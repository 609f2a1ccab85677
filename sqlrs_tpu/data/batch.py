"""Fixed-width columnar device batches with validity masks.

This is the engine's RecordBatch replacement (reference uses Arrow
`RecordBatch` throughout, e.g. src/executor/mod.rs:34). A column is a dense
jax array plus a boolean validity mask; a batch is columns + row count. All
dtypes are fixed width (strings are dictionary codes, data/strings.py), so
every operator is expressible as static-shape XLA programs.

Host materialization (`to_pylist`) happens only at the session boundary for
result rendering.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

import jax.numpy as jnp
import numpy as np

from sqlrs_tpu.data.strings import GLOBAL_STRINGS, NULL_CODE
from sqlrs_tpu.errors import TypeError_
from sqlrs_tpu.types import Interval, LogicalType, ScalarValue, numpy_dtype_for


@dataclass(frozen=True)
class SchemaField:
    name: str
    type: LogicalType
    nullable: bool = True


@dataclass(frozen=True)
class Schema:
    fields: tuple[SchemaField, ...]

    @staticmethod
    def of(pairs: Iterable[tuple[str, LogicalType]]) -> "Schema":
        return Schema(tuple(SchemaField(n, t) for n, t in pairs))

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    @property
    def types(self) -> list[LogicalType]:
        return [f.type for f in self.fields]

    def __len__(self) -> int:
        return len(self.fields)


@dataclass
class Column:
    type: LogicalType
    data: Any  # jnp array, dtype = numpy_dtype_for(type)
    valid: Any  # jnp bool array, same length

    def __len__(self) -> int:
        return int(self.data.shape[0])

    # ---- constructors ----------------------------------------------------

    @staticmethod
    def from_numpy(
        t: LogicalType, data: np.ndarray, valid: np.ndarray | None = None
    ) -> "Column":
        dt = numpy_dtype_for(t)
        if valid is None:
            valid = np.ones(len(data), dtype=np.bool_)
        return Column(t, jnp.asarray(data.astype(dt, copy=False)), jnp.asarray(valid))

    @staticmethod
    def from_scalars(t: LogicalType, values: Sequence[ScalarValue]) -> "Column":
        """Build a column from host scalars (literal VALUES lists, agg results)."""
        n = len(values)
        valid = np.array([not v.is_null for v in values], dtype=np.bool_)
        dt = numpy_dtype_for(t)
        data = np.zeros(n, dtype=dt)
        for i, v in enumerate(values):
            if v.is_null:
                data[i] = NULL_CODE if t == LogicalType.VARCHAR else 0
                continue
            data[i] = _encode_value(t, v.value)
        return Column(t, jnp.asarray(data), jnp.asarray(valid))

    @staticmethod
    def broadcast(v: ScalarValue, t: LogicalType, n: int) -> "Column":
        """Broadcast one scalar to n rows (reference src/types/mod.rs:214)."""
        dt = numpy_dtype_for(t)
        if v.is_null:
            data = np.full(n, NULL_CODE if t == LogicalType.VARCHAR else 0, dtype=dt)
            valid = np.zeros(n, dtype=np.bool_)
        else:
            data = np.full(n, _encode_value(t, v.cast_to(t).value), dtype=dt)
            valid = np.ones(n, dtype=np.bool_)
        return Column(t, jnp.asarray(data), jnp.asarray(valid))

    # ---- host access -----------------------------------------------------

    def data_np(self) -> np.ndarray:
        return np.asarray(self.data)

    def valid_np(self) -> np.ndarray:
        return np.asarray(self.valid)

    def scalar_at(self, i: int) -> ScalarValue:
        if not bool(self.valid_np()[i]):
            return ScalarValue(self.type, None)
        return ScalarValue(self.type, _decode_value(self.type, self.data_np()[i]))

    def to_pylist(self) -> list[Any]:
        data, valid = self.data_np(), self.valid_np()
        if self.type == LogicalType.VARCHAR:
            return GLOBAL_STRINGS.decode(data, valid)
        out: list[Any] = []
        for x, v in zip(data.tolist(), valid.tolist()):
            out.append(_decode_value(self.type, x) if v else None)
        return out

    def take(self, indices) -> "Column":
        """Gather rows by index (device op)."""
        idx = jnp.asarray(indices)
        return Column(self.type, self.data[idx], self.valid[idx])

    def mask_invalid(self, keep) -> "Column":
        """AND the validity with `keep` (same length bool array)."""
        return Column(self.type, self.data, jnp.logical_and(self.valid, keep))


def _encode_value(t: LogicalType, v: Any) -> Any:
    if t == LogicalType.VARCHAR:
        return GLOBAL_STRINGS.intern(v)
    if t == LogicalType.INTERVAL:
        return v.pack() if isinstance(v, Interval) else int(v)
    if t == LogicalType.BOOLEAN:
        return bool(v)
    if t.is_float():
        return float(v)
    return int(v)


def _decode_value(t: LogicalType, x: Any) -> Any:
    if t == LogicalType.VARCHAR:
        return GLOBAL_STRINGS.lookup(int(x))
    if t == LogicalType.INTERVAL:
        return Interval.unpack(int(x))
    if t == LogicalType.BOOLEAN:
        return bool(x)
    if t.is_float():
        return float(x)
    return int(x)


@dataclass
class DeviceBatch:
    schema: Schema
    columns: list[Column]
    num_rows: int = field(default=-1)

    def __post_init__(self) -> None:
        if self.num_rows < 0:
            self.num_rows = len(self.columns[0]) if self.columns else 0
        for c in self.columns:
            if len(c) != self.num_rows:
                raise TypeError_("column length mismatch in DeviceBatch")

    @staticmethod
    def empty(schema: Schema) -> "DeviceBatch":
        cols = [
            Column.from_numpy(f.type, np.zeros(0, dtype=numpy_dtype_for(f.type)))
            for f in schema.fields
        ]
        return DeviceBatch(schema, cols, 0)

    @staticmethod
    def from_pydict(schema: Schema, data: dict[str, list[Any]]) -> "DeviceBatch":
        cols = []
        for f in schema.fields:
            vals = [
                ScalarValue(f.type, v) if not isinstance(v, ScalarValue) else v
                for v in data[f.name]
            ]
            vals = [
                ScalarValue(f.type, None) if v.value is None else v.cast_to(f.type)
                for v in vals
            ]
            cols.append(Column.from_scalars(f.type, vals))
        return DeviceBatch(schema, cols)

    @staticmethod
    def concat(batches: Sequence["DeviceBatch"]) -> "DeviceBatch":
        if not batches:
            raise TypeError_("concat of zero batches")
        if len(batches) == 1:
            return batches[0]
        from sqlrs_tpu.ops.fused import concat_arrays

        schema = batches[0].schema
        flat = concat_arrays(
            [
                tuple(a for c in b.columns for a in (c.data, c.valid))
                for b in batches
            ]
        )
        cols = [
            Column(f.type, flat[2 * ci], flat[2 * ci + 1])
            for ci, f in enumerate(schema.fields)
        ]
        return DeviceBatch(schema, cols)

    def take(self, indices) -> "DeviceBatch":
        """Gather rows by index: ONE dispatched program for the whole batch
        (per-column eager gathers cost ~8 dispatches each)."""
        if not self.columns:
            idx = jnp.asarray(indices)
            return DeviceBatch(self.schema, [], int(idx.shape[0]))
        from sqlrs_tpu.ops.fused import gather_arrays

        idx = jnp.asarray(indices)
        flat = gather_arrays(
            tuple(a for c in self.columns for a in (c.data, c.valid)), idx
        )
        cols = [
            Column(c.type, flat[2 * ci], flat[2 * ci + 1])
            for ci, c in enumerate(self.columns)
        ]
        return DeviceBatch(self.schema, cols, int(idx.shape[0]))

    def compact(self, keep: "Column", count: int) -> "DeviceBatch":
        """Rows where `keep` holds (original order), in ONE dispatched
        program — fused flag-sort compaction + whole-batch gather."""
        if not self.columns:
            return DeviceBatch(self.schema, [], count)
        from sqlrs_tpu.ops.fused import compact_gather_arrays

        flat = compact_gather_arrays(
            keep.data,
            keep.valid,
            tuple(a for c in self.columns for a in (c.data, c.valid)),
            int(count),
        )
        cols = [
            Column(c.type, flat[2 * ci], flat[2 * ci + 1])
            for ci, c in enumerate(self.columns)
        ]
        return DeviceBatch(self.schema, cols, count)

    def slice(self, start: int, length: int) -> "DeviceBatch":
        if not self.columns:
            return DeviceBatch(self.schema, [], length)
        from sqlrs_tpu.ops.fused import slice_arrays

        flat = slice_arrays(
            tuple(a for c in self.columns for a in (c.data, c.valid)),
            int(start),
            int(length),
        )
        cols = [
            Column(c.type, flat[2 * ci], flat[2 * ci + 1])
            for ci, c in enumerate(self.columns)
        ]
        return DeviceBatch(self.schema, cols, length)

    def to_pylist(self) -> list[list[Any]]:
        """Row-major host values (None for NULL) — session-boundary only.

        All column transfers are started asynchronously before any is
        awaited: per-column np.asarray costs one device-to-host sync EACH,
        so a wide result used to pay 2×width syncs; the async prefetch
        overlaps them into ~one."""
        arrays = [a for c in self.columns for a in (c.data, c.valid)]
        for a in arrays:
            try:
                a.copy_to_host_async()
            except AttributeError:
                pass  # plain numpy or tracer
        col_lists = [c.to_pylist() for c in self.columns]
        return [list(row) for row in zip(*col_lists)] if col_lists else []
