"""Device sort: multi-key, per-key direction, arrow-compatible null placement.

Replaces the reference's materialize-all + `lexsort_to_indices` ORDER BY
(reference src/executor/order.rs:14-38). Keys are encoded to orderable device
arrays (strings via dictionary lex-ranks) and sorted with ONE variadic stable
lax.sort. NULLs sort first in both directions (arrow SortOptions default the
reference inherits).

Rows ride the sort as payload operands (sort_rows) instead of being gathered
by a permutation afterwards: sort payloads stream, where N-sized gathers
read at random.

Every public function here is ONE dispatched program: key encoding (rank
gathers, direction flips, null sentinels) happens INSIDE the jit. The old
eager assembly cost a dispatch per step — a 2-key ORDER BY paid ~10 before
the sort even launched.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sqlrs_tpu.data import Column
from sqlrs_tpu.data.strings import GLOBAL_STRINGS
from sqlrs_tpu.errors import ExecutorError
from sqlrs_tpu.types import LogicalType


def key_kind(t: LogicalType) -> str:
    """Host-static classification driving the traced key encoding."""
    if t == LogicalType.VARCHAR:
        return "varchar"
    if t in (LogicalType.FLOAT, LogicalType.DOUBLE):
        return "float"
    if t == LogicalType.UBIGINT:
        return "ubigint"
    if (
        t.is_numeric()
        or t in (LogicalType.DATE, LogicalType.INTERVAL, LogicalType.BOOLEAN)
    ):
        return "plain"
    raise ExecutorError(f"type {t} is not orderable")


def _rank_table_for(cols) -> jnp.ndarray | None:
    if any(c.type == LogicalType.VARCHAR for c in cols):
        r = GLOBAL_STRINGS.ranks_device()
        if r.shape[0] > 0:
            return r
    return None


def _encode_traced(kind: str, data, rank):
    """Orderable int64/float64 key, monotone in column sort order (traced)."""
    if kind == "varchar":
        if rank is None:
            return jnp.zeros(data.shape[0], dtype=jnp.int64)
        codes = jnp.clip(data, 0, rank.shape[0] - 1)
        return rank[codes].astype(jnp.int64)
    if kind == "float":
        return data.astype(jnp.float64)
    if kind == "ubigint":
        return (data - jnp.uint64(2**63)).astype(jnp.int64)
    return data.astype(jnp.int64)


def _directed_traced(kind: str, asc: bool, data, valid, rank):
    """ASCENDING sort realizes the requested direction, NULLs first."""
    key = _encode_traced(kind, data, rank)
    if not asc:
        key = -key
    if kind == "float":
        null_val = -jnp.inf
    else:
        null_val = np.iinfo(np.int64).min
    return jnp.where(valid, key, null_val)


def orderable_key(col: Column):
    """(key, valid): eager counterpart of _encode_traced for callers that
    assemble their own programs. Works under jit too (rank table is a
    device-cached constant; tracing closes over it)."""
    rank = None
    if col.type == LogicalType.VARCHAR:
        rank = GLOBAL_STRINGS.ranks_device()
        if rank.shape[0] == 0:
            rank = None
    return _encode_traced(key_kind(col.type), col.data, rank), col.valid


def _directed_key(col: Column, asc: bool):
    """Directed orderable key (NULLs first) — eager/traceable form used by
    the distributed sort, which assembles its own shard_map programs."""
    return _directed_traced(
        key_kind(col.type), bool(asc), col.data, col.valid, _rank_table_for([col])
    )


# ---- fused single-dispatch sort programs -----------------------------------


@partial(jax.jit, static_argnames=("kinds", "ascs"))
def _sort_indices_jit(kdatas, kvalids, rank, kinds, ascs):
    n = kdatas[0].shape[0]
    ops = [
        _directed_traced(k, a, d, v, rank)
        for k, a, d, v in zip(kinds, ascs, kdatas, kvalids)
    ]
    ops.append(jnp.arange(n, dtype=jnp.int64))
    out = jax.lax.sort(tuple(ops), num_keys=len(kinds), is_stable=True)
    return out[-1]


@partial(jax.jit, static_argnames=("kinds", "ascs"))
def _sort_rows_jit(kdatas, kvalids, rank, pdatas, pvalids, kinds, ascs):
    keys = [
        _directed_traced(k, a, d, v, rank)
        for k, a, d, v in zip(kinds, ascs, kdatas, kvalids)
    ]
    payloads: list = []
    for d, v in zip(pdatas, pvalids):
        payloads.append(d.astype(jnp.int32) if d.dtype == jnp.bool_ else d)
        payloads.append(v.astype(jnp.int32))
    out = jax.lax.sort(
        tuple(keys + payloads), num_keys=len(kinds), is_stable=True
    )
    res_d, res_v = [], []
    p = len(kinds)
    for d in pdatas:
        data, valid = out[p], out[p + 1]
        p += 2
        if d.dtype == jnp.bool_:
            data = data.astype(jnp.bool_)
        res_d.append(data)
        res_v.append(valid > 0)
    return tuple(res_d), tuple(res_v)


@partial(jax.jit, static_argnames=("kinds", "ascs"))
def _sort_gather_jit(kdatas, kvalids, rank, datas, valids, kinds, ascs):
    """Wide-table ORDER BY in ONE program: 2-operand permutation sort +
    whole-batch gather (a separate take program costs an extra dispatch).
    The payload-carrying sort stays the choice for narrow tables (≤6
    columns)."""
    n = kdatas[0].shape[0]
    ops = [
        _directed_traced(k, a, d, v, rank)
        for k, a, d, v in zip(kinds, ascs, kdatas, kvalids)
    ]
    ops.append(jnp.arange(n, dtype=jnp.int64))
    perm = jax.lax.sort(tuple(ops), num_keys=len(kinds), is_stable=True)[-1]
    return tuple(a[perm] for a in datas), tuple(a[perm] for a in valids)


def sort_gather_rows(items, columns):
    """Permutation-sort + gather every column, one dispatch (wide tables)."""
    kcols = [c for c, _ in items]
    res_d, res_v = _sort_gather_jit(
        tuple(c.data for c in kcols),
        tuple(c.valid for c in kcols),
        _rank_table_for(kcols),
        tuple(c.data for c in columns),
        tuple(c.valid for c in columns),
        tuple(key_kind(c.type) for c in kcols),
        tuple(bool(a) for _, a in items),
    )
    return [Column(c.type, d, v) for c, d, v in zip(columns, res_d, res_v)]


@partial(jax.jit, static_argnames=("count",))
def _compact_indices_jit(keep_data, keep_valid, count: int):
    drop = jnp.logical_not(jnp.logical_and(keep_data, keep_valid))
    n = drop.shape[0]
    _, perm = jax.lax.sort(
        (drop.astype(jnp.int32), jnp.arange(n, dtype=jnp.int64)),
        num_keys=1,
        is_stable=True,
    )
    return perm[:count]


@partial(jax.jit, static_argnames=("count",))
def _compact_rows_jit(keep_data, keep_valid, pdatas, pvalids, count: int):
    drop = jnp.logical_not(jnp.logical_and(keep_data, keep_valid))
    payloads: list = []
    for d, v in zip(pdatas, pvalids):
        payloads.append(d.astype(jnp.int32) if d.dtype == jnp.bool_ else d)
        payloads.append(v.astype(jnp.int32))
    out = jax.lax.sort(
        tuple([drop.astype(jnp.int32)] + payloads), num_keys=1, is_stable=True
    )
    res_d, res_v = [], []
    p = 1
    for d in pdatas:
        data, valid = out[p][:count], out[p + 1][:count]
        p += 2
        if d.dtype == jnp.bool_:
            data = data.astype(jnp.bool_)
        res_d.append(data)
        res_v.append(valid > 0)
    return tuple(res_d), tuple(res_v)


# ---- public API --------------------------------------------------------------


def compact_indices(keep: Column, count: int):
    """Device-resident compaction permutation: ONE 2-operand stable sort by
    the drop flag, sliced to `count`. Pairs with batched gathers for wide
    tables, where a full payload-carrying sort (say 21 mixed operands) is
    heavier to compile and run than 2 operands plus per-column gathers."""
    return _compact_indices_jit(keep.data, keep.valid, int(count))


def sort_indices(items: list[tuple[Column, bool]]):
    """Permutation sorting rows by the given (column, ascending) keys;
    stable, NULLs first. ONE dispatch: key encoding + variadic lax.sort with
    the row index as payload."""
    cols = [c for c, _ in items]
    return _sort_indices_jit(
        tuple(c.data for c in cols),
        tuple(c.valid for c in cols),
        _rank_table_for(cols),
        tuple(key_kind(c.type) for c in cols),
        tuple(bool(a) for _, a in items),
    )


def sort_rows(items: list[tuple[Column, bool]], columns: list[Column]):
    """Sort whole rows: ONE dispatch — key encoding + variadic lax.sort
    carrying every output column (data + validity) as payload. No post-sort
    permutation gathers."""
    kcols = [c for c, _ in items]
    res_d, res_v = _sort_rows_jit(
        tuple(c.data for c in kcols),
        tuple(c.valid for c in kcols),
        _rank_table_for(kcols),
        tuple(c.data for c in columns),
        tuple(c.valid for c in columns),
        tuple(key_kind(c.type) for c in kcols),
        tuple(bool(a) for _, a in items),
    )
    return [Column(c.type, d, v) for c, d, v in zip(columns, res_d, res_v)]


def compact_rows(keep: Column, columns: list[Column], count: int):
    """Filter compaction as ONE dispatched program: stable variadic sort by
    the drop flag (kept rows first, original order preserved), sliced to
    `count` — no host-side index materialization and no N-sized gathers
    (sort payloads stream)."""
    res_d, res_v = _compact_rows_jit(
        keep.data,
        keep.valid,
        tuple(c.data for c in columns),
        tuple(c.valid for c in columns),
        int(count),
    )
    return [Column(c.type, d, v) for c, d, v in zip(columns, res_d, res_v)]
