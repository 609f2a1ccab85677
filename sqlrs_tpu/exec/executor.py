"""Operator executors: physical plan → device batches.

The engine's data plane. Each operator consumes whole device-resident
columnar batches and produces one (pipeline breakers land exactly where the
reference materializes: agg, sort, join build — reference
src/executor/order.rs:14, hash_join.rs:187, hash_agg.rs:32). Elementwise
chains are jnp programs XLA fuses; grouping/join/sort dispatch to the
kernels in sqlrs_tpu/ops/.
"""

from __future__ import annotations

import functools
from collections import OrderedDict

import numpy as np
import jax.numpy as jnp
import jax

from sqlrs_tpu.binder.expression import BoundAggregate, BoundReference
from sqlrs_tpu.data import Column, DeviceBatch, Schema, SchemaField
from sqlrs_tpu.data.strings import NULL_CODE
from sqlrs_tpu.errors import ExecutorError
from sqlrs_tpu.exec.expression_executor import (
    execute_expr,
    execute_exprs_fused,
    execute_scalar,
)
from sqlrs_tpu.ops import elementwise as ew
from sqlrs_tpu.ops.grouping import (
    dedup_mask,
    group_ids,
    seg_argmin_by,
    seg_count_valid,
    seg_max,
    seg_min,
    seg_sum,
)
from sqlrs_tpu.ops.fused import mask_count
from sqlrs_tpu.ops.join import equi_join_pairs
from sqlrs_tpu.ops.sort import (
    compact_indices,
    compact_rows,
    orderable_key,
    sort_gather_rows,
    sort_rows,
)
from sqlrs_tpu.plan import physical as P
from sqlrs_tpu.storage.memory import DataTable, null_column
from sqlrs_tpu.types import LogicalType, numpy_dtype_for


class Executor:
    # may HashAgg(HashJoin) subtrees take the fused star-rollup route
    # (exec/fused_route.py), which executes them from their scans
    fused_routes = True

    def __init__(self, db, profile=None) -> None:
        self.db = db
        self.profile = profile  # QueryProfile | None

    def execute(self, op: P.PhysicalOperator) -> DeviceBatch:
        # one-shot reuse of child batches a bailed fused-route attempt
        # already executed (exec/fused_route.py) — popped on hit so no
        # intermediate batch outlives its single consumer
        cache = getattr(self, "_route_cache", None)
        if cache:
            hit = cache.pop(id(op), None)
            if hit is not None:
                return hit
        method = getattr(self, "_exec_" + type(op).__name__.removeprefix("Physical"))
        if self.profile is None:
            return method(op)
        with self.profile.measure(op.explain_line()[:60]) as stats:
            out = method(op)
            stats.rows_out = out.num_rows
        return out

    # ---- scans -------------------------------------------------------------

    def _exec_TableScan(self, op: P.PhysicalTableScan) -> DeviceBatch:
        fn = self.db.catalog.table_function(op.function_name)
        return fn.execute(self.db, op.bind_data, op.projection, op.bounds)

    def _exec_DummyScan(self, op: P.PhysicalDummyScan) -> DeviceBatch:
        return DeviceBatch(Schema(()), [], 1)

    def _exec_ExpressionScan(self, op: P.PhysicalExpressionScan) -> DeviceBatch:
        cols = []
        for ci, t in enumerate(op.expr_types):
            scalars = [
                execute_scalar(row[ci]).cast_to(t) for row in op.expr_rows
            ]
            cols.append(Column.from_scalars(t, scalars))
        return DeviceBatch(_schema(op), cols, len(op.expr_rows))

    def _exec_ColumnDataScan(self, op: P.PhysicalColumnDataScan) -> DeviceBatch:
        return op.batch

    # ---- row-wise operators ---------------------------------------------------

    def _exec_Projection(self, op: P.PhysicalProjection) -> DeviceBatch:
        child = self.execute(op.children[0])
        cols = execute_exprs_fused(op.exprs, child)
        return DeviceBatch(_schema(op), cols, child.num_rows)

    _COMPACT_SORT_MIN_ROWS = 1 << 18

    def _exec_Filter(self, op: P.PhysicalFilter) -> DeviceBatch:
        child = self.execute(op.children[0])
        (keep,) = execute_exprs_fused([op.predicate], child)
        if child.num_rows >= self._COMPACT_SORT_MIN_ROWS and child.columns:
            # large batches compact device-resident: narrow tables carry the
            # rows through ONE stable flag-sort; wide tables sort only a
            # permutation (2 operands) and gather — wide payload sorts are
            # heavy to compile AND run (21 mixed operands ~5s at 8.4M)
            count = int(mask_count(keep.data, keep.valid))
            if count == child.num_rows:
                return child
            if len(child.columns) <= 4:
                cols = compact_rows(keep, child.columns, count)
                return DeviceBatch(child.schema, cols, count)
            return child.compact(keep, count)
        idx = ew.selection_to_indices(keep)
        return child.take(idx)

    def _exec_Limit(self, op: P.PhysicalLimit) -> DeviceBatch:
        out = self._streaming_limit(op)
        if out is not None:
            return out
        child = self.execute(op.children[0])
        offset = op.offset or 0
        start = min(offset, child.num_rows)
        count = child.num_rows - start
        if op.limit is not None:
            count = min(op.limit, count)
        return child.slice(start, count)

    def _streaming_limit(self, op: P.PhysicalLimit) -> DeviceBatch | None:
        """LIMIT k over a pure row-wise pipeline (Projection/Filter chain on
        an unbounded TableScan) executes the scan in geometrically growing
        chunks and stops as soon as offset+k rows survive — the per-batch
        LIMIT windowing + early stop of the reference's pull model
        (reference src/executor/limit.rs:31-70, storage/csv.rs:206-232)
        re-expressed for whole-batch execution: filters/projections compute
        over O(result) rows, never O(table). Returns None when the child
        pipeline isn't streamable (joins, aggregates, ORDER BY need their
        whole input; the reference breaks its pipeline there too)."""
        import dataclasses

        if op.limit is None:
            return None
        need = (op.offset or 0) + op.limit
        chain: list[P.PhysicalOperator] = []
        node = op.children[0]
        while isinstance(node, (P.PhysicalProjection, P.PhysicalFilter)):
            chain.append(node)
            node = node.children[0]
        if not isinstance(node, P.PhysicalTableScan) or node.bounds is not None:
            return None
        chunk = max(1024, 2 * need)
        start_row, parts, got = 0, [], 0
        while got < need or not parts:  # LIMIT 0 still needs the schema
            scan = dataclasses.replace(node, bounds=(start_row, chunk))
            piece = self.execute(scan)
            exhausted = piece.num_rows < chunk
            for c in reversed(chain):
                if isinstance(c, P.PhysicalFilter):
                    (keep,) = execute_exprs_fused([c.predicate], piece)
                    piece = piece.take(ew.selection_to_indices(keep))
                else:
                    cols = execute_exprs_fused(c.exprs, piece)
                    piece = DeviceBatch(_schema(c), cols, piece.num_rows)
            parts.append(piece)
            got += piece.num_rows
            start_row += chunk
            chunk *= 2
            if exhausted:
                break
        batch = parts[0] if len(parts) == 1 else DeviceBatch.concat(parts)
        offset = op.offset or 0
        first = min(offset, batch.num_rows)
        return batch.slice(first, min(op.limit, batch.num_rows - first))

    def _exec_Order(self, op: P.PhysicalOrder) -> DeviceBatch:
        # star-rollup fusion: Order(HashAgg(HashJoin)) with the order key ==
        # the single group key == the single int equi-join key routes to the
        # packed-sort kernel (ops/pipelines.join_groupby_direct) — one fused
        # program instead of pair materialization + re-aggregation
        from sqlrs_tpu.exec.fused_route import try_order_agg_join_route

        routed = try_order_agg_join_route(self, op)
        if routed is not None:
            return routed
        child = self.execute(op.children[0])
        if child.num_rows == 0:
            return child
        key_cols = execute_exprs_fused([e for e, _ in op.items], child)
        keys = [(c, asc) for c, (_, asc) in zip(key_cols, op.items)]
        if len(child.columns) <= 6:
            cols = sort_rows(keys, child.columns)
        else:
            # wide tables: 2-operand permutation sort + gather, ONE program
            cols = sort_gather_rows(keys, child.columns)
        return DeviceBatch(child.schema, cols, child.num_rows)

    # ---- aggregation ------------------------------------------------------------

    def _exec_SimpleAgg(self, op: P.PhysicalSimpleAgg) -> DeviceBatch:
        src, alive = self._fusable_filter_input(op)
        return self._aggregate(op, [], op.aggregates, src, alive)

    def _exec_HashAgg(self, op: P.PhysicalHashAgg) -> DeviceBatch:
        # star-rollup fusion without an ORDER BY: HashAgg(HashJoin) on the
        # single int equi-join key routes to the rowid-packed kernel, which
        # recovers the first-appearance group order from per-group min
        # probe row indices (exec/fused_route.py)
        from sqlrs_tpu.exec.fused_route import try_agg_join_route

        routed = try_agg_join_route(self, op)
        if routed is not None:
            return routed
        src, alive = self._fusable_filter_input(op)
        return self._aggregate(op, op.groups, op.aggregates, src, alive)

    def _filter_fused_side(self, child_op):
        """(batch, alive) for a join side, folding one Filter level. alive
        is the raw (keep_data, keep_valid) pair — the AND happens inside
        the consuming program (an eager logical_and cost a dispatch)."""
        if isinstance(child_op, P.PhysicalFilter):
            src = self.execute(child_op.children[0])
            if src.num_rows > 0:
                (keep,) = execute_exprs_fused([child_op.predicate], src)
                return src, (keep.data, keep.valid)
        return self.execute(child_op), None

    @staticmethod
    def _distinct_on_sorted_path(op) -> bool:
        """DISTINCT aggregates ride the sorted-run path when grouped and all
        distinct aggs share ONE argument expression (the common SQL shape,
        e.g. Q16's count(distinct ps_suppkey))."""
        d_args = {repr(a.arg) for a in op.aggregates if a.distinct}
        if not d_args:
            return True
        return bool(getattr(op, "groups", None)) and len(d_args) == 1

    def _fusable_filter_input(self, op):
        """Filter directly under an aggregate fuses as an alive-mask: the
        aggregate excludes masked rows itself, skipping the compaction
        (permutation sort + per-column gathers) entirely. The mask is the
        raw (keep_data, keep_valid) pair; the AND happens inside the
        consuming program (ops/grouped_agg._agg_phase1 /
        _reduce_ungrouped_fused)."""
        child_op = op.children[0]
        if (
            isinstance(child_op, P.PhysicalFilter)
            and self._distinct_on_sorted_path(op)
        ):
            src = self.execute(child_op.children[0])
            if src.num_rows > 0:
                (keep,) = execute_exprs_fused([child_op.predicate], src)
                return src, (keep.data, keep.valid)
        return self.execute(child_op), None

    def _aggregate(self, op, groups, aggs, child, alive=None) -> DeviceBatch:
        n = child.num_rows
        if not groups and not any(a.distinct for a in aggs) and n > 0:
            # ungrouped aggregates are plain masked reductions — XLA lowers
            # them at memory speed (the segment-op path scatters per element)
            distinct_args: list = []
            arg_keys: dict[str, int] = {}
            for a in aggs:
                if a.arg is not None and repr(a.arg) not in arg_keys:
                    arg_keys[repr(a.arg)] = len(distinct_args)
                    distinct_args.append(a.arg)
            arg_cols = execute_exprs_fused(distinct_args, child)
            slots = [
                arg_keys[repr(a.arg)] if a.arg is not None else None
                for a in aggs
            ]
            out_cols = _reduce_ungrouped_fused(aggs, slots, arg_cols, n, alive)
            return DeviceBatch(_schema(op), out_cols, 1)
        if groups and self._distinct_on_sorted_path(op):
            # sorted-run fast path: one variadic sort, no N-sized scatters
            # (ops/grouped_agg.py; DISTINCT aggs sharing one argument ride
            # the same sort with a value key — multi-argument DISTINCT
            # falls to the legacy dedup path below)
            from sqlrs_tpu.ops.grouped_agg import sorted_grouped_aggregate

            distinct_args: list = []
            arg_keys: dict[str, int] = {}  # identical args share one Column
            for a in aggs:                 # (payload-slot dedupe downstream)
                if a.arg is not None and repr(a.arg) not in arg_keys:
                    arg_keys[repr(a.arg)] = len(distinct_args)
                    distinct_args.append(a.arg)
            evaluated = execute_exprs_fused(list(groups) + distinct_args, child)
            key_cols = evaluated[: len(groups)]
            arg_cols = evaluated[len(groups):]
            specs = []
            for a in aggs:
                col = None
                if a.arg is not None:
                    col = arg_cols[arg_keys[repr(a.arg)]]
                specs.append((a.function_name, col, a.return_type(), a.distinct))
            gcols, acols, n_groups = sorted_grouped_aggregate(
                key_cols, specs, alive=alive
            )
            return DeviceBatch(_schema(op), gcols + acols, n_groups)
        if groups:
            key_cols = [execute_expr(g, child) for g in groups]
            gid, n_groups = group_ids(key_cols)
        else:
            key_cols = []
            gid = jnp.zeros(n, dtype=jnp.int64)
            n_groups = 1  # ungrouped agg always yields one row
        out_cols: list[Column] = []
        if key_cols:
            rep = jax.ops.segment_min(
                jnp.arange(n, dtype=jnp.int64), gid, num_segments=n_groups
            )
            out_cols.extend(c.take(rep) for c in key_cols)
        for a in aggs:
            out_cols.append(self._eval_aggregate(a, child, gid, n_groups))
        return DeviceBatch(_schema(op), out_cols, n_groups)

    def _eval_aggregate(
        self, a: BoundAggregate, batch: DeviceBatch, gid, n_groups: int
    ) -> Column:
        n = batch.num_rows
        if a.arg is None:  # count(*)
            counts = seg_count_valid(jnp.ones(n, dtype=jnp.bool_), gid, n_groups)
            return Column(
                LogicalType.BIGINT, counts, jnp.ones(n_groups, dtype=jnp.bool_)
            )
        col = execute_expr(a.arg, batch)
        valid = dedup_mask([col], gid) if a.distinct else col.valid
        counts = seg_count_valid(valid, gid, n_groups)
        has_any = counts > 0
        name = a.function_name
        if name == "count":
            return Column(
                LogicalType.BIGINT, counts, jnp.ones(n_groups, dtype=jnp.bool_)
            )
        if name in ("sum", "avg"):
            acc_t = LogicalType.DOUBLE if name == "avg" else a.type
            data = col.data.astype(numpy_dtype_for(acc_t))
            s = seg_sum(data, valid, gid, n_groups)
            if name == "avg":
                data = s / jnp.maximum(counts, 1).astype(jnp.float64)
                return Column(LogicalType.DOUBLE, data, has_any)
            return Column(a.type, s, has_any)
        if name in ("min", "max"):
            if col.type == LogicalType.VARCHAR:
                key, _ = orderable_key(col)
                key = key if name == "min" else -key
                win = seg_argmin_by(key, valid, gid, n_groups)
                win_safe = jnp.clip(win, 0, max(n - 1, 0))
                codes = (
                    col.data[win_safe]
                    if n > 0
                    else jnp.full(n_groups, NULL_CODE, dtype=jnp.int32)
                )
                return Column(LogicalType.VARCHAR, codes, has_any)
            info = (
                np.iinfo(numpy_dtype_for(col.type))
                if col.type.is_integral() or col.type == LogicalType.DATE
                else np.finfo(numpy_dtype_for(col.type))
            )
            if name == "min":
                data = seg_min(col.data, valid, gid, n_groups, info.max)
            else:
                data = seg_max(col.data, valid, gid, n_groups, info.min)
            return Column(col.type, data, has_any)
        raise ExecutorError(f"unknown aggregate {name}")

    # ---- joins ----------------------------------------------------------------

    def _exec_semi_anti_join(self, op: P.PhysicalHashJoin) -> DeviceBatch:
        """Semi/anti join (decorrelated EXISTS / IN-subquery): emit LEFT rows
        that have (semi) / lack (anti) a surviving match, preserving left
        order. null_aware anti = NOT IN semantics: any NULL inner value ⇒
        empty result; NULL probe values never pass (SQL three-valued logic).

        A Filter on the LEFT child — even under the pure-reference
        Projection that column pruning interposes — folds as an alive
        mask: its rows drop in the SAME compaction as the semi/anti keep,
        instead of paying a full materializing compaction first (Q21's
        anti probe side spent 2.6 s on that at SF1). Folding is restricted
        to residual-free / single-<>-residual marks (the count-based
        paths), whose semantics ignore dead-row counts; null-aware NOT IN
        keeps the plain path."""
        def _fold_filter_child(child):
            """(batch, alive_pair, remap) with one Filter level folded,
            seeing through a pure-reference pruning Projection; (None,
            None, None) when the shape doesn't apply."""
            rm = None
            node = child
            if (
                isinstance(node, P.PhysicalProjection)
                and len(node.children) == 1
                and all(isinstance(e, BoundReference) for e in node.exprs)
                and isinstance(node.children[0], P.PhysicalFilter)
            ):
                rm = [e.index for e in node.exprs]
                node = node.children[0]
            if isinstance(node, P.PhysicalFilter):
                src = self.execute(node.children[0])
                if src.num_rows > 0:
                    (keep,) = execute_exprs_fused([node.predicate], src)
                    return src, (keep.data, keep.valid), rm
            return None, None, None

        left = right = None
        left_alive = right_alive = None
        remap = remap_r = None
        if not op.null_aware and (
            op.filter is None or self._ne_residual(op) is not None
        ):
            left, left_alive, remap = _fold_filter_child(op.children[0])
            right, right_alive, remap_r = _fold_filter_child(op.children[1])
        if left is None:
            remap = None
            left = self.execute(op.children[0])
        if right is None:
            remap_r = None
            right = self.execute(op.children[1])
        out_schema = _schema(op)
        nl = left.num_rows

        def _project(cols):
            return [cols[i] for i in remap] if remap is not None else cols

        def _emit_all():
            """Every LIVE left row survives (anti over empty right, etc.)."""
            if left_alive is None:
                return DeviceBatch(out_schema, _project(left.columns), nl)
            keep = jnp.logical_and(left_alive[0], left_alive[1])
            out = left.compact(
                Column(LogicalType.BOOLEAN, keep, jnp.ones(nl, jnp.bool_)),
                int(jnp.sum(keep)),
            )
            return DeviceBatch(out_schema, _project(out.columns), out.num_rows)

        def _emit_none():
            z = left.slice(0, 0)
            return DeviceBatch(out_schema, _project(z.columns), 0)

        if nl == 0:
            return _emit_none()
        if right.num_rows == 0:
            # x NOT IN (empty) / NOT EXISTS(empty) keeps every left row —
            # even NULL probe values (SQL: NOT IN over an empty set is true)
            if op.join_type == "anti":
                return _emit_all()
            return _emit_none()
        if not op.on:
            # uncorrelated EXISTS / NOT EXISTS: no equi keys — the inner side
            # is non-empty (the empty case returned above), so EXISTS keeps
            # every left row and NOT EXISTS keeps none
            if op.filter is not None:
                raise ExecutorError(
                    "semi/anti join with a residual filter requires at least "
                    "one equi condition"
                )
            if op.join_type == "semi":
                return _emit_all()
            return _emit_none()

        def _remap_ref(e, rm):
            if rm is None:
                return e
            import dataclasses

            from sqlrs_tpu.binder.expression import rewrite_expr

            return rewrite_expr(
                e,
                lambda x: dataclasses.replace(x, index=rm[x.index])
                if isinstance(x, BoundReference)
                else None,
            )

        left_keys = execute_exprs_fused(
            [_remap_ref(l, remap) for l, _ in op.on], left
        )
        right_keys = execute_exprs_fused(
            [_remap_ref(r, remap_r) for _, r in op.on], right
        )
        correlated = len(op.on) > 1 or op.filter is not None
        if (
            op.null_aware
            and op.join_type == "anti"
            and not correlated
        ):
            # uncorrelated NOT IN: any NULL inner VALUE ⇒ no row can be
            # proven absent ⇒ empty result (the reference has no NOT IN;
            # semantics per SQL spec / DuckDB behavior)
            if bool(jnp.any(jnp.logical_not(right_keys[0].valid))):
                return _emit_none()
        matched = self._mark_matches(
            op, left, right, left_keys, right_keys, remap=remap,
            remap_r=remap_r, right_alive=right_alive,
        )
        if op.null_aware and op.join_type == "anti" and correlated:
            # three-valued NOT IN per correlated group: x NOT IN S(l) is
            # UNKNOWN (row dropped) iff S(l) is non-empty AND (x IS NULL
            # or S(l) contains a NULL value); S(l) empty keeps the row,
            # even for NULL x. op.on[0] is the IN-value pair, op.on[1:]
            # the correlation keys (binder _bind_in_subquery layout).
            nonempty, has_null = self._correlated_group_info(
                op, left, right, left_keys, right_keys
            )
            keep_mask, n_keep = _semi_keep_corr_jit(
                matched, left_keys[0].valid, nonempty, has_null
            )
        else:
            # NULL probe values never pass NOT IN when the inner side is
            # non-empty (null_guard)
            keep_mask, n_keep = _semi_keep_jit(
                matched,
                left_keys[0].valid,
                anti=op.join_type == "anti",
                null_guard=bool(op.null_aware and op.join_type == "anti"),
                alive=left_alive,
            )
        keep_col = Column(LogicalType.BOOLEAN, keep_mask, jnp.ones(nl, jnp.bool_))
        out = left.compact(keep_col, int(n_keep))
        return DeviceBatch(out_schema, _project(out.columns), out.num_rows)

    @staticmethod
    def _ne_residual(op):
        """(left_col, right_col) when the residual is a single left-column
        <> right-column comparison (the TPC-H Q21 shape), else None —
        static plan inspection, shared by the count-based mark join and
        the left-Filter fold gate."""
        from sqlrs_tpu.binder.expression import BoundComparison, BoundReference

        f = op.filter
        if not (
            isinstance(f, BoundComparison)
            and f.op in ("<>", "!=")
            and isinstance(f.left, BoundReference)
            and isinstance(f.right, BoundReference)
        ):
            return None
        w = op.left_width
        ia, ib = f.left.index, f.right.index
        if ia < w <= ib:
            return (ia, ib - w)
        if ib < w <= ia:
            return (ib, ia - w)
        return None

    def _mark_matches(self, op, left, right, left_keys, right_keys,
                      remap=None, remap_r=None, right_alive=None):
        """bool[left rows]: does a surviving (keys + residual) match exist?

        Count-based mark join: per-left-row match counts come straight from
        the join kernel's merged sort (ops/join.match_counts) with NO pair
        expansion — a residual-free semi/anti is two dispatches. A residual
        that is a single column <> column comparison (the TPC-H Q21 shape,
        'exists another lineitem with a DIFFERENT supplier') folds into
        counts too:  matched = #key-matches-with-valid-b − #(key,b)=(key,a)
        matches > 0. Everything else falls back to pair expansion.

        remap (left-Filter folded through a pruning Projection): maps
        join-layout left column indexes onto the WIDER unprojected batch."""
        from sqlrs_tpu.ops.join import match_counts

        nl = left.num_rows
        if op.filter is None:
            # raw counts: the >0 test folds into the keep-mask program
            # (right_alive — a folded build-side Filter — ANDs into every
            # key's validity inside the one merged-sort program)
            return match_counts(right_keys, left_keys,
                                build_alive=right_alive)
        ne = self._ne_residual(op)
        if ne is not None:
            a_l = left.columns[remap[ne[0]] if remap is not None else ne[0]]
            b_r = right.columns[
                remap_r[ne[1]] if remap_r is not None else ne[1]
            ]
            # a <> b is TRUE only where both sides are valid: restrict the
            # key-match count to valid-b rows (AND any folded build-side
            # Filter), subtract the equal-pair count
            ba = b_r.valid
            if right_alive is not None:
                ba = _and_alive_jit(ba, right_alive)
            counts_all = match_counts(right_keys, left_keys, build_alive=ba)
            counts_eq = match_counts(right_keys + [b_r], left_keys + [a_l],
                                     build_alive=ba)
            return _ne_mark_jit(counts_all, counts_eq, a_l.valid)
        # general residual: expand pairs, filter, scatter
        l_idx, r_idx = equi_join_pairs(left_keys, right_keys)
        if len(l_idx):
            keep = _eval_residual_on_pairs(op.filter, left, right, l_idx, r_idx)
            cnt = int(jnp.sum(jnp.logical_and(keep.data, keep.valid)))
            l_idx = jnp.asarray(l_idx)[compact_indices(keep, cnt)]
        if not len(l_idx):
            return jnp.zeros((nl,), jnp.bool_)
        return jnp.zeros((nl,), jnp.bool_).at[jnp.asarray(l_idx)].set(True)

    def _correlated_group_info(self, op, left, right, left_keys, right_keys):
        """Per-left-row info about the CORRELATED inner subset for null-aware
        NOT IN: (group_nonempty, group_has_null_value) bool masks. The group
        is defined by the correlation keys (op.on[1:]) plus the residual
        filter — NOT the IN-value comparison itself."""
        corr_l, corr_r = left_keys[1:], right_keys[1:]
        nl, nr = left.num_rows, right.num_rows
        if corr_l and op.filter is None:
            from sqlrs_tpu.ops.join import match_counts

            # raw counts: the >0 tests fold into _semi_keep_corr_jit
            nonempty = match_counts(corr_r, corr_l)
            null_rows = jnp.logical_not(right_keys[0].valid)
            has_null = match_counts(corr_r, corr_l, build_alive=null_rows)
            return nonempty, has_null
        if corr_l:
            gl, gr = equi_join_pairs(corr_l, corr_r)
            gl, gr = jnp.asarray(gl), jnp.asarray(gr)
        else:
            # correlation lives only in the residual filter: every (l, r)
            # candidate pair (rare shape; sizes here are subquery-bounded)
            gl = jnp.repeat(jnp.arange(nl, dtype=jnp.int64), nr)
            gr = jnp.tile(jnp.arange(nr, dtype=jnp.int64), nl)
        if op.filter is not None and len(gl):
            keep = _eval_residual_on_pairs(op.filter, left, right, gl, gr)
            cnt = int(jnp.sum(jnp.logical_and(keep.data, keep.valid)))
            sel = compact_indices(keep, cnt)
            gl, gr = gl[sel], gr[sel]
        nonempty = jnp.zeros((nl,), jnp.bool_)
        has_null = jnp.zeros((nl,), jnp.bool_)
        if len(gl):
            nonempty = nonempty.at[gl].set(True)
            r_val_null = jnp.logical_not(right_keys[0].valid)
            has_null = has_null.at[gl].max(r_val_null[gr])
        return nonempty, has_null

    def _exec_HashJoin(self, op: P.PhysicalHashJoin) -> DeviceBatch:
        if op.join_type in ("semi", "anti"):
            return self._exec_semi_anti_join(op)
        # INNER joins fuse Filter children as alive-masks folded into the
        # join-key validity: masked rows simply never produce pairs, skipping
        # the compaction entirely (pair emission order is unchanged — probe
        # rows keep their relative order either way)
        if op.join_type == "inner":
            left, l_alive = self._filter_fused_side(op.children[0])
            right, r_alive = self._filter_fused_side(op.children[1])
        else:
            left, l_alive = self.execute(op.children[0]), None
            right, r_alive = self.execute(op.children[1]), None
        left_keys = execute_exprs_fused([l for l, _ in op.on], left)
        right_keys = execute_exprs_fused([r for _, r in op.on], right)
        from sqlrs_tpu.ops.join import (
            expand_gather_pairs,
            expand_pairs,
            pair_ranges,
        )

        # fused-Filter alive masks AND into key validity INSIDE phase A
        # (an eager mask_invalid per key column cost a dispatch each)
        pr = pair_ranges(left_keys, right_keys, l_alive, r_alive)
        total = pr[3] if pr is not None else 0
        if op.join_type == "inner" and op.filter is None and total > 0:
            # non-residual inner join: pair expansion + output gather in ONE
            # program (the common TPC-H shape — saves a dispatch per join)
            ld, lv, rd, rv = expand_gather_pairs(pr, left.columns, right.columns)
            cols = [
                Column(c.type, d, v) for c, d, v in zip(left.columns, ld, lv)
            ] + [
                Column(c.type, d, v) for c, d, v in zip(right.columns, rd, rv)
            ]
            return DeviceBatch(_schema(op), cols, total)
        budget = getattr(self.db, "join_pair_budget", 1 << 25)
        if op.filter is not None and total > budget:
            # bounded-memory path: the full pair set would exceed the cell
            # budget and a residual filter gates the output, so expand +
            # filter in fixed-size chunks (reference analogue: the pull
            # model's per-batch probe, hash_join.rs:207-250, never holds
            # the whole pair set either)
            l_idx, r_idx = self._residual_pairs_chunked(
                op, left, right, pr, budget
            )
        elif op.filter is not None and total > 0:
            # device-side residual compaction over ONLY the referenced
            # columns, fused: ONE program expands the pairs, evaluates the
            # filter, and counts survivors; the only host sync is the count.
            # A second program compacts — and for inner joins also gathers
            # every output column, finishing the join.
            res = _residual_fused_phase1(op.filter, left, right, pr)
            if res is not None:
                l_idx_u, r_idx_u, kd, cnt_dev = res
                cnt = int(cnt_dev)
                if op.join_type == "inner":
                    ld, lv, rd, rv = _compact_gather_pairs_jit(
                        l_idx_u, r_idx_u, kd,
                        tuple(c.data for c in left.columns),
                        tuple(c.valid for c in left.columns),
                        tuple(c.data for c in right.columns),
                        tuple(c.valid for c in right.columns),
                        count=cnt,
                    )
                    cols = [
                        Column(c.type, d, v)
                        for c, d, v in zip(left.columns, ld, lv)
                    ] + [
                        Column(c.type, d, v)
                        for c, d, v in zip(right.columns, rd, rv)
                    ]
                    return DeviceBatch(_schema(op), cols, cnt)
                l_idx, r_idx = _compact_pairs_jit(
                    l_idx_u, r_idx_u, kd, count=cnt
                )
            else:
                # unfusable residual (host-concretizing expression): the
                # unfused chain — expand, eval, flag-sort-compact
                l_idx, r_idx = expand_pairs(*pr)
                l_idx, r_idx = jnp.asarray(l_idx), jnp.asarray(r_idx)
                keep = _eval_residual_on_pairs(
                    op.filter, left, right, l_idx, r_idx
                )
                cnt = int(jnp.sum(jnp.logical_and(keep.data, keep.valid)))
                sel = compact_indices(keep, cnt)
                from sqlrs_tpu.ops.fused import gather_arrays

                l_idx, r_idx = gather_arrays((l_idx, r_idx), sel)
        else:
            l_idx, r_idx = (
                expand_pairs(*pr) if pr is not None
                else (np.zeros(0, np.int64), np.zeros(0, np.int64))
            )
            l_idx, r_idx = jnp.asarray(l_idx), jnp.asarray(r_idx)

        # Unmatched-row passes, device-side: a scatter marks visited rows
        # and a flag-sort compaction extracts the unmatched index set (the
        # old np.setdiff1d pulled full row-index ranges to the host).
        # Right/full joins re-add unmatched right rows interleaved in probe
        # (right-row) order — the reference's apply_join_filter rebuilds
        # them inside the same probe batch (reference hash_join.rs:73-121),
        # so `... right join department` emits Finance between Marketing
        # and Engineering. Unmatched left rows come from a final pass and
        # append at the end (reference hash_join.rs:294-322).
        if op.join_type in ("left", "right", "full"):
            # fused outer-join emission: ONE mask+count program, then ONE
            # program interleaving/appending unmatched rows and gathering
            # every output column (was ~8 dispatches per outer join)
            need_r = op.join_type in ("right", "full")
            need_l = op.join_type in ("left", "full")
            l_idx, r_idx = jnp.asarray(l_idx), jnp.asarray(r_idx)
            outs = _unmatched_masks_jit(
                l_idx, r_idx, nl=left.num_rows, nr=right.num_rows,
                need_l=need_l, need_r=need_r,
            )
            dummy = jnp.zeros((0,), jnp.bool_)
            um_r_mask = um_l_mask = dummy
            n_um_r = n_um_l = 0
            k = 0
            if need_r:
                um_r_mask, n_um_r = outs[0], int(outs[1])
                k = 2
            if need_l:
                um_l_mask, n_um_l = outs[k], int(outs[k + 1])
            ld, lv, rd, rv = _outer_join_tail_jit(
                l_idx, r_idx, um_r_mask, um_l_mask,
                tuple(c.data for c in left.columns),
                tuple(c.valid for c in left.columns),
                tuple(c.data for c in right.columns),
                tuple(c.valid for c in right.columns),
                n_um_r=n_um_r, n_um_l=n_um_l, jt=op.join_type,
                l_fills=_null_fills(left.columns),
                r_fills=_null_fills(right.columns),
            )
            n_out = int(l_idx.shape[0]) + n_um_r + n_um_l
            cols = [
                Column(c.type, d, v) for c, d, v in zip(left.columns, ld, lv)
            ] + [
                Column(c.type, d, v) for c, d, v in zip(right.columns, rd, rv)
            ]
            return DeviceBatch(_schema(op), cols, n_out)
        return _merge_rows(op, left, right, l_idx, r_idx)

    def _residual_pairs_chunked(self, op, left, right, pr, budget: int):
        """Expand + residual-filter join pairs in bounded-memory chunks.

        Peak live cells are O(budget + survivors) instead of O(total pairs):
        probe rows are partitioned so each chunk's pair span fits
        budget (+ one row's overhang), one shared-shape jitted program
        expands each chunk, the residual filter compacts it to a pow2-padded
        survivor block, and a final global compaction re-assembles exact
        (l_idx, r_idx) in unchanged probe-major order. The single-device
        counterpart of the reference's per-batch probe stream
        (hash_join.rs:207-250), which never holds the full pair set."""
        from sqlrs_tpu.ops.fused import gather_arrays
        from sqlrs_tpu.ops.hash_table import next_pow2

        starts, counts, order, total = pr
        nr = counts.shape[0]
        maxc = int(jnp.max(counts))
        B2 = budget + maxc
        n_chunks = -(-total // budget)
        span_start = jnp.cumsum(counts) - counts
        bounds = np.array(
            jnp.searchsorted(
                span_start,
                jnp.arange(n_chunks + 1, dtype=jnp.int64) * budget,
            )
        )
        bounds[-1] = nr
        W = int(max(int(bounds[k + 1] - bounds[k]) for k in range(n_chunks)))
        W = max(W, 1)
        pad = jnp.zeros((W,), counts.dtype)
        starts_p = jnp.concatenate([starts, pad])
        counts_p = jnp.concatenate([counts, pad])

        parts_l, parts_r, parts_v, cnts = [], [], [], []
        for k in range(n_chunks):
            r0, r1 = int(bounds[k]), int(bounds[k + 1])
            if r1 <= r0:
                continue
            l_c, r_c, valid = _expand_pair_chunk(
                starts_p, counts_p, order, r0, r1 - r0, W, B2
            )
            keep = _eval_residual_on_pairs(op.filter, left, right, l_c, r_c)
            kd = keep.data & keep.valid & valid
            cnt = int(jnp.sum(kd))
            if cnt == 0:
                continue
            width = min(next_pow2(cnt), B2)  # pow2 pad bounds compile variants
            sel = compact_indices(
                Column(LogicalType.BOOLEAN, kd, jnp.ones_like(kd)), width
            )
            l_k, r_k = gather_arrays((l_c, r_c), sel)
            parts_l.append(l_k)
            parts_r.append(r_k)
            parts_v.append(jnp.arange(width, dtype=jnp.int64) < cnt)
            cnts.append(cnt)
        if not parts_l:
            z = jnp.zeros((0,), jnp.int64)
            return z, z
        L = jnp.concatenate(parts_l)
        R = jnp.concatenate(parts_r)
        V = jnp.concatenate(parts_v)
        sel = compact_indices(
            Column(LogicalType.BOOLEAN, V, jnp.ones_like(V)), sum(cnts)
        )
        return gather_arrays((L, R), sel)

    def _exec_CrossJoin(self, op: P.PhysicalCrossJoin) -> DeviceBatch:
        left = self.execute(op.children[0])
        right = self.execute(op.children[1])
        nl, nr = left.num_rows, right.num_rows
        # left-major emission (reference src/executor/join/cross_join.rs:25)
        # — indices generated AND gathered in ONE device program (the old
        # path materialized two nl*nr host arrays and shipped them over)
        ld, lv, rd, rv = _cross_join_jit(
            tuple(c.data for c in left.columns),
            tuple(c.valid for c in left.columns),
            tuple(c.data for c in right.columns),
            tuple(c.valid for c in right.columns),
            nl=nl, nr=nr,
        )
        cols = [
            Column(c.type, d, v) for c, d, v in zip(left.columns, ld, lv)
        ] + [
            Column(c.type, d, v) for c, d, v in zip(right.columns, rd, rv)
        ]
        return DeviceBatch(_schema(op), cols, nl * nr)

    # ---- DDL / DML ---------------------------------------------------------------

    def _exec_CreateTable(self, op: P.PhysicalCreateTable) -> DeviceBatch:
        from sqlrs_tpu.catalog.catalog import ColumnDefinition

        storage = DataTable(op.column_names, op.column_types)
        self.db.catalog.create_table(
            op.table_name,
            [ColumnDefinition(n, t) for n, t in zip(op.column_names, op.column_types)],
            storage,
            schema=op.schema_name,
        )
        if op.children:  # CREATE TABLE AS
            batch = self.execute(op.children[0])
            storage.append_batch(batch)
        return _empty_result()

    def _exec_Insert(self, op: P.PhysicalInsert) -> DeviceBatch:
        child = self.execute(op.children[0])
        entry = self.db.catalog.table(op.table_name)
        cols: list[Column] = []
        for ti, t in enumerate(op.expected_types):
            src = op.column_index_map[ti]
            if src is None:
                data, valid = null_column(t, child.num_rows)
                cols.append(Column.from_numpy(t, data, valid))
            else:
                cols.append(ew.cast_column(child.columns[src], t))
        entry.storage.append_batch(
            DeviceBatch(entry.storage.schema, cols, child.num_rows)
        )
        return _empty_result()

    def _exec_CreateView(self, op: P.PhysicalCreateView) -> DeviceBatch:
        self.db.catalog.create_view(
            op.view_name, op.column_names, op.query_ast, schema=op.schema_name
        )
        return _empty_result()

    def _exec_Drop(self, op: P.PhysicalDrop) -> DeviceBatch:
        from sqlrs_tpu.errors import CatalogError

        try:
            if op.kind == "view":
                self.db.catalog.drop_view(op.name, schema=op.schema_name)
            else:
                self.db.catalog.drop_table(op.name, schema=op.schema_name)
        except CatalogError:
            if not op.if_exists:
                raise
        return _empty_result()

    def _exec_Explain(self, op: P.PhysicalExplain) -> DeviceBatch:
        from sqlrs_tpu.types import ScalarValue

        keys = list(op.plan_strings.keys())
        vals = [op.plan_strings[k] for k in keys]
        cols = [
            Column.from_scalars(
                LogicalType.VARCHAR, [ScalarValue.varchar(k) for k in keys]
            ),
            Column.from_scalars(
                LogicalType.VARCHAR, [ScalarValue.varchar(v) for v in vals]
            ),
        ]
        return DeviceBatch(_schema(op), cols, len(keys))


def _schema(op: P.PhysicalOperator) -> Schema:
    return Schema(tuple(SchemaField(n, t) for n, t in zip(op.names, op.types)))


def _empty_result() -> DeviceBatch:
    return DeviceBatch(Schema(()), [], 0)


@jax.jit
def _gather_pairs_jit(l_datas, l_valids, r_datas, r_valids, li, ri, l_live):
    """Materialize join output columns in ONE compiled program (per-column
    eager gathers cost a dispatch each)."""
    ld = tuple(a[li] for a in l_datas)
    lv = tuple(a[li] for a in l_valids)
    if l_live is not None:
        lv = tuple(v & l_live for v in lv)
    return ld, lv, tuple(a[ri] for a in r_datas), tuple(a[ri] for a in r_valids)


def _concat_schema(left: DeviceBatch, right: DeviceBatch) -> Schema:
    return Schema(tuple(left.schema.fields) + tuple(right.schema.fields))


def _expand_pair_chunk(starts_p, counts_p, order, r0, nrows, W: int, B2: int):
    """One bounded chunk of pair expansion (jitted, shapes shared across
    chunks: W probe rows in, B2 padded pairs out). `starts_p`/`counts_p`
    are W-padded so the dynamic_slice never clamps (clamping would silently
    misalign probe row ids)."""
    return _expand_pair_chunk_jit(starts_p, counts_p, order, r0, nrows, W, B2)


@functools.partial(jax.jit, static_argnums=(5, 6))
def _expand_pair_chunk_jit(starts_p, counts_p, order, r0, nrows, W, B2):
    r0 = jnp.asarray(r0, jnp.int64)
    s = jax.lax.dynamic_slice(starts_p, (r0,), (W,))
    c = jax.lax.dynamic_slice(counts_p, (r0,), (W,))
    c = jnp.where(jnp.arange(W) < nrows, c, 0)
    tot = jnp.sum(c)
    seq = jnp.arange(B2, dtype=jnp.int64)
    loc = jnp.repeat(jnp.arange(W, dtype=jnp.int64), c, total_repeat_length=B2)
    base = jnp.repeat(jnp.cumsum(c) - c, c, total_repeat_length=B2)
    st = jnp.repeat(s, c, total_repeat_length=B2)
    valid = seq < tot
    pos = seq - base + st
    l_idx = order[jnp.clip(pos, 0, order.shape[0] - 1)]
    r_idx = jnp.clip(r0 + loc, 0, counts_p.shape[0] - W - 1)  # < real nr
    return l_idx, r_idx, valid


def _residual_subplan(filter_expr, left, right):
    """(expr2, sub_fields, l_pick, r_pick): the filter rewritten against the
    compacted layout of ONLY the columns it references, plus per-side column
    index lists (the filter is positional against left++right)."""
    from sqlrs_tpu.binder.expression import BoundReference, rewrite_expr, visit_expr

    refs: set[int] = set()

    def _collect(e):
        if isinstance(e, BoundReference):
            refs.add(e.index)

    visit_expr(filter_expr, _collect)
    order = sorted(refs)
    remap = {old: new for new, old in enumerate(order)}

    def _remap(e):
        if isinstance(e, BoundReference):
            return BoundReference(remap[e.index], e.type, e.column_name)
        return None

    expr2 = rewrite_expr(filter_expr, _remap)
    nl = len(left.columns)
    all_fields = tuple(left.schema.fields) + tuple(right.schema.fields)
    sub_fields = tuple(all_fields[i] for i in order)
    l_pick = [i for i in order if i < nl]
    r_pick = [i - nl for i in order if i >= nl]
    return expr2, sub_fields, l_pick, r_pick


# (expr repr, shapes, dict version) -> jitted phase-1 program | False when the
# expression concretizes at trace time (host string work) and can never fuse
_RESIDUAL_FUSED_CACHE: OrderedDict = OrderedDict()
_RESIDUAL_FUSED_CACHE_MAX = 256


def _residual_fused_phase1(filter_expr, left, right, pr):
    """Pair expansion + residual evaluation + survivor count in ONE compiled
    program: returns (l_idx, r_idx, keep, count) on device, or None when the
    expression cannot trace (eager fallback). The unfused chain costs four
    dispatches (expand, gather, eval, reduce)."""
    from sqlrs_tpu.data.strings import GLOBAL_STRINGS
    from sqlrs_tpu.ops.join import _expand_body

    starts, counts, order_arr, total = pr
    expr2, sub_fields, l_pick, r_pick = _residual_subplan(
        filter_expr, left, right
    )
    sig = (
        repr(expr2),
        total,
        tuple(
            (f.type, str(c.data.dtype), c.data.shape[0])
            for f, c in zip(left.schema.fields, left.columns)
        ),
        tuple(
            (f.type, str(c.data.dtype), c.data.shape[0])
            for f, c in zip(right.schema.fields, right.columns)
        ),
        len(GLOBAL_STRINGS),
    )
    entry = _RESIDUAL_FUSED_CACHE.get(sig)
    if entry is False:
        return None
    if entry is not None:
        _RESIDUAL_FUSED_CACHE.move_to_end(sig)
    else:
        sub_schema = Schema(sub_fields)
        n_l = len(l_pick)

        def phase1(starts, counts, order_arr, datas, valids):
            l_idx, r_idx = _expand_body(starts, counts, order_arr, total)
            cols = [
                Column(f.type, d[l_idx], v[l_idx])
                for f, d, v in zip(sub_fields[:n_l], datas[:n_l], valids[:n_l])
            ] + [
                Column(f.type, d[r_idx], v[r_idx])
                for f, d, v in zip(sub_fields[n_l:], datas[n_l:], valids[n_l:])
            ]
            pairs = DeviceBatch(sub_schema, cols, total)
            keep = execute_expr(expr2, pairs)
            kd = jnp.logical_and(keep.data, keep.valid)
            return l_idx, r_idx, kd, jnp.sum(kd)

        entry = jax.jit(phase1)
        _RESIDUAL_FUSED_CACHE[sig] = entry
        while len(_RESIDUAL_FUSED_CACHE) > _RESIDUAL_FUSED_CACHE_MAX:
            _RESIDUAL_FUSED_CACHE.popitem(last=False)
    datas = tuple(left.columns[i].data for i in l_pick) + tuple(
        right.columns[i].data for i in r_pick
    )
    valids = tuple(left.columns[i].valid for i in l_pick) + tuple(
        right.columns[i].valid for i in r_pick
    )
    try:
        return entry(starts, counts, order_arr, datas, valids)
    except jax.errors.JAXTypeError:
        _RESIDUAL_FUSED_CACHE[sig] = False  # concretizes: never fusable
        return None
    except Exception:
        return None  # transient (OOM/backend): unfused fallback this once


def _reduce_one_ungrouped(a, col, n: int, alive=None) -> Column:
    rt = a.return_type()
    if col is None:  # count(*)
        if alive is None:
            data = jnp.full((1,), n, jnp.int64)
        else:
            data = jnp.sum(alive.astype(jnp.int64))[None]
        return Column(LogicalType.BIGINT, data, jnp.ones(1, jnp.bool_))
    ok = col.valid if alive is None else (col.valid & alive)
    cnt = jnp.sum(ok.astype(jnp.int64))
    has = (cnt > 0)[None]
    name = a.function_name
    if name == "count":
        return Column(LogicalType.BIGINT, cnt[None], jnp.ones(1, jnp.bool_))
    if name in ("sum", "avg"):
        acc_t = LogicalType.DOUBLE if name == "avg" else rt
        s = jnp.sum(
            jnp.where(ok, col.data.astype(numpy_dtype_for(acc_t)), 0)
        )
        if name == "avg":
            s = s / jnp.maximum(cnt, 1).astype(jnp.float64)
        return Column(rt, s[None].astype(numpy_dtype_for(rt)), has)
    if name in ("min", "max"):
        if col.type == LogicalType.VARCHAR:
            key, _ = orderable_key(col)
            big = jnp.iinfo(key.dtype).max
            k = jnp.where(ok, key, big if name == "min" else -big)
            i = jnp.argmin(k) if name == "min" else jnp.argmax(k)
            return Column(LogicalType.VARCHAR, col.data[i][None], has)
        dt = numpy_dtype_for(col.type)
        if col.type.is_float():
            sent = np.inf if name == "min" else -np.inf
        else:
            ii = np.iinfo(dt)
            sent = ii.max if name == "min" else ii.min
        v = jnp.where(ok, col.data, jnp.asarray(sent, col.data.dtype))
        r = jnp.min(v) if name == "min" else jnp.max(v)
        return Column(rt, r[None].astype(numpy_dtype_for(rt)), has)
    raise ExecutorError(f"unknown aggregate {name}")

# (agg reprs, shapes, alive?, dict version) -> jitted all-aggregates program
_UNGROUPED_FUSED_CACHE: OrderedDict = OrderedDict()
_UNGROUPED_FUSED_CACHE_MAX = 256


def _reduce_ungrouped_fused(aggs, slots, arg_cols, n: int, alive=None):
    """ALL ungrouped aggregates of a SimpleAgg in ONE compiled program
    (each reduction alone costs 3-6 eager dispatches — where/sum/compare —
    so a multi-aggregate SELECT paid a dispatch per op). Falls back to the
    per-aggregate eager path if the fused program cannot trace."""
    from sqlrs_tpu.data.strings import GLOBAL_STRINGS

    sig = (
        tuple(repr(a) for a in aggs),
        tuple(slots),
        tuple((c.type, str(c.data.dtype)) for c in arg_cols),
        n,
        alive is not None,
        len(GLOBAL_STRINGS),
    )
    entry = _UNGROUPED_FUSED_CACHE.get(sig)
    if entry is False:
        return _reduce_ungrouped_eager(aggs, slots, arg_cols, n, alive)
    if entry is not None:
        _UNGROUPED_FUSED_CACHE.move_to_end(sig)
    else:
        types = [c.type for c in arg_cols]
        out_types: list = []

        def prog(datas, valids, alive_arr):
            if isinstance(alive_arr, tuple):  # raw (keep_data, keep_valid)
                alive_arr = jnp.logical_and(alive_arr[0], alive_arr[1])
            cols = [
                Column(t, d, v) for t, d, v in zip(types, datas, valids)
            ]
            outs = [
                _reduce_one_ungrouped(
                    a, cols[s] if s is not None else None, n, alive_arr
                )
                for a, s in zip(aggs, slots)
            ]
            if not out_types:
                out_types.extend(c.type for c in outs)
            return tuple(c.data for c in outs), tuple(c.valid for c in outs)

        entry = (jax.jit(prog), out_types)
        _UNGROUPED_FUSED_CACHE[sig] = entry
        while len(_UNGROUPED_FUSED_CACHE) > _UNGROUPED_FUSED_CACHE_MAX:
            _UNGROUPED_FUSED_CACHE.popitem(last=False)
    fn, out_types = entry
    try:
        od, ov = fn(
            tuple(c.data for c in arg_cols),
            tuple(c.valid for c in arg_cols),
            alive,
        )
    except jax.errors.JAXTypeError:
        _UNGROUPED_FUSED_CACHE[sig] = False
        return _reduce_ungrouped_eager(aggs, slots, arg_cols, n, alive)
    except Exception:
        return _reduce_ungrouped_eager(aggs, slots, arg_cols, n, alive)
    return [Column(t, d, v) for t, d, v in zip(out_types, od, ov)]


def _reduce_ungrouped_eager(aggs, slots, arg_cols, n: int, alive=None):
    if isinstance(alive, tuple):  # raw (keep_data, keep_valid) pair
        alive = jnp.logical_and(alive[0], alive[1])
    return [
        _reduce_one_ungrouped(
            a, arg_cols[s] if s is not None else None, n, alive
        )
        for a, s in zip(aggs, slots)
    ]


@jax.jit
def _ne_mark_jit(counts_all, counts_eq, a_valid):
    """Count-based `a <> b` mark: a key match with a DIFFERENT b exists."""
    return a_valid & (counts_all - counts_eq > 0)


def _as_bool_mark(matched):
    # _mark_matches hands back raw match COUNTS where it can (the >0 test
    # fuses here instead of costing its own dispatch)
    return matched if matched.dtype == jnp.bool_ else matched > 0


@functools.partial(jax.jit, static_argnames=("anti", "null_guard"))
def _semi_keep_jit(matched, x_valid, anti: bool, null_guard: bool,
                   alive=None):
    """Semi/anti keep mask + survivor count in ONE program (the eager
    not/and/sum chain cost three dispatches). `alive` is a fused-Filter
    (keep_data, keep_valid) pair from the LEFT child: dead rows drop here,
    in the same compaction as the semi/anti keep itself."""
    m = _as_bool_mark(matched)
    keep = jnp.logical_not(m) if anti else m
    if null_guard:
        keep = keep & x_valid
    if alive is not None:
        keep = keep & jnp.logical_and(alive[0], alive[1])
    return keep, jnp.sum(keep)


@jax.jit
def _and_alive_jit(valid, alive_pair):
    """validity AND a folded-Filter (keep_data, keep_valid) pair."""
    return jnp.logical_and(
        valid, jnp.logical_and(alive_pair[0], alive_pair[1])
    )


@jax.jit
def _semi_keep_corr_jit(matched, x_valid, nonempty, has_null):
    """Correlated null-aware NOT IN keep mask + count (anti only)."""
    unknown = _as_bool_mark(nonempty) & (
        jnp.logical_not(x_valid) | _as_bool_mark(has_null)
    )
    keep = jnp.logical_not(_as_bool_mark(matched)) & jnp.logical_not(unknown)
    return keep, jnp.sum(keep)


@functools.partial(jax.jit, static_argnames=("count",))
def _compact_pairs_jit(l_idx, r_idx, keep, count: int):
    """Surviving (l_idx, r_idx) in unchanged probe-major order: ONE stable
    3-operand flag sort (replaces separate compact_indices + gather)."""
    drop = jnp.logical_not(keep).astype(jnp.int32)
    _, li, ri = jax.lax.sort((drop, l_idx, r_idx), num_keys=1, is_stable=True)
    return li[:count], ri[:count]


@functools.partial(jax.jit, static_argnames=("nl", "nr", "need_l", "need_r"))
def _unmatched_masks_jit(l_idx, r_idx, nl: int, nr: int,
                         need_l: bool, need_r: bool):
    """Unmatched-row masks + counts for outer joins, ONE program (the old
    per-side scatter/not/sum chain cost ~4 dispatches per side)."""
    outs: list = []
    if need_r:
        um_r = jnp.logical_not(jnp.zeros((nr,), jnp.bool_).at[r_idx].set(True))
        outs += [um_r, jnp.sum(um_r)]
    if need_l:
        um_l = jnp.logical_not(jnp.zeros((nl,), jnp.bool_).at[l_idx].set(True))
        outs += [um_l, jnp.sum(um_l)]
    return tuple(outs)


@functools.partial(
    jax.jit, static_argnames=("n_um_r", "n_um_l", "jt", "l_fills", "r_fills")
)
def _outer_join_tail_jit(l_idx, r_idx, um_r_mask, um_l_mask,
                         l_datas, l_valids, r_datas, r_valids,
                         n_um_r: int, n_um_l: int, jt: str,
                         l_fills: tuple, r_fills: tuple):
    """The ENTIRE left/right/full join emission in ONE program: compact the
    unmatched indices, interleave unmatched-right rows at their probe
    positions (stable sort by probe row — reference hash_join.rs:73-121),
    append unmatched-left rows (hash_join.rs:294-322), gather every output
    column, and fill NULL lanes (valid=False, null_column fill values).
    The unfused chain cost ~8 dispatches per outer join."""
    all_l, all_r = l_idx, r_idx
    if jt in ("right", "full"):
        nr = um_r_mask.shape[0]
        _, perm = jax.lax.sort(
            (jnp.logical_not(um_r_mask).astype(jnp.int32),
             jnp.arange(nr, dtype=jnp.int64)),
            num_keys=1, is_stable=True,
        )
        um_r = perm[:n_um_r]
        all_l = jnp.concatenate([all_l, jnp.full((n_um_r,), jnp.int64(-1))])
        all_r = jnp.concatenate([all_r, um_r])
        all_r, all_l = jax.lax.sort((all_r, all_l), num_keys=1, is_stable=True)
    if jt in ("left", "full"):
        nl = um_l_mask.shape[0]
        _, perm = jax.lax.sort(
            (jnp.logical_not(um_l_mask).astype(jnp.int32),
             jnp.arange(nl, dtype=jnp.int64)),
            num_keys=1, is_stable=True,
        )
        um_l = perm[:n_um_l]
        all_l = jnp.concatenate([all_l, um_l])
        all_r = jnp.concatenate([all_r, jnp.full((n_um_l,), jnp.int64(-1))])
    li, l_live = jnp.maximum(all_l, 0), all_l >= 0
    ri, r_live = jnp.maximum(all_r, 0), all_r >= 0
    ld = tuple(
        jnp.where(l_live, a[li], jnp.asarray(f, a.dtype))
        for a, f in zip(l_datas, l_fills)
    )
    lv = tuple(a[li] & l_live for a in l_valids)
    rd = tuple(
        jnp.where(r_live, a[ri], jnp.asarray(f, a.dtype))
        for a, f in zip(r_datas, r_fills)
    )
    rv = tuple(a[ri] & r_live for a in r_valids)
    return ld, lv, rd, rv


@functools.partial(jax.jit, static_argnames=("nl", "nr"))
def _cross_join_jit(l_datas, l_valids, r_datas, r_valids, nl: int, nr: int):
    """Cross-join emission (left-major) in ONE program."""
    l_idx = jnp.repeat(jnp.arange(nl, dtype=jnp.int64), nr)
    r_idx = jnp.tile(jnp.arange(nr, dtype=jnp.int64), nl)
    return (
        tuple(a[l_idx] for a in l_datas),
        tuple(a[l_idx] for a in l_valids),
        tuple(a[r_idx] for a in r_datas),
        tuple(a[r_idx] for a in r_valids),
    )


def _null_fills(cols) -> tuple:
    return tuple(
        NULL_CODE if c.type == LogicalType.VARCHAR else 0 for c in cols
    )


@functools.partial(jax.jit, static_argnames=("count",))
def _compact_gather_pairs_jit(
    l_idx, r_idx, keep, l_datas, l_valids, r_datas, r_valids, count: int
):
    """Residual-join tail for INNER joins: compact the survivors AND gather
    every output column in ONE program."""
    drop = jnp.logical_not(keep).astype(jnp.int32)
    _, li, ri = jax.lax.sort((drop, l_idx, r_idx), num_keys=1, is_stable=True)
    li, ri = li[:count], ri[:count]
    return (
        tuple(a[li] for a in l_datas),
        tuple(a[li] for a in l_valids),
        tuple(a[ri] for a in r_datas),
        tuple(a[ri] for a in r_valids),
    )


def _eval_residual_on_pairs(filter_expr, left, right, l_idx, r_idx):
    """Evaluate a join residual over (l_idx, r_idx) pairs, gathering ONLY
    the columns the filter references (the filter is positional against the
    left++right layout). A wide join used to materialize every output
    column just to decide which pairs survive — at SF1 Q21 that is
    gigabytes of unused gather traffic."""
    expr2, sub_fields, l_pick, r_pick = _residual_subplan(
        filter_expr, left, right
    )
    n_l = len(l_pick)
    left_sub = DeviceBatch(
        Schema(sub_fields[:n_l]),
        [left.columns[i] for i in l_pick],
        left.num_rows,
    )
    right_sub = DeviceBatch(
        Schema(sub_fields[n_l:]),
        [right.columns[i] for i in r_pick],
        right.num_rows,
    )
    pairs = _merge_rows_schema(
        Schema(sub_fields), left_sub, right_sub, l_idx, r_idx
    )
    # fused: a Q19-sized residual (nested AND/OR over a dozen comparisons)
    # costs ~450 eager dispatches — one compiled program instead
    (keep,) = execute_exprs_fused([expr2], pairs)
    return keep


def _merge_rows_schema(schema, left, right, l_idx, r_idx) -> DeviceBatch:
    """_merge_rows against an explicit output schema (used where the
    operator's own schema is not left++right, e.g. semi/anti residual
    evaluation)."""

    class _Shim:
        pass

    shim = _Shim()
    shim.names = [f.name for f in schema.fields]
    shim.types = [f.type for f in schema.fields]
    return _merge_rows(shim, left, right, l_idx, r_idx)


def _gather_pairs(op, left, right, li, ri, l_live=None) -> DeviceBatch:
    ld, lv, rd, rv = _gather_pairs_jit(
        tuple(c.data for c in left.columns),
        tuple(c.valid for c in left.columns),
        tuple(c.data for c in right.columns),
        tuple(c.valid for c in right.columns),
        li,
        ri,
        l_live,
    )
    n = int(li.shape[0])
    cols: list[Column] = [
        Column(c.type, d, v) for c, d, v in zip(left.columns, ld, lv)
    ]
    cols += [Column(c.type, d, v) for c, d, v in zip(right.columns, rd, rv)]
    return DeviceBatch(_schema(op), cols, n)




def _merge_rows(op, left: DeviceBatch, right: DeviceBatch, l_idx, r_idx) -> DeviceBatch:
    """Gather (left_rows ++ right_rows) into the join output layout; None on a
    side means all-NULL columns (unmatched-row passes)."""
    if l_idx is not None and r_idx is not None:
        return _gather_pairs(
            op, left, right, jnp.asarray(l_idx), jnp.asarray(r_idx)
        )
    n = len(l_idx) if l_idx is not None else len(r_idx)
    cols: list[Column] = []
    if l_idx is not None:
        li = jnp.asarray(l_idx)
        cols.extend(c.take(li) for c in left.columns)
    else:
        for c in left.columns:
            data, valid = null_column(c.type, n)
            cols.append(Column.from_numpy(c.type, data, valid))
    if r_idx is not None:
        ri = jnp.asarray(r_idx)
        cols.extend(c.take(ri) for c in right.columns)
    else:
        for c in right.columns:
            data, valid = null_column(c.type, n)
            cols.append(Column.from_numpy(c.type, data, valid))
    return DeviceBatch(_schema(op), cols, n)
