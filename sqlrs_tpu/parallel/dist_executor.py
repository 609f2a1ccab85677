"""SQL-level distributed execution: physical plans over row-sharded tables.

The reference has NO distributed execution (SURVEY.md §2.3: single-process
tokio streams, no exchange operator). This module is the from-scratch
counterpart: a second executor personality that runs the SAME
physical plans the single-device executor runs, but over tables row-sharded
across a `jax.sharding.Mesh` — the "partitioned parallel scan" (DP) component
of the parallelism table, composed with the exchange/partial-agg/join
strategies in parallel/dist_ops.py.

Design (SURVEY.md §7 "fixed-capacity batches + valid-count scalars"):

- `ShardedBatch`: columns are jax arrays laid out P("x") over the mesh —
  contiguous row blocks per device — padded to a multiple of n_dev, plus an
  `alive` row mask. Filters only clear `alive` bits (no compaction ⇒ no
  communication, static shapes); compaction happens once, at the collect
  boundary.
- Row order: because sharding is block-contiguous and dead rows are masked
  (never reordered), collecting a ShardedBatch yields rows in EXACTLY the
  single-device order. Distributed results equal the single-device
  engine's, ordering included, except that DOUBLE sums (per-shard partials,
  then a combine) may differ in the last bits.
- Operators keep data sharded as long as the op is expressible with static
  shapes and mesh collectives (scan/filter/project/simple & grouped agg/
  hash join/ORDER BY/LIMIT/DISTINCT); the rest (DISTINCT aggregates, cross
  join, DDL) materializes and delegates to the standard executor —
  pipeline breakers land exactly where the reference materializes
  (order.rs:14, hash_agg.rs:32, hash_join.rs:187).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sqlrs_tpu.data import Column, DeviceBatch, Schema
from sqlrs_tpu.exec.executor import Executor, _schema
from sqlrs_tpu.exec.expression_executor import execute_expr, execute_exprs_fused
from sqlrs_tpu.ops import elementwise as ew
from sqlrs_tpu.parallel.mesh import DATA_AXIS, replicated, row_sharding, spmd


def _host(x) -> np.ndarray:
    """Host fetch that works when `x` spans processes (multi-host mesh):
    plain np.asarray raises for arrays with non-addressable shards, so
    cross-process-sharded values go through process_allgather."""
    if (
        isinstance(x, jax.Array)
        and not x.is_fully_addressable
        and not x.is_fully_replicated
    ):
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)
from sqlrs_tpu.plan import physical as P
from sqlrs_tpu.types import LogicalType, ScalarValue, numpy_dtype_for


@dataclass
class ShardedBatch:
    """Row-sharded columnar batch: fixed capacity (multiple of n_dev),
    `alive` marks live rows. `parts` holds small host-side row blocks that
    belong AFTER all sharded rows (unmatched-left join output, reference
    hash_join.rs:294-322 appends them last).

    `rowid`, when set, is the LOGICAL row-order key (int64, sharded like the
    columns): the batch's single-device-equivalent order is ascending rowid
    among alive rows, not physical position. Shuffle-repartition joins set
    it (the exchange scrambles physical placement); collect sorts by it, and
    order-sensitive operators (first-appearance GROUP BY, ORDER BY ties,
    LIMIT) consume it instead of position. rowid None == position order."""

    schema: Schema
    columns: list[Column]  # data/valid sharded P(axis)
    alive: jnp.ndarray  # bool[capacity], sharded P(axis)
    mesh: jax.sharding.Mesh
    parts: list[DeviceBatch] = field(default_factory=list)
    rowid: Optional[jnp.ndarray] = None  # int64[capacity] logical order

    @property
    def capacity(self) -> int:
        return int(self.alive.shape[0])

    def view(self) -> DeviceBatch:
        """Expression-evaluation view (capacity rows; dead rows hold garbage
        that downstream masks ignore)."""
        return DeviceBatch(self.schema, self.columns, self.capacity)

    def with_columns(self, schema: Schema, columns: list[Column]) -> "ShardedBatch":
        return ShardedBatch(
            schema, columns, self.alive, self.mesh, list(self.parts), self.rowid
        )

    def to_device_batch(self) -> DeviceBatch:
        """Collect: gather shards, compact dead rows. Preserves single-device
        row order (block-contiguous sharding + stable masking; rowid-sorted
        when the physical layout was scrambled by an exchange)."""
        alive = _host(self.alive)
        idx = np.nonzero(alive)[0]
        if self.rowid is not None and len(idx):
            idx = idx[np.argsort(_host(self.rowid)[idx], kind="stable")]
        cols = []
        for c in self.columns:
            data = _host(c.data)[idx]
            valid = _host(c.valid)[idx]
            cols.append(Column.from_numpy(c.type, data, valid))
        out = DeviceBatch(self.schema, cols, len(idx))
        if self.parts:
            out = DeviceBatch.concat([out] + self.parts)
        return out


def shard_batch(batch: DeviceBatch, mesh: jax.sharding.Mesh) -> ShardedBatch:
    """Pad rows to a multiple of n_dev and lay columns out P(axis) — the
    partitioned parallel scan (each device holds one contiguous row block)."""
    n_dev = mesh.devices.size
    n = batch.num_rows
    cap = max(((n + n_dev - 1) // n_dev) * n_dev, n_dev)
    sh = row_sharding(mesh)
    cols = []
    for c in batch.columns:
        data = np.zeros(cap, dtype=numpy_dtype_for(c.type))
        valid = np.zeros(cap, dtype=np.bool_)
        data[:n] = np.asarray(c.data)
        valid[:n] = np.asarray(c.valid)
        cols.append(
            Column(c.type, jax.device_put(jnp.asarray(data), sh),
                   jax.device_put(jnp.asarray(valid), sh))
        )
    alive = np.zeros(cap, dtype=np.bool_)
    alive[:n] = True
    return ShardedBatch(batch.schema, cols, jax.device_put(jnp.asarray(alive), sh), mesh)


class DistributedExecutor:
    """Distributed personality of exec/executor.Executor: same physical plan
    IR, sharded data plane. Unsupported operators materialize their inputs
    and delegate to the single-device executor (correctness is never gated on
    distribution support)."""

    def __init__(self, db, mesh, profile=None) -> None:
        self.db = db
        self.mesh = mesh
        self.profile = profile

    # ---- entry -----------------------------------------------------------------

    def run(self, op: P.PhysicalOperator) -> DeviceBatch:
        out = self.execute(op)
        return out.to_device_batch() if isinstance(out, ShardedBatch) else out

    def execute(self, op: P.PhysicalOperator):
        name = type(op).__name__.removeprefix("Physical")
        method = getattr(self, "_dexec_" + name, None)
        if method is None:
            return self._fallback(op)
        if self.profile is None:
            return method(op)
        with self.profile.measure("dist:" + op.explain_line()[:54]) as stats:
            out = method(op)
            if isinstance(out, ShardedBatch):
                stats.rows_out = int(_host(jnp.sum(out.alive)))
            else:
                stats.rows_out = out.num_rows
        return out

    def _fallback(self, op: P.PhysicalOperator) -> DeviceBatch:
        """Materialize children, then run the standard executor for this op."""
        cache = {
            id(c): self._materialize(self.execute(c)) for c in op.children
        }
        return _DelegatingExecutor(self.db, cache).execute(op)

    @staticmethod
    def _materialize(res) -> DeviceBatch:
        return res.to_device_batch() if isinstance(res, ShardedBatch) else res

    # ---- scans -----------------------------------------------------------------

    def _dexec_Explain(self, op):
        # plan strings are pre-materialized; never execute the child
        return _DelegatingExecutor(self.db, {}).execute(op)

    def _dexec_TableScan(self, op: P.PhysicalTableScan):
        fn = self.db.catalog.table_function(op.function_name)
        batch = fn.execute(self.db, op.bind_data, op.projection, op.bounds)
        return shard_batch(batch, self.mesh)

    # ---- row-wise (zero-communication SPMD) ----------------------------------------

    def _dexec_Projection(self, op: P.PhysicalProjection):
        child = self.execute(op.children[0])
        if not isinstance(child, ShardedBatch):
            return self._delegate(op, child)
        cols = execute_exprs_fused(op.exprs, child.view())
        out = child.with_columns(_schema(op), cols)
        out.parts = [
            DeviceBatch(
                _schema(op), [execute_expr(e, p) for e in op.exprs], p.num_rows
            )
            for p in child.parts
        ]
        return out

    def _dexec_Filter(self, op: P.PhysicalFilter):
        child = self.execute(op.children[0])
        if not isinstance(child, ShardedBatch):
            return self._delegate(op, child)
        (keep,) = execute_exprs_fused([op.predicate], child.view())
        alive = child.alive & keep.data & keep.valid
        out = ShardedBatch(
            child.schema, child.columns, alive, self.mesh, rowid=child.rowid
        )
        for p in child.parts:
            k = execute_expr(op.predicate, p)
            out.parts.append(p.take(ew.selection_to_indices(k)))
        return out

    def _dexec_Order(self, op: P.PhysicalOrder):
        """Distributed ORDER BY: sample-sort exchange on the first key (ties
        share a bucket), local stable sort with the global row index as the
        final tiebreak — collected output is bit-exact with the
        single-device stable sort. Doubles as compaction (dead rows are
        dropped by the exchange)."""
        child = self.execute(op.children[0])
        if not isinstance(child, ShardedBatch) or child.parts:
            return self._delegate(op, child)
        from sqlrs_tpu.ops.sort import _directed_key
        from sqlrs_tpu.parallel.dist_ops import dist_sort_rows

        view = child.view()
        key_cols = execute_exprs_fused([e for e, _ in op.items], view)
        dkeys = [
            _directed_key(c, asc) for c, (_, asc) in zip(key_cols, op.items)
        ]
        payload = []
        bool_cols = []
        for c in child.columns:
            is_bool = c.data.dtype == jnp.bool_
            bool_cols.append(is_bool)
            payload.append(c.data.astype(jnp.int32) if is_bool else c.data)
            payload.append(c.valid.astype(jnp.int32))  # sort-payload safe
        n_dev = self.mesh.devices.size
        cap = child.capacity
        bucket_capacity = max(4 * cap // (n_dev * n_dev), 64)
        while True:
            _k, pays, alive, overflow = dist_sort_rows(
                self.mesh, dkeys, payload, child.alive, bucket_capacity,
                rowid=child.rowid,
            )
            if overflow == 0:
                break
            if bucket_capacity >= cap // n_dev + 64:
                return self._delegate(op, child)  # pathological skew
            bucket_capacity = min(bucket_capacity * 4, cap // n_dev + 64)
        cols = []
        for i, c in enumerate(child.columns):
            data, valid = pays[2 * i], pays[2 * i + 1] > 0
            if bool_cols[i]:
                data = data.astype(jnp.bool_)
            cols.append(Column(c.type, data, valid))
        return ShardedBatch(child.schema, cols, alive, self.mesh)

    def _dexec_Limit(self, op: P.PhysicalLimit):
        """LIMIT/OFFSET without materializing: a global prefix count of live
        rows (XLA lowers the cumsum over the sharded axis to a collective
        scan) masks rows outside the window — SURVEY.md §2.3 'per-host count
        + prefix-sum across hosts'."""
        child = self.execute(op.children[0])
        if not isinstance(child, ShardedBatch) or child.parts or child.rowid is not None:
            return self._delegate(op, child)
        offset = op.offset or 0
        pos = jnp.cumsum(child.alive.astype(jnp.int64)) - 1  # rank among live
        keep = child.alive & (pos >= offset)
        if op.limit is not None:
            keep = keep & (pos < offset + op.limit)
        return ShardedBatch(child.schema, child.columns, keep, self.mesh)

    # ---- ungrouped aggregation: local partials + XLA-inserted psum ----------------

    def _dexec_SimpleAgg(self, op: P.PhysicalSimpleAgg):
        child = self.execute(op.children[0])
        if not isinstance(child, ShardedBatch) or child.parts:
            return self._delegate(op, child)
        if any(a.distinct for a in op.aggregates):
            return self._delegate(op, child.to_device_batch())
        view = child.view()
        alive = child.alive
        out_vals: list[ScalarValue] = []
        for a in op.aggregates:
            out_vals.append(self._simple_agg_value(a, view, alive))
        cols = [
            Column.from_scalars(a.return_type(), [v])
            for a, v in zip(op.aggregates, out_vals)
        ]
        return DeviceBatch(_schema(op), cols, 1)

    def _simple_agg_value(self, a, view: DeviceBatch, alive) -> ScalarValue:
        rt = a.return_type()
        if a.arg is None:  # count(*)
            return ScalarValue(rt, int(_host(jnp.sum(alive))))
        col = execute_expr(a.arg, view)
        ok = alive & col.valid
        cnt = int(_host(jnp.sum(ok)))
        name = a.function_name
        if name == "count":
            return ScalarValue(rt, cnt)
        if cnt == 0:
            return ScalarValue(rt, None)
        if name in ("sum", "avg"):
            acc_t = np.float64 if name == "avg" else numpy_dtype_for(rt)
            s = jnp.sum(jnp.where(ok, col.data.astype(acc_t), 0))
            if name == "avg":
                return ScalarValue(rt, float(s) / cnt)
            v = float(s) if rt.is_float() else int(s)
            return ScalarValue(rt, v)
        if name in ("min", "max"):
            if col.type == LogicalType.VARCHAR:
                from sqlrs_tpu.ops.sort import orderable_key

                key, _ = orderable_key(col)
                big = jnp.iinfo(key.dtype).max
                k = jnp.where(ok, key, big if name == "min" else -big)
                i = int(_host(jnp.argmin(k) if name == "min" else jnp.argmax(k)))
                return view_scalar(col, i)
            dt = numpy_dtype_for(col.type)
            if col.type.is_float():
                sent = np.inf if name == "min" else -np.inf
            else:
                ii = np.iinfo(dt)
                sent = ii.max if name == "min" else ii.min
            v = jnp.where(ok, col.data, jnp.asarray(sent, col.data.dtype))
            r = jnp.min(v) if name == "min" else jnp.max(v)
            return ScalarValue(rt, float(r) if rt.is_float() else int(r)).cast_to(rt)
        from sqlrs_tpu.errors import ExecutorError

        raise ExecutorError(f"unknown aggregate {name}")

    # ---- grouped aggregation: shard-local sorted partials + O(G) all_gather -------

    def _dexec_HashAgg(self, op: P.PhysicalHashAgg):
        fused = self._try_ring_agg_join(op)
        if fused is not None:
            return fused
        child = self.execute(op.children[0])
        if (
            not isinstance(child, ShardedBatch)
            or child.parts
            or any(a.distinct for a in op.aggregates)
        ):
            return self._delegate(op, child)
        return self._grouped_agg_dist(op, child)

    def _try_ring_agg_join(self, op: P.PhysicalHashAgg):
        """Fused ring aggregate-over-join (SURVEY §2.3 pipeline parallelism,
        made SQL-reachable): HashAgg directly over an inner single-key
        HashJoin, where every group key reads the build (dim) side and every
        aggregate argument reads the probe (fact) side, computes per-dim-row
        partials with parallel/dist_join.ring_agg_join — the join's pair set
        is NEVER materialized, no data is exchanged (the dim chunk rotates
        via ppermute, overlapped with probe compute), and the result feeds
        the standard distributed grouped-agg as a tiny dim-sized batch whose
        rowid = (min matching fact row, dim position) reproduces the
        reference's first-appearance group order (hash_agg.rs:85-111 over
        hash_join.rs:207-250 emission order) exactly.

        Returns None (caller falls back to join-then-agg) when the pattern
        or the policy doesn't fit. Policy: db.dist_join_policy == 'ring'
        forces the ring; 'auto' picks the ring when the build side has at
        least db.dist_ring_min_build (default 2^16) live rows (the regime
        where broadcast would replicate a fact-sized dim on every shard)
        and the broadcast-fused kernel (dist_join.broadcast_agg_join — one
        O(G) all_gather + one shard-local probe pass, strategy
        'broadcast_fused') below it; explicit 'broadcast'/'shuffle' stay on
        the general pair-materializing machinery."""
        from sqlrs_tpu.binder.expression import (
            BoundAggregate,
            BoundReference,
            visit_expr,
        )
        from sqlrs_tpu.ops.sort import orderable_key
        from sqlrs_tpu.parallel.dist_join import ring_agg_join

        from sqlrs_tpu.binder.expression import rewrite_expr

        policy = getattr(self.db, "dist_join_policy", "auto")
        if policy in ("broadcast", "shuffle"):
            # explicit policies stay on the general machinery (the escape
            # hatch that keeps the pair-materializing paths exercised);
            # 'auto' routes matching rollups through a fused kernel below
            return None
        # see through column-pruning Projection chains between agg and join
        # by composing expressions (substitute refs with the projection's
        # exprs, level by level — rewrite_expr never recurses into a
        # replacement, so each level substitutes exactly once)
        node = op.children[0]
        proj_stack = []
        while isinstance(node, P.PhysicalProjection):
            proj_stack.append(node.exprs)
            node = node.children[0]
        jop = node
        if not isinstance(jop, P.PhysicalHashJoin):
            return None
        if (
            jop.join_type != "inner"
            or len(jop.on) not in (1, 2)
            or jop.filter is not None
        ):
            return None
        # DISTINCT combines across shards exactly via locally-deduped
        # (key, value) pair exchange + a second fused pass (round-4 VERDICT
        # item 7). Sound only when every output group is refined by the
        # join key (some group expr IS the build-side key reference): each
        # group's match set is then exactly one key's, so per-key distinct
        # partials equal the group's and duplicate dim rows combine with
        # max. Mirrors the single-device route's limits: count/sum/avg over
        # ONE shared argument; otherwise fall back.
        d_reprs = {repr(a.arg) for a in op.aggregates if a.distinct}
        has_distinct = bool(d_reprs)
        if has_distinct and (
            len(d_reprs) > 1
            or len(jop.on) != 1
            or any(
                a.distinct and a.function_name not in ("count", "sum", "avg")
                for a in op.aggregates
            )
        ):
            return None
        if len(jop.on) == 2:
            from sqlrs_tpu.exec.fused_route import _routable_key_type

            for lk, rk in jop.on:
                for k in (lk, rk):
                    if not _routable_key_type(k.type):
                        return None

        def compose(e):
            for exprs in proj_stack:
                e = rewrite_expr(
                    e,
                    lambda x: exprs[x.index]
                    if isinstance(x, BoundReference)
                    else None,
                )
            return e

        groups = [compose(g) for g in op.groups]
        aggregates = [
            a if a.arg is None else a.with_children((compose(a.arg),))
            for a in op.aggregates
        ]
        nb = len(jop.children[0].names)

        def side(exprs):
            lo, hi = [None], [None]

            def f(e):
                if isinstance(e, BoundReference):
                    lo[0] = e.index if lo[0] is None else min(lo[0], e.index)
                    hi[0] = e.index if hi[0] is None else max(hi[0], e.index)

            for e in exprs:
                visit_expr(e, f)
            return lo[0], hi[0]

        glo, ghi = side(groups)
        alo, ahi = side([a.arg for a in aggregates if a.arg is not None])
        if glo is None:
            return None
        # the dim side holds every group key, the fact side every aggregate
        # argument: dim = build (left) as written, or mirrored — dim = probe
        # (right), e.g. `from fact f join dim d ... group by d.k`
        mirrored = glo >= nb
        if mirrored and (has_distinct or (alo is not None and ahi >= nb)):
            return None
        if not mirrored and (ghi >= nb or (alo is not None and alo < nb)):
            return None
        if has_distinct:
            lkey = jop.on[0][0]
            from sqlrs_tpu.binder.expression import (
                BoundReference as _BR,
            )

            if not isinstance(lkey, _BR) or not any(
                isinstance(g, _BR) and g.index == lkey.index for g in groups
            ):
                return None  # groups not refined by the join key
            if lkey.type.is_float():
                return None  # float keys: no integer hash for the exchange
            d_types = {
                a.arg.return_type()
                for a in aggregates
                if a.distinct and a.function_name in ("sum", "avg")
            }
            if LogicalType.UBIGINT in d_types or any(
                t == LogicalType.VARCHAR for t in d_types
            ):
                return None  # no exact raw reconstruction for sums

        # from here on `left` is the dim side and `right` the fact side
        dim_ix = 1 if mirrored else 0
        left = self.execute(jop.children[dim_ix])
        right = self.execute(jop.children[1 - dim_ix])
        on = [(r, l) for l, r in jop.on] if mirrored else list(jop.on)
        ok = (
            isinstance(left, ShardedBatch)
            and isinstance(right, ShardedBatch)
            and not left.parts
            and not right.parts
            and left.rowid is None
            and right.rowid is None
        )
        use_ring = True
        if ok and policy == "auto":
            # small builds take the broadcast-fused kernel (ONE all_gather
            # + one probe pass — the distributed unification of the
            # single-device star-rollup route, round-4 VERDICT item 5);
            # large builds rotate chunks through the ring instead of
            # replicating a fact-sized dim on every shard
            min_build = getattr(self.db, "dist_ring_min_build", 1 << 16)
            use_ring = int(_host(jnp.sum(left.alive))) >= min_build
        if not ok:
            # fall back: re-dispatch through the normal agg-over-join path
            # (children re-execute; they are scan/filter chains here)
            child = self.execute(op.children[0])
            if (
                not isinstance(child, ShardedBatch)
                or child.parts
                or any(a.distinct for a in op.aggregates)
            ):
                return self._delegate(op, child)
            return self._grouped_agg_dist(op, child)

        lview, rview = left.view(), right.view()
        if len(jop.on) == 2:
            # composite two-key equi join: fold into one combined int key
            # (fused_route._combine_keys — same packing, masking and
            # overflow guard as the single-device route; ONE extra host
            # fetch for the meta)
            from sqlrs_tpu.exec.fused_route import _combine_keys

            (l1, r1), (l2, r2) = on
            d1, d2 = execute_exprs_fused([l1, l2], lview)
            f1, f2 = execute_exprs_fused([r1, r2], rview)
            fact_ck, fact_ok, dim_ck, dim_ok2, ck_meta = _combine_keys(
                f1.data, f1.valid, f2.data, f2.valid,
                d1.data, d1.valid, d2.data, d2.valid,
            )
            ckm = np.asarray(ck_meta)
            s_minor, mj_min = int(ckm[0]), int(ckm[1])
            f1_min, f1_max, d1_max = int(ckm[3]), int(ckm[4]), int(ckm[5])
            span = max(abs(f1_max - mj_min) + 1, abs(f1_min - mj_min) + 1,
                       abs(d1_max - mj_min) + 1)
            if s_minor <= 0 or span >= (1 << 61) // max(s_minor, 1):
                return None  # combined packing would overflow int64
            d_enc, d_kv = dim_ck, dim_ok2
            f_enc, f_kv = fact_ck, fact_ok
        else:
            # join `on` sides are resolved against their own child
            # (resolver _resolve_against per child); only agg args / group
            # keys index the merged join output and need the probe shift
            (d_col,) = execute_exprs_fused([on[0][0]], lview)
            (f_col,) = execute_exprs_fused([on[0][1]], rview)
            d_enc, d_kv = orderable_key(d_col)
            f_enc, f_kv = orderable_key(f_col)
            f_enc = f_enc.astype(d_enc.dtype)

        def shift(e):
            """merged-output reference -> the right child's own index"""
            return rewrite_expr(
                e,
                lambda x: BoundReference(x.index - nb, x.type, x.column_name)
                if isinstance(x, BoundReference)
                else None,
            )

        group_cols = execute_exprs_fused(
            [shift(g) for g in groups] if mirrored else groups, lview
        )
        agg_args = [
            execute_exprs_fused([a.arg if mirrored else shift(a.arg)],
                                rview)[0]
            if a.arg is not None
            else None
            for a in aggregates
        ]

        f_ok = right.alive & f_kv
        d_ok = left.alive & d_kv
        sh = row_sharding(self.mesh)
        f_rowid = jax.device_put(
            jnp.arange(right.capacity, dtype=jnp.int64), sh
        )

        # per-aggregate partial layout: sum/count -> one sum column (+ a
        # validity-count column so all-NULL partials stay NULL); min/max ->
        # one (directed key, raw) sort + a validity-count column
        sum_cols: list = []
        mm_specs: list = []
        plan = []  # (kind, sum_ix, vcnt_ix, mm_ix)
        d_arg_col = None
        d_need_sum = False
        for a, c in zip(aggregates, agg_args):
            if a.arg is None:
                plan.append(("count_star", None, None, None))
                continue
            name = a.function_name
            if a.distinct:
                # served by the deduped-pair second pass below
                plan.append((name + "_d", None, None, None))
                d_arg_col = c
                d_need_sum = d_need_sum or name in ("sum", "avg")
                continue
            if name == "count":
                plan.append(("count", len(sum_cols), None, None))
                sum_cols.append(c.valid.astype(jnp.int64))
            elif name in ("sum", "avg"):
                # avg decomposes into sum + non-NULL-count partials; the
                # division happens after the final combine (below). Int
                # args accumulate int64 so the final division matches the
                # single-device float64(int_sum)/count exactly.
                if name == "avg":
                    acc_dt = (
                        jnp.float64
                        if jnp.issubdtype(c.data.dtype, jnp.floating)
                        else jnp.int64
                    )
                else:
                    acc_dt = numpy_dtype_for(a.return_type())
                plan.append((name, len(sum_cols), len(sum_cols) + 1, None))
                sum_cols.append(
                    jnp.where(c.valid, c.data.astype(acc_dt), 0)
                )
                sum_cols.append(c.valid.astype(jnp.int64))
            else:  # min / max
                enc, vv = orderable_key(c)
                enc = enc.astype(jnp.int64)
                if name == "max":
                    enc = ~enc
                mk = jnp.where(vv & right.alive, enc, jnp.iinfo(jnp.int64).max)
                plan.append((name, None, len(sum_cols), len(mm_specs)))
                sum_cols.append((vv & right.alive).astype(jnp.int64))
                mm_specs.append((mk, c.data))

        from sqlrs_tpu.parallel.dist_join import broadcast_agg_join

        fused_fn = ring_agg_join if use_ring else broadcast_agg_join
        counts, sums, min_rowid, mm_outs = fused_fn(
            self.mesh, f_enc, f_ok, f_rowid, sum_cols, mm_specs,
            d_enc, d_ok,
        )
        d_counts = d_sums = None
        if has_distinct:
            d_counts, d_sums = self._distinct_dim_partials(
                fused_fn, d_arg_col, f_enc, f_ok, right, d_enc, d_ok,
                d_need_sum,
            )

        # ---- dim-sized partial batch + standard distributed grouped agg ----
        ng = len(groups)
        part_cols = list(group_cols)
        aggs2 = []
        names2 = list(op.names[:ng])
        types2 = list(op.types[:ng])
        final_spec = []  # per original aggregate: ("one", ix) | ("avg", s, c)
        always = jnp.ones((left.capacity,), jnp.bool_)

        def _add(fn2, col, rt, nm):
            part_cols.append(col)
            aggs2.append(
                BoundAggregate(
                    fn2,
                    BoundReference(len(part_cols) - 1, col.type, nm),
                    False,
                    rt,
                )
            )
            names2.append(nm)
            types2.append(rt)
            return ng + len(aggs2) - 1  # final output column index

        dcnt_ix = None  # shared distinct-count partial column

        def _dcnt_col():
            nonlocal dcnt_ix
            if dcnt_ix is None:
                # duplicate dim rows of one key carry EQUAL distinct
                # partials: combine with max, never sum
                dcnt_ix = _add(
                    "max",
                    Column(LogicalType.BIGINT, d_counts, always),
                    LogicalType.BIGINT, "#dcnt",
                )
            return dcnt_ix

        for i, ((kind, six, vix, mix), a) in enumerate(zip(plan, aggregates)):
            rt = a.return_type()
            nm = op.names[ng + i] if ng + i < len(op.names) else a.name()
            if kind == "count_d":
                final_spec.append(("one", _dcnt_col()))
                continue
            if kind in ("sum_d", "avg_d"):
                st = (
                    LogicalType.DOUBLE
                    if jnp.issubdtype(d_sums.dtype, jnp.floating)
                    else LogicalType.BIGINT
                )
                s_ix = _add(
                    "max", Column(st, d_sums, d_counts > 0), st, nm + "#dsum"
                )
                if kind == "sum_d":
                    final_spec.append(("one", s_ix))
                else:
                    final_spec.append(("avg", s_ix, _dcnt_col()))
                continue
            if kind == "count_star":
                final_spec.append(("one", _add("sum", Column(rt, counts, always), rt, nm)))
            elif kind == "count":
                final_spec.append(
                    ("one", _add("sum", Column(rt, sums[six], always), rt, nm))
                )
            elif kind == "sum":
                final_spec.append(("one", _add(
                    "sum",
                    Column(rt, sums[six].astype(numpy_dtype_for(rt)),
                           sums[vix] > 0),
                    rt, nm,
                )))
            elif kind == "avg":
                st = (
                    LogicalType.DOUBLE
                    if jnp.issubdtype(sums[six].dtype, jnp.floating)
                    else LogicalType.BIGINT
                )
                s_ix = _add(
                    "sum", Column(st, sums[six], sums[vix] > 0), st,
                    nm + "#sum",
                )
                c_ix = _add(
                    "sum", Column(LogicalType.BIGINT, sums[vix], always),
                    LogicalType.BIGINT, nm + "#cnt",
                )
                final_spec.append(("avg", s_ix, c_ix))
            else:  # min / max
                raw, _mk = mm_outs[mix]
                final_spec.append(("one", _add(
                    kind, Column(rt, raw, sums[vix] > 0), rt, nm,
                )))
        # group order = first appearance in the join's emission order, which
        # is probe-row-major: with the fact side probing, (first matching
        # fact row, dim position); with the dim side probing (mirrored), the
        # dim position alone. Guard the packing against int64 overflow at
        # absurd capacities.
        if right.capacity * left.capacity >= (1 << 62):
            return None  # pragma: no cover - capacities beyond packing range
        pos = jax.device_put(jnp.arange(left.capacity, dtype=jnp.int64), sh)
        pair_rowid = jnp.where(
            counts > 0,
            pos if mirrored else min_rowid * left.capacity + pos,
            jnp.iinfo(jnp.int64).max,
        )
        schema2 = Schema.of(
            [(f"g{i}", c.type) for i, c in enumerate(part_cols)]
        )
        partial = ShardedBatch(
            schema2, part_cols, d_ok & (counts > 0), self.mesh,
            rowid=pair_rowid,
        )
        op2 = P.PhysicalHashAgg(
            children=[],
            names=names2,
            types=types2,
            groups=[
                BoundReference(i, c.type, f"g{i}")
                for i, c in enumerate(part_cols[:ng])
            ],
            aggregates=aggs2,
        )
        self._record_strategy("ring" if use_ring else "broadcast_fused")
        batch = self._grouped_agg_dist(op2, partial)
        if all(kind == "one" for kind, *_ in final_spec):
            return batch
        # avg post-pass: divide the combined sum/count partials and emit
        # the ORIGINAL output schema (G-sized, trivial)
        cols = list(batch.columns)
        out_cols = cols[:ng]
        for spec, a in zip(final_spec, aggregates):
            if spec[0] == "one":
                out_cols.append(cols[spec[1]])
            else:
                _, s_ix, c_ix = spec
                s, c = cols[s_ix], cols[c_ix]
                den = jnp.maximum(c.data, 1).astype(jnp.float64)
                out_cols.append(Column(
                    a.return_type(),
                    s.data.astype(jnp.float64) / den,
                    s.valid & (c.data > 0),
                ))
        return DeviceBatch(
            Schema.of(list(zip(op.names, op.types))), out_cols,
            batch.num_rows,
        )

    def _distinct_dim_partials(
        self, fused_fn, c, f_enc, f_ok, right: "ShardedBatch", d_enc, d_ok,
        need_sum: bool,
    ):
        """count/sum(DISTINCT c) per dim row, exact across shards:

          1. shard-local sorted-unique over (join key, value-encoding)
             pairs (dist_join.pair_local_dedup — no scatter, output order
             free);
          2. exchange the surviving pairs by key hash (partition_shuffle,
             fixed capacity + overflow-retry ×4 — every copy of a pair
             lands on one shard);
          3. dedup again: pairs are now globally unique;
          4. the deduped pair table is just another fact table — one more
             fused pass (same ring/broadcast kernel) returns per-dim-row
             counts (= COUNT(DISTINCT)) and value sums (= SUM(DISTINCT)).

        The local pre-dedup bounds the exchange at min(n_local, distinct
        pairs) rows — the shard-local sorted-unique the round-4 VERDICT
        item 7 asked for. Returns (d_counts, d_sums) aligned with the dim
        side's sharded layout (d_sums None when not need_sum)."""
        from sqlrs_tpu.ops.hash_table import next_pow2
        from sqlrs_tpu.ops.sort import orderable_key
        from sqlrs_tpu.parallel.dist_join import pair_local_dedup
        from sqlrs_tpu.parallel.dist_ops import (
            _overflow_scalar,
            partition_shuffle,
        )

        venc, vv = orderable_key(c)
        pair_ok = f_ok & vv
        k1, v1, ok1 = pair_local_dedup(self.mesh, f_enc, venc, pair_ok)

        n_dev = self.mesh.shape["x"]
        local_n = max(right.capacity // n_dev, 1)
        cap = next_pow2(max(-(-local_n // max(n_dev // 2, 1)), 64))
        while True:
            k2, v2, ok2, ovf = partition_shuffle(
                self.mesh, k1, v1, ok1, bucket_capacity=cap
            )
            if _overflow_scalar(ovf) == 0:
                break
            if cap >= 2 * next_pow2(local_n):  # pragma: no cover
                from sqlrs_tpu.errors import ExecutorError

                raise ExecutorError(
                    "distinct pair exchange overflow at maximum capacity"
                )
            cap *= 4
        k3, v3, ok3 = pair_local_dedup(self.mesh, k2, v2, ok2)

        sum_cols: list = []
        if need_sum:
            if jnp.issubdtype(v3.dtype, jnp.floating):
                raw = v3.astype(jnp.float64)
            else:
                from sqlrs_tpu.ops.grouped_agg import _orderable_inverse

                raw = _orderable_inverse(v3, c.type).astype(jnp.int64)
            sum_cols.append(
                jnp.where(ok3, raw, jnp.zeros((), raw.dtype))
            )
        rowid = jax.device_put(
            jnp.arange(k3.shape[0], dtype=jnp.int64),
            row_sharding(self.mesh),
        )
        d_counts, d_sums, _rid, _mm = fused_fn(
            self.mesh, k3, ok3, rowid, sum_cols, [], d_enc, d_ok
        )
        return d_counts, (d_sums[0] if need_sum else None)

    def _grouped_agg_dist(self, op, child: ShardedBatch) -> DeviceBatch:
        """Two-phase distributed GROUP BY: per-shard fixed-capacity sorted
        partial aggregation under shard_map (communication = ONE all_gather
        of O(G) partials), then a final merge on the gathered partials via
        the standard sorted-run kernel. The min global row index is carried
        as a partial state and the final rows are ordered by it, reproducing
        the reference's first-appearance group order exactly
        (reference hash_agg.rs:85-111)."""
        from jax.sharding import PartitionSpec as PS

        from sqlrs_tpu.ops.grouped_agg import (
            partial_grouped_fixed,
            sorted_grouped_aggregate,
        )
        from sqlrs_tpu.ops.hash_table import next_pow2
        from sqlrs_tpu.ops.sort import orderable_key

        view = child.view()
        key_cols = [execute_expr(g, view) for g in op.groups]
        agg_cols = [
            execute_expr(a.arg, view) if a.arg is not None else None
            for a in op.aggregates
        ]

        # ---- flatten inputs for shard_map ------------------------------------
        has_rowid = child.rowid is not None
        arrays: list = [child.alive]
        if has_rowid:
            arrays.append(child.rowid)
        key_desc = []  # (orderable_ix, valid_ix, raw_ix)
        for c in key_cols:
            okey, _ = orderable_key(c)
            key_desc.append(len(arrays))
            arrays.extend([okey, c.valid, c.data])
        agg_desc = []  # (kind, data_ix or None, out_dtype)
        for a, c in zip(op.aggregates, agg_cols):
            name = a.function_name
            if c is None:
                agg_desc.append(("count_star", None, None))
                continue
            if name in ("min", "max") and c.type == LogicalType.VARCHAR:
                rank, _ = orderable_key(c)
                agg_desc.append(("vmin" if name == "min" else "vmax", len(arrays), np.int32))
                arrays.extend([c.data, c.valid, rank])
                continue
            if name == "avg":
                out_dt = np.float64
            elif name == "sum":
                out_dt = numpy_dtype_for(a.return_type())
            else:
                out_dt = numpy_dtype_for(c.type)
            agg_desc.append((name, len(arrays), out_dt))
            arrays.extend([c.data, c.valid])

        n_dev = self.mesh.devices.size
        cap_local = child.capacity // n_dev
        axis = DATA_AXIS

        def make_local(g_cap):
            def local(*arrs):
                alive = arrs[0]
                n_local = alive.shape[0]
                if has_rowid:
                    row_idx = arrs[1]
                else:
                    base = jax.lax.axis_index(axis).astype(jnp.int64) * n_local
                    row_idx = base + jnp.arange(n_local, dtype=jnp.int64)
                keys = [
                    (arrs[ix], arrs[ix + 1], arrs[ix + 2]) for ix in key_desc
                ]
                aggs = []
                for kind, ix, out_dt in agg_desc:
                    if ix is None:
                        aggs.append((kind, None, None, None, None))
                    elif kind in ("vmin", "vmax"):
                        aggs.append((kind, arrs[ix], arrs[ix + 1], arrs[ix + 2], out_dt))
                    else:
                        aggs.append((kind, arrs[ix], arrs[ix + 1], None, out_dt))
                key_outs, first_row, live, states, n_runs, overflow = (
                    partial_grouped_fixed(alive, row_idx, keys, aggs, g_cap)
                )
                flat = [first_row, live, n_runs[None], overflow[None]]
                for kd, kv in key_outs:
                    flat.extend([kd, kv])
                for st in states:
                    for k in sorted(st):
                        flat.append(st[k])
                return tuple(flat)

            return local

        g_cap = min(next_pow2(max(64, cap_local // 8)), next_pow2(cap_local))
        while True:
            local = make_local(g_cap)
            outs = spmd(
                local,
                mesh=self.mesh,
                in_specs=(PS(axis),) * len(arrays),
                out_specs=PS(axis),
            )(*arrays)
            overflow = bool(np.any(_host(outs[3])))
            if not overflow or g_cap >= next_pow2(cap_local):
                break
            g_cap = min(g_cap * 4, next_pow2(cap_local))  # bucketed recompile

        # ---- assemble gathered partials (host compact at G size) --------------
        first_row = _host(outs[0])
        live = _host(outs[1])
        idx = np.nonzero(live)[0]
        p = 4
        partial_keys = []
        for c in key_cols:
            kd = _host(outs[p])[idx]
            kv = _host(outs[p + 1])[idx]
            p += 2
            partial_keys.append(Column.from_numpy(c.type, kd, kv))
        merge_specs = [
            (
                "min",
                Column.from_numpy(LogicalType.BIGINT, first_row[idx]),
                LogicalType.BIGINT,
            )
        ]
        result_plan = []  # per original agg: how to read merged outputs
        for (kind, _ix, _dt), a in zip(agg_desc, op.aggregates):
            rt = a.return_type()
            if kind in ("count_star", "count"):
                cnt = Column.from_numpy(LogicalType.BIGINT, _host(outs[p])[idx])
                p += 1
                result_plan.append(("count", len(merge_specs), rt))
                merge_specs.append(("sum", cnt, LogicalType.BIGINT))
            elif kind in ("sum", "avg"):
                # state order sorted(): cnt, sum
                cnt_np = _host(outs[p])[idx]
                sum_np = _host(outs[p + 1])[idx]
                p += 2
                has = cnt_np > 0
                st = LogicalType.DOUBLE if kind == "avg" else rt
                sum_col = Column.from_numpy(st, sum_np, has)
                cnt_col = Column.from_numpy(LogicalType.BIGINT, cnt_np)
                if kind == "avg":
                    result_plan.append(("avg", len(merge_specs), rt))
                    merge_specs.append(("sum", sum_col, LogicalType.DOUBLE))
                    merge_specs.append(("sum", cnt_col, LogicalType.BIGINT))
                else:
                    result_plan.append(("direct", len(merge_specs), rt))
                    merge_specs.append(("sum", sum_col, rt))
            elif kind in ("min", "max", "vmin", "vmax"):
                # state order sorted(): best, cnt
                best_np = _host(outs[p])[idx]
                cnt_np = _host(outs[p + 1])[idx]
                p += 2
                has = cnt_np > 0
                if kind in ("vmin", "vmax"):
                    from sqlrs_tpu.data.strings import NULL_CODE

                    src_t = LogicalType.VARCHAR
                    best_np = np.where(has, best_np, NULL_CODE)
                else:
                    src_t = agg_cols[len(result_plan)].type
                best_col = Column.from_numpy(src_t, best_np, has)
                result_plan.append(("direct", len(merge_specs), rt))
                merge_specs.append(
                    ("min" if kind in ("min", "vmin") else "max", best_col, rt)
                )
            else:  # pragma: no cover
                raise AssertionError(kind)

        gcols, acols, n_groups = sorted_grouped_aggregate(partial_keys, merge_specs)

        # ---- first-appearance order + output assembly --------------------------
        if n_groups > 0:
            order = jnp.argsort(acols[0].data)
            gcols = [c.take(order) for c in gcols]
            acols = [c.take(order) for c in acols]
        out_cols = list(gcols)
        for what, mi, rt in result_plan:
            if what == "count":
                out_cols.append(
                    Column(
                        LogicalType.BIGINT,
                        acols[mi].data,
                        jnp.ones(n_groups, jnp.bool_),
                    )
                )
            elif what == "avg":
                s, c = acols[mi], acols[mi + 1]
                cnt = jnp.maximum(c.data, 1)
                out_cols.append(
                    Column(rt, s.data / cnt.astype(jnp.float64), c.data > 0)
                )
            else:
                a = acols[mi]
                dt = numpy_dtype_for(rt)
                data = a.data if a.data.dtype == dt else a.data.astype(dt)
                out_cols.append(Column(rt, data, a.valid))
        return DeviceBatch(_schema(op), out_cols, n_groups)

    # ---- hash join: replicated build side, sharded slot-expansion probe ------------

    # guardrails for the fixed-width slot expansion; beyond these the
    # materialize-and-delegate path is the better plan anyway
    _JOIN_MAX_DUP = 256
    _JOIN_MAX_CELLS = 1 << 26

    def _dexec_HashJoin(self, op: P.PhysicalHashJoin):
        if op.join_type in ("semi", "anti"):
            return self._semi_anti_dist(op)
        right = self.execute(op.children[1])
        if not isinstance(right, ShardedBatch) or right.parts:
            cache = {id(op.children[1]): self._materialize(right)}
            cache[id(op.children[0])] = self._materialize(self.execute(op.children[0]))
            self._record_strategy("delegate")
            return _DelegatingExecutor(self.db, cache).execute(op)
        left_res = self.execute(op.children[0])
        if self._pick_shuffle(op, left_res, right):
            out = self._shuffle_join_dist(op, left_res, right)
            if out is not None:
                return out
        left = self._materialize(left_res)
        self._record_strategy("broadcast")
        return self._hash_join_dist(op, left, right)

    def _record_strategy(self, name: str) -> None:
        """Append the chosen join strategy to db.last_join_strategies (reset
        per statement by the session layer; tests and EXPLAIN read it)."""
        log = getattr(self.db, "last_join_strategies", None)
        if log is None:
            log = []
            self.db.last_join_strategies = log
        log.append(name)

    def _pick_shuffle(self, op, left_res, right: ShardedBatch) -> bool:
        """Strategy selection from live row counts (the catalog-stats seam):
        broadcast replicates the build side to every device (cost ~ B x p);
        the shuffle repartitions both sides once (cost ~ B + N). Shuffle
        wins when B x (p-1) > N and B is big enough that replication
        actually hurts. `db.dist_shuffle_min_build` overrides the absolute
        floor (tests force small joins onto the shuffle path with it)."""
        if op.join_type != "inner" or not isinstance(left_res, ShardedBatch):
            return False
        if left_res.parts or right.parts:
            return False
        policy = getattr(self.db, "dist_join_policy", "auto")
        if policy == "broadcast":
            return False
        if policy == "shuffle":  # forced (tests / operator escape hatch)
            return True
        n_dev = self.mesh.devices.size
        build_rows = int(_host(jnp.sum(left_res.alive)))
        probe_rows = int(_host(jnp.sum(right.alive)))
        min_build = getattr(self.db, "dist_shuffle_min_build", 1 << 16)
        return (
            build_rows >= min_build
            and build_rows * (n_dev - 1) > probe_rows
        )

    def _semi_anti_dist(self, op: P.PhysicalHashJoin):
        """Distributed mark-join (decorrelated EXISTS / IN): the OUTER side
        stays row-sharded; the subquery side materializes (it is a
        dimension-sized result) and its sorted key array is replicated.
        Each shard tests membership with a searchsorted probe into the
        replicated table and flips its alive-mask — semi/anti emit each
        left row at most once, in place, so no exchange and no pair
        expansion happen at all. Single-equality, residual-free joins only
        (all six TPC-H semi/anti shapes); everything else delegates."""
        left = self.execute(op.children[0])
        right = self._materialize(self.execute(op.children[1]))
        if (
            not isinstance(left, ShardedBatch)
            or left.parts
            or op.filter is not None
            or len(op.on) != 1
        ):
            cache = {
                id(op.children[0]): self._materialize(left),
                id(op.children[1]): right,
            }
            return _DelegatingExecutor(self.db, cache).execute(op)
        from sqlrs_tpu.ops.sort import orderable_key

        anti = op.join_type == "anti"
        view = left.view()
        (l_col,) = execute_exprs_fused([op.on[0][0]], view)
        r_col = execute_expr(op.on[0][1], right)
        out_schema = _schema(op)
        if right.num_rows == 0:
            # NOT IN / NOT EXISTS over an empty set keeps every row (even
            # NULL probes); semi keeps none
            alive = left.alive if anti else jnp.zeros_like(left.alive)
            return ShardedBatch(
                out_schema, left.columns, alive, self.mesh, rowid=left.rowid
            )
        if op.null_aware and anti and bool(
            _host(jnp.any(jnp.logical_not(r_col.valid)))
        ):
            return ShardedBatch(
                out_schema, left.columns, jnp.zeros_like(left.alive), self.mesh,
                rowid=left.rowid,
            )
        lk, lv = orderable_key(l_col)
        rk, rv = orderable_key(r_col)
        big = jnp.iinfo(rk.dtype).max
        # validity rides the sort as a secondary key (invalid entries map to
        # the max sentinel AND sort after equal-valued valid entries), so a
        # legitimate key equal to dtype-max still matches: the searchsorted
        # hit position always lands on a VALID entry if one exists
        invalid_flag = jnp.logical_not(rv).astype(jnp.int32)
        r_sorted, flag_sorted = jax.lax.sort(
            (jnp.where(rv, rk, big), invalid_flag), num_keys=2
        )
        m = r_sorted.shape[0]
        pos = jnp.clip(jnp.searchsorted(r_sorted, lk), 0, m - 1)
        matched = lv & (r_sorted[pos] == lk) & (flag_sorted[pos] == 0)
        keep = jnp.logical_not(matched) if anti else matched
        if op.null_aware and anti:
            keep = keep & lv  # NULL probe never passes NOT IN (inner non-empty)
        return ShardedBatch(
            out_schema, left.columns, left.alive & keep, self.mesh,
            rowid=left.rowid,
        )

    _SHUFFLE_MAX_CELLS = 1 << 27

    def _shuffle_join_dist(
        self, op, left: ShardedBatch, right: ShardedBatch
    ) -> Optional[ShardedBatch]:
        """Partitioned (shuffle-repartition) inner hash join: both sides
        exchanged by key hash, full payloads carried, skew salted adaptively
        — parallel/dist_join.py. Returns None to fall back to broadcast when
        the match width would blow the cell budget (the guardrail seam).

        Bit-exactness: the output ShardedBatch carries
        rowid = probe_rowid * m + slot, the single-device pair emission
        sequence; collect and downstream order-sensitive operators sort by
        it (reference emission order: hash_join.rs:207-250)."""
        from sqlrs_tpu.ops.hash_table import next_pow2
        from sqlrs_tpu.ops.sort import orderable_key
        from sqlrs_tpu.parallel.dist_join import (
            shuffle_join_phase_a,
            shuffle_join_phase_b,
        )

        n_dev = self.mesh.devices.size
        lview, rview = left.view(), right.view()
        lkey_cols = execute_exprs_fused([l for l, _ in op.on], lview)
        rkey_cols = execute_exprs_fused([r for _, r in op.on], rview)
        b_keys, p_keys = [], []
        for lc, rc in zip(lkey_cols, rkey_cols):
            le, lv = orderable_key(lc)
            re_, rv = orderable_key(rc)
            re_ = re_.astype(le.dtype)
            b_keys.append((le, lv))
            p_keys.append((re_, rv))

        def flatten(cols):
            pays, bools = [], []
            for c in cols:
                is_bool = c.data.dtype == jnp.bool_
                bools.append(is_bool)
                pays.append(c.data.astype(jnp.int32) if is_bool else c.data)
                pays.append(c.valid.astype(jnp.int32))
            return pays, bools

        b_pay, b_bools = flatten(left.columns)
        p_pay, p_bools = flatten(right.columns)
        sh = row_sharding(self.mesh)

        def rid(b: ShardedBatch):
            if b.rowid is not None:
                return b.rowid
            return jax.device_put(
                jnp.arange(b.capacity, dtype=jnp.int64), sh
            )

        b_rowid, p_rowid = rid(left), rid(right)
        cap_b, cap_p = left.capacity, right.capacity
        # size buckets from LIVE row counts with 2x hash-skew slack, rounded
        # to a power of two: pow2 quantization makes the compiled phase-a
        # shapes recur across joins/queries (the persistent cache hits), and
        # honest sizing makes the overflow-retry recompile a rare event
        # instead of the common path (each retry is a fresh XLA compile)
        live_b = int(_host(jnp.sum(left.alive)))
        live_p = int(_host(jnp.sum(right.alive)))
        # a (src,dst) bucket receives ~live/n_dev^2 rows under a uniform
        # hash (salting absorbs hot keys), so 2x that is the honest size;
        # the x4 retry ladder below covers residual non-hot skew
        bucket_b = next_pow2(max(2 * live_b // (n_dev * n_dev), 64))
        bucket_p = next_pow2(max(2 * live_p // (n_dev * n_dev), 64))
        hot_capacity = 1024
        while True:
            a = shuffle_join_phase_a(
                self.mesh,
                b_keys, b_pay, b_rowid, left.alive,
                p_keys, p_pay, p_rowid, right.alive,
                bucket_b=bucket_b, bucket_p=bucket_p,
                hot_capacity=hot_capacity,
                hot_min=getattr(self.db, "dist_hot_min", None),
                # db.dist_exchange_ring=True stages the probe exchange in
                # ppermute ring hops overlapping the per-chunk rank sorts
                # (bit-identical outputs; see dist_join._ring_probe_ranks)
                ring=getattr(self.db, "dist_exchange_ring", False),
            )
            if a.overflow == 0:
                break
            if bucket_b >= cap_b // n_dev and bucket_p >= cap_p // n_dev:
                return None  # pragma: no cover - full capacity always fits
            bucket_b = min(bucket_b * 4, max(cap_b // n_dev, 64))
            bucket_p = min(bucket_p * 4, max(cap_p // n_dev, 64))
            hot_capacity = min(hot_capacity * 4, next_pow2(max(cap_b, 64)))
        m = max(a.m, 1)
        out_cap = n_dev * n_dev * bucket_p * m
        # memory guardrail: the strip expansion materializes out_cap cells.
        # No separate m cap — a high per-key duplication (Q21's
        # supplier⋈lineitem runs ~600 lineitems per supplier at EVERY scale
        # factor) is fine when the probe side is small; out_cap already
        # accounts for the product.
        if out_cap > self._SHUFFLE_MAX_CELLS:
            return None
        b_cells, p_cells, rowid_out, alive = shuffle_join_phase_b(
            self.mesh, a, len(b_keys), len(b_pay)
        )
        cols: list[Column] = []
        for i, c in enumerate(left.columns):
            data = b_cells[2 * i]
            if b_bools[i]:
                data = data.astype(jnp.bool_)
            cols.append(Column(c.type, data, (b_cells[2 * i + 1] > 0) & alive))
        for i, c in enumerate(right.columns):
            data = p_cells[2 * i]
            if p_bools[i]:
                data = data.astype(jnp.bool_)
            cols.append(Column(c.type, data, p_cells[2 * i + 1] > 0))
        out = ShardedBatch(
            _schema(op), cols, alive, self.mesh, rowid=rowid_out
        )
        if op.filter is not None:
            (keep,) = execute_exprs_fused([op.filter], out.view())
            out.alive = out.alive & keep.data & keep.valid
        self._record_strategy(
            "salted" if a.n_hot_buckets > 0 else "shuffle"
        )
        return out

    def _hash_join_dist(self, op, left: DeviceBatch, right: ShardedBatch):
        """Broadcast-build distributed equi join (reference semantics from
        hash_join.rs:146-323, re-laid-out for static shapes):

        - the build (left) side is replicated; the probe (right) side stays
          row-sharded — no shuffle of the big side;
        - each probe row owns a fixed strip of m match slots (m = max build
          bucket size) plus, for right/full joins, one unmatched-right slot —
          probe-row-major strips reproduce the reference's probe-order
          emission (incl. unmatched-right rows interleaved at their probe
          position) EXACTLY, because sharding is block-contiguous;
        - candidates come from the shared open-addressing table
          (ops/hash_table.py) on a combined key hash, then every candidate is
          re-checked for exact equality on all key columns (the reference's
          missing collision check, hash_join.rs:221-224, fixed here too);
        - unmatched-left rows (left/full) are computed from a psum'd visited
          bitmap and appended as a host part — the reference also appends
          them last (hash_join.rs:294-322)."""
        from sqlrs_tpu.exec.executor import _merge_rows
        from sqlrs_tpu.ops.hash_table import (
            EMPTY,
            _mix64,
            build_join_table,
            next_pow2,
            probe_counts,
        )

        nl = left.num_rows
        rview = right.view()
        left_keys = execute_exprs_fused([l for l, _ in op.on], left)
        right_keys = execute_exprs_fused([r for _, r in op.on], rview)

        def combined_hash(cols, n):
            h = jnp.full((n,), jnp.uint64(0x9E3779B97F4A7C15))
            valid = jnp.ones((n,), jnp.bool_)
            for c in cols:
                h = _mix64(h ^ _mix64(_int64_bits(c).astype(jnp.uint64)))
                valid = valid & c.valid
            h = h.astype(jnp.int64)
            # keep clear of the table's reserved EMPTY key
            return jnp.where(h == EMPTY, EMPTY + 3, h), valid

        bh, bvalid = combined_hash(left_keys, nl)
        # NULL-key build rows never match: give each a spread, unique-ish
        # hash (collisions are harmless — the exact re-check rejects them)
        row_ids = jnp.arange(nl, dtype=jnp.int64)
        decoy = _mix64((row_ids + 7).astype(jnp.uint64)).astype(jnp.int64)
        bh = jnp.where(bvalid, bh, jnp.where(decoy == EMPTY, EMPTY + 3, decoy))

        cap_r = right.capacity
        extra = 1 if op.join_type in ("right", "full") else 0
        if nl > 0:
            capacity = next_pow2(max(2 * nl, 16))
            table, start, bcounts, order = build_join_table(bh, capacity)
            m = int(_host(jnp.max(bcounts)))
        else:
            m = 0
        w = max(m, 1) + extra
        if nl == 0 or m > self._JOIN_MAX_DUP or cap_r * w > self._JOIN_MAX_CELLS:
            cache = {
                id(op.children[0]): left,
                id(op.children[1]): right.to_device_batch(),
            }
            return _DelegatingExecutor(self.db, cache).execute(op)

        ph, pvalid = combined_hash(right_keys, cap_r)
        found, counts = probe_counts(table, ph, bcounts, capacity)
        probe_ok = right.alive & pvalid & (found >= 0)
        slot = jnp.maximum(found, 0)
        j = jnp.arange(m, dtype=jnp.int64)  # slot strip within a probe row
        cand_pos = start[slot][:, None] + j[None, :]
        cand = order[jnp.clip(cand_pos, 0, nl - 1)]  # (cap_r, m) build rows
        have = probe_ok[:, None] & (j[None, :] < counts[:, None])
        # exact key equality re-check on every candidate
        for lk, rk in zip(left_keys, right_keys):
            lv = lk.data[cand]
            have = have & lk.valid[cand] & rk.valid[:, None]
            have = have & (_int64_bits_v(lv, lk.type) == _int64_bits(rk)[:, None])

        # ---- merged output columns: (cap_r, w) strips, row-major ----------------
        pad = jnp.zeros((cap_r, extra), dtype=cand.dtype) if extra else None
        cand_w = jnp.concatenate([cand, pad], axis=1) if extra else cand
        match_w = (
            jnp.concatenate([have, jnp.zeros((cap_r, extra), jnp.bool_)], axis=1)
            if extra
            else have
        )
        cand_flat = cand_w.reshape(-1)
        match_flat = match_w.reshape(-1)
        n_out = cap_r * w
        cols: list[Column] = []
        for c in left.columns:
            data = c.data[cand_flat]
            valid = c.valid[cand_flat] & match_flat
            cols.append(Column(c.type, data, valid))
        for c in rview.columns:
            cols.append(
                Column(c.type, jnp.repeat(c.data, w), jnp.repeat(c.valid, w))
            )
        merged = DeviceBatch(_schema(op), cols, n_out)
        alive = match_flat
        if op.filter is not None:
            keep = execute_expr(op.filter, merged)
            alive = alive & keep.data & keep.valid

        if extra:
            has_match = jnp.any(alive.reshape(cap_r, w), axis=1)
            ur = right.alive & ~has_match  # unmatched right rows, in place
            ur_flat = (
                jnp.concatenate(
                    [jnp.zeros((cap_r, m), jnp.bool_), ur[:, None]], axis=1
                )
            ).reshape(-1)
            alive = alive | ur_flat

        # probe-major strips keep position order; if the probe side itself
        # was order-scrambled (rowid set), derive the output's logical order
        # from it: (probe rowid, slot) is exactly the single-device emission
        # sequence
        rowid_out = None
        if right.rowid is not None:
            rowid_out = (
                right.rowid[:, None] * w + jnp.arange(w, dtype=jnp.int64)[None, :]
            ).reshape(-1)
        out = ShardedBatch(
            _schema(op), merged.columns, alive, self.mesh, rowid=rowid_out
        )

        if op.join_type in ("left", "full"):
            visited = (
                jnp.zeros((nl + 1,), jnp.int32)
                .at[jnp.where(alive & match_flat, cand_flat, nl)]
                .add(1)[:nl]
            )
            unmatched_l = np.nonzero(~(_host(visited) > 0))[0]
            if len(unmatched_l):
                out.parts.append(
                    _merge_rows(op, left, rview, unmatched_l, None)
                )
        return out

    # ---- delegation ---------------------------------------------------------------

    def _delegate(self, op: P.PhysicalOperator, child_result) -> DeviceBatch:
        cache = {id(op.children[0]): self._materialize(child_result)}
        for c in op.children[1:]:
            cache[id(c)] = self._materialize(self.execute(c))
        return _DelegatingExecutor(self.db, cache).execute(op)


def view_scalar(col: Column, i: int) -> ScalarValue:
    return col.scalar_at(i)


def _int64_bits_v(data, _t=None):
    """Equality/hash bit view of column data as int64 (floats via bitcast
    with -0.0 normalized so SQL 0 = -0 holds)."""
    if data.dtype == jnp.float64:
        data = jnp.where(data == 0, 0.0, data)
        return jax.lax.bitcast_convert_type(data, jnp.int64)
    if data.dtype == jnp.float32:
        data = jnp.where(data == 0, jnp.float32(0), data)
        return jax.lax.bitcast_convert_type(data, jnp.int32).astype(jnp.int64)
    return data.astype(jnp.int64)


def _int64_bits(c: Column):
    return _int64_bits_v(c.data, c.type)


class _DelegatingExecutor(Executor):
    """Standard executor that serves precomputed results for given child
    plan nodes (the materialize-and-delegate fallback seam)."""

    # the children were computed sharded; a fused route would run the
    # subtree again on one device and discard them
    fused_routes = False

    def __init__(self, db, cache: dict[int, DeviceBatch]) -> None:
        super().__init__(db)
        self._cache = cache

    def execute(self, op: P.PhysicalOperator) -> DeviceBatch:
        hit = self._cache.get(id(op))
        if hit is not None:
            return hit
        return super().execute(op)
