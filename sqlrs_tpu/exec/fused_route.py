"""SQL → fused-pipeline routing: Order(HashAgg(HashJoin)) → join_groupby_direct.

The engine's fastest kernel (ops/pipelines.join_groupby_direct) computes
fact⋈dim + GROUP BY join-key + sum/count in one packed sort — but until
round 3 no SQL plan could reach it (the general executor materializes join
pairs and re-aggregates, with several host syncs). This module
pattern-matches the star-rollup plan shape

    Order(key asc)
      HashAgg(groups=[key], aggs = sum(v) / count(*) / count(v))
        HashJoin(inner, fact.key = dim.key)          -- unique dim keys

and routes it through the fused kernel. Requiring the ORDER BY on the group
key sidesteps the engine's first-appearance group-order guarantee (the
query makes the order explicit), which the range-query formulation cannot
reproduce without a second sort. The reference analogue of the unfused
chain is HashJoin→HashAgg (reference src/executor/join/hash_join.rs:146,
src/executor/aggregate/hash_agg.rs:32); the fused form has no reference
analogue — it exists because recomputing the aggregate from one packed
sort beats materializing join pairs and re-aggregating them.

Eligibility is checked statically from the plan (single int equi-key, no
residual, no distinct, any number of distinct aggregate value expressions
on one side — at most one of them under min/max) and dynamically from ONE
tiny device program (dim keys unique + spans + value ranges + validity,
fetched as a single meta vector). A routed query is 5 dispatches end to
end: stats, kernel, compaction, finalize, render-slice.
FLOAT/DOUBLE measures ride the variadic sort as payloads and accumulate
float64 — this is what lets real TPC-H rollups route (every TPC-H measure
is DOUBLE; Q3's sum(l_extendedprice*(1-l_discount)) fires the
first-appearance variant, with the general ORDER BY running over the
G-sized result). The join key may sit at ANY position in the GROUP BY
list (Q18 lists dim attributes before o_orderkey); output columns follow
the GROUP BY order. Join CHAINS route too: the dim side executes through
the normal executor first (Q3's orders⋈customer subtree), so only the TOP
join must match the star shape.
Beyond the first (packed) value expression, values ride the variadic sort
as payloads: negatives are fine there, and each costs only one extra
(Q,128) payload-row gather. NULL-able value columns sum as masked zeros
plus a validity payload carrying the per-group non-NULL count (count(v),
avg denominators, all-NULL-group NULL results); a NULL-able PACKED column
masks NULLs to an above-range sentinel instead, and the kernel subtracts
their contributions — min/max/DISTINCT over NULL-able measures stay
routed and exact. Ineligible plans fall back to the general executors — the route
is a pure optimization, bit-exact where it applies (tests/test_fused_route.py
differential-checks it against the unfused path).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as _np

from sqlrs_tpu.binder.expression import BoundAggregate, BoundReference
from sqlrs_tpu.data.batch import Column, DeviceBatch
from sqlrs_tpu.plan import physical as P
from sqlrs_tpu.types.types import LogicalType, numpy_dtype_for


@jax.jit
def _route_stats(dim_keys, dim_valid, fact_keys, fact_valid, datas, valids):
    """Every dynamic eligibility check in ONE program with ONE small host
    fetch (each dispatch and each fetch is a host-device sync):

      dim_sorted            (G,)  — stays on device for the kernel
      meta  int64[6 + 3V]:  [d_all_valid, d_unique, d_min, d_max,
                             f_kmin, f_kmax,
                             per-value-column all_valid…, min…, max…]

    Value mins/maxs are over VALID rows; they drive packed-expression
    selection and int32 payload packing (the sort is HBM-bound: narrower
    payloads are proportionally cheaper)."""
    ks = jnp.sort(dim_keys)
    unique = (
        jnp.all(ks[1:] > ks[:-1]) if dim_keys.shape[0] > 1 else jnp.bool_(True)
    )
    kmin = jnp.min(
        jnp.where(fact_valid, fact_keys, jnp.iinfo(fact_keys.dtype).max)
    )
    kmax = jnp.max(
        jnp.where(fact_valid, fact_keys, jnp.iinfo(fact_keys.dtype).min)
    )
    parts = [
        jnp.all(dim_valid).astype(jnp.int64)[None],
        unique.astype(jnp.int64)[None],
        ks[0][None].astype(jnp.int64),
        ks[-1][None].astype(jnp.int64),
        kmin[None].astype(jnp.int64),
        kmax[None].astype(jnp.int64),
    ]
    big = jnp.iinfo(jnp.int64).max
    for v in valids:
        parts.append(jnp.all(v).astype(jnp.int64)[None])
    # FLOAT/DOUBLE value columns: detect k-dp decimals (k in 0/2/4/6 —
    # TPC-H measures and their products) so their sums can run in EXACT
    # integer arithmetic. Without this, per-group sums are differences of
    # GLOBAL f64 prefix sums, whose accumulated rounding (~ulp(total) *
    # sqrt(nblocks)) is amplified against small group sums — measured
    # 2e-9 relative on Q3 revenue at SF1, outside the oracle tolerance.
    # kcode = smallest integral k (or -1); min/max slots then carry the
    # SCALED int range (drives int32 payload packing).
    kcodes = []
    for d, v in zip(datas, valids):
        if not jnp.issubdtype(d.dtype, jnp.floating):
            kcodes.append(None)
            continue
        f = d.astype(jnp.float64)
        kc = jnp.float64(-1.0)
        for k in (6, 4, 2, 0):  # descending: smallest k wins last
            s = f * (10.0 ** k)
            fr = jnp.abs(s - jnp.round(s))
            row_ok = fr <= (1e-5 + jnp.abs(s) * 1e-12)
            allok = jnp.all(jnp.where(v, row_ok, True)) & (
                jnp.max(jnp.where(v, jnp.abs(s), 0.0)) < float(1 << 46)
            )
            kc = jnp.where(allok, jnp.float64(k), kc)
        kcodes.append(kc)

    def _scale_of(kc):
        return jnp.where(
            kc == 0, 1.0,
            jnp.where(kc == 2, 1e2, jnp.where(kc == 4, 1e4, 1e6)),
        )

    for d, v, kc in zip(datas, valids, kcodes):
        if kc is None:
            parts.append(jnp.min(jnp.where(v, d.astype(jnp.int64), big))[None])
        else:
            s = jnp.round(d.astype(jnp.float64) * _scale_of(kc)).astype(
                jnp.int64
            )
            parts.append(jnp.min(jnp.where(v, s, big))[None])
    for d, v, kc in zip(datas, valids, kcodes):
        if kc is None:
            parts.append(jnp.max(jnp.where(v, d.astype(jnp.int64), -big))[None])
        else:
            s = jnp.round(d.astype(jnp.float64) * _scale_of(kc)).astype(
                jnp.int64
            )
            parts.append(jnp.max(jnp.where(v, s, -big))[None])
    for kc in kcodes:
        parts.append(
            jnp.full((1,), -1, jnp.int64) if kc is None
            else kc.astype(jnp.int64)[None]
        )
    return ks, jnp.concatenate(parts)


@jax.jit
def _combine_keys(f1, f1v, f2, f2v, d1, d1v, d2, d2v):
    """Fold a two-key equi join into one combined int key:

        ck = (k_major - dim_major_min) * span_minor + (k_minor - minor_min)

    computed over the DIM minor span, so ck is injective across majors for
    in-span minors; fact rows whose minor key falls OUTSIDE the dim minor
    span would alias a neighbouring major's range and are masked invalid
    (they cannot match any dim row anyway). Returns (fact_ck, fact_ok,
    dim_ck, dim_ok, meta[s, mj_min, mn_min, f1_min, f1_max, d1_max]) —
    meta lets the host guard the packing against int64 overflow and the
    finalize program decode the combined key back into its two columns.
    ONE program, one small fetch. Combined asc order IS (major, minor)
    lexicographic order, so multi-key ORDER BY rides for free."""
    big = jnp.iinfo(jnp.int64).max
    d1 = d1.astype(jnp.int64)
    d2 = d2.astype(jnp.int64)
    f1 = f1.astype(jnp.int64)
    f2 = f2.astype(jnp.int64)
    d12v = d1v & d2v
    mn_min = jnp.min(jnp.where(d12v, d2, big))
    mn_max = jnp.max(jnp.where(d12v, d2, -big))
    mj_min = jnp.min(jnp.where(d12v, d1, big))
    d1_max = jnp.max(jnp.where(d12v, d1, -big))
    s = jnp.maximum(mn_max - mn_min + 1, 1)
    dim_ck = (d1 - mj_min) * s + (d2 - mn_min)
    in_span = (f2 >= mn_min) & (f2 <= mn_max)
    fact_ck = (f1 - mj_min) * s + (f2 - mn_min)
    fact_ok = f1v & f2v & in_span
    f1_min = jnp.min(jnp.where(fact_ok, f1, big))
    f1_max = jnp.max(jnp.where(fact_ok, f1, -big))
    meta = jnp.stack([s, mj_min, mn_min, f1_min, f1_max, d1_max])
    return fact_ck, fact_ok, dim_ck, d12v, meta


def _mask_payloads(pairs, packs, scales=None):
    """(data, valid|None) pairs -> payload arrays, NULLs as 0 (adds nothing
    to the payload sums; their count rides a validity payload). packs[i]
    selects int32 (range-checked by the caller — the sort is HBM-bound, so
    narrower payloads are proportionally cheaper); cast precedes masking so
    wrapped garbage in NULL slots is zeroed. FLOAT/DOUBLE payloads whose
    values are k-dp decimals (scales[i] >= 0, detected by _route_stats)
    ride as SCALED ints — their per-group sums are then EXACT integer
    arithmetic instead of f64 prefix differences (whose accumulated
    rounding is amplified against small group sums at scale); the finalize
    program divides by 10^k. Non-decimal floats keep their own width and
    accumulate float64."""
    out = []
    scales = scales or (-1,) * len(pairs)
    for (d, v), p32, sc in zip(pairs, packs, scales):
        if jnp.issubdtype(d.dtype, jnp.floating):
            if sc is not None and sc >= 0:
                x = jnp.round(d.astype(jnp.float64) * (10.0 ** sc)).astype(
                    jnp.int32 if p32 else jnp.int64
                )
                if v is not None:
                    x = jnp.where(v, x, jnp.zeros((), x.dtype))
                out.append(x)
                continue
            x = d
            if v is not None:
                x = jnp.where(v, x, jnp.zeros((), d.dtype))
            out.append(x)
            continue
        dt = jnp.int32 if p32 else jnp.int64
        x = d.astype(dt)
        if v is not None:
            x = jnp.where(v, x, jnp.zeros((), dt))
        out.append(x)
    return tuple(out)


@partial(
    jax.jit,
    static_argnames=(
        "n_groups", "val_bits", "pack32", "dense", "with_minmax",
        "with_distinct", "extra_packs", "extra_scales", "null_ix",
    ),
)
def _routed_kernel(fkeys, fvalid, fvals, fvals_valid, dim_sorted, miss_key,
                   n_groups: int, val_bits: int, pack32: bool, dense: bool,
                   with_minmax: bool, with_distinct: bool = False,
                   extra_pairs=(), extra_packs=(), extra_scales=(),
                   null_ix: int = -1):
    """Masked fact rows -> out-of-span key, then the direct kernel.

    dim_sorted is already sorted so dim_perm is the identity and the output
    arrives in ORDER BY key ascending order directly. fvals_valid (when not
    None) masks NULL packed values to the SENTINEL 2^val_bits - 1, which
    sorts them to each range's tail; the kernel subtracts their
    contributions using the validity payload at extra index null_ix —
    NULL-able min/max/sum/avg/DISTINCT stay exact. extra_pairs are
    (data, valid|None) payload columns, NULLs masked to 0 there."""
    from sqlrs_tpu.ops.pipelines import join_groupby_direct

    fk = jnp.where(fvalid, fkeys, miss_key).astype(jnp.int64)
    fv = fvals.astype(jnp.int64)
    if fvals_valid is not None:
        fv = jnp.where(fvals_valid, fv, jnp.int64((1 << val_bits) - 1))
    perm = jnp.arange(n_groups, dtype=jnp.int64)
    return join_groupby_direct(
        fk, fv, dim_sorted.astype(jnp.int64), perm, n_groups, val_bits, pack32,
        dense=dense, with_minmax=with_minmax, with_distinct=with_distinct,
        extra_vals=_mask_payloads(extra_pairs, extra_packs, extra_scales),
        null_ix=null_ix,
    )


@partial(
    jax.jit,
    static_argnames=(
        "n_groups", "pack32", "dense", "extra_packs", "extra_scales",
        "sum_scale", "null_ix",
    ),
)
def _routed_kernel_tv(fkeys, fvalid, fvals, fvals_valid, dim_sorted,
                      miss_key, n_groups: int, pack32: bool, dense: bool,
                      extra_pairs=(), extra_packs=(), extra_scales=(),
                      sum_scale: int = -1, null_ix: int = -1):
    """min/max over a FLOAT/DOUBLE measure: the measure rides as a SECOND
    sort operand under the order-preserving IEEE-754 bit transform
    (ops/pipelines.join_groupby_minmax_tv) — the route's answer to floats
    not fitting the packed int operand. NULL values mask to int64-max tv
    (range-tail sentinel) with the validity payload at null_ix; the f64
    sum payload masks NULLs to 0."""
    from sqlrs_tpu.ops.pipelines import f64_orderable, join_groupby_minmax_tv

    fk = jnp.where(fvalid, fkeys, miss_key).astype(jnp.int64)
    v64 = fvals.astype(jnp.float64)
    tv = f64_orderable(v64)
    if sum_scale >= 0:
        # k-dp decimal measure: the SUM payload rides as scaled int64 —
        # exact integer sums, divided back by the finalize program
        vpay = jnp.round(v64 * (10.0 ** sum_scale)).astype(jnp.int64)
    else:
        vpay = v64
    if fvals_valid is not None:
        tv = jnp.where(
            fvals_valid, tv, jnp.int64(jnp.iinfo(jnp.int64).max)
        )
        vpay = jnp.where(fvals_valid, vpay, jnp.zeros((), vpay.dtype))
    perm = jnp.arange(n_groups, dtype=jnp.int64)
    return join_groupby_minmax_tv(
        fk, vpay, tv, dim_sorted.astype(jnp.int64), perm, n_groups,
        pack32, dense=dense,
        extra_vals=_mask_payloads(extra_pairs, extra_packs, extra_scales),
        null_ix=null_ix,
    )


@partial(
    jax.jit,
    static_argnames=("n_groups", "rid_bits", "dense", "packs", "scales"),
)
def _routed_kernel_firstapp(fkeys, fvalid, pairs, dim_sorted, miss_key,
                            n_groups: int, rid_bits: int, dense: bool,
                            packs=(), scales=()):
    from sqlrs_tpu.ops.pipelines import join_groupby_firstapp

    fk = jnp.where(fvalid, fkeys, miss_key).astype(jnp.int64)
    perm = jnp.arange(n_groups, dtype=jnp.int64)
    return join_groupby_firstapp(
        fk, _mask_payloads(pairs, packs, scales),
        dim_sorted.astype(jnp.int64), perm,
        n_groups, rid_bits, dense=dense,
    )


@jax.jit
def _compact_nonempty(dim_sorted, arrays):
    """Drop zero-count groups keeping sorted order: one stable argsort by
    the drop flag; counts must be arrays[1]."""
    alive = arrays[1] > 0
    order = jnp.argsort(jnp.logical_not(alive), stable=True)
    return (
        dim_sorted[order],
        tuple(a[order] for a in arrays),
        jnp.sum(alive),
    )


@partial(
    jax.jit,
    static_argnames=(
        "n_out", "spec", "reorder", "order_ix", "reverse", "fscales",
    ),
)
def _finalize(arrays, n_out: int, spec, reorder: bool = False,
              order_ix: int = -1, reverse: bool = False, fscales=None,
              fdivs=None):
    """Emit every output column in ONE program. spec entries are
    (op, ai, bi, dtype, vop, vai): op 'slice' takes arrays[ai], 'div'
    computes float64 arrays[ai]/max(arrays[bi],1); dtype (np.dtype or
    None=keep) casts; vop selects the validity mask — 'ones', 'arr'
    (arrays[vai] is the mask), or 'gt0' (arrays[vai] > 0). reorder applies
    the first-appearance permutation argsort(arrays[order_ix][:n_out]) to
    every column — the per-column slice/cast/compare/argsort chain this
    replaces was one eager dispatch EACH."""
    if reorder:
        order = jnp.argsort(arrays[order_ix][:n_out])

        def take(a):
            return a[:n_out][order]
    elif reverse:  # ORDER BY key DESC: ascending kernel output, flipped
        def take(a):
            return a[:n_out][::-1]
    else:
        def take(a):
            return a[:n_out]

    ones = jnp.ones((n_out,), jnp.bool_)
    outs = []
    if fscales is None:
        fscales = (-1,) * len(spec)
    if fdivs is None:
        fdivs = (jnp.float64(1.0),) * len(spec)
    # the 10^k divisor rides as a TRACED operand: a constant denominator
    # gets strength-reduced by XLA into multiplication by the (inexact)
    # reciprocal, costing 1 ulp on ~a quarter of groups — a runtime
    # operand forces a true, correctly-rounded division
    for (op, ai, bi, dt, vop, vai), fsc, fdv in zip(spec, fscales, fdivs):
        if op == "slice":
            src = take(arrays[ai])
            if fsc >= 0:  # scaled-int decimal sum: divide back by 10^k
                src = src.astype(jnp.float64) / fdv
            if dt is not None:
                src = src.astype(dt)
        elif op in ("majk", "mink"):
            # composite-key decode: arrays[bi] is the _combine_keys meta
            # [s_minor, mj_min, mn_min, …]; combined keys are >= 0
            ck = arrays[bi]
            if op == "majk":
                src = take(arrays[ai]) // ck[0] + ck[1]
            else:
                src = take(arrays[ai]) % ck[0] + ck[2]
            if dt is not None:
                src = src.astype(dt)
        else:  # "div"
            num = take(arrays[ai]).astype(jnp.float64)
            if fsc >= 0:
                num = num / fdv
            den = jnp.maximum(take(arrays[bi]), 1).astype(jnp.float64)
            src = num / den
            if dt is not None:
                src = src.astype(dt)
        if vop == "ones":
            valid = ones
        elif vop == "arr":
            valid = take(arrays[vai])
        else:  # "gt0"
            valid = take(arrays[vai]) > 0
        outs.append(src)
        outs.append(valid)
    return tuple(outs)


def _routable_key_type(t) -> bool:
    """Join-key types the packed kernels handle: ints and DATE (stored as
    int32 days — equality and ORDER BY on day ints are exact)."""
    return (t.is_integral() and t != LogicalType.INTERVAL) or (
        t == LogicalType.DATE
    )


def _resolve_side(ref_index: int, left_width: int):
    """join-output column index -> (side, in-side index)."""
    if ref_index < left_width:
        return "left", ref_index
    return "right", ref_index - left_width


def _route_enabled(executor) -> bool:
    """The route runs its HashAgg(HashJoin) subtree from the scans up: off
    when the session disables it, and off for an executor whose children
    arrive precomputed (Executor.fused_routes), which would otherwise run
    that subtree a second time."""
    db = getattr(executor, "db", None)
    if db is not None and getattr(db, "enable_fused_route", True) is False:
        return False
    return getattr(executor, "fused_routes", True)


def try_order_agg_join_route(executor, op: P.PhysicalOrder):
    """Order(HashAgg(HashJoin)) with order key == group key: the output is
    produced directly in key order by the value-packed kernel (min/max
    supported). Returns None when ineligible."""
    if not _route_enabled(executor):
        return None
    if not op.items or len(op.items) > 2:
        return None
    dirs = {asc for _, asc in op.items}
    if len(dirs) != 1:
        return None  # mixed asc/desc cannot ride one packed order
    for j, (okey, _) in enumerate(op.items):
        if not isinstance(okey, BoundReference) or okey.index != j:
            return None
    if len(op.children) != 1 or not isinstance(op.children[0], P.PhysicalHashAgg):
        return None
    agg = op.children[0]
    # DESC: the kernel emits ascending key order; finalize reverses — the
    # direct variant (min/max/DISTINCT included) stays available. Two order
    # keys must be the two columns of a composite join key (checked inside).
    return _try_route(
        executor, op, agg, ordered=True, reverse=not dirs.pop(),
        n_order_keys=len(op.items),
    )


def try_agg_join_route(executor, agg: P.PhysicalHashAgg):
    """Bare HashAgg(HashJoin) — no ORDER BY above. The first-appearance
    group order the engine guarantees is recovered from the rowid-packed
    kernel (join_groupby_firstapp): min probe row index per group, one
    G-sized argsort. Values ride as sort payloads, so negatives are fine,
    but min/max aggregates are not available on this variant."""
    if not _route_enabled(executor):
        return None
    return _try_route(executor, agg, agg, ordered=False)


def _try_route(executor, op, agg, ordered: bool, reverse: bool = False,
               n_order_keys: int = 1):
    if not agg.groups or not all(
        isinstance(g, BoundReference) for g in agg.groups
    ):
        return None
    if len(agg.children) != 1:
        return None
    child = agg.children[0]
    # column pruning interposes a pure-reference Projection between the
    # aggregate and the join — see through it by remapping indices
    remap = None
    if (
        isinstance(child, P.PhysicalProjection)
        and len(child.children) == 1
        and all(isinstance(e, BoundReference) for e in child.exprs)
    ):
        remap = [e.index for e in child.exprs]
        child = child.children[0]
    if not isinstance(child, P.PhysicalHashJoin):
        return None
    join = child

    def _map(i: int) -> int:
        return remap[i] if remap is not None else i
    if (
        join.join_type != "inner"
        or len(join.on) not in (1, 2)
        or join.filter is not None
        or getattr(join, "null_aware", False)
    ):
        return None
    composite = len(join.on) == 2
    for lk, rk in join.on:
        if not isinstance(lk, BoundReference) or not isinstance(rk, BoundReference):
            return None
    lw = join.left_width
    if composite:
        # two-key equi join: both keys int; the first TWO group columns
        # must be the two key columns of one side (groups[0] = the major
        # key — its order dominates the combined packing)
        if ordered and n_order_keys != 2:
            return None  # ORDER BY one of two keys under-specifies ties
        for lk, rk in join.on:
            for k in (lk, rk):
                if not _routable_key_type(k.type):
                    return None
        if len(agg.groups) < 2:
            return None
        g0s, g0i = _resolve_side(_map(agg.groups[0].index), lw)
        g1s, g1i = _resolve_side(_map(agg.groups[1].index), lw)
        if g0s != g1s or g0i == g1i:
            return None
        (l1, r1), (l2, r2) = join.on
        side_keys = (
            (l1.index, l2.index) if g0s == "left" else (r1.index, r2.index)
        )
        if {g0i, g1i} != set(side_keys):
            return None
        maj_pair = 0 if g0i == side_keys[0] else 1
        key_positions = [0, 1]
        # (side, in-side index, position among agg.groups)
        extra_groups: list[tuple[str, int, int]] = []
        for gpos, g in enumerate(agg.groups[2:], start=2):
            extra_groups.append((*_resolve_side(_map(g.index), lw), gpos))
        varchar_key = False
    else:
        if ordered and n_order_keys != 1:
            return None
        lkey, rkey = join.on[0]
        # VARCHAR keys are int32 dictionary codes — equality on codes IS
        # string equality, so the first-appearance variant routes them (its
        # group order never depends on code order); the ORDER BY variant
        # would order by code, not collation, and bails.
        varchar_key = (
            lkey.type == LogicalType.VARCHAR
            and rkey.type == LogicalType.VARCHAR
        )
        if varchar_key:
            if ordered:
                return None
        elif not (_routable_key_type(lkey.type) and _routable_key_type(rkey.type)):
            return None
        # SOME group column must BE the join key column of its side (any
        # position — Q18-class rollups list dim attributes before the key);
        # every other group column must be a DIM-side attribute — with
        # unique dim keys they are functionally dependent on the key, so
        # they refine nothing and are emitted via G-sized gathers
        key_positions = []
        extra_groups = []
        for gpos, g in enumerate(agg.groups):
            side, idx = _resolve_side(_map(g.index), lw)
            if idx == (lkey.index if side == "left" else rkey.index):
                key_positions.append(gpos)
            else:
                extra_groups.append((side, idx, gpos))
        if not key_positions:
            return None
        if ordered and key_positions[0] != 0:
            # the ORDER BY references output column 0, which must be the key
            return None

    # aggregates: sum/count/min/max/avg over ANY number of distinct value
    # expressions whose column references all live on the side opposite the
    # (unique-key) dim side, plus count(*). Non-reference expressions
    # (sum(a*b), …) are evaluated over the fact batch with the fused
    # expression executor before the kernel. One expression may be PACKED
    # into the sort key (enabling min/max + a free prefix sum); every other
    # expression rides the variadic sort as a payload — nearly free
    # (measured flat in operand count) and tolerant of negative values.
    from sqlrs_tpu.binder.expression import visit_expr

    val_side = None
    val_exprs: list = []       # distinct value expressions, by repr
    val_keys: list[str] = []
    specs: list[tuple[str, int | None]] = []  # (kind, val_exprs index)
    for a in agg.aggregates:
        if not isinstance(a, BoundAggregate):
            return None
        if a.distinct and (
            not ordered or a.function_name not in ("count", "sum", "avg")
        ):
            # DISTINCT needs the value packed into the sort key (adjacent
            # duplicates); only the ordered variant packs values
            return None
        if a.arg is None:
            if a.function_name != "count":
                return None
            specs.append(("count_star", None))
            continue
        if a.function_name not in ("sum", "count", "min", "max", "avg"):
            return None
        rt_arg = a.arg.return_type()
        if rt_arg.is_float():
            # FLOAT/DOUBLE measures ride the variadic sort as payloads
            # unchanged (payload sums need no ordering) and accumulate
            # float64 — this is what lets real TPC-H rollups route (every
            # TPC-H measure is DOUBLE). They cannot pack into the sort key,
            # so min/max/DISTINCT over floats fall back (checked below).
            pass
        elif not rt_arg.is_integral() or rt_arg in (
            LogicalType.DATE, LogicalType.INTERVAL
        ):
            return None
        if not ordered and a.function_name in ("min", "max"):
            return None  # rowid packing cannot order values within a range
        refs: list[int] = []
        bad = []
        visit_expr(
            a.arg,
            lambda e: (
                refs.append(e.index) if isinstance(e, BoundReference)
                else bad.append(e) if isinstance(e, BoundAggregate) else None
            ),
        )
        if bad or not refs:
            return None  # nested aggregate / constant-only argument
        ref_sides = {_resolve_side(_map(i), lw)[0] for i in refs}
        if len(ref_sides) != 1:
            return None
        side = ref_sides.pop()
        if val_side is None:
            val_side = side
        elif side != val_side:
            return None  # value expressions split across both join sides
        key = repr(a.arg)
        if key in val_keys:
            ix = val_keys.index(key)
        else:
            ix = len(val_keys)
            val_keys.append(key)
            val_exprs.append(a.arg)
        specs.append(
            (a.function_name + ("_d" if a.distinct else ""), ix)
        )
    # min/max and DISTINCT need their value packed into the sort key; only
    # one expression can be packed
    minmax_ixs = {ix for k, ix in specs if k in ("min", "max")}
    distinct_ixs = {ix for k, ix in specs if k.endswith("_d")}
    packed_need = minmax_ixs | distinct_ixs
    if len(packed_need) > 1:
        return None
    expr_float = [e.return_type().is_float() for e in val_exprs]
    # float min/max routes via the two-operand tv kernel (order-preserving
    # IEEE-754 transform as a second sort key); float DISTINCT would need
    # value-equality packing and still falls back
    float_tv = bool(packed_need) and expr_float[next(iter(packed_need))]
    if float_tv and distinct_ixs:
        return None

    # ---- execute children (normal recursion; scans/filters run as usual) --
    # stash the batches in the executor's one-shot cache so a later bail
    # does NOT re-execute the subtree (the general path pops them)
    left = executor.execute(join.children[0])
    right = executor.execute(join.children[1])
    cache = getattr(executor, "_route_cache", None)
    if cache is None:
        cache = executor._route_cache = {}
    cache[id(join.children[0])] = left
    cache[id(join.children[1])] = right
    sides = {"left": left, "right": right}

    # ---- choose dim (unique build) side ---------------------------------
    # aggregate values live on the fact side; with only count(*) either
    # side may serve as dim — pick the smaller one (the group VALUES are
    # equal on both sides of an inner equi join).
    if val_side is not None:
        dim_side = "left" if val_side == "right" else "right"
    elif left.num_rows <= right.num_rows:
        dim_side = "left"
    else:
        dim_side = "right"
    fact_side = "left" if dim_side == "right" else "right"
    if any(side != dim_side for side, _, _ in extra_groups):
        return None  # non-key group columns must be dim attributes
    dim_b, fact_b = sides[dim_side], sides[fact_side]
    n_groups = dim_b.num_rows
    n_fact = fact_b.num_rows
    if n_groups == 0 or n_fact == 0 or n_groups > n_fact:
        return None  # empty inputs / dim larger than fact: general path

    ck_meta_dev = None
    if composite:
        # fold the two keys into one combined int key (ONE program + one
        # small fetch); everything downstream runs the single-key machinery
        def _side_col(b, side, pair_ix):
            lk, rk = join.on[pair_ix]
            return b.columns[(lk if side == "left" else rk).index]

        d1c = _side_col(dim_b, dim_side, maj_pair)
        d2c = _side_col(dim_b, dim_side, 1 - maj_pair)
        f1c = _side_col(fact_b, fact_side, maj_pair)
        f2c = _side_col(fact_b, fact_side, 1 - maj_pair)
        fact_ck, fact_ok, dim_ck, dim_ok, ck_meta_dev = _combine_keys(
            f1c.data, f1c.valid, f2c.data, f2c.valid,
            d1c.data, d1c.valid, d2c.data, d2c.valid,
        )
        ckm = _np.asarray(ck_meta_dev)
        s_minor, mj_min = int(ckm[0]), int(ckm[1])
        f1_min, f1_max, d1_max = int(ckm[3]), int(ckm[4]), int(ckm[5])
        # int64 overflow guard on (k_major - mj_min) * s_minor
        span = max(abs(f1_max - mj_min) + 1, abs(f1_min - mj_min) + 1,
                   abs(d1_max - mj_min) + 1)
        if s_minor <= 0 or span >= (1 << 61) // max(s_minor, 1):
            return None
        dim_key_col = Column(LogicalType.BIGINT, dim_ck, dim_ok)
        fact_key_col = Column(LogicalType.BIGINT, fact_ck, fact_ok)
    else:
        dim_key_col = dim_b.columns[
            rkey.index if dim_side == "right" else lkey.index
        ]
        fact_key_col = fact_b.columns[
            lkey.index if fact_side == "left" else rkey.index
        ]
    # materialize every distinct value expression over the fact batch:
    # direct column refs are free; everything else runs in ONE fused program
    val_cols: list = [None] * len(val_exprs)
    to_eval, eval_ixs = [], []
    for k, e in enumerate(val_exprs):
        if isinstance(e, BoundReference):
            val_cols[k] = fact_b.columns[_resolve_side(_map(e.index), lw)[1]]
        else:
            to_eval.append(e)
            eval_ixs.append(k)
    if to_eval:
        # refs rewritten from join-output to fact-batch indices
        import dataclasses

        from sqlrs_tpu.binder.expression import rewrite_expr
        from sqlrs_tpu.exec.expression_executor import execute_exprs_fused

        def _rw(e):
            if isinstance(e, BoundReference):
                return dataclasses.replace(
                    e, index=_resolve_side(_map(e.index), lw)[1]
                )
            return None

        outs = execute_exprs_fused(
            [rewrite_expr(e, _rw) for e in to_eval], fact_b
        )
        for k, c in zip(eval_ixs, outs):
            val_cols[k] = c

    # ---- dynamic checks (ONE tiny program + ONE host fetch) --------------
    nv = len(val_cols)
    dim_sorted, meta_dev = _route_stats(
        dim_key_col.data.astype(jnp.int64), dim_key_col.valid,
        fact_key_col.data.astype(jnp.int64), fact_key_col.valid,
        tuple(c.data for c in val_cols),
        tuple(c.valid for c in val_cols),
    )
    meta = _np.asarray(meta_dev)
    if not bool(meta[0]) or not bool(meta[1]):
        return None  # NULL or duplicate dim keys
    d_min, d_max = int(meta[2]), int(meta[3])
    f_kmin, f_kmax = int(meta[4]), int(meta[5])
    with_minmax = bool(minmax_ixs)
    with_distinct = bool(distinct_ixs)
    nullable: list[bool] = []
    fits32: list[bool] = []
    vmins = vmaxs = ()
    kscales: list[int] = []
    if val_cols:
        # NULL-able value columns are handled with masked payloads (NULL
        # sums as 0) plus one validity payload each for the per-group
        # non-NULL count (count(v), avg denominator, all-NULL-group NULL
        # sums). min/max alone need every value real: range endpoints of
        # the packed sort cannot skip masked entries.
        flags = meta[6:6 + nv]
        vmins = meta[6 + nv:6 + 2 * nv]
        vmaxs = meta[6 + 2 * nv:6 + 3 * nv]
        nullable = [not bool(f) for f in flags]
        # k-dp decimal scale per float column (-1: not a decimal / int
        # col); float min/max slots carry the SCALED int range. Scaled
        # payloads whose worst-case total could round in int64 fall back
        # to f64 payloads.
        kscales = [int(x) for x in meta[6 + 3 * nv:6 + 4 * nv]]
        for k in range(nv):
            if expr_float[k] and kscales[k] >= 0:
                mag = max(abs(int(vmins[k])), abs(int(vmaxs[k])), 1)
                if mag * n_fact >= (1 << 62):
                    kscales[k] = -1
        lo32, hi32 = -(1 << 31), (1 << 31) - 1
        fits32 = [
            (not expr_float[k] or kscales[k] >= 0) and (
                int(mn) > int(mx)  # no valid rows: masked zeros
                or (lo32 < int(mn) and int(mx) < hi32)
            )
            for k, (mn, mx) in enumerate(zip(vmins, vmaxs))
        ]
        # NULL-able min/max/DISTINCT pack too: NULLs mask to an above-range
        # sentinel and the kernel subtracts their contributions (sentinel
        # mode, join_groupby_direct null_ix)
    f_kmax = max(f_kmax, d_max)
    f_kmin = min(f_kmin, d_min)
    miss_key = f_kmax + 1  # out of every dim range, incl. the last boundary
    dense = (d_max - d_min + 1) == n_groups

    # validity payloads: one per NULL-able expression (per-group non-NULL
    # counts for count(v) / avg denominators / NULL-sum detection)
    valid_ixs = [k for k in range(len(val_cols)) if nullable[k]]
    if ordered:
        # the packed expression: the min/max/DISTINCT one if any (those
        # REQUIRE packing — range endpoints / adjacent duplicates), else the
        # first expression whose valid range packs (0 <= value, headroom);
        # its prefix sum comes free with the rank rows. Everything else
        # rides as payloads; no packable expression at all is fine too.
        def _bits_ok(k):
            if expr_float[k]:
                return None  # floats never pack; they ride as payloads
            vmx = max(int(vmaxs[k]), 0)
            if int(vmins[k]) < 0 and int(vmins[k]) <= int(vmaxs[k]):
                return None
            if nullable[k]:
                vmx += 1  # sentinel mode: every real value < 2^vb - 1
            vb = max(vmx.bit_length(), 1)
            if vb >= 62 or miss_key >= (1 << (62 - vb)) or f_kmin <= -(
                1 << (62 - vb)
            ):
                return None
            return vb

        packed_ix = None
        val_bits = 1
        if packed_need:
            packed_ix = next(iter(packed_need))
            if float_tv:
                pass  # value rides the second sort operand; val_bits unused
            else:
                vb = _bits_ok(packed_ix)
                if vb is None:
                    return None  # min/max/DISTINCT cannot ride a payload
                val_bits = vb
        else:
            for k in range(len(val_cols)):
                vb = _bits_ok(k)
                if vb is not None:
                    packed_ix, val_bits = k, vb
                    break
        if miss_key >= (1 << (62 - val_bits)) or f_kmin <= -(1 << (62 - val_bits)):
            return None  # packing headroom exhausted
        pack32 = (
            miss_key < (1 << (31 - val_bits)) - 1
            and f_kmin > -(1 << (31 - val_bits))
        )
        extra_ixs = [k for k in range(len(val_cols)) if k != packed_ix]
        vals = (val_cols[packed_ix].data if packed_ix is not None
                else jnp.zeros((n_fact,), jnp.int64))
        pvalid = (
            val_cols[packed_ix].valid
            if packed_ix is not None and nullable[packed_ix] else None
        )
        pairs = tuple(
            (val_cols[k].data, val_cols[k].valid if nullable[k] else None)
            for k in extra_ixs
        ) + tuple(
            (val_cols[k].valid.astype(jnp.int32), None) for k in valid_ixs
        )
        packs = tuple(fits32[k] for k in extra_ixs) + tuple(
            True for _ in valid_ixs  # 0/1 flags always fit
        )
        scales_t = tuple(
            kscales[k] if expr_float[k] else -1 for k in extra_ixs
        ) + tuple(-1 for _ in valid_ixs)
        # sentinel mode: the packed column's validity payload position
        null_ix = (
            len(extra_ixs) + valid_ixs.index(packed_ix)
            if pvalid is not None else -1
        )
        if float_tv:
            out = _routed_kernel_tv(
                fact_key_col.data.astype(jnp.int64), fact_key_col.valid,
                vals, pvalid, dim_sorted, _np.int64(miss_key),
                n_groups=n_groups, pack32=bool(pack32), dense=dense,
                extra_pairs=pairs, extra_packs=packs,
                extra_scales=scales_t,
                sum_scale=kscales[packed_ix], null_ix=null_ix,
            )
        else:
            out = _routed_kernel(
                fact_key_col.data.astype(jnp.int64), fact_key_col.valid,
                vals, pvalid, dim_sorted, _np.int64(miss_key),
                n_groups=n_groups, val_bits=val_bits, pack32=bool(pack32),
                dense=dense, with_minmax=with_minmax,
                with_distinct=with_distinct,
                extra_pairs=pairs, extra_packs=packs,
                extra_scales=scales_t, null_ix=null_ix,
            )
        # kernel layout: sums_packed, counts, [mins, maxs,] [dcnt, dsum,]
        # extra sums…, validity counts…
        dbase = 4 if with_minmax else 2
        kb = dbase + (2 if with_distinct else 0)
        dcnt_ai, dsum_ai = dbase, dbase + 1
        expr_src = {k: kb + j for j, k in enumerate(extra_ixs)}
        if packed_ix is not None:
            expr_src[packed_ix] = 0
        vbase = kb + len(extra_ixs)
        expr_vcnt = {k: vbase + j for j, k in enumerate(valid_ixs)}
    else:
        rid_bits = max(n_fact.bit_length(), 1)
        if miss_key >= (1 << (62 - rid_bits)) or f_kmin <= -(1 << (62 - rid_bits)):
            return None
        pairs = tuple(
            (c.data, c.valid if nullable[k] else None)
            for k, c in enumerate(val_cols)
        ) + tuple(
            (val_cols[k].valid.astype(jnp.int32), None) for k in valid_ixs
        )
        packs = tuple(fits32) + tuple(True for _ in valid_ixs)
        scales_t = tuple(
            kscales[k] if expr_float[k] else -1
            for k in range(len(val_cols))
        ) + tuple(-1 for _ in valid_ixs)
        if not pairs:
            pairs = ((jnp.zeros((n_fact,), jnp.int32), None),)
            packs = (True,)
            scales_t = (-1,)
        out = _routed_kernel_firstapp(
            fact_key_col.data.astype(jnp.int64), fact_key_col.valid,
            pairs, dim_sorted, _np.int64(miss_key),
            n_groups=n_groups, rid_bits=rid_bits, dense=dense, packs=packs,
            scales=scales_t,
        )
        # kernel layout: sums_0, counts, firsts, sums_1…, validity counts…
        expr_src = {k: (0 if k == 0 else k + 2) for k in range(len(val_cols))}
        vbase = len(val_cols) + 2
        expr_vcnt = {k: vbase + j for j, k in enumerate(valid_ixs)}

    # extra dim group columns and (for first-appearance ordering with the
    # dim on the probe side) original dim positions ride the compaction as
    # additional G-sized arrays, aligned to key-sorted order via sperm
    base_len = len(out)
    extras_flat: list = []
    need_sperm = bool(extra_groups) or (not ordered and fact_side == "left")
    sperm = (
        jnp.argsort(dim_key_col.data.astype(jnp.int64)) if need_sperm else None
    )
    for _, idx, _ in extra_groups:
        c = dim_b.columns[idx]
        extras_flat.append(c.data[sperm])
        extras_flat.append(c.valid[sperm])
    pos_idx = None
    if not ordered and fact_side == "left":
        # pairs are emitted right-row-major (ops/join.py equi_join_pairs:
        # "(right_row, left insertion order)" per the reference's probe
        # order), so with the DIM side on the right the group
        # first-appearance order is the dim table's ORIGINAL row order
        pos_idx = base_len + len(extras_flat)
        extras_flat.append(sperm.astype(jnp.int64))
    keys_c, arrays_c, n_alive = _compact_nonempty(
        dim_sorted, tuple(out) + tuple(extras_flat)
    )
    n_out = int(n_alive)  # the ONLY host sync after the kernel

    # ---- build the output batch in ONE finalize program ------------------
    # arrays handed to _finalize: (keys_c,) + arrays_c — arrays_c[i] is at
    # finalize index i+1
    A = 1
    # group output columns follow agg.groups order: key positions slice (or
    # composite-decode) the kernel key, every other position gathers its
    # compacted dim-attribute array
    extra_entry = {}
    for i, (_, idx, gpos) in enumerate(extra_groups):
        extra_entry[gpos] = (
            ("slice", A + base_len + 2 * i, -1, None,
             "arr", A + base_len + 2 * i + 1),
            dim_b.columns[idx].type,
        )
    spec: list = []
    col_types: list = []
    if composite:
        # decode the combined key back into its two columns inside the
        # finalize program (ck meta rides as the LAST finalize array)
        ck_ix = A + len(arrays_c)
        t0 = agg.types[0] if agg.types else LogicalType.BIGINT
        t1 = agg.types[1] if len(agg.types) > 1 else LogicalType.BIGINT
        spec.append(("majk", 0, ck_ix, numpy_dtype_for(t0), "ones", -1))
        spec.append(("mink", 0, ck_ix, numpy_dtype_for(t1), "ones", -1))
        col_types.extend([t0, t1])
        for gpos in range(2, len(agg.groups)):
            e, t = extra_entry[gpos]
            spec.append(e)
            col_types.append(t)
    else:
        for gpos in range(len(agg.groups)):
            if gpos in extra_entry:
                e, t = extra_entry[gpos]
                spec.append(e)
                col_types.append(t)
            else:  # a key position (the key may repeat among the groups)
                gtype = (
                    agg.types[gpos] if gpos < len(agg.types)
                    else dim_key_col.type
                )
                spec.append(
                    ("slice", 0, -1, numpy_dtype_for(gtype), "ones", -1)
                )
                col_types.append(gtype)
    cnt_ai = A + 1
    fscales_l: list[int] = [-1] * len(spec)  # group columns: no scaling
    for (kind, ix), a in zip(specs, agg.aggregates):
        rt = a.return_type()
        dt = numpy_dtype_for(rt)
        fscales_l.append(
            kscales[ix]
            if kind in ("sum", "avg") and ix is not None
            and expr_float[ix] and kscales[ix] >= 0
            else -1
        )
        if kind == "sum":
            vop, vai = (
                ("gt0", A + expr_vcnt[ix]) if ix in expr_vcnt
                else ("ones", -1)  # all-NULL group sums to NULL
            )
            entry = ("slice", A + expr_src[ix], -1, dt, vop, vai)
        elif kind == "min":
            vop, vai = (
                ("gt0", A + expr_vcnt[ix]) if ix in expr_vcnt
                else ("ones", -1)  # all-NULL group: min/max render NULL
            )
            entry = ("slice", A + 2, -1, dt, vop, vai)
        elif kind == "max":
            vop, vai = (
                ("gt0", A + expr_vcnt[ix]) if ix in expr_vcnt
                else ("ones", -1)
            )
            entry = ("slice", A + 3, -1, dt, vop, vai)
        elif kind == "avg":
            den = A + expr_vcnt[ix] if ix in expr_vcnt else cnt_ai
            vop, vai = (
                ("gt0", den) if ix in expr_vcnt else ("ones", -1)
            )
            entry = ("div", A + expr_src[ix], den, dt, vop, vai)
        elif kind == "count_d":
            entry = ("slice", A + dcnt_ai, -1, dt, "ones", -1)
        elif kind == "sum_d":
            vop, vai = (
                ("gt0", A + expr_vcnt[ix]) if ix in expr_vcnt
                else ("ones", -1)  # all-NULL group: NULL distinct sum
            )
            entry = ("slice", A + dsum_ai, -1, dt, vop, vai)
        elif kind == "avg_d":
            vop, vai = (
                ("gt0", A + expr_vcnt[ix]) if ix in expr_vcnt
                else ("ones", -1)
            )
            entry = ("div", A + dsum_ai, A + dcnt_ai, dt, vop, vai)
        elif kind == "count" and ix in expr_vcnt:
            # non-NULL count of a NULL-able expression
            entry = ("slice", A + expr_vcnt[ix], -1, dt, "ones", -1)
        else:  # count(all-valid v) / count_star
            entry = ("slice", cnt_ai, -1, dt, "ones", -1)
        spec.append(entry)
        col_types.append(rt)
    if ordered:
        reorder, order_ix = False, -1
    else:
        # reorder the surviving groups into first-appearance order (the
        # engine's guaranteed group order): fact on the right → min probe
        # (fact) rowid; dim on the right → original dim row position
        reorder = True
        order_ix = A + 2 if fact_side == "right" else A + pos_idx
    fin_arrays = (keys_c,) + tuple(arrays_c)
    if composite:
        fin_arrays = fin_arrays + (ck_meta_dev,)
    flat = _finalize(
        fin_arrays, n_out, tuple(spec),
        reorder=reorder, order_ix=order_ix, reverse=reverse,
        fscales=tuple(fscales_l),
        fdivs=tuple(
            jnp.float64(10.0 ** f) if f >= 0 else jnp.float64(1.0)
            for f in fscales_l
        ),
    )
    cols = [
        Column(t, flat[2 * i], flat[2 * i + 1])
        for i, t in enumerate(col_types)
    ]
    if hasattr(executor, "db") and executor.db is not None:
        log = getattr(executor.db, "last_fused_routes", None)
        if log is None:
            log = []
            executor.db.last_fused_routes = log
        log.append(
            ("order_agg_join_direct" if ordered else "agg_join_firstapp")
            + ("_dense" if dense else "")
            + ("_ck2" if composite else "")
            + ("_tv" if ordered and float_tv else "")
        )
    cache.pop(id(join.children[0]), None)  # consumed — don't leak into a
    cache.pop(id(join.children[1]), None)  # later executor walk
    return DeviceBatch(_out_schema(op, agg), cols, n_out)


def _out_schema(op: P.PhysicalOrder, agg: P.PhysicalHashAgg):
    from sqlrs_tpu.exec.executor import _schema

    return _schema(op if op.names else agg)
