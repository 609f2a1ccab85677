"""Fused compiled query pipelines (the benchmark / scale path).

Each pipeline is ONE jit program: scan → probe → aggregate with no host
round-trips, so a query is a handful of XLA executions rather than hundreds
of small dispatches. These back `bench.py`, `__graft_entry__.py`, and the
kernel benchmarks; the general SQL executor uses the same building blocks
(ops/join.py pair generation, ops/grouped_agg.py sorted runs), and
`exec/fused_route.py` routes whole star-rollup SQL plans
(HashAgg-over-HashJoin, ± ORDER BY) onto join_groupby_direct /
join_groupby_firstapp directly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from sqlrs_tpu.ops.hash_table import build_join_table, next_pow2, probe_counts


@partial(jax.jit, static_argnames=("n_groups", "capacity"))
def join_groupby_local(fact_keys, fact_vals, dim_keys, n_groups: int, capacity: int):
    """SELECT dim_row, sum(v), count(*) FROM fact JOIN dim USING(key)
    GROUP BY dim_row — single chip, one fused XLA program.

    Equivalent single-node semantics to the reference's HashJoin→HashAgg
    chain (reference src/executor/join/hash_join.rs + aggregate/hash_agg.rs)
    for unique dim keys, without materializing the join."""
    table, start, bcounts, order = build_join_table(dim_keys, capacity)
    found, _ = probe_counts(table, fact_keys, bcounts, capacity)
    matched = found >= 0
    slot = jnp.maximum(found, 0)
    dim_row = order[jnp.clip(start[slot], 0, order.shape[0] - 1)]
    gid = jnp.where(matched, dim_row, n_groups)
    sums = jnp.zeros((n_groups + 1,), fact_vals.dtype).at[gid].add(
        jnp.where(matched, fact_vals, 0)
    )
    counts = jnp.zeros((n_groups + 1,), jnp.int64).at[gid].add(
        matched.astype(jnp.int64)
    )
    return sums[:n_groups], counts[:n_groups]


@partial(jax.jit, static_argnames=("n_groups", "run_capacity"))
def join_groupby_sorted(
    fact_keys, fact_vals, dim_keys_sorted, dim_perm, n_groups: int, run_capacity: int
):
    """Sort-merge join + group-by: the run-boundary formulation.

    The opposite of the reference's hash loops — every N-sized step streams
    and all random access is group-sized:

      1. sort (key, value)                       — the only O(N log N) step
      2. run boundaries + prefix sums            — pure streaming scans
      3. per-run sum/count = cumsum differences at run ends, where run ends
         come from searchsorted(rid, arange(R)) — only R (#distinct keys)
         queries, not N
      4. run key -> dim row via searchsorted into the sorted dim keys — again
         R queries — and a final R-sized scatter into the output

    Every N-sized operation is sequential-access; all random access is
    R-sized (R <= run_capacity ~ #groups). Returns (sums, counts, n_runs);
    n_runs > run_capacity means undercounted output — callers size
    run_capacity >= distinct keys (misses included) or fall back.
    """
    n = fact_keys.shape[0]
    ks, vs = lax.sort((fact_keys, fact_vals), num_keys=1)
    prev = jnp.concatenate([ks[:1] - 1, ks[:-1]])
    new_run = ks != prev
    rid = jnp.cumsum(new_run.astype(jnp.int32)) - 1
    n_runs = rid[-1] + 1
    csum = jnp.cumsum(vs)

    r = jnp.arange(run_capacity, dtype=jnp.int32)
    ends = jnp.searchsorted(rid, r, side="right")
    prev_end = jnp.concatenate([jnp.zeros((1,), ends.dtype), ends[:-1]])
    valid_run = ends > prev_end
    last = jnp.clip(ends - 1, 0, n - 1)
    base = jnp.where(prev_end > 0, csum[jnp.clip(prev_end - 1, 0, n - 1)], 0)
    run_sum = csum[last] - base
    run_cnt = (ends - prev_end).astype(jnp.int64)
    run_key = ks[last]

    pos = jnp.searchsorted(dim_keys_sorted, run_key)
    pos_c = jnp.clip(pos, 0, n_groups - 1)
    hit = valid_run & (dim_keys_sorted[pos_c] == run_key)
    out_row = jnp.where(hit, dim_perm[pos_c], n_groups)
    sums = jnp.zeros((n_groups + 1,), fact_vals.dtype).at[out_row].add(
        jnp.where(hit, run_sum, 0)
    )
    counts = jnp.zeros((n_groups + 1,), jnp.int64).at[out_row].add(
        jnp.where(hit, run_cnt, 0)
    )
    return sums[:n_groups], counts[:n_groups], n_runs


@partial(jax.jit, static_argnames=("n_groups", "run_capacity", "val_bits"))
def join_groupby_sorted_packed(
    fact_keys,
    fact_vals,
    dim_keys_sorted,
    dim_perm,
    n_groups: int,
    run_capacity: int,
    val_bits: int,
):
    """join_groupby_sorted with (key << val_bits | value) packed into ONE
    int64 sort operand — half the sort traffic when the ranges fit
    (key < 2^(63-val_bits), 0 <= value < 2^val_bits). Runs stay contiguous
    per key because the value occupies the low bits."""
    n = fact_keys.shape[0]
    packed = (fact_keys << val_bits) | fact_vals
    sp = lax.sort(packed)
    ks = sp >> val_bits
    vs = sp & ((1 << val_bits) - 1)
    prev = jnp.concatenate([ks[:1] - 1, ks[:-1]])
    new_run = ks != prev
    rid = jnp.cumsum(new_run.astype(jnp.int32)) - 1
    n_runs = rid[-1] + 1
    csum = jnp.cumsum(vs)

    r = jnp.arange(run_capacity, dtype=jnp.int32)
    ends = jnp.searchsorted(rid, r, side="right")
    prev_end = jnp.concatenate([jnp.zeros((1,), ends.dtype), ends[:-1]])
    valid_run = ends > prev_end
    last = jnp.clip(ends - 1, 0, n - 1)
    base = jnp.where(prev_end > 0, csum[jnp.clip(prev_end - 1, 0, n - 1)], 0)
    run_sum = csum[last] - base
    run_cnt = (ends - prev_end).astype(jnp.int64)
    run_key = ks[last]

    pos = jnp.searchsorted(dim_keys_sorted, run_key)
    pos_c = jnp.clip(pos, 0, n_groups - 1)
    hit = valid_run & (dim_keys_sorted[pos_c] == run_key)
    out_row = jnp.where(hit, dim_perm[pos_c], n_groups)
    sums = jnp.zeros((n_groups + 1,), fact_vals.dtype).at[out_row].add(
        jnp.where(hit, run_sum, 0)
    )
    counts = jnp.zeros((n_groups + 1,), jnp.int64).at[out_row].add(
        jnp.where(hit, run_cnt, 0)
    )
    return sums[:n_groups], counts[:n_groups], n_runs


def _ranks_and_value_prefix(sp2d, queries, vmask, bp):
    """Fused merge-rank + value prefix sum: rank_left(q) AND the prefix sum
    of the packed VALUES below q's insertion point, from ONE gathered row
    per query.

    The insertion point of q lies inside candidate block c-1 (c = count of
    block minima strictly below q, from the tiny merge sort), so

        prefix_values(q) = bp[c-1] + sum(row & vmask where row < q)

    over the SAME row the rank reduction reads — the separate prefix_at
    stage (two more (2G,128) gathers) disappears.

    bp: per-block exclusive value-prefix table (nb+1). Returns
    (rank_left, value_prefix) with value_prefix in bp's dtype."""
    nb, blk = sp2d.shape
    n = nb * blk
    q = queries
    nq = q.shape[0]
    vals = jnp.concatenate([sp2d[:, 0], q])
    tags = jnp.concatenate(
        [jnp.ones((nb,), jnp.int32), jnp.zeros((nq,), jnp.int32)]
    )
    ids = jnp.concatenate(
        [jnp.arange(nb, dtype=jnp.int32), jnp.arange(nq, dtype=jnp.int32)]
    )
    _, st, si = lax.sort((vals, tags, ids), num_keys=2)
    pos = jnp.arange(nb + nq, dtype=jnp.int64)
    is_q = st == 0
    qrank = jnp.cumsum(is_q.astype(jnp.int64)) - 1
    c_at = pos - qrank
    c = (
        jnp.zeros((nq + 1,), jnp.int64)
        .at[jnp.where(is_q, si.astype(jnp.int64), nq)]
        .set(c_at)[:nq]
    )
    rows = sp2d[jnp.clip(c - 1, 0, nb - 1)]
    below = rows < q[:, None]
    rank_ge = jnp.sum(jnp.logical_not(below).astype(jnp.int64), axis=1)
    count_ge = jnp.where(c == 0, n, (nb - c) * blk + rank_ge)
    inblock = jnp.sum(
        jnp.where(below, (rows & vmask).astype(jnp.int32), 0).astype(bp.dtype),
        axis=1,
    )
    prefix = jnp.where(c == 0, 0, bp[jnp.clip(c - 1, 0, nb - 1)] + inblock)
    return n - count_ge, prefix


def _sorted_ranks_left(sp2d, queries):
    """searchsorted(sp.ravel(), queries, side='left') for a block-reshaped
    sorted array — via ONE small merge sort of (block minima ++ queries) and
    one gathered block row per query, instead of log2(N) latency-bound
    gathers per query.

    For each query q let c = #block-minima strictly < q (from the merged
    order). Every block >= c holds only elements >= q, every block < c-1
    only elements < q, and block c-1 is ranked by a 128-wide row scan:
        count_ge(q) = (nb - c)·blk + rank_ge(row[c-1], q)
        rank_left(q) = n - count_ge(q).
    """
    nb, blk = sp2d.shape
    n = nb * blk
    q = queries
    nq = q.shape[0]
    vals = jnp.concatenate([sp2d[:, 0], q])
    # ties: queries (tag 0) sort before equal block minima (tag 1), so equal
    # minima are NOT counted as "strictly before"
    tags = jnp.concatenate(
        [jnp.ones((nb,), jnp.int32), jnp.zeros((nq,), jnp.int32)]
    )
    ids = jnp.concatenate(
        [jnp.arange(nb, dtype=jnp.int32), jnp.arange(nq, dtype=jnp.int32)]
    )
    _, st, si = lax.sort((vals, tags, ids), num_keys=2)
    pos = jnp.arange(nb + nq, dtype=jnp.int64)
    is_q = st == 0
    qrank = jnp.cumsum(is_q.astype(jnp.int64)) - 1
    c_at = pos - qrank
    c = (
        jnp.zeros((nq + 1,), jnp.int64)
        .at[jnp.where(is_q, si.astype(jnp.int64), nq)]
        .set(c_at)[:nq]
    )
    rows = sp2d[jnp.clip(c - 1, 0, nb - 1)]
    rank_ge = jnp.sum((rows >= q[:, None]).astype(jnp.int64), axis=1)
    count_ge = jnp.where(c == 0, n, (nb - c) * blk + rank_ge)
    return n - count_ge


@partial(
    jax.jit,
    static_argnames=(
        "n_groups", "val_bits", "pack32", "dense", "with_minmax",
        "with_distinct", "null_ix", "shared",
    ),
)
def join_groupby_direct(
    fact_keys, fact_vals, dim_keys_sorted, dim_perm, n_groups: int,
    val_bits: int, pack32: bool, dense: bool = False,
    with_minmax: bool = False, with_distinct: bool = False, extra_vals=(),
    null_ix: int = -1, shared: bool = False,
):
    """The speed-of-light formulation of fact⋈dim + GROUP BY dim_row for
    unique dim keys: sort + prefix sum + 2G binary searches. No run-boundary
    detection, no rid cumsum, no N-sized gathers at all.

    Because the dim keys are known up front, the per-key ranges in the packed
    sorted array are found by searching the PACKED domain directly
    ([key << vb, (key+1) << vb)), and per-key sums are prefix-sum differences
    at those 2G positions:

        packed = key << vb | value        (int32 when ranges allow — the sort
                                           moves half the bytes)
        sp  = sort(packed)                — the ONLY O(N log N) step
        cs  = cumsum(sp & vmask)          — one streaming pass
        lo/hi = searchsorted(sp, dim<<vb / (dim+1)<<vb)
        sum = cs[hi-1] - cs[lo-1]; cnt = hi - lo   — G-sized
        scatter by dim_perm                         — G-sized

    Requires 0 <= value < 2^val_bits and key < 2^(31-val_bits) (pack32) or
    2^(63-val_bits). Keys not in dim are skipped by construction (their
    ranges are never queried). Misses still occupy sort slots — same as every
    other formulation.

    dense=True: the sorted dim keys are CONSECUTIVE integers (surrogate-key
    dimensions — catalog check: max-min+1 == n_groups). Then
    dhi[i] == dlo[i+1] exactly, so the 2G lo/hi queries collapse to G+1
    shared boundaries: half the merge-rank sort entries and HALF the
    latency-bound (·,128) rank-row gathers. This is EXACT with misses
    present: fact keys below dim-min or at/above dim-max+1 fall outside
    [dlo_0, dhi_last) and the boundary differences never count them;
    in-span misses cannot exist when the dim domain is dense.

    extra_vals: additional value columns carried as sort PAYLOADS (cheaper
    than gathering them by the sort permutation), summed per group via one
    (Q,128) payload-row gather at the SAME rank positions the packed value
    uses. Payloads are not packed, so negatives and wide ranges are fine;
    integer payloads accumulate int64, FLOAT/DOUBLE payloads accumulate
    float64 (their per-group sums are XLA-reduction-ordered, like every
    other float aggregation in the engine). Appended to the return tuple
    as per-group sums in the accumulation dtype.

    with_distinct: the packed sort places each group's EQUAL values
    adjacently, so a change flag (sp[i] != sp[i-1] — always 1 at group
    boundaries since keys live in the high bits) derived IN-program marks
    the first occurrence of every distinct (key, value); prefix sums of
    the flag and of flag*value at the same rank positions give per-group
    COUNT(DISTINCT v) and SUM(DISTINCT v) with no extra sort operand.
    Appended as (…, dcounts, dsums) right after the minmax outputs.

    null_ix >= 0 enables SENTINEL mode for a NULL-able packed column: the
    caller masks NULL values to vmask = 2^val_bits - 1 (choosing val_bits
    so every real value is < vmask), which sorts the NULL block to each
    range's TAIL, and passes the column's validity as extra_vals[null_ix].
    Sums subtract nullcnt·vmask, max reads hi-1-nullcnt, min is unchanged,
    and the distinct count/sum drop the one sentinel entry — NULL-able
    min/max/avg/DISTINCT all stay exact without a second pass."""
    if pack32:
        packed = (fact_keys.astype(jnp.int32) << val_bits) | fact_vals.astype(
            jnp.int32
        )
        dlo = (dim_keys_sorted.astype(jnp.int32) << val_bits)
        dhi = ((dim_keys_sorted.astype(jnp.int32) + 1) << val_bits)
    else:
        packed = (fact_keys << val_bits) | fact_vals
        dlo = dim_keys_sorted << val_bits
        dhi = (dim_keys_sorted + 1) << val_bits
    n = packed.shape[0]
    # pad to a block multiple with dtype-max (sorts last, outside every dim
    # range — caller contract: max key < 2^(31-vb)-1 / 2^(63-vb)-1)
    blk = 128
    pad = (-n) % blk
    if pad:
        packed = jnp.concatenate(
            [packed, jnp.full((pad,), jnp.iinfo(packed.dtype).max, packed.dtype)]
        )
    # payloads keep their caller-chosen width (int32 when the range allows:
    # the sort is HBM-bound, narrower payloads are proportionally cheaper);
    # all accumulation below is explicit int64
    evs = tuple(extra_vals)
    if pad:
        evs = tuple(
            jnp.concatenate([e, jnp.zeros((pad,), e.dtype)]) for e in evs
        )
    if evs:
        sorted_all = lax.sort((packed,) + evs, num_keys=1)
        sp, evs = sorted_all[0], sorted_all[1:]
    else:
        sp = lax.sort(packed)
    vmask = (1 << val_bits) - 1
    nb = sp.shape[0] // blk
    sp2d = sp.reshape(nb, blk)
    # prefix sums only at the 2G query positions: one block-reduce pass +
    # a tiny block prefix; the in-block parts come for free from the
    # merge-rank rows (no separate (2G, blk) prefix gathers — that stage
    # used to cost another ~2x the rank stage's HBM gather traffic)
    bs = jnp.sum((sp2d & vmask).astype(jnp.int64), axis=1)
    bp = jnp.cumsum(bs) - bs

    # rank queries: searchsorted costs log2(N) latency-bound gathers per
    # query; instead MERGE the sorted block minima with the sorted queries
    # via one tiny (nb+2G) sort, then rank AND value-prefix inside a single
    # gathered block per query
    g = dlo.shape[0]
    if dense or shared:
        # G+1 shared boundary queries replace the 2G lo/hi pairs — half
        # the rank-row gathers. Exact in two regimes: dense (consecutive
        # dim keys: dhi[i] == dlo[i+1] identically), or `shared` — the
        # caller asserts NO fact key falls strictly between consecutive
        # dim keys (FK-complete star joins: every fact key matches some
        # dim, the referential-integrity norm). Then range i ends exactly
        # where range i+1 begins and the boundary differences are the true
        # per-key sums/counts.
        queries = jnp.concatenate([dlo, dhi[-1:]])
        ranks, prefixes = _ranks_and_value_prefix(sp2d, queries, vmask, bp)
        lo, hi = ranks[:g], ranks[1:]
        sum_sorted = prefixes[1:] - prefixes[:g]
    else:
        queries = jnp.concatenate([dlo, dhi])
        ranks, prefixes = _ranks_and_value_prefix(sp2d, queries, vmask, bp)
        lo, hi = ranks[:g], ranks[g:]
        sum_sorted = prefixes[g:] - prefixes[:g]
    cnt_sorted = (hi - lo).astype(jnp.int64)
    derived = []
    if with_distinct:
        # first-occurrence flags of each distinct (key, value): group
        # boundaries always flag 1 (keys in the high bits), duplicates 0
        flag = jnp.concatenate(
            [jnp.ones((1,), jnp.int64), (sp[1:] != sp[:-1]).astype(jnp.int64)]
        )
        dval = flag * (sp & vmask).astype(jnp.int64)
        derived = [flag, dval]
    payloads = tuple(derived) + tuple(evs)
    es_list = []
    if payloads:
        # payload prefix sums at the SAME rank positions: per payload one
        # block-sum pass + one (Q,128) gathered row (Q = G+1 dense / 2G)
        lane = jnp.arange(blk, dtype=jnp.int32)
        b = ranks // blk
        rem = (ranks % blk).astype(jnp.int32)
        brow = jnp.clip(b, 0, nb - 1)
        under = lane[None, :] < rem[:, None]
        for e in payloads:
            acc_dt = (
                jnp.float64 if jnp.issubdtype(e.dtype, jnp.floating)
                else jnp.int64
            )
            e2d = e.reshape(nb, blk)
            ebs = jnp.sum(e2d, axis=1, dtype=acc_dt)
            ebp = jnp.concatenate([jnp.cumsum(ebs) - ebs, jnp.sum(ebs)[None]])
            part = jnp.sum(
                jnp.where(under, e2d[brow], jnp.zeros((), e2d.dtype)),
                axis=1, dtype=acc_dt,
            )
            pr = ebp[jnp.clip(b, 0, nb)] + part
            es_list.append(
                (pr[1:] - pr[:g]) if (dense or shared)
                else (pr[g:] - pr[:g])
            )
    nullcnt = None
    if null_ix >= 0:
        # sentinel mode: the caller masked NULL packed values to vmask
        # (real values < vmask), so they sort LAST within each group's
        # range. The per-group non-NULL count rides as payload null_ix;
        # every sentinel contribution is removed arithmetically.
        off = 2 if with_distinct else 0
        nullcnt = cnt_sorted - es_list[off + null_ix]
        sum_sorted = sum_sorted - nullcnt * vmask
        if with_distinct:
            has_null = (nullcnt > 0).astype(jnp.int64)
            es_list[0] = es_list[0] - has_null          # distinct count
            es_list[1] = es_list[1] - has_null * vmask  # distinct sum
    sums = jnp.zeros((n_groups,), jnp.int64).at[dim_perm].set(sum_sorted)
    counts = jnp.zeros((n_groups,), jnp.int64).at[dim_perm].set(cnt_sorted)
    extra_out = [
        jnp.zeros((n_groups,), es.dtype).at[dim_perm].set(es)
        for es in es_list
    ]
    if with_minmax:
        # the packed sort orders each key's range by VALUE, so per-group
        # min/max are the range's first/last elements: two G-sized random
        # gathers (group-count-sized access is the design budget). In
        # sentinel mode the NULL block sits at the range's tail, so max
        # reads position hi-1-nullcnt. Garbage for empty (or all-NULL)
        # ranges — callers mask those via count/validity-count.
        last = sp.shape[0] - 1
        hi_eff = hi - 1 if nullcnt is None else hi - 1 - nullcnt
        min_sorted = (sp[jnp.clip(lo, 0, last)] & vmask).astype(jnp.int64)
        max_sorted = (sp[jnp.clip(hi_eff, 0, last)] & vmask).astype(jnp.int64)
        mins = jnp.zeros((n_groups,), jnp.int64).at[dim_perm].set(min_sorted)
        maxs = jnp.zeros((n_groups,), jnp.int64).at[dim_perm].set(max_sorted)
        return (sums, counts, mins, maxs, *extra_out)
    return (sums, counts, *extra_out)


def f64_orderable(v):
    """IEEE-754 order-preserving bit transform: doubles (NaN excluded —
    NULLs never reach this) map to int64 such that signed integer order ==
    float order. Positives keep their bit pattern (sign clear => already
    ordered); negatives flip all magnitude bits and keep the sign
    (two's-complement: t = ~bits ^ minint64)."""
    tu = jax.lax.bitcast_convert_type(v.astype(jnp.float64), jnp.int64)
    m = jnp.int64(-(1 << 63))
    return jnp.where(tu < 0, (~tu) ^ m, tu)


def f64_from_orderable(t):
    """Inverse of f64_orderable."""
    m = jnp.int64(-(1 << 63))
    bits = jnp.where(t >= 0, t, ~(t ^ m))
    return jax.lax.bitcast_convert_type(bits, jnp.float64)


@partial(
    jax.jit, static_argnames=("n_groups", "pack32", "dense", "null_ix")
)
def join_groupby_minmax_tv(
    fact_keys, fact_vals_f64, tv, dim_keys_sorted, dim_perm, n_groups: int,
    pack32: bool, dense: bool = False, extra_vals=(), null_ix: int = -1,
):
    """fact⋈dim + GROUP BY key with MIN/MAX over a FLOAT/DOUBLE measure —
    the float sibling of join_groupby_direct's with_minmax mode.

    Floats cannot share the packed int operand with the key (a double needs
    all 64 bits to preserve order), so the measure rides as a SECOND sort
    operand carrying the order-preserving IEEE-754 bit transform
    (f64_orderable) under num_keys=2: within each key's range, rows are
    ordered by VALUE, so per-group min/max are the range's first/last
    elements — two G-sized gathers, inverse-transformed in-program. The
    measure's SUM rides as an f64 payload (payload prefix machinery), so
    sum/avg/count over the same expression stay on the one kernel.

    null_ix >= 0 is sentinel mode: the caller masks NULL tv entries to
    int64 max (they sort to each range's tail) and passes the column's
    validity as extra_vals[null_ix]; max then reads hi-1-nullcnt and the
    f64 value payload is NULL-masked to 0 by the caller.

    Output layout matches _routed_kernel's with_minmax shape:
    (sums_f64, counts, mins_f64, maxs_f64, extra sums…)."""
    if pack32:
        keys_op = fact_keys.astype(jnp.int32)
        dlo = dim_keys_sorted.astype(jnp.int32)
    else:
        keys_op = fact_keys
        dlo = dim_keys_sorted
    dhi = dlo + 1
    n = keys_op.shape[0]
    blk = 128
    pad = (-n) % blk
    # the sum payload keeps its caller-chosen dtype: f64 for true floats,
    # scaled int64 for k-dp decimals (exact integer accumulation)
    evs = (fact_vals_f64,) + tuple(extra_vals)
    if pad:
        keys_op = jnp.concatenate(
            [keys_op, jnp.full((pad,), jnp.iinfo(keys_op.dtype).max,
                               keys_op.dtype)]
        )
        tv = jnp.concatenate(
            [tv, jnp.full((pad,), jnp.iinfo(jnp.int64).max, jnp.int64)]
        )
        evs = tuple(
            jnp.concatenate([e, jnp.zeros((pad,), e.dtype)]) for e in evs
        )
    sorted_all = lax.sort((keys_op, tv) + evs, num_keys=2)
    sp, tvs, evs = sorted_all[0], sorted_all[1], sorted_all[2:]
    nb = sp.shape[0] // blk
    sp2d = sp.reshape(nb, blk)

    g = dlo.shape[0]
    if dense:
        queries = jnp.concatenate([dlo, dhi[-1:]])
        ranks = _sorted_ranks_left(sp2d, queries)
        lo, hi = ranks[:g], ranks[1:]
    else:
        ranks = _sorted_ranks_left(sp2d, jnp.concatenate([dlo, dhi]))
        lo, hi = ranks[:g], ranks[g:]
    cnt_sorted = (hi - lo).astype(jnp.int64)

    lane = jnp.arange(blk, dtype=jnp.int32)
    b = ranks // blk
    rem = (ranks % blk).astype(jnp.int32)
    brow = jnp.clip(b, 0, nb - 1)
    bcol = jnp.clip(b, 0, nb)
    under = lane[None, :] < rem[:, None]
    es_list = []
    for e in evs:
        acc_dt = (
            jnp.float64 if jnp.issubdtype(e.dtype, jnp.floating)
            else jnp.int64
        )
        e2d = e.reshape(nb, blk)
        ebs = jnp.sum(e2d, axis=1, dtype=acc_dt)
        ebp = jnp.concatenate([jnp.cumsum(ebs) - ebs, jnp.sum(ebs)[None]])
        part = jnp.sum(
            jnp.where(under, e2d[brow], jnp.zeros((), e2d.dtype)),
            axis=1, dtype=acc_dt,
        )
        pr = ebp[bcol] + part
        es_list.append((pr[1:] - pr[:g]) if dense else (pr[g:] - pr[:g]))
    sum_sorted = es_list[0]
    extra_sorted = es_list[1:]
    nullcnt = None
    if null_ix >= 0:
        nullcnt = cnt_sorted - extra_sorted[null_ix]
    last = tvs.shape[0] - 1
    hi_eff = hi - 1 if nullcnt is None else hi - 1 - nullcnt
    min_sorted = f64_from_orderable(tvs[jnp.clip(lo, 0, last)])
    max_sorted = f64_from_orderable(tvs[jnp.clip(hi_eff, 0, last)])
    sums = jnp.zeros((n_groups,), sum_sorted.dtype).at[dim_perm].set(
        sum_sorted
    )
    counts = jnp.zeros((n_groups,), jnp.int64).at[dim_perm].set(cnt_sorted)
    mins = jnp.zeros((n_groups,), jnp.float64).at[dim_perm].set(min_sorted)
    maxs = jnp.zeros((n_groups,), jnp.float64).at[dim_perm].set(max_sorted)
    extra_out = [
        jnp.zeros((n_groups,), es.dtype).at[dim_perm].set(es)
        for es in extra_sorted
    ]
    return (sums, counts, mins, maxs, *extra_out)


@partial(jax.jit, static_argnames=("n_groups", "rid_bits", "dense"))
def join_groupby_firstapp(
    fact_keys, fact_vals, dim_keys_sorted, dim_perm, n_groups: int,
    rid_bits: int, dense: bool = False,
):
    """fact⋈dim + GROUP BY key with the engine's first-appearance group
    ORDER recoverable — the ORDER-BY-free sibling of join_groupby_direct.

    The row index (not the value) is packed into the sort key:

        packed = key << rid_bits | rowid        (rowid < 2^rid_bits)
        sort (packed, value)                    -- value rides as a payload

    Per-key ranges come from the same merge-ranked boundary queries in the
    packed domain; per-key value sums from block prefix sums over the
    PAYLOAD array (one extra 128-wide gathered row per boundary); and the
    first-appearance rank of each key is simply `sp[lo] & rid_mask` — the
    smallest probe row index in the range, one G-sized gather. For unique
    dim keys the join emits ≤1 pair per probe row, so min probe rowid IS
    the reference's first-appearance position (hash_agg.rs:85-111).

    Requires key_eff_max < 2^(63-rid_bits). Values are NOT packed: any
    payload (negatives included) sums exactly for ints; FLOAT/DOUBLE
    payloads accumulate float64 (XLA-reduction-ordered, like every other
    float aggregation in the engine). fact_vals may be a single array or a
    TUPLE of value columns — every payload rides the one variadic sort
    and is summed from one (Q,128)
    payload-row gather at the shared rank positions.
    Returns (sums_0, counts, first_rowid, sums_1, ...) scattered to
    dim_perm order."""
    vals = fact_vals if isinstance(fact_vals, tuple) else (fact_vals,)
    n = fact_keys.shape[0]
    rid = jnp.arange(n, dtype=jnp.int64)
    packed = (fact_keys.astype(jnp.int64) << rid_bits) | rid
    blk = 128
    pad = (-n) % blk
    # payloads keep their caller-chosen width (int32 when ranges allow);
    # accumulation below is explicit int64
    if pad:
        packed = jnp.concatenate(
            [packed, jnp.full((pad,), jnp.iinfo(jnp.int64).max, jnp.int64)]
        )
        vals = tuple(
            jnp.concatenate([v, jnp.zeros((pad,), v.dtype)]) for v in vals
        )
    sorted_all = lax.sort((packed,) + vals, num_keys=1)
    sp, vsorted = sorted_all[0], sorted_all[1:]
    nb = sp.shape[0] // blk
    sp2d = sp.reshape(nb, blk)

    dlo = dim_keys_sorted.astype(jnp.int64) << rid_bits
    dhi = (dim_keys_sorted.astype(jnp.int64) + 1) << rid_bits
    g = dlo.shape[0]
    if dense:
        queries = jnp.concatenate([dlo, dhi[-1:]])
        ranks = _sorted_ranks_left(sp2d, queries)
        lo, hi = ranks[:g], ranks[1:]
    else:
        ranks = _sorted_ranks_left(sp2d, jnp.concatenate([dlo, dhi]))
        lo, hi = ranks[:g], ranks[g:]

    # per-payload prefix sums at the shared rank positions: one gathered
    # (Q,128) row per payload (Q = G+1 dense / 2G), not per endpoint
    lane = jnp.arange(blk, dtype=jnp.int32)
    b = ranks // blk
    rem = (ranks % blk).astype(jnp.int32)
    brow = jnp.clip(b, 0, nb - 1)
    bcol = jnp.clip(b, 0, nb)
    under = lane[None, :] < rem[:, None]
    sums_all = []
    for vs in vsorted:
        acc_dt = (
            jnp.float64 if jnp.issubdtype(vs.dtype, jnp.floating)
            else jnp.int64
        )
        v2d = vs.reshape(nb, blk)
        bs = jnp.sum(v2d, axis=1, dtype=acc_dt)
        bp = jnp.concatenate([jnp.cumsum(bs) - bs, jnp.sum(bs)[None]])
        part = jnp.sum(
            jnp.where(under, v2d[brow], jnp.zeros((), v2d.dtype)),
            axis=1, dtype=acc_dt,
        )
        pr = bp[bcol] + part
        sum_sorted = (pr[1:] - pr[:g]) if dense else (pr[g:] - pr[:g])
        sums_all.append(
            jnp.zeros((n_groups,), acc_dt).at[dim_perm].set(sum_sorted)
        )
    cnt_sorted = (hi - lo).astype(jnp.int64)
    rmask = (jnp.int64(1) << rid_bits) - 1
    first_sorted = sp[jnp.clip(lo, 0, sp.shape[0] - 1)] & rmask
    counts = jnp.zeros((n_groups,), jnp.int64).at[dim_perm].set(cnt_sorted)
    firsts = jnp.zeros((n_groups,), jnp.int64).at[dim_perm].set(first_sorted)
    return (sums_all[0], counts, firsts, *sums_all[1:])


def make_join_groupby(n_groups: int, strategy: str = "direct", slack: int = 2):
    """strategy 'direct' (sort + prefix sum + 2G binary searches — the
    headline path), 'sorted'/'sorted_packed' (run-boundary sort-merge), or
    'hash' (open addressing)."""
    if strategy == "direct":

        def fn_direct(
            fact_keys, fact_vals, dim_keys, val_bits: int = 7,
            pack32=None, key_max=None, val_max=None,
            dim_min=None, dim_max=None, fk_complete: bool = False,
        ):
            # pack32/val_bits contract: max(key) < 2^(31-val_bits) and
            # 0 <= value < 2^val_bits. When the caller passes host-known
            # table metadata (catalog min/max), the packing is AUTO-chosen:
            # a 32-bit sort moves half the bytes of a 64-bit one, so
            # dense-key tables get the narrow path by default.
            # dim_min/dim_max (catalog metadata for the UNIQUE dim keys)
            # additionally auto-select the dense boundary-sharing variant
            # when the dim domain is consecutive (surrogate keys):
            # max-min+1 == n_groups ⇒ half the rank queries.
            if val_max is not None:
                val_bits = max(int(val_max).bit_length(), 1)
            if pack32 is None:
                pack32 = (
                    key_max is not None
                    and int(key_max) < (1 << (31 - val_bits)) - 1
                )
            dense = (
                dim_min is not None
                and dim_max is not None
                and int(dim_max) - int(dim_min) + 1 == n_groups
            )
            order = jnp.argsort(dim_keys)
            dim_sorted = dim_keys[order]
            # fk_complete (caller-asserted referential integrity: every
            # fact key matches some dim key) lets NON-dense dims share
            # range boundaries too — half the latency-bound rank gathers
            return join_groupby_direct(
                fact_keys, fact_vals, dim_sorted, order, n_groups,
                val_bits, bool(pack32), dense,
                shared=bool(fk_complete) and not dense,
            )

        return fn_direct

    if strategy == "hash":
        capacity = next_pow2(max(2 * n_groups, 16))

        def fn_hash(fact_keys, fact_vals, dim_keys):
            return join_groupby_local(
                fact_keys, fact_vals, dim_keys, n_groups, capacity
            )

        return fn_hash

    run_capacity = next_pow2(max(slack * n_groups, 16))

    if strategy == "sorted_packed":

        def fn_packed(fact_keys, fact_vals, dim_keys, val_bits: int = 7):
            order = jnp.argsort(dim_keys)
            dim_sorted = dim_keys[order]
            sums, counts, _ = join_groupby_sorted_packed(
                fact_keys, fact_vals, dim_sorted, order, n_groups,
                run_capacity, val_bits,
            )
            return sums, counts

        return fn_packed

    def fn(fact_keys, fact_vals, dim_keys):
        order = jnp.argsort(dim_keys)
        dim_sorted = dim_keys[order]
        sums, counts, _ = join_groupby_sorted(
            fact_keys, fact_vals, dim_sorted, order, n_groups, run_capacity
        )
        return sums, counts

    return fn
