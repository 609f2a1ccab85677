"""Equi-join index-pair generation.

Replaces the reference's build/probe HashMap<u64, Vec<row>> hash join
(reference src/executor/join/hash_join.rs:146-292) with key-id assignment +
sorted search: both sides' key columns are mapped to shared integer key ids
(exact equality — unlike the reference, which matches on 64-bit hash only,
TODO at hash_join.rs:221-224), the build side is sorted by key id, and each
probe row finds its match run via merge-ranked range queries. Match emission
order equals the reference's: probe (right) row outer, build (left) rows in
insertion order.

NULL join keys never match (SQL equality semantics).

Device-resident end to end: TWO jit programs split at the single
pair-count host sync —

  phase A: one variadic sort of the concatenated key columns with the row
  position as the final sort key (build rows precede probe rows within each
  key, in insertion order); prefix sums/maxes then hand every probe row its
  match range — no searches, no N-sized gathers;
  phase B (static total): expands ranges into (left_row, right_row) pairs
  with jnp.repeat(total_repeat_length=...).

No N-sized host round-trips (the old formulation shipped every key id
through numpy — hundreds of MB per join).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sqlrs_tpu.data import Column
from sqlrs_tpu.ops.sort import orderable_key

@partial(jax.jit, static_argnames=("num_keys",))
def _pairs_phase_a(l_ops, r_ops, num_keys: int, l_alive=None, r_alive=None):
    """l_ops/r_ops: per key column (valid, encoded key) per side. The sides
    are concatenated INSIDE the program (eager concats cost a dispatch
    each). Returns per-probe-row (starts, counts) into the
    build side sorted by key id, plus the stably sorted build row order and
    the total pair count. Optional l_alive/r_alive row masks (fused Filter
    children) AND into every key's validity here instead of costing an
    eager dispatch per key column.

    Pure streaming formulation: ONE combined sort with the row position as
    the final key (so within each key run, build rows precede probe rows, in
    insertion order), then prefix sums/maxes give every probe row its match
    range — no per-query searches, no N-sized gathers (probe counts via
    range queries cost a 128-wide gathered row per probe; with N probes
    that was gigabytes of gather traffic)."""
    nl = l_ops[0].shape[0]
    nr = r_ops[0].shape[0]
    n = nl + nr
    ops: list = []
    def _and_alive(v, alive):
        if alive is None:
            return v
        if isinstance(alive, tuple):  # raw (keep_data, keep_valid) pair
            return jnp.logical_and(v, jnp.logical_and(alive[0], alive[1]))
        return jnp.logical_and(v, alive)

    for i in range(0, num_keys, 2):
        lv = _and_alive(l_ops[i], l_alive)
        rv = _and_alive(r_ops[i], r_alive)
        valid = jnp.concatenate(
            [lv.astype(jnp.int32), rv.astype(jnp.int32)]
        )
        key = jnp.concatenate([l_ops[i + 1], r_ops[i + 1]])
        ops.append(valid)
        ops.append(jnp.where(valid > 0, key, 0))
    ops.append(jnp.arange(n, dtype=jnp.int64))  # position: the FINAL sort key
    out = lax.sort(tuple(ops), num_keys=num_keys + 1)
    pos = out[num_keys]
    boundary = jnp.zeros(n, dtype=jnp.bool_).at[0].set(True)
    for arr in out[:num_keys]:
        d = arr[1:] != arr[:-1]
        boundary = boundary.at[1:].set(jnp.logical_or(boundary[1:], d))
    allvalid = jnp.ones(n, dtype=jnp.bool_)
    for arr in out[0:num_keys:2]:
        allvalid = allvalid & (arr > 0)

    is_left = pos < nl
    is_lv = is_left & allvalid  # valid build rows
    cum_left = jnp.cumsum(is_lv.astype(jnp.int64))  # inclusive prefix
    # valid-build count BEFORE each run start, broadcast through the run:
    # run starts carry a non-decreasing prefix, so a running max propagates
    cl0 = lax.cummax(
        jnp.where(boundary, cum_left - is_lv.astype(jnp.int64), 0)
    )
    # build rows precede probe rows within a run (position is a sort key),
    # so at any probe row the run's build rows are fully counted
    counts_sorted = cum_left - cl0
    is_rv = jnp.logical_not(is_left) & allvalid
    packed = jnp.where(is_rv, (cl0 << 31) | counts_sorted, 0)
    # emit the packed ranges in probe order with a 2-operand sort on the
    # probe position instead of an N-sized scatter (build rows push to the
    # tail; every probe row appears exactly once, invalid ones carrying
    # packed=0)
    probe_pos = jnp.where(is_left, jnp.int64(nr), pos - nl)
    _, pbp = lax.sort((probe_pos, packed), num_keys=1)
    packed_by_probe = pbp[:nr]
    starts = packed_by_probe >> 31
    counts = packed_by_probe & ((1 << 31) - 1)
    # build-side order: valid build rows first, already in (key, insertion)
    # order — one cheap 2-operand stable extraction sort
    _, order = lax.sort(
        (jnp.logical_not(is_lv).astype(jnp.int32), pos),
        num_keys=1,
        is_stable=True,
    )
    return starts, counts, order[:nl], jnp.sum(counts)


def _expand_body(starts, counts, order, total: int):
    """Trace-time pair expansion shared by the phase-B jits."""
    nr = counts.shape[0]
    r_idx = jnp.repeat(
        jnp.arange(nr, dtype=jnp.int64), counts, total_repeat_length=total
    )
    base = jnp.repeat(
        jnp.cumsum(counts) - counts, counts, total_repeat_length=total
    )
    pos = jnp.arange(total, dtype=jnp.int64) - base + jnp.repeat(
        starts, counts, total_repeat_length=total
    )
    l_idx = order[jnp.clip(pos, 0, order.shape[0] - 1)]
    return l_idx, r_idx


@partial(jax.jit, static_argnames=("total",))
def _pairs_phase_b(starts, counts, order, total: int):
    return _expand_body(starts, counts, order, total)


@partial(jax.jit, static_argnames=("total",))
def _expand_gather_jit(starts, counts, order, l_datas, l_valids, r_datas,
                       r_valids, total: int):
    l_idx, r_idx = _expand_body(starts, counts, order, total)
    return (
        tuple(a[l_idx] for a in l_datas),
        tuple(a[l_idx] for a in l_valids),
        tuple(a[r_idx] for a in r_datas),
        tuple(a[r_idx] for a in r_valids),
    )


def expand_gather_pairs(pr, left_cols, right_cols):
    """Phase B fused with the output-column gather: expand a pair_ranges
    result AND materialize every output column in ONE compiled program
    (separate expand + gather programs cost an extra dispatch per join).
    Inner-join fast path; callers that
    need the raw index pairs (residual filters, outer joins) use
    expand_pairs."""
    return _expand_gather_jit(
        pr[0], pr[1], pr[2],
        tuple(c.data for c in left_cols),
        tuple(c.valid for c in left_cols),
        tuple(c.data for c in right_cols),
        tuple(c.valid for c in right_cols),
        total=pr[3],
    )


@jax.jit
def _pack2_stats(lk1, lv1, lk2, lv2, rk1, rv1, rk2, rv2):
    """min/max of each key column over VALID rows of BOTH sides — drives
    the 2-key -> one-operand packing below (one program + one fetch)."""
    big = jnp.iinfo(jnp.int64).max

    def mm(lk, lv, rk, rv):
        k = jnp.concatenate([lk.astype(jnp.int64), rk.astype(jnp.int64)])
        v = jnp.concatenate([lv, rv])
        return (
            jnp.min(jnp.where(v, k, big)),
            jnp.max(jnp.where(v, k, -big)),
        )

    a, b = mm(lk1, lv1, rk1, rv1)
    c, d = mm(lk2, lv2, rk2, rv2)
    return jnp.stack([a, b, c, d])


@partial(jax.jit, static_argnames=("b2",))
def _pack2_apply(v1, k1, v2, k2, min1, min2, b2: int):
    """(valid, packed) for one side: both keys rebased and packed into one
    int64 — the 2-key comparator becomes a 1-key one."""
    v = jnp.logical_and(v1, v2)
    p = ((k1.astype(jnp.int64) - min1) << b2) | (
        k2.astype(jnp.int64) - min2
    )
    return v, jnp.where(v, p, jnp.int64(0))


_PACK2_MIN_ROWS = 1 << 21


def _try_pack2(l_ops, r_ops):
    """2-key mark joins: fold both key columns into ONE int64 sort operand
    when the ranges fit (one stats program + one small fetch + one pack
    program per side). Multi-key comparators cost XLA sorts more compile
    and run time than one packed key; Q21's (orderkey, suppkey) equal-pair
    count is the shape this serves. Returns (l_ops2, r_ops2) or None."""
    for o in (l_ops[1], l_ops[3], r_ops[1], r_ops[3]):
        if jnp.issubdtype(o.dtype, jnp.floating):
            return None
    m = np.asarray(_pack2_stats(
        l_ops[1], l_ops[0], l_ops[3], l_ops[2],
        r_ops[1], r_ops[0], r_ops[3], r_ops[2],
    ))
    if m[0] > m[1] or m[2] > m[3]:
        return None  # a side with no valid rows: leave unpacked
    span1 = int(m[1]) - int(m[0]) + 1
    span2 = int(m[3]) - int(m[2]) + 1
    b2 = max(span2.bit_length(), 1)
    if span1.bit_length() + b2 > 62:
        return None
    min1, min2 = jnp.int64(int(m[0])), jnp.int64(int(m[2]))
    lv, lp = _pack2_apply(l_ops[0], l_ops[1], l_ops[2], l_ops[3],
                          min1, min2, b2)
    rv, rp = _pack2_apply(r_ops[0], r_ops[1], r_ops[2], r_ops[3],
                          min1, min2, b2)
    return [lv, lp], [rv, rp]


def match_counts(build_keys: list[Column], probe_keys: list[Column],
                 build_alive=None):
    """Per-probe-row count of matching build rows — the mark-join primitive
    (semi/anti/EXISTS) — with NO pair expansion and NO host sync: just
    _pairs_phase_a's merged sort. NULL keys on either side never match;
    build_alive optionally masks build rows in-program.

    Replaces pair expansion + scatter for semi/anti joins (reference
    hash_join.rs:207-250 emits pairs row-at-a-time; a 6M-row TPC-H Q21
    self-mark-join would expand ~40M pairs just to test emptiness).

    Two-key marks at scale pack both keys into one operand (_try_pack2):
    packed equality == pairwise equality for in-range keys, and NULLs
    (either column) stay non-matching via the ANDed validity."""
    nl = len(build_keys[0])
    nr = len(probe_keys[0])
    if nl == 0 or nr == 0:
        return jnp.zeros(nr, dtype=jnp.int64)
    l_ops: list = []
    r_ops: list = []
    for l, r in zip(build_keys, probe_keys):
        lk, lv = orderable_key(l)
        rk, rv = orderable_key(r)
        l_ops += [lv, lk]
        r_ops += [rv, rk.astype(lk.dtype)]
    if len(build_keys) == 2 and nl + nr >= _PACK2_MIN_ROWS:
        packed = _try_pack2(l_ops, r_ops)
        if packed is not None:
            l_ops, r_ops = packed
    _, counts, _, _ = _pairs_phase_a(
        tuple(l_ops), tuple(r_ops), len(l_ops), build_alive, None
    )
    return counts


def pair_ranges(left_keys: list[Column], right_keys: list[Column],
                l_alive=None, r_alive=None):
    """Phase A of pair emission: per-probe-row match ranges.
    Returns (starts, counts, order, total) — total is a host int (the single
    pipeline-breaker sync) — or None when either side is empty. Callers that
    schedule their own expansion (bounded-memory chunked residual filtering,
    exec/executor._residual_pairs_chunked) start here. l_alive/r_alive are
    optional fused-Filter row masks ANDed into key validity in-program."""
    nl = len(left_keys[0])
    nr = len(right_keys[0])
    if nl == 0 or nr == 0:
        return None
    l_ops: list = []
    r_ops: list = []
    for l, r in zip(left_keys, right_keys):
        lk, lv = orderable_key(l)
        rk, rv = orderable_key(r)
        l_ops += [lv, lk]
        r_ops += [rv, rk.astype(lk.dtype)]
    num_keys = len(l_ops)
    starts, counts, order, total = _pairs_phase_a(
        tuple(l_ops), tuple(r_ops), num_keys, l_alive, r_alive
    )
    return starts, counts, order, int(total)


def expand_pairs(starts, counts, order, total: int):
    """Phase B: materialize the (left_row, right_row) pair arrays for a
    pair_ranges result, probe-major order."""
    if total == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    return _pairs_phase_b(starts, counts, order, total)


def equi_join_pairs(
    left_keys: list[Column], right_keys: list[Column]
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """All matching (left_row, right_row) pairs, ordered by (right_row,
    left insertion order) to reproduce the reference's probe-order emission
    (hash_join.rs:207-250). ONE host sync (the pair count)."""
    pr = pair_ranges(left_keys, right_keys)
    if pr is None:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    return expand_pairs(*pr)
