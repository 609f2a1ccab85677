"""Open-addressing hash table kernels: grouped aggregation and equi-join.

COMPARISON BASELINE, not the production path: the sort-run formulations
in ops/pipelines.py / ops/grouped_agg.py are; whether a hash path wins on
the H100 is not measured yet (ROADMAP 3.2). next_pow2/build_join_table
remain used by other modules. A plain-XLA design for the two headline
operators (reference's row-at-a-time HashAggExecutor,
src/executor/aggregate/hash_agg.rs:32-150, and HashJoinExecutor,
src/executor/join/hash_join.rs:146-323), redesigned for whole-batch device
execution:

- one fused jit program per operator — all probing/aggregation is device-side
  XLA (gathers/scatters/segment ops), no per-row host work;
- static shapes: table capacity is a power of two sized ahead of time
  (2x headroom over the expected distinct-key count);
- multiplicative hashing (Fibonacci/splitmix-style mixing) — deterministic
  across hosts, so the same function drives distributed partitioning
  (the reference's ahash with fixed seeds plays this role,
  src/executor/hash_utils.rs:161-249);
- insertion resolves collisions with linear probing driven by a
  `lax.while_loop` of scatter-claim rounds: every round, each still-homeless
  row tries to claim its current slot with a min-scatter; losers and
  key-mismatches advance to the next slot. Each round settles at least one
  contender per slot, so the loop terminates in O(max chain) rounds while
  every row is processed in parallel;
- probing (join) gathers the chain with the same stride until hit/empty —
  and compares FULL KEYS, not hashes: the reference matches on the 64-bit
  hash only (TODO at hash_join.rs:221-224); this implementation is exact.

NULL keys are pre-filtered by the callers (SQL semantics: NULL never
matches / forms its own group via a reserved key).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

EMPTY = jnp.int64(-(2**63))  # reserved: no live key may equal EMPTY


def _mix64(x):
    """splitmix64 finalizer — deterministic, well-distributed, vectorizes to
    a handful of VPU ops."""
    x = x.astype(jnp.uint64)
    x = (x ^ (x >> 30)) * jnp.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> 27)) * jnp.uint64(0x94D049BB133111EB)
    x = x ^ (x >> 31)
    return x


def hash_keys(keys, capacity: int):
    """Slot index in [0, capacity); capacity must be a power of two."""
    return (_mix64(keys) & jnp.uint64(capacity - 1)).astype(jnp.int64)


def next_pow2(n: int) -> int:
    c = 1
    while c < n:
        c *= 2
    return c


# ---- table build -----------------------------------------------------------


@partial(jax.jit, static_argnames=("capacity",))
def build_table(keys, capacity: int):
    """Insert distinct keys into an open-addressing table.

    Returns (table_keys[capacity], slot_of_row[n]): table_keys holds the key
    occupying each slot (EMPTY otherwise); slot_of_row[i] is the slot that
    row i's key lives in. Duplicate keys share a slot.
    """
    cap_mask = jnp.int64(capacity - 1)
    # derive fresh carries from `keys` so they inherit any shard_map-varying
    # mesh axes (a fresh jnp.zeros would be "unvarying" and while_loop would
    # reject the carry type mismatch)
    vary = jnp.sum(keys) * 0
    table = jnp.full((capacity,), EMPTY, dtype=jnp.int64) + vary
    slot = hash_keys(keys, capacity)
    done = keys != keys  # all-False, varying like keys

    def cond(state):
        _, _, done, _ = state
        return ~jnp.all(done)

    def body(state):
        table, slot, done, it = state
        occupant = table[slot]
        # my key already in this slot -> settled
        hit = occupant == keys
        # empty slot -> try to claim it (min over contending keys this round)
        want = (occupant == EMPTY) & ~done & ~hit
        claim_key = jnp.where(want, keys, EMPTY)  # EMPTY = int64 min: use max-scatter
        table = table.at[slot].max(jnp.where(want, claim_key, EMPTY))
        occupant2 = table[slot]
        settled = occupant2 == keys
        done2 = done | hit | settled
        # everyone else probes the next slot
        slot2 = jnp.where(done2, slot, (slot + 1) & cap_mask)
        return table, slot2, done2, it + 1

    table, slot, done, _ = jax.lax.while_loop(
        cond, body, (table, slot, done, jnp.int64(0))
    )
    return table, slot


# ---- grouped aggregation ------------------------------------------------------


@partial(jax.jit, static_argnames=("capacity",))
def hash_group_aggregate(keys, values, capacity: int):
    """GROUP BY keys: per-group sum / count / min / max in ONE fused program.

    Returns (table_keys, sums, counts, mins, maxs) each of length `capacity`;
    slots with table_keys == EMPTY are unused. This is the compiled
    counterpart of the correctness-path _aggregate executor.
    """
    table, slot = build_table(keys, capacity)
    ones = jnp.ones_like(values)
    sums = jnp.zeros((capacity,), dtype=values.dtype).at[slot].add(values)
    counts = jnp.zeros((capacity,), dtype=jnp.int64).at[slot].add(ones.astype(jnp.int64))
    big = jnp.iinfo(values.dtype).max if jnp.issubdtype(values.dtype, jnp.integer) else jnp.inf
    mins = jnp.full((capacity,), big, dtype=values.dtype).at[slot].min(values)
    maxs = jnp.full((capacity,), -big if big != jnp.inf else -jnp.inf, dtype=values.dtype).at[slot].max(values)
    return table, sums, counts, mins, maxs


# ---- equi join -------------------------------------------------------------------


@partial(jax.jit, static_argnames=("capacity",))
def build_join_table(build_keys, capacity: int):
    """Build-side chain layout for a duplicate-preserving join probe.

    Rows are bucketed by key slot: (table_keys, bucket_start, bucket_count,
    row_order) where row_order holds build-row indices grouped by slot
    (insertion order preserved within a key via stable sort), and
    bucket_start/count delimit each slot's run.
    """
    table, slot = build_table(build_keys, capacity)
    counts = jnp.zeros((capacity,), dtype=jnp.int64).at[slot].add(1)
    start = jnp.cumsum(counts) - counts
    order = jnp.argsort(slot, stable=True)  # rows grouped by slot, stable
    return table, start, counts, order


@partial(jax.jit, static_argnames=("capacity",))
def probe_counts(table, probe_keys, bucket_counts, capacity: int):
    """For each probe row: its build-side slot (or -1) and match count.
    Linear-probe chain walk with full-key equality."""
    cap_mask = jnp.int64(capacity - 1)
    slot = hash_keys(probe_keys, capacity)
    found = slot * 0 - 1  # varying like probe_keys
    active = probe_keys == probe_keys  # all-True, varying
    # the table may come from an unvarying (replicated) side
    table = table + jnp.sum(slot) * 0

    def cond(state):
        _, _, active = state
        return jnp.any(active)

    def body(state):
        slot, found, active = state
        occupant = table[slot]
        hit = active & (occupant == probe_keys)
        miss = active & (occupant == EMPTY)
        found = jnp.where(hit, slot, found)
        active2 = active & ~hit & ~miss
        slot2 = jnp.where(active2, (slot + 1) & cap_mask, slot)
        return slot2, found, active2

    _, found, _ = jax.lax.while_loop(cond, body, (slot, found, active))
    counts = jnp.where(found >= 0, bucket_counts[jnp.maximum(found, 0)], 0)
    return found, counts


@partial(jax.jit, static_argnames=("out_capacity",))
def expand_pairs(found_slot, counts, bucket_start, row_order, out_capacity: int):
    """Materialize (build_row, probe_row) index pairs, ordered by probe row
    (the reference's emission order). Output is padded to `out_capacity`
    (static); `total` gives the live prefix length.

    Fully on device: prefix-sum offsets + a searchsorted-based expansion.
    """
    n_probe = counts.shape[0]
    offsets = jnp.cumsum(counts) - counts  # start of each probe row's run
    total = offsets[-1] + counts[-1] if n_probe > 0 else jnp.int64(0)
    pos = jnp.arange(out_capacity, dtype=jnp.int64)
    # which probe row does output position p belong to?
    probe_row = jnp.searchsorted(offsets + counts, pos, side="right")
    probe_row = jnp.minimum(probe_row, n_probe - 1)
    within = pos - offsets[probe_row]
    slot = jnp.maximum(found_slot[probe_row], 0)
    build_pos = bucket_start[slot] + within
    build_row = row_order[jnp.clip(build_pos, 0, row_order.shape[0] - 1)]
    live = pos < total
    return (
        jnp.where(live, build_row, 0),
        jnp.where(live, probe_row, 0),
        live,
        total,
    )


def hash_join_pairs(build_keys, probe_keys, out_capacity: int | None = None):
    """End-to-end compiled inner-join index-pair generation for int64 keys.

    Host syncs only for `total` when out_capacity is not given (capacity
    bucketing keeps recompiles bounded: capacity is rounded to a power of
    two).
    """
    capacity = next_pow2(max(2 * build_keys.shape[0], 16))
    table, start, bcounts, order = build_join_table(build_keys, capacity)
    found, counts = probe_counts(table, probe_keys, bcounts, capacity)
    if out_capacity is None:
        total = int(jnp.sum(counts))  # pipeline-breaker sync
        out_capacity = next_pow2(max(total, 16))
    build_row, probe_row, live, total = expand_pairs(
        found, counts, start, order, out_capacity
    )
    return build_row, probe_row, live, total
