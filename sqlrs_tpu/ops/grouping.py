"""Group-id assignment and segmented aggregation kernels.

The device replacement for the reference's row-at-a-time HashAggExecutor
(reference src/executor/aggregate/hash_agg.rs:32-150: ahash row-hash →
HashMap → per-group take): here rows are lexsorted by the encoded group keys,
group boundaries fall out of an adjacent-difference, and aggregates are
segment reductions — O(n log n) of fully vectorized XLA instead of a host
hash map. NULL keys form their own group (SQL GROUP BY semantics), and group
output order is first-appearance order, which the reference preserves via its
insertion-ordered map (reference hash_agg.rs:85-111) and the slt suite
depends on.

ops/hash_table.py holds a plain-XLA open-addressing hash table kept as a
comparison baseline (its insert loop is scatter-bound); the sort-run
formulations here and in ops/grouped_agg.py are the production paths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sqlrs_tpu.data import Column
from sqlrs_tpu.ops.sort import orderable_key


def group_ids(key_cols: list[Column]) -> tuple[jnp.ndarray, int]:
    """Returns (gid, n_groups): gid[i] is the group of row i, numbered in
    first-appearance order. One host sync for n_groups (pipeline breaker)."""
    n = len(key_cols[0])
    if n == 0:
        return jnp.zeros(0, dtype=jnp.int64), 0
    keys = [orderable_key(c) for c in key_cols]

    idx = jnp.arange(n, dtype=jnp.int64)
    for key, valid in reversed(keys):
        # NULLs group together: order by (valid, key-with-null-slot)
        k = jnp.where(valid, key, 0)[idx]
        v = valid[idx]
        order = jnp.argsort(k, stable=True)
        idx = idx[order]
        v = v[order]
        order2 = jnp.argsort(v.astype(jnp.int32), stable=True)
        idx = idx[order2]

    # boundary: any key column differs (validity-aware) vs previous sorted row
    boundary = jnp.zeros(n, dtype=jnp.bool_)
    boundary = boundary.at[0].set(True)
    for key, valid in keys:
        ks, vs = key[idx], valid[idx]
        diff = jnp.logical_or(
            vs[1:] != vs[:-1],
            jnp.logical_and(vs[1:], ks[1:] != ks[:-1]),
        )
        boundary = boundary.at[1:].set(jnp.logical_or(boundary[1:], diff))

    gid_sorted = jnp.cumsum(boundary.astype(jnp.int64)) - 1
    gid = jnp.zeros(n, dtype=jnp.int64).at[idx].set(gid_sorted)

    n_groups = int(gid_sorted[-1]) + 1  # host sync

    # renumber groups by first appearance
    first_row = jax.ops.segment_min(
        jnp.arange(n, dtype=jnp.int64), gid, num_segments=n_groups
    )
    # inverse permutation by scatter: argsort(argsort(.)) trips XLA's GPU
    # permutation-sort simplifier on int64 indices
    order = jnp.argsort(first_row)
    rank = jnp.zeros_like(order).at[order].set(
        jnp.arange(n_groups, dtype=order.dtype)
    )
    gid = rank[gid]
    return gid, n_groups


# ---- segmented aggregate kernels -------------------------------------------


def seg_count_valid(valid, gid, n_groups):
    return jax.ops.segment_sum(valid.astype(jnp.int64), gid, num_segments=n_groups)


def seg_sum(data, valid, gid, n_groups):
    x = jnp.where(valid, data, jnp.zeros_like(data))
    return jax.ops.segment_sum(x, gid, num_segments=n_groups)


def seg_min(data, valid, gid, n_groups, big):
    x = jnp.where(valid, data, jnp.full_like(data, big))
    return jax.ops.segment_min(x, gid, num_segments=n_groups)


def seg_max(data, valid, gid, n_groups, small):
    x = jnp.where(valid, data, jnp.full_like(data, small))
    return jax.ops.segment_max(x, gid, num_segments=n_groups)


def seg_argmin_by(order_key, data_valid, gid, n_groups):
    """Row index minimizing order_key per group, ignoring invalid rows.
    Used for MIN/MAX on dictionary-encoded strings (the winning row's code is
    gathered afterwards). Exact two-pass formulation: min key per group, then
    min row index among rows attaining it."""
    n = order_key.shape[0]
    big = jnp.iinfo(jnp.int64).max
    k = jnp.where(data_valid, order_key.astype(jnp.int64), big)
    m = jax.ops.segment_min(k, gid, num_segments=n_groups)
    attains = jnp.logical_and(data_valid, k == m[gid])
    rows = jnp.where(attains, jnp.arange(n, dtype=jnp.int64), big)
    return jax.ops.segment_min(rows, gid, num_segments=n_groups)


def dedup_mask(key_cols: list[Column], gid) -> jnp.ndarray:
    """True for the first occurrence of each (group, value) pair — implements
    DISTINCT aggregates (sum/count DISTINCT, reference
    src/executor/aggregate/sum.rs:99, count.rs:31). NULL values are excluded
    entirely (SQL ignores NULLs in aggregates)."""
    n = len(key_cols[0])
    if n == 0:
        return jnp.zeros(0, dtype=jnp.bool_)
    # composite: (gid, valid_0, key_0, valid_1, key_1, ...) so NULLs cannot
    # shadow valid values that share the null-slot encoding
    keys = [(gid, jnp.ones(n, dtype=jnp.bool_))]
    for c in key_cols:
        key, valid = orderable_key(c)
        keys.append((valid.astype(jnp.int64), jnp.ones(n, dtype=jnp.bool_)))
        keys.append((key, valid))
    idx = jnp.arange(n, dtype=jnp.int64)
    for key, valid in reversed(keys):
        k = jnp.where(valid, key, 0)[idx]
        order = jnp.argsort(k, stable=True)
        idx = idx[order]
    diff_any = jnp.zeros(max(n - 1, 0), dtype=jnp.bool_)
    for key, valid in keys:
        ks = jnp.where(valid, key, 0)[idx]
        diff_any = jnp.logical_or(diff_any, ks[1:] != ks[:-1])
    first = jnp.concatenate([jnp.ones(1, dtype=jnp.bool_), diff_any])
    mask = jnp.zeros(n, dtype=jnp.bool_).at[idx].set(first)
    # drop NULL values entirely
    all_valid = jnp.ones(n, dtype=jnp.bool_)
    for c in key_cols:
        all_valid = jnp.logical_and(all_valid, c.valid)
    return jnp.logical_and(mask, all_valid)
