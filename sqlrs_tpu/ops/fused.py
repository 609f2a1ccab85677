"""Single-dispatch batched array utilities.

An eager `x[idx]` costs ~8 dispatched programs (index normalization,
broadcasts, gather, dtype casts are separate eager ops), so a 10-column
DeviceBatch.take cost ~160 dispatches (counted with
benchmarks/dispatch_count.py). These helpers batch whole-batch operations
into ONE jitted program each.

jit caches key on (pytree structure, shapes, dtypes, static args), so the
generic tuple signatures compile once per batch layout and hit thereafter.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@jax.jit
def gather_arrays(arrays, idx):
    """tuple(a[idx] for a in arrays) in one dispatch."""
    return tuple(a[idx] for a in arrays)


@jax.jit
def gather_arrays_masked(arrays, valids, idx, live):
    """Gather (data, valid) pairs and AND a liveness mask into the
    validity — the unmatched/nullable join emission shape."""
    d = tuple(a[idx] for a in arrays)
    v = tuple(a[idx] & live for a in valids)
    return d, v


@partial(jax.jit, static_argnames=("start", "n"))
def slice_arrays(arrays, start: int, n: int):
    """tuple(a[start:start+n] for a in arrays) in one dispatch."""
    return tuple(jax.lax.dynamic_slice_in_dim(a, start, n) for a in arrays)


@jax.jit
def concat_arrays(parts):
    """parts: list of tuples of arrays (same structure). Concatenates
    position-wise in one dispatch."""
    return tuple(jnp.concatenate(cols) for cols in zip(*parts))


@jax.jit
def mask_count(keep_data, keep_valid):
    """Surviving-row count of a selection mask in ONE dispatch (eager
    `jnp.sum(jnp.logical_and(...))` costs two)."""
    return jnp.sum(jnp.logical_and(keep_data, keep_valid))


@partial(jax.jit, static_argnames=("count",))
def compact_gather_arrays(keep_data, keep_valid, arrays, count: int):
    """Flag-sort compaction AND gather of every array in ONE program:
    the rows where `keep` holds, in original order, sliced to `count`
    (separate compact_indices + gather programs cost an extra dispatch)."""
    drop = jnp.logical_not(jnp.logical_and(keep_data, keep_valid))
    n = drop.shape[0]
    _, perm = jax.lax.sort(
        (drop.astype(jnp.int32), jnp.arange(n, dtype=jnp.int64)),
        num_keys=1,
        is_stable=True,
    )
    idx = perm[:count]
    return tuple(a[idx] for a in arrays)
