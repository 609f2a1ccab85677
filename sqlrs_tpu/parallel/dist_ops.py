"""Distributed operators: shuffle, join + group-by, sort over a device mesh.

The DB-domain parallelism the reference lacks entirely (SURVEY.md §2.3),
built as shard_map SPMD programs so XLA schedules the collectives:

- partition_shuffle: repartition rows by key hash via `lax.all_to_all` with
  fixed per-destination bucket capacity (static shapes; padding carries a
  validity mask) — the exchange operator / "TP all-to-all" analogue.
- dist_join_groupby_broadcast: fact⋈dim join + group-by-dim-row in ONE pass:
  the dim side is replicated, each shard probes its fact rows against the
  shared table and segment-sums partial aggregates by dim row id, and a
  single psum combines partials. No key-based shuffle of the fact table ⇒
  immune to zipf key skew (the north star's skew case), and the collective
  payload is O(G), not O(N).
- dist_join_groupby_shuffle: the general large-large path — both sides
  repartitioned by key hash, local hash join + partial agg per shard.
- dist_sort: sample sort — global splitters from a gathered sample, bucket
  all-to-all, local sort per shard.

All functions take (mesh, sharded arrays) and are jit-compilable end to end.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from sqlrs_tpu.ops.hash_table import hash_keys
from sqlrs_tpu.parallel.mesh import spmd


def _overflow_scalar(x) -> int:
    """Max of a per-shard overflow counter that may span processes. The
    counters are psum'd inside the kernels, so every shard holds the global
    value — reading the process-LOCAL addressable shards is exact and needs
    no collective (np.asarray on a cross-process array raises)."""
    try:
        return int(np.max(np.asarray(x)))
    except RuntimeError:
        return int(
            max(np.max(np.asarray(s.data)) for s in x.addressable_shards)
        )


def _axis_size(mesh, axis):
    return mesh.shape[axis]


# ---- shard-local sorted join+group-by core -----------------------------------
#
# All four distributed join+group-by strategies share one shard-local
# compute: fact rows joined to (a chunk of) the dim table, partial sums and
# counts by dim row. Instead of a hash-table/scatter formulation, this
# sorted formulation is the same design as the single-device headline
# kernel (ops/pipelines.join_groupby_direct): sort the local fact rows
# once, then answer each dim key's [k, k+1) range with merge-ranked
# prefix-sum differences — every N-sized op streams, and the only scatter
# is G-sized. int64 max is a reserved key (masked rows).

_BLK = 128
_MAXK = jnp.int64(jnp.iinfo(jnp.int64).max)


def _sorted_fact_blocks(fk, fv, fm):
    """Sort local fact rows by key (masked rows -> reserved max key, sorted
    last) and precompute 128-wide block prefix sums of the values."""
    from jax import lax

    n = fk.shape[0]
    ks, vs = lax.sort((jnp.where(fm, fk, _MAXK), fv), num_keys=1)
    pad = (-n) % _BLK
    if pad:
        ks = jnp.concatenate([ks, jnp.full((pad,), _MAXK)])
        vs = jnp.concatenate([vs, jnp.zeros((pad,), vs.dtype)])
    k2d = ks.reshape(-1, _BLK)
    v2d = vs.reshape(-1, _BLK)
    bs = jnp.sum(v2d, axis=1)
    bp = jnp.concatenate([jnp.cumsum(bs) - bs, jnp.sum(bs)[None]])
    return k2d, v2d, bp


def _range_partials(k2d, v2d, bp, dk, dm):
    """Per dim key k: (sum, count) of fact values with key in [k, k+1).
    Invalid dim rows query an empty range."""
    from sqlrs_tpu.ops.pipelines import _sorted_ranks_left

    dlo = jnp.where(dm, dk, _MAXK)
    dhi = jnp.where(dm, dk + 1, _MAXK)
    g = dlo.shape[0]
    ranks = _sorted_ranks_left(k2d, jnp.concatenate([dlo, dhi]))
    lo, hi = ranks[:g], ranks[g:]
    nb = k2d.shape[0]
    lane = jnp.arange(_BLK, dtype=jnp.int32)

    def prefix_at(pos):
        b = pos // _BLK
        rem = (pos % _BLK).astype(jnp.int32)
        rows = v2d[jnp.clip(b, 0, nb - 1)]
        part = jnp.sum(jnp.where(lane[None, :] < rem[:, None], rows, 0), axis=1)
        return bp[b] + part

    return prefix_at(hi) - prefix_at(lo), hi - lo


def _local_join_groupby(fk, fv, fm, dk, drow, dm, n_groups: int):
    """(sums, counts) partials by dim row id over one shard's fact rows."""
    k2d, v2d, bp = _sorted_fact_blocks(fk, fv, fm)
    sum_d, cnt_d = _range_partials(k2d, v2d, bp, dk, dm)
    tgt = jnp.where(dm, drow, n_groups)
    sums = jnp.zeros((n_groups + 1,), fv.dtype).at[tgt].add(sum_d)
    cnts = jnp.zeros((n_groups + 1,), jnp.int64).at[tgt].add(cnt_d)
    return sums[:n_groups], cnts[:n_groups]


# ---- exchange: repartition by key hash ------------------------------------------


def partition_shuffle(mesh, keys, values, valid, bucket_capacity: int, axis="x"):
    """Repartition (keys, values, valid) so rows land on device
    hash(key) % n_dev. Per-destination buckets are padded to
    `bucket_capacity` rows (static); overflow rows are dropped with a
    returned overflow count so callers can size up and retry — the
    fixed-capacity + bucketed-recompile strategy from SURVEY.md §7.
    """
    n_dev = _axis_size(mesh, axis)

    def local(keys, values, valid):
        n = keys.shape[0]
        dest = (hash_keys(keys, 1 << 32) % n_dev).astype(jnp.int32)
        dest = jnp.where(valid, dest, n_dev)  # invalid rows sort to the end
        order = jnp.argsort(dest, stable=True)
        k_s, v_s, d_s = keys[order], values[order], dest[order]
        ok = d_s < n_dev
        # position of each row within its destination bucket
        one = ok.astype(jnp.int64)
        counts = jnp.zeros((n_dev,), jnp.int64).at[jnp.where(ok, d_s, 0)].add(one)
        starts = jnp.cumsum(counts) - counts
        pos_in_bucket = jnp.arange(n, dtype=jnp.int64) - starts[jnp.clip(d_s, 0, n_dev - 1)]
        in_cap = ok & (pos_in_bucket < bucket_capacity)
        # scatter rows into (n_dev, bucket_capacity) send buffers
        flat_idx = jnp.clip(d_s, 0, n_dev - 1) * bucket_capacity + pos_in_bucket
        flat_idx = jnp.where(in_cap, flat_idx, n_dev * bucket_capacity)  # dropped
        buf_k = jnp.full((n_dev * bucket_capacity + 1,), 0, keys.dtype).at[flat_idx].set(k_s)
        buf_v = jnp.full((n_dev * bucket_capacity + 1,), 0, values.dtype).at[flat_idx].set(v_s)
        buf_ok = jnp.zeros((n_dev * bucket_capacity + 1,), jnp.bool_).at[flat_idx].set(in_cap)
        send_k = buf_k[:-1].reshape(n_dev, bucket_capacity)
        send_v = buf_v[:-1].reshape(n_dev, bucket_capacity)
        send_m = buf_ok[:-1].reshape(n_dev, bucket_capacity)
        overflow = jnp.sum(ok & ~in_cap)
        # exchange: row i of my buffers goes to device i
        recv_k = jax.lax.all_to_all(send_k, axis, 0, 0, tiled=False)
        recv_v = jax.lax.all_to_all(send_v, axis, 0, 0, tiled=False)
        recv_m = jax.lax.all_to_all(send_m, axis, 0, 0, tiled=False)
        return (
            recv_k.reshape(-1),
            recv_v.reshape(-1),
            recv_m.reshape(-1),
            overflow[None],
        )

    return spmd(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
    )(keys, values, valid)


# ---- fused distributed join + group-by --------------------------------------------


def dist_join_groupby_broadcast(
    mesh, fact_keys, fact_vals, dim_keys, n_groups: int, axis="x"
):
    """SELECT dim_row, sum(v), count(*) FROM fact JOIN dim USING (key)
    GROUP BY dim_row — dim replicated, fact sharded.

    Returns (sums[n_groups], counts[n_groups]) replicated. Group id == dim
    row index (dim keys assumed unique — the fact→dimension join). One psum
    of O(n_groups) is the only cross-device traffic.
    """
    def local(fk, fv, dk):
        fm = jnp.ones(fk.shape, jnp.bool_)
        drow = jnp.arange(dk.shape[0], dtype=jnp.int64)
        dm = jnp.ones(dk.shape, jnp.bool_)
        sums, cnts = _local_join_groupby(fk, fv, fm, dk, drow, dm, n_groups)
        return jax.lax.psum(sums, axis), jax.lax.psum(cnts, axis)

    return spmd(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=(P(), P()),
    )(fact_keys, fact_vals, dim_keys)


def dist_join_groupby_shuffle(
    mesh, fact_keys, fact_vals, dim_keys, n_groups: int, bucket_capacity: int, axis="x"
):
    """General large-large path: both sides repartitioned by key hash, then
    per-shard hash join + partial aggregation; partials combined with psum.
    Handles dim sides too large to replicate; skewed hot keys are bounded by
    bucket_capacity (salted splitting is layered above by the planner).

    Returns (sums, counts, overflow): overflow > 0 means a (sender,
    receiver) bucket exceeded bucket_capacity and ROWS WERE DROPPED — the
    result is NOT trustworthy and the caller must retry with a larger
    capacity (dist_join_groupby_shuffle_checked does this) or raise."""
    n_dev = _axis_size(mesh, axis)

    def _pad_to_mesh(x, fill):
        n = x.shape[0]
        pad = (-n) % n_dev
        if pad == 0:
            return x, jnp.ones((n,), jnp.bool_)
        xp = jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)])
        return xp, jnp.concatenate([jnp.ones((n,), jnp.bool_), jnp.zeros((pad,), jnp.bool_)])

    dim_vals = jnp.arange(dim_keys.shape[0], dtype=jnp.int64)  # dim row ids
    fact_keys, valid_f = _pad_to_mesh(fact_keys, 0)
    fact_vals, _ = _pad_to_mesh(fact_vals, 0)
    dim_keys, valid_d = _pad_to_mesh(dim_keys, 0)
    dim_vals, _ = _pad_to_mesh(dim_vals, 0)
    fk, fv, fm, ovf_f = partition_shuffle(mesh, fact_keys, fact_vals, valid_f, bucket_capacity, axis)
    dk, drow, dm, ovf_d = partition_shuffle(mesh, dim_keys, dim_vals, valid_d, bucket_capacity, axis)

    def local(fk, fv, fm, dk, drow, dm):
        sums, cnts = _local_join_groupby(fk, fv, fm, dk, drow, dm, n_groups)
        return jax.lax.psum(sums, axis), jax.lax.psum(cnts, axis)

    sums, cnts = spmd(
        local,
        mesh=mesh,
        in_specs=(P(axis),) * 6,
        out_specs=(P(), P()),
    )(fk, fv, fm, dk, drow, dm)
    return sums, cnts, jnp.sum(ovf_f) + jnp.sum(ovf_d)


def dist_join_groupby_shuffle_checked(
    mesh, fact_keys, fact_vals, dim_keys, n_groups: int, bucket_capacity: int, axis="x"
):
    """Host-level wrapper: retries with 4x capacity until no exchange bucket
    overflows (the bucketed-recompile strategy dist_sort_rows uses,
    SURVEY.md §7). Capacity == total padded rows always fits, so the loop
    terminates; silent row drops are impossible through this entry point."""
    n_dev = _axis_size(mesh, axis)
    n_pad = fact_keys.shape[0] + (-fact_keys.shape[0]) % n_dev
    d_pad = dim_keys.shape[0] + (-dim_keys.shape[0]) % n_dev
    cap_max = max(n_pad, d_pad)
    while True:
        sums, cnts, overflow = dist_join_groupby_shuffle(
            mesh, fact_keys, fact_vals, dim_keys, n_groups, bucket_capacity, axis
        )
        if _overflow_scalar(overflow) == 0:
            return sums, cnts
        if bucket_capacity >= cap_max:  # pragma: no cover - cap_max always fits
            raise RuntimeError("exchange overflow at full capacity")
        bucket_capacity = min(bucket_capacity * 4, cap_max)


def dist_join_groupby_salted(
    mesh,
    fact_keys,
    fact_vals,
    dim_keys,
    n_groups: int,
    bucket_capacity: int,
    hot_capacity: int = 1024,
    hot_factor: float = 4.0,
    axis="x",
):
    """Skew-aware shuffle join + group-by: salted-key splitting (the north
    star's skew requirement; the reference's hash map simply degrades on hot
    keys, SURVEY.md §2.3).

    1. per-shard key histograms over hash buckets → psum → buckets with
       > hot_factor × mean are "hot";
    2. fact rows with hot keys are salted: destination spreads round-robin
       over all shards instead of hash(key) % n_dev — no shard receives the
       whole hot key;
    3. dim rows in hot buckets are REPLICATED to every shard (all_gather of
       the small hot subset, capacity `hot_capacity`), cold dim rows shuffle
       normally;
    4. local hash join + partial aggregate by dim row id; one psum combines.
       Every fact row is processed exactly once, so replication cannot
       double-count.
    """
    n_dev = _axis_size(mesh, axis)
    n_buckets = 4096

    def _pad(x, fill):
        n = x.shape[0]
        pad = (-n) % n_dev
        if pad == 0:
            return x, jnp.ones((n,), jnp.bool_)
        return (
            jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)]),
            jnp.concatenate([jnp.ones((n,), jnp.bool_), jnp.zeros((pad,), jnp.bool_)]),
        )

    dim_rows = jnp.arange(dim_keys.shape[0], dtype=jnp.int64)
    fact_keys, fvalid = _pad(fact_keys, 0)
    fact_vals, _ = _pad(fact_vals, 0)
    dim_keys_p, dvalid = _pad(dim_keys, 0)
    dim_rows_p, _ = _pad(dim_rows, 0)

    def local(fk, fv, fm, dk, drow, dm):
        n = fk.shape[0]
        bucket_f = (hash_keys(fk, n_buckets)).astype(jnp.int32)
        hist = jnp.zeros((n_buckets,), jnp.int64).at[bucket_f].add(
            fm.astype(jnp.int64)
        )
        hist = jax.lax.psum(hist, axis)
        total = jnp.sum(hist)
        hot = hist > (hot_factor * total / n_buckets)

        # ---- fact exchange: hot rows salted round-robin ------------------
        base_dest = (hash_keys(fk, 1 << 32) % n_dev).astype(jnp.int32)
        salt = (jnp.arange(n, dtype=jnp.int32) % n_dev)
        dest = jnp.where(hot[bucket_f], salt, base_dest)
        dest = jnp.where(fm, dest, n_dev)
        (fk2, fv2), fm2, ovf_f = _exchange_rows(
            (fk, fv), dest, n_dev, bucket_capacity, axis
        )

        # ---- dim: cold rows shuffle, hot rows all_gather ------------------
        bucket_d = (hash_keys(dk, n_buckets)).astype(jnp.int32)
        d_hot = hot[bucket_d] & dm
        dest_d = jnp.where(
            dm & ~d_hot, (hash_keys(dk, 1 << 32) % n_dev).astype(jnp.int32), n_dev
        )
        dcold, dm_cold, ovf_d = _exchange_rows(
            (dk, drow), dest_d, n_dev, bucket_capacity, axis
        )
        dk_cold, drow_cold = dcold
        # hot subset to fixed-capacity buffer, then all_gather; hot rows
        # beyond hot_capacity are NOT carried — count them as overflow so
        # the caller retries (silent truncation = wrong answers under skew)
        ovf_hot = jnp.maximum(
            jnp.sum(d_hot.astype(jnp.int64)) - hot_capacity, 0
        )
        hot_order = jnp.argsort(jnp.logical_not(d_hot), stable=True)
        hk = dk[hot_order][:hot_capacity]
        hr = drow[hot_order][:hot_capacity]
        hmask = d_hot[hot_order][:hot_capacity]
        hk = jax.lax.all_gather(hk, axis).reshape(-1)
        hr = jax.lax.all_gather(hr, axis).reshape(-1)
        hmask = jax.lax.all_gather(hmask, axis).reshape(-1)

        dk_all = jnp.concatenate([dk_cold, hk])
        drow_all = jnp.concatenate([drow_cold, hr])
        dm_all = jnp.concatenate([dm_cold, hmask])

        # ---- local join + partial agg -------------------------------------
        sums, cnts = _local_join_groupby(
            fk2, fv2, fm2, dk_all, drow_all, dm_all, n_groups
        )
        overflow = jax.lax.psum(ovf_f + ovf_d + ovf_hot, axis)
        return jax.lax.psum(sums, axis), jax.lax.psum(cnts, axis), overflow

    return spmd(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
    )(fact_keys, fact_vals, fvalid, dim_keys_p, dim_rows_p, dvalid)


def dist_join_groupby_salted_checked(
    mesh,
    fact_keys,
    fact_vals,
    dim_keys,
    n_groups: int,
    bucket_capacity: int,
    hot_capacity: int = 1024,
    hot_factor: float = 4.0,
    axis="x",
):
    """Host-level wrapper around the salted kernel: retries with 4x bucket
    AND hot capacities until nothing overflowed. Both capacities are bounded
    by the padded input sizes, so the loop terminates with every row
    processed exactly once."""
    n_dev = _axis_size(mesh, axis)
    n_pad = fact_keys.shape[0] + (-fact_keys.shape[0]) % n_dev
    d_pad = dim_keys.shape[0] + (-dim_keys.shape[0]) % n_dev
    cap_max = max(n_pad, d_pad)
    while True:
        sums, cnts, overflow = dist_join_groupby_salted(
            mesh, fact_keys, fact_vals, dim_keys, n_groups,
            bucket_capacity, hot_capacity, hot_factor, axis,
        )
        if _overflow_scalar(overflow) == 0:
            return sums, cnts
        if bucket_capacity >= cap_max and hot_capacity >= d_pad:
            raise RuntimeError(  # pragma: no cover - full capacity always fits
                "exchange overflow at full capacity"
            )
        bucket_capacity = min(bucket_capacity * 4, cap_max)
        hot_capacity = min(hot_capacity * 4, d_pad)


def dist_join_groupby_ring(mesh, fact_keys, fact_vals, dim_keys, n_groups: int, axis="x"):
    """Ring join + group-by: the pipeline-parallel / overlapped-communication
    path (SURVEY.md §2.3 "pipeline parallelism"; the reference has no
    parallelism at all — single tokio pull chain, src/executor/mod.rs:34).

    Both sides stay sharded (fact rows and dim rows each P(axis)); no key
    shuffle ever happens. Over n_dev ring steps, each shard probes its
    resident fact rows against the dim chunk it currently holds while the
    chunk for step s+1 is already in flight via `lax.ppermute` — the permute
    of the next chunk has no data dependence on the current probe, so XLA's
    latency-hiding scheduler overlaps communication with compute (the same
    double-buffering structure as ring attention / rotated all-gather
    matmuls). Memory per shard is O(N/p + G/p + G); collective payload is
    the dim table once around the ring plus one O(G) psum.

    Compared with the other join strategies:
      - broadcast: dim replicated up front (needs G per shard, one-shot);
      - shuffle:   O(N) all-to-all, exposed (non-overlapped) latency;
      - ring:      O(G) ppermute traffic hidden under probe compute — the
                   right choice when dim is too big to replicate but the
                   fact table is too expensive to shuffle.

    Returns (sums[n_groups], counts[n_groups]) replicated.
    """
    n_dev = _axis_size(mesh, axis)

    def _pad(x, fill):
        n = x.shape[0]
        pad = (-n) % n_dev
        if pad == 0:
            return x, jnp.ones((n,), jnp.bool_)
        return (
            jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)]),
            jnp.concatenate([jnp.ones((n,), jnp.bool_), jnp.zeros((pad,), jnp.bool_)]),
        )

    dim_rows = jnp.arange(dim_keys.shape[0], dtype=jnp.int64)
    fact_keys, fvalid = _pad(fact_keys, 0)
    fact_vals, _ = _pad(fact_vals, 0)
    dim_keys_p, dvalid = _pad(dim_keys, 0)
    dim_rows_p, _ = _pad(dim_rows, 0)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    def local(fk, fv, fm, dk, drow, dm):
        # the fact side is sorted ONCE; each ring step answers the resident
        # dim chunk's range queries against the same sorted blocks
        k2d, v2d, bp = _sorted_fact_blocks(fk, fv, fm)

        def step(carry, _):
            dk_c, drow_c, dm_c, sums, cnts = carry
            # issue the next chunk's transfer FIRST — independent of the
            # range queries below, so XLA overlaps the ppermute with compute
            dk_n = jax.lax.ppermute(dk_c, axis, perm)
            drow_n = jax.lax.ppermute(drow_c, axis, perm)
            dm_n = jax.lax.ppermute(dm_c, axis, perm)
            sum_d, cnt_d = _range_partials(k2d, v2d, bp, dk_c, dm_c)
            tgt = jnp.where(dm_c, drow_c, n_groups)
            sums = sums.at[tgt].add(sum_d)
            cnts = cnts.at[tgt].add(cnt_d)
            return (dk_n, drow_n, dm_n, sums, cnts), None

        # accumulators derive from fv so they carry the shard-varying mesh
        # axis (a fresh jnp.zeros is "unvarying" and scan rejects the carry)
        vary = jnp.sum(fv) * 0
        init = (
            dk,
            drow,
            dm,
            jnp.zeros((n_groups + 1,), fv.dtype) + vary,
            jnp.zeros((n_groups + 1,), jnp.int64) + vary,
        )
        (_, _, _, sums, cnts), _ = jax.lax.scan(step, init, None, length=n_dev)
        return jax.lax.psum(sums[:n_groups], axis), jax.lax.psum(cnts[:n_groups], axis)

    return spmd(
        local,
        mesh=mesh,
        in_specs=(P(axis),) * 6,
        out_specs=(P(), P()),
    )(fact_keys, fact_vals, fvalid, dim_keys_p, dim_rows_p, dvalid)


def _bucketize_rows(arrays, dest, n_dev, bucket_capacity):
    """The scatter half of the exchange: lay rows into per-destination
    buckets. Returns (tuple of (n_dev, cap) buffers, (n_dev, cap) live
    mask, local overflow count). dest == n_dev drops the row."""
    n = dest.shape[0]
    order = jnp.argsort(dest, stable=True)
    d_s = dest[order]
    ok = d_s < n_dev
    one = ok.astype(jnp.int64)
    counts = jnp.zeros((n_dev,), jnp.int64).at[jnp.where(ok, d_s, 0)].add(one)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(n, dtype=jnp.int64) - starts[jnp.clip(d_s, 0, n_dev - 1)]
    in_cap = ok & (pos < bucket_capacity)
    overflow = jnp.sum(ok & jnp.logical_not(in_cap))
    flat = jnp.where(
        in_cap, jnp.clip(d_s, 0, n_dev - 1) * bucket_capacity + pos,
        n_dev * bucket_capacity,
    )
    bufs = []
    for a in arrays:
        a_s = a[order]
        buf = jnp.zeros((n_dev * bucket_capacity + 1,), a.dtype).at[flat].set(a_s)
        bufs.append(buf[:-1].reshape(n_dev, bucket_capacity))
    mbuf = jnp.zeros((n_dev * bucket_capacity + 1,), jnp.bool_).at[flat].set(in_cap)
    return tuple(bufs), mbuf[:-1].reshape(n_dev, bucket_capacity), overflow


def _exchange_rows(arrays, dest, n_dev, bucket_capacity, axis):
    """all_to_all N rows to `dest` shards (dest == n_dev drops the row);
    returns (tuple of received arrays, received mask, local overflow count).
    Shared bucketing logic for the shuffle operators. overflow > 0 means
    live rows did NOT fit their (sender, receiver) bucket and were dropped —
    callers must surface it (retry bigger or raise), never ignore it."""
    bufs, mbuf, overflow = _bucketize_rows(arrays, dest, n_dev, bucket_capacity)
    received = [
        jax.lax.all_to_all(buf, axis, 0, 0).reshape(-1) for buf in bufs
    ]
    mask = jax.lax.all_to_all(mbuf, axis, 0, 0).reshape(-1)
    return tuple(received), mask, overflow


def dist_sort_rows(
    mesh, dkeys, payload_arrays, alive, bucket_capacity: int, axis="x",
    rowid=None,
):
    """Distributed ORDER BY over whole rows: sample-sort exchange on the
    FIRST directed key (ties share a value, hence a bucket, so shard i holds
    range bucket i), then one local stable variadic sort per shard over ALL
    directed keys with the global row index as the final tiebreak — the
    collected result is bit-exact with the single-device stable sort,
    including NULL placement and tie order.

    dkeys: directed orderable key arrays (ops/sort._directed_key output);
    payload_arrays: every row array to carry (column data + validity);
    alive: live-row mask (dead rows are dropped by the exchange — the
    distributed sort doubles as compaction);
    rowid: optional logical row-order array — the tie-break key when the
    input's physical placement is already scrambled (ShardedBatch.rowid);
    defaults to the global position index.

    Returns (sorted dkeys', payloads', alive', overflow) — overflow > 0
    means some (sender, receiver) bucket exceeded bucket_capacity and the
    caller must retry with a larger capacity (SURVEY.md §7 bucketed
    recompile) or materialize.
    """
    n_dev = _axis_size(mesh, axis)
    sample_per_shard = 64
    first = dkeys[0]
    if jnp.issubdtype(first.dtype, jnp.floating):
        big = jnp.asarray(jnp.inf, first.dtype)
    else:
        big = jnp.asarray(jnp.iinfo(first.dtype).max, first.dtype)

    def local(alive_l, *arrs):
        nk = len(dkeys)
        keys_l = arrs[:nk]
        n_local = alive_l.shape[0]
        if rowid is None:
            pays_l = arrs[nk:]
            base = jax.lax.axis_index(axis).astype(jnp.int64) * n_local
            rowid_l = base + jnp.arange(n_local, dtype=jnp.int64)
        else:
            rowid_l = arrs[nk]
            pays_l = arrs[nk + 1 :]

        first_l = jnp.where(alive_l, keys_l[0], big)
        sorted_first = jnp.sort(first_l)
        stride = max(n_local // sample_per_shard, 1)
        sample = jax.lax.all_gather(
            sorted_first[::stride][:sample_per_shard], axis
        ).reshape(-1)
        sample = jnp.sort(sample)
        m = sample.shape[0]
        splitters = sample[jnp.arange(1, n_dev) * m // n_dev]
        dest = jnp.searchsorted(splitters, keys_l[0], side="right").astype(
            jnp.int32
        )
        dest = jnp.where(alive_l, dest, n_dev)  # dead rows are dropped

        send = tuple(keys_l) + (rowid_l,) + tuple(pays_l)
        received, mask, overflow = _exchange_rows(
            send, dest, n_dev, bucket_capacity, axis
        )
        keys_r = received[:nk]
        rowid_r = received[nk]
        pays_r = received[nk + 1 :]
        # local stable sort: dead rows last, then directed keys, then the
        # global row index (exact single-device tie order)
        sort_ops = [jnp.logical_not(mask).astype(jnp.int32)]
        sort_ops += list(keys_r) + [rowid_r]
        out = jax.lax.sort(
            tuple(sort_ops) + tuple(pays_r) + (mask.astype(jnp.int32),),
            num_keys=len(sort_ops),
            is_stable=True,
        )
        s_keys = out[1 : 1 + nk]
        s_pays = out[1 + nk + 1 : -1]
        s_mask = out[-1] > 0
        return tuple(s_keys) + tuple(s_pays) + (s_mask, jax.lax.psum(overflow, axis)[None])

    extra = () if rowid is None else (rowid,)
    outs = spmd(
        local,
        mesh=mesh,
        in_specs=(P(axis),) * (1 + len(dkeys) + len(extra) + len(payload_arrays)),
        out_specs=P(axis),
    )(alive, *dkeys, *extra, *payload_arrays)
    nk = len(dkeys)
    keys_out = outs[:nk]
    pays_out = outs[nk : nk + len(payload_arrays)]
    mask_out = outs[-2]
    overflow = _overflow_scalar(outs[-1])
    return keys_out, pays_out, mask_out, overflow


# ---- distributed sort ----------------------------------------------------------------


def dist_sort(mesh, keys, bucket_capacity: int, axis="x"):
    """Sample sort: splitters from an all-gathered per-shard sample; rows
    all-to-all'd to their range owner; local sort per shard. Returns
    (sorted_keys[shards, cap], valid mask) — shard i holds range bucket i,
    so the concatenation of valid rows is globally sorted (the distributed
    ORDER BY, SURVEY.md §2.3's CP-analogue)."""
    n_dev = _axis_size(mesh, axis)
    sample_per_shard = 64

    def local(k):
        n = k.shape[0]
        stride = max(n // sample_per_shard, 1)
        sample = jax.lax.all_gather(
            jnp.sort(k[::stride][:sample_per_shard]), axis
        ).reshape(-1)
        sample = jnp.sort(sample)
        m = sample.shape[0]
        splitters = sample[jnp.arange(1, n_dev) * m // n_dev]
        dest = jnp.searchsorted(splitters, k, side="right").astype(jnp.int32)
        # bucket + exchange (same machinery as partition_shuffle, inline)
        order = jnp.argsort(dest, stable=True)
        k_s, d_s = k[order], dest[order]
        one = jnp.ones((n,), jnp.int64)
        counts = jnp.zeros((n_dev,), jnp.int64).at[d_s].add(one)
        starts = jnp.cumsum(counts) - counts
        pos = jnp.arange(n, dtype=jnp.int64) - starts[d_s]
        in_cap = pos < bucket_capacity
        flat = jnp.where(in_cap, d_s * bucket_capacity + pos, n_dev * bucket_capacity)
        buf_k = jnp.zeros((n_dev * bucket_capacity + 1,), k.dtype).at[flat].set(k_s)
        buf_m = jnp.zeros((n_dev * bucket_capacity + 1,), jnp.bool_).at[flat].set(in_cap)
        recv_k = jax.lax.all_to_all(
            buf_k[:-1].reshape(n_dev, bucket_capacity), axis, 0, 0
        ).reshape(-1)
        recv_m = jax.lax.all_to_all(
            buf_m[:-1].reshape(n_dev, bucket_capacity), axis, 0, 0
        ).reshape(-1)
        big = jnp.iinfo(k.dtype).max
        sort_k = jnp.sort(jnp.where(recv_m, recv_k, big))
        return sort_k[None], jnp.sort(~recv_m)[None]  # valid rows first

    ks, invalid = spmd(
        local, mesh=mesh, in_specs=(P(axis),), out_specs=(P(axis), P(axis))
    )(keys)
    return ks, ~invalid
