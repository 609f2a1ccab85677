"""Shuffle-repartition distributed hash join carrying full row payloads.

SURVEY.md §2.3 "partitioned hash join": when NEITHER side fits replicated,
both sides are repartitioned by key hash so every shard joins ~N/p probe
rows against ~B/p build rows. (The reference's build/probe split is
hash_join.rs:146-187 — single-process; the broadcast path in
dist_executor._hash_join_dist replicates the build side, which stops
scaling once the build side is itself fact-sized, e.g. TPC-H Q9/Q18/Q21.)

Design — two shard_map programs split at the one host sync (the max match
count m, same two-phase shape as ops/join.equi_join_pairs):

  program A ("exchange + rank"):
    1. combined splitmix hash over all encoded key columns -> destination
       shard; rows with NULL keys or dead rows are dropped (inner-join
       semantics: NULL never matches).
    2. SKEW IS HANDLED HERE, adaptively: a psum'd 4096-bucket key histogram
       marks hot buckets (> hot_factor x mean). Hot PROBE rows spread
       round-robin over all shards; hot BUILD rows are replicated to every
       shard via all_gather (bounded by hot_capacity) instead of being
       exchanged. A plain hash shuffle would bottleneck the hot key's owner
       shard; with salting no (sender, receiver) bucket ever carries a whole
       hot key. When no bucket is hot the salted path degenerates to the
       plain shuffle — one code path, data-dependent behavior.
    3. every (sender, receiver) bucket overflow is COUNTED and returned
       (never silently dropped); the driver retries with 4x capacities.
    4. received build rows are sorted by global rowid (dead slots last), so
       local position order == single-device insertion order; one merged
       sort (ops/join._pairs_phase_a) then hands every probe row its match
       range [start, start+count) plus the key-rank -> position permutation.
  host: m = global max match count (the only sync), overflow check.
  program B ("expand"): every probe row owns a static m-wide strip of match
    slots; build columns gather through the permutation, probe columns
    repeat. Output logical order is rowid_out = probe_rowid * m + slot —
    exactly the single-device emission sequence (probe-order outer, build
    insertion order inner, hash_join.rs:207-250), so the collected result
    is bit-exact including row order (ShardedBatch.rowid machinery).

Every array the SQL layer hands over (any column dtype + validity) rides
the exchange as payload; bools are cast to int32 by the caller.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from sqlrs_tpu.ops.hash_table import _mix64
from sqlrs_tpu.ops.join import _pairs_phase_a
from sqlrs_tpu.parallel.dist_ops import _bucketize_rows, _exchange_rows
from sqlrs_tpu.parallel.mesh import spmd


def _ring_probe_ranks(p_send, dest_p, n_dev, cap, axis, l_ops, nk):
    """Ring-staged probe exchange with receive/probe OVERLAP (round-3
    VERDICT item 7): instead of one monolithic all_to_all followed by one
    rank pass, the bucketized probe buffers rotate around the ring via
    lax.ppermute; each step ISSUES the next hop first, then ranks the
    chunk that just became resident against the local build side — so
    receive(k+1) is in flight while probe(k) computes, exactly the
    ring_agg_join double-buffering pattern generalized to the shuffle
    join. Per-chunk results land at the same sender-major offsets the
    all_to_all layout uses, and per-probe-row ranks depend only on the
    build side, so every output array is BIT-IDENTICAL to the monolithic
    path (tests/test_distributed.py pins this).

    Cost model: a ring all_to_all moves each buffer n_dev hops (on ICI
    ring topologies the links carry equivalent traffic for the monolithic
    all_to_all too — average hop distance is O(n)); the rank sort runs
    once per chunk against the full local build, so the build side is
    re-sorted n_dev times. The win is latency hiding, not volume; the
    monolithic path stays the default."""
    bufs, mbuf, ovf = _bucketize_rows(p_send, dest_p, n_dev, cap)
    i = jax.lax.axis_index(axis)
    perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]
    n_recv = n_dev * cap

    def _varying(x):
        # zero-init carries are replicated constants; the scan outputs are
        # shard-varying — align the vma types for shard_map's scan check
        return jax.lax.pcast(x, (axis,), to="varying")

    outs0 = tuple(_varying(jnp.zeros((n_recv,), b.dtype)) for b in bufs)
    msk0 = _varying(jnp.zeros((n_recv,), jnp.bool_))
    st0 = _varying(jnp.zeros((n_recv,), jnp.int64))
    ct0 = _varying(jnp.zeros((n_recv,), jnp.int64))
    nb_local = l_ops[1].shape[0]
    ord0 = _varying(jnp.zeros((nb_local,), jnp.int64))

    def step(carry, s):
        bufs_c, mbuf_c, outs, msk, sts, cts, _ = carry
        # next hop FIRST: the ppermute overlaps the rank compute below
        bufs_n = tuple(jax.lax.ppermute(b, axis, perm) for b in bufs_c)
        mbuf_n = jax.lax.ppermute(mbuf_c, axis, perm)
        # resident buffer belongs to shard (i - s); my chunk is row i
        chunk = tuple(
            jax.lax.dynamic_index_in_dim(b, i, 0, keepdims=False)
            for b in bufs_c
        )
        cm = jax.lax.dynamic_index_in_dim(mbuf_c, i, 0, keepdims=False)
        r_ops = []
        for j in range(nk):
            r_ops += [cm.astype(jnp.int32), chunk[j]]
        st_c, ct_c, order, _tot = _pairs_phase_a(
            l_ops, tuple(r_ops), 2 * nk
        )
        src = (i - s) % n_dev
        off = src * np.int64(cap)
        outs = tuple(
            jax.lax.dynamic_update_slice(o, c, (off,))
            for o, c in zip(outs, chunk)
        )
        msk = jax.lax.dynamic_update_slice(msk, cm, (off,))
        sts = jax.lax.dynamic_update_slice(sts, st_c, (off,))
        cts = jax.lax.dynamic_update_slice(cts, ct_c, (off,))
        return (bufs_n, mbuf_n, outs, msk, sts, cts, order), None

    carry0 = (bufs, mbuf, outs0, msk0, st0, ct0, ord0)
    carry, _ = jax.lax.scan(
        step, carry0, jnp.arange(n_dev, dtype=jnp.int64)
    )
    _, _, outs, msk, sts, cts, order = carry
    return outs, msk, sts, cts, order, ovf

_N_BUCKETS = 4096
_BLK = 128
_MAXK = jnp.int64(np.iinfo(np.int64).max)


@dataclass
class ShuffleJoinPhaseA:
    """Host-visible result of program A (arrays stay on device, sharded)."""

    build_arrays: tuple  # key encs, payloads, rowid — rowid-sorted per shard
    build_mask: jnp.ndarray
    probe_arrays: tuple  # key encs, payloads, rowid — exchange order
    probe_mask: jnp.ndarray
    starts: jnp.ndarray
    counts: jnp.ndarray
    order: jnp.ndarray
    overflow: int
    n_hot_buckets: int
    m: int  # global max matches per probe row


def _combined_hash(key_pairs):
    """One well-mixed uint64 per row over all encoded key columns.

    key_pairs entries are (encoded_key, valid) — the hash MUST consume the
    encoded key (first element). A round-3 bug unpacked (valid, enc) and
    hashed the validity bits, which sent every valid row to ONE destination;
    results stayed correct only because the adaptive skew path then marked
    that bucket hot and round-robined it, at the cost of real partitioning
    (and an overflow-retry compile ladder). tests/test_distributed.py
    test_shuffle_partitions_by_key pins the correct behavior."""
    h = jnp.full(key_pairs[0][0].shape, 0x9E3779B97F4A7C15, jnp.uint64)
    for enc, _valid in key_pairs:
        h = _mix64(h ^ _mix64(enc.astype(jnp.uint64)))
    return h


def shuffle_join_phase_a(
    mesh,
    b_keys,  # [(enc int array, valid bool array)] per join key, build side
    b_payload,  # flat arrays to carry (col data + validity as int32)
    b_rowid,
    b_alive,
    p_keys,
    p_payload,
    p_rowid,
    p_alive,
    *,
    bucket_b: int,
    bucket_p: int,
    hot_capacity: int,
    hot_factor: float = 4.0,
    hot_min: int | None = None,
    axis="x",
    ring: bool = False,
):
    # a bucket is hot only when it is BOTH far above the mean and big
    # enough to threaten a (sender, receiver) bucket: tiny inputs otherwise
    # mark noise buckets hot and pay replication for nothing
    if hot_min is None:
        hot_min = bucket_p
    n_dev = mesh.shape[axis]
    nk = len(b_keys)
    nb_pay = len(b_payload)
    np_pay = len(p_payload)

    # flat argument layout for shard_map
    args = [b_alive]
    for e, v in b_keys:
        args += [e, v]
    args += list(b_payload) + [b_rowid, p_alive]
    for e, v in p_keys:
        args += [e, v]
    args += list(p_payload) + [p_rowid]

    def local(*arrs):
        i = 0
        ba = arrs[i]; i += 1
        bk = []
        for _ in range(nk):
            bk.append((arrs[i], arrs[i + 1])); i += 2
        bpay = arrs[i : i + nb_pay]; i += nb_pay
        brow = arrs[i]; i += 1
        pa = arrs[i]; i += 1
        pk = []
        for _ in range(nk):
            pk.append((arrs[i], arrs[i + 1])); i += 2
        ppay = arrs[i : i + np_pay]; i += np_pay
        prow = arrs[i]; i += 1

        bvalid = ba
        for e, v in bk:
            bvalid = bvalid & v
        pvalid = pa
        for e, v in pk:
            pvalid = pvalid & v

        hb = _combined_hash(bk)
        hp = _combined_hash(pk)

        # ---- adaptive skew detection: psum'd histogram of probe keys ------
        bucket_p_id = (hp % _N_BUCKETS).astype(jnp.int32)
        hist = (
            jnp.zeros((_N_BUCKETS,), jnp.int64)
            .at[jnp.where(pvalid, bucket_p_id, 0)]
            .add(pvalid.astype(jnp.int64))
        )
        hist = jax.lax.psum(hist, axis)
        total = jnp.sum(hist)
        thresh = jnp.maximum(
            hot_factor * total.astype(jnp.float64) / _N_BUCKETS,
            jnp.float64(hot_min),
        )
        hot = hist.astype(jnp.float64) > thresh
        n_hot = jnp.sum(hot.astype(jnp.int64))

        # ---- probe exchange: hot rows salted round-robin ------------------
        n_local = pvalid.shape[0]
        base_p = (hp % jnp.uint64(n_dev)).astype(jnp.int32)
        salt = (
            (jnp.arange(n_local, dtype=jnp.int32) + jax.lax.axis_index(axis))
            % n_dev
        )
        dest_p = jnp.where(hot[bucket_p_id], salt, base_p)
        dest_p = jnp.where(pvalid, dest_p, n_dev)
        p_send = tuple(e for e, _ in pk) + tuple(ppay) + (prow,)
        if not ring:
            p_recv, pm, ovf_p = _exchange_rows(
                p_send, dest_p, n_dev, bucket_p, axis
            )

        # ---- build exchange: cold rows shuffle, hot rows replicate --------
        bucket_b_id = (hb % _N_BUCKETS).astype(jnp.int32)
        b_hot = hot[bucket_b_id] & bvalid
        dest_b = jnp.where(
            bvalid & jnp.logical_not(b_hot),
            (hb % jnp.uint64(n_dev)).astype(jnp.int32),
            n_dev,
        )
        b_send = tuple(e for e, _ in bk) + tuple(bpay) + (brow,)
        b_cold, bm_cold, ovf_b = _exchange_rows(b_send, dest_b, n_dev, bucket_b, axis)
        ovf_hot = jnp.maximum(
            jnp.sum(b_hot.astype(jnp.int64)) - hot_capacity, 0
        )
        hot_order = jnp.argsort(jnp.logical_not(b_hot), stable=True)[:hot_capacity]
        b_hot_rows = tuple(
            jax.lax.all_gather(a[hot_order], axis).reshape(-1) for a in b_send
        )
        hmask = jax.lax.all_gather(b_hot[hot_order], axis).reshape(-1)

        b_all = tuple(
            jnp.concatenate([c, h]) for c, h in zip(b_cold, b_hot_rows)
        )
        bm_all = jnp.concatenate([bm_cold, hmask])

        # ---- sort build by rowid (dead slots last): local position order
        # becomes the single-device insertion order ------------------------
        brow_all = b_all[-1]
        sort_in = (
            jnp.logical_not(bm_all).astype(jnp.int32),
            brow_all,
        ) + tuple(b_all[:-1]) + (bm_all.astype(jnp.int32),)
        sort_out = jax.lax.sort(sort_in, num_keys=2, is_stable=False)
        brow_s = sort_out[1]
        b_sorted = sort_out[2 : 2 + nk + nb_pay]
        bm_s = sort_out[-1] > 0

        # ---- per-probe match ranges over the rowid-ordered build ----------
        l_ops = []
        for j in range(nk):
            l_ops += [bm_s.astype(jnp.int32), b_sorted[j]]
        if ring:
            # ring-staged probe exchange: ppermute hops overlap the
            # per-chunk rank sorts; outputs bit-identical to the
            # monolithic all_to_all + single rank pass
            p_recv, pm, starts, counts, order, ovf_p = _ring_probe_ranks(
                p_send, dest_p, n_dev, bucket_p, axis, tuple(l_ops), nk
            )
        else:
            r_ops = []
            for j in range(nk):
                r_ops += [pm.astype(jnp.int32), p_recv[j]]
            starts, counts, order, _tot = _pairs_phase_a(
                tuple(l_ops), tuple(r_ops), 2 * nk
            )
        m_local = jnp.max(counts)

        overflow = jax.lax.psum(ovf_p + ovf_b + ovf_hot, axis)
        m_glob = jax.lax.pmax(m_local, axis)
        return (
            tuple(b_sorted)
            + (brow_s, bm_s)
            + tuple(p_recv)
            + (pm, starts, counts, order, overflow[None], n_hot[None], m_glob[None])
        )

    out_specs = (P(axis),) * (nk + nb_pay + 2 + nk + np_pay + 1 + 1 + 3) + (
        P(), P(), P(),
    )
    outs = spmd(
        local,
        mesh=mesh,
        in_specs=(P(axis),) * len(args),
        out_specs=out_specs,
    )(*args)

    i = 0
    b_sorted = outs[i : i + nk + nb_pay]; i += nk + nb_pay
    brow_s = outs[i]; i += 1
    bm_s = outs[i]; i += 1
    p_recv = outs[i : i + nk + np_pay + 1]; i += nk + np_pay + 1
    pm = outs[i]; i += 1
    starts = outs[i]; i += 1
    counts = outs[i]; i += 1
    order = outs[i]; i += 1
    overflow = int(np.max(np.asarray(outs[i]))); i += 1
    n_hot = int(np.max(np.asarray(outs[i]))); i += 1
    m = int(np.max(np.asarray(outs[i])))
    return ShuffleJoinPhaseA(
        build_arrays=tuple(b_sorted) + (brow_s,),
        build_mask=bm_s,
        probe_arrays=tuple(p_recv),
        probe_mask=pm,
        starts=starts,
        counts=counts,
        order=order,
        overflow=overflow,
        n_hot_buckets=n_hot,
        m=m,
    )


def shuffle_join_phase_b(
    mesh, a: ShuffleJoinPhaseA, n_keys: int, n_b_payload: int, axis="x"
):
    """Expand match ranges into m-wide probe strips. Returns
    (build payload cells, probe payload cells, probe rowid cells, alive
    cells) — all sharded P(axis), flat (local_probe_rows * m per shard).

    rowid_out = probe_rowid * m + slot reproduces the single-device pair
    emission sequence exactly (see module docstring)."""
    m = max(a.m, 1)
    b_pay = a.build_arrays[n_keys : n_keys + n_b_payload]
    p_pay = a.probe_arrays[n_keys:-1]
    p_rowid = a.probe_arrays[-1]
    args = (a.starts, a.counts, a.order, p_rowid) + tuple(b_pay)
    n_bp = len(b_pay)
    n_pp = len(p_pay)

    def local(starts, counts, order, prow, *pays):
        bpays = pays[:n_bp]
        ppays = pays[n_bp:]
        nb_local = order.shape[0]
        j = jnp.arange(m, dtype=jnp.int64)
        cand_pos = starts[:, None] + j[None, :]
        cand = order[jnp.clip(cand_pos, 0, max(nb_local - 1, 0))]
        have = j[None, :] < counts[:, None]
        out = []
        for arr in bpays:
            out.append(arr[cand].reshape(-1))
        for arr in ppays:
            out.append(jnp.repeat(arr, m))
        rowid_out = (prow[:, None] * m + j[None, :]).reshape(-1)
        return tuple(out) + (rowid_out, have.reshape(-1))

    outs = spmd(
        local,
        mesh=mesh,
        in_specs=(P(axis),) * (4 + n_bp + n_pp),
        out_specs=(P(axis),) * (n_bp + n_pp + 2),
    )(*(args + tuple(p_pay)))
    b_cells = outs[:n_bp]
    p_cells = outs[n_bp : n_bp + n_pp]
    rowid_out = outs[-2]
    alive = outs[-1]
    return b_cells, p_cells, rowid_out, alive


# ---- fused ring aggregate-over-join ------------------------------------------


def _blockify(arr, fill):
    """Pad to a multiple of 128 and reshape to (n_blocks, 128)."""
    n = arr.shape[0]
    pad = (-n) % _BLK
    if pad:
        arr = jnp.concatenate([arr, jnp.full((pad,), fill, arr.dtype)])
    return arr.reshape(-1, _BLK)


def ring_agg_join(
    mesh,
    f_enc,      # int64 encoded fact join key, P(axis)
    f_ok,       # bool: fact row participates (alive & key valid), P(axis)
    f_rowid,    # int64 global fact row position, P(axis)
    sum_cols,   # list of arrays to range-sum (pre-masked: invalid -> 0)
    mm_specs,   # list of (mm_key int64 directed+invalid-masked, raw) pairs
    d_enc,      # int64 encoded dim join key, P(axis)
    d_ok,       # bool: dim row alive & key valid, P(axis)
    axis="x",
):
    """Fused ring join + per-dim-row aggregation: the SQL-reachable
    generalization of dist_join_groupby_ring (SURVEY.md §2.3 "pipeline
    parallelism"). ONE shard_map program, no host syncs, no exchange and
    hence no overflow/retry: fact rows never move; the dim chunk rotates
    around the ring via lax.ppermute (issued before the probe compute it
    does not depend on, so XLA overlaps transfer with compute), and each
    shard answers the resident chunk's per-key range queries against its
    locally sorted fact rows.

    Per dim row (aligned with the dim side's P(axis) layout) returns:
      counts    int64: matching fact rows (count(*) partial)
      sums      one array per sum_cols entry: range sums (sum / count(col)
                partials — count(col) is the sum of col's validity ints)
      min_rowid int64: minimum fact rowid among matches (INT64_MAX when
                none) — the first-appearance order seed
      mm_outs   one (raw, mm_key) pair per mm_specs entry: the raw value
                whose directed key is minimal in the row's match range
                (min -> encode ascending, max -> bitwise-NOT the encoding;
                invalid rows must be pre-masked to INT64_MAX so they sort
                after every real value)

    The sums ride the same base sort as the ranks: the fact side is sorted
    once by (key, rowid) carrying every sum column as payload (variadic
    sort cost is ~flat in operand count — CLAUDE.md), each min/max column
    adds one extra (key, mm_key) sort, and every range answer is a
    prefix-sum difference or a single gather at the range start.
    """
    from sqlrs_tpu.ops.pipelines import _sorted_ranks_left

    n_dev = mesh.shape[axis]
    n_sum = len(sum_cols)
    n_mm = len(mm_specs)
    d_cap = d_enc.shape[0]
    chunk = d_cap // n_dev
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    args = (
        [f_enc, f_ok, f_rowid]
        + list(sum_cols)
        + [a for pair in mm_specs for a in pair]
        + [d_enc, d_ok]
    )

    def local(f_enc_l, f_ok_l, f_rowid_l, *rest):
        scols = rest[:n_sum]
        mmflat = rest[n_sum : n_sum + 2 * n_mm]
        d_enc_l, d_ok_l = rest[-2:]
        n_local = f_enc_l.shape[0]
        key = jnp.where(f_ok_l, f_enc_l, _MAXK)

        # ---- base sort: (key, rowid) + sum payloads -----------------------
        base = jax.lax.sort(
            (key, f_rowid_l) + tuple(scols), num_keys=2
        )
        ks, rid_s = base[0], base[1]
        k2d = _blockify(ks, _MAXK)
        nb = k2d.shape[0]
        sum_tables = []
        for sv in base[2:]:
            v2d = _blockify(sv, jnp.zeros((), sv.dtype))
            bs = jnp.sum(v2d, axis=1)
            bp = jnp.concatenate([jnp.cumsum(bs) - bs, jnp.sum(bs)[None]])
            sum_tables.append((v2d, bp))

        # ---- one extra sort per min/max column ----------------------------
        mm_sorted = []  # (mm_key_sorted, raw_sorted)
        for j in range(n_mm):
            mk, raw = mmflat[2 * j], mmflat[2 * j + 1]
            _, mk_s, raw_s = jax.lax.sort((key, mk, raw), num_keys=2)
            mm_sorted.append((mk_s, raw_s))

        lane = jnp.arange(_BLK, dtype=jnp.int32)

        def prefix_at(tbl, pos):
            v2d, bp = tbl
            b = pos // _BLK
            rem = (pos % _BLK).astype(jnp.int32)
            rows = v2d[jnp.clip(b, 0, nb - 1)]
            part = jnp.sum(
                jnp.where(lane[None, :] < rem[:, None], rows, 0), axis=1
            )
            return bp[b] + part

        big_rid = jnp.int64(np.iinfo(np.int64).max)
        pos0 = jax.lax.axis_index(axis).astype(jnp.int64) * chunk

        def step(carry, _):
            d_enc_c, d_pos_c, d_ok_c, accs = carry
            # next chunk's transfer first: independent of the range queries,
            # so the ppermute overlaps the probe compute below
            d_enc_n = jax.lax.ppermute(d_enc_c, axis, perm)
            d_pos_n = jax.lax.ppermute(d_pos_c, axis, perm)
            d_ok_n = jax.lax.ppermute(d_ok_c, axis, perm)

            dlo = jnp.where(d_ok_c, d_enc_c, _MAXK)
            dhi = jnp.where(d_ok_c, d_enc_c + 1, _MAXK)
            g = dlo.shape[0]
            ranks = _sorted_ranks_left(k2d, jnp.concatenate([dlo, dhi]))
            lo, hi = ranks[:g], ranks[g:]
            cnt = hi - lo
            lo_c = jnp.clip(lo, 0, max(n_local - 1, 0))

            # each dim position is resident exactly once per shard, so the
            # scatters below hit disjoint targets across the n_dev steps
            tgt = jnp.where(d_ok_c, d_pos_c, d_cap)
            (cnt_a, rid_a, sum_as, mm_as) = accs
            cnt_a = cnt_a.at[tgt].add(cnt)
            rid_a = rid_a.at[tgt].min(
                jnp.where(cnt > 0, rid_s[lo_c], big_rid)
            )
            sum_as = tuple(
                a.at[tgt].add(prefix_at(tbl, hi) - prefix_at(tbl, lo))
                for a, tbl in zip(sum_as, sum_tables)
            )
            # disjoint targets ⇒ plain masked writes; rows with no match
            # keep the MAXK/zero initializers
            tgt_hit = jnp.where(d_ok_c & (cnt > 0), d_pos_c, d_cap)
            mm_as = tuple(
                (
                    ka.at[tgt_hit].set(mk_s[lo_c]),
                    ra.at[tgt_hit].set(raw_s[lo_c]),
                )
                for (ka, ra), (mk_s, raw_s) in zip(mm_as, mm_sorted)
            )
            return (d_enc_n, d_pos_n, d_ok_n, (cnt_a, rid_a, sum_as, mm_as)), None

        vary = jnp.sum(f_rowid_l) * 0  # make accumulators mesh-axis-varying
        init_accs = (
            jnp.zeros((d_cap + 1,), jnp.int64) + vary,
            jnp.full((d_cap + 1,), big_rid) + vary,
            tuple(
                jnp.zeros((d_cap + 1,), sv.dtype) + vary.astype(sv.dtype)
                for sv in scols
            ),
            tuple(
                (
                    jnp.full((d_cap + 1,), _MAXK) + vary,
                    jnp.zeros((d_cap + 1,), raw.dtype)
                    + vary.astype(raw.dtype),
                )
                for _mk, raw in mm_sorted
            ),
        )
        d_pos_l = pos0 + jnp.arange(chunk, dtype=jnp.int64)
        (_, _, _, accs), _ = jax.lax.scan(
            step, (d_enc_l, d_pos_l, d_ok_l, init_accs), None, length=n_dev
        )
        cnt_a, rid_a, sum_as, mm_as = accs

        # ---- cross-shard combine + slice own chunk ------------------------
        idx = jax.lax.axis_index(axis)
        start = (idx * chunk,)

        def own(a):
            return jax.lax.dynamic_slice(a[:d_cap], start, (chunk,))

        cnt_g = own(jax.lax.psum(cnt_a[:d_cap], axis))
        rid_g = own(jax.lax.pmin(rid_a[:d_cap], axis))
        sums_g = tuple(own(jax.lax.psum(a[:d_cap], axis)) for a in sum_as)
        mm_g = []
        for ka, ra in mm_as:
            kk = ka[:d_cap]
            gmin = jax.lax.pmin(kk, axis)
            mine = kk == gmin
            shard_sel = jax.lax.pmin(
                jnp.where(mine, idx, n_dev).astype(jnp.int32), axis
            )
            raw_g = jax.lax.psum(
                jnp.where(
                    mine & (shard_sel == idx), ra[:d_cap],
                    jnp.zeros((), ra.dtype),
                ),
                axis,
            )
            mm_g.append((own(raw_g), own(gmin)))
        return (
            (cnt_g, rid_g)
            + sums_g
            + tuple(a for pair in mm_g for a in pair)
        )

    outs = spmd(
        local,
        mesh=mesh,
        in_specs=(P(axis),) * len(args),
        out_specs=(P(axis),) * (2 + n_sum + 2 * n_mm),
    )(*args)
    counts, min_rowid = outs[0], outs[1]
    sums = outs[2 : 2 + n_sum]
    mm_outs = [
        (outs[2 + n_sum + 2 * j], outs[2 + n_sum + 2 * j + 1])
        for j in range(n_mm)
    ]
    return counts, sums, min_rowid, mm_outs


def broadcast_agg_join(
    mesh,
    f_enc,
    f_ok,
    f_rowid,
    sum_cols,
    mm_specs,
    d_enc,
    d_ok,
    axis="x",
):
    """Broadcast sibling of ring_agg_join for SMALL dim sides — the
    distributed unification of the single-device fused star-rollup route
    (round-4 VERDICT item 5): instead of materializing join pairs per shard
    and re-aggregating through the general sorted path, each shard runs the
    join_groupby_direct formulation (one local fact sort + merge-ranked
    range queries) against the FULL dim side, replicated by ONE tiled
    all_gather (O(G) bytes), and the per-dim-row partials combine with one
    psum/pmin. Compared to the ring: 2 collective launches instead of
    n_dev ppermute steps — the right trade when the dim side fits
    comfortably in every shard (the auto policy's small-build regime).

    Same argument and return contract as ring_agg_join: per-LOCAL-dim-row
    (counts, sums, min_rowid, mm_outs), aligned with the dim side's
    P(axis) layout."""
    from sqlrs_tpu.ops.pipelines import _sorted_ranks_left

    n_dev = mesh.shape[axis]
    n_sum = len(sum_cols)
    n_mm = len(mm_specs)
    d_cap = d_enc.shape[0]
    chunk = d_cap // n_dev
    args = (
        [f_enc, f_ok, f_rowid]
        + list(sum_cols)
        + [a for pair in mm_specs for a in pair]
        + [d_enc, d_ok]
    )

    def local(f_enc_l, f_ok_l, f_rowid_l, *rest):
        scols = rest[:n_sum]
        mmflat = rest[n_sum : n_sum + 2 * n_mm]
        d_enc_l, d_ok_l = rest[-2:]
        n_local = f_enc_l.shape[0]
        key = jnp.where(f_ok_l, f_enc_l, _MAXK)

        # ---- local fact probe tables (identical to the ring's) -----------
        base = jax.lax.sort((key, f_rowid_l) + tuple(scols), num_keys=2)
        ks, rid_s = base[0], base[1]
        k2d = _blockify(ks, _MAXK)
        nb = k2d.shape[0]
        sum_tables = []
        for sv in base[2:]:
            v2d = _blockify(sv, jnp.zeros((), sv.dtype))
            bs = jnp.sum(v2d, axis=1)
            bp = jnp.concatenate([jnp.cumsum(bs) - bs, jnp.sum(bs)[None]])
            sum_tables.append((v2d, bp))
        mm_sorted = []
        for j in range(n_mm):
            mk, raw = mmflat[2 * j], mmflat[2 * j + 1]
            _, mk_s, raw_s = jax.lax.sort((key, mk, raw), num_keys=2)
            mm_sorted.append((mk_s, raw_s))

        lane = jnp.arange(_BLK, dtype=jnp.int32)

        def prefix_at(tbl, pos):
            v2d, bp = tbl
            b = pos // _BLK
            rem = (pos % _BLK).astype(jnp.int32)
            rows = v2d[jnp.clip(b, 0, nb - 1)]
            part = jnp.sum(
                jnp.where(lane[None, :] < rem[:, None], rows, 0), axis=1
            )
            return bp[b] + part

        # ---- broadcast the dim side: ONE tiled all_gather (O(G)) ---------
        d_enc_g = jax.lax.all_gather(d_enc_l, axis, tiled=True)
        d_ok_g = jax.lax.all_gather(d_ok_l, axis, tiled=True)
        dlo = jnp.where(d_ok_g, d_enc_g, _MAXK)
        dhi = jnp.where(d_ok_g, d_enc_g + 1, _MAXK)
        ranks = _sorted_ranks_left(k2d, jnp.concatenate([dlo, dhi]))
        lo, hi = ranks[:d_cap], ranks[d_cap:]
        cnt = hi - lo
        lo_c = jnp.clip(lo, 0, max(n_local - 1, 0))
        big_rid = jnp.int64(np.iinfo(np.int64).max)
        rid_l = jnp.where(cnt > 0, rid_s[lo_c], big_rid)
        sums_l = [
            prefix_at(tbl, hi) - prefix_at(tbl, lo) for tbl in sum_tables
        ]
        mm_l = [
            (
                jnp.where(cnt > 0, mk_s[lo_c], _MAXK),
                raw_s[lo_c],
            )
            for mk_s, raw_s in mm_sorted
        ]

        # ---- one psum/pmin combine + own-chunk slice ---------------------
        idx = jax.lax.axis_index(axis)
        start = (idx.astype(jnp.int64) * chunk,)

        def own(a):
            return jax.lax.dynamic_slice(a, start, (chunk,))

        cnt_g = own(jax.lax.psum(cnt, axis))
        rid_g = own(jax.lax.pmin(rid_l, axis))
        sums_g = tuple(own(jax.lax.psum(a, axis)) for a in sums_l)
        mm_g = []
        for kk, ra in mm_l:
            gmin = jax.lax.pmin(kk, axis)
            mine = kk == gmin
            shard_sel = jax.lax.pmin(
                jnp.where(mine, idx, n_dev).astype(jnp.int32), axis
            )
            raw_g = jax.lax.psum(
                jnp.where(
                    mine & (shard_sel == idx), ra, jnp.zeros((), ra.dtype)
                ),
                axis,
            )
            mm_g.append((own(raw_g), own(gmin)))
        return (
            (cnt_g, rid_g)
            + sums_g
            + tuple(a for pair in mm_g for a in pair)
        )

    outs = spmd(
        local,
        mesh=mesh,
        in_specs=(P(axis),) * len(args),
        out_specs=(P(axis),) * (2 + n_sum + 2 * n_mm),
    )(*args)
    counts, min_rowid = outs[0], outs[1]
    sums = outs[2 : 2 + n_sum]
    mm_outs = [
        (outs[2 + n_sum + 2 * j], outs[2 + n_sum + 2 * j + 1])
        for j in range(n_mm)
    ]
    return counts, sums, min_rowid, mm_outs


def pair_local_dedup(mesh, keys, vals, ok, axis="x"):
    """Shard-local sorted-unique over (key, value) pairs: sort the pairs
    (num_keys=2, no scatter — output stays in sorted order, which is all a
    SET needs) and flag first occurrences. The building block of the
    cross-shard DISTINCT path: dedup locally, exchange by key hash
    (partition_shuffle), dedup again — every surviving (key, value) pair
    is then globally unique and lives on exactly one shard."""
    def local(k, v, o):
        kk = jnp.where(o, k, _MAXK)
        sk, sv = jax.lax.sort((kk, v), num_keys=2)
        first = jnp.concatenate(
            [
                jnp.ones((1,), jnp.bool_),
                (sk[1:] != sk[:-1]) | (sv[1:] != sv[:-1]),
            ]
        )
        keep = first & (sk != _MAXK)
        return sk, sv, keep

    return spmd(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
    )(keys, vals, ok)
