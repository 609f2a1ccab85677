"""Hash-table kernel and fused-pipeline tests (numpy oracles)."""

import numpy as np
import pytest

import sqlrs_tpu  # noqa: F401
import jax.numpy as jnp

from sqlrs_tpu.ops.hash_table import (
    EMPTY,
    build_table,
    hash_group_aggregate,
    hash_join_pairs,
    next_pow2,
)
from sqlrs_tpu.ops.pipelines import make_join_groupby


def test_build_table_assigns_unique_slots():
    keys = jnp.asarray(np.array([5, 5, 9, 9, 9, 1, 2, 3], dtype=np.int64))
    table, slot = build_table(keys, 16)
    table, slot = np.asarray(table), np.asarray(slot)
    # same key -> same slot; different keys -> different slots
    by_key = {}
    for k, s in zip(np.asarray(keys), slot):
        by_key.setdefault(int(k), set()).add(int(s))
    assert all(len(v) == 1 for v in by_key.values())
    slots = {next(iter(v)) for v in by_key.values()}
    assert len(slots) == len(by_key)
    for k, v in by_key.items():
        assert table[next(iter(v))] == k


def test_hash_group_aggregate_matches_numpy():
    rng = np.random.default_rng(42)
    keys = rng.integers(0, 517, size=20_000).astype(np.int64)
    vals = rng.integers(-100, 100, size=20_000).astype(np.int64)
    cap = next_pow2(2 * 517)
    table, sums, counts, mins, maxs = hash_group_aggregate(
        jnp.asarray(keys), jnp.asarray(vals), cap
    )
    table, sums, counts = np.asarray(table), np.asarray(sums), np.asarray(counts)
    mins, maxs = np.asarray(mins), np.asarray(maxs)
    live = table != np.int64(-(2**63))
    import collections

    es, ec = collections.defaultdict(int), collections.defaultdict(int)
    emin, emax = {}, {}
    for k, v in zip(keys, vals):
        k = int(k)
        es[k] += int(v)
        ec[k] += 1
        emin[k] = min(emin.get(k, 10**9), int(v))
        emax[k] = max(emax.get(k, -(10**9)), int(v))
    got = {
        int(k): (int(s), int(c), int(mn), int(mx))
        for k, s, c, mn, mx in zip(
            table[live], sums[live], counts[live], mins[live], maxs[live]
        )
    }
    assert set(got) == set(es)
    for k in es:
        assert got[k] == (es[k], ec[k], emin[k], emax[k])


def test_hash_join_pairs_matches_numpy_and_order():
    rng = np.random.default_rng(7)
    bk = rng.integers(0, 300, size=2_000).astype(np.int64)
    pk = rng.integers(0, 400, size=3_000).astype(np.int64)
    br, pr, live, total = hash_join_pairs(jnp.asarray(bk), jnp.asarray(pk))
    total = int(total)
    br = np.asarray(br)[:total]
    pr = np.asarray(pr)[:total]
    from collections import defaultdict

    bm = defaultdict(list)
    for i, k in enumerate(bk):
        bm[int(k)].append(i)
    exp = [(i, j) for j, k in enumerate(pk) for i in bm.get(int(k), [])]
    got = list(zip(br.tolist(), pr.tolist()))
    assert sorted(got) == sorted(exp)
    # probe-order emission (reference hash_join.rs:207-250)
    assert all(got[i][1] <= got[i + 1][1] for i in range(len(got) - 1))


def test_join_pairs_no_hash_collision_false_matches():
    # keys engineered to collide in small tables: full-key re-check must
    # reject them (fixes reference TODO hash_join.rs:221-224)
    bk = jnp.asarray(np.array([0, 16, 32, 48], dtype=np.int64))
    pk = jnp.asarray(np.array([64, 80, 0], dtype=np.int64))
    br, pr, live, total = hash_join_pairs(bk, pk)
    total = int(total)
    assert total == 1
    assert int(np.asarray(br)[0]) == 0 and int(np.asarray(pr)[0]) == 2


def test_fused_join_groupby_pipeline():
    rng = np.random.default_rng(3)
    n, groups = 50_000, 128
    gid = rng.integers(0, groups, n)
    dim_keys = np.arange(groups, dtype=np.int64) * 13 + 5
    fk = jnp.asarray(dim_keys[gid])
    fv = jnp.asarray(rng.integers(0, 50, n).astype(np.int64))
    fn = make_join_groupby(groups)
    sums, counts = fn(fk, fv, jnp.asarray(dim_keys))
    exp_s = np.zeros(groups, np.int64)
    exp_c = np.zeros(groups, np.int64)
    np.add.at(exp_s, gid, np.asarray(fv))
    np.add.at(exp_c, gid, 1)
    assert np.array_equal(np.asarray(sums), exp_s)
    assert np.array_equal(np.asarray(counts), exp_c)


def test_packed_pipeline_matches_plain():
    from sqlrs_tpu.ops.pipelines import make_join_groupby

    rng = np.random.default_rng(9)
    n, groups = 60_000, 300
    gid = rng.integers(0, groups, n)
    dim_keys = np.arange(groups, dtype=np.int64) * 977 + 11
    fk = jnp.asarray(dim_keys[gid])
    fv = jnp.asarray(rng.integers(0, 128, n).astype(np.int64))
    dk = jnp.asarray(dim_keys)
    s1, c1 = make_join_groupby(groups, strategy="sorted")(fk, fv, dk)
    s2, c2 = make_join_groupby(groups, strategy="sorted_packed")(fk, fv, dk, val_bits=8)
    assert np.array_equal(np.asarray(s1), np.asarray(s2))
    assert np.array_equal(np.asarray(c1), np.asarray(c2))
    # the direct (headline) strategy must agree too, in both packings
    s3, c3 = make_join_groupby(groups, strategy="direct")(fk, fv, dk, 8, False)
    s4, c4 = make_join_groupby(groups, strategy="direct")(fk, fv, dk, 8, True)
    assert np.array_equal(np.asarray(s1), np.asarray(s3))
    assert np.array_equal(np.asarray(c1), np.asarray(c3))
    assert np.array_equal(np.asarray(s1), np.asarray(s4))
    assert np.array_equal(np.asarray(c1), np.asarray(c4))


def test_direct_pipeline_misses_and_odd_sizes():
    from sqlrs_tpu.ops.pipelines import make_join_groupby

    rng = np.random.default_rng(11)
    n, groups = 9_973, 64  # prime n exercises block padding
    gid = rng.integers(0, groups, n)
    dim_keys = np.arange(groups, dtype=np.int64) * 1013904223 + 12345
    fk = dim_keys[gid].copy()
    fk[::11] = 7  # misses (absent from dim)
    fv = rng.integers(0, 100, n).astype(np.int64)
    m = fk != 7
    exp_s = np.zeros(groups, np.int64)
    exp_c = np.zeros(groups, np.int64)
    np.add.at(exp_s, gid[m], fv[m])
    np.add.at(exp_c, gid[m], 1)
    s, c = make_join_groupby(groups, strategy="direct")(
        jnp.asarray(fk), jnp.asarray(fv), jnp.asarray(dim_keys)
    )
    assert np.array_equal(np.asarray(s), exp_s)
    assert np.array_equal(np.asarray(c), exp_c)


def test_direct_pipeline_dense_boundary_sharing():
    """Dense (consecutive) dim keys auto-select the G+1 shared-boundary
    rank stage; it must stay exact with misses on BOTH sides of the dim
    span (out-of-span fact keys are excluded by the boundary differences)
    and agree with the general 2G-query path, in both packings."""
    from sqlrs_tpu.ops.pipelines import make_join_groupby

    rng = np.random.default_rng(13)
    n, groups = 10_007, 96
    base = 50  # dim keys are [50, 146) — dense but not starting at 0
    gid = rng.integers(0, groups, n)
    dim_keys = np.arange(groups, dtype=np.int64) + base
    fk = dim_keys[gid].copy()
    fk[::7] = 3  # misses below the dim span
    fk[5::13] = base + groups + 9  # misses above the dim span
    fv = rng.integers(0, 100, n).astype(np.int64)
    m = (fk >= base) & (fk < base + groups)
    exp_s = np.zeros(groups, np.int64)
    exp_c = np.zeros(groups, np.int64)
    np.add.at(exp_s, gid[m], fv[m])
    np.add.at(exp_c, gid[m], 1)
    fn = make_join_groupby(groups, strategy="direct")
    for pack32 in (False, True):
        s, c = fn(
            jnp.asarray(fk), jnp.asarray(fv), jnp.asarray(dim_keys),
            val_bits=7, pack32=pack32,
            dim_min=base, dim_max=base + groups - 1,
        )
        assert np.array_equal(np.asarray(s), exp_s), pack32
        assert np.array_equal(np.asarray(c), exp_c), pack32
        # general path on the same inputs agrees
        s2, c2 = fn(
            jnp.asarray(fk), jnp.asarray(fv), jnp.asarray(dim_keys),
            val_bits=7, pack32=pack32,
        )
        assert np.array_equal(np.asarray(s), np.asarray(s2))
        assert np.array_equal(np.asarray(c), np.asarray(c2))


def test_sort_based_filter_compaction():
    """Filters over >=2^18 rows take the stable flag-sort compaction path;
    results and row order must match the small-batch gather path."""
    import sqlrs_tpu
    from sqlrs_tpu.data import DeviceBatch, Schema
    from sqlrs_tpu.types import LogicalType as LT

    n = (1 << 18) + 123
    rng = np.random.default_rng(5)
    v = rng.integers(0, 1000, n).astype(np.int64)
    w = rng.integers(0, 10, n).astype(np.int64)
    null_mask = rng.random(n) < 0.1
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "big",
        DeviceBatch.from_pydict(
            Schema.of([("v", LT.BIGINT), ("w", LT.BIGINT)]),
            {
                "v": [None if m else int(x) for x, m in zip(v, null_mask)],
                "w": w.tolist(),
            },
        ),
    )
    got = db.run("select v, w from big where v < 100 and w = 3")[0]
    keep = (~null_mask) & (v < 100) & (w == 3)
    exp_v = v[keep]
    got_v = np.asarray(got.columns[0].data)
    assert got.num_rows == int(keep.sum())
    assert np.array_equal(got_v, exp_v)  # original row order preserved
    assert np.array_equal(np.asarray(got.columns[1].data), w[keep])


@pytest.mark.parametrize("bits,hi", [(7, 100), (23, 1 << 23)])
def test_direct_pipeline_dense_metadata_matches_numpy(bits, hi):
    """make_join_groupby with catalog-style metadata (key/value ranges and
    a dense dim span, as bench.py passes it): exact int64 sums and counts
    with misses on both sides of the span, for 7-bit and 23-bit values."""
    rng = np.random.default_rng(7)
    n, g = 70_000, 700  # non-multiple of every block size
    keys = rng.integers(0, g, n).astype(np.int64)
    keys[::11] = -3
    keys[::17] = g + 9
    m = (keys >= 0) & (keys < g)
    vals = rng.integers(0, hi, n).astype(np.int64)
    exp_s = np.bincount(keys[m], weights=vals[m], minlength=g).astype(np.int64)
    exp_c = np.bincount(keys[m], minlength=g)
    s, c = make_join_groupby(g, strategy="direct")(
        jnp.asarray(keys), jnp.asarray(vals),
        jnp.asarray(np.arange(g, dtype=np.int64)),
        key_max=g + 9, val_max=int(vals.max()), dim_min=0, dim_max=g - 1,
    )
    assert np.array_equal(np.asarray(s), exp_s), bits
    assert np.array_equal(np.asarray(c), exp_c), bits


def test_match_counts_pack2_differential(monkeypatch):
    """2-key mark-join counts with the packed-operand path forced on must
    be bit-identical to the unpacked path and a numpy brute force,
    including NULLs in either key column and out-of-overlap keys."""
    import numpy as np

    import sqlrs_tpu.ops.join as J
    from sqlrs_tpu.data import Column
    from sqlrs_tpu.types import LogicalType as LT

    rng = np.random.default_rng(23)
    nb, np_ = 800, 1100
    bk1 = rng.integers(-50, 50, nb)
    bk2 = rng.integers(1000, 1030, nb)
    pk1 = rng.integers(-60, 60, np_)
    pk2 = rng.integers(995, 1035, np_)
    bv1 = rng.random(nb) > 0.1
    bv2 = rng.random(nb) > 0.1
    pv1 = rng.random(np_) > 0.1
    pv2 = rng.random(np_) > 0.1

    def cols(k1, v1, k2, v2):
        return [
            Column(LT.BIGINT, jnp.asarray(k1), jnp.asarray(v1)),
            Column(LT.BIGINT, jnp.asarray(k2), jnp.asarray(v2)),
        ]

    build = cols(bk1, bv1, bk2, bv2)
    probe = cols(pk1, pv1, pk2, pv2)
    monkeypatch.setattr(J, "_PACK2_MIN_ROWS", 1 << 60)
    plain = np.asarray(J.match_counts(build, probe))
    monkeypatch.setattr(J, "_PACK2_MIN_ROWS", 0)
    packed = np.asarray(J.match_counts(build, probe))
    assert np.array_equal(plain, packed)
    # brute force
    ok_b = bv1 & bv2
    exp = np.zeros(np_, dtype=np.int64)
    for i in range(np_):
        if pv1[i] and pv2[i]:
            exp[i] = int(
                np.sum(ok_b & (bk1 == pk1[i]) & (bk2 == pk2[i]))
            )
    assert np.array_equal(packed, exp)
