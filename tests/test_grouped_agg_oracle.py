"""Sorted-run GROUP BY (ops/grouped_agg.py) against Python/numpy oracles on
the small-group-domain shapes TPC-H Q1 produces: signed integer sums,
values at 24-bit boundaries, 2/4/6-decimal-place DOUBLE measures, NULL keys
under an alive mask, group counts around 1024 and at 2^16, and the Q1 SQL
shape end to end. Outputs keep the reference's first-appearance group order
(reference src/executor/aggregate/hash_agg.rs:85-111).
"""

import collections
from decimal import Decimal

import numpy as np
import pytest

import sqlrs_tpu
from sqlrs_tpu.data import Column, DeviceBatch, Schema
from sqlrs_tpu.ops.grouped_agg import sorted_grouped_aggregate
from sqlrs_tpu.types import LogicalType as LT

import jax.numpy as jnp


def _col(t, data, valid=None):
    n = len(data)
    return Column(t, jnp.asarray(data),
                  jnp.ones(n, bool) if valid is None else jnp.asarray(valid))


def _oracle(keys_rows, vals, valids):
    """first-appearance-ordered keys and [count, sum, vcount] per group."""
    first = {}
    agg = collections.defaultdict(lambda: [0, 0, 0])
    for i, k in enumerate(keys_rows):
        first.setdefault(k, i)
        agg[k][0] += 1
        if valids[i]:
            agg[k][1] += vals[i]
            agg[k][2] += 1
    return sorted(first, key=first.get), agg


def test_int_sum_signed_first_appearance():
    rng = np.random.default_rng(7)
    n = 3000
    k = rng.integers(10, 26, n)
    v = rng.integers(-1000, 1000, n)
    vvalid = rng.random(n) > 0.15
    vc = _col(LT.BIGINT, v, vvalid)
    gcols, acols, ng = sorted_grouped_aggregate(
        [_col(LT.BIGINT, k)],
        [("count", None, LT.BIGINT), ("sum", vc, LT.BIGINT),
         ("count", vc, LT.BIGINT)],
    )
    order, agg = _oracle(k.tolist(), v.tolist(), vvalid)
    assert ng == len(order)
    assert np.asarray(gcols[0].data).tolist() == order
    for j, key in enumerate(order):
        for a in range(3):
            assert int(np.asarray(acols[a].data)[j]) == agg[key][a]
        # a group whose values are all NULL sums to NULL
        assert bool(np.asarray(acols[1].valid)[j]) == (agg[key][2] > 0)


@pytest.mark.parametrize("vmin", [0, -1])
def test_signed_values_sum(vmin):
    n = 1024
    v = np.full(n, vmin, dtype=np.int64)
    v[::2] = 100
    _, acols, ng = sorted_grouped_aggregate(
        [_col(LT.BIGINT, np.zeros(n, np.int64))],
        [("sum", _col(LT.BIGINT, v), LT.BIGINT)],
    )
    assert ng == 1
    assert int(np.asarray(acols[0].data)[0]) == int(v.sum())


@pytest.mark.parametrize("vmax", [(1 << 24) - 1, 1 << 24])
def test_values_at_24_bit_boundary(vmax):
    n = 2048
    v = np.zeros(n, dtype=np.int64)
    v[:100] = vmax
    k = np.arange(n, dtype=np.int64) % 4
    gcols, acols, ng = sorted_grouped_aggregate(
        [_col(LT.BIGINT, k)],
        [("sum", _col(LT.BIGINT, v), LT.BIGINT), ("count", None, LT.BIGINT)],
    )
    assert ng == 4
    gk = np.asarray(gcols[0].data)
    exp = np.bincount(k, weights=v).astype(np.int64)
    assert np.array_equal(np.asarray(acols[0].data), exp[gk])
    assert np.array_equal(np.asarray(acols[1].data), np.full(4, n // 4))


@pytest.mark.parametrize("g", [1024, 1025, 1 << 16])
def test_group_counts_match_bincount(g):
    """Around the old 1024-group matmul cap, and 2^16 groups over fewer
    rows than groups (most stay empty)."""
    rng = np.random.default_rng(9)
    n = 4096 if g <= 1025 else 1 << 15
    k = np.arange(n, dtype=np.int64) % g if g <= 1025 else rng.integers(0, g, n)
    v = rng.integers(0, (1 << 24) - 1, n)
    gcols, acols, ng = sorted_grouped_aggregate(
        [_col(LT.BIGINT, k)],
        [("sum", _col(LT.BIGINT, v), LT.BIGINT), ("count", None, LT.BIGINT)],
    )
    present = np.unique(k)
    assert ng == len(present)
    gk = np.asarray(gcols[0].data)
    _, first = np.unique(k, return_index=True)
    assert np.array_equal(gk, k[np.sort(first)])  # first-appearance order
    exp_s = np.bincount(k, weights=v.astype(np.float64), minlength=g)
    assert np.array_equal(np.asarray(acols[0].data), exp_s.astype(np.int64)[gk])
    assert np.array_equal(np.asarray(acols[1].data),
                          np.bincount(k, minlength=g)[gk])


def _decimal_measures(n, seed):
    rng = np.random.default_rng(seed)
    p = np.round(rng.uniform(900, 105000, n), 2)
    d = np.round(rng.uniform(0, 0.1, n), 2)
    t = np.round(rng.uniform(0, 0.08, n), 2)
    cents = [(int(round(pi * 100)), int(round(di * 100)), int(round(ti * 100)))
             for pi, di, ti in zip(p, d, t)]
    return {
        2: (p, [c[0] for c in cents]),
        4: (p * (1 - d), [c[0] * (100 - c[1]) for c in cents]),
        6: (p * (1 - d) * (1 + t),
            [c[0] * (100 - c[1]) * (100 + c[2]) for c in cents]),
    }


@pytest.mark.parametrize("dp", [2, 4, 6])
def test_double_decimal_measures(dp):
    """k-decimal-place DOUBLE measures (prices and their computed products)
    sum and average within 1e-9 of the Decimal-exact value."""
    n = 2000
    k = np.random.default_rng(3).integers(0, 3, n)
    vals, scaled = _decimal_measures(n, 3)[dp]
    cc = _col(LT.DOUBLE, vals)
    gcols, acols, ng = sorted_grouped_aggregate(
        [_col(LT.BIGINT, k)],
        [("sum", cc, LT.DOUBLE), ("avg", cc, LT.DOUBLE)],
    )
    gk = np.asarray(gcols[0].data)
    for j in range(ng):
        m = k == gk[j]
        exact = sum(s for s, mm in zip(scaled, m) if mm)
        exp = float(Decimal(exact) / Decimal(10 ** dp))
        got = float(np.asarray(acols[0].data)[j])
        assert abs(got - exp) <= 1e-9 * max(1.0, abs(exp))
        got_avg = float(np.asarray(acols[1].data)[j])
        assert abs(got_avg - exp / m.sum()) <= 1e-9 * max(1.0, abs(exp))


def test_null_keys_and_alive_mask():
    rng = np.random.default_rng(5)
    n = 1500
    k = rng.integers(0, 5, n)
    kvalid = rng.random(n) > 0.1  # NULL keys group together
    v = rng.integers(0, 100, n)
    alive = rng.random(n) > 0.3
    gcols, acols, ng = sorted_grouped_aggregate(
        [_col(LT.BIGINT, k, kvalid)],
        [("count", None, LT.BIGINT), ("sum", _col(LT.BIGINT, v), LT.BIGINT)],
        alive=jnp.asarray(alive),
    )
    live = np.nonzero(alive)[0]
    order, agg = _oracle(
        [int(k[i]) if kvalid[i] else None for i in live],
        [int(v[i]) for i in live], [True] * len(live),
    )
    assert ng == len(order)
    gk, gvv = np.asarray(gcols[0].data), np.asarray(gcols[0].valid)
    for j, key in enumerate(order):
        assert (int(gk[j]) if gvv[j] else None) == key
        assert int(np.asarray(acols[0].data)[j]) == agg[key][0]
        assert int(np.asarray(acols[1].data)[j]) == agg[key][1]


def test_sql_q1_shape():
    """The Q1 shape through the full engine against a numpy oracle."""
    rng = np.random.default_rng(11)
    n = 2500
    f = np.array(["A", "N", "R"])[rng.integers(0, 3, n)]
    q = rng.integers(1, 51, n)
    p = np.round(rng.uniform(900, 105000, n), 2)
    d = np.round(rng.uniform(0, 0.1, n), 2)
    db = sqlrs_tpu.Database()
    db.create_memory_table("li", DeviceBatch.from_pydict(
        Schema.of([("f", LT.VARCHAR), ("q", LT.BIGINT),
                   ("p", LT.DOUBLE), ("d", LT.DOUBLE)]),
        {"f": f.tolist(), "q": q.tolist(), "p": p.tolist(), "d": d.tolist()}))
    got = [tuple(r) for b in db.run(
        "select f, sum(q), sum(p*(1-d)), avg(p), count(*) from li "
        "where q < 45 group by f") for r in b.to_pylist()]
    m = q < 45
    flags = list(dict.fromkeys(f[m].tolist()))  # first appearance
    assert [r[0] for r in got] == flags
    for row, fl in zip(got, flags):
        sel = m & (f == fl)
        assert row[1] == int(q[sel].sum())
        assert row[2] == pytest.approx(float(np.sum(p[sel] * (1 - d[sel]))),
                                       rel=1e-9)
        assert row[3] == pytest.approx(float(p[sel].mean()), rel=1e-9)
        assert row[4] == int(sel.sum())
