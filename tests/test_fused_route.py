"""Order(HashAgg(HashJoin)) → join_groupby_direct routing (exec/fused_route.py).

Differential: every routed query is re-run with the route disabled and must
be bit-identical; numpy oracles double-check. Ineligible shapes must fall
back (and stay correct)."""

import numpy as np
import pytest

import sqlrs_tpu
from sqlrs_tpu.data import DeviceBatch, Schema
from sqlrs_tpu.types import LogicalType as LT


def _mk_db(fact_rows, dim_keys, seed=0, null_every=None):
    rng = np.random.default_rng(seed)
    dim = np.asarray(dim_keys, dtype=np.int64)
    gid = rng.integers(0, len(dim), fact_rows)
    fk = dim[gid].astype(np.int64)
    fk[::7] = 10_000_019  # misses above every dim key
    fv = rng.integers(0, 1000, fact_rows).astype(np.int64)
    fk_list = fk.tolist()
    if null_every:
        fk_list = [None if i % null_every == 0 else v
                   for i, v in enumerate(fk_list)]
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f",
        DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("v", LT.BIGINT)]),
            {"k": fk_list, "v": fv.tolist()},
        ),
    )
    db.create_memory_table(
        "d",
        DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]), {"k": dim.tolist()}
        ),
    )
    return db


def _both_ways(db, sql):
    """(routed_lines, unrouted_lines, route_fired)"""
    db.last_fused_routes = []
    routed = db.run_lines(sql)
    fired = list(db.last_fused_routes)
    db.enable_fused_route = False
    try:
        plain = db.run_lines(sql)
    finally:
        db.enable_fused_route = True
    return routed, plain, fired


SQL = ("select d.k, sum(f.v), count(*) from f join d on f.k = d.k "
       "group by d.k order by d.k")


@pytest.mark.parametrize("dim_keys", [
    np.arange(64) + 100,            # dense span
    np.arange(64) * 13 + 5,         # sparse
    np.arange(64) * 977 - 3000,     # negative keys
])
def test_route_matches_general_path(dim_keys):
    db = _mk_db(5000, dim_keys, seed=1)
    routed, plain, fired = _both_ways(db, SQL)
    assert fired, "route did not fire"
    assert routed == plain


def test_route_with_null_fact_keys_and_count_v():
    db = _mk_db(3000, np.arange(32) + 7, seed=2, null_every=11)
    sql = ("select d.k, count(f.v), sum(f.v) from f join d on f.k = d.k "
           "group by d.k order by d.k")
    routed, plain, fired = _both_ways(db, sql)
    assert fired
    assert routed == plain


def test_route_group_on_fact_side_key():
    db = _mk_db(2000, np.arange(16) * 3, seed=3)
    sql = ("select f.k, count(*) from f join d on f.k = d.k "
           "group by f.k order by f.k")
    routed, plain, fired = _both_ways(db, sql)
    assert fired
    assert routed == plain


def test_route_oracle():
    rng = np.random.default_rng(5)
    dim = (np.arange(48) * 7 + 1).astype(np.int64)
    n = 4096
    gid = rng.integers(0, 48, n)
    fk = dim[gid]
    fv = rng.integers(0, 100, n).astype(np.int64)
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("v", LT.BIGINT)]),
            {"k": fk.tolist(), "v": fv.tolist()}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]), {"k": dim.tolist()}))
    db.last_fused_routes = []
    got = db.run_lines(SQL)
    assert db.last_fused_routes
    exp_s = np.zeros(48, np.int64)
    exp_c = np.zeros(48, np.int64)
    np.add.at(exp_s, gid, fv)
    np.add.at(exp_c, gid, 1)
    exp = [f"{k} {s} {c}" for k, s, c in zip(dim, exp_s, exp_c) if c > 0]
    assert got == exp


def test_route_min_max_avg():
    db = _mk_db(4000, np.arange(40) * 3 + 11, seed=6)
    sql = ("select d.k, min(f.v), max(f.v), avg(f.v), count(*) "
           "from f join d on f.k = d.k group by d.k order by d.k")
    routed, plain, fired = _both_ways(db, sql)
    assert fired
    assert routed == plain


@pytest.mark.parametrize("sql,name", [
    # no ORDER BY: first-appearance group order must be reproduced exactly.
    # fact on the left (dim right): order = dim table's original row order
    ("select d.k, sum(f.v), count(*) from f join d on f.k = d.k group by d.k",
     "fact_left"),
    # fact on the right (dim left): order = first matching fact row
    ("select d.k, sum(f.v), count(*) from d join f on f.k = d.k group by d.k",
     "fact_right"),
    # avg and negative values (payload sums need no packing)
    ("select d.k, avg(f.v), count(f.v) from f join d on f.k = d.k group by d.k",
     "avg"),
])
def test_firstapp_route_matches_general_path(sql, name):
    # dim keys deliberately NOT in sorted order: first-appearance order
    # differs from key order, so ordering bugs cannot hide
    dim = np.array([50, 7, 93, 22, 68, 1, 39, 84, 15, 61], dtype=np.int64)
    rng = np.random.default_rng(8)
    n = 3000
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid]
    fk = fk.copy()
    fk[::9] = 999  # misses
    fv = rng.integers(-50, 50, n).astype(np.int64)  # negatives
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("v", LT.BIGINT)]),
            {"k": fk.tolist(), "v": fv.tolist()}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]), {"k": dim.tolist()}))
    db.last_fused_routes = []
    routed = db.run_lines(sql)
    assert any("firstapp" in r for r in db.last_fused_routes), (
        name, db.last_fused_routes)
    db.enable_fused_route = False
    try:
        plain = db.run_lines(sql)
    finally:
        db.enable_fused_route = True
    assert routed == plain, name


def test_route_extra_dim_group_columns():
    """group by key + dim attributes (functionally dependent): emitted via
    G-sized gathers, bit-exact incl. VARCHAR columns and NULL attrs, in
    both the ordered and first-appearance variants."""
    rng = np.random.default_rng(12)
    dim = np.array([30, 4, 18, 92, 55, 11, 73, 47], dtype=np.int64)
    names = [" containerA", None, "containerC", "d", "e", "f", "g", "h"]
    n = 2500
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid]
    fv = rng.integers(0, 80, n).astype(np.int64)
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("v", LT.BIGINT)]),
            {"k": fk.tolist(), "v": fv.tolist()}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("name", LT.VARCHAR)]),
            {"k": dim.tolist(), "name": names}))
    for sql, expect_route in [
        ("select d.k, d.name, sum(f.v) from f join d on f.k = d.k "
         "group by d.k, d.name order by d.k", "order_agg_join_direct"),
        ("select d.k, d.name, sum(f.v), count(*) from f join d on f.k = d.k "
         "group by d.k, d.name", "agg_join_firstapp"),
        ("select d.k, d.name, count(*) from d join f on f.k = d.k "
         "group by d.k, d.name", "agg_join_firstapp"),
    ]:
        routed, plain, fired = _both_ways(db, sql)
        assert any(expect_route in r for r in fired), (sql, fired)
        assert routed == plain, sql


def test_route_value_expression():
    """sum/avg over an int EXPRESSION of fact columns (evaluated by the
    fused expression executor before the kernel)."""
    db = _mk_db(2000, np.arange(24) * 5 + 2, seed=14)
    for sql in [
        "select d.k, sum(f.v * 2 + 1), count(*) from f join d on f.k = d.k "
        "group by d.k order by d.k",
        "select d.k, sum(f.v * 3), avg(f.v * 3) from f join d on f.k = d.k "
        "group by d.k",
    ]:
        routed, plain, fired = _both_ways(db, sql)
        assert fired, sql
        assert routed == plain, sql
    # two DIFFERENT value expressions: the second rides the variadic sort
    # as a payload (one fused-eval program for both)
    sql = ("select d.k, sum(f.v + f.v), avg(f.v * 3) from f join d "
           "on f.k = d.k group by d.k")
    routed, plain, fired = _both_ways(db, sql)
    assert fired
    assert routed == plain


def test_route_multi_value_columns():
    """Several distinct value expressions in one rollup: one is packed
    (carrying min/max when asked), the rest ride as sort payloads — both
    the ordered and first-appearance variants, negatives included."""
    rng = np.random.default_rng(21)
    dim = (np.arange(32) * 3 + 4).astype(np.int64)
    n = 4000
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid].copy()
    fk[::13] = 10_000_019  # misses
    fa = rng.integers(0, 500, n).astype(np.int64)
    fb = rng.integers(-80, 80, n).astype(np.int64)  # negatives: payload-only
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("a", LT.BIGINT), ("b", LT.BIGINT)]),
            {"k": fk.tolist(), "a": fa.tolist(), "b": fb.tolist()}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]), {"k": dim.tolist()}))
    cases = [
        # ordered: a packed (min/max), b as payload (negatives)
        ("select d.k, sum(f.a), min(f.a), max(f.a), sum(f.b), avg(f.b), "
         "count(*) from f join d on f.k = d.k group by d.k order by d.k",
         "order_agg_join_direct"),
        # ordered, no min/max, negative-valued first expr: everything rides
        # as payloads (packing demoted), previously ineligible
        ("select d.k, sum(f.b), sum(f.a), count(*) from f join d "
         "on f.k = d.k group by d.k order by d.k",
         "order_agg_join_direct"),
        # first-appearance: all payloads
        ("select d.k, sum(f.a), sum(f.b), avg(f.a), count(f.b) "
         "from f join d on f.k = d.k group by d.k",
         "agg_join_firstapp"),
        # expression + column payloads mixed
        ("select d.k, sum(f.a * 2 + f.b), sum(f.b), min(f.a) from f join d "
         "on f.k = d.k group by d.k order by d.k",
         "order_agg_join_direct"),
    ]
    for sql, expect in cases:
        routed, plain, fired = _both_ways(db, sql)
        assert any(expect in r for r in fired), (sql, fired)
        assert routed == plain, sql
    # two different min/max value expressions cannot both pack: falls back
    sql = ("select d.k, min(f.a), max(f.b) from f join d on f.k = d.k "
           "group by d.k order by d.k")
    routed, plain, fired = _both_ways(db, sql)
    assert not fired
    assert routed == plain


def test_route_nullable_value_columns():
    """NULL-able measures: masked payload sums + validity payloads. count(v)
    counts non-NULL, avg divides by the non-NULL count, an all-NULL group
    sums to NULL — bit-exact vs the general path in both variants; min/max
    over a NULL-able column falls back."""
    rng = np.random.default_rng(31)
    dim = (np.arange(24) * 2 + 1).astype(np.int64)
    n = 3000
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid].copy()
    fk[::17] = 10_000_019  # misses
    fv = rng.integers(-30, 120, n)
    vals = [None if i % 5 == 0 else int(v) for i, v in enumerate(fv)]
    # key 1 (dim[0]) gets ONLY NULL values: its sum/avg must render NULL
    vals = [None if k == dim[0] else v for k, v in zip(fk.tolist(), vals)]
    # w: non-negative NULL-able — packs in SENTINEL mode (min/max/DISTINCT)
    fw = rng.integers(0, 15, n)
    wvals = [None if i % 4 == 0 else int(v) for i, v in enumerate(fw)]
    wvals = [None if k == dim[0] else v for k, v in zip(fk.tolist(), wvals)]
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("v", LT.BIGINT), ("w", LT.BIGINT)]),
            {"k": fk.tolist(), "v": vals, "w": wvals}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]), {"k": dim.tolist()}))
    for sql in [
        "select d.k, sum(f.v), count(f.v), count(*) from f join d "
        "on f.k = d.k group by d.k order by d.k",
        "select d.k, avg(f.v), count(f.v) from f join d on f.k = d.k "
        "group by d.k",
        # sentinel mode: NULL-able min/max/DISTINCT pack NULLs above the
        # real range and the kernel subtracts their contributions —
        # incl. the all-NULL group (key 1) rendering NULL min/max/sums
        "select d.k, min(f.w), max(f.w), sum(f.w), count(*) from f join d "
        "on f.k = d.k group by d.k order by d.k",
        "select d.k, count(distinct f.w), sum(distinct f.w), avg(f.w) "
        "from f join d on f.k = d.k group by d.k order by d.k",
        # sentinel-packed w + negative NULL-able payload v together
        "select d.k, max(f.w), sum(f.v), count(f.v) from f join d "
        "on f.k = d.k group by d.k order by d.k",
    ]:
        routed, plain, fired = _both_ways(db, sql)
        assert fired, sql
        assert routed == plain, sql


def test_route_distinct_aggregates():
    """count/sum/avg(DISTINCT v) in the ordered variant: the packed sort
    places equal (key, value) pairs adjacently, so first-occurrence flags
    derived in-program yield distinct counts/sums with no extra sort."""
    rng = np.random.default_rng(41)
    dim = (np.arange(20) * 4 + 3).astype(np.int64)
    n = 2500
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid].copy()
    fk[::11] = 10_000_019  # misses
    fv = rng.integers(0, 12, n).astype(np.int64)  # few values: many dups
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("v", LT.BIGINT)]),
            {"k": fk.tolist(), "v": fv.tolist()}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]), {"k": dim.tolist()}))
    for sql in [
        "select d.k, count(distinct f.v), count(*) from f join d "
        "on f.k = d.k group by d.k order by d.k",
        "select d.k, sum(distinct f.v), sum(f.v) from f join d "
        "on f.k = d.k group by d.k order by d.k",
        "select d.k, avg(distinct f.v), min(f.v), max(f.v) from f join d "
        "on f.k = d.k group by d.k order by d.k",
    ]:
        routed, plain, fired = _both_ways(db, sql)
        assert fired, sql
        assert routed == plain, sql
    # numpy oracle for distinct counts
    db.last_fused_routes = []
    got = db.run_lines(
        "select d.k, count(distinct f.v) from f join d on f.k = d.k "
        "group by d.k order by d.k")
    assert db.last_fused_routes
    hit = fk != 10_000_019
    exp = {}
    for k, v in zip(fk[hit], fv[hit]):
        exp.setdefault(int(k), set()).add(int(v))
    assert got == [f"{k} {len(vs)}" for k, vs in sorted(exp.items())]
    # two different DISTINCT expressions cannot both pack: falls back
    sql = ("select d.k, count(distinct f.v), sum(distinct f.v + 1) "
           "from f join d on f.k = d.k group by d.k order by d.k")
    routed, plain, fired = _both_ways(db, sql)
    assert not fired
    assert routed == plain


def test_route_multi_value_oracle():
    """Numpy oracle for the multi-payload ordered kernel."""
    rng = np.random.default_rng(22)
    dim = np.arange(20, dtype=np.int64) + 3  # dense span
    n = 2048
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid]
    fa = rng.integers(0, 90, n).astype(np.int64)
    fb = rng.integers(-40, 40, n).astype(np.int64)
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("a", LT.BIGINT), ("b", LT.BIGINT)]),
            {"k": fk.tolist(), "a": fa.tolist(), "b": fb.tolist()}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]), {"k": dim.tolist()}))
    db.last_fused_routes = []
    got = db.run_lines(
        "select d.k, sum(f.a), sum(f.b), count(*) from f join d "
        "on f.k = d.k group by d.k order by d.k")
    assert db.last_fused_routes
    sa = np.zeros(len(dim), np.int64)
    sb = np.zeros(len(dim), np.int64)
    cnt = np.zeros(len(dim), np.int64)
    np.add.at(sa, gid, fa)
    np.add.at(sb, gid, fb)
    np.add.at(cnt, gid, 1)
    exp = [f"{k} {x} {y} {c}"
           for k, x, y, c in zip(dim, sa, sb, cnt) if c > 0]
    assert got == exp


def test_desc_order_routes_direct():
    """ORDER BY key DESC: the direct route fires (kernel output reversed in
    the finalize program) — min/max/DISTINCT stay available."""
    db = _mk_db(1000, np.arange(16) + 1, seed=4)
    for sql in [
        "select d.k, sum(f.v) from f join d on f.k=d.k "
        "group by d.k order by d.k desc",
        "select d.k, min(f.v), count(distinct f.v) from f join d on f.k=d.k "
        "group by d.k order by d.k desc",
    ]:
        routed, plain, fired = _both_ways(db, sql)
        assert any("order_agg_join_direct" in r for r in fired), (sql, fired)
        assert routed == plain, sql


def test_single_side_on_residual_is_pushed_and_routes():
    """PushJoinResidualIntoChildren turns `on f.k=d.k and f.v > 10` into a
    residual-free join over a filtered fact scan — which then routes."""
    db = _mk_db(1500, np.arange(16) + 1, seed=4)
    sql = ("select d.k, sum(f.v), count(*) from f join d "
           "on f.k=d.k and f.v > 10 group by d.k order by d.k")
    routed, plain, fired = _both_ways(db, sql)
    assert fired, "pushed residual should leave a routable join"
    assert routed == plain
    # oracle: plain general path with an explicit WHERE is identical
    where = db.run_lines(
        "select d.k, sum(f.v), count(*) from f join d on f.k=d.k "
        "where f.v > 10 group by d.k order by d.k")
    assert routed == where


def test_ineligible_shapes_fall_back():
    db = _mk_db(1000, np.arange(16) + 1, seed=4)
    cases = [
        # left join
        "select d.k, sum(f.v) from d left join f on f.k=d.k "
        "group by d.k order by d.k",
        # CROSS-side residual filter on the join (not pushable)
        "select d.k, sum(f.v) from f join d on f.k=d.k and f.v > d.k "
        "group by d.k order by d.k",
        # DISTINCT without an ORDER BY (first-appearance variant cannot
        # order values inside a range)
        "select d.k, count(distinct f.v) from f join d on f.k=d.k "
        "group by d.k",
    ]
    for sql in cases:
        db.last_fused_routes = []
        routed = db.run_lines(sql)
        assert not db.last_fused_routes, sql
        db.enable_fused_route = False
        try:
            plain = db.run_lines(sql)
        finally:
            db.enable_fused_route = True
        assert routed == plain, sql


def test_duplicate_dim_keys_fall_back_with_pair_multiplicity():
    """Non-unique 'dim' keys must NOT route (pairs multiply)."""
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("v", LT.BIGINT)]),
            {"k": [1, 1, 2, 3], "v": [10, 20, 30, 40]}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]), {"k": [1, 1, 2]}))
    db.last_fused_routes = []
    got = db.run_lines(SQL)
    assert not db.last_fused_routes
    # key 1 joins twice per fact row: sum doubled, count doubled
    assert got == ["1 60 4", "2 30 1"]


def test_route_fuzz_differential():
    """Seeded randomized differential: random dim spans, NULL densities,
    value ranges (negatives included), and aggregate lists — routed output
    must be bit-identical to the general path whenever a route fires, and
    correct either way."""
    rng = np.random.default_rng(77)
    agg_pool = [
        "sum(f.a)", "sum(f.b)", "count(f.a)", "count(f.b)", "count(*)",
        "avg(f.a)", "avg(f.b)", "min(f.a)", "max(f.a)",
        "sum(f.a + f.b)", "count(distinct f.a)", "sum(distinct f.a)",
    ]
    fired_total = 0
    for case in range(10):
        g = int(rng.integers(4, 40))
        dense = bool(rng.integers(0, 2))
        base = int(rng.integers(-50, 50))
        dim = (np.arange(g) + base if dense
               else np.cumsum(rng.integers(1, 9, g)) + base).astype(np.int64)
        n = int(rng.integers(200, 1500))
        gid = rng.integers(0, g, n)
        fk = dim[gid].copy()
        fk[:: int(rng.integers(5, 15))] = dim.max() + 7  # misses
        a_max = int(rng.integers(2, 200))
        fa = rng.integers(0, a_max, n).astype(np.int64)
        fb = rng.integers(-100, 100, n).astype(np.int64)
        null_a = int(rng.integers(0, 3))  # 0: none
        avals = [None if (null_a and i % (null_a * 7) == 0) else int(v)
                 for i, v in enumerate(fa)]
        db = sqlrs_tpu.Database()
        db.create_memory_table(
            "f", DeviceBatch.from_pydict(
                Schema.of([("k", LT.BIGINT), ("a", LT.BIGINT),
                           ("b", LT.BIGINT)]),
                {"k": fk.tolist(), "a": avals, "b": fb.tolist()}))
        db.create_memory_table(
            "d", DeviceBatch.from_pydict(
                Schema.of([("k", LT.BIGINT)]), {"k": dim.tolist()}))
        n_aggs = int(rng.integers(1, 5))
        aggs = ", ".join(rng.choice(agg_pool, n_aggs, replace=False))
        order = " order by d.k" if rng.integers(0, 2) else ""
        sql = (f"select d.k, {aggs} from f join d on f.k = d.k "
               f"group by d.k{order}")
        routed, plain, fired = _both_ways(db, sql)
        fired_total += bool(fired)
        assert routed == plain, (case, sql)
    assert fired_total >= 5, f"routes fired in only {fired_total}/10 cases"


def test_varchar_key_routes_firstapp():
    """VARCHAR join keys (int32 dictionary codes) route through the
    first-appearance variant; the ORDER BY variant bails (code order is
    not collation order)."""
    names = ["zeta", "alpha", "mid", "omega", "beta"]
    facts = ["mid", "zeta", "zeta", "nope", "beta", None, "mid", "alpha"]
    vals = [1, 2, 3, 4, 5, 6, 7, 8]
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("name", LT.VARCHAR), ("v", LT.BIGINT)]),
            {"name": facts, "v": vals}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("name", LT.VARCHAR)]), {"name": names}))
    sql = ("select d.name, sum(f.v), count(*) from f join d "
           "on f.name = d.name group by d.name")
    routed, plain, fired = _both_ways(db, sql)
    assert any("firstapp" in r for r in fired), fired
    assert routed == plain
    # explicit oracle: fact on the left -> dim on the right -> group order
    # follows the dim table's original row order (CLAUDE.md emission order)
    assert routed == ["zeta 5 2", "alpha 8 1", "mid 8 2", "beta 5 1"]
    # ORDER BY the varchar key: ordered route must bail, result correct
    sql2 = sql + " order by d.name"
    routed2, plain2, fired2 = _both_ways(db, sql2)
    assert not any("order_agg" in r for r in fired2), fired2
    assert routed2 == plain2


def test_composite_key_routes():
    """Two-key equi joins fold into one combined key (_combine_keys) and
    ride the single-key machinery; ORDER BY (k1, k2) asc/desc IS combined
    order; out-of-span minor keys and NULL keys are misses."""
    rng = np.random.default_rng(55)
    k1 = np.repeat(np.arange(6, dtype=np.int64) * 3 + 10, 4)
    k2 = np.tile(np.array([2, 5, 7, 11], dtype=np.int64), 6)
    n = 4000
    pick = rng.integers(0, len(k1), n)
    fk1 = k1[pick].copy()
    fk2 = k2[pick].copy()
    fk1[::9] = 999          # major miss
    fk2[::7] = 100          # minor OUT OF dim span (would alias if unmasked)
    fk2[3::13] = 6          # minor in-span but not a dim value
    fv = rng.integers(0, 50, n).astype(np.int64)
    k1l = fk1.tolist()
    k1l[5] = None           # NULL major key
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("a", LT.BIGINT), ("b", LT.BIGINT), ("v", LT.BIGINT)]),
            {"a": k1l, "b": fk2.tolist(), "v": fv.tolist()}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("a", LT.BIGINT), ("b", LT.BIGINT)]),
            {"a": k1.tolist(), "b": k2.tolist()}))
    base = "from f join d on f.a = d.a and f.b = d.b group by d.a, d.b"
    for sql, expect in [
        (f"select d.a, d.b, sum(f.v), count(*) {base} order by d.a, d.b",
         "order_agg_join_direct"),
        (f"select d.a, d.b, min(f.v), max(f.v), count(distinct f.v) {base} "
         "order by d.a, d.b", "order_agg_join_direct"),
        (f"select d.a, d.b, sum(f.v) {base} order by d.a desc, d.b desc",
         "order_agg_join_direct"),
        (f"select d.a, d.b, sum(f.v), avg(f.v) {base}", "agg_join_firstapp"),
        # group by the FACT side's key columns
        ("select f.a, f.b, count(*) from f join d on f.a = d.a and "
         "f.b = d.b group by f.a, f.b order by f.a, f.b",
         "order_agg_join_direct"),
    ]:
        routed, plain, fired = _both_ways(db, sql)
        assert any(expect in r and "_ck2" in r for r in fired), (sql, fired)
        assert routed == plain, sql
    # numpy oracle for the first query
    db.last_fused_routes = []
    got = db.run_lines(f"select d.a, d.b, sum(f.v), count(*) {base} "
                       "order by d.a, d.b")
    assert db.last_fused_routes
    valid = np.ones(n, bool)
    valid[5] = False
    exp = {}
    dimset = set(zip(k1.tolist(), k2.tolist()))
    for i in range(n):
        if not valid[i]:
            continue
        kk = (int(fk1[i]), int(fk2[i]))
        if kk in dimset:
            s, c = exp.get(kk, (0, 0))
            exp[kk] = (s + int(fv[i]), c + 1)
    assert got == [f"{a} {b} {s} {c}"
                   for (a, b), (s, c) in sorted(exp.items())]
    # ORDER BY one key / mixed directions: the ORDERED route must bail
    # (ties/order under-specified for the packed order) — the firstapp
    # route may still fire under the general Order, which sorts the G-row
    # output; results stay bit-exact either way
    for sql in [
        f"select d.a, d.b, sum(f.v) {base} order by d.a",
        f"select d.a, d.b, sum(f.v) {base} order by d.a, d.b desc",
    ]:
        routed, plain, fired = _both_ways(db, sql)
        assert not any("order_agg" in r for r in fired), (sql, fired)
        assert routed == plain, sql
    # group col that is not both key columns: no route at all
    sql = ("select d.a, count(*) from f join d on f.a = d.a and f.b = d.b "
           "group by d.a")
    routed, plain, fired = _both_ways(db, sql)
    assert not fired, (sql, fired)
    assert routed == plain, sql


def test_composite_key_fuzz():
    """Seeded random composite-key rollups vs the general path."""
    for seed in range(300, 306):
        rng = np.random.default_rng(seed)
        g1, g2 = int(rng.integers(2, 8)), int(rng.integers(2, 8))
        k1 = np.repeat(np.arange(g1, dtype=np.int64) * int(rng.integers(1, 5))
                       + int(rng.integers(-9, 9)), g2)
        k2 = np.tile(np.cumsum(rng.integers(1, 4, g2)).astype(np.int64), g1)
        n = int(rng.integers(200, 1200))
        pick = rng.integers(0, len(k1), n)
        fk1, fk2 = k1[pick].copy(), k2[pick].copy()
        fk1[:: int(rng.integers(5, 11))] = k1.max() + 2
        fk2[:: int(rng.integers(6, 13))] = k2.max() + 7  # out-of-span minors
        fv = rng.integers(-40, 90, n).astype(np.int64)
        db = sqlrs_tpu.Database()
        db.create_memory_table(
            "f", DeviceBatch.from_pydict(
                Schema.of([("a", LT.BIGINT), ("b", LT.BIGINT),
                           ("v", LT.BIGINT)]),
                {"a": fk1.tolist(), "b": fk2.tolist(), "v": fv.tolist()}))
        db.create_memory_table(
            "d", DeviceBatch.from_pydict(
                Schema.of([("a", LT.BIGINT), ("b", LT.BIGINT)]),
                {"a": k1.tolist(), "b": k2.tolist()}))
        aggs = rng.choice(
            ["sum(f.v)", "count(*)", "avg(f.v)", "count(f.v)"],
            int(rng.integers(1, 4)), replace=False)
        order = ["", " order by d.a, d.b",
                 " order by d.a desc, d.b desc"][int(rng.integers(0, 3))]
        sql = (f"select d.a, d.b, {', '.join(aggs)} from f join d "
               f"on f.a = d.a and f.b = d.b group by d.a, d.b{order}")
        routed, plain, fired = _both_ways(db, sql)
        assert fired, (seed, sql)
        assert routed == plain, (seed, sql)


def test_date_key_routes():
    """DATE join keys (int32 days) route in both variants; day-int order IS
    date order, so ORDER BY the date key stays on the direct kernel."""
    db = sqlrs_tpu.Database()
    db.run("create table f(dt date, v int)")
    db.run("insert into f values (date '2024-01-01', 3), "
           "(date '2024-01-02', 5), (date '2024-01-01', 7), "
           "(date '2030-05-05', 9), (null, 11)")
    db.run("create table d(dt date)")
    db.run("insert into d values (date '2024-01-01'), (date '2024-01-02'), "
           "(date '2024-01-03')")
    for sql, tag in [
        ("select d.dt, sum(f.v), count(*) from f join d on f.dt = d.dt "
         "group by d.dt order by d.dt", "order_agg_join_direct"),
        ("select d.dt, min(f.v), max(f.v) from f join d on f.dt = d.dt "
         "group by d.dt order by d.dt desc", "order_agg_join_direct"),
        ("select d.dt, avg(f.v) from f join d on f.dt = d.dt group by d.dt",
         "agg_join_firstapp"),
    ]:
        routed, plain, fired = _both_ways(db, sql)
        assert any(tag in r for r in fired), (sql, fired)
        assert routed == plain, sql


def test_route_float_measures():
    """DOUBLE measures route: f64 values ride the variadic sort as payloads
    and accumulate float64 (this is what lets real TPC-H rollups fire the
    route — every TPC-H measure is DOUBLE). Test values are dyadic
    rationals (k/4) with small exponent spread, so the float sums are EXACT
    in any summation order and the rendered differential stays
    bit-identical; realistic data is covered by the TPC-H oracle checks."""
    rng = np.random.default_rng(91)
    dim = (np.arange(28) * 3 + 2).astype(np.int64)
    n = 3000
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid].copy()
    fk[::8] = 10_000_019  # misses
    fv = (rng.integers(-400, 400, n) / 4.0)  # exact dyadic values
    fw = rng.integers(0, 90, n).astype(np.int64)  # int measure alongside
    vals = [None if i % 6 == 0 else float(v) for i, v in enumerate(fv)]
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("x", LT.DOUBLE),
                       ("w", LT.BIGINT)]),
            {"k": fk.tolist(), "x": fv.tolist(), "w": fw.tolist()}))
    db.create_memory_table(
        "fn", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("x", LT.DOUBLE)]),
            {"k": fk.tolist(), "x": vals}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]), {"k": dim.tolist()}))
    for sql, expect in [
        # ordered variant: float payload + int packed side by side
        ("select d.k, sum(f.x), count(*) from f join d on f.k = d.k "
         "group by d.k order by d.k", "order_agg_join_direct"),
        ("select d.k, sum(f.x), min(f.w), max(f.w) from f join d "
         "on f.k = d.k group by d.k order by d.k", "order_agg_join_direct"),
        # float EXPRESSION of fact columns (the Q3/Q18 shape):
        ("select d.k, sum(f.x * 2.0 + 1.0), avg(f.x), count(*) from f "
         "join d on f.k = d.k group by d.k order by d.k",
         "order_agg_join_direct"),
        # first-appearance variant (non-key ORDER BY queries land here)
        ("select d.k, sum(f.x), avg(f.x), count(*) from f join d "
         "on f.k = d.k group by d.k", "agg_join_firstapp"),
        # NULL-able float measure: masked-zero payload + validity payload
        ("select d.k, sum(fn.x), count(fn.x), avg(fn.x) from fn join d "
         "on fn.k = d.k group by d.k order by d.k", "order_agg_join_direct"),
    ]:
        routed, plain, fired = _both_ways(db, sql)
        assert any(expect in r for r in fired), (sql, fired)
        assert routed == plain, sql
    # min/max over a float measure: routes via the two-operand tv kernel
    # (order-preserving IEEE-754 transform as a second sort key)
    for sql in [
        ("select d.k, min(f.x) from f join d on f.k = d.k "
         "group by d.k order by d.k"),
        ("select d.k, min(f.x), max(f.x), sum(f.x), avg(f.x), count(*) "
         "from f join d on f.k = d.k group by d.k order by d.k"),
        # int payload rides alongside the float tv operand
        ("select d.k, max(f.x), sum(f.w) from f join d on f.k = d.k "
         "group by d.k order by d.k"),
        # NULL-able float min/max: tv sentinel mode (NULLs sort to each
        # range's tail; max reads hi-1-nullcnt)
        ("select d.k, min(fn.x), max(fn.x), sum(fn.x), count(fn.x) "
         "from fn join d on fn.k = d.k group by d.k order by d.k"),
        # DESC stays on the tv kernel (finalize reverses)
        ("select d.k, min(f.x), max(f.x) from f join d on f.k = d.k "
         "group by d.k order by d.k desc"),
    ]:
        routed, plain, fired = _both_ways(db, sql)
        assert any("_tv" in r for r in fired), (sql, fired)
        assert routed == plain, sql
    # float DISTINCT still falls back (needs value-equality packing)
    sql = ("select d.k, count(distinct f.x) from f join d on f.k = d.k "
           "group by d.k order by d.k")
    routed, plain, fired = _both_ways(db, sql)
    assert not fired
    assert routed == plain


def test_route_float_oracle():
    """Numpy float64 oracle for the routed float sums (realistic values,
    tolerance-checked against the raw device column)."""
    rng = np.random.default_rng(92)
    dim = np.arange(16, dtype=np.int64) + 1  # dense
    n = 2000
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid]
    fv = rng.uniform(900.0, 105000.0, n) * (1 - rng.uniform(0, 0.1, n))
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("x", LT.DOUBLE)]),
            {"k": fk.tolist(), "x": fv.tolist()}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]), {"k": dim.tolist()}))
    db.last_fused_routes = []
    res = db.run("select d.k, sum(f.x) from f join d on f.k = d.k "
                 "group by d.k order by d.k")
    assert db.last_fused_routes
    got = np.asarray(res[0].columns[1].data)
    exp = np.zeros(len(dim))
    np.add.at(exp, gid, fv)
    np.testing.assert_allclose(got, exp, rtol=1e-12)


def test_route_group_key_any_position():
    """The join key may appear at ANY position among the group columns
    (Q18 lists dim attributes before the key); output column order follows
    the GROUP BY list. Ordered variant still requires the key first (the
    ORDER BY references output column 0)."""
    rng = np.random.default_rng(93)
    dim = np.array([30, 4, 18, 92, 55, 11, 73, 47], dtype=np.int64)
    names = ["nA", "nB", None, "nD", "nE", "nF", "nG", "nH"]
    n = 2500
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid].copy()
    fk[::9] = 999  # misses
    fv = rng.integers(-40, 80, n).astype(np.int64)
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("v", LT.BIGINT)]),
            {"k": fk.tolist(), "v": fv.tolist()}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("name", LT.VARCHAR)]),
            {"k": dim.tolist(), "name": names}))
    for sql, expect_fire in [
        # key in the middle / last of the GROUP BY list (firstapp variant)
        ("select d.name, d.k, sum(f.v), count(*) from f join d "
         "on f.k = d.k group by d.name, d.k", True),
        ("select d.name, f.k, sum(f.v) from f join d on f.k = d.k "
         "group by d.name, f.k", True),
        # both d.k and f.k grouped (the key twice)
        ("select d.k, f.k, count(*) from f join d on f.k = d.k "
         "group by d.k, f.k", True),
    ]:
        routed, plain, fired = _both_ways(db, sql)
        assert bool(fired) == expect_fire, (sql, fired)
        assert routed == plain, sql
    # ordered variant with a non-first key: ORDER BY references column 0
    # (a dim attribute) -> must fall back and stay correct
    sql = ("select d.name, d.k, sum(f.v) from f join d on f.k = d.k "
           "group by d.name, d.k order by d.name")
    routed, plain, fired = _both_ways(db, sql)
    assert not any("order_agg" in r for r in fired), fired
    assert routed == plain


def test_semi_join_pushdown_routes_q18_shape():
    """PushSemiJoinThroughInner: an IN-subquery semi join above the star
    join commutes onto the side that owns its key, leaving the Q18 shape
    HashAgg(inner(fact, dim')) — which routes. Differential vs the general
    path (same pushed plan, route disabled) and vs the equivalent
    explicit-filter query."""
    rng = np.random.default_rng(97)
    dim = (np.arange(30) * 2 + 4).astype(np.int64)
    n = 3000
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid].copy()
    fk[::9] = 10_000_019  # misses
    fv = (rng.integers(-200, 200, n) / 4.0)  # exact dyadic DOUBLEs
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("x", LT.DOUBLE)]),
            {"k": fk.tolist(), "x": fv.tolist()}))
    db.create_memory_table(
        "d", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]), {"k": dim.tolist()}))
    # subquery table: every 3rd dim key (plus a non-key to be ignored)
    db.create_memory_table(
        "s", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]),
            {"k": dim[::3].tolist() + [999999]}))
    # semi key on the DIM side of the star join
    sql = ("select d.k, sum(f.x), count(*) from f join d on f.k = d.k "
           "where d.k in (select k from s) group by d.k")
    routed, plain, fired = _both_ways(db, sql)
    assert any("firstapp" in r for r in fired), fired
    assert routed == plain
    # semi key on the FACT side
    sql2 = ("select d.k, sum(f.x) from f join d on f.k = d.k "
            "where f.k in (select k from s) group by d.k")
    routed2, plain2, fired2 = _both_ways(db, sql2)
    assert any("firstapp" in r for r in fired2), fired2
    assert routed2 == plain2
    # both phrasings keep the same groups (d.k = f.k on an inner join)
    assert [r.split()[0] for r in routed] == [r.split()[0] for r in routed2]
    # NOT IN (null-aware anti) also commutes below the join
    sql3 = ("select d.k, sum(f.x) from f join d on f.k = d.k "
            "where d.k not in (select k from s) group by d.k")
    routed3, plain3, fired3 = _both_ways(db, sql3)
    assert any("firstapp" in r for r in fired3), fired3
    assert routed3 == plain3
    # IN / NOT IN partition the surviving dim keys
    keys_in = {r.split()[0] for r in routed}
    keys_not = {r.split()[0] for r in routed3}
    assert not (keys_in & keys_not)
    base = db.run_lines("select d.k, sum(f.x) from f join d on f.k = d.k "
                        "group by d.k")
    assert keys_in | keys_not == {r.split()[0] for r in base}


def test_route_dense_dim_matches_general_path():
    """A pure sum+count rollup over a dense dim domain takes the dense
    packed-sort kernel and must be bit-identical to the general path, with
    misses, with NULL fact keys, and with min() added."""
    db = _mk_db(5000, np.arange(64) + 100, seed=51)  # dense span + misses
    routed, plain, fired = _both_ways(db, sql=SQL)
    assert any(r.endswith("_dense") for r in fired), fired
    assert routed == plain
    db2 = _mk_db(3000, np.arange(32) + 7, seed=52, null_every=9)
    routed2, plain2, fired2 = _both_ways(db2, SQL)
    assert any(r.endswith("_dense") for r in fired2), fired2
    assert routed2 == plain2
    sql3 = ("select d.k, sum(f.v), min(f.v) from f join d on f.k = d.k "
            "group by d.k order by d.k")
    routed3, plain3, fired3 = _both_ways(db, sql3)
    assert any(r.endswith("_dense") for r in fired3), fired3
    assert routed3 == plain3


def test_route_decimal_sums_exact_at_scale():
    """Round-5 regression: routed sums of k-dp decimal DOUBLE measures run
    in EXACT scaled-int arithmetic. The old f64 path computed per-group
    sums as differences of GLOBAL prefix sums, whose accumulated rounding
    (~ulp(total)*sqrt(nblocks)) broke the TPC-H Q3 oracle at SF1 (got
    425031.3994 vs 425031.3985). Here the total is ~5e9 across 2^20 rows
    while each group sums ~5e6 — the routed result must equal the
    Decimal-exact value to the last bit."""
    from decimal import Decimal

    rng = np.random.default_rng(55)
    n, g = 1 << 20, 1 << 10
    gid = rng.integers(0, g, n)
    dim = np.arange(g, dtype=np.int64) * 7 + 3
    fk = dim[gid]
    price = np.round(rng.uniform(900, 10500, n), 2)
    disc = np.round(rng.uniform(0, 0.1, n), 2)
    rev = price * (1 - disc)  # 4dp decimal computed in doubles
    db = sqlrs_tpu.Database()
    db.create_memory_table(
        "f", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("p", LT.DOUBLE),
                       ("d", LT.DOUBLE)]),
            {"k": fk.tolist(), "p": price.tolist(), "d": disc.tolist()}))
    db.create_memory_table(
        "dm", DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]), {"k": dim.tolist()}))
    db.last_fused_routes = []
    lines = db.run_lines(
        "select dm.k, sum(f.p * (1 - f.d)) from f join dm on f.k = dm.k "
        "group by dm.k order by dm.k"
    )
    assert db.last_fused_routes, "route did not fire"
    # Decimal-exact oracle: integer cents products
    acc = {}
    for k, p, d in zip(fk, price, disc):
        s = int(round(p * 100)) * (100 - int(round(d * 100)))
        acc[k] = acc.get(k, 0) + s
    for line in lines[:64]:
        kstr, vstr = line.split()
        exact = float(Decimal(acc[int(kstr)]) / Decimal(10 ** 4))
        assert float(vstr) == exact, (line, exact)
