"""SQL-level distributed execution: every query must render bit-identically
(row order included) between the single-device engine and the distributed
engine over the 8-device CPU mesh."""

import glob
import os

import pytest

pytestmark = pytest.mark.slow

import sqlrs_tpu
from sqlrs_tpu import Database

CSV_DIR = os.path.join(os.path.dirname(__file__), "csv")


def _make_pair():
    db1 = Database()
    db8 = Database(n_devices=8)
    for db in (db1, db8):
        for path in sorted(glob.glob(os.path.join(CSV_DIR, "*.csv"))):
            name = os.path.splitext(os.path.basename(path))[0]
            db.create_csv_table(name, path)
    return db1, db8


@pytest.fixture(scope="module")
def dbs():
    return _make_pair()


QUERIES = [
    # scan / filter / project (zero-communication SPMD ops)
    "select * from employee",
    "select first_name, salary from employee where salary > 100",
    "select id, id + 1, -id from employee where last_name = 'Hopkins'",
    "select * from employee where salary is null",
    "select first_name from employee where state in ('CA', 'CO')",
    "select a from t1 where a between 1 and 2",
    # ungrouped aggregation (local partials + psum)
    "select sum(salary), count(*), count(salary), min(salary), max(salary), avg(salary) from employee",
    "select count(*) from employee where salary > 100",
    "select min(first_name), max(last_name) from employee",
    "select sum(salary) from employee where salary < 0",  # empty -> NULL
    # grouped aggregation (shard-local partials + all_gather merge);
    # first-appearance group order must match the single-device engine
    "select state, sum(salary) from employee group by state",
    "select state, count(*), count(salary), min(salary), max(salary), avg(salary) from employee group by state",
    "select last_name, state, sum(id) from employee group by last_name, state",
    "select state, min(first_name), max(first_name) from employee group by state",
    "select salary, count(*) from employee group by salary",  # NULL group key
    "select b, sum(a), max(c) from t1 group by b",
    # hash joins (replicated build, sharded slot-expansion probe);
    # emission order must match the reference probe-order semantics
    "select * from employee join department on employee.department_id = department.id",
    "select * from employee left join department on employee.department_id = department.id",
    "select * from employee right join department on employee.department_id = department.id",
    "select * from employee full join department on employee.department_id = department.id",
    "select * from t1 join t2 on t1.a = t2.a and t1.b = t2.b",
    "select * from employee join department on employee.department_id = department.id and employee.salary > 100",
    "select first_name, department_name, state_name from employee"
    " join department on employee.department_id = department.id"
    " join state on employee.state = state.state_code",
    # join feeding distributed aggregation
    "select department_name, sum(salary), count(*) from employee"
    " join department on employee.department_id = department.id"
    " group by department_name",
    # limit/offset windowing via global prefix count (stays sharded)
    "select first_name from employee limit 2",
    "select first_name from employee limit 2 offset 1",
    "select id from employee where salary > 100 limit 1 offset 1",
    # distinct (group-by-all through the distributed partial-agg path)
    "select distinct state from employee",
    "select distinct last_name, state from employee",
    # join feeding ORDER BY / LIMIT (materialize boundary)
    "select first_name, department_name from employee"
    " join department on employee.department_id = department.id"
    " order by first_name desc limit 2",
]


@pytest.mark.parametrize("sql", QUERIES)
def test_distributed_matches_single_device(dbs, sql):
    db1, db8 = dbs
    assert db8.run_lines(sql) == db1.run_lines(sql)


def test_distributed_prepared_statements(dbs):
    """ClientContext prepared statements honor the session mesh."""
    db1, db8 = dbs
    ctx = db8.connect()
    prepared = ctx.prepare("select state, count(*) from employee group by state")
    got = ctx.execute_prepared(prepared)
    exp = db1.run_lines("select state, count(*) from employee group by state")
    from sqlrs_tpu.utils.render import batches_to_slt_lines

    assert batches_to_slt_lines(got.batches) == exp


def test_distributed_having(dbs):
    db1, db8 = dbs
    sql = "select state, sum(salary) from employee group by state having sum(salary) > 100"
    assert db8.run_lines(sql) == db1.run_lines(sql)


def test_distributed_randomized_scale():
    """Randomized fact/dim workload (thousands of rows, duplicate + NULL
    keys, zipf-ish skew) — exercises the g_cap overflow retry, multi-slot
    probe strips, and the exact-equality collision re-check."""
    import numpy as np

    from sqlrs_tpu.data import DeviceBatch, Schema
    from sqlrs_tpu.types import LogicalType as LT

    rng = np.random.default_rng(42)
    n, nd = 6007, 97
    fk = np.minimum(rng.zipf(1.4, n), nd * 2).astype(np.int64)
    fv = rng.integers(-50, 50, n).astype(np.int64)
    fnull = rng.random(n) < 0.05
    dk = np.arange(1, nd + 1, dtype=np.int64)
    dname = np.array([f"grp{i}" for i in dk])

    fact = DeviceBatch.from_pydict(
        Schema.of([("k", LT.BIGINT), ("v", LT.BIGINT)]),
        {"k": [None if m else int(x) for x, m in zip(fk, fnull)], "v": fv.tolist()},
    )
    dim = DeviceBatch.from_pydict(
        Schema.of([("k", LT.BIGINT), ("name", LT.VARCHAR)]),
        {"k": dk.tolist(), "name": dname.tolist()},
    )
    db1, db8 = Database(), Database(n_devices=8)
    for db in (db1, db8):
        db.create_memory_table("fact", fact)
        db.create_memory_table("dim", dim)

    for sql in [
        "select name, sum(v), count(*), min(v), max(v) from fact"
        " join dim on fact.k = dim.k group by name",
        "select k, count(*), avg(v) from fact group by k",
        "select count(*) from fact left join dim on fact.k = dim.k",
        "select count(*), sum(fact.k) from fact right join dim on fact.k = dim.k",
        "select sum(v) from fact where k > 50",
    ]:
        assert db8.run_lines(sql) == db1.run_lines(sql), sql


def test_distributed_ddl_dml_roundtrip():
    db = Database(n_devices=8)
    db.run("create table t(v int, w varchar)")
    db.run("insert into t values (1, 'a'), (2, 'b'), (3, null)")
    assert db.run_lines("select sum(v), count(w) from t") == ["6 2"]
    assert db.run_lines("select v from t where w = 'b'") == ["2"]


def test_distributed_order_by(dbs):
    """ORDER BY stays sharded (sample-sort exchange + local stable sort) and
    must be bit-exact with the single-device stable sort, including ties,
    NULL placement, desc, and LIMIT windows above it."""
    db1, db8 = dbs
    for sql in [
        "select * from employee order by salary",
        "select * from employee order by salary desc",
        "select first_name, state from employee order by state, first_name desc",
        "select * from employee order by salary limit 2 offset 1",
        "select a, b from t1 order by b desc, a",
    ]:
        assert db8.run_lines(sql) == db1.run_lines(sql), sql


def test_distributed_order_by_scale():
    import numpy as np

    rng = np.random.default_rng(12)
    n = 5000
    v = rng.integers(0, 40, n)  # heavy ties exercise tie ordering
    w = rng.integers(-1000, 1000, n)
    db1, db8 = Database(), Database(n_devices=8)
    for db in (db1, db8):
        from sqlrs_tpu.types import LogicalType as LT

        db.create_memory_table_numpy(
            "s", [("v", LT.BIGINT), ("w", LT.BIGINT)], [v, w]
        )
    for sql in [
        "select v, w from s where w > 0 order by v",
        "select v, w from s order by v desc, w",
        "select v from s order by v limit 17 offset 5",
    ]:
        assert db8.run_lines(sql) == db1.run_lines(sql), sql


def test_distributed_skew_routes_through_salted():
    """A zipf-hot fact key must trip the adaptive skew detector inside the
    shuffle join (hot probe rows salted round-robin, hot build rows
    replicated) and still produce bit-exact results + first-appearance
    group order (VERDICT round-2 item 3's skew case)."""
    import numpy as np

    rng = np.random.default_rng(11)
    n, g = 6000, 50
    gid = np.where(rng.random(n) < 0.7, 0, rng.integers(1, g, n))
    vals = rng.integers(0, 1000, n)
    rows_f = ",".join(f"({k * 3 + 1},{v})" for k, v in zip(gid, vals))
    rows_d = ",".join(f"({k * 3 + 1},{k * 7})" for k in range(g))
    ddl = [
        "create table fact(k int, v int)",
        "create table dim(k int, d int)",
        f"insert into fact values {rows_f}",
        f"insert into dim values {rows_d}",
    ]
    # dim first: the planner's left child is the BUILD side (reference
    # hash_join.rs:146), so the skewed fact table is the probe side — the
    # direction the salted exchange is designed for (hot PROBE rows spread
    # round-robin; a fact-side build would instead blow the m-strip width
    # and correctly fall back to broadcast)
    q = (
        "select dim.d, sum(fact.v), count(*) from dim join fact"
        " on fact.k = dim.k group by dim.d"
    )
    db1 = Database()
    db8 = Database(n_devices=8)
    db8.dist_join_policy = "shuffle"
    db8.dist_hot_min = 16  # trip hotness at test scale
    for db in (db1, db8):
        for s in ddl:
            db.run(s)
    exp = [tuple(r) for b in db1.run(q) for r in b.to_pylist()]
    got = [tuple(r) for b in db8.run(q) for r in b.to_pylist()]
    assert got == exp
    assert "salted" in db8.last_join_strategies, db8.last_join_strategies


def test_ring_agg_over_join():
    """Fused ring aggregate-over-join (parallel/dist_join.ring_agg_join):
    HashAgg over an inner single-key join with build-side group keys and
    probe-side aggregates routes through the exchange-free ppermute ring
    and stays bit-exact — results, NULL semantics (NULL agg inputs, NULL
    join keys, all-NULL groups), duplicate dim keys, unmatched dim rows,
    and first-appearance group order included."""
    rows_d = ",".join(f"({k % 7},{k},{(k * 13) % 5})" for k in range(20))
    parts = []
    for i in range(300):
        k = "null" if i % 37 == 0 else str(i % 9)
        v = "null" if i % 11 == 0 else str(i)
        sv = "null" if i % 13 == 0 else f"'w{i % 23:02d}'"
        parts.append(f"({k},{v},{sv})")
    ddl = [
        "create table dim(k int, u int, g int)",
        "create table fact(k int, v int, s varchar)",
        f"insert into dim values {rows_d}",
        f"insert into fact values {','.join(parts)}",
    ]
    qs = [
        # multi-aggregate, duplicate dim join keys, NULLs in v and k
        "select dim.g, sum(fact.v), count(*), count(fact.v), min(fact.v),"
        " max(fact.v) from dim join fact on fact.k = dim.k group by dim.g",
        # join key == group key, unmatched dim rows must vanish
        "select dim.u, sum(fact.v) from dim join fact on fact.k = dim.u"
        " group by dim.u",
        # enclosing order/limit over the fused result
        "select dim.g, count(*) from dim join fact on fact.k = dim.k"
        " group by dim.g order by count(*) desc, dim.g limit 3",
        # VARCHAR min/max (rank-encoded sort keys, code raws)
        "select dim.g, min(fact.s), max(fact.s) from dim join fact"
        " on fact.k = dim.k group by dim.g",
    ]
    db1 = Database()
    db8 = Database(n_devices=8)
    db8.dist_join_policy = "ring"
    for db in (db1, db8):
        for s in ddl:
            db.run(s)
    for q in qs:
        assert db8.run_lines(q) == db1.run_lines(q), q
        assert "ring" in db8.last_join_strategies, (q, db8.last_join_strategies)
    # auto policy sends small builds through the broadcast-FUSED shard
    # kernel (dist_join.broadcast_agg_join: one O(G) all_gather + one
    # shard-local join_groupby_direct-style probe pass — round-4 VERDICT
    # item 5, no per-shard pair materialization); the ring gate
    # (dist_ring_min_build) is overridable. Bit-exact vs single-device
    # either way, including min/max, NULLs and first-appearance order.
    db8.dist_join_policy = "auto"
    for q in qs:
        assert db8.run_lines(q) == db1.run_lines(q), q
        assert "broadcast_fused" in db8.last_join_strategies, (
            q, db8.last_join_strategies,
        )
    db8.dist_ring_min_build = 1
    assert db8.run_lines(qs[0]) == db1.run_lines(qs[0])
    assert db8.last_join_strategies == ["ring"]
    del db8.dist_ring_min_build
    # explicit broadcast policy remains the general-path escape hatch
    db8.dist_join_policy = "broadcast"
    assert db8.run_lines(qs[0]) == db1.run_lines(qs[0])
    assert db8.last_join_strategies == ["broadcast"]


def test_ring_exchange_sql_shuffle_join_bit_exact():
    """db.dist_exchange_ring=True: the shuffle join's probe exchange runs
    as ppermute ring hops with per-chunk rank sorts overlapping the next
    receive (dist_join._ring_probe_ranks). The SQL result must be
    bit-exact vs single-device AND vs the monolithic exchange."""
    import numpy as np

    rng = np.random.default_rng(23)
    n, g = 5000, 60
    gid = rng.integers(0, g, n)
    vals = rng.integers(-100, 1000, n)
    rows_f = ",".join(f"({k * 5 + 2},{v})" for k, v in zip(gid, vals))
    rows_d = ",".join(f"({k * 5 + 2},{k * 9})" for k in range(g))
    ddl = [
        "create table fact(k int, v int)",
        "create table dim(k int, d int)",
        f"insert into fact values {rows_f}",
        f"insert into dim values {rows_d}",
    ]
    q = (
        "select dim.d, sum(fact.v), count(*) from dim join fact"
        " on fact.k = dim.k group by dim.d order by dim.d"
    )
    db1 = Database()
    db8 = Database(n_devices=8)
    db8.dist_join_policy = "shuffle"
    db8r = Database(n_devices=8)
    db8r.dist_join_policy = "shuffle"
    db8r.dist_exchange_ring = True
    for db in (db1, db8, db8r):
        for s in ddl:
            db.run(s)
    exp = db1.run_lines(q)
    mono = db8.run_lines(q)
    ring = db8r.run_lines(q)
    assert mono == exp
    assert ring == exp
    assert "shuffle" in db8r.last_join_strategies, db8r.last_join_strategies


def test_ring_agg_join_avg_float_composite():
    """Round-3 VERDICT item 8 widenings on the distributed ring route:
    avg (sum+count partials + final division), DOUBLE measures (float64
    partial accumulation), and composite two-key equi joins (combined-key
    packing shared with the single-device fused route). All bit-exact vs
    single-device; DISTINCT still falls back."""
    import numpy as np

    rng = np.random.default_rng(31)
    rows_d = ",".join(
        f"({k % 6},{k % 4},{k},{(k * 11) % 7})" for k in range(24)
    )
    parts = []
    for i in range(400):
        a = "null" if i % 29 == 0 else str(i % 6)
        b = str(i % 4)
        v = "null" if i % 13 == 0 else str(i % 100)
        x = f"{(i % 89) * 0.25 + 900.0}"  # exact dyadic DOUBLEs
        parts.append(f"({a},{b},{v},{x})")
    ddl = [
        "create table dim(a int, b int, u int, g int)",
        "create table fact(a int, b int, v int, x double)",
        f"insert into dim values {rows_d}",
        f"insert into fact values {','.join(parts)}",
    ]
    db1 = Database()
    db8 = Database(n_devices=8)
    db8.dist_join_policy = "ring"
    for db in (db1, db8):
        for s in ddl:
            db.run(s)
    qs = [
        # avg over NULL-able int + count
        "select dim.g, avg(fact.v), count(fact.v) from dim join fact"
        " on fact.a = dim.a group by dim.g",
        # DOUBLE measures: sum + avg (dyadic values -> exact in any order)
        "select dim.g, sum(fact.x), avg(fact.x) from dim join fact"
        " on fact.a = dim.a group by dim.g",
        # composite two-key equi join
        "select dim.g, sum(fact.v), count(*) from dim join fact"
        " on fact.a = dim.a and fact.b = dim.b group by dim.g",
        # composite + avg + float together
        "select dim.g, avg(fact.x), min(fact.v) from dim join fact"
        " on fact.a = dim.a and fact.b = dim.b group by dim.g",
    ]
    for q in qs:
        assert db8.run_lines(q) == db1.run_lines(q), q
        assert "ring" in db8.last_join_strategies, (q, db8.last_join_strategies)
    # DISTINCT: not combinable across shards from ring partials -> falls
    # back, stays correct
    q = ("select dim.g, count(distinct fact.v) from dim join fact"
         " on fact.a = dim.a group by dim.g")
    assert db8.run_lines(q) == db1.run_lines(q)
    assert "ring" not in db8.last_join_strategies


def test_distinct_on_fused_dist_path():
    """Round-4 VERDICT item 7: count/sum/avg(DISTINCT) over a sharded join
    stays on the fused path (ring AND broadcast_fused) — shard-local
    sorted-unique + key-hash pair exchange + a second fused pass — when
    the groups are refined by the join key. Bit-exact vs single-device."""
    import numpy as np

    rng = np.random.default_rng(17)
    nd, nf = 24, 800
    # duplicate dim keys exercise the equal-partials/max-combine rule
    dks = list(range(nd)) + [3, 7]
    rows_d = ",".join(f"({k},{k % 5})" for k in dks)
    parts = []
    for i in range(nf):
        k = int(rng.integers(0, nd + 6))  # misses included
        v = int(rng.integers(-9, 9))      # few distinct values -> overlap
        x = (int(rng.integers(-40, 40))) / 4.0  # dyadic floats
        if i % 11 == 0:
            parts.append(f"({k},NULL,{x})")
        else:
            parts.append(f"({k},{v},{x})")
    ddl = [
        "create table dim(k int, g int)",
        "create table fact(k int, v int, x double)",
        f"insert into dim values {rows_d}",
        f"insert into fact values {','.join(parts)}",
    ]
    db1 = Database()
    db8 = Database(n_devices=8)
    for db in (db1, db8):
        for s in ddl:
            db.run(s)
    qs = [
        # group == join key (the soundness condition)
        "select dim.k, count(distinct fact.v), count(*) from dim join fact"
        " on fact.k = dim.k group by dim.k",
        "select dim.k, sum(distinct fact.v), avg(distinct fact.v) from dim"
        " join fact on fact.k = dim.k group by dim.k",
        # group by (key, attr): still refined by the key
        "select dim.k, dim.g, count(distinct fact.v), sum(fact.v) from dim"
        " join fact on fact.k = dim.k group by dim.k, dim.g",
        # DOUBLE distinct measure
        "select dim.k, count(distinct fact.x), sum(distinct fact.x) from"
        " dim join fact on fact.k = dim.k group by dim.k",
    ]
    for policy, tag in (("auto", "broadcast_fused"), ("ring", "ring")):
        db8.dist_join_policy = policy
        for q in qs:
            assert db8.run_lines(q) == db1.run_lines(q), (policy, q)
            assert tag in db8.last_join_strategies, (
                policy, q, db8.last_join_strategies,
            )
    # groups NOT refined by the key: falls back, stays correct
    db8.dist_join_policy = "auto"
    q = ("select dim.g, count(distinct fact.v) from dim join fact"
         " on fact.k = dim.k group by dim.g")
    assert db8.run_lines(q) == db1.run_lines(q)
    assert not any(
        s in ("ring", "broadcast_fused") for s in db8.last_join_strategies
    )
