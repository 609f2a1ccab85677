"""SQL-level fused-route benchmark: the headline star rollup through the
FULL engine (parse → bind → optimize → execute), routed vs general path.

An earlier review found a 50-200x gap between the engine's kernels and
SQL-path throughput; the dispatch diet closed the round-trip part and
exec/fused_route.py closes the kernel part for the star-rollup shape. This
runner measures that closure end to end on the SAME workload bench.py uses
(33.5M zipf rows x 64K dense dim keys):

  select d.k, sum(f.v), count(*) from f join d on f.k = d.k
  group by d.k order by d.k

Usage: python -m benchmarks.route_bench [--rows 25] [--groups 16] [--repeat 3]
(--rows/--groups are log2). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=25)
    ap.add_argument("--groups", type=int, default=16)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)


    import sqlrs_tpu
    from sqlrs_tpu.data import DeviceBatch, Schema
    from sqlrs_tpu.data.batch import Column
    from sqlrs_tpu.types import LogicalType as LT

    n, groups = 1 << args.rows, 1 << args.groups
    rng = np.random.default_rng(0)
    gid = np.minimum(rng.zipf(1.2, n), groups).astype(np.int64) - 1
    dim_keys = np.arange(groups, dtype=np.int64)
    fk = dim_keys[gid]
    fv = rng.integers(0, 100, n).astype(np.int64)
    fw = rng.integers(-50, 50, n).astype(np.int64)  # payload-only (negative)
    fx = rng.uniform(900.0, 105000.0, n)            # TPC-H-like DOUBLEs
    fdisc = rng.uniform(0.0, 0.1, n)

    db = sqlrs_tpu.Database()
    fschema = Schema.of([("k", LT.BIGINT), ("v", LT.BIGINT), ("w", LT.BIGINT),
                         ("x", LT.DOUBLE), ("disc", LT.DOUBLE)])
    db.create_memory_table(
        "f",
        DeviceBatch(
            fschema,
            [Column.from_numpy(LT.BIGINT, fk), Column.from_numpy(LT.BIGINT, fv),
             Column.from_numpy(LT.BIGINT, fw),
             Column.from_numpy(LT.DOUBLE, fx),
             Column.from_numpy(LT.DOUBLE, fdisc)],
            n,
        ),
    )
    db.create_memory_table(
        "d",
        DeviceBatch(
            Schema.of([("k", LT.BIGINT)]),
            [Column.from_numpy(LT.BIGINT, dim_keys)],
            groups,
        ),
    )
    sql = ("select d.k, sum(f.v), count(*) from f join d on f.k = d.k "
           "group by d.k order by d.k")

    def run(enabled: bool):
        db.enable_fused_route = enabled
        db.last_fused_routes = []
        db.run_lines(sql)  # warm (compile)
        times = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            out = db.run_lines(sql)
            times.append(time.perf_counter() - t0)
        return min(times), out, list(db.last_fused_routes)

    t_routed, out_r, routes = run(True)
    assert routes, "fused route did not fire"
    t_plain, out_p, _ = run(False)
    db.enable_fused_route = True
    assert out_r == out_p, "routed result differs from general path"

    # 6-aggregate rollup: packed value (min/max) + payload sums incl. a
    # negative-valued column and a DISTINCT — the round-3 widened surface,
    # still ONE device program through the route
    multi_sql = (
        "select d.k, sum(f.v), min(f.v), max(f.v), sum(f.w), "
        "count(distinct f.v), count(*) from f join d on f.k = d.k "
        "group by d.k order by d.k"
    )

    def run_multi(enabled: bool):
        db.enable_fused_route = enabled
        db.last_fused_routes = []
        db.run_lines(multi_sql)
        times = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            out = db.run_lines(multi_sql)
            times.append(time.perf_counter() - t0)
        return min(times), out, list(db.last_fused_routes)

    tm_r, om_r, m_routes = run_multi(True)
    assert m_routes, "multi-agg route did not fire"
    tm_p, om_p, _ = run_multi(False)
    db.enable_fused_route = True
    assert om_r == om_p, "multi-agg routed result differs"

    # Q3-shaped DOUBLE rollup: a float expression of fact columns rides the
    # variadic sort as a payload; ORDER BY the measure (not the key) lands
    # on the first-appearance variant + a G-sized general sort on top
    float_sql = (
        "select d.k, sum(f.x * (1 - f.disc)) as revenue, count(*) "
        "from f join d on f.k = d.k group by d.k "
        "order by revenue desc limit 10"
    )

    def run_float(enabled: bool):
        db.enable_fused_route = enabled
        db.last_fused_routes = []
        db.run_lines(float_sql)
        routes_f = list(db.last_fused_routes)
        times = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            out = db.run_lines(float_sql)
            times.append(time.perf_counter() - t0)
        return min(times), out, routes_f

    tf_r, of_r, f_routes = run_float(True)
    assert any("firstapp" in r for r in f_routes), f_routes
    tf_p, of_p, _ = run_float(False)
    db.enable_fused_route = True
    # float sums are XLA-reduction-ordered: compare with tolerance
    assert len(of_r) == len(of_p)
    for lr, lp in zip(of_r, of_p):
        kr, sr, cr = lr.split()
        kp, sp, cp = lp.split()
        assert kr == kp and cr == cp, (lr, lp)
        assert abs(float(sr) - float(sp)) <= 1e-9 * max(abs(float(sp)), 1)

    print(json.dumps({
        "metric": "sql_star_rollup_rows_per_sec",
        "value": round(n / t_routed),
        "unit": "rows/s",
        "vs_baseline": round(t_plain / t_routed, 2),
        "detail": {
            "rows": n, "groups": groups,
            "routed_s": round(t_routed, 4),
            "general_path_s": round(t_plain, 4),
            "route": routes[0],
            "baseline": "same engine, fused route disabled",
            "multi6_routed_s": round(tm_r, 4),
            "multi6_general_s": round(tm_p, 4),
            "multi6_speedup": round(tm_p / tm_r, 2),
            "multi6_rows_per_sec": round(n / tm_r),
            "multi6_aggs": "sum/min/max(v), sum(w<0 ok), "
                           "count(distinct v), count(*)",
            "float_q3_routed_s": round(tf_r, 4),
            "float_q3_general_s": round(tf_p, 4),
            "float_q3_speedup": round(tf_p / tf_r, 2),
            "float_q3_rows_per_sec": round(n / tf_r),
            "float_q3_shape": "sum(x*(1-disc)) DOUBLE, order by measure "
                              "desc limit 10 (firstapp route + G-sized sort)",
        },
    }))


if __name__ == "__main__":
    main()
