"""TPC-H runner: all 22 queries with per-query oracles.

Round 1 ran 8 query shapes over a "dbgen-lite"; this runs the FULL 22-query
suite (benchmarks/tpch_queries.py, validation parameters) over dbgen-faithful
data (benchmarks/tpch_dbgen.py) and value-checks every query against an
independent pandas oracle (benchmarks/tpch_oracle.py). The reference only
scaffolds TPC-H (dbgen clone + qgen templates, no runner — reference
Makefile:46-70).

Usage:
  python -m benchmarks.tpch [--sf 0.01] [--check] [--queries 1,5,19]
                            [--devices N] [--repeat 2]

Timing protocol: each query runs `--repeat` times; the first run includes
compilation, the minimum of the remaining runs is reported as steady-state.
Each run ends with the result rows fetched to the host.
"""

from __future__ import annotations

import argparse
import time

from benchmarks import tpch_dbgen, tpch_queries
from benchmarks.np_oracles import compare as _compare


def run_query(db, qn: int):
    """Execute query qn; returns list of row tuples (typed host values)."""
    q = tpch_queries.ALL[qn]
    stmts = q if isinstance(q, list) else [q]
    rows = []
    for s in stmts:
        batches = db.run(s)
        out = []
        for b in batches:
            out.extend(tuple(r) for r in b.to_pylist())
        if out or (batches and batches[0].columns):
            rows = out
    return rows


def compare(got: list[tuple], exp: list[tuple], q: int) -> list[str]:
    """Cell-wise comparison with float tolerance; returns list of problems."""
    return _compare(got, exp, f"Q{q}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--queries", type=str, default=None,
                    help="comma-separated query numbers (default: all 22)")
    ap.add_argument("--devices", type=int, default=None,
                    help="run through the distributed engine over an N-device mesh")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--no-route", action="store_true",
                    help="disable the fused star-rollup route "
                         "(db.enable_fused_route=False) — the routed-vs-"
                         "unrouted comparison")
    args = ap.parse_args(argv)

    import sqlrs_tpu

    qns = (
        [int(x) for x in args.queries.split(",")]
        if args.queries
        else list(range(1, 23))
    )

    t0 = time.time()
    tables = tpch_dbgen.gen_tables(args.sf, seed=args.seed)
    print(f"generated SF{args.sf} "
          f"(lineitem={len(tables['lineitem']['l_orderkey']):,} rows) "
          f"in {time.time()-t0:.1f}s", flush=True)
    db = sqlrs_tpu.Database(n_devices=args.devices)
    if args.no_route:
        db.enable_fused_route = False
    t0 = time.time()
    tpch_dbgen.load_into(db, tables)
    print(f"loaded in {time.time()-t0:.1f}s", flush=True)

    failures = []
    timings = {}
    for qn in qns:
        times = []
        got = None
        db.last_fused_routes = []
        try:
            for r in range(max(args.repeat, 1)):
                t0 = time.time()
                got = run_query(db, qn)
                times.append(time.time() - t0)
        except Exception as e:  # keep the sweep alive; record the failure
            print(f"Q{qn:<2} ERROR {type(e).__name__}: {e}", flush=True)
            failures.append(f"Q{qn}: {type(e).__name__}: {e}")
            continue
        steady = min(times[1:]) if len(times) > 1 else times[0]
        timings[qn] = steady
        routes = sorted(set(db.last_fused_routes))
        print(f"Q{qn:<2} first={times[0]:7.2f}s steady={steady:7.2f}s "
              f"rows={len(got)}"
              + (f" routes={','.join(routes)}" if routes else ""),
              flush=True)
        if args.check:
            from benchmarks import tpch_oracle  # pandas, needed only here

            exp = tpch_oracle.ORACLES[qn](tables)
            issues = compare(got, exp, qn)
            if issues:
                failures.extend(issues)
                for msg in issues[:6]:
                    print("  MISMATCH", msg, flush=True)
            else:
                print(f"  Q{qn} oracle OK ({len(exp)} rows)", flush=True)

    total = sum(timings.values())
    print(f"total steady-state: {total:.2f}s over {len(qns)} queries")
    if args.check:
        if failures:
            print(f"CHECK FAILED: {len(failures)} mismatches")
            raise SystemExit(1)
        print(f"CHECK PASSED: {len(qns)}/22 queries match their oracles")


if __name__ == "__main__":
    main()
