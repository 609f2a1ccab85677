"""End-to-end smoke test of the SQL engine on NVIDIA GPUs.

    python chip_smoke.py [--seed 0]     # one GPU
    python chip_smoke.py --devices 4    # four GPUs of one host

One process drives everything through the public API (`sqlrs_tpu.Database`
and `run`), on `jax.devices()` with no platform pinned, and checks every
result against plain-numpy oracles (`benchmarks/np_oracles.py`):

  (a) device check: JAX must see GPUs; the card's name and power limit are
      printed as nvidia-smi reports them;
  (b) TPC-H at SF1 (in-repo dbgen from --seed): Q1, Q3, Q4, Q6, Q13, Q18,
      each run twice — the two runs must be identical;
  (c) the zipf star rollup as SQL: 2^25 fact rows, zipf(1.2) keys over
      2^16 dimension keys, values in [0, 100), once with dense dimension
      keys and once with spread ones.

With --devices N only (b) and (c) run, through `Database(n_devices=N)`, and
each result must also equal the single-device engine's, row order included:
integer, date and string cells bit for bit, DOUBLE cells within the oracle
tolerance (the sharded engine adds per-shard partial sums in another order;
the count of float cells that differ in the last bits is printed).

Any failure raises and exits non-zero. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time

import numpy as np

TPCH_SF = 1.0
TPCH_QUERIES = (1, 3, 4, 6, 13, 18)
ROLLUP_ROWS = 1 << 25
ROLLUP_GROUPS = 1 << 16
ROLLUP_SQL = (
    "select d.k, sum(f.v), count(*) from fact f join dim d on f.k = d.k "
    "group by d.k order by d.k"
)


def log(msg: str) -> None:
    print(msg, flush=True)


def check_device(devices, count: int) -> None:
    """Refuse to run anywhere but on at least `count` GPUs."""
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, but JAX's first device is {platform!r}"
        )
    if len(devices) < count:
        raise SystemExit(
            f"chip_smoke: needs {count} GPUs, JAX sees {len(devices)}"
        )


def card_info() -> str:
    """name, power.limit of every card, as nvidia-smi prints them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: not found, card name and power limit unknown"
    res = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        return f"nvidia-smi failed ({res.returncode}): {res.stderr.strip()}"
    return res.stdout.strip()


def query_rows(db, sql: str) -> list[tuple]:
    return [tuple(r) for b in db.run(sql) for r in b.to_pylist()]


def timed_runs(db, sql: str, label: str, repeat: int = 2) -> list[tuple]:
    """Run `sql` `repeat` times, print first/warm seconds and the fused
    routes that fired, and require identical results from every run."""
    db.last_fused_routes = []
    runs, secs = [], []
    for _ in range(repeat):
        t0 = time.perf_counter()
        runs.append(query_rows(db, sql))
        secs.append(time.perf_counter() - t0)
    routes = sorted(set(db.last_fused_routes))
    joins = getattr(db, "last_join_strategies", None)
    log(f"{label}: first {secs[0]:.3f} s, warm {secs[-1]:.3f} s, "
        f"{len(runs[0])} rows, routes {routes or '-'}"
        + (f", sharded joins {joins}" if db.mesh is not None else ""))
    for r in runs[1:]:
        if r != runs[0]:
            raise AssertionError(f"{label}: two runs of one query differ")
    return runs[0]


def check(got: list[tuple], exp: list[tuple], label: str) -> None:
    from benchmarks.np_oracles import compare

    issues = compare(got, exp, label)
    if issues:
        raise AssertionError("\n".join(issues))


def check_sharded(got: list[tuple], one: list[tuple], label: str) -> None:
    """The sharded engine against the single-device one: every non-float
    cell and the row order must be identical. DOUBLE sums are added in
    another order (per-shard partials, then a combine), so float cells must
    agree within the oracle tolerance; how many are not bit-identical is
    printed."""
    from benchmarks.np_oracles import compare

    issues = compare(got, one, f"{label} sharded vs single-device")
    if issues:
        raise AssertionError("\n".join(issues))
    floats = [(a, b) for ra, rb in zip(got, one) for a, b in zip(ra, rb)
              if isinstance(b, float)]
    differ = [(a, b) for a, b in floats if a != b]
    worst = max((abs(a - b) / max(abs(b), 1e-300) for a, b in differ),
                default=0.0)
    log(f"{label}: sharded vs single-device: {len(differ)} of {len(floats)} "
        f"float cells not bit-identical (max relative difference {worst:.3g})")


def load_tpch(db, tables: dict) -> None:
    from benchmarks import tpch_dbgen

    t0 = time.perf_counter()
    tpch_dbgen.load_into(db, tables)
    log(f"tpch load: {time.perf_counter() - t0:.3f} s")


def tpch_phase(db, tables: dict, queries=TPCH_QUERIES, single_db=None) -> None:
    """Each query twice through `db`; checked against the numpy oracle and,
    when given, against the single-device engine `single_db`."""
    from benchmarks import np_oracles, tpch_queries

    for qn in queries:
        got = timed_runs(db, tpch_queries.ALL[qn], f"Q{qn}")
        check(got, np_oracles.TPCH[qn](tables), f"Q{qn}")
        if single_db is not None:
            check_sharded(got, query_rows(single_db, tpch_queries.ALL[qn]),
                          f"Q{qn}")


def rollup_data(n: int, groups: int, seed: int):
    """Zipf(1.2) group ids over `groups` dimension rows and values in
    [0, 100) for `n` fact rows."""
    rng = np.random.default_rng(seed)
    gid = np.minimum(rng.zipf(1.2, n), groups).astype(np.int64) - 1
    vals = rng.integers(0, 100, n, dtype=np.int64)
    return gid, vals


def dim_keys(groups: int, spread: bool) -> np.ndarray:
    keys = np.arange(groups, dtype=np.int64)
    return keys * 1013904223 + 12345 if spread else keys


def rollup_phase(make_db, gid, vals, groups: int, spread: bool,
                 single_db_factory=None) -> None:
    """The star rollup through SQL on freshly loaded fact/dim tables."""
    from benchmarks import np_oracles
    from sqlrs_tpu.types import LogicalType as LT

    label = f"rollup {'spread' if spread else 'dense'}"
    dk = dim_keys(groups, spread)
    fk = dk[gid]
    dbs = [make_db()] + ([single_db_factory()] if single_db_factory else [])
    t0 = time.perf_counter()
    for db in dbs:
        db.create_memory_table_numpy("fact", [("k", LT.BIGINT), ("v", LT.BIGINT)],
                                     [fk, vals])
        db.create_memory_table_numpy("dim", [("k", LT.BIGINT)], [dk])
    log(f"{label} load: {time.perf_counter() - t0:.3f} s")
    if dbs[0].mesh is not None:
        print_shard_bytes(dbs[0])
    got = timed_runs(dbs[0], ROLLUP_SQL, label)
    check(got, np_oracles.rollup(dk, gid, vals), label)
    if len(dbs) > 1:
        check_sharded(got, query_rows(dbs[1], ROLLUP_SQL), label)


def print_shard_bytes(db) -> None:
    """Bytes each device holds of every table once the sharded engine has
    scanned it (the same layout DistributedExecutor's table scan builds)."""
    from sqlrs_tpu.parallel.dist_executor import shard_batch

    for name, entry in sorted(db.catalog.schema().tables.items()):
        sb = shard_batch(entry.storage.scan(), db.mesh)
        per_dev: dict = {}
        for arr in [c.data for c in sb.columns] + [c.valid for c in sb.columns]:
            for shard in arr.addressable_shards:
                per_dev[shard.device.id] = (
                    per_dev.get(shard.device.id, 0) + shard.data.nbytes
                )
        log(f"table {name}: bytes per device "
            + ", ".join(f"{d}: {b}" for d, b in sorted(per_dev.items())))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=None,
                    help="run (b) and (c) through Database(n_devices=N) and "
                         "compare with the single-device engine")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    check_device(devices, args.devices or 1)
    log(f"devices: {len(devices)} x {devices[0].device_kind}")
    log(f"card (name, power.limit): {card_info()}")

    import sqlrs_tpu
    from benchmarks import tpch_dbgen

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    tables = tpch_dbgen.gen_tables(TPCH_SF, seed=args.seed)
    log(f"tpch gen SF{TPCH_SF}: {time.perf_counter() - t0:.3f} s, "
        f"{len(tables['lineitem']['l_orderkey'])} lineitem rows")
    gid, vals = rollup_data(ROLLUP_ROWS, ROLLUP_GROUPS, args.seed)

    if args.devices:
        db = sqlrs_tpu.Database(n_devices=args.devices)
        single = sqlrs_tpu.Database()
        load_tpch(db, tables)
        load_tpch(single, tables)
        print_shard_bytes(db)
        tpch_phase(db, tables, single_db=single)
        del db, single

        def make_db():
            return sqlrs_tpu.Database(n_devices=args.devices)

        for spread in (False, True):
            rollup_phase(make_db, gid, vals, ROLLUP_GROUPS, spread,
                         single_db_factory=sqlrs_tpu.Database)
    else:
        db = sqlrs_tpu.Database()
        load_tpch(db, tables)
        tpch_phase(db, tables)
        del db
        for spread in (False, True):
            rollup_phase(sqlrs_tpu.Database, gid, vals, ROLLUP_GROUPS, spread)
    log(f"all phases: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)


if __name__ == "__main__":
    main()
