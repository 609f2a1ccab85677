"""Weak-scaling measurement over the virtual CPU mesh.

The ≥80%-scaling-efficiency north star (BASELINE.md) cannot be measured on
real hardware in this environment (one physical chip); this runner produces
the next-best evidence: a weak-scaling curve (problem size grows with the
device count, so perfect scaling = flat wall time) over the
xla_force_host_platform_device_count mesh for

  1. the headline distributed kernel (broadcast join + group-by,
     parallel/dist_ops.dist_join_groupby_broadcast), and
  2. one end-to-end SQL query (TPC-H Q1) through Database(n_devices=n),

plus the per-step collective payload each configuration moves (computed
from the algorithm's shapes — the broadcast kernel's only cross-device
traffic is one O(G) psum; the SQL path adds the O(G) partial all_gather).

CPU-mesh caveat, recorded with the numbers: the 8 "devices" are threads of
one shared-memory CPU, so collectives cost ~memcpy and compute shares
cores — the curve measures the ENGINE's sharding overhead (exchange
bucketing, psum combines, padding), not ICI behavior. Efficiency on real
multi-chip ICI is expected to be HIGHER for the broadcast path (payload is
O(G), compute O(N/p)) and lower for shuffle-heavy plans.

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python -m benchmarks.scaling [--base-rows 2000000] [--sf 0.05]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _bench_kernel(n_dev: int, base_rows: int, groups: int, repeat: int):
    import jax
    import jax.numpy as jnp

    from sqlrs_tpu.parallel.dist_ops import dist_join_groupby_broadcast
    from sqlrs_tpu.parallel.mesh import make_mesh, replicated, row_sharding

    mesh = make_mesh(n_dev)
    n = base_rows * n_dev  # weak scaling: rows grow with devices
    rng = np.random.default_rng(0)
    dim_keys = np.arange(groups, dtype=np.int64) * 7 + 3
    gid = np.minimum(rng.zipf(1.3, n), groups).astype(np.int64) - 1
    fk = jax.device_put(jnp.asarray(dim_keys[gid]), row_sharding(mesh))
    fv = jax.device_put(
        jnp.asarray(rng.integers(0, 100, n).astype(np.int64)),
        row_sharding(mesh),
    )
    dk = jax.device_put(jnp.asarray(dim_keys), replicated(mesh))

    fn = jax.jit(
        lambda a, b, c: dist_join_groupby_broadcast(mesh, a, b, c, groups)
    )
    times = []
    for _ in range(repeat + 1):
        t0 = time.perf_counter()
        sums, counts = fn(fk, fv, dk)
        _ = int(np.asarray(sums)[0])  # force materialization
        times.append(time.perf_counter() - t0)
    steady = min(times[1:])
    # the ONLY cross-device traffic: one psum of (sums, counts) = 2 x G x 8B
    payload = 2 * groups * 8
    return dict(
        n_devices=n_dev, rows=n, steady_s=steady,
        rows_per_s=n / steady, collective_bytes_per_step=payload,
    )


def _bench_sql(n_dev: int, sf: float, repeat: int):
    import sqlrs_tpu
    from benchmarks import tpch, tpch_dbgen

    tables = tpch_dbgen.gen_tables(sf * n_dev, seed=0)  # weak scaling
    db = sqlrs_tpu.Database(n_devices=n_dev)
    tpch_dbgen.load_into(db, tables)
    n_rows = len(tables["lineitem"]["l_orderkey"])
    times = []
    for _ in range(repeat + 1):
        t0 = time.perf_counter()
        tpch.run_query(db, 1)
        times.append(time.perf_counter() - t0)
    steady = min(times[1:])
    # Q1 dist plan: grouped-agg partials all_gathered once: G(=4 groups)
    # x ~21 partial-state arrays x 8B x n_dev shards
    payload = 4 * 21 * 8 * n_dev
    return dict(
        n_devices=n_dev, rows=n_rows, steady_s=steady,
        rows_per_s=n_rows / steady, collective_bytes_per_step=payload,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-rows", type=int, default=2_000_000)
    ap.add_argument("--groups", type=int, default=4096)
    ap.add_argument("--sf", type=float, default=0.05)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--devices", type=str, default="1,2,4,8")
    args = ap.parse_args(argv)


    import sqlrs_tpu  # noqa: F401  (x64 + backend init)

    devs = [int(x) for x in args.devices.split(",")]
    out = {"kernel": [], "sql_q1": []}
    for n in devs:
        r = _bench_kernel(n, args.base_rows, args.groups, args.repeat)
        out["kernel"].append(r)
        print(
            f"kernel  n={n} rows={r['rows']:>10,} steady={r['steady_s']:.3f}s "
            f"{r['rows_per_s']/1e6:7.1f}M rows/s "
            f"payload={r['collective_bytes_per_step']}B", flush=True,
        )
    for n in devs:
        r = _bench_sql(n, args.sf, args.repeat)
        out["sql_q1"].append(r)
        print(
            f"sql Q1  n={n} rows={r['rows']:>10,} steady={r['steady_s']:.3f}s "
            f"{r['rows_per_s']/1e6:7.1f}M rows/s "
            f"payload={r['collective_bytes_per_step']}B", flush=True,
        )
    # Efficiency vs the ACHIEVABLE ideal on this host: n virtual devices
    # backed by c physical cores can speed up at most min(n, c)x, so ideal
    # weak-scaling rows/s = rps(1) * min(n, c). On a 1-core host that ideal
    # is FLAT rows/s and the ratio isolates the engine's sharding overhead
    # (exchange bucketing, padding, collective emulation) — the quantity
    # that carries over to real multi-chip ICI, where compute genuinely
    # parallelizes. The raw per-device ratio is reported too.
    import os as _os

    cores = _os.cpu_count() or 1
    out["physical_cores"] = cores
    for name in ("kernel", "sql_q1"):
        rows = out[name]
        base = rows[0]["rows_per_s"] / rows[0]["n_devices"]
        for r in rows:
            ideal = base * min(r["n_devices"], cores)
            r["efficiency_vs_cores"] = r["rows_per_s"] / ideal
            r["efficiency_vs_devices"] = r["rows_per_s"] / (
                base * r["n_devices"]
            )
        eff = ", ".join(
            f"{r['n_devices']}dev={r['efficiency_vs_cores']:.0%}"
            for r in rows
        )
        print(f"{name} weak-scaling efficiency (vs {cores}-core ideal): {eff}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
