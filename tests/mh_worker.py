"""Multi-host worker (driven by tests/test_multihost.py).

argv: pid port [nprocs=2] [devices_per_proc=4] [mode=kernels]

Each process owns `devices_per_proc` virtual CPU devices; after
`initialize_distributed` the flat data mesh spans all of them across the
processes — the CPU stand-in for a multi-host accelerator cluster (SURVEY.md
§2.3 collective backend). Modes:

  kernels: every distributed kernel (shuffle / salted / ring
    join+group-by, sample-sort), a hierarchical hosts×devices mesh, and a
    SQL join+agg through the DistributedExecutor.
  tpch: a real TPC-H query (Q3: 3-table join + group-by + ORDER BY +
    LIMIT) plus a null-aware NOT IN (anti mark-join) and a distributed
    ORDER BY, each bit-exact vs an in-process single-device run."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={sys.argv[4] if len(sys.argv) > 4 else 4}"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    pid = int(sys.argv[1])
    port = sys.argv[2]
    nprocs = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    mode = sys.argv[5] if len(sys.argv) > 5 else "kernels"

    # distributed init must precede ANY backend-initializing jax call —
    # including the engine import (sqlrs_tpu's package import touches the
    # backend), so this mirrors what a production launcher does: raw
    # jax.distributed.initialize first, engine import after
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nprocs, process_id=pid
    )
    import sqlrs_tpu  # noqa: F401  (x64)
    from sqlrs_tpu.parallel.mesh import initialize_distributed, make_mesh

    # the engine-level helper must be a no-op once the runtime is live
    initialize_distributed()
    assert jax.process_count() == nprocs

    if mode == "tpch":
        _tpch_mode(pid)
        return

    assert len(jax.devices()) == 8

    import numpy as np
    import jax.numpy as jnp

    from sqlrs_tpu.parallel.dist_ops import (
        dist_join_groupby_ring,
        dist_join_groupby_salted,
        dist_join_groupby_shuffle,
        dist_sort,
    )
    from sqlrs_tpu.parallel.mesh import replicated, row_sharding
    from jax.experimental import multihost_utils

    def fetch(x):
        # results may be sharded across processes; gather the global value
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))

    mesh = make_mesh()
    n, groups = 512, 16
    rng = np.random.default_rng(0)
    dim_keys = np.arange(groups, dtype=np.int64) * 7 + 3
    gid = np.minimum(rng.zipf(1.3, n), groups).astype(np.int64) - 1
    fact_keys = dim_keys[gid]
    fact_vals = rng.integers(0, 100, n).astype(np.int64)
    expect_total = int(fact_vals.sum())

    fk = jax.device_put(jnp.asarray(fact_keys), row_sharding(mesh))
    fv = jax.device_put(jnp.asarray(fact_vals), row_sharding(mesh))
    dk = jax.device_put(jnp.asarray(dim_keys), replicated(mesh))
    dk_sharded = jax.device_put(jnp.asarray(dim_keys), row_sharding(mesh))

    sums, _, _ovf = jax.jit(
        lambda a, b, c: dist_join_groupby_shuffle(
            mesh, a, b, c, groups, bucket_capacity=n
        )
    )(fk, fv, dk)
    assert int(fetch(_ovf)) == 0, "shuffle overflow" 
    assert int(fetch(jnp.sum(sums))) == expect_total, "shuffle"

    sums2, _, _ovf2 = jax.jit(
        lambda a, b, c: dist_join_groupby_salted(
            mesh, a, b, c, groups, bucket_capacity=n, hot_capacity=32
        )
    )(fk, fv, dk)
    assert int(fetch(_ovf2)) == 0, "salted overflow" 
    assert int(fetch(jnp.sum(sums2))) == expect_total, "salted"

    sums3, _ = jax.jit(
        lambda a, b, c: dist_join_groupby_ring(mesh, a, b, c, groups)
    )(fk, fv, dk_sharded)
    assert int(fetch(jnp.sum(sums3))) == expect_total, "ring"

    ks, valid = jax.jit(lambda a: dist_sort(mesh, a, bucket_capacity=2 * n))(fk)
    got = fetch(ks)[fetch(valid)]
    assert np.array_equal(got, np.sort(fact_keys)), "dist_sort"

    # hierarchical hosts×devices mesh: collectives over both axes
    from sqlrs_tpu.parallel.mesh import make_multihost_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    mh = make_multihost_mesh()
    assert mh.devices.shape == (2, 4)
    x = jax.device_put(
        jnp.ones((8,)), NamedSharding(mh, P(("host", "device")))
    )
    total = jax.jit(
        jax.shard_map(
            lambda a: jax.lax.psum(jnp.sum(a), ("host", "device")),
            mesh=mh,
            in_specs=P(("host", "device")),
            out_specs=P(),
        )
    )(x)
    assert int(fetch(total)) == 8, "2d psum"

    # SQL-level distributed execution across the 2-process mesh
    from sqlrs_tpu import Database
    from sqlrs_tpu.data import DeviceBatch, Schema
    from sqlrs_tpu.types import LogicalType as LT

    db = Database(mesh=mesh)
    db.create_memory_table(
        "fact",
        DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT), ("v", LT.BIGINT)]),
            {"k": fact_keys.tolist(), "v": fact_vals.tolist()},
        ),
    )
    db.create_memory_table(
        "dim",
        DeviceBatch.from_pydict(
            Schema.of([("k", LT.BIGINT)]), {"k": dim_keys.tolist()}
        ),
    )
    (line,) = db.run_lines(
        "select count(*), sum(v) from fact join dim on fact.k = dim.k where v >= 0"
    )
    assert line == f"{n} {expect_total}", line

    print(f"MH_OK pid={pid}", flush=True)


def _tpch_mode(pid: int) -> None:
    """A real TPC-H query over the multi-process mesh, bit-exact vs an
    in-process single-device run (VERDICT round-2 item 8): Q3 covers the
    3-table join + group-by + ORDER BY + LIMIT chain; the NOT IN statement
    covers the distributed anti mark-join; the bare ORDER BY covers
    dist_sort_rows tie order across processes."""
    from benchmarks import tpch_dbgen, tpch_queries
    from sqlrs_tpu import Database
    from sqlrs_tpu.parallel.mesh import make_mesh

    tables = tpch_dbgen.gen_tables(0.01, seed=7)  # deterministic everywhere

    db1 = Database()  # local single-device oracle
    tpch_dbgen.load_into(db1, tables)
    dbm = Database(mesh=make_mesh())
    tpch_dbgen.load_into(dbm, tables)

    checks = [
        tpch_queries.ALL[3],
        "select o_custkey from orders where o_custkey not in "
        "(select c_custkey from customer where c_acctbal < 0) "
        "order by o_custkey limit 20",
        "select l_orderkey, l_linenumber from lineitem "
        "order by l_extendedprice desc, l_orderkey limit 15",
    ]
    for sql in checks:
        exp = db1.run_lines(sql)
        got = dbm.run_lines(sql)
        assert len(got) == len(exp), f"{sql[:60]}...: {len(got)} != {len(exp)} rows"
        for g, e in zip(got, exp):
            assert _cells_match(g, e), f"{sql[:60]}...: {g!r} != {e!r}"

    print(f"MH_OK pid={pid}", flush=True)


def _cells_match(got_line: str, exp_line: str) -> bool:
    """Cell-wise equality with float tolerance (the engine's own TPC-H
    standard, benchmarks/tpch.compare rel_tol=1e-9): distributed partial
    aggregation legitimately reorders float summation, so last-ulp drift
    between mesh shapes is expected — exact compare for everything else."""
    import math

    gs, es = got_line.split(), exp_line.split()
    if len(gs) != len(es):
        return False
    for g, e in zip(gs, es):
        if g == e:
            continue
        try:
            if math.isclose(float(g), float(e), rel_tol=1e-9, abs_tol=1e-6):
                continue
        except ValueError:
            pass
        return False
    return True


if __name__ == "__main__":
    main()
