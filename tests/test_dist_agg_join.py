"""The sharded engine's fused aggregate-over-join (DistributedExecutor.
_try_ring_agg_join) with the dimension table on either side of the join:
results and first-appearance group order must equal the single-device
engine's, through both fused kernels (broadcast and ring)."""

import jax
import numpy as np
import pytest

import sqlrs_tpu
from sqlrs_tpu.parallel.mesh import make_mesh
from sqlrs_tpu.types import LogicalType as LT

QUERIES = [
    # dim on the probe (right) side, as `from fact join dim` writes it
    "select d.k, sum(f.v), count(*) from f join d on f.k = d.k group by d.k",
    "select d.k, d.w, min(f.v), max(f.v), avg(f.v) from f join d "
    "on f.k = d.k group by d.k, d.w",
    "select d.k, sum(f.v), count(*) from f join d on f.k = d.k "
    "group by d.k order by d.k",
    # dim on the build (left) side
    "select d.k, sum(f.v) from d join f on d.k = f.k group by d.k",
]


@pytest.fixture(scope="module")
def dbs():
    rng = np.random.default_rng(3)
    n, g = 3000, 50
    dk = (np.arange(g, dtype=np.int64) * 7919 + 11)[rng.permutation(g)]
    fk = dk[rng.integers(0, g, n)]
    fk[::13] = 5  # misses
    fv = rng.integers(-50, 100, n)
    out = [sqlrs_tpu.Database(), sqlrs_tpu.Database(n_devices=4)]
    for db in out:
        db.create_memory_table_numpy(
            "f", [("k", LT.BIGINT), ("v", LT.BIGINT)], [fk, fv])
        db.create_memory_table_numpy(
            "d", [("k", LT.BIGINT), ("w", LT.BIGINT)], [dk, np.arange(g)])
    return out


@pytest.mark.parametrize("kernel", ["broadcast_fused", "ring"])
@pytest.mark.parametrize("sql", QUERIES)
def test_fused_agg_join_matches_single_device(dbs, sql, kernel):
    single, sharded = dbs
    sharded.dist_ring_min_build = 0 if kernel == "ring" else 1 << 16
    sharded.last_join_strategies = []
    assert sharded.run_lines(sql) == single.run_lines(sql)
    assert sharded.last_join_strategies == [kernel]


def test_make_mesh_refuses_more_devices_than_exist():
    with pytest.raises(ValueError, match="device"):
        make_mesh(len(jax.devices()) + 1)
