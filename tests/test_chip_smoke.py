"""chip_smoke.py's phases on the CPU at small size, against the numpy oracles
(benchmarks/np_oracles.py), plus its refusal to run off the GPU, the compile
cache choice and the device peak table."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

import chip_smoke
import sqlrs_tpu
from benchmarks import tpch_dbgen
from sqlrs_tpu.utils.profiling import hbm_bandwidth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tpch_db():
    tables = tpch_dbgen.gen_tables(0.01, seed=0)
    db = sqlrs_tpu.Database()
    chip_smoke.load_tpch(db, tables)
    return db, tables


@pytest.mark.parametrize("qn", chip_smoke.TPCH_QUERIES)
def test_tpch_query_matches_numpy_oracle(tpch_db, qn):
    db, tables = tpch_db
    chip_smoke.tpch_phase(db, tables, queries=[qn])


@pytest.mark.parametrize("spread", [False, True], ids=["dense", "spread"])
def test_rollup_matches_numpy_oracle(spread):
    groups = chip_smoke.ROLLUP_GROUPS
    gid, vals = chip_smoke.rollup_data(1 << 16, groups, seed=0)
    chip_smoke.rollup_phase(sqlrs_tpu.Database, gid, vals, groups, spread)


def test_rollup_sharded_matches_single_device():
    gid, vals = chip_smoke.rollup_data(1 << 12, 1 << 8, seed=1)

    def make_db():
        return sqlrs_tpu.Database(n_devices=4)

    chip_smoke.rollup_phase(make_db, gid, vals, 1 << 8, False,
                            single_db_factory=sqlrs_tpu.Database)


def _gpu(n=1):
    return [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
            ] * n


@pytest.mark.parametrize("case", ["cpu", "too_few_gpus"])
def test_device_check_refuses(case):
    devs, count = (jax.devices(), 1) if case == "cpu" else (_gpu(1), 4)
    with pytest.raises(SystemExit):
        chip_smoke.check_device(devs, count)
    chip_smoke.check_device(_gpu(4), 4)  # enough GPUs pass


def test_script_exits_nonzero_without_ok_line_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "checkout"])
def test_compile_cache_dir(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    expected = os.path.join(REPO, ".jax_cache")
    if env_dir:
        expected = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = expected
    assert sqlrs_tpu._compile_cache_dir(env) == (None if env_dir else expected)
    res = subprocess.run(
        [sys.executable, "-c",
         "import jax, sqlrs_tpu; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == expected


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("NVIDIA H100 PCIe", 2.0e12),
    ("Some Future GPU", None),
])
def test_peak_table(kind, peak):
    dev = SimpleNamespace(platform="gpu", device_kind=kind)
    if peak is None:
        with pytest.raises(KeyError, match="Some Future GPU"):
            hbm_bandwidth(dev)
    else:
        assert hbm_bandwidth(dev) == peak
    assert hbm_bandwidth(jax.devices()[0]) is None  # the CPU has no roofline
