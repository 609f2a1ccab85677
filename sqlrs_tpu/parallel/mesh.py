"""Device mesh construction.

The engine's collective backend is jax.lax collectives over a named mesh
(SURVEY.md §2.3: the reference has NO distributed execution — no NCCL/MPI,
single-process tokio streams only; this layer is the from-scratch
replacement: all-to-all for repartition, psum/all-gather for combines,
which XLA hands to NCCL on GPUs).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "x"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the JAX distributed runtime (multi-HOST execution): after this,
    jax.devices() is the GLOBAL device list and every mesh built from it
    spans hosts (SURVEY.md §2.3 collective-backend row). Parameters fall
    back to the SQLRS_TPU_COORDINATOR / SQLRS_TPU_NUM_PROCESSES /
    SQLRS_TPU_PROCESS_ID environment variables, and to JAX's own
    autodetection when absent.

    On the CPU backend the gloo collectives transport is enabled so
    multi-process meshes work in tests/CI without accelerators
    (tests/test_multihost.py runs the full kernel set over 2 processes)."""
    import os

    from jax._src import distributed as _jaxdist

    if _jaxdist.global_state.client is not None:
        return  # already initialized (checking via process_count would
        # itself initialize the backend, defeating the call)
    coordinator_address = coordinator_address or os.environ.get(
        "SQLRS_TPU_COORDINATOR"
    )
    if num_processes is None and os.environ.get("SQLRS_TPU_NUM_PROCESSES"):
        num_processes = int(os.environ["SQLRS_TPU_NUM_PROCESSES"])
    if process_id is None and os.environ.get("SQLRS_TPU_PROCESS_ID"):
        process_id = int(os.environ["SQLRS_TPU_PROCESS_ID"])
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass  # not a CPU backend / option renamed
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS) -> Mesh:
    """Flat 1-axis mesh over the first `n_devices` of the (global, multi-host
    if initialized) device list — every dist op shards and communicates over
    this one axis. The cards of one host are joined all to all, so the mesh
    follows the algorithm, not a topology. Raises ValueError when fewer
    devices exist than were asked for."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"asked for a {n_devices}-device mesh, but JAX sees "
                f"{len(devs)} device(s)"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def make_multihost_mesh(axis_names: tuple = ("host", "device")) -> Mesh:
    """Hierarchical hosts×devices mesh (SURVEY §2.3 'Mesh(hosts, devices)'
    contract) for layouts that want the host boundary explicit — e.g.
    host-major range partitioning so shuffles prefer the intra-host axis.
    The flat mesh remains the default data path; collectives over BOTH axes
    (axis_name=axis_names) are equivalent to the flat mesh's."""
    devs = np.array(jax.devices())
    n_proc = max(jax.process_count(), 1)
    if len(devs) % n_proc != 0:
        return Mesh(devs.reshape(1, -1), axis_names)
    return Mesh(devs.reshape(n_proc, -1), axis_names)


def spmd(fn, **shard_map_kwargs):
    """`shard_map(fn, ...)` compiled as ONE program. Called eagerly,
    shard_map runs its body primitive by primitive, compiling each op for
    the mesh again on every call — thousands of compiles per query."""
    return jax.jit(jax.shard_map(fn, **shard_map_kwargs))


def row_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> NamedSharding:
    """Rows partitioned over the data axis (hash/range-partitioned tables)."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
