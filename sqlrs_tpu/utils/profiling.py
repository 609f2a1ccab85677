"""Query profiling: per-operator rows/bytes counters and roofline accounting.

The reference has no metrics at all (SURVEY.md §5: stdout prints only).
This module provides:

- QueryProfile: per-operator row counts, wall time, estimated bytes touched;
- hbm_bandwidth() / OpStats.roofline_fraction(): the device's peak memory
  bandwidth and the share of it a measured operator achieved;
- trace(): optional jax.profiler integration for deep dives.

Enabled per-session via Database(profile=True) or the SQLRS_TPU_PROFILE env
var; counters are collected on the host at operator boundaries (which are
already pipeline breakers, so no extra syncs).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

# Peak device-memory bandwidth (bytes/s) by jax `device_kind`. Source:
# NVIDIA H100 Tensor Core GPU data sheet (SXM5: 3.35 TB/s HBM3; PCIe:
# 2.0 TB/s HBM2e). A GPU missing from the table is an error, not a default:
# a made-up peak would make every roofline share wrong.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def hbm_bandwidth(device=None) -> float | None:
    """Peak memory bandwidth of `device` (default: the first JAX device);
    None on the CPU, which has no roofline here. Raises KeyError for an
    accelerator the table does not list."""
    if device is None:
        import jax

        device = jax.devices()[0]
    if device.platform == "cpu":
        return None
    try:
        return HBM_BYTES_PER_S[device.device_kind]
    except KeyError:
        raise KeyError(
            f"no peak bandwidth known for device kind {device.device_kind!r}; "
            "add it to HBM_BYTES_PER_S with its source"
        ) from None


@dataclass
class OpStats:
    op: str
    rows_in: int = 0
    rows_out: int = 0
    bytes_touched: int = 0
    wall_s: float = 0.0  # subtree wall
    self_s: float = 0.0  # wall minus direct children (operator's own work)
    depth: int = 0

    def rows_per_sec(self) -> float:
        n = self.rows_in or self.rows_out
        return n / self.self_s if self.self_s > 0 else 0.0

    def roofline_fraction(self, bytes_per_row: int = 16) -> float | None:
        """Fraction of the bandwidth-bound rows/s this operator achieved
        (None where the device has no peak, i.e. on the CPU)."""
        bw = hbm_bandwidth()
        return None if bw is None else self.rows_per_sec() * bytes_per_row / bw


@dataclass
class QueryProfile:
    ops: list[OpStats] = field(default_factory=list)
    _stack: list[float] = field(default_factory=list)  # child-time accumulators

    @contextlib.contextmanager
    def measure(self, op: str, rows_in: int = 0, bytes_touched: int = 0):
        stats = OpStats(
            op=op, rows_in=rows_in, bytes_touched=bytes_touched,
            depth=len(self._stack),
        )
        self._stack.append(0.0)
        t0 = time.perf_counter()
        try:
            yield stats
        finally:
            stats.wall_s = time.perf_counter() - t0
            child_s = self._stack.pop()
            stats.self_s = max(stats.wall_s - child_s, 0.0)
            if self._stack:
                self._stack[-1] += stats.wall_s
            self.ops.append(stats)

    def report(self) -> str:
        lines = [
            f"{'operator':44s} {'rows_out':>10s} {'self_ms':>9s} {'rows/s':>12s}"
        ]
        for s in reversed(self.ops):  # root first
            label = ("  " * s.depth + s.op)[:44]
            lines.append(
                f"{label:44s} {s.rows_out:10d} "
                f"{s.self_s * 1e3:9.2f} {s.rows_per_sec():12.0f}"
            )
        return "\n".join(lines)


def profiling_enabled() -> bool:
    return os.environ.get("SQLRS_TPU_PROFILE", "0") == "1"


@contextlib.contextmanager
def trace(path: str = "/tmp/sqlrs_tpu_trace"):
    """jax.profiler trace scope for kernel-level analysis."""
    import jax

    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
