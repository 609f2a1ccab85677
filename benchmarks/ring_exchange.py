"""Ring-staged vs monolithic probe exchange in the shuffle join.

Round-3 VERDICT item 7: stage the shuffle join's exchange in ring steps so
receive(k+1) overlaps probe(k). `dist_join._ring_probe_ranks` does exactly
that (ppermute hop issued before each per-chunk rank sort) with
bit-identical outputs (tests/test_distributed.py pins every array). This
runner measures phase-A step time for both on the virtual CPU mesh —
where compute serializes on one core, so the ring's n_dev rank sorts cost
extra; the DISPATCH/program structure (one compiled program either way,
collectives interleaved with compute for the ring) is the property that
carries to real ICI, where the per-hop latency hides behind the chunk
sorts. Prints one JSON line.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
       python -m benchmarks.ring_exchange [--rows 18] [--repeat 3]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=18)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)

    # ALWAYS CPU: this measures the virtual-mesh program structure
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices}"
        )
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import sqlrs_tpu  # noqa: F401
    from sqlrs_tpu.parallel.dist_join import shuffle_join_phase_a
    from sqlrs_tpu.parallel.mesh import make_mesh, row_sharding

    n_dev = args.devices
    mesh = make_mesh(n_dev)
    n = 1 << args.rows
    rng = np.random.default_rng(0)
    bkeys = rng.integers(0, n // 8, n).astype(np.int64)
    pkeys = rng.integers(0, n // 6, n).astype(np.int64)
    bpay = rng.integers(-50, 50, n).astype(np.int64)

    def put(x):
        return jax.device_put(jnp.asarray(x), row_sharding(mesh))

    ones = put(np.ones(n, np.bool_))
    b_args = ([(put(bkeys), ones)], [put(bpay)],
              put(np.arange(n, dtype=np.int64)), ones)
    p_args = ([(put(pkeys), ones)], [],
              put(np.arange(n, dtype=np.int64)), ones)
    cap = 2 * n // n_dev // n_dev

    def run(ring: bool):
        a = shuffle_join_phase_a(
            mesh, *b_args, *p_args,
            bucket_b=cap, bucket_p=cap, hot_capacity=256, ring=ring,
        )
        assert a.overflow == 0
        np.asarray(a.counts)  # force materialization
        return a

    out = {}
    for ring in (False, True):
        run(ring)  # compile
        ts = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            run(ring)
            ts.append(time.perf_counter() - t0)
        out["ring_s" if ring else "monolithic_s"] = float(np.median(ts))
    a0, a1 = run(False), run(True)
    same = all(
        np.array_equal(np.asarray(x), np.asarray(y))
        for x, y in [(a0.starts, a1.starts), (a0.counts, a1.counts),
                     (a0.order, a1.order), (a0.probe_mask, a1.probe_mask)]
    )
    print(json.dumps({
        "metric": "shuffle_exchange_phase_a_seconds",
        "value": round(out["ring_s"], 4),
        "unit": "s",
        "vs_baseline": round(out["monolithic_s"] / out["ring_s"], 3),
        "detail": {
            "rows": n, "devices": n_dev,
            "monolithic_s": round(out["monolithic_s"], 4),
            "ring_s": round(out["ring_s"], 4),
            "bit_identical": bool(same),
            "note": "virtual CPU mesh: compute serializes, ring pays "
                    "n_dev rank sorts; structure (ppermute overlapped "
                    "with per-chunk sorts) is what transfers to ICI",
        },
    }))


if __name__ == "__main__":
    main()
