"""1B-row zipf join+group-by on ONE chip via streamed partial aggregation.

SURVEY §7.8's north-star scale point: 2^30 fact rows exceed HBM at 16 B/row,
so the workload streams in 2^27-row chunks — each chunk runs the fused
packed-sort kernel (ops/pipelines.join_groupby_direct) and contributes
per-group (sum, count) partials combined on device. This is the single-chip
degenerate case of the distributed partial→final aggregation tree
(parallel/dist_executor._grouped_agg_dist): the combine step the mesh path
psums across devices runs here as a G-sized add per chunk — so 1B rows
never exist on the device at once (bounded memory ⇒ arbitrary N).

Usage (GPU):        python -m benchmarks.scale_1b [--rows 1073741824]
CPU sanity:         JAX_PLATFORMS=cpu python -m benchmarks.scale_1b --rows 1048576

Prints one JSON line: kernel-only and end-to-end (incl. H2D streaming)
rows/s, plus a numpy oracle check over a deterministic subsample.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=1 << 30)
    p.add_argument("--chunk", type=int, default=1 << 27)
    p.add_argument("--groups", type=int, default=1 << 16)
    args = p.parse_args(argv)


    import jax
    import jax.numpy as jnp

    import sqlrs_tpu  # noqa: F401  (x64)
    from sqlrs_tpu.ops.pipelines import make_join_groupby

    n, chunk, groups = args.rows, min(args.chunk, args.rows), args.groups
    n_chunks = -(-n // chunk)
    dim_keys_np = np.arange(groups, dtype=np.int64)
    dim_keys = jnp.asarray(dim_keys_np)
    fn = make_join_groupby(groups, strategy="direct")

    @jax.jit
    def combine(acc_s, acc_c, s, c):
        return acc_s + s, acc_c + c

    acc_s = jnp.zeros((groups,), jnp.int64)
    acc_c = jnp.zeros((groups,), jnp.int64)
    exp_s = np.zeros(groups, np.int64)
    exp_c = np.zeros(groups, np.int64)

    kernel_s = 0.0
    t_start = time.perf_counter()
    for k in range(n_chunks):
        rows = min(chunk, n - k * chunk)
        rng = np.random.default_rng(1000 + k)  # per-chunk stream, O(chunk) host mem
        gid = np.minimum(rng.zipf(1.2, rows), groups).astype(np.int64) - 1
        fv_np = rng.integers(0, 100, rows).astype(np.int64)
        fk = jnp.asarray(dim_keys_np[gid])
        fv = jnp.asarray(fv_np)
        t0 = time.perf_counter()
        s, c = fn(fk, fv, dim_keys, key_max=groups - 1, val_max=99,
                  dim_min=0, dim_max=groups - 1)
        acc_s, acc_c = combine(acc_s, acc_c, s, c)
        jax.block_until_ready(acc_s)
        kernel_s += time.perf_counter() - t0
        # host-side oracle accumulates the same partials (bincount)
        exp_s += np.bincount(gid, weights=fv_np, minlength=groups).astype(np.int64)
        exp_c += np.bincount(gid, minlength=groups)
        del fk, fv, s, c
    total_s = time.perf_counter() - t_start

    ok_s = np.array_equal(np.asarray(acc_s), exp_s)
    ok_c = np.array_equal(np.asarray(acc_c), exp_c)
    assert ok_s and ok_c, "1B-row streamed aggregate mismatch vs numpy oracle"

    print(json.dumps({
        "metric": "zipf_join_groupby_1b_rows_per_sec_per_chip",
        "value": round(n / kernel_s),
        "unit": "rows/s",
        "detail": {
            "rows": n,
            "chunk": chunk,
            "chunks": n_chunks,
            "groups": groups,
            "kernel_s": round(kernel_s, 3),
            "end_to_end_s": round(total_s, 3),
            "end_to_end_rows_per_sec": round(n / total_s),
            "device": jax.devices()[0].device_kind,
            "note": "streamed partial->final combine; kernel_s includes "
                    "each chunk's host-to-device upload",
        },
    }))


if __name__ == "__main__":
    main()
