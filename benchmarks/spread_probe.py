"""Spread-key probe: how fast can the spread-int64-key join+group-by go?

Every exact sort-based formulation needs the fact rows grouped by a sort, so
the int64 single-operand sort time bounds any full-int64-sort formulation.
The probes below attack the only two levers:

  A. pack64_shared — keep the int64 packed sort but halve the rank stage:
     under FK-completeness (caller-asserted referential integrity: every
     fact key matches some dim key — the star-schema norm, and true by
     construction in bench.py's spread variant) consecutive dim ranges
     tile, so G+1 shared boundaries replace 2G lo/hi queries
     (join_groupby_direct shared=True).

  B. h32 compaction — escape the int64 sort entirely: map keys through a
     seeded 64->32-bit mix, host-verify the G dim hashes are injective
     (retry seeds; expected collisions G^2/2^33 ~ 0.5 at 64K dims), then
     sort ONE int32 operand (half the bytes) with the value as an int32
     payload and answer shared-boundary ranks in h-space. EXACT under
     FK-completeness: every fact key is a dim key, and h is injective on
     dims, so no alias can exist. Without FK-completeness a miss could
     alias a dim hash — this path is gated on the same flag as A.

Also measures the raw sort-primitive matrix the bound rests on.
Usage: python -m benchmarks.spread_probe [--n 33554432] [--groups 65536]
"""

from __future__ import annotations

import argparse
import time
from functools import partial

import numpy as np


def _median_time(fn, reps=3):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 25)
    ap.add_argument("--groups", type=int, default=1 << 16)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from jax import lax

    import sqlrs_tpu  # noqa: F401  (x64)
    from sqlrs_tpu.ops.pipelines import (
        _sorted_ranks_left,
        join_groupby_direct,
    )

    n, g = args.n, args.groups
    rng = np.random.default_rng(0)
    gid = np.minimum(rng.zipf(1.2, n), g).astype(np.int64) - 1
    spread_np = np.arange(g, dtype=np.int64) * 1013904223 + 12345
    fk_np = spread_np[gid]
    fv_np = rng.integers(0, 100, n).astype(np.int64)
    fk = jnp.asarray(fk_np)
    fv = jnp.asarray(fv_np)
    dk = jnp.asarray(spread_np)

    exp_sums = np.bincount(gid, weights=fv_np.astype(np.float64), minlength=g).astype(np.int64)
    exp_counts = np.bincount(gid, minlength=g).astype(np.int64)

    results = {}

    # ---- sort-primitive matrix (the ceiling argument) --------------------
    pk64 = (fk << 7) | fv
    k32 = (fk % jnp.int64(1 << 31)).astype(jnp.int32)
    v32 = fv.astype(jnp.int32)

    # operands must be jit ARGUMENTS (a closure would embed the 268 MB
    # arrays as program constants)
    @jax.jit
    def _s1(x):
        return lax.sort(x)

    @partial(jax.jit, static_argnames=("nk",))
    def _s2(x, y, nk: int):
        return lax.sort((x, y), num_keys=nk)

    prims = {
        "sort_int64": lambda: _s1(pk64),
        "sort_int32": lambda: _s1(k32),
        "sort_int64_plus_i64payload": lambda: _s2(pk64, fk, nk=1),
        "sort_int32_plus_i32payload": lambda: _s2(k32, v32, nk=1),
        "sort_2key_int32_int32": lambda: _s2(k32, v32, nk=2),
        "sort_2key_int64_int64": lambda: _s2(pk64, fk, nk=2),
    }
    for name, mk in prims.items():
        out = mk()
        arr = out[0] if isinstance(out, (tuple, list)) else out
        float(arr[0])  # materialize

        def run(mk=mk):
            o = mk()
            a = o[0] if isinstance(o, (tuple, list)) else o
            float(a[0])

        dt = _median_time(run, args.reps)
        results[name] = dt
        print(f"{name:32s} {dt*1e3:9.1f} ms  "
              f"({n/dt/1e6:7.1f}M elem/s)", flush=True)

    # ---- A/B formulations ------------------------------------------------
    order = jnp.argsort(dk)
    dsorted = dk[order]

    def run_direct(shared):
        s, c = join_groupby_direct(
            fk, fv, dsorted, order, g, 7, False, dense=False, shared=shared
        )
        float(s[0])
        return s, c

    for shared, name in ((False, "pack64_2G (current)"),
                         (True, "pack64_shared (fk-complete)")):
        s, c = run_direct(shared)
        assert np.array_equal(np.asarray(s), exp_sums), name
        assert np.array_equal(np.asarray(c), exp_counts), name
        dt = _median_time(lambda sh=shared: run_direct(sh), args.reps)
        results[name] = dt
        print(f"{name:32s} {dt*1e3:9.1f} ms  "
              f"({n/dt/1e6:7.1f}M rows/s)", flush=True)

    # ---- B: h32 compaction ----------------------------------------------
    from sqlrs_tpu.ops.hash_table import _mix64

    @jax.jit
    def _dim_h32(dkeys, seed):
        h = (_mix64(dkeys ^ seed) >> 32).astype(jnp.int32)
        hs = jnp.sort(h)
        # also retry if the top value leaves no room for the final
        # shared boundary (hs[-1] + 1 must not wrap)
        coll = jnp.any(hs[1:] == hs[:-1]) | (
            hs[-1] >= jnp.int32(jnp.iinfo(jnp.int32).max - 1)
        )
        return h, coll

    seed = 0x1E3779B97F4A7C15  # fits int64
    for attempt in range(8):
        dh, coll = _dim_h32(dk, jnp.int64(np.int64(seed + attempt)))
        if not bool(coll):
            seed = seed + attempt
            break
    else:  # pragma: no cover
        raise AssertionError("no injective h32 seed found in 8 tries")
    print(f"h32 injective on dims at seed attempt {attempt}", flush=True)

    @partial(jax.jit, static_argnames=("g",))
    def h32_join_groupby(fkeys, fvals, dh_sorted, dperm, seed, g: int):
        """Sort ONE int32 operand (half the bytes of int64) + the value
        as an int32 payload; shared-boundary ranks in h-space. Exact under
        FK-completeness + dim-injective h (no alias can exist)."""
        h = (_mix64(fkeys ^ seed) >> 32).astype(jnp.int32)
        blk = 128
        nn = h.shape[0]
        pad = (-nn) % blk
        v32l = fvals.astype(jnp.int32)
        if pad:
            h = jnp.concatenate(
                [h, jnp.full((pad,), jnp.iinfo(jnp.int32).max, jnp.int32)]
            )
            v32l = jnp.concatenate([v32l, jnp.zeros((pad,), jnp.int32)])
        hs, vs = lax.sort((h, v32l), num_keys=1)
        nb = hs.shape[0] // blk
        h2d = hs.reshape(nb, blk)
        # shared boundaries: rank of each sorted dim hash + one final end
        queries = jnp.concatenate(
            [dh_sorted, dh_sorted[-1:] + 1]  # dh int32; +1 may wrap only
        )                                    # at INT32_MAX (not a dim h)
        ranks = _sorted_ranks_left(h2d, queries)
        lo, hi = ranks[:g], ranks[1:]
        cnt = (hi - lo).astype(jnp.int64)
        v2d = vs.reshape(nb, blk)
        bs = jnp.sum(v2d, axis=1, dtype=jnp.int64)
        bp = jnp.concatenate([jnp.cumsum(bs) - bs, jnp.sum(bs)[None]])
        lane = jnp.arange(blk, dtype=jnp.int32)
        b = ranks // blk
        rem = (ranks % blk).astype(jnp.int32)
        under = lane[None, :] < rem[:, None]
        part = jnp.sum(
            jnp.where(under, v2d[jnp.clip(b, 0, nb - 1)], 0),
            axis=1, dtype=jnp.int64,
        )
        pr = bp[jnp.clip(b, 0, nb)] + part
        sm = pr[1:] - pr[:g]
        sums = jnp.zeros((g,), jnp.int64).at[dperm].set(sm)
        counts = jnp.zeros((g,), jnp.int64).at[dperm].set(cnt)
        return sums, counts

    hperm = jnp.argsort(dh)
    dh_sorted = dh[hperm]

    def run_h32():
        s, c = h32_join_groupby(
            fk, fv, dh_sorted, hperm, jnp.int64(np.int64(seed)), g
        )
        float(s[0])
        return s, c

    s, c = run_h32()
    assert np.array_equal(np.asarray(s), exp_sums), "h32 sums mismatch"
    assert np.array_equal(np.asarray(c), exp_counts), "h32 counts mismatch"
    dt = _median_time(run_h32, args.reps)
    results["h32_compaction (fk-complete)"] = dt
    print(f"{'h32_compaction (fk-complete)':32s} {dt*1e3:9.1f} ms  "
          f"({n/dt/1e6:7.1f}M rows/s)", flush=True)

    best = min(
        (k for k in results if "pack64" in k or "h32" in k),
        key=lambda k: results[k],
    )
    print(f"\nbest spread formulation: {best} -> "
          f"{n/results[best]/1e6:.1f}M rows/s "
          f"(int64-sort ceiling: {n/results['sort_int64']/1e6:.1f}M)",
          flush=True)


if __name__ == "__main__":
    main()
