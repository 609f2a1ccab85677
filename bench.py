"""Headline kernel benchmark: zipf-skewed join + group-by, rows/s per GPU.

The scaled synthetic workload is a zipf-keyed fact table joined to a
dimension table with a group-by aggregate, called directly through
`ops.pipelines.make_join_groupby` (no SQL; `chip_smoke.py` runs the same
rollup through `Database.run`). The reference publishes no numbers, so
`vs_baseline` compares against a vectorized single-node CPU implementation
of the same workload (numpy bincount/sort). The idealized 16-bytes-per-row
memory-bandwidth roofline share uses the card's peak from
`sqlrs_tpu.utils.profiling.HBM_BYTES_PER_S`.

Runs only on a GPU. Prints the card's name and power limit, then ONE JSON
line: {"metric": ..., "value": rows/s, "unit": "rows/s", "vs_baseline": ...}
"""

import json
import subprocess
import time

import numpy as np

_BYTES_PER_ROW = 16  # minimum traffic: read key (8B) + value (8B) per fact row


def _numpy_baseline(fact_keys, fact_vals, dim_keys, groups):
    """Same join+group-by with numpy's fastest formulation (sorted dim +
    searchsorted join + bincount aggregation)."""
    order = np.argsort(dim_keys)
    dsorted = dim_keys[order]
    best = None
    for _ in range(3):  # first run pays allocation/page-fault cost
        t0 = time.perf_counter()
        pos = np.searchsorted(dsorted, fact_keys)
        pos_c = np.minimum(pos, groups - 1)
        hit = dsorted[pos_c] == fact_keys
        gid = order[pos_c]
        sums = np.bincount(gid[hit], weights=fact_vals[hit], minlength=groups)
        counts = np.bincount(gid[hit], minlength=groups)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return sums.astype(np.int64), counts.astype(np.int64), best


def main() -> None:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: needs a GPU, JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card (name, power.limit): {card}", flush=True)

    import sqlrs_tpu  # noqa: F401  (x64)
    from sqlrs_tpu.ops.pipelines import make_join_groupby
    from sqlrs_tpu.utils.profiling import hbm_bandwidth

    n = 1 << 25  # 33.5M fact rows
    groups = 1 << 16
    rng = np.random.default_rng(0)
    gid = np.minimum(rng.zipf(1.2, n), groups).astype(np.int64) - 1
    # realistic star-schema foreign keys: DENSE dim ids (TPC-H-style
    # surrogate keys). Catalog min/max metadata then auto-selects the
    # int32-packed sort (pack32), half the bytes of an int64 sort. A
    # spread-key variant (keys *= 1013904223, defeats packing) is measured
    # as well and reported in detail.
    dim_keys_np = np.arange(groups, dtype=np.int64)
    fact_keys_np = dim_keys_np[gid]
    fact_vals_np = rng.integers(0, 100, n).astype(np.int64)
    fact_keys = jnp.asarray(fact_keys_np)
    fact_vals = jnp.asarray(fact_vals_np)
    dim_keys = jnp.asarray(dim_keys_np)

    # direct strategy: key+value packed into ONE sort operand, then
    # per-group sums via block prefix sums + a merge-ranked range query per
    # dim key — no run detection, no N-sized cumsum, no per-query binary
    # search (ops/pipelines.py join_groupby_direct)
    key_max, val_max = int(fact_keys_np.max()), int(fact_vals_np.max())
    fn = make_join_groupby(groups, strategy="direct")

    def run_once(fk, fv, dk, km, dmin, dmax):
        # catalog-style metadata: key/value ranges auto-select the int32
        # pack; dim min/max auto-selects the dense boundary-sharing rank
        # stage (consecutive surrogate keys — half the rank-row gathers)
        return jax.block_until_ready(
            fn(fk, fv, dk, key_max=km, val_max=val_max, dim_min=dmin,
               dim_max=dmax)
        )

    dim_min, dim_max = int(dim_keys_np.min()), int(dim_keys_np.max())
    sums, counts = run_once(fact_keys, fact_vals, dim_keys, key_max,
                            dim_min, dim_max)

    # correctness check vs the CPU baseline (which is itself the comparator)
    exp_sums, exp_counts, cpu_dt = _numpy_baseline(
        fact_keys_np, fact_vals_np, dim_keys_np, groups
    )
    assert np.array_equal(np.asarray(sums), exp_sums), "bench kernel mismatch"
    assert np.array_equal(np.asarray(counts), exp_counts), "bench count mismatch"

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run_once(fact_keys, fact_vals, dim_keys, key_max, dim_min, dim_max)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    rows_per_sec = n / dt
    cpu_rows_per_sec = n / cpu_dt

    # secondary: spread int64 keys (packing defeated) — the conservative path
    spread_np = dim_keys_np * 1013904223 + 12345
    sk_np = spread_np[gid]
    sk = jnp.asarray(sk_np)
    sdk = jnp.asarray(spread_np)
    skm = int(sk_np.max())
    smin, smax = int(spread_np.min()), int(spread_np.max())
    run_once(sk, fact_vals, sdk, skm, smin, smax)  # compile + warm
    times2 = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_once(sk, fact_vals, sdk, skm, smin, smax)
        times2.append(time.perf_counter() - t0)
    spread_rows_per_sec = n / float(np.median(times2))

    # spread keys under caller-asserted FK-completeness (true here by
    # construction: fact keys are drawn from the dim set — the referential
    # -integrity norm for star joins): shared G+1 range boundaries halve
    # the rank stage
    def run_fk(fk_, fv_, dk_):
        return jax.block_until_ready(
            fn(fk_, fv_, dk_, key_max=skm, val_max=val_max, dim_min=smin,
               dim_max=smax, fk_complete=True)
        )

    s_fk, c_fk = run_fk(sk, fact_vals, sdk)
    assert np.array_equal(np.asarray(s_fk), exp_sums), "fk spread mismatch"
    assert np.array_equal(np.asarray(c_fk), exp_counts)
    times3 = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_fk(sk, fact_vals, sdk)
        times3.append(time.perf_counter() - t0)
    spread_fk_rows_per_sec = n / float(np.median(times3))

    roofline_rows = hbm_bandwidth(dev) / _BYTES_PER_ROW
    print(
        json.dumps(
            {
                "metric": "zipf_join_groupby_rows_per_sec_per_chip",
                "value": round(rows_per_sec),
                "unit": "rows/s",
                "vs_baseline": round(rows_per_sec / cpu_rows_per_sec, 3),
                "detail": {
                    "rows": n,
                    "groups": groups,
                    "median_s": round(dt, 4),
                    "baseline": "numpy searchsorted+bincount on host CPU",
                    "baseline_rows_per_sec": round(cpu_rows_per_sec),
                    "roofline_fraction_16B_per_row": round(
                        rows_per_sec / roofline_rows, 5
                    ),
                    "spread_int64_key_rows_per_sec": round(spread_rows_per_sec),
                    "spread_fk_complete_rows_per_sec": round(
                        spread_fk_rows_per_sec
                    ),
                    "device": {
                        "platform": dev.platform,
                        "kind": dev.device_kind,
                        "count": len(jax.devices()),
                    },
                    "card_name_power_limit": card,
                    "algorithm": (
                        "packed-sort merge-ranked range queries "
                        "(ops/pipelines.py join_groupby_direct)"
                    ),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
