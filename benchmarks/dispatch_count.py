"""Dispatch-count profiler: how many device round-trips does a query cost?

Every dispatch (eager primitive, jitted-program execution, host fetch) is a
host-device round trip, so small-query latency follows DISPATCH COUNT as
much as device time. This tool counts them on CPU — the counts are
platform-independent.

Methodology: the C++ pjit fast path is disabled BEFORE the warm run (so
traces are Python-cached and steady-state calls re-enter
_run_python_pjit exactly once per executed program), then the steady run is
counted. Trace-time constant folding therefore does not pollute the counts.

Usage:
  JAX_PLATFORMS=cpu python -m benchmarks.dispatch_count --sf 0.01 --queries 1,18
  ... --devices 8 [--policy shuffle]   # distributed executor profile

Distributed mode (--devices N) answers round-3 VERDICT item 6: dispatches
and HOST SYNCS per query through the 8-shard executor, plus per-program
COLLECTIVE PAYLOAD bytes. Collectives execute inside compiled shard_map
programs, so they are recorded at trace time (the warm run) — with static
shapes that IS the per-execution payload; bytes are per shard.
"""

from __future__ import annotations

import argparse
import collections
import traceback


class DispatchCounter:
    def __init__(self) -> None:
        self.eager = collections.Counter()   # primitive name -> count
        self.jit = collections.Counter()     # jitted fn name -> count
        self.fetch = 0                        # device->host materializations
        self._stack_samples = collections.Counter()
        self.sample_stacks = False
        self.active = False

    def total(self) -> int:
        return sum(self.eager.values()) + sum(self.jit.values()) + self.fetch

    def reset(self) -> None:
        self.eager.clear()
        self.jit.clear()
        self.fetch = 0
        self._stack_samples.clear()

    def report(self, top: int = 18) -> str:
        lines = [
            f"total dispatches: {self.total()} "
            f"(eager {sum(self.eager.values())}, jit {sum(self.jit.values())}, "
            f"fetch {self.fetch})"
        ]
        for name, cnt in self.eager.most_common(top):
            lines.append(f"  eager {name:30s} {cnt}")
        for name, cnt in self.jit.most_common(top):
            lines.append(f"  jit   {name:30s} {cnt}")
        if self._stack_samples:
            lines.append("--- hottest call sites ---")
            for site, cnt in self._stack_samples.most_common(14):
                lines.append(f"  {cnt:5d}  {site}")
        return "\n".join(lines)


def install(counter: DispatchCounter) -> None:
    """Install the hooks process-wide (call before ANY jax execution)."""
    import jax._src.dispatch as dispatch
    import jax._src.pjit as pjit_mod
    from jax._src import array as array_mod

    orig_apply = dispatch.apply_primitive
    orig_run = pjit_mod._run_python_pjit
    orig_np = array_mod.ArrayImpl.__array__
    pjit_mod._get_fastpath_data = lambda *a, **k: None

    def _site(tag):
        ours = [
            f"{fr.filename.split('/')[-1]}:{fr.lineno}"
            for fr in traceback.extract_stack(limit=60)
            if ("sqlrs_tpu" in fr.filename or "/benchmarks/" in fr.filename)
            and "dispatch_count" not in fr.filename
        ]
        if ours:
            # innermost frame + the outermost three (the operator context)
            counter._stack_samples[
                f"{tag}@" + " < ".join(ours[-6:])
            ] += 1

    import sys

    def _inside_trace() -> bool:
        """With the fastpath disabled every call re-traces, so constant
        folding during _trace_for_jit would be (mis)counted as steady
        dispatches — in production the trace happens once at compile time.
        Skip anything executing under a trace."""
        f = sys._getframe(2)
        while f is not None:
            if f.f_code.co_name in ("_trace_for_jit", "trace_to_jaxpr_dynamic"):
                return True
            f = f.f_back
        return False

    def apply_primitive(prim, *args, **kw):
        if counter.active and not _inside_trace():
            counter.eager[prim.name] += 1
            if counter.sample_stacks:
                _site("eager")
        return orig_apply(prim, *args, **kw)

    def run_python_pjit(p, args_flat, fun, *rest, **kw):
        if counter.active and not _inside_trace():
            counter.jit[getattr(fun, "__name__", "<jit>")] += 1
            if counter.sample_stacks:
                _site("jit")
        return orig_run(p, args_flat, fun, *rest, **kw)

    def np_hook(self, *a, **kw):
        if counter.active:
            counter.fetch += 1
            if counter.sample_stacks:
                _site("fetch")
        return orig_np(self, *a, **kw)

    dispatch.apply_primitive = apply_primitive
    pjit_mod._run_python_pjit = run_python_pjit
    array_mod.ArrayImpl.__array__ = np_hook


class CollectiveMeter:
    """Trace-time accounting of jax.lax collective payloads. Collectives
    run inside compiled shard_map bodies, so they appear during tracing
    (the warm run); with static shapes the traced payload IS the
    per-execution payload. Bytes are per shard."""

    OPS = ("all_to_all", "psum", "all_gather", "ppermute", "psum_scatter")

    def __init__(self) -> None:
        self.calls = collections.Counter()
        self.bytes = collections.Counter()
        self.active = False

    def reset(self):
        self.calls.clear()
        self.bytes.clear()

    def install(self):
        import jax

        def _nbytes(x):
            try:
                return x.size * x.dtype.itemsize
            except Exception:
                return 0

        def wrap(name, orig):
            def f(*a, **kw):
                if self.active:
                    self.calls[name] += 1
                    for arg in a:
                        for leaf in jax.tree.leaves(arg):
                            if hasattr(leaf, "dtype"):
                                self.bytes[name] += _nbytes(leaf)
                return orig(*a, **kw)

            return f

        for name in self.OPS:
            orig = getattr(jax.lax, name, None)
            if orig is not None:
                setattr(jax.lax, name, wrap(name, orig))

    def report(self) -> str:
        if not self.calls:
            return "  collectives: none"
        lines = []
        for name, cnt in self.calls.most_common():
            lines.append(
                f"  collective {name:14s} {cnt:4d} calls  "
                f"{self.bytes[name]:12,d} B/shard"
            )
        lines.append(
            f"  collective TOTAL          {sum(self.calls.values()):4d} calls  "
            f"{sum(self.bytes.values()):12,d} B/shard"
        )
        return "\n".join(lines)


def main() -> None:
    import os

    # ALWAYS CPU: the counts are platform-independent
    os.environ["JAX_PLATFORMS"] = "cpu"

    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--queries", type=str, default="1")
    ap.add_argument("--stacks", action="store_true",
                    help="sample call sites of dispatches")
    ap.add_argument("--devices", type=int, default=0,
                    help="run through Database(n_devices=N) on a virtual mesh")
    ap.add_argument("--policy", type=str, default=None,
                    help="dist join policy override (e.g. shuffle)")
    args = ap.parse_args()

    if args.devices:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices}"
        )
    import jax

    jax.config.update("jax_platforms", "cpu")

    counter = DispatchCounter()
    install(counter)
    meter = CollectiveMeter()
    meter.install()

    import sqlrs_tpu
    from benchmarks import tpch_dbgen
    from benchmarks.tpch import run_query

    tables = tpch_dbgen.gen_tables(args.sf, seed=0)
    db = (
        sqlrs_tpu.Database(n_devices=args.devices)
        if args.devices else sqlrs_tpu.Database()
    )
    if args.policy:
        db.dist_join_policy = args.policy
    tpch_dbgen.load_into(db, tables)
    qs = [int(x) for x in args.queries.split(",")]
    total = 0
    total_fetch = 0
    for qn in qs:
        meter.reset()
        meter.active = True
        run_query(db, qn)  # warm: trace caches, interning (+ collectives)
        meter.active = False
        counter.reset()
        counter.sample_stacks = args.stacks
        counter.active = True
        run_query(db, qn)
        counter.active = False
        print(f"=== Q{qn} (steady) ===")
        print(counter.report())
        if args.devices:
            print(meter.report())
        total += counter.total()
        total_fetch += counter.fetch
    if len(qs) > 1:
        print(
            f"=== ALL: {total} dispatches ({total_fetch} host fetches) "
            f"over {len(qs)} queries ==="
        )


if __name__ == "__main__":
    main()
