"""Sorted-run grouped aggregation: the general GROUP BY.

The general-executor counterpart of ops/pipelines.join_groupby_sorted,
handling arbitrary key columns (any logical type, NULL keys group together),
multiple aggregates, and the reference's first-appearance group output order
(reference src/executor/aggregate/hash_agg.rs:85-111) — with ZERO N-sized
random accesses:

  one variadic lax.sort carrying (key encodings, validity flags, raw key
  payloads, aggregate inputs, row index) → run boundaries by adjacent diff →
  per-run sum/count as cumsum differences at run ends → per-run min/max via
  segmented associative scans → all remaining work at R = #groups size.

The jax.ops.segment_* path scatters per element instead; this formulation
is bound by one sort.

DISTINCT aggregates take the legacy dedup path (rare, and they need a second
value-keyed sort anyway).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sqlrs_tpu.data import Column
from sqlrs_tpu.data.strings import NULL_CODE
from sqlrs_tpu.errors import ExecutorError
from sqlrs_tpu.ops.hash_table import next_pow2
from sqlrs_tpu.ops.sort import orderable_key
from sqlrs_tpu.types import LogicalType, numpy_dtype_for


def sorted_grouped_aggregate(
    key_cols: list[Column],
    agg_specs: list[tuple],
    alive=None,
):
    """agg_specs: (function_name, input column or None for count(*),
    result logical type[, distinct]). Returns (group_cols, agg_cols,
    n_groups) with groups in first-appearance order.

    DISTINCT aggregates ride the SAME two-jit-phase structure: the (single,
    shared) distinct argument column becomes an extra value sort key after
    the group keys, and phase 2 counts/sums contributions only at
    (group, value) pair boundaries. Multiple distinct aggs must share one
    argument column (raises ValueError otherwise — callers fall back to the
    legacy dedup path).

    `alive` (optional bool array) excludes rows WITHOUT compacting first —
    the fused Filter→GROUP BY path: dead rows ride a leading dead-flag sort
    key to the end, never open runs, and are masked out of every aggregate
    (compaction costs a permutation sort + per-column gathers; the mask
    costs one extra sort operand).

    Compiled as TWO jit programs split only at the n_groups host sync (the
    data-dependent output size): phase 1 = variadic sort + run detection,
    phase 2 = per-run reduction + first-appearance placement. A GROUP BY is
    a handful of dispatches regardless of key/aggregate count."""
    n = len(key_cols[0])
    if n == 0:
        return (
            [Column.from_numpy(c.type, np.zeros(0, numpy_dtype_for(c.type))) for c in key_cols],
            [
                Column.from_numpy(s[2], np.zeros(0, numpy_dtype_for(s[2])))
                for s in agg_specs
            ],
            0,
        )

    # ---- layout planning (host-static; arithmetic happens inside the jit) --
    # SMALL keys (VARCHAR lex ranks and BOOLEANs — their bit widths are
    # host-known) pack, WITH their validity bits, into shared int64 composite
    # sort operands. Multi-key comparators cost XLA sorts far more compile
    # time than one key over the same operands, so collapsing num_keys pays
    # at compile and at run time.
    from sqlrs_tpu.data.strings import GLOBAL_STRINGS
    from sqlrs_tpu.ops.sort import key_kind

    rank_bits = max(len(GLOBAL_STRINGS).bit_length(), 1)
    has_alive = alive is not None
    key_layout, num_keys = _plan_key_layout(
        [c.type for c in key_cols], rank_bits, has_alive
    )

    # each DISTINCT aggregate input column rides the sort once, shared by
    # every aggregate over it (sum(v), count(v), min(v), max(v) -> one
    # payload pair, one valid-count downstream). VARCHAR columns used by any
    # min/max ride as ONE packed (rank << 32 | code) operand.
    specs4 = [
        (s[0], s[1], s[2], bool(s[3]) if len(s) > 3 else False)
        for s in agg_specs
    ]
    slot_of: dict[int, int] = {}
    slot_cols: list = []
    slot_packed: list = []
    agg_slots: list = []
    distinct_slot = -1
    for name, col, _, distinct in specs4:
        if col is None:
            agg_slots.append(None)
            continue
        ident = id(col)
        if ident not in slot_of:
            slot_of[ident] = len(slot_cols)
            slot_cols.append(col)
            slot_packed.append(False)
        agg_slots.append(slot_of[ident])
        if col.type == LogicalType.VARCHAR and name in ("min", "max"):
            slot_packed[slot_of[ident]] = True
        if distinct and name in ("sum", "avg", "count"):
            if distinct_slot not in (-1, slot_of[ident]):
                raise ValueError(
                    "sorted path supports one shared DISTINCT argument"
                )
            distinct_slot = slot_of[ident]

    spec = (
        tuple(
            (c.type,) + tuple(lay) for c, lay in zip(key_cols, key_layout)
        ),
        tuple(
            (name, col.type if col is not None else None, rt, slot,
             distinct and name in ("sum", "avg", "count"))
            for (name, col, rt, distinct), slot in zip(specs4, agg_slots)
        ),
        len(slot_cols),
        has_alive,
    )

    rank = None
    needs_rank = any(c.type == LogicalType.VARCHAR for c in key_cols) or any(
        c.type == LogicalType.VARCHAR and p
        for c, p in zip(slot_cols, slot_packed)
    ) or (distinct_slot >= 0 and slot_cols[distinct_slot].type == LogicalType.VARCHAR)
    if needs_rank:
        r = GLOBAL_STRINGS.ranks_device()
        rank = r if r.shape[0] > 0 else None

    dkind = (
        key_kind(slot_cols[distinct_slot].type) if distinct_slot >= 0 else ""
    )
    out, new_run, new_pair, rid, n_runs = _agg_phase1(
        tuple(c.data for c in key_cols),
        tuple(c.valid for c in key_cols),
        rank,
        tuple(c.data for c in slot_cols),
        tuple(c.valid for c in slot_cols),
        alive,
        tuple(key_kind(c.type) for c in key_cols),
        tuple(key_layout),
        tuple(slot_packed),
        rank_bits,
        distinct_slot,
        dkind,
    )
    n_groups = int(n_runs)  # pipeline-breaker sync
    r_cap = next_pow2(max(n_groups, 8))

    if distinct_slot >= 0:
        num_keys += 2  # the (valid, value) distinct sort-operand pair
    gdata, gvalid, adata, avalid = _agg_phase2(
        out, new_run, new_pair, rid, n_runs, num_keys, spec, r_cap
    )

    # slice every output to n_groups in ONE dispatch (eager per-column
    # slicing cost 2 dispatches per column)
    from sqlrs_tpu.ops.fused import slice_arrays

    flat = slice_arrays(tuple(gdata + gvalid + adata + avalid), 0, n_groups)
    nk, na = len(gdata), len(adata)
    gdata, gvalid = flat[:nk], flat[nk : 2 * nk]
    adata, avalid = flat[2 * nk : 2 * nk + na], flat[2 * nk + na :]
    group_cols = [
        Column(c.type, d, v) for c, d, v in zip(key_cols, gdata, gvalid)
    ]
    agg_cols = [
        Column(s[2], d, v) for s, d, v in zip(specs4, adata, avalid)
    ]
    return group_cols, agg_cols, n_groups


def _plan_key_layout(key_types, rank_bits: int, has_alive: bool):
    """Host-static sort-operand layout: per key ("small", op_i, shift, bits)
    for bit-packed composite members or ("plain", op_i, 0, 0) for dedicated
    (valid, key) operand pairs. op_i is the absolute sort-operand index
    (operand 0 is the dead flag when has_alive)."""
    layout: list = []
    n_ops = 1 if has_alive else 0
    acc_bits = None  # bits used in the currently-open composite
    for t in key_types:
        if t == LogicalType.VARCHAR:
            bits = rank_bits
        elif t == LogicalType.BOOLEAN:
            bits = 1
        else:
            bits = None
        if bits is None or bits + 1 > 62:
            if acc_bits is not None:
                n_ops += 1
                acc_bits = None
            layout.append(("plain", n_ops, 0, 0))
            n_ops += 2
            continue
        if acc_bits is not None and acc_bits + bits + 1 <= 62:
            for i, lay in enumerate(layout):
                if lay[0] == "small" and lay[1] == n_ops:
                    layout[i] = ("small", lay[1], lay[2] + bits + 1, lay[3])
            acc_bits += bits + 1
        else:
            if acc_bits is not None:
                n_ops += 1
            acc_bits = bits + 1
        layout.append(("small", n_ops, 0, bits))
    if acc_bits is not None:
        n_ops += 1
    return layout, n_ops


_BLK = 128


@partial(
    jax.jit,
    static_argnames=(
        "kinds", "layout", "slot_packed", "rank_bits", "distinct_slot",
        "dkind",
    ),
)
def _agg_phase1(
    kdatas,
    kvalids,
    rank,
    sdatas,
    svalids,
    alive,
    kinds,
    layout,
    slot_packed,
    rank_bits: int,
    distinct_slot: int = -1,
    dkind: str = "",
):
    """Operand assembly (key encoding, composite bit-packing, payload
    building) + variadic sort + run-boundary detection, ONE dispatched
    program. Returns the sorted operands in the layout _agg_phase2 expects,
    the run-start mask, run ids, and the run count (device scalar). The row
    index (first payload) participates as the least-significant sort key —
    run boundaries are computed over the true key fields only. With alive,
    a leading dead-flag key sends masked rows to the end and they never
    open runs.

    The assembly used to run eagerly on the host driver: each shift/where/
    rank-gather was its own dispatch, costing a GROUP BY ~40 dispatches
    before the sort launched."""
    from sqlrs_tpu.ops.sort import _encode_traced

    n = kdatas[0].shape[0] if kdatas else sdatas[0].shape[0]
    has_alive = alive is not None
    if isinstance(alive, tuple):  # raw (keep_data, keep_valid) pair
        alive = jnp.logical_and(alive[0], alive[1])
    sort_keys: list = []
    if has_alive:
        sort_keys.append(jnp.logical_not(alive).astype(jnp.int32))
    acc = None  # open composite value (bit budget tracked by `layout`)
    for data, valid, kind, lay in zip(kdatas, kvalids, kinds, layout):
        key = _encode_traced(kind, data, rank)
        tag, op_i, shift, bits = lay
        if tag == "plain":
            if acc is not None:
                sort_keys.append(acc)
                acc = None
            sort_keys.append(valid.astype(jnp.int32))
            sort_keys.append(jnp.where(valid, key, 0))
            continue
        unit = (valid.astype(jnp.int64) << bits) | jnp.where(
            valid, key.astype(jnp.int64), 0
        )
        if acc is not None and op_i == len(sort_keys):
            acc = (acc << (bits + 1)) | unit
        else:
            if acc is not None:
                sort_keys.append(acc)
            acc = unit
    if acc is not None:
        sort_keys.append(acc)
    num_keys = len(sort_keys)

    # the row index rides as the LEAST-SIGNIFICANT SORT KEY, so each run's
    # first sorted row is its first-appearance representative
    payloads: list = [jnp.arange(n, dtype=jnp.int32)]
    if has_alive:
        payloads.append(alive.astype(jnp.int32))
    for data, kind in zip(kdatas, kinds):
        # non-VARCHAR key values are reconstructed from the sort key fields
        # themselves (orderable encoding is invertible); only dictionary
        # codes need a dedicated payload
        if kind == "varchar":
            payloads.append(data)
    for data, valid, packed in zip(sdatas, svalids, slot_packed):
        if packed:
            rk = _encode_traced("varchar", data, rank)
            code_u = data.astype(jnp.int64) & jnp.int64(0xFFFFFFFF)
            payloads.append((rk.astype(jnp.int64) << 32) | code_u)
        else:
            payloads.append(_sortable(data))
        payloads.append(valid.astype(jnp.int32))

    n_group_ops = num_keys  # operands defining GROUP boundaries
    if distinct_slot >= 0:
        # the distinct argument rides as an extra (valid, value) sort-key
        # pair AFTER the group keys: equal values cluster within each run,
        # so phase 2 can count/sum at pair boundaries. Group boundaries
        # still come from the key fields alone.
        dd, dv = sdatas[distinct_slot], svalids[distinct_slot]
        denc = _encode_traced(dkind, dd, rank)
        sort_keys.append(dv.astype(jnp.int32))
        sort_keys.append(
            jnp.where(dv, denc, jnp.zeros((), denc.dtype))
        )
        num_keys = len(sort_keys)

    ops = sort_keys + payloads
    out = lax.sort(tuple(ops), num_keys=num_keys + 1)
    n = out[0].shape[0]
    new_run = jnp.zeros(n, dtype=jnp.bool_).at[0].set(True)
    lo = 1 if has_alive else 0  # skip the dead flag for boundary detection
    for arr in out[lo:n_group_ops]:
        d = arr[1:] != arr[:-1]
        new_run = new_run.at[1:].set(jnp.logical_or(new_run[1:], d))
    new_pair = new_run
    if distinct_slot >= 0:
        for arr in out[n_group_ops:num_keys]:
            d = arr[1:] != arr[:-1]
            new_pair = new_pair.at[1:].set(jnp.logical_or(new_pair[1:], d))
    if has_alive:
        alive_s = out[num_keys + 1] > 0  # payloads: [rowidx, alive, ...]
        new_run = new_run & alive_s
        new_pair = new_pair & alive_s
    rid = jnp.cumsum(new_run.astype(jnp.int32)) - 1
    if has_alive:
        # Dead rows sort to the tail but would otherwise inherit the LAST
        # live run's rid, making phase 2's ends/last for that run point at a
        # dead row (wrong key data/validity emitted). Mask them out of every
        # run, mirroring partial_grouped_fixed's rid_eff.
        rid = jnp.where(alive_s, rid, jnp.int32(np.iinfo(np.int32).max))
    n_runs = jnp.sum(new_run.astype(jnp.int32))
    return out, new_run, new_pair, rid, n_runs


@partial(jax.jit, static_argnames=("num_keys", "spec", "r_cap"))
def _agg_phase2(
    out, new_run, new_pair, rid, n_runs, num_keys: int, spec, r_cap: int
):
    """Per-run reduction + first-appearance placement at static capacity
    r_cap (outputs are r_cap-sized; the caller slices to n_groups).

    Run ends come from the merge-rank trick (searchsorted costs log2(N)
    latency-bound gathers per query; a tiny merge sort + one 128-wide row
    scan per query replaces them, ops/pipelines._sorted_ranks_left), and
    per-run sums are prefix differences with prefixes computed ONLY at the
    2R query positions (one block-reduce pass instead of a full-N
    cumsum)."""
    from sqlrs_tpu.ops.pipelines import _sorted_ranks_left

    key_types, agg_items, n_slots, has_alive = spec
    s_payloads = list(out[num_keys:])
    alive_s = (s_payloads[1] > 0) if has_alive else None
    n = out[0].shape[0]
    pad_n = (-n) % _BLK
    # DENSE mode: when the group count approaches the row count (Q18's 1.5M
    # orderkey groups over 6M rows), the per-run block machinery gathers
    # ~3×128 elements PER RUN (≈3N total random reads); a full-N cumsum +
    # one N-sized scatter is far cheaper. Both n and r_cap are trace-time
    # static, so this is a compile-time algorithm choice.
    dense = r_cap * 64 >= n

    def _pad_to_blocks(arr, fill):
        if pad_n == 0:
            return arr
        return jnp.concatenate([arr, jnp.full((pad_n,), fill, arr.dtype)])

    r = jnp.arange(r_cap, dtype=jnp.int32)
    rid_p = _pad_to_blocks(rid, np.iinfo(np.int32).max)
    big32 = np.iinfo(np.int32).max
    rid_tgt = jnp.where(
        (rid >= 0) & (rid < r_cap), rid.astype(jnp.int64), r_cap
    )
    if dense:
        # run end = max row position + 1 scattered by run id
        ends = (
            jnp.zeros((r_cap + 1,), jnp.int64)
            .at[rid_tgt]
            .max(jnp.arange(1, n + 1, dtype=jnp.int64))[:r_cap]
        )
    else:
        ends = _sorted_ranks_left(rid_p.reshape(-1, _BLK), r + 1)  # side='right'
    prev_end = jnp.concatenate([jnp.zeros((1,), ends.dtype), ends[:-1]])
    live = r < n_runs
    last = jnp.clip(ends - 1, 0, n - 1)
    lane = jnp.arange(_BLK, dtype=jnp.int32)

    if dense:

        def run_sum(arr):
            cs = jnp.cumsum(arr)

            def prefix_at(pos):
                return jnp.where(pos > 0, cs[jnp.clip(pos - 1, 0, n - 1)], 0)

            return prefix_at(ends) - prefix_at(prev_end)

        def run_minmax(arr, want_min, sentinel):
            init = jnp.full((r_cap + 1,), sentinel, arr.dtype)
            scat = (
                init.at[rid_tgt].min(arr)
                if want_min
                else init.at[rid_tgt].max(arr)
            )
            return scat[:r_cap]

    else:

        def run_sum(arr):
            a2 = _pad_to_blocks(arr, 0).reshape(-1, _BLK)
            nb = a2.shape[0]
            bs = jnp.sum(a2, axis=1)
            bp = jnp.concatenate([jnp.cumsum(bs) - bs, jnp.sum(bs)[None]])

            def prefix_at(pos):
                b = pos // _BLK
                rem = (pos % _BLK).astype(jnp.int32)
                rows = a2[jnp.clip(b, 0, nb - 1)]
                part = jnp.sum(
                    jnp.where(lane[None, :] < rem[:, None], rows, 0), axis=1
                )
                return bp[b] + part

            return prefix_at(ends) - prefix_at(prev_end)

        nb_all = (n + pad_n) // _BLK
        rid_blocks_first = rid_p[::_BLK]
        rid_blocks_last = rid_p[_BLK - 1 :: _BLK]
        whole_blk = rid_blocks_first == rid_blocks_last
        e1 = jnp.maximum(ends, 1) - 1
        bs_ = prev_end // _BLK
        rs_ = (prev_end % _BLK).astype(jnp.int32)
        be_ = e1 // _BLK
        re_ = (e1 % _BLK).astype(jnp.int32) + 1
        same_blk = bs_ == be_

        def run_minmax(arr, want_min, sentinel):
            """Segmented min/max over the sorted runs WITHOUT an associative
            scan (whose log2(N) unrolled stages dominated compile time): one
            block-reduce pass, an nb-sized scatter of whole-block bests to
            their run, and two gathered boundary rows per run for the
            partial blocks."""
            a2 = _pad_to_blocks(arr, sentinel).reshape(-1, _BLK)
            red = jnp.min if want_min else jnp.max
            bbest = red(a2, axis=1)
            tgt = jnp.where(
                whole_blk & (rid_blocks_first >= 0) & (rid_blocks_first < r_cap),
                rid_blocks_first.astype(jnp.int64),
                r_cap,
            )
            init = jnp.full((r_cap + 1,), sentinel, a2.dtype)
            out = (
                init.at[tgt].min(bbest) if want_min else init.at[tgt].max(bbest)
            )[:r_cap]
            head_rows = a2[jnp.clip(bs_, 0, nb_all - 1)]
            not_same = jnp.logical_not(same_blk)
            hm = (lane[None, :] >= rs_[:, None]) & (
                not_same[:, None] | (lane[None, :] < re_[:, None])
            )
            head = red(jnp.where(hm, head_rows, sentinel), axis=1)
            tail_rows = a2[jnp.clip(be_, 0, nb_all - 1)]
            tm = (lane[None, :] < re_[:, None]) & not_same[:, None]
            tail = red(jnp.where(tm, tail_rows, sentinel), axis=1)
            return red(jnp.stack([out, head, tail]), axis=0)

    # ---- first-appearance order -------------------------------------------
    # the row index was the least-significant sort key, so the row at each
    # run START is the run's first-appearance representative — UNLESS a
    # distinct value key sits between the group keys and the row index, in
    # which case the true first appearance is the run MIN of the row index
    row_idx = s_payloads[0]
    any_distinct = any(len(it) > 4 and it[4] for it in agg_items)
    if any_distinct:
        big32 = np.iinfo(np.int32).max
        rep = jnp.where(live, run_minmax(row_idx, True, big32), big32)
    else:
        rep = jnp.where(live, row_idx[jnp.clip(prev_end, 0, n - 1)],
                        np.iinfo(np.int32).max)
    # runs in first-appearance order: output slot j holds run first_runs[j]
    # (a gather; the equivalent scatter through argsort(argsort(rep)) trips
    # XLA's GPU permutation-sort simplifier on int64 indices)
    first_runs = jnp.argsort(rep)

    def place(vals_runs):
        return vals_runs[first_runs]

    ones = jnp.ones(r_cap, jnp.bool_)

    # ---- group key output columns -------------------------------------------
    gdata, gvalid = [], []
    p = 2 if has_alive else 1
    for kt, kind, op_i, shift, bits in key_types:
        if kind == "small":
            composite = out[op_i]
            valid_bit = (composite >> (shift + bits)) & 1
            if kt == LogicalType.VARCHAR:
                raw = s_payloads[p]
                p += 1
            else:  # BOOLEAN
                raw = ((composite >> shift) & ((1 << bits) - 1)).astype(
                    jnp.int32
                )
            gdata.append(_unsortable(place(raw[last]), kt))
            gvalid.append(place((valid_bit[last] > 0).astype(jnp.int32)) > 0)
            continue
        valid_f = out[op_i]  # the (valid, encoded key) sort fields
        key_f = out[op_i + 1]
        if kt == LogicalType.VARCHAR:
            raw = s_payloads[p]
            p += 1
        else:
            raw = _orderable_inverse(key_f, kt)
        gdata.append(_unsortable(place(raw[last]), kt))
        gvalid.append(place((valid_f[last] > 0).astype(jnp.int32)) > 0)

    # ---- aggregates -----------------------------------------------------------
    slot_base = p
    counts_cache: dict = {}
    adata, avalid = [], []
    for item in agg_items:
        name, ct, rt, slot = item[0], item[1], item[2], item[3]
        distinct = len(item) > 4 and item[4]
        if ct is None:  # count(*)
            if has_alive:
                cnt = run_sum(alive_s.astype(jnp.int64))
            else:
                cnt = (ends - prev_end).astype(jnp.int64)
            adata.append(place(jnp.where(live, cnt, 0)))
            avalid.append(ones)
            continue
        data = s_payloads[slot_base + 2 * slot]  # VARCHAR min/max: packed
        valid = s_payloads[slot_base + 2 * slot + 1] > 0
        if has_alive:
            valid = valid & alive_s
        if distinct:
            # contributions only at (group, value) pair boundaries — the
            # distinct value rode as an extra sort key, so duplicates are
            # adjacent and only the first of each counts
            valid = valid & new_pair
        if (slot, distinct) not in counts_cache:
            counts_cache[(slot, distinct)] = run_sum(valid.astype(jnp.int64))
        counts = counts_cache[(slot, distinct)]
        has_any = counts > 0
        if name == "count":
            adata.append(place(jnp.where(live, counts, 0)))
            avalid.append(ones)
            continue
        if name in ("sum", "avg"):
            acc_t = LogicalType.DOUBLE if name == "avg" else rt
            vals = _unsortable(data, ct).astype(numpy_dtype_for(acc_t))
            sm = run_sum(jnp.where(valid, vals, 0))
            if name == "avg":
                sm = sm / jnp.maximum(counts, 1).astype(jnp.float64)
            adata.append(place(sm).astype(numpy_dtype_for(rt)))
            avalid.append(place(has_any.astype(jnp.int32)) > 0)
            continue
        if name in ("min", "max"):
            if ct == LogicalType.VARCHAR:
                big = jnp.int64(jnp.iinfo(jnp.int64).max)
                sentinel = big if name == "min" else -big
                v = jnp.where(valid, data, sentinel)
                best = run_minmax(v, name == "min", sentinel)
                out_data = place((best & jnp.int64(0xFFFFFFFF)).astype(jnp.int32))
            else:
                info_dt = numpy_dtype_for(ct)
                if ct.is_float():
                    sentinel = np.inf if name == "min" else -np.inf
                else:
                    ii = np.iinfo(info_dt)
                    sentinel = ii.max if name == "min" else ii.min
                vals = _unsortable(data, ct)
                v = jnp.where(valid, vals, jnp.asarray(sentinel, vals.dtype))
                best = run_minmax(v, name == "min", sentinel)
                out_data = place(best)
            adata.append(out_data.astype(numpy_dtype_for(rt)))
            avalid.append(place(has_any.astype(jnp.int32)) > 0)
            continue
        raise ExecutorError(f"unknown aggregate {name}")

    return tuple(gdata), tuple(gvalid), tuple(adata), tuple(avalid)


def partial_grouped_fixed(alive, row_idx, keys, aggs, g_cap: int):
    """Shard-local FIXED-CAPACITY partial GROUP BY — the shard_map-safe core
    of the distributed aggregation (static shapes only, no host sync; the
    capacity-overflow flag drives the caller's bucketed-recompile retry,
    SURVEY.md §7 "fixed-capacity batches + valid-count scalars").

    Scatter-free, same techniques as the single-device kernels: the row
    index rides as the least-significant sort
    key (run start = first appearance), run ends come from merge-ranked
    queries at the static g_cap capacity, run sums are block-prefix
    differences, and run min/max uses whole-block bests + boundary rows.

    alive:   bool[n] live-row mask (dead rows sort last, never form runs)
    row_idx: int64[n] global row ids
    keys:    list of (orderable int array, valid bool, raw data array)
    aggs:    list of ("count_star" | "count" | "sum" | "avg" | "min" | "max"
             | "vmin" | "vmax", data, valid, rank_or_None, out_dtype)
             (data/valid/rank are None for count_star; rank only for v*)

    Returns (key_outs, first_row, live, states, n_runs, overflow) where
    key_outs = [(data[g_cap], valid[g_cap])], states = per agg dict of
    g_cap-sized partial-state arrays.
    """
    from sqlrs_tpu.ops.pipelines import _sorted_ranks_left

    n = alive.shape[0]
    dead = jnp.logical_not(alive).astype(jnp.int32)
    sort_keys: list = [dead]
    for orderable, valid, _raw in keys:
        sort_keys.append(valid.astype(jnp.int32))
        sort_keys.append(jnp.where(valid, orderable, 0))
    sort_keys.append(row_idx)  # least-significant: run start = first appearance
    num_keys = len(sort_keys)

    payloads: list = [alive.astype(jnp.int32)]
    key_pay_ix = []
    for _orderable, valid, raw in keys:
        key_pay_ix.append(num_keys + len(payloads))
        payloads.append(_sortable(raw))
        payloads.append(valid.astype(jnp.int32))
    agg_pay_ix = []
    for kind, data, valid, rank, _dt in aggs:
        if data is None:
            agg_pay_ix.append(None)
            continue
        agg_pay_ix.append(num_keys + len(payloads))
        if kind in ("vmin", "vmax"):
            code_u = data.astype(jnp.int64) & jnp.int64(0xFFFFFFFF)
            payloads.append((rank.astype(jnp.int64) << 32) | code_u)
        else:
            payloads.append(_sortable(data))
        payloads.append(valid.astype(jnp.int32))

    out = lax.sort(tuple(sort_keys + payloads), num_keys=num_keys)
    row_s = out[num_keys - 1]
    alive_b = out[num_keys] > 0

    new_run = jnp.zeros(n, dtype=jnp.bool_).at[0].set(True)
    for arr in out[1 : num_keys - 1]:  # key fields only (not dead flag/row)
        d = arr[1:] != arr[:-1]
        new_run = new_run.at[1:].set(jnp.logical_or(new_run[1:], d))
    new_run = new_run & alive_b
    rid = jnp.cumsum(new_run.astype(jnp.int32)) - 1
    n_runs = jnp.sum(new_run.astype(jnp.int64))
    overflow = n_runs > g_cap
    big32 = jnp.int32(jnp.iinfo(jnp.int32).max)
    rid_eff = jnp.where(alive_b, rid, big32)  # dead rows leave every run

    pad_n = (-n) % _BLK
    nb = (n + pad_n) // _BLK

    def _pad(arr, fill):
        if pad_n == 0:
            return arr
        return jnp.concatenate([arr, jnp.full((pad_n,), fill, arr.dtype)])

    rid_p = _pad(rid_eff, big32)
    r = jnp.arange(g_cap, dtype=jnp.int32)
    ends = _sorted_ranks_left(rid_p.reshape(-1, _BLK), r + 1)  # side='right'
    prev_end = jnp.concatenate([jnp.zeros((1,), ends.dtype), ends[:-1]])
    live = r.astype(jnp.int64) < jnp.minimum(n_runs, jnp.int64(g_cap))
    start_pos = jnp.clip(prev_end, 0, n - 1)
    lane = jnp.arange(_BLK, dtype=jnp.int32)

    def run_sum(arr):
        a2 = _pad(arr, 0).reshape(-1, _BLK)
        bs = jnp.sum(a2, axis=1)
        bp = jnp.concatenate([jnp.cumsum(bs) - bs, jnp.sum(bs)[None]])

        def prefix_at(pos):
            b = pos // _BLK
            rem = (pos % _BLK).astype(jnp.int32)
            rows = a2[jnp.clip(b, 0, nb - 1)]
            part = jnp.sum(
                jnp.where(lane[None, :] < rem[:, None], rows, 0), axis=1
            )
            return bp[b] + part

        return prefix_at(ends) - prefix_at(prev_end)

    rid_first = rid_p[::_BLK]
    rid_last = rid_p[_BLK - 1 :: _BLK]
    whole_blk = rid_first == rid_last
    e1 = jnp.maximum(ends, 1) - 1
    bs_ = prev_end // _BLK
    rs_ = (prev_end % _BLK).astype(jnp.int32)
    be_ = e1 // _BLK
    re_ = (e1 % _BLK).astype(jnp.int32) + 1
    same_blk = bs_ == be_

    def run_minmax(arr, want_min, sentinel):
        a2 = _pad(arr, sentinel).reshape(-1, _BLK)
        red = jnp.min if want_min else jnp.max
        bbest = red(a2, axis=1)
        tgt = jnp.where(
            whole_blk & (rid_first >= 0) & (rid_first < g_cap),
            rid_first.astype(jnp.int64),
            g_cap,
        )
        init = jnp.full((g_cap + 1,), sentinel, a2.dtype)
        scat = (
            init.at[tgt].min(bbest) if want_min else init.at[tgt].max(bbest)
        )[:g_cap]
        head_rows = a2[jnp.clip(bs_, 0, nb - 1)]
        not_same = jnp.logical_not(same_blk)
        hm = (lane[None, :] >= rs_[:, None]) & (
            not_same[:, None] | (lane[None, :] < re_[:, None])
        )
        head = red(jnp.where(hm, head_rows, sentinel), axis=1)
        tail_rows = a2[jnp.clip(be_, 0, nb - 1)]
        tm = (lane[None, :] < re_[:, None]) & not_same[:, None]
        tail = red(jnp.where(tm, tail_rows, sentinel), axis=1)
        return red(jnp.stack([scat, head, tail]), axis=0)

    big64 = jnp.int64(jnp.iinfo(jnp.int64).max)
    first_row = jnp.where(live, row_s[start_pos], big64)

    key_outs = []
    for (_o, _v, raw), ix in zip(keys, key_pay_ix):
        raw_s, valid_s = out[ix], out[ix + 1]
        kd = jnp.where(live, raw_s[start_pos], jnp.zeros((), raw_s.dtype))
        kv = live & (valid_s[start_pos] > 0)
        key_outs.append((kd, kv))

    states = []
    for (kind, data, valid, rank, out_dt), ix in zip(aggs, agg_pay_ix):
        if kind == "count_star":
            cnt = jnp.where(live, (ends - prev_end).astype(jnp.int64), 0)
            states.append({"cnt": cnt})
            continue
        data_s = out[ix]
        valid_s = (out[ix + 1] > 0) & alive_b
        cnt = jnp.where(live, run_sum(valid_s.astype(jnp.int64)), 0)
        if kind == "count":
            states.append({"cnt": cnt})
        elif kind in ("sum", "avg"):
            acc = data_s.astype(out_dt)
            sm = run_sum(jnp.where(valid_s, acc, 0))
            states.append({"cnt": cnt, "sum": jnp.where(live, sm, 0)})
        elif kind in ("min", "max"):
            if jnp.issubdtype(data_s.dtype, jnp.floating):
                sent = jnp.inf if kind == "min" else -jnp.inf
            else:
                ii = jnp.iinfo(data_s.dtype)
                sent = ii.max if kind == "min" else ii.min
            v = jnp.where(valid_s, data_s, jnp.asarray(sent, data_s.dtype))
            best = run_minmax(v, kind == "min", sent)
            states.append({"cnt": cnt, "best": best})
        elif kind in ("vmin", "vmax"):
            sent = big64 if kind == "vmin" else -big64
            v = jnp.where(valid_s, data_s, sent)
            best = run_minmax(v, kind == "vmin", sent)
            states.append(
                {"cnt": cnt, "best": (best & jnp.int64(0xFFFFFFFF)).astype(jnp.int32)}
            )
        else:
            raise ExecutorError(f"unknown partial aggregate kind {kind}")

    return key_outs, first_row, live, states, n_runs, overflow


def _orderable_inverse(key_field, t: LogicalType):
    """Invert ops/sort.orderable_key for the non-VARCHAR types (identity up
    to dtype, except the UBIGINT signed-range shift)."""
    if t == LogicalType.UBIGINT:
        return (key_field.astype(jnp.uint64) + jnp.uint64(2**63))
    return key_field.astype(numpy_dtype_for(t))


def _sortable(data):
    """lax.sort payload-friendly view (bools -> int32)."""
    if data.dtype == jnp.bool_:
        return data.astype(jnp.int32)
    return data


def _unsortable(data, t: LogicalType):
    dt = numpy_dtype_for(t)
    if data.dtype != dt:
        return data.astype(dt)
    return data
