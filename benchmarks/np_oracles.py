"""Plain-numpy oracles for the queries `chip_smoke.py` runs.

Independent of the engine and of pandas: every function here takes the
numpy columns that `benchmarks/tpch_dbgen.gen_tables` (or the star-rollup
generator) produced and returns the expected result as a list of tuples in
the engine's output column order and row order — floats as float, dates as
epoch-day ints, strings as str. Imports nothing beyond numpy.

`compare` is the one result check shared by `chip_smoke.py` and
`benchmarks/tpch.py`: integer, date and string cells must match exactly;
float cells within 1e-9 relative / 1e-6 absolute, because the engine sums
DOUBLE measures in XLA's reduction order while numpy sums sequentially.
"""

from __future__ import annotations

import math

import numpy as np

REL_TOL = 1e-9
ABS_TOL = 1e-6


def day(s: str) -> int:
    """'YYYY-MM-DD' -> days since 1970-01-01 (the engine's DATE encoding)."""
    return int(np.datetime64(s, "D").astype(np.int64))


def _order_index(o_orderkey: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Row of each key in the (ascending, unique) orders key column."""
    idx = np.searchsorted(o_orderkey, keys)
    assert np.array_equal(o_orderkey[idx], keys), "dangling l_orderkey"
    return idx


def _int_sums(gid: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """Per-group integer sums; exact while every partial sum is < 2^53."""
    assert np.abs(vals).sum(dtype=np.float64) < 2.0**53
    return np.bincount(gid, weights=vals, minlength=n).astype(np.int64)


def q1(t: dict) -> list[tuple]:
    li = t["lineitem"]
    m = li["l_shipdate"] <= day("1998-09-02")
    rf, ls = li["l_returnflag"][m], li["l_linestatus"][m]
    qty = li["l_quantity"][m]
    price = li["l_extendedprice"][m]
    disc = li["l_discount"][m]
    tax = li["l_tax"][m]
    # (returnflag, linestatus) are one character each, so the joined string
    # sorts exactly like the ORDER BY pair
    groups, gid = np.unique(np.char.add(rf, ls), return_inverse=True)
    ng = len(groups)
    cnt = np.bincount(gid, minlength=ng)
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)

    def fsum(w):
        return np.bincount(gid, weights=w, minlength=ng)

    sum_qty = _int_sums(gid, qty, ng)
    s_price, s_disc_price, s_charge = fsum(price), fsum(disc_price), fsum(charge)
    s_disc = fsum(disc)
    return [
        (str(groups[g][0]), str(groups[g][1]), int(sum_qty[g]),
         float(s_price[g]), float(s_disc_price[g]), float(s_charge[g]),
         float(sum_qty[g] / cnt[g]), float(s_price[g] / cnt[g]),
         float(s_disc[g] / cnt[g]), int(cnt[g]))
        for g in range(ng)
    ]


def q3(t: dict) -> list[tuple]:
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    building = np.zeros(int(c["c_custkey"].max()) + 1, np.bool_)
    building[c["c_custkey"][c["c_mktsegment"] == "BUILDING"]] = True
    o_ok = (o["o_orderdate"] < day("1995-03-15")) & building[o["o_custkey"]]
    oi = _order_index(o["o_orderkey"], li["l_orderkey"])
    keep = (li["l_shipdate"] > day("1995-03-15")) & o_ok[oi]
    rev_line = li["l_extendedprice"][keep] * (1 - li["l_discount"][keep])
    n_o = len(o["o_orderkey"])
    rev = np.bincount(oi[keep], weights=rev_line, minlength=n_o)
    has = np.bincount(oi[keep], minlength=n_o) > 0
    rows = np.nonzero(has)[0]  # ascending orderkey: the ties' base order
    order = np.lexsort((o["o_orderdate"][rows], -rev[rows]))[:10]
    sel = rows[order]
    return [
        (int(o["o_orderkey"][r]), float(rev[r]), int(o["o_orderdate"][r]),
         int(o["o_shippriority"][r]))
        for r in sel
    ]


def q4(t: dict) -> list[tuple]:
    o, li = t["orders"], t["lineitem"]
    late = np.zeros(len(o["o_orderkey"]), np.bool_)
    late_lines = li["l_commitdate"] < li["l_receiptdate"]
    late[_order_index(o["o_orderkey"], li["l_orderkey"][late_lines])] = True
    m = ((o["o_orderdate"] >= day("1993-07-01"))
         & (o["o_orderdate"] < day("1993-10-01")) & late)
    pri, cnt = np.unique(o["o_orderpriority"][m], return_counts=True)
    return [(str(p), int(n)) for p, n in zip(pri, cnt)]


def q6(t: dict) -> list[tuple]:
    li = t["lineitem"]
    m = ((li["l_shipdate"] >= day("1994-01-01"))
         & (li["l_shipdate"] < day("1995-01-01"))
         & (li["l_discount"] >= 0.05) & (li["l_discount"] <= 0.07)
         & (li["l_quantity"] < 24))
    if not m.any():
        return [(None,)]  # SUM over no rows is NULL
    return [(float(np.sum(li["l_extendedprice"][m] * li["l_discount"][m])),)]


def _like_special_requests(comments: np.ndarray) -> np.ndarray:
    """comments LIKE '%special%requests%'."""
    parts = np.char.partition(comments, "special")
    return (parts[:, 1] != "") & (np.char.find(parts[:, 2], "requests") >= 0)


def q13(t: dict) -> list[tuple]:
    c, o = t["customer"], t["orders"]
    keep = ~_like_special_requests(o["o_comment"])
    per_cust = np.bincount(
        o["o_custkey"][keep], minlength=int(c["c_custkey"].max()) + 1
    )
    c_count = per_cust[c["c_custkey"]]
    custdist = np.bincount(c_count)
    vals = np.nonzero(custdist)[0]
    order = np.lexsort((-vals, -custdist[vals]))
    return [(int(vals[k]), int(custdist[vals[k]])) for k in order]


def q18(t: dict) -> list[tuple]:
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    oi = _order_index(o["o_orderkey"], li["l_orderkey"])
    qty = _int_sums(oi, li["l_quantity"], len(o["o_orderkey"]))
    big = np.nonzero(qty > 300)[0]
    cust_row = np.searchsorted(c["c_custkey"], o["o_custkey"][big])
    # groupby order (c_name, c_custkey, o_orderkey, ...) is the ties' base
    base = np.lexsort((o["o_orderkey"][big], c["c_custkey"][cust_row],
                       c["c_name"][cust_row]))
    big, cust_row = big[base], cust_row[base]
    order = np.lexsort((o["o_orderdate"][big], -o["o_totalprice"][big]))[:100]
    return [
        (str(c["c_name"][cust_row[k]]), int(c["c_custkey"][cust_row[k]]),
         int(o["o_orderkey"][big[k]]), int(o["o_orderdate"][big[k]]),
         float(o["o_totalprice"][big[k]]), int(qty[big[k]]))
        for k in order
    ]


TPCH = {1: q1, 3: q3, 4: q4, 6: q6, 13: q13, 18: q18}


def rollup(dim_keys: np.ndarray, gid: np.ndarray, vals: np.ndarray) -> list[tuple]:
    """select d.k, sum(f.v), count(*) from fact f join dim d on f.k = d.k
    group by d.k order by d.k — for fact keys dim_keys[gid] and dim_keys
    ascending in gid."""
    g = len(dim_keys)
    sums = _int_sums(gid, vals, g)
    counts = np.bincount(gid, minlength=g)
    hit = np.nonzero(counts)[0]
    return list(zip(dim_keys[hit].tolist(), sums[hit].tolist(),
                    counts[hit].tolist()))


def compare(got: list[tuple], exp: list[tuple], label: str) -> list[str]:
    """Cell-wise check, row order included; returns the problems found."""
    if len(got) != len(exp):
        return [f"{label}: row count {len(got)} != expected {len(exp)}"]
    issues = []
    for i, (g, e) in enumerate(zip(got, exp)):
        if len(g) != len(e):
            return issues + [f"{label} row {i}: width {len(g)} != {len(e)}"]
        for j, (gv, ev) in enumerate(zip(g, e)):
            if isinstance(ev, (float, np.floating)) or isinstance(gv, float):
                if gv is None or ev is None:
                    ok = gv is None and (ev is None or math.isnan(ev))
                else:
                    ok = math.isclose(float(gv), float(ev), rel_tol=REL_TOL,
                                      abs_tol=ABS_TOL)
            else:
                ok = gv == ev
            if not ok:
                issues.append(
                    f"{label} row {i} col {j}: got {gv!r} expected {ev!r}"
                )
                if len(issues) > 5:
                    return issues
    return issues
