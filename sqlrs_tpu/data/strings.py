"""Interning dictionary for VARCHAR columns.

Device-first string representation: device arrays never hold bytes. Every
distinct string in the engine is interned once into a process-global
dictionary and columns carry its int32 code. Consequences:

- equality (joins, group-by, DISTINCT) is exact integer equality on codes —
  ACROSS columns and tables, with no hash-collision caveat (the reference's
  hash join matches on hash only, TODO at reference
  src/executor/join/hash_join.rs:221-224; we are exact) and no
  dictionary-reconciliation step at exchange time;
- ordered ops (<, >, MIN/MAX on strings, ORDER BY) go through a cached
  lexicographic-rank projection: rank[code] is monotone in string order, so
  comparisons run on-device on rank arrays. The rank sort is vectorized: a
  24-byte prefix lexsort (three big-endian u64 keys — UTF-8 byte order
  equals code-point order) with Python-compare fallback only inside
  equal-prefix runs, far faster than a full object argsort (the TPC-H SF1
  comment columns made this load-bearing);
- per-pattern LIKE / substring code-map tables extend INCREMENTALLY as the
  dictionary grows (see match_table), so repeated predicates cost O(new
  strings), not O(dictionary) per call;
- rendering gathers codes to host and indexes the dictionary.

Replaces Arrow Utf8 arrays (reference src/types/mod.rs:23, Strings are a
first-class ScalarValue variant there).
"""

from __future__ import annotations

import numpy as np

NULL_CODE = -1  # code used in invalid slots

_PREFIX_BYTES = 48


def _lex_argsort(values: list[str]) -> np.ndarray:
    """Lexicographic argsort of a string list, vectorized.

    Fast path: encode each string's first 48 UTF-8 bytes (byte order ==
    code-point order) as six big-endian u64 keys and np.lexsort them;
    resolve only equal-prefix tie runs with Python comparisons. Falls back
    to a full object argsort if encoding fails (never for TPC-H/slt data)."""
    n = len(values)
    if n <= 1:
        return np.arange(n, dtype=np.int64)
    try:
        a = np.array(values, dtype=f"S{_PREFIX_BYTES}")
    except UnicodeEncodeError:
        return np.argsort(np.array(values, dtype=object), kind="stable")
    raw = np.zeros((n, _PREFIX_BYTES), dtype=np.uint8)
    av = a.view(np.uint8).reshape(n, -1)
    raw[:, : av.shape[1]] = av[:, :_PREFIX_BYTES]
    keys = raw.view(">u8")  # (n, 6) big-endian u64, order-preserving
    order = np.lexsort(tuple(keys[:, j] for j in range(keys.shape[1] - 1, -1, -1)))
    # resolve ties: only runs whose FULL 48-byte prefixes are equal can
    # still be mis-ordered (strings longer than the prefix); loop over
    # those runs alone
    k = keys[order]
    same = np.all(k[1:] == k[:-1], axis=1)
    idx = np.flatnonzero(same)
    if len(idx):
        breaks = np.flatnonzero(np.diff(idx) > 1)
        starts = np.concatenate([idx[:1], idx[breaks + 1]])
        ends = np.concatenate([idx[breaks], idx[-1:]]) + 2
        for s, e in zip(starts, ends):
            seg = order[s:e]
            seg_sorted = sorted(seg, key=lambda i: values[i])
            order[s:e] = seg_sorted
    return order


class _MatchTable:
    """An append-only bool/int32 table over dictionary codes, extended
    lazily as the dictionary grows: fn evaluates only the NEW entries."""

    def __init__(self, fn, dtype) -> None:
        self.fn = fn
        self.table = np.zeros(0, dtype)

    def get(self, dictionary: "StringDictionary") -> np.ndarray:
        n = len(dictionary)
        if len(self.table) < n:
            start = len(self.table)
            new = np.fromiter(
                (self.fn(dictionary.lookup(i)) for i in range(start, n)),
                dtype=self.table.dtype,
                count=n - start,
            )
            self.table = np.concatenate([self.table, new])
        return self.table[:n]


def _load_intern_lib():
    """ctypes handle to native/libsqlrs_intern.so (auto-built); None when
    unavailable or disabled via SQLRS_TPU_NATIVE_INTERN=0."""
    import ctypes
    import os
    import subprocess

    if os.environ.get("SQLRS_TPU_NATIVE_INTERN", "1") == "0":
        return None
    native_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
    )
    lib_path = os.path.join(native_dir, "libsqlrs_intern.so")
    try:
        if not os.path.exists(lib_path):
            subprocess.run(
                ["make", "-C", native_dir, "-s"],
                check=True,
                capture_output=True,
                timeout=120,
            )
        lib = ctypes.CDLL(lib_path)
    except Exception:
        return None
    lib.sqlrs_intern_bulk_ucs4.restype = ctypes.c_int64
    lib.sqlrs_intern_bulk_ucs4.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.sqlrs_intern_one.restype = ctypes.c_int32
    lib.sqlrs_intern_one.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


class StringDictionary:
    def __init__(self, native_ok: bool = False) -> None:
        self._codes: dict[str, int] = {}
        self._values: list[str] = []
        self._ranks: np.ndarray | None = None  # lex rank per code, cached
        self._match_tables: dict = {}  # key -> _MatchTable
        # the native interner's hash map is PROCESS-GLOBAL (one bytes->code
        # map, like this dictionary's contract); only the designated global
        # instance may bind to it, and only while still empty so the two
        # sides never diverge
        self._native_ok = native_ok
        self._native = None  # None = undecided, False = python path, else lib
        # incremental rank maintenance: codes in lex order + the values in
        # that order (object array, so merges use Python comparisons only
        # for the new entries)
        self._sorted_codes: np.ndarray | None = None
        self._sorted_vals: np.ndarray | None = None

    def _native_lib(self):
        if self._native is None:
            self._native = (
                (_load_intern_lib() or False)
                if self._native_ok and not self._values
                else False
            )
        return self._native

    def __len__(self) -> int:
        return len(self._values)

    def intern(self, s: str) -> int:
        lib = self._native_lib()
        if lib:
            import ctypes

            b = s.encode("utf-32-le")
            is_new = ctypes.c_int32(0)
            code = lib.sqlrs_intern_one(
                b, len(b), len(self._values), ctypes.byref(is_new)
            )
            if is_new.value:
                self._values.append(s)
                self._ranks = None
            return code
        code = self._codes.get(s)
        if code is None:
            code = len(self._values)
            self._codes[s] = code
            self._values.append(s)
            self._ranks = None
        return code

    def intern_many(self, strings) -> np.ndarray:
        """Intern an iterable; None entries get NULL_CODE. Deduplicates
        through np.unique first so the Python-level intern loop runs once
        per DISTINCT value."""
        try:
            arr = np.asarray(strings)
        except Exception:
            arr = None
        if (
            arr is not None
            and arr.dtype.kind == "U"
            and arr.ndim == 1
            and len(arr) > 256
        ):
            lib = self._native_lib()
            if lib:
                import ctypes

                buf = np.ascontiguousarray(arr)
                width = buf.dtype.itemsize // 4
                codes = np.empty(len(buf), np.int32)
                new_rows = np.empty(len(buf), np.int64)
                n_new = lib.sqlrs_intern_bulk_ucs4(
                    buf.ctypes.data_as(ctypes.c_void_p),
                    len(buf),
                    width,
                    len(self._values),
                    codes.ctypes.data_as(ctypes.c_void_p),
                    new_rows.ctypes.data_as(ctypes.c_void_p),
                )
                if n_new:
                    self._values.extend(buf[new_rows[:n_new]].tolist())
                    self._ranks = None
                return codes
            # np.unique SORTS, which dominates bulk-load time for
            # high-cardinality columns (TPC-H comments are near-unique:
            # the sort costs ~5x the dict pass it was meant to save).
            # Sample the distinct ratio and only pre-dedup when it pays.
            step = max(len(arr) // 512, 1)
            sample = arr[::step][:512]
            if len(np.unique(sample)) <= len(sample) // 2:
                uniq, inverse = np.unique(arr, return_inverse=True)
                codes = np.fromiter(
                    (self.intern(u) for u in uniq.tolist()),
                    dtype=np.int32,
                    count=len(uniq),
                )
                return codes[inverse].astype(np.int32)
            return np.fromiter(
                (self.intern(s) for s in arr.tolist()),
                dtype=np.int32,
                count=len(arr),
            )
        out = np.empty(len(strings), dtype=np.int32)
        for i, s in enumerate(strings):
            out[i] = NULL_CODE if s is None else self.intern(s)
        return out

    def lookup(self, code: int) -> str:
        return self._values[code]

    def decode(self, codes: np.ndarray, valid: np.ndarray) -> list[str | None]:
        return [
            self._values[int(c)] if v else None
            for c, v in zip(codes.tolist(), valid.tolist())
        ]

    def ranks(self) -> np.ndarray:
        """rank[code] = position of the string in lexicographic order.

        Monotone in string order, so rank comparison == string comparison.
        Cached until a new string is interned; SMALL appends (≤10% growth,
        e.g. substring results interned mid-query) MERGE into the cached
        sorted order — O(new·log D) Python comparisons + O(D) pointer
        moves — instead of re-sorting millions of strings.
        """
        n = len(self._values)
        if self._ranks is not None and len(self._ranks) == n:
            return self._ranks
        n_old = 0 if self._sorted_codes is None else len(self._sorted_codes)
        k = n - n_old
        if 0 < k <= max(n_old // 10, 1024) and n_old > 0:
            new_vals = self._values[n_old:]
            new_order = _lex_argsort(new_vals)
            new_sorted_vals = np.array(
                [new_vals[i] for i in new_order], dtype=object
            )
            new_codes = (n_old + new_order).astype(np.int64)
            ins = np.searchsorted(self._sorted_vals, new_sorted_vals)
            self._sorted_codes = np.insert(self._sorted_codes, ins, new_codes)
            self._sorted_vals = np.insert(
                self._sorted_vals, ins, new_sorted_vals
            )
        else:
            order = _lex_argsort(self._values)
            self._sorted_codes = order.astype(np.int64)
            self._sorted_vals = np.array(self._values, dtype=object)[
                self._sorted_codes
            ]
        ranks = np.empty(n, dtype=np.int64)
        ranks[self._sorted_codes] = np.arange(n, dtype=np.int64)
        self._ranks = ranks
        return self._ranks

    def ranks_device(self):
        """Device-resident rank table, cached by dictionary version — callers
        used to jnp.asarray(ranks()) per use, re-transferring the whole table
        every sort/compare."""
        import jax
        import jax.numpy as jnp

        r = self.ranks()
        cached = getattr(self, "_ranks_dev", None)
        if cached is not None and cached.shape[0] == len(r):
            return cached
        dev = jnp.asarray(r)
        if not isinstance(dev, jax.core.Tracer):
            # never cache under an active jit trace: a cached tracer leaks
            # out of its trace and poisons later calls (UnexpectedTracerError)
            self._ranks_dev = dev
        return dev

    def match_table(self, key, fn, dtype=np.bool_) -> np.ndarray:
        """Memoized per-code table for a string predicate/transform (LIKE
        match bits, substring target codes, ...). Costs O(new entries) per
        call — the table extends incrementally as interning grows the
        dictionary, so a repeated LIKE over a stable dictionary is free."""
        t = self._match_tables.get(key)
        if t is None:
            t = _MatchTable(fn, np.dtype(dtype))
            self._match_tables[key] = t
        return t.get(self)


# One dictionary per process: codes are globally comparable, so exchange
# between partitions / hosts needs no dictionary reconciliation on device.
# The global instance binds to the native C++ interner (native/interner.cpp)
# when available — code assignment for bulk loads runs at native speed.
GLOBAL_STRINGS = StringDictionary(native_ok=True)
