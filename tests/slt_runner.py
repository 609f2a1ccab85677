"""sqllogictest runner.

Runs .slt files against the engine, replicating the reference harness's
behavior (reference tests/sqllogictest/tests/sqllogictest.rs:26-107): every
file runs against BOTH engine personalities —

- "sqlrs"    (v1): session preloaded with every tests/csv/*.csv as a table
  named by file stem (reference tests/sqllogictest/src/lib.rs:10-31)
- "sqlrs_v2" (v2): fresh instance (reference src/lib.rs:66-72)

gated per-record by `skipif <engine>` / `onlyif <engine>` directives. Our
engine implements the union of both generations, so both personalities share
one implementation; only session setup differs.

Comparison: rendered rows (reference src/util/mod.rs:53 rules) against the
expected block, whitespace-collapsed per line; `rowsort` sorts result lines.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass, field

# Conformance is defined on the CPU backend (like conftest.py); set both the
# env var and the config knob before first jax use.
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from sqlrs_tpu import Database
from sqlrs_tpu.errors import SqlrsError

REFERENCE_ROOT = "/root/reference"
ENGINES = ("sqlrs", "sqlrs_v2")


@dataclass
class Record:
    kind: str  # "statement_ok" | "statement_error" | "query"
    sql: str
    expected: list[str] = field(default_factory=list)
    rowsort: bool = False
    skipif: list[str] = field(default_factory=list)
    onlyif: list[str] = field(default_factory=list)
    line: int = 0


def parse_slt(path: str) -> list[Record]:
    lines = open(path).read().splitlines()
    records: list[Record] = []
    i = 0
    skipif: list[str] = []
    onlyif: list[str] = []
    while i < len(lines):
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        if line.startswith("skipif "):
            skipif.append(line.split()[1])
            i += 1
            continue
        if line.startswith("onlyif "):
            onlyif.append(line.split()[1])
            i += 1
            continue
        if line.startswith("statement") or line.startswith("query"):
            kind_line = line
            start = i
            i += 1
            sql_lines: list[str] = []
            while i < len(lines) and lines[i].strip() not in ("----",) and lines[i].strip():
                sql_lines.append(lines[i])
                i += 1
            expected: list[str] = []
            if i < len(lines) and lines[i].strip() == "----":
                i += 1
                while i < len(lines) and lines[i].strip():
                    expected.append(lines[i])
                    i += 1
            if kind_line.startswith("statement"):
                kind = (
                    "statement_error"
                    if "error" in kind_line
                    else "statement_ok"
                )
                rowsort = False
            else:
                kind = "query"
                rowsort = "rowsort" in kind_line
            records.append(
                Record(
                    kind=kind,
                    sql="\n".join(sql_lines),
                    expected=expected,
                    rowsort=rowsort,
                    skipif=skipif,
                    onlyif=onlyif,
                    line=start + 1,
                )
            )
            skipif, onlyif = [], []
            continue
        i += 1
    return records


def make_session(engine: str, base_dir: str = REFERENCE_ROOT) -> Database:
    db = Database(base_dir=base_dir)
    if engine == "sqlrs":
        for csv_path in sorted(glob.glob(os.path.join(base_dir, "tests/csv/*.csv"))):
            name = os.path.splitext(os.path.basename(csv_path))[0]
            db.create_csv_table(name, csv_path)
    return db


def _norm(line: str) -> str:
    return re.sub(r"\s+", " ", line.strip())


@dataclass
class Failure:
    path: str
    line: int
    sql: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.message}\n  sql: {self.sql}"


def run_slt_file(path: str, engine: str, base_dir: str = REFERENCE_ROOT) -> list[Failure]:
    db = make_session(engine, base_dir)
    failures: list[Failure] = []
    for rec in parse_slt(path):
        if engine in rec.skipif or (rec.onlyif and engine not in rec.onlyif):
            continue
        if rec.kind == "statement_error":
            try:
                db.run(rec.sql)
                failures.append(
                    Failure(path, rec.line, rec.sql, "expected error, got success")
                )
            except SqlrsError:
                pass
            except Exception as e:  # non-engine error = harness bug, surface it
                failures.append(
                    Failure(
                        path, rec.line, rec.sql,
                        f"expected engine error, got {type(e).__name__}: {e}",
                    )
                )
            continue
        try:
            lines = db.run_lines(rec.sql)
        except Exception as e:
            failures.append(
                Failure(path, rec.line, rec.sql, f"{type(e).__name__}: {e}")
            )
            continue
        if rec.kind == "statement_ok":
            continue
        actual = [_norm(l) for l in lines]
        expected = [_norm(l) for l in rec.expected]
        if rec.rowsort:
            actual, expected = sorted(actual), sorted(expected)
        if actual != expected:
            failures.append(
                Failure(
                    path, rec.line, rec.sql,
                    "result mismatch\n  expected: %r\n  actual:   %r"
                    % (expected, actual),
                )
            )
    return failures


def all_slt_files(base_dir: str = REFERENCE_ROOT) -> list[str]:
    return sorted(glob.glob(os.path.join(base_dir, "tests/slt/**/*.slt"), recursive=True))


def main() -> int:
    import sys

    files = sys.argv[1:] or all_slt_files()
    total_failures = 0
    for f in files:
        for engine in ENGINES:
            fails = run_slt_file(f, engine)
            status = "ok" if not fails else f"{len(fails)} FAILED"
            print(f"{os.path.basename(f):28s} [{engine:8s}] {status}")
            for x in fails:
                print("   ", str(x).replace("\n", "\n    "))
            total_failures += len(fails)
    print(f"\n{'PASS' if total_failures == 0 else 'FAIL'}: {total_failures} failures")
    return 1 if total_failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
