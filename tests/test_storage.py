"""Storage tests: CSV inference + native/Python loader equivalence + the
in-memory table store (bounds/projection per reference src/storage/csv.rs
tests :310-400 and local_storage coalescing :98-120)."""

import os

import numpy as np
import pytest

import sqlrs_tpu  # noqa: F401
from sqlrs_tpu.storage.csv import CsvConfig, read_csv_file
from sqlrs_tpu.storage.memory import DataTable
from sqlrs_tpu.types import LogicalType as LT, ScalarValue

EMPLOYEE = os.path.join(os.path.dirname(__file__), "csv", "employee.csv")


def test_csv_inference_and_nulls(tmp_path):
    p = tmp_path / "x.csv"
    p.write_text(
        "a,b,c,d,e\n1,1.5,true,2020-01-02,hi\n2,,false,,\n\n"
    )
    t = read_csv_file(str(p))
    assert t.types == [LT.BIGINT, LT.DOUBLE, LT.BOOLEAN, LT.DATE, LT.VARCHAR]
    assert t.num_rows == 2  # trailing blank line skipped
    rows = t.scan().to_pylist()
    assert rows[0][0] == 1 and rows[0][2] is True and rows[0][4] == "hi"
    # empty -> NULL for typed cols, "" for utf8
    assert rows[1][1] is None and rows[1][3] is None and rows[1][4] == ""


def test_csv_quoting(tmp_path):
    p = tmp_path / "q.csv"
    p.write_text('a,b\n"x,y",2\n"he said ""hi""",3\n')
    t = read_csv_file(str(p))
    rows = t.scan().to_pylist()
    assert rows[0][0] == "x,y"
    assert rows[1][0] == 'he said "hi"'


def test_csv_no_header_and_delim(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("1|x\n2|y\n")
    t = read_csv_file(str(p), CsvConfig(has_header=False, delimiter="|"))
    assert t.names == ["column_1", "column_2"]
    assert t.types == [LT.BIGINT, LT.VARCHAR]


def test_native_loader_matches_python():
    from sqlrs_tpu.storage.native_loader import native_available, read_csv_native

    if not native_available():
        pytest.skip("native loader not built")
    a = read_csv_native(EMPLOYEE)
    b = read_csv_file(EMPLOYEE)
    assert a.names == b.names and a.types == b.types
    assert a.scan().to_pylist() == b.scan().to_pylist()


def test_datatable_scan_bounds_projection():
    t = DataTable(["a", "b"], [LT.BIGINT, LT.VARCHAR])
    t.append_rows(
        [
            [ScalarValue(LT.BIGINT, i), ScalarValue(LT.VARCHAR, f"s{i}")]
            for i in range(10)
        ]
    )
    b = t.scan(projection=[1], bounds=(3, 4))
    assert b.schema.names == ["b"]
    assert [r[0] for r in b.to_pylist()] == ["s3", "s4", "s5", "s6"]
    # bounds beyond the table clip cleanly
    assert t.scan(bounds=(20, 5)).num_rows == 0


def test_datatable_tile_growth():
    t = DataTable(["a"], [LT.BIGINT])
    for i in range(5):
        t.append_rows([[ScalarValue(LT.BIGINT, i)]])
    assert t.num_rows == 5
    assert [r[0] for r in t.scan().to_pylist()] == list(range(5))
