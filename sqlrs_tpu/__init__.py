"""sqlrs_tpu — a vectorized OLAP SQL query engine on JAX/XLA accelerators.

A from-scratch reimplementation of the capabilities of Fedomn/sqlrs (a
DuckDB-modeled in-process SQL engine):

- Data plane: fixed-width columnar device batches (jax arrays + validity
  masks) instead of Arrow chunks; strings are dictionary-encoded int32 codes
  against an interning dictionary (host-resident, device ops on codes).
- Operators: vectorized JAX/XLA programs built on the sort primitive:
  grouped aggregate / join / order-by are sort-run formulations with
  group-sized (not row-sized) random access (see sqlrs_tpu/ops/).
- Distribution: tables hash-partitioned over a jax.sharding.Mesh; exchange =
  all-to-all collectives via shard_map (see sqlrs_tpu/parallel/).
- Frontend (parser/binder/planner/HEP optimizer) is host Python — it is not
  perf-critical and is specified by the reference's plan-tree goldens.

Entry point mirrors the reference's session layer (reference src/db.rs:107,
src/main_entry/client_context.rs:34):

    import sqlrs_tpu
    db = sqlrs_tpu.Database()
    db.create_csv_table("employee", "tests/csv/employee.csv")
    rows = db.run("select first_name from employee where last_name='Hopkins'")
"""

import os as _os

import jax

# SQL needs 64-bit ints (BIGINT, SUM results) — enable x64 before any jax use.
jax.config.update("jax_enable_x64", True)


def _compile_cache_dir(environ) -> str | None:
    """Where this package puts JAX's persistent compilation cache: nowhere
    of its own when JAX_COMPILATION_CACHE_DIR is set (JAX reads the variable
    itself), else a fixed directory inside the checkout, so that every
    process of one checkout shares compiled plans."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )


_cache_dir = _compile_cache_dir(_os.environ)
if _cache_dir is not None:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from sqlrs_tpu.errors import (  # noqa: E402
    BinderError,
    CatalogError,
    ExecutorError,
    ParserError,
    SqlrsError,
    TypeError_,
)
from sqlrs_tpu.session.database import Database  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Database",
    "SqlrsError",
    "ParserError",
    "BinderError",
    "CatalogError",
    "ExecutorError",
    "TypeError_",
]
