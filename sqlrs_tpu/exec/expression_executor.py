"""Expression executor: resolved BoundExpr tree → device Column.

The vectorized evaluator (reference src/executor/evaluator.rs:13 eval_column;
v2 src/execution/expression_executor.rs:11-40). Dispatches to the jnp kernels
in sqlrs_tpu/ops/elementwise.py; XLA fuses the resulting op chains.
"""

from __future__ import annotations

from sqlrs_tpu.binder.expression import (
    BoundCast,
    BoundComparison,
    BoundConjunction,
    BoundConstant,
    BoundExpr,
    BoundFunction,
    BoundNot,
    BoundReference,
)
from sqlrs_tpu.data import Column, DeviceBatch
from sqlrs_tpu.errors import ExecutorError
from sqlrs_tpu.ops import elementwise as ew
from sqlrs_tpu.types import Interval, LogicalType, ScalarValue


from collections import OrderedDict

# LRU-bounded: keys include expr list, schema, row count, and string-dict
# version, so long sessions with varying batch sizes would otherwise
# accumulate compiled programs without limit.
_FUSED_CACHE: OrderedDict = OrderedDict()
_FUSED_CACHE_MAX = 512


def execute_exprs_fused(exprs, batch: DeviceBatch) -> list[Column]:
    """Evaluate a LIST of expressions over a batch as ONE jitted XLA program:
    one dispatch and one fused pass over HBM, instead of one compiled op per
    elementwise node (eager mode compiles per op, so a 10-node predicate
    costs 10 read+write passes; fused it costs one). Falls back to eager
    evaluation for expressions that concretize at trace time (e.g. casts
    that parse the string dictionary on the host).

    Cache key includes the string-dictionary length: the dictionary is
    append-only, so its length is a version (LIKE tables and rank
    projections bake dictionary contents into the traced program)."""
    import os

    if (
        os.environ.get("SQLRS_TPU_FUSE", "1") == "0"
        or batch.num_rows == 0
        or not batch.columns
        or not exprs
    ):
        return [execute_expr(e, batch) for e in exprs]
    if all(isinstance(e, BoundReference) for e in exprs):
        # pure column selection (pruning projections, most join/order keys):
        # ZERO device programs — an identity jit still costs a dispatch
        return [batch.columns[e.index] for e in exprs]
    import jax

    from sqlrs_tpu.data.strings import GLOBAL_STRINGS

    sig = (
        tuple(repr(e) for e in exprs),
        tuple(
            (f.type, str(c.data.dtype), c.data.shape[0])
            for f, c in zip(batch.schema.fields, batch.columns)
        ),
        batch.num_rows,
        len(GLOBAL_STRINGS),
    )
    entry = _FUSED_CACHE.get(sig)
    if entry is not None:
        _FUSED_CACHE.move_to_end(sig)
    if entry is False:  # known trace failure: permanent eager fallback
        return [execute_expr(e, batch) for e in exprs]
    if entry is None:
        schema, n, e_list = batch.schema, batch.num_rows, list(exprs)
        out_types: list = []

        def run(datas, valids):
            cols = [
                Column(f.type, d, v)
                for f, d, v in zip(schema.fields, datas, valids)
            ]
            b = DeviceBatch(schema, cols, n)
            outs = [execute_expr(e, b) for e in e_list]
            if not out_types:
                out_types.extend(c.type for c in outs)
            return tuple(c.data for c in outs), tuple(c.valid for c in outs)

        entry = (jax.jit(run), out_types)
        _FUSED_CACHE[sig] = entry
        while len(_FUSED_CACHE) > _FUSED_CACHE_MAX:
            _FUSED_CACHE.popitem(last=False)
    fn, out_types = entry
    try:
        od, ov = fn(
            tuple(c.data for c in batch.columns),
            tuple(c.valid for c in batch.columns),
        )
    except jax.errors.JAXTypeError:
        # trace-time concretization (host-side string work etc.): this
        # signature can never fuse — pin the eager fallback
        _FUSED_CACHE[sig] = False
        return [execute_expr(e, batch) for e in exprs]
    except Exception:
        # transient (OOM, interrupt, backend hiccup): fall back this once
        # but leave the compiled program cached for the next call
        return [execute_expr(e, batch) for e in exprs]
    return [Column(t, d, v) for t, d, v in zip(out_types, od, ov)]


def execute_expr(expr: BoundExpr, batch: DeviceBatch) -> Column:
    if isinstance(expr, BoundReference):
        return batch.columns[expr.index]
    if isinstance(expr, BoundConstant):
        v = expr.value
        t = v.type if v.type != LogicalType.SQLNULL else LogicalType.SQLNULL
        return Column.broadcast(v, t, batch.num_rows)
    if isinstance(expr, BoundCast):
        child = execute_expr(expr.child, batch)
        return ew.cast_column(child, expr.target, safe=expr.try_cast)
    if isinstance(expr, BoundComparison):
        left = execute_expr(expr.left, batch)
        right = execute_expr(expr.right, batch)
        return ew.compare(expr.op, left, right)
    if isinstance(expr, BoundConjunction):
        cols = [execute_expr(a, batch) for a in expr.args]
        out = cols[0]
        for c in cols[1:]:
            out = ew.kleene_and(out, c) if expr.op == "AND" else ew.kleene_or(out, c)
        return out
    if isinstance(expr, BoundNot):
        return ew.logical_not(execute_expr(expr.child, batch))
    if isinstance(expr, BoundFunction):
        return _execute_function(expr, batch)
    from sqlrs_tpu.binder.expression import BoundCase, BoundIsNull

    if isinstance(expr, BoundIsNull):
        return ew.is_null(execute_expr(expr.child, batch), expr.negated)
    if isinstance(expr, BoundCase):
        conds = [execute_expr(c, batch) for c in expr.conditions]
        results = [execute_expr(r, batch) for r in expr.results]
        return ew.case_when(conds, results, expr.type)
    raise ExecutorError(f"cannot execute expression {type(expr).__name__}")


def _execute_function(expr: BoundFunction, batch: DeviceBatch) -> Column:
    if expr.op in ("+", "-", "*", "/", "%"):
        left = execute_expr(expr.args[0], batch)
        right = execute_expr(expr.args[1], batch)
        return ew.arithmetic(expr.op, expr.type, left, right)
    if expr.op == "neg":
        return ew.negate(execute_expr(expr.args[0], batch))
    if expr.op in ("date+", "date-"):
        dates = execute_expr(expr.args[0], batch)
        interval = _constant_interval(expr.args[1])
        sign = 1 if expr.op == "date+" else -1
        return ew.date_add_interval(dates, interval, sign)
    if expr.op == "like":
        col = execute_expr(expr.args[0], batch)
        pattern = expr.args[1]
        return ew.like_match(col, pattern.value.value)
    if expr.op.startswith("extract_"):
        col = execute_expr(expr.args[0], batch)
        return ew.extract_date_field(col, expr.op.removeprefix("extract_"))
    if expr.op == "substring":
        col = execute_expr(expr.args[0], batch)
        start = int(expr.args[1].value.value)
        length = (
            int(expr.args[2].value.value) if len(expr.args) > 2 else None
        )
        return ew.substring_column(col, start, length)
    if expr.op == "concat":
        left = execute_expr(expr.args[0], batch)
        right = execute_expr(expr.args[1], batch)
        return ew.concat_columns(left, right)
    raise ExecutorError(f"unknown function kernel {expr.op}")


def _constant_interval(expr: BoundExpr) -> Interval:
    if isinstance(expr, BoundConstant) and isinstance(expr.value.value, Interval):
        return expr.value.value
    raise ExecutorError("INTERVAL operands must be constants")


def execute_scalar(expr: BoundExpr) -> ScalarValue:
    """Evaluate a row-independent expression on a 1-row dummy batch
    (reference src/execution/util.rs:34)."""
    from sqlrs_tpu.data import Schema

    dummy = DeviceBatch(Schema(()), [], 1)
    col = execute_expr(expr, dummy)
    return col.scalar_at(0)
