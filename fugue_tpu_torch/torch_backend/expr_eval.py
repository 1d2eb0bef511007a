"""Column-expression evaluation on the card: masked tensors with null
propagation.

A port of ``fugue_tpu/jax_backend/expr_eval.py`` restricted to what the
slice's aggregates take: named columns, numeric literals and ``+ - * /``.
Types follow the JAX package with 64-bit types on: an int literal is
int64, a float literal float64, and dividing two integer columns gives
float64 (PyTorch alone would give float32).
"""

from typing import Dict, Optional, Tuple

import torch

from fugue_tpu_torch.column.expressions import (
    ColumnExpr,
    _BinaryOpExpr,
    _LitColumnExpr,
    _NamedColumnExpr,
)
from fugue_tpu_torch.torch_backend.blocks import TorchBlocks
from fugue_tpu_torch.utils.assertion import assert_or_throw

# a masked value: (values, mask) — mask None means all-valid
Masked = Tuple[torch.Tensor, Optional[torch.Tensor]]

_ARITH_OPS = ("+", "-", "*", "/")


def blocks_to_masked(blocks: TorchBlocks) -> Dict[str, Masked]:
    """``jax_backend/expr_eval.py:564``."""
    return {name: (c.data, c.mask) for name, c in blocks.columns.items()}


def can_eval_on_device(expr: ColumnExpr, blocks: TorchBlocks) -> bool:
    """Whether ``eval_expr`` takes the whole tree
    (``jax_backend/expr_eval.py:632``)."""
    if isinstance(expr, _NamedColumnExpr):
        return expr.name in blocks.columns
    if isinstance(expr, _LitColumnExpr):
        return True
    if isinstance(expr, _BinaryOpExpr):
        return (
            expr.op in _ARITH_OPS
            and can_eval_on_device(expr.left, blocks)
            and can_eval_on_device(expr.right, blocks)
        )
    return False


def eval_expr(
    cols: Dict[str, Masked], expr: ColumnExpr, nrows: int, device: torch.device
) -> Masked:
    """The expression over ``nrows`` padded rows, with its null mask
    (``jax_backend/expr_eval.py:91`` and its recursion ``_eval`` ``:109``)."""
    if isinstance(expr, _NamedColumnExpr):
        assert_or_throw(
            expr.name in cols, ValueError(f"{expr.name} not available on device")
        )
        return cols[expr.name]
    if isinstance(expr, _LitColumnExpr):
        v = expr.value
        if v is None:
            return (
                torch.zeros((nrows,), dtype=torch.float64, device=device),
                torch.zeros((nrows,), dtype=torch.bool, device=device),
            )
        dtype = (
            torch.bool
            if isinstance(v, bool)
            else torch.int64 if isinstance(v, int) else torch.float64
        )
        return torch.full((nrows,), v, dtype=dtype, device=device), None
    if isinstance(expr, _BinaryOpExpr) and expr.op in _ARITH_OPS:
        lv, lm = eval_expr(cols, expr.left, nrows, device)
        rv, rm = eval_expr(cols, expr.right, nrows, device)
        both = _and_masks(lm, rm)
        if expr.op == "+":
            return lv + rv, both
        if expr.op == "-":
            return lv - rv, both
        if expr.op == "*":
            return lv * rv, both
        if not lv.is_floating_point() and not rv.is_floating_point():
            lv = lv.to(torch.float64)
        return torch.true_divide(lv, rv), both
    raise NotImplementedError(f"{expr} on the card (ROADMAP.md queue 2 item 8)")


def _and_masks(
    a: Optional[torch.Tensor], b: Optional[torch.Tensor]
) -> Optional[torch.Tensor]:
    if a is None:
        return b
    if b is None:
        return a
    return a & b
