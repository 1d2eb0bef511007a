"""Column-expression evaluation on the card: masked tensors, null
propagation and Kleene logic, through the K6 expression program.

A port of ``fugue_tpu/jax_backend/expr_eval.py``'s numeric part: named
columns, literals, unary ``-``, NOT, IS [NOT] NULL, ``+ - * /``,
comparisons, AND/OR, COALESCE, CASE WHEN, IF/IIF, NULLIF, ``mod``,
``power``, ``round``, ``abs``, ``floor``, ``ceil``, ``sign``, ``sqrt``,
``exp``, the logarithms, ``sin``/``cos``/``tan`` and casts
(``_eval`` ``:109``, ``_binary`` ``:512``, ``_cast`` ``:552``). Every
expression of one call is compiled into one program
(``kernels/expr_program.py``) and evaluated in one launch of K6 on the
card, or by its twin on the CPU; a bare column passes through with no
launch. Values compute in the declared types (``expr_program.py`` says
where those differ from the JAX package's computed types). String
literals, string functions and string columns raise
``NotImplementedError`` naming ROADMAP.md queue 1 item 1; what the JAX
package answers on its host engine names queue 1 item 2(b).
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from fugue_tpu_torch.column.expressions import ColumnExpr, _NamedColumnExpr
from fugue_tpu_torch.kernels.expr_program import (
    Program,
    ProgramCache,
    Refused,
    compile_program,
    expr_program_cuda,
)
from fugue_tpu_torch.kernels.reference import expr_program_reference
from fugue_tpu_torch.torch_backend.blocks import TorchBlocks

# a masked value: (values, mask) — mask None means all-valid
Masked = Tuple[torch.Tensor, Optional[torch.Tensor]]

__all__ = [
    "Masked", "ProgramCache", "Refused", "can_eval_on_device", "check",
    "eval_exprs", "filter_rows", "is_bare", "run_program",
]


def _columns(blocks: TorchBlocks) -> Dict[str, Tuple[torch.dtype, bool]]:
    return {name: (c.data.dtype, c.mask is not None) for name, c in blocks.columns.items()}


def check(expr: ColumnExpr, blocks: TorchBlocks) -> None:
    """Raises ``Refused`` (a ``NotImplementedError`` naming the ROADMAP.md
    item) where the card does not evaluate ``expr`` over ``blocks``, and
    ``ValueError`` where it names a column the frame lacks
    (``jax_backend/expr_eval.py:766``, ``_check``)."""
    if is_bare(expr):
        if expr.name not in blocks.columns:
            raise ValueError(f"{expr.name} not available on device")
        return
    compile_program([expr], [None], _columns(blocks))


def can_eval_on_device(expr: ColumnExpr, blocks: TorchBlocks) -> bool:
    """Whether ``eval_exprs`` takes the whole tree (``:632``)."""
    try:
        check(expr, blocks)
    except (NotImplementedError, ValueError):
        return False
    return True


def is_bare(expr: ColumnExpr) -> bool:
    """A plain column reference: it passes through, mask and stats kept."""
    return isinstance(expr, _NamedColumnExpr) and not expr.wildcard and expr.as_type is None


def run_program(program: Program, blocks: TorchBlocks, **kw) -> object:
    """``program`` over the frame's padded rows: K6 on the card, its twin
    on the CPU (no fallback between them). ``kw``: the filter epilogue's
    ``filter``, ``nrows`` and ``row_valid``."""
    inputs = []
    for name, _ in program.inputs:
        c = blocks.columns[name]
        # the kernel reads dense columns; a transformer may return views
        inputs.append((c.data.contiguous(), None if c.mask is None else c.mask.contiguous()))
    n, device = blocks.padded_nrows, blocks.device
    if device.type == "cuda":
        return expr_program_cuda(program, inputs, n, device=device, **kw)
    if device.type != "cpu":
        raise NotImplementedError(f"expression programs on {device}")
    return expr_program_reference(program, inputs, n, device=device, **kw)


def eval_exprs(
    blocks: TorchBlocks,
    exprs: Sequence[ColumnExpr],
    out_dtypes: Sequence[Optional[torch.dtype]],
    programs: ProgramCache,
) -> List[Masked]:
    """Every expression over the frame's padded rows, each in its
    ``out_dtypes`` entry (None: the type it computes in), with its null
    mask: the bare column references as they are, the rest in ONE program
    and one launch (``_assign_prog`` ``execution_engine.py:1446``,
    ``_project_prog`` ``:2242``)."""
    out: List[Optional[Masked]] = [None] * len(exprs)
    todo: List[int] = []
    for i, (e, dt) in enumerate(zip(exprs, out_dtypes)):
        if is_bare(e) and e.name in blocks.columns and dt in (None, blocks.columns[e.name].data.dtype):
            c = blocks.columns[e.name]
            out[i] = (c.data, c.mask)
        else:
            todo.append(i)
    if todo:
        prog = programs.get([exprs[i] for i in todo], [out_dtypes[i] for i in todo],
                            _columns(blocks))
        for i, res in zip(todo, run_program(prog, blocks)):  # type: ignore[arg-type]
            out[i] = res
    return out  # type: ignore[return-value]


def filter_rows(
    blocks: TorchBlocks, condition: ColumnExpr, programs: ProgramCache
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows that stay: the condition's value AND its validity AND the
    row's, with their count as an int32 0-d device tensor read back by no
    one here (``_filter_prog``, ``execution_engine.py:1387``). One launch."""
    prog = programs.get([condition], [torch.bool], _columns(blocks))
    if blocks.row_valid is not None:
        rows = {"row_valid": blocks.row_valid.contiguous()}
    else:
        rows = {"nrows": blocks.nrows}
    return run_program(prog, blocks, filter=True, **rows)  # type: ignore[return-value]

