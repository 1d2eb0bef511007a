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
where those differ from the JAX package's computed types).

String columns take part through their dictionaries, as in the JAX
package: LIKE, the compares (``=``, ``<>``, ``<``, ``<=``, ``>``,
``>=``, IN as OR, a column against a literal or another column), LENGTH,
NULLIF and the dictionary transforms (UPPER, LOWER, the trims, REVERSE,
SUBSTRING, REPLACE, CONCAT) compile into the same program as the numeric
operations, as table gathers by code (``torch_backend/strings.py``
builds the tables on the host). A string result comes back as int32
codes and its dictionary, re-coded onto its distinct entries where the
transformed dictionary holds one twice. What the JAX package answers on
its host engine (string CASE branches, COALESCE of strings, a cast of a
string, a table over the caps) raises ``NotImplementedError`` naming
ROADMAP.md queue 1 item 2(b).
"""

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fugue_tpu_torch.column.expressions import ColumnExpr, _NamedColumnExpr
from fugue_tpu_torch.kernels.expr_program import (
    Program,
    ProgramCache,
    Refused,
    compile_program,
    expr_program_cuda,
    remap_program,
)
from fugue_tpu_torch.kernels.reference import expr_program_reference
from fugue_tpu_torch.torch_backend.blocks import TorchBlocks

# a masked value: (values, mask) — mask None means all-valid
Masked = Tuple[torch.Tensor, Optional[torch.Tensor]]

__all__ = [
    "Evaluated", "Masked", "ProgramCache", "Refused", "can_eval_on_device", "check",
    "eval_exprs", "evaluate", "filter_rows", "is_bare", "is_string_result", "remap_codes",
    "run_program",
]


class Evaluated(NamedTuple):
    """An expression's values over the padded rows, its null mask (None:
    every row valid) and, for a string, the dictionary its codes index."""

    values: torch.Tensor
    mask: Optional[torch.Tensor]
    dictionary: Optional[np.ndarray]


def _columns(blocks: TorchBlocks) -> Dict[str, Tuple[torch.dtype, bool]]:
    return {name: (c.data.dtype, c.mask is not None) for name, c in blocks.columns.items()}


def _dicts(blocks: TorchBlocks) -> Dict[str, np.ndarray]:
    """The decode tables of the frame's string columns."""
    return {name: c.dictionary for name, c in blocks.columns.items() if c.is_string}


def _compile(expr: ColumnExpr, blocks: TorchBlocks, out_dtype: Optional[torch.dtype],
             programs: Optional[ProgramCache]) -> Program:
    """``expr`` alone compiled over ``blocks``, through ``programs`` where
    given (a filter then finds its check's program compiled)."""
    if programs is None:
        return compile_program([expr], [out_dtype], _columns(blocks), _dicts(blocks))
    return programs.get([expr], [out_dtype], _columns(blocks), _dicts(blocks), blocks.device)


def check(expr: ColumnExpr, blocks: TorchBlocks, out_dtype: Optional[torch.dtype] = None,
          programs: Optional[ProgramCache] = None) -> None:
    """Raises ``Refused`` (a ``NotImplementedError`` naming the ROADMAP.md
    item) where the card does not evaluate ``expr`` over ``blocks`` (as
    ``out_dtype`` where given: bool for a filter's condition), and
    ``ValueError`` where it names a column the frame lacks
    (``jax_backend/expr_eval.py:766``, ``_check``). The program is kept in
    ``programs`` where given."""
    if is_bare(expr) and out_dtype is None:
        if expr.name not in blocks.columns:
            raise ValueError(f"{expr.name} not available on device")
        return
    _compile(expr, blocks, out_dtype, programs)


def is_string_result(expr: ColumnExpr, blocks: TorchBlocks,
                     programs: Optional[ProgramCache] = None) -> bool:
    """Whether ``expr`` evaluates to a string (``:801``); False where the
    card does not evaluate it."""
    if is_bare(expr):
        col = blocks.columns.get(expr.name)
        return col is not None and col.is_string
    try:
        prog = _compile(expr, blocks, None, programs)
    except (NotImplementedError, ValueError):
        return False
    return prog.dicts[0] is not None


def can_eval_on_device(expr: ColumnExpr, blocks: TorchBlocks) -> bool:
    """Whether ``evaluate`` takes the whole tree (``:632``)."""
    try:
        check(expr, blocks)
    except (NotImplementedError, ValueError):
        return False
    return True


def is_bare(expr: ColumnExpr) -> bool:
    """A plain column reference: it passes through, mask and stats kept."""
    return isinstance(expr, _NamedColumnExpr) and not expr.wildcard and expr.as_type is None


def _run(program: Program, inputs: List[Masked], n: int, device: torch.device, **kw) -> object:
    """K6 on the card, its twin on the CPU (no fallback between them)."""
    if device.type == "cuda":
        return expr_program_cuda(program, inputs, n, device=device, **kw)
    if device.type != "cpu":
        raise NotImplementedError(f"expression programs on {device}")
    return expr_program_reference(program, inputs, n, device=device, **kw)


def run_program(program: Program, blocks: TorchBlocks, **kw) -> object:
    """``program`` over the frame's padded rows. ``kw``: the filter
    epilogue's ``filter``, ``nrows`` and ``row_valid``."""
    inputs = []
    for name, _ in program.inputs:
        c = blocks.columns[name]
        # the kernel reads dense columns; a transformer may return views
        inputs.append((c.data.contiguous(), None if c.mask is None else c.mask.contiguous()))
    return _run(program, inputs, blocks.padded_nrows, blocks.device, **kw)


def remap_codes(codes: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """``table[codes]`` (int32, an index clamped into the table) in one K6
    launch of a single LUT: a join key's codes re-coded into another
    dictionary (``harmonize_string_keys``)."""
    prog = remap_program(torch.from_numpy(table).to(codes.device))
    (values, _), = _run(prog, [(codes.contiguous(), None)], int(codes.shape[0]),
                        codes.device)  # type: ignore[misc]
    return values


def evaluate(
    blocks: TorchBlocks,
    exprs: Sequence[ColumnExpr],
    out_dtypes: Sequence[Optional[torch.dtype]],
    programs: ProgramCache,
) -> List[Evaluated]:
    """Every expression over the frame's padded rows, each in its
    ``out_dtypes`` entry (None: the type it computes in; a string is int32
    codes), with its null mask and dictionary: the bare column references
    as they are, the rest in ONE program and one launch (``_assign_prog``
    ``execution_engine.py:1446``, ``_project_prog`` ``:2242``)."""
    out: List[Optional[Evaluated]] = [None] * len(exprs)
    todo: List[int] = []
    for i, (e, dt) in enumerate(zip(exprs, out_dtypes)):
        if is_bare(e) and e.name in blocks.columns and dt in (None, blocks.columns[e.name].data.dtype):
            c = blocks.columns[e.name]
            out[i] = Evaluated(c.data, c.mask, c.dictionary)
        else:
            todo.append(i)
    if todo:
        prog = programs.get([exprs[i] for i in todo], [out_dtypes[i] for i in todo],
                            _columns(blocks), _dicts(blocks), blocks.device)
        results = run_program(prog, blocks)
        for i, (v, m), d in zip(todo, results, prog.dicts):  # type: ignore[arg-type]
            out[i] = Evaluated(v, m, d)
    return out  # type: ignore[return-value]


def eval_exprs(
    blocks: TorchBlocks,
    exprs: Sequence[ColumnExpr],
    out_dtypes: Sequence[Optional[torch.dtype]],
    programs: ProgramCache,
) -> List[Masked]:
    """``evaluate``'s values and masks."""
    return [(r.values, r.mask) for r in evaluate(blocks, exprs, out_dtypes, programs)]


def filter_rows(
    blocks: TorchBlocks, condition: ColumnExpr, programs: ProgramCache
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows that stay: the condition's value AND its validity AND the
    row's, with their count as an int32 0-d device tensor read back by no
    one here (``_filter_prog``, ``execution_engine.py:1387``). One launch."""
    prog = programs.get([condition], [torch.bool], _columns(blocks), _dicts(blocks),
                        blocks.device)
    if blocks.row_valid is not None:
        rows = {"row_valid": blocks.row_valid.contiguous()}
    else:
        rows = {"nrows": blocks.nrows}
    return run_program(prog, blocks, filter=True, **rows)  # type: ignore[return-value]

