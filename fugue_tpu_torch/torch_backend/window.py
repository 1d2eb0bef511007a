"""Window functions on the card: the port of ``device_window``
(``fugue_tpu/jax_backend/relational.py:1457``) with
``_window_rank_family`` (``:1524``), ``_window_frame_agg`` (``:1659``)
and ``_window_segment_agg`` (``:2094``).

``items`` (``algebra_bridge.WindowPlan.items``) mix passthrough columns
with window specs. For each spec the partition keys are factorized
(``groupby.factorize_keys``), then:

- the ranking family (row_number, rank, dense_rank, ntile, percent_rank,
  cume_dist) and every ordered function sort the rows into window order
  (``relational.presort_sorted``: the segment id above the ORDER BY keys
  in K11's words, one stable ``torch.sort`` a word; once for all the
  items of one PARTITION BY and ORDER BY) and run K15 ``window_rank`` or
  K16 ``window_frame``, which write each row's value in row order;
- a function with no ORDER BY over its whole partition is the group-by's
  ``segment_aggs`` over the partition's segments, then one K10 gather of
  each row's segment value (``v[:S][segc]``).

What the JAX functions decline (they return None, and its engine then
answers on its host runner) raises through ``refuse`` naming ROADMAP.md
queue 1 item 2(b), the host engine the port has not ported yet.
"""

from typing import Any, Callable, Dict, List, Tuple

import pyarrow as pa
import torch

from fugue_tpu_torch.kernels import kernel_for
from fugue_tpu_torch.kernels.gather import gather_rows
from fugue_tpu_torch.kernels.reference import (
    GatherColumn,
    PresortKey,
    SortedWords,
    WindowFrame,
    frame_route,
    window_frame_reference,
    window_rank_reference,
)
from fugue_tpu_torch.kernels.window import window_frame_cuda, window_rank_cuda
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend import groupby, relational
from fugue_tpu_torch.torch_backend.blocks import TorchBlocks, TorchColumn, torch_dtype

RANK_FUNCS = ("row_number", "rank", "dense_rank", "ntile", "percent_rank", "cume_dist")
GATHER_FUNCS = ("lag", "lead", "first_value", "last_value", "nth_value")
Refuse = Callable[[str], None]


def _numeric(tp: pa.DataType) -> bool:
    return pa.types.is_integer(tp) or pa.types.is_floating(tp) or pa.types.is_boolean(tp)


def device_window(blocks: TorchBlocks, schema: Schema, items: List[Tuple[str, Any]],
                  refuse: Refuse) -> Tuple[TorchBlocks, Schema]:
    """The window items over the frame's rows (``relational.py:1457``):
    the frame's rows and validity (a lazy count stays lazy) with the
    passthrough and window columns, and their schema."""
    p = blocks.padded_nrows
    out_cols: Dict[str, TorchColumn] = {}
    fields: List[pa.Field] = []
    orders: Dict[Any, SortedWords] = {}  # one window order per (PARTITION BY, ORDER BY)
    for kind, payload in items:
        if kind == "col":
            out_name, src_name = payload
            out_cols[out_name] = blocks.columns[src_name]
            fields.append(pa.field(out_name, schema[src_name].type))
            continue
        spec = payload
        if spec.partition_by:
            fr = groupby.factorize_keys(blocks, list(spec.partition_by))
            seg, num = fr.seg, max(fr.num_segments, 1)
        else:
            seg, num = torch.zeros((p,), dtype=torch.int32, device=blocks.device), 1

        def order(spec: Any = spec, seg: torch.Tensor = seg, num: int = num) -> SortedWords:
            by = (tuple(spec.partition_by), tuple(spec.order_by))
            if by not in orders:
                orders[by] = window_order(blocks, spec, seg, num)
            return orders[by]

        if spec.func in RANK_FUNCS:
            col = _window_rank_family(spec, order())
        elif spec.order_by:
            col = _window_frame_agg(blocks, spec, order, refuse)
        else:
            col = _window_segment_agg(blocks, spec, seg, num, refuse)
        out_cols[spec.name] = col
        fields.append(pa.field(spec.name, col.pa_type))
    return (TorchBlocks(blocks._nrows, out_cols, blocks.device, row_valid=blocks.row_valid,
                        nrows_dev=blocks._nrows_dev), Schema(fields))


def window_order(blocks: TorchBlocks, spec: Any, seg: torch.Tensor, num: int) -> SortedWords:
    """The frame's rows in window order: by partition (the segment id, its
    sentinel ``num`` on rows that are not real), then by the ORDER BY keys,
    each ascending or descending with its nulls (and a float's NaN) last
    unless asked first (``relational.py:1546-1553``)."""
    keys = [PresortKey(seg, kmin=0, bits=num.bit_length())]
    for name, asc, nulls_first in spec.order_by:
        keys += relational.sort_code_columns(blocks, [(name, asc)], bool(nulls_first))
    return relational.presort_sorted(keys, blocks.padded_nrows, blocks.device,
                                     **groupby.frame_rows(blocks))


def _window_rank_family(spec: Any, sw: SortedWords) -> TorchColumn:
    """``relational.py:1524``: K15 over the window order; int64, or
    float64 for percent_rank and cume_dist."""
    run = kernel_for(sw.order, window_rank_cuda, window_rank_reference, "window rank")
    out = run(sw, spec.func, int(spec.param or 0))
    tp = pa.float64() if spec.func in ("percent_rank", "cume_dist") else pa.int64()
    return TorchColumn(tp, out)


def _frame(spec: Any) -> Tuple[str, Tuple[str, float], Tuple[str, float]]:
    """The bridge's normalized frame as K16's unit and bounds: None is the
    running default frame."""
    if spec.frame is None:
        return "running", ("up", 0), ("c", 0)
    unit, sk, sn, ek, en = spec.frame
    return unit, (sk, sn or 0), (ek, en or 0)


def _window_frame_agg(blocks: TorchBlocks, spec: Any, order: Callable[[], SortedWords],
                      refuse: Refuse) -> TorchColumn:
    """``relational.py:1659``: K16 over the window order (``order()``,
    sorted once the item is known to run), with the result
    type and refusals of the JAX function (``:1680-1724``): a string
    argument only for the positional functions and with no default, a
    float default for an integer column, sum/avg of a non-numeric
    argument, min/max of a bool, a RANGE offset over a non-numeric key."""
    func = "avg" if spec.func == "mean" else spec.func
    gather_like = func in GATHER_FUNCS
    vcol = None if spec.arg is None else blocks.columns[spec.arg]
    if vcol is not None:
        if vcol.is_string and not gather_like:
            refuse(f"{func} of the string column {spec.arg} over a window")
        if vcol.is_string and spec.default is not None:
            refuse(f"{func} of the string column {spec.arg} with a default")
        if isinstance(spec.default, float) and pa.types.is_integer(vcol.pa_type):
            refuse(f"{func} of the integer column {spec.arg} with a float default")
    arg_tp = None if vcol is None else vcol.pa_type
    if func == "count":
        tp: pa.DataType = pa.int64()
    elif func in ("sum", "avg"):
        if arg_tp is None or not _numeric(arg_tp):
            refuse(f"{func} of {spec.arg} ({arg_tp}) over a window")
        tp = pa.float64() if func == "avg" or not pa.types.is_integer(arg_tp) else pa.int64()
    elif func in ("min", "max"):
        if arg_tp is None or pa.types.is_boolean(arg_tp):
            refuse(f"{func} of {spec.arg} ({arg_tp}) over a window")
        tp = arg_tp
    else:
        tp = arg_tp
    unit, lo, hi = _frame(spec)
    key = kmask = None
    key_desc = False
    if unit == "range" and (lo[0] in ("p", "f") or hi[0] in ("p", "f")):
        kname, asc, _ = spec.order_by[0]
        kcol = blocks.columns[kname]
        if kcol.is_string or not _numeric(kcol.pa_type):
            refuse(f"a RANGE offset over the key {kname} ({kcol.pa_type})")
        key, kmask, key_desc = kcol.data.to(torch.float64), kcol.mask, not asc
    values = vmask = None
    if vcol is not None:
        as_float = vcol.data.is_floating_point() or (
            func in ("sum", "avg") and vcol.data.dtype == torch.bool)
        values = vcol.data.to(torch.float64 if as_float else torch.int64).contiguous()
        vmask = None if vcol.mask is None else vcol.mask.contiguous()
    frame = WindowFrame(
        "count_star" if func == "count" and vcol is None else func, int(spec.param or 0), unit,
        lo, hi, values, vmask, spec.default, key, kmask, key_desc, frame_route(func, unit, lo, hi))
    sw = order()
    run = kernel_for(sw.order, window_frame_cuda, window_frame_reference, "window frame")
    out, mask = run(sw, frame)
    if func in ("min", "max") or gather_like:
        out = out.to(torch_dtype(tp))  # type: ignore[arg-type]
    return TorchColumn(tp, out, mask,  # type: ignore[arg-type]
                       dictionary=vcol.dictionary if gather_like and vcol is not None else None)


def _window_segment_agg(blocks: TorchBlocks, spec: Any, seg: torch.Tensor, num: int,
                        refuse: Refuse) -> TorchColumn:
    """``relational.py:2094``: count/sum/avg/min/max over the whole
    partition: ``segment_aggs`` over the partition's segments, then a K10
    gather of each row's segment value. A string argument, and sum/avg of
    a non-numeric one, are refused as the JAX function declines them."""
    func = "avg" if spec.func == "mean" else spec.func
    if spec.arg is None:
        request = groupby.AggRequest("count", None, None, "", "")
        arg_tp = None
    else:
        col = blocks.columns[spec.arg]
        if col.is_string:
            refuse(f"{func} of the string column {spec.arg} over a partition")
        mask = None if col.mask is None else col.mask.contiguous()
        request = groupby.AggRequest(func, col.data.contiguous(), mask, spec.arg,
                                     "" if mask is None else f"m:{spec.arg}")
        arg_tp = col.pa_type
    if func == "count":
        tp: pa.DataType = pa.int64()
    elif func in ("sum", "avg"):
        if arg_tp is None or not _numeric(arg_tp):
            refuse(f"{func} of {spec.arg} ({arg_tp}) over a partition")
        tp = pa.float64() if func == "avg" or not pa.types.is_integer(arg_tp) else pa.int64()
    else:
        if arg_tp is None:
            refuse(f"{func}(*) over a partition")
        tp = arg_tp
    _, [(v, m)] = groupby.segment_aggs([request], num, groupby.frame_rows(blocks), seg=seg)
    idx = seg.clamp(0, num - 1).to(torch.int32).contiguous()
    [(out, outm)] = gather_rows([GatherColumn(v.to(torch_dtype(tp)).contiguous(),  # type: ignore[arg-type]
                                              None if m is None else m.contiguous())], idx)
    return TorchColumn(tp, out, outm)  # type: ignore[arg-type]
