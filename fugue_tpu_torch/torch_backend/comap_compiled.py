"""Co-map on the card: a cotransformer runs once over whole columns of
every zipped member (port of ``fugue_tpu/jax_backend/comap_compiled.py:
77-520``).

- Every member's zip keys are stacked (``_concat_key_blocks_n``: string
  keys first re-coded into one dictionary by ``_harmonize_n``) and
  factorized once (``groupby.factorize_keys``) into one segment space
  shared by the members, then cut back into per-member views.
- K17 ``comap_presence`` marks which members have a real row in each
  segment, and K18 ``comap_rows`` applies the zip's rule (``_alive_rule``,
  ``:197``, whose twin is ``reference.comap_alive_reference``: inner,
  left_outer, right_outer, full_outer; a cross zip is one segment that is
  always alive): each row's liveness and its segment id re-pointed at the
  sentinel where its segment is dead, each segment's liveness, and the
  counts, which stay on the card. Two launches a co-map, no readback.
- The cotransformer receives one dict a member, positionally and in
  member order (``fn(*member_dicts)``), with the map ABI
  (``TorchMapEngine._compiled_map``): its columns, ``_<name>_mask``,
  ``_<name>_dict`` for a string column, ``_row_valid`` (a real row of a
  live segment), ``_nrows`` (their count, an int32 0-d device tensor),
  ``_segment_ids`` (int32, in the shared space, the sentinel
  ``_num_segments`` on other rows) and ``_num_segments`` (a Python int:
  the shared space, some of whose segments may be empty or dead). Torch's
  ``index_add_`` raises on the sentinel, so a cotransformer sums into
  ``_num_segments + 1`` buckets and drops the last one.
- The output's length decides its layout (``:419-512``): ``_num_segments``
  rows are one a segment, the alive segments kept and their count lazy;
  member 0's padded length is row-aligned with member 0; anything else
  needs an explicit ``_nrows``.

The function always runs whole-column, so one written for one group at a
time sees every group at once: the JAX package's host group loop for a
function it cannot trace has no counterpart here."""

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.kernels import kernel_for
from fugue_tpu_torch.kernels.comap import comap_presence_cuda, comap_rows_cuda
from fugue_tpu_torch.kernels.reference import (
    ComapRows,
    comap_presence_reference,
    comap_rows_reference,
)
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend import groupby, relational
from fugue_tpu_torch.torch_backend.blocks import (
    TorchBlocks,
    TorchColumn,
    is_string_type,
    pad_rows,
    padded_len,
    stored_words,
    torch_dtype,
    value_bits,
)
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from fugue_tpu_torch.utils.assertion import assert_or_throw


class HostPathRequired(Exception):
    """The co-map cannot run on the card; the message says why. The JAX
    package answers such a co-map on its host group loop; the engine
    refuses it, naming ROADMAP.md queue 1 item 2(b)."""


def _harmonize_n(cs: List[TorchColumn]) -> List[TorchColumn]:
    """N string columns in one dictionary (``:77``): a left fold of
    ``relational.harmonize_string_keys``. Each step only appends to the
    union dictionary, so earlier members' codes stay valid and adopt the
    final table."""
    out = [cs[0]]
    for c in cs[1:]:
        base, remapped = relational.harmonize_string_keys(out[0], c)
        out[0] = base
        out.append(remapped)
    union = out[0].dictionary
    stats = (0, max(len(union) - 1, 0))  # type: ignore[arg-type]
    return [TorchColumn(c.pa_type, c.data, c.mask, stats, dictionary=union) for c in out]


def _concat_key_blocks_n(blocks_list: List[TorchBlocks], keys: List[str]) -> TorchBlocks:
    """Every member's key columns stacked along the rows, member 0's
    first (``:94``): the N-way ``relational.stack_blocks``, string keys
    in one dictionary. Rows that are not real stay so, so the
    factorization sees them as non-rows."""
    columns: Dict[str, List[TorchColumn]] = {}
    for k in keys:
        cs = [b.columns[k] for b in blocks_list]
        columns[k] = _harmonize_n(cs) if cs[0].is_string else cs
    return relational.stack_blocks(blocks_list, columns)


def _membership(blocks_list: List[TorchBlocks], seg: torch.Tensor, num: int, how: str,
                valid: Optional[torch.Tensor]) -> ComapRows:
    """K17 then K18 over the stacked rows (their twins on the CPU). Where
    every member is a prefix frame the kernels read each member's row
    count, else the stacked validity ``valid``."""
    device = seg.device
    ps = [b.padded_nrows for b in blocks_list]
    prefix = all(b.row_valid is None for b in blocks_list)
    nrows = [b.nrows for b in blocks_list] if prefix else ps
    layout = torch.tensor(np.concatenate([[0], np.cumsum(ps), nrows]), dtype=torch.int64,
                          device=device)
    offsets, counts = layout[: len(ps) + 1], layout[len(ps) + 1:]
    rows = None if prefix else valid
    presence = None
    if how != "cross":
        run = kernel_for(seg, comap_presence_cuda, comap_presence_reference, "comap presence")
        presence = run(seg, num, offsets, counts, valid=rows)
    run = kernel_for(seg, comap_rows_cuda, comap_rows_reference, "comap rows")
    return run(seg, presence, num, offsets, counts, how, valid=rows)


def _member_dicts(blocks_list: List[TorchBlocks], m: ComapRows, num: int) -> List[Dict[str, Any]]:
    """Each member's dict of the cotransformer ABI, over views of K18's
    outputs."""
    dicts: List[Dict[str, Any]] = []
    off = 0
    for i, b in enumerate(blocks_list):
        p = b.padded_nrows
        d: Dict[str, Any] = {}
        for name, c in b.columns.items():
            d[name] = value_bits(c.data, c.pa_type)  # as the map path gives it
            if c.mask is not None:
                d[f"_{name}_mask"] = c.mask
            if c.is_string:
                d[f"_{name}_dict"] = c.dictionary
        d["_row_valid"] = m.row_alive[off: off + p]
        d["_nrows"] = m.counts[i]
        d["_segment_ids"] = m.seg_out[off: off + p]
        d["_num_segments"] = num
        dicts.append(d)
        off += p
    return dicts


def compiled_comap(
    engine: Any,
    zdf: Any,
    fn: Callable[..., Dict[str, torch.Tensor]],
    output_schema: Any,
    partition_spec: PartitionSpec,
    on_init: Optional[Callable[[int, Any], Any]],
) -> TorchDataFrame:
    """Run ``fn`` once over the shared segment space of the zip ``zdf``
    (``:216``), or raise ``HostPathRequired`` with the reason: a presort,
    the ambiguous length (``num_segments`` equal to member 0's padded
    rows: on one device there is no padding, so whenever member 0's row
    count equals the segment space, such as a dimension table with one row
    a key of a dense range, zipped first; the JAX engine on one device
    takes its host loop there too), or a string output without a
    ``_<name>_dict``. ``on_init(0, frames)`` runs once, with the members'
    empty frames, after the checks that come before the function runs."""
    out_schema = Schema(output_schema)
    how = zdf.how
    keys = list(zdf.keys)
    if zdf.zip_spec.presort or partition_spec.presort:
        # a presort orders rows within a group; one whole-column call has
        # no per-group row order
        raise HostPathRequired("a comap presort (it needs host grouping)")
    blocks_list = [f.blocks for f in zdf.frames]
    ps = [b.padded_nrows for b in blocks_list]
    device = blocks_list[0].device
    if how == "cross":
        num = 1
        seg = torch.zeros((sum(ps),), dtype=torch.int32, device=device)
        valid = torch.cat([b.validity() for b in blocks_list])
    else:
        combined = _concat_key_blocks_n(blocks_list, keys)
        fr = groupby.factorize_keys(combined, keys)
        num = max(fr.num_segments, 1)
        seg = fr.seg
        valid = combined.row_valid
    if num == ps[0]:
        # the output's length is the only sign of its layout: one a segment
        # or one a row of member 0 cannot be told apart
        raise HostPathRequired(
            f"a comap whose segment space equals member 0's rows ({num}): the output "
            "length is ambiguous")
    membership = _membership(blocks_list, seg, num, how, valid)
    if on_init is not None:
        on_init(0, _empty_frames(engine, zdf))
    out = fn(*_member_dicts(blocks_list, membership, num))
    assert_or_throw(isinstance(out, dict),
                    ValueError("torch cotransformer must return a dict of tensors"))
    for f in out_schema.fields:
        if is_string_type(f.type) and f"_{f.name}_dict" not in out:
            raise HostPathRequired(f"string output {f.name!r} with no '_{f.name}_dict'")
    return _output(out, out_schema, membership, num, ps[0], device)


def _output(out: Dict[str, Any], out_schema: Schema, m: ComapRows, num: int, p0: int,
            device: torch.device) -> TorchDataFrame:
    """The cotransformer's output as a frame, laid out by its length
    (``:419-512``)."""
    first = -1
    for f in out_schema.fields:
        assert_or_throw(f.name in out,
                        ValueError(f"torch cotransformer output missing column {f.name}"))
        n = int(out[f.name].shape[0])
        first = n if first < 0 else first
        assert_or_throw(n == first,
                        ValueError("torch cotransformer output columns differ in length"))
    row_valid: Optional[torch.Tensor] = None
    nrows: Optional[int] = None
    nrows_dev: Optional[torch.Tensor] = None
    if "_nrows" in out:
        nrows = int(out["_nrows"])  # an explicit count: one readback
        # an over-reporting count would make padding rows real
        assert_or_throw(0 <= nrows <= first, ValueError(
            f"torch cotransformer reported _nrows={nrows} outside [0, {first}] "
            "(its output column length)"))
        target = max(padded_len(nrows), padded_len(first))
    elif first == num:
        # one row a segment: the alive segments are the rows, count lazy
        target, row_valid, nrows_dev = num, m.alive, m.alive_count
    elif first == p0:
        # row-aligned with member 0, whose dead segments' rows drop out
        target, row_valid, nrows_dev = p0, m.row_alive[:p0], m.counts[0]
    else:
        raise ValueError(
            f"torch cotransformer output length must be _num_segments ({num}), member 0's "
            f"padded length ({p0}), or come with an explicit '_nrows' (got {first})")
    cols: Dict[str, TorchColumn] = {}
    for f in out_schema.fields:
        data = stored_words(out[f.name].to(device=device, dtype=torch_dtype(f.type)), f.type)
        mask = out.get(f"_{f.name}_mask")
        dictionary = None
        if is_string_type(f.type):
            dictionary = np.asarray(out[f"_{f.name}_dict"], dtype=object)
        cols[f.name] = TorchColumn(
            f.type, pad_rows(data, target),
            None if mask is None else pad_rows(mask.to(device=device, dtype=torch.bool), target),
            None if dictionary is None else (0, max(len(dictionary) - 1, 0)),
            dictionary=dictionary)
    return TorchDataFrame(
        TorchBlocks(nrows, cols, device, row_valid=row_valid, nrows_dev=nrows_dev), out_schema)


def _empty_frames(engine: Any, zdf: Any) -> Any:
    """The members' empty frames, by name where the zip named them
    (``:515``; the port has no ``DataFrames``)."""
    frames = [engine.to_df(pa.Table.from_pylist([], f.schema.pa_schema)) for f in zdf.frames]
    if any(n != "" for n in zdf.names):
        return dict(zip(zdf.names, frames))
    return frames


def zip_keys(members: List[Any], how: str, spec: PartitionSpec) -> Tuple[List[str], Schema]:
    """The zip's keys and their schema (``execution_engine.py:1639-1663``):
    the spec's, else the columns every member has; none for a cross zip."""
    keys: List[str] = list(spec.partition_by)
    if not keys and how != "cross":
        keys = [n for n in members[0].schema.names if all(n in m.schema for m in members)]
        assert_or_throw(len(keys) > 0, ValueError("no common keys to zip by"))
    if how == "cross":
        assert_or_throw(len(keys) == 0, ValueError("cross zip can't have keys"))
    return keys, Schema([members[0].schema[k] for k in keys])
