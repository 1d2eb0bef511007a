"""Group-by on the card: key factorization and the per-segment
reductions.

The port of ``fugue_tpu/jax_backend/groupby.py``. Two factorizations, as
there:

- **Static binning** (``bin_spec``): when every key is integer-like with
  host-known bounds, segment ids are a mixed-radix combination of
  ``key - min``, and the segment count is the static bin count, so no
  output shape needs a readback. The aggregate computes the ids inside
  the fused kernel (``kernels/segment_sums.cu``) with the row validity
  and the sums; ``factorize_keys`` writes them out with the first row and
  occupancy of each bin (kernel K1 of ``kernels/factorize.cu``). Empty
  bins are dropped lazily through an occupancy mask.
- **Sort** (``factorize_keys`` for float keys, int64 keys over more than
  ``_MAX_BINS`` bins and the like), with one readback of the group count.
  Keys whose codes fit one 64-bit word take the *word route*: kernel KW
  packs them into one order-preserving int32/int64 word a row, one stable
  ``torch.sort`` orders it, K2w finds the group boundaries over the sorted
  words and K3w gives each row its id by a search of its own word among
  the groups' words (above ``lookup_limit`` groups, K3 scatters the
  sorted ids instead). Wider keys take the *wide route*: one stable sort
  per key code, K2 (boundaries over the codes gathered at the order) and
  K3 (the scatter back to row order).

Over the segment ids, ``segment_aggs`` computes every aggregation of a
plan (``_segment_agg_impl``): sums and counts in the fused kernel, min,
max and each segment's last row in K4 (``kernels/segment_reduce.cu``),
the variance's second pass in K5, the median by one sort of a
(segment, value) word.

The JAX package's other segment-sum strategies (one-hot matmul, bf16
matmul, sorted scatter) were built for the TPU's matrix unit and are not
carried over. Every kernel has its plain twin in ``kernels/reference.py``,
which runs where the tensors lie on the CPU; there is no fallback from the
card to a twin.
"""

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import pyarrow as pa
import torch

from fugue_tpu_torch.column.expressions import VARIANCE_FUNCS
from fugue_tpu_torch.kernels import kernel_for
from fugue_tpu_torch.kernels.factorize import (
    bin_factorize_cuda,
    sort_boundaries_cuda,
    sort_finish_cuda,
    sort_word_boundaries_cuda,
    sort_word_cuda,
    sort_word_lookup_cuda,
)
from fugue_tpu_torch.kernels.reference import (
    MAX_KEYS,
    BinKey,
    Extrema,
    Extremum,
    Payload,
    SortWord,
    bin_factorize_reference,
    bin_segments,
    binned_sums_reference,
    float_sum_dtype,
    has_unreal_rows,
    segment_extrema_reference,
    segment_sq_dev_reference,
    sort_factorize_reference,
    sort_finish_reference,
    sort_word_boundaries_reference,
    sort_word_lookup_reference,
    sort_word_reference,
    word_bits,
)
from fugue_tpu_torch.kernels.segment_reduce import segment_extrema_cuda, segment_sq_dev_cuda
from fugue_tpu_torch.kernels.segment_sums import binned_sums_cuda
from fugue_tpu_torch.torch_backend.blocks import (
    TorchBlocks,
    key_data,
    value_bits,
    value_float64,
)

_MAX_BINS = 1 << 22  # static-binning cap (``groupby.py:451``)
# K3's route on the word route, by the group count and the word's width:
# up to lookup_limit(width) groups K3w searches each row's word among the
# groups' words (in shared memory while they fit in 227 KB, else in global
# memory through L2); above it, K3 stores K2w's sorted ids to row order
# through its slabs (order_scatter.cuh). On an NVIDIA H100 80GB HBM3 at
# 700 W at 100M rows (``chip_smoke.k3_routes``; PERF.md, PR 14) the
# lookup over int32 words takes 0.38 ms at 1024 groups, 0.97 at 2^14, 1.56
# at 2^15 (its table's last size in shared memory), 3.88 at 2^16, 6.44 at
# 2^19 and 31.6 at 10^8; over int64 words 0.75 at 1024, 1.35 at 2^12, 1.66
# at 2^13, 2.58 at 2^14 and 3.73 at 2^15; K3 takes 1.86-2.05 ms at every
# count. So the lookup stays up to 2^15 int32 words and 2^13 int64 words.
LOOKUP_MAX_GROUPS = 1 << 15
LOOKUP_MAX_GROUPS_WIDE = 1 << 13  # int64 words: half as many fit in shared memory


def lookup_limit(word_bytes: int) -> int:
    """The most groups K3w takes for words of ``word_bytes`` (4 or 8)."""
    return LOOKUP_MAX_GROUPS if word_bytes == 4 else min(LOOKUP_MAX_GROUPS,
                                                         LOOKUP_MAX_GROUPS_WIDE)


class BinSpec(NamedTuple):
    """Static mixed-radix key binning (``groupby.py:53``): enough to
    compute segment ids and to decode key values from bin indices."""

    names: Tuple[str, ...]
    mins: Tuple[int, ...]
    spans: Tuple[int, ...]  # includes the +1 null bucket where masked
    masked: Tuple[bool, ...]
    total: int


def bin_spec(blocks: TorchBlocks, keys: List[str]) -> Optional[BinSpec]:
    """BinSpec for ``keys`` when all are integer-like with bounds (ingest
    stats, else ONE device min/max readback, cached on the columns); None
    for float keys or more than ``_MAX_BINS`` bins (``groupby.py:64``)."""
    missing: List[str] = []
    for k in keys:
        col = blocks.columns[k]
        if col.data.is_floating_point():
            return None
        if col.stats is None:
            missing.append(k)
    if missing:
        _fill_stats_from_device(blocks, missing)
    spans: List[int] = []
    mins: List[int] = []
    masked: List[bool] = []
    total = 1
    for k in keys:
        col = blocks.columns[k]
        lo, hi = col.stats  # type: ignore[misc]
        span = int(hi) - int(lo) + 1
        if span <= 0 or span > _MAX_BINS:
            return None
        if col.mask is not None:
            span += 1  # null bucket
        spans.append(span)
        mins.append(int(lo))
        masked.append(col.mask is not None)
        total *= span
        if total > _MAX_BINS:
            return None
    return BinSpec(tuple(keys), tuple(mins), tuple(spans), tuple(masked), total)


def _fill_stats_from_device(blocks: TorchBlocks, names: List[str]) -> None:
    """Missing int-key bounds from ``torch.aminmax`` over each column, with
    one readback for all of them (``groupby.py:109``)."""
    datas = [blocks.columns[k].data for k in names]
    bounds = torch.stack(
        [
            torch.stack(
                torch.aminmax(d.to(torch.int32) if d.dtype == torch.bool else d)
            ).to(torch.int64)
            for d in datas
        ]
    ).cpu()
    for k, b in zip(names, bounds.tolist()):
        blocks.columns[k].stats = (int(b[0]), int(b[1]))


def bin_keys(
    spec: BinSpec,
    key_data: Dict[str, torch.Tensor],
    key_masks: Dict[str, Optional[torch.Tensor]],
) -> List[BinKey]:
    """The key columns of ``spec`` as the fused kernel takes them: dense
    (a transformer may return views)."""
    return [
        BinKey(
            key_data[name].contiguous(),
            key_masks[name].contiguous() if has_mask else None,  # type: ignore[union-attr]
            kmin,
            span,
        )
        for name, kmin, span, has_mask in zip(
            spec.names, spec.mins, spec.spans, spec.masked
        )
    ]


def kernel_keys(spec: BinSpec, blocks: TorchBlocks) -> List[BinKey]:
    """The keys of ``spec`` as a binned kernel reads them. More keys than
    the kernels read (``MAX_KEYS``) become one: their segment ids, with
    the sentinel ``spec.total`` on rows that are not real, so the kernel
    drops those rows however it is told the frame's rows."""
    key_data = {k: blocks.columns[k].data for k in spec.names}
    key_masks = {k: blocks.columns[k].mask for k in spec.names}
    bkeys = bin_keys(spec, key_data, key_masks)
    if len(bkeys) <= MAX_KEYS:
        return bkeys
    seg = inline_seg(spec, key_data, key_masks, blocks.validity())
    return [BinKey(seg, None, 0, spec.total)]


def inline_seg(
    spec: BinSpec,
    key_data: Dict[str, torch.Tensor],
    key_masks: Dict[str, Optional[torch.Tensor]],
    valid_rows: torch.Tensor,
) -> torch.Tensor:
    """Mixed-radix segment id per row (``groupby.py:120``); invalid rows get
    the out-of-range sentinel ``spec.total``."""
    return bin_segments(bin_keys(spec, key_data, key_masks), valid_rows)


def decode_bin_keys(
    spec: BinSpec, dtypes: Dict[str, torch.dtype], device: torch.device
) -> Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """Key ``(values, mask)`` per bin index (``groupby.py:141``): arithmetic
    over ``arange(total)``, no representative-row gather."""
    b = torch.arange(spec.total, dtype=torch.int64, device=device)
    out: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}
    stride = spec.total
    for name, kmin, span, has_mask in zip(
        spec.names, spec.mins, spec.spans, spec.masked
    ):
        stride //= span
        code = (b // stride) % span
        mask: Optional[torch.Tensor] = None
        if has_mask:
            mask = code != span - 1
            code = torch.where(mask, code, 0)
        out[name] = ((code + kmin).to(dtypes[name]), mask)
    return out


def binned_sums(
    keys: Sequence[BinKey],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    floats: Sequence[Payload] = (),
    counts: Sequence[torch.Tensor] = (),
    ints: Sequence[Payload] = (),
    occupancy: bool = True,
    f64: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Segment ids, row validity and every sum-type reduction of an
    aggregate in one pass, with the contract of
    ``kernels.reference.binned_sums_reference``. CUDA keys go to the fused
    kernel, CPU keys to its plain twin; there is no fallback between
    them."""
    run = kernel_for(keys[0].data, binned_sums_cuda, binned_sums_reference, "binned sums")
    return run(keys, nrows=nrows, row_valid=row_valid, floats=floats, counts=counts,
               ints=ints, occupancy=occupancy, f64=f64)


def segment_sums(
    float_payloads: List[torch.Tensor],
    count_payloads: List[torch.Tensor],
    seg: torch.Tensor,
    num_segments: int,
    int_payloads: Optional[List[torch.Tensor]] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """Per-segment sums over precomputed segment ids (``groupby.py:219``):
    ``binned_sums`` with ``seg`` as its one key. ``float_payloads`` sum in
    the widest float dtype present (float32 when all are float32);
    ``count_payloads`` (bool/0-1) sum exactly in int32; ``int_payloads``
    sum exactly in int64. Rows with ``seg < 0`` or ``seg >= num_segments``
    contribute nothing."""
    f, c, i = binned_sums(
        [BinKey(seg, None, 0, num_segments)],
        nrows=int(seg.shape[0]),
        floats=[(p, None) for p in float_payloads],
        counts=count_payloads,
        ints=[(p, None) for p in int_payloads or []],
        occupancy=False,
    )
    return list(f), list(c), list(i)


def frame_rows(blocks: TorchBlocks) -> Dict[str, Any]:
    """A frame's rows as the kernels take them (``groupby.py:472``): a
    prefix frame's ``nrows``, or a masked frame's ``row_valid``."""
    if blocks.row_valid is None:
        return {"nrows": blocks.nrows}
    return {"row_valid": blocks.row_valid}


class Factorized(NamedTuple):
    """Key factorization over a frame's padded rows (``groupby.py:415``).

    - ``seg``: int32 segment id per padded row; rows that are not real
      carry the out-of-range sentinel ``num_segments``.
    - ``num_segments``: the segment-id space, a Python int: the bin count
      on the binned path (some bins may be empty), the exact group count
      on the sort path.
    - ``first_idx``: int32[num_segments], the first real row of each
      segment; ``padded_nrows - 1`` where a bin is empty.
    - ``occupied``: bool[num_segments] marking non-empty bins, or None on
      the sort path, where every segment is occupied.
    - ``num_groups_dev``: the group count as an int32 0-d device tensor.
    """

    seg: torch.Tensor
    num_segments: int
    first_idx: torch.Tensor
    occupied: Optional[torch.Tensor]
    num_groups_dev: torch.Tensor


def factorize_keys(blocks: TorchBlocks, keys: List[str]) -> Factorized:
    """Factorize ``keys`` into segment ids (``groupby.py:437``). Null keys
    form their own groups (SQL GROUP BY). The result is cached on the
    frame, so a transform and an aggregate by the same keys of one frame
    factorize once."""
    cache_key = tuple(keys)
    res = blocks.factorize_cache.get(cache_key)
    if res is None:
        res = _try_bin_factorize(blocks, keys)
        if res is None:
            res = _sort_factorize(blocks, keys)
        blocks.factorize_cache[cache_key] = res
    return res


def _try_bin_factorize(blocks: TorchBlocks, keys: List[str]) -> Optional[Factorized]:
    """The sort-free path for keys with a bin spec (``groupby.py:452``):
    one launch of K1, no readback."""
    spec = bin_spec(blocks, keys)
    if spec is None:
        return None
    seg, first_idx, occupied, count = bin_factorize(
        kernel_keys(spec, blocks), **frame_rows(blocks)
    )
    return Factorized(seg, spec.total, first_idx, occupied, count)


def bin_factorize(
    keys: Sequence[BinKey],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on CUDA keys, its twin ``bin_factorize_reference`` on CPU keys."""
    run = kernel_for(keys[0].data, bin_factorize_cuda, bin_factorize_reference,
                  "bin factorization")
    return run(keys, nrows=nrows, row_valid=row_valid)


def sort_codes(
    keys: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]
) -> List[torch.Tensor]:
    """The sort codes of ``keys`` (each its values and null mask, True =
    valid), most significant first, exactly as the
    JAX package builds them (``groupby.py:507-546``), so group ids and
    group order match it: bool and narrow integers as int32; a float key
    canonical (-0.0 as +0.0, NaN as 0) behind an int32 NaN flag; an int64
    key as its two int32 words, low word first (``bitcast_convert_type``'s
    order); a nullable key behind an int32 null flag, with its codes
    zeroed where it is null."""
    codes: List[torch.Tensor] = []
    for v, mask in keys:
        if v.is_floating_point():
            isnan = torch.isnan(v)
            v = torch.where((v == 0) | isnan, torch.zeros_like(v), v)
            pair = [isnan.to(torch.int32), v]
        elif v.dtype == torch.int64:
            words = v.view(torch.int32).view(-1, 2)
            pair = [words[:, 0], words[:, 1]]
        else:
            pair = [v.to(torch.int32)]
        if mask is not None:
            codes.append((~mask).to(torch.int32))
            pair = [torch.where(mask, p, torch.zeros_like(p)) for p in pair]
        codes.extend(pair)
    return codes


def lex_sort(
    codes: Sequence[torch.Tensor],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(order, first_sorted)``: the rows in the lexicographic order of
    ``codes``, real rows first: one stable ``torch.sort`` per code, least
    significant first, then one on validity (``groupby.py:562-568``).
    int64, as ``torch.sort`` gives it. A prefix frame with no padding
    skips the validity sort, which would keep the order as it is; then the
    last sort's values are ``codes[0][order]`` and come back as
    ``first_sorted`` (K2 reads them in place of that code's gather), else
    it is None. Only that last sort's values are kept."""
    prefix = row_valid is None and (nrows is None or nrows >= int(codes[0].shape[0]))
    order: Optional[torch.Tensor] = None
    first_sorted = None
    for j in range(len(codes) - 1, -1, -1):
        c = codes[j] if order is None else codes[j][order]
        if j == 0 and prefix:
            first_sorted, idx = torch.sort(c, stable=True)
        else:
            idx = torch.sort(c, stable=True).indices
        del c
        order = idx if order is None else order[idx]
        del idx  # not held through the next sort
    assert order is not None
    if prefix:
        return order, first_sorted
    if row_valid is not None:
        unreal = (row_valid[order] == 0).to(torch.uint8)
    else:
        unreal = (order >= nrows).to(torch.uint8)
    return order[torch.sort(unreal, stable=True).indices], None


def sort_word(
    keys: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Optional[SortWord]:
    """The keys (each its values and null mask) packed into one
    order-preserving sort word per row (``reference.sort_word_reference``
    has the layout): a signed sort of it orders the rows as the
    lexicographic sort of ``sort_codes`` then validity (``lex_sort``).
    None when its fields take more than 64 bits, which depends on the
    keys' dtypes and masks and the frame's layout alone. KW on CUDA keys,
    its twin on CPU keys."""
    n = int(keys[0][0].shape[0])
    if word_bits(keys, has_unreal_rows(n, nrows, row_valid)) > 64:
        return None
    build = kernel_for(keys[0][0], sort_word_cuda, sort_word_reference, "sort word")
    return build(keys, nrows=nrows, row_valid=row_valid)


def word_factorize(sw: SortWord) -> Tuple[torch.Tensor, torch.Tensor, int, str]:
    """``(seg, first_idx, num, k3_route)`` of the word route: one stable
    ``torch.sort`` of the word, K2w over the sorted words, the readback of
    the group count, then, by the group count alone, K3w (``"lookup"``)
    or K3 over K2w's sorted ids (``"scatter"``); the kernels on CUDA, the
    twins on the CPU."""
    sorted_words, order = torch.sort(sw.word, stable=True)
    boundaries = kernel_for(order, sort_word_boundaries_cuda, sort_word_boundaries_reference,
                         "sort word boundaries")
    uniq, first_idx, seg_sorted, count = boundaries(
        sorted_words, order, real_below=sw.real_below
    )
    num = int(count)  # the sort path's one readback (groupby.py:548)
    if num <= lookup_limit(sw.word.element_size()):
        lookup = kernel_for(order, sort_word_lookup_cuda, sort_word_lookup_reference,
                         "sort word lookup")
        seg = lookup(sw.word, uniq, num, real_below=sw.real_below)
        return seg, first_idx[:num].clone(), num, "lookup"
    finish = kernel_for(order, sort_finish_cuda, sort_finish_reference, "sort finish")
    seg, first_idx = finish(seg_sorted, order, num)
    return seg, first_idx, num, "scatter"


def wide_factorize(
    codes: Sequence[torch.Tensor],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(seg, first_idx, num)`` of the wide route: ``lex_sort``, then K2
    (over the sort's values of the first code where it has them) and K3
    with one readback of the group count between them (CUDA), or their
    twins (CPU)."""
    order, first_sorted = lex_sort(codes, nrows=nrows, row_valid=row_valid)
    if order.is_cuda:
        seg_sorted, count = sort_boundaries_cuda(codes, order, nrows=nrows, row_valid=row_valid,
                                                 first_sorted=first_sorted)
        del first_sorted  # K3's scratch needs the room
        num = int(count)  # the sort path's one readback (groupby.py:548)
        seg, first_idx = sort_finish_cuda(seg_sorted, order, num)
        return seg, first_idx, num
    if order.device.type == "cpu":
        return sort_factorize_reference(codes, order, nrows=nrows, row_valid=row_valid)
    raise NotImplementedError(f"sort factorization on {order.device}")


def sort_factorize(
    keys: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(seg, first_idx, num)`` of the sort path over ``keys`` (each its
    values and null mask): the word route where ``sort_word`` packs them,
    else the wide route over ``sort_codes``. Both give the JAX package's
    ids, first rows and group order. ``sort_factorize.last_route`` names
    the route taken: ``"word32/lookup"``, ``"word32/scatter"``,
    ``"word64/lookup"``, ``"word64/scatter"`` or ``"wide"``."""
    sw = sort_word(keys, nrows=nrows, row_valid=row_valid)
    if sw is None:
        seg, first_idx, num = wide_factorize(sort_codes(keys), nrows=nrows, row_valid=row_valid)
        route = "wide"
    else:
        seg, first_idx, num, k3 = word_factorize(sw)
        route = f"word{8 * sw.word.element_size()}/{k3}"
    sort_factorize.last_route = route  # type: ignore[attr-defined]
    return seg, first_idx, num


sort_factorize.last_route = None  # type: ignore[attr-defined]


def _sort_factorize(blocks: TorchBlocks, keys: List[str]) -> Factorized:
    """``groupby.py:507``: the general path for keys with no bin spec."""
    cols = [(key_data(blocks.columns[k]), blocks.columns[k].mask) for k in keys]
    seg, first_idx, num = sort_factorize(cols, **frame_rows(blocks))
    return Factorized(
        seg, num, first_idx, None,
        torch.tensor(num, dtype=torch.int32, device=blocks.device),
    )


def segment_extrema(
    seg: torch.Tensor,
    num: int,
    payloads: Sequence[Extremum],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    first: bool = False,
    last: bool = False,
) -> Extrema:
    """K4 on a CUDA ``seg``, its twin ``segment_extrema_reference`` on a
    CPU one: per payload its min and max over each segment, and each
    segment's first and last row."""
    run = kernel_for(seg, segment_extrema_cuda, segment_extrema_reference, "segment extrema")
    return run(seg, num, payloads, nrows=nrows, row_valid=row_valid, first=first, last=last)


def segment_sq_dev(
    seg: torch.Tensor,
    num: int,
    payloads: Sequence[Payload],
    means: torch.Tensor,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K5 on a CUDA ``seg``, its twin ``segment_sq_dev_reference`` on a CPU
    one: per payload the float64 sum of squared deviations from each
    segment's mean."""
    run = kernel_for(seg, segment_sq_dev_cuda, segment_sq_dev_reference, "segment sq dev")
    return run(seg, num, payloads, means, nrows=nrows, row_valid=row_valid)


def segment_median(
    values: torch.Tensor,
    eff: Optional[torch.Tensor],
    seg: torch.Tensor,
    num: int,
    counts: torch.Tensor,
) -> torch.Tensor:
    """Per-segment median of ``values`` over the rows where ``eff`` holds
    (None: every row), in float64 (``groupby.py:686-710``): the rows
    sorted by (segment, value), ties in row order, then the mean of the
    middle one or two of each segment's ``counts[s]`` positions. ``seg``
    holds ``num`` on rows that are not real; ``counts`` are the rows per
    segment where ``eff`` holds.

    A value of up to 32 bits sorts with its segment as one int64 word
    (``sort_word``: KW on the card), once; an int64 or float64 value takes
    the JAX package's two stable sorts, by value and then by segment.
    -0.0 ties with +0.0 in either, as it does there."""
    n = int(values.shape[0])
    seg_eff = seg if eff is None else torch.where(eff, seg, num)
    pair = [(seg_eff, None), (values, None)]
    if word_bits(pair, False) <= 64:
        word = sort_word(pair, nrows=n)
        order = torch.sort(word.word, stable=True).indices  # type: ignore[union-attr]
    else:
        key = values.to(torch.float64) + 0.0  # -0.0 + 0.0 is +0.0
        if eff is not None:
            key = torch.where(eff, key, float("inf"))
        order = torch.sort(key, stable=True).indices
        order = order[torch.sort(seg_eff[order], stable=True).indices]
    cnt = counts.to(torch.int64)
    starts = torch.cumsum(cnt, 0) - cnt
    lo = (starts + torch.div(cnt - 1, 2, rounding_mode="floor")).clamp(0, n - 1)
    hi = (starts + cnt // 2).clamp(0, n - 1)

    def at(pos: torch.Tensor) -> torch.Tensor:
        return values.index_select(0, order.index_select(0, pos)).to(torch.float64)

    return (at(lo) + at(hi)) * 0.5


def agg_form(func: str, tp: pa.DataType) -> str:
    """How aggregation ``func`` reads an argument of arrow type ``tp``
    (``agg_input``): ``"bits"``, ``"f64"`` or ``""`` (as it is stored)."""
    if tp != pa.uint64():
        return ""
    if func in ("sum", "avg", "mean"):
        return "bits"
    return "f64" if func == "median" or func in VARIANCE_FUNCS else ""


def agg_input(func: str, data: torch.Tensor, tp: pa.DataType) -> torch.Tensor:
    """An aggregation's argument, of arrow type ``tp``, as the kernels read
    it. A uint64 is stored with its sign bit flipped (``U64_FLIP``): min,
    max, first and last read the stored words, whose order is the values'
    (and return words the column stores); sum and avg read the values'
    bits (``value_bits``: an int64 sum that wraps as the JAX package's
    does); median and the variance family read the values in float64
    (``value_float64``); count reads no value. Any other type is read as
    it is."""
    form = agg_form(func, tp)
    if form == "bits":
        return value_bits(data, tp)
    return value_float64(data, tp) if form == "f64" else data


class AggRequest(NamedTuple):
    """One aggregation as ``segment_aggs`` takes it.

    - ``func``: count, sum, avg/mean, min, max, first, last, median or one
      of ``VARIANCE_FUNCS``, in lower case;
    - ``values``: its argument over the frame's padded rows (None for
      COUNT(*));
    - ``mask``: True where the row's value takes part (False on its nulls
      and, for a DISTINCT aggregation, on repeats); None: every value;
    - ``vkey``, ``mkey``: identities of ``values`` and ``mask`` ("" for
      None). Requests with equal keys share their payloads and counts."""

    func: str
    values: Optional[torch.Tensor]
    mask: Optional[torch.Tensor]
    vkey: str
    mkey: str


_SUM_AGGS = ("count", "sum", "avg", "mean")


def segment_aggs(
    requests: Sequence[AggRequest],
    span: int,
    rows: Dict[str, Any],
    *,
    seg: Optional[torch.Tensor] = None,
    keys: Optional[List[BinKey]] = None,
    first_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, Optional[torch.Tensor]]]]:
    """Every aggregation of a plan by segment (``_segment_agg_impl``,
    ``groupby.py:602-726``), each function on its route:

    - count, sum, avg: the fused kernel (``binned_sums``), one launch for
      the whole plan, over ``keys`` (the binned aggregate's key columns)
      or ``seg`` as the one key of span ``span``;
    - min, max: K4 (``segment_extrema``), one launch for the plan; first
      and last: the value at each segment's first row (``first_idx`` where
      given, which is that row) or last row (K4);
    - the variance family: the count and float64 sum of the rows that are
      not NaN (the fused kernel in float64: in the plan's launch, or in a
      second one where the plan also sums float32 payloads in float32),
      then K5 (``segment_sq_dev``) over the means;
    - median: ``segment_median``.

    ``seg`` int32 holds each row's segment in ``[0, span)``, and ``span``
    on rows that are not real; the binned aggregate passes ``keys`` and no
    ``seg``, and then only count/sum/avg. ``rows`` are the frame's rows as
    ``frame_rows`` gives them (``{"nrows": 0}`` to read none). Returns the
    rows of each segment (int32[span]) and per request ``(values[span],
    mask[span] or None)`` with the JAX package's masks: none for count,
    ``count > 0`` for sum/avg/min/max/median, more than 0 (pop) or 1
    (sample) rows that are not NaN for the variance family, and for
    first/last the value's own mask at the row picked, and whether the
    segment has a row."""
    if seg is None and any(r.func not in _SUM_AGGS for r in requests):
        raise ValueError("min/max/first/last/median/variance need the segment ids")
    counts: List[torch.Tensor] = []
    ckeys: Dict[str, int] = {"": 0}  # slot 0 counts every row of the segment
    pays: Dict[str, List[Payload]] = {"f": [], "i": [], "v": []}
    pkeys: Dict[str, Dict[str, int]] = {"f": {}, "i": {}, "v": {}}
    var_counts: List[int] = []  # each variance payload's count slot
    ext: List[List[Any]] = []  # [values, mask, min, max] per K4 payload
    ext_keys: Dict[str, int] = {}
    meds: List[Tuple[torch.Tensor, Optional[torch.Tensor], int]] = []
    eff_cache: Dict[str, Tuple[Optional[torch.Tensor], str]] = {}
    need_first = need_last = False

    def count_slot(key: str, mask: Optional[torch.Tensor]) -> int:
        if mask is None:
            return 0
        if key not in ckeys:
            counts.append(mask)
            ckeys[key] = len(counts)
        return ckeys[key]

    def payload_slot(kind: str, key: str, item: Payload) -> int:
        if key not in pkeys[kind]:
            pays[kind].append(item)
            pkeys[kind][key] = len(pays[kind]) - 1
        return pkeys[kind][key]

    def not_nan(r: AggRequest) -> Tuple[Optional[torch.Tensor], str]:
        """The request's mask without the NaN values (pandas skips them in
        median and variance, ``groupby.py:665``), and its key."""
        key = f"{r.mkey}|nan:{r.vkey}"
        if key not in eff_cache:
            v = r.values
            if v.is_floating_point():  # type: ignore[union-attr]
                ok = ~torch.isnan(v)  # type: ignore[arg-type]
                eff_cache[key] = (ok if r.mask is None else r.mask & ok, key)
            else:
                eff_cache[key] = (r.mask, r.mkey)
        return eff_cache[key]

    plan: List[Tuple[Any, ...]] = []
    for r in requests:
        f = r.func
        if f == "count":
            plan.append((f, count_slot(r.mkey, r.mask)))
        elif f in _SUM_AGGS:
            kind = "f" if r.values.is_floating_point() else "i"  # type: ignore[union-attr]
            si = payload_slot(kind, f"{r.vkey}|{r.mkey}", (r.values, r.mask))  # type: ignore
            plan.append((f, kind, si, count_slot(r.mkey, r.mask)))
        elif f in ("min", "max"):
            key = f"{r.vkey}|{r.mkey}"
            if key not in ext_keys:
                ext_keys[key] = len(ext)
                ext.append([r.values, r.mask, False, False])
            ext[ext_keys[key]][2 if f == "min" else 3] = True
            plan.append((f, ext_keys[key], count_slot(r.mkey, r.mask)))
        elif f in ("first", "last"):
            need_first |= f == "first" and first_idx is None
            need_last |= f == "last"
            plan.append((f, r))
        elif f == "median" or f in VARIANCE_FUNCS:
            eff, ekey = not_nan(r)
            ci = count_slot(ekey, eff)
            if f == "median":
                meds.append((r.values, eff, ci))  # type: ignore[arg-type]
                plan.append((f, len(meds) - 1, ci))
                continue
            # K5 reads float32 or float64: other payloads (a float16 too) in float64
            v = r.values if r.values.dtype in (torch.float32, torch.float64) \
                else r.values.to(torch.float64)  # type: ignore
            vi = payload_slot("v", f"{r.vkey}|{ekey}", (v, eff))
            if vi == len(var_counts):
                var_counts.append(ci)
            plan.append((f, vi, ci))
        else:
            raise ValueError(f"aggregation {f} has no segment route")

    fkeys = keys if keys is not None else [BinKey(seg, None, 0, span)]  # type: ignore[arg-type]
    floats, var = pays["f"], pays["v"]
    # variance payloads sum in float64: with the plan's floats unless those
    # sum in float32, then in a launch of their own
    joined = not floats or float_sum_dtype(floats) == torch.float64
    f_sums, c_sums, i_sums = binned_sums(
        fkeys, **rows, floats=floats + var if joined else floats, counts=counts,
        ints=pays["i"], f64=joined and bool(var),
    )
    v_sums = f_sums[len(floats):]
    if var and not joined:
        v_sums = binned_sums(fkeys, **rows, floats=var, occupancy=False, f64=True)[0]
    extrema = None
    if ext or need_first or need_last:
        extrema = segment_extrema(seg, span, [Extremum(*e) for e in ext], **rows,  # type: ignore
                                  first=need_first, last=need_last)
    sq_dev = None
    if var:
        means = torch.stack([v_sums[j] / torch.clamp(c_sums[ci], min=1)
                             for j, ci in enumerate(var_counts)])
        sq_dev = segment_sq_dev(seg, span, var, means, **rows)  # type: ignore[arg-type]
    med_vals = [segment_median(v, eff, seg, span, c_sums[ci])  # type: ignore[arg-type]
                for v, eff, ci in meds]

    occupancy = c_sums[0]
    out: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
    for item in plan:
        f = item[0]
        if f == "count":
            out.append((c_sums[item[1]], None))
        elif f in _SUM_AGGS:
            _, kind, si, ci = item
            tot, cnt = (i_sums if kind == "i" else f_sums)[si], c_sums[ci]
            if f != "sum":  # integer sums divide in float64, as in the JAX package
                tot = (tot.to(torch.float64) if kind == "i" else tot) / torch.clamp(cnt, min=1)
            out.append((tot, cnt > 0))
        elif f in ("min", "max"):
            _, j, ci = item
            out.append(((extrema.mins if f == "min" else extrema.maxs)[j],  # type: ignore
                        c_sums[ci] > 0))
        elif f in ("first", "last"):
            r = item[1]
            best = first_idx if f == "first" and first_idx is not None else (
                extrema.first if f == "first" else extrema.last)  # type: ignore[union-attr]
            best = best.clamp(0, int(r.values.shape[0]) - 1)  # type: ignore
            has = occupancy > 0
            out.append((r.values.index_select(0, best),  # type: ignore[union-attr]
                        has if r.mask is None else has & r.mask.index_select(0, best)))
        elif f == "median":
            _, j, ci = item
            out.append((med_vals[j], c_sums[ci] > 0))
        else:  # the variance family
            _, j, ci = item
            cnt = c_sums[ci].to(torch.float64)
            pop = f.endswith("_pop")
            var_ = sq_dev[j] / torch.clamp(cnt if pop else cnt - 1, min=1)  # type: ignore
            out.append((torch.sqrt(var_) if f.startswith("stddev") else var_,
                        c_sums[ci] > (0 if pop else 1)))
    return occupancy, out
