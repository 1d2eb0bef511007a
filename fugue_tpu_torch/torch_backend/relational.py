"""Joins, set operations, fillna, take and sample on the card: the port of
the one-device programs of ``fugue_tpu/jax_backend/relational.py``.

Both sides' key columns are factorized into one shared segment space
(``shared_factorize``: the group-by's ``factorize_keys`` over the keys
stacked), then:

- **semi / anti** flip the left frame's row validity: K7 ``join_build``
  counts the right rows of each segment, K8 ``join_probe`` tests each
  left row's segment. No gather, no readback; the count stays lazy.
- **unique right** (inner or left outer on one key that ingest proved
  unique on the right): K7 writes each right row into its segment's slot,
  K8 reads each left row's slot, K10 ``gather_rows`` gathers the right
  columns. The left columns pass through untouched; no readback.
- **expansion** (inner, left and full outer, cross): K7's right counts,
  their exclusive prefix sum and the right rows grouped by segment (one
  stable ``torch.sort``), K8's matches and output rows per left row with
  their total, one readback of the output size (full outer's two sizes
  in the same transfer), K9 ``join_expand`` for each output row's left
  and right row, and K10 for both sides' columns. Full outer appends the
  right rows with no match (K8 in anti mode over the right side against
  the left side's counts) through ``union_all_blocks``.

Null join keys never match (SQL): rows with any null key are not
matchable on either side (``_null_any_mask``), though the factorization
groups them. A string key's two dictionaries become one before the keys
are stacked (``harmonize_string_keys``): side 1 keeps its codes and side
2's are re-coded by one K6 launch of a single table gather; other string
columns ride through K10 as their int32 codes and keep their
dictionaries.

The row selections flip a frame's row validity and give it a lazy count,
with no gather and no readback (the JAX package's mask-only programs):

- **INTERSECT / EXCEPT** (``intersect_subtract``) over the shared
  factorization of every column (nulls equal): K7 counts side 2's rows
  a segment; DISTINCT keeps each segment's first row of side 1 where the
  count is (INTERSECT) or is not (EXCEPT) above 0, by K13
  ``first_row_mask``; ALL sorts side 1's segment ids (one stable
  ``torch.sort``), counts side 1 by K7 for each segment's first sorted
  position, and K12 ``rank_keep`` keeps, over the sorted ids, the rows
  whose ordinal is below (INTERSECT) or at least (EXCEPT) side 2's count.
- **fillna** (``device_fillna``): every target column in one K6 launch,
  ``COALESCE(x, v)`` with a float's NaN read as null first.
- **take** (``device_take``): the presort's keys, and the partition's
  segment id before them, packed into order-preserving sort words by
  K11 (KW's presort mode), one stable ``torch.sort`` a word
  (``presort_order``), K7's partition counts for each partition's first
  sorted position, and K12 keeps the ranks below ``n``, the partition read
  from the first word in sorted order.
- **sample** (``device_sample``): a seeded ``torch.randperm`` as each
  row's priority (``len`` on rows that are not real), ``torch.sort``, and
  K12 keeps the first ``k`` positions, ``k`` computed on the card.

The SQL front end adds three more: ``not_in_join`` (K7 with the right
side's real and null-key rows counted on the card, K8's NOT IN mode),
``device_sort`` (ORDER BY/LIMIT/OFFSET: ``presort_order`` and one K10
gather) and ``presort_sorted``, the window order K15 and K16 read
(``torch_backend/window.py``).

The kernels run where the tensors lie on CUDA, their plain twins
(``kernels/reference.py``) where they lie on the CPU; there is no
fallback between them. The multi-device branches wait for ROADMAP.md
queue 1 item 12.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from fugue_tpu_torch.kernels import kernel_for
from fugue_tpu_torch.kernels.expr_program import (
    CODES,
    F16,
    F32,
    OP,
    Instr,
    Output,
    Program,
)
from fugue_tpu_torch.kernels.factorize import MAX_WORD_KEYS, presort_word_cuda
from fugue_tpu_torch.kernels.gather import gather_rows
from fugue_tpu_torch.kernels.join import join_build_cuda, join_expand_cuda, join_probe_cuda
from fugue_tpu_torch.kernels.reference import (
    GatherColumn,
    PresortKey,
    Probe,
    SortedWords,
    first_row_mask_reference,
    has_unreal_rows,
    join_build_reference,
    join_expand_reference,
    join_probe_reference,
    key_field_bits,
    key_has_flag,
    null_count_keep_reference,
    presort_bits,
    presort_word_reference,
    rank_keep_reference,
    real_below,
)
from fugue_tpu_torch.kernels.row_select import (
    first_row_mask_cuda,
    null_count_keep_cuda,
    rank_keep_cuda,
)
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend import expr_eval, groupby, strings
from fugue_tpu_torch.torch_backend.blocks import (
    TorchBlocks,
    TorchColumn,
    gather_indices,
    is_unsigned_wide,
    key_data,
    keeps_stats,
    padded_len,
    storage_scalar,
    torch_dtype,
)
from fugue_tpu_torch.utils.validity import materialize_validity

# the readbacks of the joins' own output sizes in this process (one a
# readback: M, or M and R together for full outer); the factorization's
# own readback on the sort path is not counted here
readbacks = 0


def _ones(mask: Optional[torch.Tensor], n: int, device: torch.device) -> torch.Tensor:
    return mask if mask is not None else torch.ones((n,), dtype=torch.bool, device=device)


def harmonize_string_keys(c1: TorchColumn, c2: TorchColumn) -> Tuple[TorchColumn, TorchColumn]:
    """Two string columns re-coded into one dictionary
    (``relational.py:69-104``): side 1 keeps its codes, and the union
    dictionary extends side 1's; side 2's codes are re-coded by one K6
    launch of a single LUT. Both get the union and its codes' bounds as
    stats. Equal dictionaries are returned as they are, with no launch."""
    remap = strings.remap_table(c1.dictionary, c2.dictionary)  # type: ignore[arg-type]
    if remap is None:
        return c1, c2
    table, union = remap
    stats = (0, max(len(union) - 1, 0))
    return (TorchColumn(c1.pa_type, c1.data, c1.mask, stats, dictionary=union),
            TorchColumn(c2.pa_type, expr_eval.remap_codes(c2.data, table), c2.mask, stats,
                        dictionary=union))


Pairs = Dict[str, Tuple[TorchColumn, TorchColumn]]


def _harmonized(b1: TorchBlocks, b2: TorchBlocks, names: List[str]) -> Pairs:
    """The named columns of both frames, string columns in one dictionary."""
    pairs: Pairs = {}
    for n in names:
        c1, c2 = b1.columns[n], b2.columns[n]
        pairs[n] = harmonize_string_keys(c1, c2) if c1.is_string else (c1, c2)
    return pairs


def stack_blocks(blocks: List[TorchBlocks], columns: Dict[str, List[TorchColumn]]
                 ) -> TorchBlocks:
    """Each entry of ``columns`` (one column a frame of ``blocks``, in
    their order) stacked along the rows in one dtype, with its masks (all
    valid where a frame has none), merged stats and the first frame's
    dictionary, over the rows of every frame: a prefix frame where each
    frame is a prefix frame with no padding, else a masked frame with the
    validities stacked (a lazy count where any frame's is)."""
    device = blocks[0].device
    ps = [b.padded_nrows for b in blocks]
    cols: Dict[str, TorchColumn] = {}
    for n, cs in columns.items():
        dt = cs[0].data.dtype
        for c in cs[1:]:
            dt = torch.promote_types(dt, c.data.dtype)
        mask = None
        if any(c.mask is not None for c in cs):
            mask = torch.cat([_ones(c.mask, p, device) for c, p in zip(cs, ps)])
        stats = cs[0].stats
        for c in cs[1:]:
            stats = None if stats is None or c.stats is None else (
                min(stats[0], c.stats[0]), max(stats[1], c.stats[1]))
        cols[n] = TorchColumn(cs[0].pa_type, torch.cat([c.data.to(dt) for c in cs]), mask,
                              stats, dictionary=cs[0].dictionary)
    if all(b.row_valid is None and b.nrows == b.padded_nrows for b in blocks):
        return TorchBlocks(sum(ps), cols, device)
    known = all(b.nrows_known for b in blocks)
    nrows = sum(b._nrows for b in blocks) if known else None  # type: ignore[misc]
    nrows_dev = None
    if not known:
        nrows_dev = blocks[0].nrows_tensor()
        for b in blocks[1:]:
            nrows_dev = nrows_dev + b.nrows_tensor()
    return TorchBlocks(nrows, cols, device, row_valid=torch.cat([b.validity() for b in blocks]),
                       nrows_dev=nrows_dev)


def concat_key_blocks(b1: TorchBlocks, b2: TorchBlocks, keys: List[str]
                      ) -> Tuple[TorchBlocks, Pairs]:
    """Both sides' key columns stacked along the rows, side 1 first
    (``relational.py:116``), string keys in one dictionary
    (``harmonize_string_keys``, ``:133``): the combined frame and each
    key's two columns. A side's rows that are not real stay so in the
    combined frame, so the factorization sees them as non-rows."""
    pairs = _harmonized(b1, b2, keys)
    return stack_blocks([b1, b2], {n: list(p) for n, p in pairs.items()}), pairs


class SharedFactorization:
    """Both sides' keys in one segment space (``relational.py:207``):
    ``seg1`` int32 [p1] and ``seg2`` int32 [p2], each with the sentinel
    ``num_segments`` on rows that are not real; ``first_idx`` and
    ``occupied``, the stacked frame's (``groupby.Factorized``: side 1's
    rows come first, so a segment's first row is side 1's where it has
    one, and at or above ``p1`` where it has none); ``keys`` each key's
    two columns, string keys in one dictionary."""

    def __init__(self, seg1: torch.Tensor, seg2: torch.Tensor, num_segments: int, keys: Pairs,
                 first_idx: torch.Tensor, occupied: Optional[torch.Tensor]):
        self.seg1 = seg1
        self.seg2 = seg2
        self.num_segments = num_segments
        self.keys = keys
        self.first_idx = first_idx
        self.occupied = occupied


def shared_factorize(b1: TorchBlocks, b2: TorchBlocks, keys: List[str]) -> SharedFactorization:
    """One factorization of the stacked keys (``groupby.factorize_keys``:
    K1 where they bin, else the sort path with its one readback of the
    group count), cut into the two sides (``relational.py:227-245``)."""
    combined, pairs = concat_key_blocks(b1, b2, keys)
    fr = groupby.factorize_keys(combined, keys)
    p1 = b1.padded_nrows
    return SharedFactorization(fr.seg[:p1], fr.seg[p1:], fr.num_segments, pairs, fr.first_idx,
                               fr.occupied)


def _null_any_mask(b: TorchBlocks, keys: List[str]) -> Optional[torch.Tensor]:
    """True where any key is null: such rows never match in a join
    (``relational.py:248``). None where no key has nulls."""
    masks = [b.columns[k].mask for k in keys if b.columns[k].mask is not None]
    if not masks:
        return None
    valid = masks[0]
    for m in masks[1:]:
        valid = valid & m
    return ~valid


def _build(seg: torch.Tensor, num: int, b: TorchBlocks, nulls: Optional[torch.Tensor],
           **kw: Any) -> Any:
    run = kernel_for(seg, join_build_cuda, join_build_reference, "join build")
    return run(seg, num, nulls=nulls, **kw, **groupby.frame_rows(b))


def _probe(seg: torch.Tensor, table: torch.Tensor, mode: str, b: TorchBlocks,
           nulls: Optional[torch.Tensor], **kw: Any) -> Probe:
    run = kernel_for(seg, join_probe_cuda, join_probe_reference, "join probe")
    return run(seg, table, mode, nulls=nulls, **kw, **groupby.frame_rows(b))


def _gather(columns: Dict[str, TorchColumn], idx: torch.Tensor, outer: bool,
            scattered: bool = False) -> Dict[str, TorchColumn]:
    """K10 over ``columns`` by ``idx``, each result with its source's
    type and stats; ``scattered`` as ``gather.gather_rows`` takes it."""
    got = gather_rows([GatherColumn(c.data, c.mask) for c in columns.values()], idx,
                      outer=outer, scattered=scattered)
    return {n: c.with_data(v, m) for (n, c), (v, m) in zip(columns.items(), got)}


def _pad_index(idx: torch.Tensor, target: int, fill: int) -> torch.Tensor:
    """``idx`` extended to ``target`` rows with ``fill``."""
    n = int(idx.shape[0])
    if n == target:
        return idx
    return torch.cat([idx, torch.full((target - n,), fill, dtype=idx.dtype, device=idx.device)])


def semi_anti_join(b1: TorchBlocks, b2: TorchBlocks, keys: List[str], anti: bool) -> TorchBlocks:
    """``relational.py:275``: the left frame's columns as they are, with
    ``row_valid`` = the rows kept and their count lazy. K7 counts the
    right side's matchable rows per segment, K8 keeps the left rows with
    (semi) or without (anti) a match. No readback."""
    sf = shared_factorize(b1, b2, keys)
    S = max(sf.num_segments, 1)
    counts = _build(sf.seg2, S, b2, _null_any_mask(b2, keys))
    pr = _probe(sf.seg1, counts, "anti" if anti else "semi", b1, _null_any_mask(b1, keys))
    return TorchBlocks(None, dict(b1.columns), b1.device, row_valid=pr.keep, nrows_dev=pr.total)


def not_in_join(b1: TorchBlocks, b2: TorchBlocks, keys: List[str]) -> TorchBlocks:
    """``WHERE x NOT IN (SELECT y ...)`` with SQL's three-valued semantics
    (``relational.py:327``): an empty right side keeps every real left row
    (a null ``x`` too), a null on the right keeps none, else the left rows
    with a non-null key and no match. K7 counts the right side's real
    non-null keys a segment and, in two device ints, its real rows and
    real rows with a null key; K8's NOT IN mode reads them on the card.
    The left frame's columns as they are, its validity flipped, the count
    lazy; no readback."""
    sf = shared_factorize(b1, b2, keys)
    S = max(sf.num_segments, 1)
    counts, stats = _build(sf.seg2, S, b2, _null_any_mask(b2, keys), side_counts=True)
    pr = _probe(sf.seg1, counts, "not_in", b1, _null_any_mask(b1, keys), stats=stats)
    return TorchBlocks(None, dict(b1.columns), b1.device, row_valid=pr.keep, nrows_dev=pr.total)


def expand_join(
    b1: TorchBlocks,
    b2: TorchBlocks,
    keys: List[str],
    how: str,  # "inner" | "leftouter" | "fullouter" | "cross"
    schema1: Schema,
    schema2: Schema,
    out_schema: Schema,
) -> Tuple[TorchBlocks, str]:
    """The match-enumerating join (``relational.py:390``), or the unique
    right route where it applies (``:419-433``). Returns the frame and
    the route, ``"join_unique"`` or ``"join_expand"``."""
    device = b1.device
    p1, p2 = b1.padded_nrows, b2.padded_nrows
    key_pairs: Pairs = {}
    if how == "cross":
        S = 1
        seg1 = torch.zeros((p1,), dtype=torch.int32, device=device)
        seg2 = torch.zeros((p2,), dtype=torch.int32, device=device)
        null1 = null2 = None
    else:
        sf = shared_factorize(b1, b2, keys)
        S, seg1, seg2, key_pairs = max(sf.num_segments, 1), sf.seg1, sf.seg2, sf.keys
        null1, null2 = _null_any_mask(b1, keys), _null_any_mask(b2, keys)
    if how in ("inner", "leftouter") and len(keys) == 1 and b2.columns[keys[0]].unique:
        return _unique_right_join(b1, b2, how, S, seg1, seg2, null1, null2, schema1, schema2,
                                  out_schema), "join_unique"
    outer_left = how in ("leftouter", "fullouter")
    counts2 = _build(seg2, S, b2, null2)
    cstart2 = torch.cumsum(counts2, 0, dtype=torch.int64) - counts2
    match2 = b2.validity() if null2 is None else b2.validity() & ~null2
    order2 = torch.sort(torch.where(match2, seg2, S), stable=True).indices
    pr = _probe(seg1, counts2, "expand", b1, null1, outer=outer_left)
    start = torch.cumsum(pr.reps, 0, dtype=torch.int64) - pr.reps
    un2: Optional[Probe] = None
    if how == "fullouter":
        counts1 = _build(seg1, S, b1, null1)
        un2 = _probe(seg2, counts1, "anti", b2, null2)
        sizes = torch.stack([pr.total, un2.total.to(torch.int64)]).tolist()
    else:
        sizes = [pr.total.item(), 0]
    global readbacks
    readbacks += 1
    M, R = int(sizes[0]), int(sizes[1])  # the join's one readback: its output size(s)
    expand = kernel_for(start, join_expand_cuda, join_expand_reference, "join expand")
    li, ri = expand(start, pr.m, seg1, cstart2, order2, M)
    out_pad = padded_len(M)
    li, ri = _pad_index(li, out_pad, 0), _pad_index(ri, out_pad, -1)
    d1 = {n: b1.columns[n] for n in schema1.names}
    if un2 is not None:
        # full outer: the keys in the shared dictionary, so that the right
        # rows with no match append with no second re-coding (``:534``)
        d1.update({k: c1 for k, (c1, _) in key_pairs.items()})
    d2 = {n: b2.columns[n] for n in schema2.names if n not in schema1}
    # li is in order; ri follows the right side's sort by segment: random
    g = {**_gather(d1, li, outer=False),
         **_gather(d2, ri, outer=outer_left, scattered=True)}
    out = TorchBlocks(M, {f.name: g[f.name] for f in out_schema.fields}, device)
    if un2 is not None and R > 0:
        right_keys = {k: c2 for k, (_, c2) in key_pairs.items()}
        tail = _gather_right_unmatched(b1, b2, right_keys, un2.keep, R,  # type: ignore[arg-type]
                                       out_schema)
        out = union_all_blocks(out, tail)
    return out, "join_expand"


def _unique_right_join(
    b1: TorchBlocks,
    b2: TorchBlocks,
    how: str,  # "inner" | "leftouter"
    S: int,
    seg1: torch.Tensor,
    seg2: torch.Tensor,
    null1: Optional[torch.Tensor],
    null2: Optional[torch.Tensor],
    schema1: Schema,
    schema2: Schema,
    out_schema: Schema,
) -> TorchBlocks:
    """``relational.py:635``, against a right side whose one key ingest
    proved unique: K7 writes each right row into its segment's slot, K8
    reads each left row's slot (its right row, -1 where none) and keeps
    the matched rows (inner) or every real row (left outer), K10 gathers
    the right columns. The left columns pass through untouched (stats and
    ``unique`` intact); the row count stays lazy. No readback."""
    slots = _build(seg2, S, b2, null2, slots=True)
    pr = _probe(seg1, slots, "unique", b1, null1, outer=how == "leftouter")
    d2 = {n: b2.columns[n] for n in schema2.names if n not in schema1}
    g2 = _gather(d2, pr.ridx, outer=how == "leftouter")  # type: ignore[arg-type]
    cols = {f.name: g2[f.name] if f.name in g2 else b1.columns[f.name] for f in out_schema.fields}
    return TorchBlocks(None, cols, b1.device, row_valid=pr.keep, nrows_dev=pr.total)


def _compact(keep: torch.Tensor, count: int) -> torch.Tensor:
    """The positions of ``keep``'s true entries in order, int32 [count]
    (``count`` of them, read back already): each kept position scatters
    itself to its rank; the others go to a last slot that is cut off. No
    readback of its own, unlike ``torch.nonzero``."""
    n = int(keep.shape[0])
    rank = torch.cumsum(keep, 0, dtype=torch.int64) - 1
    slot = torch.where(keep, rank, count)
    out = torch.empty((count + 1,), dtype=torch.int32, device=keep.device)
    out.scatter_(0, slot, torch.arange(n, dtype=torch.int32, device=keep.device))
    return out[:count]


def _gather_right_unmatched(
    b1: TorchBlocks, b2: TorchBlocks, keys: Dict[str, TorchColumn], unmatched: torch.Tensor,
    R: int, out_schema: Schema,
) -> TorchBlocks:
    """The full outer join's tail (``relational.py:737``): the ``R`` right
    rows with no left match (``unmatched``), in row order; the keys (the
    right side's ``keys`` columns) and the right-only columns from the
    right side (K10), the left-only columns all null (a string one with
    its left column's dictionary)."""
    device = b2.device
    out_pad = padded_len(R)
    idx = _pad_index(_compact(unmatched, R), out_pad, 0)
    src = {n: keys[n] if n in keys else b2.columns[n] for n in out_schema.names
           if n in keys or (n in b2.columns and n not in b1.columns)}
    g = _gather(src, idx, outer=False)
    cols: Dict[str, TorchColumn] = {}
    for f in out_schema.fields:
        if f.name in g:
            cols[f.name] = g[f.name]
        else:
            cols[f.name] = TorchColumn(
                f.type, torch.zeros((out_pad,), dtype=torch_dtype(f.type), device=device),
                torch.zeros((out_pad,), dtype=torch.bool, device=device),
                dictionary=b1.columns[f.name].dictionary)
    return TorchBlocks(R, cols, device)


def union_all_blocks(b1: TorchBlocks, b2: TorchBlocks) -> TorchBlocks:
    """Two frames of the same columns stacked along the rows
    (``relational.py:935``): a masked frame (or a prefix one where both
    have no padding) whose padding rows stay invalid, string columns in
    one dictionary (``:946``). No compaction, no readback."""
    pairs = _harmonized(b1, b2, list(b1.columns))
    return stack_blocks([b1, b2], {n: list(p) for n, p in pairs.items()})


# ---------------------------------------------------------------------------
# set operations, fillna, take and sample: new row validity, no gather
# ---------------------------------------------------------------------------


def first_rows(first_idx: torch.Tensor, n: int, *, occupied: Optional[torch.Tensor] = None,
               counts: Optional[torch.Tensor] = None, mode: str = "all"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13 ``first_row_mask`` (its twin on the CPU): each segment's first
    row among ``n`` rows where its predicate holds, and their count."""
    run = kernel_for(first_idx, first_row_mask_cuda, first_row_mask_reference,
                          "first row mask")
    return run(first_idx, n, occupied=occupied, counts=counts, mode=mode)


def rank_keep(order: torch.Tensor, **kw: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12 ``rank_keep`` over the sorted positions (its twin on the CPU)."""
    run = kernel_for(order, rank_keep_cuda, rank_keep_reference, "rank keep")
    return run(order, **kw)


def null_count_keep(b: TorchBlocks, masks: List[torch.Tensor], ncols: int, how: str,
                    thresh: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K14 ``null_count_keep`` over the frame's rows (its twin on the
    CPU)."""
    run = kernel_for(b.device, null_count_keep_cuda, null_count_keep_reference,
                     "null count keep")
    return run([m.contiguous() for m in masks], ncols, b.padded_nrows, how=how, thresh=thresh,
               device=b.device, **groupby.frame_rows(b))


def keep_rows(b: TorchBlocks, keep: torch.Tensor, count: torch.Tensor) -> TorchBlocks:
    """The frame's columns over the rows ``keep``, the count lazy."""
    return TorchBlocks(None, dict(b.columns), b.device, row_valid=keep, nrows_dev=count)


def intersect_subtract(b1: TorchBlocks, b2: TorchBlocks, names: List[str], subtract: bool,
                       distinct: bool = True) -> TorchBlocks:
    """INTERSECT / EXCEPT (``relational.py:1030``): side 1's rows whose
    whole row (``names``; nulls equal) is, or is not, among side 2's.
    DISTINCT keeps each such row once, at its first occurrence; ALL keeps
    the rows whose ordinal among equal rows of side 1 is below (INTERSECT)
    or at least (EXCEPT) side 2's count of that row. Side 1's columns as
    they are, its validity flipped, the count lazy: K7 for side 2's counts,
    then K13, or the stable sort of side 1's segment ids, K7 and K12 over
    the sorted ids (the sentinel of the rows that are not real sorts
    last)."""
    sf = shared_factorize(b1, b2, names)
    S = max(sf.num_segments, 1)
    c2 = _build(sf.seg2, S, b2, None)
    p1 = b1.padded_nrows
    if distinct:
        # the predicate depends on the segment alone, so the first kept row
        # of a segment is its first row of side 1 (first_idx below p1)
        num = int(sf.first_idx.shape[0])
        keep, count = first_rows(sf.first_idx, p1, occupied=sf.occupied, counts=c2[:num],
                                 mode="miss" if subtract else "hit")
        return keep_rows(b1, keep, count)
    c1 = _build(sf.seg1, S, b1, None)
    num = sf.num_segments  # the sentinel, which K12 keeps out
    starts = (torch.cumsum(c1, 0, dtype=torch.int64) - c1)[:num]
    srt = torch.sort(sf.seg1, stable=True)
    keep, count = rank_keep(srt.indices, seg=srt.values, starts=starts, limits=c2[:num],
                            mode="ge" if subtract else "lt")
    return keep_rows(b1, keep, count)


def encode_fill_value(col: TorchColumn, value: Any) -> Optional[Tuple[Any, Optional[np.ndarray]]]:
    """The fill ``value`` in the column's representation on the card, and
    the dictionary of a string column that does not hold it yet (its own
    extended by the value; else None): ``_encode_fill_value``
    (``relational.py:1114-1152``), which extends the source column's
    dictionary in place where the port gives the filled column a new one.
    None where the value cannot be represented exactly (``2.5`` into an
    integer column), which the JAX package answers on its host engine."""
    tp = col.pa_type
    try:
        if col.is_string:
            if not isinstance(value, str):
                return None
            hits = np.nonzero(col.dictionary == value)[0]
            if len(hits) > 0:
                return np.int32(hits[0]), None
            extended = np.concatenate([col.dictionary, np.asarray([value], dtype=object)])
            return np.int32(len(extended) - 1), extended
        if pa.types.is_timestamp(tp):
            ts = np.datetime64(value, "us")
            return np.int64((ts - np.datetime64(0, "us")).astype(np.int64)), None
        if pa.types.is_date32(tp):
            d = np.datetime64(value, "D")
            return np.int32((d - np.datetime64(0, "D")).astype(np.int64)), None
        if is_unsigned_wide(tp):  # the value in its type, then as the column stores it
            u = np.asarray(value, dtype=tp.to_pandas_dtype())[()]
            if u != value:
                return None
            return np.asarray(storage_scalar(int(u), tp),
                              dtype=torch.empty((0,), dtype=col.data.dtype).numpy().dtype)[()], \
                None
        np_dtype = torch.empty((0,), dtype=col.data.dtype).numpy().dtype
        v = np.asarray(value, dtype=np_dtype)[()]
        if not np.issubdtype(np_dtype, np.floating) and v != value:
            return None
        return v, None
    except (ValueError, TypeError):
        return None


def fill_program(columns: List[Tuple[str, torch.dtype]], fills: List[Any]) -> Program:
    """One K6 program in columns mode that fills each column: register j
    holds input j, ``NANNULL`` it where it is a float, then ``COAL`` it
    with its fill (a constant in the one spare register); each output is
    its register, with no mask."""
    m = len(columns)
    instrs: List[Instr] = []
    # a float16 column is read into, filled in and stored from an F32 register
    codes = [F32 if dtype == torch.float16 else CODES[dtype] for _, dtype in columns]
    stored = [F16 if dtype == torch.float16 else CODES[dtype] for _, dtype in columns]
    for j, ((_, dtype), v) in enumerate(zip(columns, fills)):
        code = codes[j]
        if dtype.is_floating_point:
            instrs.append(Instr(OP["NANNULL"], code, j, j))
        value = bool(v) if dtype == torch.bool else (float(v) if dtype.is_floating_point
                                                     else int(v))
        instrs.append(Instr(OP["CONST"], code, m, imm=value))
        instrs.append(Instr(OP["COAL"], code, j, j, m))
    return Program(
        tuple((name, stored[j]) for j, (name, _) in enumerate(columns)), tuple(instrs),
        tuple(Output(j, stored[j], False) for j in range(m)),
        m + 1, (False,) * m, (), (None,) * m,
    )


def device_fillna(blocks: TorchBlocks, targets: Dict[str, Any]) -> Optional[TorchBlocks]:
    """``relational.py:1154``: the nulls of each target column, and a
    float column's NaN, filled with its value in one K6 launch, however
    many columns; the filled columns drop their masks. A column
    with neither nulls nor a float type is left as it is. None where a
    value cannot be represented in its column (``encode_fill_value``).
    An integer-like column's stats take in its fill, and a string
    column's dictionary the value it did not hold."""
    enc: Dict[str, Tuple[Any, Optional[np.ndarray]]] = {}
    for name, value in targets.items():
        col = blocks.columns[name]
        if col.mask is None and not col.data.is_floating_point():
            continue  # nothing to fill
        e = encode_fill_value(col, value)
        if e is None:
            return None
        enc[name] = e
    if not enc:
        return blocks
    names = sorted(enc)
    new_cols = dict(blocks.columns)
    prog = fill_program([(n, blocks.columns[n].data.dtype) for n in names],
                        [enc[n][0] for n in names])
    outs = expr_eval.run_program(prog, blocks)
    for name, (values, _) in zip(names, outs):  # type: ignore[arg-type]
        src = blocks.columns[name]
        v, extended = enc[name]
        dictionary = src.dictionary if extended is None else extended
        stats = src.stats
        if src.is_string:
            stats = (0, max(len(dictionary) - 1, 0))  # type: ignore[arg-type]
        elif stats is not None and keeps_stats(src.pa_type):
            stats = (min(stats[0], int(v)), max(stats[1], int(v)))
        new_cols[name] = TorchColumn(src.pa_type, values, None, stats, dictionary=dictionary)
    return TorchBlocks(blocks._nrows, new_cols, blocks.device, row_valid=blocks.row_valid,
                       nrows_dev=blocks._nrows_dev)


def sort_code_columns(blocks: TorchBlocks, sorts: List[Tuple[str, bool]],
                      nulls_first: bool) -> List[PresortKey]:
    """Each sort item, in order, as a key of K11 (``_sort_code_columns``,
    ``relational.py:1234``): descending where not ascending, nulls (and a
    float's NaN) first or last, -0.0 tied with +0.0. A string column sorts
    by its entries' rank in the sorted dictionary (one K6 LUT launch over
    the rank table), not by its codes; an integer column takes a field of
    ``value - min`` in the bits its range needs (its stats', else its
    type's)."""
    keys: List[PresortKey] = []
    for name, asc in sorts:
        if name not in blocks.columns:
            raise KeyError(f"{name} is not a column of the frame")
        col = blocks.columns[name]
        values, kmin, bits = key_data(col), None, 0
        if col.is_string:
            table = strings.sort_rank_table(col.dictionary)  # type: ignore[arg-type]
            values = expr_eval.remap_codes(col.data, table)
            kmin, bits = 0, (len(table) - 1).bit_length()
        elif values.dtype != torch.bool and not values.is_floating_point():
            # an integer's field is value - kmin: numeric order (an int64's
            # natural field orders as the group-by's codes, low word first)
            kmin, bits = torch.iinfo(values.dtype).min, 8 * values.element_size()
            if col.stats is not None and keeps_stats(col.pa_type):
                span = int(col.stats[1]) - int(col.stats[0])
                if span.bit_length() < bits:
                    kmin, bits = int(col.stats[0]), span.bit_length()
        mask = None if col.mask is None else col.mask.contiguous()
        keys.append(PresortKey(values.contiguous(), mask, desc=not asc, nulls_first=nulls_first,
                               nan_is_null=True, kmin=kmin, bits=bits))
    return keys


def _word_groups(keys: List[PresortKey], unreal: bool) -> List[List[PresortKey]]:
    """``keys`` (most significant first) cut into the fields of words of
    at most 64 bits and ``MAX_WORD_KEYS`` keys, most significant word
    first; the first holds the "not real" bit where ``unreal``. A key that
    does not fit what is left of a word ends it with its null flag and
    puts its field in the next; a 64-bit field with a flag takes a word of
    its own."""
    groups: List[List[PresortKey]] = [[]]
    used = int(unreal)
    for k in keys:
        flag, width = int(k.flag and key_has_flag(k)), key_field_bits(k)
        if used + flag + width > 64 or len(groups[-1]) >= MAX_WORD_KEYS:
            if flag and used < 64 and len(groups[-1]) < MAX_WORD_KEYS:
                groups[-1].append(k._replace(value=False))
                k, flag = k._replace(flag=False), 0
            groups.append([])
            used = 0
            if flag + width > 64:
                groups[-1].append(k._replace(value=False))
                groups.append([])
                k, flag = k._replace(flag=False), 0
        groups[-1].append(k)
        used += flag + width
    return [g for i, g in enumerate(groups) if g or (i == 0 and unreal)]


def _presort_words(keys: List[PresortKey], n: int, device: torch.device,
                   nrows: Optional[int], row_valid: Optional[torch.Tensor]
                   ) -> Tuple[List[torch.Tensor], List[List[PresortKey]]]:
    """K11's words of ``keys`` (``_word_groups``) and the groups of keys
    they hold, most significant first."""
    unreal = has_unreal_rows(n, nrows, row_valid)
    groups = _word_groups(keys, unreal)
    if not groups:
        return [], groups
    build = kernel_for(device, presort_word_cuda, presort_word_reference, "presort words")
    rows = dict(nrows=nrows, row_valid=row_valid)
    if not groups[0] and row_valid is None:  # the word of the "not real" bit alone
        rows = dict(row_valid=materialize_validity(None, n, nrows, device))
    return [build(g, unreal=unreal and i == 0, **rows) for i, g in enumerate(groups)], groups


def presort_order(keys: List[PresortKey], n: int, device: torch.device, *,
                  nrows: Optional[int] = None, row_valid: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The rows (int64 [n]) in the order of ``keys``, real rows first,
    ties in row order: ``_stable_sort_order`` (``relational.py:1265``).
    The keys are packed into as few order-preserving words as fit their
    fields (K11, KW's presort mode; ``_word_groups``), and one stable
    ``torch.sort`` a word, least significant first, orders the rows
    (the JAX package sorts once a key and once a null flag)."""
    words = _presort_words(keys, n, device, nrows, row_valid)[0]
    if not words:
        return torch.arange(n, dtype=torch.int64, device=device)
    return _lsd_order(words)[0]


def _lsd_order(words: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The order of ``words`` (most significant first), one stable sort a
    word, least significant first; and ``words[0]`` in that order (the
    values of the last sort)."""
    srt = torch.sort(words[-1], stable=True)
    order, first = srt.indices, srt.values
    for w in reversed(words[:-1]):
        srt = torch.sort(w.index_select(0, order), stable=True)
        order, first = order.index_select(0, srt.indices), srt.values
    return order, first


def presort_sorted(keys: List[PresortKey], n: int, device: torch.device, *,
                   nrows: Optional[int] = None, row_valid: Optional[torch.Tensor] = None
                   ) -> SortedWords:
    """The rows in window order, as K15 and K16 take them: ``keys[0]`` the
    partition's segment id (a narrowed field: ``kmin`` 0), the rest the
    ORDER BY keys. One group of K11 words, one stable ``torch.sort`` a
    word as ``presort_order`` sorts them, and each word in sorted order;
    ``part_shift`` counts the bits of word 0 below the segment id, and
    ``real_below`` marks the rows that are not real (sorted last). The
    JAX package sorts by the keys and then stably by the segment
    (``relational.py:1548-1553``)."""
    words, groups = _presort_words(keys, n, device, nrows, row_valid)
    shift = presort_bits(groups[0][1:], False)
    unreal = has_unreal_rows(n, nrows, row_valid)
    below = real_below(presort_bits(groups[0], True)) if unreal else None
    order, first = _lsd_order(words)
    return SortedWords(order, [first] + [w.index_select(0, order) for w in words[1:]], shift,
                       below)


def device_sort(blocks: TorchBlocks, sorts: List[Tuple[str, bool, Optional[bool]]],
                limit: Optional[int] = None, offset: Optional[int] = None) -> TorchBlocks:
    """ORDER BY [LIMIT/OFFSET] (``relational.py:1389``): the rows of the
    ``[offset, offset + limit)`` window of the order as a prefix frame.
    Each sort item is ``(column, ascending, nulls first)``, nulls last
    where that is None, as the JAX package's host runner has it
    (``:1398``). The order is ``presort_order``'s (K11 words, one stable
    ``torch.sort`` a word, real rows first); one readback of the row count
    (the export boundary, as there), then one K10 gather of every column
    (``blocks.gather_indices``). With no sort item, plain LIMIT/OFFSET in
    row order."""
    keys: List[PresortKey] = []
    for name, asc, nulls_first in sorts:
        keys += sort_code_columns(blocks, [(name, asc)], bool(nulls_first))
    order = presort_order(keys, blocks.padded_nrows, blocks.device, **groupby.frame_rows(blocks))
    n = blocks.nrows  # the one readback
    start = min(offset or 0, n)
    stop = n if limit is None else min(n, start + limit)
    return gather_indices(blocks, order[start:stop], scattered=True)


def device_take(blocks: TorchBlocks, n: int, sorts: Dict[str, bool], na_position: str,
                partition_by: List[str]) -> TorchBlocks:
    """``relational.py:1301``: the first ``n`` rows of each partition (or
    of the frame) under the presort, rows kept in their place with the
    frame's validity flipped and the count lazy. The partition's segment
    id leads the sort words (K11); K7 counts each partition's rows for its
    first sorted position; K12 keeps the ranks below ``n``, reading each
    position's partition from the first word in sorted order (the values
    of its last sort), where the "not real" bit above it puts the rows
    that are not real out of range; with no partition, that bit alone is
    the segment. No readback but the sort path's group count where the
    partition keys take it."""
    device = blocks.device
    keys = sort_code_columns(blocks, list(sorts.items()), na_position == "first")
    starts: Optional[torch.Tensor] = None
    if partition_by:
        for k in partition_by:
            if k not in blocks.columns:
                raise KeyError(f"{k} is not a column of the frame")
        fr = groupby.factorize_keys(blocks, partition_by)
        S = max(fr.num_segments, 1)
        # the field covers the sentinel of the rows that are not real
        keys = [PresortKey(fr.seg, kmin=0, bits=S.bit_length())] + keys
        counts = _build(fr.seg, S, blocks, None)
        starts = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    p = blocks.padded_nrows
    rows = groupby.frame_rows(blocks)
    words, groups = _presort_words(keys, p, device, rows.get("nrows"), rows.get("row_valid"))
    limit = torch.full((), n, dtype=torch.int64, device=device)
    if not words:  # no key and every row real
        keep, count = rank_keep(torch.arange(p, dtype=torch.int64, device=device), limit=limit)
        return keep_rows(blocks, keep, count)
    order, first = _lsd_order(words)
    where: Dict[str, Any] = {}
    if starts is not None:
        where = dict(seg=first, word_shift=presort_bits(groups[0][1:], False), starts=starts)
    elif has_unreal_rows(p, rows.get("nrows"), rows.get("row_valid")):
        where = dict(seg=first, word_shift=presort_bits(groups[0], True) - 1,
                     starts=torch.zeros((1,), dtype=torch.int64, device=device))
    keep, count = rank_keep(order, limit=limit, mode="lt", **where)
    return keep_rows(blocks, keep, count)


def device_sample(blocks: TorchBlocks, n: Optional[int], frac: Optional[float],
                  seed: Optional[int]) -> TorchBlocks:
    """Sampling without replacement (``relational.py:2176``): each row
    draws a distinct priority from one seeded ``torch.randperm`` (rows
    that are not real the priority ``len``), one ``torch.sort`` orders
    them, and K12 keeps the first ``k`` positions: ``k = min(n, nvalid)``
    or ``min(round(nvalid * frac), nvalid)`` (half to even), computed on
    the card, so a lazy count stays lazy. The same seed keeps the same
    rows; no seed draws one."""
    if seed is None:
        seed = int(np.random.default_rng().integers(0, 2**31 - 1))
    device = blocks.device
    p = blocks.padded_nrows
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pri = torch.randperm(p, generator=gen, device=device, dtype=torch.int32)
    order = torch.sort(torch.where(blocks.validity(), pri, p)).indices
    nvalid = blocks.nrows_tensor().to(torch.int64)
    if n is not None:
        k = torch.full((), int(n), dtype=torch.int64, device=device)
    else:
        k = torch.round(nvalid.to(torch.float64) * float(frac)).to(torch.int64)  # type: ignore
    keep, count = rank_keep(order, limit=torch.minimum(k, nvalid), mode="lt")
    return keep_rows(blocks, keep, count)


def hash_partition_order(blocks: TorchBlocks, by: List[str], num: int) -> torch.Tensor:
    """The real rows (int64, as many as the frame holds) ordered for
    ``repartition`` by hash into ``num`` partitions
    (``execution_engine.py:1551-1564``): by ``(segment id % num, segment
    id)`` of the keys ``by``, so that equal keys stay together where
    distinct keys share a partition, ties in row order. One K11 word of
    the two narrowed fields, one stable ``torch.sort``; the row count is
    read back."""
    fr = groupby.factorize_keys(blocks, by)
    S = max(fr.num_segments, 1)
    keys = [PresortKey(torch.remainder(fr.seg, num), kmin=0, bits=(num - 1).bit_length()),
            PresortKey(fr.seg, kmin=0, bits=S.bit_length())]
    order = presort_order(keys, blocks.padded_nrows, blocks.device, **groupby.frame_rows(blocks))
    return order[: blocks.nrows]
