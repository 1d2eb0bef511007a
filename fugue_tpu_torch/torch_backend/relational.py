"""Joins on the card: the port of the one-device join programs of
``fugue_tpu/jax_backend/relational.py``.

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
dictionaries. The kernels run where the tensors lie on CUDA, their plain
twins (``kernels/reference.py``) where they lie on the CPU; there is no
fallback between them. ``not_in_join`` waits for the SQL front end
(ROADMAP.md queue 1 item 4), the multi-device branches for item 12.
"""

from typing import Dict, List, Optional, Tuple

import torch

from fugue_tpu_torch.kernels.gather import gather_rows_cuda
from fugue_tpu_torch.kernels.join import join_build_cuda, join_expand_cuda, join_probe_cuda
from fugue_tpu_torch.kernels.reference import (
    GatherColumn,
    Probe,
    gather_rows_reference,
    join_build_reference,
    join_expand_reference,
    join_probe_reference,
)
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend import expr_eval, groupby, strings
from fugue_tpu_torch.torch_backend.blocks import TorchBlocks, TorchColumn, padded_len, torch_dtype

# the readbacks of the joins' own output sizes in this process (one a
# readback: M, or M and R together for full outer); the factorization's
# own readback on the sort path is not counted here
readbacks = 0


def _ones(mask: Optional[torch.Tensor], n: int, device: torch.device) -> torch.Tensor:
    return mask if mask is not None else torch.ones((n,), dtype=torch.bool, device=device)


def _merged_stats(c1: TorchColumn, c2: TorchColumn) -> Optional[Tuple[int, int]]:
    if c1.stats is None or c2.stats is None:
        return None
    return (min(c1.stats[0], c2.stats[0]), max(c1.stats[1], c2.stats[1]))


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


def _stack(b1: TorchBlocks, b2: TorchBlocks, pairs: Pairs) -> TorchBlocks:
    """The columns of ``pairs`` (side 1's, side 2's) stacked along the rows
    (side 1 first), their masks (all valid where a side has none), merged
    stats, and the rows of both: a prefix frame where both sides are
    prefix frames with no padding, else a masked frame with both
    validities stacked (a lazy count where either side's is)."""
    device = b1.device
    p1, p2 = b1.padded_nrows, b2.padded_nrows
    cols: Dict[str, TorchColumn] = {}
    for n, (c1, c2) in pairs.items():
        dt = torch.promote_types(c1.data.dtype, c2.data.dtype)
        mask = None
        if c1.mask is not None or c2.mask is not None:
            mask = torch.cat([_ones(c1.mask, p1, device), _ones(c2.mask, p2, device)])
        cols[n] = TorchColumn(c1.pa_type, torch.cat([c1.data.to(dt), c2.data.to(dt)]), mask,
                              _merged_stats(c1, c2), dictionary=c1.dictionary)
    full = all(b.row_valid is None and b.nrows == b.padded_nrows for b in (b1, b2))
    if full:
        return TorchBlocks(p1 + p2, cols, device)
    nrows = b1._nrows + b2._nrows if b1.nrows_known and b2.nrows_known else None
    nrows_dev = None if nrows is not None else b1.nrows_tensor() + b2.nrows_tensor()
    return TorchBlocks(nrows, cols, device, row_valid=torch.cat([b1.validity(), b2.validity()]),
                       nrows_dev=nrows_dev)


def concat_key_blocks(b1: TorchBlocks, b2: TorchBlocks, keys: List[str]
                      ) -> Tuple[TorchBlocks, Pairs]:
    """Both sides' key columns stacked along the rows, side 1 first
    (``relational.py:116``), string keys in one dictionary
    (``harmonize_string_keys``, ``:133``): the combined frame and each
    key's two columns. A side's rows that are not real stay so in the
    combined frame, so the factorization sees them as non-rows."""
    pairs = _harmonized(b1, b2, keys)
    return _stack(b1, b2, pairs), pairs


class SharedFactorization:
    """Both sides' keys in one segment space (``relational.py:207``):
    ``seg1`` int32 [p1] and ``seg2`` int32 [p2], each with the sentinel
    ``num_segments`` on rows that are not real; ``keys`` each key's two
    columns, string keys in one dictionary."""

    def __init__(self, seg1: torch.Tensor, seg2: torch.Tensor, num_segments: int, keys: Pairs):
        self.seg1 = seg1
        self.seg2 = seg2
        self.num_segments = num_segments
        self.keys = keys


def shared_factorize(b1: TorchBlocks, b2: TorchBlocks, keys: List[str]) -> SharedFactorization:
    """One factorization of the stacked keys (``groupby.factorize_keys``:
    K1 where they bin, else the sort path with its one readback of the
    group count), cut into the two sides (``relational.py:227-245``)."""
    combined, pairs = concat_key_blocks(b1, b2, keys)
    fr = groupby.factorize_keys(combined, keys)
    p1 = b1.padded_nrows
    return SharedFactorization(fr.seg[:p1], fr.seg[p1:], fr.num_segments, pairs)


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
           slots: bool = False) -> torch.Tensor:
    run = groupby._kernel(seg, join_build_cuda, join_build_reference, "join build")
    return run(seg, num, nulls=nulls, slots=slots, **groupby.frame_rows(b))


def _probe(seg: torch.Tensor, table: torch.Tensor, mode: str, b: TorchBlocks,
           nulls: Optional[torch.Tensor], outer: bool = False) -> Probe:
    run = groupby._kernel(seg, join_probe_cuda, join_probe_reference, "join probe")
    return run(seg, table, mode, nulls=nulls, outer=outer, **groupby.frame_rows(b))


def _gather(columns: Dict[str, TorchColumn], idx: torch.Tensor, outer: bool
            ) -> Dict[str, TorchColumn]:
    """K10 over ``columns`` by ``idx``, each result with its source's
    type and stats."""
    run = groupby._kernel(idx, gather_rows_cuda, gather_rows_reference, "gather rows")
    got = run([GatherColumn(c.data, c.mask) for c in columns.values()], idx, outer=outer)
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
    expand = groupby._kernel(start, join_expand_cuda, join_expand_reference, "join expand")
    li, ri = expand(start, pr.m, seg1, cstart2, order2, M)
    out_pad = padded_len(M)
    li, ri = _pad_index(li, out_pad, 0), _pad_index(ri, out_pad, -1)
    d1 = {n: b1.columns[n] for n in schema1.names}
    if un2 is not None:
        # full outer: the keys in the shared dictionary, so that the right
        # rows with no match append with no second re-coding (``:534``)
        d1.update({k: c1 for k, (c1, _) in key_pairs.items()})
    d2 = {n: b2.columns[n] for n in schema2.names if n not in schema1}
    g = {**_gather(d1, li, outer=False), **_gather(d2, ri, outer=outer_left)}
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
    return _stack(b1, b2, _harmonized(b1, b2, list(b1.columns)))
