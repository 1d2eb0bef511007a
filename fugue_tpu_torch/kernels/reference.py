"""Plain PyTorch twins of the port's CUDA kernels (``segment_sums.cu``,
``factorize.cu``, ``segment_reduce.cu``, ``expr_program.cu``, ``join.cu``,
``gather.cu``, ``row_select.cu``, ``window.cu``, ``comap.cu``,
``stream.cu``): the CPU path, and the oracle each kernel is held against
on the card."""

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from fugue_tpu_torch.kernels import expr_program as ep
from fugue_tpu_torch.utils.validity import materialize_validity

# a payload column and its null mask (True = valid; None: all valid)
Payload = Tuple[torch.Tensor, Optional[torch.Tensor]]
MAX_KEYS = 4  # key columns the fused kernel reads


class BinKey(NamedTuple):
    """One key column of the binned aggregate: its values (bool or an
    integer type, read in its own type), its null mask (True = valid), the
    smallest value ``kmin`` and the ``span`` of codes, the null bucket
    ``span - 1`` included where the key is masked."""

    data: torch.Tensor
    mask: Optional[torch.Tensor]
    kmin: int
    span: int


def bin_total(keys: Sequence[BinKey]) -> int:
    """The segment count: the product of the spans, below 2^31."""
    total = 1
    for k in keys:
        if int(k.span) < 1:
            raise ValueError(f"span {k.span} must be at least 1")
        total *= int(k.span)
    if total >= 2**31:
        raise ValueError(f"{total} segments: at most 2^31 - 1")
    return total


def bin_segments(keys: Sequence[BinKey], valid_rows: torch.Tensor) -> torch.Tensor:
    """Mixed-radix segment id per row, the first key most significant:
    the port's ``groupby.inline_seg`` (``fugue_tpu/jax_backend/groupby.py:120``).
    Invalid rows get the out-of-range sentinel ``bin_total(keys)``."""
    combined: Optional[torch.Tensor] = None
    for k in keys:
        key = k.data
        if key.dtype in (torch.bool, torch.int8, torch.int16, torch.uint8):
            # key - kmin may not fit the narrow type; it always fits int32
            key = key.to(torch.int32)
        # in the key's own type the difference may wrap in between, but
        # its true value lies in [0, span) and so comes out right
        code = (key - k.kmin).to(torch.int32)
        if k.mask is not None:
            code = torch.where(k.mask, code, k.span - 1)
        combined = code if combined is None else combined * k.span + code
    return torch.where(valid_rows, combined, bin_total(keys))  # type: ignore


def _binned_rows(
    keys: Sequence[BinKey], nrows: Optional[int], row_valid: Optional[torch.Tensor]
) -> torch.Tensor:
    """The rows a binned kernel accepts: real rows (a prefix frame's first
    ``nrows``, or a masked frame's non-zero ``row_valid`` bytes) whose
    every key code lies in ``[0, span)``."""
    if not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"{len(keys)} keys: the kernel takes 1 to {MAX_KEYS}")
    if (nrows is None) == (row_valid is None):
        raise ValueError("pass exactly one of nrows (prefix rows) and row_valid")
    n = int(keys[0].data.shape[0])
    valid = materialize_validity(row_valid, n, nrows, keys[0].data.device)
    for k in keys:
        code = k.data.to(torch.int64) - int(k.kmin)
        if k.mask is not None:
            code = torch.where(k.mask, code, int(k.span) - 1)
        valid = valid & (code >= 0) & (code < int(k.span))
    return valid


def binned_sums_reference(
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
    """Segment ids, row validity and per-segment sums of a binned
    aggregate: the twin of ``segment_sums.cu`` and of the per-row part of
    the JAX package's ``_binned_packed_aggregate`` program
    (``fugue_tpu/jax_backend/execution_engine.py:3500-3574``), built from
    ``bin_segments`` (``groupby.inline_seg``) and
    ``segment_sums_reference``.

    ``keys``: 1-4 ``BinKey``; a row with any code (``key - kmin``, or
    ``span - 1`` where null) outside ``[0, span)`` is dropped. Rows: pass
    ``nrows`` for a prefix frame (rows ``>= nrows`` are dropped) or
    ``row_valid`` for a masked frame (rows whose byte is zero are
    dropped). ``floats``: float32/float64 payloads with optional masks,
    summed in float64 if any is float64 or ``f64`` is set, else in
    float32; ``counts``:
    bool/uint8 flags, the accepted rows whose byte is non-zero counted in
    int32; ``ints``: integer payloads with optional masks, summed in
    int64. A masked payload adds only where its mask holds. With
    ``occupancy``, count row 0 counts every accepted row and the flags
    follow it. Returns ``([F, total], [occupancy + C, total], [I,
    total])``."""
    n = int(keys[0].data.shape[0])
    device = keys[0].data.device
    seg = bin_segments(keys, _binned_rows(keys, nrows, row_valid))
    fdtype = float_sum_dtype(floats, f64)

    def _pack(pays: Sequence[Payload], dtype: torch.dtype) -> torch.Tensor:
        rows = [(v if m is None else torch.where(m, v, 0)).to(dtype) for v, m in pays]
        if not rows:
            return torch.empty((0, n), dtype=dtype, device=device)
        return torch.stack(rows)

    flags = [torch.ones((n,), dtype=torch.bool, device=device)] if occupancy else []
    flags += [c != 0 for c in counts]
    cpack = torch.stack(flags) if flags else torch.empty((0, n), dtype=torch.bool, device=device)
    return segment_sums_reference(
        seg, _pack(floats, fdtype), cpack, _pack(ints, torch.int64), bin_total(keys)
    )


def float_sum_dtype(floats: Sequence[Payload], f64: bool = False) -> torch.dtype:
    """The dtype the fused kernel sums ``floats`` in: float64 where any is
    float64 or the caller asks for it (``f64``), else float32."""
    if f64 or any(v.dtype == torch.float64 for v, _ in floats):
        return torch.float64
    return torch.float32


def segment_sums_reference(
    seg: torch.Tensor,
    fpack: torch.Tensor,
    cpack: torch.Tensor,
    ipack: torch.Tensor,
    total: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-segment sums of packed payloads, with ``index_add_``; the twin
    of ``segment_sums.cu`` over precomputed segment ids and of
    ``groupby.segment_sums(strategy="scatter")`` in the JAX package
    (``fugue_tpu/jax_backend/groupby.py:219``).

    ``seg`` int32[n]; ``fpack`` [F, n] float32/float64, summed in its own
    dtype; ``cpack`` [C, n] bool or uint8, read as flags: the rows whose
    byte is non-zero are counted in int32; ``ipack`` [I, n] int64, summed
    in int64. Rows with ``seg < 0`` or ``seg >= total``
    contribute nothing. Returns ``([F, total], [C, total], [I, total])``."""
    keep = (seg >= 0) & (seg < total)
    # dropped rows land in one extra bin that is cut off at the end
    idx = torch.where(keep, seg, total).long()

    def _sums(pack: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        acc = torch.zeros((pack.shape[0], total + 1), dtype=dtype, device=seg.device)
        acc.index_add_(1, idx, pack.to(dtype))
        return acc[:, :total].contiguous()

    return (
        _sums(fpack, fpack.dtype),
        _sums(cpack != 0, torch.int32),
        _sums(ipack, torch.int64),
    )


def bin_factorize_reference(
    keys: Sequence[BinKey],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Binned key factorization: the twin of K1 in ``factorize.cu`` and of
    the JAX package's ``_bin_core`` (``fugue_tpu/jax_backend/groupby.py:481``).

    ``keys`` and the rows as for ``binned_sums_reference``: a row that is
    not real, or has a key code outside ``[0, span)``, has no bin. Returns
    ``(seg, first_idx, occupied, count)``: ``seg`` int32[n], the row's bin
    (``bin_total(keys)`` where it has none); ``first_idx`` int32[total],
    the first row of each bin, ``n - 1`` where the bin is empty;
    ``occupied`` bool[total]; ``count`` the occupied bins, an int32 0-d
    tensor."""
    n = int(keys[0].data.shape[0])
    device = keys[0].data.device
    valid = _binned_rows(keys, nrows, row_valid)
    seg = bin_segments(keys, valid)
    total = bin_total(keys)
    pos = torch.arange(n, dtype=torch.int32, device=device)
    # rows with no bin land in one extra bin that is cut off at the end
    first = torch.full((total + 1,), n, dtype=torch.int32, device=device)
    first.scatter_reduce_(0, seg.long(), torch.where(valid, pos, n), "amin")
    first = first[:total]
    occupied = first < n
    return seg, first.clamp(max=n - 1), occupied, occupied.sum(dtype=torch.int32)


def _code_bits(c: torch.Tensor) -> torch.Tensor:
    """A sort code as the integers the kernel compares: floats bit for bit
    (they come canonical: no NaN, no -0.0)."""
    if c.dtype == torch.float32:
        return c.view(torch.int32)
    if c.dtype == torch.float64:
        return c.view(torch.int64)
    return c


def sort_boundaries_reference(
    codes: Sequence[torch.Tensor],
    order: torch.Tensor,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    first_sorted: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group ids in sorted order: the twin of K2 in ``factorize.cu`` and of
    the boundary-and-scan tail of the JAX package's
    ``_sort_factorize_core`` (``fugue_tpu/jax_backend/groupby.py:554``).

    ``order`` int64[n] is the sorted permutation of the rows, real rows
    first (a prefix frame's rows below ``nrows``, or a masked frame's
    non-zero ``row_valid`` bytes); a real position opens a group where any
    of ``codes`` differs from the position before it, and the first real
    position always does. ``first_sorted``, where given, is ``codes[0]``
    in sorted order (``codes[0][order]``, as the sort's values give it),
    taken in place of that gather. Returns ``(seg_sorted, count)``:
    ``seg_sorted`` int32[n] the group of each sorted position, -1 where it
    is not real; ``count`` the groups, an int32 0-d tensor."""
    if (nrows is None) == (row_valid is None):
        raise ValueError("pass exactly one of nrows (prefix rows) and row_valid")
    n = int(order.shape[0])
    real = row_valid[order] != 0 if row_valid is not None else order < nrows
    opens = torch.zeros((n,), dtype=torch.bool, device=order.device)
    opens[0] = True
    for j, c in enumerate(codes):
        sc = _code_bits(first_sorted if j == 0 and first_sorted is not None else c[order])
        opens[1:] |= sc[1:] != sc[:-1]
    opens &= real
    seg_sorted = torch.cumsum(opens, 0, dtype=torch.int32) - 1
    return torch.where(real, seg_sorted, -1), opens.sum(dtype=torch.int32)


def sort_finish_reference(
    seg_sorted: torch.Tensor, order: torch.Tensor, num: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group ids in row order and the first row of each group: the twin of
    K3 in ``factorize.cu`` and of the JAX package's
    ``_sort_factorize_finish`` (``fugue_tpu/jax_backend/groupby.py:582``).

    ``seg_sorted`` and ``order`` as ``sort_boundaries_reference`` takes and
    gives them, ``num`` the group count. Returns ``(seg, first_idx)``:
    ``seg`` int32[n], ``num`` where the row is not real; ``first_idx``
    int32[num], the row at each group's first sorted position."""
    n = int(order.shape[0])
    real = seg_sorted >= 0
    seg = torch.empty((n,), dtype=torch.int32, device=order.device)
    seg.scatter_(0, order, torch.where(real, seg_sorted, num))
    opens = real.clone()
    opens[1:] &= seg_sorted[1:] != seg_sorted[:-1]
    first_idx = torch.empty((num,), dtype=torch.int32, device=order.device)
    first_idx[seg_sorted[opens].long()] = order[opens].to(torch.int32)
    return seg, first_idx


def sort_factorize_reference(
    codes: Sequence[torch.Tensor],
    order: torch.Tensor,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The sort path after the sorts, as the twins of K2 and K3 with the
    one readback of the group count between them (``groupby.py:548``):
    ``(seg, first_idx, num)``."""
    seg_sorted, count = sort_boundaries_reference(
        codes, order, nrows=nrows, row_valid=row_valid
    )
    num = int(count)
    seg, first_idx = sort_finish_reference(seg_sorted, order, num)
    return seg, first_idx, num


# the bits of each key dtype's field in the sort word
_FIELD_BITS = {
    torch.bool: 1, torch.uint8: 8, torch.int8: 8, torch.int16: 16, torch.int32: 32,
    torch.float32: 32, torch.int64: 64, torch.float64: 64,
}
_INT64_TOP = -(2**63)
_INT64_WORDS_TOP = -(2**63) + 2**31  # the top bit of both int32 words of an int64


class SortWord(NamedTuple):
    """One order-preserving sort word per row, and the rows it marks as
    not real.

    - ``word``: int32 or int64 per row; a signed sort of it orders the rows
      as the JAX package's lexicographic sort of its key codes, real rows
      first;
    - ``real_below``: the rows whose word is ``>= real_below`` are not
      real; None where every row is."""

    word: torch.Tensor
    real_below: Optional[int]


def word_bits(keys: Sequence[Payload], unreal: bool) -> int:
    """The bits of the sort word of ``keys`` (each its values and null
    mask): 1 for ``unreal`` (the frame has rows that are not real), and
    per key 1 for a null mask, 1 for bool, 8 for int8/uint8, 16 for int16,
    32 for int32/float32, 64 for int64/float64."""
    bits = int(unreal)
    for v, mask in keys:
        if v.dtype not in _FIELD_BITS:
            raise ValueError(f"no sort word field for dtype {v.dtype}")
        bits += _FIELD_BITS[v.dtype] + (mask is not None)
    return bits


def has_unreal_rows(n: int, nrows: Optional[int], row_valid: Optional[torch.Tensor]) -> bool:
    """Whether a frame of ``n`` padded rows may hold rows that are not
    real: a masked frame, or a prefix frame with ``nrows`` below ``n``."""
    if (nrows is None) == (row_valid is None):
        raise ValueError("pass exactly one of nrows (prefix rows) and row_valid")
    return row_valid is not None or int(nrows) < n  # type: ignore[arg-type]


def real_below(bits: int) -> int:
    """The smallest signed word whose top field (of a ``bits``-bit word)
    is set: the "not real" bit's threshold. Flipping the container's top
    bit maps the unsigned field value ``u`` to ``u - 2^(C - 1)``."""
    container = 32 if bits <= 32 else 64
    return (1 << (bits - 1)) - (1 << (container - 1))


def _word_field(v: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """A key's field of the sort word as the unsigned bits in an int64,
    and its width: integers offset by their type's minimum; an int64 as its
    two int32 words swapped, each offset (the low word orders first, as
    ``bitcast_convert_type`` has it); a float with -0.0 as +0.0 and its
    bits flipped to order as unsigned, NaN as all ones (above +inf)."""
    width = _FIELD_BITS[v.dtype]
    if v.dtype in (torch.bool, torch.uint8):
        return v.to(torch.int64), width
    if v.dtype in (torch.int8, torch.int16, torch.int32):
        return v.to(torch.int64) + (1 << (width - 1)), width
    if v.dtype == torch.int64:
        return ((v << 32) | ((v >> 32) & 0xFFFFFFFF)) ^ _INT64_WORDS_TOP, width
    canon = torch.where(v == 0, torch.zeros_like(v), v)
    if v.dtype == torch.float32:
        b = canon.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        f = torch.where(b >= 2**31, b ^ 0xFFFFFFFF, b | 2**31)
        return torch.where(torch.isnan(v), 0xFFFFFFFF, f), width
    b = canon.view(torch.int64)
    f = torch.where(b < 0, ~b, b ^ _INT64_TOP)
    return torch.where(torch.isnan(v), -1, f), width


class PresortKey(NamedTuple):
    """One key of KW's presort mode (K11), and of its factorize mode with
    every option at its default.

    - ``values``, ``mask``: the key's values (bool, uint8, int8-64,
      float32/64) and null mask (True = valid; None: every row valid);
    - ``desc``: the field inverted, so that one ascending sort orders the
      key descending with ties kept in the order of the less significant
      fields;
    - ``nulls_first``: the null flag inverted (nulls before the values);
    - ``nan_is_null``: a float NaN is null (its flag set, its field 0), as
      the JAX package's ``_sort_code_columns`` has it; else NaN is its own
      value above +inf, as the group-by has it;
    - ``kmin``: where given, an integer key's field is ``value - kmin`` in
      ``bits`` bits (a range known from the column's stats, or the type's
      own), else the dtype's natural field (``_word_field``, whose int64
      field orders as the group-by's codes, low word first, not by value);
    - ``flag``, ``value``: whether the word holds this key's null flag and
      its field; a key wider than what is left of a word puts its flag at
      the end of one word and its field in the next."""

    values: torch.Tensor
    mask: Optional[torch.Tensor] = None
    desc: bool = False
    nulls_first: bool = False
    nan_is_null: bool = False
    kmin: Optional[int] = None
    bits: int = 0
    flag: bool = True
    value: bool = True


def key_has_flag(k: PresortKey) -> bool:
    """Whether the key has a null flag: a mask, or NaN read as null."""
    return k.mask is not None or (k.nan_is_null and k.values.is_floating_point())


def key_field_bits(k: PresortKey) -> int:
    """The width of the key's value field: ``bits`` where narrowed, else
    its dtype's (``_FIELD_BITS``)."""
    if k.values.dtype not in _FIELD_BITS:
        raise ValueError(f"no sort word field for dtype {k.values.dtype}")
    return int(k.bits) if k.kmin is not None else _FIELD_BITS[k.values.dtype]


def presort_bits(keys: Sequence[PresortKey], unreal: bool) -> int:
    """The bits of the word of ``keys``: 1 for ``unreal``, and per key its
    flag and its field where the word holds them."""
    return int(unreal) + sum((k.flag and key_has_flag(k)) + (key_field_bits(k) if k.value else 0)
                             for k in keys)


def _low_mask(width: int) -> int:
    return -1 if width >= 64 else (1 << width) - 1


def presort_word_reference(
    keys: Sequence[PresortKey],
    *,
    unreal: bool = False,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The sort word of ``keys``: the twin of KW's presort mode (K11) in
    ``factorize.cu``, the order of the JAX package's ``_stable_sort_order``
    (``fugue_tpu/jax_backend/relational.py:1265``) over the codes of
    ``_sort_code_columns`` (``:1234``).

    The fields, most significant first: "not real" where ``unreal`` (the
    rows as ``nrows`` or ``row_valid``), then per key its null flag (where
    it has one: set on a null, inverted under ``nulls_first``) and its
    field (zero where null, inverted under ``desc``). A signed sort of the
    word orders the rows by the fields as unsigned numbers, which is that
    loop's order: each key ascending or descending, its nulls first or
    last, ties in the order of the next key. Returns int32 words when the
    fields take at most 32 bits, int64 at most 64; raises ``ValueError``
    over 64."""
    if keys:
        n, device = int(keys[0].values.shape[0]), keys[0].values.device
    elif unreal and row_valid is not None:
        n, device = int(row_valid.shape[0]), row_valid.device
    else:
        raise ValueError("a sort word of no key takes the unreal flag and a row_valid tensor")
    bits = presort_bits(keys, unreal)
    if bits > 64:
        raise ValueError(f"the keys take {bits} bits: a sort word holds 64")
    u = torch.zeros((n,), dtype=torch.int64, device=device)
    if unreal:
        u = (~materialize_validity(row_valid, n, nrows, device)).to(torch.int64)
    for k in keys:
        v = k.values
        null = torch.zeros((n,), dtype=torch.bool, device=device) if k.mask is None else ~k.mask
        if k.nan_is_null and v.is_floating_point():
            null = null | torch.isnan(v)
        width = key_field_bits(k)
        if k.kmin is not None:
            f = (v.to(torch.int64) - int(k.kmin)) & _low_mask(width)
        else:
            f = _word_field(v)[0]
        if k.desc:
            f = ~f & _low_mask(width)
        f = torch.where(null, 0, f)
        if k.flag and key_has_flag(k):
            u = (u << 1) | (null ^ k.nulls_first).to(torch.int64)
        if k.value:
            u = f if width == 64 else (u << width) | f
    return (u - 2**31).to(torch.int32) if bits <= 32 else u ^ _INT64_TOP


def sort_word_reference(
    keys: Sequence[Payload],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> SortWord:
    """The sort word of ``keys``: the twin of KW in ``factorize.cu``, in
    the order of the JAX package's sort codes (``_sort_factorize``,
    ``fugue_tpu/jax_backend/groupby.py:507-546``) and its validity sort.

    ``keys``: each its values (bool, uint8, int8-64, float32/64) and null
    mask (True = valid). The fields, most significant first: "not real"
    where the frame may hold such rows (``has_unreal_rows``), then per key
    its null flag (a masked key) and its field (``_word_field``), zero
    where null: ``presort_word_reference`` with every option at its
    default. The word is an int32 when the fields take at most 32 bits, an
    int64 at most 64, with its top bit flipped so that a signed sort
    orders it as unsigned. Raises ``ValueError`` over 64 bits."""
    n = int(keys[0][0].shape[0])
    unreal = has_unreal_rows(n, nrows, row_valid)
    bits = word_bits(keys, unreal)
    if bits > 64:
        raise ValueError(f"the keys take {bits} bits: a sort word holds 64")
    word = presort_word_reference([PresortKey(v, m) for v, m in keys], unreal=unreal,
                                  nrows=nrows, row_valid=row_valid)
    return SortWord(word, real_below(bits) if unreal else None)


def sort_word_boundaries_reference(
    sorted_words: torch.Tensor,
    order: torch.Tensor,
    *,
    real_below: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group boundaries over sorted words: the twin of K2w in
    ``factorize.cu`` and of the boundary-and-scan tail of the JAX
    package's ``_sort_factorize_core`` (``fugue_tpu/jax_backend/groupby.py:554``).

    ``sorted_words`` int32/int64[n] is ``SortWord.word`` in its sorted
    order, ``order`` int64[n] the sort's permutation; a position is real
    where its word is below ``real_below`` (every position where None), and
    a real position opens a group where its word differs from the one
    before. Returns ``(uniq, first_idx, seg_sorted, count)``: ``uniq``
    [n] and ``first_idx`` int32[n], whose first ``count`` entries are each
    group's word and first row (the row at its first sorted position; the
    rest is unspecified: zeros here); ``seg_sorted`` int32[n], the group
    of each sorted position, -1 where it is not real; ``count`` the
    groups, an int32 0-d tensor."""
    n = int(sorted_words.shape[0])
    if real_below is None:
        real = torch.ones((n,), dtype=torch.bool, device=sorted_words.device)
    else:
        real = sorted_words < real_below
    opens = real.clone()
    opens[1:] &= sorted_words[1:] != sorted_words[:-1]
    seg_sorted = torch.where(real, torch.cumsum(opens, 0, dtype=torch.int32) - 1, -1)
    count = opens.sum(dtype=torch.int32)
    num = int(count)
    uniq = torch.zeros_like(sorted_words)
    uniq[:num] = sorted_words[opens]
    first_idx = torch.zeros((n,), dtype=torch.int32, device=sorted_words.device)
    first_idx[:num] = order[opens].to(torch.int32)
    return uniq, first_idx, seg_sorted.to(torch.int32), count


def sort_word_lookup_reference(
    words: torch.Tensor,
    uniq: torch.Tensor,
    num: int,
    *,
    real_below: Optional[int] = None,
) -> torch.Tensor:
    """Group ids in row order by lookup: the twin of K3w in
    ``factorize.cu`` and, with ``first_idx`` from K2w, of the JAX
    package's ``_sort_factorize_finish``
    (``fugue_tpu/jax_backend/groupby.py:582``).

    ``words`` is ``SortWord.word`` in row order, ``uniq`` K2w's distinct
    words (the first ``num`` entries are read). Returns ``seg`` int32[n]:
    each real row's index among them, ``num`` where the row is not real
    (its word is at or above ``real_below``)."""
    seg = torch.searchsorted(uniq[:num].contiguous(), words).to(torch.int32)
    if real_below is not None:
        seg = torch.where(words < real_below, seg, num)
    return seg


class Extremum(NamedTuple):
    """A payload of ``segment_extrema``: its values (bool, uint8, int8-64,
    float32/64), its null mask (True = valid; None: every row valid), and
    whether its per-segment ``min`` and ``max`` are wanted."""

    values: torch.Tensor
    mask: Optional[torch.Tensor]
    min: bool
    max: bool


class Extrema(NamedTuple):
    """What ``segment_extrema`` gives: per payload its min and max over
    each segment (None where not wanted), in the payload's dtype, and the
    first and last counted row of each segment (int32, -1 where the
    segment has none; None where not wanted)."""

    mins: List[Optional[torch.Tensor]]
    maxs: List[Optional[torch.Tensor]]
    first: Optional[torch.Tensor]
    last: Optional[torch.Tensor]


def extremum_fill(dtype: torch.dtype, is_max: bool) -> float:
    """An empty segment's min (``is_max`` False) or max: the type's largest
    or smallest value, as the JAX package fills them (``_type_max`` and
    ``_type_min``, ``fugue_tpu/jax_backend/groupby.py:729-743``)."""
    if dtype.is_floating_point:
        return float("-inf") if is_max else float("inf")
    if dtype == torch.bool:
        return not is_max
    info = torch.iinfo(dtype)
    return info.min if is_max else info.max


_I64_MIN, _I64_MAX = -(2**63), 2**63 - 1
_MAGNITUDE = {torch.float32: 0x7FFFFFFF, torch.float64: _I64_MAX}


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the order of ``v``, with -0.0 below
    +0.0 (a float's bits, the magnitude bits flipped where it is
    negative). NaN is left to the caller."""
    if v.dtype == torch.float32:
        b = v.view(torch.int32).to(torch.int64)
    elif v.dtype == torch.float64:
        b = v.view(torch.int64)
    else:
        return v.to(torch.int64)
    return torch.where(b < 0, b ^ _MAGNITUDE[v.dtype], b)


def _from_order_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return torch.where(k < 0, k ^ _MAGNITUDE[dtype], k).to(torch.int32).view(dtype)
    if dtype == torch.float64:
        return torch.where(k < 0, k ^ _MAGNITUDE[dtype], k).view(dtype)
    return k.to(dtype)


def _segment_rows(seg: torch.Tensor, num: int, nrows: Optional[int],
                  row_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The rows a segment reduction counts: real (a prefix frame's first
    ``nrows``, or a masked frame's non-zero ``row_valid`` bytes) and with
    ``seg`` in ``[0, num)``."""
    if (nrows is None) == (row_valid is None):
        raise ValueError("pass exactly one of nrows (prefix rows) and row_valid")
    n = int(seg.shape[0])
    valid = materialize_validity(row_valid, n, nrows, seg.device)
    return valid & (seg >= 0) & (seg < num)


def segment_extrema_reference(
    seg: torch.Tensor,
    num: int,
    payloads: Sequence[Extremum],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    first: bool = False,
    last: bool = False,
) -> Extrema:
    """Per-segment min and max of each payload, and the first and last row
    of each segment: the twin of K4 in ``segment_reduce.cu`` and of the
    scatter-min/max of the JAX package's ``_segment_agg_impl``
    (``fugue_tpu/jax_backend/groupby.py:647-656``, ``:711-718``), with
    ``scatter_reduce_(include_self=False)``.

    ``seg`` int32[n]; a row counts where ``seg`` lies in ``[0, num)`` and
    the row is real (``nrows`` or ``row_valid`` as for
    ``binned_sums_reference``); a payload takes only the counted rows where
    its mask holds. The rules of the JAX package on the CPU, made
    explicit: NaN wins both the min and the max (it propagates, as
    ``segment_min`` and ``jnp.min`` do), -0.0 is below +0.0, and a segment
    with no row gets ``extremum_fill``. ``num`` is at least 1."""
    if num < 1:
        raise ValueError(f"num {num} must be at least 1")
    n = int(seg.shape[0])
    device = seg.device
    real = _segment_rows(seg, num, nrows, row_valid)
    mins: List[Optional[torch.Tensor]] = []
    maxs: List[Optional[torch.Tensor]] = []
    for p in payloads:
        keep = real if p.mask is None else real & p.mask
        # rows that are not kept land in one extra bucket, cut off below
        idx = torch.where(keep, seg, num).long()
        key = _order_key(p.values)
        nan = torch.isnan(p.values) if p.values.dtype.is_floating_point else None
        for want, is_max, out in ((p.min, False, mins), (p.max, True, maxs)):
            if not want:
                out.append(None)
                continue
            k = key
            if nan is not None:
                k = torch.where(nan, _I64_MAX if is_max else _I64_MIN, key)
            fill = _order_key(torch.tensor([extremum_fill(p.values.dtype, is_max)],
                                           dtype=p.values.dtype, device=device))
            table = fill.expand(num + 1).clone()
            table.scatter_reduce_(0, idx, k, "amax" if is_max else "amin", include_self=False)
            res = _from_order_key(table[:num], p.values.dtype)
            if nan is not None:
                res = torch.where(table[:num] == (_I64_MAX if is_max else _I64_MIN),
                                  float("nan"), res)
            out.append(res)
    rows_out: List[Optional[torch.Tensor]] = []
    idx = torch.where(real, seg, num).long()
    pos = torch.arange(n, dtype=torch.int64, device=device)
    for want, how in ((first, "amin"), (last, "amax")):
        if not want:
            rows_out.append(None)
            continue
        table = torch.full((num + 1,), -1, dtype=torch.int64, device=device)
        table.scatter_reduce_(0, idx, pos, how, include_self=False)
        rows_out.append(table[:num].to(torch.int32))
    return Extrema(mins, maxs, rows_out[0], rows_out[1])


def segment_sq_dev_reference(
    seg: torch.Tensor,
    num: int,
    payloads: Sequence[Payload],
    means: torch.Tensor,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment sums of squared deviations from the segment's mean in
    float64: the twin of K5 in ``segment_reduce.cu`` and of the second
    pass of the JAX package's two-pass variance
    (``fugue_tpu/jax_backend/groupby.py:676-678``), with ``index_add_``.

    ``seg`` and the rows as for ``segment_extrema_reference``;
    ``payloads`` float32/float64 with optional masks (a payload adds only
    the counted rows where its mask holds); ``means`` float64 [P, num].
    Returns float64 [P, num]: the sum of ``(x - means[p, seg])^2``.
    ``num`` is at least 1."""
    if num < 1:
        raise ValueError(f"num {num} must be at least 1")
    device = seg.device
    real = _segment_rows(seg, num, nrows, row_valid)
    segc = seg.clamp(0, num - 1).long()
    out = torch.zeros((len(payloads), num + 1), dtype=torch.float64, device=device)
    for q, (v, m) in enumerate(payloads):
        keep = real if m is None else real & m
        d = v.to(torch.float64) - means[q].index_select(0, segc)
        out[q].index_add_(0, torch.where(keep, seg, num).long(), torch.where(keep, d * d, 0.0))
    return out[:, :num].contiguous()


# a register of K6's twin: values (rows, or 0-d for a constant) and
# validity (None: every row valid)
_Reg = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _valid_of(r: _Reg) -> torch.Tensor:
    v, m = r
    return torch.ones_like(v, dtype=torch.bool) if m is None else m


def _and_valid(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _cast_values(x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """K6's cast rule: floats to integers by truncation with NaN as 0 and
    saturation at the type's bounds; anything to bool as ``x != 0``; the
    rest as torch converts (integers wrap, floats round to nearest)."""
    dtype = ep.DTYPES[dst]
    if dst == ep.B:
        return x != 0
    if src not in ep._FLOATS or dst in ep._FLOATS:
        return x.to(dtype)
    lo, hi = ep.int_bounds(dst)
    nan, above, below = torch.isnan(x), x >= float(hi + 1), x < float(lo)
    safe = torch.where(nan | above | below, torch.zeros_like(x), x).trunc()
    out = safe.to(dtype)
    out = torch.where(above, torch.tensor(hi, dtype=dtype, device=x.device), out)
    return torch.where(below, torch.tensor(lo, dtype=dtype, device=x.device), out)


def _sign(x: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x if x.is_floating_point()
                                               else torch.zeros_like(x)))


_FLOAT_OPS = {
    "SQRT": torch.sqrt, "EXP": torch.exp, "LN": torch.log, "LOG2": torch.log2,
    "LOG10": torch.log10, "SIN": torch.sin, "COS": torch.cos, "TAN": torch.tan,
    "FLOOR": torch.floor, "CEIL": torch.ceil,
}
_CMP_OPS = {"EQ": torch.eq, "NE": torch.ne, "LT": torch.lt, "LE": torch.le, "GT": torch.gt,
            "GE": torch.ge}


def _step(ins: "ep.Instr", regs: List[_Reg], device: torch.device,
          tables: Sequence[torch.Tensor]) -> _Reg:
    op, dt = ep.OPS[ins.op], ins.dtype
    a, b, c = (regs[r] if r < len(regs) else None for r in (ins.a, ins.b, ins.c))
    if op == "LUT":  # an index_select of table b, the index clamped into it
        table = tables[ins.b]
        idx = a[0].to(torch.int64).clamp(0, int(table.shape[0]) - 1)
        return torch.index_select(table, 0, idx.reshape(-1)).reshape(idx.shape), a[1]
    if op == "CONST":
        return torch.tensor(ins.imm, dtype=ep.DTYPES[dt], device=device), None
    if op == "NULL":
        return (torch.zeros((), dtype=ep.DTYPES[dt], device=device),
                torch.tensor(False, device=device))
    if op in ("ISNULL", "NOTNULL"):
        valid = _valid_of(a)
        return (~valid if op == "ISNULL" else valid), None
    if op == "CAST":
        return _cast_values(a[0], dt, ins.b), a[1]
    if op == "SEL":
        match = a[0] & _valid_of(a)
        return (torch.where(match, b[0], c[0]),
                torch.where(match, _valid_of(b), _valid_of(c)))
    if op == "COAL":
        av = _valid_of(a)
        return torch.where(av, a[0], b[0]), av | _valid_of(b)
    if op == "NULLIF":
        return a[0], _valid_of(a) & ~(b[0] & _valid_of(b))
    if op in ("AND", "OR"):
        (x, _), (y, _) = a, b
        xv, yv = _valid_of(a), _valid_of(b)
        xf, yf = x & xv, y & yv  # NULL reads as False
        if op == "AND":
            return xf & yf, (xv & yv) | (xv & ~x) | (yv & ~y)
        return xf | yf, (xv & yv) | (xv & x) | (yv & y)
    if op == "NOT":
        return ~a[0], a[1]
    if op in _CMP_OPS:
        return _CMP_OPS[op](a[0], b[0]), _and_valid(a[1], b[1])
    if op in ("ADD", "SUB", "MUL", "DIV", "POW"):
        x, y = a[0], b[0]
        if dt == ep.B:
            value = x | y if op == "ADD" else x & y
        else:
            value = {"ADD": torch.add, "SUB": torch.sub, "MUL": torch.mul,
                     "DIV": torch.div, "POW": torch.pow}[op](x, y)
        return value, _and_valid(a[1], b[1])
    if op == "MOD":
        x, y = a[0], b[0]
        nonzero = y != 0
        guard = ~nonzero if dt in (ep.U8,) + ep._FLOATS else ~nonzero | (y == -1)
        value = torch.fmod(x, torch.where(guard, torch.ones_like(y), y))
        return value, _and_valid(_and_valid(a[1], b[1]), nonzero)
    if op == "NEG":
        return -a[0], a[1]
    if op == "ABS":
        return (a[0] if dt == ep.B else torch.abs(a[0])), a[1]
    if op == "SIGN":
        return _sign(a[0]), a[1]
    if op == "NANNULL":
        nan = torch.isnan(a[0])
        return torch.where(nan, torch.zeros_like(a[0]), a[0]), _and_valid(a[1], ~nan)
    if op == "ROUND":
        # a 0-d tensor, not a Python scalar: torch divides by a scalar on
        # the card as a product with its reciprocal
        x, f = a[0], torch.tensor(ins.imm, dtype=torch.float64, device=device)
        if ins.b:
            return torch.round(x / f) * f, a[1]
        return torch.round(x * f) / f, a[1]
    if op in _FLOAT_OPS:
        return _FLOAT_OPS[op](a[0]), a[1]
    raise ValueError(f"no twin for {ins}")  # pragma: no cover - compile_program checks


def expr_program_reference(
    program: "ep.Program",
    inputs: Sequence[Payload],
    n: int,
    *,
    filter: bool = False,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    device: Optional[torch.device] = None,
) -> Any:
    """The twin of K6 in ``expr_program.cu``: ``program`` interpreted over
    ``n`` rows with torch ops, one instruction at a time, constants as
    0-d tensors of their type, a LUT as an ``index_select`` of its table.
    ``inputs`` are the program's input columns (values and null mask) in
    its order.

    Columns mode: a list of ``(values, mask)``, one per output, values in
    the output's dtype and ``mask`` (True = valid) None where the output
    has none. Filter mode (``filter=True``, the rows as ``nrows`` or
    ``row_valid``): ``(keep bool[n], count int32 0-d)``, keep = the
    condition's value and validity and the row's. ``device`` is where a
    program with no input puts its outputs."""
    if len(inputs) != len(program.inputs):
        raise ValueError(f"{len(inputs)} inputs for a program of {len(program.inputs)}")
    if device is None:
        device = inputs[0][0].device if inputs else torch.device("cpu")
    regs: List[_Reg] = [(torch.zeros((), device=device), None)] * program.nregs
    for j, (v, m) in enumerate(inputs):
        regs[j] = (v, m)
    for ins in program.instrs:
        regs[ins.dst] = _step(ins, regs, device, program.tables)
    outs = []
    for o in program.outputs:
        v, m = regs[o.reg]
        v = v.to(device).expand(n).contiguous()
        m = None if not o.masked else _valid_of((v, m)).to(device).expand(n).contiguous()
        outs.append((v, m))
    if not filter:
        return outs
    (value, mask), = outs
    if (nrows is None) == (row_valid is None):
        raise ValueError("pass exactly one of nrows (prefix rows) and row_valid")
    keep = value & materialize_validity(row_valid, n, nrows, device)
    if mask is not None:
        keep = keep & mask
    return keep, keep.sum().to(torch.int32)


# --- joins: K7 join_build, K8 join_probe, K9 join_expand, K10 gather_rows ---

PROBE_MODES = ("semi", "anti", "unique", "expand", "not_in")


class Probe(NamedTuple):
    """What K8 ``join_probe`` writes, by mode (None where the mode writes
    nothing):

    - ``keep``: bool [n], the probe rows the join keeps (semi, anti,
      unique, not_in);
    - ``ridx``: int32 [n], each probe row's build row, -1 where it has
      none (unique);
    - ``m``: int32 [n], each probe row's matches (expand);
    - ``reps``: int32 [n], its output rows: ``m`` on a real row, at least
      1 under an outer join, 0 on a row that is not real (expand);
    - ``total``: 0-d, the kept rows (int32: semi, anti, unique, not_in) or
      the sum of ``reps`` (int64: expand)."""

    keep: Optional[torch.Tensor]
    ridx: Optional[torch.Tensor]
    m: Optional[torch.Tensor]
    reps: Optional[torch.Tensor]
    total: torch.Tensor


def _join_rows(seg: torch.Tensor, num: int, nrows: Optional[int],
               row_valid: Optional[torch.Tensor],
               nulls: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(real, matchable)`` over a join side's padded rows: real rows (a
    prefix frame's first ``nrows``, or a masked frame's non-zero
    ``row_valid`` bytes), and those of them with no null key (``nulls``,
    True where a key is null) and a segment in ``[0, num)``."""
    if (nrows is None) == (row_valid is None):
        raise ValueError("pass exactly one of nrows (prefix rows) and row_valid")
    n = int(seg.shape[0])
    real = materialize_validity(row_valid, n, nrows, seg.device)
    matchable = real & (seg >= 0) & (seg < num)
    if nulls is not None:
        matchable = matchable & ~nulls
    return real, matchable


def join_build_reference(
    seg: torch.Tensor,
    num: int,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    nulls: Optional[torch.Tensor] = None,
    slots: bool = False,
    side_counts: bool = False,
) -> Any:
    """The twin of K7 in ``join.cu``: the build side's table, int32
    [num]. A row takes part where it is real, has no null key and its
    segment lies in ``[0, num)`` (``_join_rows``). Counts mode: the rows
    of each segment (``segment_count`` of the JAX package's join programs,
    ``fugue_tpu/jax_backend/relational.py:298-300``, ``:466``). Slot
    mode: the highest such row of each segment, -1 where there is none
    (the scatter-max of ``_unique_right_join``, ``:674-678``). With
    ``side_counts``, ``(table, stats)``: stats int32 [2] holds the side's
    real rows and its real rows with a null key (``not_in_join``'s
    ``empty2`` and ``any_null2``, ``:356-362``)."""
    real, take = _join_rows(seg, num, nrows, row_valid, nulls)
    rows = seg[take].to(torch.int64)
    if slots:
        table = torch.full((num,), -1, dtype=torch.int32, device=seg.device)
        pos = torch.arange(int(seg.shape[0]), dtype=torch.int32, device=seg.device)[take]
        table = table.scatter_reduce_(0, rows, pos, "amax")
    else:
        table = torch.bincount(rows, minlength=num).to(torch.int32)
    if not side_counts:
        return table
    null_rows = real if nulls is None else real & nulls
    stats = torch.stack([real.sum(dtype=torch.int32),
                         null_rows.sum(dtype=torch.int32) if nulls is not None
                         else torch.zeros((), dtype=torch.int32, device=seg.device)])
    return table, stats


def join_probe_reference(
    seg: torch.Tensor,
    table: torch.Tensor,
    mode: str,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    nulls: Optional[torch.Tensor] = None,
    outer: bool = False,
    stats: Optional[torch.Tensor] = None,
) -> Probe:
    """The twin of K8 in ``join.cu``: each probe row reads its segment's
    entry of ``table`` (K7's counts, or its slots in ``"unique"`` mode); a
    row that is not matchable (``_join_rows``) reads 0 (-1 in unique
    mode). ``mode``:

    - ``"semi"``: keep = matchable and the count above 0; ``"anti"``: keep
      = real and not that (``semi_anti_join``,
      ``fugue_tpu/jax_backend/relational.py:301-306``);
    - ``"unique"``: ridx = the slot, keep = ridx >= 0, or every real row
      under ``outer`` (``_unique_right_join``, ``:679-682``, ``:688``);
    - ``"expand"``: m = the count, reps = m on a real row, ``max(m, 1)``
      under ``outer``, total their sum in int64 (``expand_join``'s
      ``_count_prog``, ``:470-474``);
    - ``"not_in"``: SQL's three-valued NOT IN against the build side whose
      K7 side counts are ``stats``: keep = real and (the build side has no
      real row, or the probe key is not null, no build key is null and
      the count is 0) (``not_in_join``, ``:368-369``)."""
    if mode not in PROBE_MODES:
        raise ValueError(f"probe mode {mode!r}: one of {PROBE_MODES}")
    if (mode == "not_in") != (stats is not None):
        raise ValueError("stats go with the not_in mode, and only with it")
    num = int(table.shape[0])
    real, matchable = _join_rows(seg, num, nrows, row_valid, nulls)
    entry = table[seg.clamp(0, num - 1).to(torch.int64)]
    if mode == "unique":
        ridx = torch.where(matchable, entry, -1)
        keep = real if outer else ridx >= 0
        return Probe(keep, ridx, None, None, keep.sum(dtype=torch.int32))
    hit = matchable & (entry > 0)
    if mode == "semi":
        return Probe(hit, None, None, None, hit.sum(dtype=torch.int32))
    if mode == "anti":
        keep = real & ~hit
        return Probe(keep, None, None, None, keep.sum(dtype=torch.int32))
    if mode == "not_in":
        notnull = real if nulls is None else real & ~nulls
        keep = real & ((stats[0] == 0) | (notnull & (stats[1] == 0) & ~hit))  # type: ignore[index]
        return Probe(keep, None, None, None, keep.sum(dtype=torch.int32))
    m = torch.where(matchable, entry, 0)
    reps = torch.where(real, m.clamp(min=1) if outer else m, 0)
    return Probe(None, None, m, reps, reps.sum(dtype=torch.int64))


def join_expand_reference(
    start: torch.Tensor,
    m: torch.Tensor,
    seg1: torch.Tensor,
    cstart2: torch.Tensor,
    order2: torch.Tensor,
    total: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin of K9 in ``join.cu``, by the JAX package's algorithm
    (``expand_join``'s ``_gather_prog``,
    ``fugue_tpu/jax_backend/relational.py:568-577``): a mark at each probe
    row's ``start`` (int64, the exclusive prefix sum of K8's ``reps``), a
    cumulative sum of the marks for each output row's probe row ``i``,
    then its offset ``j`` in that row's run and, where ``j < m[i]``, its
    build row ``order2[cstart2[seg1[i]] + j]``. ``cstart2`` (int64 [S]) is
    each segment's first position in ``order2`` (int64 [p2], the build
    rows grouped by segment). Returns ``(li, ri)``, int32 [total]; ``ri``
    is -1 on an outer row with no match."""
    device = start.device
    p1, num, p2 = int(start.shape[0]), int(cstart2.shape[0]), int(order2.shape[0])
    t = torch.arange(total, dtype=torch.int64, device=device)
    marks = torch.zeros((total,), dtype=torch.int64, device=device)
    inside = start < total
    marks.index_add_(0, start[inside], torch.ones_like(start[inside]))
    i = (torch.cumsum(marks, 0) - 1).clamp(0, p1 - 1)
    j = t - start[i]
    matched = j < m[i]
    s = seg1[i].clamp(0, num - 1).to(torch.int64)
    rpos = (cstart2[s] + j).clamp(0, p2 - 1)
    ri = torch.where(matched, order2[rpos], -1)
    return i.to(torch.int32), ri.to(torch.int32)


class GatherColumn(NamedTuple):
    """A column K10 ``gather_rows`` gathers: its values (any dtype of 1,
    2, 4 or 8 bytes) and null mask (True = valid; None: every row valid)."""

    values: torch.Tensor
    mask: Optional[torch.Tensor]


def gather_rows_reference(
    columns: Sequence[GatherColumn], idx: torch.Tensor, *, outer: bool = False
) -> List[Payload]:
    """The twin of K10 in ``gather.cu``: per column ``out[t] =
    values[idx[t]]``, 0 where ``idx[t]`` is -1 (an outer row with no
    match), and the mask ``mask[idx[t]] and idx[t] >= 0``, given where the
    column has a mask or under ``outer`` (the index may hold -1), else
    None (``_gather_prog``, ``fugue_tpu/jax_backend/relational.py:578-585``;
    ``_unique_right_join``, ``:683-687``)."""
    hit = idx >= 0
    safe = idx.clamp(min=0).to(torch.int64)
    out: List[Payload] = []
    for values, mask in columns:
        v = values.index_select(0, safe)
        v = torch.where(hit, v, torch.zeros_like(v))
        om: Optional[torch.Tensor] = None
        if mask is not None:
            om = mask.index_select(0, safe) & hit
        elif outer:
            om = hit
        out.append((v, om))
    return out


# --- row selection: K12 rank_keep, K13 first_row_mask, K14 null_count_keep ---

RANK_MODES = ("lt", "ge")
FIRST_ROW_MODES = ("all", "hit", "miss")
DROPNA_HOWS = ("any", "all")


def check_rank_args(seg: Optional[torch.Tensor], word_shift: Optional[int],
                    starts: Optional[torch.Tensor], limit: Optional[torch.Tensor],
                    limits: Optional[torch.Tensor], mode: str) -> None:
    """Raises on K12's arguments that do not go together."""
    if mode not in RANK_MODES:
        raise ValueError(f"rank mode {mode!r}: one of {RANK_MODES}")
    if (limit is None) == (limits is None):
        raise ValueError("pass exactly one of limit (one scalar) and limits (one per segment)")
    if (seg is None) != (starts is None) or (limits is not None and seg is None):
        raise ValueError("seg and starts go together, and limits needs them")
    if seg is not None:
        if seg.dtype not in ((torch.int32, torch.int64) if word_shift is not None
                             else (torch.int32,)):
            raise ValueError(f"seg has dtype {seg.dtype}: an int32 id or an int32/int64 word")
        if word_shift is not None and not 0 <= word_shift < 8 * seg.element_size():
            raise ValueError(f"word_shift {word_shift} outside the word's bits")
    elif word_shift is not None:
        raise ValueError("word_shift goes with seg")


def sorted_segments(seg: torch.Tensor, word_shift: Optional[int]) -> torch.Tensor:
    """K12's segment of each sorted position (int64): ``seg`` itself (an
    int32 id), or a K11 word's unsigned field above ``word_shift`` bits
    (its container's top bit flipped back)."""
    if word_shift is None:
        return seg.to(torch.int64)
    if seg.dtype == torch.int32:
        return ((seg.to(torch.int64) & 0xFFFFFFFF) ^ (1 << 31)) >> word_shift
    u = seg ^ _INT64_TOP
    if word_shift == 0:
        return u  # a field of 64 bits: at or above 2^63 it is negative, out of range either way
    return (u >> word_shift) & ((1 << (64 - word_shift)) - 1)


def rank_keep_reference(
    order: torch.Tensor,
    *,
    seg: Optional[torch.Tensor] = None,
    word_shift: Optional[int] = None,
    starts: Optional[torch.Tensor] = None,
    limit: Optional[torch.Tensor] = None,
    limits: Optional[torch.Tensor] = None,
    mode: str = "lt",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin of K12 in ``row_select.cu``: keep flags by rank, the
    decision taken in sorted order.

    ``order`` (int64 [n], a permutation of the rows, as ``torch.sort``
    gives it) lists the rows in sorted order. ``seg`` gives the segment
    of each sorted position (``sorted_segments``): an int32 id, or, with
    ``word_shift``, the first K11 presort word (int32 or int64) whose
    field above ``word_shift`` bits is the segment (K11's "not real" bit
    above it). A position whose segment lies outside ``[0, S)`` (the
    sentinel; a row that is not real) is not kept; without ``seg`` there
    is one segment of every position. The position ``i`` has rank ``i -
    starts[s]`` within its segment ``s`` (``starts`` int64 [S] each
    segment's first sorted position; 0 without ``seg``), and is kept where
    that rank is at least 0 and below (``mode="lt"``) or at least
    (``"ge"``) its limit: ``limits[s]`` (int32 [S]) or the one ``limit``
    (a 0-d int64 device tensor). Returns ``(keep bool[n] in row order,
    count int32 0-d)``: ``device_take``'s ``local < n``
    (``fugue_tpu/jax_backend/relational.py:1348-1361``), INTERSECT ALL's
    and EXCEPT ALL's ordinal against ``c2[seg]`` (``:1072-1084``),
    ``device_sample``'s k smallest priorities (``:2196-2206``)."""
    check_rank_args(seg, word_shift, starts, limit, limits, mode)
    n = int(order.shape[0])
    device = order.device
    rank = torch.arange(n, dtype=torch.int64, device=device)
    if seg is not None:
        num = int(starts.shape[0])  # type: ignore[union-attr]
        s = sorted_segments(seg, word_shift)
        inside = (s >= 0) & (s < num)
        if num == 0:
            return (torch.zeros((n,), dtype=torch.bool, device=device),
                    torch.zeros((), dtype=torch.int32, device=device))
        s = s.clamp(0, num - 1)
        rank = rank - starts.index_select(0, s)  # type: ignore[union-attr]
        lim = (limits.index_select(0, s).to(torch.int64) if limits is not None
               else limit.to(torch.int64))  # type: ignore[union-attr]
    else:
        inside = torch.ones((n,), dtype=torch.bool, device=device)
        lim = limit.to(torch.int64)  # type: ignore[union-attr]
    kept = inside & (rank >= 0) & (rank >= lim if mode == "ge" else rank < lim)
    keep = torch.zeros((n,), dtype=torch.bool, device=device)
    keep[order] = kept
    return keep, kept.sum(dtype=torch.int32)


def first_row_mask_reference(
    first_idx: torch.Tensor,
    n: int,
    *,
    occupied: Optional[torch.Tensor] = None,
    counts: Optional[torch.Tensor] = None,
    mode: str = "all",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin of K13 in ``row_select.cu``: a mask over ``n`` rows with
    each segment's first row set, where the segment is occupied
    (``occupied`` bool [S]; None: every segment), its first row lies in
    ``[0, n)`` (``first_idx`` int32 [S]) and its predicate holds:
    ``"all"`` (``_distinct_prog``,
    ``fugue_tpu/jax_backend/execution_engine.py:1854-1867``, and the
    DISTINCT aggregates' first-occurrence mask, ``_apply_distinct_mask``
    ``:3749-3776``), ``"hit"`` (``counts[g] > 0``: INTERSECT DISTINCT) or
    ``"miss"`` (``counts[g] == 0``: EXCEPT DISTINCT;
    ``relational.py:1061-1071``). The kept segments' first rows are
    distinct, as a factorization's occupied segments' are. Returns
    ``(keep bool[n], count int32 0-d)``."""
    if mode not in FIRST_ROW_MODES:
        raise ValueError(f"first-row mode {mode!r}: one of {FIRST_ROW_MODES}")
    if (mode == "all") != (counts is None):
        raise ValueError("counts go with the hit and miss modes only")
    f = first_idx.to(torch.int64)
    ok = (f >= 0) & (f < n)
    if occupied is not None:
        ok = ok & occupied
    if mode != "all":
        ok = ok & ((counts > 0) if mode == "hit" else (counts == 0))  # type: ignore[operator]
    keep = torch.zeros((n,), dtype=torch.bool, device=first_idx.device)
    keep[f[ok]] = True
    return keep, ok.sum(dtype=torch.int32)


def null_count_keep_reference(
    masks: Sequence[torch.Tensor],
    ncols: int,
    n: int,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    how: str = "any",
    thresh: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin of K14 in ``row_select.cu`` (``_dropna_prog``,
    ``fugue_tpu/jax_backend/execution_engine.py:1906-1925``): each row's
    valid count over ``ncols`` columns, of which ``masks`` (bool [n]
    each, True = valid) are the ones with nulls; keep the real rows whose
    count is at least ``thresh`` where given, else all ``ncols``
    (``how="any"``) or above 0 (``"all"``). Returns ``(keep bool[n],
    count int32 0-d)``."""
    if how not in DROPNA_HOWS:
        raise ValueError(f"dropna how {how!r}: one of {DROPNA_HOWS}")
    if device is None:
        device = masks[0].device if masks else (
            row_valid.device if row_valid is not None else torch.device("cpu"))
    valid = torch.full((n,), ncols - len(masks), dtype=torch.int32, device=device)
    for m in masks:
        valid = valid + m.to(torch.int32)
    if thresh is not None:
        keep = valid >= thresh
    elif how == "any":
        keep = valid == ncols
    else:
        keep = valid > 0
    keep = keep & materialize_validity(row_valid, n, nrows, device)
    return keep, keep.sum(dtype=torch.int32)


# --- windows: K15 window_rank, K16 window_frame ---

RANK_FUNCS = ("row_number", "rank", "dense_rank", "ntile", "percent_rank", "cume_dist")
FRAME_FUNCS = ("count", "count_star", "sum", "avg", "min", "max", "lag", "lead",
               "first_value", "last_value", "nth_value")
FRAME_UNITS = ("running", "rows", "groups", "range")
BOUND_KINDS = ("up", "p", "c", "f", "uf")
AGG_ROUTES = ("prefix", "loop", "span")
# the widest ROWS frame of literal offsets that K16 sums or extremises by a
# loop over its rows
LOOP_MAX = 64


class SortedWords(NamedTuple):
    """The rows in window order, as K15 and K16 take them: ``order`` (int64
    [n], the row at each sorted position), ``words`` (each int32 or int64
    [n] in sorted order: K11's words of the partition's segment id, then
    the ORDER BY keys), ``part_shift``, the bits of ``words[0]`` below
    the segment id's field, and ``real_below``: where the frame has rows
    that are not real (sorted last, K11's "not real" bit above the
    segment id), the smallest signed ``words[0]`` of such a row
    (``real_below``); else None."""

    order: torch.Tensor
    words: List[torch.Tensor]
    part_shift: int
    real_below: Optional[int] = None


class WindowFrame(NamedTuple):
    """What K16 computes at each row:

    - ``func``: one of ``FRAME_FUNCS`` (``count_star`` takes no argument);
      ``param`` lag/lead's offset or nth_value's position;
    - the frame: ``unit`` one of ``FRAME_UNITS`` (``"running"``: the
      default, from the partition's start to the row's last peer) and its
      bounds ``lo``, ``hi``, each ``(kind, n)`` with kind one of
      ``BOUND_KINDS`` (``"p"``/``"f"``: ``n`` preceding or following);
    - ``values`` (int64 or float64 [n], in row order: integer, bool, date,
      timestamp and string-code arguments as int64, floats as float64, a
      bool summed as float64) and ``vmask`` (True = valid; None: all); a
      float NaN is not valid;
    - ``default``: lag/lead's value where the offset leaves the partition;
    - ``key`` (float64 [n]), ``kmask`` and ``key_desc``: RANGE's one
      ORDER BY key where a bound is an offset;
    - ``route``: one of ``AGG_ROUTES`` (``frame_route``)."""

    func: str
    param: int = 0
    unit: str = "running"
    lo: Tuple[str, float] = ("up", 0)
    hi: Tuple[str, float] = ("c", 0)
    values: Optional[torch.Tensor] = None
    vmask: Optional[torch.Tensor] = None
    default: Optional[Any] = None
    key: Optional[torch.Tensor] = None
    kmask: Optional[torch.Tensor] = None
    key_desc: bool = False
    route: str = "prefix"


def frame_route(func: str, unit: str, lo: Tuple[str, float], hi: Tuple[str, float]) -> str:
    """How K16 takes count/sum/avg/min/max over a frame: ``"prefix"`` where
    it starts at the partition's start (the running frame's partition
    prefix), ``"loop"`` over a ROWS frame of literal offsets at most
    ``LOOP_MAX`` rows wide, else ``"span"``: a difference of partition
    prefixes for count/sum/avg, a sparse table up to the longest frame for
    min/max."""
    if func not in ("count", "sum", "avg", "min", "max"):
        return "prefix"
    if unit == "running" or lo[0] == "up":
        return "prefix"
    if unit == "rows" and lo[0] in ("p", "c", "f") and hi[0] in ("p", "c", "f"):
        def off(b: Tuple[str, float]) -> int:
            return {"p": -1, "c": 0, "f": 1}[b[0]] * int(b[1] or 0)

        if off(hi) - off(lo) + 1 <= LOOP_MAX:
            return "loop"
    return "span"


def _shifted(x: torch.Tensor, first: Any) -> torch.Tensor:
    """``x`` moved one position later, ``first`` in front."""
    return torch.cat([torch.full((1,), first, dtype=x.dtype, device=x.device), x[:-1]])


def window_positions(sw: SortedWords) -> Dict[str, torch.Tensor]:
    """Per sorted position (int64 [n]): its partition's first and last
    positions (``ps``, ``pe``), its peer group's (``gs``, ``ge``) and the
    peer group starts up to it (``cnt``): the JAX package's cummax and
    reversed cummin over adjacent-word comparisons
    (``fugue_tpu/jax_backend/relational.py:1555-1632``)."""
    w0 = sw.words[0]
    n = int(w0.shape[0])
    device = w0.device
    raw = (w0.to(torch.int64) & 0xFFFFFFFF) if w0.dtype == torch.int32 else w0
    pk = raw >> sw.part_shift
    pos = torch.arange(n, dtype=torch.int64, device=device)
    ph = pk != _shifted(pk, 0)
    ph[0] = True
    gh = ph.clone()
    for w in sw.words:
        gh |= w != _shifted(w, 0)
    pend = torch.cat([ph[1:], torch.ones((1,), dtype=torch.bool, device=device)])
    gend = torch.cat([gh[1:], torch.ones((1,), dtype=torch.bool, device=device)])

    def last_at_or_before(flag: torch.Tensor) -> torch.Tensor:
        return torch.cummax(torch.where(flag, pos, -1), 0).values

    def first_at_or_after(flag: torch.Tensor) -> torch.Tensor:
        return torch.flip(torch.cummin(torch.flip(torch.where(flag, pos, n), [0]), 0).values, [0])

    return dict(ps=last_at_or_before(ph), pe=first_at_or_after(pend),
                gs=last_at_or_before(gh), ge=first_at_or_after(gend),
                cnt=torch.cumsum(gh, 0))


def _to_rows(order: torch.Tensor, sorted_vals: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(sorted_vals)
    out[order] = sorted_vals
    return out


def window_rank_reference(sw: SortedWords, func: str, param: int = 0) -> torch.Tensor:
    """The twin of K15 in ``window.cu`` (``_window_rank_family``,
    ``fugue_tpu/jax_backend/relational.py:1542-1641``): each row's
    row_number, rank, dense_rank or ntile(``param``) (int64), or
    percent_rank or cume_dist (float64), in row order."""
    if func not in RANK_FUNCS:
        raise ValueError(f"rank function {func!r}: one of {RANK_FUNCS}")
    if func == "ntile" and param < 1:
        raise ValueError("ntile takes at least one bucket")
    p = window_positions(sw)
    ps, pe, gs, ge, cnt = p["ps"], p["pe"], p["gs"], p["ge"], p["cnt"]
    n = int(ps.shape[0])
    local = torch.arange(n, dtype=torch.int64, device=ps.device) - ps
    psize = pe - ps + 1
    if func == "row_number":
        out = local + 1
    elif func == "rank":
        out = gs - ps + 1
    elif func == "dense_rank":
        out = cnt - cnt[ps] + 1
    elif func == "ntile":
        q, rem = psize // param, psize % param
        cutoff = rem * (q + 1)
        out = torch.where(local < cutoff, local // (q + 1) + 1,
                          rem + (local - cutoff) // q.clamp(min=1) + 1)
    elif func == "percent_rank":
        out = torch.where(psize > 1, (gs - ps).to(torch.float64)
                          / (psize - 1).clamp(min=1).to(torch.float64), 0.0)
    else:
        out = (ge - ps + 1).to(torch.float64) / psize.to(torch.float64)
    return _to_rows(sw.order, out)


def _search(skv: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, t: torch.Tensor,
            upper: bool) -> torch.Tensor:
    """Per position the first k in ``[lo, hi)`` with ``skv[k] >= t``
    (``upper``: ``> t``), by a vectorised bisection."""
    n = int(skv.shape[0])
    for _ in range(max(1, n.bit_length()) + 1):
        live = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        m = skv[mid.clamp(0, n - 1)]
        go = live & ((m <= t) if upper else (m < t))
        lo, hi = torch.where(go, mid + 1, lo), torch.where(live & ~go, mid, hi)
    return lo


def frame_bounds_reference(sw: SortedWords, frame: WindowFrame,
                           p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each sorted position's frame ``[lo, hi]`` (int64; empty where ``lo >
    hi``), clamped to its partition (``relational.py:1830-1966``); a row
    that is not real gets an empty frame, ``[j + 1, j]``."""
    ps = p["ps"]
    pos = torch.arange(int(ps.shape[0]), dtype=torch.int64, device=ps.device)
    lo, hi = _frame_bounds(sw, frame, p, pos)
    if sw.real_below is None:
        return lo, hi
    real = sw.words[0] < sw.real_below
    return torch.where(real, lo, pos + 1), torch.where(real, hi, pos)


def _frame_bounds(sw: SortedWords, frame: WindowFrame, p: Dict[str, torch.Tensor],
                  pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    ps, pe, gs, ge, cnt = p["ps"], p["pe"], p["gs"], p["ge"], p["cnt"]
    n = int(ps.shape[0])
    if frame.unit == "running":
        return ps, ge
    skv = snull = None
    if frame.unit == "range" and (frame.lo[0] in ("p", "f") or frame.hi[0] in ("p", "f")):
        k = frame.key.index_select(0, sw.order)  # type: ignore[union-attr]
        null = torch.isnan(k)
        if frame.kmask is not None:
            null |= ~frame.kmask.index_select(0, sw.order)
        skv = torch.where(null, 0.0, -k if frame.key_desc else k)
        snull = null

    def bound(b: Tuple[str, float], is_start: bool) -> torch.Tensor:
        kind, nv = b
        if kind == "up":
            return ps
        if kind == "uf":
            return pe
        if frame.unit == "rows":
            if kind == "c":
                return pos
            return pos + int(nv) if kind == "f" else pos - int(nv)
        if kind == "c":
            return gs if is_start else ge
        if frame.unit == "groups":
            g = cnt - 1
            tg = g + int(nv) if kind == "f" else g - int(nv)
            first, last = cnt[ps] - 1, cnt[pe] - 1
            heads = torch.zeros((n + 1,), dtype=torch.int64, device=ps.device)
            if is_start:
                heads.scatter_(0, (cnt - 1)[gs == pos], pos[gs == pos])
                got = heads[tg.clamp(0, n)]
                return torch.where(tg < first, ps, torch.where(tg > last, pe + 1, got))
            heads.scatter_(0, (cnt - 1)[ge == pos], pos[ge == pos])
            got = heads[tg.clamp(0, n)]
            return torch.where(tg > last, pe, torch.where(tg < first, ps - 1, got))
        t = skv + (float(nv) if kind == "f" else -float(nv))  # type: ignore[operator]
        s0 = torch.where(snull[ps], ge[ps] + 1, ps)  # type: ignore[index]
        s1 = torch.where(snull[pe], gs[pe] - 1, pe)  # type: ignore[index]
        got = _search(skv, s0, s1 + 1, t, upper=False) if is_start else \
            _search(skv, s0, s1 + 1, t, upper=True) - 1  # type: ignore[arg-type]
        return torch.where(snull, gs if is_start else ge, got)  # type: ignore[arg-type]

    return torch.maximum(bound(frame.lo, True), ps), torch.minimum(bound(frame.hi, False), pe)


def _partition_prefix(x: torch.Tensor, ps: torch.Tensor) -> torch.Tensor:
    """Each position's sum of ``x`` from its partition's start, summed in
    position order within each partition (an integer one exactly)."""
    if not x.is_floating_point():
        g = torch.cumsum(x, 0)
        before = torch.where(ps > 0, g[(ps - 1).clamp(min=0)], 0)
        return g - before
    starts = torch.nonzero(ps == torch.arange(int(ps.shape[0]), device=ps.device)).flatten()
    bounds = starts.tolist() + [int(ps.shape[0])]
    return torch.cat([torch.cumsum(x[s:e], 0) for s, e in zip(bounds[:-1], bounds[1:])])


def window_frame_reference(sw: SortedWords, frame: WindowFrame
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The twin of K16 in ``window.cu`` (``_window_frame_agg``,
    ``fugue_tpu/jax_backend/relational.py:1762-2057``): each row's
    function over its frame, in row order, and its mask (None for the
    counts, which are never null). Values where the mask is False are 0.

    Sums take the argument's type's accumulator (int64 exactly, float64
    for the rest) per partition: from the partition's start (``"prefix"``
    route), in row order over the frame (``"loop"``), or as a difference of
    partition prefixes (``"span"``), as K16 does; float64 frame sums of
    the two may differ in their last bits where K16's scan adds in another
    order. Min and max are exact on every route (-0.0 below +0.0)."""
    if frame.func not in FRAME_FUNCS:
        raise ValueError(f"frame function {frame.func!r}: one of {FRAME_FUNCS}")
    order = sw.order
    p = window_positions(sw)
    ps, pe = p["ps"], p["pe"]
    n = int(ps.shape[0])
    device = ps.device
    func = frame.func
    if func == "count_star":
        lo, hi = frame_bounds_reference(sw, frame, p)
        return _to_rows(order, torch.where(lo > hi, 0, hi - lo + 1)), None
    v = frame.values.index_select(0, order)  # type: ignore[union-attr]
    ok = torch.ones((n,), dtype=torch.bool, device=device) if frame.vmask is None \
        else frame.vmask.index_select(0, order).clone()
    if v.is_floating_point():
        ok &= ~torch.isnan(v)
    sv = torch.where(ok, v, torch.zeros((), dtype=v.dtype, device=device))
    pos = torch.arange(n, dtype=torch.int64, device=device)
    if func in ("lag", "lead"):
        src = pos - frame.param if func == "lag" else pos + frame.param
        inside = (src >= ps) & (src <= pe)
        at = src.clamp(0, n - 1)
        dflt = torch.zeros((), dtype=v.dtype, device=device)
        if frame.default is not None:
            dflt = torch.tensor(frame.default, device=device).to(v.dtype)
        val = torch.where(inside, sv[at], dflt)
        m = torch.where(inside, ok[at], frame.default is not None)
        return _to_rows(order, torch.where(m, val, 0)), _to_rows(order, m)
    lo, hi = frame_bounds_reference(sw, frame, p)
    empty = lo > hi
    if func in ("first_value", "last_value", "nth_value"):
        at = lo if func == "first_value" else (hi if func == "last_value" else lo + frame.param - 1)
        bad = empty | (at > hi)
        m = ~bad & ok[at.clamp(0, n - 1)]
        val = torch.where(m, sv[at.clamp(0, n - 1)], 0)
        return _to_rows(order, val), _to_rows(order, m)
    lo_c, hi_c = lo.clamp(0, n - 1), hi.clamp(0, n - 1)
    if frame.route == "loop":
        los = {"p": -1, "c": 0, "f": 1}
        first = los[frame.lo[0]] * int(frame.lo[1] or 0)
        last = los[frame.hi[0]] * int(frame.hi[1] or 0)
        total = torch.zeros((n,), dtype=sv.dtype, device=device)
        count = torch.zeros((n,), dtype=torch.int64, device=device)
        for d in range(first, last + 1):
            k = pos + d
            take = (k >= lo) & (k <= hi) & ok[k.clamp(0, n - 1)]
            total = torch.where(take, total + sv[k.clamp(0, n - 1)], total)
            count += take
    else:
        c = _partition_prefix(ok.to(torch.int64), ps)
        count = torch.where(empty, 0, c[hi_c] - torch.where(lo > ps, c[(lo_c - 1).clamp(min=0)], 0))
        total = torch.zeros((n,), dtype=sv.dtype, device=device)
        if func in ("sum", "avg"):
            s = _partition_prefix(sv, ps)
            total = torch.where(empty, 0, s[hi_c] - torch.where(lo > ps, s[(lo_c - 1).clamp(min=0)],
                                                                0))
    if func == "count":
        return _to_rows(order, count), None
    has = count > 0
    if func == "sum":
        return _to_rows(order, torch.where(has, total, 0)), _to_rows(order, has)
    if func == "avg":
        avg = total.to(torch.float64) / count.clamp(min=1).to(torch.float64)
        return _to_rows(order, torch.where(has, avg, 0.0)), _to_rows(order, has)
    # min/max: a sparse table up to the longest frame, by a total order
    is_min = func == "min"
    key = _order_key(sv)
    fill = _I64_MAX if is_min else _I64_MIN
    if sv.is_floating_point():
        fill = int(_order_key(torch.tensor([float("inf") if is_min else float("-inf")],
                                           dtype=torch.float64))[0])
    op = torch.minimum if is_min else torch.maximum
    level = torch.where(ok, key, fill)
    length = torch.where(empty, 1, hi - lo + 1)
    kq = torch.floor(torch.log2(length.to(torch.float64))).to(torch.int64)
    best = torch.full((n,), fill, dtype=torch.int64, device=device)
    longest = int(length.max()) if n else 1
    w, k = 1, 0
    while True:
        at_k = kq == k
        a = level[lo_c]
        b = level[(hi_c - w + 1).clamp(0, n - 1)]
        best = torch.where(at_k, op(a, b), best)
        if 2 * w > longest:
            break
        shifted = torch.cat([level[w:], torch.full((w,), fill, dtype=torch.int64, device=device)])
        level = op(level, shifted[:n])
        w, k = 2 * w, k + 1
    val = _from_order_key(best, sv.dtype)
    return _to_rows(order, torch.where(has, val, 0)), _to_rows(order, has)


# ---- co-map membership: comap.cu (K17 comap_presence, K18 comap_rows) ----

COMAP_HOWS = ("inner", "left_outer", "right_outer", "full_outer", "cross")


class ComapRows(NamedTuple):
    """What K18 writes: per stacked row ``row_alive`` (bool) and
    ``seg_out`` (int32: its segment where alive, else the sentinel
    ``num_segments``); per segment ``alive`` (bool); per member the count
    of its alive rows ``counts`` (int32 [N]); and the count of alive
    segments ``alive_count`` (int32 0-d)."""

    row_alive: torch.Tensor
    seg_out: torch.Tensor
    alive: torch.Tensor
    counts: torch.Tensor
    alive_count: torch.Tensor


def presence_words(members: int) -> int:
    """The ``uint32`` presence words a segment holds: one bit a member."""
    return (members + 31) // 32


def _comap_rows(n: int, offsets: torch.Tensor, nrows: torch.Tensor,
                valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per stacked row its member (``offsets`` int64 [N + 1]: member
    ``m`` holds rows ``[offsets[m], offsets[m + 1])``) and whether it is
    real: below its member's ``nrows[m]`` and, where ``valid`` is given,
    with a non-zero ``valid`` byte."""
    if offsets.dim() != 1 or offsets.numel() < 2 or int(offsets[-1]) != n or int(offsets[0]) != 0:
        raise ValueError(f"offsets must run from 0 to the {n} stacked rows")
    rows = torch.arange(n, dtype=torch.int64, device=offsets.device)
    member = torch.searchsorted(offsets[1:], rows, right=True)
    real = (rows - offsets.index_select(0, member)) < nrows.index_select(0, member)
    if valid is not None:
        real = real & (valid != 0)
    return member, real


def comap_presence_reference(
    seg: torch.Tensor,
    num_segments: int,
    offsets: torch.Tensor,
    nrows: torch.Tensor,
    *,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The twin of K17 in ``comap.cu``: which members have a real row in
    each segment (``compiled_comap``'s ``segment_sum(valid) > 0`` per
    member, ``fugue_tpu/jax_backend/comap_compiled.py:335-341``).

    ``seg`` int32 [n] are the stacked members' segment ids, ``offsets``
    and ``nrows`` (int64, on ``seg``'s device) their layout
    (``_comap_rows``). Returns the presence words, int32 [S * W] with
    ``W = presence_words(N)``: bit ``m % 32`` of word ``s * W + m // 32``
    is set where member ``m`` has a real row with ``seg == s``; rows whose
    ``seg`` lies outside ``[0, S)`` set nothing."""
    n = int(seg.shape[0])
    members = int(offsets.numel()) - 1
    words = presence_words(members)
    member, real = _comap_rows(n, offsets, nrows, valid)
    s = seg.to(torch.int64)
    ok = real & (s >= 0) & (s < num_segments)
    marks = torch.zeros((num_segments * words * 32,), dtype=torch.bool, device=seg.device)
    marks[((s * words + member // 32) * 32 + member % 32)[ok]] = True
    bits = marks.view(num_segments * words, 32)
    out = torch.zeros((num_segments * words,), dtype=torch.int32, device=seg.device)
    for b in range(32):
        out |= bits[:, b].to(torch.int32) << b
    return out


def comap_alive_reference(presence: Optional[torch.Tensor], num_segments: int, members: int,
                          how: str) -> torch.Tensor:
    """Each segment's liveness under the zip's rule (``_alive_rule``,
    ``comap_compiled.py:197-213``): every member present (inner), the
    first (left_outer), the last (right_outer), any (full_outer); a cross
    zip's one segment is always alive."""
    if how not in COMAP_HOWS:
        raise ValueError(f"zip how {how!r}: one of {COMAP_HOWS}")
    if how == "cross":
        return torch.ones((num_segments,), dtype=torch.bool,
                          device=None if presence is None else presence.device)
    w = presence.view(num_segments, presence_words(members))  # type: ignore[union-attr]
    if how == "left_outer":
        return (w[:, 0] & 1) != 0
    if how == "right_outer":
        return ((w[:, (members - 1) // 32] >> ((members - 1) % 32)) & 1) != 0
    if how == "full_outer":
        return (w != 0).any(dim=1)
    full = torch.full((w.shape[1],), -1, dtype=torch.int32, device=w.device)
    if members % 32:
        full[-1] = (1 << (members % 32)) - 1
    return (w == full).all(dim=1)


def comap_rows_reference(
    seg: torch.Tensor,
    presence: Optional[torch.Tensor],
    num_segments: int,
    offsets: torch.Tensor,
    nrows: torch.Tensor,
    how: str,
    *,
    valid: Optional[torch.Tensor] = None,
) -> ComapRows:
    """The twin of K18 in ``comap.cu``: the zip rule over K17's
    ``presence`` (None for a cross zip), then per row ``valid & alive[seg]``
    and the segment id re-pointed at the sentinel where not alive, the
    members' alive rows and the alive segments counted
    (``compiled_comap._wrapped``, ``comap_compiled.py:342-362``)."""
    n = int(seg.shape[0])
    members = int(offsets.numel()) - 1
    member, real = _comap_rows(n, offsets, nrows, valid)
    alive = comap_alive_reference(presence, num_segments, members, how).to(seg.device)
    s = seg.to(torch.int64)
    ok = real & (s >= 0) & (s < num_segments)
    row_alive = ok & alive.index_select(0, s.clamp(0, num_segments - 1))
    seg_out = torch.where(row_alive, seg, torch.full_like(seg, num_segments))
    counts = torch.bincount(member[row_alive], minlength=members).to(torch.int32)
    return ComapRows(row_alive, seg_out, alive, counts, alive.sum(dtype=torch.int32))


# ---- streaming fold: stream.cu (K19 stream_fold) ----

# an accumulator row's update, as K19 takes it: "rows" counts every row;
# "count" the rows whose payload is valid; "sum_i" adds an int64 payload
# into int64 (two's complement, exact), "sum_f" a float64 one into
# float64, "sum_if" an int64 one converted to float64; "min_i"/"max_i"
# keep an int64 extremum, "min_f"/"max_f" a float64 one as its order key
# (``_order_key``: the int64 image whose signed order is the float's)
FOLD_KINDS = ("rows", "count", "sum_i", "sum_f", "sum_if", "min_i", "max_i", "min_f", "max_f")


class FoldOp(NamedTuple):
    """One accumulator's update: its ``kind`` (``FOLD_KINDS``), the index
    of the payload it reads (-1 for ``"rows"``) and its column of the
    accumulator store."""

    kind: str
    payload: int
    acc: int


def fold_init(kind: str) -> int:
    """The value an accumulator row of ``kind`` starts from, as int64."""
    if kind in ("min_i", "max_i"):
        return _I64_MAX if kind == "min_i" else _I64_MIN
    if kind in ("min_f", "max_f"):
        inf = float("inf") if kind == "min_f" else float("-inf")
        return int(_order_key(torch.tensor([inf], dtype=torch.float64))[0])
    return 0


def fold_segments(keys: Sequence[torch.Tensor], bounds: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Each row's slot: the mixed radix of ``key - lo`` over the spans, the
    first key most significant (``_Space.seg``,
    ``fugue_tpu/jax_backend/streaming.py:125``), as int64."""
    seg = torch.zeros_like(keys[0], dtype=torch.int64)
    for k, (lo, span) in zip(keys, bounds):
        seg = seg * int(span) + (k.to(torch.int64) - int(lo))
    return seg


def stream_fold_reference(
    keys: Sequence[torch.Tensor],
    bounds: Sequence[Tuple[int, int]],
    payloads: Sequence[Payload],
    ops: Sequence[FoldOp],
    store: torch.Tensor,
) -> torch.Tensor:
    """The twin of K19 in ``stream.cu``: one chunk folded into the
    accumulators in place (``StreamingAggregator._get_update``'s
    ``_update``, ``fugue_tpu/jax_backend/streaming.py:295-350``).

    ``keys`` are int64 [n], ``bounds`` each key's ``(lo, span)`` with every
    key in ``[lo, lo + span)``; ``payloads`` int64 or float64 [n] values
    with their masks (True = valid; None: all valid); ``store`` the int64
    accumulators [T, A], slot-major (a slot's A accumulators are
    adjacent; a float64 sum's column holds its bits), ``T`` the slots.
    Each op adds the chunk's rows into its column at their slots; a row
    whose slot is outside ``[0, T)`` is dropped. Returns ``store``."""
    seg = fold_segments(keys, bounds)
    slots = int(store.shape[0])
    inside = (seg >= 0) & (seg < slots)
    if not bool(inside.all()):
        seg = seg[inside]
        payloads = [(v[inside], None if m is None else m[inside]) for v, m in payloads]
    for op in ops:
        if op.kind not in FOLD_KINDS:
            raise ValueError(f"fold kind {op.kind!r}: one of {FOLD_KINDS}")
        row = store[:, op.acc]
        if op.kind == "rows":
            row += torch.bincount(seg, minlength=slots)
            continue
        values, mask = payloads[op.payload]
        s, v = (seg, values) if mask is None else (seg[mask], values[mask])
        if op.kind == "count":
            row += torch.bincount(s, minlength=slots)
        elif op.kind == "sum_i":
            row.index_add_(0, s, v.to(torch.int64))
        elif op.kind in ("sum_f", "sum_if"):
            row.view(torch.float64).index_add_(0, s, v.to(torch.float64))
        else:
            key = _order_key(v) if op.kind in ("min_f", "max_f") else v.to(torch.int64)
            row.scatter_reduce_(0, s, key, "amin" if op.kind.startswith("min") else "amax")
    return store
