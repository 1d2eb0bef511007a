"""The wrappers of ``factorize.cu``: check their tensors, allocate the
outputs and scratch, and launch the key-factorization kernels on
PyTorch's current stream.

- ``bin_factorize_cuda`` (K1): segment ids, first row per bin, occupied
  bins and the group count of a binned key set;
- ``sort_word_cuda`` (KW): one order-preserving sort word per row;
- ``presort_word_cuda`` (K11, KW's presort mode): the same with keys
  descending, nulls first, NaN as null and fields narrowed to a known
  range, for ``take``'s presort and partitions;
- ``sort_word_boundaries_cuda`` (K2w): from the sorted words and the
  sort's order, the sorted segment ids, each group's word and first row,
  and the group count;
- ``sort_word_lookup_cuda`` (K3w): segment ids in row order, by a search
  of each row's word among the groups' words;
- ``sort_boundaries_cuda`` (K2): sorted segment ids and the group count
  from the sort codes of a key too wide for one word and the sort's order;
- ``sort_finish_cuda`` (K3): segment ids in row order (stored through the
  order by slab, ``order_scatter.cuh``) and the first row of each group.

Each has the contract of its twin in ``reference.py``. Each wrapper's
``launches`` grows by one where it launches its kernel and nowhere else;
``bin_factorize_cuda.last_path`` names the path of its last launch,
``"shared"`` or ``"global"`` (where the bins' first rows were taken), and
``sort_word_lookup_cuda.last_path`` likewise where the table was
searched."""

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from fugue_tpu_torch.kernels import build
from fugue_tpu_torch.kernels.reference import (
    MAX_KEYS,
    BinKey,
    Payload,
    PresortKey,
    SortWord,
    bin_total,
    has_unreal_rows,
    key_field_bits,
    key_has_flag,
    presort_bits,
    real_below,
    word_bits,
)

MAX_CODES = 16  # sort codes per K2 launch
MAX_WORD_KEYS = 16  # key columns per KW launch
_WORD_TILE = 2048  # the fewest K2w positions per block (int64 words)
_PATHS = {1: "shared", 2: "global"}
# dtype codes of bin_keys.cuh
_CODES = {
    torch.bool: 0, torch.uint8: 1, torch.int8: 2, torch.int16: 3,
    torch.int32: 4, torch.int64: 5,
}
_WORD_CODES = {**_CODES, torch.float32: 6, torch.float64: 7}
_WORD_DTYPES = (torch.int32, torch.int64)
# K11's key options (factorize.cu)
_FLAG, _NO_VALUE, _DESC, _NULLS_FIRST, _NAN_NULL, _NARROW = 1, 2, 4, 8, 16, 32
_CODE_DTYPES = {4: (torch.int32, torch.float32), 8: (torch.int64, torch.float64)}


def _bind() -> ctypes.CDLL:
    lib = build.load("factorize")
    if lib.fugue_bin_factorize.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pp, ip, llp = ctypes.POINTER(p), ctypes.POINTER(i), ctypes.POINTER(ll)
        lib.fugue_bin_factorize.argtypes = [
            ll, ll, p, i,  # n, nrows, row_valid, nkeys
            pp, pp, ip, llp, llp,  # key data, masks, codes, kmin, span
            p, p, p, p,  # seg, first_idx, occupied, count
            i, p, ip,  # device, stream, path
        ]
        lib.fugue_sort_boundaries.argtypes = [
            ll, ll, p, p,  # n, nrows, row_valid, order
            i, pp, llp, ip, p,  # ncodes, data, strides, widths, first_sorted
            p, p, p,  # state, seg_sorted, count
            i, p,  # device, stream
        ]
        lib.fugue_sort_boundaries_tiles.argtypes = [ll]
        lib.fugue_sort_boundaries_tiles.restype = ll
        lib.fugue_sort_finish.argtypes = [
            ll, p, p, i, p, p,  # n, seg_sorted, order, num, seg, first_idx
            p, p, p, i, p,  # offs, vals, fill, device, stream
        ]
        lib.fugue_sort_finish_shift.argtypes = []
        lib.fugue_sort_finish_shift.restype = i
        lib.fugue_sort_word.argtypes = [
            ll, ll, p, i,  # n, nrows, row_valid, unreal
            i, pp, pp, ip,  # nkeys, key data, masks, codes
            ip, ip, llp,  # options, widths, kmin
            i, p, i, p,  # wide, word, device, stream
        ]
        lib.fugue_sort_word_boundaries.argtypes = [
            ll, i, p, p, i, ll,  # n, width, sorted, order, has_limit, limit
            p, p, p, p, p,  # block_sums, uniq, first_idx, seg_sorted, count
            i, p,  # device, stream
        ]
        lib.fugue_sort_word_lookup.argtypes = [
            ll, i, p, p, i, i, ll, p,  # n, width, words, uniq, num, has_limit, limit, seg
            i, p, ip,  # device, stream, path
        ]
        for fn in (lib.fugue_bin_factorize, lib.fugue_sort_boundaries, lib.fugue_sort_finish,
                   lib.fugue_sort_word, lib.fugue_sort_word_boundaries, lib.fugue_sort_word_lookup):
            fn.restype = i
        lib.fugue_factorize_error_string.argtypes = [i]
        lib.fugue_factorize_error_string.restype = ctypes.c_char_p
    return lib


def _require_cuda(t: torch.Tensor, fn: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{fn} takes CUDA tensors only")


def _device_and_stream(device: torch.device) -> Tuple[int, int]:
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def _check(t: torch.Tensor, name: str, dtypes: Tuple[torch.dtype, ...], n: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != (n,) or (n > 1 and t.stride(0) != 1):
        raise ValueError(f"{name} must be a dense 1-D tensor of {n} rows")
    if t.data_ptr() % t.element_size() != 0:
        raise ValueError(f"{name} is not aligned to its {t.element_size()}-byte elements")


def _check_rows(n: int, nrows: Optional[int], row_valid: Optional[torch.Tensor],
                device: torch.device) -> int:
    """The ``nrows`` argument of a launch: a prefix frame's ``nrows``, -1
    for a masked frame."""
    if (nrows is None) == (row_valid is None):
        raise ValueError("pass exactly one of nrows (prefix rows) and row_valid")
    if not 1 <= n < 2**31:
        raise ValueError(f"{n} rows: the kernels take 1 to 2^31 - 1")
    if row_valid is not None:
        _check(row_valid, "row_valid", (torch.bool, torch.uint8), n, device)
        return -1
    if not 0 <= int(nrows) <= n:  # type: ignore[arg-type]
        raise ValueError(f"nrows {nrows} outside [0, {n}]")
    return int(nrows)  # type: ignore[arg-type]


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.fugue_factorize_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _ptrs(ts: Sequence[Optional[torch.Tensor]]) -> "ctypes.Array":
    return (ctypes.c_void_p * max(len(ts), 1))(
        *[None if t is None else t.data_ptr() for t in ts]
    )


def bin_factorize_cuda(
    keys: Sequence[BinKey],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1, with the contract of ``reference.bin_factorize_reference``:
    ``(seg int32[n], first_idx int32[total], occupied bool[total], count
    int32 0-d)``. Keys are dense 1-D CUDA tensors of one device; raises on
    anything else, on a failed build and on a refused launch."""
    if len(keys) == 0:
        raise ValueError("bin_factorize_cuda needs at least one key")
    _require_cuda(keys[0].data, "bin_factorize_cuda")
    if len(keys) > MAX_KEYS:
        raise ValueError(f"{len(keys)} keys: the kernel takes 1 to {MAX_KEYS}")
    device = keys[0].data.device
    n = int(keys[0].data.shape[0])
    nrows_arg = _check_rows(n, nrows, row_valid, device)
    total = bin_total(keys)
    for j, k in enumerate(keys):
        _check(k.data, f"key {j}", tuple(_CODES), n, device)
        if k.mask is not None:
            _check(k.mask, f"key {j} mask", (torch.bool,), n, device)
    seg = torch.empty((n,), dtype=torch.int32, device=device)
    first_idx = torch.empty((total,), dtype=torch.int32, device=device)
    occupied = torch.empty((total,), dtype=torch.bool, device=device)
    count = torch.empty((), dtype=torch.int32, device=device)
    lib = _bind()
    index, stream = _device_and_stream(device)
    path = ctypes.c_int(0)
    err = lib.fugue_bin_factorize(
        n, nrows_arg, None if row_valid is None else row_valid.data_ptr(), len(keys),
        _ptrs([k.data for k in keys]), _ptrs([k.mask for k in keys]),
        (ctypes.c_int * len(keys))(*[_CODES[k.data.dtype] for k in keys]),
        (ctypes.c_longlong * len(keys))(*[int(k.kmin) for k in keys]),
        (ctypes.c_longlong * len(keys))(*[int(k.span) for k in keys]),
        seg.data_ptr(), first_idx.data_ptr(), occupied.data_ptr(), count.data_ptr(),
        index, stream, ctypes.byref(path),
    )
    _raise_on(lib, err, "bin_factorize")
    bin_factorize_cuda.launches += 1
    bin_factorize_cuda.last_path = _PATHS[path.value]
    return seg, first_idx, occupied, count


bin_factorize_cuda.launches = 0  # type: ignore[attr-defined]
bin_factorize_cuda.last_path = None  # type: ignore[attr-defined]


def sort_boundaries_cuda(
    codes: Sequence[torch.Tensor],
    order: torch.Tensor,
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
    first_sorted: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2, with the contract of ``reference.sort_boundaries_reference``:
    ``(seg_sorted int32[n], count int32 0-d)``. ``codes`` are 1-D CUDA
    tensors of n rows, int32/float32 or int64/float64, any stride (an
    int64 key's two int32 words are views); ``order`` is the dense int64
    permutation that ``torch.sort`` gives, real rows first;
    ``first_sorted``, where given, is ``codes[0][order]`` (``lex_sort``'s
    values), read in its place."""
    _require_cuda(order, "sort_boundaries_cuda")
    if not 1 <= len(codes) <= MAX_CODES:
        raise ValueError(f"{len(codes)} sort codes: the kernel takes 1 to {MAX_CODES}")
    device = order.device
    n = int(order.shape[0])
    _check(order, "order", (torch.int64,), n, device)
    nrows_arg = _check_rows(n, nrows, row_valid, device)
    widths = []
    for j, c in enumerate(codes):
        width = c.element_size()
        if c.device != device or c.dim() != 1 or int(c.shape[0]) != n:
            raise ValueError(f"code {j} must be a 1-D tensor of {n} rows on {device}")
        if c.dtype not in _CODE_DTYPES.get(width, ()):
            raise ValueError(f"code {j} has dtype {c.dtype}: int32/float32 or int64/float64")
        if c.data_ptr() % width != 0:
            raise ValueError(f"code {j} is not aligned to its {width}-byte elements")
        widths.append(width)
    if first_sorted is not None:
        if (first_sorted.device != device or first_sorted.dtype != codes[0].dtype
                or first_sorted.dim() != 1 or int(first_sorted.shape[0]) != n
                or not first_sorted.is_contiguous()):
            raise ValueError(f"first_sorted must be a dense 1-D {codes[0].dtype} tensor of {n} "
                             f"rows on {device}")
    lib = _bind()
    # the tiles' look-back state and the tile counter, zeroed by the call
    state = torch.empty((int(lib.fugue_sort_boundaries_tiles(n)) + 1,), dtype=torch.int64,
                        device=device)
    seg_sorted = torch.empty((n,), dtype=torch.int32, device=device)
    count = torch.empty((), dtype=torch.int32, device=device)
    index, stream = _device_and_stream(device)
    err = lib.fugue_sort_boundaries(
        n, nrows_arg, None if row_valid is None else row_valid.data_ptr(), order.data_ptr(),
        len(codes), _ptrs(list(codes)),
        (ctypes.c_longlong * len(codes))(*[int(c.stride(0)) for c in codes]),
        (ctypes.c_int * len(codes))(*widths),
        None if first_sorted is None else first_sorted.data_ptr(),
        state.data_ptr(), seg_sorted.data_ptr(), count.data_ptr(), index, stream,
    )
    _raise_on(lib, err, "sort_boundaries")
    sort_boundaries_cuda.launches += 1
    return seg_sorted, count


sort_boundaries_cuda.launches = 0  # type: ignore[attr-defined]


def sort_finish_cuda(
    seg_sorted: torch.Tensor, order: torch.Tensor, num: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3, with the contract of ``reference.sort_finish_reference``:
    ``(seg int32[n], first_idx int32[num])``. ``order`` must be a
    permutation of the rows. ``sort_finish_cuda.last_fill`` keeps each
    slab's bucket count of its store through the order in the last launch
    (int32, on the device) and ``.last_shift`` its slab's log2 rows."""
    _require_cuda(order, "sort_finish_cuda")
    device = order.device
    n = int(order.shape[0])
    _check(order, "order", (torch.int64,), n, device)
    _check(seg_sorted, "seg_sorted", (torch.int32,), n, device)
    if not 0 <= num <= n:
        raise ValueError(f"num {num} outside [0, {n}]")
    lib = _bind()
    shift = lib.fugue_sort_finish_shift()
    seg = torch.empty((n,), dtype=torch.int32, device=device)
    _check_aligned16(seg, "seg")
    first_idx = torch.empty((num,), dtype=torch.int32, device=device)
    # the buckets' entries (offset, value) and each bucket's count
    offs = torch.empty((n,), dtype=torch.int32, device=device)
    vals = torch.empty((n,), dtype=torch.int32, device=device)
    fill = torch.empty((-(-n >> shift),), dtype=torch.int32, device=device)
    index, stream = _device_and_stream(device)
    err = lib.fugue_sort_finish(
        n, seg_sorted.data_ptr(), order.data_ptr(), num, seg.data_ptr(),
        first_idx.data_ptr() if num > 0 else None, offs.data_ptr(), vals.data_ptr(),
        fill.data_ptr(), index, stream,
    )
    _raise_on(lib, err, "sort_finish")
    sort_finish_cuda.launches += 1
    sort_finish_cuda.last_fill, sort_finish_cuda.last_shift = fill, shift
    return seg, first_idx


sort_finish_cuda.launches = 0  # type: ignore[attr-defined]
sort_finish_cuda.last_fill = None  # type: ignore[attr-defined]
sort_finish_cuda.last_shift = 0  # type: ignore[attr-defined]


def _check_aligned16(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} is not 16-byte aligned: the kernel reads it in 16-byte vectors")


def _launch_word(keys: Sequence[PresortKey], n: int, device: torch.device, unreal: bool,
                 nrows_arg: int, row_valid: Optional[torch.Tensor], what: str) -> torch.Tensor:
    """One KW launch over checked ``keys``: the int32 or int64 word."""
    bits = presort_bits(keys, unreal)
    if bits > 64:
        raise ValueError(f"the keys take {bits} bits: a sort word holds 64")
    wide = bits > 32
    word = torch.empty((n,), dtype=torch.int64 if wide else torch.int32, device=device)
    m = max(len(keys), 1)
    lib = _bind()
    index, stream = _device_and_stream(device)
    err = lib.fugue_sort_word(
        n, max(nrows_arg, 0), None if row_valid is None or not unreal else row_valid.data_ptr(),
        int(unreal), len(keys), _ptrs([k.values for k in keys]), _ptrs([k.mask for k in keys]),
        (ctypes.c_int * m)(*[_WORD_CODES[k.values.dtype] for k in keys]),
        (ctypes.c_int * m)(*[_presort_opts(k) for k in keys]),
        (ctypes.c_int * m)(*[key_field_bits(k) for k in keys]),
        (ctypes.c_longlong * m)(*[int(k.kmin or 0) for k in keys]),
        int(wide), word.data_ptr(), index, stream,
    )
    _raise_on(lib, err, what)
    return word


def sort_word_cuda(
    keys: Sequence[Payload],
    *,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> SortWord:
    """KW, with the contract of ``reference.sort_word_reference``: the
    sort word of ``keys`` (each dense 1-D CUDA values of bool, uint8,
    int8-64 or float32/64 and an optional dense bool mask), int32 when
    its fields fit 32 bits, int64 when they fit 64; raises over 64 bits.
    The presort mode with every option at its default."""
    if not 1 <= len(keys) <= MAX_WORD_KEYS:
        raise ValueError(f"{len(keys)} keys: the kernel takes 1 to {MAX_WORD_KEYS}")
    _require_cuda(keys[0][0], "sort_word_cuda")
    device = keys[0][0].device
    n = int(keys[0][0].shape[0])
    nrows_arg = _check_rows(n, nrows, row_valid, device)
    for j, (v, mask) in enumerate(keys):
        _check(v, f"key {j}", tuple(_WORD_CODES), n, device)
        if mask is not None:
            _check(mask, f"key {j} mask", (torch.bool,), n, device)
    unreal = has_unreal_rows(n, nrows, row_valid)
    bits = word_bits(keys, unreal)
    word = _launch_word([PresortKey(v, mask) for v, mask in keys], n, device, unreal,
                        nrows_arg, row_valid, "sort_word")
    sort_word_cuda.launches += 1
    return SortWord(word, real_below(bits) if unreal else None)


sort_word_cuda.launches = 0  # type: ignore[attr-defined]


def _presort_opts(k: PresortKey) -> int:
    opts = 0
    if k.flag and key_has_flag(k):
        opts |= _FLAG
    if not k.value:
        opts |= _NO_VALUE
    if k.desc:
        opts |= _DESC
    if k.nulls_first:
        opts |= _NULLS_FIRST
    if k.nan_is_null:
        opts |= _NAN_NULL
    if k.kmin is not None:
        opts |= _NARROW
    return opts


def presort_word_cuda(
    keys: Sequence[PresortKey],
    *,
    unreal: bool = False,
    nrows: Optional[int] = None,
    row_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K11, KW's presort mode, with the contract of
    ``reference.presort_word_reference``: the int32 or int64 word of
    ``keys`` (each dense 1-D CUDA values, an optional dense bool mask, a
    narrowed field only on an integer or bool key), the rows as ``nrows``
    or ``row_valid`` where ``unreal``. Raises over 64 bits, on anything
    else the kernel does not take, on a failed build and on a refused
    launch."""
    if len(keys) > MAX_WORD_KEYS or (not keys and not unreal):
        raise ValueError(f"{len(keys)} keys: the kernel takes 0 to {MAX_WORD_KEYS}, "
                         "and 0 only with the unreal flag")
    first = keys[0].values if keys else row_valid
    if first is None:
        raise ValueError("a word of no key needs the rows as a row_valid tensor")
    _require_cuda(first, "presort_word_cuda")
    device = first.device
    n = int(first.shape[0])
    nrows_arg = 0
    if unreal:
        nrows_arg = _check_rows(n, nrows, row_valid, device)
    elif not 1 <= n < 2**31:
        raise ValueError(f"{n} rows: the kernels take 1 to 2^31 - 1")
    for j, k in enumerate(keys):
        _check(k.values, f"key {j}", tuple(_WORD_CODES), n, device)
        if k.mask is not None:
            _check(k.mask, f"key {j} mask", (torch.bool,), n, device)
        if k.kmin is not None and (k.values.is_floating_point() or not 0 <= k.bits <= 64):
            raise ValueError(f"key {j}: a narrowed field takes an integer key and 0 to 64 bits")
    word = _launch_word(keys, n, device, unreal, nrows_arg, row_valid, "presort_word")
    presort_word_cuda.launches += 1
    return word


presort_word_cuda.launches = 0  # type: ignore[attr-defined]


def _limit_args(words: torch.Tensor, limit: Optional[int]) -> Tuple[int, int]:
    """``(has_limit, limit)`` of a K2w/K3w launch, the limit within the
    word's type."""
    if limit is None:
        return 0, 0
    info = torch.iinfo(words.dtype)
    if not info.min <= int(limit) <= info.max:
        raise ValueError(f"real_below {limit} outside {words.dtype}")
    return 1, int(limit)


def sort_word_boundaries_cuda(
    sorted_words: torch.Tensor,
    order: torch.Tensor,
    *,
    real_below: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2w, with the contract of
    ``reference.sort_word_boundaries_reference``: ``(uniq, first_idx,
    seg_sorted, count)``. ``sorted_words`` is a dense, 16-byte aligned
    int32/int64 CUDA tensor in sorted order (``torch.sort``'s values),
    ``order`` the dense int64 permutation it came with."""
    _require_cuda(sorted_words, "sort_word_boundaries_cuda")
    device = sorted_words.device
    n = int(sorted_words.shape[0])
    if not 1 <= n < 2**31:
        raise ValueError(f"{n} rows: the kernels take 1 to 2^31 - 1")
    _check(sorted_words, "sorted_words", _WORD_DTYPES, n, device)
    _check(order, "order", (torch.int64,), n, device)
    _check_aligned16(sorted_words, "sorted_words")
    has_limit, limit = _limit_args(sorted_words, real_below)
    block_sums = torch.empty((-(-n // _WORD_TILE),), dtype=torch.int32, device=device)
    uniq = torch.empty_like(sorted_words)
    first_idx = torch.empty((n,), dtype=torch.int32, device=device)
    seg_sorted = torch.empty((n,), dtype=torch.int32, device=device)
    count = torch.empty((), dtype=torch.int32, device=device)
    lib = _bind()
    index, stream = _device_and_stream(device)
    err = lib.fugue_sort_word_boundaries(
        n, sorted_words.element_size(), sorted_words.data_ptr(), order.data_ptr(),
        has_limit, limit, block_sums.data_ptr(), uniq.data_ptr(), first_idx.data_ptr(),
        seg_sorted.data_ptr(), count.data_ptr(), index, stream,
    )
    _raise_on(lib, err, "sort_word_boundaries")
    sort_word_boundaries_cuda.launches += 1
    return uniq, first_idx, seg_sorted, count


sort_word_boundaries_cuda.launches = 0  # type: ignore[attr-defined]


def sort_word_lookup_cuda(
    words: torch.Tensor,
    uniq: torch.Tensor,
    num: int,
    *,
    real_below: Optional[int] = None,
) -> torch.Tensor:
    """K3w, with the contract of ``reference.sort_word_lookup_reference``:
    ``seg`` int32[n]. ``words`` is the dense, 16-byte aligned row-order
    sort word, ``uniq`` K2w's distinct words (at least ``num`` of them,
    dense, of the same dtype)."""
    _require_cuda(words, "sort_word_lookup_cuda")
    device = words.device
    n = int(words.shape[0])
    if not 1 <= n < 2**31:
        raise ValueError(f"{n} rows: the kernels take 1 to 2^31 - 1")
    _check(words, "words", _WORD_DTYPES, n, device)
    _check_aligned16(words, "words")
    if not 0 <= num <= min(n, int(uniq.shape[0])):
        raise ValueError(f"num {num} outside [0, {min(n, int(uniq.shape[0]))}]")
    _check(uniq, "uniq", (words.dtype,), int(uniq.shape[0]), device)
    has_limit, limit = _limit_args(words, real_below)
    seg = torch.empty((n,), dtype=torch.int32, device=device)
    lib = _bind()
    index, stream = _device_and_stream(device)
    path = ctypes.c_int(0)
    err = lib.fugue_sort_word_lookup(
        n, words.element_size(), words.data_ptr(), uniq.data_ptr(), num, has_limit, limit,
        seg.data_ptr(), index, stream, ctypes.byref(path),
    )
    _raise_on(lib, err, "sort_word_lookup")
    sort_word_lookup_cuda.launches += 1
    sort_word_lookup_cuda.last_path = _PATHS[path.value]
    return seg


sort_word_lookup_cuda.launches = 0  # type: ignore[attr-defined]
sort_word_lookup_cuda.last_path = None  # type: ignore[attr-defined]
