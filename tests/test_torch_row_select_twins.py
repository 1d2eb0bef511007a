"""The twins of K11 (KW's presort mode), K12 ``rank_keep``, K13
``first_row_mask`` and K14 ``null_count_keep`` (``kernels/reference.py``)
against numpy oracles: the presort order over one or several words, by
a ``hypothesis`` property against ``numpy.lexsort`` over every key dtype,
descending keys, nulls first and last, NaN as null, narrowed fields,
fields split over words and frames with rows that are not real; each
row-selection twin against the numpy statement of its contract. Also
``chip_smoke.py``'s ``row_select_vs_twin`` and ``relational_paths`` on the
CPU at small sizes (the wrappers swapped for their twins), as
``test_torch_strings.test_chip_smoke_string_paths_on_cpu`` does for the
string paths."""

from typing import Any, Dict, List, Tuple

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fugue_tpu_torch.kernels import expr_program, factorize, reference, row_select
from fugue_tpu_torch.kernels.reference import (
    PresortKey,
    first_row_mask_reference,
    null_count_keep_reference,
    presort_bits,
    presort_word_reference,
    rank_keep_reference,
)
from fugue_tpu_torch.torch_backend import relational

DTYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float32", "float64"]


def _values(rng: np.random.Generator, dtype: str, n: int) -> np.ndarray:
    """Few distinct values (ties), the type's extremes, and for floats
    -0.0, +0.0, infinities and NaN."""
    if dtype == "bool":
        return rng.random(n) < 0.5
    if dtype.startswith("float"):
        pool = [-np.inf, -2.5, -0.0, 0.0, 1.0, 3.25, np.inf, np.nan]
        return rng.choice(pool, n).astype(dtype)
    info = np.iinfo(dtype)
    pool = [info.min, info.min + 1, -1 if info.min < 0 else 1, 0, 2, info.max - 1, info.max]
    return rng.choice(np.array(pool, dtype=np.int64), n).astype(dtype)


def _oracle_ranks(values: np.ndarray, null: np.ndarray, desc: bool) -> np.ndarray:
    """Each row's rank among the non-null values (-0.0 ties +0.0), the
    negative of it where descending, 0 on nulls."""
    v = values.astype(np.float64) if values.dtype.kind == "f" else values.astype(object)
    ranks = np.zeros(len(values), dtype=np.int64)
    if (~null).any():
        uniq = np.unique(v[~null]) if values.dtype.kind == "f" else sorted(set(v[~null]))
        lookup = {x: i for i, x in enumerate(uniq)}
        if values.dtype.kind == "f":
            ranks[~null] = np.searchsorted(uniq, v[~null])
        else:
            ranks[~null] = [lookup[x] for x in v[~null]]
    return -ranks if desc else ranks


@st.composite
def presort_case(draw: Any) -> Any:
    n = draw(st.integers(1, 40))
    seed = draw(st.integers(0, 2**31 - 1))
    nkeys = draw(st.integers(0, 5))
    keys = []
    for _ in range(nkeys):
        keys.append(dict(dtype=draw(st.sampled_from(DTYPES)), masked=draw(st.booleans()),
                         desc=draw(st.booleans()), nulls_first=draw(st.booleans()),
                         narrow=draw(st.booleans())))
    rows = draw(st.sampled_from(["full", "short", "masked"]))
    return n, seed, keys, rows


@settings(max_examples=150, deadline=None)
@given(presort_case())
def test_presort_order_matches_lexsort(case):
    """``relational.presort_order`` (K11's twin, one stable sort a word)
    orders the rows as ``numpy.lexsort`` of the keys' semantics: real rows
    first, then per key its nulls first or last and its values ascending
    or descending (NaN null, -0.0 equal to +0.0), ties in row order."""
    n, seed, specs, rows = case
    rng = np.random.default_rng(seed)
    keys: List[PresortKey] = []
    lex: List[np.ndarray] = []
    for spec in specs:
        vals = _values(rng, spec["dtype"], n)
        mask = rng.random(n) > 0.3 if spec["masked"] else None
        kmin, bits = None, 0
        if spec["dtype"] not in ("bool",) and spec["dtype"][0] in "ui" and spec["narrow"]:
            lo, hi = int(vals.min()), int(vals.max())
            kmin, bits = lo, (hi - lo).bit_length()
        elif spec["dtype"][0] in "ui" and spec["dtype"] != "bool":
            info = np.iinfo(spec["dtype"])
            kmin, bits = int(info.min), info.bits
        keys.append(PresortKey(torch.from_numpy(vals), None if mask is None else
                               torch.from_numpy(mask), desc=spec["desc"],
                               nulls_first=spec["nulls_first"], nan_is_null=True, kmin=kmin,
                               bits=bits))
        null = np.zeros(n, dtype=bool) if mask is None else ~mask
        if vals.dtype.kind == "f":
            null = null | np.isnan(vals)
        lex.append(null != spec["nulls_first"])
        lex.append(_oracle_ranks(vals, null, spec["desc"]))
    kw: Any = {"full": dict(nrows=n), "short": dict(nrows=n // 2)}.get(rows)
    real = np.arange(n) < (n if rows == "full" else n // 2)
    if rows == "masked":
        real = rng.random(n) < 0.7
        kw = dict(row_valid=torch.from_numpy(real))
    order = relational.presort_order(keys, n, torch.device("cpu"), **kw).numpy()
    want = np.lexsort([np.arange(n)] + lex[::-1] + [~real])
    np.testing.assert_array_equal(order, want)


def test_presort_word_splits_keys_over_words():
    """A float64 key with a flag after a narrowed key and the "not real"
    bit: its flag ends the first word and its field takes the second, and
    a word holds at most 64 bits and 16 keys."""
    n = 10
    f64 = PresortKey(torch.zeros(n, dtype=torch.float64), torch.ones(n, dtype=torch.bool),
                     nan_is_null=True)
    narrow = PresortKey(torch.zeros(n, dtype=torch.int32), kmin=0, bits=5)
    groups = relational._word_groups([narrow, f64], unreal=True)
    assert [[(k.flag, k.value) for k in g] for g in groups] == [
        [(True, True), (True, False)], [(False, True)]]
    assert [presort_bits(g, i == 0) for i, g in enumerate(groups)] == [7, 64]
    bools = [PresortKey(torch.zeros(n, dtype=torch.bool))] * 20
    assert [len(g) for g in relational._word_groups(bools, unreal=False)] == [16, 4]
    assert relational._word_groups([], unreal=False) == []
    assert relational._word_groups([], unreal=True) == [[]]
    with pytest.raises(ValueError, match="65 bits"):
        presort_word_reference([f64])


def test_presort_word_factorize_mode_is_the_group_by_word():
    """With every option at its default, the presort word is the group
    by's sort word (``sort_word_reference``), NaN its own value."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy(_values(rng, "float32", 50))
    m = torch.from_numpy(rng.random(50) > 0.2)
    sw = reference.sort_word_reference([(v, m)], nrows=40)
    assert torch.equal(sw.word, presort_word_reference([PresortKey(v, m)], unreal=True, nrows=40))


def _rank_oracle(order: np.ndarray, seg: Any, starts: Any, limit: Any, limits: Any,
                 ge: bool) -> np.ndarray:
    """K12's contract in numpy, one sorted position at a time: ``seg`` the
    segment of each position (None: one segment of all), kept where it
    lies in ``[0, len(starts))`` and its rank is at least 0 and below (or
    at least) its limit."""
    keep = np.zeros(len(order), dtype=bool)
    for i, row in enumerate(order):
        rank, lim = i, limit
        if seg is not None:
            s = seg[i]
            if not 0 <= s < len(starts):
                continue
            rank = i - starts[s]
            lim = limits[s] if limits is not None else limit
        keep[row] = rank >= 0 and (rank >= lim if ge else rank < lim)
    return keep


def _sorted_frame(rng: np.random.Generator, n: int, S: int, rows: str, form: str
                  ) -> Dict[str, Any]:
    """A frame of ``n`` rows over ``S`` segments sorted as K12's callers
    sort it (by segment, then a key; the rows that are not real last), as
    ``(order, seg, word_shift, starts, seg_ids)``: ``seg`` in the form K12
    reads (an int32 id with the sentinel ``S``, or the first K11 word of
    the segment and a float32 key, an int64 word, or of the segment and a
    narrowed int8 key, an int32 word) and ``seg_ids`` the numpy segment of
    each sorted position (-1 for a row that is not real)."""
    sid = rng.integers(0, S, n).astype(np.int32)
    real = np.ones(n, dtype=bool)
    frame: Dict[str, Any] = dict(nrows=n)
    if rows == "short":
        real[n - n // 4:] = False
        frame = dict(nrows=n - n // 4)
    elif rows == "masked":
        real = rng.random(n) < 0.75
        frame = dict(row_valid=torch.from_numpy(real))
    sid = np.where(real, sid, S).astype(np.int32)  # the sentinel
    counts = np.bincount(sid[real], minlength=S)
    starts = np.cumsum(counts) - counts
    if form == "id":
        order = np.lexsort((rng.random(n), sid))
        return dict(order=order, seg=torch.from_numpy(sid[order]), word_shift=None,
                    starts=starts, seg_ids=np.where(sid[order] < S, sid[order], -1))
    if form == "word64":
        key = PresortKey(torch.from_numpy(rng.random(n).astype(np.float32)), desc=True)
    else:
        key = PresortKey(torch.from_numpy(rng.integers(-3, 4, n).astype(np.int8)), kmin=-3,
                         bits=3)
    keys = [PresortKey(torch.from_numpy(sid), kmin=0, bits=S.bit_length()), key]
    words, groups = relational._presort_words(keys, n, torch.device("cpu"),
                                              frame.get("nrows"), frame.get("row_valid"))
    order, first = relational._lsd_order(words)
    assert first.dtype == (torch.int64 if form == "word64" else torch.int32)
    o = order.numpy()
    return dict(order=o, seg=first, word_shift=presort_bits(groups[0][1:], False),
                starts=starts, seg_ids=np.where(real[o], sid[o], -1))


_RANK_FORMS = [("none", "one"), ("id", "one"), ("id", "per_segment"), ("word32", "one"),
               ("word64", "one"), ("word64", "per_segment")]


@pytest.mark.parametrize("form,limits_kind", _RANK_FORMS)
@pytest.mark.parametrize("rows", ["full", "short", "masked"])
@pytest.mark.parametrize("mode", ["lt", "ge"])
@pytest.mark.parametrize("seed", [0, 1])
def test_rank_keep_twin_matches_numpy(form, limits_kind, rows, mode, seed):
    """K12's twin against the numpy contract over the segment forms its
    callers pass (none: sample and the global take; an id with the
    sentinel: INTERSECT/EXCEPT ALL; the first presort word: the take), one
    limit and one a segment, frames with every row real, a short prefix
    and a mask, at ``n = 301`` (not a multiple of 32)."""
    rng = np.random.default_rng(seed)
    n, S = 301, 7
    limit, limits = 5 + seed * 20, rng.integers(0, 50, S).astype(np.int32)
    if form == "none":
        order, seg_ids, kw = rng.permutation(n), None, {}
    else:
        f = _sorted_frame(rng, n, S, rows, form)
        order, seg_ids = f["order"], f["seg_ids"]
        kw = dict(seg=f["seg"], word_shift=f["word_shift"], starts=torch.from_numpy(f["starts"]))
    per = limits_kind == "per_segment"
    kw.update(limit=None if per else torch.tensor(limit),
              limits=torch.from_numpy(limits) if per else None, mode=mode)
    keep, count = rank_keep_reference(torch.from_numpy(order), **kw)
    want = _rank_oracle(order, seg_ids, f["starts"] if form != "none" else None, limit,
                        limits if per else None, mode == "ge")
    np.testing.assert_array_equal(keep.numpy(), want)
    assert int(count) == want.sum() and count.dtype == torch.int32


def _edge_case(label: str) -> Dict[str, Any]:
    """K12's edge cases: ``(order, numpy seg ids, keyword arguments)``."""
    rng = np.random.default_rng(len(label))
    one = torch.tensor
    if label == "every row kept":
        return dict(order=rng.permutation(100), ids=None, kw=dict(limit=one(100)))
    if label == "every row kept, ge 0":
        return dict(order=rng.permutation(100), ids=None, kw=dict(limit=one(0), mode="ge"))
    if label == "none kept":
        return dict(order=rng.permutation(100), ids=None, kw=dict(limit=one(0)))
    if label in ("one segment", "one segment, n = 1", "n = 33", "n = 31"):
        n = {"one segment": 64, "one segment, n = 1": 1, "n = 33": 33, "n = 31": 31}[label]
        ids = np.zeros(n, dtype=np.int32)
        return dict(order=rng.permutation(n), ids=ids, kw=dict(
            seg=torch.from_numpy(ids), starts=one([0]), limit=one(n // 2 + 1)))
    if label == "the sentinel segment":
        ids = np.array([0, 0, 1, 1, 1, 2, 2, 2], dtype=np.int32)  # 2: the sentinel
        return dict(order=rng.permutation(8), ids=ids, kw=dict(
            seg=torch.from_numpy(ids), starts=one([0, 2]),
            limits=torch.zeros(2, dtype=torch.int32), mode="ge"))
    if label == "clustered in one word":
        ids = np.repeat(np.arange(4, dtype=np.int32), 16)
        return dict(order=np.arange(64), ids=ids, kw=dict(
            seg=torch.from_numpy(ids), starts=one([0, 16, 32, 48]), limit=one(11)))
    if label in ("limits of 0", "limits of 0, ge"):
        ids = np.sort(rng.integers(0, 5, 90)).astype(np.int32)
        starts = np.searchsorted(ids, np.arange(5))
        return dict(order=rng.permutation(90), ids=ids, kw=dict(
            seg=torch.from_numpy(ids), starts=torch.from_numpy(starts),
            limits=torch.zeros(5, dtype=torch.int32), mode="ge" if "ge" in label else "lt"))
    if label == "no segment at all":
        ids = np.full(40, 0, dtype=np.int32)  # the sentinel of zero segments
        return dict(order=rng.permutation(40), ids=ids, kw=dict(
            seg=torch.from_numpy(ids), starts=torch.zeros(0, dtype=torch.int64),
            limits=torch.zeros(0, dtype=torch.int32), mode="ge"))
    raise KeyError(label)


_EDGES = ["every row kept", "every row kept, ge 0", "none kept", "one segment",
          "one segment, n = 1", "n = 33", "n = 31", "the sentinel segment",
          "clustered in one word", "limits of 0", "limits of 0, ge", "no segment at all"]


@pytest.mark.parametrize("label", _EDGES)
def test_rank_keep_twin_edge_cases(label):
    c = _edge_case(label)
    kw = c["kw"]
    keep, count = rank_keep_reference(torch.from_numpy(c["order"]), **kw)
    starts = kw["starts"].numpy() if "starts" in kw else None
    limits = kw["limits"].numpy() if kw.get("limits") is not None else None
    limit = int(kw["limit"]) if kw.get("limit") is not None else None
    want = _rank_oracle(c["order"], c["ids"], starts, limit, limits, kw.get("mode") == "ge")
    np.testing.assert_array_equal(keep.numpy(), want)
    assert int(count) == want.sum()
    model, mcount = _k12_model(c["order"], c["ids"], starts, limit, limits,
                               kw.get("mode") == "ge")
    assert torch.equal(model, keep) and int(mcount) == int(count)


@pytest.mark.parametrize("seed", [0, 1])
def test_rank_keep_prefix_and_masked_frames_agree(seed):
    """The take's word from a short prefix frame and from a masked frame
    with the same real rows give K12 the same kept rows: the "not real"
    bit puts the rows that are not real out of range either way."""
    n, S = 200, 5
    rng = np.random.default_rng(seed)
    sid = torch.from_numpy(rng.integers(0, S, n).astype(np.int32))
    v = torch.from_numpy(rng.random(n).astype(np.float32))
    real = np.arange(n) < 150
    got = []
    for rows in (dict(nrows=150), dict(row_valid=torch.from_numpy(real))):
        seg = torch.where(torch.from_numpy(real), sid, S)
        keys = [PresortKey(seg, kmin=0, bits=S.bit_length()), PresortKey(v, desc=True)]
        words, groups = relational._presort_words(keys, n, torch.device("cpu"),
                                                  rows.get("nrows"), rows.get("row_valid"))
        order, first = relational._lsd_order(words)
        counts = torch.bincount(seg[: 150].long(), minlength=S)
        got.append(rank_keep_reference(
            order, seg=first, word_shift=presort_bits(groups[0][1:], False),
            starts=torch.cumsum(counts, 0) - counts, limit=torch.tensor(4)))
    assert torch.equal(got[0][0], got[1][0]) and int(got[0][1]) == 4 * S
    assert not got[0][0][150:].any()


def test_rank_keep_twin_refuses_inconsistent_arguments():
    order = torch.arange(4)
    seg = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="exactly one of limit"):
        rank_keep_reference(order)
    with pytest.raises(ValueError, match="seg and starts"):
        rank_keep_reference(order, limits=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="rank mode"):
        rank_keep_reference(order, limit=torch.tensor(1), mode="le")
    with pytest.raises(ValueError, match="word_shift goes with seg"):
        rank_keep_reference(order, limit=torch.tensor(1), word_shift=3)
    with pytest.raises(ValueError, match="an int32 id"):
        rank_keep_reference(order, seg=seg.long(), starts=torch.zeros(1, dtype=torch.int64),
                            limit=torch.tensor(1))
    with pytest.raises(ValueError, match="outside the word's bits"):
        rank_keep_reference(order, seg=seg, word_shift=32,
                            starts=torch.zeros(1, dtype=torch.int64), limit=torch.tensor(1))


@pytest.mark.parametrize("mode", ["all", "hit", "miss"])
@pytest.mark.parametrize("occupied", [False, True])
def test_first_row_mask_twin_matches_numpy(mode, occupied):
    rng = np.random.default_rng(5)
    n, S = 200, 60
    first = rng.permutation(n + 40)[:S].astype(np.int32)  # some at or beyond n: side 2's
    occ = rng.random(S) < 0.6
    counts = rng.integers(0, 3, S).astype(np.int32)
    keep, count = first_row_mask_reference(
        torch.from_numpy(first), n, occupied=torch.from_numpy(occ) if occupied else None,
        counts=None if mode == "all" else torch.from_numpy(counts), mode=mode)
    ok = (first < n) & (occ if occupied else True)
    ok &= {"all": True, "hit": counts > 0, "miss": counts == 0}[mode]
    want = np.zeros(n, dtype=bool)
    want[first[ok]] = True
    np.testing.assert_array_equal(keep.numpy(), want)
    assert int(count) == ok.sum()
    model, mcount = _select_bits_model(torch.from_numpy(first[ok]).long(), n)
    assert torch.equal(model, keep) and int(mcount) == int(count)


# --- the two steps of K12 and K13 (row_select.cu), modelled in torch ---

SLAB_SHIFT = 18  # row_select.cu's kSlabShift


def _select_bits_model(rows: torch.Tensor, n: int, shift: int = SLAB_SHIFT
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 1 and 2 of ``row_select.cu`` in plain torch: each kept row
    (int64, in ``[0, n)``) goes to its slab's bucket (slab ``r >> shift``)
    as its offset in the slab; each slab ORs bit ``o % 32`` of word ``o //
    32`` of its own bits for each offset, then writes its rows from them,
    16 rows a chunk (bit ``k`` of the chunk's half-word to the chunk's
    byte ``k``), and counts the set bits. Returns ``(keep, count)``."""
    slab_rows = 1 << shift
    buckets: Dict[int, List[int]] = {}
    for r in rows.tolist():
        buckets.setdefault(r >> shift, []).append(r & (slab_rows - 1))
    keep = torch.zeros((n,), dtype=torch.bool)
    count = 0
    k = torch.arange(16, dtype=torch.int64)
    for slab in range(-(-n // slab_rows)):
        r0 = slab << shift
        size = min(slab_rows, n - r0)
        bits = torch.zeros(((size + 31) // 32,), dtype=torch.int64)
        for o in buckets.get(slab, []):  # shared-memory atomicOr
            bits[o // 32] |= 1 << (o % 32)
        c = torch.arange((size + 15) // 16, dtype=torch.int64)
        half = (bits.index_select(0, c // 2) >> ((c % 2) * 16)) & 0xFFFF
        flags = (half[:, None] >> k) & 1
        keep[r0:r0 + size] = flags.reshape(-1)[:size].to(torch.bool)
        count += int(flags.sum())
    return keep, torch.tensor(count, dtype=torch.int32)


def _k12_model(order: np.ndarray, ids: Any, starts: Any, limit: Any, limits: Any,
               ge: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12's walk as ``row_select.cu`` takes it, then the bitmask steps:
    with one limit and rank < limit where ``num * limit <= n``, one
    (segment, rank) pair a thread and the tail test (the position's
    segment is still the pair's); else every position in sorted order."""
    n = len(order)
    num = 1 if ids is None else len(starts)
    seg = np.zeros(n, dtype=np.int64) if ids is None else np.where(
        (ids >= 0) & (ids < num), ids, -1)
    first = np.zeros(1, dtype=np.int64) if ids is None else np.asarray(starts, dtype=np.int64)
    if limits is None and not ge and (num == 0 or limit <= 0 or limit <= n // num):
        t = np.arange(num * limit if num > 0 and limit > 0 else 0)
        s = t // max(limit, 1)
        i = first[s] + t - s * limit if len(t) else t
        ok = (i >= 0) & (i < n)
        ok[ok] &= seg[i[ok]] == s[ok]
        rows = order[i[ok]]
    elif num == 0:
        rows = order[:0]
    else:
        i = np.arange(n)
        inside = seg >= 0
        s = np.where(inside, seg, 0)
        rank = i - first[s]
        lim = np.asarray(limits)[s] if limits is not None else limit
        kept = inside & (rank >= 0) & ((rank >= lim) if ge else (rank < lim))
        rows = order[kept]
    return _select_bits_model(torch.from_numpy(np.asarray(rows, dtype=np.int64)), n)


@pytest.mark.parametrize("n", [1, 31, 33, 64, 1000, 4099])
@pytest.mark.parametrize("case", ["take", "sample", "except all", "intersect all"])
def test_select_bits_model_matches_twins(case, n):
    """The model of K12's walk and of the two steps equals K12's and K13's
    twins bit for bit, the count included, on random cases at sizes that
    are and are not multiples of 32 (and of 16, the write's chunk)."""
    rng = np.random.default_rng(n)
    S = max(n // 20, 1)
    f = _sorted_frame(rng, n, S, "masked", "word64" if case == "take" else "id")
    limits = rng.integers(0, 4, S).astype(np.int32)
    limit = 3
    if case == "sample":
        order, ids, kw = f["order"], None, dict(limit=torch.tensor(max(n // 3, 1)))
    else:
        order, ids = f["order"], f["seg_ids"]
        kw = dict(seg=f["seg"], word_shift=f["word_shift"], starts=torch.from_numpy(f["starts"]))
        if case == "take":
            kw["limit"] = torch.tensor(limit)
        else:
            kw.update(limits=torch.from_numpy(limits),
                      mode="ge" if case == "except all" else "lt")
    keep, count = rank_keep_reference(torch.from_numpy(order), **kw)
    model, mcount = _k12_model(order, ids, f["starts"] if ids is not None else None,
                               int(kw["limit"]) if "limit" in kw else None,
                               limits if "limits" in kw else None, kw.get("mode") == "ge")
    assert torch.equal(model, keep) and int(mcount) == int(count)
    first = torch.from_numpy(rng.permutation(n + 5)[: max(n // 4, 1)].astype(np.int32))
    k13, c13 = first_row_mask_reference(first, n)
    m13, mc13 = _select_bits_model(first.long()[first < n], n)
    assert torch.equal(m13, k13) and int(mc13) == int(c13)
    # slabs of 64 rows, so that rows span many slabs and the last is short
    m13, mc13 = _select_bits_model(first.long()[first < n], n, shift=6)
    assert torch.equal(m13, k13) and int(mc13) == int(c13)


@pytest.mark.parametrize("how,thresh", [("any", None), ("all", None), ("any", 2), ("all", 4)])
@pytest.mark.parametrize("nmasks", [0, 1, 3, 70])
def test_null_count_keep_twin_matches_numpy(how, thresh, nmasks):
    rng = np.random.default_rng(nmasks)
    n, ncols = 120, nmasks + 2
    masks = [rng.random(n) > 0.3 for _ in range(nmasks)]
    real = rng.random(n) < 0.9
    keep, count = null_count_keep_reference([torch.from_numpy(m) for m in masks], ncols, n,
                                            row_valid=torch.from_numpy(real), how=how,
                                            thresh=thresh)
    valid = ncols - nmasks + sum(m.astype(np.int64) for m in masks)
    want = (valid >= thresh if thresh is not None else
            (valid == ncols if how == "any" else valid > 0)) & real
    np.testing.assert_array_equal(keep.numpy(), want)
    assert int(count) == want.sum()


@pytest.fixture()
def twins_as_kernels(monkeypatch: Any) -> None:
    """The new kernels' wrappers replaced by their twins (and K6's by its
    twin), so that ``chip_smoke.py``'s phases run on the CPU."""
    monkeypatch.setattr(factorize, "presort_word_cuda", reference.presort_word_reference)
    monkeypatch.setattr(row_select, "rank_keep_cuda", reference.rank_keep_reference)
    monkeypatch.setattr(row_select, "first_row_mask_cuda", reference.first_row_mask_reference)
    monkeypatch.setattr(row_select, "null_count_keep_cuda", reference.null_count_keep_reference)
    monkeypatch.setattr(expr_program, "expr_program_cuda",
                        lambda prog, inputs, n, device, **kw: reference.expr_program_reference(
                            prog, inputs, n, device=device, **kw))


def test_chip_smoke_row_select_vs_twin_on_cpu(twins_as_kernels):
    import chip_smoke

    chip_smoke.row_select_vs_twin(torch.device("cpu"), (1, 3001))


def test_chip_smoke_relational_timing_on_cpu(twins_as_kernels, monkeypatch):
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "time_cuda", lambda fn, reps: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "ROWS", 5000)
    monkeypatch.setattr(chip_smoke, "GROUPS", 16)
    monkeypatch.setattr(chip_smoke, "DISTINCT_VALUES", 10)
    entries = chip_smoke.relational_timing(torch.device("cpu"), dict.fromkeys(
        ("presort_word", "rank_keep", "rank_keep_take", "rank_keep_except_all",
         "first_row_mask", "null_count_keep", "expr_program_fillna"), 1))
    assert [e["name"] for e in entries] == [
        "presort_word", "rank_keep", "rank_keep[top-n take]", "rank_keep[except all]",
        "first_row_mask", "null_count_keep", "expr_program[fillna 4 float64]"]
    assert all(set(e) == set(chip_smoke._ENTRY_KEYS) for e in entries)


def test_chip_smoke_relational_paths_on_cpu(monkeypatch):
    """``chip_smoke.py``'s relational paths at 30,000 rows on the CPU,
    each checked inside the phase against numpy; the Q38/Q87 name lists
    cut so that the two channels share rows."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "Q_NAMES", (40, 10))
    monkeypatch.setattr(chip_smoke, "Q_DAYS", 12)
    stats = chip_smoke.relational_paths(torch.device("cpu"), 30_000, 1, q_rows=(30_000, 15_000))
    by_case = {s["case"]: s for s in stats}
    assert list(by_case) == list(chip_smoke.RELATIONAL_PATH_LAUNCHES)
    assert by_case["take_top_n"]["kept_rows"] == chip_smoke.TAKE_N * chip_smoke.GROUPS
    assert by_case["take_global"]["kept_rows"] == chip_smoke.GLOBAL_TAKE_N
    assert 0 < by_case["intersect_all"]["kept_rows"] < 30_000
    assert by_case["except_distinct"]["kept_rows"] < 4_800  # the distinct rows
    assert by_case["sample_frac"]["kept_rows"] == 300
