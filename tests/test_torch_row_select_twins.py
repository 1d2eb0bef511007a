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

from typing import Any, List

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


def _rank_oracle(order: np.ndarray, real: np.ndarray, seg: Any, starts: Any, limit: Any,
                 limits: Any, ge: bool) -> np.ndarray:
    keep = np.zeros(len(order), dtype=bool)
    for i, row in enumerate(order):
        if not real[row]:
            continue
        rank, lim = i, limit
        if seg is not None:
            s = seg[row]
            if not 0 <= s < len(starts):
                continue
            rank = i - starts[s]
            lim = limits[s] if limits is not None else limit
        keep[row] = rank >= lim if ge else rank < lim
    return keep


@pytest.mark.parametrize("segmented", ["global", "one_limit", "limits"])
@pytest.mark.parametrize("mode", ["lt", "ge"])
@pytest.mark.parametrize("seed", [0, 1])
def test_rank_keep_twin_matches_numpy(segmented, mode, seed):
    rng = np.random.default_rng(seed)
    n, S = 300, 7
    order = rng.permutation(n)
    real = rng.random(n) < 0.8
    seg = rng.integers(0, S + 1, n).astype(np.int32)  # S: the sentinel
    starts = rng.integers(0, n, S)
    limits = rng.integers(0, 50, S).astype(np.int32)
    limit = 120
    kw: Any = dict(row_valid=torch.from_numpy(real), limit=torch.tensor(limit), mode=mode)
    if segmented != "global":
        kw.update(seg=torch.from_numpy(seg), starts=torch.from_numpy(starts))
    if segmented == "limits":
        kw.update(limit=None, limits=torch.from_numpy(limits))
    keep, count = rank_keep_reference(torch.from_numpy(order), **kw)
    want = _rank_oracle(order, real, seg if segmented != "global" else None, starts, limit,
                        limits if segmented == "limits" else None, mode == "ge")
    np.testing.assert_array_equal(keep.numpy(), want)
    assert int(count) == want.sum() and count.dtype == torch.int32


def test_rank_keep_twin_refuses_inconsistent_arguments():
    order = torch.arange(4)
    with pytest.raises(ValueError, match="exactly one of limit"):
        rank_keep_reference(order, nrows=4)
    with pytest.raises(ValueError, match="seg and starts"):
        rank_keep_reference(order, nrows=4, limits=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="rank mode"):
        rank_keep_reference(order, nrows=4, limit=torch.tensor(1), mode="le")


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
        ("presort_word", "rank_keep", "first_row_mask", "null_count_keep",
         "expr_program_fillna"), 1))
    assert [e["name"] for e in entries] == ["presort_word", "rank_keep", "first_row_mask",
                                            "null_count_keep", "expr_program[fillna 4 float64]"]
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
