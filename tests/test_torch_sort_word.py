"""The sort path's word route: ``groupby.sort_word`` and
``groupby.sort_factorize`` of ``fugue_tpu_torch/torch_backend/groupby.py``
with the twins of KW, K2w and K3w (``sort_word_reference``,
``sort_word_boundaries_reference``, ``sort_word_lookup_reference`` in
``fugue_tpu_torch/kernels/reference.py``), against the lexicographic
order of the port's sort codes (``sort_codes`` + ``lex_sort``) and
against the JAX package's ``_sort_factorize`` on one CPU device. Frames
are built with ``from_arrow`` on both sides from the same seeded numpy
data; prefix frames with ``nrows`` below their padded rows and masked
frames get the same layout on both sides.

Tolerances: none. Sort orders, segment ids, group counts, first rows,
routes, keys and counts exactly."""

from typing import Any, Dict, List, Optional, Tuple

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from fugue_tpu.jax_backend import blocks as jblocks
from fugue_tpu.jax_backend import groupby as jgroupby
from fugue_tpu.schema import Schema as JSchema
from fugue_tpu_torch.kernels.factorize import (
    sort_word_boundaries_cuda,
    sort_word_cuda,
    sort_word_lookup_cuda,
)
from fugue_tpu_torch.kernels.reference import (
    sort_finish_reference,
    sort_word_boundaries_reference,
    sort_word_lookup_reference,
    sort_word_reference,
    word_bits,
)
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend import blocks as tblocks
from fugue_tpu_torch.torch_backend import groupby

CPU = torch.device("cpu")
N = 2000
_SHORT = N // 2 + 7  # a prefix frame's real rows, below its padded rows

# values each dtype's keys are drawn from: the extremes and the values
# whose order the word's fields must get right, and a few ordinary ones
_POOLS: Dict[str, np.ndarray] = {
    "float32": np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.1754944e-38, -1.5, 2.25,
                         3.4028235e38, -3.4028235e38], dtype=np.float32),
    "float64": np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 2.2250738585072014e-308, -1.5,
                         2.25, 1.7976931348623157e308, -1.7976931348623157e308]),
    "int64": np.array([-(2**63), 2**63 - 1, 2**32, -(2**32), 2**32 + 1, 2**31, -(2**31) - 1,
                       -1, 0, 1, 7], dtype=np.int64),
    "int32": np.array([-(2**31), 2**31 - 1, -1, 0, 1, 2**16, -(2**16)], dtype=np.int32),
    "int16": np.array([-(2**15), 2**15 - 1, -1, 0, 1], dtype=np.int16),
    "int8": np.array([-128, 127, -1, 0, 1], dtype=np.int8),
    "uint8": np.array([0, 1, 127, 128, 255], dtype=np.uint8),
    "bool": np.array([False, True]),
}
# keys the JAX package gets wrong, where the port is held against numpy:
# subnormal floats, which it merges with 0.0 (XLA on the CPU flushes them
# to zero, so its ``v == 0`` canonicalization zeroes them), and nullable
# int64 keys beyond 2^53, which its ingest casts through float64
# (``fugue_tpu/jax_backend/blocks.py:451``)
_SUBNORMALS = {
    "float32": np.array([1e-45, -1e-45, 1e-40, -3e-39], dtype=np.float32),
    "float64": np.array([5e-324, -5e-324, 1e-310, -3e-309]),
}
_INT64_EXTREMES = np.array([-(2**63), 2**63 - 1, 2**53 + 1, -(2**53) - 3], dtype=np.int64)

# (name, dtype, nullable) per key; the route expected on a prefix frame,
# a prefix frame with nrows below its rows, and a masked frame (the "not
# real" bit takes one more bit in the last two)
_CASES: Dict[str, Tuple[List[Tuple[str, str, bool]], Tuple[str, str, str]]] = {
    "float32": ([("k", "float32", False)], ("word32", "word64", "word64")),
    "float64": ([("k", "float64", False)], ("word64", "wide", "wide")),
    "int64": ([("k", "int64", False)], ("word64", "wide", "wide")),
    "int32": ([("k", "int32", False)], ("word32", "word64", "word64")),
    "bool": ([("k", "bool", False)], ("word32", "word32", "word32")),
    "uint8": ([("k", "uint8", False)], ("word32", "word32", "word32")),
    "int16_int8": ([("a", "int16", False), ("b", "int8", False)],
                   ("word32", "word32", "word32")),
    "nullable_int32": ([("k", "int32", True)], ("word64", "word64", "word64")),
    "nullable_float32": ([("k", "float32", True)], ("word64", "word64", "word64")),
    "nullable_bool": ([("k", "bool", True)], ("word32", "word32", "word32")),
    "nullable_int64": ([("k", "int64", True)], ("wide", "wide", "wide")),
    "nullable_float64": ([("k", "float64", True)], ("wide", "wide", "wide")),
    "int32_float32": ([("a", "int32", False), ("b", "float32", False)],
                      ("word64", "wide", "wide")),
    "float32_int64": ([("a", "float32", False), ("b", "int64", False)],
                      ("wide", "wide", "wide")),
}
_LAYOUTS = ("prefix", "prefix_short", "masked")


def _table(case: str) -> pa.Table:
    """The case's keys over ``N`` rows from its pools (ties on every
    value), 20 % null where the key is nullable."""
    rng = np.random.default_rng(59)
    cols = {}
    for name, dtype, nullable in _CASES[case][0]:
        pool = _POOLS[dtype]
        if nullable and dtype == "int64":  # within 2^53 (``_INT64_EXTREMES``)
            pool = pool[np.abs(pool.astype(np.float64)) < 2**53]
        values = pool[rng.integers(0, len(pool), N)]
        cols[name] = pa.array(values, mask=rng.random(N) < 0.2 if nullable else None)
    return pa.table(cols)


def _frames(table: pa.Table, layout: str) -> Tuple[tblocks.TorchBlocks, Any]:
    """The same rows as the port's and the JAX package's blocks (one CPU
    device) in ``layout``."""
    port = tblocks.from_arrow(table, Schema(table.schema), CPU)
    ref = jblocks.from_arrow(table, JSchema(table.schema), jblocks.make_mesh([jax.devices()[0]]))
    if layout == "prefix_short":
        port._nrows = ref._nrows = _SHORT
    elif layout == "masked":
        valid = np.random.default_rng(61).random(table.num_rows) < 0.6
        port.row_valid, port._nrows = torch.from_numpy(valid), None
        ref.row_valid, ref._nrows = jax.numpy.asarray(valid), None
    return port, ref


@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("layout", _LAYOUTS)
def test_word_route_matches_jax_sort_factorize(case, layout):
    """``seg``, the group count and ``first_idx`` of the port's sort path
    equal the JAX package's ``_sort_factorize`` exactly, on the route the
    keys' width gives."""
    table = _table(case)
    keys = table.column_names
    port, ref = _frames(table, layout)
    fr = groupby._sort_factorize(port, keys)
    route = groupby.sort_factorize.last_route
    want_route = _CASES[case][1][_LAYOUTS.index(layout)]
    assert route.split("/")[0] == want_route
    if want_route != "wide":
        assert route.endswith("/lookup")  # a few groups: the lookup table
    jfr = jgroupby._sort_factorize(ref, keys)
    assert fr.num_segments == jfr.num_segments
    assert fr.seg.dtype == fr.first_idx.dtype == torch.int32
    np.testing.assert_array_equal(fr.seg.numpy(), np.asarray(jfr.seg))
    np.testing.assert_array_equal(fr.first_idx.numpy(), np.asarray(jfr.first_idx))
    assert int(fr.num_groups_dev) == int(jfr.num_groups_dev)


@pytest.mark.parametrize("case,layout", [("float32", "prefix"), ("int64", "prefix"),
                                         ("nullable_int32", "masked"),
                                         ("int16_int8", "prefix_short")])
def test_scatter_route_matches_jax_sort_factorize(case, layout, monkeypatch):
    """Above ``LOOKUP_MAX_GROUPS`` groups the word route scatters
    K2w's sorted ids (K3's twin) and gives the same ids and first rows."""
    monkeypatch.setattr(groupby, "LOOKUP_MAX_GROUPS", 0)
    table = _table(case)
    port, ref = _frames(table, layout)
    fr = groupby._sort_factorize(port, table.column_names)
    assert groupby.sort_factorize.last_route.endswith("/scatter")
    jfr = jgroupby._sort_factorize(ref, table.column_names)
    assert fr.num_segments == jfr.num_segments
    np.testing.assert_array_equal(fr.seg.numpy(), np.asarray(jfr.seg))
    np.testing.assert_array_equal(fr.first_idx.numpy(), np.asarray(jfr.first_idx))


def _rows(layout: str) -> Dict[str, Any]:
    if layout == "prefix":
        return {"nrows": N}
    if layout == "prefix_short":
        return {"nrows": _SHORT}
    return {"row_valid": torch.from_numpy(np.random.default_rng(61).random(N) < 0.6)}


@pytest.mark.parametrize("case,layout", [
    (case, layout) for case in _CASES for layout in ("prefix", "masked")
    if _CASES[case][1][_LAYOUTS.index(layout)] != "wide"
])
def test_lookup_twin_matches_finish_twin(case, layout):
    """Over the same keys, K3w's twin (a search of each row's word among
    K2w's distinct words) gives the ids that K3's twin scatters from K2w's
    sorted ids, and K2w's first rows are K3's."""
    port, _ = _frames(_table(case), "prefix")
    rows = _rows(layout)
    keys = [(c.data, c.mask) for c in port.columns.values()]
    sw = sort_word_reference(keys, **rows)
    sorted_words, order = torch.sort(sw.word, stable=True)
    uniq, first_idx, seg_sorted, count = sort_word_boundaries_reference(
        sorted_words, order, real_below=sw.real_below
    )
    num = int(count)
    seg = sort_word_lookup_reference(sw.word, uniq, num, real_below=sw.real_below)
    want_seg, want_first = sort_finish_reference(seg_sorted, order, num)
    assert seg.dtype == torch.int32
    assert torch.equal(seg, want_seg)
    assert torch.equal(first_idx[:num], want_first)


def _numpy_factorize(codes: List[np.ndarray], real: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(seg, first_idx)`` of the real rows in the lexicographic order of
    ``codes`` (numpy's stable ``lexsort``): the sort path's contract, with
    ``num`` on the rows that are not real."""
    rows = np.flatnonzero(real)
    order = rows[np.lexsort([c[rows] for c in reversed(codes)])]
    opens = np.zeros(len(order), dtype=bool)
    opens[:1] = True
    for c in codes:
        opens[1:] |= c[order][1:] != c[order][:-1]
    gid = np.cumsum(opens) - 1
    seg = np.full(len(real), opens.sum(), dtype=np.int32)
    seg[order] = gid
    return seg, order[opens].astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "float64", "nullable int64"])
@pytest.mark.parametrize("layout", _LAYOUTS)
def test_keys_the_reference_gets_wrong_match_numpy(dtype, layout):
    """Float keys with subnormals beside zeros of both signs, infinities and
    NaN, and nullable int64 keys at +-2^63 and beyond 2^53: one group per
    distinct key (-0.0 with +0.0, every NaN in one group after +inf, every
    null in one group after the rest), in the JAX package's group order
    (floats ascending; int64 by low word, then high word), each with its
    first real row, as a numpy ``lexsort`` of the same codes gives them."""
    rng = np.random.default_rng(67)
    mask = None
    if dtype == "nullable int64":
        pool = np.concatenate([_POOLS["int64"], _INT64_EXTREMES])
        values = pool[rng.integers(0, len(pool), N)]
        mask = rng.random(N) >= 0.2
        words = np.where(mask, values, 0).view(np.int32).reshape(-1, 2)
        codes = [(~mask).astype(np.int32), words[:, 0], words[:, 1]]
    else:
        pool = np.concatenate([_POOLS[dtype], _SUBNORMALS[dtype]])
        values = pool[rng.integers(0, len(pool), N)]
        nan = np.isnan(values)
        codes = [nan.astype(np.int32), np.where((values == 0) | nan, 0, values)]
    table = pa.table({"k": pa.array(values, mask=None if mask is None else ~mask)})
    port, _ = _frames(table, layout)
    fr = groupby._sort_factorize(port, ["k"])
    real = np.ones(N, dtype=bool)
    if layout == "prefix_short":
        real[_SHORT:] = False
    elif layout == "masked":
        real = port.row_valid.numpy()
    want_seg, want_first = _numpy_factorize(codes, real)
    assert fr.num_segments == len(want_first)
    np.testing.assert_array_equal(fr.seg.numpy(), want_seg)
    np.testing.assert_array_equal(fr.first_idx.numpy(), want_first)


def _column(draw: Any, dtype: str, n: int) -> np.ndarray:
    """``n`` values of ``dtype``: each from the dtype's pool (ties and
    extremes, subnormals included) or anywhere in the type's range."""
    pool = np.concatenate([_POOLS[dtype], _SUBNORMALS.get(dtype, _POOLS[dtype][:0])])
    if dtype == "bool":
        anywhere = st.booleans()
    elif dtype.startswith("float"):
        anywhere = st.floats(width=32 if dtype == "float32" else 64)
    else:
        info = np.iinfo(dtype)
        anywhere = st.integers(int(info.min), int(info.max))
    values = draw(st.lists(st.one_of(st.sampled_from(list(pool)), anywhere),
                           min_size=n, max_size=n))
    return np.array(values, dtype=dtype)


@settings(max_examples=150, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(st.data())
def test_sort_word_orders_as_the_sort_codes(data):
    """A stable sort of the word gives the permutation of ``lex_sort`` over
    ``sort_codes``, ties included, for one to three keys of any dtype,
    nullable or not, that fit 64 bits, on every frame layout; the word is an
    int32 exactly when its fields fit 32 bits, and ``real_below`` splits the
    real rows from the rest."""
    n = data.draw(st.integers(1, 64), label="n")
    specs = data.draw(st.lists(st.tuples(st.sampled_from(sorted(_POOLS)), st.booleans()),
                               min_size=1, max_size=3), label="keys")
    keys: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
    for dtype, nullable in specs:
        values = torch.from_numpy(_column(data.draw, dtype, n))
        mask = None
        if nullable:
            mask = torch.tensor(data.draw(st.lists(st.booleans(), min_size=n, max_size=n)))
        keys.append((values, mask))
    layout = data.draw(st.sampled_from(_LAYOUTS), label="layout")
    if layout == "prefix":
        rows: Dict[str, Any] = {"nrows": n}
    elif layout == "prefix_short":
        rows = {"nrows": data.draw(st.integers(0, n - 1)) if n > 1 else 0}
    else:
        rows = {"row_valid": torch.tensor(data.draw(st.lists(st.booleans(), min_size=n,
                                                             max_size=n)))}
    unreal = layout != "prefix"
    bits = word_bits(keys, unreal)
    sw = groupby.sort_word(keys, **rows)
    if bits > 64:
        assert sw is None
        return
    assert sw.word.dtype == (torch.int32 if bits <= 32 else torch.int64)
    order = torch.sort(sw.word, stable=True).indices
    want = groupby.lex_sort(groupby.sort_codes(keys), **rows)[0]
    assert torch.equal(order, want)
    if unreal:
        real = rows["row_valid"] if layout == "masked" else torch.arange(n) < rows["nrows"]
        assert torch.equal(sw.word < sw.real_below, real)
    else:
        assert sw.real_below is None


def test_word_wrappers_refuse_cpu_tensors():
    words = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sort_word_cuda([(words, None)], nrows=4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sort_word_boundaries_cuda(words, torch.arange(4))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sort_word_lookup_cuda(words, words, 1)


@pytest.mark.parametrize("case,lookup_groups,route", [
    ("wide_key", None, "wide"),
    ("float_key", 0, "word32/scatter"),
    ("int64_key", None, "word64/lookup"),
])
def test_chip_smoke_sort_path_routes_on_cpu(case, lookup_groups, route, monkeypatch):
    """The sort-path phase of ``chip_smoke.py`` on the CPU at a small size
    (the card runs it at 100M rows) on each route; it checks itself
    against numpy and reports the route it took."""
    if lookup_groups is not None:
        monkeypatch.setattr(groupby, "LOOKUP_MAX_GROUPS", lookup_groups)
    (stats,) = chip_smoke.sort_path_aggregates(CPU, 20_000, 64, 42, 1, cases=(case,))
    assert stats["route"] == route and stats["groups"] == 64
    assert max(stats["max_rel_err"].values()) < 1e-5
    assert stats["launches"] == dict.fromkeys(stats["launches"], 0)  # the CPU runs the twins


@pytest.mark.parametrize("extra", [0, 37])
def test_uint64_words_above_2_63_order_as_numpy(extra):
    """A uint64 column's stored words (its values with the sign bit flipped):
    KW's twin gives equal values one word and distinct values distinct
    words, as the group-by needs (its int64 field orders as the codes, low
    word first, not by value); K11's twin, with the engine's field (``kmin``
    the type's minimum, 64 bits), orders them as numpy's unsigned sort,
    values above 2^63 included."""
    from fugue_tpu_torch.kernels.reference import PresortKey, presort_word_reference

    rng = np.random.default_rng(5)
    values = np.concatenate([rng.integers(0, 2**63, 300, dtype=np.uint64),
                             rng.integers(2**63, 2**64 - 1, 300, dtype=np.uint64),
                             np.array([0, 2**63 - 1, 2**63, 2**64 - 1], dtype=np.uint64)])
    values = np.concatenate([values, values[:100 + extra]])
    rng.shuffle(values)
    n = len(values)
    words = torch.from_numpy(tblocks.to_storage(values, pa.uint64()))
    mask = None  # a nullable 64-bit key takes 65 bits: the wide route, not a word
    valid = np.ones(n, bool)
    sw = sort_word_reference([(words, mask)], nrows=n).word.numpy()
    pairs = set(zip(sw[valid].tolist(), values[valid].tolist()))
    assert len(pairs) == len(set(values[valid].tolist())) == len(set(sw[valid].tolist()))
    pk = presort_word_reference([PresortKey(words, mask, desc=True, nulls_first=False,
                                            nan_is_null=True, kmin=-2**63, bits=64)], nrows=n)
    down = torch.sort(pk, stable=True).indices.numpy()
    assert np.array_equal(values[down][:int(valid.sum())], np.sort(values[valid])[::-1])
    assert not valid[down][int(valid.sum()):].any()
