"""Streaming aggregation on the port (``ft.aggregate`` of a
``LocalDataFrameIterableDataFrame`` on ``device="cpu"``, K19's twin)
against the JAX engine pinned to one CPU device aggregating the same
chunks as an ``IterablePandasDataFrame``: the cases of
``tests/fugue_tpu/jax_backend/test_streaming.py:56-243`` (the full frame
matched, a growing key range and its rebases, null keys falling back
(counted), an empty stream, int64 beyond 2^53 exactly, an all-null group
as NULL, ragged chunks, two keys), with float sums within rtol 1e-9 and
everything else exact; then K19's twin against numpy."""

from typing import Any, Callable, List

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import fugue_tpu_torch as ft
from fugue_tpu.collections.partition import PartitionSpec as JPartitionSpec
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.dataframe import PandasDataFrame
from fugue_tpu.dataframe.dataframe_iterable_dataframe import IterablePandasDataFrame
from fugue_tpu_torch import col
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.kernels.reference import FoldOp, fold_init, stream_fold_reference
from fugue_tpu_torch.torch_backend import streaming
from test_torch_join import _jax_engine

RTOL = 1e-9


def run_both(make: Callable[[], List[pd.DataFrame]], schema: str, keys: List[str],
             aggs: List[Any]) -> Any:
    """The chunks of ``make()`` aggregated by ``keys`` on both engines
    (``aggs``: ``(name, function name, column)``); returns both results as
    arrow tables and the port's engine."""
    je = _jax_engine()
    src = IterablePandasDataFrame((PandasDataFrame(p, schema) for p in make()), schema)
    want = je.aggregate(src, JPartitionSpec(by=keys),
                        [getattr(jff, f)(jcol(c)).alias(n) for n, f, c in aggs])
    te = ft.make_execution_engine(device="cpu")
    got = ft.aggregate(ft.LocalDataFrameIterableDataFrame(iter(make()), schema), keys,
                       engine=te, as_fugue=True,
                       **{n: getattr(ff, f)(col(c)) for n, f, c in aggs})
    return got.as_arrow(), want.as_arrow(), te, je


def assert_same(got: pa.Table, want: pa.Table, keys: List[str]) -> None:
    assert got.schema == want.schema, (got.schema, want.schema)
    g = got.to_pandas().sort_values(keys).reset_index(drop=True)
    w = want.to_pandas().sort_values(keys).reset_index(drop=True)
    assert len(g) == len(w)
    for c in g.columns:
        gv, wv = g[c].to_numpy(), w[c].to_numpy()
        assert np.array_equal(pd.isna(g[c]).to_numpy(), pd.isna(w[c]).to_numpy()), c
        ok = ~pd.isna(w[c]).to_numpy()
        if g[c].dtype.kind == "f":
            np.testing.assert_allclose(gv[ok].astype(float), wv[ok].astype(float), rtol=RTOL)
        else:
            assert gv[ok].tolist() == wv[ok].tolist(), c


def _chunks(n_chunks: int, rows: int, seed: int = 0) -> Callable[[], List[pd.DataFrame]]:
    def make() -> List[pd.DataFrame]:
        rng = np.random.default_rng(seed)
        return [pd.DataFrame({"k": rng.integers(0, 32, rows).astype(np.int64),
                              "v": rng.random(rows)}) for _ in range(n_chunks)]
    return make


FIVE = [("s", "sum", "v"), ("m", "avg", "v"), ("c", "count", "v"), ("lo", "min", "v"),
        ("hi", "max", "v")]


def test_stream_aggregate_matches_full() -> None:
    got, want, te, je = run_both(_chunks(8, 500), "k:long,v:double", ["k"], FIVE)
    assert_same(got, want, ["k"])
    full = pd.concat(_chunks(8, 500)()).groupby("k").v.agg(["sum", "count", "min", "max"])
    g = got.to_pandas().set_index("k")
    np.testing.assert_allclose(g.s, full["sum"], rtol=RTOL)
    assert g.c.tolist() == full["count"].tolist() and g.lo.tolist() == full["min"].tolist()
    assert te.fallbacks == {} and te.stream_stats["chunks"] == 8


def test_growing_key_range_rebases() -> None:
    def make() -> List[pd.DataFrame]:
        return [pd.DataFrame({"k": np.arange(b, b + 10, dtype=np.int64), "v": np.ones(10)})
                for b in (0, 100, 50)]

    got, want, te, _ = run_both(make, "k:long,v:double", ["k"], [("s", "sum", "v")])
    assert_same(got, want, ["k"])
    assert got.num_rows == 30
    # [0, 9] -> [0, 109]; 50..59 lands inside
    assert te.stream_stats["rebases"] == 1 and te.stream_stats["group_slots"] == 110


def test_null_keys_fall_back_to_the_bounded_path() -> None:
    def make() -> List[pd.DataFrame]:
        return [pd.DataFrame({"k": [1.0, 2.0], "v": [1.0, 2.0]}),
                pd.DataFrame({"k": [1.0, None], "v": [3.0, 4.0]})]

    got, want, te, je = run_both(make, "k:long,v:double", ["k"], [("s", "sum", "v")])
    assert_same(got, want, ["k"])
    assert te.fallbacks == {"aggregate": 1} == je.fallbacks


def test_empty_stream_gives_an_empty_result() -> None:
    got, want, te, _ = run_both(lambda: [], "k:long,v:double", ["k"], [("s", "sum", "v")])
    assert got.num_rows == want.num_rows == 0
    assert got.schema == want.schema
    assert te.fallbacks == {"aggregate": 1}


def test_int64_beyond_2_53_is_exact() -> None:
    big = (1 << 55) + 3

    def make() -> List[pd.DataFrame]:
        return [pd.DataFrame({"k": np.zeros(2, dtype=np.int64),
                              "v": np.array([big, big + 1], dtype=np.int64)})
                for _ in range(2)]

    aggs = [("s", "sum", "v"), ("lo", "min", "v"), ("hi", "max", "v")]
    got, want, _, _ = run_both(make, "k:long,v:long", ["k"], aggs)
    assert str(got.schema) == str(want.schema)
    assert got.to_pylist() == want.to_pylist() == [
        {"k": 0, "s": 2 * (2 * big + 1), "lo": big, "hi": big + 1}]


def test_all_null_group_is_null() -> None:
    def make() -> List[pd.DataFrame]:
        return [pd.DataFrame({"k": [0, 1], "v": [np.nan, 5.0]})]

    got, want, _, _ = run_both(make, "k:long,v:double", ["k"],
                               [("s", "sum", "v"), ("lo", "min", "v")])
    assert_same(got, want, ["k"])
    assert got.to_pylist()[0] == {"k": 0, "s": None, "lo": None}


def test_ragged_chunks() -> None:
    lens = [100, 150, 90, 201, 255, 130, 180]

    def make() -> List[pd.DataFrame]:
        rng = np.random.default_rng(1)
        return [pd.DataFrame({"k": rng.integers(0, 4, n).astype(np.int64),
                              "v": rng.random(n)}) for n in lens]

    got, want, te, _ = run_both(make, "k:long,v:double", ["k"], [("c", "count", "v")])
    assert_same(got, want, ["k"])
    assert sum(got.column("c").to_pylist()) == sum(lens)
    assert te.stream_stats["rows"] == sum(lens) and te.stream_stats["traces"] == 0


def test_two_keys() -> None:
    def make() -> List[pd.DataFrame]:
        return [pd.DataFrame({"a": np.arange(20, dtype=np.int64) % 3,
                              "b": (np.arange(20, dtype=np.int64) + i) % 2,
                              "v": np.full(20, float(i))}) for i in range(4)]

    got, want, _, _ = run_both(make, "a:long,b:long,v:double", ["a", "b"],
                               [("s", "sum", "v"), ("c", "count", "v")])
    assert_same(got, want, ["a", "b"])


def test_nullable_int_payloads_and_count_star() -> None:
    """int32 and bool keys, an int64 payload with nulls (pandas' NaN) and
    a float one with NaN: every function, and COUNT(*)."""
    def make() -> List[pd.DataFrame]:
        rng = np.random.default_rng(3)
        out = []
        for _ in range(3):
            q = rng.integers(-50, 50, 300).astype(np.float64)
            q[rng.random(300) < 0.1] = np.nan
            p = rng.random(300)
            p[rng.random(300) < 0.1] = np.nan
            out.append(pd.DataFrame({"s": rng.integers(-3, 4, 300).astype(np.int32),
                                     "f": rng.random(300) < 0.5, "q": q, "p": p}))
        return out

    aggs = [(f"{c}_{f}", f, c) for c in ("q", "p") for f in ("sum", "count", "min", "max",
                                                              "avg")]
    aggs.append(("n", "count", "*"))
    got, want, te, _ = run_both(make, "s:int,f:bool,q:long,p:double", ["s", "f"], aggs)
    assert_same(got, want, ["s", "f"])
    assert te.fallbacks == {}


def test_float_keys_take_the_bounded_aggregate() -> None:
    te = ft.make_execution_engine(device="cpu")
    chunks = [pd.DataFrame({"k": [0.5, 1.5, 0.5], "v": [1.0, 2.0, 3.0]})]
    got = ft.aggregate(ft.LocalDataFrameIterableDataFrame(iter(chunks)), "k", engine=te,
                       s=ff.sum(col("v")))
    assert sorted(got.itertuples(index=False)) == [(0.5, 4.0), (1.5, 2.0)]
    assert te.stream_stats == {} and te.fallbacks == {}


def test_stream_fold_twin_matches_numpy() -> None:
    """K19's twin over two keys (mixed radix), an int64 payload beyond
    2^53 and a float64 one, both masked, every op kind, folded twice."""
    rng = np.random.default_rng(11)
    bounds = [(-3, 5), (10, 7)]
    slots = 35
    kinds = [("rows", -1), ("count", 0), ("sum_i", 0), ("sum_if", 0), ("min_i", 0),
             ("max_i", 0), ("count", 1), ("sum_f", 1), ("min_f", 1), ("max_f", 1)]
    ops = [FoldOp(k, p, j) for j, (k, p) in enumerate(kinds)]
    store = torch.tensor([fold_init(op.kind) for op in ops]).unsqueeze(0).repeat(slots, 1)
    want = {k: [] for k in ("seg", "i", "im", "f", "fm")}
    for _ in range(2):
        n = 400
        k1 = rng.integers(-3, 2, n)
        k2 = rng.integers(10, 17, n)
        ints = (1 << 58) + rng.integers(-1000, 1000, n)
        floats = rng.standard_normal(n)
        im, fm = rng.random(n) > 0.2, rng.random(n) > 0.2
        stream_fold_reference(
            [torch.from_numpy(k1), torch.from_numpy(k2)], bounds,
            [(torch.from_numpy(ints), torch.from_numpy(im)),
             (torch.from_numpy(floats), torch.from_numpy(fm))], ops, store)
        for key, v in (("seg", (k1 + 3) * 7 + (k2 - 10)), ("i", ints), ("im", im),
                       ("f", floats), ("fm", fm)):
            want[key].append(v)
    seg, ints, im, floats, fm = (np.concatenate(want[k]) for k in ("seg", "i", "im", "f", "fm"))
    assert store[:, 0].tolist() == np.bincount(seg, minlength=slots).tolist()
    assert store[:, 1].tolist() == np.bincount(seg[im], minlength=slots).tolist()
    sums = np.zeros(slots, dtype=np.int64)
    np.add.at(sums, seg[im], ints[im])
    assert store[:, 2].tolist() == sums.tolist()
    np.testing.assert_allclose(store[:, 3].view(torch.float64).numpy(),
                               np.bincount(seg[im], ints[im].astype(float), slots), rtol=RTOL)
    lo = np.full(slots, np.iinfo(np.int64).max)
    np.minimum.at(lo, seg[im], ints[im])
    assert store[:, 4].tolist() == lo.tolist()
    np.testing.assert_allclose(store[:, 7].view(torch.float64).numpy(),
                               np.bincount(seg[fm], floats[fm], slots), rtol=RTOL, atol=1e-12)
    got_min = streaming._from_order_key(store[:, 8], torch.float64).numpy()
    fmin = np.full(slots, np.inf)
    np.minimum.at(fmin, seg[fm], floats[fm])
    assert np.array_equal(got_min, fmin)


def test_aggregator_stats_and_pad_spans() -> None:
    """``pad_spans`` rounds each span up to a power of two, so growth
    within it needs no rebase; ``stats()`` counts no traces or programs
    (the port compiles none)."""
    te = ft.make_execution_engine(device="cpu")
    schema = ft.Schema("k:long,v:double")
    agg = streaming.StreamingAggregator(te, schema, ["k"], [("s", "sum", "v")], pad_spans=True)
    for base in (0, 3, 5):
        agg.fold(pd.DataFrame({"k": np.arange(base, base + 3, dtype=np.int64),
                               "v": np.ones(3)}))
    assert agg.stats() == {"traces": 0, "programs": 0, "rebases": 1, "chunks": 3, "rows": 9,
                           "group_slots": 8}
    out = agg.finalize().as_pandas()
    assert out.k.tolist() == list(range(8)) and out.s.tolist() == [1, 1, 1, 1, 1, 2, 1, 1]
    with pytest.raises(streaming.StreamUnsupported, match="key space too large"):
        agg.fold(pd.DataFrame({"k": np.array([0, 1 << 30]), "v": [1.0, 2.0]}))


def test_chip_smoke_streaming_phases_on_cpu(monkeypatch: pytest.MonkeyPatch) -> None:
    """``chip_smoke.stream_fold_vs_twin`` and ``stream_path`` at small
    sizes with K19's twin standing in for the kernel."""
    import chip_smoke
    from fugue_tpu_torch.kernels import stream

    def fold(*args: Any) -> Any:
        fold.launches += 1  # type: ignore[attr-defined]
        return stream_fold_reference(*args)

    fold.launches = 0  # type: ignore[attr-defined]
    monkeypatch.setattr(stream, "stream_fold_cuda", fold)
    chip_smoke.stream_fold_vs_twin(torch.device("cpu"), (1, 2001))
    monkeypatch.setattr(chip_smoke, "STREAM_STORES", 50)
    monkeypatch.setattr(chip_smoke, "STREAM_ITEMS", (40, 60))
    st = chip_smoke.stream_path(torch.device("cpu"), 8, 5000, 1)
    assert 0 < st["groups"] <= 3000 and st["rebases_per_run"] == 1


# ---- K19's slab plan and a model of its four steps --------------------------

from fugue_tpu_torch.kernels import stream as stream_kernels  # noqa: E402
from fugue_tpu_torch.kernels.reference import fold_segments  # noqa: E402


@pytest.mark.parametrize("width,slots,shift,nslabs", [
    (1, 1_000_000, 14, 62), (20, 1_000_000, 10, 977), (20, 1024, 10, 1), (20, 1025, 10, 2),
    (48, 1 << 22, 8, 1 << 14), (21, 5000, 9, 10), (3, 100, 12, 1)])
def test_fold_plan_slab_slots_follow_the_width(width, slots, shift, nslabs):
    """A slab is the most slots whose accumulators fit ``IMAGE_BYTES``
    (a power of two); a store of one slab takes the direct route with no
    scratch."""
    ops = [FoldOp("count", j, j) for j in range(width)]  # distinct: one accumulator each
    plan = stream_kernels.fold_plan(width, slots, 10_000_000, ops, width)
    assert plan.accumulators == width
    assert (plan.shift, plan.nslabs) == (shift, nslabs)
    assert (width << plan.shift) * 8 <= stream_kernels.IMAGE_BYTES
    assert (width << (plan.shift + 1)) * 8 > stream_kernels.IMAGE_BYTES or plan.shift == 16
    assert plan.route == ("direct" if nslabs == 1 else "slabs")
    if nslabs == 1:
        assert plan.state_ints == plan.scratch_bytes == 0


def test_fold_plan_scratch_sizing():
    """An entry is 8 B a row (its slot in its slab with the payloads'
    validity bits, and its row) whatever the payloads; the counters 4
    ints a slab. A payload that is only counted has its values never
    read. The stream's chunk: 10M rows, 80 MB."""
    ops = [FoldOp("rows", -1, 0), FoldOp("count", 0, 1), FoldOp("sum_f", 0, 2),
           FoldOp("count", 1, 3), FoldOp("min_i", 2, 4), FoldOp("max_i", 2, 5)]
    plan = stream_kernels.fold_plan(20, 1_000_000, 10_000_000, ops, 3)
    assert plan.reads == (True, False, True)
    assert plan.state_ints == 4 * plan.nslabs + 2
    assert plan.scratch_bytes == 4 * plan.state_ints + 10_000_000 * 8
    assert 0.08e9 <= plan.scratch_bytes <= 0.081e9


def test_fold_plan_refusals():
    with pytest.raises(ValueError, match="accumulators a slot"):
        stream_kernels.fold_plan(49, 10, 1, [], 0)
    with pytest.raises(ValueError, match="slabs"):
        stream_kernels.fold_plan(48, (1 << 22) + 1, 1, [FoldOp("count", j, j) for j in range(48)],
                                 48)


def test_fold_plan_repeated_columns_share_an_accumulator():
    """The stream's 20 columns (two payloads' sum, count, min, max and avg,
    the rows, a count(*)) are 11 distinct accumulators: an average's sum
    beside a sum, and a payload's count beside each of its functions, fold
    once. Their slab is 1,024 slots (88 B a slot)."""
    schema = ft.Schema("store:int,item:long,qty:long,price:double")
    plans = [(f"{c}_{f}", f, c) for c in ("qty", "price") for f in ("sum", "count", "min",
                                                                     "max", "avg")]
    plans.append(("n", "count", "store"))
    agg = streaming.StreamingAggregator(ft.make_execution_engine(device="cpu"), schema,
                                        ["store", "item"], plans)
    plan = stream_kernels.fold_plan(len(agg._ops), 1_000_000, 10_000_000, agg._ops, 3)
    assert (len(agg._ops), plan.accumulators, plan.shift, plan.nslabs) == (20, 11, 10, 977)


_NEUTRAL = {"min_i": (1 << 63) - 1, "min_f": (1 << 63) - 1, "max_i": -(1 << 63),
            "max_f": -(1 << 63)}


def _merge(dst: torch.Tensor, image: torch.Tensor, ops: List[FoldOp]) -> None:
    """A piece's image merged into the store, accumulator by accumulator
    (the global atomics of ``image_finish``), skipping neutral values."""
    for op in ops:
        d, v = dst[:, op.acc], image[:, op.acc]
        moved = v != _NEUTRAL.get(op.kind, 0)
        if op.kind in ("sum_f", "sum_if"):
            d.view(torch.float64)[moved] += v.view(torch.float64)[moved]
        elif op.kind.startswith("min"):
            d[moved] = torch.minimum(d[moved], v[moved])
        elif op.kind.startswith("max"):
            d[moved] = torch.maximum(d[moved], v[moved])
        else:
            d[moved] += v[moved]


def _fold_image(image: torch.Tensor, off: torch.Tensor, payloads: List[Any],
                ops: List[FoldOp]) -> None:
    stream_fold_reference([off], [(0, int(image.shape[0]))], payloads, ops, image)


def fold_model(keys: List[torch.Tensor], bounds: List[Any], payloads: List[Any],
               ops: List[FoldOp], store: torch.Tensor, image_bytes: int, piece: int,
               tile: int, blocks: int, rng: np.random.Generator) -> torch.Tensor:
    """``stream.cu``'s steps in torch: the slab plan (``fold_plan`` at
    ``image_bytes``); on the direct route ``blocks`` blocks over ranges
    of the rows; else the slabs' rows, their buckets and pieces of at most
    ``piece`` entries, tiles of ``tile`` rows partitioned by slab and
    reserving their runs in a random order. Each block or piece folds into
    an image of its slots that starts from the neutral values, and the
    image goes into the store accumulator by accumulator (combined in
    place where one block owns the slots, by atomics where several do:
    the same values)."""
    slots, width = store.shape
    plan = stream_kernels.fold_plan(width, slots, len(keys[0]), ops, len(payloads), image_bytes)
    seg = fold_segments(keys, bounds)
    inside = (seg >= 0) & (seg < slots)
    slab_slots = 1 << plan.shift
    init = torch.tensor([_NEUTRAL.get(op.kind, 0) for op in ops])

    def neutral_image(rows: int) -> torch.Tensor:
        return init.unsqueeze(0).repeat(rows, 1)

    if plan.route == "direct":
        n = len(seg)
        per = -(-n // blocks)
        for b in range(blocks):
            rows = torch.arange(b * per, min(n, (b + 1) * per))
            rows = rows[inside[rows]]
            pl = [(v[rows], None if m is None else m[rows]) for v, m in payloads]
            image = neutral_image(slots)
            _fold_image(image, seg[rows], pl, ops)
            _merge(store, image, ops)
        return store
    slab = torch.where(inside, seg >> plan.shift, -1)
    counts = torch.bincount(slab[inside], minlength=plan.nslabs)
    start = torch.cumsum(counts, 0) - counts
    pieces = (counts + piece - 1) // piece
    pfirst = torch.cumsum(pieces, 0) - pieces
    n = len(seg)
    entries = torch.full((int(counts.sum()),), -1, dtype=torch.int64)  # the row of each entry
    fill = torch.zeros(plan.nslabs, dtype=torch.int64)
    for t in rng.permutation(-(-n // tile)):
        rows = torch.arange(t * tile, min(n, (t + 1) * tile))
        rows = rows[inside[rows]]
        for s in torch.unique(slab[rows]).tolist():  # a run a slab, in row order
            run = rows[slab[rows] == s]
            at = int(start[s] + fill[s])
            entries[at:at + len(run)] = run
            fill[s] += len(run)
    assert torch.equal(fill, counts) and bool((entries >= 0).all())
    for b in range(int(pieces.sum())):
        s = int(torch.searchsorted(pfirst, torch.tensor(b), right=True)) - 1
        e0 = int(start[s]) + (b - int(pfirst[s])) * piece
        e1 = min(e0 + piece, int(start[s] + counts[s]))
        rows = entries[e0:e1]
        pl = [(v[rows], None if m is None else m[rows]) for v, m in payloads]
        lo = s * slab_slots
        hi = min(slots, lo + slab_slots)
        image = neutral_image(hi - lo)
        _fold_image(image, seg[rows] - lo, pl, ops)
        _merge(store[lo:hi], image, ops)
    return store


def _fold_case(kind: str, n: int, rng: np.random.Generator) -> Any:
    slots = 3000 if kind != "within_one_slab" else 40
    if kind == "one_slot":
        seg = np.full(n, 7)
    elif kind == "zipf":
        seg = (rng.zipf(1.1, n) - 1) % slots
    elif kind == "outside_rows":
        seg = rng.integers(-50, slots + 50, n)
    else:
        seg = rng.integers(0, slots, n)
    keys = [torch.from_numpy(seg // 100), torch.from_numpy(seg % 100)]
    bounds = [(0, -(-slots // 100)), (0, 100)]
    if kind in ("within_one_slab", "outside_rows"):
        keys, bounds = [torch.from_numpy(seg)], [(0, slots)]
    ints = torch.from_numpy(rng.integers(-1000, 1000, n))
    floats = torch.from_numpy(rng.standard_normal(n))
    payloads = [(ints, torch.from_numpy(rng.random(n) > 0.1)),
                (floats, torch.from_numpy(rng.random(n) > 0.1)), (ints, None)]
    kinds = [("rows", -1), ("count", 0), ("sum_i", 0), ("sum_if", 0), ("min_i", 0),
             ("max_i", 0), ("count", 1), ("sum_f", 1), ("min_f", 1), ("max_f", 1), ("count", 2)]
    if kind == "width_1":
        kinds = [("sum_f", 1)]
    ops = [FoldOp(k, p, j) for j, (k, p) in enumerate(kinds)]
    store = torch.tensor([fold_init(op.kind) for op in ops]).unsqueeze(0).repeat(slots, 1)
    return keys, bounds, payloads, ops, store


@pytest.mark.parametrize("kind", ["uniform", "one_slot", "zipf", "within_one_slab",
                                  "outside_rows", "one_row", "width_1"])
@pytest.mark.parametrize("blocks", [1, 3])
def test_fold_model_matches_the_twin(kind, blocks):
    """The model of K19's steps, slabs of 64 or 128 slots (``image_bytes``
    5,120), pieces of 50 entries and tiles of 96 rows, folded twice into
    one store, against the twin: counts, integer sums and extrema exactly,
    float sums within rtol 1e-9 (the pieces add in another order)."""
    rng = np.random.default_rng(hash(kind) % 1000 + blocks)
    n = 1 if kind == "one_row" else 2000
    keys, bounds, payloads, ops, store = _fold_case(kind, n, rng)
    want = store.clone()
    for _ in range(2):
        stream_fold_reference(keys, bounds, payloads, ops, want)
        fold_model(keys, bounds, payloads, ops, store, 5120, 50, 96, blocks, rng)
    for op in ops:
        g, w = store[:, op.acc], want[:, op.acc]
        if op.kind in ("sum_f", "sum_if"):
            np.testing.assert_allclose(g.view(torch.float64).numpy(),
                                       w.view(torch.float64).numpy(), rtol=1e-9, atol=1e-12)
        else:
            assert torch.equal(g, w), op


@pytest.mark.parametrize("kind", ["one_slot", "zipf"])
def test_skewed_chunk_twin_matches_numpy(kind):
    """K19's twin on a skewed chunk (every row in one slot; a Zipf(1.1)
    slot) against numpy: the rows, valid counts, sums and extrema."""
    rng = np.random.default_rng(5)
    n = 5000
    keys, bounds, payloads, ops, store = _fold_case(kind, n, rng)
    stream_fold_reference(keys, bounds, payloads, ops, store)
    seg = fold_segments(keys, bounds).numpy()
    slots = store.shape[0]
    assert store[:, 0].tolist() == np.bincount(seg, minlength=slots).tolist()
    ints, im = (t.numpy() for t in payloads[0])
    floats, fm = (t.numpy() for t in payloads[1])
    assert store[:, 1].tolist() == np.bincount(seg[im], minlength=slots).tolist()
    sums = np.zeros(slots, dtype=np.int64)
    np.add.at(sums, seg[im], ints[im])
    assert store[:, 2].tolist() == sums.tolist()
    hi = np.full(slots, np.iinfo(np.int64).min)
    np.maximum.at(hi, seg[im], ints[im])
    assert store[:, 5].tolist() == hi.tolist()
    np.testing.assert_allclose(store[:, 7].view(torch.float64).numpy(),
                               np.bincount(seg[fm], floats[fm], slots), rtol=1e-9, atol=1e-12)
    fmax = np.full(slots, -np.inf)
    np.maximum.at(fmax, seg[fm], floats[fm])
    assert np.array_equal(streaming._from_order_key(store[:, 9], torch.float64).numpy(), fmax)
    assert store[:, 10].tolist() == np.bincount(seg, minlength=slots).tolist()


def test_chip_smoke_stream_fold_edges_on_cpu(monkeypatch: pytest.MonkeyPatch) -> None:
    """``chip_smoke.stream_fold_edges`` (every edge case, timed) at a small
    size, with K19's twin standing in for the kernel."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "STREAM_STORES", 50)
    monkeypatch.setattr(chip_smoke, "STREAM_ITEMS", (40, 60))
    monkeypatch.setattr(chip_smoke, "time_cuda", lambda fn, reps: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "device_split_ms", lambda fn, device: None)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    out = chip_smoke.stream_fold_edges(torch.device("cpu"), 3000, fold=stream_fold_reference)
    assert [c["case"] for c in out] == [
        "uniform", "one_slot", f"zipf_{chip_smoke.FOLD_ZIPF}", "within_one_slab",
        "three_slabs_and_17", "outside_rows", "one_row", "width_1", "width_48"]
    assert [c["accumulators"] for c in out][-2:] == [1, 48] and out[6]["rows"] == 1


BEYOND = (1 << 53) + 1  # float64 holds 2^53 and 2^53 + 2, not this


def _int64_chunk(kind: str, keys: List[Any], values: List[Any]) -> Any:
    """One chunk of ``k:long,v:long`` as an arrow table or a pandas frame
    of nullable ``Int64`` columns."""
    if kind == "arrow":
        return pa.table({"k": pa.array(keys, pa.int64()), "v": pa.array(values, pa.int64())})
    return pd.DataFrame({"k": pd.array(keys, dtype="Int64"),
                         "v": pd.array(values, dtype="Int64")})


_EXACT = [("s", "sum", "v"), ("lo", "min", "v"), ("hi", "max", "v"), ("c", "count", "v")]


@pytest.mark.parametrize("kind", ["arrow", "pandas_Int64"])
def test_nullable_int64_beyond_2_53_streams_exactly(kind: str) -> None:
    """A nullable int64 payload beyond 2^53 streams exactly: the chunk is
    read through arrow, never through float64 (held against Python ints;
    the JAX package loses the same bits, ``jax_backend/streaming.py:432-437``)."""
    te = ft.make_execution_engine(device="cpu")
    chunk = _int64_chunk(kind, [1, 1, 1], [BEYOND, None, 5])
    got = ft.aggregate(ft.LocalDataFrameIterableDataFrame(iter([chunk]), "k:long,v:long"),
                       ["k"], engine=te, as_fugue=True,
                       **{n: getattr(ff, f)(col(c)) for n, f, c in _EXACT}).as_arrow()
    assert te.stream_stats["chunks"] == 1 and "aggregate" not in te.fallbacks
    assert got.to_pylist() == [{"k": 1, "s": BEYOND + 5, "lo": 5, "hi": BEYOND, "c": 2}]


@pytest.mark.parametrize("kind", ["arrow", "pandas_Int64"])
def test_fallback_keeps_int64_beyond_2_53(kind: str) -> None:
    """A stream that falls back (a null key in a later chunk) materializes
    its consumed chunks through arrow too: the bounded aggregate sees the
    earlier chunk's int64 values beyond 2^53 exactly."""
    te = ft.make_execution_engine(device="cpu")
    chunks = [_int64_chunk(kind, [1, 1, 1], [BEYOND, None, 5]),
              _int64_chunk(kind, [None, 2], [7, BEYOND + 2])]
    got = ft.aggregate(ft.LocalDataFrameIterableDataFrame(iter(chunks), "k:long,v:long"),
                       ["k"], engine=te, as_fugue=True,
                       **{n: getattr(ff, f)(col(c)) for n, f, c in _EXACT}).as_arrow()
    assert te.fallbacks["aggregate"] == 1
    rows = {r["k"]: r for r in got.to_pylist()}
    assert rows[1] == {"k": 1, "s": BEYOND + 5, "lo": 5, "hi": BEYOND, "c": 2}
    assert rows[2] == {"k": 2, "s": BEYOND + 2, "lo": BEYOND + 2, "hi": BEYOND + 2, "c": 1}


def test_host_arrays_read_through_arrow() -> None:
    """``host_arrays`` of an arrow chunk and of the same pandas chunk: keys
    and int64 payloads exact, a float payload's bits, nulls and NaN
    invalid with slot 0; a NULL key is refused."""
    te = ft.make_execution_engine(device="cpu")
    schema = ft.Schema("k:int,v:long,x:double")
    agg = streaming.StreamingAggregator(te, schema, ["k"], [("s", "sum", "v"),
                                                             ("m", "max", "x")])
    table = pa.table({"k": pa.array([3, 4, 5], pa.int32()),
                      "v": pa.array([BEYOND, None, -2], pa.int64()),
                      "x": pa.array([1.5, float("nan"), None], pa.float64())})
    for chunk in (table, table.to_pandas(types_mapper={pa.int64(): pd.Int64Dtype()}.get)):
        values, valids = agg.host_arrays(chunk)
        assert values.dtype == np.int64 and values.shape == (3, 3)
        assert values[0].tolist() == [3, 4, 5] and values[1].tolist() == [BEYOND, 0, -2]
        assert values[2].view(np.float64).tolist() == [1.5, 0.0, 0.0]
        assert valids.tolist() == [[True, False, True], [True, False, False]]
    with pytest.raises(streaming.StreamUnsupported, match="NULL group keys"):
        agg.host_arrays(pa.table({"k": pa.array([None], pa.int32()), "v": pa.array([1]),
                                  "x": pa.array([1.0])}))
