"""Key factorization (``fugue_tpu_torch/torch_backend/groupby.py``'s
``factorize_keys`` and the twins of its kernels in
``fugue_tpu_torch/kernels/reference.py``) and the sort-path aggregate,
against the JAX package on one CPU device: ``factorize_keys`` (binned and
sort paths), ``_bin_core``, ``_sort_factorize_core`` + ``_finish`` and
``JaxExecutionEngine.aggregate``. Frames are built with ``from_arrow`` on
both sides from the same seeded numpy data; prefix frames with
``nrows`` < padded rows and masked frames get the same layout on both
sides.

Tolerances: segment ids, segment counts, first rows, occupancy, group
counts, sort orders, keys, counts and integer sums exactly (group order
included); float sums and means at rtol 1e-5, since the two add float32
values in different orders (the values are positive, so no sum
cancels)."""

from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import chip_smoke
import fugue_tpu_torch as ft
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.execution import make_execution_engine as make_jax_engine
from fugue_tpu.execution.api import aggregate as jaggregate
from fugue_tpu.jax_backend import blocks as jblocks
from fugue_tpu.jax_backend import groupby as jgroupby
from fugue_tpu.schema import Schema as JSchema
from fugue_tpu_torch.kernels import build
from fugue_tpu_torch.kernels.factorize import (
    bin_factorize_cuda,
    sort_boundaries_cuda,
    sort_finish_cuda,
)
from fugue_tpu_torch.kernels.reference import (
    BinKey,
    bin_factorize_reference,
    sort_factorize_reference,
)
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend import blocks as tblocks
from fugue_tpu_torch.torch_backend import groupby

CPU = torch.device("cpu")
N = 2000
_FLOATS = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, 3.0e38, -np.inf, 7.0])


def _floats(rng: np.random.Generator, n: int, dtype: Any) -> np.ndarray:
    return _FLOATS[rng.integers(0, len(_FLOATS), n)].astype(dtype)


def _table(case: str) -> pa.Table:
    rng = np.random.default_rng(23)
    n = 1 if case == "one_row" else N
    nulls = rng.random(n) < 0.2
    if case == "int32_key":
        return pa.table({"k": pa.array(rng.integers(-20, 45, n).astype(np.int32))})
    if case == "two_int_keys":
        return pa.table({
            "a": pa.array(rng.integers(0, 9, n).astype(np.int32)),
            "b": pa.array(rng.integers(-5, 8, n).astype(np.int64), mask=nulls),
        })
    if case in ("float32_key", "float64_key", "one_row"):
        dtype = np.float64 if case == "float64_key" else np.float32
        return pa.table({"k": pa.array(_floats(rng, n, dtype), mask=nulls)})
    if case == "wide_int64_key":
        pool = rng.integers(-(2**40), 2**40, 300)
        return pa.table({"k": pa.array(pool[rng.integers(0, 300, n)].astype(np.int64))})
    if case == "bool_key":
        return pa.table({"k": pa.array(rng.random(n) < 0.5, mask=nulls)})
    if case == "float_and_int_keys":
        return pa.table({
            "f": pa.array(_floats(rng, n, np.float32)),
            "i": pa.array(rng.integers(-3, 4, n).astype(np.int32), mask=nulls),
        })
    if case == "one_group":
        return pa.table({"k": pa.array(np.full(n, 2.5, dtype=np.float32))})
    if case == "five_int_keys":  # more keys than the kernels read
        return pa.table({f"k{j}": pa.array(rng.integers(-1, 3, n).astype(np.int32),
                                           mask=nulls if j == 2 else None) for j in range(5)})
    assert case == "all_distinct"
    return pa.table({"k": pa.array(rng.permutation(n).astype(np.int64) * 2**33)})


_SHORT = N // 2 + 7  # a prefix frame's real rows, below its padded rows


def _frames(table: pa.Table, layout: str) -> Tuple[tblocks.TorchBlocks, Any]:
    """The same rows as the port's and the JAX package's blocks, in one
    layout: ``prefix`` (every row real), ``prefix_short`` (only the first
    ``_SHORT`` rows real, the rest holding real-looking values) or
    ``masked`` (a ``row_valid`` mask)."""
    port = tblocks.from_arrow(table, Schema(table.schema), CPU)
    ref = jblocks.from_arrow(table, JSchema(table.schema), jblocks.make_mesh([jax_device()]))
    if layout == "prefix_short":
        port._nrows = ref._nrows = _SHORT
    elif layout == "masked":
        valid = np.random.default_rng(5).random(table.num_rows) < 0.6
        port.row_valid, port._nrows = torch.from_numpy(valid), None
        ref.row_valid, ref._nrows = jnp.asarray(valid), None
    return port, ref


def jax_device() -> Any:
    import jax

    return jax.devices()[0]


_CASES = ["int32_key", "two_int_keys", "five_int_keys", "float32_key", "float64_key",
          "wide_int64_key", "bool_key", "float_and_int_keys", "one_row", "one_group",
          "all_distinct"]
_LAYOUTS = [(c, "prefix") for c in _CASES] + [
    (c, layout) for c in ("int32_key", "five_int_keys", "float32_key", "float_and_int_keys",
                          "wide_int64_key")
    for layout in ("prefix_short", "masked")
]
# the cases on the binned path, in both packages
_BINNED = ("int32_key", "two_int_keys", "five_int_keys", "bool_key")


@pytest.mark.parametrize("case,layout", _LAYOUTS)
def test_factorize_keys_matches_jax(case, layout):
    table = _table(case)
    keys = table.column_names
    port, ref = _frames(table, layout)
    fr = groupby.factorize_keys(port, keys)
    jfr = jgroupby.factorize_keys(ref, keys)
    assert fr.num_segments == jfr.num_segments
    assert (fr.occupied is None) == (jfr.occupied is None) == (case not in _BINNED)
    assert fr.seg.dtype == fr.first_idx.dtype == torch.int32
    np.testing.assert_array_equal(fr.seg.numpy(), np.asarray(jfr.seg))
    occupied = np.ones(fr.num_segments, dtype=bool)
    if fr.occupied is not None:
        occupied = fr.occupied.numpy()
        np.testing.assert_array_equal(occupied, np.asarray(jfr.occupied))
        # an empty bin's first row is the last padded row
        assert (fr.first_idx.numpy()[~occupied] == port.padded_nrows - 1).all()
    np.testing.assert_array_equal(
        fr.first_idx.numpy()[occupied], np.asarray(jfr.first_idx)[occupied]
    )
    assert int(fr.num_groups_dev) == int(jfr.num_groups_dev)
    if case == "one_group":
        assert fr.num_segments == 1
    if case == "all_distinct":
        assert fr.num_segments == port.nrows


def test_factorization_is_cached_per_frame(monkeypatch):
    calls: List[Any] = []
    real = groupby.sort_factorize

    def counted(*args: Any, **kwargs: Any) -> Any:
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(groupby, "sort_factorize", counted)
    port, _ = _frames(_table("float32_key"), "prefix")
    first = groupby.factorize_keys(port, ["k"])
    assert groupby.factorize_keys(port, ["k"]) is first
    assert len(calls) == 1


def _bin_case(case: str) -> Tuple[List[np.ndarray], List[Optional[np.ndarray]], Any, Any]:
    """``(keys, masks, spec, rows)`` of a ``_bin_core`` case: numpy key
    columns and masks, its ``(names, mins, spans, masked, total)`` and the
    layout (``("prefix", nrows)`` or ``("masked", row_valid)``)."""
    rng = np.random.default_rng(31)
    if case == "four_keys_one_nullable":
        keys = [rng.integers(0, 3, N).astype(np.int8), rng.integers(-2, 3, N).astype(np.int16),
                rng.integers(10, 17, N).astype(np.int32),
                rng.integers(2**35, 2**35 + 11, N).astype(np.int64)]
        masks = [None, rng.random(N) < 0.9, None, None]
        spec = (("a", "b", "c", "d"), (0, -2, 10, 2**35), (3, 6, 7, 11),
                (False, True, False, False), 3 * 6 * 7 * 11)
    else:
        keys, masks = [rng.integers(-7, 1017, N).astype(np.int32)], [None]
        spec = (("k",), (-7,), (1024,), (False,), 1024)
    if case == "masked_frame":
        return keys, masks, spec, ("masked", rng.random(N) < 0.6)
    return keys, masks, spec, ("prefix", _SHORT if case == "prefix_short" else N)


@pytest.mark.parametrize("case", ["one_key", "four_keys_one_nullable", "prefix_short",
                                  "masked_frame"])
def test_bin_factorize_reference_matches_bin_core(case):
    keys, masks, spec, (layout, rows) = _bin_case(case)
    t = torch.from_numpy
    bkeys = [BinKey(t(k), None if m is None else t(m), kmin, span)
             for k, m, kmin, span in zip(keys, masks, spec[1], spec[2])]
    kwargs = {"nrows": rows} if layout == "prefix" else {"row_valid": t(rows)}
    seg, first_idx, occupied, count = bin_factorize_reference(bkeys, **kwargs)
    jseg, jfirst, jocc, jcount = jgroupby._bin_core(
        tuple(jnp.asarray(k) for k in keys),
        tuple(None if m is None else jnp.asarray(m) for m in masks),
        None if layout == "prefix" else jnp.asarray(rows),
        np.int32(rows if layout == "prefix" else -1),
        jgroupby.BinSpec(*spec),
    )
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(occupied.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(first_idx.numpy(), np.asarray(jfirst))
    assert int(count) == int(jcount)


def _sort_case(case: str) -> Tuple[List[np.ndarray], Any]:
    """Canonical sort codes (no NaN, no -0.0) as numpy columns, and the
    layout."""
    rng = np.random.default_rng(37)
    if case == "two_words":  # an int64 key's low and high words
        words = (rng.integers(-(2**40), 2**40, 50)[rng.integers(0, 50, N)]
                 .astype(np.int64).view(np.int32).reshape(-1, 2))
        codes = [words[:, 0].copy(), words[:, 1].copy()]
    elif case == "flag_and_float64":
        codes = [(rng.random(N) < 0.1).astype(np.int32),
                 rng.choice([-1.5, 0.0, 2.0, 1e300], N).astype(np.float64)]
    else:
        codes = [rng.integers(0, 5, N).astype(np.int32),
                 rng.choice([-1.5, 0.0, 2.0, 7.25], N).astype(np.float32)]
    if case == "masked_frame":
        return codes, ("masked", rng.random(N) < 0.6)
    return codes, ("prefix", _SHORT if case == "prefix_short" else N)


@pytest.mark.parametrize("case", ["int_and_float32", "two_words", "flag_and_float64",
                                  "prefix_short", "masked_frame"])
def test_sort_factorize_reference_matches_jax_core(case):
    codes, (layout, rows) = _sort_case(case)
    t = torch.from_numpy
    kwargs = {"nrows": rows} if layout == "prefix" else {"row_valid": t(rows)}
    tcodes = [t(c) for c in codes]
    order = groupby.lex_sort(tcodes, **kwargs)[0]
    seg, first_idx, num = sort_factorize_reference(tcodes, order, **kwargs)
    jseg_sorted, jorder, jvalid, jnum = jgroupby._sort_factorize_core(
        tuple(jnp.asarray(c) for c in codes),
        None if layout == "prefix" else jnp.asarray(rows),
        np.int32(rows if layout == "prefix" else -1),
    )
    jnum = int(jnum)
    jseg, jfirst = jgroupby._sort_factorize_finish(jseg_sorted, jorder, jvalid, jnum)
    assert order.dtype == torch.int64
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    assert num == jnum
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(first_idx.numpy(), np.asarray(jfirst))


def test_sort_codes_match_jax():
    """The codes of a nullable float key and an int64 key: a NaN flag and
    the canonical float, behind a null flag; the int64 key's two words,
    low word first."""
    rng = np.random.default_rng(41)
    f = _floats(rng, N, np.float32)
    valid = rng.random(N) < 0.8
    w = rng.integers(-(2**40), 2**40, N).astype(np.int64)
    codes = groupby.sort_codes([(torch.from_numpy(np.where(valid, f, 0)), torch.from_numpy(valid)),
                                (torch.from_numpy(w), None)])
    assert [c.dtype for c in codes] == [torch.int32, torch.int32, torch.float32,
                                        torch.int32, torch.int32]
    fz = np.where(valid & ~np.isnan(f), f, 0).astype(np.float32) + np.float32(0.0)
    want = [(~valid).astype(np.int32), (np.isnan(f) & valid).astype(np.int32), fz,
            (w & 0xFFFFFFFF).astype(np.uint32).view(np.int32), (w >> 32).astype(np.int32)]
    for got, exp in zip(codes, want):
        np.testing.assert_array_equal(got.contiguous().numpy().view(np.uint8), exp.view(np.uint8))


def _agg_table(case: str) -> pa.Table:
    rng = np.random.default_rng(43)
    cols = {k: v for k, v in zip(_table(case).column_names, _table(case).columns)}
    v = (rng.random(N) + 0.5).astype(np.float32)
    cols["v"] = pa.array(v, mask=rng.random(N) < 0.1)
    cols["i"] = pa.array(rng.integers(-(2**40), 2**40, N).astype(np.int64))
    return pa.table(cols)


def _torch_shrink(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"k": a["k"], "v": a["v"], "_nrows": torch.tensor(_SHORT)}


def _jax_shrink(a: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    return {"k": a["k"], "v": a["v"], "_nrows": jnp.int32(_SHORT)}


def _layout_inputs(case: str, te: Any, je: Any) -> Tuple[Any, Any, List[str], Dict[str, Any]]:
    """The port's and the JAX engine's input frames of a layout case, its
    keys and its aggregations as ``{name: (function, column)}``: a prefix
    frame whose padding past ``_nrows`` holds real-looking rows, or the
    masked frame a binned aggregate returns, grouped again by one of its
    float sums."""
    import fugue_tpu

    rng = np.random.default_rng(47)
    k = np.array([-0.0, 0.0, 1.5, -2.25, 7.0])[rng.integers(0, 5, N)].astype(np.float32)
    pdf = pd.DataFrame({"k": k, "v": (rng.random(N) + 0.5).astype(np.float32)})
    if case == "prefix_frame_pad_gt_nrows":
        tin = ft.transform(pdf, _torch_shrink, "k:float,v:float", engine=te, as_fugue=True)
        jin = fugue_tpu.transform(pdf, _jax_shrink, schema="k:float,v:float", engine=je,
                                  as_fugue=True)
        return tin, jin, ["k"], {"s": ("sum", "v"), "m": ("avg", "v"), "c": ("count", "v")}
    assert case == "masked_frame"
    # every other bin of g empty; w's float32 sums are small integers, so
    # they come out the same in any order and can be keys
    pdf = pdf.assign(g=rng.integers(0, 40, N).astype(np.int32) * 2,
                     w=rng.integers(0, 3, N).astype(np.float32))
    tin = ft.aggregate(pdf, partition_by="g", engine=te, as_fugue=True,
                       s1=ft.functions.sum(ft.col("w")), c1=ft.functions.count(ft.col("v")))
    jin = jaggregate(pdf, partition_by="g", engine=je, as_fugue=True,
                     s1=jff.sum(jcol("w")), c1=jff.count(jcol("v")))
    assert tin.blocks.row_valid is not None
    return tin, jin, ["s1"], {"t": ("sum", "c1"), "c": ("count", "g")}


@pytest.mark.parametrize("case", ["float32_key", "float64_key", "wide_int64_key",
                                  "float_and_int_keys", "prefix_frame_pad_gt_nrows",
                                  "masked_frame"])
def test_sort_path_aggregate_matches_jax(case):
    """The generic branch against the JAX engine's, row for row in the
    JAX package's group order (the order of the key codes)."""
    te = ft.make_execution_engine(device="cpu")
    je = make_jax_engine("jax", {"fugue.jax.devices": "0"})
    if case in ("prefix_frame_pad_gt_nrows", "masked_frame"):
        tin, jin, keys, aggs = _layout_inputs(case, te, je)
    else:
        tin = jin = _agg_table(case)
        keys = [c for c in tin.column_names if c not in ("v", "i")]
        aggs = {"s": ("sum", "v"), "m": ("avg", "v"), "c": ("count", "v"),
                "t": ("sum", "i"), "a": ("avg", "i"), "n": ("count", "*")}
    before = te.strategy_counts.get("reference", 0)
    tagg = ft.aggregate(tin, partition_by=keys, engine=te, as_fugue=True,
                        **{n: getattr(ft.functions, f)(ft.col(a)) for n, (f, a) in aggs.items()})
    assert te.strategy_counts["generic"] == 1
    assert te.strategy_counts["reference"] == before + 1
    assert te.fallbacks == {}
    jagg = jaggregate(jin, partition_by=keys, engine=je, as_fugue=True,
                      **{n: getattr(jff, f)(jcol(a)) for n, (f, a) in aggs.items()})
    assert str(tagg.schema) == str(jagg.schema)
    # held column by column on the device, values and null masks: the JAX
    # package's as_arrow turns a NaN key into a null (ROADMAP.md queue 3)
    num = tagg.blocks.nrows
    assert tagg.blocks.row_valid is None and num == jagg.native.nrows
    for name in tagg.schema.names:
        g, w = tagg.blocks.columns[name], jagg.native.columns[name]
        gv, wv = g.data.numpy()[:num], np.asarray(w.data)[:num]
        gm = np.ones(num, bool) if g.mask is None else g.mask.numpy()[:num]
        wm = np.ones(num, bool) if w.mask is None else np.asarray(w.mask)[:num]
        np.testing.assert_array_equal(gm, wm)
        if name in ("s", "m", "a"):
            np.testing.assert_allclose(gv[gm], wv[wm], rtol=1e-5, atol=0)
        else:  # keys (NaN included), counts and int sums exactly
            np.testing.assert_array_equal(gv[gm], wv[wm])


def test_chip_smoke_sort_path_aggregates_on_cpu():
    """The sort-path phase of ``chip_smoke.py`` at a small size on the
    CPU (the card runs it at 100M rows); it checks itself against numpy."""
    stats = chip_smoke.sort_path_aggregates(CPU, 20_000, 64, 42, 1)
    assert [s["case"] for s in stats] == ["float_key", "int64_key"]
    for s in stats:
        assert s["groups"] == 64 and max(s["max_rel_err"].values()) < 1e-5
        assert s["launches"] == dict.fromkeys(s["launches"], 0)  # the CPU runs the twins


def test_kernel_wrappers_refuse_cpu_tensors():
    key = torch.zeros(4, dtype=torch.int32)
    order = torch.arange(4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        bin_factorize_cuda([BinKey(key, None, 0, 1)], nrows=4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sort_boundaries_cuda([key], order, nrows=4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sort_finish_cuda(key, order, 1)


def test_both_sources_build_at_once_and_are_keyed_by_their_header(tmp_path, monkeypatch):
    """``build_all`` starts one ``nvcc`` per source before it waits for
    any, keys each library by its source and the shared headers, and
    builds nothing that is built already. ``nvcc`` is a stand-in script
    here (the CPU has no CUDA toolkit)."""
    kdir = tmp_path / "kernels"
    kdir.mkdir()
    for name in ("a.cu", "b.cu", "shared.cuh"):
        (kdir / name).write_text(f"// {name}\n")
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    log = tmp_path / "log"
    # waits until both builds have started, so it only finishes if they
    # run at once
    fake.write_text(
        "#!/bin/sh\n"
        f"echo start >> {log}\n"
        f"for i in $(seq 100); do [ $(wc -l < {log}) -ge 2 ] && break; sleep 0.05; done\n"
        'while [ $# -gt 1 ]; do [ "$1" = -o ] && out=$2; shift; done\n'
        'echo built > "$out"\n'
    )
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "KERNEL_DIR", kdir)
    monkeypatch.setattr(build, "BUILD_DIR", kdir / "_build")
    assert build.sources() == ["a", "b"]
    assert sorted(build.build_all()) == ["a", "b"]
    assert log.read_text().count("start") == 2
    assert build.build_all() == {}  # cached by hash
    before = build.library_path("a")
    (kdir / "shared.cuh").write_text("// edited\n")
    assert build.library_path("a") != before
    assert sorted(build.build_all()) == ["a", "b"]
