"""``transform(partition={"by": [...]})`` on the port against the JAX
engine pinned to one CPU device: the config-2 transformer of
``bench.py:798-811`` (each value less its group's mean) in JAX and its
torch twin (``chip_smoke.udfs()["demean"]``), a transformer that returns
one row per segment with ``_nrows``, and the segment ids a transformer
sees. Inputs come from a seeded numpy generator.

Tolerances: keys, values passed through, counts, segment ids and segment
counts exactly; the demeaned ``z`` and per-segment float32 sums at rtol
1e-5 with an absolute floor of 1e-6 (``z`` crosses zero, and the two sum
the group's float32 values in different orders: one float32 ulp of a
mean near 0.5 is 6e-8)."""

from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
import fugue_tpu
import fugue_tpu_torch as ft
from fugue_tpu.execution import make_execution_engine as make_jax_engine
from fugue_tpu_torch.torch_backend import groupby

N = 3000


def _frame(case: str) -> pd.DataFrame:
    rng = np.random.default_rng(13)
    v = rng.random(N).astype(np.float32)
    if case == "int32_key":
        return pd.DataFrame({"k": rng.integers(0, 40, N).astype(np.int32), "v": v})
    if case == "float32_key":
        k = np.array([1.5, -0.0, 0.0, 2.25, -7.0])[rng.integers(0, 5, N)].astype(np.float32)
        return pd.DataFrame({"k": k, "v": v})
    if case == "wide_int64_key":
        return pd.DataFrame({"k": rng.integers(-20, 20, N).astype(np.int64) * 2**33, "v": v})
    assert case == "nullable_int64_key"
    k = pd.array(rng.integers(0, 30, N), dtype="Int64")
    k[rng.random(N) < 0.15] = pd.NA
    return pd.DataFrame({"k": k, "v": v})


def _jax_demean(arrs: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    """``bench.py:798-811``."""
    seg, num, valid = arrs["_segment_ids"], arrs["_num_segments"], arrs["_row_valid"]
    v = jnp.where(valid, arrs["v"], 0.0)
    cnt = jax.ops.segment_sum(jnp.where(valid, 1.0, 0.0), seg, num_segments=num)
    mean = jax.ops.segment_sum(v, seg, num_segments=num) / jnp.maximum(cnt, 1.0)
    return {"k": arrs["k"], "v": arrs["v"], "z": arrs["v"] - mean[jnp.clip(seg, 0, num - 1)]}


_SCHEMA = {"int32_key": "k:int", "float32_key": "k:float", "wide_int64_key": "k:long",
           "nullable_int64_key": "k:long"}


@pytest.mark.parametrize("case", sorted(_SCHEMA))
def test_partitioned_demean_matches_jax(case):
    pdf = _frame(case)
    schema = f"{_SCHEMA[case]},v:float,z:float"
    te = ft.make_execution_engine(device="cpu")
    got = ft.transform(pdf, chip_smoke.udfs()["demean"], schema, engine=te,
                       partition={"by": ["k"]})
    assert te.fallbacks == {}
    je = make_jax_engine("jax", {"fugue.jax.devices": "0"})
    want = fugue_tpu.transform(pdf, _jax_demean, schema=schema, partition={"by": ["k"]},
                               engine=je, as_fugue=True).as_pandas()
    assert list(got.columns) == list(want.columns) == ["k", "v", "z"]
    pd.testing.assert_series_equal(got["k"], want["k"], check_dtype=False)
    np.testing.assert_array_equal(got["v"].to_numpy(), pdf["v"].to_numpy())
    np.testing.assert_allclose(got["z"].to_numpy(), want["z"].to_numpy(), rtol=1e-5, atol=1e-6)


def _jax_per_segment(arrs: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    seg, num, valid = arrs["_segment_ids"], arrs["_num_segments"], arrs["_row_valid"]
    return {
        "k": jnp.zeros((num,), jnp.int32).at[seg].set(arrs["k"], mode="drop"),
        "s": jax.ops.segment_sum(jnp.where(valid, arrs["v"], 0.0), seg, num_segments=num),
        "c": jax.ops.segment_sum(valid.astype(jnp.int32), seg, num_segments=num),
        "_nrows": jnp.int32(num),
    }


def _torch_per_segment(arrs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One row per segment: ``_num_segments + 1`` buckets, the last (the
    sentinel's) cut off."""
    seg, num, valid = arrs["_segment_ids"], arrs["_num_segments"], arrs["_row_valid"]
    idx = seg.long()
    k = torch.zeros(num + 1, dtype=torch.int32).index_put_((idx,), arrs["k"])
    s = torch.zeros(num + 1).index_add_(0, idx, torch.where(valid, arrs["v"], 0.0))
    c = torch.zeros(num + 1, dtype=torch.int32).index_add_(0, idx, valid.to(torch.int32))
    return {"k": k[:num], "s": s[:num], "c": c[:num], "_nrows": torch.tensor(num)}


@pytest.mark.parametrize("case", ["bin_path", "sort_path"])
def test_one_row_per_segment_with_nrows_matches_jax(case):
    """A transformer that changes the row count through ``_nrows``
    (``tests/fugue_tpu/jax_backend/test_transformer_abi.py``'s contract):
    every segment, empty bins included, in segment order."""
    pdf = _frame("int32_key")
    if case == "sort_path":  # a float key has no bin spec
        pdf = pdf.assign(f=pdf["k"].astype(np.float32) / 4)
    keys = ["k"] if case == "bin_path" else ["f"]
    got = ft.transform(pdf, _torch_per_segment, "k:int,s:float,c:int",
                       engine=ft.make_execution_engine(device="cpu"), partition={"by": keys})
    want = fugue_tpu.transform(
        pdf, _jax_per_segment, schema="k:int,s:float,c:int", partition={"by": keys},
        engine=make_jax_engine("jax", {"fugue.jax.devices": "0"}), as_fugue=True,
    ).as_pandas()
    assert len(got) == len(want) == (40 if case == "bin_path" else pdf["k"].nunique())
    np.testing.assert_array_equal(got["k"].to_numpy(), want["k"].to_numpy())
    np.testing.assert_array_equal(got["c"].to_numpy(), want["c"].to_numpy())
    np.testing.assert_allclose(got["s"].to_numpy(), want["s"].to_numpy(), rtol=1e-5, atol=1e-6)


def _seen(arrs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"k": arrs["k"], "seg": arrs["_segment_ids"],
            "num": torch.full_like(arrs["_segment_ids"], arrs["_num_segments"])}


@pytest.mark.parametrize("layout", ["prefix_pad_gt_nrows", "masked"])
def test_rows_that_are_not_real_carry_the_sentinel(layout):
    """``_segment_ids`` is ``_num_segments`` on every row that is not
    real: a prefix frame's padding past ``_nrows``, a masked frame's
    dropped rows."""
    engine = ft.make_execution_engine(device="cpu")
    pdf = _frame("float32_key")
    if layout == "prefix_pad_gt_nrows":
        def shrink(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            return {"k": a["k"], "v": a["v"], "_nrows": torch.tensor(N // 2)}

        src = ft.transform(pdf, shrink, "k:float,v:float", engine=engine, as_fugue=True)
        real = np.arange(N) < N // 2
    else:  # the binned aggregate's result: its empty bins are not real
        src = ft.aggregate(pdf.assign(g=np.arange(N, dtype=np.int32) % 50 * 2), "g",
                           engine=engine, as_fugue=True, k=ft.functions.sum(ft.col("v")))
        real = src.blocks.row_valid.numpy()
        assert 0 < real.sum() < real.shape[0]
    out = ft.transform(src, _seen, "k:float,seg:int,num:int", engine=engine, as_fugue=True,
                       partition={"by": ["k"]})
    seg = out.blocks.columns["seg"].data.numpy()
    num = int(out.blocks.columns["num"].data[0])
    assert num == len(np.unique(src.as_pandas()["k"]))
    np.testing.assert_array_equal(seg == num, ~real)
    assert (seg[real] < num).all()


def test_transform_then_aggregate_factorizes_once(monkeypatch):
    """A transform and an aggregate by the same keys of one frame share its
    factorization."""
    calls = []
    real = groupby.sort_factorize

    def counted(*args: Any, **kwargs: Any) -> Any:
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(groupby, "sort_factorize", counted)
    engine = ft.make_execution_engine(device="cpu")
    src = engine.to_df(_frame("float32_key"))
    out = ft.transform(src, chip_smoke.udfs()["demean"], "k:float,v:float,z:float",
                       engine=engine, partition={"by": ["k"]}, as_fugue=True)
    agg = ft.aggregate(src, "k", engine=engine, as_fugue=True, s=ft.functions.sum(ft.col("v")))
    assert len(calls) == 1
    assert out.count() == N and agg.count() == 4  # -0.0 and 0.0 are one group
    assert engine.strategy_counts == {"reference": 1, "generic": 1}


def test_chip_smoke_partitioned_transform_on_cpu():
    """The config-2 phase of ``chip_smoke.py`` at a small size on the CPU
    (the card runs it at 10M and 100M rows); it checks itself against
    numpy."""
    stats = chip_smoke.partitioned_transform(torch.device("cpu"), 20_000, 1)
    assert stats["rows"] == 20_000 and stats["max_abs_err_z"] < 1e-5
    assert stats["launches"] == dict.fromkeys(stats["launches"], 0)  # the CPU runs the twins
