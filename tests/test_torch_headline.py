"""The port's main path (``fugue_tpu_torch.transform`` + ``aggregate``)
against the JAX engine's (``fugue_tpu.transform`` + ``fugue_tpu.execution.
api.aggregate``) at a small size: 20k rows, 64 groups, inputs from a
seeded numpy generator. The JAX engine is pinned to one device.

Tolerances: result schemas, keys, counts and integer sums exactly; float
sums and means at rtol 1e-5 (float32 payloads summed in another order)."""

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import chip_smoke
import fugue_tpu
import fugue_tpu_torch as ft
from fugue_tpu.column import col as jcol
from fugue_tpu.column import functions as jff
from fugue_tpu.execution import make_execution_engine as make_jax_engine
from fugue_tpu.execution.api import aggregate as jaggregate

N, GROUPS = 20_000, 64


def _frame(case: str, n: int = N) -> pd.DataFrame:
    rng = np.random.default_rng(42)
    k = rng.integers(0, GROUPS, n).astype(np.int32)
    v = rng.random(n).astype(np.float32)
    if case == "headline":
        return pd.DataFrame({"k": k, "v": v})
    if case == "nullable_key":
        kn = pd.array(k, dtype="Int32")
        kn[rng.random(n) < 0.1] = pd.NA
        vn = pd.array(v, dtype="Float32")
        vn[rng.random(n) < 0.1] = pd.NA
        return pd.DataFrame({"k": kn, "v": vn})
    if case == "two_keys":
        return pd.DataFrame({
            "k": (k % 8).astype(np.int32),
            "k2": rng.integers(-5, 5, n).astype(np.int64),
            "v": v,
        })
    if case == "int_sum":
        return pd.DataFrame({"k": k, "v": rng.integers(-(2**40), 2**40, n).astype(np.int64)})
    assert case == "empty"
    return pd.DataFrame({"k": k[:0], "v": v[:0]})


_KEYS = {"two_keys": ["k", "k2"]}
_OUT_SCHEMA = {
    "two_keys": "k:int,k2:long,v2:float",
    "int_sum": "k:int,v2:long",
}


def _jax_udf(a: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    out = {name: a[name] for name in ("k", "k2") if name in a}
    if jnp.issubdtype(a["v"].dtype, jnp.integer):
        out["v2"] = a["v"]
    else:
        out["v2"] = a["v"] * jnp.float32(2.0) + 1.0
    if "_v_mask" in a:
        out["_v2_mask"] = a["_v_mask"]
    return out


def _torch_udf(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {name: a[name] for name in ("k", "k2") if name in a}
    if a["v"].is_floating_point():
        out["v2"] = a["v"] * 2.0 + 1.0
    else:
        out["v2"] = a["v"]
    if "_v_mask" in a:
        out["_v2_mask"] = a["_v_mask"]
    return out


def _sorted(table: pa.Table, keys) -> pa.Table:
    return table.sort_by([(k, "ascending", "at_end") for k in keys])


@pytest.mark.parametrize(
    "case", ["headline", "nullable_key", "two_keys", "int_sum", "empty"]
)
def test_main_path_matches_jax(case):
    pdf = _frame(case)
    keys = _KEYS.get(case, ["k"])
    schema = _OUT_SCHEMA.get(case, "k:int,v2:float")

    je = make_jax_engine("jax", {"fugue.jax.devices": "0"})
    jout = fugue_tpu.transform(pdf, _jax_udf, schema=schema, engine=je, as_fugue=True)
    jagg = jaggregate(
        jout, partition_by=keys, engine=je, as_fugue=True,
        s=jff.sum(jcol("v2")), m=jff.avg(jcol("v2")), c=jff.count(jcol("v2")),
    )

    te = ft.make_execution_engine("torch", device="cpu")
    tout = ft.transform(pdf, _torch_udf, schema=schema, engine=te, as_fugue=True)
    for k in keys:  # passthrough keys keep their ingest stats
        assert tout.blocks.columns[k].stats is not None
    tagg = ft.aggregate(
        tout, partition_by=keys, engine=te, as_fugue=True,
        s=ft.functions.sum(ft.col("v2")),
        m=ft.functions.avg(ft.col("v2")),
        c=ft.functions.count(ft.col("v2")),
    )
    assert not tagg.blocks.nrows_known  # the group count stays on the device
    assert te.strategy_counts == {"reference": 1}
    assert te.fallbacks == {}

    assert str(tagg.schema) == str(jagg.schema)
    if case in ("headline", "nullable_key", "empty"):
        assert str(tagg.schema) == "k:int,s:float,m:double,c:long"
    got, want = _sorted(tagg.as_arrow(), keys), _sorted(jagg.as_arrow(), keys)
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows == tagg.count()
    for name in got.column_names:
        g, w = got.column(name), want.column(name)
        if pa.types.is_floating(g.type):
            assert g.null_count == w.null_count == 0
            np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=1e-5, atol=0)
        else:
            assert g.to_pylist() == w.to_pylist()  # exact, nulls included
    if case == "empty":
        assert got.num_rows == 0


def test_transform_returns_pandas_for_pandas_input():
    pdf = _frame("headline", 100)
    out = ft.transform(
        pdf, _torch_udf, schema="k:int,v2:float",
        engine=ft.make_execution_engine(device="cpu"),
    )
    assert isinstance(out, pd.DataFrame)
    np.testing.assert_allclose(out["v2"].to_numpy(), pdf["v"].to_numpy() * 2 + 1, rtol=1e-6)


def test_transform_can_change_the_row_count():
    pdf = pd.DataFrame({"k": np.arange(10, dtype=np.int32)})

    def head(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": a["k"][:4] * 10, "_nrows": torch.tensor(4)}

    out = ft.transform(pdf, head, schema="k:int", engine=ft.make_execution_engine(device="cpu"))
    assert out["k"].tolist() == [0, 10, 20, 30]


def test_chip_smoke_main_path_on_cpu():
    """The main-path phase of ``chip_smoke.py`` at a small size on the CPU
    (the card runs it at 100M rows); it checks itself against numpy."""
    stats = chip_smoke.main_path(torch.device("cpu"), N, GROUPS, 42, 1)
    assert stats["rows"] == N and stats["max_rel_err_s"] < 1e-5
    assert stats["launches"] == {"segment_sums": 0}  # the CPU runs the twin
