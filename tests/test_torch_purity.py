"""The port's boundaries: it imports neither JAX nor the JAX package, its
engine runs on CUDA unless told otherwise, and a path outside its slice
raises ``NotImplementedError`` instead of answering on the host.

The import check reads the sources (an AST walk), not ``sys.modules``:
this interpreter may load JAX at start-up whatever the port imports."""

import ast
import decimal
from pathlib import Path
from typing import Dict, List

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import fugue_tpu_torch as ft
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.column.expressions import _FuncExpr

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib")


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in FORBIDDEN or (root.startswith("fugue_tpu") and root != "fugue_tpu_torch")


def _imports(path: Path) -> List[str]:
    names: List[str] = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif isinstance(node, ast.Call):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if fname in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    names.append(arg.value)
    return names


def _port_sources() -> List[Path]:
    files = sorted((ROOT / "fugue_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py",
        ROOT / "profile_torch_main_path.py",
        ROOT / "old_vs_new.py",
    ]
    assert len(files) > 10
    return files


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_jax_package(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert bad == [], f"{path} imports {bad}"


def test_import_check_catches_forbidden_forms(tmp_path):
    src = tmp_path / "x.py"
    src.write_text(
        "import jax.numpy as jnp\nfrom fugue_tpu.schema import Schema\n"
        "import importlib\nimportlib.import_module('fugue_tpu_test')\n"
        "from fugue_tpu_torch import api\n"
    )
    assert [m for m in _imports(src) if _forbidden(m)] == [
        "jax.numpy", "fugue_tpu.schema", "fugue_tpu_test"
    ]


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.TorchExecutionEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.make_execution_engine("torch")
    assert ft.TorchExecutionEngine(device="cpu").device == torch.device("cpu")


def _udf(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"k": a["k"], "v": a["v"]}


def _pandas_udf(df: pd.DataFrame) -> pd.DataFrame:
    return df


def _df(key_dtype=np.int32) -> pd.DataFrame:
    rng = np.random.default_rng(0)
    return pd.DataFrame({
        "k": rng.integers(0, 5, 50).astype(key_dtype),
        "v": rng.random(50).astype(np.float32),
    })


def _agg(func, arg, distinct=False):
    return _FuncExpr(func, arg, arg_distinct=distinct, is_aggregation=True)


_UNPORTED = {
    "first_distinct": lambda e: ft.aggregate(_df(), "k", engine=e, s=_agg("first", ft.col("v"), True)),
    "last_distinct": lambda e: ft.aggregate(_df(), None, engine=e, s=_agg("last", ft.col("v"), True)),
    "count_distinct_of_an_expression": lambda e: ft.aggregate(
        _df(), "k", engine=e, c=ff.count_distinct(ft.col("v") * 2)
    ),
    "min_of_a_function_expression": lambda e: ft.aggregate(
        _df(), "k", engine=e, s=ff.min(_FuncExpr("atan", ft.col("v")))
    ),
    # uint16 and float16 columns are on the card now; a binary, nested or
    # decimal column beside them is a host column, and a union or a join of
    # such frames goes to the JAX package's host engine (queue 1 item 2(b))
    "uint16_column": lambda e: ft.union(
        pd.DataFrame({"u": np.arange(3, dtype=np.uint16), "b": [b"x", b"y", None]}),
        pd.DataFrame({"u": np.arange(3, dtype=np.uint16), "b": [b"x", b"y", None]}), engine=e),
    "float16_column": lambda e: ft.join(
        pa.table({"k": [1, 2], "h": pa.array(np.arange(2, dtype=np.float16)),
                  "l": pa.array([[1], [2, 3]])}),
        pd.DataFrame({"k": [1]}), how="inner", on=["k"], engine=e),
    "min_of_a_string": lambda e: ft.aggregate(
        _df().assign(s=lambda d: d["k"].astype(str)), "k", engine=e, m=ff.min(ft.col("s"))
    ),
    "dynamic_like_over_the_pair_cap": lambda e: ft.filter(
        pd.DataFrame({"s": [f"s{i}" for i in range(1100)], "p": [f"p{i}" for i in range(1100)]}),
        _FuncExpr("like", ft.col("s"), ft.col("p"), False), engine=e,
    ),
    "inexact_fillna": lambda e: ft.fillna(
        pd.DataFrame({"c": pd.array([1, None, 3], dtype="Int64")}), 2.5, engine=e
    ),
    "take_by_a_uint16_presort": lambda e: ft.take(
        pa.Table.from_pandas(_df().assign(u=np.arange(50, dtype=np.uint16)),
                             preserve_index=False).append_column(
            "d", pa.array([decimal.Decimal(i) for i in range(50)], pa.decimal128(12, 2))),
        3, presort="u desc", engine=e
    ),
    "pandas_transformer": lambda e: ft.transform(_df(), _pandas_udf, "k:int,v:float", engine=e),
    "other_engine": lambda e: ft.make_execution_engine("native"),
    "save_table": lambda e: e.sql_engine.save_table(_df(), "t"),
    "load_table": lambda e: e.sql_engine.load_table("t"),
    "non_lowerable_select": lambda e: ft.raw_sql(
        "SELECT a.k FROM", _df(), "AS a JOIN", _df(), "AS b ON a.k < b.k", engine=e),
}


@pytest.mark.parametrize("case", sorted(_UNPORTED))
def test_unported_paths_raise(case):
    engine = ft.make_execution_engine(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _UNPORTED[case](engine)


@pytest.mark.parametrize("case,op,item", [
    ("inexact_fillna", "fillna", r"queue 1 item 2\(b\)"),
    ("take_by_a_uint16_presort", "take", r"queue 1 item 2\(b\)"),
])
def test_refused_fillna_and_take_count_as_fallbacks(case, op, item):
    """A fill the column cannot hold exactly and a take of a frame that
    holds a host column (a decimal beside the uint16 presort column, which
    the card now holds) go to the JAX package's host engine: each names
    its ROADMAP.md item and counts in ``fallbacks``."""
    engine = ft.make_execution_engine(device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        _UNPORTED[case](engine)
    assert engine.fallbacks == {op: 1}


@pytest.mark.parametrize("case,op,item", [
    ("non_lowerable_select", "sql_select", r"queue 1 item 2\(b\)"),
    ("save_table", "save_table", "queue 1 item 16"),
    ("load_table", "load_table", "queue 1 item 16"),
])
def test_refused_sql_counts_as_fallbacks(case, op, item):
    """A SELECT the algebra bridge does not lower (the JAX package runs
    it on its host SELECT runner) and the device table catalog each name
    their ROADMAP.md item and count in ``fallbacks``."""
    engine = ft.make_execution_engine(device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        _UNPORTED[case](engine)
    assert engine.fallbacks == {op: 1}


@pytest.mark.parametrize("uri", ["memory://t/x.parquet", "lake://warehouse/t",
                                 "gs://bucket/x.parquet"])
@pytest.mark.parametrize("op", ["load_df", "save_df"])
def test_unported_uris_raise_naming_item_13(uri, op):
    """The in-memory filesystem, lake tables and fsspec's object stores
    are not ported (ROADMAP.md queue 1 item 13): a load or a save of such a
    URI raises, is counted in ``fallbacks`` and reads or writes nothing on
    the host instead, through the engine and through ``ft.load``/``ft.save``."""
    engine = ft.make_execution_engine(device="cpu")
    run = {"load_df": lambda: engine.load_df(uri),
           "save_df": lambda: engine.save_df(_df(), uri)}[op]
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        run()
    assert engine.fallbacks == {op: 1}
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        if op == "load_df":
            ft.load(uri, engine=engine)
        else:
            ft.save(_df(), uri, engine=engine)


def test_string_columns_and_string_partition_keys_answer():
    """The two string cases this file once listed as unported: a string
    column uploads and comes back, and a transform partitioned by a
    string key sees each row's group (the partitions of the int key it
    was made from)."""
    engine = ft.make_execution_engine(device="cpu")
    assert engine.to_df(pd.DataFrame({"s": ["a", "b"]})).as_pandas()["s"].tolist() == ["a", "b"]
    pdf = _df().assign(k=lambda d: d["k"].astype(str))

    def seg(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": a["k"], "v": a["v"], "g": a["_segment_ids"]}

    out = ft.transform(pdf, seg, "k:str,v:float,g:int", engine=engine, partition="k")
    assert out["k"].tolist() == pdf["k"].tolist() and out["v"].tolist() == pdf["v"].tolist()
    # one segment per distinct key, the same for every row of a key
    assert out.groupby("k")["g"].nunique().eq(1).all() and out["g"].nunique() == 5
    assert engine.fallbacks == {}


def test_refusals_are_counted():
    engine = ft.make_execution_engine(device="cpu")
    with pytest.raises(NotImplementedError):
        _UNPORTED["first_distinct"](engine)
    assert engine.fallbacks == {"aggregate": 1}
    assert engine.strategy_counts == {}


def test_float_keys_and_partitions_run_without_refusal():
    """A partitioned transform and a group-by on a float key, both refused
    before the key factorization was ported, now answer on the engine."""
    engine = ft.make_execution_engine(device="cpu")
    out = ft.transform(_df(), _udf, "k:int,v:float", engine=engine, partition={"by": ["k"]})
    agg = ft.aggregate(_df(np.float32), "k", engine=engine, s=ff.sum(ft.col("v")))
    assert len(out) == 50 and sorted(agg["k"]) == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert engine.fallbacks == {}


# the cases that raised before the rest of the group-by was ported
_NOW_PORTED = {
    "min_on_float_key": ("min", "v", False, ["k"], np.float32),
    "min": ("min", "v", False, ["k"], np.int32),
    "max": ("max", "v", False, ["k"], np.int32),
    "distinct": ("count", "v", True, ["k"], np.int32),
    "no_keys": ("sum", "v", False, None, np.int32),
}


@pytest.mark.parametrize("case", sorted(_NOW_PORTED))
def test_formerly_unported_aggregates_answer_as_the_jax_package(case):
    """Each aggregate this file once listed as unported now answers on the
    engine, equal to the JAX package's on one CPU device (float sums at
    rtol 1e-5, the rest exactly)."""
    from fugue_tpu.column import col as jcol
    from fugue_tpu.column.expressions import _FuncExpr as JFunc
    from fugue_tpu.execution import make_execution_engine as make_jax_engine
    from fugue_tpu.execution.api import aggregate as jaggregate

    func, arg, distinct, keys, key_dtype = _NOW_PORTED[case]
    engine = ft.make_execution_engine(device="cpu")
    got = ft.aggregate(_df(key_dtype), keys, engine=engine, x=_agg(func, ft.col(arg), distinct))
    want = jaggregate(_df(key_dtype), partition_by=keys,
                      engine=make_jax_engine("jax", {"fugue.jax.devices": "0"}),
                      x=JFunc(func, jcol(arg), arg_distinct=distinct, is_aggregation=True),
                      as_fugue=True).as_pandas()
    assert engine.fallbacks == {}
    by = keys or ["x"]
    got, want = (d.sort_values(by).reset_index(drop=True) for d in (got, want))
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    np.testing.assert_allclose(got["x"].to_numpy(), want["x"].to_numpy(),
                               rtol=1e-5 if case == "no_keys" else 0)
