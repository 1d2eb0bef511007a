"""The port's boundaries: it imports neither JAX nor the JAX package, its
engine runs on CUDA unless told otherwise, and a path outside its slice
raises ``NotImplementedError`` instead of answering on the host.

The import check reads the sources (an AST walk), not ``sys.modules``:
this interpreter may load JAX at start-up whatever the port imports."""

import ast
from pathlib import Path
from typing import Dict, List

import numpy as np
import pandas as pd
import pytest
import torch

import fugue_tpu_torch as ft
from fugue_tpu_torch.column import functions as ff

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


_UNPORTED = {
    "min_on_float_key": lambda e: ft.aggregate(
        _df(np.float32), "k", engine=e, s=ff.min(ft.col("v"))
    ),
    "min": lambda e: ft.aggregate(_df(), "k", engine=e, s=ff.min(ft.col("v"))),
    "max": lambda e: ft.aggregate(_df(), "k", engine=e, s=ff.max(ft.col("v"))),
    "distinct": lambda e: ft.aggregate(_df(), "k", engine=e, c=ff.count_distinct(ft.col("v"))),
    "no_keys": lambda e: ft.aggregate(_df(), None, engine=e, s=ff.sum(ft.col("v"))),
    "partitioned_transform_on_string_key": lambda e: ft.transform(
        _df().assign(k=lambda d: d["k"].astype(str)), _udf, "k:str,v:float", engine=e,
        partition="k",
    ),
    "pandas_transformer": lambda e: ft.transform(_df(), _pandas_udf, "k:int,v:float", engine=e),
    "string_column": lambda e: e.to_df(pd.DataFrame({"s": ["a", "b"]})),
    "other_engine": lambda e: ft.make_execution_engine("native"),
}


@pytest.mark.parametrize("case", sorted(_UNPORTED))
def test_unported_paths_raise(case):
    engine = ft.make_execution_engine(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _UNPORTED[case](engine)


def test_refusals_are_counted():
    engine = ft.make_execution_engine(device="cpu")
    with pytest.raises(NotImplementedError):
        _UNPORTED["min_on_float_key"](engine)
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
