"""The port's function wrapper, converters, schema hints and validation
rules (``fugue_tpu_torch/dataframe/function_wrapper.py``,
``fugue_tpu_torch/extensions/``) against the JAX package's: over the same
functions, each converter accepts or refuses alike, with the same codes
(the port's ``t``, ``Dict[str, torch.Tensor]``, where the JAX package has
``j``, ``Dict[str, jax.Array]``) and an error of the same name and
built-in base; the functions include those of the transform annotation
matrix (``fugue_tpu_test/builtin_suite.py:758``)."""

from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import jax
import pandas as pd
import pyarrow as pa
import pytest
import torch

from fugue_tpu.collections.partition import PartitionSpec as JSpec
from fugue_tpu.dataframe import DataFrame as JDataFrame
from fugue_tpu.dataframe import DataFrames as JDataFrames
from fugue_tpu.dataframe import LocalDataFrame as JLocalDataFrame
from fugue_tpu.execution.execution_engine import ExecutionEngine as JEngine
from fugue_tpu.extensions import convert as jconvert
from fugue_tpu.extensions import schema_hint as jhint
from fugue_tpu.extensions import validation as jvalid
from fugue_tpu.schema import Schema as JSchema
from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.dataframe import DataFrame, LocalDataFrame
from fugue_tpu_torch.dataframe.dataframes import DataFrames
from fugue_tpu_torch.execution.execution_engine import ExecutionEngine
from fugue_tpu_torch.extensions import convert, schema_hint, validation
from fugue_tpu_torch.schema import Schema

T = Dict[str, torch.Tensor]
J = Dict[str, jax.Array]


# ---- the functions, each in both packages' annotations ------------------
# (``{F}`` a frame type, ``{E}`` the engine, ``{C}`` DataFrames, ``{D}``
# the device dict; each pair differs in those annotations only)

_SOURCES = {
    "device": "def f(d: {D}) -> {D}: return d",
    "device_params": "def f(d: {D}, a: int = 1) -> {D}: return d",
    "device_callback": "def f(d: {D}, cb: Callable) -> {D}: return d",
    "device_opt_callback": "def f(d: {D}, cb: Optional[Callable] = None) -> {D}: return d",
    "device_none": "def f(d: {D}) -> None: pass",
    "device_two": "def f(a: {D}, b: {D}) -> {D}: return a",
    "device_three": "def f(a: {D}, b: {D}, c: {D}) -> {D}: return a",
    "device_to_pandas": "def f(d: {D}) -> pd.DataFrame: return d",
    "pandas": "def f(df: pd.DataFrame) -> pd.DataFrame: return df",
    "pandas_none": "def f(df: pd.DataFrame) -> None: pass",
    "arrow_in_out": "def f(df: pa.Table) -> pa.Table: return df",
    "dicts_in_rows_out": "def f(rows: Iterable[Dict[str, Any]]) -> List[List[Any]]: return []",
    "rows_in_pandas_out": "def f(rows: List[List[Any]]) -> pd.DataFrame: return None",
    "pandas_in_dicts_out": "def f(df: pd.DataFrame) -> Iterator[Dict[str, Any]]: yield {{}}",
    "iter_pandas": "def f(dfs: Iterable[pd.DataFrame]) -> Iterator[pd.DataFrame]: yield None",
    "iter_arrow": "def f(t: Iterator[pa.Table]) -> Iterable[pa.Table]: return []",
    "frame": "def f(df: {F}) -> {F}: return df",
    "local_frame": "def f(df: {L}) -> {L}: return df",
    "frames": "def f(dfs: {C}) -> {F}: return None",
    "engine_frames": "def f(e: {E}, dfs: {C}) -> {F}: return None",
    "engine_pandas": "def f(e: {E}, df: pd.DataFrame) -> pd.DataFrame: return df",
    "engine_only": "def f(e: {E}) -> pd.DataFrame: return None",
    "creator_params": "def f(n: int = 3) -> List[List[Any]]: return []",
    "nothing": "def f() -> None: pass",
    "no_annotation": "def f(df): return df",
    "varargs": "def f(*dfs: pd.DataFrame) -> pd.DataFrame: return None",
    "kwargs": "def f(df: pd.DataFrame, **kw: Any) -> pd.DataFrame: return df",
    "int_return": "def f(df: pd.DataFrame) -> int: return 1",
    "pandas_and_device": "def f(a: pd.DataFrame, b: {D}) -> {D}: return b",
    "callback_first": "def f(cb: Callable, df: pd.DataFrame) -> pd.DataFrame: return df",
    "two_pandas": "def f(a: pd.DataFrame, b: pd.DataFrame) -> pd.DataFrame: return a",
}


def _make(name: str, port: bool) -> Callable:
    names = (dict(D="T", F="DataFrame", L="LocalDataFrame", C="DataFrames", E="ExecutionEngine")
             if port else
             dict(D="J", F="JDataFrame", L="JLocalDataFrame", C="JDataFrames", E="JEngine"))
    env = dict(globals())
    exec(_SOURCES[name].format(**names), env)  # noqa: S102 - the test's own sources
    return env["f"]


_KINDS = {
    "transformer": ("_to_transformer", lambda f: ("k:int",)),
    "output_transformer": ("_to_output_transformer", lambda f: ()),
    "creator": ("_to_creator", lambda f: ("k:int",)),
    "processor": ("_to_processor", lambda f: ("k:int",)),
    "outputter": ("_to_outputter", lambda f: ()),
}


def _decide(module: Any, kind: str, func: Callable) -> Any:
    """What converting ``func`` gives: its class name and codes, or the
    error's class name and built-in base."""
    conv, args = _KINDS[kind]
    try:
        ext = getattr(module, conv)(func, *args(func))
    except Exception as e:  # the decision under test
        base = next(c.__name__ for c in type(e).__mro__ if c.__module__ == "builtins")
        return ("error", type(e).__name__, base)
    return ("ok", type(ext).__name__, ext.wrapper.input_code.replace("j", "t"),
            ext.wrapper.output_code.replace("j", "t"))


@pytest.mark.parametrize("kind", sorted(_KINDS))
@pytest.mark.parametrize("name", sorted(_SOURCES))
def test_converters_decide_as_the_reference(name, kind):
    """Each converter accepts or refuses the function as the JAX
    package's does, with the same extension class and codes."""
    assert _decide(convert, kind, _make(name, True)) == _decide(jconvert, kind, _make(name, False))


def test_the_device_parameter_has_its_own_code_and_hint():
    from fugue_tpu_torch.dataframe.function_wrapper import DataFrameFunctionWrapper, annotation_code

    assert annotation_code(T) == "t" and annotation_code(Dict[str, int]) == "x"
    w = DataFrameFunctionWrapper(_make("device", True))
    assert (w.input_code, w.output_code, w.get_format_hint()) == ("t", "t", "torch")
    assert convert._is_cotransform_func(_make("device_two", True))
    assert not convert._is_cotransform_func(_make("device", True))


def test_a_schema_comment_and_validation_comments_are_read():
    # schema: k:int,v:double
    # partitionby_has: k
    def commented(d: T) -> T:
        return d

    tf = convert._to_transformer(commented)
    assert tf._schema_hint == "k:int,v:double"
    assert tf.validation_rules == {"partitionby_has": "k"}
    with pytest.raises(convert.ExtensionConvertError, match="schema hint is required"):
        convert._to_transformer(_make("device", True))


_HINTS = ["a:int,b:str", "*", "*,c:double", "*,-b", "+c:int", "-b", "*,-a,b",
          "*,a:int", "x:[int],y:{a:int,b:str}", "*,-z", ""]


@pytest.mark.parametrize("hint", _HINTS)
def test_schema_hints_resolve_as_the_reference(hint):
    def resolve(mod: Any, schema_cls: Any) -> str:
        try:
            return str(mod.apply_schema_hint(schema_cls("a:int,b:str"), hint))
        except Exception as e:
            return type(e).__name__
    assert resolve(schema_hint, Schema) == resolve(jhint, JSchema)


_RULES = [
    ({"partitionby_has": "k"}, dict(by=["k", "j"])),
    ({"partitionby_has": "k,z"}, dict(by=["k"])),
    ({"partitionby_is": ["k", "j"]}, dict(by=["k", "j"])),
    ({"partitionby_is": "k"}, dict(by=["k", "j"])),
    ({"presort_has": "v desc"}, dict(by=["k"], presort="v desc, w")),
    ({"presort_has": "v"}, dict(by=["k"], presort="v desc")),
    ({"presort_is": "v desc,w"}, dict(presort="v desc, w asc")),
    ({"input_has": "k,v"}, {}),
    ({"input_has": ["k", "q"]}, {}),
    ({"input_is": "k:int,v:double"}, {}),
    ({"input_is": "k:long,v:double"}, {}),
    ({"bogus": 1}, {}),
]


@pytest.mark.parametrize("rules,spec", _RULES, ids=[str(r) for r, _ in _RULES])
def test_validation_rules_decide_as_the_reference(rules, spec):
    def decide(mod: Any, spec_cls: Any, schema_cls: Any) -> List[str]:
        out = []
        for step in (lambda: mod.validate_rules(rules),
                     lambda: mod.validate_partition_spec(rules, spec_cls(**spec)),
                     lambda: mod.validate_input_schema(rules, schema_cls("k:int,v:double"))):
            try:
                step()
                out.append("ok")
            except Exception as e:
                out.append(type(e).__name__)
        return out
    assert decide(validation, PartitionSpec, Schema) == decide(jvalid, JSpec, JSchema)


def test_registered_aliases_resolve():
    convert.register_transformer("port_device_alias", _make("device", True))
    tf = convert._to_transformer("port_device_alias", "k:int")
    assert tf.wrapper.input_code == "t"
    with pytest.raises(ValueError, match="not a registered transformer"):
        convert._to_transformer("no_such_alias", "k:int")
