"""The interfaceless core: a plain function's annotations mapped onto
one-letter codes, and its frames converted to and from them (a port of
``fugue_tpu/dataframe/function_wrapper.py``: ``AnnotatedParam`` ``:65``,
``fugue_annotated_param`` ``:85``, the params ``:114-292``,
``annotation_code`` ``:295``, ``DataFrameFunctionWrapper`` ``:340``).

Codes, as in the reference: ``d`` DataFrame, ``l`` LocalDataFrame, ``p``
pd.DataFrame, ``q`` pa.Table, ``r`` List[List[Any]], ``R``
Iterable[List[Any]], ``m`` List[Dict[str, Any]], ``M``
Iterable[Dict[str, Any]], ``P`` Iterable[pd.DataFrame], ``Q``
Iterable[pa.Table], ``c`` DataFrames, ``f``/``F`` a (optional) callback,
``e`` the engine, ``x`` any other parameter, ``n`` no output. The port's
own is ``t``, ``Dict[str, torch.Tensor]`` (format hint ``"torch"``), in
place of the JAX package's ``j``, ``Dict[str, jax.Array]``
(``jax_backend/registry.py:25-56``): the engine's map and comap run such a
function over whole columns on the card. Every annotation parses as in the
reference, so a signature is accepted or refused alike; a creator, a
processor or an outputter converts its frames on the host as the
reference's does, while a ``t`` parameter of one (host work per
partition) is refused, naming ROADMAP.md queue 1 item 2(b).
"""

import collections.abc as _abc
import inspect
import re
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Union,
    get_args,
    get_origin,
    get_type_hints,
)

import pandas as pd
import pyarrow as pa
import torch

from fugue_tpu_torch.dataframe.array_dataframe import ArrayDataFrame
from fugue_tpu_torch.dataframe.arrow_dataframe import ArrowDataFrame
from fugue_tpu_torch.dataframe.dataframe import DataFrame, LocalDataFrame
from fugue_tpu_torch.dataframe.dataframes import DataFrames
from fugue_tpu_torch.dataframe.utils import arrow_to_table, pandas_to_table
from fugue_tpu_torch.exceptions import FugueInterfacelessError
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw


class FunctionSignatureError(FugueInterfacelessError, TypeError):
    """A function's signature does not fit the extension it is asked to be
    (``:60``)."""


class AnnotatedParam:
    """The handler of one annotation kind."""

    code = "x"
    format_hint: Optional[str] = None

    def to_input(self, df: Any, ctx: Dict[str, Any]) -> Any:
        raise NotImplementedError  # pragma: no cover

    def to_output_df(self, output: Any, schema: Schema, ctx: Dict[str, Any]) -> DataFrame:
        raise NotImplementedError  # pragma: no cover


_PARAM_REGISTRY: List[Any] = []  # (matcher, param class)


def fugue_annotated_param(annotation: Any, matcher: Optional[Callable[[Any], bool]] = None
                          ) -> Callable:
    """Registers an ``AnnotatedParam`` class for an annotation (``:85``)."""

    def deco(cls: type) -> type:
        _PARAM_REGISTRY.append((matcher or (lambda a: a == annotation), cls))
        return cls

    return deco


def _resolve_param(annotation: Any) -> Optional[AnnotatedParam]:
    for matcher, cls in reversed(_PARAM_REGISTRY):
        try:
            if matcher(annotation):
                return cls()
        except Exception:
            continue
    return None


def _concat(tables: Iterable[pa.Table], schema: Schema) -> ArrowDataFrame:
    parts = [arrow_to_table(t, schema) for t in tables]
    return ArrowDataFrame(pa.concat_tables(parts) if parts else None, schema)


@fugue_annotated_param(DataFrame)
class _DataFrameParam(AnnotatedParam):
    code = "d"

    def to_input(self, df: Any, ctx: Dict[str, Any]) -> Any:
        return df

    def to_output_df(self, output: Any, schema: Schema, ctx: Dict[str, Any]) -> DataFrame:
        assert_or_throw(isinstance(output, DataFrame), ValueError(f"{output} is not a DataFrame"))
        assert_or_throw(output.schema == schema,
                        ValueError(f"schema mismatch {output.schema} vs {schema}"))
        return output.as_local()


@fugue_annotated_param(LocalDataFrame)
class _LocalDataFrameParam(_DataFrameParam):
    code = "l"


@fugue_annotated_param(pd.DataFrame)
class _PandasParam(AnnotatedParam):
    code = "p"
    format_hint = "pandas"

    def to_input(self, df: Any, ctx: Dict[str, Any]) -> Any:
        return df.as_pandas()

    def to_output_df(self, output: Any, schema: Schema, ctx: Dict[str, Any]) -> DataFrame:
        assert_or_throw(isinstance(output, pd.DataFrame), ValueError("output is not pd.DataFrame"))
        return ArrowDataFrame(pandas_to_table(output, schema), schema)


@fugue_annotated_param(pa.Table)
class _ArrowParam(AnnotatedParam):
    code = "q"
    format_hint = "pyarrow"

    def to_input(self, df: Any, ctx: Dict[str, Any]) -> Any:
        return df.as_arrow()

    def to_output_df(self, output: Any, schema: Schema, ctx: Dict[str, Any]) -> DataFrame:
        assert_or_throw(isinstance(output, pa.Table), ValueError("output is not pa.Table"))
        return ArrowDataFrame(output, schema)


@fugue_annotated_param(List[List[Any]])
class _RowsParam(AnnotatedParam):
    code = "r"

    def to_input(self, df: Any, ctx: Dict[str, Any]) -> Any:
        return df.as_array(type_safe=True)

    def to_output_df(self, output: Any, schema: Schema, ctx: Dict[str, Any]) -> DataFrame:
        return ArrayDataFrame(output, schema)


@fugue_annotated_param(Iterable[List[Any]])
class _IterRowsParam(_RowsParam):
    code = "R"

    def to_input(self, df: Any, ctx: Dict[str, Any]) -> Any:
        return df.as_array_iterable(type_safe=True)


@fugue_annotated_param(List[Dict[str, Any]])
class _DictsParam(AnnotatedParam):
    code = "m"

    def to_input(self, df: Any, ctx: Dict[str, Any]) -> Any:
        return list(df.as_dict_iterable())

    def to_output_df(self, output: Any, schema: Schema, ctx: Dict[str, Any]) -> DataFrame:
        return ArrayDataFrame(([row.get(n) for n in schema.names] for row in output), schema)


@fugue_annotated_param(Iterable[Dict[str, Any]])
class _IterDictsParam(_DictsParam):
    code = "M"

    def to_input(self, df: Any, ctx: Dict[str, Any]) -> Any:
        return df.as_dict_iterable()


@fugue_annotated_param(Iterable[pd.DataFrame])
class _IterPandasParam(AnnotatedParam):
    code = "P"
    format_hint = "pandas"

    def to_input(self, df: Any, ctx: Dict[str, Any]) -> Any:
        return iter([df.as_pandas()])

    def to_output_df(self, output: Any, schema: Schema, ctx: Dict[str, Any]) -> DataFrame:
        return _concat((pandas_to_table(o, schema) for o in output), schema)


@fugue_annotated_param(Iterable[pa.Table])
class _IterArrowParam(AnnotatedParam):
    code = "Q"
    format_hint = "pyarrow"

    def to_input(self, df: Any, ctx: Dict[str, Any]) -> Any:
        return iter([df.as_arrow()])

    def to_output_df(self, output: Any, schema: Schema, ctx: Dict[str, Any]) -> DataFrame:
        return _concat(output, schema)


@fugue_annotated_param(DataFrames)
class _DataFramesParam(AnnotatedParam):
    code = "c"


fugue_annotated_param(Iterator[List[Any]])(_IterRowsParam)
fugue_annotated_param(Iterator[Dict[str, Any]])(_IterDictsParam)
fugue_annotated_param(Iterator[pd.DataFrame])(_IterPandasParam)
fugue_annotated_param(Iterator[pa.Table])(_IterArrowParam)


def _is_tensor_dict(anno: Any) -> bool:
    """``Dict[str, torch.Tensor]`` or ``dict[str, torch.Tensor]``."""
    return get_origin(anno) is dict and get_args(anno) == (str, torch.Tensor)


@fugue_annotated_param(None, matcher=_is_tensor_dict)
class TorchTensorsParam(AnnotatedParam):
    """``Dict[str, torch.Tensor]``: on the torch engine the function runs
    over whole columns on the card (``TorchMapEngine._compiled_map``, the
    ABI there). Handing it one partition's columns at a time is the host
    engine's work."""

    code = "t"
    format_hint = "torch"

    def to_input(self, df: Any, ctx: Dict[str, Any]) -> Any:
        raise NotImplementedError(
            "a Dict[str, torch.Tensor] parameter outside a transformer (one partition's "
            "columns on the host) is not ported; see ROADMAP.md queue 1 item 2(b)")

    to_output_df = to_input  # type: ignore[assignment]


class _CallbackParam(AnnotatedParam):
    code = "f"


class _OptionalCallbackParam(AnnotatedParam):
    code = "F"


class _EngineParam(AnnotatedParam):
    code = "e"


class _OtherParam(AnnotatedParam):
    code = "x"


class _NoneParam(AnnotatedParam):
    code = "n"


_DF_INPUT_CODES = "dlpqrRmMPQt"


def annotation_code(annotation: Any) -> str:
    return _annotation_param(annotation).code


def _annotation_param(anno: Any) -> AnnotatedParam:
    from fugue_tpu_torch.execution.execution_engine import ExecutionEngine

    if anno is None or anno is type(None) or anno is inspect.Parameter.empty:
        return _OtherParam()
    if anno == "None":
        return _NoneParam()
    origin = get_origin(anno)
    if anno is Callable or anno is callable or origin is _abc.Callable:
        return _CallbackParam()
    if origin is Union:
        args = [a for a in get_args(anno) if a is not type(None)]
        if len(args) == 1:
            inner = _annotation_param(args[0])
            return _OptionalCallbackParam() if inner.code == "f" else inner
    if isinstance(anno, type) and issubclass(anno, ExecutionEngine):
        return _EngineParam()
    return _resolve_param(anno) or _OtherParam()


class _Param:
    def __init__(self, name: str, param: AnnotatedParam, required: bool):
        self.name = name
        self.param = param
        self.required = required

    @property
    def code(self) -> str:
        return self.param.code


class DataFrameFunctionWrapper:
    """A plain function with each parameter and its return classified, the
    code string checked against ``params_re`` and ``return_re``, and its
    frames converted at call time (``:340``)."""

    def __init__(self, func: Callable, params_re: str = ".*", return_re: str = ".*"):
        self._func = func
        sig = inspect.signature(func)
        try:
            hints = get_type_hints(func)
        except Exception:
            hints = {}
        self._params: List[_Param] = []
        for name, p in sig.parameters.items():
            assert_or_throw(
                p.kind not in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD),
                TypeError("*args/**kwargs not supported in fugue functions"),
            )
            anno = hints.get(name, p.annotation)
            self._params.append(
                _Param(name, _annotation_param(anno), p.default is inspect.Parameter.empty))
        ret_anno = hints.get("return", sig.return_annotation)
        if ret_anno is None or ret_anno is type(None) or ret_anno is inspect.Signature.empty:
            self._rt: AnnotatedParam = _NoneParam()
        else:
            self._rt = _annotation_param(ret_anno)
            if isinstance(self._rt, _OtherParam):
                self._rt = _NoneParam()
        self._input_code = "".join(p.code for p in self._params)
        assert_or_throw(
            re.match(params_re, self._input_code) is not None,
            FunctionSignatureError(
                f"signature code {self._input_code!r} of {func} doesn't match {params_re!r}"),
        )
        assert_or_throw(
            re.match(return_re, self._rt.code) is not None,
            FunctionSignatureError(
                f"return code {self._rt.code!r} of {func} doesn't match {return_re!r}"),
        )

    @property
    def func(self) -> Callable:
        return self._func

    @property
    def input_code(self) -> str:
        return self._input_code

    @property
    def output_code(self) -> str:
        return self._rt.code

    def get_format_hint(self) -> Optional[str]:
        for p in self._params:
            if p.param.format_hint is not None:
                return p.param.format_hint
        return self._rt.format_hint

    def run(
        self,
        args: List[Any],
        kwargs: Dict[str, Any],
        output_schema: Any = None,
        output: bool = True,
        ctx: Optional[Dict[str, Any]] = None,
    ) -> Any:
        """Calls the function (``:410``): ``args`` fill its frame
        parameters in order (a ``DataFrames`` fills ``c``), ``kwargs`` its
        ``x`` parameters; the callback and the engine come from ``ctx``."""
        ctx = ctx or {}
        call_args: Dict[str, Any] = {}
        dfs = list(args)
        for p in self._params:
            if p.code in _DF_INPUT_CODES and len(dfs) > 0:
                call_args[p.name] = p.param.to_input(dfs.pop(0), ctx)
            elif p.code == "c":
                call_args[p.name] = dfs.pop(0)
            elif p.code in ("f", "F"):
                cb = ctx.get("callback")
                assert_or_throw(cb is not None or p.code == "F",
                                ValueError(f"callback required by {p.name} but not provided"))
                call_args[p.name] = cb
            elif p.code == "e":
                call_args[p.name] = ctx.get("engine")
            elif p.name in kwargs:
                call_args[p.name] = kwargs[p.name]
            elif p.required:
                raise ValueError(f"param {p.name} is required but not provided")
        res = self._func(**call_args)
        if not output:
            if isinstance(res, Iterator):
                for _ in res:  # a generator runs only when drained
                    pass
            return None
        if output_schema is None:
            return res
        return self._rt.to_output_df(res, Schema(output_schema), ctx)
