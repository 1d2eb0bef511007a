"""Interfaceless converters: a class, an instance, a plain function (its
schema from an argument or a ``# schema:`` comment) or a registered alias
made into an extension (a port of ``fugue_tpu/extensions/convert.py``:
the registries ``:51-77``, ``_FuncAsTransformer``
``:133``, ``_FuncAsOutputTransformer`` ``:173``, ``_FuncAsCoTransformer``
``:194``, ``_FuncAsOutputCoTransformer`` ``:241``, the creator, processor
and outputter wrappers and the decorators). A signature is accepted or
refused by a regex over the wrapper's codes, as in the reference, the
port's ``t`` (``Dict[str, torch.Tensor]``) standing where the JAX
package's ``j`` does. The registries are plain dicts; the reference's
``parse_*`` plugin hooks (``:83-103``, the identity unless a backend
registers a parser) are left out, as the port has no plugin registry."""

import copy
from typing import Any, Callable, Dict, List, Optional

from fugue_tpu_torch.dataframe.dataframe import DataFrame
from fugue_tpu_torch.dataframe.dataframes import DataFrames
from fugue_tpu_torch.dataframe.function_wrapper import DataFrameFunctionWrapper
from fugue_tpu_torch.exceptions import FugueInterfacelessError
from fugue_tpu_torch.extensions.interfaces import (
    CoTransformer,
    Creator,
    OutputCoTransformer,
    Outputter,
    OutputTransformer,
    Processor,
    Transformer,
)
from fugue_tpu_torch.extensions.schema_hint import apply_schema_hint, parse_comment_annotation
from fugue_tpu_torch.extensions.validation import (
    parse_validation_rules_from_comment,
    validate_rules,
)
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw
from fugue_tpu_torch.utils.hash import to_uuid


class ExtensionConvertError(FugueInterfacelessError, ValueError):
    """An object can't be made into the requested extension."""


_DF = "[dlpqrRmMPQt]"

_REGISTRIES: Dict[str, Dict[str, Any]] = {
    k: {} for k in ("creator", "processor", "outputter", "transformer", "output_transformer",
                    "cotransformer", "output_cotransformer")
}


def _register(kind: str, name: str, extension: Any, on_dup: str = "overwrite") -> None:
    reg = _REGISTRIES[kind]
    if name in reg:
        if on_dup == "throw":
            raise KeyError(f"{kind} {name} already registered")
        if on_dup == "ignore":
            return
    reg[name] = extension


def register_creator(alias: str, obj: Any, on_dup: str = "overwrite") -> None:
    _register("creator", alias, obj, on_dup)


def register_processor(alias: str, obj: Any, on_dup: str = "overwrite") -> None:
    _register("processor", alias, obj, on_dup)


def register_outputter(alias: str, obj: Any, on_dup: str = "overwrite") -> None:
    _register("outputter", alias, obj, on_dup)


def register_transformer(alias: str, obj: Any, on_dup: str = "overwrite") -> None:
    _register("transformer", alias, obj, on_dup)


def register_output_transformer(alias: str, obj: Any, on_dup: str = "overwrite") -> None:
    _register("output_transformer", alias, obj, on_dup)


class _FuncExtension:
    """What the ``_FuncAs*`` wrappers share (``:108``)."""

    def __init__(self, wrapper: DataFrameFunctionWrapper, validation: Dict[str, Any]):
        self._wrapper = wrapper
        self._validation = validation

    @property
    def validation_rules(self) -> Dict[str, Any]:
        return self._validation

    @property
    def wrapper(self) -> DataFrameFunctionWrapper:
        return self._wrapper

    def __uuid__(self) -> str:
        return to_uuid(type(self).__name__, self._wrapper.func, self._validation)

    def _ctx(self) -> Dict[str, Any]:
        return dict(callback=getattr(self, "_callback", None),
                    engine=getattr(self, "_execution_engine", None))


def _members(wrapper: DataFrameFunctionWrapper, dfs: DataFrames) -> List[Any]:
    return [dfs] if wrapper.input_code.startswith("c") else list(dfs.values())


class _FuncAsTransformer(_FuncExtension, Transformer):
    def __init__(self, wrapper: DataFrameFunctionWrapper, schema: Any,
                 validation: Dict[str, Any]):
        super().__init__(wrapper, validation)
        self._schema_hint = schema

    def get_output_schema(self, df: DataFrame) -> Any:
        return apply_schema_hint(df.schema, self._schema_hint)

    def get_format_hint(self) -> Optional[str]:
        return self._wrapper.get_format_hint()

    def transform(self, df: DataFrame) -> DataFrame:
        return self._wrapper.run([df], dict(self.params), output_schema=self.output_schema,
                                 ctx=self._ctx())

    def __uuid__(self) -> str:
        return to_uuid(super().__uuid__(), str(self._schema_hint))

    @staticmethod
    def from_func(func: Callable, schema: Any, validation: Dict[str, Any]
                  ) -> "_FuncAsTransformer":
        if schema is None:
            schema = parse_comment_annotation(func, "schema")
        assert_or_throw(schema is not None,
                        ExtensionConvertError(f"schema hint is required for transformer {func}"))
        validation = dict(parse_validation_rules_from_comment(func), **validation)
        wrapper = DataFrameFunctionWrapper(func, f"^{_DF}[fF]?x*$", f"^{_DF}$")
        return _FuncAsTransformer(wrapper, schema, validate_rules(validation))


class _FuncAsOutputTransformer(_FuncExtension, OutputTransformer):
    def get_format_hint(self) -> Optional[str]:
        return self._wrapper.get_format_hint()

    def process(self, df: DataFrame) -> None:
        self._wrapper.run([df], dict(self.params), output=False, ctx=self._ctx())

    @staticmethod
    def from_func(func: Callable, validation: Dict[str, Any]) -> "_FuncAsOutputTransformer":
        validation = dict(parse_validation_rules_from_comment(func), **validation)
        wrapper = DataFrameFunctionWrapper(func, f"^{_DF}[fF]?x*$", "^[dlpqrRmMPQtn]$")
        return _FuncAsOutputTransformer(wrapper, validate_rules(validation))


class _FuncAsCoTransformer(_FuncExtension, CoTransformer):
    def __init__(self, wrapper: DataFrameFunctionWrapper, schema: Any,
                 validation: Dict[str, Any]):
        super().__init__(wrapper, validation)
        self._schema_hint = schema

    def get_output_schema(self, dfs: DataFrames) -> Any:
        if isinstance(self._schema_hint, str) and "*" in self._schema_hint:
            raise ValueError("cotransformer schema hint can't use *")
        return Schema(self._schema_hint) if isinstance(self._schema_hint, str) \
            else self._schema_hint

    def get_format_hint(self) -> Optional[str]:
        return self._wrapper.get_format_hint()

    def transform(self, dfs: DataFrames) -> DataFrame:
        return self._wrapper.run(_members(self._wrapper, dfs), dict(self.params),
                                 output_schema=self.output_schema, ctx=self._ctx())

    def __uuid__(self) -> str:
        return to_uuid(super().__uuid__(), str(self._schema_hint))

    @staticmethod
    def from_func(func: Callable, schema: Any, validation: Dict[str, Any]
                  ) -> "_FuncAsCoTransformer":
        if schema is None:
            schema = parse_comment_annotation(func, "schema")
        assert_or_throw(schema is not None,
                        ExtensionConvertError(f"schema hint is required for cotransformer {func}"))
        validation = dict(parse_validation_rules_from_comment(func), **validation)
        wrapper = DataFrameFunctionWrapper(func, f"^(c|{_DF}+)[fF]?x*$", f"^{_DF}$")
        return _FuncAsCoTransformer(wrapper, schema, validate_rules(validation))


class _FuncAsOutputCoTransformer(_FuncExtension, OutputCoTransformer):
    def get_format_hint(self) -> Optional[str]:
        return self._wrapper.get_format_hint()

    def process(self, dfs: DataFrames) -> None:
        self._wrapper.run(_members(self._wrapper, dfs), dict(self.params), output=False,
                          ctx=self._ctx())

    @staticmethod
    def from_func(func: Callable, validation: Dict[str, Any]) -> "_FuncAsOutputCoTransformer":
        validation = dict(parse_validation_rules_from_comment(func), **validation)
        wrapper = DataFrameFunctionWrapper(func, f"^(c|{_DF}+)[fF]?x*$", "^[dlpqrRmMPQtn]$")
        return _FuncAsOutputCoTransformer(wrapper, validate_rules(validation))


class _FuncAsCreator(_FuncExtension, Creator):
    def __init__(self, wrapper: DataFrameFunctionWrapper, schema: Any):
        super().__init__(wrapper, {})
        self._schema_hint = schema

    def create(self) -> DataFrame:
        schema = None if self._schema_hint is None else Schema(self._schema_hint)
        res = self._wrapper.run([], dict(self.params), output_schema=schema,
                                ctx=dict(engine=getattr(self, "_execution_engine", None)))
        return res if isinstance(res, DataFrame) else self.execution_engine.to_df(res, schema)

    def __uuid__(self) -> str:
        return to_uuid(super().__uuid__(), str(self._schema_hint))

    @staticmethod
    def from_func(func: Callable, schema: Any) -> "_FuncAsCreator":
        if schema is None:
            schema = parse_comment_annotation(func, "schema")
        return _FuncAsCreator(DataFrameFunctionWrapper(func, "^e?x*$", f"^{_DF}$"), schema)


class _FuncAsProcessor(_FuncExtension, Processor):
    def __init__(self, wrapper: DataFrameFunctionWrapper, schema: Any,
                 validation: Optional[Dict[str, Any]] = None):
        super().__init__(wrapper, validation or {})
        self._schema_hint = schema

    def process(self, dfs: DataFrames) -> DataFrame:
        if self._wrapper.input_code.replace("e", "").startswith("c"):
            args: List[Any] = [dfs]
        else:
            args = [df.as_local() for df in dfs.values()]
        schema = None if self._schema_hint is None else Schema(self._schema_hint)
        res = self._wrapper.run(args, dict(self.params), output_schema=schema,
                                ctx=dict(engine=getattr(self, "_execution_engine", None)))
        return res if isinstance(res, DataFrame) else self.execution_engine.to_df(res, schema)

    def __uuid__(self) -> str:
        return to_uuid(super().__uuid__(), str(self._schema_hint))

    @staticmethod
    def from_func(func: Callable, schema: Any) -> "_FuncAsProcessor":
        if schema is None:
            schema = parse_comment_annotation(func, "schema")
        validation = validate_rules(parse_validation_rules_from_comment(func))
        wrapper = DataFrameFunctionWrapper(func, f"^e?(c|{_DF}+)x*$", f"^{_DF}$")
        return _FuncAsProcessor(wrapper, schema, validation)


class _FuncAsOutputter(_FuncExtension, Outputter):
    def process(self, dfs: DataFrames) -> None:
        if self._wrapper.input_code.replace("e", "").startswith("c"):
            args: List[Any] = [dfs]
        else:
            args = [df.as_local() for df in dfs.values()]
        self._wrapper.run(args, dict(self.params), output=False,
                          ctx=dict(engine=getattr(self, "_execution_engine", None)))

    @staticmethod
    def from_func(func: Callable) -> "_FuncAsOutputter":
        validation = validate_rules(parse_validation_rules_from_comment(func))
        wrapper = DataFrameFunctionWrapper(func, f"^e?(c|{_DF}+)x*$", "^.*$")
        return _FuncAsOutputter(wrapper, validation)


def _to_extension(obj: Any, kind: str, base: type, from_func: Callable) -> Any:
    if isinstance(obj, str):
        registered = _REGISTRIES[kind].get(obj)
        assert_or_throw(registered is not None,
                        ValueError(f"{obj!r} is not a registered {kind}"))
        return _to_extension(registered, kind, base, from_func)
    if isinstance(obj, base):
        return copy.copy(obj)
    if isinstance(obj, type) and issubclass(obj, base):
        return obj()
    if callable(obj):
        return from_func(obj)
    raise ExtensionConvertError(f"can't convert {obj!r} to {kind}")


def _to_creator(obj: Any, schema: Any = None) -> Creator:
    return _to_extension(obj, "creator", Creator, lambda f: _FuncAsCreator.from_func(f, schema))


def _to_processor(obj: Any, schema: Any = None) -> Processor:
    return _to_extension(obj, "processor", Processor,
                         lambda f: _FuncAsProcessor.from_func(f, schema))


def _to_outputter(obj: Any) -> Outputter:
    return _to_extension(obj, "outputter", Outputter, _FuncAsOutputter.from_func)


def _to_transformer(obj: Any, schema: Any = None, validation: Optional[Dict[str, Any]] = None
                    ) -> Any:
    """A Transformer or a CoTransformer: a ``DataFrames`` or more than one
    frame parameter makes a cotransformer (``:402``)."""
    validation = validation or {}
    if isinstance(obj, str):
        registered = _REGISTRIES["transformer"].get(obj) or _REGISTRIES["cotransformer"].get(obj)
        assert_or_throw(registered is not None,
                        ValueError(f"{obj!r} is not a registered transformer"))
        return _to_transformer(registered, schema, validation)
    if isinstance(obj, (Transformer, CoTransformer)):
        return copy.copy(obj)
    if isinstance(obj, type) and issubclass(obj, (Transformer, CoTransformer)):
        return obj()
    if callable(obj):
        if _is_cotransform_func(obj):
            return _FuncAsCoTransformer.from_func(obj, schema, validation)
        return _FuncAsTransformer.from_func(obj, schema, validation)
    raise ExtensionConvertError(f"can't convert {obj!r} to transformer")


def _to_output_transformer(obj: Any, validation: Optional[Dict[str, Any]] = None) -> Any:
    validation = validation or {}
    if isinstance(obj, str):
        registered = (_REGISTRIES["output_transformer"].get(obj)
                      or _REGISTRIES["output_cotransformer"].get(obj)
                      or _REGISTRIES["transformer"].get(obj))
        assert_or_throw(registered is not None,
                        ValueError(f"{obj!r} is not a registered output transformer"))
        return _to_output_transformer(registered, validation)
    if isinstance(obj, (OutputTransformer, OutputCoTransformer)):
        return copy.copy(obj)
    if isinstance(obj, type) and issubclass(obj, (OutputTransformer, OutputCoTransformer)):
        return obj()
    if callable(obj):
        if _is_cotransform_func(obj):
            return _FuncAsOutputCoTransformer.from_func(obj, validation)
        return _FuncAsOutputTransformer.from_func(obj, validation)
    raise ExtensionConvertError(f"can't convert {obj!r} to output transformer")


def _is_cotransform_func(func: Callable) -> bool:
    try:
        code = DataFrameFunctionWrapper(func).input_code
    except TypeError:
        return False
    return code.startswith("c") or len([c for c in code if c in "dlpqrRmMPQtc"]) > 1


def creator(schema: Any = None) -> Callable:
    return lambda func: _FuncAsCreator.from_func(func, schema)


def processor(schema: Any = None) -> Callable:
    return lambda func: _FuncAsProcessor.from_func(func, schema)


def outputter() -> Callable:
    return _FuncAsOutputter.from_func


def transformer(schema: Any, **validation: Any) -> Callable:
    return lambda func: _FuncAsTransformer.from_func(func, schema, validation)


def output_transformer(**validation: Any) -> Callable:
    return lambda func: _FuncAsOutputTransformer.from_func(func, validation)


def cotransformer(schema: Any, **validation: Any) -> Callable:
    return lambda func: _FuncAsCoTransformer.from_func(func, schema, validation)


def output_cotransformer(**validation: Any) -> Callable:
    return lambda func: _FuncAsOutputCoTransformer.from_func(func, validation)
