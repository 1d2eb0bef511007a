"""The built-in extensions a workflow's tasks lower to (a port of
``fugue_tpu/extensions/builtins.py``): ``Load`` ``:38``, ``CreateData``
``:52``, the transformer runners ``:62-118``, ``RunTransformer`` ``:120``
with ``_lower_transform`` ``:137`` and ``_lower_cotransform`` ``:173``,
``RunJoin`` ... ``Take`` ``:205-377``, ``SaveAndUse`` ``:378``, ``Show``
``:398``, ``AssertEqFunc`` ``:407``, ``AssertNotEqFunc`` ``:422``,
``Save`` ``:438`` and ``RunOutputTransformer`` ``:457``.

A transform lowers to the engine's ``map_dataframe`` with the runner's
bound ``run`` and the transformer's format hint, from which the engine
reaches the raw ``Dict[str, torch.Tensor]`` function and runs it over
whole columns. A transform of a zip (``TorchZippedDataFrame``, which holds
its members and their names) lowers to the engine's ``comap``: the
members' schemas and names come from the zip itself, where the reference
reads them from a serialized zip's metadata; nothing is serialized."""

from typing import Any, Callable, Dict, List

from fugue_tpu_torch.collections.sql import StructuredRawSQL
from fugue_tpu_torch.column.expressions import ColumnExpr
from fugue_tpu_torch.column.sql import SelectColumns
from fugue_tpu_torch.dataframe.array_dataframe import ArrayDataFrame
from fugue_tpu_torch.dataframe.dataframe import DataFrame
from fugue_tpu_torch.dataframe.dataframes import DataFrames
from fugue_tpu_torch.dataframe.utils import df_eq
from fugue_tpu_torch.extensions.convert import _to_output_transformer, _to_transformer
from fugue_tpu_torch.extensions.interfaces import (
    CoTransformer,
    Creator,
    OutputTransformer,
    Outputter,
    Processor,
    Transformer,
)
from fugue_tpu_torch.extensions.validation import validate_input_schema, validate_partition_spec
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend.zipped import TorchZippedDataFrame
from fugue_tpu_torch.utils.assertion import assert_or_throw


class Load(Creator):
    def create(self) -> DataFrame:
        fmt = self.params.get("fmt", "")
        return self.execution_engine.load_df(
            path=self.params.get_or_throw("path", object),
            format_hint=fmt if fmt != "" else None,
            columns=self.params.get("columns", None),
            **self.params.get("params", dict()),
        )


class CreateData(Creator):
    def create(self) -> DataFrame:
        schema = self.params.get("schema", None)
        return self.execution_engine.to_df(self.params.get_or_throw("data", object),
                                           schema=None if schema is None else Schema(schema))


class _TransformerRunner:
    """The transformer a map runs (``:62``). The port's map reads the raw
    function through ``run``'s ``__self__`` and never calls ``run``, which
    is the host partition loop's entry (ROADMAP.md queue 1 item 2(b))."""

    def __init__(self, df: Any, transformer: Any, ignore_errors: List[type],
                 returns_frame: bool = True):
        self.schema = df.schema
        self.transformer = transformer
        self.ignore_errors = tuple(ignore_errors)
        self.returns_frame = returns_frame  # False: an output transformer's

    def run(self, cursor: Any, df: Any) -> Any:  # pragma: no cover - host loop
        raise NotImplementedError(
            "the host partition loop is ROADMAP.md queue 1 item 2(b) (the host engine)")

    def on_init(self, partition_no: int, df: Any) -> None:
        self.transformer.on_init(df)


def _lower_transform(host: Any, df: Any, tf: Any) -> DataFrame:
    """Configures the transformer and hands it to the engine's
    ``map_dataframe``, or to ``comap`` for a zip (``:137``)."""
    engine = host.execution_engine
    tf._workflow_conf = engine.conf
    tf._params = host.params.get("params", dict())
    tf._partition_spec = host.partition_spec
    rpc_handler = host.params.get("rpc_handler", None)
    if rpc_handler is not None:
        tf._callback = host.rpc_server.make_client(rpc_handler)
    ignore_errors = host.params.get("ignore_errors", [])
    validate_partition_spec(tf.validation_rules, host.partition_spec)
    if isinstance(df, TorchZippedDataFrame):
        assert_or_throw(isinstance(tf, CoTransformer),
                        TypeError(f"{tf} is not a CoTransformer but the input is zipped"))
        return _lower_cotransform(host, df, tf, ignore_errors)
    assert_or_throw(isinstance(tf, Transformer), TypeError(f"{tf} is not a Transformer"))
    validate_input_schema(tf.validation_rules, df.schema)
    tf._key_schema = host.partition_spec.get_key_schema(df.schema)
    output_schema = Schema(tf.get_output_schema(df))
    tf._output_schema = output_schema
    runner = _TransformerRunner(df, tf, ignore_errors,
                                returns_frame=not isinstance(tf, OutputTransformer))
    return engine.map_engine.map_dataframe(
        df, map_func=runner.run, output_schema=output_schema,
        partition_spec=host.partition_spec, on_init=runner.on_init,
        map_func_format_hint=getattr(tf, "get_format_hint", lambda: None)(),
    )


def _lower_cotransform(host: Any, df: TorchZippedDataFrame, tf: CoTransformer,
                       ignore_errors: List[type]) -> DataFrame:
    """``:173``: the output schema from empty frames of the members'
    schemas, then the engine's ``comap``."""
    schemas = [f.schema for f in df.frames]
    if any(n != "" for n in df.names):
        empty = DataFrames({n: ArrayDataFrame([], s) for n, s in zip(df.names, schemas)})
    else:
        empty = DataFrames([ArrayDataFrame([], s) for s in schemas])
    tf._key_schema = df.key_schema
    output_schema = Schema(tf.get_output_schema(empty))
    tf._output_schema = output_schema
    runner = _TransformerRunner(df, tf, ignore_errors)
    return host.execution_engine.comap(
        df, map_func=runner.run, output_schema=output_schema,
        partition_spec=host.partition_spec,
        on_init=lambda no, frames: runner.on_init(no, DataFrames(frames)),
    )


class RunTransformer(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        tf = _to_transformer(self.params.get_or_throw("transformer", object),
                             self.params.get("schema", None))
        return _lower_transform(self, dfs[0], tf)


class RunJoin(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        if len(dfs) == 1:
            return dfs[0]
        how = self.params.get_or_throw("how", str)
        on = self.params.get("on", [])
        df = dfs[0]
        for i in range(1, len(dfs)):
            df = self.execution_engine.join(df, dfs[i], how=how, on=on if len(on) > 0 else None)
        return df


class RunSetOperation(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        if len(dfs) == 1:
            return dfs[0]
        e = self.execution_engine
        func: Callable = {"union": e.union, "subtract": e.subtract,
                          "intersect": e.intersect}[self.params.get_or_throw("how", str)]
        distinct = self.params.get("distinct", True)
        df = dfs[0]
        for i in range(1, len(dfs)):
            df = func(df, dfs[i], distinct=distinct)
        return df


def _one(dfs: DataFrames, what: str) -> Any:
    assert_or_throw(len(dfs) == 1, ValueError(f"{what} takes 1 df"))
    return dfs[0]


class Distinct(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        return self.execution_engine.distinct(_one(dfs, "distinct"))


class Dropna(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        return self.execution_engine.dropna(
            _one(dfs, "dropna"), how=self.params.get("how", "any"),
            thresh=self.params.get_or_none("thresh", int),
            subset=self.params.get("subset", None))


class Fillna(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        return self.execution_engine.fillna(
            _one(dfs, "fillna"), value=self.params.get_or_throw("value", object),
            subset=self.params.get("subset", None))


class RunSQLSelect(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        statement = self.params.get_or_throw("statement", object)
        if isinstance(statement, str):
            statement = StructuredRawSQL([(False, statement)])
        return self.execution_engine.sql_engine.select(dfs, statement)


class Zip(Processor):
    def process(self, dfs: DataFrames) -> Any:
        return self.execution_engine.zip(
            dfs, how=self.params.get("how", "inner"), partition_spec=self.partition_spec,
            temp_path=self.params.get("temp_path", None),
            to_file_threshold=self.params.get("to_file_threshold", -1))


class Select(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        return self.execution_engine.select(
            _one(dfs, "select"), cols=self.params.get_or_throw("columns", SelectColumns),
            where=self.params.get("where", None), having=self.params.get("having", None))


class Filter(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        return self.execution_engine.filter(
            _one(dfs, "filter"), condition=self.params.get_or_throw("condition", ColumnExpr))


class Assign(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        return self.execution_engine.assign(
            _one(dfs, "assign"), columns=self.params.get_or_throw("columns", list))


class Aggregate(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        return self.execution_engine.aggregate(
            _one(dfs, "aggregate"), partition_spec=self.partition_spec,
            agg_cols=self.params.get_or_throw("columns", list))


class Rename(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        return _one(dfs, "rename").rename(self.params.get_or_throw("columns", dict))


class AlterColumns(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        return _one(dfs, "alter_columns").alter_columns(
            self.params.get_or_throw("columns", object))


class DropColumns(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        df = _one(dfs, "drop")
        columns = self.params.get_or_throw("columns", list)
        if self.params.get("if_exists", False):
            columns = [c for c in columns if c in df.schema]
            if len(columns) == 0:
                return df
        return df.drop(columns)


class SelectColumnsP(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        return _one(dfs, "select_columns")[self.params.get_or_throw("columns", list)]


class Sample(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        return self.execution_engine.sample(
            _one(dfs, "sample"), n=self.params.get_or_none("n", int),
            frac=self.params.get_or_none("frac", float),
            replace=self.params.get("replace", False), seed=self.params.get_or_none("seed", int))


class Take(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        return self.execution_engine.take(
            _one(dfs, "take"), n=self.params.get_or_throw("n", int),
            presort=self.params.get("presort", ""),
            na_position=self.params.get("na_position", "last"),
            partition_spec=self.partition_spec)


def _save(ext: Any, df: Any) -> Dict[str, Any]:
    """Writes ``df`` as ``Save`` and ``SaveAndUse`` do; their format hint."""
    fmt = ext.params.get("fmt", "")
    ext.execution_engine.save_df(
        df, path=ext.params.get_or_throw("path", str), format_hint=fmt if fmt != "" else None,
        mode=ext.params.get("mode", "overwrite"), partition_spec=ext.partition_spec,
        force_single=ext.params.get("single", False), **ext.params.get("params", dict()))
    return dict(format_hint=fmt if fmt != "" else None)


class SaveAndUse(Processor):
    def process(self, dfs: DataFrames) -> DataFrame:
        hint = _save(self, _one(dfs, "save_and_use"))
        return self.execution_engine.load_df(self.params.get_or_throw("path", str), **hint)


class Show(Outputter):
    def process(self, dfs: DataFrames) -> None:
        title = self.params.get("title", "")
        for df in dfs.values():
            df.show(self.params.get("n", 10), self.params.get("with_count", False),
                    title if title != "" else None)


class AssertEqFunc(Outputter):
    def process(self, dfs: DataFrames) -> None:
        assert_or_throw(len(dfs) >= 2, ValueError("assert_eq requires >= 2 dfs"))
        for i in range(1, len(dfs)):
            df_eq(dfs[0], dfs[i], throw=True, check_order=self.params.get("check_order", False),
                  check_schema=self.params.get("check_schema", True),
                  digits=self.params.get("digits", 8))


class AssertNotEqFunc(Outputter):
    def process(self, dfs: DataFrames) -> None:
        assert_or_throw(len(dfs) >= 2, ValueError("assert_not_eq requires >= 2 dfs"))
        for i in range(1, len(dfs)):
            assert_or_throw(
                not df_eq(dfs[0], dfs[i], check_order=self.params.get("check_order", False),
                          check_schema=self.params.get("check_schema", True)),
                AssertionError("dataframes are equal"))


class Save(Outputter):
    def process(self, dfs: DataFrames) -> None:
        _save(self, _one(dfs, "save"))


class RunOutputTransformer(Outputter):
    """``out_transform``: a transform whose output is discarded, made
    local so that a lazy engine runs it (``:457``)."""

    def process(self, dfs: DataFrames) -> None:
        tf = _to_output_transformer(self.params.get_or_throw("transformer", object))
        _lower_transform(self, dfs[0], tf).as_local()
