"""``TorchExecutionEngine``: the port's engine, on one ``torch.device``.

A port of the main path of ``fugue_tpu/jax_backend/execution_engine.py``:
``to_df``/``persist`` upload a frame; ``TorchMapEngine`` runs a
``Dict[str, torch.Tensor]`` transformer over whole columns, with the
segment ids of its partition keys when it has some; ``aggregate`` runs
the JAX package's device aggregations (count, sum, avg/mean, min, max,
first, last, median and the variance family, and their DISTINCT forms
but FIRST/LAST) by keys or with none: count/sum/avg by keys with a bin
spec through the binned packed aggregate, whose whole per-row part
(segment ids, row validity, sums) is one launch of the fused CUDA kernel;
any other plan through the key factorization and
``groupby.segment_aggs`` over its segment ids; no keys through the same
over one segment. ``join`` runs every join type on the card
(``torch_backend/relational.py``). ``filter``, ``assign`` and ``select`` (a projection, or
a group-by with computed keys, WHERE and HAVING) evaluate their column
expressions with one launch of the K6 expression program per call
(``torch_backend/expr_eval.py``), and so does an aggregate whose
arguments are more than bare columns; a filter leaves the columns as
they are and gives the frame a new ``row_valid`` with a lazy count.
String columns are int32 dictionary codes on the card with their
decode table on the host: they pass through transformers (``_<name>_dict``
beside the codes), group by code, join after one re-coding of the right
side's key, and take part in expressions as table gathers; timestamps and
dates are their int64 microseconds and int32 days. ``union``,
``intersect``, ``subtract``, ``distinct``, ``dropna``, ``fillna``,
``take`` and ``sample`` (without replacement) flip a frame's row
validity with a lazy count (``relational.py``: K12-K14 and the presort
words of K11), or fill its columns in one K6 launch; ``repartition`` and
``sample`` with replacement gather rows through K10 (``gather_indices``).

The engine runs on CUDA unless the caller passes ``device="cpu"``, and
then every kernel runs as its plain PyTorch twin. Paths the port does not
have yet raise ``NotImplementedError`` naming the ROADMAP.md item that
ports them; nothing falls back to a host engine. ``fallbacks`` counts
those refusals by operation, ``strategy_counts`` the aggregates by the
route of their kernels (``"cuda"`` or ``"reference"``) and the ones that
took the generic (factorized) branch (``"generic"``) or had no keys
(``"global"``), and the joins by route (``"join_mask"``,
``"join_unique"``, ``"join_expand"``).
"""

from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, List, NoReturn, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import torch

from fugue_tpu_torch.collections.partition import (
    KEYWORD_CONCURRENCY,
    KEYWORD_ROWCOUNT,
    PartitionSpec,
    parse_presort_exp,
)
from fugue_tpu_torch.column.expressions import (
    VARIANCE_FUNCS,
    ColumnExpr,
    _FuncExpr,
    _NamedColumnExpr,
)
from fugue_tpu_torch.collections.sql import StructuredRawSQL
from fugue_tpu_torch.column.sql import SelectColumns, rewrite_having
from fugue_tpu_torch.dataframe.dataframe_iterable_dataframe import LocalDataFrameIterableDataFrame
from fugue_tpu_torch.dataframe.utils import (
    arrow_to_table,
    get_join_schemas,
    normalize_join_type,
    pandas_to_table,
)
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.sql_frontend import algebra_bridge as ab
from fugue_tpu_torch.sql_frontend.algebra_bridge import inline_scalar_subqueries, translate_query
from fugue_tpu_torch.sql_frontend.checks import check_statement
from fugue_tpu_torch.sql_frontend.parser import parse_select
from fugue_tpu_torch.torch_backend import expr_eval, groupby, relational, streaming
from fugue_tpu_torch.torch_backend.comap_compiled import HostPathRequired, compiled_comap, zip_keys
from fugue_tpu_torch.torch_backend.blocks import (
    TorchBlocks,
    TorchColumn,
    blocks_with_columns,
    from_arrow,
    gather_indices,
    is_string_type,
    keeps_stats,
    pad_rows,
    padded_len,
    torch_dtype,
)
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from fugue_tpu_torch.torch_backend.window import device_window
from fugue_tpu_torch.torch_backend.zipped import TorchZippedDataFrame
from fugue_tpu_torch.utils.assertion import assert_or_throw

# the aggregations the engine runs on its device (``:3739``)
_DEVICE_AGGS = (
    "min", "max", "sum", "avg", "mean", "count", "first", "last", "median", *VARIANCE_FUNCS,
)
# where the JAX package answers on its host engine instead
_HOST_ENGINE = "ROADMAP.md queue 1 item 2(b) (the host engine)"
_TABLE_CATALOG = "ROADMAP.md queue 1 item 16 (the device table catalog)"
# an aggregation of a plan: (output name, function, argument or None for
# COUNT(*), result type)
Plan = Tuple[str, str, Optional[ColumnExpr], pa.DataType]


class TorchMapEngine:
    """The map primitive (``jax_backend/execution_engine.py:86``): a
    transformer over whole padded columns, on the engine's device."""

    def __init__(self, execution_engine: "TorchExecutionEngine"):
        self.execution_engine = execution_engine

    def map_dataframe(
        self,
        df: Any,
        map_func: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
        output_schema: Any,
        partition_spec: Optional[PartitionSpec] = None,
    ) -> TorchDataFrame:
        """``jax_backend/execution_engine.py:95``. A string partition key
        bins by its codes, like any integer key. ``output_schema`` may
        name the input's columns as ``"*"`` (``"*"`` alone, or
        ``"*,w:double"``)."""
        tdf = self.execution_engine.to_df(df)
        keys = [] if partition_spec is None else partition_spec.partition_by
        for k in keys:
            assert_or_throw(k in tdf.blocks.columns, KeyError(f"{k} not in {tdf.schema}"))
        return self._compiled_map(tdf, map_func, _output_schema(output_schema, tdf.schema), keys)

    def _compiled_map(
        self,
        df: TorchDataFrame,
        fn: Callable[[Dict[str, Any]], Dict[str, torch.Tensor]],
        output_schema: Schema,
        keys: List[str],
    ) -> TorchDataFrame:
        """Whole-column execution (``jax_backend/execution_engine.py:177``).

        The transformer ABI, as in the JAX package:

        - each column ``name`` is a tensor over the padded rows, with
          ``_<name>_mask`` (True = valid) beside it when it has nulls; a
          string column is its int32 dictionary codes, with its decode
          table ``_<name>_dict`` (an object ``np.ndarray`` on the host,
          for host code, never for tensor math), a timestamp its int64
          microseconds since the epoch, a date its int32 days;
        - ``_row_valid`` bool[padded]: True = real row, built on first
          access only (XLA drops it from a program that never reads it);
        - ``_nrows``: the true row count as a 0-d int32 device tensor;
        - with partition keys: ``_segment_ids`` int32[padded], the group of
          each row (``groupby.factorize_keys``), and ``_num_segments``, a
          Python int, the segment-id space (the bin count when the keys
          have a bin spec, so some segments may be empty; else the exact
          group count). Rows that are not real carry the sentinel
          ``_num_segments``. ``jax.ops.segment_sum`` drops it; torch's
          ``index_add_``, ``scatter_add_`` and ``bincount`` do not (an id
          equal to the size raises on the CPU and asserts on the card), so
          a torch transformer sums into ``_num_segments + 1`` buckets and
          slices the last off, and clamps the ids to
          ``[0, _num_segments - 1]`` to gather per-segment values back to
          the rows;
        - output columns of the input's padded length are row-aligned with
          it; to change the row count, return ``_nrows`` too (one readback);
        - a string output either passes an input's codes through (and
          keeps its dictionary) or returns its decode table ``_<name>_dict``
          beside its codes (``:164-231``, ``:335-353``): ``value.map(m)``
          is host work over the dictionary and no work on the card. A
          string output with neither is refused (the JAX package runs such
          a transformer on its host engine).

        An output that IS an input column's tensor (passthrough) keeps that
        column's null mask and ``(min, max)`` stats, so a key passed
        through a transform still bins with no readback; passed-through
        codes keep their dictionary only on a string field."""
        blocks = df.blocks
        device = blocks.device
        pad_n = blocks.padded_nrows
        args: Dict[str, Any] = {}
        for name, col in blocks.columns.items():
            args[name] = col.data
            if col.mask is not None:
                args[f"_{name}_mask"] = col.mask
            if col.is_string:
                args[f"_{name}_dict"] = col.dictionary
        args["_nrows"] = blocks.nrows_tensor()
        if keys:
            fr = groupby.factorize_keys(blocks, keys)
            args["_segment_ids"] = fr.seg
            args["_num_segments"] = fr.num_segments
        out = fn(_TransformerArgs(args, blocks))
        assert_or_throw(
            isinstance(out, dict),
            ValueError("torch transformer must return a dict of tensors"),
        )
        first = -1
        for f in output_schema.fields:
            assert_or_throw(
                f.name in out,
                ValueError(f"torch transformer output missing column {f.name}"),
            )
            n = int(out[f.name].shape[0])
            first = n if first < 0 else first
            assert_or_throw(
                n == first,
                ValueError("torch transformer output columns differ in length"),
            )
        row_valid_out: Optional[torch.Tensor] = None
        nrows_dev_out: Optional[torch.Tensor] = None
        if "_nrows" in out:
            # explicit count -> prefix layout over [0, _nrows)
            nrows_out: Optional[int] = int(out["_nrows"])
            target = max(padded_len(nrows_out), padded_len(first))  # type: ignore
        elif first == pad_n:
            # row-aligned: inherit the input's membership, lazy count too
            row_valid_out = blocks.row_valid
            nrows_out = blocks._nrows
            nrows_dev_out = blocks._nrows_dev
            target = pad_n
        else:
            raise ValueError(
                "torch transformer changed the row count "
                f"({pad_n} -> {first}) without returning "
                "'_nrows'; include '_nrows' in the output dict"
            )
        cols: Dict[str, TorchColumn] = {}
        for f in output_schema.fields:
            data = out[f.name].to(device=device, dtype=torch_dtype(f.type))
            src = next(
                (c for c in blocks.columns.values() if c.data is data), None
            )
            mask = out.get(f"_{f.name}_mask")
            if mask is None and src is not None and src.mask is not None:
                # passthrough values keep their nulls unless the fn
                # returned an explicit mask
                mask = src.mask
            stats = src.stats if src is not None and keeps_stats(f.type) else None
            dictionary = None
            if is_string_type(f.type):
                given = out.get(f"_{f.name}_dict")
                if given is not None:  # the transformer's decode table wins
                    dictionary = np.asarray(given, dtype=object)
                elif src is not None and src.is_string:
                    dictionary = src.dictionary
                else:
                    self.execution_engine._unported(
                        "map", f"string output {f.name!r} with neither passed-through codes nor "
                        f"a '_{f.name}_dict'", _HOST_ENGINE)
            cols[f.name] = TorchColumn(
                f.type,
                pad_rows(data, target),
                None if mask is None else pad_rows(mask.to(device), target),
                stats,
                dictionary=dictionary,
            )
        return TorchDataFrame(
            TorchBlocks(
                nrows_out,
                cols,
                device,
                row_valid=row_valid_out,
                nrows_dev=nrows_dev_out,
            ),
            output_schema,
        )


class _TransformerArgs(Mapping):
    """A transformer's input dict: the columns, their masks, ``_nrows`` and
    the partition's segment ids as given, and ``_row_valid`` built from the
    frame the first time the transformer reads it."""

    def __init__(self, cols: Dict[str, Any], blocks: TorchBlocks):
        self._cols = cols
        self._blocks = blocks

    def __getitem__(self, key: str) -> Any:
        if key == "_row_valid" and key not in self._cols:
            self._cols[key] = self._blocks.validity()
        return self._cols[key]

    def __iter__(self) -> Iterator[str]:
        yield from self._cols
        if "_row_valid" not in self._cols:
            yield "_row_valid"

    def __len__(self) -> int:
        return len(self._cols) + ("_row_valid" not in self._cols)


class TorchSQLEngine:
    """The SQL facet (``JaxSQLEngine``, ``jax_backend/execution_engine.py:
    384-537``): parse a SELECT with the port's front end, inline its
    uncorrelated scalar subqueries as literals the device computed, lower
    it through the algebra bridge (``sql_frontend/algebra_bridge.py``)
    and run the plan on the engine's device primitives: ``join``,
    ``union``/``subtract``/``intersect``, ``select`` with WHERE and
    HAVING, ``distinct``, NOT IN (``relational.not_in_join``), windows
    (``torch_backend/window.py``: K15, K16) and ORDER BY/LIMIT/OFFSET
    (``relational.device_sort``).

    Where the JAX package answers on its host SELECT runner (a shape the
    bridge does not lower), the port counts the request in ``fallbacks``
    and raises ``NotImplementedError`` naming ROADMAP.md queue 1 item
    2(b); a device plan that raises is not caught. ``save_table`` and
    ``load_table``, the device table catalog (``:540-573``), wait for
    queue 1 item 16."""

    def __init__(self, execution_engine: "TorchExecutionEngine"):
        self.execution_engine = execution_engine

    def select(self, dfs: Dict[str, Any], statement: StructuredRawSQL) -> TorchDataFrame:
        """``:399``: the SELECT ``statement`` over the frames ``dfs`` (by
        the names the statement uses)."""
        engine = self.execution_engine
        sql = statement.construct()
        dfs = {name: engine._input("sql_select", df) for name, df in dfs.items()}
        schemas = {name: list(df.schema.names) for name, df in dfs.items()}
        q = parse_select(sql)
        # uncorrelated scalar subqueries run as device plans now and inline
        # as literals (one scalar readback each)
        inline_scalar_subqueries(q, schemas, lambda p: self._exec_plan(p, dfs, {}))
        plan = translate_query(q, schemas)
        if plan is None:
            self._refuse(q, dfs, "a SELECT the algebra bridge does not lower "
                         f"({sql.strip()[:80]!r})")
        return self._exec_plan(plan, dfs, {}, q)

    def _refuse(self, q: Any, dfs: Dict[str, TorchDataFrame], what: str) -> NoReturn:
        """Raises ``SQLExecutionError`` where ``q`` is invalid
        (``check_statement``), else refuses it as not ported (counted in
        ``fallbacks``), naming ROADMAP.md queue 1 item 2(b)."""
        check_statement(q, {name: df.schema for name, df in dfs.items()})
        self.execution_engine._unported("sql_select", what, _HOST_ENGINE)

    def _exec_plan(self, plan: Any, dfs: Dict[str, Any], done: Dict[int, TorchDataFrame],
                   q: Any = None) -> TorchDataFrame:
        """``:431``: memoized by plan identity, so that a CTE the query
        reads twice runs once. ``q``, the statement, is checked before a
        device plan that declines it is refused."""
        if id(plan) not in done:
            done[id(plan)] = self._exec_plan_uncached(plan, dfs, done, q)
        return done[id(plan)]

    def _exec_plan_uncached(self, plan: Any, dfs: Dict[str, Any],
                            done: Dict[int, TorchDataFrame], q: Any) -> TorchDataFrame:
        """``:442-513``."""
        engine = self.execution_engine
        if isinstance(plan, ab.ScanPlan):
            lowered = {n.lower(): n for n in dfs}
            return engine.to_df(dfs[lowered[plan.table]])
        if isinstance(plan, ab.JoinPlan):
            return engine.join(self._exec_plan(plan.left, dfs, done, q),
                               self._exec_plan(plan.right, dfs, done, q), how=plan.how,
                               on=list(plan.on))
        if isinstance(plan, ab.NotInJoinPlan):
            left = engine.to_df(self._exec_plan(plan.left, dfs, done, q))
            right = engine.to_df(self._exec_plan(plan.right, dfs, done, q))
            out = relational.not_in_join(left.blocks, right.blocks, [plan.key])
            return TorchDataFrame(out, left.schema)
        if isinstance(plan, ab.SetPlan):
            left = self._exec_plan(plan.left, dfs, done, q)
            right = self._exec_plan(plan.right, dfs, done, q)
            if plan.op == "union":
                return engine.union(left, right, distinct=plan.distinct)
            if plan.op == "except":
                return engine.subtract(left, right, distinct=plan.distinct)
            return engine.intersect(left, right, distinct=plan.distinct)
        if isinstance(plan, ab.WindowPlan):
            src = engine.to_df(self._exec_plan(plan.source, dfs, done, q))
            if plan.where is not None:
                src = engine.filter(src, plan.where)
            blocks, schema = device_window(
                src.blocks, src.schema, plan.items,
                lambda what: self._refuse(q, dfs, what) if q is not None
                else engine._unported("sql_select", what, _HOST_ENGINE))
            return TorchDataFrame(blocks, schema)
        assert_or_throw(isinstance(plan, ab.SelectPlan), ValueError(f"bad plan {plan}"))
        out = self._exec_plan(plan.source, dfs, done, q)
        if plan.cols is not None:
            out = engine.select(out, plan.cols, where=plan.where, having=plan.having)
        if plan.distinct:
            out = engine.distinct(out)
        if plan.order_by or plan.limit is not None or plan.offset is not None:
            return self._exec_sort(out, plan)
        return engine.to_df(out)

    def _exec_sort(self, df: Any, plan: Any) -> TorchDataFrame:
        """``:515``: ORDER BY/LIMIT/OFFSET (``relational.device_sort``);
        an item's nulls last unless it says FIRST."""
        tdf = self.execution_engine.to_df(df)
        sorts = [(name, asc, None if nulls is None else nulls == "FIRST")
                 for name, asc, nulls in plan.order_by]
        return TorchDataFrame(relational.device_sort(tdf.blocks, sorts, limit=plan.limit,
                                                     offset=plan.offset), tdf.schema)

    def save_table(self, df: Any, table: str, mode: str = "overwrite", **kwargs: Any) -> None:
        """``:540``: the device table catalog, not ported yet."""
        self.execution_engine._unported("save_table", "the device table catalog",
                                        _TABLE_CATALOG)

    def load_table(self, table: str, **kwargs: Any) -> TorchDataFrame:
        """``:564``: the device table catalog, not ported yet."""
        self.execution_engine._unported("load_table", "the device table catalog",
                                        _TABLE_CATALOG)


class TorchExecutionEngine:
    """The port's engine (``jax_backend/execution_engine.py:575``).

    ``device`` defaults to ``torch.device("cuda")``; without CUDA the
    constructor raises unless the caller asked for ``device="cpu"``."""

    def __init__(self, conf: Any = None, device: Any = None):
        self.conf: Dict[str, Any] = dict(conf or {})
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchExecutionEngine runs on CUDA and no CUDA device is "
                    "available; pass device='cpu' to run the plain twins"
                )
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        assert_or_throw(
            self.device.type in ("cuda", "cpu"),
            ValueError(f"unsupported device {self.device}"),
        )
        self.map_engine = TorchMapEngine(self)
        self._strategy_counts: Dict[str, int] = {}
        self._fallbacks: Dict[str, int] = {}
        # compiled K6 programs of this engine's filters, assigns,
        # projections and aggregate arguments; and of the single
        # expressions its checks compiled (a string's tables are built
        # once a frame, not once a call)
        self._programs = expr_eval.ProgramCache()
        self._checked = expr_eval.ProgramCache()
        self.sql_engine = TorchSQLEngine(self)
        # the last streaming aggregate's StreamingAggregator.stats()
        # (chunks, rows, rebases, slots)
        self.stream_stats: Dict[str, int] = {}

    @property
    def strategy_counts(self) -> Dict[str, int]:
        """Aggregates by route (``:909``): ``"cuda"`` or ``"reference"``
        (where their kernels ran), and ``"generic"`` or ``"global"``; joins
        by route: ``"join_mask"`` (semi, anti), ``"join_unique"`` (the
        unique right side) or ``"join_expand"``."""
        return dict(self._strategy_counts)

    @property
    def fallbacks(self) -> Dict[str, int]:
        """Refused (not yet ported) requests by operation (``:772``)."""
        return dict(self._fallbacks)

    def _unported(self, op: str, what: str, roadmap: str) -> NoReturn:
        self._fallbacks[op] = self._fallbacks.get(op, 0) + 1
        raise NotImplementedError(
            f"{what} is not ported to the torch engine yet; see {roadmap}"
        )

    def _require_device(self, op: str, expr: ColumnExpr, blocks: TorchBlocks,
                        out_dtype: Optional[torch.dtype] = None) -> None:
        """Refuses (``_unported``) an expression the card does not
        evaluate (as ``out_dtype`` where given), naming the ROADMAP.md
        item that ports it."""
        try:
            expr_eval.check(expr, blocks, out_dtype, self._checked)
        except expr_eval.Refused as r:
            self._unported(op, r.what, r.item)

    def to_df(self, df: Any, schema: Any = None) -> TorchDataFrame:
        """pandas, arrow or a frame on this device -> ``TorchDataFrame``,
        uploaded now (``:1297``). A pandas frame is typed as the reference
        types it (``dataframe.utils.pandas_to_table``: an empty or all-null
        object column is ``str``); ``schema``, where given, names and types
        the columns of a local frame, and must be None for a
        ``TorchDataFrame``."""
        if isinstance(df, TorchDataFrame):
            assert_or_throw(schema is None,
                            ValueError("schema must be None for TorchDataFrame"))
            assert_or_throw(
                df.device == self.device,
                ValueError(f"frame is on {df.device}, engine on {self.device}"),
            )
            return df
        if isinstance(df, pd.DataFrame):
            table = pandas_to_table(df, schema)
        elif isinstance(df, pa.Table):
            table = arrow_to_table(df, schema)
        elif isinstance(df, LocalDataFrameIterableDataFrame):
            table = arrow_to_table(df.as_arrow(), schema)  # the stream materialized
        else:
            raise ValueError(f"can't convert {type(df)} to a TorchDataFrame")
        tschema = Schema(table.schema)
        return TorchDataFrame(from_arrow(table, tschema, self.device), tschema)

    def persist(self, df: Any, schema: Any = None) -> TorchDataFrame:
        """``to_df``, then wait until the upload is on the card (``:1576``)."""
        res = self.to_df(df, schema)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return res

    def select(
        self,
        df: Any,
        cols: SelectColumns,
        where: Optional[ColumnExpr] = None,
        having: Optional[ColumnExpr] = None,
    ) -> TorchDataFrame:
        """``:1345``: WHERE (``filter``), then the projection
        (``_device_project``) or the group-by (``_device_groupby_select``)
        with HAVING. What the JAX package answers on its host engine
        (``_can_select_on_device``, ``:2174``) raises here."""
        tdf = self.to_df(df)
        resolved = cols.replace_wildcard(tdf.schema).assert_all_with_names()
        self._check_select(tdf, resolved, where, having)
        out_schema = resolved.infer_schema(tdf.schema)
        filtered = tdf if where is None else self.filter(tdf, where)
        if not resolved.has_agg:
            return self._device_project(filtered, resolved, out_schema)
        return self._device_groupby_select(filtered, resolved, having)

    def filter(self, df: Any, condition: ColumnExpr) -> TorchDataFrame:
        """``:1375``: one K6 launch flips row validity (the condition's value
        AND its validity AND the row's); columns and their stats are
        untouched, and the row count becomes a lazy device scalar. No
        gather, no readback."""
        tdf = self.to_df(df)
        blocks = tdf.blocks
        self._require_device("filter", condition, blocks, torch.bool)
        keep, count = expr_eval.filter_rows(blocks, condition, self._programs)
        return TorchDataFrame(
            TorchBlocks(None, dict(blocks.columns), blocks.device, row_valid=keep,
                        nrows_dev=count),
            tdf.schema,
        )

    def assign(self, df: Any, columns: List[ColumnExpr]) -> TorchDataFrame:
        """``:1426``: new or replaced columns, every expression in one K6
        launch over the input's columns; a bare column reference keeps its
        mask, stats and dictionary; a computed string its codes and
        dictionary (``:1463-1482``)."""
        tdf = self.to_df(df)
        blocks = tdf.blocks
        schema = tdf.schema
        plans: List[Tuple[str, pa.DataType, ColumnExpr]] = []
        for c in columns:
            self._require_device("assign", c, blocks)
            name = c.output_name
            tp = c.infer_type(schema) or (schema[name].type if name in schema else None)
            assert_or_throw(tp is not None, ValueError(f"can't infer {c}"))
            plans.append((name, tp, c))
            fields = [f if f.name != name else pa.field(name, tp) for f in schema.fields]
            schema = Schema(fields if name in schema else fields + [pa.field(name, tp)])
        values = expr_eval.evaluate(
            blocks, [c for _, _, c in plans], [torch_dtype(tp) for _, tp, _ in plans],
            self._programs,
        )
        new_cols = dict(blocks.columns)
        for (name, tp, c), r in zip(plans, values):
            new_cols[name] = _result_column(tp, r, blocks, c)
        return TorchDataFrame(blocks_with_columns(blocks, new_cols), schema)

    def join(
        self, df1: Any, df2: Any, how: str, on: Optional[List[str]] = None
    ) -> TorchDataFrame:
        """``:1731``: semi and anti flip the left frame's validity (no
        readback); inner, left, right and full outer and cross enumerate
        their matches on the card with one readback of the output size, or
        none where the right side's one key is unique (inner, left outer;
        for right outer the left side's). Right outer is a left outer join
        with the sides swapped and the columns reordered. Null keys never
        match. A frame on another device or a column the card cannot hold
        raises ``NotImplementedError`` and counts in ``fallbacks``."""
        t1, t2 = self._input("join", df1), self._input("join", df2)
        hownorm = normalize_join_type(how)
        key_schema, output_schema = get_join_schemas(t1, t2, hownorm, on)
        keys = list(key_schema.names)
        b1, b2 = t1.blocks, t2.blocks
        if hownorm in ("semi", "leftsemi", "anti", "leftanti"):
            out = relational.semi_anti_join(b1, b2, keys, anti=hownorm in ("anti", "leftanti"))
            self._count_strategy("join_mask")
            return TorchDataFrame(out, output_schema)
        if hownorm == "rightouter":
            _, swapped = get_join_schemas(t2, t1, "leftouter", keys)
            out, route = relational.expand_join(
                b2, b1, keys, "leftouter", t2.schema, t1.schema, swapped)
            out = blocks_with_columns(out, {n: out.columns[n] for n in output_schema.names})
        else:
            out, route = relational.expand_join(
                b1, b2, keys, hownorm, t1.schema, t2.schema, output_schema)
        self._count_strategy(route)
        return TorchDataFrame(out, output_schema)

    def _input(self, op: str, df: Any) -> TorchDataFrame:
        """``to_df`` of an input of ``op``. A frame on another device (work
        across devices, ROADMAP.md queue 1 item 12) and a column type the
        card does not hold (``to_df`` raises for uint16-64, float16, binary,
        nested and decimal columns, queue 1 item 1) count in ``fallbacks`` as a refused ``op``."""
        if isinstance(df, TorchDataFrame) and df.device != self.device:
            self._unported(op, f"{op} of a frame on {df.device} on an engine on "
                           f"{self.device}", "ROADMAP.md queue 1 item 12")
        try:
            return self.to_df(df)
        except NotImplementedError:
            self._fallbacks[op] = self._fallbacks.get(op, 0) + 1
            raise

    def union(self, df1: Any, df2: Any, distinct: bool = True) -> TorchDataFrame:
        """``:1790``: the rows of both frames (string columns in one
        dictionary, ``union_all_blocks``), then ``distinct`` unless
        ``distinct=False``. The schemas must be equal."""
        t1, t2 = self._input("union", df1), self._input("union", df2)
        assert_or_throw(t1.schema == t2.schema,
                        ValueError(f"union schema mismatch {t1.schema} vs {t2.schema}"))
        out = TorchDataFrame(relational.union_all_blocks(t1.blocks, t2.blocks), t1.schema)
        return self.distinct(out) if distinct else out

    def subtract(self, df1: Any, df2: Any, distinct: bool = True) -> TorchDataFrame:
        """``:1806``: EXCEPT [ALL] (``_set_op``)."""
        return self._set_op(df1, df2, distinct, subtract=True)

    def intersect(self, df1: Any, df2: Any, distinct: bool = True) -> TorchDataFrame:
        """``:1811``: INTERSECT [ALL] (``_set_op``)."""
        return self._set_op(df1, df2, distinct, subtract=False)

    def _set_op(self, df1: Any, df2: Any, distinct: bool, subtract: bool) -> TorchDataFrame:
        """``:1816``: the rows of ``df1`` whose whole row (nulls equal) is
        (INTERSECT) or is not (EXCEPT) among ``df2``'s, each once where
        ``distinct``, else as a multiset
        (``relational.intersect_subtract``): ``df1``'s columns with their
        validity flipped and the count lazy. The schemas must be equal."""
        name = "subtract" if subtract else "intersect"
        t1, t2 = self._input(name, df1), self._input(name, df2)
        assert_or_throw(t1.schema == t2.schema,
                        ValueError(f"{name} schema mismatch {t1.schema} vs {t2.schema}"))
        out = relational.intersect_subtract(t1.blocks, t2.blocks, t1.schema.names, subtract,
                                            distinct=distinct)
        return TorchDataFrame(out, t1.schema)

    def distinct(self, df: Any) -> TorchDataFrame:
        """``:1843``: the factorization of every column
        (``groupby.factorize_keys``: K1 where they bin, else the sort
        path), then K13 keeps each group's first row: the frame's validity
        flipped, the count lazy, no gather. A frame known to be empty is
        returned as it is."""
        tdf = self._input("distinct", df)
        blocks = tdf.blocks
        if blocks.nrows_known and blocks.nrows == 0:
            return tdf
        fr = groupby.factorize_keys(blocks, tdf.schema.names)
        keep, count = relational.first_rows(fr.first_idx, blocks.padded_nrows,
                                            occupied=fr.occupied)
        return TorchDataFrame(relational.keep_rows(blocks, keep, count), tdf.schema)

    def dropna(self, df: Any, how: str = "any", thresh: Optional[int] = None,
               subset: Optional[List[str]] = None) -> TorchDataFrame:
        """``:1886``: the rows with every (``how="any"``) or any
        (``"all"``) column of ``subset`` (default: all) valid, or at least
        ``thresh`` of them, by one launch of K14 over their masks; the
        count lazy."""
        tdf = self._input("dropna", df)
        blocks = tdf.blocks
        assert_or_throw(how in ("any", "all"), ValueError(f"invalid dropna how {how!r}"))
        names = list(subset) if subset is not None else tdf.schema.names
        for n in names:
            assert_or_throw(n in blocks.columns, KeyError(f"{n} not in {tdf.schema}"))
        masks = {n: blocks.columns[n].mask for n in names if blocks.columns[n].mask is not None}
        keep, count = relational.null_count_keep(blocks, list(masks.values()), len(names), how,
                                                 thresh)
        return TorchDataFrame(relational.keep_rows(blocks, keep, count), tdf.schema)

    def fillna(self, df: Any, value: Any, subset: Optional[List[str]] = None) -> TorchDataFrame:
        """``:1948``: nulls (and a float column's NaN) filled with
        ``value``, or per column with a dict's values, in one K6 launch
        (``relational.device_fillna``); the filled columns drop their
        masks. A value the column cannot hold exactly (2.5 into an
        integer column), which the JAX package answers on its host engine,
        raises naming ROADMAP.md queue 1 item 2(b)."""
        assert_or_throw(
            not isinstance(value, dict) or all(v is not None for v in value.values()),
            ValueError("fillna dict can't contain None"),
        )
        assert_or_throw(value is not None, ValueError("fillna value can't be None"))
        tdf = self._input("fillna", df)
        blocks = tdf.blocks
        if isinstance(value, dict):
            fills: Dict[str, Any] = dict(value)
        elif subset is not None:
            fills = {c: value for c in subset}
        else:
            fills = {c: value for c in tdf.schema.names}
        targets = {n: v for n, v in fills.items() if n in blocks.columns}
        res = relational.device_fillna(blocks, targets)
        if res is None:
            self._unported("fillna", f"a fill value ({value!r}) that a column cannot hold "
                           "exactly", _HOST_ENGINE)
        return TorchDataFrame(res, tdf.schema)  # type: ignore[arg-type]

    def sample(self, df: Any, n: Optional[int] = None, frac: Optional[float] = None,
               replace: bool = False, seed: Optional[int] = None) -> TorchDataFrame:
        """``:1982``: without replacement, exactly ``min(n, rows)`` or
        ``min(round(rows * frac), rows)`` rows kept in their place, the
        same rows for the same seed (``relational.device_sample``); with
        replacement, the JAX package's host draw (``:2002-2015``: the real
        rows' indices read back, ``np.random.default_rng(seed).choice``,
        sorted), then ``gather_indices``."""
        assert_or_throw((n is None) != (frac is None),
                        ValueError("one and only one of n and frac must be set"))
        tdf = self._input("sample", df)
        blocks = tdf.blocks
        if not replace:
            return TorchDataFrame(relational.device_sample(blocks, n, frac, seed), tdf.schema)
        if blocks.row_valid is not None:
            valid_idx = np.nonzero(blocks.row_valid.cpu().numpy())[0]
        else:
            valid_idx = np.arange(blocks.nrows)
        total = len(valid_idx)
        rng = np.random.default_rng(seed)
        count = n if n is not None else int(round(total * frac))  # type: ignore[operator]
        idx = valid_idx[rng.choice(total, size=count, replace=True)]
        return TorchDataFrame(gather_indices(blocks, torch.from_numpy(np.sort(idx))), tdf.schema)

    def take(self, df: Any, n: int, presort: str, na_position: str = "last",
             partition_spec: Optional[PartitionSpec] = None) -> TorchDataFrame:
        """``:2017``: the first ``n`` rows of each partition of
        ``partition_spec`` (or of the frame) under ``presort`` (default:
        the spec's presort; none: row order), nulls and NaN first or last
        by ``na_position``, kept in their place with the count lazy
        (``relational.device_take``)."""
        assert_or_throw(isinstance(n, int) and n >= 0,
                        ValueError("n must be a non-negative int"))
        assert_or_throw(na_position in ("first", "last"), ValueError("invalid na_position"))
        tdf = self._input("take", df)
        partition_spec = partition_spec or PartitionSpec()
        sorts = parse_presort_exp(presort) if presort else partition_spec.presort
        out = relational.device_take(tdf.blocks, n, sorts, na_position,
                                     partition_spec.partition_by)
        return TorchDataFrame(out, tdf.schema)

    def repartition(self, df: Any, partition_spec: PartitionSpec) -> TorchDataFrame:
        """``:1523``: one card holds a frame whole, so a repartition
        reorders its rows so that contiguous even chunks are the requested
        partitions. ``hash`` by the keys (default: every column) into
        ``num`` partitions: the real rows ordered by ``(segment id % num,
        segment id)``, one stable sort of a K11 word; ``rand``: the real
        rows in a ``default_rng(42)`` permutation; both then gathered by
        ``gather_indices``. Other algorithms, and ``hash`` into one
        partition, return the frame as it is."""
        tdf = self._input("repartition", df)
        algo = partition_spec.algo
        if algo not in ("hash", "rand"):
            return tdf
        blocks = tdf.blocks
        by = [k for k in (partition_spec.partition_by or tdf.schema.names) if k in blocks.columns]
        num = partition_spec.get_num_partitions(
            **{KEYWORD_ROWCOUNT: lambda: blocks.nrows, KEYWORD_CONCURRENCY: lambda: 1})
        if algo == "hash":
            if num <= 1:
                return tdf
            idx = relational.hash_partition_order(blocks, by, num)
        else:
            vidx = np.nonzero(blocks.validity().cpu().numpy())[0]
            idx = torch.from_numpy(vidx[np.random.default_rng(42).permutation(len(vidx))])
        return TorchDataFrame(gather_indices(blocks, idx, scattered=True), tdf.schema)

    def aggregate(
        self,
        df: Any,
        partition_spec: Optional[PartitionSpec],
        agg_cols: List[ColumnExpr],
    ) -> TorchDataFrame:
        """``:1498``: an iterable of frames streams chunk by chunk into
        accumulators on the card (``_try_stream_aggregate``); any other
        input, and a stream that cannot, takes the bounded aggregate."""
        keys = partition_spec.partition_by if partition_spec is not None else []
        res = self._try_stream_aggregate(df, keys, agg_cols)
        if res is not None:
            return res
        return self._device_aggregate(self.to_df(df), keys, agg_cols)

    def _try_stream_aggregate(self, df: Any, keys: List[str], agg_cols: List[ColumnExpr]
                              ) -> Optional[TorchDataFrame]:
        """``:3087-3150``: the streaming aggregate (``streaming.py``: K19 a
        chunk) where the input is a ``LocalDataFrameIterableDataFrame``, it
        has keys, each integer or bool, and every aggregation is one of
        ``streaming._SUPPORTED`` of a bare column or ``*``; else None. A
        stream the bounded path's semantics cannot stream (null keys, too
        wide a key space, an empty stream) counts in ``fallbacks``, is
        materialized and runs the bounded aggregate, which refuses what it
        declines, naming ROADMAP.md queue 1 item 2(b)."""
        if not isinstance(df, LocalDataFrameIterableDataFrame) or len(keys) == 0:
            return None
        schema = df.schema
        for k in keys:
            if k not in schema or not (pa.types.is_integer(schema[k].type)
                                       or pa.types.is_boolean(schema[k].type)):
                return None
        plans: List[Tuple[str, str, str]] = []
        for c in agg_cols:
            if (not isinstance(c, _FuncExpr) or len(c.args) != 1 or c.arg_distinct
                    or c.func.lower() not in streaming._SUPPORTED):
                return None
            arg = c.args[0]
            if isinstance(arg, _NamedColumnExpr) and arg.wildcard:
                src = keys[0]  # count(*): the key's occurrences
            elif isinstance(arg, _NamedColumnExpr) and arg.as_type is None and arg.name in schema:
                src = arg.name
            else:
                return None
            plans.append((c.output_name, c.func.lower(), src))
        try:
            res, self.stream_stats = streaming.stream_aggregate(
                self, df.arrow_chunks(), schema, list(keys), plans)
            return res
        except streaming.StreamFallback as fb:
            self._fallbacks["aggregate"] = self._fallbacks.get("aggregate", 0) + 1
            table = streaming.materialize_fallback(fb, schema)
            return self._device_aggregate(self.to_df(table), list(keys), agg_cols)

    def zip(self, dfs: Any, how: str = "inner",
            partition_spec: Optional[PartitionSpec] = None) -> TorchZippedDataFrame:
        """``:1616``: records the co-partition of ``dfs`` (a list of frames,
        or a dict of them by name) in a ``TorchZippedDataFrame``, each
        member uploaded; ``comap`` runs over it. Inner, left_outer,
        right_outer, full_outer and cross; the keys are the spec's, else
        the columns every member has (none for cross). The JAX package's
        serialized zip of other types is host work: refused, naming
        ROADMAP.md queue 1 item 2(b)."""
        hownorm = how.lower().replace(" ", "_")
        if hownorm not in ("inner", "left_outer", "right_outer", "full_outer", "cross"):
            self._unported("zip", f"a {how} zip (the serialized zip)", _HOST_ENGINE)
        assert_or_throw(len(dfs) > 0, ValueError("can't zip 0 dataframes"))
        names = list(dfs.keys()) if isinstance(dfs, dict) else [""] * len(dfs)
        members = [self._input("zip", f) for f in (dfs.values() if isinstance(dfs, dict) else dfs)]
        spec = partition_spec or PartitionSpec()
        keys, key_schema = zip_keys(members, hownorm, spec)
        return TorchZippedDataFrame(members, names, hownorm, keys, key_schema, spec)

    def comap(self, df: TorchZippedDataFrame, map_func: Callable[..., Dict[str, torch.Tensor]],
              output_schema: Any, partition_spec: Optional[PartitionSpec] = None,
              on_init: Optional[Callable[[int, Any], Any]] = None) -> TorchDataFrame:
        """``:1669``: the cotransformer ``map_func`` (one
        ``Dict[str, torch.Tensor]`` a member, positionally, to a
        ``Dict[str, torch.Tensor]``) run once over the zip's shared segment
        space (``comap_compiled.compiled_comap``: K17, K18). What the JAX
        package answers on its host group loop (a presort, the ambiguous
        output length, a string output without its decode table) is
        refused, naming ROADMAP.md queue 1 item 2(b), and counted in
        ``fallbacks["comap"]``."""
        assert_or_throw(isinstance(df, TorchZippedDataFrame),
                        ValueError("comap takes a zipped dataframe (zip)"))
        try:
            return compiled_comap(self, df, map_func, output_schema,
                                  partition_spec or PartitionSpec(), on_init)
        except HostPathRequired as e:
            self._unported("comap", str(e), _HOST_ENGINE)

    def _check_select(
        self,
        tdf: TorchDataFrame,
        cols: SelectColumns,
        where: Optional[ColumnExpr],
        having: Optional[ColumnExpr],
    ) -> None:
        """``_can_select_on_device`` (``:2174``): what the JAX package sends
        to its host engine is refused, naming the ROADMAP.md item."""
        blocks = tdf.blocks
        if having is not None and not cols.has_agg:
            self._unported("select", "HAVING without an aggregation", _HOST_ENGINE)
        if cols.is_distinct:
            self._unported("select", "SELECT DISTINCT", _HOST_ENGINE)
        if where is not None:
            self._require_device("select", where, blocks, torch.bool)
        if not cols.has_agg:
            for c in cols.all_cols:
                self._require_device("select", c, blocks)
            return
        for k in cols.group_keys:
            if expr_eval.is_bare(k) and k.output_name == k.name:
                assert_or_throw(k.name in blocks.columns, KeyError(f"{k.name} not in {tdf.schema}"))
                continue
            if k.output_name == "" or k.output_name in blocks.columns:
                # unnamed, or shadowing a column an aggregation may read
                self._unported("select", f"group key {k}", _HOST_ENGINE)
            self._require_device("select", k, blocks)
        # the aggregate refuses the functions and DISTINCT forms it lacks
        for a in cols.agg_funcs:
            if not isinstance(a, _FuncExpr) or len(a.args) != 1:
                self._unported("select", f"aggregation expression {a}", _HOST_ENGINE)

    def _device_project(
        self, tdf: TorchDataFrame, cols: SelectColumns, out_schema: Schema
    ) -> TorchDataFrame:
        """``:2234``: every column of the projection in one K6 launch (bare
        references pass through with their stats and dictionaries; string
        results keep theirs, ``:2259-2277``), over the input's rows."""
        blocks = tdf.blocks
        values = expr_eval.evaluate(
            blocks, cols.all_cols, [torch_dtype(f.type) for f in out_schema.fields],
            self._programs,
        )
        new_cols = {
            f.name: _result_column(f.type, r, blocks, c)
            for c, f, r in zip(cols.all_cols, out_schema.fields, values)
        }
        return TorchDataFrame(blocks_with_columns(blocks, new_cols), out_schema)

    def _device_groupby_select(
        self, tdf: TorchDataFrame, cols: SelectColumns, having: Optional[ColumnExpr]
    ) -> TorchDataFrame:
        """``:2293``: computed or renamed keys are assigned first (one K6
        launch), then the aggregate runs; HAVING's aggregations become
        references to output columns (hidden ones added where the select
        lacks them) and a filter of the aggregate's output applies it."""
        keys: List[str] = []
        computed: List[ColumnExpr] = []
        for k in cols.group_keys:
            if expr_eval.is_bare(k) and k.output_name == k.name:
                keys.append(k.name)
            else:
                computed.append(k)
                keys.append(k.output_name)
        if computed:
            tdf = self.assign(tdf, computed)
        agg_exprs = list(cols.agg_funcs)
        visible = [c.output_name for c in cols.all_cols]
        extra: Dict[str, ColumnExpr] = {}
        having2: Optional[ColumnExpr] = None
        if having is not None:
            done = {c.alias("").__uuid__(): c.output_name for c in cols.agg_funcs}
            having2 = rewrite_having(having, done, extra)
            agg_exprs += list(extra.values())
        res = self._device_aggregate(tdf, keys, agg_exprs, col_order=visible + list(extra))
        if having2 is None:
            return res
        res = self.filter(res, having2)
        if extra:
            res = TorchDataFrame(
                blocks_with_columns(res.blocks, {n: res.blocks.columns[n] for n in visible}),
                res.schema.extract(visible),
            )
        return res

    def _device_aggregate(
        self,
        tdf: TorchDataFrame,
        keys: List[str],
        agg_cols: List[ColumnExpr],
        col_order: Optional[List[str]] = None,
    ) -> TorchDataFrame:
        """The aggregate of ``_plan_aggregate``, its columns in ``col_order``
        where given (``_try_device_aggregate``'s ``col_order``, ``:2760``)."""
        res = self._plan_aggregate(tdf, keys, agg_cols)
        if col_order is None:
            return res
        return TorchDataFrame(
            blocks_with_columns(res.blocks, {n: res.blocks.columns[n] for n in col_order}),
            res.schema.extract(col_order),
        )

    def _plan_aggregate(
        self, tdf: TorchDataFrame, keys: List[str], agg_cols: List[ColumnExpr]
    ) -> TorchDataFrame:
        """``_try_device_aggregate`` (``:2754``): the plan checks
        (``:2772-2834``), then the keyless aggregate (``_global_aggregate``),
        the binned packed aggregate where the keys have a bin spec and every
        aggregation is packable (``:2836-2864``), else the generic branch
        (``:2866``). What the JAX package sends to its host engine raises
        ``NotImplementedError`` here."""
        blocks = tdf.blocks
        for k in keys:
            assert_or_throw(k in blocks.columns, KeyError(f"{k} not in {tdf.schema}"))
        typed_plans: List[Plan] = []
        distinct_args: Dict[str, str] = {}
        for c in agg_cols:
            assert_or_throw(
                isinstance(c, _FuncExpr) and c.is_aggregation and len(c.args) == 1,
                ValueError(f"{c} is not a one-argument aggregation"),
            )
            fn = c.func.lower()  # type: ignore[attr-defined]
            if fn not in _DEVICE_AGGS:
                self._unported("aggregate", f"aggregation {fn}", _HOST_ENGINE)
            arg = c.args[0]  # type: ignore[attr-defined]
            wildcard = isinstance(arg, _NamedColumnExpr) and arg.wildcard
            if c.arg_distinct and fn not in ("min", "max"):  # type: ignore[attr-defined]
                # min/max DISTINCT are plain min/max; the rest count each
                # (keys, value) once; first/last DISTINCT depend on order
                if fn in ("first", "last") or not isinstance(arg, _NamedColumnExpr) or wildcard:
                    self._unported("aggregate", f"{fn.upper()}(DISTINCT {arg})", _HOST_ENGINE)
                distinct_args[c.output_name] = arg.name
            if wildcard:
                assert_or_throw(fn == "count", ValueError(f"{fn}(*) is invalid"))
                typed_plans.append((c.output_name, "count", None, pa.int64()))
                continue
            self._require_device("aggregate", arg, blocks)
            if fn != "count" and expr_eval.is_string_result(arg, blocks, self._checked):
                # the JAX package aggregates a string only by COUNT on its
                # device (:2229, :2803-2812)
                self._unported("aggregate", f"{fn}({arg}) of a string", _HOST_ENGINE)
            atp = arg.infer_type(tdf.schema)
            tp = c.infer_type(tdf.schema)
            if tp is None or (
                (fn == "median" or fn in VARIANCE_FUNCS) and not _is_numeric(atp)
            ):
                self._unported("aggregate", f"{fn} of {arg} ({atp})", _HOST_ENGINE)
            typed_plans.append((c.output_name, fn, arg, tp))
        if len(keys) == 0:
            return self._global_aggregate(tdf, typed_plans, distinct_args)
        spec = groupby.bin_spec(blocks, keys)
        if spec is not None and all(
            _packed_agg_kind(tdf.schema, func, arg) is not None
            for _, func, arg, _ in typed_plans
        ):
            return self._binned_packed_aggregate(tdf, keys, typed_plans, spec, distinct_args)
        return self._generic_aggregate(tdf, keys, typed_plans, distinct_args)

    def _binned_packed_aggregate(
        self,
        tdf: TorchDataFrame,
        keys: List[str],
        typed_plans: List[Plan],
        spec: groupby.BinSpec,
        distinct_args: Dict[str, str],
    ) -> TorchDataFrame:
        """The group-by hot path (``:3463``): ONE launch of the fused kernel
        reads the key and payload columns, computes segment ids and row
        validity in registers and sums every count/sum/avg payload,
        DISTINCT ones with their first-occurrence masks; keys are decoded
        arithmetically from bin indices. The group count stays a lazy
        device scalar; empty bins are dropped by the result's
        ``row_valid``."""
        blocks = tdf.blocks
        device = blocks.device
        occupancy, agg_cols = self._segment_aggregates(
            tdf, keys, typed_plans, distinct_args, spec.total, groupby.frame_rows(blocks),
            keys=groupby.kernel_keys(spec, blocks),
        )
        occupied = occupancy > 0
        decoded = groupby.decode_bin_keys(
            spec, {k: blocks.columns[k].data.dtype for k in keys}, device
        )
        out_cols: Dict[str, TorchColumn] = {}
        for k in keys:
            kv, km = decoded[k]
            out_cols[k] = blocks.columns[k].with_data(kv, km)
        out_cols.update(agg_cols)
        return TorchDataFrame(
            TorchBlocks(
                None, out_cols, device, row_valid=occupied, nrows_dev=occupied.sum()
            ),
            _result_schema(tdf.schema, keys, typed_plans),
        )

    def _generic_aggregate(
        self,
        tdf: TorchDataFrame,
        keys: List[str],
        typed_plans: List[Plan],
        distinct_args: Dict[str, str],
    ) -> TorchDataFrame:
        """The generic branch (``:2866``, ``_agg_program`` ``:2900``):
        ``groupby.factorize_keys`` (K1 where the keys have a bin spec, else
        the sort path), every aggregation of the plan over its segment ids
        (``groupby.segment_aggs``), and each key gathered at its group's
        first row. On a binned factorization the result keeps every bin,
        with ``row_valid`` = the occupied bins and the group count lazy
        (``:3066-3080``); else it is a prefix frame of ``num_segments``
        rows, in the order of the key codes."""
        blocks = tdf.blocks
        fr = groupby.factorize_keys(blocks, keys)
        num = fr.num_segments
        # with no group at all the kernels read no row
        rows = groupby.frame_rows(blocks) if num > 0 else {"nrows": 0}
        _, agg_cols = self._segment_aggregates(
            tdf, keys, typed_plans, distinct_args, max(num, 1), rows, seg=fr.seg,
            first_idx=fr.first_idx if num > 0 else None,
        )
        self._count_strategy("generic")
        target = padded_len(num) if fr.occupied is None else num
        out_cols: Dict[str, TorchColumn] = {}
        for k in keys:
            src = blocks.columns[k]
            mask = None if src.mask is None else pad_rows(
                src.mask.index_select(0, fr.first_idx), target
            )
            out_cols[k] = src.with_data(
                pad_rows(src.data.index_select(0, fr.first_idx), target), mask)
        out_cols.update(agg_cols)
        schema = _result_schema(tdf.schema, keys, typed_plans)
        if fr.occupied is not None:
            return TorchDataFrame(
                TorchBlocks(None, out_cols, blocks.device, row_valid=fr.occupied,
                            nrows_dev=fr.num_groups_dev),
                schema,
            )
        return TorchDataFrame(TorchBlocks(num, out_cols, blocks.device), schema)

    def _global_aggregate(
        self,
        tdf: TorchDataFrame,
        typed_plans: List[Plan],
        distinct_args: Dict[str, str],
    ) -> TorchDataFrame:
        """Keyless aggregation (``:3311``): one result row, through the same
        kernels and twins as the keyed aggregate over one segment that
        holds every real row (``groupby.segment_aggs``). FIRST/LAST are the
        first/last real row's value, NULL where the frame has no row
        (``:3398-3411``)."""
        blocks = tdf.blocks
        seg = (~blocks.validity()).to(torch.int32)  # 0 on real rows, the sentinel 1 else
        _, agg_cols = self._segment_aggregates(
            tdf, [], typed_plans, distinct_args, 1, groupby.frame_rows(blocks), seg=seg
        )
        self._count_strategy("global")
        return TorchDataFrame(
            TorchBlocks(1, agg_cols, blocks.device),
            _result_schema(tdf.schema, [], typed_plans),
        )

    def _segment_aggregates(
        self,
        tdf: TorchDataFrame,
        group_keys: List[str],
        typed_plans: List[Plan],
        distinct_args: Dict[str, str],
        span: int,
        rows: Dict[str, Any],
        **where: Any,
    ) -> Tuple[torch.Tensor, Dict[str, TorchColumn]]:
        """Every aggregation of ``typed_plans`` in one
        ``groupby.segment_aggs`` call over ``span`` segments (``where``:
        its ``seg``, ``keys`` and ``first_idx``). Returns the rows counted
        per segment and the aggregate columns, one value per segment.

        Payload dedup (``:3520``): SUM(v) and AVG(v) share one payload;
        COUNT(*) and any count of an unmasked column are the segment's row
        count. A DISTINCT aggregation's mask also holds its
        first-occurrence-of-(keys, value) mask, so its payload and count
        are its own."""
        blocks = tdf.blocks
        dmasks = _distinct_masks(blocks, group_keys, distinct_args)
        # every argument at once: the bare columns as they are, the rest in
        # one K6 launch
        args = {a.__uuid__(): a for _, _, a, _ in typed_plans if a is not None}
        evaluated = dict(zip(args, expr_eval.eval_exprs(
            blocks, list(args.values()),
            [_arg_dtype(a.infer_type(tdf.schema)) for a in args.values()], self._programs,
        )))
        requests: List[groupby.AggRequest] = []
        for name, func, arg, _tp in typed_plans:
            if arg is None:
                requests.append(groupby.AggRequest("count", None, None, "", ""))
                continue
            akey = arg.__uuid__()
            values, mask = evaluated[akey]
            # the kernels read dense columns; a transformer may return views
            values = values.contiguous()
            mkey = "" if mask is None else f"m:{akey}"
            mask = None if mask is None else mask.contiguous()
            if name in distinct_args:
                dmask = dmasks[distinct_args[name]]
                mask = dmask if mask is None else mask & dmask
                mkey = "|".join(p for p in (mkey, f"d:{distinct_args[name]}") if p)
            requests.append(groupby.AggRequest(func, values, mask, akey, mkey))
        occupancy, results = groupby.segment_aggs(requests, span, rows, **where)
        self._count_strategy("cuda" if blocks.device.type == "cuda" else "reference")
        out_cols = {
            name: TorchColumn(tp, _cast_agg_result(v, tp), m)
            for (name, _, _, tp), (v, m) in zip(typed_plans, results)
        }
        return occupancy, out_cols

    def _count_strategy(self, name: str) -> None:
        self._strategy_counts[name] = self._strategy_counts.get(name, 0) + 1


def _result_column(tp: pa.DataType, r: expr_eval.Evaluated, blocks: TorchBlocks,
                   c: ColumnExpr) -> TorchColumn:
    """An evaluated column of type ``tp``: a bare column reference keeps
    its column's ``(min, max)`` and dictionary; a computed string its
    dictionary, with the codes' bounds as stats
    (``finalize_string_result``); any other computed column has none."""
    if expr_eval.is_bare(c):
        src = blocks.columns[c.name]
        return TorchColumn(tp, r.values, r.mask, src.stats, dictionary=src.dictionary)
    stats = None if r.dictionary is None else (0, max(len(r.dictionary) - 1, 0))
    return TorchColumn(tp, r.values, r.mask, stats, dictionary=r.dictionary)


def _output_schema(spec: Any, schema: Schema) -> Schema:
    """A transformer's output schema, ``"*"`` standing for the input's
    columns (``"*"`` alone, or among other fields: ``"*,w:double"``)."""
    if isinstance(spec, str) and "*" in spec:
        parts = [p.strip() for p in spec.split(",") if p.strip() != ""]
        return Schema(*[schema if p == "*" else p for p in parts])
    return Schema(spec)


def _arg_dtype(tp: Optional[pa.DataType]) -> Optional[torch.dtype]:
    """An aggregate argument's dtype: its declared type's, or None (the
    type it computes in) where it has no column type."""
    try:
        return None if tp is None else torch_dtype(tp)
    except NotImplementedError:
        return None


def _result_schema(schema: Schema, keys: List[str], typed_plans: List[Plan]) -> Schema:
    """An aggregate's schema: the keys, then one field per aggregation."""
    return Schema(
        [schema[k] for k in keys] + [pa.field(name, tp) for name, _, _, tp in typed_plans]
    )


def _packed_agg_kind(schema: Schema, func: str, arg: Optional[ColumnExpr]) -> Optional[str]:
    """How an aggregation rides the binned packed aggregate (``:3288``):
    ``"count"``, ``"float"`` or ``"int"`` (exact int64 sums) for
    count/sum/avg, else None (min/max/median and the rest, and the
    sum/avg of a bool, take the generic branch)."""
    if func == "count":
        return "count"
    tp = None if arg is None else arg.infer_type(schema)
    if func not in ("sum", "avg", "mean") or tp is None:
        return None
    if pa.types.is_floating(tp):
        return "float"
    if pa.types.is_integer(tp):
        return "int"
    return None


def _is_numeric(tp: Optional[pa.DataType]) -> bool:
    return tp is not None and (
        pa.types.is_integer(tp) or pa.types.is_floating(tp) or pa.types.is_boolean(tp)
    )


def _distinct_masks(
    blocks: TorchBlocks, keys: List[str], distinct_args: Dict[str, str]
) -> Dict[str, torch.Tensor]:
    """Per DISTINCT argument, the first-occurrence mask of each (keys,
    value) over the padded rows (``_distinct_factorize`` and
    ``_apply_distinct_mask``, ``:3749-3776``): the factorization of the
    keys and the argument (``groupby.factorize_keys``, cached on the
    frame), then one K13 launch that sets each occupied segment's first
    row. A row that is not real is no segment's first row, so its flag is
    clear."""
    out: Dict[str, torch.Tensor] = {}
    pad_n = blocks.padded_nrows
    for argname in dict.fromkeys(distinct_args.values()):
        if pad_n == 0:
            out[argname] = torch.zeros((0,), dtype=torch.bool, device=blocks.device)
            continue
        fr = groupby.factorize_keys(blocks, keys + [argname])
        out[argname] = relational.first_rows(fr.first_idx, pad_n, occupied=fr.occupied)[0]
    return out


def _cast_agg_result(v: torch.Tensor, tp: pa.DataType) -> torch.Tensor:
    """``:3821``: an aggregate's values in its result type."""
    return v.to(torch_dtype(tp))
