"""fugue_tpu_torch: the PyTorch/CUDA port of fugue_tpu for an NVIDIA H100.

It imports nothing of ``fugue_tpu`` or of JAX; the JAX package stays
beside it as the reference the port is tested against. The slices ported
so far: ``transform`` of a ``Dict[str, torch.Tensor]`` transformer, with
or without partition keys, then ``aggregate`` with count, sum, avg, min,
max, first, last, median and the variance family (and DISTINCT forms) by
numeric or bool keys or with none. The per-row work is hand-written CUDA
kernels: the fused binned sums (``fugue_tpu_torch/kernels/segment_sums.cu``),
the key factorization (``fugue_tpu_torch/kernels/factorize.cu``) and the
per-segment extrema and squared deviations
(``fugue_tpu_torch/kernels/segment_reduce.cu``); and ``select``,
``filter`` and ``assign`` over the numeric column algebra, each call's
expressions evaluated by one compiled program in one launch of the
expression kernel (``fugue_tpu_torch/kernels/expr_program.cu``); and
``join`` of every type, with hand-written build, probe, expand and gather
kernels (``fugue_tpu_torch/kernels/join.cu``, ``gather.cu``); and string,
timestamp and date columns on the card (dictionary codes, int64
microseconds, int32 days) through all of these, string predicates and
dictionary transforms running as table gathers inside the expression
kernel; and the set operations, ``distinct``, ``dropna``, ``fillna``,
``take``, ``sample`` and ``repartition``, with hand-written presort-word,
rank-keep, first-row and null-count kernels
(``fugue_tpu_torch/kernels/factorize.cu``, ``row_select.cu``); and SQL
SELECT through ``raw_sql`` (the port's tokenizer, parser and algebra
bridge), with ORDER BY/LIMIT, NOT IN (a mode of the join kernels) and
window functions on hand-written window-rank and window-frame kernels
(``fugue_tpu_torch/kernels/window.cu``); and ``zip`` + ``transform``
(co-transform over a shared segment space) with hand-written co-map
presence and row kernels (``fugue_tpu_torch/kernels/comap.cu``), and
``aggregate`` of a stream of frames folded chunk by chunk on the card by
a hand-written stream-fold kernel (``fugue_tpu_torch/kernels/stream.cu``);
and ``load`` and ``save`` of parquet, csv and json files, a parquet load
streamed into pinned slabs on a copy stream (``fugue.torch.io.batch_rows``)
and every export compacted on the card (the gather kernel) and read back
in one wave of copies into pinned memory; and the workflow DAG
(``FugueWorkflow``, ``fugue_tpu_torch/workflow/``), through which
``transform``, ``out_transform`` and ``raw_sql`` run, with the port's own
function wrapper, extensions, tasks, checkpoints and runner.
"""

from fugue_tpu_torch.api import (
    aggregate,
    alter_columns,
    as_array,
    as_array_iterable,
    as_dict_iterable,
    assign,
    distinct,
    drop_columns,
    dropna,
    fillna,
    filter,
    head,
    intersect,
    join,
    load,
    out_transform,
    peek_array,
    peek_dict,
    raw_sql,
    rename,
    repartition,
    sample,
    save,
    select,
    select_columns,
    subtract,
    take,
    transform,
    union,
    zip,
)
from fugue_tpu_torch.column import SelectColumns, col, function, lit, null
from fugue_tpu_torch.column import functions
from fugue_tpu_torch.dataframe import ArrayDataFrame, ArrowDataFrame, DataFrame
from fugue_tpu_torch.dataframe.dataframe_iterable_dataframe import LocalDataFrameIterableDataFrame
from fugue_tpu_torch.execution import make_execution_engine
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from fugue_tpu_torch.torch_backend.execution_engine import TorchExecutionEngine
from fugue_tpu_torch.workflow import FugueWorkflow, WorkflowDataFrame, module

__all__ = [
    "ArrayDataFrame",
    "ArrowDataFrame",
    "DataFrame",
    "FugueWorkflow",
    "LocalDataFrameIterableDataFrame",
    "Schema",
    "SelectColumns",
    "TorchDataFrame",
    "TorchExecutionEngine",
    "WorkflowDataFrame",
    "aggregate",
    "alter_columns",
    "as_array",
    "as_array_iterable",
    "as_dict_iterable",
    "assign",
    "col",
    "distinct",
    "drop_columns",
    "dropna",
    "fillna",
    "filter",
    "function",
    "functions",
    "head",
    "intersect",
    "join",
    "lit",
    "load",
    "make_execution_engine",
    "module",
    "null",
    "out_transform",
    "peek_array",
    "peek_dict",
    "raw_sql",
    "rename",
    "repartition",
    "sample",
    "save",
    "select",
    "select_columns",
    "subtract",
    "take",
    "transform",
    "union",
    "zip",
]
