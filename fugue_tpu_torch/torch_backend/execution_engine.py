"""``TorchExecutionEngine``: the port's engine, on one ``torch.device``.

A port of the main path of ``fugue_tpu/jax_backend/execution_engine.py``:
``to_df``/``persist`` upload a frame; ``TorchMapEngine`` runs a
``Dict[str, torch.Tensor]`` transformer over whole columns, with the
segment ids of its partition keys when it has some; ``aggregate`` runs
sum/avg/count by keys: keys with a bin spec through the binned packed
aggregate, whose whole per-row part (segment ids, row validity, sums) is
one launch of the fused CUDA kernel, and any other numeric or bool keys
through the sort factorization and the same kernel over its segment ids.

The engine runs on CUDA unless the caller passes ``device="cpu"``, and
then every kernel runs as its plain PyTorch twin. Paths the port does not
have yet raise ``NotImplementedError`` naming the ROADMAP.md item that
ports them; nothing falls back to a host engine. ``fallbacks`` counts
those refusals by operation, ``strategy_counts`` the segment-sum routes
taken (``"cuda"`` or ``"reference"``) and the aggregates that took the
generic (factorized) branch (``"generic"``).
"""

from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import pandas as pd
import pyarrow as pa
import torch

from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.kernels.reference import BinKey, Payload
from fugue_tpu_torch.column.expressions import (
    ColumnExpr,
    _FuncExpr,
    _NamedColumnExpr,
)
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend import expr_eval, groupby
from fugue_tpu_torch.torch_backend.blocks import (
    TorchBlocks,
    TorchColumn,
    from_arrow,
    is_integer_like,
    padded_len,
    torch_dtype,
)
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from fugue_tpu_torch.utils.assertion import assert_or_throw

_PACKED_AGGS = ("sum", "avg", "mean", "count")


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
        """``jax_backend/execution_engine.py:95``. A partition key of
        string type never gets here: ``to_df`` refuses string columns
        (ROADMAP.md queue 1 item 1)."""
        tdf = self.execution_engine.to_df(df)
        keys = [] if partition_spec is None else partition_spec.partition_by
        for k in keys:
            assert_or_throw(k in tdf.blocks.columns, KeyError(f"{k} not in {tdf.schema}"))
        return self._compiled_map(tdf, map_func, Schema(output_schema), keys)

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
          ``_<name>_mask`` (True = valid) beside it when it has nulls;
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
          it; to change the row count, return ``_nrows`` too (one readback).

        An output that IS an input column's tensor (passthrough) keeps that
        column's null mask and ``(min, max)`` stats, so a key passed
        through a transform still bins with no readback."""
        blocks = df.blocks
        device = blocks.device
        pad_n = blocks.padded_nrows
        args: Dict[str, Any] = {}
        for name, col in blocks.columns.items():
            args[name] = col.data
            if col.mask is not None:
                args[f"_{name}_mask"] = col.mask
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
            stats = src.stats if src is not None and is_integer_like(f.type) else None
            cols[f.name] = TorchColumn(
                f.type,
                _pad_to(data, target),
                None if mask is None else _pad_to(mask.to(device), target),
                stats,
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

    @property
    def strategy_counts(self) -> Dict[str, int]:
        """Segment-sum launches by route (``:909``)."""
        return dict(self._strategy_counts)

    @property
    def fallbacks(self) -> Dict[str, int]:
        """Refused (not yet ported) requests by operation (``:772``)."""
        return dict(self._fallbacks)

    def _unported(self, op: str, what: str, roadmap: str) -> None:
        self._fallbacks[op] = self._fallbacks.get(op, 0) + 1
        raise NotImplementedError(
            f"{what} is not ported to the torch engine yet; see {roadmap}"
        )

    def to_df(self, df: Any) -> TorchDataFrame:
        """pandas, arrow or a frame on this device -> ``TorchDataFrame``,
        uploaded now (``:1297``)."""
        if isinstance(df, TorchDataFrame):
            assert_or_throw(
                df.device == self.device,
                ValueError(f"frame is on {df.device}, engine on {self.device}"),
            )
            return df
        if isinstance(df, pd.DataFrame):
            table = pa.Table.from_pandas(df, preserve_index=False)
        elif isinstance(df, pa.Table):
            table = df
        else:
            raise ValueError(f"can't convert {type(df)} to a TorchDataFrame")
        schema = Schema(table.schema)
        return TorchDataFrame(from_arrow(table, schema, self.device), schema)

    def persist(self, df: Any) -> TorchDataFrame:
        """``to_df``, then wait until the upload is on the card (``:1576``)."""
        res = self.to_df(df)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return res

    def aggregate(
        self,
        df: Any,
        partition_spec: Optional[PartitionSpec],
        agg_cols: List[ColumnExpr],
    ) -> TorchDataFrame:
        """``:1498``."""
        keys = partition_spec.partition_by if partition_spec is not None else []
        return self._device_aggregate(self.to_df(df), keys, agg_cols)

    def _device_aggregate(
        self, tdf: TorchDataFrame, keys: List[str], agg_cols: List[ColumnExpr]
    ) -> TorchDataFrame:
        """``_try_device_aggregate`` (``:2754``) for sum/avg/count: the
        binned branch (``:2835-2864``) where the keys have a bin spec, else
        the generic branch (``:2866``); every other aggregation is
        refused."""
        blocks = tdf.blocks
        for k in keys:
            assert_or_throw(k in blocks.columns, KeyError(f"{k} not in {tdf.schema}"))
        typed_plans: List[Tuple[str, str, Optional[ColumnExpr], pa.DataType]] = []
        for c in agg_cols:
            assert_or_throw(
                isinstance(c, _FuncExpr) and c.is_aggregation and len(c.args) == 1,
                ValueError(f"{c} is not a one-argument aggregation"),
            )
            fn = c.func.lower()  # type: ignore[attr-defined]
            if fn not in _PACKED_AGGS:
                self._unported(
                    "aggregate", f"aggregation {fn}",
                    "ROADMAP.md queue 2 item 6 (_segment_agg_impl)",
                )
            if c.arg_distinct:  # type: ignore[attr-defined]
                self._unported(
                    "aggregate", "DISTINCT aggregation", "ROADMAP.md queue 1 item 3"
                )
            arg = c.args[0]  # type: ignore[attr-defined]
            if isinstance(arg, _NamedColumnExpr) and arg.wildcard:
                assert_or_throw(fn == "count", ValueError(f"{fn}(*) is invalid"))
                typed_plans.append((c.output_name, "count", None, pa.int64()))
                continue
            if not expr_eval.can_eval_on_device(arg, blocks):
                self._unported(
                    "aggregate", f"expression {arg}",
                    "ROADMAP.md queue 2 item 8 (expr_eval._eval)",
                )
            if fn != "count" and _packed_agg_kind(tdf.schema, arg) is None:
                self._unported(
                    "aggregate", f"{fn} of {arg} (not a float or integer column)",
                    "ROADMAP.md queue 2 item 7 (_agg_program)",
                )
            typed_plans.append((c.output_name, fn, arg, c.infer_type(tdf.schema)))
        if len(keys) == 0:
            self._unported(
                "aggregate", "an aggregate with no keys",
                "ROADMAP.md queue 2 item 7 (_global_aggregate)",
            )
        spec = groupby.bin_spec(blocks, keys)
        if spec is None:
            return self._generic_aggregate(tdf, keys, typed_plans)
        return self._binned_packed_aggregate(tdf, keys, typed_plans, spec)

    def _binned_packed_aggregate(
        self,
        tdf: TorchDataFrame,
        keys: List[str],
        typed_plans: List[Tuple[str, str, Optional[ColumnExpr], pa.DataType]],
        spec: groupby.BinSpec,
    ) -> TorchDataFrame:
        """The group-by hot path (``:3463``): ONE launch of the fused kernel
        reads the key and payload columns, computes segment ids and row
        validity in registers and sums every sum/avg/count payload; keys
        are decoded arithmetically from bin indices. The group count stays
        a lazy device scalar; empty bins are dropped by the result's
        ``row_valid``."""
        blocks = tdf.blocks
        device = blocks.device
        occupancy, agg_cols = self._packed_sums(
            tdf, typed_plans, groupby.kernel_keys(spec, blocks), groupby.frame_rows(blocks)
        )
        occupied = occupancy > 0
        decoded = groupby.decode_bin_keys(
            spec, {k: blocks.columns[k].data.dtype for k in keys}, device
        )
        out_cols: Dict[str, TorchColumn] = {}
        for k in keys:
            kv, km = decoded[k]
            src = blocks.columns[k]
            out_cols[k] = TorchColumn(src.pa_type, kv, km, src.stats)
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
        typed_plans: List[Tuple[str, str, Optional[ColumnExpr], pa.DataType]],
    ) -> TorchDataFrame:
        """The generic branch (``:2866``, ``_agg_program`` ``:2900``) for
        sum/avg/count: ``groupby.factorize_keys`` (the sort path, since the
        keys have no bin spec), the fused kernel over its segment ids as
        the one key of span ``num_segments`` (the sentinel rows fall
        outside it and are dropped), and each key gathered at its group's
        first row. The result is a prefix frame of ``num_segments`` rows,
        in the order of the key codes."""
        blocks = tdf.blocks
        fr = groupby.factorize_keys(blocks, keys)
        num = fr.num_segments
        # with no group at all the kernel reads no row of a one-bin key
        rows = {"nrows": blocks.padded_nrows if num > 0 else 0}
        _, agg_cols = self._packed_sums(
            tdf, typed_plans, [BinKey(fr.seg, None, 0, max(num, 1))], rows
        )
        self._count_strategy("generic")
        target = padded_len(num)
        out_cols: Dict[str, TorchColumn] = {}
        for k in keys:
            src = blocks.columns[k]
            mask = None if src.mask is None else _pad_to(
                src.mask.index_select(0, fr.first_idx), target
            )
            out_cols[k] = TorchColumn(
                src.pa_type, _pad_to(src.data.index_select(0, fr.first_idx), target),
                mask, src.stats,
            )
        out_cols.update(agg_cols)
        return TorchDataFrame(
            TorchBlocks(num, out_cols, blocks.device),
            _result_schema(tdf.schema, keys, typed_plans),
        )

    def _packed_sums(
        self,
        tdf: TorchDataFrame,
        typed_plans: List[Tuple[str, str, Optional[ColumnExpr], pa.DataType]],
        bkeys: List[BinKey],
        rows: Dict[str, Any],
    ) -> Tuple[torch.Tensor, Dict[str, TorchColumn]]:
        """Every sum/avg/count of ``typed_plans`` by ``bkeys`` in one
        ``groupby.binned_sums`` call. Returns the rows counted per segment
        and the aggregate columns, one value per segment."""
        blocks = tdf.blocks
        device = blocks.device
        pad_n = blocks.padded_nrows
        mcols = expr_eval.blocks_to_masked(blocks)
        floats: List[Payload] = []
        counts: List[torch.Tensor] = []
        ints: List[Payload] = []
        # payload dedup: SUM(v)+AVG(v) share one float payload; COUNT(*)
        # and any unmasked count ARE the occupancy row (count slot 0),
        # which the kernel counts from the rows it accepts
        fkeys: Dict[str, int] = {}
        ckeys: Dict[str, int] = {"__valid__": 0}
        ikeys: Dict[str, int] = {}

        def _slot(keys_: Dict[str, int], pays: List[Any], key: str, item: Any,
                  base: int = 0) -> int:
            if key not in keys_:
                pays.append(item)
                keys_[key] = base + len(pays) - 1
            return keys_[key]

        slots: List[Tuple[str, Any]] = []
        for name, func, arg, _tp in typed_plans:
            if arg is None:
                slots.append(("c", 0))  # COUNT(*) == occupancy
                continue
            akey = arg.__uuid__()
            values, mask = expr_eval.eval_expr(mcols, arg, pad_n, device)
            # the kernel reads dense columns; a transformer may return views
            values = values.contiguous()
            mask = None if mask is None else mask.contiguous()
            eff_key = "__valid__" if mask is None else f"m:{akey}"
            ci = 0 if mask is None else _slot(ckeys, counts, eff_key, mask, base=1)
            if func == "count":
                slots.append(("c", ci))
                continue
            # the kernel adds a masked payload only where its mask holds
            pkey = f"{akey}|{eff_key}"
            if _packed_agg_kind(tdf.schema, arg) == "int":
                slots.append(("i", (_slot(ikeys, ints, pkey, (values, mask)), ci)))
            else:
                slots.append(("f", (_slot(fkeys, floats, pkey, (values, mask)), ci)))
        f_sums, c_sums, i_sums = groupby.binned_sums(
            bkeys, floats=floats, counts=counts, ints=ints, **rows
        )
        self._count_strategy("cuda" if device.type == "cuda" else "reference")
        out_cols: Dict[str, TorchColumn] = {}
        for (name, func, _arg, tp), (kind, idx) in zip(typed_plans, slots):
            if kind == "c":
                out_cols[name] = TorchColumn(tp, _cast_agg_result(c_sums[idx], tp))
                continue
            si, ci = idx
            tot = i_sums[si] if kind == "i" else f_sums[si]
            cnt = c_sums[ci]
            if func == "sum":
                v = tot
            else:  # avg/mean; integer sums divide in float64 as in the JAX package
                v = (tot.to(torch.float64) if kind == "i" else tot) / torch.clamp(cnt, min=1)
            out_cols[name] = TorchColumn(tp, _cast_agg_result(v, tp), cnt > 0)
        return c_sums[0], out_cols

    def _count_strategy(self, name: str) -> None:
        self._strategy_counts[name] = self._strategy_counts.get(name, 0) + 1


def _result_schema(
    schema: Schema,
    keys: List[str],
    typed_plans: List[Tuple[str, str, Optional[ColumnExpr], pa.DataType]],
) -> Schema:
    """An aggregate's schema: the keys, then one field per aggregation."""
    return Schema(
        [schema[k] for k in keys] + [pa.field(name, tp) for name, _, _, tp in typed_plans]
    )


def _packed_agg_kind(schema: Schema, arg: ColumnExpr) -> Optional[str]:
    """How a sum/avg payload rides the packed kernel (``:3288``):
    ``"float"``, ``"int"`` (exact int64 sums) or None."""
    tp = arg.infer_type(schema)
    if tp is None:
        return None
    if pa.types.is_floating(tp):
        return "float"
    if pa.types.is_integer(tp):
        return "int"
    return None


def _pad_to(v: torch.Tensor, target: int) -> torch.Tensor:
    """``:3814``: zero-pad the row axis to ``target``."""
    n = int(v.shape[0])
    if n == target:
        return v
    return torch.cat([v, torch.zeros((target - n,), dtype=v.dtype, device=v.device)])


def _cast_agg_result(v: torch.Tensor, tp: pa.DataType) -> torch.Tensor:
    """``:3821``: an aggregate's values in its result type."""
    return v.to(torch_dtype(tp))
