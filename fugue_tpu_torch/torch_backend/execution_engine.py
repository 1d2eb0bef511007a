"""``TorchExecutionEngine``: the port's engine, on one ``torch.device``.

A port of the main path of ``fugue_tpu/jax_backend/execution_engine.py``:
``to_df``/``persist`` upload a frame; ``TorchMapEngine`` runs a
``Dict[str, torch.Tensor]`` transformer over whole columns; ``aggregate``
runs sum/avg/count by integer keys through the binned packed aggregate,
whose whole per-row part (segment ids, row validity, sums) is one launch
of the fused CUDA kernel.

The engine runs on CUDA unless the caller passes ``device="cpu"``, and
then every kernel runs as its plain PyTorch twin. Paths the port does not
have yet raise ``NotImplementedError`` naming the ROADMAP.md item that
ports them; nothing falls back to a host engine. ``fallbacks`` counts
those refusals by operation, ``strategy_counts`` the segment-sum routes
taken (``"cuda"`` or ``"reference"``).
"""

from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import pandas as pd
import pyarrow as pa
import torch

from fugue_tpu_torch.collections.partition import PartitionSpec
from fugue_tpu_torch.kernels.reference import MAX_KEYS, BinKey, Payload
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
        """``jax_backend/execution_engine.py:95``."""
        engine = self.execution_engine
        if partition_spec is not None and not partition_spec.empty:
            engine._unported(
                "map",
                "a transform with partition keys (it needs the key "
                "factorization groupby._bin_core)",
                "ROADMAP.md queue 2 item 2",
            )
        return self._compiled_map(engine.to_df(df), map_func, Schema(output_schema))

    def _compiled_map(
        self,
        df: TorchDataFrame,
        fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
        output_schema: Schema,
    ) -> TorchDataFrame:
        """Whole-column execution (``jax_backend/execution_engine.py:177``).

        The transformer ABI, as in the JAX package:

        - each column ``name`` is a tensor over the padded rows, with
          ``_<name>_mask`` (True = valid) beside it when it has nulls;
        - ``_row_valid`` bool[padded]: True = real row, built on first
          access only (XLA drops it from a program that never reads it);
        - ``_nrows``: the true row count as a 0-d int32 device tensor;
        - output columns of the input's padded length are row-aligned with
          it; to change the row count, return ``_nrows`` too (one readback).

        An output that IS an input column's tensor (passthrough) keeps that
        column's null mask and ``(min, max)`` stats, so a key passed
        through a transform still bins with no readback."""
        blocks = df.blocks
        device = blocks.device
        pad_n = blocks.padded_nrows
        args: Dict[str, torch.Tensor] = {}
        for name, col in blocks.columns.items():
            args[name] = col.data
            if col.mask is not None:
                args[f"_{name}_mask"] = col.mask
        args["_nrows"] = blocks.nrows_tensor()
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
    """A transformer's input dict: the columns, their masks and ``_nrows``
    as given, and ``_row_valid`` built from the frame the first time the
    transformer reads it."""

    def __init__(self, cols: Dict[str, torch.Tensor], blocks: TorchBlocks):
        self._cols = cols
        self._blocks = blocks

    def __getitem__(self, key: str) -> torch.Tensor:
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
        """The binned branch of ``_try_device_aggregate`` (``:2754``,
        ``:2835-2864``); every other branch is refused."""
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
            self._unported(
                "aggregate",
                "group-by on keys with no bin spec (float keys, or more than "
                f"{groupby._MAX_BINS} bins)",
                "ROADMAP.md queue 2 item 5 (sort factorization)",
            )
        return self._binned_packed_aggregate(tdf, keys, typed_plans, spec)  # type: ignore

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
        pad_n = blocks.padded_nrows
        key_data = {k: blocks.columns[k].data for k in keys}
        key_masks = {k: blocks.columns[k].mask for k in keys}
        bkeys = groupby.bin_keys(spec, key_data, key_masks)
        if len(bkeys) > MAX_KEYS:
            # more keys than the kernel reads: their segment ids, with the
            # invalid rows' sentinel, are its one key
            seg = groupby.inline_seg(spec, key_data, key_masks, blocks.validity())
            bkeys = [BinKey(seg, None, 0, spec.total)]
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
        rows: Dict[str, Any] = (
            {"nrows": blocks.nrows} if blocks.row_valid is None
            else {"row_valid": blocks.row_valid}
        )
        f_sums, c_sums, i_sums = groupby.binned_sums(
            bkeys, floats=floats, counts=counts, ints=ints, **rows
        )
        self._count_strategy("cuda" if device.type == "cuda" else "reference")
        occupied = c_sums[0] > 0
        decoded = groupby.decode_bin_keys(
            spec, {k: blocks.columns[k].data.dtype for k in keys}, device
        )
        out_cols: Dict[str, TorchColumn] = {}
        fields: List[pa.Field] = []
        for k in keys:
            kv, km = decoded[k]
            src = blocks.columns[k]
            out_cols[k] = TorchColumn(src.pa_type, kv, km, src.stats)
            fields.append(tdf.schema[k])
        for (name, func, _arg, tp), (kind, idx) in zip(typed_plans, slots):
            fields.append(pa.field(name, tp))
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
        return TorchDataFrame(
            TorchBlocks(
                None, out_cols, device, row_valid=occupied, nrows_dev=occupied.sum()
            ),
            Schema(fields),
        )

    def _count_strategy(self, name: str) -> None:
        self._strategy_counts[name] = self._strategy_counts.get(name, 0) + 1


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
