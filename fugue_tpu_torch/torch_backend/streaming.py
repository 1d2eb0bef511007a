"""Streaming aggregation: a group-by over a stream of host chunks, folded
chunk by chunk into accumulators on the card (port of
``fugue_tpu/jax_backend/streaming.py:77-689``).

- The input is a ``LocalDataFrameIterableDataFrame``; its chunks never
  need to be on the card together, so the frame may be larger than the
  card's memory.
- Per-group accumulators (count, sum, min, max a plan, and each plan's
  count of valid values) live on the engine's device in one int64 store,
  slot-major (a float64 accumulator's column holds its bits, a float
  extremum its order key). Each chunk's keys, payloads and validity are
  written once into pinned slabs (two a kind, alternating from chunk to
  chunk, ``ingest._Stager``) and shipped by non-blocking copies on a copy
  stream, which the fold waits for on the card; then one launch of K19
  ``stream_fold`` folds every plan (its twin on the CPU, where the rows
  are written straight into the tensors): peak residency is the
  accumulators plus a chunk, whatever the row count.
- Group keys bin by the mixed radix of ``_Space`` (integer and bool keys,
  at most ``_MAX_BINS`` slots). When a chunk's keys leave the current
  space, the accumulators are re-based onto the wider one on the card
  (``_rebase``: one ``index_copy_``). ``pad_spans`` rounds each span up to
  a power of two, so moderate growth lands inside the space.
- Accumulators follow the source columns (int64 sums and extrema stay
  exact int64; floats accumulate in float64; each starts from
  ``reference.fold_init``, which takes the place of the JAX package's
  ``_acc_dtype`` and ``_type_extreme``), and a group whose values are all
  null finalizes to NULL, as the bounded aggregate does.
- What the bounded path's semantics cannot stream (NULL keys, a key space
  beyond ``_MAX_BINS``, more keys, payloads or accumulators than K19's
  parameters hold, an empty stream) raises ``StreamUnsupported``;
  ``stream_aggregate`` turns it into ``StreamFallback`` carrying the
  consumed chunks and the rest, and the engine materializes and runs its
  bounded aggregate, so the answer never depends on the container.

The JAX package pads each chunk to a power-of-two bucket only to bound
XLA's retraces; the port has no trace, folds exactly a chunk's rows, and
its ``stats()`` keep ``traces`` and ``programs`` at 0. ``snapshot``,
``from_snapshot`` and ``evict_leading_below`` serve the standing pipeline
(``fugue_tpu/stream/pipeline.py``) and wait for ROADMAP.md queue 1 item
13; the memory governor's ``pre_alloc`` waits for item 10."""

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc
import torch

from fugue_tpu_torch.dataframe.dataframe_iterable_dataframe import chunk_table
from fugue_tpu_torch.kernels import kernel_for
from fugue_tpu_torch.kernels.reference import (
    FoldOp,
    Payload,
    _from_order_key,
    fold_init,
    stream_fold_reference,
)
from fugue_tpu_torch.kernels.stream import MAX_KEYS, MAX_OPS, MAX_PAYLOADS, stream_fold_cuda
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend.blocks import (
    TorchBlocks,
    TorchColumn,
    storage_scalar,
    to_storage,
    torch_dtype,
)
from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from fugue_tpu_torch.torch_backend.groupby import _MAX_BINS
from fugue_tpu_torch.torch_backend.ingest import _Stager
from fugue_tpu_torch.utils.assertion import assert_or_throw

_SUPPORTED = ("sum", "count", "min", "max", "avg", "mean")
Plan = Tuple[str, str, str]  # (output name, function, source column)


class StreamUnsupported(Exception):
    """This chunk cannot stream under the bounded path's semantics (NULL
    group keys, a key space beyond the bin cap, ...)."""


class StreamFallback(Exception):
    """Streaming cannot honor the bounded path's semantics for this input:
    the caller materializes ``consumed + rest`` and runs the bounded
    aggregate."""

    def __init__(self, reason: str, consumed: List[Any], rest: Iterator[Any]):
        super().__init__(reason)
        self.consumed = consumed
        self.rest = rest


class _Space:
    """The current mixed-radix key space: per key its ``(lo, hi)``."""

    def __init__(self, bounds: List[Tuple[int, int]]):
        self.bounds = bounds

    @property
    def total(self) -> int:
        t = 1
        for lo, hi in self.bounds:
            t *= hi - lo + 1
        return t

    @property
    def spans(self) -> List[Tuple[int, int]]:
        """Per key ``(lo, span)``, as K19 takes them."""
        return [(lo, hi - lo + 1) for lo, hi in self.bounds]

    def contains(self, other: List[Tuple[int, int]]) -> bool:
        return all(lo <= olo and ohi <= hi
                   for (lo, hi), (olo, ohi) in zip(self.bounds, other))

    def union(self, other: List[Tuple[int, int]]) -> "_Space":
        return _Space([(min(lo, olo), max(hi, ohi))
                       for (lo, hi), (olo, ohi) in zip(self.bounds, other)])

    def seg(self, cols: List[torch.Tensor]) -> torch.Tensor:
        """Each row's slot (int64), the first key most significant."""
        combined = torch.zeros_like(cols[0], dtype=torch.int64)
        for (lo, hi), c in zip(self.bounds, cols):
            combined = combined * (hi - lo + 1) + (c.to(torch.int64) - lo)
        return combined

    def decode(self, idx: torch.Tensor) -> List[torch.Tensor]:
        """Each key's values at the slots ``idx``."""
        out: List[torch.Tensor] = []
        stride = self.total
        for lo, hi in self.bounds:
            stride //= hi - lo + 1
            out.append((idx // stride) % (hi - lo + 1) + lo)
        return out


def _pad_bounds(bounds: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Every key span rounded up to a power of two, anchored at ``lo``:
    growth inside the padded span needs no rebase. Padding slots never
    emit (``finalize`` keeps occupied groups only)."""
    out: List[Tuple[int, int]] = []
    for lo, hi in bounds:
        p = 1
        while p < hi - lo + 1:
            p <<= 1
        out.append((lo, lo + p - 1))
    return out


class StreamingAggregator:
    """Per-group accumulators on the card, fed chunk by chunk. ``plans``
    are ``(out_name, func, src_col)`` with ``func`` in ``_SUPPORTED``.

    The accumulators are the columns of one int64 store [slots, A]; each
    has a name as in the JAX package (``_count``, ``s:``, ``c:``, ``m:``
    and the plan's name) and the ``FoldOp`` K19 applies to it."""

    def __init__(self, engine: Any, schema: Schema, keys: List[str], plans: List[Plan],
                 pad_spans: bool = False):
        for _, func, _ in plans:
            assert_or_throw(func in _SUPPORTED,
                            NotImplementedError(f"streaming aggregation {func}"))
        # a uint64 payload streams as its int64 bits: its sum and count are
        # the bounded aggregate's (the sum wraps as there), its order and
        # mean are not
        self._unsigned_order = [f"{func}({src})" for _, func, src in plans
                                if schema[src].type == pa.uint64() and func not in ("sum", "count")]
        self._engine = engine
        self._schema = schema
        self._keys = list(keys)
        self._plans = [tuple(p) for p in plans]
        self._pad_spans = pad_spans
        self._src_types: Dict[str, pa.DataType] = {src: schema[src].type for _, _, src in plans}
        self._payloads = sorted(self._src_types)
        self._rows: Dict[str, int] = {}
        self._ops: List[FoldOp] = []
        self._layout()
        self._space: Optional[_Space] = None
        self._store: Optional[torch.Tensor] = None
        self.rebases = 0
        self.chunks_folded = 0
        self.rows_folded = 0
        # the pinned upload of the chunks' values and validity
        self._stagers: List[Optional[_Stager]] = [None, None]
        self._copy_stream: Optional[Any] = None

    def _layout(self) -> None:
        """Each accumulator's store column and op, every op of a payload
        next to the others (``_make_init``'s accumulators, ``:233-256``)."""
        def add(name: str, kind: str, src: Optional[str]) -> None:
            self._rows[name] = len(self._rows)
            payload = -1 if src is None else self._payloads.index(src)
            self._ops.append(FoldOp(kind, payload, self._rows[name]))

        add("_count", "rows", None)
        for src in self._payloads:
            flt = pa.types.is_floating(self._src_types[src])
            for name, func, s in self._plans:
                if s != src:
                    continue
                if func in ("sum", "avg", "mean"):
                    add(f"s:{name}", "sum_i" if func == "sum" and not flt
                        else ("sum_f" if flt else "sum_if"), src)
                elif func in ("min", "max"):
                    add(f"m:{name}", f"{func}_{'f' if flt else 'i'}", src)
                add(f"c:{name}", "count", src)

    # ---- observability ---------------------------------------------------
    @property
    def empty(self) -> bool:
        return self._space is None

    @property
    def num_groups_bound(self) -> int:
        """Allocated accumulator slots (occupied groups <= this)."""
        return 0 if self._space is None else self._space.total

    def stats(self) -> Dict[str, int]:
        """``traces`` and ``programs`` count XLA traces and compiled update
        programs in the JAX package; the port compiles none, so they are
        0."""
        return {"traces": 0, "programs": 0, "rebases": self.rebases,
                "chunks": self.chunks_folded, "rows": self.rows_folded,
                "group_slots": self.num_groups_bound}

    # ---- accumulators ------------------------------------------------------
    def _make_init(self, total: int) -> torch.Tensor:
        """A fresh store of ``total`` slots, each accumulator at its op's
        start value (``fold_init``)."""
        store = torch.empty((total, len(self._ops)), dtype=torch.int64,
                            device=self._engine.device)
        for j, op in enumerate(self._ops):  # fills on the card: no copy from the host
            store[:, j].fill_(fold_init(op.kind))
        return store

    def _rebase(self, old_space: _Space, new_space: _Space, store: torch.Tensor
                ) -> torch.Tensor:
        """The old accumulators scattered into the widened slot space
        (``:352``): one ``index_copy_`` of every slot's accumulators."""
        old_idx = torch.arange(old_space.total, dtype=torch.int64, device=store.device)
        new_seg = new_space.seg(old_space.decode(old_idx))
        fresh = self._make_init(new_space.total)
        fresh.index_copy_(0, new_seg, store)
        self.rebases += 1
        return fresh

    # ---- folding ---------------------------------------------------------
    def host_arrays(self, chunk: Any, out: Optional[Tuple[np.ndarray, np.ndarray]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """A chunk's keys and payloads as one int64 array ``[keys +
        payloads, n]`` (a float payload's float64 bits, a uint64 key's
        word with its sign bit flipped as its column stores it, a uint64
        payload's int64 bits) and the payloads' validity ``[payloads, n]``,
        written into ``out`` where given (the pinned slabs the chunk ships
        from), read through arrow with no pass through pandas
        (``blocks.from_arrow``'s way: ``fill_null``, then ``to_numpy``), so
        an int64 is exact whatever its nulls; a float's NaN is invalid, its
        slot 0 (``:421-450``). A pandas chunk is typed by the stream's
        schema first. Raises ``StreamUnsupported`` for a NULL key or a
        payload that is not a number or a bool."""
        table = chunk_table(chunk, self._schema)
        n = table.num_rows
        if out is None:
            out = (np.empty((len(self._keys) + len(self._payloads), n), dtype=np.int64),
                   np.empty((len(self._payloads), n), dtype=np.bool_))
        values, valids = out
        for j, k in enumerate(self._keys):
            col = table.column(k)
            if col.null_count > 0:
                raise StreamUnsupported("NULL group keys")
            values[j] = to_storage(col.to_numpy(), col.type)
        for j, c in enumerate(self._payloads):
            values[len(self._keys) + j], valids[j] = _payload(table.column(c),
                                                               self._src_types[c])
        return values, valids

    def _staged(self, k: int, shape: Tuple[int, int], dtype: torch.dtype) -> Any:
        """Stager ``k`` (0: the values, 1: the validity), retargeted to a
        new device tensor of ``shape``: its pinned slabs alternate from
        chunk to chunk on one copy stream (``ingest._Stager``), made anew
        only where a chunk outgrows them; on the CPU it writes the tensor
        itself."""
        device = self._engine.device
        rows = shape[0] * shape[1]
        st = self._stagers[k]
        if st is None or (st.stream is not None and int(st.slabs[0].shape[0]) < rows):
            if self._copy_stream is None and device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(device)
            st = self._stagers[k] = _Stager(rows, dtype, device, rows, self._copy_stream)
        else:
            st.retarget(torch.empty((rows,), dtype=dtype, device=device))
        return st

    def fold(self, chunk: Any) -> int:
        """Fold one host chunk (an arrow table or a pandas frame of the
        stream's schema) into the accumulators; returns its row count. An
        empty chunk is a no-op. Raises ``StreamUnsupported`` where the
        bounded path's semantics cannot be honored. The chunk's keys,
        payloads and masks (``host_arrays``) are written once into pinned
        slabs and shipped on a copy stream (``_staged``); the fold waits
        for the copies on the card, the host does not."""
        n = len(chunk)
        if n == 0:
            return 0
        if self._unsigned_order:
            raise StreamUnsupported(f"{self._unsigned_order[0]} of a uint64 payload")
        if (len(self._keys) > MAX_KEYS or len(self._payloads) > MAX_PAYLOADS
                or len(self._ops) > MAX_OPS):
            raise StreamUnsupported("more keys, payloads or accumulators than one fold takes")
        nk, npay = len(self._keys), len(self._payloads)
        table = chunk_table(chunk, self._schema)
        # the keys' stored bounds first, so a rebase's stores and the
        # chunk's rows are never on the card together
        cb = [_key_bounds(table.column(k)) for k in self._keys]
        space = self._space
        if space is not None and space.contains(cb):
            cand = space
        else:
            raw = cb if space is None else space.union(cb).bounds
            cand = _Space(_pad_bounds(raw) if self._pad_spans else raw)
            if self._pad_spans and cand.total > _MAX_BINS and _Space(raw).total <= _MAX_BINS:
                cand = _Space(list(raw))  # the padding overflowed: an exact fit
        if cand.total > _MAX_BINS:
            raise StreamUnsupported("key space too large")
        if space is None:
            self._store = self._make_init(cand.total)
        elif cand is not space:
            self._store = self._rebase(space, cand, self._store)  # type: ignore[arg-type]
        self._space = cand
        vs = self._staged(0, (nk + npay, n), torch.int64)
        ms = self._staged(1, (npay, n), torch.bool)
        self.host_arrays(table, (vs.reserve((nk + npay) * n).reshape(nk + npay, n),
                                 ms.reserve(npay * n).reshape(npay, n)))
        vs.advance((nk + npay) * n)
        ms.advance(npay * n)
        dev = vs.finish().view(nk + npay, n)
        masks = ms.finish().view(npay, n)
        if self._copy_stream is not None:
            torch.cuda.current_stream(dev.device).wait_stream(self._copy_stream)
        payloads: List[Payload] = []
        for j, c in enumerate(self._payloads):
            v = dev[nk + j]
            if pa.types.is_floating(self._src_types[c]):
                v = v.view(torch.float64)
            payloads.append((v, masks[j]))
        run = kernel_for(dev, stream_fold_cuda, stream_fold_reference, "stream fold")
        run(list(dev[:nk]), cand.spans, payloads, self._ops, self._store)
        self.chunks_folded += 1
        self.rows_folded += n
        return n

    # ---- finalize --------------------------------------------------------
    def finalize(self) -> Optional[TorchDataFrame]:
        """The current state as a frame of ``keys + [out names]`` on the
        card (occupied groups only, in slot order; an all-null group's value
        is NULL), non-destructively; None before any fold. One readback:
        the number of occupied groups."""
        if self._space is None:
            return None
        store = self._store
        acc = {name: store[:, j] for name, j in self._rows.items()}  # type: ignore[index]
        occupied = torch.nonzero(acc["_count"] > 0).squeeze(1)
        n = int(occupied.shape[0])
        device = occupied.device
        cols: Dict[str, TorchColumn] = {}
        fields = []
        for k, kv, (lo, hi) in zip(self._keys, self._space.decode(occupied), self._space.bounds):
            field = self._schema[k]
            cols[k] = TorchColumn(field.type, kv.to(torch_dtype(field.type)), None, (lo, hi))
            fields.append(field)
        for name, func, src in self._plans:
            flt = pa.types.is_floating(self._src_types[src])
            cnt = acc[f"c:{name}"].index_select(0, occupied)
            if func == "count":
                vals, tp = cnt, pa.int64()
            elif func in ("avg", "mean"):
                s = acc[f"s:{name}"].view(torch.float64).index_select(0, occupied)
                vals, tp = s / cnt.clamp(min=1).to(torch.float64), pa.float64()
            elif func == "sum":
                s = acc[f"s:{name}"].index_select(0, occupied)
                vals, tp = (s.view(torch.float64), pa.float64()) if flt else (s, pa.int64())
            else:
                m = acc[f"m:{name}"].index_select(0, occupied)
                vals, tp = (_from_order_key(m, torch.float64), pa.float64()) if flt \
                    else (m, pa.int64())
            mask = None if func == "count" else cnt > 0  # an all-null group is NULL
            if mask is not None:
                vals = torch.where(mask, vals, torch.zeros_like(vals))
            cols[name] = TorchColumn(tp, vals, mask)
            fields.append(pa.field(name, tp))
        if n == 0:  # keep one padding row, as every frame does
            cols = {k: c.with_data(torch.zeros((1,), dtype=c.data.dtype, device=device),
                                   None if c.mask is None else
                                   torch.zeros((1,), dtype=torch.bool, device=device))
                    for k, c in cols.items()}
        return TorchDataFrame(TorchBlocks(n, cols, device), Schema(fields))


def _key_bounds(col: pa.ChunkedArray) -> Tuple[int, int]:
    """A chunk's key column's ``(min, max)`` as the card stores it (a
    uint64's words flipped: the same order); raises ``StreamUnsupported``
    for a NULL key."""
    if col.null_count > 0:
        raise StreamUnsupported("NULL group keys")
    mm = pc.min_max(col)
    lo, hi = int(mm["min"].as_py()), int(mm["max"].as_py())
    if col.type == pa.uint64():
        return storage_scalar(lo, col.type), storage_scalar(hi, col.type)
    return lo, hi


def _payload(col: pa.ChunkedArray, tp: pa.DataType) -> Tuple[np.ndarray, np.ndarray]:
    """A chunk's column as int64 (a float column's float64 bits) and its
    validity; nulls and a float's NaN are invalid, their slots 0."""
    if not (pa.types.is_integer(tp) or pa.types.is_floating(tp) or pa.types.is_boolean(tp)):
        raise StreamUnsupported(f"a payload of type {tp}")
    valid = col.is_valid().to_numpy(zero_copy_only=False) if col.null_count > 0 else \
        np.ones(len(col), dtype=np.bool_)
    if pa.types.is_floating(tp):
        npv = pc.fill_null(col, 0.0).to_numpy().astype(np.float64, copy=False)
        nan = np.isnan(npv)
        if nan.any():
            valid &= ~nan
            npv = np.where(nan, 0.0, npv)
        return npv.view(np.int64), valid
    if col.null_count > 0:
        col = pc.fill_null(col, False if pa.types.is_boolean(tp) else 0)
    return col.to_numpy(zero_copy_only=False).astype(np.int64, copy=False), valid


def stream_aggregate(engine: Any, chunks: Iterator[Any], schema: Schema,
                     keys: List[str], plans: List[Plan]
                     ) -> Tuple[TorchDataFrame, Dict[str, int]]:
    """Fold a stream of arrow or pandas chunks into per-group accumulators
    on the card (the engine's one-shot entry, ``:650``): the result and the
    aggregator's ``stats()``. Raises ``StreamFallback`` where the bounded
    path's semantics cannot stream."""
    agg = StreamingAggregator(engine, schema, keys, plans)
    consumed: List[Any] = []
    it = iter(chunks)
    for chunk in it:
        consumed.append(chunk)
        try:
            agg.fold(chunk)
        except StreamUnsupported as ex:
            # the consumed chunks are the caller's, not copies
            raise StreamFallback(str(ex), consumed, it)
    if agg.empty:
        raise StreamFallback("empty stream", consumed, it)
    res = agg.finalize()
    assert res is not None  # a folded aggregator always emits
    return res, agg.stats()


def materialize_fallback(fb: StreamFallback, schema: Schema) -> pa.Table:
    """The consumed chunks and the rest of the stream as one arrow table of
    ``schema``, for the bounded path (``:676``): each chunk typed by
    ``chunk_table``, so int64 values stay exact."""
    parts = [chunk_table(p, schema) for p in fb.consumed + list(fb.rest) if len(p) > 0]
    if not parts:
        return schema.pa_schema.empty_table()
    return pa.concat_tables(parts)
