#!/usr/bin/env python3
"""Time another tree's K2 ``sort_boundaries``, K9 ``join_expand`` and the
streaming aggregate's host work a chunk beside this tree's, on one card.

    python3 old_vs_new.py DIR

DIR holds the other tree's (as a rule the parent commit's)
``factorize.cu``, ``factorize.py``, ``join.cu``, ``join.py`` (from
``fugue_tpu_torch/kernels/``), ``groupby.py`` and ``streaming.py`` (from
``fugue_tpu_torch/torch_backend/``), for example unpacked with ``git archive``
into a git-ignored directory. Its sources are built here with this tree's
headers and flags, and each wrapper module is bound to its own library.

Each shape is timed with CUDA events in turns (old, new, new, old), after
the two versions' outputs are checked equal:

- K2 at the set operations' shape (``chip_smoke.setop_codes``: 150M
  stacked rows, three int32 codes) and at the sort path's float32 key
  (100M rows, 1024 groups), as the wide route calls it (the first code in
  sorted order) and gathering every code;
- the wide route's whole factorization (its lexicographic sorts, K2, the
  readback, K3; K3 this tree's in both) of the set operations' codes:
  time, and peak device memory above what each run found allocated;
- K9 at ``chip_smoke.join_timing``'s expansion (200M outputs), on its
  cross join and skewed key, and at 100M probe rows of which one in 50 and
  one in 50,000 have a match (a tile's outputs over many probe rows);
- the stream's host work a 10M-row chunk (``chip_smoke.stream_chunks``):
  the other tree's route (the pandas chunk's keys and its ``_payload``,
  as its ``StreamingAggregator.fold`` reads them) against this tree's
  ``chunk_table`` and ``StreamingAggregator.host_arrays``, the median of
  the chunks, on the host's clock.

Prints one ``old_vs_new:`` JSON line a shape, each with the card's name
and power limit. Exits non-zero where the versions differ or there is no
card."""

import ctypes
import importlib.util
import json
import sys
import time
import types
from pathlib import Path
from typing import Any, Callable, Dict, List

import chip_smoke as cs


def load_old(root: Path) -> Dict[str, Any]:
    """The other tree's ``factorize`` and ``join`` wrapper modules, each
    bound to its own source built into ``root / "_build"``, and its
    ``streaming`` module."""
    from fugue_tpu_torch.kernels import build

    out = root / "_build"
    build.compile_jobs([(stem, [*build.NVCC_FLAGS, f"-I{build.KERNEL_DIR}",
                                str(root / f"{stem}.cu")], out / f"{stem}.so")
                        for stem in ("factorize", "join")])
    mods = {}
    for stem in ("factorize", "join", "groupby", "streaming"):
        spec = importlib.util.spec_from_file_location(f"old_{stem}", root / f"{stem}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)  # type: ignore[union-attr]
        if stem in ("factorize", "join"):
            lib = ctypes.CDLL(str(out / f"{stem}.so"))
            mod.build = types.SimpleNamespace(load=lambda _stem, lib=lib: lib)
        mods[stem] = mod
    return mods


def turns(label: str, new_fn: Callable[[], Any], old_fn: Callable[[], Any], reps: int,
          **extra: Any) -> None:
    """Old and new checked equal, then timed old, new, new, old."""
    import torch

    for g, w in zip(new_fn(), old_fn()):
        if not torch.equal(g, w):
            raise SystemExit(f"FAIL old_vs_new {label}: the two versions differ")
    o1, n1, n2, o2 = (cs.time_cuda(f, reps) for f in (old_fn, new_fn, new_fn, old_fn))
    print("old_vs_new: " + json.dumps({"case": label, "old_ms": [o1, o2], "new_ms": [n1, n2],
                                       **extra, "card": cs.card_line()}), flush=True)


def k2(device: Any, old: Dict[str, Any]) -> None:
    import torch

    from fugue_tpu_torch.kernels.factorize import sort_boundaries_cuda
    from fugue_tpu_torch.torch_backend import groupby

    old_k2 = old["factorize"].sort_boundaries_cuda
    codes, (order, first) = cs.setop_codes(device)
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    for shape in ("set operations", "float32 key"):
        if shape == "float32 key":
            del codes, order, first
            torch.cuda.empty_cache()
            key = torch.randint(0, cs.GROUPS, (cs.ROWS,), generator=gen, device=device,
                                dtype=torch.int32)
            codes = groupby.sort_codes([(key.float(), None)])
            del key
            order, first = groupby.lex_sort(codes, nrows=cs.ROWS)
        n = int(order.shape[0])
        for suffix, extra in (("", dict(first_sorted=first)), (", every code gathered", {})):
            turns(f"sort_boundaries {shape}{suffix}",
                  lambda: sort_boundaries_cuda(codes, order, nrows=n, **extra),  # noqa: B023
                  lambda: old_k2(codes, order, nrows=n), 20, rows=n)  # noqa: B023
    del codes, order, first
    torch.cuda.empty_cache()


def wide_route(device: Any, old: Dict[str, Any]) -> None:
    """``groupby.wide_factorize`` of each tree over the set operations'
    codes, its outputs equal; each run's peak device memory above what it
    found allocated (old, new, new, old), and its time."""
    import torch

    from fugue_tpu_torch.torch_backend import groupby

    og = old["groupby"]  # its K2 the other tree's, its K3 this tree's
    og.sort_boundaries_cuda = old["factorize"].sort_boundaries_cuda
    codes, (order, first) = cs.setop_codes(device)
    n = int(order.shape[0])
    del order, first
    fns = {"old": lambda: og.wide_factorize(codes, nrows=n),
           "new": lambda: groupby.wide_factorize(codes, nrows=n)}
    got, want = fns["new"](), fns["old"]()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and got[2] == want[2]):
        raise SystemExit("FAIL old_vs_new wide route: the two versions differ")
    del got, want
    peaks: Dict[str, List[int]] = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = fns[which]()
        torch.cuda.synchronize(device)
        peaks[which].append(torch.cuda.max_memory_allocated(device) - base)
        del out
    print("old_vs_new: " + json.dumps({
        "case": "wide route set operations", "rows": n, "old_peak_bytes": peaks["old"],
        "new_peak_bytes": peaks["new"], "old_ms": cs.time_cuda(fns["old"], 3),
        "new_ms": cs.time_cuda(fns["new"], 3), "card": cs.card_line()}), flush=True)
    del codes
    torch.cuda.empty_cache()


def k9(device: Any, old: Dict[str, Any]) -> None:
    import torch

    from fugue_tpu_torch.kernels.join import join_expand_cuda

    def sparse(every: int) -> Dict[str, Any]:
        n = cs.JOIN_EXPAND_ROWS
        gen = torch.Generator(device=device).manual_seed(cs.SEED)
        probe = torch.randperm(n, generator=gen, device=device).to(torch.int32)
        build = torch.arange(n // every, dtype=torch.int32, device=device)
        return cs._expand_inputs(probe, build, n, False)

    cases = [("expansion", lambda: cs.expand_timing_inputs(device))]
    cases += [(label, lambda case=case: case)
              for label, case in cs.expand_cases(device, cs.JOIN_CROSS_ROWS[0] * 10, cs.SEED)
              if label in ("cross", "skew")]
    cases += [(f"100M probe rows, 1 in {every}", lambda every=every: sparse(every))
              for every in (50, 50_000)]
    for label, make in cases:
        case = make()
        turns(f"join_expand {label}", lambda: join_expand_cuda(**case),  # noqa: B023
              lambda: old["join"].join_expand_cuda(**case), 20,  # noqa: B023
              output_rows=case["total"], probe_rows=int(case["start"].shape[0]))
        del case
        torch.cuda.empty_cache()


def stream_host(device: Any, old: Dict[str, Any]) -> None:
    """The host work a chunk of the stream's two routes, each chunk timed
    old, new, new, old; the medians over the chunks."""
    import numpy as np

    import fugue_tpu_torch as ft
    from fugue_tpu_torch.dataframe.dataframe_iterable_dataframe import chunk_table
    from fugue_tpu_torch.torch_backend.streaming import StreamingAggregator

    schema = ft.Schema("store:int,item:long,qty:long,price:double")
    keys = ["store", "item"]
    plans = [(f"{c}_{f}", f, c) for c in ("qty", "price") for f in cs.STREAM_AGGS]
    e = ft.make_execution_engine(device=device)
    agg = StreamingAggregator(e, schema, keys, plans)
    payloads = list(agg._payloads)  # host_arrays' order
    types_ = {c: schema[c].type for c in payloads}
    old_payload = old["streaming"]._payload

    def old_route(pdf: Any) -> Any:
        # the other tree's fold up to its upload: its null-key check, keys
        # and payloads from the pandas chunk
        assert not pdf[keys].isna().any().any()
        ks = [np.asarray(pdf[k].to_numpy()).astype(np.int64, copy=False) for k in keys]
        values = np.empty((len(ks) + len(payloads), len(pdf)), dtype=np.int64)
        for j, k in enumerate(ks):
            values[j] = k
        valids = np.empty((len(payloads), len(pdf)), dtype=np.bool_)
        for j, c in enumerate(payloads):
            values[len(ks) + j], valids[j] = old_payload(pdf[c], types_[c])
        return values, valids

    def new_route(pdf: Any) -> Any:
        return agg.host_arrays(chunk_table(pdf, schema))

    data = cs.stream_chunks(cs.STREAM_CHUNKS, cs.STREAM_CHUNK_ROWS, cs.STREAM_SEED)
    ms: Dict[str, List[float]] = {"old": [], "new": []}
    for pdf in data:
        got, want = new_route(pdf), old_route(pdf)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise SystemExit("FAIL old_vs_new stream host: the two routes differ")
        for which, fn in (("old", old_route), ("new", new_route), ("new", new_route),
                          ("old", old_route)):
            t = time.perf_counter()
            fn(pdf)
            ms[which].append((time.perf_counter() - t) * 1e3)
    print("old_vs_new: " + json.dumps({
        "case": "stream host work a chunk", "chunk_rows": cs.STREAM_CHUNK_ROWS,
        "old_ms_median": float(np.median(ms["old"])), "new_ms_median": float(np.median(ms["new"])),
        "old_ms_max": max(ms["old"]), "new_ms_max": max(ms["new"]), "card": cs.card_line()}),
        flush=True)


def main() -> None:
    import torch

    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false")
    print(f"card: {cs.card_line()}", flush=True)
    device = torch.device("cuda", torch.cuda.current_device())
    old = load_old(Path(sys.argv[1]).resolve())
    k2(device, old)
    wide_route(device, old)
    k9(device, old)
    stream_host(device, old)


if __name__ == "__main__":
    main()
