#!/usr/bin/env python3
"""Time another tree's kernels and host work beside this tree's, on one
card.

    python3 old_vs_new.py DIR [--old-only] [--no-check] [--only NAME,...]

DIR holds files of the other tree (as a rule the parent commit's), for
example unpacked with ``git archive`` into a git-ignored directory: any of
``factorize.cu``, ``factorize.py``, ``join.cu``, ``join.py``,
``segment_reduce.cu``, ``segment_reduce.py``, ``gather.cu``, ``gather.py``,
``comap.cu``, ``comap.py``
(from ``fugue_tpu_torch/kernels/``), ``groupby.py`` and ``streaming.py``
(from ``fugue_tpu_torch/torch_backend/``). Its sources are built here with this
tree's headers and flags, and each wrapper module is bound to its own
library. Each comparison runs where DIR holds its files.

Each shape is timed with CUDA events in turns (old, new, new, old), after
the two versions' outputs are checked equal:

- with ``factorize``: K2 at the set operations' shape
  (``chip_smoke.setop_codes``: 150M stacked rows, three int32 codes) and at
  the sort path's float32 key (100M rows, 1024 groups), as the wide route
  calls it (the first code in sorted order) and gathering every code; with
  ``groupby`` too, the wide route's whole factorization (its
  lexicographic sorts, K2, the readback, K3; K3 this tree's in both) of
  the set operations' codes: time, and peak device memory above what each
  run found allocated;
- with ``join``: K9 at ``chip_smoke.join_timing``'s expansion (200M
  outputs), on its cross join and skewed key, and at 100M probe rows of
  which one in 50 and one in 50,000 have a match (a tile's outputs over
  many probe rows);
- with ``streaming``: the stream's host work a 10M-row chunk
  (``chip_smoke.stream_chunks``): the other tree's route (the pandas
  chunk's keys and its ``_payload``, as its ``StreamingAggregator.fold``
  reads them) against this tree's ``chunk_table`` and
  ``StreamingAggregator.host_arrays``, the median of the chunks, on the
  host's clock;
- with ``segment_reduce``: K4 and K5 at each of
  ``chip_smoke.REDUCE_SHAPES`` (100M rows over one segment, 1024 uniform
  segments, Zipf(1.1) over 1024, 2^20 segments), K5 within rtol 1e-10 of
  the other (float64 sums in no fixed order), beside the shape's library
  call and bound; and the keyed and keyless full group-by
  (``chip_smoke.build_full_groupby``) with ``groupby``'s K4 and K5 each
  tree's: the results alike (exactly but the float sums, within
  ``chip_smoke.MAIN_PATH_RTOL`` and ``VARIANCE_RTOL``), best warm of
  ``chip_smoke.WARM_RUNS`` runs and the device time of one run
  (``torch.profiler``), in turns.

- with ``gather``: K10 gathering ``k`` int32 and ``v`` float32 by 100M
  permuted rows, by a sorted draw with replacement (sample's index), 8
  columns of 8 B by the permutation (this tree also on its direct route:
  the per-column cost of both), and at the expansion join's shapes
  (``chip_smoke.expand_timing_inputs``: the right side's float64 ``w`` by
  ``ri``, 200M outputs from 50M rows; the left side's int64 ``k`` and
  float64 ``v`` by ``li``), each beside its library call and bound; with
  ``join`` too, K7 at ``chip_smoke.join_timing``'s shape (50M rows over
  25M segments), in slot mode at config 3b's (256 dimension rows), at
  12,289 segments and with one segment holding every row over 25M; with
  both, the hash repartition of the headline frame (100M rows) and config
  10's expansion join (``chip_smoke.build_join_expand``) with each tree's
  K7 and K10 swapped in: the outputs alike, best warm, device time of one
  run (``torch.profiler``) and peak device memory above what each run
  found allocated; and this tree's K7 on its global and slab routes at 2^22
  to 2^24 segments (``k7_routes``).

- with ``join``: K8 in every mode (``k8``): expand, semi and anti at
  ``chip_smoke.join_timing``'s shape (100M probe rows over 25M segments),
  semi and anti also at 1024 and 2^18 + 1 segments, NOT IN at TPC-H
  Q16's shape (80M probe rows against 1M segments) and unique at config
  3b's (100M facts over 256 slots); expand over 200,000 and 250,000
  segments and unique over 50,000 and 60,000 slots (each side of the
  shared copy's limit), expand over 48M and 100M segments (byte tables
  past L2), expand with three quarters of its rows escaping to the int32
  count, and semi with 1M probe rows over 25M segments (a small probe
  side against a large table); each beside ``index_select`` of the
  table and its bound (each input read and each output written once),
  with this tree's place of the table (``join_probe_cuda.last_path``);
  and config 10's expansion join (``chip_smoke.build_join_expand``) and
  Q16's NOT IN statement with each tree's K8 swapped in
  (``probe_paths``): the results alike, best warm, device time of one run;
- with ``comap``: K18 at ``chip_smoke.comap_timing``'s config 4 shape and
  at 2^24 segments with 33 members (two presence words) (``k18``).

``--only k8,k18,probe_paths`` (any of ``reduce``, ``full_groupby``,
``k10``, ``k7``, ``k7_routes``, ``paths``, ``k2``, ``wide_route``,
``k9``, ``stream_host``, ``k8``, ``k18``, ``probe_paths``) runs only
those comparisons. With ``--old-only``, the ``segment_reduce``, ``gather``, ``join`` and ``comap``
comparisons time DIR's version alone (beside the library calls): a reading
taken before this tree's kernels are timed. With
``--no-check``, K10 and K7 are timed without holding the two versions'
outputs alike: for a DIR that holds a copy of this tree's ``gather.cu``
and ``gather.py`` with a step cut out (its outputs wrong), to see what the
step costs. The K10 and K7 lines carry this tree's kernels' device
milliseconds each (``new_split``, ``torch.profiler``).

Prints one ``old_vs_new:`` JSON line a shape, each with the card's name
and power limit. Exits non-zero where the versions differ or there is no
card."""

import ctypes
import importlib.util
import inspect
import json
import sys
import time
import types
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import chip_smoke as cs


def torch_equal(a: Any, b: Any) -> bool:
    import torch

    return torch.equal(a, b)


def load_old(root: Path) -> Dict[str, Any]:
    """The other tree's wrapper and backend modules that ``root`` holds,
    each wrapper bound to its own source built into ``root / "_build"``."""
    from fugue_tpu_torch.kernels import build

    out = root / "_build"
    sources = [stem for stem in ("factorize", "join", "segment_reduce", "gather", "comap")
               if (root / f"{stem}.cu").exists()]
    build.compile_jobs([(stem, [*build.NVCC_FLAGS, f"-I{build.KERNEL_DIR}",
                                str(root / f"{stem}.cu")], out / f"{stem}.so")
                        for stem in sources])
    mods = {}
    for stem in ("factorize", "join", "segment_reduce", "gather", "comap", "groupby",
                 "streaming"):
        if not (root / f"{stem}.py").exists():
            continue
        spec = importlib.util.spec_from_file_location(f"old_{stem}", root / f"{stem}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)  # type: ignore[union-attr]
        if stem in sources:
            lib = ctypes.CDLL(str(out / f"{stem}.so"))
            mod.build = types.SimpleNamespace(load=lambda _stem, lib=lib: lib)
        mods[stem] = mod
    return mods


def turns(label: str, new_fn: Callable[[], Any], old_fn: Callable[[], Any], reps: int,
          same: Callable[[Any, Any], bool] = torch_equal, **extra: Any) -> None:
    """Old and new checked alike (``same`` on each pair of outputs), then
    timed old, new, new, old."""
    for g, w in zip(new_fn(), old_fn()):
        if not same(g, w):
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


def kernel_ms(fn: Callable[[], Any], name: str, device: Any) -> Optional[float]:
    """The device milliseconds of the kernels named ``name`` in one call of
    ``fn`` (``torch.profiler``), without the wrapper's other work."""
    split = cs.device_split_ms(fn, device) or {}
    found = [ms for kernel, ms in split.items() if name in kernel]
    return sum(found) if found else None


def host_ms(fn: Callable[[], Any], device: Any, reps: int = 20) -> float:
    """Milliseconds of the host's clock a call of ``fn`` takes to enqueue
    its work, over ``reps`` calls after a synchronize."""
    import torch

    torch.cuda.synchronize(device)
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize(device)
    return ms


def reduce(device: Any, old: Dict[str, Any], old_only: bool) -> None:
    """K4 and K5 of each tree at each of ``chip_smoke.REDUCE_SHAPES``; with
    ``old_only``, the other tree's alone."""
    import torch

    from fugue_tpu_torch.kernels.segment_reduce import segment_extrema_cuda, segment_sq_dev_cuda

    om = old["segment_reduce"]

    def k4(fn: Callable[..., Any], case: Dict[str, Any]) -> Callable[[], Any]:
        def run() -> Any:
            got = fn(**case)
            return [cs._bits(got.mins[0]), cs._bits(got.maxs[0]), got.last]

        return run

    def close(g: Any, w: Any) -> bool:
        return bool(((g - w).abs() <= 1e-10 * w.abs()).all())

    for shape in cs.REDUCE_SHAPES:
        c = cs.reduce_shape(device, shape)
        for name, new_fn, old_fn, nbytes, library, ops_per_s, same in (
                ("segment_extrema", k4(segment_extrema_cuda, c["k4"]),
                 k4(om.segment_extrema_cuda, c["k4"]), c["k4_bytes"], c["k4_library"],
                 cs.FP32_OPS_PER_S, torch_equal),
                ("segment_sq_dev", lambda: [segment_sq_dev_cuda(**c["k5"])],  # noqa: B023
                 lambda: [om.segment_sq_dev_cuda(**c["k5"])],  # noqa: B023
                 c["k5_bytes"], c["k5_library"], cs.FP64_OPS_PER_S, close)):
            extra = {"shape": shape, "segments": c["num"], "rows": cs.ROWS,
                     "library_ms": cs.time_cuda(library, 5),
                     "bound_ms": max(nbytes / cs.HBM_BYTES_PER_S, 3 * cs.ROWS / ops_per_s) * 1e3,
                     "old_device_ms": kernel_ms(old_fn, name, device),
                     "old_host_ms": host_ms(old_fn, device)}
            if not old_only:
                extra.update(new_device_ms=kernel_ms(new_fn, name, device),
                             new_host_ms=host_ms(new_fn, device))
            if old_only:
                print("old_vs_new: " + json.dumps({
                    "case": f"{name} {shape}", "old_ms": [cs.time_cuda(old_fn, 20)
                                                          for _ in range(2)],
                    **extra, "card": cs.card_line()}), flush=True)
            else:
                turns(f"{name} {shape}", new_fn, old_fn, 20, same=same, **extra)
        del c
        torch.cuda.empty_cache()


def full_groupby(device: Any, old: Dict[str, Any], old_only: bool) -> None:
    """The keyed and keyless full group-by with ``groupby``'s K4 and K5
    wrappers each tree's in turn (the other tree's alone with
    ``old_only``): best warm and device time of each turn."""
    import numpy as np
    import torch

    from fugue_tpu_torch.torch_backend import groupby

    om = old["segment_reduce"]
    versions = {"old": (om.segment_extrema_cuda, om.segment_sq_dev_cuda),
                "new": (groupby.segment_extrema_cuda, groupby.segment_sq_dev_cuda)}
    run_for, _, _ = cs.build_full_groupby(device, cs.ROWS, cs.GROUPS, cs.DISTINCT_VALUES,
                                          cs.SEED)
    order = ("old", "old") if old_only else ("old", "new", "new", "old")
    try:
        for keyed in (True, False):
            run_once = run_for(keyed)
            results, best, busy = {}, {"old": [], "new": []}, {"old": [], "new": []}
            for which in order:
                groupby.segment_extrema_cuda, groupby.segment_sq_dev_cuda = versions[which]
                results[which] = run_once()[1]
                best[which].append(min(run_once()[0] for _ in range(cs.WARM_RUNS)))
                busy[which].append(cs.device_busy_ms(run_once, device))
            if not old_only:
                a, b = results["new"], results["old"]
                for col in a.columns:
                    x, y = a[col].to_numpy(), b[col].to_numpy()
                    tol = {"s": cs.MAIN_PATH_RTOL, "sd": cs.VARIANCE_RTOL,
                           "vp": cs.VARIANCE_RTOL}.get(col)
                    alike = (np.allclose(x, y, rtol=tol, atol=0) if tol is not None
                             else np.array_equal(x, y))
                    if not alike:
                        raise SystemExit(f"FAIL old_vs_new full group-by: {col} differs")
            print("old_vs_new: " + json.dumps({
                "case": f"full group-by {'keyed' if keyed else 'keyless'}", "rows": cs.ROWS,
                "old_best_warm_secs": best["old"], "new_best_warm_secs": best["new"],
                "old_device_ms": busy["old"], "new_device_ms": busy["new"],
                "card": cs.card_line()}), flush=True)
            torch.cuda.empty_cache()
    finally:
        groupby.segment_extrema_cuda, groupby.segment_sq_dev_cuda = versions["new"]

def same_columns(got: Any, want: Any) -> bool:
    """Two gathers' ``(values, mask)`` pairs alike, bit for bit."""
    import torch

    for (gv, gm), (wv, wm) in zip(got, want):
        if gv.dtype.is_floating_point:
            gv, wv = gv.view(torch.uint8), wv.view(torch.uint8)
        if not torch.equal(gv, wv) or (gm is None) != (wm is None):
            return False
        if gm is not None and not torch.equal(gm, wm):
            return False
    return True


def old_gather_fn(old: Dict[str, Any]) -> Callable[..., Any]:
    """The other tree's K10 wrapper with this tree's signature (the
    parent's has no ``scattered``: one route)."""
    fn = old["gather"].gather_rows_cuda
    takes_route = "scattered" in inspect.signature(fn).parameters

    def run(columns: Any, idx: Any, *, outer: bool = False, scattered: bool = False) -> Any:
        if takes_route:  # a variant of this tree's wrapper
            return fn(columns, idx, outer=outer, scattered=scattered)
        return fn(columns, idx, outer=outer)

    run.launches = 0  # type: ignore[attr-defined]
    return run


NO_CHECK = "--no-check" in sys.argv[1:]


def timed_once(label: str, new_fn: Callable[[], Any], old_fn: Callable[[], Any],
               old_only: bool, same: Callable[[Any, Any], bool], reps: int,
               **extra: Any) -> None:
    """``turns``, or with ``old_only`` the other tree's time alone (twice);
    with ``--no-check`` the outputs are not held alike."""
    if NO_CHECK:
        same = lambda g, w: True  # noqa: E731
    if old_only:
        print("old_vs_new: " + json.dumps({
            "case": label, "old_ms": [cs.time_cuda(old_fn, reps) for _ in range(2)], **extra,
            "card": cs.card_line()}), flush=True)
    else:
        turns(label, new_fn, old_fn, reps, same=same, **extra)


def k10(device: Any, old: Dict[str, Any], old_only: bool) -> None:
    """K10 of each tree at the permutation, the sample's sorted index, 8
    columns by the permutation and the expansion join's two gathers."""
    import torch

    from fugue_tpu_torch.kernels import gather
    from fugue_tpu_torch.kernels.join import join_expand_cuda
    from fugue_tpu_torch.kernels.reference import GatherColumn

    og = old_gather_fn(old)
    n = cs.ROWS
    gen = torch.Generator(device=device).manual_seed(cs.SEED)

    def run(label: str, cols: List[Any], idx: Any, scattered: bool, nbytes: int) -> None:
        idx64 = idx.to(torch.int64)
        extra: Dict[str, Any] = {
            "output_rows": int(idx.shape[0]), "columns": len(cols),
            "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
            "library_ms": cs.time_cuda(lambda: [c.values.index_select(0, idx64)
                                                for c in cols], 5),
            "old_device_ms": kernel_ms(lambda: og(cols, idx, scattered=scattered), "gather",
                                       device)}
        del idx64
        new_fn = lambda: gather.gather_rows_cuda(cols, idx, scattered=scattered)  # noqa: E731
        if not old_only:
            new_fn()
            extra.update(route=getattr(gather.gather_rows_cuda, "last_route", None),
                         new_device_ms=kernel_ms(new_fn, "", device),
                         new_split=cs.device_split_ms(new_fn, device))
            if scattered:
                direct = lambda: gather.gather_rows_cuda(cols, idx)  # noqa: E731
                extra["new_direct_ms"] = cs.time_cuda(direct, 10)
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
                out = new_fn()
                torch.cuda.synchronize(device)
                outputs = sum(v.numel() * v.element_size() for v, _ in out)
                extra["new_scratch_bytes_a_row"] = (torch.cuda.max_memory_allocated(device)
                                                    - base - outputs) / int(idx.shape[0])
                del out
        timed_once(f"gather_rows {label}", new_fn,
                   lambda: og(cols, idx, scattered=scattered), old_only,
                   lambda g, w: same_columns([g], [w]), 10, **extra)
        torch.cuda.empty_cache()

    k = torch.randint(0, cs.GROUPS, (n,), generator=gen, device=device, dtype=torch.int32)
    v = torch.rand((n,), generator=gen, device=device)
    kv = [GatherColumn(k, None), GatherColumn(v, None)]
    perm = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    run("k, v by 100M permuted rows", kv, perm, True, n * (4 + 2 * (4 + 4)))
    drawn = torch.sort(torch.randint(0, n, (n,), generator=gen, device=device,
                                     dtype=torch.int32)).values
    run("k, v by a sorted draw with replacement", kv, drawn, False, n * (4 + 2 * (4 + 4)))
    del drawn, k, v, kv
    wide = [GatherColumn(torch.randint(-(2**62), 2**62, (n,), generator=gen, device=device),
                         None) for _ in range(8)]
    run("8 int64 columns by 100M permuted rows", wide, perm, True, n * (4 + 8 * 16))
    del wide, perm
    torch.cuda.empty_cache()
    case = cs.expand_timing_inputs(device)
    li, ri = join_expand_cuda(**case)
    del case
    p1, p2 = cs.JOIN_EXPAND_ROWS, cs.JOIN_EXPAND_ROWS // 2
    total = int(li.shape[0])
    w = [GatherColumn(torch.rand((p2,), generator=gen, device=device, dtype=torch.float64),
                      None)]
    run("the expansion join's right side (w by ri)", w, ri, True, total * (4 + 16))
    del w, ri
    kv64 = [GatherColumn(torch.randint(0, p1 // 4, (p1,), generator=gen, device=device), None),
            GatherColumn(torch.rand((p1,), generator=gen, device=device, dtype=torch.float64),
                         None)]
    run("the expansion join's left side (k, v by li)", kv64, li, False, total * (4 + 2 * 16))
    del kv64, li
    torch.cuda.empty_cache()


def k7(device: Any, old: Dict[str, Any], old_only: bool) -> None:
    """K7 of each tree at join_timing's shape, config 3b's slot mode,
    12,289 segments and one segment holding every row."""
    import torch

    from fugue_tpu_torch.kernels.join import join_build_cuda

    ob = old["join"].join_build_cuda
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    p2 = cs.JOIN_EXPAND_ROWS // 2
    num = cs.JOIN_EXPAND_ROWS // 4
    shapes = [
        ("50M rows over 25M segments", lambda: dict(
            seg=(torch.randperm(p2, generator=gen, device=device) % num).to(torch.int32),
            num=num, nrows=p2)),
        ("slots, 50M rows over 25M segments", lambda: dict(
            seg=(torch.randperm(p2, generator=gen, device=device) % num).to(torch.int32),
            num=num, nrows=p2, slots=True)),
        ("slots, config 3b's 256 dimension rows", lambda: dict(
            seg=torch.arange(cs.JOIN3B_GROUPS, dtype=torch.int32, device=device),
            num=cs.JOIN3B_GROUPS, nrows=cs.JOIN3B_GROUPS, slots=True)),
        ("50M rows over 12,289 segments", lambda: dict(
            seg=torch.randint(0, 12_289, (p2,), generator=gen, device=device,
                              dtype=torch.int32), num=12_289, nrows=p2)),
        ("one segment of 25M holding 50M rows", lambda: dict(
            seg=torch.full((p2,), num // 2, dtype=torch.int32, device=device), num=num,
            nrows=p2)),
    ]
    for label, make in shapes:
        case = make()
        rows, segs = int(case["seg"].shape[0]), case["num"]
        extra: Dict[str, Any] = {
            "rows": rows, "segments": segs,
            "bound_ms": (rows * 4 + segs * 4) / cs.HBM_BYTES_PER_S * 1e3,
            "library_ms": None if case.get("slots") else cs.time_cuda(
                lambda: torch.bincount(case["seg"], minlength=segs), 5),  # noqa: B023
            "old_device_ms": kernel_ms(lambda: ob(**case), "join_build", device)}  # noqa: B023
        if not old_only:
            join_build_cuda(**case)
            extra.update(path=join_build_cuda.last_path,
                         new_device_ms=kernel_ms(lambda: join_build_cuda(**case),  # noqa: B023
                                                 "", device),
                         new_split=cs.device_split_ms(lambda: join_build_cuda(**case),  # noqa
                                                      device))
        timed_once(f"join_build {label}", lambda: [join_build_cuda(**case)],  # noqa: B023
                   lambda: [ob(**case)], old_only, torch_equal, 20, **extra)  # noqa: B023
        del case
        torch.cuda.empty_cache()


def k7_routes(device: Any) -> None:
    """This tree's K7 on its global and slab routes (``join.GLOBAL_MAX``
    moved) at 50M rows over 2^22, 2^23 and 2^24 segments: where the
    global table stops fitting L2."""
    import torch

    from fugue_tpu_torch.kernels import join

    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    p2, keep = cs.JOIN_EXPAND_ROWS // 2, join.GLOBAL_MAX
    try:
        for num in (1 << 22, 1 << 23, 1 << 24):
            seg = (torch.randperm(p2, generator=gen, device=device) % num).to(torch.int32)
            ms = {}
            for route, limit in (("global", num), ("slab", 0)):
                join.GLOBAL_MAX = limit
                join.join_build_cuda(seg, num, nrows=p2)
                assert join.join_build_cuda.last_path == route
                ms[route] = [cs.time_cuda(lambda: join.join_build_cuda(seg, num, nrows=p2),  # noqa
                                          20) for _ in range(2)]
            print("old_vs_new: " + json.dumps({
                "case": "join_build routes", "rows": p2, "segments": num,
                "global_ms": ms["global"], "slab_ms": ms["slab"], "card": cs.card_line()}),
                flush=True)
            del seg
    finally:
        join.GLOBAL_MAX = keep


def paths(device: Any, old: Dict[str, Any], old_only: bool) -> None:
    """The hash repartition of the headline frame and config 10's
    expansion join, with each tree's K7 and K10 in turn: outputs alike,
    best warm, device ms of one run and peak memory above the run's
    start."""
    import numpy as np
    import pandas as pd
    import torch

    import fugue_tpu_torch as ft
    from fugue_tpu_torch.kernels import gather
    from fugue_tpu_torch.torch_backend import blocks, relational, window

    mods = [m for m in (gather, blocks, relational, window) if hasattr(m, "gather_rows_cuda")]
    versions = {"old": (old_gather_fn(old), old["join"].join_build_cuda),
                "new": (gather.gather_rows_cuda, relational.join_build_cuda)}

    def use(which: str) -> None:
        g, b = versions[which]
        for m in mods:
            m.gather_rows_cuda = g
        relational.join_build_cuda = b

    engine = ft.make_execution_engine("torch", device=device)
    k, v, _ = cs.full_groupby_frame(cs.ROWS, cs.GROUPS, cs.DISTINCT_VALUES, cs.SEED)
    src = engine.persist(engine.to_df(pd.DataFrame({"k": k, "v": v})))
    del k, v

    def repartition() -> Any:
        out = ft.repartition(src, {"algo": "hash", "num": cs.REPARTITION_NUM, "by": ["k"]},
                             engine=engine, as_fugue=True)
        torch.cuda.synchronize(device)
        return out

    join_once = cs.build_join_expand(device, cs.JOIN_EXPAND_ROWS)[1]

    def expansion() -> Any:
        out = join_once()
        out.count()
        return out

    order = ("old", "old") if old_only else ("old", "new", "new", "old")
    try:
        for label, fn in (("repartition_hash", repartition), ("join_expand", expansion)):
            got: Dict[str, Any] = {}
            best: Dict[str, List[float]] = {"old": [], "new": []}
            busy: Dict[str, List[Optional[float]]] = {"old": [], "new": []}
            peak: Dict[str, List[int]] = {"old": [], "new": []}
            for which in order:
                use(which)
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
                out = fn()
                torch.cuda.synchronize(device)
                peak[which].append(torch.cuda.max_memory_allocated(device) - base)
                if which not in got:
                    b = out.blocks
                    got[which] = {n: b.columns[n].data[:b.nrows].cpu().numpy()
                                  for n in b.columns}
                del out
                secs = []
                for _ in range(3):
                    t = time.perf_counter()
                    fn()
                    secs.append(time.perf_counter() - t)
                best[which].append(min(secs))
                busy[which].append(cs.device_busy_ms(fn, device))
            if not old_only and any(not np.array_equal(got["old"][n], got["new"][n])
                                    for n in got["old"]):
                raise SystemExit(f"FAIL old_vs_new {label}: the two versions differ")
            del got
            print("old_vs_new: " + json.dumps({
                "case": f"path {label}", "old_best_warm_secs": best["old"],
                "new_best_warm_secs": best["new"], "old_device_ms": busy["old"],
                "new_device_ms": busy["new"], "old_peak_bytes": peak["old"],
                "new_peak_bytes": peak["new"], "card": cs.card_line()}), flush=True)
            torch.cuda.empty_cache()
    finally:
        use("new")


def probe_values(probe: Any) -> List[Any]:
    """A K8 result's outputs, the fields its mode leaves None dropped."""
    return [t for t in probe if t is not None]


def k8(device: Any, old: Dict[str, Any], old_only: bool) -> None:
    """K8 of each tree in every mode at the shapes of ``join_timing``
    (expand, semi, anti), 1024 and 2^18 + 1 segments (semi, anti), Q16's
    NOT IN and config 3b's unique lookup."""
    import torch

    from fugue_tpu_torch.kernels import join
    from fugue_tpu_torch.kernels.reference import join_build_reference

    op = old["join"].join_probe_cuda
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    p1, p2 = cs.JOIN_EXPAND_ROWS, cs.JOIN_EXPAND_ROWS // 2

    def sides(num: int, build_rows: int, cover: int, probe_rows: int = p1) -> Any:
        probe = (torch.randperm(probe_rows, generator=gen, device=device) % num).to(torch.int32)
        build = (torch.randperm(build_rows, generator=gen, device=device) % cover)
        counts = join_build_reference(build.to(torch.int32), num, nrows=build_rows)
        return probe, counts

    big = cs.JOIN_EXPAND_ROWS // 4
    shapes: List[Any] = []
    probe, counts = sides(big, p2, big)  # join_timing's: 2 build rows a segment
    for mode in ("expand", "semi", "anti"):
        shapes.append((f"{mode}, 100M probe rows over 25M segments", mode, probe, counts, {}))
    for num in (1024, (1 << 18) + 1):
        pr, ct = sides(num, p2, num * 3 // 4)  # a quarter of the segments unmatched
        for mode in ("semi", "anti"):
            shapes.append((f"{mode}, 100M probe rows over {num} segments", mode, pr, ct, {}))
    # each side of the shared copy's limit (200 KB of byte entries), and
    # tables of bytes past L2, whose narrowing reads K7's table whole
    for num in (200_000, 250_000, 48_000_000, 100_000_000):
        pr, ct = sides(num, min(2 * num, p2), num * 3 // 4)
        shapes.append((f"expand, 100M probe rows over {num} segments", "expand", pr, ct, {}))
    # 266 or 267 build rows in each of three quarters of the segments: those
    # rows read the byte and, through its escape, the int32 count
    pr, ct = sides(250_000, p2, 187_500)
    shapes.append(("expand, 100M probe rows over 250000 segments, three quarters escaping",
                   "expand", pr, ct, {}))
    # a small probe side against a large table: the narrowing launch reads
    # 25 times the probe's rows
    pr, ct = sides(big, p2, big, probe_rows=1_000_000)
    shapes.append(("semi, 1M probe rows over 25M segments", "semi", pr, ct, {}))
    del pr, ct
    q16 = torch.randint(0, cs.NOT_IN_SUPPLIERS, (cs.NOT_IN_ROWS,), generator=gen, device=device,
                        dtype=torch.int32)
    bad = torch.randperm(cs.NOT_IN_SUPPLIERS, generator=gen, device=device)[:cs.NOT_IN_COMPLAINTS]
    table, stats = join_build_reference(bad.to(torch.int32), cs.NOT_IN_SUPPLIERS,
                                        nrows=cs.NOT_IN_COMPLAINTS, side_counts=True)
    shapes.append(("not_in, Q16's 80M probe rows against 1M segments", "not_in", q16, table,
                   dict(stats=stats)))
    slots = join_build_reference(torch.arange(cs.JOIN3B_GROUPS, dtype=torch.int32,
                                              device=device),
                                 cs.JOIN3B_GROUPS, nrows=cs.JOIN3B_GROUPS, slots=True)
    facts = torch.randint(0, cs.JOIN3B_GROUPS, (cs.ROWS,), generator=gen, device=device,
                          dtype=torch.int32)
    shapes.append(("unique, config 3b's 100M facts over 256 slots", "unique", facts, slots, {}))
    # each side of the shared copy's limit (200 KB of slots)
    for num in (50_000, 60_000):
        keys = torch.arange(num, dtype=torch.int32, device=device)
        tab = join_build_reference(keys, num, nrows=num, slots=True)
        ids = torch.randint(0, num, (cs.ROWS,), generator=gen, device=device, dtype=torch.int32)
        shapes.append((f"unique, 100M facts over {num} slots", "unique", ids, tab, {}))
    # bytes of each input read once and each output written once: the
    # probe ids and the table, and by mode keep (1 B), ridx (4 B), m and
    # reps (8 B)
    out_bytes = {"semi": 1, "anti": 1, "not_in": 1, "unique": 5, "expand": 8}
    for label, mode, seg, tab, kw in shapes:
        n, num = int(seg.shape[0]), int(tab.shape[0])
        new_fn = lambda: probe_values(join.join_probe_cuda(  # noqa: E731
            seg, tab, mode, nrows=n, **kw))  # noqa: B023
        old_fn = lambda: probe_values(op(seg, tab, mode, nrows=n, **kw))  # noqa: E731,B023
        seg64 = seg.to(torch.int64)
        extra: Dict[str, Any] = {
            "mode": mode, "rows": n, "segments": num,
            "bound_ms": (n * (4 + out_bytes[mode]) + num * 4) / cs.HBM_BYTES_PER_S * 1e3,
            "library_ms": cs.time_cuda(lambda: tab.index_select(0, seg64), 5),  # noqa: B023
            "old_device_ms": kernel_ms(old_fn, "join_probe", device)}
        del seg64
        if not old_only:
            new_fn()
            extra.update(path=join.join_probe_cuda.last_path,
                         new_device_ms=kernel_ms(new_fn, "join_probe", device),
                         new_split=cs.device_split_ms(new_fn, device))
        timed_once(f"join_probe {label}", new_fn, old_fn, old_only, torch_equal, 20, **extra)
        torch.cuda.empty_cache()


def k18(device: Any, old: Dict[str, Any], old_only: bool) -> None:
    """K18 of each tree at config 4's shape (``comap_timing``) and at 2^24
    segments with 33 members, each member's rows in segment order (a
    co-partitioned frame), inner rule."""
    import torch

    from fugue_tpu_torch.kernels import comap

    oc = old["comap"]
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    groups = cs.CONFIG4_BIG_GROUPS
    na, nb = groups * cs.CONFIG4_PER, groups
    config4 = (torch.cat([torch.arange(na, device=device) // cs.CONFIG4_PER,
                          torch.arange(nb, device=device)]).to(torch.int32), groups, [na, nb])
    members, num = 33, 1 << 24
    per = cs.ROWS // members
    sizes = [per] * (members - 1) + [cs.ROWS - per * (members - 1)]
    seg33 = torch.cat([torch.sort(torch.randint(0, num, (s,), generator=gen, device=device,
                                                dtype=torch.int32)).values for s in sizes])
    for label, (seg, segs, sz) in (("config 4 (102M rows, 2 members, 2M segments)", config4),
                                   ("100M rows, 33 members, 2^24 segments", (seg33, num, sizes))):
        offsets, nrows = cs.comap_layout(device, sz, sz)
        kw = dict(offsets=offsets, nrows=nrows)
        presence = oc.comap_presence_cuda(seg, segs, **kw)
        n = int(seg.shape[0])
        new_fn = lambda: list(comap.comap_rows_cuda(  # noqa: E731
            seg, presence, segs, how="inner", **kw))  # noqa: B023
        old_fn = lambda: list(oc.comap_rows_cuda(  # noqa: E731
            seg, presence, segs, how="inner", **kw))  # noqa: B023
        words = int(presence.shape[0]) // segs
        extra: Dict[str, Any] = {
            "rows": n, "members": len(sz), "segments": segs,
            "bound_ms": (n * (4 + 1 + 4) + segs * (4 * words + 1)) / cs.HBM_BYTES_PER_S * 1e3,
            "old_device_ms": kernel_ms(old_fn, "comap_rows", device)}
        if not old_only:
            extra["new_device_ms"] = kernel_ms(new_fn, "comap_rows", device)
        timed_once(f"comap_rows {label}", new_fn, old_fn, old_only, torch_equal, 20, **extra)
        del presence
        torch.cuda.empty_cache()
    del seg33, config4


def frame_arrays(out: Any) -> List[Any]:
    """A frame's rows on the card: its row count, and each column's values
    and mask over its real rows."""
    b = out.blocks
    keep = None if b.row_valid is None else b.row_valid[:b.padded_nrows]
    arrays: List[Any] = []
    for c in b.columns.values():
        for t in (c.data, c.mask):
            if t is not None:
                t = t[:b.padded_nrows]
                arrays.append(t[keep] if keep is not None else t[:b.nrows])
    return [b.nrows, *arrays]


def probe_paths(device: Any, old: Dict[str, Any], old_only: bool) -> None:
    """Config 10's expansion join and Q16's NOT IN statement with each
    tree's K8 in turn: results alike, best warm of 3, device ms of one
    run."""
    import torch

    from fugue_tpu_torch.torch_backend import relational

    versions = {"old": old["join"].join_probe_cuda, "new": relational.join_probe_cuda}
    join_once = cs.build_join_expand(device, cs.JOIN_EXPAND_ROWS)[1]

    def expansion() -> Any:
        out = join_once()
        out.count()
        return out

    not_in_run = cs.build_sql_paths(device, 10_000, cs.NOT_IN_ROWS)[0]["q16_not_in"]

    def not_in() -> Any:
        return not_in_run()[1]

    order = ("old", "old") if old_only else ("old", "new", "new", "old")
    try:
        for label, fn in (("join_expand", expansion), ("q16_not_in", not_in)):
            got: Dict[str, Any] = {}
            best: Dict[str, List[float]] = {"old": [], "new": []}
            busy: Dict[str, List[Optional[float]]] = {"old": [], "new": []}
            for which in order:
                relational.join_probe_cuda = versions[which]
                out = fn()
                torch.cuda.synchronize(device)
                if which not in got:
                    got[which] = frame_arrays(out)
                del out
                secs = []
                for _ in range(3):
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize(device)
                    secs.append(time.perf_counter() - t)
                best[which].append(min(secs))
                busy[which].append(cs.device_busy_ms(fn, device))
            if not old_only:
                a, b = got["old"], got["new"]
                if a[0] != b[0] or any(not torch_equal(x, y) for x, y in zip(a[1:], b[1:])):
                    raise SystemExit(f"FAIL old_vs_new {label}: the two versions differ")
            del got
            print("old_vs_new: " + json.dumps({
                "case": f"path {label}", "old_best_warm_secs": best["old"],
                "new_best_warm_secs": best["new"], "old_device_ms": busy["old"],
                "new_device_ms": busy["new"], "card": cs.card_line()}), flush=True)
            torch.cuda.empty_cache()
    finally:
        relational.join_probe_cuda = versions["new"]


COMPARISONS = ("reduce", "full_groupby", "k10", "k7", "k7_routes", "paths", "k2", "wide_route",
               "k9", "stream_host", "k8", "k18", "probe_paths")


def main() -> None:
    import torch

    argv = sys.argv[1:]
    only = set(COMPARISONS)
    if "--only" in argv:
        at = argv.index("--only")
        only = set(argv[at + 1].split(","))
        if not only <= set(COMPARISONS):
            raise SystemExit(f"--only takes names of {COMPARISONS}")
        argv = argv[:at] + argv[at + 2:]
    args = [a for a in argv if a not in ("--old-only", "--no-check")]
    if len(args) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false")
    print(f"card: {cs.card_line()}", flush=True)
    device = torch.device("cuda", torch.cuda.current_device())
    old = load_old(Path(args[0]).resolve())
    old_only = "--old-only" in argv

    def want(name: str, *stems: str) -> bool:
        return name in only and all(stem in old for stem in stems)

    if want("reduce", "segment_reduce"):
        reduce(device, old, old_only)
    if want("full_groupby", "segment_reduce"):
        full_groupby(device, old, old_only)
    if want("k10", "gather"):
        k10(device, old, old_only)
    if want("k7", "join"):
        k7(device, old, old_only)
    if want("k7_routes", "join") and not old_only:
        k7_routes(device)
    if want("k8", "join"):
        k8(device, old, old_only)
    if want("probe_paths", "join"):
        probe_paths(device, old, old_only)
    if want("k18", "comap"):
        k18(device, old, old_only)
    if want("paths", "join", "gather") and not NO_CHECK:
        paths(device, old, old_only)
    if old_only or NO_CHECK:
        return
    if want("k2", "factorize"):
        k2(device, old)
    if want("wide_route", "factorize", "groupby"):
        wide_route(device, old)
    if want("k9", "join") and "gather" not in old:
        k9(device, old)
    if want("stream_host", "streaming"):
        stream_host(device, old)


if __name__ == "__main__":
    main()
