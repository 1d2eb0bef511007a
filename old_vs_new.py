#!/usr/bin/env python3
"""Time another tree's kernels and host work beside this tree's, on one
card.

    python3 old_vs_new.py DIR [--old-only]

DIR holds files of the other tree (as a rule the parent commit's), for
example unpacked with ``git archive`` into a git-ignored directory: any of
``factorize.cu``, ``factorize.py``, ``join.cu``, ``join.py``,
``segment_reduce.cu``, ``segment_reduce.py`` (from
``fugue_tpu_torch/kernels/``), ``groupby.py`` and ``streaming.py`` (from
``fugue_tpu_torch/torch_backend/``). Its sources are built here with this
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

With ``--old-only``, the ``segment_reduce`` comparisons time DIR's
version alone (beside the library calls): a reading taken before this
tree's kernels are timed.

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
    sources = [stem for stem in ("factorize", "join", "segment_reduce")
               if (root / f"{stem}.cu").exists()]
    build.compile_jobs([(stem, [*build.NVCC_FLAGS, f"-I{build.KERNEL_DIR}",
                                str(root / f"{stem}.cu")], out / f"{stem}.so")
                        for stem in sources])
    mods = {}
    for stem in ("factorize", "join", "segment_reduce", "groupby", "streaming"):
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


def main() -> None:
    import torch

    args = [a for a in sys.argv[1:] if a != "--old-only"]
    if len(args) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false")
    print(f"card: {cs.card_line()}", flush=True)
    device = torch.device("cuda", torch.cuda.current_device())
    old = load_old(Path(args[0]).resolve())
    old_only = "--old-only" in sys.argv[1:]
    if "segment_reduce" in old:
        reduce(device, old, old_only)
        full_groupby(device, old, old_only)
    if old_only:
        return
    if "factorize" in old:
        k2(device, old)
        if "groupby" in old:
            wide_route(device, old)
    if "join" in old:
        k9(device, old)
    if "streaming" in old:
        stream_host(device, old)


if __name__ == "__main__":
    main()
