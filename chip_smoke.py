#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fugue_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them.
2. build: compiles every CUDA source of the port with ``nvcc`` (one
   process per source, all at once).
3. kernel vs twin: the fused binned-sum kernel against its plain PyTorch
   twin on the same CUDA tensors. First in its one-key form over
   precomputed segment ids (``segment_sums_cuda``), on both of its paths
   (shared-memory replicas at 1024 segments, global atomics at 2^20), with
   float32/float64, count (bool and uint8) and int64 payloads and rows
   outside the segment range; then every case of ``binned_cases`` (one to
   four keys of every width, nullable keys, wide spans, int64 keys near
   -2^40, masked payloads, count(col), prefix and masked-layout frames,
   offset views, one group, more payloads than one launch takes), and two
   of them in every variant of the sweep. Each at n = 1 and n = 2^20 + 37.
   Counts and int64 sums must match exactly; float sums within the bound
   ``float_tolerance`` states.
4. main path: 100M rows, an int32 key over 1024 groups and a float32
   value made from seed 42 (the JAX package's headline shape,
   ``bench.py:538-545``), through ``persist(to_df)`` -> ``transform`` ->
   ``aggregate`` -> ``as_pandas``; checked against a float64 numpy
   reference. Reports cold and best-of-5 warm seconds, rows/s and peak
   device memory. The kernel launch count is zeroed just before the cold
   run and read just after it: one fused-kernel launch per aggregate.
5. kernel timing at the headline shape with CUDA events: the kernel, its
   plain twin, one ``index_add_`` call computing the same sums, and the
   kernel's bound from the bytes it must move; then the variant sweep
   (rows per tile, tiles per iteration, replicas) and the time of the
   all-rows-in-one-group shape, each on a line of its own.

Before the last line it prints one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import math
import subprocess
import time
from typing import Any, Callable, Dict, List, Tuple

ROWS = 100_000_000
GROUPS = 1024
SEED = 42
WARM_RUNS = 5
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the
# tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the main path against float64 numpy: float32 accumulation over ~100k
# rows per group
MAIN_PATH_RTOL = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def float_tolerance(dtype: Any, rows: Any, absum: Any) -> Any:
    """Per-segment bound on |kernel - twin| for float sums: 8 u sqrt(m)
    sum|v|, with u the unit roundoff of the type and m the segment's row
    count. The two add the same values in different orders (atomics in
    the order they land), so each sum carries a rounding error that grows
    like u sqrt(m) sum|v| for random orders; the worst-case bound is
    2 (m - 1) u sum|v|."""
    import torch

    u = 2.0**-24 if dtype == torch.float32 else 2.0**-53
    return 8.0 * u * torch.sqrt(rows.to(torch.float64).clamp(min=1)) * absum


def check_against_twin(
    got: Tuple[Any, Any, Any], want: Tuple[Any, Any, Any], fpack: Any,
    seg: Any, total: int, label: str,
) -> float:
    """Counts and ints exact, floats within ``float_tolerance``. Returns
    the largest absolute float difference."""
    import torch

    from fugue_tpu_torch.kernels.reference import segment_sums_reference

    (kf, kc, ki), (rf, rc, ri) = got, want
    if not torch.equal(kc, rc):
        raise SystemExit(f"FAIL {label}: count sums differ")
    if not torch.equal(ki, ri):
        raise SystemExit(f"FAIL {label}: int64 sums differ")
    if kf.numel() == 0:
        return 0.0
    ones = torch.ones((1, seg.shape[0]), dtype=torch.bool, device=seg.device)
    empty_i = torch.empty((0, seg.shape[0]), dtype=torch.int64, device=seg.device)
    absum, rows, _ = segment_sums_reference(seg, fpack.abs(), ones, empty_i, total)
    tol = float_tolerance(fpack.dtype, rows, absum.to(torch.float64))
    diff = (kf.to(torch.float64) - rf.to(torch.float64)).abs()
    if bool((diff > tol).any()):
        raise SystemExit(
            f"FAIL {label}: float sums differ by up to {float(diff.max())}"
        )
    return float(diff.max())


def kernel_vs_twin(device: Any) -> float:
    """The kernel in its one-key form over precomputed segment ids
    (``segment_sums_cuda``) against ``segment_sums_reference``."""
    import torch

    from fugue_tpu_torch.kernels.reference import segment_sums_reference
    from fugue_tpu_torch.kernels.segment_sums import binned_sums_cuda, segment_sums_cuda

    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = 0.0
    for total, path in ((1024, "shared"), (1 << 20, "global")):
        for n in (1, (1 << 20) + 37):
            for fdtype in (torch.float32, torch.float64):
                seg = torch.randint(
                    -2, total + 2, (n,), generator=gen, device=device,
                    dtype=torch.int32,
                )
                fpack = torch.rand((2, n), generator=gen, device=device, dtype=fdtype) * 2 - 1
                # bool counts on float32 runs, uint8 flags of 0-3 on float64
                # runs: kernel and twin count the non-zero bytes
                cpack = (
                    torch.rand((2, n), generator=gen, device=device) < 0.7
                    if fdtype == torch.float32
                    else torch.randint(
                        0, 4, (2, n), generator=gen, device=device, dtype=torch.uint8
                    )
                )
                ipack = torch.randint(
                    -(2**40), 2**40, (1, n), generator=gen, device=device,
                    dtype=torch.int64,
                )
                got = segment_sums_cuda(seg, fpack, cpack, ipack, total)
                if binned_sums_cuda.last_path != path:
                    raise SystemExit(
                        f"FAIL: total={total} took the "
                        f"{binned_sums_cuda.last_path} path, expected {path}"
                    )
                want = segment_sums_reference(seg, fpack, cpack, ipack, total)
                torch.cuda.synchronize(device)
                label = f"segment_sums total={total} n={n} {fdtype}"
                err = check_against_twin(got, want, fpack, seg, total, label)
                worst = max(worst, err)
                print(f"ok {label} path={path} max_abs_err={err}")
    return worst


def binned_cases(device: Any, n: int, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """The fused kernel's phase-3 cases at ``n`` rows: ``(label, keyword
    arguments of binned_sums_cuda / binned_sums_reference)``. Keys reach
    beyond their ``[kmin, kmin + span)`` on some rows, so the kernel must
    drop those rows."""
    import torch

    from fugue_tpu_torch.kernels.reference import BinKey

    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(lo: int, hi: int, dtype: Any, m: int = n) -> Any:
        return torch.randint(lo, hi, (m,), generator=gen, device=device, dtype=dtype)

    def flags(p: float, m: int = n) -> Any:
        return torch.rand((m,), generator=gen, device=device) < p

    def floats(dtype: Any = torch.float32, m: int = n) -> Any:
        return torch.rand((m,), generator=gen, device=device, dtype=dtype) * 2 - 1

    def big(m: int = n) -> Any:
        return ints(-(2**40), 2**40, torch.int64, m)

    one = [BinKey(ints(-9, 1020, torch.int32), None, -7, 1024)]
    cases: List[Tuple[str, Dict[str, Any]]] = [
        ("one int32 key, shared path at 1024 segments",
         dict(keys=one, nrows=n, floats=[(floats(), None)])),
    ]
    bmask = flags(0.8)
    cases.append(("two keys, one nullable", dict(
        keys=[BinKey(ints(0, 33, torch.int32), None, 0, 32),
              BinKey(ints(5, 37, torch.int64), bmask, 5, 33)],
        nrows=n, floats=[(floats(), None)], counts=[bmask])))
    cases.append(("int8 and bool keys with wide spans", dict(
        keys=[BinKey(ints(-110, 111, torch.int8), None, -100, 201),
              BinKey(flags(0.5), flags(0.9), 0, 3)],
        nrows=n, floats=[(floats(), None)], ints=[(big(), None)])))
    cases.append(("int16 key with a wide span, global path", dict(
        keys=[BinKey(ints(-20010, 20011, torch.int16), None, -20000, 40001)],
        nrows=n, floats=[(floats(), None)])))
    cases.append(("int64 key near -2^40", dict(
        keys=[BinKey(ints(-(2**40) - 2, -(2**40) + 1000, torch.int64), None, -(2**40), 1000)],
        nrows=n, ints=[(big(), None)])))
    for fdtype in (torch.float32, torch.float64):
        cases.append((f"masked {fdtype} and int64 payloads", dict(
            keys=one, nrows=n,
            floats=[(floats(fdtype), flags(0.6)), (floats(), None)],
            ints=[(big(), flags(0.5))])))
    cmask = flags(0.7)
    cases.append(("count(*) with count(col) of a nullable column", dict(
        keys=one, nrows=n, floats=[(floats(), cmask)],
        counts=[cmask, ints(0, 4, torch.uint8)])))
    cases.append(("prefix frame with pad_n > nrows", dict(
        keys=one, nrows=n // 2, floats=[(floats(), None)], ints=[(big(), None)])))
    cases.append(("masked-layout frame", dict(
        keys=one, row_valid=flags(0.6), floats=[(floats(), None)], counts=[flags(0.5)])))
    cases.append(("four keys of four widths", dict(
        keys=[BinKey(ints(0, 3, torch.int8), None, 0, 3),
              BinKey(ints(-2, 3, torch.int16), flags(0.9), -2, 6),
              BinKey(ints(10, 17, torch.int32), None, 10, 7),
              BinKey(ints(2**35, 2**35 + 11, torch.int64), None, 2**35, 11)],
        nrows=n, floats=[(floats(), None)])))
    # offset views: every column starts one element past an aligned base,
    # so the kernel must take its 1-row tiles
    cases.append(("unaligned views", dict(
        keys=[BinKey(ints(0, 1024, torch.int32, n + 1)[1:], None, 0, 1024)],
        nrows=n, floats=[(floats(m=n + 1)[1:], flags(0.7, n + 1)[1:])],
        counts=[flags(0.5, n + 1)[1:]])))
    cases.append(("global path at 2^20 segments", dict(
        keys=[BinKey(ints(-3, (1 << 20) + 3, torch.int32), None, 0, 1 << 20)],
        nrows=n, floats=[(floats(), None)], ints=[(big(), None)])))
    cases.append(("all rows in one group", dict(
        keys=[BinKey(torch.full((n,), 5, dtype=torch.int32, device=device), None, 5, 1)],
        nrows=n, floats=[(floats(), None)])))
    cases.append(("more payloads than one launch takes", dict(
        keys=one, nrows=n,
        floats=[(floats(), flags(0.8) if j % 2 else None) for j in range(10)],
        counts=[flags(0.5) for _ in range(9)],
        ints=[(big(), None) for _ in range(9)])))
    return cases


def check_binned(got: Tuple[Any, Any, Any], want: Tuple[Any, Any, Any],
                 case: Dict[str, Any], label: str) -> float:
    """Counts and int64 sums exact, each float payload's sums within
    ``float_tolerance`` of its rows and absolute sum. Returns the largest
    absolute float difference."""
    import torch

    from fugue_tpu_torch.kernels.reference import binned_sums_reference

    (kf, kc, ki), (rf, rc, ri) = got, want
    if kc.shape != rc.shape or not torch.equal(kc, rc):
        raise SystemExit(f"FAIL {label}: counts differ")
    if ki.shape != ri.shape or not torch.equal(ki, ri):
        raise SystemExit(f"FAIL {label}: int64 sums differ")
    if kf.shape != rf.shape or kf.dtype != rf.dtype:
        raise SystemExit(f"FAIL {label}: float sums have shape {kf.shape} {kf.dtype}")
    worst = 0.0
    rows_arg = {k: case[k] for k in ("nrows", "row_valid") if k in case}
    for q, (v, m) in enumerate(case.get("floats", ())):
        _, rows, _ = binned_sums_reference(
            case["keys"], **rows_arg, counts=[] if m is None else [m]
        )
        absum = binned_sums_reference(
            case["keys"], **rows_arg, floats=[(v.abs().to(torch.float64), m)]
        )[0][0]
        tol = float_tolerance(kf.dtype, rows[-1], absum)
        diff = (kf[q].to(torch.float64) - rf[q].to(torch.float64)).abs()
        if bool((diff > tol).any()):
            raise SystemExit(f"FAIL {label}: float sums differ by up to {float(diff.max())}")
        worst = max(worst, float(diff.max()))
    return worst


# the path (and, for offset views, the tile) a phase-3 case must take
_ROUTES = {
    "one int32 key": ("shared", None),
    "global path": ("global", None),
    "int16 key": ("global", None),
    "unaligned views": ("shared", 1),
}


def check_route(kernel: Callable[..., Any], label: str, full: str) -> None:
    """On the card, the case took the path (and rows per tile) that its
    shape calls for."""
    for prefix, (path, vec) in _ROUTES.items():
        if not label.startswith(prefix) or not hasattr(kernel, "last_path"):
            continue
        if kernel.last_path != path:
            raise SystemExit(f"FAIL {full}: took the {kernel.last_path} path, expected {path}")
        if vec is not None and kernel.last_variant[0].vec != vec:
            raise SystemExit(f"FAIL {full}: took {kernel.last_variant}, expected vec={vec}")


# the variants the kernel is checked and timed in
VARIANTS = [(vec, unroll, replicas) for vec in (1, 4) for unroll in (1, 2, 4)
            for replicas in (1, 2, 4, 8)]


def binned_vs_twin(device: Any, kernel: Callable[..., Any]) -> float:
    """Every case of ``binned_cases`` at n = 1 and n = 2^20 + 37 through
    ``kernel`` (``binned_sums_cuda`` on the card) against
    ``binned_sums_reference``; the first case and the masked-layout case
    also in every variant."""
    import torch

    from fugue_tpu_torch.kernels.reference import binned_sums_reference
    from fugue_tpu_torch.kernels.segment_sums import Variant

    worst = 0.0
    for n in (1, (1 << 20) + 37):
        for label, case in binned_cases(device, n, SEED):
            want = binned_sums_reference(**case)
            runs = [None]
            if n > 1 and label.startswith(("one int32 key", "masked-layout")):
                runs += [Variant(*v) for v in VARIANTS]
            for variant in runs:
                got = kernel(**case, variant=variant)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                full = f"binned_sums {label} n={n} variant={tuple(variant or ())}"
                err = check_binned(got, want, case, full)
                worst = max(worst, err)
                if n > 1 and variant is None:
                    check_route(kernel, label, full)
            print(f"ok {label} n={n} ({len(runs)} variants) max_abs_err={err}")
    return worst


def build_main_path(
    device: Any, rows: int, groups: int, seed: int
) -> Tuple[Callable[[], Tuple[float, Any, Any]], Any, Any, float]:
    """Upload the headline frame and return ``(run_once, keys, values,
    upload_secs)``; ``run_once()`` drives transform -> aggregate ->
    as_pandas through the port's entry points and returns ``(seconds,
    result frame, result pandas)``."""
    import numpy as np
    import pandas as pd
    import torch

    from fugue_tpu_torch import aggregate, col, functions as ff
    from fugue_tpu_torch import make_execution_engine, transform

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, groups, rows).astype(np.int32)
    values = rng.random(rows).astype(np.float32)
    engine = make_execution_engine("torch", device=device)
    t0 = time.perf_counter()
    src = engine.persist(engine.to_df(pd.DataFrame({"k": keys, "v": values})))
    upload_secs = time.perf_counter() - t0

    def udf(arrs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": arrs["k"], "v2": arrs["v"] * 2.0 + 1.0}

    def run_once() -> Tuple[float, Any, Any]:
        t = time.perf_counter()
        out = transform(src, udf, schema="k:int,v2:float", engine=engine, as_fugue=True)
        agg = aggregate(
            out, partition_by="k",
            s=ff.sum(col("v2")), m=ff.avg(col("v2")), c=ff.count(col("v2")),
            engine=engine, as_fugue=True,
        )
        pdf = agg.as_pandas()  # the host endpoint is part of the run
        return time.perf_counter() - t, agg, pdf

    return run_once, keys, values, upload_secs


def main_path(
    device: Any, rows: int, groups: int, seed: int, warm_runs: int
) -> Dict[str, Any]:
    """The port's main path through its entry points, checked against
    float64 numpy. Returns timings, memory and the kernel launch count of
    the cold run."""
    import numpy as np
    import torch

    from fugue_tpu_torch.kernels.segment_sums import binned_sums_cuda

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run_once, keys, values, upload_secs = build_main_path(device, rows, groups, seed)

    binned_sums_cuda.launches = 0
    cold_secs, agg, pdf = run_once()
    launches = {"binned_sums": binned_sums_cuda.launches}
    if str(agg.schema) != "k:int,s:float,m:double,c:long":
        raise SystemExit(f"FAIL main path: schema {agg.schema}")
    binned_sums_cuda.launches = 0
    warm = [run_once()[0] for _ in range(warm_runs)]
    warm_launches = binned_sums_cuda.launches
    v2 = values * np.float32(2.0) + np.float32(1.0)
    s_ref = np.bincount(keys, weights=v2.astype(np.float64), minlength=groups)
    c_ref = np.bincount(keys, minlength=groups)
    occupied = np.nonzero(c_ref)[0]
    pdf = pdf.sort_values("k").reset_index(drop=True)
    if not np.array_equal(pdf["k"].to_numpy(), occupied):
        raise SystemExit("FAIL main path: group keys differ from the reference")
    if not np.array_equal(pdf["c"].to_numpy(), c_ref[occupied]):
        raise SystemExit("FAIL main path: counts differ from the reference")
    s_ref, m_ref = s_ref[occupied], s_ref[occupied] / c_ref[occupied]
    for name, want in (("s", s_ref), ("m", m_ref)):
        got = pdf[name].to_numpy().astype(np.float64)
        if not (np.all(np.isfinite(got)) and np.allclose(got, want, rtol=MAIN_PATH_RTOL, atol=0)):
            rel = float(np.max(np.abs(got - want) / np.abs(want)))
            raise SystemExit(f"FAIL main path: {name} off by rtol {rel}")
    best = min(warm) if warm else cold_secs
    return {
        "rows": rows,
        "groups": groups,
        "upload_secs": upload_secs,
        "cold_secs": cold_secs,
        "warm_secs": warm,
        "best_warm_secs": best,
        "rows_per_sec": rows / best,
        "max_memory_allocated": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
        "launches": launches,
        "warm_launches": warm_launches,
        "max_rel_err_s": float(np.max(np.abs(pdf["s"].to_numpy() - s_ref) / s_ref)),
    }


def time_cuda(fn: Callable[[], Any], reps: int) -> float:
    """Milliseconds per call, from CUDA events around ``reps`` calls after
    two warm-up calls."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_timing(device: Any, launches: int) -> Dict[str, Any]:
    """The fused kernel at the headline shape: n = 100M rows of an int32
    key over 1024 segments and a float32 value, a prefix frame with
    nrows = n, occupancy counted. Also prints the variant sweep and the
    time of the all-rows-in-one-group shape."""
    import torch

    from fugue_tpu_torch.kernels.reference import BinKey, binned_sums_reference
    from fugue_tpu_torch.kernels.segment_sums import Variant, binned_sums_cuda

    gen = torch.Generator(device=device).manual_seed(SEED)
    n, total = ROWS, GROUPS
    key = torch.randint(0, total, (n,), generator=gen, device=device, dtype=torch.int32)
    value = torch.rand((n,), generator=gen, device=device) * 2 + 1
    case = dict(keys=[BinKey(key, None, 0, total)], nrows=n, floats=[(value, None)])
    want = binned_sums_reference(**case)
    got = binned_sums_cuda(**case)
    path, default = binned_sums_cuda.last_path, binned_sums_cuda.last_variant
    err = check_binned(got, want, case, "binned_sums headline shape")
    ms = time_cuda(lambda: binned_sums_cuda(**case), 20)
    plain_ms = time_cuda(lambda: binned_sums_reference(**case), 5)
    # one PyTorch call for the same sums: index_add_ of the packed [n, 2]
    # payloads (value, 1.0) into a [total, 2] accumulator, over the key
    # itself as segment id (kmin = 0, every key in range)
    src = torch.stack([value, torch.ones_like(value)], dim=1)
    acc = torch.zeros((total, 2), dtype=torch.float32, device=device)
    library_ms = time_cuda(lambda: acc.zero_().index_add_(0, key, src), 5)
    del src
    nbytes = n * (4 + 4) + total * (4 + 4)  # read key, value; write sums, counts
    ops = n * 2  # one add per payload per row
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    print(f"binned_sums headline: path={path} variant={default} bytes={nbytes} ops={ops}")

    sweep = []
    for v in VARIANTS:
        variant = Variant(*v)
        check_binned(binned_sums_cuda(**case, variant=variant), want, case,
                     f"binned_sums headline variant={v}")
        taken = binned_sums_cuda.last_variant
        sweep.append({"vec": taken[0].vec, "unroll": taken[0].unroll,
                      "replicas": taken[0].replicas, "grid": taken[1],
                      "ms": time_cuda(lambda: binned_sums_cuda(**case, variant=variant), 20)})
    for row in sorted(sweep, key=lambda r: r["ms"]):
        print("sweep: " + json.dumps(row))
    one = dict(keys=[BinKey(torch.zeros_like(key), None, 0, 1)], nrows=n,
               floats=[(value, None)])
    # the twin's index_add_ adds all 10^8 values into one float32 in turn
    # and is itself off by far more than the kernel, so the oracle here is
    # the float64 sum, held at the main path's float32 bound
    kf, kc, _ = binned_sums_cuda(**one)
    truth = float(value.to(torch.float64).sum())
    one_rel = abs(float(kf[0, 0]) - truth) / truth
    if int(kc[0, 0]) != n or one_rel > MAIN_PATH_RTOL:
        raise SystemExit(f"FAIL binned_sums one group: count {int(kc[0, 0])}, rel err {one_rel}")
    one_ms = {r: time_cuda(lambda: binned_sums_cuda(**one, variant=Variant(replicas=r)), 20)
              for r in (1, 8)}
    print("one_group: " + json.dumps({"rows": n, "ms_by_replicas": one_ms,
                                      "bound_ms": bytes_ms, "rel_err": one_rel}))
    return {
        "name": "binned_sums",
        "route": "cuda",
        "source": "fugue_tpu_torch/kernels/segment_sums.cu",
        "replaces": "fugue_tpu/jax_backend/execution_engine.py:3500",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false")
    card = card_line()
    print(f"card: {card}")
    device = torch.device("cuda", torch.cuda.current_device())

    from fugue_tpu_torch.kernels import build

    t = time.perf_counter()
    reports = build.build_all()
    print(f"build: {sorted(reports)} built in {time.perf_counter() - t:.1f}s")
    for stem, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")

    from fugue_tpu_torch.kernels.segment_sums import binned_sums_cuda

    worst = max(kernel_vs_twin(device), binned_vs_twin(device, binned_sums_cuda))
    print(f"kernels checked against their twins: binned_sums (max_abs_err={worst})")

    stats = main_path(device, ROWS, GROUPS, SEED, WARM_RUNS)
    # one aggregate per run, one fused-kernel launch per aggregate
    if stats["launches"]["binned_sums"] != 1 or stats["warm_launches"] != WARM_RUNS:
        raise SystemExit(
            f"FAIL: the main path launched binned_sums {stats['launches']} "
            f"(cold) and {stats['warm_launches']} times ({WARM_RUNS} warm runs)"
        )
    stats["card"] = card
    print("main_path: " + json.dumps(stats))
    torch.cuda.empty_cache()

    entry = kernel_timing(device, stats["launches"]["binned_sums"])
    if not all(math.isfinite(entry[k]) for k in ("ms", "plain_ms", "bound_ms", "library_ms")):
        raise SystemExit("FAIL: a kernel time is not finite")
    print(f"card: {card}")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
