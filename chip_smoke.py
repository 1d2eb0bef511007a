#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fugue_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them.
2. build: compiles every CUDA source of the port with ``nvcc`` (one
   process per source, all at once).
3. kernel vs twin: the segment-sum kernel against its plain PyTorch twin
   on the same CUDA tensors, on both of its paths (shared-memory
   accumulators at 1024 segments, global atomics at 2^20), at n = 1 and
   n = 2^20 + 37, with float32/float64, count (bool and uint8) and int64
   payloads and rows outside the segment range. Counts and int64 sums must match exactly;
   float sums within the bound ``float_tolerance`` states.
4. main path: 100M rows, an int32 key over 1024 groups and a float32
   value made from seed 42 (the JAX package's headline shape,
   ``bench.py:538-545``), through ``persist(to_df)`` -> ``transform`` ->
   ``aggregate`` -> ``as_pandas``; checked against a float64 numpy
   reference. Reports cold and best-of-5 warm seconds, rows/s and peak
   device memory. The kernel launch counts are zeroed just before the
   cold run and read just after it.
5. kernel timing at the headline shape with CUDA events: the kernel, its
   plain twin, one ``index_add_`` call computing the same sums, and the
   kernel's bound from the bytes it must move.

Before the last line it prints one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import math
import subprocess
import time
from typing import Any, Callable, Dict, Tuple

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
    import torch

    from fugue_tpu_torch.kernels.reference import segment_sums_reference
    from fugue_tpu_torch.kernels.segment_sums import segment_sums_cuda

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
                if segment_sums_cuda.last_path != path:
                    raise SystemExit(
                        f"FAIL: total={total} took the "
                        f"{segment_sums_cuda.last_path} path, expected {path}"
                    )
                want = segment_sums_reference(seg, fpack, cpack, ipack, total)
                torch.cuda.synchronize(device)
                label = f"segment_sums total={total} n={n} {fdtype}"
                err = check_against_twin(got, want, fpack, seg, total, label)
                worst = max(worst, err)
                print(f"ok {label} path={path} max_abs_err={err}")
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

    from fugue_tpu_torch.kernels.segment_sums import segment_sums_cuda

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run_once, keys, values, upload_secs = build_main_path(device, rows, groups, seed)

    segment_sums_cuda.launches = 0
    cold_secs, agg, pdf = run_once()
    launches = {"segment_sums": segment_sums_cuda.launches}
    if str(agg.schema) != "k:int,s:float,m:double,c:long":
        raise SystemExit(f"FAIL main path: schema {agg.schema}")
    warm = [run_once()[0] for _ in range(warm_runs)]
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
    """The segment-sum kernel at the headline shape: n = 100M rows, 1024
    segments, one float32 payload and one count payload."""
    import torch

    from fugue_tpu_torch.kernels.reference import segment_sums_reference
    from fugue_tpu_torch.kernels.segment_sums import segment_sums_cuda

    gen = torch.Generator(device=device).manual_seed(SEED)
    n, total = ROWS, GROUPS
    seg = torch.randint(0, total, (n,), generator=gen, device=device, dtype=torch.int32)
    fpack = torch.rand((1, n), generator=gen, device=device) * 2 + 1
    cpack = torch.ones((1, n), dtype=torch.bool, device=device)
    ipack = torch.empty((0, n), dtype=torch.int64, device=device)
    got = segment_sums_cuda(seg, fpack, cpack, ipack, total)
    path = segment_sums_cuda.last_path
    want = segment_sums_reference(seg, fpack, cpack, ipack, total)
    err = check_against_twin(got, want, fpack, seg, total, "segment_sums headline shape")
    ms = time_cuda(lambda: segment_sums_cuda(seg, fpack, cpack, ipack, total), 20)
    plain_ms = time_cuda(lambda: segment_sums_reference(seg, fpack, cpack, ipack, total), 5)
    # one PyTorch call for the same sums: index_add_ of the packed [n, 2]
    # payloads (value, 1.0) into a [total, 2] accumulator
    src = torch.stack([fpack[0], cpack[0].to(torch.float32)], dim=1)
    acc = torch.zeros((total, 2), dtype=torch.float32, device=device)
    library_ms = time_cuda(lambda: acc.zero_().index_add_(0, seg, src), 5)
    nbytes = n * (4 + 4 + 1) + total * (4 + 4)  # read seg, f32, count; write sums
    ops = n * 2  # one add per payload per row
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    print(f"segment_sums headline: path={path} bytes={nbytes} ops={ops}")
    return {
        "name": "segment_sums",
        "route": "cuda",
        "source": "fugue_tpu_torch/kernels/segment_sums.cu",
        "replaces": "fugue_tpu/jax_backend/groupby.py:219",
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

    worst = kernel_vs_twin(device)
    print(f"kernels checked against their twins: segment_sums (max_abs_err={worst})")

    stats = main_path(device, ROWS, GROUPS, SEED, WARM_RUNS)
    if stats["launches"]["segment_sums"] < 1:
        raise SystemExit("FAIL: the main path did not launch segment_sums")
    stats["card"] = card
    print("main_path: " + json.dumps(stats))
    torch.cuda.empty_cache()

    entry = kernel_timing(device, stats["launches"]["segment_sums"])
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
