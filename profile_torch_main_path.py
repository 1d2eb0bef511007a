#!/usr/bin/env python3
"""Where the time of the port's main path goes on the card.

    python3 profile_torch_main_path.py

Builds the headline frame of ``chip_smoke.py`` (100M rows, 1024 groups,
seed 42), warms the path up with two runs, then runs it ``RUNS`` times
under ``torch.profiler`` and prints one JSON object: the wall seconds per
run, the device's busy and idle share of that wall time (busy = the
summed time of the kernels and copies the card ran), and the device time
of each kernel or copy, largest first. The profiler's full table goes to
``profile_main_path.txt`` in the working directory. Needs a CUDA card.
"""

import json
import time

import chip_smoke

RUNS = 3
TABLE = "profile_main_path.txt"


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false")
    device = torch.device("cuda", torch.cuda.current_device())
    run_once, _, _, _ = chip_smoke.build_main_path(
        device, chip_smoke.ROWS, chip_smoke.GROUPS, chip_smoke.SEED
    )
    run_once()
    run_once()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(RUNS):
            run_once()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
    averages = prof.key_averages()

    # the entries the card itself ran (kernels, copies, memsets); the
    # host-side operator entries would count the same time again
    rows = sorted(
        (
            (e.key, e.self_device_time_total / RUNS, e.count // RUNS)
            for e in averages
            if e.device_type == DeviceType.CUDA
        ),
        key=lambda r: -r[1],
    )
    busy_us = sum(r[1] for r in rows) * RUNS
    with open(TABLE, "w") as f:
        f.write(averages.table(sort_by="self_device_time_total", row_limit=60))
    print(json.dumps({
        "card": chip_smoke.card_line(),
        "rows": chip_smoke.ROWS,
        "runs": RUNS,
        "wall_secs_per_run": wall / RUNS,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_ms_per_run_by_op": [
            {"op": k[:120], "ms": us / 1e3, "calls": n} for k, us, n in rows[:25]
        ],
    }))


if __name__ == "__main__":
    main()
