#!/usr/bin/env python3
"""Where the time of the port's paths goes on the card.

    python3 profile_torch_main_path.py [--only GROUP ...]

Builds each path of ``chip_smoke.py`` at 100M rows: the headline
(transform, then the binned aggregate; 1024 groups, seed 42), the
partitioned transform of ``BASELINE.json``'s second configuration (512
groups, seed 1), the sort-path aggregate on the float32 key, the wide
int64 key and the two as one key pair over 1024 groups, and on the
float32 key over 2^18 and 2^20 groups, the full group-by (every
aggregate function and two DISTINCT ones, by the headline key and with no
key), and the paths of the K6 expression program: the filtered pipeline
and the WHERE/HAVING select (100M rows) and BASELINE config 3's select
(10M rows), and the joins: config 3b (facts joined to a 256-row dimension
table on a unique key, then aggregated; 5M and 100M facts) and config
10's join (100M left rows, 200M output rows), and the string paths
(``--only strings``, 100M rows): the string predicates and group-by, the
group-by on a canonicalised UPPER, the string-keyed join to a
10,000-row dimension table and the date group-by, and the relational
paths (``--only relational``, 100M rows; the Q38/Q87 channels 100M and
50M rows): the top-n per group and the global take, distinct of the
(k, u) pairs, INTERSECT and EXCEPT DISTINCT and ALL, dropna, fillna,
sample and repartition, and the SQL statements (``--only sql``, 100M
rows; Q16's NOT IN over 80M): q67's rank with its top 100, q51's running
sum, q47's partition average, the 7-row moving average with MIN and MAX,
LAG beside a RANGE sum, ORDER BY ... LIMIT with and without OFFSET, and
NOT IN with and without a null on the right. Each is warmed up with two
runs,
then run ``RUNS`` times under ``torch.profiler``; for each the script
prints one JSON object: the
wall seconds per run, the device's busy and idle share of that wall time
(busy = the summed time of the kernels and copies the card ran), and the
device time of each kernel or copy, largest first. The profiler's full
tables go to ``profile_main_path.txt`` in the working directory. Needs a
CUDA card.
"""

import argparse
import json
import time
from typing import Any, Callable, Dict

import chip_smoke

RUNS = 3
TABLE = "profile_main_path.txt"


def profile_path(name: str, run_once: Callable[[], Any], device: Any, table: Any,
                 nrows: int = chip_smoke.ROWS) -> None:
    """Profiles ``RUNS`` runs of ``run_once`` after two warm-up runs,
    prints the path's JSON object and appends its table to ``table``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    table.write(f"== {name}\n")
    table.write(averages.table(sort_by="self_device_time_total", row_limit=60) + "\n")
    print(json.dumps({
        "path": name,
        "card": chip_smoke.card_line(),
        "rows": nrows,
        "runs": RUNS,
        "wall_secs_per_run": wall / RUNS,
        "device_ms_per_run": busy_us / RUNS / 1e3,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_ms_per_run_by_op": [
            {"op": k[:120], "ms": us / 1e3, "calls": n} for k, us, n in rows[:25]
        ],
    }))


def _groups(device: Any, table: Any) -> Dict[str, Callable[[], None]]:
    """Each group of paths by name: building it and profiling its paths."""
    import torch

    from fugue_tpu_torch.torch_backend import groupby

    rows, groups, seed = chip_smoke.ROWS, chip_smoke.GROUPS, chip_smoke.SEED

    def headline() -> None:
        run_once = chip_smoke.build_main_path(device, rows, groups, seed)[0]
        profile_path("headline", run_once, device, table)

    def config2() -> None:
        run_once = chip_smoke.build_partitioned_transform(device, rows)[0]
        profile_path("config2_partitioned_transform", run_once, device, table)

    def sort_path() -> None:
        run_for = chip_smoke.build_sort_path(device, rows, groups, seed)[0]
        for name in chip_smoke.SORT_PATH_CASES:
            profile_path(f"sort_path_{name}", run_for(name), device, table)
        # both sides of the word route's crossover between K3w and K3
        for many in (groupby.lookup_limit(4), 2 * groupby.lookup_limit(4)):
            del run_for
            torch.cuda.empty_cache()
            run_for = chip_smoke.build_sort_path(device, rows, many, seed)[0]
            profile_path(f"sort_path_float_key_{many}_groups", run_for("float_key"), device,
                         table)

    def full_groupby() -> None:
        run_full = chip_smoke.build_full_groupby(device, rows, groups,
                                                 chip_smoke.DISTINCT_VALUES, seed)[0]
        for keyed in (True, False):
            profile_path(f"full_groupby_{'keyed' if keyed else 'keyless'}", run_full(keyed),
                         device, table)

    def k6() -> None:
        run_for = chip_smoke.build_filtered_paths(device, rows, groups, seed)[0]
        for name, run_once in run_for.items():
            profile_path(name, run_once, device, table)
        del run_for, run_once
        torch.cuda.empty_cache()
        run_once = chip_smoke.build_config3(device, chip_smoke.CONFIG3_ROWS)[0]
        profile_path("config3_select", run_once, device, table, chip_smoke.CONFIG3_ROWS)

    def joins() -> None:
        for facts in (chip_smoke.JOIN3B_ROWS, rows):
            run_once = chip_smoke.build_join_3b(device, facts)[0]
            profile_path(f"join_3b_{facts}", run_once, device, table, facts)
            del run_once
            torch.cuda.empty_cache()
        run_once = chip_smoke.build_join_expand(device, chip_smoke.JOIN_EXPAND_ROWS)[0]
        profile_path("join_expand", run_once, device, table, chip_smoke.JOIN_EXPAND_ROWS)

    def strings() -> None:
        run_for = chip_smoke.build_string_paths(device, rows, chip_smoke.STRING_SEED)[0]
        for name, run_once in run_for.items():
            profile_path(name, run_once, device, table)
        del run_for, run_once
        torch.cuda.empty_cache()
        run_once = chip_smoke.build_date_groupby(device, rows, chip_smoke.DATE_SEED)[0]
        profile_path("date_groupby", run_once, device, table)

    def relational() -> None:
        q_rows = (rows, rows // 2)
        run_for = chip_smoke.build_relational_paths(device, rows, q_rows)[0]
        for name, run_once in run_for.items():
            profile_path(name, run_once, device, table,
                         q_rows[0] if name[:3] in ("int", "exc") else rows)

    def sql() -> None:
        run_for = chip_smoke.build_sql_paths(device, rows, chip_smoke.NOT_IN_ROWS)[0]
        for name, run_once in run_for.items():
            profile_path(f"sql_{name}", run_once, device, table,
                         chip_smoke.NOT_IN_ROWS if name.startswith("q16") else rows)

    return {"headline": headline, "config2": config2, "sort_path": sort_path,
            "full_groupby": full_groupby, "k6": k6, "joins": joins, "strings": strings,
            "relational": relational, "sql": sql}


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", nargs="*", metavar="GROUP",
                        help="profile only these groups of paths: headline, config2, "
                             "sort_path, full_groupby, k6, joins, strings, relational, "
                             "sql (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false")
    device = torch.device("cuda", torch.cuda.current_device())
    with open(TABLE, "w") as table:
        for name, run in _groups(device, table).items():
            if args.only and name not in args.only:
                continue
            run()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
