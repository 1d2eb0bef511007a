#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fugue_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them.
2. build: compiles every CUDA source of the port with ``nvcc`` (one
   process per source, all at once). K6's kernels are generated, one for
   each program structure, and built at first use: each twin check below
   builds its programs' kernels together first (``prebuild_k6``:
   parallel ``nvcc -cubin``s), and the paths build theirs as they run
   (``k6_builds_cold`` of each path's stats).
3. kernel vs twin: every hand kernel against its plain PyTorch twin on
   the same CUDA tensors. The fused binned-sum kernel first in its one-key
   form over precomputed segment ids (``segment_sums_cuda``), on both of
   its paths, then every case of ``binned_cases`` (one to four keys of
   every width, nullable keys, wide spans, masked payloads, prefix and
   masked-layout frames, offset views, one group, more payloads than one
   launch takes) and two of them in every variant of the sweep, at n = 1
   and 2^20 + 37: counts and int64 sums exactly, float sums within
   ``float_tolerance``. Then, exactly, K1 in every case of
   ``bin_factorize_cases`` and the sort path's kernels in every case of
   ``sort_cases`` (``sort_vs_twin``: KW, K2w, K3w and K3 on the word
   route, K2 and K3 on the wide route, K2 as the route calls it, over the
   first code in sorted order where the sort gives it), up to 100M rows,
   with each case's route printed, and K2 at its edges
   (``sort_boundaries_edges``: one group, every row its own group, groups
   across tile boundaries, masked frames, a short prefix, strided int64
   words, an unaligned order, n = 1 and off the tile). Then K4 ``segment_extrema`` bit for bit and K5
   ``segment_sq_dev`` within rtol 1e-10 of its twin summed by chunks
   (``sq_dev_twin``) in every case of ``reduce_cases`` (every payload
   dtype, masked payloads, NaN, -0.0, +0.0 and infinities, prefix and
   masked frames, one segment with every payload dtype and with every
   row NaN or masked, Zipf(1.1) over 1024 segments, sorted runs across a
   thread's, a warp's and a block's rows, views at an unaligned offset,
   2^20 segments in global tables, more payloads than one launch takes)
   at n = 1, 31, 33, 2^20 + 37, 10M and 100M. Then K6
   ``expr_program`` against its twin (``expr_program_vs_twin``): every
   program of ``k6_cases`` (every operator family over every dtype, with
   nulls, NaN, -0.0, infinities and integer extremes, in columns mode, and
   filter conditions over prefix rows and a ``row_valid``; programs over
   the interpreter's old caps: 140 instructions, 17 outputs, 40 live
   values, 4,100 immediates whose parameters go through device memory)
   at n = 1 and 2^20 + 37, and the paths' programs (``k6_path_programs``) at 1,
   2^20 + 37, 10M and 100M rows: masks, filter flags and counts exactly,
   values bit for bit, the float functions within ``K6_FUNC_RTOL``. Then
   K6's LUT family exactly (``lut_vs_twin``): every program of
   ``k6_string_cases`` over string codes with nulls (LIKE with ``%``,
   ``_`` and regex characters; every compare against a literal in the
   dictionary, one absent and one between entries; columns with
   different dictionaries; IN lists; LENGTH; a canonicalising UPPER; a
   two-column CONCAT; a LIKE by a pattern column; NULLIF; filters over
   prefix rows and a ``row_valid``; nine tables) and the harmonize
   re-coding of a join key, at 1, 2^20 + 37 and 100M rows; and one
   binary a structure (``k6_build_once``: filters that differ in a
   threshold, LIKEs over other dictionaries, each group built at most
   once). Then
   the join kernels exactly (``join_vs_twin``): K7 ``join_build`` (counts
   and slots) and K8 ``join_probe`` (semi, anti, unique and expand, inner
   and outer, and NOT IN; each case at the place of its table that
   ``probe_place`` picks, ``last_path`` asserted, and each mode seen at
   the places of its smallest and its largest table) over
   ``JOIN_SIDE_SEGMENTS`` (K7's shared, global and slab routes, the slab
   buckets checked) with sentinel rows, null keys,
   prefix, short-prefix and masked layouts, probe rows with no match, one
   key with 10^6 build rows, counts of 254, 255 and 256 (K8's byte entry
   and its escape) and one segment of 25M holding every row; K9
   ``join_expand`` on pairs
   (inner, outer), a cross join, a skewed key at a tile's start and from
   inside a tile, one probe row in 50 matching, one output, and an
   unmatched probe row at a tile's first output (inner and outer); K10
   ``gather_rows`` over every width, with and without masks, by indices
   with and without -1, with duplicates, a permutation, in order and over a
   source under L2, each case's route printed and the slab route's buckets
   checked; at 1, 2^20 + 37, 10M and 100M rows. Then the row-selection kernels
   exactly (``row_select_vs_twin``): K11, KW's presort mode (float keys
   with ties, -0.0, NaN and nulls, descending and nulls first, narrowed,
   int64, uint8, bool and string-rank keys, a float64 key split over two
   words, the "not real" bit alone), K12 ``rank_keep`` over sorted
   segments (no segment with limits from 0 past the rows; int32 ids with
   the sentinel, per-segment limits below and at least, also of 0; one
   limit walked by (segment, rank) pairs and over every position; the
   first presort word, int64 and int32, and the "not real" bit alone;
   one segment, none, rows in order), K13 ``first_row_mask`` (every,
   occupied, hit and miss segments, first rows beyond the mask, adjacent
   first rows, no segment) and K14
   ``null_count_keep`` (0, 1, 4, 70 and 300 masks; any, all, thresh at
   and beyond each end; ``nrows`` inside a group of 16 rows; masks and
   ``row_valid`` one byte off, its scalar route; each case's route
   checked), at 1, 2^14 + 7, 2^20 + 37 and 100M rows; and the order of a
   three-word presort against ``numpy.lexsort`` up to 2^20 + 37 rows.
   Then one dropna of 64 masked columns under ``torch.profiler``, which
   must show K14's launch and no host-to-device copy
   (``dropna_copies``). The join check also holds K7's
   side counts and K8's NOT IN mode (``not_in_vs_twin``: as built, an
   empty build side, a null on it). Then the window kernels
   (``window_vs_twin``): K15 ``window_rank`` (every ranking function) and
   K16 ``window_frame`` (count, COUNT(*), sum, avg, min, max, first, last
   and nth value over the running frame, ROWS, GROUPS and RANGE frames of
   ``WINDOW_FRAMES``, of a float and an int argument with nulls and NaN,
   lag/lead with defaults) over a partitioned masked frame ordered by an
   int key with ties and nulls, one partition holding every row ordered
   by a float key with NaN and nulls descending, nulls first, and a
   two-key order; every case at 1 and 2^20 + 37 rows, the SQL phase's
   shapes and one frame of each unit at 100M, and again below one of
   K16's slabs and at one slab and a row (``window_slab_cases``); exactly
   but the float64 frame sums (``FRAME_SUM_RTOL`` and
   ``frame_sum_atol``), and each call's slab buckets holding their slabs'
   rows (``check_fill``; K3 too, in ``sort_vs_twin`` and at its slabs'
   edges over random permutations, ``sort_finish_slab_cases``). Then K17
   ``comap_presence`` and K18 ``comap_rows`` exactly (``comap_vs_twin``:
   1, 2, 3 and 33 members, every zip type, prefix and masked layouts, a
   member with no real row, sentinel ids, 1 and 2^24 segments; K17 on
   its vector route and with ``seg`` one element off on its scalar one;
   the tile edges: a member boundary at a tile's edge and inside a tile, an
   empty member, members of 1 and 3 rows, 65 members; at 1, 2^20 + 37 and
   100M rows; K18 over 2^31 - 1 rows, whose top tile ends at 2^31,
   ``comap_top_tile``) and K19 ``stream_fold``
   (``stream_fold_vs_twin``: one and two keys, masked int64 and float64
   payloads, int64 values beyond 2^53, folds before and after a rebase;
   at 1, 2^20 + 37 and 10M rows; counts, int64 sums and extrema exactly,
   float64 sums within ``FOLD_RTOL``).
4. paths through the entry points, each with every launch count zeroed
   just before its cold run and read just after, checked against numpy:
   the main path (100M rows, an int32 key over 1024 groups and a float32
   value from seed 42, the JAX package's headline shape,
   ``bench.py:538-545``: ``persist(to_df)`` -> ``transform`` ->
   ``aggregate`` -> ``as_pandas``; one fused-kernel launch); the config-2
   partitioned transform at 10M and 100M rows (K1 once, then cached); the
   sort-path aggregate at 100M rows over 1024 groups on a float32 key and
   an int64 key (the word route: KW, K2w, K3w once each), on the two as
   one key pair (the wide route: K2, K3) and over 2^15 and 2^16 float32
   groups, the two sides of ``groupby.lookup_limit`` (K3w; K3); the full
   group-by at 100M rows (the headline frame and UDF with an int32 ``u``
   over [0, 10000) passed through; sum, count(*), min, max, first, last,
   stddev, var_pop, median of ``v2`` and count/sum DISTINCT of ``u``, by
   ``k`` and with no key: K1, the word route of the (k, u) pairs, the fused
   sums twice, K4, K5 and the median's sort word), checked against a
   float64 numpy oracle at the full size. Each cold run is split into
   stages (``StageTimer``). Then K6's paths (``filtered_paths``,
   ``config3_select``): the filtered pipeline at 100M rows (the headline
   UDF passing ``u`` and ``x`` through, a filter, an assign of a CASE
   WHEN and a cast, the aggregate by ``k``: K6 twice, the fused sums
   once, the filter's count still lazy after the run), the WHERE/HAVING
   select at 100M rows (K6 three times) and BASELINE config 3's select at
   10M rows (no K6), each against numpy, their launches asserted
   (``K6_PATH_LAUNCHES``). Then the joins through ``ft.join``
   (``JOIN_PATH_LAUNCHES``): config 3b (``join_3b``: facts joined to a
   256-row dimension table on a unique key, then aggregated; 5M and 100M
   facts; the unique-right route, no readback, the count still lazy when
   the aggregate starts), config 10's join (``join_expand``: 100M left
   rows, 2 right rows a key, 200M output rows, one readback; checked by an
   aggregate of the output against numpy, and row for row at 10M), left,
   right and full outer, semi and anti at 10M by 5M rows with null keys
   and keys that miss, and a cross join of 10^4 by 10^3 rows, each row for
   row against a numpy sort-merge (``numpy_join``). Then the string paths
   (``string_paths``, ``STRING_PATH_LAUNCHES``), their columns built in
   arrow from codes: BASELINE config 1 at 2M (as published) and 100M rows
   (the ``_value_dict`` remap, schema ``"*"``, no launch); at 100M rows of
   10,000 SKUs with 5 % nulls, the string predicates and group-by
   (``SELECT s, SUM(v), COUNT(*) WHERE s LIKE 'sku-1%' AND s < 'sku-15000'
   GROUP BY s``), a group-by on ``UPPER(SUBSTR(s, 1, 6))`` beside
   ``LENGTH(s)``, the inner join to a 10,000-row dimension table whose
   dictionary has another order and 10 % keys no fact holds (one
   harmonize launch, one readback), then SUM/COUNT by ``s``; and the
   date group-by (1,096 days, a timestamp with 3 % nulls: SUM, AVG, COUNT,
   MIN and MAX by ``d``), each against numpy/pandas. Then the relational
   paths (``relational_paths``, ``RELATIONAL_PATH_LAUNCHES``) at 100M
   rows: ``take(n=10, presort="v desc", partition="k")`` on the headline
   frame; the global take ``presort="k asc, v desc"``, nulls first, with
   5 % null ``v``; ``distinct`` of the full group-by's (k, u) pairs;
   INTERSECT and EXCEPT, DISTINCT and ALL, in the shape of TPC-DS queries
   38 and 87 (``last_name``, ``first_name``, ``d_date`` of two channels
   of 100M and 50M rows over 10,000 and 1,000 names and 365 days, seed
   13; ending in the count, as the queries do); dropna (any, all,
   thresh) and fillna (a scalar, a dict, a string absent from the
   dictionary) over four float64 columns with 5 % nulls and 1 % NaN and
   a string; ``sample(frac=0.01)`` and ``sample(n=1_000_000)`` (exact
   counts, the same rows for the same seed); ``repartition`` by hash of
   ``k`` into 8 and at random; each against numpy, with the device time
   of one warm run from ``torch.profiler``. Each reports cold and
   best-of-5 warm seconds, rows/s, peak device memory and its route.
   Then the SQL phase (``sql_paths``, ``SQL_PATH_LAUNCHES``) through
   ``raw_sql`` on the headline frame at 100M rows with a day over 1,096
   days: TPC-DS q67's ``RANK() OVER (PARTITION BY k ORDER BY v DESC)``
   with ``WHERE rk <= 100`` in an outer SELECT, q51's running ``SUM(v)``
   by day, q47/q89's ``AVG(v) OVER (PARTITION BY k)``, a 7-row moving
   average with MIN and MAX, ``LAG(v, 1, 0)`` beside a RANGE 10 days sum,
   ``ORDER BY v DESC, k LIMIT 100`` with and without ``OFFSET 1000000``,
   and TPC-H Q16's NOT IN (80M partsupp rows against 500 of 1M
   suppliers, and with a null on the right, which keeps no row); each
   against numpy, with cold and best-of-5 warm seconds to the result
   frame on the card and its count, launches, the synchronizing
   operations of one run, peak memory and device time. Then the zip
   paths through ``ft.zip`` + ``ft.transform`` (``zip_paths``,
   ``COMAP_PATH_LAUNCHES``): BASELINE config 4 (``bench.py:921-998``,
   seed 3) at 2,000 groups of 50 and at 100M rows (2M groups of 50, b 2M
   rows), left, right and full outer zips of 10M by 5M rows whose keys
   miss on each side, a three-member inner zip, a string key whose
   dictionaries differ, a row-aligned output and a cross zip of 10^4 by
   10^3 rows, each against pandas; then the streaming aggregate
   (``stream_path``): 200M rows in 20 chunks of 10M through
   ``ft.aggregate`` of a ``LocalDataFrameIterableDataFrame``, sum, count,
   min, max and avg of an int64 and a float64 payload with 2 % nulls and
   count(*) by (store, item), about 1M groups, at least one rebase, K19
   once a chunk, against numpy accumulated chunk by chunk, its peak
   memory held below the accumulators plus two chunks and printed beside
   the whole frame's bytes, its host work a chunk timed alone
   (``host_ms_a_chunk``) and a warm run traced in a fresh process
   (``traced_stream``): its chunks' uploads pinned copies only, and their
   device ms a chunk (``upload_ms_a_chunk``). Then the types phase
   (``types_paths``, ``types_sku``, ``types_host``): 100M rows of a
   uint32 key above 2^31, a uint64 column half above 2^63, float16 and
   float32 through the binned group-by, a count by the uint64 (the word
   route), a filter, a top-100 take, a join against 1M rows and
   ``alter_columns``; config 1's SKU column as numeric text cast to int
   and back on the card; 10M rows with binary, list and decimal host
   columns through a filter, ``head``, the export and a save and load;
   each against numpy or pyarrow, its launches held to
   ``TYPES_PATH_LAUNCHES``; and, with the twins, the kernels at their new
   dtype codes (``types_vs_twin``).
5. timing with CUDA events at the paths' shapes: each kernel beside its
   plain twin, one PyTorch call computing the same function where there
   is one, and its bound from the bytes it must move; the fused kernel's
   variant sweep and one-group shape; ``torch.sort`` of the int32 and
   int64 sort words; and K3's two routes over 1024 to 10^8 groups
   (``k3_routes``), each on a line of its own; K4 and K5 over one
   segment (the keyless aggregate), 1024 uniform segments (the full
   group-by's), Zipf(1.1) over 1024 and 2^20 segments (``reduce_timing``),
   the median's two routes (``median_timing``) and the
   DISTINCT mask by K13 (``distinct_mask_timing``, beside the gather it
   replaced and ``index_fill_``), each beside its bound;
   K6's path programs at 100M rows (``expr_timing``: time, twin time and
   the kernels the twin launches, bytes bound) and programs of growing
   size (``k6_scaling``); K7-K10 at the expansion join's shapes
   (``join_timing``), beside ``torch.sort`` of the right side's segment
   ids, K8 in unique mode at 100M rows and K9 on a cross join and a
   skewed key; K6's LUT programs at 100M rows (``lut_timing``: LIKE, a
   LIKE by a pattern column, a compare of two columns, LENGTH, the
   canonicalising re-coding and the harmonize re-coding), each beside its
   twin, ``index_select`` of its table and its bound, and on ``shifted``
   views (K6's scalar path); K11-K14 and the
   fillna program of K6 (``relational_timing``), each beside its twin, its
   bound and, where one PyTorch call computes the same function,
   ``index_fill_`` (K12 at ``sample``'s, the top-n take's and EXCEPT ALL's
   shapes, K13; also after the ``zero_()`` the kernel's work includes) or
   ``torch.all`` (K14, also with a ``row_valid``, at one mask and at 70
   masks with thresh: ``null_count_shapes``); K2 at the set operations' shape
   (``setop_boundaries_timing``: 150M stacked rows, three int32 codes) and
   K2 and K9 with each launch's device time; K3's ``scatter_`` also with
   its ``where``, and
   K3 and K16's running sum with each launch's device time, K3 also over
   a random permutation (``order_scatter_timing``);
   K15, K16 and K8's NOT IN mode at the SQL phase's shapes
   (``window_timing``), with K16's other routes and its running sum's
   equal work in three PyTorch calls (``index_select`` by the order,
   ``cumsum``, ``scatter_`` back), ``device_sort`` against
   ``torch.sort`` and ``gather_indices`` by a permutation (K10's slab
   route, beside its direct route) against ``index_select``; K17
   and K18 at config 4's 100M-row shape (``comap_timing``: K17 beside a
   ``bincount`` of its (segment, member) pairs, also at 33 members over
   2^24 segments and a masked random layout, ``presence_shapes``) and
   K19 at a streaming chunk (``stream_timing``:
   beside ``index_add_`` of one payload's sum); the fused kernel, K4 and
   K6 over float16 beside float32 (``types_timing``).

Before the last lines it prints K6's builds, their seconds and the cold
seconds of its first path (``k6_builds:``); before the last line one JSON
object ``{"kernels": [...]}``; the last line is ``{"ok": true, "device":
{...}}``.
"""

import json
import math
import subprocess
import sys
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple

ROWS = 100_000_000
GROUPS = 1024
CONFIG2_ROWS = 10_000_000  # BASELINE.json's second configuration
SEED = 42
WARM_RUNS = 5
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the
# tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12  # float64 outside the tensor cores
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


def _draws(device: Any, n: int, seed: int) -> Tuple[Callable[..., Any], ...]:
    """Random columns of ``n`` rows from one seeded generator on
    ``device``: ``ints(lo, hi, dtype)``, ``flags(p)`` (True with
    probability p), ``floats(dtype)`` in [-1, 1) and ``big()``, int64 in
    [-2^40, 2^40); each takes another row count as ``m``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(lo: int, hi: int, dtype: Any, m: int = n) -> Any:
        return torch.randint(lo, hi, (m,), generator=gen, device=device, dtype=dtype)

    def flags(p: float, m: int = n) -> Any:
        return torch.rand((m,), generator=gen, device=device) < p

    def floats(dtype: Any = torch.float32, m: int = n) -> Any:
        return torch.rand((m,), generator=gen, device=device, dtype=dtype) * 2 - 1

    def big(m: int = n) -> Any:
        return ints(-(2**40), 2**40, torch.int64, m)

    return ints, flags, floats, big


def binned_cases(device: Any, n: int, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """The fused kernel's phase-3 cases at ``n`` rows: ``(label, keyword
    arguments of binned_sums_cuda / binned_sums_reference)``. Keys reach
    beyond their ``[kmin, kmin + span)`` on some rows, so the kernel must
    drop those rows."""
    import torch

    from fugue_tpu_torch.kernels.reference import BinKey

    ints, flags, floats, big = _draws(device, n, seed)
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


def _wrappers() -> List[Callable[..., Any]]:
    """Every kernel wrapper, each with its launch count."""
    from fugue_tpu_torch.kernels import (
        comap,
        expr_program,
        factorize,
        gather,
        join,
        row_select,
        segment_reduce,
        segment_sums,
        stream,
        window,
    )

    return [segment_sums.binned_sums_cuda, factorize.bin_factorize_cuda,
            factorize.sort_word_cuda, factorize.presort_word_cuda,
            factorize.sort_word_boundaries_cuda,
            factorize.sort_word_lookup_cuda, factorize.sort_boundaries_cuda,
            factorize.sort_finish_cuda, segment_reduce.segment_extrema_cuda,
            segment_reduce.segment_sq_dev_cuda, expr_program.expr_program_cuda,
            join.join_build_cuda, join.join_probe_cuda, join.join_expand_cuda,
            gather.gather_rows_cuda, row_select.rank_keep_cuda,
            row_select.first_row_mask_cuda, row_select.null_count_keep_cuda,
            window.window_rank_cuda, window.window_frame_cuda, comap.comap_presence_cuda,
            comap.comap_rows_cuda, stream.stream_fold_cuda]


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, and K6's filter-mode launches
    (``expr_program_filter``, part of ``expr_program``'s)."""
    from fugue_tpu_torch.kernels.expr_program import expr_program_cuda

    counts = {f.__name__[: -len("_cuda")]: f.launches for f in _wrappers()}
    counts["expr_program_filter"] = expr_program_cuda.filter_launches
    return counts


def zero_launches() -> None:
    """Sets every kernel wrapper's launch counts to 0."""
    from fugue_tpu_torch.kernels.expr_program import expr_program_cuda

    for f in _wrappers():
        f.launches = 0
    expr_program_cuda.filter_launches = 0


def bin_factorize_cases(device: Any, n: int, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """K1's cases at ``n`` rows: ``(label, keyword arguments of
    bin_factorize_cuda / bin_factorize_reference)``. The first key reaches
    past its span on some rows, which then have no bin."""
    import torch

    from fugue_tpu_torch.kernels.reference import BinKey

    ints, flags, _, _ = _draws(device, n, seed)
    return [
        ("one int32 key, 1024 bins, shared path", dict(
            keys=[BinKey(ints(-3, 1027, torch.int32), None, 0, 1024)], nrows=n)),
        ("four keys, one of them nullable", dict(
            keys=[BinKey(ints(0, 3, torch.int8), None, 0, 3),
                  BinKey(ints(-2, 3, torch.int16), flags(0.9), -2, 6),
                  BinKey(ints(10, 17, torch.int32), None, 10, 7),
                  BinKey(ints(2**35, 2**35 + 11, torch.int64), None, 2**35, 11)],
            nrows=n)),
        ("nullable key, prefix frame with nrows < n", dict(
            keys=[BinKey(ints(0, 100, torch.int32), flags(0.8), 0, 101)], nrows=n // 2)),
        ("masked frame", dict(
            keys=[BinKey(ints(-50, 50, torch.int64), None, -50, 100)], row_valid=flags(0.6))),
        ("2^22 bins, global path", dict(
            keys=[BinKey(ints(0, 1 << 22, torch.int32), None, 0, 1 << 22)], nrows=n)),
    ]


def sort_cases(device: Any, n: int, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """The sort path's cases at ``n`` rows: ``(label, {"keys": [(values,
    null mask)], and nrows or row_valid})``, keys as a frame holds them."""
    import torch

    ints, flags, _, big = _draws(device, n, seed)
    table = torch.tensor([float("nan"), -0.0, 0.0, 1.5, -2.25, 3.0e38, float("-inf"), 7.0],
                         device=device)
    pool = big(max(1, n // 8))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return [
        ("all rows in one group", dict(
            keys=[(torch.full((n,), 7, dtype=torch.int32, device=device), None)], nrows=n)),
        ("all rows distinct", dict(
            keys=[(torch.randperm(n, generator=gen, device=device).to(torch.int32), None)],
            nrows=n)),
        ("float32 keys with NaN, -0.0 and +0.0", dict(
            keys=[(table[ints(0, 8, torch.int64)], None)], nrows=n)),
        ("nullable float64 keys", dict(
            keys=[(table.double()[ints(0, 8, torch.int64)], flags(0.8))], nrows=n)),
        ("nullable int32 keys", dict(
            keys=[(ints(0, 50, torch.int32), flags(0.7))], nrows=n)),
        ("int64 keys spanning +-2^40", dict(
            keys=[(pool[ints(0, pool.shape[0], torch.int64)], None)], nrows=n)),
        ("two keys, float32 and int64", dict(
            keys=[(table[ints(0, 8, torch.int64)], None), (ints(-3, 3, torch.int64) * 2**33, None)],
            nrows=n)),
        ("masked frame", dict(keys=[(ints(0, 100, torch.int32), None)], row_valid=flags(0.6))),
        ("prefix frame with nrows < n", dict(
            keys=[(pool[ints(0, pool.shape[0], torch.int64)], None)], nrows=n // 2 + 1)),
    ]


def _rows_of(case: Dict[str, Any]) -> Dict[str, Any]:
    return {k: case[k] for k in ("nrows", "row_valid") if k in case}


def bin_factorize_vs_twin(device: Any, sizes: Tuple[int, ...]) -> None:
    """K1 against ``bin_factorize_reference`` in every case of
    ``bin_factorize_cases``: segment ids, first rows, occupied bins and
    the count exactly, and the path the bin count calls for."""
    import torch

    from fugue_tpu_torch.kernels.factorize import bin_factorize_cuda
    from fugue_tpu_torch.kernels.reference import bin_factorize_reference

    for n in sizes:
        for label, case in bin_factorize_cases(device, n, SEED):
            got = bin_factorize_cuda(**case)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            want = bin_factorize_reference(**case)
            for name, g, w in zip(("seg", "first_idx", "occupied", "count"), got, want):
                if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
                    raise SystemExit(f"FAIL bin_factorize {label} n={n}: {name} differs")
            path = "global" if label.startswith("2^22") else "shared"
            if bin_factorize_cuda.last_path != path:
                raise SystemExit(f"FAIL bin_factorize {label} n={n}: took the "
                                 f"{bin_factorize_cuda.last_path} path, expected {path}")
            print(f"ok bin_factorize {label} n={n} path={path} groups={int(want[3])}")


def _equal(label: str, names: Tuple[str, ...], got: Tuple[Any, ...],
           want: Tuple[Any, ...]) -> None:
    import torch

    for name, g, w in zip(names, got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise SystemExit(f"FAIL {label}: {name} differs")


def sort_vs_twin(device: Any, sizes: Tuple[int, ...]) -> None:
    """The sort path's kernels against their twins in every case of
    ``sort_cases`` at each size, exactly, on the route the case's key width
    gives (``reference.word_bits``). Word route: KW against
    ``sort_word_reference``; after ``torch.sort`` of the word, K2w against
    ``sort_word_boundaries_reference`` (sorted ids, count, and each
    group's word and first row), K3w against ``sort_word_lookup_reference``
    (whatever the group count: in shared memory where the table fits, else
    in global memory) and K3 over K2w's sorted ids against
    ``sort_finish_reference``, and the two routes of K3 against each
    other. Wide route: K2 and K3 against ``sort_boundaries_reference`` and
    ``sort_finish_reference`` over the port's ``sort_codes`` and
    ``lex_sort``'s order."""
    import torch

    from fugue_tpu_torch.kernels.factorize import (
        sort_boundaries_cuda, sort_finish_cuda, sort_word_boundaries_cuda, sort_word_cuda,
        sort_word_lookup_cuda,
    )
    from fugue_tpu_torch.kernels.reference import (
        has_unreal_rows, sort_boundaries_reference, sort_finish_reference,
        sort_word_boundaries_reference, sort_word_lookup_reference, sort_word_reference,
        word_bits,
    )
    from fugue_tpu_torch.torch_backend import groupby

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for n in sizes:
        for label, case in sort_cases(device, n, SEED):
            rows = _rows_of(case)
            full = f"sort {label} n={n}"
            unreal = has_unreal_rows(n, rows.get("nrows"), rows.get("row_valid"))
            if word_bits(case["keys"], unreal) > 64:
                codes = groupby.sort_codes(case["keys"])
                order, first = groupby.lex_sort(codes, **rows)
                got = sort_boundaries_cuda(codes, order, **rows, first_sorted=first)
                want = sort_boundaries_reference(codes, order, **rows)
                num = int(want[1])
                got2 = sort_finish_cuda(want[0], order, num)
                sync()
                check_fill(full, sort_finish_cuda.last_fill, n, sort_finish_cuda.last_shift)
                _equal(full, ("seg_sorted", "count", "seg", "first_idx"),
                       got + got2, want + sort_finish_reference(want[0], order, num))
                route = "wide" if first is None else "wide, first code sorted"
                del codes, got, want, got2, first
            else:
                sw = sort_word_cuda(case["keys"], **rows)
                sync()
                want_sw = sort_word_reference(case["keys"], **rows)
                _equal(full, ("word",), (sw.word,), (want_sw.word,))
                if sw.real_below != want_sw.real_below:
                    raise SystemExit(f"FAIL {full}: real_below {sw.real_below} "
                                     f"!= {want_sw.real_below}")
                sorted_words, order = torch.sort(sw.word, stable=True)
                got = sort_word_boundaries_cuda(sorted_words, order, real_below=sw.real_below)
                sync()
                want = sort_word_boundaries_reference(sorted_words, order,
                                                      real_below=sw.real_below)
                num = int(want[3])
                _equal(full, ("seg_sorted", "count"), got[2:], want[2:])
                _equal(full, ("uniq", "first_idx"), (got[0][:num], got[1][:num]),
                       (want[0][:num], want[1][:num]))
                seg = sort_word_lookup_cuda(sw.word, got[0], num, real_below=sw.real_below)
                path = sort_word_lookup_cuda.last_path
                scattered = sort_finish_cuda(got[2], order, num)
                sync()
                check_fill(full, sort_finish_cuda.last_fill, n, sort_finish_cuda.last_shift)
                seg_want = sort_word_lookup_reference(sw.word, want[0], num,
                                                      real_below=sw.real_below)
                _equal(full, ("seg (lookup)",), (seg,), (seg_want,))
                _equal(full, ("seg (scatter)", "first_idx (scatter)"), scattered,
                       sort_finish_reference(want[2], order, num))
                _equal(full, ("seg lookup vs scatter", "first_idx"),
                       (seg, want[1][:num]), scattered)
                route = f"word{8 * sw.word.element_size()}, K3w {path} table"
                del sw, want_sw, sorted_words, got, want, seg, scattered, seg_want
            if label == "all rows in one group" and num != 1:
                raise SystemExit(f"FAIL {full}: {num} groups")
            if label == "all rows distinct" and num != n:
                raise SystemExit(f"FAIL {full}: {num} groups")
            print(f"ok {full} route={route} groups={num}")
            del order


K2_TILE = 2048  # K2's positions a tile (kBoundTile in factorize.cu)


def sort_boundaries_edge_cases(device: Any, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """K2's edge cases: ``(label, {"codes", "order", and nrows or
    row_valid})``, each order ``lex_sort``'s over its codes. One group;
    every row its own group (in row order and permuted); a group that
    straddles each tile boundary (equal codes at positions ``K2_TILE * t -
    1`` and ``K2_TILE * t``, three codes of which only the last changes
    there); a masked frame whose real rows end inside a thread's positions
    and one with no real row; a prefix frame with nrows < n; an int64 key
    as two strided int32 word views and as an int64 view of stride 2; an
    order that is not 16-byte aligned (a view one element in); n = 1, a
    tile less one, a tile plus one, three tiles plus five and fifty tiles
    plus seven. Where ``lex_sort`` gives the first code in sorted order (a
    prefix frame with no padding), each case also runs with it, as the
    wide route calls K2."""
    import torch

    from fugue_tpu_torch.torch_backend import groupby

    gen = torch.Generator(device=device).manual_seed(seed)
    cases: List[Tuple[str, Dict[str, Any]]] = []

    def add(label: str, codes: List[Any], **rows: Any) -> None:
        order, first_sorted = groupby.lex_sort(codes, **rows)
        cases.append((label, dict(codes=codes, order=order, **rows)))
        if first_sorted is not None:  # the wide route's call: code 0 in sorted order
            cases.append((f"{label}, first code sorted",
                          dict(codes=codes, order=order, first_sorted=first_sorted, **rows)))

    for n in (1, K2_TILE - 1, K2_TILE + 1, 3 * K2_TILE + 5, 50 * K2_TILE + 7):
        i32 = torch.arange(n, dtype=torch.int32, device=device)
        add(f"one group n={n}", [torch.zeros((n,), dtype=torch.int32, device=device)], nrows=n)
        add(f"every row its own group n={n}", [i32], nrows=n)
        perm = torch.randperm(n, generator=gen, device=device).to(torch.int32)
        add(f"every row its own group, permuted n={n}", [perm], nrows=n)
        # sorted position p holds (p + 1) // 2: positions 2k - 1 and 2k
        # share a group, so every tile boundary falls inside one
        pair = (perm + 1) // 2
        add(f"groups across tile boundaries n={n}",
            [torch.zeros_like(i32), pair // 1500, pair], nrows=n)
        few = torch.randint(0, 5, (n,), generator=gen, device=device, dtype=torch.int32)
        rv = torch.rand((n,), generator=gen, device=device) < 0.37
        add(f"masked frame n={n}", [few, perm], row_valid=rv)
        add(f"masked frame, no real row n={n}", [few],
            row_valid=torch.zeros((n,), dtype=torch.bool, device=device))
        add(f"prefix frame with nrows < n n={n}", [few, perm], nrows=n // 2 + 1)
        wide = torch.randint(-(2**40), 2**40, (n,), generator=gen, device=device)
        wide = wide[torch.randint(0, max(n // 3, 1), (n,), generator=gen, device=device)]
        words = wide.view(torch.int32)
        add(f"int64 key as strided int32 words n={n}", [words[1::2], words[0::2]], nrows=n)
        pairs = torch.stack([wide, wide.flip(0)], dim=1)
        add(f"int64 codes of stride 2 n={n}", [pairs[:, 0], pairs[:, 1]], nrows=n)
        if n > 1:
            buf = torch.empty((n + 1,), dtype=torch.int64, device=device)
            label = f"order not 16-byte aligned n={n}"
            add(label, [few, perm], nrows=n)
            buf[1:] = cases[-1][1]["order"]
            for _, case in cases[-2:]:
                case["order"] = buf[1:]
    return cases


def sort_boundaries_edges(device: Any, seed: int = SEED) -> int:
    """K2 against ``sort_boundaries_reference`` in every case of
    ``sort_boundaries_edge_cases``, exactly (ids and count), with one
    launch a call; returns the number of cases."""
    from fugue_tpu_torch.kernels.factorize import sort_boundaries_cuda
    from fugue_tpu_torch.kernels.reference import sort_boundaries_reference

    cases = sort_boundaries_edge_cases(device, seed)
    for label, case in cases:
        before = sort_boundaries_cuda.launches
        got = sort_boundaries_cuda(**case)
        want = sort_boundaries_reference(**case)
        _equal(f"sort_boundaries {label}", ("seg_sorted", "count"), got, want)
        if sort_boundaries_cuda.launches != before + 1:
            raise SystemExit(f"FAIL sort_boundaries {label}: launches counted "
                             f"{sort_boundaries_cuda.launches - before}")
    print(f"ok sort_boundaries edges: {len(cases)} cases equal")
    return len(cases)


def check_fill(label: str, fill: Any, n: int, shift: int) -> None:
    """A store through the order by slab (``order_scatter.cuh``) left each
    slab's bucket holding exactly its slab's rows (the order is a
    permutation)."""
    import torch

    slabs = -(-n >> shift)
    want = torch.full((slabs,), 1 << shift, dtype=torch.int32, device=fill.device)
    want[-1] = n - ((slabs - 1) << shift)
    if fill.shape != want.shape or not torch.equal(fill, want):
        raise SystemExit(f"FAIL {label}: bucket counts differ from the slabs' rows")


def slab_sizes(shift: int) -> Tuple[int, ...]:
    """The edges of slabs of 2^shift rows: below one slab, one slab, one
    slab and a last slab of one row, three slabs and a short one."""
    slab = 1 << shift
    return (slab // 2 + 3, slab, slab + 1, 3 * slab + 17)


def sort_finish_slab_cases(device: Any) -> None:
    """K3 at the edges of its slabs (``slab_sizes``), against
    ``sort_finish_reference`` bit for bit: a random permutation as the
    order, sorted segment ids of groups of 1 to 8 positions with the rows
    that are not real (-1) last; each bucket's count against its slab's
    rows (``check_fill``)."""
    import torch

    from fugue_tpu_torch.kernels.factorize import sort_finish_cuda
    from fugue_tpu_torch.kernels.reference import sort_finish_reference

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    sort_finish_cuda(torch.zeros((1,), dtype=torch.int32, device=device),
                     torch.zeros((1,), dtype=torch.int64, device=device), 1)
    shift = sort_finish_cuda.last_shift
    for n in slab_sizes(shift):
        order = torch.randperm(n, generator=gen, device=device)
        opens = torch.randint(0, 8, (n,), generator=gen, device=device) == 0
        opens[0] = True
        seg_sorted = (torch.cumsum(opens, 0) - 1).to(torch.int32)
        real = n - n // 10
        seg_sorted[real:] = -1
        num = int(seg_sorted[real - 1]) + 1
        label = f"sort_finish n={n}"
        got = sort_finish_cuda(seg_sorted, order, num)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        _equal(label, ("seg", "first_idx"), got, sort_finish_reference(seg_sorted, order, num))
        check_fill(label, sort_finish_cuda.last_fill, n, shift)
        print(f"ok {label} slabs of 2^{shift} rows, groups={num}")


def config2_frame(rows: int) -> Any:
    """``BASELINE.json``'s second configuration (``bench.py:786-793``): an
    int32 key uniform over 512 groups and a float32 value, seed 1."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(1)
    return pd.DataFrame({
        "k": rng.integers(0, 512, rows).astype(np.int32),
        "v": rng.random(rows).astype(np.float32),
    })


def udfs() -> Dict[str, Callable[..., Any]]:
    """The transformers of the new paths, annotated ``Dict[str,
    torch.Tensor]`` as the port requires:

    - ``demean``: the config-2 transformer (``bench.py:798-811``) in
      torch, each value less its group's mean. The sentinel id
      ``_num_segments`` of rows that are not real gets its own bucket, cut
      off after the sums, and ids are clamped for the gather back to the
      rows;
    - ``float_key`` and ``int64_key``: the headline UDF (``v2 = v*2+1``)
      with the key cast to float32, or mapped to ``k * 2^33 - 2^40`` as
      int64, which has no bin spec; ``wide_key`` returns both, as ``k``
      and ``j``, a key pair of 96 bits that no sort word holds."""
    import torch

    Cols = Dict[str, torch.Tensor]

    def demean(a: Cols) -> Cols:
        seg, num, valid = a["_segment_ids"], a["_num_segments"], a["_row_valid"]
        v = torch.where(valid, a["v"], 0.0)
        idx = seg.long()
        zeros = torch.zeros(num + 1, dtype=v.dtype, device=v.device)
        cnt = zeros.clone().index_add_(0, idx, valid.to(v.dtype))
        tot = zeros.index_add_(0, idx, v)
        mean = tot[:num] / torch.clamp(cnt[:num], min=1.0)
        return {"k": a["k"], "v": a["v"], "z": a["v"] - mean[torch.clamp(seg, 0, num - 1).long()]}

    def float_key(a: Cols) -> Cols:
        return {"k": a["k"].float(), "v2": a["v"] * 2.0 + 1.0}

    def int64_key(a: Cols) -> Cols:
        return {"k": a["k"].to(torch.int64) * 2**33 - 2**40, "v2": a["v"] * 2.0 + 1.0}

    def wide_key(a: Cols) -> Cols:
        return {"k": a["k"].float(), "j": a["k"].to(torch.int64) * 2**33 - 2**40,
                "v2": a["v"] * 2.0 + 1.0}

    return {"demean": demean, "float_key": float_key, "int64_key": int64_key,
            "wide_key": wide_key}


def build_partitioned_transform(
    device: Any, rows: int
) -> Tuple[Callable[[], Tuple[float, Dict[str, Any]]], Any]:
    """Upload the config-2 frame and return ``(run_once, frame)``;
    ``run_once()`` drives ``transform(partition={"by": ["k"]})`` of
    ``udfs()["demean"]`` and brings every output column back through the
    host endpoint (``as_arrow``) as numpy arrays, and returns ``(seconds,
    arrays)``."""
    from fugue_tpu_torch import make_execution_engine, transform

    pdf = config2_frame(rows)
    engine = make_execution_engine("torch", device=device)
    src = engine.persist(engine.to_df(pdf))

    def run_once() -> Tuple[float, Dict[str, Any]]:
        t = time.perf_counter()
        out = transform(src, udfs()["demean"], schema="k:int,v:float,z:float",
                        partition={"by": ["k"]}, engine=engine, as_fugue=True)
        table = out.as_arrow()  # the host endpoint: one wave of copies into pinned memory
        host = {name: table.column(name).to_numpy() for name in table.column_names}
        return time.perf_counter() - t, host

    return run_once, pdf


def partitioned_transform(device: Any, rows: int, warm_runs: int) -> Dict[str, Any]:
    """``transform(partition={"by": ["k"]})`` of ``udfs()["demean"]`` over the
    config-2 frame, every output column brought back to the host (the
    JAX bench's endpoint). ``z`` is held against float64 numpy: within
    ``MAIN_PATH_RTOL`` of the group's mean (float32 sums of ~20k rows per
    group at 10M rows) plus float32 rounding of ``v``. Reports cold and
    best warm seconds, rows/s, peak memory and each kernel's launches in
    the cold run and over the warm runs (the factorization is cached on
    the frame, so warm runs launch none)."""
    import numpy as np
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run_once, pdf = build_partitioned_transform(device, rows)
    zero_launches()
    cold_secs, host = run_once()
    cold_launches = launch_counts()
    zero_launches()
    warm = [run_once()[0] for _ in range(warm_runs)]
    warm_launches = launch_counts()
    k, v = pdf["k"].to_numpy(), pdf["v"].to_numpy()
    if not (np.array_equal(host["k"], k) and np.array_equal(host["v"], v)):
        raise SystemExit(f"FAIL partitioned transform n={rows}: k or v changed")
    counts = np.bincount(k, minlength=512)
    mean = np.bincount(k, weights=v.astype(np.float64), minlength=512) / np.maximum(counts, 1)
    z_ref = v.astype(np.float64) - mean[k]
    err = np.abs(host["z"].astype(np.float64) - z_ref)
    bound = MAIN_PATH_RTOL * np.abs(mean[k]) + 2.0**-24 * np.abs(v)
    if not (np.all(np.isfinite(host["z"])) and np.all(err <= bound)):
        raise SystemExit(f"FAIL partitioned transform n={rows}: z off by up to {err.max()}")
    best = min(warm) if warm else cold_secs
    return {
        "rows": rows,
        "cold_secs": cold_secs,
        "warm_secs": warm,
        "best_warm_secs": best,
        "rows_per_sec": rows / best,
        "max_memory_allocated": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
        "launches": cold_launches,
        "warm_launches": warm_launches,
        "max_abs_err_z": float(err.max()),
    }


# the sort-path aggregates: UDF of ``udfs`` -> (its output schema, the
# keys, the key columns in numpy from the occupied int32 keys)
SORT_PATH_CASES: Dict[str, Tuple[str, List[str], Callable[[Any], Dict[str, Any]]]] = {
    "float_key": ("k:float,v2:float", ["k"], lambda k: {"k": k.astype("float32")}),
    "int64_key": ("k:long,v2:float", ["k"],
                  lambda k: {"k": k.astype("int64") * 2**33 - 2**40}),
    "wide_key": ("k:float,j:long,v2:float", ["k", "j"],
                 lambda k: {"k": k.astype("float32"), "j": k.astype("int64") * 2**33 - 2**40}),
}


def build_sort_path(
    device: Any, rows: int, groups: int, seed: int
) -> Tuple[Callable[[str], Callable[[], Tuple[float, Any]]], Any, Any, Any]:
    """Upload the headline frame and return ``(run_for, keys, values,
    engine)``; ``run_for(name)`` is the ``run_once`` of the sort-path case
    ``name`` of ``SORT_PATH_CASES``: the case's UDF, then sum/avg/count of
    ``v2`` by its keys, through the entry points to pandas, returning
    ``(seconds, result pandas)``."""
    import numpy as np
    import pandas as pd

    from fugue_tpu_torch import aggregate, col, functions as ff
    from fugue_tpu_torch import make_execution_engine, transform

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, groups, rows).astype(np.int32)
    values = rng.random(rows).astype(np.float32)
    engine = make_execution_engine("torch", device=device)
    src = engine.persist(engine.to_df(pd.DataFrame({"k": keys, "v": values})))

    def run_for(name: str) -> Callable[[], Tuple[float, Any]]:
        udf = udfs()[name]
        schema, by, _ = SORT_PATH_CASES[name]

        def run_once() -> Tuple[float, Any]:
            t = time.perf_counter()
            tout = transform(src, udf, schema=schema, engine=engine, as_fugue=True)
            agg = aggregate(tout, partition_by=by, s=ff.sum(col("v2")), m=ff.avg(col("v2")),
                            c=ff.count(col("v2")), engine=engine, as_fugue=True)
            return time.perf_counter() - t, agg.as_pandas()

        return run_once

    return run_for, keys, values, engine


class StageTimer:
    """Times the stages of one run: while active, ``torch.sort`` and the
    group-by's kernel wrappers as ``groupby`` calls them each run between
    two ``torch.cuda.synchronize`` calls, and the calls of each are summed.
    The readback of the group count is the time from the end of the first
    K2w (or K2) to the start of the K3 that follows it."""

    STAGES = ("bin_factorize_cuda", "sort_word_cuda", "sort_word_boundaries_cuda",
              "sort_word_lookup_cuda", "sort_boundaries_cuda", "sort_finish_cuda",
              "binned_sums_cuda", "segment_extrema_cuda", "segment_sq_dev_cuda")

    def __init__(self, device: Any) -> None:
        self.device = device
        self.secs: Dict[str, float] = {}
        self._saved: Dict[str, Any] = {}
        self._k2_end: Any = None

    def _timed(self, name: str, fn: Callable[..., Any]) -> Callable[..., Any]:
        import torch

        def run(*args: Any, **kwargs: Any) -> Any:
            torch.cuda.synchronize(self.device)
            t = time.perf_counter()
            if name in ("sort_word_lookup_cuda", "sort_finish_cuda") and self._k2_end:
                self.secs.setdefault("readback", t - self._k2_end)
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(self.device)
            end = time.perf_counter()
            self.secs[name] = self.secs.get(name, 0.0) + end - t
            if name in ("sort_word_boundaries_cuda", "sort_boundaries_cuda"):
                self._k2_end = end
            return out

        return run

    def __enter__(self) -> "StageTimer":
        import torch

        from fugue_tpu_torch.torch_backend import groupby

        self._saved = {name: getattr(groupby, name) for name in self.STAGES}
        self._saved["torch.sort"] = torch.sort
        for name in self.STAGES:
            setattr(groupby, name, self._timed(name, self._saved[name]))
        torch.sort = self._timed("torch.sort", self._saved["torch.sort"])
        return self

    def __exit__(self, *exc: Any) -> None:
        import torch

        from fugue_tpu_torch.torch_backend import groupby

        torch.sort = self._saved.pop("torch.sort")
        for name, fn in self._saved.items():
            setattr(groupby, name, fn)


def sort_path_aggregates(device: Any, rows: int, groups: int, seed: int, warm_runs: int,
                         cases: Tuple[str, ...] = ("float_key", "int64_key"),
                         split_cold: bool = False) -> List[Dict[str, Any]]:
    """The headline frame and UDF (``v2 = v*2+1``) with the key cast to
    float32, or mapped to ``k * 2^33 - 2^40`` as int64 (no bin spec), or
    both as a key pair too wide for one sort word, then sum/avg/count of
    ``v2`` by the keys through the sort path, through the entry points to
    pandas, for each of ``cases``. Keys (in the port's order, ascending
    here) and counts must equal numpy, ``s`` and ``m`` be within
    ``MAIN_PATH_RTOL`` of float64 numpy. Reports cold and best warm
    seconds, peak memory, each kernel's launches per aggregate and the
    factorization's route (``groupby.sort_factorize.last_route``); with
    ``split_cold``, each case's cold run is split into stages by a
    ``StageTimer``."""
    import contextlib

    import numpy as np
    import torch

    from fugue_tpu_torch.kernels.factorize import sort_word_lookup_cuda
    from fugue_tpu_torch.torch_backend import groupby

    run_for, keys, values, engine = build_sort_path(device, rows, groups, seed)
    v2 = values * np.float32(2.0) + np.float32(1.0)
    c_ref = np.bincount(keys, minlength=groups)
    s_ref = np.bincount(keys, weights=v2.astype(np.float64), minlength=groups)
    occupied = np.nonzero(c_ref)[0]
    out = []
    for name in cases:
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        run_once = run_for(name)
        before = engine.strategy_counts.get("generic", 0)
        timer = StageTimer(device) if split_cold else contextlib.nullcontext()
        sort_word_lookup_cuda.last_path = None
        zero_launches()
        with timer:
            cold_secs, pdf = run_once()
        cold_launches = launch_counts()
        route = groupby.sort_factorize.last_route
        lookup_path = sort_word_lookup_cuda.last_path
        zero_launches()
        warm = [run_once()[0] for _ in range(warm_runs)]
        warm_launches = launch_counts()
        if engine.strategy_counts.get("generic", 0) != before + 1 + warm_runs:
            raise SystemExit(f"FAIL sort path {name}: the aggregate took the binned branch")
        for key, want_k in SORT_PATH_CASES[name][2](occupied).items():
            if not np.array_equal(pdf[key].to_numpy(), want_k):
                raise SystemExit(f"FAIL sort path {name}: keys {key} differ from numpy")
        if not np.array_equal(pdf["c"].to_numpy(), c_ref[occupied]):
            raise SystemExit(f"FAIL sort path {name}: counts differ from numpy")
        rel = {}
        for col_name, want in (("s", s_ref[occupied]), ("m", s_ref[occupied] / c_ref[occupied])):
            got = pdf[col_name].to_numpy().astype(np.float64)
            rel[col_name] = float(np.max(np.abs(got - want) / np.abs(want)))
            if not (np.all(np.isfinite(got)) and rel[col_name] <= MAIN_PATH_RTOL):
                raise SystemExit(f"FAIL sort path {name}: {col_name} off by rtol {rel[col_name]}")
        best = min(warm) if warm else cold_secs
        stats = {
            "case": name,
            "rows": rows,
            "groups": int(occupied.shape[0]),
            "route": route,
            "lookup_path": lookup_path,
            "cold_secs": cold_secs,
            "warm_secs": warm,
            "best_warm_secs": best,
            "rows_per_sec": rows / best,
            "max_memory_allocated": (
                torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
            ),
            "launches": cold_launches,
            "warm_launches": warm_launches,
            "max_rel_err": rel,
        }
        if split_cold:
            stats["cold_split_secs"] = timer.secs
        out.append(stats)
    return out


def zipf_ids(u: Any, num: int, exponent: float) -> Any:
    """Segment ids over ``[0, num)`` drawn with probability proportional
    to (id + 1)^-``exponent`` from uniforms ``u`` in [0, 1): a bounded
    Zipf law, in the order of ``u`` (so a hot id is spread over the
    rows)."""
    import torch

    p = torch.arange(1, num + 1, dtype=torch.float64, device=u.device) ** -exponent
    cdf = torch.cumsum(p / p.sum(), 0)
    return torch.searchsorted(cdf, u.to(torch.float64)).clamp(max=num - 1).to(torch.int32)


def reduce_cases(device: Any, n: int, seed: int) -> Iterator[Tuple[str, str, Dict[str, Any]]]:
    """K4's and K5's cases at ``n`` rows: ``(label, "extrema" or "sq_dev",
    keyword arguments of the kernel and its twin)``. Segment ids reach
    outside ``[0, num)`` on some rows, which then count nowhere; float
    payloads hold NaN, -0.0, +0.0 and infinities; int64 payloads their
    type's extremes. Beside 1024 uniform segments: one segment (prefix
    and masked frames, every payload NaN or masked), Zipf(``FOLD_ZIPF``)
    over 1024 segments, sorted runs of 37 and 5000 rows (across a
    thread's run of 8 rows, a warp's 256 and a block's 2048), views at an
    offset no 16-byte load takes, and 2^20 segments. Cases labelled
    "global tables" take that route, the rest the shared one. Each case's
    payloads are drawn as it is reached, so that one case's columns are
    held at a time."""
    import torch

    from fugue_tpu_torch.kernels.reference import Extremum

    ints, flags, floats, big = _draws(device, n, seed)
    table = torch.tensor([float("nan"), -0.0, 0.0, 1.5, -2.25, float("inf"), float("-inf"), 7.0],
                         device=device)
    extremes = torch.tensor([-(2**63), 2**63 - 1, -1, 0, 1], dtype=torch.int64, device=device)

    def special(dtype: Any) -> Any:
        return table.to(dtype)[ints(0, 8, torch.int64)]

    def every_dtype(lo: int = 0, hi: int = 9) -> List[Any]:
        makers = [
            lambda: Extremum(special(torch.float32), flags(0.8), True, True),
            lambda: Extremum(special(torch.float64), None, True, True),
            lambda: Extremum(extremes[ints(0, 5, torch.int64)], None, True, True),
            lambda: Extremum(big(), flags(0.5), True, False),
            lambda: Extremum(ints(-(2**31), 2**31 - 1, torch.int32), None, False, True),
            lambda: Extremum(ints(-(2**15), 2**15, torch.int16), None, True, True),
            lambda: Extremum(ints(-128, 128, torch.int8), flags(0.7), True, True),
            lambda: Extremum(ints(0, 256, torch.uint8), None, True, True),
            lambda: Extremum(flags(0.5), flags(0.9), True, True),
        ]
        return [make() for make in makers[lo:hi]]

    def means(p: int, num: int) -> Any:
        return floats(torch.float64, m=p * num).view(p, num) * 2

    def view(t: Any) -> Any:
        return shifted([(t, None)])[0][0]

    seg1024 = ints(-2, 1026, torch.int32)
    wide = 1 << 20
    seg_wide = ints(0, wide, torch.int32)
    zeros = torch.zeros((n,), dtype=torch.int32, device=device)
    zipf = zipf_ids((floats(torch.float64) + 1) / 2, 1024, FOLD_ZIPF)
    row = torch.arange(n, dtype=torch.int32, device=device)
    runs37, runs5000 = (row // 37) % 1024, (row // 5000) % 1024
    finite = [(floats() * 10, None), (floats(torch.float64), flags(0.6))]
    none = torch.zeros((n,), dtype=torch.bool, device=device)

    def not_nan() -> List[Any]:
        # as the engine gives K5 its payloads: NaN (and here infinite) rows masked out
        special32 = special(torch.float32)
        return [(special32, flags(0.8) & torch.isfinite(special32))]

    def offset() -> List[Any]:
        return [Extremum(view(special(torch.float32)), view(flags(0.8)), True, True),
                Extremum(view(extremes[ints(0, 5, torch.int64)]), None, True, True),
                Extremum(view(ints(-(2**15), 2**15, torch.int16)), None, True, True),
                Extremum(view(ints(0, 256, torch.uint8)), view(flags(0.7)), True, True)]

    cases: List[Tuple[str, str, Callable[[], Dict[str, Any]]]] = [
        ("every payload dtype, 1024 segments, prefix frame", "extrema", lambda: dict(
            seg=seg1024, num=1024, payloads=every_dtype(), nrows=n - n // 7,
            first=True, last=True)),
        ("masked frame", "extrema", lambda: dict(
            seg=seg1024, num=1024, payloads=every_dtype(0, 3), row_valid=flags(0.6),
            last=True)),
        ("one segment", "extrema", lambda: dict(
            seg=zeros, num=1, payloads=every_dtype(1, 4), nrows=n, first=True, last=True)),
        ("one segment, every payload dtype, masked frame", "extrema", lambda: dict(
            seg=zeros, num=1, payloads=every_dtype(), row_valid=flags(0.6), first=True,
            last=True)),
        ("one segment, every row NaN or masked", "extrema", lambda: dict(
            seg=zeros, num=1, nrows=n, first=True, last=True, payloads=[
                Extremum(torch.full((n,), float("nan"), device=device), flags(0.5), True, True),
                Extremum(special(torch.float64), none, True, True),
                Extremum(big(), none, True, True)])),
        ("zipf over 1024 segments", "extrema", lambda: dict(
            seg=zipf, num=1024, payloads=every_dtype(0, 5), nrows=n, first=True, last=True)),
        ("sorted runs of 37 rows", "extrema", lambda: dict(
            seg=runs37, num=1024, payloads=every_dtype(0, 4), nrows=n - n // 7, first=True,
            last=True)),
        ("sorted runs of 5000 rows, masked frame", "extrema", lambda: dict(
            seg=runs5000, num=1024, payloads=every_dtype(4), row_valid=flags(0.6),
            first=True, last=True)),
        ("views at an unaligned offset", "extrema", lambda: dict(
            seg=view(seg1024), num=1024, payloads=offset(), row_valid=view(flags(0.7)),
            first=True, last=True)),
        ("2^20 segments, global tables", "extrema", lambda: dict(
            seg=seg_wide, num=wide, payloads=every_dtype(0, 2), nrows=n, first=True,
            last=True)),
        ("float32 and float64, 1024 segments, prefix frame", "sq_dev", lambda: dict(
            seg=seg1024, num=1024, payloads=finite, means=means(2, 1024), nrows=n - n // 7)),
        ("masked frame, NaN rows masked out", "sq_dev", lambda: dict(
            seg=seg1024, num=1024, payloads=not_nan() + finite, means=means(3, 1024),
            row_valid=flags(0.6))),
        ("one segment", "sq_dev", lambda: dict(
            seg=zeros, num=1, payloads=finite, means=means(2, 1), nrows=n)),
        ("one segment, masked frame, a payload every row masked", "sq_dev", lambda: dict(
            seg=zeros, num=1, payloads=not_nan() + finite + [(floats(), none)],
            means=means(4, 1), row_valid=flags(0.6))),
        ("zipf over 1024 segments", "sq_dev", lambda: dict(
            seg=zipf, num=1024, payloads=finite, means=means(2, 1024), nrows=n)),
        ("sorted runs of 37 rows", "sq_dev", lambda: dict(
            seg=runs37, num=1024, payloads=finite, means=means(2, 1024), nrows=n)),
        ("sorted runs of 5000 rows, masked frame", "sq_dev", lambda: dict(
            seg=runs5000, num=1024, payloads=finite, means=means(2, 1024),
            row_valid=flags(0.6))),
        ("views at an unaligned offset", "sq_dev", lambda: dict(
            seg=view(seg1024), num=1024, payloads=shifted([
                (special(torch.float32).nan_to_num(0.0, 0.0, 0.0), flags(0.8)), finite[1]]),
            means=means(2, 1024), nrows=n)),
        ("2^20 segments, global tables", "sq_dev", lambda: dict(
            seg=seg_wide, num=wide, payloads=finite, means=means(2, wide), nrows=n)),
        ("more payloads than one launch takes", "sq_dev", lambda: dict(
            seg=seg1024, num=1024, payloads=finite * 5, means=means(10, 1024), nrows=n)),
    ]
    for label, kind, make in cases:
        yield label, kind, make()


REDUCE_SIZES = (1, 31, 33, (1 << 20) + 37, 10_000_000, ROWS)  # reduce_vs_twin's row counts


def _bits(t: Any) -> Any:
    """A tensor as the integers of its bits, so that ``torch.equal``
    compares floats bit for bit (NaN and the sign of zero included)."""
    import torch

    views = {torch.float32: torch.int32, torch.float64: torch.int64}
    return t.view(views[t.dtype]) if t.dtype in views else t


def sq_dev_twin(case: Dict[str, Any], chunk: int = 1 << 20) -> Any:
    """``segment_sq_dev_reference`` of ``case`` (K5's keyword arguments)
    as the sum of the twin over chunks of ``chunk`` rows. On the card the
    twin's ``index_add_`` adds every row of a segment into one float64
    word in turn: over tens of millions of rows of a few repeated values
    that one accumulator drifts by some 2e-10 (a sum of 36M such squares
    in row order is off by 2.4e-10, by numpy's cumsum against math.fsum),
    while partial sums of 2^20 rows stay within 1e-12."""
    import torch

    from fugue_tpu_torch.kernels.reference import segment_sq_dev_reference

    seg, payloads = case["seg"], case["payloads"]
    rows = case.get("nrows")
    scan = int(seg.shape[0]) if rows is None else int(rows)
    out = torch.zeros((len(payloads), case["num"]), dtype=torch.float64, device=seg.device)
    for a in range(0, scan, chunk):
        b = min(a + chunk, scan)
        part = dict(seg=seg[a:b], num=case["num"], means=case["means"],
                    payloads=[(v[a:b], None if m is None else m[a:b]) for v, m in payloads])
        if rows is None:
            part["row_valid"] = case["row_valid"][a:b]
        else:
            part["nrows"] = b - a
        out += segment_sq_dev_reference(**part)
    return out


def reduce_vs_twin(device: Any, sizes: Tuple[int, ...]) -> float:
    """K4 (``segment_extrema_cuda``) against ``segment_extrema_reference``
    bit for bit, and K5 (``segment_sq_dev_cuda``) against
    ``segment_sq_dev_reference`` (summed by chunks: ``sq_dev_twin``)
    within rtol 1e-10 (float64 sums add in no fixed order), in every case
    of ``reduce_cases`` at each size, with the path each took. Returns
    K5's largest relative difference."""
    import torch

    from fugue_tpu_torch.kernels.reference import segment_extrema_reference
    from fugue_tpu_torch.kernels.segment_reduce import (
        segment_extrema_cuda, segment_sq_dev_cuda,
    )

    worst = 0.0
    for n in sizes:
        for label, kind, case in reduce_cases(device, n, SEED):
            full = f"{kind} {label} n={n}"
            if kind == "extrema":
                got = segment_extrema_cuda(**case)
                path = segment_extrema_cuda.last_path
                want = segment_extrema_reference(**case)
                torch.cuda.synchronize(device)
                pairs = [("first", got.first, want.first), ("last", got.last, want.last)]
                for q in range(len(case["payloads"])):
                    pairs += [(f"min {q}", got.mins[q], want.mins[q]),
                              (f"max {q}", got.maxs[q], want.maxs[q])]
                for name, g, w in pairs:
                    if (g is None) != (w is None):
                        raise SystemExit(f"FAIL {full}: {name} given by one side only")
                    if g is not None and (g.dtype != w.dtype or not torch.equal(_bits(g), _bits(w))):
                        raise SystemExit(f"FAIL {full}: {name} differs from the twin")
                err = 0.0
            else:
                got = segment_sq_dev_cuda(**case)
                path = segment_sq_dev_cuda.last_path
                want = sq_dev_twin(case)
                torch.cuda.synchronize(device)
                rel = ((got - want).abs() / want.abs().clamp(min=1e-300)).max()
                err = float(rel)
                if got.shape != want.shape or not err <= 1e-10:
                    raise SystemExit(f"FAIL {full}: rel err {err}")
                worst = max(worst, err)
            want_path = "global" if "global tables" in label else "shared"
            if n > 1 and path != want_path:
                raise SystemExit(f"FAIL {full}: took the {path} path, expected {want_path}")
            print(f"ok {full} path={path} rel_err={err}")
            del got, want, case
        torch.cuda.empty_cache()
    return worst


# the full group-by: every function by the headline key (and with no key)
FULL_GROUPBY_SCHEMA = ("k:int,s:float,c:long,mn:float,mx:float,f:float,l:float,"
                       "sd:double,vp:double,md:double,cu:long,su:long")
DISTINCT_VALUES = 10_000  # u uniform over [0, 10000)
VARIANCE_RTOL = 1e-9


def full_groupby_frame(rows: int, groups: int, distinct: int, seed: int) -> Tuple[Any, Any, Any]:
    """The headline frame (``k`` int32 over ``groups``, ``v`` float32) and
    ``u`` int32 uniform over ``[0, distinct)``, from one generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, groups, rows).astype(np.int32)
    values = rng.random(rows).astype(np.float32)
    u = rng.integers(0, distinct, rows).astype(np.int32)
    return keys, values, u


def build_full_groupby(
    device: Any, rows: int, groups: int, distinct: int, seed: int
) -> Tuple[Callable[[bool], Callable[[], Tuple[float, Any, str]]], Tuple[Any, Any, Any],
           Any]:
    """Upload the full group-by frame and return ``(run_for, (k, v, u),
    engine)``; ``run_for(keyed)`` is the ``run_once`` of the headline UDF
    (``v2 = v*2+1``, ``u`` passed through) then sum, count(*), min, max,
    first, last, stddev, var_pop, median of ``v2`` and count/sum DISTINCT
    of ``u``, by ``k`` or with no key, through the entry points to pandas,
    returning ``(seconds, result pandas, result schema)``."""
    import pandas as pd
    import torch

    from fugue_tpu_torch import aggregate, col, functions as ff
    from fugue_tpu_torch import make_execution_engine, transform
    from fugue_tpu_torch.column.expressions import _FuncExpr

    k, v, u = full_groupby_frame(rows, groups, distinct, seed)
    engine = make_execution_engine("torch", device=device)
    src = engine.persist(engine.to_df(pd.DataFrame({"k": k, "v": v, "u": u})))

    def udf(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": a["k"], "v2": a["v"] * 2.0 + 1.0, "u": a["u"]}

    def agg(func: str, name: str, distinct_: bool = False) -> Any:
        return _FuncExpr(func, col(name), arg_distinct=distinct_, is_aggregation=True)

    def run_for(keyed: bool) -> Callable[[], Tuple[float, Any, str]]:
        def run_once() -> Tuple[float, Any, str]:
            t = time.perf_counter()
            tout = transform(src, udf, schema="k:int,v2:float,u:int", engine=engine,
                             as_fugue=True)
            res = aggregate(
                tout, partition_by="k" if keyed else None, engine=engine, as_fugue=True,
                s=ff.sum(col("v2")), c=ff.count(col("*")), mn=ff.min(col("v2")),
                mx=ff.max(col("v2")), f=ff.first(col("v2")), l=ff.last(col("v2")),
                sd=agg("stddev", "v2"), vp=agg("var_pop", "v2"), md=agg("median", "v2"),
                cu=ff.count_distinct(col("u")), su=agg("sum", "u", True),
            )
            pdf = res.as_pandas()
            return time.perf_counter() - t, pdf, str(res.schema)

        return run_once

    return run_for, (k, v, u), engine


def full_groupby_oracle(k: Any, v2: Any, u: Any, groups: int, distinct: int,
                        keyed: bool) -> Dict[str, Any]:
    """The full group-by's result from numpy in float64, per occupied key
    in ascending order (or one row with no key): min, max and median from
    one sort of the rows by (key, value), first and last from each key's
    first and last occurrence, the variance family in two passes, the
    DISTINCT forms from a presence table of the (key, u) pairs. ``v2``
    must be positive, so that its bits order as unsigned integers."""
    import numpy as np

    n = int(k.shape[0])
    if not keyed:
        k = np.zeros(n, dtype=np.int32)
        groups = 1
    if float(v2.min()) <= 0:
        raise SystemExit("FAIL full group-by oracle: v2 must be positive")
    c = np.bincount(k, minlength=groups)
    occ = np.nonzero(c)[0]
    v64 = v2.astype(np.float64)
    s = np.bincount(k, weights=v64, minlength=groups)
    mean = s / np.maximum(c, 1)
    ss = np.bincount(k, weights=(v64 - mean[k]) ** 2, minlength=groups)
    word = (k.astype(np.int64) << 32) | v2.view(np.uint32).astype(np.int64)
    word.sort()
    sv = (word & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
    del word
    starts = np.cumsum(c) - c
    lo, hi = starts + (c - 1) // 2, starts + c // 2
    first = np.full(groups, -1, dtype=np.int64)
    last = np.full(groups, -1, dtype=np.int64)
    chunk = 1 << 20
    for out, sl in ((first, lambda a: slice(a, a + chunk)),
                    (last, lambda a: slice(max(n - a - chunk, 0), n - a))):
        for a in range(0, n, chunk):
            part = sl(a)
            seen = k[part] if out is first else k[part][::-1]
            uniq, idx = np.unique(seen, return_index=True)
            rows_ = part.start + idx if out is first else part.stop - 1 - idx
            new = out[uniq] < 0
            out[uniq[new]] = rows_[new]
            if (out[occ] >= 0).all():
                break
    present = (np.bincount(k.astype(np.int64) * distinct + u, minlength=groups * distinct)
               > 0).reshape(groups, distinct)
    res = {
        "c": c[occ],
        "s": s[occ],
        "mn": sv[starts[occ]],
        "mx": sv[starts[occ] + c[occ] - 1],
        "f": v2[first[occ]],
        "l": v2[last[occ]],
        "sd": np.sqrt(ss / np.maximum(c - 1, 1))[occ],
        "vp": (ss / np.maximum(c, 1))[occ],
        "md": ((sv[lo].astype(np.float64) + sv[hi].astype(np.float64)) * 0.5)[occ],
        "cu": present.sum(axis=1)[occ],
        "su": (present * np.arange(distinct, dtype=np.int64)).sum(axis=1)[occ],
    }
    if keyed:
        res["k"] = occ.astype(np.int32)
    return res


def check_full_groupby(pdf: Any, want: Dict[str, Any], label: str) -> Dict[str, float]:
    """The result against ``full_groupby_oracle``: keys, counts, min, max,
    first, last, median and the DISTINCT forms exactly; ``s`` within
    ``MAIN_PATH_RTOL``; ``sd`` and ``vp`` within ``VARIANCE_RTOL``. Returns
    the relative errors of the inexact columns."""
    import numpy as np

    if len(pdf) != len(want["c"]):
        raise SystemExit(f"FAIL {label}: {len(pdf)} rows, expected {len(want['c'])}")
    for name in ("k", "c", "mn", "mx", "f", "l", "md", "cu", "su"):
        if name in want and not np.array_equal(pdf[name].to_numpy(), want[name]):
            raise SystemExit(f"FAIL {label}: {name} differs from numpy")
    rel = {}
    for name, tol in (("s", MAIN_PATH_RTOL), ("sd", VARIANCE_RTOL), ("vp", VARIANCE_RTOL)):
        got = pdf[name].to_numpy().astype(np.float64)
        rel[name] = float(np.max(np.abs(got - want[name]) / np.abs(want[name])))
        if not (np.all(np.isfinite(got)) and rel[name] <= tol):
            raise SystemExit(f"FAIL {label}: {name} off by rtol {rel[name]}")
    return rel


def full_groupby(device: Any, rows: int, groups: int, distinct: int, seed: int,
                 warm_runs: int, split_cold: bool = False) -> List[Dict[str, Any]]:
    """The full group-by through the entry points to pandas
    (``build_full_groupby``), by ``k`` and with no key, each checked
    against ``full_groupby_oracle`` outside the timed runs. Reports cold
    and best warm seconds, peak device memory, each kernel's launches in
    the cold run and over the warm runs and, with ``split_cold``, the cold
    run split into stages (``StageTimer``)."""
    import contextlib

    import numpy as np
    import torch

    run_for, (k, v, u), engine = build_full_groupby(device, rows, groups, distinct, seed)
    v2 = v * np.float32(2.0) + np.float32(1.0)
    out = []
    for keyed in (True, False):
        label = f"full group-by {'keyed' if keyed else 'keyless'}"
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        run_once = run_for(keyed)
        timer = StageTimer(device) if split_cold else contextlib.nullcontext()
        zero_launches()
        with timer:
            cold_secs, pdf, schema = run_once()
        cold_launches = launch_counts()
        zero_launches()
        warm = [run_once()[0] for _ in range(warm_runs)]
        warm_launches = launch_counts()
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        if schema != (FULL_GROUPBY_SCHEMA if keyed else FULL_GROUPBY_SCHEMA[len("k:int,"):]):
            raise SystemExit(f"FAIL {label}: schema {schema}")
        want = full_groupby_oracle(k, v2, u, groups, distinct, keyed)
        rel = check_full_groupby(pdf, want, label)
        best = min(warm) if warm else cold_secs
        stats = {
            "case": "keyed" if keyed else "keyless",
            "rows": rows,
            "groups": len(pdf),
            "cold_secs": cold_secs,
            "warm_secs": warm,
            "best_warm_secs": best,
            "rows_per_sec": rows / best,
            "max_memory_allocated": peak,
            "launches": cold_launches,
            "warm_launches": warm_launches,
            "max_rel_err": rel,
        }
        if split_cold:
            stats["cold_split_secs"] = timer.secs
        out.append(stats)
    return out


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

    zero_launches()
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


def time_cuda(fn: Callable[[], Any], reps: int, warm: int = 2) -> float:
    """Milliseconds per call, from CUDA events around ``reps`` calls after
    ``warm`` warm-up calls."""
    import torch

    for _ in range(warm):
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


def _kernel_entry(name: str, replaces: str, launches: int, err: float, ms: float,
                  plain_ms: float, nbytes: int, ops: int,
                  library_ms: Optional[float], source: str = "factorize.cu",
                  ops_per_s: float = FP32_OPS_PER_S) -> Dict[str, Any]:
    """One kernel's entry of the ``kernels`` line; its bound is the larger
    of its bytes over the HBM rate and its operations over ``ops_per_s``
    (the float32 rate unless given). ``source`` is a file of
    ``fugue_tpu_torch/kernels/``."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": f"fugue_tpu_torch/kernels/{source}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def _max_abs_diff(got: Tuple[Any, ...], want: Tuple[Any, ...]) -> float:
    return max(float((g.to(w.dtype).double() - w.double()).abs().max()) if w.numel() else 0.0
               for g, w in zip(got, want))


def factorize_timing(device: Any, launches: Dict[str, int]) -> List[Dict[str, Any]]:
    """The factorization kernels with CUDA events at the 100M-row shapes
    of their paths, beside their plain twins, one PyTorch call each where
    there is one and their bounds: K1 over the headline key (int32 over
    1024 bins, a prefix frame with nrows = n); K2 and K3 over the codes of
    the sort path's float32 key (a NaN flag and the value; 1024 groups),
    as a key too wide for one word would take them; then KW, K2w and K3w
    (``word_timing``). Bytes: each input read once, each output written
    once; K2 and K3 read the int64 order. ``launches`` holds each kernel's
    launches on the path that runs it."""
    import torch

    from fugue_tpu_torch.kernels.factorize import (
        bin_factorize_cuda, sort_boundaries_cuda, sort_finish_cuda,
    )
    from fugue_tpu_torch.kernels.reference import (
        BinKey, bin_factorize_reference, sort_boundaries_reference, sort_finish_reference,
    )
    from fugue_tpu_torch.torch_backend import groupby

    gen = torch.Generator(device=device).manual_seed(SEED)
    n, total = ROWS, GROUPS
    key = torch.randint(0, total, (n,), generator=gen, device=device, dtype=torch.int32)
    k1 = dict(keys=[BinKey(key, None, 0, total)], nrows=n)
    want = bin_factorize_reference(**k1)
    err = _max_abs_diff(bin_factorize_cuda(**k1), want)
    ms = time_cuda(lambda: bin_factorize_cuda(**k1), 20)
    plain_ms = time_cuda(lambda: bin_factorize_reference(**k1), 5)
    # one PyTorch call for the first-row part: scatter_reduce_ "amin" of
    # the row positions over precomputed segment ids
    idx, pos = want[0].long(), torch.arange(n, dtype=torch.int32, device=device)
    first = torch.full((total,), n, dtype=torch.int32, device=device)
    library_ms = time_cuda(lambda: first.scatter_reduce_(0, idx, pos, "amin"), 5)
    del idx, pos, want
    entries = [_kernel_entry(
        "bin_factorize", "fugue_tpu/jax_backend/groupby.py:481", launches["bin_factorize"],
        err, ms, plain_ms, n * (4 + 4) + total * (4 + 1) + 4, n, library_ms)]

    codes = groupby.sort_codes([(key.float(), None)])
    order, first = groupby.lex_sort(codes, nrows=n)
    k2 = dict(nrows=n, first_sorted=first)  # as the wide route calls K2
    want2 = sort_boundaries_reference(codes, order, **k2)
    err = _max_abs_diff(sort_boundaries_cuda(codes, order, **k2), want2)
    ms = time_cuda(lambda: sort_boundaries_cuda(codes, order, **k2), 20)
    plain_ms = time_cuda(lambda: sort_boundaries_reference(codes, order, **k2), 5)
    # no one PyTorch call computes K2 (boundaries over codes gathered at
    # the order, then their scan); the scan alone, for scale
    opens = torch.zeros((n,), dtype=torch.bool, device=device)
    opens[1:] = want2[0][1:] != want2[0][:-1]
    opens[0] = True
    scan_ms = time_cuda(lambda: torch.cumsum(opens, 0, dtype=torch.int32), 5)
    print("sort_boundaries scan alone: " + json.dumps({
        "cumsum_ms": scan_ms,
        "device_ms": device_split_ms(lambda: sort_boundaries_cuda(codes, order, **k2), device),
        "ms_gathering_every_code": time_cuda(lambda: sort_boundaries_cuda(codes, order, nrows=n),
                                             20)}))
    del opens
    code_bytes = sum(int(c.shape[0]) * c.element_size() for c in codes)
    entries.append(_kernel_entry(
        "sort_boundaries", "fugue_tpu/jax_backend/groupby.py:554",
        launches["sort_boundaries"], err, ms, plain_ms, 8 * n + code_bytes + 4 * n + 4,
        n * len(codes), None))

    seg_sorted, num = want2[0], int(want2[1])
    want3 = sort_finish_reference(seg_sorted, order, num)
    err = _max_abs_diff(sort_finish_cuda(seg_sorted, order, num), want3)
    ms = time_cuda(lambda: sort_finish_cuda(seg_sorted, order, num), 20)
    plain_ms = time_cuda(lambda: sort_finish_reference(seg_sorted, order, num), 5)
    # one PyTorch call: the scatter of the sorted ids back to row order;
    # with its where (the rows that are not real to the sentinel), the
    # twin's first call, which is the kernel's work for the ids
    seg = torch.empty((n,), dtype=torch.int32, device=device)
    library_ms = time_cuda(lambda: seg.scatter_(0, order, seg_sorted), 5)
    print("sort_finish library calls: " + json.dumps({
        "scatter_ms": library_ms, "where_and_scatter_ms": time_cuda(
            lambda: seg.scatter_(0, order, torch.where(seg_sorted >= 0, seg_sorted, num)), 5)}))
    entries.append(_kernel_entry(
        "sort_finish", "fugue_tpu/jax_backend/groupby.py:582", launches["sort_finish"],
        err, ms, plain_ms, 4 * n + 8 * n + 4 * n + 4 * num, n, library_ms))
    del codes, order, first, want2, seg_sorted, want3, seg
    torch.cuda.empty_cache()
    entries += word_timing(device, key.float(), launches)
    return entries


def setop_codes(device: Any, rows: Optional[Tuple[int, int]] = None
                ) -> Tuple[Any, Tuple[Any, Any]]:
    """The set operations' factorization input (TPC-DS Q38/Q87's shape,
    ``relational_paths``): the two channels' rows stacked (``ROWS`` and
    half as many unless ``rows`` says), as three int32 codes (last name, first name, day: a name's
    string code is a relabelling of its index, which leaves the groups as
    they are), drawn on the card with ``q_channel``'s distributions; and
    ``lex_sort``'s order over them (a prefix frame)."""
    import torch

    from fugue_tpu_torch.torch_backend import groupby

    gen = torch.Generator(device=device).manual_seed(Q_SEED)
    n = sum(rows or (ROWS, ROWS // 2))
    codes = [torch.randint(0, hi, (n,), generator=gen, device=device, dtype=torch.int32)
             for hi in (Q_NAMES[0], Q_NAMES[1], Q_DAYS)]
    return codes, groupby.lex_sort(codes, nrows=n)


def setop_boundaries_timing(device: Any, launches: int) -> Dict[str, Any]:
    """K2 at the set operations' shape (``setop_codes``: 150M stacked rows,
    three int32 codes, most rows a group of their own) with CUDA events,
    beside its twin and its bound (the order and the codes read once, the
    ids written once), and its device split (``device_split_ms``).
    ``launches``: K2's launches in one set operation."""
    from fugue_tpu_torch.kernels.factorize import sort_boundaries_cuda
    from fugue_tpu_torch.kernels.reference import sort_boundaries_reference

    codes, (order, first) = setop_codes(device)
    n = int(order.shape[0])
    args = dict(nrows=n, first_sorted=first)
    want = sort_boundaries_reference(codes, order, **args)
    err = _max_abs_diff(sort_boundaries_cuda(codes, order, **args), want)
    print("sort_boundaries set operations: " + json.dumps({
        "rows": n, "groups": int(want[1]),
        "device_ms": device_split_ms(lambda: sort_boundaries_cuda(codes, order, **args), device),
        "ms_gathering_every_code": time_cuda(lambda: sort_boundaries_cuda(codes, order, nrows=n),
                                             20),
        "card": card_line()}))
    entry = _kernel_entry(
        "sort_boundaries_set_ops", "fugue_tpu/jax_backend/groupby.py:554", launches, err,
        time_cuda(lambda: sort_boundaries_cuda(codes, order, **args), 20),
        time_cuda(lambda: sort_boundaries_reference(codes, order, **args), 3),
        8 * n + 4 * n * len(codes) + 4 * n + 4, n * len(codes), None)
    del codes, order, first, want
    return entry


def word_timing(device: Any, fkey: Any, launches: Dict[str, int]) -> List[Dict[str, Any]]:
    """KW, K2w and K3w with CUDA events over the sort path's float32 key
    (100M rows, 1024 groups, a prefix frame with nrows = n: an int32
    word), beside their twins, one PyTorch call each where there is one
    and their bounds; then ``torch.sort`` of that word and of the int64
    key's word beside the bytes bound of a sort (the keys read once, the
    sorted keys and the int64 order written once), on a line of its own.
    Bytes: each input read once, each output written once; K2w reads the
    order and writes each group's word and first row only where a group
    opens."""
    import math

    import torch

    from fugue_tpu_torch.kernels.factorize import (
        sort_word_boundaries_cuda, sort_word_cuda, sort_word_lookup_cuda,
    )
    from fugue_tpu_torch.kernels.reference import (
        sort_word_boundaries_reference, sort_word_lookup_reference, sort_word_reference,
    )

    n = int(fkey.shape[0])
    keys = [(fkey, None)]
    sw = sort_word_cuda(keys, nrows=n)
    want = sort_word_reference(keys, nrows=n)
    err = _max_abs_diff((sw.word,), (want.word,))
    ms = time_cuda(lambda: sort_word_cuda(keys, nrows=n), 20)
    plain_ms = time_cuda(lambda: sort_word_reference(keys, nrows=n), 5)
    entries = [_kernel_entry(
        "sort_word", "fugue_tpu/jax_backend/groupby.py:507", launches["sort_word"],
        err, ms, plain_ms, 4 * n + 4 * n, n, None)]
    del want

    words = sw.word
    sort_ms = time_cuda(lambda: torch.sort(words, stable=True), 5)
    sorted_words, order = torch.sort(words, stable=True)
    got = sort_word_boundaries_cuda(sorted_words, order)
    want = sort_word_boundaries_reference(sorted_words, order)
    num = int(want[3])
    err = max(_max_abs_diff(got[2:], want[2:]),
              _max_abs_diff((got[0][:num], got[1][:num]), (want[0][:num], want[1][:num])))
    ms = time_cuda(lambda: sort_word_boundaries_cuda(sorted_words, order), 20)
    plain_ms = time_cuda(lambda: sort_word_boundaries_reference(sorted_words, order), 5)
    # one PyTorch call: the distinct words and their counts, which leaves
    # out the first rows and the sorted ids
    library_ms = time_cuda(lambda: torch.unique_consecutive(sorted_words, return_counts=True), 5)
    entries.append(_kernel_entry(
        "sort_word_boundaries", "fugue_tpu/jax_backend/groupby.py:554",
        launches["sort_word_boundaries"], err, ms, plain_ms,
        4 * n + 4 * n + num * (8 + 4 + 4) + 4, n, library_ms))

    uniq = got[0]
    seg = sort_word_lookup_cuda(words, uniq, num)
    path = sort_word_lookup_cuda.last_path
    err = _max_abs_diff((seg,), (sort_word_lookup_reference(words, want[0], num),))
    ms = time_cuda(lambda: sort_word_lookup_cuda(words, uniq, num), 20)
    plain_ms = time_cuda(lambda: sort_word_lookup_reference(words, uniq, num), 5)
    table = uniq[:num].contiguous()
    # one PyTorch call: the search of every row's word among the groups'
    library_ms = time_cuda(lambda: torch.searchsorted(table, words), 5)
    entries.append(_kernel_entry(
        "sort_word_lookup", "fugue_tpu/jax_backend/groupby.py:582",
        launches["sort_word_lookup"], err, ms, plain_ms, 4 * n + 4 * num + 4 * n,
        n * max(1, math.ceil(math.log2(max(num, 1)))), library_ms))
    print(f"sort_word_lookup timed shape: path={path} groups={num}")
    del sorted_words, order, got, want, seg, table

    wide_words = sort_word_cuda([(fkey.to(torch.int64) * 2**33 - 2**40, None)], nrows=n).word
    sort64_ms = time_cuda(lambda: torch.sort(wide_words, stable=True), 5)
    print("sorts: " + json.dumps({
        "rows": n,
        "int32_word_ms": sort_ms,
        "int32_word_bound_ms": n * (4 + 4 + 8) / HBM_BYTES_PER_S * 1e3,
        "int64_word_ms": sort64_ms,
        "int64_word_bound_ms": n * (8 + 8 + 8) / HBM_BYTES_PER_S * 1e3,
    }))
    return entries


def k3_routes(device: Any, rows: int) -> List[Dict[str, Any]]:
    """K3's two routes on the word route at ``rows`` rows: an int32 key
    (an int32 word) over 1024 to 2^21 groups and with every row distinct,
    and the int64 key ``k * 2^33`` (an int64 word) over 1024 to 2^18
    groups, densest around the crossover. K3w (its table in shared memory where it fits, else in global
    memory) and the scatter of K2w's sorted ids (K3) are checked against
    each other and timed with CUDA events. Prints and returns one line
    each; the crossover sets ``groupby.lookup_limit``."""
    import torch

    from fugue_tpu_torch.kernels.factorize import (
        sort_finish_cuda, sort_word_boundaries_cuda, sort_word_cuda, sort_word_lookup_cuda,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    sweeps = [(4, g) for g in (1024, 1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 19, 1 << 21, rows)]
    sweeps += [(8, g) for g in (1024, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 18)]
    out = []
    for width, groups in sweeps:
        if groups == rows:
            key = torch.randperm(rows, generator=gen, device=device).to(torch.int32)
        else:
            key = torch.randint(0, groups, (rows,), generator=gen, device=device,
                                dtype=torch.int32)
        if width == 8:
            key = key.to(torch.int64) * 2**33
        words = sort_word_cuda([(key, None)], nrows=rows).word
        del key
        sorted_words, order = torch.sort(words, stable=True)
        uniq, first_idx, seg_sorted, count = sort_word_boundaries_cuda(sorted_words, order)
        num = int(count)
        del sorted_words
        seg = sort_word_lookup_cuda(words, uniq, num)
        path = sort_word_lookup_cuda.last_path
        scattered, _ = sort_finish_cuda(seg_sorted, order, num)
        torch.cuda.synchronize(device)
        if not torch.equal(seg, scattered):
            raise SystemExit(f"FAIL k3 routes at {num} groups: lookup and scatter differ")
        reps = 3 if num > (1 << 21) else 10
        row = {
            "rows": rows,
            "word_bits": 8 * width,
            "groups": num,
            "table_bytes": num * width,
            "lookup_path": path,
            "lookup_ms": time_cuda(lambda: sort_word_lookup_cuda(words, uniq, num), reps),
            "scatter_ms": time_cuda(lambda: sort_finish_cuda(seg_sorted, order, num), reps),
        }
        print("k3_route: " + json.dumps(row))
        out.append(row)
        del words, uniq, first_idx, seg_sorted, order, seg, scattered
        torch.cuda.empty_cache()
    return out


def device_split_ms(run_once: Callable[[], Any], device: Any) -> Optional[Dict[str, float]]:
    """Each kernel's device milliseconds in one run, by name, from
    ``torch.profiler``; None where the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_once()
        torch.cuda.synchronize(device)
    def name(key: str) -> str:
        return key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]

    split = {name(e.key): e.self_device_time_total / 1e3
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    return split or None


def order_scatter_timing(device: Any, rows: int) -> Dict[str, Any]:
    """The two kernels that store through an order by slab at ``rows``
    rows with CUDA events and each launch's device time
    (``device_split_ms``): K3 over K2's sorted ids of the sort path's
    float32 key (1024 groups) with its lexicographic order (each group's
    rows ascending) and with a random permutation as the order (any other
    order), and K16's running float64 sum as ``window_timing`` takes it.
    Prints one ``order_scatter:`` line and returns its numbers."""
    import torch

    from fugue_tpu_torch.kernels.factorize import sort_boundaries_cuda, sort_finish_cuda
    from fugue_tpu_torch.kernels.reference import PresortKey, WindowFrame
    from fugue_tpu_torch.kernels.window import window_frame_cuda
    from fugue_tpu_torch.torch_backend import groupby, relational

    gen = torch.Generator(device=device).manual_seed(SEED)
    key = torch.randint(0, GROUPS, (rows,), generator=gen, device=device, dtype=torch.int32)
    codes = groupby.sort_codes([(key.float(), None)])
    order = groupby.lex_sort(codes, nrows=rows)[0]
    seg_sorted, count = sort_boundaries_cuda(codes, order, nrows=rows)
    num = int(count)
    del codes
    out: Dict[str, Any] = {"rows": rows}
    for label, o in (("sort_order", order),
                     ("random_order", torch.randperm(rows, generator=gen, device=device))):
        out[f"sort_finish_{label}"] = {
            "ms": time_cuda(lambda: sort_finish_cuda(seg_sorted, o, num), 20),
            "device_ms": device_split_ms(lambda: sort_finish_cuda(seg_sorted, o, num), device)}
        del o
    del seg_sorted, order
    torch.cuda.empty_cache()
    v = torch.rand((rows,), generator=gen, device=device).to(torch.float64)
    di = torch.randint(0, DATE_DAYS, (rows,), generator=gen, device=device, dtype=torch.int32)
    by_d = relational.presort_sorted([PresortKey(key, kmin=0, bits=GROUPS.bit_length()),
                                      PresortKey(di, kmin=0, bits=11)], rows, device, nrows=rows)
    running = WindowFrame("sum", 0, "running", ("up", 0), ("c", 0), v, route="prefix")
    out["window_frame_running_sum"] = {
        "ms": time_cuda(lambda: window_frame_cuda(by_d, running), 10),
        "device_ms": device_split_ms(lambda: window_frame_cuda(by_d, running), device)}
    print("order_scatter: " + json.dumps(out))
    del by_d, v, di, key
    torch.cuda.empty_cache()
    return out


def stand_in_timing(device: Any) -> Dict[str, Any]:
    """The two torch stand-ins of the headline path beside their bounds:
    ``torch.aminmax`` over 100M int32 keys (``groupby._minmax_prog``'s
    port; reads 4 B a row) and the UDF ``v*2+1`` over 100M float32 values
    (``_compiled_map``; two passes, each reading and writing 4 B a row)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    key = torch.randint(0, GROUPS, (ROWS,), generator=gen, device=device, dtype=torch.int32)
    value = torch.rand((ROWS,), generator=gen, device=device)
    return {
        "aminmax_ms": time_cuda(lambda: torch.aminmax(key), 20),
        "aminmax_bound_ms": ROWS * 4 / HBM_BYTES_PER_S * 1e3,
        "udf_ms": time_cuda(lambda: value * 2.0 + 1.0, 20),
        "udf_bound_ms": 2 * ROWS * 8 / HBM_BYTES_PER_S * 1e3,
    }


# K4's and K5's timing shapes: 100M rows of v2 in [1, 3) over one segment
# (the keyless aggregate), 1024 uniform segments (the full group-by's),
# Zipf(FOLD_ZIPF) over 1024 segments and 2^20 uniform segments (the
# global route); each entry's name suffix
REDUCE_SHAPES = {"keyless": "_keyless", "uniform": "", "zipf": "_zipf", "2^20": "_2p20"}


def reduce_shape(device: Any, shape: str) -> Dict[str, Any]:
    """K4's and K5's inputs at one of ``REDUCE_SHAPES`` (100M rows, a
    prefix frame with nrows = n, ``v2 = v*2+1`` in float32): ``k4`` takes
    the min and max of ``v2`` and each segment's last row, ``k5`` the
    squared deviations of ``v2`` under its not-NaN mask from the
    segments' float64 means; with ``library``, one PyTorch call each
    (``torch.aminmax`` and ``torch.var(correction=0)`` over one segment,
    else ``scatter_reduce_("amin")``, the min alone, and ``index_add_`` of
    squares computed before it), and the bytes each reads and writes
    once."""
    import torch

    from fugue_tpu_torch.kernels.reference import Extremum

    gen = torch.Generator(device=device).manual_seed(SEED)
    n = ROWS
    num = {"keyless": 1, "uniform": GROUPS, "zipf": GROUPS, "2^20": 1 << 20}[shape]
    if shape == "keyless":
        seg = torch.zeros((n,), dtype=torch.int32, device=device)
    elif shape == "zipf":
        seg = zipf_ids(torch.rand((n,), generator=gen, device=device, dtype=torch.float64),
                       num, FOLD_ZIPF)
    else:
        seg = torch.randint(0, num, (n,), generator=gen, device=device, dtype=torch.int32)
    value = torch.rand((n,), generator=gen, device=device) * 2 + 1
    eff = ~torch.isnan(value)
    idx = seg.long()
    cnt = torch.zeros((num,), dtype=torch.float64, device=device).index_add_(
        0, idx, eff.to(torch.float64))
    tot = torch.zeros((num,), dtype=torch.float64, device=device).index_add_(
        0, idx, value.to(torch.float64))
    means = (tot / cnt.clamp(min=1))[None]
    out: Dict[str, Any] = {
        "num": num,
        "k4": dict(seg=seg, num=num, payloads=[Extremum(value, None, True, True)], nrows=n,
                   last=True),
        "k5": dict(seg=seg, num=num, payloads=[(value, eff)], means=means, nrows=n),
        # seg and v2 read, the min, max and last row written; seg, v2 and
        # the mask read, the means read and the sums written
        "k4_bytes": n * (4 + 4) + num * (4 + 4 + 4),
        "k5_bytes": n * (4 + 4 + 1) + num * (8 + 8),
    }
    if shape == "keyless":
        kept = value[eff]
        out["k4_library"] = lambda: torch.aminmax(value)
        out["k5_library"] = lambda: torch.var(kept, correction=0)
    else:
        table = torch.empty((num,), dtype=torch.float32, device=device)
        sq = (value.to(torch.float64) - means[0].index_select(0, idx)) ** 2
        acc = torch.zeros((num,), dtype=torch.float64, device=device)
        out["k4_library"] = lambda: table.scatter_reduce_(0, idx, value, "amin",
                                                          include_self=False)
        out["k5_library"] = lambda: acc.zero_().index_add_(0, idx, sq)
    return out


def reduce_timing(device: Any, launches: Dict[str, int]) -> List[Dict[str, Any]]:
    """K4 and K5 with CUDA events at each of ``REDUCE_SHAPES``
    (``reduce_shape``), beside their twins, one PyTorch call each and their
    bounds: each input read once, each output written once; K5's float64
    operations over the float64 rate. K4 must equal its twin bit for bit,
    K5 within rtol 1e-10. The twins are timed by one call each, right
    after the call that checks the kernel against them (K4's twin takes
    seconds a call over one segment: ``scatter_reduce_`` into one
    address). ``launches`` holds each entry's launches on its path: the
    keyless full group-by's for the one-segment shape, the keyed one's for
    the rest."""
    import torch

    from fugue_tpu_torch.kernels.reference import (
        segment_extrema_reference, segment_sq_dev_reference,
    )
    from fugue_tpu_torch.kernels.segment_reduce import segment_extrema_cuda, segment_sq_dev_cuda

    entries = []
    for shape, suffix in REDUCE_SHAPES.items():
        c = reduce_shape(device, shape)
        n = ROWS
        got, want = segment_extrema_cuda(**c["k4"]), segment_extrema_reference(**c["k4"])
        pairs = [(got.mins[0], want.mins[0]), (got.maxs[0], want.maxs[0]),
                 (got.last, want.last)]
        if not all(torch.equal(_bits(g), _bits(w)) for g, w in pairs):
            raise SystemExit(f"FAIL segment_extrema at the {shape} shape: differs from its twin")
        path = segment_extrema_cuda.last_path
        entries.append(_kernel_entry(
            f"segment_extrema{suffix}", "fugue_tpu/jax_backend/groupby.py:647",
            launches[f"segment_extrema{suffix}"], 0.0,
            time_cuda(lambda: segment_extrema_cuda(**c["k4"]), 20),  # noqa: B023
            time_cuda(lambda: segment_extrema_reference(**c["k4"]), 1, warm=0),  # noqa: B023
            c["k4_bytes"], 3 * n, time_cuda(c["k4_library"], 5), source="segment_reduce.cu"))
        del got, want, pairs
        got5, want5 = segment_sq_dev_cuda(**c["k5"]), sq_dev_twin(c["k5"])
        rel = float(((got5 - want5).abs() / want5.abs().clamp(min=1e-300)).max())
        if not rel <= 1e-10:
            raise SystemExit(f"FAIL segment_sq_dev at the {shape} shape: rel err {rel}")
        entries.append(_kernel_entry(
            f"segment_sq_dev{suffix}", "fugue_tpu/jax_backend/groupby.py:676",
            launches[f"segment_sq_dev{suffix}"], float((got5 - want5).abs().max()),
            time_cuda(lambda: segment_sq_dev_cuda(**c["k5"]), 20),  # noqa: B023
            time_cuda(lambda: segment_sq_dev_reference(**c["k5"]), 1, warm=0),  # noqa: B023
            c["k5_bytes"], 3 * n, time_cuda(c["k5_library"], 5), source="segment_reduce.cu",
            ops_per_s=FP64_OPS_PER_S))
        print(f"segment reductions at the {shape} shape: K4 path={path}, K5 path="
              f"{segment_sq_dev_cuda.last_path} rel_err={rel}")
        del c, got5, want5
        torch.cuda.empty_cache()
    return entries


def median_timing(device: Any) -> Dict[str, Any]:
    """``groupby.segment_median``'s two routes with CUDA events at the full
    group-by's shape (100M rows, 1024 segments, ``v2`` in [1, 3)): one
    sort of the (segment, value) int64 word (KW) for the float32 values,
    and the JAX package's two stable sorts (by value, then by segment) for
    the same values as float64. Both must give the same medians."""
    import torch

    from fugue_tpu_torch.torch_backend import groupby

    gen = torch.Generator(device=device).manual_seed(SEED)
    seg = torch.randint(0, GROUPS, (ROWS,), generator=gen, device=device, dtype=torch.int32)
    value = torch.rand((ROWS,), generator=gen, device=device) * 2 + 1
    counts = torch.bincount(seg, minlength=GROUPS).to(torch.int32)
    wide = value.to(torch.float64)
    word = groupby.segment_median(value, None, seg, GROUPS, counts)
    if not torch.equal(word, groupby.segment_median(wide, None, seg, GROUPS, counts)):
        raise SystemExit("FAIL median: the two routes differ")
    out = {
        "rows": ROWS,
        "segments": GROUPS,
        "word_ms": time_cuda(lambda: groupby.segment_median(value, None, seg, GROUPS, counts), 5),
        "two_sorts_ms": time_cuda(
            lambda: groupby.segment_median(wide, None, seg, GROUPS, counts), 5),
        # the values and segment ids read once, the medians written once
        "bound_ms": (ROWS * (4 + 4) + GROUPS * 8) / HBM_BYTES_PER_S * 1e3,
    }
    print("median: " + json.dumps(out))
    return out


def distinct_mask_timing(device: Any) -> Dict[str, Any]:
    """The DISTINCT first-occurrence mask (the engine's ``_distinct_masks``)
    with CUDA events at the keyed full group-by's shape: 100M rows over the
    ~10.24M (k, u) bins, binned with ``occupied``, by K13 (the first rows
    and the occupancy read, 5 bytes a bin, the mask written, 1 byte a
    row), beside its twin, the gather and compare it replaced
    (``first_idx[seg] == row``, 9 bytes a row), and ``index_fill_`` of the
    occupied bins' first rows as one call and after ``zero_()``."""
    import torch

    from fugue_tpu_torch.kernels.reference import first_row_mask_reference
    from fugue_tpu_torch.kernels.row_select import first_row_mask_cuda

    gen = torch.Generator(device=device).manual_seed(SEED)
    num = GROUPS * DISTINCT_VALUES
    seg = torch.randint(0, num, (ROWS,), generator=gen, device=device, dtype=torch.int32)
    # each bin's first row and whether it holds one, as K1 gives them
    rows = torch.arange(ROWS, dtype=torch.int64, device=device)
    first = torch.full((num,), ROWS, dtype=torch.int64, device=device)
    first.scatter_reduce_(0, seg.long(), rows, "amin")
    occupied = first < ROWS
    first_idx = torch.where(occupied, first, ROWS - 1).to(torch.int32)
    want = first_row_mask_reference(first_idx, ROWS, occupied=occupied)
    got = first_row_mask_cuda(first_idx, ROWS, occupied=occupied)
    gathered = first_idx.index_select(0, seg) == rows.to(torch.int32)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[0], gathered)):
        raise SystemExit("FAIL distinct mask: K13 differs from its twin or from the gather")
    kept = first[occupied]
    mask = torch.zeros((ROWS,), dtype=torch.bool, device=device)
    row32 = rows.to(torch.int32)
    del rows, first
    out = {"rows": ROWS, "pairs": num, "occupied": int(occupied.sum()),
           "ms": time_cuda(lambda: first_row_mask_cuda(first_idx, ROWS, occupied=occupied), 20),
           "plain_ms": time_cuda(lambda: first_row_mask_reference(first_idx, ROWS,
                                                                  occupied=occupied), 5),
           "gather_compare_ms": time_cuda(lambda: first_idx.index_select(0, seg) == row32, 5),
           "index_fill_ms": time_cuda(lambda: mask.index_fill_(0, kept, True), 20),
           "zero_and_index_fill_ms": time_cuda(lambda: mask.zero_().index_fill_(0, kept, True),
                                               20),
           "bound_ms": (num * (4 + 1) + ROWS) / HBM_BYTES_PER_S * 1e3,
           "gather_bound_ms": ROWS * (4 + 4 + 1) / HBM_BYTES_PER_S * 1e3}
    print("distinct_mask: " + json.dumps(out))
    return out


# --- K6 expr_program: the kernel against its twin, the three paths, timing ---

# float64 rtol of the float functions (sqrt, exp, the logarithms, sin,
# cos, tan, power): CUDA's and torch's libraries agree to about 1 ulp
K6_FUNC_RTOL = 1e-13
K6_FUNCS = ("sqrt", "exp", "ln", "log2", "log10", "sin", "cos", "tan", "power")
K6_TYPES = ("bool", "i8", "i32", "i64", "u8", "f32", "f64")
K6_MANY_IMMS = 4_100
HAVING_COUNT = 87_900  # SELECT ... HAVING COUNT(*) > this, at 100M rows
CONFIG3_ROWS, CONFIG3_GROUPS, CONFIG3_SEED = 10_000_000, 256, 2  # bench.py:841-870
FILTER_COND = "((v2 >= 1.2) & (u != 7)) | x IS NULL"


def k6_frame(device: Any, n: int, seed: int) -> Any:
    """A frame of ``n`` rows with a column of every dtype K6 reads, twice
    (``<t>`` with nulls, ``<t>_b`` without): floats with NaN, -0.0, +0.0
    and infinities, integers with their type's extremes."""
    import torch

    from fugue_tpu_torch.kernels.expr_program import _PA, CODES
    from fugue_tpu_torch.torch_backend.blocks import TorchBlocks, TorchColumn

    ints, flags, floats, _ = _draws(device, n, seed)
    dtypes = {"bool": torch.bool, "i8": torch.int8, "i32": torch.int32, "i64": torch.int64,
              "u8": torch.uint8, "f32": torch.float32, "f64": torch.float64}
    special = torch.tensor([float("nan"), -0.0, 0.0, float("inf"), -float("inf"), 1.5, -2.25,
                            0.5, 3.0e7], dtype=torch.float64, device=device)
    cols = {}
    for t, dtype in dtypes.items():
        for suffix, nulls in (("", 0.2), ("_b", 0.0)):
            if t == "bool":
                v = flags(0.5)
            elif dtype.is_floating_point:
                v = torch.where(flags(0.3), special[ints(0, len(special), torch.int64)],
                                floats(torch.float64) * 200).to(dtype)
            else:
                info = torch.iinfo(dtype)
                edge = torch.tensor([info.min, info.max, 0, 1], dtype=dtype, device=device)
                lo = 0 if info.min == 0 else -50
                v = torch.where(flags(0.1), edge[ints(0, 4, torch.int64)],
                                ints(lo, 50, torch.int64).to(dtype))
            mask = flags(1.0 - nulls) if nulls else None
            cols[t + suffix] = TorchColumn(_PA[CODES[dtype]], v.contiguous(), mask)
    return TorchBlocks(n, cols, device)


def k6_cases() -> List[Tuple[str, List[Any], bool]]:
    """K6's checked programs: ``(label, expressions, filter mode)``. Every
    operator family over every dtype, several expressions a program
    (columns mode), and filter conditions."""
    import pyarrow as pa

    from fugue_tpu_torch.column.expressions import _FuncExpr, col, lit, null
    from fugue_tpu_torch.column.functions import case_when, coalesce

    def fn(name: str, *args: Any) -> Any:
        return _FuncExpr(name, *args)

    cases: List[Tuple[str, List[Any], bool]] = []
    for t in K6_TYPES:
        a, b = col(t), col(t + "_b")
        cases.append((f"logic_{t}", [a.is_null(), a.not_null(), ~a, a & col("bool"),
                                     col("bool_b") | a, fn("abs", a),
                                     fn("iif", col("bool"), a, b), fn("nullif", a, b)], False))
        cases.append((f"compare_{t}", [a == b, a != b, a < b, a <= b, a > b, a >= b,
                                       coalesce(a, b),
                                       case_when(col("f64") > 0.0, a, col("i8").is_null(), b, a)],
                      False))
        cases.append((f"cast_{t}", [a.cast(to) for to in (pa.bool_(), pa.int8(), pa.int32(),
                                                          pa.int64(), pa.uint8(), pa.float32(),
                                                          pa.float64())], False))
        if t != "bool":
            arith = [a + b, a - b, a * b, -a, fn("sign", a), fn("floor", a), fn("ceil", a)]
            if t != "u8":
                arith.append(fn("mod", a, b))
            cases.append((f"arith_{t}", arith, False))
    f = col("f64")
    cases += [
        ("div_round_f64", [f / col("f64_b"), col("i64") / col("i32_b"), f / 3.0,
                           fn("round", f, 2), fn("round", f, -1), fn("round", f),
                           fn("mod", f, 2.5), col("i8") - col("bool")], False),
        ("funcs_f64", [fn(name, f) for name in K6_FUNCS[:-1]] + [fn("power", f, col("f64_b"))],
         False),
        ("mixed", [col("i8") + col("f32"), col("i32") * col("i64"), col("u8") + col("u8_b"),
                   col("i64") + 9223372036854775807, f * -0.0, col("f32") - 3,
                   (col("i32") + null()).is_null(), coalesce(col("i64"), lit(5), col("i64_b"))],
         False),
        ("filter_pipeline", [((col("f32") >= 1.2) & (col("i32") != 7)) | f.is_null()], True),
        ("filter_kleene", [(col("bool") & ~col("i8")) | col("f64").not_null()], True),
        ("filter_float", [f], True),
        ("filter_null", [null()], True),
        ("filter_case", [case_when(col("f32") > 0.5, col("bool"), col("bool_b"))], True),
        ("wide", [col("i64") * i + col("i32") for i in range(16)], False),
    ]
    # over the interpreter's old caps (64 instructions, 32 registers, 16
    # outputs): a chain of 140 instructions, 17 outputs, and 40 terms all
    # live at once (the second sum reads them in reverse)
    chain = col("i64")
    for i in range(70):
        chain = chain + i
    terms = [col("i32") * i for i in range(1, 41)]
    cases += [
        ("chain70", [chain], False),
        ("outputs17", [col("i64") * i + col("i32") for i in range(17)], False),
        ("live40", [_left_sum(terms), _left_sum(terms[::-1])], False),
        # 4,100 immediates: parameters past a launch's 32,764 bytes, read
        # from device memory
        ("params_in_memory", [coalesce(col("i64"), *[lit(i) for i in range(K6_MANY_IMMS)])],
         False),
    ]
    return cases


def _left_sum(terms: List[Any]) -> Any:
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _or_all(conds: List[Any]) -> Any:
    out = conds[0]
    for c in conds[1:]:
        out = out | c
    return out


def k6_path_programs() -> List[Tuple[str, List[Any], bool]]:
    """The programs the three paths run, over ``k6_frame``'s columns."""
    import pyarrow as pa

    from fugue_tpu_torch.column.expressions import col
    from fugue_tpu_torch.column.functions import case_when, coalesce

    v2, u, x = col("f32"), col("i32"), col("f64")
    return [
        ("path_filter", [((v2 >= 1.2) & (u != 7)) | x.is_null()], True),
        ("path_assign", [case_when(v2 > 2.0, v2 * 2 - 1, coalesce(x, 0.0)),
                         u.cast(pa.float64()) / 3], False),
        ("path_where", [col("f32_b") < 0.9], True),
        ("path_agg_arg", [v2 * 2], False),
    ]


def _uses_func(expr: Any) -> bool:
    text = str(expr).lower()
    return any(f"{name}(" in text for name in K6_FUNCS)


def _run_k6(blocks: Any, exprs: List[Any], filt: bool, rows: Dict[str, Any],
            views: bool = False) -> Tuple[Any, Any, Any]:
    """``(program, kernel's result, twin's result)`` on the same tensors;
    with ``views``, on ``shifted`` copies (K6's scalar path)."""
    import torch

    from fugue_tpu_torch.kernels.expr_program import compile_program, expr_program_cuda
    from fugue_tpu_torch.kernels.reference import expr_program_reference

    cols = {n: (c.data.dtype, c.mask is not None) for n, c in blocks.columns.items()}
    dicts = {n: c.dictionary for n, c in blocks.columns.items() if c.is_string}
    prog = compile_program(exprs, [torch.bool] if filt else [None] * len(exprs), cols, dicts,
                           blocks.device)
    inputs = [(blocks.columns[n].data, blocks.columns[n].mask) for n, _ in prog.inputs]
    if views:
        inputs = shifted(inputs)
    n = blocks.padded_nrows
    kw = dict(filter=True, **rows) if filt else {}
    got = expr_program_cuda(prog, inputs, n, device=blocks.device, **kw)
    want = expr_program_reference(prog, inputs, n, device=blocks.device, **kw)
    return prog, got, want


def check_k6(label: str, exprs: List[Any], filt: bool, got: Any, want: Any) -> float:
    """Filter mode: keep flags and count exactly. Columns mode: each
    output's mask exactly and its values where valid bit for bit (NaN's
    sign aside), or within ``K6_FUNC_RTOL`` where it calls a float
    function. Returns the largest absolute difference."""
    import torch

    if filt:
        if not torch.equal(got[0], want[0]) or int(got[1]) != int(want[1]):
            raise SystemExit(f"FAIL expr_program {label}: keep or count differs from the twin "
                             f"({int(got[1])} vs {int(want[1])})")
        return 0.0
    worst = 0.0
    for e, (gv, gm), (wv, wm) in zip(exprs, got, want):
        if (gm is None) != (wm is None) or (gm is not None and not torch.equal(gm, wm)):
            raise SystemExit(f"FAIL expr_program {label}: the mask of {e} differs")
        if gv.dtype != wv.dtype:
            raise SystemExit(f"FAIL expr_program {label}: {e} is {gv.dtype}, twin {wv.dtype}")
        valid = torch.ones_like(gv, dtype=torch.bool) if gm is None else gm
        g, w = gv[valid], wv[valid]
        if g.is_floating_point():
            nan = torch.isnan(g)
            if not torch.equal(nan, torch.isnan(w)):
                raise SystemExit(f"FAIL expr_program {label}: NaNs of {e} differ")
            g, w = g[~nan], w[~nan]
            if _uses_func(e):
                if not torch.allclose(g.double(), w.double(), rtol=K6_FUNC_RTOL, atol=0):
                    raise SystemExit(f"FAIL expr_program {label}: {e} beyond rtol {K6_FUNC_RTOL}")
            elif not torch.equal(g.view(torch.int64 if g.element_size() == 8 else torch.int32),
                                 w.view(torch.int64 if w.element_size() == 8 else torch.int32)):
                raise SystemExit(f"FAIL expr_program {label}: {e} differs from the twin")
            finite = torch.isfinite(g) & torch.isfinite(w)
            if bool(finite.any()):
                worst = max(worst, float((g[finite].double() - w[finite].double()).abs().max()))
        elif not torch.equal(g, w):
            raise SystemExit(f"FAIL expr_program {label}: {e} differs from the twin")
    return worst


def prebuild_k6(blocks: Any, cases: List[Tuple[str, List[Any], bool]], label: str) -> None:
    """Builds K6's kernels of ``cases`` over ``blocks``' columns, in each
    mode a case runs in, all at once (``expr_program.build_kernels``:
    parallel ``nvcc``s), and prints the builds and their seconds."""
    import torch

    from fugue_tpu_torch.kernels import expr_program as ep

    cols = {n: (c.data.dtype, c.mask is not None) for n, c in blocks.columns.items()}
    dicts = {n: c.dictionary for n, c in blocks.columns.items() if c.is_string}
    specs = []
    for _, exprs, filt in cases:
        prog = ep.compile_program(exprs, [torch.bool] if filt else [None] * len(exprs), cols,
                                  dicts, blocks.device)
        masked = [blocks.columns[n].mask is not None for n, _ in prog.inputs]
        specs += [(prog, masked, mode) for mode in (("prefix", "row_valid") if filt
                                                    else ("columns",))]
    builds, secs, t = ep.expr_program_cuda.builds, ep.expr_program_cuda.build_seconds, \
        time.perf_counter()
    kernels = ep.build_kernels(specs)
    print(f"k6_prebuild {label}: " + json.dumps({
        "programs": len(specs), "kernels": len({k.name for k in kernels}),
        "built": ep.expr_program_cuda.builds - builds,
        "build_secs": ep.expr_program_cuda.build_seconds - secs,
        "wall_secs": time.perf_counter() - t}))


def expr_program_vs_twin(device: Any, sizes: Tuple[int, ...]) -> float:
    """K6 against its twin: every case of ``k6_cases`` at the sizes below
    10M rows, the paths' programs (``k6_path_programs``) at every size;
    filter programs over prefix rows (all, and all but 3) and a random
    ``row_valid``; below 10M rows each on aligned columns (the vector
    path) and on ``shifted`` views (the scalar path)."""
    import torch

    prebuild_k6(k6_frame(device, 1, SEED), k6_path_programs() + k6_cases(), "k6_cases")
    worst = 0.0
    for n in sizes:
        blocks = k6_frame(device, n, SEED + n % 97)
        rows_variants = [{"nrows": n}, {"nrows": max(n - 3, 0)},
                         {"row_valid": torch.rand((n,), device=device) < 0.6}]
        cases = k6_path_programs() + (k6_cases() if n < 10_000_000 else [])
        for label, exprs, filt in cases:
            for rows in (rows_variants if filt else [{}]):
                # aligned columns take the vector path; views one element in, the scalar
                for views in ((False, True) if n < 10_000_000 else (False,)):
                    _, got, want = _run_k6(blocks, exprs, filt, rows, views)
                    worst = max(worst, check_k6(f"{label} n={n} views={views}", exprs, filt,
                                                got, want))
        print(f"ok expr_program n={n}: {len(cases)} programs against the twin")
        del blocks
        torch.cuda.empty_cache()
    return worst


def k6_build_once(device: Any, n: int) -> Dict[str, Any]:
    """One binary a program structure: filters that differ only in their
    thresholds, and LIKEs by patterns over dictionaries of other entries
    and lengths, each group built once (``expr_program_cuda.builds``)
    and each program held against the twin."""
    import numpy as np
    import pyarrow as pa

    from fugue_tpu_torch.column.expressions import col
    from fugue_tpu_torch.column.functions import like
    from fugue_tpu_torch.kernels.expr_program import expr_program_cuda
    from fugue_tpu_torch.torch_backend.blocks import TorchBlocks, TorchColumn

    blocks = k6_frame(device, n, SEED)
    strings = k6_string_frame(device, n, STRING_SEED)
    s = strings.columns["s"]
    small = dict(strings.columns)
    small["s"] = TorchColumn(pa.string(), s.data % 7, s.mask, (0, 6),
                             dictionary=np.array([f"sku-{i}x" for i in range(7)], dtype=object))
    other = TorchBlocks(n, small, device)
    groups = {
        "thresholds": [(blocks, [(col("f64_b") > x) & (col("i32_b") != 3)], True)
                       for x in (0.9, 0.5, -10.0)],
        "like_patterns": [(frame, [like(col("s"), pat)], False)
                          for frame, pat in ((strings, "sku-1%"), (strings, "%7_"),
                                             (other, "sku-3%"))],
    }
    out = {}
    for name, runs in groups.items():
        before = expr_program_cuda.builds
        for frame, exprs, filt in runs:
            _, got, want = _run_k6(frame, exprs, filt, {"nrows": n} if filt else {})
            check_k6(f"build_once {name}", exprs, filt, got, want)
        out[name] = {"programs": len(runs), "builds": expr_program_cuda.builds - before}
        if out[name]["builds"] > 1:
            raise SystemExit(f"FAIL k6 {name}: {out[name]['builds']} builds for one structure")
    print("k6_build_once: " + json.dumps(out))
    return out


def filtered_frame(rows: int, groups: int, seed: int) -> Dict[str, Any]:
    """The headline frame (``k`` int32 over ``groups``, ``v`` float32, from
    seed 42's generator as ``bench.py:538-545``), ``u`` int32 uniform over
    [0, 10000) and ``x`` float64 with about 5 % nulls."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = rng.integers(0, groups, rows).astype(np.int32)
    v = rng.random(rows).astype(np.float32)
    u = rng.integers(0, DISTINCT_VALUES, rows).astype(np.int32)
    x = rng.standard_normal(rows)
    xnull = rng.random(rows) < 0.05
    return {"k": k, "v": v, "u": u, "x": x, "xnull": xnull}


def build_filtered_paths(device: Any, rows: int, groups: int, seed: int
                         ) -> Tuple[Dict[str, Callable[[], Tuple[float, Any, Any]]], Dict[str, Any]]:
    """Upload ``filtered_frame`` and return ``(run_for, data)``:
    ``run_for["filtered_pipeline"]`` runs the headline UDF (``v2 =
    v*2+1``, ``k``, ``v``, ``u`` and ``x`` passed through), the filter
    ``FILTER_COND``, ``assign(w=CASE WHEN v2 > 2.0 THEN v2*2-1 ELSE
    COALESCE(x, 0.0) END, y=CAST(u AS double) / 3)`` and the aggregate by
    ``k`` of sum/avg of ``w`` and ``y`` and the count to pandas;
    ``run_for["where_having"]`` the UDF, then ``SELECT k, SUM(v2*2) AS s,
    AVG(v) AS m, COUNT(*) AS c WHERE v < 0.9 GROUP BY k HAVING COUNT(*) >
    t`` through ``fugue_tpu_torch.select``, ``t`` = ``HAVING_COUNT`` at
    100M rows over 1024 groups and scaled with the rows a group. Each
    returns ``(seconds, the filtered frame, result pandas)``."""
    import pyarrow as pa
    import torch

    import fugue_tpu_torch as ft
    from fugue_tpu_torch import aggregate, col, functions as ff
    from fugue_tpu_torch import make_execution_engine, transform
    from fugue_tpu_torch.column.functions import case_when, coalesce

    d = filtered_frame(rows, groups, seed)
    engine = make_execution_engine("torch", device=device)
    table = pa.table({"k": d["k"], "v": d["v"], "u": d["u"],
                      "x": pa.array(d["x"], mask=d["xnull"])})
    src = engine.persist(engine.to_df(table))
    del table
    # near the median group count at every size: about half the groups stay
    threshold = round(HAVING_COUNT * (rows / groups) / (ROWS / GROUPS))

    def udf(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": a["k"], "v": a["v"], "v2": a["v"] * 2.0 + 1.0, "u": a["u"], "x": a["x"]}

    def transformed() -> Any:
        return transform(src, udf, schema="k:int,v:float,v2:float,u:int,x:double",
                         engine=engine, as_fugue=True)

    def pipeline() -> Tuple[float, Any, Any]:
        t = time.perf_counter()
        kept = ft.filter(transformed(),
                         ((col("v2") >= 1.2) & (col("u") != 7)) | col("x").is_null(),
                         engine=engine, as_fugue=True)
        wy = ft.assign(kept, engine=engine, as_fugue=True,
                       w=case_when(col("v2") > 2.0, col("v2") * 2 - 1, coalesce(col("x"), 0.0)),
                       y=col("u").cast(pa.float64()) / 3)
        res = aggregate(wy, partition_by="k", engine=engine, as_fugue=True,
                        sw=ff.sum(col("w")), mw=ff.avg(col("w")), sy=ff.sum(col("y")),
                        my=ff.avg(col("y")), c=ff.count(col("w")))
        pdf = res.as_pandas()
        return time.perf_counter() - t, kept, pdf

    def where_having() -> Tuple[float, Any, Any]:
        t = time.perf_counter()
        res = ft.select(transformed(), col("k"), ff.sum(col("v2") * 2).alias("s"),
                        ff.avg(col("v")).alias("m"), ff.count(col("*")).alias("c"),
                        where=col("v") < 0.9, having=ff.count(col("*")) > threshold,
                        engine=engine, as_fugue=True)
        pdf = res.as_pandas()
        return time.perf_counter() - t, res, pdf

    d["threshold"] = threshold
    return {"filtered_pipeline": pipeline, "where_having": where_having}, d


def filtered_oracle(d: Dict[str, Any], groups: int) -> Dict[str, Dict[str, Any]]:
    """Both filtered paths from numpy, in the declared types: ``v2`` and
    ``v2*2-1`` and ``v2*2`` in float32, comparisons and ``w``, ``y`` in
    float64; sums and means per group in float64."""
    import numpy as np

    k, v, u, x, xnull = d["k"], d["v"], d["u"], d["x"], d["xnull"]
    v2 = v * np.float32(2.0) + np.float32(1.0)
    v2d = v2.astype(np.float64)
    keep = ((v2d >= 1.2) & (u != 7)) | xnull
    w = np.where(v2d > 2.0, (v2 * np.float32(2.0) - np.float32(1.0)).astype(np.float64),
                 np.where(xnull, 0.0, x))
    y = u.astype(np.float64) / 3.0
    kk = k[keep]
    c = np.bincount(kk, minlength=groups)
    occ = np.nonzero(c)[0]
    sw = np.bincount(kk, weights=w[keep], minlength=groups)
    sy = np.bincount(kk, weights=y[keep], minlength=groups)
    pipeline = {"kept": int(keep.sum()), "k": occ.astype(np.int32), "c": c[occ],
                "sw": sw[occ], "mw": sw[occ] / c[occ], "sy": sy[occ], "my": sy[occ] / c[occ]}
    where = v.astype(np.float64) < 0.9
    kk = k[where]
    c = np.bincount(kk, minlength=groups)
    s = np.bincount(kk, weights=(v2 * np.float32(2.0))[where].astype(np.float64),
                    minlength=groups)
    m = np.bincount(kk, weights=v[where].astype(np.float64), minlength=groups)
    survive = np.nonzero(c > d["threshold"])[0]
    having = {"kept": int(where.sum()), "k": survive.astype(np.int32), "c": c[survive],
              "s": s[survive], "m": m[survive] / c[survive],
              "groups_before_having": int((c > 0).sum())}
    return {"filtered_pipeline": pipeline, "where_having": having}


def _check_columns(pdf: Any, want: Dict[str, Any], exact: Tuple[str, ...],
                   inexact: Dict[str, float], label: str) -> Dict[str, float]:
    import numpy as np

    pdf = pdf.sort_values("k").reset_index(drop=True)
    if len(pdf) != len(want["k"]):
        raise SystemExit(f"FAIL {label}: {len(pdf)} groups, expected {len(want['k'])}")
    for name in exact:
        if not np.array_equal(pdf[name].to_numpy(), want[name]):
            raise SystemExit(f"FAIL {label}: {name} differs from numpy")
    rel = {}
    for name, tol in inexact.items():
        got = pdf[name].to_numpy().astype(np.float64)
        rel[name] = float(np.max(np.abs(got - want[name]) / np.abs(want[name]))) if len(got) else 0.0
        if not (np.all(np.isfinite(got)) and rel[name] <= tol):
            raise SystemExit(f"FAIL {label}: {name} off by rtol {rel[name]}")
    return rel


# each path's launches in one run: K6 once per filter, assign and
# aggregate argument list that is more than bare columns
# an aggregate's result is a masked frame over its bins: its export to
# pandas compacts it with one K10 launch (blocks.leading_rows), here and in
# every path below that ends in a masked frame's as_pandas
K6_PATH_LAUNCHES = {
    "filtered_pipeline": dict(expr_program=2, expr_program_filter=1, binned_sums=1,
                              gather_rows=1),
    "where_having": dict(expr_program=3, expr_program_filter=2, binned_sums=1, gather_rows=1),
    "config3_select": dict(binned_sums=1, gather_rows=1),
}
FLOAT64_SUM_RTOL = 1e-9  # float64 sums of float64 values in another order


def _path_stats(label: str, rows: int, run_once: Callable[[], Tuple[float, Any, Any]],
                device: Any, warm_runs: int, launches: Optional[Dict[str, int]] = None
                ) -> Tuple[Dict[str, Any], Any, Any]:
    """Cold and warm runs of one path with the launch counts of each,
    held to ``K6_PATH_LAUNCHES``, ``JOIN_PATH_LAUNCHES``,
    ``STRING_PATH_LAUNCHES``, ``RELATIONAL_PATH_LAUNCHES``,
    ``COMAP_PATH_LAUNCHES`` on the card, or to ``launches`` where given;
    returns the stats, the cold run's frame and pandas."""
    import torch

    from fugue_tpu_torch.kernels.expr_program import expr_program_cuda

    zero_launches()
    builds, build_secs = expr_program_cuda.builds, expr_program_cuda.build_seconds
    cold_secs, frame, pdf = run_once()
    cold = launch_counts()
    builds, build_secs = (expr_program_cuda.builds - builds,
                          expr_program_cuda.build_seconds - build_secs)
    lazy = frame.blocks._nrows is None
    zero_launches()
    warm = [run_once()[0] for _ in range(warm_runs)]
    warm_launches = launch_counts()
    best = min(warm) if warm else cold_secs
    want = dict.fromkeys(cold, 0)
    if device.type == "cuda":  # on the CPU every kernel runs as its twin
        want.update(launches or {**K6_PATH_LAUNCHES, **JOIN_PATH_LAUNCHES,
                                 **STRING_PATH_LAUNCHES, **RELATIONAL_PATH_LAUNCHES,
                                 **COMAP_PATH_LAUNCHES}[label])
    warm_want = {k: 0 if k in CACHED_ON_FRAME.get(label, ()) else v * warm_runs
                 for k, v in want.items()}
    if cold != want or warm_launches != warm_want:
        raise SystemExit(f"FAIL {label}: launched {cold} (cold), {warm_launches} (warm), "
                         f"expected {want} a run")
    return {
        "case": label,
        "rows": rows,
        "cold_secs": cold_secs,
        "k6_builds_cold": builds,
        "k6_build_secs_cold": build_secs,
        "warm_secs": warm,
        "best_warm_secs": best,
        "rows_per_sec": rows / best,
        "max_memory_allocated": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None),
        "launches": cold,
        "warm_launches": warm_launches,
        "count_lazy_after_run": lazy,
    }, frame, pdf


def filtered_paths(device: Any, rows: int, groups: int, seed: int,
                   warm_runs: int) -> List[Dict[str, Any]]:
    """The filtered pipeline and the WHERE/HAVING select at ``rows`` rows
    (``build_filtered_paths``), each against ``filtered_oracle``: keys,
    counts, the filter's count and the HAVING survivors exactly, float64
    sums and means within ``FLOAT64_SUM_RTOL``, float32-accumulated ones
    within ``MAIN_PATH_RTOL``. The filter's count must still be lazy after
    a run (no readback inside it)."""
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run_for, d = build_filtered_paths(device, rows, groups, seed)
    want = filtered_oracle(d, groups)
    out = []
    for label, inexact, exact in (
        ("filtered_pipeline", {"sw": FLOAT64_SUM_RTOL, "mw": FLOAT64_SUM_RTOL,
                               "sy": FLOAT64_SUM_RTOL, "my": FLOAT64_SUM_RTOL}, ("k", "c")),
        ("where_having", {"s": MAIN_PATH_RTOL, "m": MAIN_PATH_RTOL}, ("k", "c")),
    ):
        stats, frame, pdf = _path_stats(label, rows, run_for[label], device, warm_runs)
        if label == "filtered_pipeline":
            if not stats["count_lazy_after_run"]:
                raise SystemExit(f"FAIL {label}: the filter's count was read in the run")
            got_kept = frame.count()
            if got_kept != want[label]["kept"]:
                raise SystemExit(f"FAIL {label}: the filter kept {got_kept}, numpy "
                                 f"{want[label]['kept']}")
            stats["kept_rows"] = got_kept
            if list(pdf.columns) != ["k", "sw", "mw", "sy", "my", "c"]:
                raise SystemExit(f"FAIL {label}: columns {list(pdf.columns)}")
        else:
            if list(pdf.columns) != ["k", "s", "m", "c"]:
                raise SystemExit(f"FAIL {label}: columns {list(pdf.columns)}")
            stats["groups_before_having"] = want[label]["groups_before_having"]
            stats["having_survivors"] = len(pdf)
            stats["having_threshold"] = d["threshold"]
        stats["max_rel_err"] = _check_columns(pdf, want[label], exact, inexact, label)
        out.append(stats)
    return out


def build_config3(device: Any, rows: int) -> Tuple[Callable[[], Tuple[float, Any, Any]],
                                                  Tuple[Any, Any]]:
    """Upload BASELINE config 3's frame (``bench.py:841-870``: ``rows``
    rows of ``k`` int32 uniform over 256 and ``v`` float32 from seed 2)
    and return ``(run_once, (k, v))``: ``SELECT k, SUM(v) AS s, AVG(v) AS
    m, COUNT(*) AS c GROUP BY k`` built as ``SelectColumns`` (the SQL
    parser is not ported) and run by the engine's ``select`` to pandas."""
    import numpy as np
    import pandas as pd

    from fugue_tpu_torch import SelectColumns, col, functions as ff, make_execution_engine

    rng = np.random.default_rng(CONFIG3_SEED)
    k = rng.integers(0, CONFIG3_GROUPS, rows).astype(np.int32)
    v = rng.random(rows).astype(np.float32)
    engine = make_execution_engine("torch", device=device)
    src = engine.persist(engine.to_df(pd.DataFrame({"k": k, "v": v})))
    stmt = SelectColumns(col("k"), ff.sum(col("v")).alias("s"), ff.avg(col("v")).alias("m"),
                         ff.count(col("*")).alias("c"))

    def run_once() -> Tuple[float, Any, Any]:
        t = time.perf_counter()
        res = engine.select(src, stmt)
        pdf = res.as_pandas()
        return time.perf_counter() - t, res, pdf

    return run_once, (k, v)


def config3_select(device: Any, rows: int, warm_runs: int) -> Dict[str, Any]:
    """``build_config3``'s select, checked against numpy: keys and counts
    exactly, float32-accumulated sums and means within
    ``MAIN_PATH_RTOL``."""
    import numpy as np
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run_once, (k, v) = build_config3(device, rows)
    stats, _, pdf = _path_stats("config3_select", rows, run_once, device, warm_runs)
    c = np.bincount(k, minlength=CONFIG3_GROUPS)
    s = np.bincount(k, weights=v.astype(np.float64), minlength=CONFIG3_GROUPS)
    occ = np.nonzero(c)[0]
    want = {"k": occ.astype(np.int32), "c": c[occ], "s": s[occ], "m": s[occ] / c[occ]}
    if list(pdf.columns) != ["k", "s", "m", "c"]:
        raise SystemExit(f"FAIL config3_select: columns {list(pdf.columns)}")
    stats["groups"] = len(pdf)
    stats["max_rel_err"] = _check_columns(pdf, want, ("k", "c"),
                                          {"s": MAIN_PATH_RTOL, "m": MAIN_PATH_RTOL},
                                          "config3_select")
    return stats


def _twin_kernels(fn: Callable[[], Any]) -> Optional[int]:
    """The CUDA kernels one call of ``fn`` launches, from the profiler
    (None where it records none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return n or None


def _k6_kernel(prog: Any, inputs: List[Any], kw: Dict[str, Any]) -> Any:
    """The generated kernel ``expr_program_cuda`` runs ``prog`` on (built
    already by the call that checked it)."""
    from fugue_tpu_torch.kernels import expr_program as ep

    mode = ep._mode(bool(kw.get("filter")), kw.get("row_valid"))
    return ep.build_kernels([(prog, [m is not None for _, m in inputs], mode)])[0]


def shifted(inputs: List[Any]) -> List[Any]:
    """Each input column and mask as a view one element into a copy one
    row longer: the same rows at an address no vector load takes, so K6
    runs its scalar path (as on a slice of a column)."""
    import torch

    def view(t: Any) -> Any:
        if t is None:
            return None
        out = torch.empty((t.shape[0] + 1,), dtype=t.dtype, device=t.device)
        out[1:] = t
        return out[1:]

    return [(view(v), view(m)) for v, m in inputs]


def expr_timing(device: Any, launches: Dict[str, int]) -> List[Dict[str, Any]]:
    """K6 with CUDA events at the filtered paths' shapes (100M rows of a
    float32 ``v2``, an int32 ``u`` and a float64 ``x`` with nulls, a
    prefix frame): each path program of ``k6_path_programs`` beside its
    twin (time and the CUDA kernels one call launches) and its bound, the
    bytes it must move over the HBM rate (each input read once, only the
    mask of an input read only for IS NULL, each output and mask written
    once) against its instructions over the float64 rate. Returns the
    ``kernels`` entries of the columns mode (the assign program) and of
    the filter mode (the filter program); ``launches`` holds each mode's
    launches in one run of the filtered pipeline."""
    import torch

    from fugue_tpu_torch.kernels.expr_program import compile_program, expr_program_cuda
    from fugue_tpu_torch.kernels.reference import expr_program_reference

    blocks = k6_frame(device, ROWS, SEED)
    entries = []
    for label, exprs, filt in k6_path_programs():
        cols = {n: (c.data.dtype, c.mask is not None) for n, c in blocks.columns.items()}
        prog = compile_program(exprs, [torch.bool] if filt else [None] * len(exprs), cols)
        inputs = [(blocks.columns[n].data, blocks.columns[n].mask) for n, _ in prog.inputs]
        kw = dict(filter=True, nrows=ROWS) if filt else {}
        got = expr_program_cuda(prog, inputs, ROWS, device=device, **kw)
        want = expr_program_reference(prog, inputs, ROWS, device=device, **kw)
        err = check_k6(f"{label} timed", exprs, filt, got, want)
        del got
        ms = time_cuda(lambda: expr_program_cuda(prog, inputs, ROWS, device=device, **kw), 20)
        views = shifted(inputs)
        check_k6(f"{label} timed, scalar path", exprs, filt,
                 expr_program_cuda(prog, views, ROWS, device=device, **kw), want)
        ms_scalar = time_cuda(lambda: expr_program_cuda(prog, views, ROWS, device=device, **kw),
                              20)
        del views, want
        plain_ms = time_cuda(
            lambda: expr_program_reference(prog, inputs, ROWS, device=device, **kw), 5)
        twin_kernels = _twin_kernels(
            lambda: expr_program_reference(prog, inputs, ROWS, device=device, **kw))
        per_row = _k6_kernel(prog, inputs, kw).bytes_per_row
        entry = _kernel_entry(
            "expr_program" if label == "path_assign" else f"expr_program[{label}]",
            "fugue_tpu/jax_backend/expr_eval.py:109", 0, err, ms, plain_ms, per_row * ROWS,
            len(prog.instrs) * ROWS, None, source="expr_codegen.py", ops_per_s=FP64_OPS_PER_S)
        entry["instrs"] = len(prog.instrs)
        entry["bytes_per_row"] = per_row
        entry["ms_scalar"] = ms_scalar
        entry["twin_cuda_kernels"] = twin_kernels
        print("expr_program timed: " + json.dumps(entry))
        if label == "path_assign":
            entry["replaces"] = "fugue_tpu/jax_backend/execution_engine.py:1446"
            entry["launches"] = launches["columns"]
            entries.append({k: entry[k] for k in _ENTRY_KEYS})
        elif label == "path_filter":
            entry["name"] = "expr_program_filter"
            entry["replaces"] = "fugue_tpu/jax_backend/execution_engine.py:1387"
            entry["launches"] = launches["filter"]
            entries.append({k: entry[k] for k in _ENTRY_KEYS})
    del blocks
    torch.cuda.empty_cache()
    return entries


def k6_scaling(device: Any) -> List[Dict[str, Any]]:
    """Where K6's time goes, at 100M rows with CUDA events: programs from
    none to 31 instructions over one float32 column (with a mask and
    without), no input at all, several outputs, a filter; beside torch's
    copy and multiply of the same column. Each on a line of its own."""
    import torch

    from fugue_tpu_torch.column.expressions import col, lit
    from fugue_tpu_torch.kernels.expr_program import compile_program, expr_program_cuda

    blocks = k6_frame(device, ROWS, SEED)
    cols = {k: (c.data.dtype, c.mask is not None) for k, c in blocks.columns.items()}

    def chain(name: str, k: int) -> Any:
        e = col(name)
        for _ in range(k):
            e = e * 2
        return e

    cases = {
        "mul_f32": ([chain("f32_b", 1)], False),
        "mul_f32_masked": ([chain("f32", 1)], False),
        "no_input": ([lit(1.5) + 0.0], False),
        "chain8_f32": ([chain("f32_b", 8)], False),
        "chain30_f32": ([chain("f32_b", 30)], False),
        "chain8_i64": ([chain("i64_b", 8)], False),
        "four_outputs": ([chain("f32_b", 1), col("i32_b") + 1, col("f64_b") * 3.0,
                          col("i64_b") - 1], False),
        "filter_lt": ([col("f32_b") < 0.9], True),
        "filter_no_input": ([lit(True)], True),
    }
    out = []
    for name, (exprs, filt) in cases.items():
        prog = compile_program(exprs, [torch.bool] if filt else [None] * len(exprs), cols)
        inputs = [(blocks.columns[k].data, blocks.columns[k].mask) for k, _ in prog.inputs]
        kw = dict(filter=True, nrows=ROWS) if filt else {}
        row = {"case": name, "instrs": len(prog.instrs), "inputs": len(prog.inputs),
               "nregs": prog.nregs,
               "ms": time_cuda(lambda: expr_program_cuda(prog, inputs, ROWS, device=device, **kw),
                               20),
               }
        print("k6_scaling: " + json.dumps(row))
        out.append(row)
    x = blocks.columns["f32_b"].data
    for name, fn in (("torch_copy", x.clone), ("torch_mul", lambda: x * 2)):
        row = {"case": name, "ms": time_cuda(fn, 20)}
        print("k6_scaling: " + json.dumps(row))
        out.append(row)
    del blocks
    torch.cuda.empty_cache()
    return out


# --- joins: K7-K10 against their twins, the join paths, timing ---

JOIN3B_ROWS = 5_000_000  # config 3b's facts as published (bench.py:883)
JOIN3B_GROUPS = 256
JOIN3B_SEED = 5
JOIN_EXPAND_ROWS = 100_000_000  # config 10's join at the headline's scale
JOIN_CHECK_ROWS = 10_000_000  # where the expansion's output is compared row for row
JOIN_KINDS_ROWS = (10_000_000, 5_000_000)  # left and right rows of the other kinds
JOIN_CROSS_ROWS = (10_000, 1_000)
JOIN_SKEW = 1_000_000  # the matches of the skewed key
K9_WALK = 64 * 2048  # K9's probe rows read by a tile, at most (kWalk in join.cu)
# K7's segment counts in join_side_cases: its shared route, its global
# route (from 12,289 to join.GLOBAL_MAX, 2^23), then its slab route (slabs
# of 2^15 segments) from just past the global route's last, with a last
# slab of one segment, to config 10's 25M
JOIN_SIDE_SEGMENTS = (1, 1024, 12_289, (1 << 18) - 1, (1 << 18) + 1, (1 << 23) + 1, 25_000_000)
JOIN_KINDS = ("left_outer", "right_outer", "full_outer", "semi", "anti")


def _same(label: str, got: Any, want: Any) -> None:
    """Kernel output against its twin's, exactly: the same dtype, shape
    and bits (None against None)."""
    import torch

    if (got is None) != (want is None):
        raise SystemExit(f"FAIL {label}: one output is None")
    if got is None:
        return
    if got.dtype != want.dtype or got.shape != want.shape:
        raise SystemExit(f"FAIL {label}: {got.dtype}{tuple(got.shape)} against "
                         f"{want.dtype}{tuple(want.shape)}")
    if got.dtype.is_floating_point:
        got, want = got.view(torch.uint8), want.view(torch.uint8)
    if not torch.equal(got, want):
        raise SystemExit(f"FAIL {label}: differs from its twin")


def join_side_cases(device: Any, n: int, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """K7's and K8's cases at ``n`` rows: ``(label, {"build": seg, "probe":
    seg, "num": S, rows...})``, the rows (``nrows`` or ``row_valid``) and
    ``nulls`` shared by both sides. Segments: each of
    ``JOIN_SIDE_SEGMENTS`` (K7's shared route to 12,288, its global route
    to 2^23, its slab route above); the build ids cover three
    quarters of them, so probe rows find no match; a twentieth of the rows
    carry the sentinel S; prefix, short-prefix and masked layouts, with
    and without null keys; one key with ``JOIN_SKEW`` build rows; from
    768 rows, three segments with 254, 255 and 256 build rows; one
    segment of 25M that every build row holds."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def flags(p: float) -> Any:
        return torch.rand((n,), generator=gen, device=device) < p

    def ids(hi: int, num: int) -> Any:
        seg = torch.randint(0, hi, (n,), generator=gen, device=device, dtype=torch.int32)
        return torch.where(flags(0.05), num, seg)

    out = []
    for num in JOIN_SIDE_SEGMENTS:
        sides = dict(build=ids(max(num * 3 // 4, 1), num), probe=ids(num, num), num=num)
        nulls, row_valid = flags(0.1), flags(0.7)
        out += [
            (f"S={num} prefix", dict(sides, nrows=n)),
            (f"S={num} short-prefix nulls", dict(sides, nrows=n // 2, nulls=nulls)),
            (f"S={num} masked nulls", dict(sides, row_valid=row_valid, nulls=nulls)),
            (f"S={num} masked bytes", dict(sides, row_valid=row_valid.to(torch.uint8))),
        ]
    build = torch.randint(0, 1024, (n,), generator=gen, device=device, dtype=torch.int32)
    hot = torch.randperm(n, generator=gen, device=device)[:JOIN_SKEW]
    build[hot] = 7
    out.append(("skew", dict(build=build, probe=ids(1024, 1024), num=1024, nrows=n)))
    if n >= 3 * 256:
        # segments 0, 1 and 2 with 254, 255 and 256 build rows, the rest over
        # [3, 1024): K8's byte entries below, at and above its escape
        build = torch.randint(3, 1024, (n,), generator=gen, device=device, dtype=torch.int32)
        build[torch.randperm(n, generator=gen, device=device)[:254 + 255 + 256]] = torch.cat([
            torch.full((c,), j, dtype=torch.int32, device=device)
            for j, c in enumerate((254, 255, 256))])
        out.append(("counts 254, 255, 256", dict(build=build, probe=ids(1024, 1024), num=1024,
                                                  nrows=n, nulls=flags(0.1))))
    many = JOIN_SIDE_SEGMENTS[-1]
    out.append(("one segment of 25M holding every row", dict(
        build=torch.full((n,), many // 3, dtype=torch.int32, device=device),
        probe=ids(many, many), num=many, nrows=n)))
    return out


def _expand_inputs(probe: Any, build: Any, num: int, outer: bool) -> Dict[str, Any]:
    """K9's arguments for prefix sides with these segment ids (every row
    real, none null), from the twins of K7 and K8."""
    import torch

    from fugue_tpu_torch.kernels.reference import join_build_reference, join_probe_reference

    counts = join_build_reference(build, num, nrows=int(build.shape[0]))
    pr = join_probe_reference(probe, counts, "expand", nrows=int(probe.shape[0]), outer=outer)
    order = torch.sort(build.clamp(max=num), stable=True).indices
    return dict(start=torch.cumsum(pr.reps, 0, dtype=torch.int64) - pr.reps, m=pr.m,
                seg1=probe, cstart2=torch.cumsum(counts, 0, dtype=torch.int64) - counts,
                order2=order, total=int(pr.total))


def expand_timing_inputs(device: Any) -> Dict[str, Any]:
    """K9's arguments at ``join_timing``'s expansion: ``JOIN_EXPAND_ROWS``
    probe rows against half as many build rows over a quarter as many
    segments, 200M output rows at the default."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    p1, p2 = JOIN_EXPAND_ROWS, JOIN_EXPAND_ROWS // 2
    num = p1 // 4
    seg1 = (torch.randperm(p1, generator=gen, device=device) % num).to(torch.int32)
    seg2 = (torch.randperm(p2, generator=gen, device=device) % num).to(torch.int32)
    return _expand_inputs(seg1, seg2, num, False)


def expand_cases(device: Any, n: int, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """K9's cases at ``n`` probe rows: keys over n/2 segments with two
    build rows each for nine tenths of them (about 1.8n outputs; inner and
    outer); a cross join (S = 1) of up to 10^4 by 10^3 rows; one probe
    row whose key has ``JOIN_SKEW`` build rows among one build row a key,
    at a tile's first output and from inside a tile; one probe row in 50
    and one in 50,000 with a match (a tile's outputs span many probe rows
    with empty runs: past ``K9_WALK`` of them, K9's search an output); the
    first half of the probe rows matched and one in 50,000 of the rest
    (both of K9's branches in one launch); one output; a probe row with no match
    at a tile's first output (inner: an empty run there; outer: its one
    output row there)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    half = max(n // 2, 1)
    probe = torch.randint(0, half, (n,), generator=gen, device=device, dtype=torch.int32)
    keys = torch.arange(half * 9 // 10 + 1, dtype=torch.int32, device=device)
    build = keys.repeat(2)[torch.randperm(2 * int(keys.shape[0]), generator=gen, device=device)]
    cp, cb = min(n, JOIN_CROSS_ROWS[0]), JOIN_CROSS_ROWS[1]
    zero = torch.zeros((cp,), dtype=torch.int32, device=device)
    one_each = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    skewed = torch.cat([one_each, torch.zeros((JOIN_SKEW - 1,), dtype=torch.int32,
                                              device=device)])
    # K9's tiles (kTile in join.cu): an unmatched probe row where a tile
    # starts, and a run of JOIN_SKEW rows that starts inside a tile
    tile, at = 2048, min(n - 1, 2048)
    hole = torch.arange(n, dtype=torch.int32, device=device)
    hole[at] = n  # a key with no build row
    mid = (torch.arange(n, dtype=torch.int32, device=device) - min(n - 1, tile // 2 + 3)) % n
    one = torch.zeros((1,), dtype=torch.int32, device=device)
    return [
        ("total = 1", _expand_inputs(one, one, 1, False)),
        ("m = 0 at a tile's first output, inner", _expand_inputs(
            hole, torch.arange(n, dtype=torch.int32, device=device), n + 1, False)),
        ("m = 0 at a tile's first output, outer", _expand_inputs(
            hole, torch.arange(n, dtype=torch.int32, device=device), n + 1, True)),
        ("a run from mid-tile over several tiles", _expand_inputs(mid, skewed, n, False)),
        ("pairs inner", _expand_inputs(probe, build, half, False)),
        ("pairs outer", _expand_inputs(probe, build, half, True)),
        ("cross", _expand_inputs(zero, torch.zeros((cb,), dtype=torch.int32, device=device),
                                 1, False)),
        ("skew", _expand_inputs(torch.arange(n, dtype=torch.int32, device=device), skewed, n,
                                True)),
        ("sparse", _expand_inputs(one_each, torch.arange(max(n // 50, 1), dtype=torch.int32,
                                                         device=device), n, False)),
        ("sparse, 1 in 50000", _expand_inputs(one_each, torch.arange(
            max(n // 50_000, 1), dtype=torch.int32, device=device), n, False)),
        ("dense, then 1 in 50000", _expand_inputs(
            torch.arange(n, dtype=torch.int32, device=device),
            torch.cat([torch.arange(n // 2, dtype=torch.int32, device=device),
                       torch.arange(n // 2, n, 50_000, dtype=torch.int32, device=device)]),
            n, False)),
    ]


_GATHER_DTYPES = ("bool", "uint8", "int8", "int16", "int32", "int64", "float32", "float64")


def gather_cases(device: Any, n: int, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """K10's cases at ``n`` rows: 16 columns (every dtype, with and
    without a mask: two launches, and on the slab route several column
    groups), gathered by an index with a tenth -1 (as an outer join's
    right side, and as not outer: -1 still writes 0), by one with
    duplicates and no -1 (scattered, and as an index in order: the direct
    route), by a random permutation (also as outer, on three columns with
    no mask), and 2 columns of at most 65,536 rows (under L2: the direct
    route, whatever the caller says) by a scattered index."""
    import torch

    from fugue_tpu_torch.kernels.reference import GatherColumn

    gen = torch.Generator(device=device).manual_seed(seed)
    cols = []
    for masked in (False, True):
        for name in _GATHER_DTYPES:
            dtype = getattr(torch, name)
            bits = torch.randint(-(2**62), 2**62, (n,), generator=gen, device=device)
            if dtype == torch.bool:
                values = bits > 0
            elif dtype.is_floating_point:
                values = bits.to(torch.int32 if dtype == torch.float32 else torch.int64)
                values = values.view(dtype)  # every bit pattern, NaNs included
            else:
                values = bits.to(dtype)
            mask = torch.rand((n,), generator=gen, device=device) < 0.8 if masked else None
            cols.append(GatherColumn(values, mask))
    idx = torch.randint(0, n, (n,), generator=gen, device=device, dtype=torch.int32)
    holes = torch.where(torch.rand((n,), generator=gen, device=device) < 0.1, -1, idx)
    perm = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    few = min(n, 1 << 16)
    small = [GatherColumn(torch.randint(-(2**62), 2**62, (few,), generator=gen, device=device),
                          None),
             GatherColumn(torch.rand((few,), generator=gen, device=device),
                          torch.rand((few,), generator=gen, device=device) < 0.8)]
    small_idx = torch.randint(0, few, (n,), generator=gen, device=device, dtype=torch.int32)
    return [
        ("index with -1, outer", dict(columns=cols, idx=holes, outer=True, scattered=True)),
        ("index with -1, not outer", dict(columns=cols, idx=holes, outer=False,
                                          scattered=True)),
        ("index with duplicates", dict(columns=cols, idx=idx, outer=False, scattered=True)),
        ("index in range, in order", dict(columns=cols, idx=idx, outer=False)),
        ("a random permutation", dict(columns=cols, idx=perm, outer=False, scattered=True)),
        ("a random permutation, outer, unmasked", dict(columns=cols[3:6], idx=perm, outer=True,
                                                       scattered=True)),
        ("a source under L2", dict(columns=small, idx=small_idx, outer=True, scattered=True)),
    ]


def check_buckets(label: str, buckets: Any, total: Optional[int] = None) -> None:
    """A partition of ``slab_partition.cuh`` (K7's and K10's slab routes)
    left each bucket's cursor at the next bucket's start, and its counts
    add to its entries (``total`` where the caller knows them)."""
    import torch

    counts, starts, cursor = (t.to(torch.int64) for t in buckets)
    want = int(starts[-1]) if total is None else total
    if (int(counts.sum()) != want or int(starts[-1]) != want
            or not torch.equal(cursor, starts[1:])
            or not torch.equal(starts[1:] - starts[:-1], counts)):
        raise SystemExit(f"FAIL {label}: the partition's buckets disagree with their counts")


def probe_vs_twin(seg: Any, table: Any, mode: str, label: str, seen: Set[Tuple[str, str]],
                  **kw: Any) -> None:
    """K8 in ``mode`` against its twin, exactly, ``last_path`` asserted
    to be ``join.probe_place``'s; ``seen`` gets the (mode, place)."""
    from fugue_tpu_torch.kernels import join
    from fugue_tpu_torch.kernels.reference import join_probe_reference

    want = join_probe_reference(seg, table, mode, **kw)
    place = join.probe_place(mode, int(table.shape[0]))
    got = join.join_probe_cuda(seg, table, mode, **kw)
    # a stand-in without a last_path (the twin, in a CPU rehearsal) is
    # taken at its word
    actual = getattr(join.join_probe_cuda, "last_path", place)
    if actual != place:
        raise SystemExit(f"FAIL join_probe {label} {mode}: read its table from {actual}, "
                         f"not {place}")
    seen.add((mode, place))
    for field in want._fields:
        _same(f"join_probe {label} {mode} {place} {field}", getattr(got, field),
              getattr(want, field))


def not_in_vs_twin(case: Dict[str, Any], rows: Dict[str, Any], label: str,
                   seen: Set[Tuple[str, str]]) -> None:
    """K7's side counts and K8's NOT IN mode against their twins, exactly
    (``probe_vs_twin``): over the case's build
    side, and with side counts of an empty build side and of one holding a
    null, so that each of NOT IN's three answers is taken."""
    import torch

    from fugue_tpu_torch.kernels.join import join_build_cuda
    from fugue_tpu_torch.kernels.reference import join_build_reference

    args = (case["build"], case["num"])
    got, got_stats = join_build_cuda(*args, side_counts=True, **rows)
    want, want_stats = join_build_reference(*args, side_counts=True, **rows)
    _same(f"join_build {label} side counts table", got, want)
    _same(f"join_build {label} side counts", got_stats, want_stats)
    device = want.device
    for what, stats in (("as built", want_stats),
                        ("empty build side", torch.zeros((2,), dtype=torch.int32, device=device)),
                        ("a null on the build side",
                         torch.tensor([5, 1], dtype=torch.int32, device=device))):
        probe_vs_twin(case["probe"], want, "not_in", f"{label} {what}", seen, stats=stats,
                      **rows)


def join_vs_twin(device: Any, sizes: Tuple[int, ...]) -> None:
    """K7, K8 in every mode (NOT IN's too, ``not_in_vs_twin``), K9 and K10
    against their twins, exactly, in every case of ``join_side_cases``,
    ``expand_cases`` and ``gather_cases`` at each size; K8 at the place
    of its table that ``join.probe_place`` picks (``probe_vs_twin``), each
    mode at the places of its tables over the fewest and the most of
    ``JOIN_SIDE_SEGMENTS`` (all of K8's places of that mode on the card);
    prints K7's path and K10's route of each case, and checks the buckets
    of their slab routes (``check_buckets``, ``check_fill``)."""
    import torch

    from fugue_tpu_torch.kernels.gather import gather_route, gather_rows_cuda
    from fugue_tpu_torch.kernels.join import join_build_cuda, join_expand_cuda, probe_place
    from fugue_tpu_torch.kernels.reference import (
        PROBE_MODES,
        gather_rows_reference,
        join_build_reference,
        join_expand_reference,
    )

    seen: Set[Tuple[str, str]] = set()
    for n in sizes:
        for label, case in join_side_cases(device, n, SEED + n):
            rows = {k: case[k] for k in ("nrows", "row_valid", "nulls") if k in case}
            paths = []
            for slots in (False, True):
                args = (case["build"], case["num"])
                got = join_build_cuda(*args, slots=slots, **rows)
                paths.append(join_build_cuda.last_path)
                if join_build_cuda.last_path == "slab":
                    check_buckets(f"join_build {label} n={n} slots={slots}",
                                  join_build_cuda.last_slabs)
                want = join_build_reference(*args, slots=slots, **rows)
                _same(f"join_build {label} n={n} slots={slots}", got, want)
                for mode, outer in (("semi", False), ("anti", False), ("unique", False),
                                    ("unique", True), ("expand", False), ("expand", True)):
                    if (mode == "unique") != slots:
                        continue
                    probe_vs_twin(case["probe"], want, mode, f"{label} n={n} outer={outer}",
                                  seen, outer=outer, **rows)
            not_in_vs_twin(case, rows, f"{label} n={n}", seen)
            print(f"join_build/join_probe n={n} {label}: equal (K7 path {paths[0]})")
        torch.cuda.empty_cache()
        for label, case in expand_cases(device, n, SEED + n):
            got, want = join_expand_cuda(**case), join_expand_reference(**case)
            for name, g, w in zip(("li", "ri"), got, want):
                _same(f"join_expand {label} n={n} {name}", g, w)
            print(f"join_expand n={n} {label}: {case['total']} output rows equal")
        torch.cuda.empty_cache()
        slab_cases = 0
        for label, case in gather_cases(device, n, SEED + n):
            got = gather_rows_cuda(**case)
            route = gather_rows_cuda.last_route
            if route != gather_route(case["columns"], n, case.get("scattered", False),
                                     case["outer"]):
                raise SystemExit(f"FAIL gather_rows {label} n={n}: took the {route} route")
            if route == "slab":
                slab_cases += 1
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                check_fill(f"gather_rows {label} n={n}", gather_rows_cuda.last_fill, n,
                           gather_rows_cuda.last_shift[1])
                check_buckets(f"gather_rows {label} n={n} sources",
                              gather_rows_cuda.last_sources, n)
            want = gather_rows_reference(case["columns"], case["idx"], outer=case["outer"])
            for j, ((gv, gm), (wv, wm)) in enumerate(zip(got, want)):
                _same(f"gather_rows {label} n={n} column {j}", gv, wv)
                _same(f"gather_rows {label} n={n} column {j} mask", gm, wm)
            print(f"gather_rows n={n} {label}: {len(got)} columns equal ({route} route)")
            del got, want
        if n >= 1 << 20 and slab_cases < 4:
            raise SystemExit(f"FAIL gather_rows n={n}: {slab_cases} cases took the slab route")
        torch.cuda.empty_cache()
    ends = {(m, probe_place(m, num)) for m in PROBE_MODES
            for num in (min(JOIN_SIDE_SEGMENTS), max(JOIN_SIDE_SEGMENTS))}
    missed = sorted(ends - seen)
    if missed:
        raise SystemExit(f"FAIL join_probe: no case read its table at {missed}")
    print(f"join_probe: every mode at each place of its table ({len(seen)} pairs)")


# each join path's launches in one run
JOIN_PATH_LAUNCHES = {
    # the keys bin (K1); the unique right side (K7 slots, K8, K10 for w);
    # the aggregate by the binned key (the fused sums), K10 at its export
    "join_3b": dict(bin_factorize=1, join_build=1, join_probe=1, gather_rows=2, binned_sums=1),
    # 150M int64 keys over 25M groups: the word route with K3's scatter;
    # K7, K8, K9, then K10 once a side
    "join_expand": dict(sort_word=1, sort_word_boundaries=1, sort_finish=1, join_build=1,
                        join_probe=1, join_expand=1, gather_rows=2),
    # the same at 10M left rows, whose 2.5M keys bin (K1)
    "join_expand_binned": dict(bin_factorize=1, join_build=1, join_probe=1, join_expand=1,
                               gather_rows=2),
    # the other kinds: the keys bin (K1); semi/anti: K7 and K8 only
    "left_outer": dict(bin_factorize=1, join_build=1, join_probe=1, join_expand=1,
                       gather_rows=2),
    "right_outer": dict(bin_factorize=1, join_build=1, join_probe=1, join_expand=1,
                        gather_rows=2),
    # plus the left side's counts, the right rows with no match, the tail
    "full_outer": dict(bin_factorize=1, join_build=2, join_probe=2, join_expand=1,
                       gather_rows=3),
    "semi": dict(bin_factorize=1, join_build=1, join_probe=1),
    "anti": dict(bin_factorize=1, join_build=1, join_probe=1),
    "cross": dict(join_build=1, join_probe=1, join_expand=1, gather_rows=2),
}
# the join's own readbacks in a run (``relational.readbacks``)
JOIN_READBACKS = {"join_3b": 0, "semi": 0, "anti": 0}


def _syncs_in(fn: Callable[[], Any]) -> Optional[Dict[str, int]]:
    """The synchronizing CUDA operations one call of ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: the count
    of each source line that made one; None off the card."""
    import warnings

    import torch

    if not torch.cuda.is_available():
        fn()
        return None
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs: Dict[str, int] = {}
    for w in seen:
        if "synchroniz" in str(w.message):
            where = f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
            syncs[where] = syncs.get(where, 0) + 1
    return syncs


def _join_stats(label: str, rows: int, run_once: Callable[[], Tuple[float, Any, Any]],
                join_once: Callable[[], Any], engine: Any, route: str, device: Any,
                warm_runs: int) -> Tuple[Dict[str, Any], Any, Any]:
    """``_path_stats`` for a join path, plus its route (each run counted
    once in ``engine.strategy_counts[route]``), its own readbacks a run
    and the synchronizing operations of one more join (``_syncs_in``)."""
    from fugue_tpu_torch.torch_backend import relational

    before, counted = relational.readbacks, engine.strategy_counts.get(route, 0)
    stats, frame, pdf = _path_stats(label, rows, run_once, device, warm_runs)
    runs = 1 + warm_runs
    if engine.strategy_counts.get(route, 0) - counted != runs:
        raise SystemExit(f"FAIL {label}: routes {engine.strategy_counts}, expected {route}")
    readbacks = (relational.readbacks - before) / runs
    if readbacks != JOIN_READBACKS.get(label, 1):
        raise SystemExit(f"FAIL {label}: {readbacks} readbacks of the output size a run")
    stats.update(route=route, join_readbacks_per_run=readbacks,
                 syncs_in_one_join=_syncs_in(join_once))
    return stats, frame, pdf


def build_join_3b(device: Any, rows: int) -> Tuple[Callable[[], Tuple[float, Any, Any]],
                                                   Callable[[], Any], Any, Dict[str, Any]]:
    """Config 3b's frames (``bench.py:884-897``, seed 5: ``rows`` facts of
    ``k`` int32 uniform over 256 and ``v`` float32; 256 dimension rows of
    ``k = arange(256)`` int32 and ``w`` float32) uploaded, and
    ``(run_once, join_once, engine, data)``: ``run_once`` joins the facts
    to the dimensions on ``k`` (``ft.join``, inner), aggregates SUM(v),
    AVG(w) and COUNT(*) by ``k`` and brings the result to pandas, noting
    in ``data["lazy"]`` whether the join's row count was still on the card
    when the aggregate started."""
    import numpy as np
    import pandas as pd

    from fugue_tpu_torch import aggregate, col, functions as ff, join, make_execution_engine

    rng = np.random.default_rng(JOIN3B_SEED)
    k = rng.integers(0, JOIN3B_GROUPS, rows).astype(np.int32)
    v = rng.random(rows).astype(np.float32)
    w = rng.random(JOIN3B_GROUPS).astype(np.float32)
    engine = make_execution_engine("torch", device=device)
    facts = engine.persist(engine.to_df(pd.DataFrame({"k": k, "v": v})))
    dims = engine.persist(engine.to_df(pd.DataFrame(
        {"k": np.arange(JOIN3B_GROUPS, dtype=np.int32), "w": w})))
    data: Dict[str, Any] = {"k": k, "v": v, "w": w, "lazy": []}

    def join_once() -> Any:
        return join(facts, dims, how="inner", on=["k"], engine=engine, as_fugue=True)

    def run_once() -> Tuple[float, Any, Any]:
        t = time.perf_counter()
        joined = join_once()
        data["lazy"].append(not joined.blocks.nrows_known)
        agg = aggregate(joined, partition_by="k", s=ff.sum(col("v")), m=ff.avg(col("w")),
                        c=ff.count(col("*")), engine=engine, as_fugue=True)
        pdf = agg.as_pandas()
        return time.perf_counter() - t, agg, pdf

    return run_once, join_once, engine, data


def join_3b(device: Any, rows: int, warm_runs: int) -> Dict[str, Any]:
    """``build_join_3b``'s path, checked against float64 numpy: keys and
    counts exactly, sums and means within ``MAIN_PATH_RTOL``; the unique
    right route, no readback inside the join, its count lazy when the
    aggregate starts."""
    import numpy as np
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run_once, join_once, engine, d = build_join_3b(device, rows)
    stats, _, pdf = _join_stats("join_3b", rows, run_once, join_once, engine, "join_unique",
                                device, warm_runs)
    if not all(d["lazy"]):
        raise SystemExit("FAIL join_3b: the join's count was read before the aggregate")
    c = np.bincount(d["k"], minlength=JOIN3B_GROUPS)
    s = np.bincount(d["k"], weights=d["v"].astype(np.float64), minlength=JOIN3B_GROUPS)
    occ = np.nonzero(c)[0]
    want = {"k": occ.astype(np.int32), "c": c[occ], "s": s[occ],
            "m": d["w"].astype(np.float64)[occ]}
    if list(pdf.columns) != ["k", "s", "m", "c"]:
        raise SystemExit(f"FAIL join_3b: columns {list(pdf.columns)}")
    stats["groups"] = len(pdf)
    stats["max_rel_err"] = _check_columns(pdf, want, ("k", "c"),
                                          {"s": MAIN_PATH_RTOL, "m": MAIN_PATH_RTOL}, "join_3b")
    return stats


def join_expand_frames(rows: int) -> Tuple[Any, Any]:
    """Config 10's join frames (``bench.py:1533-1546``) at ``rows`` left
    rows: ``k = permutation(arange(n) % (rows // 4))`` int64 and a float64
    ``v`` from seed 4; the right side ``rows // 2`` rows the same way from
    seed 9, ``w`` for ``v``: exactly 2 right rows a key, 4 left rows."""
    import numpy as np
    import pandas as pd

    dom = max(rows // 4, 64)

    def frame(seed: int, n: int, name: str) -> Any:
        r = np.random.default_rng(seed)
        return pd.DataFrame({"k": r.permutation(np.arange(n, dtype=np.int64) % dom),
                             name: r.random(n)})

    return frame(4, rows, "v"), frame(9, rows // 2, "w")


def numpy_join(k1: Any, ok1: Any, k2: Any, ok2: Any, how: str, dom: int) -> Tuple[Any, Any]:
    """A numpy sort-merge of two key columns (``ok``: not null) over keys
    in ``[0, dom)``, in the reference's order: ``(li, ri)``, the left and
    right row of each output row, -1 where a side has none. Inner and
    outer: the left rows in order, each with its matches in right-row
    order (one row with ``ri = -1`` under an outer join where it has none);
    full outer then the right rows with no match in order; semi and anti
    the left rows kept (``ri`` None); cross every pair, left-major."""
    import numpy as np

    n1, n2 = len(k1), len(k2)
    if how == "cross":
        return np.repeat(np.arange(n1), n2), np.tile(np.arange(n2), n1)
    kk1 = np.where(ok1, k1, 0).astype(np.int64)
    order2 = np.argsort(np.where(ok2, k2, dom), kind="stable")
    cnt2 = np.bincount(k2[ok2].astype(np.int64), minlength=dom)
    m = np.where(ok1, cnt2[kk1], 0)
    if how in ("semi", "anti"):
        return np.nonzero(m > 0 if how == "semi" else m == 0)[0], None
    reps = np.maximum(m, 1) if how in ("left_outer", "full_outer") else m
    li = np.repeat(np.arange(n1), reps)
    j = np.arange(len(li)) - np.repeat(np.cumsum(reps) - reps, reps)
    pos = np.minimum((np.cumsum(cnt2) - cnt2)[kk1[li]] + j, max(n2 - 1, 0))
    ri = np.where(j < m[li], order2[pos] if n2 else -1, -1)
    if how == "full_outer":
        cnt1 = np.bincount(k1[ok1].astype(np.int64), minlength=dom)
        tail = np.nonzero(~ok2 | (cnt1[np.where(ok2, k2, 0).astype(np.int64)] == 0))[0]
        li = np.concatenate([li, np.full(len(tail), -1)])
        ri = np.concatenate([ri, tail])
    return li, ri


def _pick(values: Any, valid: Any, idx: Any) -> Tuple[Any, Any]:
    """``values`` and ``valid`` at ``idx``, invalid where ``idx`` is -1."""
    import numpy as np

    if idx is None:
        return None, None
    safe = np.maximum(idx, 0)
    return values[safe], valid[safe] & (idx >= 0)


def check_join_output(label: str, table: Any, want: Dict[str, Tuple[Any, Any]]) -> None:
    """An arrow result against numpy, row for row: per column its nulls,
    and its values where valid, bit for bit."""
    import numpy as np

    if table.column_names != list(want):
        raise SystemExit(f"FAIL {label}: columns {table.column_names}, expected {list(want)}")
    for name, (values, valid) in want.items():
        col = table.column(name).combine_chunks()
        if len(col) != len(values):
            raise SystemExit(f"FAIL {label}: {len(col)} rows, numpy {len(values)}")
        got_valid = np.asarray(col.is_valid())
        if not np.array_equal(got_valid, valid):
            raise SystemExit(f"FAIL {label}: the nulls of {name} differ")
        got = col.fill_null(0).to_numpy(zero_copy_only=False)[valid]
        exp = values[valid]
        if got.dtype != exp.dtype or not np.array_equal(got.view(np.uint8), exp.view(np.uint8)):
            raise SystemExit(f"FAIL {label}: the values of {name} differ")


def build_join_expand(device: Any, rows: int) -> Tuple[Callable[[], Tuple[float, Any, Any]],
                                                       Callable[[], Any], Any, Tuple[Any, Any]]:
    """``join_expand_frames`` uploaded, and ``(run_once, join_once, engine,
    (left, right))``: ``run_once`` is config 10's timed step, the inner
    join on ``k`` (``ft.join``) and its row count."""
    from fugue_tpu_torch import join, make_execution_engine

    left, right = join_expand_frames(rows)
    engine = make_execution_engine("torch", device=device)
    tl, tr = engine.persist(engine.to_df(left)), engine.persist(engine.to_df(right))

    def join_once() -> Any:
        return join(tl, tr, how="inner", on=["k"], engine=engine, as_fugue=True)

    def run_once() -> Tuple[float, Any, Any]:
        t = time.perf_counter()
        joined = join_once()
        joined.count()
        return time.perf_counter() - t, joined, None

    return run_once, join_once, engine, (left, right)


def join_expand(device: Any, rows: int, warm_runs: int, row_for_row: bool) -> Dict[str, Any]:
    """``build_join_expand``'s path: the expansion route with one
    readback a run, ``2 * rows`` output rows, and the aggregate of the
    cold run's output by ``k`` (count, sum of v, sum of w) against numpy
    ``bincount``: counts exactly, sums within ``FLOAT64_SUM_RTOL``. With
    ``row_for_row``, the output also goes to the host and is held row for
    row against ``numpy_join``."""
    import numpy as np
    import torch

    from fugue_tpu_torch import aggregate, col, functions as ff

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    from fugue_tpu_torch.torch_backend.groupby import _MAX_BINS

    run_once, join_once, engine, (left, right) = build_join_expand(device, rows)
    label = "join_expand" if max(rows // 4, 64) > _MAX_BINS else "join_expand_binned"
    stats, frame, _ = _join_stats(label, rows, run_once, join_once, engine, "join_expand",
                                  device, warm_runs)
    if frame.count() != 2 * rows:
        raise SystemExit(f"FAIL {label}: {frame.count()} output rows, expected {2 * rows}")
    kl, kr = left["k"].to_numpy(), right["k"].to_numpy()
    dom = max(rows // 4, 64)
    agg = aggregate(frame, partition_by="k", c=ff.count(col("*")), sv=ff.sum(col("v")),
                    sw=ff.sum(col("w")), engine=engine, as_fugue=True).as_pandas()
    cl, cr = np.bincount(kl, minlength=dom), np.bincount(kr, minlength=dom)
    c = cl * cr
    occ = np.nonzero(c)[0]
    want = {"k": occ, "c": c[occ],
            "sv": (np.bincount(kl, weights=left["v"].to_numpy(), minlength=dom) * cr)[occ],
            "sw": (np.bincount(kr, weights=right["w"].to_numpy(), minlength=dom) * cl)[occ]}
    stats["output_rows"] = frame.count()
    stats["max_rel_err"] = _check_columns(agg.sort_values("k").reset_index(drop=True), want,
                                          ("k", "c"), {"sv": FLOAT64_SUM_RTOL,
                                                       "sw": FLOAT64_SUM_RTOL}, label)
    if row_for_row:
        li, ri = numpy_join(kl, np.ones(len(kl), bool), kr, np.ones(len(kr), bool), "inner", dom)
        ones = np.ones(len(li), bool)
        check_join_output(f"{label} at {rows} rows", frame.as_arrow(), {
            "k": (kl[li], ones), "v": (left["v"].to_numpy()[li], ones),
            "w": (right["w"].to_numpy()[ri], ones)})
        stats["row_for_row"] = True
    return stats


def join_kind_frames(rows: Tuple[int, int], seed: int) -> Tuple[Any, Any, int]:
    """The other kinds' frames: ``rows[0]`` left rows of ``k`` int32 uniform
    over [0, 3M) and a float64 ``v``, ``rows[1]`` right rows of ``k`` over
    [1M, 4M) and a float64 ``w``, both with a tenth of the keys null, so
    keys miss on both sides (scaled down with the rows); and the key
    domain."""
    import numpy as np
    import pandas as pd

    dom = max(rows[0] * 2 // 5, 16)
    r = np.random.default_rng(seed)

    def frame(n: int, lo: int, name: str) -> Any:
        k = pd.array(r.integers(lo, lo + dom * 3 // 4, n).astype(np.int32), dtype="Int32")
        k[r.random(n) < 0.1] = pd.NA
        return pd.DataFrame({"k": k, name: r.random(n)})

    return frame(rows[0], 0, "v"), frame(rows[1], dom // 4, "w"), dom


def join_kinds(device: Any, rows: Tuple[int, int], cross_rows: Tuple[int, int],
               warm_runs: int) -> List[Dict[str, Any]]:
    """Left, right and full outer, semi and anti of ``join_kind_frames``
    through ``ft.join``, and a cross join of ``cross_rows``, each run
    (join and its row count) cold and warm with its launches, route and
    readbacks asserted, its cold output held row for row against
    ``numpy_join``."""
    import numpy as np
    import pandas as pd
    import torch

    from fugue_tpu_torch import join, make_execution_engine

    left, right, dom = join_kind_frames(rows, SEED)
    engine = make_execution_engine("torch", device=device)
    tl, tr = engine.persist(engine.to_df(left)), engine.persist(engine.to_df(right))
    k1, ok1 = left["k"].to_numpy(np.int32, na_value=0), left["k"].notna().to_numpy()
    k2, ok2 = right["k"].to_numpy(np.int32, na_value=0), right["k"].notna().to_numpy()
    v, w = left["v"].to_numpy(), right["w"].to_numpy()
    r = np.random.default_rng(SEED)
    cl = pd.DataFrame({"a": r.integers(-5, 5, cross_rows[0]).astype(np.int64)})
    cr = pd.DataFrame({"b": r.random(cross_rows[1]).astype(np.float32)})
    tcl, tcr = engine.persist(engine.to_df(cl)), engine.persist(engine.to_df(cr))
    out = []
    for how in JOIN_KINDS + ("cross",):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        a, b, on = (tcl, tcr, None) if how == "cross" else (tl, tr, ["k"])

        def join_once() -> Any:
            return join(a, b, how=how, on=on, engine=engine, as_fugue=True)  # noqa: B023

        def run_once() -> Tuple[float, Any, Any]:
            t = time.perf_counter()
            res = join_once()
            res.count()
            return time.perf_counter() - t, res, None

        route = {"semi": "join_mask", "anti": "join_mask"}.get(how, "join_expand")
        stats, frame, _ = _join_stats(how, len(cl) if how == "cross" else rows[0], run_once,
                                      join_once, engine, route, device, warm_runs)
        got = frame.as_arrow()
        if how == "cross":
            li, ri = numpy_join(cl["a"].to_numpy(), None, cr["b"].to_numpy(), None, how, 0)
            ones = np.ones(len(li), bool)
            want = {"a": (cl["a"].to_numpy()[li], ones), "b": (cr["b"].to_numpy()[ri], ones)}
        elif how == "right_outer":
            ri, li = numpy_join(k2, ok2, k1, ok1, "left_outer", dom)
            kv = _pick(k2, ok2, ri)
            want = {"k": kv, "v": _pick(v, np.ones(len(v), bool), li),
                    "w": _pick(w, np.ones(len(w), bool), ri)}
        else:
            li, ri = numpy_join(k1, ok1, k2, ok2, how, dom)
            kv = _pick(k1, ok1, li)
            if how == "full_outer":  # the tail's keys are the right side's
                tk = _pick(k2, ok2, ri)
                kv = (np.where(li >= 0, kv[0], tk[0]), np.where(li >= 0, kv[1], tk[1]))
            want = {"k": kv, "v": _pick(v, np.ones(len(v), bool), li)}
            if ri is not None:
                want["w"] = _pick(w, np.ones(len(w), bool), ri)
        check_join_output(how, got, want)
        stats["output_rows"] = got.num_rows
        out.append(stats)
    return out


def join_timing(device: Any, launches: Dict[str, int]) -> List[Dict[str, Any]]:
    """K7-K10 at the expansion path's shapes (``join_expand`` at 100M left
    rows: 50M right rows over 25M segments, 200M output rows), each beside
    its twin, one PyTorch call and its bound (bytes); ``torch.sort`` of
    the right side's segment ids (``order2``); K8 in unique mode at
    config 3b's 100M facts; K9 on a cross join and a skewed key."""
    import torch

    from fugue_tpu_torch.kernels import gather
    from fugue_tpu_torch.kernels.gather import gather_rows_cuda
    from fugue_tpu_torch.kernels.join import join_build_cuda, join_expand_cuda, join_probe_cuda
    from fugue_tpu_torch.kernels.reference import (
        GatherColumn,
        gather_rows_reference,
        join_build_reference,
        join_expand_reference,
        join_probe_reference,
    )

    gen = torch.Generator(device=device).manual_seed(SEED)
    p1, p2 = JOIN_EXPAND_ROWS, JOIN_EXPAND_ROWS // 2
    num = p1 // 4
    seg1 = (torch.randperm(p1, generator=gen, device=device) % num).to(torch.int32)
    seg2 = (torch.randperm(p2, generator=gen, device=device) % num).to(torch.int32)
    entries = []

    counts = join_build_cuda(seg2, num, nrows=p2)
    want = join_build_reference(seg2, num, nrows=p2)
    err = float((counts - want).abs().max())
    entries.append(_kernel_entry(
        "join_build", "fugue_tpu/jax_backend/relational.py:466",
        launches["join_build"], err,
        time_cuda(lambda: join_build_cuda(seg2, num, nrows=p2), 20),
        time_cuda(lambda: join_build_reference(seg2, num, nrows=p2), 1, warm=0),
        p2 * 4 + num * 4, 0,
        time_cuda(lambda: torch.bincount(seg2, minlength=num), 5), source="join.cu"))

    pr = join_probe_cuda(seg1, counts, "expand", nrows=p1)
    path = join_probe_cuda.last_path
    pw = join_probe_reference(seg1, counts, "expand", nrows=p1)
    err = max(float((pr.m - pw.m).abs().max()), float((pr.reps - pw.reps).abs().max()))
    entries.append(_kernel_entry(
        "join_probe", "fugue_tpu/jax_backend/relational.py:470",
        launches["join_probe"], err,
        time_cuda(lambda: join_probe_cuda(seg1, counts, "expand", nrows=p1), 20),
        time_cuda(lambda: join_probe_reference(seg1, counts, "expand", nrows=p1), 1, warm=0),
        p1 * (4 + 4 + 4) + num * 4, 0,  # seg read, m and reps written; the table read once
        time_cuda(lambda: counts.index_select(0, seg1), 5), source="join.cu"))
    print("join_probe expand: " + json.dumps({"rows": p1, "segments": num, "path": path}))
    slots = join_build_cuda(torch.arange(JOIN3B_GROUPS, dtype=torch.int32, device=device),
                            JOIN3B_GROUPS, nrows=JOIN3B_GROUPS, slots=True)
    facts = torch.randint(0, JOIN3B_GROUPS, (ROWS,), generator=gen, device=device,
                          dtype=torch.int32)
    unique_ms = time_cuda(lambda: join_probe_cuda(facts, slots, "unique", nrows=ROWS), 20)
    print("join_probe unique: " + json.dumps({
        "rows": ROWS, "ms": unique_ms, "path": join_probe_cuda.last_path,
        # seg read, ridx and keep written; 256 slots
        "bound_ms": (ROWS * (4 + 4 + 1) + JOIN3B_GROUPS * 4) / HBM_BYTES_PER_S * 1e3}))
    del facts

    order2 = torch.sort(seg2, stable=True).indices
    sort_ms = time_cuda(lambda: torch.sort(seg2, stable=True), 5)
    print("order2_sort: " + json.dumps({
        "rows": p2, "ms": sort_ms,
        "bound_ms": p2 * (4 + 4 + 8) / HBM_BYTES_PER_S * 1e3}))  # ids in, sorted ids and order out
    start = torch.cumsum(pr.reps, 0, dtype=torch.int64) - pr.reps
    cstart2 = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    total = int(pr.total)
    args = (start, pr.m, seg1, cstart2, order2, total)
    li, ri = join_expand_cuda(*args)
    wl, wr = join_expand_reference(*args)
    err = max(float((li - wl).abs().max()), float((ri - wr).abs().max()))
    del wl, wr
    rows1 = torch.arange(p1, device=device)
    entries.append(_kernel_entry(
        "join_expand", "fugue_tpu/jax_backend/relational.py:568",
        launches["join_expand"], err,
        time_cuda(lambda: join_expand_cuda(*args), 20),
        time_cuda(lambda: join_expand_reference(*args), 1, warm=0),
        total * (4 + 4) + p1 * 12, 0,
        # computes li alone
        time_cuda(lambda: torch.repeat_interleave(rows1, pr.reps, output_size=total), 5),
        source="join.cu"))
    print("join_expand device: " + json.dumps({
        "output_rows": total, "device_ms": device_split_ms(lambda: join_expand_cuda(*args),
                                                           device)}))
    del rows1
    for label, case in expand_cases(device, JOIN_CROSS_ROWS[0] * 10, SEED):
        if label not in ("cross", "skew"):
            continue
        print("join_expand_shape: " + json.dumps({
            "case": label, "output_rows": case["total"],
            "ms": time_cuda(lambda: join_expand_cuda(**case), 20),  # noqa: B023
            "bound_ms": (case["total"] * 8 + int(case["start"].shape[0]) * 12)
            / HBM_BYTES_PER_S * 1e3}))
    torch.cuda.empty_cache()

    gen_cols = [GatherColumn(torch.randint(0, num, (p1,), generator=gen, device=device), None),
                GatherColumn(torch.rand((p1,), generator=gen, device=device,
                                        dtype=torch.float64), None)]
    got = gather_rows_cuda(gen_cols, li)
    want = gather_rows_reference(gen_cols, li)
    err = max(float((g - w).abs().max()) for (g, _), (w, _) in zip(got, want))
    del got, want
    idx64 = li.to(torch.int64)
    entries.append(_kernel_entry(
        "gather_rows", "fugue_tpu/jax_backend/relational.py:578",
        launches["gather_rows"], err,
        time_cuda(lambda: gather_rows_cuda(gen_cols, li), 20),
        time_cuda(lambda: gather_rows_reference(gen_cols, li), 1, warm=0),
        total * (4 + 2 * (8 + 8)), 0,  # the index, each column's element read and written
        time_cuda(lambda: [c.values.index_select(0, idx64) for c in gen_cols], 5),
        source="gather.cu"))
    # the right side's gather: w by ri, which follows the right side's sort
    # (random reads of 50M rows); one column, so K10 reads it directly
    # (gather.gather_route), and its slab route is timed beside
    del idx64
    right = [GatherColumn(torch.rand((p2,), generator=gen, device=device, dtype=torch.float64),
                          None)]

    def slab_route(columns: Any, idx: Any) -> Any:
        saved = gather.column_groups
        gather.column_groups = lambda w, m: []  # as if the pass packed every column
        try:
            return gather_rows_cuda(columns, idx, scattered=True)
        finally:
            gather.column_groups = saved

    got = gather_rows_cuda(right, ri, scattered=True)
    route = gather_rows_cuda.last_route
    _same("gather_rows right side", got[0][0], gather_rows_reference(right, ri)[0][0])
    del got
    ri64 = ri.to(torch.int64)
    print("gather_rows right side: " + json.dumps({
        "output_rows": total, "route": route,
        "ms": time_cuda(lambda: gather_rows_cuda(right, ri, scattered=True), 10),
        "slab_ms": time_cuda(lambda: slab_route(right, ri), 10),
        "index_select_ms": time_cuda(lambda: right[0].values.index_select(0, ri64), 5),
        "bound_ms": total * (4 + 8 + 8) / HBM_BYTES_PER_S * 1e3,
        "device_ms": device_split_ms(lambda: gather_rows_cuda(right, ri, scattered=True),
                                     device)}))
    return entries


# --- strings: K6's LUT family against its twin, the string paths, timing ---

SKUS = 10_000  # distinct SKUs of the string paths
SKU_SPACE = 100_000  # their numbers: "sku-%05d", drawn without replacement
STRING_SEED = 7
STRING_NULLS = 0.05
CONFIG1_ROWS = 2_000_000  # BASELINE config 1 as published (bench.py:709)
CONFIG1_MAPPING = {"A": "Apple", "B": "Banana", "C": "Carrot"}
JOIN_DIMS = 10_000  # the dimension table of the string-keyed join
JOIN_DIMS_ABSENT = 0.1  # its share of keys no fact holds
DATE_SEED = 11
DATE_DAYS = 1_096  # 2020-01-01 to 2022-12-31
DATE_EPOCH_DAY = 18_262  # 2020-01-01
DATE_TS_NULLS = 0.03


def sku_names(nums: Any) -> List[str]:
    return [f"sku-{int(x):05d}" for x in nums]


def k6_string_frame(device: Any, n: int, seed: int) -> Any:
    """A frame of ``n`` rows of string codes on ``device``, each column
    with its dictionary: ``s`` over 10,000 SKUs in shuffled order (5 %
    nulls), ``t`` over 600 (500 of ``s``'s in another order, 100 that
    ``s`` lacks; 10 % nulls), ``u`` over 300 colours, ``p`` over 20 LIKE
    patterns (5 % nulls), and ``v`` float32."""
    import numpy as np
    import pyarrow as pa
    import torch

    from fugue_tpu_torch.torch_backend.blocks import TorchBlocks, TorchColumn

    rng = np.random.default_rng(seed)
    nums = rng.choice(SKU_SPACE, SKUS, replace=False)
    absent = np.setdiff1d(np.arange(SKU_SPACE), nums)
    t_nums = np.concatenate([rng.choice(nums, 500, replace=False), rng.choice(absent, 100)])
    rng.shuffle(t_nums)
    dicts = {
        "s": np.array(sku_names(nums), dtype=object),
        "t": np.array(sku_names(t_nums), dtype=object),
        "u": np.array([f"c{i:03d}" for i in rng.permutation(300)], dtype=object),
        "p": np.array(["sku-1%", "%5_", "sku-0.%", "%7%", "sku-(1)%", "s_u%", "%", "_",
                       "sku-12%", "%99", "sku-_____", "SKU%", "%-0%", "sku-5____", "%1%2%",
                       "sku-0", "sku-00123", "%3", "x%", "sku-4%"], dtype=object),
    }
    ints, flags, floats, _ = _draws(device, n, seed)
    cols = {}
    for name, nulls in (("s", 0.05), ("t", 0.1), ("u", 0.0), ("p", 0.05)):
        d = dicts[name]
        codes = ints(0, len(d), torch.int32)
        cols[name] = TorchColumn(pa.string(), codes, flags(1.0 - nulls) if nulls else None,
                                 (0, len(d) - 1), dictionary=d)
    cols["v"] = TorchColumn(pa.float32(), floats(torch.float32))
    return TorchBlocks(n, cols, device)


def k6_string_cases(frame: Any) -> List[Tuple[str, List[Any], bool]]:
    """K6's LUT programs over ``k6_string_frame``'s columns: LIKE with
    ``%``, ``_`` and regex characters, every compare against a literal in
    the dictionary, one absent from it and one that sorts between its
    entries, columns with different dictionaries against each other, IN
    lists, LENGTH, a canonicalising UPPER, a two-column CONCAT, a LIKE by
    a pattern column, NULLIF, and filter conditions."""
    from fugue_tpu_torch.column.expressions import _FuncExpr, col, lit
    from fugue_tpu_torch.column.functions import like

    def fn(name: str, *args: Any) -> Any:
        return _FuncExpr(name, *args)

    s, t, u, p = col("s"), col("t"), col("u"), col("p")
    d = frame.columns["s"].dictionary
    present = str(d[len(d) // 2])
    absent = "sku-99999z"  # not an SKU: sorts after every one
    between = str(sorted(d)[len(d) // 3])[:-1] + "5x"  # between two SKUs
    cases: List[Tuple[str, List[Any], bool]] = [
        ("lut_like", [like(s, "sku-1%"), like(s, "%5_"), like(s, "sku-0.%"),
                      like(s, "%7%", negated=True), like(s, "sku-(1)%"), like(t, "%0__")],
         False),
    ]
    for label, x in (("present", present), ("absent", absent), ("between", between)):
        cases.append((f"lut_compare_{label}", [s == x, s != x, s < x, s <= x, s > x, s >= x,
                                               lit(x) < t], False))
    cases += [
        ("lut_columns", [s == t, s != t, s < t, s <= t, s > t, s >= t], False),
        ("lut_in", [(s == present) | (s == str(d[0])) | (s == absent),
                    ~((t == str(d[1])) | (t == present))], False),
        ("lut_length", [fn("length", s), fn("length", fn("concat", t, "-x")),
                        fn("length", s) + fn("length", t)], False),
        ("lut_upper_canonical", [fn("upper", fn("substring", s, 1, 6)),
                                 fn("trim", fn("replace", s, "sku-", " "))], False),
        ("lut_concat", [fn("concat", t, "/", u), fn("concat", "<", u, ">")], False),
        ("lut_dynamic_like", [_FuncExpr("like", s, p, False), _FuncExpr("like", t, p, True)],
         False),
        ("lut_nullif", [fn("nullif", t, present), fn("nullif", s, t)], False),
        ("lut_filter", [like(s, "sku-1%") & (s < "sku-15000")], True),
        ("lut_filter_columns", [(s == t) | (fn("length", u) > 3) | (col("v") > 0.5)], True),
        # nine tables, over the interpreter's old cap of eight
        ("lut_nine_tables", [_or_all([like(s, f"sku-{i}%") for i in range(1, 10)])], True),
    ]
    return cases


def _remap_case(frame: Any) -> Tuple[Any, List[Any]]:
    """The harmonize re-coding of ``t``'s codes into ``s``'s dictionary
    extended (``strings.remap_table``), as a K6 program and its input."""
    import torch

    from fugue_tpu_torch.kernels.expr_program import remap_program
    from fugue_tpu_torch.torch_backend import strings

    s, t = frame.columns["s"], frame.columns["t"]
    table, _ = strings.remap_table(s.dictionary, t.dictionary)
    prog = remap_program(torch.from_numpy(table).to(t.data.device))
    return prog, [(t.data, None)]


def lut_vs_twin(device: Any, sizes: Tuple[int, ...]) -> float:
    """K6's LUT programs (``k6_string_cases`` and the harmonize re-coding)
    against the twin at each size, filter programs over prefix rows (all,
    and all but 3) and a random ``row_valid``, below 100M rows also on
    ``shifted`` views (the scalar path): masks, codes, flags and counts
    exactly."""
    import torch

    from fugue_tpu_torch.kernels.expr_program import OP, expr_program_cuda
    from fugue_tpu_torch.kernels.reference import expr_program_reference

    prebuild_k6(k6_string_frame(device, 1, STRING_SEED), k6_string_cases(
        k6_string_frame(device, 1, STRING_SEED)), "k6_string_cases")
    worst = 0.0
    for n in sizes:
        frame = k6_string_frame(device, n, STRING_SEED + n % 89)
        rows_variants = [{"nrows": n}, {"nrows": max(n - 3, 0)},
                         {"row_valid": torch.rand((n,), device=device) < 0.6}]
        cases = k6_string_cases(frame)
        for label, exprs, filt in cases:
            for rows in (rows_variants if filt else [{}]):
                for views in ((False, True) if n < ROWS else (False,)):
                    prog, got, want = _run_k6(frame, exprs, filt, rows, views)
                    if not any(ins.op == OP["LUT"] for ins in prog.instrs) \
                            and label != "lut_concat":
                        raise SystemExit(f"FAIL expr_program {label}: no LUT instruction")
                    worst = max(worst, check_k6(f"{label} n={n} views={views}", exprs, filt,
                                                got, want))
        prog, inputs = _remap_case(frame)
        got = expr_program_cuda(prog, inputs, n, device=device)
        want = expr_program_reference(prog, inputs, n, device=device)
        if not torch.equal(got[0][0], want[0][0]):
            raise SystemExit(f"FAIL expr_program harmonize remap n={n} differs from the twin")
        print(f"ok expr_program LUT n={n}: {len(cases) + 1} programs against the twin")
        del frame, got, want
        torch.cuda.empty_cache()
    return worst


def sku_frame(rows: int, seed: int) -> Dict[str, Any]:
    """The string paths' facts, from seed ``seed``: 10,000 SKU numbers
    drawn from [0, 100000) without replacement (the dictionary's order in
    the table is the draw's, so codes are not ranks), each row's SKU
    index uniform, 5 % nulls, ``v`` float32 uniform over [0, 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nums = rng.choice(SKU_SPACE, SKUS, replace=False)
    codes = rng.integers(0, SKUS, rows).astype(np.int32)
    null = rng.random(rows) < STRING_NULLS
    v = rng.random(rows).astype(np.float32)
    return {"nums": nums, "codes": codes, "null": null, "v": v}


def _string_array(codes: Any, null: Any, names: List[str]) -> Any:
    """A string column built in arrow from dictionary codes."""
    import pyarrow as pa

    indices = pa.array(codes, type=pa.int32(), mask=null)
    return pa.DictionaryArray.from_arrays(indices, pa.array(names, pa.string())).cast(pa.string())


def sku_dims(d: Dict[str, Any], dims: int, seed: int) -> Dict[str, Any]:
    """The join's dimension table: ``dims`` SKUs in another order, 90 % of
    them held by the facts and 10 % by none; ``w`` int64 over [0, 1000)."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    held = min(int(dims * (1 - JOIN_DIMS_ABSENT)), len(d["nums"]))
    absent = np.setdiff1d(np.arange(SKU_SPACE), d["nums"])
    nums = np.concatenate([rng.choice(d["nums"], held, replace=False),
                           rng.choice(absent, dims - held, replace=False)])
    rng.shuffle(nums)
    return {"nums": nums, "w": rng.integers(0, 1000, dims).astype(np.int64)}


def build_string_paths(device: Any, rows: int, seed: int, dims: int = JOIN_DIMS
                       ) -> Tuple[Dict[str, Callable[[], Tuple[float, Any, Any]]], Dict[str, Any],
                                  Any]:
    """``sku_frame`` and ``sku_dims`` built in arrow from codes and
    uploaded; returns ``(run_for, data, engine)``. ``run_for``:

    - ``string_groupby``: ``SELECT s, SUM(v), COUNT(*) WHERE s LIKE
      'sku-1%' AND s < 'sku-15000' GROUP BY s``;
    - ``string_upper_groupby``: ``assign(u=UPPER(SUBSTR(s, 1, 6)),
      n=LENGTH(s))``, then COUNT(*), SUM(n), SUM(v) by ``u`` (canonical
      codes: ten prefixes and NULL);
    - ``string_join``: the facts inner-joined to the dimension table on
      ``s`` (``ft.join``), then SUM(v), SUM(w), COUNT(*) by ``s``;

    each to pandas, returning ``(seconds, frame, pandas)``."""
    import pyarrow as pa

    import fugue_tpu_torch as ft
    from fugue_tpu_torch import col, function, functions as ff, make_execution_engine

    d = sku_frame(rows, seed)
    dd = sku_dims(d, dims, seed)
    engine = make_execution_engine("torch", device=device)
    table = pa.table({"s": _string_array(d["codes"], d["null"], sku_names(d["nums"])),
                      "v": d["v"]})
    src = engine.persist(engine.to_df(table))
    del table
    dim_table = pa.table({"s": pa.array(sku_names(dd["nums"]), pa.string()), "w": dd["w"]})
    dims_src = engine.persist(engine.to_df(dim_table))
    d["dims"] = dd

    def groupby() -> Tuple[float, Any, Any]:
        t = time.perf_counter()
        res = ft.select(src, "s", ff.sum(col("v")).alias("sv"), ff.count(col("*")).alias("c"),
                        where=ff.like(col("s"), "sku-1%") & (col("s") < "sku-15000"),
                        engine=engine, as_fugue=True)
        pdf = res.as_pandas()
        return time.perf_counter() - t, res, pdf

    def upper_groupby() -> Tuple[float, Any, Any]:
        t = time.perf_counter()
        a = ft.assign(src, engine=engine, as_fugue=True,
                      u=function("upper", function("substring", col("s"), 1, 6)),
                      n=function("length", col("s")))
        res = ft.aggregate(a, "u", engine=engine, as_fugue=True, c=ff.count(col("*")),
                           sn=ff.sum(col("n")), sv=ff.sum(col("v")))
        pdf = res.as_pandas()
        return time.perf_counter() - t, res, pdf

    def join() -> Tuple[float, Any, Any]:
        t = time.perf_counter()
        j = ft.join(src, dims_src, how="inner", on=["s"], engine=engine, as_fugue=True)
        res = ft.select(j, "s", ff.sum(col("v")).alias("sv"), ff.sum(col("w")).alias("sw"),
                        ff.count(col("*")).alias("c"), engine=engine, as_fugue=True)
        pdf = res.as_pandas()
        return time.perf_counter() - t, res, pdf

    return ({"string_groupby": groupby, "string_upper_groupby": upper_groupby,
             "string_join": join}, d, engine)


def string_oracle(d: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The three string paths from numpy: per SKU (a code of the facts'
    dictionary) counts and float64 sums, in the order of the SKU names."""
    import numpy as np

    nums, codes, null, v = d["nums"], d["codes"], d["null"], d["v"]
    num = nums[codes]
    valid = ~null

    def by_sku(keep: Any, weights: Any = None) -> Tuple[Any, Any]:
        c = np.bincount(codes[keep], minlength=SKUS)
        s = np.bincount(codes[keep], weights=None if weights is None else weights[keep],
                        minlength=SKUS)
        return c, s

    keep = valid & (num >= 10_000) & (num < 15_000)  # LIKE 'sku-1%' AND s < 'sku-15000'
    c, sv = by_sku(keep, v.astype(np.float64))
    occ = np.nonzero(c)[0]
    occ = occ[np.argsort(nums[occ])]
    groupby = {"s": np.array(sku_names(nums[occ]), dtype=object), "c": c[occ], "sv": sv[occ],
               "kept": int(keep.sum())}
    prefix = np.where(valid, num // 1000, 100)  # UPPER(SUBSTR(s, 1, 6)): "SKU-" + 2 digits
    cu = np.bincount(prefix, minlength=101)
    svu = np.bincount(prefix, weights=v.astype(np.float64), minlength=101)
    occ_u = np.nonzero(cu[:100])[0]
    upper = {"u": np.array([f"SKU-{i:02d}" for i in occ_u] + [None], dtype=object),
             "c": np.append(cu[occ_u], cu[100]), "sn": np.append(9 * cu[occ_u], 0),
             "sv": np.append(svu[occ_u], svu[100])}
    dd = d["dims"]
    pos = np.full(SKU_SPACE, -1, dtype=np.int64)
    pos[dd["nums"]] = np.arange(len(dd["nums"]))
    matched = valid & (pos[num] >= 0)
    cj, svj = by_sku(matched, v.astype(np.float64))
    swj = np.bincount(codes[matched], weights=dd["w"][pos[num[matched]]].astype(np.float64),
                      minlength=SKUS)
    occ_j = np.nonzero(cj)[0]
    occ_j = occ_j[np.argsort(nums[occ_j])]
    join = {"s": np.array(sku_names(nums[occ_j]), dtype=object), "c": cj[occ_j],
            "sv": svj[occ_j], "sw": swj[occ_j].astype(np.int64), "rows": int(matched.sum())}
    return {"string_groupby": groupby, "string_upper_groupby": upper, "string_join": join}


def _check_string_result(label: str, pdf: Any, want: Dict[str, Any], key: str,
                         exact: Tuple[str, ...], inexact: Dict[str, float]) -> Dict[str, float]:
    """``pdf`` sorted by its string key (NULL last) against ``want``:
    keys and ``exact`` columns equal, ``inexact`` within their rtol."""
    import numpy as np

    pdf = pdf.sort_values(key, na_position="last").reset_index(drop=True)
    if len(pdf) != len(want[key]):
        raise SystemExit(f"FAIL {label}: {len(pdf)} groups, expected {len(want[key])}")
    keys = [None if k is None or k != k else k for k in pdf[key].tolist()]
    if keys != list(want[key]):
        raise SystemExit(f"FAIL {label}: the keys differ from numpy")
    for name in exact:
        got = pdf[name].fillna(0).to_numpy().astype(np.int64)
        if not np.array_equal(got, np.asarray(want[name], dtype=np.int64)):
            raise SystemExit(f"FAIL {label}: {name} differs from numpy")
    rel = {}
    for name, tol in inexact.items():
        got = pdf[name].to_numpy().astype(np.float64)
        w = np.asarray(want[name], dtype=np.float64)
        rel[name] = float(np.max(np.abs(got - w) / np.abs(w))) if len(got) else 0.0
        if not (np.all(np.isfinite(got)) and rel[name] <= tol):
            raise SystemExit(f"FAIL {label}: {name} off by rtol {rel[name]}")
    return rel


def config1_frame(rows: int) -> Tuple[Any, Any]:
    """BASELINE config 1 (``bench.py:709-714``): ``id`` int64 and
    ``value`` drawn from A, B and C with seed 0, built in arrow from the
    draws' codes; returns the table and the codes."""
    import numpy as np
    import pyarrow as pa

    codes = np.random.default_rng(0).choice(3, rows).astype(np.int32)
    table = pa.table({"id": np.arange(rows, dtype=np.int64),
                      "value": _string_array(codes, None, ["A", "B", "C"])})
    return table, codes


def build_config1(device: Any, rows: int) -> Tuple[Callable[[], Tuple[float, Any, Any]], Any]:
    """Config 1 uploaded (``persist(to_df)``) and ``(run_once, codes)``:
    ``transform`` with the ``_value_dict`` remap and schema ``"*"``, then
    ``as_pandas``."""
    import numpy as np
    import torch

    from fugue_tpu_torch import make_execution_engine, transform

    table, codes = config1_frame(rows)
    engine = make_execution_engine("torch", device=device)
    src = engine.persist(engine.to_df(table))
    del table

    def map_letter_to_food(arrs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        d = arrs["_value_dict"]
        remapped = np.array([CONFIG1_MAPPING.get(s, s) for s in d.tolist()], dtype=object)
        return {"id": arrs["id"], "value": arrs["value"], "_value_dict": remapped}

    def run_once() -> Tuple[float, Any, Any]:
        t = time.perf_counter()
        res = transform(src, map_letter_to_food, schema="*", engine=engine, as_fugue=True)
        pdf = res.as_pandas()
        return time.perf_counter() - t, res, pdf

    return run_once, codes


def date_frame(rows: int, seed: int) -> Dict[str, Any]:
    """The date group-by's frame from seed ``seed``: ``d`` over 1,096 days
    from 2020-01-01, ``ts`` a microsecond timestamp uniform over the same
    three years with 3 % nulls, ``v`` float64 standard normal."""
    import numpy as np

    rng = np.random.default_rng(seed)
    days = (rng.integers(0, DATE_DAYS, rows) + DATE_EPOCH_DAY).astype(np.int32)
    lo = DATE_EPOCH_DAY * 86_400_000_000
    ts = rng.integers(lo, lo + DATE_DAYS * 86_400_000_000, rows)
    null = rng.random(rows) < DATE_TS_NULLS
    v = rng.standard_normal(rows)
    return {"days": days, "ts": ts, "null": null, "v": v}


def build_date_groupby(device: Any, rows: int, seed: int
                       ) -> Tuple[Callable[[], Tuple[float, Any, Any]], Dict[str, Any]]:
    """``date_frame`` uploaded and ``(run_once, data)``: SUM, AVG and COUNT
    of ``v`` and MIN and MAX of ``ts`` by ``d``, to pandas."""
    import pyarrow as pa

    from fugue_tpu_torch import aggregate, col, functions as ff, make_execution_engine

    d = date_frame(rows, seed)
    engine = make_execution_engine("torch", device=device)
    table = pa.table({
        "d": pa.array(d["days"], pa.int32()).cast(pa.date32()),
        "ts": pa.array(d["ts"], pa.int64(), mask=d["null"]).cast(pa.timestamp("us")),
        "v": d["v"],
    })
    src = engine.persist(engine.to_df(table))
    del table

    def run_once() -> Tuple[float, Any, Any]:
        t = time.perf_counter()
        res = aggregate(src, partition_by="d", engine=engine, as_fugue=True,
                        sv=ff.sum(col("v")), mv=ff.avg(col("v")), c=ff.count(col("v")),
                        lo=ff.min(col("ts")), hi=ff.max(col("ts")))
        pdf = res.as_pandas()
        return time.perf_counter() - t, res, pdf

    return run_once, d


# each string path's launches in one run
STRING_PATH_LAUNCHES = {
    # the codes pass through, the dictionary is remapped on the host
    "config1_map": {},
    # the WHERE's LUTs (one filter launch), the fused sums by the binned
    # string key, K10 at the export
    "string_groupby": dict(expr_program=1, expr_program_filter=1, binned_sums=1,
                           gather_rows=1),
    # the assign (a canonicalising LUT and LENGTH's LUT), the fused sums
    "string_upper_groupby": dict(expr_program=1, binned_sums=1, gather_rows=1),
    # one harmonize LUT, K1 over the stacked codes, K7, K8, K9, K10 a
    # side, then the fused sums by the binned key
    "string_join": dict(expr_program=1, bin_factorize=1, join_build=1, join_probe=1,
                        join_expand=1, gather_rows=3, binned_sums=1),
    # K1 over the binned date (cold only), the fused sums, K4 for MIN and
    # MAX
    "date_groupby": dict(bin_factorize=1, binned_sums=1, segment_extrema=1, gather_rows=1),
}
# the kernels a path launches in its cold run only: the factorization of
# a frame's keys is cached on the frame (groupby.factorize_keys)
CACHED_ON_FRAME = {
    "date_groupby": ("bin_factorize",),
    "take_top_n": ("bin_factorize",),
    "repartition_hash": ("bin_factorize",),
    "distinct_pairs": ("sort_word", "sort_word_boundaries", "sort_finish"),
}


def string_paths(device: Any, rows: int, warm_runs: int, dims: int = JOIN_DIMS,
                 config1_rows: Tuple[int, ...] = ()) -> List[Dict[str, Any]]:
    """Config 1 (at ``config1_rows``, else ``rows``), the string paths of
    ``build_string_paths`` and the date group-by at ``rows`` rows, each
    checked against numpy/pandas: keys, counts, integer sums, the filter's
    kept rows and the join's rows exactly, float32-accumulated sums within
    ``MAIN_PATH_RTOL``, float64 ones within ``FLOAT64_SUM_RTOL``; each
    with its launches held to ``STRING_PATH_LAUNCHES`` on the card."""
    import numpy as np
    import pandas as pd
    import torch

    from fugue_tpu_torch.torch_backend import relational

    out: List[Dict[str, Any]] = []
    for n in config1_rows or (rows,):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        run_once, codes = build_config1(device, n)
        stats, _, pdf = _path_stats("config1_map", n, run_once, device, warm_runs)
        want = np.array(["Apple", "Banana", "Carrot"], dtype=object)[codes]
        if list(pdf.columns) != ["id", "value"] or not np.array_equal(
                pdf["id"].to_numpy(), np.arange(n)) or not (pdf["value"].to_numpy() == want).all():
            raise SystemExit(f"FAIL config1_map at {n} rows: differs from the mapped letters")
        out.append(stats)
        del run_once, codes, pdf, want
        torch.cuda.empty_cache()

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run_for, d, engine = build_string_paths(device, rows, STRING_SEED, dims)
    want = string_oracle(d)
    for label, exact, inexact in (
        ("string_groupby", ("c",), {"sv": MAIN_PATH_RTOL}),
        ("string_upper_groupby", ("c", "sn"), {"sv": MAIN_PATH_RTOL}),
        ("string_join", ("c", "sw"), {"sv": MAIN_PATH_RTOL}),
    ):
        before = relational.readbacks
        stats, frame, pdf = _path_stats(label, rows, run_for[label], device, warm_runs)
        key = "u" if label == "string_upper_groupby" else "s"
        stats["max_rel_err"] = _check_string_result(label, pdf, want[label], key, exact, inexact)
        stats["groups"] = len(pdf)
        stats["join_readbacks_per_run"] = (relational.readbacks - before) / (1 + warm_runs)
        if label == "string_join":
            if stats["join_readbacks_per_run"] != 1:
                raise SystemExit(f"FAIL {label}: {stats['join_readbacks_per_run']} readbacks a run")
            stats["join_rows"] = want[label]["rows"]
            stats["route"] = "join_expand"
        out.append(stats)
    del run_for, d, engine
    torch.cuda.empty_cache()

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run_once, d = build_date_groupby(device, rows, DATE_SEED)
    stats, _, pdf = _path_stats("date_groupby", rows, run_once, device, warm_runs)
    day = d["days"] - DATE_EPOCH_DAY
    c_all = np.bincount(day, minlength=DATE_DAYS)
    sv = np.bincount(day, weights=d["v"], minlength=DATE_DAYS)
    ok = ~d["null"]
    ext = pd.DataFrame({"d": day[ok], "ts": d["ts"][ok]}).groupby("d")["ts"].agg(["min", "max"])
    occ = np.nonzero(c_all)[0]
    pdf = pdf.sort_values("d").reset_index(drop=True)
    got_days = pdf["d"].to_numpy().astype("datetime64[D]").astype(np.int64) - DATE_EPOCH_DAY
    lo = pdf["lo"].to_numpy().astype("datetime64[us]").astype(np.int64)
    hi = pdf["hi"].to_numpy().astype("datetime64[us]").astype(np.int64)
    if list(pdf.columns) != ["d", "sv", "mv", "c", "lo", "hi"] or not np.array_equal(
            got_days, occ) or not np.array_equal(pdf["c"].to_numpy(), c_all[occ]) or \
            not np.array_equal(lo, ext["min"].reindex(occ).to_numpy()) or \
            not np.array_equal(hi, ext["max"].reindex(occ).to_numpy()):
        raise SystemExit("FAIL date_groupby: keys, counts, MIN or MAX differ from numpy")
    stats["max_rel_err"] = _check_columns(
        pdf.assign(k=got_days), {"k": occ, "sv": sv[occ], "mv": sv[occ] / c_all[occ]}, (),
        {"sv": FLOAT64_SUM_RTOL, "mv": FLOAT64_SUM_RTOL}, "date_groupby")
    stats["groups"] = len(pdf)
    out.append(stats)
    del run_once, d
    torch.cuda.empty_cache()
    return out


def lut_timing(device: Any, launches: Dict[str, int]) -> List[Dict[str, Any]]:
    """Each program of the JAX package's table gathers by dictionary code,
    at 100M rows of ``k6_string_frame`` with CUDA events: K6, its twin and
    the one PyTorch call for the gather alone (``index_select`` of the
    table by the codes), beside the bound (each input's codes and mask
    read once, each output and mask written once, over the HBM rate).
    ``launches`` holds each program's launches in one run of its path.
    Returns their ``kernels`` entries."""
    import torch

    from fugue_tpu_torch.column.expressions import _FuncExpr, col
    from fugue_tpu_torch.column.functions import like
    from fugue_tpu_torch.kernels.expr_program import compile_program, remap_program
    from fugue_tpu_torch.torch_backend import strings

    frame = k6_string_frame(device, ROWS, STRING_SEED)
    cols = {n: (c.data.dtype, c.mask is not None) for n, c in frame.columns.items()}
    dicts = {n: c.dictionary for n, c in frame.columns.items() if c.is_string}
    s, t, p = col("s"), col("t"), col("p")
    programs = [
        ("like", "fugue_tpu/jax_backend/expr_eval.py:64", [like(s, "sku-1%")]),
        ("like_pairs", "fugue_tpu/jax_backend/expr_eval.py:197",
         [_FuncExpr("like", s, p, False)]),
        ("compare", "fugue_tpu/jax_backend/expr_eval.py:477", [s < t]),
        ("length", "fugue_tpu/jax_backend/expr_eval.py:303", [_FuncExpr("length", s)]),
        ("canonicalize", "fugue_tpu/jax_backend/expr_eval.py:572",
         [_FuncExpr("upper", _FuncExpr("substring", s, 1, 6))]),
    ]
    entries = []
    for label, replaces, exprs in programs:
        prog = compile_program(exprs, [None], cols, dicts, device)
        inputs = [(frame.columns[n].data, frame.columns[n].mask) for n, _ in prog.inputs]
        entries.append(_lut_entry(label, replaces, launches.get(label, 0), prog, inputs, exprs))
    table, _ = strings.remap_table(frame.columns["s"].dictionary, frame.columns["t"].dictionary)
    prog = remap_program(torch.from_numpy(table).to(device))
    entries.append(_lut_entry("harmonize", "fugue_tpu/jax_backend/relational.py:69",
                              launches.get("harmonize", 0), prog,
                              [(frame.columns["t"].data, None)], None))
    del frame
    torch.cuda.empty_cache()
    return entries


def _lut_entry(label: str, replaces: str, launches: int, prog: Any, inputs: List[Any],
               exprs: Optional[List[Any]]) -> Dict[str, Any]:
    """One LUT program timed: K6, its twin, ``index_select`` of its first
    table by its first input's codes, and its bound."""
    import torch

    from fugue_tpu_torch.kernels.expr_program import expr_program_cuda
    from fugue_tpu_torch.kernels.reference import expr_program_reference

    device, n = inputs[0][0].device, ROWS
    got = expr_program_cuda(prog, inputs, n, device=device)
    want = expr_program_reference(prog, inputs, n, device=device)
    err = check_k6(f"{label} timed", exprs or ["remap"], False, got, want) if exprs else 0.0
    if not exprs and not torch.equal(got[0][0], want[0][0]):
        raise SystemExit(f"FAIL expr_program {label} timed: differs from the twin")
    del got, want
    ms = time_cuda(lambda: expr_program_cuda(prog, inputs, n, device=device), 20)
    plain_ms = time_cuda(lambda: expr_program_reference(prog, inputs, n, device=device), 5)
    table, codes = prog.tables[0], inputs[0][0].long()
    library_ms = time_cuda(lambda: torch.index_select(table, 0, codes), 20)
    del codes
    per_row = _k6_kernel(prog, inputs, {}).bytes_per_row
    entry = _kernel_entry(f"expr_program[LUT {label}]", replaces, launches, err, ms, plain_ms,
                          per_row * n, 0, library_ms, source="expr_codegen.py")
    entry["instrs"] = [str(i) for i in prog.instrs]
    entry["table_entries"] = [int(t.shape[0]) for t in prog.tables]
    views = shifted(inputs)
    entry["ms_scalar"] = time_cuda(lambda: expr_program_cuda(prog, views, n, device=device), 20)
    del views
    entry["bytes_per_row"] = per_row
    print("expr_program LUT timed: " + json.dumps(entry))
    return {k: entry[k] for k in _ENTRY_KEYS}


# --- set operations, distinct, dropna/fillna, take, sample, repartition ---

TAKE_N = 10  # take(n=10, presort="v desc", partition="k") on the headline frame
GLOBAL_TAKE_N = 1_000  # take(n, presort="k asc, v desc", na_position="first")
TAKE_NULLS = 0.05  # the global take's null v
TAKE_SEED = 43
# TPC-DS queries 38 and 87: INTERSECT / EXCEPT of the (c_last_name,
# c_first_name, d_date) rows of two sales channels
Q_NAMES = (10_000, 1_000)  # last names, first names
Q_DAYS, Q_EPOCH_DAY = 365, 18_993  # 2022-01-01
Q_SEED = 13
NA_SEED = 17
NA_NULLS, NA_NANS = 0.05, 0.01  # dropna/fillna: four float64 columns
NA_NAMES = 100  # and a string column over 100 names, 5 % null
NA_THRESH = 3
SAMPLE_N, SAMPLE_FRAC, SAMPLE_SEED = 1_000_000, 0.01, 5
REPARTITION_NUM = 8

# each path's launches in one run; the factorization of a frame's keys is
# cached on the frame (CACHED_ON_FRAME), the set operations' shared one is
# not (each call stacks its two frames anew)
_Q_FACTORIZE = dict(expr_program=2, sort_boundaries=1, sort_finish=1, join_build=1)
RELATIONAL_PATH_LAUNCHES = {
    # a take's kept rows are a masked frame: K10 at its export
    "take_top_n": dict(bin_factorize=1, presort_word=1, join_build=1, rank_keep=1,
                       gather_rows=1),
    "take_global": dict(presort_word=1, rank_keep=1, gather_rows=1),
    "distinct_pairs": dict(sort_word=1, sort_word_boundaries=1, sort_finish=1,
                           first_row_mask=1),
    "intersect_distinct": dict(**_Q_FACTORIZE, first_row_mask=1),
    "except_distinct": dict(**_Q_FACTORIZE, first_row_mask=1),
    "intersect_all": {**_Q_FACTORIZE, "join_build": 2, "rank_keep": 1},
    "except_all": {**_Q_FACTORIZE, "join_build": 2, "rank_keep": 1},
    "dropna_any": dict(null_count_keep=1),
    "dropna_all": dict(null_count_keep=1),
    "dropna_thresh": dict(null_count_keep=1),
    "fillna_scalar": dict(expr_program=1),
    "fillna_dict": dict(expr_program=1),
    "fillna_string": dict(expr_program=1),
    "sample_frac": dict(rank_keep=1),
    "sample_n": dict(rank_keep=1),
    "repartition_hash": dict(bin_factorize=1, presort_word=1, gather_rows=1),
    "repartition_rand": dict(gather_rows=1),
}


def presort_cases(device: Any, n: int, seed: int) -> List[Tuple[str, List[Any], Dict[str, Any]]]:
    """K11's cases at ``n`` rows: ``(label, keys, keyword arguments)``.
    Ties, -0.0 and +0.0, NaN and nulls in float keys; descending and nulls
    first; narrowed, int64 and uint8 keys; a string's ranks; a float64
    key split over two words (its flag ending one, its field the next);
    a masked and a short prefix frame's "not real" bit, alone too."""
    import torch

    from fugue_tpu_torch.kernels.reference import PresortKey

    gen = torch.Generator(device=device).manual_seed(seed)

    def rand() -> Any:
        return torch.rand((n,), generator=gen, device=device)

    f32 = torch.round(torch.randn((n,), generator=gen, device=device) * 4) / 4
    f32 = torch.where(rand() < 0.1, -0.0, torch.where(rand() < 0.05, float("nan"), f32))
    f64 = torch.where(rand() < 0.05, float("nan"), f32.to(torch.float64) * 1e300)
    mask = rand() > 0.1
    i64 = torch.randint(-(2**62), 2**62, (n,), generator=gen, device=device)
    i64 = torch.where(rand() < 0.3, torch.tensor(-(2**63), device=device), i64)
    i32 = torch.randint(-50, 50, (n,), generator=gen, device=device, dtype=torch.int32)
    seg = torch.randint(0, 1025, (n,), generator=gen, device=device, dtype=torch.int32)
    u8 = torch.randint(0, 256, (n,), generator=gen, device=device, dtype=torch.uint8)
    i8 = torch.randint(-128, 128, (n,), generator=gen, device=device, dtype=torch.int8)
    b = rand() < 0.5
    rank = torch.randint(0, 10_000, (n,), generator=gen, device=device, dtype=torch.int32)
    row_valid = rand() < 0.9
    short = dict(nrows=max(n - 3, 0)) if n > 3 else dict(row_valid=row_valid)
    nan_key = PresortKey(f32, mask, desc=True, nulls_first=True, nan_is_null=True)
    k64 = PresortKey(f64, mask, desc=True, nan_is_null=True)
    return [
        ("f32 desc nulls first, nan null", [nan_key], {}),
        ("f32 asc nulls last, masked frame", [nan_key._replace(desc=False, nulls_first=False)],
         dict(unreal=True, row_valid=row_valid)),
        ("f32 no flag: NaN its own value", [PresortKey(f32)], {}),
        ("top-n: segment then f32 desc", [PresortKey(seg, kmin=0, bits=11),
                                         PresortKey(f32, None, desc=True, nan_is_null=True)], {}),
        ("global take: narrowed i32 then f32 desc nulls first",
         [PresortKey(i32, None, kmin=-50, bits=7), nan_key], dict(unreal=True, **short)),
        ("i64 desc over its type's range, its flag in another word",
         [PresortKey(i64, mask, desc=True, kmin=-(2**63), bits=64, flag=False)], {}),
        ("bool desc, u8 desc, i8 nulls first", [PresortKey(b, None, desc=True),
                                               PresortKey(u8, None, desc=True),
                                               PresortKey(i8, mask, nulls_first=True)], {}),
        ("string ranks desc nulls first", [PresortKey(rank, mask, desc=True, nulls_first=True,
                                                      kmin=0, bits=14)], {}),
        ("f64 flag ending a word", [PresortKey(i32, None, kmin=-50, bits=7),
                                    k64._replace(value=False)], dict(unreal=True, **short)),
        ("f64 field in the next word", [k64._replace(flag=False)], {}),
        ("the not-real bit alone", [], dict(unreal=True, row_valid=row_valid)),
    ]


def multiword_order_check(device: Any, n: int, seed: int) -> None:
    """``relational.presort_order`` over keys of more than 64 bits (three
    words) against numpy's ``lexsort`` of the same keys: the float64's
    flag and field split over two words, nulls and NaN first."""
    import numpy as np
    import torch

    from fugue_tpu_torch.kernels.reference import PresortKey
    from fugue_tpu_torch.torch_backend import relational

    gen = torch.Generator(device=device).manual_seed(seed)
    i32 = torch.randint(-3, 3, (n,), generator=gen, device=device, dtype=torch.int32)
    f64 = torch.round(torch.randn((n,), generator=gen, device=device, dtype=torch.float64) * 2)
    f64 = torch.where(torch.rand((n,), generator=gen, device=device) < 0.05, float("nan"), f64)
    i64 = torch.randint(-5, 5, (n,), generator=gen, device=device) * (2**60)
    mask = torch.rand((n,), generator=gen, device=device) > 0.1
    keys = [PresortKey(i32, None, desc=True, kmin=-(2**31), bits=32),
            PresortKey(f64, mask, desc=True, nulls_first=True, nan_is_null=True),
            PresortKey(i64, None, kmin=-(2**63), bits=64)]
    order = relational.presort_order(keys, n, device, nrows=n).cpu().numpy()
    a, f, c = (t.cpu().numpy() for t in (i32, f64, i64))
    null = ~mask.cpu().numpy() | np.isnan(f)
    want = np.lexsort((np.arange(n), c, -np.where(null, 0.0, f) + 0.0, ~null, -a.astype(np.int64)))
    if not np.array_equal(order, want):
        raise SystemExit(f"FAIL presort_order of three words at n={n}: differs from lexsort")


def sorted_segment_frame(device: Any, n: int, nseg: int, seed: int, form: str,
                         rows: str = "masked") -> Dict[str, Any]:
    """A frame of ``n`` rows over ``nseg`` segments sorted as K12's callers
    sort it, the rows that are not real last (``rows``: "full", "short" or
    "masked"), as K12's keyword arguments ``order``, ``seg``,
    ``word_shift`` and ``starts``: ``form`` "id" an int32 segment id with
    the sentinel ``nseg`` (INTERSECT/EXCEPT ALL: one stable sort of the
    ids), "word64" the first K11 word of the segment and a float32 key
    desc (the top-n take), "word32" of the segment and a narrowed int8 key,
    "real bit" the global take's word (a float32 key, the "not real" bit
    its segment)."""
    import torch

    from fugue_tpu_torch.kernels.reference import PresortKey, presort_bits
    from fugue_tpu_torch.torch_backend import relational

    gen = torch.Generator(device=device).manual_seed(seed)
    sid = torch.randint(0, nseg, (n,), generator=gen, device=device, dtype=torch.int32)
    frame: Dict[str, Any] = dict(nrows=n)
    real = torch.ones((n,), dtype=torch.bool, device=device)
    if rows == "short":
        frame = dict(nrows=n - n // 4)
        real[n - n // 4:] = False
    elif rows == "masked":
        real = torch.rand((n,), generator=gen, device=device) < 0.8
        frame = dict(row_valid=real)
    sid = torch.where(real, sid, nseg)
    counts = torch.bincount(sid.long(), minlength=nseg + 1)[:nseg]
    starts = torch.cumsum(counts, 0) - counts
    if form == "id":
        srt = torch.sort(sid, stable=True)
        return dict(order=srt.indices, seg=srt.values, starts=starts)
    v = torch.rand((n,), generator=gen, device=device)
    if form == "word32":
        key = PresortKey(torch.randint(-3, 4, (n,), generator=gen, device=device,
                                       dtype=torch.int8), kmin=-3, bits=3)
    else:
        key = PresortKey(v, None, desc=True, nan_is_null=True)
    keys = [key] if form == "real bit" else [PresortKey(sid, kmin=0, bits=nseg.bit_length()), key]
    words, groups = relational._presort_words(keys, n, device, frame.get("nrows"),
                                              frame.get("row_valid"))
    order, first = relational._lsd_order(words)
    if form == "real bit":
        return dict(order=order, seg=first, word_shift=presort_bits(groups[0], True) - 1,
                    starts=torch.zeros((1,), dtype=torch.int64, device=device))
    return dict(order=order, seg=first, word_shift=presort_bits(groups[0][1:], False),
                starts=starts)


def rank_keep_cases(device: Any, n: int, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """K12's cases at ``n`` rows, over the sorted segment forms its callers
    pass: no segment (sample) with limits from 0 past the rows, rank at
    least; an id with the sentinel (INTERSECT/EXCEPT ALL) by per-segment
    limits, also of 0, and one limit both walked by (segment, rank) pairs
    and over every position; the first K11 word, int64 and int32 (the
    top-n take), and the "not real" bit alone (the global take) over
    masked, short and full frames; one segment, none, and an order that is
    the rows themselves, so a warp's kept rows share words."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    order = torch.randperm(n, generator=gen, device=device)
    nseg = max(min(n // 50, 1 << 20), 1)
    limits = torch.randint(0, 60, (nseg,), generator=gen, device=device, dtype=torch.int32)

    def lim(v: int) -> Any:
        return torch.full((), v, dtype=torch.int64, device=device)

    ids = sorted_segment_frame(device, n, nseg, seed, "id")
    one = sorted_segment_frame(device, n, 1, seed + 1, "id", rows="short")
    w64 = sorted_segment_frame(device, n, nseg, seed + 2, "word64")
    w32 = sorted_segment_frame(device, n, nseg, seed + 3, "word32", rows="full")
    rbit = sorted_segment_frame(device, n, 1, seed + 4, "real bit")
    zeros = torch.zeros((nseg,), dtype=torch.int32, device=device)
    arange = torch.arange(n, device=device)
    clustered = dict(order=arange, seg=torch.div(arange, 40, rounding_mode="floor").to(
        torch.int32), starts=torch.arange(0, n, 40, device=device))
    return [
        ("no segment, limit n / 3", dict(order=order, limit=lim(n // 3))),
        ("no segment, limit 0", dict(order=order, limit=lim(0))),
        ("no segment, limit above the rows", dict(order=order, limit=lim(n + 5))),
        ("no segment, rank at least n / 4", dict(order=order, limit=lim(n // 4), mode="ge")),
        ("ids, limits below", dict(**ids, limits=limits)),
        ("ids, limits at least", dict(**ids, limits=limits, mode="ge")),
        ("ids, limits of 0 below", dict(**ids, limits=zeros)),
        ("ids, limits of 0 at least", dict(**ids, limits=zeros, mode="ge")),
        ("ids, one limit by pairs", dict(**ids, limit=lim(7))),
        ("ids, one limit over every position", dict(**ids, limit=lim(n))),
        ("one segment, short frame", dict(**one, limit=lim(n // 2 + 1))),
        ("no segment at all", dict(**{**ids, "starts": ids["starts"][:0]}, mode="ge",
                                   limits=limits[:0])),
        ("int64 word, limit 10", dict(**w64, limit=lim(10))),
        ("int64 word, limits at least", dict(**w64, limits=limits, mode="ge")),
        ("int32 word, limit 3", dict(**w32, limit=lim(3))),
        ("the not-real bit, limit n / 2", dict(**rbit, limit=lim(n // 2 + 1))),
        ("rows in order, a warp's rows in one word", dict(**clustered, limit=lim(25))),
    ]


def first_row_cases(device: Any, n: int, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """K13's cases: every segment, occupied bins only, the hit and miss
    predicates, first rows at or beyond ``n`` (a shared factorization's
    side-2 segments), adjacent first rows (one slab's, in order), and no
    segment."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    num = max(n // 10, 1)
    first = torch.randperm(n + n // 10 + 1, generator=gen, device=device)[:num].to(torch.int32)
    occupied = torch.rand((num,), generator=gen, device=device) < 0.7
    counts = torch.randint(0, 3, (num,), generator=gen, device=device, dtype=torch.int32)
    empty = torch.empty((0,), dtype=torch.int32, device=device)
    adjacent = torch.arange(num, device=device, dtype=torch.int32)
    return [
        ("all", dict(first_idx=first, n=n)),
        ("all, occupied", dict(first_idx=first, n=n, occupied=occupied)),
        ("hit", dict(first_idx=first, n=n, counts=counts, mode="hit")),
        ("miss, occupied", dict(first_idx=first, n=n, occupied=occupied, counts=counts,
                                mode="miss")),
        ("adjacent first rows, occupied", dict(first_idx=adjacent, n=n, occupied=occupied)),
        ("no segment", dict(first_idx=empty, n=n)),
    ]


NULL_COUNT_EDGE_ROWS = 16 * 1024 + 7  # K14's groups of 16 rows and a tail of 7


def null_count_cases(device: Any, n: int, seed: int, many: bool
                     ) -> List[Tuple[str, Dict[str, Any]]]:
    """K14's cases: no mask, one, four, and (``many``) 70 and 300 masks
    (past the 64 passed by value, past the 255 a byte lane counts); any,
    all and thresh, ``thresh`` at and beyond each end of the masks' range
    (every real row kept without a mask read, or none); prefix frames,
    ``nrows`` inside a group of 16 rows, masked frames; masks and
    ``row_valid`` as views one byte off (the scalar route). Each case's
    expected route is its label's last word."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    masks = [torch.rand((n,), generator=gen, device=device) > 0.05 * (j + 1)
             for j in range(70 if many else 4)]
    row_valid = torch.rand((n,), generator=gen, device=device) < 0.9
    off = shifted([(m, None) for m in masks[:4]] + [(row_valid, None)])
    cases = [
        ("no mask, vector", dict(masks=[], ncols=3, n=n, nrows=n)),
        ("one mask, all, vector", dict(masks=masks[:1], ncols=2, n=n, nrows=max(n - 1, 0),
                                       how="all")),
        ("four masks, any, masked, vector", dict(masks=masks[:4], ncols=4, n=n,
                                                 row_valid=row_valid)),
        ("four masks, thresh 3, vector", dict(masks=masks[:4], ncols=5, n=n, nrows=n, thresh=3)),
        ("four masks, nrows inside a group, vector", dict(masks=masks[:4], ncols=4, n=n,
                                                          nrows=n // 2 + 5 if n > 10 else n)),
        ("four masks, all, unaligned views, scalar", dict(
            masks=[m for m, _ in off[:4]], ncols=4, n=n, row_valid=off[4][0], how="all")),
        ("four masks, thresh 3, one view unaligned, scalar", dict(
            masks=masks[:3] + [off[3][0]], ncols=5, n=n, nrows=n, thresh=3)),
    ]
    # thresh over six columns, two without a mask: -1 and 0 and 2 (every
    # real row, no mask read), 6 (every mask set), 7 (none, no mask read)
    for thresh in (-1, 0, 2, 6, 7):
        cases.append((f"four masks of six columns, thresh {thresh}, vector", dict(
            masks=masks[:4], ncols=6, n=n, nrows=n, thresh=thresh)))
    if many:
        cases.append(("70 masks, thresh 66, vector", dict(masks=masks, ncols=72, n=n,
                                                          row_valid=row_valid, thresh=66)))
        wide = [torch.rand((n,), generator=gen, device=device) > 0.002 for _ in range(300)]
        cases.append(("300 masks, any, vector", dict(masks=wide, ncols=300, n=n, nrows=n)))
        cases.append(("300 masks, thresh 298 of 301, masked, vector", dict(
            masks=wide, ncols=301, n=n, row_valid=row_valid, thresh=298)))
    for _, kw in cases:
        kw["device"] = device
    return cases


DROPNA_COPY_COLUMNS = 64  # the most masks K14 takes by value (kParamMasks)


def dropna_copies(device: Any, rows: int, tries: int = 3) -> Dict[str, Any]:
    """One dropna (``thresh``) over ``DROPNA_COPY_COLUMNS`` nullable float32
    columns of ``rows`` rows on the card, under ``torch.profiler``: fails
    where the trace holds a host-to-device copy, and where, in ``tries``
    traces, it holds no launch of K14 (a trace without the kernel shows
    nothing). Returns the trace's device events by name."""
    import numpy as np
    import pyarrow as pa
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import fugue_tpu_torch as ft

    engine = ft.make_execution_engine("torch", device=device)
    rng = np.random.default_rng(SEED)
    table = pa.table({f"c{j}": pa.array(rng.standard_normal(rows).astype(np.float32),
                                        mask=rng.random(rows) < 0.01)
                      for j in range(DROPNA_COPY_COLUMNS)})
    src = engine.persist(engine.to_df(table))
    del table
    thresh = DROPNA_COPY_COLUMNS - 2

    def dropna() -> Any:
        return ft.dropna(src, thresh=thresh, engine=engine)

    want = int(dropna().count())  # warm: the library loaded, the allocator primed
    for _ in range(tries):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = dropna()
            torch.cuda.synchronize(device)
        names: Dict[str, int] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                names[e.name] = names.get(e.name, 0) + 1
        if any("null_count_keep" in name for name in names):
            break
    else:
        raise SystemExit(f"FAIL dropna_copies: {tries} traces held no launch of null_count_keep "
                         f"(device events {names})")
    copies = [name for name in names if "HtoD" in name]
    if copies:
        raise SystemExit(f"FAIL dropna_copies: a dropna of {DROPNA_COPY_COLUMNS} masked columns "
                         f"copied to the card: {copies}")
    if int(out.count()) != want:
        raise SystemExit("FAIL dropna_copies: the profiled dropna kept another count")
    return {"columns": DROPNA_COPY_COLUMNS, "rows": rows, "device_events": names}


def row_select_vs_twin(device: Any, sizes: Tuple[int, ...]) -> None:
    """K11 (KW's presort mode), K12, K13 and K14 against their twins, bit
    for bit, in every case above at each size, and K14 also at
    ``NULL_COUNT_EDGE_ROWS`` with K14's route checked on the card; the
    multi-word presort order against ``numpy.lexsort`` up to 2^20 + 37
    rows."""
    import torch

    from fugue_tpu_torch.kernels.factorize import presort_word_cuda
    from fugue_tpu_torch.kernels.reference import (
        first_row_mask_reference,
        null_count_keep_reference,
        presort_word_reference,
        rank_keep_reference,
    )
    from fugue_tpu_torch.kernels.row_select import (
        first_row_mask_cuda,
        null_count_keep_cuda,
        rank_keep_cuda,
    )

    def same(label: str, got: Any, want: Any) -> None:
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
                raise SystemExit(f"FAIL {label}: differs from its twin")

    def null_count_vs_twin(n: int, cases: List[Tuple[str, Dict[str, Any]]]) -> None:
        """K14 in each case, its route checked on the card."""
        for label, kw in cases:
            same(f"null_count_keep {label} n={n}", null_count_keep_cuda(**kw),
                 null_count_keep_reference(**kw))
            check_last_path(null_count_keep_cuda, f"null_count_keep {label} n={n}",
                            label.rsplit(" ", 1)[1])

    for n in sizes:
        for label, keys, kw in presort_cases(device, n, n + 1):
            same(f"presort_word {label} n={n}", [presort_word_cuda(keys, **kw)],
                 [presort_word_reference(keys, **kw)])
        if n <= (1 << 20) + 37:
            multiword_order_check(device, n, n + 2)
        for label, kw in rank_keep_cases(device, n, n + 3):
            same(f"rank_keep {label} n={n}", rank_keep_cuda(**kw), rank_keep_reference(**kw))
        for label, kw in first_row_cases(device, n, n + 4):
            same(f"first_row_mask {label} n={n}", first_row_mask_cuda(**kw),
                 first_row_mask_reference(**kw))
        null_count_vs_twin(n, null_count_cases(device, n, n + 5, many=n <= (1 << 20) + 37))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"row_select_vs_twin: n={n} equal")
    null_count_vs_twin(NULL_COUNT_EDGE_ROWS, null_count_cases(
        device, NULL_COUNT_EDGE_ROWS, NULL_COUNT_EDGE_ROWS, many=True))
    print(f"row_select_vs_twin: null_count_keep at n={NULL_COUNT_EDGE_ROWS} equal")


WINDOW_PARTS = 1000  # partitions of the window checks
# K16's frames in the window checks: (unit, first bound, last bound)
WINDOW_FRAMES = (
    ("running", ("up", 0), ("c", 0)), ("rows", ("p", 3), ("c", 0)),
    ("rows", ("up", 0), ("f", 1)), ("rows", ("c", 0), ("uf", 0)),
    ("rows", ("p", 100), ("f", 100)), ("groups", ("p", 1), ("f", 1)),
    ("groups", ("c", 0), ("uf", 0)), ("range", ("p", 2), ("c", 0)),
    ("range", ("c", 0), ("f", 1.5)),
)
WINDOW_AGGS = ("count", "sum", "avg", "min", "max", "first_value", "last_value", "nth_value")
# float64 frame sums and averages against the twin: rtol, and an atol of
# this times the largest absolute prefix sum of the row's partition
FRAME_SUM_RTOL, FRAME_SUM_ATOL = 1e-9, 1e-12


def window_data(device: Any, n: int, seed: int) -> Dict[str, Any]:
    """The window checks' columns at ``n`` rows: ``part`` over
    ``WINDOW_PARTS`` partitions, a masked frame's ``row_valid``; order
    keys ``a`` (int32 over 50 values, 10 % null: many ties) and ``b``
    (float64 in halves, 5 % NaN, 5 % null); arguments ``fv`` (float64, 3 %
    NaN, 5 % null) and ``iv`` (int64 over [-1000, 1000), 5 % null)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def rand() -> Any:
        return torch.rand((n,), generator=gen, device=device)

    b = torch.round(torch.randn((n,), generator=gen, device=device, dtype=torch.float64) * 4) / 2
    fv = torch.randn((n,), generator=gen, device=device, dtype=torch.float64)
    return dict(
        part=torch.randint(0, WINDOW_PARTS, (n,), generator=gen, device=device,
                           dtype=torch.int32),
        row_valid=rand() < 0.9,
        a=torch.randint(0, 50, (n,), generator=gen, device=device, dtype=torch.int32),
        amask=rand() > 0.1,
        b=torch.where(rand() < 0.05, float("nan"), b), bmask=rand() > 0.05,
        fv=torch.where(rand() < 0.03, float("nan"), fv), fmask=rand() > 0.05,
        iv=torch.randint(-1000, 1000, (n,), generator=gen, device=device), imask=rand() > 0.05,
    )


def window_orders(device: Any, d: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Three window orders of ``d``'s rows (``relational.presort_sorted``,
    K11 on the card) and each one's RANGE key: ``by_a`` partitions a
    masked frame by ``part`` and orders by ``a``, nulls last; ``one_b``
    holds every row of a prefix frame in one partition ordered by ``b``
    descending, NaN and nulls first; ``by_ab`` by ``a`` descending, then
    ``b`` nulls first, in ``part``."""
    import torch

    from fugue_tpu_torch.kernels.reference import PresortKey
    from fugue_tpu_torch.torch_backend import relational

    seg = torch.where(d["row_valid"], d["part"], WINDOW_PARTS)
    by = PresortKey(seg, kmin=0, bits=WINDOW_PARTS.bit_length())
    a = PresortKey(d["a"], d["amask"], kmin=0, bits=6)
    b = PresortKey(d["b"], d["bmask"], nan_is_null=True)
    one = PresortKey(torch.zeros((n,), dtype=torch.int32, device=device), kmin=0, bits=1)
    masked = dict(row_valid=d["row_valid"])
    return dict(
        by_a=(relational.presort_sorted([by, a], n, device, **masked),
              (d["a"].to(torch.float64), d["amask"], False)),
        one_b=(relational.presort_sorted([one, b._replace(desc=True, nulls_first=True)], n,
                                         device, nrows=n),
               (d["b"], d["bmask"], True)),
        by_ab=(relational.presort_sorted([by, a._replace(desc=True), b._replace(nulls_first=True)],
                                         n, device, **masked), None),
    )


def window_cases(device: Any, n: int, seed: int, full: bool
                 ) -> Tuple[List[Tuple[str, str, Any, Any]], Dict[str, Any]]:
    """The cases ``(label, order, "rank" or "frame", (func, param) or
    WindowFrame)`` and the orders (``window_orders``) they run over: with
    ``full``, every rank function on each
    order, and every aggregate and positional function of
    ``WINDOW_AGGS`` over each frame of ``WINDOW_FRAMES`` (RANGE only on the
    one-key orders) of the float and the int argument, COUNT(*), and
    lag/lead with and without defaults; else the SQL phase's shapes (the
    rank family, the running sum and min, a 7-row average, min and max,
    ``LAG(v, 1, 0)``, a RANGE sum over ``a``) and one frame of each
    unit for the table route."""
    from fugue_tpu_torch.kernels.reference import WindowFrame, frame_route

    d = window_data(device, n, seed)
    orders = window_orders(device, d, n)
    args = {"fv": (d["fv"], d["fmask"]), "iv": (d["iv"], d["imask"])}
    out: List[Tuple[str, str, Any, Any]] = []

    def frame(o: str, func: str, unit: str, lo: Any, hi: Any, arg: Optional[str],
              param: int = 0, default: Any = None) -> None:
        values, vmask = args[arg] if arg is not None else (None, None)
        key = orders[o][1] if unit == "range" else None
        fr = WindowFrame(func, param, unit, lo, hi, values, vmask, default,
                         None if key is None else key[0], None if key is None else key[1],
                         False if key is None else key[2], frame_route(func, unit, lo, hi))
        out.append((f"{o} {func}({arg or '*'}) {unit} {lo[0]}{lo[1]}..{hi[0]}{hi[1]}", o,
                    "frame", fr))

    if full:
        for o in orders:
            for func in ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist"):
                out.append((f"{o} {func}", o, "rank", (func, 0)))
            for buckets in (1, 7):
                out.append((f"{o} ntile({buckets})", o, "rank", ("ntile", buckets)))
        for o in ("by_a", "one_b"):
            for unit, lo, hi in WINDOW_FRAMES:
                frame(o, "count_star", unit, lo, hi, None)
                for func in WINDOW_AGGS:
                    for arg in args:
                        frame(o, func, unit, lo, hi, arg, param=2 if func == "nth_value" else 0)
            for func, off, default in (("lag", 1, None), ("lead", 3, None), ("lag", 2, 0),
                                       ("lead", 1, -7)):
                for arg in args:
                    frame(o, func, "running", ("up", 0), ("c", 0), arg, off, default)
        return out, orders
    for func in ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist"):
        out.append((f"by_a {func}", "by_a", "rank", (func, 0)))
    out.append(("by_ab ntile(7)", "by_ab", "rank", ("ntile", 7)))
    running, seven = (("up", 0), ("c", 0)), (("p", 6), ("c", 0))
    frame("by_a", "sum", "running", *running, "fv")
    frame("one_b", "min", "rows", *running, "fv")
    for func in ("avg", "min", "max"):
        frame("by_a", func, "rows", *seven, "fv")
    frame("by_a", "lag", "running", *running, "fv", 1, 0)
    frame("by_a", "sum", "range", ("p", 10), ("c", 0), "iv")
    frame("by_a", "max", "groups", ("p", 1), ("f", 1), "fv")
    frame("by_a", "min", "range", ("p", 2), ("c", 0), "iv")
    frame("by_a", "sum", "rows", ("p", 100), ("f", 100), "fv")
    frame("by_a", "count_star", "groups", ("c", 0), ("uf", 0), None)
    return out, orders


def frame_sum_atol(sw: Any, values: Any, vmask: Any) -> Any:
    """Per row, ``FRAME_SUM_ATOL`` times the largest absolute prefix sum
    of its partition's valid values (in window order): the float64 frame
    sums' absolute tolerance against the twin and the JAX package."""
    import torch

    from fugue_tpu_torch.kernels.reference import _partition_prefix, window_positions

    ps = window_positions(sw)["ps"]
    v = values.index_select(0, sw.order)
    ok = ~torch.isnan(v) if vmask is None else vmask.index_select(0, sw.order) & ~torch.isnan(v)
    pre = _partition_prefix(torch.where(ok, v, 0.0), ps).abs()
    best = torch.zeros_like(pre).scatter_reduce(0, ps, pre, "amax")
    out = torch.empty_like(pre)
    out[sw.order] = best[ps] * FRAME_SUM_ATOL
    return out


def check_frame_sums(label: str, got: Any, want: Any, atol: Any) -> float:
    """Float64 frame sums within ``FRAME_SUM_RTOL`` and the per-row
    ``atol``; returns the largest absolute difference."""
    import torch

    diff = (got - want).abs()
    bad = diff > FRAME_SUM_RTOL * want.abs() + atol
    if bool(bad.any()):
        raise SystemExit(f"FAIL {label}: float sums differ by up to {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def window_vs_twin(device: Any, sizes: Tuple[int, ...], full_below: int = (1 << 20) + 38
                   ) -> float:
    """K15 and K16 against their twins in every case of ``window_cases``
    (the full set below ``full_below`` rows, the SQL phase's shapes
    above): ranks, counts, integer sums, extrema, positional values and
    every mask exactly, float64 sums and averages within
    ``FRAME_SUM_RTOL`` and ``frame_sum_atol``; on the card, each K16
    call's bucket counts against its slabs' rows (``check_fill``). Prints
    each size's case count and the levels of each table-route case's
    sparse table. Returns the largest float difference."""
    import torch

    from fugue_tpu_torch.kernels.reference import window_frame_reference, window_rank_reference
    from fugue_tpu_torch.kernels.window import window_frame_cuda, window_rank_cuda

    on_card = device.type == "cuda"
    worst = 0.0
    for n in sizes:
        cases, orders = window_cases(device, n, SEED + n, full=n < full_below)
        levels: Dict[str, int] = {}
        for label, o, kind, payload in cases:
            sw = orders[o][0]
            label = f"{label} n={n}"
            if kind == "rank":
                _same(f"window_rank {label}", window_rank_cuda(sw, *payload),
                      window_rank_reference(sw, *payload))
                continue
            got, want = window_frame_cuda(sw, payload), window_frame_reference(sw, payload)
            if on_card:
                check_fill(f"window_frame {label}", window_frame_cuda.last_fill, n,
                           window_frame_cuda.last_shift)
            if window_frame_cuda.last_levels:
                levels[f"{o} {payload.unit} {payload.lo}..{payload.hi}"] = \
                    window_frame_cuda.last_levels
            _same(f"window_frame {label} mask", got[1], want[1])
            if payload.func in ("sum", "avg") and got[0].is_floating_point() \
                    and payload.route != "loop":
                atol = frame_sum_atol(sw, payload.values, payload.vmask)
                worst = max(worst, check_frame_sums(f"window_frame {label}", got[0], want[0],
                                                    atol))
            else:
                _same(f"window_frame {label}", got[0], want[0])
            del got, want
        print(f"window_vs_twin: n={n} {len(cases)} cases equal (float sums within tolerance); "
              f"table levels {levels}")
        del cases, orders
        if on_card:
            torch.cuda.empty_cache()
    return worst


def window_slab_cases(device: Any) -> float:
    """K16 at the edges of its slabs: below one slab and one slab plus a
    last slab of one row, on the SQL phase's shapes of ``window_cases``
    (masked frames, so rows that are not real sort last; every route and a
    table), as ``window_vs_twin`` holds them. Returns the largest float
    difference."""
    import torch

    from fugue_tpu_torch.kernels.reference import SortedWords, WindowFrame
    from fugue_tpu_torch.kernels.window import window_frame_cuda

    one = SortedWords(torch.zeros((1,), dtype=torch.int64, device=device),
                      [torch.zeros((1,), dtype=torch.int32, device=device)], 0)
    window_frame_cuda(one, WindowFrame("count_star"))
    shift = window_frame_cuda.last_shift
    return window_vs_twin(device, ((1 << shift) - 3, (1 << shift) + 1), full_below=0)


RANK_CASES = (("row_number", 0), ("rank", 0), ("dense_rank", 0), ("ntile", 1), ("ntile", 7),
              ("percent_rank", 0), ("cume_dist", 0))


def rank_edge_orders(device: Any, n: int, seed: int) -> List[Tuple[str, Any]]:
    """Window orders of ``n`` rows at K15's edges (``SortedWords`` built
    directly): one partition of random peer groups, every row its own
    partition, every row in one peer group, and random partitions of 1 to
    64 rows; each with a random order and an ascending one."""
    import torch

    from fugue_tpu_torch.kernels.reference import SortedWords

    gen = torch.Generator(device=device).manual_seed(seed)
    peers = torch.sort(torch.randint(0, 50, (n,), generator=gen, device=device,
                                     dtype=torch.int32)).values
    starts = torch.randint(0, 64, (n,), generator=gen, device=device) == 0
    parts = (torch.cumsum(starts, 0) << 6) + torch.randint(0, 4, (n,), generator=gen,
                                                           device=device)
    shapes = [("one_partition", [peers], 31),
              ("own_partitions", [torch.arange(n, dtype=torch.int32, device=device)], 0),
              ("one_peer_group", [torch.zeros((n,), dtype=torch.int32, device=device)], 0),
              ("random_partitions", [torch.sort(parts).values], 6)]
    out = []
    for name, words, shift in shapes:
        for order_name, order in (("random", torch.randperm(n, generator=gen, device=device)),
                                  ("ascending", torch.arange(n, device=device))):
            out.append((f"{name} {order_name}", SortedWords(order, words, shift)))
    return out


def window_rank_edges(device: Any) -> None:
    """K15 against ``window_rank_reference`` bit for bit in every function
    of ``RANK_CASES`` on ``rank_edge_orders`` at sizes around a scan tile
    and a slab: 1, 31, 33, a tile and one row either side, a slab less 3
    and plus 1 row, three slabs and 17; on the card each slab's bucket
    count against its rows (``check_fill``)."""
    import torch

    from fugue_tpu_torch.kernels.reference import window_rank_reference
    from fugue_tpu_torch.kernels.window import _bind, _layout, window_rank_cuda

    on_card = device.type == "cuda"
    # a scan tile's positions and a slab's log2 rows; where the twins stand
    # in (on the CPU), small edges
    tile, shift = (_layout(_bind())[5], _layout(_bind())[4]) if on_card else (128, 9)
    slab = 1 << shift
    sizes = (1, 31, 33, tile - 1, tile, tile + 1, slab - 3, slab + 1, 3 * slab + 17)
    checked = 0
    for n in sizes:
        for label, sw in rank_edge_orders(device, n, SEED + n):
            for func, param in RANK_CASES:
                full = f"window_rank {func}({param}) {label} n={n}"
                got = window_rank_cuda(sw, func, param)
                if on_card:
                    check_fill(full, window_rank_cuda.last_fill, n, window_rank_cuda.last_shift)
                _same(full, got, window_rank_reference(sw, func, param))
                checked += 1
        if on_card:
            torch.cuda.empty_cache()
    print(f"window_rank_edges: {checked} cases equal at {sizes} rows")


def rank_order(device: Any, n: int) -> Any:
    """``window_timing``'s K15 order: ``n`` rows ranked by (``k``, ``v``
    desc), ``k`` int32 over ``GROUPS``, ``v`` float32, one int64 word."""
    import torch

    from fugue_tpu_torch.kernels.reference import PresortKey
    from fugue_tpu_torch.torch_backend import relational

    gen = torch.Generator(device=device).manual_seed(SEED)
    k = torch.randint(0, GROUPS, (n,), generator=gen, device=device, dtype=torch.int32)
    v = torch.rand((n,), generator=gen, device=device)
    return relational.presort_sorted(
        [PresortKey(k, kmin=0, bits=GROUPS.bit_length()),
         PresortKey(v, None, desc=True, nan_is_null=True)], n, device, nrows=n)


def window_rank_timing(device: Any, n: int) -> None:
    """Every function of ``RANK_CASES`` at ``n`` rows on ``rank_order``
    with CUDA events, each launch's device ms (``device_split_ms``; early
    in the run, where the profiler sees the card) and its buckets against
    its slabs (``check_fill``). Prints one ``window timed:`` line a
    function."""
    import torch

    from fugue_tpu_torch.kernels.window import window_rank_cuda

    by_v = rank_order(device, n)
    for func, param in RANK_CASES:
        window_rank_cuda(by_v, func, param)
        check_fill(f"window_rank[{func}({param})] timed", window_rank_cuda.last_fill, n,
                   window_rank_cuda.last_shift)
        print("window timed: " + json.dumps({
            "name": f"window_rank[{func}({param})]",
            "ms": time_cuda(lambda: window_rank_cuda(by_v, func, param), 10),
            "device_ms": device_split_ms(lambda: window_rank_cuda(by_v, func, param), device),
            "card": card_line()}))
    del by_v
    torch.cuda.empty_cache()


def q_channel(rows: int, rng: Any) -> Dict[str, Any]:
    """One sales channel's rows of the TPC-DS Q38/Q87 shape: last and
    first name indices and a day, each uniform."""
    import numpy as np

    return {"last": rng.integers(0, Q_NAMES[0], rows).astype(np.int32),
            "first": rng.integers(0, Q_NAMES[1], rows).astype(np.int32),
            "day": rng.integers(0, Q_DAYS, rows).astype(np.int32)}


def q_table(ch: Dict[str, Any]) -> Any:
    """A channel as arrow: the names as strings (``Lnnnnn``, ``Fnnnn``),
    the day as a date32; the port's ingest encodes the strings again, so
    each channel's dictionary is in its own order of first appearance."""
    import pyarrow as pa

    last = [f"L{i:05d}" for i in range(Q_NAMES[0])]
    first = [f"F{i:04d}" for i in range(Q_NAMES[1])]
    return pa.table({
        "last_name": _string_array(ch["last"], None, last),
        "first_name": _string_array(ch["first"], None, first),
        "d_date": pa.array(ch["day"] + Q_EPOCH_DAY, type=pa.int32()).cast(pa.date32()),
    })


def q_oracle(c1: Dict[str, Any], c2: Dict[str, Any]) -> Dict[str, Any]:
    """Numpy's keep masks of channel 1's rows: each row's ordinal among
    its equal rows (one stable argsort) and channel 2's count of its row
    (``np.unique`` and a search), then INTERSECT/EXCEPT DISTINCT (ordinal
    0 and a count above 0, or 0) and ALL (ordinal below the count, or at
    least it)."""
    import numpy as np

    def key(c: Dict[str, Any]) -> Any:
        return ((c["last"].astype(np.int64) * Q_NAMES[1] + c["first"]) * Q_DAYS + c["day"])

    k1, k2 = key(c1), key(c2)
    n1 = len(k1)
    # the row as the last digit makes every key distinct: numpy's default
    # sort is then stable, and several times faster than its stable one
    if int(k1.max(initial=0)) >= (2**63 - n1) // max(n1, 1):
        raise SystemExit("FAIL q_oracle: the packed key overflows int64")
    order = np.argsort(k1 * n1 + np.arange(n1))
    s = k1[order]
    opens = np.r_[True, s[1:] != s[:-1]]
    run_start = np.nonzero(opens)[0]
    ordinal = np.empty(len(k1), dtype=np.int64)
    ordinal[order] = np.arange(len(k1)) - run_start[np.cumsum(opens) - 1]
    u2, n2 = np.unique(k2, return_counts=True)
    pos = np.minimum(np.searchsorted(u2, s), len(u2) - 1)
    cnt = np.empty(len(k1), dtype=np.int64)
    cnt[order] = np.where(u2[pos] == s, n2[pos], 0)
    return {"intersect_distinct": (ordinal == 0) & (cnt > 0),
            "except_distinct": (ordinal == 0) & (cnt == 0),
            "intersect_all": ordinal < cnt, "except_all": ordinal >= cnt}


def na_frame(rows: int, seed: int) -> Tuple[Dict[str, Any], Any]:
    """Four float64 columns ``a``-``d`` with 5 % nulls and 1 % NaN and a
    string ``s`` over 100 names with 5 % nulls, as numpy and as arrow."""
    import numpy as np
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    d: Dict[str, Any] = {}
    cols = {}
    for name in "abcd":
        x = rng.standard_normal(rows)
        x[rng.random(rows) < NA_NANS] = np.nan
        null = rng.random(rows) < NA_NULLS
        d[name], d[f"{name}_null"] = x, null
        cols[name] = pa.array(x, mask=null)
    d["s"] = rng.integers(0, NA_NAMES, rows).astype(np.int32)
    d["s_null"] = rng.random(rows) < NA_NULLS
    cols["s"] = _string_array(d["s"], d["s_null"], [f"name{i:03d}" for i in range(NA_NAMES)])
    return d, pa.table(cols)


def build_relational_paths(device: Any, rows: int, q_rows: Tuple[int, int]
                           ) -> Tuple[Dict[str, Callable[[], Tuple[float, Any, Any]]],
                                      Dict[str, Any], Any]:
    """Upload the slice's frames and return ``(run_for, data, engine)``:
    each path's ``run_once`` through the entry points, returning
    ``(seconds, result frame, what it read back)``. A take ends in
    pandas; a selection with a large result in its row count, as Q38 and
    Q87 do; fillna and repartition in the frame on the card."""
    import numpy as np
    import pandas as pd
    import pyarrow as pa
    import torch

    import fugue_tpu_torch as ft

    engine = ft.make_execution_engine("torch", device=device)
    k, v, u = full_groupby_frame(rows, GROUPS, DISTINCT_VALUES, SEED)
    headline = pd.DataFrame({"k": k, "v": v})
    top_src = engine.persist(engine.to_df(headline))
    part_src = engine.persist(engine.to_df(headline))
    sample_src = engine.persist(engine.to_df(headline))
    vnull = np.random.default_rng(TAKE_SEED).random(rows) < TAKE_NULLS
    take_src = engine.persist(engine.to_df(pa.table({"k": k, "v": pa.array(v, mask=vnull)})))
    pair_src = engine.persist(engine.to_df(pd.DataFrame({"k": k, "u": u})))
    qrng = np.random.default_rng(Q_SEED)
    c1, c2 = q_channel(q_rows[0], qrng), q_channel(q_rows[1], qrng)
    q1 = engine.persist(engine.to_df(q_table(c1)))
    q2 = engine.persist(engine.to_df(q_table(c2)))
    nad, natable = na_frame(rows, NA_SEED)
    na_src = engine.persist(engine.to_df(natable))
    del natable
    floats = ["a", "b", "c", "d"]

    def timed(fn: Callable[[], Tuple[Any, Any]]) -> Callable[[], Tuple[float, Any, Any]]:
        def run_once() -> Tuple[float, Any, Any]:
            t = time.perf_counter()
            frame, out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return time.perf_counter() - t, frame, out
        return run_once

    def counted(frame: Any) -> Tuple[Any, Any]:
        return frame, frame.count()

    def taken(frame: Any) -> Tuple[Any, Any]:
        return frame, frame.as_pandas()

    def q_op(op: Callable[..., Any], distinct: bool) -> Callable[[], Tuple[Any, Any]]:
        return lambda: counted(op(q1, q2, distinct=distinct, engine=engine))

    run_for = {
        "take_top_n": timed(lambda: taken(ft.take(top_src, TAKE_N, presort="v desc",
                                                  partition="k", engine=engine))),
        "take_global": timed(lambda: taken(ft.take(take_src, GLOBAL_TAKE_N,
                                                   presort="k asc, v desc",
                                                   na_position="first", engine=engine))),
        "distinct_pairs": timed(lambda: counted(ft.distinct(pair_src, engine=engine))),
        "intersect_distinct": timed(q_op(ft.intersect, True)),
        "except_distinct": timed(q_op(ft.subtract, True)),
        "intersect_all": timed(q_op(ft.intersect, False)),
        "except_all": timed(q_op(ft.subtract, False)),
        "dropna_any": timed(lambda: counted(ft.dropna(na_src, subset=floats, engine=engine))),
        "dropna_all": timed(lambda: counted(ft.dropna(na_src, how="all", subset=floats,
                                                      engine=engine))),
        "dropna_thresh": timed(lambda: counted(ft.dropna(na_src, thresh=NA_THRESH,
                                                         subset=floats, engine=engine))),
        "fillna_scalar": timed(lambda: (ft.fillna(na_src, 0.0, subset=floats, engine=engine),
                                        None)),
        "fillna_dict": timed(lambda: (ft.fillna(na_src, {"a": 0.0, "b": 1.5, "c": -1.0,
                                                         "d": 2.0}, engine=engine), None)),
        "fillna_string": timed(lambda: (ft.fillna(na_src, {"s": "missing"}, engine=engine),
                                        None)),
        "sample_frac": timed(lambda: counted(ft.sample(sample_src, frac=SAMPLE_FRAC,
                                                       seed=SAMPLE_SEED, engine=engine))),
        "sample_n": timed(lambda: counted(ft.sample(sample_src, n=SAMPLE_N, seed=SAMPLE_SEED,
                                                    engine=engine))),
        "repartition_hash": timed(lambda: (ft.repartition(
            part_src, {"algo": "hash", "num": REPARTITION_NUM, "by": ["k"]}, engine=engine),
            None)),
        "repartition_rand": timed(lambda: (ft.repartition(sample_src, "rand", engine=engine),
                                           None)),
    }
    data = {"k": k, "v": v, "u": u, "vnull": vnull, "c1": c1, "c2": c2, "na": nad}
    return run_for, data, engine


def _keep(frame: Any) -> Any:
    """A selection's keep mask on the host."""
    return frame.blocks.validity().cpu().numpy()


def check_relational(label: str, frame: Any, out: Any, d: Dict[str, Any],
                     want: Dict[str, Any]) -> None:
    """One path's result against numpy (``want`` holds the oracles already
    computed)."""
    import numpy as np

    def fail(what: str) -> None:
        raise SystemExit(f"FAIL {label}: {what}")

    k, v = d["k"], d["v"]
    if label.startswith("take"):
        idx = want[label]
        null = d["vnull"][idx] if label == "take_global" else np.zeros(len(idx), dtype=bool)
        if not (np.array_equal(out["k"].to_numpy(), k[idx]) and np.array_equal(
                out["v"].to_numpy(na_value=np.nan), np.where(null, np.nan, v[idx]),
                equal_nan=True)):
            fail("rows differ from numpy's")
    elif label.startswith("repartition"):
        idx = want[label]
        got_k = frame.blocks.columns["k"].data[: len(k)].cpu().numpy()
        got_v = frame.blocks.columns["v"].data[: len(k)].cpu().numpy()
        if frame.count() != len(k) or not (np.array_equal(got_k, k[idx])
                                           and np.array_equal(got_v, v[idx])):
            fail("rows differ from numpy's order")
    elif label.startswith("sample"):
        want_n = int(round(len(k) * SAMPLE_FRAC))
        if label == "sample_n":
            want_n = min(SAMPLE_N, len(k))
        keep = _keep(frame)
        if out != want_n or int(keep.sum()) != want_n:
            fail(f"kept {int(keep.sum())} rows ({out} counted), expected {want_n}")
    elif label.startswith("fillna"):
        na = d["na"]
        fills = {"fillna_scalar": dict.fromkeys("abcd", 0.0),
                 "fillna_dict": {"a": 0.0, "b": 1.5, "c": -1.0, "d": 2.0}}.get(label, {})
        for name, fill in fills.items():
            x = na[name]
            exp = np.where(na[f"{name}_null"] | np.isnan(x), fill, x)
            col = frame.blocks.columns[name]
            if col.mask is not None or not np.array_equal(col.data.cpu().numpy(), exp):
                fail(f"column {name} differs from numpy's fill")
        if label == "fillna_string":
            col = frame.blocks.columns["s"]
            names = np.asarray(col.dictionary, dtype=object)
            exp = np.where(na["s_null"], "missing", np.array(
                [f"name{i:03d}" for i in range(NA_NAMES)], dtype=object)[na["s"]])
            if col.mask is not None or not (names[col.data.cpu().numpy()] == exp).all():
                fail("the filled strings differ from numpy's")
    else:  # a selection: distinct, the set operations, dropna
        keep = _keep(frame)
        if not np.array_equal(keep, want[label]) or out != int(want[label].sum()):
            fail(f"keeps {int(keep.sum())} rows ({out} counted), numpy {int(want[label].sum())}")


def relational_oracle(d: Dict[str, Any]) -> Dict[str, Any]:
    """Numpy's answers: the kept row indices of both takes, keep masks of
    distinct, the Q38/Q87 set operations and dropna, and the row orders of
    both repartitions."""
    import numpy as np

    k, v, u = d["k"], d["v"], d["u"]
    n = len(k)
    want: Dict[str, Any] = {}
    # top-n per group: (k, v desc, row), sorted over the candidates, the
    # rows at or above a threshold that leaves every group TAKE_N of them
    # (or all its rows)
    vbits = v.view(np.uint32).astype(np.int64)  # v >= 0: its bits order as v
    sizes = np.bincount(k, minlength=GROUPS)
    need = np.minimum(sizes, TAKE_N)
    thresh = np.partition(v, max(n - 64 * GROUPS * TAKE_N, 0))[max(n - 64 * GROUPS * TAKE_N, 0)]
    cand = np.nonzero(v >= thresh)[0]
    if (np.bincount(k[cand], minlength=GROUPS) < need).any():
        cand = np.arange(n)
    ck = k[cand].astype(np.int64)
    sub = np.argsort((ck << 32) | (0xFFFFFFFF - vbits[cand]), kind="stable")
    order, ks = cand[sub], ck[sub]
    rank = np.arange(len(order)) - np.searchsorted(ks, ks)
    want["take_top_n"] = np.sort(order[rank < TAKE_N])
    # the global take: k asc, nulls first, v desc, row; the n smallest keys
    gkey = (k.astype(np.int64) << 33) | np.where(d["vnull"], 0, (1 << 32) | (0xFFFFFFFF - vbits))
    kth = np.partition(gkey, GLOBAL_TAKE_N - 1)[GLOBAL_TAKE_N - 1]
    cand = np.nonzero(gkey <= kth)[0]
    want["take_global"] = np.sort(cand[np.argsort(gkey[cand], kind="stable")[:GLOBAL_TAKE_N]])
    first = np.full(GROUPS * DISTINCT_VALUES, n, dtype=np.int64)
    np.minimum.at(first, k.astype(np.int64) * DISTINCT_VALUES + u, np.arange(n))
    keep = np.zeros(n, dtype=bool)
    keep[first[first < n]] = True
    want["distinct_pairs"] = keep
    want.update(q_oracle(d["c1"], d["c2"]))
    na = d["na"]
    valid = sum((~na[f"{c}_null"]).astype(np.int32) for c in "abcd")
    want["dropna_any"], want["dropna_all"] = valid == 4, valid > 0
    want["dropna_thresh"] = valid >= NA_THRESH
    # (partition, key) fits 16 bits here: numpy's stable sort is a radix sort
    want["repartition_hash"] = np.argsort(
        ((k % REPARTITION_NUM) * GROUPS + k).astype(np.int16), kind="stable")
    want["repartition_rand"] = np.random.default_rng(42).permutation(n)
    return want


def relational_paths(device: Any, rows: int, warm_runs: int,
                     q_rows: Optional[Tuple[int, int]] = None) -> List[Dict[str, Any]]:
    """Every path of ``build_relational_paths`` at ``rows`` rows (the
    Q38/Q87 channels at ``q_rows``, default ``rows`` and ``rows // 2``),
    each held to numpy's answer (``relational_oracle``) and its launches to
    ``RELATIONAL_PATH_LAUNCHES`` on the card, with its cold and best warm
    seconds, peak memory and the device time of one warm run; both samples
    also keep the same rows for the same seed."""
    import numpy as np
    import torch

    q_rows = q_rows or (rows, rows // 2)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    run_for, d, engine = build_relational_paths(device, rows, q_rows)
    build_secs = time.perf_counter() - t
    t = time.perf_counter()
    want = relational_oracle(d)
    print(f"relational_paths: frames built and uploaded in {build_secs:.1f}s, numpy's "
          f"answers in {time.perf_counter() - t:.1f}s")
    out: List[Dict[str, Any]] = []
    for label, run_once in run_for.items():
        # the random repartition's host permutation takes seconds a run
        stats, frame, got = _path_stats(label, q_rows[0] if label[:3] in ("int", "exc") else rows,
                                        run_once, device,
                                        1 if label == "repartition_rand" else warm_runs)
        check_relational(label, frame, got, d, want)
        if label.startswith("sample"):
            again = run_once()[1]
            if not np.array_equal(_keep(again), _keep(frame)):
                raise SystemExit(f"FAIL {label}: another run of the same seed kept other rows")
        stats["device_ms"] = device_busy_ms(run_once, device)
        stats["kept_rows"] = got if isinstance(got, int) else (
            len(got) if got is not None else frame.count())
        out.append(stats)
        del frame, got
    del run_for, d, engine, want
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def device_busy_ms(run_once: Callable[[], Any], device: Any) -> Optional[float]:
    """The summed device time of the kernels and copies of one run, from
    ``torch.profiler``; None off the card, and where the trace holds no
    device event."""
    if device.type != "cuda":
        return None
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_once()
        torch.cuda.synchronize(device)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return busy if busy > 0 else None  # the trace lost the device's events: not measured


def relational_timing(device: Any, launches: Dict[str, int]) -> List[Dict[str, Any]]:
    """K11, K12, K13, K14 and the fillna program of K6 at 100M rows with
    CUDA events, each beside its twin, one PyTorch call where one computes
    the same function, and its bound: K11 at the top-n take's word (the
    segment and ``v`` desc, 16 bytes a row); K12 at ``sample(n=1M)``'s
    shape, at the top-n take's (10 of each of 1024 segments, the
    segment read from the first word) and at EXCEPT ALL's (Q87's shape:
    100M rows of side 1 against 50M, most rows kept); K13 at the (k, u)
    distinct's ~10M groups; K12's and K13's one call is ``index_fill_`` of
    the kept rows, timed also with the ``zero_()`` of the mask, the
    kernel's work (``row_select library calls``); K14 over four masks, how
    ``any`` (``torch.all`` of the stacked masks), and at the other
    ``null_count_shapes`` (a ``null_count_keep shape:`` line each, with
    its route); the fillna program over
    four float64 columns (no one call: ``where`` handles one column and
    no NaN). ``launches``: each kernel's launches on its path, K12's at
    the take's and EXCEPT ALL's shapes as ``rank_keep_take`` and
    ``rank_keep_except_all``."""
    import torch

    from fugue_tpu_torch.kernels.expr_program import expr_program_cuda
    from fugue_tpu_torch.kernels.factorize import presort_word_cuda
    from fugue_tpu_torch.kernels.reference import (
        PresortKey,
        expr_program_reference,
        first_row_mask_reference,
        null_count_keep_reference,
        presort_word_reference,
        rank_keep_reference,
    )
    from fugue_tpu_torch.kernels.row_select import (
        first_row_mask_cuda,
        null_count_keep_cuda,
        rank_keep_cuda,
    )
    from fugue_tpu_torch.torch_backend import relational

    n = ROWS
    gen = torch.Generator(device=device).manual_seed(SEED)
    seg = torch.randint(0, GROUPS, (n,), generator=gen, device=device, dtype=torch.int32)
    v = torch.rand((n,), generator=gen, device=device)
    entries = []

    def twin_err(got: Any, want: Any, label: str) -> float:
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise SystemExit(f"FAIL {label} timed: differs from its twin")
        return 0.0

    keys = [PresortKey(seg, kmin=0, bits=11), PresortKey(v, None, desc=True, nan_is_null=True)]
    err = twin_err([presort_word_cuda(keys)], [presort_word_reference(keys)], "presort_word")
    entries.append(_kernel_entry(
        "presort_word", "fugue_tpu/jax_backend/relational.py:1234", launches["presort_word"], err,
        time_cuda(lambda: presort_word_cuda(keys), 20),
        time_cuda(lambda: presort_word_reference(keys), 5), n * (4 + 4 + 8), 0, None))

    mask = torch.zeros((n,), dtype=torch.bool, device=device)
    yardsticks: Dict[str, Dict[str, float]] = {}

    def index_fill(label: str, rows: Any) -> float:
        """``index_fill_`` of ``rows`` as one call into a mask zeroed
        outside the timing, and as the kernel's work, ``zero_()`` and
        ``index_fill_``; returns the one call's time."""
        one = time_cuda(lambda: mask.index_fill_(0, rows, True), 20)
        yardsticks[label] = {"index_fill_ms": one, "zero_and_index_fill_ms": time_cuda(
            lambda: mask.zero_().index_fill_(0, rows, True), 20)}
        return one

    def rank_entry(name: str, launched: int, kw: Dict[str, Any], nbytes: int) -> None:
        """K12 at one shape: twin, time, bound from ``nbytes`` and the
        kept rows' ``index_fill_``."""
        want = rank_keep_reference(**kw)
        err = twin_err(rank_keep_cuda(**kw), want, name)
        # the kept rows as the caller holds them: in sorted order
        rows = kw["order"][want[0].index_select(0, kw["order"])]
        entries.append(_kernel_entry(
            name, "fugue_tpu/jax_backend/relational.py:2191", launched, err,
            time_cuda(lambda: rank_keep_cuda(**kw), 20),
            time_cuda(lambda: rank_keep_reference(**kw), 5), nbytes, 0,
            index_fill(name, rows), source="row_select.cu"))

    # sample(n=1M): the first k positions of a permutation; the kept
    # positions' order read (8 B), the mask written (1 B a row)
    order = torch.sort(torch.randperm(n, generator=gen, device=device, dtype=torch.int32)).indices
    k = min(SAMPLE_N, n)
    rank_entry("rank_keep", launches["rank_keep"],
               dict(order=order, limit=torch.full((), k, dtype=torch.int64, device=device)),
               k * 8 + n)
    del order
    # the top-n take: the first TAKE_N positions of each of GROUPS
    # segments read from the first word (order and word, 16 B a visited
    # position), each segment's start, the mask written
    take = sorted_segment_frame(device, n, GROUPS, SEED, "word64", rows="full")
    take_limit = torch.full((), TAKE_N, dtype=torch.int64, device=device)
    rank_entry("rank_keep[top-n take]", launches["rank_keep_take"],
               dict(**take, limit=take_limit), GROUPS * TAKE_N * 16 + GROUPS * 8 + n)
    del take
    # EXCEPT ALL at Q87's shape: side 1's segment ids over the distinct
    # rows of both channels, side 2's counts the limits; every position's
    # id read (4 B), the start and limit of each segment side 1 holds
    # (12 B), each kept position's order (8 B), the mask written
    space = Q_NAMES[0] * Q_NAMES[1] * Q_DAYS
    codes = torch.randint(0, space, (n + n // 2,), generator=gen, device=device)
    uniq, inv = torch.unique(codes, return_inverse=True)
    del codes
    num = int(uniq.shape[0])
    del uniq
    seg1, seg2 = inv[:n].to(torch.int32), inv[n:].to(torch.int32)
    del inv
    c1 = torch.bincount(seg1.long(), minlength=num).to(torch.int32)
    c2 = torch.bincount(seg2.long(), minlength=num).to(torch.int32)
    del seg2
    srt = torch.sort(seg1, stable=True)
    del seg1
    ekw = dict(order=srt.indices, seg=srt.values, starts=torch.cumsum(c1, 0) - c1, limits=c2,
               mode="ge")
    kept = int(rank_keep_reference(**ekw)[1])
    rank_entry("rank_keep[except all]", launches["rank_keep_except_all"], ekw,
               n * 4 + int((c1 > 0).sum()) * 12 + kept * 8 + n)
    print("rank_keep except all shape: " + json.dumps({"rows": n, "segments": num,
                                                        "kept": kept}))
    del ekw, srt, c1, c2
    torch.cuda.empty_cache()

    # K13 at the (k, u) distinct's ~10M groups: the first rows read (4 B
    # a group), the mask written
    num = GROUPS * DISTINCT_VALUES
    first_long = torch.randperm(n, generator=gen, device=device)[:num]
    first = first_long.to(torch.int32)
    err = twin_err(first_row_mask_cuda(first, n), first_row_mask_reference(first, n),
                   "first_row_mask")
    entries.append(_kernel_entry(
        "first_row_mask", "fugue_tpu/jax_backend/execution_engine.py:1854",
        launches["first_row_mask"], err, time_cuda(lambda: first_row_mask_cuda(first, n), 20),
        time_cuda(lambda: first_row_mask_reference(first, n), 5), num * 4 + n, 0,
        index_fill("first_row_mask", first_long), source="row_select.cu"))
    del first, first_long, mask
    print("row_select library calls: " + json.dumps(yardsticks))

    for label, nkw, library, nbytes in null_count_shapes(device):
        err = twin_err(null_count_keep_cuda(**nkw), null_count_keep_reference(**nkw),
                       f"null_count_keep {label}")
        path = getattr(null_count_keep_cuda, "last_path", None)
        first = label == "four masks, prefix, any"
        if first:
            masks = nkw["masks"]  # the fillna program's masks below
        entry = _kernel_entry(
            "null_count_keep", "fugue_tpu/jax_backend/execution_engine.py:1906",
            launches["null_count_keep"], err,
            time_cuda(lambda: null_count_keep_cuda(**nkw), 20),  # noqa: B023
            time_cuda(lambda: null_count_keep_reference(**nkw), 5 if first else 1),  # noqa: B023
            nbytes, 0, time_cuda(library, 20 if first else 5), source="row_select.cu")
        if first:
            entries.append(entry)
            print(f"null_count_keep route at four masks: {path}")
        else:
            print("null_count_keep shape: " + json.dumps({
                "case": label, "path": path,
                **{k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}}))
        del nkw, library
    torch.cuda.empty_cache()

    cols = [torch.where(torch.rand((n,), generator=gen, device=device) < NA_NANS, float("nan"),
                        torch.randn((n,), generator=gen, device=device, dtype=torch.float64))
            for _ in range(4)]
    prog = relational.fill_program([(f"c{j}", torch.float64) for j in range(4)],
                                    [0.0, 1.5, -1.0, 2.0])
    inputs = list(zip(cols, masks))
    got = expr_program_cuda(prog, inputs, n, device=device)
    want = expr_program_reference(prog, inputs, n, device=device)
    err = twin_err([g for g, _ in got], [w for w, _ in want], "fillna program")
    del got, want
    entries.append(_kernel_entry(
        "expr_program[fillna 4 float64]", "fugue_tpu/jax_backend/relational.py:1182",
        launches["expr_program_fillna"], err,
        time_cuda(lambda: expr_program_cuda(prog, inputs, n, device=device), 20),
        time_cuda(lambda: expr_program_reference(prog, inputs, n, device=device), 5),
        n * 4 * (8 + 1 + 8), 0, None, source="expr_codegen.py"))
    for e in entries:
        print("relational timed: " + json.dumps(e))
    return entries


# ---- the SQL phase -------------------------------------------------------

SQL_RANK_LIMIT = 100  # TPC-DS q67's WHERE rk <= 100
SQL_TOP, SQL_OFFSET = 100, 1_000_000  # ORDER BY v DESC, k LIMIT 100 [OFFSET 1M]
SQL_RANGE_DAYS = 10  # RANGE BETWEEN 10 PRECEDING AND CURRENT ROW over the day number
SQL_MOVING_ROWS = 7  # ROWS BETWEEN 6 PRECEDING AND CURRENT ROW
# TPC-H Q16 at scale factor 100: partsupp's 80M rows over supplier's 1M
# keys; the complaint filter keeps about 0.05 % of the suppliers
NOT_IN_ROWS, NOT_IN_SUPPLIERS, NOT_IN_COMPLAINTS, NOT_IN_SEED = 80_000_000, 1_000_000, 500, 16
SQL_STATEMENTS = {
    "q67_rank_top100": (
        "SELECT k, v, rk FROM (SELECT k, v, RANK() OVER (PARTITION BY k ORDER BY v DESC) AS rk"
        f" FROM {{t}}) AS x WHERE rk <= {SQL_RANK_LIMIT}"),
    "q51_running_sum": (
        "SELECT k, d, v, SUM(v) OVER (PARTITION BY k ORDER BY d ROWS BETWEEN UNBOUNDED"
        " PRECEDING AND CURRENT ROW) AS cume FROM {t}"),
    "q47_avg_partition": "SELECT k, v, AVG(v) OVER (PARTITION BY k) AS av FROM {t}",
    "moving_7": (
        "SELECT k, d, v, AVG(v) OVER (PARTITION BY k ORDER BY d ROWS BETWEEN 6 PRECEDING AND"
        " CURRENT ROW) AS ma, MIN(v) OVER (PARTITION BY k ORDER BY d ROWS BETWEEN 6 PRECEDING"
        " AND CURRENT ROW) AS mn, MAX(v) OVER (PARTITION BY k ORDER BY d ROWS BETWEEN 6"
        " PRECEDING AND CURRENT ROW) AS mx FROM {t}"),
    "lag_range10": (
        "SELECT k, di, v, LAG(v, 1, 0) OVER (PARTITION BY k ORDER BY di) AS lg, SUM(v) OVER"
        " (PARTITION BY k ORDER BY di RANGE BETWEEN 10 PRECEDING AND CURRENT ROW) AS r10"
        " FROM {t}"),
    "order_limit": f"SELECT k, v FROM {{t}} ORDER BY v DESC, k LIMIT {SQL_TOP}",
    "order_limit_offset": (
        f"SELECT k, v FROM {{t}} ORDER BY v DESC, k LIMIT {SQL_TOP} OFFSET {SQL_OFFSET}"),
    "q16_not_in": (
        "SELECT ps_partkey, ps_suppkey FROM {ps} WHERE ps_suppkey NOT IN"
        " (SELECT s_suppkey FROM {s})"),
    "q16_not_in_null": (
        "SELECT ps_partkey, ps_suppkey FROM {ps} WHERE ps_suppkey NOT IN"
        " (SELECT s_suppkey FROM {sn})"),
}
# each statement's launches in one run: the partition key's K1 ran once at
# upload and is cached on the frame; NOT IN factorizes both sides' keys
# stacked, a new frame each run
SQL_PATH_LAUNCHES = {
    "q67_rank_top100": dict(presort_word=1, window_rank=1, expr_program=1,
                            expr_program_filter=1),
    "q51_running_sum": dict(presort_word=1, window_frame=1),
    "q47_avg_partition": dict(binned_sums=1, gather_rows=1),
    "moving_7": dict(presort_word=1, window_frame=3),
    "lag_range10": dict(presort_word=1, window_frame=2),
    "order_limit": dict(presort_word=1, gather_rows=1),
    "order_limit_offset": dict(presort_word=1, gather_rows=1),
    "q16_not_in": dict(bin_factorize=1, join_build=1, join_probe=1),
    "q16_not_in_null": dict(bin_factorize=1, join_build=1, join_probe=1),
}


def sql_frames(rows: int, not_in_rows: int) -> Dict[str, Any]:
    """The SQL phase's frames as arrow tables and their columns: the
    headline frame (``k`` int32 over 1024 groups, ``v`` float32, seed 42,
    ``bench.py:538-545``) with a day over 1,096 days from the date path's
    seed (``d`` date32, ``di`` its int32 day number); and TPC-H Q16's
    partsupp (``ps_partkey`` four suppliers a part, ``ps_suppkey`` uniform
    over 1M suppliers) with the complaint filter's suppliers, and the same
    with a null."""
    import numpy as np
    import pyarrow as pa

    rng = np.random.default_rng(SEED)
    k = rng.integers(0, GROUPS, rows).astype(np.int32)
    v = rng.random(rows).astype(np.float32)
    di = np.random.default_rng(DATE_SEED).integers(0, DATE_DAYS, rows).astype(np.int32)
    t = pa.table({"k": k, "v": v, "d": pa.array(di + DATE_EPOCH_DAY, pa.int32()).cast(
        pa.date32()), "di": di})
    rng = np.random.default_rng(NOT_IN_SEED)
    supp = rng.integers(1, NOT_IN_SUPPLIERS + 1, not_in_rows).astype(np.int64)
    part = np.arange(not_in_rows, dtype=np.int64) // 4 + 1
    bad = np.sort(rng.choice(NOT_IN_SUPPLIERS, NOT_IN_COMPLAINTS, replace=False) + 1)
    ps = pa.table({"ps_partkey": part, "ps_suppkey": supp})
    s = pa.table({"s_suppkey": bad.astype(np.int64)})
    sn = pa.table({"s_suppkey": pa.array(list(bad[:-1]) + [None], pa.int64())})
    return dict(t=t, ps=ps, s=s, sn=sn, k=k, v=v, di=di, supp=supp, part=part, bad=bad)


def _group_runs(key_sorted: Any, groups: int) -> Any:
    """The first sorted position of each row's group, for rows sorted by
    a group key in ``[0, groups)``."""
    import numpy as np

    counts = np.bincount(key_sorted, minlength=groups)
    return (np.cumsum(counts) - counts)[key_sorted]


def _stable_order(key: Any) -> Any:
    """``numpy.argsort(key, kind="stable")`` of non-negative keys below
    2^32 as two passes of 16-bit digits, least significant first: each
    pass a stable radix sort in numpy."""
    import numpy as np

    lo = (key & 0xFFFF).astype(np.uint16)
    order = np.argsort(lo, kind="stable")
    hi = (key[order] >> 16).astype(np.uint16)
    return order[np.argsort(hi, kind="stable")]


def sql_oracle(d: Dict[str, Any]) -> Dict[str, Any]:
    """numpy's answers to ``SQL_STATEMENTS`` (float64 sums per partition in
    window order, ties in row order): per statement the expected columns
    (in row order, or the selected rows), and the float sums' per-row
    absolute tolerances."""
    import numpy as np

    k, v, di = d["k"], d["v"], d["di"]
    n = len(k)
    pos = np.arange(n)
    x = v.astype(np.float64)
    want: Dict[str, Any] = {}
    # q67: a row ranks at most 100 in its group where at most 99 of the
    # group's values are above it: the candidates at or above the group's
    # 100th value, ranked among themselves
    by_k = _stable_order(k.astype(np.int64))
    bounds = np.cumsum(np.bincount(k, minlength=GROUPS))
    cut = np.array([np.partition(g, max(len(g) - SQL_RANK_LIMIT, 0))[max(len(g) - SQL_RANK_LIMIT, 0)]
                    if len(g) else np.inf for g in np.split(v[by_k], bounds[:-1])])
    cand = np.nonzero(v >= cut[k])[0]
    srt = cand[np.lexsort((cand, -v[cand].astype(np.float64), k[cand]))]
    ks, vs = k[srt], v[srt]
    m = len(srt)
    head = np.ones(m, dtype=bool)
    head[1:] = (ks[1:] != ks[:-1]) | (vs[1:] != vs[:-1])
    first = np.ones(m, dtype=bool)
    first[1:] = ks[1:] != ks[:-1]
    at = np.arange(m)
    rank_sorted = (np.maximum.accumulate(np.where(head, at, 0))
                   - np.maximum.accumulate(np.where(first, at, 0)) + 1)
    keep = rank_sorted <= SQL_RANK_LIMIT
    rows, ranks = srt[keep], rank_sorted[keep]
    back = np.argsort(rows)
    rows, ranks = rows[back], ranks[back]
    want["q67_rank_top100"] = dict(k=k[rows], v=v[rows], rk=ranks)
    del by_k, cand, srt, ks, vs
    # the (k, day) order of the running, moving, lag and RANGE windows
    order = _stable_order(k.astype(np.int64) * DATE_DAYS + di)
    ks, xs = k[order], x[order]
    start = _group_runs(ks, GROUPS)
    bounds = np.cumsum(np.bincount(ks, minlength=GROUPS))
    running = np.concatenate([np.cumsum(p) for p in np.split(xs, bounds[:-1])])
    peak = np.zeros(GROUPS)
    np.maximum.at(peak, ks, np.abs(running))

    def to_rows(sorted_vals: Any) -> Any:
        out = np.empty_like(sorted_vals)
        out[order] = sorted_vals
        return out

    want["q51_running_sum"] = dict(k=k, d=di, v=v, cume=to_rows(running),
                                   cume_atol=FRAME_SUM_ATOL * peak[k])
    sums, counts = np.bincount(k, weights=x, minlength=GROUPS), np.bincount(k, minlength=GROUPS)
    want["q47_avg_partition"] = dict(k=k, v=v, av=(sums / counts)[k])
    local = pos - start  # each sorted row's place in its partition
    total, at = np.zeros(n), np.zeros(n)
    lo, hi = np.full(n, np.inf), np.full(n, -np.inf)
    for off in range(SQL_MOVING_ROWS - 1, -1, -1):  # the frame's rows in order, as K16's loop
        at[off:] = xs[:n - off]
        inside = local >= off
        np.add(total, at, out=total, where=inside)
        np.minimum(lo, at, out=lo, where=inside)
        np.maximum(hi, at, out=hi, where=inside)
    count = np.minimum(local + 1, SQL_MOVING_ROWS)
    want["moving_7"] = dict(k=k, d=di, v=v, ma=to_rows(total / count),
                            mn=to_rows(lo).astype(np.float32), mx=to_rows(hi).astype(np.float32))
    del total, count, lo, hi, at, inside
    vs = v[order]
    lag = np.zeros(n, dtype=np.float32)
    lag[1:] = np.where(local[1:] >= 1, vs[:-1], np.float32(0))
    table = np.bincount(k.astype(np.int64) * DATE_DAYS + di, weights=x,
                        minlength=GROUPS * DATE_DAYS).reshape(GROUPS, DATE_DAYS)
    cum = np.cumsum(table, axis=1)
    before = np.where(di > SQL_RANGE_DAYS, cum[k, np.maximum(di - SQL_RANGE_DAYS - 1, 0)], 0.0)
    want["lag_range10"] = dict(k=k, di=di, v=v, lg=to_rows(lag), r10=cum[k, di] - before,
                               r10_atol=FRAME_SUM_ATOL * np.abs(cum).max(axis=1)[k])
    del order, ks, xs, vs, start, running
    # ORDER BY v DESC, k [LIMIT/OFFSET]: the candidates above the cut, sorted
    m = min(SQL_OFFSET + SQL_TOP, n)
    cut = np.partition(v, n - m)[n - m]
    cand = np.nonzero(v >= cut)[0]
    top = cand[np.lexsort((cand, k[cand], -v[cand].astype(np.float64)))]
    for label, lo_ in (("order_limit", 0), ("order_limit_offset", SQL_OFFSET)):
        sel = top[lo_:lo_ + SQL_TOP]
        want[label] = dict(k=k[sel], v=v[sel])
    listed = np.zeros(NOT_IN_SUPPLIERS + 1, dtype=bool)
    listed[d["bad"]] = True
    keep = ~listed[d["supp"]]
    want["q16_not_in"] = dict(ps_partkey=d["part"][keep], ps_suppkey=d["supp"][keep])
    want["q16_not_in_null"] = dict(ps_partkey=d["part"][:0], ps_suppkey=d["supp"][:0])
    return want


def check_sql(label: str, table: Any, want: Dict[str, Any]) -> None:
    """A statement's arrow result against numpy's: every column exactly
    but the float64 frame sums (within ``FRAME_SUM_RTOL`` and their
    per-row atol) and the float32-accumulated average (``MAIN_PATH_RTOL``)."""
    import numpy as np

    cols = [c for c in want if not c.endswith("_atol")]
    if table.column_names != cols:
        raise SystemExit(f"FAIL {label}: columns {table.column_names}, expected {cols}")
    for name in cols:
        col = table.column(name).combine_chunks()
        if col.null_count:
            raise SystemExit(f"FAIL {label}: {name} has {col.null_count} nulls")
        got = col.cast("int32").to_numpy() if name == "d" else col.to_numpy()
        w = want[name]
        if name == "d":
            w = w + DATE_EPOCH_DAY
        if len(got) != len(w):
            raise SystemExit(f"FAIL {label}: {len(got)} rows of {name}, expected {len(w)}")
        if name + "_atol" in want:
            bad = np.abs(got - w) > FRAME_SUM_RTOL * np.abs(w) + want[name + "_atol"]
        elif name == "av":
            bad = np.abs(got - w) > MAIN_PATH_RTOL * np.abs(w)
        else:
            bad = got != w
        if bad.any():
            raise SystemExit(f"FAIL {label}: {int(bad.sum())} values of {name} differ")


def build_sql_paths(device: Any, rows: int, not_in_rows: int
                    ) -> Tuple[Dict[str, Callable[[], Tuple[float, Any, Any]]], Dict[str, Any]]:
    """The SQL phase's frames uploaded once (the headline frame's key
    factorized once, cached on it as a transform's is), and per statement
    a ``run_once()``: ``raw_sql`` over them through the port's entry point,
    its result left as a frame on the card with its row count read
    (``count()``), then a synchronize; returns ``(seconds, frame,
    None)``."""
    import torch

    import fugue_tpu_torch as ft

    from fugue_tpu_torch.torch_backend import groupby

    d = sql_frames(rows, not_in_rows)
    engine = ft.make_execution_engine(device=device)
    frames = {name: engine.persist(engine.to_df(d[name])) for name in ("t", "ps", "s", "sn")}
    groupby.factorize_keys(frames["t"].blocks, ["k"])  # the partition key, as an upload's

    def runner(statement: str) -> Callable[[], Tuple[float, Any, Any]]:
        head, _, tail = statement.partition("{")
        name, _, rest = tail.partition("}")
        parts: List[Any] = [head, frames[name]]
        while "{" in rest:
            mid, _, tail = rest.partition("{")
            name, _, rest = tail.partition("}")
            parts += [mid, frames[name]]
        parts.append(rest)

        def run_once() -> Tuple[float, Any, Any]:
            t = time.perf_counter()
            out = ft.raw_sql(*parts, engine=engine, as_fugue=True)
            out.count()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return time.perf_counter() - t, out, None

        return run_once

    return {label: runner(stmt) for label, stmt in SQL_STATEMENTS.items()}, d


def sql_paths(device: Any, rows: int, not_in_rows: int, warm_runs: int) -> List[Dict[str, Any]]:
    """Every statement of ``SQL_STATEMENTS`` through ``raw_sql`` on the
    card at ``rows`` rows (Q16's NOT IN at ``not_in_rows``): cold and
    best-of-``warm_runs`` warm seconds, each kernel's launches (held to
    ``SQL_PATH_LAUNCHES``), the synchronizing operations of one more run,
    peak device memory, the result's rows, and the device time of one
    warm run; each result held against numpy's (``sql_oracle``)."""
    import torch

    t = time.perf_counter()
    run_for, d = build_sql_paths(device, rows, not_in_rows)
    build_secs = time.perf_counter() - t
    t = time.perf_counter()
    want = sql_oracle(d)
    print(f"sql_paths: frames built and uploaded in {build_secs:.1f}s, numpy's answers in "
          f"{time.perf_counter() - t:.1f}s")
    out: List[Dict[str, Any]] = []
    for label, run_once in run_for.items():
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        zero_launches()
        cold_secs, frame, _ = run_once()
        cold = launch_counts()
        zero_launches()
        warm = [run_once()[0] for _ in range(warm_runs)]
        warm_launches = launch_counts()
        want_launches = dict.fromkeys(cold, 0)
        if device.type == "cuda":  # on the CPU every kernel runs as its twin
            want_launches.update(SQL_PATH_LAUNCHES[label])
        warm_want = {kk: vv * warm_runs for kk, vv in want_launches.items()}
        if cold != want_launches or warm_launches != warm_want:
            raise SystemExit(f"FAIL {label}: launched {cold} (cold), {warm_launches} (warm), "
                             f"expected {want_launches} a run")
        check_sql(label, frame.as_arrow(), want[label])
        stats = {
            "case": label, "rows": not_in_rows if label.startswith("q16") else rows,
            "result_rows": frame.count(), "cold_secs": cold_secs, "warm_secs": warm,
            "best_warm_secs": min(warm), "launches": {kk: vv for kk, vv in cold.items() if vv},
            "syncs_in_one_run": _syncs_in(run_once),
            "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else None),
            "device_ms": device_busy_ms(run_once, device),
        }
        print(f"sql_path {label}: " + json.dumps(stats))
        out.append(stats)
        del frame
    del run_for, d, want
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def window_timing(device: Any, launches: Dict[str, int]) -> List[Dict[str, Any]]:
    """K15, K16 and K8's NOT IN mode at the SQL phase's shapes with CUDA
    events, each beside its twin, one PyTorch call where one is near, and
    its bound (bytes): K15 ranking 100M rows by (``k``, ``v`` desc), an
    int64 word (order, word and output read or written once: 24 B a row;
    no library call ranks); K16's running float64 sum by (``k``, day), an
    int32 word (order, word, float64 argument, float64 output and mask:
    29 B a row; ``torch.cumsum`` of the argument); K8's NOT IN mode over
    Q16's 80M probe rows against 1M segments (segment id and keep flag, 5
    B a row, and the table; ``index_select`` of the table). Printed
    beside them: K16's loop, span and table routes
    and lag, ORDER BY's ``device_sort`` against ``torch.sort`` of the
    column alone, and ``gather_indices`` against ``index_select``."""
    import torch

    from fugue_tpu_torch.kernels.join import join_build_cuda, join_probe_cuda
    from fugue_tpu_torch.kernels.reference import (
        PresortKey,
        WindowFrame,
        frame_route,
        join_build_reference,
        join_probe_reference,
        window_frame_reference,
        window_rank_reference,
    )
    from fugue_tpu_torch.kernels.window import window_frame_cuda, window_rank_cuda
    from fugue_tpu_torch.torch_backend import relational
    from fugue_tpu_torch.torch_backend.blocks import TorchBlocks, TorchColumn, gather_indices
    import pyarrow as pa

    n = ROWS
    gen = torch.Generator(device=device).manual_seed(SEED)
    k = torch.randint(0, GROUPS, (n,), generator=gen, device=device, dtype=torch.int32)
    v = torch.rand((n,), generator=gen, device=device)
    di = torch.randint(0, DATE_DAYS, (n,), generator=gen, device=device, dtype=torch.int32)
    seg = PresortKey(k, kmin=0, bits=GROUPS.bit_length())
    by_v = relational.presort_sorted(
        [seg, PresortKey(v, None, desc=True, nan_is_null=True)], n, device, nrows=n)
    by_d = relational.presort_sorted([seg, PresortKey(di, kmin=0, bits=11)], n, device,
                                     nrows=n)
    entries = []
    got, want = window_rank_cuda(by_v, "rank"), window_rank_reference(by_v, "rank")
    _same("window_rank timed", got, want)
    entries.append(_kernel_entry(
        "window_rank", "fugue_tpu/jax_backend/relational.py:1542", launches["window_rank"], 0.0,
        time_cuda(lambda: window_rank_cuda(by_v, "rank"), 10),
        time_cuda(lambda: window_rank_reference(by_v, "rank"), 1, warm=0), n * (8 + 8 + 8), 0, None,
        source="window.cu"))
    x = v.to(torch.float64)
    running = WindowFrame("sum", 0, "running", ("up", 0), ("c", 0), x, route="prefix")
    got, want = window_frame_cuda(by_d, running), window_frame_reference(by_d, running)
    _same("window_frame timed mask", got[1], want[1])
    err = check_frame_sums("window_frame timed", got[0], want[0],
                           frame_sum_atol(by_d, x, None))
    del got, want
    entries.append(_kernel_entry(
        "window_frame", "fugue_tpu/jax_backend/relational.py:1762", launches["window_frame"],
        err, time_cuda(lambda: window_frame_cuda(by_d, running), 10),
        time_cuda(lambda: window_frame_reference(by_d, running), 1, warm=0),
        n * (8 + 4 + 8 + 8 + 1), 0,
        time_cuda(lambda: torch.cumsum(x, 0), 10), source="window.cu"))
    # the same work in three PyTorch calls: the argument gathered to sorted
    # order, its (unsegmented) running sum, the sums scattered back
    summed = torch.empty_like(x)
    print("window timed: " + json.dumps({
        "name": "window_frame[running sum] equal work",
        "index_select_cumsum_scatter_ms": time_cuda(lambda: summed.scatter_(
            0, by_d.order, torch.cumsum(x.index_select(0, by_d.order), 0)), 10),
        "index_select_ms": time_cuda(lambda: x.index_select(0, by_d.order), 10),
        "scatter_ms": time_cuda(lambda: summed.scatter_(0, by_d.order, x), 10)}))
    del summed
    for label, func, unit, lo, hi, extra in (
            ("moving avg 7 rows", "avg", "rows", ("p", 6), ("c", 0), {}),
            ("min 7 rows", "min", "rows", ("p", 6), ("c", 0), {}),
            ("range 10 sum", "sum", "range", ("p", SQL_RANGE_DAYS), ("c", 0),
             dict(key=di.to(torch.float64))),
            ("lag 1 default 0", "lag", "running", ("up", 0), ("c", 0), dict(param=1, default=0)),
            ("groups 1 max (table)", "max", "groups", ("p", 1), ("f", 1), {})):
        fr = WindowFrame(func, extra.get("param", 0), unit, lo, hi, x,
                         default=extra.get("default"), key=extra.get("key"),
                         route=frame_route(func, unit, lo, hi))
        entry = {"name": f"window_frame[{label}]", "route": fr.route,
                 "ms": time_cuda(lambda: window_frame_cuda(by_d, fr), 5),
                 "levels": window_frame_cuda.last_levels}
        if func == "lag":
            idx = torch.arange(n, device=device) - 1
            entry["index_select_ms"] = time_cuda(lambda: x.index_select(0, idx.clamp(min=0)), 10)
        print("window timed: " + json.dumps(entry))
    del by_v, by_d

    pn = NOT_IN_ROWS
    probe = torch.randint(0, NOT_IN_SUPPLIERS, (pn,), generator=gen, device=device,
                          dtype=torch.int32)
    build = torch.randperm(NOT_IN_SUPPLIERS, generator=gen, device=device)[:NOT_IN_COMPLAINTS]
    build = build.to(torch.int32)
    table, stats = join_build_reference(build, NOT_IN_SUPPLIERS, nrows=NOT_IN_COMPLAINTS,
                                        side_counts=True)
    kw = dict(nrows=pn, stats=stats)
    got = join_probe_cuda(probe, table, "not_in", **kw)
    print("window timed: " + json.dumps({"name": "join_probe[not_in] place",
                                          "path": join_probe_cuda.last_path}))
    want = join_probe_reference(probe, table, "not_in", **kw)
    _same("join_probe not_in timed", got.keep, want.keep)
    entries.append(_kernel_entry(
        "join_probe[not_in]", "fugue_tpu/jax_backend/relational.py:368",
        launches["join_probe_not_in"], 0.0,
        time_cuda(lambda: join_probe_cuda(probe, table, "not_in", **kw), 20),
        time_cuda(lambda: join_probe_reference(probe, table, "not_in", **kw), 5),
        pn * 5 + NOT_IN_SUPPLIERS * 4, 0,
        time_cuda(lambda: table.index_select(0, probe), 20), source="join.cu"))
    print("window timed: " + json.dumps({
        "name": "join_build[side counts]",
        "ms": time_cuda(lambda: join_build_cuda(build, NOT_IN_SUPPLIERS,
                                                nrows=NOT_IN_COMPLAINTS, side_counts=True),
                        20)}))
    del probe, got, want

    blocks = TorchBlocks(n, {"k": TorchColumn(pa.int32(), k, stats=(0, GROUPS - 1)),
                             "v": TorchColumn(pa.float32(), v)}, device)
    sorts = [("v", False, None), ("k", True, None)]
    print("window timed: " + json.dumps({
        "name": "device_sort[ORDER BY v DESC, k LIMIT 100]",
        "ms": time_cuda(lambda: relational.device_sort(blocks, sorts, limit=SQL_TOP), 5),
        "torch_sort_ms": time_cuda(lambda: torch.sort(v, descending=True, stable=True), 5),
        "bound_ms": n * 8 / HBM_BYTES_PER_S * 1e3}))
    perm = torch.randperm(n, generator=gen, device=device)
    from fugue_tpu_torch.kernels.gather import gather_rows_cuda

    print("window timed: " + json.dumps({
        "name": "gather_indices[k, v by 100M permuted rows]",
        "ms": time_cuda(lambda: gather_indices(blocks, perm, scattered=True), 5),
        "route": gather_rows_cuda.last_route,
        "direct_ms": time_cuda(lambda: gather_indices(blocks, perm), 5),
        "index_select_one_column_ms": time_cuda(lambda: v.index_select(0, perm), 10),
        "bound_ms": n * (8 + 4 + 4 + 4) / HBM_BYTES_PER_S * 1e3}))
    for e in entries:
        print("window timed: " + json.dumps(e))
    return entries


# ---- zip/co-map and streaming aggregation ---------------------------------

CONFIG4_GROUPS, CONFIG4_PER, CONFIG4_SEED = 2_000, 50, 3  # bench.py:930-945
CONFIG4_BIG_GROUPS = 2_000_000  # 100M rows of a, 2M of b
ZIP_ROWS = (10_000_000, 5_000_000)  # the outer zips' members
ZIP_KEYS = 2_000_000  # a's keys over [0, ZIP_KEYS), b's over [ZIP_KEYS / 2, 3 ZIP_KEYS / 2)
ZIP_CROSS_ROWS = (10_000, 1_000)
ZIP_SEED = 23
STREAM_CHUNKS, STREAM_CHUNK_ROWS = 20, 10_000_000
# warm runs of the 200M-row stream (about 8 s each on an H100's host since
# its chunks go up pinned): one, as the random repartition, to keep the whole
# script inside its time
STREAM_WARM_RUNS = 1
STREAM_STORES = 1_000  # store int32 over [0, 1000)
STREAM_ITEMS = (800, 1_000)  # item int64 over [0, 800), from a quarter of the chunks [0, 1000)
STREAM_NULLS = 0.02
STREAM_SEED = 29
FOLD_RTOL = 1e-9  # float64 sums, kernel against twin: atomics add in another order
COMAP_RTOL = 1e-9  # float64 sums against pandas

# K10 at the export of the co-map's masked output
_ZIP_LAUNCHES = dict(bin_factorize=1, comap_presence=1, comap_rows=1, gather_rows=1)
COMAP_PATH_LAUNCHES = {
    "config4_inner": _ZIP_LAUNCHES,
    "config4_inner_100m": _ZIP_LAUNCHES,
    "zip_left_outer": _ZIP_LAUNCHES,
    "zip_right_outer": _ZIP_LAUNCHES,
    "zip_full_outer": _ZIP_LAUNCHES,
    "zip_three_inner": _ZIP_LAUNCHES,
    "zip_string_key": dict(_ZIP_LAUNCHES, expr_program=1),  # the harmonize re-coding
    "zip_row_aligned": _ZIP_LAUNCHES,
    "zip_cross": dict(comap_rows=1, gather_rows=1),
}


def comap_layout(device: Any, sizes: List[int], nrows: List[int]) -> Tuple[Any, Any]:
    """``offsets`` and ``nrows`` (int64) of members of ``sizes`` rows."""
    import numpy as np
    import torch

    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int64,
                           device=device)
    return offsets, torch.tensor(nrows, dtype=torch.int64, device=device)


def comap_cases(device: Any, n: int, seed: int, big_segments: int, full: bool
                ) -> List[Tuple[str, Dict[str, Any]]]:
    """K17's and K18's cases at ``n`` stacked rows: ``(label, keyword
    arguments)``. 1, 2, 3 and 33 members (two presence words); every zip
    type; a prefix layout (member 0 short by a few rows, adjacent rows of
    one segment, as a co-partitioned frame has them) and a masked one
    (70 % real, random segments); member 1 with no real row; 5 % sentinel
    ids; 1 segment and ``big_segments``. Where not ``full``, 2 and 33
    members and ``big_segments`` only. Then K18's tile edges
    (``comap_tile_cases``)."""
    import torch

    from fugue_tpu_torch.kernels.reference import COMAP_HOWS

    gen = torch.Generator(device=device).manual_seed(seed)
    cases = []
    for members in (1, 2, 3, 33) if full else (2, 33):
        if members > n:
            continue
        base = n // members
        sizes = [base] * (members - 1) + [n - base * (members - 1)]
        for layout in ("prefix", "masked"):
            for num in (1, big_segments) if full else (big_segments,):
                if layout == "prefix":
                    per = max(n // num, 1)
                    seg = (torch.arange(n, device=device) // per).clamp(max=num - 1)
                    valid = None
                    nrows = [max(s - (m % 3), 0) for m, s in enumerate(sizes)]
                else:
                    seg = torch.randint(0, num, (n,), generator=gen, device=device)
                    valid = torch.rand((n,), generator=gen, device=device) < 0.7
                    nrows = list(sizes)
                seg = seg.to(torch.int32)
                seg[torch.rand((n,), generator=gen, device=device) < 0.05] = num  # sentinels
                if members > 1:  # member 1 without a real row
                    if valid is None:
                        nrows[1] = 0
                    else:
                        valid[sizes[0]: sizes[0] + sizes[1]] = False
                offsets, nr = comap_layout(device, sizes, nrows)
                for how in COMAP_HOWS:
                    s, g = (torch.zeros_like(seg), 1) if how == "cross" else (seg, num)
                    cases.append((f"{members} members {layout} S={g} {how}", dict(
                        seg=s, num_segments=g, offsets=offsets, nrows=nr, how=how,
                        valid=valid)))
    return cases + comap_tile_cases(device, n, seed)


K18_TILE = 256 * 4  # K18's rows a tile (kRowTile in comap.cu)
K17_TILE = 256 * 16  # K17's rows a tile (kPresenceTile in comap.cu), 16 a thread


def comap_tile_cases(device: Any, n: int, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """K18's tile edges at ``n`` stacked rows (from ``2 * K18_TILE + 64``):
    26 members with a boundary at a tile's edge, an empty member, a
    boundary inside a tile, members of 1 and 7 rows and 20 of 3 rows (a
    tile over many members); 65 members, the first 40 of 3 rows, one
    empty (more than the 64 whose layout a block keeps, counted by global
    atomics; 3 presence words); and, from ``2 * K17_TILE + 64`` rows,
    K17's: a boundary at its tile's edge, an empty member, boundaries
    inside a thread's 16 rows (members of 1, 9 and 17 rows). Each in a
    prefix layout with ``nrows`` shorter than some members' rows, and a
    masked one; segments of 50 adjacent rows, 5 % sentinels; every zip
    type."""
    import torch

    from fugue_tpu_torch.kernels.reference import COMAP_HOWS

    if n < 2 * K18_TILE + 64:
        return []
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    edge = [K18_TILE, 0, K18_TILE // 2 + 3, 1, 7] + [3] * 20
    tiny = [3] * 40 + [0]
    layouts = [("tile edges", edge + [n - sum(edge)])]
    rest = n - sum(tiny)
    layouts.append(("65 members", tiny + [rest // 24] * 23 + [rest - 23 * (rest // 24)]))
    if n >= 2 * K17_TILE + 64:
        k17 = [K17_TILE, 0, K17_TILE // 2 + 7, 1, 9, 17]
        layouts.append(("K17 tile edges", k17 + [n - sum(k17)]))
    cases = []
    for name, sizes in layouts:
        members = len(sizes)
        num = max(n // 50, 1)
        seg = (torch.arange(n, device=device) // 50).clamp(max=num - 1).to(torch.int32)
        seg[torch.rand((n,), generator=gen, device=device) < 0.05] = num  # sentinels
        for layout in ("prefix", "masked"):
            if layout == "prefix":
                valid = None
                nrows = [max(sz - 5 * (m % 3), 0) for m, sz in enumerate(sizes)]
            else:
                valid = torch.rand((n,), generator=gen, device=device) < 0.8
                nrows = list(sizes)
            offsets, nr = comap_layout(device, sizes, nrows)
            for how in COMAP_HOWS:
                s, g = (torch.zeros_like(seg), 1) if how == "cross" else (seg, num)
                cases.append((f"{name} ({members} members) {layout} S={g} {how}", dict(
                    seg=s, num_segments=g, offsets=offsets, nrows=nr, how=how, valid=valid)))
    return cases


def comap_top_tile(device: Any, n: int) -> None:
    """K18 over ``n`` stacked rows (2^31 - 1 on the card, the most it
    takes, whose top tile ends at 2^31): a cross zip of two members, the
    second's last 5 rows past its ``nrows``; every row's flag and segment,
    the counts and the segment checked against what the rule gives."""
    import torch

    from fugue_tpu_torch.kernels import comap

    first = min(1000, n // 2)
    dead = min(5, n - first)
    real = n - dead
    offsets, nrows = comap_layout(device, [first, n - first], [first, n - first - dead])
    seg = torch.zeros((n,), dtype=torch.int32, device=device)
    got = comap.comap_rows_cuda(seg, None, 1, offsets, nrows, "cross")
    del seg
    ok = (bool(got.row_alive[:real].all()) and not bool(got.row_alive[real:].any())
          and bool((got.seg_out[:real] == 0).all()) and bool((got.seg_out[real:] == 1).all())
          and got.counts.tolist() == [first, n - first - dead] and int(got.alive_count) == 1
          and bool(got.alive.all()))
    del got
    if not ok:
        raise SystemExit(f"FAIL comap_rows over {n} rows: the top tile's rows are wrong")
    print(f"comap_rows over {n} rows: every row as the rule gives it")


def check_last_path(kernel: Callable[..., Any], label: str, want: str) -> None:
    """Fails where ``kernel``'s last launch on the card took another route
    (``last_path``) than ``want``; a twin standing in has none."""
    got = getattr(kernel, "last_path", want)
    if got != want:
        raise SystemExit(f"FAIL {label}: took the {got} route, expected {want}")


def comap_vs_twin(device: Any, sizes: Tuple[int, ...], big_segments: int = 1 << 24,
                  top_rows: Optional[int] = None) -> None:
    """K17 and K18 against their twins, exactly, at each size of ``sizes``
    (all of ``comap_cases`` up to 2^21 rows, its large cases above), K17
    on its vector route and, up to 2^21 rows, with ``seg`` one element off
    on its scalar route; then
    K18 over ``top_rows`` (``comap_top_tile``; 2^31 - 1 on the card, four
    tiles less one row in a CPU rehearsal)."""
    import torch

    from fugue_tpu_torch.kernels import comap
    from fugue_tpu_torch.kernels.reference import (
        comap_presence_reference,
        comap_rows_reference,
    )

    checked = 0
    for n in sizes:
        for label, kw in comap_cases(device, n, SEED + n, big_segments, n <= (1 << 21)):
            label = f"comap n={n} {label}"
            how = kw.pop("how")
            seg, num = kw.pop("seg"), kw.pop("num_segments")
            presence = want_presence = None
            if how != "cross":
                presence = comap.comap_presence_cuda(seg, num, **kw)
                want_presence = comap_presence_reference(seg, num, **kw)
                _same(f"{label} presence", presence, want_presence)
                check_last_path(comap.comap_presence_cuda, label, "vector")
                if n <= (1 << 21) and how == "inner":  # seg one element off: the scalar route
                    (view, _), = shifted([(seg, None)])
                    _same(f"{label} presence, seg unaligned",
                          comap.comap_presence_cuda(view, num, **kw), want_presence)
                    check_last_path(comap.comap_presence_cuda, label, "scalar")
            got = comap.comap_rows_cuda(seg, presence, num, how=how, **kw)
            want = comap_rows_reference(seg, want_presence, num, how=how, **kw)
            for name, g, w in zip(got._fields, got, want):
                _same(f"{label} {name}", g, w)
            checked += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
    if top_rows is None:
        top_rows = 2**31 - 1 if device.type == "cuda" else 4 * K18_TILE - 1
    comap_top_tile(device, top_rows)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"comap_vs_twin: {checked} cases equal at {sizes} rows")


def fold_ops() -> List[Any]:
    """Every kind of K19's accumulator updates over an int64 payload (0)
    and a float64 one (1), as ``StreamingAggregator`` lays them out."""
    from fugue_tpu_torch.kernels.reference import FoldOp

    kinds = [("rows", -1), ("count", 0), ("sum_i", 0), ("sum_if", 0), ("min_i", 0),
             ("max_i", 0), ("count", 1), ("sum_f", 1), ("min_f", 1), ("max_f", 1)]
    return [FoldOp(k, p, j) for j, (k, p) in enumerate(kinds)]


def fold_store(ops: List[Any], slots: int, device: Any) -> Any:
    import torch

    from fugue_tpu_torch.kernels.reference import fold_init

    init = torch.tensor([fold_init(op.kind) for op in ops], dtype=torch.int64)
    return init.to(device).unsqueeze(0).repeat(slots, 1)


def fold_chunk(device: Any, n: int, bounds: List[Tuple[int, int]], gen: Any, huge: bool
               ) -> Tuple[List[Any], List[Any]]:
    """``n`` rows of keys within ``bounds`` and an int64 and a float64
    payload, each with 5 % masked; ``huge``: int64 values beyond 2^53."""
    import torch

    keys = [torch.randint(lo, lo + span, (n,), generator=gen, device=device)
            for lo, span in bounds]
    if huge:
        ints = (1 << 60) + torch.randint(-(1 << 40), 1 << 40, (n,), generator=gen, device=device)
    else:
        ints = torch.randint(-1000, 1000, (n,), generator=gen, device=device)
    floats = torch.randn((n,), generator=gen, device=device, dtype=torch.float64)
    payloads = [(v, torch.rand((n,), generator=gen, device=device) > 0.05)
                for v in (ints, floats)]
    return keys, payloads


def twin_fold(keys: List[Any], bounds: List[Tuple[int, int]], payloads: List[Any],
              ops: List[Any], want: Any, mag: Any) -> None:
    """K19's twin folds the chunk into ``want``, and the payloads'
    absolute values into ``mag``, whose float sums are then each slot's
    sum of the magnitudes of its terms (``check_fold``'s scale)."""
    from fugue_tpu_torch.kernels.reference import stream_fold_reference

    stream_fold_reference(keys, bounds, payloads, ops, want)
    stream_fold_reference(keys, bounds, [(v.abs(), m) for v, m in payloads], ops, mag)


def check_fold(label: str, ops: List[Any], got: Any, want: Any, mag: Any) -> float:
    """Counts, int64 sums and extrema exactly; float64 sums within
    ``FOLD_RTOL`` of the larger of the sum and the sum of its terms'
    magnitudes (``mag``, ``twin_fold``): two orders of adding round
    apart by a share of the terms' magnitudes, which a slot whose terms
    cancel can hold far above its sum. Returns the largest relative float
    difference, against that scale."""
    import torch

    worst = 0.0
    for op in ops:
        g, w = got[:, op.acc], want[:, op.acc]
        if op.kind in ("sum_f", "sum_if"):
            g, w = g.view(torch.float64), w.view(torch.float64)
            scale = torch.maximum(w.abs(), mag[:, op.acc].view(torch.float64).abs())
            diff = (g - w).abs()
            if bool((diff > FOLD_RTOL * scale + 1e-300).any()):
                raise SystemExit(f"FAIL {label} {op.kind}: float sums differ by "
                                 f"{float(diff.max())}")
            rel = diff / scale.clamp(min=1e-300)
            worst = max(worst, float(rel.max()) if rel.numel() else 0.0)
        elif not torch.equal(g, w):
            raise SystemExit(f"FAIL {label} {op.kind}: differs from its twin")
    return worst


def stream_fold_vs_twin(device: Any, sizes: Tuple[int, ...]) -> float:
    """K19 against its twin at each size of ``sizes``: one key and two
    keys; int64 payloads small and beyond 2^53; two folds into one
    store, then a rebase onto a wider space (the same ``index_copy_`` on
    both stores) and a third fold over the new keys. Counts, int64 sums
    and extrema exactly, float64 sums within ``FOLD_RTOL``."""
    import torch

    from fugue_tpu_torch.kernels import stream
    from fugue_tpu_torch.torch_backend.streaming import _Space

    ops = fold_ops()
    worst = 0.0
    for n in sizes:
        gen = torch.Generator(device=device).manual_seed(SEED + n)
        for nkeys in (1, 2):
            for huge in (False, True):
                label = f"stream_fold n={n} keys={nkeys} huge={huge}"
                old = _Space([(0, 999), (-50, 49)][:nkeys])
                new = _Space([(-20, 1099), (-50, 59)][:nkeys])
                got, want, mag = (fold_store(ops, old.total, device) for _ in range(3))
                for _ in range(2):
                    keys, payloads = fold_chunk(device, n, old.spans, gen, huge)
                    stream.stream_fold_cuda(keys, old.spans, payloads, ops, got)
                    twin_fold(keys, old.spans, payloads, ops, want, mag)
                worst = max(worst, check_fold(label, ops, got, want, mag))
                new_seg = new.seg(old.decode(torch.arange(old.total, device=device)))
                got, want, mag = (fold_store(ops, new.total, device).index_copy_(0, new_seg, t)
                                  for t in (got, want, mag))
                keys, payloads = fold_chunk(device, n, new.spans, gen, huge)
                stream.stream_fold_cuda(keys, new.spans, payloads, ops, got)
                twin_fold(keys, new.spans, payloads, ops, want, mag)
                worst = max(worst, check_fold(f"{label} rebased", ops, got, want, mag))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    print(f"stream_fold_vs_twin: equal at {sizes} rows (float sums max rel err {worst})")
    return worst


def comap_udfs() -> Dict[str, Callable[..., Any]]:
    """The cotransformers of the zip paths, annotated one ``Dict[str,
    torch.Tensor]`` a member: per-key sums over ``_num_segments + 1``
    buckets with ``index_add_`` (torch's scatter ops raise on the sentinel
    id, so the last bucket takes it and is cut off):

    - ``config4``: ``cm_jax`` of ``bench.py:958-976``, the key and
      ``SUM(a.v) + SUM(b.w)``;
    - ``outer``: the key present on either side and each side's sum and
      row count;
    - ``three``: ``SUM(a.v) + 2 SUM(b.w) + 3 SUM(c.x)`` by key;
    - ``strings``: the string key (member a's codes and dictionary) and
      ``SUM(a.v) + SUM(b.w)``;
    - ``rows``: row-aligned with member a, each row's ``v`` plus its key's
      ``SUM(b.w)`` (``cm_rows``, ``test_comap_compiled.py:73``);
    - ``cross``: one row of both members' row counts and the product of
      their sums."""
    import torch

    Cols = Dict[str, torch.Tensor]

    def seg_sum(d: Cols, col: str) -> Any:
        s = d["_num_segments"]
        out = torch.zeros((s + 1,), dtype=d[col].dtype, device=d[col].device)
        return out.index_add_(0, d["_segment_ids"], torch.where(d["_row_valid"], d[col], 0))[:s]

    def seg_count(d: Cols) -> Any:
        s = d["_num_segments"]
        out = torch.zeros((s + 1,), dtype=torch.int64, device=d["_row_valid"].device)
        return out.index_add_(0, d["_segment_ids"], d["_row_valid"].to(torch.int64))[:s]

    def seg_key(d: Cols, col: str) -> Any:
        s = d["_num_segments"]
        key = d[col].to(torch.int64)
        out = torch.full((s + 1,), -(2**31), dtype=torch.int64, device=key.device)
        return out.scatter_reduce_(0, d["_segment_ids"].long(),
                                   torch.where(d["_row_valid"], key, -(2**31)), "amax")[:s]

    def config4(a: Cols, b: Cols) -> Cols:
        return {"k": seg_key(a, "k"), "s": seg_sum(a, "v") + seg_sum(b, "w")}

    def outer(a: Cols, b: Cols) -> Cols:
        return {"k": torch.maximum(seg_key(a, "k"), seg_key(b, "k")), "sa": seg_sum(a, "v"),
                "sb": seg_sum(b, "w"), "na": seg_count(a), "nb": seg_count(b)}

    def three(a: Cols, b: Cols, c: Cols) -> Cols:
        return {"k": seg_key(a, "k"),
                "s": seg_sum(a, "v") + 2.0 * seg_sum(b, "w") + 3.0 * seg_sum(c, "x")}

    def strings(a: Cols, b: Cols) -> Cols:
        return {"s": seg_key(a, "s").to(torch.int32), "_s_dict": a["_s_dict"],
                "t": seg_sum(a, "v") + seg_sum(b, "w")}

    def rows(a: Cols, b: Cols) -> Cols:
        s = a["_num_segments"]
        sw = seg_sum(b, "w")
        return {"k": a["k"], "d": a["v"] + sw[a["_segment_ids"].clamp(max=s - 1).long()]}

    def cross(a: Cols, b: Cols) -> Cols:
        n = torch.stack([a["_nrows"], b["_nrows"]]).to(torch.int64)
        return {"na": n[:1], "nb": n[1:], "p": seg_sum(a, "v") * seg_sum(b, "w")}

    return {"config4": config4, "outer": outer, "three": three, "strings": strings,
            "rows": rows, "cross": cross}


def config4_frames(groups: int) -> Tuple[Any, Any]:
    """BASELINE config 4's frames (``bench.py:930-945``, seed 3): ``a``
    holds ``groups`` keys of 50 rows each (``k`` int64 repeated, ``v``
    float64 uniform), ``b`` one row a key (``w`` float64 uniform)."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(CONFIG4_SEED)
    n = groups * CONFIG4_PER
    a = pd.DataFrame({"k": np.repeat(np.arange(groups, dtype=np.int64), CONFIG4_PER),
                      "v": rng.random(n)})
    b = pd.DataFrame({"k": np.arange(groups, dtype=np.int64), "w": rng.random(groups)})
    return a, b


def zip_frames(rows: Tuple[int, int], seed: int) -> Dict[str, Any]:
    """The other zip paths' frames: ``a`` of ``rows[0]`` rows with ``k``
    int64 uniform over [0, ZIP_KEYS), ``b`` of ``rows[1]`` rows over
    [ZIP_KEYS / 2, 3 ZIP_KEYS / 2) (keys missing on each side), ``c`` of
    ``rows[1]`` rows over [ZIP_KEYS / 4, 5 ZIP_KEYS / 4); ``v``, ``w``,
    ``x`` float64; ``rb``: one row a key over [1000, ZIP_KEYS / 2) (the
    row-aligned path's other side); ``s``/``sd``: 10,000 names for ``a``'s
    rows and a dimension table of them in another order with ``w``."""
    import numpy as np
    import pandas as pd
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    na, nb = rows
    half = ZIP_KEYS // 2
    a = pd.DataFrame({"k": rng.integers(0, ZIP_KEYS, na), "v": rng.random(na)})
    b = pd.DataFrame({"k": rng.integers(half, half + ZIP_KEYS, nb), "w": rng.random(nb)})
    c = pd.DataFrame({"k": rng.integers(half // 2, half // 2 + ZIP_KEYS, nb),
                      "x": rng.random(nb)})
    rb = pd.DataFrame({"k": np.arange(1000, half, dtype=np.int64),
                       "w": rng.random(half - 1000)})
    names = sku_names(rng.choice(SKU_SPACE, SKUS, replace=False))
    codes = rng.integers(0, SKUS, na).astype(np.int32)
    s = pa.table({"s": _string_array(codes, None, names), "v": pa.array(a.v.to_numpy())})
    order = rng.permutation(SKUS)
    sd = pa.table({"s": pa.array([names[i] for i in order], pa.string()),
                   "w": pa.array(rng.random(SKUS))})
    return {"a": a, "b": b, "c": c, "rb": rb, "s": s, "sd": sd, "codes": codes,
            "names": names, "order": order}


def _sum_by(keys: Any, vals: Any) -> Any:
    import pandas as pd

    return pd.Series(vals).groupby(keys).sum()


def zip_oracle(label: str, d: Dict[str, Any]) -> Any:
    """pandas' answer of a zip path: a frame sorted by its key."""
    import pandas as pd

    a, b = d["a"], d["b"]
    how = {"zip_left_outer": "left", "zip_right_outer": "right",
           "zip_full_outer": "outer"}.get(label)
    if how is not None:
        sa, sb = a.groupby("k").v.agg(["sum", "count"]), b.groupby("k").w.agg(["sum", "count"])
        j = sa.join(sb, how=how, lsuffix="a", rsuffix="b").fillna(0)
        return pd.DataFrame({"k": j.index.to_numpy(), "sa": j.suma.to_numpy(),
                             "sb": j.sumb.to_numpy(), "na": j.counta.to_numpy(),
                             "nb": j.countb.to_numpy()})
    if label == "zip_three_inner":
        s = pd.concat([a.groupby("k").v.sum(), 2.0 * b.groupby("k").w.sum(),
                       3.0 * d["c"].groupby("k").x.sum()], axis=1, join="inner").sum(axis=1)
        return pd.DataFrame({"k": s.index.to_numpy(), "s": s.to_numpy()})
    if label == "zip_string_key":
        sv = _sum_by(d["codes"], a.v.to_numpy())
        sw = pd.Series(d["sd"].column("w").to_numpy(), index=d["order"])
        t = (sv + sw).dropna()
        return pd.DataFrame({"s": [d["names"][i] for i in t.index], "t": t.to_numpy()})
    if label == "zip_row_aligned":
        rb = d["rb"]
        keep = a.k.isin(rb.k)
        w = pd.Series(rb.w.to_numpy(), index=rb.k.to_numpy())
        out = pd.DataFrame({"k": a.k[keep].to_numpy(),
                            "d": a.v[keep].to_numpy() + w.reindex(a.k[keep]).to_numpy()})
        return out
    if label == "zip_cross":
        return pd.DataFrame({"na": [len(d["xa"])], "nb": [len(d["xb"])],
                             "p": [d["xa"].v.sum() * d["xb"].w.sum()]})
    s = a.groupby("k").v.sum() + b.groupby("k").w.sum()  # config 4
    return pd.DataFrame({"k": s.index.to_numpy(), "s": s.to_numpy()})


def check_zip(label: str, got: Any, want: Any) -> None:
    """The same columns and rows as pandas' answer, sorted by the key
    (both sides' rows in a row-aligned output): keys and counts exactly,
    float64 within ``COMAP_RTOL``."""
    import numpy as np

    key = [c for c in ("k", "s", "na") if c in want.columns][0]
    by = [key, "d"] if "d" in want.columns else [key]
    g = got.sort_values(by, kind="stable").reset_index(drop=True)
    w = want.sort_values(by, kind="stable").reset_index(drop=True)
    if list(g.columns) != list(w.columns) or len(g) != len(w):
        raise SystemExit(f"FAIL {label}: {list(g.columns)} x {len(g)} rows against "
                         f"{list(w.columns)} x {len(w)}")
    for c in w.columns:
        gv, wv = g[c].to_numpy(), w[c].to_numpy()
        if wv.dtype.kind == "f" and c not in ("na", "nb"):
            if not np.allclose(gv, wv, rtol=COMAP_RTOL, atol=0):
                raise SystemExit(f"FAIL {label} {c}: max diff {np.abs(gv - wv).max()}")
        elif not np.array_equal(gv.astype(wv.dtype) if wv.dtype.kind != "O" else gv, wv):
            raise SystemExit(f"FAIL {label} {c}: differs from pandas")


def build_zip_paths(device: Any, config4_groups: Tuple[int, ...], rows: Tuple[int, int],
                    cross_rows: Tuple[int, int]
                    ) -> Tuple[Dict[str, Callable[[], Tuple[float, Any, Any]]],
                               Dict[str, Callable[[], Any]], Dict[str, Any], Any]:
    """Every zip path's frames uploaded, and per path ``run_once`` (zip,
    transform, the result to pandas: ``(seconds, frame, pandas)``) and
    ``comap_once`` (zip and transform only), the data and the engine."""
    import numpy as np
    import pandas as pd

    import fugue_tpu_torch as ft

    e = ft.make_execution_engine(device=device)
    cm = comap_udfs()
    runs: Dict[str, Callable[[], Tuple[float, Any, Any]]] = {}
    comaps: Dict[str, Callable[[], Any]] = {}
    data: Dict[str, Any] = {}

    def add(label: str, frames: List[Any], fn: Any, schema: str, how: str = "inner",
            partition: Any = "k") -> None:
        def comap_once() -> Any:
            z = ft.zip(*frames, how=how, partition=partition, engine=e)
            return ft.transform(z, fn, schema, engine=e, as_fugue=True)

        def run_once() -> Tuple[float, Any, Any]:
            sync(device)
            t = time.perf_counter()
            frame = comap_once()
            pdf = frame.as_pandas()
            return time.perf_counter() - t, frame, pdf

        runs[label], comaps[label] = run_once, comap_once

    for groups in config4_groups:
        a, b = config4_frames(groups)
        label = "config4_inner" if groups == CONFIG4_GROUPS else "config4_inner_100m"
        data[label] = {"a": a, "b": b}
        add(label, [e.persist(a), e.persist(b)], cm["config4"], "k:long,s:double")
    d = zip_frames(rows, ZIP_SEED)
    xa = pd.DataFrame({"i": np.arange(cross_rows[0]), "v": d["a"].v[: cross_rows[0]].to_numpy()})
    xb = pd.DataFrame({"j": np.arange(cross_rows[1]), "w": d["b"].w[: cross_rows[1]].to_numpy()})
    d.update(xa=xa, xb=xb)
    ta, tb, tc = e.persist(d["a"]), e.persist(d["b"]), e.persist(d["c"])
    for how in ("left_outer", "right_outer", "full_outer"):
        data[f"zip_{how}"] = d
        add(f"zip_{how}", [ta, tb], cm["outer"], "k:long,sa:double,sb:double,na:long,nb:long",
            how=how)
    data["zip_three_inner"] = d
    add("zip_three_inner", [ta, tb, tc], cm["three"], "k:long,s:double")
    data["zip_string_key"] = d
    add("zip_string_key", [e.persist(d["s"]), e.persist(d["sd"])], cm["strings"],
        "s:str,t:double", partition="s")
    data["zip_row_aligned"] = d
    add("zip_row_aligned", [ta, e.persist(d["rb"])], cm["rows"], "k:long,d:double")
    data["zip_cross"] = d
    add("zip_cross", [e.persist(xa), e.persist(xb)], cm["cross"], "na:long,nb:long,p:double",
        how="cross", partition=None)
    return runs, comaps, data, e


def sync(device: Any) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def zip_paths(device: Any, config4_groups: Tuple[int, ...], rows: Tuple[int, int],
              cross_rows: Tuple[int, int], warm_runs: int) -> List[Dict[str, Any]]:
    """Every zip path through ``ft.zip`` + ``ft.transform``, each against
    pandas (``zip_oracle``), its launches held to ``COMAP_PATH_LAUNCHES``
    on the card, with cold and best warm seconds, rows/s, peak memory, the
    synchronizing operations of one co-map (``_syncs_in``) and the device
    time of one run."""
    import torch

    sync(device)  # CUDA up before its memory statistics are reset
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    runs, comaps, data, _ = build_zip_paths(device, config4_groups, rows, cross_rows)
    print(f"zip_paths: frames built and uploaded in {time.perf_counter() - t:.1f}s")
    out = []
    for label, run_once in runs.items():
        d = data[label]
        n = sum(len(d[k]) for k in ("a", "b")) if label.startswith("config4") else rows[0]
        stats, frame, got = _path_stats(label, n, run_once, device, warm_runs)
        check_zip(label, got, zip_oracle(label, d))
        stats["out_rows"] = len(got)
        stats["syncs_in_one_comap"] = _syncs_in(comaps[label])
        stats["device_ms"] = device_busy_ms(run_once, device)
        out.append(stats)
        del frame, got
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def stream_chunks(chunks: int, chunk_rows: int, seed: int) -> List[Any]:
    """The streaming path's chunks as pandas frames: ``store`` int32 over
    [0, STREAM_STORES), ``item`` int64 over [0, STREAM_ITEMS[0]) and, from
    chunk ``chunks // 4`` on (5 of 20), [0, STREAM_ITEMS[1]); ``qty`` int64 over [1, 100]
    and ``price`` float64 over [0, 100), each with STREAM_NULLS nulls (a
    null ``qty`` is NaN, as pandas holds a nullable integer)."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(seed)
    out = []
    for i in range(chunks):
        items = STREAM_ITEMS[i >= max(chunks // 4, 1)]
        qty = rng.integers(1, 101, chunk_rows).astype(np.float64)
        qty[rng.random(chunk_rows) < STREAM_NULLS] = np.nan
        price = rng.random(chunk_rows) * 100.0
        price[rng.random(chunk_rows) < STREAM_NULLS] = np.nan
        out.append(pd.DataFrame({
            "store": rng.integers(0, STREAM_STORES, chunk_rows).astype(np.int32),
            "item": rng.integers(0, items, chunk_rows).astype(np.int64),
            "qty": qty, "price": price}))
    return out


STREAM_AGGS = ("sum", "count", "min", "max", "avg")


def stream_oracle(chunks: List[Any]) -> Dict[str, Any]:
    """numpy's answer, accumulated chunk by chunk over the final key space
    (store x item): per group the rows, and per payload its valid count,
    sum, min and max."""
    import numpy as np

    slots = STREAM_STORES * STREAM_ITEMS[1]
    acc = {"rows": np.zeros(slots, dtype=np.int64)}
    for c in ("qty", "price"):
        acc[f"{c}_count"] = np.zeros(slots, dtype=np.int64)
        acc[f"{c}_sum"] = np.zeros(slots, dtype=np.float64)
        acc[f"{c}_min"] = np.full(slots, np.inf)
        acc[f"{c}_max"] = np.full(slots, -np.inf)
    for pdf in chunks:
        g = pdf.store.to_numpy().astype(np.int64) * STREAM_ITEMS[1] + pdf.item.to_numpy()
        acc["rows"] += np.bincount(g, minlength=slots)
        for c in ("qty", "price"):
            v = pdf[c].to_numpy()
            ok = ~np.isnan(v)
            gv, vv = g[ok], v[ok]
            acc[f"{c}_count"] += np.bincount(gv, minlength=slots)
            acc[f"{c}_sum"] += np.bincount(gv, weights=vv, minlength=slots)
            np.minimum.at(acc[f"{c}_min"], gv, vv)
            np.maximum.at(acc[f"{c}_max"], gv, vv)
    return acc


def check_stream(got: Any, want: Dict[str, Any]) -> float:
    """The streaming aggregate against ``stream_oracle``: the occupied
    groups in slot order, counts, the qty sums (exact in float64 at this
    size) and extrema exactly, price sums and both averages within
    ``COMAP_RTOL``. Returns the largest relative difference."""
    import numpy as np

    occ = np.flatnonzero(want["rows"])
    if len(got) != len(occ):
        raise SystemExit(f"FAIL stream_200m: {len(got)} groups, numpy has {len(occ)}")
    if not (np.array_equal(got.store.to_numpy(), occ // STREAM_ITEMS[1])
            and np.array_equal(got.item.to_numpy(), occ % STREAM_ITEMS[1])):
        raise SystemExit("FAIL stream_200m: the groups' keys differ from numpy's")
    if not np.array_equal(got.n.to_numpy(), want["rows"][occ]):
        raise SystemExit("FAIL stream_200m: count(*) differs")
    worst = 0.0
    for c in ("qty", "price"):
        cnt = want[f"{c}_count"][occ]
        exact = {"count": cnt, "min": want[f"{c}_min"][occ], "max": want[f"{c}_max"][occ]}
        near = {"avg": want[f"{c}_sum"][occ] / np.maximum(cnt, 1)}
        (exact if c == "qty" else near)["sum"] = want[f"{c}_sum"][occ]
        for f, w in exact.items():
            g = got[f"{c}_{f}"].to_numpy(dtype=np.float64, na_value=np.nan)
            w = np.where(cnt > 0, w, np.nan) if f != "count" else w
            if not np.array_equal(g, w, equal_nan=True):
                raise SystemExit(f"FAIL stream_200m: {c} {f} differs from numpy")
        for f, w in near.items():
            g = got[f"{c}_{f}"].to_numpy(dtype=np.float64, na_value=np.nan)
            ok = cnt > 0
            rel = np.abs(g[ok] - w[ok]) / np.maximum(np.abs(w[ok]), 1e-300)
            if not (rel <= COMAP_RTOL).all() or not np.isnan(g[~ok]).all():
                raise SystemExit(f"FAIL stream_200m: {c} {f} off by {rel.max()}")
            worst = max(worst, float(rel.max()) if rel.size else 0.0)
    return worst


def stream_path(device: Any, chunks: int, chunk_rows: int, warm_runs: int) -> Dict[str, Any]:
    """The streaming aggregate through ``ft.aggregate`` of a
    ``LocalDataFrameIterableDataFrame`` of ``chunks`` chunks of
    ``chunk_rows`` rows (``stream_chunks``): sum, count, min, max and avg
    of ``qty`` and ``price`` and count(*) by (store, item), K19 once a
    chunk, at least one rebase (the item range widens a quarter of the way
    through), against numpy accumulated chunk by chunk. Peak device
    memory above what the run found allocated must stay below the
    accumulators plus two chunks on the card in every run; it is printed
    beside the whole frame's bytes. The chunks are made once (set-up) and
    each run streams them anew. ``host_ms_a_chunk`` (the median; and its
    largest) times a chunk's host work alone: its arrow table
    (``chunk_table``) and ``StreamingAggregator.host_arrays``."""
    import torch

    import fugue_tpu_torch as ft
    from fugue_tpu_torch import col
    from fugue_tpu_torch.column import functions as ff

    t = time.perf_counter()
    data = stream_chunks(chunks, chunk_rows, STREAM_SEED)
    gen_secs = time.perf_counter() - t
    t = time.perf_counter()
    want = stream_oracle(data)
    oracle_secs = time.perf_counter() - t
    e = ft.make_execution_engine(device=device)
    aggs = {f"{c}_{f}": getattr(ff, f)(col(c)) for c in ("qty", "price") for f in STREAM_AGGS}
    aggs["n"] = ff.count(col("*"))
    schema = "store:int,item:long,qty:long,price:double"
    rebases: List[int] = []
    peaks: List[int] = []  # a run's peak device memory above what it found allocated

    def run_once() -> Tuple[float, Any, Any]:
        sync(device)
        start = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        src = ft.LocalDataFrameIterableDataFrame(iter(data), schema)
        frame = ft.aggregate(src, ["store", "item"], engine=e, as_fugue=True, **aggs)
        pdf = frame.as_pandas()
        secs = time.perf_counter() - t
        rebases.append(e.stream_stats["rebases"])
        if device.type == "cuda":
            peaks.append(torch.cuda.max_memory_allocated(device) - start)
        return secs, frame, pdf

    # K19 once a chunk, nothing else
    stats, frame, got = _path_stats("stream_200m", chunks * chunk_rows, run_once, device,
                                    warm_runs, launches=dict(stream_fold=chunks))
    if e.fallbacks:
        raise SystemExit(f"FAIL stream_200m: fell back {e.fallbacks}")
    if min(rebases) < 1:
        raise SystemExit(f"FAIL stream_200m: rebases a run {rebases}, expected at least 1")
    worst = check_stream(got, want)
    slots = STREAM_STORES * STREAM_ITEMS[1]
    acc_bytes = 20 * slots * 8  # the store's rows: _count, 9 a payload, count(*)
    chunk_bytes = chunk_rows * (5 * 8 + 3)  # 2 keys and 3 payloads as int64, 3 masks
    frame_bytes = sum(int(p.memory_usage(index=False).sum()) + 2 * len(p) for p in data)
    peak = max(peaks) if peaks else None
    if peak is not None and peak > acc_bytes + 2 * chunk_bytes:
        raise SystemExit(f"FAIL stream_200m: peak {peak} B above the accumulators and two "
                         f"chunks ({acc_bytes + 2 * chunk_bytes} B)")
    # the host's part of a chunk: its arrow table and keys, payloads and
    # masks as the arrays that go to the card (no pass through pandas)
    from fugue_tpu_torch.dataframe.dataframe_iterable_dataframe import chunk_table
    from fugue_tpu_torch.torch_backend.streaming import StreamingAggregator

    plans = [(f"{c}_{f}", f, c) for c in ("qty", "price") for f in STREAM_AGGS]
    agg = StreamingAggregator(e, ft.Schema(schema), ["store", "item"], plans)
    host_ms = []
    for chunk in data:
        t = time.perf_counter()
        agg.host_arrays(chunk_table(chunk, ft.Schema(schema)))
        host_ms.append((time.perf_counter() - t) * 1e3)
    trace: Dict[str, Any] = {}
    if device.type == "cuda":
        # the chunks' upload: pinned copies only, timed from a trace
        trace = traced_stream(TRACE_CHUNKS, chunk_rows)
        kinds = set(trace["copies"])
        if PINNED_COPIES[0] not in kinds or not kinds <= set(PINNED_COPIES) | {
                "Memcpy DtoD (Device -> Device)"}:
            raise SystemExit(f"FAIL stream_200m: the trace's copies are {trace['copies']}, "
                             f"expected pinned copies only")
        trace["upload_ms_a_chunk"] = trace["copy_ms"][PINNED_COPIES[0]] / TRACE_CHUNKS
    stats.update(
        trace=trace, upload_ms_a_chunk=trace.get("upload_ms_a_chunk"),
        host_ms_a_chunk=sorted(host_ms)[len(host_ms) // 2], host_ms_a_chunk_max=max(host_ms),
        groups=len(got), rebases_per_run=rebases[0], max_rel_err=worst,
        peak_over_start_bytes=peak, accumulator_bytes=acc_bytes, chunk_device_bytes=chunk_bytes,
        whole_frame_bytes=frame_bytes, generate_secs=gen_secs, numpy_secs=oracle_secs,
        device_ms=device_busy_ms(run_once, device),
        scale_cut="200M rows, not larger than memory: cut by host generation time and the "
                  "script's time limit")
    del frame, got, data
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return stats


TRACE_CHUNKS = 2  # the traced streaming run's chunks (of the phase's chunk rows)


def build_stream_run(device: Any, chunks: int, chunk_rows: int) -> Callable[[], Any]:
    """One streaming aggregate of ``stream_chunks`` (made once) through
    ``ft.aggregate``, with its export, as ``stream_path`` runs it."""
    import fugue_tpu_torch as ft
    from fugue_tpu_torch import col
    from fugue_tpu_torch.column import functions as ff

    data = stream_chunks(chunks, chunk_rows, STREAM_SEED)
    e = ft.make_execution_engine(device=device)
    aggs = {f"{c}_{f}": getattr(ff, f)(col(c)) for c in ("qty", "price") for f in STREAM_AGGS}
    schema = "store:int,item:long,qty:long,price:double"

    def run() -> Any:
        src = ft.LocalDataFrameIterableDataFrame(iter(data), schema)
        return ft.aggregate(src, ["store", "item"], engine=e, as_fugue=True, **aggs).as_pandas()

    return run


def traced_stream(chunks: int, chunk_rows: int, tries: int = 3) -> Dict[str, Any]:
    """``copy_kinds`` of a warm streaming aggregate (``build_stream_run``)
    in a fresh process, as ``traced_config5`` takes its traces: the copies
    between host and card by kind, and their device milliseconds."""
    import os

    code = ("import json, torch, chip_smoke as cs\n"
            "d = torch.device('cuda', torch.cuda.current_device())\n"
            f"run = cs.build_stream_run(d, {chunks}, {chunk_rows})\n"
            "run()\n"
            f"for _ in range({tries}):\n"
            "    tr = cs.copy_kinds(run, d)\n"
            "    if cs.PINNED_COPIES[0] in tr['copies']:\n"
            "        break\n"
            "print(json.dumps(tr))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)), timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"FAIL the traced streaming run: {res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def config4_stacked(device: Any) -> Tuple[Any, int, List[int]]:
    """Config 4's stacked ids at 100M rows: ``(seg, segments, sizes)``, a
    with 50 rows a key in order, b with one a key."""
    import torch

    groups = CONFIG4_BIG_GROUPS
    na, nb = groups * CONFIG4_PER, groups
    seg = torch.cat([torch.arange(na, device=device) // CONFIG4_PER,
                     torch.arange(nb, device=device)]).to(torch.int32)
    return seg, groups, [na, nb]


def sorted_members(device: Any, n: int, members: int, num: int, seed: int) -> Tuple[Any, List[int]]:
    """``n`` stacked rows of ``members`` equal members, each member's ids
    drawn over ``num`` segments and sorted (a co-partitioned frame):
    ``(seg, sizes)``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    per = n // members
    sizes = [per] * (members - 1) + [n - per * (members - 1)]
    return torch.cat([torch.sort(torch.randint(0, num, (s,), generator=gen, device=device,
                                               dtype=torch.int32)).values for s in sizes]), sizes


PRESENCE_WIDE_SEGMENTS = 1 << 24  # the 33-member shape's segments (two presence words)


def presence_shapes(device: Any) -> Iterator[Tuple[str, Dict[str, Any], Callable[[], Any], int]]:
    """K17's timed shapes, one at a time: ``(label, comap_presence_cuda's
    arguments, its one PyTorch call, bytes of its bound)``. Config 4 at
    100M rows; 100M rows of 33 members over 2^24 segments (two presence
    words), each member's ids sorted; 100M rows of 2 members, random ids
    over 2M segments, 70 % real (a ``valid`` mask), 5 % sentinels: every
    row its own run. The bound reads ``seg`` (and ``valid``) once a row
    and writes the words once; the one call is a ``bincount`` of each
    real row's (segment, member) pair, precomputed: the counts whose
    non-zero entries are the bits."""
    import torch

    def shape(label: str, seg: Any, num: int, sizes: List[int], valid: Any) -> Any:
        offsets, nrows = comap_layout(device, sizes, sizes)
        members = len(sizes)
        member = torch.repeat_interleave(torch.arange(members, device=device),
                                         torch.tensor(sizes, device=device))
        real = (seg >= 0) & (seg < num)
        if valid is not None:
            real &= valid
        pair = (seg.long() * members + member)[real]
        del member, real
        words = -(-members // 32)
        n = int(seg.shape[0])
        kw = dict(seg=seg, num_segments=num, offsets=offsets, nrows=nrows, valid=valid)
        return (label, kw, lambda: torch.bincount(pair, minlength=num * members),
                n * (4 + (valid is not None)) + num * words * 4)

    seg, num, sizes = config4_stacked(device)
    yield shape("config 4 (102M rows, 2 members, 2M segments)", seg, num, sizes, None)
    del seg
    seg, sizes = sorted_members(device, ROWS, 33, PRESENCE_WIDE_SEGMENTS, SEED)
    yield shape("100M rows, 33 members, 2^24 segments", seg, PRESENCE_WIDE_SEGMENTS, sizes, None)
    del seg
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    num = CONFIG4_BIG_GROUPS
    seg = torch.randint(0, num, (ROWS,), generator=gen, device=device, dtype=torch.int32)
    seg[torch.rand((ROWS,), generator=gen, device=device) < 0.05] = num  # sentinels
    valid = torch.rand((ROWS,), generator=gen, device=device) < 0.7
    yield shape("masked, 100M rows, 2 members, random over 2M segments, 70 % real", seg, num,
                [ROWS // 2, ROWS - ROWS // 2], valid)


def null_count_shapes(device: Any
                      ) -> Iterator[Tuple[str, Dict[str, Any], Callable[[], Any], int]]:
    """K14's timed shapes at 100M rows, one at a time: ``(label,
    null_count_keep_cuda's arguments, its one PyTorch call, bytes of its
    bound)``. Four masks of 5 % nulls, how any, in a prefix frame (the
    dropna path's) and with a ``row_valid``; one mask; 70 masks with
    ``thresh`` 66 of 72 columns. The bound reads each mask (and the
    validity) once a row and writes the keep byte; the one call is
    ``torch.all`` of the masks stacked beforehand, and at 70 masks their
    byte sum (the counts alone)."""
    import torch

    n = ROWS
    gen = torch.Generator(device=device).manual_seed(SEED + 2)

    def masks_of(k: int) -> List[Any]:
        return [torch.rand((n,), generator=gen, device=device) > 0.05 for _ in range(k)]

    masks = masks_of(4)
    stacked = torch.stack(masks)
    yield ("four masks, prefix, any", dict(masks=masks, ncols=4, n=n, nrows=n, device=device),
           lambda: torch.all(stacked, 0), n * 5)
    row_valid = torch.rand((n,), generator=gen, device=device) < 0.9
    with_rows = torch.stack(masks + [row_valid])
    yield ("four masks, row_valid, any", dict(masks=masks, ncols=4, n=n, row_valid=row_valid,
                                              device=device),
           lambda: torch.all(with_rows, 0), n * 6)
    del with_rows, row_valid
    yield ("one mask, prefix, any", dict(masks=masks[:1], ncols=1, n=n, nrows=n, device=device),
           lambda: torch.all(stacked[:1], 0), n * 2)
    del masks, stacked
    masks = masks_of(70)
    stacked = torch.stack(masks)
    yield ("70 masks, prefix, thresh 66 of 72", dict(masks=masks, ncols=72, n=n, nrows=n,
                                                     thresh=66, device=device),
           lambda: stacked.sum(0, dtype=torch.uint8), n * 71)


def comap_timing(device: Any, launches: Dict[str, int]) -> List[Dict[str, Any]]:
    """K17 and K18 at config 4's 100M-row shape (a: 100M rows, 50 a key in
    order; b: 2M rows, one a key; 2M segments; prefix frames), beside
    their twins, and K17 also at the other ``presence_shapes`` (a
    ``comap_presence shape:`` line each, with its route); K17's bound and
    one PyTorch call are the shape's; K18's bound ``seg`` read,
    ``row_alive`` and ``seg_out`` written a row (9 B) and the words read
    and ``alive`` written a segment (5 B), with no one call."""
    from fugue_tpu_torch.kernels import comap
    from fugue_tpu_torch.kernels.reference import comap_presence_reference, comap_rows_reference

    entries = []
    for label, kw, library, nbytes in presence_shapes(device):
        want = comap_presence_reference(**kw)
        _same(f"comap_presence timed {label}", comap.comap_presence_cuda(**kw), want)
        path = getattr(comap.comap_presence_cuda, "last_path", None)
        first = not entries
        entry = _kernel_entry(
            "comap_presence", "fugue_tpu/jax_backend/comap_compiled.py:335",
            launches["comap_presence"], 0.0,
            time_cuda(lambda: comap.comap_presence_cuda(**kw), 20),  # noqa: B023
            time_cuda(lambda: comap_presence_reference(**kw), 5 if first else 1),  # noqa: B023
            nbytes, 0, time_cuda(library, 5), source="comap.cu")
        if not first:
            print("comap_presence shape: " + json.dumps({
                "case": label, "path": path,
                **{k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}}))
            continue
        entries.append(entry)
        seg, groups = kw["seg"], kw["num_segments"]
        rkw = dict(offsets=kw["offsets"], nrows=kw["nrows"])
        got = comap.comap_rows_cuda(seg, want, groups, how="inner", **rkw)
        for name, g, w in zip(got._fields, got,
                              comap_rows_reference(seg, want, groups, how="inner", **rkw)):
            _same(f"comap_rows timed {name}", g, w)
        n = int(seg.shape[0])
        entries.append(_kernel_entry(
            "comap_rows", "fugue_tpu/jax_backend/comap_compiled.py:342",
            launches["comap_rows"], 0.0,
            time_cuda(lambda: comap.comap_rows_cuda(seg, want, groups, how="inner",  # noqa: B023
                                                    **rkw), 20),  # noqa: B023
            time_cuda(lambda: comap_rows_reference(seg, want, groups, how="inner",  # noqa: B023
                                                   **rkw), 5),  # noqa: B023
            n * (4 + 1 + 4) + groups * (4 + 1), 0, None, source="comap.cu"))
        del got, seg, rkw
        print(f"comap_presence route at config 4: {path}")
    for e in entries:
        print("comap timed: " + json.dumps(e))
    return entries


def stream_timing(device: Any, launches: int) -> Dict[str, Any]:
    """K19 at the streaming path's shape: one chunk of STREAM_CHUNK_ROWS
    rows, 2 keys, 3 payloads (qty int64, price float64 and the key's
    count(*)) with masks, the 20 accumulators of its aggregate over
    STREAM_STORES x STREAM_ITEMS[1] slots, beside its twin; its bound
    reads 8 B a key and 9 B a payload a row and each touched slot's
    accumulators once (8 B read and 8 B written each), its one PyTorch
    call the ``index_add_`` of one payload's sum."""
    import torch

    import fugue_tpu_torch as ft
    from fugue_tpu_torch import Schema
    from fugue_tpu_torch.kernels import stream
    from fugue_tpu_torch.kernels.reference import stream_fold_reference
    from fugue_tpu_torch.torch_backend.streaming import StreamingAggregator

    n = STREAM_CHUNK_ROWS
    schema = Schema("store:int,item:long,qty:long,price:double")
    plans = [(f"{c}_{f}", f, c) for c in ("qty", "price") for f in STREAM_AGGS]
    plans.append(("n", "count", "store"))

    agg = StreamingAggregator(ft.make_execution_engine(device=device), schema,
                              ["store", "item"], plans)
    ops = agg._ops
    slots = STREAM_STORES * STREAM_ITEMS[1]
    bounds = [(0, STREAM_STORES), (0, STREAM_ITEMS[1])]
    gen = torch.Generator(device=device).manual_seed(STREAM_SEED)
    keys = [torch.randint(0, span, (n,), generator=gen, device=device) for _, span in bounds]
    qty = torch.randint(1, 101, (n,), generator=gen, device=device)
    price = torch.rand((n,), generator=gen, device=device, dtype=torch.float64) * 100.0
    masks = [torch.rand((n,), generator=gen, device=device) > STREAM_NULLS for _ in range(3)]
    payloads = [(price, masks[0]), (qty, masks[1]), (keys[0], masks[2])]  # sorted names
    got = stream.stream_fold_cuda(keys, bounds, payloads, ops, agg._make_init(slots))
    want, mag = agg._make_init(slots), agg._make_init(slots)
    twin_fold(keys, bounds, payloads, ops, want, mag)
    err = check_fold("stream_fold timed", ops, got, want, mag)
    store = agg._make_init(slots)
    seg = keys[0] * STREAM_ITEMS[1] + keys[1]
    touched = int(torch.unique(seg).numel())
    sums = torch.zeros((slots,), dtype=torch.float64, device=device)
    entry = _kernel_entry(
        "stream_fold", "fugue_tpu/jax_backend/streaming.py:295", launches, err,
        time_cuda(lambda: stream.stream_fold_cuda(keys, bounds, payloads, ops, store), 20),
        time_cuda(lambda: stream_fold_reference(keys, bounds, payloads, ops, store), 3),
        n * (2 * 8 + 3 * 9) + touched * len(ops) * 16, 0,
        time_cuda(lambda: sums.index_add_(0, seg, price), 20), source="stream.cu",
        ops_per_s=FP64_OPS_PER_S)
    print("stream timed: " + json.dumps(entry))
    # the rebase of the run: the slots of 800 items widened to 1,000
    from fugue_tpu_torch.torch_backend.streaming import _Space

    old = _Space([(0, STREAM_STORES - 1), (0, STREAM_ITEMS[0] - 1)])
    new = _Space([(0, STREAM_STORES - 1), (0, STREAM_ITEMS[1] - 1)])
    before = agg._make_init(old.total)
    nbytes = (before.numel() + new.total * before.shape[1]) * before.element_size()
    print("rebase timed: " + json.dumps({
        "name": "StreamingAggregator._rebase", "slots": [old.total, new.total],
        "accumulators": int(before.shape[1]),
        "ms": time_cuda(lambda: agg._rebase(old, new, before), 20),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "card": card_line()}))
    return entry


FOLD_ZIPF = 1.1  # the skewed case's Zipf exponent over the stream's slots


def fold_edge_cases(device: Any, rows: int, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """K19's cases at its edges, each ``(label, {keys, bounds, payloads,
    ops, slots})`` with ``rows`` rows: the stream's uniform 1M slots x 20
    accumulators; one slot taking every row; a Zipf(``FOLD_ZIPF``) slot
    drawn with numpy from ``seed``; a slot space within one slab, and one
    of three slabs and 17 slots; 1 % of the rows outside the space; one
    row; widths 1 and 48. Every payload is masked (5 % null)."""
    import numpy as np
    import torch

    from fugue_tpu_torch.kernels import stream
    from fugue_tpu_torch.kernels.reference import FoldOp

    gen = torch.Generator(device=device).manual_seed(seed)
    stores, items = STREAM_STORES, STREAM_ITEMS[1]
    kinds = [("rows", -1), ("count", 0), ("sum_i", 0), ("min_i", 0), ("max_i", 0),
             ("sum_if", 0)] + [(k, 1) for k in ("count", "sum_f", "min_f", "max_f")]
    kinds += [("count", 2)] + [(k, 3) for k in ("count", "sum_f", "min_f", "max_f")]
    kinds += [(k, 4) for k in ("count", "sum_i", "min_i", "max_i")] + [("count", 5)]  # 20

    def payloads(n: int, count: int) -> List[Any]:
        out = []
        for j in range(count):
            if j % 2 == 0:
                v = torch.randint(-1000, 1000, (n,), generator=gen, device=device)
            else:
                v = torch.randn((n,), generator=gen, device=device, dtype=torch.float64)
            out.append((v, torch.rand((n,), generator=gen, device=device) > STREAM_NULLS))
        return out

    def case(n: int, keys: List[Any], bounds: List[Tuple[int, int]], slots: int,
             kind_list: List[Tuple[str, int]]) -> Dict[str, Any]:
        ops = [FoldOp(k, p, j) for j, (k, p) in enumerate(kind_list)]
        count = max(p for _, p in kind_list) + 1
        return dict(keys=keys, bounds=bounds, payloads=payloads(n, count), ops=ops, slots=slots)

    def uniform(n: int, spans: List[int], lo: int = 0) -> List[Any]:
        return [torch.randint(lo, lo + s, (n,), generator=gen, device=device) for s in spans]

    bounds = [(0, stores), (0, items)]
    rng = np.random.default_rng(seed)
    zipf = torch.from_numpy((rng.zipf(FOLD_ZIPF, rows) - 1) % (stores * items)).to(device)
    slab = 1 << stream.fold_plan(len(kinds), stores * items, rows,
                                 [FoldOp(k, p, j) for j, (k, p) in enumerate(kinds)], 6).shift
    wide = [(k, p) for p in range(12) for k in (("count", "sum_i", "min_i", "max_i") if p % 2 == 0
                                                else ("count", "sum_f", "min_f", "max_f"))]
    zero = torch.zeros((rows,), dtype=torch.int64, device=device)
    return [
        ("uniform", case(rows, uniform(rows, [stores, items]), bounds, stores * items, kinds)),
        ("one_slot", case(rows, [zero, zero.clone()], bounds, stores * items, kinds)),
        (f"zipf_{FOLD_ZIPF}", case(rows, [zipf // items, zipf % items], bounds, stores * items,
                                  kinds)),
        ("within_one_slab", case(rows, uniform(rows, [slab // 2]), [(0, slab // 2)], slab // 2,
                                 kinds)),
        ("three_slabs_and_17", case(rows, uniform(rows, [3 * slab + 17]), [(0, 3 * slab + 17)],
                                    3 * slab + 17, kinds)),
        ("outside_rows", case(rows, uniform(rows, [stores * items + 20000], lo=-10000),
                              [(0, stores * items)], stores * items, kinds)),
        ("one_row", case(1, uniform(1, [stores, items]), bounds, stores * items, kinds)),
        ("width_1", case(rows, uniform(rows, [stores, items]), bounds, stores * items,
                         [("sum_f", 1)])),
        ("width_48", case(rows, uniform(rows, [stores, items]), bounds, stores * items, wide)),
    ]


def check_fold_fill(label: str, plan: Any, fill: Any, keys: List[Any],
                    bounds: List[Tuple[int, int]], slots: int) -> None:
    """K19's buckets: each slab's entries, as ``fold_partition`` counted
    them, against the rows whose slot lies in it."""
    import torch

    from fugue_tpu_torch.kernels.reference import fold_segments

    if plan.route == "direct":
        return
    seg = fold_segments(keys, bounds)
    seg = seg[(seg >= 0) & (seg < slots)]
    want = torch.bincount(seg >> plan.shift, minlength=plan.nslabs).to(torch.int32)
    if fill is None or not torch.equal(fill, want):
        raise SystemExit(f"FAIL {label}: bucket counts differ from the slabs' rows")


def stream_fold_edges(device: Any, rows: int, fold: Optional[Callable[..., Any]] = None
                      ) -> List[Dict[str, Any]]:
    """K19 (``fold``: the wrapper unless given) against its twin in every
    case of ``fold_edge_cases`` (``check_fold``); on the card each slab's
    bucket count against its rows (``check_fold_fill``); each case's ms
    (CUDA events) and each launch's device ms (``device_split_ms``).
    Prints one ``stream_fold edge:`` line a case and returns them."""
    import torch

    from fugue_tpu_torch.kernels import stream
    from fugue_tpu_torch.kernels.reference import fold_init

    run = stream.stream_fold_cuda if fold is None else fold
    on_card = device.type == "cuda"
    out = []
    for label, c in fold_edge_cases(device, rows, SEED + 19):
        init = torch.tensor([fold_init(op.kind) for op in c["ops"]], dtype=torch.int64)
        width = len(c["ops"])

        def store() -> Any:
            return init.to(device).unsqueeze(0).repeat(c["slots"], 1)

        args = (c["keys"], c["bounds"], c["payloads"], c["ops"])
        got, want, mag = run(*args, store()), store(), store()
        twin_fold(*args, want, mag)
        err = check_fold(f"stream_fold {label}", c["ops"], got, want, mag)
        line: Dict[str, Any] = {"case": label, "rows": int(c["keys"][0].shape[0]),
                                "slots": c["slots"], "accumulators": width, "max_rel_err": err}
        if fold is None:
            plan = stream.stream_fold_cuda.last_plan
            if on_card:
                check_fold_fill(f"stream_fold {label}", plan, stream.stream_fold_cuda.last_fill,
                                c["keys"], c["bounds"], c["slots"])
            line.update(route=plan.route, slab_slots=1 << plan.shift, slabs=plan.nslabs)
        del got, want, mag
        dst = store()
        line["ms"] = time_cuda(lambda: run(*args, dst), 10)
        line["device_ms"] = device_split_ms(lambda: run(*args, dst), device)
        line["card"] = card_line()
        print("stream_fold edge: " + json.dumps(line))
        out.append(line)
        del c, args
        if on_card:
            torch.cuda.empty_cache()
    return out


# ---- the host boundary and file I/O (BASELINE config 5) ---------------------

CONFIG5_ROWS = (5_000_000, 100_000_000)  # bench.py:1011's n, then the headline's rows
CONFIG5_GROUPS, CONFIG5_SEED = 128, 4  # bench.py:1012-1018
CONFIG5_WARM_RUNS = 3
# the launches of one config 5 run: the fused sums once; K10 once, where
# the aggregate's masked result is compacted for its save
CONFIG5_LAUNCHES = dict(binned_sums=1, gather_rows=1)
IO_CHECK_ROWS = 2_000_003  # the mixed-type load, save and export checks
IO_CHECK_BATCH = 300_007  # their batch rows: no divisor of the rows, slabs reused
PINNED_COPIES = ("Memcpy HtoD (Pinned -> Device)", "Memcpy DtoH (Device -> Pinned)")


def config5_frame(rows: int) -> Any:
    """BASELINE config 5's source (``bench.py:1011-1018``): ``k`` int32
    uniform over [0, 128), ``v`` float32, from ``default_rng(4)``."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(CONFIG5_SEED)
    return pd.DataFrame({"k": rng.integers(0, CONFIG5_GROUPS, rows).astype(np.int32),
                         "v": rng.random(rows).astype(np.float32)})


def config5_batch_rows(rows: int) -> int:
    """The streamed engine's batch rows, as the bench sets them (``:1036``)."""
    return max(rows // 16, 65_536)


def build_config5(device: Any, src: str, out: str, batch_rows: int
                  ) -> Tuple[Callable[[], Tuple[Dict[str, float], Any]], Any]:
    """``(run_once, engine)``: ``run_once()`` drives BASELINE config 5
    (``bench.py:1040-1050``) through the port's entry points: ``load_df`` of
    the parquet file ``src`` (streamed with ``batch_rows`` > 0), the UDF
    ``v2 = v * 0.5``, ``sum(v2)`` and ``count(v2)`` by ``k``, ``save_df`` to
    ``out``; with the phases' boundaries forced (the load's columns on the
    card, the aggregate done) as ``bench.py:1069-1086`` forces them. It
    returns the load, compute and save seconds and the loaded frame."""
    import torch

    import fugue_tpu_torch as ft
    from fugue_tpu_torch import col, functions as ff

    engine = ft.make_execution_engine(device=device,
                                      conf={"fugue.torch.io.batch_rows": batch_rows})

    def udf(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"k": a["k"], "v2": a["v"] * 0.5}

    def run_once() -> Tuple[Dict[str, float], Any]:
        t0 = time.perf_counter()
        df = engine.load_df(src, format_hint="parquet")
        df.blocks
        sync(device)
        t1 = time.perf_counter()
        tout = ft.transform(df, udf, schema="k:int,v2:float", engine=engine, as_fugue=True)
        agg = ft.aggregate(tout, partition_by="k", s=ff.sum(col("v2")), c=ff.count(col("v2")),
                           engine=engine, as_fugue=True)
        sync(device)
        t2 = time.perf_counter()
        engine.save_df(agg, out, format_hint="parquet")
        t3 = time.perf_counter()
        return {"load_secs": t1 - t0, "compute_secs": t2 - t1, "save_secs": t3 - t2,
                "total_secs": t3 - t0}, df

    return run_once, engine


def check_config5(label: str, out: str, want: Dict[str, Any]) -> float:
    """The saved file against float64 numpy: keys and counts exactly, sums
    within ``MAIN_PATH_RTOL``; returns the largest relative error."""
    import numpy as np
    import pyarrow.parquet as pq

    got = pq.read_table(out).to_pandas().sort_values("k")
    if list(got.columns) != ["k", "s", "c"] or not np.array_equal(got["k"], want["k"]) \
            or not np.array_equal(got["c"], want["c"]):
        raise SystemExit(f"FAIL {label}: keys or counts differ from numpy's")
    s = got["s"].to_numpy(np.float64)
    rel = float(np.max(np.abs(s - want["s"]) / np.abs(want["s"])))
    if not (np.all(np.isfinite(s)) and rel <= MAIN_PATH_RTOL):
        raise SystemExit(f"FAIL {label}: sums off by rtol {rel}")
    return rel


def same_blocks(label: str, got: Any, want: Any) -> None:
    """Two loads of one file alike bit for bit: rows, columns, masks,
    stats, ``unique`` flags and dictionaries."""
    import torch

    if got.nrows != want.nrows or list(got.columns) != list(want.columns):
        raise SystemExit(f"FAIL {label}: rows or columns differ")
    for name, g in got.columns.items():
        w = want.columns[name]
        same = (g.pa_type == w.pa_type and torch.equal(g.data.view(torch.uint8),
                                                       w.data.view(torch.uint8))
                and (g.mask is None) == (w.mask is None)
                and (g.mask is None or torch.equal(g.mask, w.mask))
                and (g.stats, g.unique) == (w.stats, w.unique)
                and (g.dictionary is None) == (w.dictionary is None)
                and (g.dictionary is None or list(g.dictionary) == list(w.dictionary)))
        if not same:
            raise SystemExit(f"FAIL {label}: column {name} differs between the loads")


def copy_kinds(run_once: Callable[[], Any], device: Any) -> Dict[str, Any]:
    """One run under ``torch.profiler``: the copies between host and card
    it traced (name: count), and its device milliseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_once()
        sync(device)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"copies": {e.key: e.count for e in events if e.key.startswith("Memcpy")},
            "copy_ms": {e.key: e.self_device_time_total / 1e3 for e in events
                        if e.key.startswith("Memcpy")},
            "device_ms": sum(e.self_device_time_total for e in events) / 1e3}


def traced_config5(src: str, out: str, modes: Dict[str, int], tries: int = 3
                   ) -> Dict[str, Dict[str, Any]]:
    """``copy_kinds`` of a warm config 5 run (``build_config5``) of each
    mode of ``modes`` (name: batch rows), in one fresh process: a trace
    taken after other profiler sessions of one process can lose device
    events. A trace that lacks either pinned kind is taken again, up to
    ``tries`` times."""
    import os

    code = ("import json, torch, chip_smoke as cs\n"
            "d = torch.device('cuda', torch.cuda.current_device())\n"
            "traces = {}\n"
            f"for mode, batch_rows in {modes!r}.items():\n"
            f"    run = cs.build_config5(d, {src!r}, {out!r}, batch_rows)[0]\n"
            "    run()\n"
            f"    for _ in range({tries}):\n"
            "        traces[mode] = cs.copy_kinds(run, d)\n"
            "        if set(cs.PINNED_COPIES) <= set(traces[mode]['copies']):\n"
            "            break\n"
            "print(json.dumps(traces))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)), timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"FAIL the traced config 5 runs: {res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def config5_path(device: Any, rows: int, warm_runs: int, tmp: str) -> List[Dict[str, Any]]:
    """BASELINE config 5 at ``rows`` rows, eager and streamed
    (``build_config5``): the source written as ``bench.py:1019-1021``
    writes it, a cold and ``warm_runs`` warm runs of each with their phase
    seconds, every saved file against numpy (``check_config5``), each
    run's launches held to ``CONFIG5_LAUNCHES``, the streamed load's
    frame against the eager load's bit for bit (``same_blocks``), and a
    warm run's trace (``traced_config5``): on the card it must hold pinned
    copies of both directions and no other copy between host and card."""
    import os

    import numpy as np

    t = time.perf_counter()
    pdf = config5_frame(rows)
    src = os.path.join(tmp, f"src_{rows}.parquet")
    pdf.to_parquet(src)
    k = pdf["k"].to_numpy()
    v2 = pdf["v"].to_numpy() * np.float32(0.5)
    del pdf
    c = np.bincount(k, minlength=CONFIG5_GROUPS)
    s = np.bincount(k, weights=v2.astype(np.float64), minlength=CONFIG5_GROUPS)
    occ = np.nonzero(c)[0]
    want = {"k": occ.astype(np.int32), "c": c[occ], "s": s[occ]}
    del k, v2
    print(f"config5 {rows}: source written and numpy's answer in "
          f"{time.perf_counter() - t:.1f}s", flush=True)
    out_stats = []
    loads = {}
    for mode, batch_rows in (("eager", 0), ("streamed", config5_batch_rows(rows))):
        out = os.path.join(tmp, f"out_{mode}_{rows}.parquet")
        run_once, engine = build_config5(device, src, out, batch_rows)
        zero_launches()
        cold, frame = run_once()
        cold_launches = launch_counts()
        err = check_config5(f"config5 {mode} {rows}", out, want)
        loads[mode] = frame.blocks
        del frame
        zero_launches()
        warm = [run_once()[0] for _ in range(warm_runs)]
        warm_launches = launch_counts()
        err = max(err, check_config5(f"config5 {mode} {rows} warm", out, want))
        want_launches = dict.fromkeys(cold_launches, 0)
        if device.type == "cuda":  # on the CPU every kernel runs as its twin
            want_launches.update(CONFIG5_LAUNCHES)
        if cold_launches != want_launches or warm_launches != {
                k: n * warm_runs for k, n in want_launches.items()}:
            raise SystemExit(f"FAIL config5 {mode} {rows}: launched {cold_launches} (cold), "
                             f"{warm_launches} (warm), expected {want_launches} a run")
        if engine.fallbacks:
            raise SystemExit(f"FAIL config5 {mode} {rows}: refused {engine.fallbacks}")
        best = {p: min(w[p] for w in warm) for p in warm[0]}
        st: Dict[str, Any] = {
            "case": f"config5_{mode}", "rows": rows, "batch_rows": batch_rows,
            "cold": cold, "warm": warm, "best_warm": best,
            "rows_per_sec": rows / best["total_secs"], "max_rel_err_s": err,
            "launches": {k: n for k, n in cold_launches.items() if n},
        }
        out_stats.append(st)
        print(f"config5 {mode} {rows}: best warm {best}", flush=True)
        del run_once, engine
    same_blocks(f"config5 {rows}: the streamed load against the eager one", loads["streamed"],
                loads["eager"])
    del loads
    if device.type == "cuda":
        traces = traced_config5(src, os.path.join(tmp, f"out_traced_{rows}.parquet"),
                                {st["case"][len("config5_"):]: st["batch_rows"]
                                 for st in out_stats})
        for st in out_stats:
            trace = traces[st["case"][len("config5_"):]]
            host_copies = [name for name in trace["copies"] if "Device -> Device" not in name]
            if set(host_copies) != set(PINNED_COPIES):
                raise SystemExit(f"FAIL {st['case']} {rows}: a run copied {trace['copies']}, "
                                 f"expected only {PINNED_COPIES} between host and card")
            st.update(trace_copies=trace["copies"], device_ms=trace["device_ms"])
    os.remove(src)
    return out_stats


def mixed_io_table(rows: int) -> Any:
    """Every type the card holds, with nulls: a strictly increasing int64,
    an int32 key, a float64 with 5 % nulls, a string over values that first
    appear late, with nulls, a nullable bool, a timestamp, a date, a uint8
    and an int64 whose nulls are all in its last 1,000 rows (a mask first
    needed in a late batch)."""
    import numpy as np
    import pyarrow as pa

    rng = np.random.default_rng(CONFIG5_SEED)
    idx = np.arange(rows, dtype=np.int64)
    late = idx >= rows - 1_000
    names = np.array([f"name-{j:05d}" for j in range(20_000)], dtype=object)
    return pa.table({
        "i": pa.array(idx * 3 - 7),
        "k": pa.array(rng.integers(0, 1000, rows).astype(np.int32)),
        "f": pa.array(rng.random(rows), mask=rng.random(rows) < 0.05),
        "s": pa.array(names[np.minimum(idx // 100, 19_999)], mask=rng.random(rows) < 0.03,
                      type=pa.string()),
        "b": pa.array(rng.random(rows) < 0.5, mask=rng.random(rows) < 0.1),
        "t": pa.array(1_577_836_800_000_000 + idx * 1_000_003, type=pa.timestamp("us")),
        "d": pa.array((18_000 + idx % 3_000).astype(np.int32), type=pa.date32()),
        "u": pa.array(rng.integers(0, 256, rows).astype(np.uint8)),
        "li": pa.array(np.where(late, 0, idx), mask=late),
    })


def io_checks(device: Any, tmp: str) -> Dict[str, Any]:
    """The host boundary on the card at ``IO_CHECK_ROWS`` rows of
    ``mixed_io_table`` in parquet row groups of 250,000: the streamed load
    (batches of ``IO_CHECK_BATCH`` rows through the pinned slabs and the
    copy stream) against the eager load bit for bit; each load's export
    against the file; a filtered (masked) frame's export against arrow's
    filter of the file, with K10 launched once a ``gather.MAX_COLUMNS``
    columns; a first export's table
    unchanged after a second export of another frame; the
    pipelined save (chunks of ``IO_CHECK_BATCH`` rows) against the one-shot
    save, row groups at most ``IO_CHECK_BATCH``; and a ``head`` of the
    masked frame."""
    import os

    import numpy as np
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    import fugue_tpu_torch as ft
    from fugue_tpu_torch.kernels.gather import MAX_COLUMNS, gather_rows_cuda

    table = mixed_io_table(IO_CHECK_ROWS)
    src = os.path.join(tmp, "mixed.parquet")
    pq.write_table(table, src, row_group_size=250_000)
    eager = ft.make_execution_engine(device=device)
    streamed = ft.make_execution_engine(device=device,
                                        conf={"fugue.torch.io.batch_rows": IO_CHECK_BATCH})
    lazy = streamed.load_df(src)
    if not lazy.is_pending or lazy.count() != IO_CHECK_ROWS:
        raise SystemExit("FAIL io_checks: the streamed load is not lazy or miscounts")
    loaded = eager.load_df(src)
    same_blocks("io_checks: the streamed load against the eager one", lazy.blocks,
                loaded.blocks)
    for label, frame in (("eager", loaded), ("streamed", lazy)):
        if not frame.as_arrow().equals(table):
            raise SystemExit(f"FAIL io_checks: the {label} load's export differs from the file")
    masked = ft.filter(lazy, ft.col("k") < 300, engine=streamed, as_fugue=True)
    gather_rows_cuda.launches = 0
    first = masked.as_arrow()
    launched = gather_rows_cuda.launches
    want = table.filter(pc.less(table.column("k"), 300))
    if not first.equals(want):
        raise SystemExit("FAIL io_checks: the masked export differs from arrow's filter")
    # one K10 launch takes up to gather.MAX_COLUMNS columns with their masks
    launches = -(-table.num_columns // MAX_COLUMNS)
    if device.type == "cuda" and launched != launches:
        raise SystemExit(f"FAIL io_checks: the masked export launched K10 {launched} times, "
                         f"expected {launches}")
    kept = {name: np.array(first.column(name).to_numpy(zero_copy_only=False))
            for name in ("i", "k", "f", "t")}
    other = ft.filter(lazy, ft.col("k") >= 700, engine=streamed, as_fugue=True).as_arrow()
    if other.num_rows == 0 or any(
            not np.array_equal(first.column(n).to_numpy(zero_copy_only=False), v,
                               equal_nan=n == "f") for n, v in kept.items()):
        raise SystemExit("FAIL io_checks: a first export changed after a second export")
    head = masked.head(1_000).as_arrow()
    if not head.equals(want.slice(0, 1_000)):
        raise SystemExit("FAIL io_checks: the masked frame's head differs")
    piped, one_shot = os.path.join(tmp, "piped.parquet"), os.path.join(tmp, "one.parquet")
    streamed.save_df(loaded, piped)
    ft.make_execution_engine(device=device, conf={"fugue.torch.io.batch_rows": IO_CHECK_BATCH,
                                                  "fugue.torch.io.pipeline": False}
                             ).save_df(loaded, one_shot)
    md = pq.ParquetFile(piped).metadata
    groups = [md.row_group(g).num_rows for g in range(md.num_row_groups)]
    if not pq.read_table(piped).equals(pq.read_table(one_shot)) or \
            not pq.read_table(piped).equals(table) or max(groups) > IO_CHECK_BATCH:
        raise SystemExit(f"FAIL io_checks: the pipelined save differs (row groups {groups})")
    for f in (src, piped, one_shot):
        os.remove(f)
    return {"rows": IO_CHECK_ROWS, "batch_rows": IO_CHECK_BATCH, "masked_rows": first.num_rows,
            "piped_row_groups": len(groups), "fallbacks": {**eager.fallbacks,
                                                           **streamed.fallbacks}}


def io_paths(device: Any, sizes: Tuple[int, ...], warm_runs: int) -> List[Dict[str, Any]]:
    """``io_checks``, then ``config5_path`` at each of ``sizes``, in a
    temporary directory on local disk that is removed afterwards."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="fugue_io_")
    try:
        t = time.perf_counter()
        checks = io_checks(device, tmp)
        checks["secs"] = time.perf_counter() - t
        print("io_checks: " + json.dumps(checks), flush=True)
        out: List[Dict[str, Any]] = []
        for rows in sizes:
            out += config5_path(device, rows, warm_runs, tmp)
            if device.type == "cuda":
                import torch

                torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


_ENTRY_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms")


# each kernel's launches in one run of the full group-by: by the key, the
# distinct (k, u) pairs take the word route and, above
# groupby.lookup_limit pairs, K3 (fewer pairs than that span fewer than
# 2^22 bins and take K1); K13 sets the DISTINCT argument's
# first-occurrence mask
FULL_GROUPBY_LAUNCHES = {
    # the keyed result's export: 12 columns, two K10 launches of up to
    # gather.MAX_COLUMNS = 8
    "keyed": dict(bin_factorize=1, sort_word=2, sort_word_boundaries=1, sort_finish=1,
                  binned_sums=2, segment_extrema=1, segment_sq_dev=1, first_row_mask=1,
                  gather_rows=2),
    "keyless": dict(bin_factorize=1, sort_word=1, binned_sums=2, segment_extrema=1,
                    segment_sq_dev=1, first_row_mask=1),
}


# ---- the types phase: uint16-64 and float16 through the kernels, host columns beside them ----

TYPES_GROUPS = 1024  # k: uint32 over 2^32 - 1024 .. 2^32 - 1
TYPES_DISTINCT = 1 << 16  # u: uint64, half of the values above 2^63
TYPES_JOIN_ROWS = 1_000_000  # the join's right side: unique u, every left value among them
TYPES_TAKE = 100
TYPES_HOST_ROWS = 10_000_000
TYPES_HOST_BATCH = 1_000_003  # the streamed load's batch rows: no divisor of the rows
TYPES_SIZES = (1, (1 << 20) + 37, ROWS)
# the types paths' launches: the binned aggregate (K1, the fused kernel, K4;
# its export adds K10), the sort-path count by u (the word route), the
# filter, the take (the top rows' word, their rank, K10 of the kept rows),
# the join (the right side's u factorized on the word route, K7, K8, K10 of
# the joined rows), alter_columns (one K6 launch for both casts)
TYPES_PATH_LAUNCHES = {
    "agg_by_k": dict(bin_factorize=1, binned_sums=1, segment_extrema=1),
    "count_by_u": dict(sort_word=1, sort_word_boundaries=1, sort_finish=1, binned_sums=1),
    "filter_u": dict(expr_program=1, expr_program_filter=1),
    "take_top_u": dict(presort_word=1, rank_keep=1, gather_rows=1),
    "join_u": dict(sort_word=1, sort_word_boundaries=1, sort_finish=1, join_build=1,
                   join_probe=1, gather_rows=1),
    "alter": dict(expr_program=1),
}


def types_data(rows: int, seed: int) -> Dict[str, Any]:
    """The types phase's facts from seed ``seed``: each row's group ``g``
    uniform over ``TYPES_GROUPS`` (``k = 2^32 - 1024 + g``, uint32), its
    index ``idx`` uniform over a table of ``TYPES_DISTINCT`` uint64 values,
    half of them above 2^63 (``u = table[idx]``), ``h`` float16 and ``v``
    float32 uniform over [0, 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    half = TYPES_DISTINCT // 2
    low = np.unique(rng.integers(1, 2**62, 2 * half, dtype=np.uint64))[:half]
    table = np.concatenate([low, rng.permutation(low) + np.uint64(2**63)])
    rng.shuffle(table)
    g = rng.integers(0, TYPES_GROUPS, rows).astype(np.uint16)
    idx = rng.integers(0, TYPES_DISTINCT, rows).astype(np.int32)
    return {"g": g, "k": g.astype(np.uint32) + np.uint32(2**32 - TYPES_GROUPS),
            "idx": idx, "table": table, "u": table[idx],
            "h": rng.random(rows, dtype=np.float32).astype(np.float16),
            "v": rng.random(rows, dtype=np.float32)}


def types_table(d: Dict[str, Any]) -> Any:
    import pyarrow as pa

    return pa.table({"k": pa.array(d["k"]), "u": pa.array(d["u"]), "h": pa.array(d["h"]),
                     "v": pa.array(d["v"])})


def types_oracle(d: Dict[str, Any]) -> Dict[str, Any]:
    """numpy's answers: per group (a radix sort of the uint16 group ids)
    its count, float64 sum of h, min and max of h and u, and u's int64
    sum as it wraps; the count of each table value and its position in
    the table's order."""
    import numpy as np

    g, h, u = d["g"], d["h"], d["u"]
    n = np.bincount(g, minlength=TYPES_GROUPS)
    order = np.argsort(g, kind="stable")
    starts = np.concatenate([[0], np.cumsum(n)[:-1]])
    hs, us = h[order], u[order]
    with np.errstate(over="ignore"):
        usum = np.add.reduceat(us.view(np.int64), starts)
    return {"n": n, "h_sum": np.bincount(g, weights=h.astype(np.float64), minlength=TYPES_GROUPS),
            "h_min": np.minimum.reduceat(hs, starts), "h_max": np.maximum.reduceat(hs, starts),
            "u_min": np.minimum.reduceat(us, starts), "u_max": np.maximum.reduceat(us, starts),
            "u_sum": usum, "u_counts": np.bincount(d["idx"], minlength=TYPES_DISTINCT)}


def half_ulp(x: Any) -> Any:
    """The float16 spacing at each value of ``x`` (float16)."""
    import numpy as np

    return np.spacing(np.abs(x.astype(np.float16))).astype(np.float64)


def _types_run(label: str, run: Callable[[], Any], want: Optional[Dict[str, int]]
               ) -> Tuple[Any, Dict[str, Any]]:
    """One types path: its result, seconds and launches (held to ``want``
    on the card, where given)."""
    zero_launches()
    t = time.perf_counter()
    out = run()
    secs = time.perf_counter() - t
    counts = {k: v for k, v in launch_counts().items() if v}
    if want is not None and counts != want:
        raise SystemExit(f"FAIL types {label}: launched {counts}, expected {want}")
    return out, {"case": label, "secs": secs, "launches": counts}


def types_paths(device: Any, rows: int, seed: int, join_rows: int = TYPES_JOIN_ROWS
                ) -> List[Dict[str, Any]]:
    """The types phase at ``rows`` rows (``types_data``) through the
    engine's entry points, each held against numpy: SUM/AVG/COUNT/MIN/MAX
    of h and u by k (the binned route), COUNT by u (the sort path's word
    route), a filter ``u > 2^63`` with its count, a top-100 take by u
    descending, an inner join on u against a ``join_rows``-row side, and
    ``alter_columns("k:long,h:float")``. Keys, counts, extrema and rows
    exactly; float16 sums within one float16 ulp of numpy's float64 sum
    rounded; AVG of h within ``MAIN_PATH_RTOL``."""
    import numpy as np
    import pyarrow as pa

    import fugue_tpu_torch as ft
    from fugue_tpu_torch import col
    from fugue_tpu_torch.column import functions as ff
    from fugue_tpu_torch.torch_backend import groupby

    cuda = device.type == "cuda"
    t = time.perf_counter()
    d = types_data(rows, seed)
    want = types_oracle(d)
    print(f"types: {rows} rows made and numpy's answers in {time.perf_counter() - t:.1f}s",
          flush=True)
    e = ft.make_execution_engine(device=device)
    frame, st = _types_run("upload", lambda: e.persist(types_table(d)), None)
    stats = [st]

    def agg() -> Any:
        return ft.aggregate(frame, "k", engine=e, as_fugue=True, n=ff.count(col("h")),
                            hs=ff.sum(col("h")), ha=ff.avg(col("h")), hmin=ff.min(col("h")),
                            hmax=ff.max(col("h")), us=ff.sum(col("u")), ua=ff.avg(col("u")),
                            umin=ff.min(col("u")), umax=ff.max(col("u"))).as_arrow()

    from fugue_tpu_torch.kernels.gather import MAX_COLUMNS

    # the masked result's export gathers its 10 columns (K10)
    got, st = _types_run("agg_by_k", agg, dict(TYPES_PATH_LAUNCHES["agg_by_k"],
                                               gather_rows=-(-10 // MAX_COLUMNS))
                         if cuda else None)
    occ = np.nonzero(want["n"])[0]
    out = {c: got.column(c).to_numpy(zero_copy_only=False) for c in got.column_names}
    if not np.array_equal(out["k"], (occ + (2**32 - TYPES_GROUPS)).astype(np.uint32)) or \
            not np.array_equal(out["n"], want["n"][occ]):
        raise SystemExit("FAIL types agg_by_k: keys or counts differ from numpy")
    for c in ("hmin", "hmax", "umin", "umax"):
        w = want[{"hmin": "h_min", "hmax": "h_max", "umin": "u_min", "umax": "u_max"}[c]][occ]
        if out[c].dtype != w.dtype or not np.array_equal(out[c], w):
            raise SystemExit(f"FAIL types agg_by_k: {c} differs from numpy")
    if not np.array_equal(out["us"], want["u_sum"][occ]):
        raise SystemExit("FAIL types agg_by_k: SUM(u) differs from numpy's wrapped int64 sum")
    if not np.array_equal(out["ua"], want["u_sum"][occ].astype(np.float64) / want["n"][occ]):
        raise SystemExit("FAIL types agg_by_k: AVG(u) differs from numpy")
    h16 = want["h_sum"][occ].astype(np.float16)
    h_err = np.abs(out["hs"].astype(np.float64) - h16.astype(np.float64))
    if out["hs"].dtype != np.float16 or bool((h_err > half_ulp(h16)).any()):
        raise SystemExit(f"FAIL types agg_by_k: SUM(h) off by {h_err.max()}")
    avg_rel = np.abs(out["ha"] / (want["h_sum"][occ] / want["n"][occ]) - 1)
    if bool((avg_rel > MAIN_PATH_RTOL).any()):
        raise SystemExit(f"FAIL types agg_by_k: AVG(h) rel err {avg_rel.max()}")
    st.update(groups=len(occ), h_sum_max_abs_err=float(h_err.max()),
              h_avg_max_rel_err=float(avg_rel.max()))
    stats.append(st)

    def count_by_u() -> Any:
        return ft.aggregate(frame, "u", engine=e, as_fugue=True, n=ff.count(col("*"))).as_arrow()

    got, st = _types_run("count_by_u", count_by_u,
                         TYPES_PATH_LAUNCHES["count_by_u"] if cuda else None)
    # the groups come in the order of the key codes (an int64 word's low
    # half first, as the JAX package orders them): compared by value
    order, gu = np.argsort(d["table"]), got.column("u").to_numpy()
    back = np.argsort(gu)
    if not np.array_equal(gu[back], d["table"][order]) or \
            not np.array_equal(got.column("n").to_numpy()[back], want["u_counts"][order]):
        raise SystemExit("FAIL types count_by_u: keys or counts differ from numpy")
    st["route"] = groupby.sort_factorize.last_route
    if cuda and st["route"] != "word64/scatter":
        raise SystemExit(f"FAIL types count_by_u: took the route {st['route']}")
    stats.append(st)

    above = int(want["u_counts"][d["table"] > np.uint64(2**63)].sum())
    got, st = _types_run("filter_u", lambda: ft.filter(
        frame, col("u") > 2**63, engine=e, as_fugue=True).count(),
        TYPES_PATH_LAUNCHES["filter_u"] if cuda else None)
    if got != above:
        raise SystemExit(f"FAIL types filter_u: {got} rows, numpy {above}")
    st["rows_kept"] = got
    stats.append(st)

    top = int(np.argmax(d["table"]))
    rows_top = np.nonzero(d["idx"] == top)[0][:TYPES_TAKE]
    if len(rows_top) < TYPES_TAKE:
        raise SystemExit("FAIL types take: the largest u has fewer rows than the take")
    got, st = _types_run("take_top_u", lambda: ft.take(
        frame, TYPES_TAKE, presort="u desc", engine=e, as_fugue=True).as_arrow(),
        TYPES_PATH_LAUNCHES["take_top_u"] if cuda else None)
    for c in ("k", "u", "h", "v"):
        if not np.array_equal(got.column(c).to_numpy(), d[c][rows_top]):
            raise SystemExit(f"FAIL types take_top_u: column {c} differs from numpy's rows")
    stats.append(st)

    rng = np.random.default_rng(seed + 1)
    extra = rng.integers(1, 2**64 - 1, 2 * join_rows, dtype=np.uint64)
    side = np.unique(np.concatenate([d["table"], extra[~np.isin(extra, d["table"])]]))
    side = np.sort(np.concatenate([d["table"], rng.choice(
        np.setdiff1d(side, d["table"]), join_rows - TYPES_DISTINCT, replace=False)]))
    right = pa.table({"u": pa.array(side), "r": pa.array(np.arange(len(side), dtype=np.int32))})
    pos = np.searchsorted(side, d["table"])
    want_r = int((want["u_counts"].astype(np.int64) * pos).sum())
    got, st = _types_run("join_u", lambda: ft.join(
        frame, right, how="inner", on=["u"], engine=e, as_fugue=True),
        TYPES_PATH_LAUNCHES["join_u"] if cuda else None)
    # every joined pair (u, r) is numpy's: r is u's position in the right
    # side, and each position is joined as often as its value is on the left
    pairs = got[["u", "r"]].as_arrow()
    ju, jr = pairs.column("u").to_numpy(), pairs.column("r").to_numpy()
    if len(jr) != rows or not np.array_equal(side[jr], ju) or not np.array_equal(
            np.bincount(jr, minlength=len(side))[pos], want["u_counts"]) or \
            int(jr.astype(np.int64).sum()) != want_r:
        raise SystemExit(f"FAIL types join_u: {len(jr)} rows ({rows} in numpy), or a (u, r) "
                         "pair or a position's count differs from numpy's")
    st["strategy"] = e.strategy_counts
    stats.append(st)
    del got, pairs, ju, jr

    got, st = _types_run("alter", lambda: frame.alter_columns("k:long,h:float"),
                         TYPES_PATH_LAUNCHES["alter"] if cuda else None)
    table = got[["k", "h"]].as_arrow()
    if str(got.schema) != "k:long,u:uint64,h:float,v:float" or \
            not np.array_equal(table.column("k").to_numpy(), d["k"].astype(np.int64)) or \
            not np.array_equal(table.column("h").to_numpy(), d["h"].astype(np.float32)):
        raise SystemExit(f"FAIL types alter: {got.schema} or its values differ from numpy")
    stats.append(st)
    if e.fallbacks:
        raise SystemExit(f"FAIL types: fell back {e.fallbacks}")
    return stats


def types_sku(device: Any, rows: int, seed: int) -> Dict[str, Any]:
    """Config 1's SKU column (``sku_frame``: 10,000 SKU numbers, 5 % nulls)
    as numeric text at ``rows`` rows: ``alter_columns`` to int (the
    dictionary parsed once on the host, one K6 LUT launch), then the int
    column back to str (factorized by K1, its 10,000 values formatted on
    the host, one K6 LUT launch), both against numpy."""
    import numpy as np
    import pyarrow as pa

    import fugue_tpu_torch as ft

    sk = sku_frame(rows, seed)
    names = [str(int(x)) for x in sk["nums"]]
    e = ft.make_execution_engine(device=device)
    frame = e.persist(pa.table({"s": _string_array(sk["codes"], sk["null"], names),
                                "v": sk["v"]}))
    cuda = device.type == "cuda"
    ints, st_int = _types_run("sku_to_int", lambda: frame.alter_columns("s:int"),
                              dict(expr_program=1) if cuda else None)
    got = ints[["s"]].as_arrow().column("s")
    want = sk["nums"][sk["codes"]].astype(np.int32)
    if got.null_count != int(sk["null"].sum()) or not np.array_equal(
            got.fill_null(0).to_numpy(), np.where(sk["null"], 0, want)):
        raise SystemExit("FAIL types sku_to_int: values differ from numpy")
    back, st_str = _types_run("sku_back_to_str", lambda: ints.alter_columns("s:str"),
                              dict(bin_factorize=1, expr_program=1) if cuda else None)
    text = back[["s"]].as_arrow().column("s").combine_chunks().dictionary_encode()
    table = np.asarray(text.dictionary.to_pylist(), dtype=object)
    codes = text.indices.to_numpy(zero_copy_only=False)
    valid = ~sk["null"]
    expect = np.asarray([str(int(x)) for x in sk["nums"]], dtype=object)[sk["codes"][valid]]
    if text.null_count != int(sk["null"].sum()) or \
            not np.array_equal(table[codes[valid].astype(np.int64)], expect):
        raise SystemExit("FAIL types sku_back_to_str: strings differ from numpy")
    st_str["dictionary"] = len(table)
    return {"case": "sku_alter", "rows": rows, "to_int": st_int, "back_to_str": st_str}


# alter_columns' routes on the card, each against pyarrow's cast: a string's
# dictionary cast into a LUT of each table dtype (float64, float16 through
# float32, bool, a timestamp's int64, a date's int32), a float64 and a
# uint64 stored as float16 (K6's HALF of an F64), a float16, a float64 and
# a uint64 to strings (floats factorized by their bits), an int32 to uint32
TYPES_ALTER = (("num", "double"), ("num", "float16"), ("flag", "bool"), ("ts", "datetime"),
               ("day", "date"), ("g", "float16"), ("u", "float16"), ("h", "str"), ("g", "str"),
               ("u", "str"), ("i", "uint32"))


def types_alter(device: Any) -> Dict[str, Any]:
    """Each of ``TYPES_ALTER`` over a few rows, on the card, against
    ``arrow_utils.cast_array`` (pyarrow's cast by ``cast_table``'s rules)
    value for value, NaN, -0.0 and nulls included; and a dictionary entry
    that casts to null (its rows' mask cleared by a second LUT)."""
    import numpy as np
    import pyarrow as pa
    import torch

    import fugue_tpu_torch as ft
    from fugue_tpu_torch.dataframe.arrow_utils import cast_array
    from fugue_tpu_torch.schema import Schema
    from fugue_tpu_torch.torch_backend.alter import alter_blocks
    from fugue_tpu_torch.torch_backend.blocks import TorchBlocks, TorchColumn

    sources = {
        "num": pa.array(["1.5", "2", None, "65504", "-0.0", "1.00048828125000001", "nan"]),
        "flag": pa.array(["true", "0", None, "FALSE", "1"]),
        "ts": pa.array(["2020-01-01 03:04:05", None, "1969-12-31 23:00:00"]),
        "day": pa.array(["2020-01-01", None, "2024-02-29"]),
        "g": pa.array([1 + 2**-11 + 2**-30, -0.0, None, 70000.0, 1e-8, 0.0, 65519.0,
                       float("nan")]),
        "u": pa.array([1, 2**63 + 5, None, 2**64 - 1, 65504], pa.uint64()),
        "h": pa.array([1.5, 60000, None, -0.0, 0.0, 6e-8, float("nan")], pa.float16()),
        "i": pa.array([1, -2, None, 2**31 - 1], pa.int32()),
    }
    e = ft.make_execution_engine(device=device)
    zero_launches()
    t = time.perf_counter()
    for src, dst in TYPES_ALTER:
        arr = sources[src]
        got = e.to_df(pa.table({"x": arr})).alter_columns(f"x:{dst}").as_arrow().column("x")
        want = cast_array(arr, Schema(f"x:{dst}").fields[0].type)
        if got.type != want.type or [str(v) for v in got.to_pylist()] != \
                [str(v) for v in want.to_pylist()]:
            raise SystemExit(f"FAIL types alter {src} -> {dst}: {got.to_pylist()}, pyarrow "
                             f"{want.to_pylist()}")
    codes = torch.tensor([0, 1, 2, 1, 0], dtype=torch.int32, device=device)
    blocks = TorchBlocks(5, {"x": TorchColumn(pa.string(), codes, None, (0, 2),
                                              dictionary=np.array(["1", None, "0"], object))},
                         device)
    out = alter_blocks(blocks, Schema("x:str"), Schema("x:double")).columns["x"]
    if out.mask is None or out.mask.tolist() != [True, False, True, False, True] or \
            out.data[out.mask].tolist() != [1.0, 0.0, 1.0]:
        raise SystemExit("FAIL types alter: a dictionary entry that casts to null")
    secs = time.perf_counter() - t
    return {"case": "alter_routes", "casts": len(TYPES_ALTER) + 1, "secs": secs,
            "launches": {k: v for k, v in launch_counts().items() if v}}


def host_columns_table(rows: int, seed: int) -> Any:
    """``TYPES_HOST_ROWS``-style frame: k uint32 and v float32 with a
    16-byte binary column (1 % nulls), a list<int32> of 0-3 items and a
    decimal(12,2), all built from buffers."""
    import numpy as np
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    valid = rng.random(rows) >= 0.01
    bits = pa.py_buffer(np.packbits(valid, bitorder="little"))
    offs = pa.py_buffer(np.arange(0, 16 * (rows + 1), 16, dtype=np.int32))
    blob = pa.Array.from_buffers(pa.binary(), rows, [bits, offs, pa.py_buffer(
        rng.bytes(16 * rows))], null_count=int((~valid).sum()))
    lens = rng.integers(0, 4, rows).astype(np.int32)
    loffs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    items = pa.array(rng.integers(-1000, 1000, int(loffs[-1])).astype(np.int32))
    lists = pa.ListArray.from_arrays(pa.array(loffs), items)
    unscaled = rng.integers(-10**11, 10**11, rows).astype(np.int64)
    words = np.stack([unscaled, unscaled >> 63], axis=1).reshape(-1)
    dec = pa.Array.from_buffers(pa.decimal128(12, 2), rows, [None, pa.py_buffer(words)])
    return pa.table({"k": pa.array(rng.integers(0, 2**32, rows, dtype=np.uint32)),
                     "v": pa.array(rng.random(rows, dtype=np.float32)),
                     "b": blob, "l": lists, "d": dec})


def types_host(device: Any, rows: int, seed: int, tmp: str) -> Dict[str, Any]:
    """Host columns beside device ones at ``rows`` rows: a filter on k,
    ``head(100)`` of the filtered frame, its ``as_arrow`` and a
    ``save_df``/``load_df`` round trip (eager, and streamed by
    ``TYPES_HOST_BATCH``-row batches), each against pyarrow's own
    ``filter`` and ``take`` of the source."""
    import os

    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    import fugue_tpu_torch as ft
    from fugue_tpu_torch import col

    table = host_columns_table(rows, seed)
    e = ft.make_execution_engine(device=device)
    frame = e.persist(table)
    keep = pc.greater(table.column("k"), pa.scalar(2**31, pa.uint32()))
    want = table.filter(keep)
    out, st = _types_run("host_filter", lambda: ft.filter(
        frame, col("k") > 2**31, engine=e, as_fugue=True), None)
    t = time.perf_counter()
    head = out.head(100).as_arrow()
    head_secs = time.perf_counter() - t
    if not head.equals(want.slice(0, 100)):
        raise SystemExit("FAIL types host_head: the filtered head differs from pyarrow's")
    t = time.perf_counter()
    full = out.as_arrow()
    export_secs = time.perf_counter() - t
    if not full.equals(want):
        raise SystemExit("FAIL types host_export: the filtered frame differs from pyarrow's")
    taken = want.take(pa.array(np.arange(0, want.num_rows, 997)))
    if not full.take(pa.array(np.arange(0, full.num_rows, 997))).equals(taken):
        raise SystemExit("FAIL types host_take: rows differ from pyarrow's take")
    path = os.path.join(tmp, "host_columns.parquet")
    t = time.perf_counter()
    e.save_df(out, path)
    save_secs = time.perf_counter() - t
    loads = {}
    for mode, batch in (("eager", 0), ("streamed", TYPES_HOST_BATCH)):
        le = ft.make_execution_engine(device=device, conf={"fugue.torch.io.batch_rows": batch})
        t = time.perf_counter()
        loaded = le.persist(le.load_df(path))
        loads[mode] = time.perf_counter() - t
        if not loaded.as_arrow().equals(want):
            raise SystemExit(f"FAIL types host_load_{mode}: the loaded frame differs")
    st.update(rows=rows, kept=want.num_rows, head_secs=head_secs, export_secs=export_secs,
              save_secs=save_secs, load_secs=loads)
    return st


def types_vs_twin(device: Any, sizes: Tuple[int, ...]) -> None:
    """Each kernel given a new dtype code against its twin at ``sizes``:
    the fused kernel's float16 payloads (sums within ``check_binned``'s
    bound), K4's float16 extrema bit for bit, K6's float16 loads, ``HALF``
    rounding and float16 stores (``h * 2``, ``h + h``, ``h < 0.5``, the
    uint64 compare and casts, and a float64 stored as float16, rounded
    once) bit for bit; and K1 and KW over the stored
    words of a uint32 key above 2^31 and a uint64 key above 2^63."""
    import pyarrow as pa
    import torch

    from fugue_tpu_torch import col
    from fugue_tpu_torch.kernels.factorize import bin_factorize_cuda, sort_word_cuda
    from fugue_tpu_torch.kernels.reference import (
        BinKey, Extremum, binned_sums_reference, bin_factorize_reference,
        segment_extrema_reference, sort_word_reference,
    )
    from fugue_tpu_torch.kernels.segment_reduce import segment_extrema_cuda
    from fugue_tpu_torch.kernels.segment_sums import binned_sums_cuda
    from fugue_tpu_torch.torch_backend.blocks import TorchBlocks, TorchColumn

    for n in sizes:
        gen = torch.Generator(device=device).manual_seed(SEED + n % 89)
        g = torch.randint(0, TYPES_GROUPS, (n,), generator=gen, device=device, dtype=torch.int32)
        h = torch.rand((n,), generator=gen, device=device).to(torch.float16)
        m = torch.rand((n,), generator=gen, device=device) < 0.9
        k = g.to(torch.int64) + (2**32 - TYPES_GROUPS)  # a uint32 as stored
        u = torch.randint(-2**63, 2**63 - 1, (n,), generator=gen, device=device,
                          dtype=torch.int64)  # uint64 words
        case = dict(keys=[BinKey(k, None, 2**32 - TYPES_GROUPS, TYPES_GROUPS)], nrows=n,
                    floats=[(h, None), (h, m)])
        check_binned(binned_sums_cuda(**case), binned_sums_reference(**case), case,
                     f"types binned_sums float16 n={n}")
        ecase = dict(seg=g, num=TYPES_GROUPS, payloads=[Extremum(h, m, True, True),
                                                         Extremum(u, None, True, True)], nrows=n)
        got, want = segment_extrema_cuda(**ecase), segment_extrema_reference(**ecase)
        for q in range(2):
            for a, b in ((got.mins[q], want.mins[q]), (got.maxs[q], want.maxs[q])):
                if a.dtype != b.dtype or not torch.equal(a.view(torch.int16) if
                                                         a.dtype == torch.float16 else a,
                                                         b.view(torch.int16) if
                                                         b.dtype == torch.float16 else b):
                    raise SystemExit(f"FAIL types segment_extrema payload {q} n={n}")
        bk = dict(keys=[BinKey(k, None, 2**32 - TYPES_GROUPS, TYPES_GROUPS)], nrows=n)
        for a, b in zip(bin_factorize_cuda(**bk), bin_factorize_reference(**bk)):
            if not torch.equal(a, b):
                raise SystemExit(f"FAIL types bin_factorize uint32 key n={n}")
        words = dict(keys=[(u, None)], nrows=n)
        a, b = sort_word_cuda(**words), sort_word_reference(**words)
        if not torch.equal(a.word, b.word):
            raise SystemExit(f"FAIL types sort_word uint64 key n={n}")
        # doubles over float16's range and past it, stored as float16
        # (rounded once: one in about 2^13 would round apart through float32)
        d = torch.randn((n,), generator=gen, device=device, dtype=torch.float64) * torch.exp2(
            torch.randint(-30, 18, (n,), generator=gen, device=device).to(torch.float64))
        blocks = TorchBlocks(n, {
            "h": TorchColumn(pa.float16(), h, m), "u": TorchColumn(pa.uint64(), u, None),
            "d": TorchColumn(pa.float64(), d, None)}, device)
        exprs = [(col("h") * 2).alias("x"), (col("h") + col("h")).alias("y"),
                 (col("h") < 0.5).alias("z"), (col("u") > 2**63).alias("w"),
                 col("u").cast("double").alias("f"), col("u").cast("long").alias("i")]
        _types_k6(blocks, exprs, n)
        _types_k6(blocks, [col("d").alias("q")], n, [torch.float16])
        del g, h, m, k, u, d, blocks
        print(f"ok types twins n={n}: binned_sums float16, segment_extrema float16 and uint64 "
              f"words, bin_factorize uint32, sort_word uint64, expr_program float16/uint64/"
              f"float64 to float16")
    torch.cuda.empty_cache()


def _types_k6(blocks: Any, exprs: List[Any], n: int, dts: Optional[List[Any]] = None) -> None:
    """K6 against its twin over ``blocks`` (float16, uint64 and float64
    columns) on ``exprs``, each output in its ``dts`` entry (default: its
    declared type), bit for bit."""
    import torch

    from fugue_tpu_torch.kernels.expr_program import compile_program, expr_program_cuda
    from fugue_tpu_torch.kernels.reference import expr_program_reference
    from fugue_tpu_torch.schema import Schema
    from fugue_tpu_torch.torch_backend.blocks import torch_dtype
    from fugue_tpu_torch.torch_backend.expr_eval import _columns

    schema = Schema([(name, c.pa_type) for name, c in blocks.columns.items()])
    dts = dts or [torch_dtype(e.infer_type(schema)) for e in exprs]
    prog = compile_program(exprs, dts, _columns(blocks), {}, blocks.device)
    inputs = [(blocks.columns[nm].data, blocks.columns[nm].mask) for nm, _ in prog.inputs]
    got = expr_program_cuda(prog, inputs, n, device=blocks.device)
    want = expr_program_reference(prog, inputs, n, device=blocks.device)
    for e, (gv, gm), (wv, wm) in zip(exprs, got, want):
        same_mask = (gm is None) == (wm is None) and (gm is None or torch.equal(gm, wm))
        bits = {torch.float16: torch.int16, torch.float32: torch.int32, torch.float64: torch.int64}
        a = gv.view(bits[gv.dtype]) if gv.dtype in bits else gv
        b = wv.view(bits[wv.dtype]) if wv.dtype in bits else wv
        if gv.dtype != wv.dtype or not same_mask or not torch.equal(a, b):
            raise SystemExit(f"FAIL types expr_program {e} n={n}: differs from the twin")


def types_timing(device: Any, launches: Dict[str, int]) -> List[Dict[str, Any]]:
    """The kernels given a new dtype code, timed at ``ROWS`` rows beside
    their existing dtype in turns (CUDA events): the fused kernel summing
    a float16 against a float32 payload by the headline key, K4's min and
    max of float16 against float32, K6's ``h * 2`` (float16 in and out,
    one ``HALF``) against ``v * 2`` (float32). Each entry's bound is its
    own bytes: the float16 ones read 2 B a row where float32 reads 4."""
    import pyarrow as pa
    import torch

    from fugue_tpu_torch import col
    from fugue_tpu_torch.kernels.expr_program import compile_program, expr_program_cuda
    from fugue_tpu_torch.kernels.reference import (
        BinKey, Extremum, binned_sums_reference, expr_program_reference,
        segment_extrema_reference,
    )
    from fugue_tpu_torch.kernels.segment_reduce import segment_extrema_cuda
    from fugue_tpu_torch.kernels.segment_sums import binned_sums_cuda

    n, total = ROWS, TYPES_GROUPS
    gen = torch.Generator(device=device).manual_seed(SEED)
    key = torch.randint(0, total, (n,), generator=gen, device=device, dtype=torch.int32)
    v = torch.rand((n,), generator=gen, device=device)
    h = v.to(torch.float16)
    out: List[Dict[str, Any]] = []
    pair: Dict[str, Dict[str, float]] = {}
    for name, payload in (("float16", h), ("float32", v)):
        case = dict(keys=[BinKey(key, None, 0, total)], nrows=n, floats=[(payload, None)])
        err = check_binned(binned_sums_cuda(**case), binned_sums_reference(**case), case,
                           f"types timing binned_sums {name}")
        ms = [time_cuda(lambda: binned_sums_cuda(**case), 20) for _ in range(2)]
        pair.setdefault("binned_sums", {})[name] = min(ms)
        if name == "float16":
            plain = time_cuda(lambda: binned_sums_reference(**case), 3)
            src = torch.stack([payload.float(), torch.ones_like(v)], dim=1)
            acc = torch.zeros((total, 2), dtype=torch.float32, device=device)
            lib = time_cuda(lambda: acc.zero_().index_add_(0, key, src), 5)
            del src
            out.append(_kernel_entry(
                "binned_sums_float16", "fugue_tpu/jax_backend/execution_engine.py:3500",
                launches.get("binned_sums_float16", 0), err, min(ms), plain,
                n * (4 + 2) + total * 8, n * 2, lib, source="segment_sums.cu"))
    seg = key
    for name, payload in (("float16", h), ("float32", v)):
        case = dict(seg=seg, num=total, payloads=[Extremum(payload, None, True, True)], nrows=n)
        got, want = segment_extrema_cuda(**case), segment_extrema_reference(**case)
        if not torch.equal(got.mins[0].float(), want.mins[0].float()) or \
                not torch.equal(got.maxs[0].float(), want.maxs[0].float()):
            raise SystemExit(f"FAIL types timing segment_extrema {name}")
        ms = [time_cuda(lambda: segment_extrema_cuda(**case), 20) for _ in range(2)]
        pair.setdefault("segment_extrema", {})[name] = min(ms)
        if name == "float16":
            plain = time_cuda(lambda: segment_extrema_reference(**case), 3)
            lib = time_cuda(lambda: torch.zeros((total,), dtype=torch.float16, device=device)
                            .scatter_reduce_(0, seg.long(), payload, "amin", include_self=False),
                            5)
            out.append(_kernel_entry(
                "segment_extrema_float16", "fugue_tpu/jax_backend/groupby.py:647",
                launches.get("segment_extrema_float16", 0), 0.0, min(ms), plain,
                n * (4 + 2) + total * 4, n * 2, lib, source="segment_reduce.cu"))
    from fugue_tpu_torch.torch_backend.blocks import TorchBlocks, TorchColumn

    blocks = TorchBlocks(n, {"h": TorchColumn(pa.float16(), h, None),
                             "v": TorchColumn(pa.float32(), v, None)}, device)
    for name, expr, dt in (("float16", col("h") * 2, torch.float16),
                           ("float32", col("v") * 2, torch.float32)):
        cols = {"h": (torch.float16, False), "v": (torch.float32, False)}
        prog = compile_program([expr], [dt], cols, {}, device)
        inputs = [(blocks.columns[nm].data, None) for nm, _ in prog.inputs]
        got = expr_program_cuda(prog, inputs, n, device=device)[0][0]
        want = expr_program_reference(prog, inputs, n, device=device)[0][0]
        if not torch.equal(got.float(), want.float()):
            raise SystemExit(f"FAIL types timing expr_program {name}")
        ms = [time_cuda(lambda: expr_program_cuda(prog, inputs, n, device=device), 20)
              for _ in range(2)]
        pair.setdefault("expr_program", {})[name] = min(ms)
        if name == "float16":
            plain = time_cuda(lambda: expr_program_reference(prog, inputs, n, device=device), 3)
            lib = time_cuda(lambda: h * 2, 5)
            out.append(_kernel_entry(
                "expr_program_float16", "fugue_tpu/jax_backend/expr_eval.py:109",
                launches.get("expr_program_float16", 0), 0.0, min(ms), plain, n * (2 + 2),
                n * 2, lib, source="expr_codegen.py"))
    print("types_timing: " + json.dumps({"rows": n, "ms_by_dtype": pair, "card": card_line()}))
    return out


def main() -> None:
    """Runs every phase on the card."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false")
    card = card_line()
    print(f"card: {card}")
    device = torch.device("cuda", torch.cuda.current_device())
    started = time.perf_counter()

    def lap(phase: str) -> None:
        print(f"phase: {phase} done at {time.perf_counter() - started:.1f}s", flush=True)

    from fugue_tpu_torch.kernels import build

    t = time.perf_counter()
    reports = build.build_all()
    print(f"build: {sorted(reports)} built in {time.perf_counter() - t:.1f}s")
    for stem, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {stem}: {line.strip()}")

    from fugue_tpu_torch.kernels.segment_sums import binned_sums_cuda

    worst = max(kernel_vs_twin(device), binned_vs_twin(device, binned_sums_cuda))
    print(f"kernels checked against their twins: binned_sums (max_abs_err={worst})")
    lap("twins: binned_sums")
    bin_factorize_vs_twin(device, (1, (1 << 20) + 37, 10_000_000))
    sort_vs_twin(device, (1, (1 << 20) + 37, 10_000_000, ROWS))
    sort_boundaries_edges(device)
    sort_finish_slab_cases(device)
    print("kernels checked against their twins: bin_factorize, sort_word, "
          "sort_word_boundaries, sort_word_lookup, sort_boundaries, sort_finish (also at its "
          "slabs' edges)")
    lap("twins: factorization")
    torch.cuda.empty_cache()
    worst = reduce_vs_twin(device, REDUCE_SIZES)
    print(f"kernels checked against their twins: segment_extrema (bit-equal), "
          f"segment_sq_dev (max rel err {worst})")
    torch.cuda.empty_cache()
    # at 100M rows each kernel is held against its twin where it is timed
    worst = expr_program_vs_twin(device, (1, (1 << 20) + 37, 10_000_000))
    print(f"kernels checked against their twins: expr_program (max_abs_err={worst})")
    lap("twins: segment reductions, expr_program")
    torch.cuda.empty_cache()
    lut_vs_twin(device, (1, (1 << 20) + 37, 10_000_000))
    print("kernels checked against their twins: expr_program's LUT family (equal)")
    k6_once = k6_build_once(device, (1 << 20) + 37)
    lap("twins: LUTs, K6 builds")
    torch.cuda.empty_cache()
    join_vs_twin(device, (1, (1 << 20) + 37, 10_000_000))
    print("kernels checked against their twins: join_build, join_probe, join_expand, "
          "gather_rows (equal)")
    lap("twins: joins")
    torch.cuda.empty_cache()
    row_select_vs_twin(device, (1, (1 << 20) + 37, 10_000_000))
    print("kernels checked against their twins: presort_word, rank_keep, first_row_mask, "
          "null_count_keep (equal)")
    print("dropna_copies: " + json.dumps(dropna_copies(device, 1 << 20)))
    lap("twins: row selection")
    torch.cuda.empty_cache()
    worst = window_vs_twin(device, (1, (1 << 20) + 37, 10_000_000))
    worst = max(worst, window_slab_cases(device))
    window_rank_edges(device)
    window_rank_timing(device, ROWS)
    print(f"kernels checked against their twins: window_rank, window_frame (equal, also at "
          f"their tiles' and slabs' edges; float64 frame sums max_abs_err={worst})")
    lap("twins: windows")
    torch.cuda.empty_cache()
    comap_vs_twin(device, (1, (1 << 20) + 37, 10_000_000))
    print("kernels checked against their twins: comap_presence, comap_rows (equal)")
    worst = stream_fold_vs_twin(device, (1, (1 << 20) + 37, STREAM_CHUNK_ROWS))
    torch.cuda.empty_cache()
    stream_fold_edges(device, STREAM_CHUNK_ROWS)
    print(f"kernels checked against their twins: stream_fold (equal, also at its edges; float64 "
          f"sums max rel err {worst})")
    lap("twins: co-map, stream fold")
    torch.cuda.empty_cache()
    types_vs_twin(device, TYPES_SIZES)
    print("kernels checked against their twins at their new dtypes: binned_sums (float16), "
          "segment_extrema (float16), expr_program (float16, HALF, uint64 words), "
          "bin_factorize (uint32 keys), sort_word (uint64 words)")
    lap("twins: new dtypes")
    torch.cuda.empty_cache()

    stats = main_path(device, ROWS, GROUPS, SEED, WARM_RUNS)
    # one aggregate per run, one fused-kernel launch per aggregate
    if stats["launches"]["binned_sums"] != 1 or stats["warm_launches"] != WARM_RUNS:
        raise SystemExit(
            f"FAIL: the main path launched binned_sums {stats['launches']} "
            f"(cold) and {stats['warm_launches']} times ({WARM_RUNS} warm runs)"
        )
    stats["card"] = card
    print("main_path: " + json.dumps(stats))
    lap("main path")
    torch.cuda.empty_cache()

    part = {}
    for rows in (CONFIG2_ROWS, ROWS):
        part[rows] = partitioned_transform(device, rows, WARM_RUNS)
        # the factorization runs once per frame: K1 once in the cold run,
        # then from the frame's cache
        if part[rows]["launches"]["bin_factorize"] != 1 or any(part[rows]["warm_launches"].values()):
            raise SystemExit(f"FAIL: the partitioned transform at {rows} rows launched "
                             f"{part[rows]['launches']} (cold), {part[rows]['warm_launches']} (warm)")
        part[rows]["card"] = card
        print("partitioned_transform: " + json.dumps(part[rows]))
        torch.cuda.empty_cache()

    lap("partitioned transform")
    # 1024 groups: the float32 key takes an int32 word, the int64 key an
    # int64 word, both K3w's shared-memory lookup; the key pair is too wide
    # for one word (K2 and K3). Float32 keys over the lookup's last group
    # count for int32 words (K3w, its table in shared memory) and twice it
    # (K3): both sides of the crossover.
    sort_stats = sort_path_aggregates(device, ROWS, GROUPS, SEED, WARM_RUNS,
                                      cases=("float_key", "int64_key", "wide_key"),
                                      split_cold=True)
    from fugue_tpu_torch.torch_backend import groupby

    for groups in (groupby.lookup_limit(4), 2 * groupby.lookup_limit(4)):
        torch.cuda.empty_cache()
        sort_stats += sort_path_aggregates(device, ROWS, groups, SEED, WARM_RUNS,
                                           cases=("float_key",), split_cold=True)
    for st in sort_stats:
        width = 4 if st["case"] == "float_key" else 8
        want_route = "wide"
        if st["case"] != "wide_key":
            k3 = "lookup" if st["groups"] <= groupby.lookup_limit(width) else "scatter"
            want_route = f"word{8 * width}/{k3}"
        want = dict.fromkeys(st["launches"], 0)
        want["binned_sums"] = 1
        if want_route == "wide":
            want.update(sort_boundaries=1, sort_finish=1)
        else:
            want.update(sort_word=1, sort_word_boundaries=1)
            want["sort_word_lookup" if k3 == "lookup" else "sort_finish"] = 1
        warm_want = {k: v * WARM_RUNS for k, v in want.items()}
        if st["route"] != want_route:
            raise SystemExit(f"FAIL: the sort-path aggregate {st['case']} over {st['groups']} "
                             f"groups took the route {st['route']}, expected {want_route}")
        if st["launches"] != want or st["warm_launches"] != warm_want:
            raise SystemExit(f"FAIL: the sort-path aggregate {st['case']} launched "
                             f"{st['launches']} (cold), {st['warm_launches']} (warm)")
        st["card"] = card
        print("sort_path_aggregate: " + json.dumps(st))
    lap("sort-path aggregates")
    torch.cuda.empty_cache()

    full = full_groupby(device, ROWS, GROUPS, DISTINCT_VALUES, SEED, WARM_RUNS, split_cold=True)
    for st in full:
        want = dict.fromkeys(st["launches"], 0)
        want.update(FULL_GROUPBY_LAUNCHES[st["case"]])
        warm_want = {k: v * WARM_RUNS for k, v in want.items()}
        if st["launches"] != want or st["warm_launches"] != warm_want:
            raise SystemExit(f"FAIL: the full group-by {st['case']} launched "
                             f"{st['launches']} (cold), {st['warm_launches']} (warm)")
        st["card"] = card
        print("full_groupby: " + json.dumps(st))
    lap("full group-by")
    torch.cuda.empty_cache()

    from fugue_tpu_torch.kernels.expr_program import expr_program_cuda

    k6_twin_builds = (expr_program_cuda.builds, expr_program_cuda.build_seconds)
    k6_paths = filtered_paths(device, ROWS, GROUPS, SEED, WARM_RUNS)
    k6_paths.append(config3_select(device, CONFIG3_ROWS, WARM_RUNS))
    for st in k6_paths:
        st["card"] = card
        print("k6_path: " + json.dumps(st))
    lap("K6 paths")
    torch.cuda.empty_cache()

    join_paths = [join_3b(device, rows, WARM_RUNS) for rows in (JOIN3B_ROWS, ROWS)]
    torch.cuda.empty_cache()
    join_paths.append(join_expand(device, JOIN_CHECK_ROWS, WARM_RUNS, row_for_row=True))
    torch.cuda.empty_cache()
    join_paths.append(join_expand(device, JOIN_EXPAND_ROWS, WARM_RUNS, row_for_row=False))
    torch.cuda.empty_cache()
    join_paths += join_kinds(device, JOIN_KINDS_ROWS, JOIN_CROSS_ROWS, WARM_RUNS)
    for st in join_paths:
        st["card"] = card
        print("join_path: " + json.dumps(st))
    lap("join paths")
    torch.cuda.empty_cache()

    str_paths = string_paths(device, ROWS, WARM_RUNS, config1_rows=(CONFIG1_ROWS, ROWS))
    for st in str_paths:
        st["card"] = card
        print("string_path: " + json.dumps(st))
    lap("string paths")
    torch.cuda.empty_cache()

    rel_paths = relational_paths(device, ROWS, WARM_RUNS)
    for st in rel_paths:
        st["card"] = card
        print("relational_path: " + json.dumps(st))
    lap("relational paths")
    torch.cuda.empty_cache()

    sql = {st["case"]: st for st in sql_paths(device, ROWS, NOT_IN_ROWS, WARM_RUNS)}
    print(f"sql_paths: {len(sql)} statements through raw_sql on {card}")
    lap("SQL statements")
    torch.cuda.empty_cache()

    zips = {st["case"]: st for st in zip_paths(device, (CONFIG4_GROUPS, CONFIG4_BIG_GROUPS),
                                               ZIP_ROWS, ZIP_CROSS_ROWS, WARM_RUNS)}
    for st in zips.values():
        st["card"] = card
        print("zip_path: " + json.dumps(st))
    torch.cuda.empty_cache()
    streamed = stream_path(device, STREAM_CHUNKS, STREAM_CHUNK_ROWS, STREAM_WARM_RUNS)
    streamed["card"] = card
    print("stream_path: " + json.dumps(streamed))
    lap("zip paths, streaming")
    torch.cuda.empty_cache()

    for st in io_paths(device, CONFIG5_ROWS, CONFIG5_WARM_RUNS):
        st["card"] = card
        print("io_path: " + json.dumps(st))
    lap("io paths")
    torch.cuda.empty_cache()

    types = types_paths(device, ROWS, SEED)
    for st in types:
        st["card"] = card
        print("types_path: " + json.dumps(st))
    torch.cuda.empty_cache()
    sku = types_sku(device, ROWS, STRING_SEED)
    sku["card"] = card
    print("types_sku: " + json.dumps(sku))
    alter = types_alter(device)
    alter["card"] = card
    print("types_alter: " + json.dumps(alter))
    torch.cuda.empty_cache()
    import os
    import tempfile

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        host = types_host(device, TYPES_HOST_ROWS, SEED, tmp)
    host["card"] = card
    print("types_host: " + json.dumps(host))
    lap("types")
    torch.cuda.empty_cache()

    stand_ins = stand_in_timing(device)
    stand_ins["card"] = card
    print("stand_ins: " + json.dumps(stand_ins))
    torch.cuda.empty_cache()
    entries = [kernel_timing(device, stats["launches"]["binned_sums"])]
    torch.cuda.empty_cache()
    entries += factorize_timing(device, {
        "bin_factorize": part[CONFIG2_ROWS]["launches"]["bin_factorize"],
        "sort_boundaries": sort_stats[2]["launches"]["sort_boundaries"],
        "sort_finish": sort_stats[2]["launches"]["sort_finish"],
        "sort_word": sort_stats[0]["launches"]["sort_word"],
        "sort_word_boundaries": sort_stats[0]["launches"]["sort_word_boundaries"],
        "sort_word_lookup": sort_stats[0]["launches"]["sort_word_lookup"],
    })
    torch.cuda.empty_cache()
    entries += reduce_timing(device, {
        f"{name}{suffix}": full[shape == "keyless"]["launches"][name]
        for name in ("segment_extrema", "segment_sq_dev")
        for shape, suffix in REDUCE_SHAPES.items()})
    torch.cuda.empty_cache()
    pipeline = k6_paths[0]["launches"]
    entries += expr_timing(device, {
        "columns": pipeline["expr_program"] - pipeline["expr_program_filter"],
        "filter": pipeline["expr_program_filter"]})
    torch.cuda.empty_cache()
    entries += join_timing(device, join_paths[3]["launches"])
    torch.cuda.empty_cache()
    by_case = {st["case"]: st["launches"] for st in str_paths}
    entries += lut_timing(device, {
        "like": by_case["string_groupby"]["expr_program_filter"],
        "length": by_case["string_upper_groupby"]["expr_program"],
        "canonicalize": by_case["string_upper_groupby"]["expr_program"],
        "harmonize": by_case["string_join"]["expr_program"],
    })
    torch.cuda.empty_cache()
    rel = {st["case"]: st["launches"] for st in rel_paths}
    entries += relational_timing(device, {
        "presort_word": rel["take_top_n"]["presort_word"],
        "rank_keep": rel["sample_n"]["rank_keep"],
        "rank_keep_take": rel["take_top_n"]["rank_keep"],
        "rank_keep_except_all": rel["except_all"]["rank_keep"],
        "first_row_mask": rel["distinct_pairs"]["first_row_mask"],
        "null_count_keep": rel["dropna_any"]["null_count_keep"],
        "expr_program_fillna": rel["fillna_scalar"]["expr_program"],
    })
    torch.cuda.empty_cache()
    entries.append(setop_boundaries_timing(device, rel["intersect_distinct"]["sort_boundaries"]))
    torch.cuda.empty_cache()
    entries += window_timing(device, {
        "window_rank": sql["q67_rank_top100"]["launches"]["window_rank"],
        "window_frame": sql["q51_running_sum"]["launches"]["window_frame"],
        "join_probe_not_in": sql["q16_not_in"]["launches"]["join_probe"],
    })
    torch.cuda.empty_cache()
    entries += comap_timing(device, zips["config4_inner_100m"]["launches"])
    torch.cuda.empty_cache()
    entries.append(stream_timing(device, streamed["launches"]["stream_fold"]))
    torch.cuda.empty_cache()
    by_types = {st["case"]: st["launches"] for st in types}
    entries += types_timing(device, {
        "binned_sums_float16": by_types["agg_by_k"].get("binned_sums", 0),
        "segment_extrema_float16": by_types["agg_by_k"].get("segment_extrema", 0),
        "expr_program_float16": by_types["alter"].get("expr_program", 0)})
    torch.cuda.empty_cache()
    k6_scaling(device)
    median_timing(device)
    torch.cuda.empty_cache()
    distinct_mask_timing(device)
    torch.cuda.empty_cache()
    order_scatter_timing(device, ROWS)
    k3_routes(device, ROWS)
    lap("timing")
    for entry in entries:
        times = [entry[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")
                 if entry[k] is not None]
        if not all(math.isfinite(t) for t in times):
            raise SystemExit(f"FAIL: a time of {entry['name']} is not finite")
        if entry["max_abs_err"] != 0 and not entry["name"].startswith((
                "binned_sums", "segment_sq_dev", "window_frame", "stream_fold")):
            raise SystemExit(f"FAIL: {entry['name']} differs from its twin at the timed shape")
    print("k6_builds: " + json.dumps({
        "builds": expr_program_cuda.builds, "build_secs": expr_program_cuda.build_seconds,
        "twin_check_builds": k6_twin_builds[0], "twin_check_build_secs": k6_twin_builds[1],
        "build_once": k6_once, "first_path": k6_paths[0]["case"],
        "first_path_cold_secs": k6_paths[0]["cold_secs"],
        "first_path_best_warm_secs": k6_paths[0]["best_warm_secs"],
        "first_path_builds": k6_paths[0]["k6_builds_cold"],
        "first_path_build_secs": k6_paths[0]["k6_build_secs_cold"], "card": card}))
    print(f"card: {card}")
    print(json.dumps({"kernels": entries}))
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
