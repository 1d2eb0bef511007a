"""A plain numpy model of K10 ``gather_rows``'s slab route as
``fugue_tpu_torch/kernels/gather.cu`` computes it, step by step, at a small
scale: source slabs of ``2^SRC_SHIFT`` rows, destination slabs of
``CLUSTER`` parts of ``2^PART_SHIFT`` rows, tiles of ``THREADS`` threads of
``ITEMS`` items and warps of ``WARP`` lanes, the tiles taken in a random
order (as a persistent wave's blocks finish in any order).

The steps modelled: step 1's count pass, scan and partition of the output
positions by source slab (``tile_slots`` with ``warp_rank_add``: a tile's
entries grouped by bucket, one run a bucket reserved from its cursor) into
entries ``idx << 32 | t``; step 2's pass over the entries in order for each
group of columns (``column_groups``: elements of at most 8 B a row, an
image row of at most 14 B), each entry's record, a header ``t's offset |
mask bit c << (DST_SHIFT + c)`` and its packed row, grouped by destination
slab into bucket s at slab s's rows; step 3's build of each destination
slab, its image of packed rows placed from the bucket by part and offset,
then each column and mask written out. The model is held against ``gather_rows_reference`` bit for bit
over ``chip_smoke.gather_cases``' kinds, and the callers are held to their
routes (``gather.gather_rows.last_route``)."""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pytest
import torch

import chip_smoke as cs
from fugue_tpu_torch.kernels import gather
from fugue_tpu_torch.kernels.reference import GatherColumn, gather_rows_reference

SRC_SHIFT = 4  # a source slab's rows (2^18 on the card)
PART_SHIFT = 2  # a block's part of a destination slab (2^14)
CLUSTER = 8
DST_SHIFT = PART_SHIFT + 3  # (2^17)
THREADS = 8  # a tile's threads (512)
ITEMS = 4  # items a thread (16)
WARP = 4  # lanes (32)
TILE = THREADS * ITEMS
GROUP_BYTES, IMAGE_ROW_BYTES = 8, 14


def tile_slots(buckets: np.ndarray, nb: int, reserve, rng: np.random.Generator
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``slab_partition.cuh``'s ``tile_slots`` for one tile: each item's
    slot in the tile's order by bucket (-1: none) and each bucket's
    position less its first slot. Within a bucket the items take their
    slots in the order their atomics land: a warp whose live lanes share a
    bucket in lane order (``warp_rank_add``), the rest in a random order."""
    n = len(buckets)
    local = np.full(n, -1, dtype=np.int64)
    hist = np.zeros(nb + 1, dtype=np.int64)
    # item k of thread th is index k * THREADS + th; a warp's lanes are
    # consecutive threads for one k
    groups = []
    for k in range(ITEMS):
        for w in range(THREADS // WARP):
            lanes = [k * THREADS + w * WARP + lane for lane in range(WARP)]
            lanes = [i for i in lanes if i < n]
            groups.append(lanes)
    rng.shuffle(groups)
    for lanes in groups:
        live = [i for i in lanes if buckets[i] >= 0]
        if not live:
            continue
        if len({int(buckets[i]) for i in live}) == 1:
            b = int(buckets[live[0]])
            for j, i in enumerate(live):
                local[i] = hist[b] + j
            hist[b] += len(live)
        else:
            for i in rng.permutation(live):
                local[i] = hist[buckets[i]]
                hist[buckets[i]] += 1
    start = np.concatenate([[0], np.cumsum(hist[:nb])])
    pos = np.where(buckets >= 0, start[np.maximum(buckets, 0)] + local, -1)
    base = np.zeros(nb, dtype=np.int64)
    for j in range(nb):
        c = int(hist[j])
        base[j] = (reserve(j, c) if c else 0) - start[j]
    return pos, base


def source_bucket(i: np.ndarray, src_rows: int, nb: int) -> np.ndarray:
    ok = (i >= 0) & (i < src_rows)
    return np.where(ok, i >> SRC_SHIFT, nb - 1)


def step1(idx: np.ndarray, src_rows: int, rng: np.random.Generator
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The entries by source slab, and the buckets' counts, starts and
    cursors."""
    n = len(idx)
    nb = -(-src_rows >> SRC_SHIFT) + 1
    counts = np.bincount(source_bucket(idx, src_rows, nb), minlength=nb)
    starts = np.concatenate([[0], np.cumsum(counts)])
    cursor = starts[:-1].copy()
    entries = np.zeros(n, dtype=np.uint64)
    tiles = list(range(0, n, TILE))
    rng.shuffle(tiles)
    for t0 in tiles:
        ts = np.array([t0 + k * THREADS + th for k in range(ITEMS) for th in range(THREADS)])
        ok = ts < n
        iv = np.where(ok, idx[np.minimum(ts, n - 1)], 0)
        b = np.where(ok, source_bucket(iv, src_rows, nb), -1)

        def reserve(j: int, c: int) -> int:
            at = int(cursor[j])
            cursor[j] += c
            return at

        pos, base = tile_slots(b, nb, reserve, rng)
        stage = np.zeros(TILE, dtype=np.uint64)
        live = pos >= 0
        stage[pos[live]] = ((iv[live].astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)
                            << np.uint64(32)) | ts[live].astype(np.uint64)
        for j in range(int(live.sum())):
            e = int(stage[j])
            i = (e >> 32) - (1 << 32 if e >> 63 else 0)  # idx[t] as int32
            s = int(source_bucket(np.array([i]), src_rows, nb)[0])
            at = int(base[s]) + j
            if at < starts[s + 1]:
                entries[at] = e
    return entries, counts, starts, cursor


def column_groups(widths: Sequence[int], masked: Sequence[bool]) -> List[Tuple[int, int]]:
    """``group_end``'s groups (column ranges): elements of at most 8 B a
    row, and an image row (the packed elements, 4 or 8 B, and a mask byte
    a masked column) of at most 14 B."""
    out, g0 = [], 0
    while g0 < len(widths):
        g1, used, masks = g0, 0, 0
        while g1 < len(widths):
            w, m = used + widths[g1], masks + masked[g1]
            if w > GROUP_BYTES or (8 if w > 4 else 4) + m > IMAGE_ROW_BYTES:
                break
            used, masks, g1 = w, m, g1 + 1
        out.append((g0, g1))
        g0 = g1
    return out


def _bits(values: np.ndarray) -> np.ndarray:
    """Elements as unsigned integers of their width."""
    return values.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[
        values.dtype.itemsize]).astype(np.uint64)


def step2(entries: np.ndarray, cols: List[Tuple[np.ndarray, Optional[np.ndarray], bool]],
          rng: np.random.Generator) -> Tuple[List[Tuple[int, int]], np.ndarray]:
    """One group: each entry's record (header, packed row) in its
    destination slab's bucket; returns the records and each bucket's
    fill."""
    n = len(entries)
    ndst = -(-n >> DST_SHIFT)
    fill = np.zeros(ndst, dtype=np.int64)
    recs: List[Tuple[int, int]] = [(-1, -1)] * n
    shifts = np.cumsum([0] + [8 * d.dtype.itemsize for d, _, _ in cols])
    tiles = list(range(0, n, TILE))
    rng.shuffle(tiles)
    for t0 in tiles:
        js = np.array([t0 + k * THREADS + th for k in range(ITEMS) for th in range(THREADS)])
        ok = js < n
        e = np.where(ok, entries[np.minimum(js, n - 1)], np.uint64(0))
        t = (e & np.uint64(0xFFFFFFFF)).astype(np.int64)
        b = np.where(ok, t >> DST_SHIFT, -1)

        def reserve(s: int, c: int) -> int:
            at = (s << DST_SHIFT) + int(fill[s])
            fill[s] += c
            return at

        pos, base = tile_slots(b, ndst, reserve, rng)
        i = (e >> np.uint64(32)).astype(np.int64)  # 2^32 - 1 for -1: past every column
        bits = np.zeros(len(e), dtype=np.int64)
        row = np.zeros(len(e), dtype=np.uint64)
        for c, (data, mask, masked) in enumerate(cols):
            hit = (pos >= 0) & (i < len(data))
            safe = np.where(hit, i, 0)
            v = np.where(hit, _bits(data)[safe], np.uint64(0))
            row |= v << np.uint64(shifts[c])
            okm = hit & (np.ones(len(e), bool) if mask is None else mask[safe])
            if masked:
                bits |= okm.astype(np.int64) << c
        total = int((pos >= 0).sum())
        order = np.empty(total, dtype=np.int64)
        order[pos[pos >= 0]] = np.nonzero(pos >= 0)[0]  # slot -> item
        for j in range(total):
            item = order[j]
            s = int(t[item]) >> DST_SHIFT
            at = int(base[s]) + j
            assert at - (s << DST_SHIFT) < min(n - (s << DST_SHIFT), 1 << DST_SHIFT)
            h = (int(t[item]) & ((1 << DST_SHIFT) - 1)) | int(bits[item]) << DST_SHIFT
            recs[at] = (h, int(row[item]))
    return recs, fill


def step3(recs: List[Tuple[int, int]], fill: np.ndarray, outs: List[np.ndarray],
          out_masks: List[Optional[np.ndarray]]) -> None:
    """One group's build: each destination slab's image of packed rows
    from its bucket's records, then each column and mask written out."""
    n = len(recs)
    part = 1 << PART_SHIFT
    shifts = np.cumsum([0] + [8 * o.dtype.itemsize for o in outs])
    for slab in range(len(fill)):
        r0 = slab << DST_SHIFT
        rows = min(n - r0, 1 << DST_SHIFT)
        assert fill[slab] == rows  # FUGUE_DEBUG_SLABS' check
        img = np.zeros(CLUSTER * part, dtype=np.uint64)
        mimgs = [np.ones(CLUSTER * part, dtype=bool) for _ in outs]
        placed = np.zeros(CLUSTER * part, dtype=np.int64)
        for e in range(int(fill[slab])):
            h, row = recs[r0 + e]
            off = h & ((1 << DST_SHIFT) - 1)
            at = (off >> PART_SHIFT) * part + (off & (part - 1))
            img[at] = row
            for c in range(len(outs)):
                if out_masks[c] is not None and not (h >> (DST_SHIFT + c)) & 1:
                    mimgs[c][at] = False
            placed[at] += 1
        assert (placed[:rows] == 1).all()  # the positions are a permutation
        for c, o in enumerate(outs):
            width = o.dtype.itemsize
            vals = (img[:rows] >> np.uint64(shifts[c])) & np.uint64((1 << (8 * width)) - 1)
            unsigned = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[width]
            o.view(unsigned)[r0:r0 + rows] = vals
            if out_masks[c] is not None:
                out_masks[c][r0:r0 + rows] = mimgs[c][:rows]


def slab_model(columns: Sequence[GatherColumn], idx: torch.Tensor, outer: bool, seed: int,
               record: Optional[Dict] = None) -> List[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """The slab route's outputs, step by step, ``MAX_COLUMNS`` columns a
    launch as the wrapper calls it; ``record`` gets the last group's
    ``fill`` and step 1's ``sources`` (counts, starts, cursor)."""
    rng = np.random.default_rng(seed)
    idx_np = idx.numpy().astype(np.int64)
    n = len(idx_np)
    src_rows = max(int(c.values.shape[0]) for c in columns)
    entries, counts, starts, cursor = step1(idx_np, src_rows, rng)
    assert (cursor == starts[1:]).all() and counts.sum() == n
    if record is not None:
        record["sources"] = (counts, starts, cursor)
    outs: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
    cols = [(c.values.numpy(), None if c.mask is None else c.mask.numpy()) for c in columns]
    for lo in range(0, len(cols), gather.MAX_COLUMNS):
        part = cols[lo:lo + gather.MAX_COLUMNS]
        masked = [m is not None or outer for _, m in part]
        out = [np.zeros(n, dtype=d.dtype) for d, _ in part]
        out_m = [np.zeros(n, dtype=bool) if mk else None for mk in masked]
        widths = [d.dtype.itemsize for d, _ in part]
        for g in column_groups(widths, masked):
            recs, fill = step2(entries, [(part[c][0], part[c][1], masked[c]) for c in range(*g)],
                               rng)
            if record is not None:
                record["fill"] = fill
            step3(recs, fill, [out[c] for c in range(*g)], [out_m[c] for c in range(*g)])
        outs += list(zip(out, out_m))
    return outs


def _same(got: Tuple[np.ndarray, Optional[np.ndarray]], want: Tuple[torch.Tensor, Optional[torch.Tensor]],
          label: str) -> None:
    gv, gm = got
    wv, wm = want
    assert gv.dtype == wv.numpy().dtype, label
    assert gv.tobytes() == wv.numpy().tobytes(), label
    assert (gm is None) == (wm is None), label
    if gm is not None:
        assert np.array_equal(gm, wm.numpy()), label


def model_cases(n: int, seed: int) -> List[Tuple[str, Dict]]:
    """``chip_smoke.gather_cases`` on the CPU, with the scattered ones."""
    return [(label, case) for label, case in cs.gather_cases(torch.device("cpu"), n, seed)]


@pytest.mark.parametrize("n", [1, 31, 33, TILE - 1, TILE + 1, (1 << DST_SHIFT) - 1,
                               1 << DST_SHIFT, 3 * (1 << DST_SHIFT) + 17, 301])
@pytest.mark.parametrize("case", range(7))
def test_slab_model_matches_the_twin(n: int, case: int) -> None:
    label, c = model_cases(n, 1000 + n)[case]
    got = slab_model(c["columns"], c["idx"], c["outer"], seed=n + case)
    want = gather_rows_reference(c["columns"], c["idx"], outer=c["outer"])
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"{label} n={n} column {j}")


def test_slab_model_permutations_with_small_sources() -> None:
    rng = np.random.default_rng(3)
    for n, src in ((200, 37), (257, 500), (64, 64)):
        idx = torch.from_numpy(rng.integers(-1, src, n).astype(np.int32))
        cols = [GatherColumn(torch.from_numpy(rng.integers(0, 255, src).astype(np.uint8)),
                             torch.from_numpy(rng.random(src) < 0.5)),
                GatherColumn(torch.from_numpy(rng.random(src)), None)]
        for outer in (False, True):
            got = slab_model(cols, idx, outer, seed=n)
            want = gather_rows_reference(cols, idx, outer=outer)
            for j, (g, w) in enumerate(zip(got, want)):
                _same(g, w, f"n={n} src={src} outer={outer} column {j}")


@pytest.mark.parametrize("widths,masked,groups", [
    ([8, 8], [False, False], [(0, 1), (1, 2)]),
    ([4, 4], [False, False], [(0, 2)]),
    ([4, 4], [True, True], [(0, 2)]),
    ([2, 1, 1, 4], [True, False, True, False], [(0, 4)]),
    ([2, 2, 4, 1], [True] * 4, [(0, 3), (3, 4)]),
    ([1, 1, 1, 1, 1, 1, 1, 1], [True] * 8, [(0, 6), (6, 8)]),
    ([1, 1, 1, 2, 4, 8, 4, 8], [True] * 8, [(0, 4), (4, 5), (5, 6), (6, 7), (7, 8)]),
])
def test_column_groups(widths: List[int], masked: List[bool],
                       groups: List[Tuple[int, int]]) -> None:
    assert column_groups(widths, masked) == groups


def _routes(monkeypatch: pytest.MonkeyPatch) -> List[str]:
    """Every K10 call's route from here on, with the route's thresholds at
    0 so that the callers' own flags decide."""
    monkeypatch.setattr(gather, "L2_DIRECT_BYTES", 0)
    monkeypatch.setattr(gather, "SLAB_MIN_ROWS", 0)
    seen: List[str] = []
    twin = gather.gather_rows_reference

    def record(columns, idx, *, outer=False):
        seen.append(gather.gather_rows.last_route)
        return twin(columns, idx, outer=outer)

    monkeypatch.setattr(gather, "gather_rows_reference", record)
    return seen


def test_callers_pick_the_route(monkeypatch: pytest.MonkeyPatch) -> None:
    """Scattered: the repartitions (hash and random), ORDER BY, the
    expansion join's right side; in order: sample with replacement, the
    expansion join's left side, the unique right side's dimension gather,
    the window's whole-partition aggregate."""
    import pandas as pd

    import fugue_tpu_torch as ft
    from fugue_tpu_torch.collections.partition import PartitionSpec
    from fugue_tpu_torch.torch_backend import relational

    seen = _routes(monkeypatch)
    rng = np.random.default_rng(1)
    e = ft.make_execution_engine(device="cpu")
    df = e.to_df(pd.DataFrame({"k": rng.integers(0, 50, 1000).astype(np.int32),
                               "v": rng.random(1000).astype(np.float32)}))
    e.repartition(df, PartitionSpec({"algo": "hash", "num": 4, "by": ["k"]}))
    e.repartition(df, PartitionSpec({"algo": "rand", "num": 4}))
    assert seen == ["slab", "slab"]
    del seen[:]
    e.sample(df, n=100, replace=True, seed=0)
    assert seen == ["direct"]
    del seen[:]
    relational.device_sort(df.blocks, [("v", True, None)])
    assert seen == ["slab"]
    del seen[:]
    right = pd.DataFrame({"k": rng.integers(0, 50, 300).astype(np.int32),
                          "w": rng.random(300).astype(np.float32),
                          "x": rng.integers(0, 9, 300).astype(np.int32)})
    e.join(df, right, how="inner", on=["k"])
    assert seen == ["direct", "slab"]  # the left side by li in order, the right by ri
    del seen[:]
    e.join(df, right[["k", "w"]], how="inner", on=["k"])
    assert seen == ["direct", "direct"]  # one column: no pass packs two
    del seen[:]
    dims = pd.DataFrame({"k": np.arange(50, dtype=np.int32), "w": rng.random(50),
                         "x": rng.random(50).astype(np.float32)})
    e.join(df, dims, how="inner", on=["k"])
    assert seen == ["direct"]
    del seen[:]
    ft.raw_sql("SELECT k, v, AVG(v) OVER (PARTITION BY k) AS a FROM", df, engine=e)
    assert seen == ["direct"]


def test_route_thresholds() -> None:
    def cols(rows: int, masked: bool, *dtypes: torch.dtype) -> List[GatherColumn]:
        return [GatherColumn(torch.zeros(rows, dtype=d),
                             torch.ones(rows, dtype=torch.bool) if masked else None)
                for d in dtypes]

    kv = cols(1 << 21, False, torch.int32, torch.float32)  # 16 MB: not above
    assert gather.gather_route(kv, 1 << 20, True) == "direct"
    kv = cols(1 << 21, True, torch.int32, torch.float32)
    assert gather.gather_route(kv, 1 << 20, True) == "slab"
    assert gather.gather_route(kv, 1 << 20, False) == "direct"
    assert gather.gather_route(kv, (1 << 17) - 1, True) == "direct"
    # one 8-byte column, or two that no pass packs together
    assert gather.gather_route(cols(1 << 22, True, torch.int64), 1 << 20, True) == "direct"
    assert gather.gather_route(cols(1 << 22, False, torch.int64, torch.float64), 1 << 20,
                               True) == "direct"
    assert gather.gather_route(cols(1 << 22, False, *[torch.int64] * 8, torch.int32,
                                    torch.int32), 1 << 20, True) == "slab"


def test_the_python_groups_match_the_model() -> None:
    rng = np.random.default_rng(9)
    for _ in range(200):
        k = int(rng.integers(1, 20))
        widths = [int(w) for w in rng.choice([1, 2, 4, 8], k)]
        masked = [bool(m) for m in rng.random(k) < 0.5]
        want = []
        for lo in range(0, k, gather.MAX_COLUMNS):
            hi = min(lo + gather.MAX_COLUMNS, k)
            want += [(g0 + lo, g1 + lo) for g0, g1 in column_groups(widths[lo:hi], masked[lo:hi])]
        assert gather.column_groups(widths, masked) == want


def model_kernel(monkeypatch: pytest.MonkeyPatch) -> None:
    """``gather.gather_rows_cuda`` replaced by the model on its slab route
    (thresholds lowered so that small cases take it) and the twin on its
    direct route, with the wrapper's ``last_*`` attributes."""
    monkeypatch.setattr(gather, "L2_DIRECT_BYTES", 4096)
    monkeypatch.setattr(gather, "SLAB_MIN_ROWS", 64)

    def kernel(columns, idx, *, outer=False, scattered=False):
        route = gather.gather_route(columns, int(idx.shape[0]), scattered, outer)
        kernel.last_route = route
        kernel.launches += -(-len(columns) // gather.MAX_COLUMNS)
        if route == "direct":
            return gather_rows_reference(columns, idx, outer=outer)
        rec: Dict = {}
        outs = slab_model(columns, idx, outer, seed=int(idx.shape[0]), record=rec)
        kernel.last_fill = torch.from_numpy(rec["fill"].astype(np.int32))
        kernel.last_shift = (SRC_SHIFT, DST_SHIFT)
        kernel.last_sources = gather.SlabSources(*(torch.from_numpy(a.astype(np.int32))
                                                   for a in rec["sources"]))
        return [(torch.from_numpy(v), None if m is None else torch.from_numpy(m))
                for v, m in outs]

    kernel.launches = 0
    monkeypatch.setattr(gather, "gather_rows_cuda", kernel)


def test_chip_smoke_gather_cases_on_cpu(monkeypatch: pytest.MonkeyPatch, capsys) -> None:
    """``chip_smoke.join_vs_twin``'s K10 part (routes, ``check_fill``,
    ``check_buckets``, the twin) with the model as the kernel, and K7-K9's
    twins as theirs."""
    from fugue_tpu_torch.kernels import join, reference

    model_kernel(monkeypatch)

    def build(*a, **kw):
        build.last_path = "shared"
        return reference.join_build_reference(*a, **kw)

    monkeypatch.setattr(join, "join_build_cuda", build)
    monkeypatch.setattr(join, "join_probe_cuda", reference.join_probe_reference)
    monkeypatch.setattr(join, "join_expand_cuda",
                        lambda *a, **kw: reference.join_expand_reference(*a, **kw))
    monkeypatch.setattr(cs, "JOIN_SIDE_SEGMENTS", (1, 7))
    monkeypatch.setattr(cs, "JOIN_SKEW", 10)
    monkeypatch.setattr(cs, "JOIN_CROSS_ROWS", (30, 7))
    cs.join_vs_twin(torch.device("cpu"), (1, 200))
    out = capsys.readouterr().out
    assert "gather_rows n=200 a random permutation: 16 columns equal (slab route)" in out
    assert "gather_rows n=200 a source under L2: 2 columns equal (direct route)" in out
    assert "gather_rows n=200 index in range, in order: 16 columns equal (direct route)" in out
