"""A plain numpy model of K7 ``join_build``'s slab route as
``fugue_tpu_torch/kernels/join.cu`` computes it, step by step, at a small
scale: slabs of ``2^SEG_SHIFT`` segments each held by a block, tiles of
``THREADS`` threads of ``ITEMS`` rows with warps of ``WARP`` lanes, pieces
of at most ``PIECE`` entries, the tiles and the pieces taken in a random
order.

The global route (between the shared and the slab routes) is modelled
too: each run head updates the table once. The slab route's steps
modelled: the count pass (``run_head``: a warp's lanes hold
consecutive rows, and a run of equal segments among them makes one entry,
its head; each slab's heads counted, and NOT IN's side counts), the plan
(each bucket's start, its pieces, which slabs have several), the partition
of the heads into 4-byte entries ``offset | (run - 1) << SEG_SHIFT`` or
8-byte ``highest row << 32 | offset`` (``test_torch_gather_model``'s
``tile_slots``), and the build: each piece's image of its slab, a warp of
equal entries folded into one update, written with stores where the slab
is one piece and merged into a filled table with atomics where it is
several.
Held against ``join_build_reference`` bit for bit over
``chip_smoke.join_side_cases``' kinds (and slot mode, NOT IN's side counts,
nullable keys, ``row_valid``) at small n, with ``SEG_SHIFT`` small so that
their segment counts span several slabs."""

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pytest
import torch

import chip_smoke as cs
from fugue_tpu_torch.kernels.join import SEG_SHIFT as SEG_SHIFT_CARD, SHARED_MAX
from fugue_tpu_torch.kernels.reference import join_build_reference
from test_torch_gather_model import tile_slots

SEG_SHIFT = 6  # segments a slab (2^15 on the card)
PIECE = 40  # a block's entries, at most (2^18)
THREADS = 8  # (512)
ITEMS = 4  # (16)
WARP = 4  # (32)
TILE = THREADS * ITEMS


def side_rows(seg: np.ndarray, num: int, nrows: Optional[int], row_valid: Optional[np.ndarray],
              nulls: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """``side_row`` of every row: real, and the segment where matchable
    (-1 else)."""
    n = len(seg)
    real = np.arange(n) < nrows if nrows is not None else row_valid != 0
    null = np.zeros(n, bool) if nulls is None else nulls
    ok = real & ~null & (seg >= 0) & (seg < num)
    return real, np.where(ok, seg, -1)


def run_heads(s: np.ndarray, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``run_head`` over one warp's lanes (rows ``rows``, segments ``s``, -1
    none): each lane's segment where it heads a run, and the run's length."""
    heads = np.full(len(s), -1)
    lens = np.zeros(len(s), dtype=np.int64)
    for lane in range(len(s)):
        if s[lane] < 0 or (lane > 0 and s[lane - 1] == s[lane]):
            continue
        end = lane + 1
        while end < len(s) and s[end] == s[lane]:
            end += 1
        heads[lane], lens[lane] = s[lane], end - lane
    return heads, lens


def tile_heads(segs: np.ndarray, t0: int, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A tile's items (item k of thread th at ``k * THREADS + th``): their
    rows, run heads and lengths."""
    rows = np.array([t0 + k * THREADS + th for k in range(ITEMS) for th in range(THREADS)])
    s = np.where(rows < n, segs[np.minimum(rows, n - 1)], -1)
    heads = np.full(TILE, -1)
    lens = np.zeros(TILE, dtype=np.int64)
    for w0 in range(0, TILE, WARP):
        heads[w0:w0 + WARP], lens[w0:w0 + WARP] = run_heads(s[w0:w0 + WARP], rows[w0:w0 + WARP])
    return rows, heads, lens


def slab_model(seg: torch.Tensor, num: int, *, nrows: Optional[int] = None,
               row_valid: Optional[torch.Tensor] = None, nulls: Optional[torch.Tensor] = None,
               slots: bool = False, side_counts: bool = False, seed: int = 0,
               record: Optional[Dict[str, Any]] = None) -> Any:
    """The slab route's table (and side counts), step by step; ``record``
    gets the buckets' counts, starts and cursors."""
    rng = np.random.default_rng(seed)
    seg_np = seg.numpy().astype(np.int64)
    n = len(seg_np)
    real, segs = side_rows(seg_np, num, nrows, None if row_valid is None else row_valid.numpy(),
                           None if nulls is None else nulls.numpy())
    nslabs = -(-num >> SEG_SHIFT)
    # the count pass
    counts = np.zeros(nslabs, dtype=np.int64)
    for t0 in range(0, n, TILE):
        _, heads, _ = tile_heads(segs, t0, n)
        np.add.at(counts, heads[heads >= 0] >> SEG_SHIFT, 1)
    null_rows = int((real & (np.zeros(n, bool) if nulls is None else nulls.numpy())).sum())
    stats = np.array([int(real.sum()), null_rows], dtype=np.int32)
    # the plan
    starts = np.concatenate([[0], np.cumsum(counts)])
    cursor = starts[:-1].copy()
    pieces = [(j, int(starts[j]) + q * PIECE) for j in range(nslabs)
              for q in range(max(1, -(-int(counts[j]) // PIECE)))]
    multi = np.array([max(1, -(-int(c) // PIECE)) > 1 for c in counts])
    fill = -1 if slots else 0
    table = np.full(num, 12345, dtype=np.int64)  # garbage: the route writes it whole
    for j in np.nonzero(multi)[0]:
        table[j << SEG_SHIFT:min(num, (j + 1) << SEG_SHIFT)] = fill
    # the partition
    ent = np.zeros(int(starts[-1]), dtype=np.int64)
    tiles = list(range(0, n, TILE))
    rng.shuffle(tiles)
    for t0 in tiles:
        rows, heads, lens = tile_heads(segs, t0, n)
        b = np.where(heads >= 0, heads >> SEG_SHIFT, -1)

        def reserve(j: int, c: int) -> int:
            at = int(cursor[j])
            cursor[j] += c
            return at

        pos, base = tile_slots(b, nslabs, reserve, rng)
        order = np.empty(int((pos >= 0).sum()), dtype=np.int64)
        order[pos[pos >= 0]] = np.nonzero(pos >= 0)[0]
        for j, item in enumerate(order):
            s = int(heads[item])
            at = int(base[s >> SEG_SHIFT]) + j
            assert at < starts[(s >> SEG_SHIFT) + 1]
            off = s & ((1 << SEG_SHIFT) - 1)
            hi = int(rows[item] + lens[item] - 1) if slots else int(lens[item])
            ent[at] = (hi << 32 | off) if slots else off | (hi - 1) << SEG_SHIFT
    assert (cursor == starts[1:]).all()
    if record is not None:
        record["slabs"] = (counts, starts, cursor)
    # the build, a block a piece
    rng.shuffle(pieces)
    for slab, lo in pieces:
        hi = min(lo + PIECE, int(starts[slab + 1]))
        img = np.full(1 << SEG_SHIFT, fill, dtype=np.int64)

        def apply(off: int, v: int) -> None:
            img[off] = max(img[off], v) if slots else img[off] + v

        for w0 in range(lo, hi, WARP):  # a warp's entries
            es = [int(ent[e]) for e in range(w0, min(w0 + WARP, hi))]
            offs = [e & (0xFFFFFFFF if slots else (1 << SEG_SHIFT) - 1) for e in es]
            vals = [e >> 32 if slots else (e >> SEG_SHIFT) + 1 for e in es]
            if len(es) == WARP and len(set(offs)) == 1:
                apply(offs[0], max(vals) if slots else sum(vals))
            else:
                for off, v in zip(offs, vals):
                    apply(off, v)
        s0 = slab << SEG_SHIFT
        for k in range(min(1 << SEG_SHIFT, num - s0)):
            x = int(img[k])
            if not multi[slab]:
                table[s0 + k] = x
            elif x != fill:
                table[s0 + k] = max(table[s0 + k], x) if slots else table[s0 + k] + x
    out = torch.from_numpy(table.astype(np.int32))
    return (out, torch.from_numpy(stats)) if side_counts else out


def global_model(seg: torch.Tensor, num: int, *, nrows: Optional[int] = None,
                 row_valid: Optional[torch.Tensor] = None, nulls: Optional[torch.Tensor] = None,
                 slots: bool = False) -> torch.Tensor:
    """K7's global route: each run head of a warp's lanes updates the
    filled table once, by its run's length or its highest row."""
    seg_np = seg.numpy().astype(np.int64)
    n = len(seg_np)
    _, segs = side_rows(seg_np, num, nrows, None if row_valid is None else row_valid.numpy(),
                        None if nulls is None else nulls.numpy())
    table = np.full(num, -1 if slots else 0, dtype=np.int64)
    for t0 in range(0, n, TILE):
        rows, heads, lens = tile_heads(segs, t0, n)
        for item in np.nonzero(heads >= 0)[0]:
            s = int(heads[item])
            if slots:
                table[s] = max(table[s], int(rows[item] + lens[item] - 1))
            else:
                table[s] += int(lens[item])
    return torch.from_numpy(table.astype(np.int32))


def _check(case: Dict[str, Any], label: str, seed: int) -> None:
    rows = {k: case[k] for k in ("nrows", "row_valid", "nulls") if k in case}
    for slots in (False, True):
        got = slab_model(case["build"], case["num"], slots=slots, seed=seed, **rows)
        want = join_build_reference(case["build"], case["num"], slots=slots, **rows)
        assert torch.equal(got, want), f"{label} slots={slots}"
        got = global_model(case["build"], case["num"], slots=slots, **rows)
        assert torch.equal(got, want), f"{label} slots={slots}, global route"
    got, got_stats = slab_model(case["build"], case["num"], side_counts=True, seed=seed, **rows)
    want, want_stats = join_build_reference(case["build"], case["num"], side_counts=True,
                                            **rows)
    assert torch.equal(got, want) and torch.equal(got_stats, want_stats), f"{label} side counts"


def _cases(n: int, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """``chip_smoke.join_side_cases`` at n rows, its segment counts scaled
    down to the model's slabs (one slab, its edges, several, and the
    shared route's few)."""
    nums = (1, 7, (1 << SEG_SHIFT) - 1, (1 << SEG_SHIFT) + 1, 5 * (1 << SEG_SHIFT) + 3)
    orig = cs.JOIN_SIDE_SEGMENTS, cs.JOIN_SKEW
    cs.JOIN_SIDE_SEGMENTS, cs.JOIN_SKEW = nums, max(n // 3, 1)
    try:
        return cs.join_side_cases(torch.device("cpu"), n, seed)
    finally:
        cs.JOIN_SIDE_SEGMENTS, cs.JOIN_SKEW = orig


@pytest.mark.parametrize("n", [1, 3, 33, TILE + 5, 150, 701])
def test_slab_model_matches_the_twin(n: int) -> None:
    for i, (label, case) in enumerate(_cases(n, 100 + n)):
        _check(case, f"{label} n={n}", seed=i)


@pytest.mark.parametrize("pattern", ["runs", "sorted", "one segment", "alternating"])
def test_runs_of_equal_segments(pattern: str) -> None:
    """Runs across lanes, warps and tiles, and pieces that split a slab."""
    rng = np.random.default_rng(5)
    n, num = 900, 3 * (1 << SEG_SHIFT)
    seg = {"runs": np.repeat(rng.integers(0, num, n // 7 + 1), 7)[:n],
           "sorted": np.sort(rng.integers(0, num, n)),
           "one segment": np.full(n, num - 2),
           "alternating": np.tile([5, 70], n // 2)}[pattern].astype(np.int32)
    nulls = torch.from_numpy(rng.random(n) < 0.05)
    _check(dict(build=torch.from_numpy(seg), num=num, nrows=n - 11), pattern, seed=1)
    _check(dict(build=torch.from_numpy(seg), num=num, nulls=nulls,
                row_valid=torch.from_numpy(rng.random(n) < 0.9)), f"{pattern} masked", seed=2)


def test_the_shared_route_limit_matches_the_kernel() -> None:
    source = (Path(__file__).resolve().parents[1] / "fugue_tpu_torch" / "kernels"
              / "join.cu").read_text()
    assert f"constexpr int kSharedMax = {SHARED_MAX};" in source
    assert f"constexpr int kSegShift = {SEG_SHIFT_CARD};" in source


def test_chip_smoke_join_side_cases_on_cpu(monkeypatch: pytest.MonkeyPatch, capsys) -> None:
    """``chip_smoke.join_vs_twin``'s K7 part (paths, ``check_buckets``,
    the twins, NOT IN) with the model as K7's slab route above 7
    segments, and the twins as the other kernels."""
    from fugue_tpu_torch.kernels import gather, join, reference

    def build(seg, num, **kw):
        if num <= 7:
            build.last_path = "shared"
            return reference.join_build_reference(seg, num, **kw)
        build.last_path = "slab"
        rec: Dict[str, Any] = {}
        out = slab_model(seg, num, record=rec, **kw)
        build.last_slabs = join.SlabBuckets(*(torch.from_numpy(a.astype(np.int32))
                                               for a in rec["slabs"]))
        return out

    monkeypatch.setattr(join, "join_build_cuda", build)
    monkeypatch.setattr(join, "join_probe_cuda", reference.join_probe_reference)
    monkeypatch.setattr(join, "join_expand_cuda",
                        lambda *a, **kw: reference.join_expand_reference(*a, **kw))

    def gather_twin(columns, idx, *, outer=False, scattered=False):
        gather_twin.last_route = "direct"
        return reference.gather_rows_reference(columns, idx, outer=outer)

    monkeypatch.setattr(gather, "gather_rows_cuda", gather_twin)
    monkeypatch.setattr(cs, "JOIN_SIDE_SEGMENTS", (1, 7, (1 << SEG_SHIFT) - 1,
                                                   (1 << SEG_SHIFT) + 1, 5 * (1 << SEG_SHIFT)))
    monkeypatch.setattr(cs, "JOIN_SKEW", 40)
    monkeypatch.setattr(cs, "JOIN_CROSS_ROWS", (30, 7))
    cs.join_vs_twin(torch.device("cpu"), (1, 150))
    out = capsys.readouterr().out
    assert "join_build/join_probe n=150 one segment of 25M holding every row: equal (K7 path " \
           "slab)" in out
    assert "join_build/join_probe n=150 S=65 masked nulls: equal (K7 path slab)" in out
