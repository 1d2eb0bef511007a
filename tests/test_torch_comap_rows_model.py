"""A plain numpy model of K18 ``comap_rows`` as
``fugue_tpu_torch/kernels/comap.cu`` computes it, tile by tile, at a small
scale: a persistent grid of ``BLOCKS`` blocks over the row tiles and then
the segment tiles, in a random order; each block keeps the layout (each
member's first row and real-row end) where the zip has at most
``SHARED_MEMBERS`` members; a row tile of ``THREADS`` threads of
``ROWS_PER`` consecutive rows finds its first and last rows' members once,
each thread walks forward from the first to its rows' member (a search a
thread where the layout is not kept), its rows compare with the next
member's start and the member's bound, the rule is read once for each run
of equal segments among a thread's rows, and the alive rows are counted in
a register, added by warp in a tile of one member and by run of a member
otherwise, into a block's counts for the first ``SHARED_MEMBERS`` members
and the global ones past them; a segment tile of ``SEGS_PER`` segments a
thread writes each one's liveness and counts the alive ones.

Held against ``comap_rows_reference`` over a member boundary inside a
tile and at a tile's edge, an empty member, ``nrows`` shorter than a
member's rows, a ``valid`` mask, 33 and 65 members and all five rules."""

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pytest
import torch

import chip_smoke as cs
from fugue_tpu_torch.kernels.reference import (
    COMAP_HOWS,
    ComapRows,
    comap_alive_reference,
    comap_presence_reference,
    comap_rows_reference,
)

THREADS = 8  # a block's threads (256 on the card)
WARP = 4  # (32)
ROWS_PER = 4  # consecutive rows a thread (4)
SEGS_PER = 4  # consecutive segments a thread (16)
SHARED_MEMBERS = 8  # members a block keeps the layout and counts of (64)
BLOCKS = 3
ROW_TILE = THREADS * ROWS_PER
SEG_TILE = THREADS * SEGS_PER


def member_of(offsets: np.ndarray, r: int) -> int:
    """The last member m with ``offsets[m] <= r``."""
    return int(np.searchsorted(offsets[:-1], r, side="right")) - 1


def rows_model(seg: torch.Tensor, presence: Optional[torch.Tensor], num: int,
               offsets: torch.Tensor, nrows: torch.Tensor, how: str, *,
               valid: Optional[torch.Tensor] = None, seed: int = 0,
               record: Optional[Dict[str, Any]] = None, int_max: int = 2**31 - 1
               ) -> ComapRows:
    """K18's outputs, tile by tile; ``record`` gets the rule's reads and
    the tiles that walked the block's copy of the layout. ``int_max`` is
    the largest value of the kernel's ``int`` (and its ``kNoRow``): every
    tile start, tile end, thread's first row and row that the kernel keeps
    in an ``int`` is checked against it, the sums it compares in 64 bits
    (a tile's end before the clamp to n, a thread's last row + 1) are
    not."""
    rng = np.random.default_rng(seed)
    s_np = seg.numpy().astype(np.int64)
    off = offsets.numpy().astype(np.int64)
    nr = nrows.numpy().astype(np.int64)
    v_np = None if valid is None else valid.numpy()
    n, members = len(s_np), len(nr)
    alive_of = comap_alive_reference(presence, num, members, how).numpy()
    reads = 0

    def rule(s: int) -> bool:
        nonlocal reads
        reads += 1
        return bool(alive_of[s])

    def next_of(m: int) -> int:
        return int(off[m + 1]) if m + 1 <= members else int_max

    def i32(x: int) -> int:
        assert -int_max - 1 <= x <= int_max, f"{x} overflows the kernel's int"
        return x

    row_alive = np.zeros(n, dtype=bool)
    seg_out = np.zeros(n, dtype=np.int32)
    alive = np.zeros(num, dtype=bool)
    counts = np.zeros(members, dtype=np.int64)
    alive_count = 0
    cached = members <= SHARED_MEMBERS
    walked = searched = 0
    row_tiles, seg_tiles = -(-n // ROW_TILE), -(-num // SEG_TILE)
    units = list(range(row_tiles + seg_tiles))
    blocks = [units[b::BLOCKS] for b in range(BLOCKS)]
    rng.shuffle(blocks)
    for mine in blocks:
        block_counts = np.zeros(min(members, SHARED_MEMBERS), dtype=np.int64)
        block_alive = 0

        def add(m: int, c: int) -> None:
            if m < SHARED_MEMBERS:
                block_counts[m] += c
            else:
                counts[m] += c

        for u in mine:
            if u >= row_tiles:  # a segment tile
                for th in range(THREADS):
                    s0 = (u - row_tiles) * SEG_TILE + th * SEGS_PER
                    for s in range(s0, min(s0 + SEGS_PER, num)):
                        alive[s] = rule(s)
                        block_alive += int(alive[s])
                continue
            t0 = i32(u * ROW_TILE)
            t1 = i32(min(t0 + ROW_TILE, n))
            first, last = member_of(off, t0), member_of(off, t1 - 1)
            warp_sums = np.zeros(THREADS // WARP, dtype=np.int64)
            for th in range(THREADS):
                r0 = i32(t0 + th * ROWS_PER)
                rows = [i32(r0 + j) for j in range(ROWS_PER)]
                m, mine_alive = first, 0
                if r0 < t1:
                    if cached:  # forward from the tile's first member
                        while m < last and off[m + 1] <= r0:
                            m += 1
                        walked += 1
                    else:
                        m = member_of(off, r0)
                        searched += 1
                    nxt, real_end = next_of(m), int(off[m] + nr[m])
                    # each row's member, whether it can be alive, the run heads
                    mj, can, head, run_seg = [], [], [], -1
                    for r in rows:
                        if r < n:
                            while r >= nxt:  # into the next member
                                m += 1
                                nxt, real_end = next_of(m), int(off[m] + nr[m])
                        mj.append(m)
                        s = int(s_np[r]) if r < n else -1
                        c = (r < n and (v_np is None or bool(v_np[r])) and r < real_end
                             and 0 <= s < num)
                        can.append(c)
                        head.append(c and s != run_seg)
                        if c:
                            run_seg = s
                    run_alive = False
                    m = mj[0]
                    for j, r in enumerate(rows):
                        if head[j]:
                            run_alive = rule(int(s_np[r]))
                        a = can[j] and run_alive
                        if mj[j] != m:
                            add(m, mine_alive)
                            mine_alive, m = 0, mj[j]
                        mine_alive += int(a)
                        if r < n:
                            row_alive[r] = a
                            seg_out[r] = s_np[r] if a else num
                if first == last:
                    warp_sums[th // WARP] += mine_alive
                else:
                    add(m, mine_alive)
            if first == last:
                for w in warp_sums:
                    add(first, int(w))
        for j, c in enumerate(block_counts):
            counts[j] += c
        alive_count += block_alive
    if record is not None:
        record.update(reads=reads, walked=walked, searched=searched)
    return ComapRows(torch.from_numpy(row_alive), torch.from_numpy(seg_out),
                     torch.from_numpy(alive), torch.from_numpy(counts.astype(np.int32)),
                     torch.tensor(alive_count, dtype=torch.int32))


def _layout(sizes: List[int], nrows: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int64),
            torch.tensor(nrows, dtype=torch.int64))


def _check(seg: torch.Tensor, num: int, sizes: List[int], nrows: List[int],
           valid: Optional[torch.Tensor], label: str, seed: int,
           int_max: int = 2**31 - 1) -> Dict[str, Any]:
    offsets, nr = _layout(sizes, nrows)
    rec: Dict[str, Any] = {}
    for how in COMAP_HOWS:
        s, g = (torch.zeros_like(seg), 1) if how == "cross" else (seg, num)
        presence = None if how == "cross" else comap_presence_reference(s, g, offsets, nr,
                                                                        valid=valid)
        got = rows_model(s, presence, g, offsets, nr, how, valid=valid, seed=seed, record=rec,
                         int_max=int_max)
        want = comap_rows_reference(s, presence, g, offsets, nr, how, valid=valid)
        for name, a, b in zip(want._fields, got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), f"{label} {how} {name}"
    return rec


LAYOUTS = {
    # a boundary at a tile's edge, an empty member, a boundary inside a
    # tile, members of 1 and 7 rows (the layout kept by the block)
    "tile edges": [ROW_TILE, 0, ROW_TILE // 2 + 3, 1, 7, 3 * ROW_TILE + 5],
    # a tile over every member of the block's layout, empty ones too
    "tiny members": [1, 0, 2, 1, 3, 0, 1, ROW_TILE * 2],
    "33 members": [5] * 20 + [0] + [ROW_TILE + 1] * 12,
    # more than SHARED_MEMBERS and 64, three presence words
    "65 members": [1, 2, 0] * 21 + [ROW_TILE * 2, 9],
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("layout", ["prefix", "masked"])
def test_rows_model_matches_the_twin(name: str, layout: str) -> None:
    rng = np.random.default_rng(7)
    sizes = LAYOUTS[name]
    n = sum(sizes)
    num = max(n // 5, 2)
    seg = np.minimum(np.arange(n) // 5, num - 1)  # runs of 5 adjacent rows
    seg[rng.random(n) < 0.05] = num  # sentinels
    seg[rng.random(n) < 0.02] = -1
    valid = None
    nrows = list(sizes)
    if layout == "prefix":
        nrows = [max(sz - (m % 3) * 2, 0) for m, sz in enumerate(sizes)]  # some short
    else:
        valid = torch.from_numpy(rng.random(n) < 0.8)
    rec = _check(torch.from_numpy(seg.astype(np.int32)), num, sizes, nrows, valid,
                 f"{name} {layout}", seed=3)
    assert rec["searched" if len(sizes) > SHARED_MEMBERS else "walked"] > 0


def test_the_rule_is_read_once_a_run() -> None:
    """Co-partitioned members (50 adjacent rows a segment): the rule is
    read once for each run of equal segments among a thread's rows, not a
    row; a tile of one member counts by warp."""
    per, groups = 50, 40
    seg = torch.from_numpy(np.concatenate([np.repeat(np.arange(groups), per),
                                           np.arange(groups)]).astype(np.int32))
    sizes = [groups * per, groups]
    offsets, nrows = _layout(sizes, sizes)
    presence = comap_presence_reference(seg, groups, offsets, nrows)
    rec: Dict[str, Any] = {}
    got = rows_model(seg, presence, groups, offsets, nrows, "inner", record=rec)
    want = comap_rows_reference(seg, presence, groups, offsets, nrows, "inner")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    n = int(seg.shape[0])
    chunks = seg.numpy().reshape(n // ROWS_PER, ROWS_PER)  # a thread's rows
    runs = int((chunks[:, 1:] != chunks[:, :-1]).sum()) + n // ROWS_PER
    assert rec["reads"] == runs + groups  # and the segment tiles' one a segment
    assert rec["reads"] < n // 2


@pytest.mark.parametrize("members", [1, 2, 33, 65])
def test_random_layouts(members: int) -> None:
    """Random member sizes (empty ones too), random segments, random
    ``nrows`` and masks."""
    rng = np.random.default_rng(members)
    for trial in range(3):
        sizes = rng.integers(0, 3 * ROW_TILE, members).tolist()
        sizes[-1] += 1
        n = sum(sizes)
        num = int(rng.integers(1, 60))
        seg = rng.integers(-1, num + 1, n).astype(np.int32)
        nrows = [int(rng.integers(0, sz + 1)) for sz in sizes]
        valid = torch.from_numpy(rng.random(n) < 0.7) if trial % 2 else None
        _check(torch.from_numpy(seg), num, sizes, nrows if valid is None else sizes, valid,
               f"{members} members trial {trial}", seed=trial)


@pytest.mark.parametrize("layout", ["prefix", "masked"])
def test_the_top_tile_of_the_most_rows(layout: str) -> None:
    """The most rows the kernel takes, its ``int`` scaled down to 8 bits:
    ``2^8 - 1`` rows, whose top tile ends at ``2^8``, one past the largest
    ``int``; a member ends inside the top tile and the last one's real
    rows end before the last row."""
    int_max = 2**8 - 1
    assert (int_max + 1) % ROW_TILE == 0  # as 2^31 is a multiple of the card's tile
    sizes = [100, 0, int_max - 100 - 9, 9]
    rng = np.random.default_rng(5)
    num = 40
    seg = np.minimum(np.arange(int_max) // 5, num - 1).astype(np.int32)
    seg[-2] = num  # a sentinel in the top tile
    valid = torch.from_numpy(rng.random(int_max) < 0.8) if layout == "masked" else None
    nrows = [100, 0, sizes[2] - 3, 6] if valid is None else sizes
    _check(torch.from_numpy(seg), num, sizes, nrows, valid, f"top tile {layout}", seed=1,
           int_max=int_max)
    with pytest.raises(AssertionError, match="overflows"):  # one row more does not fit
        _check(torch.zeros(int_max + 1, dtype=torch.int32), num, sizes[:3] + [10],
               sizes[:3] + [10], None, "past the top", seed=1, int_max=int_max)


def test_the_model_matches_the_kernel_constants() -> None:
    source = (Path(__file__).resolve().parents[1] / "fugue_tpu_torch" / "kernels"
              / "comap.cu").read_text()
    assert "constexpr int kRowsPer = 4;" in source
    assert "constexpr int kThreads = 256;" in source
    assert "constexpr int kSharedMembers = 64;" in source
    assert cs.K18_TILE == 256 * 4


def test_chip_smoke_comap_vs_twin_with_the_model(monkeypatch: pytest.MonkeyPatch,
                                                 capsys: pytest.CaptureFixture) -> None:
    """``chip_smoke.comap_vs_twin`` with the model as K18 and its tile
    edges cut to the model's tile."""
    from fugue_tpu_torch.kernels import comap

    monkeypatch.setattr(comap, "comap_presence_cuda", comap_presence_reference)
    monkeypatch.setattr(comap, "comap_rows_cuda", rows_model)
    monkeypatch.setattr(cs, "K18_TILE", ROW_TILE)
    cs.comap_vs_twin(torch.device("cpu"), (1, 300), big_segments=1 << 8,
                     top_rows=4 * ROW_TILE - 1)
    out = capsys.readouterr().out
    assert "comap_vs_twin: " in out
    assert f"comap_rows over {4 * ROW_TILE - 1} rows: every row as the rule gives it" in out
    cases = cs.comap_tile_cases(torch.device("cpu"), 300, 1)
    assert any(label.startswith("65 members") for label, _ in cases)
