"""A plain numpy model of K17 ``comap_presence`` as
``fugue_tpu_torch/kernels/comap.cu`` computes it, tile by tile, at a small
scale: a persistent grid of ``BLOCKS`` blocks over row tiles of ``THREADS``
threads; each thread loads its ``ROWS_PER`` consecutive rows of a tile
(four rows a vector load on the vector route), finds its first row's
member by a search (of the block's copy of the layout for up to
``SHARED_MEMBERS`` members, of ``offsets`` above), walks its other rows'
members by compares, gives one candidate bit for each run of equal
(segment, member) among its real rows, drops its first run where it
continues the last run of the lane before it in its warp of ``WARP``
lanes, and reads each remaining candidate's word, setting the bit where it
is clear. The blocks run in a random order.

Held against ``comap_presence_reference`` over runs that cross a thread, a
lane, a warp and a tile; a member boundary inside a thread's rows and an
empty member; ``nrows`` shorter than a member's rows and a ``valid``
mask; sentinel ids below 0 and at ``num``; 33 and 65 members; ``n`` not a
multiple of the tile and an unaligned ``seg`` view on the scalar route;
and ``chip_smoke.comap_vs_twin`` rehearsed with the model as K17."""

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pytest
import torch

import chip_smoke as cs
from fugue_tpu_torch.kernels.reference import (
    comap_presence_reference,
    comap_rows_reference,
    presence_words,
)

THREADS = 8  # a block's threads (256 on the card)
WARP = 4  # (32)
ROWS_PER = 8  # consecutive rows a thread (16: four 16-byte loads of seg)
SHARED_MEMBERS = 64  # members whose layout a block keeps (64)
BLOCKS = 3
ROW_TILE = THREADS * ROWS_PER


def member_of(offsets: np.ndarray, r: int) -> int:
    """The last member m with ``offsets[m] <= r``."""
    return int(np.searchsorted(offsets[:-1], r, side="right")) - 1


def presence_model(seg: torch.Tensor, num_segments: int, offsets: torch.Tensor,
                   nrows: torch.Tensor, *, valid: Optional[torch.Tensor] = None,
                   seed: int = 0, record: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """K17's presence words; ``record`` gets the route, the candidates
    (each one word read), the atomics, the searches of ``offsets`` and
    the candidates dropped as continuing the lane before."""
    rng = np.random.default_rng(seed)
    s_np = seg.numpy().astype(np.int64)
    off = offsets.numpy().astype(np.int64)
    nr = nrows.numpy().astype(np.int64)
    v_np = None if valid is None else valid.numpy()
    n, members = len(s_np), len(nr)
    words = presence_words(members)
    out = np.zeros(num_segments * words, dtype=np.uint32)
    vec = seg.data_ptr() % 16 == 0 and (valid is None or valid.data_ptr() % 4 == 0)
    cached = members <= SHARED_MEMBERS
    row_tiles = -(-n // ROW_TILE)
    reads = atomics = searched = dropped = 0

    def thread_bits(r0: int) -> Tuple[List[int], int]:
        """A thread's candidate bits (its runs' heads) and its last run."""
        nonlocal searched
        heads: List[int] = []
        run = -1
        ok = [r0 + j < n and (v_np is None or bool(v_np[r0 + j])) for j in range(ROWS_PER)]
        if not any(ok):
            return heads, run
        m = member_of(off, r0)
        searched += not cached
        for j in range(ROWS_PER):
            r = r0 + j
            if not ok[j]:
                continue
            while m + 1 <= members and r >= off[m + 1]:  # into the next member
                m += 1
            s = int(s_np[r])
            if r >= off[m] + nr[m] or not 0 <= s < num_segments:
                continue
            bit = s * 32 * words + m
            if bit != run:
                heads.append(bit)
                run = bit
        return heads, run

    blocks = list(range(BLOCKS))
    rng.shuffle(blocks)
    for b in blocks:
        for tile in range(b, row_tiles, BLOCKS):
            runs = [thread_bits(tile * ROW_TILE + th * ROWS_PER) for th in range(THREADS)]
            for th, (heads, _) in enumerate(runs):
                before = runs[th - 1][1] if th % WARP else -1
                if heads and before >= 0 and heads[0] == before:
                    heads = heads[1:]
                    dropped += 1
                for bit in heads:
                    reads += 1
                    word, mask = bit >> 5, np.uint32(1 << (bit & 31))
                    if not out[word] & mask:
                        atomics += 1
                        out[word] |= mask
    if record is not None:
        record.update(route="vector" if vec else "scalar", reads=reads, atomics=atomics,
                      searched=searched, dropped=dropped)
    presence_model.last_path = "vector" if vec else "scalar"
    return torch.from_numpy(out.view(np.int32).copy())


presence_model.last_path = None  # type: ignore[attr-defined]


def _layout(sizes: List[int], nrows: List[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int64),
            torch.tensor(nrows, dtype=torch.int64))


def _check(seg: torch.Tensor, num: int, sizes: List[int], nrows: List[int],
           valid: Optional[torch.Tensor], label: str, seed: int) -> Dict[str, Any]:
    offsets, nr = _layout(sizes, nrows)
    rec: Dict[str, Any] = {}
    got = presence_model(seg, num, offsets, nr, valid=valid, seed=seed, record=rec)
    want = comap_presence_reference(seg, num, offsets, nr, valid=valid)
    assert got.dtype == want.dtype and torch.equal(got, want), label
    assert rec["atomics"] == int(sum(bin(w & 0xFFFFFFFF).count("1") for w in want.tolist()))
    return rec


LAYOUTS = {
    # member boundaries inside a thread's rows (sizes not multiples of 4),
    # at a tile's edge, an empty member, members of 1 and 7 rows
    "boundaries": [ROW_TILE, 0, ROW_TILE // 2 + 3, 1, 7, 3 * ROW_TILE + 6],
    "tiny members": [1, 0, 2, 1, 3, 0, 1, ROW_TILE * 2 + 1],
    "33 members": [5] * 20 + [0] + [ROW_TILE + 1] * 12,
    # more than SHARED_MEMBERS: a search of offsets a thread, then a walk
    "65 members": [1, 2, 0] * 21 + [ROW_TILE * 2, 9],
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("layout", ["prefix", "masked"])
@pytest.mark.parametrize("run", [3, 5, 17, 50])
def test_presence_model_matches_the_twin(name: str, layout: str, run: int) -> None:
    """Runs of ``run`` adjacent rows of one segment: within a thread (3),
    across threads and lanes (5), across warps (17) and tiles (50); 5 %
    sentinels at ``num`` and 2 % at -1."""
    rng = np.random.default_rng(run)
    sizes = LAYOUTS[name]
    n = sum(sizes)
    assert n % ROW_TILE != 0
    num = max(n // run, 2)
    seg = np.minimum(np.arange(n) // run, num - 1)
    seg[rng.random(n) < 0.05] = num
    seg[rng.random(n) < 0.02] = -1
    valid = None
    nrows = list(sizes)
    if layout == "prefix":
        nrows = [max(sz - (m % 3) * 2, 0) for m, sz in enumerate(sizes)]  # some short
    else:
        valid = torch.from_numpy(rng.random(n) < 0.8)
    rec = _check(torch.from_numpy(seg.astype(np.int32)), num, sizes, nrows, valid,
                 f"{name} {layout} run {run}", seed=run)
    assert rec["route"] == "vector"
    assert (rec["searched"] > 0) == (len(sizes) > SHARED_MEMBERS)
    if run >= 5:
        assert rec["dropped"] > 0  # runs continued from the lane before


def test_one_candidate_a_run() -> None:
    """Config 4's layout (50 adjacent rows a segment in member a, one in
    member b): about one candidate a segment and member, the runs cut only
    at the warps' first lanes; each candidate reads its word once."""
    per, groups = 50, 40
    seg = torch.from_numpy(np.concatenate([np.repeat(np.arange(groups), per),
                                           np.arange(groups)]).astype(np.int32))
    sizes = [groups * per, groups]
    rec = _check(seg, groups, sizes, sizes, None, "config 4", seed=1)
    n = int(seg.shape[0])
    warps = -(-n // (WARP * ROWS_PER))
    assert rec["atomics"] == 2 * groups
    assert 2 * groups <= rec["reads"] <= 2 * groups + warps
    assert rec["reads"] < n // 10


@pytest.mark.parametrize("members", [1, 2, 33, 65])
def test_random_layouts(members: int) -> None:
    """Random member sizes (empty ones too), random segments with
    sentinels, random ``nrows`` and masks."""
    rng = np.random.default_rng(members)
    for trial in range(3):
        sizes = rng.integers(0, 3 * ROW_TILE, members).tolist()
        sizes[-1] += 1
        n = sum(sizes)
        num = int(rng.integers(1, 60))
        seg = np.sort(rng.integers(-1, num + 1, n)) if trial == 1 else rng.integers(-1, num + 1, n)
        nrows = [int(rng.integers(0, sz + 1)) for sz in sizes]
        valid = torch.from_numpy(rng.random(n) < 0.7) if trial % 2 else None
        _check(torch.from_numpy(seg.astype(np.int32)), num, sizes,
               nrows if valid is None else sizes, valid, f"{members} members trial {trial}",
               seed=trial)


def test_an_unaligned_seg_view_takes_the_scalar_route() -> None:
    sizes = [ROW_TILE + 3, 2 * ROW_TILE + 1]
    n = sum(sizes)
    seg = torch.from_numpy((np.arange(n) // 5).astype(np.int32))
    (view, _), = cs.shifted([(seg, None)])
    assert view.data_ptr() % 16 != 0
    rec = _check(view, n // 5 + 1, sizes, sizes, None, "unaligned seg", seed=2)
    assert rec["route"] == "scalar"
    valid = torch.ones(n + 1, dtype=torch.bool)[1:]  # 4-byte aligned only with seg's view
    rec = _check(seg, n // 5 + 1, sizes, sizes, valid, "unaligned valid", seed=2)
    assert rec["route"] == "scalar"


def test_the_model_matches_the_kernel_constants() -> None:
    source = (Path(__file__).resolve().parents[1] / "fugue_tpu_torch" / "kernels"
              / "comap.cu").read_text()
    for line in ("constexpr int kPresenceRows = 16;", "constexpr int kThreads = 256;",
                 "constexpr int kSharedMembers = 64;"):
        assert line in source
    assert cs.K17_TILE == 256 * 16 and cs.K18_TILE == 256 * 4


def test_chip_smoke_comap_vs_twin_with_the_model(monkeypatch: pytest.MonkeyPatch,
                                                 capsys: pytest.CaptureFixture) -> None:
    """``chip_smoke.comap_vs_twin`` with the model as K17 (its routes
    checked) and K18's twin, the tile edges cut to the model's tile."""
    from fugue_tpu_torch.kernels import comap

    monkeypatch.setattr(comap, "comap_presence_cuda", presence_model)
    monkeypatch.setattr(comap, "comap_rows_cuda", comap_rows_reference)
    monkeypatch.setattr(cs, "K18_TILE", ROW_TILE)
    monkeypatch.setattr(cs, "K17_TILE", ROW_TILE)
    cs.comap_vs_twin(torch.device("cpu"), (1, 300), big_segments=1 << 8,
                     top_rows=4 * ROW_TILE - 1)
    assert "comap_vs_twin: " in capsys.readouterr().out
