"""K2 ``sort_boundaries`` and K9 ``join_expand`` as redesigned for Hopper,
as numpy models of their steps, against the twins they must equal; the
twins on ``chip_smoke.py``'s K2 and K9 cases against the JAX package's
programs.

- ``k2_model``: tiles of ``threads * items`` sorted positions, a thread's
  ``items`` consecutive positions; a position's real flag from the
  thread's last and first rows (real rows come first in sorted order);
  each code read once a position (gathered at the order, or read at the
  position where the first code comes in sorted order), the predecessor's
  from the position before in the thread, the thread before in the warp,
  the warp before (shared memory) or the tile's own read of ``order[i -
  1]``; the "opens a group" counts scanned across tiles by
  ``lookback_scan`` (tiles finishing in any order).
- ``k9_model``: ``expand_tiles``' search of each tile's first probe row,
  then a tile's marks (row ``tiles[b]`` at slot 0, each later row whose
  run is not empty at the slot its run starts, unless that is in the next
  tile), the max scan of the marks, and each slot's outputs from its
  row's staged ``m``, ``seg`` and ``cstart``; a tile whose range holds
  more than ``walk`` probe rows finds each slot's row by a binary search
  over ``start`` in the range instead.

The models run with small tiles, so the cases span many of them; at the
kernels' own tiles they rehearse ``chip_smoke.sort_boundaries_edges`` and
``expand_cases``. ``lex_sort``'s values are the first code in sorted
order."""

from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fugue_tpu.jax_backend import groupby as jgroupby
from fugue_tpu_torch.kernels import factorize as factorize_kernels
from fugue_tpu_torch.kernels import reference as R
from fugue_tpu_torch.torch_backend import groupby
from test_torch_order_scatter import lookback_scan

CPU = torch.device("cpu")


def _bits(c: np.ndarray) -> np.ndarray:
    return c.view(np.uint32 if c.itemsize == 4 else np.uint64).astype(np.uint64)


def k2_model(codes: List[torch.Tensor], order: torch.Tensor, *, nrows: Optional[int] = None,
             row_valid: Optional[torch.Tensor] = None,
             first_sorted: Optional[torch.Tensor] = None, threads: int = 8, items: int = 2,
             warp: int = 4, seed: int = 0) -> Any:
    """``factorize.cu``'s K2 step by step (see the module's docstring):
    ``(seg_sorted, count)``."""
    o = order.numpy()
    n, tile = len(o), threads * items
    tiles = -(-n // tile)
    real = np.zeros(n, dtype=bool)
    for base in range(0, n, items):  # a thread's positions
        rows = o[base:base + items]
        if row_valid is None:
            real[base:base + items] = rows < nrows
        else:
            rv = row_valid.numpy()
            if rv[rows[-1]]:
                real[base:base + items] = True
            elif rv[rows[0]]:
                real[base:base + items] = rv[rows] != 0
    differ = np.zeros(n, dtype=bool)
    for j, c in enumerate(codes):
        sorted_code = j == 0 and first_sorted is not None
        bits = _bits(first_sorted.numpy() if sorted_code else c.numpy())
        v = np.where(real, bits[np.arange(n)] if sorted_code else bits[o], 0)
        prev = np.zeros(n, dtype=np.uint64)
        for i in range(n):
            t_first = i % tile == 0
            if i % items:  # within the thread
                prev[i] = v[i - 1]
            elif (i // items) % warp:  # the lane before (a shuffle)
                prev[i] = v[i - 1]
            elif not t_first:  # the warp before, through shared memory
                prev[i] = v[i - 1]
            elif i > 0 and real[i]:  # the tile's own read of order[i - 1]
                prev[i] = bits[i - 1] if sorted_code else bits[o[i - 1]]
            else:
                prev[i] = v[i]
        differ |= v != prev
    differ[0] = True
    opens = (real & differ).astype(np.int64)
    rng = np.random.default_rng(seed)
    if tiles == 0:
        return torch.empty((0,), dtype=torch.int32), torch.tensor(0, dtype=torch.int32)
    scan = np.array(lookback_scan(list(opens), lambda x, y: x + y, 0, tile, rng))
    seg = np.where(real, scan - 1, -1).astype(np.int32)
    return torch.from_numpy(seg), torch.tensor(int(scan[-1]), dtype=torch.int32)


@pytest.fixture(scope="module")
def k2_cases() -> List[Any]:
    return chip_smoke.sort_boundaries_edge_cases(CPU, chip_smoke.SEED)


def _small(cases: List[Any], limit: int) -> List[Any]:
    return [(label, case) for label, case in cases if int(case["order"].shape[0]) <= limit]


def test_k2_edge_cases_cover_the_kernel_tiles(k2_cases):
    """The cases reach past one kernel tile, hold an order that is not
    16-byte aligned, and pass the first code in sorted order where
    ``lex_sort`` has it."""
    sizes = {int(case["order"].shape[0]) for _, case in k2_cases}
    assert {1, chip_smoke.K2_TILE - 1, chip_smoke.K2_TILE + 1} <= sizes
    assert any(case["order"].data_ptr() % 16 for _, case in k2_cases)
    assert any("first_sorted" in case for _, case in k2_cases)
    for _, case in k2_cases:
        if "first_sorted" in case:
            assert torch.equal(case["first_sorted"], case["codes"][0][case["order"]])


@pytest.mark.parametrize("threads,items,warp", [(8, 2, 4), (4, 8, 2), (16, 1, 8)])
def test_k2_model_matches_the_twin(k2_cases, threads, items, warp):
    for label, case in _small(k2_cases, chip_smoke.K2_TILE + 1):
        got = k2_model(**case, threads=threads, items=items, warp=warp, seed=len(label))
        want = R.sort_boundaries_reference(**case)
        assert torch.equal(got[0], want[0]), label
        assert int(got[1]) == int(want[1]), label


def test_chip_smoke_sort_boundaries_edges_on_cpu(monkeypatch):
    """``chip_smoke.sort_boundaries_edges`` with the twin standing in for
    K2 (one launch counted a call)."""
    def k2(*args: Any, **kwargs: Any) -> Any:
        k2.launches += 1
        return R.sort_boundaries_reference(*args, **kwargs)

    k2.launches = 0
    monkeypatch.setattr(factorize_kernels, "sort_boundaries_cuda", k2)
    assert chip_smoke.sort_boundaries_edges(CPU) == k2.launches > 40


def test_k2_twin_matches_the_jax_core(k2_cases):
    """On the cases whose codes the JAX package takes (int32 and float32,
    as ``_sort_factorize_core`` sorts them itself): its order is
    ``lex_sort``'s, and the twin's ids and count are its own where a
    position is real."""
    for label, case in _small(k2_cases, 3 * chip_smoke.K2_TILE + 5):
        if any(c.element_size() != 4 or c.stride(0) != 1 for c in case["codes"]):
            continue
        if case["order"].data_ptr() % 16:
            continue
        n = int(case["order"].shape[0])
        rv = case.get("row_valid")
        jseg, jorder, jvalid, jnum = jgroupby._sort_factorize_core(
            tuple(jnp.asarray(c.numpy()) for c in case["codes"]),
            None if rv is None else jnp.asarray(rv.numpy()),
            np.int32(case.get("nrows", -1)))
        np.testing.assert_array_equal(case["order"].numpy(), np.asarray(jorder))
        seg, count = R.sort_boundaries_reference(**case)
        real = np.asarray(jvalid)[np.asarray(jorder)]
        assert int(count) == int(jnum), label
        np.testing.assert_array_equal(seg.numpy()[real], np.asarray(jseg)[real])
        assert (seg.numpy()[~real] == -1).all() and n == len(real)


@pytest.mark.parametrize("layout", ["prefix", "short", "masked"])
def test_lex_sort_values_are_the_first_code_in_sorted_order(layout):
    rng = np.random.default_rng(5)
    n = 300
    codes = [torch.from_numpy(rng.integers(0, 7, n).astype(np.int32)),
             torch.from_numpy(rng.standard_normal(n).astype(np.float32))]
    rows: Dict[str, Any] = {"prefix": {"nrows": n}, "short": {"nrows": n - 7},
                            "masked": {"row_valid": torch.from_numpy(rng.random(n) < 0.5)}}[layout]
    order, first = groupby.lex_sort(codes, **rows)
    unreal = {"prefix": np.zeros(n, bool), "short": np.arange(n) >= n - 7,
              "masked": ~rows.get("row_valid", torch.ones(n, dtype=torch.bool)).numpy()}[layout]
    want = np.lexsort((codes[1].numpy(), codes[0].numpy(), unreal))  # stable, last key first
    np.testing.assert_array_equal(order.numpy(), want)
    if layout == "prefix":
        assert torch.equal(first, codes[0][order])
    else:
        assert first is None


# ---- K9 -------------------------------------------------------------------


def k9_tiles(start: np.ndarray, total: int, tile: int) -> List[int]:
    """``expand_tiles``: the probe row of each tile's first output, and of
    the last output."""
    firsts = [b * tile for b in range(-(-total // tile))] + [total - 1]
    return [max(int(np.searchsorted(start, t, side="right")) - 1, 0) for t in firsts]


def k9_model(start: torch.Tensor, m: torch.Tensor, seg1: torch.Tensor, cstart2: torch.Tensor,
             order2: torch.Tensor, total: int, tile: int = 8, walk: Optional[int] = None
             ) -> Any:
    """``join.cu``'s K9 step by step (see the module's docstring): ``(li,
    ri)``. ``walk`` is ``kWalk``, 4 tiles unless given (64 in the kernel)."""
    start, m, seg1 = start.numpy(), m.numpy(), seg1.numpy()
    cstart2, order2 = cstart2.numpy(), order2.numpy()
    p1, num, p2 = len(start), len(cstart2), len(order2)
    walk = 4 * tile if walk is None else walk
    li = np.full(total, -7, dtype=np.int64)
    ri = np.full(total, -7, dtype=np.int64)
    ntiles = -(-total // tile)
    tiles = k9_tiles(start, total, tile)
    for b in range(ntiles):
        t0 = b * tile
        width = min(total - t0, tile)
        if tiles[b + 1] - tiles[b] > walk:  # a sparse tile: a search an output
            for t in range(t0, t0 + width):
                i = tiles[b] + int(np.searchsorted(start[tiles[b]:tiles[b + 1] + 1], t,
                                                   side="right")) - 1
                k = t - int(start[i])
                sg = min(max(int(seg1[i]), 0), num - 1)
                li[t] = i
                ri[t] = order2[min(max(int(cstart2[sg]) + k, 0), p2 - 1)] if k < m[i] else -1
            continue
        owner = np.full(tile, -1)
        srow, slim, soff = (np.zeros(tile, dtype=np.int64) for _ in range(3))
        for i in range(tiles[b], tiles[b + 1] + 1):
            s, q = int(start[i]), 0
            if i > tiles[b]:
                nxt = int(start[i + 1]) if i + 1 < p1 else total
                if s >= nxt or s - t0 >= width:
                    continue
                q = s - t0
            assert owner[q] == -1  # one row a slot
            sg = min(max(int(seg1[i]), 0), num - 1)
            srow[q], owner[q] = i, q
            slim[q] = min(max(s + int(m[i]) - t0, 0), tile)
            soff[q] = min(max(int(cstart2[sg]) - s + t0, -tile), p2)
        own = np.maximum.accumulate(owner)
        for r in range(width):
            o = own[r]
            li[t0 + r] = srow[o]
            ri[t0 + r] = order2[min(max(soff[o] + r, 0), p2 - 1)] if r < slim[o] else -1
    return torch.from_numpy(li.astype(np.int32)), torch.from_numpy(ri.astype(np.int32))


@jax.jit
def _jax_expand(start: Any, m: Any, seg1: Any, cstart2: Any, order2: Any, t: Any) -> Any:
    """The index lines of the JAX package's ``_gather_prog`` on one device
    (``fugue_tpu/jax_backend/relational.py:557-573``): marks at the starts,
    their cumulative sum, the clamps and the build row."""
    p1, num, p2 = start.shape[0], cstart2.shape[0], order2.shape[0]
    marks = jnp.zeros(t.shape, jnp.int32).at[start].add(1, mode="drop")
    i = jnp.clip(jnp.cumsum(marks) - 1, 0, p1 - 1)
    j_local = t - start[i]
    matched = j_local < m[i]
    s = jnp.clip(seg1[i], 0, num - 1)
    rpos = jnp.clip(cstart2[s] + j_local, 0, p2 - 1)
    return i, jnp.where(matched, order2[rpos], -1)


@pytest.fixture(scope="module")
def k9_cases() -> List[Any]:
    skew = chip_smoke.JOIN_SKEW
    chip_smoke.JOIN_SKEW = 5000  # the skewed key's build rows, cut for the CPU
    try:
        return [(f"{label} n={n}", case) for n in (1, 37, 2100)
                for label, case in chip_smoke.expand_cases(CPU, n, chip_smoke.SEED + n)
                if case["total"] <= 250_000]
    finally:
        chip_smoke.JOIN_SKEW = skew


@pytest.mark.parametrize("tile", [8, 64, 2048])
def test_k9_model_matches_the_twin(k9_cases, tile):
    for label, case in k9_cases:
        if tile == 8 and case["total"] > 20_000:
            continue
        got, want = k9_model(**case, tile=tile), R.join_expand_reference(**case)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), label


@pytest.mark.parametrize("walk", [0, 1, 10**9])
def test_k9_model_either_branch_alone_matches_the_twin(k9_cases, walk):
    """Every tile searched (``walk`` 0 and 1) or every tile walked, at 64
    outputs a tile."""
    for label, case in k9_cases:
        got, want = k9_model(**case, tile=64, walk=walk), R.join_expand_reference(**case)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), label


def test_k9_cases_take_both_branches_at_the_kernel_tile(monkeypatch):
    """At the kernel's tile (2048 outputs, ``K9_WALK`` probe rows) the
    sparse cases search: one in 50,000 past a few tiles' walk of probe
    rows; the dense-then-sparse case walks its first tiles and searches its
    last; one in 50 and the pairs walk every tile."""
    monkeypatch.setattr(chip_smoke, "JOIN_SKEW", 5000)
    n = 1_000_000
    by = dict(chip_smoke.expand_cases(CPU, n, chip_smoke.SEED))

    def spans(label: str) -> np.ndarray:
        return np.diff(k9_tiles(by[label]["start"].numpy(), by[label]["total"], 2048))

    assert (spans("sparse, 1 in 50000") > chip_smoke.K9_WALK).all()
    mixed = spans("dense, then 1 in 50000")
    assert mixed[0] <= chip_smoke.K9_WALK < mixed[-1]
    for label in ("sparse", "pairs inner"):
        assert (spans(label) <= chip_smoke.K9_WALK).all(), label
    for label in ("sparse, 1 in 50000", "dense, then 1 in 50000"):
        got = k9_model(**by[label], tile=2048, walk=chip_smoke.K9_WALK)
        want = R.join_expand_reference(**by[label])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), label


def test_k9_twin_matches_the_jax_gather_program(k9_cases):
    for label, case in k9_cases:
        total = case["total"]
        li, ri = R.join_expand_reference(**case)
        args = [jnp.asarray(case[k].numpy().astype(np.int32))
                for k in ("start", "m", "seg1", "cstart2", "order2")]
        ji, jr = _jax_expand(*args, jnp.arange(total, dtype=jnp.int32))
        np.testing.assert_array_equal(li.numpy(), np.asarray(ji), err_msg=label)
        np.testing.assert_array_equal(ri.numpy(), np.asarray(jr), err_msg=label)


def test_k9_cases_cover_the_kernel_tiles(k9_cases):
    """A probe row with no match at a tile's first output, one output in
    all, and a run that starts inside a tile and spans several."""
    by = dict(k9_cases)
    hole = by["m = 0 at a tile's first output, inner n=2100"]
    assert int(hole["m"][2048]) == 0 and int(hole["start"][2048]) == 2048
    assert by["total = 1 n=37"]["total"] == 1
    run = by["a run from mid-tile over several tiles n=2100"]
    i = int(torch.argmax(run["m"]))
    assert int(run["start"][i]) % 2048 != 0 and int(run["m"][i]) > 2 * 2048
