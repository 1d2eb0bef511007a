"""The store through a sort's order by slab (``kernels/order_scatter.cuh``)
and K16's single-pass scans (``kernels/window.cu``), as numpy models of
their steps, against the twins they must equal.

- ``scatter_model``: step 1 groups each tile's entries by slab and
  reserves one run a slab in the slab's bucket, tiles finishing in any
  order and entries in any order within a slab; step 2 places each
  bucket's entries into an image of its slab and writes it. Held against
  ``sort_finish_reference`` bit for bit (rows that are not real and
  ``first_idx`` included), and against ``window_frame_reference`` when fed
  the twin's results in sorted order.
- ``lookback_scan``: tiles that combine only through published aggregates
  and inclusive prefixes, looking back 32 tiles at a time, in any
  completion order. Held against ``window_positions`` and the twin's
  partition prefixes, then the running sum read at each peer group's end
  against ``window_frame_reference``.

Sizes: 1, 31 and 33 rows, one tile and one slab each side, and several
slabs with a short last one; a small slab and tile so that rows span many
of both. Also rehearses ``chip_smoke.sort_finish_slab_cases`` with the
twin standing in for K3."""

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import pytest
import torch

import chip_smoke
from fugue_tpu_torch.kernels import factorize as factorize_kernels
from fugue_tpu_torch.kernels import reference as R
from fugue_tpu_torch.torch_backend import relational

SHIFT = 4  # a slab of 16 rows
TILE = 8  # positions a tile
SIZES = (1, 31, 33, TILE - 1, TILE + 1, (1 << SHIFT) - 1, (1 << SHIFT) + 1, 3 * (1 << SHIFT) + 5)
VALID_BIT = 1 << 31


def scatter_model(rows: np.ndarray, values: np.ndarray, valid: np.ndarray, n: int, shift: int,
                  tile: int, rng: np.random.Generator
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``out[rows[j]] = values[j]`` (and the mask ``valid[j]``) for every
    position j, by slab: step 1 tile by tile in a random completion order,
    step 2 slab by slab. Returns ``(out, mask, fill)``, ``fill`` each
    bucket's entries. ``rows`` must be a permutation of ``[0, n)``."""
    nslabs = -(-n >> shift)
    offs = np.full(n, -1, dtype=np.int64)
    vals = np.zeros(n, dtype=values.dtype)
    fill = np.zeros(nslabs, dtype=np.int64)

    def bucket_rows(s: int) -> int:
        return min(1 << shift, n - (s << shift))

    tiles = list(range(-(-n // tile)))
    rng.shuffle(tiles)
    for t in tiles:  # step 1
        pos = np.arange(t * tile, min(n, (t + 1) * tile))
        slab = rows[pos] >> shift
        for s in np.unique(slab):
            run = pos[slab == s]
            run = run[rng.permutation(len(run))]  # entries of a slab in any order
            base = fill[s]
            fill[s] += len(run)
            for i, p in enumerate(run):
                if base + i < bucket_rows(s):
                    e = (s << shift) + base + i
                    offs[e] = (rows[p] & ((1 << shift) - 1)) | (VALID_BIT if valid[p] else 0)
                    vals[e] = values[p]
    out = np.zeros(n, dtype=values.dtype)
    mask = np.zeros(n, dtype=bool)
    for s in range(nslabs):  # step 2
        r0, count = s << shift, bucket_rows(s)
        image = np.full(count, -7, dtype=values.dtype)  # never cleared: every row is placed
        image_valid = np.zeros(count, dtype=bool)
        placed = np.zeros(count, dtype=bool)
        for e in range(r0, r0 + min(fill[s], count)):
            at = offs[e] & ~VALID_BIT
            image[at], image_valid[at], placed[at] = vals[e], bool(offs[e] & VALID_BIT), True
        assert placed.all(), f"slab {s} has a hole"
        out[r0:r0 + count], mask[r0:r0 + count] = image, image_valid
    return out, mask, fill


def _slab_rows(n: int, shift: int) -> np.ndarray:
    slabs = -(-n >> shift)
    want = np.full(slabs, 1 << shift)
    want[-1] = n - ((slabs - 1) << shift)
    return want


def _sorted_segments(n: int, rng: np.random.Generator) -> Tuple[np.ndarray, int]:
    """Sorted segment ids of groups of 1 to 6 positions, the last tenth of
    the positions not real (-1), and the group count."""
    opens = rng.integers(0, 6, n) == 0
    opens[0] = True
    seg = np.cumsum(opens) - 1
    real = n - n // 10
    seg[real:] = -1
    return seg.astype(np.int32), int(seg[real - 1]) + 1 if real > 0 else 0


@pytest.mark.parametrize("n", SIZES)
def test_scatter_model_is_sort_finish(n):
    rng = np.random.default_rng(n)
    seg_sorted, num = _sorted_segments(n, rng)
    order = rng.permutation(n)
    values = np.where(seg_sorted < 0, num, seg_sorted).astype(np.int32)
    seg, _, fill = scatter_model(order, values, np.ones(n, dtype=bool), n, SHIFT, TILE, rng)
    # K3's first rows: the row at each position that opens a group
    opens = seg_sorted >= 0
    opens[1:] &= seg_sorted[1:] != seg_sorted[:-1]
    first_idx = np.zeros(num, dtype=np.int32)
    first_idx[seg_sorted[opens]] = order[opens]
    want = R.sort_finish_reference(torch.from_numpy(seg_sorted), torch.from_numpy(order), num)
    np.testing.assert_array_equal(seg, want[0].numpy())
    np.testing.assert_array_equal(first_idx, want[1].numpy())
    np.testing.assert_array_equal(fill, _slab_rows(n, SHIFT))


def _frame_data(n: int, parts: int, seed: int) -> Dict[str, Any]:
    """A masked frame of ``n`` rows (a tenth not real) in ``parts``
    partitions, ordered by an int key with ties, and a float and an int
    argument with nulls and NaN."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v[rng.random(n) < 0.05] = np.nan
    return dict(part=rng.integers(0, parts, n).astype(np.int32), real=rng.random(n) >= 0.1,
                key=rng.integers(0, 5, n).astype(np.int32), v=v, vmask=rng.random(n) > 0.1,
                iv=rng.integers(-50, 50, n).astype(np.int64), parts=parts)


def _sorted_words(d: Dict[str, Any]) -> R.SortedWords:
    n, parts = len(d["part"]), d["parts"]
    seg = torch.from_numpy(np.where(d["real"], d["part"], parts).astype(np.int32))
    keys = [R.PresortKey(seg, kmin=0, bits=max(1, parts.bit_length())),
            R.PresortKey(torch.from_numpy(d["key"]), kmin=0, bits=3)]
    return relational.presort_sorted(keys, n, torch.device("cpu"),
                                     row_valid=torch.from_numpy(d["real"]))


FRAMES = [("sum", "running", ("up", 0), ("c", 0)), ("avg", "rows", ("p", 2), ("c", 0)),
          ("min", "groups", ("p", 1), ("f", 1)), ("lag", "running", ("up", 0), ("c", 0)),
          ("count", "rows", ("c", 0), ("uf", 0)), ("last_value", "running", ("up", 0), ("c", 0))]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("func,unit,lo,hi", FRAMES, ids=lambda x: str(x))
def test_scatter_model_is_window_frame(n, func, unit, lo, hi):
    d = _frame_data(n, 3, n)
    sw = _sorted_words(d)
    for arg in ("v", "iv"):
        fr = R.WindowFrame(func, 1 if func == "lag" else 0, unit, lo, hi,
                           torch.from_numpy(d[arg]), torch.from_numpy(d["vmask"]),
                           route=R.frame_route(func, unit, lo, hi))
        out, mask = R.window_frame_reference(sw, fr)
        order = sw.order.numpy()
        sorted_bits = out.numpy().view(np.int64)[order]
        sorted_valid = np.ones(n, dtype=bool) if mask is None else mask.numpy()[order]
        got, got_mask, fill = scatter_model(order, sorted_bits, sorted_valid, n, SHIFT, TILE,
                                            np.random.default_rng(7))
        np.testing.assert_array_equal(got, out.numpy().view(np.int64))
        if mask is not None:
            np.testing.assert_array_equal(got_mask, mask.numpy())
        np.testing.assert_array_equal(fill, _slab_rows(n, SHIFT))


# ---- the single-pass scans ----------------------------------------------


def lookback_scan(elements: List[Any], combine: Callable[[Any, Any], Any], identity: Any,
                  tile: int, rng: np.random.Generator, window: int = 32) -> List[Any]:
    """The inclusive scan of ``elements`` as K16's single-pass launches
    take it: tiles of ``tile`` elements, each scanned alone; a tile
    publishes its aggregate, then looks back over up to ``window`` tiles at
    a time (each must have published something; an inclusive prefix ends
    the walk, an aggregate is combined and the walk goes on) and publishes
    its inclusive prefix. The tiles' steps interleave in a random order."""
    ntiles = -(-len(elements) // tile)
    local = []
    for t in range(ntiles):
        run, scanned = identity, []
        for e in elements[t * tile:(t + 1) * tile]:
            run = combine(run, e)
            scanned.append(run)
        local.append(scanned)
    aggregate: Dict[int, Any] = {}
    inclusive: Dict[int, Any] = {}
    prefix: Dict[int, Any] = {}
    pending = [(t, "publish") for t in range(ntiles)]
    while pending:
        ready = [i for i, (t, step) in enumerate(pending)
                 if step == "publish" or all(u in aggregate for u in range(max(0, t - window), t))]
        t, step = pending.pop(ready[int(rng.integers(0, len(ready)))])
        if step == "publish":
            aggregate[t] = local[t][-1]
            if t == 0:
                prefix[0], inclusive[0] = identity, local[0][-1]
            else:
                pending.append((t, "look back"))
            continue
        excl, end = identity, t
        while True:  # one window: the tiles end - 1 down to end - window
            seen, stop = [], False
            for u in range(end - 1, max(-1, end - 1 - window), -1):
                if u in inclusive:
                    seen.append(inclusive[u])
                    stop = True
                    break
                seen.append(aggregate[u])
            if not stop and end - window <= 0:
                stop = True  # the window reached tile 0, whose prefix is the identity
            for value in seen:
                excl = combine(value, excl)
            if stop:
                break
            end -= window
            if not all(u in aggregate for u in range(max(0, end - window), end)):
                pending.append((t, "look back"))  # spins: take the step again later
                excl = None
                break
        if excl is None:
            continue
        prefix[t] = excl
        inclusive[t] = combine(excl, local[t][-1])
    return [combine(prefix[t], v) for t in range(ntiles) for v in local[t]]


def forward_combine(x: Tuple, y: Tuple) -> Tuple:
    """K16's forward element (ps, gs, cnt, start, sum, count, min)."""
    ps, gs, cnt = max(x[0], y[0]), max(x[1], y[1]), x[2] + y[2]
    if y[3]:
        return (ps, gs, cnt, 1, y[4], y[5], y[6])
    return (ps, gs, cnt, x[3], x[4] + y[4], x[5] + y[5], min(x[6], y[6]))


def reverse_combine(x: Tuple, y: Tuple) -> Tuple:
    return (min(x[0], y[0]), min(x[1], y[1]))


def _scan_case(d: Dict[str, Any], tile: int, seed: int) -> None:
    sw = _sorted_words(d)
    n = len(d["part"])
    order = sw.order.numpy()
    w = sw.words[0].numpy().astype(np.int64) & 0xFFFFFFFF
    pk = w >> sw.part_shift
    head = np.ones(n, dtype=bool)
    head[1:] = pk[1:] != pk[:-1]
    peer = head.copy()
    peer[1:] |= w[1:] != w[:-1]
    values = d["v"][order]
    ok = d["vmask"][order] & ~np.isnan(values)
    vals = np.where(ok, values, 0.0)
    rng = np.random.default_rng(seed)
    fwd = [(j if head[j] else -1, j if peer[j] else -1, int(peer[j]), int(head[j]), vals[j],
            int(ok[j]), vals[j] if ok[j] else np.inf) for j in range(n)]
    got = lookback_scan(fwd, forward_combine, (-1, -1, 0, 0, 0.0, 0, np.inf), tile, rng)
    pend = np.ones(n, dtype=bool)
    pend[:-1] = head[1:]
    gend = np.ones(n, dtype=bool)
    gend[:-1] = peer[1:]
    big = 1 << 31
    rev = [(j if pend[j] else big, j if gend[j] else big) for j in range(n - 1, -1, -1)]
    ends = lookback_scan(rev, reverse_combine, (big, big), tile, rng)[::-1]
    p = R.window_positions(sw)
    for i, name in enumerate(("ps", "gs", "cnt")):
        np.testing.assert_array_equal([g[i] for g in got], p[name].numpy(), err_msg=name)
    np.testing.assert_array_equal([e[0] for e in ends], p["pe"].numpy())
    np.testing.assert_array_equal([e[1] for e in ends], p["ge"].numpy())
    ps = p["ps"]
    prefix = R._partition_prefix(torch.from_numpy(vals), ps).numpy()
    scale = max(1.0, float(np.abs(prefix).max()) if n else 1.0)
    np.testing.assert_allclose([g[4] for g in got], prefix, rtol=1e-12, atol=1e-12 * scale)
    np.testing.assert_array_equal([g[5] for g in got],
                                  R._partition_prefix(torch.from_numpy(ok.astype(np.int64)),
                                                      ps).numpy())
    running_min = np.array([g[6] for g in got])
    for j in range(n):  # the running extremum from each partition's start
        start = int(p["ps"][j])
        seg = vals[start:j + 1][ok[start:j + 1]]
        assert running_min[j] == (seg.min() if len(seg) else np.inf)
    # the running sum: each position reads the prefix at its peer group's end
    ge = np.array([e[1] for e in ends])
    real = d["real"][order]
    count = np.array([g[5] for g in got])[ge]
    sums = np.array([g[4] for g in got])[ge]
    fr = R.WindowFrame("sum", 0, "running", ("up", 0), ("c", 0), torch.from_numpy(d["v"]),
                       torch.from_numpy(d["vmask"]), route="prefix")
    out, mask = R.window_frame_reference(sw, fr)
    has = (count > 0) & real
    np.testing.assert_array_equal(has, mask.numpy()[order])
    np.testing.assert_allclose(np.where(has, sums, 0.0), out.numpy()[order], rtol=1e-12,
                               atol=1e-12 * scale)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("parts", [1, 3, 10_000], ids=["one partition", "three", "1-row"])
def test_lookback_scan_matches_the_twin(n, parts):
    """Partitions and peer groups across tile edges (three partitions),
    one partition of every row, and partitions of one row; rows that are
    not real sort last."""
    _scan_case(_frame_data(n, parts, 100 + n), TILE, n)


@pytest.mark.parametrize("seed", range(6))
def test_lookback_scan_any_completion_order(seed):
    """Many tiles (past one look-back window of 32) finishing in other
    orders give the same prefixes."""
    _scan_case(_frame_data(300, 4, seed), 4, seed)


def test_chip_smoke_sort_finish_slab_phase_on_cpu(monkeypatch):
    """``chip_smoke.sort_finish_slab_cases`` with K3's twin standing in for
    the kernel (small slabs, bucket counts as a permutation leaves them)."""
    sizes = []

    def finish(seg_sorted: torch.Tensor, order: torch.Tensor, num: int) -> Any:
        n = int(order.shape[0])
        finish.last_shift = SHIFT
        finish.last_fill = torch.from_numpy(_slab_rows(n, SHIFT).astype(np.int32))
        sizes.append(n)
        return R.sort_finish_reference(seg_sorted, order, num)

    monkeypatch.setattr(factorize_kernels, "sort_finish_cuda", finish)
    chip_smoke.sort_finish_slab_cases(torch.device("cpu"))
    assert sizes[1:] == list(chip_smoke.slab_sizes(SHIFT))


# ---- K15 on the same machinery ------------------------------------------


def rank_combine(x: Tuple, y: Tuple) -> Tuple:
    """K15's forward element (ps, gs, dense rank, start): the dense rank
    counts peer heads since the last partition start."""
    return (max(x[0], y[0]), max(x[1], y[1]), y[2] if y[3] else x[2] + y[2], x[3] | y[3])


def rank_model(sw: R.SortedWords, func: str, param: int, tile: int,
               rng: np.random.Generator) -> np.ndarray:
    """``window.cu``'s K15: ``rank_forward``'s look-back scan; for
    row_number, rank and dense_rank each result from it, for ntile,
    percent_rank and cume_dist from ps and gs and the reverse scan's pe
    and ge; then the store through the order by slab (``scatter_model``)."""
    order = sw.order.numpy()
    n = len(order)
    w = sw.words[0].numpy().astype(np.int64)
    w = w & 0xFFFFFFFF if sw.words[0].dtype == torch.int32 else w
    pk = w.astype(np.uint64) >> np.uint64(sw.part_shift)
    head = np.ones(n, dtype=bool)
    head[1:] = pk[1:] != pk[:-1]
    peer = head.copy()
    for word in sw.words:
        x = word.numpy()
        peer[1:] |= x[1:] != x[:-1]
    fwd = [(j if head[j] else -1, j if peer[j] else -1, int(peer[j]), int(head[j]))
           for j in range(n)]
    got = lookback_scan(fwd, rank_combine, (-1, -1, 0, 0), tile, rng)
    ps, gs, dr = (np.array([g[i] for g in got], dtype=np.int64) for i in range(3))
    pend = np.ones(n, dtype=bool)
    pend[:-1] = head[1:]
    gend = np.ones(n, dtype=bool)
    gend[:-1] = peer[1:]
    big = 1 << 31
    rev = [(j if pend[j] else big, j if gend[j] else big) for j in range(n - 1, -1, -1)]
    ends = lookback_scan(rev, reverse_combine, (big, big), tile, rng)[::-1]
    pe, ge = (np.array([e[i] for e in ends], dtype=np.int64) for i in range(2))
    j = np.arange(n)
    local, psize = j - ps, pe - ps + 1
    if func == "row_number":
        res = local + 1
    elif func == "rank":
        res = gs - ps + 1
    elif func == "dense_rank":
        res = dr
    elif func == "ntile":
        q, rem = psize // param, psize % param
        cutoff = rem * (q + 1)
        res = np.where(local < cutoff, local // (q + 1) + 1,
                       rem + (local - cutoff) // np.maximum(q, 1) + 1)
    elif func == "percent_rank":
        res = np.where(psize > 1, (gs - ps) / np.maximum(psize - 1, 1), 0.0).view(np.int64)
    else:
        res = ((ge - ps + 1) / psize).view(np.int64)
    out, _, fill = scatter_model(order, res.astype(np.int64), np.ones(n, dtype=bool), n, SHIFT,
                                 tile, rng)
    np.testing.assert_array_equal(fill, _slab_rows(n, SHIFT))
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("func,param", chip_smoke.RANK_CASES, ids=str)
def test_rank_model_matches_the_twin(n, func, param):
    """K15's model against ``window_rank_reference`` bit for bit on every
    edge order of ``chip_smoke.rank_edge_orders`` (one partition, a
    partition a row, one peer group, random partitions; a random and an
    ascending order) at the tiles' and slabs' edges."""
    for label, sw in chip_smoke.rank_edge_orders(torch.device("cpu"), n, n):
        want = R.window_rank_reference(sw, func, param).numpy().view(np.int64)
        got = rank_model(sw, func, param, TILE, np.random.default_rng(n))
        np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("parts", [1, 3, 10_000], ids=["one partition", "three", "1-row"])
def test_rank_model_on_a_masked_frame(parts):
    """K15's model on a masked frame's window order (rows that are not
    real sort last, ranked as the twin ranks them), many tiles finishing
    in random orders."""
    sw = _sorted_words(_frame_data(300, parts, parts))
    for func, param in chip_smoke.RANK_CASES:
        want = R.window_rank_reference(sw, func, param).numpy().view(np.int64)
        np.testing.assert_array_equal(rank_model(sw, func, param, 4,
                                                 np.random.default_rng(parts)), want)
