"""K15's and K16's twins (``window_rank_reference``,
``window_frame_reference``) and the window order (``relational.
presort_sorted``) against a per-partition loop in numpy and Python: the
rows ordered by ``numpy.lexsort``, each partition walked row by row, each
frame found by its definition and each function taken over it. Ranks,
counts, integer sums, extrema, positional values and masks exactly;
float64 sums within rtol 1e-9 and an atol of 1e-12 times the partition's
largest absolute prefix sum (the twin sums per partition in window order,
the loop over each frame from its first row). Also holds ``window.
frame_plan`` (which frames K16's reverse scan finishes) and rehearses
``chip_smoke.window_vs_twin`` and ``window_slab_cases`` on the CPU at a
small size with the twins standing in for the kernels."""

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pytest
import torch

import chip_smoke
from fugue_tpu_torch.kernels import reference as R
from fugue_tpu_torch.kernels import window as window_kernels
from fugue_tpu_torch.torch_backend import relational

N, PARTS = 240, 7


def _data(seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    key = np.round(rng.standard_normal(N) * 2) / 2
    key[rng.random(N) < 0.07] = np.nan
    v = rng.standard_normal(N)
    v[rng.random(N) < 0.05] = np.nan
    return dict(part=rng.integers(0, PARTS, N).astype(np.int32),
                real=rng.random(N) < 0.9,
                key=key, kmask=rng.random(N) > 0.08,
                v=v, vmask=rng.random(N) > 0.06,
                iv=rng.integers(-100, 100, N).astype(np.int64), imask=rng.random(N) > 0.06)


def _window(d: Dict[str, np.ndarray], desc: bool, nulls_first: bool) -> R.SortedWords:
    seg = torch.from_numpy(np.where(d["real"], d["part"], PARTS).astype(np.int32))
    keys = [R.PresortKey(seg, kmin=0, bits=PARTS.bit_length()),
            R.PresortKey(torch.from_numpy(d["key"]), torch.from_numpy(d["kmask"]), desc=desc,
                         nulls_first=nulls_first, nan_is_null=True)]
    return relational.presort_sorted(keys, N, torch.device("cpu"),
                                     row_valid=torch.from_numpy(d["real"]))


def _numpy_order(d: Dict[str, np.ndarray], desc: bool, nulls_first: bool
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The window order by ``numpy.lexsort`` (real rows by partition, then
    the key, nulls and NaN first or last, ties in row order; rows that are
    not real last) and each row's key as it orders (null: None)."""
    null = ~d["kmask"] | np.isnan(d["key"])
    k = np.where(null, 0.0, d["key"]) + 0.0
    k = -k if desc else k
    flag = ~null if nulls_first else null
    part = np.where(d["real"], d["part"], PARTS)
    order = np.lexsort((np.arange(N), k, flag, part, ~d["real"]))
    return order, np.where(null, np.nan, k)


def _partitions(order: np.ndarray, d: Dict[str, np.ndarray]) -> List[np.ndarray]:
    """The sorted positions of each real partition."""
    part = np.where(d["real"], d["part"], PARTS)[order]
    return [np.nonzero(part == p)[0] for p in range(PARTS + 1) if (part == p).any()]


def _peers(pos: np.ndarray, okey: np.ndarray) -> np.ndarray:
    """Each position's peer group index within its partition."""
    g, out = -1, np.empty(len(pos), dtype=np.int64)
    for i in range(len(pos)):
        a, b = okey[pos[i]], okey[pos[i - 1]] if i else None
        same = i > 0 and ((np.isnan(a) and np.isnan(b)) or a == b)
        g += 0 if same else 1
        out[i] = g
    return out


def numpy_rank(d: Dict[str, np.ndarray], func: str, param: int, desc: bool,
               nulls_first: bool) -> np.ndarray:
    order, okey = _numpy_order(d, desc, nulls_first)
    out = np.zeros(N, dtype=np.float64 if func in ("percent_rank", "cume_dist") else np.int64)
    for pos in _partitions(order, d):
        g = _peers(pos, okey[order])
        m = len(pos)
        for i in range(m):
            first = int(np.argmax(g == g[i]))
            last = int(len(g) - 1 - np.argmax(g[::-1] == g[i]))
            if func == "row_number":
                r: Any = i + 1
            elif func == "rank":
                r = first + 1
            elif func == "dense_rank":
                r = g[i] + 1
            elif func == "ntile":
                q, rem = divmod(m, param)
                r = i // (q + 1) + 1 if i < rem * (q + 1) else rem + (i - rem * (q + 1)) // max(q, 1) + 1
            elif func == "percent_rank":
                r = first / (m - 1) if m > 1 else 0.0
            else:
                r = (last + 1) / m
            out[order[pos[i]]] = r
    return out


def _bounds(func_frame: Tuple[str, Tuple[str, float], Tuple[str, float]], i: int,
            g: np.ndarray, keys: np.ndarray) -> Tuple[int, int]:
    """Local frame [lo, hi] of position ``i`` of a partition."""
    unit, (sk, sn), (ek, en) = func_frame
    m = len(g)
    gfirst = lambda grp: int(np.argmax(g == grp))  # noqa: E731
    glast = lambda grp: int(m - 1 - np.argmax(g[::-1] == grp))  # noqa: E731
    if unit == "running":
        return 0, glast(g[i])

    def bound(kind: str, n: float, start: bool) -> int:
        if kind == "up":
            return 0
        if kind == "uf":
            return m - 1
        if unit == "rows":
            return i + (0 if kind == "c" else int(n) if kind == "f" else -int(n))
        if kind == "c":
            return gfirst(g[i]) if start else glast(g[i])
        if unit == "groups":
            tg = g[i] + (int(n) if kind == "f" else -int(n))
            if tg < 0:
                return 0 if start else -1
            if tg > g[-1]:
                return m if start else m - 1
            return gfirst(tg) if start else glast(tg)
        if np.isnan(keys[i]):
            return gfirst(g[i]) if start else glast(g[i])
        t = keys[i] + (n if kind == "f" else -n)
        ok = [j for j in range(m) if not np.isnan(keys[j]) and
              (keys[j] >= t if start else keys[j] <= t)]
        if not ok:
            nonnull = [j for j in range(m) if not np.isnan(keys[j])]
            return (nonnull[-1] + 1) if start else (nonnull[0] - 1)
        return ok[0] if start else ok[-1]

    return max(bound(sk, sn, True), 0), min(bound(ek, en, False), m - 1)


def numpy_frame(d: Dict[str, np.ndarray], fr: R.WindowFrame, arg: str, desc: bool,
                nulls_first: bool) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    order, okey = _numpy_order(d, desc, nulls_first)
    vals = d[arg] if arg != "*" else None
    ok = None if vals is None else d["vmask" if arg == "v" else "imask"] & ~np.isnan(
        vals.astype(float))
    dtype = np.float64 if fr.func == "avg" or (vals is not None and vals.dtype.kind == "f") \
        else np.int64
    out, mask = np.zeros(N, dtype=dtype), np.zeros(N, dtype=bool)
    for pos in _partitions(order, d):
        rows = order[pos]
        g = _peers(pos, okey[order])
        keys = okey[rows]  # as it orders: negated where descending
        for i, r in enumerate(rows):
            if fr.func in ("lag", "lead"):
                j = i - fr.param if fr.func == "lag" else i + fr.param
                if 0 <= j < len(rows):
                    out[r], mask[r] = (vals[rows[j]] if ok[rows[j]] else 0), ok[rows[j]]
                else:
                    out[r], mask[r] = (fr.default or 0), fr.default is not None
                continue
            lo, hi = _bounds((fr.unit, fr.lo, fr.hi), i, g, keys)
            span = rows[lo:hi + 1] if lo <= hi else rows[:0]
            if fr.func == "count_star":
                out[r] = len(span)
                continue
            if fr.func in ("first_value", "last_value", "nth_value"):
                at = {"first_value": 0, "last_value": len(span) - 1,
                      "nth_value": fr.param - 1}[fr.func]
                if 0 <= at < len(span) and ok[span[at]]:
                    out[r], mask[r] = vals[span[at]], True
                continue
            good = span[ok[span]]
            if fr.func == "count":
                out[r] = len(good)
                continue
            mask[r] = len(good) > 0
            if not len(good):
                continue
            x = vals[good]
            out[r] = {"sum": lambda: x.sum(), "avg": lambda: x.sum() / len(x),
                      "min": lambda: x.min(), "max": lambda: x.max()}[fr.func]()
    return out, (None if fr.func in ("count", "count_star") else mask)


FRAMES = [("running", ("up", 0), ("c", 0)), ("rows", ("p", 2), ("c", 0)),
          ("rows", ("p", 1), ("f", 3)), ("rows", ("c", 0), ("uf", 0)),
          ("rows", ("f", 1), ("f", 2)), ("groups", ("p", 1), ("c", 0)),
          ("groups", ("p", 2), ("f", 1)), ("range", ("p", 1), ("f", 0.5)),
          ("range", ("up", 0), ("p", 0.5)), ("range", ("c", 0), ("uf", 0))]
ORDERS = [(False, False), (True, True)]


@pytest.mark.parametrize("desc,nulls_first", ORDERS)
def test_window_order_is_numpys_lexsort(desc, nulls_first):
    d = _data(1)
    sw = _window(d, desc, nulls_first)
    order, _ = _numpy_order(d, desc, nulls_first)
    np.testing.assert_array_equal(sw.order.numpy(), order)


@pytest.mark.parametrize("desc,nulls_first", ORDERS)
@pytest.mark.parametrize("func,param", [("row_number", 0), ("rank", 0), ("dense_rank", 0),
                                        ("ntile", 1), ("ntile", 4), ("percent_rank", 0),
                                        ("cume_dist", 0)])
def test_rank_twin_matches_the_loop(func, param, desc, nulls_first):
    d = _data(2)
    got = R.window_rank_reference(_window(d, desc, nulls_first), func, param).numpy()
    want = numpy_rank(d, func, param, desc, nulls_first)
    np.testing.assert_array_equal(got[d["real"]], want[d["real"]])


def _frame(func: str, frame: Tuple[Any, ...], arg: str, d: Dict[str, np.ndarray], desc: bool,
           param: int = 0, default: Any = None) -> R.WindowFrame:
    unit, lo, hi = frame
    values = vmask = None
    if arg != "*":
        values = torch.from_numpy(d[arg].astype(np.float64 if arg == "v" else np.int64))
        vmask = torch.from_numpy(d["vmask" if arg == "v" else "imask"])
    return R.WindowFrame(func, param, unit, lo, hi, values, vmask, default,
                         torch.from_numpy(d["key"]), torch.from_numpy(d["kmask"]), desc,
                         R.frame_route(func, unit, lo, hi))


def _compare(got: Tuple[Any, Any], want: Tuple[np.ndarray, Any], real: np.ndarray,
             sums: bool, atol: float) -> None:
    gv, gm = got[0].numpy()[real], None if got[1] is None else got[1].numpy()[real]
    wv, wm = want[0][real], None if want[1] is None else want[1][real]
    if wm is not None:
        np.testing.assert_array_equal(gm, wm)
        gv, wv = np.where(wm, gv, 0), np.where(wm, wv, 0)
    if sums:
        np.testing.assert_allclose(gv, wv, rtol=1e-9, atol=atol)
    else:
        np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("desc,nulls_first", ORDERS)
@pytest.mark.parametrize("frame", FRAMES, ids=lambda f: f"{f[0]}-{f[1][0]}{f[1][1]}-{f[2][0]}{f[2][1]}")
def test_frame_twin_matches_the_loop(frame, desc, nulls_first):
    d = _data(3)
    sw = _window(d, desc, nulls_first)
    atol = 1e-12 * float(np.nansum(np.abs(np.where(d["vmask"], d["v"], 0))))
    for func in ("count_star", "count", "sum", "avg", "min", "max", "first_value",
                 "last_value", "nth_value"):
        for arg in (("*",) if func == "count_star" else ("v", "iv")):
            fr = _frame(func, frame, arg, d, desc, param=2 if func == "nth_value" else 0)
            got = R.window_frame_reference(sw, fr)
            want = numpy_frame(d, fr, arg, desc, nulls_first)
            _compare(got, want, d["real"], func in ("sum", "avg") and arg == "v", atol)


@pytest.mark.parametrize("func,param,default", [("lag", 1, None), ("lead", 2, None),
                                                ("lag", 3, 0), ("lead", 1, -7)])
def test_lag_lead_twin_matches_the_loop(func, param, default):
    d = _data(4)
    sw = _window(d, False, False)
    for arg in ("v", "iv"):
        fr = _frame(func, ("running", ("up", 0), ("c", 0)), arg, d, False, param, default)
        _compare(R.window_frame_reference(sw, fr), numpy_frame(d, fr, arg, False, False),
                 d["real"], False, 0.0)


def test_frame_routes():
    assert R.frame_route("sum", "running", ("up", 0), ("c", 0)) == "prefix"
    assert R.frame_route("min", "rows", ("up", 0), ("f", 9)) == "prefix"
    assert R.frame_route("avg", "rows", ("p", 6), ("c", 0)) == "loop"
    assert R.frame_route("max", "rows", ("p", 32), ("f", 31)) == "loop"
    assert R.frame_route("max", "rows", ("p", 32), ("f", 32)) == "span"
    assert R.frame_route("min", "rows", ("c", 0), ("uf", 0)) == "span"
    assert R.frame_route("sum", "groups", ("p", 1), ("f", 1)) == "span"
    assert R.frame_route("lag", "running", ("up", 0), ("c", 0)) == "prefix"


_SHIFT = 6  # slabs of 64 rows for the rehearsals


def test_frame_plan_fuses_the_frames_whose_bounds_are_their_own():
    """K16's reverse scan computes the results of running and ROWS frames
    (but the table route's min/max), reading back only the partition
    start, and none for the running frame's aggregates; GROUPS, RANGE and
    the table route read every bound in ``frame_final``."""
    def plan(func: str, unit: str, lo: Any, hi: Any) -> Any:
        return window_kernels.frame_plan(
            R.WindowFrame(func, 0, unit, lo, hi, route=R.frame_route(func, unit, lo, hi)))

    running, every = (("up", 0), ("c", 0)), ("ps", "pe", "gs", "ge", "cnt")
    for func in ("count", "sum", "avg", "min", "max"):
        assert plan(func, "running", *running) == (True, ())
    for func in ("count_star", "lag", "lead", "first_value", "nth_value"):
        assert plan(func, "running", *running) == (True, ("ps",))
    assert plan("avg", "rows", ("p", 6), ("c", 0)) == (True, ("ps",))  # loop
    assert plan("sum", "rows", ("c", 0), ("uf", 0)) == (True, ("ps",))  # span: prefix sums
    assert plan("min", "rows", ("up", 0), ("f", 2)) == (True, ("ps",))  # prefix
    assert plan("max", "rows", ("c", 0), ("uf", 0)) == (False, every)  # the table
    assert plan("sum", "groups", ("p", 1), ("c", 0)) == (False, every)
    assert plan("count", "range", ("p", 1), ("c", 0)) == (False, every)
    assert plan("first_value", "range", ("c", 0), ("uf", 0)) == (False, every)


@pytest.fixture
def twins_as_kernels(monkeypatch):
    """K15's and K16's wrappers replaced by their twins (with a launch
    count), so that ``chip_smoke``'s phases run here."""
    def rank(*a: Any, **k: Any) -> Any:
        rank.launches += 1
        return R.window_rank_reference(*a, **k)

    def frame(sw: R.SortedWords, fr: R.WindowFrame) -> Any:
        frame.launches += 1
        frame.last_shift = _SHIFT
        n = int(sw.order.shape[0])
        slabs = -(-n >> frame.last_shift)
        frame.last_fill = torch.full((slabs,), 1 << frame.last_shift, dtype=torch.int32)
        frame.last_fill[-1] = n - ((slabs - 1) << frame.last_shift)
        return R.window_frame_reference(sw, fr)

    rank.launches = frame.launches = 0
    frame.last_levels = 0
    monkeypatch.setattr(window_kernels, "window_rank_cuda", rank)
    monkeypatch.setattr(window_kernels, "window_frame_cuda", frame)
    return rank, frame


def test_chip_smoke_window_phase_on_cpu(twins_as_kernels):
    worst = chip_smoke.window_vs_twin(torch.device("cpu"), (1, 300))
    assert math.isfinite(worst)
    assert twins_as_kernels[1].launches > 300


def test_chip_smoke_window_slab_phase_on_cpu(twins_as_kernels):
    """``chip_smoke.window_slab_cases`` at its slabs' edges (small slabs
    here) with the twins as kernels."""
    worst = chip_smoke.window_slab_cases(torch.device("cpu"))
    assert math.isfinite(worst)
    assert twins_as_kernels[1].launches == 1 + 2 * 11  # the probe, 11 frame cases a size


def test_rank_positions_of_the_reverse_functions():
    """K15's forward scan writes no position for the functions it
    finishes, ps for ntile and cume_dist, ps and gs for percent_rank."""
    from fugue_tpu_torch.kernels.window import rank_positions

    assert [rank_positions(f) for f in R.RANK_FUNCS] == [
        (), (), (), ("ps",), ("ps", "gs"), ("ps",)]


def test_chip_smoke_window_rank_edges_on_cpu(twins_as_kernels):
    """``chip_smoke.window_rank_edges`` (every rank function on the edge
    orders at a tile's and a slab's edges, small here) with the twin as
    K15."""
    chip_smoke.window_rank_edges(torch.device("cpu"))
    assert twins_as_kernels[0].launches == 9 * 8 * len(chip_smoke.RANK_CASES)
