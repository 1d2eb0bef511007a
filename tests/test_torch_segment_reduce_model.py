"""A plain numpy model of K4 ``segment_extrema`` and K5 ``segment_sq_dev``
as ``fugue_tpu_torch/kernels/segment_reduce.cu`` computes them, step by
step, at a small scale: runs of ``RUN`` rows a thread, warps of ``WARP``
lanes, blocks of ``THREADS`` threads, a grid of at most ``BLOCKS`` blocks
walking tiles, and a shared-memory limit of ``LIMIT`` bytes, so that wide
segment counts take the global route.

The steps modelled: each thread's run folded into its pending (segment,
value) a group of tables, carried from run to run and flushed with one
update a table where the segment changes, into the lane's replica of the
block's tables (``replicas_for``, ``replica_stride``) or the global
tables; the warps' combine at the end (a butterfly where every lane holds
one segment, else the ``__match_any_sync`` groups reduced in rounds of
shuffles, as ``reduce_peers`` does); the merge of the replicas into the
global tables; K4's decoding of its code tables into the payloads'
dtypes (``extrema_decode``).

The model is held against the kernels' twins over ``chip_smoke.
reduce_cases``' kinds at small n: K4 bit for bit, K5 within rtol 1e-10
(its float64 sums add in the order of the flushes, which differs from the
twin's; so does the card's, which also varies with the order in which
atomics land)."""

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import pytest
import torch

from fugue_tpu_torch.kernels.reference import (
    Extrema,
    Extremum,
    segment_extrema_reference,
    segment_sq_dev_reference,
)

RUN = 4  # rows a thread takes from a tile (8 on the card)
WARP = 4  # lanes a warp (32)
THREADS = 8  # threads a block (256)
BLOCKS = 3  # at most this many blocks (one wave)
BUDGET = 4096  # bytes of replicated tables a block, at most (32 KB)
LIMIT = 8192  # bytes of shared memory a block (the opt-in limit)
MAX_REPLICAS = 8

_U32 = np.uint64(0xFFFFFFFF)
_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def replicas_for(one: int) -> int:
    rep = 1
    while rep < MAX_REPLICAS and 2 * rep * one <= BUDGET:
        rep *= 2
    return rep


def replica_stride(nbytes: int, nrep: int) -> int:
    return (nbytes + 127) // 128 * 128 + (128 // nrep if nrep > 1 else 0)


def ordered_codes(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's order-preserving codes of a payload as uint64: as a
    min table takes them (NaN 0) and as a max table does (NaN all ones of
    the code's width)."""
    if values.dtype in (np.bool_, np.uint8):
        code = values.astype(np.uint64)
        return code, code
    if values.dtype in (np.int8, np.int16, np.int32):
        code = (values.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
        return code, code
    if values.dtype == np.int64:
        code = values.view(np.uint64) ^ np.uint64(1 << 63)
        return code, code
    bits, top, nan_max = ((values.view(np.uint32), np.uint32(1 << 31), _U32)
                          if values.dtype == np.float32
                          else (values.view(np.uint64), np.uint64(1 << 63), _ONES))
    code = np.where(bits & top, ~bits, bits | top).astype(np.uint64)
    nan = np.isnan(values)
    return np.where(nan, np.uint64(0), code), np.where(nan, nan_max, code)


def decode(raw: np.ndarray, dtype: Any, is_max: bool, wide: bool) -> np.ndarray:
    """``extrema_decode``: a K4 table's codes (uint64) as values of
    ``dtype``; the identity is an empty segment and takes the JAX
    package's fill, a float's NaN code the NaN ``float("nan")`` gives."""
    ones = np.uint64(2**64 - 1 if wide else 2**32 - 1)
    empty = raw == (np.uint64(0) if is_max else ones)
    nan = raw == (ones if is_max else np.uint64(0))
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return np.where(empty, not is_max, raw != 0)
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        fill = info.min if is_max else info.max
        if dtype == np.uint8:
            vals = (raw & np.uint64(0xFF)).astype(np.uint8)
        elif dtype == np.int64:
            vals = (raw ^ np.uint64(1 << 63)).view(np.int64)
        else:
            vals = (raw.astype(np.uint32) ^ np.uint32(1 << 31)).view(np.int32).astype(dtype)
        return np.where(empty, np.array(fill, dtype), vals)
    if dtype == np.float32:
        k = raw.astype(np.uint32)
        bits = np.where(k & np.uint32(1 << 31), k ^ np.uint32(1 << 31), ~k).view(np.float32)
        quiet = np.array([0x7FC00000], np.uint32).view(np.float32)[0]
    else:
        bits = np.where(raw >> np.uint64(63), raw ^ np.uint64(1 << 63), ~raw).view(np.float64)
        quiet = np.array([0x7FF8000000000000], np.uint64).view(np.float64)[0]
    vals = np.where(nan, quiet, bits)
    return np.where(empty, np.array(-np.inf if is_max else np.inf, dtype), vals).astype(dtype)


class Op:
    """One table of a group: how it folds, its identity, the width of its
    codes (4 or 8 bytes; K5's float64 sums 8)."""

    def __init__(self, kind: str, width: int) -> None:
        self.kind, self.width = kind, width
        self.identity: Any = {"min": (_U32 if width == 4 else _ONES), "max": np.uint64(0),
                              "sum": 0.0}[kind]

    def __call__(self, a: Any, b: Any) -> Any:
        if self.kind == "min":
            return min(a, b)
        if self.kind == "max":
            return max(a, b)
        return a + b


class Group:
    """Tables folded together: each row's contribution to each (``vals``)
    and whether a row counts for them beyond its segment (``valid``)."""

    def __init__(self, ops: List[Op], vals: List[np.ndarray], valid: np.ndarray) -> None:
        self.ops, self.vals, self.valid = ops, vals, valid


def warp_combine(ps: List[int], accs: List[List[Any]], g: Group) -> List[Tuple[int, int]]:
    """The lanes that flush after the warp's combine, ``(lane, segment)``;
    their ``accs`` hold the combined values."""
    lanes = len(ps)
    if all(s == ps[0] for s in ps):
        d = lanes // 2
        while d:  # the butterfly: every lane ends with the whole warp's value
            accs[:] = [[op(a, b) for op, a, b in zip(g.ops, accs[i], accs[i ^ d])]
                       for i in range(lanes)]
            d //= 2
        return [(0, ps[0])] if ps[0] >= 0 else []
    peers = [sum(1 << j for j in range(lanes) if ps[j] == ps[i]) for i in range(lanes)]
    rel = [bin(peers[i] & ((1 << i) - 1)).count("1") for i in range(lanes)]
    above = [peers[i] & ~((2 << i) - 1) for i in range(lanes)]
    while any(above):  # reduce_peers: every round, each lane takes its next peer's value
        nxt = [(a & -a).bit_length() - 1 if a else -1 for a in above]
        taken = [list(accs[j]) if j >= 0 else None for j in nxt]
        for i in range(lanes):
            if taken[i] is not None:
                accs[i] = [op(a, b) for op, a, b in zip(g.ops, accs[i], taken[i])]
        done = sum(1 << i for i in range(lanes) if rel[i] & 1)
        above = [a & ~done for a in above]
        rel = [r >> 1 for r in rel]
    return [(i, ps[i]) for i in range(lanes)
            if ps[i] >= 0 and peers[i] & ((1 << i) - 1) == 0]


def k4_layout(widths: List[int], ngroups: int, num: int) -> Tuple[int, str]:
    """K4's replicas and route: its tables, each in whole lines, as many
    times as fit the budget, and a pending fold a group and thread."""
    nrep = replicas_for(sum(replica_stride(num * w, 1) for w in widths))
    tables = sum(nrep * replica_stride(num * w, nrep) for w in widths)
    return (nrep, "shared") if tables + ngroups * THREADS * 20 <= LIMIT else (1, "global")


def k5_layout(payloads: int, num: int) -> Tuple[int, str]:
    """K5's: the means once, the [payload][segment] sums as many times as
    fit the budget, and a pending fold a payload and thread."""
    tab = payloads * num * 8
    nrep = replicas_for(tab)
    tables = tab + nrep * replica_stride(tab, nrep)
    return (nrep, "shared") if tables + payloads * THREADS * 12 <= LIMIT else (1, "global")


def run_kernel(seg: np.ndarray, num: int, groups: List[Group], nrep: int,
               route: str) -> List[np.ndarray]:
    """One launch over the counted segments ``seg`` (-1: the row does not
    count) with ``nrep`` replicas on the ``route``: each table's global
    values."""
    n = len(seg)
    tables = [op for g in groups for op in g.ops]
    out = [np.array([op.identity] * num, dtype=object) for op in tables]
    tile = THREADS * RUN
    ntiles = math.ceil(n / tile)
    for b in range(min(ntiles, BLOCKS)):
        reps = [[np.array([op.identity] * num, dtype=object) for _ in range(nrep)]
                for op in tables]
        pend = [[(-1, [op.identity for op in g.ops]) for _ in range(THREADS)] for g in groups]

        def flush(lane: int, gi: int, s: int, acc: List[Any]) -> None:
            base = sum(len(g.ops) for g in groups[:gi])
            for k, (op, a) in enumerate(zip(groups[gi].ops, acc)):
                dst = out[base + k] if route == "global" else reps[base + k][lane % WARP % nrep]
                dst[s] = op(dst[s], a)

        for t in range(b, ntiles, BLOCKS):
            for tid in range(THREADS):
                r0 = t * tile + tid * RUN
                for gi, g in enumerate(groups):
                    ps, acc = pend[gi][tid]
                    for r in range(r0, min(r0 + RUN, n)):
                        if seg[r] < 0 or not g.valid[r]:
                            continue
                        if seg[r] != ps:
                            if ps >= 0:
                                flush(tid, gi, ps, acc)
                            ps, acc = int(seg[r]), [op.identity for op in g.ops]
                        acc = [op(a, v[r]) for op, a, v in zip(g.ops, acc, g.vals)]
                    pend[gi][tid] = (ps, acc)
        for w in range(0, THREADS, WARP):
            for gi, g in enumerate(groups):
                ps = [pend[gi][w + i][0] for i in range(WARP)]
                accs = [list(pend[gi][w + i][1]) for i in range(WARP)]
                for lane, s in warp_combine(ps, accs, g):
                    flush(w + lane, gi, s, accs[lane])
        if route == "shared":
            for k, op in enumerate(tables):
                for s in range(num):
                    v = op.identity
                    for r in range(nrep):
                        v = op(v, reps[k][r][s])
                    if v != op.identity:
                        out[k][s] = op(out[k][s], v)
    return out


def counted_segments(seg: torch.Tensor, num: int, nrows: Optional[int],
                     row_valid: Optional[torch.Tensor]) -> np.ndarray:
    """The rows [0, n) a launch reads (a prefix frame's first ``nrows``),
    each its segment where it counts, else -1."""
    s = seg.numpy().astype(np.int64)
    real = np.ones(len(s), bool) if row_valid is None else row_valid.numpy().astype(bool)
    if nrows is not None:
        s, real = s[:nrows], real[:nrows]
    return np.where(real & (s >= 0) & (s < num), s, -1)


def model_extrema(seg: torch.Tensor, num: int, payloads: List[Extremum], *,
                  nrows: Optional[int] = None, row_valid: Optional[torch.Tensor] = None,
                  first: bool = False, last: bool = False) -> Tuple[Extrema, List[str]]:
    """K4 in the model, with the wrapper's tables (a min and a max a
    payload, the first and last row), launches (at most 8 payloads each,
    the row tables with the first) and decoding; also each launch's
    route."""
    s = counted_segments(seg, num, nrows, row_valid)
    n = len(s)
    tables: Dict[Any, Any] = {}
    routes = []
    used = [j for j, p in enumerate(payloads) if p.min or p.max]
    rows = np.arange(n, dtype=np.uint64)
    for c in range(0, max(len(used), 1), 8):
        groups, keys = [], []
        for j in used[c:c + 8]:
            p = payloads[j]
            values = p.values.numpy()[:n]
            lo, hi = ordered_codes(values)
            width = 8 if values.dtype.itemsize == 8 else 4
            kinds = [(k, v) for want, k, v in ((p.min, "min", lo), (p.max, "max", hi)) if want]
            valid = np.ones(n, bool) if p.mask is None else p.mask.numpy()[:n]
            groups.append(Group([Op(k, width) for k, _ in kinds], [v for _, v in kinds], valid))
            keys += [(j, k == "max") for k, _ in kinds]
        if c == 0 and (first or last):
            kinds = [("min", rows, "first")] * first + [("max", rows + 1, "last")] * last
            groups.append(Group([Op(k, 4) for k, _, _ in kinds], [v for _, v, _ in kinds],
                                np.ones(n, bool)))
            keys += [name for _, _, name in kinds]
        if not groups or n == 0:
            continue
        nrep, route = k4_layout([op.width for g in groups for op in g.ops], len(groups), num)
        tables.update(zip(keys, run_kernel(s, num, groups, nrep, route)))
        routes.append(route)

    def codes(key: Any, ident: int) -> np.ndarray:
        return np.array([int(c) for c in tables.get(key, [ident] * num)], dtype=np.uint64)

    mins: List[Optional[torch.Tensor]] = []
    maxs: List[Optional[torch.Tensor]] = []
    for j, p in enumerate(payloads):
        wide = p.values.element_size() == 8
        for is_max, res in ((False, mins), (True, maxs)):
            if not (p.max if is_max else p.min):
                res.append(None)
                continue
            raw = codes((j, is_max), 0 if is_max else (2**64 - 1 if wide else 2**32 - 1))
            np_dtype = p.values.numpy().dtype
            res.append(torch.from_numpy(decode(raw, np_dtype, is_max, wide)))
    f = torch.from_numpy(codes("first", 2**32 - 1).astype(np.uint32).view(np.int32))
    lt = torch.from_numpy(codes("last", 0).astype(np.int64) - 1).to(torch.int32)
    return Extrema(mins, maxs, f if first else None, lt if last else None), routes


def model_sq_dev(seg: torch.Tensor, num: int, payloads: List[Tuple[torch.Tensor, Any]],
                 means: torch.Tensor, *, nrows: Optional[int] = None,
                 row_valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, List[str]]:
    """K5 in the model: each counted row adds (x - mean)^2 of its segment,
    in launches of at most 8 payloads; also each launch's route."""
    s = counted_segments(seg, num, nrows, row_valid)
    n = len(s)
    out = np.zeros((len(payloads), num))
    routes = []
    m = means.numpy()
    for lo in range(0, len(payloads) if n else 0, 8):
        groups = []
        for q, (v, mask) in enumerate(payloads[lo:lo + 8], start=lo):
            d = v.numpy()[:n].astype(np.float64) - m[q][np.clip(s, 0, num - 1)]
            valid = np.ones(n, bool) if mask is None else mask.numpy()[:n]
            groups.append(Group([Op("sum", 8)], [d * d], valid))
        nrep, route = k5_layout(len(groups), num)
        sums = run_kernel(s, num, groups, nrep, route)
        out[lo:lo + len(groups)] = np.array([t.astype(np.float64) for t in sums])
        routes.append(route)
    return torch.from_numpy(out), routes


def _bits(t: torch.Tensor) -> torch.Tensor:
    views = {torch.float32: torch.int32, torch.float64: torch.int64}
    return t.view(views[t.dtype]) if t.dtype in views else t


_SPECIAL = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf, -np.inf, 7.0])
_I64 = np.array([-(2**63), 2**63 - 1, -1, 0, 1], dtype=np.int64)


def cases(n: int, seed: int) -> List[Tuple[str, str, Dict[str, Any]]]:
    """``chip_smoke.reduce_cases``' kinds at ``n`` rows, from numpy."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy

    def flags(p: float) -> torch.Tensor:
        return t(rng.random(n) < p)

    def special(dtype: Any) -> torch.Tensor:
        return t(_SPECIAL.astype(dtype)[rng.integers(0, 8, n)])

    def every_dtype() -> List[Extremum]:
        return [
            Extremum(special(np.float32), flags(0.8), True, True),
            Extremum(special(np.float64), None, True, True),
            Extremum(t(_I64[rng.integers(0, 5, n)]), None, True, True),
            Extremum(t(rng.integers(-(2**40), 2**40, n)), flags(0.5), True, False),
            Extremum(t(rng.integers(-(2**31), 2**31, n).astype(np.int32)), None, False, True),
            Extremum(t(rng.integers(-(2**15), 2**15, n).astype(np.int16)), None, True, True),
            Extremum(t(rng.integers(-128, 128, n).astype(np.int8)), flags(0.7), True, True),
            Extremum(t(rng.integers(0, 256, n).astype(np.uint8)), None, True, True),
            Extremum(flags(0.5), flags(0.9), True, True),
        ]

    def finite() -> List[Tuple[torch.Tensor, Any]]:
        return [(t((rng.random(n) * 10).astype(np.float32)), None),
                (t(rng.standard_normal(n) * 1e3), flags(0.6))]

    def means(p: int, num: int) -> torch.Tensor:
        return t(rng.random((p, num)) * 2)

    row = np.arange(n)
    zipf_p = 1.0 / np.arange(1, 17) ** 1.1
    zipf = t(rng.choice(16, n, p=zipf_p / zipf_p.sum()).astype(np.int32))
    seg16 = t(rng.integers(-2, 18, n).astype(np.int32))  # sentinels and negative ids
    zeros = t(np.zeros(n, np.int32))
    sorted_short = t((row // 3).astype(np.int32))  # runs across a thread's run
    sorted_long = t((row // 37).astype(np.int32))  # across a warp's and a block's tile
    nan_or_masked = special(np.float32)
    nan_or_masked[::2] = float("nan")
    none_valid = t(np.zeros(n, bool))
    out: List[Tuple[str, str, Dict[str, Any]]] = [
        ("every dtype, 16 segments, prefix", "extrema", dict(
            seg=seg16, num=16, payloads=every_dtype(), nrows=n - n // 7, first=True,
            last=True)),
        ("every dtype, masked frame", "extrema", dict(
            seg=seg16, num=16, payloads=every_dtype(), row_valid=flags(0.6), last=True)),
        ("one segment, every dtype, masked frame", "extrema", dict(
            seg=zeros, num=1, payloads=every_dtype(), row_valid=flags(0.7), first=True,
            last=True)),
        ("one segment, NaN or masked", "extrema", dict(
            seg=zeros, num=1, nrows=n, first=True, last=True,
            payloads=[Extremum(nan_or_masked, t(np.arange(n) % 2 == 0), True, True),
                      Extremum(special(np.float64), none_valid, True, True)])),
        ("zipf(1.1), 16 segments", "extrema", dict(
            seg=zipf, num=16, payloads=every_dtype()[:4], nrows=n, first=True, last=True)),
        ("sorted runs of 3 rows", "extrema", dict(
            seg=sorted_short, num=int(row[-1] // 3) + 1, payloads=every_dtype()[:2],
            nrows=n, first=True, last=True)),
        ("sorted runs of 37 rows, short prefix", "extrema", dict(
            seg=sorted_long, num=int(row[-1] // 37) + 1, payloads=every_dtype()[2:5],
            nrows=n - n // 3, first=True, last=True)),
        ("many segments, global route", "extrema", dict(
            seg=t(rng.integers(0, 1000, n).astype(np.int32)), num=1000,
            payloads=every_dtype()[:2], nrows=n, first=True, last=True)),
        ("16 segments, prefix", "sq_dev", dict(
            seg=seg16, num=16, payloads=finite(), means=means(2, 16), nrows=n - n // 7)),
        ("one segment, masked frame", "sq_dev", dict(
            seg=zeros, num=1, payloads=finite(), means=means(2, 1), row_valid=flags(0.6))),
        ("one segment, every row masked", "sq_dev", dict(
            seg=zeros, num=1, payloads=[(finite()[0][0], none_valid)], means=means(1, 1),
            nrows=n)),
        ("zipf(1.1), 16 segments", "sq_dev", dict(
            seg=zipf, num=16, payloads=finite(), means=means(2, 16), nrows=n)),
        ("sorted runs of 37 rows", "sq_dev", dict(
            seg=sorted_long, num=int(row[-1] // 37) + 1, payloads=finite(),
            means=means(2, int(row[-1] // 37) + 1), nrows=n)),
        ("many segments, global route", "sq_dev", dict(
            seg=t(rng.integers(0, 1000, n).astype(np.int32)), num=1000, payloads=finite(),
            means=means(2, 1000), nrows=n)),
        ("more payloads than one launch takes", "sq_dev", dict(
            seg=seg16, num=16, payloads=finite() * 5, means=means(10, 16), nrows=n)),
    ]
    return out


_SIZES = (1, 5, 33, 611)


def _case_ids() -> List[str]:
    return [f"{kind}-{label}" for label, kind, _ in cases(8, 0)]


@pytest.mark.parametrize("n", _SIZES)
@pytest.mark.parametrize("index", range(len(cases(8, 0))), ids=_case_ids())
def test_model_matches_twins(index, n):
    """Each case: the model against the twin (K4 bit for bit, K5 within
    rtol 1e-10), on the route its label names."""
    label, kind, case = cases(n, 100 + n)[index]
    if kind == "extrema":
        got, routes = model_extrema(**case)
        want = segment_extrema_reference(**case)
        pairs = [("first", got.first, want.first), ("last", got.last, want.last)]
        for q in range(len(case["payloads"])):
            pairs += [(f"min {q}", got.mins[q], want.mins[q]),
                      (f"max {q}", got.maxs[q], want.maxs[q])]
        for name, g, w in pairs:
            assert (g is None) == (w is None), name
            if g is not None:
                assert g.dtype == w.dtype, name
                assert torch.equal(_bits(g), _bits(w)), f"{label} n={n}: {name}"
    else:
        got, routes = model_sq_dev(**case)
        want = segment_sq_dev_reference(**case)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=0,
                                   err_msg=f"{label} n={n}")
    if n > 1 and "sorted" not in label:
        assert set(routes) == {"global" if "global route" in label else "shared"}, routes


def test_both_routes_and_every_combine_are_modelled():
    """The cases reach both routes and replicas, and the warps' combine
    takes both its branches: every lane on one segment, and groups of
    matching lanes."""
    seen = set()
    for _, kind, case in cases(611, 711):
        fn: Callable[..., Any] = model_extrema if kind == "extrema" else model_sq_dev
        seen.update(fn(**case)[1])
    assert seen == {"shared", "global"}
    assert k5_layout(2, 16)[0] == MAX_REPLICAS and k4_layout([4] * 9, 5, 16)[0] == 2
    g = Group([Op("sum", 8)], [], np.ones(0, bool))
    uniform = [[1.0], [2.0], [3.0], [4.0]]
    assert warp_combine([5, 5, 5, 5], uniform, g) == [(0, 5)] and uniform[0] == [10.0]
    mixed = [[1.0], [2.0], [3.0], [4.0]]
    leaders = warp_combine([7, 2, 7, 7], mixed, g)
    assert leaders == [(0, 7), (1, 2)] and mixed[0] == [8.0] and mixed[1] == [2.0]


def test_replicas_and_their_banks():
    """Replicas fill the budget in powers of two up to 8, and each starts
    128 / replicas bytes into a line, a turn of the banks."""
    assert replicas_for(BUDGET) == 1 and replicas_for(BUDGET // 2) == 2
    assert replicas_for(1) == MAX_REPLICAS
    for nrep in (2, 4, 8):
        stride = replica_stride(4 * 1024, nrep)
        banks = {(r * stride // 4) % 32 for r in range(nrep)}
        assert len(banks) == nrep


def test_twin_extrema_of_float16_and_uint64_words():
    """K4's twin over a float16 payload (folded by its float value, decoded
    back to float16) and over a uint64 column's stored words (its values
    with the sign bit flipped): unflipped, the extrema are numpy's unsigned
    ones, values above 2^63 included."""
    import pyarrow as pa

    from fugue_tpu_torch.torch_backend.blocks import from_storage, to_storage

    rng = np.random.default_rng(9)
    n, num = 4000, 23
    seg = torch.from_numpy(rng.integers(0, num, n).astype(np.int32))
    h = (rng.standard_normal(n) * 100).astype(np.float16)
    u = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    mask = torch.from_numpy(rng.random(n) < 0.85)
    got = segment_extrema_reference(
        seg, num, [Extremum(torch.from_numpy(h), mask, True, True),
                   Extremum(torch.from_numpy(to_storage(u, pa.uint64())), None, True, True)],
        nrows=n)
    s, m = seg.numpy(), mask.numpy()
    for j in range(num):
        hj, uj = h[(s == j) & m], u[s == j]
        assert got.mins[0].dtype == torch.float16
        assert float(got.mins[0][j]) == float(hj.min()) and float(got.maxs[0][j]) == float(hj.max())
        lo, hi = (from_storage(t[j:j + 1].numpy(), pa.uint64())[0] for t in
                  (got.mins[1], got.maxs[1]))
        assert (lo, hi) == (uj.min(), uj.max())
