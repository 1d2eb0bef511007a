"""A plain numpy model of K8 ``join_probe`` as
``fugue_tpu_torch/kernels/join.cu`` computes it, step by step, at a small
scale: the narrowing launch (one bit a segment, ``count > 0``, for semi,
anti and NOT IN, a warp's 32 entries a word; one byte for expand,
``min(count, 255)``, 255 an escape to the int32 entry; unique mode keeps
K7's int32 slots), the choice of where the probe reads its table
(``join.probe_place``: bits from L2, byte entries from a shared copy or
L2, slots from a shared copy or K7's table, here also at a scaled-down
limit), and the probe: blocks of ``THREADS`` threads, each taking
``GROUPS`` groups of 4 consecutive rows a step (a warp's groups side by
side), the tiles taken in a random order by a persistent grid of
``BLOCKS`` blocks, each thread's total in a register and each block's
added once.

Held bit for bit against ``join_probe_reference`` in every mode over
``chip_smoke.join_side_cases``' kinds (prefix, short-prefix and masked
layouts with null keys, the sentinel segment, one key holding most build
rows, counts of 254, 255 and 256, one segment holding every build row) at
small n, with and without the shared copy."""

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pytest
import torch

import chip_smoke as cs
from fugue_tpu_torch.kernels import join
from fugue_tpu_torch.kernels.reference import (
    PROBE_MODES,
    Probe,
    join_build_reference,
    join_probe_reference,
)

THREADS = 8  # a block's threads (1024 on the card)
WARP = 4  # (32)
GROUPS = 2  # groups of 4 rows a thread a step (4)
BLOCKS = 3  # the persistent grid
ESCAPE = 255
WARP_ROWS = WARP * GROUPS * 4
TILE = THREADS * GROUPS * 4


def narrow_bits(table: np.ndarray) -> np.ndarray:
    """The narrowing launch of semi, anti and NOT IN: word w holds bit
    ``i % 32`` of each entry ``i`` of ``[32 w, 32 w + 32)`` above 0 (a
    warp's ballot)."""
    num = len(table)
    words = np.zeros(-(-num // 32), dtype=np.uint32)
    for w in range(len(words)):
        for lane in range(32):
            i = 32 * w + lane
            if i < num and table[i] > 0:
                words[w] |= np.uint32(1 << lane)
    return words


def narrow_bytes(table: np.ndarray) -> np.ndarray:
    """The narrowing launch of expand: ``min(count, 255)`` a segment."""
    return np.clip(table, 0, ESCAPE).astype(np.uint8)


def entry(mode: str, place: str, table: np.ndarray, narrow: Optional[np.ndarray], s: int) -> int:
    """``probe_entry``: segment s's hit (0/1), count or slot, from where
    the place keeps it (a shared copy holds what the narrow table or K7's
    slots hold)."""
    if mode == "unique":
        assert place in ("shared", "wide")
        return int(table[s])
    assert narrow is not None and place in (("shared", "l2") if mode == "expand" else ("l2",))
    if mode == "expand":
        b = int(narrow[s])
        return int(table[s]) if b == ESCAPE else b
    return int((int(narrow[s >> 5]) >> (s & 31)) & 1)


def group_rows(t0: int, thread: int, g: int) -> List[int]:
    """The 4 consecutive rows of group g of a thread in the tile at t0."""
    warp, lane = divmod(thread, WARP)
    base = t0 + warp * WARP_ROWS + g * WARP * 4 + lane * 4
    return [base + k for k in range(4)]


def probe_model(seg: torch.Tensor, table: torch.Tensor, mode: str, *,
                nrows: Optional[int] = None, row_valid: Optional[torch.Tensor] = None,
                nulls: Optional[torch.Tensor] = None, outer: bool = False,
                stats: Optional[torch.Tensor] = None, seed: int = 0,
                record: Optional[Dict[str, Any]] = None) -> Probe:
    """K8's outputs, step by step; ``record`` gets the place and the
    narrow table."""
    rng = np.random.default_rng(seed)
    seg_np = seg.numpy().astype(np.int64)
    tab = table.numpy().astype(np.int64)
    n, num = len(seg_np), len(tab)
    place = join.probe_place(mode, num)
    narrow = None
    if mode != "unique":
        narrow = narrow_bytes(tab) if mode == "expand" else narrow_bits(tab)
        assert narrow.nbytes == join.probe_table_bytes(mode, num)
    if record is not None:
        record.update(place=place, narrow=narrow)
    rv = None if row_valid is None else row_valid.numpy()
    nl = None if nulls is None else nulls.numpy()
    keep = np.zeros(n, dtype=bool)
    ridx = np.zeros(n, dtype=np.int32)
    m = np.zeros(n, dtype=np.int32)
    reps = np.zeros(n, dtype=np.int32)
    total = 0
    empty2 = stats is not None and int(stats[0]) == 0
    any_null2 = stats is not None and int(stats[1]) > 0
    tiles = list(range(0, n, TILE))
    # a persistent grid: block b takes tiles b, b + BLOCKS, ...; the blocks
    # run in any order, each adding its total once
    blocks = [tiles[b::BLOCKS] for b in range(BLOCKS)]
    rng.shuffle(blocks)
    for mine in blocks:
        block_total = 0
        for t0 in mine:
            for thread in range(THREADS):
                for g in range(GROUPS):
                    for r in group_rows(t0, thread, g):
                        if r >= n:
                            continue
                        real = r < nrows if nrows is not None else bool(rv[r])
                        null = nl is not None and bool(nl[r])
                        s = int(seg_np[r])
                        ok = real and not null and 0 <= s < num
                        e = entry(mode, place, tab, narrow, s) if ok else (
                            -1 if mode == "unique" else 0)
                        if mode == "expand":
                            m[r] = e
                            reps[r] = (1 if outer and e < 1 else e) if real else 0
                            block_total += int(reps[r])
                            continue
                        if mode == "unique":
                            ridx[r] = e
                            k = real if outer else e >= 0
                        elif mode == "not_in":
                            k = real and (empty2 or (not null and not any_null2 and e == 0))
                        elif mode == "semi":
                            k = e != 0
                        else:
                            k = real and e == 0
                        keep[r] = k
                        block_total += int(k)
        total += block_total
    if mode == "expand":
        return Probe(None, None, torch.from_numpy(m), torch.from_numpy(reps),
                     torch.tensor(total, dtype=torch.int64))
    return Probe(torch.from_numpy(keep), torch.from_numpy(ridx) if mode == "unique" else None,
                 None, None, torch.tensor(total, dtype=torch.int32))


def _same(got: Probe, want: Probe, label: str) -> None:
    for field, g, w in zip(want._fields, got, want):
        assert (g is None) == (w is None), f"{label} {field}"
        if w is not None:
            assert g.dtype == w.dtype and torch.equal(g, w), f"{label} {field}"


# ``join.PROBE_SHARED_BYTES``, moved so that every table here is copied to
# shared memory, or none
SHARED_LIMITS = {"copy": 1 << 30, "none": -1}


def place_of(mode: str, shared_limit: int) -> str:
    """Where K8 reads the table of ``mode`` at this limit: the copy where
    it is not of bits, else L2 (bits, bytes) or K7's table (slots)."""
    if mode in ("expand", "unique") and shared_limit > 0:
        return "shared"
    return "wide" if mode == "unique" else "l2"


def _check(case: Dict[str, Any], label: str, seed: int,
           monkeypatch: pytest.MonkeyPatch) -> None:
    rows = {k: case[k] for k in ("nrows", "row_valid", "nulls") if k in case}
    device = case["build"].device
    for limit in SHARED_LIMITS.values():
        monkeypatch.setattr(join, "PROBE_SHARED_BYTES", limit)
        for slots in (False, True):
            table = join_build_reference(case["build"], case["num"], slots=slots, **rows)
            for mode in PROBE_MODES:
                if (mode == "unique") != slots or mode == "not_in":
                    continue
                for outer in (False, True) if mode in ("unique", "expand") else (False,):
                    rec: Dict[str, Any] = {}
                    got = probe_model(case["probe"], table, mode, outer=outer, seed=seed,
                                      record=rec, **rows)
                    place = rec["place"]
                    assert place == place_of(mode, limit)
                    want = join_probe_reference(case["probe"], table, mode, outer=outer, **rows)
                    _same(got, want, f"{label} {mode} outer={outer} {place}")
        table, stats = join_build_reference(case["build"], case["num"], side_counts=True, **rows)
        for st in (stats, torch.zeros((2,), dtype=torch.int32, device=device),
                   torch.tensor([5, 1], dtype=torch.int32, device=device)):
            got = probe_model(case["probe"], table, "not_in", stats=st, seed=seed, **rows)
            want = join_probe_reference(case["probe"], table, "not_in", stats=st, **rows)
            _same(got, want, f"{label} not_in limit={limit}")


def _cases(n: int, seed: int) -> List[Tuple[str, Dict[str, Any]]]:
    """``chip_smoke.join_side_cases`` at n rows, their segment counts cut
    down (one word of bits, its edges, several words)."""
    nums = (1, 31, 33, 100)
    orig = cs.JOIN_SIDE_SEGMENTS, cs.JOIN_SKEW
    cs.JOIN_SIDE_SEGMENTS, cs.JOIN_SKEW = nums, max(n // 3, 1)
    try:
        return cs.join_side_cases(torch.device("cpu"), n, seed)
    finally:
        cs.JOIN_SIDE_SEGMENTS, cs.JOIN_SKEW = orig


@pytest.mark.parametrize("n", [1, 5, TILE + 3, 3 * TILE * BLOCKS + 7, 800])
def test_probe_model_matches_the_twin(n: int, monkeypatch: pytest.MonkeyPatch) -> None:
    cases = _cases(n, 200 + n)
    if n >= 3 * 256:
        assert any(label == "counts 254, 255, 256" for label, _ in cases)
    for i, (label, case) in enumerate(cases):
        _check(case, f"{label} n={n}", seed=i, monkeypatch=monkeypatch)


def test_byte_entries_escape_at_255() -> None:
    """Counts of 254 stay in their byte; 255 and above read the int32
    entry through the escape; a segment holding every build row too."""
    table = np.array([0, 1, 254, 255, 256, 70_000, 2**31 - 1], dtype=np.int64)
    narrow = narrow_bytes(table)
    assert narrow.tolist() == [0, 1, 254, 255, 255, 255, 255]
    got = [entry("expand", "l2", table, narrow, s) for s in range(len(table))]
    assert got == table.tolist()
    bits = narrow_bits(np.array([0, 3, 0, 1] + [0] * 28 + [9], dtype=np.int64))
    assert bits.tolist() == [0b1010, 1]


def test_places_by_table_size(monkeypatch: pytest.MonkeyPatch) -> None:
    """The narrow table's bytes by mode and the place each takes, at the
    card's limit and at a scaled-down one."""
    assert join.probe_table_bytes("semi", 1) == 4
    assert join.probe_table_bytes("not_in", 33) == 8
    assert join.probe_table_bytes("expand", 1000) == 1000
    assert join.probe_table_bytes("unique", 1000) == 4000
    assert [join.probe_entry(m) for m in PROBE_MODES] == ["bit", "bit", "int32", "byte", "bit"]
    # the card's: bits from L2 at every size (1024 segments, Q16's 1M, 2^31
    # - 1), 200,000 byte entries in shared memory, config 10's 25M and
    # more from L2, 256 slots in shared memory, 25M read wide
    for num in (1, 1024, 1_000_000, 25_000_000, 2**31 - 1):
        assert {join.probe_place(m, num) for m in ("semi", "anti", "not_in")} == {"l2"}
    assert join.probe_place("expand", 200_000) == "shared"
    assert join.probe_place("expand", 204_801) == "l2"
    assert join.probe_place("expand", 25_000_000) == "l2"
    assert join.probe_place("expand", 2**31 - 1) == "l2"
    assert join.probe_place("unique", 256) == "shared"
    assert join.probe_place("unique", 51_200) == "shared"
    assert join.probe_place("unique", 51_201) == "wide"
    assert join.probe_place("unique", 25_000_000) == "wide"
    monkeypatch.setattr(join, "PROBE_SHARED_BYTES", 16)
    assert [join.probe_place("semi", num) for num in (1, 128, 129)] == ["l2"] * 3
    assert [join.probe_place("expand", num) for num in (16, 17)] == ["shared", "l2"]
    assert [join.probe_place("unique", num) for num in (4, 5)] == ["shared", "wide"]


def test_the_model_matches_the_kernel_constants() -> None:
    source = (Path(__file__).resolve().parents[1] / "fugue_tpu_torch" / "kernels"
              / "join.cu").read_text()
    assert f"constexpr unsigned kEscape = {ESCAPE};" in source
    assert "constexpr int kPlaceShared = 0, kPlaceL2 = 1, kPlaceWide = 2;" in source
    assert f"constexpr int kProbeSharedBytes = {join.PROBE_SHARED_BYTES // 1024} * 1024;" in source
    assert join.PROBE_PLACES == ("shared", "l2", "wide")


def test_chip_smoke_join_vs_twin_with_the_model(monkeypatch: pytest.MonkeyPatch,
                                                capsys: pytest.CaptureFixture) -> None:
    """``chip_smoke.join_vs_twin``'s K8 part with the model as K8 (its
    place recorded as the wrapper's ``last_path``), the twins as the other
    kernels: every mode reaches each place of its table."""
    from fugue_tpu_torch.kernels import gather, reference

    def probe(*a: Any, **kw: Any) -> Probe:
        rec: Dict[str, Any] = {}
        out = probe_model(*a, record=rec, **kw)
        probe.last_path = rec["place"]  # type: ignore[attr-defined]
        return out

    def build(seg: Any, num: int, **kw: Any) -> Any:
        build.last_path = "shared"  # type: ignore[attr-defined]
        return reference.join_build_reference(seg, num, **kw)

    def gather_twin(columns: Any, idx: Any, *, outer: bool = False,
                    scattered: bool = False) -> Any:
        gather_twin.last_route = "direct"  # type: ignore[attr-defined]
        return reference.gather_rows_reference(columns, idx, outer=outer)

    monkeypatch.setattr(join, "join_probe_cuda", probe)
    monkeypatch.setattr(join, "join_build_cuda", build)
    monkeypatch.setattr(join, "join_expand_cuda",
                        lambda *a, **kw: reference.join_expand_reference(*a, **kw))
    monkeypatch.setattr(gather, "gather_rows_cuda", gather_twin)
    # 16 segments of bytes, 4 slots
    monkeypatch.setattr(join, "PROBE_SHARED_BYTES", 16)
    monkeypatch.setattr(cs, "JOIN_SIDE_SEGMENTS", (1, 33, 200))
    monkeypatch.setattr(cs, "JOIN_SKEW", 40)
    monkeypatch.setattr(cs, "JOIN_CROSS_ROWS", (30, 7))
    cs.join_vs_twin(torch.device("cpu"), (1, 130))
    out = capsys.readouterr().out
    # bits at L2 (3 modes), bytes shared and L2, slots shared and wide
    assert f"join_probe: every mode at each place of its table ({3 + 2 + 2} pairs)" in out
