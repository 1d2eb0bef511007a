"""A plain numpy model of K14 ``null_count_keep`` as
``fugue_tpu_torch/kernels/row_select.cu`` computes it, at a small scale: a
persistent grid of ``BLOCKS`` blocks of ``THREADS`` threads; on the vector
route (every mask, ``row_valid`` and ``keep`` 16-byte aligned) each thread
takes ``GROUPS_PER`` groups of ``GROUP_ROWS`` consecutive rows at a time
(groups ``g0``, ``g0 + stride``, ...), loads each mask's 16 bytes of a
group once (and ``row_valid``'s in a masked frame), adds the masks in byte
lanes that wrap at 256 as the card's ``__vadd4`` does (past ``BYTE_LANES``
masks widened into ints), keeps a row where its lane is at least ``need``
(worked out once from the mode, ``thresh`` and the columns without masks),
ANDs the real rows (a prefix frame's ``nrows`` only in the group that
straddles it, no mask read past it), and counts the kept rows; the rows
past the last whole group, and every row on the scalar route, take a row a
thread. Mask pointers go by value up to ``PARAM_MASKS``, through a device
array above.

Held against ``null_count_keep_reference`` over ``n`` not a multiple of
16, ``nrows`` inside a group, a ``row_valid``, unaligned mask views, 0, 1,
4, 64, 65 and 300 masks, every mode and ``thresh`` at 0, at ``ncols -
nmasks`` and above ``ncols``; and ``chip_smoke.row_select_vs_twin``'s K14
cases rehearsed with the model as the kernel, each case's route checked."""

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pytest
import torch

import chip_smoke as cs
from fugue_tpu_torch.kernels import row_select
from fugue_tpu_torch.kernels.reference import DROPNA_HOWS, null_count_keep_reference

THREADS = 8  # a block's threads (256 on the card)
BLOCKS = 3
GROUP_ROWS = 16  # consecutive rows a group: one 16-byte load a mask (16)
GROUPS_PER = 2  # groups a thread has in flight (2)
BYTE_LANES = 255  # masks a byte lane counts before it is widened (255)
PARAM_MASKS = 64  # mask pointers passed by value (64)


def _need(nmasks: int, ncols: int, how: str, thresh: Optional[int]) -> int:
    """The least count of set masks that keeps a real row, clamped to [0,
    nmasks + 1]: 0 keeps every real row, nmasks + 1 none."""
    others = ncols - nmasks
    if thresh is not None:
        need = thresh - others
    elif how == "any":
        need = nmasks
    else:
        need = 1 - others
    return min(max(need, 0), nmasks + 1)


def _aligned(t: Optional[torch.Tensor]) -> bool:
    return t is None or t.data_ptr() % 16 == 0


def k14_model(masks: Sequence[torch.Tensor], ncols: int, n: int, *,
              nrows: Optional[int] = None, row_valid: Optional[torch.Tensor] = None,
              how: str = "any", thresh: Optional[int] = None,
              device: Optional[torch.device] = None,
              record: Optional[Dict[str, Any]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K14's ``(keep, count)``; ``record`` gets the route, where the mask
    pointers went, the 16-byte mask loads and the rows a thread took
    alone. ``k14_model.last_path`` is the route, as the wrapper's."""
    if how not in DROPNA_HOWS:
        raise ValueError(how)
    m = [t.numpy().view(np.uint8) for t in masks]
    nmasks = len(m)
    need = _need(nmasks, ncols, how, thresh)
    read = 1 <= need <= nmasks
    rv = None if row_valid is None else row_valid.numpy().view(np.uint8)
    vec = all(_aligned(t) for t in masks) and _aligned(row_valid)  # keep: a fresh allocation
    keep = np.zeros(n, dtype=np.uint8)
    count = 0
    loads = rows_alone = 0
    stride = BLOCKS * THREADS
    tail = 0
    if vec:
        groups = n // GROUP_ROWS
        tail = groups * GROUP_ROWS
        for tid in range(stride):
            for g0 in range(tid, groups, GROUPS_PER * stride):
                for k in range(GROUPS_PER):
                    g = g0 + k * stride
                    if g >= groups:
                        continue
                    r0 = g * GROUP_ROWS
                    rows = np.arange(r0, r0 + GROUP_ROWS)
                    if nrows is not None:
                        live = r0 < nrows
                        real = (rows < nrows).astype(np.uint8)
                    else:
                        live = True
                        real = (rv[rows] != 0).astype(np.uint8)
                    if not read:
                        flags = real if need <= 0 else np.zeros(GROUP_ROWS, dtype=np.uint8)
                    else:
                        wide = np.zeros(GROUP_ROWS, dtype=np.int64)
                        for j0 in range(0, nmasks, BYTE_LANES):
                            lanes = np.zeros(GROUP_ROWS, dtype=np.uint8)
                            for j in range(j0, min(j0 + BYTE_LANES, nmasks)):
                                if live:
                                    loads += 1
                                    lanes = (lanes + m[j][rows]).astype(np.uint8)  # wraps
                            wide += lanes
                        if nmasks <= BYTE_LANES:
                            assert (wide <= BYTE_LANES).all()
                        flags = (wide >= need).astype(np.uint8) & real
                    keep[rows] = flags
                    count += int(flags.sum())
    for r in range(tail, n):
        rows_alone += 1
        real = r < nrows if nrows is not None else rv[r] != 0
        kept = False
        if real:
            kept = sum(int(x[r]) for x in m) >= need if read else need <= 0
        keep[r] = kept
        count += int(kept)
    k14_model.last_path = "vector" if vec else "scalar"
    if record is not None:
        record.update(route=k14_model.last_path, loads=loads, rows_alone=rows_alone,
                      pointers="params" if nmasks <= PARAM_MASKS else "device array")
    return torch.from_numpy(keep.astype(bool)), torch.tensor(count, dtype=torch.int32)


k14_model.last_path = None  # type: ignore[attr-defined]


def _masks(n: int, k: int, seed: int, nulls: float = 0.1) -> List[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random(n) >= nulls * (1 + j % 3)) for j in range(k)]


def _view(t: torch.Tensor) -> torch.Tensor:
    """The same rows one byte off a 16-byte boundary."""
    (v, _), = cs.shifted([(t, None)])
    return v


def _check(label: str, **kw: Any) -> Dict[str, Any]:
    rec: Dict[str, Any] = {}
    got = k14_model(**kw, record=rec)
    want = null_count_keep_reference(**kw)
    assert torch.equal(got[0], want[0]), label
    assert int(got[1]) == int(want[1]), label
    return rec


SIZES = [1, 15, 16, 17, 3 * 16 * GROUPS_PER * THREADS * BLOCKS + 7]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("nmasks", [0, 1, 4, 64, 65, 300])
def test_model_matches_the_twin(n: int, nmasks: int) -> None:
    """Every mode, thresh at 0, at ``ncols - nmasks`` (every real row), in
    the masks' range and above ``ncols`` (none); a prefix frame whole,
    ending inside a group, and a masked frame."""
    masks = _masks(n, nmasks, n + nmasks)
    row_valid = torch.from_numpy(np.random.default_rng(n).random(n) < 0.8)
    ncols = nmasks + 2
    modes: List[Dict[str, Any]] = [dict(how="any"), dict(how="all")]
    modes += [dict(thresh=t) for t in sorted({0, ncols - nmasks, ncols - nmasks + 1,
                                              ncols - 1, ncols, ncols + 1})]
    rows: List[Dict[str, Any]] = [dict(nrows=n), dict(nrows=min(n, n // 2 + 5)),
                                  dict(row_valid=row_valid)]
    for mode in modes:
        for frame in rows:
            rec = _check(f"n={n} masks={nmasks} {mode} {list(frame)}", masks=masks, ncols=ncols,
                         n=n, **mode, **frame)
            assert rec["route"] == "vector"
            assert rec["rows_alone"] == n % GROUP_ROWS
            assert rec["pointers"] == ("params" if nmasks <= PARAM_MASKS else "device array")


@pytest.mark.parametrize("n", [17, 1000])
def test_unaligned_views_take_the_scalar_route(n: int) -> None:
    masks = _masks(n, 4, 5)
    row_valid = torch.from_numpy(np.random.default_rng(6).random(n) < 0.7)
    for label, ms, rv in (("a mask", masks[:3] + [_view(masks[3])], None),
                          ("row_valid", masks, _view(row_valid)),
                          ("every view", [_view(x) for x in masks], _view(row_valid))):
        frame = dict(nrows=n) if rv is None else dict(row_valid=rv)
        for mode in (dict(how="any"), dict(thresh=3)):
            rec = _check(f"{label} {mode}", masks=ms, ncols=5, n=n, **mode, **frame)
            assert rec["route"] == "scalar" and rec["rows_alone"] == n and rec["loads"] == 0


def test_no_mask_is_read_where_none_decides() -> None:
    """``need`` out of the masks' range (thresh at or below the columns
    without masks: every real row; above ``ncols``: none), and a prefix
    frame's groups past ``nrows``: no 16-byte load of a mask."""
    n = 40 * GROUP_ROWS
    masks = _masks(n, 4, 9)
    for thresh in (-1, 0, 2, 7):
        rec = _check(f"thresh {thresh}", masks=masks, ncols=6, n=n, nrows=n, thresh=thresh)
        assert rec["loads"] == 0
    rec = _check("all but a group past nrows", masks=masks, ncols=4, n=n, nrows=GROUP_ROWS + 3)
    assert rec["loads"] == 2 * 4  # the two groups below nrows, four masks each


@pytest.mark.parametrize("nmasks", [255, 256, 300])
def test_byte_lanes_at_their_top(nmasks: int) -> None:
    """Every mask set: a byte lane holds 255 ones exactly; past it the
    lanes are widened before they wrap."""
    n = 100
    masks = [torch.ones(n, dtype=torch.bool)] * nmasks
    for mode in (dict(how="any"), dict(thresh=nmasks), dict(thresh=nmasks + 1)):
        _check(f"{nmasks} masks {mode}", masks=masks, ncols=nmasks, n=n, nrows=n, **mode)
    masks = masks[:-1] + [torch.zeros(n, dtype=torch.bool)]
    _check(f"{nmasks} masks, one clear", masks=masks, ncols=nmasks, n=n, nrows=n)


def test_the_model_matches_the_kernel_constants() -> None:
    source = (Path(__file__).resolve().parents[1] / "fugue_tpu_torch" / "kernels"
              / "row_select.cu").read_text()
    for line in ("constexpr int kParamMasks = 64;", "constexpr int kGroupRows = 16;",
                 "constexpr int kGroupsPer = 2;", "constexpr int kByteLanes = 255;",
                 "constexpr int kThreads = 256;"):
        assert line in source
    assert row_select.PARAM_MASKS == PARAM_MASKS
    assert cs.DROPNA_COPY_COLUMNS == PARAM_MASKS


def test_the_wrapper_takes_cuda_tensors_only() -> None:
    with pytest.raises(ValueError, match="CUDA"):
        row_select.null_count_keep_cuda(_masks(10, 2, 1), 2, 10, nrows=10)


def test_chip_smoke_null_count_cases_with_the_model(monkeypatch: pytest.MonkeyPatch,
                                                    capsys: pytest.CaptureFixture) -> None:
    """``chip_smoke.row_select_vs_twin``'s K14 cases (routes checked) with
    the model as K14 and the other kernels' twins standing in."""
    from fugue_tpu_torch.kernels import factorize
    from fugue_tpu_torch.kernels.reference import (
        first_row_mask_reference,
        presort_word_reference,
        rank_keep_reference,
    )

    monkeypatch.setattr(row_select, "null_count_keep_cuda", k14_model)
    monkeypatch.setattr(row_select, "rank_keep_cuda", rank_keep_reference)
    monkeypatch.setattr(row_select, "first_row_mask_cuda", first_row_mask_reference)
    monkeypatch.setattr(factorize, "presort_word_cuda", presort_word_reference)
    monkeypatch.setattr(cs, "NULL_COUNT_EDGE_ROWS", 16 * 20 + 7)
    cs.row_select_vs_twin(torch.device("cpu"), (1, 301))
    out = capsys.readouterr().out
    assert "row_select_vs_twin: null_count_keep at n=327 equal" in out
    labels = [label for label, _ in cs.null_count_cases(torch.device("cpu"), 100, 1, True)]
    assert {label.rsplit(" ", 1)[1] for label in labels} == {"vector", "scalar"}
    assert any(label.startswith("300 masks") for label in labels)
