"""K17 ``comap_presence`` and K18 ``comap_rows``'s twins
(``kernels/reference.py``) against a numpy oracle written from the JAX
package's co-map program (``comap_compiled.py:335-362``: per member
``segment_sum(valid) > 0``, ``_alive_rule``, ``valid & alive[seg]``, the
sentinel, the counts): a ``hypothesis`` property over the member count
(two presence words past 32), the zip type, prefix and masked layouts,
members with no real row and sentinel ids. The kernels themselves run
only on the card (``chip_smoke.comap_vs_twin``); the last test rehearses
that phase here with the twins standing in for the kernels."""

from typing import Any, List, Tuple

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fugue_tpu_torch.kernels.reference import (
    COMAP_HOWS,
    comap_presence_reference,
    comap_rows_reference,
    presence_words,
)


def oracle(seg: np.ndarray, num: int, sizes: List[int], nrows: List[int],
           valid: Any, how: str) -> Tuple[np.ndarray, ...]:
    members = len(sizes)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    real = np.zeros(len(seg), dtype=bool)
    member = np.zeros(len(seg), dtype=np.int64)
    for m in range(members):
        rows = np.arange(offs[m], offs[m + 1])
        member[rows] = m
        real[rows] = (rows - offs[m]) < nrows[m]
    if valid is not None:
        real &= valid
    ok = real & (seg >= 0) & (seg < num)
    present = np.zeros((members, num), dtype=bool)
    for r in np.flatnonzero(ok):
        present[member[r], seg[r]] = True
    words = np.zeros((num, presence_words(members)), dtype=np.uint32)
    for m in range(members):
        words[:, m // 32] |= present[m].astype(np.uint32) << np.uint32(m % 32)
    if how == "cross":
        alive = np.ones(num, dtype=bool)
    elif how == "inner":
        alive = present.all(axis=0)
    elif how == "left_outer":
        alive = present[0]
    elif how == "right_outer":
        alive = present[-1]
    else:
        alive = present.any(axis=0)
    row_alive = ok & alive[np.clip(seg, 0, num - 1)]
    seg_out = np.where(row_alive, seg, num)
    counts = np.bincount(member[row_alive], minlength=members)
    return words.view(np.int32).reshape(-1), row_alive, seg_out, alive, counts


@st.composite
def cases(draw: Any) -> Tuple[Any, ...]:
    members = draw(st.sampled_from([1, 2, 3, 5, 32, 33, 40]))
    sizes = draw(st.lists(st.integers(1, 12), min_size=members, max_size=members))
    num = draw(st.integers(1, 20))
    seed = draw(st.integers(0, 2**31))
    masked = draw(st.booleans())
    how = draw(st.sampled_from(COMAP_HOWS))
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    seg = rng.integers(0, num + 1, n).astype(np.int32)  # num: the sentinel
    if how == "cross":
        num = 1
        seg = np.zeros(n, dtype=np.int32)
    nrows = [int(rng.integers(0, s + 1)) for s in sizes]
    valid = None
    if masked:
        nrows = list(sizes)
        valid = rng.random(n) < 0.7
    return seg, num, sizes, nrows, valid, how


def run_twins(seg: np.ndarray, num: int, sizes: List[int], nrows: List[int], valid: Any,
              how: str) -> Tuple[Any, ...]:
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int64)
    nr = torch.tensor(nrows, dtype=torch.int64)
    v = None if valid is None else torch.from_numpy(valid)
    s = torch.from_numpy(seg)
    presence = None
    if how != "cross":
        presence = comap_presence_reference(s, num, offsets, nr, valid=v)
    return presence, comap_rows_reference(s, presence, num, offsets, nr, how, valid=v)


@settings(max_examples=120, deadline=None)
@given(cases())
def test_twins_match_the_numpy_oracle(case: Tuple[Any, ...]) -> None:
    seg, num, sizes, nrows, valid, how = case
    words, row_alive, seg_out, alive, counts = oracle(seg, num, sizes, nrows, valid, how)
    presence, rows = run_twins(seg, num, sizes, nrows, valid, how)
    if presence is not None:
        assert np.array_equal(presence.numpy(), words)
    assert np.array_equal(rows.row_alive.numpy(), row_alive)
    assert np.array_equal(rows.seg_out.numpy(), seg_out)
    assert np.array_equal(rows.alive.numpy(), alive)
    assert np.array_equal(rows.counts.numpy(), counts)
    assert int(rows.alive_count) == int(alive.sum())


def test_a_member_without_rows_kills_every_inner_segment() -> None:
    seg = np.array([0, 1, 0, 1], dtype=np.int32)
    presence, rows = run_twins(seg, 2, [2, 2], [2, 0], None, "inner")
    assert not rows.alive.any() and int(rows.alive_count) == 0
    assert rows.seg_out.tolist() == [2, 2, 2, 2]
    _, rows = run_twins(seg, 2, [2, 2], [2, 0], None, "left_outer")
    assert rows.alive.tolist() == [True, True] and rows.counts.tolist() == [2, 0]


def test_chip_smoke_comap_phase_on_cpu(monkeypatch: pytest.MonkeyPatch) -> None:
    """``chip_smoke.comap_vs_twin`` at small sizes, each twin standing in
    for its kernel (with a launch count)."""
    import chip_smoke
    from fugue_tpu_torch.kernels import comap

    def counted(fn: Any) -> Any:
        def run(*args: Any, **kw: Any) -> Any:
            run.launches += 1  # type: ignore[attr-defined]
            return fn(*args, **kw)
        run.launches = 0  # type: ignore[attr-defined]
        return run

    monkeypatch.setattr(comap, "comap_presence_cuda", counted(comap_presence_reference))
    monkeypatch.setattr(comap, "comap_rows_cuda", counted(comap_rows_reference))
    chip_smoke.comap_vs_twin(torch.device("cpu"), (1, 3001), big_segments=1 << 12)
