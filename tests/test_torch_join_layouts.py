"""The port's joins against ``JaxExecutionEngine.join`` pinned to one CPU
device (``tests/test_torch_join.py``'s comparison) over all-null keys,
empty sides and filtered (masked, lazily counted) inputs; the unique
right route against the expansion route."""

import numpy as np
import pandas as pd
import pytest

from test_torch_join import (
    HOWS,
    LAYOUT_CASES,
    _run,
    assert_tables_equal,
    check_join_matches_jax,
)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_join_matches_jax_over_layouts(case, how):
    check_join_matches_jax(case, how)


def test_unique_right_route_matches_expansion_route():
    """A monotone right key takes the unique right route, the same rows
    shuffled the expansion route; both equal the JAX engine's
    (``test_relational.py:231-249``)."""
    rng = np.random.default_rng(33)
    left = pd.DataFrame({"k": rng.integers(0, 50, 500).astype(np.int64), "v": rng.random(500)})
    right = pd.DataFrame({"k": np.arange(0, 80, 2, dtype=np.int64), "w": rng.random(40)})
    shuffled = right.sample(frac=1.0, random_state=5).reset_index(drop=True)
    for how in ("inner", "left_outer"):
        fast, jfast, te_fast = _run(how, left, right, ["k"])
        slow, jslow, te_slow = _run(how, left, shuffled, ["k"])
        assert te_fast.strategy_counts == {"join_unique": 1}
        assert te_slow.strategy_counts == {"join_expand": 1}
        assert not fast.blocks.nrows_known  # lazy: the left rows with a validity mask
        assert_tables_equal(fast.as_arrow(), jfast.as_arrow())
        assert_tables_equal(slow.as_arrow(), jslow.as_arrow())
        key = [("k", "ascending"), ("v", "ascending")]
        assert_tables_equal(fast.as_arrow().sort_by(key), slow.as_arrow().sort_by(key))
    # right outer takes the unique route when the LEFT key is unique
    _, _, te = _run("right_outer", right, left, ["k"])
    assert te.strategy_counts == {"join_unique": 1}


@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_unique_right_route_after_filters(how):
    """A filter keeps the columns, so a filtered dimension table still has
    its unique key and the join takes the unique right route, over a
    filtered (masked, lazily counted) left side too."""
    rng = np.random.default_rng(21)
    left = pd.DataFrame({"k": rng.integers(0, 40, 300).astype(np.int64), "v": rng.random(300)})
    dims = pd.DataFrame({"k": np.arange(0, 60, 2, dtype=np.int64), "w": rng.random(30)})
    tres, jres, te = _run(how, left, dims, ["k"], filtered=True)
    assert te.strategy_counts == {"join_unique": 1}
    assert not tres.blocks.nrows_known
    assert_tables_equal(tres.as_arrow(), jres.as_arrow())
