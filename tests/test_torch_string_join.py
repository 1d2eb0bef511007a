"""Joins on string keys: the port (``TorchExecutionEngine.join`` on the CPU,
its kernels as their twins) against ``JaxExecutionEngine.join`` pinned to
one CPU device, every join type, the two sides' key dictionaries in
different orders with keys that only one side holds, null keys, a
string key beside an int key, and string payload columns on both sides
(they ride through the gathers as codes and keep their dictionaries).

Compared as arrow tables row for row (decoded strings, nulls, values
exactly). One harmonize re-coding of the right side's key a join
(``harmonize_string_keys``), none where both sides share a dictionary."""

from typing import Any, List

import numpy as np
import pandas as pd
import pytest

import fugue_tpu_torch as ft
from fugue_tpu_torch.torch_backend import expr_eval, relational
from test_torch_join import _jax_df, _jax_engine
from test_torch_strings import compare_tables

HOWS = ["inner", "left_outer", "right_outer", "full_outer", "semi", "anti"]


def _sides(case: str) -> Any:
    """``(left, right, keys)``: 70 left rows over keys ``a``-``h``, 30
    right rows over ``f``-``m`` in another order (so the dictionaries
    differ and each side holds keys the other lacks), about 15 % null
    keys, a string payload on each side."""
    rng = np.random.default_rng(sum(map(ord, case)))
    lk = rng.choice(list("abcdefgh"), 70).astype(object)
    rk = rng.choice(list("mlkjihgf"), 30).astype(object)
    lk[rng.random(70) < 0.15] = None
    rk[rng.random(30) < 0.15] = None
    left = pd.DataFrame({"s": lk, "v": rng.integers(-50, 50, 70).astype(np.int64),
                         "lname": rng.choice(["x", "y", "z"], 70).astype(object)})
    right = pd.DataFrame({"s": rk, "w": np.round(rng.random(30), 3),
                          "rname": rng.choice(["p", "q"], 30).astype(object)})
    keys = ["s"]
    if case == "string_and_int":
        left["i"] = rng.integers(0, 2, 70).astype(np.int32)
        right["i"] = rng.integers(0, 2, 30).astype(np.int32)
        keys = ["s", "i"]
    elif case == "same_dictionary":
        right["s"] = left["s"].iloc[:30].to_numpy()
    return left, right, keys


def _counted_remaps(monkeypatch: Any) -> List[int]:
    calls: List[int] = []
    real = expr_eval.remap_codes

    def counting(codes: Any, table: Any) -> Any:
        calls.append(int(codes.shape[0]))
        return real(codes, table)

    monkeypatch.setattr(expr_eval, "remap_codes", counting)
    return calls


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("case", ["one_key", "string_and_int", "same_dictionary"])
def test_string_key_join_matches_jax(case, how, monkeypatch):
    left, right, keys = _sides(case)
    remaps = _counted_remaps(monkeypatch)
    te, je = ft.make_execution_engine(device="cpu"), _jax_engine()
    tres = te.join(te.to_df(left), te.to_df(right), how=how, on=keys)
    jres = je.join(_jax_df(je, left), _jax_df(je, right), how=how, on=keys)
    compare_tables(tres.as_arrow(), jres.as_arrow())
    assert te.fallbacks == {}
    # one re-coding of one side's key (the right's; right outer swaps
    # the sides), none where the two dictionaries are equal
    assert len(remaps) == (0 if case == "same_dictionary" else 1), remaps
    assert te.strategy_counts == {"join_mask" if how in ("semi", "anti") else "join_expand": 1}


def test_payload_strings_keep_their_dictionaries():
    left, right, keys = _sides("one_key")
    te = ft.make_execution_engine(device="cpu")
    tl, tr = te.to_df(left), te.to_df(right)
    res = te.join(tl, tr, how="inner", on=keys)
    assert res.blocks.columns["lname"].dictionary is tl.blocks.columns["lname"].dictionary
    assert res.blocks.columns["rname"].dictionary is tr.blocks.columns["rname"].dictionary
    pdf = res.as_pandas()
    want = left.dropna(subset=["s"]).merge(right.dropna(subset=["s"]), on="s")
    key = ["s", "v", "lname", "w", "rname"]
    assert pdf.sort_values(key).to_numpy().tolist() == want[key].sort_values(key).to_numpy() \
        .tolist()


def test_harmonize_keeps_side_one_and_extends_its_dictionary():
    te = ft.make_execution_engine(device="cpu")
    c1 = te.to_df(pd.DataFrame({"s": ["b", "a", "b", None]})).blocks.columns["s"]
    c2 = te.to_df(pd.DataFrame({"s": ["c", "a", None, "d", "c"]})).blocks.columns["s"]
    h1, h2 = relational.harmonize_string_keys(c1, c2)
    assert h1.data is c1.data and list(h1.dictionary) == ["b", "a", "c", "d"]
    assert h2.dictionary is h1.dictionary and h1.stats == h2.stats == (0, 3)
    decoded = [None if not m else h2.dictionary[c] for c, m in zip(h2.data.tolist(),
                                                                  h2.mask.tolist())]
    assert decoded == ["c", "a", None, "d", "c"]
    assert relational.harmonize_string_keys(c1, c1) == (c1, c1)


def test_union_of_full_outer_tails_shares_the_key_dictionary():
    """Full outer: the matched rows' keys and the right rows with no match
    decode through one dictionary, with no second re-coding."""
    left = pd.DataFrame({"s": ["a", "b", None], "v": [1, 2, 3]})
    right = pd.DataFrame({"s": ["z", "b", "y"], "w": [0.5, 1.5, 2.5]})
    te = ft.make_execution_engine(device="cpu")
    res = te.join(left, right, how="full_outer", on=["s"])
    assert sorted(res.as_pandas()["s"].fillna("-")) == ["-", "a", "b", "y", "z"]
