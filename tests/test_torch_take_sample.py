"""The port's ``take``, ``sample`` and ``repartition``
(``TorchExecutionEngine`` on the CPU, where K7, K10, K11 and K12 run as
their twins) against ``JaxExecutionEngine`` pinned to one CPU device, on
the same seeded frames built on that engine's mesh.

``take`` global and partitioned, ascending and descending, nulls first
and last, by string, bool, uint8, nullable int64 and float keys (ties,
-0.0 and NaN), with no presort, ``n = 0`` and ``n`` above a partition's
size, over prefix and filtered frames: row for row and exactly
(``test_torch_set_ops.assert_same_rows``). ``sample`` with replacement
copies the JAX package's host draw, so it is held row for row too.
Without replacement the two engines' generators differ, so ``sample`` is
held to the JAX package's exact count, to kept rows that are real and
distinct, and to the same rows for the same seed. ``repartition`` by
hash and at random: row for row."""

from typing import Any

import numpy as np
import pandas as pd
import pytest

import fugue_tpu_torch as ft
from fugue_tpu.collections.partition import PartitionSpec as JSpec
from fugue_tpu.column import col as jcol
from fugue_tpu_torch.collections.partition import PartitionSpec
from test_torch_join import _jax_df, _jax_engine
from test_torch_set_ops import NAMES, assert_same_rows


def take_frame(seed: int = 5, n: int = 90) -> pd.DataFrame:
    """``id`` the row number; ``k`` int32 over 4 partitions; ``v``
    float64 with ties, -0.0, 0.0 and NaN; ``s`` a string with nulls; ``b``
    bool; ``u`` uint8; ``t`` a nullable int64 with a wide range; ``g``
    float32."""
    rng = np.random.default_rng(seed)
    s = NAMES[rng.integers(0, 5, n)].copy()
    s[rng.random(n) < 0.2] = None
    t = pd.array(rng.choice([-(2**62), -5, 0, 3, 2**62], n), dtype="Int64")
    t[rng.random(n) < 0.2] = pd.NA
    return pd.DataFrame({
        "id": np.arange(n, dtype=np.int64),
        "k": rng.integers(0, 4, n).astype(np.int32),
        "v": rng.choice([-1.0, -0.0, 0.0, 0.5, 2.0, np.nan], n),
        "s": s,
        "b": rng.random(n) < 0.4,
        "u": rng.choice([0, 3, 200, 255], n).astype(np.uint8),
        "t": t,
        "g": rng.standard_normal(n).astype(np.float32),
    })


def _engines(pdf: pd.DataFrame, filtered: bool = False) -> Any:
    te, je = ft.make_execution_engine(device="cpu"), _jax_engine()
    tdf, jdf = te.to_df(pdf), _jax_df(je, pdf)
    if filtered:
        tdf = te.filter(tdf, (ft.col("id") != 2) & ((ft.col("id") < 10) | (ft.col("id") > 25)))
        jdf = je.filter(jdf, (jcol("id") != 2) & ((jcol("id") < 10) | (jcol("id") > 25)))
    return te, je, tdf, jdf


TAKES = [
    ("v", "last", None, 7),
    ("v desc", "first", None, 7),
    ("v desc, id", "last", ["k"], 2),
    ("s", "last", None, 5),
    ("s desc", "first", ["k"], 3),
    ("b desc, g", "last", None, 4),
    ("u desc", "last", None, 3),
    ("t desc, v", "first", ["k"], 2),
    ("t, s desc, v", "last", ["b"], 3),
    ("k, v desc", "first", None, 12),
    ("", "last", None, 6),
    ("", "last", ["k"], 1),
    ("v", "last", ["k"], 0),
    ("g desc", "last", ["k"], 100),
    ("t", "first", ["s"], 2),
]


@pytest.mark.parametrize("filtered", [False, True], ids=["prefix", "filtered"])
@pytest.mark.parametrize("presort,na_position,by,n", TAKES,
                         ids=[f"{p or 'none'}-{na}-{by}-{n}" for p, na, by, n in TAKES])
def test_take_matches_jax(presort, na_position, by, n, filtered):
    te, je, tdf, jdf = _engines(take_frame(), filtered)
    got = te.take(tdf, n, presort, na_position,
                  None if by is None else PartitionSpec(by=by))
    assert not got.blocks.nrows_known
    want = je.take(jdf, n, presort, na_position, None if by is None else JSpec(by=by))
    assert_same_rows(got, want)
    assert te.fallbacks == {}


def test_take_presort_from_the_partition_spec_and_entry_point():
    """An empty ``presort`` takes the spec's; ``ft.take`` runs it and
    returns pandas."""
    te, je, tdf, jdf = _engines(take_frame(7, 50))
    got = te.take(tdf, 2, "", partition_spec=PartitionSpec(by=["k"], presort="g desc"))
    want = je.take(jdf, 2, "", partition_spec=JSpec(by=["k"], presort="g desc"))
    assert_same_rows(got, want)
    pdf = ft.take(take_frame(7, 50), 2, presort="g desc", partition={"by": ["k"]}, engine=te)
    exp = take_frame(7, 50).sort_values("g", ascending=False, kind="stable").groupby("k").head(2)
    assert sorted(pdf["id"]) == sorted(exp["id"])


def test_take_desc_unsigned_no_negation_wraparound():
    """``test_fillna_take_sample.py``'s wraparound case on a uint8 column
    (the port holds no uint32 yet): descending takes the largest."""
    te, je, tdf, jdf = _engines(pd.DataFrame({"c": np.array([0, 5, 255, 3], dtype=np.uint8)}))
    got = te.take(tdf, 1, "c desc")
    assert_same_rows(got, je.take(jdf, 1, "c desc"))
    assert got.as_pandas()["c"].tolist() == [255]


def test_take_arguments_raise_as_the_jax_package():
    te, je, tdf, jdf = _engines(take_frame(1, 10))
    for args in ((-1, "v"), (1.5, "v")):
        with pytest.raises(ValueError, match="non-negative"):
            te.take(tdf, *args)
        with pytest.raises(ValueError, match="non-negative"):
            je.take(jdf, *args)
    with pytest.raises(ValueError, match="na_position"):
        te.take(tdf, 1, "v", na_position="middle")


def test_sample_without_replacement_holds_the_counts_and_rows():
    """Exact counts as the JAX package's (``n``; ``frac`` rounded half to
    even), every kept row real and distinct, the same rows for the same
    seed, other rows for another seed, on a prefix and a filtered frame."""
    pdf = pd.DataFrame({"id": np.arange(1000, dtype=np.int64)})
    for filtered in (False, True):
        te, je, tdf, jdf = _engines(pdf, filtered)
        real = set(tdf.as_pandas()["id"])
        for kw in (dict(n=100), dict(frac=0.25), dict(frac=0.0005), dict(n=5000),
                   dict(frac=1.0), dict(n=0)):
            got = te.sample(tdf, seed=7, **kw)
            assert not got.blocks.nrows_known
            ids = got.as_pandas()["id"].tolist()
            assert len(ids) == je.sample(jdf, seed=7, **kw).count(), kw
            assert len(set(ids)) == len(ids) and set(ids) <= real
            assert ids == sorted(ids)  # rows stay in their place
            assert te.sample(tdf, seed=7, **kw).as_pandas()["id"].tolist() == ids
        one, two = (te.sample(tdf, n=50, seed=s).as_pandas()["id"].tolist() for s in (1, 2))
        assert one != two
        unseeded = te.sample(tdf, n=50)
        assert unseeded.count() == 50
        assert te.fallbacks == {}


def test_sample_frac_rounds_half_to_even():
    te = ft.make_execution_engine(device="cpu")
    pdf = pd.DataFrame({"id": np.arange(10, dtype=np.int64)})
    assert te.sample(pdf, frac=0.25, seed=0).count() == 2  # 2.5 -> 2
    assert te.sample(pdf, frac=0.35, seed=0).count() == 4  # 3.5 -> 4


@pytest.mark.parametrize("filtered", [False, True], ids=["prefix", "filtered"])
def test_sample_with_replacement_matches_jax_row_for_row(filtered):
    te, je, tdf, jdf = _engines(take_frame(3, 60), filtered)
    for kw in (dict(n=80, seed=2), dict(frac=0.5, seed=9)):
        got = te.sample(tdf, replace=True, **kw)
        assert got.blocks.nrows_known
        assert_same_rows(got, je.sample(jdf, replace=True, **kw))


def test_sample_arguments_raise_as_the_jax_package():
    te, je, tdf, jdf = _engines(take_frame(1, 10))
    for kw in (dict(), dict(n=1, frac=0.1)):
        with pytest.raises(ValueError, match="one and only one"):
            te.sample(tdf, **kw)
        with pytest.raises(ValueError, match="one and only one"):
            je.sample(jdf, **kw)


REPARTITIONS = [
    {"algo": "hash", "num": 3, "by": ["k"]},
    {"algo": "hash", "num": 4, "by": ["s", "b"]},
    {"algo": "hash", "num": 5},
    {"algo": "hash", "num": "ROWCOUNT/20", "by": ["v"]},
    {"algo": "hash", "num": 1, "by": ["k"]},
    {"algo": "hash", "num": 3, "by": ["t", "g"]},
    {"algo": "rand"},
    {"algo": "even", "num": 4},
]


@pytest.mark.parametrize("filtered", [False, True], ids=["prefix", "filtered"])
@pytest.mark.parametrize("spec", REPARTITIONS, ids=[str(r) for r in REPARTITIONS])
def test_repartition_matches_jax_row_for_row(spec, filtered):
    """The segment ids of the port's factorization equal the JAX
    package's on these keys, so hash's order is held row for row."""
    te, je, tdf, jdf = _engines(take_frame(9, 70), filtered)
    got, want = te.repartition(tdf, PartitionSpec(spec)), je.repartition(jdf, JSpec(spec))
    if spec["algo"] == "even":  # one card holds the frame whole: both return it
        assert got is tdf and want is jdf
        return
    assert_same_rows(got, want)
    assert te.fallbacks == {}


def test_repartition_hash_keeps_equal_keys_together():
    te = ft.make_execution_engine(device="cpu")
    pdf = take_frame(4, 80)
    out = ft.repartition(pdf, {"algo": "hash", "num": 3, "by": ["k"]}, engine=te)
    assert sorted(out["id"]) == list(range(80))
    runs = (out["k"] != out["k"].shift()).sum()
    assert runs == out["k"].nunique()  # each key one contiguous run
