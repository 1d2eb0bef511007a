"""Invalid SELECT statements raise the JAX package's error on the port:
``SQLExecutionError`` (a ``FugueSQLRuntimeError`` and a ``ValueError``)
with the message of the reference's host SELECT runner
(``fugue_tpu/sql_frontend/select_runner.py``), and count nothing in
``fallbacks``: an unknown column in SELECT, WHERE, GROUP BY, HAVING and
ORDER BY, an unknown table, NTILE's and LAG/LEAD's literal arguments, a
ranking function without ORDER BY, and a RANGE frame with offsets over
two ORDER BY keys or a string key. Each is run on the port
(``device="cpu"``) and on the JAX engine pinned to one CPU device.

Statements that are valid but not ported keep their refusal
(``NotImplementedError`` naming ROADMAP.md queue 1 item 2(b), counted in
``fallbacks``); the last test holds one of them."""

from typing import Any, Tuple

import numpy as np
import pandas as pd
import pytest

import fugue_tpu_torch as ft
from fugue_tpu.sql_frontend.select_runner import SQLExecutionError as JaxSQLExecutionError
from fugue_tpu.workflow.api import raw_sql as jax_raw_sql
from fugue_tpu_torch.exceptions import FugueSQLRuntimeError, SQLExecutionError
from test_torch_join import _jax_df, _jax_engine

INVALID = [
    ("SELECT zz FROM", ""),
    ("SELECT k FROM", " ORDER BY zz"),
    ("SELECT NTILE(0) OVER (ORDER BY v) AS n FROM", ""),
    ("SELECT LAG(v, -1) OVER (ORDER BY k) AS l FROM", ""),
    ("SELECT k, zz FROM", ""),
    ("SELECT t.zz FROM", ""),
    ("SELECT k FROM", " WHERE zz > 1"),
    ("SELECT k, SUM(v) AS s FROM", " GROUP BY zz"),
    ("SELECT k FROM", " GROUP BY k HAVING SUM(zz) > 1"),
    ("SELECT SUM(zz) AS s FROM", ""),
    ("SELECT * FROM", " ORDER BY zz"),
    ("SELECT LEAD(v, -2) OVER (ORDER BY k) AS l FROM", ""),
    ("SELECT LAG(v, 1.5) OVER (ORDER BY k) AS l FROM", ""),
    ("SELECT NTILE(k) OVER (ORDER BY v) AS n FROM", ""),
    ("SELECT NTILE(2.5) OVER (ORDER BY v) AS n FROM", ""),
    ("SELECT NTILE(2) OVER (PARTITION BY k) AS n FROM", ""),
    ("SELECT SUM(v) OVER (ORDER BY k, v RANGE BETWEEN 1 PRECEDING AND CURRENT ROW) AS x FROM", ""),
    ("SELECT SUM(v) OVER (ORDER BY s RANGE BETWEEN 1 PRECEDING AND CURRENT ROW) AS x FROM", ""),
    ("SELECT k FROM (SELECT k FROM", ") AS q WHERE q.v > 0"),
]


def frame() -> pd.DataFrame:
    rng = np.random.default_rng(5)
    return pd.DataFrame({"k": rng.integers(0, 4, 20).astype(np.int64), "v": rng.random(20),
                         "s": rng.choice(["a", "b", "c"], 20)})


def _errors(head: str, tail: str) -> Tuple[Any, Any, Any]:
    t = frame()
    te, je = ft.make_execution_engine(device="cpu"), _jax_engine()
    with pytest.raises(JaxSQLExecutionError) as want:
        jax_raw_sql(head, _jax_df(je, t), tail, engine=je)
    with pytest.raises(SQLExecutionError) as got:
        ft.raw_sql(head, t, tail, engine=te)
    return got.value, want.value, te


@pytest.mark.parametrize("head,tail", INVALID)
def test_invalid_statement_raises_the_references_error(head: str, tail: str) -> None:
    got, want, te = _errors(head, tail)
    assert str(got) == str(want)
    assert isinstance(got, FugueSQLRuntimeError) and isinstance(got, ValueError)
    assert te.fallbacks == {}, te.fallbacks


def test_unknown_table_raises_the_references_error() -> None:
    te, je = ft.make_execution_engine(device="cpu"), _jax_engine()
    with pytest.raises(JaxSQLExecutionError) as want:
        jax_raw_sql("SELECT * FROM zt", engine=je)
    with pytest.raises(SQLExecutionError) as got:
        ft.raw_sql("SELECT * FROM zt", engine=te)
    assert str(got.value) == str(want.value) == "table not found: zt"
    assert te.fallbacks == {}


def test_valid_statements_pass_the_checks() -> None:
    """Aliases in ORDER BY, GROUP BY and HAVING, qualified names, a CTE's
    computed column and a subquery's unaliased one are valid: the port
    runs them or refuses them as not ported, never as invalid."""
    t = frame()
    te = ft.make_execution_engine(device="cpu")
    for head, tail in [
        ("SELECT k AS kk, SUM(v) AS s FROM", " GROUP BY kk HAVING s > 0 ORDER BY kk"),
        ("SELECT a.k, a.v FROM", " AS a ORDER BY a.v"),
        ("WITH c AS (SELECT k, v * 2 AS w FROM", ") SELECT k, w FROM c ORDER BY w"),
        ("SELECT k, x FROM (SELECT k, v + 1 FROM", ") AS q CROSS JOIN (SELECT 1 AS x) AS z"),
    ]:
        try:
            ft.raw_sql(head, t, tail, engine=te)
        except NotImplementedError:
            pass


def test_unported_statement_still_refuses_and_counts() -> None:
    te = ft.make_execution_engine(device="cpu")
    with pytest.raises(NotImplementedError, match=r"queue 1 item 2\(b\)"):
        ft.raw_sql("SELECT k FROM", frame(), " ORDER BY v", engine=te)
    assert te.fallbacks == {"sql_select": 1}
