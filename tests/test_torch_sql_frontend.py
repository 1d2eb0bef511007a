"""The port's SQL front end (``fugue_tpu_torch/sql_frontend``) against the
JAX package's, on the same statements: the tokenizer's tokens (kind,
value, position), the parser's AST (its ``repr``, on the JAX package's
pure-Python path: its ``Cursor`` over ``_scan_py``, so its C++ parser is
not asked), and the algebra bridge's plans: the same tree of plan
classes, output names, join keys and kinds, set operations, ORDER BY
items, LIMIT and OFFSET, window specs, and the same column expressions
(their SQL text); and the same shapes refused (``translate_query`` gives
None on both). Also the scalar-subquery pre-pass, CTE sharing and the
port's refusals."""

from typing import Any, Dict, List

import pytest

from fugue_tpu.sql_frontend import algebra_bridge as jab
from fugue_tpu.sql_frontend.parser import Cursor as JCursor
from fugue_tpu.sql_frontend.parser import ExprParser as JExprParser
from fugue_tpu.sql_frontend.tokenizer import _scan_py as jax_scan
from fugue_tpu_torch.collections.sql import StructuredRawSQL, interleave_sql
from fugue_tpu_torch.exceptions import FugueSQLSyntaxError
from fugue_tpu_torch.sql_frontend import algebra_bridge as ab
from fugue_tpu_torch.sql_frontend.parser import SQLParseError, parse_select
from fugue_tpu_torch.sql_frontend.tokenizer import TokenError, tokenize

SCHEMAS: Dict[str, List[str]] = {
    "a": ["k", "v", "i", "s", "o", "d"],
    "b": ["k", "w"],
    "c": ["k2", "w"],
}

TOKEN_CASES = [
    "SELECT a.k, `weird col`, \"q\"\"x\" FROM t -- comment\nWHERE x >= 1.5e-3 AND y <> 'it''s'",
    "/* block */ SELECT .5, 7E2, 3e, a||b, c!=d, e==f, g=>h FROM t;",
    "SELECT 'back\\\\slash', 'q\\'s', {x}[1] ? : % FROM u",
]

STATEMENTS = [
    # projections, WHERE, expressions
    "SELECT k, v * 2 + 1 AS w, CAST(i AS double) AS c FROM a WHERE v > 0.25 AND NOT (i IS NULL)",
    "SELECT k, CASE WHEN v > 0.5 THEN 1 WHEN v < 0 THEN -1 ELSE 0 END AS b FROM a",
    "SELECT k, CASE i WHEN 1 THEN 'one' ELSE 'many' END AS b FROM a WHERE s LIKE 'a%'",
    "SELECT k, COALESCE(i, 0) AS c, ABS(v) AS av, i % 3 AS m FROM a WHERE k BETWEEN 2 AND 5",
    "SELECT * FROM a WHERE k IN (1, 2, 3) OR s NOT LIKE '%x%'",
    "SELECT k FROM a WHERE s LIKE s",
    # aggregates
    "SELECT k, SUM(v) AS s, COUNT(*) AS c, AVG(v) AS m FROM a GROUP BY k",
    "SELECT k, s, COUNT(DISTINCT i) AS n FROM a GROUP BY 1, 2 HAVING COUNT(*) > 3",
    "SELECT COUNT(*) AS c, MIN(v) AS lo, MAX(v) AS hi, STDDEV(v) AS sd FROM a",
    "SELECT k, SUM(v) AS s FROM a GROUP BY k ORDER BY s DESC LIMIT 3",
    "SELECT DISTINCT k, s FROM a ORDER BY 2 NULLS FIRST, k DESC LIMIT 10 OFFSET 2",
    # joins
    "SELECT a.k, SUM(v) AS s, AVG(w) AS m FROM a AS a JOIN b AS b ON a.k = b.k GROUP BY a.k",
    "SELECT k, v, w FROM a LEFT JOIN b USING (k) ORDER BY v",
    "SELECT k, v, w FROM a RIGHT OUTER JOIN b USING (k)",
    "SELECT k, v, w FROM a FULL OUTER JOIN b USING (k)",
    "SELECT k, v FROM a LEFT SEMI JOIN b ON a.k = b.k",
    "SELECT k, v FROM a ANTI JOIN b ON a.k = b.k",
    "SELECT k, v, k2 FROM a CROSS JOIN c",
    # set operations, CTEs, subqueries
    "SELECT k FROM a UNION SELECT k FROM b ORDER BY k LIMIT 4",
    "SELECT k FROM a EXCEPT ALL SELECT k FROM b",
    "SELECT k, w FROM b INTERSECT SELECT k, w FROM b",
    "WITH t AS (SELECT k, v FROM a WHERE v > 0) SELECT k FROM t UNION ALL SELECT k FROM t",
    "WITH t AS (SELECT k, SUM(v) AS s FROM a GROUP BY k) SELECT k, s FROM t ORDER BY s",
    "SELECT k, o FROM a WHERE k IN (SELECT k FROM b WHERE w > 0.5)",
    "SELECT k, o FROM a WHERE k NOT IN (SELECT k FROM b) AND v > 0",
    "SELECT k, o FROM a WHERE i NOT IN (SELECT w FROM b)",
    "SELECT k, o FROM a AS x WHERE EXISTS (SELECT * FROM b AS y WHERE y.k = x.k AND w > 0)",
    "SELECT k, o FROM a AS x WHERE NOT EXISTS (SELECT 1 AS one FROM b AS y WHERE y.k = x.k)",
    "SELECT k, v FROM (SELECT k, v FROM a WHERE v > 0) AS t WHERE k > 1",
    # windows
    "SELECT k, v, RANK() OVER (PARTITION BY k ORDER BY v DESC) AS rk FROM a",
    "SELECT k, ROW_NUMBER() OVER (ORDER BY o) AS rn, DENSE_RANK() OVER (ORDER BY s NULLS FIRST)"
    " AS dr, NTILE(4) OVER (PARTITION BY k ORDER BY o) AS nt FROM a",
    "SELECT k, PERCENT_RANK() OVER (ORDER BY v) AS p, CUME_DIST() OVER (ORDER BY v) AS c FROM a",
    "SELECT k, SUM(v) OVER (PARTITION BY k ORDER BY d ROWS BETWEEN UNBOUNDED PRECEDING AND"
    " CURRENT ROW) AS r FROM a",
    "SELECT k, AVG(v) OVER (PARTITION BY k) AS m, COUNT(*) OVER () AS c FROM a ORDER BY k",
    "SELECT k, MIN(v) OVER (PARTITION BY k ORDER BY o ROWS BETWEEN 6 PRECEDING AND CURRENT ROW)"
    " AS mn FROM a",
    "SELECT k, LAG(v, 1, 0) OVER (PARTITION BY k ORDER BY o) AS l, LEAD(v, 2, -1.5) OVER"
    " (PARTITION BY k ORDER BY o) AS n FROM a",
    "SELECT k, SUM(v) OVER (PARTITION BY k ORDER BY d RANGE BETWEEN 10 PRECEDING AND CURRENT"
    " ROW) AS r FROM a",
    "SELECT k, MAX(v) OVER (PARTITION BY k ORDER BY d GROUPS BETWEEN 1 PRECEDING AND 1"
    " FOLLOWING) AS r FROM a WHERE v > 0",
    "SELECT k, FIRST_VALUE(v) OVER (PARTITION BY k ORDER BY o) AS f, NTH_VALUE(v, 2) OVER"
    " (PARTITION BY k ORDER BY o ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING)"
    " AS n FROM a",
    "SELECT k, v, rk FROM (SELECT k, v, RANK() OVER (PARTITION BY k ORDER BY v DESC) AS rk"
    " FROM a) AS x WHERE rk <= 100",
]

REFUSED = [
    "SELECT 1 AS one",  # no FROM
    "SELECT a.o FROM a AS a JOIN b AS b ON a.k < b.k",  # non-equi join
    "SELECT a.o FROM a AS a JOIN c AS c ON a.k = c.k2",  # differently named keys
    "SELECT k, v + 1 FROM a",  # unnamed computed column
    "SELECT k, v FROM a ORDER BY a.v",  # qualified ORDER BY
    "SELECT k, v FROM a ORDER BY v * 2",  # expression ORDER BY
    "SELECT k, v FROM a WHERE v > (SELECT AVG(v) FROM a)",  # scalar subquery, not inlined
    "SELECT k, SUM(v * 2) OVER (PARTITION BY k ORDER BY o) AS s FROM a",  # expression arg
    "SELECT k, SUM(v) OVER (PARTITION BY k ORDER BY o ROWS BETWEEN CURRENT ROW AND"
    " 2147483647 FOLLOWING) AS s FROM a",  # offset beyond the device's
    "SELECT k, SUM(v) OVER (PARTITION BY k ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) AS s"
    " FROM a",  # framed but unordered
    "SELECT k, SUM(v) OVER (PARTITION BY k ORDER BY o, d RANGE BETWEEN 1 PRECEDING AND"
    " CURRENT ROW) AS s FROM a",  # RANGE offsets over two keys
    "SELECT k, NTILE(0) OVER (ORDER BY o) AS b FROM a",
    "SELECT k, LAG(v, 1, 'x') OVER (ORDER BY o) AS l FROM a",  # non-numeric default
    "SELECT k, k FROM a AS x JOIN a AS x ON x.k = x.k",  # duplicate alias
    "SELECT x.k FROM a AS x WHERE EXISTS (SELECT * FROM b)",  # uncorrelated EXISTS
    "SELECT k, v FROM a, b",  # shared column names across a cross join
    "SELECT k, COUNT(v) FROM a",  # non-aggregate beside an aggregate, no GROUP BY
    "SELECT k FROM t_missing",
]


def _jax_parse(sql: str) -> Any:
    cur = JCursor(jax_scan(sql))
    q = JExprParser(cur).query()
    cur.accept_op(";")
    assert cur.at_end()
    return q


def shape(node: Any) -> Any:
    """A plan tree as nested tuples of plain values (classes by name,
    column expressions by their SQL text)."""
    if node is None or isinstance(node, (str, int, float, bool)):
        return node
    if isinstance(node, (list, tuple)):
        return tuple(shape(x) for x in node)
    name = type(node).__name__
    if name == "SelectColumns":
        return ("SelectColumns", tuple(str(c) for c in node.all_cols))
    if hasattr(node, "__uuid__") and hasattr(node, "output_name"):  # a column expression
        return ("expr", str(node))
    if name == "WindowSpec":
        return (name, tuple(sorted((k, shape(v)) for k, v in vars(node).items())))
    fields = {k: shape(v) for k, v in vars(node).items()}
    if hasattr(node, "sql_row_names"):
        fields["sql_row_names"] = tuple(node.sql_row_names)
    return (name, tuple(sorted(fields.items())))


@pytest.mark.parametrize("sql", TOKEN_CASES)
def test_tokens_are_the_jax_packages(sql):
    assert [tuple(t) for t in tokenize(sql)] == [tuple(t) for t in jax_scan(sql)]


@pytest.mark.parametrize("sql", ["SELECT 'open", "SELECT /* open", "SELECT \"open", "SELECT #"])
def test_bad_tokens_raise_on_both(sql):
    with pytest.raises(TokenError):
        tokenize(sql)
    with pytest.raises(ValueError):
        jax_scan(sql)


@pytest.mark.parametrize("sql", STATEMENTS + REFUSED)
def test_ast_is_the_jax_packages(sql):
    assert repr(parse_select(sql)) == repr(_jax_parse(sql))


@pytest.mark.parametrize("sql", [
    "SELECT k FROM a WHERE", "SELECT k FROM (SELECT k FROM a)",
    "SELECT SUM(v) OVER (ORDER BY o ROWS BETWEEN CURRENT ROW AND 1 PRECEDING) AS s FROM a",
    "SELECT k FROM a LIMIT x", "SELECT k FROM a ORDER k", "SELECT (k FROM a",
])
def test_syntax_errors_raise_on_both(sql):
    with pytest.raises(SQLParseError) as info:
        parse_select(sql)
    assert isinstance(info.value, FugueSQLSyntaxError)
    with pytest.raises(ValueError):
        _jax_parse(sql)


@pytest.mark.parametrize("sql", STATEMENTS)
def test_plans_are_the_jax_packages(sql):
    got = ab.translate_query(parse_select(sql), SCHEMAS)
    want = jab.translate_query(_jax_parse(sql), SCHEMAS)
    assert got is not None and want is not None
    assert shape(got) == shape(want)


@pytest.mark.parametrize("sql", REFUSED)
def test_refused_shapes_are_the_jax_packages(sql):
    assert ab.translate_query(parse_select(sql), SCHEMAS) is None
    assert jab.translate_query(_jax_parse(sql), SCHEMAS) is None


def test_a_cte_read_twice_is_one_plan():
    plan = ab.translate_query(parse_select(STATEMENTS[21]), SCHEMAS)
    assert plan.left.source is plan.right.source  # the CTE body, shared


def test_scalar_subqueries_inline_as_the_jax_package_does():
    sql = "SELECT k, v FROM a WHERE v > (SELECT AVG(v) AS m FROM a) AND k < (SELECT 3 AS x)"

    class One:
        def __init__(self, value: Any, pa_type: Any):
            import pyarrow as pa

            self.schema = type("S", (), {"fields": [pa.field("m", pa_type)]})()
            self._table = pa.table({"m": pa.array([value], pa_type)})

        def count(self) -> int:
            return 1

        def as_arrow(self) -> Any:
            return self._table

        def as_array(self) -> Any:
            return [[self._table.column(0)[0].as_py()]]

    import pyarrow as pa

    q, jq = parse_select(sql), _jax_parse(sql)
    ab.inline_scalar_subqueries(q, SCHEMAS, lambda p: One(0.5, pa.float64()))
    jab.inline_scalar_subqueries(jq, SCHEMAS, lambda p: One(0.5, pa.float64()))
    assert repr(q) == repr(jq)
    assert "ScalarSubquery" not in repr(q.where.left)
    assert shape(ab.translate_query(q, SCHEMAS)) == shape(jab.translate_query(jq, SCHEMAS))


def test_interleave_and_construct():
    import pandas as pd

    df = pd.DataFrame({"k": [1]})
    parts, dfs = interleave_sql(("SELECT k FROM", df, "WHERE k > 0"))
    (name, frame), = dfs.items()
    assert frame is df and name.startswith("_fugue_tpu_tmp_")
    assert StructuredRawSQL(parts).construct() == f"SELECT k FROM {name} WHERE k > 0 "
    assert StructuredRawSQL(parts).construct({name: "t"}) == "SELECT k FROM t WHERE k > 0 "
    with pytest.raises(ValueError, match="cannot interleave"):
        interleave_sql(("SELECT k FROM", {"t": df}))
