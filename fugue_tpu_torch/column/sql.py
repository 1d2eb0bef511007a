"""``SelectColumns``, a validated projection list, and the HAVING rewrite.

A trimmed copy of ``fugue_tpu/column/sql.py:22`` (``SelectColumns``)
holding what the engine's ``select`` uses: the wildcard, the group keys
(the columns that are not aggregations), the aggregations, DISTINCT and
the output schema; and of ``_rewrite_having``
(``fugue_tpu/column/pandas_eval.py:495``)."""

from typing import Dict, List

from fugue_tpu_torch.column.expressions import (
    ColumnExpr,
    _BinaryOpExpr,
    _FuncExpr,
    _NamedColumnExpr,
    _UnaryOpExpr,
    col,
)
from fugue_tpu_torch.column.functions import is_agg
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw


def _is_wildcard(c: ColumnExpr) -> bool:
    return isinstance(c, _NamedColumnExpr) and c.wildcard


class SelectColumns:
    """A validated projection list, with aggregations or without."""

    def __init__(self, *cols: ColumnExpr, arg_distinct: bool = False):
        self._cols = list(cols)
        self._distinct = arg_distinct
        assert_or_throw(len(self._cols) > 0, ValueError("empty select"))
        self._agg = [c for c in self._cols if is_agg(c)]
        self._non_agg = [c for c in self._cols if not is_agg(c)]
        if self.has_agg:
            assert_or_throw(
                not any(_is_wildcard(c) for c in self._cols),
                ValueError("wildcard can't be used with aggregations"),
            )

    @property
    def is_distinct(self) -> bool:
        return self._distinct

    @property
    def all_cols(self) -> List[ColumnExpr]:
        return self._cols

    @property
    def has_agg(self) -> bool:
        return len(self._agg) > 0

    @property
    def agg_funcs(self) -> List[ColumnExpr]:
        return self._agg

    @property
    def group_keys(self) -> List[ColumnExpr]:
        """The expressions that are not aggregations: the implicit GROUP BY
        keys."""
        return self._non_agg

    def assert_all_with_names(self) -> "SelectColumns":
        names: List[str] = []
        for c in self._cols:
            if _is_wildcard(c) and c.as_name == "":
                continue
            name = c.output_name
            assert_or_throw(name != "", ValueError(f"{c} has no output name"))
            names.append(name)
        assert_or_throw(
            len(set(names)) == len(names),
            ValueError(f"duplicated output names in {names}"),
        )
        return self

    def replace_wildcard(self, schema: Schema) -> "SelectColumns":
        """``*`` expanded to the schema's columns that no other column of
        the list names."""
        cols: List[ColumnExpr] = []
        for c in self._cols:
            if _is_wildcard(c) and c.as_name == "":
                explicit = set(x.output_name for x in self._cols if not _is_wildcard(x))
                cols.extend(_NamedColumnExpr(n) for n in schema.names if n not in explicit)
            else:
                cols.append(c)
        return SelectColumns(*cols, arg_distinct=self._distinct)

    def infer_schema(self, schema: Schema) -> Schema:
        resolved = self.replace_wildcard(schema).assert_all_with_names()
        return Schema([c.infer_schema_field(schema) for c in resolved.all_cols])


def rewrite_having(
    expr: ColumnExpr, computed: Dict[str, str], extra: Dict[str, ColumnExpr]
) -> ColumnExpr:
    """HAVING over an aggregate's output: each aggregation in ``expr``
    becomes a reference to the output column that holds it (``computed``,
    by the aggregation's uuid without its alias), or to a new hidden
    column ``_having_<i>`` added to ``extra``."""
    if isinstance(expr, _FuncExpr) and expr.is_aggregation:
        key = expr.alias("").__uuid__()
        if key in computed:
            return col(computed[key])
        name = f"_having_{len(extra)}"
        extra[name] = expr.alias(name)
        computed[key] = name
        return col(name)
    if isinstance(expr, _BinaryOpExpr):
        return _BinaryOpExpr(
            expr.op,
            rewrite_having(expr.left, computed, extra),
            rewrite_having(expr.right, computed, extra),
        )
    if isinstance(expr, _UnaryOpExpr):
        return _UnaryOpExpr(expr.op, rewrite_having(expr.col, computed, extra))
    return expr
