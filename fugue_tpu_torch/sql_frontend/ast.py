"""AST nodes of the SQL front end: a copy of
``fugue_tpu/sql_frontend/ast.py`` (a typed logical AST of SELECT queries)."""

from typing import Any, List, Optional, Tuple

__all__ = [
    "Expr", "Lit", "Col", "Star", "Unary", "Binary", "Func", "Case", "Cast",
    "InList", "Between", "Like", "IsNull", "Window", "Frame",
    "ScalarSubquery", "InSubquery", "Exists",
    "Relation", "TableRef", "SubqueryRef", "JoinRel",
    "SelectItem", "OrderItem", "Select", "SetOp", "With", "Query",
]


class Node:
    _fields: Tuple[str, ...] = ()

    def __repr__(self) -> str:
        inner = ", ".join(f"{f}={getattr(self, f)!r}" for f in self._fields)
        return f"{type(self).__name__}({inner})"

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other) and all(
            getattr(self, f) == getattr(other, f) for f in self._fields
        )

    def __hash__(self) -> int:  # structural, for agg dedup
        return hash((type(self).__name__,) + tuple(
            tuple(v) if isinstance(v := getattr(self, f), list) else v
            for f in self._fields
        ))


class Expr(Node):
    pass


class Lit(Expr):
    _fields = ("value",)

    def __init__(self, value: Any):
        self.value = value  # None | bool | int | float | str


class Col(Expr):
    _fields = ("name", "table")

    def __init__(self, name: str, table: Optional[str] = None):
        self.name = name
        self.table = table


class Star(Expr):
    _fields = ("table",)

    def __init__(self, table: Optional[str] = None):
        self.table = table


class Unary(Expr):
    _fields = ("op", "operand")

    def __init__(self, op: str, operand: Expr):
        self.op = op  # '-' | '+' | 'NOT'
        self.operand = operand


class Binary(Expr):
    _fields = ("op", "left", "right")

    def __init__(self, op: str, left: Expr, right: Expr):
        self.op = op  # = <> < <= > >= + - * / % || AND OR
        self.left = left
        self.right = right


class Func(Expr):
    _fields = ("name", "args", "distinct")

    def __init__(self, name: str, args: List[Expr], distinct: bool = False):
        self.name = name.lower()
        self.args = args
        self.distinct = distinct


class Case(Expr):
    _fields = ("operand", "whens", "default")

    def __init__(
        self,
        operand: Optional[Expr],
        whens: List[Tuple[Expr, Expr]],
        default: Optional[Expr],
    ):
        self.operand = operand
        self.whens = whens
        self.default = default

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.operand, tuple(self.whens), self.default))


class Cast(Expr):
    _fields = ("operand", "type_name")

    def __init__(self, operand: Expr, type_name: str):
        self.operand = operand
        self.type_name = type_name.lower()


class InList(Expr):
    _fields = ("operand", "items", "negated")

    def __init__(self, operand: Expr, items: List[Expr], negated: bool):
        self.operand = operand
        self.items = items
        self.negated = negated


class Between(Expr):
    _fields = ("operand", "low", "high", "negated")

    def __init__(self, operand: Expr, low: Expr, high: Expr, negated: bool):
        self.operand = operand
        self.low = low
        self.high = high
        self.negated = negated


class Like(Expr):
    _fields = ("operand", "pattern", "negated")

    def __init__(self, operand: Expr, pattern: Expr, negated: bool):
        self.operand = operand
        self.pattern = pattern
        self.negated = negated


class IsNull(Expr):
    _fields = ("operand", "negated")

    def __init__(self, operand: Expr, negated: bool):
        self.operand = operand
        self.negated = negated


class ScalarSubquery(Expr):
    """``(SELECT ...)`` as a value: exactly one output column; one row
    gives its value, zero rows NULL, more is an error. Columns that do
    not bind inside the subquery correlate to the enclosing scope."""

    _fields = ("query",)

    def __init__(self, query: "Query"):
        self.query = query


class InSubquery(Expr):
    """``operand [NOT] IN (SELECT ...)`` with SQL three-valued logic."""

    _fields = ("operand", "query", "negated")

    def __init__(self, operand: "Expr", query: "Query", negated: bool):
        self.operand = operand
        self.query = query
        self.negated = negated


class Exists(Expr):
    """``EXISTS (SELECT ...)`` — true iff the subquery returns rows."""

    _fields = ("query",)

    def __init__(self, query: "Query"):
        self.query = query


class Frame(Node):
    """Explicit window frame clause: ``ROWS|RANGE|GROUPS BETWEEN <bound>
    AND <bound>``. Bounds are ``(kind, n)`` pairs with kind one of
    ``"up"`` (UNBOUNDED PRECEDING), ``"p"`` (n PRECEDING), ``"c"``
    (CURRENT ROW), ``"f"`` (n FOLLOWING), ``"uf"`` (UNBOUNDED
    FOLLOWING); ``n`` is None except for "p"/"f"."""

    _fields = ("unit", "start", "end")

    def __init__(
        self,
        unit: str,  # "rows" | "range" | "groups"
        start: Tuple[str, Optional[Any]],
        end: Tuple[str, Optional[Any]],
    ):
        self.unit = unit
        self.start = start
        self.end = end


class Window(Expr):
    """``func(...) OVER (PARTITION BY ... ORDER BY ... [frame])``. With
    no explicit frame clause and an ORDER BY, aggregates use the SQL
    default frame (RANGE UNBOUNDED PRECEDING .. CURRENT ROW — running
    totals where peers share a value); without ORDER BY, the whole
    partition."""

    _fields = ("func", "partition_by", "order_by", "frame")

    def __init__(
        self,
        func: "Func",
        partition_by: List["Expr"],
        order_by: List["OrderItem"],
        frame: Optional["Frame"] = None,
    ):
        self.func = func
        self.partition_by = partition_by
        self.order_by = order_by
        self.frame = frame


# ---- relations ----------------------------------------------------------


class Relation(Node):
    pass


class TableRef(Relation):
    _fields = ("name", "alias")

    def __init__(self, name: str, alias: Optional[str] = None):
        self.name = name
        self.alias = alias


class SubqueryRef(Relation):
    _fields = ("query", "alias")

    def __init__(self, query: "Query", alias: str):
        self.query = query
        self.alias = alias


class JoinRel(Relation):
    _fields = ("left", "right", "how", "on", "using")

    def __init__(
        self,
        left: Relation,
        right: Relation,
        how: str,  # inner|cross|left_outer|right_outer|full_outer|semi|anti
        on: Optional[Expr] = None,
        using: Optional[List[str]] = None,
    ):
        self.left = left
        self.right = right
        self.how = how
        self.on = on
        self.using = using


# ---- queries ------------------------------------------------------------


class SelectItem(Node):
    _fields = ("expr", "alias")

    def __init__(self, expr: Expr, alias: Optional[str] = None):
        self.expr = expr
        self.alias = alias


class OrderItem(Node):
    _fields = ("expr", "asc", "nulls")

    def __init__(self, expr: Expr, asc: bool = True, nulls: Optional[str] = None):
        self.expr = expr
        self.asc = asc
        self.nulls = nulls  # None | 'FIRST' | 'LAST'


class Query(Node):
    pass


class Select(Query):
    _fields = (
        "items", "from_", "where", "group_by", "having",
        "order_by", "limit", "offset", "distinct",
    )

    def __init__(
        self,
        items: List[SelectItem],
        from_: Optional[Relation] = None,
        where: Optional[Expr] = None,
        group_by: Optional[List[Expr]] = None,
        having: Optional[Expr] = None,
        order_by: Optional[List[OrderItem]] = None,
        limit: Optional[int] = None,
        offset: Optional[int] = None,
        distinct: bool = False,
    ):
        self.items = items
        self.from_ = from_
        self.where = where
        self.group_by = group_by or []
        self.having = having
        self.order_by = order_by or []
        self.limit = limit
        self.offset = offset
        self.distinct = distinct


class SetOp(Query):
    _fields = ("op", "all", "left", "right", "order_by", "limit", "offset")

    def __init__(
        self,
        op: str,  # UNION | EXCEPT | INTERSECT
        all: bool,
        left: Query,
        right: Query,
        order_by: Optional[List[OrderItem]] = None,
        limit: Optional[int] = None,
        offset: Optional[int] = None,
    ):
        self.op = op
        self.all = all
        self.left = left
        self.right = right
        self.order_by = order_by or []
        self.limit = limit
        self.offset = offset


class With(Query):
    _fields = ("ctes", "body")

    def __init__(self, ctes: List[Tuple[str, Query]], body: Query):
        self.ctes = ctes
        self.body = body
