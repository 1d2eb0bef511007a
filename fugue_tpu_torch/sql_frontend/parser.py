"""Recursive-descent SQL parser of the SELECT front end: ``parse_select``,
``Cursor`` and ``ExprParser`` of ``fugue_tpu/sql_frontend/parser.py:103-631``
on their pure-Python path. The JAX package first tries its C++ parser and
scanner (``:104-117``, ``native/cparser.cpp``, ``native/ctokenizer.cpp``),
host code that gives the same AST; the port has not ported them yet
(ROADMAP.md queue 1 item 15) and always parses here.

Supports: WITH CTEs; SELECT [DISTINCT] items; FROM with aliases, subqueries
and INNER/LEFT/RIGHT/FULL/CROSS/SEMI/ANTI joins (ON / USING); WHERE;
GROUP BY (exprs, ordinals or aliases); HAVING; ORDER BY with NULLS
FIRST/LAST; LIMIT/OFFSET; UNION/EXCEPT/INTERSECT [ALL|DISTINCT];
expressions with CASE, CAST, IN, BETWEEN, LIKE, IS NULL, arithmetic,
comparison, boolean logic, function calls (incl. DISTINCT aggregates) and
window functions with OVER (PARTITION BY ... ORDER BY ... [frame]).
"""

from typing import List, Optional, Tuple

from fugue_tpu_torch.exceptions import FugueSQLSyntaxError
from fugue_tpu_torch.sql_frontend.ast import (
    Between, Binary, Case, Cast, Col, Exists, Expr, Frame, Func, InList,
    InSubquery, IsNull, JoinRel, Like, Lit, OrderItem, Query, Relation,
    ScalarSubquery, Select, SelectItem, SetOp, Star, SubqueryRef,
    TableRef, Unary, Window, With,
)
from fugue_tpu_torch.sql_frontend.tokenizer import Token, tokenize

__all__ = ["SQLParseError", "parse_select", "Cursor", "ExprParser"]


class SQLParseError(FugueSQLSyntaxError, ValueError):
    """Parse failure (ValueError kept for pre-hierarchy callers)."""


_RESERVED_AFTER_TABLE = {
    "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "UNION",
    "EXCEPT", "INTERSECT", "JOIN", "INNER", "LEFT", "RIGHT", "FULL",
    "CROSS", "SEMI", "ANTI", "ON", "USING", "NATURAL", "BY", "AND", "OR",
    # FugueSQL statement keywords that may follow a table expression
    "PERSIST", "BROADCAST", "CHECKPOINT", "YIELD", "PREPARTITION",
    "TRANSFORM", "PROCESS", "OUTPUT", "PRINT", "SAVE", "LOAD", "TAKE",
    "SELECT", "WITH", "END", "DISTRIBUTE", "PRESORT", "SINGLE", "FROM",
    "OUTTRANSFORM", "CREATE", "ZIP", "RENAME", "ALTER", "FILL", "SAMPLE",
    "REPLACE", "SEED", "DETERMINISTIC", "LAZY", "WEAK", "STRONG",
    "CALLBACK", "ROWCOUNT", "ROWS", "TITLE", "HASH", "RAND", "EVEN",
    "COARSE", "DROP", "SCHEMA", "PARAMS", "COLUMNS", "OVERWRITE", "APPEND",
}


class Cursor:
    """Token cursor shared by the SELECT parser and the FugueSQL dialect
    parser."""

    def __init__(self, tokens: List[Token]):
        self.tokens = tokens
        self.i = 0

    @property
    def tok(self) -> Token:
        return self.tokens[self.i]

    def peek(self, n: int = 1) -> Token:
        j = min(self.i + n, len(self.tokens) - 1)
        return self.tokens[j]

    def at_end(self) -> bool:
        return self.tok.kind == "END"

    def advance(self) -> Token:
        t = self.tok
        if t.kind != "END":
            self.i += 1
        return t

    def is_kw(self, *words: str) -> bool:
        t = self.tok
        return t.kind == "IDENT" and t.upper in words

    def accept_kw(self, *words: str) -> bool:
        if self.is_kw(*words):
            self.advance()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.accept_kw(word):
            raise SQLParseError(f"expected {word}, got {self.tok.value!r}")

    def is_op(self, *ops: str) -> bool:
        t = self.tok
        return t.kind == "OP" and t.value in ops

    def accept_op(self, *ops: str) -> bool:
        if self.is_op(*ops):
            self.advance()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SQLParseError(f"expected {op!r}, got {self.tok.value!r}")

    def error(self, msg: str) -> SQLParseError:
        return SQLParseError(f"{msg} (at token {self.tok.value!r})")


def parse_select(sql: str) -> Query:
    """The AST of one SELECT statement (an optional trailing ``;``)."""
    cur = Cursor(tokenize(sql))
    q = ExprParser(cur).query()
    cur.accept_op(";")
    if not cur.at_end():
        raise cur.error("unexpected trailing input")
    return q


class ExprParser:
    """Parses queries and expressions from a shared :class:`Cursor`."""

    def __init__(self, cursor: Cursor):
        self.cur = cursor

    # ---- queries --------------------------------------------------------

    def query(self) -> Query:
        cur = self.cur
        if cur.is_kw("WITH"):
            cur.advance()
            ctes: List[Tuple[str, Query]] = []
            while True:
                name = self._name("CTE name")
                cur.expect_kw("AS")
                cur.expect_op("(")
                sub = self.query()
                cur.expect_op(")")
                ctes.append((name, sub))
                if not cur.accept_op(","):
                    break
            return With(ctes, self.query())
        return self._set_expr()

    def _set_expr(self) -> Query:
        left = self._select_core()
        while self.cur.is_kw("UNION", "EXCEPT", "INTERSECT"):
            op = self.cur.advance().upper
            all_ = self.cur.accept_kw("ALL")
            if not all_:
                self.cur.accept_kw("DISTINCT")
            right = self._select_core()
            left = SetOp(op, all_, left, right)
        # trailing ORDER BY / LIMIT bind to the whole set expression
        if isinstance(left, SetOp):
            left.order_by = self._order_by_clause()
            left.limit, left.offset = self._limit_clause()
        return left

    def _select_core(self) -> Query:
        cur = self.cur
        if cur.accept_op("("):
            q = self.query()
            cur.expect_op(")")
            return q
        cur.expect_kw("SELECT")
        distinct = False
        if cur.accept_kw("DISTINCT"):
            distinct = True
        else:
            cur.accept_kw("ALL")
        items = [self._select_item()]
        while cur.accept_op(","):
            items.append(self._select_item())
        from_ = None
        if cur.accept_kw("FROM"):
            from_ = self._from_expr()
        where = self.expr() if cur.accept_kw("WHERE") else None
        group_by: List[Expr] = []
        if cur.accept_kw("GROUP"):
            cur.expect_kw("BY")
            group_by.append(self.expr())
            while cur.accept_op(","):
                group_by.append(self.expr())
        having = self.expr() if cur.accept_kw("HAVING") else None
        order_by = self._order_by_clause()
        limit, offset = self._limit_clause()
        return Select(
            items, from_, where, group_by, having, order_by, limit, offset,
            distinct,
        )

    def _order_by_clause(self) -> List[OrderItem]:
        cur = self.cur
        out: List[OrderItem] = []
        if cur.is_kw("ORDER"):
            cur.advance()
            cur.expect_kw("BY")
            while True:
                e = self.expr()
                asc = True
                if cur.accept_kw("DESC"):
                    asc = False
                else:
                    cur.accept_kw("ASC")
                nulls = None
                if cur.accept_kw("NULLS"):
                    if cur.accept_kw("FIRST"):
                        nulls = "FIRST"
                    else:
                        cur.expect_kw("LAST")
                        nulls = "LAST"
                out.append(OrderItem(e, asc, nulls))
                if not cur.accept_op(","):
                    break
        return out

    def _limit_clause(self) -> Tuple[Optional[int], Optional[int]]:
        cur = self.cur
        limit = offset = None
        if cur.accept_kw("LIMIT"):
            limit = self._int_lit("LIMIT")
        if cur.accept_kw("OFFSET"):
            offset = self._int_lit("OFFSET")
        return limit, offset

    def _int_lit(self, what: str) -> int:
        t = self.cur.tok
        if t.kind != "NUMBER":
            raise self.cur.error(f"{what} expects an integer")
        self.cur.advance()
        return int(t.value)

    def _select_item(self) -> SelectItem:
        cur = self.cur
        if cur.is_op("*"):
            cur.advance()
            return SelectItem(Star())
        # qualified star: t.*
        if (
            cur.tok.kind in ("IDENT", "QIDENT")
            and cur.peek(1).kind == "OP" and cur.peek(1).value == "."
            and cur.peek(2).kind == "OP" and cur.peek(2).value == "*"
        ):
            table = cur.advance().value
            cur.advance()
            cur.advance()
            return SelectItem(Star(table))
        e = self.expr()
        alias = None
        if cur.accept_kw("AS"):
            alias = self._name("alias")
        elif cur.tok.kind == "QIDENT" or (
            cur.tok.kind == "IDENT"
            and cur.tok.upper not in _RESERVED_AFTER_TABLE
        ):
            alias = cur.advance().value
        return SelectItem(e, alias)

    # ---- FROM -----------------------------------------------------------

    def _from_expr(self) -> Relation:
        rel = self._table_primary()
        while True:
            cur = self.cur
            how = None
            if cur.is_kw("CROSS"):
                cur.advance()
                cur.expect_kw("JOIN")
                how = "cross"
            elif cur.is_kw("INNER"):
                cur.advance()
                cur.expect_kw("JOIN")
                how = "inner"
            elif cur.is_kw("JOIN"):
                cur.advance()
                how = "inner"
            elif cur.is_kw("LEFT"):
                if cur.peek(1).upper in ("SEMI", "ANTI"):
                    cur.advance()
                    how = "semi" if cur.advance().upper == "SEMI" else "anti"
                    cur.expect_kw("JOIN")
                else:
                    cur.advance()
                    cur.accept_kw("OUTER")
                    cur.expect_kw("JOIN")
                    how = "left_outer"
            elif cur.is_kw("RIGHT"):
                cur.advance()
                cur.accept_kw("OUTER")
                cur.expect_kw("JOIN")
                how = "right_outer"
            elif cur.is_kw("FULL"):
                cur.advance()
                cur.accept_kw("OUTER")
                cur.expect_kw("JOIN")
                how = "full_outer"
            elif cur.is_kw("SEMI", "ANTI"):
                how = "semi" if cur.advance().upper == "SEMI" else "anti"
                cur.expect_kw("JOIN")
            elif cur.is_op(","):
                cur.advance()
                how = "cross"
                rel = JoinRel(rel, self._table_primary(), how)
                continue
            else:
                break
            right = self._table_primary()
            on = None
            using = None
            if how != "cross":
                if cur.accept_kw("ON"):
                    on = self.expr()
                elif cur.accept_kw("USING"):
                    cur.expect_op("(")
                    using = [self._name("USING column")]
                    while cur.accept_op(","):
                        using.append(self._name("USING column"))
                    cur.expect_op(")")
            rel = JoinRel(rel, right, how, on, using)
        return rel

    def _table_primary(self) -> Relation:
        cur = self.cur
        if cur.accept_op("("):
            q = self.query()
            cur.expect_op(")")
            alias = self._table_alias()
            if alias is None:
                raise cur.error("subquery in FROM requires an alias")
            return SubqueryRef(q, alias)
        name = self._name("table name")
        return TableRef(name, self._table_alias())

    def _table_alias(self) -> Optional[str]:
        cur = self.cur
        if cur.accept_kw("AS"):
            return self._name("alias")
        if cur.tok.kind == "QIDENT" or (
            cur.tok.kind == "IDENT"
            and cur.tok.upper not in _RESERVED_AFTER_TABLE
        ):
            return cur.advance().value
        return None

    def _name(self, what: str) -> str:
        t = self.cur.tok
        if t.kind not in ("IDENT", "QIDENT"):
            raise self.cur.error(f"expected {what}")
        self.cur.advance()
        return t.value

    # ---- expressions ----------------------------------------------------

    def expr(self) -> Expr:
        return self._or_expr()

    def _or_expr(self) -> Expr:
        left = self._and_expr()
        while self.cur.accept_kw("OR"):
            left = Binary("OR", left, self._and_expr())
        return left

    def _and_expr(self) -> Expr:
        left = self._not_expr()
        while self.cur.accept_kw("AND"):
            left = Binary("AND", left, self._not_expr())
        return left

    def _not_expr(self) -> Expr:
        if self.cur.accept_kw("NOT"):
            return Unary("NOT", self._not_expr())
        return self._predicate()

    def _predicate(self) -> Expr:
        cur = self.cur
        left = self._additive()
        while True:
            if cur.is_op("=", "==", "<>", "!=", "<", "<=", ">", ">="):
                op = cur.advance().value
                op = {"==": "=", "!=": "<>"}.get(op, op)
                left = Binary(op, left, self._additive())
                continue
            if cur.is_kw("IS"):
                cur.advance()
                negated = cur.accept_kw("NOT")
                cur.expect_kw("NULL")
                left = IsNull(left, negated)
                continue
            negated = False
            if cur.is_kw("NOT") and cur.peek(1).upper in (
                "IN", "BETWEEN", "LIKE",
            ):
                cur.advance()
                negated = True
            if cur.accept_kw("IN"):
                cur.expect_op("(")
                if cur.is_kw("SELECT", "WITH"):
                    q = self.query()
                    cur.expect_op(")")
                    left = InSubquery(left, q, negated)
                    continue
                items = [self.expr()]
                while cur.accept_op(","):
                    items.append(self.expr())
                cur.expect_op(")")
                left = InList(left, items, negated)
                continue
            if cur.accept_kw("BETWEEN"):
                low = self._additive()
                cur.expect_kw("AND")
                high = self._additive()
                left = Between(left, low, high, negated)
                continue
            if cur.accept_kw("LIKE"):
                left = Like(left, self._additive(), negated)
                continue
            if negated:
                raise cur.error("dangling NOT")
            return left

    def _additive(self) -> Expr:
        left = self._multiplicative()
        while True:
            if self.cur.is_op("+", "-", "||"):
                op = self.cur.advance().value
                left = Binary(op, left, self._multiplicative())
            else:
                return left

    def _multiplicative(self) -> Expr:
        left = self._unary()
        while True:
            if self.cur.is_op("*", "/", "%"):
                op = self.cur.advance().value
                left = Binary(op, left, self._unary())
            else:
                return left

    def _unary(self) -> Expr:
        if self.cur.is_op("-", "+"):
            op = self.cur.advance().value
            return Unary(op, self._unary())
        return self._primary()

    def _primary(self) -> Expr:
        cur = self.cur
        t = cur.tok
        if t.kind == "NUMBER":
            cur.advance()
            v = float(t.value) if ("." in t.value or "e" in t.value.lower()) \
                else int(t.value)
            return Lit(v)
        if t.kind == "STRING":
            cur.advance()
            return Lit(t.value)
        if cur.accept_op("("):
            if cur.is_kw("SELECT", "WITH"):
                q = self.query()
                cur.expect_op(")")
                return ScalarSubquery(q)
            e = self.expr()
            cur.expect_op(")")
            return e
        if t.kind == "QIDENT":
            cur.advance()
            return self._maybe_qualified(t.value)
        if t.kind != "IDENT":
            raise cur.error("expected expression")
        u = t.upper
        if u == "NULL":
            cur.advance()
            return Lit(None)
        if u == "TRUE":
            cur.advance()
            return Lit(True)
        if u == "FALSE":
            cur.advance()
            return Lit(False)
        if u == "CASE":
            return self._case()
        if (
            u == "EXISTS"
            and cur.peek(1).kind == "OP"
            and cur.peek(1).value == "("
            and cur.peek(2).kind == "IDENT"
            and cur.peek(2).upper in ("SELECT", "WITH")
        ):
            cur.advance()
            cur.advance()  # (
            q = self.query()
            cur.expect_op(")")
            return Exists(q)
        if u == "CAST":
            cur.advance()
            cur.expect_op("(")
            e = self.expr()
            cur.expect_kw("AS")
            tp = self._type_name()
            cur.expect_op(")")
            return Cast(e, tp)
        # function call?
        if cur.peek(1).kind == "OP" and cur.peek(1).value == "(":
            name = cur.advance().value
            cur.advance()  # (
            if cur.accept_op(")"):
                return self._maybe_over(Func(name, []))
            if cur.is_op("*"):
                cur.advance()
                cur.expect_op(")")
                return self._maybe_over(Func(name, [Star()]))
            distinct = cur.accept_kw("DISTINCT")
            args = [self.expr()]
            while cur.accept_op(","):
                args.append(self.expr())
            cur.expect_op(")")
            return self._maybe_over(Func(name, args, distinct))
        cur.advance()
        return self._maybe_qualified(t.value)

    def _maybe_over(self, func: Func) -> Expr:
        """``OVER (PARTITION BY ... ORDER BY ...)`` after a function call.
        OVER introduces a window only when followed by ``(`` — a bare
        ``over`` stays available as a select-item alias."""
        cur = self.cur
        if not (
            cur.is_kw("OVER")
            and cur.peek(1).kind == "OP"
            and cur.peek(1).value == "("
        ):
            return func
        cur.advance()
        cur.expect_op("(")
        partition: List[Expr] = []
        if cur.accept_kw("PARTITION"):
            cur.expect_kw("BY")
            partition.append(self.expr())
            while cur.accept_op(","):
                partition.append(self.expr())
        order: List[OrderItem] = []
        if cur.is_kw("ORDER"):
            order = self._order_by_clause()
        frame = None
        if cur.is_kw("ROWS", "RANGE", "GROUPS"):
            frame = self._frame_clause()
        cur.expect_op(")")
        return Window(func, partition, order, frame)

    def _frame_clause(self) -> Frame:
        """``ROWS|RANGE|GROUPS BETWEEN <bound> AND <bound>`` (or the
        single-bound shorthand, whose end is CURRENT ROW)."""
        cur = self.cur
        unit = cur.advance().value.lower()
        if cur.accept_kw("BETWEEN"):
            start = self._frame_bound()
            cur.expect_kw("AND")
            end = self._frame_bound()
        else:
            start = self._frame_bound()
            end = ("c", None)
        if cur.is_kw("EXCLUDE"):
            raise cur.error("EXCLUDE in window frames is not supported")
        if start[0] == "uf" or end[0] == "up":
            raise cur.error("window frame start cannot follow its end")
        _rank = {"up": 0, "p": 1, "c": 2, "f": 3, "uf": 4}
        if _rank[start[0]] > _rank[end[0]]:
            raise cur.error("window frame start cannot follow its end")
        return Frame(unit, start, end)

    def _frame_bound(self) -> Tuple[str, Optional[object]]:
        cur = self.cur
        if cur.accept_kw("UNBOUNDED"):
            if cur.accept_kw("PRECEDING"):
                return ("up", None)
            cur.expect_kw("FOLLOWING")
            return ("uf", None)
        if cur.accept_kw("CURRENT"):
            cur.expect_kw("ROW")
            return ("c", None)
        t = cur.tok
        if t.kind != "NUMBER":
            raise cur.error("expected a numeric window frame offset")
        cur.advance()
        v = t.value
        n: object = float(v) if ("." in v or "e" in v.lower()) else int(v)
        if cur.accept_kw("PRECEDING"):
            return ("p", n)
        cur.expect_kw("FOLLOWING")
        return ("f", n)

    def _maybe_qualified(self, first: str) -> Expr:
        cur = self.cur
        if cur.is_op(".") and cur.peek(1).kind in ("IDENT", "QIDENT"):
            cur.advance()
            name = cur.advance().value
            return Col(name, table=first)
        return Col(first)

    def _case(self) -> Expr:
        cur = self.cur
        cur.expect_kw("CASE")
        operand = None
        if not cur.is_kw("WHEN"):
            operand = self.expr()
        whens: List[Tuple[Expr, Expr]] = []
        while cur.accept_kw("WHEN"):
            c = self.expr()
            cur.expect_kw("THEN")
            whens.append((c, self.expr()))
        default = self.expr() if cur.accept_kw("ELSE") else None
        cur.expect_kw("END")
        if len(whens) == 0:
            raise cur.error("CASE requires at least one WHEN")
        return Case(operand, whens, default)

    def _type_name(self) -> str:
        cur = self.cur
        base = self._name("type name").lower()
        # consume (p[,s]) for decimal-style types; ignored by our type map
        if cur.accept_op("("):
            self._int_lit("type parameter")
            if cur.accept_op(","):
                self._int_lit("type parameter")
            cur.expect_op(")")
        return base
