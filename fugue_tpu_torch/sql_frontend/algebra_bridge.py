"""SQL AST -> device plan bridge: a copy of
``fugue_tpu/sql_frontend/algebra_bridge.py:69-1268`` (the plans,
``translate_query``, ``inline_scalar_subqueries``, ``_window_select``,
``_order_items``, ``_expr``), building its column expressions from the
port's ``column`` package.

It lowers SELECT queries into a small tree of engine primitives
(``engine.join`` / ``union`` / ``select`` / ``distinct``, a device sort,
device windows and the three-valued NOT IN join): joins on equal-named
keys, set operations, GROUP BY aggregates with HAVING, DISTINCT, CASE,
LIKE and the scalar function library, uncorrelated ``col [NOT] IN
(SELECT ...)`` WHERE conjuncts as SEMI / NOT IN joins, equi-correlated
``[NOT] EXISTS`` as SEMI/ANTI joins, uncorrelated scalar subqueries
inlined as literals the device computed, ORDER BY/LIMIT/OFFSET, and
window functions (``WindowPlan``): the ranking family, whole-partition,
running and framed aggregates (ROWS, GROUPS, RANGE with numeric offsets),
LAG/LEAD and FIRST/LAST/NTH_VALUE. ``translate_query`` returns ``None``
for any other shape; the JAX package then answers on its host SELECT
runner, which the port has not ported (ROADMAP.md queue 1 item 2(b)).

Name scoping is tracked per relation (each plan node knows its output
column names), so a qualified reference to a column the relation does
not own is a translation failure, not a silent mis-binding.
"""

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.column.expressions import ColumnExpr, col, function, lit, null
from fugue_tpu_torch.column.sql import SelectColumns
from fugue_tpu_torch.sql_frontend import ast

__all__ = [
    "translate_query",
    "inline_scalar_subqueries",
    "Plan",
    "ScanPlan",
    "JoinPlan",
    "NotInJoinPlan",
    "SetPlan",
    "SelectPlan",
    "WindowPlan",
    "WindowSpec",
]

from fugue_tpu_torch.column.functions import VARIANCE_FUNCS, _agg

_AGG_FUNCS = {
    "sum", "min", "max", "avg", "mean", "count", "first", "last",
    "median", *VARIANCE_FUNCS,
}

_JOIN_HOW = {
    "inner": "inner",
    "cross": "cross",
    "left_outer": "left_outer",
    "right_outer": "right_outer",
    "full_outer": "full_outer",
    "semi": "semi",
    "anti": "anti",
}


class _GiveUp(Exception):
    pass


class Plan:
    """A device-executable relational plan node.

    ``out_names`` is the node's PHYSICAL output column list (what the
    engine frame will hold); executors walk the tree with engine
    primitives. ``sql_row_names`` is the SQL-visible namespace, which can
    differ: an ON equi-join keeps BOTH key columns visible (referencing
    the bare key is ambiguous, per the host oracle) even though the
    engine output collapses them, while USING merges them in SQL too."""

    out_names: List[str]

    @property
    def sql_row_names(self) -> List[str]:
        return self.out_names


class ScanPlan(Plan):
    def __init__(self, table: str, out_names: List[str]):
        self.table = table
        self.out_names = out_names


class JoinPlan(Plan):
    def __init__(
        self,
        left: Plan,
        right: Plan,
        how: str,
        on: List[str],
        using: bool = False,
    ):
        self.left = left
        self.right = right
        self.how = how
        self.on = on
        self.using = using
        if how in ("semi", "anti"):
            self.out_names = list(left.out_names)
            self._sql_names = list(left.sql_row_names)
        else:
            keyset = {k.lower() for k in on}
            self.out_names = list(left.out_names) + [
                n for n in right.out_names if n.lower() not in keyset
            ]
            if using:
                self._sql_names = list(self.out_names)
            else:
                # ON join: both key columns stay SQL-visible, so a bare
                # reference to the key is ambiguous — exactly what the
                # host oracle enforces
                self._sql_names = list(left.sql_row_names) + list(
                    right.sql_row_names
                )

    @property
    def sql_row_names(self) -> List[str]:
        return self._sql_names


class NotInJoinPlan(Plan):
    """``WHERE x NOT IN (SELECT ...)`` — an anti-join variant with SQL's
    three-valued NOT IN semantics (relational.not_in_join). Keeps the
    left frame's columns/visibility like semi/anti."""

    def __init__(self, left: Plan, right: Plan, key: str):
        self.left = left
        self.right = right
        self.key = key
        self.out_names = list(left.out_names)
        self._sql_names = list(left.sql_row_names)

    @property
    def sql_row_names(self) -> List[str]:
        return self._sql_names


class SetPlan(Plan):
    def __init__(self, op: str, distinct: bool, left: Plan, right: Plan):
        self.op = op  # union | except | intersect
        self.distinct = distinct
        self.left = left
        self.right = right
        self.out_names = list(left.out_names)


class SelectPlan(Plan):
    """Project/filter/aggregate over ``source`` plus post-ops.

    ``cols is None`` means pass the source through unchanged (used to
    hang ORDER BY / LIMIT off a set-op result)."""

    def __init__(
        self,
        source: Plan,
        cols: Optional[SelectColumns],
        where: Optional[ColumnExpr],
        having: Optional[ColumnExpr],
        order_by: List[Tuple[str, bool, Optional[str]]],
        limit: Optional[int],
        offset: Optional[int],
        distinct: bool,
        out_names: List[str],
    ):
        self.source = source
        self.cols = cols
        self.where = where
        self.having = having
        self.order_by = order_by  # (output column, asc, nulls)
        self.limit = limit
        self.offset = offset
        self.distinct = distinct
        self.out_names = out_names


class WindowSpec:
    """One device-lowerable window item: the ranking family
    (row_number/rank/dense_rank/ntile/percent_rank/cume_dist, needing
    ORDER BY), a whole-partition aggregate (sum/count/avg/min/max, no
    ORDER BY), a running or ROWS-framed aggregate/positional
    (sum/count/avg/min/max/first_value/last_value/nth_value with ORDER
    BY), or lag/lead. ``param`` holds ntile's bucket count, nth_value's
    position or lag/lead's offset; ``default`` lag/lead's fill literal.
    ``frame`` is a normalized frame ``(unit, lo_kind, lo_n, hi_kind,
    hi_n)`` — unit 'rows'/'groups'/'range', kinds 'up'/'p'/'c'/'f'/'uf'
    — or None for the default frame (running when ``order_by`` is
    non-empty; RANGE offsets require exactly one ORDER BY key)."""

    def __init__(
        self,
        name: str,
        func: str,
        arg: Optional[str],
        partition_by: List[str],
        order_by: List[Tuple[str, bool, Optional[bool]]],
        param: Optional[int] = None,
        frame: Optional[
            Tuple[str, str, Optional[float], str, Optional[float]]
        ] = None,
        default: Optional[object] = None,
    ):
        self.name = name
        self.func = func
        self.arg = arg
        self.partition_by = partition_by
        self.order_by = order_by  # (column, asc, nulls_first)
        self.param = param
        self.frame = frame
        self.default = default


class WindowPlan(Plan):
    """Window items + passthrough columns over ``source``; executed by
    ``relational.device_window``."""

    def __init__(
        self,
        source: Plan,
        items: List[Tuple[str, object]],
        where: Optional[ColumnExpr],
        out_names: List[str],
    ):
        self.source = source
        self.items = items  # ("col", (out, src)) | ("win", WindowSpec)
        self.where = where
        self.out_names = out_names


class _Scope:
    """Visible relations: alias -> that relation's output column names.
    ``row_names`` is the FROM clause's final (join-deduped) column list —
    unqualified references resolve against it, so a join key appearing on
    both sides is unambiguous exactly when the join collapsed it."""

    def __init__(self) -> None:
        self.relations: Dict[str, List[str]] = {}
        self.row_names: List[str] = []
        # (alias, column) pairs whose SQL value diverges from the surviving
        # joined column — e.g. ``b.k`` after ``a LEFT JOIN b`` is NULL on
        # unmatched rows while the surviving ``k`` is a's value
        self.tainted: Set[Tuple[str, str]] = set()

    def add(self, alias: str, names: List[str]) -> None:
        if alias.lower() in self.relations:
            raise _GiveUp()  # duplicate alias: let the host runner error
        self.relations[alias.lower()] = names

    def taint(self, alias: str, name: str) -> None:
        self.tainted.add((alias.lower(), name.lower()))

    def resolve(self, name: str, table: Optional[str]) -> str:
        """Return the bound column name, or give up on a bad/ambiguous
        reference (the host runner owns the error message)."""
        if table is not None:
            if (table.lower(), name.lower()) in self.tainted:
                raise _GiveUp()
            names = self.relations.get(table.lower())
            if names is None:
                raise _GiveUp()
            for n in names:
                if n.lower() == name.lower():
                    return n
            raise _GiveUp()
        hits = [n for n in self.row_names if n.lower() == name.lower()]
        if len(hits) != 1:
            raise _GiveUp()
        return hits[0]


def inline_scalar_subqueries(
    q: ast.Node,
    df_schemas: Dict[str, Sequence[str]],
    run_plan: Any,  # Callable[[Plan], DataFrame-like]
) -> None:
    """Pre-pass: replace each UNCORRELATED scalar subquery whose body
    lowers to a device plan with the literal value computed on device
    (one scalar readback — the data never leaves the device). The
    rewritten outer query then lowers as usual, so e.g.
    ``WHERE v > (SELECT AVG(v) FROM t)`` runs entirely in-engine.

    Non-lowerable, correlated, multi-row or exotic-typed subqueries stay
    in the tree — the host runner owns those (including the proper
    "more than one row" error). Mutates ``q`` in place (the ast is
    parsed fresh per statement).

    Guards: a subquery referencing a name any CTE
    shadows is never inlined (the base-table value would silently
    diverge from the host's CTE-scoped one), and nothing executes until
    a cheap placeholder probe shows the OUTER query would lower — a
    host-destined statement must not pay device subquery runs it will
    redo on the host."""
    import copy

    cte_names: Set[str] = set()
    subq_count = 0

    def _scan(node: Any) -> None:
        nonlocal subq_count
        if isinstance(node, ast.With):
            cte_names.update(name.lower() for name, _ in node.ctes)
        if isinstance(node, ast.ScalarSubquery):
            subq_count += 1
        if isinstance(node, ast.Node):
            for f in node._fields:
                _scan_val(getattr(node, f))

    def _scan_val(v: Any) -> None:
        if isinstance(v, ast.Node):
            _scan(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                _scan_val(x)

    _scan(q)
    if subq_count == 0:
        return
    # probe: would the outer query lower with the subqueries replaced by
    # placeholder literals? (numeric and string shapes both tried — the
    # value's kind can decide lowerability)
    probe_ok = False
    for ph in (ast.Lit(0), ast.Lit("")):
        qc = copy.deepcopy(q)

        def _stub(node: Any) -> Any:
            if isinstance(node, ast.ScalarSubquery):
                return copy.deepcopy(ph)
            if isinstance(node, ast.Node):
                for f in node._fields:
                    setattr(node, f, _stub_val(getattr(node, f)))
            return node

        def _stub_val(v: Any) -> Any:
            if isinstance(v, ast.Node):
                return _stub(v)
            if isinstance(v, list):
                return [_stub_val(x) for x in v]
            if isinstance(v, tuple):
                return tuple(_stub_val(x) for x in v)
            return v

        if translate_query(_stub(qc), df_schemas) is not None:
            probe_ok = True
            break
    if not probe_ok:
        return

    def _references_cte(sub: ast.Node) -> bool:
        found = False

        def _walk_refs(node: Any) -> None:
            nonlocal found
            if isinstance(node, ast.TableRef):
                if node.name.lower() in cte_names:
                    found = True
            if isinstance(node, ast.Node):
                for f in node._fields:
                    _walk_refs_val(getattr(node, f))

        def _walk_refs_val(v: Any) -> None:
            if isinstance(v, ast.Node):
                _walk_refs(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    _walk_refs_val(x)

        _walk_refs(sub)
        return found

    def _rewrite(node: Any) -> Any:
        if isinstance(node, ast.ScalarSubquery):
            if cte_names and _references_cte(node.query):
                return node  # a CTE shadows the name: host scoping wins
            # translate a COPY: when this pass declines to inline (plan
            # not lowerable, >1 row, exotic value), the original tree must
            # come out untouched — the host runner reuses it, and a
            # synthetic __scalar__ alias left behind would leak into its
            # scoping
            query = node.query
            if (
                isinstance(node.query, ast.Select)
                and len(node.query.items) == 1
                and node.query.items[0].alias is None
                and not isinstance(node.query.items[0].expr, ast.Star)
            ):
                # the bridge needs named computed columns; the name is
                # never visible to the outer query
                query = copy.deepcopy(node.query)
                query.items[0].alias = "__scalar__"
            plan = translate_query(query, df_schemas)
            if plan is None or len(plan.out_names) != 1:
                return node
            try:
                res = run_plan(plan)
                n = res.count()
                if n > 1:
                    return node  # host raises the >1-row error
                v = None if n == 0 else res.as_arrow().column(0)[0].as_py()
                tp = res.schema.fields[0].type
            except Exception:
                return node
            if isinstance(v, float) and v != v:
                v = None  # NaN payload -> SQL NULL
            if v is None:
                # a bare NULL literal is typeless; the host's scalar
                # subquery carries the subquery's dtype — cast to match
                tn = _sql_type_name(tp)
                return (
                    ast.Cast(ast.Lit(None), tn) if tn is not None else node
                )
            if isinstance(v, (bool, int, float, str)):
                return ast.Lit(v)
            return node  # exotic value type: host owns it
        if isinstance(node, ast.Node):
            for f in node._fields:
                setattr(node, f, _walk(getattr(node, f)))
        return node

    def _walk(v: Any) -> Any:
        if isinstance(v, ast.Node):
            return _rewrite(v)
        if isinstance(v, list):
            return [_walk(x) for x in v]
        if isinstance(v, tuple):
            return tuple(_walk(x) for x in v)
        return v

    _rewrite(q)


def _sql_type_name(tp: Any) -> Optional[str]:
    """SQL type name for a pyarrow type (inverse of the parsers'
    _SQL_TYPES for the types a scalar subquery can produce)."""
    import pyarrow as pa

    if pa.types.is_float64(tp):
        return "double"
    if pa.types.is_float32(tp):
        return "float"
    if pa.types.is_int64(tp):
        return "long"
    if pa.types.is_int32(tp):
        return "int"
    if pa.types.is_int16(tp):
        return "smallint"
    if pa.types.is_int8(tp):
        return "tinyint"
    if pa.types.is_boolean(tp):
        return "boolean"
    if pa.types.is_string(tp) or pa.types.is_large_string(tp):
        return "string"
    return None


def translate_query(
    query: ast.Query, df_schemas: Dict[str, Sequence[str]]
) -> Optional[Plan]:
    """Translate a full query (CTEs, set ops, joins, nested SELECTs) into
    a device plan, or ``None`` when any part falls outside the supported
    shape."""
    try:
        return _query(
            {n.lower(): list(v) for n, v in df_schemas.items()}, query
        )
    except _GiveUp:
        return None


def _query(env: Dict[str, object], q: ast.Query) -> Plan:
    if isinstance(q, ast.With):
        inner = dict(env)
        for name, sub in q.ctes:
            inner[name.lower()] = _query(inner, sub)
        return _query(inner, q.body)
    if isinstance(q, ast.SetOp):
        op = q.op.lower()
        if op not in ("union", "except", "intersect"):
            raise _GiveUp()
        left = _query(env, q.left)
        right = _query(env, q.right)
        plan: Plan = SetPlan(op, not q.all, left, right)
        if q.order_by or q.limit is not None or q.offset is not None:
            order = _order_items(q.order_by, plan.out_names)
            plan = SelectPlan(
                plan, None, None, None, order, q.limit, q.offset,
                False, list(plan.out_names),
            )
        return plan
    if isinstance(q, ast.Select):
        return _select(env, q)
    raise _GiveUp()


def _relation(env: Dict[str, object], rel: ast.Relation, scope: _Scope) -> Plan:
    if isinstance(rel, ast.TableRef):
        target = env.get(rel.name.lower())
        if target is None:
            raise _GiveUp()
        alias = rel.alias or rel.name
        if isinstance(target, Plan):  # CTE body
            plan: Plan = target
            names = list(target.out_names)
        else:
            names = list(target)  # type: ignore[arg-type]
            plan = ScanPlan(rel.name.lower(), names)
        scope.add(alias, names)
        return plan
    if isinstance(rel, ast.SubqueryRef):
        sub = _query(env, rel.query)
        scope.add(rel.alias, list(sub.out_names))
        return sub
    if isinstance(rel, ast.JoinRel):
        left = _relation(env, rel.left, scope)
        left_aliases = set(scope.relations)
        right_scope = _Scope()
        right = _relation(env, rel.right, right_scope)
        for alias, names in right_scope.relations.items():
            scope.add(alias, names)
        scope.tainted |= right_scope.tainted
        how = _JOIN_HOW.get(rel.how.lower().replace(" ", "_"))
        if how is None:
            raise _GiveUp()
        keys = _join_keys(rel, left, right)
        if how != "cross" and len(keys) == 0:
            raise _GiveUp()
        # a qualified key reference on an outer join's null-filled side is
        # NOT the surviving joined key — decline those bindings
        if how in ("left_outer", "full_outer"):
            for alias in set(scope.relations) - left_aliases:
                for k in keys:
                    scope.taint(alias, k)
        if how in ("right_outer", "full_outer"):
            for alias in left_aliases:
                for k in keys:
                    scope.taint(alias, k)
        plan = JoinPlan(left, right, how, keys, using=bool(rel.using))
        lowered_names = [n.lower() for n in plan.out_names]
        if len(set(lowered_names)) != len(lowered_names):
            raise _GiveUp()  # shared non-key columns: engine.join can't
        return plan
    raise _GiveUp()


def _join_keys(rel: ast.JoinRel, left: Plan, right: Plan) -> List[str]:
    """Equi-join keys: USING(...) or an ON conjunction of same-name
    column equalities across the two sides. Keys resolve
    case-insensitively against BOTH sides' actual column names."""
    lnames = {n.lower(): n for n in left.out_names}
    rnames = {n.lower(): n for n in right.out_names}
    if rel.using:
        out = []
        for u in rel.using:
            nl = u.lower()
            if nl not in lnames or nl not in rnames:
                raise _GiveUp()
            out.append(lnames[nl])
        return out
    if rel.on is None:
        return []

    def _conj(e: ast.Expr) -> List[str]:
        if isinstance(e, ast.Binary) and e.op.upper() == "AND":
            return _conj(e.left) + _conj(e.right)
        if (
            isinstance(e, ast.Binary)
            and e.op == "="
            and isinstance(e.left, ast.Col)
            and isinstance(e.right, ast.Col)
        ):
            a, b = e.left, e.right
            if a.name.lower() != b.name.lower():
                raise _GiveUp()  # differently-named equi keys: host only
            nl = a.name.lower()
            if nl not in lnames or nl not in rnames:
                raise _GiveUp()
            return [lnames[nl]]
        raise _GiveUp()

    return _conj(rel.on)


def _select(env: Dict[str, object], q: ast.Select) -> Plan:
    if q.from_ is None:
        raise _GiveUp()  # FROM-less SELECT: host evaluates it fine
    scope = _Scope()
    source = _relation(env, q.from_, scope)
    scope.row_names = list(source.sql_row_names)
    if any(isinstance(it.expr, ast.Window) for it in q.items):
        return _window_select(q, scope, source)

    exprs: List[ColumnExpr] = []
    out_names: List[str] = []
    implicit_star = False
    for item in q.items:
        if isinstance(item.expr, ast.Star):
            if (
                item.expr.table is not None
                and item.expr.table.lower() not in scope.relations
            ):
                raise _GiveUp()
            if item.expr.table is not None and len(scope.relations) > 1:
                raise _GiveUp()  # per-table star over a join: host only
            visible = [n.lower() for n in source.sql_row_names]
            if len(set(visible)) != len(visible):
                # SELECT * over an ON join duplicates the key column —
                # the host oracle rejects that; don't silently dedup
                raise _GiveUp()
            exprs.append(col("*"))
            out_names.extend(source.out_names)
            implicit_star = True
            continue
        e = _expr(item.expr, scope)
        if item.alias:
            e = e.alias(item.alias)
        elif e.output_name == "":
            raise _GiveUp()  # unnamed computed column
        exprs.append(e)
        out_names.append(e.output_name)

    cols = SelectColumns(*exprs)
    if cols.has_agg and implicit_star:
        raise _GiveUp()
    if q.group_by:
        # each GROUP BY entry — ordinal, select alias, plain column or
        # expression — must cover a non-agg select item, and every
        # non-agg item must be covered (extra keys: host runner)
        na_pairs = [
            (item, e)
            for item, e in zip(q.items, exprs)
            if any(e is k for k in cols.group_keys)
        ]
        covered = [False] * len(na_pairs)

        def _cover(pred) -> bool:
            hit = False
            for j, (item, e2) in enumerate(na_pairs):
                if pred(item, e2):
                    covered[j] = True
                    hit = True
            return hit

        for g in q.group_by:
            if (
                isinstance(g, ast.Lit)
                and isinstance(g.value, int)
                and not isinstance(g.value, bool)
            ):
                idx = g.value - 1
                if not (0 <= idx < len(q.items)) or not _cover(
                    lambda item, _e, t=q.items[idx]: item is t
                ):
                    raise _GiveUp()
                continue
            if isinstance(g, ast.Col):
                # a real input column takes precedence over a select
                # alias of the same folded name (host runner agrees);
                # an ambiguous reference gives up so the host owns the
                # error message
                if g.table is None and not any(
                    n.lower() == g.name.lower() for n in scope.row_names
                ):
                    if _cover(
                        lambda item, _e: item.alias is not None
                        and item.alias.lower() == g.name.lower()
                    ):
                        continue
                    raise _GiveUp()
                resolved = scope.resolve(g.name, g.table).lower()

                def _same_col(item: ast.SelectItem, _e: ColumnExpr) -> bool:
                    if not isinstance(item.expr, ast.Col):
                        return False
                    try:
                        return (
                            scope.resolve(
                                item.expr.name, item.expr.table
                            ).lower()
                            == resolved
                        )
                    except Exception:
                        return False

                if _cover(_same_col):
                    continue
                raise _GiveUp()
            if not _cover(lambda item, _e: item.expr == g):
                raise _GiveUp()
        if not all(covered) or not cols.has_agg:
            raise _GiveUp()
    elif cols.has_agg and len(cols.group_keys) > 0:
        raise _GiveUp()  # non-agg cols without GROUP BY is invalid SQL

    where_ast = q.where
    if where_ast is not None:
        source, where_ast = _lower_in_subqueries(
            env, source, scope, where_ast
        )
    where = _expr(where_ast, scope) if where_ast is not None else None
    having = _expr(q.having, scope) if q.having is not None else None
    order = _order_items(q.order_by, out_names)
    return SelectPlan(
        source, cols, where, having, order, q.limit, q.offset,
        q.distinct, out_names,
    )


def _lower_in_subqueries(
    env: Dict[str, object],
    source: Plan,
    scope: _Scope,
    where: ast.Expr,
) -> Tuple[Plan, Optional[ast.Expr]]:
    """Uncorrelated ``col IN (SELECT ...)`` WHERE conjuncts become
    device SEMI joins against the translated subquery; ``col NOT IN
    (SELECT ...)`` becomes a :class:`NotInJoinPlan` — an anti-join
    variant carrying SQL's three-valued NOT IN semantics (any NULL on
    the right keeps nothing; an empty right keeps everything). NULL
    semantics of the IN form match exactly: in a WHERE context a
    no-match NULL filters the row just like FALSE, and null keys never
    join."""

    remaining: List[ast.Expr] = []
    for c in _split_conjuncts(where):
        if isinstance(c, ast.InSubquery) and isinstance(c.operand, ast.Col):
            sub = _query(env, c.query)  # correlated refs -> _GiveUp
            if len(sub.out_names) != 1:
                raise _GiveUp()  # the host owns the arity error
            keyname = scope.resolve(c.operand.name, c.operand.table)
            inner = sub.out_names[0]
            if inner.lower() != keyname.lower():
                sub = SelectPlan(
                    sub,
                    SelectColumns(col(inner).alias(keyname)),
                    None, None, [], None, None, False, [keyname],
                )
            if c.negated:
                source = NotInJoinPlan(source, sub, keyname)
            else:
                source = JoinPlan(source, sub, "semi", [keyname])
            continue
        ex = _exists_form(c)
        if ex is not None:
            source = _decorrelate_exists(env, source, scope, *ex)
            continue
        remaining.append(c)
    out: Optional[ast.Expr] = None
    for c in remaining:
        out = c if out is None else ast.Binary("AND", out, c)
    return source, out


def _split_conjuncts(e: ast.Expr) -> List[ast.Expr]:
    if isinstance(e, ast.Binary) and e.op.upper() == "AND":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _has_aggregate(e: Any) -> bool:
    """Any aggregate call anywhere in the expression subtree (nested
    queries included — conservative: callers give up to the host)."""
    if isinstance(e, ast.Func) and e.name.lower() in _AGG_FUNCS:
        return True
    if isinstance(e, ast.Node):
        return any(
            _has_aggregate(getattr(e, f)) for f in e._fields
        )
    if isinstance(e, (list, tuple)):
        return any(_has_aggregate(x) for x in e)
    return False


def _exists_form(c: ast.Expr) -> Optional[Tuple[ast.Query, bool]]:
    if isinstance(c, ast.Exists):
        return (c.query, False)
    if (
        isinstance(c, ast.Unary)
        and c.op.upper() == "NOT"
        and isinstance(c.operand, ast.Exists)
    ):
        return (c.operand.query, True)
    return None


def _decorrelate_exists(
    env: Dict[str, object],
    source: Plan,
    scope: _Scope,
    q: ast.Query,
    negated: bool,
) -> Plan:
    """The classic decorrelation: ``[NOT] EXISTS (SELECT ... WHERE
    inner.k = outer.k AND <inner-only residuals>)`` is exactly a device
    SEMI (resp. ANTI) join on the equality pairs — NULL outer keys never
    join, which matches EXISTS evaluating the correlation to NULL.
    Anything beyond equi-correlation + inner residuals gives up (the
    host runner owns the general case)."""
    if not isinstance(q, ast.Select) or q.from_ is None:
        raise _GiveUp()
    if (
        q.group_by
        or q.having is not None
        or q.distinct
        or q.order_by
        or q.limit is not None
        or q.offset is not None
    ):
        raise _GiveUp()
    if _has_aggregate(list(q.items)) or _has_aggregate(q.where):
        # a scalar-aggregate subquery ALWAYS returns one row, so EXISTS
        # is unconditionally true — not a semi join
        raise _GiveUp()
    inner_scope = _Scope()
    inner_src = _relation(env, q.from_, inner_scope)
    inner_scope.row_names = list(inner_src.sql_row_names)
    for item in q.items:  # EXISTS ignores items, but bad refs must fall
        if isinstance(item.expr, ast.Star):
            tbl = item.expr.table
            if tbl is not None and tbl.lower() not in inner_scope.relations:
                raise _GiveUp()  # unknown alias: the host raises it
            continue
        _expr(item.expr, inner_scope)

    def _bind(ref: ast.Col) -> Tuple[str, str]:
        # standard scoping: unqualified names prefer the INNER scope.
        # Only a name genuinely ABSENT from the inner scope may bind
        # outer — taint/ambiguity failures must not silently rebind
        #
        if ref.table is not None:
            if ref.table.lower() in inner_scope.relations:
                return (
                    "inner", inner_scope.resolve(ref.name, ref.table)
                )
            return ("outer", scope.resolve(ref.name, ref.table))
        hits = [
            n
            for n in inner_scope.row_names
            if n.lower() == ref.name.lower()
        ]
        if hits:
            return ("inner", inner_scope.resolve(ref.name, None))
        return ("outer", scope.resolve(ref.name, None))

    pairs: List[Tuple[str, str]] = []  # (outer name, inner name)
    residual: Optional[ColumnExpr] = None
    for cj in _split_conjuncts(q.where) if q.where is not None else []:
        if (
            isinstance(cj, ast.Binary)
            and cj.op == "="
            and isinstance(cj.left, ast.Col)
            and isinstance(cj.right, ast.Col)
        ):
            (ka, na), (kb, nb) = _bind(cj.left), _bind(cj.right)
            if {ka, kb} == {"inner", "outer"}:
                outer_n = na if ka == "outer" else nb
                inner_n = na if ka == "inner" else nb
                pairs.append((outer_n, inner_n))
                continue
            if ka == "outer":  # outer = outer: host handles
                raise _GiveUp()
        # anything else must be INNER-only (resolve raises otherwise)
        term = _expr(cj, inner_scope)
        residual = term if residual is None else (residual & term)
    if not pairs:
        raise _GiveUp()  # uncorrelated EXISTS: host owns it
    outer_names = [o for o, _ in pairs]
    if len({o.lower() for o in outer_names}) != len(outer_names):
        raise _GiveUp()
    sub = SelectPlan(
        inner_src,
        SelectColumns(*[col(i).alias(o) for o, i in pairs]),
        residual, None, [], None, None, False, list(outer_names),
    )
    return JoinPlan(
        source, sub, "anti" if negated else "semi", list(outer_names)
    )


_DEVICE_WINDOW_AGGS = {"sum", "count", "avg", "mean", "min", "max"}

# scalar functions the bridge forwards into the column algebra (device
# evaluation or the pandas evaluator; anything else is a host fallback)
_SCALAR_FN_NAMES = {
    "abs", "round", "floor", "ceil", "ceiling", "sqrt", "exp", "ln",
    "log", "log2", "log10", "sin", "cos", "tan", "sign", "power", "pow",
    "mod", "nullif", "if", "iif", "upper", "ucase", "lower", "lcase",
    "length", "len", "trim", "ltrim", "rtrim", "reverse", "substring",
    "substr", "concat", "replace",
}

# device frame/offset arithmetic runs in int32 sorted-space positions;
# anything larger stays on the host runner (which handles it exactly)
_DEVICE_OFFSET_MAX = 1 << 30


def _device_int(nv: object, lo: int = 0) -> bool:
    return (
        isinstance(nv, int)
        and not isinstance(nv, bool)
        and lo <= nv <= _DEVICE_OFFSET_MAX
    )


def _window_select(q: ast.Select, scope: _Scope, source: Plan) -> Plan:
    """SELECT with window items -> ``WindowPlan``. Shapes beyond the
    device set (expression arguments, exotic functions, oversized
    offsets) give up."""
    if q.group_by or q.having is not None or q.distinct:
        raise _GiveUp()
    items: List[Tuple[str, object]] = []
    out_names: List[str] = []
    for item in q.items:
        e = item.expr
        if isinstance(e, ast.Col):
            name = scope.resolve(e.name, e.table)
            out = item.alias or name
            items.append(("col", (out, name)))
            out_names.append(out)
            continue
        if not isinstance(e, ast.Window) or item.alias is None:
            raise _GiveUp()
        if e.func.distinct:
            raise _GiveUp()
        part: List[str] = []
        for pexpr in e.partition_by:
            if not isinstance(pexpr, ast.Col):
                raise _GiveUp()
            part.append(scope.resolve(pexpr.name, pexpr.table))
        order: List[Tuple[str, bool, Optional[bool]]] = []
        for o in e.order_by:
            if not isinstance(o.expr, ast.Col):
                raise _GiveUp()
            order.append(
                (
                    scope.resolve(o.expr.name, o.expr.table),
                    o.asc,
                    None if o.nulls is None else o.nulls == "FIRST",
                )
            )
        fn = e.func.name
        arg: Optional[str] = None
        param: Optional[int] = None
        default: Optional[object] = None
        # normalize the frame clause: None = the SQL default frame.
        # ROWS, GROUPS and single-key RANGE frames (incl. numeric
        # offsets) all lower to device; only oversized offsets and
        # multi-key RANGE stay on the host runner.
        frame: Optional[
            Tuple[str, str, Optional[float], str, Optional[float]]
        ]
        frame = None
        whole_partition = False
        fr = e.frame
        is_ranking = fn in (
            "row_number", "rank", "dense_rank", "percent_rank",
            "cume_dist", "ntile", "lag", "lead",
        )
        if fr is not None and not is_ranking:  # ranking ignores frames
            sk, sn = fr.start
            ek, en = fr.end
            if fr.unit == "groups" and not order:
                raise _GiveUp()  # the host runner owns this error
            if (sk, ek) == ("up", "uf"):
                whole_partition = True
            elif fr.unit == "range":
                if (sk, ek) == ("up", "c"):
                    pass  # the default running frame
                elif len(order) == 1:
                    # numeric RANGE offsets: one ORDER BY key required
                    for kd, nv in ((sk, sn), (ek, en)):
                        if kd in ("p", "f") and (
                            isinstance(nv, bool)
                            or not isinstance(nv, (int, float))
                            or not (0 <= nv <= _DEVICE_OFFSET_MAX)
                        ):
                            raise _GiveUp()  # host runner owns the error
                    frame = ("range", sk, sn, ek, en)
                else:
                    raise _GiveUp()
            elif fr.unit == "rows":
                for kd, nv in ((sk, sn), (ek, en)):
                    if kd in ("p", "f") and not _device_int(nv):
                        raise _GiveUp()  # host runner owns the error
                frame = ("rows", sk, sn, ek, en)
            else:  # groups
                for kd, nv in ((sk, sn), (ek, en)):
                    if kd in ("p", "f") and not _device_int(nv):
                        raise _GiveUp()  # host runner owns the error
                frame = ("groups", sk, sn, ek, en)
        if fn in ("row_number", "rank", "dense_rank", "percent_rank",
                  "cume_dist"):
            if not order or e.func.args:
                raise _GiveUp()
        elif fn == "ntile":
            if not order or len(e.func.args) != 1:
                raise _GiveUp()
            a0 = e.func.args[0]
            if not isinstance(a0, ast.Lit) or not _device_int(a0.value, 1):
                raise _GiveUp()  # host runner owns the error message
            param = a0.value
        elif fn in _DEVICE_WINDOW_AGGS:
            if len(e.func.args) != 1:
                raise _GiveUp()
            a = e.func.args[0]
            if isinstance(a, ast.Star):
                if fn != "count":
                    raise _GiveUp()
            elif isinstance(a, ast.Col):
                arg = scope.resolve(a.name, a.table)
            else:
                raise _GiveUp()
            if whole_partition or (not order and fr is None):
                # order-insensitive over the whole partition: the plain
                # segment aggregate
                order = []
                frame = None
            elif not order:
                raise _GiveUp()  # framed but unordered: host runner
        elif fn in ("first_value", "last_value", "nth_value"):
            nargs = 2 if fn == "nth_value" else 1
            if not order or len(e.func.args) != nargs:
                raise _GiveUp()
            a = e.func.args[0]
            if not isinstance(a, ast.Col):
                raise _GiveUp()
            arg = scope.resolve(a.name, a.table)
            if fn == "nth_value":
                a1 = e.func.args[1]
                if not isinstance(a1, ast.Lit) or not _device_int(
                    a1.value, 1
                ):
                    raise _GiveUp()
                param = a1.value
            if whole_partition:
                frame = ("rows", "up", None, "uf", None)
        elif fn in ("lag", "lead"):
            if not order or not (1 <= len(e.func.args) <= 3):
                raise _GiveUp()
            a = e.func.args[0]
            if not isinstance(a, ast.Col):
                raise _GiveUp()
            arg = scope.resolve(a.name, a.table)
            param = 1
            if len(e.func.args) >= 2:
                a1 = e.func.args[1]
                if not isinstance(a1, ast.Lit) or not _device_int(a1.value):
                    raise _GiveUp()
                param = a1.value
            if len(e.func.args) == 3:
                a2 = e.func.args[2]
                dv: object = None
                if isinstance(a2, ast.Lit):
                    dv = a2.value
                elif (
                    isinstance(a2, ast.Unary)
                    and a2.op == "-"
                    and isinstance(a2.operand, ast.Lit)
                    and isinstance(a2.operand.value, (int, float))
                    and not isinstance(a2.operand.value, bool)
                ):
                    dv = -a2.operand.value
                if dv is None or isinstance(dv, (str, bool)):
                    raise _GiveUp()  # non-numeric defaults: host runner
                default = dv
        else:
            raise _GiveUp()  # expression args / exotic funcs: host runner
        items.append(
            (
                "win",
                WindowSpec(
                    item.alias, fn, arg, part, order, param,
                    frame=frame, default=default,
                ),
            )
        )
        out_names.append(item.alias)
    lowered = [n.lower() for n in out_names]
    if len(set(lowered)) != len(lowered):
        raise _GiveUp()
    where = _expr(q.where, scope) if q.where is not None else None
    plan: Plan = WindowPlan(source, items, where, out_names)
    if q.order_by or q.limit is not None or q.offset is not None:
        order2 = _order_items(q.order_by, out_names)
        plan = SelectPlan(
            plan, None, None, None, order2, q.limit, q.offset, False,
            list(out_names),
        )
    return plan


def _order_items(
    items: List[ast.OrderItem],
    out_names: List[str],
) -> List[Tuple[str, bool, Optional[str]]]:
    """ORDER BY entries resolved against the SELECT's OUTPUT columns
    (unqualified references and 1-based positions only — expression and
    qualified sort keys stay on the host runner)."""
    out: List[Tuple[str, bool, Optional[str]]] = []
    for o in items:
        e = o.expr
        if (
            isinstance(e, ast.Lit)
            and isinstance(e.value, int)
            and not isinstance(e.value, bool)
            and 1 <= e.value <= len(out_names)
        ):
            name = out_names[e.value - 1]
        elif isinstance(e, ast.Col):
            if e.table is not None:
                # a QUALIFIED ref names the source column, which an output
                # alias of the same name may shadow with different values —
                # sorting by the output here would silently diverge from
                # SQL semantics, so the host runner keeps
                # this shape
                raise _GiveUp()
            if e.name in out_names:  # exact name wins, like the host
                name = e.name
            else:
                folded = [n for n in out_names if n.lower() == e.name.lower()]
                if len(folded) != 1:  # missing or case-ambiguous: host
                    raise _GiveUp()
                name = folded[0]
        else:
            raise _GiveUp()
        out.append((name, o.asc, o.nulls))
    return out


_BIN_OPS = {"=", "<>", "!=", "<", "<=", ">", ">=", "+", "-", "*", "/",
            "AND", "OR"}


def _expr(e: ast.Expr, scope: _Scope) -> ColumnExpr:
    if isinstance(e, ast.Lit):
        return null() if e.value is None else lit(e.value)
    if isinstance(e, ast.Col):
        return col(scope.resolve(e.name, e.table))
    if isinstance(e, ast.Unary):
        op = e.op.upper()
        v = _expr(e.operand, scope)
        if op == "-":
            return -v
        if op == "+":
            return v
        if op == "NOT":
            return ~v
        raise _GiveUp()
    if isinstance(e, ast.Binary):
        op = e.op.upper()
        if op == "%":
            return function(
                "mod", _expr(e.left, scope), _expr(e.right, scope)
            )
        if op not in _BIN_OPS:
            raise _GiveUp()
        lv, rv = _expr(e.left, scope), _expr(e.right, scope)
        return {
            "=": lambda: lv == rv,
            "<>": lambda: lv != rv,
            "!=": lambda: lv != rv,
            "<": lambda: lv < rv,
            "<=": lambda: lv <= rv,
            ">": lambda: lv > rv,
            ">=": lambda: lv >= rv,
            "+": lambda: lv + rv,
            "-": lambda: lv - rv,
            "*": lambda: lv * rv,
            "/": lambda: lv / rv,
            "AND": lambda: lv & rv,
            "OR": lambda: lv | rv,
        }[op]()
    if isinstance(e, ast.Func):
        name = e.name.lower()
        if e.distinct and name not in _AGG_FUNCS:
            raise _GiveUp()
        if name in _AGG_FUNCS:
            if len(e.args) != 1:
                raise _GiveUp()
            a = e.args[0]
            arg = col("*") if isinstance(a, ast.Star) else _expr(a, scope)
            if name == "mean":
                name = "avg"
            if e.distinct:
                if isinstance(a, ast.Star):
                    raise _GiveUp()  # COUNT(DISTINCT *): host owns error
                return _agg(name, arg, arg_distinct=True)
            if not hasattr(ff, name):  # variance family etc.
                return _agg(name, arg)
            # the ff constructors mark is_aggregation (function() does not)
            return getattr(ff, name)(arg)
        if name == "coalesce":
            return ff.coalesce(*[_expr(a, scope) for a in e.args])
        if name in _SCALAR_FN_NAMES:
            return function(name, *[_expr(a, scope) for a in e.args])
        raise _GiveUp()
    if isinstance(e, ast.Cast):
        return _expr(e.operand, scope).cast(e.type_name)
    if isinstance(e, ast.IsNull):
        v = _expr(e.operand, scope)
        return v.not_null() if e.negated else v.is_null()
    if isinstance(e, ast.Between):
        v = _expr(e.operand, scope)
        res = (v >= _expr(e.low, scope)) & (v <= _expr(e.high, scope))
        return ~res if e.negated else res
    if isinstance(e, ast.InList):
        v = _expr(e.operand, scope)
        res: Optional[ColumnExpr] = None
        for item in e.items:
            term = v == _expr(item, scope)
            res = term if res is None else (res | term)
        if res is None:
            raise _GiveUp()
        return ~res if e.negated else res
    if isinstance(e, ast.Like):
        if isinstance(e.pattern, ast.Lit) and isinstance(
            e.pattern.value, str
        ):
            return ff.like(
                _expr(e.operand, scope), e.pattern.value, negated=e.negated
            )
        # dynamic (column-valued) pattern: engine-interpreted LIKE over
        # two expressions — on device a (value-dict x pattern-dict) LUT
        return function(
            "like",
            _expr(e.operand, scope),
            _expr(e.pattern, scope),
            lit(bool(e.negated)),
        )
    if isinstance(e, ast.Case):
        args: List[ColumnExpr] = []
        operand = (
            None if e.operand is None else _expr(e.operand, scope)
        )
        for cond, val in e.whens:
            c = _expr(cond, scope)
            if operand is not None:
                c = operand == c
            args.append(c)
            args.append(_expr(val, scope))
        args.append(
            null() if e.default is None else _expr(e.default, scope)
        )
        return ff.case_when(*args)
    raise _GiveUp()  # subqueries / windows
