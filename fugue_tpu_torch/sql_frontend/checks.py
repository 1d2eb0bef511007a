"""The checks that tell an invalid SELECT from one the port has not
ported: names resolved against the inputs' schemas, and the literal
arguments and frames of window functions, each raising the
``SQLExecutionError`` of the JAX package's host SELECT runner with its
message (``fugue_tpu/sql_frontend/select_runner.py``: ``column not
found`` ``:153``, ``table not found`` ``:191``, the ranking functions'
ORDER BY ``:1273-1286``, NTILE ``:1289-1297``, LAG/LEAD ``:1316-1331``,
RANGE offsets ``:1622-1636``).

The engine asks ``check_statement`` only where it would refuse a
statement: the algebra bridge does not lower it, or a device plan
declines it. A statement that passes is then refused as not ported. The
checks are kept on the safe side: a name they cannot see into (the
unaliased computed column of a subquery or CTE) resolves to anything, and
an ORDER BY, GROUP BY or HAVING name may be a select item's alias."""

from typing import Dict, List, Optional, Tuple

import pyarrow as pa

from fugue_tpu_torch.exceptions import SQLExecutionError
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.sql_frontend import ast

# (name, qualifier in lower case, type where known)
_Entry = Tuple[str, Optional[str], Optional[pa.DataType]]
_RANKING = ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist", "ntile",
            "lag", "lead")


class _Columns:
    """A relation's columns; ``open`` where some of them have no name the
    checks can know, so that any name may resolve."""

    def __init__(self, entries: List[_Entry], open_: bool = False):
        self.entries = entries
        self.open = open_


class _Scope:
    """The columns a SELECT's expressions see, and the enclosing
    SELECT's for a correlated subquery; ``aliases`` are the select items'
    names, which ORDER BY, GROUP BY and HAVING may use."""

    def __init__(self, cols: _Columns, parent: Optional["_Scope"] = None):
        self.cols = cols
        self.parent = parent
        self.aliases: List[str] = []

    def find(self, name: str, qual: Optional[str]) -> Optional[_Entry]:
        q = None if qual is None else qual.lower()
        for match in (lambda e: e[0] == name, lambda e: e[0].lower() == name.lower()):
            cands = [e for e in self.cols.entries if match(e) and (q is None or e[1] == q)]
            if cands:
                return cands[0]
        return None

    def resolves(self, name: str, qual: Optional[str]) -> bool:
        scope: Optional[_Scope] = self
        while scope is not None:
            if scope.cols.open or scope.find(name, qual) is not None:
                return True
            scope = scope.parent
        return False


def check_statement(q: ast.Query, schemas: Dict[str, Schema]) -> None:
    """Raise ``SQLExecutionError`` where ``q`` is invalid over the frames
    of ``schemas`` (by the names the statement uses)."""
    env = {name.lower(): _Columns([(f.name, None, f.type) for f in s.fields])
           for name, s in schemas.items()}
    _query(q, env, None)


def _query(q: ast.Query, env: Dict[str, _Columns], parent: Optional[_Scope]) -> _Columns:
    if isinstance(q, ast.With):
        scoped = dict(env)
        for name, sub in q.ctes:
            scoped[name.lower()] = _query(sub, scoped, parent)
        return _query(q.body, scoped, parent)
    if isinstance(q, ast.SetOp):
        left = _query(q.left, env, parent)
        _query(q.right, env, parent)
        return left
    assert isinstance(q, ast.Select)
    return _select(q, env, parent)


def _relation(rel: ast.Relation, env: Dict[str, _Columns], parent: Optional[_Scope]
              ) -> _Columns:
    if isinstance(rel, ast.TableRef):
        t = env.get(rel.name.lower())
        if t is None:
            raise SQLExecutionError(f"table not found: {rel.name}")
        qual = (rel.alias or rel.name).lower()
        return _Columns([(n, qual, tp) for n, _, tp in t.entries], t.open)
    if isinstance(rel, ast.SubqueryRef):
        sub = _query(rel.query, env, parent)
        qual = rel.alias.lower()
        return _Columns([(n, qual, tp) for n, _, tp in sub.entries], sub.open)
    assert isinstance(rel, ast.JoinRel)
    left, right = _relation(rel.left, env, parent), _relation(rel.right, env, parent)
    joined = _Columns(left.entries + right.entries, left.open or right.open)
    if rel.on is not None:
        _expr(rel.on, _Scope(joined, parent), env)
    return joined


def _select(q: ast.Select, env: Dict[str, _Columns], parent: Optional[_Scope]) -> _Columns:
    cols = _relation(q.from_, env, parent) if q.from_ is not None else _Columns([])
    scope = _Scope(cols, parent)
    scope.aliases = [i.alias for i in q.items if i.alias]
    out: List[_Entry] = []
    open_ = False
    for item in q.items:
        e = item.expr
        if isinstance(e, ast.Star):
            q_ = None if e.table is None else e.table.lower()
            out += [(n, None, tp) for n, qual, tp in cols.entries if q_ is None or qual == q_]
            open_ = open_ or cols.open
            continue
        _expr(e, scope, env)
        if item.alias:
            out.append((item.alias, None, None))
        elif isinstance(e, ast.Col):
            found = scope.find(e.name, e.table)
            out.append((e.name, None, None if found is None else found[2]))
        else:
            open_ = True  # a generated name
    if q.where is not None:
        _expr(q.where, scope, env)
    for g in q.group_by:
        _expr(g, scope, env, aliases=True)
    if q.having is not None:
        _expr(q.having, scope, env, aliases=True)
    for o in q.order_by:
        _expr(o.expr, scope, env, aliases=True)
    return _Columns(out, open_)


def _expr(e: ast.Expr, scope: _Scope, env: Dict[str, _Columns], aliases: bool = False) -> None:
    """Resolves every column of ``e`` (a select item's alias too where
    ``aliases``) and checks its window functions."""
    if isinstance(e, ast.Col):
        if aliases and e.table is None and e.name in scope.aliases:
            return
        if not scope.resolves(e.name, e.table):
            name = e.name if e.table is None else f"{e.table}.{e.name}"
            raise SQLExecutionError(f"column not found: {name}")
        return
    if isinstance(e, (ast.Lit, ast.Star)):
        return
    if isinstance(e, ast.Window):
        _window(e, scope, env)
        return
    if isinstance(e, (ast.ScalarSubquery, ast.Exists)):
        _query(e.query, env, scope)
        return
    if isinstance(e, ast.InSubquery):
        _expr(e.operand, scope, env, aliases)
        _query(e.query, env, scope)
        return
    for f in e._fields:
        v = getattr(e, f)
        for sub in v if isinstance(v, list) else [v]:
            for x in sub if isinstance(sub, tuple) else (sub,):
                if isinstance(x, ast.Expr):
                    _expr(x, scope, env, aliases)


def _literal(e: ast.Expr) -> Tuple[bool, object]:
    """``(True, value)`` of a literal or a negated numeric literal
    (``select_runner.py:1146``), else ``(False, None)``."""
    if isinstance(e, ast.Lit):
        return True, e.value
    if (isinstance(e, ast.Unary) and e.op == "-" and isinstance(e.operand, ast.Lit)
            and isinstance(e.operand.value, (int, float))
            and not isinstance(e.operand.value, bool)):
        return True, -e.operand.value
    return False, None


def _is_int(v: object) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _window(e: ast.Window, scope: _Scope, env: Dict[str, _Columns]) -> None:
    """``_eval_window``'s checks, in its order: the PARTITION BY and ORDER
    BY keys, the ranking functions' ORDER BY and literal arguments, the
    arguments, then a RANGE frame's offsets."""
    for p in e.partition_by:
        _expr(p, scope, env)
    for o in e.order_by:
        _expr(o.expr, scope, env)
    name, args = e.func.name, e.func.args
    if name in ("row_number", "rank", "dense_rank", "ntile", "percent_rank", "cume_dist"):
        if not e.order_by:
            raise SQLExecutionError(f"{name}() requires ORDER BY")
    if name == "ntile":
        if len(args) != 1:
            raise SQLExecutionError("ntile takes one int argument")
        ok, v = _literal(args[0])
        if not ok or not _is_int(v) or v < 1:  # type: ignore[operator]
            raise SQLExecutionError("ntile argument must be a positive int literal")
    if name in ("lag", "lead"):
        if not 1 <= len(args) <= 3 or isinstance(args[0], ast.Star):
            raise SQLExecutionError(f"{name} takes (expr[, offset[, default]])")
        offset: object = 1
        if len(args) >= 2:
            ok, offset = _literal(args[1])
            if not ok or not _is_int(offset):
                raise SQLExecutionError(f"{name} offset must be an int literal")
        if len(args) == 3 and not _literal(args[2])[0]:
            raise SQLExecutionError(f"{name} default must be a literal")
        if offset < 0:  # type: ignore[operator]
            raise SQLExecutionError(f"{name} offset must be >= 0")
    for a in args:
        _expr(a, scope, env)
    frame = e.frame
    if (frame is None or frame.unit != "range" or name in _RANKING
            or not any(b[0] in ("p", "f") for b in (frame.start, frame.end))):
        return
    if len(e.order_by) != 1:
        raise SQLExecutionError(
            "RANGE frames with offsets require exactly one ORDER BY expression")
    key = e.order_by[0].expr
    if isinstance(key, ast.Col):
        found = scope.find(key.name, key.table)
        tp = None if found is None else found[2]
        if tp is not None and not (pa.types.is_integer(tp) or pa.types.is_floating(tp)
                                   or pa.types.is_boolean(tp)):
            raise SQLExecutionError("RANGE frame offsets require a numeric ORDER BY key")
