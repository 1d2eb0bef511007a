"""``PartitionSpec``: the partition keys, algorithm, partition count and
presort of a map, an aggregate, a take or a repartition.

A trimmed copy of ``fugue_tpu/collections/partition.py``: the ``by``
keys, ``algo`` (``default``, ``hash``, ``rand``, ``even``, ``coarse``),
the ``num`` expression with its ``ROWCOUNT``/``CONCURRENCY`` keywords
(``get_num_partitions``, ``:149-180``) and the ``presort``
(``parse_presort_exp``, ``:25``).
"""

import json
import re
from typing import Any, Callable, Dict, Iterable, List

from fugue_tpu_torch.utils.assertion import assert_or_throw

KEYWORD_ROWCOUNT = "ROWCOUNT"
KEYWORD_CONCURRENCY = "CONCURRENCY"

_ALGOS = {"", "default", "hash", "rand", "even", "coarse"}
_NUM_EXPR_RE = re.compile(r"^[0-9+\-*/() %]*$")


def parse_presort_exp(presort: Any) -> Dict[str, bool]:
    """``"a asc, b desc"``, a dict or a list of names and ``(name, asc)``
    pairs as an ordered ``{column: ascending}`` mapping (``:25``)."""
    if presort is None:
        return {}
    if isinstance(presort, dict):
        for v in presort.values():
            assert_or_throw(isinstance(v, bool), ValueError("presort value must be bool"))
        return dict(presort)
    if isinstance(presort, str):
        res: Dict[str, bool] = {}
        for part in presort.split(","):
            part = part.strip()
            if part == "":
                continue
            m = re.match(r"^([^\s]+|`[^`]+`)(\s+(asc|desc))?$", part, re.IGNORECASE)
            assert_or_throw(m is not None, SyntaxError(f"invalid presort {part!r}"))
            name = m.group(1).strip("`")  # type: ignore[union-attr]
            asc = m.group(3) is None or m.group(3).lower() == "asc"  # type: ignore[union-attr]
            assert_or_throw(name not in res, SyntaxError(f"duplicated presort key {name}"))
            res[name] = asc
        return res
    if isinstance(presort, Iterable):
        res = {}
        for item in presort:
            if isinstance(item, str):
                res[item] = True
            else:
                res[item[0]] = bool(item[1])
        return res
    raise SyntaxError(f"invalid presort {presort!r}")


class PartitionSpec:
    """``PartitionSpec(by=["k"])``, ``PartitionSpec(["k"])``,
    ``PartitionSpec("k")``, ``PartitionSpec("hash", num=8, by="k")``,
    ``PartitionSpec(by="k", presort="v desc")``, ``PartitionSpec(4)`` or a
    copy of another spec (``:58``). A string is an algorithm name, a
    ``num`` expression (digits and the two keywords) or a key."""

    def __init__(self, *args: Any, **kwargs: Any):
        self._algo = ""
        self._num_partitions = "0"
        self._partition_by: List[str] = []
        self._presort: Dict[str, bool] = {}
        for a in args:
            self._update(a)
        if kwargs:
            self._update(kwargs)

    def _update(self, obj: Any) -> None:
        if obj is None:
            return
        if isinstance(obj, PartitionSpec):
            self._algo = obj._algo or self._algo
            if obj._num_partitions != "0":
                self._num_partitions = obj._num_partitions
            if obj._partition_by:
                self._partition_by = list(obj._partition_by)
            if obj._presort:
                self._presort = dict(obj._presort)
        elif isinstance(obj, bool):
            raise SyntaxError(f"can't interpret partition spec {obj!r}")
        elif isinstance(obj, int):
            self._num_partitions = str(obj)
        elif isinstance(obj, str):
            s = obj.strip()
            if s == "":
                return
            if s.lower() in _ALGOS:
                self._algo = "" if s.lower() == "default" else s.lower()
            elif s.startswith("{"):
                self._update(json.loads(s))
            elif _NUM_EXPR_RE.match(s) or KEYWORD_ROWCOUNT in s or KEYWORD_CONCURRENCY in s:
                self._num_partitions = s
            else:
                self._update(dict(by=[s]))
        elif isinstance(obj, (list, tuple)):
            self._update(dict(by=list(obj)))
        elif isinstance(obj, dict):
            for k, v in obj.items():
                if k == "algo":
                    v = str(v).lower()
                    assert_or_throw(v in _ALGOS, ValueError(f"invalid algo {v}"))
                    self._algo = "" if v == "default" else v
                elif k in ("num", "num_partitions"):
                    self._num_partitions = str(v)
                elif k in ("by", "partition_by"):
                    v = [v] if isinstance(v, str) else list(v)
                    assert_or_throw(
                        len(set(v)) == len(v),
                        SyntaxError(f"duplicated keys in {v}"),
                    )
                    self._partition_by = v
                elif k == "presort":
                    self._presort = parse_presort_exp(v)
                else:
                    raise SyntaxError(f"unknown partition spec key {k}")
        else:
            raise SyntaxError(f"can't interpret partition spec {obj!r}")

    @property
    def empty(self) -> bool:
        return (self._algo == "" and self._num_partitions == "0"
                and len(self._partition_by) == 0 and len(self._presort) == 0)

    @property
    def algo(self) -> str:
        return self._algo

    @property
    def num_partitions(self) -> str:
        return self._num_partitions

    @property
    def partition_by(self) -> List[str]:
        return list(self._partition_by)

    @property
    def presort(self) -> Dict[str, bool]:
        return dict(self._presort)

    def get_num_partitions(self, **expr_map_funcs: Callable[[], Any]) -> int:
        """The ``num`` expression evaluated (``:160``); a keyword's callable
        (``ROWCOUNT``, ``CONCURRENCY``) is called only where the expression
        names it."""
        expr = self._num_partitions
        env: Dict[str, Any] = {"__builtins__": {}, "min": min, "max": max}
        for k, f in expr_map_funcs.items():
            if k in expr:
                env[k] = int(f())
        stripped = expr
        for k in env:
            stripped = stripped.replace(k, "")
        assert_or_throw(
            _NUM_EXPR_RE.match(stripped.replace(",", "")) is not None,
            ValueError(f"invalid num expression {expr!r}"),
        )
        try:
            return int(eval(expr, env))  # noqa: S307 - validated charset
        except Exception as e:
            raise ValueError(f"can't evaluate num expression {expr!r}") from e

    def __repr__(self) -> str:
        return (f"PartitionSpec(algo={self._algo!r}, num={self._num_partitions!r}, "
                f"by={self._partition_by}, presort={self._presort})")
