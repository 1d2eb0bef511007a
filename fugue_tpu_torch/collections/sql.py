"""Dialect-tagged SQL fragments with dataframe-name placeholders: a trimmed
copy of ``fugue_tpu/collections/sql.py`` (``interleave_sql`` ``:25``,
``TempTableName`` ``:51``, ``StructuredRawSQL`` ``:72``). The JAX package
transpiles between dialects through a plugin whose default is the
identity; the port has no transpiler, so ``construct`` renders the text
as it is."""

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple
from uuid import uuid4


def _is_dataframe_like(obj: Any) -> bool:
    """A ``TorchDataFrame``, pandas or pyarrow input."""
    from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame

    if isinstance(obj, TorchDataFrame):
        return True
    mod = type(obj).__module__ or ""
    return mod.startswith("pandas") or mod.startswith("pyarrow")


def interleave_sql(statements: Any) -> Tuple[List[Tuple[bool, str]], Dict[str, Any]]:
    """String fragments and dataframes mixed into ``StructuredRawSQL``
    parts and a ``{temp name: dataframe}`` map (the ``raw_sql("SELECT ...
    FROM", df)`` form). Anything but a fragment or a dataframe raises."""
    parts: List[Tuple[bool, str]] = []
    dfs: Dict[str, Any] = {}
    for s in statements:
        if isinstance(s, str):
            parts.append((False, s))
        else:
            if not _is_dataframe_like(s):
                raise ValueError(
                    f"cannot interleave {type(s).__name__} into SQL; "
                    "only SQL fragments (str) and dataframes are accepted"
                )
            t = TempTableName()
            dfs[t.key] = s
            parts.append((True, t.key))
        parts.append((False, " "))
    return parts, dfs


class TempTableName:
    """A unique placeholder name for a dataframe inside a raw SQL string."""

    _PREFIX = "_fugue_tpu_tmp_"

    def __init__(self) -> None:
        self.key = self._PREFIX + str(uuid4())[:8]

    def __repr__(self) -> str:
        return "<tmpdf:" + self.key + ">"


class StructuredRawSQL:
    """A sequence of ``(is_dataframe, text)`` parts; dataframe parts name
    their dataframes and are mapped at ``construct`` time."""

    def __init__(self, statements: Iterable[Tuple[bool, str]], dialect: Optional[str] = None):
        self._statements = list(statements)
        self._dialect = dialect

    @property
    def dialect(self) -> Optional[str]:
        return self._dialect

    def construct(self, name_map: Any = None, dialect: Optional[str] = None) -> str:
        """The SQL text, each dataframe name mapped through ``name_map`` (a
        dict or a callable). ``dialect`` is accepted for the JAX package's
        signature; with no transpiler the text is returned as it is."""
        if name_map is None:
            _map: Callable[[str], str] = lambda x: x  # noqa: E731
        elif isinstance(name_map, dict):
            _map = lambda x: name_map.get(x, x)  # noqa: E731
        else:
            _map = name_map
        return "".join(_map(text) if is_df else text for is_df, text in self._statements)
