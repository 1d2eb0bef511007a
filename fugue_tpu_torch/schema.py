"""Schema: an ordered column schema backed by pyarrow, parsed from the
compact expression syntax ``"k:int,v2:float"``.

A trimmed copy of ``fugue_tpu/schema.py:206`` (``Schema``) holding what the
port's slice uses: flat fields of the simple types (``int`` is int32,
``long`` int64, ``float`` float32, ``double`` float64, ``datetime`` a
microsecond timestamp), ``names``/``fields``/``pa_schema``/``extract``.
Nested types are not parsed here.
"""

import re
from typing import Any, Dict, Iterable, List, Union

import pyarrow as pa

from fugue_tpu_torch.utils.assertion import assert_or_throw

_SIMPLE_TYPES: Dict[str, pa.DataType] = {
    "null": pa.null(),
    "bool": pa.bool_(),
    "boolean": pa.bool_(),
    "int8": pa.int8(),
    "byte": pa.int8(),
    "int16": pa.int16(),
    "short": pa.int16(),
    "int32": pa.int32(),
    "int": pa.int32(),
    "int64": pa.int64(),
    "long": pa.int64(),
    "uint8": pa.uint8(),
    "ubyte": pa.uint8(),
    "uint16": pa.uint16(),
    "ushort": pa.uint16(),
    "uint32": pa.uint32(),
    "uint": pa.uint32(),
    "uint64": pa.uint64(),
    "ulong": pa.uint64(),
    "float16": pa.float16(),
    "float32": pa.float32(),
    "float": pa.float32(),
    "float64": pa.float64(),
    "double": pa.float64(),
    "string": pa.string(),
    "str": pa.string(),
    "binary": pa.binary(),
    "bytes": pa.binary(),
    "date": pa.date32(),
    "datetime": pa.timestamp("us"),
    "timestamp": pa.timestamp("us"),
}

# canonical (shortest, unambiguous) names for to-string conversion
_TYPE_TO_NAME: Dict[pa.DataType, str] = {
    pa.null(): "null",
    pa.bool_(): "bool",
    pa.int8(): "int8",
    pa.int16(): "int16",
    pa.int32(): "int",
    pa.int64(): "long",
    pa.uint8(): "uint8",
    pa.uint16(): "uint16",
    pa.uint32(): "uint32",
    pa.uint64(): "uint64",
    pa.float16(): "float16",
    pa.float32(): "float",
    pa.float64(): "double",
    pa.string(): "str",
    pa.binary(): "bytes",
    pa.date32(): "date",
}

_NAME_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def type_to_expr(tp: pa.DataType) -> str:
    """Canonical string name of a pyarrow type."""
    if tp in _TYPE_TO_NAME:
        return _TYPE_TO_NAME[tp]
    if pa.types.is_timestamp(tp) and tp.tz is None and tp.unit == "us":
        return "datetime"
    return str(tp)


def _parse_fields(expr: str) -> List[pa.Field]:
    fields: List[pa.Field] = []
    for part in expr.split(","):
        assert_or_throw(
            ":" in part, ValueError(f"invalid schema expression {expr!r}")
        )
        name, tp = (x.strip() for x in part.split(":", 1))
        if name.startswith("`") and name.endswith("`") and len(name) > 1:
            name = name[1:-1]
        else:
            assert_or_throw(
                _NAME_RE.fullmatch(name) is not None,
                ValueError(f"invalid column name {name!r} in {expr!r}"),
            )
        assert_or_throw(
            tp.lower() in _SIMPLE_TYPES,
            ValueError(f"unknown type {tp!r} in {expr!r}"),
        )
        fields.append(pa.field(name, _SIMPLE_TYPES[tp.lower()]))
    return fields


class Schema:
    """Ordered column schema. Construct from expression strings, pyarrow
    schemas/fields, other Schemas, ``(name, type)`` tuples, or lists of
    those: ``Schema("k:int", ("s", pa.float32()))``."""

    def __init__(self, *args: Any):
        self._fields: Dict[str, pa.Field] = {}
        for a in args:
            self._append(a)

    def _append(self, obj: Any) -> None:
        if obj is None:
            return
        if isinstance(obj, str):
            if obj.strip() != "":
                for f in _parse_fields(obj):
                    self._append_field(f)
        elif isinstance(obj, Schema):
            for f in obj.fields:
                self._append_field(f)
        elif isinstance(obj, pa.Schema):
            for f in obj:
                self._append_field(f)
        elif isinstance(obj, pa.Field):
            self._append_field(obj)
        elif isinstance(obj, tuple) and len(obj) == 2:
            tp = obj[1]
            if isinstance(tp, str):
                tp = _SIMPLE_TYPES[tp.lower()]
            self._append_field(pa.field(obj[0], tp))
        elif isinstance(obj, Iterable):
            for x in obj:
                self._append(x)
        else:
            raise ValueError(f"can't build schema from {obj!r}")

    def _append_field(self, f: pa.Field) -> None:
        assert_or_throw(
            isinstance(f.name, str) and f.name != "",
            ValueError(f"invalid field name {f.name!r}"),
        )
        assert_or_throw(
            f.name not in self._fields,
            KeyError(f"duplicated field name {f.name}"),
        )
        tp = f.type
        if pa.types.is_large_string(tp):
            tp = pa.string()
        elif pa.types.is_large_binary(tp):
            tp = pa.binary()
        self._fields[f.name] = pa.field(f.name, tp)

    @property
    def names(self) -> List[str]:
        return list(self._fields.keys())

    @property
    def fields(self) -> List[pa.Field]:
        return list(self._fields.values())

    @property
    def pa_schema(self) -> pa.Schema:
        return pa.schema(self.fields)

    def __contains__(self, key: Any) -> bool:
        return isinstance(key, str) and key in self._fields

    def __getitem__(self, key: Union[str, int]) -> pa.Field:
        if isinstance(key, int):
            return self.fields[key]
        return self._fields[key]

    def extract(self, names: Union[str, List[str]]) -> "Schema":
        """The named subset, in the requested order."""
        if isinstance(names, str):
            names = [names]
        for n in names:
            assert_or_throw(n in self._fields, KeyError(f"{n} not in {self}"))
        return Schema([self._fields[n] for n in names])

    def intersect(self, names: Iterable[str]) -> "Schema":
        """The fields whose names are in ``names``, in this schema's order
        (``fugue_tpu/schema.py:374``, for names)."""
        keep = set(names)
        return Schema([f for f in self.fields if f.name in keep])

    def __add__(self, other: Any) -> "Schema":
        """Both schemas' fields, this one's first; a repeated name raises
        (``fugue_tpu/schema.py:353``)."""
        return Schema(self, other)

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Schema):
            try:
                other = Schema(other)
            except (ValueError, KeyError, TypeError):
                return False
        return self.names == other.names and all(
            a.type == b.type for a, b in zip(self.fields, other.fields)
        )

    def __hash__(self) -> int:
        return hash(str(self))

    def __str__(self) -> str:
        return ",".join(
            f"{n if _NAME_RE.fullmatch(n) else f'`{n}`'}:{type_to_expr(f.type)}"
            for n, f in self._fields.items()
        )

    def __repr__(self) -> str:
        return str(self)

