"""Schema: an ordered column schema backed by pyarrow, parsed from the
compact expression syntax ``"k:int,v2:float,l:[int],s:{x:int},m:<str,int>"``.

A trimmed copy of ``fugue_tpu/schema.py:206`` (``Schema``) holding what the
port uses: the simple types (``int`` is int32, ``long`` int64, ``float``
float32, ``double`` float64, ``datetime`` a microsecond timestamp), ``[T]``
lists, ``{a:T,...}`` structs, ``<K,V>`` maps, ``decimal(p,s)`` and
``timestamp(unit[,tz])`` (``_parse_type``, ``:142``), and
``names``/``fields``/``pa_schema``/``extract``/``exclude``/``rename``/
``alter``.
"""

import re
from typing import Any, Dict, Iterable, List, Tuple, Union

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
    """Canonical string name of a pyarrow type, the inverse of
    ``parse_type`` (``fugue_tpu/schema.py:98``)."""
    if tp in _TYPE_TO_NAME:
        return _TYPE_TO_NAME[tp]
    if pa.types.is_timestamp(tp):
        if tp.tz is None and tp.unit == "us":
            return "datetime"
        tz = f",{tp.tz}" if tp.tz is not None else ""
        return f"timestamp({tp.unit}{tz})"
    if pa.types.is_decimal(tp):
        return f"decimal({tp.precision},{tp.scale})"
    if pa.types.is_list(tp) or pa.types.is_large_list(tp):
        return f"[{type_to_expr(tp.value_type)}]"
    if pa.types.is_map(tp):
        return f"<{type_to_expr(tp.key_type)},{type_to_expr(tp.item_type)}>"
    if pa.types.is_struct(tp):
        return "{" + ",".join(f"{f.name}:{type_to_expr(f.type)}" for f in tp) + "}"
    return str(tp)


def parse_type(expr: str) -> pa.DataType:
    """One type expression as a pyarrow type (``fugue_tpu/schema.py:90``)."""
    tp, pos = _parse_type(expr, 0)
    assert_or_throw(expr[pos:].strip() == "", ValueError(f"invalid type expression {expr!r}"))
    return tp


def _skip_ws(s: str, pos: int) -> int:
    while pos < len(s) and s[pos].isspace():
        pos += 1
    return pos


def _parse_name(s: str, pos: int) -> Tuple[str, int]:
    pos = _skip_ws(s, pos)
    if pos < len(s) and s[pos] == "`":
        end = s.find("`", pos + 1)
        assert_or_throw(end > pos, ValueError(f"unclosed backquote in {s.rstrip(chr(0))!r}"))
        return s[pos + 1:end], end + 1
    m = _NAME_RE.match(s, pos)
    assert_or_throw(m is not None, ValueError(f"invalid name at {s[pos:].rstrip(chr(0))!r}"))
    return m.group(0), m.end()  # type: ignore[union-attr]


def _parse_type(s: str, pos: int) -> Tuple[pa.DataType, int]:
    """A type from ``s[pos:]`` (``fugue_tpu/schema.py:142``): ``[T]`` a
    list, ``<K,V>`` a map, ``{a:T,...}`` a struct, ``decimal(p,s)``,
    ``timestamp(unit[,tz])`` or a simple name."""
    pos = _skip_ws(s, pos)
    assert_or_throw(pos < len(s), ValueError(f"empty type expression in {s.rstrip(chr(0))!r}"))
    ch = s[pos]
    if ch == "[":
        inner, pos = _parse_type(s, pos + 1)
        pos = _skip_ws(s, pos)
        assert_or_throw(pos < len(s) and s[pos] == "]",
                        ValueError(f"expect ] in {s.rstrip(chr(0))!r}"))
        return pa.list_(inner), pos + 1
    if ch == "<":
        ktype, pos = _parse_type(s, pos + 1)
        pos = _skip_ws(s, pos)
        assert_or_throw(pos < len(s) and s[pos] == ",",
                        ValueError(f"expect , in map {s.rstrip(chr(0))!r}"))
        vtype, pos = _parse_type(s, pos + 1)
        pos = _skip_ws(s, pos)
        assert_or_throw(pos < len(s) and s[pos] == ">",
                        ValueError(f"expect > in {s.rstrip(chr(0))!r}"))
        return pa.map_(ktype, vtype), pos + 1
    if ch == "{":
        fields, pos = _parse_fields(s, pos + 1, "}")
        return pa.struct(fields), pos
    m = _NAME_RE.match(s, pos)
    assert_or_throw(m is not None, ValueError(f"invalid type at {s[pos:].rstrip(chr(0))!r}"))
    name = m.group(0).lower()  # type: ignore[union-attr]
    pos = m.end()  # type: ignore[union-attr]
    if name in ("decimal", "timestamp"):
        at = _skip_ws(s, pos)
        if at < len(s) and s[at] == "(":
            end = s.find(")", at)
            assert_or_throw(end > 0, ValueError(f"{name} needs a closing )"))
            parts = [p.strip() for p in s[at + 1:end].split(",")]
            if name == "decimal":
                return pa.decimal128(int(parts[0]), int(parts[1]) if len(parts) > 1 else 0), \
                    end + 1
            return pa.timestamp(parts[0], parts[1] if len(parts) > 1 else None), end + 1
        assert_or_throw(name == "timestamp", ValueError("decimal needs (p,s)"))
    assert_or_throw(name in _SIMPLE_TYPES, ValueError(f"unknown type {name!r} in {s!r}"))
    return _SIMPLE_TYPES[name], pos


def _parse_fields(s: str, pos: int, closing: str) -> Tuple[List[pa.Field], int]:
    """``name:type`` fields up to ``closing`` (``fugue_tpu/schema.py:189``)."""
    fields: List[pa.Field] = []
    while True:
        pos = _skip_ws(s, pos)
        assert_or_throw(pos < len(s), ValueError(f"unclosed struct in {s.rstrip(chr(0))!r}"))
        if s[pos] == closing:
            return fields, pos + 1
        name, pos = _parse_name(s, pos)
        pos = _skip_ws(s, pos)
        assert_or_throw(pos < len(s) and s[pos] == ":",
                        ValueError(f"invalid schema expression {s.rstrip(chr(0))!r}"))
        tp, pos = _parse_type(s, pos + 1)
        fields.append(pa.field(name, tp))
        pos = _skip_ws(s, pos)
        if pos < len(s) and s[pos] == ",":
            pos += 1
        else:
            assert_or_throw(pos < len(s) and s[pos] == closing,
                            ValueError(f"invalid schema expression {s.rstrip(chr(0))!r}"))


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
                for f in _parse_fields(obj.strip() + "\0", 0, "\0")[0]:
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
                tp = parse_type(tp)
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
    def types(self) -> List[pa.DataType]:
        return [f.type for f in self._fields.values()]

    def __len__(self) -> int:
        return len(self._fields)

    def index_of_key(self, key: str) -> int:
        return self.names.index(key)

    def assert_not_empty(self) -> "Schema":
        assert_or_throw(len(self) > 0, ValueError("schema is empty"))
        return self

    def create_empty_arrow(self) -> pa.Table:
        return self.pa_schema.empty_table()

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

    def exclude(self, names: Union[str, List[str]]) -> "Schema":
        """The schema without ``names`` (``fugue_tpu/schema.py:359``, for
        names); each must be in it."""
        if isinstance(names, str):
            names = [names]
        for n in names:
            assert_or_throw(n in self._fields, KeyError(f"{n} not in {self}"))
        return Schema([f for f in self.fields if f.name not in set(names)])

    def rename(self, columns: Dict[str, str]) -> "Schema":
        """Each ``old -> new`` at once (``fugue_tpu/schema.py:391``): every
        old name must exist and the new names must be distinct."""
        for k in columns:
            assert_or_throw(k in self._fields, KeyError(f"{k} not in schema"))
        new_names = [columns.get(n, n) for n in self.names]
        assert_or_throw(len(set(new_names)) == len(new_names),
                        ValueError(f"rename causes duplicated names {new_names}"))
        return Schema([pa.field(nn, f.type) for nn, f in zip(new_names, self.fields)])

    def alter(self, subschema: Any) -> "Schema":
        """This schema with the types of ``subschema``'s columns, which it
        must hold (``fugue_tpu/schema.py:402``)."""
        sub = subschema if isinstance(subschema, Schema) else Schema(subschema)
        for n in sub.names:
            assert_or_throw(n in self._fields, KeyError(f"{n} not in schema"))
        return Schema([sub[f.name] if f.name in sub else f for f in self.fields])

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

