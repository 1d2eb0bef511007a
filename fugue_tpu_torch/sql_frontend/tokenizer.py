"""SQL tokenizer of the SELECT front end: the pure-Python scanner
``_scan_py`` of ``fugue_tpu/sql_frontend/tokenizer.py:60``. The JAX
package can swap in a C++ scanner (``native/ctokenizer.cpp``); the port
has none yet (ROADMAP.md queue 1 item 15)."""

from typing import List, NamedTuple

from fugue_tpu_torch.exceptions import FugueSQLSyntaxError

__all__ = ["Token", "TokenError", "tokenize"]


class TokenError(FugueSQLSyntaxError, ValueError):
    """Lexing failure (ValueError kept for pre-hierarchy callers)."""


class Token(NamedTuple):
    kind: str  # IDENT | QIDENT | NUMBER | STRING | OP | END
    value: str
    pos: int  # character offset into the source

    @property
    def upper(self) -> str:
        return self.value.upper()


_OPERATORS = [
    "<>", "!=", "<=", ">=", "||", "==", "=>",
    "=", "<", ">", "+", "-", "*", "/", "%", "(", ")", ",", ".", ";", ":",
    "{", "}", "[", "]", "?",
]

_IDENT_START = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_")
_IDENT_CONT = _IDENT_START | set("0123456789")
_DIGITS = set("0123456789")

def tokenize(sql: str) -> List[Token]:
    """Scan ``sql`` into a token list terminated by an END token."""
    return _scan_py(sql)


def _scan_py(sql: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":
            j = sql.find("*/", i + 2)
            if j < 0:
                raise TokenError(f"unterminated block comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j, buf = i + 1, []
            while True:
                if j >= n:
                    raise TokenError(f"unterminated string at {i}")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                if sql[j] == "\\" and j + 1 < n and sql[j + 1] in ("'", "\\"):
                    buf.append(sql[j + 1])
                    j += 2
                    continue
                buf.append(sql[j])
                j += 1
            out.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        if c == '"' or c == "`":
            close = c
            j, buf = i + 1, []
            while True:
                if j >= n:
                    raise TokenError(f"unterminated quoted identifier at {i}")
                if sql[j] == close:
                    if j + 1 < n and sql[j + 1] == close:
                        buf.append(close)
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            out.append(Token("QIDENT", "".join(buf), i))
            i = j + 1
            continue
        if c in _DIGITS or (
            c == "." and i + 1 < n and sql[i + 1] in _DIGITS
        ):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                ch = sql[j]
                if ch in _DIGITS:
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    if j + 1 < n and (
                        sql[j + 1] in _DIGITS
                        or (
                            sql[j + 1] in "+-"
                            and j + 2 < n
                            and sql[j + 2] in _DIGITS
                        )
                    ):
                        seen_exp = True
                        j += 2 if sql[j + 1] in "+-" else 1
                    else:
                        break
                else:
                    break
            out.append(Token("NUMBER", sql[i:j], i))
            i = j
            continue
        if c in _IDENT_START:
            j = i + 1
            while j < n and sql[j] in _IDENT_CONT:
                j += 1
            out.append(Token("IDENT", sql[i:j], i))
            i = j
            continue
        for op in _OPERATORS:
            if sql.startswith(op, i):
                out.append(Token("OP", op, i))
                i += len(op)
                break
        else:
            raise TokenError(f"unexpected character {c!r} at {i}")
    out.append(Token("END", "", n))
    return out
