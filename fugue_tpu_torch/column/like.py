"""SQL ``LIKE`` patterns as anchored regular expressions: the port's copy of
``like_pattern_to_regex`` and ``compile_like_regex``
(``fugue_tpu/column/pandas_eval.py:331`` and ``:346``), the one helper
every LIKE evaluator of the JAX package matches with."""

import re


def like_pattern_to_regex(pattern: str) -> str:
    """``%`` -> ``.*``, ``_`` -> ``.``, every other character literal.
    Unanchored; ``compile_like_regex`` anchors it."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)


def compile_like_regex(pattern: str) -> "re.Pattern":
    r"""The compiled regex of a LIKE pattern, anchored with ``\A...\Z``
    (``$`` would also match before a trailing newline) and with DOTALL,
    since SQL's ``%`` and ``_`` match newlines too."""
    return re.compile(r"\A" + like_pattern_to_regex(pattern) + r"\Z", re.DOTALL)
