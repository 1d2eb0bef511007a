"""The host side of string expressions on the card: the tables K6's ``LUT``
instructions gather from, and the dictionaries of string results.

The port of the string part of ``fugue_tpu/jax_backend/expr_eval.py``. A
string column is int32 codes on the card and its decode table, the
dictionary, on the host (``blocks.TorchColumn``). Every string operation
is a rewrite of the dictionary or a table over it, built here in
O(|dictionary|) and gathered by code on the card:

- LIKE with a literal pattern: a bool table over the dictionary
  (``_like_literal``, ``:64-83``); with a pattern column, a bool table
  over the pairs of the two dictionaries, indexed by ``code * |d_p| +
  pattern code`` (``:174-216``), capped at ``MAX_PAIR_LUT`` entries;
- compares: each side's rank in the union of both sides' strings
  (``_str_compare``, ``:477-510``); against a literal, the compare is
  folded into one bool table over the dictionary;
- LENGTH: an int64 table of the entries' lengths (``:303-318``);
- a presort by a string column: each entry's rank in the sorted
  dictionary (``sort_rank_table``, ``relational.py:1248-1251``);
- UPPER, LOWER, the trims, REVERSE, SUBSTRING, REPLACE and CONCAT with
  literals: the codes pass through and the dictionary is transformed
  (``_transformed_dictionary``, ``:395-421``); CONCAT of several columns
  composes their codes in mixed radix over the cross product of their
  dictionaries (``_compose_concat_dictionary``, ``:648-672``), capped at
  ``MAX_COMPOSED_DICT`` entries;
- a string result whose dictionary has duplicates (TRIM folding ``"a "``
  into ``"a"``) is re-coded by a table onto its sorted distinct entries
  (``canonicalize_string_column``, ``:572-595``), so that group-by and
  joins see one code per string.

The compiler (``kernels/expr_program.py``) tracks which dictionary each
register codes; the kernel only gathers.
"""

import itertools
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from fugue_tpu_torch.column.like import compile_like_regex

# caps of the host-built tables that grow with a product of dictionaries
# (``expr_eval.py:57-61``): beyond them the JAX package answers on its
# host engine, and the port refuses naming ROADMAP.md queue 1 item 2(b)
MAX_PAIR_LUT = 1 << 20
MAX_COMPOSED_DICT = 1 << 18

# the dictionary transforms of one string argument (``:338-347``)
DICT_TRANSFORMS = {
    "upper": str.upper,
    "ucase": str.upper,
    "lower": str.lower,
    "lcase": str.lower,
    "trim": str.strip,
    "ltrim": str.lstrip,
    "rtrim": str.rstrip,
    "reverse": lambda x: x[::-1],
}
SUBSTRING = ("substring", "substr")

_CMP = {
    "==": np.equal, "!=": np.not_equal, "<": np.less, "<=": np.less_equal,
    ">": np.greater, ">=": np.greater_equal,
}
# a compare with its sides swapped
FLIPPED = {"==": "==", "!=": "!=", "<": ">", "<=": ">=", ">": "<", ">=": "<="}


def _nonempty(table: np.ndarray, fill: Any) -> np.ndarray:
    """A table of at least one entry: an empty dictionary's codes are all
    null, and the gather still reads entry 0."""
    return table if len(table) > 0 else np.full(1, fill, dtype=table.dtype)


def like_table(dictionary: np.ndarray, pattern: str, negated: bool) -> np.ndarray:
    """bool [|dictionary|]: whether each entry matches ``pattern``, or not
    where ``negated``."""
    rx = compile_like_regex(pattern)
    hit = np.fromiter((rx.fullmatch(str(x)) is not None for x in dictionary), dtype=bool,
                      count=len(dictionary))
    return _nonempty(hit != negated, False)


def like_pair_table(values: np.ndarray, patterns: np.ndarray, negated: bool) -> np.ndarray:
    """bool [max(|values|, 1) * max(|patterns|, 1)]: entry ``i * P + j``
    says whether value ``i`` matches pattern ``j`` (or not where
    ``negated``). The caller checks ``MAX_PAIR_LUT``."""
    no, npat = max(len(values), 1), max(len(patterns), 1)
    table = np.zeros((no, npat), dtype=bool)
    for j, p in enumerate(patterns):
        rx = compile_like_regex(str(p))
        table[: len(values), j] = np.fromiter(
            (rx.fullmatch(str(x)) is not None for x in values), dtype=bool, count=len(values))
    if negated:
        table = ~table
    return table.reshape(-1)


def vocabulary(parts: Sequence[np.ndarray]) -> np.ndarray:
    """The sorted distinct strings of every side of a compare."""
    return np.unique(np.concatenate([np.asarray(p, dtype=object).astype(str) for p in parts]))


def rank_table(vocab: np.ndarray, dictionary: np.ndarray) -> np.ndarray:
    """int32 [|dictionary|]: each entry's rank in ``vocab``."""
    ranks = np.searchsorted(vocab, np.asarray(dictionary, dtype=object).astype(str))
    return _nonempty(ranks.astype(np.int32), 0)


def sort_rank_table(dictionary: np.ndarray) -> np.ndarray:
    """int32 [|dictionary|]: each entry's rank in the dictionary sorted as
    strings, a repeated entry ranked in dictionary order: the rank table by
    which ``_sort_code_columns`` sorts a string column
    (``relational.py:1248-1251``)."""
    order = np.argsort(np.asarray(dictionary, dtype=object).astype(str), kind="stable")
    rank = np.empty(len(order), dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    return _nonempty(rank, 0)


def compare_table(op: str, dictionary: np.ndarray, literal: str) -> np.ndarray:
    """bool [|dictionary|]: ``entry op literal`` for each entry, by the
    union vocabulary's ranks (the same order as ``_str_compare``)."""
    vocab = vocabulary([dictionary, np.array([literal], dtype=object)])
    ranks = np.searchsorted(vocab, np.asarray(dictionary, dtype=object).astype(str))
    return _nonempty(_CMP[op](ranks, int(np.searchsorted(vocab, literal))), False)


def length_table(dictionary: np.ndarray) -> np.ndarray:
    """int64 [|dictionary|]: each entry's length in characters."""
    lengths = np.fromiter((len(str(x)) for x in dictionary), dtype=np.int64,
                          count=len(dictionary))
    return _nonempty(lengths, 0)


def transformed_dictionary(func: str, params: Sequence[Any], dictionary: np.ndarray
                           ) -> np.ndarray:
    """The dictionary of ``func(column, *params)`` for a dictionary
    transform (``_transformed_dictionary``): the codes are unchanged.
    ``params`` are SUBSTRING's start (1-based) and length, REPLACE's old
    and new text."""
    sd = [str(x) for x in dictionary]
    if func in DICT_TRANSFORMS:
        fn = DICT_TRANSFORMS[func]
        return np.array([fn(x) for x in sd], dtype=object)
    if func in SUBSTRING:
        start0 = max(int(params[0] if params else 1) - 1, 0)
        if len(params) > 1:
            n = int(params[1])
            return np.array([x[start0:start0 + n] for x in sd], dtype=object)
        return np.array([x[start0:] for x in sd], dtype=object)
    if func == "replace":
        old = str(params[0]) if params else ""
        new = str(params[1]) if len(params) > 1 else ""
        return np.array([x.replace(old, new) for x in sd], dtype=object)
    raise ValueError(f"{func} is not a dictionary transform")


def affixed_dictionary(prefix: str, dictionary: np.ndarray, suffix: str) -> np.ndarray:
    """The dictionary of CONCAT of literals and one string column."""
    return np.array([prefix + str(x) + suffix for x in dictionary], dtype=object)


def concat_size(dictionaries: Sequence[np.ndarray]) -> int:
    """The entries of a multi-column CONCAT's composed dictionary."""
    total = 1
    for d in dictionaries:
        total *= max(len(d), 1)
    return total


def concat_dictionary(template: List[Optional[str]], dictionaries: Sequence[np.ndarray]
                      ) -> np.ndarray:
    """The composed dictionary of a multi-column CONCAT: the cross product
    of the columns' dictionaries, row-major over the columns in order (the
    code ``((c1 * |d2|) + c2) * |d3| + c3 ...``), with the literal
    fragments of ``template`` between them (None marks a column). The
    caller checks ``MAX_COMPOSED_DICT``."""
    parts = list(template)
    slots = [i for i, t in enumerate(parts) if t is None]
    out = np.full(concat_size(dictionaries), "", dtype=object)
    for flat, combo in enumerate(itertools.product(*dictionaries)):
        for i, v in zip(slots, combo):
            parts[i] = str(v)
        out[flat] = "".join(parts)  # type: ignore[arg-type]
    return out


def canonical(dictionary: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``(table, distinct)`` where ``dictionary`` holds an entry twice:
    ``table`` (int32) maps each code to its entry's code in ``distinct``,
    the sorted distinct entries; None where every entry is distinct
    (``canonicalize_string_column``)."""
    if len(dictionary) == 0:
        return None
    distinct, inverse = np.unique(np.asarray(dictionary, dtype=object).astype(str),
                                  return_inverse=True)
    if len(distinct) == len(dictionary):
        return None
    return inverse.astype(np.int32).reshape(-1), distinct.astype(object)


def remap_table(d1: np.ndarray, d2: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``(table, union)`` that re-codes side 2 of a join key into one
    dictionary (``harmonize_string_keys``, ``jax_backend/relational.py:69-104``):
    ``union`` is ``d1`` with ``d2``'s new entries after it, so side 1
    keeps its codes; ``table`` (int32) maps each of ``d2``'s codes into
    it. None where the two dictionaries are equal."""
    if d1 is d2 or (len(d1) == len(d2) and bool((d1 == d2).all())):
        return None
    index1 = {v: i for i, v in enumerate(d1)}
    table = np.zeros(max(len(d2), 1), dtype=np.int32)
    extra: List[Any] = []
    for i, v in enumerate(d2):
        j = index1.get(v)
        if j is None:
            j = len(d1) + len(extra)
            extra.append(v)
        table[i] = j
    union = np.concatenate([d1, np.asarray(extra, dtype=object)]) if extra else d1
    return table, union
