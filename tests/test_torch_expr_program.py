"""K6 ``expr_program``: the compiler (``fugue_tpu_torch/kernels/expr_program.py``)
and the kernel's twin (``expr_program_reference`` in
``fugue_tpu_torch/kernels/reference.py``), through
``torch_backend/expr_eval.py``, against the JAX package's
``expr_eval.eval_expr`` under ``jax.jit`` on the CPU.

Every operator family over every ported dtype, with nulls, NaN, -0.0,
infinities and integer wrap, then random numeric trees (``hypothesis``,
depth up to 4) built so that the JAX package's computed types equal the
declared ones. Integer, bool and float results must equal the JAX
package's bit for bit, nulls in place (values compared where valid);
the float functions (``sqrt``, ``exp``, ``ln``, ``log2``, ``log10``,
``sin``, ``cos``, ``tan``, ``power``) at rtol 1e-13 in float64 (torch's
CPU functions, XLA's and CUDA's differ in the last bits: torch's CPU
``sqrt`` is not even correctly rounded, ``sqrt(0.5)`` one ulp low; the
kernel is held at the same tolerance on the card). Where the JAX package computes
in another type than it declares, or XLA rewrites the arithmetic
(ROADMAP.md queue 3: weak literals, int / int in float32, inner casts
dropped, float32 arguments of the float functions, ``/ const`` as a
product, ``round``, ``a * b + c`` as an FMA, ``x + 0`` as ``x``), the port is
held against numpy instead; the random trees compare -0.0 equal to
+0.0 for that last reason.
"""

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import fugue_tpu.column.expressions as jx
import fugue_tpu_torch.column.expressions as tx
from fugue_tpu.jax_backend.expr_eval import eval_expr as jax_eval_expr
from fugue_tpu_torch.kernels import expr_program as ep
from fugue_tpu_torch.kernels.reference import expr_program_reference
from fugue_tpu_torch.torch_backend import expr_eval
from fugue_tpu_torch.torch_backend.blocks import TorchBlocks, TorchColumn

N = 97
TYPES = ("bool", "i8", "i32", "i64", "f32", "f64")
_NP = {"bool": np.bool_, "i8": np.int8, "i32": np.int32, "i64": np.int64,
       "f32": np.float32, "f64": np.float64, "u8": np.uint8}
_PA = {"bool": pa.bool_(), "i8": pa.int8(), "i32": pa.int32(), "i64": pa.int64(),
       "f32": pa.float32(), "f64": pa.float64(), "u8": pa.uint8()}
TRANSCENDENTAL = ("sqrt", "exp", "ln", "log", "log2", "log10", "sin", "cos", "tan", "power", "pow")


def _data(seed: int = 7, n: int = N) -> Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Columns ``<type>`` and ``<type>_b`` of every type, some with nulls
    (mask True = valid): special floats, integer extremes, no subnormal."""
    rng = np.random.default_rng(seed)
    floats = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf, -np.inf, 3.0e7, 7.0, -1.0,
                       0.5, 123.456, -0.001, 2.0])
    out: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]] = {}
    for t in TYPES + ("u8",):
        for suffix, nulls in (("", 0.2), ("_b", 0.0)):
            if t == "bool":
                v = rng.random(n) < 0.5
            elif t in ("f32", "f64"):
                v = np.where(rng.random(n) < 0.4, floats[rng.integers(0, len(floats), n)],
                             rng.standard_normal(n) * 100).astype(_NP[t])
            else:
                info = np.iinfo(_NP[t])
                v = np.where(rng.random(n) < 0.15, rng.choice([info.min, info.max, 0, -1
                                                               if info.min < 0 else 1], n),
                             rng.integers(-50 if info.min < 0 else 0, 50, n)).astype(_NP[t])
            mask = (rng.random(n) >= nulls) if nulls else None
            out[t + suffix] = (v, mask)
    return out


def _build(spec: Any, mod: Any) -> Any:
    """A spec (nested tuples) as an expression of ``mod`` (the JAX
    package's or the port's ``column.expressions``)."""
    kind = spec[0]
    if kind == "col":
        return mod.col(spec[1])
    if kind == "lit":
        return mod.lit(spec[1])
    if kind == "un":
        return mod._UnaryOpExpr(spec[1], _build(spec[2], mod))
    if kind == "bin":
        return mod._BinaryOpExpr(spec[1], _build(spec[2], mod), _build(spec[3], mod))
    if kind == "fn":
        return mod._FuncExpr(spec[1], *[_build(a, mod) for a in spec[2:]])
    if kind == "cast":
        return _build(spec[2], mod).cast(_PA[spec[1]])
    raise ValueError(spec)


def _blocks(data: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]], n: int) -> TorchBlocks:
    cols = {k: TorchColumn(_PA[k.split("_")[0]], torch.from_numpy(v.copy()),
                           None if m is None else torch.from_numpy(m.copy()))
            for k, (v, m) in data.items()}
    return TorchBlocks(n, cols, torch.device("cpu"))


def port_eval(spec: Any, data: Dict[str, Any], n: int = N) -> Tuple[np.ndarray, np.ndarray, bool]:
    """(values, validity, has a mask) of the port's evaluation."""
    blocks = _blocks(data, n)
    (v, m), = expr_eval.eval_exprs(blocks, [_build(spec, tx)], [None], ep.ProgramCache())
    valid = np.ones(n, bool) if m is None else m.numpy()
    return v.numpy(), valid, m is not None


def jax_eval(spec: Any, data: Dict[str, Any], n: int = N) -> Tuple[np.ndarray, np.ndarray, bool]:
    """(values, validity, has a mask) of the JAX package's ``eval_expr``
    under ``jax.jit`` on the CPU."""
    expr = _build(spec, jx)
    cols = {k: (jnp.asarray(v), None if m is None else jnp.asarray(m))
            for k, (v, m) in data.items()}
    v, m = jax.jit(lambda c: jax_eval_expr(c, expr, n))(cols)
    valid = np.ones(n, bool) if m is None else np.asarray(m)
    return np.asarray(v), valid, m is not None


def _same_bits(got: np.ndarray, want: np.ndarray, valid: np.ndarray,
               signed_zero: bool = True) -> bool:
    g, w = got[valid], want[valid]
    if not signed_zero and g.dtype.kind == "f":
        g, w = g + 0.0, w + 0.0  # -0.0 as +0.0
    if g.dtype.kind == "f":
        return bool(np.array_equal(g.view(f"u{g.itemsize}"), w.view(f"u{w.itemsize}"))
                    or np.array_equal(np.where(np.isnan(g), 0, g).view(f"u{g.itemsize}"),
                                      np.where(np.isnan(w), 0, w).view(f"u{w.itemsize}"))
                    and np.array_equal(np.isnan(g), np.isnan(w)))
    return bool(np.array_equal(g, w))


def _uses(spec: Any, names: Tuple[str, ...]) -> bool:
    if not isinstance(spec, tuple):
        return False
    if spec[0] == "fn" and spec[1] in names:
        return True
    return any(_uses(s, names) for s in spec[1:])


def assert_matches_jax(spec: Any, data: Optional[Dict[str, Any]] = None,
                       signed_zero: bool = True) -> None:
    """The port's value of ``spec`` against the JAX package's; with
    ``signed_zero`` False, -0.0 equals +0.0."""
    data = data if data is not None else _data()
    gv, gm, gmask = port_eval(spec, data)
    wv, wm, wmask = jax_eval(spec, data)
    assert gv.dtype == wv.dtype, (spec, gv.dtype, wv.dtype)
    np.testing.assert_array_equal(gm, wm, err_msg=str(spec))
    assert gmask == wmask, spec
    if _uses(spec, TRANSCENDENTAL):
        np.testing.assert_allclose(gv[gm], wv[gm], rtol=1e-13, atol=0, equal_nan=True,
                                   err_msg=str(spec))
    else:
        assert _same_bits(gv, wv, gm, signed_zero), (spec, gv[gm][:10], wv[gm][:10])


def C(name: str) -> Any:
    return ("col", name)


def L(v: Any) -> Any:
    return ("lit", v)


# --- every operator family over every ported dtype ---

_FAMILIES: Dict[str, Any] = {}
for _t in TYPES:
    _FAMILIES[f"is_null_{_t}"] = ("un", "IS_NULL", C(_t))
    _FAMILIES[f"not_null_{_t}"] = ("un", "NOT_NULL", C(_t))
    _FAMILIES[f"not_{_t}"] = ("un", "~", C(_t))
    _FAMILIES[f"abs_{_t}"] = ("fn", "abs", C(_t))
    _FAMILIES[f"floor_{_t}"] = ("fn", "floor", C(_t))
    _FAMILIES[f"ceil_{_t}"] = ("fn", "ceil", C(_t))
    _FAMILIES[f"and_{_t}"] = ("bin", "&", C(_t), C("bool_b"))
    _FAMILIES[f"or_{_t}"] = ("bin", "|", C("bool"), C(_t))
    _FAMILIES[f"add_{_t}"] = ("bin", "+", C(_t), C(_t + "_b"))
    _FAMILIES[f"mul_{_t}"] = ("bin", "*", C(_t), C(_t + "_b"))
    for _op in ("==", "!=", "<", "<=", ">", ">="):
        _FAMILIES[f"cmp{_op}_{_t}"] = ("bin", _op, C(_t), C(_t + "_b"))
    _FAMILIES[f"coalesce_{_t}"] = ("fn", "coalesce", C(_t), C(_t + "_b"))
    _FAMILIES[f"case_when_{_t}"] = ("fn", "case_when", ("bin", ">", C("f64"), L(0.0)), C(_t),
                                    ("un", "IS_NULL", C("i8")), C(_t + "_b"), C(_t))
    _FAMILIES[f"iif_{_t}"] = ("fn", "iif", C("bool"), C(_t), C(_t + "_b"))
    _FAMILIES[f"nullif_{_t}"] = ("fn", "nullif", C(_t), C(_t + "_b"))
    for _to in TYPES:
        _FAMILIES[f"cast_{_t}_to_{_to}"] = ("cast", _to, C(_t))
    if _t != "bool":
        _FAMILIES[f"neg_{_t}"] = ("un", "-", C(_t))
        _FAMILIES[f"sub_{_t}"] = ("bin", "-", C(_t), C(_t + "_b"))
        _FAMILIES[f"sign_{_t}"] = ("fn", "sign", C(_t))
        _FAMILIES[f"mod_{_t}"] = ("fn", "mod", C(_t), C(_t + "_b"))
    if _t in ("i64", "f64"):
        _FAMILIES[f"div_{_t}"] = ("bin", "/", C(_t), C(_t + "_b"))
        for _f in ("sqrt", "exp", "ln", "log2", "log10", "sin", "cos", "tan"):
            _FAMILIES[f"{_f}_{_t}"] = ("fn", _f, C(_t))
        _FAMILIES[f"power_{_t}"] = ("fn", "power", C(_t), C("f64_b"))
_FAMILIES.update({
    "bool_minus_int8": ("bin", "-", C("bool"), C("i8")),
    "int8_minus_bool": ("bin", "-", C("i8"), C("bool_b")),
    "mixed_add_i8_f32": ("bin", "+", C("i8"), C("f32")),
    "mixed_cmp_i64_f32": ("bin", "<", C("i64"), C("f32_b")),
    "mixed_mul_i32_i64": ("bin", "*", C("i32"), C("i64")),
    "wrap_i8": ("bin", "*", ("bin", "+", C("i8"), C("i8_b")), C("i8")),
    "wrap_i64": ("bin", "*", C("i64"), C("i64_b")),
    "int_literal_with_i64": ("bin", "+", C("i64"), L(9223372036854775807)),
    "float_literal_with_f64": ("bin", "*", C("f64"), L(-0.0)),
    "int_literal_with_f32": ("bin", "-", C("f32"), L(3)),
    "compare_i8_literal": ("bin", ">=", C("i8"), L(-1)),
    "compare_f32_literal": ("bin", "<", C("f32"), L(1.5)),
    "null_literal_is_null": ("un", "IS_NULL", ("lit", None)),
    "null_plus_i32": ("un", "NOT_NULL", ("bin", "+", C("i32"), ("lit", None))),
    "coalesce_literal": ("fn", "coalesce", C("f32"), L(0.5)),
    "coalesce_three": ("fn", "coalesce", C("i64"), L(5), C("i64_b")),
    "case_when_null_default": ("fn", "case_when", C("bool"), C("i32"), ("lit", None)),
    "kleene_chain": ("bin", "|", ("bin", "&", C("bool"), ("un", "~", C("i8"))),
                     ("un", "IS_NULL", C("f64"))),
    "mod_by_literal": ("fn", "mod", C("i64"), L(7)),
    "mod_float_literal": ("fn", "mod", C("f64"), L(2.5)),
    "div_power_of_two": ("bin", "/", C("f64"), L(4.0)),
    "sign_nan_zero": ("fn", "sign", ("bin", "*", C("f64"), L(0.0))),
    "cast_top_f64_to_i8": ("cast", "i8", ("bin", "*", C("f64"), L(1000.0))),
})


@pytest.mark.parametrize("case", sorted(_FAMILIES))
def test_operator_family_matches_jax(case):
    assert_matches_jax(_FAMILIES[case])


# --- random trees ---

_LITS = {"bool": [True, False], "i64": [0, 1, -3, 7, 2**40], "f64": [0.5, -2.0, 0.0, 1.5, -0.0]}


def _is_op(spec: Any, op: str) -> bool:
    """``spec`` is a ``op`` node, or a negation or NULLIF of one (a NULLIF's
    value is its first argument's): what XLA's simplifier sees through."""
    if (spec[0] == "un" and spec[1] == "-") or (spec[0] == "fn" and spec[1] == "nullif"):
        return _is_op(spec[2], op)
    return spec[0] == "bin" and spec[1] == op


def _foldable(spec: Any) -> bool:
    """A literal, or IS [NOT] NULL, which XLA may prove constant."""
    return spec[0] == "lit" or (spec[0] == "un" and spec[1] in ("IS_NULL", "NOT_NULL"))


def _tree(draw: Any, depth: int, top: bool = True) -> Tuple[Any, str]:
    """A random tree and its type, built so that the JAX package computes
    in the declared types and XLA rewrites nothing (see the module
    docstring): a float function only at the root, where the tolerance
    applies, and no float product under an add."""
    if depth == 0 or draw(st.integers(0, 3)) == 0:
        t = draw(st.sampled_from(TYPES))
        return C(t + draw(st.sampled_from(["", "_b"]))), t
    kinds = ["arith", "cmp", "logic", "unary", "func", "select"]
    kind = draw(st.sampled_from(kinds if top else kinds[:4] + kinds[5:]))
    a, ta = _tree(draw, depth - 1, False)
    if kind == "unary":
        op = draw(st.sampled_from(["-", "~", "IS_NULL", "NOT_NULL"]))
        if op == "-" and ta == "bool":
            op = "~"
        return ("un", op, a), ("bool" if op != "-" else ta)
    if kind == "func":
        f = draw(st.sampled_from(["abs", "floor", "ceil", "sign", "sqrt", "exp", "sin"]))
        if f == "sign" and ta == "bool":
            f = "abs"
        if f in ("sqrt", "exp", "sin"):
            if ta not in ("i64", "f64"):
                return ("fn", "abs", a), ta
            return ("fn", f, a), "f64"
        return ("fn", f, a), (ta if f == "abs" else "i64")
    if draw(st.booleans()) and ta in _LITS:
        b, tb = L(draw(st.sampled_from(_LITS[ta]))), ta
    else:
        b, tb = _tree(draw, depth - 1, False)
    order = TYPES.index
    tp = ta if order(ta) >= order(tb) else tb
    if kind == "cmp":
        return ("bin", draw(st.sampled_from(["==", "!=", "<", "<=", ">", ">="])), a, b), "bool"
    if kind == "logic":
        return ("bin", draw(st.sampled_from(["&", "|"])), a, b), "bool"
    if kind == "select":
        c, _ = _tree(draw, depth - 1, False)
        if ta != tb:
            b, tb = a, ta
        f = draw(st.sampled_from(["case_when", "iif", "coalesce", "nullif"]))
        if f == "coalesce":
            return ("fn", f, a, b), ta
        if f == "nullif":
            return ("fn", f, a, b), ta
        return ("fn", f, c, a, b), ta
    floats = tp in ("f32", "f64")

    def safe(op: str) -> bool:
        if op == "mod":
            return ta != "bool" and tb == ta
        if _foldable(a) or (op != "*" and b[0] == "un" and _foldable(b)):
            return False  # XLA reassociates and folds around constants
        if b[0] == "lit" and a[0] == "bin" and any(_foldable(x) for x in a[2:]):
            return False  # (x op c1) op c2 into x op (c1 op c2)
        if op == "/":  # XLA turns x / const into a product, regroups quotients
            return (tp in ("i64", "f64") and b[0] != "lit"
                    and not (_is_op(a, "/") or _is_op(b, "/")))
        if op == "*":  # XLA turns x * bool into a select
            return not ("bool" in (ta, tb) and floats)
        # XLA fuses a * b + c into an FMA; JAX refuses bool - bool
        fma = floats and (_is_op(a, "*") or _is_op(b, "*"))
        return not fma and not (op == "-" and tp == "bool")

    first = draw(st.sampled_from(["+", "-", "*", "/", "mod"]))
    op = next((o for o in (first, "+", "-", "*", "/") if safe(o)), None)
    if op is None:
        return ("bin", "<", a, b), "bool"
    if op == "mod":
        return ("fn", "mod", a, b), ta
    return ("bin", op, a, b), ("f64" if op == "/" else tp)


@settings(max_examples=60, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_random_trees_match_jax(data):
    spec, _ = _tree(data.draw, 4)
    if data.draw(st.booleans()):
        spec = ("cast", data.draw(st.sampled_from(TYPES)), spec)
    # XLA folds x + 0 (a literal zero, or an IS NULL it can prove false)
    # into x, so -0.0 + 0 stays -0.0 there (test_adding_zero_is_ieee)
    assert_matches_jax(spec, _data(seed=data.draw(st.integers(0, 3))), signed_zero=False)


# --- where the JAX package computes in other types: numpy ---

def _np_col(data: Dict[str, Any], name: str) -> Tuple[np.ndarray, np.ndarray]:
    v, m = data[name]
    return v, np.ones(len(v), bool) if m is None else m


def test_weak_literal_computes_in_the_declared_type():
    """``i8 * 100`` is declared int64: the port gives 300 where the JAX
    package wraps in int8 to 44."""
    data = {"i8": (np.array([1, 2, 3, -128], np.int8), None)}
    gv, gm, _ = port_eval(("bin", "*", C("i8"), L(100)), data, 4)
    assert gv.dtype == np.int64 and gm.all()
    np.testing.assert_array_equal(gv, data["i8"][0].astype(np.int64) * 100)
    jv, _, _ = jax_eval(("bin", "*", C("i8"), L(100)), data, 4)
    assert jv.dtype == np.int8  # the reference's computed type


def test_integer_division_is_float64():
    data = {"i32": (np.array([1, -7, 2**31 - 1, 5], np.int32), None),
            "i32_b": (np.array([3, 2, 3, 0], np.int32), None)}
    gv, _, _ = port_eval(("bin", "/", C("i32"), C("i32_b")), data, 4)
    want = data["i32"][0].astype(np.float64) / data["i32_b"][0].astype(np.float64)
    np.testing.assert_array_equal(gv, want)


def test_inner_cast_is_honoured():
    """``cast(u, double) / 3`` divides in float64 (the JAX package drops
    the inner cast and divides int32 by int32 in float32)."""
    data = {"i32": (np.arange(-5, 95, dtype=np.int32), None)}
    spec = ("bin", "/", ("cast", "f64", C("i32")), L(3))
    gv, _, _ = port_eval(spec, data, 100)
    np.testing.assert_array_equal(gv, data["i32"][0].astype(np.float64) / 3.0)
    jv, _, _ = jax_eval(spec, data, 100)
    assert not np.array_equal(jv, gv)  # the reference's fault, ROADMAP.md queue 3


def test_float_functions_of_float32_compute_in_float64():
    data = {"f32": (np.array([2.0, 3.0, 0.1, -1.0, np.nan], np.float32), None)}
    for f, npf in (("sqrt", np.sqrt), ("exp", np.exp), ("ln", np.log), ("sin", np.sin)):
        gv, _, _ = port_eval(("fn", f, C("f32")), data, 5)
        with np.errstate(invalid="ignore"):
            want = npf(data["f32"][0].astype(np.float64))
        np.testing.assert_allclose(gv, want, rtol=1e-13, equal_nan=True)


def test_division_by_a_literal_is_true_division():
    """XLA computes ``x / 3.0`` as ``x * (1/3.0)``, one ulp off; the port
    divides (numpy's value, bit for bit)."""
    x = np.random.default_rng(0).standard_normal(1000) * 1000
    gv, _, _ = port_eval(("bin", "/", C("f64"), L(3.0)), {"f64": (x, None)}, 1000)
    np.testing.assert_array_equal(gv, x / 3.0)


@pytest.mark.parametrize("t", ["f32", "f64"])
def test_multiply_add_rounds_each_operation(t):
    """XLA on the CPU fuses ``a * b + c`` into an FMA (one rounding); the
    port rounds the product and the sum, as numpy does."""
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal(5000).astype(_NP[t]) * 100 for _ in range(2))
    data = {t: (a, None), t + "_b": (b, None)}
    spec = ("bin", "+", ("bin", "*", C(t), C(t + "_b")), C(t))
    gv, _, _ = port_eval(spec, data, 5000)
    np.testing.assert_array_equal(gv, a * b + a)


def test_adding_zero_is_ieee():
    """``-0.0 + 0.0`` is +0.0 in IEEE and numpy; XLA folds ``x + 0`` into
    ``x`` and keeps -0.0."""
    x = np.array([-0.0, 0.0, -1.5, np.nan])
    gv, _, _ = port_eval(("bin", "+", C("f64"), L(0.0)), {"f64": (x, None)}, 4)
    assert _same_bits(gv, x + 0.0, np.ones(4, bool)) and not np.signbit(gv[0])


def test_bool_times_float_is_ieee():
    """``(b / 0.0) * False`` is NaN as in IEEE and numpy (XLA's select
    gives 0)."""
    data = {"f64": (np.array([1.0, -1.0, 0.0]), None),
            "bool": (np.array([False, False, True]), None)}
    gv, _, _ = port_eval(("bin", "*", ("bin", "/", C("f64"), L(0.0)), C("bool")), data, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = (data["f64"][0] / 0.0) * data["bool"][0]
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(want))
    np.testing.assert_array_equal(gv[~np.isnan(gv)], want[~np.isnan(want)])


@pytest.mark.parametrize("digits", [0, 1, 2, 3, -1, -2])
def test_round_is_numpys(digits):
    x = np.concatenate([np.random.default_rng(1).standard_normal(3000) * 1000,
                        [0.5, 1.5, 2.5, -0.5, 0.125, 0.375, np.nan, np.inf, -0.0]])
    gv, _, _ = port_eval(("fn", "round", C("f64"), L(digits)), {"f64": (x, None)}, len(x))
    want = np.round(x, digits)
    assert _same_bits(gv, want, np.ones(len(x), bool))


def test_float_to_int_casts_saturate_and_nan_is_zero():
    """The JAX package's rule on the CPU (XLA's convert): NaN as 0, values
    beyond the type at its bounds, truncation otherwise."""
    x = np.array([np.nan, np.inf, -np.inf, 1e20, -1e20, 3.7, -3.7, 2.0**31, 300.5, -200.0,
                  -0.5, 255.9])
    data = {"f64": (x, None), "f32": (x.astype(np.float32), None)}
    for src in ("f64", "f32"):
        for to in ("i8", "i32", "i64", "u8", "bool"):
            spec = ("cast", to, C(src))
            gv, _, _ = port_eval(spec, data, len(x))
            jv, _, _ = jax_eval(spec, data, len(x))
            np.testing.assert_array_equal(gv, jv, err_msg=f"{src}->{to}")


# --- the twin's filter epilogue, the compiler and its refusals ---

@pytest.mark.parametrize("layout", ["prefix", "masked"])
def test_filter_epilogue_matches_the_jax_filter_program(layout):
    data = _data(3)
    cond = ("bin", "|", ("bin", "&", ("bin", ">=", C("f32"), L(0.5)),
                         ("bin", "!=", C("i32"), L(7))), ("un", "IS_NULL", C("f64")))
    blocks = _blocks(data, N)
    blocks._nrows = N - 10
    rows: Dict[str, Any] = {"nrows": N - 10}
    valid = np.arange(N) < N - 10
    if layout == "masked":
        valid = np.random.default_rng(2).random(N) < 0.7
        blocks.row_valid, blocks._nrows = torch.from_numpy(valid), None
        rows = {"row_valid": torch.from_numpy(valid)}
    keep, count = expr_eval.filter_rows(blocks, _build(cond, tx), ep.ProgramCache())
    jv, jm, _ = jax_eval(cond, data)
    want = jv.astype(bool) & jm & valid
    np.testing.assert_array_equal(keep.numpy(), want)
    assert count.dtype == torch.int32 and int(count) == int(want.sum())
    prog = ep.compile_program([_build(cond, tx)], [torch.bool],
                              {k: (torch.from_numpy(v).dtype, m is not None)
                               for k, (v, m) in data.items()})
    inputs = [blocks_col(blocks, name) for name, _ in prog.inputs]
    k2, c2 = expr_program_reference(prog, inputs, N, filter=True, **rows)
    assert torch.equal(k2, keep) and int(c2) == int(count)


def blocks_col(blocks: TorchBlocks, name: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    c = blocks.columns[name]
    return c.data, c.mask


def test_literals_are_immediates_and_values_are_shared():
    """A literal is a CONST instruction of the operation's type (never a
    column), a cast of a literal folds into it, a repeated subtree is
    computed once, and registers are reused."""
    cols = {"a": (torch.int32, False), "b": (torch.float64, True)}
    e = (tx.col("a") * 2 + tx.col("a") * 2) > (tx.col("b") + 1.5)
    prog = ep.compile_program([e], [torch.bool], cols)
    ops = [ep.OPS[i.op] for i in prog.instrs]
    assert ops.count("MUL") == 1 and ops.count("CONST") == 2
    consts = {(i.dtype, i.imm) for i in prog.instrs if ep.OPS[i.op] == "CONST"}
    assert consts == {(ep.I64, 2), (ep.F64, 1.5)}
    assert prog.nregs <= 4 and prog.outputs[0].masked
    assert [name for name, _ in prog.inputs] == ["a", "b"]


def _chain(m: Any, k: int) -> Any:
    e = m.col("g")
    for i in range(k):
        e = e + i
    return e


def _sum(terms: list) -> Any:
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


# programs over the interpreter's old caps (64 instructions, 32 registers,
# 16 outputs), as assign columns of test_torch_filter_select's frame
_OVER_CAPS = {
    "chain70": lambda m: [_chain(m, 70).alias("c")],
    "outputs17": lambda m: [(m.col("g") * i + m.col("i32")).alias(f"o{i}") for i in range(17)],
    # 40 terms all live at once: the second sum reads them in reverse
    "live40": lambda m: [_sum([m.col("g") * i for i in range(1, 41)]).alias("s"),
                         _sum([m.col("g") * i for i in range(40, 0, -1)]).alias("r")],
}


def _over_caps_engines(layout: str) -> Any:
    from test_torch_filter_select import _data, _engines
    from test_torch_segment_aggs import _frames

    te, je = _engines()
    tin, jin = _frames(_data(), layout)
    return te, je, tin, jin


def test_program_over_the_caps_is_refused_naming_roadmap():
    """The interpreter refused a program over its caps (ROADMAP.md queue 2
    item 17, now retired): a kernel generated for the program has none.
    A chain of 70 additions (140 instructions) and 17 outputs in one
    ``assign`` compute and equal the JAX engine's, in one program each."""
    from test_torch_segment_aggs import compare

    cols = {"g": (torch.int64, False), "i32": (torch.int32, False)}
    chain = ep.compile_program(_OVER_CAPS["chain70"](tx), [None], cols)
    wide = ep.compile_program(_OVER_CAPS["outputs17"](tx), [None] * 17, cols)
    assert len(chain.instrs) == 140 and len(wide.outputs) == 17
    for case in ("chain70", "outputs17"):
        te, je, tin, jin = _over_caps_engines("prefix")
        compare(te.assign(tin, _OVER_CAPS[case](tx)), je.assign(jin, _OVER_CAPS[case](jx)), {})
        assert te.fallbacks == {}


@pytest.mark.parametrize("layout", ["prefix", "masked"])
@pytest.mark.parametrize("case", sorted(_OVER_CAPS))
def test_programs_over_the_old_caps_match_jax(case, layout):
    from test_torch_segment_aggs import compare

    te, je, tin, jin = _over_caps_engines(layout)
    compare(te.assign(tin, _OVER_CAPS[case](tx)), je.assign(jin, _OVER_CAPS[case](jx)), {})
    assert te.fallbacks == {}


def test_program_with_more_than_32_live_registers():
    cols = {"g": (torch.int64, False)}
    prog = ep.compile_program(_OVER_CAPS["live40"](tx), [None] * 2, cols)
    assert prog.nregs > 40


def test_filter_by_a_chain_over_the_old_caps_matches_jax():
    from test_torch_segment_aggs import compare

    te, je, tin, jin = _over_caps_engines("masked")
    tres, jres = te.filter(tin, _chain(tx, 70) > 2000), je.filter(jin, _chain(jx, 70) > 2000)
    compare(tres, jres, {})
    assert tres.count() == jres.count() and te.fallbacks == {}


@pytest.mark.parametrize("spec,item", [
    # a string beside a number, a string function of a number: the JAX
    # package answers both on its host engine
    (("bin", "==", C("i32"), L("x")), "queue 1 item 2(b)"),
    (("fn", "upper", C("i32")), "queue 1 item 2(b)"),
    (("fn", "atan", C("f64")), "queue 1 item 2(b)"),
    (("bin", "-", C("bool"), C("bool_b")), "queue 1 item 2(b)"),
    (("un", "-", C("bool")), "queue 1 item 2(b)"),
    (("bin", "+", C("u8"), C("i8")), "queue 1 item 2(b)"),
    (("fn", "round", C("f64"), C("i32")), "queue 1 item 2(b)"),
])
def test_refusals_name_their_roadmap_item(spec, item):
    with pytest.raises(NotImplementedError, match=item.replace("(", r"\(").replace(")", r"\)")):
        port_eval(spec, _data())


def test_uint8_alone_computes_in_uint8():
    data = {"u8": (np.array([200, 100, 0, 255], np.uint8), None),
            "u8_b": (np.array([100, 200, 1, 255], np.uint8), None)}
    gv, _, _ = port_eval(("bin", "+", C("u8"), C("u8_b")), data, 4)
    np.testing.assert_array_equal(gv, data["u8"][0] + data["u8_b"][0])
    assert gv.dtype == np.uint8


def test_the_cuda_wrapper_refuses_cpu_tensors():
    prog = ep.compile_program([tx.col("a") + 1], [None], {"a": (torch.int64, False)})
    with pytest.raises(ValueError, match="CUDA"):
        ep.expr_program_cuda(prog, [(torch.arange(3), None)], 3, device=torch.device("cpu"))


@pytest.mark.parametrize("op", ["+", "-", "*", "neg", "lit_mul", "cast"])
def test_float16_ops_match_numpy_float16(op):
    """K6's twin over float16 columns (an F16 input read into float32, the
    result rounded to float16 once an operation, ``HALF``, and stored as
    float16) against numpy's float16 arithmetic elementwise, bit for bit:
    60000 * 2 overflows to inf as there."""
    rng = np.random.default_rng(17)
    n = 3000
    x = np.concatenate([(rng.standard_normal(n) * 300).astype(np.float16),
                        np.array([60000, -60000, 65504, 6e-8, -0.0, 0.0], np.float16)])
    y = np.concatenate([(rng.standard_normal(n) * 300).astype(np.float16),
                        np.array([2, 2, 1, 3e-5, 0.0, -0.0], np.float16)])
    blocks = TorchBlocks(len(x), {
        "x": TorchColumn(pa.float16(), torch.from_numpy(x), None),
        "y": TorchColumn(pa.float16(), torch.from_numpy(y), None)}, torch.device("cpu"))
    cx, cy = tx.col("x"), tx.col("y")
    expr, want = {
        "+": (cx + cy, x + y), "-": (cx - cy, x - y), "*": (cx * cy, x * y),
        "neg": (-cx, -x), "lit_mul": (cx * 2, x * np.float16(2)),
        "cast": (cx.cast("double"), x.astype(np.float64)),
    }[op]
    dt = torch.float64 if op == "cast" else torch.float16
    (got, _), = expr_eval.eval_exprs(blocks, [expr], [dt], ep.ProgramCache())
    assert got.dtype == dt
    np.testing.assert_array_equal(got.numpy().view(np.int64 if op == "cast" else np.int16),
                                  want.view(np.int64 if op == "cast" else np.int16))
