"""K6's code generator (``fugue_tpu_torch/kernels/expr_codegen.py``) on the
CPU, where there is no ``nvcc`` and no card.

The key: a kernel is keyed by its program's structure only, so two
programs that differ in a literal or in a table's contents share one
binary, and a dtype, a mask, an opcode or the mode each make another.

A host build of the generated code: every program below is generated as
for the card, and each kernel's device part (``Params``, ``Row``, ``Out``,
``load``/``loadv``, ``row``, ``store``/``storev``) is built with ``g++ -O2
-ffp-contract=off`` under ``k6_host_shim.h`` (which maps ``__device__``,
``__ldg``, the ``_rn`` intrinsics, the conversions and the bit casts onto
C++), all of them in one call, beside a loop that runs ``row`` over
every row. Its parameters are packed by the wrapper's own
``pack_params``, over CPU tensors. The programs are ``chip_smoke.py``'s
(``k6_cases``: every operator family over every dtype, with nulls, NaN,
-0.0, +0.0, infinities and the integer extremes; the paths' programs;
``k6_string_cases``: the LUT family; the programs over the interpreter's
old caps), in columns mode and, for a filter, over prefix rows (all,
and all but 3) and a ``row_valid``, each through its scalar and its
vector row code. Each result is held against the
twin (``expr_program_reference``) by ``chip_smoke.check_k6``: masks,
keep flags and counts exactly, values bit for bit, the float functions
within its 1e-13. Skipped only where no ``g++`` is found."""

import ctypes
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
from fugue_tpu_torch.column import functions as ff
from fugue_tpu_torch.column.expressions import _FuncExpr, col
from fugue_tpu_torch.kernels import build
from fugue_tpu_torch.kernels import expr_codegen as cg
from fugue_tpu_torch.kernels import expr_program as ep
from fugue_tpu_torch.kernels.reference import expr_program_reference

CPU = torch.device("cpu")
N = 701
SHIM = Path(__file__).resolve().with_name("k6_host_shim.h")


def _string_frame(n: int) -> Any:
    return chip_smoke.k6_string_frame(CPU, n, chip_smoke.STRING_SEED)


def _cases(string_frame: Any) -> List[Tuple[str, str, List[Any], bool]]:
    """``(frame, label, expressions, filter mode)`` of every program."""
    out = [("k6", label, exprs, filt)
           for label, exprs, filt in chip_smoke.k6_cases() + chip_smoke.k6_path_programs()]
    out += [("str", label, exprs, filt)
            for label, exprs, filt in chip_smoke.k6_string_cases(string_frame)]
    return out


LABELS = [label for _, label, _, _ in _cases(_string_frame(1))]


def _compile(blocks: Any, exprs: List[Any], filt: bool) -> ep.Program:
    cols = {n: (c.data.dtype, c.mask is not None) for n, c in blocks.columns.items()}
    dicts = {n: c.dictionary for n, c in blocks.columns.items() if c.is_string}
    return ep.compile_program(exprs, [torch.bool] if filt else [None] * len(exprs), cols, dicts,
                              CPU)


def _variants(n: int, filt: bool) -> List[Dict[str, Any]]:
    if not filt:
        return [{}]
    gen = torch.Generator().manual_seed(5)
    return [{"nrows": n}, {"nrows": n - 3}, {"row_valid": torch.rand((n,), generator=gen) < 0.6}]


_DRIVER = """
extern "C" int run_{name}(const void* params, int vec) {{
  using namespace {ns};
  const Params& p = *static_cast<const Params*>(params);
  int kept = 0;
  long long r = 0;
  if (vec) {{  // the vector path: rows in groups of {w}, then the rest one at a time
    for (; r + {w} <= p.n; r += {w}) {{
      Row x[{w}];
      Out y[{w}];
      loadv(p, r, x);
      for (int j = 0; j < {w}; ++j) kept += row(p, r + j, x[j], y[j]);
      storev(p, r, y);
    }}
  }}
  for (; r < p.n; ++r) {{
    Row x;
    Out y;
    load(p, r, x);
    kept += row(p, r, x, y);
    store(p, r, y);
  }}
  return kept;
}}
"""


class HostKernels:
    """Generated kernels built for the host: ``run`` packs a program's
    parameters as the wrapper does and runs its device part row by row."""

    def __init__(self, kernels: List[cg.Kernel], where: Path):
        unique = {k.name: k for k in kernels}
        src = where / "k6_host.cpp"
        src.write_text(f'#include "{SHIM}"\n#include "expr_ops.cuh"\n\n' + "\n".join(
            k.device_part + _DRIVER.format(name=k.name, ns=k.namespace, w=k.vec_width)
            for k in unique.values()))
        lib = where / "k6_host.so"
        proc = subprocess.run(
            ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-w",
             f"-I{build.KERNEL_DIR}", "-o", str(lib), str(src)],
            capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        self.lib = ctypes.CDLL(str(lib))
        for name in unique:
            fn = getattr(self.lib, f"run_{name}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
            fn.restype = ctypes.c_int

    def run(self, kernel: cg.Kernel, prog: ep.Program, inputs: List[Any], n: int,
            nrows: Any = None, row_valid: Any = None, vec: bool = False) -> Any:
        filt = kernel.mode != "columns"
        keep = count = None
        outs: List[Any] = []
        if filt:
            keep = torch.zeros((n,), dtype=torch.bool)
            count = torch.zeros((), dtype=torch.int32)
        else:
            outs = [(torch.zeros((n,), dtype=ep.DTYPES[o.dtype]),
                     None if not o.masked else inputs[q][1] if q is not None
                     else torch.zeros((n,), dtype=torch.bool))
                    for o, q in zip(prog.outputs, kernel.mask_aliases)]
        params, aligned = ep.pack_params(kernel, prog, inputs, outs, n,
                                         -1 if nrows is None else nrows, row_valid, keep,
                                         count)
        assert aligned or not vec  # CPU tensors are aligned for vectors
        buf = ctypes.create_string_buffer(params, len(params))
        kept = getattr(self.lib, f"run_{kernel.name}")(buf, int(vec))
        if filt:
            return keep, torch.tensor(kept, dtype=torch.int32)
        return outs


def _kernel(prog: ep.Program, inputs: List[Any], rows: Dict[str, Any]) -> cg.Kernel:
    mode = ep._mode(bool(rows), rows.get("row_valid"))
    return cg.generate(cg.structure(prog, [m is not None for _, m in inputs], mode))


@pytest.fixture(scope="module")
def host(tmp_path_factory: Any) -> Any:
    """Every case's runs: ``label -> [(kernel, program, inputs, rows,
    vector path, expressions, filter mode)]``, and the host build of all
    their kernels."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the generated code for the host")
    frames = {"k6": chip_smoke.k6_frame(CPU, N, chip_smoke.SEED), "str": _string_frame(N)}
    runs: Dict[str, List[Any]] = {}
    kernels = []
    for frame, label, exprs, filt in _cases(frames["str"]):
        blocks = frames[frame]
        prog = _compile(blocks, exprs, filt)
        inputs = [(blocks.columns[n].data, blocks.columns[n].mask) for n, _ in prog.inputs]
        for rows in _variants(N, filt):
            kernel = _kernel(prog, inputs, rows)
            kernels.append(kernel)
            for vec in (False, True):
                runs.setdefault(label, []).append((kernel, prog, inputs, rows, vec, exprs, filt))
    return runs, HostKernels(kernels, tmp_path_factory.mktemp("k6_host"))


@pytest.mark.parametrize("label", LABELS)
def test_generated_kernel_matches_the_twin_on_the_host(host, label):
    runs, lib = host
    for kernel, prog, inputs, rows, vec, exprs, filt in runs[label]:
        got = lib.run(kernel, prog, inputs, N, rows.get("nrows"), rows.get("row_valid"), vec)
        want = expr_program_reference(prog, inputs, N, device=CPU,
                                      **(dict(filter=True, **rows) if filt else {}))
        try:
            chip_smoke.check_k6(f"{label} {sorted(rows)} vec={vec}", exprs, filt, got, want)
        except SystemExit as e:
            pytest.fail(str(e))


# --- the key: the structure only -----------------------------------------

COLS = {"v": (torch.float32, True), "w": (torch.float64, False), "i": (torch.int32, True)}


def _name(exprs: List[Any], masked: Any = None, mode: str = "columns",
          cols: Dict[str, Any] = COLS, dicts: Any = None) -> str:
    out = [torch.bool] if mode != "columns" else [None] * len(exprs)
    prog = ep.compile_program(exprs, out, cols, dicts)
    if masked is None:
        masked = [cols[name][1] for name, _ in prog.inputs]
    return cg.generate(cg.structure(prog, masked, mode)).name


def test_key_ignores_literals_and_table_contents():
    """``v < 0.9`` and ``v < 0.5`` share one kernel, as do ``round`` by 2
    and 3 digits and a divisor of 3.0 and 7.0; a LIKE over two
    dictionaries of other entries and lengths shares one, and so does
    a compare against two different strings."""
    v = col("v")
    assert _name([v < 0.9]) == _name([v < 0.5])
    assert _name([v < 0.9], mode="prefix") == _name([v < 0.5], mode="prefix")
    assert _name([_FuncExpr("round", col("w"), 2)]) == _name([_FuncExpr("round", col("w"), 3)])
    assert _name([col("w") / 3.0]) == _name([col("w") / 7.0])
    cols = {"s": (torch.int32, True)}
    small = {"s": np.array(["a", "b", "c"], dtype=object)}
    large = {"s": np.array([f"x{i}" for i in range(500)], dtype=object)}
    like = [ff.like(col("s"), "a%")]
    assert _name(like, cols=cols, dicts=small) == _name(like, cols=cols, dicts=large)
    assert (_name([col("s") == "b"], cols=cols, dicts=small)
            == _name([col("s") == "x7"], cols=cols, dicts=large))


@pytest.mark.parametrize("change", ["dtype", "mask", "opcode", "mode", "output_dtype"])
def test_key_changes_with_the_structure(change):
    base = _name([col("v") < 0.5])
    other = {
        "dtype": lambda: _name([col("w") < 0.5]),
        "mask": lambda: _name([col("v") < 0.5], masked=[False]),
        "opcode": lambda: _name([col("v") <= 0.5]),
        "mode": lambda: _name([col("v") < 0.5], mode="prefix"),
        "output_dtype": lambda: _name([(col("v") < 0.5).cast(pa.int32())]),
    }[change]()
    assert other != base


def test_every_mode_makes_its_own_kernel():
    names = {_name([col("v") < 0.5], mode=m) for m in cg.MODES}
    assert len(names) == 3 and all(n.startswith("expr_program") for n in names)


def test_parameters_past_a_launchs_limit_go_through_device_memory():
    """A program whose ``Params`` would pass ``PARAM_LIMIT`` bytes takes
    them by a device pointer; its row code is the same."""
    prog = ep.compile_program([col("v") + 1.5], [None], COLS)
    key = cg.structure(prog, [True], "columns")
    direct, indirect = cg.generate(key), cg.generate(key, param_limit=16)
    assert not direct.indirect and indirect.indirect
    assert "__grid_constant__" in direct.source and "__restrict__ pp" in indirect.source
    assert direct.fields == indirect.fields
    assert direct.device_part.replace(direct.namespace, "") == \
        indirect.device_part.replace(indirect.namespace, "")


def test_generator_refuses_a_register_read_before_it_is_written():
    prog = ep.Program((("a", ep.I32),), (ep.Instr(ep.OP["ADD"], ep.I32, 1, 0, 5),),
                      (ep.Output(1, ep.I32, False),), 2, (False,))
    with pytest.raises(ValueError, match="r5"):
        cg.generate(cg.structure(prog, [False], "columns"))


# --- builds: once per structure, a failure raises with nvcc's output ------

def _fake_nvcc(tmp_path: Path, fail: bool) -> str:
    script = tmp_path / "nvcc"
    body = 'echo "error: no such intrinsic" >&2; exit 2' if fail else \
        'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then : > "$2"; fi; shift; done'
    script.write_text(f"#!/bin/sh\n{body}\n")
    script.chmod(0o755)
    return str(script)


def test_programs_differing_in_literals_or_tables_build_once(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    fake = _fake_nvcc(tmp_path, fail=False)
    monkeypatch.setattr(build, "nvcc", lambda: fake)
    monkeypatch.setattr(ep.expr_program_cuda, "builds", 0)
    monkeypatch.setattr(ep.expr_program_cuda, "build_seconds", 0.0)
    progs = [ep.compile_program([col("v") < x], [torch.bool], COLS) for x in (0.9, 0.5, 0.1)]
    kernels = ep.build_kernels([(p, [True], "prefix") for p in progs])
    assert len({k.name for k in kernels}) == 1 and ep.expr_program_cuda.builds == 1
    ep.build_kernels([(progs[0], [True], "prefix")])  # on disk already
    assert ep.expr_program_cuda.builds == 1
    ep.build_kernels([(progs[0], [True], "row_valid"), (progs[0], [False], "prefix")])
    assert ep.expr_program_cuda.builds == 3
    cubins = sorted(p.name for p in ep.kernel_dir().glob("*.cubin"))
    assert len(cubins) == 3 and all(c.startswith("expr_program_") for c in cubins)
    assert all((ep.kernel_dir() / c.replace(".cubin", ".cu")).exists() for c in cubins)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    fake = _fake_nvcc(tmp_path, fail=True)
    monkeypatch.setattr(build, "nvcc", lambda: fake)
    prog = ep.compile_program([col("v") * 2], [None], COLS)
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        ep.build_kernels([(prog, [True], "columns")])
    assert not list(ep.kernel_dir().glob("*.cubin"))


def test_many_immediates_take_the_device_memory_route():
    """``k6_cases``' ``params_in_memory``: 4,100 immediates put the
    parameters past a launch's 32,764 bytes; the host run above holds
    its result, and here its kernel takes them by a pointer."""
    exprs = dict((label, e) for label, e, _ in chip_smoke.k6_cases())["params_in_memory"]
    blocks = chip_smoke.k6_frame(CPU, 4, chip_smoke.SEED)
    prog = _compile(blocks, exprs, False)
    kernel = _kernel(prog, [(None, blocks.columns["i64"].mask)], {})
    assert kernel.indirect and 8 * len(kernel.fields) > cg.PARAM_LIMIT


# --- float16 on the host ------------------------------------------------------

def _doubles_near_half_ties(n: int) -> np.ndarray:
    """float64 values around float16's midpoints (a midpoint plus or minus
    2^-30 of it, where float32's nearest would make a tie), random ones
    over float16's whole range and past it, and the special values."""
    rng = np.random.default_rng(29)
    h = (rng.standard_normal(n) * np.exp2(rng.integers(-24, 16, n))).astype(np.float16)
    up = np.nextafter(h, np.float16(np.inf)).astype(np.float64)
    mid = (h.astype(np.float64) + up) / 2
    near = mid * (1 + rng.choice([-1.0, 1.0], n) * 2.0**-30)
    wide = rng.standard_normal(n) * np.exp2(rng.uniform(-30, 18, n))
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 65519.99, 65520.0, 1e300, 2.0**-25,
                        2.0**-25 * (1 + 2.0**-40), 1 + 2.0**-11 + 2.0**-30])
    return np.concatenate([near, mid, wide, special])


def test_float16_programs_match_numpy_on_the_host(tmp_path):
    """A host build of programs over float16 (under the shim's integer
    float16 conversions): ``h * 2`` and ``h + h`` rounded once an
    operation, and a float64 stored as float16 (``HALF`` of an F64: float32
    rounded to odd, then to nearest), each on its scalar and vector path,
    bit for bit against numpy's float16 and the twin."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the generated code for the host")
    d = _doubles_near_half_ties(400)
    n = len(d)
    h = np.concatenate([d.astype(np.float16)[: n - 6],
                        np.array([60000, -60000, 65504, 6e-8, -0.0, 0.0], np.float16)])
    inputs = {"h": (torch.from_numpy(h), None), "d": (torch.from_numpy(d), None)}
    cols = {"h": (torch.float16, False, pa.float16()), "d": (torch.float64, False)}
    cases = [([col("h") * 2], h * np.float16(2)), ([col("h") + col("h")], h + h),
             ([col("d")], d.astype(np.float16))]
    progs = [ep.compile_program(exprs, [torch.float16], cols, {}, CPU) for exprs, _ in cases]
    args = [[inputs[name] for name, _ in p.inputs] for p in progs]
    kernels = [_kernel(p, a, {}) for p, a in zip(progs, args)]
    lib = HostKernels(kernels, tmp_path)
    for (exprs, want), prog, a, kernel in zip(cases, progs, args, kernels):
        twin, = expr_program_reference(prog, a, n, device=CPU)
        np.testing.assert_array_equal(twin[0].numpy().view(np.int16), want.view(np.int16))
        for vec in (False, True):
            (got, _), = lib.run(kernel, prog, a, n, vec=vec)
            assert got.dtype == torch.float16
            np.testing.assert_array_equal(got.numpy().view(np.int16), want.view(np.int16),
                                          err_msg=f"{exprs[0]} vec={vec}")
