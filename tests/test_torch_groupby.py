"""The port's group-by pieces (``fugue_tpu_torch/torch_backend/groupby.py``
and the segment-sum twin ``fugue_tpu_torch/kernels/reference.py``) against
the JAX package's ``fugue_tpu/jax_backend/groupby.py`` on one device.

Tolerances: counts, int64 sums, segment ids, bin specs and decoded keys
exactly; float sums at rtol 1e-5 (float32) and 1e-6 (float64), since the
two sum the same rows in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from fugue_tpu.jax_backend import blocks as jblocks
from fugue_tpu.jax_backend import groupby as jgroupby
from fugue_tpu.schema import Schema as JSchema
from fugue_tpu_torch.kernels import build
from fugue_tpu_torch.kernels.reference import segment_sums_reference
from fugue_tpu_torch.kernels.segment_sums import segment_sums_cuda
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend import blocks as tblocks
from fugue_tpu_torch.torch_backend import groupby

CPU = torch.device("cpu")
_RTOL = {np.float32: 1e-5, np.float64: 1e-6}


def _payloads(seed: int, n: int, total: int, fdtype):
    rng = np.random.default_rng(seed)
    seg = rng.integers(-3, total + 3, n).astype(np.int32)  # negative + sentinel rows
    floats = [(rng.standard_normal(n) * 10).astype(fdtype) for _ in range(2)]
    counts = [rng.random(n) < p for p in (0.5, 0.9)]
    ints = [rng.integers(-(2**40), 2**40, n).astype(np.int64) for _ in range(2)]
    edge = np.array([2**40 - 1, -(2**40), 2**40 - 3, -(2**40) + 7, 0])
    ints[1][: min(n, 5)] = edge[: min(n, 5)]
    return seg, floats, counts, ints


def _jax_sums(seg, floats, counts, ints, total):
    f, c, i = jgroupby.segment_sums(
        [jnp.asarray(x) for x in floats],
        [jnp.asarray(x) for x in counts],
        jnp.asarray(seg),
        total,
        strategy="scatter",
        int_payloads=[jnp.asarray(x) for x in ints],
    )
    return [np.asarray(x) for x in f], [np.asarray(x) for x in c], [np.asarray(x) for x in i]


@pytest.mark.parametrize("fdtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,total", [(1, 7), (5000, 97), (20000, 1024)])
def test_segment_sums_reference_matches_jax_scatter(fdtype, n, total):
    seg, floats, counts, ints = _payloads(3, n, total, fdtype)
    jf, jc, ji = _jax_sums(seg, floats, counts, ints, total)
    t = torch.from_numpy
    f, c, i = segment_sums_reference(
        t(seg), t(np.stack(floats)), t(np.stack(counts)), t(np.stack(ints)), total
    )
    assert f.dtype == torch.from_numpy(floats[0]).dtype
    assert c.dtype == torch.int32 and i.dtype == torch.int64
    for got, want in zip(f.numpy(), jf):
        np.testing.assert_allclose(got, want, rtol=_RTOL[fdtype], atol=0)
    for got, want in zip(c.numpy(), jc):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(i.numpy(), ji):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fdtype", [np.float32, np.float64])
def test_segment_sums_dispatch_matches_jax(fdtype):
    """``groupby.segment_sums`` packs lists of payloads (widest float
    dtype, int32 counts, int64 ints) and routes a CPU ``seg`` to the twin."""
    seg, floats, counts, ints = _payloads(5, 4000, 50, fdtype)
    floats = [floats[0], floats[1].astype(np.float32)]  # mixed widths widen
    jf, jc, ji = _jax_sums(seg, floats, counts, ints, 50)
    t = torch.from_numpy
    f, c, i = groupby.segment_sums(
        [t(x) for x in floats], [t(x) for x in counts], t(seg), 50,
        int_payloads=[t(x) for x in ints],
    )
    assert len(f) == 2 and len(c) == 2 and len(i) == 2
    for got, want in zip(f, jf):
        assert got.numpy().dtype == want.dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=_RTOL[fdtype], atol=0)
    for got, want in zip(c + i, jc + ji):
        np.testing.assert_array_equal(got.numpy(), want)


def test_segment_sums_no_payload_kinds():
    seg = torch.tensor([0, 1, 1, 5], dtype=torch.int32)
    f, c, i = groupby.segment_sums([], [torch.tensor([True, True, False, True])], seg, 2)
    assert f == [] and i == []
    assert c[0].tolist() == [1, 1]


def test_segment_sums_reference_counts_nonzero_uint8_flags():
    """A uint8 count pack is read as flags, as ``segment_sums.cu`` reads
    it: the rows whose byte is non-zero are counted, whatever the value.
    Exact against numpy, and equal to the same pack given as bool."""
    rng = np.random.default_rng(11)
    n, total = 3000, 40
    seg = rng.integers(-2, total + 2, n).astype(np.int32)
    flags = rng.integers(0, 4, (2, n)).astype(np.uint8)
    empty_f = torch.empty((0, n), dtype=torch.float32)
    empty_i = torch.empty((0, n), dtype=torch.int64)
    _, c, _ = segment_sums_reference(
        torch.from_numpy(seg), empty_f, torch.from_numpy(flags), empty_i, total
    )
    _, b, _ = segment_sums_reference(
        torch.from_numpy(seg), empty_f, torch.from_numpy(flags != 0), empty_i, total
    )
    keep = (seg >= 0) & (seg < total)
    for p in range(2):
        want = np.bincount(seg[keep], weights=flags[p][keep] != 0, minlength=total)
        np.testing.assert_array_equal(c[p].numpy(), want.astype(np.int64))
    assert c.dtype == torch.int32
    assert torch.equal(c, b)


def test_kernel_wrapper_refuses_cpu_tensors():
    seg = torch.zeros(4, dtype=torch.int32)
    empty = torch.empty((0, 4))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        segment_sums_cuda(seg, empty, empty.bool(), empty.long(), 3)


def test_build_is_keyed_by_source(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "KERNEL_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "k.cu").write_text("// one\n")
    first = build.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    assert build.library_path("k") != first
    assert build.sources() == ["k"]


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def _frames(table: pa.Table):
    port = tblocks.from_arrow(table, Schema(table.schema), CPU)
    ref = jblocks.from_arrow(
        table, JSchema(table.schema), jblocks.make_mesh([jax.devices()[0]])
    )
    return port, ref


def _key_table(case: str, n: int = 3000) -> pa.Table:
    rng = np.random.default_rng(17)
    if case == "one_key":
        return pa.table({"k": pa.array(rng.integers(-20, 45, n).astype(np.int32))})
    if case == "two_keys":
        return pa.table({
            "a": pa.array(rng.integers(0, 9, n).astype(np.int32)),
            "b": pa.array(rng.integers(-(2**20), -(2**20) + 13, n).astype(np.int64)),
        })
    assert case == "nullable_key"
    k = rng.integers(3, 30, n).astype(np.int16)
    return pa.table({"k": pa.array(k, mask=rng.random(n) < 0.25)})


@pytest.mark.parametrize("from_device", [False, True])
@pytest.mark.parametrize("case", ["one_key", "two_keys", "nullable_key"])
def test_binning_matches_jax(case, from_device):
    table = _key_table(case)
    keys = table.column_names
    port, ref = _frames(table)
    if from_device:  # bounds from the one min/max readback, not ingest
        for k in keys:
            port.columns[k].stats = None
            ref.columns[k].stats = None
    spec = groupby.bin_spec(port, keys)
    jspec = jgroupby.bin_spec(ref, keys)
    assert spec is not None and tuple(spec) == tuple(jspec)
    seg = groupby.inline_seg(
        spec,
        {k: port.columns[k].data for k in keys},
        {k: port.columns[k].mask for k in keys},
        port.validity(),
    )
    jseg = jgroupby.inline_seg(
        jspec,
        {k: ref.columns[k].data for k in keys},
        {k: ref.columns[k].mask for k in keys if ref.columns[k].mask is not None},
        ref.validity(),
    )
    assert seg.dtype == torch.int32
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    dtypes = {k: port.columns[k].data.dtype for k in keys}
    decoded = groupby.decode_bin_keys(spec, dtypes, CPU)
    jdecoded = jgroupby.decode_bin_keys(jspec, {k: ref.columns[k].data.dtype for k in keys})
    for k in keys:
        (v, m), (jv, jm) = decoded[k], jdecoded[k]
        assert v.dtype == dtypes[k]
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        assert (m is None) == (jm is None)
        if m is not None:
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_bin_spec_refuses_float_and_wide_keys():
    table = pa.table({
        "f": pa.array([1.0, 2.0], type=pa.float32()),
        "w": pa.array([0, groupby._MAX_BINS], type=pa.int64()),
    })
    port, _ = _frames(table)
    assert groupby.bin_spec(port, ["f"]) is None
    assert groupby.bin_spec(port, ["w"]) is None


def test_narrow_key_with_wide_span_bins_exactly():
    """An int8 key spanning more than 127 values: ``key - min`` does not
    fit int8, so the port widens first. (The JAX package computes it in
    int8 and wraps; this case is held against numpy, not against it.)"""
    k = np.array([-100, 0, 100, 27, -100], dtype=np.int8)
    port, _ = _frames(pa.table({"k": pa.array(k)}))
    spec = groupby.bin_spec(port, ["k"])
    seg = groupby.inline_seg(spec, {"k": port.columns["k"].data}, {"k": None}, port.validity())
    np.testing.assert_array_equal(seg.numpy(), k.astype(np.int64) + 100)


def test_wide_int64_key_decodes_exactly():
    """An int64 key whose minimum lies outside int32: the decoded key
    values must be the keys themselves. (The JAX package adds the minimum
    to an int32 code and wraps, so this case is held against numpy.)"""
    b = np.array([-(2**40), -(2**40) + 1, -(2**40) + 1, -(2**40) + 9], dtype=np.int64)
    port, _ = _frames(pa.table({"b": pa.array(b)}))
    spec = groupby.bin_spec(port, ["b"])
    seg = groupby.inline_seg(spec, {"b": port.columns["b"].data}, {"b": None}, port.validity())
    values, mask = groupby.decode_bin_keys(spec, {"b": torch.int64}, CPU)["b"]
    assert mask is None
    np.testing.assert_array_equal(values.numpy()[seg.numpy()], b)
