"""The port's block layer (``fugue_tpu_torch/torch_backend/blocks.py``)
against the JAX package's (``fugue_tpu/jax_backend/blocks.py``).

Arrow -> blocks -> arrow must give back the same table exactly, for every
type the port holds, with and without nulls; key stats, padded row count
and device bytes must equal the JAX package's on one device. Inputs come
from a seeded numpy generator."""

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from fugue_tpu.jax_backend import blocks as jblocks
from fugue_tpu.schema import Schema as JSchema
from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.torch_backend import blocks as tblocks

CPU = torch.device("cpu")

_TYPES = {
    "int8": pa.int8(),
    "int16": pa.int16(),
    "int32": pa.int32(),
    "int64": pa.int64(),
    "uint8": pa.uint8(),
    "float32": pa.float32(),
    "float64": pa.float64(),
    "bool": pa.bool_(),
}


def _column(tp: pa.DataType, n: int, nulls: bool, seed: int) -> pa.Array:
    rng = np.random.default_rng(seed)
    if pa.types.is_boolean(tp):
        values = rng.random(n) < 0.5
    elif pa.types.is_floating(tp):
        values = (rng.standard_normal(n) * 1e3).astype(tp.to_pandas_dtype())
    else:
        info = np.iinfo(tp.to_pandas_dtype())
        lo = max(int(info.min), -(2**40))
        hi = min(int(info.max), 2**40)
        values = rng.integers(lo, hi, n, endpoint=True).astype(tp.to_pandas_dtype())
    mask = (rng.random(n) < 0.2) if nulls else None
    return pa.array(values, type=tp, mask=mask)


def _jax_blocks(table: pa.Table) -> jblocks.JaxBlocks:
    mesh = jblocks.make_mesh([jax.devices()[0]])
    return jblocks.from_arrow(table, JSchema(table.schema), mesh)


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("name", sorted(_TYPES))
def test_arrow_round_trip(name, nulls):
    tp = _TYPES[name]
    table = pa.table({"a": _column(tp, 1000, nulls, 7), "b": _column(pa.int32(), 1000, False, 8)})
    schema = Schema(table.schema)
    blocks = tblocks.from_arrow(table, schema, CPU)
    back = tblocks.to_arrow(blocks, schema)
    assert back.schema == table.schema
    assert back.equals(table)  # exact, nulls included
    assert blocks.columns["a"].data.dtype == tblocks.torch_dtype(tp)
    assert (blocks.columns["a"].mask is not None) == nulls


@pytest.mark.parametrize("n", [0, 1, 1000])
@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("name", sorted(_TYPES))
def test_stats_padding_and_bytes_match_jax(name, nulls, n):
    table = pa.table({"a": _column(_TYPES[name], n, nulls, 11)})
    port = tblocks.from_arrow(table, Schema(table.schema), CPU)
    ref = _jax_blocks(table)
    assert port.columns["a"].stats == ref.columns["a"].stats
    assert port.padded_nrows == ref.padded_nrows
    assert port.nrows == ref.nrows == n
    assert tblocks.device_nbytes(port) == jblocks.device_nbytes(ref)
    np.testing.assert_array_equal(
        port.validity().numpy(), np.asarray(ref.validity())
    )


def test_masked_layout_compacts_on_export():
    table = pa.table({"a": pa.array([5, 6, 7, 8], type=pa.int64())})
    schema = Schema(table.schema)
    base = tblocks.from_arrow(table, schema, CPU)
    row_valid = torch.tensor([True, False, True, False])
    masked = tblocks.TorchBlocks(
        None, base.columns, CPU, row_valid=row_valid, nrows_dev=row_valid.sum()
    )
    assert not masked.nrows_known
    assert tblocks.to_arrow(masked, schema).column("a").to_pylist() == [5, 7]
    assert masked.nrows == 2


@pytest.mark.parametrize(
    "arr,case",
    [
        (pa.array([1, 2, 3], type=pa.uint32()), "uint16-64 or float16"),
        (pa.array([1, 2, 3], type=pa.uint16()), "uint16-64 or float16"),
        (pa.array(np.array([1, 2, 3], dtype=np.float16)), "uint16-64 or float16"),
        (pa.array([b"x", None, b"yz"]), "a binary column"),
        (pa.array([[1], None, [2, 3]]), "a nested"),
        (pa.array([1, None, 3], type=pa.decimal128(10, 2)), "a decimal column"),
        (pa.array([None, None, None]), "null type"),
    ],
    ids=["uint32", "uint16", "float16", "binary", "list", "decimal", "null"],
)
def test_unported_types_raise(arr, case):
    """A type the card does not hold is refused, naming ROADMAP.md queue 1
    item 1 and the type's own case."""
    table = pa.table({"a": arr})
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 1") as info:
        tblocks.from_arrow(table, Schema(table.schema), CPU)
    assert case in str(info.value)


@pytest.mark.parametrize(
    "arr,codes",
    [
        (pa.array(["x", None, "z", "x"]), [0, 0, 1, 0]),
        (pa.array([1, None, 3, -7], type=pa.timestamp("us")), [1, 0, 3, -7]),
        (pa.array([1, None, 3, -7], type=pa.date32()), [1, 0, 3, -7]),
    ],
    ids=["string", "timestamp", "date"],
)
def test_string_and_temporal_columns_round_trip(arr, codes):
    """A string column is int32 codes with a host dictionary and ``(0,
    len - 1)`` stats; a timestamp int64 microseconds, a date int32 days,
    each with its ``(min, max)``; nulls are 0 in a mask. All come back
    as they went in."""
    table = pa.table({"a": arr})
    blocks = tblocks.from_arrow(table, Schema(table.schema), CPU)
    col = blocks.columns["a"]
    assert col.data.tolist() == codes and col.mask.tolist() == [True, False, True, True]
    if pa.types.is_string(arr.type):
        assert col.data.dtype == torch.int32 and list(col.dictionary) == ["x", "z"]
        assert col.stats == (0, 1)
    else:
        assert not col.is_string and col.stats == (-7, 3)
    assert tblocks.to_arrow(blocks, Schema(table.schema)).equals(table)
