"""``DataFrameTests`` (the reference's frame conformance suite,
``fugue_tpu_test/dataframe_suite.py``) on the port's ``TorchDataFrame``,
built on the CPU through the engine's ``to_df(rows, schema)``."""

from typing import Any

from fugue_tpu.dataframe.utils import df_eq
from fugue_tpu_test.dataframe_suite import DataFrameTests

from fugue_tpu_torch.torch_backend.dataframe import TorchDataFrame
from fugue_tpu_torch.torch_backend.execution_engine import TorchExecutionEngine

_ENGINE = TorchExecutionEngine(device="cpu")


class TestTorchDataFrame(DataFrameTests.Tests):
    def df(self, data: Any = None, schema: Any = None) -> TorchDataFrame:
        return _ENGINE.to_df([] if data is None else data, schema)

    def test_as_local(self):
        # ``df_eq`` takes the frame through the reference's ``as_fugue_df``,
        # which does not know the port's local frame: the comparison goes
        # through ``as_arrow()`` instead, the rest as the suite has it
        df = self.df([[1, "a"]], "a:long,b:str")
        local = df.as_local()
        assert local.is_local
        assert df_eq(local.as_arrow(), [[1, "a"]], "a:long,b:str", throw=True)
