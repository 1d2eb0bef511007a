from fugue_tpu_torch.dataframe.array_dataframe import ArrayDataFrame
from fugue_tpu_torch.dataframe.arrow_dataframe import ArrowDataFrame
from fugue_tpu_torch.dataframe.dataframe import (
    DataFrame,
    LocalBoundedDataFrame,
    LocalDataFrame,
)

__all__ = ["ArrayDataFrame", "ArrowDataFrame", "DataFrame", "LocalBoundedDataFrame",
           "LocalDataFrame"]
