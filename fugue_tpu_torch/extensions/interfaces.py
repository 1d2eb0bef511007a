"""The extension kinds (a copy of ``fugue_tpu/extensions/interfaces.py``):
``Creator``, ``Processor`` and ``Outputter`` run where the workflow runs,
with the engine; ``Transformer`` and ``CoTransformer`` are what a transform or a
cotransform of a zip runs, on the engine's map and comap."""

from abc import ABC, abstractmethod
from typing import Any

from fugue_tpu_torch.dataframe.array_dataframe import ArrayDataFrame
from fugue_tpu_torch.dataframe.dataframe import DataFrame
from fugue_tpu_torch.dataframe.dataframes import DataFrames
from fugue_tpu_torch.extensions.context import ExtensionContext

OUTPUT_TRANSFORMER_DUMMY_SCHEMA = "_fugue_output_dummy:int"


class Creator(ExtensionContext, ABC):
    """A frame from nothing."""

    @abstractmethod
    def create(self) -> DataFrame:  # pragma: no cover - interface
        raise NotImplementedError


class Processor(ExtensionContext, ABC):
    """Frames -> a frame, with the engine."""

    @abstractmethod
    def process(self, dfs: DataFrames) -> DataFrame:  # pragma: no cover
        raise NotImplementedError


class Outputter(ExtensionContext, ABC):
    """Frames -> a side effect, with the engine."""

    @abstractmethod
    def process(self, dfs: DataFrames) -> None:  # pragma: no cover
        raise NotImplementedError


class Transformer(ExtensionContext, ABC):
    """A map over each logical partition (``:38``)."""

    @abstractmethod
    def get_output_schema(self, df: DataFrame) -> Any:  # pragma: no cover
        raise NotImplementedError

    def on_init(self, df: DataFrame) -> None:  # pragma: no cover - hook
        pass

    @abstractmethod
    def transform(self, df: DataFrame) -> DataFrame:  # pragma: no cover
        raise NotImplementedError


class OutputTransformer(Transformer):
    """A transformer with no output."""

    def get_output_schema(self, df: DataFrame) -> Any:
        return OUTPUT_TRANSFORMER_DUMMY_SCHEMA

    @abstractmethod
    def process(self, df: DataFrame) -> None:  # pragma: no cover
        raise NotImplementedError

    def transform(self, df: DataFrame) -> DataFrame:
        self.process(df)
        return ArrayDataFrame([], OUTPUT_TRANSFORMER_DUMMY_SCHEMA)


class CoTransformer(ExtensionContext, ABC):
    """A map over the groups of a zip."""

    @abstractmethod
    def get_output_schema(self, dfs: DataFrames) -> Any:  # pragma: no cover
        raise NotImplementedError

    def on_init(self, dfs: DataFrames) -> None:  # pragma: no cover - hook
        pass

    @abstractmethod
    def transform(self, dfs: DataFrames) -> DataFrame:  # pragma: no cover
        raise NotImplementedError


class OutputCoTransformer(CoTransformer):
    def get_output_schema(self, dfs: DataFrames) -> Any:
        return OUTPUT_TRANSFORMER_DUMMY_SCHEMA

    @abstractmethod
    def process(self, dfs: DataFrames) -> None:  # pragma: no cover
        raise NotImplementedError

    def transform(self, dfs: DataFrames) -> DataFrame:
        self.process(dfs)
        return ArrayDataFrame([], OUTPUT_TRANSFORMER_DUMMY_SCHEMA)
