"""A minimal ``DataFrame`` base: a schema-carrying frame that converts to
arrow and pandas (trimmed from ``fugue_tpu/dataframe/dataframe.py:23``)."""

from abc import ABC, abstractmethod

import pandas as pd
import pyarrow as pa

from fugue_tpu_torch.schema import Schema


class DataFrame(ABC):
    def __init__(self, schema: Schema):
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    @abstractmethod
    def is_local(self) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    @abstractmethod
    def count(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    @abstractmethod
    def as_arrow(self) -> pa.Table:  # pragma: no cover - interface
        raise NotImplementedError

    def as_pandas(self) -> pd.DataFrame:
        return self.as_arrow().to_pandas(
            ignore_metadata=True, date_as_object=False
        )
