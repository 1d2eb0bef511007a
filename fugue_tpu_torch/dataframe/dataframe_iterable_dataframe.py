"""A stream of local frames: a trimmed ``LocalDataFrameIterableDataFrame``
(``fugue_tpu/dataframe/dataframe_iterable_dataframe.py:53``).

It holds a schema and an iterator of pandas or arrow chunks, and is
consumed once. ``aggregate`` folds such a stream chunk by chunk into
accumulators on the card (``torch_backend/streaming.py``), so the whole
frame never has to be on the card or in host memory at once; any other
use materializes it (``as_arrow``)."""

from typing import Any, Iterable, Iterator, List, Optional

import pandas as pd
import pyarrow as pa

from fugue_tpu_torch.schema import Schema
from fugue_tpu_torch.utils.assertion import assert_or_throw


class LocalDataFrameIterableDataFrame:
    """Chunks (pandas frames or arrow tables) of one ``schema``, empty
    chunks skipped. Without a schema, the first non-empty chunk's is
    taken (read ahead once)."""

    def __init__(self, chunks: Optional[Iterable[Any]] = None, schema: Any = None):
        self._chunks: Iterator[Any] = iter(chunks if chunks is not None else [])
        self._ahead: List[Any] = []
        if schema is None:
            first = self._peek()
            assert_or_throw(first is not None,
                            ValueError("schema can't be inferred from an empty stream"))
            schema = chunk_table(first, None).schema
        self._schema = Schema(schema)

    def _peek(self) -> Optional[Any]:
        while not self._ahead:
            chunk = next(self._chunks, None)
            if chunk is None:
                return None
            if len(chunk) > 0:
                self._ahead.append(chunk)
        return self._ahead[0]

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def native(self) -> Iterator[Any]:
        """The chunks as given (pandas or arrow), each once."""
        while self._ahead:
            yield self._ahead.pop(0)
        for chunk in self._chunks:
            if len(chunk) > 0:
                yield chunk

    def arrow_chunks(self) -> Iterator[pa.Table]:
        """The chunks as arrow tables of the schema (``chunk_table``), each
        once."""
        for chunk in self.native:
            yield chunk_table(chunk, self._schema)

    def as_arrow(self) -> pa.Table:
        """Every remaining chunk in one arrow table of the schema."""
        tables = [chunk_table(c, self._schema) for c in self.native]
        if not tables:
            return self._schema.pa_schema.empty_table()
        return pa.concat_tables(tables)


def chunk_table(chunk: Any, schema: Optional[Schema]) -> pa.Table:
    """A chunk as an arrow table, typed by ``schema`` where given: an arrow
    chunk as it comes (cast where its types differ), a pandas chunk through
    ``pa.Table.from_pandas`` with the schema, so a nullable integer column
    never passes through float64."""
    if isinstance(chunk, pd.DataFrame):
        return pa.Table.from_pandas(chunk, preserve_index=False,
                                    schema=None if schema is None else schema.pa_schema)
    assert_or_throw(isinstance(chunk, pa.Table), ValueError(f"can't stream {type(chunk)}"))
    if schema is None or chunk.schema == schema.pa_schema:
        return chunk
    return chunk.cast(schema.pa_schema)
