"""``DataFrames``: the frames a processor, an outputter or a cotransformer
takes, all named or all positional (a copy of
``fugue_tpu/dataframe/dataframes.py:10``)."""

from typing import Any, Dict

from fugue_tpu_torch.dataframe.dataframe import DataFrame
from fugue_tpu_torch.torch_backend.zipped import TorchZippedDataFrame
from fugue_tpu_torch.utils.assertion import assert_or_throw


class DataFrames(Dict[str, Any]):
    """Named (dict-like) or unnamed (keyed ``_0, _1, ...``); mixing the two
    raises. A member may be a ``TorchZippedDataFrame``, the zip a
    cotransform reads."""

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__()
        self._has_dict_name = False
        for a in args:
            self._add(a)
        for k, v in kwargs.items():
            self._append_named(k, v)

    def _add(self, obj: Any) -> None:
        if obj is None:
            return
        if isinstance(obj, DataFrames):
            for k, v in obj.items():
                if obj.has_dict:
                    self._append_named(k, v)
                else:
                    self._append_unnamed(v)
        elif isinstance(obj, dict):
            for k, v in obj.items():
                self._append_named(k, v)
        elif isinstance(obj, (list, tuple)):
            for x in obj:
                self._add(x)
        else:
            self._append_unnamed(obj)

    def _check_df(self, name: str, df: Any) -> None:
        assert_or_throw(isinstance(df, (DataFrame, TorchZippedDataFrame)),
                        ValueError(f"{name}: {type(df)} is not a DataFrame"))
        assert_or_throw(name not in self, KeyError(f"duplicated name {name}"))

    def _append_named(self, name: str, df: Any) -> None:
        assert_or_throw(self._has_dict_name or len(self) == 0,
                        ValueError("can't mix named and unnamed dataframes"))
        self._check_df(name, df)
        self._has_dict_name = True
        super().__setitem__(name, df)

    def _append_unnamed(self, df: Any) -> None:
        assert_or_throw(not self._has_dict_name,
                        ValueError("can't mix named and unnamed dataframes"))
        name = f"_{len(self)}"
        self._check_df(name, df)
        super().__setitem__(name, df)

    @property
    def has_dict(self) -> bool:
        return self._has_dict_name

    def __getitem__(self, key: Any) -> Any:  # type: ignore[override]
        if isinstance(key, int):
            return list(self.values())[key]
        return super().__getitem__(key)
