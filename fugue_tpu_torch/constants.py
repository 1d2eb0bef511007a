"""The port's conf keys for file I/O: the reference's two streaming knobs
(``fugue_tpu/constants.py:43-44``, registered at ``:296-310``) under the
port's name, with the same types and defaults."""

from typing import Any, Dict

# streamed parquet ingest: 0 = eager (the whole table read, then
# uploaded); > 0 reads record batches of this many rows into pinned
# slabs that ship on a copy stream while later batches decode, and bounds
# the row groups of a save
FUGUE_CONF_TORCH_IO_BATCH_ROWS = "fugue.torch.io.batch_rows"
# with batch_rows > 0, a save of a prefix frame copies chunk k + 1 from the
# card while chunk k parquet-encodes (the reference's save half; its load
# half warms an executable cache the port does not have)
FUGUE_CONF_TORCH_IO_PIPELINE = "fugue.torch.io.pipeline"

_DEFAULTS: Dict[str, Any] = {
    FUGUE_CONF_TORCH_IO_BATCH_ROWS: 0,
    FUGUE_CONF_TORCH_IO_PIPELINE: True,
}


def typed_conf_get(conf: Dict[str, Any], key: str) -> Any:
    """``conf[key]`` as its default's type (an int, or a bool that may be
    given as ``"true"``/``"false"``), or the default where unset
    (``fugue_tpu/constants.py`` ``typed_conf_get``)."""
    default = _DEFAULTS[key]
    value = conf.get(key, default)
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes")
        return bool(value)
    return type(default)(value or 0)
