"""The port's conf keys: the reference's two streaming knobs
(``fugue_tpu/constants.py:43-44``, registered at ``:296-310``) under the
port's name, and the workflow's keys (``:22-35``, ``:102``, ``:121``,
defaults in ``_declare_defaults``, ``:204``), with the same types and
defaults but for the hidden module prefix, which is the port's."""

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

FUGUE_CONF_ANALYSIS = "fugue.analysis"
FUGUE_CONF_OPTIMIZE = "fugue.optimize"
FUGUE_CONF_WORKFLOW_CONCURRENCY = "fugue.workflow.concurrency"
FUGUE_CONF_WORKFLOW_CHECKPOINT_PATH = "fugue.workflow.checkpoint.path"
FUGUE_CONF_WORKFLOW_RETRY_MAX_ATTEMPTS = "fugue.workflow.retry.max_attempts"
FUGUE_CONF_WORKFLOW_TIMEOUT = "fugue.workflow.timeout"
FUGUE_CONF_WORKFLOW_RESUME = "fugue.workflow.resume"
FUGUE_CONF_WORKFLOW_EXCEPTION_HIDE = "fugue.workflow.exception.hide"
FUGUE_CONF_WORKFLOW_EXCEPTION_INJECT = "fugue.workflow.exception.inject"
FUGUE_CONF_WORKFLOW_EXCEPTION_OPTIMIZE = "fugue.workflow.exception.optimize"
FUGUE_CONF_RPC_SERVER = "fugue.rpc.server"
FUGUE_CONF_OBS_ENABLED = "fugue.obs.enabled"

_DEFAULTS: Dict[str, Any] = {
    FUGUE_CONF_TORCH_IO_BATCH_ROWS: 0,
    FUGUE_CONF_TORCH_IO_PIPELINE: True,
    FUGUE_CONF_ANALYSIS: "warn",
    FUGUE_CONF_OPTIMIZE: "auto",
    FUGUE_CONF_WORKFLOW_CONCURRENCY: 1,
    FUGUE_CONF_WORKFLOW_CHECKPOINT_PATH: "",
    FUGUE_CONF_WORKFLOW_RETRY_MAX_ATTEMPTS: 1,
    FUGUE_CONF_WORKFLOW_TIMEOUT: 0.0,
    FUGUE_CONF_WORKFLOW_RESUME: False,
    FUGUE_CONF_WORKFLOW_EXCEPTION_HIDE: "fugue_tpu_torch.",
    FUGUE_CONF_WORKFLOW_EXCEPTION_INJECT: 3,
    FUGUE_CONF_WORKFLOW_EXCEPTION_OPTIMIZE: True,
    FUGUE_CONF_RPC_SERVER: "native",
    FUGUE_CONF_OBS_ENABLED: False,
}


def typed_conf_get(conf: Dict[str, Any], key: str) -> Any:
    """``conf[key]`` as its default's type (an int, a float, a string, or a
    bool that may be given as ``"true"``/``"false"``), or the default where
    unset (``fugue_tpu/constants.py`` ``typed_conf_get``)."""
    default = _DEFAULTS[key]
    value = dict.get(conf, key, default)
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes", "on")
        return bool(value)
    if isinstance(default, str):
        return str(value)
    return type(default)(value or 0)
