"""Checkpoints (a port of ``fugue_tpu/workflow/checkpoint.py``:
``Checkpoint`` ``:23``, ``WeakCheckpoint`` ``:58``, ``StrongCheckpoint``
``:71``, ``CheckpointPath`` ``:226``). A weak checkpoint is the engine's
``persist``; a strong one saves the frame and loads it back through the
engine's ``save_df``/``load_df``, and a deterministic one names its file
by the task's id, so that a rerun of the same DAG loads it and skips the
task's work. The checkpoint path must be local: another scheme raises,
naming ROADMAP.md queue 1 item 13, as the engine's file I/O does. The
table checkpoint (``:157``, ``yield_table_as``) is ROADMAP.md queue 1
item 16."""

from typing import Any, Optional
from uuid import uuid4

from fugue_tpu_torch.collections.yielded import PhysicalYielded
from fugue_tpu_torch.constants import FUGUE_CONF_WORKFLOW_CHECKPOINT_PATH, typed_conf_get
from fugue_tpu_torch.utils.assertion import assert_or_throw
from fugue_tpu_torch.utils.hash import to_uuid


class Checkpoint:
    """No checkpoint."""

    @property
    def is_null(self) -> bool:
        return True

    @property
    def deterministic(self) -> bool:
        return False

    def run(self, df: Any, path: "CheckpointPath") -> Any:
        return df

    def try_load(self, path: "CheckpointPath") -> Optional[Any]:
        """The saved frame of a deterministic checkpoint whose file exists,
        so that the task skips its work; else None."""
        return None


class WeakCheckpoint(Checkpoint):
    def __init__(self, lazy: bool = False, **kwargs: Any):
        self._lazy = lazy
        self._kwargs = dict(kwargs)

    @property
    def is_null(self) -> bool:
        return False

    def run(self, df: Any, path: "CheckpointPath") -> Any:
        return path.execution_engine.persist(df, lazy=self._lazy, **self._kwargs)


class StrongCheckpoint(Checkpoint):
    def __init__(self, obj_id: str, deterministic: bool = False, permanent: bool = False,
                 lazy: bool = False, fmt: str = "parquet", partition: Any = None,
                 single: bool = False, namespace: Any = None, **save_kwargs: Any):
        assert_or_throw(not deterministic or permanent,
                        ValueError("deterministic checkpoint must be permanent"))
        assert_or_throw(not lazy, NotImplementedError("lazy strong checkpoint"))
        self._obj_id = obj_id
        self._deterministic = deterministic
        self._permanent = permanent
        self._fmt = fmt
        self._single = single
        self._namespace = namespace
        self._save_kwargs = dict(save_kwargs)
        self.yielded: Optional[PhysicalYielded] = None

    @property
    def is_null(self) -> bool:
        return False

    @property
    def deterministic(self) -> bool:
        return self._deterministic

    def _file_path(self, path: "CheckpointPath") -> str:
        fid = self._obj_id if self._namespace is None else to_uuid(self._obj_id, self._namespace)
        return path.get_file_path(fid, self._fmt, permanent=self._permanent)

    def _load(self, fpath: str, path: "CheckpointPath") -> Any:
        result = path.execution_engine.load_df(fpath, format_hint=self._fmt)
        if self.yielded is not None:
            self.yielded.set_value(fpath)
        return result

    def try_load(self, path: "CheckpointPath") -> Optional[Any]:
        if not self._deterministic:
            return None
        fpath = self._file_path(path)
        return self._load(fpath, path) if path.file_exists(fpath) else None

    def run(self, df: Any, path: "CheckpointPath") -> Any:
        fpath = self._file_path(path)
        if not (self._deterministic and path.file_exists(fpath)):
            path.execution_engine.save_df(df, fpath, format_hint=self._fmt, mode="overwrite",
                                          force_single=self._single, **self._save_kwargs)
        return self._load(fpath, path)


class CheckpointPath:
    """A run's temporary and permanent checkpoint folders under
    ``fugue.workflow.checkpoint.path`` (``:226``)."""

    def __init__(self, engine: Any):
        self._engine = engine
        self._path = typed_conf_get(engine.conf, FUGUE_CONF_WORKFLOW_CHECKPOINT_PATH).strip()
        if self._path != "":
            engine._check_uri("checkpoint", self._path)
        self._temp_path = ""

    @property
    def execution_engine(self) -> Any:
        return self._engine

    def init_temp_path(self, execution_id: str) -> str:
        if self._path == "":
            self._temp_path = ""
            return ""
        fs = self._engine.fs
        self._temp_path = fs.join(self._path, execution_id)
        fs.makedirs(self._temp_path, exist_ok=True)
        return self._temp_path

    def remove_temp_path(self) -> None:
        if self._temp_path != "":
            self._engine.fs.rm(self._temp_path, recursive=True)

    def get_file_path(self, obj_id: str, fmt: str, permanent: bool) -> str:
        path = self._path if permanent else self._temp_path
        assert_or_throw(path != "", ValueError(
            "fugue.workflow.checkpoint.path is not set for checkpoints"))
        return self._engine.fs.join(path, f"{obj_id}.{fmt}")

    def file_exists(self, path: str) -> bool:
        return self._engine.fs.exists(path)

    def temp_file(self, fmt: str = "parquet") -> str:
        assert_or_throw(self._temp_path != "",
                        ValueError("fugue.workflow.checkpoint.path is not set"))
        return self._engine.fs.join(self._temp_path, f"{uuid4()}.{fmt}")
