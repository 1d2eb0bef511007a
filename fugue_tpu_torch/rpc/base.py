"""The in-process callback channel a workflow run makes (a port of
``fugue_tpu/rpc/base.py``: ``RPCHandler`` ``:26``, ``EmptyRPCHandler``
``:82``, ``RPCFunc`` ``:92``, ``to_rpc_handler`` ``:223``, ``RPCServer``
``:233``, ``NativeRPCClient``/``NativeRPCServer`` ``:286-309``,
``make_rpc_server`` ``:314``). A transformer's ``callback`` reaches its
handler on the workflow's side through a client the server makes. The HTTP server
(``fugue_tpu/rpc/http.py``) is ROADMAP.md queue 1 item 13."""

import functools
import inspect
import pickle
from abc import ABC, abstractmethod
from threading import RLock
from typing import Any, Callable, Dict, Optional
from uuid import uuid4

from fugue_tpu_torch.constants import FUGUE_CONF_RPC_SERVER, typed_conf_get
from fugue_tpu_torch.utils.assertion import assert_or_throw
from fugue_tpu_torch.utils.hash import to_uuid
from fugue_tpu_torch.utils.params import ParamDict


class RPCClient:
    """What a transformer calls to reach a handler on the workflow's side."""

    def __call__(self, *args: Any, **kwargs: Any) -> Any:  # pragma: no cover
        raise NotImplementedError


class RPCHandler(RPCClient):
    """A handler on the workflow's side; its ``__uuid__`` folds into task ids."""

    def __init__(self) -> None:
        self._rpchandler_lock = RLock()
        self._running = 0
        self._uuid_once: Optional[str] = None

    def __uuid__(self) -> str:
        """A random id per handler (fail closed: the base class cannot
        see a subclass's state, ``:35-48``)."""
        if self._uuid_once is None:
            self._uuid_once = str(uuid4())
        return self._uuid_once

    @property
    def running(self) -> bool:
        return self._running > 0

    def start_handler(self) -> None:  # pragma: no cover - hook
        pass

    def stop_handler(self) -> None:  # pragma: no cover - hook
        pass

    def start(self) -> "RPCHandler":
        with self._rpchandler_lock:
            if self._running == 0:
                self.start_handler()
            self._running += 1
        return self

    def stop(self) -> None:
        with self._rpchandler_lock:
            if self._running == 1:
                self.stop_handler()
            self._running = max(0, self._running - 1)

    def __getstate__(self) -> Any:
        raise pickle.PicklingError(f"{self} is not serializable")


class EmptyRPCHandler(RPCHandler):
    def __uuid__(self) -> str:
        return to_uuid("EmptyRPCHandler")

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError("empty rpc handler")


class RPCFunc(RPCHandler):
    """A plain callable as a handler, identified by its source and the
    state it captures (``:92-160``); what cannot be hashed by value gets a
    random id, so that a changed callback never reuses a checkpoint."""

    def __init__(self, func: Callable):
        super().__init__()
        assert_or_throw(callable(func), ValueError(f"{func} is not callable"))
        self._func = func

    def __uuid__(self) -> str:
        f: Any = self._func
        state: list = []
        while isinstance(f, functools.partial):
            state.append((_state_view(list(f.args)),
                          _state_view(sorted((f.keywords or {}).items()))))
            f = f.func
        bound = getattr(f, "__self__", None)
        if bound is not None:
            if hasattr(bound, "__uuid__"):
                state.append(bound.__uuid__())
            else:
                try:
                    state.append(_state_view(sorted(vars(bound).items())))
                except TypeError:
                    return str(uuid4())
        f = getattr(f, "__func__", f)
        if hasattr(f, "__uuid__"):
            base: Any = f.__uuid__()
        elif inspect.isbuiltin(f):
            base = to_uuid(f)
        elif inspect.isfunction(f):
            try:
                inspect.getsource(f)
            except (OSError, TypeError):
                return str(uuid4())
            state.append(_state_view(f))
            base = "fn"
        else:
            return str(uuid4())
        if not _state_hash_is_sound(state):
            return str(uuid4())
        return to_uuid(type(self).__name__, base, state)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self._func(*args, **kwargs)


def _state_view(v: Any, _seen: Optional[set] = None) -> Any:
    """Captured state with every function expanded into its defaults and
    closure cells, recursively (``:163``)."""
    seen = _seen if _seen is not None else set()
    if inspect.isfunction(v):
        if id(v) in seen:
            return "<cycle>"
        seen.add(id(v))
        inner: list = []
        if v.__defaults__:
            inner.append(("defaults", _state_view(list(v.__defaults__), seen)))
        if v.__kwdefaults__:
            inner.append(("kwdefaults", _state_view(sorted(v.__kwdefaults__.items()), seen)))
        if v.__closure__:
            cells = []
            for c in v.__closure__:
                try:
                    cells.append(_state_view(c.cell_contents, seen))
                except ValueError:
                    cells.append("<empty>")
            inner.append(("closure", cells))
        return (v, inner)
    if isinstance(v, (set, frozenset)):
        return [_state_view(x, seen) for x in sorted(v, key=repr)]
    if isinstance(v, (list, tuple)):
        return [_state_view(x, seen) for x in v]
    if isinstance(v, dict):
        return {str(k): _state_view(x, seen) for k, x in v.items()}
    return v


def _state_hash_is_sound(v: Any) -> bool:
    """Every leaf hashes by value (``:195``)."""
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return True
    if isinstance(v, (list, tuple, set, frozenset)):
        return all(_state_hash_is_sound(x) for x in v)
    if isinstance(v, dict):
        return all(_state_hash_is_sound(k) and _state_hash_is_sound(x) for k, x in v.items())
    if hasattr(v, "__uuid__"):
        return True
    if inspect.isfunction(v):
        try:
            inspect.getsource(v)
            return True
        except (OSError, TypeError):
            return False
    return False


def to_rpc_handler(obj: Any) -> RPCHandler:
    if obj is None:
        return EmptyRPCHandler()
    if isinstance(obj, RPCHandler):
        return obj
    if callable(obj):
        return RPCFunc(obj)
    raise ValueError(f"{obj} can't be converted to RPCHandler")


class RPCServer(RPCHandler, ABC):
    """Registers handlers by key and makes their clients (``:233``)."""

    def __init__(self, conf: Any = None):
        super().__init__()
        self._conf = ParamDict(conf)
        self._handlers: Dict[str, RPCHandler] = {}

    @abstractmethod
    def make_client(self, handler: Any) -> RPCClient:  # pragma: no cover
        raise NotImplementedError

    def stop_handler(self) -> None:
        for h in list(self._handlers.values()):
            h.stop()
        self._handlers.clear()

    def invoke(self, key: str, *args: Any, **kwargs: Any) -> Any:
        with self._rpchandler_lock:
            handler = self._handlers[key]
        return handler(*args, **kwargs)

    def register(self, handler: Any) -> str:
        key = "_" + str(uuid4())[:8]
        with self._rpchandler_lock:
            assert_or_throw(key not in self._handlers, ValueError(f"dup key {key}"))
            self._handlers[key] = to_rpc_handler(handler).start()
        return key

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError("RPCServer is not directly callable")


class NativeRPCClient(RPCClient):
    """An in-process client, holding its server by reference."""

    def __init__(self, server: "NativeRPCServer", key: str):
        self._key = key
        self._server = server

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self._server.invoke(self._key, *args, **kwargs)

    def __getstate__(self) -> Any:
        raise pickle.PicklingError("NativeRPCClient can't be serialized")


class NativeRPCServer(RPCServer):
    def make_client(self, handler: Any) -> RPCClient:
        return NativeRPCClient(self, self.register(handler))


def make_rpc_server(conf: Any = None) -> RPCServer:
    """The server ``fugue.rpc.server`` names: ``native`` (the default);
    ``http`` raises, naming ROADMAP.md queue 1 item 13 (``:314``)."""
    tp = typed_conf_get(ParamDict(conf), FUGUE_CONF_RPC_SERVER).lower()
    if tp != "native":
        raise NotImplementedError(
            f"{FUGUE_CONF_RPC_SERVER}={tp!r}: the port runs only the in-process RPC server; "
            "the HTTP server is ROADMAP.md queue 1 item 13")
    return NativeRPCServer(conf)
