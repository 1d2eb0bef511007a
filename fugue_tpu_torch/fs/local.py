"""Local files for the port's ``load_df``/``save_df``: bare paths and
``file://`` URIs (``fugue_tpu/fs/local.py``, with the URI helpers of
``fugue_tpu/fs/base.py:45-97`` and the atomic write of ``:172-194``).

The reference routes every URI through a scheme registry (``memory://``,
fsspec's object stores, ``lake://`` tables). The port has local files
only: any other scheme raises ``NotImplementedError`` naming ROADMAP.md
queue 1 item 13, and is never read or written on the host instead."""

import os
import posixpath
import re
import shutil
from typing import Any, BinaryIO, Callable, List, Optional, Tuple
from uuid import uuid4

_URI_RE = re.compile(r"^([A-Za-z][A-Za-z0-9+.-]*)://(.*)$")
UNPORTED_IO = "ROADMAP.md queue 1 item 13"


def split_uri(uri: str) -> Tuple[str, str]:
    """``"gs://bucket/a"`` -> ``("gs", "bucket/a")``; a bare path ->
    ``("file", path)`` (``fs/base.py:59``)."""
    m = _URI_RE.match(uri)
    if m is None or len(m.group(1)) == 1:  # C:\... is a drive, not a scheme
        return "file", uri
    return m.group(1).lower(), m.group(2)


def unported_scheme(uri: str) -> Optional[str]:
    """What ``uri`` reaches where its scheme is not ``file`` (``"memory://
    'memory://t.parquet' (the in-memory filesystem)"``), else None."""
    scheme, _ = split_uri(uri)
    if scheme == "file":
        return None
    what = {"memory": "the in-memory filesystem", "lake": "a lake table"}.get(
        scheme, "an fsspec filesystem")
    return f"{scheme}:// {uri!r} ({what})"


def check_uri(uri: str) -> str:
    """The local path of ``uri``; raises ``NotImplementedError`` naming
    ROADMAP.md queue 1 item 13 for any scheme but ``file``."""
    what = unported_scheme(uri)
    if what is not None:
        raise NotImplementedError(f"{what} is not ported to the torch engine yet; "
                                  f"see {UNPORTED_IO}")
    return split_uri(uri)[1]


class LocalFileSystem:
    """``VirtualFileSystem`` over local disk, taking URIs: each method
    checks its URI's scheme first (``check_uri``)."""

    def open_input_stream(self, uri: str) -> BinaryIO:
        return open(check_uri(uri), "rb")

    def open_output_stream(self, uri: str) -> BinaryIO:
        path = check_uri(uri)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        return open(path, "wb")

    def exists(self, uri: str) -> bool:
        return os.path.exists(check_uri(uri))

    def isdir(self, uri: str) -> bool:
        return os.path.isdir(check_uri(uri))

    def listdir(self, uri: str) -> List[str]:
        """Base names of a directory's children, sorted."""
        return sorted(os.listdir(check_uri(uri)))

    def join(self, base: str, *parts: str) -> str:
        """``base`` joined with ``parts``, a ``file://`` prefix kept."""
        if _URI_RE.match(base) is None:
            return os.path.join(check_uri(base), *parts)
        return "file://" + posixpath.join(check_uri(base), *parts)

    def makedirs(self, uri: str, exist_ok: bool = True) -> None:
        os.makedirs(check_uri(uri), exist_ok=exist_ok)

    def rm(self, uri: str, recursive: bool = False) -> None:
        """Removes a file, or a directory tree with ``recursive``; a
        missing path is a no-op."""
        path = check_uri(uri)
        if not os.path.exists(path):
            return
        if os.path.isdir(path):
            if recursive:
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.rmdir(path)
        else:
            os.remove(path)

    def pyarrow_fs(self, uri: str) -> Tuple[Any, str]:
        """A ``pyarrow.fs`` view of local disk and the local path, for
        pyarrow's dataset reads and writes."""
        import pyarrow.fs as pafs

        return pafs.LocalFileSystem(), check_uri(uri)

    def write_file_atomic(self, uri: str, writer: Callable[[BinaryIO], None]) -> None:
        """Writes ``uri`` through ``writer`` into a dot-hidden sibling
        temp file, then renames it over the target, so a reader never
        sees a torn file (``fs/base.py:172-194``); the temp file goes on
        any error."""
        path = check_uri(uri)
        head, tail = os.path.split(path)
        tmp = os.path.join(head, f".{tail}.tmp-{uuid4().hex[:8]}")
        try:
            with self.open_output_stream(tmp) as fp:
                writer(fp)
            os.replace(tmp, path)
        except BaseException:
            self.rm(tmp)
            raise
