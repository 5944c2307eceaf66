"""Storage seam: one open / exists / put interface for local and remote paths
(counterpart of starcop_tpu/utils/storage.py).

Local paths use the builtins. ``gs://``-style remote paths go through
``fsspec``, imported only when a remote path is used: a machine without it
runs every local path, and a remote path there raises ``ImportError``
naming ``fsspec``.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import shutil
from typing import Any, List

_REMOTE_SCHEMES = ("gs://", "s3://", "gcs://", "az://")


def is_remote(path: str) -> bool:
    return str(path).startswith(_REMOTE_SCHEMES)


def get_filesystem(path: str):
    """The fsspec filesystem of a remote path's scheme; None for a local path
    (the call sites then use the builtins)."""
    if not is_remote(path):
        return None
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(f"{path}: remote paths need the fsspec package") from e
    return fsspec.filesystem(str(path).split("://", 1)[0])


def open_file(path: str, mode: str = "r"):
    fs = get_filesystem(path)
    if fs is None:
        if any(m in mode for m in ("w", "a", "x")):
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        return open(path, mode)
    return fs.open(path, mode)


def exists(path: str) -> bool:
    fs = get_filesystem(path)
    return os.path.exists(path) if fs is None else fs.exists(path)


def makedirs(path: str) -> None:
    fs = get_filesystem(path)
    if fs is None:
        os.makedirs(path, exist_ok=True)
    else:
        fs.makedirs(path, exist_ok=True)


def listdir(path: str) -> List[str]:
    fs = get_filesystem(path)
    if fs is None:
        return sorted(os.listdir(path))
    return sorted(os.path.basename(p.rstrip("/")) for p in fs.ls(path))


def glob(pattern: str) -> List[str]:
    fs = get_filesystem(pattern)
    if fs is None:
        return sorted(_glob.glob(pattern))
    scheme = pattern.split("://", 1)[0]
    return [f"{scheme}://{p}" for p in sorted(fs.glob(pattern))]


def put(local_path: str, dest_path: str, recursive: bool = False) -> str:
    """Copy (upload) a file, or a tree with ``recursive``, to ``dest_path``."""
    fs = get_filesystem(dest_path)
    if fs is None:
        if recursive and os.path.isdir(local_path):
            shutil.copytree(local_path, dest_path, dirs_exist_ok=True)
        else:
            parent = os.path.dirname(dest_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            shutil.copy2(local_path, dest_path)
    else:
        fs.put(local_path, dest_path, recursive=recursive)
    return dest_path


def get(remote_path: str, local_path: str) -> str:
    fs = get_filesystem(remote_path)
    if fs is None:
        shutil.copy2(remote_path, local_path)
    else:
        fs.get(remote_path, local_path)
    return local_path


def read_json(path: str) -> Any:
    with open_file(path, "r") as fh:
        return json.load(fh)


def write_json(path: str, payload: Any) -> str:
    with open_file(path, "w") as fh:
        json.dump(payload, fh, default=str)
    return path
