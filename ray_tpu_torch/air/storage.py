"""URI-addressed durable storage for experiments and checkpoints.

Parity: reference ``python/ray/tune/syncer.py`` (experiment/trial sync to
durable storage) + ``python/ray/air/_internal/remote_storage.py`` (the
pyarrow-fs upload/download helpers).  The reference reaches s3/gs through
pyarrow; this runtime ships a ``file://`` backend (shared filesystems —
NFS, GCS-fuse mounts — are the common TPU-pod fabric) and a scheme
registry so cloud backends plug in without touching callers:

    register_storage("gs", MyGCSBackend())

Every URI is ``<scheme>://<path>`` or a plain path (treated as file).
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Tuple

__all__ = [
    "StorageBackend", "FileStorage", "register_storage", "get_storage",
    "upload_dir", "download_dir", "read_bytes", "write_bytes", "exists",
]


class StorageBackend:
    """Interface for a durable blob/directory store."""

    def upload_dir(self, local_dir: str, path: str) -> None:
        raise NotImplementedError

    def download_dir(self, path: str, local_dir: str) -> None:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError


def _atomic_dir_swap(tmp: str, path: str) -> None:
    """Install ``tmp`` at ``path`` atomically even when ``path`` exists.

    ``os.replace`` refuses a non-empty directory target, so replacement
    uses Linux ``renameat2(RENAME_EXCHANGE)`` — the destination is never
    absent, closing the crash window a rename-aside two-step leaves
    (where a SIGKILL between the renames loses the only copy).  Falls
    back to the two-step on filesystems without exchange support."""
    if not os.path.exists(path):
        os.replace(tmp, path)
        return
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        AT_FDCWD = -100
        RENAME_EXCHANGE = 2
        rc = libc.renameat2(AT_FDCWD, os.fsencode(tmp),
                            AT_FDCWD, os.fsencode(path), RENAME_EXCHANGE)
        if rc == 0:
            shutil.rmtree(tmp, ignore_errors=True)  # now holds the old dir
            return
    except Exception:  # noqa: BLE001 — non-Linux/libc without renameat2
        pass
    old = path + ".old"
    os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


class FileStorage(StorageBackend):
    """file:// (or bare-path) backend: durable == a shared filesystem.

    Uploads are ATOMIC at directory granularity: staged to a ``.tmp``
    sibling then swapped in with ``renameat2(RENAME_EXCHANGE)``, so a
    reader never sees a half-synced (or missing) checkpoint (the
    reference's syncer has the same contract)."""

    def upload_dir(self, local_dir: str, path: str) -> None:
        tmp = path + ".tmp"
        old = path + ".old"
        # clear residue a crashed previous swap may have left
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(old, ignore_errors=True)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        shutil.copytree(local_dir, tmp)
        _atomic_dir_swap(tmp, path)

    def download_dir(self, path: str, local_dir: str) -> None:
        if not os.path.exists(path) and os.path.exists(path + ".old"):
            # safety net for the non-exchange fallback's crash window
            path = path + ".old"
        shutil.copytree(path, local_dir, dirs_exist_ok=True)

    def write_bytes(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        return sorted(os.listdir(path)) if os.path.isdir(path) else []

    def delete(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.unlink(path)


_REGISTRY: Dict[str, StorageBackend] = {"file": FileStorage()}


def register_storage(scheme: str, backend: StorageBackend) -> None:
    """Plug in a backend for ``<scheme>://`` URIs (e.g. gs, s3)."""
    _REGISTRY[scheme] = backend


def get_storage(uri: str) -> Tuple[StorageBackend, str]:
    """Resolve a URI (or plain path) to (backend, backend-local path)."""
    if "://" in uri:
        scheme, path = uri.split("://", 1)
        backend = _REGISTRY.get(scheme)
        if backend is None:
            raise ValueError(
                f"no storage backend registered for {scheme}://; "
                f"register one with ray_tpu_torch.air.storage.register_storage")
        if scheme == "file":
            path = "/" + path.lstrip("/")
        return backend, path
    return _REGISTRY["file"], uri


def join(uri: str, *parts: str) -> str:
    out = uri.rstrip("/")
    for p in parts:
        out += "/" + p.strip("/")
    return out


# -- convenience wrappers (resolve per call) ------------------------------

def upload_dir(local_dir: str, uri: str) -> None:
    backend, path = get_storage(uri)
    backend.upload_dir(local_dir, path)


def download_dir(uri: str, local_dir: str) -> None:
    backend, path = get_storage(uri)
    backend.download_dir(path, local_dir)


def write_bytes(uri: str, data: bytes) -> None:
    backend, path = get_storage(uri)
    backend.write_bytes(path, data)


def read_bytes(uri: str) -> bytes:
    backend, path = get_storage(uri)
    return backend.read_bytes(path)


def exists(uri: str) -> bool:
    backend, path = get_storage(uri)
    return backend.exists(path)


def delete(uri: str) -> None:
    backend, path = get_storage(uri)
    backend.delete(path)
