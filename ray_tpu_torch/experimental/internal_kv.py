"""Internal key-value store client over the GCS KV table.

Parity: reference ``python/ray/experimental/internal_kv.py`` —
``_internal_kv_put/get/del/exists/list`` against the GCS
(``src/ray/gcs/gcs_server/gcs_kv_manager.h``).  Values in this table are
durable across a GCS/head restart (snapshot-persisted, see
``ray_tpu/core/gcs.py``), which makes this the substrate the fault
tolerance tests poke at.

Keys may be ``bytes`` or ``str`` (normalized to str on the wire); values
are arbitrary bytes.
"""

from __future__ import annotations

from typing import List, Optional, Union

from ray_tpu_torch.core import worker as _worker_mod

KeyT = Union[str, bytes]


def _key(key: KeyT) -> str:
    if isinstance(key, bytes):
        return key.decode("utf-8", "surrogateescape")
    return key


def _call(method: str, data: dict, timeout: float = 30.0):
    core = _worker_mod.global_worker()
    return core._run(core.gcs_conn.call(method, data), timeout=timeout)


def _internal_kv_initialized() -> bool:
    core = _worker_mod.global_worker_or_none()
    return core is not None and core.gcs_conn is not None


def _internal_kv_put(key: KeyT, value: Union[bytes, str],
                     overwrite: bool = True,
                     namespace: str = "") -> bool:
    """Store value; returns True iff the key already existed."""
    if isinstance(value, str):
        value = value.encode()
    return bool(_call("kv_put", {
        "key": _key(key), "value": value, "overwrite": overwrite,
        "namespace": namespace}))


def _internal_kv_get(key: KeyT, namespace: str = "") -> Optional[bytes]:
    return _call("kv_get", {"key": _key(key), "namespace": namespace})


def _internal_kv_exists(key: KeyT, namespace: str = "") -> bool:
    return _internal_kv_get(key, namespace=namespace) is not None


def _internal_kv_del(key: KeyT, namespace: str = "") -> bool:
    return bool(_call("kv_del", {"key": _key(key), "namespace": namespace}))


def _internal_kv_list(prefix: KeyT, namespace: str = "") -> List[bytes]:
    keys = _call("kv_keys", {"prefix": _key(prefix), "namespace": namespace})
    return [k.encode("utf-8", "surrogateescape") for k in keys or []]
