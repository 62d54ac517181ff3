"""Deterministic failpoint injection for the control plane.

Parity model: the reference's ``RAY_testing_asio_delay_us`` /
``testing_rpc_failure`` knobs (``src/ray/common/ray_config_def.h``) and
the FreeBSD/TiKV ``fail::cfg`` registry: named, process-local injection
*sites* compiled into the hot control-plane paths that stay dormant
(one dict lookup) until *armed*.  Arming attaches an action:

``raise``
    raise :class:`FailpointError` at the site (callers see it through
    their normal RPC error classification);
``drop``
    the site suppresses the protected effect (e.g. a reply frame is
    never sent) — models a lost message on an otherwise healthy link;
``delay``
    sleep ``delay_s`` (async sites use ``asyncio.sleep``) then proceed
    — models a slow peer / GC pause / queue stall;
``kill``
    ``os._exit(1)`` — models a process crash at exactly this point.

Determinism: each armed site owns a ``random.Random(seed)`` stream and
fires with probability ``prob`` at most ``count`` times, optionally
skipping its first ``skip`` evaluations.  With ``prob=1.0`` (default)
behavior is fully deterministic; with ``prob<1`` it is reproducible for
a fixed seed because every site draws from its own stream.

Arming surfaces:

* :func:`arm` / :func:`disarm` / :func:`disarm_all` — process-local.
* ``RAY_TPU_TORCH_FAILPOINTS`` env var — parsed on first evaluation, so any
  child process (raylets spawned by ``init()``, workers spawned by
  raylets — both inherit ``os.environ``) boots with the same sites
  armed.  Spec grammar (semicolon-separated)::

      site=action[:k=v[,k=v...]]
      rpc.push_tasks.reply_drop=drop:count=1
      gcs.health_report.delay=delay:delay_s=2.0,count=3,seed=7

* the GCS internal KV (namespace ``_failpoints``) via
  :func:`arm_cluster` — covers the arming process plus every raylet
  and worker that registers AFTER the call (each reads the table once
  at registration via :func:`sync_from_kv`); processes already running
  when the test arms are NOT re-armed.

Sites are cheap when dormant: ``failpoint(name)`` is a dict lookup of
an (almost always) empty dict.  Production builds need no stripping —
the registry is empty unless a test armed it.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

ENV_VAR = "RAY_TPU_TORCH_FAILPOINTS"
KV_NAMESPACE = "_failpoints"
KV_KEY = "armed"

ACTIONS = ("raise", "drop", "delay", "kill")


class FailpointError(Exception):
    """Raised by an armed ``raise`` site.  Deliberately distinct from
    the transport's ConnectionLost so tests can tell an injected fault
    from a real one in logs; RPC callers treat it like any handler
    error (it crosses the wire as a structured ``RpcError``)."""

    def __init__(self, site: str):
        super().__init__(f"failpoint injected: {site}")
        self.site = site


@dataclass
class _Site:
    name: str
    action: str
    prob: float = 1.0
    count: int = 1          # max fires; -1 = unlimited
    skip: int = 0           # dormant for the first N evaluations
    delay_s: float = 0.05   # for action == "delay"
    seed: int = 0
    fired: int = 0
    evaluated: int = 0
    rng: random.Random = field(default_factory=random.Random)

    def __post_init__(self):
        self.rng = random.Random(self.seed)

    def should_fire(self) -> bool:
        self.evaluated += 1
        if self.evaluated <= self.skip:
            return False
        if self.count >= 0 and self.fired >= self.count:
            return False
        if self.prob < 1.0 and self.rng.random() >= self.prob:
            return False
        self.fired += 1
        return True


_lock = threading.Lock()
_sites: Dict[str, _Site] = {}
_env_loaded = False


def _load_env_locked() -> None:
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return
    try:
        for name, site in parse_spec(spec).items():
            _sites.setdefault(name, site)
    except ValueError:
        logger.exception("malformed %s ignored", ENV_VAR)


def parse_spec(spec: str) -> Dict[str, _Site]:
    """``site=action[:k=v,...]`` items separated by ``;``."""
    out: Dict[str, _Site] = {}
    for item in spec.split(";"):
        item = item.strip()
        if not item:
            continue
        name, _, rhs = item.partition("=")
        name = name.strip()
        if not name or not rhs:
            raise ValueError(f"malformed failpoint spec item: {item!r}")
        action, _, opt_str = rhs.partition(":")
        action = action.strip()
        if action not in ACTIONS:
            raise ValueError(f"unknown failpoint action {action!r} "
                             f"(expected one of {ACTIONS})")
        kwargs: Dict[str, float] = {}
        if opt_str:
            for pair in opt_str.split(","):
                k, _, v = pair.partition("=")
                k = k.strip()
                if k not in ("prob", "count", "skip", "delay_s", "seed"):
                    raise ValueError(f"unknown failpoint option {k!r}")
                kwargs[k] = float(v) if k in ("prob", "delay_s") else int(v)
        out[name] = _Site(name=name, action=action, **kwargs)
    return out


def format_spec(sites: Dict[str, _Site]) -> str:
    """Inverse of :func:`parse_spec` (for KV/env round trips)."""
    items = []
    for site in sites.values():
        opts = (f"prob={site.prob},count={site.count},skip={site.skip},"
                f"delay_s={site.delay_s},seed={site.seed}")
        items.append(f"{site.name}={site.action}:{opts}")
    return ";".join(items)


def arm(name: str, action: str = "raise", *, prob: float = 1.0,
        count: int = 1, skip: int = 0, delay_s: float = 0.05,
        seed: int = 0) -> None:
    """Arm a site in THIS process.  ``count=-1`` fires forever."""
    if action not in ACTIONS:
        raise ValueError(f"unknown failpoint action {action!r}")
    with _lock:
        _sites[name] = _Site(name=name, action=action, prob=prob,
                             count=count, skip=skip, delay_s=delay_s,
                             seed=seed)
    logger.info("failpoint armed: %s action=%s prob=%s count=%s",
                name, action, prob, count)


def disarm(name: str) -> None:
    with _lock:
        _sites.pop(name, None)


def disarm_all() -> None:
    global _env_loaded
    with _lock:
        _sites.clear()
        # keep env specs from silently re-arming on the next evaluation
        _env_loaded = True


def reload_env() -> None:
    """Drop every armed site and re-read ``RAY_TPU_TORCH_FAILPOINTS`` on the
    next evaluation (test fixtures that mutate the env var call this)."""
    global _env_loaded
    with _lock:
        _sites.clear()
        _env_loaded = False


def active() -> bool:
    """Hot-path gate: True when any site might be armed (or the env
    spec hasn't been read yet).  Callers on hot paths check this before
    building a site name / allocating an ``afailpoint`` coroutine."""
    return bool(_sites) or not _env_loaded


def armed() -> List[str]:
    with _lock:
        _load_env_locked()
        return sorted(_sites)


def fire_count(name: str) -> int:
    """How many times the named site has fired (0 if unknown)."""
    with _lock:
        site = _sites.get(name)
        return site.fired if site is not None else 0


def _resolve(name: str) -> Optional[_Site]:
    with _lock:
        if not _env_loaded:
            _load_env_locked()
        site = _sites.get(name)
        if site is None or not site.should_fire():
            return None
    logger.warning("failpoint FIRING: %s (%s, fire #%d)",
                   name, site.action, site.fired)
    return site


def failpoint(name: str) -> bool:
    """Synchronous site.  Returns True when the caller must DROP the
    protected effect; raises/sleeps/kills for the other actions."""
    if not _sites and _env_loaded:
        return False  # dormant fast path
    site = _resolve(name)
    if site is None:
        return False
    if site.action == "drop":
        return True
    if site.action == "raise":
        raise FailpointError(name)
    if site.action == "delay":
        time.sleep(site.delay_s)
        return False
    if site.action == "kill":
        os._exit(1)
    return False


async def afailpoint(name: str) -> bool:
    """Async site: like :func:`failpoint` but delays without blocking
    the event loop."""
    if not _sites and _env_loaded:
        return False
    site = _resolve(name)
    if site is None:
        return False
    if site.action == "drop":
        return True
    if site.action == "raise":
        raise FailpointError(name)
    if site.action == "delay":
        await asyncio.sleep(site.delay_s)
        return False
    if site.action == "kill":
        os._exit(1)
    return False


# ---------------------------------------------------------------------------
# cluster-wide arming over internal KV
# ---------------------------------------------------------------------------
def arm_cluster(name: str, action: str = "raise", **options) -> None:
    """Arm a site in THIS process and in every raylet/worker that
    REGISTERS AFTER the call: the merged spec is written into the GCS
    KV, which processes read once at registration
    (:func:`sync_from_kv`).  Already-running remote processes never
    re-read the table — arm via ``RAY_TPU_TORCH_FAILPOINTS`` before
    ``init()`` to cover the whole tree from boot."""
    from ray_tpu_torch.experimental import internal_kv

    arm(name, action, **options)
    with _lock:
        spec = format_spec(_sites)
    internal_kv._internal_kv_put(KV_KEY, spec, namespace=KV_NAMESPACE)


def disarm_cluster() -> None:
    from ray_tpu_torch.experimental import internal_kv

    disarm_all()
    internal_kv._internal_kv_del(KV_KEY, namespace=KV_NAMESPACE)


async def sync_from_kv(gcs_conn) -> None:
    """Merge KV-armed sites into this process (called by workers after
    their GCS connection is up; best-effort — a dead GCS must not block
    boot)."""
    try:
        raw = await gcs_conn.call(
            "kv_get", {"key": KV_KEY, "namespace": KV_NAMESPACE},
            timeout=5.0)
    except Exception:  # noqa: BLE001 — injection must never break boot
        return
    if not raw:
        return
    if isinstance(raw, bytes):
        raw = raw.decode()
    try:
        parsed = parse_spec(raw)
    except ValueError:
        logger.exception("malformed failpoint spec in KV ignored")
        return
    with _lock:
        for name, site in parsed.items():
            _sites.setdefault(name, site)
