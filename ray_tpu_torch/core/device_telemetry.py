"""Device-plane sensors: what is the accelerator actually doing?

Every observability layer before this one watches the *host* — RPC
latencies, CPU stacks, trace spans, SLO burn rates.  A TPU-native
runtime lives or dies by what the *device* does, and three failure
modes are invisible from the host side until they surface as a
tail-latency mystery:

- **recompile storms** — a shape leak past the padding buckets makes
  XLA retrace on every step; throughput collapses while every host
  metric looks healthy;
- **data starvation** — the chip idles between steps waiting on the
  input pipeline; host throughput counters keep climbing because the
  host *is* busy — shoveling;
- **gang stragglers** — one slow rank gates every step of a gang
  (network, a noisy neighbor, thermal throttling); the gang's
  aggregate step time degrades with no per-replica signal naming the
  culprit.

Three instruments, one per failure mode:

``instrument_step(fn, name)``
    Wraps a step entry point.  Each call's *abstract input signature*
    (shapes + dtypes, not values) is keyed against the wrapper's
    seen-set — in the JAX package a miss is exactly when ``jax.jit``
    compiles — and timed, emitting ``ray_tpu_xla_compiles_total{fn,
    reason}`` + ``ray_tpu_xla_compile_seconds`` plus a ``compile`` span
    into the tracing plane.  Eager torch compiles nothing: here a miss
    counts a new step shape, what jit would compile once per padding
    bucket.  The serve batcher's contract (one signature per bucket,
    none new within one) and its tests rest on that count, so the
    bookkeeping is kept under the same names.  Steady-state calls cost
    one set lookup.

:class:`StepMonitor`
    Splits each step's wall time into the data_wait / host / device /
    sync phase ladder (device time via a CUDA synchronise of the
    step's output tensors), derives rolling MFU and goodput from engine-declared
    FLOPs-per-token, and exports the ``train:mfu`` /
    ``train:step_data_wait_frac`` / ``serve:decode_device_frac``
    recording-rule inputs.  Phases telescope to step wall time by
    construction: every boundary is a stamp of the same clock.

:class:`RankSkewWindow`
    Gang-level straggler detector: per-rank step durations feed a
    rolling window; skew = max - min of the per-rank means, and the
    argmax rank is named in ``ray_tpu_gang_rank_skew_seconds``'s
    ``straggler`` tag (which the GangStraggler alert's group_by
    surfaces) and in ``gang``-category trace spans.

The module must stay import-cheap (no torch import at module load: torch
is the one the process has loaded, ``serialization.loaded_torch``): the
worker imports it on every task execution to attribute device seconds
into the ``task_exec`` span
(`ray-tpu analyze`'s exec_host/exec_device split).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core import telemetry as _tm
from ray_tpu_torch.core.serialization import loaded_torch

__all__ = ["instrument_step", "is_instrumented", "compile_count",
           "compile_stats", "StepMonitor", "RankSkewWindow",
           "peak_flops_per_chip", "device_seconds",
           "add_device_seconds", "reset_for_tests"]


#: dense bf16 tensor-core FLOP/s by device name (NVIDIA's data sheets,
#: SXM parts)
_PEAK_BF16_FLOPS = {"h100": 989e12, "h200": 989e12}


def peak_flops_per_chip() -> float:
    """Best-effort peak dense bf16 FLOP/s of the attached GPU (the MFU
    denominator), read from ``torch.cuda.get_device_name()``.  Hosts
    without CUDA, and processes that never imported torch, get the
    H100's 989e12, as the JAX package gives CPU hosts its v5e figure,
    so CPU-smoke MFU numbers stay comparable across runs."""
    torch = loaded_torch()
    kind = ""
    if torch is not None and torch.cuda.is_available():
        kind = torch.cuda.get_device_name().lower()
    for key, val in _PEAK_BF16_FLOPS.items():
        if key in kind:
            return val
    return _PEAK_BF16_FLOPS["h100"]


def _sync_devices(out: Any) -> None:
    """Wait for the work that produced ``out``: synchronise each CUDA
    device that a tensor in it (or in a list, tuple or dict of them)
    lies on.  Host values are already done."""
    torch = loaded_torch()
    if torch is None:
        return
    devices = set()

    def visit(x: Any) -> None:
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)

    visit(out)
    for device in devices:
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# compile accounting (new step signatures)
# ---------------------------------------------------------------------------

_compile_lock = threading.Lock()
#: fn name -> {"total": int, "first": int, "shape_miss": int,
#:             "seconds": float}
_compiles: Dict[str, Dict[str, Any]] = {}


def _abstract(x: Any) -> Any:
    """Abstract one argument the way jit's cache keys it: arrays by
    (shape, dtype), containers structurally, python scalars by type
    only (jit re-traces on *type* changes, not value changes)."""
    shape = getattr(x, "shape", None)
    if shape is not None:
        return ("arr", tuple(shape), str(getattr(x, "dtype", "?")))
    if isinstance(x, (list, tuple)):
        return ("seq", tuple(_abstract(v) for v in x))
    if isinstance(x, dict):
        return ("map", tuple(sorted(
            (str(k), _abstract(v)) for k, v in x.items())))
    return ("py", type(x).__name__)


def _record_compile(name: str, reason: str, seconds: float) -> None:
    with _compile_lock:
        st = _compiles.get(name)
        if st is None:
            st = _compiles[name] = {"total": 0, "first": 0,
                                    "shape_miss": 0, "seconds": 0.0}
        st["total"] += 1
        st[reason] = st.get(reason, 0) + 1
        st["seconds"] += seconds


def instrument_step(fn: Callable, name: str) -> Callable:
    """Wrap a step entry point with compile detection.

    A call whose abstract input signature was never seen by THIS
    wrapper counts as a compilation (``jax.jit`` keys its executable
    cache the same way; eager torch compiles nothing, so here it is a
    new step shape): the first signature is ``reason="first"``, every
    later new signature a ``shape_miss``.  The wrapper is rebuilt
    together with the step it wraps (e.g. on a weight swap), so the
    wrapper's seen-set and the engine's own count stay in lockstep — the
    toy decoder's ``trace_count`` discipline cross-checks this in
    tests.  Compile seconds are the first call's wall time up to its
    outputs being ready (the cost a request actually pays)."""
    seen: set = set()
    lock = threading.Lock()

    def wrapped(*args, **kwargs):
        sig = (_abstract(args), _abstract(kwargs) if kwargs else None)
        with lock:
            is_new = sig not in seen
            if is_new:
                reason = "first" if not seen else "shape_miss"
                seen.add(sig)
        if not is_new:
            return fn(*args, **kwargs)
        t0 = time.time()
        out = fn(*args, **kwargs)
        _sync_devices(out)
        t1 = time.time()
        _record_compile(name, reason, t1 - t0)
        _tm.xla_compile(name, reason, t1 - t0)
        _tm.record_span("compile", name, t0, t1, reason=reason)
        return out

    wrapped._rtpu_instrumented = True  # step-instrumentation rule hook
    wrapped._rtpu_step_name = name
    wrapped.__wrapped__ = fn
    return wrapped


def is_instrumented(fn: Callable) -> bool:
    return bool(getattr(fn, "_rtpu_instrumented", False))


def compile_count(name: Optional[str] = None) -> int:
    """Compilations recorded in this process (one fn, or all)."""
    with _compile_lock:
        if name is not None:
            st = _compiles.get(name)
            return int(st["total"]) if st else 0
        return sum(int(st["total"]) for st in _compiles.values())


def compile_stats() -> Dict[str, Dict[str, Any]]:
    with _compile_lock:
        return {k: dict(v) for k, v in _compiles.items()}


# ---------------------------------------------------------------------------
# per-task device-seconds attribution (ray-tpu analyze exec split)
# ---------------------------------------------------------------------------

_tls = threading.local()


def device_seconds() -> float:
    """Device-compute seconds accumulated on THIS thread.  The worker
    snapshots the value around a task body; the delta rides the
    ``task_exec`` span as ``device_s`` so `ray-tpu analyze` can split
    ``exec`` into host and device time."""
    return getattr(_tls, "device_s", 0.0)


def add_device_seconds(seconds: float) -> None:
    if seconds > 0:
        _tls.device_s = getattr(_tls, "device_s", 0.0) + seconds


# ---------------------------------------------------------------------------
# step-time attribution
# ---------------------------------------------------------------------------

class _StepSpan:
    """Phase stamps of one step; every boundary is a ``time.time()``
    stamp, so the recorded phases telescope to the step's wall time
    exactly (the 5% acceptance gate only absorbs clock granularity)."""

    __slots__ = ("_mon", "_t0", "_t_host", "_t_dev", "_data_wait")

    def __init__(self, mon: "StepMonitor", data_wait_s: float):
        self._mon = mon
        self._data_wait = max(0.0, float(data_wait_s))
        self._t0 = time.time()
        self._t_host: Optional[float] = None
        self._t_dev: Optional[float] = None

    def dispatched(self) -> None:
        """The step call returned: host dispatch ends, device-compute
        bracketing starts."""
        self._t_host = time.time()

    def device_done(self, out: Any = None) -> Any:
        """Block until ``out`` is ready and stamp the device boundary.
        Returns ``out`` so call sites can chain."""
        if out is not None:
            _sync_devices(out)
        self._t_dev = time.time()
        return out

    def done(self, *, tokens: float = 0.0, requests: float = 0.0) -> None:
        t_end = time.time()
        t_host = self._t_host if self._t_host is not None else t_end
        t_dev = self._t_dev if self._t_dev is not None else t_host
        self._mon.record_step(
            data_wait_s=self._data_wait,
            host_s=max(0.0, t_host - self._t0),
            device_s=max(0.0, t_dev - t_host),
            sync_s=max(0.0, t_end - t_dev),
            tokens=tokens, requests=requests)


class StepMonitor:
    """Per-engine step-time attribution: the data_wait / host / device
    / sync phase ladder, rolling MFU, and goodput.

    ``plane`` routes the exported gauges: ``train`` feeds
    ``ray_tpu_train_mfu`` + ``ray_tpu_train_step_data_wait_frac``,
    ``serve`` feeds ``ray_tpu_serve_decode_device_frac{deployment}``,
    every plane feeds the ``ray_tpu_step_phase_seconds`` histograms
    and the goodput gauge.  MFU needs ``flops_per_token`` from the
    engine (0 disables it — goodput and phase fractions still work).
    """

    PHASES = ("data_wait", "host", "device", "sync")

    def __init__(self, plane: str, name: str = "", *,
                 deployment: str = "", flops_per_token: float = 0.0,
                 peak_flops: Optional[float] = None, window: int = 256):
        self.plane = plane
        self.name = name or plane
        self.deployment = deployment
        self.flops_per_token = float(flops_per_token)
        self.peak_flops = float(peak_flops) if peak_flops \
            else peak_flops_per_chip()
        self._lock = threading.Lock()
        self._window: "deque[Tuple[float, float, float, float, float]]" \
            = deque(maxlen=max(8, window))
        self._steps = 0
        self._sums = dict.fromkeys(self.PHASES, 0.0)
        self._tokens = 0.0
        self._requests = 0.0

    def step(self, data_wait_s: float = 0.0) -> _StepSpan:
        """Open one step's phase bracket (see :class:`_StepSpan`)."""
        return _StepSpan(self, data_wait_s)

    def record_step(self, *, data_wait_s: float = 0.0,
                    host_s: float = 0.0, device_s: float = 0.0,
                    sync_s: float = 0.0, tokens: float = 0.0,
                    requests: float = 0.0) -> None:
        """Record one step's phase split directly (engines that own
        their own stamps); :meth:`step` brackets funnel here."""
        with self._lock:
            self._steps += 1
            self._sums["data_wait"] += data_wait_s
            self._sums["host"] += host_s
            self._sums["device"] += device_s
            self._sums["sync"] += sync_s
            self._tokens += tokens
            self._requests += requests
            self._window.append((data_wait_s, host_s, device_s, sync_s,
                                 tokens))
            mfu, goodput, dev_frac, wait_frac = self._derive_locked()
        add_device_seconds(device_s)
        _tm.step_phase(self.plane, "data_wait", data_wait_s)
        _tm.step_phase(self.plane, "host", host_s)
        _tm.step_phase(self.plane, "device", device_s)
        _tm.step_phase(self.plane, "sync", sync_s)
        _tm.step_goodput(self.plane, goodput)
        if self.plane == "train":
            _tm.train_step_quality(mfu, wait_frac)
        elif self.plane == "serve" and self.deployment:
            _tm.serve_decode_device_frac(self.deployment, dev_frac)

    def _derive_locked(self) -> Tuple[float, float, float, float]:
        wait = host = dev = sync = tok = 0.0
        for dw, h, d, s, t in self._window:
            wait += dw
            host += h
            dev += d
            sync += s
            tok += t
        wall = wait + host + dev + sync
        if wall <= 0:
            return 0.0, 0.0, 0.0, 0.0
        goodput = tok / wall
        mfu = (goodput * self.flops_per_token / self.peak_flops) \
            if self.flops_per_token > 0 else 0.0
        return mfu, goodput, dev / wall, wait / wall

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            mfu, goodput, dev_frac, wait_frac = self._derive_locked()
            wall = sum(self._sums.values())
            return {
                "steps": self._steps,
                "phase_s": dict(self._sums),
                "wall_s": wall,
                "tokens": self._tokens,
                "requests": self._requests,
                "mfu": mfu,
                "goodput_per_s": goodput,
                "device_frac": dev_frac,
                "data_wait_frac": wait_frac,
            }


# ---------------------------------------------------------------------------
# gang straggler detection
# ---------------------------------------------------------------------------

class RankSkewWindow:
    """Rolling per-rank step durations of one gang; skew is the spread
    of the per-rank means over the window, and the straggler is the
    argmax rank.  Rank 0 (the gang driver) records everyone's duration
    per step — its own slice's compute time plus each remote rank's
    submit-to-arrival time — so no shard-protocol change is needed."""

    def __init__(self, world: int, window: int = 64):
        self.world = int(world)
        self._lock = threading.Lock()
        self._durs: List["deque[float]"] = [
            deque(maxlen=max(8, window)) for _ in range(self.world)]

    def record(self, durations_s: Dict[int, float]) -> None:
        with self._lock:
            for rank, dur in durations_s.items():
                if 0 <= int(rank) < self.world:
                    self._durs[int(rank)].append(float(dur))

    def snapshot(self) -> Dict[str, Any]:
        """{"rank_step_s": [...], "skew_s": float, "straggler": int}
        — means over the window; empty ranks report 0 and a gang with
        fewer than two reporting ranks has zero skew."""
        with self._lock:
            means = [(sum(d) / len(d)) if d else 0.0
                     for d in self._durs]
        reporting = [m for m in means if m > 0]
        if len(reporting) < 2:
            return {"rank_step_s": means, "skew_s": 0.0, "straggler": 0}
        skew = max(reporting) - min(reporting)
        straggler = max(range(len(means)), key=lambda r: means[r])
        return {"rank_step_s": means, "skew_s": skew,
                "straggler": straggler}


def reset_for_tests() -> None:
    """Clear process-global compile accounting (test isolation)."""
    with _compile_lock:
        _compiles.clear()
    _tls.device_s = 0.0
