"""Continuous sampling profiler with per-task time attribution.

Parity: the reference ships ``ray stack`` (py-spy one-shots) and a
py-spy-backed dashboard profiler button; neither is continuous and
neither attributes samples to *tasks*.  This module is the always-ON
capable half of the profiling plane: a per-process background thread
samples every Python thread's stack via ``sys._current_frames()`` at
``profiler_hz``, tags each sample with the task/actor/job currently
executing on that thread (the worker installs a provider over its
exec-thread tracking table), folds samples into bounded collapsed-stack
counts, and hands deltas to the existing telemetry flush loops, which
ship them to the GCS profile ring over the ``report_profile`` RPC
(drop-don't-block, like metrics/spans).

Design constraints, in priority order:

- **Off is free.**  ``profiler_enabled`` defaults to False; nothing
  starts, no thread exists, and the only hot-path cost anywhere in the
  runtime is the provider dict the worker maintains anyway for task
  cancellation.  The sampler thread is created lazily on the first
  ``configure(enabled=True)`` and parks on an Event while inactive.
- **On is cheap.**  One ``sys._current_frames()`` call per tick (a C
  traversal that takes the GIL briefly), frame->label strings cached by
  code identity, one lock acquisition per tick, plain-int overflow
  counters folded into real telemetry Counters only at drain time.
  At the default 25 Hz this measures <1% on the task microbenchmarks.
- **Bounded.**  The fold table holds at most ``profiler_max_stacks``
  distinct (task, stack) keys; samples that would create a new key
  beyond the cap are counted in ``stacks_dropped`` instead of stored.
  Stacks deeper than ``MAX_DEPTH`` keep their leaf-most frames under a
  ``<truncated>`` root.

Timestamps are wall-clock corrected by the process's GCS clock offset
at drain time (same timebase as spans/task events), so merged profiles
from many hosts describe one window.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core import telemetry as _tm

#: frames kept per stack (leaf-most win; deeper stacks get a
#: ``<truncated>`` root so recursion can't explode label length)
MAX_DEPTH = 64

#: provider signature: () -> {thread_ident: (task_name, task_id_hex,
#: actor_hex, job_hex)} for threads currently executing a task
TaskInfoProvider = Callable[[], Dict[int, Tuple]]

_IDLE_KEY = (None, None, None, None)


def _hz_default() -> float:
    try:
        from ray_tpu_torch.core.config import get_config
        return float(getattr(get_config(), "profiler_hz", 25.0))
    except Exception:  # noqa: BLE001 — config unavailable
        return 25.0


def _max_stacks() -> int:
    try:
        from ray_tpu_torch.core.config import get_config
        return int(getattr(get_config(), "profiler_max_stacks", 2000))
    except Exception:  # noqa: BLE001
        return 2000


class SamplingProfiler:
    """One per process; use the module-level singleton helpers."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._thread_ident: Optional[int] = None
        self._stop = False
        self._enabled = False
        self._deadline: Optional[float] = None  # monotonic; None = forever
        self._hz = _hz_default()
        self._provider: Optional[TaskInfoProvider] = None
        # fold state (guarded by _lock)
        self._folds: Dict[Tuple, int] = {}
        self._window_start: Optional[float] = None  # wall clock, local
        self._samples = 0          # samples folded this window
        self._stacks_dropped = 0   # samples lost to the max_stacks cap
        self.samples_total = 0     # lifetime (tests/observability)
        self.stacks_dropped_total = 0
        # frame label cache: (filename, firstlineno, name) -> label
        self._labels: Dict[Tuple, str] = {}
        # parked-thread fast path: ident -> (frame id, code id, lasti,
        # task_key, fold key).  A thread that hasn't moved since the
        # last tick (same top frame, same instruction) reuses its fold
        # key without walking the stack — most threads in most
        # processes sit in a selector/queue wait, so this turns the
        # steady-state tick into a few dict hits
        self._parked: Dict[int, Tuple] = {}
        # thread-name cache (threading.enumerate takes a lock + builds
        # a list; names only change when threads come and go)
        self._names: Dict[int, str] = {}
        self._names_tick = 0

    # -- control -------------------------------------------------------
    def set_task_info_provider(self, provider: TaskInfoProvider) -> None:
        self._provider = provider

    def configure(self, enabled: bool, hz: Optional[float] = None,
                  duration_s: Optional[float] = None) -> None:
        """Process-local switch (driven by config at boot, by the
        ``profiler_control`` RPC at runtime)."""
        with self._lock:
            self._enabled = bool(enabled)
            if hz:
                self._hz = max(1.0, min(200.0, float(hz)))
            if enabled:
                self._deadline = (time.monotonic() + float(duration_s)
                                  if duration_s else None)
        if enabled:
            self._ensure_thread()
            self._wake.set()
        else:
            self._wake.clear()

    def active(self) -> bool:
        if not self._enabled:
            return False
        if self._deadline is not None and time.monotonic() > self._deadline:
            return False
        return True

    def stop(self) -> None:
        """Tear down the sampler thread (tests / process exit)."""
        self._stop = True
        self._enabled = False
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None
        self._stop = False
        self._wake.clear()

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        t = threading.Thread(target=self._run, name="rtpu-profiler",
                             daemon=True)
        self._thread = t
        t.start()

    # -- sampler loop --------------------------------------------------
    def _run(self) -> None:
        self._thread_ident = threading.get_ident()
        while not self._stop:
            if not self.active():
                if self._enabled and self._deadline is not None:
                    # duration elapsed: fall back to dormant until the
                    # next configure() — folded samples stay buffered
                    # for the flush loop to drain
                    self._enabled = False
                    self._wake.clear()
                self._wake.wait(timeout=1.0)
                continue
            t0 = time.perf_counter()
            try:
                self._sample_once()
            except Exception:  # noqa: BLE001 — sampling must never die
                pass
            delay = max(0.001, 1.0 / self._hz - (time.perf_counter() - t0))
            time.sleep(delay)

    def _frame_label(self, code) -> str:
        key = (code.co_filename, code.co_firstlineno, code.co_name)
        label = self._labels.get(key)
        if label is None:
            base = os.path.basename(code.co_filename)
            label = f"{code.co_name} ({base}:{code.co_firstlineno})"
            if len(self._labels) < 65536:
                self._labels[key] = label
        return label

    def _sample_once(self) -> None:
        provider = self._provider
        info = provider() if provider is not None else {}
        frames = sys._current_frames()
        now = time.time()
        cap = _max_stacks()
        names = self._names
        self._names_tick -= 1
        if self._names_tick <= 0 or any(i not in names for i in frames):
            names = self._names = {t.ident: t.name
                                   for t in threading.enumerate()}
            self._names_tick = 64
            # reap parked entries of exited threads
            for ident in list(self._parked):
                if ident not in frames:
                    del self._parked[ident]
        parked = self._parked
        with self._lock:
            if self._window_start is None:
                self._window_start = now
            for ident, frame in frames.items():
                if ident == self._thread_ident:
                    continue
                task_key = info.get(ident, _IDLE_KEY)
                # ids, not the objects: caching the frame would pin its
                # locals (and the whole stack) past the thread's use.
                # id reuse with identical lasti+code can misattribute a
                # tick — acceptable at sampling granularity.
                cached = parked.get(ident)
                if cached is not None \
                        and cached[0] == id(frame) \
                        and cached[1] == id(frame.f_code) \
                        and cached[2] == frame.f_lasti \
                        and cached[3] == task_key:
                    key = cached[4]
                else:
                    stack: List[str] = []
                    depth = 0
                    f = frame
                    while f is not None and depth < MAX_DEPTH:
                        stack.append(self._frame_label(f.f_code))
                        f = f.f_back
                        depth += 1
                    if f is not None:
                        stack.append("<truncated>")
                    stack.reverse()  # root first (collapsed order)
                    key = (task_key, names.get(ident, str(ident)),
                           tuple(stack))
                    parked[ident] = (id(frame), id(frame.f_code),
                                     frame.f_lasti, task_key, key)
                cur = self._folds.get(key)
                if cur is None and len(self._folds) >= cap:
                    self._stacks_dropped += 1
                    self.stacks_dropped_total += 1
                    continue
                self._folds[key] = (cur or 0) + 1
                self._samples += 1
                self.samples_total += 1

    # -- drain (called by the telemetry flush loops) -------------------
    def drain(self) -> List[Dict[str, Any]]:
        """Pop the window's folded stacks as wire records, clock-
        corrected onto the GCS timebase.  Also folds the window's
        plain-int sample/drop counters into telemetry Counters (same
        presample pattern as the RPC byte accumulators)."""
        with self._lock:
            if not self._folds and not self._stacks_dropped:
                return []
            folds, self._folds = self._folds, {}
            start = self._window_start or time.time()
            self._window_start = None
            samples, self._samples = self._samples, 0
            dropped, self._stacks_dropped = self._stacks_dropped, 0
        off = _tm.clock_offset()
        end = time.time() + off
        pid = os.getpid()
        out: List[Dict[str, Any]] = []
        for (task_key, thread_name, stack), count in folds.items():
            task, task_id, actor, job = task_key
            out.append({
                "stack": ";".join(stack),
                "count": count,
                "task": task,
                "task_id": task_id,
                "actor": actor,
                "job": job,
                "thread": thread_name,
                "pid": pid,
                "start": start + off,
                "end": end,
            })
        if samples:
            _tm.profiler_samples(samples)
        if dropped:
            _tm.profiler_stack_drops(dropped)
        return out

    def _reset_for_tests(self) -> None:
        self.stop()
        with self._lock:
            self._folds.clear()
            self._window_start = None
            self._samples = 0
            self._stacks_dropped = 0
            self.samples_total = 0
            self.stacks_dropped_total = 0
            self._deadline = None
            self._hz = _hz_default()


# ---------------------------------------------------------------------------
# process singleton
# ---------------------------------------------------------------------------

_profiler: Optional[SamplingProfiler] = None
_singleton_lock = threading.Lock()


def get_profiler() -> SamplingProfiler:
    global _profiler
    if _profiler is None:
        with _singleton_lock:
            if _profiler is None:
                _profiler = SamplingProfiler()
    return _profiler


def set_task_info_provider(provider: TaskInfoProvider) -> None:
    get_profiler().set_task_info_provider(provider)


def configure(enabled: bool, hz: Optional[float] = None,
              duration_s: Optional[float] = None) -> None:
    get_profiler().configure(enabled, hz=hz, duration_s=duration_s)


def active() -> bool:
    p = _profiler
    return p is not None and p.active()


def pending() -> bool:
    """True while a DURATION-BOUNDED window is active or folded samples
    await a flush — the flush loops fast-tick (>=1 Hz) on this so a
    short ``ray-tpu profile --duration 2`` sees its samples arrive.
    Open-ended always-on profiling flushes at the normal metrics period
    (latency doesn't matter there; the fast tick would cost idle CPU
    forever)."""
    p = _profiler
    if p is None:
        return False
    if p.active() and p._deadline is not None:
        return True
    return bool(p._folds) and not p.active()


def drain() -> List[Dict[str, Any]]:
    p = _profiler
    if p is None:
        return []
    return p.drain()


def maybe_start_from_config() -> None:
    """Boot-time hook: start sampling when ``profiler_enabled`` is set
    (config or RAY_TPU_TORCH_PROFILER_ENABLED env) — the always-on mode."""
    try:
        from ray_tpu_torch.core.config import get_config
        if bool(getattr(get_config(), "profiler_enabled", False)):
            configure(True)
    except Exception:  # noqa: BLE001 — config unavailable: stay off
        pass


# ---------------------------------------------------------------------------
# output formats (consumed by the CLI, dashboard, and tests)
# ---------------------------------------------------------------------------

def merge_records(records: List[Dict[str, Any]],
                  by_task: bool = True) -> List[Dict[str, Any]]:
    """Merge records across workers/processes: same (stack, attribution)
    sums counts.  ``by_task=False`` collapses attribution entirely
    (pure cluster flamegraph)."""
    merged: Dict[Tuple, Dict[str, Any]] = {}
    for rec in records:
        key = (rec.get("stack"),
               (rec.get("task"), rec.get("job")) if by_task else None)
        cur = merged.get(key)
        if cur is None:
            cur = dict(rec)
            cur.pop("pid", None)
            cur.pop("thread", None)
            if not by_task:
                for k in ("task", "task_id", "actor", "job"):
                    cur.pop(k, None)
            merged[key] = cur
        else:
            cur["count"] += rec.get("count", 0)
            cur["start"] = min(cur.get("start", 0), rec.get("start", 0))
            cur["end"] = max(cur.get("end", 0), rec.get("end", 0))
    out = sorted(merged.values(), key=lambda r: -r["count"])
    return out


def to_collapsed(records: List[Dict[str, Any]]) -> str:
    """Brendan-Gregg collapsed-stack text (flamegraph.pl / speedscope
    both ingest it).  Task attribution becomes the root frame so one
    flamegraph splits by task."""
    lines = []
    for rec in records:
        stack = rec.get("stack") or "<unknown>"
        root = rec.get("task")
        if root:
            stack = f"task:{root};{stack}"
        lines.append(f"{stack} {rec.get('count', 0)}")
    return "\n".join(lines) + ("\n" if lines else "")


def to_speedscope(records: List[Dict[str, Any]],
                  name: str = "ray_tpu profile") -> Dict[str, Any]:
    """speedscope 'sampled' profile (https://speedscope.app file
    format): shared frame table + per-sample frame-index lists with
    fold counts as weights."""
    frame_index: Dict[str, int] = {}
    frames: List[Dict[str, str]] = []
    samples: List[List[int]] = []
    weights: List[int] = []
    for rec in records:
        stack = rec.get("stack") or "<unknown>"
        parts = ([f"task:{rec['task']}"] if rec.get("task") else []) \
            + stack.split(";")
        idxs = []
        for part in parts:
            idx = frame_index.get(part)
            if idx is None:
                idx = frame_index[part] = len(frames)
                frames.append({"name": part})
            idxs.append(idx)
        samples.append(idxs)
        weights.append(int(rec.get("count", 0)))
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled",
            "name": name,
            "unit": "none",
            "startValue": 0,
            "endValue": total,
            "samples": samples,
            "weights": weights,
        }],
        "name": name,
        "activeProfileIndex": 0,
        "exporter": "ray_tpu",
    }
