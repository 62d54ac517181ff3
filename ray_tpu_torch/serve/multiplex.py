"""Model multiplexing: N small models share one replica's chip.

The long tail of low-QPS deployments is the serving-economics problem
``DeploymentConfig.multiplexed_models`` solves: instead of pinning one
deployment (and its chips) per fine-tune, a single replica hosts N
models and swaps weights on demand.  :class:`MultiplexEngine` wraps the
user's engine factory and implements the continuous-batcher engine
protocol (``batching.py``) with one extension — ``step`` takes a
per-slot **model-id vector**, so one batch freely mixes requests for
different models (each distinct model in the batch runs one masked
sub-step).

Residency is LRU-bounded (``multiplex_max_resident``): an evicted model
drops its live engine but keeps its weights as a sealed **arena
object** (``export_weights`` -> ``ray_tpu_torch.put``), so the next swap-in
reloads by ref through the transfer/spill plane (``load_weights``)
instead of re-initializing — the same move-by-ref discipline the KV
page table uses.  Swap count and latency are measured
(``ray_tpu_serve_mux_swaps_total`` / ``..._swap_seconds``): the router
prefers replicas where the request's model is already resident, so in
steady state swaps are rare and the histogram prices the misses.

A failed swap raises :class:`~ray_tpu_torch.serve.batching.ModelSwapFailed`
— retryable, the router excludes the replica pick WITHOUT marking it
dead (its resident models keep serving).  The ``serve.mux.swap_fail``
failpoint injects exactly that fault.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve.batching import ModelSwapFailed, host_array
from ray_tpu_torch.util import failpoint as _fp

__all__ = ["MultiplexEngine"]


class MultiplexEngine:
    """Engine-protocol adapter hosting N models behind one batcher.

    ``factory(*init_args, **{**init_kwargs, **models[m]})`` builds model
    ``m``'s engine — each model's dict overrides the deployment's init
    kwargs (for :class:`~ray_tpu_torch.serve.toy_decoder.ToyDecoder`, e.g.
    ``{"seed": 3}``).  The first model listed is the default for
    requests that carry no ``"model"`` field.  ``begin_request`` /
    ``finish_request`` parse with the default engine (they must not
    depend on weights); ``prefill`` and ``step`` run on the request's
    own model, swapping it resident first.
    """

    #: batcher hook: step() takes a per-slot model-id vector
    multiplexed = True

    #: bounded ring of swap latencies (replica metrics p50 source)
    _SWAP_RING = 256

    def __init__(self, factory: Any, init_args: tuple = (),
                 init_kwargs: Optional[Dict[str, Any]] = None,
                 models: Optional[Dict[str, Any]] = None,
                 max_resident: int = 0, deployment: str = ""):
        if not models:
            raise ValueError("multiplexed_models must name >= 1 model")
        self._factory = factory
        self._args = tuple(init_args or ())
        self._kwargs = dict(init_kwargs or {})
        self._models: Dict[str, Dict[str, Any]] = {
            str(k): dict(v or {}) for k, v in models.items()}
        self._default = next(iter(self._models))
        self._max_resident = max(0, int(max_resident))  # 0 = unbounded
        self._deployment = deployment
        self._lock = threading.RLock()
        self._resident: "OrderedDict[str, Any]" = OrderedDict()
        self._weight_refs: Dict[str, Any] = {}
        self.swaps_total = 0
        self.evictions_total = 0
        self.loads_by_ref_total = 0
        self._swap_ms: List[float] = []
        # the default model is resident up front and doubles as the
        # weight-independent parser for begin/finish/kv_page_payload
        self._parser = self._engine_for(self._default)
        self.pad_token = getattr(self._parser, "pad_token", 0)
        self.eos_token = getattr(self._parser, "eos_token", None)

    # -- residency ---------------------------------------------------------
    def _engine_for(self, model: str) -> Any:
        """Return the model's engine, swapping it resident if needed.
        The whole swap runs under the lock — concurrent requests for a
        cold model serialize behind one build instead of double
        building.  Raises :class:`ModelSwapFailed` on any failure."""
        with self._lock:
            eng = self._resident.get(model)
            if eng is not None:
                self._resident.move_to_end(model)
                return eng
            if model not in self._models:
                raise ModelSwapFailed(self._deployment, model)
            try:
                _fp.failpoint("serve.mux.swap_fail")
            except Exception as e:  # noqa: BLE001 — injected fault
                raise ModelSwapFailed(self._deployment, model) from e
            t0 = time.perf_counter()
            try:
                # model swaps are deliberately serialized under _lock:
                # a concurrent second swap of the same (or an LRU-racy
                # other) model would double-load weights over the arena
                # rtpu-check: disable=lock-order-cycle
                eng = self._swap_in_locked(model)
            except ModelSwapFailed:
                raise
            except Exception as e:  # noqa: BLE001 — build/load error
                raise ModelSwapFailed(self._deployment, model) from e
            dt = time.perf_counter() - t0
            self.swaps_total += 1
            self._swap_ms.append(dt * 1e3)
            if len(self._swap_ms) > self._SWAP_RING:
                del self._swap_ms[:-self._SWAP_RING]
        self._emit_swap(dt)
        return eng

    def _swap_in_locked(self, model: str) -> Any:
        kw = dict(self._kwargs)
        kw.update(self._models[model])
        eng = self._factory(*self._args, **kw)
        ref = self._weight_refs.get(model)
        if ref is not None and hasattr(eng, "load_weights"):
            # weights ride the arena: the sealed export pulls back by
            # ref (transfer plane / spill restore) instead of whatever
            # the factory just initialized
            import ray_tpu_torch

            eng.load_weights(ray_tpu_torch.get(ref, timeout=30))
            self.loads_by_ref_total += 1
        elif hasattr(eng, "export_weights"):
            try:
                import ray_tpu_torch

                self._weight_refs[model] = ray_tpu_torch.put(
                    eng.export_weights())
            except Exception:  # noqa: BLE001 — no cluster (unit test):
                pass  # future swaps rebuild from the factory instead
        self._resident[model] = eng
        while self._max_resident > 0 \
                and len(self._resident) > self._max_resident:
            self._resident.popitem(last=False)  # LRU; engine drops,
            self.evictions_total += 1           # weights stay by ref
        return eng

    def _emit_swap(self, seconds: float) -> None:
        try:
            from ray_tpu_torch.core import telemetry as _tm

            _tm.serve_mux_swap(self._deployment, seconds)
        except Exception:  # noqa: BLE001 — stats must not fail serving
            pass

    # -- engine protocol ---------------------------------------------------
    def begin_request(self, payload: Any) -> Dict[str, Any]:
        """Parse with the default engine (cheap — runs under the
        batcher lock; the swap happens later in ``prefill``, off the
        lock) and pin the request to its model id."""
        model = self._default
        if isinstance(payload, dict) and payload.get("model"):
            model = str(payload["model"])
        if model not in self._models:
            raise ValueError(
                f"unknown model {model!r}; deployment "
                f"{self._deployment!r} multiplexes {list(self._models)}")
        state = self._parser.begin_request(payload)
        state["model"] = model
        return state

    def prefill(self, state: Dict[str, Any]) -> Dict[str, Any]:
        eng = self._engine_for(str(state.get("model") or self._default))
        pf = getattr(eng, "prefill", None)
        return pf(state) if pf is not None else state

    def kv_page_payload(self, tokens: List[int]):
        """Pages carry the shared-base payload (tokens self-describe
        the page; see kv_cache.py) — the prefix cache additionally
        salts chain keys with the model id, so models never share
        chains even though the payload hook is common."""
        hook = getattr(self._parser, "kv_page_payload", None)
        return hook(tokens) if hook is not None else None

    def step(self, tokens, lengths, active, models=None):
        """One decode step over a mixed-model batch: group active slots
        by model, run one masked sub-step per distinct model, merge the
        next-token vectors.  Sub-steps reuse each engine's own step
        (one signature per (model, bucket))."""
        import numpy as np

        B = len(active)
        out = np.full((B,), int(self.pad_token or 0), dtype=np.int32)
        groups: Dict[str, List[int]] = {}
        for i in range(B):
            if bool(active[i]):
                m = str((models[i] if models is not None else None)
                        or self._default)
                groups.setdefault(m, []).append(i)
        for model, idxs in groups.items():
            eng = self._engine_for(model)
            sub_active = np.zeros((B,), dtype=bool)
            sub_active[idxs] = True
            sub = host_array(
                eng.step(tokens, lengths, sub_active)).reshape(-1)
            out[idxs] = sub[idxs]
        return out

    def finish_request(self, state: Dict[str, Any]) -> Any:
        model = str(state.get("model") or self._default)
        with self._lock:
            eng = self._resident.get(model)
        return (eng or self._parser).finish_request(state)

    # -- stats -------------------------------------------------------------
    def mux_stats(self) -> Dict[str, Any]:
        with self._lock:
            sms = sorted(self._swap_ms)
            return {
                "mux_models_total": len(self._models),
                "mux_resident_models": list(self._resident),
                "mux_max_resident": self._max_resident,
                "mux_swaps_total": self.swaps_total,
                "mux_evictions_total": self.evictions_total,
                "mux_loads_by_ref_total": self.loads_by_ref_total,
                "mux_swap_p50_ms": sms[len(sms) // 2] if sms else 0.0,
            }
