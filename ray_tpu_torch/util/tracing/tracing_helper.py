"""Opt-in OpenTelemetry trace propagation across task boundaries.

Parity: reference ``python/ray/util/tracing/tracing_helper.py`` —
``_OpenTelemetryProxy`` (:33) defers the opentelemetry import so the
runtime works without it; ``_DictPropagator.inject_current_context``
(:160) serializes the active span context into the task spec at
submission, and the executing worker reattaches it as the parent, so a
user-configured exporter sees one distributed trace spanning driver and
workers.  TPU twist (SURVEY.md §5): ``execute_with_trace`` names spans
after the task descriptor, which lines up with XLA profiler annotations
when the user also runs ``jax.profiler``.

Enabled explicitly via :func:`enable_tracing` (reference:
``ray.init(_tracing_startup_hook=...)``); disabled costs one boolean
check per submission.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

_enabled = False
_otel = None  # lazily-imported module bundle


class _Otel:
    def __init__(self):
        from opentelemetry import context, propagate, trace
        self.context = context
        self.propagate = propagate
        self.trace = trace
        self.tracer = trace.get_tracer("ray_tpu_torch")


def enable_tracing(startup_hook: Optional[Callable[[], None]] = None
                   ) -> bool:
    """Turn on context propagation; ``startup_hook`` may install the
    user's TracerProvider/exporter (reference ``_tracing_startup_hook``).
    Returns False (and stays disabled) when opentelemetry is absent —
    checked before the hook runs, so its side effects don't leak into a
    process where tracing can never activate."""
    global _enabled, _otel
    try:
        _otel = _Otel()
    except ImportError:
        return False
    if startup_hook is not None:
        startup_hook()
    _enabled = True
    return True


def is_tracing_enabled() -> bool:
    return _enabled


def current_trace_context() -> Optional[Dict[str, str]]:
    """W3C traceparent carrier for the active span, or None when
    disabled/absent — stored on the TaskSpec by the submitter."""
    if not _enabled or _otel is None:
        return None
    carrier: Dict[str, str] = {}
    _otel.propagate.inject(carrier)
    return carrier or None


def execute_with_trace(fn: Callable, descriptor: str,
                       carrier: Optional[Dict[str, str]],
                       *args, **kwargs) -> Any:
    """Run ``fn`` under a span parented to the submitted context.

    A worker never called enable_tracing() itself — the submitted
    carrier IS the enable signal, so the otel bundle is built lazily
    here (without it, the worker half of tracing would be dead code)."""
    global _otel
    if carrier is None:
        return fn(*args, **kwargs)
    if _otel is None:
        try:
            _otel = _Otel()
        except ImportError:
            return fn(*args, **kwargs)
    ctx = _otel.propagate.extract(carrier)
    with _otel.tracer.start_as_current_span(f"task.run::{descriptor}",
                                            context=ctx):
        return fn(*args, **kwargs)
