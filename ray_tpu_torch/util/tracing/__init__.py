"""Distributed tracing (reference ``ray.util.tracing``)."""

from ray_tpu_torch.util.tracing.tracing_helper import (  # noqa: F401
    current_trace_context,
    enable_tracing,
    execute_with_trace,
    is_tracing_enabled,
)
