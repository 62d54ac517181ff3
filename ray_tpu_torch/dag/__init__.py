"""Lazy task/actor graphs (reference ``python/ray/dag/``)."""

from ray_tpu_torch.dag.dag_node import (  # noqa: F401
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
)
