"""Deployment-graph driver.

Parity: reference ``serve/drivers.py`` (``DAGDriver``) +
``deployment_graph_build.py`` — compose deployed models into a DAG
(preprocess -> model -> postprocess) served behind one endpoint.  Graph
nodes are either plain ``@remote`` function nodes (``fn.bind``) or
calls into live deployments via :func:`deployment_node`; the driver is
itself a deployment executing the DAG per request, so every edge rides
the object plane and stages run in parallel where the DAG allows.
"""

from __future__ import annotations

from typing import Any

import ray_tpu_torch
from ray_tpu_torch.dag.dag_node import DAGNode, _ExecContext


class DeploymentMethodNode(DAGNode):
    """A bound call to a deployed Serve deployment (by name)."""

    def __init__(self, deployment_name: str, method: str,
                 args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._deployment_name = deployment_name
        self._method = method

    def _execute_impl(self, ctx: _ExecContext):
        from ray_tpu_torch import serve

        handle = serve.get_deployment_handle(self._deployment_name)
        args, kwargs = self._resolve_args(ctx)
        if self._method != "__call__":
            handle = getattr(handle, self._method)
        return handle.remote(*args, **kwargs)


class _DeploymentNodeStub:
    def __init__(self, deployment_name: str, method: str = "__call__"):
        self._name = deployment_name
        self._method = method

    def bind(self, *args, **kwargs) -> DeploymentMethodNode:
        return DeploymentMethodNode(self._name, self._method, args, kwargs)

    def __getattr__(self, method: str) -> "_DeploymentNodeStub":
        if method.startswith("_"):
            raise AttributeError(method)
        return _DeploymentNodeStub(self._name, method)


def deployment_node(deployment_name: str) -> _DeploymentNodeStub:
    """Graph node factory over a deployed deployment:
    ``deployment_node("model").bind(upstream)`` or
    ``deployment_node("model").predict.bind(...)``."""
    return _DeploymentNodeStub(deployment_name)


class _DAGDriverImpl:
    """The driver callable hosted in a replica: executes the DAG per
    request (reference ``DAGDriver.predict``)."""

    def __init__(self, dag: DAGNode):
        self._dag = dag

    def __call__(self, request: Any) -> Any:
        out = self._dag.execute(request)
        if isinstance(out, ray_tpu_torch.ObjectRef):
            return ray_tpu_torch.get(out)
        return out


def DAGDriver(num_replicas: int = 1):
    """Deployment factory: ``serve.run(DAGDriver().bind(dag))``."""
    from ray_tpu_torch import serve

    return serve.deployment(name="DAGDriver",
                            num_replicas=num_replicas)(_DAGDriverImpl)
