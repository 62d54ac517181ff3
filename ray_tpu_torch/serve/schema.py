"""Declarative Serve config (parity: reference ``serve/schema.py`` +
``serve deploy`` — a YAML/dict of applications with import paths and
deployment overrides, applied idempotently).

Config shape (the reference's multi-app schema, trimmed to the options
this serve implements)::

    applications:
      - name: app1                       # optional label
        import_path: mymodule:app        # module:attr -> Application or
                                         # Deployment (bind() optional)
        args: {}                         # passed to .bind(**args)
        deployments:                     # per-deployment overrides
          - name: Echo
            num_replicas: 2
            max_concurrent_queries: 16
            user_config: {...}
            autoscaling_config: {...}

``deploy_config`` imports each application, applies the overrides, and
``serve.run``s it; existing deployments roll to the new version (the
controller's rolling update path).
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional, Union

OVERRIDE_KEYS = ("num_replicas", "max_concurrent_queries", "user_config",
                 "ray_actor_options", "autoscaling_config", "batching",
                 "max_queued_requests")


def _import_target(import_path: str):
    module_name, _, attr = import_path.partition(":")
    if not attr:
        raise ValueError(
            f"import_path {import_path!r} must be 'module:attribute'")
    module = importlib.import_module(module_name)
    target = module
    for part in attr.split("."):
        target = getattr(target, part)
    return target


def _apply_overrides(deployment, override: Dict[str, Any]):
    opts = {k: override[k] for k in OVERRIDE_KEYS if k in override}
    return deployment.options(**opts) if opts else deployment


def deploy_config(config: Union[str, Dict[str, Any]]) -> List[str]:
    """Deploy every application in a config dict or YAML file path;
    returns the deployed deployment names."""
    from ray_tpu_torch import serve

    if isinstance(config, str):
        import yaml

        with open(config) as f:
            config = yaml.safe_load(f)
    apps = config.get("applications")
    if apps is None:  # single-app shorthand
        apps = [config]
    deployed: List[str] = []
    for app_cfg in apps:
        target = _import_target(app_cfg["import_path"])
        overrides = {d["name"]: d
                     for d in app_cfg.get("deployments", []) or []}
        cfg_args = dict(app_cfg.get("args") or {})
        if isinstance(target, serve.Application):
            deployment = target.deployment
            # config args, when given, replace the bind's
            args, kwargs = ((), cfg_args) if cfg_args \
                else (target.args, target.kwargs)
        elif isinstance(target, serve.Deployment):
            deployment = target
            args, kwargs = (), cfg_args
        else:
            raise TypeError(
                f"{app_cfg['import_path']} resolved to "
                f"{type(target).__name__}; expected a serve Deployment "
                f"or a bound Application")
        unknown = set(overrides) - {deployment.name}
        if unknown:
            raise ValueError(
                f"config overrides for unknown deployments "
                f"{sorted(unknown)}; {app_cfg['import_path']} provides "
                f"{deployment.name!r}")
        if deployment.name in overrides:
            deployment = _apply_overrides(deployment,
                                          overrides[deployment.name])
        serve.run(deployment.bind(*args, **kwargs))
        deployed.append(deployment.name)
    return deployed


def status_config() -> Dict[str, Any]:
    """Current applications in the schema's status shape (parity:
    ``serve status`` against the REST API)."""
    from ray_tpu_torch import serve

    deployments = serve.status()
    return {
        "applications": {
            name: {
                "status": "RUNNING" if info.get("num_replicas", 0) > 0
                else "DEPLOYING",
                "deployments": {name: {
                    "status": "HEALTHY"
                    if info.get("stale_replicas", 0) == 0 else "UPDATING",
                    "replica_states": {
                        "RUNNING": info.get("num_replicas", 0)},
                }},
            }
            for name, info in deployments.items()
        }
    }
