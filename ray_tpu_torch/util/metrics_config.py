"""Prometheus + Grafana bootstrap configs for the metrics pipeline.

Parity: reference ``dashboard/modules/metrics/`` — Ray writes a ready
to-run ``prometheus.yml`` (scraping the cluster's exporters) and a
Grafana provisioning tree with a default dashboard, so operators get
graphs without hand-writing scrape configs.  Here the cluster's one
Prometheus surface is the head dashboard's ``/metrics`` endpoint
(``ray_tpu_torch/dashboard.py`` aggregates Counter/Gauge/Histogram from the
GCS), plus each node agent's stats endpoint.

The files, the job and datasource names and the ``ray_tpu_*`` metric
names are the JAX package's: the port's dashboard emits the same
metrics, so one Prometheus and Grafana setup reads either runtime.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

PROMETHEUS_YML = """\
# generated by `ray-tpu metrics export-config` — scrapes the ray_tpu
# head dashboard's Prometheus endpoint
global:
  scrape_interval: 10s
  evaluation_interval: 10s

scrape_configs:
  - job_name: ray_tpu
    metrics_path: /metrics
    static_configs:
      - targets: ["{dashboard_address}"]
        labels:
          cluster: ray_tpu
"""

GRAFANA_INI = """\
# generated by `ray-tpu metrics export-config`
[security]
allow_embedding = true

[auth.anonymous]
enabled = true
org_role = Viewer

[paths]
provisioning = {provisioning_dir}
"""

GRAFANA_DATASOURCE_YML = """\
apiVersion: 1
datasources:
  - name: ray_tpu-prometheus
    type: prometheus
    access: proxy
    url: http://{prometheus_address}
    isDefault: true
"""

GRAFANA_DASHBOARDS_YML = """\
apiVersion: 1
providers:
  - name: ray_tpu
    folder: ray_tpu
    type: file
    options:
      path: {dashboards_dir}
"""


def _default_dashboard() -> dict:
    def panel(pid, title, expr, y):
        return {
            "id": pid, "title": title, "type": "timeseries",
            "datasource": "ray_tpu-prometheus",
            "gridPos": {"h": 8, "w": 12, "x": (pid % 2) * 12, "y": y},
            "targets": [{"expr": expr, "refId": "A"}],
        }

    return {
        "title": "ray_tpu cluster",
        "uid": "ray-tpu-default",
        "timezone": "browser",
        "refresh": "10s",
        "panels": [
            panel(0, "tasks finished/s",
                  "rate(ray_tpu_tasks_finished_total[1m])", 0),
            panel(1, "object store used bytes",
                  "ray_tpu_object_store_used_bytes", 0),
            panel(2, "alive nodes", "ray_tpu_alive_nodes", 8),
            panel(3, "actors alive", "ray_tpu_actors_alive", 8),
        ],
        "schemaVersion": 36,
    }


def write_configs(output_dir: str, *,
                  dashboard_address: Optional[str] = None,
                  prometheus_address: str = "127.0.0.1:9090"
                  ) -> List[str]:
    """Write the Prometheus + Grafana provisioning tree; returns the
    written paths.  Point ``prometheus --config.file`` and ``grafana
    --config`` at them (reference parity:
    ``dashboard/modules/metrics/install_and_start_prometheus.py``
    writes the same shape)."""
    dashboard_address = dashboard_address or "127.0.0.1:8265"
    os.makedirs(output_dir, exist_ok=True)
    grafana_dir = os.path.join(output_dir, "grafana")
    provisioning = os.path.join(grafana_dir, "provisioning")
    dashboards_dir = os.path.join(grafana_dir, "dashboards")
    for d in (os.path.join(provisioning, "datasources"),
              os.path.join(provisioning, "dashboards"), dashboards_dir):
        os.makedirs(d, exist_ok=True)

    written = []

    def write(path, text):
        with open(path, "w") as f:
            f.write(text)
        written.append(path)

    write(os.path.join(output_dir, "prometheus.yml"),
          PROMETHEUS_YML.format(dashboard_address=dashboard_address))
    write(os.path.join(grafana_dir, "grafana.ini"),
          GRAFANA_INI.format(provisioning_dir=provisioning))
    write(os.path.join(provisioning, "datasources", "default.yml"),
          GRAFANA_DATASOURCE_YML.format(
              prometheus_address=prometheus_address))
    write(os.path.join(provisioning, "dashboards", "default.yml"),
          GRAFANA_DASHBOARDS_YML.format(dashboards_dir=dashboards_dir))
    write(os.path.join(dashboards_dir, "ray_tpu_default.json"),
          json.dumps(_default_dashboard(), indent=1))
    return written
