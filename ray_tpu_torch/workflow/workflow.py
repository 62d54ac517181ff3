"""Durable DAG execution.

Parity: reference ``python/ray/workflow/`` — ``workflow.run`` executes a
task DAG with every step's output persisted
(``WorkflowStorage``:229, ``workflow_storage.py``), so a crashed or
interrupted workflow resumes (``workflow.resume``) by replaying only the
steps whose outputs are not yet on disk; observable outputs are
exactly-once (steps themselves are at-least-once, same contract as the
reference).  DAG structure comes from ``ray_tpu_torch.dag``
(``workflow_state_from_dag.py`` analog).

Step identity is positional: a deterministic DFS numbering of the DAG,
qualified by the function name — stable across runs of the same
program, which is what resume correctness needs.

Step outputs, events and the DAG itself are written with cloudpickle
under the object store's tensor rule (``core.serialization.
dump_in_band``): a tensor is stored as its raw bytes with its shape,
dtype and device kind, whatever pickle's own tensor format would be.
A step's CUDA tensor output so reloads, bit for bit, on the current
card of a resumed driver in a fresh process (and raises there if that
process has no CUDA); a CPU tensor reloads on the CPU.  The default
storage root is ``~/.ray_tpu_torch_workflows``, not the JAX package's,
so that neither runtime reads the other's pickles.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.core import serialization
from ray_tpu_torch.dag.dag_node import (ClassMethodNode, ClassNode, DAGNode,
                                        FunctionNode, InputAttributeNode,
                                        InputNode)

RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
RESUMABLE = "RESUMABLE"

_storage_dir: Optional[str] = None


def init(storage: Optional[str] = None) -> None:
    """Set the workflow storage root (reference ``workflow.init``)."""
    global _storage_dir
    _storage_dir = storage or _storage_dir or os.path.join(
        os.path.expanduser("~"), ".ray_tpu_torch_workflows")
    os.makedirs(_storage_dir, exist_ok=True)


def _root() -> str:
    if _storage_dir is None:
        init()
    return _storage_dir


def _dump(value: Any, path: str) -> None:
    """Write ``value`` to ``path`` atomically (tmp + rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        serialization.dump_in_band(value, f)
    os.replace(tmp, path)


class WorkflowStorage:
    """Filesystem step-output store (reference ``WorkflowStorage``:229).

    Writes are atomic (tmp + rename) so a crash can't leave a partial
    output that later reads as completed.
    """

    def __init__(self, workflow_id: str):
        self.workflow_id = workflow_id
        self.dir = os.path.join(_root(), workflow_id)
        os.makedirs(os.path.join(self.dir, "steps"), exist_ok=True)

    def _step_path(self, step_id: str) -> str:
        # continuation steps are namespaced "parent/child" — nested dirs
        return os.path.join(self.dir, "steps", *step_id.split("/")) + ".pkl"

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(self._step_path(step_id))

    def load_step(self, step_id: str) -> Any:
        with open(self._step_path(step_id), "rb") as f:
            return cloudpickle.load(f)

    def save_step(self, step_id: str, value: Any) -> None:
        path = self._step_path(step_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _dump(value, path)

    # -- workflow metadata ---------------------------------------------
    def save_meta(self, meta: Dict[str, Any]) -> None:
        path = os.path.join(self.dir, "meta.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)

    def load_meta(self) -> Optional[Dict[str, Any]]:
        try:
            with open(os.path.join(self.dir, "meta.json")) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def save_dag(self, dag: DAGNode, args: tuple, kwargs: dict) -> None:
        _dump((dag, args, kwargs), os.path.join(self.dir, "dag.pkl"))

    def load_dag(self):
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            return cloudpickle.load(f)

    def delete(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


def _assign_step_ids(dag: DAGNode) -> Dict[int, str]:
    """Deterministic DFS numbering -> '<index>_<fn_name>'."""
    ids: Dict[int, str] = {}
    counter = [0]

    def visit(node: Any) -> None:
        if not isinstance(node, DAGNode) or id(node) in ids:
            return
        # children first so ids follow dependency order
        for a in list(node._bound_args) + list(node._bound_kwargs.values()):
            walk(a)
        if isinstance(node, ClassMethodNode):
            visit(node._class_node)
        if isinstance(node, FunctionNode):
            name = getattr(node._remote_fn, "__name__", "step")
        elif isinstance(node, ClassMethodNode):
            name = node._method_name
        else:
            name = type(node).__name__
        ids[id(node)] = f"{counter[0]:04d}_{name}"
        counter[0] += 1

    def walk(v: Any) -> None:
        if isinstance(v, DAGNode):
            visit(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)

    visit(dag)
    return ids


def options(node: DAGNode, *, max_retries: int = 0,
            catch_exceptions: bool = False) -> DAGNode:
    """Annotate a bound step with workflow execution options (parity:
    reference ``workflow.options(max_retries=…, catch_exceptions=…)``).

    ``max_retries``: re-execute a raising step up to N extra times before
    surfacing the error.  ``catch_exceptions``: the step's durable result
    becomes ``(value, None)`` on success or ``(None, exception)`` on
    failure — downstream steps decide, nothing is raised.
    """
    node._workflow_options = {"max_retries": int(max_retries),
                              "catch_exceptions": bool(catch_exceptions)}
    return node


class Continuation:
    """A step's returned sub-workflow (parity: reference
    ``workflow.continuation`` — a step that returns a DAG continues into
    it; the sub-DAG's steps are durable under the parent step's id)."""

    def __init__(self, dag: DAGNode):
        self.dag = dag


def continuation(dag: DAGNode) -> Continuation:
    return Continuation(dag)


class _DurableContext:
    """DAG executor with per-step persistence (memoized like
    dag._ExecContext, plus storage read-through/write-back).

    ``prefix`` namespaces step ids of dynamic continuations under their
    parent step, so resume skips completed sub-steps too."""

    def __init__(self, storage: WorkflowStorage, step_ids: Dict[int, str],
                 input_args: tuple, input_kwargs: dict, prefix: str = ""):
        self.storage = storage
        self.step_ids = step_ids
        self.input_args = input_args
        self.input_kwargs = input_kwargs
        self.prefix = prefix
        self._results: Dict[int, Any] = {}

    def result_of(self, node: DAGNode):
        key = id(node)
        if key in self._results:
            return self._results[key]
        if isinstance(node, EventNode):
            value = _wait_event(self.storage, node)
            self._results[key] = value
            return value
        step_id = self.step_ids.get(key)
        if step_id is not None:
            step_id = self.prefix + step_id
        durable = isinstance(node, (FunctionNode, ClassMethodNode)) \
            and step_id is not None
        if durable and self.storage.has_step(step_id):
            value = self.storage.load_step(step_id)
        else:
            value = self._run_step(node, step_id)
            if durable:
                self.storage.save_step(step_id, value)
        self._results[key] = value
        return value

    def _run_step(self, node: DAGNode, step_id: Optional[str]):
        opts = getattr(node, "_workflow_options", None) or {}
        retries_left = opts.get("max_retries", 0)
        catch = opts.get("catch_exceptions", False)
        while True:
            try:
                out = node._execute_impl(self)
                value = ray_tpu_torch.get(out) if isinstance(
                    out, ray_tpu_torch.ObjectRef) else out
                value = self._maybe_continue(value, step_id)
                return (value, None) if catch else value
            except Exception as e:  # noqa: BLE001 — step failure policy
                if retries_left > 0:
                    retries_left -= 1
                    continue
                if catch:
                    return (None, e)
                raise

    def _maybe_continue(self, value: Any, step_id: Optional[str]):
        """A step returning a Continuation (or bare DAG) executes it in
        place, durably, namespaced under the parent step."""
        if isinstance(value, Continuation):
            value = value.dag
        if not isinstance(value, DAGNode):
            return value
        sub_ids = _assign_step_ids(value)
        sub = _DurableContext(
            self.storage, sub_ids, self.input_args, self.input_kwargs,
            prefix=(step_id or "dyn") + "/")
        return sub.result_of(value)


def run(dag: DAGNode, *args, workflow_id: Optional[str] = None,
        **kwargs) -> Any:
    """Execute the DAG durably; returns the terminal value (reference
    ``workflow.run``)."""
    workflow_id = workflow_id or f"workflow_{int(time.time() * 1000)}"
    storage = WorkflowStorage(workflow_id)
    if storage.load_meta() is not None:
        raise ValueError(
            f"workflow {workflow_id!r} already exists; use resume() to "
            f"continue it or delete() to discard it (reference raises on "
            f"duplicate workflow ids too)")
    storage.save_dag(dag, args, kwargs)
    return _drive(storage, dag, args, kwargs)


MANAGEMENT_ACTOR_NAME = "__workflow_management__"


@ray_tpu_torch.remote
class WorkflowManagementActor:
    """Cluster-wide workflow registry (parity: reference
    ``workflow_access.py`` WorkflowManagementActor) — live status for
    ``list_all``/``get_status`` without scanning storage, and a single
    place that could serialize concurrent ``resume`` calls."""

    def __init__(self):
        self._status: Dict[str, Dict[str, Any]] = {}

    def set_status(self, workflow_id: str, status: str) -> None:
        self._status[workflow_id] = {"status": status,
                                     "time": time.time()}

    def get_status(self, workflow_id: str) -> Optional[str]:
        entry = self._status.get(workflow_id)
        return entry["status"] if entry else None

    def list_status(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._status)


def _management_actor():
    """Get-or-create the detached management actor; None when no cluster
    is up (workflows also run driver-local against bare storage)."""
    if not ray_tpu_torch.is_initialized():
        return None
    try:
        return ray_tpu_torch.get_actor(MANAGEMENT_ACTOR_NAME)
    except ValueError:
        try:
            return WorkflowManagementActor.options(
                name=MANAGEMENT_ACTOR_NAME, lifetime="detached",
                get_if_exists=True).remote()
        except Exception:  # noqa: BLE001 — registry is best-effort
            return None


def _report_status(workflow_id: str, status: str) -> None:
    actor = _management_actor()
    if actor is not None:
        try:
            actor.set_status.remote(workflow_id, status)
        except Exception:  # noqa: BLE001
            pass


def _drive(storage: WorkflowStorage, dag: DAGNode, args: tuple,
           kwargs: dict) -> Any:
    storage.save_meta({"status": RUNNING, "start_time": time.time()})
    _report_status(storage.workflow_id, RUNNING)
    step_ids = _assign_step_ids(dag)
    ctx = _DurableContext(storage, step_ids, args, kwargs)
    try:
        result = ctx.result_of(dag)
    except Exception as e:
        storage.save_meta({"status": RESUMABLE, "error": repr(e),
                           "time": time.time()})
        _report_status(storage.workflow_id, RESUMABLE)
        raise
    storage.save_step("__output__", result)
    storage.save_meta({"status": SUCCEEDED, "time": time.time()})
    _report_status(storage.workflow_id, SUCCEEDED)
    return result


def resume(workflow_id: str) -> Any:
    """Re-drive a workflow; completed steps load from storage
    (reference ``workflow.resume``)."""
    storage = WorkflowStorage(workflow_id)
    dag, args, kwargs = storage.load_dag()
    return _drive(storage, dag, args, kwargs)


def get_status(workflow_id: str) -> Optional[str]:
    meta = WorkflowStorage(workflow_id).load_meta()
    return meta["status"] if meta else None


def get_output(workflow_id: str) -> Any:
    storage = WorkflowStorage(workflow_id)
    if not storage.has_step("__output__"):
        raise ValueError(f"workflow {workflow_id!r} has no output "
                         f"(status: {get_status(workflow_id)})")
    return storage.load_step("__output__")


def list_all() -> List[Dict[str, Any]]:
    out = []
    root = _root()
    for wid in sorted(os.listdir(root)):
        meta = WorkflowStorage(wid).load_meta()
        if meta is not None:
            out.append({"workflow_id": wid, **meta})
    return out


def delete(workflow_id: str) -> None:
    WorkflowStorage(workflow_id).delete()


# ---------------------------------------------------------------------------
# events (reference ``workflow.wait_for_event`` + http_event_provider)
# ---------------------------------------------------------------------------

class EventNode(DAGNode):
    """A DAG node that resolves when an external event is delivered.

    Parity: reference ``workflow/api.py`` ``wait_for_event`` — the
    workflow pauses at this step until :func:`send_event` persists the
    payload; the payload is durable, so a resumed workflow sees the
    event exactly once, without re-waiting.
    """

    def __init__(self, key: str, *, timeout: Optional[float] = None,
                 poll_interval: float = 0.2):
        super().__init__((), {})
        self.key = key
        self.timeout = timeout
        self.poll_interval = poll_interval

    def _execute_impl(self, ctx):  # non-durable contexts just wait too
        raise RuntimeError("EventNode only executes inside workflow.run")


def wait_for_event(key: str, *, timeout: Optional[float] = None
                   ) -> EventNode:
    return EventNode(key, timeout=timeout)


def send_event(workflow_id: str, key: str, payload: Any = None) -> None:
    """Deliver an event durably (the storage IS the event channel, so
    delivery survives crashes on either side)."""
    WorkflowStorage(workflow_id).save_step(f"__event__{key}", payload)


def _wait_event(storage: WorkflowStorage, node: EventNode) -> Any:
    step = f"__event__{node.key}"
    deadline = None if node.timeout is None \
        else time.time() + node.timeout
    while not storage.has_step(step):
        if deadline is not None and time.time() > deadline:
            raise TimeoutError(
                f"event {node.key!r} not delivered within "
                f"{node.timeout}s")
        time.sleep(node.poll_interval)
    return storage.load_step(step)
