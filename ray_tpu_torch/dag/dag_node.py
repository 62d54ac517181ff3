"""Lazy task/actor DAGs.

Parity: reference ``python/ray/dag/dag_node.py`` (``DAGNode``:23),
``function_node.py``, ``class_node.py``, ``input_node.py`` — a DAG is
authored with ``.bind(...)`` (instead of ``.remote``), composed freely,
and launched with ``dag.execute(*input)``, which submits the whole graph
as tasks/actor calls and returns the terminal ``ObjectRef``.  Serve
deployment graphs and Workflow build on this.

Execution maps each ``FunctionNode`` to one task submission whose
upstream args are ObjectRefs — the scheduler runs independent branches
in parallel and the object plane moves intermediate results without
driver round-trips.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.object_ref import ObjectRef


class DAGNode:
    """A node in a lazy computation graph; bound args may contain other
    DAGNodes (dependencies) arbitrarily nested in lists/tuples/dicts."""

    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    def _resolve_args(self, ctx: "_ExecContext") -> Tuple[tuple, dict]:
        def subst(v):
            if isinstance(v, DAGNode):
                return ctx.result_of(v)
            if isinstance(v, list):
                return [subst(x) for x in v]
            if isinstance(v, tuple):
                return tuple(subst(x) for x in v)
            if isinstance(v, dict):
                return {k: subst(x) for k, x in v.items()}
            return v

        args = tuple(subst(a) for a in self._bound_args)
        kwargs = {k: subst(v) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_impl(self, ctx: "_ExecContext"):
        raise NotImplementedError

    # -- public -------------------------------------------------------
    def execute(self, *input_args, **input_kwargs):
        """Submit the whole DAG; returns this node's result handle
        (an ObjectRef for task/method nodes, an ActorHandle for a
        ClassNode terminal)."""
        ctx = _ExecContext(input_args, input_kwargs)
        return ctx.result_of(self)

    def __str__(self):
        return f"{type(self).__name__}({id(self):x})"


class _ExecContext:
    """One DAG launch: memoizes each node's submission so diamond
    dependencies execute once."""

    def __init__(self, input_args: tuple, input_kwargs: dict):
        self.input_args = input_args
        self.input_kwargs = input_kwargs
        self._results: Dict[int, Any] = {}

    def result_of(self, node: DAGNode):
        key = id(node)
        if key not in self._results:
            self._results[key] = node._execute_impl(self)
        return self._results[key]


class InputNode(DAGNode):
    """Placeholder for the value passed to ``dag.execute(...)``
    (reference ``input_node.py``).  Usable as a context manager for
    authoring ergonomics::

        with InputNode() as inp:
            dag = f.bind(inp)
    """

    def __init__(self):
        super().__init__((), {})

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key, kind="item")

    def __getattr__(self, name: str) -> "InputAttributeNode":
        if name.startswith("_"):
            raise AttributeError(name)
        return InputAttributeNode(self, name, kind="attr")

    def _execute_impl(self, ctx: _ExecContext):
        if ctx.input_kwargs or len(ctx.input_args) != 1:
            # multi-arg execute: the input is the arg tuple itself
            return ctx.input_args if not ctx.input_kwargs else \
                (ctx.input_args, ctx.input_kwargs)
        return ctx.input_args[0]


class InputAttributeNode(DAGNode):
    """``inp["x"]`` / ``inp.x`` projection of the DAG input."""

    def __init__(self, parent: InputNode, key, kind: str):
        super().__init__((parent,), {})
        self._key = key
        self._kind = kind

    def _execute_impl(self, ctx: _ExecContext):
        base = ctx.result_of(self._bound_args[0])
        if self._kind == "item":
            return base[self._key]
        return getattr(base, self._key)


class FunctionNode(DAGNode):
    """A bound ``@remote`` function call (reference ``function_node.py``)."""

    def __init__(self, remote_fn, args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_impl(self, ctx: _ExecContext) -> ObjectRef:
        args, kwargs = self._resolve_args(ctx)
        return self._remote_fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """A bound actor instantiation.  Method access returns bindable
    stubs: ``node.method.bind(...)`` (reference ``class_node.py``).

    With constant constructor args the actor is created once and reused
    across ``execute`` calls (stateful service pattern, as Serve uses);
    if any constructor arg derives from another DAG node (e.g. the
    InputNode), a fresh actor is created per execution — caching would
    silently pin the first input's value.
    """

    def __init__(self, actor_cls, args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._lock = threading.Lock()
        self._handle = None

        def has_node(v) -> bool:
            if isinstance(v, DAGNode):
                return True
            if isinstance(v, (list, tuple)):
                return any(has_node(x) for x in v)
            if isinstance(v, dict):
                return any(has_node(x) for x in v.values())
            return False

        self._input_dependent = any(has_node(a) for a in args) or \
            any(has_node(a) for a in kwargs.values())

    def __getattr__(self, name: str) -> "_ClassMethodStub":
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodStub(self, name)

    def _execute_impl(self, ctx: _ExecContext):
        if self._input_dependent:
            args, kwargs = self._resolve_args(ctx)
            return self._actor_cls.remote(*args, **kwargs)
        with self._lock:
            if self._handle is None:
                args, kwargs = self._resolve_args(ctx)
                self._handle = self._actor_cls.remote(*args, **kwargs)
        return self._handle


class _ClassMethodStub:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method_name,
                               args, kwargs)


class ClassMethodNode(DAGNode):
    """A bound actor method call on a :class:`ClassNode` instance."""

    def __init__(self, class_node: ClassNode, method_name: str,
                 args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method_name = method_name

    def _execute_impl(self, ctx: _ExecContext) -> ObjectRef:
        handle = ctx.result_of(self._class_node)
        args, kwargs = self._resolve_args(ctx)
        return getattr(handle, self._method_name).remote(*args, **kwargs)
