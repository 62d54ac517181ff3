"""Remote pdb: break inside a running task and attach from the CLI.

Parity: reference ``python/ray/util/rpdb.py`` (``ray debug``) — a task
calls :func:`set_trace`, which opens a TCP-served pdb session and
registers it in the GCS KV; ``ray-tpu debug`` on any machine lists the
active breakpoints and attaches a terminal to one.

The wire protocol is a plain byte pipe (works with ``ray-tpu debug``,
``nc`` or ``telnet``) carrying the normal pdb REPL.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time
import uuid
from typing import Dict, List

__all__ = ["set_trace", "list_breakpoints", "connect"]

_KV_PREFIX = "rtpu:debugger:"
_KV_NAMESPACE = "debugger"


def _make_pdb_class():
    """Build the Pdb subclass lazily (pdb import is not free)."""
    import pdb

    class _RemotePdb(pdb.Pdb):
        """Pdb over a socket file.  ``Pdb.set_trace(frame)`` installs
        the trace function and RETURNS — the REPL then runs at trace
        events in the caller's frame — so resources (socket, KV
        registration) must be released when the session ENDS, i.e. on
        continue/quit/EOF, not when set_trace returns."""

        def __init__(self, handle, on_end):
            super().__init__(stdin=handle, stdout=handle)
            self.use_rawinput = False
            self.prompt = "(rpdb) "
            self._on_end = on_end

        def _finish(self):
            try:
                self._on_end()
            except Exception:  # noqa: BLE001 — teardown
                pass

        def do_continue(self, arg):
            res = super().do_continue(arg)
            self._finish()
            return res

        do_c = do_cont = do_continue

        def do_quit(self, arg):
            res = super().do_quit(arg)
            self._finish()
            return res

        do_q = do_exit = do_quit

        def do_EOF(self, arg):
            res = super().do_EOF(arg)
            self._finish()
            return res

    return _RemotePdb


def set_trace(breakpoint_host: str = "") -> None:
    """Pause this task at the NEXT line and serve a pdb session: blocks
    until a client attaches (``ray-tpu debug`` / ``nc``), then hands the
    caller's frames to the remote REPL; ``c`` resumes the task."""
    from ray_tpu_torch.core import worker as worker_mod

    core = worker_mod.global_worker_or_none()
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    host = breakpoint_host or _my_host(core)
    server.bind((host if breakpoint_host else "0.0.0.0", 0))
    server.listen(1)
    port = server.getsockname()[1]
    bp_id = uuid.uuid4().hex[:12]
    record = {
        "id": bp_id,
        "host": host,
        "port": port,
        "pid": os.getpid(),
        "task": _task_desc(core),
        "timestamp": time.time(),
    }
    if core is not None:
        try:
            core.kv_put(_KV_PREFIX + bp_id,
                        json.dumps(record).encode(), _KV_NAMESPACE)
        except Exception:  # noqa: BLE001 — debugger must not kill the task
            pass
    sys.stderr.write(
        f"RemotePdb waiting on {host}:{port} "
        f"(attach: ray-tpu debug, or nc {host} {port})\n")
    sys.stderr.flush()
    try:
        conn, _addr = server.accept()
    except BaseException:
        server.close()
        _deregister(core, bp_id)
        raise
    server.close()
    handle = conn.makefile("rw", buffering=1)

    def _on_end():
        _deregister(core, bp_id)
        try:
            handle.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            conn.close()
        except Exception:  # noqa: BLE001
            pass

    session = _make_pdb_class()(handle, _on_end)
    # installs the trace and returns; the first stop is the caller's
    # next line, served over the socket until continue/quit
    session.set_trace(sys._getframe(1))


def _deregister(core, bp_id: str) -> None:
    if core is None:
        return
    try:
        core.kv_del(_KV_PREFIX + bp_id, _KV_NAMESPACE)
    except Exception:  # noqa: BLE001
        pass


def _my_host(core) -> str:
    if core is not None and core.task_address:
        return core.task_address[0]
    return "127.0.0.1"


def _task_desc(core) -> str:
    if core is None:
        return f"pid {os.getpid()}"
    task_id = core.current_task_id()
    actor_id = core.current_actor_id()
    if actor_id is not None:
        return f"actor {actor_id.hex()[:12]}"
    if task_id is not None:
        return f"task {task_id.hex()[:12]}"
    return f"driver pid {os.getpid()}"


def list_breakpoints() -> List[Dict]:
    """Active breakpoints registered in the GCS KV (newest first)."""
    from ray_tpu_torch.core import worker as worker_mod

    core = worker_mod.global_worker()
    out = []
    for key in core.kv_keys(_KV_PREFIX, _KV_NAMESPACE):
        blob = core.kv_get(key, _KV_NAMESPACE)
        if blob:
            try:
                out.append(json.loads(blob))
            except json.JSONDecodeError:
                pass
    out.sort(key=lambda r: -r.get("timestamp", 0))
    return out


def connect(host: str, port: int, stdin=None, stdout=None) -> None:
    """Bridge this terminal onto a served pdb session (the ``ray-tpu
    debug`` attach loop)."""
    import select

    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    sock = socket.create_connection((host, port), timeout=10)
    sock.setblocking(False)
    stdin_fd = stdin.fileno()
    try:
        while True:
            ready, _, _ = select.select([sock, stdin_fd], [], [])
            if sock in ready:
                data = sock.recv(4096)
                if not data:
                    break  # session ended remotely
                stdout.write(data.decode(errors="replace"))
                stdout.flush()
            if stdin_fd in ready:
                line = os.read(stdin_fd, 4096)
                if not line:
                    break
                sock.sendall(line)
    finally:
        sock.close()
