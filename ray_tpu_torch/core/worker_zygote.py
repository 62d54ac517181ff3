"""Worker fork-server ("zygote"): amortize interpreter start + imports.

Parity rationale: the reference prestarts pooled C++-backed workers
(``worker_pool.h:156`` prestart) because process start dominates
small-actor creation; in pure Python the equivalent lever is a fork
server — one template process pays interpreter boot + ``ray_tpu_torch.core``
imports (~300 ms cold), then each worker is an ``os.fork()`` (~10 ms).
The raylet talks to it over a line-oriented stdin/stdout protocol:

    -> {"argv": [...], "env": {...}, "log_base": "..."}
    <- {"pid": 12345}

Safety: the zygote imports only thread-free modules (threads, event
loops, and sockets all start inside ``CoreWorker.__init__`` AFTER the
fork), and ``ray_tpu_torch.core.ids`` re-seeds its entropy pool via
``os.register_at_fork``.  Workers that lease a GPU do NOT fork from
here: the raylet cold-spawns them, so CUDA only ever starts in a fresh
interpreter, and uses this path only for plain (CPU) pool workers.
The zygote never imports torch.
"""

from __future__ import annotations

import json
import os
import signal
import sys


def _child(req: dict) -> None:
    os.setsid()  # own process group; raylet kills by pid
    # No PDEATHSIG here: tying workers to the ZYGOTE's lifetime would
    # kill every live actor if the zygote crashed.  Orphan protection is
    # the worker's raylet-connection watch (worker.py exits on close).
    signal.signal(signal.SIGCHLD, signal.SIG_DFL)  # undo zygote's IGN —
    # user task code must see real subprocess exit statuses
    devnull = os.open(os.devnull, os.O_RDONLY)
    os.dup2(devnull, 0)  # NEVER share the zygote control pipe with tasks
    os.close(devnull)
    out = open(req["log_base"] + ".out", "ab", buffering=0)
    err = open(req["log_base"] + ".err", "ab", buffering=0)
    os.dup2(out.fileno(), 1)
    os.dup2(err.fileno(), 2)
    for key, value in req.get("env", {}).items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = str(value)
    sys.argv = ["ray_tpu-worker"] + list(req["argv"])
    from ray_tpu_torch.core import worker_main

    code = 0
    try:
        worker_main.main()
    except SystemExit as e:
        code = int(e.code or 0)
    except BaseException:
        import traceback

        traceback.print_exc()
        code = 1
    finally:
        os._exit(code)


def main() -> None:
    from ray_tpu_torch.core.node import maybe_arm_pdeathsig
    maybe_arm_pdeathsig()
    # Pre-warm the import graph forks inherit.  Deliberately NOT torch —
    # plain pool workers never touch the accelerator.
    import ray_tpu_torch.core.worker  # noqa: F401 — pulls rpc/serialization/ids
    import ray_tpu_torch.actor  # noqa: F401
    import ray_tpu_torch.remote_function  # noqa: F401

    # Freeze the template heap (the fork-server trick): a child's first
    # gc pass otherwise writes mark bits into EVERY inherited object's
    # header, copy-on-write-faulting the whole template heap per worker
    # — a large slice of per-fork boot cost during actor creation storms.
    import gc
    gc.collect()
    gc.freeze()

    # reap forked children so they don't accumulate as zombies
    signal.signal(signal.SIGCHLD, signal.SIG_IGN)

    sys.stdout.write(json.dumps({"ready": True}) + "\n")
    sys.stdout.flush()
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError:
            continue
        if req.get("exit"):
            break
        pid = os.fork()
        if pid == 0:
            _child(req)  # never returns
        sys.stdout.write(json.dumps({"pid": pid}) + "\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
