"""Entry point for spawned worker processes.

Parity: the reference's python worker `default_worker.py` — connect to the
local raylet + GCS, then run the task execution loop on the main thread.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def _install_cancel_sigint_handler() -> None:
    """Task cancellation delivers a real SIGINT to this process's main
    thread (worker.py handle_cancel_task -> pthread_kill).  Gate it on
    the per-thread interrupt window: inside a task body it raises
    KeyboardInterrupt (the reference's cancel semantics); landing in
    the commit phase — after the body returned, while the reply is
    being shipped — it is swallowed so the exec loop (and the computed
    reply) survive the race."""
    import signal

    def handler(signum, frame):
        from ray_tpu_torch.core.worker import INTERRUPT_WINDOW
        if getattr(INTERRUPT_WINDOW, "open", False):
            raise KeyboardInterrupt
        # cancel raced task completion: ignore — the cancel reply path
        # already settles the task owner-side

    signal.signal(signal.SIGINT, handler)


def main() -> None:
    import time
    t0 = time.perf_counter()
    trace = os.environ.get("RAY_TPU_TORCH_BOOT_TRACE")

    def mark(label):
        if trace:
            sys.stderr.write(
                f"BOOT {label} {1000 * (time.perf_counter() - t0):.1f}ms\n")
            sys.stderr.flush()

    from ray_tpu_torch.core.node import maybe_arm_pdeathsig
    maybe_arm_pdeathsig()
    mark("pdeathsig")
    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet", required=True)
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--store-path", required=True)
    parser.add_argument("--store-capacity", type=int, required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--job-id", default=None)
    args = parser.parse_args()

    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    if os.environ.get("RAY_TPU_TORCH_WORKER_FAULTHANDLER"):
        import faulthandler

        faulthandler.enable()
        faulthandler.dump_traceback_later(
            float(os.environ["RAY_TPU_TORCH_WORKER_FAULTHANDLER"]), repeat=True)

    from ray_tpu_torch.core.ids import JobID, NodeID
    from ray_tpu_torch.core.worker import CoreWorker
    _install_cancel_sigint_handler()
    mark("imports")

    def parse_addr(s: str):
        host, port = s.rsplit(":", 1)
        return (host, int(port))

    worker = CoreWorker(
        mode="worker",
        gcs_address=parse_addr(args.gcs),
        raylet_address=parse_addr(args.raylet),
        node_id=NodeID.from_hex(args.node_id),
        store_path=args.store_path,
        store_capacity=args.store_capacity,
        session_dir=args.session_dir,
        job_id=JobID.from_hex(args.job_id) if args.job_id else None,
    )
    mark("core_worker_ready")
    try:
        worker.run_exec_loop()
    finally:
        worker.shutdown()
    sys.exit(0)


if __name__ == "__main__":
    main()
