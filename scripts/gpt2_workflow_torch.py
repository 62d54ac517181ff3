"""A durable workflow whose GPU step a resumed driver does not run again.

    python scripts/gpt2_workflow_torch.py run --storage DIR --workflow-id ID
    python scripts/gpt2_workflow_torch.py resume --storage DIR --workflow-id ID

Each driver starts its own local cluster (``init(num_cpus=2,
num_gpus=1)``) and runs one workflow of the port's ``workflow`` module,
stored under ``--storage``:

1. ``draw_tokens`` (CPU): the token ids ``[batch, seq]`` from ``--seed +
   1``, as ``chip_smoke.cluster_weights`` draws them;
2. ``gpt2_forward`` (``num_gpus=1``): GPT-2 (``--preset``) built on the
   CPU from ``--seed``, loaded on the card, its bf16 forward under
   ``no_grad``: the sha256 of the f32 logits' bytes, each sequence's
   last-position logits row as a CUDA tensor, and the launches of the
   port's kernels;
3. ``wait_for_event("go")``;
4. ``finish`` (``num_gpus=1``: it receives step 2's CUDA tensor): returns
   a continuation into ``digest_on_card`` (``num_gpus=1``), which takes
   that tensor as its argument and returns its sha256 and its sum in
   f64.

Every function step appends one byte to ``<counts>/<step name>``.
``run --exit-at-event`` hard-exits the driver (``os._exit(9)``) once step
2's output is on disk and the workflow waits for the event, after one
line, ``WORKFLOW_WAITING {json}``, that lists its descendants (pid and
start time): its local cluster, which goes with it.  ``resume`` delivers
the event ``"go"`` and resumes the workflow from its storage, then
prints one line, ``WORKFLOW {json}``: the output, the status,
``list_all()``'s row and the management actor's status.  On a card every GPU step raises unless
it holds the GPU and CUDA sees it; ``--device cpu`` runs the steps on
the CPU (with a small ``--preset``; "GPU" is then a label).
"""

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEP_FORWARD = "0001_gpt2_forward"  # step 2's id: the DAG's DFS numbering


def _count(counts, name):
    with open(os.path.join(counts, name), "a") as f:
        f.write("x")


def _on_card(device):
    """Raise unless this GPU step holds the GPU and CUDA sees it."""
    import torch

    import ray_tpu_torch as rt
    gpu_ids = rt.get_gpu_ids()
    if device == "cuda" and (not gpu_ids or not torch.cuda.is_available()):
        raise RuntimeError(
            f"GPU step without the card: gpu_ids={gpu_ids}, "
            f"CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}")
    return gpu_ids


def _launches(zero=False):
    """{"<entry point>.<counter>": n} of every kernel wrapper (set to 0
    first with ``zero``)."""
    from ray_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                   flash_attention_fwd,
                                                   flash_attention_hm_bwd,
                                                   flash_attention_hm_fwd)
    from ray_tpu_torch.ops.fused import fused_rmsnorm
    out = {}
    for fn in (flash_attention_fwd, flash_attention_bwd,
               flash_attention_hm_fwd, flash_attention_hm_bwd,
               fused_rmsnorm):
        for attr in sorted(a for a in vars(fn) if a.startswith("launches")):
            if zero:
                setattr(fn, attr, 0)
            out[f"{fn.__name__}.{attr}"] = getattr(fn, attr)
    return out


def draw_tokens(counts, preset, seed, batch, seq):
    """Step 1: the forward's token ids, on the CPU."""
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config
    _count(counts, "draw_tokens")
    cfg = getattr(GPT2Config, preset)(max_seq_len=seq)
    return torch.randint(0, cfg.vocab_size, (batch, seq),
                         generator=torch.Generator().manual_seed(seed + 1))


def gpt2_forward(counts, tokens, preset, seed, device):
    """Step 2: GPT-2's forward on ``device``; its logits' sha256, last
    rows (on ``device``) and kernel launches."""
    import hashlib

    import torch

    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config
    _count(counts, "gpt2_forward")
    t0 = time.time()
    gpu_ids = _on_card(device)
    cfg = getattr(GPT2Config, preset)(max_seq_len=tokens.shape[1])
    weights = GPT2(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(seed)).state_dict()
    model = GPT2(cfg, device=device)
    model.load_state_dict(weights)
    t1 = time.time()
    _launches(zero=True)
    with torch.no_grad():
        logits = model(tokens.to(device)).float()
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {k: v for k, v in _launches().items() if v}
    t2 = time.time()
    host = logits.cpu()
    return {"sha256": hashlib.sha256(
                memoryview(host.numpy()).cast("B")).hexdigest(),
            "shape": list(logits.shape),
            "finite": bool(torch.isfinite(host).all()),
            "last": logits[:, -1, :].contiguous(),
            "launches": launches, "gpu_ids": gpu_ids, "pid": os.getpid(),
            "times": {"setup_s": t1 - t0, "forward_s": t2 - t1}}


def digest_on_card(counts, last, info, device):
    """The continuation's step: ``last`` (step 2's tensor) on this
    process's device, its sha256 and its f64 sum."""
    import hashlib

    import torch
    _count(counts, "digest_on_card")
    gpu_ids = _on_card(device)
    if last.device.type != device:
        raise RuntimeError(f"step 2's tensor arrived on {last.device}, "
                           f"not on {device}")
    host = last.cpu()
    return {**info, "last_device": str(last.device),
            "last_sha256": hashlib.sha256(
                memoryview(host.numpy()).cast("B")).hexdigest(),
            "last_sum_f64": float(last.double().sum()),
            "digest_gpu_ids": gpu_ids, "digest_pid": os.getpid()}


def finish(counts, forward, event, device):
    """Step 4: continue into ``digest_on_card`` with step 2's tensor."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    _count(counts, "finish")
    _on_card(device)
    info = {k: v for k, v in forward.items() if k != "last"}
    info["event"] = event
    step = rt.remote(digest_on_card).options(num_gpus=1)
    return workflow.continuation(step.bind(counts, forward["last"], info,
                                           device))


def build_dag(args):
    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    tokens = rt.remote(draw_tokens).bind(args.counts, args.preset,
                                         args.seed, args.batch, args.seq)
    forward = rt.remote(gpt2_forward).options(num_gpus=1).bind(
        args.counts, tokens, args.preset, args.seed, args.device)
    event = workflow.wait_for_event("go", timeout=args.event_timeout)
    return rt.remote(finish).options(num_gpus=1).bind(
        args.counts, forward, event, args.device)


def _exit_at_event(storage):
    """Hard-exit this driver once step 2's output is on disk and the
    main thread waits for the workflow's event."""
    main = threading.main_thread().ident

    def waiting():
        frame = sys._current_frames().get(main)
        while frame is not None:
            if frame.f_code.co_name == "_wait_event":
                return True
            frame = frame.f_back
        return False

    def watch():
        import psutil
        while not (storage.has_step(STEP_FORWARD) and waiting()):
            time.sleep(0.05)
        # the processes that must go with this driver: its local cluster
        tree = [[c.pid, c.create_time()]
                for c in psutil.Process().children(recursive=True)]
        print("WORKFLOW_WAITING " + json.dumps({"pid": os.getpid(),
                                                "tree": tree}), flush=True)
        os._exit(9)

    threading.Thread(target=watch, daemon=True).start()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["run", "resume"])
    p.add_argument("--storage", required=True)
    p.add_argument("--workflow-id", required=True)
    p.add_argument("--counts", help="directory of the steps' count files "
                   "(default: <storage>/counts)")
    p.add_argument("--preset", default="gpt2_small")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--exit-at-event", action="store_true",
                   help="os._exit(9) once the workflow waits for its event")
    p.add_argument("--event-timeout", type=float, default=600.0)
    args = p.parse_args(argv)
    args.counts = args.counts or os.path.join(args.storage, "counts")
    os.makedirs(args.counts, exist_ok=True)

    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow

    t0 = time.time()
    rt.init(num_cpus=2, num_gpus=1)
    workflow.init(args.storage)
    if args.mode == "run":
        if args.exit_at_event:
            _exit_at_event(workflow.WorkflowStorage(args.workflow_id))
        out = workflow.run(build_dag(args), workflow_id=args.workflow_id)
    else:
        workflow.send_event(args.workflow_id, "go", {"by": os.getpid()})
        out = workflow.resume(args.workflow_id)
    actor = rt.get_actor(workflow.workflow.MANAGEMENT_ACTOR_NAME)
    report = {"output": out,
              "status": workflow.get_status(args.workflow_id),
              "listed": [r for r in workflow.list_all()
                         if r["workflow_id"] == args.workflow_id],
              "actor_status": rt.get(actor.get_status.remote(
                  args.workflow_id), timeout=60),
              "driver_s": time.time() - t0}
    print("WORKFLOW " + json.dumps(report), flush=True)
    rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
