"""A job's driver: GPT-2's forward in one ``num_gpus=1`` task.

Submit it to a running cluster through the dashboard's job routes::

    python -m ray_tpu_torch.scripts.cli job --dashboard-address URL \\
        submit python scripts/gpt2_job_torch.py --preset gpt2_small

The driver joins the cluster that runs it (the job's supervisor sets
``RAY_TPU_TORCH_ADDRESS``) and never touches a device itself: its
process holds no GPU lease.  The task builds the model's f32 weights on
the CPU from ``--seed`` and the tokens from ``--seed + 1`` (as
``chip_smoke.cluster_weights`` does), loads them on its device and runs
the forward (bf16 compute) under ``no_grad``.  Only small values come
back across the raylets: the sha256 of the f32 logits' bytes, each
sequence's last-position logits row (base64 of its f32 bytes), the
launches of the port's kernels in the forward, and where it ran.  The
driver prints them as one line, ``GPT2_JOB {json}``, to the job's log.

On a card the task raises unless it holds a GPU and CUDA sees it;
``--device cpu`` runs it on a node's CPU (with a small ``--preset``).
"""

import argparse
import json
import sys
import time


def _kernel_entry_points():
    from ray_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                   flash_attention_fwd,
                                                   flash_attention_hm_bwd,
                                                   flash_attention_hm_fwd)
    from ray_tpu_torch.ops.fused import fused_rmsnorm
    return (flash_attention_fwd, flash_attention_bwd,
            flash_attention_hm_fwd, flash_attention_hm_bwd, fused_rmsnorm)


def _launches(zero=False):
    """{"<entry point>.<counter>": n} over every kernel wrapper's launch
    counters (set to 0 first with ``zero``)."""
    out = {}
    for fn in _kernel_entry_points():
        for attr in sorted(a for a in vars(fn) if a.startswith("launches")):
            if zero:
                setattr(fn, attr, 0)
            out[f"{fn.__name__}.{attr}"] = getattr(fn, attr)
    return out


def gpt2_forward_task(preset, seed, batch, seq, device):
    """The job's task: the forward, and a small summary of its logits."""
    import base64
    import hashlib
    import os

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config

    t0 = time.time()
    gpu_ids = rt.get_gpu_ids()
    if device == "cuda":
        if not gpu_ids or not torch.cuda.is_available():
            raise RuntimeError(
                f"GPU task without the card: gpu_ids={gpu_ids}, "
                f"CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}")
        torch.zeros(1, device=device)
    cfg = getattr(GPT2Config, preset)(max_seq_len=seq)
    weights = GPT2(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(seed)).state_dict()
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(seed + 1))
    model = GPT2(cfg, device=device)
    model.load_state_dict(weights)
    t1 = time.time()
    _launches(zero=True)
    with torch.no_grad():
        logits = model(tokens.to(device))
    if device == "cuda":
        torch.cuda.synchronize()
    launches = _launches()
    t2 = time.time()
    logits = logits.float().cpu()
    last = logits[:, -1, :].contiguous()
    return {
        "sha256": hashlib.sha256(
            memoryview(logits.numpy()).cast("B")).hexdigest(),
        "shape": list(logits.shape),
        "finite": bool(torch.isfinite(logits).all()),
        "last_rows_f32_b64": base64.b64encode(
            last.numpy().tobytes()).decode(),
        "launches": {k: v for k, v in launches.items() if v},
        "node": rt.get_runtime_context().get_node_id(),
        "gpu_ids": gpu_ids, "pid": os.getpid(),
        "device": (torch.cuda.get_device_name() if device == "cuda"
                   else "cpu"),
        "times": {"setup_s": t1 - t0, "forward_s": t2 - t1,
                  "digest_s": time.time() - t2}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="gpt2_small")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import ray_tpu_torch as rt

    t0 = time.time()
    rt.init()
    task = rt.remote(gpt2_forward_task).options(num_gpus=1)
    ref = task.remote(args.preset, args.seed, args.batch, args.seq,
                      args.device)
    out = rt.get(ref, timeout=600)
    out["driver_s"] = time.time() - t0
    print("GPT2_JOB " + json.dumps(out), flush=True)
    rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
