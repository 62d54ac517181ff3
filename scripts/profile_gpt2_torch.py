#!/usr/bin/env python3
"""The GPT-2 LM head's products by vocabulary width, on one CUDA GPU.

    python3 scripts/profile_gpt2_torch.py

The training step's chunked LM head (``chunked_lm_loss``, 8192 rows a
chunk, width 768) takes one forward product per chunk, its recompute,
and two backward products.  At GPT-2's vocabulary, 50257, a bf16 logits
row is no multiple of 16 bytes.  This times each of the three product
shapes, bf16, at the vocabulary's own width and at the next multiple of
64 (50304), with chip_smoke.py's timer (CUDA events, median of 30, L2
flushed before each).  One JSON line per width, then the card's name
and power limit.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

ROWS, WIDTH, VOCAB = 8192, 768, 50257


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_gpt2_torch: needs a CUDA device", file=sys.stderr)
        return 2
    timer = chip_smoke.Timer()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    h = randn(ROWS, WIDTH)
    for vocab in (VOCAB, -(-VOCAB // 64) * 64):
        emb, dlogits = randn(vocab, WIDTH), randn(ROWS, vocab)
        print(json.dumps({
            "vocab": vocab,
            "logits_ms": timer(lambda: h @ emb.T),          # [R,E] x [E,V]
            "d_hidden_ms": timer(lambda: dlogits @ emb),    # [R,V] x [V,E]
            "d_emb_ms": timer(lambda: dlogits.T @ h)}),     # [V,R] x [R,E]
            flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
