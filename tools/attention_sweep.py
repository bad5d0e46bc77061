#!/usr/bin/env python3
"""The ViT attention kernels, K6 ``mha`` and K5 ``flash_mha``, against
PyTorch's ``scaled_dot_product_attention`` at the shapes the ViT routes
launch, on one GPU.

    python3 tools/attention_sweep.py

Run from the root of a checkout. For each shape, q, k and v are bf16 views
of one seeded packed ``[B, N, 3, h, hd]`` projection, as the model passes
them; the kernel's answer is first held to its plain version by
``check_attention``, then one JSON line gives the CUDA-event medians
(after warm-up) of the kernel and of SDPA on the same tensors, and the
least time the card could take (``chip_smoke.bound``). Every line carries
the card's nvidia-smi name and power limit. To compare two trees, copy this
file into the other tree's ``tools/`` and run it from each root in one
call, parent, change, change, parent.
"""
from __future__ import annotations

import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import bound, card_line, cuda_median_ms, report  # noqa: E402
from instsearch_torch.kernels.vit_attention import (  # noqa: E402
    check_attention, flash_mha, flash_mha_reference, mha, mha_reference)

# (kernel, plain version, [B, h, N, hd]): K6 at 224 px (B = 1 and the
# extraction batch) and 1024 px; K5 at 1024 px (B = 1 and the route's
# batch of 4) and 2048 px
SHAPES = [(mha, mha_reference, (1, 12, 197, 64)),
          (mha, mha_reference, (64, 12, 197, 64)),
          (mha, mha_reference, (1, 12, 4097, 64)),
          (flash_mha, flash_mha_reference, (1, 12, 4097, 64)),
          (flash_mha, flash_mha_reference, (4, 12, 4097, 64)),
          (flash_mha, flash_mha_reference, (1, 12, 16385, 64))]


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for fn, ref, (b, h, n, hd) in SHAPES:
        qkv = torch.randn((b, n, 3, h, hd), generator=gen,
                          device="cuda").to(torch.bfloat16)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        err = check_attention(fn(q, k, v), ref(q, k, v))
        report(card, kernel=fn.__name__, shape=[b, h, n, hd],
               rel_err=err["rel_err"],
               ms=cuda_median_ms(lambda: fn(q, k, v)),
               sdpa_ms=cuda_median_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v)),
               **bound(4 * b * h * n * hd * q.element_size(),
                       4 * b * h * n * n * hd, "bf16"))
        del q, k, v, qkv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
