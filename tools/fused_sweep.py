#!/usr/bin/env python3
"""K7, ``fused_identity_blocks``, against the module's cuDNN blocks at
ResNet-50's four identity-block stages, 224 and 512 px, B = 64, on one GPU.

    python3 tools/fused_sweep.py                      # this checkout
    python3 tools/fused_sweep.py --root DIR           # the package in DIR
    python3 tools/fused_sweep.py --pair PARENT_DIR    # parent, this, this,
                                                      # parent

Run from anywhere; the package comes from the checkout this file lies in,
or from ``--root``. For each stage, the stage's identity blocks of a seeded
ResNet-50 with randomized BatchNorm, folded and stacked as
``fused_resnet_apply`` does, on a seeded post-ReLU activation: the call's
first block is held to its plain version by ``check_fused_blocks``, then
one JSON line gives the CUDA-event medians (after warm-up) of the K7 call
(all the stage's blocks) and of the module's ``Bottleneck.forward`` over
the same blocks and activation replayed from a CUDA graph (about ten cuDNN
calls a block: the yardstick), and the least time the card could take
(``chip_smoke.bound``). Every line carries the card's nvidia-smi name and
power limit.

``--pair PARENT_DIR`` compares two trees on one card: it runs the sweep
from PARENT_DIR (for example ``git archive`` of the parent commit,
unpacked into a git-ignored directory), from this checkout, from this
checkout again and from PARENT_DIR again, each in a process of its own
that builds its tree's kernels, and tags each line with ``tree`` and
``run``. The timing code is this file's for both trees.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = (224, 512)
BATCH = 64


def _chip_smoke():
    """This checkout's ``chip_smoke`` (its timing helpers), whatever
    ``--root`` is."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep(images, tags: dict) -> None:
    import torch
    cs = _chip_smoke()
    from instsearch_torch.kernels.fused_resnet import (
        _stack_identity_weights, check_fused_blocks, fused_identity_blocks,
        fused_identity_blocks_reference, randomize_bn)
    from instsearch_torch.models import get_backbone
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = get_backbone("resnet50")[0].init_weights(gen)
    randomize_bn(model, gen)
    sd = model.state_dict()
    b = BATCH
    for image in images:
        for layer, hh, c, m, n in cs.resnet50_stages(image):
            op = _stack_identity_weights(sd, layer, [str(j) for j in
                                                     range(1, n + 1)], "cuda")
            x = torch.relu(torch.randn((b, hh * hh, c), generator=gen,
                                       device="cuda")).to(torch.bfloat16)
            first = [t[:1] for t in op]
            err = check_fused_blocks(
                fused_identity_blocks(x, *first, H=hh, W=hh),
                fused_identity_blocks_reference(x, *first, H=hh, W=hh))
            blocks = [getattr(model, layer)[j] for j in range(1, n + 1)]
            xc = x.view(b, hh, hh, c).permute(0, 3, 1, 2)  # channels-last

            def module_route():
                y = xc
                for blk in blocks:
                    y = blk(y)
                return y

            hw = hh * hh
            with torch.inference_mode():
                ms = cs.cuda_median_ms(
                    lambda: fused_identity_blocks(x, *op, H=hh, W=hh))
                graph_ms = cs.cuda_median_ms(cs.graph_replay(module_route))
            cs.report(card, **tags, layer=layer, image=image, blocks=n,
                      shape=[b, hh * hh, c], M=m, ms=ms,
                      cudnn_graph_ms=graph_ms,
                      rel_err_first_block=err["rel_err"],
                      **cs.bound(2 * b * hw * c * 2
                                 + n * 2 * (2 * c * m + 9 * m * m)
                                 + n * 4 * (2 * m + c),
                                 2 * b * hw * n * (c * m + 9 * m * m + m * c),
                                 "bf16"))
            del x, xc, op
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose instsearch_torch is timed")
    ap.add_argument("--pair", metavar="PARENT_DIR",
                    help="run parent, this, this, parent, one process each")
    ap.add_argument("--images", default=",".join(map(str, IMAGES)),
                    help="image sizes, comma-separated (default 224,512)")
    ap.add_argument("--tree", default="", help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.pair:
        rc = 0
        for k, (tree, root) in enumerate((("parent", args.pair),
                                          ("change", HERE),
                                          ("change", HERE),
                                          ("parent", args.pair))):
            rc |= subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--root",
                 os.path.abspath(root), "--images", args.images, "--tree",
                 tree, "--run", str(k)]).returncode
        return rc
    import torch
    if not torch.cuda.is_available():
        print("fused_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    tags = {"tree": args.tree, "run": args.run} if args.tree else {}
    sweep([int(s) for s in args.images.split(",")], tags)
    return 0


if __name__ == "__main__":
    sys.exit(main())
