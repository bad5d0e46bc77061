"""Convert what the JAX package (``instsearch_tpu``) wrote in orbax form into
the forms the PyTorch port (``instsearch_torch``) reads.

    python tools/orbax_to_port.py index SRC_INDEX DST_INDEX
    python tools/orbax_to_port.py weights SRC_CHECKPOINT DST_CHECKPOINT

Run it where the JAX package, orbax and tensorstore are installed (the host
that built the index): the reference's streaming store and its weight trees
are OCDBT checkpoints, which only tensorstore reads. The port never imports
this tool, and the machine that serves the port needs none of these
packages.

``index``: a reference index directory (``meta.json`` ``format`` "orbax" or
"npz") becomes a port index directory. An orbax ``store/`` is restored with
``orbax.checkpoint.PyTreeCheckpointer().restore`` and written as the port's
stream (``utils/checkpoint.py``'s sharded tree: the same arrays, names,
widths, int4 pairing and storage dtypes); an ``index.npz`` is copied as it
is. The backbone's orbax ``variables/`` become ``torch_weights.pt`` through
``models/jax_import.py`` (the importer of ``meta.json``'s
``extract.backbone`` family), the views (``ivf/``, ``lw/``, ``pq/``,
``ivfpq/``) are copied as they are, and ``meta.json`` is rewritten.

``weights``: a reference ``finetune`` checkpoint (an orbax tree with its
``.meta.json`` sidecar and, after ``--fit-lw``, its ``.whitening.npz``)
becomes the port's ``finetune`` checkpoint (a directory holding
``torch_weights.pt``, with the two sidecars beside it), which
``python -m instsearch_torch.cli build-index --weights`` and ``evaluate
--weights`` read.

Each command prints one JSON line describing what it wrote.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from instsearch_torch.index import Index  # noqa: E402
from instsearch_torch.models import jax_import  # noqa: E402
from instsearch_torch.models.registry import get_backbone  # noqa: E402
from instsearch_torch.utils.checkpoint import (WEIGHTS_FILE,  # noqa: E402
                                               save_pytree,
                                               save_sharded_pytree,
                                               tensor_of)

VIEWS = ("ivf", "lw", "pq", "ivfpq")


def restore(path: str):
    """An orbax tree as nested dicts of numpy arrays."""
    import orbax.checkpoint as ocp
    tree = ocp.PyTreeCheckpointer().restore(os.path.abspath(path))

    def to_numpy(t):
        if isinstance(t, dict):
            return {k: to_numpy(v) for k, v in t.items()}
        return np.asarray(t)
    return to_numpy(tree)


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A restored array as a tensor of the same dtype (bf16 by its bits)."""
    bf16 = a.dtype.name == "bfloat16"
    return tensor_of(a.view(np.uint16) if bf16 else a, a.dtype.name)


def state_dict(backbone: str, variables, full: bool) -> dict:
    """The port's state_dict of the reference's Flax ``variables`` of
    ``backbone``, carried by ``models/jax_import.py`` and checked against
    the port's model. ``full`` adds the step counters a BatchNorm keeps
    (what ``torch_weights.pt`` of an index holds: the model's whole
    state_dict); without it, the checkpoint ``finetune`` writes."""
    model, _ = get_backbone(backbone, dtype=torch.float32, device="cpu")
    family = ("vit" if backbone.startswith("vit") else "vgg"
              if backbone.startswith("vgg") else "resnet")
    sd = getattr(jax_import, f"from_jax_{family}")(variables, model)
    if not full:
        return sd
    model.load_state_dict(sd, strict=False)
    return {k: v.clone() for k, v in model.state_dict().items()}


def convert_index(src: str, dst: str) -> dict:
    """``src`` (a reference index directory) -> ``dst`` (the port's)."""
    with open(os.path.join(src, "meta.json")) as f:
        meta = json.load(f)
    fmt = meta.get("format", "npz")
    os.makedirs(dst, exist_ok=True)
    if fmt == "orbax":
        store = restore(os.path.join(src, "store"))
        tree = {k: to_tensor(v) for k, v in store.items()}
        save_sharded_pytree(os.path.join(dst, "store"), tree)
        meta["format"] = Index.STREAM_FORMAT
        meta["dtypes"] = {k: str(t.dtype).split(".")[-1]
                          for k, t in tree.items()}
    elif fmt == "npz":
        shutil.copyfile(os.path.join(src, "index.npz"),
                        os.path.join(dst, "index.npz"))
    else:
        raise ValueError(f"{src}: format {fmt!r}, not the reference's")
    backbone = meta["config"]["extract"]["backbone"]
    if meta.get("weights_saved"):
        sd = state_dict(backbone, restore(os.path.join(src, "variables")),
                        full=True)
        torch.save(sd, os.path.join(dst, WEIGHTS_FILE))
        meta["torch_weights"] = WEIGHTS_FILE
    meta["weights_saved"] = False
    for view in VIEWS:
        if meta.get(view):
            shutil.copytree(os.path.join(src, view), os.path.join(dst, view),
                            dirs_exist_ok=True)
    with open(os.path.join(dst, "meta.json"), "w") as f:
        json.dump(meta, f)
    return {"index": dst, "from": fmt, "format": meta["format"],
            "weights": bool(meta.get("torch_weights")),
            "views": [v for v in VIEWS if meta.get(v)]}


def convert_weights(src: str, dst: str) -> dict:
    """``src`` (a reference ``finetune`` checkpoint and its sidecars) ->
    ``dst`` (the port's, with its sidecars ``dst.meta.json`` and, when the
    source has one, ``dst.whitening.npz``)."""
    meta_path = src + ".meta.json"
    wmeta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            wmeta = json.load(f)
    backbone = wmeta.get("backbone", "resnet50")
    save_pytree(dst, state_dict(backbone, restore(src), full=False))
    if wmeta.get("whitening"):
        wpath = wmeta["whitening"]
        if not os.path.isabs(wpath):
            wpath = os.path.join(os.path.dirname(os.path.abspath(meta_path)),
                                 os.path.basename(wpath))
        shutil.copyfile(wpath, dst + ".whitening.npz")
        wmeta["whitening"] = os.path.abspath(dst + ".whitening.npz")
    if wmeta:
        with open(dst + ".meta.json", "w") as f:
            json.dump(wmeta, f)
    return {"weights": dst, "backbone": backbone,
            "meta": dst + ".meta.json" if wmeta else None,
            "whitening": wmeta.get("whitening")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    for name, text in (("index", "a reference index directory"),
                       ("weights", "a reference finetune checkpoint")):
        s = sub.add_parser(name, help=f"convert {text}")
        s.add_argument("src")
        s.add_argument("dst")
    args = p.parse_args(argv)
    fn = convert_index if args.what == "index" else convert_weights
    print(json.dumps(fn(args.src, args.dst)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
