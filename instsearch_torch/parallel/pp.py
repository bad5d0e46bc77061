"""Pipeline-parallel ViT forward (port of ``instsearch_tpu/parallel/pp.py``).

A GPipe schedule (Huang et al., arXiv:1811.06965), forward only: the L
encoder layers are cut into S = ``mesh.shape['pipe']`` contiguous stages
of L/S layers, each stage's layers on its device of the ``'pipe'`` axis
(devices may repeat: ``["cuda:0"] * 4`` runs the schedule on one card).

- ``stack_layer_params`` stacks each encoder-layer tensor over the layers
  (``[L, ...]``, named as in one block: ``qkv.weight``); ``place_pp``
  puts stage s's L/S rows of each stack on stage s's device and the rest
  (patch conv, class token, position embeddings, final LayerNorm) on the
  group's first device, where ``ViT.embed`` and ``ViT.finalize`` run,
  outside the pipeline.
- The batch is cut into ``n_micro`` microbatches. At step t (``n_micro + S
  - 1`` steps) stage s runs microbatch t - s through its layers, and the
  host enqueues the steps in that order, so stages on distinct cards
  overlap; the activation moves to the next stage's device between
  steps (the reference's ``ppermute``). Unlike the reference's SPMD
  program, the warm-up and drain steps compute nothing.
- Composed with a ``'data'`` axis, each position of it runs its own
  pipeline over its share of the batch (rows in order), weights placed
  per position.
- Across processes (a mesh over a process group, ``parallel/mesh.py``)
  each process holds only its stages' layers. The first stage's process
  embeds; between two stages held by different processes the activation
  moves by ``isend``/``recv`` over the line's subgroup in GPipe order; the
  last stage's process finalizes and broadcasts the result over the
  subgroup, as the reference's final ``psum`` replicates it. The data
  positions' outputs meet by one ``all_gather``.

The blocks are the model's own ``EncoderBlock`` on the plain attention
route, applied to the placed tensors through ``models.vit.call_with``.
"""
from __future__ import annotations

import torch

from ..models.vit import ViT, call_with, templates
from .mesh import axis_groups, batch_groups

_LAYER = "encoder_layer_"


def _check_layers(model: ViT, n_stages: int, axis: str) -> None:
    if model.num_layers % n_stages:
        raise ValueError(f"num_layers={model.num_layers} not divisible by "
                         f"{axis}={n_stages} pipeline stages")


def stack_layer_params(model: ViT) -> tuple[dict, dict]:
    """``(rest, stacked)``: ``stacked`` maps each tensor name of one
    encoder block (``qkv.weight``, ...) to its ``[L, ...]`` stack over the
    layers in order; ``rest`` is the rest of the state_dict (embed and
    finalize)."""
    sd = model.state_dict()
    rest = {k: v for k, v in sd.items() if not k.startswith(_LAYER)}
    first = f"{_LAYER}0."
    names = [k[len(first):] for k in sd if k.startswith(first)]
    stacked = {n: torch.stack([sd[f"{_LAYER}{i}.{n}"]
                               for i in range(model.num_layers)])
               for n in names}
    return rest, stacked


def place_pp(mesh, model: ViT, *, axis: str = "pipe") -> tuple[list, list]:
    """``(rest, stacked)``, one entry per line of ``axis`` this process
    holds (``axis_groups``; one on a 1-D mesh): ``rest[g]`` maps each
    embed/finalize tensor to its copy on the line's first local device;
    ``stacked[g]`` maps each block tensor name to one ``[L/S, ...]`` tensor
    per local stage, on its device (a view of the stack where the device
    is the model's own). Across processes each holds only its stages'
    layers."""
    n_stages = mesh.shape[axis]
    _check_layers(model, n_stages, axis)
    rest, stacked = stack_layer_params(model)
    per = model.num_layers // n_stages
    out_rest, out_stacked = [], []
    for devs in axis_groups(mesh, axis):
        out_rest.append({k: v.to(devs[0]) for k, v in rest.items()})
        out_stacked.append({k: tuple(v[s * per:(s + 1) * per].to(dev)
                                     for s, dev in enumerate(devs,
                                                             devs.start))
                            for k, v in stacked.items()})
    return out_rest, out_stacked


def pipelined_vit_fn(model: ViT, mesh, n_micro: int, axis: str = "pipe",
                     data_axis: "str | None" = None):
    """``f(rest, stacked, images) -> NHWC patch maps`` running the encoder
    stack as a GPipe pipeline over ``mesh[axis]`` (``rest, stacked`` from
    :func:`place_pp`); with a data axis (``'data'`` by default, when the
    mesh has one) each of its positions takes an equal share of the batch.
    The result is on this process's first device of the mesh, on every
    process."""
    n_stages = mesh.shape[axis]
    _check_layers(model, n_stages, axis)
    lines, n_data, data_mesh = batch_groups(mesh, axis, data_axis)
    shell, block = templates(model)
    per = model.num_layers // n_stages

    def layer(stacked_g, s, i):
        return {n: t[s][i] for n, t in stacked_g.items()}

    def forward(rest, stacked, images: torch.Tensor) -> torch.Tensor:
        b = images.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
        if b % (n_micro * n_data):
            raise ValueError(f"batch {b} not divisible by n_micro={n_micro} "
                             f"x {n_data} data positions")
        share = b // n_data
        p = model.patch_size
        # a microbatch's activation: what a stage on another process sends
        act = (share // n_micro, (images.shape[1] // p)
               * (images.shape[2] // p) + 1, model.hidden_dim)
        acts, grids, sent = [], [], []
        for g, (pos, devs) in enumerate(lines):
            tokens, grid = None, (images.shape[1] // p, images.shape[2] // p)
            if devs.start == 0:                 # the first stage embeds
                tokens, grid = call_with(shell, rest[g], "embed",
                                         images[pos * share:(pos + 1) * share]
                                         .to(devs[0]))
            acts.append(list(tokens.chunk(n_micro)) if tokens is not None
                        else [None] * n_micro)
            grids.append(grid)
        params = [[[layer(stacked[g], j, i) for i in range(per)]
                   for j in range(len(devs))]
                  for g, (_, devs) in enumerate(lines)]
        for t in range(n_micro + n_stages - 1):
            for g, (_, devs) in enumerate(lines):
                for j, dev in enumerate(devs):
                    s = devs.start + j
                    m = t - s
                    if not 0 <= m < n_micro:
                        continue
                    if j == 0 and s > 0:    # from the previous process
                        h = torch.empty(act, dtype=model.dtype, device=dev)
                        _recv(h, devs)
                    else:
                        h = acts[g][m].to(dev)          # the ppermute
                    for prm in params[g][j]:
                        h = call_with(block, prm, "forward", h)
                    if j == len(devs) - 1 and s < n_stages - 1:
                        h = h.contiguous()      # kept alive until sent
                        sent.append((_send(h, devs), h))
                        h = None
                    acts[g][m] = h
        for work, _ in sent:
            work.wait()
        out = []
        for g, (_, devs) in enumerate(lines):
            last = devs.start + len(devs) == n_stages
            if last:
                enc = torch.cat([a.to(devs[0]) for a in acts[g]])
                y = call_with(shell, rest[g], "finalize", enc, *grids[g])
            if devs.group is not None:
                # the last stage's output to the line, as the reference's
                # final psum replicates it
                y = (y.contiguous() if last else
                     torch.empty((share,) + grids[g] + (model.hidden_dim,),
                                 dtype=model.dtype, device=devs[0]))
                _broadcast(y, devs)
            out.append(y)
        return (data_mesh.gather(out, 0) if data_mesh is not None
                else out[0])

    return forward


def _recv(h: torch.Tensor, line) -> None:
    """Receive ``h`` from the process before this one on ``line``."""
    import torch.distributed as dist
    dist.recv(h, src=line.global_rank(dist.get_rank(line.group) - 1),
              group=line.group)


def _send(h: torch.Tensor, line):
    """Start sending ``h`` (contiguous) to the process after this one on
    ``line``; the returned work must be waited on, ``h`` kept until then."""
    import torch.distributed as dist
    return dist.isend(h,
                      dst=line.global_rank(dist.get_rank(line.group) + 1),
                      group=line.group)


def _broadcast(y: torch.Tensor, line) -> None:
    """``y`` (contiguous) of the line's last process, on all of its
    processes."""
    import torch.distributed as dist
    dist.broadcast(y, src=line.global_rank(dist.get_world_size(line.group)
                                           - 1), group=line.group)
