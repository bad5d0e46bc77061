"""Siamese fine-tuning for retrieval (port of
``instsearch_tpu/train/trainer.py``; arXiv:1711.02512 §4): tuples of
(anchor, positive, negatives...) pass through the backbone and the pooling,
and a contrastive, triplet or Smooth-AP loss pulls matching pairs together
in descriptor space.

The parameters are f32 master tensors; the optimizer (AdamW, every
parameter decayed, as ``optax.adamw``) updates them. The forward runs the
backbone in its compute dtype: a model built in ``cfg.dtype`` (bf16
convolutions and GEMMs, f32 BatchNorm and LayerNorm) is applied by
``torch.func.functional_call`` to each master cast to that parameter's
dtype, as Flax casts its f32 params at use, so the gradients reach the
masters through the casts. BatchNorm runs on its running statistics, which
are frozen (the reference's ``batch_stats``); its weight and bias train.

Data parallel: ``mesh`` is a ``torch.distributed`` process group (the
default group once ``parallel.multihost.initialize()`` has started it).
Every process is handed the whole batch, runs its slice of it, gathers the
descriptors of all slices (with autograd) and computes the loss over the
whole batch, so Smooth-AP ranks every candidate as in one process; the
gradients are averaged over the processes.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..data import frontend
from ..models import get_backbone
from ..models.registry import load_variables
from ..ops import avg_pool, gem_pool, l2_normalize, mac_pool
from ..utils.device import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class TrainState(NamedTuple):
    params: dict           # name -> f32 master (``gem_p`` when learned)
    frozen: dict           # BatchNorm running statistics (no gradients)
    opt_state: Any         # the optimizer's ``state_dict()``
    step: int


def _descriptors(model, params: dict, frozen: dict, images: torch.Tensor,
                 cfg) -> torch.Tensor:
    """Normalized images ``[B, S, S, 3]`` -> ``[B, D]`` f32 unit
    descriptors. ``model`` is applied to ``params`` (f32 masters, each cast
    to the dtype of the model's parameter of that name) and ``frozen``
    (its buffers). With ``cfg.learn_gem_p`` the GeM exponent is
    ``params["gem_p"]`` and receives gradients (arXiv:1711.02512 learns p
    jointly)."""
    def apply(x):
        tensors = {name: params[name].to(p.dtype)
                   for name, p in model.named_parameters()}
        return functional_call(model, {**tensors, **frozen}, (x,))

    fmap = (checkpoint(apply, images, use_reentrant=False) if cfg.remat
            else apply(images))
    if cfg.pooling == "gem":
        p = params["gem_p"] if cfg.learn_gem_p else cfg.gem_p
        d = gem_pool(fmap, p)
    elif cfg.pooling == "mac":
        d = mac_pool(fmap)
    else:
        d = avg_pool(fmap)
    return l2_normalize(d.float(), axis=-1)


def contrastive_loss(desc: torch.Tensor, cfg) -> torch.Tensor:
    """desc: ``[B, T, D]`` with T = anchor, positive, negatives...
    L = 0.5 ||a - p||^2 + sum_n 0.5 max(0, margin - ||a - n||)^2 (ibid.
    eq. 1), averaged over the tuples."""
    a, p, negs = desc[:, 0], desc[:, 1], desc[:, 2:]
    pos = 0.5 * torch.sum(torch.square(a - p), dim=-1)
    dneg = torch.linalg.norm(a[:, None] - negs, dim=-1)        # [B, Nneg]
    neg = 0.5 * torch.sum(torch.square(F.relu(cfg.margin - dneg)), dim=-1)
    return torch.mean(pos + neg)


def triplet_loss(desc: torch.Tensor, cfg) -> torch.Tensor:
    """max(0, ||a - p||^2 - ||a - n||^2 + margin), averaged over the
    negatives and the tuples."""
    a, p, negs = desc[:, 0], desc[:, 1], desc[:, 2:]
    dp = torch.sum(torch.square(a - p), dim=-1, keepdim=True)
    dn = torch.sum(torch.square(a[:, None] - negs), dim=-1)
    return torch.mean(F.relu(dp - dn + cfg.margin))


def smoothap_loss(desc: torch.Tensor, cfg) -> torch.Tensor:
    """Smooth-AP (Brown et al., arXiv:2007.12163): 1 - mean relaxed AP.
    Each anchor ranks ALL positives and negatives of the batch, ``[B,
    B(T-1)]`` cosines: its own positive is the one relevant item, every
    other tuple's members are extra negatives. With one relevant item the
    relaxed AP is ``1 / (1 + sum_j sigmoid((s_j - s_pos) / tau))``, the
    positive's own column masked out (its sigmoid(0) = 0.5 would bias every
    AP)."""
    b, t, d = desc.shape
    anchors = desc[:, 0]                               # [B, D]
    cands = desc[:, 1:].reshape(b * (t - 1), d)        # [B(T-1), D]
    scores = anchors @ cands.T                         # [B, B(T-1)]
    rows = torch.arange(b, device=desc.device)
    pos_idx = rows * (t - 1)                           # own positive column
    s_pos = scores[rows, pos_idx]
    above = torch.sigmoid((scores - s_pos[:, None]) / cfg.smoothap_tau)
    mask = torch.ones_like(scores)
    mask[rows, pos_idx] = 0.0
    ap = 1.0 / (1.0 + torch.sum(above * mask, dim=-1))
    return 1.0 - torch.mean(ap)


_LOSSES = {"contrastive": contrastive_loss, "triplet": triplet_loss,
           "smoothap": smoothap_loss}


class _GatherBatch(torch.autograd.Function):
    """All processes' ``[b, ...]`` slices -> the ``[P b, ...]`` batch in
    rank order. Backward sums the cotangent over the processes and returns
    this process's slice of it: the adjoint of the gather."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        b = grad.shape[0] // dist.get_world_size(ctx.group)
        return grad[ctx.rank * b:(ctx.rank + 1) * b], None


class Trainer:
    """One fine-tuning run's model, masters and optimizer.

    ``variables``: the reference's Flax variables or a state_dict of the
    port's backbone, copied (the caller's tensors are never updated); None
    draws seeded weights (``init_weights``, as ``Extractor`` does).
    ``mesh``: a ``torch.distributed`` process group for data parallelism,
    or None. ``device`` defaults to the CUDA card. Batches are ``[B, T, S,
    S, 3]`` uint8 or [0, 1] float, numpy or tensors; under a mesh B must
    divide by the number of processes."""

    def __init__(self, cfg, mesh=None, seed: int = 0,
                 variables: dict | None = None,
                 *, device: "torch.device | str | None" = None):
        if cfg.loss not in _LOSSES:
            raise ValueError(f"unknown loss {cfg.loss!r}; expected one of "
                             f"{sorted(_LOSSES)}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]
        self.loss_fn = _LOSSES[cfg.loss]
        self.mesh = mesh
        # attention="xla": the ViT attention kernels have no backward, so
        # training takes the differentiable einsum route
        master, _ = get_backbone(cfg.backbone, dtype=torch.float32,
                                 device=self.device, attention="xla")
        if variables is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            master.init_weights(gen)
        else:
            load_variables(master, variables)
        self.model = (master if self.dtype == torch.float32 else get_backbone(
            cfg.backbone, dtype=self.dtype, device=self.device,
            attention="xla")[0])
        self.params = {name: p for name, p in master.named_parameters()}
        if cfg.learn_gem_p and cfg.pooling == "gem":
            self.params["gem_p"] = torch.nn.Parameter(torch.tensor(
                float(cfg.gem_p), dtype=torch.float32, device=self.device))
        # BatchNorm's running statistics; its step counters are not read
        self.frozen = {name: b for name, b in master.named_buffers()
                       if not name.endswith("num_batches_tracked")}
        if mesh is not None:
            self._broadcast_from_first()
        self.opt = torch.optim.AdamW(list(self.params.values()), lr=cfg.lr,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=cfg.weight_decay)
        self.steps = 0

    def _broadcast_from_first(self) -> None:
        """Every process starts from the first process's weights."""
        import torch.distributed as dist
        with torch.no_grad():
            for t in [*self.params.values(), *self.frozen.values()]:
                dist.broadcast(t, group=self.mesh, group_src=0)

    def _local_batch(self, images) -> torch.Tensor:
        images = torch.as_tensor(images)
        if self.mesh is None:
            return images.to(self.device)
        import torch.distributed as dist
        world, rank = (dist.get_world_size(self.mesh),
                       dist.get_rank(self.mesh))
        if images.shape[0] % world:
            raise ValueError(f"batch of {images.shape[0]} tuples does not "
                             f"split over {world} processes")
        per = images.shape[0] // world
        return images[rank * per:(rank + 1) * per].to(self.device)

    def value_and_grad(self, images) -> tuple[torch.Tensor, dict]:
        """-> ``(loss, {name: gradient})`` of the whole batch at the current
        parameters, averaged over the mesh's processes; nothing is
        updated."""
        x = self._local_batch(images)
        b, t = x.shape[:2]
        flat = frontend.normalize(x.reshape((b * t,) + x.shape[2:]),
                                  dtype=self.dtype)
        desc = _descriptors(self.model, self.params, self.frozen, flat,
                            self.cfg).reshape(b, t, -1)
        if self.mesh is not None:
            desc = _GatherBatch.apply(desc, self.mesh)
        loss = self.loss_fn(desc, self.cfg)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names])
        if self.mesh is not None:
            grads = self._average(grads)
        return loss.detach(), dict(zip(names, grads))

    def _average(self, grads) -> list:
        import torch.distributed as dist
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.mesh)
        flat /= dist.get_world_size(self.mesh)
        return [piece.view_as(g) for piece, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

    def step(self, images) -> dict:
        """One optimizer step on the batch -> ``{"loss": float}`` (the loss
        before the update)."""
        loss, grads = self.value_and_grad(images)
        for name, g in grads.items():
            self.params[name].grad = g
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.steps += 1
        return {"loss": float(loss)}

    @property
    def state(self) -> TrainState:
        return TrainState(self.params, self.frozen, self.opt.state_dict(),
                          self.steps)

    @property
    def variables(self) -> dict:
        """A copy of the backbone's state_dict (f32 masters and running
        statistics) for the extraction stack; the learned GeM exponent is
        :attr:`gem_p`."""
        return {name: t.detach().clone() for name, t in
                [*self.params.items(), *self.frozen.items()]
                if name != "gem_p"}

    @property
    def gem_p(self) -> float:
        p = self.params.get("gem_p")
        return float(p.detach()) if p is not None else float(self.cfg.gem_p)
