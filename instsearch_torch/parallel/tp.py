"""Tensor-parallel ViT extraction (port of ``instsearch_tpu/parallel/tp.py``).

The Megatron column/row split of the attention and MLP weights (Shoeybi et
al., arXiv:1909.08053) over the ``'model'`` axis of a mesh (devices may
repeat; the axis may span processes), in the torch layout (``[out, in]``,
Flax's kernel transposed):

  qkv       weight [3D, D]  and bias  dim 0 (column split: heads per shard)
  out       weight [D, D]             dim 1 (row split: partial sums)
  linear_1  weight [mlp, D] and bias  dim 0
  linear_2  weight [D, mlp]           dim 1
  everything else (LayerNorms, patch conv, class token, position
  embeddings, the row-split layers' biases) replicated.

The reference writes only these placements and GSPMD derives the forward;
here :class:`TensorParallelViT` writes it out. The residual stream lives on
the group's first device (in each process, its first device of the line).
In each block the LayerNorm output goes to every shard, which applies its
columns of qkv (and of linear_1), attends its heads, and applies its rows
of out (and of linear_2); the shards' partial outputs are summed in f32 on
the first device (the reference's psum), then, on a mesh over a process
group, by one f32 ``all_reduce`` over the line's subgroup, and the bias
is added once. Every process of the line ends with the same output.

Across processes each process places only its own shards of the split
tensors (the state_dict passes through host memory, as the reference's
``place_tp`` takes host arrays), and the replicated ones on its first
device.

qkv's columns are ``(q | k | v)``, each ``(h, hd)``. A contiguous cut of
the 3D columns (the reference's ``P(None, 'model')``, which GSPMD reshards
around its split) would cross q, k and v. So where tp divides the heads,
shard j holds the q, k and v columns of heads ``j h/tp .. (j+1) h/tp - 1``
and attends them alone: its shard has the reference's shape, not its
columns. Where it does not (tp = 8 over 4 heads, which the reference
serves), the columns are cut contiguously as the reference's, q, k and v
are gathered on the first device for attention (across processes by one
``all_gather``), as GSPMD would, and o is cut again into the row split of
out.

A CNN's state_dict has nothing to split: under a ``'model'`` axis it
extracts data-parallel, as in the reference (``Extractor``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.vit import ViT, attend, call_with, templates
from .mesh import AxisGroup, axis_groups, gather_parts

_COL_SPLIT = ("qkv", "linear_1")
_ROW_SPLIT = ("out", "linear_2")


def tp_param_spec(name: str, axis: str = "model") -> "int | None":
    """The dimension of the torch tensor ``name`` (a state_dict key, e.g.
    ``encoder_layer_3.qkv.weight``) that is split over ``axis``, or None
    for a replicated tensor. ``axis`` names the mesh axis, as in the
    reference; the dimension does not depend on it."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    layer, leaf = parts[-2], parts[-1]
    if layer in _COL_SPLIT and leaf in ("weight", "bias"):
        return 0
    if layer in _ROW_SPLIT and leaf == "weight":
        return 1
    return None


def tp_param_specs(state_dict, axis: str = "model") -> dict:
    """``tp_param_spec`` of every tensor of ``state_dict``."""
    return {name: tp_param_spec(name, axis) for name in state_dict}


def _qkv_rows(d: int, heads: int, tp: int, j: int) -> torch.Tensor:
    """Rows of ``qkv.weight`` (and entries of its bias) shard j holds: the
    q, k and v rows of its heads when tp divides them, else the j-th
    contiguous 3D/tp."""
    if heads % tp == 0:
        w = d // tp
        return torch.cat([torch.arange(c * d + j * w, c * d + (j + 1) * w)
                          for c in range(3)])
    w = 3 * d // tp
    return torch.arange(j * w, (j + 1) * w)


def _line(devices) -> AxisGroup:
    """A line of the ``'model'`` axis: an ``AxisGroup`` as it is, a plain
    sequence of devices as all of its line."""
    return devices if isinstance(devices, AxisGroup) else AxisGroup(devices)


def place_group(state_dict, devices, heads: int, axis: str = "model"
                ) -> dict:
    """One line's placement: tensor name -> one tensor per device of
    ``devices`` (an ``AxisGroup`` of ``axis_groups``, or all of a line):
    the shard's slice of a split tensor (a view where it lies on the
    source's device, but for qkv's head rows); the whole of a replicated
    one, on the first device alone. Raises ``ValueError`` for a split
    dimension that the line's length does not divide."""
    line = _line(devices)
    start, tp = line.start, line.size
    out = {}
    for name, t in state_dict.items():
        dim = tp_param_spec(name, axis)
        if dim is None:
            out[name] = (t.to(devices[0]),)
            continue
        if t.shape[dim] % tp:
            raise ValueError(f"parameter {name} dim {dim} ({t.shape[dim]}) "
                             f"not divisible by {axis}={tp}")
        if name.split(".")[-2] == "qkv":
            d = t.shape[0] // 3
            out[name] = tuple(
                t.index_select(0, _qkv_rows(d, heads, tp, start + j)
                               .to(t.device)).to(dev)
                for j, dev in enumerate(devices))
        else:
            c = t.shape[dim] // tp
            out[name] = tuple(t.narrow(dim, (start + j) * c, c).to(dev)
                              for j, dev in enumerate(devices))
    return out


def place_tp(mesh, model: torch.nn.Module, axis: str = "model") -> list:
    """``model``'s weights in their TP placement: one ``place_group`` for
    each line of ``axis`` this process holds (``axis_groups``; one on a
    1-D mesh), in order. A model without split layers (a CNN) comes back
    replicated."""
    heads = getattr(model, "num_heads", 1)
    sd = model.state_dict()
    return [place_group(sd, devs, heads, axis)
            for devs in axis_groups(mesh, axis)]


def _psum(parts, device, bias, dtype, group) -> torch.Tensor:
    """The shards' partial outputs summed in f32 on ``device`` and, with a
    ``group``, over its processes by one f32 ``all_reduce``; the bias added
    once."""
    total = parts[0].to(device).float()
    for p in parts[1:]:
        total = total + p.to(device).float()
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(total, group=group)
    return (total + bias.float()).to(dtype)


class TensorParallelViT:
    """``images [N, H, W, 3] -> [N, H/p, W/p, D]``, the ViT's forward with
    its weights split over ``devices`` (one line of the ``'model'`` axis:
    an ``AxisGroup`` of ``axis_groups``, or a plain sequence of devices
    that is all of it): see the module docstring. ``placement`` is
    ``place_group``'s (made from ``model`` when None); ``load_state_dict``
    places another state_dict of the same model."""

    def __init__(self, model: ViT, devices, placement: "dict | None" = None):
        self.devices = _line(devices)
        self.start, self.tp = self.devices.start, self.devices.size
        self.group = self.devices.group
        self.num_layers = model.num_layers
        self.num_heads = model.num_heads
        self.hidden_dim = model.hidden_dim
        self.dtype = model.dtype
        self.head_split = model.num_heads % self.tp == 0
        self._shell, _ = templates(model)
        self.placement = (placement if placement is not None else
                          place_group(model.state_dict(), self.devices,
                                      model.num_heads))

    def load_state_dict(self, state_dict) -> None:
        self.placement = place_group(state_dict, self.devices,
                                     self.num_heads)

    def _attention(self, x, y, w):
        """The attention half's partial outputs, one per local shard."""
        devs, tp = self.devices, self.tp
        d, h = self.hidden_dim, self.num_heads
        hd, b, n = d // h, x.shape[0], x.shape[1]
        qkv = [F.linear(y.to(dev), w("qkv.weight")[j], w("qkv.bias")[j])
               for j, dev in enumerate(devs)]
        if self.head_split:              # each shard attends its own heads
            hl, parts = h // tp, []
            for j, t in enumerate(qkv):
                q, k, v = (u.reshape(b, n, hl, hd).transpose(1, 2)
                           for u in t.split(d // tp, dim=-1))
                o = attend(q, k, v, None, self.dtype).transpose(1, 2)
                parts.append(F.linear(o.reshape(b, n, d // tp),
                                      w("out.weight")[j]))
            return parts
        # gathered: q, k, v whole on the first device, o cut again
        full = gather_parts(devs[0], self.group, qkv, -1)
        q, k, v = (u.reshape(b, n, h, hd).transpose(1, 2)
                   for u in full.split(d, dim=-1))
        o = attend(q, k, v, None, self.dtype).transpose(1, 2).reshape(b, n, d)
        c, s = d // tp, self.start
        return [F.linear(o[..., (s + j) * c:(s + j + 1) * c].to(dev),
                         w("out.weight")[j]) for j, dev in enumerate(devs)]

    def _block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        p = self.placement

        def w(name):
            return p[f"encoder_layer_{i}.{name}"]

        d, dev0 = (self.hidden_dim,), self.devices[0]
        y = F.layer_norm(x.float(), d, w("ln_1.weight")[0], w("ln_1.bias")[0],
                         1e-6).to(self.dtype)
        x = x + _psum(self._attention(x, y, w), dev0, w("out.bias")[0],
                      self.dtype, self.group)
        y = F.layer_norm(x.float(), d, w("ln_2.weight")[0], w("ln_2.bias")[0],
                         1e-6).to(self.dtype)
        parts = [F.linear(F.gelu(F.linear(y.to(dev), w("linear_1.weight")[j],
                                          w("linear_1.bias")[j])),
                          w("linear_2.weight")[j])
                 for j, dev in enumerate(self.devices)]
        return x + _psum(parts, dev0, w("linear_2.bias")[0], self.dtype,
                         self.group)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        rest = {k: v[0] for k, v in self.placement.items()
                if not k.startswith("encoder_layer_")}
        x, (gh, gw) = call_with(self._shell, rest, "embed",
                                images.to(self.devices[0]))
        for i in range(self.num_layers):
            x = self._block(i, x)
        return call_with(self._shell, rest, "finalize", x, gh, gw)


def split_layer_bytes(placement: dict) -> dict:
    """Bytes of the split layers' tensors (``tp_param_spec`` not None) on
    each shard of one line's placement, and their sum over its shards (in
    one process the layers' whole: each shard holds 1/tp of it)."""
    shards = None
    whole = 0
    for name, parts in placement.items():
        if tp_param_spec(name) is None:
            continue
        sizes = [p.numel() * p.element_size() for p in parts]
        shards = sizes if shards is None else [a + s for a, s in
                                               zip(shards, sizes)]
        whole += sum(sizes)
    return {"shard_bytes": shards or [], "whole_bytes": whole}
