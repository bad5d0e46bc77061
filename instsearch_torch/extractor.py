"""Descriptor extraction: frontend -> backbone -> pooling -> whitening
(port of ``instsearch_tpu/extractor.py``: ``build_extract_fn``,
``build_regional_fn``, ``build_combined_fn`` and ``Extractor``).

Eager PyTorch on one device: uint8 ``[B, S, S, 3]`` in, unit-norm ``[B, D]``
f32 out. Multi-scale extraction runs the backbone once per scale and flip
TTA the mirrored batch too; the L2-normalized descriptors are averaged.
Regional extraction gives the R-MAC per-region rows ``[B, R, D]`` of the
re-rank store; the combined pass gives both from one backbone pass at scale
1.0.

Data-parallel extraction (``Extractor(mesh=)``) runs one replica of the
model on each device of the mesh's batch axis (``'data'``, else its first
axis that is not ``'model'``; devices may repeat, and a repeated device
keeps one replica): the batch is padded to a multiple of the axis size, cut
into one slice a device, each slice extracted there, and the results joined
in order on the first device, which also whitens them. Where the axis spans
processes (a mesh over a process group, ``parallel/mesh.py``) each process
extracts only the slices of its own positions, as the reference splits the
batch over every process's devices; the descriptors meet by one
``all_gather`` over the axis's group, so every process returns the whole
batch, whitened once after the join. The replicas on the other devices
take the first device's weights again whenever they have
changed since the last batch (``load_state_dict`` into ``Extractor.model``
reaches every device). A mesh with a ``'model'`` axis runs a ViT tensor
parallel (``parallel/tp.py``, as the reference's ``place_tp``): each
position of the batch axis this process holds keeps one ``TensorParallelViT``
over its row of ``'model'`` devices (with the row's subgroup where it spans
processes), on the plain attention route (``cfg.vit_attention`` resolves to
``"xla"``, as in the reference); a CNN has nothing to split and extracts
data-parallel, on each row's first device.
"""
from __future__ import annotations

from typing import Optional

import copy

import numpy as np
import torch

from .data import frontend
from .data.loader import iter_batches
from .models import get_backbone
from .models.registry import descriptor_dim, load_variables
from .models.vit import ViT
from .ops import l2_normalize, pool
from .ops.pooling import rmac_region_geometry, rmac_regional_descriptors
from .ops.whitening import WhiteningParams, apply_whitening
from .parallel.mesh import axis_groups, batch_axis, gather_parts
from .parallel.tp import TensorParallelViT
from .utils.device import resolve_device
from .utils.observe import COUNTERS

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _device(d) -> torch.device:
    """The device a tensor placed on ``d`` reports (``"cuda"`` is the
    current card, ``"cpu:0"`` the CPU): mesh entries that name one device
    share one replica."""
    return torch.empty(0, device=d).device


def _global_descriptor(model, cfg, x: torch.Tensor):
    """Normalized images ``x`` -> ``(desc [N, D] f32 unit-norm, the scale-1.0
    feature map or None)``: the backbone per scale (and mirrored, with flip
    TTA), each pooled descriptor L2-normalized, their mean re-normalized."""
    descs, fmap_s1 = [], None
    for scale in cfg.scales:
        xs = frontend.rescale(x, scale)
        fmap = model(xs)
        if scale == 1.0:
            fmap_s1 = fmap
        descs.append(l2_normalize(pool(fmap, cfg).float(), axis=-1))
        if cfg.flip:                         # flip TTA: mirrored pass too
            fm = model(torch.flip(xs, dims=(2,)))
            descs.append(l2_normalize(pool(fm, cfg).float(), axis=-1))
    desc = torch.stack(descs, 0).mean(0) if len(descs) > 1 else descs[0]
    return l2_normalize(desc, axis=-1), fmap_s1


def _regional_rows(fmap: torch.Tensor, cfg) -> torch.Tensor:
    """Feature map -> R-MAC per-region rows ``[N, R, C]`` f32, unit-norm."""
    reg = rmac_regional_descriptors(fmap, cfg.rmac_levels)
    return l2_normalize(reg.float(), axis=-1)


def build_extract_fn(cfg, *, device=None):
    """Returns ``(model, extract_fn)`` with
    ``extract_fn(images, whitening=None) -> [N, D] f32``; ``images`` is a
    uint8 or [0, 1] float tensor ``[N, S, S, 3]`` on the model's device
    (``device``, the CUDA card by default)."""
    model, _ = get_backbone(cfg.backbone, dtype=_DTYPES[cfg.dtype],
                            device=device, attention=cfg.vit_attention)
    return model, build_global_fn(cfg, model)


def build_global_fn(cfg, model):
    """``extract(images, whitening=None) -> [N, D] f32``, the global
    descriptor of ``model`` (``build_extract_fn``'s function)."""
    dtype = _DTYPES[cfg.dtype]

    @torch.inference_mode()
    def extract(images: torch.Tensor,
                whitening: Optional[WhiteningParams] = None) -> torch.Tensor:
        desc, _ = _global_descriptor(
            model, cfg, frontend.normalize(images, dtype=dtype))
        if whitening is not None:
            desc = apply_whitening(desc, whitening)      # includes re-L2
        return desc

    return extract


def build_regional_fn(cfg, *, model):
    """``extract_regional(images, whitening=None) -> [N, R, D] f32``, the
    per-region R-MAC rows of the re-rank store from one backbone pass of
    ``model`` at the images' own size, unit-norm per region (whitened and
    re-normalized when ``whitening`` is given)."""
    dtype = _DTYPES[cfg.dtype]

    @torch.inference_mode()
    def extract_regional(images: torch.Tensor,
                         whitening: Optional[WhiteningParams] = None
                         ) -> torch.Tensor:
        reg = _regional_rows(model(frontend.normalize(images, dtype=dtype)),
                             cfg)
        return reg if whitening is None else apply_whitening(reg, whitening)

    return extract_regional


def build_combined_fn(cfg, *, model):
    """``extract_combined(images, whitening=None) -> ([N, D], [N, R, D])``:
    the global descriptor and the regional rows from one backbone pass at
    scale 1.0, shared by the two (the backbone runs once more only when
    1.0 is not among the scales). Flip TTA applies to the global
    descriptor alone: region geometry depends on the side, so the regional
    rows come from the unflipped map."""
    dtype = _DTYPES[cfg.dtype]

    @torch.inference_mode()
    def extract_combined(images: torch.Tensor,
                         whitening: Optional[WhiteningParams] = None):
        x = frontend.normalize(images, dtype=dtype)
        desc, fmap_s1 = _global_descriptor(model, cfg, x)
        reg = _regional_rows(model(x) if fmap_s1 is None else fmap_s1, cfg)
        if whitening is not None:
            desc = apply_whitening(desc, whitening)
            reg = apply_whitening(reg, whitening)
        return desc, reg

    return extract_combined


class Extractor:
    """Holds the backbone, its weights and the fitted whitening.

    ``variables``: the reference's Flax variables (loaded through
    ``models.jax_import``, by the model's family), or a state_dict of the
    port's model such as ``models.torch_import`` makes from a torchvision
    checkpoint (any mapping without a ``"params"`` collection); None draws
    seeded random weights with Flax's initializer distributions
    (``init_weights``).
    ``device`` defaults to the CUDA card; without one it raises unless the
    caller passes ``device="cpu"``.
    ``mesh`` (a ``ShardMesh`` or a 2-D mesh, ``parallel/mesh.py``) extracts
    data-parallel over its batch axis (see the module docstring); the
    extractor's device is then the axis's first and ``device`` is not
    used. Under a ``'model'`` axis a ViT's weights are split over it
    (tensor parallelism) and ``cfg.vit_attention`` becomes ``"xla"``."""

    def __init__(self, cfg, variables: dict | None = None,
                 whitening: WhiteningParams | None = None, seed: int = 0,
                 mesh=None, *, device: "torch.device | str | None" = None):
        tp = mesh is not None and "model" in mesh.axis_names
        if tp and cfg.vit_attention != "xla":
            # the split heads attend on the plain route (the reference's
            # GSPMD cannot partition a pallas_call either)
            cfg = cfg.replace(vit_attention="xla")
        self.cfg = cfg
        self.seed = seed
        self.mesh = mesh
        groups, self._data_mesh = None, None
        if mesh is not None:
            # one group of devices a data position this process holds: its
            # row of 'model' devices under tensor parallelism, else its one
            # device; the batch axis's 1-D mesh (None for a 'model' axis
            # alone) numbers them and joins their outputs
            bax = batch_axis(mesh)
            self._data_mesh = mesh.along(bax) if bax else None
            groups = ([row.with_devices(tuple(_device(d) for d in row))
                       for row in axis_groups(mesh, "model")] if tp else
                      [(_device(d),) for d in self._data_mesh.devices])
            groups = groups[:self._data_mesh.num_local if bax else 1]
            device = groups[0][0]
        self.device = resolve_device(device)
        self.model, self._fn = build_extract_fn(cfg, device=self.device)
        if variables is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            self.model.init_weights(gen)
        else:
            load_variables(self.model, variables)
        self.model.eval()
        self.whitening = whitening
        self._regional_fn = build_regional_fn(cfg, model=self.model)
        self._combined_fn = build_combined_fn(cfg, model=self.model)
        self._geometry: "np.ndarray | None" = None
        # data parallelism: the batch axis's groups in order (their first
        # devices take the slices), one functions replica per distinct
        # group, the replicas that copy the weights (the models of the
        # devices other than the first, every tensor-parallel one) and the
        # weights' state they were copied at
        self._groups = groups
        self._replicas, self._copies, self._copied_at = {}, [], None
        split = tp and isinstance(self.model, ViT)
        for group in groups or ():
            if group in self._replicas:
                continue
            m = self.model
            if split:
                m = TensorParallelViT(self.model, group)
                self._copies.append(m)
            elif group[0] != self.device:
                m = copy.deepcopy(self.model).to(group[0])
                self._copies.append(m)
            self._replicas[group] = {
                "global": build_global_fn(cfg, m),
                "regional": build_regional_fn(cfg, model=m),
                "combined": build_combined_fn(cfg, model=m)}
        self._copied_at = self._weights_version()

    def _weights_version(self) -> tuple:
        """Each of ``self.model``'s tensors' identity and version counter:
        it changes when a tensor is replaced or written in place (e.g. by
        ``self.model.load_state_dict``)."""
        return tuple((id(t), t._version) for t in
                     self.model.state_dict(keep_vars=True).values())

    def _sync_replicas(self) -> None:
        """Copy ``self.model``'s weights into the other devices' replicas
        when they changed since the last copy."""
        if not self._copies:
            return
        now = self._weights_version()
        if now != self._copied_at:
            state = self.model.state_dict()
            with torch.no_grad():
                for m in self._copies:
                    m.load_state_dict(state)
            self._copied_at = self._weights_version()

    @property
    def dp_size(self) -> int:
        """Positions of the data-parallel axis, over every process (1
        without a mesh)."""
        return (self._data_mesh.num_shards
                if self._groups and self._data_mesh else 1)

    def _run(self, kind: str, images):
        """One extraction function (``"global"``, ``"regional"`` or
        ``"combined"``) over a batch: on the extractor's device, or
        data-parallel over the mesh's batch axis: the batch padded with
        zero images to a multiple of its positions, one slice a position
        (this process's replicas launched for each of its slices before any
        result is joined), the results joined in order on the first device
        (across processes by one ``all_gather``), the padding cut off,
        whitened there."""
        x = self._on_device(images)
        if not self._groups:
            fn = {"global": self._fn, "regional": self._regional_fn,
                  "combined": self._combined_fn}[kind]
            return fn(x, self.whitening)
        self._sync_replicas()
        b, n = x.shape[0], self.dp_size
        pad = (-b) % n
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        c = x.shape[0] // n
        first = self._data_mesh.first_shard if self._data_mesh else 0
        outs = [self._replicas[group][kind](
                    x[(first + j) * c:(first + j + 1) * c].to(group[0]))
                for j, group in enumerate(self._groups)]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        group = self._data_mesh.group if self._data_mesh else None
        joined = tuple(gather_parts(self.device, group, [o[t] for o in outs],
                                    0)[:b] for t in range(len(outs[0])))
        if self.whitening is not None:
            joined = tuple(apply_whitening(t, self.whitening) for t in joined)
        return joined if kind == "combined" else joined[0]

    @property
    def descriptor_dim(self) -> int:
        if self.whitening is not None:
            return int(self.whitening.P.shape[0])
        return descriptor_dim(self.cfg)

    def _on_device(self, images) -> torch.Tensor:
        return torch.as_tensor(np.asarray(images) if not isinstance(
            images, torch.Tensor) else images).to(self.device)

    def __call__(self, images) -> torch.Tensor:
        """uint8 ``[B, S, S, 3]`` (numpy or tensor) -> ``[B, D]`` f32 on the
        extractor's device."""
        return self._run("global", images)

    def regional_geometry(self) -> np.ndarray:
        """The R-MAC grid's geometry ``[R, 3]`` (cx, cy, log side) at
        ``image_size``, the constant spatial verification bins against.
        The map's size comes from a shape pass of the backbone on the
        ``meta`` device (no compute): each of VGG's max-pools floors an odd
        side, so it is not ``image_size // stride``."""
        if self._geometry is None:
            s = self.cfg.image_size
            shape_model, _ = get_backbone(
                self.cfg.backbone, dtype=_DTYPES[self.cfg.dtype],
                device="meta", attention="xla")
            fmap = shape_model(torch.empty((1, s, s, 3), device="meta"))
            self._geometry = rmac_region_geometry(
                fmap.shape[1], fmap.shape[2], self.cfg.rmac_levels)
        return self._geometry

    def extract_regional(self, images) -> torch.Tensor:
        """uint8 ``[B, S, S, 3]`` -> ``[B, R, D]`` f32 per-region rows on the
        extractor's device (the same weights and whitening as the global
        descriptor)."""
        return self._run("regional", images)

    def extract_with_regional(self, images):
        """uint8 ``[B, S, S, 3]`` -> ``([B, D], [B, R, D])`` f32: the global
        descriptor and the regional rows from one backbone pass at scale
        1.0 (``build_combined_fn``), equal to ``self(images)`` and
        ``self.extract_regional(images)``."""
        return self._run("combined", images)

    def _extract_loop(self, paths, quarantine, run):
        """Prefetch-overlapped loop shared by every path-based extraction
        (``data/loader.py::iter_batches``, depth 4, each batch uploaded by
        the producer thread): the host decodes and uploads batch i+1 while
        the card runs batch i, and batch i-1's outputs come back to the
        host only after batch i is launched. ``run(batch) -> tensor |
        tuple of tensors`` of per-image outputs. Returns ``(list of numpy
        arrays, one per output, kept_indices)``, or ``(None, kept)`` when
        nothing decoded; undecodable paths go to ``quarantine``."""
        outs, kept, pending = None, [], None

        def drain(pending):
            res, idxs = pending
            keep = idxs >= 0
            for slot, r in zip(outs, res):
                slot.append(r.cpu().numpy()[keep])
            kept.append(idxs[keep])

        for batch, idxs in iter_batches(
                paths, self.cfg.image_size, self.cfg.batch_size, quarantine,
                depth=4, device_put=True, device=self.device):
            res = run(batch)
            res = res if isinstance(res, tuple) else (res,)
            if outs is None:
                outs = [[] for _ in res]
            if pending is not None:
                drain(pending)
            pending = (res, idxs)
        if pending is not None:
            drain(pending)
        if outs is None:
            return None, np.zeros((0,), np.int64)
        kept = np.concatenate(kept)
        COUNTERS.add("images_extracted", len(kept))
        return [np.concatenate(o) for o in outs], kept

    def extract_paths(self, paths, quarantine: list | None = None):
        """Decode and extract every path in batches of ``cfg.batch_size``.
        Returns ``(descriptors [N, D] f32 numpy, kept_indices [N])``;
        undecodable paths go to ``quarantine``."""
        outs, kept = self._extract_loop(paths, quarantine, self)
        if outs is None:
            return np.zeros((0, self.descriptor_dim), np.float32), kept
        return outs[0], kept

    def extract_paths_with_regional(self, paths,
                                    quarantine: list | None = None):
        """One decode and one backbone pass per image for both the global
        descriptor and the regional re-rank rows (``build_combined_fn``).
        Returns ``(descriptors [N, D], regional [N, R, D], kept_indices
        [N])`` as numpy, row-aligned by construction."""
        outs, kept = self._extract_loop(
            paths, quarantine,
            self.extract_with_regional)
        if outs is None:
            return (np.zeros((0, self.descriptor_dim), np.float32),
                    np.zeros((0, 0, 0), np.float32), kept)
        return outs[0], outs[1], kept
