"""Expert-parallel local whitening (port of ``instsearch_tpu/parallel/ep.py``).

The local-whitening bank (``ops/local_whiten.py``) is E experts ``P [E,
dim, D]``, ``mu [E, D]`` routed by a codebook ``centroids [E, D]``, with
hard top-1 routing. Here the experts are split over the shards of a
:class:`~instsearch_torch.parallel.mesh.ShardMesh` (E / S consecutive
experts a shard, on its device) and the router is replicated, so every
shard computes the same assignment for every row and no routing is sent.
Each shard projects the rows whose expert it holds and gives zeros for the
rest; the combine is a sum over the shards (each row has exactly one
non-zero contributor, so the sum is exact), then the L2 normalization, so
the result equals the single-device ``apply_local_whitening``. With a
process group the shards' pieces meet through ``ShardMesh.gather``.
"""
from __future__ import annotations

import torch

from ..ops.local_whiten import LocalWhiteningParams, project_by_expert
from ..ops.pooling import l2_normalize
from .mesh import ShardMesh, replicate


def _experts_per_shard(mesh: ShardMesh, e: int) -> int:
    if e % mesh.num_shards:
        raise ValueError(f"E={e} experts not divisible by "
                         f"{mesh.num_shards} shards")
    return e // mesh.num_shards


def place_ep(mesh: ShardMesh, params: LocalWhiteningParams
             ) -> LocalWhiteningParams:
    """A fitted bank in its expert-parallel placement: each field a tuple
    with one tensor per local shard, on its device; ``P`` and ``mu`` are
    the shard's E / S experts, ``centroids`` the whole router."""
    e_local = _experts_per_shard(mesh, params.P.shape[0])
    first = mesh.first_shard
    return LocalWhiteningParams(
        centroids=tuple(replicate(mesh, params.centroids)),
        P=tuple(params.P[(first + j) * e_local:(first + j + 1) * e_local]
                .to(dev) for j, dev in enumerate(mesh.devices)),
        mu=tuple(params.mu[(first + j) * e_local:(first + j + 1) * e_local]
                 .to(dev) for j, dev in enumerate(mesh.devices)))


def expert_whiten_fn(mesh: ShardMesh, *, renormalize: bool = True):
    """``f(params, x [B, D]) -> [B, dim]`` applying the bank with its
    experts over ``mesh``'s shards. ``params`` is :func:`place_ep`'s
    placement (a whole bank is placed first); ``x`` is replicated to every
    shard. The result is on the mesh's first device."""
    def forward(params: LocalWhiteningParams, x: torch.Tensor
                ) -> torch.Tensor:
        if isinstance(params.P, torch.Tensor):
            params = place_ep(mesh, params)
        e_local = params.P[0].shape[0]
        parts = []
        for j, (cent, p_loc, mu_loc, xx) in enumerate(zip(
                params.centroids, params.P, params.mu,
                replicate(mesh, x.float()))):
            a = (xx @ cent.T).argmax(dim=-1)                # global expert
            lo = (mesh.first_shard + j) * e_local
            # rows of another shard's experts fall outside [0, e_local)
            # and come back zero
            parts.append(project_by_expert(xx, a - lo, p_loc, mu_loc)[None])
        out = mesh.gather(parts, dim=0).sum(dim=0)         # one contributor
        return l2_normalize(out, axis=-1) if renormalize else out

    return forward
