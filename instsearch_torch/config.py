"""Frozen configuration dataclasses with JSON round-trip (port of
``instsearch_tpu/config.py``).

The same fields, defaults and JSON form as the reference, so the presets
under ``configs/`` load unchanged (tests/test_torch_config.py holds the two
field for field). The port keeps its own copy for one reason: the
reference's ``ExtractConfig.descriptor_dim`` imports the Flax model
registry, and the port runs where there is no JAX. Here it reads the
port's registry.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


def _asdict(obj) -> dict[str, Any]:
    return dataclasses.asdict(obj)


class _JsonMixin:
    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_dict(cls, d: dict[str, Any]):
        # resolve string annotations (`from __future__ import annotations`
        # makes f.type a STRING, so is_dataclass(f.type) was always False
        # and nested configs came back as raw dicts; review r2)
        import typing
        hints = typing.get_type_hints(cls)
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(
                f"{cls.__name__}: unknown config key(s) {sorted(unknown)} "
                f"(valid: {sorted(names)}) — typo'd preset fields must not "
                f"silently fall back to defaults")
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            t = hints.get(f.name, f.type)
            if dataclasses.is_dataclass(t) and isinstance(v, dict):
                v = t.from_dict(v)
            if isinstance(v, list):
                v = tuple(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ExtractConfig(_JsonMixin):
    """Descriptor-extraction pipeline configuration."""

    backbone: str = "resnet50"          # resnet{18,34,50,101,152} | vgg16
                                        # | vit_{b,l}_16 (models/registry.py)
    pooling: str = "gem"                # avg | mac | gem | rmac
    gem_p: float = 3.0
    rmac_levels: int = 3                # R-MAC scale levels L (arXiv:1511.05879 §3)
    image_size: int = 224               # shorter-side resize target
    center_crop: bool = False           # square center crop after resize
    scales: tuple[float, ...] = (1.0,)  # multi-scale factors (arXiv:1711.02512)
    flip: bool = False                  # horizontal-flip TTA: also pool the
                                        # mirrored image at every scale and
                                        # average (same pass; the
                                        # regional store stays unflipped —
                                        # region geometry is side-dependent)
    whiten: bool = False                # apply PCA-whitening after pooling
    whiten_dim: int = 0                 # 0 = keep full dimensionality
    dtype: str = "bfloat16"             # on-device compute dtype
    batch_size: int = 64
    vit_attention: str = "auto"         # ViT backbones only: auto | xla |
                                        # pallas | flash — 'auto' = the
                                        # plain matmul path; 'pallas' the
                                        # single-pass kernel (K6), 'flash'
                                        # the tiled kernel (K5) for
                                        # 16k-token (2048²) extraction
                                        # (kernels/vit_attention.py)

    @property
    def descriptor_dim(self) -> int:
        from .models.registry import descriptor_dim
        return descriptor_dim(self)


@dataclass(frozen=True)
class IndexConfig(_JsonMixin):
    """Device-resident (optionally sharded) index configuration."""

    num_shards: int = 1                 # row shards across the device mesh
    row_tile: int = 1024                # store rows pad to a multiple of this
    dtype: str = "bfloat16"             # stored descriptor dtype: bfloat16 /
                                        # float32 / int8 (per-row scales) /
                                        # int4 (packed nibble pairs, 4x the
                                        # rows of bf16 per chip)
    capacity: int = 0                   # 0 = size to the dataset, padded to tile
    # database-side augmentation (αDBA, search/dba.py): each stored row is
    # replaced offline by the s^alpha-weighted sum of its dba_n nearest
    # database rows (itself included). 0 = off.
    dba_n: int = 0
    dba_alpha: float = 3.0
    # exact-refine tier (FAISS IndexRefine analog): keep an int8 copy of
    # every row as a 1-region re-rank store; SearchConfig.refine_enabled
    # then re-scores the coarse scan's top-depth candidates against it.
    # Meant for dtype="int4": int4-speed scan, int8-grade top-k, 1.5
    # bytes/component total. "" = off; "int8" is the only option.
    refine_dtype: str = ""
    # similarity metric for RAW-VECTOR indexes (Index.from_descriptors):
    # "ip" (inner product; == cosine on unit rows — the image pipeline's
    # descriptors are always unit) or "l2" (exact Euclidean NN, FAISS
    # IndexFlatL2 analog). "l2" stores rows augmented with one
    # ||x||^2/2 column and queries gain a -1 column, so the UNCHANGED
    # fused IP kernels rank by -L2 exactly (argmax x.q - ||x||^2/2 ==
    # argmin ||x-q||); returned scores are -||x-q||^2. Exact tiers only
    # (search/search_range/knn_graph/sharded search); the cosine-space
    # quality stack (QE/re-rank/diffusion/lw/IVF/PQ) rejects l2 indexes.
    # int8 + l2 is reduced precision: the norm column dominates the
    # per-row scale, so near-tie rankings can flip — prefer f32/bf16
    # (int4 is rejected outright).
    metric: str = "ip"


@dataclass(frozen=True)
class SearchConfig(_JsonMixin):
    """Query-time configuration."""

    k: int = 10
    use_pallas: bool = True             # fused top-k kernel vs the scoring
                                        # oracle (the name is the
                                        # reference's; in the port it
                                        # selects the CUDA kernel)
    # big query batches are served in chunks of this size; also bounds
    # the oracle's [B, N] scores. 0 disables chunking.
    query_chunk: int = 128
    # alpha query expansion (arXiv:1711.02512 §5)
    qe_enabled: bool = False
    qe_n: int = 10                      # number of expansion neighbours
    qe_alpha: float = 3.0
    # regional re-ranking (arXiv:1511.05879 §4)
    rerank_enabled: bool = False
    rerank_depth: int = 100
    # spatial verification fused into the re-rank (search/spatial.py):
    # weight of the weak-geometric-consistency Hough-vote score (largest
    # single-transform-bin mass of the region matches). 0 = off; needs
    # rerank_enabled and a grid-geometry-bearing regional store (indexes
    # built by this version attach it automatically).
    spatial_weight: float = 0.0
    # exact-refine stage (IndexConfig.refine_dtype): re-score the coarse
    # scan's top-rerank_depth candidates against the stored int8 copy —
    # the rerank machinery with the row itself as the single "region"
    # and zero global-fusion weight. Mutually exclusive with
    # rerank_enabled / diffusion_enabled (one re-scoring stage).
    refine_enabled: bool = False
    # diffusion re-ranking (arXiv:1611.05113, truncated — search/diffusion.py):
    # re-score the top-diffusion_depth candidates by diffusing the query's
    # affinity through their mutual-knn similarity graph (CG solve of
    # (I - alpha W) f = y, fixed iteration count). Mutually exclusive with
    # rerank_enabled (one re-scoring stage per query).
    diffusion_enabled: bool = False
    diffusion_depth: int = 200
    diffusion_knn: int = 10
    diffusion_alpha: float = 0.99
    diffusion_iters: int = 20
    diffusion_seeds: int = 10
    # IVF ANN tier (search/ivf.py): probes per query; 0 = exact brute
    # force. Takes effect only when the index has an IVF view attached
    # (Index.build_ivf, which sets this to its nprobe).
    ivf_nprobe: int = 0
    # PQ compressed-domain cascade (search/pq_view.py): ADC coarse scan
    # over 4-bit product-quantized codes selects this many candidates,
    # exactly re-scored against the main store in the same program.
    # 0 = exact brute force. Takes effect only when the index has a PQ
    # view attached (Index.build_pq, which sets this to its depth).
    pq_depth: int = 0
    # IVF-PQ pruned cascade (search/ivfpq.py): probes per query over the
    # bucketed 4-bit residual-code store; candidates exactly re-scored
    # like the PQ cascade. 0 = exact brute force. Takes effect only when
    # the index has an IVF-PQ view attached (Index.build_ivfpq, which
    # sets this to its nprobe). Mutually exclusive with the IVF and PQ
    # views at build time (one candidate tier per index).
    ivfpq_nprobe: int = 0
    # local-whitening re-ranking (search/lw_rerank.py): re-score the
    # top-rerank_depth candidates under each candidate's own cluster
    # metric (k-means-routed per-cluster whitening bank,
    # ops/local_whiten.py). Needs Index.fit_local_whitening (which sets
    # this). Mutually exclusive with the other re-scoring stages.
    lw_enabled: bool = False


@dataclass(frozen=True)
class EvalConfig(_JsonMixin):
    dataset: str = "roxford5k"          # oxford5k|paris6k|roxford5k|rparis6k|mini
    protocol: str = "medium"            # easy | medium | hard (revisited only)
    data_root: str = "data"


@dataclass(frozen=True)
class TrainConfig(_JsonMixin):
    """Contrastive fine-tuning (arXiv:1711.02512)."""

    backbone: str = "resnet50"
    pooling: str = "gem"
    gem_p: float = 3.0
    learn_gem_p: bool = False           # make p a trained parameter
    loss: str = "contrastive"           # contrastive | triplet | smoothap
    margin: float = 0.7                 # contrastive/triplet only
    smoothap_tau: float = 0.01          # Smooth-AP sigmoid temperature
                                        # (arXiv:2007.12163; smoothap only)
    lr: float = 1e-4
    weight_decay: float = 1e-4
    batch_size: int = 8                 # tuples per step
    num_negatives: int = 5
    image_size: int = 224
    dtype: str = "bfloat16"
    remat: bool = False                 # checkpoint the backbone pass:
                                        # recompute activations in the bwd
                                        # pass instead of holding them in
                                        # HBM — the standard memory/FLOPs
                                        # trade for deep backbones (ViT-L,
                                        # ResNet-152) or large tuples


@dataclass(frozen=True)
class PipelineConfig(_JsonMixin):
    """Top-level bundle; what a `configs/*.json` preset stores."""

    extract: ExtractConfig = field(default_factory=ExtractConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    # to_json/from_json: inherited — _JsonMixin recurses into nested
    # dataclasses (asdict down, resolved type hints up)

    @classmethod
    def load(cls, path: str) -> "PipelineConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
