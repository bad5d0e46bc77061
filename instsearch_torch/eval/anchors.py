"""Literature mAP anchors for parity checking (the port's own copy of
``instsearch_tpu/eval/anchors.py``, which imports no JAX; the port imports
nothing of the JAX package).

Given an evaluation config + dataset + protocol it returns the matching
published anchor, and ``cli evaluate`` prints measured-vs-anchor whenever
one matches. Literature numbers use the paper authors' exact crops and
scales; ``tolerance`` is the band around each anchor given crop, scale and
weight-version variance, not a precision claim.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Anchor:
    """One literature anchor: expected mAP (percent) for a method+dataset."""
    dataset: str          # load_dataset name ("oxford5k", "roxford5k", ...)
    protocol: str         # "classic" | "medium" | "hard"
    backbone_family: str  # "vgg16" | "resnet50" | "resnet101" | ...
    pooling: str          # "avg" | "mac" | "rmac" | "gem"
    qe: Optional[bool]    # required QE state; None = either
    map_pct: float        # anchor mAP, percent
    tolerance: float      # honest +- band (crop/scale/weight variance)
    source: str           # citation
    note: str = ""


# The BASELINE.md §"literature anchors" table, machine-readable. Values are
# the published numbers for off-the-shelf / fine-tuned variants of the
# methods in BASELINE.json configs 1-3 and 5.
ANCHORS: tuple[Anchor, ...] = (
    Anchor("oxford5k", "classic", "vgg16", "rmac", False,
           66.9, 3.0, "Tolias et al., arXiv:1511.05879",
           "off-the-shelf VGG16 R-MAC"),
    Anchor("paris6k", "classic", "vgg16", "rmac", True,
           84.0, 3.0, "arXiv:1511.05879",
           "VGG16 R-MAC + QE (published ~83-85, BASELINE.md)"),
    Anchor("paris6k", "classic", "vgg16", "rmac", False,
           83.0, 3.0, "arXiv:1511.05879",
           "off-the-shelf VGG16 R-MAC, no QE"),
    Anchor("oxford5k", "classic", "resnet50", "avg", None,
           47.0, 8.0, "literature range (SURVEY.md §6)",
           "off-the-shelf ResNet-50 avg-pool, config-dependent 40-55"),
    Anchor("roxford5k", "medium", "resnet101", "gem", None,
           64.7, 2.0, "Radenović et al., arXiv:1803.11285",
           "fine-tuned ResNet101-GeM"),
    Anchor("roxford5k", "hard", "resnet101", "gem", None,
           38.5, 2.0, "arXiv:1803.11285", "fine-tuned ResNet101-GeM"),
    Anchor("rparis6k", "medium", "resnet101", "gem", None,
           77.2, 2.0, "arXiv:1803.11285", "fine-tuned ResNet101-GeM"),
    Anchor("rparis6k", "hard", "resnet101", "gem", None,
           56.3, 2.0, "arXiv:1803.11285", "fine-tuned ResNet101-GeM"),
)


def lookup_anchor(cfg, dataset: str, protocol: str) -> Optional[Anchor]:
    """Find the anchor matching a PipelineConfig + dataset + protocol.

    Matching is deliberately strict on the axes that move mAP by tens of
    points (backbone family, pooling, dataset, protocol) and lenient on
    the ones papers vary freely (image size, scales): a loose match that
    compares a GeM run against an R-MAC anchor would manufacture fake
    parity gaps. Returns None when no anchor applies.
    """
    backbone = cfg.extract.backbone.lower()
    pooling = cfg.extract.pooling.lower()
    qe = bool(cfg.search.qe_enabled)
    for a in ANCHORS:
        if a.dataset != dataset or a.protocol != protocol:
            continue
        if not backbone.startswith(a.backbone_family):
            continue
        if pooling != a.pooling:
            continue
        if a.qe is not None and qe != a.qe:
            continue
        return a
    return None


def compare(measured_map_pct: float, anchor: Anchor) -> dict:
    """measured-vs-anchor report fragment. ``measured_map_pct`` in percent
    (the evaluator's ``mAP`` key scale), like the anchor table."""
    measured_pct = float(measured_map_pct)
    delta = measured_pct - anchor.map_pct
    return {
        "anchor_map_pct": anchor.map_pct,
        "anchor_tolerance_pct": anchor.tolerance,
        "anchor_source": anchor.source,
        "anchor_note": anchor.note,
        "measured_map_pct": round(measured_pct, 2),
        "delta_vs_anchor_pct": round(delta, 2),
        "within_tolerance": bool(abs(delta) <= anchor.tolerance),
    }
