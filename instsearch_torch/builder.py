"""Resumable index building (port of ``instsearch_tpu/builder.py``).

Descriptors are flushed per batch-group to ``out_dir/parts/`` with a
manifest recording completed ranges; on restart, completed groups are
skipped (at-least-once, idempotent by image position). Corrupt images are
quarantined to a sidecar list, never fatal. The manifest and the parts have
the reference's layout. The extractor runs on ``device`` (the CUDA card by
default), or data-parallel over ``mesh`` (``Extractor(mesh=)``), which
without ``mesh`` and ``device`` is ``default_data_mesh()``: every visible
card when there are more than one, else None.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from .config import PipelineConfig
from .extractor import Extractor
from .index import Index, attach_regional_store
from .ops.whitening import (apply_whitening, apply_whitening_regional,
                            fit_whitening)
from .utils.observe import get_logger

log = get_logger("instsearch.builder")


class ResumableBuilder:
    """Builds descriptors for ``paths`` with crash recovery.

    Usage::

        b = ResumableBuilder(paths, cfg, "out/")
        b.run()                 # resumes automatically if interrupted
        index = b.finalize()    # assemble the Index
    """

    def __init__(self, paths: Sequence[str], cfg: PipelineConfig,
                 out_dir: str, group_size: int = 16,
                 variables: dict | None = None, seed: int = 0,
                 mesh=None, *, device: "torch.device | str | None" = None):
        self.paths = list(paths)
        self.cfg = cfg
        if mesh is None and device is None:
            from .parallel.mesh import default_data_mesh
            mesh = default_data_mesh()
        self.extractor = Extractor(cfg.extract.replace(whiten=False),
                                   variables, seed=seed, device=device,
                                   mesh=mesh)
        self.out_dir = out_dir
        self.parts_dir = os.path.join(out_dir, "parts")
        self.manifest_path = os.path.join(out_dir, "manifest.json")
        os.makedirs(self.parts_dir, exist_ok=True)
        self.group = group_size * cfg.extract.batch_size  # images per flush
        self.manifest = self._load_manifest()

    def _load_manifest(self) -> dict:
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                m = json.load(f)
            if m.get("num_paths") != len(self.paths):
                log.warning("manifest path count changed; restarting build")
                m = None
            elif m.get("group") != self.group:
                # a different group size re-shapes the part ranges: stale
                # ranges would make finalize() report a complete build
                # incomplete
                log.warning("manifest group size changed (%s -> %d); "
                            "restarting build", m.get("group"), self.group)
                m = None
            elif bool(m.get("regional")) != self.cfg.search.rerank_enabled:
                # parts without regional rows cannot serve a rerank-enabled
                # finalize (and the other way round wastes space)
                log.warning("manifest regional flag changed; restarting build")
                m = None
            if m is not None:
                return m
        return {"num_paths": len(self.paths), "group": self.group,
                "regional": self.cfg.search.rerank_enabled,
                "completed": [], "quarantined": []}

    def _save_manifest(self) -> None:
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.manifest, f)
        os.replace(tmp, self.manifest_path)   # atomic

    def _part_path(self, start: int) -> str:
        return os.path.join(self.parts_dir, f"part_{start:09d}.npz")

    def run(self) -> None:
        done = {tuple(r) for r in self.manifest["completed"]}
        for start in range(0, len(self.paths), self.group):
            end = min(start + self.group, len(self.paths))
            if (start, end) in done:
                continue
            chunk = self.paths[start:end]
            quarantine: list[str] = []
            extra = {}
            if self.cfg.search.rerank_enabled:
                # one pass, as Index.build: the regional re-rank rows come
                # from the same decode and backbone run, flushed into the
                # part, so finalize never extracts again
                descs, reg, kept = \
                    self.extractor.extract_paths_with_regional(chunk,
                                                               quarantine)
                extra["regional"] = reg
            else:
                descs, kept = self.extractor.extract_paths(chunk, quarantine)
            np.savez(self._part_path(start), descriptors=descs,
                     kept=np.asarray(kept) + start, **extra)
            self.manifest["completed"].append([start, end])
            self.manifest["quarantined"].extend(quarantine)
            self._save_manifest()
            log.info("group [%d, %d) done (%d imgs, %d quarantined)",
                     start, end, len(kept), len(quarantine))

    def finalize(self, fit_whitening_now: bool = True,
                 whitening=None) -> Index:
        """Assemble the parts into an Index (fitting whitening on the
        collected descriptors when the config asks for it; ``whitening``
        supplies fitted params instead)."""
        ranges = sorted(tuple(r) for r in self.manifest["completed"])
        expected = [(s, min(s + self.group, len(self.paths)))
                    for s in range(0, len(self.paths), self.group)]
        if ranges != expected:
            missing = set(expected) - set(ranges)
            raise RuntimeError(
                f"build incomplete; missing groups {sorted(missing)[:5]}")
        descs, kept, regional = [], [], []
        want_regional = self.cfg.search.rerank_enabled
        for s, _ in expected:
            part = np.load(self._part_path(s))
            descs.append(part["descriptors"])
            kept.append(part["kept"])
            if want_regional:
                regional.append(part["regional"])
        descs = np.concatenate(descs) if descs else np.zeros((0, 1),
                                                             np.float32)
        kept = np.concatenate(kept) if kept else np.zeros((0,), np.int64)
        regional = (np.concatenate(regional)
                    if want_regional and regional else None)

        ex = self.extractor
        descs = torch.as_tensor(descs, device=ex.device)
        if whitening is not None or (self.cfg.extract.whiten
                                     and fit_whitening_now):
            ex.whitening = whitening if whitening is not None else \
                fit_whitening(descs, dim=self.cfg.extract.whiten_dim or None)
            descs = apply_whitening(descs, ex.whitening)
            if regional is not None and len(regional):
                regional = apply_whitening_regional(regional, ex.whitening)

        names = [os.path.splitext(os.path.basename(self.paths[i]))[0]
                 for i in kept]
        idx = Index.from_descriptors(descs, names, self.cfg, extractor=ex,
                                     original_ids=kept)
        idx.quarantined = list(self.manifest["quarantined"])
        if regional is not None:
            # the regional re-rank store Index.build attaches, from the
            # parts' single-pass rows
            attach_regional_store(idx, regional)
        if self.cfg.index.dba_n:
            idx.augment_database()   # αDBA, the policy of Index.build
        return idx
