"""Two rules of the port, each pinned here.

The port imports nothing of the JAX package: its evaluation keeps its own
copies of the reference's numpy modules (``instsearch_torch/eval/
revisited.py`` and ``datasets.py``). They are held equal to the reference's
functions on seeded inputs: per-query AP, mAP and mP@k equal for every
protocol, and the mini fixture's dataset fields and image bytes equal.

The port runs on the CUDA card unless the caller asks for the CPU: with no
CUDA device and no explicit ``device``, each entry point raises a
``RuntimeError`` naming the missing card rather than carry on on the CPU.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from instsearch_tpu.eval import datasets as jds
from instsearch_tpu.eval import revisited as jrev
from instsearch_torch import ExtractConfig, IndexConfig, PipelineConfig
from instsearch_torch.eval import datasets as tds
from instsearch_torch.eval import revisited as trev
from instsearch_torch.extractor import Extractor
from instsearch_torch.index import Index
from instsearch_torch.models import get_backbone
from instsearch_torch.search.ivf import IVFIndex
from instsearch_torch.search.ivfpq import IVFPQView
from instsearch_torch.search.lw_rerank import LocalWhiteningView
from instsearch_torch.search.pq_view import PQView
from instsearch_torch.serve import VectorServeCore
from instsearch_torch.builder import ResumableBuilder
from instsearch_torch.data.loader import PrefetchLoader
from instsearch_torch.eval.evaluate import build_index_for_dataset
from instsearch_torch.workloads import run_all, run_workload


def _gnd(rng, n_db, n_q):
    out = []
    for _ in range(n_q):
        pick = rng.permutation(n_db)
        e, h, j = rng.integers(0, 6, size=3)
        out.append({"easy": pick[:e].tolist(), "hard": pick[e:e + h].tolist(),
                    "junk": pick[e + h:e + h + j].tolist()})
    return out


@pytest.mark.parametrize("protocol", ["easy", "medium", "hard", "classic"])
def test_evaluate_ranks_equal(rng, protocol):
    n_db, n_q = 60, 12
    ranks = np.stack([rng.permutation(n_db) for _ in range(n_q)])
    gnd = _gnd(rng, n_db, n_q)
    want = jrev.evaluate_ranks(ranks, gnd, protocol)
    got = trev.evaluate_ranks(ranks, gnd, protocol)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["per_query_ap"], want["per_query_ap"])
    for key in ("mAP", "num_queries", "mP@1", "mP@5", "mP@10"):
        assert got[key] == want[key]


def test_mini_fixture_equal(tmp_path):
    want = jds.make_mini_dataset(str(tmp_path / "jax"), seed=5, size=48)
    got = tds.make_mini_dataset(str(tmp_path / "port"), seed=5, size=48)
    assert isinstance(got, tds.RetrievalDataset)
    for field in ("name", "imlist", "qimlist", "gnd", "ext"):
        assert getattr(got, field) == getattr(want, field)
    for a, b in zip(got.db_paths + got.query_paths,
                    want.db_paths + want.query_paths):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


_ROWS = np.eye(8, dtype=np.float32)
_ENTRY_POINTS = {
    "Extractor": lambda: Extractor(ExtractConfig(backbone="resnet18")),
    "get_backbone": lambda: get_backbone("resnet18"),
    "Index.from_descriptors": lambda: Index.from_descriptors(
        _ROWS, list("abcdefgh"), PipelineConfig(index=IndexConfig())),
    "Index.build": lambda: Index.build(
        [], PipelineConfig(extract=ExtractConfig(backbone="resnet18"))),
    "PQView.from_arrays": lambda: PQView.from_arrays(
        np.zeros((2, 16, 4), np.float32), np.zeros((8, 1), np.int8)),
    # the device is resolved before the path is read
    "LocalWhiteningView.load": lambda: LocalWhiteningView.load("lw"),
    "IVFIndex.load": lambda: IVFIndex.load("ivf"),
    "IVFPQView.load": lambda: IVFPQView.load("ivfpq"),
    "IVFPQView.from_host_store": lambda: IVFPQView.from_host_store(
        SimpleNamespace(n=64, d=8)),
    "VectorServeCore": lambda: VectorServeCore(None, None),
    # the command line's entry points; each resolves the device first
    "ResumableBuilder": lambda: ResumableBuilder(
        [], PipelineConfig(extract=ExtractConfig(backbone="resnet18")),
        "never_made"),
    "build_index_for_dataset": lambda: build_index_for_dataset(
        SimpleNamespace(db_paths=[]),
        PipelineConfig(extract=ExtractConfig(backbone="resnet18"))),
    "run_workload": lambda: run_workload("oxford5k_resnet50_avgpool", None),
    "run_all": lambda: run_all("never_read"),
    "PrefetchLoader(device_put=True)": lambda: PrefetchLoader(
        [], 32, 4, device_put=True),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_default_device_without_cuda_raises(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[entry]()


def test_explicit_cpu_device_runs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx = Index.from_descriptors(_ROWS, list("abcdefgh"),
                                 PipelineConfig(index=IndexConfig()),
                                 device="cpu")
    assert idx.device.type == "cpu"
    assert idx.search(_ROWS[:2])[1][:, 0].tolist() == [0, 1]
