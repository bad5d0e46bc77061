"""``instsearch_torch/utils/observe.py`` against the reference's
``utils/observe.py``: the same sequence of calls moves both packages'
process-wide counters by the same amounts, under the reference's names
(search, query, range search, remove, αDBA, path extraction);
``annotate`` names appear among ``torch.profiler`` events;
``trace`` writes a TensorBoard trace; ``emit_tensorboard`` writes event
files. Counts are integers: equal, no tolerance."""
import glob
import os

import numpy as np
import pytest
import torch

from instsearch_tpu import ExtractConfig as JaxExtractConfig
from instsearch_tpu import IndexConfig as JaxIndexConfig
from instsearch_tpu import PipelineConfig as JaxPipelineConfig
from instsearch_tpu import SearchConfig as JaxSearchConfig
from instsearch_tpu.extractor import Extractor as JaxExtractor
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.utils import COUNTERS as JAX_COUNTERS
from instsearch_torch import (ExtractConfig, IndexConfig, PipelineConfig,
                              SearchConfig)
from instsearch_torch.data import frontend
from instsearch_torch.eval.evaluate import _splice_head
from instsearch_torch.extractor import Extractor
from instsearch_torch.index import Index
from instsearch_torch.utils import COUNTERS, annotate
from instsearch_torch.utils.observe import Counters, emit_tensorboard, trace

NAMES = ("queries_served", "images_removed", "rows_dba_augmented",
         "images_extracted")


def _deltas(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in NAMES}


def _rows():
    rng = np.random.default_rng(81)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _sequence(index, extractor, x, paths):
    index.search(x[:3])
    index.query(x[0])
    index.search_range(x[:2], 0.5)
    index.remove(["1", "2"])
    index.augment_database(n=4)
    extractor.extract_paths(paths)


def test_counters_move_as_the_reference(tmp_path):
    import cv2
    paths = []
    for i in range(3):
        p = str(tmp_path / f"i{i}.png")
        cv2.imwrite(p, np.full((40, 40, 3), i * 40, np.uint8))
        paths.append(p)
    x = _rows()
    names = [str(i) for i in range(64)]
    jcfg = JaxPipelineConfig(index=JaxIndexConfig(row_tile=8),
                             search=JaxSearchConfig(k=5, use_pallas=False))
    jidx = JaxIndex.from_descriptors(x, names, jcfg)
    jex = JaxExtractor(JaxExtractConfig(backbone="resnet18", image_size=32,
                                        dtype="float32", batch_size=4),
                       seed=0)
    before = JAX_COUNTERS.dump()
    _sequence(jidx, jex, x, paths)
    want = _deltas(before, JAX_COUNTERS.dump())

    cfg = PipelineConfig(index=IndexConfig(row_tile=8),
                         search=SearchConfig(k=5))
    tidx = Index.from_descriptors(x, names, cfg, device="cpu")
    tex = Extractor(ExtractConfig(backbone="resnet18", image_size=32,
                                  dtype="float32", batch_size=4),
                    device="cpu")
    before = COUNTERS.dump()
    _sequence(tidx, tex, x, paths)
    got = _deltas(before, COUNTERS.dump())
    assert got == want
    assert want == {"queries_served": 6, "images_removed": 2,
                    "rows_dba_augmented": 62, "images_extracted": 3}


def test_dump_derives_rates():
    c = Counters()
    c.add("images_extracted", 10)
    c.add("queries_served", 4)
    out = c.dump()
    assert out["images_extracted"] == 10 and out["queries_served"] == 4
    assert out["images_per_sec"] == pytest.approx(10 / out["elapsed_sec"])
    assert out["queries_per_sec"] == pytest.approx(4 / out["elapsed_sec"])


def test_annotate_names_reach_the_profiler(tmp_path):
    from instsearch_torch.data import native_frontend
    from instsearch_torch.eval import make_mini_dataset
    ds = make_mini_dataset(str(tmp_path / "mini"), n_instances=1,
                           n_views=2, n_distractors=1, seed=3, size=32)
    ranks = np.stack([np.arange(6), np.arange(6)[::-1]])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("a_named_stage"):
            torch.ones(4).sum()
        list(frontend.batch_paths(ds.db_paths, 32, 2))
        _splice_head(ranks, np.array([[5, -1], [0, 3]]))
    names = {e.name for e in prof.events()}
    assert {"a_named_stage", "splice_head"} <= names
    if native_frontend.available():
        assert "host_decode_native" in names


def test_trace_writes_a_tensorboard_trace(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        (torch.ones(8, 8) * 2).sum()
    found = [f for f in glob.glob(os.path.join(d, "**", "*"), recursive=True)
             if os.path.isfile(f)]
    assert found and all(f.endswith(".pt.trace.json") for f in found)


def test_emit_tensorboard_as_the_reference(tmp_path):
    from instsearch_tpu.utils.observe import Counters as JaxCounters
    from instsearch_tpu.utils.observe import \
        emit_tensorboard as jax_emit_tensorboard
    for emit, counters, sub in ((emit_tensorboard, Counters(), "port"),
                                (jax_emit_tensorboard, JaxCounters(), "jax")):
        counters.add("images_extracted", 10)
        d = str(tmp_path / sub)
        emit(d, scalars={"query": {"p50_ms": 1.5, "path": "cuda"}},
             counters=counters)
        assert glob.glob(os.path.join(d, "events.out.tfevents.*"))
