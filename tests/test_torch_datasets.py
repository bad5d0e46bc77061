"""The port's on-disk dataset loaders and literature anchors
(``instsearch_torch/eval/datasets.py``, ``eval/anchors.py``, its own copies
of the reference's numpy modules) against the reference's on the same
files: ``load_revisited`` on a ``gnd_*.pkl`` and ``load_classic`` on a
``gt/`` tree the test writes, ``with_distractors``, ``load_dataset`` for
each name, including the refusal to regenerate over a non-default mini
fixture, and the anchor table, lookup and comparison. Every field equal
(names, ground truth, boxes, paths); no tolerance."""
import dataclasses
import os
import pickle
import shutil

import numpy as np
import pytest

from instsearch_tpu.config import ExtractConfig as JaxExtractConfig
from instsearch_tpu.config import PipelineConfig as JaxPipelineConfig
from instsearch_tpu.config import SearchConfig as JaxSearchConfig
from instsearch_tpu.eval import anchors as janchors
from instsearch_tpu.eval import datasets as jds
from instsearch_torch import ExtractConfig, PipelineConfig, SearchConfig
from instsearch_torch.eval import anchors as tanchors
from instsearch_torch.eval import datasets as tds


def _fields(ds) -> dict:
    out = dataclasses.asdict(ds)
    out["db_paths"] = ds.db_paths
    out["query_paths"] = ds.query_paths
    return out


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return tds.make_mini_dataset(str(tmp_path_factory.mktemp("mini_ds")),
                                 n_instances=2, n_views=2, n_distractors=2,
                                 seed=5, size=32)


def test_load_revisited_equal(tmp_path):
    rng = np.random.default_rng(0)
    base = tmp_path / "roxford5k"
    base.mkdir()
    imlist = [f"img_{i:04d}" for i in range(20)]
    gnd = [{"easy": rng.permutation(20)[:3].tolist(),
            "hard": rng.permutation(20)[:2].tolist(),
            "junk": rng.permutation(20)[:1].tolist(),
            "bbx": rng.uniform(0, 100, 4).tolist()} for _ in range(4)]
    with open(base / "gnd_roxford5k.pkl", "wb") as f:
        pickle.dump({"imlist": imlist, "qimlist": imlist[:4], "gnd": gnd}, f)
    for load in (lambda: tds.load_revisited("roxford5k", str(tmp_path)),
                 lambda: tds.load_dataset("roxford5k", str(tmp_path))):
        got = load()
        want = jds.load_revisited("roxford5k", str(tmp_path))
        assert _fields(got) == _fields(want)
        assert got.image_root == str(base / "jpg")


def _classic_tree(root, mini):
    base = root / "oxford5k"
    (base / "gt").mkdir(parents=True)
    (base / "jpg").mkdir()
    names = ["all_souls_000001", "all_souls_000002", "radcliffe_000003",
             "query_img_0009", "bodleian_000004"]
    for n, src in zip(names, mini.db_paths):
        shutil.copy(src, base / "jpg" / f"{n}.jpg")
    gt = base / "gt"
    (gt / "all_souls_1_query.txt").write_text(
        "oxc1_query_img_0009 10.0 20.0 200.0 300.0\n")
    (gt / "all_souls_1_good.txt").write_text("all_souls_000001\n")
    (gt / "all_souls_1_ok.txt").write_text("all_souls_000002\nnot_there\n")
    (gt / "all_souls_1_junk.txt").write_text("radcliffe_000003\n")
    (gt / "bodleian_2_query.txt").write_text(
        "bodleian_000004 1.5 2.5 30.0 40.0\n")
    (gt / "bodleian_2_good.txt").write_text("\nall_souls_000002\n\n")


def test_load_classic_equal(tmp_path, mini):
    _classic_tree(tmp_path, mini)
    want = jds.load_classic("oxford5k", str(tmp_path))
    for got in (tds.load_classic("oxford5k", str(tmp_path)),
                tds.load_dataset("oxford5k", str(tmp_path))):
        assert _fields(got) == _fields(want)
    assert want.qimlist == ["query_img_0009", "bodleian_000004"]
    assert want.gnd[1]["easy"] == [] and want.gnd[1]["junk"] == []


def test_with_distractors_equal(tmp_path, mini):
    extra = tmp_path / "flickr"
    extra.mkdir()
    for i, src in enumerate(mini.db_paths[:3]):
        shutil.copy(src, extra / f"d{i}.jpg")
    for limit in (None, 2):
        want = jds.with_distractors(mini, str(extra), limit=limit)
        got = tds.with_distractors(mini, str(extra), limit=limit)
        assert _fields(got) == _fields(want)
        assert all(os.path.exists(p) for p in got.db_paths)


def test_load_dataset_mini_and_its_refusal(tmp_path):
    want = jds.load_dataset("mini", str(tmp_path / "jax"))
    got = tds.load_dataset("mini", str(tmp_path / "port"))
    assert {k: v for k, v in _fields(got).items()
            if "path" not in k and k != "image_root"} == \
        {k: v for k, v in _fields(want).items()
         if "path" not in k and k != "image_root"}
    for a, b in zip(got.db_paths, want.db_paths):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    # the default fixture regenerates in place; a non-default one is refused
    tds.load_dataset("mini", str(tmp_path / "port"))
    tds.make_mini_dataset(str(tmp_path / "port" / "mini"), n_instances=9)
    with pytest.raises(ValueError, match="non-default mini fixture") as e:
        tds.load_dataset("mini", str(tmp_path / "port"))
    jds.make_mini_dataset(str(tmp_path / "jax" / "mini"), n_instances=9)
    with pytest.raises(ValueError) as je:
        jds.load_dataset("mini", str(tmp_path / "jax"))
    assert str(e.value).replace("port", "jax") == str(je.value)
    for mod in (tds, jds):
        with pytest.raises(ValueError, match="unknown dataset"):
            mod.load_dataset("imagenet", str(tmp_path))


def test_anchors_equal():
    assert [dataclasses.asdict(a) for a in tanchors.ANCHORS] == \
        [dataclasses.asdict(a) for a in janchors.ANCHORS]
    cases = [("vgg16", "rmac", False, "paris6k", "classic"),
             ("vgg16", "rmac", True, "paris6k", "classic"),
             ("resnet50", "avg", True, "oxford5k", "classic"),
             ("resnet101", "gem", False, "roxford5k", "hard"),
             ("resnet50", "gem", False, "roxford5k", "medium"),
             ("vit_b_16", "gem", False, "mini", "medium")]
    for backbone, pooling, qe, dataset, protocol in cases:
        want = janchors.lookup_anchor(JaxPipelineConfig(
            extract=JaxExtractConfig(backbone=backbone, pooling=pooling),
            search=JaxSearchConfig(qe_enabled=qe)), dataset, protocol)
        got = tanchors.lookup_anchor(PipelineConfig(
            extract=ExtractConfig(backbone=backbone, pooling=pooling),
            search=SearchConfig(qe_enabled=qe)), dataset, protocol)
        assert (got is None) == (want is None)
        if want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            for measured in (want.map_pct, want.map_pct + 5.123, 1.0):
                assert tanchors.compare(measured, got) == \
                    janchors.compare(measured, want)
