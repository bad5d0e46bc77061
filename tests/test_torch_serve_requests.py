"""``ServeCore``'s requests beyond queries, against the JAX package's
``ServeCore`` answering the same lines: ``define_subset``, ``drop_subset``,
subset queries, ``add``, ``remove``, ``range`` and ``reconstruct``, and
bad requests answered with an error line; then ``sharded=True``, which
cuts the sharded index again after a mutation.

The rig: the mini fixture written to PNG files at 96 px; a ResNet-18 with
the same variables on both sides, GeM, PCA whitening to 16 dims, an f32
store of 32 images in a capacity of 40 (so the second ``add`` re-pads).
The JAX Index is built over the files; the port's index holds the f32 rows
the JAX build stored, behind the JAX whitening (each side's PCA may flip
an eigenvector's sign). Both decode the build's
images through their native decoders (the same source), requests with cv2.

Tolerances: the response keys equal; ids, names, counts and error lines
equal; scores and vectors within 2e-5, the two extractors' difference on a
query or an added image (measured ~1e-6); ids may differ only where JAX
scores the two within that bar.
"""
import json
import os

import cv2
import numpy as np
import pytest

from instsearch_tpu.config import (ExtractConfig, IndexConfig, PipelineConfig,
                                   SearchConfig)
from instsearch_tpu.eval import make_mini_dataset
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.models import load_torch_resnet
from instsearch_tpu.serve import ServeCore as JaxServeCore
from instsearch_torch import PipelineConfig as TorchPipelineConfig
from instsearch_torch.extractor import Extractor
from instsearch_torch.index import Index
from instsearch_torch.ops.whitening import WhiteningParams
from instsearch_torch.parallel import make_mesh
from instsearch_torch.serve import ServeCore

from parity.torch_models import BasicBlock, TruncatedResNet, randomize_bn_stats

SIZE = 96
TOL = 2e-5
CFG = PipelineConfig(
    extract=ExtractConfig(backbone="resnet18", pooling="gem", image_size=SIZE,
                          whiten=True, whiten_dim=16, dtype="float32",
                          batch_size=8),
    index=IndexConfig(dtype="float32", capacity=40, row_tile=8),
    search=SearchConfig(k=5))


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    import torch
    root = tmp_path_factory.mktemp("serve_requests")
    ds = make_mini_dataset(str(root), seed=4, size=SIZE)
    os.makedirs(root / "png")
    paths = []
    for p in ds.db_paths:
        png = str(root / "png" / (os.path.basename(p)[:-4] + ".png"))
        cv2.imwrite(png, cv2.imread(p))
        paths.append(png)
    torch.manual_seed(0)
    variables = load_torch_resnet(randomize_bn_stats(TruncatedResNet(
        layers=(2, 2, 2, 2), block=BasicBlock)).state_dict())
    seen = []
    build_from = JaxIndex.from_descriptors.__func__

    def recording(cls, descriptors, *a, **kw):
        seen.append(np.array(descriptors, np.float32))
        return build_from(cls, descriptors, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxIndex, "from_descriptors", classmethod(recording))
        jidx = JaxIndex.build(paths[:32], CFG, variables=variables)
    tcfg = TorchPipelineConfig.from_json(CFG.to_json())
    jw = jidx.extractor.whitening
    ex = Extractor(tcfg.extract.replace(whiten=False), variables,
                   whitening=WhiteningParams(torch.tensor(np.asarray(jw.P)),
                                             torch.tensor(np.asarray(jw.mu))),
                   device="cpu")

    names = list(jidx.names)          # before any test mutates jidx

    def port_index():
        return Index.from_descriptors(seen[0], names, tcfg, extractor=ex)

    return {"jidx": jidx, "port_index": port_index, "paths": paths}


def _name(path):
    return os.path.splitext(os.path.basename(path))[0]


def _lines(paths, names):
    """The request sequence: (line, label)."""
    even = names[::2]
    return [
        ({"define_subset": {"name": "even", "members": even}}, "define"),
        ({"define_subset": {"name": "few", "members": names[1:4]}}, "define"),
        ({"image": paths[2], "subset": "even"}, "query"),
        ({"images": paths[5:8], "k": 3, "subset": "few"}, "query"),
        ({"image": paths[0]}, "query"),
        ({"range": {"image": paths[4], "tau": 0.3}}, "range"),
        ({"range": {"image": paths[4], "tau": 0.1, "max_results": 4,
                    "subset": "even"}}, "range"),
        ({"reconstruct": {"names": names[3:6]}}, "reconstruct"),
        ({"reconstruct": {"ids": [0, 31, 7]}}, "reconstruct"),
        ({"add": paths[32:38]}, "mutate"),
        ({"image": paths[33]}, "query"),
        ({"image": paths[2], "subset": "even"}, "query"),
        ({"remove": [names[0], names[2], names[31], _name(paths[33])]},
         "mutate"),
        ({"image": paths[4], "subset": "even"}, "query"),
        ({"add": paths[38:46]}, "mutate"),        # past the capacity of 40
        ({"images": [paths[40], paths[6]], "subset": "even"}, "query"),
        ({"range": {"image": paths[37], "tau": 0.2, "subset": "even"}},
         "range"),
        ({"reconstruct": {"names": [_name(paths[37]), names[6]]}},
         "reconstruct"),
        ({"drop_subset": "few"}, "mutate"),
        ({"image": paths[1], "subset": "few"}, "error"),
        ({"range": {"image": paths[1], "tau": 0.5, "subset": "few"}},
         "error"),
        ({"remove": ["no_such_image"]}, "error"),
        ({"define_subset": {"name": "bad", "members": ["no_such"]}}, "error"),
        ({"reconstruct": {}}, "error"),
        ({"reconstruct": {"ids": [99999]}}, "error"),
        ({"image": "/no/such/file.png"}, "error"),
        ({"images": [paths[1]], "k": "many"}, "error"),
    ]


def _agree_results(want, got):
    assert len(got) == len(want)
    jscore = {r["id"]: r["score"] for r in want}
    for a, b in zip(want, got):
        assert set(a) == set(b) == {"rank", "name", "id", "score"}
        assert a["rank"] == b["rank"]
        if a["id"] != b["id"]:
            assert b["id"] in jscore
            assert abs(jscore[a["id"]] - jscore[b["id"]]) < TOL
        else:
            assert a["name"] == b["name"]
        assert abs(a["score"] - b["score"]) < TOL


def _agree(want: dict, got: dict, label: str):
    assert set(got) == set(want), (label, set(got) ^ set(want))
    for key, w in want.items():
        g = got[key]
        if key == "latency_ms":
            assert isinstance(g, float)
        elif key == "results" and label == "query":
            for wrow, grow in zip(w, g):
                _agree_results(wrow, grow)
            assert len(w) == len(g)
        elif key == "results":
            _agree_results(w, g)
        elif key == "vectors":
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                       atol=TOL)
        else:
            assert g == w, (label, key, g, w)


def test_requests_answer_as_the_reference(rig):
    jidx, tidx, paths = rig["jidx"], rig["port_index"](), rig["paths"]
    jcore, core = JaxServeCore(jidx), ServeCore(tidx)
    names = list(jidx.names)
    for req, label in _lines(paths, names) + [("{not json", "e")]:
        line = req if isinstance(req, str) else json.dumps(req)
        want, got = jcore.handle_line(line), core.handle_line(line)
        if label in ("error", "e"):
            assert set(want) == {"error"}
        _agree(want, got, label)
    assert tidx.num_valid == jidx.num_valid == 32 + 6 - 4 + 8
    assert _name(paths[33]) not in tidx.names
    assert tidx.names == list(jidx.names)
    assert tidx.descriptors.shape[0] == jidx.descriptors.shape[0] == 80
    assert sorted(core.subsets) == sorted(jcore.subsets) == ["even"]
    sub, jsub = core.subsets["even"], jcore.subsets["even"]
    assert (sub.count, sub.layout_gen, sub.n_pad) == (
        jsub.count, jsub.layout_gen, jsub.n_pad)
    np.testing.assert_array_equal(sub.mask.numpy(), np.asarray(jsub.mask))


def test_sharded_core_cuts_the_shards_again(rig):
    """``sharded=True`` on two CPU shards: each mutation re-shards (the
    shards' counts of valid rows follow the store), and every answer equals
    the single-device core's."""
    paths = rig["paths"]
    one = ServeCore(rig["port_index"]())
    two = ServeCore(rig["port_index"](), sharded=True,
                    mesh=make_mesh(2, devices=["cpu"] * 2))
    names = list(one.idx.names)
    before = two.sidx
    for req in ({"define_subset": {"name": "even", "members": names[::2]}},
                {"add": paths[32:44]},
                {"images": paths[32:35]},
                {"image": paths[2], "subset": "even"},
                {"remove": names[:6]},
                {"images": [paths[10], paths[36]], "subset": "even"},
                {"reconstruct": {"names": names[10:12]}}):
        line = json.dumps(req)
        want, got = one.handle_line(line), two.handle_line(line)
        assert "error" not in got, got
        want.pop("latency_ms", None)
        got.pop("latency_ms", None)
        assert got == want
        if "add" in req or "remove" in req:
            assert two.sidx is not before
            before = two.sidx
            assert two.sidx.num_valid == two.idx.num_valid
            assert sum(sh.num_valid for sh in two.sidx.shards) == \
                two.idx.num_valid
    assert two.idx.descriptors.shape[0] == 80        # re-padded, re-cut
    ans = two.handle_line(json.dumps({"image": paths[38]}))
    assert ans["results"][0][0]["name"] == _name(paths[38])
