"""Data-parallel extraction and the 2-D meshes of the port
(``parallel/mesh.py``: ``default_data_mesh``, ``make_mesh_2d``,
``make_mesh_dp_tp``; ``Extractor(mesh=)``, ``Index.build(mesh=)``,
``ResumableBuilder(mesh=)``, ``ShardedIndex`` on a 2-D mesh), mirroring
tests/distributed/test_dp_extraction.py and test_2d_mesh.py.

A ResNet-18 at 32 px in f32 (seeded torchvision-layout weights with
randomized batch-norm statistics, carried into both packages), held to the
JAX single-device ``Extractor`` on the same uint8 images: the reference
test's tolerance, 1e-5 relative and 1e-6 absolute. The meshes are CPU
devices that repeat (``["cpu"] * 8``): one replica of the model, a slice of
the batch each. A data-parallel ``Index.build`` and ``ResumableBuilder``
give the single-device build's ids, names and rows (f32, within 1e-6).
"""
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from instsearch_tpu.config import ExtractConfig as JaxExtractConfig
from instsearch_tpu.extractor import Extractor as JaxExtractor
from instsearch_tpu.models import load_torch_resnet
from instsearch_tpu.search import search_topk as jax_search_topk
from instsearch_torch import ExtractConfig, IndexConfig, PipelineConfig
from instsearch_torch import extractor as extractor_mod
from instsearch_torch.builder import ResumableBuilder
from instsearch_torch.extractor import Extractor
from instsearch_torch.index import Index
from instsearch_torch.parallel import (ShardedIndex, ShardMesh,
                                       default_data_mesh, make_mesh_2d,
                                       make_mesh_dp_tp)
from instsearch_torch.search.bruteforce import search_topk

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from parity.torch_models import (BasicBlock, TruncatedResNet,  # noqa: E402
                                 randomize_bn_stats)

CFG = dict(backbone="resnet18", pooling="gem", image_size=32,
           dtype="float32", batch_size=8)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small CPU tensors in a worker process: one intra-op thread,
    restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def extractors():
    """(JAX single-device, port single-device, port over an 8-device
    'data' mesh, the variables), one set of weights."""
    torch.manual_seed(0)
    variables = load_torch_resnet(randomize_bn_stats(TruncatedResNet(
        layers=(2, 2, 2, 2), block=BasicBlock)).state_dict())
    jax_single = JaxExtractor(JaxExtractConfig(**CFG), variables=variables)
    single = Extractor(ExtractConfig(**CFG), variables, device="cpu")
    dp = Extractor(ExtractConfig(**CFG), variables,
                   mesh=ShardMesh((torch.device("cpu"),) * 8, axis="data"))
    return jax_single, single, dp, variables


def _images(seed, n, size=32):
    return (np.random.default_rng(seed).random((n, size, size, 3))
            * 255).astype(np.uint8)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("batch", [8, 16, 5])    # 5: padded to 8 devices
def test_dp_matches_single_device(extractors, batch):
    jax_single, single, dp, _ = extractors
    assert dp.dp_size == 8 and dp.device == torch.device("cpu")
    imgs = _images(batch, batch)
    got = dp(imgs)
    assert tuple(got.shape) == (batch, 512)
    _close(got, jax_single(imgs))
    _close(got, single(imgs))


def test_dp_regional_and_combined_match(extractors):
    jax_single, single, dp, _ = extractors
    imgs = _images(7, 8)
    _close(dp.extract_regional(imgs), jax_single.extract_regional(imgs))
    desc, reg = dp.extract_with_regional(imgs)
    _close(desc, jax_single(imgs))
    _close(reg, jax_single.extract_regional(imgs))
    sdesc, sreg = single.extract_with_regional(imgs)
    _close(desc, sdesc)
    _close(reg, sreg)


def _write_pngs(folder, n, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = os.path.join(folder, f"img_{i}.png")
        cv2.imwrite(p, (rng.random((40, 48, 3)) * 255).astype(np.uint8))
        paths.append(p)
    return paths


def test_dp_extract_paths(extractors, tmp_path):
    jax_single, _, dp, _ = extractors
    paths = _write_pngs(str(tmp_path), 11)
    d0, k0 = jax_single.extract_paths(paths)
    d1, k1 = dp.extract_paths(paths)
    np.testing.assert_array_equal(k1, k0)
    _close(d1, d0)


def test_weights_loaded_after_construction_reach_every_replica(
        extractors, monkeypatch):
    """A second, distinct replica: ``"cpu:0"`` kept apart from ``"cpu"``
    (on the card, another device). Weights loaded into ``Extractor.model``
    after construction reach it before the next batch (1e-5 relative,
    1e-6 absolute against a single-device extractor built with them)."""
    jax_single, single, _, variables = extractors
    monkeypatch.setattr(extractor_mod, "_device", torch.device)
    dp = Extractor(ExtractConfig(**CFG), variables,
                   mesh=make_mesh_2d(2, 1, devices=["cpu", "cpu:0"]))
    assert len(dp._copies) == 1 and dp._copies[0] is not dp.model
    imgs = _images(11, 6)
    _close(dp(imgs), jax_single(imgs))
    other = Extractor(ExtractConfig(**CFG), seed=5, device="cpu")
    dp.model.load_state_dict(other.model.state_dict())
    _close(dp(imgs), other(imgs))
    assert not torch.allclose(other(imgs), single(imgs), atol=1e-3)


def test_dp_extraction_on_2d_mesh(extractors):
    jax_single, _, _, variables = extractors
    dp = Extractor(ExtractConfig(**CFG), variables,
                   mesh=make_mesh_2d(2, 4, devices=["cpu"] * 8))
    assert dp.dp_size == 2
    imgs = _images(1, 6)
    _close(dp(imgs), jax_single(imgs))


def test_sharded_search_on_2d_mesh():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((512, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    mesh = make_mesh_2d(2, 4, devices=["cpu"] * 8)
    sidx = ShardedIndex(torch.from_numpy(x), np.arange(512), mesh=mesh)
    assert sidx.axis == "shard" and sidx.mesh.num_shards == 4
    q = x[:3] + 0.001
    s_d, i_d = sidx.search(q, k=10)
    s_l, i_l = jax_search_topk(x, q, k=10)
    np.testing.assert_array_equal(i_d.numpy(), np.asarray(i_l))
    np.testing.assert_allclose(s_d.numpy(), np.asarray(s_l), rtol=1e-5)
    s_p, i_p = search_topk(torch.from_numpy(x), torch.from_numpy(q), k=10)
    np.testing.assert_array_equal(i_d.numpy(), i_p.numpy())


def test_build_and_serve_one_mesh(extractors):
    """Extract over 'data', serve sharded over 'shard': one mesh."""
    _, _, _, variables = extractors
    mesh = make_mesh_2d(2, 4, devices=["cpu"] * 8)
    ex = Extractor(ExtractConfig(**CFG), variables, mesh=mesh)
    descs = ex(_images(3, 64))
    sidx = ShardedIndex(descs, np.arange(64), mesh=mesh, k=5)
    _, i = sidx.search(descs[:4], k=5)
    assert (i[:, 0].numpy() == np.arange(4)).all()
    _, iq = sidx.search_qe(descs[:4], k=5, qe_n=3)
    assert (iq[:, 0].numpy() == np.arange(4)).all()
    ranks = sidx.full_ranking(descs[:2])
    assert ranks.shape == (2, 64) and (ranks[:, 0] == np.arange(2)).all()


def test_model_axis_raises_naming_m11(extractors):
    """A ``'model'`` axis (M11, tensor parallelism) no longer raises: a
    ResNet has nothing to split and extracts data-parallel over the
    ``'data'`` axis, equal to the JAX single-device extractor (the ViT's
    split: tests/test_torch_tp.py)."""
    jax_single, _, _, variables = extractors
    ex = Extractor(ExtractConfig(**CFG), variables,
                   mesh=make_mesh_dp_tp(2, 2, devices=["cpu"] * 4))
    assert ex.dp_size == 2
    imgs = _images(4, 6)
    _close(ex(imgs), jax_single(imgs))


def _pipeline():
    return PipelineConfig(extract=ExtractConfig(whiten=False, **CFG),
                          index=IndexConfig(dtype="float32", row_tile=8))


def test_index_build_and_resumable_builder_on_a_mesh(extractors, tmp_path):
    _, _, _, variables = extractors
    paths = _write_pngs(str(tmp_path), 13, seed=3)
    mesh = make_mesh_2d(4, 2, devices=["cpu"] * 8)
    want = Index.build(paths, _pipeline(), variables=variables,
                       device="cpu")
    b = ResumableBuilder(paths, _pipeline(), str(tmp_path / "rb"),
                         group_size=1, variables=variables, mesh=mesh)
    assert b.extractor.dp_size == 4
    b.run()
    for got in (Index.build(paths, _pipeline(), variables=variables,
                            mesh=mesh), b.finalize()):
        assert got.extractor.dp_size == 4 and got.names == want.names
        assert torch.equal(got.ids, want.ids)
        _close(got.descriptors, want.descriptors)


def test_mesh_constructors(monkeypatch):
    m = make_mesh_2d(2, 3, devices=["cpu"] * 6)
    assert m.shape == {"data": 2, "shard": 3}
    assert m.along("data").devices == (torch.device("cpu"),) * 2
    assert m.along("shard").axis == "shard"
    assert make_mesh_dp_tp(2, 2, devices=["cpu"] * 4).axis_names == (
        "data", "model")
    with pytest.raises(ValueError, match="needs 6 devices"):
        make_mesh_2d(2, 3, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert default_data_mesh() is None
    with pytest.raises(ValueError, match="have 1 CUDA devices"):
        make_mesh_2d(2, 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = default_data_mesh()
    assert mesh.axis == "data" and mesh.devices == (
        torch.device("cuda", 0), torch.device("cuda", 1))
