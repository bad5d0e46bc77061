"""The port's workload runner (``instsearch_torch/workloads.py``) against the
reference's (``instsearch_tpu/workloads.py``): the same presets listed, and
``run_workload`` on the mini fixture returning the reference's keys for
every preset, the three that nothing else drives included
(``oxford5k_resnet50_avgpool``, ``roxford_gem_multiscale_qe``,
``compact128_int4``), with the values that the config alone decides equal
(backbone, pooling, whitening, scales, stages, shards, image count, dim)
and every stage the preset enables applied (``stages_missing`` empty).

Both sides run at ``run_workload``'s own scale-down (64 px, batch 8), and
each draws its own seeded weights, so the measured values (mAP, recall,
times) are not compared. To keep the CPU run short, the presets' two
backbones are swapped, in both registries at once, for small members of
their families: ResNet-50 for a (1, 1, 1, 1) BasicBlock ResNet (512
channels), VGG16 for a three-convolution VGG (24 channels); the runner's
code paths do not depend on the width. The sharded presets keep their
shards: eight virtual CPU devices in the reference (tests/conftest.py),
eight CPU shards in the port."""
import numpy as np
import pytest
import torch

import instsearch_tpu.models.registry as jreg
import instsearch_torch.models.registry as treg
from instsearch_tpu import workloads as jwl
from instsearch_tpu.eval import make_mini_dataset
from instsearch_tpu.models.resnet import BasicBlock as JaxBasicBlock
from instsearch_tpu.models.resnet import ResNet as JaxResNet
from instsearch_tpu.models.torch_import import (load_torch_resnet,
                                                load_torch_vgg)
from instsearch_tpu.models.vgg import VGG as JaxVGG
from instsearch_torch import workloads as twl
from instsearch_torch.models.resnet import BasicBlock, ResNet
from instsearch_torch.models.vgg import VGG

NARROW_VGG = (8, "M", 16, 16, "M", 24)
# values the preset decides; mAP, recall and times are measured
DECIDED = ("workload", "backbone", "pooling", "whiten", "scales", "qe",
           "rerank", "spatial", "lw", "num_shards", "num_images",
           "descriptor_dim", "stages_missing", "ivfpq")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on a few cores: this
    module's small CPU tensors take one intra-op thread (no oversubscribed
    thread pools), restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_resnet(dtype=None):
    return JaxResNet(stage_sizes=(1, 1, 1, 1), dtype=dtype,
                     block=JaxBasicBlock)


def _port_resnet(dtype=torch.bfloat16, device=None):
    return ResNet((1, 1, 1, 1), block=BasicBlock, dtype=dtype, device=device)


def _jax_vgg(dtype=None):
    return JaxVGG(cfg=NARROW_VGG, dtype=dtype)


def _port_vgg(dtype=torch.bfloat16, device=None):
    return VGG(NARROW_VGG, dtype=dtype, device=device)


@pytest.fixture(scope="module")
def small_backbones():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jreg.BACKBONES, "resnet50", jreg.BackboneSpec(
            _jax_resnet, 512, 32, load_torch_resnet))
        mp.setitem(jreg.BACKBONES, "vgg16", jreg.BackboneSpec(
            _jax_vgg, 24, 4, load_torch_vgg))
        mp.setitem(treg.BACKBONES, "resnet50", treg.BackboneSpec(
            _port_resnet, 512, 32))
        mp.setitem(treg.BACKBONES, "vgg16", treg.BackboneSpec(
            _port_vgg, 24, 4))
        yield


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return make_mini_dataset(str(tmp_path_factory.mktemp("mini_wl")), seed=6)


def test_presets_listed_as_the_reference():
    assert twl.list_presets() == jwl.list_presets()
    assert len(twl.list_presets()) == 12
    for name in twl.list_presets():
        assert twl.load_preset(name).to_json() == \
            jwl.load_preset(name).to_json()


@pytest.mark.parametrize("name", jwl.list_presets())
def test_run_workload_keys_match_the_reference(small_backbones, mini, name):
    want = jwl.run_workload(name, mini, scale_down=True)
    got = twl.run_workload(name, mini, scale_down=True, device="cpu")
    assert set(got) == set(want)
    for key in DECIDED:
        assert got.get(key) == want.get(key), key
    assert got["stages_missing"] == []
    assert np.isfinite(got["mAP"]) and 0 <= got["mAP"] <= 100
    if got["num_shards"] > 1:
        assert got["sharded_matches_single"] is True
    if "ivfpq_recall_at_10" in got:
        assert 0 <= got["ivfpq_recall_at_10"] <= 1
