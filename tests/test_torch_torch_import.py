"""The port's torchvision importer (``instsearch_torch/models/torch_import.py``)
against the reference's (``instsearch_tpu/models/torch_import.py``): one
seeded torchvision-layout state_dict each for ResNet-50, VGG16 and a narrow
ViT (classifier keys and BatchNorm step counters included, as real
checkpoints carry them) goes through both importers, into the port's
module and into the Flax model, and both forward the same images.

Tolerances, those of tests/test_torch_resnet.py, test_torch_vgg.py and
test_torch_vit.py: in f32 the CNN forwards differ by the convolutions'
summation order alone, max|diff| / max|ref| < 1e-4; the ViT's within 2e-5.
The GeM descriptors (p = 3, L2-normalized) then agree within 1e-5. The
importers refuse keys no rule takes, and ``validate_variables`` a state_dict
that does not fit the model."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.models import torch_import as jimport
from instsearch_tpu.models.resnet import resnet50 as jax_resnet50
from instsearch_tpu.models.vgg import vgg16 as jax_vgg16
from instsearch_tpu.models.vit import ViT as JaxViT
from instsearch_torch.models import get_backbone
from instsearch_torch.models import torch_import as timport
from instsearch_torch.models.vit import ViT

from parity.torch_models import (Bottleneck, TruncatedResNet, TruncatedVGG16,
                                 TruncatedViT, randomize_bn_stats)

TINY = dict(hidden_dim=32, num_layers=2, num_heads=4, mlp_dim=64,
            patch_size=4, image_size=16)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on a few cores: this
    module's small CPU tensors take one intra-op thread (no oversubscribed
    thread pools), restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _with_head(sd: dict, head: str, width: int) -> dict:
    g = torch.Generator().manual_seed(1)
    return dict(sd, **{f"{head}.weight": torch.randn(10, width, generator=g),
                       f"{head}.bias": torch.randn(10, generator=g)})


def _resnet_sd():
    torch.manual_seed(0)
    tm = randomize_bn_stats(TruncatedResNet(layers=(3, 4, 6, 3),
                                            block=Bottleneck))
    return _with_head(tm.state_dict(), "fc", 2048)


def _vgg_sd():
    torch.manual_seed(0)
    return _with_head(TruncatedVGG16().state_dict(), "classifier.0", 512)


def _vit_sd():
    torch.manual_seed(0)
    tm = TruncatedViT(image_size=16, patch_size=4, hidden_dim=32,
                      num_layers=2, num_heads=4, mlp_dim=64)
    with torch.no_grad():           # move the zero/one defaults
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    return _with_head(tm.state_dict(), "heads.head", 32)


def _gem(fmap: np.ndarray) -> np.ndarray:
    d = (np.maximum(fmap, 1e-6) ** 3).mean(axis=(1, 2)) ** (1 / 3)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _images(size: int) -> np.ndarray:
    return np.random.default_rng(1).standard_normal(
        (2, size, size, 3)).astype(np.float32)


def _port_forward(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).float().numpy()


@pytest.mark.parametrize("name", ["resnet50", "vgg16"])
def test_cnn_descriptors_agree(name):
    sd, load_t, load_j, jax_model, size = {
        "resnet50": (_resnet_sd(), timport.load_torch_resnet,
                     jimport.load_torch_resnet, jax_resnet50, 64),
        "vgg16": (_vgg_sd(), timport.load_torch_vgg, jimport.load_torch_vgg,
                  jax_vgg16, 32)}[name]
    x = _images(size)
    want = np.asarray(jax_model(jnp.float32).apply(load_j(sd),
                                                   jnp.asarray(x)))
    model, _ = get_backbone(name, dtype=torch.float32, device="cpu")
    imported = load_t(sd)
    assert not any(k.startswith(("fc.", "classifier.")) or
                   k.endswith("num_batches_tracked") for k in imported)
    timport.load_state_dict_checked(model, imported)
    got = _port_forward(model, x)
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    np.testing.assert_allclose(_gem(got), _gem(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("old_names", [False, True])
def test_vit_descriptors_agree(old_names):
    sd = _vit_sd()
    if old_names:     # older torchvision exports: mlp.linear_{1,2}
        sd = {k.replace("mlp.0.", "mlp.linear_1.")
              .replace("mlp.3.", "mlp.linear_2."): v for k, v in sd.items()}
    x = _images(16)
    jm = JaxViT(dtype=jnp.float32, attention="xla", **TINY)
    want = np.asarray(jm.apply(jimport.load_torch_vit(sd), jnp.asarray(x)))
    model = ViT(dtype=torch.float32, attention="xla", device="cpu", **TINY)
    timport.load_state_dict_checked(model, timport.load_torch_vit(sd))
    got = _port_forward(model, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(_gem(got), _gem(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("load,sd", [
    (timport.load_torch_resnet, {"conv1.weight": torch.zeros(1),
                                 "mystery.weight": torch.zeros(1)}),
    (timport.load_torch_vgg, {"features.0.weight": torch.zeros(1),
                              "avgpool.weight": torch.zeros(1)}),
    (timport.load_torch_vit, {"class_token": torch.zeros(1),
                              "encoder.layers.encoder_layer_0.extra.weight":
                                  torch.zeros(1)}),
])
def test_unknown_keys_refused(load, sd):
    with pytest.raises(ValueError, match="unhandled torch key"):
        load(sd)


def test_validate_variables_refuses_a_misfit():
    model, _ = get_backbone("vgg16", dtype=torch.float32, device="meta")
    sd = timport.load_torch_vgg(_vgg_sd())
    timport.validate_variables(model, sd)
    short = {k: v for k, v in sd.items() if not k.startswith("features.28")}
    with pytest.raises(ValueError, match="missing"):
        timport.validate_variables(model, short)
    bad = dict(sd, **{"features.0.bias": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape_mismatch"):
        timport.validate_variables(model, bad)
