"""Port's ResNet (instsearch_torch.models) against the Flax ResNet fed the
same variables, and the weight carry-over both ways.

Tolerances: in f32 the two forwards differ only by the convolution
algorithms' summation order, so max|diff| / max|ref| < 1e-4. In bf16 both
round activations at every layer, in different places (XLA fuses, PyTorch
rounds per op), so the bar is cosine > 0.99 per pooled descriptor.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.models import load_torch_resnet
from instsearch_tpu.models.resnet import resnet18 as jax_resnet18
from instsearch_tpu.models.resnet import resnet50 as jax_resnet50
from instsearch_torch.models import from_jax_resnet, get_backbone
from instsearch_torch.models.jax_import import load_jax_resnet
from instsearch_torch.models.resnet import ResNet

from parity.torch_models import (BasicBlock, Bottleneck, TruncatedResNet,
                                 randomize_bn_stats)

_JAX = {"resnet18": jax_resnet18, "resnet50": jax_resnet50}
_TORCH_REF = {"resnet18": ((2, 2, 2, 2), BasicBlock),
              "resnet50": ((3, 4, 6, 3), Bottleneck)}


@pytest.fixture(scope="module")
def weights():
    """name -> (torchvision-layout state_dict, Flax variables)."""
    out = {}
    for name, (layers, block) in _TORCH_REF.items():
        torch.manual_seed(0)
        tm = randomize_bn_stats(TruncatedResNet(layers=layers, block=block))
        sd = tm.state_dict()
        out[name] = (sd, load_torch_resnet(sd))
    return out


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_from_jax_resnet_round_trip(weights, name):
    sd, variables = weights[name]
    model, _ = get_backbone(name, dtype=torch.float32, device="cpu")
    back = from_jax_resnet(variables, model)
    want = {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}
    assert set(back) == set(want)
    for k, v in want.items():
        assert torch.equal(back[k], v.float()), k


def test_from_jax_resnet_rejects_unknown_and_missing(weights):
    _, variables = weights["resnet18"]
    model, _ = get_backbone("resnet18", dtype=torch.float32, device="cpu")
    bad = {"params": dict(variables["params"],
                          mystery={"kernel": np.zeros((1, 1, 1, 1))}),
           "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError):
        from_jax_resnet(bad)
    short = {"params": {k: v for k, v in variables["params"].items()
                        if k != "layer4"},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError):
        from_jax_resnet(short, model)
    with pytest.raises(ValueError):
        from_jax_resnet(dict(variables, extra={}))


def _forwards(weights, name, dtype, size):
    _, variables = weights[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    jm = _JAX[name](dtype=getattr(jnp, dtype))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)), np.float32)
    model, _ = get_backbone(name, dtype=getattr(torch, dtype), device="cpu")
    load_jax_resnet(model, variables)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).float().numpy()
    return got, want


@pytest.mark.parametrize("name,size", [("resnet18", 64), ("resnet50", 32)])
def test_forward_matches_flax_f32(weights, name, size):
    got, want = _forwards(weights, name, "float32", size)
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


@pytest.mark.parametrize("name,size", [("resnet18", 64), ("resnet50", 32)])
def test_forward_matches_flax_bf16(weights, name, size):
    got, want = _forwards(weights, name, "bfloat16", size)
    assert got.shape == want.shape
    g, w = got.mean(axis=(1, 2)), want.mean(axis=(1, 2))
    cos = (g * w).sum(1) / (np.linalg.norm(g, axis=1)
                            * np.linalg.norm(w, axis=1))
    assert cos.min() > 0.99, cos


def test_random_init_matches_flax_scale():
    """Seeded random weights follow Flax's initializer distributions, so a
    random ResNet has the reference's activation scale."""
    from instsearch_tpu.models.resnet import resnet18 as jr18
    import jax
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    jm = jr18(dtype=jnp.float32)
    jv = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(jv, jnp.asarray(x)))
    model: ResNet = get_backbone("resnet18", dtype=torch.float32,
                                 device="cpu")[0]
    model.init_weights(torch.Generator().manual_seed(0))
    w = model.conv1.weight.detach()
    std = np.sqrt(1.0 / (3 * 7 * 7))
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(float(w.std()) / std - 1.0) < 0.1
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert 0.5 < got.std() / want.std() < 2.0
