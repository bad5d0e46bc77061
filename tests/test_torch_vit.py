"""The port's ViT (instsearch_torch.models.vit) against the Flax ViT fed the
same variables (carried over by ``from_jax_vit``), on a tiny configuration:
hidden 32, 2 layers, 4 heads, MLP 64, patch 4, canonical image 16.

Tolerances. f32: 2e-5, the bar JAX's own tests hold its kernel routes to its
plain route (tests/kernels/test_vit_attention.py); the two frameworks differ
only in summation orders and in LayerNorm's variance formula. bf16: each
side rounds at its own points (a Flax Dense rounds its product to bf16 and
then adds the bias in bf16, where ``F.linear`` adds the bias before its one
rounding; JAX's erf GELU rounds between its steps, PyTorch's computes in f32
and rounds once; the port's kernel routes keep f32 logits where the
reference's plain route keeps bf16), so the output grids are compared by
cosine: grid-averaged descriptors > 0.9999 and every token's feature vector
> 0.9995. Measured: 0.99998 and 0.99993 on all three routes, about what
either side's bf16 keeps of its own f32 result (0.99993 per token).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.models.vit import ViT as JaxViT
from instsearch_torch.models import from_jax_vit, get_backbone
from instsearch_torch.models.jax_import import load_jax_vit
from instsearch_torch.models.vit import ViT, _resolve_attention

TINY = dict(hidden_dim=32, num_layers=2, num_heads=4, mlp_dim=64,
            patch_size=4, image_size=16)
ROUTES = ("xla", "pallas", "flash")


def tiny_variables(seed: int = 0) -> dict:
    """Flax's random init, every leaf then moved by seeded noise, so that the
    class token, biases and LayerNorm parameters are not their zero / one
    defaults and a wrongly carried leaf shows."""
    x = np.zeros((1, 16, 16, 3), np.float32)
    params = JaxViT(dtype=jnp.float32, **TINY).init(
        jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.default_rng(seed)
    return {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), params)}


@pytest.fixture(scope="module")
def variables():
    return tiny_variables()


def _jax_forward(variables, x, dtype="float32"):
    m = JaxViT(dtype=getattr(jnp, dtype), attention="xla", **TINY)
    return np.asarray(m.apply(variables, jnp.asarray(x)), np.float32)


def _port(variables, dtype="float32", attention="xla") -> ViT:
    m = ViT(dtype=getattr(torch, dtype), attention=attention, device="cpu",
            **TINY)
    load_jax_vit(m, variables)
    return m


def _port_forward(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).float().numpy()


def _images(size, seed=1, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("attention", ROUTES)
@pytest.mark.parametrize("size", [16, 24, 12, 18])
def test_forward_matches_flax_f32(variables, attention, size):
    """16: the canonical grid; 24 and 12: the position grid resized up and
    down; 18: VALID patchify drops the 2-pixel remainder."""
    x = _images(size)
    want = _jax_forward(variables, x)
    got = _port_forward(_port(variables, attention=attention), x)
    assert got.shape == want.shape == (2, size // 4, size // 4, 32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _cos(a, b, axis=-1):
    return (a * b).sum(axis) / (np.linalg.norm(a, axis=axis)
                                * np.linalg.norm(b, axis=axis))


@pytest.mark.parametrize("attention", ROUTES)
def test_forward_matches_flax_bf16(variables, attention):
    x = _images(24, seed=2)
    want = _jax_forward(variables, x, "bfloat16")
    got = _port_forward(_port(variables, "bfloat16", attention), x)
    assert got.shape == want.shape
    assert _cos(got.mean((1, 2)), want.mean((1, 2))).min() > 0.9999
    assert _cos(got, want).min() > 0.9995


def test_from_jax_vit_round_trip(variables):
    model = ViT(dtype=torch.float32, device="cpu", **TINY)
    sd = from_jax_vit(variables, model)
    assert set(sd) == set(model.state_dict())
    p = variables["params"]
    np.testing.assert_array_equal(sd["pos_embedding"].numpy(),
                                  p["pos_embedding"])
    np.testing.assert_array_equal(sd["encoder_layer_1.qkv.weight"].numpy(),
                                  p["encoder_layer_1"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["conv_proj.weight"].numpy(),
        p["conv_proj"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["ln.weight"].numpy(), p["ln"]["scale"])


def test_from_jax_vit_rejects_what_does_not_fit(variables):
    model = ViT(dtype=torch.float32, device="cpu", **TINY)
    p = variables["params"]
    missing = {"params": {k: v for k, v in p.items()
                          if k != "encoder_layer_1"}}
    with pytest.raises(ValueError, match="missing"):
        from_jax_vit(missing, model)
    extra = {"params": dict(p, mystery={"kernel": np.zeros((2, 2))})}
    with pytest.raises(ValueError, match="mystery"):
        from_jax_vit(extra, model)
    wrong = {"params": dict(p, pos_embedding=np.zeros((1, 37, 32)))}
    with pytest.raises(ValueError, match="shape_mismatch"):
        from_jax_vit(wrong, model)
    with pytest.raises(ValueError, match="collections"):
        from_jax_vit(dict(variables, batch_stats={}), model)


@pytest.mark.parametrize("name,dim", [("vit_b_16", 768), ("vit_l_16", 1024)])
def test_registry_output_shapes(name, dim):
    """Shapes only, on the ``meta`` device (no compute), as the reference's
    test uses ``eval_shape``."""
    model, spec = get_backbone(name, device="meta")
    assert (spec.feature_dim, spec.stride) == (dim, 16)
    out = model(torch.empty((2, 224, 224, 3), device="meta"))
    assert tuple(out.shape) == (2, 14, 14, dim)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("attention", ["auto", "xla", "pallas", "flash"])
def test_registry_passes_the_attention_route(attention):
    model, _ = get_backbone("vit_b_16", device="meta", attention=attention)
    assert model.encoder_layer_0.attention == _resolve_attention(attention)
    cnn, _ = get_backbone("resnet18", device="meta", attention=attention)
    assert cnn.feature_dim == 512


def test_unknown_attention_rejected():
    with pytest.raises(ValueError, match=r"auto\|xla\|pallas\|flash, got "
                                         r"'cuda'"):
        ViT(dtype=torch.float32, attention="cuda", device="cpu", **TINY)


def test_input_smaller_than_a_patch_rejected(variables):
    with pytest.raises(ValueError, match="smaller than patch size 4"):
        _port(variables)(torch.zeros((1, 3, 16, 3)))


def test_random_init_matches_flax_scale():
    """Seeded random weights follow Flax's initializer distributions, so a
    random ViT has the reference's activation scale."""
    x = _images(16, seed=3)
    jm = JaxViT(dtype=jnp.float32, **TINY)
    want = np.asarray(jm.apply(jm.init(jax.random.PRNGKey(0), x),
                               jnp.asarray(x)))
    model = ViT(dtype=torch.float32, device="cpu", **TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    w = model.encoder_layer_0.linear_1.weight.detach()
    std = np.sqrt(1.0 / 32)
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(float(w.std()) / std - 1.0) < 0.1
    assert abs(float(model.pos_embedding.detach().std()) / 0.02 - 1.0) < 0.2
    assert not model.class_token.any()
    assert not model.encoder_layer_0.qkv.bias.any()
    got = _port_forward(model, x)
    assert 0.5 < got.std() / want.std() < 2.0
