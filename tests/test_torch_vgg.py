"""Port's VGG16 (instsearch_torch.models.vgg) against the Flax VGG fed the
same variables, the weight carry-over both ways, and the initializer.

Tolerances: in f32 the two forwards differ only by the convolution
algorithms' summation order, so max|diff| / max|ref| < 1e-4. In bf16 both
round activations at every layer, in different places (Flax adds the bias
in bf16 after rounding the product, PyTorch rounds once), so the bar is a
cosine of at least 0.999 per pooled (GeM and R-MAC) descriptor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.config import ExtractConfig
from instsearch_tpu.models import load_torch_vgg
from instsearch_tpu.models.vgg import VGG as JaxVGG
from instsearch_tpu.models.vgg import vgg16 as jax_vgg16
from instsearch_tpu.ops import pooling as jpool
from instsearch_torch.models import from_jax_vgg, get_backbone
from instsearch_torch.models.jax_import import load_jax_vgg
from instsearch_torch.models.vgg import VGG, VGG16_CFG
from instsearch_torch.ops import pooling as tpool

NARROW = (8, "M", 16, 16, "M", 24)


def _images(size: int, n: int = 2, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def variables():
    """Flax VGG16 variables at their own initializer, as numpy."""
    v = jax_vgg16(jnp.float32).init(jax.random.PRNGKey(0),
                                    np.zeros((1, 32, 32, 3), np.float32))
    return jax.tree_util.tree_map(np.asarray, v)


def _port(variables, dtype=torch.float32, cfg=VGG16_CFG) -> VGG:
    model = VGG(cfg, dtype=dtype, device="cpu")
    load_jax_vgg(model, variables)
    return model


@pytest.mark.parametrize("size", [64, 96])
def test_f32_forward_matches_flax(variables, size):
    x = _images(size)
    want = np.asarray(jax_vgg16(jnp.float32).apply(variables, x))
    with torch.no_grad():
        got = _port(variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, size // 16, size // 16, 512)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-4, err


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("pooling", ["gem", "rmac"])
def test_bf16_descriptors_match_flax(variables, size, pooling):
    x = _images(size, n=3, seed=1)
    cfg = ExtractConfig(pooling=pooling, gem_p=3.0, rmac_levels=3)
    fmap = jax_vgg16(jnp.bfloat16).apply(variables, x)
    want = np.asarray(jpool.l2_normalize(
        jpool.pool(fmap, cfg).astype(jnp.float32)))
    with torch.no_grad():
        out = _port(variables, torch.bfloat16)(torch.from_numpy(x))
        assert out.dtype == torch.bfloat16
        got = tpool.l2_normalize(tpool.pool(out, cfg).float()).numpy()
    cos = (got * want).sum(1)
    assert (cos >= 0.999).all(), cos


def test_narrow_cfg_matches_flax():
    """``cfg`` is a parameter: a narrow stack keeps torchvision's indices."""
    x = _images(40, n=2, seed=2)
    jm = JaxVGG(cfg=NARROW, dtype=jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), x))
    assert sorted(v["params"]) == ["conv0", "conv3", "conv5", "conv8"]
    model = _port(v, cfg=NARROW)
    assert model.feature_dim == 24
    assert sorted(k for k in model.state_dict() if k.endswith("weight")) == [
        "features.0.weight", "features.3.weight", "features.5.weight",
        "features.8.weight"]
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(v, x))
    assert got.shape == want.shape == (2, 10, 10, 24)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


@pytest.mark.parametrize("size,side", [(500, 31), (512, 32), (100, 6)])
def test_odd_sides_floor_like_flax(variables, size, side):
    """Each max-pool floors an odd side (500 -> 250 -> 125 -> 62 -> 31), as
    Flax's VALID pooling does; shapes on the meta device, no compute."""
    model, spec = get_backbone("vgg16", device="meta")
    out = model(torch.empty((1, size, size, 3), device="meta"))
    want = jax.eval_shape(lambda v, z: jax_vgg16().apply(v, z), variables,
                          jax.ShapeDtypeStruct((1, size, size, 3),
                                               jnp.float32))
    assert tuple(out.shape) == want.shape == (1, side, side, 512)
    assert (spec.feature_dim, spec.stride) == (512, 16)


def test_from_jax_vgg_round_trips_the_layout(variables):
    model, _ = get_backbone("vgg16", dtype=torch.float32, device="cpu")
    sd = from_jax_vgg(variables, model)
    assert set(sd) == set(model.state_dict())
    assert tuple(sd["features.0.weight"].shape) == (64, 3, 3, 3)  # OIHW
    assert tuple(sd["features.28.bias"].shape) == (512,)
    back = load_torch_vgg(sd)                  # the reference's importer
    flat = jax.tree_util.tree_leaves_with_path(variables)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(back_leaves) == 26
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(back_leaves[path]), leaf)


def test_from_jax_vgg_refuses_a_misfit(variables):
    model, _ = get_backbone("vgg16", dtype=torch.float32, device="cpu")
    params = variables["params"]
    missing = {"params": {k: v for k, v in params.items() if k != "conv28"}}
    extra = {"params": dict(params, conv30={"kernel": np.zeros(
        (3, 3, 512, 512), np.float32), "bias": np.zeros(512, np.float32)})}
    shape = {"params": dict(params, conv0={"kernel": np.zeros(
        (3, 3, 3, 32), np.float32), "bias": np.zeros(32, np.float32)})}
    for bad in (missing, extra, shape):
        with pytest.raises(ValueError, match="do not fit"):
            from_jax_vgg(bad, model)
    with pytest.raises(ValueError, match="unhandled"):
        from_jax_vgg({"params": dict(params, fc={"kernel": np.zeros(2)})})
    with pytest.raises(ValueError, match="collections"):
        from_jax_vgg(dict(variables, batch_stats={}))


def test_init_weights_follows_flax_distribution(variables):
    """lecun_normal kernels (truncated normal of variance 1/fan_in) and
    zero biases, by moments per layer: the std within 3% of Flax's sample
    (64 * 27 weights at least), the mean within 4 standard errors of 0, no
    weight past the truncation at two standard deviations."""
    model, _ = get_backbone("vgg16", dtype=torch.float32, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    for name, layer in variables["params"].items():
        idx = name[len("conv"):]
        w = sd[f"features.{idx}.weight"].numpy().ravel()
        ref = layer["kernel"].ravel()
        fan_in = 9 * layer["kernel"].shape[2]        # HWIO
        assert abs(w.std() / ref.std() - 1) < 0.03, name
        assert abs(w.std() - fan_in ** -0.5) < 0.03 * fan_in ** -0.5, name
        assert abs(w.mean()) < 4 * w.std() / np.sqrt(w.size), name
        assert np.abs(w).max() <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6, name
        assert not sd[f"features.{idx}.bias"].any()
        assert not layer["bias"].any()
