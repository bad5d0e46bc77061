"""The fused-ResNet inference path of the port
(``instsearch_torch.kernels.fused_resnet``) against the JAX package's
(``instsearch_tpu.kernels.fused_resnet``, K7 in interpret mode), on the same
seeded inputs; ``check_fused_blocks``, the rule K7 is held to on the card,
against planted faults; the wrapper's routing and refusals.

Tolerances:
  * ``fold_bn``: 1e-6 relative in f32, the same products in both (rsqrt
    may differ in its last bit).
  * K7's plain version against the interpret-mode kernel: the same rounding
    points, so only the order of f32 sums may move a bf16 value by one step;
    held by ``check_fused_blocks`` (each element within 2^-7 (|want| + 4
    rms(want)), the whole within 1e-3 in norm). At these sizes the two
    agree bit for bit.
  * ``fused_resnet_apply`` on a (2, 2, 2, 2) Bottleneck ResNet at 64 px
    with randomized BN, Flax variables carried by ``from_jax_resnet``: the
    port on the CPU runs the reference's arithmetic (f32 conv sums of bf16
    operands, the same roundings), so only the order of f32 sums differs,
    but 16 blocks carry each one-step flip on into the next: each route
    must stay within 1e-2 of JAX's in norm over the whole feature map and
    2^-6 (|want| + 4 rms) per element, twice the card rule's element bar;
    the port's fused route against its own module forward (bf16 through
    unfolded BN): GeM cosine above 0.999 per image, the reference's bar
    between its fused path and the Flax forward. On the card the lax
    route's convs return cuDNN's bf16 sums, one rounding more; that route is
    held to the module by the same cosine there (``chip_smoke.py`` phase 6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_tpu.kernels.fused_resnet as jax_fused
from instsearch_tpu.models.resnet import ResNet as JaxResNet
from instsearch_torch.kernels import (fused_identity_blocks,
                                      fused_identity_blocks_reference,
                                      fused_resnet_apply)
from instsearch_torch.kernels.fused_resnet import (
    BLOCK_FAULTS, REL_TOL, STAGE_SIZES, _stack_identity_weights,
    check_fused_blocks, fold_bn, fused_blocks_error, planted_block_fault,
    randomize_bn)
from instsearch_torch.models.jax_import import from_jax_resnet, load_jax_resnet
from instsearch_torch.models.resnet import Bottleneck, ResNet
from instsearch_torch.ops.pooling import gem_pool

BF16 = torch.bfloat16


def _bn(rng, n):
    return {"weight": rng.uniform(0.5, 1.5, n).astype(np.float32),
            "bias": rng.normal(0, 0.2, n).astype(np.float32),
            "running_mean": rng.normal(0, 0.3, n).astype(np.float32),
            "running_var": rng.uniform(0.5, 2.0, n).astype(np.float32)}


@pytest.mark.parametrize("shape", [(16, 8, 3, 3), (64, 32, 1, 1),
                                   (8, 3, 7, 7)])
def test_fold_bn_matches_jax(shape):
    """OIHW (port) and HWIO (reference) of the same kernel fold alike."""
    rng = np.random.default_rng(sum(shape))
    k = rng.standard_normal(shape).astype(np.float32)
    bn = _bn(rng, shape[0])
    kf, bf = fold_bn(torch.from_numpy(k),
                     {n: torch.from_numpy(v) for n, v in bn.items()})
    jk, jb = jax_fused.fold_bn(
        jnp.asarray(k.transpose(2, 3, 1, 0)),
        {"scale": jnp.asarray(bn["weight"]), "bias": jnp.asarray(bn["bias"])},
        {"mean": jnp.asarray(bn["running_mean"]),
         "var": jnp.asarray(bn["running_var"])})
    assert kf.dtype == torch.float32 and bf.dtype == torch.float32
    np.testing.assert_allclose(kf.numpy().transpose(2, 3, 1, 0),
                               np.asarray(jk), rtol=1e-6, atol=0)
    np.testing.assert_allclose(bf.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


def test_fold_bn_equals_conv_then_batchnorm():
    rng = np.random.default_rng(1)
    k = torch.from_numpy(rng.standard_normal((16, 8, 3, 3)).astype(
        np.float32))
    bn = {n: torch.from_numpy(v) for n, v in _bn(rng, 16).items()}
    x = torch.from_numpy(rng.standard_normal((2, 8, 6, 6)).astype(
        np.float32))
    want = torch.nn.functional.batch_norm(
        torch.nn.functional.conv2d(x, k, padding=1), bn["running_mean"],
        bn["running_var"], bn["weight"], bn["bias"], False, 0.0, 1e-5)
    kf, bf = fold_bn(k, bn)
    got = torch.nn.functional.conv2d(x, kf, padding=1) + bf.reshape(
        1, -1, 1, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _block_operands(seed, n, C, M, scale=0.2):
    """Seeded K7 operands, as the reference's kernel test draws them."""
    rng = np.random.default_rng(seed)
    shapes = ((n, C, M), (n, 1, M), (n, 9, M, M), (n, 1, M), (n, M, C),
              (n, 1, C))
    arrs = [(rng.standard_normal(s) * (scale if i % 2 == 0 else 0.1)
             ).astype(np.float32) for i, s in enumerate(shapes)]
    jax_ops = [jnp.asarray(a, jnp.bfloat16 if i % 2 == 0 else jnp.float32)
               for i, a in enumerate(arrs)]
    torch_ops = [torch.from_numpy(np.asarray(j, np.float32)).to(
        BF16 if i % 2 == 0 else torch.float32) for i, j in enumerate(jax_ops)]
    return rng, jax_ops, torch_ops


@pytest.mark.parametrize("hw,C,M,n", [((7, 9), 32, 8, 2), ((5, 5), 32, 8, 2),
                                      ((8, 8), 64, 16, 3)])
def test_plain_blocks_match_jax_kernel(hw, C, M, n):
    """Odd H, W exercise the borders; n > 1 the chaining."""
    H, W = hw
    rng, jops, tops = _block_operands(4 + C + n, n, C, M)
    x = jnp.asarray(rng.standard_normal((3, H * W, C)) * 0.5, jnp.bfloat16)
    want = jax_fused.fused_identity_blocks(x, *jops, H=H, W=W,
                                           interpret=True)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(BF16)
    got = fused_identity_blocks_reference(tx, *tops, H=H, W=W)
    assert got.shape == tx.shape and got.dtype == BF16
    check_fused_blocks(got, torch.from_numpy(np.asarray(
        want, np.float32)).to(BF16))


def test_cpu_tensor_takes_the_plain_version():
    _, _, tops = _block_operands(5, 2, 32, 8)
    x = torch.randn(2, 20, 32, generator=torch.Generator().manual_seed(0)
                    ).to(BF16)
    before = x.clone()
    fused_identity_blocks.launches = 0
    out = fused_identity_blocks(x, *tops, H=4, W=5)
    assert torch.equal(out, fused_identity_blocks_reference(x, *tops, H=4,
                                                            W=5))
    assert torch.equal(x, before)
    assert fused_identity_blocks.launches == 0


# ---------------------------------------------------------------------------
# check_fused_blocks and the planted faults, at ResNet-50's stage shapes
# ---------------------------------------------------------------------------

_STAGES = [(56, 256, 64), (28, 512, 128), (14, 1024, 256), (7, 2048, 512)]


def _stage_operands(H, C, M, n=1, seed=0):
    """A stage's identity blocks with Flax-distribution conv weights
    (std 1/sqrt(fan_in)) and randomized BN, folded and stacked as
    ``fused_resnet_apply`` does, and a post-ReLU activation."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for j in range(1, n + 1):
        blk = Bottleneck(C, M, dtype=torch.float32, device="cpu")
        for name, t in blk.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if t.dim() == 4:
                fan = t.shape[1] * t.shape[2] * t.shape[3]
                t = torch.randn(t.shape, generator=g) / fan ** 0.5
            elif name.endswith("running_var"):
                t = 0.5 + 1.5 * torch.rand(t.shape, generator=g)
            elif name.endswith("weight"):
                t = 0.5 + torch.rand(t.shape, generator=g)
            else:
                t = 0.2 * torch.randn(t.shape, generator=g)
            sd[f"layer.{j}.{name}"] = t
    ops = _stack_identity_weights(sd, "layer", [str(j) for j in
                                                range(1, n + 1)], "cpu")
    x = torch.relu(torch.randn(1, H * H, C, generator=g)).to(BF16)
    return x, ops


@pytest.mark.parametrize("H,C,M", _STAGES)
def test_check_fused_blocks_rejects_planted_faults(H, C, M):
    """On one block, as the card holds K7: the rule lets the plain version
    and rare one-step flips through, and rejects what a faulty kernel would
    give: a border tap reading the neighbouring row's pixel, a dropped
    corner tap, the tap sum rounded to bf16 tap by tap."""
    x, ops = _stage_operands(H, C, M)
    want = fused_identity_blocks_reference(x, *ops, H=H, W=H)
    assert check_fused_blocks(want, want)["max_abs_err"] == 0
    flip = want.clone()
    bits = flip.view(torch.int16).view(-1)
    bits[::997] += 1               # 0.1% of the elements one bf16 step out
    assert fused_blocks_error(flip, want)["max_abs_err"] > 0
    check_fused_blocks(flip, want)
    with pytest.raises(ValueError, match="unknown fault"):
        planted_block_fault("none", x, *ops, H, H)
    for fault in BLOCK_FAULTS:
        bad = planted_block_fault(fault, x, *ops, H, H)
        err = fused_blocks_error(bad, want)
        assert err["bar_ratio"] > 1 or err["rel_err"] > REL_TOL, fault
        with pytest.raises(AssertionError):
            check_fused_blocks(bad, want)


# ---------------------------------------------------------------------------
# The wrapper's refusals and tile plan
# ---------------------------------------------------------------------------

def _meta_operands(B=2, H=7, W=7, C=128, M=64, n=2, **dtypes):
    shapes = {"x": (B, H * W, C), "w1": (n, C, M), "b1": (n, 1, M),
              "w2": (n, 9, M, M), "b2": (n, 1, M), "w3": (n, M, C),
              "b3": (n, 1, C)}
    return [torch.empty(s, device="meta", dtype=dtypes.get(
        k, torch.float32 if k.startswith("b") else BF16))
        for k, s in shapes.items()]


@pytest.mark.parametrize("kwargs,HW,match", [
    ({"C": 96}, (7, 7), "multiples of 64"),
    ({"M": 48}, (7, 7), "multiples of 64"),
    ({"x": torch.float32}, (7, 7), "x is torch.float32"),
    ({"w2": torch.float16}, (7, 7), "w2 is torch.float16"),
    ({"b3": BF16}, (7, 7), "b3 is torch.bfloat16"),
    ({}, (7, 8), "H\\*W"),
    ({"B": 65536, "H": 1, "W": 1}, (1, 1), "65535"),
])
def test_kernel_route_refuses_what_it_cannot_take(kwargs, HW, match):
    """A tensor off the CPU goes to the kernel or raises, before any
    launch; ``meta`` tensors are not on the CPU and hold no data."""
    dtypes = {k: v for k, v in kwargs.items() if isinstance(v, torch.dtype)}
    dims = {k: v for k, v in kwargs.items() if not isinstance(v, torch.dtype)}
    ops = _meta_operands(**dims, **dtypes)
    fused_identity_blocks.launches = 0
    with pytest.raises(ValueError, match=match):
        fused_identity_blocks(*ops, H=HW[0], W=HW[1])
    assert fused_identity_blocks.launches == 0


def test_kernel_route_refuses_mismatched_shapes_and_layouts():
    x, w1, b1, w2, b2, w3, b3 = _meta_operands()
    with pytest.raises(ValueError, match="w3 is"):
        fused_identity_blocks(x, w1, b1, w2, b2, w3[:, :32], b3, H=7, W=7)
    with pytest.raises(ValueError, match="not contiguous"):
        fused_identity_blocks(x.transpose(0, 1).contiguous().transpose(0, 1),
                              w1, b1, w2, b2, w3, b3, H=7, W=7)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_identity_blocks(x, w1, b1, w2, b2, w3, b3, H=7, W=7)
    assert fused_identity_blocks.launches == 0


def test_randomize_bn_is_seeded_and_not_the_identity():
    """The BatchNorm that ``chip_smoke.py`` and the GPU tests fold: the same
    seed draws the same statistics, each within its range, and none is
    ``init_weights``' identity (scale 1, mean 0, var 1)."""
    def drawn(seed):
        model = ResNet((1, 1, 1, 1), Bottleneck, dtype=torch.float32,
                       device="cpu")
        randomize_bn(model, torch.Generator().manual_seed(seed))
        return model.state_dict()
    one, again, other = drawn(0), drawn(0), drawn(1)
    bn = [k for k in one if k.startswith("bn") or ".bn" in k
          or "downsample.1" in k]
    assert len(bn) > 40
    assert all(torch.equal(one[k], again[k]) for k in bn)
    ranges = {"bn1.weight": (0.5, 1.5), "bn1.running_var": (0.5, 2.0),
              "bn1.running_mean": (-2.0, 2.0), "bn1.bias": (-2.0, 2.0)}
    for key, (lo, hi) in ranges.items():
        v = one[key]
        assert ((v >= lo) & (v <= hi)).all(), key
        assert len(v.unique()) > 1 and not torch.equal(v, other[key]), key


# ---------------------------------------------------------------------------
# fused_resnet_apply against the reference's
# ---------------------------------------------------------------------------

def _randomize_bn(tree, rng, stats):
    """A copy of a Flax variable tree with every BatchNorm drawn anew
    (scale U(0.5, 1.5), bias N(0, 0.2), mean N(0, 0.3), var U(0.5, 2))."""
    out = {}
    for k, v in tree.items():
        if not hasattr(v, "items"):
            out[k] = v
        elif stats and "mean" in v:
            out[k] = {"mean": jnp.asarray(rng.normal(0, 0.3, v["mean"].shape),
                                          jnp.float32),
                      "var": jnp.asarray(rng.uniform(0.5, 2.0,
                                                     v["var"].shape),
                                         jnp.float32)}
        elif not stats and "scale" in v:
            out[k] = {"scale": jnp.asarray(
                rng.uniform(0.5, 1.5, v["scale"].shape), jnp.float32),
                "bias": jnp.asarray(rng.normal(0, 0.2, v["bias"].shape),
                                    jnp.float32)}
        else:
            out[k] = _randomize_bn(v, rng, stats)
    return out


@pytest.fixture(scope="module")
def small_resnet():
    """(Flax variables, port state_dict, input, JAX kernel-route output,
    JAX lax-route output) of a (2, 2, 2, 2) Bottleneck ResNet at 64 px; the
    interpret-mode apply takes tens of seconds, so it runs once."""
    model = JaxResNet(stage_sizes=(2, 2, 2, 2), dtype=jnp.bfloat16)
    variables = model.init(jax.random.PRNGKey(0),
                           np.zeros((1, 64, 64, 3), np.float32))
    rng = np.random.default_rng(1)
    variables = {"params": _randomize_bn(variables["params"], rng, False),
                 "batch_stats": _randomize_bn(variables["batch_stats"], rng,
                                              True)}
    x = (np.random.default_rng(2).random((2, 64, 64, 3), np.float32) * 2
         - 1)
    kern = np.asarray(jax_fused.fused_resnet_apply(
        variables, jnp.asarray(x), stage_sizes=(2, 2, 2, 2),
        fused_layers=(1, 2, 3, 4), interpret=True), np.float32)
    lax = np.asarray(jax_fused.fused_resnet_apply(
        variables, jnp.asarray(x), stage_sizes=(2, 2, 2, 2),
        use_kernel=False), np.float32)
    return variables, from_jax_resnet(variables), torch.from_numpy(x), \
        kern, lax


def _close_to_jax(got: torch.Tensor, want: np.ndarray) -> None:
    w = torch.from_numpy(want)
    g = got.float()
    assert g.shape == w.shape and got.dtype == BF16
    assert ((g - w).norm() / w.norm()).item() < 1e-2
    rms = w.square().mean().sqrt()
    assert ((g - w).abs() <= 2.0 ** -6 * (w.abs() + 4 * rms)).all()


def test_fused_apply_kernel_route_matches_jax(small_resnet):
    _, sd, x, kern, _ = small_resnet
    got = fused_resnet_apply(sd, x, stage_sizes=(2, 2, 2, 2),
                             fused_layers=(1, 2, 3, 4))
    _close_to_jax(got, kern)


def test_fused_apply_lax_route_matches_jax(small_resnet):
    _, sd, x, _, lax = small_resnet
    got = fused_resnet_apply(sd, x, stage_sizes=(2, 2, 2, 2),
                             use_kernel=False)
    _close_to_jax(got, lax)


@pytest.mark.parametrize("fused_layers,use_kernel", [
    ((1, 2, 3, 4), True), ((2,), True), ((), False)])
def test_fused_apply_matches_module_forward(small_resnet, fused_layers,
                                            use_kernel):
    variables, sd, x, _, _ = small_resnet
    model = ResNet((2, 2, 2, 2), Bottleneck, dtype=BF16, device="cpu")
    load_jax_resnet(model, variables)
    with torch.inference_mode():
        want = gem_pool(model(x).float())
    got = gem_pool(fused_resnet_apply(sd, x, stage_sizes=(2, 2, 2, 2),
                                      fused_layers=fused_layers,
                                      use_kernel=use_kernel).float())
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert cos.min().item() > 0.999, cos


def test_stage_sizes_match_the_reference():
    assert STAGE_SIZES == {k: tuple(v) for k, v in
                           jax_fused.STAGE_SIZES.items()}


@pytest.mark.parametrize("fused_layers", [(2,), (1, 2, 3, 4)])
def test_one_call_per_fused_stage(monkeypatch, fused_layers):
    """ResNet-50 at 32 px: the port calls K7 once per fused stage with all
    of the stage's identity blocks, the blocks the reference's calls at
    that stage take together (it splits a stage by its VMEM budget;
    ``max_group_bytes`` is accepted and ignored)."""
    calls = {"jax": [], "torch": []}

    def record(side):
        def fn(x, w1, *_, H, W, **__):
            calls[side].append((H * W, int(x.shape[-1]), int(w1.shape[0])))
            return x
        return fn

    import instsearch_torch.kernels.fused_resnet as port
    monkeypatch.setattr(jax_fused, "fused_identity_blocks", record("jax"))
    monkeypatch.setattr(port, "fused_identity_blocks", record("torch"))
    variables = JaxResNet(stage_sizes=STAGE_SIZES["resnet50"],
                          dtype=jnp.float32).init(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))
    x = np.zeros((1, 32, 32, 3), np.float32)
    jax_fused.fused_resnet_apply(variables, jnp.asarray(x),
                                 fused_layers=fused_layers)
    port.fused_resnet_apply(from_jax_resnet(variables), torch.from_numpy(x),
                            fused_layers=fused_layers, max_group_bytes=1)
    per_stage = {}
    for hw, c, n in calls["jax"]:
        per_stage[hw, c] = per_stage.get((hw, c), 0) + n
    assert calls["torch"] == [(hw, c, n) for (hw, c), n in per_stage.items()]
    assert len(calls["torch"]) == len(fused_layers)
    assert sum(n for *_, n in calls["torch"]) == \
        {(2,): 3, (1, 2, 3, 4): 12}[fused_layers]
