"""The plain versions of K5 and K6 (``instsearch_torch.kernels.vit_attention``)
against the JAX kernels run in interpret mode, on the same seeded inputs;
the wrappers' routing and refusals on the CPU; and ``check_attention``, the
rule the kernels are held to on the card, against planted faults.

Tolerances: ``check_attention``'s. f32: 1e-5, as JAX's own kernel tests hold
its kernels to its oracle; both sides compute f32 logits from the same f32
inputs and differ only in summation order. bf16: q, k and v are the same
bf16 values and both sides keep f32 logits and f32 sums, so only the
roundings differ: p rounded to bf16 may land on the neighbouring bf16 value
where the two f32 sums came out one f32 step apart, and the output rounds
to bf16. Each element within 2^-7 of itself plus 2^-6 of the output's rms,
the whole within 1e-3 in norm (``check_attention`` says why). v = ones
gives ones within 1e-6 in f32: the rows of p sum to one over the valid
keys, and a padded key attending would pull the output below by about 1/N.
"""
import inspect
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.kernels.vit_attention import flash_mha as jax_flash_mha
from instsearch_tpu.kernels.vit_attention import mha as jax_mha
from instsearch_torch.kernels.vit_attention import (BF16_REL_TOL,
                                                    FLASH_KV_BLOCK,
                                                    attention_error,
                                                    check_attention,
                                                    flash_mha,
                                                    flash_mha_reference, mha,
                                                    mha_reference)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import planted_faults  # noqa: E402


def _qkv(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    jax_in = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    torch_in = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jax_in, torch_in


def _close(got, want, dtype):
    check_attention(got, torch.from_numpy(np.array(want, np.float32)).to(
        got.dtype))


@pytest.mark.parametrize("dtype,n", [("float32", 197), ("float32", 128),
                                     ("float32", 5), ("bfloat16", 197)])
def test_mha_reference_matches_jax_kernel(dtype, n):
    (jq, jk, jv), (q, k, v) = _qkv(n, (2, 3, n, 64), dtype)
    want = jax_mha(jq, jk, jv, interpret=True)
    got = mha_reference(q, k, v)
    assert got.shape == (2, 3, n, 64) and got.dtype == q.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype,n", [("float32", 197), ("float32", 300),
                                     ("float32", 1025), ("bfloat16", 1025)])
def test_flash_reference_matches_jax_kernel(dtype, n):
    (jq, jk, jv), (q, k, v) = _qkv(n + 1, (2, 3, n, 64), dtype)
    want = jax_flash_mha(jq, jk, jv, interpret=True)      # kv_block 128
    got = flash_mha_reference(q, k, v)
    assert got.shape == (2, 3, n, 64) and got.dtype == q.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("n", [300, 1025, 2049])
def test_flash_default_tiles_match_jax_defaults(n):
    """F5: in bf16 the key tiles are part of K5's result (p is rounded
    before it is normalised, against a running max that depends on where
    the tiles split), so the port's served route, ``flash_mha`` at its
    defaults, must answer as the JAX ``flash_mha`` at its defaults. With
    64-key tiles it read 1.2e-3 to 1.5e-3 in norm here, past
    ``BF16_REL_TOL``."""
    (jq, jk, jv), (q, k, v) = _qkv(n + 11, (1, 2, n, 64), "bfloat16")
    want = jax_flash_mha(jq, jk, jv, interpret=True)
    got = flash_mha(q, k, v)
    assert got.shape == (1, 2, n, 64) and got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


def test_flash_tile_is_the_reference_kv_block():
    ref = inspect.signature(jax_flash_mha).parameters["kv_block"].default
    assert FLASH_KV_BLOCK == ref == 128


def test_flash_reference_tiles_differ_only_by_rounding():
    """In f32 the tiling changes only summation order: the 64-key tiles of
    the f32 kernel, the default 128 and one whole tile all give the
    one-pass result."""
    _, (q, k, v) = _qkv(3, (1, 2, 300, 64), "float32")
    want = mha_reference(q, k, v)
    for kb in (64, 128, 300):
        torch.testing.assert_close(flash_mha_reference(q, k, v, kv_block=kb),
                                   want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn", [mha_reference, flash_mha_reference])
def test_padded_keys_never_attend(fn):
    _, (q, k, _) = _qkv(4, (1, 2, 197, 64), "float32")
    ones = torch.ones_like(q)
    np.testing.assert_allclose(fn(q, k, ones).numpy(), 1.0, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("fn", [mha, flash_mha, mha_reference,
                                flash_mha_reference])
def test_shape_mismatch_rejected(fn):
    _, (q, k, v) = _qkv(5, (1, 1, 8, 64), "float32")
    with pytest.raises(ValueError, match="shapes differ"):
        fn(q, k[:, :, :4], v)


@pytest.mark.parametrize("fn,ref", [(mha, mha_reference),
                                    (flash_mha, flash_mha_reference)])
def test_cpu_tensor_takes_the_plain_version(fn, ref):
    _, (q, k, v) = _qkv(6, (1, 2, 40, 64), "bfloat16")
    fn.launches = 0
    assert torch.equal(fn(q, k, v), ref(q, k, v))
    assert fn.launches == 0


@pytest.mark.parametrize("fn", [mha, flash_mha])
@pytest.mark.parametrize("shape,dtype,match", [
    ((1, 2, 40, 32), torch.float32, "head dim 32"),
    ((1, 2, 40, 64), torch.float16, "bfloat16 or all float32"),
    ((1, 2, 40, 64), torch.float32, "one CUDA device"),
])
def test_kernel_route_refuses_what_it_cannot_take(fn, shape, dtype, match):
    """A tensor off the CPU goes to the kernel or raises; checked with
    ``meta`` tensors, which are not on the CPU and hold no data."""
    q, k, v = (torch.empty(shape, dtype=dtype, device="meta")
               for _ in range(3))
    fn.launches = 0
    with pytest.raises(ValueError, match=match):
        fn(q, k, v)
    assert fn.launches == 0


@pytest.mark.parametrize("flash,n", [(False, 197), (True, 300),
                                     (True, 1025)])
def test_check_attention_rejects_planted_faults(flash, n):
    """The bar lets the plain version and rare one-step flips of the output
    through, and rejects what a faulty kernel would give: a key tile
    skipped, or logits rounded to bf16."""
    _, (q, k, v) = _qkv(n + 7, (1, 2, n, 64), "bfloat16")
    want = (flash_mha_reference if flash else mha_reference)(q, k, v)
    assert check_attention(want, want)["max_abs_err"] == 0
    flip = want.clone()
    bits = flip.view(torch.int16).view(-1)
    bits[::997] += 1               # 0.1% of the elements one bf16 step out
    assert attention_error(flip, want)["max_abs_err"] > 0
    check_attention(flip, want)
    for name, bad in planted_faults(q, k, v, flash).items():
        err = attention_error(bad, want)
        assert err["bar_ratio"] > 1 or err["rel_err"] > BF16_REL_TOL, name
        with pytest.raises(AssertionError):
            check_attention(bad, want)


def _two_pass_mha(q, k, v, tile=64):
    """K6's bf16 kernel's arithmetic, step for step, in torch: logits in
    base-2 units, t = q·k times the f32 product 1/sqrt(hd) · log2(e); pass A
    keeps each row's max m2 and sum l online over key tiles of ``tile`` (l =
    l 2^(m2 - m2_new) + sum 2^(t - m2_new), the finite -1e30 before the
    first tile); pass B recomputes each tile's logits, forms p = 2^(t - m2)
    (1 / l) in f32, rounds p to bf16 and sums p·v in f32; the output is
    rounded once."""
    scale2 = torch.tensor(1.0 / np.sqrt(q.shape[-1]), dtype=torch.float32) \
        * torch.tensor(np.log2(np.e), dtype=torch.float32)
    qf = q.float()
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    tiles = range(0, q.shape[2], tile)

    def logits(c0):
        return qf @ k[:, :, c0:c0 + tile].float().transpose(-1, -2) * scale2

    for c0 in tiles:
        t = logits(c0)
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        l = l * torch.exp2(m - m_new) + torch.exp2(t - m_new).sum(
            -1, keepdim=True)
        m = m_new
    acc = torch.zeros(q.shape)
    for c0 in tiles:
        p = (torch.exp2(logits(c0) - m) * (1 / l)).to(v.dtype).float()
        acc = acc + p @ v[:, :, c0:c0 + tile].float()
    return acc.to(q.dtype)


@pytest.mark.parametrize("n", [197, 1025])
def test_two_pass_arithmetic_passes_check_attention(n):
    """The bf16 K6 normalises p from a sum taken online over key tiles in a
    first pass, not from the whole row at once, with exp2 of base-2 logits
    and a reciprocal in place of exp and a quotient: its emulation lies within
    ``check_attention``'s bar of the plain version (and of the JAX kernel),
    while the planted faults still fail that bar."""
    (jq, jk, jv), (q, k, v) = _qkv(n + 1, (2, 3, n, 64), "bfloat16")
    want = mha_reference(q, k, v)
    got = _two_pass_mha(q, k, v)
    err = check_attention(got, want)
    assert err["rel_err"] < BF16_REL_TOL / 4
    _close(got, jax_mha(jq, jk, jv, interpret=True), "bfloat16")
    for name, bad in planted_faults(q, k, v, flash=False).items():
        with pytest.raises(AssertionError):
            check_attention(bad, want)


@pytest.mark.parametrize("n", [197, 1025])
def test_exp2_form_moves_p_by_at_most_one_bf16_step(n):
    """K6 evaluates p = exp(s - m) / l as 2^(t - m2) · (1 / l), with t the
    logits in base-2 units: the same function in another f32 order. Over
    whole rows the two forms' p, rounded to bf16, differ by at most one bf16
    step, and in under 1e-4 of the entries (about 2e-5 at these sizes)."""
    _, (q, k, _) = _qkv(n + 1, (2, 3, n, 64), "bfloat16")
    dot = q.float() @ k.float().transpose(-1, -2)
    inv = torch.tensor(1.0 / np.sqrt(q.shape[-1]), dtype=torch.float32)
    e = torch.exp(dot * inv - (dot * inv).amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(torch.bfloat16)
    t = dot * (inv * torch.tensor(np.log2(np.e), dtype=torch.float32))
    e2 = torch.exp2(t - t.amax(-1, keepdim=True))
    p2 = (e2 * (1 / e2.sum(-1, keepdim=True))).to(torch.bfloat16)
    steps = (p.view(torch.int16).int() - p2.view(torch.int16).int()).abs()
    assert int(steps.max()) <= 1
    assert float((steps > 0).float().mean()) < 1e-4


def _flash_forms(q, k, v, tile=FLASH_KV_BLOCK):
    """K5's online softmax over key tiles of ``tile`` keys in two forms, side
    by side: the plain version's (s = q·k / sqrt(hd), p = exp(s - m)) and the
    bf16 kernel's base-2 one (m2 the running max of q·k · scale2, scale2 =
    f32(1/sqrt(hd)) · f32(log2(e)), p = 2^(q·k · scale2 - m2) with the FFMA's
    single rounding, emulated in f64). Returns each tile's p of both forms
    rounded to bf16, and the base-2 form's output: l summed from the
    unrounded p, p rounded to bf16 before p·v, acc / l at the end."""
    scale = torch.tensor(1.0 / np.sqrt(q.shape[-1]), dtype=torch.float32)
    scale2 = scale * torch.tensor(np.log2(np.e), dtype=torch.float32)
    qf = q.float()
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    m2 = m.clone()
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    tiles = []
    for c0 in range(0, q.shape[2], tile):
        dot = qf @ k[:, :, c0:c0 + tile].float().transpose(-1, -2)
        s = dot * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        m = m_new
        m2_new = torch.maximum(m2, dot.amax(-1, keepdim=True) * scale2)
        t = (dot.double() * scale2.double() - m2_new.double()).float()
        p2 = torch.exp2(t)
        corr = torch.exp2(m2 - m2_new)
        l = corr * l + p2.sum(-1, keepdim=True)
        acc = corr * acc + p2.to(v.dtype).float() @ v[
            :, :, c0:c0 + tile].float()
        m2 = m2_new
        tiles.append((p.to(v.dtype), p2.to(v.dtype)))
    return tiles, (acc / l).to(q.dtype)


@pytest.mark.parametrize("n", [300, 1025])
def test_flash_exp2_form_moves_p_by_at_most_one_bf16_step(n):
    """The bf16 K5 evaluates p = exp(s - m) as 2^(q·k · scale2 - m2), m2 the
    running max in base-2 units: the same function in another f32 order.
    Tile by tile, with each form's own running max, the two forms' p rounded
    to bf16 differ by at most one bf16 step, and in under 1e-4 of the
    entries."""
    _, (q, k, v) = _qkv(n + 3, (2, 3, n, 64), "bfloat16")
    tiles, _ = _flash_forms(q, k, v)
    steps = torch.cat([(p.view(torch.int16).int()
                        - p2.view(torch.int16).int()).abs().flatten()
                       for p, p2 in tiles])
    assert int(steps.max()) <= 1
    assert float((steps > 0).float().mean()) < 1e-4


@pytest.mark.parametrize("n", [300, 1025])
def test_flash_base2_arithmetic_passes_check_attention(n):
    """The bf16 K5's arithmetic step for step (base-2 units, p rounded before
    it is normalised, tile by tile) lies within ``check_attention``'s bar of
    the plain version and of the JAX kernel at its defaults, while the
    planted faults still fail that bar."""
    (jq, jk, jv), (q, k, v) = _qkv(n + 5, (2, 3, n, 64), "bfloat16")
    want = flash_mha_reference(q, k, v)
    _, got = _flash_forms(q, k, v)
    err = check_attention(got, want)
    assert err["rel_err"] < BF16_REL_TOL / 4
    _close(got, jax_flash_mha(jq, jk, jv, interpret=True), "bfloat16")
    for name, bad in planted_faults(q, k, v, flash=True).items():
        with pytest.raises(AssertionError):
            check_attention(bad, want)
