"""The port's CUDA kernels on the card. Every test here needs a CUDA device
and skips without one (the kernels have no CPU form); the CPU side of the
same semantics is held against the JAX kernels in test_torch_topk_matmul.py
and test_torch_topk_int.py.

This file imports no JAX, so it runs on a GPU machine without it; the
suite's conftest imports JAX, so run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances. K1 (``check_against_plain``): scores to 1e-5 absolute (unit
rows, f32 sums in two orders); the kernel's answer in its own (score desc,
position asc) order with no position twice; ids equal, except where the two
rows are not copies of each other and the plain version's own scores of
them differ by less than 1e-5 (a near-tie that the summation order may
flip). Copies of one row must come out lowest position first. K2 and K3
(``check_exact``): none; their sums are exact integers, so scores and ids
equal the plain version's bit for bit. K4 (``check_exact``): none; kernel
and plain version add the same bf16 table entries in one fixed order, and
build the table (``pq_table``: none, bit for bit) in one fixed order. The
query's quantization (``quantize_query``): none; the same f32 operations
in one order, IEEE division.
K5 and K6 against their plain versions (``check_attention``): f32 within
1e-5 (sums in other orders over at most 1,025 keys); bf16 each element
within one bf16 step of itself plus one at the output's rms (2^-7 of each),
and the whole within 1e-3 in norm, since only the rare element whose two f32
values straddle a rounding point may differ. With v = ones the output is ones within n * 2^-23 in f32
(the n rounded terms of a row of p sum to one over the valid keys, each
term and each addition off by at most 2^-24 of the running sum; a padded
key, whose staged v row is zero, would pull it below by about 1/n) and within
one bf16 step in bf16. K7 against its plain version
(``check_fused_blocks``): each element within 2^-7 (|plain| + 4
rms(plain)), the whole within 1e-3 in norm, one block at a time; three
planted faults (``planted_block_fault``) must fail that rule. The ANN
tiers (IVF, IVF-PQ) run plain PyTorch and launch none of K1-K4; at full
probe they are held to the exact routes by ``check_against_plain``, and the
ADC selection on the card to the same view's on the CPU (scores within
1e-5 of the largest, positions equal but at near-ties).

Products on both sides run in true f32: the ``gen`` fixture turns TF32 off
for matmuls and cuDNN and restores the flags after the test.
"""
import os
import sys

import numpy as np
import pytest
import torch

from instsearch_torch import (ExtractConfig, IndexConfig, PipelineConfig,
                              SearchConfig)
from instsearch_torch.extractor import Extractor
from instsearch_torch.index import Index, attach_regional_store
from instsearch_torch.kernels import (flash_mha, flash_mha_reference, mha,
                                      mha_reference, pq_topk,
                                      pq_topk_reference, topk_matmul,
                                      topk_matmul_int4,
                                      topk_matmul_int4_reference,
                                      topk_matmul_int8,
                                      topk_matmul_int8_reference,
                                      topk_matmul_reference)
from instsearch_torch.kernels.topk_matmul import (K_MAX, check_against_plain,
                                                  check_exact, quantize_query)
from instsearch_torch.kernels.pq_scan import _lut, pq_table
from instsearch_torch.kernels.fused_resnet import (
    _stack_identity_weights, check_fused_call, fused_identity_blocks,
    fused_resnet_apply, kernel_attrs, randomize_bn, tile_rows)
from instsearch_torch.kernels.vit_attention import check_attention
from instsearch_torch.models.resnet import Bottleneck, ResNet
from instsearch_torch.ops.pooling import gem_pool
from instsearch_torch.ops.pq import PQCodebook, default_m
from instsearch_torch.ops.quantize import quantize_rows, quantize_rows_int4
from instsearch_torch.ops.whitening import apply_whitening, fit_whitening
from instsearch_torch.search.rerank import rerank_from_candidates
from instsearch_torch.serve import ServeCore

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import empty_slice_case, quantizer_rows  # noqa: E402

TOL = 1e-5


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    for f, was in zip(flags, saved):
        f.allow_tf32 = was


def _unit(gen, n, d, dtype=torch.float32):
    x = torch.randn(n, d, generator=gen, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernel_matches_plain_version(gen, dtype):
    x = _unit(gen, 70_000, 512, dtype)
    q = _unit(gen, 9, 512)
    mask = (torch.rand(70_000, generator=gen, device="cuda") < 0.5
            ).to(torch.int8)
    dup = x[:1000].repeat(20, 1).contiguous()       # exact ties
    for xx, k, nv, m in ((x, 10, None, None), (x, 100, 69_000, mask),
                         (x, 1, 5, None), (x, 300, None, None),
                         (x, 16, 7, None), (dup, 50, None, None)):
        before = topk_matmul.launches
        s, i = topk_matmul(xx, q, k=k, num_valid=nv, mask=m)
        rs, ri = topk_matmul_reference(xx, q, k=k, num_valid=nv, mask=m)
        torch.cuda.synchronize()
        assert topk_matmul.launches == before + 1
        check_against_plain(xx, q, s, i, rs, ri, TOL)
        if nv is not None and nv < k:
            assert (i[:, nv:] == -1).all() and torch.isneginf(s[:, nv:]).all()
        if xx is dup:
            # each query's best base row has 20 copies: the first 20 slots
            # hold them all, lowest position first
            copies = torch.arange(20, device="cuda")
            assert (i[:, :20] // 1000 == copies).all()
            assert (i[:, :20] % 1000 == i[:, :1] % 1000).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("b", [1, 8, 13])
def test_empty_slices_after_full_lists(gen, kind, b):
    """F7: k = 200 over 1,024 padded rows with 56 valid (three of four
    slices empty), each call right after one over a full store whose
    blocks leave their top-k lists in shared memory: every answer equal to
    the plain version's (``chip_smoke.empty_slice_case``)."""
    for masked in (False, True):
        assert empty_slice_case(gen, kind, b, masked, reps=100) == 100


def _check_k1(x, q, k, num_valid=None, mask=None):
    """One K1 launch held to its plain version; returns the positions."""
    before = topk_matmul.launches
    s, i = topk_matmul(x, q, k=k, num_valid=num_valid, mask=mask)
    rs, ri = topk_matmul_reference(x, q, k=k, num_valid=num_valid, mask=mask)
    torch.cuda.synchronize()
    assert topk_matmul.launches == before + 1
    check_against_plain(x, q, s, i, rs, ri, TOL)
    if mask is not None:
        assert (mask[i[i >= 0].long()] > 0).all()
    return i


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 512, 2048])
@pytest.mark.parametrize("b", [1, 8, 16, 64, 128])
def test_bf16_kernel_matches_plain_version(gen, b, d):
    """The bf16 store on the tensor-core pass 1, for k up to K_MAX, with
    padding rows, a 50% mask and duplicated rows."""
    n = 40_000
    x = _unit(gen, n, d, torch.bfloat16)
    q = _unit(gen, b, d)
    for k in (1, 10, 100, 1024):
        _check_k1(x, q, k)
    _check_k1(x, q, 100, num_valid=n - 77)
    _check_k1(x, q, 10, num_valid=5)
    mask = (torch.rand(n, generator=gen, device="cuda") < 0.5
            ).to(torch.int8)
    _check_k1(x, q, 10, mask=mask)
    dup = x[:500].repeat(n // 500, 1).contiguous()     # exact ties
    i = _check_k1(dup, q, 100)
    # each query's best base row has 80 copies: the first 80 slots hold
    # them, lowest position first
    copies = torch.arange(80, device="cuda")
    assert (i[:, :80] // 500 == copies).all()
    assert (i[:, :80] % 500 == i[:, :1] % 500).all()


@pytest.mark.gpu
def test_whitened_index_of_32_images_serves_k_2000(gen):
    """Whitening fitted on 32 images keeps 31 dims (N - 1): the store pads to
    32 columns for K1, and a request for k = 2000, past K_MAX, takes the
    scoring oracle; both answer through ServeCore."""
    cfg = PipelineConfig(
        extract=ExtractConfig(backbone="resnet18", image_size=64,
                              dtype="bfloat16", whiten=True, whiten_dim=64),
        index=IndexConfig(dtype="bfloat16"), search=SearchConfig(k=10))
    ex = Extractor(cfg.extract.replace(whiten=False), seed=0, device="cuda")
    imgs = (torch.rand((32, 64, 64, 3), generator=gen, device="cuda") * 255
            ).to(torch.uint8).cpu().numpy()
    raw = ex(imgs)
    ex.whitening = fit_whitening(raw, dim=cfg.extract.whiten_dim)
    desc = apply_whitening(raw, ex.whitening)
    assert desc.shape == (32, 31)
    idx = Index.from_descriptors(desc, [f"im{j}" for j in range(32)], cfg,
                                 extractor=ex)
    assert idx.dim == 31 and idx.store_dim == 32
    core = ServeCore(idx)
    before = topk_matmul.launches
    top10 = core.run_queries([(imgs[:3], 10)])[0]["results"]
    assert topk_matmul.launches > before
    assert [r[0]["id"] for r in top10] == [0, 1, 2]
    before = topk_matmul.launches
    deep = core.run_queries([(imgs[:3], 2000)])[0]["results"]
    assert topk_matmul.launches == before
    assert [len(r) for r in deep] == [32, 32, 32]
    assert [r[0]["id"] for r in deep] == [0, 1, 2]
    for short, long in zip(top10, deep):
        assert [e["id"] for e in long[:10]] == [e["id"] for e in short]


@pytest.mark.gpu
def test_cuda_wrapper_raises_instead_of_falling_back(gen):
    x = _unit(gen, 4096, 64, torch.bfloat16)
    q = _unit(gen, 2, 64)
    before = topk_matmul.launches
    with pytest.raises(ValueError):
        topk_matmul(x.T.contiguous().T, q, k=10)      # not contiguous
    with pytest.raises(ValueError):
        topk_matmul(x, q.cpu(), k=10)                 # wrong device
    with pytest.raises(ValueError):
        topk_matmul(x, q, k=K_MAX + 1)
    with pytest.raises(ValueError):
        topk_matmul(x[:, :60].contiguous(), q[:, :60].contiguous(), k=10)
    with pytest.raises(ValueError):
        topk_matmul(x.to(torch.int8), q, k=10)
    assert topk_matmul.launches == before


@pytest.mark.gpu
def test_index_on_cuda_launches_the_kernel_and_agrees_with_cpu(gen):
    rows = _unit(gen, 5000, 128).cpu().numpy()
    names = [f"r{j}" for j in range(5000)]
    cfg = PipelineConfig(index=IndexConfig(dtype="bfloat16"))
    gpu = Index.from_descriptors(rows, names, cfg, device="cuda")
    cpu = Index.from_descriptors(rows, names, cfg, device="cpu")
    q = rows[np.arange(0, 5000, 250)]
    before = topk_matmul.launches
    gs, gi = gpu.search(q)
    assert topk_matmul.launches > before
    cs, ci = cpu.search(q)
    np.testing.assert_array_equal(gi[:, 0], np.arange(0, 5000, 250))
    np.testing.assert_allclose(gs, cs, rtol=0, atol=TOL)
    np.testing.assert_array_equal(gi, ci)


@pytest.mark.gpu
def test_rerank_on_cuda_matches_plain_candidates():
    """The re-rank composite on the card: K1 selects the top-100 (one
    launch), ``rerank_from_candidates`` re-scores them; against the same
    stage over K1's plain version's candidates, by the near-tie rule on the
    fused scores (TOL), and against the same index on the CPU. The
    region products are f32 einsums: TF32 must be off, as PyTorch leaves
    it, or the card's order would differ from the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    g = torch.Generator(device="cuda").manual_seed(0)
    n, r, d = 20_000, 6, 64
    rows = _unit(g, n, d).cpu().numpy()
    reg = torch.nn.functional.normalize(
        torch.randn(n, r, d, generator=g, device="cuda"), dim=-1)
    names = [f"r{j}" for j in range(n)]
    cfg = PipelineConfig(index=IndexConfig(dtype="bfloat16"),
                         search=SearchConfig(k=10, rerank_enabled=True,
                                             rerank_depth=100))
    gpu = Index.from_descriptors(rows, names, cfg, device="cuda")
    attach_regional_store(gpu, reg)
    cpu = Index.from_descriptors(rows, names, cfg, device="cpu")
    attach_regional_store(cpu, reg.cpu())
    pick = torch.arange(0, n, 997, device="cuda")
    q = torch.from_numpy(rows).cuda()[pick] + 0.02 * _unit(g, len(pick), d)
    qreg = reg[pick] + 0.02 * torch.randn(len(pick), r, d, generator=g,
                                          device="cuda")
    before = topk_matmul.launches
    gs, gi = gpu.search(q, query_regional=qreg)
    assert topk_matmul.launches == before + 1
    np.testing.assert_array_equal(gi[:, 0], pick.cpu().numpy())
    ps, pp = topk_matmul_reference(gpu.descriptors, q, k=100,
                                   num_valid=gpu.num_valid)
    ws, wi = rerank_from_candidates(gpu.regional, gpu.ids, ps, pp,
                                    qreg.float(), k=10)
    cs, ci = cpu.search(q.cpu(), query_regional=qreg.cpu())
    for want_s, want_i in ((ws.cpu().numpy(), wi.cpu().numpy()), (cs, ci)):
        np.testing.assert_allclose(gs, want_s, rtol=0, atol=TOL)
        for row in range(gi.shape[0]):
            fused = dict(zip(want_i[row].tolist(), want_s[row].tolist()))
            for slot, (a, b) in enumerate(zip(gi[row], want_i[row])):
                if a != b and slot < gi.shape[1] - 1:
                    # a near-tie of the fused scores may flip
                    assert a in fused and abs(fused[a] - fused[b]) < TOL


_INT = {"int8": (quantize_rows, topk_matmul_int8, topk_matmul_int8_reference),
        "int4": (quantize_rows_int4, topk_matmul_int4,
                 topk_matmul_int4_reference)}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_int_kernels_equal_plain_version(gen, kind):
    quant, fn, ref = _INT[kind]
    x = quant(_unit(gen, 70_000, 512))
    dup = quant(_unit(gen, 1000, 512).repeat(20, 1))      # exact ties
    q = _unit(gen, 9, 512)
    mask = (torch.rand(70_000, generator=gen, device="cuda") < 0.5
            ).to(torch.int8)
    for st, b, k, nv, m in ((x, 9, 10, None, None), (x, 9, 100, 69_000, mask),
                            (x, 1, 1, None, None), (x, 3, 16, 7, None),
                            (x, 9, 300, None, None), (dup, 9, 50, None, None)):
        qq = q[:b].contiguous()
        before = fn.launches
        s, i = fn(st.values, st.scales, qq, k=k, num_valid=nv, mask=m)
        rs, ri = ref(st.values, st.scales, qq, k=k, num_valid=nv, mask=m)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        check_exact(s, i, rs, ri)
        if m is not None:
            assert (m[i[i >= 0].long()] > 0).all()
        if nv is not None and nv < k:
            assert (i[:, nv:] == -1).all() and torch.isneginf(s[:, nv:]).all()
        if st is dup:
            copies = torch.arange(20, device="cuda")
            assert (i[:, :20] // 1000 == copies).all()
            assert (i[:, :20] % 1000 == i[:, :1] % 1000).all()
    # a ragged (65) and a full (128) query block of the tensor-core pass 1,
    # the register lists (k = 10) and the shared ones (k = 100), and an int4
    # row that half fills a 128-byte chunk (D = 128)
    for d in (128, 512):
        x = quant(_unit(gen, 30_000, d))
        for b in (65, 128):
            q = _unit(gen, b, d)
            for k in (10, 100):
                before = fn.launches
                s, i = fn(x.values, x.scales, q, k=k)
                rs, ri = ref(x.values, x.scales, q, k=k)
                torch.cuda.synchronize()
                assert fn.launches == before + 1
                check_exact(s, i, rs, ri)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 512, 2048])
def test_query_quantizer_equals_quantize_rows(gen, d):
    """The first kernel of K2/K3's launch sequence, on its own: values and
    scales bit for bit ``quantize_rows``', offsets 8 * the row's sum, on
    rows with ties at half a step, a zero row, signs at the maximum, bf16
    values and extreme scales (``chip_smoke.quantizer_rows``)."""
    for q in (quantizer_rows(gen, d), _unit(gen, 70, d)):
        before = quantize_query.launches
        v, s, off = quantize_query(q)
        qr = quantize_rows(q)
        torch.cuda.synchronize()
        assert quantize_query.launches == before + 1
        assert torch.equal(v, qr.values)
        assert torch.equal(s.view(torch.int32), qr.scales.view(torch.int32))
        assert torch.equal(off, 8 * qr.values.sum(1, dtype=torch.int32))
    # a half step rounds to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
    row = quantize_query(quantizer_rows(gen, d))[0][1, :8].tolist()
    assert row == [127, 0, 2, 2, 0, -2, 126, -126]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_int_kernels_refuse_a_width_they_cannot_take(gen, kind):
    quant, fn, _ = _INT[kind]
    d = 40 if kind == "int8" else 48                 # not a 16-byte row
    x = quant(_unit(gen, 4096, d))
    before = fn.launches
    with pytest.raises(ValueError, match=f"D={d}"):
        fn(x.values, x.scales, _unit(gen, 2, d), k=10)
    with pytest.raises(ValueError):
        fn(x.values, x.scales, _unit(gen, 2, d).cpu(), k=10)
    assert fn.launches == before


def _pq_codes(gen, n, m):
    return torch.randint(-128, 128, (n, m // 2), generator=gen,
                         device="cuda", dtype=torch.int8)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [16, 64])
def test_pq_kernel_equals_plain_version(gen, m):
    d = 8 * m
    cb = PQCodebook(torch.randn(m, 16, 8, generator=gen, device="cuda"))
    codes = _pq_codes(gen, 70_000, m)
    dup = codes[:1000].repeat(20, 1).contiguous()           # exact ties
    q = _unit(gen, 9, d)
    mask = (torch.rand(70_000, generator=gen, device="cuda") < 0.5
            ).to(torch.int8)
    for x, b, k, nv, msk in ((codes, 9, 10, None, None),
                             (codes, 9, 100, 69_000, mask),
                             (codes, 1, 1, None, None), (codes, 3, 16, 7, None),
                             (codes, 9, 300, None, None),
                             (dup, 9, 50, None, None)):
        qq = q[:b].contiguous()
        before = pq_topk.launches
        s, i = pq_topk(x, qq, cb, k=k, num_valid=nv, mask=msk)
        rs, ri = pq_topk_reference(x, qq, cb, k=k, num_valid=nv, mask=msk)
        torch.cuda.synchronize()
        assert pq_topk.launches == before + 1
        check_exact(s, i, rs, ri)
        if msk is not None:
            assert (msk[i[i >= 0].long()] > 0).all()
        if nv is not None and nv < k:
            assert (i[:, nv:] == -1).all() and torch.isneginf(s[:, nv:]).all()
        if x is dup:
            copies = torch.arange(20, device="cuda")
            assert (i[:, :20] // 1000 == copies).all()
            assert (i[:, :20] % 1000 == i[:, :1] % 1000).all()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [96, 128, 512, 2048])
def test_pq_table_kernel_equals_plain_table(gen, d):
    """The table kernel of K4's launch sequence (``pq_table``) against the
    plain ``_lut`` on the same card, bit for bit, at the default M = D / 8
    (D = 96: M = 12, G padded to 8 bytes with zero rows)."""
    m = default_m(d)
    groups = -(-(m // 2) // 4) * 4
    cb = PQCodebook(0.25 * torch.randn(m, 16, d // m, generator=gen,
                                       device="cuda"))
    q = _unit(gen, 33, d)
    before = pq_table.launches
    got = pq_table(q, cb, groups)
    want = _lut(q, cb, groups)
    torch.cuda.synchronize()
    assert pq_table.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [9, 16, 33, 65, 128])
def test_pq_kernel_at_wide_query_blocks(gen, b):
    """K4 at the query blocks above 8 (ragged ones included) with k = 1,
    100 and K_MAX, a mask, fewer valid rows than k and exact ties."""
    cb = PQCodebook(torch.randn(64, 16, 8, generator=gen, device="cuda"))
    codes = _pq_codes(gen, 50_000, 64)
    dup = codes[:1000].repeat(20, 1).contiguous()           # exact ties
    q = _unit(gen, b, 512)
    mask = (torch.rand(50_000, generator=gen, device="cuda") < 0.5
            ).to(torch.int8)
    for x, k, nv, msk in ((codes, 1, None, None), (codes, 100, None, mask),
                          (codes, K_MAX, 49_000, None), (codes, 16, 7, None),
                          (dup, 50, None, None)):
        s, i = pq_topk(x, q, cb, k=k, num_valid=nv, mask=msk)
        rs, ri = pq_topk_reference(x, q, cb, k=k, num_valid=nv, mask=msk)
        torch.cuda.synchronize()
        check_exact(s, i, rs, ri)
        if msk is not None:
            assert (msk[i[i >= 0].long()] > 0).all()
        if nv is not None and nv < k:
            assert (i[:, nv:] == -1).all() and torch.isneginf(s[:, nv:]).all()
        if x is dup:
            copies = torch.arange(20, device="cuda")
            assert (i[:, :20] // 1000 == copies).all()
            assert (i[:, :20] % 1000 == i[:, :1] % 1000).all()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 12, 16])
@pytest.mark.parametrize("n", [1, 255, 769, 70_001])
def test_pq_kernel_takes_a_ragged_last_chunk(gen, m, n):
    """Row counts that are not a multiple of the 256-row chunk: the last
    chunk's bytes (n * G at G = 4, 8) are not a multiple of 16, which a
    bulk copy needs, so its tail is loaded another way. M = 12 is padded to
    G = 8 as PQView pads it; the answer equals the unpadded plain one."""
    cb = PQCodebook(torch.randn(m, 16, 8, generator=gen, device="cuda"))
    codes = _pq_codes(gen, n, m)
    pad = -(-(m // 2) // 4) * 4 - m // 2
    packed = torch.nn.functional.pad(codes, (0, pad)).contiguous()
    q = _unit(gen, 5, 8 * m)
    for k in (1, 10, 300):
        s, i = pq_topk(packed, q, cb, k=k, num_valid=n - n // 3)
        rs, ri = pq_topk_reference(codes, q, cb, k=k, num_valid=n - n // 3)
        torch.cuda.synchronize()
        check_exact(s, i, rs, ri)


@pytest.mark.gpu
def test_pq_kernel_refuses_what_it_cannot_take(gen):
    q = _unit(gen, 2, 32)
    before = pq_topk.launches
    for m in (2, 4, 12):                 # M/2 not a whole number of words
        cb = PQCodebook(torch.randn(m, 16, 32 // m if 32 % m == 0 else 1,
                                    generator=gen, device="cuda"))
        qq = _unit(gen, 2, cb.dim)
        with pytest.raises(ValueError, match=f"M={m}"):
            pq_topk(_pq_codes(gen, 4096, m), qq, cb, k=10)
    cb = PQCodebook(torch.randn(8, 16, 4, generator=gen, device="cuda"))
    codes = _pq_codes(gen, 4096, 8)
    with pytest.raises(ValueError):
        pq_topk(codes, q, cb, k=K_MAX + 1)                  # too deep
    with pytest.raises(ValueError):
        pq_topk(codes, q.cpu(), cb, k=10)                   # wrong device
    assert pq_topk.launches == before


def _qkv(gen, shape, dtype):
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [5, 197, 300, 1025])
def test_attention_kernels_match_plain_versions(gen, dtype, n):
    """``check_attention``'s bars (see there). v = ones must give ones: the
    rows of p sum to one over the valid keys, while a padded key attending
    would pull the output about 1/n below. In f32 the sum of n p's is off by
    up to n f32 steps (2^-23 each); in bf16 by one output step, 2^-7."""
    q, k, v = _qkv(gen, (2, 3, n, 64), dtype)
    for fn, ref in ((mha, mha_reference), (flash_mha, flash_mha_reference)):
        before = fn.launches
        out = fn(q, k, v)
        want = ref(q, k, v)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert out.shape == q.shape and out.dtype == dtype
        check_attention(out, want)
        ones = torch.ones_like(v)
        got = fn(q, k, ones).float()
        step = n * 2 ** -23 if dtype == torch.float32 else 2 ** -7
        assert (got - 1).abs().max().item() <= step, fn.__name__


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernels_read_the_qkv_projection_in_place(gen, dtype):
    """q, k, v as the model passes them, [B, h, N, hd] views of one packed
    [B, N, 3, h, hd] projection, give what their contiguous copies give, and
    o's memory is [B, N, h, hd], so merging the heads copies nothing."""
    qkv = torch.randn((2, 300, 3, 3, 64), generator=gen,
                      device="cuda").to(dtype)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    for fn, ref in ((mha, mha_reference), (flash_mha, flash_mha_reference)):
        out = fn(q, k, v)
        assert torch.equal(out, fn(q.contiguous(), k.contiguous(),
                                   v.contiguous()))
        check_attention(out, ref(q, k, v))
        merged = out.transpose(1, 2)
        assert merged.is_contiguous()
        assert merged.reshape(2, 300, 192).data_ptr() == out.data_ptr()


@pytest.mark.gpu
def test_attention_kernels_refuse_what_they_cannot_take(gen):
    q, k, v = _qkv(gen, (1, 2, 40, 32), torch.float32)
    before = (mha.launches, flash_mha.launches)
    for fn in (mha, flash_mha):
        with pytest.raises(ValueError, match="head dim 32"):
            fn(q, k, v)                                   # hd != 64
        q64, k64, v64 = _qkv(gen, (1, 2, 40, 64), torch.float32)
        with pytest.raises(ValueError):
            fn(q64, k64, v64.half())                      # mixed dtypes
        with pytest.raises(ValueError):
            fn(q64, k64, v64.cpu())                       # wrong device
        with pytest.raises(ValueError):
            fn(q64.transpose(1, 2).contiguous().transpose(1, 2), k64, v64)
        with pytest.raises(ValueError):
            fn(q64, k64[:, :, :20], v64)                  # shapes differ
    qf, kf, vf = _qkv(gen, (1, 1, 4000, 64), torch.float32)
    with pytest.raises(ValueError, match="off the served path"):
        mha(qf, kf, vf)                      # past the f32 K6's logit rows
    assert (mha.launches, flash_mha.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 127, 128, 129, 255, 257])
def test_bf16_flash_at_the_tile_edges(gen, n):
    """The bf16 K5 at the edges of its 128-row query blocks and 128-key
    tiles, where TMA zero-fills the rows past n and the kernel masks the
    keys past n by position, over B * h = 15 (B = 3, h = 5) on q, k, v views
    of a packed qkv projection: within ``check_attention`` of its plain
    version, v = ones gives ones, and o lies in [B, N, h, hd] memory."""
    qkv = torch.randn((3, n, 3, 5, 64), generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    before = flash_mha.launches
    out = flash_mha(q, k, v)
    want = flash_mha_reference(q, k, v)
    torch.cuda.synchronize()
    assert flash_mha.launches == before + 1
    check_attention(out, want)
    merged = out.transpose(1, 2)
    assert merged.is_contiguous()
    assert merged.reshape(3, n, 320).data_ptr() == out.data_ptr()
    qkv[:, :, 2] = 1                                  # v = ones
    ones = flash_mha(q, k, v).float()
    assert (ones - 1).abs().max().item() <= 2 ** -7


@pytest.mark.gpu
def test_bf16_flash_refuses_strides_tma_cannot_take(gen):
    """TMA reads rows whose strides are multiples of 16 bytes from a
    16-byte-aligned base; other operands raise ``ValueError`` in the wrapper
    before any launch, not a fault on the card."""
    before = flash_mha.launches
    x = torch.randn((2, 40, 3 * 2 * 64 + 4), generator=gen,
                    device="cuda").to(torch.bfloat16)
    row = x[..., :3 * 2 * 64].unflatten(-1, (3, 2, 64))     # 776-byte rows
    q, k, v = (t.transpose(1, 2) for t in row.unbind(2))
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_mha(q, k, v)
    flat = torch.randn(2 * 2 * 40 * 64 + 4, generator=gen,
                       device="cuda").to(torch.bfloat16)
    q = flat[4:].view(2, 2, 40, 64)                         # base 8 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_mha(q, q, q)
    torch.cuda.synchronize()
    assert flash_mha.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("n", [5, 197, 300, 1025, 4000])
def test_bf16_mha_takes_any_token_count(gen, n):
    """The bf16 K6 keeps nothing per key: from 5 tokens (one ragged key
    tile) to 4,000 (past the ~3,264 its one-pass plan held), on q, k, v
    views of a packed qkv projection, within ``check_attention`` of its
    plain version."""
    qkv = torch.randn((2, n, 3, 3, 64), generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    before = mha.launches
    out = mha(q, k, v)
    want = mha_reference(q, k, v)
    torch.cuda.synchronize()
    assert mha.launches == before + 1
    check_attention(out, want)
    qkv[:, :, 2] = 1                                  # v = ones
    ones = mha(q, k, v).float()
    assert (ones - 1).abs().max().item() <= 2 ** -7


def _seeded_net(gen, stage_sizes):
    """A Bottleneck ResNet on the card: Flax-distribution conv weights and
    randomized BN."""
    model = ResNet(stage_sizes, Bottleneck, device="cuda")
    model.init_weights(gen)
    randomize_bn(model, gen)
    return model


def _stage(gen, H, W, C, M, n, B=2):
    """n identity blocks of a seeded net's stage (C, M), folded and stacked
    as ``fused_resnet_apply`` does, and a post-ReLU activation [B, H*W, C]."""
    layer = {64: 1, 128: 2, 256: 3, 512: 4}[M]
    sizes = [1, 1, 1, 1]
    sizes[layer - 1] = n + 1
    model = _seeded_net(gen, sizes)
    ops = _stack_identity_weights(model.state_dict(), f"layer{layer}",
                                  [str(j) for j in range(1, n + 1)], "cuda")
    x = torch.relu(torch.randn((B, H * W, C), generator=gen,
                               device="cuda")).to(torch.bfloat16)
    return x, ops


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,C,M,n,B", [
    (56, 56, 256, 64, 2, 2), (28, 28, 512, 128, 3, 2),
    (14, 14, 1024, 256, 2, 2),
    (7, 7, 2048, 512, 1, 2),       # ResNet-50's stages at 224 px
    (23, 23, 256, 64, 2, 2),       # an uneven split: tiles of 8, 8, 7 rows
    (9, 13, 512, 128, 2, 2),       # H != W
    (3, 130, 256, 64, 1, 2),       # a row wider than a 128-row m-tile; conv1
                                   # two row groups (390 rows)
    (32, 32, 1024, 256, 2, 2),     # layer 3 at 512 px: tiles of 3 rows,
                                   # conv1 two sub-tiles, conv2-3 one
    (128, 128, 256, 64, 1, 2),     # layer 1 at 512 px: conv1's 384-512
                                   # rows a tile in two row groups
    (7, 7, 2048, 512, 2, 2),       # layer 4: 1,088 weight stages a block
                                   # (576 in conv2), the ring's phases
                                   # wrapping 272 times a launch
    (28, 28, 512, 128, 1, 64)])    # layer 2 at B = 64: 256 blocks, two
                                   # waves on 132 SMs
def test_fused_blocks_kernel_matches_plain_version(gen, H, W, C, M, n, B):
    """``check_fused_call``: one launch per block, the call equal to its
    blocks launched one at a time, each block within
    ``check_fused_blocks`` of the plain version, the three planted faults
    rejected on every block; the caller's x untouched."""
    x, ops = _stage(gen, H, W, C, M, n, B)
    keep = x.clone()
    out, errs, faults = check_fused_call(x, ops, H, W)
    torch.cuda.synchronize()
    assert torch.equal(x, keep)
    assert out.shape == x.shape and len(errs) == n
    assert all(len(v) == n for v in faults.values())


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,M,want", [
    (56, 56, 64, 4), (28, 28, 128, 7), (14, 14, 256, 7), (7, 7, 512, 7),
    (128, 128, 64, 2), (64, 64, 128, 4), (32, 32, 256, 3), (16, 16, 512, 3),
    (3, 130, 64, 1), (23, 23, 64, 8), (1, 4000, 512, 0)])
def test_fused_blocks_tile_plan(gen, H, W, M, want):
    """The kernel's own tile plan: ResNet-50's stages at 224 and 512 px, a
    row wider than the 256-pixel aim, an uneven split, and a row whose tile
    does not fit the shared memory (0: the wrapper refuses)."""
    assert tile_rows(H, W, M) == want


@pytest.mark.gpu
def test_fused_blocks_kernel_does_not_spill(gen):
    """The compiled K7 kernel keeps its registers: no local memory."""
    attrs = kernel_attrs()
    assert attrs["local_bytes"] == 0, attrs
    assert 0 < attrs["registers"] <= 255, attrs


@pytest.mark.gpu
def test_fused_blocks_kernel_refuses_what_it_cannot_take(gen):
    x, ops = _stage(gen, 7, 7, 2048, 512, 1)
    w1, b1, w2, b2, w3, b3 = ops
    before = fused_identity_blocks.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_identity_blocks(x, w1.cpu(), b1, w2, b2, w3, b3, H=7, W=7)
    with pytest.raises(ValueError, match="not contiguous"):
        fused_identity_blocks(x.transpose(0, 1).contiguous().transpose(0, 1),
                              *ops, H=7, W=7)
    with pytest.raises(ValueError, match="16-byte"):
        xs = torch.empty(x.numel() + 8, dtype=x.dtype, device="cuda")
        fused_identity_blocks(xs[1:x.numel() + 1].view(x.shape), *ops, H=7,
                              W=7)
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_identity_blocks(x[:, :, :96].contiguous(),
                              w1[:, :96].contiguous(), b1, w2, b2,
                              w3[:, :, :96].contiguous(),
                              b3[:, :, :96].contiguous(), H=7, W=7)
    wide = torch.zeros((1, 4000, 2048), dtype=x.dtype, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        fused_identity_blocks(wide, *ops, H=1, W=4000)
    assert fused_identity_blocks.launches == before


@pytest.mark.gpu
def test_fused_resnet_apply_on_the_card_matches_the_module(gen):
    """A (2, 2, 2, 2) Bottleneck ResNet at 96 px: the fused route (K7 on
    every stage, one launch per identity block) gives the module route's
    GeM descriptors within cosine 0.999 per image."""
    model = _seeded_net(gen, (2, 2, 2, 2))
    x = torch.rand((4, 96, 96, 3), generator=gen, device="cuda") * 2 - 1
    before = fused_identity_blocks.launches
    with torch.inference_mode():
        want = gem_pool(model(x).float())
        got = gem_pool(fused_resnet_apply(model.state_dict(), x,
                                          stage_sizes=(2, 2, 2, 2),
                                          fused_layers=(1, 2, 3, 4)).float())
    assert fused_identity_blocks.launches == before + 4
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert cos.min().item() > 0.999, cos


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_sharded_search_on_one_card(gen, dtype):
    """Eight shards on cuda:0 (views of the store) through K1/K2/K3: one
    launch per shard with valid rows (the last shard is all padding here),
    the merge equal to the single-device search: K1 by
    ``check_against_plain`` on the answers as positions (ids are positions
    in this store), K2/K3 bit for bit; with alpha-QE and the re-rank too."""
    from instsearch_torch.parallel import make_mesh
    kernel = {"bfloat16": topk_matmul, "int8": topk_matmul_int8,
              "int4": topk_matmul_int4}[dtype]
    n, d = 57_000, 512
    x = _unit(gen, n, d)
    cfg = PipelineConfig(index=IndexConfig(dtype=dtype, row_tile=1024,
                                           num_shards=8, capacity=65_536),
                         search=SearchConfig(k=10))
    idx = Index.from_descriptors(x, [str(i) for i in range(n)], cfg)
    attach_regional_store(idx, _unit(gen, n * 3, d).reshape(n, 3, d))
    sidx = idx.to_sharded(mesh=make_mesh(8, devices=["cuda"] * 8))
    assert sidx.use_pallas and [sh.num_valid for sh in sidx.shards][-2:] \
        == [57_000 - 6 * 8192, 0]
    q = x[:9] + 0.01 * _unit(gen, 9, d)
    qreg = _unit(gen, 27, d).reshape(9, 3, d)
    before = kernel.launches
    s, i = sidx.search(q)
    torch.cuda.synchronize()
    assert kernel.launches == before + 7
    ws, wi = idx.search(q)
    if dtype == "bfloat16":
        check_against_plain(idx.descriptors, q, s, i,
                            torch.from_numpy(ws).cuda(),
                            torch.from_numpy(wi).cuda(), TOL)
    else:
        check_exact(s, i, torch.from_numpy(ws).cuda(),
                    torch.from_numpy(wi).cuda())
    for got, want in (
            (sidx.search_qe(q, qe_n=10),
             idx.search(q, cfg.search.replace(qe_enabled=True))),
            (sidx.search_rerank(q, qreg, depth=100),
             idx.search(q, cfg.search.replace(rerank_enabled=True),
                        query_regional=qreg))):
        np.testing.assert_array_equal(got[1].cpu().numpy(), want[1])
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0], rtol=0,
                                   atol=0 if dtype != "bfloat16" else TOL)
    np.testing.assert_array_equal(sidx.full_ranking(q[:2]),
                                  idx.full_ranking(q[:2]))


@pytest.mark.gpu
@pytest.mark.parametrize("members", [5, 200], ids=["five", "0.1%"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4", "pq"])
def test_subset_search_through_the_kernels(gen, dtype, members,
                                           monkeypatch):
    """``Index.search(subset=)`` on the card with 5 members and with 0.1% of
    200,000 rows: the kernel of the store's kind (K4 through the PQ
    cascade) launches once with the mask, every id is a member, five members
    give five results and a ``(-inf, -1)`` tail, and the answer equals the
    same search through the kernel's plain version with the same mask (K1
    by ``check_against_plain``, K2-K4 bit for bit)."""
    import instsearch_torch.index as tindex
    import instsearch_torch.search.pq_view as tview
    n, d = 200_000, 512
    x = _unit(gen, n, d)
    cfg = PipelineConfig(index=IndexConfig(
        dtype="int4" if dtype == "pq" else dtype, row_tile=1024),
        search=SearchConfig(k=10))
    idx = Index.from_descriptors(x, [str(i) for i in range(n)], cfg)
    entry, kernel, plain = {
        "bfloat16": (tindex, topk_matmul, topk_matmul_reference),
        "int8": (tindex, topk_matmul_int8, topk_matmul_int8_reference),
        "int4": (tindex, topk_matmul_int4, topk_matmul_int4_reference),
        "pq": (tview, pq_topk, pq_topk_reference)}[dtype]
    if dtype == "pq":
        idx.build_pq(iters=3, sample=20_000, depth=100)
    allowed = torch.randperm(n, generator=gen, device="cuda")[:members]
    sub = idx.make_subset(ids=allowed.tolist())
    q = torch.cat([x[allowed[:3]] + 0.05 * _unit(gen, 3, d), x[:3]])
    before = (kernel.launches, kernel.launches_subset)
    s, i = idx.search(q, subset=sub)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.launches_subset) == (before[0] + 1,
                                                         before[1] + 1)
    assert set(i[i >= 0].tolist()) <= set(allowed.tolist())
    if members == 5:
        assert (i[:, 5:] == -1).all() and np.isneginf(s[:, 5:]).all()
        assert all(sorted(row[:5].tolist()) == sorted(allowed.tolist())
                   for row in i)
    monkeypatch.setattr(entry, kernel.__name__, plain)
    ps, pi = idx.search(q, subset=sub)
    if dtype == "bfloat16":
        check_against_plain(idx.descriptors, q, *(torch.from_numpy(a).cuda()
                                                  for a in (s, i, ps, pi)),
                            TOL)
    else:
        np.testing.assert_array_equal(i, pi)
        np.testing.assert_array_equal(s, ps)


@pytest.mark.gpu
def test_stale_filter_after_a_repadding_add_raises(gen):
    """An ``add`` past capacity re-pads the store: a filter of the old
    layout is refused before any launch (its mask would end inside the
    new store); a filter made again covers the new rows."""
    n, d = 4096, 512
    x = _unit(gen, n, d)
    idx = Index.from_descriptors(
        x, [str(i) for i in range(n)],
        PipelineConfig(index=IndexConfig(row_tile=1024)))
    sub = idx.make_subset(ids=list(range(0, n, 2)))
    idx.add(descriptors=_unit(gen, 8, d), names=[f"new{i}" for i in range(8)])
    assert idx.descriptors.shape[0] == 2 * n and sub.n_pad == n
    before = topk_matmul.launches
    with pytest.raises(ValueError, match="stale SubsetFilter"):
        idx.search(x[:2], subset=sub)
    assert topk_matmul.launches == before
    fresh = idx.make_subset(names=["new3", "0"])
    _, i = idx.search(x[:1], subset=fresh)
    assert sorted(i[0, :2].tolist()) == [0, n + 3] and (i[0, 2:] == -1).all()


# ---------------------------------------------------------------------------
# the quality tiers (αDBA, diffusion, local whitening, the kNN graph, EP)


def _quality_index(gen, dtype, n=20_000, d=256, rows=None, **search):
    """An index of ``rows`` (default: seeded unit rows around 16 centres)
    with the quality ladder's dba_n and depths."""
    cfg = PipelineConfig(
        index=IndexConfig(dtype=dtype, row_tile=1024, dba_n=10),
        search=SearchConfig(qe_enabled=True, diffusion_depth=200,
                            rerank_depth=100, **search))
    if rows is None:
        centres = _unit(gen, 16, d)
        rows = centres[torch.randint(0, 16, (n,), generator=gen,
                                     device="cuda")] + _unit(gen, n, d)
        rows = rows / rows.norm(dim=1, keepdim=True)
    return Index.from_descriptors(rows, [f"r{i}" for i in range(len(rows))],
                                  cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 128])
def test_k1_at_the_diffusion_depth(gen, b):
    x = _unit(gen, 65_536, 2048, torch.bfloat16)
    _check_k1(x, _unit(gen, b, 2048), 200, num_valid=65_000)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_augment_database_on_the_card(gen, dtype, monkeypatch):
    """αDBA through K1-K3 against the same pass through their plain
    versions: int8/int4 bit for bit, bf16 within one bf16 step but on rows
    whose 10th and 11th neighbours (the plain version's scores over the
    original store) are within TOL."""
    import instsearch_torch.index as tindex
    rows = _unit(gen, 20_000, 256)
    idx = _quality_index(gen, dtype, rows=rows)
    twin = _quality_index(gen, dtype, rows=rows)
    kernel = {"bfloat16": topk_matmul, "int8": topk_matmul_int8,
              "int4": topk_matmul_int4}[dtype]
    plain = {"bfloat16": topk_matmul_reference,
             "int8": topk_matmul_int8_reference,
             "int4": topk_matmul_int4_reference}[dtype]
    before = kernel.launches
    idx.augment_database()
    assert kernel.launches - before == -(-20_000 // 128)
    monkeypatch.setattr(tindex, kernel.__name__, plain)
    twin.augment_database()
    if dtype != "bfloat16":
        assert torch.equal(idx.descriptors, twin.descriptors)
        assert torch.equal(idx.scales, twin.scales)
        return
    orig = _quality_index(gen, dtype, rows=rows)
    n = orig.cfg.index.dba_n
    ties = torch.zeros(20_000, dtype=torch.bool, device="cuda")
    for s in range(0, 20_000, 1_000):
        sc, _ = plain(orig.descriptors, orig._query_rows(s, 1_000), k=n + 1,
                      num_valid=20_000)
        ties[s:s + 1_000] = (sc[:, n - 1] - sc[:, n]) < TOL
    a = idx._rows_f32_chunk(0, 20_000)
    b = twin._rows_f32_chunk(0, 20_000)
    bar = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7 + 1e-7
    beyond = ((a - b).abs() > bar).any(dim=1)
    assert not bool((beyond & ~ties).any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_diffusion_on_the_card_matches_the_cpu(gen, dtype):
    """The composite (αQE, K1/K2 at depth 200, diffusion) on the card and
    the same store copied to the CPU (the kernels' plain versions): ids
    equal but at near-ties, diffused scores within 1e-4 of the row's
    largest."""
    idx = _quality_index(gen, dtype, rows=_unit(gen, 20_000, 256),
                         diffusion_enabled=True)
    cpu = Index(idx.descriptors.cpu(), idx.ids.cpu(), idx.names, idx.cfg,
                scales=None if idx.scales is None else idx.scales.cpu(),
                dim=idx.dim)
    q = idx._rows_f32_chunk(0, 13).cpu().numpy()
    ks, ki = idx.search(q)
    ps, pi = cpu.search(q)
    tol = 1e-4 * max(1.0, float(np.abs(ps[np.isfinite(ps)]).max()))
    np.testing.assert_allclose(ks, ps, rtol=0, atol=tol)
    for r in range(13):
        f = dict(zip(pi[r].tolist(), ps[r].tolist()))
        for a, b in zip(ki[r].tolist(), pi[r].tolist()):
            assert a == b or (a in f and abs(f[a] - f[b]) < tol)
    assert (ki[:, 0] == np.arange(13)).all()


@pytest.mark.gpu
def test_local_whitening_on_the_card(gen):
    """The fit on the card (k-means, moments, the f64 eigh bank) routes as
    the CPU fit of the same rows; the lw search on the card with the CPU's
    view carried over equals the CPU's within 1e-5; the bank split over 4
    shards of cuda:0 (EP) equals the single-device whitening."""
    from instsearch_torch.ops.local_whiten import apply_local_whitening
    from instsearch_torch.parallel import expert_whiten_fn, make_mesh
    from instsearch_torch.search.lw_rerank import LocalWhiteningView
    idx = _quality_index(gen, "bfloat16", n=8_192, d=64)
    cpu = Index(idx.descriptors.cpu(), idx.ids.cpu(), idx.names, idx.cfg,
                dim=idx.dim)
    view = idx.fit_local_whitening(n_clusters=16)
    cview = cpu.fit_local_whitening(n_clusters=16)
    assert torch.equal(view.assign.cpu(), cview.assign)
    idx.lw = LocalWhiteningView(
        type(cview.params)(*(t.cuda() for t in cview.params)),
        cview.store.cuda(), cview.assign.cuda())
    q = cpu._rows_f32_chunk(0, 9).numpy()
    ks, ki = idx.search(q)
    ps, pi = cpu.search(q)
    np.testing.assert_allclose(ks, ps, rtol=0, atol=1e-5)
    assert (ki[:, 0] == np.arange(9)).all()
    x = idx._rows_f32_chunk(0, 2048)
    mesh = make_mesh(4, devices=["cuda"] * 4)
    ep = expert_whiten_fn(mesh)(idx.lw.params, x)
    assert torch.equal(ep, apply_local_whitening(x, idx.lw.params))


@pytest.mark.gpu
def test_knn_graph_and_duplicates_on_the_card(gen):
    idx = _quality_index(gen, "bfloat16", n=10_000, d=128)
    rows = idx._rows_f32_chunk(0, 10_000)
    dup = rows[:32] + 0.05 * _unit(gen, 32, 128)
    idx.add(descriptors=dup / dup.norm(dim=1, keepdim=True),
            names=[f"d{i}" for i in range(32)])
    s, i = idx.knn_graph(k=5)
    assert (i[:32, 0] == np.arange(10_000, 10_032)).all()
    assert (i != np.arange(idx.num_valid)[:, None]).all()
    pairs, _ = idx.find_duplicates(tau=0.97)
    assert {(j, 10_000 + j) for j in range(32)} <= set(map(tuple,
                                                           pairs.tolist()))


def _launches_of(fn):
    """``fn()`` with every kernel's count set to 0 -> (result, total
    launches of K1-K4)."""
    kernels = (topk_matmul, topk_matmul_int8, topk_matmul_int4, pq_topk)
    for k in kernels:
        k.launches = 0
    out = fn()
    return out, sum(k.launches for k in kernels)


def _ann_store(gen, dtype, n=20_000, d=128):
    rows = _unit(gen, n, d).cpu().numpy()
    cfg = PipelineConfig(index=IndexConfig(dtype=dtype, row_tile=256),
                         search=SearchConfig(k=10, qe_enabled=True))
    return rows, Index.from_descriptors(rows, [f"r{i}" for i in range(n)],
                                        cfg, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int4", "bfloat16"])
def test_ivfpq_on_the_card(gen, dtype):
    """build_ivfpq on the card: no K1-K4 launch on the cascade, every
    source row its query's top-1, and at full probe and full depth the
    exact top-k over the dequantized rows by check_against_plain."""
    rows, idx = _ann_store(gen, dtype)
    view = idx.build_ivfpq(n_clusters=64, m=16, depth=200)
    assert view.codes.device.type == "cuda" and view.codes.shape[2] == 8
    q = torch.as_tensor(rows[:64], device="cuda")
    (s, i), launches = _launches_of(lambda: idx.search(q))
    assert launches == 0
    assert (i[:, 0] == np.arange(64)).all()
    full = idx.cfg.search.replace(ivfpq_nprobe=64, qe_enabled=False)
    view.depth = idx.num_valid
    s, i = idx.search(q[:8], full)
    # the cascade re-scores the f32 query against the dequantized rows: the
    # plain top-k over those rows (a bf16 store's oracle would round the
    # query to bf16 first)
    x = idx._rows_f32_chunk(0, idx.descriptors.shape[0])
    ps, pi = topk_matmul_reference(x, q[:8], k=10, num_valid=idx.num_valid)
    on_card = [torch.as_tensor(a, device="cuda") for a in (s, i)]
    check_against_plain(x, q[:8], *on_card, ps, pi, TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_ivf_on_the_card(gen, dtype):
    """build_ivf on the card: no K1-K4 launch; at full probe a bf16 store
    gives K1's route and an int8 store the oracle's on the bf16-rounded
    query (the reference's scoring), by check_against_plain."""
    rows, idx = _ann_store(gen, dtype)
    view = idx.build_ivf(n_clusters=64)
    q = torch.as_tensor(rows[:32], device="cuda")
    (s, i), launches = _launches_of(lambda: idx.search(q))
    assert launches == 0 and (i[:, 0] == np.arange(32)).all()
    full = idx.cfg.search.replace(ivf_nprobe=view.n_clusters,
                                  qe_enabled=False)
    s, i = idx.search(q, full)
    if dtype == "bfloat16":
        ps, pi = idx.search(q, full.replace(ivf_nprobe=0))
        x = idx.descriptors
    else:
        ps, pi = idx.with_search(use_pallas=False).search(
            q.to(torch.bfloat16).float(), full.replace(ivf_nprobe=0))
        x = idx._rows_f32_chunk(0, idx.descriptors.shape[0])
    on_card = [torch.as_tensor(a, device="cuda") for a in (s, i, ps, pi)]
    check_against_plain(x, q, *on_card, TOL)


@pytest.mark.gpu
def test_adc_select_memory_and_cpu_agreement(gen):
    """The ADC selection over 4M codes (C = 1024, depth 400): its working
    memory stays far under the one-hot form's, and its answer is the same
    view's on the CPU (scores within 1e-5 of the largest, positions equal
    but at near-ties)."""
    from instsearch_torch.search.ivfpq import IVFPQView
    c, m_cap = 1024, 4096
    cent = _unit(gen, c, 256)
    codes = torch.randint(-128, 128, (c, m_cap, 16), generator=gen,
                          device="cuda", dtype=torch.int8)
    pos = torch.randperm(c * m_cap, generator=gen, device="cuda").to(
        torch.int32).reshape(c, m_cap)
    pq = 0.05 * torch.randn(32, 16, 8, generator=gen, device="cuda")
    empty = torch.zeros((0,), dtype=torch.int32, device="cuda")
    view = IVFPQView(cent, codes, pos, torch.zeros((0, 16), dtype=torch.int8,
                                                   device="cuda"),
                     empty, empty.clone(), PQCodebook(pq), depth=400)
    q = _unit(gen, 8, 256).cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s, p = view.search_adc(q, k=400)
    assert torch.cuda.max_memory_allocated() - base < 1 << 30
    cpu = IVFPQView(cent.cpu(), codes.cpu(), pos.cpu(),
                    view.spill_codes.cpu(), empty.cpu(), empty.cpu(),
                    PQCodebook(pq.cpu()), depth=400)
    cs, cp = cpu.search_adc(q, k=400)
    tol = 1e-5 * np.abs(cs).max()
    np.testing.assert_allclose(s, cs, rtol=0, atol=tol)
    for r, j in zip(*np.nonzero(p != cp)):
        other = np.flatnonzero(cp[r] == p[r, j])
        assert (len(other) and abs(cs[r, other[0]] - cs[r, j]) <= 2 * tol) \
            or abs(s[r, j] - cs[r, -1]) <= 2 * tol


@pytest.mark.gpu
def test_bench_query_takes_the_kernel(gen):
    """``bench.bench_query`` over 65,536 x 128 bf16 rows on the card runs
    K1 (path ``"kernel"``, launches counted) beside its interleaved
    roofline probe, and reports finite times."""
    from instsearch_torch import bench
    before = topk_matmul.launches
    out = bench.bench_query(n=65_536, d=128, k=10)
    assert out["path"] == "kernel"
    assert topk_matmul.launches > before
    assert np.isfinite(out["p50_ms"]) and out["p50_ms"] > 0
    lo, hi = out["spread_ms"]
    assert lo <= hi
    assert {"hbm_bw_gbps", "hbm_roofline_ms", "frac_of_roofline"} <= set(out)
