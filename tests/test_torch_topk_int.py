"""K2 and K3 of the port (instsearch_torch.kernels.topk_matmul_int8 /
topk_matmul_int4) against the JAX Pallas kernels run in interpret mode on
the CPU, as tests/kernels/test_topk_int8.py and test_topk_int4.py run them;
and the int8/int4 scoring oracle and alpha-QE against the reference's.

On the CPU each wrapper takes its plain version; the CUDA kernels are held
to the same plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).

Tolerances. The kernels: none. Both sides quantize the query with
byte-identical functions, sum int8 products exactly in int32 and scale with
the same two f32 products, so ids and scores must be equal bit for bit,
ties included. The oracle (an f32 query against the stored integers) and
alpha-QE: rtol = atol = 1e-5 on scores, since the two sides sum f32 products
in different orders; ids equal, since random normal scores at these sizes
lie far further apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.kernels import topk_matmul_int4 as jax_int4
from instsearch_tpu.kernels import topk_matmul_int8 as jax_int8
from instsearch_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from instsearch_tpu.ops.quantize import quantize_rows_int4 as jax_quantize_int4
from instsearch_tpu.search import bruteforce as jbf
from instsearch_tpu.search import qe as jqe
from instsearch_torch.kernels import (topk_matmul, topk_matmul_int4,
                                      topk_matmul_int8)
from instsearch_torch.kernels.topk_matmul import check_exact
from instsearch_torch.ops.quantize import quantize_rows, quantize_rows_int4
from instsearch_torch.search import bruteforce as tbf
from instsearch_torch.search import qe as tqe

_KINDS = {
    "int8": (quantize_rows, jax_quantize_rows, topk_matmul_int8, jax_int8),
    "int4": (quantize_rows_int4, jax_quantize_int4, topk_matmul_int4,
             jax_int4),
}


def _both(kind, X, Q, k, tile, num_valid=None, mask=None):
    """(jax scores, jax ids, port scores, port ids) as numpy; the store is
    quantized by each package from the same f32 rows."""
    tquant, jquant, tfn, jfn = _KINDS[kind]
    jr = jquant(jnp.asarray(X))
    js, ji = jfn(jr.values, jr.scales, jnp.asarray(Q), k=k, tile_n=tile,
                 num_valid=num_valid, interpret=True,
                 mask=None if mask is None else jnp.asarray(mask))
    tr = tquant(torch.from_numpy(X))
    before = tfn.launches
    ps, pi = tfn(tr.values, tr.scales, torch.from_numpy(Q), k=k,
                 num_valid=num_valid,
                 mask=None if mask is None else torch.from_numpy(mask))
    assert tfn.launches == before            # a CPU store launches nothing
    return np.asarray(js), np.asarray(ji), ps.numpy(), pi.numpy()


def _assert_exact(js, ji, ps, pi):
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(ps.view(np.uint32), js.view(np.uint32))


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("n,d,b,k,tile", [
    (512, 128, 3, 10, 128),
    (1024, 64, 8, 32, 256),       # k > 16: the 16-round extraction tier
    (512, 256, 1, 1, 256),        # k = 1
    (256, 512, 2, 100, 128),      # the presets' whitened width
    (384, 2048, 1, 10, 128),      # the unwhitened ResNet-50 width
])
def test_matches_pallas_kernel_exactly(kind, n, d, b, k, tile):
    rng = np.random.default_rng(d + k)
    X = rng.standard_normal((n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Q = rng.standard_normal((b, d)).astype(np.float32)
    _assert_exact(*_both(kind, X, Q, k, tile))


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_num_valid_masks_poisoned_padding(kind):
    rng = np.random.default_rng(2)
    X = rng.standard_normal((256, 64)).astype(np.float32)
    X[200:] = 50.0                            # must never be returned
    Q = rng.standard_normal((2, 64)).astype(np.float32)
    js, ji, ps, pi = _both(kind, X, Q, 10, 128, num_valid=200)
    assert pi.max() < 200
    _assert_exact(js, ji, ps, pi)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_subset_mask(kind):
    rng = np.random.default_rng(4)
    X = rng.standard_normal((512, 64)).astype(np.float32)
    Q = rng.standard_normal((3, 64)).astype(np.float32)
    mask = (rng.random((1, 512)) < 0.5).astype(np.int8)
    js, ji, ps, pi = _both(kind, X, Q, 10, 128, mask=mask)
    _assert_exact(js, ji, ps, pi)
    assert mask[0, pi].all()


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_fewer_valid_rows_than_k(kind):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((128, 32)).astype(np.float32)
    Q = rng.standard_normal((2, 32)).astype(np.float32)
    js, ji, ps, pi = _both(kind, X, Q, 10, 128, num_valid=4)
    _assert_exact(js, ji, ps, pi)
    assert (pi[:, 4:] == -1).all() and np.isneginf(ps[:, 4:]).all()


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_duplicated_rows_lowest_position_first(kind):
    rng = np.random.default_rng(1)
    base = rng.standard_normal((8, 64)).astype(np.float32)
    X = np.concatenate([base] * 32)           # every row 32 times
    Q = rng.standard_normal((2, 64)).astype(np.float32)
    js, ji, ps, pi = _both(kind, X, Q, 40, 128)
    _assert_exact(js, ji, ps, pi)
    # the best base row's 32 copies first, lowest position first
    assert (pi[:, :32] // 8 == np.arange(32)).all()
    assert (pi[:, :32] % 8 == pi[:, :1] % 8).all()


def test_odd_width_int4_store():
    """The mini fixture's 55-dim whitened rows: an int4 store gains a zero
    column (56 components, 28 bytes per row) and queries a zero component."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((256, 56)).astype(np.float32)
    X[:, 55] = 0.0
    Q = rng.standard_normal((2, 56)).astype(np.float32)
    Q[:, 55] = 0.0
    _assert_exact(*_both("int4", X, Q, 10, 128))


def test_rejects_what_it_cannot_take():
    qr = quantize_rows_int4(torch.zeros((64, 32)))
    with pytest.raises(ValueError, match="packed"):
        topk_matmul_int4(qr.values, qr.scales, torch.zeros((1, 48)), k=5)
    with pytest.raises(ValueError, match="store dim"):
        topk_matmul_int8(qr.values, qr.scales, torch.zeros((1, 32)), k=5)
    with pytest.raises(ValueError):
        topk_matmul_int8(qr.values.float(), qr.scales, torch.zeros((1, 16)))
    with pytest.raises(ValueError):
        topk_matmul_int8(qr.values, qr.scales[:, :10], torch.zeros((1, 16)))
    with pytest.raises(ValueError):
        topk_matmul_int4(qr.values, qr.scales, torch.zeros((1, 32)), k=0)
    with pytest.raises(ValueError, match="topk_matmul_int8"):
        topk_matmul(qr.values, torch.zeros((1, 16)))


def test_check_exact_rejects_any_difference():
    s = torch.tensor([[3.0, 2.0, float("-inf")]])
    i = torch.tensor([[4, 7, -1]], dtype=torch.int32)
    assert check_exact(s, i, s.clone(), i.clone()) == 0.0
    with pytest.raises(AssertionError, match="positions"):
        check_exact(s, i.flip(1), s, i)
    with pytest.raises(AssertionError, match="scores"):
        check_exact(torch.nextafter(s, torch.zeros(())), i, s, i)


# ---- the scoring oracle and alpha-QE over quantized stores ---------------

def _store(kind, n=300, d=64, seed=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    ids = np.arange(n, dtype=np.int32)
    ids[-20:] = -1                            # padding rows
    quant = {"int8": jax_quantize_rows, "int4": jax_quantize_int4}[kind]
    jr = quant(jnp.asarray(X))
    Q = rng.standard_normal((4, d)).astype(np.float32)
    return jr, ids, Q


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_masked_scores_matches_reference(kind):
    jr, ids, Q = _store(kind)
    int4 = kind == "int4"
    want = np.asarray(jbf.masked_scores(jr.values, jnp.asarray(Q),
                                        scales=jr.scales,
                                        ids=jnp.asarray(ids), int4=int4))
    got = tbf.masked_scores(_t(jr.values), _t(Q), scales=_t(jr.scales),
                            ids=_t(ids), int4=int4).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_alpha_query_expansion_matches_reference(kind):
    jr, ids, Q = _store(kind)
    int4 = kind == "int4"
    want = np.asarray(jqe.alpha_query_expansion(
        jr.values, jnp.asarray(ids), jnp.asarray(Q), n=10, alpha=3.0,
        scales=jr.scales, int4=int4))
    got = tqe.alpha_query_expansion(
        _t(jr.values), _t(ids), _t(Q), n=10, alpha=3.0, scales=_t(jr.scales),
        int4=int4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
