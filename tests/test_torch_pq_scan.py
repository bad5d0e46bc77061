"""K4 of the port (instsearch_torch.kernels.pq_topk) against the JAX Pallas
kernel run in interpret mode on the CPU, as tests/kernels/test_pq_scan.py
runs it. On the CPU the wrapper takes its plain version,
``pq_topk_reference``; the CUDA kernel is held to that plain version bit
for bit on the card (tests/test_torch_gpu.py, chip_smoke.py).

Tolerances. Both sides score with the same bf16-rounded lookup table; the
TPU kernel sums its 2 x M/2 products in the matrix unit's order, the port
in ascending m, so scores agree to 2e-5 (64 f32 additions of values below
1 in another order), and positions may differ only where the JAX scores of
the two rows lie within that same 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_torch.kernels.pq_scan as tscan
from instsearch_tpu.kernels.pq_scan import pq_topk as jax_pq_topk
from instsearch_tpu.ops.pq import PQCodebook as JaxCodebook
from instsearch_tpu.ops.pq import decode_pq, encode_pq, fit_pq
from instsearch_torch.kernels import pq_topk, pq_topk_reference
from instsearch_torch.kernels.topk_matmul import check_exact
from instsearch_torch.ops.pq import PQCodebook

TOL = 2e-5


def _fixture(rng, n, d, m, b):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jcb = fit_pq(jnp.asarray(x), m=m, iters=5)
    packed = np.asarray(encode_pq(jnp.asarray(x), jcb))
    tcb = PQCodebook(torch.tensor(np.asarray(jcb.centroids)))
    return packed, q, jcb, tcb


def _both(packed, q, jcb, tcb, k, num_valid=None, mask=None):
    js, ji = jax_pq_topk(jnp.asarray(packed), jnp.asarray(q), jcb, k=k,
                         num_valid=num_valid, interpret=True,
                         mask=None if mask is None else jnp.asarray(mask))
    ts, ti = pq_topk(torch.tensor(packed), torch.tensor(q), tcb, k=k,
                     num_valid=num_valid,
                     mask=None if mask is None else torch.tensor(mask))
    return np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy()


def _agree(js, ji, ts, ti):
    """Scores within TOL; a position swap only between rows JAX scores
    within TOL of each other; empty slots exactly (-inf, -1) on both."""
    assert ((ji < 0) == (ti < 0)).all()
    assert np.isneginf(ts[ti < 0]).all() and np.isneginf(js[ji < 0]).all()
    full = ti >= 0
    np.testing.assert_allclose(ts[full], js[full], rtol=0, atol=TOL)
    for q in range(ji.shape[0]):
        jscore = dict(zip(ji[q].tolist(), js[q].tolist()))
        for a, b in zip(ji[q], ti[q]):
            if a != b:
                assert b in jscore and abs(jscore[a] - jscore[b]) < TOL


@pytest.mark.parametrize("b", [1, 4])
def test_matches_jax_kernel(rng, b):
    packed, q, jcb, tcb = _fixture(rng, 512, 64, 8, b)
    _agree(*_both(packed, q, jcb, tcb, 10))


def test_padding_and_k_past_valid_rows(rng):
    packed, q, jcb, tcb = _fixture(rng, 1024, 64, 8, 2)
    js, ji, ts, ti = _both(packed, q, jcb, tcb, 8, num_valid=200)
    assert ti.max() < 200
    _agree(js, ji, ts, ti)
    js, ji, ts, ti = _both(packed, q, jcb, tcb, 10, num_valid=5)
    assert (ti[:, 5:] == -1).all() and np.isneginf(ts[:, 5:]).all()
    _agree(js, ji, ts, ti)


def test_half_mask(rng):
    packed, q, jcb, tcb = _fixture(rng, 512, 64, 8, 3)
    mask = (rng.random((1, 512)) < 0.5).astype(np.int8)
    js, ji, ts, ti = _both(packed, q, jcb, tcb, 10, mask=mask)
    assert (mask[0][ti[ti >= 0]] > 0).all()
    _agree(js, ji, ts, ti)


def test_k100_and_full_depth(rng):
    packed, q, jcb, tcb = _fixture(rng, 512, 64, 8, 2)
    _agree(*_both(packed, q, jcb, tcb, 100))
    packed, q, jcb, tcb = _fixture(rng, 128, 32, 4, 2)
    js, ji, ts, ti = _both(packed, q, jcb, tcb, 128)
    assert sorted(ti[0].tolist()) == list(range(128))
    _agree(js, ji, ts, ti)


def test_scores_are_bf16_lut_sums_of_the_decoded_rows(rng):
    """Every returned score is the row's ADC score: close to q . decode(row)
    up to the table's bf16 rounding, as the reference's own test holds."""
    packed, q, jcb, tcb = _fixture(rng, 256, 32, 4, 3)
    s, i = pq_topk(torch.tensor(packed), torch.tensor(q), tcb, k=16)
    full = q @ np.asarray(decode_pq(jnp.asarray(packed), jcb)).T
    want = np.take_along_axis(full, i.numpy(), axis=1)
    np.testing.assert_allclose(s.numpy(), want, rtol=2e-2, atol=2e-2)


def test_duplicate_rows_come_lowest_position_first(rng):
    packed, q, _, tcb = _fixture(rng, 64, 32, 4, 2)
    dup = np.tile(packed, (8, 1))                   # each row 8 times
    s, i = pq_topk(torch.tensor(dup), torch.tensor(q), tcb, k=16)
    i = i.numpy()
    assert (i[:, :8] % 64 == i[:, :1] % 64).all()
    assert (i[:, :8] // 64 == np.arange(8)).all()


def test_plain_version_in_pieces_equals_one_piece(rng, monkeypatch):
    """The plain version selects per piece of rows, then merges: the answer
    is the one-piece answer bit for bit, ties included."""
    packed, q, _, tcb = _fixture(rng, 512, 64, 8, 3)
    dup = torch.tensor(np.tile(packed[:100], (6, 1)))
    qt = torch.tensor(q)
    for x, nv in ((torch.tensor(packed), 400), (dup, None)):
        whole = pq_topk_reference(x, qt, tcb, k=50, num_valid=nv)
        monkeypatch.setattr(tscan, "_PLAIN_ROWS", 96)
        pieces = pq_topk_reference(x, qt, tcb, k=50, num_valid=nv)
        monkeypatch.undo()
        check_exact(*pieces, *whole)


def test_validation_errors_match_the_reference(rng):
    packed, q, jcb, tcb = _fixture(rng, 128, 32, 4, 1)
    with pytest.raises(ValueError) as jerr:                 # query dim
        jax_pq_topk(jnp.asarray(packed), jnp.asarray(q[:, :16]), jcb, k=4,
                    interpret=True)
    with pytest.raises(ValueError) as terr:
        pq_topk(torch.tensor(packed), torch.tensor(q[:, :16]), tcb, k=4)
    assert str(terr.value) == str(jerr.value)
    other = JaxCodebook(jnp.zeros((8, 16, 4), jnp.float32))   # m mismatch
    with pytest.raises(ValueError) as jerr:
        jax_pq_topk(jnp.asarray(packed), jnp.asarray(q), other, k=4,
                    interpret=True)
    with pytest.raises(ValueError) as terr:
        pq_topk(torch.tensor(packed), torch.tensor(q),
                PQCodebook(torch.zeros(8, 16, 4)), k=4)
    assert str(terr.value) == str(jerr.value)


def test_cpu_wrapper_counts_no_launch(rng):
    packed, q, _, tcb = _fixture(rng, 128, 32, 4, 1)
    before = pq_topk.launches
    pq_topk(torch.tensor(packed), torch.tensor(q), tcb, k=4)
    assert pq_topk.launches == before
