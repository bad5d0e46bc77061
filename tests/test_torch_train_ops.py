"""The fine-tuning pieces that run without a backbone, against the
reference on the same seeded numpy inputs: Lw whitening
(``ops/whitening.py::fit_lw_whitening``), hard-negative mining
(``train/mining.py``), the three losses, the optimizer and the port's
checkpoint (``utils/checkpoint.py``).

Tolerances:
  * Lw with many pairs (M = 2000 >> D = 16, distinct eigenvalues): each row
    of ``P`` within 1e-4 of its largest entry after matching its sign (an
    eigenvector's sign is each library's choice), ``mu`` within 1e-6. With
    fewer pairs than dims the rows past the data's rank are any basis of
    the null space, so what is compared is the whitened Gram matrix of
    held-out pairs (``(x - mu)^T P^T P (y - mu)``, invariant to that
    basis): within 1e-4 of its largest entry;
  * mining: the indices equal;
  * the losses in f32: within 1e-6 relative;
  * AdamW (``torch.optim.AdamW``) fed the same gradients as
    ``optax.adamw`` (gradients from 1e-8 to 1 in scale, so the placement of
    ``eps`` and of the decay shows): the parameters within 1e-7 relative
    per step taken. Each step rounds a parameter once more in another
    order (torch decays ``p`` and then adds the Adam step; optax adds one
    update made of both), up to one f32 step of ``p`` (2^-23 relative);
    measured 2.9e-7 relative after five steps.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instsearch_tpu.config import TrainConfig as JaxTrainConfig
from instsearch_tpu.ops.whitening import apply_whitening as jax_apply
from instsearch_tpu.ops.whitening import fit_lw_whitening as jax_fit_lw
from instsearch_tpu.train import trainer as jtrainer
from instsearch_tpu.train.mining import mine_hard_negatives as jax_mine
from instsearch_torch.config import TrainConfig
from instsearch_torch.ops.whitening import apply_whitening, fit_lw_whitening
from instsearch_torch.train import (contrastive_loss, smoothap_loss,
                                    triplet_loss)
from instsearch_torch.train.mining import mine_hard_negatives
from instsearch_torch.utils.checkpoint import load_pytree, save_pytree


def _pairs(m, d, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    scale = np.linspace(0.3, 1.5, d).astype(np.float32)   # distinct spread
    a = (rng.standard_normal((m, d)) * scale).astype(np.float32)
    p = a + noise * (rng.standard_normal((m, d))
                     * scale[::-1]).astype(np.float32)
    return a, p


def _fit_both(a, p, dim=None):
    want = jax_fit_lw(jnp.asarray(a), jnp.asarray(p), dim=dim)
    got = fit_lw_whitening(torch.from_numpy(a), torch.from_numpy(p),
                           dim=dim)
    return want, got


@pytest.mark.parametrize("dim", [None, 6])
def test_lw_rows_match_up_to_sign(dim):
    a, p = _pairs(2000, 16)
    want, got = _fit_both(a, p, dim)
    wp, gp = np.asarray(want.P), got.P.numpy()
    assert gp.shape == wp.shape == (dim or 16, 16)
    for w, g in zip(wp, gp):
        sign = np.sign(np.dot(w, g))
        np.testing.assert_allclose(sign * g, w, atol=1e-4 * np.abs(w).max())
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu),
                               atol=1e-6)


def test_lw_few_pairs_whitened_gram_matches():
    """M = 10 pairs at D = 64: the rank cap keeps 9 components, the floor
    bounds the amplification, and held-out pairs whitened by either fit
    have the same Gram matrix."""
    a, p = _pairs(10, 64, seed=1, noise=0.05)
    want, got = _fit_both(a, p)
    assert got.P.shape == (9, 64)
    held_a, held_p = _pairs(6, 64, seed=2, noise=0.05)
    held = np.concatenate([held_a, held_p])

    def gram(P, mu):
        w = (held - np.asarray(mu)) @ np.asarray(P).T
        return w @ w.T

    g_want = gram(want.P, want.mu)
    np.testing.assert_allclose(gram(got.P.numpy(), got.mu.numpy()), g_want,
                               atol=1e-4 * np.abs(g_want).max())


def test_lw_normalizes_intraclass_scatter(rng):
    """The reference's own check: pairs that differ mostly along one
    direction have an isotropic difference after Lw."""
    d = 16
    noise_dir = np.zeros(d, np.float32)
    noise_dir[0] = 1.0
    a = rng.standard_normal((500, d)).astype(np.float32)
    p = (a + 3.0 * rng.standard_normal((500, 1)).astype(np.float32)
         * noise_dir
         + 0.05 * rng.standard_normal((500, d)).astype(np.float32))
    params = fit_lw_whitening(torch.from_numpy(a), torch.from_numpy(p))
    wa = apply_whitening(torch.from_numpy(a), params, renormalize=False)
    wp = apply_whitening(torch.from_numpy(p), params, renormalize=False)
    scatter = torch.var(wa - wp, dim=0).numpy()
    assert scatter.max() / max(scatter.min(), 1e-6) < 10.0, scatter
    raw = np.var(a - p, axis=0)
    assert raw.max() / raw.min() > 100.0


def test_lw_few_pairs_keeps_matched_pairs_closer(rng):
    a = rng.standard_normal((10, 64)).astype(np.float32)
    p = a + 0.05 * rng.standard_normal((10, 64)).astype(np.float32)
    params = fit_lw_whitening(torch.from_numpy(a), torch.from_numpy(p))
    out = apply_whitening(torch.from_numpy(a), params)
    assert torch.isfinite(out).all()
    wa, wp, wr = (apply_whitening(torch.from_numpy(x), params)
                  for x in (a[:4], p[:4], a[4:8]))
    assert (wa * wp).sum(1).mean() > (wa * wr).sum(1).mean()
    assert out.shape == jax_apply(jnp.asarray(a), jax_fit_lw(
        jnp.asarray(a), jnp.asarray(p))).shape == (10, 9)
    assert fit_lw_whitening(torch.from_numpy(a[:, :12]),
                            torch.from_numpy(p[:, :12]),
                            dim=4).P.shape == (4, 12)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("case", ["many", "fill", "cycle", "duplicates"])
def test_mining_indices_equal_the_reference(case):
    """``many``: 50 rows of 5 classes, 3 negatives (the top-13 has enough
    other-class rows); ``fill``: 2 classes where the top-k holds too few,
    filled from ``default_rng(anchor)``; ``cycle``: one other-class row for
    3 negatives; ``duplicates``: copies of rows, so top-k ties fall to the
    lower position."""
    rng = np.random.default_rng(3)
    if case == "many":
        pool = _unit(rng.standard_normal((50, 8)))
        labels = np.arange(50) % 5
        n = 3
    elif case == "fill":
        pool = _unit(rng.standard_normal((40, 8)))
        labels = (np.arange(40) >= 36).astype(np.int64)
        n = 4
    elif case == "cycle":
        pool = _unit(rng.standard_normal((12, 8)))
        labels = np.zeros(12, np.int64)
        labels[5] = 1
        n = 3
    else:
        base = _unit(rng.standard_normal((10, 8)))
        pool = np.concatenate([base, base, base])
        labels = np.arange(30) % 4
        n = 5
    anchors, alabels = pool[:12], labels[:12]
    want = jax_mine(pool, labels, anchors, alabels, num_negatives=n)
    got = mine_hard_negatives(pool, labels, anchors, alabels,
                              num_negatives=n, device="cpu")
    assert got.dtype == np.int64 and got.shape == (12, n)
    np.testing.assert_array_equal(got, want)
    for i in range(12):
        assert all(labels[j] != alabels[i] for j in got[i])


def test_mining_refuses_one_class():
    pool = _unit(np.random.default_rng(0).standard_normal((6, 4)))
    with pytest.raises(ValueError, match="at least 2 classes"):
        mine_hard_negatives(pool, np.zeros(6), pool[:2], np.zeros(2),
                            device="cpu")


LOSSES = {"contrastive": (contrastive_loss, jtrainer.contrastive_loss),
          "triplet": (triplet_loss, jtrainer.triplet_loss),
          "smoothap": (smoothap_loss, jtrainer.smoothap_loss)}


@pytest.mark.parametrize("shape", [(8, 7, 32), (3, 3, 16), (5, 4, 2048)])
@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_losses_match_the_reference(loss, shape):
    rng = np.random.default_rng([sorted(LOSSES).index(loss), *shape])
    base = rng.standard_normal((shape[0], 1, shape[2]))
    desc = _unit(base + 0.8 * rng.standard_normal(shape))  # some margins hit
    kw = dict(margin=0.7, smoothap_tau=0.05)
    port, ref = LOSSES[loss]
    got = float(port(torch.from_numpy(desc), TrainConfig(**kw)))
    want = float(ref(jnp.asarray(desc), JaxTrainConfig(**kw)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_smoothap_ranks_the_whole_batch():
    """An other tuple's positive scored above the anchor's own positive
    counts against it: the candidates are all B (T - 1) of the batch."""
    a = np.array([1.0, 0.0], np.float32)
    desc = np.stack([np.stack([a, _unit(np.array([1.0, 0.3])),
                               np.array([0.0, 1.0], np.float32)]),
                     np.stack([np.array([0.0, 1.0], np.float32), a,
                               np.array([0.0, -1.0], np.float32)])])
    cfg = TrainConfig(smoothap_tau=1e-3)
    loss = float(smoothap_loss(torch.from_numpy(desc), cfg))
    # tuple 0: tuple 1's positive (== a) ranks above its own: AP 1/2;
    # tuple 1 (anchor [0, 1], positive a at cosine 0): tuple 0's positive
    # (0.29) and negative (1.0) rank above it: AP 1/3
    assert loss == pytest.approx(1 - (1 / 2 + 1 / 3) / 2, abs=1e-4)


def test_adamw_matches_optax_on_the_same_gradients():
    rng = np.random.default_rng(5)
    shapes = {"w": (16, 8), "b": (8,), "gem_p": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32)
              for k, s in shapes.items()}
    grads = [{k: np.asarray(rng.standard_normal(s)
                            * 10.0 ** rng.integers(-8, 1), np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    tx = optax.adamw(1e-3, weight_decay=1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = torch.optim.AdamW(list(tp.values()), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-2)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v)
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-7 * len(grads), atol=1e-7)


def test_checkpoint_round_trip_and_orbax_refusal(tmp_path):
    tree = {"conv1.weight": torch.randn(4, 3, 3, 3),
            "bn1.running_mean": torch.arange(4.0)}
    save_pytree(str(tmp_path / "ck"), tree)
    back = load_pytree(str(tmp_path / "ck"))
    assert set(back) == set(tree)
    for k in tree:
        assert torch.equal(back[k], tree[k])
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="orbax reader"):
        load_pytree(str(tmp_path / "orbax"))
