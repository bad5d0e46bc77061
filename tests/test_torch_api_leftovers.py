"""The last public functions the port lacked, against the JAX package on the
same seeded inputs: ``eval/revisited.py``'s ``compute_ap``,
``precision_at`` and ``evaluate_scores``, ``search/bruteforce.py::
all_scores``, ``search/rerank.py::regional_rerank_scores`` (all exported
under the reference's names) and ``data/loader.py::grain_dataset``.

What is compared, and the tolerances:
  * the protocol functions: the hand-computed cases of
    tests/unit/test_revisited.py, each equal to the reference's value (the
    same numpy arithmetic: exactly); ``evaluate_scores`` of seeded score
    matrices equal to the reference's, key for key; the vectorized AP and
    P@k equal to the loops on randomized protocol data;
  * ``all_scores``: f32 and bf16 stores, scores within 1e-6 of the
    reference's (products exact in f32, the sums' order differs);
  * ``regional_rerank_scores``: bf16 and int8 regional stores with padding
    rows: scores within 1e-6, ids equal;
  * the mini pipeline (tests/integration/test_mini_pipeline.py:8-42, with a
    seeded ResNet-18 at 64 px in f32 for the reference's ResNet-50): the
    fixture's layout, then ``all_scores`` -> ``evaluate_scores`` over the
    port's descriptors above the reference's golden bounds and equal to the
    reference's functions on the same descriptors, and ``compute_ap``
    against the independent AP of tests/parity/torch_pipeline.py
    (tests/parity/test_pipeline_oracle.py:127-131), within 1e-9;
  * ``grain_dataset``'s batches equal the reference's bit for bit on the
    mini fixture, a broken file giving a zero image and index -1
    (tests/unit/test_loaders.py:38-44), at ``num_workers`` 0 and 2 (the
    reference's at 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_tpu.eval as jeval
import instsearch_tpu.search as jsearch
from instsearch_tpu.data.loader import grain_dataset as jax_grain_dataset
from instsearch_torch import eval as teval
from instsearch_torch import search as tsearch
from instsearch_torch.data import frontend
from instsearch_torch.data.loader import grain_dataset
from instsearch_torch.eval.revisited import _ap_fast, _patk_fast
from instsearch_torch.extractor import Extractor
from instsearch_torch.ops.quantize import quantize_rows

from parity import torch_pipeline as tp


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small CPU models in a worker process: one intra-op thread, restored
    afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


AP_CASES = [                       # tests/unit/test_revisited.py
    ([0, 1, 2, 9, 8], {0, 1, 2}, set(), 1.0),
    ([0, 2, 3, 1], {0, 1}, {2}, 0.5 + (0.5 + 2 / 3) / 4),
    ([5, 0, 1], {0, 1}, set(), None),
    ([5, 9, 0, 9, 1], {0, 1}, {9}, None),
    ([2, 3, 0, 1], {0, 1}, set(), 7 / 24),
    ([3, 4], set(), set(), float("nan")),
]


@pytest.mark.parametrize("ranked,pos,junk,want", AP_CASES)
def test_compute_ap(ranked, pos, junk, want):
    got = teval.compute_ap(np.array(ranked), pos, junk)
    ref = jeval.compute_ap(np.array(ranked), pos, junk)
    if want is not None and np.isnan(want):
        assert np.isnan(got) and np.isnan(ref)
        return
    assert got == ref
    if want is not None:
        assert got == pytest.approx(want, abs=1e-9)


def test_junk_neither_helps_nor_hurts():
    base = teval.compute_ap(np.array([5, 0, 1]), {0, 1}, set())
    assert teval.compute_ap(np.array([5, 9, 0, 9, 1]), {0, 1}, {9}) == \
        pytest.approx(base)


@pytest.mark.parametrize("pos,junk,k,want", [
    ({0, 1}, {9}, 2, 1.0), ({0, 3}, set(), 4, 0.5), ({0}, set(), 10, 1.0)])
def test_precision_at(pos, junk, k, want):
    ranked = np.array([0, 9, 1, 2, 3])
    got = teval.precision_at(ranked, pos, junk, k)
    assert got == jeval.precision_at(ranked, pos, junk, k)
    assert got == pytest.approx(want)


def test_fast_ap_equals_the_loops():
    rng = np.random.default_rng(17)
    for _ in range(30):
        n = int(rng.integers(5, 200))
        ranked = rng.permutation(n).astype(np.int64)
        pos = set(rng.choice(n, size=int(rng.integers(1, max(2, n // 3))),
                             replace=False).tolist())
        pool = [i for i in range(n) if i not in pos]
        junk = set(rng.choice(pool, size=int(rng.integers(
            0, max(1, len(pool) // 2))), replace=False).tolist())
        pos_a = np.fromiter(pos, dtype=ranked.dtype, count=len(pos))
        junk_a = np.fromiter(junk, dtype=ranked.dtype, count=len(junk))
        assert _ap_fast(ranked, pos_a, junk_a) == pytest.approx(
            teval.compute_ap(ranked, pos, junk), abs=1e-12)
        assert _patk_fast(ranked, pos_a, junk_a, (1, 5, 10)) == \
            pytest.approx([teval.precision_at(ranked, pos, junk, k)
                           for k in (1, 5, 10)], abs=1e-12)


@pytest.mark.parametrize("protocol", ["easy", "medium", "hard", "classic"])
def test_evaluate_scores_equals_jax(protocol):
    rng = np.random.default_rng(5)
    scores = rng.standard_normal((6, 40)).astype(np.float32)
    gnd = [{"easy": rng.choice(40, 3, replace=False).tolist(),
            "hard": rng.choice(40, 2, replace=False).tolist(),
            "junk": rng.choice(40, 4, replace=False).tolist()}
           for _ in range(5)] + [{"easy": [], "hard": [], "junk": [1]}]
    got = teval.evaluate_scores(scores, gnd, protocol)
    want = jeval.evaluate_scores(scores, gnd, protocol)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got.pop("per_query_ap"),
                                  want.pop("per_query_ap"))
    assert got == want


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_scores_equals_jax(dtype):
    rng = np.random.default_rng(8)
    x, q = _unit(rng, (300, 64)), _unit(rng, (7, 64))
    got = tsearch.all_scores(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(q))
    want = np.asarray(jsearch.all_scores(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(q)))
    assert got.dtype == torch.float32 and got.shape == (7, 300)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_regional_rerank_scores_equals_jax(kind):
    rng = np.random.default_rng(12)
    n, n_pad, r, d, depth, k = 90, 96, 5, 32, 24, 10
    reg = np.zeros((n_pad, r, d), np.float32)
    reg[:n] = _unit(rng, (n, r, d))
    qreg = _unit(rng, (4, 3, d))
    ids = np.where(np.arange(n_pad) < n, np.arange(n_pad), -1).astype(
        np.int32)
    g = rng.standard_normal((4, n_pad)).astype(np.float32)
    g[:, n:] = -np.inf
    if kind == "int8":
        qr = quantize_rows(torch.from_numpy(reg.reshape(-1, d)))
        t_store = qr.values.reshape(n_pad, r, d)
        t_scales = qr.scales.reshape(n_pad, r)
        j_store, j_scales = jnp.asarray(t_store.numpy()), jnp.asarray(
            t_scales.numpy())
    else:
        t_store, t_scales = torch.from_numpy(reg).to(torch.bfloat16), None
        j_store, j_scales = jnp.asarray(reg, jnp.bfloat16), None
    ts, ti = tsearch.regional_rerank_scores(
        t_store, torch.from_numpy(ids), torch.from_numpy(g),
        torch.from_numpy(qreg), depth=depth, k=k, fuse_weight=0.5,
        regional_scales=t_scales)
    js, ji = jsearch.regional_rerank_scores(
        j_store, jnp.asarray(ids), jnp.asarray(g), jnp.asarray(qreg),
        depth=depth, k=k, fuse_weight=0.5, regional_scales=j_scales)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return teval.make_mini_dataset(str(tmp_path_factory.mktemp("mini")),
                                   seed=0)


def test_mini_dataset_layout(mini):
    assert len(mini.qimlist) == 8
    assert len(mini.imlist) == 8 * 6 + 8
    for e in mini.gnd:
        assert e["easy"] and e["hard"] and e["junk"]


def test_mini_pipeline_map(mini):
    from instsearch_torch import ExtractConfig
    cfg = ExtractConfig(backbone="resnet18", pooling="avg", image_size=64,
                        batch_size=8, dtype="float32")
    ex = Extractor(cfg, seed=0, device="cpu")
    quarantine: list = []
    db, kept = ex.extract_paths(mini.db_paths, quarantine)
    q, _ = ex.extract_paths(mini.query_paths)
    db, q = np.asarray(db), np.asarray(q)
    assert not quarantine and db.shape == (len(mini.imlist), 512)
    assert list(kept) == list(range(len(mini.imlist)))
    np.testing.assert_allclose(np.linalg.norm(db, axis=1), 1.0, rtol=1e-4)
    scores = tsearch.all_scores(torch.from_numpy(db),
                                torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(scores, np.asarray(jsearch.all_scores(
        jnp.asarray(db), jnp.asarray(q))), rtol=0, atol=1e-6)
    res_med = teval.evaluate_scores(scores, mini.gnd, "medium")
    res_hard = teval.evaluate_scores(scores, mini.gnd, "hard")
    assert res_med["num_queries"] == 8
    assert res_med["mAP"] > 80.0, res_med
    assert res_med["mP@1"] == pytest.approx(100.0)
    assert 0.0 <= res_hard["mAP"] <= 100.0
    want = jeval.evaluate_scores(scores, mini.gnd, "medium")
    assert res_med.pop("per_query_ap") == want.pop("per_query_ap")
    assert res_med == want
    ranks = np.argsort(-scores, axis=1)
    for r, entry in enumerate(mini.gnd):
        pos = set(entry.get("easy", [])) | set(entry.get("hard", []))
        junk = set(entry.get("junk", []))
        assert teval.compute_ap(ranks[r], pos, junk) == pytest.approx(
            tp.average_precision_np(ranks[r], pos, junk), abs=1e-9)


@pytest.mark.parametrize("workers", [0, 2])
def test_grain_dataset_equals_the_reference(mini, workers, tmp_path):
    bad = str(tmp_path / "bad.jpg")
    open(bad, "wb").write(b"junk")
    paths = list(mini.db_paths[:5]) + [bad] + list(mini.db_paths[5:10])
    got = list(grain_dataset(paths, 32, 4, num_workers=workers))
    want = list(jax_grain_dataset(paths, 32, 4))
    assert [len(i) for _, i in got] == [4, 4, 3]
    assert len(got) == len(want)
    for (a, ia), (b, ib) in zip(got, want):
        assert a.dtype == np.uint8 and ia.dtype == np.int64
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(ia, np.asarray(ib))
    idx = np.concatenate([i for _, i in got])
    assert idx.tolist() == [0, 1, 2, 3, 4, -1, 6, 7, 8, 9, 10]
    assert not got[1][0][1].any()
    np.testing.assert_array_equal(got[0][0][0],
                                  frontend.load_square(paths[0], 32))
    total = sum((i >= 0).sum() for _, i in grain_dataset(
        mini.db_paths, 32, 4, num_workers=workers))
    assert total == len(mini.db_paths)
