"""``VectorServeCore`` (``instsearch_torch/serve.py``) against
``instsearch_tpu``'s on one host row store and the same IVF-PQ view.

The JAX package writes the store (400 clustered int8 rows, D = 32, ids that
are not positions) and fits the view; the port reads the same files and
loads the saved view. Each request line goes through both cores'
``handle_line``: the responses are equal key for key but the latency, with
scores within 1e-6 (the host gather re-scores in numpy in both; ADC-only
within 1e-5 of the largest ADC score). Subsets defined by ids and by
positions, dropped, unknown; mutations and malformed vectors are refused
with the reference's error lines."""
import json

import numpy as np
import pytest

from instsearch_tpu.search.ivfpq import HostRowStore as JaxHostRowStore
from instsearch_tpu.search.ivfpq import IVFPQView as JaxIVFPQView
from instsearch_tpu.serve import VectorServeCore as JaxVectorServeCore
from instsearch_torch.search.ivfpq import HostRowStore, IVFPQView
from instsearch_torch.serve import VectorServeCore

N, D = 400, 32


def _rows(seed, n, d, centres=10, sigma=0.12):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centres, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = (c[rng.integers(0, centres, n)]
         + sigma * rng.standard_normal((n, d)).astype(np.float32))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def cores(tmp_path_factory):
    root = tmp_path_factory.mktemp("vector_serve")
    x = _rows(0, N, D)
    ids = (np.arange(N) * 3 + 1000).astype(np.int32)
    jstore = JaxHostRowStore.create(str(root / "store"), x, ids=ids)
    jview = JaxIVFPQView.from_host_store(jstore, n_clusters=8, nprobe=3,
                                         m=4, pq_iters=4, depth=40)
    jview.save(str(root / "view"))
    tstore = HostRowStore(str(root / "store"))
    tview = IVFPQView.load(str(root / "view"), device="cpu")
    out = {"x": x, "ids": ids}
    for adc in (False, True):
        out[adc] = (JaxVectorServeCore(jstore, jview, k=5, adc_only=adc),
                    VectorServeCore(tstore, tview, k=5, adc_only=adc,
                                    device="cpu"))
    return out


def _same(got, want, tol):
    got, want = dict(got), dict(want)
    for r in (got, want):
        r.pop("latency_ms", None)
    if "results" not in want:
        assert got == want
        return
    res_g, res_w = got.pop("results"), want.pop("results")
    assert got == want
    assert len(res_g) == len(res_w)
    for rg, rw in zip(res_g, res_w):
        assert [h["rank"] for h in rg] == [h["rank"] for h in rw]
        np.testing.assert_allclose([h["score"] for h in rg],
                                   [h["score"] for h in rw], rtol=0,
                                   atol=tol)
        assert [h["id"] for h in rg] == [h["id"] for h in rw]


def _lines(x, ids):
    return [
        {"vector": x[3].tolist()},
        {"vectors": x[10:13].tolist(), "k": 7},
        {"define_subset": {"name": "odd", "ids": ids[1::2].tolist()}},
        {"vectors": x[20:24].tolist(), "subset": "odd"},
        {"define_subset": {"name": "head", "positions": list(range(50))}},
        {"vector": x[5].tolist(), "subset": "head", "k": 3},
        {"drop_subset": "odd"},
        {"vector": x[5].tolist(), "subset": "odd"},
        {"define_subset": {"name": "bad", "ids": [7]}},
        {"define_subset": {"name": "bad", "positions": [N]}},
        {"add": [x[0].tolist()]},
        {"remove": [1]},
        {"vector": x[0, :5].tolist()},
    ]


@pytest.mark.parametrize("adc_only", [False, True])
def test_handle_line_equal(cores, adc_only):
    jcore, tcore = cores[adc_only]
    x, ids = cores["x"], cores["ids"]
    assert tcore.ready_info() == jcore.ready_info()
    tol = 1e-5 if adc_only else 1e-6
    for req in _lines(x, ids):
        line = json.dumps(req)
        _same(tcore.handle_line(line), jcore.handle_line(line), tol)


def test_cascade_finds_each_row_first(cores):
    """The host-gather cascade answers every stored row with itself."""
    _, tcore = cores[False]
    x, ids = cores["x"], cores["ids"]
    ans = tcore.handle_line(json.dumps({"vectors": x[::40].tolist()}))
    assert [r[0]["id"] for r in ans["results"]] == ids[::40].tolist()
    subset = tcore.handle_line(json.dumps(
        {"define_subset": {"name": "head", "positions": list(range(50))}}))
    assert subset["count"] == 50
    tcore.warmup()
    assert tcore.query_cap() == 128 and tcore.buckets == [1, 2, 4, 8]


def test_construction_refusals(cores, tmp_path):
    _, tcore = cores[False]
    small = HostRowStore.create(str(tmp_path / "small"), cores["x"][:, :16])
    with pytest.raises(ValueError, match="view dim 32 != store dim 16"):
        VectorServeCore(small, tcore.view, device="cpu")
    with pytest.raises(ValueError, match="lies on cpu"):
        VectorServeCore(tcore.store, tcore.view, device="meta")
