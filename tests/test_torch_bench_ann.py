"""The port's benchmark stages of the ANN tiers (``instsearch_torch/
bench.py``: IVF, PQ, IVF-PQ, their capacity forms and the host-store
serving path) against the reference's on the CPU, at the toy arguments of
the reference's smoke tests (``tests/bench/test_bench_smoke.py``).

Each reference stage runs once in a module fixture, each port stage once
with ``device="cpu"``. Held equal: the reference's keys are a subset of the
port's (``EXTRA``: none), the fields the arguments fix (``FIXED``), the
recall curves' keys and the per-batch entries' keys. The stores are drawn
on the device by each package's generator, so recalls are not compared;
the reference's own assertions must hold for the port's output (recall
exact at full probe, deeper candidate sets recall no less,
``production_p50_ms`` the chained ADC plus the host part, the host
cascade's recall within the store's quantization of the device's).
``bench_host_serve`` draws its store with numpy (the reference's numbers);
every field it returns is an argument or a time.
"""
import math

import pytest
import torch

from instsearch_torch import bench as B
from instsearch_tpu import bench as RB

ARGS = {
    "ivf": dict(n=4096, d=64, k=5, n_clusters=16, nprobe=4,
                recall_nprobes=(1, 4, 16)),
    "pq": dict(n=4096, d=64, k=5, depth=32, m=8, fit_rows=2048),
    "pq_capacity": dict(n=8192, d=64, m=8, depth=16, q_batches=(1, 4)),
    "ivfpq": dict(n=4096, d=64, k=5, n_clusters=16, nprobe=4, m=8,
                  depth=32, recall_nprobes=(1, 4, 16), recall_depths=(8,),
                  host_quality=False),
    "ivfpq_capacity": dict(n=8192, d=64, m=8, n_clusters=32, nprobe=4,
                           depth=16, q_batches=(1, 4)),
    "host_serve": dict(n=8192, d=64, m=8, n_clusters=32, nprobe=4,
                       depth=16, q_batches=(1, 2), reps=3,
                       adc_chained_ms={"1": 0.5}),
    "host_quality": dict(n=4096, d=64, k=5, n_clusters=16, nprobe=4, m=8,
                         depth=32, recall_nprobes=(4,), recall_depths=(),
                         host_quality=True),
}
STAGES = {"ivf": "bench_ivf", "pq": "bench_pq",
          "pq_capacity": "bench_pq_capacity", "ivfpq": "bench_ivfpq",
          "ivfpq_capacity": "bench_ivfpq_capacity",
          "host_serve": "bench_host_serve", "host_quality": "bench_ivfpq"}
FIXED = {
    "ivf": ("n", "d", "k", "q_batch", "n_clusters", "nprobe", "cap_factor",
            "reps"),
    "pq": ("n", "d", "k", "depth", "q_batch", "m", "bytes_per_row"),
    "pq_capacity": ("n", "d", "m", "depth", "codes_gb", "bf16_equiv_gb",
                    "int4_equiv_gb", "q_batch"),
    "ivfpq": ("n", "d", "k", "q_batch", "n_clusters", "nprobe", "m",
              "depth", "bytes_per_row", "reps"),
    "ivfpq_capacity": ("n", "d", "m", "n_clusters", "nprobe", "depth",
                       "codes_gb", "scan_fraction", "q_batch"),
    "host_serve": ("n", "d", "m", "n_clusters", "nprobe", "depth",
                   "store_gb"),
    "host_quality": ("n", "d", "k", "q_batch", "n_clusters", "nprobe", "m",
                     "depth", "bytes_per_row", "reps"),
}
EXTRA = {name: set() for name in ARGS}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on a few cores: this
    module's small CPU tensors take one intra-op thread, restored
    afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(module, name, tmp, **extra):
    kw = dict(ARGS[name], **extra)
    if name == "host_serve":
        kw["workdir"] = str(tmp / f"{module.__name__}_{name}")
    return getattr(module, STAGES[name])(**kw)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    return {name: _run(RB, name, tmp) for name in ARGS}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port")
    return {name: _run(B, name, tmp, device="cpu") for name in ARGS}


def _finite_positive(x) -> bool:
    return math.isfinite(float(x)) and float(x) > 0


@pytest.mark.parametrize("name", sorted(ARGS))
def test_stage_matches_the_reference(ref, port, name):
    r, p = ref[name], port[name]
    assert set(r) <= set(p), set(r) - set(p)
    assert set(p) - set(r) == EXTRA[name]
    for key in FIXED[name]:
        assert p[key] == r[key], key
    assert _finite_positive(p["p50_ms"])
    for key in ("recall_at_k_vs_nprobe", "recall_at_k_vs_depth"):
        if key in r:
            assert set(p[key]) == set(r[key])
            assert all(0.0 <= v <= 1.0 for v in p[key].values())
    if "per_batch" in r:
        assert set(p["per_batch"]) == set(r["per_batch"])
        for b, entry in p["per_batch"].items():
            assert set(entry) == set(r["per_batch"][b])
            for key, v in entry.items():
                assert _finite_positive(v), (b, key)
        if "q_batch" in r:
            assert p["q_batch"] == ARGS[name]["q_batches"][0]
    if "spread_ms" in r:
        lo, hi = p["spread_ms"]
        assert _finite_positive(lo) and lo <= hi


def test_ivf_curve(port):
    """Full probe scans every cluster, so recall is exact; nprobe = 1 on
    boundary queries is not; the headline is the timed nprobe's point."""
    out = port["ivf"]
    curve = out["recall_at_k_vs_nprobe"]
    assert set(curve) == {"1", "4", "16"}
    assert curve["16"] == pytest.approx(1.0)
    assert curve["1"] < 1.0
    assert out["recall_at_k"] == curve["4"]
    assert 0 < out["scan_fraction"] <= 1


def test_pq_curve(port):
    """The cascade re-scores exactly: deeper candidate sets can only help;
    the headline is the timed depth's point."""
    out = port["pq"]
    curve = out["recall_at_k_vs_depth"]
    assert set(curve) == {"32", "1024"}
    assert out["recall_at_k"] == curve["32"]
    assert curve["1024"] >= curve["32"]
    assert 0.0 <= out["recall_at_k_opq"] <= 1.0
    assert _finite_positive(out["build_sec"] + 1e-9)


def test_pq_capacity_headline(port):
    out = port["pq_capacity"]
    assert out["n"] == 8192 and out["q_batch"] == 1
    assert out["p50_ms"] == out["per_batch"]["1"]["p50_ms"]
    assert _finite_positive(out["effective_gbps"])


def test_ivfpq_curve(port):
    """The recall headline is measured at the timed (nprobe, depth); a
    shallower contrast depth can only recall less."""
    out = port["ivfpq"]
    curve = out["recall_at_k_vs_nprobe"]
    assert set(curve) == {"1", "4", "16"}
    assert curve["16"] >= curve["1"]
    assert out["recall_at_k"] == curve["4"]
    assert out["depth"] == 32
    assert out["recall_at_k_depth8"] <= curve["4"]
    assert out["reps"] > 0 and len(out["spread_ms"]) == 2
    assert 0 < out["scan_fraction"] <= 1


def test_ivfpq_capacity_scan_fraction(port):
    assert port["ivfpq_capacity"]["scan_fraction"] == pytest.approx(4 / 32)


def test_host_serve_composition(port):
    out = port["host_serve"]
    assert _finite_positive(out["host_gather_rescore_p50_ms"])
    assert out["production_p50_ms"] == pytest.approx(
        0.5 + out["host_gather_rescore_p50_ms"])
    assert set(out["per_batch"]) == {"1", "2"}
    for e in out["per_batch"].values():
        assert e["host_gather_rescore_p50_ms"] <= e["e2e_p50_ms"]
    assert "production_p50_ms" not in out["per_batch"]["2"]


def test_host_quality_triple(ref, port):
    q = port["host_quality"]["host_quality"]
    assert set(q) == set(ref["host_quality"]["host_quality"]) == {
        "plain", "anisotropic_t0.2"}
    for label, qd in q.items():
        assert set(qd) == set(ref["host_quality"]["host_quality"][label])
        for v in qd.values():
            assert 0.0 <= v <= 1.0
        # the host cascade re-scores against the int8 store: only the
        # store's quantization separates it from the device cascade
        assert qd["recall_at_k_cascade_host"] == pytest.approx(
            qd["recall_at_k_cascade_device"], abs=0.1)
