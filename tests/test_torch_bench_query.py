"""The port's benchmark stages of the exact and quality paths
(``instsearch_torch/bench.py``) against the reference's
(``instsearch_tpu/bench.py``) on the CPU, at the toy arguments of the
reference's own smoke tests (``tests/bench/test_bench_smoke.py``).

Each reference stage runs once in a module fixture, each port stage once
with ``device="cpu"``. Held equal: the reference's keys are a subset of the
port's (``EXTRA`` lists the port's others, none here), and every field the
arguments fix (``FIXED``). The stores are drawn on the device by each
package's own generator, so recall and timing fields are not compared;
timings are only checked finite and positive, and the reference's own
assertions must hold for the port's output. ``bench_protocol_eval`` draws
its rows with numpy, the reference's numbers; every field it returns is an
argument or a time, and the rankings behind them (index, sharded, spliced)
are checked inside the stage, as the reference checks them.

The timing helpers (``marginal_times``, ``marginal_time``,
``interleaved_marginal``, ``_est_meta``) run against the reference's on one
scripted clock (``time.perf_counter`` monkeypatched to a fixed sequence):
their arrays must be equal. The stages of no smoke test
(``bench_extraction``, ``bench_extraction_e2e``, ``bench_query_e2e``,
``bench_sharded_overhead``, ``bench_dba``, ``bench_filtered_query``) run at
toy sizes on a ResNet-18 at 32 px, batch 2, and return the keys the
reference's lines give (the ResNet stages' chains cut short, their
call-site lengths checked).
"""
import math
import time

import numpy as np
import pytest
import torch

from instsearch_torch import bench as B
from instsearch_tpu import bench as RB

ARGS = {
    "query": dict(n=4096, d=64, k=5, q_batch=2),
    "qe": dict(n=4096, d=64, k=5, qe_n=3),
    "rerank": dict(n=2048, d=64, r=4, k=5, depth=32),
    "refine": dict(n=4096, d=64, depth=32, k=5),
    "diffusion": dict(n=4096, d=64, k=5, depth=32, knn=4, iters=3),
    "lw": dict(n=4096, d=64, e=8, depth=32, k=5),
    "protocol_eval": dict(n=2048, n_queries=8, d=64),
}
# the fields the arguments fix, which must be equal
FIXED = {
    "query": ("n", "d", "k", "q_batch", "reps"),
    "qe": ("n", "d", "k", "qe_n", "q_batch", "dtype", "scans", "reps"),
    "rerank": ("n", "d", "r", "depth", "k", "q_batch", "regional_dtype",
               "regional_gb", "gather_mb", "reps"),
    "refine": ("n", "d", "depth", "k", "q_batch", "bytes_per_component",
               "reps"),
    "diffusion": ("n", "d", "k", "depth", "knn", "iters", "q_batch", "reps"),
    "lw": ("n", "d", "e", "depth", "k", "q_batch", "bank_gb", "store_gb",
           "reps"),
    "protocol_eval": ("n", "n_queries", "d"),
}
# keys the port returns beyond the reference's, by stage (none on the CPU)
EXTRA = {name: set() for name in ARGS}
# the latency fields, finite and positive
TIMED = {name: ("p50_ms", "p99_ms", "qps") for name in ARGS}
TIMED["protocol_eval"] = ("full_ranking_sec", "full_ranking_warm_sec",
                          "splice_sec", "full_ranking_sharded_sec",
                          "full_ranking_sharded_warm_sec", "total_warm_sec")
STAGES = {"query": "bench_query", "qe": "bench_qe",
          "rerank": "bench_rerank", "refine": "bench_refine",
          "diffusion": "bench_diffusion", "lw": "bench_lw",
          "protocol_eval": "bench_protocol_eval"}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on a few cores: this
    module's small CPU tensors take one intra-op thread, restored
    afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    return {name: getattr(RB, STAGES[name])(**a) for name, a in ARGS.items()}


@pytest.fixture(scope="module")
def port():
    return {name: getattr(B, STAGES[name])(**a, device="cpu")
            for name, a in ARGS.items()}


def _finite_positive(x) -> bool:
    return math.isfinite(float(x)) and float(x) > 0


@pytest.mark.parametrize("name", sorted(ARGS))
def test_stage_matches_the_reference(ref, port, name):
    r, p = ref[name], port[name]
    assert set(r) <= set(p), set(r) - set(p)
    assert set(p) - set(r) == EXTRA[name]
    for key in FIXED[name]:
        assert p[key] == r[key], key
    for key in TIMED[name]:
        assert _finite_positive(p[key]), key
    if "spread_ms" in r:
        lo, hi = p["spread_ms"]
        assert _finite_positive(lo) and lo <= hi
        assert p["reps"] > 0


def test_query_paths_on_the_cpu():
    """A CPU run names its route ``plain`` for every store kind and for
    ``use_pallas=False``; the keys are the reference's."""
    want = set(RB.bench_query(n=1024, d=64, k=5))
    for kw in ({}, {"dtype": "int8"}, {"dtype": "int4"},
               {"use_pallas": False}, {"roofline": False, "hbm_bw": 1e9}):
        out = B.bench_query(n=1024, d=64, k=5, device="cpu", **kw)
        assert out["path"] == "plain", kw
        if "hbm_bw" in kw:      # the fallback roofline keys
            assert {"hbm_bw_gbps", "hbm_roofline_ms",
                    "frac_of_roofline"} <= set(out)
        else:
            assert set(out) == want


def test_stages_need_a_card_unless_asked(monkeypatch):
    """Without ``device`` a stage runs on the card, and without one it
    raises before any work; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, kw in ((B.bench_query, dict(n=256, d=16)),
                   (B.bench_pq, dict(n=256, d=16)),
                   (B.bench_train, dict(batch=1)),
                   (B.marginal_times, dict(make_chained=None, args=())),
                   (B.run_bench, dict(what="query"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(**kw)


class _Clock:
    """``time.perf_counter`` replaced by a fixed sequence of readings."""

    def __init__(self, seed: int):
        steps = np.random.default_rng(seed).uniform(0.001, 0.02, 400)
        self.readings = list(np.cumsum(steps))
        self.at = 0

    def __call__(self) -> float:
        self.at += 1
        return float(self.readings[self.at - 1])


def _on_clock(monkeypatch, seed, fn):
    clock = _Clock(seed)
    monkeypatch.setattr(time, "perf_counter", clock)
    out = fn()
    monkeypatch.undo()
    return out, clock.at


def _trivial(n):
    return lambda *a: 0.0


@pytest.mark.parametrize("helper,kw", [
    ("marginal_times", {}),
    ("marginal_times", dict(n1=4, n2=20, reps=9)),
    ("marginal_time", dict(n1=3, n2=15, reps=7)),
    ("interleaved_marginal", {}),
    ("interleaved_marginal", dict(n1=8, n2=136, reps=7)),
])
def test_timing_helpers_on_a_scripted_clock(monkeypatch, helper, kw):
    """The same clock readings give the same estimates, reading the clock
    as many times: the method (interleaved short and long chains, the
    short chain's median as anchor, the 1e-9 clamp) is the reference's."""
    if helper == "interleaved_marginal":
        specs = [(_trivial, ()), (_trivial, ())]
        calls = (lambda: RB.interleaved_marginal(specs, **kw),
                 lambda: B.interleaved_marginal(specs, device="cpu", **kw))
    else:
        calls = (lambda: getattr(RB, helper)(_trivial, (), **kw),
                 lambda: getattr(B, helper)(_trivial, (), device="cpu",
                                            **kw))
    want, n_want = _on_clock(monkeypatch, 3, calls[0])
    got, n_got = _on_clock(monkeypatch, 3, calls[1])
    assert n_got == n_want
    if helper == "interleaved_marginal":
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)
    # the clamp: a clock whose long chains read shorter than the anchor
    back = (lambda: RB.marginal_times(_trivial, (), n1=3, n2=5, reps=3),
            lambda: B.marginal_times(_trivial, (), n1=3, n2=5, reps=3,
                                     device="cpu"))
    for fn in back:
        monkeypatch.setattr(time, "perf_counter", iter(
            [0, 5, 0, 1, 0, 5, 0, 1, 0, 5, 0, 1]).__next__)
        assert (fn() == 1e-9).all()
        monkeypatch.undo()


def test_est_meta_matches_the_reference():
    for seed in range(3):
        e = np.random.default_rng(seed).uniform(1e-4, 5e-3, 9)
        assert B._est_meta(e) == RB._est_meta(e)


def test_stream_probe_on_the_cpu():
    """The roofline probe is a chained bf16 matrix-vector product; on the
    CPU ``measure_hbm_bw`` runs it (a rate, not the card's)."""
    x = torch.randn(64, 32).to(torch.bfloat16)
    q = torch.ones(1, 32, dtype=torch.bfloat16)
    got = B.make_stream_probe(3)(x, q)
    torch.testing.assert_close(got, torch.matmul(q, x.T))
    assert _finite_positive(B.measure_hbm_bw(1 << 16, device="cpu"))


# the keys each stage returns at toy size, from the reference's lines
TOY_KEYS = {
    # instsearch_tpu/bench.py:176-183
    "extraction": {"images_per_sec", "ms_per_batch", "batch", "image_size",
                   "backbone", "pooling", "scales"},
    # :270-282
    "extraction_e2e": {
        "images_per_sec_e2e", "wall_sec", "n_images", "image_size",
        "src_size", "backbone", "reps", "e2e_spread_img_s",
        "decode_images_per_sec_insitu", "host_to_device_mbps_sustained",
        "transfer_bound_images_per_sec",
        "serial_host_bound_images_per_sec", "frac_of_transfer_bound",
        "pipeline_efficiency"},
    # :1839-1844
    "query_e2e": {"p50_ms", "p99_ms", "n", "d", "k", "image_size",
                  "backbone", "pooling"},
    # :1727-1730
    "sharded_overhead": {"n", "d", "k", "q_batch", "sharded_p50_ms",
                         "plain_p50_ms", "overhead_ms", "overhead_frac"},
    # :707-710
    "dba": {"n", "d", "dba_n", "chunk", "per_chunk_ms", "rows_per_sec",
            "est_total_sec_1M"},
    # :473-484 (overhead_ratio when a rep pair is valid)
    "filtered": {"n", "d", "k", "subset_frac", "p50_ms",
                 "unfiltered_p50_ms", "overhead_ratio", "reps",
                 "spread_ms", "members_only"},
}
TINY = dict(image_size=32, backbone="resnet18")


# the chains of the ResNet stages as the reference's call sites give them
# (instsearch_tpu/bench.py:175, :1836), run at 1 and 2 calls over 2 reps
# here: a bf16 ResNet-18 forward takes tens of ms on one CPU thread, and
# the method itself is held to the reference's above
CHAINS = {"extraction": (4, 16, 7), "query_e2e": (3, 15, 7)}


@pytest.mark.parametrize("name,call", [
    ("extraction", lambda: B.bench_extraction(batch=2, device="cpu", **TINY)),
    ("extraction_e2e", lambda: B.bench_extraction_e2e(
        n_images=6, batch=2, src_size=48, device="cpu", **TINY)),
    ("query_e2e", lambda: B.bench_query_e2e(n=4096, d=64, device="cpu",
                                            **TINY)),
    ("sharded_overhead", lambda: B.bench_sharded_overhead(n=4096, d=64, k=5,
                                                          device="cpu")),
    ("dba", lambda: B.bench_dba(n=4096, d=64, device="cpu")),
    ("filtered", lambda: B.bench_filtered_query(n=4096, d=64, k=5,
                                                device="cpu")),
])
def test_stage_at_toy_size(monkeypatch, name, call):
    seen = []
    if name in CHAINS:
        timer = B.marginal_times

        def short(make_chained, args, n1, n2, reps=7, device=None,
                  wall=False):
            seen.append((n1, n2, reps))
            return timer(make_chained, args, 1, 2, 2, device=device,
                         wall=wall)
        monkeypatch.setattr(B, "marginal_times", short)
    out = call()
    if name in CHAINS:
        assert seen == [CHAINS[name]]
    assert set(out) == TOY_KEYS[name]
    for key in ("images_per_sec", "images_per_sec_e2e", "p50_ms",
                "sharded_p50_ms", "plain_p50_ms", "per_chunk_ms",
                "rows_per_sec"):
        if key in out:
            assert _finite_positive(out[key]), key
    if name == "extraction_e2e":
        assert out["n_images"] == 6 and out["reps"] == 3
        assert len(out["e2e_spread_img_s"]) == 3
    if name == "filtered":
        assert out["members_only"] is True
    if name == "dba":
        assert out["est_total_sec_1M"] == pytest.approx(
            out["per_chunk_ms"] / 1e3 * 4096 / 128)
