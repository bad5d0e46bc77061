"""``cli bench`` and ``run_bench`` of the port (``instsearch_torch/cli.py``,
``instsearch_torch/bench.py``) on the CPU.

  * ``run_bench``'s groups against the reference's: every ``bench_*`` stage
    of both modules replaced by a recorder, each group must call the same
    stages with the same arguments in the same order and return the
    reference's keys, the port's adding ``kernel_launches`` (and on the
    card ``peak_gib``);
  * ``python -m instsearch_torch.cli --device cpu bench --what query``
    through ``main`` with the stages at toy sizes (their defaults patched:
    4,096 x 64 stores, ResNet-18 at 32 px; of the call sites' arguments,
    dtype kept, ``q_batch`` capped at 4 and the sweep's rows cut 64-fold):
    one JSON line with ``platform``, ``counters`` and every stage's keys;
  * ``--trace`` writes a ``torch.profiler`` trace, ``--tensorboard``
    scalars;
  * without ``--device`` and without a card, ``bench`` exits with code 2
    and the "no CUDA device" error, and runs nothing;
  * ``bench_train`` at toy size (ResNet-18, 32 px, batch 2, its chains
    cut short) returns the reference's keys.
"""
import glob
import json
import math
import os

import pytest
import torch

from instsearch_torch import bench as B
from instsearch_torch import cli as tcli
from instsearch_tpu import bench as RB


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on a few cores: this
    module's small CPU tensors take one intra-op thread, restored
    afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stages(module) -> list:
    return [name for name in dir(module) if name.startswith("bench_")]


def test_both_modules_have_the_same_stages():
    assert _stages(B) == _stages(RB)
    assert len(_stages(B)) == 20


def _recorded_run(monkeypatch, module, what: str, **kw):
    calls = []
    for name in _stages(module):
        def stage(*args, _name=name, **kwargs):
            kwargs.pop("device", None)
            calls.append((_name, args, kwargs))
            return {"stage": _name}
        monkeypatch.setattr(module, name, stage)
    out = module.run_bench(what, **kw)
    monkeypatch.undo()
    return calls, out


@pytest.mark.parametrize("what", ["extraction", "query", "all", "extended"])
def test_run_bench_groups_match_the_reference(monkeypatch, what):
    want_calls, want = _recorded_run(monkeypatch, RB, what)
    got_calls, got = _recorded_run(monkeypatch, B, what, device="cpu")
    assert got_calls == want_calls
    assert set(got) - set(want) == {"kernel_launches"}
    assert set(want) - set(got) == set()
    assert got["platform"] == "cpu"
    for key, v in want.items():
        if key not in ("platform", "device"):
            assert got[key] == v, key
    # one launch record a stage, none on the CPU
    assert all(v == {} for v in got["kernel_launches"].values())


# the stages at toy sizes: their defaults patched; of the call sites'
# arguments, dtype kept, q_batch capped at 4 and the sweep's n cut 64-fold
TOY = {
    "bench_query": dict(n=4096, d=64),
    "bench_filtered_query": dict(n=4096, d=64),
    "bench_query_e2e": dict(n=4096, d=64, image_size=32,
                            backbone="resnet18"),
    "bench_qe": dict(n=4096, d=64, qe_n=3),
    "bench_rerank": dict(n=2048, d=64, r=4, depth=32),
    "bench_diffusion": dict(n=4096, d=64, depth=32, knn=4, iters=3),
    "bench_refine": dict(n=4096, d=64, depth=32),
    "bench_lw": dict(n=4096, d=64, e=8, depth=32),
    "bench_sharded_overhead": dict(n=4096, d=64),
    "bench_protocol_eval": dict(n=2048, n_queries=8, d=64),
}
# instsearch_tpu/bench.py:1891-1916, the 'query' group's keys
QUERY_KEYS = {"query", "query_b128", "query_int8", "query_int8_b128",
              "query_int4", "query_int4_b128", "query_filtered", "query_e2e",
              "query_sweep", "qe", "qe_b128", "rerank", "rerank_b32",
              "diffusion", "refine", "lw", "lw_b32", "sharded_overhead",
              "protocol_eval_105k"}


def _toy_stages(monkeypatch):
    for name, kw in TOY.items():
        fn = getattr(B, name)

        def toy(*a, _fn=fn, _kw=kw, **k):
            if "q_batch" in k:
                k["q_batch"] = min(k["q_batch"], 4)
            if "n" in k:
                k["n"] //= 64
            return _fn(*a, **{**_kw, **k})
        monkeypatch.setattr(B, name, toy)


def _main(capsys, *argv):
    rc = tcli.main(list(argv))
    out, err = capsys.readouterr()
    return rc, [ln for ln in out.splitlines() if ln.strip()], err


def test_cli_bench_query_group(monkeypatch, capsys):
    _toy_stages(monkeypatch)
    rc, lines, err = _main(capsys, "--device", "cpu", "bench", "--what",
                           "query")
    assert rc == 0 and len(lines) == 1
    out = json.loads(lines[0])
    assert out["platform"] == "cpu" and out["device"] == "cpu"
    assert QUERY_KEYS <= set(out)
    assert "hbm_bw_gbps" not in out          # the probe runs on the card
    assert isinstance(out["counters"], dict) and "elapsed_sec" in \
        out["counters"]
    assert [s["n"] for s in out["query_sweep"]] == [1024, 4096, 4096]
    assert out["query_b128"]["q_batch"] == 4
    for key in QUERY_KEYS - {"query_sweep", "protocol_eval_105k",
                             "sharded_overhead"}:
        assert math.isfinite(out[key]["p50_ms"]) and out[key]["p50_ms"] > 0
    for key in ("query", "query_int8", "query_int4"):
        assert out[key]["path"] == "plain"
    assert set(out["kernel_launches"]) >= QUERY_KEYS - {"query_sweep"}
    # one progress line a stage on stderr
    stages = [json.loads(ln)["stage"] for ln in err.splitlines()
              if ln.startswith("{")]
    assert len(stages) == len(out["kernel_launches"])


def test_cli_bench_trace_and_tensorboard(monkeypatch, capsys, tmp_path):
    def tiny(what, device):
        return {"platform": device.type,
                "query": B.bench_query(n=1024, d=32, k=5, device=device)}
    monkeypatch.setattr(B, "run_bench", tiny)
    trace, tb = str(tmp_path / "trace"), str(tmp_path / "tb")
    rc, lines, _ = _main(capsys, "--device", "cpu", "bench", "--trace",
                         trace, "--tensorboard", tb)
    assert rc == 0 and len(lines) == 1
    out = json.loads(lines[0])
    assert out["trace_dir"] == trace and out["tensorboard_dir"] == tb
    assert glob.glob(os.path.join(trace, "*.pt.trace.json"))
    events = glob.glob(os.path.join(tb, "events.out.tfevents.*"))
    assert events and os.path.getsize(events[0]) > 0


def test_cli_bench_needs_a_card(monkeypatch, capsys):
    """Without ``--device`` and without a card, ``bench`` refuses like every
    other subcommand and runs no stage on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*a, **k):
        raise AssertionError("a stage ran")
    monkeypatch.setattr(B, "run_bench", never)
    rc, lines, err = _main(capsys, "bench", "--what", "query")
    assert rc == 2 and lines == []
    assert "no CUDA device" in err


def test_bench_train_at_toy_size(monkeypatch):
    """The stage at toy size, its chains cut to 1 and 2 steps over 2 reps
    (the method is held to the reference's in test_torch_bench_query.py;
    a bf16 step of ResNet-18 takes ~0.3 s on one CPU thread)."""
    timer = B.marginal_times
    seen = {}

    def short(make_chained, args, n1, n2, reps, device, wall):
        seen.update(n1=n1, n2=n2, reps=reps, wall=wall)
        return timer(make_chained, args, 1, 2, 2, device, wall)
    monkeypatch.setattr(B, "marginal_times", short)
    out = B.bench_train(batch=2, negs=1, image_size=32, backbone="resnet18",
                        device="cpu")
    # the reference's chains (instsearch_tpu/bench.py:1875), on the host's
    # clock: Trainer.step reads its loss
    assert seen == dict(n1=3, n2=11, reps=5, wall=True)
    # instsearch_tpu/bench.py:1878-1881
    assert set(out) == {"steps_per_sec", "step_ms", "tuple_images_per_sec",
                        "batch", "tuple", "image_size", "backbone"}
    assert out["tuple"] == 3 and out["batch"] == 2
    assert math.isfinite(out["step_ms"]) and out["step_ms"] > 0
    assert out["tuple_images_per_sec"] == pytest.approx(
        6 / (out["step_ms"] / 1e3))
