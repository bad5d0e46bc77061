"""The port's raw-vector walkthroughs, ``examples/torch_vector_ops.py`` and
``examples/torch_capacity_serving.py``, against the reference's
``examples/vector_ops.py`` and ``examples/capacity_serving.py``.

Each port script runs with ``--device cpu`` in a fresh interpreter whose
``sys.modules["jax"]`` is None, so any import of JAX (or of
``instsearch_tpu``, which imports it) fails; the reference scripts run in
this process on the same seeds. The printed lines are compared:
  * vector ops: top-1 ids, range counts, duplicate groups and ``stats``
    equal; the top-1 scores (rounded to 3 places by both) equal; the l2
    nearest distances within 1e-4 (the f32 sums of the augmented rows
    differ in order; the printed values are rounded to 4 places, so one
    rounding step apart at most);
  * capacity serving, cascade and ``--adc-only``: ``ready_info`` equal and
    the self-match (row 7) first in both. The cascade re-scores its
    candidates exactly from the same int8 host rows, so its three ids are
    equal and its scores within 1e-6. ``--adc-only`` ranks by the PQ
    approximation of codebooks each package fits itself (the same bf16
    Lloyd steps; tests/test_torch_ivfpq.py holds the fits within recall
    0.02), so only the self-match's ADC score is compared, within 5e-3
    (2.3e-4 apart on this seed, on this CPU: the two fits' codebooks
    differ in their bf16 roundings, not in their algorithm).
The scripts raise without a CUDA card unless ``--device cpu`` is given
(``torch.cuda.is_available`` patched to False, in this process).
"""
import json
import os

import numpy as np
import pytest
import torch

from torch_example_runner import _EXAMPLES, run_port, run_reference

def _after(lines: list[str], prefix: str) -> str:
    hit = [ln[len(prefix):].strip() for ln in lines if ln.startswith(prefix)]
    assert len(hit) == 1, (prefix, lines)
    return hit[0]


def _lists(text: str) -> list:
    """``[a, b] word: [c, d]`` -> the bracketed lists, parsed."""
    out, depth, start = [], 0, None
    for i, c in enumerate(text):
        if c == "[":
            depth += 1
            start = i if depth == 1 else start
        elif c == "]":
            depth -= 1
            if depth == 0:
                out.append(json.loads(text[start:i + 1].replace("'", '"')))
    return out


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The reference runs in this worker process: one intra-op thread for
    torch here, restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_vector_ops_matches_the_reference():
    got = run_port("torch_vector_ops", ["--device", "cpu"])
    want = run_reference("vector_ops", [])
    ids, scores = _lists(_after(got, "top-1:"))
    wids, wscores = _lists(_after(want, "top-1:"))
    assert ids == wids == [0, 1, 2]
    assert scores == wscores
    assert _lists(_after(got, "range counts @0.5:")) == \
        _lists(_after(want, "range counts @0.5:"))
    assert _lists(_after(got, "duplicate groups:")) == \
        _lists(_after(want, "duplicate groups:")) == [[["im7", "im100"]]]
    assert json.loads(_after(got, "stats:")) == \
        json.loads(_after(want, "stats:"))
    assert float(_after(got, "reconstruct cos:")) == pytest.approx(
        float(_after(want, "reconstruct cos:")), abs=1e-6)
    np.testing.assert_allclose(_lists(_after(got, "l2 nearest dist:"))[0],
                               _lists(_after(want, "l2 nearest dist:"))[0],
                               rtol=0, atol=1e-4 + 1e-7)
    assert _lists(_after(got, "rows within radius 5.0:")) == \
        _lists(_after(want, "rows within radius 5.0:"))


def _serving(lines: list[str]) -> tuple[dict, list]:
    """(ready_info, the query's results) from a capacity run's lines."""
    ready = next(json.loads(ln) for ln in lines if ln.startswith(
        '{"ready"'))
    resp = next(json.loads(ln) for ln in lines if ln.startswith(
        '{"results"'))
    return ready, resp["results"][0]


@pytest.mark.parametrize("mode", ["cascade", "adc-only"])
def test_capacity_serving_matches_the_reference(mode, tmp_path):
    flags = ["--adc-only"] if mode == "adc-only" else []
    got = run_port("torch_capacity_serving", ["--device", "cpu", "--workdir",
                                              str(tmp_path / "port")] + flags)
    want = run_reference("capacity_serving", ["--workdir",
                                              str(tmp_path / "ref")] + flags)
    ready, res = _serving(got)
    wready, wres = _serving(want)
    assert ready == wready
    assert res[0]["id"] == wres[0]["id"] == 7
    if mode == "cascade":
        assert [r["id"] for r in res] == [r["id"] for r in wres]
        np.testing.assert_allclose([r["score"] for r in res],
                                   [r["score"] for r in wres], atol=1e-6)
    else:
        assert abs(res[0]["score"] - wres[0]["score"]) < 5e-3
    daemon = got[got.index("daemon form:") + 1].split()
    assert daemon[:4] == ["python", "-m", "instsearch_torch.cli", "serve"]
    assert ("--adc-only" in daemon) == (mode == "adc-only")
    assert os.path.isdir(tmp_path / "port" / "view")


@pytest.mark.parametrize("name", ["torch_vector_ops",
                                  "torch_capacity_serving",
                                  "torch_end_to_end"])
def test_walkthrough_needs_the_card_or_device_cpu(name, monkeypatch,
                                                  tmp_path):
    """Without ``--device`` a walkthrough runs on the card; with no card it
    raises before any work, and never falls back to the CPU."""
    import runpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = runpy.run_path(os.path.join(_EXAMPLES, f"{name}.py"))["main"]
    argv = ["--workdir", str(tmp_path)] if name != "torch_vector_ops" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not os.listdir(tmp_path)
