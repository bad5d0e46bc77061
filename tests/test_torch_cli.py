"""The port's command line (``instsearch_torch/cli.py``) on the CPU
(``--device cpu``), against the reference's (``instsearch_tpu/cli.py``).

Every subcommand runs through ``main`` on the mini fixture at 64 px in f32
(ResNet-18 for speed, 16 whitened dims): build-index plain, resumable and
with each view, update-index, merge-index, query, info, dedupe, evaluate
(``--weights``, ``--distractors``, ``--sharded``), serve over stdin (an
image index, sharded, and a host store with ``--adc-only``) and over TCP
as ``python -m instsearch_torch.cli``, workloads, finetune (with
``--fit-lw`` and ``--eval-dataset``) and its checkpoint read back by
``build-index --weights`` and ``evaluate --weights``; orbax weights refuse
with exit code 2 (``bench`` runs: ``test_torch_bench_cli.py``).

Against the reference, on the same inputs:
  * the subcommands and every option's spellings (``-h``), the port's
    adding ``--device`` alone;
  * build-index with ``--lw --pq --dba-n``: the output JSON equal but for
    ``out``;
  * ``evaluate --weights`` with one seeded torchvision-layout ``.pth`` the
    test writes: mAP within 0.01 points, and the per-query protocol ranks
    equal except where the reference's own scores of the two ids differ by
    less than NEAR_TIE (f32 descriptors of the two packages differ by the
    convolutions' summation order, ~1e-6);
  * info and dedupe over one index the port saved in the npz form: the JSON
    equal, the dedupe scores within 1e-5.
"""
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import instsearch_tpu.cli as jcli
import instsearch_tpu.eval.evaluate as jeval
import instsearch_torch.cli as tcli
import instsearch_torch.eval.evaluate as teval
import instsearch_torch.workloads as tworkloads
from instsearch_torch import IndexConfig, PipelineConfig
from instsearch_torch.eval import make_mini_dataset
from instsearch_torch.index import Index
from instsearch_torch.search.ivfpq import HostRowStore, IVFPQView

from parity.torch_models import BasicBlock, TruncatedResNet, randomize_bn_stats

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEAR_TIE = 1e-5
EXTRACT = {"backbone": "resnet18", "image_size": 64, "batch_size": 8,
           "dtype": "float32", "pooling": "gem"}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on a few cores: this
    module's small CPU tensors take one intra-op thread (no oversubscribed
    thread pools), restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_cfg(path, whiten=True, shards=1):
    cfg = {"extract": dict(EXTRACT, whiten=whiten, whiten_dim=16),
           "index": {"dtype": "float32", "row_tile": 8,
                     "num_shards": shards},
           "search": {"k": 5}}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def _run(main, capsys, *argv):
    """``main(argv)`` -> (exit code, stdout lines as JSON, stderr)."""
    rc = main(list(argv))
    out, err = capsys.readouterr()
    return rc, [json.loads(ln) for ln in out.splitlines() if ln.strip()], err


def port(capsys, *argv):
    return _run(tcli.main, capsys, "--device", "cpu", *argv)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    ds = make_mini_dataset(str(tmp / "data" / "mini"))
    cfg = _write_cfg(tmp / "cfg.json")
    idx = str(tmp / "idx")
    assert tcli.main(["--device", "cpu", "build-index", "--images",
                      ds.image_root, "--out", idx, "--config", cfg]) == 0
    return {"tmp": tmp, "ds": ds, "cfg": cfg, "idx": idx,
            "data": str(tmp / "data")}


def _help(capsys, main, *argv) -> str:
    with pytest.raises(SystemExit) as e:
        main([*argv, "-h"])
    assert e.value.code == 0
    return capsys.readouterr().out


def test_subcommands_and_options_match_the_reference(capsys):
    def spellings(text):
        return set(re.findall(r"(?<![\w-])(--?[a-z][\w-]*)", text))

    top = _help(capsys, tcli.main)
    cmds = re.search(r"\{([a-z,-]+)\}", top).group(1).split(",")
    assert cmds == re.search(r"\{([a-z,-]+)\}", _help(
        capsys, jcli.main)).group(1).split(",")
    assert len(cmds) == 11
    assert spellings(top) - spellings(_help(capsys, jcli.main)) == \
        {"--device"}
    for cmd in cmds:
        got = spellings(_help(capsys, tcli.main, cmd))
        want = spellings(_help(capsys, jcli.main, cmd))
        assert got - {"--device"} >= want and got - want <= {"--device"}, cmd


def test_build_index_variants(rig, capsys):
    tmp, ds, cfg = rig["tmp"], rig["ds"], rig["cfg"]
    base = ["build-index", "--images", ds.image_root, "--config", cfg]
    rc, out, _ = port(capsys, *base, "--out", str(tmp / "r"), "--resumable")
    assert rc == 0 and out == [{"indexed": 64, "quarantined": 0, "dim": 16,
                                "out": str(tmp / "r")}]
    for name in ("index.npz",):
        a, b = np.load(os.path.join(rig["idx"], name)), \
            np.load(str(tmp / "r" / name))
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert os.path.isfile(str(tmp / "r.build" / "manifest.json"))
    rc, out, _ = port(capsys, *base, "--out", str(tmp / "ivf"), "--ivf",
                      "--ivf-clusters", "4", "--nprobe", "2")
    assert rc == 0 and out[0]["ivf"]["clusters"] == 4
    assert set(out[0]["ivf"]) == {"clusters", "nprobe", "scan_fraction"}
    rc, out, _ = port(capsys, *base, "--out", str(tmp / "ivfpq"), "--ivfpq",
                      "--ivf-clusters", "4", "--nprobe", "2", "--pq-m", "4",
                      "--pq-depth", "16")
    assert rc == 0 and set(out[0]["ivfpq"]) == {
        "clusters", "nprobe", "m", "bytes_per_row", "depth", "opq",
        "anisotropic_t", "scan_fraction"}
    for flags in (["--ivf", "--pq"], ["--ivfpq", "--pq"],
                  ["--ivfpq", "--ivf"]):
        rc, out, err = port(capsys, *base, "--out", str(tmp / "no"), *flags)
        assert rc == 2 and out == [] and "mutually exclusive" in err
    rc, _, err = port(capsys, "build-index", "--images", str(tmp / "empty"),
                      "--out", str(tmp / "no"))
    assert rc == 2 and "no images" in err


def test_build_index_json_matches_the_reference(rig, capsys):
    tmp, ds, cfg = rig["tmp"], rig["ds"], rig["cfg"]
    flags = ["build-index", "--images", ds.image_root, "--config", cfg,
             "--lw", "--lw-clusters", "4", "--pq", "--pq-m", "4",
             "--pq-depth", "16", "--dba-n", "3"]
    rc, want, _ = _run(jcli.main, capsys, *flags, "--out", str(tmp / "j"))
    assert rc == 0
    rc, got, _ = port(capsys, *flags, "--out", str(tmp / "views"))
    assert rc == 0
    assert dict(got[0], out=None) == dict(want[0], out=None)
    # the saved index serves queries through its views
    q = ds.db_paths[3]
    for extra in ([], ["--pq-depth", "0"], ["--lw", "0"], ["--diffusion"]):
        rc, out, _ = port(capsys, "query", "--index", str(tmp / "views"),
                          "--image", q, "-k", "3", *extra)
        assert rc == 0 and out[0]["query"] == q
        assert len(out[0]["results"]) == 3


def test_query(rig, capsys):
    ds = rig["ds"]
    for i in (0, 9, 40):
        rc, out, _ = port(capsys, "query", "--index", rig["idx"], "--image",
                          ds.db_paths[i], "-k", "3")
        assert rc == 0
        res = out[0]["results"]
        assert [r["rank"] for r in res] == [0, 1, 2]
        assert res[0]["name"] == ds.imlist[i]
    names = ds.imlist[10:14]
    members = rig["tmp"] / "members.txt"
    members.write_text("\n".join(names) + "\n")
    for spec in (",".join(names), "@" + str(members)):
        rc, out, _ = port(capsys, "query", "--index", rig["idx"], "--image",
                          ds.db_paths[0], "-k", "10", "--subset", spec)
        assert rc == 0
        assert {r["name"] for r in out[0]["results"]} == set(names)
    rc, _, err = port(capsys, "query", "--index", rig["idx"], "--image",
                      str(rig["tmp"] / "missing.jpg"))
    assert rc == 2 and "cannot decode" in err


@pytest.fixture(scope="module")
def plain_index(tmp_path_factory):
    """An index the port saved in the npz form, no extractor: 64 seeded unit
    rows of 32 dims with three planted near-duplicate pairs and a triple."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    for a, b in ((3, 40), (10, 11), (20, 50), (50, 60)):
        x[b] = x[a] + 0.02 * rng.standard_normal(32).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    path = str(tmp_path_factory.mktemp("plain") / "idx")
    Index.from_descriptors(
        x, [f"img{i:03d}" for i in range(64)],
        PipelineConfig(index=IndexConfig(row_tile=8)), device="cpu").save(
            path)
    return path


def test_info_and_dedupe_match_the_reference(plain_index, capsys):
    rc, got, _ = port(capsys, "info", "--index", plain_index)
    rc2, want, _ = _run(jcli.main, capsys, "info", "--index", plain_index)
    assert rc == rc2 == 0 and got == want
    for extra in ([], ["--tau", "0.9", "-k", "4"],
                  ["--subset", ",".join(f"img{i:03d}" for i in range(0, 64,
                                                                      2))]):
        rc, got, _ = port(capsys, "dedupe", "--index", plain_index, *extra)
        rc2, want, _ = _run(jcli.main, capsys, "dedupe", "--index",
                            plain_index, *extra)
        assert rc == rc2 == 0
        got, want = got[0], want[0]
        for key in ("tau", "n_pairs", "n_groups", "groups"):
            assert got[key] == want[key], key
        assert [(p["a"], p["b"]) for p in got["pairs"]] == \
            [(p["a"], p["b"]) for p in want["pairs"]]
        np.testing.assert_allclose([p["score"] for p in got["pairs"]],
                                   [p["score"] for p in want["pairs"]],
                                   rtol=0, atol=1e-5)
    assert want["n_pairs"] >= 1


def _renamed_copies(ds, folder, picks, prefix):
    os.makedirs(folder, exist_ok=True)
    for i in picks:
        shutil.copy(ds.db_paths[i], os.path.join(folder, f"{prefix}{i}.jpg"))
    return folder


def test_update_and_merge_index(rig, capsys):
    """Unwhitened, so that two builds carry one extraction pipeline (a
    whitening fit on other images would refuse the merge, as there)."""
    tmp, ds = rig["tmp"], rig["ds"]
    cfg = _write_cfg(tmp / "nowhiten.json", whiten=False)
    base = str(tmp / "upd")
    assert port(capsys, "build-index", "--images", ds.image_root, "--config",
                cfg, "--out", base, "--ivf", "--ivf-clusters", "4",
                "--nprobe", "2")[0] == 0
    new = _renamed_copies(ds, str(tmp / "new"), (1, 2), "new")
    rc, out, _ = port(capsys, "update-index", "--index", base, "--add", new,
                      "--remove", ds.imlist[5], ds.imlist[6],
                      "--out", str(tmp / "upd2"))
    assert rc == 0 and out == [{"added": 2, "removed": 2, "rows": 64,
                                "out": str(tmp / "upd2")}]
    meta = json.load(open(str(tmp / "upd2" / "meta.json")))
    assert meta.get("ivf") and "new1" in meta["names"]
    assert ds.imlist[5] not in meta["names"]
    rc, out, _ = port(capsys, "query", "--index", str(tmp / "upd2"),
                      "--image", os.path.join(new, "new2.jpg"), "-k", "1")
    assert out[0]["results"][0]["name"] in ("new2", ds.imlist[2])
    donor = str(tmp / "donor")
    assert port(capsys, "build-index", "--images",
                _renamed_copies(ds, str(tmp / "don"), (7, 8, 9), "don"),
                "--config", cfg, "--out", donor)[0] == 0
    rc, out, _ = port(capsys, "merge-index", str(tmp / "upd2"), donor,
                      "--out", str(tmp / "merged"))
    assert rc == 0 and out == [{"indexes": 2, "merged": 3, "rows": 67,
                                "out": str(tmp / "merged"),
                                "views_refit": ["ivf"]}]
    with pytest.raises(KeyError, match="no-such-name"):   # as the reference
        port(capsys, "update-index", "--index", str(tmp / "upd2"),
             "--remove", "no-such-name")


def _serve_stdin(capsys, monkeypatch, lines, *argv):
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(json.dumps(ln) + "\n" for ln in lines)))
    rc, out, _ = port(capsys, "serve", *argv)
    assert rc == 0
    return out


def test_serve_stdin(rig, capsys, monkeypatch):
    ds = rig["ds"]
    reqs = [{"image": ds.db_paths[3], "k": 2},
            {"images": ds.db_paths[4:7]},
            {"image": "/nonexistent.jpg"},
            {"remove": [ds.imlist[3]]},
            {"image": ds.db_paths[3], "k": 2}]
    for sharded in ([], ["--sharded"]):
        out = _serve_stdin(capsys, monkeypatch, reqs, "--index", rig["idx"],
                           *sharded)
        ready = {"ready": True, "rows": 64, "dim": 16}
        if sharded:
            ready["shards"] = 1
        assert out[0] == ready and len(out) == len(reqs) + 1
        assert out[1]["results"][0][0]["name"] == ds.imlist[3]
        assert [r[0]["name"] for r in out[2]["results"]] == ds.imlist[4:7]
        assert "error" in out[3]
        assert out[4]["removed"] == 1 and out[4]["rows"] == 63
        assert all(e["name"] != ds.imlist[3] for e in out[5]["results"][0])


def test_serve_host_store(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((256, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    store = HostRowStore.create(str(tmp_path / "store"), x)
    IVFPQView.from_host_store(store, n_clusters=4, nprobe=4, m=4, depth=64,
                              device="cpu").save(str(tmp_path / "view"))
    reqs = [{"vectors": x[:3].tolist(), "k": 2}, {"add": ["x.jpg"]}]
    for adc in ([], ["--adc-only"]):
        out = _serve_stdin(capsys, monkeypatch, reqs, "--host-store",
                           str(tmp_path / "store"), "--ivfpq-view",
                           str(tmp_path / "view"), *adc)
        assert out[0]["ready"] and out[0]["mode"] == ("adc" if adc
                                                      else "cascade")
        assert [len(r) for r in out[1]["results"]] == [2, 2, 2]
        if not adc:     # the exact re-score; ADC alone ranks coarsely
            assert [r[0]["id"] for r in out[1]["results"]] == [0, 1, 2]
        assert "error" in out[2]
    rc, _, err = port(capsys, "serve", "--host-store", str(tmp_path))
    assert rc == 2 and "--ivfpq-view" in err
    rc, _, err = port(capsys, "serve")
    assert rc == 2 and "--index" in err


def test_serve_tcp_as_a_module(rig):
    """``python -m instsearch_torch.cli serve --port 0``: the ready line names
    the port; requests and an error line over one connection."""
    import socket
    proc = subprocess.Popen(
        [sys.executable, "-m", "instsearch_torch.cli", "serve", "--index",
         rig["idx"], "--port", "0", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=_ROOT)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["ready"] and ready["rows"] == 64
        with socket.create_connection(("127.0.0.1", ready["port"]),
                                      timeout=60) as s:
            f = s.makefile("rw")
            for i in (2, 30):
                f.write(json.dumps({"image": rig["ds"].db_paths[i],
                                    "k": 1}) + "\n")
                f.flush()
                r = json.loads(f.readline())
                assert r["results"][0][0]["name"] == rig["ds"].imlist[i]
                assert r["batch_rows"] == 1
            f.write("{bad\n")
            f.flush()
            assert "error" in json.loads(f.readline())
    finally:
        proc.kill()
        proc.wait(timeout=30)


def _recording(monkeypatch, module, seen):
    real_eval, real_build = module.evaluate_index, \
        module.build_index_for_dataset

    def evaluate(*a, **kw):
        res = real_eval(*a, **dict(kw, include_ranks=True))
        seen["ranks"] = res.pop("ranks")
        return res

    def build(*a, **kw):
        seen["index"] = real_build(*a, **kw)
        return seen["index"]

    monkeypatch.setattr(module, "evaluate_index", evaluate)
    monkeypatch.setattr(module, "build_index_for_dataset", build)


def test_evaluate_torchvision_weights_match_the_reference(
        rig, capsys, monkeypatch):
    torch.manual_seed(0)
    sd = randomize_bn_stats(TruncatedResNet(layers=(2, 2, 2, 2),
                                            block=BasicBlock)).state_dict()
    g = torch.Generator().manual_seed(1)
    sd["fc.weight"] = torch.randn(10, 512, generator=g)
    sd["fc.bias"] = torch.randn(10, generator=g)
    pth = str(rig["tmp"] / "resnet18.pth")
    torch.save(sd, pth)
    cfg = _write_cfg(rig["tmp"] / "eval.json", whiten=False)
    argv = ["evaluate", "--config", cfg, "--dataset", "mini", "--data-root",
            rig["data"], "--protocol", "medium", "--weights", pth]
    jseen, tseen = {}, {}
    _recording(monkeypatch, jeval, jseen)
    _recording(monkeypatch, teval, tseen)
    rc, want, _ = _run(jcli.main, capsys, *argv)
    assert rc == 0
    rc, got, _ = port(capsys, *argv)
    assert rc == 0
    got, want = got[0], want[0]
    assert set(got) == set(want)
    assert abs(got["mAP"] - want["mAP"]) <= 0.01
    for key in ("dataset", "protocol", "stages_applied", "num_queries"):
        assert got[key] == want[key]
    # ranks: equal but where the reference scores the two ids alike
    jidx = jseen["index"]
    q = np.asarray(jeval.extract_queries(jidx, rig["ds"]), np.float32)
    rows = np.asarray(jidx.descriptors, np.float32)
    ids = np.asarray(jidx.ids)
    scores = {int(i): q @ rows[p] for p, i in enumerate(ids) if i >= 0}
    jr, tr = jseen["ranks"], tseen["ranks"]
    assert jr.shape == tr.shape
    for qi, pos in zip(*np.nonzero(jr != tr)):
        a, b = int(jr[qi, pos]), int(tr[qi, pos])
        assert abs(scores[a][qi] - scores[b][qi]) < NEAR_TIE, (qi, pos)


def test_evaluate_distractors_and_sharded(rig, capsys):
    ds = rig["ds"]
    extra = _renamed_copies(ds, str(rig["tmp"] / "flickr"), (0, 1, 2), "d")
    cfg = _write_cfg(rig["tmp"] / "two.json", shards=2)
    base = ["evaluate", "--config", cfg, "--dataset", "mini", "--data-root",
            rig["data"], "--protocol", "medium"]
    rc, one, _ = port(capsys, *base, "--distractors", extra)
    assert rc == 0 and one[0]["dataset"] == "mini+3distractors"
    rc, two, _ = port(capsys, *base, "--distractors", extra, "--sharded")
    assert rc == 0 and two[0]["sharded"] is True
    assert two[0]["num_shards"] == 2 and two[0]["mAP"] == one[0]["mAP"]


def test_workloads_subcommand(rig, capsys, monkeypatch):
    monkeypatch.setattr(tworkloads, "list_presets",
                        lambda: ["oxford5k_resnet50_avgpool"])
    rc, out, _ = port(capsys, "workloads", "--data-root", rig["data"])
    assert rc == 0 and len(out) == 1
    assert out[0]["workload"] == "oxford5k_resnet50_avgpool"
    assert out[0]["num_images"] == len(rig["ds"].imlist)
    assert 0 <= out[0]["mAP"] <= 100


@pytest.mark.parametrize("argv,item", [
    (["evaluate", "--weights", "finetuned_checkpoint"], "M10"),
])
def test_refusals(capsys, argv, item):
    rc, out, err = port(capsys, *argv)
    assert rc == 2 and out == []
    # an orbax tree (once M10's reader) is refused naming the converter
    assert {"M10": "tools/orbax_to_port.py"}[item] in err


@pytest.fixture(scope="module")
def tuned(rig, tmp_path_factory):
    """``finetune`` over a labelled tree of the mini fixture's instances
    (one subdirectory each, their database views) at 32 px, Smooth-AP,
    with ``--fit-lw`` and the tuned-versus-frozen report on the mini
    fixture: (report, checkpoint path)."""
    tree = tmp_path_factory.mktemp("tree")
    for name in rig["ds"].imlist:
        if name.startswith("inst"):
            os.makedirs(tree / name[:6], exist_ok=True)
            shutil.copy(rig["ds"].image_path(name), tree / name[:6])
    ckpt = str(tree.parent / "tuned")
    out = io.StringIO()
    argv = ["--device", "cpu", "finetune", "--images", str(tree), "--out",
            ckpt, "--backbone", "resnet18", "--image-size", "32",
            "--batch-size", "4", "--num-negatives", "2", "--loss",
            "smoothap", "--fit-lw", "--eval-dataset", "mini",
            "--eval-data-root", rig["data"]]
    from contextlib import redirect_stdout
    with redirect_stdout(out):
        assert tcli.main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), ckpt


def _tuned_cfg(rig):
    path = rig["tmp"] / "cfg32.json"
    with open(path, "w") as f:
        json.dump({"extract": dict(EXTRACT, image_size=32, batch_size=16),
                   "index": {"dtype": "float32", "row_tile": 8},
                   "search": {"k": 5}}, f)
    return str(path)


def test_finetune_subcommand(rig, tuned, capsys):
    """The report carries the reference's keys; the checkpoint and its
    sidecars are written; the frozen mAP is the mAP ``evaluate`` gives the
    seeded weights the run started from, the tuned one the mAP ``evaluate
    --weights`` gives the checkpoint."""
    report, ckpt = tuned
    assert set(report) == {"steps", "final_loss", "gem_p", "out", "meta",
                           "eval_dataset", "eval_protocol", "frozen_mAP",
                           "tuned_mAP", "lift"}
    assert report["gem_p"] == 3.0 and np.isfinite(report["final_loss"])
    assert os.path.isfile(os.path.join(ckpt, "torch_weights.pt"))
    assert os.path.isfile(ckpt + ".whitening.npz")
    base = ["evaluate", "--config", _tuned_cfg(rig), "--dataset", "mini",
            "--data-root", rig["data"], "--protocol", "medium"]
    rc, frozen, _ = port(capsys, *base)
    assert rc == 0 and round(frozen[0]["mAP"], 2) == report["frozen_mAP"]
    rc, tuned_map, _ = port(capsys, *base, "--weights", ckpt)
    assert rc == 0 and round(tuned_map[0]["mAP"], 2) == report["tuned_mAP"]
    assert report["lift"] == pytest.approx(
        report["tuned_mAP"] - report["frozen_mAP"], abs=0.011)


def test_build_index_weights_subcommand(rig, tuned, capsys):
    """``build-index --weights`` takes the sidecar's image size and Lw
    whitening (the index's width is the whitening's, one row fewer than
    the training pairs) and stores the tuned backbone."""
    _, ckpt = tuned
    out = str(rig["tmp"] / "idx_tuned")
    rc, res, _ = port(capsys, "build-index", "--images",
                      rig["ds"].image_root, "--out", out, "--config",
                      rig["cfg"], "--weights", ckpt)
    assert rc == 0
    lw = np.load(ckpt + ".whitening.npz")
    views = sum(n.startswith("inst") for n in rig["ds"].imlist)
    per = views // len({n[:6] for n in rig["ds"].imlist
                        if n.startswith("inst")})
    assert res[0]["dim"] == lw["P"].shape[0] == views * (per - 1) - 1
    idx = Index.load(out, device="cpu")
    assert idx.cfg.extract.image_size == 32
    np.testing.assert_array_equal(idx.extractor.whitening.P.numpy(),
                                  lw["P"])
    tuned = torch.load(os.path.join(ckpt, "torch_weights.pt"))
    got = idx.extractor.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in tuned.items())


@pytest.mark.parametrize("argv", [
    ["info", "--index", "x"], ["dedupe", "--index", "x"],
    ["query", "--index", "x", "--image", "y"], ["serve", "--index", "x"],
    ["build-index", "--images", "x", "--out", "y"], ["workloads"],
    ["evaluate"], ["update-index", "--index", "x"],
    ["merge-index", "x", "--out", "y"],
    ["finetune", "--images", "x", "--out", "y"],
])
def test_no_card_without_device_exits_nonzero(capsys, monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = tcli.main(argv)
    _, err = capsys.readouterr()
    assert rc == 2 and "no CUDA device" in err
