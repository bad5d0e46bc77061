"""Fine-tuning end to end: ``train/finetune.py::finetune`` against the
reference's on one labelled tree (3 classes x 4 views of PNG files at 32²,
the tree of tests/integration/test_finetune_flow.py), and the command line
round trip ``finetune`` -> ``build-index --weights`` -> ``Index.load`` ->
``query`` with the ``gem_p`` and Lw sidecars applied (that file's
``test_cli_finetune_then_build_index_weights``).

Both ``finetune`` runs start from the same ResNet-18 weights (f32, the GeM
exponent learned, two epochs of two steps) and record what they mine (the
mining function wrapped in each module). Held to the reference:
  * the negatives mined in every epoch: equal;
  * the step losses: within 1e-3 relative (the reference's bar for its
    later data-parallel steps), the learned exponent within 1e-4;
  * the Lw whitening fitted on the final weights (every dimension, 35 =
    pairs - 1 rows): ``mu`` within 1e-4; Lw makes the within-class scatter
    isotropic, so past the 2 between-class directions (classes - 1) the
    eigenvalues are near-equal and the rows any basis of their space: the
    first 2 rows up to their sign within 2e-2 of the row's largest entry,
    and the whitened Gram matrix of the pool (every pool image is an
    anchor, so its whitened vector lies in the fitted span whatever its
    basis) within 1e-2 of its largest entry. The two final networks'
    descriptors differ by ~1e-6 (measured), which Lw's inverse square root
    amplifies by up to 100 (its floor).
"""
import json
import os

import cv2
import numpy as np
import pytest
import torch

import instsearch_tpu.train.finetune as jft
from instsearch_tpu.config import TrainConfig as JaxTrainConfig
from instsearch_tpu.models import load_torch_resnet
import instsearch_torch.train.finetune as tft
from instsearch_torch import ExtractConfig, PipelineConfig
from instsearch_torch.cli import main
from instsearch_torch.config import TrainConfig
from instsearch_torch.data import frontend
from instsearch_torch.index import Index
from instsearch_torch.models import get_backbone

KW = dict(backbone="resnet18", pooling="gem", image_size=32, batch_size=3,
          num_negatives=1, dtype="float32", lr=1e-4, learn_gem_p=True)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small CPU tensors in a suite of several worker processes: one
    intra-op thread, restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_tree(root, rng, classes=3, views=4):
    """``root/class{c}/v{v}.png``: a smooth 32² pattern per class, views
    with pixel noise."""
    for c in range(classes):
        d = root / f"class{c}"
        os.makedirs(d)
        base = cv2.resize(rng.random((8, 8, 3), np.float32), (32, 32),
                          interpolation=cv2.INTER_CUBIC)
        for v in range(views):
            img = np.clip(base + rng.normal(0, 0.05, base.shape), 0, 1)
            cv2.imwrite(str(d / f"v{v}.png"), (img * 255).astype(np.uint8))


def _labelled(root):
    paths, labels = [], []
    for li, sub in enumerate(sorted(os.listdir(root))):
        for f in sorted(os.listdir(root / sub)):
            paths.append(str(root / sub / f))
            labels.append(li)
    return paths, np.asarray(labels)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetune") / "train"
    _write_tree(root, np.random.default_rng(23))
    return root


@pytest.fixture(scope="module")
def runs(tree):
    """Both packages' ``finetune`` from the same weights, what each mined."""
    paths, labels = _labelled(tree)
    gen = torch.Generator().manual_seed(0)
    net = get_backbone("resnet18", dtype=torch.float32,
                       device="cpu")[0].init_weights(gen)
    flax = load_torch_resnet({k: v.numpy()
                              for k, v in net.state_dict().items()})
    out = {}
    for name, module, cfg, extra in (
            ("jax", jft, JaxTrainConfig(**KW), {}),
            ("port", tft, TrainConfig(**KW), {"device": "cpu"})):
        mined = []
        with pytest.MonkeyPatch.context() as mp:
            mine = module.mine_hard_negatives

            def record(*a, _mine=mine, **k):
                mined.append(_mine(*a, **k))
                return mined[-1]

            mp.setattr(module, "mine_hard_negatives", record)
            res = module.finetune(paths, labels, cfg, epochs=2,
                                  steps_per_epoch=2, seed=0, variables=flax,
                                  fit_lw=True, **extra)
        out[name] = res, mined
    return out


def test_same_negatives_and_losses(runs):
    (jres, jmined), (tres, tmined) = runs["jax"], runs["port"]
    assert len(tmined) == len(jmined) == 2
    for t, j in zip(tmined, jmined):
        np.testing.assert_array_equal(t, j)
    assert len(tres["losses"]) == 4
    assert tres["losses"] == pytest.approx(jres["losses"], rel=1e-3)
    assert tres["gem_p"] == pytest.approx(jres["gem_p"], abs=1e-4)
    assert tres["gem_p"] != 3.0
    assert "gem_p" not in tres["variables"]
    assert set(tres) == set(jres)


def test_lw_whitening_matches_up_to_sign(runs, tree):
    jw, tw = runs["jax"][0]["whitening"], runs["port"][0]["whitening"]
    jp, tp = np.asarray(jw.P), tw.P.numpy()
    assert tp.shape == jp.shape == (35, 512)
    np.testing.assert_allclose(tw.mu.numpy(), np.asarray(jw.mu), atol=1e-4)
    for w, g in zip(jp[:2], tp[:2]):
        sign = np.sign(np.dot(w, g))
        np.testing.assert_allclose(sign * g, w, atol=2e-2 * np.abs(w).max())
    ex_cfg = ExtractConfig(backbone="resnet18", image_size=32,
                           gem_p=runs["port"][0]["gem_p"], dtype="float32")
    from instsearch_torch.extractor import Extractor
    pool, _ = Extractor(ex_cfg, variables=runs["port"][0]["variables"],
                        device="cpu").extract_paths(_labelled(tree)[0])

    def gram(P, mu):
        w = (pool - np.asarray(mu)) @ np.asarray(P).T
        return w @ w.T

    want = gram(jp, jw.mu)
    np.testing.assert_allclose(gram(tp, tw.mu.numpy()), want,
                               atol=1e-2 * np.abs(want).max())


def test_cli_finetune_then_build_index_weights(tree, tmp_path, capsys):
    """``finetune`` writes the checkpoint directory and its sidecars;
    ``build-index --weights`` applies the tuned ``gem_p`` and the Lw
    whitening, and ``Index.load`` reproduces both."""
    ckpt = str(tmp_path / "tuned")
    assert main(["--device", "cpu", "finetune", "--images", str(tree),
                 "--out", ckpt, "--backbone", "resnet18", "--image-size",
                 "32", "--epochs", "1", "--batch-size", "3",
                 "--num-negatives", "1", "--learn-p", "--fit-lw"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["steps"] == 36 // 3 and report["meta"] == ckpt + ".meta.json"
    assert os.path.isfile(os.path.join(ckpt, "torch_weights.pt"))
    with open(ckpt + ".meta.json") as fh:
        meta = json.load(fh)
    assert meta["backbone"] == "resnet18" and meta["image_size"] == 32
    assert meta["gem_p"] == report["gem_p"] != 3.0
    assert meta["whitening"] == os.path.abspath(ckpt + ".whitening.npz")
    lw = np.load(ckpt + ".whitening.npz")

    rng = np.random.default_rng(5)
    db = tmp_path / "db"
    os.makedirs(db)
    for i in range(5):
        img = cv2.resize(rng.random((8, 8, 3), np.float32), (32, 32),
                         interpolation=cv2.INTER_CUBIC)
        cv2.imwrite(str(db / f"img{i}.png"), (img * 255).astype(np.uint8))
    cfgp = tmp_path / "cfg.json"
    PipelineConfig(extract=ExtractConfig(
        backbone="resnet50", image_size=64, dtype="float32", batch_size=4,
        gem_p=3.0)).save(str(cfgp))
    out_idx = str(tmp_path / "idx")
    assert main(["--device", "cpu", "build-index", "--images", str(db),
                 "--out", out_idx, "--config", str(cfgp), "--weights",
                 ckpt]) == 0
    built = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert built["dim"] == lw["P"].shape[0]

    loaded = Index.load(out_idx, device="cpu")
    assert loaded.cfg.extract.gem_p == pytest.approx(meta["gem_p"])
    assert (loaded.cfg.extract.backbone, loaded.cfg.extract.image_size) == (
        "resnet18", 32)                       # the sidecar's, not cfg.json's
    np.testing.assert_array_equal(loaded.extractor.whitening.P.numpy(),
                                  lw["P"])
    tuned = torch.load(os.path.join(ckpt, "torch_weights.pt"))
    got = loaded.extractor.model.state_dict()
    for k, v in tuned.items():
        assert torch.equal(got[k].float(), v), k
    img = frontend.load_square(str(db / "img0.png"), 32)
    _, ids = loaded.query_images(img[None])
    assert int(ids[0, 0]) == 0

    # a recorded whitening sidecar that is gone fails the build
    os.remove(ckpt + ".whitening.npz")
    assert main(["--device", "cpu", "build-index", "--images", str(db),
                 "--out", str(tmp_path / "idx2"), "--config", str(cfgp),
                 "--weights", ckpt]) == 2
    assert "whitening sidecar" in capsys.readouterr().err
