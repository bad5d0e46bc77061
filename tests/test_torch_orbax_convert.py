"""``tools/orbax_to_port.py``: what the JAX package writes in orbax form,
converted into the port's forms and read by the port.

One module-scoped fixture saves four JAX indexes with a ResNet-18 extractor
(f32 at 64 px, whitened to 48 dims, seeded torch-layout weights carried
into Flax by the reference's ``load_torch_resnet``): bf16, int8 and int4 in
the reference's streaming (orbax) form with a regional store (bf16 for the
bf16 store, int8 for the integer ones, as the reference quantizes it), and
an f32 index in the npz form whose weights are still an orbax tree. Each is
converted by the tool and loaded by ``instsearch_torch.index.Index.load``.

What is compared, and the tolerances:
  * the stores: the converted index's ids, names, row scales and regional
    store equal the JAX-loaded index's bit for bit, and its rows equal the
    reference's components up to ``dim`` (int4 by unpacked components; the
    port re-adds zero columns and repacks int4 on load).
  * the answers on the oracle route (``with_search(use_pallas=False)``)
    against the JAX Index's on the CPU (its oracle): the same stored bytes,
    an f32 query, so ids equal except where JAX scores the two ids within
    NEAR_TIE = 1e-6 of each other, scores within 1e-6. The integer stores
    are held on the oracle route alone: K2/K3 quantize the query, the
    reference's oracle does not (ROADMAP, the two-semantics trap).
  * the extractor rebuilt from the converted ``torch_weights.pt``: each
    seeded image's whitened descriptor against the JAX extractor's, cosine
    at least 0.99999 (both in f32; measured 1 - 3e-14).
  * a reference ``finetune`` checkpoint (``save_pytree`` of Flax variables
    with its ``.meta.json`` and ``.whitening.npz`` sidecars), converted,
    drives ``python -m instsearch_torch.cli build-index --weights``; its
    weights equal ``from_jax_resnet`` of the tree exactly.
  * an unconverted orbax tree still exits 2 and names the tool.
"""
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instsearch_tpu.config import (ExtractConfig, IndexConfig, PipelineConfig,
                                   SearchConfig)
from instsearch_tpu.eval import make_mini_dataset
from instsearch_tpu.extractor import Extractor as JaxExtractor
from instsearch_tpu.index import Index as JaxIndex
from instsearch_tpu.index import attach_regional_store as jax_attach
from instsearch_tpu.models import load_torch_resnet
from instsearch_tpu.ops.quantize import unpack_int4 as jax_unpack_int4
from instsearch_tpu.ops.whitening import WhiteningParams as JaxWhitening
from instsearch_tpu.utils import save_pytree as jax_save_pytree
from instsearch_torch import cli as tcli
from instsearch_torch.index import Index
from instsearch_torch.models.jax_import import from_jax_resnet
from instsearch_torch.ops.quantize import unpack_int4
from instsearch_torch.utils.checkpoint import load_pytree

from parity.torch_models import BasicBlock, TruncatedResNet, randomize_bn_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, DIM, N, R = 64, 48, 200, 3
NEAR_TIE = 1e-6
COSINE = 0.99999
CASES = (("bfloat16", True), ("int8", True), ("int4", True),
         ("float32", False))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_port", os.path.join(ROOT, "tools", "orbax_to_port.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on a few cores: this
    module's CPU models take one intra-op thread, restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(kind: str) -> PipelineConfig:
    return PipelineConfig(
        extract=ExtractConfig(backbone="resnet18", pooling="gem",
                              image_size=SIZE, whiten=True, whiten_dim=DIM,
                              dtype="float32"),
        index=IndexConfig(dtype=kind, row_tile=8),
        search=SearchConfig(k=10))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The JAX saves, their conversions and the seeded inputs: (root,
    variables, jax extractor, images, queries)."""
    root = tmp_path_factory.mktemp("orbax_convert")
    torch.manual_seed(0)
    variables = load_torch_resnet(randomize_bn_stats(TruncatedResNet(
        layers=(2, 2, 2, 2), block=BasicBlock)).state_dict())
    rng = np.random.default_rng(21)
    P = (rng.standard_normal((DIM, 512)) / np.sqrt(512)).astype(np.float32)
    mu = (0.01 * rng.standard_normal(512)).astype(np.float32)
    jex = JaxExtractor(_cfg("float32").extract, variables=variables,
                       whitening=JaxWhitening(P=jnp.asarray(P),
                                              mu=jnp.asarray(mu)))
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    reg = rng.standard_normal((N, R, DIM)).astype(np.float32)
    reg /= np.linalg.norm(reg, axis=-1, keepdims=True)
    q = x[:9] + 0.05 * rng.standard_normal((9, DIM)).astype(np.float32)
    tool = _tool()
    for kind, streaming in CASES:
        jidx = JaxIndex.from_descriptors(x, [f"im{i}" for i in range(N)],
                                         _cfg(kind), extractor=jex)
        if streaming:
            jax_attach(jidx, reg)
        jidx.save(str(root / f"jax_{kind}"), streaming=streaming)
        tool.convert_index(str(root / f"jax_{kind}"),
                           str(root / f"port_{kind}"))
    images = (rng.random((4, SIZE, SIZE, 3)) * 255).astype(np.uint8)
    return root, variables, jex, images, q


@pytest.mark.parametrize("kind,streaming", CASES)
def test_converted_store_equals_jax(saved, kind, streaming):
    root = saved[0]
    meta = json.load(open(root / f"port_{kind}" / "meta.json"))
    assert meta["format"] == (Index.STREAM_FORMAT if streaming else "npz")
    assert meta["weights_saved"] is False
    assert meta["torch_weights"] == "torch_weights.pt"
    jidx = JaxIndex.load(str(root / f"jax_{kind}"), extractor=saved[2])
    tidx = Index.load(str(root / f"port_{kind}"), device="cpu")
    assert tidx.dim == jidx.dim == DIM and tidx.names == list(jidx.names)
    np.testing.assert_array_equal(tidx.ids.numpy(), np.asarray(jidx.ids))
    x = tidx.descriptors
    comps = unpack_int4(x) if tidx.is_int4 else x
    assert not comps[:, DIM:].any()
    want = (jax_unpack_int4(jidx.descriptors) if jidx.is_int4
            else jidx.descriptors.astype(jnp.float32))
    np.testing.assert_array_equal(comps[:, :DIM].float().numpy(),
                                  np.asarray(want, np.float32))
    for mine, ref in ((tidx.scales, jidx.scales),
                      (tidx.regional, jidx.regional),
                      (tidx.regional_scales, jidx.regional_scales)):
        assert (mine is None) == (ref is None)
        if mine is not None:
            np.testing.assert_array_equal(mine.float().numpy(),
                                          np.asarray(ref, np.float32))
    if jidx.regional is not None:
        assert tidx.regional.dtype == (torch.int8 if kind != "bfloat16"
                                       else torch.bfloat16)


@pytest.mark.parametrize("kind,streaming", CASES)
def test_converted_index_serves_jax_answers(saved, kind, streaming):
    root, _, jex, _, q = saved
    jidx = JaxIndex.load(str(root / f"jax_{kind}"), extractor=jex)
    tidx = Index.load(str(root / f"port_{kind}"), device="cpu")
    js, ji = (np.asarray(a) for a in jidx.search(jnp.asarray(q)))
    ts, ti = (np.asarray(a) for a in tidx.with_search(
        use_pallas=False).search(torch.from_numpy(q)))
    for r in range(len(q)):
        jscore = dict(zip(ji[r].tolist(), js[r].tolist()))
        for a, b in zip(ji[r], ti[r]):
            if a != b:
                assert b in jscore and abs(jscore[a] - jscore[b]) < NEAR_TIE
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["bfloat16", "float32"])
def test_converted_extractor_reproduces_jax(saved, kind):
    """The backbone from ``torch_weights.pt`` and the stored whitening give
    the JAX extractor's descriptors (the orbax-store and npz conversions
    alike)."""
    root, _, jex, images, _ = saved
    tidx = Index.load(str(root / f"port_{kind}"), device="cpu")
    got = tidx.extractor(images).numpy().astype(np.float64)
    want = np.asarray(jex(jnp.asarray(images)), np.float64)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert cos.min() >= COSINE, cos


@pytest.fixture(scope="module")
def finetune_ckpt(saved, tmp_path_factory):
    """A reference ``finetune`` checkpoint: the Flax variables by the
    reference's ``save_pytree``, the ``.meta.json`` sidecar and the Lw
    ``.whitening.npz`` it records, and a folder of the mini fixture's
    images; (source, converted, images dir, P, mu)."""
    root = tmp_path_factory.mktemp("finetune_ckpt")
    variables = saved[1]
    src = str(root / "tuned")
    jax_save_pytree(src, variables)
    rng = np.random.default_rng(4)
    P = (rng.standard_normal((512, 512)) / np.sqrt(512)).astype(np.float32)
    mu = (0.01 * rng.standard_normal(512)).astype(np.float32)
    np.savez(src + ".whitening.npz", P=P, mu=mu)
    with open(src + ".meta.json", "w") as f:
        json.dump({"gem_p": 3.0, "backbone": "resnet18", "pooling": "gem",
                   "image_size": SIZE,
                   "whitening": os.path.abspath(src + ".whitening.npz")}, f)
    dst = str(root / "tuned_port")
    out = _tool().convert_weights(src, dst)
    assert out["backbone"] == "resnet18"
    ds = make_mini_dataset(str(root / "mini"), n_instances=2, n_views=2,
                           n_distractors=2, seed=3, size=SIZE)
    images = str(root / "images")
    os.makedirs(images)
    for p in ds.db_paths:
        os.symlink(p, os.path.join(images, os.path.basename(p)))
    return src, dst, images, P, mu


def test_finetune_checkpoint_drives_build_index(saved, finetune_ckpt,
                                                tmp_path, capsys):
    src, dst, images, P, mu = finetune_ckpt
    want = from_jax_resnet(saved[1])
    got = load_pytree(dst)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    wmeta = json.load(open(dst + ".meta.json"))
    assert wmeta["whitening"] == os.path.abspath(dst + ".whitening.npz")
    out = str(tmp_path / "idx")
    rc = tcli.main(["--device", "cpu", "build-index", "--images", images,
                    "--out", out, "--weights", dst, "--backbone",
                    "resnet18"])
    assert rc == 0, capsys.readouterr().err
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    idx = Index.load(out, device="cpu")
    assert res["indexed"] == idx.num_valid == len(os.listdir(images))
    np.testing.assert_array_equal(idx.extractor.whitening.P.numpy(), P)
    np.testing.assert_array_equal(idx.extractor.whitening.mu.numpy(), mu)
    assert idx.cfg.extract.image_size == SIZE and idx.dim == 512
    sd = idx.extractor.model.state_dict()
    for k in want:
        assert torch.equal(sd[k], want[k].to(sd[k].dtype)), k


@pytest.fixture(scope="module")
def orbax_index(tmp_path_factory) -> str:
    """A reference index in the orbax form, never converted."""
    path = str(tmp_path_factory.mktemp("orbax_index") / "idx")
    x = np.eye(8, DIM, dtype=np.float32)
    JaxIndex.from_descriptors(x, [f"e{i}" for i in range(8)],
                              _cfg("int8")).save(path, streaming=True)
    return path


@pytest.mark.parametrize("sub", ["build-index", "evaluate"])
def test_unconverted_orbax_exits_2_and_names_the_tool(finetune_ckpt,
                                                      orbax_index, sub,
                                                      tmp_path, capsys):
    src, _, images, _, _ = finetune_ckpt
    argv = (["build-index", "--images", images, "--out",
             str(tmp_path / "x")] if sub == "build-index" else
            ["evaluate", "--dataset", "mini"])
    rc = tcli.main(["--device", "cpu"] + argv + ["--weights", src])
    err = capsys.readouterr().err
    assert rc == 2 and "tools/orbax_to_port.py" in err, err
    with pytest.raises(NotImplementedError, match="orbax_to_port"):
        Index.load(orbax_index, device="cpu")
