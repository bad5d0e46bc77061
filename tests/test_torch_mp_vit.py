"""The port's model-parallel ViT forwards and ``Extractor(mesh=)`` on meshes
whose axes span processes: two processes of two CPU devices each (four for
tp = 8), joined by gloo over the loopback (tests/torch_mp_vit_worker.py,
which imports no JAX), as the reference's meshes span JAX processes. One
spawn serves the module.

The tiny ViT of tests/distributed/test_pipeline_parallel.py (hidden 32, 4
layers, 4 heads, MLP 64, patch 4) with Flax's initial variables moved by
seeded noise, carried into the port by ``from_jax_vit``; seeded numpy
images. Every case, on every rank, is held against the JAX package's
single-device forward run here:
- f32 within 2e-5, relative and absolute (the reference's own TP bar,
  tests/distributed/test_tensor_parallel.py);
- bf16 (the tensor-parallel cases, whose f32 partial sums meet in another
  order than the single device's product): every image's cosine with the
  reference's single-device patch maps at least 0.9999, and the port's
  TP-versus-single spread (its largest difference from the port's own
  single-device bf16 forward) within the reference's own on the same mesh
  shape (its GSPMD route against its ``model.apply``). The two packages'
  single-device bf16 forwards differ by a few bf16 steps already, so the
  spread, not the difference between packages, is what TP adds.
The ranks' outputs are equal bit for bit, and each process holds only its
own shards of the split layers (its bytes are the whole's x local shards /
tp) or its own stages.
"""
import os
import socket
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import instsearch_tpu.models.registry as jreg
from instsearch_tpu.config import ExtractConfig as JaxExtractConfig
from instsearch_tpu.extractor import Extractor as JaxExtractor
from instsearch_tpu.models import load_torch_vit
from instsearch_tpu.models.vit import ViT as JaxViT
from instsearch_tpu.parallel.tp import place_tp as jax_place_tp
from instsearch_torch.index import Index
from instsearch_torch.models.jax_import import from_jax_vit

import torch_mp_vit_worker as worker
from test_torch_tp import jax_vit_variables

WORLD = 2
TOL = 2e-5
COS = 0.9999
# TP cases: (data, model) of the reference's mesh of the same shape
TP_CASES = {"tp4": (1, 4), "tp8": (1, 8), "dptp22": (2, 2),
            "dptp14": (1, 4)}
FORWARDS = list(TP_CASES) + ["pp4", "pp_dp", "sp4", "sp_dp"]
EXTRACTORS = {"ex_dptp22": 2, "ex_dptp14": 1, "ex_2d": 2, "ex_data": 4}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_pngs(folder, n, seed=3):
    os.makedirs(folder)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = os.path.join(folder, f"img_{i}.png")
        cv2.imwrite(p, (rng.random((40, 48, 3)) * 255).astype(np.uint8))
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(the workers' answers by rank, the JAX references, the PNG paths)."""
    folder = tmp_path_factory.mktemp("torch_mp_vit")
    jm, variables = jax_vit_variables(num_layers=worker.LAYERS)
    np.savez(folder / "weights.npz", **{
        k: v.numpy() for k, v in from_jax_vit(variables).items()})
    x = np.random.default_rng(1).standard_normal((4, 16, 16, 3)).astype(
        np.float32)
    np.save(folder / "images.npy", x)
    u8 = (np.random.default_rng(2).random((5, 32, 32, 3)) * 255).astype(
        np.uint8)
    np.save(folder / "uint8.npy", u8)
    paths = _write_pngs(str(folder / "png"), 7)
    with socket.socket() as s:                 # a free loopback port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(r), str(WORLD), str(port),
         str(folder)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(WORLD)]
    # the references, while the workers run
    ref = {"f32": np.asarray(jm.apply(variables, jnp.asarray(x)))}
    jb = JaxViT(num_layers=worker.LAYERS, dtype=jnp.bfloat16,
                **worker.TINY)
    ref["bf16"] = np.asarray(jb.apply(variables, jnp.asarray(x)),
                             np.float32)
    for case, (data, tp) in TP_CASES.items():
        mesh = Mesh(np.array(jax.devices()[:data * tp]).reshape(data, tp),
                    ("data", "model"))
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
        got = np.asarray(jax.jit(jb.apply)(jax_place_tp(mesh, variables),
                                           xs), np.float32)
        ref[f"{case}_spread"] = float(np.abs(got - ref["bf16"]).max())
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jreg.BACKBONES, worker.NAME, jreg.BackboneSpec(
            lambda dtype=None, attention="auto": JaxViT(
                dtype=dtype, attention=attention, num_layers=worker.LAYERS,
                **worker.TINY), 32, 4, load_torch_vit))
        jex = JaxExtractor(JaxExtractConfig(
            backbone=worker.NAME, pooling="gem", image_size=32,
            dtype="float32", batch_size=4), variables=variables)
        ref["global"] = np.asarray(jex(jnp.asarray(u8)))
        ref["regional"] = np.asarray(jex.extract_regional(jnp.asarray(u8)))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"MP_OK {r}" in log, \
            f"worker {r} failed:\n{log[-3000:]}"
    answers = [dict(np.load(folder / f"rank{r}.npz")) for r in range(WORLD)]
    return answers, ref, paths


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", FORWARDS)
def test_forward_f32_matches_jax_single_device(spawned, case):
    answers, ref, _ = spawned
    key = f"{case}_f32" if case in TP_CASES else case
    for res in answers:
        assert res[key].shape == ref["f32"].shape
        _close(res[key], ref["f32"])


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp_bf16_within_the_references_own_spread(spawned, case):
    answers, ref, _ = spawned
    want = ref["bf16"]
    for res in answers:
        got = res[f"{case}_bf16"]
        a, b = got.reshape(len(got), -1), want.reshape(len(want), -1)
        cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(
            b, axis=1)
        assert cos.min() >= COS, cos
        spread = np.abs(got - res["single_bf16"]).max()
        assert spread <= ref[f"{case}_spread"], (spread, ref)


@pytest.mark.parametrize("case", list(EXTRACTORS))
def test_extractor_matches_jax_single_device(spawned, case):
    """``Extractor(mesh=)`` end to end (frontend, ViT, GeM, L2): 5 images,
    padded to the data positions, every rank the whole batch."""
    answers, ref, _ = spawned
    for res in answers:
        assert int(res[f"{case}_dp_size"]) == EXTRACTORS[case]
        _close(res[f"{case}_global"], ref["global"])
        _close(res[f"{case}_regional"], ref["regional"])


def test_ranks_agree_bit_for_bit(spawned):
    answers, _, _ = spawned
    assert set(answers[0]) == set(answers[1])
    for key, value in answers[0].items():
        np.testing.assert_array_equal(value, answers[1][key], err_msg=key)


@pytest.mark.parametrize("case", [f"{c}_{dt}" for c in TP_CASES
                                  for dt in ("f32", "bf16")]
                         + ["ex_dptp22", "ex_dptp14"])
def test_tp_process_holds_only_its_shards(spawned, case):
    """A process's split-layer bytes are the layers' whole x its local
    shards / tp: no process holds another's shards."""
    answers, _, _ = spawned
    for res in answers:
        local, whole, n_local, tp = res[f"{case}_bytes"]
        assert local * tp == whole * n_local
        # the 'model' axis across the processes: each holds half of it
        assert (n_local * WORLD == tp) == ("dptp22" not in case)


@pytest.mark.parametrize("case", ["pp4", "pp_dp"])
def test_pp_process_holds_only_its_stages(spawned, case):
    answers, _, _ = spawned
    for res in answers:
        local, whole, n_local, stages = res[f"{case}_bytes"]
        assert local * stages == whole * n_local
        assert bool(res[f"{case}_layers_ok"])
    # 'pipe' over the processes: each holds half of the stages
    assert answers[0]["pp4_bytes"][2] * WORLD == answers[0]["pp4_bytes"][3]


def test_index_build_and_builder_across_processes(spawned):
    """``Index.build(mesh=)`` and ``ResumableBuilder`` over a ``('data',
    'model')`` mesh across the processes: each rank's store equals the
    single-device build's (f32, within 2e-5), names in order."""
    answers, _, paths = spawned
    from torch_mp_vit_worker import pipeline_config, register_backbone
    import instsearch_torch.models.registry as treg
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treg, "BACKBONES", dict(treg.BACKBONES))
        register_backbone()
        sd = {k: torch.from_numpy(v) for k, v in
              np.load(os.path.join(os.path.dirname(os.path.dirname(
                  paths[0])), "weights.npz")).items()}
        want = Index.build(paths, pipeline_config(), variables=sd,
                           device="cpu")
    names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    assert want.names == names
    for res in answers:
        assert res["build_names"].tolist() == names * 2
        for key in ("build", "builder"):
            _close(res[key], want.descriptors[:want.num_valid].numpy())
