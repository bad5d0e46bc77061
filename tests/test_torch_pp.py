"""The port's GPipe pipeline (``parallel/pp.py``) against the reference's
(``instsearch_tpu/parallel/pp.py``), mirroring
tests/distributed/test_pipeline_parallel.py: the tiny ViT of
test_torch_tp.py at 8 layers (4 for the DP x PP mesh), batch 8, its
variables carried by ``from_jax_vit``; the port's stages are CPU devices
that repeat, the reference's the eight virtual CPU devices of
tests/conftest.py. Tolerance: the reference test's, 2e-5 in f32 (the
stages run the same blocks; only the frameworks' summation orders
differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from instsearch_tpu.parallel.pp import pipelined_vit_fn as jax_pipelined
from instsearch_tpu.parallel.pp import place_pp as jax_place_pp
from instsearch_tpu.parallel.pp import (
    stack_layer_params as jax_stack_layer_params)
from instsearch_torch.parallel import (DeviceMesh, ShardMesh,
                                       pipelined_vit_fn, place_pp,
                                       stack_layer_params)

from test_torch_tp import jax_vit_variables, port_vit

TOL = 2e-5
CPU = torch.device("cpu")
CASES = [(4, 4), (2, 8), (8, 2)]


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _images(batch=8, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, 16, 16, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def rig():
    """(8-layer and 4-layer port models, images, JAX outputs: single
    device for each depth, the pipelines by case, DP x PP)."""
    x = _images()
    out = {}
    models = {}
    for layers in (8, 4):
        jm, variables = jax_vit_variables(num_layers=layers)
        out[layers] = np.asarray(jm.apply(variables, jnp.asarray(x)))
        models[layers] = (jm, variables, port_vit(variables,
                                                  num_layers=layers))
    jm, variables, _ = models[8]
    for stages, n_micro in CASES:
        mesh = _jax_mesh((stages,), ("pipe",))
        rest, stacked = jax_place_pp(mesh, jm, variables)
        out[(stages, n_micro)] = np.asarray(jax.jit(jax_pipelined(
            jm, mesh, n_micro=n_micro))(rest, stacked, jnp.asarray(x)))
    jm, variables, _ = models[4]
    mesh = _jax_mesh((2, 4), ("data", "pipe"))
    rest, stacked = jax_place_pp(mesh, jm, variables)
    out["dp"] = np.asarray(jax.jit(jax_pipelined(jm, mesh, n_micro=2))(
        rest, stacked, jnp.asarray(x)))
    return models, x, out


def _run(model, mesh, n_micro, x):
    with torch.inference_mode():
        return pipelined_vit_fn(model, mesh, n_micro)(
            *place_pp(mesh, model), torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("stages,n_micro", CASES)
def test_pp_matches_jax(rig, stages, n_micro):
    models, x, out = rig
    got = _run(models[8][2], ShardMesh((CPU,) * stages, axis="pipe"),
               n_micro, x)
    np.testing.assert_allclose(got, out[(stages, n_micro)], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got, out[8], rtol=TOL, atol=TOL)


def test_pp_dp_composition(rig):
    models, x, out = rig
    mesh = DeviceMesh(((CPU,) * 4,) * 2, ("data", "pipe"))
    got = _run(models[4][2], mesh, 2, x)
    np.testing.assert_allclose(got, out["dp"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, out[4], rtol=TOL, atol=TOL)


def test_layers_really_stage_sharded(rig):
    model = rig[0][8][2]
    rest, stacked = place_pp(ShardMesh((CPU,) * 4, axis="pipe"), model)
    assert len(rest) == len(stacked) == 1
    qkv = stacked[0]["qkv.weight"]           # 4 stages of [2, 96, 32]
    assert len(qkv) == 4
    assert all(tuple(t.shape) == (2, 96, 32) for t in qkv)
    sd = model.state_dict()
    assert torch.equal(qkv[3][1], sd["encoder_layer_7.qkv.weight"])
    conv = rest[0]["conv_proj.weight"]
    assert tuple(conv.shape) == tuple(sd["conv_proj.weight"].shape)
    two = DeviceMesh(((CPU,) * 4,) * 2, ("data", "pipe"))
    rest2, stacked2 = place_pp(two, model)
    assert len(rest2) == len(stacked2) == 2


def test_stack_roundtrip_preserves_values(rig):
    jm, variables, model = rig[0][4]
    rest, stacked = stack_layer_params(model)
    sd = model.state_dict()
    assert torch.equal(stacked["linear_1.weight"][2],
                       sd["encoder_layer_2.linear_1.weight"])
    assert not any(k.startswith("encoder_layer_") for k in rest)
    assert "conv_proj.weight" in rest and "ln.weight" in rest
    assert set(rest) | {f"encoder_layer_{i}.{n}" for i in range(4)
                        for n in stacked} == set(sd)
    _, jstacked = jax_stack_layer_params(jm, variables)
    np.testing.assert_array_equal(
        stacked["linear_1.weight"].numpy(),
        np.asarray(jstacked["linear_1"]["kernel"]).transpose(0, 2, 1))


def test_indivisible_layers_rejected():
    _, variables = jax_vit_variables(num_layers=5)
    model = port_vit(variables, num_layers=5)
    mesh = ShardMesh((CPU,) * 4, axis="pipe")
    with pytest.raises(ValueError, match="not divisible"):
        place_pp(mesh, model)
    with pytest.raises(ValueError, match="not divisible"):
        pipelined_vit_fn(model, mesh, n_micro=2)


def test_indivisible_batch_rejected(rig):
    model = rig[0][4][2]
    mesh = ShardMesh((CPU,) * 4, axis="pipe")
    fwd = pipelined_vit_fn(model, mesh, n_micro=4)
    with pytest.raises(ValueError, match="not divisible"):
        fwd(*place_pp(mesh, model), torch.from_numpy(_images(batch=6)))
