"""The port's sequence-parallel ViT forward (``parallel/sp.py``) against the
reference's (``instsearch_tpu/parallel/sp.py``), mirroring
tests/distributed/test_sequence_parallel.py: the tiny ViT of
test_torch_tp.py (16 px at patch 4 gives 17 tokens, which no sp > 1
divides, so every case takes the pad-and-mask path; 24 px gives 37), its
variables carried by ``from_jax_vit``; the port's shards are CPU devices
that repeat, the reference's the eight virtual CPU devices of
tests/conftest.py. Tolerance: the reference test's, 2e-5 in f32 (the pad
mask is exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from instsearch_tpu.parallel.sp import place_sp as jax_place_sp
from instsearch_tpu.parallel.sp import (
    sequence_parallel_vit_fn as jax_sp_fn)
from instsearch_torch.parallel import (DeviceMesh, ShardMesh, place_sp,
                                       sequence_parallel_vit_fn)

from test_torch_tp import jax_vit_variables, port_vit

TOL = 2e-5
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _images(batch, size=16, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def rig():
    """(port model, JAX outputs: single device and SP by case)."""
    jm, variables = jax_vit_variables()
    out = {}
    for name, shape, names, x in (
            (2, (2,), ("seq",), _images(4)),
            (4, (4,), ("seq",), _images(4)),
            ("dp", (2, 4), ("data", "seq"), _images(4)),
            ("24px", (4,), ("seq",), _images(2, size=24))):
        mesh = _jax_mesh(shape, names)
        got = jax.jit(jax_sp_fn(jm, mesh))(jax_place_sp(mesh, variables),
                                           jnp.asarray(x))
        out[name] = (x, np.asarray(got),
                     np.asarray(jm.apply(variables, jnp.asarray(x))))
    return port_vit(variables), out


def _run(model, mesh, x):
    with torch.inference_mode():
        return sequence_parallel_vit_fn(model, mesh)(
            place_sp(mesh, model=model), torch.from_numpy(x)).numpy()


def _check(got, case):
    _, want, single = case
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, single, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_matches_jax(rig, sp):
    model, out = rig
    x = out[sp][0]
    _check(_run(model, ShardMesh((CPU,) * sp, axis="seq"), x), out[sp])


def test_sp_dp_composition(rig):
    model, out = rig
    mesh = DeviceMesh(((CPU,) * 4,) * 2, ("data", "seq"))
    _check(_run(model, mesh, out["dp"][0]), out["dp"])
    placed = place_sp(mesh, model=model)
    assert len(placed) == 2 and all(len(g) == 4 for g in placed)
    # one copy a distinct device, shared by the shards that repeat it
    assert placed[0][0] is placed[0][3]


def test_sp_multiscale_input(rig):
    model, out = rig
    x = out["24px"][0]
    _check(_run(model, ShardMesh((CPU,) * 4, axis="seq"), x), out["24px"])


def test_sp_head_divisibility_guard():
    _, variables = jax_vit_variables(num_heads=2)
    model = port_vit(variables, num_heads=2)
    with pytest.raises(ValueError, match="not divisible"):
        sequence_parallel_vit_fn(model, ShardMesh((CPU,) * 4, axis="seq"))
