"""Tensor-parallel ViT extraction of the port (``parallel/tp.py``,
``Extractor`` over a ``('data', 'model')`` mesh) against the reference's
(``instsearch_tpu/parallel/tp.py``), mirroring
tests/distributed/test_tensor_parallel.py.

The reference's tiny ViT (hidden 32, 2 layers, 4 heads, MLP 64, patch 4,
image 16, f32) with Flax's initial variables moved by seeded noise (so a
bias or LayerNorm tensor carried into the wrong place shows), carried into
the port by ``from_jax_vit``. The port's meshes are CPU devices that repeat
(``["cpu"] * n``); the reference's are the eight virtual CPU devices that
tests/conftest.py makes. Tolerance: the reference test's, 2e-5 relative and
absolute in f32 (the split sums the partial products of out and linear_2
in another order); the extractors, 2e-4 / 2e-5 as the reference's
extractor test. tp = 8 over 4 heads takes the gathered attention route.

The port's shards hold their heads' q, k and v rows (the reference's
contiguous column cut crosses them), so shards are compared by shape and
outputs only.
"""
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
from instsearch_tpu.parallel import make_mesh_dp_tp as jax_mesh_dp_tp
from instsearch_tpu.parallel.tp import place_tp as jax_place_tp
from instsearch_tpu.parallel.tp import tp_param_spec as jax_tp_param_spec
import instsearch_torch.models.registry as treg
from instsearch_torch import ExtractConfig
from instsearch_torch.extractor import Extractor
from instsearch_torch.models import get_backbone
from instsearch_torch.models.jax_import import from_jax_vit, load_jax_vit
from instsearch_torch.models.vit import ViT, vit_b_16, vit_l_16
from instsearch_torch.parallel import (DeviceMesh, ShardMesh, make_mesh_dp_tp,
                                       place_tp, tp_param_spec,
                                       tp_param_specs)
from instsearch_torch.parallel.mesh import axis_groups
from instsearch_torch.parallel.tp import TensorParallelViT, split_layer_bytes

TINY = dict(hidden_dim=32, num_heads=4, mlp_dim=64, patch_size=4,
            image_size=16)
TOL = 2e-5
MESHES = [(1, 4), (2, 2), (1, 8)]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small CPU tensors in a worker process: one intra-op thread,
    restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_vit_variables(num_layers: int = 2, num_heads: int = 4, seed: int = 0,
                      **kw) -> tuple:
    """(the Flax tiny ViT, its initial variables moved by seeded noise,
    numpy leaves)."""
    cfg = dict(TINY, num_heads=num_heads, **kw)
    model = JaxViT(num_layers=num_layers, dtype=jnp.float32, **cfg)
    x = np.zeros((1, cfg["image_size"], cfg["image_size"], 3), np.float32)
    params = model.init(jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.default_rng(seed)
    return model, {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), params)}


def port_vit(variables, num_layers: int = 2, num_heads: int = 4,
             **kw) -> ViT:
    """The port's ViT of the same shape with ``variables`` carried in."""
    m = ViT(num_layers=num_layers, dtype=torch.float32, device="cpu",
            **dict(TINY, num_heads=num_heads, **kw))
    load_jax_vit(m, variables)
    return m


def _jax_mesh(data, tp):
    return Mesh(np.array(jax.devices()[:data * tp]).reshape(data, tp),
                ("data", "model"))


@pytest.fixture(scope="module")
def rig():
    """(port model, images, JAX single-device output, JAX TP outputs by
    mesh shape)."""
    model, variables = jax_vit_variables()
    x = np.random.default_rng(1).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x)))
    tp_out = {}
    for data, tp in MESHES:
        mesh = _jax_mesh(data, tp)
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
        tp_out[(data, tp)] = np.asarray(jax.jit(model.apply)(
            jax_place_tp(mesh, variables), xs))
    return port_vit(variables), x, ref, tp_out, variables


def _tp_forward(model, mesh, x):
    """The batch over the mesh's data positions, one TensorParallelViT a
    position."""
    placed = place_tp(mesh, model)
    groups = axis_groups(mesh, "model")
    parts = np.array_split(np.arange(x.shape[0]), len(groups))
    with torch.inference_mode():
        return torch.cat([TensorParallelViT(model, devs, pl)(
            torch.from_numpy(x[rows])) for devs, pl, rows in
            zip(groups, placed, parts)]).numpy()


@pytest.mark.parametrize("data,tp", MESHES)
def test_tp_matches_jax(rig, data, tp):
    model, x, ref, tp_out, _ = rig
    got = _tp_forward(model, make_mesh_dp_tp(data, tp,
                                             devices=["cpu"] * data * tp), x)
    np.testing.assert_allclose(got, tp_out[(data, tp)], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("data,tp", MESHES)
def test_params_really_sharded(rig, data, tp):
    model = rig[0]
    placed = place_tp(make_mesh_dp_tp(data, tp, devices=["cpu"] * data * tp),
                      model)
    assert len(placed) == data
    for group in placed:
        for name, want in (("qkv.weight", (96 // tp, 32)),
                           ("qkv.bias", (96 // tp,)),
                           ("out.weight", (32, 32 // tp)),
                           ("out.bias", (32,)),
                           ("linear_1.weight", (64 // tp, 32)),
                           ("linear_2.weight", (32, 64 // tp)),
                           ("ln_1.weight", (32,))):
            shards = group[f"encoder_layer_0.{name}"]
            # split tensors: one shard a device; replicated ones: on the
            # line's first device alone
            assert len(shards) == (tp if tp_param_spec(f"encoder_layer_0."
                                                       f"{name}") is not None
                                   else 1)
            assert all(tuple(s.shape) == want for s in shards), name
        assert tuple(group["conv_proj.weight"][0].shape) == (32, 3, 4, 4)
    sizes = split_layer_bytes(placed[0])
    assert sizes["shard_bytes"] == [sizes["whole_bytes"] // tp] * tp


def test_head_split_holds_each_heads_qkv_rows(rig):
    """At tp = 2 shard 1 holds heads 2-3's q, k and v rows; at tp = 8 (4
    heads) the rows are the reference's contiguous eighths."""
    model = rig[0]
    w = model.state_dict()["encoder_layer_1.qkv.weight"]
    two = place_tp(ShardMesh((CPU,) * 2, axis="model"), model)[0]
    want = torch.cat([w[16:32], w[48:64], w[80:96]])
    assert torch.equal(two["encoder_layer_1.qkv.weight"][1], want)
    eight = place_tp(ShardMesh((CPU,) * 8, axis="model"), model)[0]
    assert torch.equal(eight["encoder_layer_1.qkv.weight"][5], w[60:72])


def test_spec_builder_replicates_unknown_params(rig):
    resnet, _ = get_backbone("resnet18", dtype=torch.float32, device="meta")
    specs = tp_param_specs(resnet.state_dict())
    assert set(specs) == set(resnet.state_dict())
    assert all(v is None for v in specs.values())
    assert tp_param_spec("conv1.weight") is None
    assert tp_param_spec("bn1.weight") is None
    assert tp_param_spec("class_token") is None
    assert tp_param_spec("encoder_layer_3.qkv.weight") == 0
    assert tp_param_spec("encoder_layer_3.out.weight") == 1
    assert tp_param_spec("encoder_layer_3.linear_1.bias") == 0
    assert tp_param_spec("encoder_layer_3.linear_2.bias") is None
    # every ViT tensor splits where the reference's does (torch's weights
    # are Flax's kernels transposed)
    variables = rig[4]
    sd = from_jax_vit(variables)

    def flat(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, path + (k,))
            else:
                yield path + (k,), v

    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    for path, _ in flat(variables["params"]):
        spec = jax_tp_param_spec(("params",) + path)
        name = (".".join(path[:-1] + (leaf[path[-1]],)) if len(path) > 1
                else path[0])
        assert name in sd
        jdim = next((i for i, a in enumerate(spec) if a == "model"), None)
        if jdim is not None and path[-1] == "kernel":
            jdim = 1 - jdim
        assert tp_param_spec(name) == jdim, name


def test_indivisible_dim_rejected():
    model = ViT(hidden_dim=24, num_layers=1, num_heads=4, mlp_dim=36,
                patch_size=4, image_size=16, dtype=torch.float32,
                device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        place_tp(ShardMesh((CPU,) * 8, axis="model"), model)


def test_meshes_for_model_parallel_runtimes():
    m2 = DeviceMesh(((CPU, CPU, CPU),) * 2, ("data", "model"))
    assert m2.shape == {"data": 2, "model": 3}
    assert axis_groups(m2, "model") == [(CPU,) * 3] * 2
    assert axis_groups(m2, "data") == [(CPU,) * 2] * 3
    one = ShardMesh((CPU,) * 4, axis="pipe")
    assert one.shape == {"pipe": 4} and axis_groups(one, "pipe") == [
        (CPU,) * 4]
    # a mesh over a process group (a gloo group of this one process): the
    # devices this process holds on each line, with the line's subgroup
    import socket

    import torch.distributed as dist
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        world = dist.group.WORLD
        seq = axis_groups(ShardMesh((CPU,) * 2, group=world, axis="seq"),
                          "seq")
        assert seq == [(CPU,) * 2] and seq[0].group is world
        assert (seq[0].start, seq[0].size) == (0, 2)
        grid = make_mesh_dp_tp(2, 2, devices=["cpu"] * 4, group=world)
        assert grid.shape == {"data": 2, "model": 2}
        for axis in ("model", "data"):
            lines = axis_groups(grid, axis)
            assert lines == [(CPU,) * 2] * 2
            assert [g.line for g in lines] == [0, 1]
            assert all(g.group is not None and g.group is not world
                       and dist.get_world_size(g.group) == 1 for g in lines)
        assert grid.along("data").group is axis_groups(grid, "data")[0].group
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="not 'model'"):
        axis_groups(one, "model")


NAME = "vit_tp_tiny"


def _jax_factory(dtype=None, attention="auto"):
    return JaxViT(dtype=dtype, attention=attention, num_layers=2, **TINY)


def _port_factory(dtype=torch.bfloat16, attention="auto", device=None):
    return ViT(dtype=dtype, attention=attention, device=device,
               num_layers=2, **TINY)


@pytest.fixture(scope="module")
def registered(rig):
    """The tiny ViT under one name in both registries, for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jreg.BACKBONES, NAME,
                   jreg.BackboneSpec(_jax_factory, 32, 4, load_torch_vit))
        mp.setitem(treg.BACKBONES, NAME,
                   treg.BackboneSpec(_port_factory, 32, 4))
        yield rig[4]


def _cfg(cls, **kw):
    return cls(backbone=NAME, pooling="gem", image_size=32, dtype="float32",
               batch_size=4, **kw)


def _images(seed, n):
    return (np.random.default_rng(seed).random((n, 32, 32, 3)) * 255).astype(
        np.uint8)


def test_extractor_tp_mesh_matches_jax(registered):
    variables = registered
    imgs = _images(3, 4)
    jex = JaxExtractor(_cfg(JaxExtractConfig, vit_attention="pallas"),
                       variables=variables, seed=0,
                       mesh=jax_mesh_dp_tp(2, 4))
    want = np.asarray(jex(jnp.asarray(imgs)))
    ex = Extractor(_cfg(ExtractConfig, vit_attention="flash"), variables,
                   mesh=make_mesh_dp_tp(2, 4, devices=["cpu"] * 8))
    assert ex.cfg.vit_attention == "xla" and jex.cfg.vit_attention == "xla"
    assert ex.dp_size == 2 and len(ex._copies) == 1
    got = ex(imgs).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    single = Extractor(_cfg(ExtractConfig), variables, device="cpu")
    np.testing.assert_allclose(got, single(imgs).numpy(), rtol=2e-4,
                               atol=2e-5)
    # 5 images: padded to the 2 data positions; regional rows too
    np.testing.assert_allclose(ex(_images(4, 5)).numpy(),
                               single(_images(4, 5)).numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(ex.extract_regional(imgs).numpy(),
                               single.extract_regional(imgs).numpy(),
                               rtol=2e-4, atol=2e-5)
    # weights loaded into Extractor.model after construction are re-placed
    other = Extractor(_cfg(ExtractConfig), seed=3, device="cpu")
    ex.model.load_state_dict(other.model.state_dict())
    np.testing.assert_allclose(ex(imgs).numpy(), other(imgs).numpy(),
                               rtol=2e-4, atol=2e-5)


def test_resnet_under_a_model_axis_is_data_parallel():
    cfg = ExtractConfig(backbone="resnet18", pooling="gem", image_size=32,
                        dtype="float32", batch_size=4)
    single = Extractor(cfg, seed=0, device="cpu")
    ex = Extractor(cfg, seed=0,
                   mesh=make_mesh_dp_tp(2, 2, devices=["cpu"] * 4))
    assert ex.dp_size == 2 and not ex._copies
    imgs = _images(5, 6)
    np.testing.assert_allclose(ex(imgs).numpy(), single(imgs).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_published_widths_shard_shapes():
    """vit_b_16 and vit_l_16 on the ``meta`` device: the shards' shapes at
    their published widths."""
    mesh = make_mesh_dp_tp(1, 4, devices=["meta"] * 4)
    b16 = place_tp(mesh, vit_b_16(device="meta"))[0]
    assert tuple(b16["encoder_layer_0.qkv.weight"][0].shape) == (576, 768)
    assert tuple(b16["encoder_layer_11.out.weight"][3].shape) == (768, 192)
    l16 = place_tp(mesh, vit_l_16(device="meta"))[0]
    assert tuple(l16["encoder_layer_23.qkv.weight"][0].shape) == (768, 1024)
    assert tuple(l16["encoder_layer_0.linear_1.weight"][1].shape) == (
        1024, 1024)
    assert tuple(l16["encoder_layer_0.linear_2.weight"][2].shape) == (
        1024, 1024)
