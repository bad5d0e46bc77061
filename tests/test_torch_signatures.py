"""The call contract between the reference and the port: a call written for
``instsearch_tpu``, positional or keyword, either computes in
``instsearch_torch`` what it computes in the reference or raises
``TypeError``; it never binds an argument to another parameter.

``test_signature_contract`` walks every module of the reference (each has a
counterpart under the same path) and every public function, class, public
method, classmethod and ``__init__`` defined there that the port has under
the same name. For each it requires:
  * the port's positional parameters are a prefix of the reference's, name
    for name (so the port's own parameters, ``device``, ``dim``,
    ``ServeCore``'s ``mesh``, are keyword-only);
  * a reference parameter the port lacks is one of the TPU and Flax idioms
    that need no port (``_IDIOMS``), and every parameter after it is
    keyword-only in the port (which the prefix rule implies);
  * whatever else differs is on ``BY_DESIGN``, whose entries must still
    differ (the list cannot go stale).

Beside it, one test per repaired fault, against the reference on the same
seeded inputs:
  * F10 ``Index(..., extractor, regional)``: the regional store passed
    sixth or by name re-ranks as the reference's (ids equal, scores 1e-6);
  * F11 ``ServeCore(idx, False, 8192)``: the IVF and IVF-PQ views reserve
    8192 spill slots, as the reference's;
  * F12, each site called positionally as the reference is called: the
    reference's answer (ids equal, scores 1e-6), the same binding as the
    keyword form where the answer needs a model, or ``TypeError``;
  * ``rescale`` by each of ``jax.image.resize``'s methods, growing and
    shrinking, within 1e-5 of the images' range of 1 in f32 (the weights
    are the same f32 formulas; sums differ in order) and exactly for
    ``nearest``; ``PQView.candidates(use_pallas=)``, ``IVFIndex.
    reserve_spill(n, index)``, ``l2_normalize(axis=)`` and ``rmac_pool(x,
    levels, whiten)`` against the reference (1e-6 f32; ids equal).
"""
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instsearch_torch

@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small CPU models in a worker process: one intra-op thread, restored
    afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REF_ROOT = os.path.dirname(os.path.abspath(
    __import__("instsearch_tpu").__file__))

# the reference parameters that are TPU or Flax idioms (ROADMAP "Need no
# port"): the Mosaic tiles and the interpreter, Flax's module plumbing, and
# in parallel/* the JAX variables pytree and mesh axis names
_IDIOMS = {"tile_n", "interpret", "q_block", "kv_block", "variant", "parent",
           "name"}
_PARALLEL_IDIOMS = {"variables", "axis", "data_axis"}

# signatures that differ in whole because the torch form of the object does;
# each reason points at the port's docstring that says so
BY_DESIGN = {
    "parallel.mesh::make_mesh":
        "devices and a process group, not jax.devices(); make_mesh's doc",
    "parallel.multihost::initialize":
        "torch.distributed reads the environment; initialize's doc",
    "parallel.multihost::global_shard_mesh":
        "this process's devices, not an axis; global_shard_mesh's doc",
    "models.resnet::BasicBlock":
        "torchvision's (inplanes, planes, stride); BasicBlock's doc",
    "models.resnet::Bottleneck":
        "torchvision's (inplanes, planes, stride); Bottleneck's doc",
    "kernels.fused_resnet::fold_bn":
        "one torchvision BN mapping for Flax's pair; fold_bn's doc",
    "kernels.fused_resnet::fused_resnet_apply":
        "a torchvision state_dict for Flax variables; its doc",
    "parallel.tp::tp_param_spec":
        "a state_dict key for a Flax path; tp_param_spec's doc",
    "parallel.tp::tp_param_specs":
        "a state_dict for Flax variables; tp_param_specs's doc",
    "models.torch_import::validate_variables":
        "the model's own state_dict as template; its doc",
    "utils.checkpoint::load_sharded_pytree":
        "placements for JAX shardings; load_sharded_pytree's doc",
    "models.registry::BackboneSpec":
        "no Flax torch_loader field; BackboneSpec's doc",
}

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _reference_modules() -> list[str]:
    """Every module of the reference, by path (no import needed to list)."""
    out = []
    for root, _, files in os.walk(_REF_ROOT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), _REF_ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mod = mod[:-len(".__init__")] if mod.endswith(
                    "__init__") else mod
                out.append("" if mod == "__init__" else mod)
    return sorted(out)


def _callables(ref_mod, port_mod, mod: str):
    """(key, reference callable, port callable) of the public names that
    ``ref_mod`` defines and ``port_mod`` has; classes with their public
    methods (the constructor is the class's own signature)."""
    ref_name = ref_mod.__name__
    for attr, obj in sorted(vars(ref_mod).items()):
        if attr.startswith("_") or getattr(obj, "__module__", None) != \
                ref_name:
            continue
        if hasattr(obj, "__wrapped__") and not inspect.isclass(obj):
            obj = inspect.unwrap(obj)           # a jax.jit function
        if not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        port_obj = getattr(port_mod, attr, None)
        if port_obj is None:
            continue
        yield f"{mod}::{attr}", obj, port_obj
        if inspect.isclass(obj) and inspect.isclass(port_obj):
            for meth, m in sorted(vars(obj).items()):
                if meth.startswith("_") or not (
                        inspect.isfunction(m)
                        or isinstance(m, (classmethod, staticmethod))):
                    continue
                if hasattr(port_obj, meth):
                    yield (f"{mod}::{attr}.{meth}", getattr(obj, meth),
                           getattr(port_obj, meth))


def _violations(key: str, ref, port) -> list[str]:
    """What breaks the contract between the two signatures (empty: none)."""
    rs, ps = inspect.signature(ref), inspect.signature(port)
    rpos = [n for n, p in rs.parameters.items() if p.kind in _POSITIONAL]
    ppos = [n for n, p in ps.parameters.items() if p.kind in _POSITIONAL]
    out = []
    if ppos != rpos[:len(ppos)]:
        out.append(f"positional {ppos} is not a prefix of the reference's "
                   f"{rpos}")
    idioms = _IDIOMS | (_PARALLEL_IDIOMS if key.startswith("parallel.")
                        else set())
    missing = [n for n, p in rs.parameters.items()
               if n not in ps.parameters and n not in idioms
               and p.kind not in (inspect.Parameter.VAR_POSITIONAL,
                                  inspect.Parameter.VAR_KEYWORD)]
    if missing:
        out.append(f"lacks the reference's {missing}")
    return out


@pytest.mark.parametrize("mod", _reference_modules())
def test_signature_contract(mod):
    import importlib
    ref = importlib.import_module("instsearch_tpu" + (f".{mod}" if mod
                                                      else ""))
    port = importlib.import_module("instsearch_torch" + (f".{mod}" if mod
                                                         else ""))
    bad, stale = {}, []
    seen = set()
    for key, r, p in _callables(ref, port, mod):
        seen.add(key)
        v = _violations(key, r, p)
        if v and key not in BY_DESIGN:
            bad[key] = v
        if not v and key in BY_DESIGN:
            stale.append(key)
    assert not bad, bad
    assert not stale, f"allow-listed but no longer different: {stale}"
    for key in BY_DESIGN:
        if key.split("::")[0] == mod:
            assert key in seen, f"{key} is allow-listed but not compared"


def test_the_walk_sees_the_faults():
    """The walk compares what F10-F12 broke: each parent signature, put
    back, is a violation."""
    def ref_index(descriptors, ids, names, cfg, extractor=None,
                  regional=None, scales=None):
        pass

    def parent_index(descriptors, ids, names, cfg, extractor=None,
                     scales=None, dim=None):
        pass

    def ref_serve(idx, sharded=False, spill_reserve=4096):
        pass

    def parent_serve(idx, sharded=False, mesh=None, spill_reserve=4096):
        pass

    def ref_topk(x, q, k=10, num_valid=None, tile_n=None, interpret=False,
                 mask=None):
        pass

    def parent_topk(x, q, k=10, num_valid=None, mask=None):
        pass

    def port_topk(x, q, k=10, num_valid=None, *, mask=None):
        pass

    assert _violations("index::Index", ref_index, parent_index)
    assert _violations("serve::ServeCore", ref_serve, parent_serve)
    assert _violations("kernels.topk_matmul::topk_matmul", ref_topk,
                       parent_topk)
    assert not _violations("kernels.topk_matmul::topk_matmul", ref_topk,
                           port_topk)
    assert len(_reference_modules()) > 50


# ---------------------------------------------------------------------------
# F10: the regional store, sixth or by name
# ---------------------------------------------------------------------------

def _regional_case():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    reg = rng.standard_normal((16, 3, 8)).astype(np.float32)
    reg /= np.linalg.norm(reg, axis=2, keepdims=True)
    qreg = reg[:2] + 0.5 * rng.standard_normal((2, 3, 8)).astype(np.float32)
    return x, reg, qreg


def _cfgs(search, dtype="float32"):
    from instsearch_tpu import config as jc
    from instsearch_torch import config as tc
    out = []
    for c in (jc, tc):
        out.append(c.PipelineConfig(
            extract=c.ExtractConfig(dtype="float32"),
            index=c.IndexConfig(dtype=dtype, row_tile=8),
            search=c.SearchConfig(**search)))
    return out


@pytest.mark.parametrize("form", ["positional", "keyword"])
def test_f10_regional_store_reranks(form):
    from instsearch_tpu.index import Index as JIndex
    from instsearch_torch.index import Index
    x, reg, qreg = _regional_case()
    jcfg, tcfg = _cfgs(dict(k=4, use_pallas=False, rerank_enabled=True,
                            rerank_depth=8))
    names = [f"r{i}" for i in range(16)]
    jidx = JIndex(jnp.asarray(x), jnp.arange(16, dtype=jnp.int32), names,
                  jcfg, None, jnp.asarray(reg))
    ids = torch.arange(16, dtype=torch.int32)
    if form == "positional":
        tidx = Index(torch.from_numpy(x), ids, names, tcfg, None,
                     torch.from_numpy(reg))
    else:
        tidx = Index(torch.from_numpy(x), ids, names, tcfg,
                     regional=torch.from_numpy(reg))
    assert tidx.scales is None and tidx.regional.shape == (16, 3, 8)
    js, ji = jidx.search(x[:2], query_regional=qreg)
    ts, ti = tidx.search(x[:2], query_regional=qreg)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-6)
    # the re-rank moved the answers: without it the lists differ
    _, plain = tidx.search(x[:2])
    assert not np.array_equal(plain, ti)


# ---------------------------------------------------------------------------
# F11: ServeCore's third argument is the spill reserve
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ivf_pair():
    """The same 300 clustered rows through both packages'
    ``from_descriptors`` (f32, D = 32): ``{"ivf": (reference, port),
    "ivfpq": (None, port)}``, each index with its own view of that kind
    (one tier an index; the reference's IVF-PQ reserve follows the same
    power-of-two rule as its IVF's)."""
    from instsearch_tpu.index import Index as JIndex
    from instsearch_torch.index import Index
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((6, 32)).astype(np.float32)
    x = centers[rng.integers(0, 6, 300)] + 0.2 * rng.standard_normal(
        (300, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    jcfg, tcfg = _cfgs(dict(k=5, use_pallas=False))
    names = [f"r{i}" for i in range(300)]
    out = {}
    for view in ("ivf", "ivfpq"):
        jidx = JIndex.from_descriptors(x, names, jcfg) if view == "ivf" \
            else None
        tidx = Index.from_descriptors(x, names, tcfg, device="cpu")
        if view == "ivf":
            for idx in (jidx, tidx):
                idx.build_ivf(n_clusters=4, nprobe=2, iters=3)
        else:
            tidx.build_ivfpq(n_clusters=4, nprobe=2, m=8, kmeans_iters=3,
                             pq_iters=3, depth=20)
        out[view] = (jidx, tidx)
    return out


def test_f11_servecore_third_argument_is_spill_reserve(ivf_pair):
    from instsearch_tpu.serve import ServeCore as JServeCore
    from instsearch_torch.serve import ServeCore
    jidx, _ = ivf_pair["ivf"]
    JServeCore(jidx, False, 8192)
    want = int(jidx.ivf.spill_pos.shape[0])
    assert want == 8192
    for view, (_, tidx) in ivf_pair.items():
        sc = ServeCore(tidx, False, 8192)
        assert sc.mesh is None and sc.sidx is None
        assert int(getattr(tidx, view).spill_pos.shape[0]) == want
        with pytest.raises(TypeError):
            ServeCore(tidx, False, 8192, None)
    jidx, tidx = ivf_pair["ivf"]
    assert tuple(tidx.ivf.spill.shape) == np.asarray(jidx.ivf.spill).shape


def test_reserve_spill_takes_the_index(ivf_pair):
    jidx, tidx = ivf_pair["ivf"]
    for idx in (jidx, tidx):
        idx.ivf.reserve_spill(20000, idx)
    jv, tv = jidx.ivf, tidx.ivf
    assert tuple(tv.spill.shape) == tuple(jv.spill.shape) == (32768, 32)
    assert str(tv.spill.dtype).split(".")[-1] == str(jv.spill.dtype)
    np.testing.assert_array_equal(tv.spill_pos.numpy(),
                                  np.asarray(jv.spill_pos))
    with pytest.raises(TypeError):
        tidx.ivf.reserve_spill(20000)


# ---------------------------------------------------------------------------
# F12: each site called positionally as the reference is called
# ---------------------------------------------------------------------------

def _store(n=200, d=32, seed=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:3] + 0.05 * rng.standard_normal((3, d)).astype(np.float32)
    return x, q


def test_f12_sharded_index_positional():
    from instsearch_tpu.parallel.mesh import make_mesh as jmake_mesh
    from instsearch_tpu.parallel.sharded_index import ShardedIndex as JSI
    from instsearch_torch.parallel.mesh import make_mesh
    from instsearch_torch.parallel.sharded_index import ShardedIndex
    x, q = _store(256)
    ids = np.arange(256, dtype=np.int32)
    jsi = JSI(jnp.asarray(x), jnp.asarray(ids), jmake_mesh(2), 4, False)
    mesh = make_mesh(2, devices=["cpu"] * 2)
    tsi = ShardedIndex(torch.from_numpy(x), torch.from_numpy(ids), mesh, 4,
                       False)
    js, ji = jsi.search(jnp.asarray(q))
    ts, ti = tsi.search(torch.from_numpy(q))
    np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
    np.testing.assert_allclose(np.asarray(ts), np.asarray(js), atol=1e-6)
    with pytest.raises(TypeError):             # the reference's interpret
        ShardedIndex(torch.from_numpy(x), torch.from_numpy(ids), mesh, 4,
                     False, False)


@pytest.mark.parametrize("kernel", ["topk_matmul", "topk_matmul_int8",
                                    "topk_matmul_int4", "pq_topk"])
def test_f12_kernel_wrappers_positional(kernel):
    """Through ``num_valid`` the positional call is the reference's (its
    answer, from the interpret-mode kernel); a positional ``tile_n``, the
    reference's fifth argument, raises."""
    import importlib
    from instsearch_tpu.ops import quantize as jquant
    jpq, jtk, pq_scan, topk_matmul = (
        importlib.import_module(f"{pkg}.kernels.{m}")
        for pkg in ("instsearch_tpu", "instsearch_torch")
        for m in ("pq_scan", "topk_matmul"))
    from instsearch_torch.ops import quantize as tquant
    x, q = _store(256, 64)
    if kernel == "pq_topk":
        from instsearch_tpu.ops.pq import encode_pq as jencode, fit_pq
        from instsearch_torch.ops.pq import PQCodebook
        cb = fit_pq(jnp.asarray(x), 8, iters=2, seed=0)
        codes = np.asarray(jencode(jnp.asarray(x), cb))
        jargs = (jnp.asarray(codes), jnp.asarray(q), cb)
        targs = (torch.from_numpy(codes), torch.from_numpy(q),
                 PQCodebook(torch.from_numpy(np.asarray(cb.centroids))))
        jfn, tfn = jpq.pq_topk, pq_scan.pq_topk
    elif kernel == "topk_matmul":
        jargs = (jnp.asarray(x), jnp.asarray(q))
        targs = (torch.from_numpy(x), torch.from_numpy(q))
        jfn, tfn = jtk.topk_matmul, topk_matmul.topk_matmul
    else:
        int4 = kernel.endswith("int4")
        qr = (jquant.quantize_rows_int4 if int4 else jquant.quantize_rows)(
            jnp.asarray(x))
        tq = (tquant.quantize_rows_int4 if int4 else tquant.quantize_rows)(
            torch.from_numpy(x))
        jargs = (qr.values, qr.scales, jnp.asarray(q))
        targs = (tq.values, tq.scales, torch.from_numpy(q))
        jfn, tfn = getattr(jtk, kernel), getattr(topk_matmul, kernel)
    js, ji = jfn(*jargs, 5, 200, interpret=True)
    ts, ti = tfn(*targs, 5, 200)
    np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
    np.testing.assert_allclose(np.asarray(ts), np.asarray(js), atol=1e-5)
    with pytest.raises(TypeError):
        tfn(*targs, 5, 200, 128)


def test_f12_get_backbone_and_resnet_positional():
    from instsearch_tpu.models import registry as jreg
    from instsearch_tpu.models import resnet as jresnet
    from instsearch_torch.models import registry, resnet
    model, spec = registry.get_backbone("vit_b_16", torch.float32, "xla",
                                        device="meta")
    jmodel, jspec = jreg.get_backbone("vit_b_16", jnp.float32, "xla")
    routes = {m.attention for m in model.modules()
              if isinstance(getattr(m, "attention", None), str)}
    assert routes == {jmodel.attention} == {"xla"}
    assert (spec.feature_dim, spec.stride) == (jspec.feature_dim,
                                               jspec.stride)
    with pytest.raises(TypeError):                # device is keyword-only
        registry.get_backbone("resnet18", torch.float32, "xla", "meta")
    # ResNet(stage_sizes, dtype, block): the reference's order
    net = resnet.ResNet((1, 1, 1, 1), torch.float32, resnet.BasicBlock,
                        device="meta")
    jnet = jresnet.ResNet((1, 1, 1, 1), jnp.float32, jresnet.BasicBlock)
    assert net.dtype == torch.float32 and jnet.dtype == jnp.float32
    assert isinstance(net.layer1[0], resnet.BasicBlock)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    jcount = sum(int(np.prod(s.shape))
                 for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in net.parameters()) == jcount


def test_f12_serve_batch_positional():
    """``serve_batch(idx, sidx, batch, scfg, buckets)`` in both packages over
    a stand-in index that answers each piece from its pixels: the same
    pieces, the same sharded index passed on, the same answers."""
    from instsearch_tpu.serve import serve_batch as jserve_batch
    from instsearch_torch.serve import serve_batch

    class Stub:
        def __init__(self):
            self.calls = []

        def query_images(self, piece, scfg, sharded_index=None, subset=None):
            self.calls.append((piece.shape[0], sharded_index, subset))
            s = piece.reshape(piece.shape[0], -1)[:, :3].astype(np.float32)
            return s, s.astype(np.int32) + 1

    batch = np.arange(11 * 2 * 2 * 3, dtype=np.uint8).reshape(11, 2, 2, 3)
    sidx = object()
    want, got = Stub(), Stub()
    js, ji = jserve_batch(want, sidx, batch, None, [1, 2, 4])
    ts, ti = serve_batch(got, sidx, batch, None, [1, 2, 4])
    assert got.calls == want.calls and got.calls[0][1] is sidx
    np.testing.assert_array_equal(ts, np.asarray(js))
    np.testing.assert_array_equal(ti, np.asarray(ji))


def test_f12_index_from_descriptors_and_load_positional(tmp_path):
    """``from_descriptors(x, names, cfg, None, None, False)`` and
    ``Index.load(path, None, mesh)``: the reference's answers."""
    from instsearch_tpu.index import Index as JIndex
    from instsearch_tpu.parallel.mesh import make_mesh as jmake_mesh
    from instsearch_torch.index import Index
    from instsearch_torch.parallel.mesh import make_mesh
    x, q = _store()
    jcfg, tcfg = _cfgs(dict(k=5, use_pallas=False), dtype="bfloat16")
    names = [f"r{i}" for i in range(len(x))]
    jidx = JIndex.from_descriptors(x, names, jcfg, None, None, False)
    with pytest.raises(TypeError):          # device is keyword-only
        Index.from_descriptors(x, names, tcfg, None, None, False, "cpu")
    tidx = Index.from_descriptors(x, names, tcfg, None, None, False,
                                  device="cpu")
    js, ji = jidx.search(q)
    ts, ti = tidx.search(q)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), atol=1e-6)
    tidx.save(str(tmp_path / "idx"), streaming=False)
    jback = JIndex.load(str(tmp_path / "idx"), None, jmake_mesh(2))
    back = Index.load(str(tmp_path / "idx"), None,
                      make_mesh(2, devices=["cpu"] * 2))
    assert back.placed
    js, ji = jback.search(q)
    ts, ti = back.search(q)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), atol=1e-6)


def test_f12_extractor_and_build_positional_mesh(tmp_path):
    """``Extractor(cfg, variables, whitening, seed, mesh)``,
    ``Index.build(paths, cfg, variables, whitening_paths, whitening, seed,
    mesh)`` and ``ResumableBuilder(paths, cfg, out_dir, group_size,
    variables, seed, mesh)``: the fifth/seventh argument is the mesh, as
    the keyword form (which tests/test_torch_dp.py holds to the reference's
    single device); the extractor's answers equal the keyword form's."""
    from PIL import Image
    from instsearch_torch import config as tc
    from instsearch_torch.builder import ResumableBuilder
    from instsearch_torch.extractor import Extractor
    from instsearch_torch.index import Index
    from instsearch_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(13)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"im{i}.png")
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(p)
    ecfg = tc.ExtractConfig(backbone="resnet18", image_size=32, dtype=
                            "float32", batch_size=2, whiten=False)
    cfg = tc.PipelineConfig(extract=ecfg, index=tc.IndexConfig(
        dtype="float32", row_tile=8), search=tc.SearchConfig(k=2))
    mesh = make_mesh(2, devices=["cpu"] * 2)
    ex = Extractor(ecfg, None, None, 0, mesh, device="cpu")
    kw = Extractor(ecfg, seed=0, mesh=mesh, device="cpu")
    assert ex.mesh is mesh
    imgs = rng.integers(0, 255, (4, 32, 32, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ex(imgs).numpy(), kw(imgs).numpy())
    with pytest.raises(TypeError):
        Extractor(ecfg, None, None, 0, mesh, "cpu")
    idx = Index.build(paths, cfg, None, None, None, 0, mesh, device="cpu")
    assert idx.extractor.mesh is mesh and idx.num_valid == 4
    rb = ResumableBuilder(paths, cfg, str(tmp_path / "rb"), 2, None, 0,
                          mesh, device="cpu")
    assert rb.extractor.mesh is mesh


def test_f12_parallel_idioms_raise(tmp_path):
    """The reference's ``variables``/``axis`` arguments of parallel/*,
    passed positionally, raise ``TypeError`` in the port."""
    from instsearch_torch.models.vit import ViT
    from instsearch_torch.parallel import ep, mesh as pmesh, multihost
    from instsearch_torch.parallel import pp, sp, tp
    from instsearch_torch.ops.local_whiten import LocalWhiteningParams
    vit = ViT(16, 2, 2, 32, 4, 16, dtype=torch.float32, device="cpu")
    m2 = pmesh.ShardMesh(("cpu",) * 2, axis="pipe")
    rows = torch.zeros((8, 4))
    calls = {
        "place_pp": lambda: pp.place_pp(m2, vit, {}, "pipe"),
        "place_sp": lambda: sp.place_sp(m2, {}),
        "place_tp": lambda: tp.place_tp(m2, {}),
        "stack_layer_params": lambda: pp.stack_layer_params(vit, {}),
        "expert_whiten_fn": lambda: ep.expert_whiten_fn(m2, "expert"),
        "place_ep": lambda: ep.place_ep(m2, LocalWhiteningParams(
            rows, rows, rows), "expert"),
        "shard_rows": lambda: pmesh.shard_rows(m2, rows, "shard"),
        "shard_local_rows": lambda: multihost.shard_local_rows(
            m2, rows, "shard"),
    }
    for name, call in calls.items():
        with pytest.raises(TypeError):
            call()
    # the port's own forms, by keyword
    assert len(pmesh.shard_rows(m2, rows, dim=0)) == 2
    assert len(pp.place_pp(m2, vit, axis="pipe")[0]) == 1


# ---------------------------------------------------------------------------
# Queue 1 item 2: rescale's methods, candidates, l2_normalize, rmac_pool
# ---------------------------------------------------------------------------

# jax.image.resize's methods, each with its other spellings
_METHODS = [("nearest",), ("bilinear", "linear"), ("cubic", "bicubic"),
            ("lanczos3",), ("lanczos5",)]


@pytest.mark.parametrize("names", _METHODS, ids=lambda n: n[0])
def test_rescale_methods_match_jax_image_resize(names):
    method = names[0]
    from instsearch_tpu.data import frontend as jfrontend
    from instsearch_torch.data import frontend
    rng = np.random.default_rng(14)
    x = rng.random((2, 17, 23, 3)).astype(np.float32)        # range [0, 1)
    for scale in (0.37, 1.3, 2.0):
        want = np.asarray(jfrontend.rescale(jnp.asarray(x), scale, method))
        got = frontend.rescale(torch.from_numpy(x), scale, method).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        tol = 0.0 if method == "nearest" else 1e-5
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f"scale {scale}")
    u8 = rng.integers(0, 256, (1, 9, 12, 3), dtype=np.uint8)
    want = np.asarray(jfrontend.rescale(jnp.asarray(u8), 0.6, method))
    got = frontend.rescale(torch.from_numpy(u8), 0.6, method).numpy()
    assert got.dtype == want.dtype                 # f32 but for nearest
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0,
                               atol=1e-5 * 255)
    for other in names[1:]:                        # the same method
        np.testing.assert_array_equal(
            frontend.rescale(torch.from_numpy(x), 0.5, other).numpy(),
            frontend.rescale(torch.from_numpy(x), 0.5, method).numpy())


def test_rescale_unknown_method_raises_as_the_reference():
    from instsearch_tpu.data import frontend as jfrontend
    from instsearch_torch.data import frontend
    x = np.zeros((1, 8, 8, 3), np.float32)
    with pytest.raises(ValueError):
        jfrontend.rescale(jnp.asarray(x), 0.5, "area")
    with pytest.raises(ValueError):
        frontend.rescale(torch.from_numpy(x), 0.5, "area")
    # an unchanged size returns the images before the method is read
    assert frontend.rescale(torch.from_numpy(x), 1.0, "area").shape == \
        np.asarray(jfrontend.rescale(jnp.asarray(x), 1.0, "area")).shape


@pytest.mark.parametrize("use_pallas", [None, False, True])
def test_pq_candidates_use_pallas(use_pallas, monkeypatch):
    """``candidates(index, q, depth, use_pallas)`` positionally: the
    reference's plain route's answers on every route (K4's plain version
    on the CPU); True scans through ``pq_topk``, False never, None as the
    index's ``cfg.search.use_pallas`` (False here)."""
    from instsearch_tpu.index import Index as JIndex
    from instsearch_torch.index import Index
    from instsearch_torch.search import pq_view
    from instsearch_torch.search.pq_view import PQView
    x, q = _store(300, 32, seed=15)
    jcfg, tcfg = _cfgs(dict(k=5, use_pallas=False))
    names = [f"r{i}" for i in range(300)]
    jidx = JIndex.from_descriptors(x, names, jcfg)
    jv = jidx.build_pq(m=8, iters=3, depth=20)
    tidx = Index.from_descriptors(x, names, tcfg, device="cpu")
    tv = PQView.from_arrays(np.asarray(jv.codebook.centroids),
                            np.asarray(jv.codes), 20, device="cpu")
    calls = []
    real = pq_view.pq_topk
    monkeypatch.setattr(pq_view, "pq_topk",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    js, jp = jv.candidates(jidx, jnp.asarray(q), 20, False)
    ts, tp = tv.candidates(tidx, q, 20, use_pallas)
    assert bool(calls) == bool(use_pallas)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


def test_l2_normalize_axis():
    from instsearch_tpu.ops import pooling as jpool
    from instsearch_torch.ops import pooling as tpool
    rng = np.random.default_rng(16)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32)
    for axis in (0, 1, -1):
        want = np.asarray(jpool.l2_normalize(jnp.asarray(x), axis))
        np.testing.assert_allclose(
            tpool.l2_normalize(torch.from_numpy(x), axis).numpy(), want,
            atol=1e-6)
        np.testing.assert_allclose(
            tpool.l2_normalize(torch.from_numpy(x), axis=axis).numpy(),
            want, atol=1e-6)


def test_rmac_pool_whiten():
    from instsearch_tpu.ops import pooling as jpool
    from instsearch_tpu.ops.whitening import WhiteningParams as JW
    from instsearch_torch.ops import pooling as tpool
    from instsearch_torch.ops.whitening import WhiteningParams
    rng = np.random.default_rng(17)
    fmap = np.abs(rng.standard_normal((2, 7, 9, 16))).astype(np.float32)
    mu = rng.standard_normal(16).astype(np.float32) * 0.1
    P = rng.standard_normal((8, 16)).astype(np.float32)
    want = np.asarray(jpool.rmac_pool(jnp.asarray(fmap), 3, JW(
        P=jnp.asarray(P), mu=jnp.asarray(mu))))
    got = tpool.rmac_pool(torch.from_numpy(fmap), 3, WhiteningParams(
        P=torch.from_numpy(P), mu=torch.from_numpy(mu))).numpy()
    assert got.shape == want.shape == (2, 8)
    np.testing.assert_allclose(got, want, atol=1e-6)
