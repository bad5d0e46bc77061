"""The port imports no JAX: in a fresh interpreter (this test process
already holds JAX through tests/conftest.py), import instsearch_torch and its
evaluation package, build a tiny bf16 Index and a tiny int4 one on the CPU,
search them (the second with alpha query expansion, then through a PQ
cascade view), re-rank the first against a regional store with the spatial
vote and refine an int4 one against its int8 copy, search and re-rank the
first through four CPU shards (``instsearch_torch.parallel``), run VGG16
with R-MAC through the combined global and regional extraction, run a tiny
ViT on its three attention routes and the multi-scale resize and a tiny
ResNet through ``fused_resnet_apply`` (its identity blocks through K7's
plain version), save the int4 index with its PQ view and load it back,
search it under a subset, add and remove rows, range-search it and cut a
subset over four CPU shards, augment a store (αDBA through four CPU
shards), search it with αQE and diffusion, take its kNN graph and stats,
fit a local-whitening view, search under it and apply its bank over two
expert shards, build an IVF view (``search/ivf.py``) and an IVF-PQ view
(``search/ivfpq.py``, also through two CPU shards), serve vectors from a
host row store through ``VectorServeCore``, import the entry points (the
command line, ``ResumableBuilder``, ``workloads.py``, ``serve_tcp``, the
input pipeline and native decoder, the dataset loaders and anchors, the
torchvision importer, the observability helpers) and run ``cli info`` on
a saved index, take a fine-tuning step (``instsearch_torch.train``), mine
hard negatives and write and read the port's checkpoint
(``instsearch_torch.utils.checkpoint``), search an l2 index and range-search
it through four CPU shards, load a saved index placed over four CPU shards
(``Index.load(mesh=)``) and search it, save an index as the port's stream,
load it placed and save it again, write and read a sharded tree
(``save_sharded_pytree``/``load_sharded_pytree``), batch images through
``grain_dataset``, run ``compute_ap``, ``precision_at``,
``evaluate_scores``, ``all_scores`` and ``regional_rerank_scores``, extract
data-parallel over a 2-D
mesh (``Extractor(mesh=)``), run a tiny ViT tensor-parallel (also through
``Extractor`` over a ``('data', 'model')`` mesh), pipelined and sequence-
parallel over CPU devices (``parallel/tp.py``, ``pp.py``, ``sp.py``), run
two benchmark stages (``instsearch_torch.bench``) at toy size, then
check sys.modules: neither JAX nor any module of the reference package was
loaded, nor orbax, tensorstore, grain or ``tools/orbax_to_port.py``. A scan
of the package's import statements finds none of them either."""
import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import json, sys
import numpy as np
import instsearch_torch
import instsearch_torch.eval
from instsearch_torch import PipelineConfig, IndexConfig
from instsearch_torch.index import Index
from instsearch_torch.serve import ServeCore

rng = np.random.default_rng(0)
x = rng.standard_normal((40, 16)).astype(np.float32)
x /= np.linalg.norm(x, axis=1, keepdims=True)
cfg = PipelineConfig(index=IndexConfig(row_tile=16))
idx = Index.from_descriptors(x, [f"r{i}" for i in range(40)], cfg,
                             device="cpu")
s, i = idx.search(x[:3])
qcfg = PipelineConfig(index=IndexConfig(row_tile=16, dtype="int4"))
qidx = Index.from_descriptors(x, [f"r{i}" for i in range(40)], qcfg,
                              device="cpu")
qs, qi = qidx.search(x[:3], qcfg.search.replace(qe_enabled=True))
assert qi[:, 0].tolist() == i[:, 0].tolist()
qidx.build_pq(m=4, iters=3, depth=40)
ps, pi = qidx.search(x[:3], qidx.cfg.search.replace(qe_enabled=True))
assert pi[:, 0].tolist() == i[:, 0].tolist()
import torch
from instsearch_torch import ExtractConfig, SearchConfig
from instsearch_torch.extractor import Extractor
from instsearch_torch.index import attach_regional_store
from instsearch_torch.ops.pooling import rmac_region_geometry
reg = rng.standard_normal((40, 14, 16)).astype(np.float32)
reg /= np.linalg.norm(reg, axis=-1, keepdims=True)
attach_regional_store(idx, reg)
idx.regional_geom = rmac_region_geometry(6, 6, 3)
rr = SearchConfig(rerank_enabled=True, rerank_depth=20, spatial_weight=0.5)
rs, ri = idx.search(x[:3], rr, query_regional=reg[:3])
assert ri[:, 0].tolist() == [0, 1, 2]
rcfg = PipelineConfig(index=IndexConfig(row_tile=16, dtype="int4",
                                        refine_dtype="int8"),
                      search=SearchConfig(refine_enabled=True))
ridx = Index.from_descriptors(x, [f"r{i}" for i in range(40)], rcfg,
                              device="cpu")
assert ridx.search(x[:3])[1][:, 0].tolist() == [0, 1, 2]
import instsearch_torch.parallel
from instsearch_torch.parallel import make_mesh
sidx = idx.to_sharded(mesh=make_mesh(4, devices=["cpu"] * 4))
ss, si = sidx.search(x[:3])
assert si.tolist() == i.tolist()
rs, ri = sidx.search_rerank(x[:3], reg[:3], depth=20)
assert ri[:, 0].tolist() == [0, 1, 2]
ex = Extractor(ExtractConfig(backbone="vgg16", pooling="rmac",
                             image_size=32), device="cpu")
g, r = ex.extract_with_regional(np.zeros((1, 32, 32, 3), np.uint8))
assert tuple(g.shape) == (1, 512) and tuple(r.shape) == (1, 14, 512)
import instsearch_torch.kernels.vit_attention
import instsearch_torch.ops.resize
from instsearch_torch.data.frontend import rescale
from instsearch_torch.models.vit import ViT
img = torch.rand(1, 20, 20, 3)
for att in ("xla", "pallas", "flash"):
    vit = ViT(hidden_dim=16, num_layers=1, num_heads=2, mlp_dim=32,
              patch_size=4, image_size=16, dtype=torch.float32,
              attention=att, device="cpu")
    vit.init_weights(torch.Generator().manual_seed(0))
    assert tuple(vit(rescale(img, 0.8)).shape) == (1, 4, 4, 16)
from instsearch_torch.kernels.fused_resnet import fused_resnet_apply
from instsearch_torch.models.resnet import Bottleneck, ResNet
net = ResNet((1, 2, 1, 1), block=Bottleneck, device="cpu")
net.init_weights(torch.Generator().manual_seed(0))
feats = fused_resnet_apply(net.state_dict(), torch.rand(1, 32, 32, 3),
                           stage_sizes=(1, 2, 1, 1), fused_layers=(1, 2, 3, 4))
assert tuple(feats.shape) == (1, 1, 1, 2048) and feats.dtype == torch.bfloat16
import tempfile
import instsearch_torch.search.subset
with tempfile.TemporaryDirectory() as tmp:
    qidx.save(tmp)
    live = Index.load(tmp, device="cpu")
assert torch.equal(live.pq.packed, qidx.pq.packed)
sub = live.make_subset(names=["r0", "r2", "r4"])
assert sorted(live.search(x[:3], subset=sub)[1][0, :3].tolist()) == [0, 2, 4]
assert live.add(descriptors=x[:2], names=["n0", "n1"]) == 2
assert live.remove(["r1", "r39"]) == 2
rs, ri, rc = live.search_range(x[:2], 0.5)
assert rc.tolist() == [3, 1] and ri[:, 0].tolist() == [0, 41]
assert ri[0, 1] == 40 and rs[0, 0] == rs[0, 1]
ssub = live.make_subset(names=["n0", "r5"])
lsidx = live.to_sharded(mesh=make_mesh(4, devices=["cpu"] * 4))
assert live.search_sharded(lsidx, x[:1], subset=ssub)[1][0, :2].tolist() \
    == [40, 5]
import instsearch_torch.ops.kmeans
import instsearch_torch.ops.local_whiten
import instsearch_torch.search.dba
import instsearch_torch.search.diffusion
import instsearch_torch.search.lw_rerank
import instsearch_torch.parallel.ep
from instsearch_torch.ops.local_whiten import apply_local_whitening
from instsearch_torch.parallel import expert_whiten_fn
qcfg = PipelineConfig(index=IndexConfig(row_tile=16, dba_n=4),
                      search=SearchConfig(diffusion_enabled=True,
                                          diffusion_depth=20,
                                          qe_enabled=True))
qual = Index.from_descriptors(x, [f"r{i}" for i in range(40)], qcfg,
                              device="cpu")
twin = Index.from_descriptors(x, [f"r{i}" for i in range(40)], qcfg,
                              device="cpu")
qual.augment_database(mesh=make_mesh(4, devices=["cpu"] * 4))
twin.augment_database()
assert torch.equal(qual.descriptors, twin.descriptors)
assert np.isfinite(qual.search(x[:3])[0]).all()
assert qual.knn_graph(k=3)[1].shape == (40, 3)
assert qual.stats()["rows"] == 40
view = qual.fit_local_whitening(n_clusters=2)
assert qual.search(x[:3], qual.cfg.search.replace(
    diffusion_enabled=False))[1][:, 0].tolist() == [0, 1, 2]
ep = expert_whiten_fn(make_mesh(2, devices=["cpu"] * 2))(
    view.params, torch.as_tensor(x))
assert torch.equal(ep, apply_local_whitening(torch.as_tensor(x),
                                             view.params))
import instsearch_torch.search.ivf
import instsearch_torch.search.ivfpq
from instsearch_torch.search.ivfpq import HostRowStore, IVFPQView
from instsearch_torch.serve import VectorServeCore
ivf_idx = Index.from_descriptors(x, [f"r{i}" for i in range(40)], cfg,
                                 device="cpu")
ivf_idx.build_ivf(n_clusters=4, nprobe=4)
assert ivf_idx.search(x[:3])[1][:, 0].tolist() == [0, 1, 2]
pq_idx = Index.from_descriptors(
    x, [f"r{i}" for i in range(40)],
    PipelineConfig(index=IndexConfig(row_tile=16, dtype="int4")),
    device="cpu")
pq_idx.build_ivfpq(n_clusters=4, nprobe=4, m=4, depth=40)
assert pq_idx.search(x[:3])[1][:, 0].tolist() == [0, 1, 2]
psidx = pq_idx.to_sharded(mesh=make_mesh(2, devices=["cpu"] * 2))
assert psidx.search_ivfpq(x[:3])[1][:, 0].tolist() == [0, 1, 2]
with tempfile.TemporaryDirectory() as tmp:
    store = HostRowStore.create(tmp, x)
    hview = IVFPQView.from_host_store(store, n_clusters=4, m=4, depth=40,
                                      device="cpu")
    vcore = VectorServeCore(store, hview, device="cpu")
    ans = vcore.handle_line(json.dumps({"vectors": x[:2].tolist()}))
    assert [r[0]["id"] for r in ans["results"]] == [0, 1]
import contextlib
import io
import instsearch_torch.builder
import instsearch_torch.cli
import instsearch_torch.data.loader
import instsearch_torch.data.native_frontend
import instsearch_torch.eval.anchors
import instsearch_torch.eval.datasets
import instsearch_torch.models.torch_import
import instsearch_torch.serve
import instsearch_torch.utils.observe
import instsearch_torch.workloads
from instsearch_torch.serve import serve_tcp
with tempfile.TemporaryDirectory() as tmp:
    qidx.save(tmp)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert instsearch_torch.cli.main(["--device", "cpu", "info",
                                          "--index", tmp]) == 0
    assert json.loads(out.getvalue())["rows"] == 40
assert instsearch_torch.workloads.list_presets()
import instsearch_torch.train
import instsearch_torch.train.finetune
import instsearch_torch.utils.checkpoint
from instsearch_torch.config import TrainConfig
from instsearch_torch.train import Trainer
from instsearch_torch.train.mining import mine_hard_negatives
tr = Trainer(TrainConfig(backbone="resnet18", image_size=32, batch_size=2,
                         num_negatives=1, dtype="float32"), device="cpu")
tuples = np.random.default_rng(0).random((2, 3, 32, 32, 3), dtype=np.float32)
assert np.isfinite(tr.step(tuples)["loss"])
assert mine_hard_negatives(x, np.arange(40) % 3, x[:2], np.arange(2),
                           num_negatives=2, device="cpu").shape == (2, 2)
with tempfile.TemporaryDirectory() as tmp:
    instsearch_torch.utils.checkpoint.save_pytree(tmp, tr.variables)
    assert set(instsearch_torch.utils.checkpoint.load_pytree(tmp)) == set(
        tr.variables)
l2 = Index.from_descriptors(3.0 * x, [f"r{i}" for i in range(40)],
                           PipelineConfig(index=IndexConfig(
                               row_tile=16, metric="l2", dtype="float32")),
                           device="cpu")
l2s, l2i = l2.search(3.0 * x[:3])
assert l2i[:, 0].tolist() == [0, 1, 2] and np.abs(l2s[:, 0]).max() < 1e-3
assert l2.search_range(3.0 * x[:2], 0.1, mesh=make_mesh(
    4, devices=["cpu"] * 4))[2].tolist() == [1, 1]
with tempfile.TemporaryDirectory() as tmp:
    idx.save(tmp)
    placed = Index.load(tmp, mesh=make_mesh(4, devices=["cpu"] * 4))
    assert placed.search(x[:3])[1][:, 0].tolist() == [0, 1, 2]
    assert placed.placed
from instsearch_torch.parallel import make_mesh_2d
dp = Extractor(ExtractConfig(backbone="resnet18", image_size=32,
                             dtype="float32"),
               mesh=make_mesh_2d(2, 1, devices=["cpu"] * 2))
assert tuple(dp(np.zeros((3, 32, 32, 3), np.uint8)).shape) == (3, 512)
from instsearch_torch.models.vit import ViT
from instsearch_torch.parallel import (ShardMesh, make_mesh_dp_tp,
                                       pipelined_vit_fn, place_pp, place_sp,
                                       place_tp, sequence_parallel_vit_fn)
from instsearch_torch.parallel.tp import TensorParallelViT
vit = ViT(32, 4, 4, 64, 4, 16, dtype=torch.float32, device="cpu")
gen = torch.Generator()
gen.manual_seed(0)
vit.init_weights(gen)
imgs = torch.rand((4, 16, 16, 3), generator=gen)
cpus = lambda n, axis: ShardMesh((torch.device("cpu"),) * n, axis=axis)
with torch.inference_mode():
    want = vit(imgs)
    tpm = cpus(2, "model")
    got = [TensorParallelViT(vit, tpm.devices,
                             place_tp(tpm, model=vit)[0])(imgs),
           pipelined_vit_fn(vit, cpus(2, "pipe"), 2)(
               *place_pp(cpus(2, "pipe"), vit), imgs),
           sequence_parallel_vit_fn(vit, cpus(4, "seq"))(
               place_sp(cpus(4, "seq"), model=vit), imgs)]
assert all(float((g - want).abs().max()) < 1e-4 for g in got)
import instsearch_torch.models.registry as treg
treg.BACKBONES["vit_tiny"] = treg.BackboneSpec(
    lambda dtype, attention, device: ViT(32, 2, 4, 64, 4, 16, dtype=dtype,
                                         attention=attention, device=device),
    32, 4)
tpx = Extractor(ExtractConfig(backbone="vit_tiny", image_size=16,
                              dtype="float32", vit_attention="flash"),
                mesh=make_mesh_dp_tp(2, 2, devices=["cpu"] * 4))
assert tpx.cfg.vit_attention == "xla"
assert tuple(tpx(np.zeros((3, 16, 16, 3), np.uint8)).shape) == (3, 32)
import tempfile
from instsearch_torch.data.loader import grain_dataset
from instsearch_torch.eval import (compute_ap, evaluate_scores,
                                   make_mini_dataset, precision_at)
from instsearch_torch.parallel import shard_rows
from instsearch_torch.search import all_scores, regional_rerank_scores
from instsearch_torch.utils.checkpoint import (Placed, load_sharded_pytree,
                                               save_sharded_pytree)
stmp = tempfile.mkdtemp()
m4 = make_mesh(4, devices=["cpu"] * 4)
sidx = Index.from_descriptors(x, [f"r{i}" for i in range(40)], cfg,
                              device="cpu")
attach_regional_store(sidx, reg)
sidx.save(stmp + "/stream", streaming=True)
splaced = Index.load(stmp + "/stream", mesh=m4)
assert splaced.placed and json.load(open(stmp + "/stream/meta.json"))[
    "format"] == Index.STREAM_FORMAT
assert splaced.search(x[:3])[1][:, 0].tolist() == [0, 1, 2]
splaced.save(stmp + "/again")
tt = torch.arange(32.0).reshape(8, 4).to(torch.bfloat16)
save_sharded_pytree(stmp + "/tree", {"t": Placed(shard_rows(m4, tt), 0, m4)})
assert torch.equal(torch.cat(load_sharded_pytree(
    stmp + "/tree", {"t": (m4, 0)})["t"]), tt)
mini = make_mini_dataset(stmp + "/mini", n_instances=2, n_views=2,
                         n_distractors=1, seed=5)
assert sum(int((b[1] >= 0).sum()) for b in grain_dataset(
    mini.db_paths, 32, 4)) == len(mini.db_paths)
sc = all_scores(torch.from_numpy(x), torch.from_numpy(x[:3]))
gnd = [{"easy": [r], "hard": [], "junk": []} for r in range(3)]
assert evaluate_scores(sc.numpy(), gnd)["mAP"] == 100.0
assert compute_ap(np.array([0, 1]), {0}, set()) == 1.0
assert precision_at(np.array([0, 1]), {1}, set(), 1) == 0.0
rs2, ri2 = regional_rerank_scores(torch.from_numpy(reg),
                                  torch.arange(40, dtype=torch.int32), sc,
                                  torch.from_numpy(reg[:3]), depth=10, k=3)
assert ri2[:, 0].tolist() == [0, 1, 2]
from instsearch_torch import bench
assert bench.bench_query(n=256, d=16, k=3, device="cpu")["path"] == "plain"
assert bench.bench_protocol_eval(n=256, n_queries=4, d=16,
                                 device="cpu")["n"] == 256
print(json.dumps({"top1": i[:, 0].tolist(), "rows": idx.descriptors.shape[0],
                  "jax": "jax" in sys.modules, "flax": "flax" in sys.modules,
                  "others": [m for m in ("orbax", "tensorstore", "grain",
                                         "orbax_to_port")
                             if any(k == m or k.startswith(m + ".")
                                    for k in sys.modules)],
                  "reference": [m for m in sys.modules
                                if m.startswith("instsearch_tpu")]}))
"""


def test_port_never_imports_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                         text=True, timeout=120, cwd=_ROOT)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["top1"] == [0, 1, 2]
    assert res["rows"] == 48                 # padded to the row tile
    assert res["jax"] is False and res["flax"] is False
    assert res["others"] == []
    assert res["reference"] == []


def test_package_never_imports_the_converter():
    """No module of instsearch_torch imports ``tools/orbax_to_port.py``
    (nor ``tools``, orbax, tensorstore or grain): the converter runs where
    JAX does, the package where it does not. Nor do the port's
    multi-process test workers (``tests/torch_*_worker.py``), which run
    without JAX."""
    import ast
    import glob
    banned = ("tools", "orbax_to_port", "orbax", "tensorstore", "grain",
              "jax", "flax", "instsearch_tpu")
    pkg = os.path.join(_ROOT, "instsearch_torch")
    workers = sorted(glob.glob(os.path.join(_ROOT, "tests",
                                            "torch_*_worker.py")))
    assert any(w.endswith("torch_mp_vit_worker.py") for w in workers)
    paths = [os.path.join(base, name) for base, _, files in os.walk(pkg)
             for name in files if name.endswith(".py")] + workers
    seen = 0
    for path in paths:
        name = os.path.basename(path)
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mods = [node.module or ""]
            else:
                continue
            seen += 1
            for m in mods:
                assert m.split(".")[0] not in banned, (name, m)
    assert seen > 100
