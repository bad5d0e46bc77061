"""Worker of the port's multi-process model-parallel test
(test_torch_mp_vit.py): one of two processes, each with two CPU devices
(``["cpu"] * 2``; four for tp = 8), joined by gloo over the loopback, that
run the ViT's tensor-parallel, pipelined and sequence-parallel forwards and
``Extractor(mesh=)`` on meshes whose axes span the processes.

    python torch_mp_vit_worker.py <rank> <world> <port> <dir>

``<dir>`` holds what the test made from the JAX package (this process
imports no JAX): ``weights.npz``, the tiny ViT's state_dict in the port's
layout (f32), ``images.npy`` (``[4, 16, 16, 3]`` f32 model inputs),
``uint8.npy`` (``[5, 32, 32, 3]`` extractor inputs) and ``png/*.png`` for
``Index.build`` and ``ResumableBuilder``. Every output, with the bytes each
placement holds in this process, goes to ``<dir>/rank<rank>.npz``.
"""
import os
import sys

import numpy as np

TINY = dict(hidden_dim=32, num_heads=4, mlp_dim=64, patch_size=4,
            image_size=16)
LAYERS = 4
NAME = "vit_mp_tiny"
LOCAL = 2                  # CPU devices a process (4 for tp = 8)


def extract_config(**kw):
    """The extractor's config: the tiny ViT, GeM, 32 px, f32."""
    from instsearch_torch import ExtractConfig
    return ExtractConfig(backbone=NAME, pooling="gem", image_size=32,
                         dtype="float32", batch_size=4, **kw)


def pipeline_config():
    from instsearch_torch import IndexConfig, PipelineConfig
    return PipelineConfig(extract=extract_config(whiten=False),
                          index=IndexConfig(dtype="float32", row_tile=8))


def register_backbone() -> None:
    """The tiny ViT under ``NAME`` in the port's registry."""
    import torch

    import instsearch_torch.models.registry as treg
    from instsearch_torch.models.vit import ViT

    def factory(dtype=torch.bfloat16, attention="auto", device=None):
        return ViT(dtype=dtype, attention=attention, device=device,
                   num_layers=LAYERS, **TINY)

    treg.BACKBONES[NAME] = treg.BackboneSpec(factory, 32, 4)


def split_bytes(sd) -> int:
    """Bytes of the tensors tensor parallelism splits, in one state_dict."""
    from instsearch_torch.parallel.tp import tp_param_spec
    return sum(t.numel() * t.element_size() for k, t in sd.items()
               if tp_param_spec(k) is not None)


def main(rank: int, world: int, port: str, folder: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from instsearch_torch.builder import ResumableBuilder
    from instsearch_torch.extractor import Extractor
    from instsearch_torch.index import Index
    from instsearch_torch.models.vit import ViT
    from instsearch_torch.parallel import (ShardMesh, axis_groups,
                                           global_mesh_2d, global_mesh_dp_tp,
                                           initialize,
                                           make_device_mesh, pipelined_vit_fn,
                                           place_pp, place_sp, place_tp,
                                           sequence_parallel_vit_fn)
    from instsearch_torch.parallel.tp import (TensorParallelViT,
                                              split_layer_bytes)
    assert initialize(backend="gloo")
    world_group = dist.group.WORLD
    register_backbone()
    sd = {k: torch.from_numpy(v) for k, v in
          np.load(os.path.join(folder, "weights.npz")).items()}
    x = torch.from_numpy(np.load(os.path.join(folder, "images.npy")))
    u8 = np.load(os.path.join(folder, "uint8.npy"))
    models = {}
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        m = ViT(num_layers=LAYERS, dtype=dtype, device="cpu", **TINY)
        m.load_state_dict(sd)
        models[dt] = m
    res = {}
    with torch.inference_mode():
        res["single_bf16"] = models["bf16"](x).float().numpy()

    def cpus(n=LOCAL):
        return ["cpu"] * n

    with torch.inference_mode():
        # tensor parallel: 1-D 'model' meshes of 4 (head split) and 8
        # (gathered attention), and ('data', 'model') grids with data and
        # with the model axis across the processes
        tp_meshes = {
            "tp4": ShardMesh(tuple(torch.device(d) for d in cpus()),
                             world_group, "model"),
            "tp8": ShardMesh(tuple(torch.device(d) for d in cpus(4)),
                             world_group, "model"),
            "dptp22": global_mesh_dp_tp(2, 2, cpus()),
            "dptp14": global_mesh_dp_tp(1, 4, cpus())}
        for case, mesh in tp_meshes.items():
            lines = axis_groups(mesh, "model")
            for dt, m in models.items():
                placed = place_tp(mesh, m)
                n_data = mesh.shape.get("data", 1)
                share = x.shape[0] // n_data
                outs = [TensorParallelViT(m, line, pl)(
                    x[line.line * share:(line.line + 1) * share])
                    for line, pl in zip(lines, placed)]
                out = (mesh.along("data").gather(outs, 0) if n_data > 1
                       else outs[0])
                res[f"{case}_{dt}"] = out.float().numpy()
                sizes = split_layer_bytes(placed[0])
                res[f"{case}_{dt}_bytes"] = np.array(
                    [sum(sizes["shard_bytes"]), split_bytes(m.state_dict()),
                     len(lines[0]), lines[0].size])
        # the GPipe pipeline: 4 stages over the processes, and
        # ('data', 'pipe') = (2, 2) with the data axis across them
        for case, mesh in (
                ("pp4", ShardMesh(tuple(torch.device(d) for d in cpus()),
                                  world_group, "pipe")),
                ("pp_dp", make_device_mesh((2, 2), ("data", "pipe"), cpus(),
                                           world_group))):
            m = models["f32"]
            rest, stacked = place_pp(mesh, m)
            res[case] = pipelined_vit_fn(m, mesh, n_micro=2)(
                rest, stacked, x).numpy()
            line = axis_groups(mesh, "pipe")[0]
            per = LAYERS // line.size
            res[f"{case}_bytes"] = np.array(
                [sum(t.numel() * t.element_size()
                     for ts in stacked[0].values() for t in ts),
                 sum(t.numel() * t.element_size() for k, t in
                     m.state_dict().items() if k.startswith("encoder_")),
                 len(line), line.size])
            # each local stage holds its own layers, no other's
            res[f"{case}_layers_ok"] = np.array(all(
                torch.equal(stacked[0]["qkv.weight"][j][i],
                            m.state_dict()[f"encoder_layer_"
                                           f"{(line.start + j) * per + i}"
                                           f".qkv.weight"])
                for j in range(len(line)) for i in range(per)))
        # sequence parallel: sp = 4 over the processes, and ('data', 'seq')
        # = (2, 2) with the data axis across them
        for case, mesh in (
                ("sp4", ShardMesh(tuple(torch.device(d) for d in cpus()),
                                  world_group, "seq")),
                ("sp_dp", make_device_mesh((2, 2), ("data", "seq"), cpus(),
                                           world_group))):
            m = models["f32"]
            res[case] = sequence_parallel_vit_fn(m, mesh)(
                place_sp(mesh, m), x).numpy()
    # Extractor(mesh=) end to end: ('data', 'model') with data across
    # the processes, 'model' across them, ('data', 'shard') with data
    # across them, and a 'data' ShardMesh
    for case, mesh in (
            ("ex_dptp22", global_mesh_dp_tp(2, 2, cpus())),
            ("ex_dptp14", global_mesh_dp_tp(1, 4, cpus())),
            ("ex_2d", global_mesh_2d(2, 2, cpus())),
            ("ex_data", ShardMesh(tuple(torch.device(d) for d in cpus()),
                                  world_group, "data"))):
        ex = Extractor(extract_config(vit_attention="flash"), sd,
                       mesh=mesh)
        res[f"{case}_global"] = ex(u8).numpy()
        res[f"{case}_regional"] = ex.extract_regional(u8).numpy()
        res[f"{case}_dp_size"] = np.array(ex.dp_size)
        if ex._copies:
            sizes = split_layer_bytes(ex._copies[0].placement)
            res[f"{case}_bytes"] = np.array(
                [sum(sizes["shard_bytes"]),
                 split_bytes(ex.model.state_dict()),
                 len(ex._copies[0].devices), ex._copies[0].tp])
    # Index.build and ResumableBuilder over a mesh across processes
    paths = sorted(os.path.join(folder, "png", f)
                   for f in os.listdir(os.path.join(folder, "png")))
    mesh = global_mesh_dp_tp(2, 2, cpus())
    built = Index.build(paths, pipeline_config(), variables=sd,
                        mesh=mesh)
    res["build"] = built.descriptors[:built.num_valid].numpy()
    b = ResumableBuilder(paths, pipeline_config(),
                         os.path.join(folder, f"rb{rank}"), group_size=1,
                         variables=sd, mesh=mesh)
    b.run()
    fin = b.finalize()
    res["builder"] = fin.descriptors[:fin.num_valid].numpy()
    res["build_names"] = np.array(built.names + fin.names)
    assert "jax" not in sys.modules
    assert not any(m.startswith("instsearch_tpu") for m in sys.modules)
    np.savez(os.path.join(folder, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
    print(f"MP_OK {rank}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
