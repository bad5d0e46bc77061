"""Meshes and what runs over them (port of ``instsearch_tpu/parallel``): the
1-D and 2-D meshes (in one process or over a process group), the
row-sharded index and its multi-process form, the expert-parallel local
whitening, and the ViT's model-parallel forwards, in one process or
across processes: tensor parallel (``tp``), the GPipe pipeline (``pp``)
and the sequence-parallel forward (``sp``)."""
from .ep import expert_whiten_fn, place_ep
from .mesh import (AxisGroup, DeviceMesh, ShardMesh, as_shard_mesh,
                   axis_groups, default_data_mesh, device_mesh,
                   make_device_mesh, make_mesh, make_mesh_2d,
                   make_mesh_dp_tp, replicate, shard_rows)
from .pp import pipelined_vit_fn, place_pp, stack_layer_params
from .sp import place_sp, sequence_parallel_vit_fn
from .tp import place_tp, tp_param_spec, tp_param_specs
from .multihost import (build_multihost_index, global_mesh_2d,
                        global_mesh_dp_tp, global_shard_mesh, initialize,
                        local_row_range, shard_local_rows)
from .sharded_index import (ShardedIndex, sharded_diffusion, sharded_expand,
                            sharded_lw, sharded_qe_topk, sharded_rerank,
                            sharded_scores, sharded_topk)

__all__ = ["ShardMesh", "DeviceMesh", "AxisGroup", "axis_groups",
           "as_shard_mesh", "default_data_mesh", "device_mesh", "make_mesh",
           "make_device_mesh", "make_mesh_2d", "make_mesh_dp_tp",
           "replicate", "shard_rows",
           "ShardedIndex", "sharded_topk", "sharded_qe_topk",
           "sharded_expand", "sharded_scores", "sharded_rerank",
           "sharded_diffusion", "sharded_lw", "place_ep", "expert_whiten_fn",
           "initialize", "global_shard_mesh", "global_mesh_2d",
           "global_mesh_dp_tp", "build_multihost_index",
           "local_row_range", "shard_local_rows", "place_tp",
           "tp_param_spec", "tp_param_specs", "pipelined_vit_fn", "place_pp",
           "stack_layer_params", "place_sp", "sequence_parallel_vit_fn"]
