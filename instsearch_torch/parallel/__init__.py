"""Row-sharded search over a shard mesh (port of
``instsearch_tpu/parallel``: the mesh, the sharded index, the multi-process
form, the expert-parallel local whitening and the 2-D meshes; the tp/pp/sp
model-parallel paths are not ported yet)."""
from .ep import expert_whiten_fn, place_ep
from .mesh import (DeviceMesh, ShardMesh, as_shard_mesh, default_data_mesh,
                   device_mesh, make_mesh, make_mesh_2d, make_mesh_dp_tp,
                   replicate, shard_rows)
from .multihost import (build_multihost_index, global_shard_mesh,
                        initialize, local_row_range, shard_local_rows)
from .sharded_index import (ShardedIndex, sharded_diffusion, sharded_expand,
                            sharded_lw, sharded_qe_topk, sharded_rerank,
                            sharded_scores, sharded_topk)

__all__ = ["ShardMesh", "DeviceMesh", "as_shard_mesh", "default_data_mesh",
           "device_mesh", "make_mesh", "make_mesh_2d", "make_mesh_dp_tp",
           "replicate", "shard_rows",
           "ShardedIndex", "sharded_topk", "sharded_qe_topk",
           "sharded_expand", "sharded_scores", "sharded_rerank",
           "sharded_diffusion", "sharded_lw", "place_ep", "expert_whiten_fn",
           "initialize", "global_shard_mesh", "build_multihost_index",
           "local_row_range", "shard_local_rows"]
