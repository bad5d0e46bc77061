"""Hand-written Hopper kernels of the port, each beside its plain version."""
from .fused_resnet import (fused_identity_blocks,
                           fused_identity_blocks_reference, fused_resnet_apply)
from .pq_scan import pq_topk, pq_topk_reference
from .topk_matmul import (topk_matmul, topk_matmul_int4,
                          topk_matmul_int4_reference, topk_matmul_int8,
                          topk_matmul_int8_reference, topk_matmul_reference)
from .vit_attention import (flash_mha, flash_mha_reference, mha,
                            mha_reference)

__all__ = ["topk_matmul", "topk_matmul_reference", "topk_matmul_int8",
           "topk_matmul_int8_reference", "topk_matmul_int4",
           "topk_matmul_int4_reference", "pq_topk", "pq_topk_reference",
           "mha", "mha_reference", "flash_mha", "flash_mha_reference",
           "fused_identity_blocks", "fused_identity_blocks_reference",
           "fused_resnet_apply"]
