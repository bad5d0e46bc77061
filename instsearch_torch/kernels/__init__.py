"""Hand-written Hopper kernels of the port, each beside its plain version."""
from .topk_matmul import (topk_matmul, topk_matmul_int4,
                          topk_matmul_int4_reference, topk_matmul_int8,
                          topk_matmul_int8_reference, topk_matmul_reference)

__all__ = ["topk_matmul", "topk_matmul_reference", "topk_matmul_int8",
           "topk_matmul_int8_reference", "topk_matmul_int4",
           "topk_matmul_int4_reference"]
