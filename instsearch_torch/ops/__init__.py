"""Descriptor ops of the port: pooling (R-MAC included), L2 normalization,
whitening, local (per-cluster) whitening, spherical k-means and per-row
int8/int4 quantization."""
from .kmeans import assign_clusters, fit_kmeans
from .local_whiten import (LocalWhiteningParams, apply_local_whitening,
                           fit_local_whitening, route)
from .pooling import (avg_pool, gem_pool, l2_normalize, mac_pool, pool,
                      rmac_pool, rmac_region_geometry, rmac_region_grid,
                      rmac_regional_descriptors)
from .quantize import (QuantizedRows, dequantize_rows, dequantize_rows_int4,
                       quantize_rows, quantize_rows_int4, unpack_int4)
from .whitening import (WhiteningParams, apply_whitening,
                        apply_whitening_regional, fit_lw_whitening,
                        fit_whitening)

__all__ = ["avg_pool", "gem_pool", "l2_normalize", "mac_pool", "pool",
           "rmac_pool", "rmac_region_geometry", "rmac_region_grid",
           "rmac_regional_descriptors",
           "QuantizedRows", "dequantize_rows", "dequantize_rows_int4",
           "quantize_rows", "quantize_rows_int4", "unpack_int4",
           "WhiteningParams", "apply_whitening", "apply_whitening_regional",
           "fit_whitening", "fit_lw_whitening", "assign_clusters", "fit_kmeans",
           "LocalWhiteningParams", "apply_local_whitening",
           "fit_local_whitening", "route"]
