"""Descriptor ops of the port: pooling, L2 normalization, whitening."""
from .pooling import avg_pool, gem_pool, l2_normalize, mac_pool, pool
from .whitening import WhiteningParams, apply_whitening, fit_whitening

__all__ = ["avg_pool", "gem_pool", "l2_normalize", "mac_pool", "pool",
           "WhiteningParams", "apply_whitening", "fit_whitening"]
