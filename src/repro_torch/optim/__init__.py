"""Optimizer and the compressed gradient exchange (port of repro.optim)."""
from .adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .grad_compress import (CompressionConfig,  # noqa: F401
                            compressed_cross_pod_mean, ef_init)
