"""PyTorch / CUDA port of the CEAZ reproduction.

A second package beside the JAX reference (``src/repro``), held to it
bit for bit. The per-value passes run as hand-written Hopper kernels
(``csrc/``, built at first use by ``kernels/_build.py``) behind a
dispatch registry whose plain PyTorch versions serve CPU tensors.

    from repro_torch import CEAZ, CEAZConfig
    comp = CEAZ(CEAZConfig(mode="rel", eb=1e-4))      # runs on the card
    c = comp.compress(x); y = comp.decompress(c)

The package imports torch and numpy only — never jax, never ``repro``.
"""
from .core import CEAZ, CEAZCompressed, CEAZConfig, CompressedChunk

__all__ = ["CEAZ", "CEAZCompressed", "CEAZConfig", "CompressedChunk"]
