"""Codec core of the port: facade, dual-quant, Huffman, codebooks."""
from .ceaz import CEAZ, CEAZCompressed, CEAZConfig, CompressedChunk
from .codebook import AdaptiveCoder, default_offline_codebook
from .huffman import Codebook

__all__ = ["CEAZ", "CEAZCompressed", "CEAZConfig", "CompressedChunk",
           "AdaptiveCoder", "default_offline_codebook", "Codebook"]
