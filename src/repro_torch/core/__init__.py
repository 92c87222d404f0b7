"""Codec core of the port: facade, dual-quant, Huffman, codebooks, rate
control and metrics. Exports the reference's ``repro.core`` names, plus
``CompressedChunk``."""
from .ceaz import (CEAZ, CEAZCompressed, CEAZConfig, CompressedChunk,
                   compress, decompress)
from .codebook import (AdaptiveCoder, BankCoder, CodebookBank,
                       build_offline_codebook, default_codebook_bank,
                       default_offline_codebook, lookup_bank,
                       min_update_bytes, register_bank, sigma_of,
                       train_codebook_bank)
from .dualquant import (NUM_SYMBOLS, OUTLIER_CODE, RADIUS, dequantize,
                        dual_quantize, inverse_lorenzo, lorenzo_predict,
                        np_dequantize, np_dual_quantize)
from .huffman import Codebook, decode, encode, entropy_bits
from .metrics import compression_ratio, max_abs_err, psnr, rmse
from .ratecontrol import (FixedRatioController, bitrate_from_ratio,
                          calibrate_eb_for_bitrate, predict_bitrate,
                          predict_eb, ratio_from_bitrate)

__all__ = [
    "CEAZ", "CEAZCompressed", "CEAZConfig", "compress", "decompress",
    "AdaptiveCoder", "BankCoder", "CodebookBank", "build_offline_codebook",
    "default_codebook_bank", "default_offline_codebook", "lookup_bank",
    "min_update_bytes", "register_bank", "train_codebook_bank",
    "sigma_of", "NUM_SYMBOLS", "OUTLIER_CODE", "RADIUS",
    "dequantize", "dual_quantize", "inverse_lorenzo", "lorenzo_predict",
    "np_dequantize", "np_dual_quantize", "Codebook", "decode", "encode",
    "entropy_bits", "compression_ratio", "max_abs_err", "psnr", "rmse",
    "FixedRatioController", "bitrate_from_ratio", "calibrate_eb_for_bitrate",
    "predict_bitrate", "predict_eb", "ratio_from_bitrate",
    "CompressedChunk",
]
