"""The `histogram` op: per-row 1024-bin histograms of quant codes."""
