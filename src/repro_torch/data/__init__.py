"""SDRBench-proxy field generators (copy of the reference's)."""
