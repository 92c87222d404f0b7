"""SDRBench-proxy field generators and the synthetic training data (copies
of the reference's)."""
