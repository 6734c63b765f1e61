"""Operation and byte counts of the benchmark's kernels and models."""
