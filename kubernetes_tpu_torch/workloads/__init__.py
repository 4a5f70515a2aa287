"""Accelerator workloads: the flagship LM and the vector-add payload."""
