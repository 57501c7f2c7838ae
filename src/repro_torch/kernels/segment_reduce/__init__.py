"""Masked group sum: the Reduce at an aggregating switch (CUDA kernel and
its plain torch version)."""
