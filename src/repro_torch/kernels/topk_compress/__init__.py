"""Per-row top-k by magnitude: gradient compression's selection (CUDA
kernel and its plain torch version)."""
