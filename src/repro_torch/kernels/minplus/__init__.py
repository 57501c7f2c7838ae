"""Min-plus kernels: the fused level fold and the batched convolution."""
