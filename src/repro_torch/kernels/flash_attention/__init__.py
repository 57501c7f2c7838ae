"""Online-softmax (flash) attention: the serving path's attention, prefill
and decode (CUDA kernel and its plain torch version)."""
