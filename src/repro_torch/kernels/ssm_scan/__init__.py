"""Selective-SSM scan: the Mamba heads' recurrence in prefill and decode
(CUDA kernel and its plain torch version)."""
