"""Hand-written CUDA kernels of the port, each beside its plain torch version.

``minplus``: the fused level fold of the batched gather and the batched
min-plus convolution of the color traceback (``csrc/levelfold.cu``,
``csrc/minplus.cu``), built by ``_build``.
"""
