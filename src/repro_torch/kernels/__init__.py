"""Hand-written CUDA kernels of the port, each beside its plain torch version.

``minplus``: the fused level fold of the batched gather and the batched
min-plus convolution of the color traceback (``csrc/levelfold.cu``,
``csrc/minplus.cu``); ``segment_reduce``: the masked group sum of the
reduce executor (``csrc/segment_reduce.cu``); ``topk_compress``: the per-row
top-k by magnitude of gradient compression (``csrc/topk_compress.cu``);
``flash_attention``: the online-softmax attention of prefill and decode
(``csrc/flash_attention.cu``), with an optional sliding window;
``ssm_scan``: the selective-SSM recurrence of the Mamba heads
(``csrc/ssm_scan.cu``). All are built by ``_build``.
"""
