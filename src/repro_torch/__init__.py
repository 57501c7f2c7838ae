"""SOAR on PyTorch and CUDA: the port of the ``repro`` package.

``core`` is the numpy host layer (trees, the packed forest, the serial
oracle), ``kernels`` the hand-written CUDA kernels with their plain torch
versions, ``engine`` the batched placement solve. Entry points run on CUDA
unless the caller passes ``EngineOptions(device="cpu")``.
"""
