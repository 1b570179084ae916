"""PyTorch/CUDA port of the ``repro`` SWAP package, for one NVIDIA H100.

Imports torch, numpy and the standard library only: never JAX, and nothing
of the ``repro`` package. Every TPU kernel on a ported path is a kernel
written by hand for Hopper (``sm_90a``) with a plain PyTorch version beside
it; the plain version runs only for tensors that lie on the CPU.
"""
