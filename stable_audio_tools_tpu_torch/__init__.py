"""stable-audio-tools in PyTorch and CUDA for NVIDIA Hopper GPUs.

A port of the JAX package `stable_audio_tools_tpu` (the reference it is held
against), module for module: `ops/norms.py` here is the counterpart of
`stable_audio_tools_tpu/ops/norms.py`, and so on. Every TPU (Pallas) kernel
on the ported path has a hand-written Hopper counterpart under
`ops/kernels/` (CUDA C++ in `csrc/`, bound with ctypes), each with a plain
PyTorch version beside it that CPU tensors take.

This package imports torch, numpy, einops and the standard library, never
JAX or the JAX package.
"""

__version__ = "0.1.0"
