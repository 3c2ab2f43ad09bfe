"""PyTorch/CUDA port of vlsat_tpu (3D-only MMGNet serving, dual-branch evaluation,
training).

Imports torch, numpy and the standard library only; nothing of JAX or of
the ``vlsat_tpu`` package.
"""
