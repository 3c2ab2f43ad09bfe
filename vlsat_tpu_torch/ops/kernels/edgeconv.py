"""Factored EdgeConv neighbour max: CUDA kernel wrapper and its plain twin.

Replaces no TPU kernel: the JAX package leaves the DGCNN's EdgeConv to XLA
over the dense (..., P, k, 2C) input.  The port's eval path with autograd
off (``models.sggpoint.DGCNN``) projects each point once
(``ops.dgcnn.project_pairs``: u = x W1^T and w = x W2^T, interleaved
channel by channel) and hands the projection, the kNN indices and the
stage's BatchNorm to ``edgeconv_max``, the PyTorch operator
``vlsat::edgeconv_max`` (registered below): the plain twin ``edgeconv_max_plain`` for a CPU
tensor, the kernel of ``vlsat_tpu_torch/csrc/edgeconv.cu`` for a CUDA
tensor (there is no fallback between them), output shapes for a fake
tensor (``torch.export`` traces through it without launching).  It has no
backward: training and every caller with autograd on take the dense path.
An index outside [0, P) raises in the twin and gives NaN at its point in
the kernel.
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from vlsat_tpu_torch.ops.dgcnn import neighbours
from vlsat_tpu_torch.ops.kernels import build

# kernel launches by ``edgeconv_max`` in this process
launches = 0

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_SIGNATURES = {
    "edgeconv_max_f32": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                         + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "edgeconv_smem_bytes": ([ctypes.c_int] * 2, ctypes.c_size_t),
}


def edgeconv_max_plain(uw: torch.Tensor, idx: torch.Tensor, mean: torch.Tensor,
                       var: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """uw (..., P, 2C) (u_c at column 2c, w_c at 2c + 1), idx (..., P, k),
    the BatchNorm's running statistics and affine (C,) -> (..., P, C): the
    max over the k neighbours j of LeakyReLU_0.2 of the eval BatchNorm
    (``MaskedBatchNorm``'s expression) of (u_j - u_i) + w_i, in any float
    dtype."""
    u, w = uw.unflatten(-1, (-1, 2)).unbind(-1)
    h = (neighbours(u, idx) - u[..., None, :]) + w[..., None, :]
    h = (h - mean) / torch.sqrt(var + eps) * weight + bias
    return F.leaky_relu(h, 0.2).amax(dim=-2)


def edgeconv_max_cuda(uw: torch.Tensor, idx: torch.Tensor, mean: torch.Tensor,
                      var: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """Launch the CUDA kernel; raises on inputs it cannot take."""
    global launches
    stats = (mean, var, weight, bias)
    if not all(t.is_cuda and t.device == uw.device for t in (uw, idx, *stats)):
        raise ValueError("edgeconv_max_cuda needs all inputs on one CUDA device")
    if uw.dtype != torch.float32 or idx.dtype != torch.int64 or any(
            t.dtype != torch.float32 for t in stats):
        raise TypeError(f"edgeconv_max_cuda takes float32 data and int64 indices, got "
                        f"{uw.dtype}, {idx.dtype}, {[t.dtype for t in stats]}")
    if uw.dim() < 2 or idx.shape[:-1] != uw.shape[:-1]:
        raise ValueError(f"uw must be (..., P, 2C) and idx (..., P, k), got "
                         f"{tuple(uw.shape)} and {tuple(idx.shape)}")
    *lead, p, c2 = uw.shape
    c, k = c2 // 2, idx.shape[-1]
    if c2 % 8 or any(tuple(t.shape) != (c,) for t in stats):
        raise ValueError(f"{c2} projected columns must be 2C with C a multiple of 4, and the "
                         f"statistics (C,), got {[tuple(t.shape) for t in stats]}")
    if k < 1:
        raise ValueError("edgeconv_max_cuda needs at least one neighbour")
    if not all(t.is_contiguous() for t in (uw, idx, *stats)):
        raise ValueError("edgeconv_max_cuda needs contiguous inputs")
    if uw.data_ptr() % 16:
        raise ValueError("edgeconv_max_cuda reads the projection in 16-byte pieces: "
                         "its storage must be 16-byte aligned")
    lib = build.load("edgeconv", _SIGNATURES)
    if lib.edgeconv_smem_bytes(p, k) > _SMEM_LIMIT:
        raise ValueError(f"P={p} points and k={k} neighbours do not fit in shared memory")
    m = 1
    for d in lead:
        m *= d
    out = torch.empty(*lead, p, c, dtype=torch.float32, device=uw.device)
    stream = torch.cuda.current_stream(uw.device).cuda_stream
    with torch.cuda.device(uw.device):
        err = lib.edgeconv_max_f32(
            uw.data_ptr(), idx.data_ptr(), mean.data_ptr(), var.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), m, p, k, c, eps, stream)
    build.check(err, "edgeconv_max_f32")
    launches += 1
    return out


def _plain_op(uw, idx, mean, var, weight, bias, eps):
    return edgeconv_max_plain(uw, idx, mean, var, weight, bias, eps).contiguous()


# Registered through ``torch.library.Library`` and not ``custom_op``: a
# custom_op's device kernels import ``torch._dynamo`` (and sympy) at their
# first call, seconds that a served model would add to its start-up (6.8 s
# for the first call on an H100 host with torch 2.11).
_LIB = torch.library.Library("vlsat", "FRAGMENT")
_LIB.define("edgeconv_max(Tensor uw, Tensor idx, Tensor mean, Tensor var, Tensor weight, "
            "Tensor bias, float eps) -> Tensor")
_LIB.impl("edgeconv_max", _plain_op, "CPU")
_LIB.impl("edgeconv_max", edgeconv_max_cuda, "CUDA")


@torch.library.register_fake("vlsat::edgeconv_max", lib=_LIB)
def _(uw, idx, mean, var, weight, bias, eps):
    return uw.new_empty(*uw.shape[:-1], uw.shape[-1] // 2)


# ``vlsat::edgeconv_max``: the plain twin for a CPU tensor (contiguous, as
# the kernel's and the fake's outputs are), the CUDA kernel for a CUDA
# tensor
edgeconv_max = torch.ops.vlsat.edgeconv_max.default
