"""Fused three-layer PointNet: CUDA kernel wrapper and its plain twin.

Counterpart of ``vlsat_tpu/ops/pallas/pointnet_kernel.py``:
``pointnet_encode_fused`` (Pallas call at :99) and
``pointnet_encode_fused_v2`` (Pallas call at :150).  Both run the one kernel
of ``vlsat_tpu_torch/csrc/pointnet.cu``; v2 is its point-chunked
configuration.  The plain twin is ``vlsat_tpu_torch.ops.pointnet``.
Both wrappers call the PyTorch operator ``vlsat::pointnet_encode``: a CPU
tensor takes the twin, a CUDA tensor the kernel (there is no fallback
between them), a fake tensor gets the output shape (``torch.export`` traces
through it without launching).  The operator is differentiable: its
backward is the twin's gradient at the same primal, as the JAX package's
interpret-mode call is differentiable.  Its FLOP formula is the twin's
matrix products, so that ``torch.utils.flop_counter`` counts both routes
alike.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
from torch.utils.flop_counter import register_flop_formula

from vlsat_tpu_torch.ops.kernels import build
from vlsat_tpu_torch.ops.pointnet import pointnet_encode

# kernel launches by ``pointnet_encode_fused`` and ``_v2`` in this process;
# ``launches_v2`` counts those of ``pointnet_encode_fused_v2`` alone
launches = 0
launches_v2 = 0

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_SIGNATURES = {
    "pointnet_f32": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
                     ctypes.c_int),
    "pointnet_smem_bytes": ([ctypes.c_int] * 6, ctypes.c_size_t),
}

pointnet_encode_plain = pointnet_encode


def _launch(pts: torch.Tensor, weights: Sequence[torch.Tensor],
            biases: Sequence[torch.Tensor], p_chunk: int) -> torch.Tensor:
    """weights are (in, out), as the twin takes them; the kernel reads them
    (out, in), nn.Linear's layout, so ``w.t()`` of a Linear weight costs no
    copy here."""
    global launches
    tensors = [pts, *weights, *biases]
    if not all(t.is_cuda and t.device == pts.device for t in tensors):
        raise ValueError("the fused PointNet kernel needs all inputs on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the fused PointNet kernel takes float32 inputs")
    if not (pts.is_contiguous() and all(b.is_contiguous() for b in biases)):
        raise ValueError("the fused PointNet kernel needs contiguous points and biases")
    if pts.dim() < 2:
        raise ValueError(f"pts must be (..., P, C), got {tuple(pts.shape)}")
    *lead, p, c = pts.shape
    (w1, w2, w3), (b1, b2, b3) = weights, biases
    h1, h2, o = w1.shape[1], w2.shape[1], w3.shape[1]
    if (tuple(w1.shape) != (c, h1) or tuple(w2.shape) != (h1, h2)
            or tuple(w3.shape) != (h2, o) or tuple(b1.shape) != (h1,)
            or tuple(b2.shape) != (h2,) or tuple(b3.shape) != (o,)):
        raise ValueError(
            f"weights {[tuple(w.shape) for w in weights]} and biases "
            f"{[tuple(b.shape) for b in biases]} do not chain from C={c}")
    if h1 % 8 or h2 % 8 or o % 8:
        raise ValueError(f"widths {h1}, {h2}, {o} must be multiples of 8 (the MMA tile)")
    if p < 1 or p_chunk < 1 or p % p_chunk:
        raise ValueError(f"P={p} must be a positive multiple of p_chunk={p_chunk}")
    lib = build.load("pointnet", _SIGNATURES)
    smem = lib.pointnet_smem_bytes(p, c, h1, h2, o, p_chunk)
    if smem == 0 or smem > _SMEM_LIMIT:
        raise ValueError(f"widths {c}->{h1}->{h2}->{o} do not fit in shared memory "
                         "(hidden widths above 128 are not taken)")
    w1t, w2t, w3t = (w.t().contiguous() for w in weights)
    if w2t.data_ptr() % 16 or w3t.data_ptr() % 16:
        raise ValueError("the fused PointNet kernel copies W2 and W3 in 16-byte "
                         "pieces: their (out, in) storage must be 16-byte aligned")
    m = 1
    for d in lead:
        m *= d
    out = torch.empty(m, o, dtype=torch.float32, device=pts.device)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    with torch.cuda.device(pts.device):
        err = lib.pointnet_f32(
            pts.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), w3t.data_ptr(), b3.data_ptr(), out.data_ptr(),
            m, p, c, h1, h2, o, p_chunk, stream)
    build.check(err, "pointnet_f32")
    launches += 1
    return out.reshape(*lead, o)


@torch.library.custom_op("vlsat::pointnet_encode", mutates_args=(), device_types="cpu")
def _pointnet_op(pts: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor,
                 b1: torch.Tensor, b2: torch.Tensor, b3: torch.Tensor,
                 p_chunk: int) -> torch.Tensor:
    """``p_chunk`` 0 is the unchunked kernel (one slab of all P points)."""
    return pointnet_encode_plain(pts, (w1, w2, w3), (b1, b2, b3))


@_pointnet_op.register_kernel("cuda")
def _(pts, w1, w2, w3, b1, b2, b3, p_chunk):
    global launches_v2
    out = _launch(pts, (w1, w2, w3), (b1, b2, b3), p_chunk or pts.shape[-2])
    launches_v2 += int(p_chunk > 0)
    return out


@_pointnet_op.register_fake
def _(pts, w1, w2, w3, b1, b2, b3, p_chunk):
    return pts.new_empty(*pts.shape[:-2], w3.shape[1])


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:7])


def _backward(ctx, grad):
    """The plain chain's gradient at the same primal, re-derived from the
    saved inputs for the inputs that need one."""
    need = [i for i, n in enumerate(ctx.needs_input_grad[:7]) if n]
    xs = [t.detach().requires_grad_(i in need) for i, t in enumerate(ctx.saved_tensors)]
    with torch.enable_grad():
        out = pointnet_encode_plain(xs[0], xs[1:4], xs[4:7])
        got = torch.autograd.grad(out, [xs[i] for i in need], grad)
    grads = [None] * 8
    for i, g in zip(need, got):
        grads[i] = g
    return tuple(grads)


_pointnet_op.register_autograd(_backward, setup_context=_setup)


@register_flop_formula(torch.ops.vlsat.pointnet_encode)
def _pointnet_flops(pts_shape, w1_shape, w2_shape, w3_shape, *_, **__) -> int:
    """The plain chain's matrix products, 2*M*P*(C*H1 + H1*H2 + H2*O), so
    that ``utils.profiling.compiled_flops`` counts either route alike."""
    *lead, p, c = pts_shape
    m = 1
    for d in lead:
        m *= d
    return 2 * m * p * (c * w1_shape[1] + w2_shape[0] * w2_shape[1] + w3_shape[0] * w3_shape[1])


def _fused(pts, weights, biases, p_chunk: int) -> torch.Tensor:
    if len(weights) != 3 or len(biases) != 3:
        raise ValueError("the fused PointNet kernel takes exactly three layers")
    return _pointnet_op(pts, *weights, *biases, p_chunk)


def pointnet_encode_fused(pts: torch.Tensor, weights: Sequence[torch.Tensor],
                          biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """pts (..., P, C) -> (..., out), weights (in, out).  The whole point
    set of an instance is one slab (the unchunked kernel)."""
    return _fused(pts, weights, biases, 0)


def pointnet_encode_fused_v2(pts: torch.Tensor, weights: Sequence[torch.Tensor],
                             biases: Sequence[torch.Tensor],
                             p_chunk: int = 16) -> torch.Tensor:
    """Point-chunked configuration: layers run on ``p_chunk``-point slabs
    folded into a running max.  Requires P % p_chunk == 0, as the Pallas
    v2 kernel does."""
    if p_chunk < 1 or pts.shape[-2] % p_chunk:
        raise ValueError(f"P={pts.shape[-2]} is not a multiple of p_chunk={p_chunk}")
    return _fused(pts, weights, biases, p_chunk)
