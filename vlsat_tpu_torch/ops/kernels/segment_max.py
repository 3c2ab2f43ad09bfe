"""Masked per-scene segment-max: CUDA kernel wrapper and its plain twin.

Counterpart of ``vlsat_tpu/ops/pallas/segment_max.py`` (``segment_max_pallas``,
Pallas call at :95).  The kernel is ``vlsat_tpu_torch/csrc/segment_max.cu``;
``segment_max_plain`` computes the same function with one
``scatter_reduce``.  ``segment_max`` is the PyTorch operator
``vlsat::segment_max``: the twin for a CPU tensor, the kernel for a CUDA
tensor (there is no fallback between them), output shapes for a fake
tensor (``torch.export`` traces through it without launching), and the
plain scatter's gradient at the same primal as its backward, as the
custom_vjp at vlsat_tpu/ops/graph.py:137-153 gives.
"""

from __future__ import annotations

import ctypes

import torch

from vlsat_tpu_torch.ops.kernels import build

# kernel launches by ``segment_max`` in this process
launches = 0


def segment_max_plain(edge_data: torch.Tensor, edge_index: torch.Tensor,
                      edge_mask: torch.Tensor, num_nodes: int,
                      target: int = 0) -> torch.Tensor:
    """(B, E, D), (B, E, 2), (B, E) -> (B, N, D).  Invalid edges go to a dump
    segment N; ``include_self=False`` into zeros leaves 0 at a node with no
    valid edge."""
    d = edge_data.shape[-1]
    seg = torch.where(edge_mask, edge_index[..., target].long(), num_nodes)
    out = edge_data.new_zeros(edge_data.shape[0], num_nodes + 1, d).scatter_reduce(
        1, seg[..., None].expand(-1, -1, d), edge_data, reduce="amax", include_self=False)
    return out[:, :num_nodes]


_SIGNATURES = {
    "segment_max_f32": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
                        ctypes.c_int),
    "segment_max_smem_bytes": ([ctypes.c_int], ctypes.c_size_t),
    "segment_max_cluster_size": ([ctypes.c_int] * 2, ctypes.c_int),
}


def _lib() -> ctypes.CDLL:
    return build.load("segment_max", _SIGNATURES)


def cluster_size(batch: int, dim: int) -> int:
    """Blocks that split each scene's edges in a launch at (B, D) on the
    current card."""
    return _lib().segment_max_cluster_size(batch, dim)


_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper


def segment_max_cuda(edge_data: torch.Tensor, edge_index: torch.Tensor,
                     edge_mask: torch.Tensor, num_nodes: int,
                     target: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel; raises on inputs it cannot take."""
    global launches
    if not (edge_data.is_cuda and edge_index.device == edge_data.device
            and edge_mask.device == edge_data.device):
        raise ValueError("segment_max_cuda needs all inputs on one CUDA device")
    if (edge_data.dtype != torch.float32 or edge_index.dtype != torch.int32
            or edge_mask.dtype != torch.bool):
        raise TypeError(
            f"segment_max_cuda takes f32 data, int32 edge_index, bool mask; got "
            f"{edge_data.dtype}, {edge_index.dtype}, {edge_mask.dtype}")
    if edge_data.dim() != 3:
        raise ValueError(f"edge_data must be (B, E, D), got {tuple(edge_data.shape)}")
    b, e, d = edge_data.shape
    if tuple(edge_index.shape) != (b, e, 2) or tuple(edge_mask.shape) != (b, e):
        raise ValueError(
            f"shapes disagree: data {tuple(edge_data.shape)}, edge_index "
            f"{tuple(edge_index.shape)}, edge_mask {tuple(edge_mask.shape)}")
    if target not in (0, 1):
        raise ValueError(f"target must be 0 or 1, got {target}")
    if not (edge_data.is_contiguous() and edge_index.is_contiguous()
            and edge_mask.is_contiguous()):
        raise ValueError("segment_max_cuda needs contiguous inputs")
    lib = _lib()
    if lib.segment_max_smem_bytes(num_nodes) > _SMEM_LIMIT:
        raise ValueError(f"num_nodes={num_nodes} does not fit in shared memory")
    out = torch.empty(b, num_nodes, d, dtype=torch.float32, device=edge_data.device)
    stream = torch.cuda.current_stream(edge_data.device).cuda_stream
    with torch.cuda.device(edge_data.device):
        err = lib.segment_max_f32(
            edge_data.data_ptr(), edge_index.data_ptr(), edge_mask.data_ptr(),
            out.data_ptr(), b, e, d, num_nodes, target, stream)
    build.check(err, "segment_max_f32")
    launches += 1
    return out


@torch.library.custom_op("vlsat::segment_max", mutates_args=(), device_types="cpu")
def segment_max(edge_data: torch.Tensor, edge_index: torch.Tensor, edge_mask: torch.Tensor,
                num_nodes: int, target: int = 0) -> torch.Tensor:
    """``vlsat::segment_max``: the plain twin for a CPU tensor (contiguous,
    as the kernel's and the fake's outputs are), the CUDA kernel for a CUDA
    tensor; differentiable."""
    return segment_max_plain(edge_data, edge_index, edge_mask, num_nodes, target).contiguous()


@segment_max.register_kernel("cuda")
def _(edge_data, edge_index, edge_mask, num_nodes, target=0):
    return segment_max_cuda(edge_data, edge_index, edge_mask, num_nodes, target)


@segment_max.register_fake
def _(edge_data, edge_index, edge_mask, num_nodes, target=0):
    return edge_data.new_empty(edge_data.shape[0], num_nodes, edge_data.shape[-1])


def _setup(ctx, inputs, output):
    edge_data, edge_index, edge_mask, ctx.num_nodes, ctx.target = inputs
    ctx.save_for_backward(edge_data, edge_index, edge_mask)


def _backward(ctx, grad):
    edge_data, edge_index, edge_mask = ctx.saved_tensors
    with torch.enable_grad():
        d = edge_data.detach().requires_grad_(True)
        out = segment_max_plain(d, edge_index, edge_mask, ctx.num_nodes, ctx.target)
        (g,) = torch.autograd.grad(out, d, grad)
    return g, None, None, None, None


segment_max.register_autograd(_backward, setup_context=_setup)
