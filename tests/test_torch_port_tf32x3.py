"""The 3xTF32 scheme of the fused PointNet kernel, in plain torch on the CPU.

``vlsat_tpu_torch/csrc/tf32x3.cuh`` splits every fp32 operand into a TF32
high part and a TF32 residual and sums three TF32 products per fp32
product.  This file runs the same rounding and split through the encoder's
math at the model's widths (3 -> 64 -> 128 -> 768, P = 128) and holds it to
the kernel's gate against the JAX reference, rtol 1e-4 / atol 1e-5.  It
also records why the kernel pays for three products: one TF32 product per
fp32 product misses that gate.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsat_tpu.ops.pointnet import pointnet_encode as j_pointnet_encode

DIMS = (3, 64, 128, 768)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: add half a TF32 ulp to the bits and drop the low 13, as the
    kernel's split and the tensor core do together."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from three TF32 products: lo*hi + hi*lo + hi*hi.  A product of
    two TF32 values is exact in fp32, so fp32 matmuls of the parts stand in
    for the tensor core's products."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return round_tf32(a) @ round_tf32(b)


def encode(pts, weights, biases, mm):
    x = pts
    for w, b in zip(weights, biases):
        x = torch.relu(mm(x, w) + b)
    return x.amax(dim=-2)


def _inputs(seed: int, scale: float):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(6, 128, 3) * scale).astype(np.float32)
    ws = [(rng.randn(a, b) / np.sqrt(a)).astype(np.float32) for a, b in zip(DIMS, DIMS[1:])]
    bs = [(rng.randn(b) * 0.1).astype(np.float32) for b in DIMS[1:]]
    return pts, ws, bs


def _reference(pts, ws, bs) -> np.ndarray:
    return np.asarray(j_pointnet_encode(jnp.asarray(pts), [jnp.asarray(w) for w in ws],
                                        [jnp.asarray(b) for b in bs]))


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32) * 100)
    r = round_tf32(x)
    assert not (r.view(torch.int32) & 0x1fff).any()
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    # ties go away from zero: 1 + 2^-11 lies halfway between TF32 neighbours
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], dtype=torch.float32)
    assert torch.equal(round_tf32(tie), torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10)]))


def test_split_residual_is_small():
    x = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(np.float32))
    hi, lo = split(x)
    # what the split drops is the rounding of the residual: ~2^-22 of x
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("seed,scale", [(0, 0.5), (1, 0.5), (2, 2.0)])
def test_tf32x3_encoder_holds_the_kernel_gate(seed, scale):
    pts, ws, bs = _inputs(seed, scale)
    got = encode(torch.from_numpy(pts), [torch.from_numpy(w) for w in ws],
                 [torch.from_numpy(b) for b in bs], mm_tf32x3)
    np.testing.assert_allclose(got.numpy(), _reference(pts, ws, bs), rtol=1e-4, atol=1e-5)


def test_one_pass_tf32_misses_the_kernel_gate():
    pts, ws, bs = _inputs(0, 0.5)
    got = encode(torch.from_numpy(pts), [torch.from_numpy(w) for w in ws],
                 [torch.from_numpy(b) for b in bs], mm_tf32)
    assert not np.allclose(got.numpy(), _reference(pts, ws, bs), rtol=1e-4, atol=1e-5)
