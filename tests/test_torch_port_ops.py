"""The port's ops against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both functions.  The JAX Pallas
kernels run in interpret mode, as tests/test_segment_max_pallas.py and
tests/test_pallas_pointnet.py run them.  Tolerances: segment-max is exact
(rtol 1e-6, atol 0: max picks one of its inputs); add/mean rtol 1e-5 (sums
in another order); PointNet rtol/atol 1e-5 (three fp32 matmuls summed in
another order); attention and descriptors rtol 1e-5 / atol 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlsat_tpu.ops.attention as JA
import vlsat_tpu_torch.ops.attention as TA
from vlsat_tpu.ops import masked_attention as j_masked_attention
from vlsat_tpu.ops.descriptor import edge_descriptor as j_edge_descriptor
from vlsat_tpu.ops.descriptor import gen_descriptor as j_gen_descriptor
from vlsat_tpu.ops.graph import scatter_edges_to_nodes as j_scatter
from vlsat_tpu.ops.pallas.pointnet_kernel import (
    pointnet_encode_fused as j_fused, pointnet_encode_fused_v2 as j_fused_v2)
from vlsat_tpu.ops.pallas.segment_max import segment_max_pallas
from vlsat_tpu.scene import full_edge_index
from vlsat_tpu_torch.ops import masked_attention
from vlsat_tpu_torch.ops.descriptor import edge_descriptor, gen_descriptor
from vlsat_tpu_torch.ops.graph import gather_edge_endpoints, scatter_edges_to_nodes
from vlsat_tpu_torch.ops.kernels.pointnet_kernel import (
    pointnet_encode_fused, pointnet_encode_fused_v2)
from vlsat_tpu_torch.ops.kernels.segment_max import segment_max, segment_max_plain

T = torch.from_numpy


def _edges(rng, B, N, D):
    """Scenes of random size in a bucket of N nodes: padded edges are
    invalid, and nodes past a scene's size receive nothing."""
    E = N * (N - 1)
    ei = np.zeros((B, E, 2), np.int32)
    em = np.zeros((B, E), bool)
    for b in range(B):
        e = full_edge_index(rng.randint(2, N + 1))
        ei[b, : len(e)] = e
        em[b, : len(e)] = True
    return rng.randn(B, E, D).astype(np.float32), ei, em


@pytest.mark.parametrize("shape", [(4, 16, 256), (2, 12, 130), (3, 8, 11)])
@pytest.mark.parametrize("target", [0, 1])
def test_segment_max_twin_matches_pallas_and_scatter(shape, target):
    B, N, D = shape
    data, ei, em = _edges(np.random.RandomState(sum(shape) + target), B, N, D)
    ref = np.asarray(j_scatter(jnp.asarray(data), jnp.asarray(ei), jnp.asarray(em), N,
                               "max", target=target))
    pallas = np.asarray(segment_max_pallas(jnp.asarray(data), jnp.asarray(ei),
                                           jnp.asarray(em), N, target=target,
                                           interpret=True))
    got = segment_max_plain(T(data), T(ei), T(em), N, target).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=0)
    via_kernel_route = scatter_edges_to_nodes(T(data), T(ei), T(em), N, "max",
                                              target=target, use_kernel=True).numpy()
    np.testing.assert_array_equal(via_kernel_route, got)


def test_segment_max_negative_and_empty():
    # node 0 receives only negative messages (kept); node 2 nothing (zero);
    # the masked edge must not contribute
    ei = np.array([[[0, 1], [0, 2], [2, 0]]], np.int32)
    em = np.array([[True, True, False]])
    data = np.array([[[-3.0, -1.0], [-2.0, -5.0], [99.0, 99.0]]], np.float32)
    want = np.asarray(segment_max_pallas(jnp.asarray(data), jnp.asarray(ei),
                                         jnp.asarray(em), 3, interpret=True))
    got = segment_max(T(data), T(ei), T(em), 3).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], [-2.0, -1.0])
    np.testing.assert_array_equal(got[0, 1:], 0.0)


@pytest.mark.parametrize("aggr", ["add", "mean"])
@pytest.mark.parametrize("target", [0, 1])
def test_scatter_add_mean_match_jax(aggr, target):
    data, ei, em = _edges(np.random.RandomState(7 + target), 3, 8, 24)
    ref = np.asarray(j_scatter(jnp.asarray(data), jnp.asarray(ei), jnp.asarray(em), 8,
                               aggr, target=target))
    got = scatter_edges_to_nodes(T(data), T(ei), T(em), 8, aggr, target=target).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_segment_max_kernel_route_gradient_matches_jax():
    """The kernel route's backward is the plain scatter's gradient; ties
    split the gradient evenly, as JAX's segment_max does."""
    data, ei, em = _edges(np.random.RandomState(3), 2, 6, 5)
    data[0, 1] = data[0, 0]  # a two-way tie on node 0
    g_out = np.random.RandomState(4).randn(2, 6, 5).astype(np.float32)

    def j_loss(d):
        return jnp.sum(j_scatter(d, jnp.asarray(ei), jnp.asarray(em), 6, "max")
                       * jnp.asarray(g_out))

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(data)))
    d = T(data.copy()).requires_grad_(True)
    out = scatter_edges_to_nodes(d, T(ei), T(em), 6, "max", use_kernel=True)
    (out * T(g_out)).sum().backward()
    np.testing.assert_allclose(d.grad.numpy(), want, rtol=1e-6, atol=1e-7)


def test_segment_max_cuda_refuses_cpu_tensors():
    from vlsat_tpu_torch.ops.kernels.segment_max import segment_max_cuda

    data, ei, em = _edges(np.random.RandomState(0), 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        segment_max_cuda(T(data), T(ei), T(em), 4)


def _pointnet_case(seed, M, P, C=3, widths=(16, 32, 64)):
    rng = np.random.RandomState(seed)
    dims = (C, *widths)
    pts = rng.randn(M, P, C).astype(np.float32)
    ws = [(rng.randn(a, b) / np.sqrt(a)).astype(np.float32) for a, b in zip(dims, dims[1:])]
    bs = [(rng.randn(b) * 0.1).astype(np.float32) for b in widths]
    return pts, ws, bs


def test_pointnet_twin_matches_fused_pallas():
    pts, ws, bs = _pointnet_case(0, M=10, P=32)  # M not a multiple of block_m
    want = np.asarray(j_fused(jnp.asarray(pts), [jnp.asarray(w) for w in ws],
                              [jnp.asarray(b) for b in bs], block_m=4, interpret=True))
    got = pointnet_encode_fused(T(pts), [T(w) for w in ws], [T(b) for b in bs]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pointnet_twin_matches_fused_v2_pallas():
    pts, ws, bs = _pointnet_case(1, M=12, P=32)
    want = np.asarray(j_fused_v2(jnp.asarray(pts), [jnp.asarray(w) for w in ws],
                                 [jnp.asarray(b) for b in bs], block_m=8, p_chunk=16,
                                 interpret=True))
    got = pointnet_encode_fused_v2(T(pts), [T(w) for w in ws], [T(b) for b in bs],
                                   p_chunk=16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="multiple of p_chunk"):
        pointnet_encode_fused_v2(T(pts), [T(w) for w in ws], [T(b) for b in bs],
                                 p_chunk=12)


def test_descriptors_match_jax():
    rng = np.random.RandomState(2)
    pts = (rng.randn(2, 5, 40, 3) * (0.2 + rng.rand(2, 5, 1, 3))).astype(np.float32)
    desc = np.array(j_gen_descriptor(jnp.asarray(pts)))
    np.testing.assert_allclose(gen_descriptor(T(pts)).numpy(), desc, rtol=1e-5, atol=1e-6)
    ei = np.stack([full_edge_index(5)] * 2).astype(np.int32)
    want = np.asarray(j_edge_descriptor(jnp.asarray(desc), jnp.asarray(ei)))
    got = edge_descriptor(T(desc), T(ei)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    x = rng.randn(2, 5, 7).astype(np.float32)
    xi, xj = gather_edge_endpoints(T(x), T(ei))
    np.testing.assert_array_equal(xi.numpy(), np.take_along_axis(x, ei[..., :1], axis=1))
    np.testing.assert_array_equal(xj.numpy(), np.take_along_axis(x, ei[..., 1:], axis=1))


def test_pairwise_distance_bias_matches_jax():
    centers = np.random.RandomState(5).randn(2, 6, 3).astype(np.float32)
    want = np.asarray(JA.pairwise_distance_bias(jnp.asarray(centers)))
    got = TA.pairwise_distance_bias(T(centers)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0, 0, 1, :3], centers[0, 1] - centers[0, 0], atol=1e-6)


def _attn_inputs(seed, B, N, H=2, D=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, N, H, D).astype(np.float32) for _ in range(3)], rng


def _both(monkeypatch, large: bool, q, k, v, bias_way="add", **kw):
    """Run the JAX and the port's attention on the same route."""
    gate = 1 if large else 1 << 62
    monkeypatch.setattr(JA, "LARGE_SCORE_ELEMENTS", gate)
    monkeypatch.setattr(TA, "LARGE_SCORE_ELEMENTS", gate)
    jkw = {k2: None if v2 is None else jnp.asarray(v2) for k2, v2 in kw.items()}
    tkw = {k2: None if v2 is None else T(v2) for k2, v2 in kw.items()}
    want = np.asarray(JA.masked_attention_bnhd(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), bias_way=bias_way, **jkw))
    got = TA.masked_attention_bnhd(T(q), T(k), T(v), bias_way=bias_way, **tkw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    return got


@pytest.mark.parametrize("large", [False, True], ids=["handwritten", "library"])
def test_masked_attention_matches_jax(monkeypatch, large):
    (q, k, v), rng = _attn_inputs(7, B=2, N=6)
    bias = rng.randn(2, 1, 6, 6).astype(np.float32)
    mask = np.ones((2, 1, 6, 6), bool)
    mask[0, 0, 2, :] = False  # fully masked query row
    mask[..., 5] = False      # padded key for every query
    for kw in (dict(mask=mask, bias=bias), dict(mask=mask), dict(bias=bias), dict()):
        got = _both(monkeypatch, large, q, k, v, **kw)
        if "mask" in kw:
            np.testing.assert_array_equal(got[0, 2], 0.0)


@pytest.mark.parametrize("large", [False, True], ids=["handwritten", "library"])
def test_masked_attention_mask_and_kmask_intersection(monkeypatch, large):
    (q, k, v), _ = _attn_inputs(13, B=2, N=5)
    mask = np.ones((2, 1, 5, 5), bool)
    mask[0, 0, 1, :2] = False  # row 1 attends keys 2..4 under mask ...
    km = np.ones((2, 5), bool)
    km[0, 2:] = False          # ... and k_mask removes keys 2..4
    got = _both(monkeypatch, large, q, k, v, mask=mask, k_mask=km)
    np.testing.assert_array_equal(got[0, 1], 0.0)


@pytest.mark.parametrize("large", [False, True], ids=["handwritten", "library"])
def test_masked_attention_factored_masks(monkeypatch, large):
    (q, k, v), _ = _attn_inputs(11, B=3, N=6)
    qm = np.ones((3, 6), bool)
    km = np.ones((3, 6), bool)
    qm[0, 4:], km[0, 3:] = False, False
    qm[2], km[2] = False, False  # a scene with nothing valid
    got = _both(monkeypatch, large, q, k, v, q_mask=qm, k_mask=km)
    np.testing.assert_array_equal(got[0, 4:], 0.0)
    np.testing.assert_array_equal(got[2], 0.0)


@pytest.mark.parametrize("bias_way", ["add", "mul"])
@pytest.mark.parametrize("large", [False, True], ids=["handwritten", "library"])
def test_head_second_masked_attention_matches_jax(monkeypatch, large, bias_way):
    """``ops.masked_attention`` on (B, H, Nq, Dk) against JAX's
    ``masked_attention`` (attention.py:80): scale, bias before the mask, and
    zeros for a row with no valid key, on either route of the port's core."""
    monkeypatch.setattr(TA, "LARGE_SCORE_ELEMENTS", 1 if large else 1 << 62)
    rng = np.random.RandomState(17)
    q, k, v = (rng.randn(2, 3, 6, 8).astype(np.float32) for _ in range(3))
    bias = (rng.rand(2, 3, 6, 6) + 0.5).astype(np.float32)
    mask = np.ones((2, 1, 6, 6), bool)
    mask[0, 0, 2, :] = False  # fully masked query row
    mask[..., 5] = False      # padded key for every query
    want = np.asarray(j_masked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         mask=jnp.asarray(mask), bias=jnp.asarray(bias),
                                         bias_way=bias_way))
    got = masked_attention(T(q), T(k), T(v), mask=T(mask), bias=T(bias),
                           bias_way=bias_way).numpy()
    assert got.shape == (2, 3, 6, 8) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[0, :, 2], 0.0)


def test_masked_attention_mul_bias_matches_jax(monkeypatch):
    (q, k, v), rng = _attn_inputs(8, B=1, N=4)
    bias = (rng.rand(1, 1, 4, 4) + 0.5).astype(np.float32)
    _both(monkeypatch, True, q, k, v, bias=bias, bias_way="mul")


@pytest.mark.parametrize("package", ["", ".ops", ".models", ".scene"],
                         ids=["root", "ops", "models", "scene"])
def test_package_roots_export_the_jax_names(package):
    """Every name that a JAX package root exports (its classes, functions and
    constants) imports from the port's twin under the same name."""
    import importlib
    import inspect

    jax_mod = importlib.import_module("vlsat_tpu" + package)
    port = importlib.import_module("vlsat_tpu_torch" + package)
    names = [n for n, v in vars(jax_mod).items()
             if not n.startswith("_") and not inspect.ismodule(v)
             and getattr(v, "__module__", "vlsat_tpu").startswith("vlsat_tpu")]
    assert names
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"vlsat_tpu_torch{package} lacks {missing}"
    for n in names:
        want, got = getattr(jax_mod, n), getattr(port, n)
        if isinstance(want, (int, float, str, tuple)):
            assert got == want, n
        else:
            assert got.__module__.startswith("vlsat_tpu_torch"), (n, got.__module__)
