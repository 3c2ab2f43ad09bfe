"""The port on the card: its CUDA kernels against their plain twins, and
every path that runs on the card (serving, evaluation, training, the data
feed, the runner, the model zoo, artifacts, data parallelism, the offline
path and the tools) against the CPU or against another path.

These tests need an NVIDIA card with nvcc; without one they skip.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: segment-max is bit-equal (max picks one of its inputs; NaN
where the twin has NaN); the EdgeConv kernel is bit-equal to its twin
given the same projection (each step of the same expression rounded on its
own), the factored DGCNN on the card within rtol 1e-4 / atol 1e-5 of the
CPU's (cuBLAS and the CPU round the projections differently); PointNet
rtol 1e-4 / atol 1e-5 (3xTF32 products on the tensor cores against cuBLAS
fp32), its gradients equal to the twin's (the backward is the twin's at
the same primal); the model rtol 1e-3 / atol 1e-4 (the parity gate); a
train step's loss rtol 1e-4 against the CPU and its gradients per leaf at
the gate of tests/test_parity_torch.py:568-575 (rtol 2e-3, atol 2e-3 *
max|g|).
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _edges(rng, B, N, D, dev):
    from vlsat_tpu_torch.scene import full_edge_index

    E = N * (N - 1)
    ei = np.zeros((B, E, 2), np.int32)
    em = np.zeros((B, E), bool)
    for b in range(B):
        e = full_edge_index(rng.randint(2, N + 1))
        ei[b, :len(e)] = e
        em[b, :len(e)] = True
    data = rng.randn(B, E, D).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (data, ei, em)]


@pytest.mark.parametrize("shape", [(4, 16, 256), (2, 12, 130), (3, 8, 11), (2, 64, 256)])
@pytest.mark.parametrize("target", [0, 1])
def test_segment_max_kernel_equals_twin(dev, shape, target):
    from vlsat_tpu_torch.ops.kernels import segment_max as K

    B, N, D = shape
    data, ei, em = _edges(np.random.RandomState(sum(shape)), B, N, D, dev)
    before = K.launches
    got = K.segment_max(data, ei, em, N, target)
    assert K.launches == before + 1
    assert torch.equal(got, K.segment_max_plain(data, ei, em, N, target))


def test_segment_max_kernel_negative_and_empty(dev):
    from vlsat_tpu_torch.ops.kernels.segment_max import segment_max

    ei = torch.tensor([[[0, 1], [0, 2], [2, 0]]], dtype=torch.int32, device=dev)
    em = torch.tensor([[True, True, False]], device=dev)
    data = torch.tensor([[[-3.0, -1.0], [-2.0, -5.0], [99.0, 99.0]]], device=dev)
    got = segment_max(data, ei, em, 3).cpu()
    assert torch.equal(got[0, 0], torch.tensor([-2.0, -1.0]))
    assert torch.equal(got[0, 1:], torch.zeros(2, 2))


def _cluster_case(case, rng, dev):
    """Inputs that the cluster split of a scene's edges can get wrong."""
    from vlsat_tpu_torch.scene import full_edge_index

    if case == "long_scene":  # E not a multiple of the slab, stray ids dropped
        B, N, E = 2, 64, 4001
        ei = rng.randint(0, N, size=(B, E, 2)).astype(np.int32)
        ei[0, :5, 0] = [-1, N, N + 7, -3, 2 * N]
        em = rng.rand(B, E) < 0.9
    else:
        B, N = 3, 8
        ei = np.zeros((B, N * (N - 1), 2), np.int32)
        em = np.zeros((B, N * (N - 1)), bool)
        for b in range(B):
            e = full_edge_index(N)
            ei[b] = e
            em[b] = True
        if case == "few_edges":  # fewer valid edges than blocks in the cluster
            em[0] = False
            em[0, [3, 17, 40]] = True
            em[2] = False
            em[2, 55] = True
        elif case == "dead_scene":
            em[1] = False
        elif case == "shuffled":
            for b in range(B):
                perm = rng.permutation(N * (N - 1))
                ei[b], em[b] = ei[b, perm], rng.rand(N * (N - 1)) < 0.7
    data = rng.randn(B, ei.shape[1], 40).astype(np.float32)
    if case == "nan_inf":
        data[0, 3, :] = np.nan      # edge (0, 4): node 0 takes NaN
        data[0, 9, :] = -np.inf     # edge (1, 3)
        data[0, 7:14, 5] = -np.inf  # every edge of node 1 in channel 5
    return [torch.from_numpy(a).to(dev) for a in (data, ei, em)] + [N]


@pytest.mark.parametrize("case", ["few_edges", "dead_scene", "nan_inf", "shuffled",
                                  "long_scene"])
@pytest.mark.parametrize("target", [0, 1])
def test_segment_max_kernel_cluster_split(dev, case, target):
    from vlsat_tpu_torch.ops.kernels import segment_max as K

    data, ei, em, N = _cluster_case(case, np.random.RandomState(len(case) + target), dev)
    before = K.launches
    got = K.segment_max(data, ei, em, N, target)
    assert K.launches == before + 1
    ids = ei[..., target]
    # the twin takes no out-of-range id; the kernel drops them, as masked edges
    want = K.segment_max_plain(data, ei, em & (ids >= 0) & (ids < N), N, target)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    if case == "few_edges":
        assert K.cluster_size(data.shape[0], data.shape[2]) > 3
    if case == "dead_scene":
        assert not got[1].any()
    if case == "nan_inf" and target == 0:
        assert got[0, 0].isnan().all() and got[0, 1, 5] == -np.inf


def test_segment_max_kernel_refuses_bad_inputs(dev):
    from vlsat_tpu_torch.ops.kernels.segment_max import segment_max_cuda

    data, ei, em = _edges(np.random.RandomState(0), 2, 4, 8, dev)
    with pytest.raises(TypeError):
        segment_max_cuda(data, ei.long(), em, 4)
    with pytest.raises(ValueError, match="contiguous"):
        segment_max_cuda(data.transpose(0, 1).contiguous().transpose(0, 1), ei, em, 4)


EPS = 1e-5  # MaskedBatchNorm's
EDGECONV_STAGES = [(3, 64), (64, 64), (64, 128), (128, 256)]  # the DGCNN's (C_in, C_out)


def _edgeconv_inputs(b, n, c_in, c_out, dev, seed=0, p=128, k=20):
    """A stage's projection (B, N, P, 2 C_out), kNN indices and BatchNorm
    (mean, var, scale with every other entry negative, shift) on the card,
    the second half of the scenes' second half of instances all-zero
    clouds, as padding is."""
    from vlsat_tpu_torch.ops import dgcnn

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, n, p, c_in, generator=g)
    if c_in > 3:
        x = torch.nn.functional.leaky_relu(x, 0.2)
    x[b // 2:, n // 2:] = 0.0
    weight = torch.randn(c_out, 2 * c_in, generator=g) / (2 * c_in) ** 0.5
    gamma = torch.randn(c_out, generator=g)
    gamma[::2] = -gamma[::2].abs()
    stats = [torch.randn(c_out, generator=g) * 0.2, torch.rand(c_out, generator=g) + 0.5,
             gamma, torch.randn(c_out, generator=g) * 0.1]
    x = x.to(dev)
    return (dgcnn.project_pairs(x, weight.to(dev)), dgcnn.knn_indices(x, k),
            [t.to(dev) for t in stats])


@pytest.mark.parametrize("bucket", [8, 64])
@pytest.mark.parametrize("c_in,c_out", EDGECONV_STAGES)
def test_edgeconv_kernel_equals_twin(dev, bucket, c_in, c_out):
    """The served shapes (32 scenes of a bucket, 128 points, k 20): the
    kernel's output equals the plain twin's on the card bit for bit, from
    the same projection (both round each step of the same expression)."""
    from vlsat_tpu_torch.ops.kernels import edgeconv as K

    uw, idx, stats = _edgeconv_inputs(32, bucket, c_in, c_out, dev, seed=c_out + bucket)
    before = K.launches
    got = K.edgeconv_max(uw, idx, *stats, EPS)
    assert K.launches == before + 1
    assert got.shape == (32, bucket, 128, c_out)
    assert torch.equal(got, K.edgeconv_max_plain(uw, idx, *stats, EPS))


def test_edgeconv_kernel_bits_do_not_depend_on_the_batch(dev):
    """An instance run alone (B = 1) gives the bits it gets inside a
    padded B = 32 batch, and two calls give the same bits: the replay
    property the serving check relies on (no atomics, a fixed order over
    the neighbours)."""
    from vlsat_tpu_torch.ops.kernels import edgeconv as K

    uw, idx, stats = _edgeconv_inputs(32, 12, 64, 128, dev, seed=3)
    batch = K.edgeconv_max(uw, idx, *stats, EPS)
    assert torch.equal(batch, K.edgeconv_max(uw, idx, *stats, EPS))
    for b, n in ((0, 0), (5, 11), (31, 2)):
        alone = K.edgeconv_max(uw[b:b + 1, n:n + 1].contiguous(),
                               idx[b:b + 1, n:n + 1].contiguous(), *stats, EPS)
        assert torch.equal(alone[0, 0], batch[b, n])


def test_edgeconv_kernel_odd_shapes_and_bad_indices(dev):
    """P not a multiple of the 16 points a block walks at once, a channel
    tile cut short (C = 68), k = P, an index out of range (NaN at its
    point) and a NaN in a projection (propagates, as amax does)."""
    from vlsat_tpu_torch.ops.kernels import edgeconv as K

    uw, idx, stats = _edgeconv_inputs(3, 2, 8, 68, dev, seed=4, p=37, k=37)
    assert torch.equal(K.edgeconv_max(uw, idx, *stats, EPS),
                       K.edgeconv_max_plain(uw, idx, *stats, EPS))
    uw[0, 0, 5, 2 * 7] = float("nan")  # u of channel 7, point 5 of instance (0, 0)
    idx[1, 1, 3, 4] = 37
    got = K.edgeconv_max(uw, idx, *stats, EPS)
    assert got[0, 0, :, 7].isnan().all()  # every point has point 5 among its k = P
    assert got[1, 1, 3].isnan().all() and not got[1, 1, :3].isnan().any()
    assert not got[0, 0, :, 8:].isnan().any() and not got[2].isnan().any()


def test_edgeconv_kernel_refuses_bad_inputs(dev):
    from vlsat_tpu_torch.ops.kernels.edgeconv import edgeconv_max_cuda

    uw, idx, stats = _edgeconv_inputs(2, 2, 3, 64, dev, p=16, k=4)
    with pytest.raises(TypeError):
        edgeconv_max_cuda(uw.double(), idx, *stats, EPS)
    with pytest.raises(TypeError):
        edgeconv_max_cuda(uw, idx.int(), *stats, EPS)
    with pytest.raises(ValueError, match="contiguous"):
        edgeconv_max_cuda(uw.transpose(0, 1).contiguous().transpose(0, 1), idx, *stats, EPS)
    with pytest.raises(ValueError, match="multiple of 4"):
        edgeconv_max_cuda(uw[..., :-4].contiguous(), idx, *[t[:-2] for t in stats], EPS)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 4096, 128, device=dev)
        edgeconv_max_cuda(big, torch.zeros(1, 4096, 20, dtype=torch.long, device=dev),
                          *stats, EPS)


def test_dgcnn_on_card_launches_the_kernel_once_a_stage(dev):
    """The DGCNN's eval forward with autograd off launches the EdgeConv
    kernel once a stage and equals the factored forward on the CPU; with
    autograd on, or in training, it launches none."""
    from vlsat_tpu_torch.models.sggpoint import DGCNN
    from vlsat_tpu_torch.ops.kernels import edgeconv as K

    torch.manual_seed(5)
    model = DGCNN(3, 64, 20).eval()
    pts = torch.randn(4, 6, 20, 3)
    mask = torch.ones(4, 6, dtype=torch.bool)
    mask[2:, 3:] = False
    pts[~mask] = 0.0
    with torch.inference_mode():
        want = model(pts, mask)
    model.to(dev)
    before = K.launches
    with torch.inference_mode():
        got = model(pts.to(dev), mask.to(dev))
    assert K.launches == before + 4
    # 20 points, k 20: every stage takes every point, so no set can differ
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    before = K.launches
    model(pts.to(dev), mask.to(dev))
    with torch.no_grad():
        model.train()(pts.to(dev), mask.to(dev))
    assert K.launches == before


@pytest.mark.parametrize("widths", [(16, 32, 64), (64, 128, 768)])
@pytest.mark.parametrize("p,p_chunk", [(32, None), (20, None), (128, None),
                                       (32, 16), (128, 16), (24, 8), (1, None), (24, None),
                                       (1, 1), (20, 10), (256, 32)])
def test_pointnet_kernel_matches_twin(dev, widths, p, p_chunk):
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel as K

    rng = np.random.RandomState(p + len(widths))
    dims = (3, *widths)
    pts = torch.from_numpy((rng.randn(2, 5, p, 3) * 0.5).astype(np.float32)).to(dev)
    ws = [torch.from_numpy((rng.randn(a, b) / np.sqrt(a)).astype(np.float32)).to(dev)
          for a, b in zip(dims, dims[1:])]
    bs = [torch.from_numpy((rng.randn(b) * 0.1).astype(np.float32)).to(dev) for b in widths]
    before = K.launches
    if p_chunk is None:
        got = K.pointnet_encode_fused(pts, ws, bs)
    else:
        got = K.pointnet_encode_fused_v2(pts, ws, bs, p_chunk=p_chunk)
    assert K.launches == before + 1
    assert got.shape == (2, 5, widths[-1])
    torch.testing.assert_close(got, K.pointnet_encode_plain(pts, ws, bs), rtol=1e-4, atol=1e-5)


def _pointnet_inputs(rng, m, p, widths, dev, scale=0.5):
    dims = (3, *widths)
    pts = torch.from_numpy((rng.randn(m, p, 3) * scale).astype(np.float32)).to(dev)
    # weights as nn.Linear holds them, (out, in), handed over as (in, out) views
    ws = [torch.from_numpy((rng.randn(b, a) / np.sqrt(a)).astype(np.float32)).to(dev).t()
          for a, b in zip(dims, dims[1:])]
    bs = [torch.from_numpy((rng.randn(b) * 0.1).astype(np.float32)).to(dev) for b in widths]
    return pts, ws, bs


@pytest.mark.parametrize("m", [1, 3, 37])
@pytest.mark.parametrize("p,p_chunk", [(128, None), (128, 16), (20, None), (24, 8), (1, None)])
def test_pointnet_kernel_instance_counts(dev, m, p, p_chunk):
    """M that does not fill the instances of the last block."""
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel as K

    pts, ws, bs = _pointnet_inputs(np.random.RandomState(m * p), m, p, (64, 128, 768), dev)
    if p_chunk is None:
        got = K.pointnet_encode_fused(pts, ws, bs)
    else:
        got = K.pointnet_encode_fused_v2(pts, ws, bs, p_chunk=p_chunk)
    assert got.shape == (m, 768)
    torch.testing.assert_close(got, K.pointnet_encode_plain(pts, ws, bs), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("widths", [(16, 32, 64), (64, 128, 768)])
def test_pointnet_kernel_large_inputs(dev, widths):
    """Points and biases scaled by 1e3: the relative gate holds at large
    magnitudes.  With the biases scaled as the points are, the encoder is
    positively homogeneous (out(s x; s b) = s out(x; b)), so the gate in the
    units of the unscaled problem is rtol 1e-4 / atol 1e-5 * s: an output
    near 0 comes from cancelling terms of size ~s, and no fp32 sum holds it
    to 1e-5 absolute."""
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel as K

    scale = 1e3
    pts, ws, bs = _pointnet_inputs(np.random.RandomState(5), 37, 128, widths, dev,
                                   scale=0.5 * scale)
    bs = [b * scale for b in bs]
    got = K.pointnet_encode_fused(pts, ws, bs)
    assert got.abs().max() > 1e2
    torch.testing.assert_close(got, K.pointnet_encode_plain(pts, ws, bs),
                               rtol=1e-4, atol=1e-5 * scale)


def test_pointnet_kernel_refuses_bad_widths(dev):
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel as K

    pts, ws, bs = _pointnet_inputs(np.random.RandomState(0), 2, 16, (16, 36, 64), dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        K.pointnet_encode_fused(pts, ws, bs)


def test_model_on_card_matches_cpu(dev):
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.ops.descriptor import gen_descriptor
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.serving import BatchedServer

    cfg = MMGNetConfig(num_obj_classes=20, num_rel_classes=7, point_feature_size=64,
                       dim_node=64, dim_edge=64, dim_atten=32, num_heads=4,
                       fused_pointnet=True)
    model = build_mmgnet(cfg, device=dev, seed=3)
    rng = np.random.RandomState(0)
    scenes = []
    for n in (3, 7, 12):
        pts = (rng.randn(n, 1, 3) * 2 + rng.randn(n, 32, 3)).astype(np.float32)
        scenes.append({"obj_points": pts - pts.mean(axis=1, keepdims=True),
                       "descriptor": gen_descriptor(torch.from_numpy(pts)).numpy()})
    sm, pn = segment_max.launches, pointnet_kernel.launches
    with BatchedServer(model, device=dev, max_batch=4, num_rel_classes=7) as gpu:
        got = [gpu.predict(s) for s in scenes]
    assert segment_max.launches > sm and pointnet_kernel.launches > pn
    with BatchedServer(model, device="cpu", max_batch=4, num_rel_classes=7) as cpu:
        want = [cpu.predict(s) for s in scenes]
    for g, w in zip(got, want):
        for key in ("obj_logits", "rel_cls"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-3, atol=1e-4, err_msg=key)


def test_rank_functions_on_card_equal_cpu(dev):
    """Ranks count strict f32 comparisons of the same products, so the card
    and the CPU agree bit for bit on the same inputs (triplets on shared
    probabilities), exact ties included."""
    from vlsat_tpu_torch.eval import metrics as M

    rng = np.random.RandomState(5)
    b, n, c, r = 3, 9, 160, 26
    e = n * (n - 1)
    logits = torch.from_numpy((np.round(rng.randn(b, n, c) * 4) / 2).astype(np.float32))
    gt = torch.from_numpy(rng.randint(0, c, (b, n)).astype(np.int32))
    rel = torch.from_numpy((np.round(rng.rand(b, e, r) * 8) / 8).astype(np.float32))
    ei = torch.from_numpy(np.stack([rng.randint(0, n, (b, e)), rng.randint(0, n, (b, e))],
                                   -1).astype(np.int32))
    gt_rels = torch.from_numpy((rng.rand(b, e, r) < 0.1).astype(np.float32))
    probs = torch.softmax(logits, -1)
    on = lambda *xs: [x.to(dev) for x in xs]
    assert torch.equal(M.object_ranks(*on(logits, gt)).cpu(), M.object_ranks(logits, gt))
    for g, w in zip(M.predicate_rank_parts(rel.to(dev)), M.predicate_rank_parts(rel)):
        assert torch.equal(g.cpu(), w)
    for method in ("topk", "sort"):
        got = M.triplet_rank_parts_from_probs(*on(probs, gt, rel, ei), chunk=32, method=method)
        want = M.triplet_rank_parts_from_probs(probs, gt, rel, ei, chunk=32, method=method)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), method
    cr, ng = want
    assert torch.equal(M.discounted_ranks_device(*on(cr, ng, gt_rels)).cpu(),
                       M.discounted_ranks_device(cr, ng, gt_rels))
    assert torch.equal(M.sorted_gt_preds_device(gt_rels.to(dev)).cpu(),
                       M.sorted_gt_preds_device(gt_rels))


def test_masked_attention_on_card_matches_cpu(dev):
    """``ops.masked_attention`` (the head-second core) at the model gate: 32
    scenes of 5-16 nodes padded to bucket 16, the node attention's heads and
    widths, a padding mask with one scene fully masked (zeros out), and a
    distance-like bias applied 'add' and 'mul'."""
    from vlsat_tpu_torch import ops

    g = torch.Generator().manual_seed(13)
    b, h, n, dk = 32, 8, 16, 64
    q, k, v = (torch.randn(b, h, n, dk, generator=g) for _ in range(3))
    valid = torch.arange(n)[None, :] < torch.randint(5, n + 1, (b, 1), generator=g)
    valid[0] = False
    mask = valid[:, None, :, None] & valid[:, None, None, :]
    bias = torch.rand(b, h, n, n, generator=g)
    for way in ("add", "mul"):
        want = ops.masked_attention(q, k, v, mask=mask, bias=bias, bias_way=way)
        got = ops.masked_attention(*(t.to(dev) for t in (q, k, v)), mask=mask.to(dev),
                                   bias=bias.to(dev), bias_way=way).cpu()
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4, msg=way)
        assert not got[0].any(), way


def _triplet_vocab(batches) -> set:
    """GT triplets of every other scene: both zero-shot and seen recall are
    defined."""
    vocab = set()
    for b in batches:
        for k in range(0, b.num_scenes, 2):
            em = b.edge_mask[k].numpy()
            ei, cls = b.edge_index[k].numpy()[em], b.gt_class[k].numpy()
            for e, p in zip(*np.nonzero(b.gt_rels[k].numpy()[em] > 0)):
                vocab.add(f"{cls[ei[e, 0]]} {cls[ei[e, 1]]} {p}")
    return vocab


@pytest.mark.parametrize("bucket,nodes", [(12, (5, 9, 12, 7)), (64, (40, 64, 33))])
def test_dual_evaluate_on_card_matches_cpu(dev, bucket, nodes):
    """The flagship's dual-branch eval step with the fused PointNet on the
    card: 4 segment-max launches and 1 PointNet a forward, every output
    at the model gate against the CPU's on valid rows, object and
    predicate ranks of the card's outputs equal to the CPU's rank functions
    on the same outputs; then ``evaluate()`` over two batches: 4 and 1
    launches a batch, every metric finite."""
    import torch_parallel_ranks as ranks  # tests/ is on the path: "tests" may name another package
    from vlsat_tpu_torch.data.synthetic import make_batch
    from vlsat_tpu_torch.eval import metrics as M
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.train.step import make_eval_step

    cfg = MMGNetConfig(num_obj_classes=20, num_rel_classes=7, point_feature_size=64,
                       dim_node=64, dim_edge=64, dim_atten=32, num_heads=4, clip_feat_dim=64,
                       fused_pointnet=True)
    model = build_mmgnet(cfg, device=dev, seed=6)
    batches = [make_batch(seed=s, node_counts=nodes, bucket=bucket, num_points=32, feat_dim=64,
                          num_obj_classes=20, num_rel_classes=7) for s in (6, 7)]
    state = model.state_dict()
    step = make_eval_step(model, device=dev)
    before = (segment_max.launches, pointnet_kernel.launches)
    card = step(state, batches[0])
    assert (segment_max.launches - before[0], pointnet_kernel.launches - before[1]) == (4, 1)
    want = make_eval_step(model, device="cpu")({k: v.cpu() for k, v in state.items()},
                                               batches[0])
    b = batches[0]
    masks = {"obj": b.obj_mask, "rel": b.edge_mask}
    for key in ("obj_logits_3d", "obj_logits_2d", "rel_cls_3d", "rel_cls_2d"):
        m = masks[key.split("_")[0]]
        torch.testing.assert_close(card[key].cpu()[m], want[key][m], rtol=1e-3, atol=1e-4,
                                   msg=key)
    gt = b.gt_class.to(dev)
    for tag in ("3d", "2d"):
        ol, rc = card[f"obj_logits_{tag}"], card[f"rel_cls_{tag}"]
        assert torch.equal(M.object_ranks(ol, gt).cpu(), M.object_ranks(ol.cpu(), b.gt_class))
        for g, w in zip(M.predicate_rank_parts(rc), M.predicate_rank_parts(rc.cpu())):
            assert torch.equal(g.cpu(), w), tag
    counted = ranks.counted(step)
    before = (segment_max.launches, pointnet_kernel.launches)
    metrics = evaluate(counted, state, batches, num_rel_classes=7, verbose=False,
                       scene_recall=True, train_triplet_vocab=_triplet_vocab(batches))
    assert counted.calls == len(batches)
    assert (segment_max.launches - before[0], pointnet_kernel.launches - before[1]) == \
        (4 * counted.calls, counted.calls)
    assert metrics and all(np.isfinite(v) for v in metrics.values()), metrics


def test_evaluate_on_card_equals_cpu(dev):
    """evaluate() of the same model outputs on the card (pinned buffers,
    one copy per batch, event fence) and on the CPU: the same metrics."""
    from vlsat_tpu_torch.data.synthetic import make_batch
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.train.step import make_eval_step

    cfg = MMGNetConfig(num_obj_classes=20, num_rel_classes=7, point_feature_size=64,
                       dim_node=64, dim_edge=64, dim_atten=32, num_heads=4, clip_feat_dim=64)
    model = build_mmgnet(cfg, device="cpu", seed=3)
    batches = [make_batch(seed=s, node_counts=nodes, num_points=16, feat_dim=64,
                          num_obj_classes=20, num_rel_classes=7)
               for s, nodes in enumerate([(5, 8, 3), (9, 4), (7, 7, 6, 2)])]
    cpu_step = make_eval_step(model, device="cpu")
    outs = [cpu_step(model.state_dict(), b) for b in batches]

    def replay(device):
        it = iter(outs)

        def step(state, batch):
            assert batch.gt_class.device.type == torch.device(device).type
            return {k: v.to(device) for k, v in next(it).items()}

        step.device = device
        return step

    kw = dict(num_rel_classes=7, verbose=False, scene_recall=True,
              train_triplet_vocab={"1 2 3", "4 5 6"})
    got = evaluate(replay(dev), {}, batches, **kw)
    want = evaluate(replay("cpu"), {}, batches, **kw)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert (np.isnan(w) and np.isnan(got[k])) or got[k] == w, k


@pytest.mark.parametrize("p_chunk", [None, 16])
def test_pointnet_kernel_gradients_equal_twin(dev, p_chunk):
    """The kernel route is differentiable: points, weights and biases get
    the twin's gradients (re-derived through the twin at the same primal)."""
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel as K

    rng = np.random.RandomState(9)
    pts, ws, bs = _pointnet_inputs(rng, 37, 128, (64, 128, 768), dev)
    r = torch.from_numpy(rng.randn(37, 768).astype(np.float32)).to(dev)
    grads = []
    for fn in (K.pointnet_encode_fused if p_chunk is None else
               lambda *a: K.pointnet_encode_fused_v2(*a, p_chunk=p_chunk),
               K.pointnet_encode_plain):
        xs = [t.detach().clone().requires_grad_() for t in (pts, *ws, *bs)]
        before = K.launches
        out = fn(xs[0], xs[1:4], xs[4:])
        assert out.grad_fn is not None
        (out * r).sum().backward()
        grads.append([x.grad for x in xs])
        if fn is K.pointnet_encode_plain:
            assert K.launches == before
        else:
            assert K.launches == before + 1
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _narrow_train_setup(dev, seed=3):
    from vlsat_tpu_torch.data.synthetic import make_batch
    from vlsat_tpu_torch.models.layers import Dropout
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet

    cfg = MMGNetConfig(num_obj_classes=20, num_rel_classes=7, point_feature_size=64,
                       dim_node=64, dim_edge=64, dim_atten=32, num_heads=4, clip_feat_dim=64,
                       fused_pointnet=True)
    batch = make_batch(seed=seed, node_counts=(9, 12, 5), num_points=32, feat_dim=64,
                       num_obj_classes=20, num_rel_classes=7)
    g = torch.Generator().manual_seed(seed)
    text = torch.nn.functional.normalize(torch.randn(*batch.edge_mask.shape, 512, generator=g),
                                         dim=-1)
    batch = batch.replace(rel_text_feat=text * batch.edge_mask[..., None])
    models = [build_mmgnet(cfg, device=d, seed=seed) for d in (dev, "cpu")]
    for m in models:
        for mod in m.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
    return models, batch


def _assert_grads_at_gate(got_model, want_model):
    """Per leaf, max|g| floored at 1e-6 of the largest gradient (a key
    bias's gradient is zero up to fp32 noise)."""
    floor = 1e-6 * max(q.grad.abs().max().item() for q in want_model.parameters()
                       if q.grad is not None)
    for (n, p), (_, q) in zip(got_model.named_parameters(), want_model.named_parameters()):
        if q.grad is None:
            assert p.grad is None, n
            continue
        g, w = p.grad.cpu(), q.grad.cpu()
        scale = max(w.abs().max().item(), floor)
        assert torch.isclose(g, w, rtol=2e-3, atol=2e-3 * scale).all(), \
            (n, (g - w).abs().max().item())


def test_eval_mode_gradients_through_fused_encoder(dev):
    """model.eval() with istrain=True (JAX's istrain=True, deterministic=True)
    on the card: the object encoder runs the fused kernel and gets the same
    gradients as the plain route."""
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel
    from vlsat_tpu_torch.train.losses import vlsat_total_loss

    (model, _), batch = _narrow_train_setup(dev)
    b = batch.to(dev)
    grads = {}
    for fused in (True, False):
        model.obj_encoder.fused = fused
        model.zero_grad(set_to_none=True)
        before = pointnet_kernel.launches
        vlsat_total_loss(model.eval()(b, istrain=True), b)[0].backward()
        assert pointnet_kernel.launches == before + int(fused)
        grads[fused] = {n: p.grad.clone() for n, p in model.obj_encoder.named_parameters()}
    for n, w in grads[False].items():
        assert w.abs().max() > 0, n
        scale = w.abs().max().item()
        assert torch.isclose(grads[True][n], w, rtol=2e-3, atol=2e-3 * scale).all(), n


def _as_dtype(batch, dtype):
    return batch.replace(**{f: getattr(batch, f).to(dtype) for f in
                            ("obj_points", "descriptor", "obj_2d_feats", "gt_rels",
                             "rel_text_feat", "rel_points") if getattr(batch, f) is not None})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["fp32", "fp64"])
def test_train_step_on_card_matches_cpu(dev, dtype):
    """One train step from identical weights, every dropout off, in fp32
    (the path's precision) and fp64: loss and every gradient leaf against
    the CPU; no kernel launches in training."""
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.train.optim import make_optimizer
    from vlsat_tpu_torch.train.state import create_train_state
    from vlsat_tpu_torch.train.step import make_train_step

    models, batch = _narrow_train_setup(dev)
    models = [m.to(dtype) for m in models]
    batch = _as_dtype(batch, dtype)
    spec = make_optimizer(lr=1e-4, max_iteration=100)
    losses = []
    counts = (segment_max.launches, pointnet_kernel.launches)
    for m, d in zip(models, (dev, "cpu")):
        state = create_train_state(m, spec)
        _, aux = make_train_step(m, spec, device=d)(state, batch, 0)
        losses.append(aux["loss"].item())
    assert (segment_max.launches, pointnet_kernel.launches) == counts
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    _assert_grads_at_gate(*models)


# ---------------------------------------------------------------- data feed

def _small_pack(tmp_path, num_scans=6, insts=(5, 5)):
    """A split of ``num_scans`` PLY scans packed by the port (one bucket
    when every scan has 5 instances)."""
    from vlsat_tpu_torch.data.dataset import SSGScenes
    from vlsat_tpu_torch.data.packed import PackedScenes, pack_scenes
    from vlsat_tpu_torch.data.synthetic import make_synthetic_split

    root, scans, _ = make_synthetic_split(str(tmp_path / "split"), num_scans=num_scans,
                                          insts_per_scan=insts, vertices_per_inst=80,
                                          rels_per_scan=(2, 6), seed=1, write_ply=True)
    pack_scenes(SSGScenes(root, scans, "validation_scans", num_points=32, feat_dim=64),
                str(tmp_path / "pack"), seed=1)
    return PackedScenes(str(tmp_path / "pack"))


def test_resident_gather_on_card_equals_host_rows(dev, tmp_path):
    from vlsat_tpu_torch.data.resident import ResidentEvalLoader, ResidentScenes, gather_rows

    packed = _small_pack(tmp_path, num_scans=12, insts=(4, 12))
    resident = ResidentScenes(packed, device=dev)
    for b in packed.buckets:
        full = resident.full_batch(b)
        assert full.obj_points.device.type == "cuda" and full.obj_points.dtype == torch.float32
        rows = np.random.RandomState(b).permutation(packed.count(b)).astype(np.int32)
        got = gather_rows(full, torch.from_numpy(rows).to(dev))
        want = packed.batch(b, rows)
        for f, w in vars(want).items():
            if w is not None:
                assert torch.equal(getattr(got, f).cpu(), w), (b, f)
    for host, card in ResidentEvalLoader(resident, 5):
        for f, w in vars(host).items():
            if w is not None:
                assert torch.equal(getattr(card, f).cpu(), w), f


def test_grouped_evaluate_on_card_equals_per_batch(dev, tmp_path, monkeypatch):
    """On the card, the grouped resident path (K batches, one copy per
    group, a partial tail group) and the per-batch resident and streaming
    paths give the same metrics, with 4 segment-max launches and 1 PointNet
    a batch or grouped row; batches of equal shapes (6 scenes, B=3)."""
    import torch_parallel_ranks as ranks
    from vlsat_tpu_torch.data.packed import PackedLoader
    from vlsat_tpu_torch.data.resident import (ResidentEvalLoader, ResidentGroupedEval,
                                               ResidentScenes)
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.train.step import make_eval_step

    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")
    packed = _small_pack(tmp_path)
    cfg = MMGNetConfig(point_feature_size=64, dim_node=64, dim_edge=64, dim_atten=32,
                       num_heads=4, clip_feat_dim=64, fused_pointnet=True)
    model = build_mmgnet(cfg, device=dev, seed=3)
    step = make_eval_step(model, device=dev)
    resident = ResidentScenes(packed, device=dev)
    kw = dict(verbose=False, scene_recall=True)
    want = evaluate(step, model.state_dict(), ResidentEvalLoader(resident, 3), **kw)
    for loader in (ResidentGroupedEval(resident, 3, group=2),
                   ResidentGroupedEval(resident, 3, group=3),
                   PackedLoader(packed, batch_size=3)):
        counted = ranks.counted(step)
        before = (segment_max.launches, pointnet_kernel.launches)
        got = evaluate(counted, model.state_dict(), loader, **kw)
        # 4 segment-max and 1 PointNet a batch or grouped row
        assert (segment_max.launches - before[0], pointnet_kernel.launches - before[1]) == \
            (4 * counted.calls, counted.calls) and counted.calls >= 2, type(loader)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert (np.isnan(w) and np.isnan(got[k])) or got[k] == w, (type(loader), k)


def test_grouped_tail_batch_on_card_equals_unpadded(dev, tmp_path):
    """A bucket's partial last batch evaluated alone and padded to the
    batch size the way the grouped loader pads it (the last scene
    repeated): every output within 1e-5 relative on the live rows."""
    from vlsat_tpu_torch.data.resident import ResidentScenes, gather_rows
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.train.step import make_eval_step

    packed = _small_pack(tmp_path, num_scans=7)
    cfg = MMGNetConfig(point_feature_size=64, dim_node=64, dim_edge=64, dim_atten=32,
                       num_heads=4, clip_feat_dim=64, fused_pointnet=True)
    model = build_mmgnet(cfg, device=dev, seed=3)
    step, state, batch = make_eval_step(model, device=dev), model.state_dict(), 4
    resident = ResidentScenes(packed, device=dev)
    for b in resident.buckets:
        c = resident.count(b)
        start = (c - 1) // batch * batch
        assert c - start < batch  # a partial tail
        full = resident.full_batch(b)
        alone = step(state, gather_rows(full, torch.arange(start, c, device=dev)))
        rows = torch.clamp(torch.arange(start, start + batch, device=dev), max=c - 1)
        padded = step(state, gather_rows(full, rows))
        for k, v in alone.items():
            rel = (padded[k][:c - start] - v).abs().max() / v.abs().max().clamp_min(1e-30)
            assert rel.item() <= 1e-5, (b, k, rel.item())


def test_resident_multi_train_step_on_card_equals_streaming(dev, tmp_path):
    """``make_resident_multi_train_step`` (rows gathered on the card) and
    ``make_multi_train_step`` (the same rows stacked on the host) from one
    set of weights, dropout off, K=2 steps of B=2: losses within 1e-6
    relative, all finite, no kernel launch."""
    from vlsat_tpu_torch.data.resident import ResidentScenes
    from vlsat_tpu_torch.models.layers import Dropout
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.train.optim import make_optimizer
    from vlsat_tpu_torch.train.state import create_train_state
    from vlsat_tpu_torch.train.step import (make_multi_train_step,
                                            make_resident_multi_train_step, stack_batches)

    packed = _small_pack(tmp_path)
    b = packed.buckets[0]
    perm = np.asarray([2, 0, 3, 1], np.int32)
    cfg = MMGNetConfig(point_feature_size=64, dim_node=64, dim_edge=64, dim_atten=32,
                       num_heads=4, clip_feat_dim=64, fused_pointnet=True)
    spec = make_optimizer(lr=1e-4, max_iteration=100)
    counts = (segment_max.launches, pointnet_kernel.launches)
    losses = []
    for resident in (True, False):
        model = build_mmgnet(cfg, device=dev, seed=7)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        state = create_train_state(model, spec)
        kw = dict(text_table=packed.text_table, device=dev)
        if resident:
            split = ResidentScenes(packed, device=dev).full_batch(b)
            step = make_resident_multi_train_step(model, spec, split, batch_size=2, **kw)
            _, aux = step(state, perm, 0)
        else:
            group = stack_batches([packed.batch(b, perm[:2]), packed.batch(b, perm[2:])])
            _, aux = make_multi_train_step(model, spec, **kw)(state, group, 0)
        losses.append(aux["losses"].cpu().double())
    assert (segment_max.launches, pointnet_kernel.launches) == counts
    assert torch.isfinite(losses[0]).all() and losses[0].numel() == 2
    rel = ((losses[0] - losses[1]).abs() / losses[1].abs()).max().item()
    assert rel <= 1e-6, (losses, rel)


def test_server_pinned_path_equals_pageable_path(dev):
    """BatchedServer's pinned, non-blocking copy gives the outputs of the
    pageable copy it replaced, bit for bit, and the CPU's at the gate."""
    from vlsat_tpu_torch.data.synthetic import make_scene
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.serving import BatchedServer

    cfg = MMGNetConfig(num_obj_classes=20, num_rel_classes=7, point_feature_size=64,
                       dim_node=64, dim_edge=64, dim_atten=32, num_heads=4, clip_feat_dim=64,
                       fused_pointnet=True)
    model = build_mmgnet(cfg, device=dev, seed=4)
    rng = np.random.RandomState(0)
    scenes = [{k: v for k, v in make_scene(rng, n, num_points=16, num_rel_classes=7).items()
               if k in ("obj_points", "descriptor")} for n in (3, 7, 5, 11)]
    runs = []
    for pinned in (True, False):
        server = BatchedServer(model, device=dev, max_batch=4, deadline_ms=50.0,
                               num_rel_classes=7)
        assert server._pin
        server._pin = pinned
        with server:
            runs.append([f.result(timeout=120) for f in [server.submit(s) for s in scenes]])
    with BatchedServer(model.cpu(), device="cpu", max_batch=4, deadline_ms=50.0,
                       num_rel_classes=7) as server:
        ref = [f.result(timeout=120) for f in [server.submit(s) for s in scenes]]
    for got, want, cpu in zip(*runs, ref):
        for key in ("obj_logits", "rel_cls"):
            np.testing.assert_array_equal(got[key], want[key])
            np.testing.assert_allclose(got[key], cpu[key], rtol=1e-3, atol=1e-4)


def test_server_reused_pinned_buffers_equal_a_fresh_server(dev):
    """Batches served back to back through the pinned buffers of two
    buckets, one of them right after a step that raised once its copies
    were enqueued, give bit for bit the answers of a fresh server."""
    from vlsat_tpu_torch.data.synthetic import make_scene
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.serving import BatchedServer
    from vlsat_tpu_torch.train.step import make_eval_step

    cfg = MMGNetConfig(num_obj_classes=20, num_rel_classes=7, point_feature_size=64,
                       dim_node=64, dim_edge=64, dim_atten=32, num_heads=4, clip_feat_dim=64,
                       fused_pointnet=True)
    model = build_mmgnet(cfg, device=dev, seed=5)
    inner = make_eval_step(model, branch_3d_only=True, device=dev)
    weights = model.state_dict()
    fail = []

    def step(_state, batch):  # raises after the real step enqueued its copies
        out = inner(weights, batch)
        if fail:
            raise RuntimeError(fail.pop())
        return out

    step.device = inner.device
    rng = np.random.RandomState(1)
    batches = [[{k: v for k, v in make_scene(rng, n, num_points=16, num_rel_classes=7).items()
                 if k in ("obj_points", "descriptor")} for n in sizes]
               for sizes in ((24, 22, 19), (5, 8, 3, 6), (17, 20), (18,), (4, 7))]
    kw = dict(max_batch=4, deadline_ms=200.0, num_rel_classes=7, feat_dim=64)
    server = BatchedServer(eval_step=step, **kw)
    assert server._pin
    got = []
    with server:
        for k, scenes in enumerate(batches):
            if k == 2:
                fail.append("after the copies")
            futs = [server.submit(s) for s in scenes]
            if k == 2:
                for f in futs:
                    with pytest.raises(RuntimeError, match="after the copies"):
                        f.result(timeout=120)
                continue
            got.append([f.result(timeout=120) for f in futs])
    assert server.stats["failed"] == 1 and server.stats["batches"] == 4
    assert server.stats["wire_buffers"] == 2 and server.stats["prepared_in_place"] == 3
    for scenes, answers in zip(batches[:2] + batches[3:], got):
        with BatchedServer(model, device=dev, **kw) as fresh:
            want = [f.result(timeout=120) for f in [fresh.submit(s) for s in scenes]]
        for g, w in zip(answers, want):
            for key in ("obj_logits", "rel_cls", "edge_index"):
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_packed_eval_step_on_card_equals_dense(dev):
    """On the card the 3D-only step packs a host batch's edge rows (the
    valid edges and one row a scene with padding) and runs a batch already
    on the card, as a resident loader's, dense; both give the same outputs
    at fp32 tolerance, with the two segment-max launches of a forward."""
    from vlsat_tpu_torch.data.synthetic import make_batch
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.ops.kernels import segment_max
    from vlsat_tpu_torch.train.step import make_eval_step, take_edge_rows

    cfg = MMGNetConfig(num_obj_classes=20, num_rel_classes=7, point_feature_size=64,
                       dim_node=64, dim_edge=64, dim_atten=32, num_heads=4, clip_feat_dim=64,
                       fused_pointnet=True)
    model = build_mmgnet(cfg, device=dev, seed=5)
    batch = make_batch(seed=5, node_counts=(40, 7, 64, 23), bucket=64, num_points=32,
                       feat_dim=64, num_obj_classes=20, num_rel_classes=7)
    step = make_eval_step(model, branch_3d_only=True, device=dev)
    outs, rows = [], []
    for b in (batch, batch.to(dev)):
        before = segment_max.launches
        outs.append(step(model.state_dict(), b))
        rows.append(take_edge_rows())
        assert segment_max.launches == before + 2
    slots = batch.edge_mask.numel()
    assert rows == [(int(batch.edge_mask.sum()) + 3, slots), (slots, slots)]
    for key in outs[1]:
        torch.testing.assert_close(outs[0][key], outs[1][key], rtol=1e-5, atol=1e-5,
                                   equal_nan=True, msg=key)


# ------------------------------------------------------------------ runner

def test_runner_epoch_and_validation_on_card(dev, tmp_path):
    """``train.runner.Runner`` on the card: one epoch over a packed split
    (the resident multi-step) and its validation (the grouped resident
    loader); the validation launches segment-max on the card (4 launches a
    batch, dual branch) and training launches none, and the epoch row
    carries the card's memory."""
    import json

    from vlsat_tpu_torch.config import load_config
    from vlsat_tpu_torch.data.synthetic import make_synthetic_split
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.tools.pack_dataset import main as pack_main
    from vlsat_tpu_torch.train.runner import Runner

    root, scans, _ = make_synthetic_split(str(tmp_path / "split"), num_scans=10,
                                          insts_per_scan=(4, 10), vertices_per_inst=60,
                                          rels_per_scan=(2, 6), seed=2, write_ply=True)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({
        "PATH": str(tmp_path / "out"), "MAX_EPOCHES": 1, "Batch_Size": 2, "VALID_INTERVAL": 1,
        "TRAIN_MICROSTEPS": 2, "EVAL_BATCH_SIZE": 3,
        "MODEL": {"N_LAYERS": 1, "DIM_ATTEN": 64, "NUM_HEADS": 2},
        "dataset": {"root": root, "scans_root": scans, "num_points": 32,
                    "packed_root": str(tmp_path / "pack")}}))
    pack_main(["--config", str(cfg_path)])
    runner = Runner(load_config(str(cfg_path), {"MODE": "train"}))
    try:
        assert runner.device.type == "cuda"
        runner.load(allow_fallback=True)
        segment_max.launches = pointnet_kernel.launches = 0
        runner.train()
        assert runner.state.step > 0
        assert segment_max.launches > 0 and segment_max.launches % 4 == 0
        assert pointnet_kernel.launches == 0
    finally:
        runner.close()
    with open(tmp_path / "out" / "Mmgnet" / "default" / "epoch_stats.jsonl") as f:
        row = json.loads(f.readline())
    assert row["hbm_peak_mb"] > 0 and np.isfinite(row["mean_recall_50"])


# segment-max launches of one eval forward: one per GraphEdgeAttenNetwork
# layer (depth 2), both towers of the teacher/student and both branches of
# in21k; SGPN has no graph network, and the SGGpoint family aggregates by
# mean and add (EdgeGCN), never by max
VARIANTS = [("MmgnetSingle", 2), ("SGFN", 2), ("SGPN", 0), ("MMteacher", 4), ("MmgnetIn21k", 4),
            ("SGGpoint", 0), ("SGGpointBaseline", 0)]


def _variant(name, seed, num_points=16, with_text=False):
    """A registry model at the default MODEL widths (2 layers, attention 32
    wide, 4 heads), seeded, on the CPU, its loss, and a 3-scene batch of
    its inputs (768-d 2D features for in21k, 32-point union clouds for
    SGPN, 512-d text targets with ``with_text``)."""
    from vlsat_tpu_torch.config import load_config
    from vlsat_tpu_torch.data.synthetic import make_batch
    from vlsat_tpu_torch.models.mmgnet import init_parameters
    from vlsat_tpu_torch.models.registry import build_model

    mcfg = load_config(overrides={"MODEL": {"N_LAYERS": 2, "DIM_ATTEN": 32,
                                            "NUM_HEADS": 4}}).MODEL
    model, loss = build_model(name, 20, 7, mcfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    batch = make_batch(seed=1, node_counts=(4, 6, 9), num_points=num_points,
                       feat_dim=768 if name == "MmgnetIn21k" else 512,
                       num_obj_classes=20, num_rel_classes=7)
    rng = np.random.RandomState(2)
    if name == "SGPN":
        pts = rng.randn(*batch.edge_mask.shape, 32, 4).astype(np.float32)
        batch = batch.replace(rel_points=torch.from_numpy(pts) * batch.edge_mask[..., None, None])
    if with_text:
        text = rng.randn(*batch.edge_mask.shape, 512).astype(np.float32)
        text /= np.linalg.norm(text, axis=-1, keepdims=True)
        batch = batch.replace(rel_text_feat=torch.from_numpy(text) * batch.edge_mask[..., None])
    return model, loss, batch


@pytest.mark.parametrize("name,per_forward", VARIANTS)
def test_variant_eval_forward_on_card_matches_cpu(dev, name, per_forward):
    """A registry variant's eval forward on the card launches segment-max
    once per graph layer and branch (none for SGPN and the SGGpoint family),
    the EdgeConv kernel once a DGCNN stage (the SGGpoint family) and no
    PointNet, and equals the CPU's forward of the same weights at the model
    gate (16 points an instance: the SGGpoint kNN takes every point, so no
    neighbour set can differ)."""
    from vlsat_tpu_torch.ops.kernels import edgeconv, pointnet_kernel, segment_max
    from vlsat_tpu_torch.train.step import make_eval_step

    model, _, batch = _variant(name, 4)
    want = make_eval_step(model, device="cpu")(model.state_dict(), batch)
    model.to(dev)
    before = (segment_max.launches, edgeconv.launches, pointnet_kernel.launches)
    got = make_eval_step(model, device=dev)(model.state_dict(), batch)
    after = (segment_max.launches, edgeconv.launches, pointnet_kernel.launches)
    assert [a - b for a, b in zip(after, before)] == \
        [per_forward, 4 if name.startswith("SGGpoint") else 0, 0]
    masks = {"obj": batch.obj_mask, "rel": batch.edge_mask}
    for key, w in want.items():
        m = masks[key.split("_")[0]]
        torch.testing.assert_close(got[key].cpu()[m], w[m], rtol=1e-3, atol=1e-4, msg=key)


@contextlib.contextmanager
def _knn_sets():
    """Records the neighbour indices of every kNN that ``ops.dgcnn``
    computes in the block, each (B, N, P, k) sorted along k, on the CPU."""
    from vlsat_tpu_torch.ops import dgcnn

    real, calls = dgcnn.knn_indices, []

    def record(x, k):
        idx = real(x, k)
        calls.append(idx.sort(dim=-1).values.cpu())
        return idx

    dgcnn.knn_indices = record
    try:
        yield calls
    finally:
        dgcnn.knn_indices = real


@pytest.mark.parametrize("name", ["Mmgnet"] + [n for n, _ in VARIANTS])
def test_variant_train_step_on_card_matches_cpu(dev, name):
    """A registry model's train step with its own loss and text targets:
    one fp64 step on the card and on the CPU from identical weights, every
    dropout off (loss rtol 1e-4, every gradient leaf at the gate, every kNN
    neighbour set of a valid instance equal, 32 points an instance); no
    kernel launch in training (the DGCNN trains its dense stages); and on
    the card, 8 fp32 steps on one repeated batch lower the loss."""
    from vlsat_tpu_torch.models.layers import Dropout
    from vlsat_tpu_torch.ops.kernels import edgeconv, pointnet_kernel, segment_max
    from vlsat_tpu_torch.train.optim import make_optimizer
    from vlsat_tpu_torch.train.state import create_train_state
    from vlsat_tpu_torch.train.step import make_train_step

    spec = make_optimizer(lr=1e-4, max_iteration=1000)
    counts = lambda: (segment_max.launches, edgeconv.launches, pointnet_kernel.launches)
    before = counts()
    pair, losses, sets = [], [], []
    for d in (dev, "cpu"):
        model, loss, batch = _variant(name, 12, num_points=32, with_text=True)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        model = model.to(d).double()
        with _knn_sets() as calls:
            _, aux = make_train_step(model, spec, objective=loss, device=d)(
                create_train_state(model, spec), _as_dtype(batch, torch.float64), 0)
        pair.append(model)
        losses.append(aux["loss"].item())
        sets.append(calls)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    _assert_grads_at_gate(*pair)
    assert len(sets[0]) == len(sets[1]) == (4 if name.startswith("SGGpoint") else 0)
    valid = batch.obj_mask  # a padded instance's all-zero cloud ties every distance
    for g, w in zip(*sets):
        assert torch.equal(g[valid], w[valid])

    model, loss, batch = _variant(name, 11, num_points=32, with_text=True)
    model.to(dev)
    state, step = create_train_state(model, spec), make_train_step(model, spec, objective=loss,
                                                                   device=dev)
    fixed = torch.stack([step(state, batch, 0)[1]["loss"] for _ in range(8)]).cpu()
    assert torch.isfinite(fixed).all() and fixed[-1] < fixed[0], fixed.tolist()
    assert counts() == before


def _flagship_artifact(tmp_path, dev):
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.serving_export import export_serving_artifact

    cfg = MMGNetConfig(num_obj_classes=20, num_rel_classes=7, fused_pointnet=True)
    model = build_mmgnet(cfg, device=dev, seed=3)
    export_serving_artifact(model, str(tmp_path), buckets=(8,), max_batch=4, num_points=32,
                            device=dev)
    return model


def test_serving_artifact_on_card_equals_live_step(dev, tmp_path):
    """The flagship (fused PointNet) exported on the card: the artifact's
    outputs equal the live 3D-only step's at 1e-6 on a batch already on
    the card, which the live step runs dense as the artifact does (a host
    batch it packs into edge rows: test_packed_eval_step_on_card_equals_dense
    holds that against dense), with the same kernel launches (one PointNet
    and two segment-max a forward), and exporting launches nothing."""
    from vlsat_tpu_torch.data.synthetic import make_batch
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.serving_export import load_serving_artifact
    from vlsat_tpu_torch.train.step import make_eval_step, take_edge_rows

    before = (segment_max.launches, pointnet_kernel.launches)
    model = _flagship_artifact(tmp_path, dev)
    assert (segment_max.launches, pointnet_kernel.launches) == before
    batch = make_batch(seed=2, node_counts=(3, 8, 5, 2), bucket=8, num_points=32,
                       num_obj_classes=20, num_rel_classes=7).to(dev)
    live = make_eval_step(model, branch_3d_only=True, device=dev)
    counts = []
    outs = []
    for step in (live, load_serving_artifact(str(tmp_path), device=dev)):
        before = (segment_max.launches, pointnet_kernel.launches)
        outs.append(step(model.state_dict(), batch))
        counts.append((segment_max.launches - before[0], pointnet_kernel.launches - before[1]))
        if step is live:  # dense: every edge slot computed
            assert take_edge_rows() == (batch.edge_mask.numel(),) * 2
    assert counts[0] == counts[1] == (2, 1)
    for key in ("obj_logits_3d", "rel_cls_3d"):
        torch.testing.assert_close(outs[1][key], outs[0][key], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="exported for"):
        load_serving_artifact(str(tmp_path), device="cpu")


# one fused eval forward under utils.profiling.trace, in a fresh process:
# late in a long process torch.profiler loses the first kernel records of a
# session, so the count is held where it keeps them all
_PROFILED_FORWARD = """
import json, sys
import torch
from vlsat_tpu_torch.data.synthetic import make_batch
from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
from vlsat_tpu_torch.train.step import make_eval_step
from vlsat_tpu_torch.utils import profiling
model = build_mmgnet(MMGNetConfig(num_obj_classes=20, num_rel_classes=7, fused_pointnet=True),
                     device="cuda", seed=1)
batch = make_batch(seed=1, node_counts=(4, 6), num_points=32, num_obj_classes=20,
                   num_rel_classes=7)
step = make_eval_step(model, device="cuda")
step(model.state_dict(), batch)
before = (segment_max.launches, pointnet_kernel.launches)
with profiling.trace(sys.argv[1]) as path:
    step(model.state_dict(), batch)
    torch.cuda.synchronize()
print(json.dumps({"path": path, "counted": [segment_max.launches - before[0],
                                            pointnet_kernel.launches - before[1]]}))
"""


def test_profiling_trace_holds_both_kernels(dev, tmp_path):
    """One fused eval forward under ``utils.profiling.trace``: the Chrome
    trace holds one event of each kernel a counted launch."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from vlsat_tpu_torch.utils import profiling

    root = str(Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", _PROFILED_FORWARD, str(tmp_path)],
                          capture_output=True, text=True, timeout=600, cwd=root,
                          env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(got["path"]) as f:
        names = [str(e.get("name")) for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    events = [sum(k in n for n in names) for k in ("segment_max_kernel", "pointnet_kernel")]
    assert events == got["counted"] and min(events) > 0, (events, got["counted"])
    assert profiling.peak_flops_per_sec(dev) > 0


def test_operators_on_card_keep_their_gradients(dev):
    """Autograd through ``vlsat::segment_max`` on the card equals the plain
    scatter's on the same primal."""
    from vlsat_tpu_torch.ops.kernels import segment_max as K

    data, ei, em = _edges(np.random.RandomState(5), 3, 12, 64, dev)
    g_out = torch.randn(3, 12, 64, device=dev)
    grads = []
    for fn in (K.segment_max, K.segment_max_plain):
        d = data.clone().requires_grad_()
        (g,) = torch.autograd.grad(fn(d, ei, em, 12, 0), d, g_out)
        grads.append(g)
    assert torch.equal(grads[0], grads[1])


def _dp_train_specs():
    """The flagship at narrow widths with dropout on: two SGD steps and
    three AdamW steps on 8-scene batches."""
    import functools

    from vlsat_tpu_torch.data.synthetic import make_batch
    from vlsat_tpu_torch.models.mmgnet import MMGNet, MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.train.losses import vlsat_total_loss

    cfg = MMGNetConfig(num_obj_classes=20, num_rel_classes=7, point_feature_size=64,
                       dim_node=64, dim_edge=64, dim_atten=32, num_heads=4, clip_feat_dim=64)
    batches = [make_batch(seed=s, node_counts=(5, 8, 3, 6, 4, 7, 2, 8), num_points=16,
                          bucket=8, feat_dim=64, num_obj_classes=20, num_rel_classes=7)
               for s in (1, 2, 3)]
    initial = build_mmgnet(cfg, device="cpu", seed=3).state_dict()
    spec = dict(model_cls=MMGNet, cfg=cfg, state=initial, dropout=True,
                loss=functools.partial(vlsat_total_loss))
    return {"case": dict(spec, opt="sgd", lr=1e-2, batches=batches[:2]),
            "adamw": dict(spec, opt="adamw", lr=1e-4, batches=batches)}


def _assert_dp_train_equals_one_process(got: dict, specs: dict, dev):
    """Losses rtol 1e-5 against the same steps without a group; after SGD
    every weight within max(5e-5, 1e-2 x its update)
    (tests/test_production_shape_sharding.py:76-77); the ranks agree."""
    import torch_parallel_ranks as ranks  # tests/ is on the path: "tests" may name another package

    for name, spec in specs.items():
        res = got[f"train/{name}"]
        assert res["agree"], name
        want = ranks.train(spec, device=dev)
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=1e-5, err_msg=name)
        if spec["opt"] != "sgd":
            continue
        for k, w in want["state"].items():
            diff = float(np.abs(res["state"][k] - w).max()) if w.size else 0.0
            upd = float(np.abs(w - spec["state"][k].numpy()).max()) if w.size else 0.0
            assert diff <= max(5e-5, 1e-2 * upd), (k, diff, upd)


def _rank_lists(save_dir) -> dict:
    return {n: np.load(save_dir / f"{n}.npy")
            for n in ("topk_pred_list", "topk_triplet_list", "cls_matrix_list")}


def test_data_parallel_two_ranks_on_one_card_equal_one_process(dev, tmp_path, monkeypatch):
    """Two gloo ranks sharing the card (``parallel.spawn_ranks``), dropout
    on: the global batch's losses over 2 SGD and 3 AdamW steps equal one
    process's; then evaluation (fused PointNet) streamed through
    ``shard_eval_batches`` and resident through ``ResidentShardedEval``
    (groups 1 and 2): rank 0's rank lists against the same evaluation with
    no group, at most 0.1 % of them differing, and in every rank 4
    segment-max launches and 1 PointNet a batch."""
    import torch_parallel_ranks as ranks
    from vlsat_tpu_torch import parallel
    from vlsat_tpu_torch.data.packed import PackedLoader
    from vlsat_tpu_torch.data.resident import ResidentGroupedEval, ResidentScenes
    from vlsat_tpu_torch.data.synthetic import make_batch
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.models.mmgnet import MMGNet, MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.train.step import make_eval_step

    monkeypatch.setenv("VLSAT_WIRE_DTYPE", "float32")  # the ranks inherit it
    packed = _small_pack(tmp_path, num_scans=12, insts=(4, 12))
    cfg = MMGNetConfig(point_feature_size=64, dim_node=64, dim_edge=64, dim_atten=32,
                       num_heads=4, clip_feat_dim=64, fused_pointnet=True)
    batches = [make_batch(seed=s, node_counts=(5, 8, 3, 6, 4, 7, 2, 8), num_points=32,
                          bucket=8, feat_dim=64) for s in (4, 5)]
    ev = {"kw": dict(scene_recall=True, train_triplet_vocab=_triplet_vocab(batches)),
          "batches": batches, "pack": packed.root, "bs": 4, "work": str(tmp_path / "ranks"),
          "save_ranks": True,
          "model": dict(model_cls=MMGNet, cfg=cfg,
                        state=build_mmgnet(cfg, device="cpu", seed=8).state_dict())}
    specs = _dp_train_specs()
    path = str(tmp_path / "inputs.pt")
    torch.save({"train": specs, "eval": ev}, path)
    got = parallel.spawn_ranks(ranks.run, 2, path, device="cuda", store_dir=str(tmp_path),
                               timeout_s=300)
    assert got["world"] == (2, "gloo", "cuda:0")
    _assert_dp_train_equals_one_process(got, specs, dev)
    assert got["eval/agree"]

    model = ranks.build(ev["model"], dev)
    step, sd = make_eval_step(model, device=dev), model.state_dict()
    resident = ResidentScenes(packed, device=dev)
    loaders = {"model": batches, "streamed_pack": PackedLoader(packed, 4),
               **{f"resident_group{g}": ResidentGroupedEval(resident, 4, group=g)
                  for g in (1, 2)}}
    for name, loader in loaders.items():
        evaluate(step, sd, loader, save_dir=str(tmp_path / "one" / name), verbose=False,
                 **ev["kw"])
        want = _rank_lists(tmp_path / "one" / name)
        lists = _rank_lists(tmp_path / "ranks" / name)
        assert all(lists[k].shape == w.shape for k, w in want.items()), name
        differ = sum(int((lists[k] != w).sum()) for k, w in want.items())
        assert differ <= 1e-3 * sum(w.size for w in want.values()), (name, differ)
        for calls, seg, pn in (r[name] for r in got["launches"]):
            assert calls > 0 and (seg, pn) == (4 * calls, calls), (name, calls, seg, pn)


def test_data_parallel_one_nccl_rank_on_card_equals_one_process(dev, tmp_path):
    """One rank on the card forms an NCCL group: its SGD and AdamW steps
    equal the same steps without a group."""
    import torch_parallel_ranks as ranks
    from vlsat_tpu_torch import parallel

    specs = _dp_train_specs()
    path = str(tmp_path / "inputs.pt")
    torch.save({"train": specs}, path)
    got = parallel.spawn_ranks(ranks.run, 1, path, device="cuda", store_dir=str(tmp_path),
                               timeout_s=300)
    assert got["world"] == (1, "nccl", "cuda:0")
    _assert_dp_train_equals_one_process(got, specs, dev)


def test_offline_projection_and_depth_on_card_equal_cpu(dev):
    """``project_points`` (both intrinsic ranks), ``backproject_depth`` and
    ``nearest_instance`` on the card against the CPU: pixels at rtol 1e-5 /
    atol 1e-4, visibility equal off the image borders, back-projection at
    the parity gate, instance assignments equal (the same elementwise
    arithmetic on both)."""
    from vlsat_tpu_torch.preprocess.depth import backproject_depth, nearest_instance
    from vlsat_tpu_torch.projection import project_points

    rng = np.random.RandomState(0)
    pts = torch.from_numpy((rng.rand(3000, 3) * [4, 3, 2] + [-2, -1.5, 1]).astype(np.float32))
    ext = torch.from_numpy(np.tile(np.eye(4, dtype=np.float32), (6, 1, 1)))
    ext[:, 0, 3] = torch.linspace(-1, 1, 6)
    k = torch.tensor([[756.0, 0, 480, 0], [0, 756.0, 270, 0], [0, 0, 1, 0]])
    for intr in (k, k.expand(6, 3, 4).contiguous()):
        pix, vis = project_points(pts.to(dev), ext.to(dev), intr.to(dev), 960, 540)
        pix_h, vis_h = project_points(pts, ext, intr, 960, 540)
        assert torch.allclose(pix.cpu(), pix_h, rtol=1e-5, atol=1e-4)
        u, v = pix_h[..., 0], pix_h[..., 1]
        border = (u.abs() < 1e-3) | ((u - 960).abs() < 1e-3) | (v.abs() < 1e-3) | \
            ((v - 540).abs() < 1e-3)
        assert torch.equal(vis.cpu()[~border], vis_h[~border]) and vis_h.any()
    depth = torch.from_numpy((rng.rand(22, 28) * 5).astype(np.float32))
    depth[::3] = 0
    kd = torch.tensor([[22.0, 0, 14], [0, 22.0, 11], [0, 0, 1]])
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([0.5, -0.2, 0.1])
    world = backproject_depth(depth.to(dev), kd.to(dev), pose.to(dev)).cpu()
    assert torch.allclose(world, backproject_depth(depth, kd, pose), rtol=1e-3, atol=1e-4)
    labels = rng.randint(1, 9, len(pts)).astype(np.int32)
    q = world.numpy()[depth.reshape(-1).numpy() > 0]
    got = nearest_instance(q, pts.numpy(), labels, max_dist=0.3, chunk=200, device=dev)
    np.testing.assert_array_equal(got, nearest_instance(q, pts.numpy(), labels, max_dist=0.3,
                                                        chunk=200, device="cpu"))
    assert (got != 0).any() and (got == 0).any()


def test_adapter_steps_on_card_equal_cpu(dev):
    """Ten ``train_adapter`` steps (512-d, 160 classes, B=32) on the card
    against the CPU from the same initial weights: losses rtol 1e-4, the
    weights within 1e-5, the best top-1 within 0.5 points."""
    from vlsat_tpu_torch.clipsem.adapter_train import train_adapter

    rng = np.random.RandomState(1)
    labels = rng.randint(0, 160, 320)
    feats = rng.randn(320, 512).astype(np.float32)
    table = rng.randn(160, 512).astype(np.float32)
    table /= np.linalg.norm(table, axis=-1, keepdims=True)
    init = {n: {"kernel": (rng.randn(i, o) / np.sqrt(i)).astype(np.float32),
                "bias": np.zeros(o, np.float32)} for n, i, o in (("fc1", 512, 256),
                                                                 ("fc2", 256, 512))}
    runs = []
    for device in (dev, "cpu"):
        hist = {}
        params, top1 = train_adapter(feats, labels, feats[:64], labels[:64], table, epochs=1,
                                     init_params=init, device=device, history=hist)
        runs.append((params, top1, torch.stack(hist["loss"]).cpu().numpy()))
    (p_card, t_card, l_card), (p_cpu, t_cpu, l_cpu) = runs
    assert len(l_card) == 10
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-4)
    assert abs(t_card - t_cpu) <= 0.5, (t_card, t_cpu)
    for layer in ("fc1", "fc2"):
        np.testing.assert_allclose(p_card[layer]["kernel"], p_cpu[layer]["kernel"], atol=1e-5)


def test_serve_tool_on_card(dev, tmp_path):
    """``tools.serve`` for a second on the card at full width: every pool
    scene answered, segment-max launched, the PointNet kernel not (the
    tool's model keeps ``fused_pointnet`` off, as the JAX tool does)."""
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.tools import serve

    segment_max.launches = pointnet_kernel.launches = 0
    res = serve.main(["--max-batch", "8", "--clients", "4", "--duration", "1", "--naive",
                      "--out", str(tmp_path / "serve.json")])
    assert segment_max.launches > 0 and pointnet_kernel.launches == 0
    assert res["batched"]["requests"] > 0 and res["naive_per_scene_dispatch"]["scenes_per_sec"] > 0
    assert np.isfinite(res["batched"]["p99_latency_ms"])


def _reference_module_files(directory, seed: int) -> None:
    """Per-module ``.pth`` files of a reference ``Mmgnet`` checkpoint
    (BaseModel.save naming and Sequential indices, as
    tests/test_torch_import.py fabricates them) at full width, with seeded
    weights scaled by 1/sqrt(fan-in) and positive BatchNorm variances."""
    g = torch.Generator().manual_seed(seed)
    d, h, da = 512, 8, 256
    dn, do = d // h, da // h

    def lin(prefix, din, dout):
        p = f"{prefix}." if prefix else ""
        return {f"{p}weight": torch.randn(dout, din, generator=g) / din ** 0.5,
                f"{p}bias": 0.1 * torch.randn(dout, generator=g)}

    def norm(prefix, n, stats=False):
        out = {f"{prefix}.weight": 1 + 0.1 * torch.randn(n, generator=g),
               f"{prefix}.bias": 0.1 * torch.randn(n, generator=g)}
        if stats:
            out[f"{prefix}.running_mean"] = 0.5 * torch.randn(n, generator=g)
            out[f"{prefix}.running_var"] = 0.5 + torch.rand(n, generator=g)
        return out

    def many(*parts):
        return {k: v for part in parts for k, v in part.items()}

    pointnet = lambda cin, cout: many(lin("conv1", cin, 64), lin("conv2", 64, 128),
                                      lin("conv3", 128, cout))
    mha = lambda p: many(*(lin(f"{p}.attention.fc_{x}", d, d) for x in "qkvo"),
                         norm(f"{p}.layer_norm", d))
    gean = lambda p: many(
        lin(f"{p}.edgeatten.nn_edge.0", 3 * d, 2 * d), lin(f"{p}.edgeatten.nn_edge.2", 2 * d, d),
        lin(f"{p}.edgeatten.proj_query.0", d, d), lin(f"{p}.edgeatten.proj_edge.0", d, d),
        lin(f"{p}.edgeatten.proj_value.0", d, da), lin(f"{p}.edgeatten.nn.0", 2 * dn, 2 * dn),
        lin(f"{p}.edgeatten.nn.3", 2 * dn, do), lin(f"{p}.prop.0", d + da, d + da),
        lin(f"{p}.prop.2", d + da, d))
    mmg = many(lin("self_attn_fc.0", 4, 32), norm("self_attn_fc.2", 32),
               lin("self_attn_fc.3", 32, 32), norm("self_attn_fc.5", 32),
               lin("self_attn_fc.6", 32, h),
               *(mha(f"{m}.{i}") for i in range(2)
                 for m in ("self_attn", "cross_attn", "cross_attn_rel")),
               *(gean(f"{m}.{i}") for i in range(2) for m in ("gcn_3ds", "gcn_2ds")))
    rel = lambda: many(lin("fc1", d, 512), lin("fc2", 512, 256), lin("fc3", 256, 26))
    modules = {
        "obj_encoder": pointnet(3, 768), "rel_encoder_2d": pointnet(11, d),
        "rel_encoder_3d": pointnet(11, d), "mmg": mmg,
        "clip_adapter": many(lin("fc1", d, 256), lin("fc2", 256, d)),
        "rel_predictor_2d": rel(), "rel_predictor_3d": rel(),
        "obj_predictor_2d": lin("", d, 160), "obj_predictor_3d": lin("", d, 160),
        "mlp_3d": many(lin("0", 768, 504), norm("1", 504, stats=True)),
        "triplet_projector_2d": many(lin("0", 3 * d, 1024), lin("3", 1024, d)),
        "obj_logit_scale": {"obj_logit_scale": torch.tensor(float(np.log(1 / 0.07)))},
    }
    directory.mkdir(parents=True, exist_ok=True)
    for name, sd in modules.items():
        torch.save(sd, directory / f"{name}.pth")


def test_imported_reference_on_card_matches_cpu(dev, tmp_path):
    """A reference checkpoint directory of per-module ``.pth`` files at full
    width, imported by ``interop.torch_import``: the dual forward on the
    card equals the CPU's at the model gate on valid rows."""
    from vlsat_tpu_torch.data.synthetic import make_batch
    from vlsat_tpu_torch.interop.torch_import import import_from_directory, to_state_dict
    from vlsat_tpu_torch.models.mmgnet import MMGNet, MMGNetConfig
    from vlsat_tpu_torch.train.step import make_eval_step

    _reference_module_files(tmp_path / "ckpt", seed=13)
    variables = import_from_directory(str(tmp_path / "ckpt"))
    batch = make_batch(seed=14, node_counts=(5, 9, 7, 6), num_points=64)
    outs = []
    for d in (dev, "cpu"):
        model = MMGNet(MMGNetConfig()).to(d)
        model.load_state_dict(to_state_dict(variables, model))
        outs.append(make_eval_step(model.eval(), device=d)(model.state_dict(), batch))
    masks = {"obj": batch.obj_mask, "rel": batch.edge_mask}
    for key, w in outs[1].items():
        m = masks[key.split("_")[0]]
        torch.testing.assert_close(outs[0][key].cpu()[m], w[m], rtol=1e-3, atol=1e-4, msg=key)


def test_parity_eval_on_card_within_tolerance_of_cpu(dev, tmp_path):
    """``tools.parity_eval`` on a seeded full-width reference ``.pth``
    directory and a 6-scan PLY split: the card run against the CPU run's
    metrics as the reference is within the 0.5-point tolerance, with 4
    segment-max launches a batch."""
    from vlsat_tpu_torch.data.synthetic import make_synthetic_split
    from vlsat_tpu_torch.ops.kernels import segment_max
    from vlsat_tpu_torch.tools import parity_eval

    _reference_module_files(tmp_path / "ckpt", seed=4)
    root, scans, _ = make_synthetic_split(str(tmp_path / "split"), num_scans=6,
                                          insts_per_scan=(4, 9), vertices_per_inst=300,
                                          rels_per_scan=(2, 8), seed=4, write_ply=True)
    kw = dict(ckpt_dir=str(tmp_path / "ckpt"), root=root, scans_root=scans,
              eval_batch_size=2, verbose=False)
    cpu, _ = parity_eval.run_parity_eval(**kw, device="cpu")
    labels = {key: label for label, key in parity_eval.REF_LABEL_TO_KEY.items()}
    ref = tmp_path / "result.txt"
    ref.write_text("".join(f"Eval: {labels[k]} : {v!r}\n" for k, v in cpu.items()
                           if k in labels and np.isfinite(v)))
    segment_max.launches = 0
    card, ok = parity_eval.run_parity_eval(**kw, reference=str(ref), device=dev)
    assert ok and segment_max.launches == 4 * 3
    assert sorted(card) == sorted(cpu)
    for k, v in cpu.items():
        assert (np.isnan(v) and np.isnan(card[k])) or abs(card[k] - v) <= 0.5, (k, card[k], v)


def test_bench_tools_on_card(dev, tmp_path, monkeypatch):
    """``tools.bench`` on the card at a tiny size: ``bench.py``'s 32 keys,
    finite rates, MFU against the card's peak and segment-max launched; then
    ``tools.bench_encoders``' fused PointNet against its plain twin at the
    kernel gate, the kernel launched."""
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.tools import bench, bench_encoders

    tiny = dict(NODE_COUNTS=(5, 7, 9, 12), BUCKET=12, EVAL_CALLS=2, TRAIN_CALLS=2,
                LATENCY_CALLS=5, LATENCY_NODES=9, SPLIT_SCANS=14, VERTS_PER_INST=60,
                MIX_SCANS=40, EVAL_B=4, B_TR=2, K=2, K_MIX=1, SERV_DURATION=0.5, SERV_CLIENTS=4)
    for name, value in tiny.items():
        monkeypatch.setattr(bench, name, value)
    monkeypatch.setenv("VLSAT_BENCH_E2E_REPS", "1")
    monkeypatch.setenv("VLSAT_BENCH_SPLIT", str(tmp_path / "split"))
    monkeypatch.setenv("VLSAT_BENCH_MIX_SPLIT", str(tmp_path / "mix"))
    segment_max.launches = pointnet_kernel.launches = 0
    res = bench.main([])
    assert len(res) == 32 and segment_max.launches > 0
    for k in res:
        if k.endswith("scenes_per_sec") or k == "value":
            assert np.isfinite(res[k]) and res[k] > 0, k
    assert 0 < res["eval_mfu"] < 1 and 0 < res["train_mfu"] < 1

    pointnet_kernel.launches = 0
    enc = bench_encoders.main(["--scenes", "8", "--nodes", "9"])
    assert enc["object_encoder"]["within_gate"] and pointnet_kernel.launches > 0
