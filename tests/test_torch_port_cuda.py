"""The port's CUDA kernels against their plain twins, on the card.

These tests need an NVIDIA card with nvcc; without one they skip.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: segment-max is bit-equal (max picks one of its inputs; NaN
where the twin has NaN); PointNet rtol 1e-4 / atol 1e-5 (3xTF32 products on
the tensor cores against cuBLAS fp32), its gradients equal to the twin's
(the backward is the twin's at the same primal); the model rtol 1e-3 / atol
1e-4 (the parity gate); a train step's loss rtol 1e-4 against the CPU and
its gradients per leaf at the gate of tests/test_parity_torch.py:568-575
(rtol 2e-3, atol 2e-3 * max|g|).
"""

from __future__ import annotations

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


def test_train_step_on_card_matches_cpu(dev):
    """One train step from identical weights, every dropout off: loss and
    every gradient leaf against the CPU; no kernel launches in training."""
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.train.optim import make_optimizer
    from vlsat_tpu_torch.train.state import create_train_state
    from vlsat_tpu_torch.train.step import make_train_step

    models, batch = _narrow_train_setup(dev)
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
    paths give the same metrics; batches of equal shapes (6 scenes, B=3)."""
    from vlsat_tpu_torch.data.packed import PackedLoader
    from vlsat_tpu_torch.data.resident import (ResidentEvalLoader, ResidentGroupedEval,
                                               ResidentScenes)
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
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
        got = evaluate(step, model.state_dict(), loader, **kw)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert (np.isnan(w) and np.isnan(got[k])) or got[k] == w, (type(loader), k)


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


@pytest.mark.parametrize("name,per_forward", [("MmgnetSingle", 2), ("SGFN", 2), ("SGPN", 0),
                                               ("MMteacher", 4), ("MmgnetIn21k", 4),
                                               ("SGGpoint", 0), ("SGGpointBaseline", 0)])
def test_variant_eval_forward_on_card_matches_cpu(dev, name, per_forward):
    """A registry variant's eval forward on the card launches segment-max
    once per graph layer and branch (none for SGPN and the SGGpoint family)
    and equals the CPU's forward of the same weights at the model gate (16
    points an instance: the SGGpoint kNN takes every point, so no
    neighbour set can differ)."""
    from vlsat_tpu_torch.config import load_config
    from vlsat_tpu_torch.data.synthetic import make_batch
    from vlsat_tpu_torch.models.mmgnet import init_parameters
    from vlsat_tpu_torch.models.registry import build_model
    from vlsat_tpu_torch.ops.kernels import segment_max
    from vlsat_tpu_torch.train.step import make_eval_step

    mcfg = load_config(overrides={"MODEL": {"N_LAYERS": 2, "DIM_ATTEN": 32,
                                            "NUM_HEADS": 4}}).MODEL
    model, _ = build_model(name, 20, 7, mcfg)
    init_parameters(model, torch.Generator().manual_seed(4))
    batch = make_batch(seed=1, node_counts=(4, 6, 9), num_points=16,
                       feat_dim=768 if name == "MmgnetIn21k" else 512,
                       num_obj_classes=20, num_rel_classes=7)
    if name == "SGPN":
        rng = np.random.RandomState(2)
        pts = rng.randn(*batch.edge_mask.shape, 32, 4).astype(np.float32)
        batch = batch.replace(rel_points=torch.from_numpy(pts) * batch.edge_mask[..., None, None])
    want = make_eval_step(model, device="cpu")(model.state_dict(), batch)
    model.to(dev)
    before = segment_max.launches
    got = make_eval_step(model, device=dev)(model.state_dict(), batch)
    assert segment_max.launches - before == per_forward
    masks = {"obj": batch.obj_mask, "rel": batch.edge_mask}
    for key, w in want.items():
        m = masks[key.split("_")[0]]
        torch.testing.assert_close(got[key].cpu()[m], w[m], rtol=1e-3, atol=1e-4, msg=key)


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
    outputs equal the live 3D-only step's at 1e-6, with the same kernel
    launches (one PointNet and two segment-max a forward), and exporting
    launches nothing."""
    from vlsat_tpu_torch.data.synthetic import make_batch
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max
    from vlsat_tpu_torch.serving_export import load_serving_artifact
    from vlsat_tpu_torch.train.step import make_eval_step

    before = (segment_max.launches, pointnet_kernel.launches)
    model = _flagship_artifact(tmp_path, dev)
    assert (segment_max.launches, pointnet_kernel.launches) == before
    batch = make_batch(seed=2, node_counts=(3, 8, 5, 2), bucket=8, num_points=32,
                       num_obj_classes=20, num_rel_classes=7)
    counts = []
    outs = []
    for step in (make_eval_step(model, branch_3d_only=True, device=dev),
                 load_serving_artifact(str(tmp_path), device=dev)):
        before = (segment_max.launches, pointnet_kernel.launches)
        outs.append(step(model.state_dict(), batch))
        counts.append((segment_max.launches - before[0], pointnet_kernel.launches - before[1]))
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


def test_data_parallel_two_ranks_on_one_card_equal_one_process(dev, tmp_path):
    """Two gloo ranks sharing the card (``parallel.spawn_ranks``), dropout
    on: the global batch's losses over 2 SGD steps equal one process's at
    rtol 1e-5, and every weight is within max(5e-5, 1e-2 x its update)
    (tests/test_production_shape_sharding.py:76-77); both ranks agree."""
    import functools

    import torch_parallel_ranks as ranks  # tests/ is on the path: "tests" may name another package
    from vlsat_tpu_torch import parallel
    from vlsat_tpu_torch.data.synthetic import make_batch
    from vlsat_tpu_torch.models.mmgnet import MMGNet, MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.train.losses import vlsat_total_loss

    cfg = MMGNetConfig(num_obj_classes=20, num_rel_classes=7, point_feature_size=64,
                       dim_node=64, dim_edge=64, dim_atten=32, num_heads=4, clip_feat_dim=64)
    batches = [make_batch(seed=s, node_counts=(5, 8, 3, 6, 4, 7, 2, 8), num_points=16,
                          bucket=8, feat_dim=64, num_obj_classes=20, num_rel_classes=7)
               for s in (1, 2)]
    initial = build_mmgnet(cfg, device="cpu", seed=3).state_dict()
    spec = dict(model_cls=MMGNet, cfg=cfg, state=initial, dropout=True, opt="sgd", lr=1e-2,
                loss=functools.partial(vlsat_total_loss), batches=batches)
    path = str(tmp_path / "inputs.pt")
    torch.save({"train": {"case": spec}}, path)
    got = parallel.spawn_ranks(ranks.run, 2, path, device="cuda", store_dir=str(tmp_path),
                               timeout_s=300)
    assert got["world"] == (2, "gloo", "cuda:0")
    res = got["train/case"]
    assert res["agree"]
    want = ranks.train(spec, device=dev)
    np.testing.assert_allclose(res["losses"], want["losses"], rtol=1e-5)
    for k, w in want["state"].items():
        diff = float(np.abs(res["state"][k] - w).max()) if w.size else 0.0
        upd = float(np.abs(w - initial[k].numpy()).max()) if w.size else 0.0
        assert diff <= max(5e-5, 1e-2 * upd), (k, diff, upd)


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
    weights within 1e-5."""
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


def test_parity_eval_on_card_within_tolerance_of_cpu(dev, tmp_path):
    """``tools.parity_eval`` on a seeded full-width reference ``.pth``
    directory and a 6-scan PLY split: the card run against the CPU run's
    metrics as the reference is within the 0.5-point tolerance, with 4
    segment-max launches a batch."""
    import chip_smoke
    from vlsat_tpu_torch.data.synthetic import make_synthetic_split
    from vlsat_tpu_torch.ops.kernels import segment_max
    from vlsat_tpu_torch.tools import parity_eval

    chip_smoke.reference_module_files(tmp_path / "ckpt", seed=4)
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
