"""The yardstick's arithmetic against hand counts: FLOPs, the segment-max
byte bound, the trace reduction, the arrival schedule and the scene
sources."""

import numpy as np
import pytest
import torch

from benchmark.harness import roofline, scenes
from benchmark.harness.trace import name_gaps, union_length
from benchmark.reference import oracle, plain
from benchmark.traffic import serve_open_loop


def test_linear_flops_are_two_per_multiply_add():
    lin = torch.nn.Linear(48, 20)
    x = torch.randn(7, 48)
    assert roofline.count_flops(lambda: lin(x)) == 2 * 7 * 48 * 20


def test_pointnet_flops_by_hand():
    net = oracle._PointNetfeat(3, 768)
    x = torch.randn(5, 3, 128)
    assert roofline.count_flops(lambda: net(x)) == 2 * 5 * 128 * (3 * 64 + 64 * 128 + 128 * 768)


def test_sgfn_train_flops_count_the_backward():
    ref = oracle.TorchSGFNOracle(depth=1)
    scene = scenes.make_scenes(scenes.label_specs("val_splits")[:1], 1, with_2d=False)[0]
    blk = plain.flatten([scene], torch.device("cpu"))
    fwd = roofline.count_flops(lambda: plain.sgfn_forward(ref, blk))

    def fwd_bwd():
        loss = plain.sgfn_loss(plain.sgfn_forward(ref, blk), blk)
        torch.autograd.grad(loss, list(ref.parameters()), allow_unused=True)

    both = roofline.count_flops(fwd_bwd)
    assert 2.5 * fwd < both < 3.05 * fwd  # backward ~2x the forward's products


def test_segment_max_bytes_by_hand():
    # 2 scenes, bucket 4 (12 edges), 7 valid edges, 8 channels
    assert roofline.segment_max_bytes(7, 2, 12, 4, 8) == 7 * 8 * 4 + 7 * 4 + 2 * 12 + 2 * 4 * 8 * 4


def test_peaks_of_the_card_and_none_elsewhere():
    row = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert row["fp32_flops"] == pytest.approx(165e12) and row["hbm_bytes_per_s"] == 3.35e12
    assert roofline.peaks(None) is None and roofline.peaks("NVIDIA A100") is None


def test_union_and_idle_gaps():
    busy, merged = union_length([(0, 10), (5, 12), (20, 30), (29, 31)])
    assert busy == 23 and merged == [(0, 12), (20, 31)]
    host = [(0, 100, "outer"), (13, 19, "inner"), (40, 60, "late")]
    gaps = name_gaps([(12, 20), (31, 50), (101, 111)], host)
    assert gaps == {"inner": pytest.approx(8e-9), "late": pytest.approx(19e-9),
                    "python after outer": pytest.approx(10e-9)}


def test_arrivals_offer_the_same_gaps_in_another_order():
    a = serve_open_loop.arrivals(100.0, 10.0, 1)
    b = serve_open_loop.arrivals(100.0, 10.0, 2 ** 31 + 5)
    assert abs(len(a) - 1000) <= 5 and abs(len(b) - 1000) <= 5
    shared = np.intersect1d(np.round(np.diff(a), 12), np.round(np.diff(b), 12))
    assert len(shared) >= min(len(a), len(b)) - 3  # all gaps but the first and last
    assert not np.allclose(a[:50], b[:50])


def test_scene_sources_keep_the_real_counts():
    splits = scenes.label_specs("val_splits")
    assert len(splits) == 548
    counts = np.bincount([len(s["gt_class"]) for s in splits])
    assert counts[5:10].tolist() == [15, 19, 25, 20, 469]
    rooms = scenes.label_specs("val_scans", max_nodes=64)
    assert len(rooms) == 151 and max(len(s["gt_class"]) for s in rooms) == 63
    s = scenes.make_scenes(splits[:3], 2 ** 31 + 7)
    t = scenes.make_scenes(splits[:3], 2 ** 31 + 7)
    assert all(np.array_equal(a["obj_points"], b["obj_points"]) for a, b in zip(s, t))
    pts = s[0]["obj_points"]
    assert np.array_equal(pts, pts.astype(np.float16).astype(np.float32))
    n = len(splits[0]["gt_class"])
    assert s[0]["gt_rels"].shape == (n * (n - 1), 26)
    assert s[0]["gt_rels"].sum() == len(splits[0]["rels"])
