"""The SGGpoint cell (``sggpoint.serve.room``) on the CPU at a small size
(128 -> 32 points an instance, rooms of at most 8 objects, every width as
published): it runs and reads correct, a fault under the timed path reads
not correct (a shifted neighbour set, one wrong weight), its control reads
not correct, and its yardstick's arithmetic holds: the DGCNN's factored
FLOP count against ``FlopCounterMode`` on a factored twin, and the
attribution of kernels to ``model.dgcnn`` on a synthetic trace."""

import json

import pytest
import torch
import torch.nn.functional as F

from benchmark import control_sggpoint, run
from benchmark.harness import core, roofline
from benchmark.harness.dgcnn import dgcnn_factored_flops, span_device_time
from benchmark.harness.weights import build_reference
from benchmark.reference import sggpoint as R

CELL = "sggpoint.serve.room"
SMALL = {"config": {"num_points": 32},
         "params": {"max_nodes": 8, "rate": 6, "max_batch": 4, "sample": 4, "ref_block": 4,
                    "grace_s": 30, "trace_s": 1}}


def _args(seed=3000000019, trace=0):
    return ["--workload", CELL, "--seed", str(seed), "--seconds", "2", "--trace", str(trace)]


def _line(capsys, trace=0) -> dict:
    assert run.main(_args(trace=trace), device=torch.device("cpu"), overrides=SMALL) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_cpu(trace, capsys):
    line = _line(capsys, trace)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in core.cell_metrics(spec, CELL, kind)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names == {"serve_p50_ms", "serve_scenes_per_s", "setup_s"}
    assert {"replay_gap", "knn_set_excess", "knn_sets_off", "obj_logit_gap"} <= set(
        line["checks"])
    assert core.forbidden_modules() == []


def test_shifted_neighbour_set_is_not_correct(capsys, monkeypatch):
    from vlsat_tpu_torch.ops import dgcnn

    real = dgcnn.knn_indices

    def shifted(x, k):  # each point's set one index over: not its nearest
        return (real(x, k) + 1) % x.shape[-2]

    monkeypatch.setattr(dgcnn, "knn_indices", shifted)
    line = _line(capsys)
    assert line["correct"] is False
    assert line["checks"]["knn_set_excess"]["value"] > line["checks"]["knn_set_excess"]["limit"]


def test_one_wrong_weight_is_not_correct(capsys, monkeypatch):
    from vlsat_tpu_torch.interop import torch_import

    real = torch_import.import_sggpoint

    def altered(sds):
        out = real(sds)
        out["params"]["edge_gcn"]["edgegcn_3d"]["node_GConv2_fc"]["bias"][0] += 0.5
        return out

    monkeypatch.setattr(torch_import, "import_sggpoint", altered)
    line = _line(capsys)
    assert line["correct"] is False, line["checks"]


def test_control_fails_the_check_on_the_cpu():
    line = control_sggpoint.control(CELL, 7, torch.device("cpu"), SMALL)
    assert line["correct"] is False, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.cuda
def test_control_fails_the_check_on_the_card(card):
    line = control_sggpoint.control(CELL, 8, card)
    assert line["correct"] is False, line["checks"]


def _factored_twin(net: R.DGCNN, x: torch.Tensor) -> torch.Tensor:
    """The reference DGCNN in its factored form (BatchNorm folded in after
    the products): per stage a Gram for the kNN, one product of each point
    with [W1 | W2 - W1], the gather after the product, then conv5."""
    feats, k = [], net.k
    for i in range(len(R.STAGES)):
        conv, bn = getattr(net, f"conv{i + 1}")[:2]
        c = x.shape[1]
        xt = x.transpose(1, 2)                                         # (M, P, C)
        gram = xt @ x                                                  # (M, P, P)
        sq = gram.diagonal(dim1=1, dim2=2)
        idx = (2 * gram - sq[:, :, None] - sq[:, None, :]).topk(k, dim=-1)[1]
        w = conv.weight[:, :, 0, 0]                                    # (out, 2C)
        w1, w2 = w[:, :c], w[:, c:]
        proj = xt @ torch.cat([w1, w2 - w1]).t()                       # (M, P, 2 out)
        a, b = proj.split(w.shape[0], dim=-1)
        h = a.gather(1, idx.reshape(idx.shape[0], -1, 1).expand(-1, -1, a.shape[-1]))
        h = h.view(*idx.shape, -1) + b[:, :, None, :]                  # x_j W1 + x_i (W2 - W1)
        h = F.leaky_relu(F.batch_norm(h.permute(0, 3, 1, 2), bn.running_mean, bn.running_var,
                                      bn.weight, bn.bias, eps=bn.eps), 0.2)
        x = h.max(dim=-1)[0]
        feats.append(x)
    conv5, bn5 = net.conv5[:2]
    h = torch.cat(feats, 1).transpose(1, 2) @ conv5.weight[:, :, 0].t()
    return F.leaky_relu(F.batch_norm(h.transpose(1, 2), bn5.running_mean, bn5.running_var,
                                     bn5.weight, bn5.bias, eps=bn5.eps), 0.2)


@pytest.mark.parametrize("points", [32, 128])
def test_factored_flops_count_the_factored_twin(points):
    net = build_reference(R.DGCNN, torch.device("cpu"), 5).double()
    x = torch.randn(3, 3, points, dtype=torch.float64)
    total, parts = dgcnn_factored_flops(points)
    with torch.no_grad():
        assert roofline.count_flops(lambda: _factored_twin(net, x)) == 3 * total
        torch.testing.assert_close(_factored_twin(net, x), net(x), rtol=1e-10, atol=1e-10)
    if points == 128:  # ~132 MFLOP, against 572 M in the original form
        assert total == 132_317_184 and parts["gram"] == 8_486_912
        with torch.no_grad():
            original = roofline.count_flops(lambda: net(x)) / 3
        assert original == pytest.approx(572e6, rel=0.01)


def test_kernels_are_attributed_to_the_dgcnn_span_by_launch():
    ev = lambda cat, name, ts, dur, tid, **args: {"ph": "X", "cat": cat, "name": name, "ts": ts,
                                                  "dur": dur, "tid": tid, "args": args}
    events = [
        ev("user_annotation", "model.dgcnn", 100, 50, 7),
        ev("user_annotation", "model.dgcnn", 300, 50, 7),
        ev("cuda_runtime", "cudaLaunchKernel", 110, 2, 7, correlation=1),   # inside
        ev("cuda_driver", "cuLaunchKernel", 340, 2, 7, correlation=2),      # inside
        ev("cuda_runtime", "cudaLaunchKernel", 200, 2, 7, correlation=3),   # between spans
        ev("cuda_runtime", "cudaLaunchKernel", 120, 2, 9, correlation=4),   # another thread
        ev("kernel", "gemm", 400, 30, 1, correlation=1),   # runs after its span: still counts
        ev("gpu_memset", "memset", 500, 5, 1, correlation=2),
        ev("kernel", "attn", 600, 70, 1, correlation=3),
        ev("kernel", "other", 700, 11, 1, correlation=4),
    ]
    got = span_device_time(events)
    assert got == {"spans": 2, "seconds": pytest.approx(35e-6)}
    assert span_device_time(events[2:]) is None  # no annotation: nothing to read


def test_dgcnn_readers_read_nothing_without_their_inputs():
    for name in ("dgcnn_busy_ms.serve", "dgcnn_roofline.serve"):
        assert core.load_reader(name).read({"kind": "serve"}, name) is None
    obs = {"kind": "serve", "peaks": {"fp32_flops": 165e12}, "dgcnn_flops_per_instance": 1e8,
           "traced_batches": [(100, 2048), (300, 2048)],
           "trace": {"dgcnn": {"spans": 2, "seconds": 0.02}}}
    assert core.load_reader("dgcnn_busy_ms.serve").read(obs, "dgcnn_busy_ms.serve") == \
        pytest.approx(10.0)
    assert core.load_reader("dgcnn_roofline.serve").read(obs, "dgcnn_roofline.serve") == \
        pytest.approx(100.0 * 200 * 1e8 / 165e12 / 0.01)
