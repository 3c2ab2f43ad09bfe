"""The factored EdgeConv on the CPU: ``vlsat::edgeconv_max``'s plain twin
(``ops.kernels.edgeconv.edgeconv_max_plain``) over ``ops.dgcnn.project_pairs``
against the dense stage the DGCNN runs in training (``graph_feature`` ->
Linear -> eval ``MaskedBatchNorm`` -> leaky ReLU -> max over k), the
operator's registration, and which path ``models.sggpoint.DGCNN`` takes.

Gates: float64 1e-12 (a reassociation of the projection's sums); float32
16 ulp of the stage's largest output (both forms are fp32 products over
C_in and 2 C_in terms, the dense one reading each neighbour's difference,
the factored one each point's projection: 5.7 ulp at most over these
shapes and five seeds).  Half of every stage's BatchNorm scales are
negative, so the max over k cannot be taken before the BatchNorm.
"""

from __future__ import annotations

import pytest
import torch
from torch.nn import functional as F

from tests.torch_threads import one_thread  # noqa: F401
from vlsat_tpu_torch.models import sggpoint as PS
from vlsat_tpu_torch.models.layers import MaskedBatchNorm
from vlsat_tpu_torch.ops import dgcnn
from vlsat_tpu_torch.ops.kernels import edgeconv

STAGES = [(3, 64), (64, 64), (64, 128), (128, 256)]  # (C_in, C_out) of the DGCNN's stages
F64_GATE = dict(rtol=1e-12, atol=1e-12)
F32_ULPS = 16


def _bn(c, seed):
    """An eval BatchNorm with statistics that are not the identity and
    every other scale negative."""
    g = torch.Generator().manual_seed(seed)
    bn = MaskedBatchNorm(c).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.2)
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
        bn.weight.copy_(torch.randn(c, generator=g))
        bn.weight[::2] = -bn.weight[::2].abs()
        bn.bias.copy_(torch.randn(c, generator=g) * 0.1)
    return bn


def _stage(c_in, c_out, seed, dtype):
    """A stage's weight (C_out, 2 C_in) and BatchNorm (``_bn``)."""
    g = torch.Generator().manual_seed(seed + 1)
    weight = torch.randn(c_out, 2 * c_in, generator=g) / (2 * c_in) ** 0.5
    return weight.to(dtype), _bn(c_out, seed).to(dtype)


def _points(case, c_in, seed, dtype):
    """(B, N, P, C_in) point sets of ``case`` and the k to take."""
    g = torch.Generator().manual_seed(seed)
    p, k = (12, 12) if case == "k_is_p" else (16, 8)
    x = torch.randn(2, 3, p, c_in, generator=g)
    if c_in > 3:  # a stage input: the previous stage's leaky ReLU output
        x = F.leaky_relu(x, 0.2)
    if case == "duplicates":  # every point twice, so every distance ties
        x[..., 1::2, :] = x[..., 0::2, :]
    if case == "padded":  # padded instances are all-zero clouds
        x[1, 1:] = 0.0
        x[0, 2] = 0.0
    return x.to(dtype), k


def _dense(x, idx, weight, bn):
    h = F.linear(dgcnn.graph_feature(x, idx=idx), weight)
    h = bn(h, torch.ones(h.shape[:-1], dtype=torch.bool))
    return F.leaky_relu(h, 0.2).amax(dim=-2)


def _factored(x, idx, weight, bn, fn=edgeconv.edgeconv_max_plain):
    return fn(dgcnn.project_pairs(x, weight), idx, bn.running_mean, bn.running_var, bn.weight,
              bn.bias, bn.eps)


@pytest.mark.parametrize("c_in,c_out", STAGES)
@pytest.mark.parametrize("case", ["random", "k_is_p", "duplicates", "padded"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_twin_equals_the_dense_stage(c_in, c_out, case, dtype):
    x, k = _points(case, c_in, seed=c_in + c_out, dtype=dtype)
    weight, bn = _stage(c_in, c_out, seed=c_out, dtype=dtype)
    idx = dgcnn.knn_indices(x, k)
    with torch.no_grad():
        want = _dense(x, idx, weight, bn)
        got = _factored(x, idx, weight, bn)
        op = _factored(x, idx, weight, bn, fn=edgeconv.edgeconv_max)
    assert got.shape == want.shape == (*x.shape[:-1], c_out)
    assert torch.equal(op, got) and op.is_contiguous()
    if dtype == torch.float64:
        torch.testing.assert_close(got, want, **F64_GATE)
    else:
        ulp = torch.finfo(dtype).eps * want.abs().max()
        assert (got - want).abs().max() <= F32_ULPS * ulp
    if case == "padded":  # an all-zero cloud: every point the same, so the rows equal
        assert torch.equal(got[1, 1:], got[1, 1:, :1].expand_as(got[1, 1:]))


def test_twin_takes_every_neighbour_and_propagates_nan():
    """The max runs over BatchNorm's output, not its input: with a negative
    scale the neighbour of the smallest projection wins; a NaN in one
    neighbour's projection reaches its point's output."""
    u = torch.tensor([[0.0, 0.0], [1.0, 0.0], [-2.0, 0.0]])  # one channel: (u, w)
    idx = torch.tensor([[0, 1, 2], [1, 1, 1], [2, 2, 0]])
    one, zero = torch.ones(1), torch.zeros(1)
    pos = edgeconv.edgeconv_max_plain(u, idx, zero, one, one, zero, 0.0)
    neg = edgeconv.edgeconv_max_plain(u, idx, zero, one, -one, zero, 0.0)
    assert pos[:, 0].tolist() == [1.0, 0.0, 2.0]
    assert neg[:, 0].tolist() == [2.0, 0.0, 0.0]
    u[1, 0] = float("nan")
    out = edgeconv.edgeconv_max_plain(u, idx, zero, one, one, zero, 0.0)
    assert out[:2].isnan().all() and not out[2].isnan().any()


def test_operator_passes_opcheck():
    """Schema, fake (shapes and strides) and dispatch of
    ``vlsat::edgeconv_max`` (``torch.library.opcheck``)."""
    x, k = _points("random", 8, seed=1, dtype=torch.float32)
    weight, bn = _stage(8, 12, seed=2, dtype=torch.float32)
    args = (dgcnn.project_pairs(x, weight).detach(), dgcnn.knn_indices(x, k),
            bn.running_mean, bn.running_var, bn.weight.detach(), bn.bias.detach(), bn.eps)
    torch.library.opcheck(torch.ops.vlsat.edgeconv_max.default, args)


def _dgcnn(seed=3, k=6):
    model = PS.DGCNN(3, 32, k)
    for i in range(1, 5):
        bn = getattr(model, f"conv{i}_bn")
        bn.load_state_dict(_bn(bn.weight.numel(), seed + i).state_dict())
    return model


def _dense_forward(model, pts, mask, k):
    """The DGCNN's dense stages, written out."""
    x, feats = pts, []
    for i in range(1, 5):
        h = getattr(model, f"conv{i}_fc")(dgcnn.graph_feature(x, k=k))
        h = getattr(model, f"conv{i}_bn")(h, mask[:, :, None, None].expand(h.shape[:-1]))
        x = F.leaky_relu(h, 0.2).amax(dim=-2)
        feats.append(x)
    h = model.conv5_fc(torch.cat(feats, dim=-1))
    return F.leaky_relu(model.conv5_bn(h, mask[:, :, None].expand(h.shape[:-1])), 0.2)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "grad", "train"])
def test_dgcnn_takes_the_operator_only_in_eval_without_autograd(mode, monkeypatch):
    """Eval mode with autograd off runs every stage through the operator,
    within the float32 gate of the dense stages; training mode, or autograd
    on, runs the dense stages, with the dense chain's outputs and
    gradients."""
    model = _dgcnn()
    pts = torch.randn(2, 3, 10, 3, generator=torch.Generator().manual_seed(4))
    mask = torch.tensor([[True, True, False], [True, False, False]])
    calls, real = [], PS.edgeconv_max
    monkeypatch.setattr(PS, "edgeconv_max", lambda *args: calls.append(1) or real(*args))
    context = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode}.get(
        mode, torch.enable_grad)
    model.train(mode == "train")
    with context():
        fused = model.fused_stages()
        out = model(pts, mask)
    assert fused == len(calls) == (4 if mode in ("no_grad", "inference_mode") else 0)
    if mode == "train":
        return
    if mode == "grad":
        want = _dense_forward(model, pts, mask, 6)
        assert torch.equal(out, want)
        params = list(model.parameters())
        got = torch.autograd.grad(out.square().sum(), params)
        for g, w in zip(got, torch.autograd.grad(want.square().sum(), params)):
            assert torch.equal(g, w)
        return
    with torch.no_grad():
        dense = _dense_forward(model, pts, mask, 6)
    assert len(calls) == 4  # the written-out stages reach no operator
    ulp = torch.finfo(torch.float32).eps * dense.abs().max()
    assert (out - dense).abs().max() <= F32_ULPS * ulp


def test_export_traces_through_the_operator():
    """``torch.export`` of the eval DGCNN under ``no_grad`` keeps
    ``vlsat::edgeconv_max`` as one node a stage (the fake gives its
    shapes), and the program equals the eager forward."""
    model = _dgcnn().eval()
    pts = torch.randn(2, 3, 10, 3, generator=torch.Generator().manual_seed(5))
    mask = torch.ones(2, 3, dtype=torch.bool)
    with torch.no_grad():
        prog = torch.export.export(model, (pts, mask))
        want = model(pts, mask)
    ops = [n.target for n in prog.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.vlsat.edgeconv_max.default) == 4
    assert torch.equal(prog.module()(pts, mask), want)
