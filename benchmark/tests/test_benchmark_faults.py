"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have (one chip: no exchange between chips to
leave out).  The look for a card is skipped and the run is small."""

import json

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny


def _eval_step_fault(kind):
    from vlsat_tpu_torch.train import step as steps

    real = steps.make_eval_step

    def make(model, branch_3d_only=False, device=None):
        inner = real(model, branch_3d_only=branch_3d_only, device=device)

        def step(state, batch):
            out = dict(inner(state, batch))
            real = int(batch.obj_mask.any(-1).sum())  # the scenes that are not padding
            h = real // 2
            for k, v in out.items():
                v = v.clone()
                if kind == "half_batch":  # the second half answered from the first
                    v[h:real] = v[:real - h]
                elif k.startswith("obj_logits"):  # one logit of every scene altered
                    v[:, :, 0] += 0.5
                out[k] = v
            return out

        step.device = inner.device
        return step

    return make


def _result(cell, capsys) -> dict:
    over = tiny.overrides(cell)
    if "serve" in cell:  # batches of several scenes, so that half of one can go missing
        over["params"]["rate"] = 40
    assert run.main(tiny.args(cell), device=torch.device("cpu"), overrides=over,
                    spec=tiny.spec(cell)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["vlsat_mmgnet.serve.val", "vlsat_mmgnet.eval.val"])
@pytest.mark.parametrize("kind", ["half_batch", "altered_answer"])
def test_broken_eval_step_is_not_correct(cell, kind, capsys, monkeypatch):
    from vlsat_tpu_torch.train import step as steps

    monkeypatch.setattr(steps, "make_eval_step", _eval_step_fault(kind))
    line = _result(cell, capsys)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("kind", ["unchanged_state", "half_batch", "altered_answer"])
def test_broken_train_step_is_not_correct(kind, capsys, monkeypatch):
    from vlsat_tpu_torch.train import losses, optim
    from vlsat_tpu_torch.train import step as steps

    if kind == "unchanged_state":
        monkeypatch.setattr(optim.OptimizerSpec, "update", staticmethod(lambda o, s: None))
    elif kind == "half_batch":
        real = steps.gather_rows
        monkeypatch.setattr(steps, "gather_rows",
                            lambda full, rows: real(full, rows[:max(len(rows) // 2, 1)]))
    else:
        real_loss = losses.sgfn_loss

        def altered(outputs, batch, **kw):
            loss, aux = real_loss(outputs, batch, **kw)
            return loss * 1.001, dict(aux, loss=loss * 1.001)

        monkeypatch.setattr(losses, "sgfn_loss", altered)
    line = _result("sgfn.train.val", capsys)
    assert line["correct"] is False, line["checks"]
