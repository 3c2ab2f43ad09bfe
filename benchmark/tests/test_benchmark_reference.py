"""The plain reference agrees with ``vlsat_tpu_torch`` at a small size on
the CPU: the forward on imported weights, the SGFN objective, the
optimizer's first update and the metric suite."""

import numpy as np
import torch

from benchmark.harness import core, program, scenes
from benchmark.reference import metrics as ref_metrics
from benchmark.reference import plain
from benchmark.tests import tiny


def _built(cell):
    cfg = core.load_config(core.load_cell(cell)["config"])
    cfg.update(tiny.overrides(cell)["config"])
    model, loss, _ = program.build(cfg, 11, torch.device("cpu"))
    return cfg, (model, program.reference(cfg, 11, torch.device("cpu")), loss)


def _batch(pool, cfg):
    from vlsat_tpu_torch.scene import collate, pad_scene

    return collate([pad_scene(s["obj_points"], s["descriptor"], s["obj_2d_feats"],
                              s["gt_class"], s["edge_index"], s["gt_rels"], n_max=12)
                    for s in pool])


@torch.no_grad()
def test_mmgnet_forward_matches_the_port():
    cfg, (model, ref, _) = _built("vlsat_mmgnet.eval.val")
    pool = scenes.make_scenes(scenes.label_specs("val_splits")[:3], 5)
    got = model(_batch(pool, cfg))
    for scene, out in zip(pool, range(3)):
        blk = plain.flatten([scene], torch.device("cpu"))
        want, want3 = plain.mmgnet_dual(ref, blk), plain.mmgnet_3d(ref, blk)
        n, e = len(scene["gt_class"]), len(scene["edge_index"])
        for k in ("obj_logits_3d", "obj_logits_2d", "rel_cls_3d", "rel_cls_2d"):
            rows = n if k.startswith("obj") else e
            np.testing.assert_allclose(got[k][out, :rows], want[k], rtol=1e-4, atol=1e-4)
        for k in ("obj_logits_3d", "rel_cls_3d"):
            np.testing.assert_allclose(want3[k], want[k], rtol=1e-5, atol=1e-6)


def test_sgfn_loss_and_first_update_match_the_port():
    from vlsat_tpu_torch.train.optim import make_optimizer
    from vlsat_tpu_torch.train.state import create_train_state

    cfg, (model, ref, loss_fn) = _built("sgfn.train.val")
    pool = scenes.make_scenes(scenes.label_specs("val_splits")[:4], 6, with_2d=False)
    batch = _batch(pool, cfg)
    model.train()
    loss, _ = loss_fn(model(batch, istrain=True, rng=torch.Generator()), batch,
                      lambda_o=0.1, weight_mode="DYNAMIC")
    blk = plain.flatten(pool, torch.device("cpu"))
    want = plain.sgfn_loss(plain.sgfn_forward(ref, blk), blk, 0.1)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    # one update each: the program's AdamW against the written-out one
    state = create_train_state(model, make_optimizer(lr=1e-4, max_iteration=100))
    start = [p.detach().clone() for p in model.parameters()]
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    moved = float(torch.sqrt(sum(((p.detach() - b) ** 2).sum()
                                 for p, b in zip(model.parameters(), start))))
    params = list(ref.parameters())
    before = [p.detach().clone() for p in params]
    plain.AdamW(params, lr=1e-4, decay_steps=100).step(torch.autograd.grad(want, params))
    moved_ref = float(torch.sqrt(sum(((p.detach() - b) ** 2).sum()
                                     for p, b in zip(params, before))))
    np.testing.assert_allclose(moved, moved_ref, rtol=1e-2)


def test_reference_metrics_match_the_programs_suite():
    from vlsat_tpu_torch.eval.engine import evaluate

    cfg, (model, ref, _) = _built("vlsat_mmgnet.eval.val")
    from vlsat_tpu_torch.train.step import make_eval_step

    pool = scenes.make_scenes(scenes.label_specs("val_splits")[:6], 8)
    batch = _batch(pool, cfg)
    step = make_eval_step(model, device="cpu")
    got = evaluate(step, model.state_dict(), [batch], verbose=False)
    with torch.no_grad():
        blk = plain.flatten(pool, torch.device("cpu"))
        outs = [plain.mmgnet_dual(ref, plain.flatten([s], torch.device("cpu"))) for s in pool]
        want = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        parts = [{t: ref_metrics.scene_ranks(want[f"obj_logits_{t}"], want[f"rel_cls_{t}"],
                                             blk["gt_class"], blk["gt_rels"], blk["edge_index"])
                  for t in ("3d", "2d")}]
    for k, v in ref_metrics.metrics(parts).items():
        assert abs(got[k] - v) < 1e-4, k
