"""Checkpoint-parity runbook (the port's twin of ``tools/parity_eval.py``):
reference checkpoint -> the port's evaluation -> a ±0.5-point table.

Given the released VL-SAT experiment directory (one ``<module>.pth`` per
child module, the reference BaseModel.save layout, model_base.py:47-73) and
a 3RScan/3DSSG dataset root, this tool imports every submodule into the
port's ``MMGNet`` (``interop/torch_import.py``), runs the full validation
metric suite with the dual-branch eval step (``eval/engine.py``), and
prints a metric-by-metric comparison against the reference's published
``result.txt`` (the line labels of src/model/model.py:290-321) with the
±0.5-point accuracy-parity verdict.

Usage:
  python -m vlsat_tpu_torch.tools.parity_eval --ckpt-dir <dir with *.pth> \
      --root <3DSSG root> --scans <3RScan scans root> \
      [--multi-view-root <dir>] [--reference <result.txt>] \
      [--eval-batch-size 8] [--num-points 128] [--tolerance 0.5] \
      [--out-json parity.json] [--device cpu]

Exit code is 1 when a reference file is given and any finite metric differs
by more than the tolerance.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import re
from typing import Dict, Optional, Tuple

# reference result.txt line label -> the eval/engine.py metrics key
REF_LABEL_TO_KEY = {
    "3d obj Acc@1": "obj_acc_1",
    "2d obj Acc@1": "obj_acc_2d_1",
    "3d obj Acc@5": "obj_acc_5",
    "2d obj Acc@5": "obj_acc_2d_5",
    "3d obj Acc@10": "obj_acc_10",
    "2d obj Acc@10": "obj_acc_2d_10",
    "3d rel Acc@1": "rel_acc_1",
    "3d mean rel Acc@1": "rel_acc_mean_1",
    "2d rel Acc@1": "rel_acc_2d_1",
    "2d mean rel Acc@1": "rel_acc_2d_mean_1",
    "3d rel Acc@3": "rel_acc_3",
    "3d mean rel Acc@3": "rel_acc_mean_3",
    "2d rel Acc@3": "rel_acc_2d_3",
    "2d mean rel Acc@3": "rel_acc_2d_mean_3",
    "3d rel Acc@5": "rel_acc_5",
    "3d mean rel Acc@5": "rel_acc_mean_5",
    "2d rel Acc@5": "rel_acc_2d_5",
    "2d mean rel Acc@5": "rel_acc_2d_mean_5",
    "3d triplet Acc@50": "triplet_acc_50",
    "2d triplet Acc@50": "triplet_acc_2d_50",
    "3d triplet Acc@100": "triplet_acc_100",
    "2d triplet Acc@100": "triplet_acc_2d_100",
    "3d mean recall@50": "mean_recall_50",
    "2d mean recall@50": "mean_recall_2d_50",
    "3d mean recall@100": "mean_recall_100",
    "2d mean recall@100": "mean_recall_2d_100",
    "3d zero-shot recall@50": "zero_shot_50",
    "3d zero-shot recall@100": "zero_shot_100",
    "3d non-zero-shot recall@50": "non_zero_shot_50",
    "3d non-zero-shot recall@100": "non_zero_shot_100",
    "3d all-zero-shot recall@50": "all_50",
    "3d all-zero-shot recall@100": "all_100",
}


def parse_reference_result(path: str) -> Dict[str, float]:
    """Parse a reference result.txt ('Eval: <label> : <value>' lines)."""
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"\s*Eval:\s*(.+?)\s*:\s*([-+0-9.eEnafNA]+)\s*$", line)
            if not m:
                continue
            label = re.sub(r"\s+", " ", m.group(1)).strip()
            key = REF_LABEL_TO_KEY.get(label)
            if key is None:
                continue
            try:
                out[key] = float(m.group(2))
            except ValueError:
                pass
    return out


def run_parity_eval(
    ckpt_dir: str,
    root: str,
    scans_root: str,
    multi_view_root: Optional[str] = None,
    cache_root: Optional[str] = None,
    reference: Optional[str] = None,
    eval_batch_size: int = 8,
    num_points: int = 128,
    tolerance: float = 0.5,
    depth: int = 2,
    out_json: Optional[str] = None,
    verbose: bool = True,
    device=None,
) -> Tuple[Dict[str, float], bool]:
    """Returns (metrics, within_tolerance); evaluates on ``device`` (the
    card unless the caller passes ``device="cpu"``)."""
    from vlsat_tpu_torch.data.assets import build_triplet_vocab, load_relationship_json
    from vlsat_tpu_torch.data.dataset import SceneLoader, SSGScenes
    from vlsat_tpu_torch.device import resolve_device
    from vlsat_tpu_torch.eval.engine import evaluate
    from vlsat_tpu_torch.interop.torch_import import state_dict_from_directory
    from vlsat_tpu_torch.models.mmgnet import MMGNetConfig, build_mmgnet
    from vlsat_tpu_torch.train.step import make_eval_step

    dev = resolve_device(device)
    scenes = SSGScenes(
        split="validation_scans", root=root, scans_root=scans_root,
        num_points=num_points, multi_view_root=multi_view_root,
        cache_root=cache_root,
    )
    num_obj = len(scenes.class_names)
    num_rel = len(scenes.relation_names)
    model = build_mmgnet(MMGNetConfig(
        num_obj_classes=num_obj, num_rel_classes=num_rel, depth=depth), dev)
    model.load_state_dict(state_dict_from_directory(ckpt_dir, model, depth=depth))

    vocab = None
    try:
        data = load_relationship_json(root, "train_scans")
        vocab = build_triplet_vocab(data, scenes.class_names, scenes.relation_names)
    except FileNotFoundError:
        pass

    loader = SceneLoader(scenes, batch_size=eval_batch_size, shuffle=False)
    metrics = evaluate(
        make_eval_step(model, device=dev), model.state_dict(), loader,
        num_rel_classes=num_rel, train_triplet_vocab=vocab, total=len(scenes),
        verbose=verbose,
    )

    ref = parse_reference_result(reference) if reference else {}
    ok = True
    lines = [f"{'metric':<28}{'ours':>10}{'reference':>12}{'delta':>9}  verdict"]
    for key in sorted(metrics):
        ours = metrics[key]
        if key in ref and math.isfinite(ref[key]) and math.isfinite(ours):
            delta = ours - ref[key]
            good = abs(delta) <= tolerance
            ok &= good
            lines.append(f"{key:<28}{ours:>10.2f}{ref[key]:>12.2f}{delta:>+9.2f}  "
                         f"{'ok' if good else 'FAIL'}")
        else:
            lines.append(f"{key:<28}{ours:>10.2f}{'-':>12}{'-':>9}  -")
    report = "\n".join(lines)
    if verbose:
        print(report)
        if reference:
            print(f"\nparity within ±{tolerance} pts: {'YES' if ok else 'NO'}")
    if out_json:
        with open(out_json, "w") as f:
            json.dump({"metrics": metrics, "reference": ref,
                       "tolerance": tolerance, "ok": ok}, f, indent=2)
    return metrics, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--root", required=True, help="3DSSG root (relationship jsons)")
    ap.add_argument("--scans", required=True, help="3RScan scans root (ply files)")
    ap.add_argument("--multi-view-root", default=None)
    ap.add_argument("--cache-root", default=None)
    ap.add_argument("--reference", default=None, help="reference result.txt")
    ap.add_argument("--eval-batch-size", type=int, default=8)
    ap.add_argument("--num-points", type=int, default=128)
    ap.add_argument("--tolerance", type=float, default=0.5)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card by default; cpu for smoke tests)")
    args = ap.parse_args(argv)
    _, ok = run_parity_eval(
        ckpt_dir=args.ckpt_dir, root=args.root, scans_root=args.scans,
        multi_view_root=args.multi_view_root, cache_root=args.cache_root,
        reference=args.reference, eval_batch_size=args.eval_batch_size,
        num_points=args.num_points, tolerance=args.tolerance,
        depth=args.depth, out_json=args.out_json, device=args.device,
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
