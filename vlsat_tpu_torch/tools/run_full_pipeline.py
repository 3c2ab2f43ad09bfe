"""The offline pipeline end to end (the port's twin of
``tools/run_full_pipeline.py``):

    python -m vlsat_tpu_torch.tools.run_full_pipeline --root ROOT/3dssg \
        --scans-root ROOT/data/3RScan --multi-view-root ROOT --out out/ \
        --stages project,text,train,eval --encoder hash [--config cfg.json] [--device cpu]

Stages, each skippable, in this order (later stages read what earlier ones
wrote to disk):

1. ``project``: every scan of the train and validation splits that has an
   RGB sequence (``{scans_root}/{scan}/sequence/frames.json`` with each
   frame's ``color`` file and world->camera ``extrinsic``, the 3x4
   ``intrinsic``, ``width`` and ``height``) goes through
   ``projection.MultiViewFeatureExtractor`` into
   ``{scans_root}/{scan}/multi_view/`` (the projection on ``--device``);
2. ``text``: ``tools.build_text_tables`` into ``{out}/clip_assets``;
3. ``train``: ``Runner.train()`` and a closing validation;
4. ``eval``: the best checkpoint (a fresh model from ``SEED`` without one)
   through ``Runner.validation(save=True, with_scores=True)``.

The dataset reads the 2D features from
``{multi_view_root}/data/3RScan/{scan}/multi_view/`` while the project stage
writes them under ``{scans_root}/{scan}/multi_view/``: a run that reads its
own features lays the scans out under ``<ROOT>/data/3RScan/`` and passes
``--multi-view-root <ROOT>``.  The runner stages run on ``--device`` (the
card by default).  ``--encoder hash`` encodes each view as a seeded unit
vector (SHA-256 of its first 64 bytes) and the text with
``HashTextEncoder``; ``--encoder hf`` (the CLIP towers) is not ported yet
and raises.  After each stage one JSON line reports its wall seconds and
the kernel launches it made.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np


def hash_image_encoder(views) -> np.ndarray:
    """views (HxWx3 uint8) -> (n, 512) unit vectors, each seeded from the
    SHA-256 of the view's first 64 bytes."""
    out = np.zeros((len(views), 512), np.float32)
    for i, v in enumerate(views):
        seed = int.from_bytes(hashlib.sha256(v.tobytes()[:64]).digest()[:4], "little")
        x = np.random.RandomState(seed).randn(512).astype(np.float32)
        out[i] = x / np.linalg.norm(x)
    return out


def read_frame(path: str) -> np.ndarray:
    import imageio.v3 as iio  # the frame decoder, needed only here

    return iio.imread(path)


def stage_project(args, read=read_frame) -> int:
    """Project every scan that has frames; ``read`` decodes one colour
    frame file to an HxWx3 uint8 array.  Returns the scans processed."""
    from vlsat_tpu_torch.clipsem import HF_MISSING
    from vlsat_tpu_torch.data.assets import build_index
    from vlsat_tpu_torch.data.ply import read_ply_vertices
    from vlsat_tpu_torch.projection import MultiViewFeatureExtractor

    if args.encoder == "hf":
        raise NotImplementedError(HF_MISSING)
    ex = MultiViewFeatureExtractor(hash_image_encoder, device=args.device)
    done = 0
    for split in ("train_scans", "validation_scans"):
        try:
            idx = build_index(args.root, split)
        except FileNotFoundError:
            continue
        for ann in idx.scenes:
            scan_dir = os.path.join(args.scans_root, ann.scan)
            frames_meta = os.path.join(scan_dir, "sequence", "frames.json")
            if not os.path.exists(frames_meta):
                continue  # RGB sequence not extracted for this scan
            with open(frames_meta) as f:
                meta = json.load(f)
            images = [read(os.path.join(scan_dir, "sequence", fr["color"]))
                      for fr in meta["frames"]]
            extr = np.asarray([fr["extrinsic"] for fr in meta["frames"]], np.float32)
            intr = np.asarray(meta["intrinsic"], np.float32)
            ply = read_ply_vertices(os.path.join(scan_dir, args.label_file))
            ex.process_scene(
                ply.points, ply.instances, ann.objects, images, extr, intr,
                {}, meta["width"], meta["height"],
                save_dir=os.path.join(scan_dir, "multi_view"))
            done += 1
    print(f"[project] processed {done} scans")
    return done


def stage_text(args) -> None:
    from vlsat_tpu_torch.tools.build_text_tables import main as build_text_tables

    build_text_tables(["--root", args.root, "--out", os.path.join(args.out, "clip_assets"),
                       "--encoder", args.encoder, "--model", args.model])


def stage_run(args, mode: str) -> dict:
    """Train (then validate) or evaluate through the runner; returns the
    validation metrics."""
    from vlsat_tpu_torch.config import load_config
    from vlsat_tpu_torch.train.runner import Runner
    from vlsat_tpu_torch.utils.seeding import set_random_seed

    clip_dir = os.path.join(args.out, "clip_assets")
    obj_table = os.path.join(clip_dir, "obj_text_table.npy")
    trip_cache = os.path.join(clip_dir, "triplet_text_cache.npz")
    cfg = load_config(args.config, overrides={
        "MODE": mode, "EVAL": mode == "eval", "PATH": args.out,
        "MODEL": {
            "obj_text_table": obj_table if os.path.exists(obj_table) else None,
            "triplet_text_cache": trip_cache if os.path.exists(trip_cache) else None,
        },
        "dataset": {"root": args.root, "scans_root": args.scans_root,
                    "multi_view_root": args.multi_view_root,
                    "cache_root": os.path.join(args.out, "cache")},
    })
    set_random_seed(cfg.SEED)
    runner = Runner(cfg, device=args.device)
    try:
        if mode == "eval":
            runner.load(best=True)
            return runner.validation(save=True, with_scores=True)
        runner.load(best=False)
        runner.train()
        return runner.validation(save=True)
    finally:
        runner.close()


def _launches() -> dict:
    from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max

    return {"segment_max": segment_max.launches, "pointnet": pointnet_kernel.launches}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="assets/3dssg")
    p.add_argument("--scans-root", required=True)
    p.add_argument("--multi-view-root", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--label-file", default="labels.instances.align.annotated.v2.ply")
    p.add_argument("--encoder", choices=["hf", "hash"], default="hf")
    p.add_argument("--model", default="openai/clip-vit-base-patch32")
    p.add_argument("--stages", default="text,eval",
                   help="comma list from: project,text,train,eval")
    p.add_argument("--device", default="cuda",
                   help="torch device of the projection and the runner (default: the card; "
                        "'cpu' for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the chosen stages; returns each stage's result (scans projected,
    the train and eval stages' validation metrics)."""
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    stages = args.stages.split(",")
    steps = {"project": lambda: stage_project(args), "text": lambda: stage_text(args),
             "train": lambda: stage_run(args, "train"), "eval": lambda: stage_run(args, "eval")}
    results = {}
    for name, run in steps.items():
        if name not in stages:
            continue
        before, t0 = _launches(), time.perf_counter()
        results[name] = run()
        after = _launches()
        print(json.dumps({"stage": name, "wall_s": time.perf_counter() - t0,
                          "kernel_launches": {k: after[k] - before[k] for k in after}}),
              flush=True)
    return results


if __name__ == "__main__":
    main()
