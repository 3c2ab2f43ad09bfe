"""Build the packed per-bucket tensor cache of a config's dataset (the
port's twin of ``tools/pack_dataset.py``; its packs are the JAX tool's,
byte for byte):

    python -m vlsat_tpu_torch.tools.pack_dataset --config cfg.json
        [--splits train validation] [--out PACKED_ROOT] [--variants 4] [--workers 4]

Writes ``{out}/train`` and ``{out}/validation`` (``data/packed.py``); point
``dataset.packed_root`` at ``out`` and the runner reads memory-mapped slices
instead of preparing and padding each scene.  ``--variants k`` packs k
independent point-sampling draws of the train split (the loader cycles one
per epoch).  ``--workers n`` prepares scenes in n spawned processes, with
per-scene seeds, so the output does not depend on n.  With
``MODEL.triplet_text_cache`` (multi-label), the train split carries the
rel-mimic text targets.  For a model that reads the per-edge union point
clouds (``SGPN``: ``models.registry.needs_union_points``) both splits carry
them, as the runner builds them (the JAX tool packs them only under
``dataset.with_union_points``).
"""

from __future__ import annotations

import argparse
import os
from functools import partial


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--splits", nargs="+", default=["train", "validation"],
                    choices=["train", "validation"])
    ap.add_argument("--out", type=str, default=None,
                    help="default: dataset.packed_root from the config")
    ap.add_argument("--variants", type=int, default=1)
    ap.add_argument("--workers", type=int, default=0,
                    help="parallel prepare workers (0 = serial; parallel packs use "
                         "order-independent per-scene seeding)")
    args = ap.parse_args(argv)

    from vlsat_tpu_torch.config import load_config
    from vlsat_tpu_torch.data.dataset import SSGScenes
    from vlsat_tpu_torch.data.packed import build_scenes, pack_scenes
    from vlsat_tpu_torch.models.registry import needs_union_points

    cfg = load_config(args.config)
    d = cfg.dataset
    out = args.out or d.get("packed_root")
    if not out:
        ap.error("--out or dataset.packed_root required")

    text_lookup = None
    if cfg.MODEL.get("triplet_text_cache") and cfg.MODEL.multi_rel_outputs:
        from vlsat_tpu_torch.clipsem import TripletTextCache
        from vlsat_tpu_torch.data.assets import read_classes, read_relationships

        text_lookup = TripletTextCache.load(cfg.MODEL.triplet_text_cache,
                                            read_classes(d.root),
                                            read_relationships(d.root)[1:])

    for split in args.splits:
        is_train = split == "train"
        kwargs = dict(
            root=d.root, scans_root=d.scans_root, split=f"{split}_scans",
            label_file=d.label_file, num_points=d.num_points,
            num_points_union=d.num_points_union,
            # as the runner builds them
            with_union_points=d.with_union_points or needs_union_points(cfg.NAME),
            multi_view_root=d.multi_view_root, cache_root=d.cache_root,
            feat_dim=cfg.MODEL.clip_feat_dim, multi_rel=cfg.MODEL.multi_rel_outputs,
            triplet_text_lookup=text_lookup if is_train else None,
            use_rgb=cfg.MODEL.get("USE_RGB", False),
            use_normal=cfg.MODEL.get("USE_NORMAL", False),
        )
        ds = SSGScenes(**kwargs)
        dest = os.path.join(out, split)
        print(f"packing {split}: {len(ds)} scenes -> {dest}")
        manifest = pack_scenes(
            ds, dest, buckets=tuple(d.node_buckets), seed=cfg.SEED,
            variants=args.variants if is_train else 1,
            drop_relation_free=is_train, workers=args.workers,
            scenes_factory=partial(build_scenes, kwargs) if args.workers else None)
        counts = {b: m["count"] for b, m in manifest["buckets"].items()}
        print(f"  bucket counts: {counts}")


if __name__ == "__main__":
    main()
