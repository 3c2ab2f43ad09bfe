"""Full-scale cold start: pack build and the first epochs at 3RScan scale
(the port's twin of ``tools/bench_cold_start.py``):

    python -m vlsat_tpu_torch.tools.bench_cold_start [--num-scans 1177]
        [--verts-per-inst 20000] [--background-verts 30000] [--workers 0]
        [--batch-size 8] [--base DIR] [--out JSON] [--keep] [--skip-stream-epochs]

Synthesizes a train split at full 3RScan scale (1,177 scans by default, each
a real binary PLY at realistic vertex counts, node and relation counts of
the 3DSSG scan-split histogram) and measures every phase a user pays
between a fresh checkout with the raw dataset and training steps flowing:

1. ``synth_s``: fabricating the dataset (not a cold-start cost);
2. ``index_s``: ``SSGScenes`` construction (JSON index and class weights);
3. ``pack_build_s``: the pack tool's path (PLY parse, point sampling,
   descriptors, bucket pack; ``--workers N`` fans it over spawned
   processes);
4. ``epoch0_stream_s``: one epoch through ``SceneLoader`` with a cold npz
   cache (PLY parse included);
5. ``epoch_warm_stream_s``: the same epoch warm;
6. ``epoch_packed_s``: one epoch through ``PackedLoader`` (mmap slices);

plus ``pack_bytes`` on disk and ``amortize_epochs`` = pack_build_s /
(epoch_warm_stream_s - epoch_packed_s).  Host only: these are the input
pipeline's costs, and nothing runs on a device.  ``--base`` defaults to
``vlsat_torch_coldstart`` in the temporary directory (``TMPDIR``, else
``/tmp``).  ``main(argv)`` returns the result it prints.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from functools import partial

import numpy as np


def dir_bytes(path: str) -> int:
    total = 0
    for dirpath, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(dirpath, f))
    return total


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-scans", type=int, default=1177)
    ap.add_argument("--verts-per-inst", type=int, default=20000)
    ap.add_argument("--background-verts", type=int, default=30000)
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--base", type=str,
                    default=os.path.join(tempfile.gettempdir(), "vlsat_torch_coldstart"))
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--keep", action="store_true",
                    help="keep the synthesized dataset + pack on exit")
    ap.add_argument("--skip-stream-epochs", action="store_true",
                    help="only measure pack build + packed epoch")
    args = ap.parse_args(argv)

    from vlsat_tpu_torch.data.dataset import SceneLoader, SSGScenes
    from vlsat_tpu_torch.data.packed import (PackedLoader, PackedScenes, build_scenes,
                                             pack_scenes)
    from vlsat_tpu_torch.data.synthetic import make_synthetic_split

    res = {"num_scans": args.num_scans, "verts_per_inst": args.verts_per_inst,
           "background_verts": args.background_verts, "workers": args.workers}

    # 1. the raw dataset (PLYs, no npz cache), the scan-split histogram
    rng = np.random.RandomState(7)
    node_counts = rng.randint(5, 10, args.num_scans)
    rel_counts = np.clip(rng.poisson(17, args.num_scans), 1, 46)
    t0 = time.perf_counter()
    root, scans_root, _ = make_synthetic_split(
        args.base, num_scans=args.num_scans, vertices_per_inst=args.verts_per_inst,
        background_verts=args.background_verts, node_counts=node_counts,
        rel_counts=rel_counts, seed=11, write_ply=True)
    res["synth_s"] = round(time.perf_counter() - t0, 1)
    res["dataset_bytes"] = dir_bytes(scans_root)
    print(f"synth: {res['synth_s']}s, {res['dataset_bytes'] / 1e9:.2f} GB of PLYs", flush=True)

    def fresh_cache(tag):
        d = os.path.join(args.base, f"cache_{tag}")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        return d

    kwargs = dict(root=root, scans_root=scans_root, split="train_scans", num_points=128,
                  feat_dim=512, multi_rel=True, cache_root=fresh_cache("pack"))

    # 2.-3. index and cold pack build
    t0 = time.perf_counter()
    ds = SSGScenes(**kwargs)
    res["index_s"] = round(time.perf_counter() - t0, 2)
    pack_dir = os.path.join(args.base, "packed")
    shutil.rmtree(pack_dir, ignore_errors=True)
    t0 = time.perf_counter()
    pack_scenes(ds, pack_dir, seed=2020, drop_relation_free=True, workers=args.workers,
                scenes_factory=partial(build_scenes, kwargs) if args.workers else None)
    pack_t = max(time.perf_counter() - t0, 1e-9)  # rates take the unrounded time
    res["pack_build_s"] = round(pack_t, 1)
    res["pack_scenes_per_sec"] = round(args.num_scans / pack_t, 1)
    res["pack_bytes"] = dir_bytes(pack_dir)
    print(f"pack build: {res['pack_build_s']}s ({res['pack_scenes_per_sec']} scenes/s, "
          f"workers={args.workers}), pack {res['pack_bytes'] / 1e6:.0f} MB", flush=True)

    # 4.-5. streamed epochs, cold npz cache then warm
    if not args.skip_stream_epochs:
        ds_stream = SSGScenes(**{**kwargs, "cache_root": fresh_cache("st")})
        loader = SceneLoader(ds_stream, batch_size=args.batch_size, shuffle=True, seed=0,
                             for_train=True)
        for tag in ("epoch0_stream_s", "epoch_warm_stream_s"):
            t0 = time.perf_counter()
            nb = sum(1 for _ in loader)
            ep_t = max(time.perf_counter() - t0, 1e-9)
            res[tag] = round(ep_t, 1)
            res[tag[:-2] + "_scenes_per_sec"] = round(args.num_scans / ep_t, 1)
            print(f"{tag}: {res[tag]}s ({nb} batches)", flush=True)

    # 6. the packed epoch
    ploader = PackedLoader(PackedScenes(pack_dir), batch_size=args.batch_size, shuffle=True,
                           seed=0)
    sum(1 for _ in ploader)  # prime the mmaps and the page cache
    t0 = time.perf_counter()
    nb = sum(1 for _ in ploader)
    packed_t = max(time.perf_counter() - t0, 1e-9)
    res["epoch_packed_s"] = round(packed_t, 2)
    res["epoch_packed_scenes_per_sec"] = round(args.num_scans / packed_t, 1)
    print(f"packed epoch: {res['epoch_packed_s']}s ({nb} batches)", flush=True)

    if "epoch_warm_stream_s" in res:
        saved = res["epoch_warm_stream_s"] - res["epoch_packed_s"]
        res["amortize_epochs"] = round(res["pack_build_s"] / saved, 2) if saved > 0 else None

    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    if not args.keep:
        shutil.rmtree(args.base, ignore_errors=True)
    return res


if __name__ == "__main__":
    main()
