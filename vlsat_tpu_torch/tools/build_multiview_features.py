"""Rebuild per-instance multi-view CLIP features from saved view images (the
port's twin of ``tools/build_multiview_features.py``; reference
clip_adapter/data/get_data_list.py + get_data_feat.py):

    python -m vlsat_tpu_torch.tools.build_multiview_features --scans-root /data/3RScan \
        --scan-list assets/3dssg/train_scans.txt --out-list train_scans_all_quanlity.txt \
        --encoder hash

Walks each scan's ``multi_view`` directory of saved view JPGs
(instance_{id}_class_{name}_[croped_]view{k}_..._{tier}.jpg, written by the
projection front-end), encodes the views, saves the mean of the
L2-normalised features per instance (``croped`` / ``origin`` variants) and
writes the ``*_all_quanlity.txt`` listing the adapter trainer reads.
``--encoder hash`` gives each view a seeded unit vector from the SHA-256 of
its path (no CLIP weights needed); ``--encoder hf`` (a CLIP vision tower)
is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np

_VIEW = re.compile(
    r"instance_(?P<iid>[^_]+)_class_(?P<name>.+?)_(?P<kind>croped_view|view)"
    r"(?P<idx>\d+).*_(?P<tier>[ABC])\.jpg$")


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scans-root", required=True)
    p.add_argument("--scan-list", required=True)
    p.add_argument("--out-list", required=True)
    p.add_argument("--encoder", choices=["hf", "hash"], default="hf")
    p.add_argument("--model", default="openai/clip-vit-base-patch32")
    p.add_argument("--dim", type=int, default=512)
    args = p.parse_args(argv)

    from vlsat_tpu_torch.clipsem import HF_MISSING, HashTextEncoder
    from vlsat_tpu_torch.data.assets import read_txt_lines

    if args.encoder == "hf":
        raise NotImplementedError(HF_MISSING)
    encode = HashTextEncoder(args.dim)  # one seeded unit vector a view path
    lines = []
    for scan in read_txt_lines(args.scan_list):
        mv = os.path.join(args.scans_root, scan, "multi_view")
        if not os.path.isdir(mv):
            continue
        groups = {}
        for fn in sorted(os.listdir(mv)):
            m = _VIEW.match(fn)
            if not m:
                continue
            key = (m["iid"], m["name"])
            mode = "croped" if m["kind"].startswith("croped") else "origin"
            groups.setdefault(key, {}).setdefault(mode, []).append(
                (os.path.join(mv, fn), m["tier"]))
        for (iid, name), modes in groups.items():
            tier = min(t for views in modes.values() for _, t in views)
            for mode, views in modes.items():
                feats = encode([p for p, _ in views])
                feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
                np.save(os.path.join(
                    mv, f"instance_{iid}_class_{name}_{mode}_view_mean.npy"),
                    feats.mean(0))
            lines.append(
                f"Scene: {scan} Instance: {iid} Label: {name} Quanlity: {tier}")
        print(f"{scan}: {len(groups)} instances")

    with open(args.out_list, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out_list} ({len(lines)} entries)")
    return lines


if __name__ == "__main__":
    main()
