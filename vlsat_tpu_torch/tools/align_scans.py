"""Align 3RScan rescans to their reference frames (the port's twin of
``tools/align_scans.py``; reference transform_ply.py):

    python -m vlsat_tpu_torch.tools.align_scans --scans-root /data/3RScan \
        --scan3r-json /data/3RScan.json --rescans rescans.txt --references refs.txt
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scans-root", required=True)
    p.add_argument("--scan3r-json", required=True)
    p.add_argument("--rescans", default=None, help="txt of rescan ids")
    p.add_argument("--references", default=None, help="txt of reference ids")
    p.add_argument("--raw-name", default="labels.instances.annotated.v2.ply")
    p.add_argument("--out-name", default="labels.instances.align.annotated.v2.ply")
    args = p.parse_args(argv)

    from vlsat_tpu_torch.data.assets import read_txt_lines
    from vlsat_tpu_torch.preprocess.transform import align_dataset, read_transform_matrices

    transforms = read_transform_matrices(args.scan3r_json)
    total = 0
    if args.rescans:
        total += align_dataset(args.scans_root, read_txt_lines(args.rescans),
                               transforms, args.raw_name, args.out_name)
    if args.references:
        total += align_dataset(args.scans_root, read_txt_lines(args.references),
                               {}, args.raw_name, args.out_name)
    print(f"aligned/copied {total} scans")
    return total


if __name__ == "__main__":
    main()
