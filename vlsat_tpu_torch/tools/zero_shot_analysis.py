"""Zero-shot triplet recall over saved eval artifacts (the port's twin of
``tools/zero_shot_analysis.py``; reference data/get_zero_shot_val.py):

    python -m vlsat_tpu_torch.tools.zero_shot_analysis --results out/results/Mmgnet/default \
        --root assets/3dssg

Loads ``topk_triplet_list.npy`` and ``cls_matrix_list.npy`` (written by an
evaluation with scores, e.g. ``main --mode eval``) and splits recall@50/100
into zero-shot and seen triplets by the train split's vocabulary.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--results", required=True)
    p.add_argument("--root", default="assets/3dssg")
    args = p.parse_args(argv)

    import numpy as np

    from vlsat_tpu_torch.data.assets import (build_triplet_vocab, load_relationship_json,
                                             read_classes, read_relationships)
    from vlsat_tpu_torch.eval.metrics import get_zero_shot_recall

    ranks = np.load(os.path.join(args.results, "topk_triplet_list.npy"))
    cls_matrix = np.load(os.path.join(args.results, "cls_matrix_list.npy"))
    classes = read_classes(args.root)
    relations = read_relationships(args.root)[1:]
    vocab = build_triplet_vocab(load_relationship_json(args.root, "train_scans"),
                                classes, relations)
    out = get_zero_shot_recall(ranks, cls_matrix, vocab)
    for k, v in out.items():
        print(f"{k}: {v:.2f}")
    return out


if __name__ == "__main__":
    main()
