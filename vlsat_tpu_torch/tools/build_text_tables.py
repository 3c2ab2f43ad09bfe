"""Build the CLIP text-embedding assets the framework reads (the port's twin
of ``tools/build_text_tables.py``):

    python -m vlsat_tpu_torch.tools.build_text_tables --root assets/3dssg \
        --out clip_assets/ --encoder hash

Writes ``obj_text_table.npy`` / ``rel_text_table.npy`` (normalised
class-prompt embeddings that initialise the cosine classifiers) and
``triplet_text_cache.npz`` (every GT-triplet and no-relation sentence
embedding, for the rel-mimic loss), in the JAX package's formats.
``--encoder hash`` is the deterministic stand-in (``HashTextEncoder``);
``--encoder hf`` (the CLIP text tower) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="assets/3dssg")
    p.add_argument("--out", required=True)
    p.add_argument("--encoder", choices=["hf", "hash"], default="hf")
    p.add_argument("--model", default="openai/clip-vit-base-patch32")
    p.add_argument("--dim", type=int, default=512)
    args = p.parse_args(argv)

    import numpy as np

    from vlsat_tpu_torch.clipsem import (HF_MISSING, HashTextEncoder, TripletTextCache,
                                         build_label_tables)
    from vlsat_tpu_torch.data.assets import build_index, read_classes, read_txt_lines

    if args.encoder == "hf":
        raise NotImplementedError(HF_MISSING)
    enc = HashTextEncoder(args.dim)

    classes = read_classes(args.root)
    relations = read_txt_lines(os.path.join(args.root, "relations.txt"))
    os.makedirs(args.out, exist_ok=True)
    obj_t, rel_t = build_label_tables(classes, relations, enc)
    np.save(os.path.join(args.out, "obj_text_table.npy"), obj_t)
    np.save(os.path.join(args.out, "rel_text_table.npy"), rel_t)
    print(f"label tables: {obj_t.shape}, {rel_t.shape}")

    cache = TripletTextCache(classes, relations, dim=obj_t.shape[-1])
    for split in ("train_scans", "validation_scans"):
        try:
            idx = build_index(args.root, split)
        except FileNotFoundError:
            print(f"skip {split}: relationships json missing")
            continue
        sentences = cache.sentences_for_index(idx.scenes)
        print(f"{split}: {len(sentences)} sentences")
        cache.build(sentences, enc)
    cache.save(os.path.join(args.out, "triplet_text_cache.npz"))
    print("done")


if __name__ == "__main__":
    main()
