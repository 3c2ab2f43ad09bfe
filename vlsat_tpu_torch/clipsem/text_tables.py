"""Precomputed CLIP text-embedding tables (counterpart of
``vlsat_tpu/clipsem/text_tables.py``, which imports no JAX; the port keeps
its own copy).

The reference runs the CLIP text tower inside the train step for every
batch (get_rel_emb, SGFN_MMG/model.py:221-255).  The sentence vocabulary is
finite (the train triplets and the no-relation class pairs), so every
embedding is computed once, offline, into a ``TripletTextCache`` and the
train step reads an (E, 512) target like any other input.

Encoders: ``HashTextEncoder`` (deterministic stand-in embeddings seeded
from each sentence's hash, bit-equal to the JAX package's) or any callable
list[str] -> (n, d) array.  The CLIP text tower itself
(``HFCLIPTextEncoder`` in the JAX package) needs weights that are not in
the repository and is not ported.

The cache's ``.npz`` format is the JAX package's: a cache that either
package saves loads in the other.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Sequence

import numpy as np

from vlsat_tpu_torch.clipsem.prompts import (
    no_relation_prompt,
    object_prompt,
    relation_prompt,
    triplet_prompt,
)

TextEncoder = Callable[[List[str]], np.ndarray]


# The CLIP encoders (``--encoder hf``) wait for their files to be in the repository.
HF_MISSING = ("--encoder hf needs the `transformers` package and the CLIP ViT-B/32 weights "
              "(openai/clip-vit-base-patch32), which are not in the repository yet; "
              "use --encoder hash")


class HashTextEncoder:
    """Deterministic stand-in encoder: a unit-norm gaussian per sentence,
    seeded from the first 4 bytes of its SHA-256."""

    def __init__(self, dim: int = 512):
        self.dim = dim

    def __call__(self, sentences: List[str]) -> np.ndarray:
        out = np.zeros((len(sentences), self.dim), np.float32)
        for i, s in enumerate(sentences):
            seed = int.from_bytes(hashlib.sha256(s.encode()).digest()[:4], "little")
            v = np.random.RandomState(seed).randn(self.dim).astype(np.float32)
            out[i] = v / np.linalg.norm(v)
        return out


def build_label_tables(class_names: Sequence[str], relation_names: Sequence[str],
                       encoder: TextEncoder):
    """Normalised text tables for the cosine classifiers
    (SGFN_MMG/model.py:209-219): (objects, relations)."""
    obj = encoder([object_prompt(c) for c in class_names])
    rel = encoder([relation_prompt(r) for r in relation_names])
    obj = obj / np.linalg.norm(obj, axis=-1, keepdims=True)
    rel = rel / np.linalg.norm(rel, axis=-1, keepdims=True)
    return obj.astype(np.float32), rel.astype(np.float32)


class TripletTextCache:
    """Sentence -> raw text embedding cache and its per-edge lookup.

    An edge's target is the mean of its GT predicates' sentence embeddings
    (raw, normalised after the mean: the reference's order, model.py:
    247-253), or the no-relation sentence's for an edge without GT."""

    def __init__(self, class_names: Sequence[str], relation_names: Sequence[str],
                 dim: int = 512):
        self.class_names = list(class_names)
        self.relation_names = list(relation_names)
        self.dim = dim
        self._cache: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------ building
    def sentences_for_index(self, scenes) -> List[str]:
        """Every sentence a ``DatasetIndex``'s scenes (its ``.scenes``) need."""
        needed = set()
        for ann in scenes:
            names = ann.objects
            ids = list(names)
            for r in ann.relationships:
                if r[0] in names and r[1] in names:
                    needed.add(triplet_prompt(names[r[0]], r[3], names[r[1]]))
            for a in ids:
                for b in ids:
                    if a != b:
                        needed.add(no_relation_prompt(names[a], names[b]))
        return sorted(needed)

    def build(self, sentences: List[str], encoder: TextEncoder) -> None:
        missing = [s for s in sentences if s not in self._cache]
        if missing:
            emb = encoder(missing)
            for s, e in zip(missing, emb):
                self._cache[s] = e.astype(np.float32)

    def save(self, path: str) -> None:
        keys = list(self._cache)
        np.savez_compressed(path, sentences=np.asarray(keys, dtype=object),
                            embeddings=np.stack([self._cache[k] for k in keys])
                            if keys else np.zeros((0, self.dim), np.float32))

    @classmethod
    def load(cls, path: str, class_names, relation_names) -> "TripletTextCache":
        # the sentences are an object array: the file must come from save()
        with np.load(path, allow_pickle=True) as z:
            sentences, embeddings = z["sentences"], z["embeddings"]
        cache = cls(class_names, relation_names,
                    dim=embeddings.shape[-1] if len(embeddings) else 512)
        for s, e in zip(sentences, embeddings):
            cache._cache[str(s)] = e.astype(np.float32)
        return cache

    # ------------------------------------------------------------- lookup
    def __call__(self, gt_class: np.ndarray, gt_rels: np.ndarray,
                 edge_index: np.ndarray) -> np.ndarray:
        """(N,), (E, R), (E, 2) -> (E, dim) normalised targets."""
        out = np.zeros((len(edge_index), self.dim), np.float32)
        for e in range(len(edge_index)):
            sub = self.class_names[gt_class[edge_index[e, 0]]]
            obj = self.class_names[gt_class[edge_index[e, 1]]]
            rels = np.nonzero(gt_rels[e])[0]
            if len(rels) == 0:
                vecs = [self._lookup(no_relation_prompt(sub, obj))]
            else:
                vecs = [self._lookup(triplet_prompt(sub, self.relation_names[r], obj))
                        for r in rels]
            v = np.mean(vecs, axis=0)
            out[e] = v / max(np.linalg.norm(v), 1e-12)
        return out

    def _lookup(self, sentence: str) -> np.ndarray:
        if sentence not in self._cache:
            raise KeyError(f"sentence not in triplet text cache: {sentence!r} — "
                           "rebuild the cache over the training index")
        return self._cache[sentence]
