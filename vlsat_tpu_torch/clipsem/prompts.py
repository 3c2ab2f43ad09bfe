"""Prompt templates (a copy of ``vlsat_tpu/clipsem/prompts.py``, which
imports no JAX): the reference's exact strings.

src/model/SGFN_MMG/model.py:209-210 (label weights) and :232,239
(per-edge triplet sentences).  They must stay byte-identical: the CLIP text
embeddings initialise the cosine classifiers, are the rel-mimic loss's
targets, and the sentences key ``TripletTextCache`` files that either
package writes.
"""


def object_prompt(class_name: str) -> str:
    return f"a photo of a {class_name}"


def relation_prompt(rel_name: str) -> str:
    return f"{rel_name}"


def triplet_prompt(sub_name: str, rel_name: str, obj_name: str) -> str:
    return f"a point cloud of a {sub_name} {rel_name} a {obj_name}"


def no_relation_prompt(sub_name: str, obj_name: str) -> str:
    return f"the {sub_name} and the {obj_name} has no relation in the point cloud"
