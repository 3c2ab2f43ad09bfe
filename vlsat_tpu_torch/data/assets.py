"""3DSSG dataset asset readers (a copy of ``vlsat_tpu/data/assets.py``).

Counterparts of the reference's scattered readers:
  * classes/relationships lists (utils/util.py:read_txt_to_list,
    read_relationships; src/dataset/dataset_3dssg.py:16-36);
  * scan-split selection + relationships_{split}.json;
  * the train-triplet vocabulary that get_zero_shot_recall builds from a
    hard-coded absolute path (src/utils/eva_utils_acc.py:249-283) — here a
    pure function over loaded data.

The relationship JSON schema: {"scans": [{"scan", "split", "objects":
{id: name}, "relationships": [[subj_id, obj_id, rel_idx, rel_name]]}]}.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set

# The 3RScanV2 scan whose semseg and ply segments mismatch — skipped by the
# reference with the v2 label file (dataset_3dssg.py:219-226).
CORRUPT_SCANS = ("fa79392f-7766-2d5c-869a-f5d6cfb62fc6",)


def read_txt_lines(path: str) -> List[str]:
    with open(path) as f:
        return [line.rstrip().lower() for line in f if line.strip() != ""]


def read_classes(root: str) -> List[str]:
    return read_txt_lines(os.path.join(root, "classes.txt"))


def read_relationships(root: str) -> List[str]:
    return read_txt_lines(os.path.join(root, "relationships.txt"))


def read_scan_split(root: str, split: str) -> List[str]:
    assert split in ("train_scans", "validation_scans"), split
    return read_txt_lines(os.path.join(root, f"{split}.txt"))


def load_relationship_json(root: str, split: str) -> dict:
    name = "relationships_train.json" if split == "train_scans" else "relationships_validation.json"
    with open(os.path.join(root, name)) as f:
        return json.load(f)


def load_semseg(json_file: str, name_mapping_dict: Dict[str, str] | None = None,
                mapping: bool = True) -> Dict[int, str]:
    """semseg.v2.json -> {instance id: label name} (utils/util.py:44-83),
    the reader feeding the offline relationship generators
    (``instance_names`` of the offline relationship generators).

    With ``name_mapping_dict``: ``mapping=True`` maps each raw label through
    the dict (missing keys become ``'none'``); ``mapping=False`` uses it as
    a filter instead — labels not among the dict's *values* become
    ``'none'``.  Names are lowercased after mapping, as the reference does.
    """
    with open(json_file) as f:
        data = json.load(f)
    instance2label: Dict[int, str] = {}
    for group in data["segGroups"]:
        label = group["label"]
        if name_mapping_dict is not None:
            if mapping:
                label = name_mapping_dict.get(label, "none")
            elif label not in name_mapping_dict.values():
                label = "none"
        instance2label[int(group["id"])] = label.lower()
    return instance2label


@dataclass
class SceneAnnotation:
    scan_id: str                     # "<scan>_<split>"
    scan: str
    objects: Dict[int, str]          # instance id -> class name
    relationships: List[list]        # [subj_id, obj_id, rel_idx, rel_name]


@dataclass
class DatasetIndex:
    class_names: List[str]
    relation_names: List[str]        # with 'none' dropped for multi-label
    scenes: List[SceneAnnotation] = field(default_factory=list)

    @property
    def scan_ids(self) -> List[str]:
        return [s.scan_id for s in self.scenes]


def build_index(
    root: str,
    split: str,
    data: dict | None = None,
    multi_rel: bool = True,
    label_file: str = "labels.instances.align.annotated.v2.ply",
) -> DatasetIndex:
    """Assemble the per-scan-split annotation index (reference
    read_relationship_json, dataset_3dssg.py:215-242)."""
    class_names = read_classes(root)
    relation_names = read_relationships(root)
    if multi_rel:
        relation_names = relation_names[1:]  # drop 'none'
    selected = set(read_scan_split(root, split))
    if data is None:
        data = load_relationship_json(root, split)

    idx = DatasetIndex(class_names=class_names, relation_names=relation_names)
    for scan_i in data["scans"]:
        if scan_i["scan"] in CORRUPT_SCANS and label_file.endswith("v2.ply"):
            continue
        if scan_i["scan"] not in selected:
            continue
        idx.scenes.append(
            SceneAnnotation(
                scan_id=f"{scan_i['scan']}_{scan_i['split']}",
                scan=scan_i["scan"],
                objects={int(k): v for k, v in scan_i["objects"].items()},
                relationships=[list(r) for r in scan_i["relationships"]],
            )
        )
    return idx


def build_triplet_vocab(
    data: dict, class_names: Sequence[str], relation_names: Sequence[str]
) -> Set[str]:
    """Train-set triplet keys "<sub_cls_idx> <obj_cls_idx> <rel_idx>" for the
    zero-shot split (eva_utils_acc.py:267-283)."""
    vocab: Set[str] = set()
    for scan in data["scans"]:
        objs = scan["objects"]
        for rel in scan["relationships"]:
            if str(rel[0]) not in objs or str(rel[1]) not in objs:
                continue
            key = (
                f"{class_names.index(objs[str(rel[0])])} "
                f"{class_names.index(objs[str(rel[1])])} "
                f"{relation_names.index(rel[-1])}"
            )
            vocab.add(key)
    return vocab
