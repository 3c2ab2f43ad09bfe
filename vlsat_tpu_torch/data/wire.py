"""Wire format for host->device SceneBatch transport.

Counterpart of ``vlsat_tpu/data/wire.py:49-101``.  ``encode_wire`` narrows
the bulky float fields of a host batch to f16 (or bf16) and the multi-hot
``gt_rels`` to uint8 before the copy to the card; ``decode_wire`` widens them
back to f32 on the device.  ``VLSAT_WIRE_DTYPE=float32`` keeps the batch
bit-exact.
"""

from __future__ import annotations

import os

import torch

from vlsat_tpu_torch.scene import SceneBatch

# fields narrowed to the wire float type; the descriptor stays f32 (its
# volume/length channels have a wide dynamic range)
_CAST_FIELDS = ("obj_points", "obj_2d_feats", "rel_text_feat", "rel_points")
_WIRE_TYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def wire_dtype(default: str = "float16") -> str:
    """VLSAT_WIRE_DTYPE in {float16, bfloat16, float32}; float32 = bit-exact."""
    return os.environ.get("VLSAT_WIRE_DTYPE", default)


def encode_wire(batch: SceneBatch, dtype: str | None = None) -> SceneBatch:
    """Narrow a host batch for transport; float32 (or an unknown name)
    returns it unchanged."""
    wdt = _WIRE_TYPES.get(dtype or wire_dtype())
    if wdt is None:
        return batch
    kw = {}
    for f in _CAST_FIELDS:
        v = getattr(batch, f)
        if v is not None and v.dtype == torch.float32:
            kw[f] = v.to(wdt)
    gr = batch.gt_rels
    if gr.dtype == torch.float32:
        # lossless only for integral labels in 0..255; soft labels stay f32
        if gr.numel() == 0 or (torch.all(gr == torch.floor(gr)) and gr.min() >= 0
                               and gr.max() <= 255):
            kw["gt_rels"] = gr.to(torch.uint8)
    return batch.replace(**kw) if kw else batch


def decode_wire(batch: SceneBatch) -> SceneBatch:
    """Widen wire fields back to float32 (identity on an f32 batch)."""
    kw = {}
    for f in _CAST_FIELDS:
        v = getattr(batch, f)
        if v is not None and v.dtype in (torch.float16, torch.bfloat16):
            kw[f] = v.float()
    if batch.gt_rels is not None and batch.gt_rels.dtype == torch.uint8:
        kw["gt_rels"] = batch.gt_rels.float()
    return batch.replace(**kw) if kw else batch


def wire_nbytes(batch: SceneBatch, dtype: str | None = None) -> int:
    """Bytes a host batch takes on the wire under ``dtype`` (default
    ``VLSAT_WIRE_DTYPE``), without casting: f16/bf16 halve the f32
    ``_CAST_FIELDS`` and quarter an f32 ``gt_rels``."""
    narrow = (dtype or wire_dtype()) in _WIRE_TYPES
    total = 0
    for name, v in vars(batch).items():
        if v is None:
            continue
        n = v.numel() * v.element_size()
        if narrow and v.dtype == torch.float32:
            if name in _CAST_FIELDS:
                n //= 2
            elif name == "gt_rels":
                n //= 4
        total += n
    return int(total)
