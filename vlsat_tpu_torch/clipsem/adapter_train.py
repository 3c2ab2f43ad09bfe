"""CLIP-adapter training (counterpart of ``vlsat_tpu/clipsem/adapter_train.py``;
reference clip_adapter/main.py + dataset.py).

Trains the residual ``AdapterModel`` on per-instance multi-view CLIP
features against instance class labels with label-smoothed cross-entropy
(eps 0.2), plain SGD (lr 1e-2, L2 weight decay 5e-4 added to the gradient,
no momentum) on a cosine schedule over all steps, keeping the best
validation top-1 -- the checkpoint that ships frozen inside the flagship
model.  The objective is cosine classification against CLIP text class
weights, as clip_adapter/test.py intends (the shipped reference trainer
passes kwargs ``AdapterModel`` does not accept, main.py:39, and treats raw
adapter features as logits).

The steps run on the device (the card unless the caller asks for the
CPU).  Weights come in and go out in the JAX package's layout (a nested
dict ``{"fc1": {"kernel", "bias"}, "fc2": ...}`` of numpy arrays), so both
packages can start from, and compare, the same weights.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vlsat_tpu_torch.device import resolve_device
from vlsat_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from vlsat_tpu_torch.models.layers import AdapterModel
from vlsat_tpu_torch.models.mmgnet import init_parameters

_LINE = re.compile(
    r"Scene:\s*(?P<scene>\S+)\s+Instance:\s*(?P<instance>\S+)\s+"
    r"Label:\s*(?P<label>.+?)\s+Quanlity:\s*(?P<quality>\S+)")


@dataclass
class MultiViewRecord:
    scene: str
    instance: str
    label: str
    quality: str

    def feature_path(self, root: str, mode: str = "origin_view_mean") -> str:
        return (f"{root}/{self.scene}/multi_view/"
                f"instance_{self.instance}_class_{self.label}_{mode}.npy")


def parse_quality_list(path: str) -> List[MultiViewRecord]:
    """Parse the reference's ``*_all_quanlity.txt`` listing
    (clip_adapter/dataset.py:26-39)."""
    out = []
    with open(path) as f:
        for line in f:
            m = _LINE.search(line)
            if m:
                out.append(MultiViewRecord(**m.groupdict()))
    return out


_PC_ANGLES = (0, 30, -30, 60, -60)


@dataclass
class MultiViewPCRecord:
    """One sample of the 5-angle rendered-point-cloud adapter dataset
    (reference ``MultiViewPCDataset``, clip_adapter/dataset.py:46-97):
    five view images of one instance + its class-label index."""

    paths: Tuple[str, ...]
    label: int


def parse_pc_data_list(data_list_path: str, labels: Sequence[str],
                       root_path: str = "") -> List[MultiViewPCRecord]:
    """Parse the quality-list file into 5-angle rendered-image records
    (clip_adapter/dataset.py:70-90): per line, image paths
    ``{root}/{scene}/multi_view_pc/{instance}_{label}_{angle}.jpg`` for
    angles (0, 30, -30, 60, -60), label resolved against ``labels``."""
    records: List[MultiViewPCRecord] = []
    with open(data_list_path) as f:
        for line in f:
            if not line.strip():
                continue
            items = line.strip().split(":")
            scene_id = items[1].split(" ")[0]
            instance_id = items[2].split(" ")[0]
            label_name = " ".join(items[3].split(" ")[0:-1])
            paths = tuple(
                f"{root_path}/{scene_id}/multi_view_pc/"
                f"{instance_id}_{label_name}_{angle}.jpg"
                for angle in _PC_ANGLES)
            records.append(MultiViewPCRecord(paths=paths,
                                             label=labels.index(label_name)))
    return records


def load_pc_views(record: MultiViewPCRecord, size: int = 224) -> np.ndarray:
    """Load one record's 5 view images as a (5, 3, size, size) float32
    array in [0, 1] — the resize(224)+RGB+ToTensor transform of the
    reference dataset (clip_adapter/dataset.py:56-61,91-97)."""
    from PIL import Image

    views = []
    for path in record.paths:
        img = Image.open(path).resize((size, size)).convert("RGB")
        arr = np.asarray(img, dtype=np.float32) / 255.0
        views.append(arr.transpose(2, 0, 1))
    return np.stack(views, axis=0)


def smooth_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         eps: float = 0.2) -> torch.Tensor:
    """Label-smoothed CE (clip_adapter/main.py:20-29)."""
    n = logits.shape[-1]
    # (F.one_hot checks the labels' range on the host: a device sync each step)
    one_hot = (labels[:, None] == torch.arange(n, device=labels.device)).to(logits.dtype)
    target = one_hot * (1 - eps) + (1 - one_hot) * eps / (n - 1)
    logp = torch.log_softmax(logits, dim=-1)
    return -(target * logp).sum(-1).mean()


def _logits(adapter: AdapterModel, feats: torch.Tensor, text_table: torch.Tensor,
            scale: float) -> torch.Tensor:
    out = adapter(feats)
    out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-12)
    return scale * out @ text_table.T


def topk_ranks(logits: np.ndarray, labels: np.ndarray) -> np.ndarray:
    gt = np.take_along_axis(logits, labels[:, None], axis=-1)
    return (logits > gt).sum(-1)  # 0-based rank


def cosine_rate(lr: float, step: int, steps: int) -> float:
    """optax ``cosine_decay_schedule(lr, steps)`` at update ``step`` (0-based):
    lr at update 0, held at 0 from ``steps`` on."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(step, steps) / steps))


def _adapter(dim: int, alpha: float, params, seed: int, dev) -> AdapterModel:
    model = AdapterModel(dim, alpha=alpha)
    if params is None:
        init_parameters(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(flax_to_state_dict(params, {}, model))
    return model.to(dev)


def train_adapter(
    train_feats: np.ndarray, train_labels: np.ndarray,
    val_feats: np.ndarray, val_labels: np.ndarray,
    text_table: np.ndarray,
    alpha: float = 0.6,
    lr: float = 1e-2,
    weight_decay: float = 5e-4,
    epochs: int = 20,
    batch_size: int = 32,
    eps: float = 0.2,
    seed: int = 0,
    logit_scale: float = float(np.exp(np.log(1 / 0.07))),
    init_params=None,
    device=None,
    history: Optional[dict] = None,
):
    """Returns (best_params, best_top1), the params in the JAX layout.

    The update is optax's ``chain(add_decayed_weights(weight_decay),
    sgd(cosine_decay_schedule(lr, steps)))``: p -= rate_t * (g + wd * p).
    Each epoch visits ``np.random.RandomState(seed).permutation`` batches
    (the trailing partial batch dropped), then scores the validation split;
    the best top-1 so far keeps its weights.  ``init_params`` (JAX layout)
    gives the first weights, else they are drawn from
    ``torch.Generator().manual_seed(seed)``.  ``history``, where given,
    receives ``"loss"`` (each step's loss, a 0-d tensor on the device) and
    ``"top1"`` (each epoch's validation top-1)."""
    dev = resolve_device(device)
    model = _adapter(train_feats.shape[-1], alpha, init_params, seed, dev)
    params = list(model.parameters())
    steps_per_epoch = max(1, len(train_feats) // batch_size)
    steps = steps_per_epoch * epochs
    table = torch.as_tensor(np.asarray(text_table, np.float32), device=dev)
    x_train = torch.as_tensor(np.asarray(train_feats, np.float32), device=dev)
    y_train = torch.as_tensor(np.asarray(train_labels).astype(np.int64), device=dev)
    x_val = torch.as_tensor(np.asarray(val_feats, np.float32), device=dev)
    if history is not None:
        history.setdefault("loss", [])
        history.setdefault("top1", [])

    rng = np.random.RandomState(seed)
    best_params, best_top1 = state_dict_to_flax(model.state_dict())[0], -1.0
    t = 0
    for _ in range(epochs):
        order = torch.as_tensor(rng.permutation(len(train_feats)), device=dev)
        for i in range(steps_per_epoch):
            sel = order[i * batch_size:(i + 1) * batch_size]
            loss = smooth_cross_entropy(_logits(model, x_train[sel], table, logit_scale),
                                        y_train[sel], eps)
            grads = torch.autograd.grad(loss, params)
            rate = cosine_rate(lr, t, steps)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p.add_((g + weight_decay * p) * -rate)
            t += 1
            if history is not None:
                history["loss"].append(loss.detach())
        with torch.no_grad():
            logits = _logits(model, x_val, table, logit_scale)
        top1 = 100.0 * (topk_ranks(logits.cpu().numpy(), np.asarray(val_labels)) < 1).mean()
        if history is not None:
            history["top1"].append(top1)
        if top1 > best_top1:
            best_top1, best_params = top1, state_dict_to_flax(model.state_dict())[0]
    return best_params, best_top1


def zero_shot_eval(feats: np.ndarray, labels: np.ndarray,
                   text_table: np.ndarray,
                   params=None, alpha: float = 0.5, device=None) -> dict:
    """clip_adapter/test.py: (adapted) feature vs text weights top-k.  With
    ``params`` (JAX layout) the adapter runs on ``device``."""
    f = feats / np.linalg.norm(feats, axis=-1, keepdims=True).clip(1e-12)
    if params is not None:
        dev = resolve_device(device)
        model = _adapter(feats.shape[-1], alpha, params, 0, dev)
        with torch.no_grad():
            f = model(torch.as_tensor(np.asarray(feats, np.float32), device=dev)).cpu().numpy()
        f = f / np.linalg.norm(f, axis=-1, keepdims=True).clip(1e-12)
    ranks = topk_ranks(f @ text_table.T, labels)
    return {f"top{k}": 100.0 * (ranks < k).mean() for k in (1, 5, 10)}
