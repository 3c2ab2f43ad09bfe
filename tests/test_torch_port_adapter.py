"""The port's CLIP-adapter trainer (``clipsem/adapter_train.py``) against
the JAX package's, on the CPU: the quality-list and rendered-view parsers,
``load_pc_views``, the label-smoothed cross-entropy, ``topk_ranks``, the
optimizer's schedule, ``train_adapter`` from the same initial weights, and
``zero_shot_eval`` with and without adapter weights.

Both packages get the same seeded numpy inputs and, for training, the JAX
trainer's own initial weights (``init_params``).  Gates: losses at the
parity gate of tests/test_parity_torch.py (fp32, rtol 1e-3, atol 1e-4);
every epoch's validation top-1 and the zero-shot top-k exactly equal; the
best weights within 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from vlsat_tpu.clipsem import adapter_train as JA
from vlsat_tpu.models.layers import AdapterModel as JaxAdapter
from vlsat_tpu_torch.clipsem import adapter_train as PA

RTOL, ATOL = 1e-3, 1e-4
DIM, CLASSES = 32, 10


def test_parsers_and_views_equal_jax(tmp_path):
    q = tmp_path / "train_scans_all_quanlity.txt"
    q.write_text("Scene: s1 Instance: 4 Label: trash can Quanlity: A\njunk\n"
                 "Scene:s2   Instance:7 Label:chair Quanlity:B\n")
    got, want = PA.parse_quality_list(str(q)), JA.parse_quality_list(str(q))
    assert [vars(r) for r in got] == [vars(r) for r in want] and len(want) == 2
    assert got[0].feature_path("/r", "croped_view_mean") == want[0].feature_path(
        "/r", "croped_view_mean")

    lst = tmp_path / "list.txt"
    lst.write_text("Scene:scene1 Instance:3 Label:trash can Quanlity:A\n\n"
                   "Scene:scene2 Instance:7 Label:chair Quanlity:B\n")
    labels = ["chair", "trash can"]
    got = PA.parse_pc_data_list(str(lst), labels, root_path=str(tmp_path))
    want = JA.parse_pc_data_list(str(lst), labels, root_path=str(tmp_path))
    assert [vars(r) for r in got] == [vars(r) for r in want] and PA._PC_ANGLES == JA._PC_ANGLES
    (tmp_path / "scene1" / "multi_view_pc").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i, path in enumerate(want[0].paths):  # grey, RGB and RGBA files, resized and converted
        arr = rng.randint(0, 255, (6 + i, 5, (1, 3, 4)[i % 3]), dtype=np.uint8)
        Image.fromarray(arr[..., 0] if arr.shape[2] == 1 else arr).save(path.replace(
            ".jpg", ".png"))
    recs = [type(want[0])(tuple(p.replace(".jpg", ".png") for p in want[0].paths), 1)]
    v = PA.load_pc_views(recs[0], size=8)
    assert v.shape == (5, 3, 8, 8) and v.dtype == np.float32
    np.testing.assert_array_equal(v, JA.load_pc_views(recs[0], size=8))


@pytest.mark.parametrize("eps", [0.2, 0.0, 0.5])
def test_smooth_cross_entropy_and_ranks_equal_jax(eps):
    rng = np.random.RandomState(1)
    logits = (rng.randn(16, CLASSES) * 3).astype(np.float32)
    labels = rng.randint(0, CLASSES, 16)
    want = float(JA.smooth_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), eps))
    got = PA.smooth_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), eps)
    np.testing.assert_allclose(got.item(), want, rtol=RTOL, atol=ATOL)
    logits[0, :3] = logits[0, labels[0]]  # ties rank below the ground truth
    np.testing.assert_array_equal(PA.topk_ranks(logits, labels), JA.topk_ranks(logits, labels))


def test_cosine_rate_equals_optax():
    sched = optax.cosine_decay_schedule(1e-2, 37)  # in float32; cosine_rate in float64
    for t in (0, 1, 18, 36, 37, 60):
        np.testing.assert_allclose(PA.cosine_rate(1e-2, t, 37), float(sched(t)), rtol=1e-5,
                                   atol=1e-12)


def features(seed: int, n: int):
    rng = np.random.RandomState(seed)
    centers = rng.randn(CLASSES, DIM).astype(np.float32)
    labels = rng.randint(0, CLASSES, n)
    feats = centers[labels] + rng.randn(n, DIM).astype(np.float32) * 1.5
    table = rng.randn(CLASSES, DIM).astype(np.float32)
    return feats, labels, table / np.linalg.norm(table, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def trained():
    """Both trainers, 4 epochs of 12 steps at B=16 from JAX's initial
    weights, recording every epoch's validation top-1."""
    tf, tl, table = features(2, 200)
    vf, vl, _ = features(2, 90)
    vf, vl = vf[-60:], vl[-60:]
    kw = dict(alpha=0.6, epochs=4, batch_size=16, seed=3)
    init = jax.tree_util.tree_map(np.asarray, JaxAdapter(alpha=0.6).init(
        jax.random.PRNGKey(3), jnp.zeros((1, DIM)))["params"])
    jax_top1 = []
    rank_fn = JA.topk_ranks

    def recording(logits, labels):
        ranks = rank_fn(logits, labels)
        jax_top1.append(100.0 * (ranks < 1).mean())
        return ranks

    JA.topk_ranks = recording
    try:
        want = JA.train_adapter(tf, tl, vf, vl, table, **kw)
    finally:
        JA.topk_ranks = rank_fn
    hist = {}
    got = PA.train_adapter(tf, tl, vf, vl, table, init_params=init, device="cpu",
                           history=hist, **kw)
    return dict(want=want, got=got, jax_top1=jax_top1, hist=hist, data=(vf, vl, table),
                init=init, train=(tf, tl))


def test_train_adapter_equals_jax(trained):
    (want_p, want_top1), (got_p, got_top1) = trained["want"], trained["got"]
    hist = trained["hist"]
    assert len(hist["loss"]) == 48 and len(hist["top1"]) == 4
    assert hist["top1"] == trained["jax_top1"]
    assert got_top1 == want_top1 and want_top1 > 100.0 / CLASSES
    for layer in ("fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got_p[layer][leaf], np.asarray(want_p[layer][leaf]),
                                       rtol=0, atol=1e-4)
    losses = [float(x) for x in hist["loss"]]
    assert np.isfinite(losses).all() and np.mean(losses[-12:]) < np.mean(losses[:12])


def test_train_adapter_first_loss_equals_jax_step(trained):
    """The first step's loss against JAX's loss function on the first
    batch of the seed's permutation."""
    tf, tl = trained["train"]
    _, _, table = trained["data"]
    sel = np.random.RandomState(3).permutation(len(tf))[:16]
    loss = JA.smooth_cross_entropy(
        JA._logits(JaxAdapter(alpha=0.6), trained["init"], jnp.asarray(tf[sel]),
                   jnp.asarray(table), float(np.exp(np.log(1 / 0.07)))), jnp.asarray(tl[sel]))
    np.testing.assert_allclose(float(trained["hist"]["loss"][0]), float(loss), rtol=RTOL,
                               atol=ATOL)


def test_train_adapter_seeded_without_init_params():
    tf, tl, table = features(4, 64)
    runs = [PA.train_adapter(tf, tl, tf[:20], tl[:20], table, epochs=2, batch_size=16, seed=5,
                             device="cpu") for _ in range(2)]
    assert runs[0][1] == runs[1][1]
    np.testing.assert_array_equal(runs[0][0]["fc2"]["kernel"], runs[1][0]["fc2"]["kernel"])
    assert runs[0][0]["fc1"]["kernel"].shape == (DIM, 256)


@pytest.mark.parametrize("with_params", [False, True])
def test_zero_shot_eval_equals_jax(trained, with_params):
    vf, vl, table = trained["data"]
    params = trained["got"][0] if with_params else None
    want = JA.zero_shot_eval(vf, vl, table, params=params)
    got = PA.zero_shot_eval(vf, vl, table, params=params, device="cpu")
    assert got == want and set(want) == {"top1", "top5", "top10"}
