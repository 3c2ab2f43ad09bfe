"""Experiment runner: config -> data -> model -> train / eval / serve
(counterpart of ``vlsat_tpu/train/runner.py``).

Builds the datasets, the model and the optimizer from a ``Config`` (a JAX
experiment JSON loads unchanged), runs the epoch loop with progress and
metric logging, periodic validation, checkpoints with best-model promotion
on mean recall@50, the standalone evaluation with its artifacts, and the
HTTP serving frontend.  Everything runs on ``device``: the card unless the
caller asks for the CPU.

Where the JAX runner draws a dropout key per step with
``jax.random.split``, this one seeds step t's dropout with
``train.step.fold_in(SEED + 7, t)``.  One device sync a step reads the
logged loss terms.

``data_parallel`` with a joined group of more than one rank
(``parallel.init_data_parallel``; ``main --data-parallel`` joins or spawns
it) is the JAX runner's mesh: every rank reads the same global batches and
its train steps take its block of scenes (global-batch losses, gradients
and BatchNorm statistics); validation runs data-parallel through
``ResidentShardedEval`` when every eval batch size divides the world size,
else through the streaming loader and ``parallel.shard_eval_batches``; the
resident train split stays single-rank, as in JAX.  Rank 0 alone writes
checkpoints, ``epoch_stats.jsonl``, the metric log and ``result.txt``;
every rank loads.  With one rank (or one card and no launcher) it changes
nothing, as JAX's mesh on one device.
"""

from __future__ import annotations

import inspect
import json
import os
import resource
import time
from typing import Optional

import numpy as np
import torch

from vlsat_tpu_torch import parallel
from vlsat_tpu_torch.config import Config
from vlsat_tpu_torch.data.assets import (build_triplet_vocab, load_relationship_json,
                                         read_classes, read_relationships)
from vlsat_tpu_torch.data.bucket_batch import resolve_batch
from vlsat_tpu_torch.data.dataset import SceneLoader, SSGScenes
from vlsat_tpu_torch.data.packed import PackedLoader, PackedScenes
from vlsat_tpu_torch.data.pipeline import Prefetcher
from vlsat_tpu_torch.data.resident import (ResidentEvalLoader, ResidentGroupedEval,
                                           ResidentScenes, ResidentShardedEval,
                                           epoch_permutations, split_nbytes)
from vlsat_tpu_torch.device import resolve_device
from vlsat_tpu_torch.eval.engine import evaluate
from vlsat_tpu_torch.models.mmgnet import MMGNet
from vlsat_tpu_torch.models.registry import build_model, model_config, needs_union_points
from vlsat_tpu_torch.serving import BatchedServer, HTTPFrontend
from vlsat_tpu_torch.train.checkpoint import CheckpointManager
from vlsat_tpu_torch.train.optim import make_optimizer, set_schedule_position
from vlsat_tpu_torch.train.state import TrainState, create_train_state
from vlsat_tpu_torch.train.step import (fold_in, make_eval_step, make_multi_train_step,
                                        make_resident_multi_train_step, make_train_step,
                                        stack_batches)
from vlsat_tpu_torch.utils.logging import MetricLogger
from vlsat_tpu_torch.utils.progbar import Progbar


def model_config_from(cfg: Config, num_obj: int, num_rel: int):
    """The config dataclass that the registry builds ``cfg.NAME`` with."""
    return model_config(cfg.NAME, num_obj, num_rel, cfg.MODEL)


class Runner:
    def __init__(self, cfg: Config, data_parallel: bool = False, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        w = parallel.world()
        self.world = w if data_parallel and w is not None and w.size > 1 else None
        if self.world is not None:
            if self.world.device.type != self.device.type:
                raise ValueError(f"the data-parallel group runs on {self.world.device}, "
                                 f"not on {self.device}")
            self.device = self.world.device
        elif data_parallel and w is None and self.device.type == "cuda" \
                and torch.cuda.device_count() > 1:
            raise RuntimeError(
                "data parallelism over several cards runs one process a card: launch under "
                "torchrun, or through python -m vlsat_tpu_torch.main --data-parallel, which "
                "joins or spawns the group (parallel.init_data_parallel)")
        self.rank0 = self.world is None or self.world.rank == 0
        d = cfg.dataset
        self.mode = cfg.get("MODE", "train")

        common = dict(
            root=d.root, scans_root=d.scans_root, label_file=d.label_file,
            num_points=d.num_points, num_points_union=d.num_points_union,
            multi_view_root=d.multi_view_root, cache_root=d.cache_root,
            with_union_points=d.with_union_points or needs_union_points(cfg.NAME),
            feat_dim=cfg.MODEL.clip_feat_dim, multi_rel=cfg.MODEL.multi_rel_outputs,
            # extra point channels (reference load_mesh, dataset_3dssg.py:38-58)
            use_rgb=cfg.MODEL.get("USE_RGB", False),
            use_normal=cfg.MODEL.get("USE_NORMAL", False),
        )
        # The precomputed triplet-sentence cache feeds the rel-mimic loss,
        # which exists only for multi-label outputs (the reference's
        # get_rel_emb asserts multi-hot targets).  The relation list is the
        # one that indexes gt_rels (relationships.txt minus 'none').  A
        # reference bug is deliberately not reproduced: SGFN_MMG/model.py:237
        # indexes relations.txt (alphabetical) with relationships.txt
        # indices, so its mimic sentences name the wrong predicate for most
        # classes.
        text_lookup = None
        if cfg.MODEL.get("triplet_text_cache") and cfg.MODEL.multi_rel_outputs:
            from vlsat_tpu_torch.clipsem import TripletTextCache

            text_lookup = TripletTextCache.load(cfg.MODEL.triplet_text_cache,
                                                read_classes(d.root),
                                                read_relationships(d.root)[1:])

        self.train_scenes = None
        if self.mode == "train":
            self.train_scenes = SSGScenes(
                split="train_scans",
                use_data_augmentation=d.get("use_data_augmentation", False),
                triplet_text_lookup=text_lookup,
                # runtime BFS subgraph sampling trains only (evaluation
                # needs full graphs)
                sample_in_runtime=d.get("sample_in_runtime", False),
                sample_num_nn=d.get("sample_num_nn", 2),
                sample_num_seed=d.get("sample_num_seed", 4),
                max_edges=d.get("max_edges", -1),
                neighbor_radius=d.get("neighbor_radius", 0.5),
                **common)
        self.valid_scenes = SSGScenes(split="validation_scans", **common)

        num_obj = len(self.valid_scenes.class_names)
        self.num_rel = len(self.valid_scenes.relation_names)
        obj_text = None
        if cfg.MODEL.obj_text_table:
            obj_text = np.load(cfg.MODEL.obj_text_table)
        self.model, self.loss_fn = build_model(cfg.NAME, num_obj, self.num_rel, cfg.MODEL,
                                               obj_text_features=obj_text)
        self.model.to(self.device)

        n_train = len(self.train_scenes) if self.train_scenes else len(self.valid_scenes)
        self.max_iteration = int(float(cfg.MAX_EPOCHES) * n_train // cfg.Batch_Size)
        self.use_pretrain = cfg.MODEL.get("use_pretrain", "") or ""
        self.optimizer = make_optimizer(
            lr=float(cfg.LR), max_iteration=max(self.max_iteration, 1),
            weight_decay=float(cfg.W_DECAY or 0.0),
            schedule=cfg.get("LR_SCHEDULE", "Cosine"),
            freeze_non_predictor=bool(self.use_pretrain))

        exp = cfg.get("exp", "default")
        self.exp_dir = os.path.join(cfg.PATH, cfg.NAME, exp)
        self.ckpt = CheckpointManager(os.path.join(self.exp_dir, "checkpoints"))
        self.logger = (MetricLogger(os.path.join(cfg.PATH, "logs", cfg.NAME, exp))
                       if self.rank0 else None)
        self.state: Optional[TrainState] = None
        self._packed_cache = {}
        self._eval_resident = None  # ResidentScenes, or ResidentShardedEval under a group

        self.train_triplet_vocab = None
        try:
            data = load_relationship_json(d.root, "train_scans")
            self.train_triplet_vocab = build_triplet_vocab(
                data, self.valid_scenes.class_names, self.valid_scenes.relation_names)
        except FileNotFoundError:
            pass

    # ------------------------------------------------------------------ setup
    def close(self) -> None:
        """Release the metric logger (and its TensorBoard writer thread)."""
        if self.logger is not None:
            self.logger.close()

    def _log(self, items, step: int) -> None:
        if self.logger is not None:
            self.logger.log(items, step)

    def _fresh_state(self) -> TrainState:
        return create_train_state(self.model, self.optimizer, seed=self.cfg.SEED)

    def _replicated(self, state: TrainState) -> TrainState:
        """Rank 0's weights and optimizer state on every rank."""
        return parallel.replicate(state, self.world) if self.world is not None else state

    def load(self, best: bool = False, allow_fallback: bool = False) -> bool:
        """Restore the latest (``best=True``: the best) checkpoint; False and
        a fresh state from ``SEED`` when there is none.

        ``allow_fallback=True`` (resuming a training run): a checkpoint that
        cannot be restored (a changed model, a damaged file) is archived
        aside and training starts fresh.  Otherwise (eval, serve) restore
        errors propagate: evaluating a fresh model silently would report
        meaningless metrics with exit code 0.

        Under a group rank 0 restores (or archives) first and the other
        ranks then read what it left, so all restore the same checkpoint
        or all start fresh."""
        if self.world is not None and not self.rank0:
            self.world.barrier()  # wait for rank 0's restore or archive
        try:
            restored = self._load(best, allow_fallback)
        finally:
            if self.world is not None and self.rank0:
                self.world.barrier()
        self.state = self._replicated(self.state)
        return restored

    def _load(self, best: bool, allow_fallback: bool) -> bool:
        state = self._fresh_state()
        try:
            restored = self.ckpt.restore(state, best=best)
        except Exception as e:  # any failure to read the checkpoint back
            if not allow_fallback:
                raise RuntimeError(
                    f"checkpoint restore failed for {self.exp_dir} ({type(e).__name__}); "
                    "delete or archive the stale checkpoints to proceed") from e
            archived = self.ckpt.archive_stale()
            print(f"warning: checkpoint restore failed ({type(e).__name__}); "
                  f"archived stale checkpoints to {archived}; starting fresh")
            restored, state = None, self._fresh_state()  # a partial load may have begun
        if restored is None:
            self.state = state
            return False
        # the schedule follows this run's max_iteration from the restored step
        set_schedule_position(restored.scheduler, restored.step)
        self.state = restored
        return True

    # ------------------------------------------------------------------ data
    def _packed(self, split: str) -> Optional[PackedScenes]:
        """The split's pack under ``dataset.packed_root``
        (``python -m vlsat_tpu_torch.tools.pack_dataset``), else None; cached
        per split, since the resident eval copy is keyed on it."""
        root = self.cfg.dataset.get("packed_root")
        if not root:
            return None
        pack = os.path.join(root, split)
        if not os.path.exists(os.path.join(pack, "manifest.json")):
            return None
        if split not in self._packed_cache:
            self._packed_cache[split] = PackedScenes(pack)
        return self._packed_cache[split]

    def _resident(self, key: str, packed: PackedScenes) -> bool:
        """``TRAIN_RESIDENT`` / ``EVAL_RESIDENT``: true, false, or "auto" =
        when one variant of the pack fits ``RESIDENT_HBM_BUDGET`` bytes."""
        mode = str(self.cfg.get(key, "auto")).lower()
        if mode == "auto":
            return split_nbytes(packed) <= int(self.cfg.get("RESIDENT_HBM_BUDGET", 2 << 30))
        return mode in ("1", "true", "yes")

    def _eval_bs(self):
        """``EVAL_BATCH_SIZE``: an int, or "auto" = the port's per-bucket
        table (``data/bucket_batch.py`` ``DEFAULT_EVAL_BATCH``; evaluation
        metrics do not depend on the batch size)."""
        raw = self.cfg.get("EVAL_BATCH_SIZE", 1)
        if str(raw).lower() == "auto":
            from vlsat_tpu_torch.data.bucket_batch import DEFAULT_EVAL_BATCH

            return dict(DEFAULT_EVAL_BATCH)
        return int(raw)

    def _eval_loader(self, packed: PackedScenes, bs):
        """A loader over a packed validation split: resident on the device
        under ``EVAL_RESIDENT`` (the copy is kept across validation passes),
        ``EVAL_GROUP`` > 1 batches per output copy; else streamed.  Under a
        group: ``ResidentShardedEval`` when resident and every resolved batch
        size divides the world size, else the streamed batches padded and
        sharded (``parallel.shard_eval_batches``)."""
        resident = self._resident("EVAL_RESIDENT", packed)
        group = max(int(self.cfg.get("EVAL_GROUP", 4)), 1)
        if self.world is not None:
            if resident and all(resolve_batch(bs, b) % self.world.size == 0
                                for b in packed.buckets):
                cached = self._eval_resident
                if (not isinstance(cached, ResidentShardedEval) or cached.packed is not packed
                        or cached.batch_size != bs or cached.group != group):
                    cached = self._eval_resident = ResidentShardedEval(
                        packed, self.world, bs, group=group)
                return cached
            return parallel.shard_eval_batches(PackedLoader(packed, batch_size=bs), self.world)
        if not resident:
            return PackedLoader(packed, batch_size=bs)
        if self._eval_resident is None or self._eval_resident.packed is not packed:
            self._eval_resident = ResidentScenes(packed, device=self.device)
        if group > 1:
            return ResidentGroupedEval(self._eval_resident, bs, group=group)
        return ResidentEvalLoader(self._eval_resident, bs)

    def _validation_loader(self, bs):
        packed = self._packed("validation")
        if packed is not None:
            return self._eval_loader(packed, bs)
        loader = SceneLoader(self.valid_scenes, batch_size=bs if isinstance(bs, int) else 1,
                             shuffle=False, buckets=self.cfg.dataset.node_buckets)
        if self.world is not None:
            loader = parallel.shard_eval_batches(loader, self.world)
        return loader

    # ------------------------------------------------------------------ train
    def train(self) -> None:
        cfg = self.cfg
        packed = self._packed("train")
        if packed is not None:
            loader = PackedLoader(packed, batch_size=cfg.Batch_Size, shuffle=True,
                                  seed=cfg.SEED, drop_last=True)
        else:
            loader = SceneLoader(self.train_scenes, batch_size=cfg.Batch_Size, shuffle=True,
                                 seed=cfg.SEED, drop_last=True, for_train=True,
                                 buckets=cfg.dataset.node_buckets)
        if self.state is None:
            self.state = self._replicated(self._fresh_state())
        if self.use_pretrain:
            # reference load_pretrain_model: the weights only, then train the
            # predictor heads (model_base.py:131-147)
            if not CheckpointManager(self.use_pretrain).restore_model(self.model, best=True):
                print(f"warning: no pretrain checkpoint at {self.use_pretrain}")

        m = cfg.MODEL
        supported = inspect.signature(self.loss_fn).parameters
        loss_kw = {k: v for k, v in dict(
            lambda_o=m.lambda_o,
            weight_mode=m.get("WEIGHT_EDGE", "DYNAMIC"),
            w_bg=m.get("w_bg", 1.0),
            none_ratio=m.get("NONE_RATIO", 1.0),
            ignore_none_rel=m.get("ignore_none_rel", False),
            weights_rel=torch.as_tensor(np.asarray(self.train_scenes.w_cls_rel, np.float32),
                                        device=self.device),
        ).items() if k in supported}
        objective = lambda outputs, batch: self.loss_fn(outputs, batch, **loss_kw)
        # a packed split carries its rel-mimic targets as a deduplicated
        # table and per-edge indices; the step gathers them on the device
        kw = dict(objective=objective, device=self.device,
                  text_table=packed.text_table if packed is not None else None)
        # TRAIN_MICROSTEPS = K train steps per call; TRAIN_RESIDENT keeps the
        # packed split on the device and sends only (K*B,) row permutations
        # (single-rank: under a group the steps shard the streamed batches)
        micro_k = max(int(cfg.get("TRAIN_MICROSTEPS", 1)), 1)
        resident = (packed is not None and self.world is None
                    and self._resident("TRAIN_RESIDENT", packed))
        if resident:
            step_fn = make_resident_multi_train_step(self.model, self.optimizer,
                                                     batch_size=cfg.Batch_Size, **kw)
            resident_cache = {}
        elif micro_k > 1:
            step_fn = make_multi_train_step(self.model, self.optimizer, world=self.world, **kw)
        else:
            step_fn = make_train_step(self.model, self.optimizer, world=self.world, **kw)
        eval_fn = make_eval_step(self.model, device=self.device)

        start_epoch = 1 + self.state.step // max(len(loader), 1)
        eva_res = -1.0
        for epoch in range(start_epoch, cfg.MAX_EPOCHES + 1):
            if self.rank0:
                print(f"\nTraining epoch: {epoch}")
            epoch_t0, epoch_scenes = time.perf_counter(), 0
            progbar = Progbar(len(loader), width=20, verbose=int(self.rank0),
                              stateful_metrics=["Misc/epo", "Misc/it"])
            if resident:
                variant = (epoch - 1) % packed.variants
                if variant not in resident_cache:
                    resident_cache.clear()  # one variant on the device at a time
                    resident_cache[variant] = ResidentScenes(packed, variant, device=self.device)
                rs = resident_cache[variant]
                counts = {b: packed.count(b) for b in packed.buckets}
                source = (((b, p), micro_k) for b, p in epoch_permutations(
                    counts, micro_k * cfg.Batch_Size, epoch - 1, seed=cfg.SEED))
            elif micro_k > 1:
                def grouped():
                    buf = []
                    for b in loader:
                        buf.append(b)
                        if len(buf) == micro_k:
                            yield stack_batches(buf)
                            buf = []
                    # a trailing partial group is dropped (drop_last semantics)

                source = ((g, micro_k) for g in Prefetcher(grouped()))
            else:
                source = ((b, 1) for b in Prefetcher(loader))
            for item, k in source:
                seed = fold_in(cfg.SEED + 7, self.state.step)
                if resident:
                    bucket, perm = item
                    self.state, aux = step_fn(self.state, rs.full_batch(bucket), perm, seed)
                else:
                    self.state, aux = step_fn(self.state, item, seed)
                it = self.state.step
                scalars = {n: v for n, v in aux.items() if v.dim() == 0}
                values = torch.stack(list(scalars.values())).cpu().tolist()  # one sync
                logs = [(f"train/{n}", v) for n, v in zip(scalars, values)]
                logs += [("Misc/epo", epoch), ("Misc/it", it)]
                progbar.add(k, values=logs)
                epoch_scenes += len(item[1]) if resident else k * int(cfg.Batch_Size)
                if cfg.LOG_INTERVAL and (it % cfg.LOG_INTERVAL) < k:
                    self._log(logs, it)
                if it >= self.max_iteration:
                    break
            # the reference saves every epoch (model.py:149); CKPT_EPOCH_INTERVAL
            # thins that out, and the final epoch always saves
            ck_int = int(cfg.get("CKPT_EPOCH_INTERVAL", 1))
            if self.rank0 and (epoch % max(ck_int, 1) == 0
                               or self.state.step >= self.max_iteration
                               or epoch == int(cfg.MAX_EPOCHES)):
                self.ckpt.save(self.state, eva_res if eva_res >= 0 else None)
            validated = None
            if cfg.VALID_INTERVAL > 0 and epoch % cfg.VALID_INTERVAL == 0:
                if self.rank0:
                    print("\nstart validation...")
                val_t0 = time.perf_counter()
                metrics = evaluate(
                    eval_fn, self.state.model.state_dict(),
                    self._validation_loader(self._eval_bs()), num_rel_classes=self.num_rel,
                    train_triplet_vocab=self.train_triplet_vocab,
                    total=len(self.valid_scenes), multi_rel=m.multi_rel_outputs)
                eva_res = metrics["mean_recall_50"]
                validated = {"mean_recall_50": round(float(eva_res), 5),
                             "val_wall_s": round(time.perf_counter() - val_t0, 2)}
                self._log(list(metrics.items()), self.state.step)
                if self.rank0:
                    self.ckpt.save(self.state, eva_res)
            if self.rank0:
                self._write_epoch_stats(epoch, epoch_t0, epoch_scenes, validated)
            if self.state.step >= self.max_iteration:
                break

    def _write_epoch_stats(self, epoch: int, epoch_t0: float, scenes: int,
                           validated: Optional[dict]) -> None:
        """Append one epoch's telemetry to ``<exp_dir>/epoch_stats.jsonl``
        (the JAX runner's row keys): wall time (validation included), train
        scenes/s, peak host RSS and, on a card, its memory in use and peak
        (``torch.cuda.memory_allocated`` / ``max_memory_allocated``).
        Telemetry never stops the run: a failure drops fields or the row."""
        wall = time.perf_counter() - epoch_t0
        row = {"epoch": epoch, "step": self.state.step, "scenes": int(scenes),
               "wall_s": round(wall, 2),
               "scenes_per_sec": round(scenes / max(wall, 1e-9), 1),
               "peak_rss_mb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
                                    1)}
        if self.device.type == "cuda":
            try:
                row["hbm_in_use_mb"] = round(torch.cuda.memory_allocated(self.device) / 1e6, 1)
                row["hbm_peak_mb"] = round(
                    torch.cuda.max_memory_allocated(self.device) / 1e6, 1)
            except RuntimeError:
                pass
        if validated:
            row.update(validated)
        try:
            with open(os.path.join(self.exp_dir, "epoch_stats.jsonl"), "a") as f:
                f.write(json.dumps(row) + "\n")
        except OSError:
            pass

    def _branch_3d_only(self) -> bool:
        """``EVAL_3D_ONLY`` is the serving mode of an ``MMGNet``; the other
        models run their full forward under it, as in JAX."""
        return bool(self.cfg.get("EVAL_3D_ONLY", False)) and isinstance(self.model, MMGNet)

    # ------------------------------------------------------------------ serve
    def serve(self, host: str = "127.0.0.1", port: int = 8764, max_batch: int = 32,
              deadline_ms: float = 5.0) -> HTTPFrontend:
        """The deployment frontend: a micro-batching ``BatchedServer`` behind
        an ``HTTPFrontend``, on the loaded state.  ``EVAL_3D_ONLY`` picks an
        ``MMGNet``'s 3D branch alone, as in ``validation()``; by default the
        full forward runs and the answers carry its 3D outputs.  Returns the frontend
        unstarted: ``.serve_forever()`` (the CLI) or a ``with`` block."""
        if self.state is None:
            raise RuntimeError("call load() first")
        server = BatchedServer(
            self.model, self.state.model.state_dict(), device=self.device,
            max_batch=max_batch, deadline_ms=deadline_ms,
            buckets=tuple(self.cfg.dataset.node_buckets),
            feat_dim=self.cfg.MODEL.clip_feat_dim, num_rel_classes=self.num_rel,
            branch_3d_only=self._branch_3d_only())
        return HTTPFrontend(server, host=host, port=port)

    # ------------------------------------------------------------------- eval
    def validation(self, save: bool = False, with_scores: bool = False,
                   batch_size: Optional[int] = None) -> dict:
        """The metric suite over the validation split.  The reference
        evaluates one scene at a time (model.py:186); the metrics do not
        depend on the batch size (``EVAL_BATCH_SIZE``).  ``EVAL_3D_ONLY``
        runs an ``MMGNet``'s 3D branch alone (its outputs are the same; the 2D metric
        families are then absent).  ``save`` writes the artifacts under
        ``PATH/results/NAME/exp``."""
        if self.state is None:
            raise RuntimeError("call load() first")
        eval_fn = make_eval_step(self.model, branch_3d_only=self._branch_3d_only(),
                                 device=self.device)
        save_dir = os.path.join(self.cfg.PATH, "results", self.cfg.NAME,
                                self.cfg.get("exp", "default")) if save else None
        metrics = evaluate(
            eval_fn, self.state.model.state_dict(),
            self._validation_loader(batch_size or self._eval_bs()),
            num_rel_classes=self.num_rel, train_triplet_vocab=self.train_triplet_vocab,
            save_dir=save_dir, with_scores=with_scores, total=len(self.valid_scenes),
            multi_rel=self.cfg.MODEL.multi_rel_outputs,
            # the in21k protocol (process_val2/3): scene-level R@K and mR@K
            scene_recall=bool(self.cfg.get("SCENE_RECALL", False)))
        if self.rank0:
            for k, v in metrics.items():
                print(f"Eval: {k}: {v}")
        return metrics
