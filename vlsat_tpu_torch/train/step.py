"""Train and eval steps (counterpart of ``vlsat_tpu/train/step.py``).

The JAX steps are jitted programs; here they run eagerly.  The train step
updates the ``TrainState`` in place: forward in training mode with the
train-time outputs, objective, backward, AdamW step, scheduler step.  It
reads nothing back to the host.  The eval step runs the model in eval mode
with the weights passed in as a ``state_dict``
(``torch.func.functional_call``), so the JAX package's (params,
batch_stats) pair maps onto one argument.  Both keep full fp32: TF32 is
switched off for matmuls and convolutions, as the JAX CPU reference
computes in fp32.

Dropout draws from a ``torch.Generator`` on the step's device seeded with
the step's ``rng`` (an int, in the role of a JAX key); a multi-step call
derives step i's seed from (rng, i) with ``fold_in``.  The masks cannot
match flax's streams; the same seed gives the same masks.

Under a data-parallel group (``parallel.init_data_parallel``) the train
steps keep the JAX sharded step's global-batch semantics: every rank passes
the same global batch and copies only its block of scenes to its device;
the forward and loss run inside ``parallel.reducing`` (global denominators,
DYNAMIC counts, BatchNorm moments and dropout masks); the gradients and the
logged loss terms are summed over the ranks, so every rank applies the
global batch's gradient and logs the global loss.
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vlsat_tpu_torch.data.resident import gather_rows
from vlsat_tpu_torch.data.wire import decode_wire
from vlsat_tpu_torch.device import resolve_device
from vlsat_tpu_torch.ops.graph import EdgeRows, edge_row_slots, select_edge_rows
from vlsat_tpu_torch.parallel import mesh
from vlsat_tpu_torch.scene import SceneBatch
from vlsat_tpu_torch.train.losses import vlsat_total_loss
from vlsat_tpu_torch.train.optim import OptimizerSpec
from vlsat_tpu_torch.train.state import TrainState

Aux = Dict[str, torch.Tensor]


def _fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fold_in(seed: int, i: int) -> int:
    """A seed for step ``i`` of a call seeded with ``seed`` (the role of
    ``jax.random.fold_in``); both non-negative."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0] >> 1)


def _materialize_text(batch: SceneBatch, table) -> SceneBatch:
    """Expand compact ``rel_text_idx`` rows into ``rel_text_feat`` from the
    device-resident table (row 0 is the zero vector of padded edges)."""
    if batch.rel_text_idx is None or table is None:
        return batch
    return batch.replace(rel_text_feat=table[batch.rel_text_idx.long()], rel_text_idx=None)


def _all_reduce_(tensors: Sequence[torch.Tensor], world: mesh.World) -> None:
    """Sum same-dtype ``tensors`` over the ranks in place, in one
    collective."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    torch.distributed.all_reduce(flat, group=world.group)
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def make_train_step(model: nn.Module, optimizer: OptimizerSpec, lambda_o: float = 0.1,
                    objective=None, text_table=None, device=None, world=None
                    ) -> Callable[[TrainState, SceneBatch, int], Tuple[TrainState, Aux]]:
    """Returns ``train_step(state, batch, rng) -> (state, aux)`` for a state
    made by ``create_train_state(model, optimizer)``.  The (wire-encoded)
    host batch moves to ``device`` (the card unless the caller passes
    ``device="cpu"``).  ``objective(outputs, batch) -> (loss, aux)``
    defaults to ``vlsat_total_loss`` with ``lambda_o``.  ``aux`` holds the
    objective's terms and ``logit_scale`` as device tensors.

    ``text_table``: an optional (T, D) table of text targets; batches then
    carry (B, E) int32 ``rel_text_idx`` rows, gathered on the device.

    ``world``: the data-parallel group (default: the one this process
    joined, if any).  Every rank then passes the same global batch, whose
    scene count must divide by the world size; the step runs on the rank's
    block and its update and ``aux`` are the global batch's on every rank.
    ``train_step.local(state, block, rng)`` takes a block already cut
    (``parallel.shard_batch``)."""
    if objective is None:
        objective = lambda outputs, batch: vlsat_total_loss(outputs, batch, lambda_o=lambda_o)
    dev = resolve_device(device)
    world = mesh.world() if world is None else world
    _fp32()
    table = None if text_table is None else torch.as_tensor(
        np.asarray(text_table, np.float32)).to(dev)

    def local_step(state: TrainState, batch: SceneBatch, rng: int
                   ) -> Tuple[TrainState, Aux]:
        if state.model is not model:
            raise ValueError("the state was not created for this step's model")
        if not model.training:
            model.train()
        batch = _materialize_text(decode_wire(batch.to(dev, non_blocking=True)), table)
        gen = torch.Generator(device=dev).manual_seed(rng)
        with mesh.reducing(world):
            outputs = model(batch, istrain=True, rng=gen)
            loss, aux = objective(outputs, batch)
        aux = {k: v.detach() for k, v in aux.items()}
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if world is not None:
            # each rank's loss is its numerator over the global denominator:
            # the sum of the ranks' gradients is the global batch's
            _all_reduce_([p.grad for p in model.parameters() if p.grad is not None], world)
            _all_reduce_(list(aux.values()), world)
        if "logit_scale" in outputs:
            aux["logit_scale"] = outputs["logit_scale"].detach()
        optimizer.update(state.optimizer, state.scheduler)
        state.step += 1
        return state, aux

    def train_step(state: TrainState, batch: SceneBatch, rng: int
                   ) -> Tuple[TrainState, Aux]:
        if world is not None:
            batch = mesh.shard_batch(batch, world)
        return local_step(state, batch, rng)

    train_step.device = local_step.device = dev
    train_step.world = local_step.world = world
    train_step.local = local_step
    return train_step


def stack_batches(batches: Sequence[SceneBatch]) -> SceneBatch:
    """Stack K same-shape SceneBatches along a new leading axis (the input of
    ``make_multi_train_step``)."""
    kw = {}
    for f in dataclasses.fields(SceneBatch):
        vals = [getattr(b, f.name) for b in batches]
        kw[f.name] = None if vals[0] is None else torch.stack(vals)
    return SceneBatch(**kw)


def _unstack(batches: SceneBatch, i: int) -> SceneBatch:
    return SceneBatch(**{f.name: None if getattr(batches, f.name) is None
                         else getattr(batches, f.name)[i]
                         for f in dataclasses.fields(SceneBatch)})


def make_multi_train_step(model: nn.Module, optimizer: OptimizerSpec, lambda_o: float = 0.1,
                          objective=None, text_table=None, device=None, world=None
                          ) -> Callable[[TrainState, SceneBatch, int], Tuple[TrainState, Aux]]:
    """K train steps per call over a ``stack_batches`` stack, moved to the
    device in one copy; step i's dropout seed is ``fold_in(rng, i)``.
    Returns ``fn(state, stacked, rng) -> (state, aux)`` with ``aux["loss"]``
    the last step's loss and ``aux["losses"]`` all K (device tensors).
    Under a data-parallel group (``world``, as in ``make_train_step``) each
    rank copies its block of axis 1 (``parallel.shard_stacked_batch``)."""
    step = make_train_step(model, optimizer, lambda_o=lambda_o, objective=objective,
                           text_table=text_table, device=device, world=world).local

    def multi_step(state: TrainState, batches: SceneBatch, rng: int
                   ) -> Tuple[TrainState, Aux]:
        if step.world is not None:
            batches = mesh.shard_stacked_batch(batches, step.world)
        batches = batches.to(step.device, non_blocking=True)
        losses = []
        for i in range(batches.obj_points.shape[0]):
            state, aux = step(state, _unstack(batches, i), fold_in(rng, i))
            losses.append(aux["loss"])
        losses = torch.stack(losses)
        return state, {"loss": losses[-1], "losses": losses}

    multi_step.device = step.device
    return multi_step


def make_resident_multi_train_step(model: nn.Module, optimizer: OptimizerSpec,
                                   split_batch: SceneBatch = None, batch_size: int = 8,
                                   lambda_o: float = 0.1, objective=None, text_table=None,
                                   device=None):
    """K train steps per call over a resident split (counterpart of
    ``vlsat_tpu/train/step.py:146-194``).

    ``split_batch``: a whole packed bucket on the device
    (``data.resident.ResidentScenes.full_batch``).  The returned
    ``fn(state, perm, rng)`` takes a (K*B,) int32 permutation of scene rows
    (``data.resident.epoch_permutations``), reshapes it to (K, B), and step
    i gathers its minibatch on the device (``gather_rows``), expands its
    ``rel_text_idx`` from ``text_table`` and takes dropout seed
    ``fold_in(rng, i)``: the steps, losses and weights of
    ``make_multi_train_step`` fed the same rows.  Only the permutation
    crosses to the device.  ``split_batch=None`` gives the unbound form
    ``fn(state, split_batch, perm, rng)``, which serves every bucket and
    pack variant.  ``aux`` as in ``make_multi_train_step``.  It stays
    single-rank, as in JAX (``vlsat_tpu/train/runner.py:372-375``): under a
    data-parallel group it raises."""
    if mesh.world() is not None:
        raise ValueError("the resident multi-step is single-rank; under a data-parallel "
                         "group train with make_train_step or make_multi_train_step")
    step = make_train_step(model, optimizer, lambda_o=lambda_o, objective=objective,
                           text_table=text_table, device=device)

    def multi(state: TrainState, split: SceneBatch, perm, rng: int
              ) -> Tuple[TrainState, Aux]:
        if len(perm) % batch_size:
            raise ValueError(f"{len(perm)} rows do not split into batches of {batch_size}")
        rows = torch.as_tensor(perm).to(step.device, non_blocking=True).reshape(-1, batch_size)
        losses = []
        for i in range(rows.shape[0]):
            state, aux = step(state, gather_rows(split, rows[i]), fold_in(rng, i))
            losses.append(aux["loss"])
        losses = torch.stack(losses)
        return state, {"loss": losses[-1], "losses": losses}

    multi.device = step.device
    if split_batch is None:
        return multi
    bound = lambda state, perm, rng: multi(state, split_batch, perm, rng)
    bound.device = step.device
    return bound


# the edge rows that the last eval step of a thread computed, and its slots;
# the valid instances of its host batch, and its instance slots
_edge_report = threading.local()
_instance_report = threading.local()


def take_edge_rows() -> Optional[Tuple[int, int]]:
    """(edge rows computed, edge slots B * E) of the last ``make_eval_step``
    call on this thread since the last take, or None; a dense call computes
    every slot.  A thread-local and not an attribute of the step, since a
    caller such as ``serving.BatchedServer`` may be handed the step inside
    wrappers of its own (the benchmark's timing wrappers copy only
    ``.device``)."""
    last, _edge_report.last = getattr(_edge_report, "last", None), None
    return last


def take_instances() -> Optional[Tuple[int, int]]:
    """(valid instances, instance slots B * N) of the host batch of the last
    ``make_eval_step`` call on this thread since the last take, or None (a
    batch already on the device: counting would wait for it).  Kept as
    ``take_edge_rows`` keeps its counts."""
    last, _instance_report.last = getattr(_instance_report, "last", None), None
    return last


def has_3d_only_mode(model: nn.Module) -> bool:
    """Whether ``model``'s forward takes ``branch_3d_only`` (``MMGNet``,
    ``SGGpoint``, and ``SGPN``, whose one branch is its 3D branch)."""
    return "branch_3d_only" in inspect.signature(model.forward).parameters


def packs_edge_rows(model: nn.Module) -> bool:
    """Whether ``model``'s 3D-only eval forward can run its per-edge layers on
    packed rows: its forward takes ``edge_rows`` (``MMGNet``, ``SGPN``)."""
    return "edge_rows" in inspect.signature(model.forward).parameters


def make_eval_step(model: nn.Module, branch_3d_only: bool = False, device=None
                   ) -> Callable[[Mapping[str, torch.Tensor], SceneBatch],
                                 Dict[str, torch.Tensor]]:
    """Returns ``eval_step(state, batch)``: moves a (wire-encoded) host
    batch to ``device`` (the card unless the caller passes ``device="cpu"``),
    widens it to f32 there and runs the model in eval mode under
    ``torch.inference_mode()`` with the weights of ``state`` (the model's
    ``state_dict`` keys, on ``device``; a trained state's
    ``state.model.state_dict()``, which shares the model's storage).  The dual-branch forward by default,
    as in JAX; ``branch_3d_only=True`` is the serving mode of the models
    that have one (``MMGNet``, ``SGGpoint``, ``SGPN``: ``has_3d_only_mode``)
    and raises for any other model (JAX has it for ``MMGNet`` alone,
    step.py:203-211).  Every model of the registry runs through it.

    A 3D-only step of a model whose forward takes ``edge_rows``
    (``packs_edge_rows``: ``MMGNet``, ``SGPN``) given a batch on the host
    (the server's, a streaming loader's on the CPU) builds the batch's
    ``ops.graph.EdgeRows`` from the host's ``edge_mask`` and ships them with
    it, and the forward runs its per-edge layers on those rows alone.  Such
    a batch's ``rel_points`` may be dense (B, E, P, C), whose rows the step
    then picks, or already packed (R, P, C) in the rows' order (the
    server's: ``serving.BatchedServer`` ships only those).  A batch already
    on the device (a resident loader's on the card), ``SGGpoint`` and the
    dual forward run dense.  Each call reports its rows and slots
    (``take_edge_rows``) and, for a host batch, its valid instances and
    instance slots (``take_instances``).  ``eval_step.union_rows`` says
    whether the step takes a host batch's union clouds as packed rows
    (SGPN's 3D-only step): a server then ships only those."""
    if branch_3d_only and not has_3d_only_mode(model):
        raise ValueError(f"branch_3d_only is an MMGNet serving mode (SGGpoint and SGPN have "
                         f"one too), got {type(model).__name__}")
    packs = branch_3d_only and packs_edge_rows(model)
    kwargs = {"branch_3d_only": True} if branch_3d_only else {}
    dev = resolve_device(device)
    _fp32()
    model.eval()

    def eval_step(state: Mapping[str, torch.Tensor], batch: SceneBatch
                  ) -> Dict[str, torch.Tensor]:
        if model.training:  # the model was trained since
            model.eval()
        kw, slots = kwargs, batch.edge_mask.numel()
        _edge_report.last = (slots, slots)
        on_host = batch.obj_mask.device.type == "cpu"
        _instance_report.last = ((int(batch.obj_mask.sum()), batch.obj_mask.numel())
                                 if on_host else None)
        with torch.inference_mode():
            if packs and on_host:
                mask, index = batch.edge_mask.numpy(), batch.edge_index.numpy()
                packed = [torch.from_numpy(a) for a in select_edge_rows(mask, index,
                                                                        batch.num_nodes)]
                rows = len(packed[0])
                _edge_report.last = (rows, slots)
                rel = batch.rel_points
                if rel is not None and rel.dim() == 4:  # dense: pick the rows
                    batch = batch.replace(rel_points=rel.flatten(0, 1)[
                        torch.from_numpy(edge_row_slots(mask, index))])
                elif rel is not None and len(rel) != rows:
                    raise ValueError(f"packed rel_points hold {len(rel)} rows, the batch's "
                                     f"edge rows are {rows}")
                if dev.type == "cuda":  # copied with the batch, asynchronously
                    packed = [t.pin_memory() for t in packed]
                kw = dict(kwargs, edge_rows=EdgeRows(
                    *(t.to(dev, non_blocking=True).long() for t in packed)))
            batch = decode_wire(batch.to(dev, non_blocking=True))
            return torch.func.functional_call(model, dict(state), (batch,), kw, strict=True)

    eval_step.device = dev  # where eval.engine.evaluate sends the batches
    eval_step.union_rows = packs and bool(getattr(model, "needs_rel_points", False))
    return eval_step
