"""Data parallelism over a ``torch.distributed`` process group (counterpart
of ``vlsat_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a one-axis ``'data'`` mesh:
scenes shard over the axis, parameters replicate and every reduction over
the scene axis (loss means, the DYNAMIC class counts, ``MaskedBatchNorm``
moments) is global, since jit inserts the psums.  Here each rank is a
process with one device; rank r holds the contiguous block r of every
batch's scene axis, which is what ``NamedSharding(P('data'))`` gives device
r.  The global semantics are made explicit:

* inside a train step the step enters ``reducing(world)``; there
  ``global_sum`` all-reduces (differentiably) every denominator, class
  count and BatchNorm moment, so each rank's loss is its numerator over the
  global denominator and the sum of the ranks' losses is the global batch's;
* the step all-reduces (SUM) the ranks' gradients, so every rank applies
  the global batch's gradient and AdamW stays identical on every rank;
* dropout draws the global batch's mask and keeps the rank's block
  (``global_rand``), so a sharded step equals the unsharded one with
  dropout on.

The group comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) or
from explicit arguments.  The backend follows the layout: NCCL when every
rank has a card of its own, gloo on the CPU and where ranks share a card
(NCCL refuses two ranks on one device).  Host tensors and Python objects
(the evaluation's gathers, the metric dict) travel over a gloo group.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
import pickle
import tempfile
from typing import Callable, Iterator, Optional

import torch
import torch.distributed as dist

from vlsat_tpu_torch.device import resolve_device
from vlsat_tpu_torch.scene import SceneBatch, pad_batch_scenes

AXIS = "data"  # the JAX mesh's axis name, kept in the messages


@dataclasses.dataclass(frozen=True)
class World:
    """One rank's view of the process group."""
    rank: int
    size: int
    device: torch.device
    backend: str
    group: object        # collectives on the device's tensors
    host_group: object   # gloo: host tensors and Python objects

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)


_WORLD: Optional[World] = None  # the group this process joined (torch's is process-wide too)
# the group whose reductions are global in this thread's current train step
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("active_world", default=None)


def init_data_parallel(device=None, init_method: Optional[str] = None,
                       rank: Optional[int] = None, world_size: Optional[int] = None,
                       timeout_s: float = 600.0) -> World:
    """Join the process group and return this rank's ``World``.

    ``rank`` / ``world_size`` default to torchrun's ``RANK`` / ``WORLD_SIZE``,
    ``init_method`` to ``env://`` (torchrun's ``MASTER_ADDR``/``MASTER_PORT``;
    ``file://...`` names a FileStore).  ``device``: the card unless the
    caller asks for the CPU; on the card rank r takes
    ``cuda:(LOCAL_RANK % device_count)``.  Backend: gloo on the CPU and when
    ``LOCAL_WORLD_SIZE`` exceeds the cards, NCCL otherwise.  A group that
    cannot form raises; nothing falls back to one process."""
    global _WORLD
    if _WORLD is not None:
        raise RuntimeError("this process already joined a data-parallel group")
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_size <= cards else "gloo"
    else:
        backend = "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=size, timeout=timeout)
    host = (dist.new_group(backend="gloo", timeout=timeout) if backend == "nccl"
            else dist.group.WORLD)
    _WORLD = World(rank, size, dev, backend, dist.group.WORLD, host)
    return _WORLD


def spawn_ranks(fn: Callable, n: int, *args, device=None, store_dir: Optional[str] = None,
                timeout_s: float = 600.0):
    """Run ``fn(*args)`` in ``n`` fresh processes that form one group
    (``init_data_parallel`` with a FileStore in ``store_dir``, a temporary
    directory by default; rank r on ``cuda:r`` unless ``device="cpu"``;
    collectives time out after ``timeout_s``) and return rank 0's result.
    A rank that raises fails the call.  ``fn`` and ``args`` must pickle (a
    module-level function)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        mp.spawn(_spawned_rank, args=(n, tmp, device, timeout_s, fn, args), nprocs=n,
                 join=True)
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


def _spawned_rank(rank: int, n: int, tmp: str, device, timeout_s: float, fn: Callable,
                  args: tuple) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_WORLD_SIZE=str(n))
    init_data_parallel(device=device, init_method=f"file://{tmp}/store", timeout_s=timeout_s)
    try:
        out = fn(*args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        shutdown()


def world() -> Optional[World]:
    """The group this process joined, or None."""
    return _WORLD


def shutdown() -> None:
    """Leave the group (the process may join another afterwards)."""
    global _WORLD
    if _WORLD is not None:
        dist.destroy_process_group()
        _WORLD = None


@contextlib.contextmanager
def reducing(w: Optional[World]) -> Iterator[None]:
    """Within the block ``global_sum`` and ``global_rand`` act over ``w``
    (a train step's forward and loss); ``None`` makes them local."""
    token = _ACTIVE.set(w)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


class _AllReduceSum(torch.autograd.Function):
    """All-reduce (SUM) whose backward all-reduces the gradient: rank r's
    input feeds every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the active group, differentiable
    (the backward all-reduces the gradient too); the identity outside
    ``reducing``."""
    w = _ACTIVE.get()
    return x if w is None else _AllReduceSum.apply(x, w.group)


def global_rand(shape, generator: torch.Generator, device) -> torch.Tensor:
    """``torch.rand(shape)`` of this rank's block of the global batch: the
    draw is of the global shape (the ranks' leading axes stacked), as the
    unsharded step draws it, and the rank keeps its rows."""
    w = _ACTIVE.get()
    if w is None:
        return torch.rand(shape, generator=generator, device=device)
    n = shape[0]
    full = torch.rand((w.size * n, *shape[1:]), generator=generator, device=device)
    return full[w.rank * n:(w.rank + 1) * n]


def _block(n: int, w: World, what: str) -> slice:
    if n % w.size:
        raise ValueError(
            f"{what} of {n} scenes does not divide over {w.size} devices on mesh axis "
            f"{AXIS!r}; pad with masked scenes or drop the remainder")
    per = n // w.size
    return slice(w.rank * per, (w.rank + 1) * per)


def shard_batch(batch: SceneBatch, w: World) -> SceneBatch:
    """This rank's contiguous block of a batch's scene axis.  The scene
    count must divide by the world size: uneven blocks would skew every
    global reduction.  Pad ragged batches with masked scenes
    (``shard_eval_batches``) or drop the remainder."""
    s = _block(batch.num_scenes, w, "batch")
    return batch.replace(**{k: v[s] for k, v in vars(batch).items() if v is not None})


def shard_stacked_batch(batches: SceneBatch, w: World) -> SceneBatch:
    """This rank's block of a K-stacked batch (``train.step.stack_batches``:
    steps first, scenes second): axis 1 shards, the K axis stays whole."""
    s = _block(batches.obj_points.shape[1], w, "stacked batch")
    return batches.replace(**{k: v[:, s].contiguous() for k, v in vars(batches).items()
                              if v is not None})


def _broadcast(t: torch.Tensor, w: World) -> None:
    """Broadcast ``t`` from rank 0 in place; NCCL needs it on the card."""
    if w.backend == "nccl" and t.device != w.device:
        tmp = t.to(w.device)
        dist.broadcast(tmp, 0, group=w.group)
        t.copy_(tmp)
    else:
        dist.broadcast(t, 0, group=w.group)


@torch.no_grad()
def replicate(state, w: World):
    """Make every rank hold rank 0's weights: parameters and buffers of a
    module or of a ``TrainState``'s model, and the TrainState's optimizer
    state.  Returns ``state``."""
    model = getattr(state, "model", state)
    for t in model.state_dict().values():
        _broadcast(t, w)
    opt = getattr(state, "optimizer", None)
    if opt is not None:
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p, {})
                for k in sorted(st):
                    if torch.is_tensor(st[k]):
                        _broadcast(st[k], w)
    return state


class ShardedEvalBatches:
    """An eval loader for data-parallel evaluation: each batch padded with
    fully-masked scenes (the metric engine skips them) to a multiple of the
    world size.  ``evaluate()`` sees ``mesh_sharded`` and gives each rank
    its block of every batch."""

    mesh_sharded = True

    def __init__(self, loader, w: World):
        self.loader = loader
        self.world = w

    @property
    def max_gt(self):
        return getattr(self.loader, "max_gt", None)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[SceneBatch]:
        n = self.world.size
        for batch in self.loader:
            yield pad_batch_scenes(batch, -(-batch.num_scenes // n) * n)


def shard_eval_batches(loader, w: World) -> ShardedEvalBatches:
    """Wrap an eval loader of host batches for data-parallel evaluation
    (``ShardedEvalBatches``)."""
    return ShardedEvalBatches(loader, w)
