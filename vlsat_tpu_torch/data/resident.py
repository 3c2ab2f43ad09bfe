"""Card-resident packed splits (counterpart of ``vlsat_tpu/data/resident.py``:
``split_nbytes`` to ``ResidentShardedEval`` and ``epoch_permutations``).

A packed split (``data/packed.py``) is already padded, collated and, with
its text targets deduplicated, small: tens of MB for a 3DSSG-scale split.
Each (bucket, field) array is copied to the card once, in the pack's own
dtypes (f32 floats, as the JAX package keeps them), and a minibatch is an
``index_select`` of rows on the card: a train step or an evaluated batch
then carries no host-to-device payload beyond a few hundred bytes of row
indices.

Epoch shuffling matches ``PackedLoader``: scene rows are permuted within
each bucket, groups have a fixed size and trailing partial groups are
dropped.  ``split_nbytes`` gives the card memory a variant needs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from vlsat_tpu_torch.data.bucket_batch import resolve_batch
from vlsat_tpu_torch.data.packed import PackedScenes
from vlsat_tpu_torch.device import resolve_device
from vlsat_tpu_torch.scene import SceneBatch, pad_batch_scenes


def split_nbytes(packed: PackedScenes, variant: int = 0) -> int:
    """Total bytes of one variant's arrays: the card memory its residency
    takes."""
    return sum(packed.array(b, f, variant).nbytes
               for b in packed.buckets for f in packed.fields(b))


def gather_rows(full: SceneBatch, rows: torch.Tensor) -> SceneBatch:
    """The scenes ``rows`` (an index tensor on ``full``'s device) of a
    resident bucket, as a new batch: one ``index_select`` per field."""
    return SceneBatch(**{
        f.name: None if getattr(full, f.name) is None
        else getattr(full, f.name).index_select(0, rows)
        for f in dataclasses.fields(SceneBatch)})


def take_batch(stacked: SceneBatch, k: int) -> SceneBatch:
    """Batch ``k`` of a batch-stacked split (leading (num_batches, B, ...)
    axes, ``ResidentShardedEval``): a view, no copy."""
    return stacked.replace(**{n: v[k] for n, v in vars(stacked).items() if v is not None})


class ResidentScenes:
    """One pack variant resident on ``device`` (the card unless the caller
    passes ``device="cpu"``).

    ``full_batch(bucket)`` is a SceneBatch whose tensors hold every scene of
    the bucket along the leading axis; ``gather_rows`` takes minibatches
    from it (``train.step.make_resident_multi_train_step``, the resident
    eval loaders).  The text table stays on the host, as the train step
    moves it once itself."""

    def __init__(self, packed: PackedScenes, variant: int = 0, device=None):
        self.packed = packed
        self.variant = variant
        self.device = resolve_device(device)
        self.text_table = packed.text_table
        self._full: Dict[int, SceneBatch] = {
            b: packed.batch(b, slice(None), variant).to(self.device) for b in packed.buckets}

    @property
    def buckets(self):
        return self.packed.buckets

    def count(self, bucket: int) -> int:
        return self.packed.count(bucket)

    def full_batch(self, bucket: int) -> SceneBatch:
        return self._full[bucket]

    def host_batch(self, bucket: int, idx) -> SceneBatch:
        """The same rows off the pack's memory map, for metric assembly."""
        return self.packed.batch(bucket, idx, self.variant)


class ResidentEvalLoader:
    """Sequential eval batches as (host, device) SceneBatch pairs.

    ``evaluate()`` runs the eval step on the device half, gathered on the
    card from the resident bucket (no per-batch host-to-device copy), and
    assembles metrics from the host half (the same rows off the memory map).
    Iteration order equals ``PackedLoader(shuffle=False)``: buckets
    ascending, contiguous rows, the trailing partial batch kept.
    ``batch_size`` is an int or a {bucket: B} mapping."""

    def __init__(self, resident: ResidentScenes, batch_size):
        self.resident = resident
        self.batch_size = batch_size

    @property
    def max_gt(self) -> int:
        """The evaluation engine's GT-slot cap (see ``PackedScenes.max_gt``)."""
        return self.resident.packed.max_gt

    def __len__(self) -> int:
        return sum(-(-self.resident.count(b) // resolve_batch(self.batch_size, b))
                   for b in self.resident.buckets)

    def __iter__(self) -> Iterator[Tuple[SceneBatch, SceneBatch]]:
        dev = self.resident.device
        for b in self.resident.buckets:
            c, bs = self.resident.count(b), resolve_batch(self.batch_size, b)
            full = self.resident.full_batch(b)
            for start in range(0, c, bs):
                stop = min(start + bs, c)
                rows = torch.arange(start, stop, device=dev)  # made on the card
                yield self.resident.host_batch(b, slice(start, stop)), gather_rows(full, rows)


class ResidentGroupedEval:
    """K eval batches per output copy over the resident split.

    Yields ``(hosts, full, idx)`` items (``grouped = True`` tells
    ``evaluate()`` to take its grouped path): ``hosts`` is a list of <= K
    host SceneBatches off the memory map, each padded to the bucket's batch
    size with fully-masked scenes; ``full`` is the bucket's resident batch;
    ``idx`` is a (K, B) int32 array of scene rows.  The engine runs the K
    index-gathered minibatches back to back on the card and copies their
    packed rank buffers to the host in one transfer.  Tail rows clamp to the
    last scene and a tail group repeats its last batch: their outputs are
    computed but never assembled (eval mode has no cross-scene coupling), so
    metrics equal the per-batch loaders'.  Batch boundaries and order equal
    ``ResidentEvalLoader``'s at the same ``batch_size`` (an int or a
    {bucket: B} mapping)."""

    grouped = True

    def __init__(self, resident: ResidentScenes, batch_size, group: int = 8):
        if group < 1:
            raise ValueError(f"group must be >= 1, got {group}")
        self.resident = resident
        self.batch_size = batch_size
        self.group = int(group)

    @property
    def max_gt(self) -> int:
        """The evaluation engine's GT-slot cap (see ``PackedScenes.max_gt``)."""
        return self.resident.packed.max_gt

    def __len__(self) -> int:
        return sum(-(-self.resident.count(b) // resolve_batch(self.batch_size, b))
                   for b in self.resident.buckets)

    def __iter__(self):
        k = self.group
        for b in self.resident.buckets:
            c, bs = self.resident.count(b), resolve_batch(self.batch_size, b)
            full = self.resident.full_batch(b)
            starts = list(range(0, c, bs))
            for g0 in range(0, len(starts), k):
                chunk = starts[g0:g0 + k]
                hosts = [pad_batch_scenes(
                    self.resident.host_batch(b, slice(s, min(s + bs, c))), bs)
                    for s in chunk]
                idx = np.stack([np.minimum(np.arange(s, s + bs), c - 1).astype(np.int32)
                                for s in chunk])
                if len(chunk) < k:  # a fixed (K, B) shape
                    idx = np.concatenate([idx, np.repeat(idx[-1:], k - len(chunk), axis=0)])
                yield hosts, full, idx


class ResidentShardedEval:
    """A card-resident eval split for data-parallel evaluation (JAX
    ``vlsat_tpu/data/resident.py:209-308``).

    The split is stored batch-structured: per bucket, batches are padded to
    a fixed ``batch_size`` with fully-masked scenes (the metric engine skips
    them) and stacked to (num_batches, B, ...); each rank places only its
    block of every batch, (num_batches, B / world, ...), on its device once.
    Selecting batch k is then a slice on the rank's device: no per-batch
    host-to-device payload.

    Yields ``(host, device)`` pairs (host: the whole padded batch off the
    pack's memory map, for metric assembly; device: the rank's block), or,
    with ``group`` > 1, ``(hosts, full, ids)`` groups: up to K host batches,
    the rank's stacked split and (K,) int32 batch ids, the tail group
    repeating its last id (repeats are computed, never assembled).
    ``batch_size`` is an int or a {bucket: B} mapping; every resolved size
    must divide by the world size (the runner streams through
    ``parallel.shard_eval_batches`` otherwise)."""

    mesh_sharded = True  # evaluate() runs it data-parallel over .world

    def __init__(self, packed: PackedScenes, world, batch_size, variant: int = 0,
                 group: int = 1):
        for b in packed.buckets:
            if resolve_batch(batch_size, b) % world.size:
                raise ValueError(
                    f"batch_size {resolve_batch(batch_size, b)} (bucket {b}) does not "
                    f"divide over {world.size} devices on mesh axis 'data'")
        if group < 1:
            raise ValueError(f"group must be >= 1, got {group}")
        self.packed = packed
        self.world = world
        self.batch_size = batch_size
        self.variant = variant
        self.group = int(group)
        self.grouped = self.group > 1  # evaluate() takes its grouped path
        self._hosts: Dict[int, list] = {}
        self._stacks: Dict[int, SceneBatch] = {}
        for b in packed.buckets:
            c, bs = packed.count(b), resolve_batch(batch_size, b)
            hosts = [pad_batch_scenes(packed.batch(b, slice(s, min(s + bs, c)), variant), bs)
                     for s in range(0, c, bs)]
            self._hosts[b] = hosts
            per = bs // world.size
            block = slice(world.rank * per, (world.rank + 1) * per)
            self._stacks[b] = SceneBatch(**{
                f.name: None if getattr(hosts[0], f.name) is None
                else torch.stack([getattr(h, f.name)[block] for h in hosts]).to(world.device)
                for f in dataclasses.fields(SceneBatch)})

    @property
    def max_gt(self) -> int:
        """The evaluation engine's GT-slot cap (see ``PackedScenes.max_gt``)."""
        return self.packed.max_gt

    def __len__(self) -> int:
        return sum(len(v) for v in self._hosts.values())

    def __iter__(self):
        for b in sorted(self._hosts):
            full, hosts_b = self._stacks[b], self._hosts[b]
            if not self.grouped:
                for k, host in enumerate(hosts_b):
                    yield host, take_batch(full, k)
                continue
            for g0 in range(0, len(hosts_b), self.group):
                hosts = hosts_b[g0:g0 + self.group]
                ids = np.arange(g0, g0 + len(hosts), dtype=np.int32)
                if len(hosts) < self.group:  # a fixed (K,) shape
                    ids = np.concatenate([ids, np.full(self.group - len(hosts), ids[-1],
                                                       np.int32)])
                yield hosts, full, ids


def epoch_permutations(counts: Dict[int, int], group: int, epoch: int, seed: int = 2020,
                       shuffle: bool = True) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (bucket, perm) index groups of one epoch; ``group`` = scenes per
    call (K*B for the resident multi-step).  Permutes within each bucket with
    the RandomState stream ``PackedLoader`` uses (seed + epoch), emits
    fixed-size int32 groups and drops trailing partials."""
    rng = np.random.RandomState(seed + epoch)
    for b in sorted(counts):
        c = counts[b]
        order = (rng.permutation(c) if shuffle else np.arange(c)).astype(np.int32)
        for start in range(0, c - group + 1, group):
            yield b, order[start:start + group]
