"""Index samplers (counterpart of ``mega_pytorch_tpu/data/samplers.py``):
the training stream (iteration-counted, shuffled each epoch, batches never
mixing orientation groups, resumable mid-epoch) and evaluation sharding at
video boundaries."""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


def training_indices(dataset_len: int, group_ids: Sequence[int], batch_size: int,
                     start_iter: int = 0, max_iter: int = 10**9, seed: int = 0,
                     shard: int = 0, num_shards: int = 1) -> Iterator[list[int]]:
    """Grouped batches until ``max_iter``: each epoch a permutation from
    ``RandomState(seed + epoch)``, stably partitioned by group id and cut
    into whole batches, the batches shuffled; batches are dealt round-robin
    to the shards, and the first ``start_iter`` are skipped."""
    group_ids = np.asarray(group_ids)
    it = 0
    epoch = 0
    while it < max_iter:
        rng = np.random.RandomState(seed + epoch)
        order = rng.permutation(dataset_len)
        batches: list[list[int]] = []
        for g in np.unique(group_ids):
            members = order[group_ids[order] == g]
            for i in range(0, len(members) - batch_size + 1, batch_size):
                batches.append(members[i: i + batch_size].tolist())
        rng.shuffle(batches)
        for i, b in enumerate(batches):
            if i % num_shards != shard:
                continue
            if it >= start_iter:
                yield b
            it += 1
            if it >= max_iter:
                return
        epoch += 1


def video_shards(start_indices: Sequence[int], total: int, num_shards: int) -> list[list[int]]:
    """Split [0, total) at video boundaries into num_shards contiguous chunks.

    start_indices: dataset indices where a new video begins (frame_id == 0),
    ascending, starting with 0. Each shard's range is snapped forward to the
    next video start, so no video straddles two shards (the streaming
    carries need whole videos)."""
    starts = list(start_indices)
    if not starts or starts[0] != 0:
        raise ValueError("start_indices must begin with 0")

    def snap(pos: int) -> int:
        for s in starts:
            if s >= pos:
                return s
        return total

    per = -(-total // num_shards)
    bounds = [snap(min(i * per, total)) for i in range(num_shards)] + [total]
    return [list(range(bounds[i], bounds[i + 1])) for i in range(num_shards)]
