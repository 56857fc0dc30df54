"""Evaluation sharding (counterpart of ``mega_pytorch_tpu/data/samplers.py``,
``video_shards``; the training samplers wait for the training slice)."""

from __future__ import annotations

from typing import Sequence


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
