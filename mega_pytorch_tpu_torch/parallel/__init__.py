from .ddp import (
    destroy_distributed,
    init_distributed,
    rank_rng,
    rank_seed,
    rank_share,
    samples_per_rank,
    unwrap,
    wrap,
)

__all__ = ["destroy_distributed", "init_distributed", "rank_rng", "rank_seed",
           "rank_share", "samples_per_rank", "unwrap", "wrap"]
