"""Multi-stream execution, with the stream axis sharded over devices."""

from motcpp_tpu_torch.parallel.collectives import (
    Mesh,
    emission_stats,
    per_stream_emissions,
    shard_over_streams,
)
from motcpp_tpu_torch.parallel.streams import (
    MultiStreamRunner,
    make_rollout,
    make_rollout_embs,
    make_rollout_general,
)

__all__ = [
    "Mesh",
    "MultiStreamRunner",
    "make_rollout",
    "make_rollout_embs",
    "make_rollout_general",
    "emission_stats",
    "per_stream_emissions",
    "shard_over_streams",
]
