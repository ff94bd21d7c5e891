"""Distribution: the logical-axis sharding rules (``sharding``, the port of
the reference's ``repro.distributed``), the training meshes (``mesh``:
``LogicalMesh``, ``TrainMesh``) and the port's layout mechanics on a
training mesh (``layout``): a rank's blocks, gathers and gradient
reductions over ``torch.distributed``."""
from .sharding import (
    Ruleset,
    axis_size,
    batch_specs,
    data_shards,
    decode_state_spec,
    default_rules,
    shard_params_spec,
    slot_batch_spec,
    specs_from_axes,
)

__all__ = [
    "Ruleset",
    "batch_specs",
    "decode_state_spec",
    "default_rules",
    "shard_params_spec",
    "specs_from_axes",
    "axis_size",
    "data_shards",
    "slot_batch_spec",
]
