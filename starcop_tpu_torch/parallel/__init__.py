"""One process per device: data-parallel training and column-sharded scenes
(counterpart of starcop_tpu/parallel)."""

from starcop_tpu_torch.parallel.launch import run_world  # noqa: F401
from starcop_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    initialize_multihost,
    make_mesh,
    replicate,
    shard_batch,
)
from starcop_tpu_torch.parallel.scene_mag1c import sharded_mag1c_scene  # noqa: F401
