"""Full-scene pipelines: raw sensor data -> enhancement -> plume masks
(counterpart of starcop_tpu/scenes; the names below are its re-exports)."""

from starcop_tpu_torch.scenes.emit_pipeline import emit_inference, emit_mag1c  # noqa: F401
from starcop_tpu_torch.scenes.aviris_pipeline import run_mag1c_groups  # noqa: F401
