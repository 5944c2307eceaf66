"""Serving: the threaded read | compute | write pipeline over granules
(counterpart of starcop_tpu/serve; the names below are its re-exports)."""

from starcop_tpu_torch.serve.pipeline import ScenePipeline, SceneResult  # noqa: F401
