"""Utilities: profiling and tracing, the storage seam (counterpart of
starcop_tpu/utils)."""

from starcop_tpu_torch.utils.profiling import StageTimer, trace  # noqa: F401
