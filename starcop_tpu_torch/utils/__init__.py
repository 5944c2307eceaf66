"""Utilities: profiling and tracing, the storage seam (counterpart of
starcop_tpu/utils). JAX's ``enable_persistent_compilation_cache`` has no
counterpart: the kernels' build cache is ``ops/_build.py``'s."""

from starcop_tpu_torch.utils.profiling import StageTimer, trace  # noqa: F401
