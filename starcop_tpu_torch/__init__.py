"""starcop_tpu_torch: the PyTorch/CUDA port of starcop_tpu for NVIDIA Hopper.

Module names mirror the JAX package (``starcop_tpu``), which stays the
reference: each module here names its counterpart. The port imports torch
and never jax, flax or starcop_tpu. Entry points take ``device=None``
(the CUDA card) and raise without one unless the caller passes
``device="cpu"``.

Each subpackage re-exports the names its JAX counterpart's ``__init__``
does, with two exceptions: ``models.cast_variables_for_inference`` is
``models.cast_for_inference`` (it casts a module in place rather than
returning a cast variable tree), and ``utils.enable_persistent_compilation_cache``
has no counterpart (the kernels' build cache is ``ops/_build.py``'s).
Importing a subpackage builds no kernel. The examples
(``python -m starcop_tpu_torch.examples.<name>``) and the experiments
(``starcop_tpu_torch.experiments``) are the JAX package's ``examples/``
and ``experiments/``.
"""

__version__ = "0.1.0"

from starcop_tpu_torch import config as config  # noqa: F401
