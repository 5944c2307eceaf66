"""starcop_tpu_torch: the PyTorch/CUDA port of starcop_tpu for NVIDIA Hopper.

Module names mirror the JAX package (``starcop_tpu``), which stays the
reference: each module here names its counterpart. The port imports torch
and never jax, flax or starcop_tpu. Entry points take ``device=None``
(the CUDA card) and raise without one unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
