"""Matched filter, CH4 template, band ratios, morphology, padding, and the
hand-written CUDA kernels (counterpart of starcop_tpu/ops).

The names below are JAX's re-exports (starcop_tpu/ops/__init__.py). The
kernels (``mag1c_kernels``, ``mag1c_fused``) are built at their first
launch on a card, never on import. ``spd_inverse_newton`` is exported
from ``ops.mag1c``, as JAX exports it.
"""

from starcop_tpu_torch.ops.ch4_template import (  # noqa: F401
    generate_template_from_bands,
    get_mask_bad_bands,
    load_ch4_lut,
)
from starcop_tpu_torch.ops.mag1c import (  # noqa: F401
    SCALING,
    NODATA,
    EPSILON,
    rmf,
    acrwl1mf,
    mag1c_column_blocks,
)
from starcop_tpu_torch.ops.ratios import (  # noqa: F401
    weight_mag1c,
    ratio_2c_match_c_from_sums_outlier,
    ratio_mlr_local,
    lr_bands,
)
from starcop_tpu_torch.ops.morphology import (  # noqa: F401
    erosion,
    dilation,
    binary_opening,
    CROSS_KERNEL,
)
from starcop_tpu_torch.ops.padding import find_padding, padded_apply  # noqa: F401
