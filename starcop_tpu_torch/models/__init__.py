"""The segmentation networks (U-Nets, the MobileNetV2 U-Net, tiny CNNs),
the segmenter, the classical threshold baselines, and weight carry-over
(counterpart of starcop_tpu/models).

The names below are JAX's re-exports (starcop_tpu/models/__init__.py) but
one: JAX's ``cast_variables_for_inference`` returns a cast variable tree,
while the port's ``cast_for_inference`` (models/segmenter.py) casts a
``SegmentationModel`` in place, so it keeps its own name.
"""

from starcop_tpu_torch.models.unet import UNet, UNetDropout  # noqa: F401
from starcop_tpu_torch.models.mobilenet_unet import MobileNetV2UNet  # noqa: F401
from starcop_tpu_torch.models.simple import (  # noqa: F401
    SingleConv,
    SimpleCNN,
    SimpleCNNRegression,
)
from starcop_tpu_torch.models.segmenter import (  # noqa: F401
    SegmentationModel,
    cast_for_inference,
    configure_architecture,
    differences,
    pred_classification,
)
from starcop_tpu_torch.models.baselines import (  # noqa: F401
    Mag1cBaseline,
    SanchezBaseline,
    VaronBaseline,
)
