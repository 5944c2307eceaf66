"""Detection-quality probe: matched filter -> validation F1 (counterpart of
starcop_tpu/eval/synthetic_eval.py).

Mask agreement with the float64 oracle is a similarity metric; a regression
that moved detections coherently could keep it high while detection quality
fell. This probe runs the validation harness on a fixed, seeded synthetic
eval set whose ``mag1c`` product comes from the production matched filter
(on the card, the hand-written kernels ``init_stats``, ``filter_round`` and
``filter_glue``), and reports the best F1 over a mag1c-scaled threshold
sweep. The default geometry is the bench headline's: 1280 x 1242, the
2122-2488 nm / 7.4 nm band set, column_step 54, 30 iterations, alpha 1e-4.
tests/test_data_train_eval.py::test_synthetic_detection_f1_pinned pins the
expected range on 2 x 256 x 216.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from starcop_tpu_torch.device import DeviceLike, float32_precision, resolve_device

#: mag1c-scaled sweep (ppm x m) bracketing the reference's 500 operating
#: point on both sides.
MAG1C_THRESHOLDS: Sequence[float] = (100.0, 200.0, 300.0, 400.0, 500.0,
                                     750.0, 1000.0, 1500.0)

#: The chip batch protocol's products: mag1c and the RGB radiance.
PRODUCTS = ("mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm")


def default_template() -> np.ndarray:
    """The bench headline's EMIT-like band set: ~7.4 nm sampling inside the
    matched-filter window, FWHM 8 nm."""
    from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands

    centers = np.arange(2122.0, 2488.0, 7.4)
    return generate_template_from_bands(centers, np.full_like(centers, 8.0))[:, 1]


def synthetic_eval_batch(mf: torch.Tensor, scene: Dict[str, np.ndarray],
                         index: int) -> Dict:
    """One tile of the eval set as a batch of one, on mf's device: input
    (1, 4, H, W) = [mag1c clipped to [0, 10000], R, G, B], the label as
    output, unit loss weights."""
    dev = mf.device
    rgb = torch.as_tensor(np.moveaxis(scene["rgb"], -1, 0), device=dev)
    x = torch.cat([mf.clamp(0, 10000)[None], rgb])[None].float()
    y = torch.as_tensor(scene["label"], device=dev)[None, None]
    return {"input": x, "output": y, "weight_loss": torch.ones_like(y),
            "has_plume": np.asarray([scene["label"].sum() > 0]),
            "id": [f"synth_f1_{index:02d}"]}


def f1_by_threshold(metrics: Dict) -> Dict[float, float]:
    """F1 at each threshold of a validation sweep; raises if the eval set
    carries no label-positive pixel (the probe would be vacuous). The
    confusion matrices are [[tn, fp], [fn, tp]], so row 1 sums the label
    positives."""
    f1 = {}
    positives = False
    for entry in metrics["thresholded"]:
        positives |= bool(np.asarray(entry["confusion_matrix"])[1].sum() > 0)
        p, r = entry["precision"], entry["recall"]
        f1[float(entry["threshold"])] = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    if not positives:
        raise RuntimeError("synthetic eval set carries no label-positive pixels — "
                           "the F1 probe would be vacuous")
    return f1


def synthetic_detection_f1(
    n_tiles: int = 2,
    height: int = 1280,
    width: int = 1242,
    seed: int = 42,
    thresholds: Sequence[float] = MAG1C_THRESHOLDS,
    column_step: int = 54,
    num_iter: int = 30,
    alpha: float = 1e-4,
    template: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Best F1 of the mag1c threshold baseline on the fixed synthetic set.

    Makes ``n_tiles`` seeded scenes (``synthetic_scene``, 3 plumes each),
    runs ``mag1c_column_blocks`` on each at the given settings on
    ``device``, and the validation harness with ``Mag1cBaseline``
    (threshold + opening) over ``thresholds``.

    Returns {"synthetic_f1": best F1 over the sweep,
             "synthetic_f1_at_500": F1 at the reference's 500 ppm x m},
    each rounded to 4 decimals.
    """
    from starcop_tpu_torch.data.synthetic import synthetic_scene
    from starcop_tpu_torch.eval.validation import run_validation
    from starcop_tpu_torch.models.baselines import Mag1cBaseline
    from starcop_tpu_torch.ops.mag1c import mag1c_column_blocks

    dev = resolve_device(device)
    if template is None:
        template = default_template()
    rng = np.random.default_rng(seed)

    def batches():
        for i in range(n_tiles):
            scene = synthetic_scene(rng, height, width, n_plumes=3, template=template)
            mf, _ = mag1c_column_blocks(scene["radiance"], template, None,
                                        column_step=column_step, num_iter=num_iter,
                                        alpha=alpha, device=dev)
            yield synthetic_eval_batch(mf, scene, i)

    bl = Mag1cBaseline(list(PRODUCTS)).to(dev)
    with torch.inference_mode(), float32_precision():
        _, metrics = run_validation(bl.batch_with_preds, batches(),
                                    thresholds=list(thresholds),
                                    apply_threshold=bl.apply_threshold)
    f1 = f1_by_threshold(metrics)
    return {"synthetic_f1": round(max(f1.values()), 4),
            "synthetic_f1_at_500": round(f1.get(500.0, 0.0), 4)}
