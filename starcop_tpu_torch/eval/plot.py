"""Plot registry and batch plotting grids (counterpart of
starcop_tpu/eval/plot.py).

A registry mapping product names to plot functions; ``plot_batch`` renders
a (samples x products) matplotlib grid, resolving each product from the
batch's keys or its normalised input channels; the differences map uses the
TN / FN / FP / TP colour legend. ``ImageLogger`` writes the grid of one
fixed batch at each epoch end. matplotlib is imported only when a grid is
drawn; the batch's tensors are copied to the host first.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# Categorical colors for the differences map {0 TN, 1 FN, 2 FP, 3 TP}
# (reference plot.py:57-63 conventions: clear, orange-ish FN, red FP, green TP).
DIFFERENCES_COLORS = np.array(
    [
        [0, 0, 0, 0],  # TN transparent/black
        [1.0, 0.64, 0.0, 1.0],  # FN orange
        [0.86, 0.08, 0.24, 1.0],  # FP crimson
        [0.0, 0.69, 0.31, 1.0],  # TP green
    ]
)
DIFFERENCES_LABELS = ["TN", "FN", "FP", "TP"]


def mask_to_rgb(mask: np.ndarray, values: Sequence[int], colors: np.ndarray) -> np.ndarray:
    """Categorical (H, W) -> (H, W, C) color map."""
    out = np.zeros(mask.shape + (colors.shape[1],), dtype=colors.dtype)
    for v, c in zip(values, colors):
        out[mask == v] = c
    return out


def _first_channels(batch: Dict, key: str, idx: int, n: int = 1) -> np.ndarray:
    arr = np.asarray(batch[key])[idx]
    return arr[:n] if arr.ndim == 3 else arr[None][:n]


def _imshow_gray(ax, img, vmin=0, vmax=1, cmap="viridis"):
    ax.imshow(img, vmin=vmin, vmax=vmax, cmap=cmap, interpolation="nearest")


def _plot_rgb(batch, idx, ax, input_products=None):
    if "rgb_aviris" in batch:
        rgb = np.asarray(batch["rgb_aviris"])[idx]
    else:
        names = ["TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm"]
        chans = [input_products.index(n) for n in names]
        rgb = np.asarray(batch["input"])[idx][chans] / 50.0
    ax.imshow(np.clip(np.moveaxis(rgb, 0, -1), 0, 1), interpolation="nearest")


def _plot_mag1c(batch, idx, ax, input_products=None):
    if "mag1c" in batch:
        img = np.asarray(batch["mag1c"])[idx][0]
    else:
        img = np.asarray(batch["input"])[idx][input_products.index("mag1c")]
    _imshow_gray(ax, img, vmin=0, vmax=1750, cmap="magma")


def _plot_label(batch, idx, ax, input_products=None):
    _imshow_gray(ax, np.asarray(batch["output_norm"])[idx][0], cmap="gray")


def _plot_pred(batch, idx, ax, input_products=None):
    _imshow_gray(ax, np.asarray(batch["prediction"])[idx][0], cmap="inferno")


def _plot_pred_binary(batch, idx, ax, input_products=None):
    _imshow_gray(ax, np.asarray(batch["pred_binary"])[idx][0], cmap="gray")


def plot_differences(batch, idx, ax, input_products=None, legend: bool = True):
    diff = np.asarray(batch["differences"])[idx][0]
    ax.imshow(mask_to_rgb(diff, [0, 1, 2, 3], DIFFERENCES_COLORS), interpolation="nearest")
    if legend:
        import matplotlib.patches as mpatches

        handles = [
            mpatches.Patch(color=DIFFERENCES_COLORS[i][:3], label=DIFFERENCES_LABELS[i])
            for i in range(1, 4)
        ]
        ax.legend(handles=handles, loc="upper right", fontsize=6)


def _plot_loss(batch, idx, ax, input_products=None):
    key = "loss_per_pixel_weighted" if "loss_per_pixel_weighted" in batch else "loss_per_pixel"
    img = np.asarray(batch[key])[idx][0]
    ax.imshow(img, cmap="hot", interpolation="nearest")


def _plot_weight(batch, idx, ax, input_products=None):
    _imshow_gray(ax, np.asarray(batch["weight_loss"])[idx][0], cmap="cividis")


def _input_channel_plotter(product: str):
    def plot(batch, idx, ax, input_products=None):
        if product in batch:
            img = np.asarray(batch[product])[idx][0]
        else:
            img = np.asarray(batch["input_norm"])[idx][input_products.index(product)]
        _imshow_gray(ax, img, vmin=-1, vmax=2)

    return plot


PLOTTING_FUNCTIONS: Dict[str, Dict] = {
    "rgb_aviris": {"function": _plot_rgb},
    "mag1c": {"function": _plot_mag1c},
    "label": {"function": _plot_label},
    "output": {"function": _plot_label},
    "pred": {"function": _plot_pred},
    "prediction": {"function": _plot_pred},
    "pred_binary": {"function": _plot_pred_binary},
    "differences": {"function": plot_differences},
    "loss_per_pixel": {"function": _plot_loss},
    "weight_loss": {"function": _plot_weight},
}

# Every normalized input product is plottable by name.
from starcop_tpu_torch.data.normalizer import BAND_NORMALIZATION as _BN  # noqa: E402

for _p in _BN:
    PLOTTING_FUNCTIONS.setdefault(_p, {"function": _input_channel_plotter(_p)})


def _multi_channel_plotter(products: List[str]):
    """False-color composite of 3 normalized input channels."""

    def plot(batch, idx, ax, input_products=None):
        chans = []
        for p in products:
            if p in batch:
                chans.append(np.asarray(batch[p])[idx][0])
            else:
                chans.append(
                    np.asarray(batch["input_norm"])[idx][input_products.index(p)]
                )
        rgb = np.stack(chans, axis=-1)
        ax.imshow(np.clip(rgb, 0, 1), interpolation="nearest")

    return plot


# The reference's full named-product registry, entry for entry
# (starcop/plot.py:98-188 upstream). Composites map to their 3 input
# channels; single-product entries to the named normalized channel. Note: the
# reference maps s2_b2..b4 to TOA_S2B_B1 (an upstream copy-paste slip); here
# each s2_bN plots its own band.
_REFERENCE_NAMED_ENTRIES: Dict[str, List[str]] = {
    "rgb_s2a": ["TOA_S2A_B4", "TOA_S2A_B3", "TOA_S2A_B2"],
    "swirnirred_s2a": ["TOA_S2A_B11", "TOA_S2A_B8", "TOA_S2A_B4"],
    "aviris_ratios_first": ["ratio_aviris_2350_2310_out"],
    "aviris_ratios_second": ["ratio_aviris_2350_2360_out"],
    "aviris_ratios_third": ["ratio_aviris_2360_2310_out"],
    "wv3_ratios_varon_b7b5": ["ratio_wv3_B7_B5_varon21_sum_c_out"],
    "wv3_ratios_varon_b8b5": ["ratio_wv3_B8_B5_varon21_sum_c_out"],
    "wv3_ratios_varon_b7b6": ["ratio_wv3_B7_B6_varon21_sum_c_out"],
    "wv3_ratios_sanchez_b7b7mlr": ["ratio_wv3_B7_B7MLR_SanchezGarcia22_sum_c_out"],
    "wv3_ratios_sanchez_b8b8mlr": ["ratio_wv3_B8_B8MLR_SanchezGarcia22_sum_c_out"],
    "wv3_ratios_sanchez_b7b7mlr_v2": ["ratio_wv3_B7_B7MLR_SanchezGarcia22_simplediv"],
    "wv3_ratios_sanchez_b8b8mlr_v2": ["ratio_wv3_B8_B8MLR_SanchezGarcia22_simplediv"],
    "wv3_lrn_bands2band8only_60ep_512_l1": ["ratio_lrn_bands2band8only_60ep_512_l1"],
    "wv3_mixSanchez_b7b7mlr_fromS2_9b": ["ratio_wv3_B7_B7MLR_fromS2_9bands_sum_c_out"],
    "wv3_mixSanchez_b7b7mlr_fromS2_5b": ["ratio_wv3_B7_B7MLR_fromS2_5bands_sum_c_out"],
    "wv3_mixSanchez_b8b8mlr_fromS2_9b": ["ratio_wv3_B8_B8MLR_fromS2_9bands_sum_c_out"],
    "wv3_mixSanchez_b8b8mlr_fromS2_5b": ["ratio_wv3_B8_B8MLR_fromS2_5bands_sum_c_out"],
    "s2_b1": ["TOA_S2B_B1"],
    "s2_b2": ["TOA_S2B_B2"],
    "s2_b3": ["TOA_S2B_B3"],
    "s2_b4": ["TOA_S2B_B4"],
    **{f"wv3_b{i}": [f"TOA_WV3_SWIR{i}"] for i in range(1, 9)},
}

for _name, _products in _REFERENCE_NAMED_ENTRIES.items():
    PLOTTING_FUNCTIONS.setdefault(
        _name,
        {
            "function": (
                _multi_channel_plotter(_products)
                if len(_products) == 3
                else _input_channel_plotter(_products[0])
            ),
            "input_products": _products,
        },
    )


def plot_batch(
    batch: Dict,
    input_products: Sequence[str],
    products_plot: Sequence[str],
    figsize_ax=(4, 4),
    max_samples: Optional[int] = None,
):
    """Render a (batch x products) grid figure from an enriched batch."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    bsz = np.asarray(batch["input"]).shape[0]
    if max_samples:
        bsz = min(bsz, max_samples)
    ncols = len(products_plot)
    fig, axes = plt.subplots(
        bsz, ncols, figsize=(figsize_ax[0] * ncols, figsize_ax[1] * bsz), squeeze=False
    )
    for i in range(bsz):
        for j, product in enumerate(products_plot):
            ax = axes[i][j]
            if product not in PLOTTING_FUNCTIONS:
                ax.axis("off")
                continue
            try:
                PLOTTING_FUNCTIONS[product]["function"](
                    batch, i, ax, input_products=list(input_products)
                )
            except (KeyError, ValueError, IndexError):
                ax.axis("off")
                continue
            if i == 0:
                ax.set_title(product, fontsize=8)
            ax.set_xticks([]), ax.set_yticks([])
    fig.tight_layout()
    return fig


def to_host(batch: Dict) -> Dict:
    """The batch with its tensors as numpy arrays (f32 for bf16)."""
    import torch

    def host(v):
        if not isinstance(v, torch.Tensor):
            return v
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()

    return {k: host(v) for k, v in batch.items()}


class ImageLogger:
    """Epoch-end image logging callback: holds one fixed batch; at each
    epoch end runs ``batch_with_preds`` on it (eval mode, no gradients) and
    writes the plot grid to ``out_dir/epoch_{n}.png``."""

    def __init__(self, model, batch: Dict, input_products: Sequence[str],
                 products_plot: Sequence[str], out_dir: str):
        self.model = model
        self.batch = batch
        self.input_products = list(input_products)
        self.products_plot = list(products_plot)
        self.out_dir = out_dir

    def on_epoch_end(self, trainer, state, epoch: int):
        import os

        import matplotlib.pyplot as plt
        import torch

        self.model.eval()
        with torch.no_grad():
            enriched = to_host(self.model.batch_with_preds(self.batch))
        fig = plot_batch(enriched, self.input_products, self.products_plot, max_samples=8)
        os.makedirs(self.out_dir, exist_ok=True)
        fig.savefig(os.path.join(self.out_dir, f"epoch_{epoch}.png"), format="png", dpi=72)
        plt.close(fig)
