"""Synthetic plume scenes and chip datasets (numpy), a copy of
starcop_tpu/data/synthetic.py's ``synthetic_scene``, ``synthetic_chip_batch``
and ``write_synthetic_chip_dataset``: the same seed gives the same arrays
and files as the JAX package (the matched filter of a dataset's mag1c
product runs on the port's device).

Radiance model: x = albedo * base_spectrum * exp(conc * template / 1e5) plus
Gaussian noise, i.e. Beer-Lambert absorption along the unit-absorption
spectrum the matched filter searches for.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Tuple

import numpy as np

from starcop_tpu_torch.device import DeviceLike

from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands


def aviris_swir_bands(step_nm: float = 5.0) -> Tuple[np.ndarray, np.ndarray]:
    """AVIRIS-NG-like band centers/FWHM inside the matched-filter window."""
    centers = np.arange(2122.0, 2488.0, step_nm)
    return centers, np.full_like(centers, 5.5)


def synthetic_scene(
    rng: np.random.Generator,
    height: int = 256,
    width: int = 256,
    n_plumes: int = 3,
    template: Optional[np.ndarray] = None,
    max_concentration: float = 4000.0,
    noise: float = 0.01,
    n_confounders: int = 0,
) -> Dict[str, np.ndarray]:
    """Synthetic (H, W, S) radiance cube with injected plumes.

    ``n_confounders`` adds rectangular patches with CH4-like absorption but a
    dark bluish RGB signature, excluded from the label.

    Returns dict with radiance (H, W, S), concentration (H, W) in ppm x m,
    label (H, W) at conc > 500 (true plumes only), rgb (H, W, 3),
    confounder_mask (H, W), and the template (S,).
    """
    if template is None:
        centers, fwhm = aviris_swir_bands()
        template = generate_template_from_bands(centers, fwhm)[:, 1]
    s = len(template)

    # Correlated albedo field (smooth terrain brightness).
    coarse = rng.uniform(0.5, 2.0, size=(height // 16 + 2, width // 16 + 2))
    yy, xx = np.mgrid[:height, :width]
    fy, fx = yy / 16.0, xx / 16.0
    i0, j0 = fy.astype(int), fx.astype(int)
    dy, dx = fy - i0, fx - j0
    albedo = (
        coarse[i0, j0] * (1 - dy) * (1 - dx)
        + coarse[i0 + 1, j0] * dy * (1 - dx)
        + coarse[i0, j0 + 1] * (1 - dy) * dx
        + coarse[i0 + 1, j0 + 1] * dy * dx
    )

    base = rng.uniform(2.0, 6.0, size=(s,)) + 0.3 * np.sin(np.linspace(0, 2, s))

    conc = np.zeros((height, width))
    for _ in range(n_plumes):
        cy, cx = rng.uniform(0.15, 0.85) * height, rng.uniform(0.15, 0.85) * width
        sy, sx = rng.uniform(4, 14), rng.uniform(8, 30)
        angle = rng.uniform(0, np.pi)
        ry = (yy - cy) * np.cos(angle) + (xx - cx) * np.sin(angle)
        rx = -(yy - cy) * np.sin(angle) + (xx - cx) * np.cos(angle)
        conc += rng.uniform(0.3, 1.0) * max_concentration * np.exp(
            -(ry**2 / (2 * sy**2) + rx**2 / (2 * sx**2))
        )

    confounder_mask = np.zeros((height, width), bool)
    conf_conc = np.zeros((height, width))
    for _ in range(n_confounders):
        ch = int(rng.uniform(6, height // 4))
        cw = int(rng.uniform(6, width // 4))
        r0 = int(rng.uniform(0, height - ch))
        c0 = int(rng.uniform(0, width - cw))
        confounder_mask[r0 : r0 + ch, c0 : c0 + cw] = True
        conf_conc[r0 : r0 + ch, c0 : c0 + cw] = rng.uniform(0.3, 1.0) * max_concentration

    total_conc = conc + conf_conc
    transmission = np.exp(total_conc[..., None] * template[None, None, :] / 1e5)
    radiance = albedo[..., None] * base[None, None, :] * transmission
    radiance = radiance + rng.normal(0, noise, size=radiance.shape)
    radiance = np.clip(radiance, 1e-3, None)

    rgb = np.stack([albedo * f for f in (55.0, 60.0, 50.0)], axis=-1)
    rgb[confounder_mask] *= np.array([0.25, 0.3, 0.55])
    rgb += rng.normal(0, 0.5, size=rgb.shape)

    return {
        "radiance": radiance.astype(np.float32),
        "concentration": conc.astype(np.float32),
        "label": (conc > 500.0).astype(np.float32),
        "rgb": np.clip(rgb, 0, None).astype(np.float32),
        "confounder_mask": confounder_mask,
        "template": np.asarray(template, np.float64),
    }


def synthetic_chip_batch(
    rng: np.random.Generator,
    batch_size: int = 8,
    size: int = 128,
    input_products: Tuple[str, ...] = (
        "mag1c",
        "TOA_AVIRIS_640nm",
        "TOA_AVIRIS_550nm",
        "TOA_AVIRIS_460nm",
    ),
) -> Dict[str, np.ndarray]:
    """A training batch dict without the matched filter: mag1c is
    approximated by the concentration plus noise. Layout (B, C, H, W)."""
    inputs, outputs, weights, has_plume = [], [], [], []
    for _ in range(batch_size):
        scene = synthetic_scene(rng, size, size, n_plumes=int(rng.integers(0, 3)))
        mag1c_proxy = np.clip(
            scene["concentration"] + rng.normal(0, 30, scene["concentration"].shape),
            0,
            10000,
        )
        chans = []
        for p in input_products:
            if p == "mag1c":
                chans.append(mag1c_proxy)
            elif p.startswith("TOA_AVIRIS_640"):
                chans.append(scene["rgb"][..., 0])
            elif p.startswith("TOA_AVIRIS_550"):
                chans.append(scene["rgb"][..., 1])
            elif p.startswith("TOA_AVIRIS_460"):
                chans.append(scene["rgb"][..., 2])
            else:
                chans.append(rng.uniform(0, 1, scene["label"].shape))
        inputs.append(np.stack(chans))
        outputs.append(scene["label"][None])
        weights.append(np.clip(mag1c_proxy / 400.0, 0.1, 1.0)[None])
        has_plume.append(float(scene["label"].sum() > 0))
    return {
        "input": np.stack(inputs).astype(np.float32),
        "output": np.stack(outputs).astype(np.float32),
        "weight_loss": np.stack(weights).astype(np.float32),
        "has_plume": np.asarray(has_plume, np.float32),
    }


def write_synthetic_chip_dataset(
    root: str,
    rng: np.random.Generator,
    n_tiles: int = 12,
    size: int = 512,
    run_matched_filter: bool = False,
    max_confounders: int = 0,
    device: DeviceLike = None,
) -> str:
    """Write a chip dataset in the framework's layout:
    root/{tile_id}/{product}.npy and root/index.csv with columns [id,
    folder, has_plume, window_col_off, window_row_off, window_width,
    window_height, qplume]. Returns the index path.

    ``run_matched_filter`` computes each tile's mag1c with
    ``mag1c_column_blocks`` (step 64, 30 iterations, alpha 1e-4) on
    ``device`` (None: the CUDA card, where the kernels run); otherwise mag1c
    is the concentration plus seeded noise and no device is used.
    """
    os.makedirs(root, exist_ok=True)
    if run_matched_filter:
        import torch

        from starcop_tpu_torch.device import float32_precision, resolve_device
        from starcop_tpu_torch.ops.mag1c import mag1c_column_blocks

        dev = resolve_device(device)
    rows = []
    for i in range(n_tiles):
        tile_id = f"synth_{i:04d}"
        folder = os.path.join(root, tile_id)
        os.makedirs(folder, exist_ok=True)
        scene = synthetic_scene(
            rng, size, size, n_plumes=int(rng.integers(0, 3)),
            n_confounders=int(rng.integers(0, max_confounders + 1)),
        )
        if run_matched_filter:
            with torch.inference_mode(), float32_precision():
                mf, _ = mag1c_column_blocks(scene["radiance"], scene["template"], None,
                                            column_step=64, num_iter=30, alpha=1e-4,
                                            device=dev)
            mag1c = np.clip(mf.cpu().numpy(), 0, 10000)
        else:
            mag1c = np.clip(
                scene["concentration"]
                + np.abs(np.random.default_rng(i).normal(0, 30, scene["concentration"].shape)),
                0,
                10000,
            ).astype(np.float32)
        products = {
            "mag1c": mag1c,
            "TOA_AVIRIS_640nm": scene["rgb"][..., 0],
            "TOA_AVIRIS_550nm": scene["rgb"][..., 1],
            "TOA_AVIRIS_460nm": scene["rgb"][..., 2],
            "labelbinary": scene["label"],
            "weight_mag1c": np.clip(mag1c / 400.0, 0.1, 1.0),
        }
        for name, arr in products.items():
            np.save(os.path.join(folder, f"{name}.npy"), arr.astype(np.float32))
        rows.append(
            {
                "id": tile_id,
                "folder": folder,
                "has_plume": bool(scene["label"].sum() > 0),
                "window_col_off": 0,
                "window_row_off": 0,
                "window_width": size,
                "window_height": size,
                "qplume": float(scene["concentration"].sum()),
            }
        )
    index = os.path.join(root, "index.csv")
    with open(index, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    return index
