"""Synthetic plume scenes (numpy), a copy of starcop_tpu/data/synthetic.py's
``synthetic_scene``: the same seed gives the same arrays as the JAX package.

Radiance model: x = albedo * base_spectrum * exp(conc * template / 1e5) plus
Gaussian noise, i.e. Beer-Lambert absorption along the unit-absorption
spectrum the matched filter searches for.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

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
