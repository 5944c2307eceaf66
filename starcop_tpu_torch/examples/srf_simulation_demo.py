"""SRF-simulation validation demo: AVIRIS -> Sentinel-2 / WorldView-3.

An executable counterpart of the reference's
``simulate_aviris_2_sentinel2.ipynb`` (SRF simulation checked against a
real S2 SAFE scene, which is not available offline): builds a synthetic
full-VSWIR AVIRIS-like cube with known spectral structure, simulates
S2A / WV3 views through the shipped tabulated SRFs on the device, and
renders

  * the SRF curves per sensor,
  * the simulated band images,
  * a per-band consistency check: a spectrally flat scene maps to the
    same constant in every band (normalised weights), and the S2A / S2B
    B12 responses differ (per-unit tables).

    python -m starcop_tpu_torch.examples.srf_simulation_demo [out_dir] [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np


def main(out_dir=None, device=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from starcop_tpu_torch.data import sensors
    from starcop_tpu_torch.data.srf import get_srf, srf_table_weights
    from starcop_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    out_dir = out_dir or tempfile.mkdtemp(prefix="starcop_srf")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)

    # Synthetic AVIRIS-like cube: smooth continuum + absorption features,
    # 5 nm sampling over the full VSWIR range.
    wl = np.arange(400.0, 2500.0, 5.0)
    h = w = 96
    continuum = 2.0 + 1.5 * np.exp(-((wl - 800.0) ** 2) / (2 * 500.0**2))
    absorption = 1.0 - 0.35 * np.exp(-((wl - 2200.0) ** 2) / (2 * 60.0**2))
    albedo = rng.uniform(0.4, 1.6, size=(h, w, 1))
    cube = (albedo * (continuum * absorption)[None, None, :]).astype(np.float32)

    # --- SRF curves -------------------------------------------------------
    fig, axes = plt.subplots(3, 1, figsize=(10, 8), sharex=True)
    for ax, sensor in zip(axes, ("S2A", "S2B", "WV3")):
        swl, svals, names = get_srf(sensor)
        for j in range(len(names)):
            ax.plot(swl, svals[:, j], lw=0.8)
        ax.set_ylabel(sensor)
    axes[-1].set_xlabel("wavelength [nm]")
    fig.suptitle("Shipped tabulated SRFs (super-Gaussian, per-unit centers)")
    fig.tight_layout()
    srf_png = os.path.join(out_dir, "srf_curves.png")
    fig.savefig(srf_png, dpi=110)
    plt.close(fig)

    # --- Simulations ------------------------------------------------------
    s2a, s2a_bands = sensors.transform_to_sentinel_2(cube, wl, sensor="S2A", device=dev)
    wv3, wv3_bands = sensors.transform_to_worldview_3(cube, wl, device=dev)
    s2a, wv3 = s2a.cpu().numpy(), wv3.cpu().numpy()
    print(f"S2A bands {s2a_bands}: {s2a.shape}")
    print(f"WV3 bands {wv3_bands}: {wv3.shape}")

    fig, axes = plt.subplots(2, 8, figsize=(18, 5))
    for j in range(8):
        axes[0, j].imshow(s2a[j], cmap="viridis")
        axes[0, j].set_title(f"S2A {s2a_bands[j]}", fontsize=8)
        axes[1, j].imshow(wv3[j], cmap="viridis")
        axes[1, j].set_title(f"WV3 {wv3_bands[j]}", fontsize=8)
        for ax in (axes[0, j], axes[1, j]):
            ax.set_xticks([]), ax.set_yticks([])
    fig.tight_layout()
    bands_png = os.path.join(out_dir, "simulated_bands.png")
    fig.savefig(bands_png, dpi=110)
    plt.close(fig)

    # --- Consistency checks ----------------------------------------------
    flat = np.full((8, 8, len(wl)), 3.0, np.float32)
    wv3_flat, _ = sensors.transform_to_worldview_3(flat, wl, device=dev)
    if not np.allclose(wv3_flat.cpu().numpy(), 3.0, rtol=1e-5):
        raise AssertionError("weights not normalized")
    w_a, _ = srf_table_weights(wl, "S2A", bands=["B12"])
    w_b, _ = srf_table_weights(wl, "S2B", bands=["B12"])
    com_a = float((wl * w_a[:, 0]).sum())
    com_b = float((wl * w_b[:, 0]).sum())
    print(f"B12 center of mass: S2A {com_a:.1f} nm vs S2B {com_b:.1f} nm "
          f"(per-unit split: {com_a - com_b:+.1f} nm)")
    if not com_a > com_b:
        raise AssertionError("S2A's B12 should sit above S2B's")
    # The 2200 nm absorption depresses the bands covering it (WV3 SWIR6)
    # relative to a band outside it (SWIR2 at 1571 nm).
    i6, i2 = wv3_bands.index("SWIR6"), wv3_bands.index("SWIR2")
    ratio = float((wv3[i6] / wv3[i2]).mean())
    print(f"SWIR6/SWIR2 mean ratio {ratio:.3f} (absorption visible: < continuum ratio)")
    print(f"wrote {srf_png} and {bands_png}")
    return out_dir


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="AVIRIS -> S2 / WV3 SRF simulation demo")
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args()
    main(args.out_dir, device=args.device)
