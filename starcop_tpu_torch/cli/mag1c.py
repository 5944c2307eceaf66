"""Matched-filter CLI: radiance cube -> mag1c and albedo rasters, on the CUDA card.

    python -m starcop_tpu_torch.cli.mag1c scene.npy --output mf.tif \
        [--glt glt.npy] [--wavelengths w.npy --fwhm f.npy] [--column-step 32] \
        [--albedo-output albedo.tif] [--num-iter 30] [--alpha 1e-4] [--device cpu]

The counterpart of starcop_tpu/cli/mag1c.py, with its flags. The cube is an
(H, W, S) .npy. With ``--glt`` (an (H, W) .npy of detector sample ids) the
scene is filtered by detector column group (``run_mag1c_scene``: the band
mask, the 2122-2488 nm window, the template); without it, in
``--column-step``-wide column blocks on every band (``mag1c_column_blocks``).
Without ``--wavelengths`` the bands are taken as an even AVIRIS-NG grid over
2122-2488 nm. The output's extension picks the format: .tif a tiled GeoTIFF
with the wavelength tags, .npy a bare array. ``--device cpu`` runs the plain
torch twins on the host instead of the card. Prints the scene's wall time.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("radiance", help=".npy radiance cube (H, W, S)")
    p.add_argument("--output", required=True, help="output .tif/.npy for the mf raster")
    p.add_argument("--albedo-output", default=None)
    p.add_argument("--wavelengths", default=None, help=".npy (S,) band centers [nm]")
    p.add_argument("--fwhm", default=None, help=".npy (S,) band FWHM [nm]")
    p.add_argument("--glt", default=None, help=".npy (H, W) detector sample ids")
    p.add_argument("--column-step", type=int, default=32)
    p.add_argument("--num-iter", type=int, default=30)
    p.add_argument("--alpha", type=float, default=1e-4)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu = the plain torch path on the host (no card needed)")
    args = p.parse_args(argv)

    from starcop_tpu_torch.data.geotiff import save_raster

    t0 = time.time()
    cube = np.load(args.radiance)
    if args.wavelengths:
        wavelengths = np.load(args.wavelengths)
        fwhm = np.load(args.fwhm) if args.fwhm else np.full(len(wavelengths), 5.5)
    else:
        wavelengths = np.linspace(2122.0, 2488.0, cube.shape[-1])
        fwhm = np.full(len(wavelengths), 5.5)

    if args.glt:
        from starcop_tpu_torch.scenes.aviris_pipeline import run_mag1c_scene

        mf, albedo = run_mag1c_scene(cube, wavelengths, fwhm, glt_samples=np.load(args.glt),
                                     num_iter=args.num_iter, alpha=args.alpha,
                                     device=args.device)
    else:
        from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands
        from starcop_tpu_torch.ops.mag1c import mag1c_column_blocks

        template = generate_template_from_bands(wavelengths, fwhm)[:, 1]
        mf_t, albedo_t = mag1c_column_blocks(cube, template, None, column_step=args.column_step,
                                             num_iter=args.num_iter, alpha=args.alpha,
                                             device=args.device)
        mf, albedo = mf_t.cpu().numpy(), albedo_t.cpu().numpy()

    wave_tags = {"wavelengths": ",".join(f"{w:.1f}" for w in np.asarray(wavelengths)),
                 "mag1c": "acfwl1mf"}
    save_raster(args.output, mf.astype(np.float32), nodata=-9999.0, tags=wave_tags,
                descriptions=["CH4 Absorption (ppm x m)"])
    if args.albedo_output:
        save_raster(args.albedo_output, albedo.astype(np.float32), nodata=-9999.0,
                    tags=wave_tags, descriptions=["Albedo"])
    print(f"mag1c {args.radiance} -> {args.output}: {time.time() - t0:.2f}s "
          f"(shape {mf.shape}, max {np.nanmax(mf):.0f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
