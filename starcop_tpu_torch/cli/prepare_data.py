"""Dataset production CLI (counterpart of starcop_tpu/cli/prepare_data.py):
scenes -> matched filter -> sensor simulations -> window statistics ->
negative mining -> chips.

    python -m starcop_tpu_torch.cli.prepare_data --synthetic 2 --output OUT [--device cpu]
    python -m starcop_tpu_torch.cli.prepare_data --scenes-dir D --output OUT

For each scene, ``process_scene`` uploads the cube once and runs on the
device the unmasked matched filter (``mag1c_column_blocks``, column step 32,
30 iterations, alpha 1e-4: the CUDA kernels ``init_stats``,
``filter_round`` and ``filter_glue`` on the card) over the kept bands in
2122-2488 nm, and the WorldView-3 and Sentinel-2A / 2B simulations of the
bands the cube covers; it writes them as GeoTIFFs with the scene's
transform and CRS. Then ``main`` computes every scene's sliding-window
mag1c statistics (``stats_mag1c.json``), mines hard and random negatives
over the unlabelled scenes, adds the high-mag1c windows of labelled scenes
as plume candidates, and caches the chips (``chips/index.csv``, each chip
with its window's geotransform). The files and their layout are the JAX
CLI's, so either package's training reads them. Existing scene products
are kept (idempotent reruns).

Scenes come from ``--scenes-dir`` ({name}.npy radiance cubes with optional
{name}_wl.npy, _fwhm.npy, _label.npy, _rgb.npy and _geo.json) or
``--synthetic N`` (N synthetic 1024 x 640 scenes on a Permian-basin UTM 13N
grid). ``--device`` picks the device (default: the CUDA card, which must be
there; ``cpu`` runs the kernels' plain twins).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

MF_WINDOW_NM = (2122.0, 2488.0)  # the matched filter's wavelength window


def process_scene(scene_dir: str, name: str, cube, wavelengths, fwhm,
                  label_rgba=None, column_step: int = 32,
                  transform=None, crs_epsg=None, device=None) -> dict:
    """Matched filter and sensor simulations of one (H, W, K) scene (array
    or tensor) on ``device``; writes {scene_dir}/{mag1c,albedo,wv3,s2a,s2b}
    .tif (and label_rgba.tif) with the scene's transform / CRS and the
    wavelength tags, skipping products already there. Returns the product
    paths by name."""
    import torch

    from starcop_tpu_torch.data import sensors
    from starcop_tpu_torch.data.geotiff import write_geotiff
    from starcop_tpu_torch.device import resolve_device
    from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands, get_mask_bad_bands
    from starcop_tpu_torch.ops.mag1c import mag1c_column_blocks

    dev = resolve_device(device)
    os.makedirs(scene_dir, exist_ok=True)
    outputs = {}
    geo = {"transform": transform, "crs_epsg": crs_epsg}
    uploaded = []

    def on_device():
        """The cube on the device, uploaded at its first use only."""
        if not uploaded:
            uploaded.append(torch.as_tensor(cube, dtype=torch.float32, device=dev))
        return uploaded[0]

    mf_path = os.path.join(scene_dir, "mag1c.tif")
    if not os.path.exists(mf_path):
        keep = get_mask_bad_bands(wavelengths)
        keep &= (wavelengths >= MF_WINDOW_NM[0]) & (wavelengths <= MF_WINDOW_NM[1])
        template = generate_template_from_bands(wavelengths[keep], fwhm[keep])[:, 1]
        keep_idx = torch.as_tensor(np.flatnonzero(keep), device=dev)
        mf, albedo = mag1c_column_blocks(
            on_device().index_select(2, keep_idx), template, None,
            column_step=column_step, num_iter=30, alpha=1e-4, device=dev,
        )
        wave_tag = ",".join(f"{w:.1f}" for w in np.asarray(wavelengths)[keep])
        for path, arr, desc in ((mf_path, mf, "CH4 Absorption (ppm x m)"),
                                (os.path.join(scene_dir, "albedo.tif"), albedo, "Albedo")):
            write_geotiff(path, arr.cpu().numpy().astype(np.float32), nodata=-9999.0,
                          tags={"wavelengths": wave_tag, "mag1c": "acfwl1mf"},
                          descriptions=[desc], **geo)
    outputs["mag1c"] = mf_path

    wv3_bands = sensors.covered_bands(wavelengths, sensors.WV3_SWIR_CENTERS_FWHM)
    wv3_path = os.path.join(scene_dir, "wv3.tif")
    if wv3_bands and not os.path.exists(wv3_path):
        wv3, _ = sensors.transform_to_worldview_3(on_device(), wavelengths, bands=wv3_bands,
                                                  device=dev)
        write_geotiff(wv3_path, wv3.cpu().numpy().astype(np.float32),
                      descriptions=list(wv3_bands), **geo)
        with open(os.path.join(scene_dir, "wv3_bands.json"), "w") as fh:
            json.dump(wv3_bands, fh)
    outputs["wv3"] = wv3_path

    s2_bands = sensors.covered_bands(wavelengths, sensors.S2_BAND_CENTERS_FWHM)
    for sensor in ("S2A", "S2B"):
        s2_path = os.path.join(scene_dir, f"{sensor.lower()}.tif")
        if s2_bands and not os.path.exists(s2_path):
            s2, _ = sensors.transform_to_sentinel_2(on_device(), wavelengths, bands=s2_bands,
                                                    sensor=sensor, device=dev)
            write_geotiff(s2_path, s2.cpu().numpy().astype(np.float32),
                          descriptions=list(s2_bands), **geo)
        outputs[sensor] = s2_path

    if label_rgba is not None:
        write_geotiff(os.path.join(scene_dir, "label_rgba.tif"),
                      label_rgba.astype(np.float32),
                      descriptions=["r", "g", "b", "a"], **geo)
    return outputs


def _synthetic_scenes(n: int, rng: np.random.Generator):
    """N synthetic 1024 x 640 scenes over the matched filter's window, each
    on a Permian-basin UTM 13N grid (5 m pixels), as the JAX CLI makes them
    from the same generator. Plume-free scenes stay unlabelled: they are the
    negative-mining population."""
    from starcop_tpu_torch.data.synthetic import aviris_swir_bands, synthetic_scene

    centers, fwhm = aviris_swir_bands()
    scenes = []
    for i in range(n):
        s = synthetic_scene(rng, 1024, 640, n_plumes=int(rng.integers(0, 4)))
        rgba = None
        if s["label"].sum() > 0:
            rgba = np.zeros((4,) + s["label"].shape, np.float32)
            rgba[3] = s["label"]
        geo = ((5.0, 0.0, 500000.0 + 10000.0 * i, 0.0, -5.0, 3540000.0), 32613)
        scenes.append((f"synth{i:03d}", s["radiance"], centers, fwhm, rgba, s["rgb"], geo))
    return scenes


def _folder_scenes(scenes_dir: str):
    """{name}.npy cubes of ``scenes_dir`` with their optional side files."""
    scenes = []
    for name in sorted(os.listdir(scenes_dir)):
        if not name.endswith(".npy") or name.endswith(("_wl.npy", "_fwhm.npy", "_label.npy",
                                                       "_rgb.npy")):
            continue
        base = name[:-4]
        side = lambda suffix: os.path.join(scenes_dir, f"{base}{suffix}")  # noqa: E731
        cube = np.load(side(".npy"))
        wl = (np.load(side("_wl.npy")) if os.path.exists(side("_wl.npy"))
              else np.linspace(2122, 2488, cube.shape[-1]))
        fw = np.load(side("_fwhm.npy")) if os.path.exists(side("_fwhm.npy")) else np.full(len(wl), 5.5)
        rgba = np.load(side("_label.npy")) if os.path.exists(side("_label.npy")) else None
        rgb = np.load(side("_rgb.npy")) if os.path.exists(side("_rgb.npy")) else None
        geo = (None, None)
        if os.path.exists(side("_geo.json")):
            with open(side("_geo.json")) as fh:
                g = json.load(fh)
            geo = (tuple(g["transform"]) if g.get("transform") else None, g.get("crs_epsg"))
        scenes.append((base, cube, wl, fw, rgba, rgb, geo))
    return scenes


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scenes-dir", default=None, help="directory of {name}.npy radiance cubes")
    p.add_argument("--synthetic", type=int, default=0, help="generate N synthetic scenes instead")
    p.add_argument("--output", required=True, help="output root for scene products + chips")
    p.add_argument("--chip-size", type=int, default=512)
    p.add_argument("--stats-overlap", type=int, default=256)
    p.add_argument("--n-hard", type=int, default=2)
    p.add_argument("--n-random", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain twins)")
    args = p.parse_args(argv)

    from starcop_tpu_torch.data.chip_cache import cache_dataset
    from starcop_tpu_torch.data.geo import window_transform
    from starcop_tpu_torch.data.geotiff import find_raster, load_raster, write_geotiff
    from starcop_tpu_torch.data.mining import mag1c_window_stats, sampling_no_plumes
    from starcop_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if args.synthetic:
        scenes = _synthetic_scenes(args.synthetic, np.random.default_rng(args.seed))
    elif args.scenes_dir:
        scenes = _folder_scenes(args.scenes_dir)
    else:
        p.error("Provide --scenes-dir or --synthetic N")
    os.makedirs(args.output, exist_ok=True)

    def scene_dir_of(name: str) -> str:
        return os.path.join(args.output, "scenes", name)

    all_stats = []
    scene_geo = {}
    for name, cube, wl, fw, rgba, rgb, geo in scenes:
        t0 = time.time()
        transform, crs_epsg = geo
        scene_geo[name] = geo
        scene_dir = scene_dir_of(name)
        process_scene(scene_dir, name, cube, np.asarray(wl, np.float64),
                      np.asarray(fw, np.float64), rgba,
                      transform=transform, crs_epsg=crs_epsg, device=dev)
        if rgb is not None and find_raster(scene_dir, "rgb") is None:
            # (H, W, 3) visible bands: the TOA_AVIRIS_{640,550,460}nm chip products.
            write_geotiff(os.path.join(scene_dir, "rgb.tif"),
                          np.moveaxis(np.asarray(rgb, np.float32), -1, 0),
                          transform=transform, crs_epsg=crs_epsg,
                          descriptions=["640nm", "550nm", "460nm"])
        mf = load_raster(find_raster(scene_dir, "mag1c"))
        stats = mag1c_window_stats(mf, size=args.chip_size, overlap=args.stats_overlap,
                                   device=dev)
        for s in stats:
            s["name"] = name
        all_stats.extend(stats)
        print(f"scene {name}: {time.time() - t0:.1f}s ({len(stats)} windows)")

    with open(os.path.join(args.output, "stats_mag1c.json"), "w") as fh:
        json.dump(all_stats, fh)

    # Negatives are mined over unlabelled scenes only: a labelled scene's
    # high-mag1c windows are its plumes.
    def scene_labeled(name: str) -> bool:
        return find_raster(scene_dir_of(name), "label_rgba") is not None

    unlabeled_stats = [s for s in all_stats if not scene_labeled(s["name"])]
    negatives = sampling_no_plumes(unlabeled_stats, args.n_hard, args.n_random, seed=args.seed)

    # Plume candidates (high-mag1c windows of labelled scenes) and the mined
    # negatives, one chip folder per window id.
    rows = [dict(s, kind="plume_candidate") for s in all_stats
            if s["max"] >= 200 and scene_labeled(s["name"])]
    rows += [dict(s, kind="negative") for s in negatives]
    seen_ids = set()
    deduped = []
    for r in rows:
        r["id"] = f"{r['name']}_r{r['window_row_off']}_c{r['window_col_off']}"
        if r["id"] not in seen_ids:
            seen_ids.add(r["id"])
            deduped.append(r)
    rows = deduped

    def read_products(row):
        scene_dir = scene_dir_of(row["name"])
        window = (row["window_col_off"], row["window_row_off"],
                  row["window_width"], row["window_height"])
        products = {"mag1c": load_raster(find_raster(scene_dir, "mag1c"), window=window)}
        wv3_path = find_raster(scene_dir, "wv3")
        if wv3_path:
            wv3 = load_raster(wv3_path, window=window)
            if wv3.ndim == 2:  # a single covered band comes back squeezed
                wv3 = wv3[None]
            bands_path = os.path.join(scene_dir, "wv3_bands.json")
            if os.path.exists(bands_path):
                with open(bands_path) as fh:
                    wv3_bands = json.load(fh)
            else:
                wv3_bands = [f"SWIR{i}" for i in range(1, wv3.shape[0] + 1)]
            for i, band in enumerate(wv3_bands):
                products[f"TOA_WV3_{band}"] = wv3[i]
        rgb_path = find_raster(scene_dir, "rgb")
        if rgb_path:
            if rgb_path.endswith(".npy"):  # the channels-last layout
                c, r, w, h = window
                rgb_hw3 = np.load(rgb_path, mmap_mode="r")[r : r + h, c : c + w]
                rgb = np.moveaxis(np.asarray(rgb_hw3), -1, 0)
            else:
                rgb = load_raster(rgb_path, window=window)  # (3, h, w)
            for i, wl_name in enumerate(("640", "550", "460")):
                products[f"TOA_AVIRIS_{wl_name}nm"] = rgb[i]
        rgba_path = find_raster(scene_dir, "label_rgba")
        rgba = None
        if rgba_path and row.get("kind") == "plume_candidate":
            rgba = load_raster(rgba_path, window=window)
        s_transform, s_epsg = scene_geo.get(row["name"], (None, None))
        chip_geo = {}
        if s_transform is not None:
            chip_geo = {
                "transform": window_transform(
                    s_transform, row["window_col_off"], row["window_row_off"]
                ),
                "crs_epsg": s_epsg,
            }
        return products, rgba, chip_geo

    index = cache_dataset(
        os.path.join(args.output, "chips"), rows, read_products,
        output_size=(args.chip_size, args.chip_size),
    )
    print(f"cached {len(rows)} chips -> {index}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
