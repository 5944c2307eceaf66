"""Binary-mask vectorisation: raster plume masks -> world-space polygons
(a copy of starcop_tpu/data/vectorize.py; numpy / scipy).

Connected components are traced to pixel-boundary polygons, mapped to world
coordinates through the raster's affine, and written as GeoJSON (no GDAL or
OGR). ``join_plume_collections`` joins per-scene collections into one file
with file and sensing-time properties.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from starcop_tpu_torch.data.geo import Affine, pixel_to_world


def _component_labels(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    try:
        from scipy import ndimage

        labels, n = ndimage.label(mask)
        return labels, n
    except ImportError:  # tiny fallback: two-pass flood fill
        labels = np.zeros(mask.shape, np.int32)
        n = 0
        for r, c in zip(*np.nonzero(mask)):
            if labels[r, c]:
                continue
            n += 1
            stack = [(r, c)]
            while stack:
                y, x = stack.pop()
                if not (0 <= y < mask.shape[0] and 0 <= x < mask.shape[1]):
                    continue
                if not mask[y, x] or labels[y, x]:
                    continue
                labels[y, x] = n
                stack += [(y + 1, x), (y - 1, x), (y, x + 1), (y, x - 1)]
        return labels, n


def _trace_boundary(component: np.ndarray) -> List[Tuple[float, float]]:
    """Exterior pixel-boundary ring of one connected component (col, row)
    vertices in pixel units, counterclockwise, closed."""
    # Collect boundary edges of every pixel (edges not shared with another
    # set pixel), then chain them into a ring.
    edges = {}

    def add_edge(a, b):
        # store directed edge a->b; interior edges appear twice (opposite
        # directions) and cancel
        if (b, a) in edges:
            del edges[(b, a)]
        else:
            edges[(a, b)] = True

    rows, cols = np.nonzero(component)
    for r, c in zip(rows, cols):
        # corners (col, row): top-left (c, r) ... pixel covers [c,c+1)x[r,r+1)
        tl, tr = (c, r), (c + 1, r)
        br, bl = (c + 1, r + 1), (c, r + 1)
        add_edge(tl, tr)  # top
        add_edge(tr, br)  # right
        add_edge(br, bl)  # bottom
        add_edge(bl, tl)  # left
    if not edges:
        return []
    # A vertex where the region pinches (e.g. a hole or notch touching the
    # boundary diagonally) has TWO outgoing edges; collect all of them and
    # resolve the continuation by turn preference while tracing.
    nxt: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for a, b in edges:
        nxt.setdefault(a, []).append(b)
    start = min(nxt)
    ring = [start]
    prev = None
    cur = start
    for _ in range(4 * len(edges) + 2):
        outs = nxt[cur]
        if len(outs) == 1 or prev is None:
            chosen = outs[0]
        else:
            # Edges are oriented with the interior on the RIGHT; at a pinch,
            # take the most clockwise available turn so the exterior ring
            # does not cross into the hole's ring.
            dx, dy = cur[0] - prev[0], cur[1] - prev[1]
            # preference: right turn (cw), straight, left turn (ccw), back
            pref = [(-dy, dx), (dx, dy), (dy, -dx), (-dx, -dy)]
            chosen = None
            for px, py in pref:
                cand = (cur[0] + px, cur[1] + py)
                if cand in outs:
                    chosen = cand
                    break
            if chosen is None:
                chosen = outs[0]
        outs.remove(chosen)  # consume so each edge is walked once
        prev, cur = cur, chosen
        if cur == start:
            break
        ring.append(cur)
    ring.append(start)
    return [(float(c), float(r)) for c, r in ring]


def get_polygons(
    mask: np.ndarray,
    transform: Optional[Affine] = None,
    min_area: float = 1.0,
) -> List[Dict]:
    """Binary (H, W) mask -> GeoJSON Polygon dicts (exterior rings only,
    one per connected component with pixel area >= min_area). ``transform``
    maps pixel corners to world coordinates (identity when None) — the
    reference's get_polygons(valid_mask, transform, min_area=1)."""
    mask = np.asarray(mask).astype(bool)
    labels, n = _component_labels(mask)
    polygons = []
    for i in range(1, n + 1):
        comp = labels == i
        if comp.sum() < min_area:
            continue
        ring_px = _trace_boundary(comp)
        if len(ring_px) < 4:
            continue
        if transform is not None:
            ring = [list(pixel_to_world(transform, c, r)) for c, r in ring_px]
        else:
            ring = [[c, r] for c, r in ring_px]
        polygons.append({"type": "Polygon", "coordinates": [ring]})
    return polygons


def write_geojson(
    path: str,
    polygons: Sequence[Dict],
    properties: Optional[Sequence[Dict]] = None,
    crs_epsg: Optional[int] = None,
) -> str:
    """FeatureCollection writer (the reference's GPKG role, OGR-free)."""
    features = []
    for i, poly in enumerate(polygons):
        props = dict(properties[i]) if properties else {}
        props.setdefault("id", i)
        features.append({"type": "Feature", "geometry": poly, "properties": props})
    payload: Dict = {"type": "FeatureCollection", "features": features}
    if crs_epsg is not None:
        payload["crs"] = {
            "type": "name",
            "properties": {"name": f"urn:ogc:def:crs:EPSG::{crs_epsg}"},
        }
    with open(path, "w") as fh:
        json.dump(payload, fh)
    return path


def vectorize_mask_raster(
    mask_tif: str, out_geojson: str, band: int = 3, min_area: float = 1.0
) -> Optional[str]:
    """Raster mask GeoTIFF -> polygon GeoJSON (reference flow: read band 4's
    alpha as validity, vectorize, save — process_data_jpl_4corners.py:103-116).
    Returns None (and writes nothing) when the mask has no valid pixels."""
    from starcop_tpu_torch.data.geotiff import GeoTIFFReader

    reader = GeoTIFFReader(mask_tif)
    band = min(band, reader.count - 1)
    valid = reader.read(band=band) != 0
    if not valid.any():
        return None
    polys = get_polygons(valid, transform=reader.meta.transform, min_area=min_area)
    return write_geojson(out_geojson, polys, crs_epsg=reader.meta.crs_epsg)


def join_plume_collections(
    geojson_paths: Sequence[str], out_path: str, max_features_per_file: int = 1000
) -> str:
    """Join per-scene collections into one file with file/sensing-time
    properties (reference all_plumes.gpkg step, :120-136; files with
    implausibly many polygons are skipped as errors)."""
    from starcop_tpu_torch.data.permian import flight_datetime

    features = []
    for p in sorted(geojson_paths):
        with open(p) as fh:
            data = json.load(fh)
        if len(data.get("features", [])) > max_features_per_file:
            continue  # "too many plumes seems an error"
        base = os.path.basename(p)
        sensing = None
        try:
            sensing = flight_datetime(base[:18].split(".")[0]).isoformat()
        except ValueError:
            pass
        for f in data.get("features", []):
            f = dict(f)
            props = dict(f.get("properties", {}))
            props["file"] = base
            if sensing:
                props["sensing_time"] = sensing
            f["properties"] = props
            features.append(f)
    with open(out_path, "w") as fh:
        json.dump({"type": "FeatureCollection", "features": features}, fh)
    return out_path
