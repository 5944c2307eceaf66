"""Negative / confounder mining from matched-filter window statistics
(counterpart of starcop_tpu/data/mining.py).

``mag1c_window_stats`` reduces every sliding window of a scene's mag1c map
on the device in one batch: the windows stacked, invalid values pushed to
+-inf, one ``torch.sort`` per window and the percentiles read at
``(n_valid - 1) * q / 100`` (``torch.quantile`` refuses more than 2^24
values and has no masked form). The percentile positions are f32, as JAX's
are in production (x64 off): at 262,144 values a window an f32 position
resolves 1/64 of an index. The window choice and the hard / random
negative sampling are host Python, copies of JAX's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from starcop_tpu_torch.data.datamodule import sliding_window_offsets
from starcop_tpu_torch.device import DeviceLike, resolve_device

PERCENTILES = (25, 50, 75, 95, 99)


def mag1c_window_stats(
    mag1c,
    size: int = 512,
    overlap: int = 256,
    nodata: float = -9999.0,
    device: DeviceLike = None,
) -> List[Dict]:
    """Per-window statistics driving negative mining: for each sliding
    window, max / min / mean / sum / percentiles (25, 50, 75, 95, 99) of the
    valid mag1c values and the valid fraction. A wholly invalid window has
    max -inf, min +inf, mean and sum 0 and NaN percentiles (inf x 0 in the
    interpolation), as JAX's.
    ``mag1c`` is an (H, W) array or tensor; the work runs on ``device``
    (None: the CUDA card)."""
    dev = resolve_device(device)
    m = torch.as_tensor(mag1c, dtype=torch.float32, device=dev)
    h, w = m.shape
    offsets = sliding_window_offsets(h, w, size, overlap)
    x = torch.stack([m[r:r + size, c:c + size] for r, c in offsets]).reshape(len(offsets), -1)
    valid = x != nodata
    count = valid.sum(1, dtype=torch.int32)
    n_valid = count.clamp_min(1)
    xv = torch.where(valid, x, 0.0)
    total = xv.sum(1)
    mean = total / n_valid
    mx = torch.where(valid, x, -torch.inf).amax(1)
    mn = torch.where(valid, x, torch.inf).amin(1)
    sorted_vals = torch.sort(torch.where(valid, x, torch.inf), dim=1).values
    pct = []
    for q in PERCENTILES:
        pos = ((n_valid - 1).float() * torch.tensor(q / 100.0, dtype=torch.float32)).clamp_min(0)
        lo, hi = pos.floor(), pos.ceil()
        frac = pos - lo
        vlo = torch.gather(sorted_vals, 1, lo.long()[:, None])[:, 0]
        vhi = torch.gather(sorted_vals, 1, hi.long()[:, None])[:, 0]
        pct.append(vlo * (1 - frac) + vhi * frac)
    frac_valid = count.float() / (size * size)
    cols = torch.stack([mx, mn, mean, total, frac_valid, *pct], 1).cpu().numpy()

    stats = []
    for (r, c), v in zip(offsets, cols):
        row = {
            "window_row_off": r,
            "window_col_off": c,
            "window_height": size,
            "window_width": size,
            "max": float(v[0]),
            "min": float(v[1]),
            "mean": float(v[2]),
            "sum": float(v[3]),
            "percentage_valids": float(v[4]),
        }
        for i, q in enumerate(PERCENTILES):
            row[f"p{q}"] = float(v[5 + i])
        stats.append(row)
    return stats


def _windows_intersect(a: Dict, b: Dict) -> bool:
    return not (
        a["window_col_off"] + a["window_width"] <= b["window_col_off"]
        or b["window_col_off"] + b["window_width"] <= a["window_col_off"]
        or a["window_row_off"] + a["window_height"] <= b["window_row_off"]
        or b["window_row_off"] + b["window_height"] <= a["window_row_off"]
    )


def select_non_overlapping(rows: Sequence[Dict], n: int = 2, chosen: Optional[List[int]] = None) -> List[int]:
    """Greedy selection of up to n mutually non-overlapping windows, after
    the ``chosen`` ones; returns indices into ``rows``."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    idxs = list(chosen or [])
    for i, row in enumerate(rows):
        if i in idxs:
            continue
        if not idxs:
            idxs.append(i)
        elif not any(_windows_intersect(rows[j], row) for j in idxs):
            idxs.append(i)
        if len(idxs) >= n:
            break
    return idxs


def sampling_no_plumes(
    stats_rows: Sequence[Dict],
    n_hard: int,
    n_random: int,
    percentage_valids: float = 0.8,
    seed: int = 42,
) -> List[Dict]:
    """Hard + random negative windows per scene (grouped by 'name'): keep
    windows with >= percentage_valids valid pixels; pick n_hard
    non-overlapping windows of the highest mean mag1c ("hard" confounders),
    then n_random more from a seeded permutation ("random")."""
    rng = np.random.default_rng(seed)
    out: List[Dict] = []
    names = sorted({r.get("name", "") for r in stats_rows})
    for name in names:
        rows = [r for r in stats_rows if r.get("name", "") == name]
        rows = [r for r in rows if r.get("percentage_valids", 1.0) >= percentage_valids]
        rows_sorted = sorted(rows, key=lambda r: -r.get("mean", 0.0))
        hard_idx = select_non_overlapping(rows_sorted, n=n_hard)
        perm = list(rng.permutation(len(rows_sorted)))
        rows_permuted = [rows_sorted[i] for i in perm]
        # the hard indices in the permuted order
        hard_in_perm = [perm.index(i) for i in hard_idx]
        all_idx = select_non_overlapping(rows_permuted, n=n_hard + n_random, chosen=hard_in_perm)
        for k, i in enumerate(all_idx):
            row = dict(rows_permuted[i])
            row["difficulty"] = "hard" if k < len(hard_in_perm) else "random"
            row["qplume"] = 0.0
            row["has_plume"] = False
            out.append(row)
    return out
