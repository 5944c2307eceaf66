"""Permian-2019 dataset assembly: plume list + mag1c window statistics ->
train / test rows (a copy of starcop_tpu/data/permian.py; host Python on
the list-of-dict row protocol, no pandas).

  * the flight-date train / test split: flights on TEST_DATES
    (2019-10-25/21/18) are test, every other flight train;
  * the published bad-test-tile blacklist (32 mislabelled or ambiguous test
    chips dropped from the plume list);
  * the published manual has_plume overrides (15 unlabelled but real plume
    windows in the statistics table, the "Big One" events among them);
  * window-intersection plume flagging: a statistics window counts as plume
    if it intersects a labelled plume window of its flight line or an
    overridden window;
  * hard / random negatives from the no-plume windows
    (``mining.sampling_no_plumes``).

The blacklist and override ids are published dataset-curation constants.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Dict, List, Sequence, Tuple

from starcop_tpu_torch.data.mining import _windows_intersect, sampling_no_plumes

TEST_DATES = ["2019-10-25", "2019-10-21", "2019-10-18"]

# Mislabeled/ambiguous test tiles dropped from the plume list
# (reference sampling_dataset.py:83-98).
BAD_TEST_TILES = [
    "ang20191018t141549_r8600_c403_w151_h151", "ang20191018t141549_r3424_c446_w151_h151",
    "ang20191018t165503_r9641_c448_w151_h151", "ang20191018t141549_r2616_c300_w151_h151",
    "ang20191018t153724_r13604_c135_w151_h151", "ang20191018t144405_r1990_c431_w151_h151",
    "ang20191018t144405_r1740_c34_w151_h151", "ang20191018t183859_r9089_c309_w151_h151",
    "ang20191018t153724_r8455_c101_w151_h151", "ang20191018t165503_r9976_c226_w151_h151",
    "ang20191018t150906_r5505_c222_w151_h151", "ang20191018t172239_r4930_c291_w151_h151",
    "ang20191018t165503_r7509_c66_w151_h151", "ang20191021t160052_r9752_c418_w151_h151",
    "ang20191018t183859_r11078_c385_w151_h151", "ang20191021t173221_r8391_c86_w151_h151",
    "ang20191018t183859_r5087_c494_w151_h151", "ang20191021t163119_r10513_c292_w151_h151",
    "ang20191021t154726_r10577_c423_w151_h151", "ang20191021t154726_r8441_c229_w151_h151",
    "ang20191021t163119_r8462_c408_w151_h151", "ang20191021t174954_r8627_c460_w151_h151",
    "ang20191021t153008_r8754_c366_w151_h151", "ang20191021t154726_r7273_c203_w151_h151",
    "ang20191021t183204_r3408_c492_w151_h151", "ang20191018t174629_r13283_c433_w151_h151",
    "ang20191021t154726_r10547_c373_w151_h151", "ang20191021t154726_r8361_c253_w151_h151",
    "ang20191021t154726_r10684_c481_w151_h151", "ang20191021t160052_r7282_c221_w151_h151",
    "ang20191021t154726_r10825_c8_w151_h151", "ang20191021t153008_r5387_c384_w151_h151",
]

# Unlabeled-but-real plume windows in the mag1c stats table
# (reference sampling_dataset.py:135-150; "Big One" events included).
MANUAL_HAS_PLUME_OVERRIDES = [
    "ang20191018t183859_r2304_c0_w512_h512",
    "ang20191018t183859_r2560_c0_w512_h512",
    "ang20191021t190136_r4096_c0_w512_h512",
    "ang20191018t141549_r2560_c0_w512_h512",
    "ang20190926t172904_r512_c0_w512_h512",
    "ang20190926t184029_r6144_c256_w512_h512",
    "ang20190927t164322_r3328_c0_w512_h512",
    "ang20190923t185208_r4608_c0_w512_h512",
    "ang20190926t172904_r768_c0_w512_h512",
    "ang20190926t184029_r6400_c256_w512_h512",
    "ang20190927t153023_r8192_c0_w512_h512",  # Big One
    "ang20191005t215301_r5120_c0_w512_h512",  # Big One
    "ang20191007t195115_r768_c0_w512_h512",  # Big One
    "ang20191012t162223_r3072_c0_w512_h512",  # Big One
    "ang20191005t215301_r4864_c0_w512_h512",  # Big One
]


def flight_datetime(name: str) -> datetime:
    """AVIRIS-NG flight-line name -> acquisition datetime
    ('ang%Y%m%dt%H%M%S', UTC — sampling_dataset.py:63)."""
    return datetime.strptime(name, "ang%Y%m%dt%H%M%S").replace(tzinfo=timezone.utc)


def flight_date(name: str) -> str:
    return flight_datetime(name).strftime("%Y-%m-%d")


def window_id(row: Dict) -> str:
    """The reference's chip id convention (sampling_dataset.py:72-74)."""
    return (
        f"{row['name']}_r{row['window_row_off']}_c{row['window_col_off']}"
        f"_w{row['window_width']}_h{row['window_height']}"
    )


def pad_window_to_size(row: Dict, output_size: Tuple[int, int]) -> Dict:
    """Center-pad a window to output_size (georeader
    window_utils.pad_window_to_size semantics, used at
    sampling_dataset.py:102-103). Offsets may go negative; the chip reader
    zero-pads out-of-scene extents."""
    h, w = row["window_height"], row["window_width"]
    th, tw = output_size
    out = dict(row)
    if th > h:
        pad = th - h
        out["window_row_off"] = row["window_row_off"] - pad // 2
        out["window_height"] = th
    if tw > w:
        pad = tw - w
        out["window_col_off"] = row["window_col_off"] - pad // 2
        out["window_width"] = tw
    return out


def permian_plumes_rows(
    rows: Sequence[Dict], output_size: Tuple[int, int] = (151, 151)
) -> List[Dict]:
    """Labeled-plume windows -> curated rows (reference
    permian_plumes_dataframe, sampling_dataset.py:45-103).

    Filters invalid windows (col_off < 0), stamps date/id/subset/has_plume,
    drops the published bad-test-tile blacklist, then pads windows to
    output_size (id is computed BEFORE padding — the blacklist ids are in the
    151x151 convention)."""
    out = []
    for row in rows:
        if row["window_col_off"] < 0:
            continue
        r = dict(row)
        r["date"] = flight_date(r["name"])
        r["id"] = window_id(r)
        r["subset"] = "test" if r["date"] in TEST_DATES else "train"
        r["has_plume"] = True
        if r["id"] in BAD_TEST_TILES:
            continue
        if output_size != (r["window_height"], r["window_width"]):
            r = pad_window_to_size(r, output_size)
        out.append(r)
    return out


def permian_mag1c_stats_rows(
    stats_rows: Sequence[Dict], plumes_rows: Sequence[Dict]
) -> List[Dict]:
    """mag1c window-stats rows -> has_plume-flagged rows (reference
    permian_mag1c_stats_dataframe, sampling_dataset.py:113-179).

    A stats window has a plume if its id is in the manual override list or it
    intersects any labeled plume window (or overridden window) of the same
    flight line."""
    prepared = []
    for row in stats_rows:
        if row["window_col_off"] < 0:
            continue
        r = dict(row)
        r["date"] = flight_date(r["name"])
        r["id"] = window_id(r)
        if "percentage_valids" not in r and "count" in r:
            r["percentage_valids"] = r["count"] / (
                r["window_width"] * r["window_height"]
            )
        r["has_plume"] = r["id"] in MANUAL_HAS_PLUME_OVERRIDES
        r["subset"] = "test" if r["date"] in TEST_DATES else "train"
        prepared.append(r)

    plumes_by_name: Dict[str, List[Dict]] = {}
    for p in plumes_rows:
        plumes_by_name.setdefault(p["name"], []).append(p)
    overrides_by_name: Dict[str, List[Dict]] = {}
    for r in prepared:
        if r["has_plume"]:
            overrides_by_name.setdefault(r["name"], []).append(r)

    for r in prepared:
        if r["has_plume"]:
            continue
        candidates = plumes_by_name.get(r["name"], []) + overrides_by_name.get(r["name"], [])
        r["has_plume"] = any(_windows_intersect(r, c) for c in candidates)
    return prepared


def generate_permian_2019_split(
    plume_rows: Sequence[Dict],
    stats_rows: Sequence[Dict],
    n_hard: int = 2,
    n_random: int = 2,
    percentage_valids: float = 0.8,
    seed: int = 42,
    output_size: Tuple[int, int] = (512, 512),
) -> Tuple[List[Dict], List[Dict]]:
    """One tested path from the plume CSV + stats CSV to (train, test) rows.

    Composes the pieces the reference spreads across
    permian_plumes_dataframe / permian_mag1c_stats_dataframe /
    sampling_no_plumes and its selection notebooks: curated plume windows
    (blacklist applied, padded to output_size) plus per-scene hard/random
    mined negatives from the no-plume stats windows, split by flight date.
    """
    plumes = permian_plumes_rows(plume_rows, output_size=output_size)
    stats = permian_mag1c_stats_rows(stats_rows, plumes)
    no_plumes = [r for r in stats if not r["has_plume"]]
    negatives = sampling_no_plumes(
        no_plumes, n_hard, n_random, percentage_valids=percentage_valids, seed=seed
    )
    for n in negatives:  # mined negatives keep their stats-window extent
        n.setdefault("id", window_id(n))
    rows = list(plumes) + list(negatives)
    train = [r for r in rows if r["subset"] == "train"]
    test = [r for r in rows if r["subset"] == "test"]
    return train, test
