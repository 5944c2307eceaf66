"""Self-contained tiled GeoTIFF (COG-style) writer + reader. No GDAL.

The port's own copy of ``starcop_tpu/data/geotiff.py`` (``write_geotiff``,
``GeoTIFFReader``, ``read_geotiff``): pure numpy, struct and zlib, byte for
byte the same files. The serving pipeline writes its mag1c and prediction
products with it.

  * tiled layout (default 128, matching the reference chip profile), optional
    DEFLATE compression, 2x-decimated overview IFDs (the COG essentials);
  * BigTIFF (version 43, 64-bit offsets) — automatic past classic TIFF's
    4 GB offset ceiling (GDAL ``BIGTIFF=IF_SAFER``), forceable, readable;
  * geotransform via ModelPixelScale+ModelTiepoint (north-up) or
    ModelTransformation (rotated grids);
  * CRS via a GeoKeyDirectory EPSG code;
  * nodata via GDAL_NODATA and free-form tags / per-band descriptions via
    GDAL_METADATA — the same tag vocabulary GDAL writes, so outputs open in
    QGIS/rasterio unchanged.

The reader parses exactly what the writer produces plus plain strip-based
TIFFs, supports windowed reads (only intersecting tiles are decompressed), and
returns the geo metadata so roundtrips preserve georeferencing.

Affine convention follows ``starcop_tpu_torch.data.geo``: (a, b, xoff, d, e,
yoff) with x = a*col + b*row + xoff; y = d*col + e*row + yoff.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from starcop_tpu_torch.data.geo import Affine

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259  # 1 = none, 8 = DEFLATE (Adobe)
_PHOTOMETRIC = 262  # 1 = min-is-black
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284  # 1 = chunky, 2 = separate planes
_PREDICTOR = 317
_EXTRA_SAMPLES = 338
_NEW_SUBFILE_TYPE = 254  # 1 = reduced-resolution (overview)
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_SAMPLE_FORMAT = 339  # 1 = uint, 2 = int, 3 = float
_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_MODEL_TRANSFORMATION = 34264
_GEO_KEY_DIRECTORY = 34735
_GDAL_METADATA = 42112
_GDAL_NODATA = 42113

# TIFF field types
_T_ASCII, _T_SHORT, _T_LONG, _T_DOUBLE = 2, 3, 4, 12
_T_LONG8 = 16  # BigTIFF 64-bit unsigned
_TYPE_SIZE = {_T_ASCII: 1, _T_SHORT: 2, _T_LONG: 4, _T_DOUBLE: 8, _T_LONG8: 8}
_TYPE_FMT = {_T_SHORT: "H", _T_LONG: "I", _T_DOUBLE: "d", _T_LONG8: "Q"}

# Classic TIFF's 32-bit offset ceiling; module-level so tests can lower it to
# exercise the BigTIFF switch without writing real 4 GB files.
_CLASSIC_MAX_OFFSET = 0xFFFFFFFF

_DTYPE_TO_TIFF = {
    np.dtype(np.uint8): (1, 8),
    np.dtype(np.uint16): (1, 16),
    np.dtype(np.uint32): (1, 32),
    np.dtype(np.int16): (2, 16),
    np.dtype(np.int32): (2, 32),
    np.dtype(np.float32): (3, 32),
    np.dtype(np.float64): (3, 64),
}
_TIFF_TO_DTYPE = {v: k for k, v in _DTYPE_TO_TIFF.items()}


@dataclass
class GeoMeta:
    """Geo metadata carried by a GeoTIFF (subset the framework uses)."""

    transform: Optional[Affine] = None
    crs_epsg: Optional[int] = None
    nodata: Optional[float] = None
    tags: Dict[str, str] = field(default_factory=dict)
    descriptions: List[str] = field(default_factory=list)


def _north_up(transform: Affine) -> bool:
    return abs(transform[1]) < 1e-12 and abs(transform[3]) < 1e-12


def _geo_entries(meta: GeoMeta) -> List[Tuple[int, int, Sequence]]:
    entries: List[Tuple[int, int, Sequence]] = []
    t = meta.transform
    if t is not None:
        a, b, xoff, d, e, yoff = t
        if _north_up(t):
            # ModelPixelScale stores a POSITIVE y scale; orientation is
            # implied (row+ goes down in world y by scale_y).
            entries.append((_MODEL_PIXEL_SCALE, _T_DOUBLE, (a, -e, 0.0)))
            entries.append((_MODEL_TIEPOINT, _T_DOUBLE, (0.0, 0.0, 0.0, xoff, yoff, 0.0)))
        else:
            entries.append(
                (
                    _MODEL_TRANSFORMATION,
                    _T_DOUBLE,
                    (a, b, 0.0, xoff, d, e, 0.0, yoff, 0, 0, 0, 0, 0, 0, 0, 1.0),
                )
            )
    if meta.crs_epsg is not None:
        epsg = int(meta.crs_epsg)
        geographic = epsg == 4326 or 4000 <= epsg <= 4999
        keys = [
            (1024, 0, 1, 2 if geographic else 1),  # GTModelType
            (1025, 0, 1, 1),  # GTRasterType = PixelIsArea
            (2048 if geographic else 3072, 0, 1, epsg),
        ]
        flat = [1, 1, 0, len(keys)]
        for k in keys:
            flat.extend(k)
        entries.append((_GEO_KEY_DIRECTORY, _T_SHORT, flat))
    if meta.nodata is not None:
        entries.append((_GDAL_NODATA, _T_ASCII, _ascii(f"{meta.nodata:g}")))
    xml = _gdal_metadata_xml(meta.tags, meta.descriptions)
    if xml:
        entries.append((_GDAL_METADATA, _T_ASCII, _ascii(xml)))
    return entries


def _ascii(s: str) -> bytes:
    return s.encode("utf-8") + b"\x00"


def _gdal_metadata_xml(tags: Dict[str, str], descriptions: Sequence[str]) -> str:
    items = []
    for k, v in (tags or {}).items():
        items.append(f'  <Item name="{_xml_escape(str(k))}">{_xml_escape(str(v))}</Item>')
    for i, desc in enumerate(descriptions or []):
        items.append(
            f'  <Item name="DESCRIPTION" sample="{i}" role="description">'
            f"{_xml_escape(str(desc))}</Item>"
        )
    if not items:
        return ""
    return "<GDALMetadata>\n" + "\n".join(items) + "\n</GDALMetadata>\n"


def _xml_escape(s: str) -> str:
    return (
        s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;").replace('"', "&quot;")
    )


def _pack_values(ttype: int, values) -> bytes:
    if ttype == _T_ASCII:
        return bytes(values)
    fmt = _TYPE_FMT[ttype]
    return struct.pack(f"<{len(values)}{fmt}", *values)


def _tile_grid(h: int, w: int, ts: int) -> Tuple[int, int]:
    return -(-h // ts), -(-w // ts)


def _split_tiles(plane: np.ndarray, ts: int) -> List[np.ndarray]:
    """Row-major full-size tiles of one (H, W) plane (edges zero-padded)."""
    h, w = plane.shape
    th, tw = _tile_grid(h, w, ts)
    padded = np.zeros((th * ts, tw * ts), plane.dtype)
    padded[:h, :w] = plane
    return [
        padded[r * ts : (r + 1) * ts, c * ts : (c + 1) * ts]
        for r in range(th)
        for c in range(tw)
    ]


def _decimate(plane: np.ndarray) -> np.ndarray:
    return plane[::2, ::2]


def write_geotiff(
    path: str,
    array: np.ndarray,
    transform: Optional[Affine] = None,
    crs_epsg: Optional[int] = None,
    nodata: Optional[float] = None,
    tags: Optional[Dict[str, str]] = None,
    descriptions: Optional[Sequence[str]] = None,
    tile_size: int = 128,
    compress: Union[bool, int] = True,
    overviews: bool = True,
    bigtiff="auto",
) -> str:
    """Write a (H, W) or (C, H, W) array as a tiled (COG-style) GeoTIFF.

    Matches the reference chip profile (BLOCKSIZE 128 —
    sampling_dataset.py:358-394) by default; adds 2x overview IFDs while the
    raster stays larger than one tile.

    ``compress``: ``True`` = DEFLATE at zlib level 6 (the archival default,
    matching GDAL's), an ``int`` 1-9 = DEFLATE at that level, ``False`` =
    uncompressed tiles. Level choice is a pure CPU/size trade — the file is
    a valid tiled GeoTIFF either way. float32 science rasters are mostly
    zlib-incompressible (a full-entropy mantissa compresses ~0.9x even at
    level 6), so throughput-critical writers (the serving pipeline) pass
    ``False``: ~5 ms vs ~100 ms per scene-sized f32 product.

    ``bigtiff``: ``"auto"`` (default) writes classic TIFF and switches to
    BigTIFF (version 43, 64-bit offsets) when the laid-out file would exceed
    classic TIFF's 4 GB offset ceiling — GDAL's ``BIGTIFF=IF_SAFER`` behavior;
    ``True`` forces BigTIFF; ``False`` raises past 4 GB.
    """
    if not isinstance(compress, bool) and not 0 <= int(compress) <= 9:
        # Fail fast: zlib.compress would raise per-tile mid-write otherwise.
        raise ValueError(f"compress must be a bool or a zlib level 0-9, got {compress}")
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim != 3:
        raise ValueError(f"Expected (H, W) or (C, H, W), got {array.shape}")
    if arr.dtype not in _DTYPE_TO_TIFF:
        arr = arr.astype(np.float32)
    # Uncompressed data that cannot fit 32-bit offsets is known before any
    # tiling work: refuse early (bigtiff=False) or go straight to BigTIFF.
    if not compress and arr.nbytes * (4 / 3) > _CLASSIC_MAX_OFFSET:
        if bigtiff is False:
            raise ValueError(
                f"Raster of {arr.nbytes / 1e9:.1f} GB exceeds classic TIFF's "
                "32-bit offsets. Pass bigtiff='auto'/True, or split the "
                "raster (e.g. per-band files via save_scene_bands)."
            )
        bigtiff = True
    meta = GeoMeta(
        transform=transform,
        crs_epsg=crs_epsg,
        nodata=nodata,
        tags=dict(tags or {}),
        descriptions=list(descriptions or []),
    )

    levels = [arr]
    if overviews:
        cur = arr
        while max(cur.shape[1], cur.shape[2]) > 2 * tile_size and min(cur.shape[1:]) >= 2:
            cur = np.stack([_decimate(p) for p in cur])
            levels.append(cur)

    ifds = []
    for lvl, data in enumerate(levels):
        ifds.append(_build_ifd(data, meta if lvl == 0 else None, tile_size, compress, lvl > 0))

    # Layout: header | IFD0 + ext | IFD1 + ext | ... | tile data. Classic and
    # BigTIFF share the layout; only the header/entry/offset widths differ.
    big = bigtiff is True
    while True:
        header_size = 16 if big else 8
        inline = 8 if big else 4
        typed_ifds = [(_retype_offsets(entries, big), tiles) for entries, tiles in ifds]
        cursor = header_size
        ifd_positions = []
        for entries, _tiles in typed_ifds:
            ifd_positions.append(cursor)
            n = len(entries)
            ifd_size = (8 + 20 * n + 8) if big else (2 + 12 * n + 4)
            ext_size = sum(
                _padded_len(_value_len(t, v))
                for _tag, t, v in entries
                if _value_len(t, v) > inline
            )
            cursor += ifd_size + ext_size
        tile_cursor = cursor

        # Assign tile offsets per IFD.
        blobs: List[bytes] = []
        tile_offsets_per_ifd = []
        for _entries, tiles in typed_ifds:
            offs = []
            for blob in tiles:
                offs.append(tile_cursor)
                blobs.append(blob)
                tile_cursor += _padded_len(len(blob))
            tile_offsets_per_ifd.append(offs)

        if not big and tile_cursor > _CLASSIC_MAX_OFFSET:
            if bigtiff == "auto":
                big = True
                continue
            raise ValueError(
                f"Raster would produce a {tile_cursor / 1e9:.1f} GB file; "
                "classic TIFF offsets are 32-bit. Pass bigtiff='auto'/True, "
                "or split the raster (e.g. per-band files via save_scene_bands)."
            )
        break

    if big:
        header = struct.pack("<2sHHHQ", b"II", 43, 8, 0, 16)
    else:
        header = struct.pack("<2sHI", b"II", 42, 8)
    out = bytearray(header)
    for i, (entries, tiles) in enumerate(typed_ifds):
        entries = _finalize_entries(entries, tile_offsets_per_ifd[i], [len(b) for b in tiles])
        next_ifd = ifd_positions[i + 1] if i + 1 < len(typed_ifds) else 0
        out += _serialize_ifd(entries, ifd_positions[i], next_ifd, big)
    with open(path, "wb") as fh:
        # Tile payloads stream straight to disk: a >4 GB raster must never be
        # double-buffered through one contiguous Python bytes object.
        fh.write(bytes(out))
        for blob in blobs:
            fh.write(blob)
            pad = _padded_len(len(blob)) - len(blob)
            if pad:
                fh.write(b"\x00" * pad)
    return path


def _retype_offsets(entries, big: bool):
    """BigTIFF stores tile offsets as LONG8 (64-bit); classic as LONG."""
    if not big:
        return entries
    return [
        (tag, _T_LONG8 if tag == _TILE_OFFSETS else ttype, values)
        for tag, ttype, values in entries
    ]


def _value_len(ttype: int, values) -> int:
    n = len(values)
    return n * _TYPE_SIZE[ttype]


def _padded_len(n: int) -> int:
    return (n + 3) & ~3


def _build_ifd(
    data: np.ndarray, meta: Optional[GeoMeta], ts: int, compress, is_overview: bool
):
    c, h, w = data.shape
    sample_format, bits = _DTYPE_TO_TIFF[data.dtype]
    raw_tiles: List[bytes] = []
    for plane in data:  # planar config 2: all tiles of band 0, then band 1, ...
        for tile in _split_tiles(np.ascontiguousarray(plane), ts):
            raw_tiles.append(tile.tobytes())
    level = 6 if compress is True else int(compress)
    if not level:
        tiles = raw_tiles
    elif len(raw_tiles) >= 32:
        # zlib releases the GIL: scene-size rasters (hundreds of tiles)
        # compress across threads (~4x faster wall clock on the write path).
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            tiles = list(pool.map(lambda b: zlib.compress(b, level), raw_tiles))
    else:
        tiles = [zlib.compress(b, level) for b in raw_tiles]

    entries: List[Tuple[int, int, Sequence]] = []
    if is_overview:
        entries.append((_NEW_SUBFILE_TYPE, _T_LONG, (1,)))
    entries += [
        (_IMAGE_WIDTH, _T_LONG, (w,)),
        (_IMAGE_LENGTH, _T_LONG, (h,)),
        (_BITS_PER_SAMPLE, _T_SHORT, (bits,) * c),
        (_COMPRESSION, _T_SHORT, (8 if compress else 1,)),
        (_PHOTOMETRIC, _T_SHORT, (1,)),
        (_SAMPLES_PER_PIXEL, _T_SHORT, (c,)),
        (_PLANAR_CONFIG, _T_SHORT, (2 if c > 1 else 1,)),
        (_TILE_WIDTH, _T_SHORT, (ts,)),
        (_TILE_LENGTH, _T_SHORT, (ts,)),
        (_TILE_OFFSETS, _T_LONG, [0] * len(tiles)),  # filled at serialization
        (_TILE_BYTE_COUNTS, _T_LONG, [0] * len(tiles)),
        (_SAMPLE_FORMAT, _T_SHORT, (sample_format,) * c),
    ]
    if c > 1:
        entries.append((_EXTRA_SAMPLES, _T_SHORT, (0,) * (c - 1)))
    if meta is not None:
        entries += _geo_entries(meta)
    entries.sort(key=lambda e: e[0])
    return entries, tiles


def _finalize_entries(entries, tile_offsets, tile_counts):
    done = []
    for tag, ttype, values in entries:
        if tag == _TILE_OFFSETS:
            values = tile_offsets
        elif tag == _TILE_BYTE_COUNTS:
            values = tile_counts
        done.append((tag, ttype, values))
    return done


def _serialize_ifd(entries, ifd_offset: int, next_ifd_offset: int, big: bool = False) -> bytes:
    n = len(entries)
    inline = 8 if big else 4
    ext_offset = ifd_offset + ((8 + 20 * n + 8) if big else (2 + 12 * n + 4))
    body = struct.pack("<Q", n) if big else struct.pack("<H", n)
    off_fmt = "<Q" if big else "<I"
    entry_head = "<HHQ" if big else "<HHI"
    ext = bytearray()
    for tag, ttype, values in entries:
        packed = _pack_values(ttype, values)
        count = len(values)
        if len(packed) <= inline:
            value_field = packed + b"\x00" * (inline - len(packed))
        else:
            value_field = struct.pack(off_fmt, ext_offset + len(ext))
            ext += packed
            ext += b"\x00" * (_padded_len(len(packed)) - len(packed))
        body += struct.pack(entry_head, tag, ttype, count) + value_field
    body += struct.pack(off_fmt, next_ifd_offset)
    return body + bytes(ext)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class GeoTIFFReader:
    """Windowed reader over a (this writer's or GDAL's) tiled/striped TIFF.

    Lazy by design: only the header + IFDs are parsed up front (one small
    read); tile/strip payloads are fetched with seeks on demand, so windowed
    chip reads over scene-sized rasters cost O(window), not O(file) — the
    chip cache reads hundreds of windows per scene product.
    """

    # IFDs + external tag data live at the front of files this writer
    # produces; 64 KiB covers them for any practical raster.
    _HEAD = 65536

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        self._buf = self._fh.read(self._HEAD)
        order, magic = struct.unpack_from("<2sH", self._buf, 0)
        if order != b"II" or magic not in (42, 43):
            raise ValueError(f"Not a little-endian TIFF/BigTIFF: {path}")
        self._big = magic == 43
        if self._big:
            offsize, zero, first_ifd = struct.unpack_from("<HHQ", self._buf, 4)
            if offsize != 8 or zero != 0:
                raise ValueError(f"Unsupported BigTIFF offset size {offsize}: {path}")
        else:
            (first_ifd,) = struct.unpack_from("<I", self._buf, 4)
        if first_ifd + 4 > len(self._buf):
            # IFDs at the end of the file (some external writers): read all.
            self._fh.seek(0)
            self._buf = self._fh.read()
        self._ifds: List[Dict[int, Tuple[int, list]]] = []
        off = first_ifd
        while off:
            ifd, off = self._parse_ifd(off)
            self._ifds.append(ifd)
        main = [i for i in self._ifds if not (i.get(_NEW_SUBFILE_TYPE, (0, [0]))[1][0] & 1)]
        self._main = main[0] if main else self._ifds[0]
        self.meta = self._parse_geo(self._main)
        self.height = self._tag(self._main, _IMAGE_LENGTH)[0]
        self.width = self._tag(self._main, _IMAGE_WIDTH)[0]
        self.count = self._tag(self._main, _SAMPLES_PER_PIXEL, [1])[0]
        self.dtype = self._dtype(self._main)
        self.shape = (self.count, self.height, self.width)
        self.overview_count = len(self._ifds) - 1

    def _bytes(self, offset: int, size: int) -> bytes:
        """File bytes [offset, offset+size): from the header cache when
        covered, else a seek+read."""
        if offset + size <= len(self._buf):
            return self._buf[offset : offset + size]
        self._fh.seek(offset)
        return self._fh.read(size)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    def _parse_ifd(self, off: int):
        big = self._big
        head, entry, inline = (8, 20, 8) if big else (2, 12, 4)
        entries = self._bytes(off, head + entry * 4096 + inline)  # generous upper bound
        if big:
            (n,) = struct.unpack_from("<Q", entries, 0)
        else:
            (n,) = struct.unpack_from("<H", entries, 0)
        n = int(n)
        ifd: Dict[int, Tuple[int, list]] = {}
        for i in range(n):
            base = head + entry * i
            tag, ttype, count = struct.unpack_from("<HHQ" if big else "<HHI", entries, base)
            if ttype not in _TYPE_SIZE:
                continue
            size = int(count) * _TYPE_SIZE[ttype]
            vpos = base + (12 if big else 8)
            if size > inline:
                (value_off,) = struct.unpack_from("<Q" if big else "<I", entries, vpos)
                raw = self._bytes(value_off, size)
            else:
                raw = entries[vpos : vpos + size]
            if ttype == _T_ASCII:
                values = [raw]
            else:
                values = list(struct.unpack_from(f"<{count}{_TYPE_FMT[ttype]}", raw, 0))
            ifd[tag] = (ttype, values)
        (next_off,) = struct.unpack_from("<Q" if big else "<I", entries, head + entry * n)
        return ifd, next_off

    @staticmethod
    def _tag(ifd, tag: int, default=None):
        if tag in ifd:
            return ifd[tag][1]
        if default is None:
            raise KeyError(f"TIFF tag {tag} missing")
        return default

    def _dtype(self, ifd) -> np.dtype:
        bits = self._tag(ifd, _BITS_PER_SAMPLE, [8])[0]
        fmt = self._tag(ifd, _SAMPLE_FORMAT, [1])[0]
        try:
            return _TIFF_TO_DTYPE[(fmt, bits)]
        except KeyError as e:
            raise NotImplementedError(f"sample_format={fmt} bits={bits}") from e

    def _parse_geo(self, ifd) -> GeoMeta:
        meta = GeoMeta()
        if _MODEL_TRANSFORMATION in ifd:
            m = self._tag(ifd, _MODEL_TRANSFORMATION)
            meta.transform = (m[0], m[1], m[3], m[4], m[5], m[7])
        elif _MODEL_PIXEL_SCALE in ifd and _MODEL_TIEPOINT in ifd:
            sx, sy = self._tag(ifd, _MODEL_PIXEL_SCALE)[:2]
            tp = self._tag(ifd, _MODEL_TIEPOINT)
            # tiepoint: raster (i, j, k) -> model (x, y, z)
            i, j, _k, x, y, _z = tp[:6]
            meta.transform = (sx, 0.0, x - i * sx, 0.0, -sy, y + j * sy)
        if _GEO_KEY_DIRECTORY in ifd:
            keys = self._tag(ifd, _GEO_KEY_DIRECTORY)
            for p in range(4, len(keys), 4):
                key_id, loc, _count, value = keys[p : p + 4]
                if key_id in (3072, 2048) and loc == 0:
                    meta.crs_epsg = int(value)
        if _GDAL_NODATA in ifd:
            try:
                meta.nodata = float(ifd[_GDAL_NODATA][1][0].split(b"\x00")[0])
            except ValueError:
                pass
        if _GDAL_METADATA in ifd:
            xml = ifd[_GDAL_METADATA][1][0].split(b"\x00")[0].decode("utf-8", "replace")
            meta.tags, meta.descriptions = _parse_gdal_metadata(xml)
        return meta

    def read(
        self,
        band: Optional[int] = None,
        window: Optional[Tuple[int, int, int, int]] = None,
    ) -> np.ndarray:
        """Read (C, H, W) (or (H, W) for a single ``band``), optionally over a
        (col_off, row_off, width, height) window. Only intersecting tiles are
        decoded."""
        ifd = self._main
        c0, r0, w, h = window if window is not None else (0, 0, self.width, self.height)
        bands = range(self.count) if band is None else [band]
        out = np.zeros((len(bands), h, w), self.dtype)
        compression = self._tag(ifd, _COMPRESSION, [1])[0]
        planar = self._tag(ifd, _PLANAR_CONFIG, [1])[0]
        if _TILE_OFFSETS in ifd:
            ts_w = self._tag(ifd, _TILE_WIDTH)[0]
            ts_h = self._tag(ifd, _TILE_LENGTH)[0]
            offsets = self._tag(ifd, _TILE_OFFSETS)
            counts = self._tag(ifd, _TILE_BYTE_COUNTS)
            tiles_down = -(-self.height // ts_h)
            tiles_across = -(-self.width // ts_w)
            tiles_per_plane = tiles_down * tiles_across
            chunky = planar == 1 and self.count > 1  # GDAL COG default interleave
            tr0 = max(r0 // ts_h, 0)
            tr1 = min((r0 + h - 1) // ts_h, tiles_down - 1)
            tc0 = max(c0 // ts_w, 0)
            tc1 = min((c0 + w - 1) // ts_w, tiles_across - 1)
            for tr in range(tr0, tr1 + 1):
                for tc in range(tc0, tc1 + 1):
                    # intersection of tile extent and requested window
                    ry0 = max(tr * ts_h, r0)
                    ry1 = min((tr + 1) * ts_h, r0 + h, self.height)
                    rx0 = max(tc * ts_w, c0)
                    rx1 = min((tc + 1) * ts_w, c0 + w, self.width)
                    if ry1 <= ry0 or rx1 <= rx0:
                        continue
                    ty = slice(ry0 - tr * ts_h, ry1 - tr * ts_h)
                    tx = slice(rx0 - tc * ts_w, rx1 - tc * ts_w)
                    oy = slice(ry0 - r0, ry1 - r0)
                    ox = slice(rx0 - c0, rx1 - c0)
                    if chunky:
                        idx = tr * tiles_across + tc
                        tile = np.frombuffer(
                            self._decode(offsets[idx], counts[idx], compression),
                            self.dtype,
                        ).reshape(ts_h, ts_w, self.count)
                        for bi, b in enumerate(bands):
                            out[bi, oy, ox] = tile[ty, tx, b]
                    else:
                        for bi, b in enumerate(bands):
                            idx = b * tiles_per_plane + tr * tiles_across + tc
                            tile = np.frombuffer(
                                self._decode(offsets[idx], counts[idx], compression),
                                self.dtype,
                            ).reshape(ts_h, ts_w)
                            out[bi, oy, ox] = tile[ty, tx]
        else:  # strip-based (external tools)
            rows_per_strip = self._tag(ifd, _ROWS_PER_STRIP, [self.height])[0]
            offsets = self._tag(ifd, _STRIP_OFFSETS)
            counts = self._tag(ifd, _STRIP_BYTE_COUNTS)
            if planar == 1 and self.count > 1:
                full = np.zeros((self.height, self.width, self.count), self.dtype)
                for si, (o, n) in enumerate(zip(offsets, counts)):
                    raw = self._decode(o, n, compression)
                    row0 = si * rows_per_strip
                    nrows = min(rows_per_strip, self.height - row0)
                    full[row0 : row0 + nrows] = np.frombuffer(
                        raw, self.dtype, nrows * self.width * self.count
                    ).reshape(nrows, self.width, self.count)
                cube = np.moveaxis(full, -1, 0)
            else:
                strips_per_plane = -(-self.height // rows_per_strip)
                cube = np.zeros((self.count, self.height, self.width), self.dtype)
                for b in range(self.count):
                    for si in range(strips_per_plane):
                        idx = b * strips_per_plane + si
                        raw = self._decode(offsets[idx], counts[idx], compression)
                        row0 = si * rows_per_strip
                        nrows = min(rows_per_strip, self.height - row0)
                        cube[b, row0 : row0 + nrows] = np.frombuffer(
                            raw, self.dtype, nrows * self.width
                        ).reshape(nrows, self.width)
            # Zero-padded window extraction: offsets may be negative or
            # overhang the raster (padded plume windows — permian.py).
            ry0, ry1 = max(r0, 0), min(r0 + h, self.height)
            rx0, rx1 = max(c0, 0), min(c0 + w, self.width)
            if ry1 > ry0 and rx1 > rx0:
                out[:, ry0 - r0 : ry1 - r0, rx0 - c0 : rx1 - c0] = cube[
                    list(bands)
                ][:, ry0:ry1, rx0:rx1]
        return out[0] if band is not None else out

    def _decode(self, offset: int, count: int, compression: int) -> bytes:
        raw = self._bytes(offset, count)
        if compression in (8, 32946):  # DEFLATE (Adobe / legacy)
            return zlib.decompress(raw)
        if compression == 1:
            return raw
        raise NotImplementedError(f"TIFF compression {compression}")


def _parse_gdal_metadata(xml: str):
    """Parse the GDAL_METADATA XML into (tags, descriptions)."""
    import re

    tags: Dict[str, str] = {}
    desc: Dict[int, str] = {}
    for m in re.finditer(r"<Item\s+([^>]*)>(.*?)</Item>", xml, re.S):
        attrs = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1)))
        value = _xml_unescape(m.group(2).strip())
        if attrs.get("role") == "description":
            desc[int(attrs.get("sample", 0))] = value
        elif "name" in attrs:
            tags[_xml_unescape(attrs["name"])] = value
    descriptions = [desc[i] for i in sorted(desc)] if desc else []
    return tags, descriptions


def _xml_unescape(s: str) -> str:
    return (
        s.replace("&quot;", '"').replace("&lt;", "<").replace("&gt;", ">").replace("&amp;", "&")
    )


def read_geotiff(
    path: str,
    band: Optional[int] = None,
    window: Optional[Tuple[int, int, int, int]] = None,
) -> Tuple[np.ndarray, GeoMeta]:
    """One-shot read: (array, GeoMeta). ``window`` is (col_off, row_off, w, h)."""
    reader = GeoTIFFReader(path)
    try:
        return reader.read(band=band, window=window), reader.meta
    finally:
        reader.close()


# ---------------------------------------------------------------------------
# Product IO by extension (.tif carries geo metadata; .npy is the fast
# synthetic and test format)
# ---------------------------------------------------------------------------


def save_raster(path: str, array: np.ndarray, **geo_kwargs) -> str:
    """Save by extension: .tif through ``write_geotiff`` (geo keywords
    honoured), .npy through numpy (geo keywords dropped)."""
    if path.endswith((".tif", ".tiff")):
        return write_geotiff(path, array, **geo_kwargs)
    np.save(path, np.asarray(array))
    return path


def load_raster(path: str, window: Optional[Tuple[int, int, int, int]] = None) -> np.ndarray:
    """Load by extension; a single-band raster comes back as (H, W), so .tif
    and .npy products interchange. ``window`` is (col_off, row_off, w, h);
    its offsets may be negative and it may overhang the raster (padded
    plume windows), the area outside the raster zero-filled."""
    if path.endswith((".tif", ".tiff")):
        reader = GeoTIFFReader(path)
        try:
            arr = reader.read(window=window)
        finally:
            reader.close()
        return arr[0] if arr.shape[0] == 1 else arr
    arr = np.load(path, mmap_mode="r")
    if window is None:
        return np.asarray(arr)
    c, r, w, h = window
    hh, ww = arr.shape[-2:]
    ry0, ry1 = max(r, 0), min(r + h, hh)
    rx0, rx1 = max(c, 0), min(c + w, ww)
    out = np.zeros(arr.shape[:-2] + (h, w), arr.dtype)
    if ry1 > ry0 and rx1 > rx0:
        out[..., ry0 - r:ry1 - r, rx0 - c:rx1 - c] = arr[..., ry0:ry1, rx0:rx1]
    return out


def find_raster(folder: str, name: str) -> Optional[str]:
    """The product file ``name`` in ``folder`` (.tif, .tiff, then .npy), or
    None."""
    for ext in (".tif", ".tiff", ".npy"):
        p = os.path.join(folder, name + ext)
        if os.path.exists(p):
            return p
    return None
