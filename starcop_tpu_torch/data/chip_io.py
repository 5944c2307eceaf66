"""Native batch assembly of chip products: ctypes bindings of this package's
``csrc/chip_io.cpp``, and the plans that feed it.

``plan([(path, window), ...])`` reads the products' first bytes in one
threaded native call, parses each header in Python and returns a
``Source`` a product: where each tile or strip that meets the window lies
in the file and where its rows land in an (h, w) float32 destination.
``BatchRead`` gathers the sources of a batch, each bound to its slice of a
preallocated (B, C, h, w) array, and reads them all in one call into the
library, which releases the interpreter lock: a pool of native threads
(one per CPU the process may run on) takes a file at a time, ``pread``s
its tiles or strips (in one read where they lie together), inflates
DEFLATE with zlib, casts to float32 and copies the intersecting rows into
place.

``plan`` takes what ``geotiff.load_raster`` reads into the same values:
single-band, little-endian TIFFs, tiled or striped, uncompressed or DEFLATE
(tags 1, 8 and 32946) without a predictor, of the sample types the reader
knows, and two-dimensional C-ordered ``.npy`` rasters, each with a window
inside the raster. It returns None for anything else (chunky or planar
multi-band TIFFs, windows that overhang the raster, other compressions, a
file it cannot open or a header it cannot follow), and the caller reads
that product as before. A failure inside the read raises ``OSError``
naming the file: a truncated or corrupt file never comes back as zeros.

The library is built like ``native_io``'s (``native_io.build``: ``g++``
with its flags, keyed by source, flags and host, into ``_build/``) and
links zlib; a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ast
import ctypes
import errno
import functools
import os
import struct
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from starcop_tpu_torch.data import native_io

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "chip_io.cpp")
LIB_NAME = "libstarcop_chip_io.so"
LIBS = ("-lz",)

# A job's fields (csrc/chip_io.cpp's Field).
(F_FILE, F_OFFSET, F_COUNT, F_COMPRESSION, F_DTYPE, F_BLOCK_MIN, F_BLOCK_MAX, F_ROW, F_Y0,
 F_X0, F_NY, F_NX, F_DST, F_DST_ROW) = range(14)
JOB_FIELDS = 14
COMP_RAW, COMP_DEFLATE = 0, 1
_CODE_DTYPES = tuple(np.dtype(t) for t in (np.uint8, np.uint16, np.uint32, np.int16, np.int32,
                                            np.float32, np.float64))
DTYPES = {dt: code for code, dt in enumerate(_CODE_DTYPES)}
_ERRORS = {-100001: "the file ends inside a tile or strip",
           -100002: "corrupt DEFLATE data",
           -100003: "a decoded tile or strip has the wrong length",
           -100004: "an inconsistent read job"}

# TIFF: (sample format, bits) -> dtype, as geotiff._TIFF_TO_DTYPE; the tags read.
_TIFF_DTYPES = {(1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32, (2, 16): np.int16,
                (2, 32): np.int32, (3, 32): np.float32, (3, 64): np.float64}
_TIFF_COMPRESSION = {1: COMP_RAW, 8: COMP_DEFLATE, 32946: COMP_DEFLATE}
_TAGS = {254, 256, 257, 258, 259, 273, 277, 278, 279, 317, 322, 323, 324, 325, 339}
_TAG_TYPES = {3: ("H", 2), 4: ("I", 4), 16: ("Q", 8)}  # SHORT, LONG, LONG8
_HEAD = 4096
NPY_BAND_ROWS = 128  # rows of a .npy raster a job reads

_SIGNATURES = {
    "starcop_chip_job_fields": (ctypes.c_int, []),
    "starcop_chip_threads": (ctypes.c_int, [ctypes.c_int32]),
    "starcop_chip_heads": (None, [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int32]),
    "starcop_chip_read": (ctypes.c_int, [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                                         ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                                         ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)]),
}


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    """Build (once per key) and load the library, its signatures declared."""
    with native_io._BUILD_LOCK:
        lib = ctypes.CDLL(native_io.build(SOURCE, LIB_NAME, "chipio", LIBS))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    if lib.starcop_chip_job_fields() != JOB_FIELDS:
        raise RuntimeError(f"{SOURCE}: {lib.starcop_chip_job_fields()} job fields, "
                           f"chip_io.py has {JOB_FIELDS}")
    return lib


def threads() -> int:
    """The threads a call runs on: one per CPU the process may run on."""
    return int(_load().starcop_chip_threads(0))


class Layout(NamedTuple):
    """A raster as blocks: tiles, or strips of ``block_h`` full rows."""

    height: int
    width: int
    dtype: np.dtype
    compression: int
    block_h: int
    block_w: int
    tiled: bool
    offsets: np.ndarray  # int64, a block
    counts: np.ndarray  # int64 bytes in the file, a block


class _Head(NamedTuple):
    """A file's first bytes, as the library read them, and its size."""

    path: str
    data: bytes
    size: int

    def read(self, offset: int, size: int) -> bytes:
        """File bytes [offset, offset + size): from ``data`` where it holds
        them, else from the file (fewer at its end)."""
        if offset + size <= len(self.data):
            return self.data[offset:offset + size]
        with open(self.path, "rb") as fh:
            fh.seek(offset)
            return fh.read(size)


def _ifd(head: _Head, offset: int, big: bool):
    """The values of the tags of ``_TAGS`` in the IFD at ``offset`` (tuples),
    and the next IFD's offset; None where a tag has a type the Python reader
    skips."""
    hsz, esz, inline = (8, 20, 8) if big else (2, 12, 4)
    (n,) = struct.unpack("<Q" if big else "<H", head.read(offset, hsz))
    body = head.read(offset + hsz, n * esz + inline)
    off_fmt = "<Q" if big else "<I"
    tags = {}
    for i in range(n):
        base = i * esz
        tag, ttype = struct.unpack_from("<HH", body, base)
        if tag not in _TAGS:
            continue
        if ttype not in _TAG_TYPES:
            return None, 0
        fmt, itemsize = _TAG_TYPES[ttype]
        (count,) = struct.unpack_from(off_fmt, body, base + 4)
        vpos = base + (12 if big else 8)
        if count * itemsize <= inline:
            raw, at = body, vpos
        else:
            raw, at = head.read(struct.unpack_from(off_fmt, body, vpos)[0], count * itemsize), 0
        tags[tag] = struct.unpack_from(f"<{count}{fmt}", raw, at)
    (nxt,) = struct.unpack_from(off_fmt, body, n * esz)
    return tags, nxt


def _first(tags, tag: int, default=None) -> Optional[int]:
    """A tag's first value, ``default`` where it is absent, None where it
    holds no value."""
    v = tags.get(tag)
    if v is None:
        return default
    return v[0] if v else None


def _tiff_layout(head: _Head) -> Optional[Layout]:
    data = head.data
    if data[:2] != b"II":
        return None
    (magic,) = struct.unpack_from("<H", data, 2)
    if magic == 42:
        big, (offset,) = False, struct.unpack_from("<I", data, 4)
    elif magic == 43:
        big, (offsize, zero, offset) = True, struct.unpack_from("<HHQ", data, 4)
        if offsize != 8 or zero != 0:
            return None
    else:
        return None
    seen = set()
    while True:  # the first IFD that is not an overview, as GeoTIFFReader's main
        if not offset or offset in seen:
            return None
        seen.add(offset)
        tags, nxt = _ifd(head, offset, big)
        if tags is None:
            return None
        subfile = _first(tags, 254, 0)
        if subfile is None:
            return None
        if not subfile & 1:
            break
        offset = nxt

    def one(tag, default=None):
        return _first(tags, tag, default)

    height, width = one(257), one(256)
    dtype = _TIFF_DTYPES.get((one(339, 1), one(258, 8)))
    compression = _TIFF_COMPRESSION.get(one(259, 1))
    if (None in (height, width, dtype, compression) or one(277, 1) != 1
            or one(317, 1) != 1 or min(height, width) <= 0):
        return None
    if 324 in tags:
        bh, bw, tiled = one(323), one(322), True
        offsets, counts = tags.get(324), tags.get(325)
    else:
        bh, bw, tiled = one(278, height), width, False
        offsets, counts = tags.get(273), tags.get(279)
    if bh is None or bw is None or offsets is None or counts is None or min(bh, bw) <= 0:
        return None
    n_blocks = -(-height // bh) * -(-width // bw)
    if len(offsets) < n_blocks or len(counts) < n_blocks:
        return None
    return Layout(height, width, np.dtype(dtype), compression, bh, bw, tiled,
                  np.asarray(offsets, np.int64), np.asarray(counts, np.int64))


def _npy_layout(head: _Head) -> Optional[Layout]:
    """The .npy header (format versions 1-3: magic, version, header length,
    then the header dict's literal) as raw strips of ``NPY_BAND_ROWS``."""
    data = head.data
    if data[:6] != b"\x93NUMPY" or len(data) < 12 or data[6] not in (1, 2, 3):
        return None
    start = 10 + struct.unpack_from("<H", data, 8)[0] if data[6] == 1 else \
        12 + struct.unpack_from("<I", data, 8)[0]
    header = ast.literal_eval(head.read(0, start)[10 if data[6] == 1 else 12:].decode(
        "latin1" if data[6] < 3 else "utf8"))
    if not isinstance(header, dict) or header.get("fortran_order") is not False:
        return None
    shape, dtype = header.get("shape"), np.dtype(header.get("descr"))
    if not isinstance(shape, tuple) or len(shape) != 2 or dtype not in DTYPES or min(shape) <= 0:
        return None
    height, width = shape
    row = width * dtype.itemsize
    if head.size < start + height * row:  # np.load refuses such a file
        return None
    bands = np.arange(0, height, NPY_BAND_ROWS, dtype=np.int64)
    counts = np.minimum(NPY_BAND_ROWS, height - bands) * row
    return Layout(height, width, dtype, COMP_RAW, NPY_BAND_ROWS, width, False,
                  start + bands * row, counts)


class _Template(NamedTuple):
    blocks: np.ndarray  # block index of each job
    jobs: np.ndarray  # (n, JOB_FIELDS): F_OFFSET a skip, F_DST a byte offset, F_FILE unset
    count_lo: np.ndarray  # the file's bytes a raw block needs, at least
    count_hi: np.ndarray  # and at most


@functools.lru_cache(maxsize=256)
def _template(height: int, width: int, block_h: int, block_w: int, tiled: bool, dtype: int,
              compression: int, window: Tuple[int, int, int, int]) -> _Template:
    """The jobs of one product of this geometry under ``window``, but for
    the file and the block offsets and counts, which ``Source.jobs`` adds."""
    c0, r0, w, h = window
    itemsize = _CODE_DTYPES[dtype].itemsize
    across = -(-width // block_w)
    blocks, jobs, lo, hi = [], [], [], []
    for br in range(r0 // block_h, (r0 + h - 1) // block_h + 1):
        rows = block_h if tiled else min(block_h, height - br * block_h)
        block_bytes = rows * block_w * itemsize
        for bc in range(c0 // block_w, (c0 + w - 1) // block_w + 1):
            ry0, ry1 = max(br * block_h, r0), min((br + 1) * block_h, r0 + h)
            rx0, rx1 = max(bc * block_w, c0), min((bc + 1) * block_w, c0 + w)
            y0, x0 = ry0 - br * block_h, rx0 - bc * block_w
            job = [0] * JOB_FIELDS
            job[F_COMPRESSION], job[F_DTYPE], job[F_ROW] = compression, dtype, block_w
            job[F_X0], job[F_NY], job[F_NX] = x0, ry1 - ry0, rx1 - rx0
            job[F_DST], job[F_DST_ROW] = ((ry0 - r0) * w + rx0 - c0) * 4, w
            if compression == COMP_RAW:  # only the rows that meet the window
                job[F_OFFSET] = y0 * block_w * itemsize
                job[F_COUNT] = job[F_BLOCK_MIN] = job[F_BLOCK_MAX] = \
                    (ry1 - ry0) * block_w * itemsize
                # GeoTIFFReader takes a raw tile of exactly its size and a
                # strip of at least its rows.
                lo.append(block_bytes)
                hi.append(block_bytes if tiled else np.iinfo(np.int64).max)
            else:
                job[F_Y0], job[F_BLOCK_MIN] = y0, block_bytes
                job[F_BLOCK_MAX] = block_bytes if tiled else -1
                lo.append(0)
                hi.append(np.iinfo(np.int64).max)
            blocks.append(br * across + bc)
            jobs.append(job)
    return _Template(np.asarray(blocks, np.int64), np.asarray(jobs, np.int64),
                     np.asarray(lo, np.int64), np.asarray(hi, np.int64))


class Source:
    """One product's planned read: ``shape`` (h, w), and its jobs."""

    __slots__ = ("path", "shape", "_template", "_offsets", "_counts")

    def __init__(self, path: str, layout: Layout, window: Tuple[int, int, int, int]):
        self.path = path
        self.shape = (window[3], window[2])
        t = self._template = _template(layout.height, layout.width, layout.block_h,
                                       layout.block_w, layout.tiled, DTYPES[layout.dtype],
                                       layout.compression, window)
        self._offsets = layout.offsets[t.blocks]
        self._counts = layout.counts[t.blocks]

    def valid(self) -> bool:
        """Every raw block holds the bytes GeoTIFFReader would take."""
        t = self._template
        return bool(((self._counts >= t.count_lo) & (self._counts <= t.count_hi)).all())

    def jobs(self, file: int, dst_address: int) -> np.ndarray:
        t = self._template
        jobs = t.jobs.copy()
        jobs[:, F_FILE] = file
        jobs[:, F_OFFSET] += self._offsets
        if t.jobs[0, F_COMPRESSION] == COMP_DEFLATE:
            jobs[:, F_COUNT] = self._counts
        jobs[:, F_DST] += dst_address
        return jobs


def plan(products: Sequence[Tuple[str, Optional[Tuple[int, int, int, int]]]]
         ) -> List[Optional[Source]]:
    """The native reads of ``products`` [(path, window)], windows as
    (col_off, row_off, width, height) or None for the whole raster: each a
    ``Source``, or None where the library does not take it (see the
    module's docstring). The files' heads are read in one threaded call."""
    n = len(products)
    if not n:
        return []
    heads = np.empty((n, _HEAD), np.uint8)
    lengths, sizes = np.empty(n, np.int64), np.empty(n, np.int64)
    paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p, _ in products])
    _load().starcop_chip_heads(paths, n, _HEAD, heads.ctypes.data, lengths.ctypes.data,
                               sizes.ctypes.data, 0)
    out: List[Optional[Source]] = []
    for (path, window), row, length, size in zip(products, heads, lengths.tolist(),
                                                 sizes.tolist()):
        out.append(None if length < 0 else
                   _source(_Head(path, row[:length].tobytes(), size), window))
    return out


def _source(head: _Head, window) -> Optional[Source]:
    try:
        layout = _tiff_layout(head) if head.path.endswith((".tif", ".tiff")) else \
            _npy_layout(head)
    except (struct.error, ValueError, TypeError, SyntaxError, OSError):
        return None
    if layout is None:
        return None
    c0, r0, w, h = (0, 0, layout.width, layout.height) if window is None else window
    if c0 < 0 or r0 < 0 or w <= 0 or h <= 0 or c0 + w > layout.width or r0 + h > layout.height:
        return None
    source = Source(head.path, layout, (c0, r0, w, h))
    return source if source.valid() else None


class BatchRead:
    """Sources bound to their destinations, read in one native call."""

    def __init__(self):
        self._paths: List[str] = []
        self._jobs: List[np.ndarray] = []

    def add(self, source: Source, dst: np.ndarray) -> None:
        """Read ``source`` into ``dst``, a C-contiguous float32 array of its
        shape that outlives ``run``."""
        if dst.dtype != np.float32 or dst.shape != source.shape or not dst.flags.c_contiguous:
            raise ValueError(f"{source.path}: destination {dst.dtype} {dst.shape} for "
                             f"float32 {source.shape}")
        self._jobs.append(source.jobs(len(self._paths), dst.ctypes.data))
        self._paths.append(source.path)

    def run(self) -> None:
        """Every source into its destination; a failure raises ``OSError``
        naming its file."""
        if not self._paths:
            return
        jobs = np.ascontiguousarray(np.concatenate(self._jobs))
        paths = (ctypes.c_char_p * len(self._paths))(*[os.fsencode(p) for p in self._paths])
        failed = ctypes.c_int64(-1)
        rc = _load().starcop_chip_read(paths, len(self._paths),
                                       jobs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                       len(jobs), 0, ctypes.byref(failed))
        if rc:
            path = self._paths[failed.value] if 0 <= failed.value < len(self._paths) else "?"
            if rc in _ERRORS:
                raise OSError(errno.EIO, f"chip read: {_ERRORS[rc]}", path)
            raise OSError(-rc, f"chip read: {os.strerror(-rc)}", path)

