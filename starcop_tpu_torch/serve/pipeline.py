"""Pipelined granule serving on the card (counterpart of starcop_tpu/serve/pipeline.py).

Three stages in their own threads, joined by bounded queues:

    reader (host: h5 read, wire encode, upload)  ->  compute (device: wire
    decode, masked matched filter, renormalisation, whole-scene U-Net, one
    stacked download)  ->  writer (host: GeoTIFF products)

While granule N computes on the card, granule N+1 is read and uploaded and
granule N-1 written; throughput approaches max(read, compute, write).

The JAX package's ``read_fn`` is split here: ``read_granule`` reads the h5
file and ``encode_payload`` (numpy only) builds the wire payload; an
``Uploader`` moves it to the card from pinned host memory on a side stream.
``make_compute_fn`` and ``make_write_fn`` are the other two stages, so a
caller can build a ``ScenePipeline`` over granules held in memory.

One intended deviation from the JAX package: the f16 download clamps
mf / 16 to +-65504 before the cast, where JAX's cast turns |mf| > ~1.05e6
into +-inf (ROADMAP section 3).
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from starcop_tpu_torch.data import native_io
from starcop_tpu_torch.data.emit import EMITRawScene, glt_gather
from starcop_tpu_torch.data.geotiff import write_geotiff
from starcop_tpu_torch.device import DeviceLike, resolve_device
from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands
from starcop_tpu_torch.ops.mag1c import NODATA
from starcop_tpu_torch.scenes.emit_pipeline import emit_granule_to_mask

logger = logging.getLogger("starcop_tpu_torch.serve")

_SENTINEL = object()
WIRE_CODECS = ("f32", "u12", "u10", "u16", "bf16")
# mag1c rides the f16 wire scaled by 1/16 (an exact power of 2), so values
# to ~16 * 65504 ppm*m keep f16 range at unchanged mantissa error.
MF_F16_SCALE = 16.0
F16_MAX = 65504.0


@dataclass
class SceneResult:
    name: str
    outputs: Dict[str, np.ndarray]
    timings: Dict[str, float] = field(default_factory=dict)
    error: Optional[str] = None


class ScenePipeline:
    """Threaded read | compute | write pipeline over scene descriptors.

    Args:
        read_fn: name -> payload dict (host IO; runs in the reader thread).
        compute_fn: payload dict -> outputs dict (device compute; one compute
            thread keeps single-device dispatch ordered). For several devices
            pass ``compute_fns`` instead: one callable per device, each in
            its own worker thread draining the shared read queue (scenes are
            independent: no collectives).
        write_fn: optional (name, outputs) -> None (host IO; writer thread).
        queue_size: bounded stage queues (backpressure; default 2 = double
            buffering per compute worker).

    A scene whose read, compute or write raises is logged and reported in
    its ``SceneResult.error``; the other scenes go on.
    """

    def __init__(
        self,
        read_fn: Callable[[str], Dict],
        compute_fn: Optional[Callable[[Dict], Dict]] = None,
        write_fn: Optional[Callable[[str, Dict], None]] = None,
        queue_size: int = 2,
        compute_fns: Optional[List[Callable[[Dict], Dict]]] = None,
    ):
        if (compute_fn is None) == (compute_fns is None):
            raise ValueError("Provide exactly one of compute_fn / compute_fns")
        self.read_fn = read_fn
        self.compute_fns = list(compute_fns) if compute_fns is not None else [compute_fn]
        self.write_fn = write_fn
        self.queue_size = queue_size

    def run(self, names: Iterable[str]) -> List[SceneResult]:
        n_workers = len(self.compute_fns)
        read_q: queue.Queue = queue.Queue(maxsize=self.queue_size * n_workers)
        write_q: queue.Queue = queue.Queue(maxsize=self.queue_size * n_workers)
        results: List[SceneResult] = []
        results_lock = threading.Lock()

        def reader():
            for name in names:
                t0 = time.time()
                try:
                    payload = self.read_fn(name)
                    read_q.put((name, payload, time.time() - t0))
                except Exception as e:  # noqa: BLE001 -- isolate scene failures
                    logger.exception("read failed for %s", name)
                    with results_lock:
                        results.append(SceneResult(name, {}, error=f"read: {e}"))
            for _ in range(n_workers):
                read_q.put(_SENTINEL)

        def computer(fn):
            while True:
                item = read_q.get()
                if item is _SENTINEL:
                    write_q.put(_SENTINEL)
                    return
                name, payload, t_read = item
                t0 = time.time()
                try:
                    outputs = fn(payload)
                    write_q.put((name, outputs, {"read_s": t_read, "compute_s": time.time() - t0}))
                except Exception as e:  # noqa: BLE001
                    logger.exception("compute failed for %s", name)
                    with results_lock:
                        results.append(SceneResult(name, {}, error=f"compute: {e}"))

        def writer():
            done_workers = 0
            while done_workers < n_workers:
                item = write_q.get()
                if item is _SENTINEL:
                    done_workers += 1
                    continue
                name, outputs, timings = item
                t0 = time.time()
                try:
                    if self.write_fn is not None:
                        self.write_fn(name, outputs)
                    timings["write_s"] = time.time() - t0
                    with results_lock:
                        results.append(SceneResult(name, outputs, timings))
                except Exception as e:  # noqa: BLE001
                    logger.exception("write failed for %s", name)
                    with results_lock:
                        results.append(SceneResult(name, outputs, timings, error=f"write: {e}"))

        threads = [threading.Thread(target=reader, daemon=True)]
        threads += [threading.Thread(target=computer, args=(fn,), daemon=True)
                    for fn in self.compute_fns]
        threads += [threading.Thread(target=writer, daemon=True)]
        t_start = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t_start
        ok = [r for r in results if r.error is None]
        logger.info("pipeline: %d scenes (%d ok, %d workers) in %.2fs (%.2fs/scene)",
                    len(results), len(ok), n_workers, wall, wall / max(len(results), 1))
        return results


# ---------------------------------------------------------------------------
# Reader stage: h5 read, wire encode (numpy), upload
# ---------------------------------------------------------------------------


def wire_codec(upload_dtype) -> str:
    """The upload wire named by ``upload_dtype``: None or "f32" (the f32
    cube), "u12", "u10", "u16" (np.uint16) or "bf16" (torch.bfloat16)."""
    if upload_dtype is None:
        return "f32"
    if isinstance(upload_dtype, str):
        name = upload_dtype.lower()
    elif isinstance(upload_dtype, torch.dtype):
        name = {torch.float32: "f32", torch.bfloat16: "bf16"}.get(upload_dtype)
    else:
        name = {np.dtype(np.float32): "f32", np.dtype(np.uint16): "u16"}.get(np.dtype(upload_dtype))
    if name not in WIRE_CODECS:
        raise ValueError(f"upload_dtype {upload_dtype!r} is none of {WIRE_CODECS}")
    return name


def read_granule(path: str, georeference: bool = False) -> Dict:
    """Read a raw EMIT granule: the band-selected (H, W, S) float32 cube, the
    (H, W, 3) RGB planes, the fill value, the band grid and the geo fields."""
    scene = EMITRawScene(path)
    try:
        sel = scene.band_slice()
        return {
            "cube": np.ascontiguousarray(scene.read_bands(sel), np.float32),
            "rgb": scene.read_rgb().astype(np.float32),
            "fill_value": scene.fill_value,
            "wavelengths": scene.wavelengths[sel],
            "fwhm": scene.fwhm[sel],
            "glt": (scene.glt_x, scene.glt_y, scene.fill_value) if georeference else None,
            "transform": scene.transform,
            "crs_epsg": scene.crs_epsg,
        }
    finally:
        scene.close()


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), rounding to nearest even."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16).astype(np.uint16)
    return np.where(np.isnan(x), np.uint16(0x7FC0), rounded)


def _u16_grid(x: np.ndarray, lo: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Per-band affine 16-bit grid; NaN maps to 0 before the integer cast
    (numpy's float -> uint cast of NaN is platform-defined)."""
    return np.nan_to_num(np.clip(np.rint((x - lo) / scale), 0, 65535), nan=0.0).astype(np.uint16)


def encode_payload(granule: Dict, upload_dtype=None) -> Dict:
    """The wire payload of a granule (``read_granule``'s dict), numpy only.

    Validity comes from the original f32 values (narrowing rounds or clips
    the fill value). Per codec, the cube travels as

      * "f32": as read;
      * "u12": a per-band affine 12-bit grid over the valid range, band
        pairs packed 2 values / 3 bytes; an odd last band rides unpaired as
        an f32 plane (``q_tail``);
      * "u10": a per-band affine 10-bit grid, pixel quads packed 4 values /
        5 bytes;
      * "u16": a per-band affine 16-bit grid;
      * "bf16": bfloat16 bit patterns (round to nearest even).

    The RGB planes ride as per-band affine u16 under u12 / u16, the u10 pack
    under u10, else f32. The valid mask ships bit-packed. Returns
    {"codec", "wire" (arrays to upload), "valid_host" (the (H, W) bool mask,
    kept on the host), "wavelengths", "fwhm", "glt", "transform", "crs_epsg"}.
    """
    codec = wire_codec(upload_dtype)
    cube, fill = granule["cube"], granule["fill_value"]
    wire: Dict[str, np.ndarray] = {}
    if codec == "u12":
        s_total = cube.shape[-1]
        s_even = s_total - s_total % 2
        valid, lo, hi = native_io.valid_band_minmax(cube, fill, n_minmax_bands=s_even)
        body = cube
        if s_total % 2:
            wire["q_tail"] = np.ascontiguousarray(cube[..., s_even:])
            body = np.ascontiguousarray(cube[..., :s_even])
        scale = np.maximum((hi - lo) / 4095.0, 1e-12).astype(np.float32)
        wire["q_lo"], wire["q_scale"] = lo, scale
        wire["cube"] = native_io.quantize_pack12(body, lo, scale)
    elif codec == "u10":
        valid, lo, hi = native_io.valid_band_minmax(cube, fill)
        scale = np.maximum((hi - lo) / 1023.0, 1e-12).astype(np.float32)
        wire["q_lo"], wire["q_scale"] = lo, scale
        wire["cube"] = native_io.quantize_pack10(cube, lo, scale)
    elif codec == "u16":
        valid, lo, hi = native_io.valid_band_minmax(cube, fill)
        scale = np.maximum((hi - lo) / 65535.0, 1e-12).astype(np.float32)
        wire["q_lo"], wire["q_scale"] = lo, scale
        wire["cube"] = _u16_grid(cube, lo, scale)
    else:
        valid, _, _ = native_io.valid_band_minmax(cube, fill, n_minmax_bands=0)
        wire["cube"] = _bf16_bits(cube) if codec == "bf16" else cube

    rgb_hwc = granule["rgb"]
    if codec == "u10":
        r_lo, r_hi = native_io.band_minmax(rgb_hwc, valid)
        r_scale = np.maximum((r_hi - r_lo) / 1023.0, 1e-12).astype(np.float32)
        wire["rgb_lo"], wire["rgb_scale"] = r_lo, r_scale
        wire["rgb"] = native_io.quantize_pack10(rgb_hwc, r_lo, r_scale)
    elif codec in ("u12", "u16"):
        r_lo, r_hi = native_io.band_minmax(rgb_hwc, valid)
        r_scale = np.maximum((r_hi - r_lo) / 65535.0, 1e-12).astype(np.float32)
        wire["rgb_lo"], wire["rgb_scale"] = r_lo, r_scale
        wire["rgb"] = _u16_grid(np.moveaxis(rgb_hwc, -1, 0), r_lo[:, None, None],
                                r_scale[:, None, None])
    else:
        wire["rgb"] = np.ascontiguousarray(np.moveaxis(rgb_hwc, -1, 0), np.float32)
    wire["valid"] = np.packbits(valid.ravel())
    return {
        "codec": codec, "wire": wire, "valid_host": valid,
        **{k: granule[k] for k in ("wavelengths", "fwhm", "glt", "transform", "crs_epsg")},
    }


def _as_torch(a: np.ndarray) -> torch.Tensor:
    """Host wire array as a tensor; uint16 travels as its int16 bits."""
    return torch.from_numpy(np.ascontiguousarray(a.view(np.int16) if a.dtype == np.uint16 else a))


class Uploader:
    """Wire payload -> tensors on ``device``, started in the reader stage.

    On a CUDA device each array is staged in pinned host memory and copied
    on a side stream; ``payload["ready"]`` is an event recorded after the
    copies, which the compute stream waits on. Staging buffers are reused
    per (wire key, shape, dtype), and a buffer is handed out again only
    once the copy that read it has finished, so a host buffer always
    outlives its asynchronous copy. Keying by the wire name matters: two
    arrays of one upload can share shape and dtype (``q_lo`` and
    ``q_scale``), and a pool keyed by shape alone would stage the second
    over the first while its copy is still queued. On the CPU the arrays
    are wrapped without a copy.
    """

    MAX_BUFFERS = 3  # per (wire key, shape, dtype)

    def __init__(self, device: DeviceLike):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._pool: Dict[tuple, List[list]] = {}  # key -> [[host tensor, event], ...]

    def _staging(self, key: str, a: torch.Tensor) -> list:
        """A [host buffer, event] slot for wire array ``key``: one whose last
        copy has finished, else a new one (pinned on a CUDA device), else the
        oldest after waiting for its copy."""
        slots = self._pool.setdefault((key, tuple(a.shape), a.dtype), [])
        for slot in slots:
            if slot[1] is None or slot[1].query():
                return slot
        if len(slots) < self.MAX_BUFFERS:
            slots.append([torch.empty(a.shape, dtype=a.dtype, pin_memory=self.cuda), None])
            return slots[-1]
        slot = slots.pop(0)  # the oldest copy: wait for it to finish
        slot[1].synchronize()
        slots.append(slot)
        return slot

    def __call__(self, payload: Dict) -> Dict:
        host = {k: _as_torch(a) for k, a in payload["wire"].items()}
        if not self.cuda:
            return {**payload, "wire": {k: t.to(self.device) for k, t in host.items()},
                    "ready": None}
        used, wire = [], {}
        with torch.cuda.stream(self.stream):
            for k, t in host.items():
                slot = self._staging(k, t)
                slot[0].copy_(t)
                wire[k] = slot[0].to(self.device, non_blocking=True)
                used.append(slot)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        for slot in used:
            slot[1] = ready
        return {**payload, "wire": wire, "ready": ready}


# ---------------------------------------------------------------------------
# Compute stage: device decode (plain torch), granule -> mask, one download
# ---------------------------------------------------------------------------


def unpack_valid(bits: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """np.packbits'd (big bit order) mask -> (H, W) bool."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    return ((bits[:, None] >> shifts) & 1).bool().reshape(-1)[: h * w].reshape(h, w)


def _u16(t: torch.Tensor) -> torch.Tensor:
    """uint16 wire values (carried as int16 bits) -> int32."""
    return t.to(torch.int32) & 0xFFFF


def dequant12(p: torch.Tensor, lo, scale, tail=None) -> torch.Tensor:
    """u12 band-pair planes (3, H, W, S/2) -> (H, W, S) float32 (the f32
    tail band, if any, appended)."""
    b = p.to(torch.int32)
    q0 = b[0] | ((b[1] & 0xF) << 8)
    q1 = (b[1] >> 4) | (b[2] << 4)
    h, w, sh = q0.shape
    x = torch.stack([q0, q1], dim=-1).reshape(h, w, 2 * sh).float() * scale + lo
    return x if tail is None else torch.cat([x, tail], dim=-1)


def dequant10(p: torch.Tensor, lo, scale, h: int, w: int) -> torch.Tensor:
    """u10 pixel-quad planes (5, G, S) -> (H, W, S) float32."""
    b = p.to(torch.int32)
    q0 = b[0] | ((b[1] & 0x3) << 8)
    q1 = (b[1] >> 2) | ((b[2] & 0xF) << 6)
    q2 = (b[2] >> 4) | ((b[3] & 0x3F) << 4)
    q3 = (b[3] >> 6) | (b[4] << 2)
    g, s = q0.shape
    q = torch.stack([q0, q1, q2, q3], dim=1).reshape(4 * g, s)
    return (q[: h * w].float() * scale + lo).reshape(h, w, s)


def decode_wire(codec: str, wire: Dict[str, torch.Tensor], h: int, w: int):
    """Device-side decode of a wire payload -> (cube (H, W, S), rgb (3, H, W)
    float32, valid (H, W) bool)."""
    valid = unpack_valid(wire["valid"], h, w)
    c = wire["cube"]
    if codec == "u12":
        cube = dequant12(c, wire["q_lo"], wire["q_scale"], wire.get("q_tail"))
    elif codec == "u10":
        cube = dequant10(c, wire["q_lo"], wire["q_scale"], h, w)
    elif codec == "u16":
        cube = _u16(c).float() * wire["q_scale"] + wire["q_lo"]
    elif codec == "bf16":
        cube = (c.to(torch.int32) << 16).view(torch.float32)
    else:
        cube = c
    r = wire["rgb"]
    if codec == "u10":
        rgb = dequant10(r, wire["rgb_lo"], wire["rgb_scale"], h, w).permute(2, 0, 1)
    elif codec in ("u12", "u16"):
        rgb = _u16(r).float() * wire["rgb_scale"][:, None, None] + wire["rgb_lo"][:, None, None]
    else:
        rgb = r
    return cube, rgb, valid


def _download_f16(download_dtype) -> bool:
    if download_dtype is None:
        return False
    name = str(download_dtype).lower()
    if name not in ("f16", "f32"):
        raise ValueError(f"download_dtype must be 'f16', 'f32' or None, got {download_dtype!r}")
    return name == "f16"


def _check_stream_dtype(stream_dtype) -> None:
    if stream_dtype is not None and stream_dtype not in (torch.float32, np.float32, "f32"):
        raise NotImplementedError(
            f"stream_dtype={stream_dtype!r}: the bf16 stream needs the bf16-dots kernels "
            "(K2's bf16_dots, K3 and K4 in ROADMAP.md), which are not ported yet")


def _model_on(model_apply: Callable, dev: torch.device) -> Callable:
    """An nn.Module on ``dev`` (a copy when it lives elsewhere); any other
    callable as given."""
    if not isinstance(model_apply, torch.nn.Module):
        return model_apply
    first = next(iter(model_apply.parameters()), None)
    if first is None or first.device == dev:
        return model_apply
    return copy.deepcopy(model_apply).to(dev).eval()


def finalize_outputs(payload: Dict, pred: np.ndarray, mf: np.ndarray) -> Dict:
    """The products of a granule: mag1c and prediction, their GLT-gathered
    versions when the payload carries a GLT, and the geo fields for the writer."""
    out = {"mag1c": mf, "prediction": pred}
    nodata = {"mag1c": NODATA}
    if payload["glt"] is not None:
        glt_x, glt_y, fill = payload["glt"]
        for key, fill_v in (("mag1c", fill), ("prediction", 0.0)):
            out[f"{key}_geo"] = glt_gather(glt_x, glt_y, out[key], fill_v)
        nodata["mag1c_geo"] = fill
    out["__geo__"] = {"transform": payload.get("transform"),
                      "crs_epsg": payload.get("crs_epsg"), "nodata": nodata}
    return out


def make_compute_fn(
    model_apply: Callable,
    device: DeviceLike = None,
    *,
    column_step: int = 32,
    num_iter: int = 30,
    download_dtype="f16",
    stream_dtype=None,
) -> Callable[[Dict], Dict]:
    """The compute stage on ``device`` (None: the CUDA card): payload ->
    products. Uploads the payload itself when the reader did not (an
    explicit device list), waits for the upload's event, decodes the wire,
    runs ``emit_granule_to_mask`` with the valid mask, and downloads
    (prediction, mf) as ONE stacked transfer: f16 (mf / 16, clamped to
    +-65504) or f32 (``download_dtype`` None / "f32"). NODATA is restored on
    the host from the reader's mask after an f16 download."""
    _check_stream_dtype(stream_dtype)
    down_f16 = _download_f16(download_dtype)
    dev = resolve_device(device)
    model = _model_on(model_apply, dev)
    upload = Uploader(dev)
    templates: Dict[tuple, torch.Tensor] = {}

    def compute_fn(payload: Dict) -> Dict:
        if "ready" not in payload:
            payload = upload(payload)
        wl, fwhm = payload["wavelengths"], payload["fwhm"]
        key = (np.asarray(wl, np.float64).tobytes(), np.asarray(fwhm, np.float64).tobytes())
        if key not in templates:
            templates[key] = torch.as_tensor(generate_template_from_bands(wl, fwhm)[:, 1],
                                             dtype=torch.float32, device=dev)
        h, w = payload["valid_host"].shape
        on_card = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with on_card, torch.inference_mode():
            wire = payload["wire"]
            if payload["ready"] is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(payload["ready"])
                for t in wire.values():
                    t.record_stream(stream)
            cube, rgb, valid = decode_wire(payload["codec"], wire, h, w)
            pred, mf = emit_granule_to_mask(cube, rgb, templates[key], model,
                                            column_step=column_step, num_iter=num_iter,
                                            valid_mask=valid, device=dev)
            if down_f16:
                both = torch.stack([pred, mf / MF_F16_SCALE]).clamp(-F16_MAX, F16_MAX)
                both = both.to(torch.float16)
            else:
                both = torch.stack([pred, mf])
            host = both.cpu().numpy()  # the one download
        if not down_f16:
            return finalize_outputs(payload, host[0], host[1])
        host = host.astype(np.float32)
        # Exact NODATA where the reader found the fill value; the f16 cast
        # rounded the sentinel.
        mf_host = np.where(payload["valid_host"], host[1] * MF_F16_SCALE, np.float32(NODATA))
        return finalize_outputs(payload, host[0], mf_host)

    return compute_fn


def make_write_fn(output_dir: str, compress_outputs=False) -> Callable[[str, Dict], None]:
    """The writer stage: one GeoTIFF per product under ``output_dir/<name>/``.
    The granule's transform describes the GLT-mapped (ortho) grid, so only
    the *_geo products carry it."""

    def write_fn(name: str, outputs: Dict) -> None:
        geo = outputs.pop("__geo__", {})
        transform, crs_epsg = geo.get("transform"), geo.get("crs_epsg")
        nodata = geo.get("nodata", {})
        base = os.path.join(output_dir, os.path.splitext(os.path.basename(name))[0])
        os.makedirs(base, exist_ok=True)
        for key, arr in outputs.items():
            on_ortho_grid = key.endswith("_geo")
            write_geotiff(
                os.path.join(base, f"{key}.tif"),
                np.asarray(arr, np.float32),
                transform=transform if on_ortho_grid else None,
                crs_epsg=crs_epsg if on_ortho_grid else None,
                nodata=nodata.get(key),
                descriptions=["CH4 Absorption (ppm x m)" if "mag1c" in key else "plume probability"],
                compress=compress_outputs,
            )

    return write_fn


def emit_serving_pipeline(
    model_apply: Callable,
    output_dir: str,
    column_step: int = 32,
    num_iter: int = 30,
    georeference: bool = False,
    queue_size: int = 2,
    stream_dtype=None,
    devices: Optional[List] = None,
    upload_dtype=None,
    download_dtype="f16",
    compress_outputs=False,
) -> ScenePipeline:
    """Ready-made pipeline: raw EMIT granule paths -> mag1c + plume masks.

    ``devices``: None means one compute worker on the CUDA card (raises
    without one), with the upload started in the reader stage so that
    granule N+1's upload overlaps granule N's compute. A list of torch
    devices (CUDA or CPU) gives one worker per device, each uploading its
    own granules.

    ``upload_dtype``: the wire of the radiance cube, see ``encode_payload``:
    None / "f32" (default), "u12" (37.5 % of the f32 bytes), "u10" (31.25 %),
    "u16" / np.uint16 (50 %) or "bf16" / torch.bfloat16 (50 %).

    ``download_dtype``: the wire of the (prediction, mag1c) results, always
    one stacked transfer. The default "f16" is LOSSY: prediction within
    2^-11 (~4.9e-4 absolute), mag1c within 2^-11 relative (it rides as
    mf / 16, clamped to +-65504, so |mf| above ~1.05e6 ppm*m saturates
    instead of overflowing), NODATA restored exactly from the host mask.
    Pass None / "f32" for the f32 results as computed.

    ``stream_dtype``: only None / f32; the bf16 stream raises
    ``NotImplementedError`` until its kernels are ported (ROADMAP).

    ``compress_outputs``: DEFLATE setting of the output GeoTIFFs (bool or
    zlib level, see ``write_geotiff``); off by default, since the f32
    rasters barely compress.
    """
    _check_stream_dtype(stream_dtype)
    codec = wire_codec(upload_dtype)
    kw = dict(column_step=column_step, num_iter=num_iter, download_dtype=download_dtype)
    write_fn = make_write_fn(output_dir, compress_outputs)

    def encode(path: str) -> Dict:
        return encode_payload(read_granule(path, georeference), codec)

    if devices:
        return ScenePipeline(encode, compute_fns=[make_compute_fn(model_apply, d, **kw)
                                                  for d in devices],
                             write_fn=write_fn, queue_size=queue_size)
    dev = resolve_device(None)
    upload = Uploader(dev)
    return ScenePipeline(lambda path: upload(encode(path)), make_compute_fn(model_apply, dev, **kw),
                         write_fn, queue_size=queue_size)
