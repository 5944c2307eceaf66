// starcop_io — native host-side raster IO for the TPU input pipeline.
//
// Role: the framework's data-loader hot path (the niche the reference fills
// with np.memmap + GDAL worker processes: SURVEY.md §2.7). Provides threaded
// windowed reads from raw binary rasters (ENVI BIP/BSQ cubes, .npy tile
// payloads) using pread(2) — no GIL, no per-worker processes, page-cache
// friendly — feeding the host->HBM prefetch pipeline.
//
// Layouts:
//   BIP  (H, W, C): pixel-interleaved — a (row, col) window is H' runs of
//                   W'*C contiguous bytes.
//   BSQ  (C, H, W): band-sequential — a window is C*H' runs of W' bytes.
//   R2   (H, W):    single-band raster (npy payload) — H' runs of W' bytes.
//
// API (C, ctypes-friendly): all functions return 0 on success, -errno-style
// negative codes on failure.

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

// Read one rectangular window from a raw raster file.
//   path: file to read; offset_bytes: payload start (e.g. npy header size)
//   itemsize: bytes per element; layout: 0=R2, 1=BIP, 2=BSQ
//   shape: [H, W] for R2, [H, W, C] for BIP, [C, H, W] for BSQ
//   window: row_off, col_off, win_h, win_w
//   out: caller buffer of win_h*win_w*(C|1)*itemsize bytes
int starcop_read_window(const char* path, int64_t offset_bytes, int32_t itemsize,
                        int32_t layout, const int64_t* shape,
                        int64_t row_off, int64_t col_off, int64_t win_h,
                        int64_t win_w, uint8_t* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;

  int rc = 0;
  if (layout == 0) {  // R2 (H, W)
    const int64_t W = shape[1];
    for (int64_t r = 0; r < win_h && rc == 0; ++r) {
      int64_t off = offset_bytes + ((row_off + r) * W + col_off) * itemsize;
      ssize_t n = pread(fd, out + r * win_w * itemsize, win_w * itemsize, off);
      if (n != win_w * itemsize) rc = -EIO;
    }
  } else if (layout == 1) {  // BIP (H, W, C)
    const int64_t W = shape[1], C = shape[2];
    const int64_t run = win_w * C * itemsize;
    for (int64_t r = 0; r < win_h && rc == 0; ++r) {
      int64_t off = offset_bytes + (((row_off + r) * W + col_off) * C) * itemsize;
      ssize_t n = pread(fd, out + r * run, run, off);
      if (n != run) rc = -EIO;
    }
  } else if (layout == 2) {  // BSQ (C, H, W)
    const int64_t C = shape[0], H = shape[1], W = shape[2];
    const int64_t run = win_w * itemsize;
    for (int64_t c = 0; c < C && rc == 0; ++c) {
      for (int64_t r = 0; r < win_h && rc == 0; ++r) {
        int64_t off = offset_bytes + ((c * H + row_off + r) * W + col_off) * itemsize;
        ssize_t n = pread(fd, out + (c * win_h + r) * run, run, off);
        if (n != run) rc = -EIO;
      }
    }
  } else {
    rc = -EINVAL;
  }
  close(fd);
  return rc;
}

// Batched windowed reads, parallel across windows (thread pool sized by
// n_threads; 0 = hardware concurrency). Each window may target a different
// file. Buffers must be preallocated by the caller; outs[i] receives window i.
int starcop_read_windows_batch(const char** paths, const int64_t* offsets,
                               int32_t itemsize, int32_t layout,
                               const int64_t* shapes,  // n x 3 (R2 uses [H,W,1])
                               const int64_t* windows,  // n x 4
                               uint8_t** outs, int32_t n, int32_t n_threads) {
  if (n <= 0) return 0;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
  if (nt > n) nt = n;

  std::vector<int> results(n, 0);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      for (int i = t; i < n; i += nt) {
        const int64_t* sh = shapes + 3 * i;
        const int64_t* win = windows + 4 * i;
        results[i] = starcop_read_window(paths[i], offsets[i], itemsize, layout,
                                         sh, win[0], win[1], win[2], win[3],
                                         outs[i]);
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int i = 0; i < n; ++i)
    if (results[i] != 0) return results[i];
  return 0;
}

// File size probe (sanity checks from Python without an extra stat round-trip).
int64_t starcop_file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -errno;
  return static_cast<int64_t>(st.st_size);
}

// ---------------------------------------------------------------------------
// Upload codec: per-band affine 12-bit quantization, packed 2 values / 3 bytes.
//
// Role: the serving pipeline's host-side encode stage. On bandwidth-limited
// host->device links (remote-attached chips) the radiance-cube upload is the
// dominant per-scene cost; 12-bit per-band fixed point is measured
// detection-equivalent to the f32 filter (matched-filter threshold masks agree
// to ~2e-4) at 37.5% of the bytes. numpy needs ~6 full passes over the cube
// for minmax+quantize+pack; these fuse them into one threaded pass each.
// ---------------------------------------------------------------------------

// Per-band min/max over VALID pixels only (valid: n_px u8 mask, may be null =
// all valid). cube: (n_px, S) f32 contiguous. Parallel over pixel stripes.
int starcop_band_minmax(const float* cube, const uint8_t* valid, int64_t n_px,
                        int32_t s, float* lo_out, float* hi_out,
                        int32_t n_threads) {
  if (n_px <= 0 || s <= 0) return -EINVAL;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
  if (static_cast<int64_t>(nt) > n_px) nt = static_cast<int>(n_px);

  std::vector<std::vector<float>> los(nt), his(nt);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  const int64_t stripe = (n_px + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      std::vector<float>& lo = los[t];
      std::vector<float>& hi = his[t];
      lo.assign(s, 3.4e38f);
      hi.assign(s, -3.4e38f);
      const int64_t p0 = t * stripe;
      const int64_t p1 = std::min(n_px, p0 + stripe);
      for (int64_t p = p0; p < p1; ++p) {
        if (valid && !valid[p]) continue;
        const float* row = cube + p * s;
        for (int32_t b = 0; b < s; ++b) {
          const float v = row[b];
          if (v < lo[b]) lo[b] = v;
          if (v > hi[b]) hi[b] = v;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int32_t b = 0; b < s; ++b) {
    float lo = 3.4e38f, hi = -3.4e38f;
    for (int t = 0; t < nt; ++t) {
      if (los[t][b] < lo) lo = los[t][b];
      if (his[t][b] > hi) hi = his[t][b];
    }
    // All-invalid band: pin a harmless (0, 1) range (mirrors the numpy path).
    lo_out[b] = (lo <= hi) ? lo : 0.0f;
    hi_out[b] = (lo <= hi) ? hi : 1.0f;
  }
  return 0;
}

// Fused nodata-validity scan + per-band min/max in ONE threaded pass.
// valid_out[p] = 1 iff NO band of pixel p equals the fill sentinel (the
// sensor nodata contract of EMITRawScene.invalid_mask: any band at fill
// invalidates the pixel; NaN never invalidates — NaN != fill — and never
// contributes to the range, matching starcop_band_minmax). (lo, hi)
// accumulate over the FIRST s_minmax bands of the pixels that end up valid
// (0 <= s_minmax <= s; 0 = validity only, lo/hi untouched). Replaces the
// serving read stage's full-cube numpy compare+any pass plus the separate
// native minmax pass with one pass (each row stays hot in L1 for the
// second mini-scan).
int starcop_valid_band_minmax(const float* cube, float fill, int64_t n_px,
                              int32_t s, int32_t s_minmax, uint8_t* valid_out,
                              float* lo_out, float* hi_out, int32_t n_threads) {
  if (n_px <= 0 || s <= 0 || s_minmax < 0 || s_minmax > s) return -EINVAL;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
  if (static_cast<int64_t>(nt) > n_px) nt = static_cast<int>(n_px);

  std::vector<std::vector<float>> los(nt), his(nt);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  const int64_t stripe = (n_px + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      std::vector<float>& lo = los[t];
      std::vector<float>& hi = his[t];
      lo.assign(s_minmax > 0 ? s_minmax : 1, 3.4e38f);
      hi.assign(s_minmax > 0 ? s_minmax : 1, -3.4e38f);
      const int64_t p0 = t * stripe;
      const int64_t p1 = std::min(n_px, p0 + stripe);
      for (int64_t p = p0; p < p1; ++p) {
        const float* row = cube + p * s;
        bool ok = true;
        for (int32_t b = 0; b < s; ++b) {
          if (row[b] == fill) { ok = false; break; }
        }
        valid_out[p] = ok ? 1 : 0;
        if (!ok) continue;
        for (int32_t b = 0; b < s_minmax; ++b) {
          const float v = row[b];
          if (v < lo[b]) lo[b] = v;
          if (v > hi[b]) hi[b] = v;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int32_t b = 0; b < s_minmax; ++b) {
    float lo = 3.4e38f, hi = -3.4e38f;
    for (int t = 0; t < nt; ++t) {
      if (los[t][b] < lo) lo = los[t][b];
      if (his[t][b] > hi) hi = his[t][b];
    }
    // All-invalid band: pin a harmless (0, 1) range (mirrors band_minmax).
    lo_out[b] = (lo <= hi) ? lo : 0.0f;
    hi_out[b] = (lo <= hi) ? hi : 1.0f;
  }
  return 0;
}

// Quantize q = clamp(rint((x - lo) * inv_scale), 0, 4095) and pack band pairs
// (2k, 2k+1) into 3 bytes, written as THREE planes of (n_px, S/2) u8 at
// out / out+plane / out+2*plane:
//   b0 = q0 & 0xff;  b1 = (q0 >> 8) | ((q1 & 0xf) << 4);  b2 = q1 >> 4.
// The device unpacks with two shifts per plane (see serve/pipeline.py). S must
// be even. Parallel over pixel stripes.
int starcop_quantize_pack12(const float* cube, int64_t n_px, int32_t s,
                            const float* lo, const float* inv_scale,
                            uint8_t* out, int32_t n_threads) {
  if (n_px <= 0 || s <= 0 || (s % 2) != 0) return -EINVAL;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
  if (static_cast<int64_t>(nt) > n_px) nt = static_cast<int>(n_px);

  const int32_t sh = s / 2;
  const int64_t plane = n_px * sh;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  const int64_t stripe = (n_px + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      const int64_t p0 = t * stripe;
      const int64_t p1 = std::min(n_px, p0 + stripe);
      for (int64_t p = p0; p < p1; ++p) {
        const float* row = cube + p * s;
        uint8_t* o0 = out + p * sh;
        uint8_t* o1 = o0 + plane;
        uint8_t* o2 = o1 + plane;
        for (int32_t k = 0; k < sh; ++k) {
          const int32_t b0i = 2 * k, b1i = 2 * k + 1;
          float f0 = (row[b0i] - lo[b0i]) * inv_scale[b0i];
          float f1 = (row[b1i] - lo[b1i]) * inv_scale[b1i];
          // Clamp in float BEFORE the int cast: casting a float outside
          // int32 range is UB, and near-constant bands (scale floored at
          // 1e-12) can push out-of-range pixels to ~1e16. The comparison
          // order also maps NaN to 0 deterministically.
          f0 = f0 > 0.0f ? (f0 < 4095.0f ? f0 : 4095.0f) : 0.0f;
          f1 = f1 > 0.0f ? (f1 < 4095.0f ? f1 : 4095.0f) : 0.0f;
          int32_t q0 = static_cast<int32_t>(f0 + 0.5f);  // round-half-up
          int32_t q1 = static_cast<int32_t>(f1 + 0.5f);
          o0[k] = static_cast<uint8_t>(q0 & 0xff);
          o1[k] = static_cast<uint8_t>((q0 >> 8) | ((q1 & 0xf) << 4));
          o2[k] = static_cast<uint8_t>(q1 >> 4);
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}

// Quantize q = clamp(rint((x - lo) * inv_scale), 0, 1023) and pack PIXEL
// groups (4g, 4g+1, 4g+2, 4g+3) of the same band into 5 bytes, written as
// FIVE planes of (n_groups, S) u8 at out + k*n_groups*S for k in 0..4:
//   p0 = q0 & 0xff
//   p1 = (q0 >> 8) | ((q1 & 0x3f) << 2)
//   p2 = (q1 >> 6) | ((q2 & 0x0f) << 4)
//   p3 = (q2 >> 4) | ((q3 & 0x03) << 6)
//   p4 = q3 >> 2
// Grouping along PIXELS (not bands, unlike pack12) means any band count S
// packs without padding; a trailing partial pixel group (n_px % 4 != 0)
// carries q=0 for the missing pixels and the device slices them off. The
// device unpacks with shifts/masks (see serve/pipeline.py). Parallel over
// group stripes.
int starcop_quantize_pack10(const float* cube, int64_t n_px, int32_t s,
                            const float* lo, const float* inv_scale,
                            uint8_t* out, int32_t n_threads) {
  if (n_px <= 0 || s <= 0) return -EINVAL;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
  const int64_t n_groups = (n_px + 3) / 4;
  if (static_cast<int64_t>(nt) > n_groups) nt = static_cast<int>(n_groups);

  const int64_t plane = n_groups * s;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  const int64_t stripe = (n_groups + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      const int64_t g0 = t * stripe;
      const int64_t g1 = std::min(n_groups, g0 + stripe);
      for (int64_t g = g0; g < g1; ++g) {
        const int64_t p_base = 4 * g;
        const int n_in = static_cast<int>(std::min<int64_t>(4, n_px - p_base));
        const float* rows[4];
        for (int i = 0; i < 4; ++i)
          rows[i] = cube + (p_base + (i < n_in ? i : 0)) * s;
        uint8_t* o0 = out + g * s;
        uint8_t* o1 = o0 + plane;
        uint8_t* o2 = o1 + plane;
        uint8_t* o3 = o2 + plane;
        uint8_t* o4 = o3 + plane;
        for (int32_t b = 0; b < s; ++b) {
          int32_t q[4];
          for (int i = 0; i < 4; ++i) {
            // Clamp in float BEFORE the int cast (UB + NaN determinism, as
            // in pack12); pad pixels of a trailing partial group carry 0.
            float f = (rows[i][b] - lo[b]) * inv_scale[b];
            f = f > 0.0f ? (f < 1023.0f ? f : 1023.0f) : 0.0f;
            q[i] = (i < n_in) ? static_cast<int32_t>(f + 0.5f) : 0;
          }
          o0[b] = static_cast<uint8_t>(q[0] & 0xff);
          o1[b] = static_cast<uint8_t>((q[0] >> 8) | ((q[1] & 0x3f) << 2));
          o2[b] = static_cast<uint8_t>((q[1] >> 6) | ((q[2] & 0x0f) << 4));
          o3[b] = static_cast<uint8_t>((q[2] >> 4) | ((q[3] & 0x03) << 6));
          o4[b] = static_cast<uint8_t>(q[3] >> 2);
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
