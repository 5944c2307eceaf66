// Batch assembly of chip products for data/chip_io.py: the tiles and strips
// of many single-band rasters read with pread(2), inflated with zlib where
// they are DEFLATE, cast to float32 and copied straight into their rows of a
// preallocated (B, C, H, W) float32 batch, on a pool of native threads.
//
// A job is one tile or strip: a row of JOB_FIELDS int64 in the field order
// below (chip_io.py's F_* names). Jobs come grouped by file, the groups in
// any order; a thread takes a whole group, opens its file once, reads its
// jobs' bytes (in one pread where they lie together), runs them and closes
// it. The first failure stops the call; it returns the failure's code and
// the index of its file.
//
// Build: g++ -O3 -march=native -fPIC -std=c++17 -shared -pthread chip_io.cpp -lz

#include <fcntl.h>
#include <sched.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <type_traits>
#include <vector>

namespace {

enum Field {
  F_FILE,         // index into the call's paths
  F_OFFSET,       // file offset of the bytes to read
  F_COUNT,        // bytes to read
  F_COMPRESSION,  // COMP_RAW: the bytes are the block; COMP_DEFLATE: a zlib stream
  F_DTYPE,        // the source sample type (Dtype)
  F_BLOCK_MIN,    // the decoded block holds at least this many bytes
  F_BLOCK_MAX,    // and at most this many (-1: any more, which are dropped)
  F_ROW,          // samples a row of the decoded block
  F_Y0,           // first row of the block to copy
  F_X0,           // first column of the block to copy
  F_NY,           // rows copied
  F_NX,           // columns copied
  F_DST,          // address of the first destination float
  F_DST_ROW,      // destination floats a row
  JOB_FIELDS
};

enum Dtype { DT_U8, DT_U16, DT_U32, DT_I16, DT_I32, DT_F32, DT_F64 };
enum Compression { COMP_RAW = 0, COMP_DEFLATE = 1 };

// Codes beyond -errno.
constexpr int E_SHORT = -100001;    // the file ends inside the bytes to read
constexpr int E_INFLATE = -100002;  // zlib refused the stream
constexpr int E_SIZE = -100003;     // the decoded block's length is out of range
constexpr int E_JOB = -100004;      // a job's fields are inconsistent

int dtype_size(int64_t dt) {
  switch (dt) {
    case DT_U8: return 1;
    case DT_U16: case DT_I16: return 2;
    case DT_U32: case DT_I32: case DT_F32: return 4;
    case DT_F64: return 8;
    default: return 0;
  }
}

// A growable scratch buffer that does not initialise its bytes.
struct Scratch {
  uint8_t* data = nullptr;
  size_t cap = 0;
  ~Scratch() { std::free(data); }
  uint8_t* get(size_t n) {
    if (n > cap) {
      std::free(data);
      data = static_cast<uint8_t*>(std::malloc(n ? n : 1));
      cap = data ? n : 0;
    }
    return data;
  }
};

int read_full(int fd, uint8_t* buf, int64_t count, int64_t offset) {
  int64_t done = 0;
  while (done < count) {
    ssize_t r = pread(fd, buf + done, static_cast<size_t>(count - done), offset + done);
    if (r < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (r == 0) return E_SHORT;
    done += r;
  }
  return 0;
}

// Inflate a whole zlib stream: the first `cap` bytes into dst, any beyond
// into a discard buffer while max < 0 (E_SIZE otherwise). *len: the
// decoded length.
int inflate_block(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int64_t max,
                  int64_t* len) {
  if (n > static_cast<int64_t>(UINT_MAX) || cap > static_cast<int64_t>(UINT_MAX)) return E_JOB;
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return E_INFLATE;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(n);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(cap);
  uint8_t discard[16384];
  int rc;
  for (;;) {
    rc = inflate(&zs, Z_FINISH);
    if (rc == Z_STREAM_END) break;
    if (zs.avail_out == 0 && (rc == Z_OK || rc == Z_BUF_ERROR)) {
      if (max >= 0) {
        rc = E_SIZE;
        break;
      }
      zs.next_out = discard;
      zs.avail_out = sizeof(discard);
      continue;
    }
    rc = E_INFLATE;  // a corrupt or cut stream
    break;
  }
  *len = static_cast<int64_t>(zs.total_out);
  inflateEnd(&zs);
  return rc == Z_STREAM_END ? 0 : rc;
}

template <typename T>
void copy_rows(const uint8_t* block, const int64_t* j) {
  const int64_t row = j[F_ROW], y0 = j[F_Y0], x0 = j[F_X0], ny = j[F_NY], nx = j[F_NX];
  const int64_t dst_row = j[F_DST_ROW];
  float* dst = reinterpret_cast<float*>(static_cast<uintptr_t>(j[F_DST]));
  for (int64_t y = 0; y < ny; ++y) {
    const uint8_t* s = block + ((y0 + y) * row + x0) * static_cast<int64_t>(sizeof(T));
    float* d = dst + y * dst_row;
    if constexpr (std::is_same_v<T, float>) {
      std::memcpy(d, s, static_cast<size_t>(nx) * sizeof(float));
    } else {
      for (int64_t x = 0; x < nx; ++x) {
        T v;
        std::memcpy(&v, s + x * static_cast<int64_t>(sizeof(T)), sizeof(T));
        d[x] = static_cast<float>(v);
      }
    }
  }
}

void copy_block(const uint8_t* block, const int64_t* j) {
  switch (j[F_DTYPE]) {
    case DT_U8: copy_rows<uint8_t>(block, j); break;
    case DT_U16: copy_rows<uint16_t>(block, j); break;
    case DT_U32: copy_rows<uint32_t>(block, j); break;
    case DT_I16: copy_rows<int16_t>(block, j); break;
    case DT_I32: copy_rows<int32_t>(block, j); break;
    case DT_F32: copy_rows<float>(block, j); break;
    case DT_F64: copy_rows<double>(block, j); break;
  }
}

// One job from its F_COUNT bytes as read from the file.
int run_job(const uint8_t* bytes, const int64_t* j, Scratch& block) {
  const int is = dtype_size(j[F_DTYPE]);
  const int64_t count = j[F_COUNT], nx = j[F_NX], ny = j[F_NY];
  if (is == 0 || count < 0 || nx <= 0 || ny <= 0 || j[F_ROW] < j[F_X0] + nx) return E_JOB;
  const int64_t need = ((j[F_Y0] + ny - 1) * j[F_ROW] + j[F_X0] + nx) * is;
  if (j[F_BLOCK_MIN] < need) return E_JOB;
  if (j[F_COMPRESSION] == COMP_RAW) {
    if (count != j[F_BLOCK_MIN]) return E_JOB;
    copy_block(bytes, j);
    return 0;
  }
  if (j[F_COMPRESSION] != COMP_DEFLATE) return E_JOB;
  const int64_t cap = j[F_BLOCK_MAX] >= 0 ? j[F_BLOCK_MAX] : j[F_BLOCK_MIN];
  uint8_t* dec = block.get(static_cast<size_t>(cap));
  if (!dec) return -ENOMEM;
  int64_t len = 0;
  int rc = inflate_block(bytes, count, dec, cap, j[F_BLOCK_MAX], &len);
  if (rc) return rc;
  if (len < j[F_BLOCK_MIN]) return E_SIZE;
  copy_block(dec, j);
  return 0;
}

// The jobs [first, last) of one open file. Where their bytes lie together
// (the span between them at most an eighth more than they hold, and within
// SPAN_MAX), one pread takes them all; else one pread a job.
int run_file(int fd, const int64_t* jobs, int64_t first, int64_t last, Scratch& bytes,
             Scratch& block) {
  constexpr int64_t SPAN_MAX = int64_t{64} << 20;
  int64_t lo = INT64_MAX, hi = 0, held = 0;
  for (int64_t i = first; i < last; ++i) {
    const int64_t* j = jobs + i * JOB_FIELDS;
    if (j[F_OFFSET] < 0 || j[F_COUNT] < 0) return E_JOB;
    lo = std::min(lo, j[F_OFFSET]);
    hi = std::max(hi, j[F_OFFSET] + j[F_COUNT]);
    held += j[F_COUNT];
  }
  if (hi - lo <= std::min(SPAN_MAX, held + held / 8)) {
    uint8_t* span = bytes.get(static_cast<size_t>(hi - lo));
    if (!span) return -ENOMEM;
    int rc = read_full(fd, span, hi - lo, lo);
    for (int64_t i = first; rc == 0 && i < last; ++i) {
      const int64_t* j = jobs + i * JOB_FIELDS;
      rc = run_job(span + (j[F_OFFSET] - lo), j, block);
    }
    return rc;
  }
  for (int64_t i = first; i < last; ++i) {
    const int64_t* j = jobs + i * JOB_FIELDS;
    uint8_t* buf = bytes.get(static_cast<size_t>(j[F_COUNT]));
    if (!buf) return -ENOMEM;
    int rc = read_full(fd, buf, j[F_COUNT], j[F_OFFSET]);
    if (!rc) rc = run_job(buf, j, block);
    if (rc) return rc;
  }
  return 0;
}

// Threads for a call: n_threads if positive, else the CPUs this process may
// run on (its affinity mask, never more than the machine has); at most one
// an item.
int workers(int32_t n_threads, int64_t n_items) {
  int64_t nt = n_threads;
  if (nt <= 0) {
    cpu_set_t set;
    CPU_ZERO(&set);
    nt = sched_getaffinity(0, sizeof(set), &set) == 0 ? CPU_COUNT(&set) : 0;
    int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (nt <= 0 || (hw > 0 && hw < nt)) nt = hw;
    if (nt <= 0) nt = 4;
  }
  return static_cast<int>(nt < n_items ? nt : n_items);
}

// Run work(i) for i in [0, n) on `workers` threads, the calling thread one
// of them.
template <typename Work>
void run_pool(int32_t n_threads, int64_t n, Work work) {
  std::atomic<int64_t> next{0};
  auto loop = [&]() {
    for (int64_t i = next.fetch_add(1); i < n; i = next.fetch_add(1))
      if (!work(i)) return;
  };
  const int nt = workers(n_threads, n);
  std::vector<std::thread> threads;
  threads.reserve(nt > 1 ? nt - 1 : 0);
  for (int t = 1; t < nt; ++t) threads.emplace_back(loop);
  loop();
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

int starcop_chip_job_fields() { return JOB_FIELDS; }

// The first head_bytes of each file into heads (n x head_bytes): lengths[i]
// the bytes read (fewer at the end of a short file) or -errno, sizes[i] the
// file's size.
void starcop_chip_heads(const char** paths, int64_t n, int64_t head_bytes, uint8_t* heads,
                        int64_t* lengths, int64_t* sizes, int32_t n_threads) {
  run_pool(n_threads, n, [&](int64_t i) {
    sizes[i] = -1;
    int fd = open(paths[i], O_RDONLY | O_CLOEXEC);
    if (fd < 0) {
      lengths[i] = -errno;
      return true;
    }
    struct stat st;
    if (fstat(fd, &st) == 0) sizes[i] = st.st_size;
    uint8_t* head = heads + i * head_bytes;
    int64_t done = 0;
    while (done < head_bytes) {
      ssize_t r = pread(fd, head + done, static_cast<size_t>(head_bytes - done), done);
      if (r < 0 && errno == EINTR) continue;
      if (r < 0) {
        done = -errno;
        break;
      }
      if (r == 0) break;
      done += r;
    }
    lengths[i] = done;
    close(fd);
    return true;
  });
}

int starcop_chip_threads(int32_t n_threads) { return workers(n_threads, INT64_MAX); }

// Run n_jobs jobs (n_jobs x JOB_FIELDS int64, grouped by F_FILE) over the
// files paths[0..n_files). Returns 0, or the first failure's code with its
// file's index in *failed_file (else -1).
int starcop_chip_read(const char** paths, int64_t n_files, const int64_t* jobs, int64_t n_jobs,
                      int32_t n_threads, int64_t* failed_file) {
  *failed_file = -1;
  if (n_jobs <= 0) return 0;
  std::vector<int64_t> starts;
  for (int64_t i = 0; i < n_jobs; ++i) {
    const int64_t f = jobs[i * JOB_FIELDS + F_FILE];
    if (f < 0 || f >= n_files) return E_JOB;
    if (i == 0 || f != jobs[(i - 1) * JOB_FIELDS + F_FILE]) starts.push_back(i);
  }
  const int64_t n_groups = static_cast<int64_t>(starts.size());
  starts.push_back(n_jobs);

  std::atomic<bool> stop{false};
  std::mutex fail_lock;
  int fail_rc = 0;
  run_pool(n_threads, n_groups, [&](int64_t g) {
    thread_local Scratch bytes, block;
    if (stop.load(std::memory_order_relaxed)) return false;
    const int64_t file = jobs[starts[g] * JOB_FIELDS + F_FILE];
    int rc;
    int fd = open(paths[file], O_RDONLY | O_CLOEXEC);
    if (fd < 0) {
      rc = -errno;
    } else {
      rc = run_file(fd, jobs, starts[g], starts[g + 1], bytes, block);
      close(fd);
    }
    if (rc) {
      std::lock_guard<std::mutex> hold(fail_lock);
      if (!fail_rc) {
        fail_rc = rc;
        *failed_file = file;
      }
      stop.store(true);
      return false;
    }
    return true;
  });
  return fail_rc;
}

}  // extern "C"
