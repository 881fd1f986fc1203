// Connected-component label sweeps for Hopper (sm_90a).
//
// Replaces keras_ocr_tpu/ops/cc_pallas.py:82 segmented_min_sweeps_pallas and
// computes exactly keras_ocr_tpu/ops/cc.py:segmented_min_sweeps, batched
// over (B, H, W): `num_sweeps` times a row pass then a column pass. A pass
// gives every non-barrier cell the minimum of its run, the run reaching
// from the nearest barrier cell on the left (or above) to the nearest one
// on the right (or below), both barrier cells included, and gives every
// barrier cell `sentinel`. A keyed mode (`cc_keyed_rows_cols`) serves the
// 8-connected blob labeling of the census
// (keras_ocr_tpu/ops/cc.py:_keyed_run_min, an XLA loop in the JAX package):
// there a run is a maximal stretch of non-barrier cells with equal key.
//
// What bounds it: bytes. A pass reads the labels (4 B) and a byte-wide
// barrier (1 B: a bool or uint8 plane) and writes the labels (4 B), 9 B per
// pixel, with a handful of integer operations per pixel; the keyed mode
// also reads its int32 key, 13 B per pixel. At (8, 480, 640) a pass moves
// 22.1 MB (keyed 32.0 MB): the 18 passes of 8 sweeps plus the convergence
// sweep take at least 0.119 ms at 3.35 TB/s, the keyed row and column pass
// 19.1 us. The batch fits the 50 MB L2, so that HBM floor is conservative.
//
// What the design does about it:
// - Coalesced passes. A block stages a tile of whole lines in shared memory
//   with loads along the rows, scans it there, and stores it back along the
//   rows: each pixel is read and written once per pass. A row-pass tile is
//   up to 8 rows, one warp per row. A column-pass tile is a band of up to 32
//   adjacent columns of one image (a warp loads 128 B of labels per row);
//   lanes scan the columns. The band is as wide as shared memory allows for
//   the map's height (32 columns up to 711 rows, 640 keyed; 4 at the
//   4096-row limit: narrowing keeps one layout for every height, where a
//   route to one block per column would keep the strided loads), and
//   it is halved, down to 8 columns (32 B of labels per row, one sector),
//   until the SMs hold the whole grid at once: at (8, 480, 640) 16 columns
//   (3 tiles of 69 KB an SM), keyed 8. Columns past the right edge are
//   masked. Each thread keeps 8 loads in flight while it stages.
// - A byte-wide barrier: 9 B per pixel per pass where an int32 plane made 12.
// - Fixpoint stop. Each pass ORs 1 into its sweep's flag of its image when
//   it changes a cell; every block of sweep s >= 1 first reads the flag of
//   sweep s - 1 and exits without touching the map when it is 0. A sweep is
//   a deterministic map of the labels (the barrier is fixed), so a sweep
//   that leaves an image unchanged is followed by sweeps that do too: the
//   skipped sweeps are identities and the map that comes out is the same.
//   Each pass is monotone: a non-barrier cell takes the minimum of a run
//   that contains it, so it never grows, and a barrier cell takes
//   `sentinel` and keeps it (it holds `sentinel` from the start under
//   segmented_min_sweeps's precondition). A pass can therefore not undo
//   what an earlier pass of its sweep changed, so "some pass of sweep s
//   changed the image" is exactly "sweep s changed the image", and the
//   flag of the convergence sweep is the plain version's `converged`. The
//   flag is read on the device; stream order is the only synchronisation.
//   A block that changes nothing in place also skips its store.
// - The scan. Each thread scans a contiguous segment of its line serially;
//   the segment summaries are scanned with warp shuffles, then, for the
//   segments of a column that run on through the warps, in one step across
//   warps in shared memory; each segment is rescanned with its carry.
//   Segments have an odd length so that the lanes of a warp reading their
//   segments hit distinct banks.
//
// Each pass is its own launch: the passes depend on each other across the
// whole image and blocks cannot wait for each other.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLine = 4096;
constexpr int kMaxBatch = 65535;  // images ride on gridDim.y
constexpr int kMaxBand = 32;
constexpr int kMinBand = 8;
constexpr int kNoValue = 0x7fffffff;
constexpr int kSmemBudget = 200 * 1024;  // dynamic shared memory of a tile
constexpr int kMaxDevices = 64;
constexpr int kBatch = 8;  // global loads a thread has in flight while staging
constexpr unsigned kFull = 0xffffffffu;

// A scan element: `head` says a run starts inside the span, `value` is the
// minimum from the last run start of the span to its end, or of the whole
// span when no run starts inside it.
__device__ __forceinline__ void combine(int& head, int& value, int next_head,
                                        int next_value) {
  value = next_head ? next_value : min(value, next_value);
  head = head | next_head;
}

struct Pass {
  const int* src;        // labels in
  int* dst;              // labels out (src after the first pass of a call)
  const uint8_t* mask;   // barrier; keyed: foreground. Nonzero = set.
  const int* key;        // keyed mode: the run key; else null
  const int* prev_flag;  // per image: did the previous sweep change it; null: run
  int* flag;             // per image: OR 1 when this pass changes it; or null
  int height, width, sentinel;
  int lines;             // lines of a block's tile: rows, or band columns
};

// One pass over a tile of lines: row lines with kRows, else a column band;
// the keyed run heads with kKeyed.
template <bool kRows, bool kKeyed>
__global__ void __launch_bounds__(kThreads) sweep_pass(const Pass p) {
  const int image = blockIdx.y;
  if (p.prev_flag != nullptr && p.prev_flag[image] == 0) return;  // fixpoint

  extern __shared__ int smem[];
  // Per warp and band column: forward head and value, backward head and value.
  __shared__ int totals[4][kWarps][kMaxBand];

  constexpr bool rows = kRows, keyed = kKeyed;
  const int len = rows ? p.width : p.height;     // cells of a line
  const int extent = rows ? p.height : p.width;  // lines of an image
  const int first = blockIdx.x * p.lines;
  const int cells = len * p.lines;
  // Tile cell q of line c sits at q * pos_step + c * line_step.
  const int pos_step = rows ? 1 : p.lines;
  const int line_step = rows ? len : 1;
  const long long gpos = rows ? 1 : p.width;
  const long long gline = rows ? p.width : 1;
  const long long base = (long long)image * p.height * p.width + first * gline;

  int* sv = smem;                                        // labels in
  int* sr = sv + cells;                                  // keys, backward scan, result
  uint8_t* sb = reinterpret_cast<uint8_t*>(sr + cells);  // barrier
  uint8_t* sh = sb + cells;  // keyed: run heads, bit 0 forward, bit 1 backward

  // The cells a thread stages: line `own`, from `q0` in steps of `q_step`,
  // neighbouring threads on neighbouring addresses of a row.
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int own = rows ? warp : tid % p.lines;
  const int q0 = rows ? lane : tid / p.lines;
  const int q_step = rows ? 32 : kThreads / p.lines;
  const bool staged = own < p.lines;  // rows: warps past the tile's lines idle
  const bool inside = staged && first + own < extent;  // else past the edge
  const long long g_own = base + own * gline;
  const int s_own = own * line_step;
  for (int q = q0; staged && q < len; q += kBatch * q_step) {
    // kBatch loads in flight before the first lands in shared memory.
    int v[kBatch], k[kBatch];
    uint8_t m[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int qj = q + j * q_step;
      v[j] = p.sentinel;  // past the edge: barrier cells, never stored
      m[j] = 1;
      k[j] = 0;
      if (inside && qj < len) {
        const long long g = g_own + qj * gpos;
        v[j] = p.src[g];
        m[j] = (p.mask[g] != 0) != keyed;
        if constexpr (keyed) k[j] = p.key[g];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int qj = q + j * q_step;
      if (qj < len) {
        const int s = s_own + qj * pos_step;
        sv[s] = v[j];
        sb[s] = m[j];
        if constexpr (keyed) sr[s] = k[j];
      }
    }
  }
  __syncthreads();
  // Unkeyed: a run ends AT a barrier cell, which belongs to the runs on both
  // of its sides. Keyed: runs are maximal same-key non-barrier stretches.
  if constexpr (keyed) {
    for (int q = q0; staged && q < len; q += q_step) {
      const int s = s_own + q * pos_step;
      const int fwd = sb[s] || q == 0 || sb[s - pos_step] || sr[s - pos_step] != sr[s];
      const int bwd =
          sb[s] || q == len - 1 || sb[s + pos_step] || sr[s + pos_step] != sr[s];
      sh[s] = fwd | (bwd << 1);
    }
    __syncthreads();
  }
  auto fwd_head = [&](int s) -> int { return keyed ? (sh[s] & 1) : sb[s]; };
  auto bwd_head = [&](int s) -> int { return keyed ? (sh[s] >> 1) : sb[s]; };

  // Each thread scans a segment of the line it staged. Rows: a warp per
  // line, a segment per lane. Columns: the segments of a line run down the
  // lanes `lines` apart, then on through the warps.
  const int seg_lanes = rows ? 1 : p.lines;  // lanes between a line's segments
  const int warp_segs = 32 / seg_lanes;      // segments of a line in a warp
  const int wseg = lane / seg_lanes;
  const int seg = rows ? lane : warp * warp_segs + wseg;
  const int segs = rows ? 32 : kWarps * warp_segs;
  const int chunk = ((len + segs - 1) / segs) | 1;
  const int start = staged ? min(seg * chunk, len) : len;
  const int stop = min(start + chunk, len);

  // Segment summaries in both directions, in one forward walk: the
  // backward summary is the minimum up to the first backward run start.
  // (The walks are unrolled so that a thread's shared-memory loads overlap.)
  int fh = 0, fv = kNoValue, bh = 0, bv = kNoValue;
#pragma unroll 4
  for (int q = start; q < stop; ++q) {
    const int s = s_own + q * pos_step;
    const int v = sv[s];
    combine(fh, fv, fwd_head(s), v);
    if (!bh) {
      bv = min(bv, v);
      bh = bwd_head(s);
    }
  }
  // Inclusive scans over the line's segments inside the warp: forward from
  // the first, backward from the last.
  for (int d = 1; d < warp_segs; d <<= 1) {
    const int delta = d * seg_lanes;
    int h = __shfl_up_sync(kFull, fh, delta);
    int v = __shfl_up_sync(kFull, fv, delta);
    if (wseg >= d) {
      combine(h, v, fh, fv);
      fh = h;
      fv = v;
    }
    h = __shfl_down_sync(kFull, bh, delta);
    v = __shfl_down_sync(kFull, bv, delta);
    if (wseg + d < warp_segs) {
      combine(h, v, bh, bv);
      bh = h;
      bv = v;
    }
  }
  // Exclusive: what the warp's earlier (forward) or later (backward)
  // segments of the line carry in.
  int fxh = __shfl_up_sync(kFull, fh, seg_lanes);
  int fxv = __shfl_up_sync(kFull, fv, seg_lanes);
  int bxh = __shfl_down_sync(kFull, bh, seg_lanes);
  int bxv = __shfl_down_sync(kFull, bv, seg_lanes);
  if (wseg == 0) {
    fxh = 0;
    fxv = kNoValue;
  }
  if (wseg == warp_segs - 1) {
    bxh = 0;
    bxv = kNoValue;
  }
  int fwd_carry = fxv, bwd_carry = bxv;
  if constexpr (!rows) {  // a column's segments run on through the warps
    if (wseg == warp_segs - 1) {
      totals[0][warp][own] = fh;
      totals[1][warp][own] = fv;
    }
    if (wseg == 0) {
      totals[2][warp][own] = bh;
      totals[3][warp][own] = bv;
    }
    __syncthreads();
    int h = 0, v = kNoValue;
    for (int w = 0; w < warp; ++w) combine(h, v, totals[0][w][own], totals[1][w][own]);
    combine(h, v, fxh, fxv);
    fwd_carry = v;
    h = 0;
    v = kNoValue;
    for (int w = kWarps - 1; w > warp; --w)
      combine(h, v, totals[2][w][own], totals[3][w][own]);
    combine(h, v, bxh, bxv);
    bwd_carry = v;
  }

  // Backward rescan into sr, then forward rescan combining both.
  int run = bwd_carry;
#pragma unroll 4
  for (int q = stop - 1; q >= start; --q) {
    const int s = s_own + q * pos_step;
    run = bwd_head(s) ? sv[s] : min(run, sv[s]);
    sr[s] = run;
  }
  run = fwd_carry;
  int changed = 0;
#pragma unroll 4
  for (int q = start; q < stop; ++q) {
    const int s = s_own + q * pos_step;
    run = fwd_head(s) ? sv[s] : min(run, sv[s]);
    const int out = sb[s] ? p.sentinel : min(run, sr[s]);
    changed |= out != sv[s];
    sr[s] = out;
  }
  const int block_changed = __syncthreads_or(changed);
  if (inside && (block_changed || p.src != p.dst)) {
    for (int q = q0; q < len; q += q_step) p.dst[g_own + q * gpos] = sr[s_own + q * pos_step];
  }
  if (p.flag != nullptr && block_changed && tid == 0) atomicOr(p.flag + image, 1);
}

using Kernel = void (*)(Pass);

Kernel kernel_for(bool rows, bool keyed) {
  if (rows) return keyed ? sweep_pass<true, true> : sweep_pass<true, false>;
  return keyed ? sweep_pass<false, true> : sweep_pass<false, false>;
}

// Raises the kernels' dynamic shared memory limit once per device; returns
// the current device and its SM count.
cudaError_t prepare(int* device_out, int* sms) {
  static int sm_count[kMaxDevices];  // 0 until the device is prepared
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[device] == 0) {
    for (int i = 0; i < 4; ++i) {
      const Kernel kernel = kernel_for(i & 1, i & 2);
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBudget);
      if (err != cudaSuccess) return err;
      // As many tiles on an SM as its shared memory holds.
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return err;
    }
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    sm_count[device] = count;
  }
  *device_out = device;
  *sms = sm_count[device];
  return cudaSuccess;
}

int cell_bytes(bool keyed) { return keyed ? 10 : 9; }

// The widest column band whose grid the SMs hold at once (a second wave of
// blocks would double the pass), at least kMinBand columns.
int widest_band(int batch, int height, int width, bool keyed, int sms) {
  int band = kMaxBand;
  while (band > 1 && band * height * cell_bytes(keyed) > kSmemBudget) band >>= 1;
  for (; band > kMinBand; band >>= 1) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel_for(false, keyed), kThreads,
            (size_t)band * height * cell_bytes(keyed)) != cudaSuccess)
      break;
    if ((long long)batch * ((width + band - 1) / band) <= (long long)per_sm * sms) break;
  }
  return band;
}

// Lines of a tile: rows for a row pass, band columns for a column pass. The
// band of a shape is chosen once per device, so that a call does not pay
// for the occupancy queries again.
int tile_lines(int device, int batch, int height, int width, bool row_pass, bool keyed,
               int sms) {
  if (row_pass) {
    const int fit = kSmemBudget / (width * cell_bytes(keyed));
    return fit < kWarps ? fit : kWarps;
  }
  static std::mutex lock;
  static std::map<std::tuple<int, int, int, int, bool>, int> chosen;
  const auto shape = std::make_tuple(device, batch, height, width, keyed);
  std::lock_guard<std::mutex> guard(lock);
  const auto found = chosen.find(shape);
  if (found != chosen.end()) return found->second;
  if (chosen.size() >= 4096) chosen.clear();  // a bound on the shapes kept
  const int band = widest_band(batch, height, width, keyed, sms);
  chosen.emplace(shape, band);
  return band;
}

// Launches one row or column pass of `p` over `lines`-line tiles.
cudaError_t launch_pass(Pass p, bool rows, int lines, int batch, bool keyed,
                        cudaStream_t stream) {
  p.lines = lines;
  const int len = rows ? p.width : p.height;
  const int extent = rows ? p.height : p.width;
  const dim3 grid((extent + lines - 1) / lines, batch);
  const size_t smem = (size_t)lines * len * cell_bytes(keyed);
  kernel_for(rows, keyed)<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool bad_shape(int batch, int height, int width) {
  return batch <= 0 || batch > kMaxBatch || height <= 0 || width <= 0 ||
         height > kMaxLine || width > kMaxLine;
}

}  // namespace

extern "C" int cc_sweeps_max_line() { return kMaxLine; }

extern "C" int cc_sweeps_max_batch() { return kMaxBatch; }

// `num_sweeps` sweeps of `src` (B, H, W) int32 into `dst` with `barrier`
// (B, H, W) one byte a cell (nonzero = barrier), then, if
// `check_convergence`, one more sweep. `flags` holds (num_sweeps + 1) x B
// zeroed int32: sweep s ORs 1 into flags[s * B + b] when it changes image
// b, and a sweep after one that left image b unchanged skips it, so image b
// converged when flags[num_sweeps * B + b] is 0 after the check sweep.
// Launches on `stream`, does not synchronise, returns a CUDA error code.
extern "C" int cc_sweeps(const int* src, int* dst, const uint8_t* barrier, int batch,
                         int height, int width, int sentinel, int num_sweeps,
                         int check_convergence, int* flags, void* stream) {
  if (bad_shape(batch, height, width) || num_sweeps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = num_sweeps + (check_convergence ? 1 : 0);
  if (total == 0) {
    return (int)cudaMemcpyAsync(dst, src, sizeof(int) * (size_t)batch * height * width,
                                cudaMemcpyDeviceToDevice, s);
  }
  int device = 0, sms = 0;
  cudaError_t err = prepare(&device, &sms);
  if (err != cudaSuccess) return (int)err;
  Pass p = {};
  p.mask = barrier;
  p.height = height;
  p.width = width;
  p.sentinel = sentinel;
  p.dst = dst;
  const int lines[2] = {tile_lines(device, batch, height, width, false, false, sms),
                        tile_lines(device, batch, height, width, true, false, sms)};
  for (int sweep = 0; sweep < total; ++sweep) {
    p.prev_flag = sweep > 0 ? flags + (size_t)(sweep - 1) * batch : nullptr;
    // The last sweep's flag is read only as the convergence proof.
    const bool flagged = sweep < total - 1 || check_convergence;
    p.flag = flagged ? flags + (size_t)sweep * batch : nullptr;
    for (int row_pass = 1; row_pass >= 0; --row_pass) {
      p.src = sweep == 0 && row_pass ? src : dst;
      err = launch_pass(p, row_pass, lines[row_pass], batch, false, s);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

// The keyed run minimum of keras_ocr_tpu/ops/cc.py:_keyed_run_min along the
// rows, then along the columns, from `src` into `dst`: runs are maximal
// stretches of foreground cells (`fg` nonzero, one byte a cell) with equal
// `key` (B, H, W) int32, and background cells get `sentinel`.
extern "C" int cc_keyed_rows_cols(const int* src, int* dst, const uint8_t* fg,
                                  const int* key, int batch, int height, int width,
                                  int sentinel, void* stream) {
  if (bad_shape(batch, height, width)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaError_t err = prepare(&device, &sms);
  if (err != cudaSuccess) return (int)err;
  Pass p = {};
  p.mask = fg;
  p.key = key;
  p.height = height;
  p.width = width;
  p.sentinel = sentinel;
  p.dst = dst;
  for (int row_pass = 1; row_pass >= 0; --row_pass) {
    p.src = row_pass ? src : dst;
    err = launch_pass(p, row_pass,
                      tile_lines(device, batch, height, width, row_pass, true, sms), batch,
                      true, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
