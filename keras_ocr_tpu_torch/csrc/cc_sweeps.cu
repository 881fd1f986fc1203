// Connected-component label sweeps for Hopper (sm_90a).
//
// Replaces keras_ocr_tpu/ops/cc_pallas.py:segmented_min_sweeps_pallas and
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
// What bounds it: bytes. A pass reads values and barrier and writes values,
// 12 B per pixel, and does a handful of integer operations per pixel. At
// B = 8 x 480 x 640 that is about 29 MB per pass and about 18 passes per
// call (8 sweeps plus the convergence sweep); the whole batch fits the
// 50 MB L2, so after the first pass the passes run from L2.
//
// What the design does about it: each pass touches every pixel once (load
// into shared memory, scan there, store once), where the shift-doubling
// form makes ~2 log2(L) full-map passes per pass. The TPU kernel kept the
// whole map in VMEM across every pass of every sweep; here the passes
// depend on each other across the whole image and blocks cannot wait for
// each other, so each pass is its own launch, and the map goes back to
// L2 in between.
//
// Layout of one launch: one block per (image, line). The line (<= 4096
// cells) is loaded into shared memory; each thread owns a contiguous chunk,
// scans it serially, the chunk summaries are scanned across the block
// (Hillis-Steele in shared memory), and each thread rescans its chunk with
// its carry. Column passes read with stride W, uncoalesced.
//
// Left for later: a barrier narrower than int32, several passes fused into
// one launch, and coalesced column passes (a block per band of columns).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLine = 4096;
constexpr int kNoValue = 0x7fffffff;

// A scan element: `head` says a run starts inside the span, `value` is the
// minimum from the last run start of the span to its end, or of the whole
// span when no run starts inside it.
__device__ __forceinline__ void combine(int& head, int& value, int next_head,
                                        int next_value) {
  value = next_head ? next_value : min(value, next_value);
  head = head | next_head;
}

__global__ void __launch_bounds__(kThreads)
sweep_pass(int* __restrict__ values, const int* __restrict__ barrier,
           const int* __restrict__ key, int height, int width, int row_pass,
           int sentinel, int* __restrict__ changed) {
  extern __shared__ int smem[];
  const int line_len = row_pass ? width : height;
  const int lines_per_image = row_pass ? height : width;
  const int image = blockIdx.x / lines_per_image;
  const int line = blockIdx.x % lines_per_image;
  const long long plane = (long long)image * height * width;
  const long long base = plane + (row_pass ? (long long)line * width : line);
  const long long stride = row_pass ? 1 : width;

  int* sv = smem;                   // original values, line_len
  int* sr = sv + line_len;          // keys, then backward scan, then result
  uint8_t* sb = reinterpret_cast<uint8_t*>(sr + line_len);  // barrier
  uint8_t* sh = sb + line_len;      // run heads: bit 0 forward, bit 1 backward
  __shared__ int fwd_head[kThreads], fwd_val[kThreads];
  __shared__ int bwd_head[kThreads], bwd_val[kThreads];

  const int tid = threadIdx.x;
  for (int i = tid; i < line_len; i += kThreads) {
    sv[i] = values[base + i * stride];
    sb[i] = barrier[base + i * stride] != 0;
    if (key != nullptr) sr[i] = key[base + i * stride];
  }
  __syncthreads();
  // Unkeyed: a run ends AT a barrier cell, which belongs to the runs on both
  // of its sides. Keyed: runs are maximal same-key non-barrier stretches.
  for (int i = tid; i < line_len; i += kThreads) {
    int fwd = sb[i], bwd = sb[i];
    if (key != nullptr) {
      fwd |= i == 0 || sb[i - 1] || sr[i - 1] != sr[i];
      bwd |= i == line_len - 1 || sb[i + 1] || sr[i + 1] != sr[i];
    }
    sh[i] = fwd | (bwd << 1);
  }
  __syncthreads();

  const int chunk = (line_len + kThreads - 1) / kThreads;
  const int start = min(tid * chunk, line_len);
  const int stop = min(start + chunk, line_len);

  // Chunk summaries in both directions.
  int fh = 0, fv = kNoValue;
  for (int i = start; i < stop; ++i) combine(fh, fv, sh[i] & 1, sv[i]);
  int bh = 0, bv = kNoValue;
  for (int i = stop - 1; i >= start; --i) combine(bh, bv, sh[i] >> 1, sv[i]);
  fwd_head[tid] = fh;
  fwd_val[tid] = fv;
  bwd_head[tid] = bh;
  bwd_val[tid] = bv;
  __syncthreads();

  // Inclusive scans of the summaries: forward over threads 0..t, backward
  // over threads T-1..t.
  for (int d = 1; d < kThreads; d <<= 1) {
    int h0 = 0, v0 = kNoValue, h1 = 0, v1 = kNoValue;
    const bool take_fwd = tid >= d;
    const bool take_bwd = tid + d < kThreads;
    if (take_fwd) {
      h0 = fwd_head[tid - d];
      v0 = fwd_val[tid - d];
      combine(h0, v0, fwd_head[tid], fwd_val[tid]);
    }
    if (take_bwd) {
      h1 = bwd_head[tid + d];
      v1 = bwd_val[tid + d];
      combine(h1, v1, bwd_head[tid], bwd_val[tid]);
    }
    __syncthreads();
    if (take_fwd) {
      fwd_head[tid] = h0;
      fwd_val[tid] = v0;
    }
    if (take_bwd) {
      bwd_head[tid] = h1;
      bwd_val[tid] = v1;
    }
    __syncthreads();
  }
  const int fwd_carry = tid > 0 ? fwd_val[tid - 1] : kNoValue;
  const int bwd_carry = tid + 1 < kThreads ? bwd_val[tid + 1] : kNoValue;

  // Backward rescan into sr, then forward rescan combining both.
  int run = bwd_carry;
  for (int i = stop - 1; i >= start; --i) {
    run = (sh[i] >> 1) ? sv[i] : min(run, sv[i]);
    sr[i] = run;
  }
  run = fwd_carry;
  int any_change = 0;
  for (int i = start; i < stop; ++i) {
    run = (sh[i] & 1) ? sv[i] : min(run, sv[i]);
    const int out = sb[i] ? sentinel : min(run, sr[i]);
    any_change |= out != sv[i];
    sr[i] = out;
  }
  __syncthreads();
  for (int i = tid; i < line_len; i += kThreads) values[base + i * stride] = sr[i];
  if (changed != nullptr) {
    if (__syncthreads_or(any_change) && tid == 0) atomicOr(changed + image, 1);
  }
}

cudaError_t launch_pass(int* values, const int* barrier, const int* key,
                        int batch, int height, int width, int row_pass,
                        int sentinel, int* changed, cudaStream_t stream) {
  const int line_len = row_pass ? width : height;
  const size_t smem = (size_t)line_len * (2 * sizeof(int) + 2);
  sweep_pass<<<batch * (row_pass ? height : width), kThreads, smem, stream>>>(
      values, barrier, key, height, width, row_pass, sentinel, changed);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cc_sweeps_max_line() { return kMaxLine; }

static bool bad_shape(int batch, int height, int width) {
  return batch <= 0 || height <= 0 || width <= 0 || height > kMaxLine ||
         width > kMaxLine;
}

// In place on `values` (B, H, W) int32 with `barrier` (B, H, W) int32 0/1:
// `num_sweeps` sweeps, then, if `changed` is not null, one more sweep that
// ORs 1 into changed[b] for every image b it alters. Launches on `stream`,
// does not synchronise, returns cudaGetLastError().
extern "C" int cc_sweeps(int* values, const int* barrier, int batch, int height,
                         int width, int sentinel, int num_sweeps, int* changed,
                         void* stream) {
  if (bad_shape(batch, height, width)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = num_sweeps + (changed != nullptr ? 1 : 0);
  for (int sweep = 0; sweep < total; ++sweep) {
    int* flag = sweep == num_sweeps ? changed : nullptr;
    for (int row_pass = 1; row_pass >= 0; --row_pass) {
      cudaError_t err = launch_pass(values, barrier, nullptr, batch, height,
                                    width, row_pass, sentinel, flag, s);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

// The keyed run minimum of keras_ocr_tpu/ops/cc.py:_keyed_run_min along the
// rows, then along the columns, in place on `values`: runs are maximal
// stretches of non-barrier cells with equal `key` (B, H, W) int32, and
// barrier cells get `sentinel`.
extern "C" int cc_keyed_rows_cols(int* values, const int* barrier,
                                  const int* key, int batch, int height,
                                  int width, int sentinel, void* stream) {
  if (bad_shape(batch, height, width)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int row_pass = 1; row_pass >= 0; --row_pass) {
    cudaError_t err = launch_pass(values, barrier, key, batch, height, width,
                                  row_pass, sentinel, nullptr, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
