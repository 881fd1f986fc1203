// SAME stride-1 convolutions of the BN-folded CRAFT graph on Hopper's
// tensor cores (sm_90a).
//
// Replaces keras_ocr_tpu/ops/conv_pallas.py:conv3x3_bias_act (3x3 conv +
// bias (+ReLU) as one im2col product per row strip) and the layers of
// keras_ocr_tpu/ops/conv_pallas.py:conv_chain (a chain of 1x1 / 3x3 conv +
// bias (+ReLU) with BatchNorm folded in, an optional fused 2x2/2 max-pool
// and a pre-pool tap). One launch computes one layer:
//
//   out[b, y, x, n] = act(bias[n] + sum_{dy, dx, c} in[b, y+dy-p, x+dx-p, c]
//                                               * w[n, dy*k + dx, c])
//
// on NHWC fp32 tensors, with zero padding p = k/2, fp32 in, out and sums.
// In the pooled mode the epilogue also takes the 2x2/2 max (floored like
// F.max_pool2d(2, 2)) and can write the pre-pool activation as a tap.
//
// What bounds it: the tensor cores' rate. The CRAFT layers do 2*9*Cin FLOP
// per output value, far above the card's balance point, and the parity
// bars (1e-4 of F.conv2d in fp32) rule out one TF32 product, which keeps
// 10 mantissa bits. So every product is taken as three TF32 products
// (3xTF32): x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and
// a*b ~ a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, as accurate as fp32 at CRAFT's
// depths. The ceiling is 495 / 3 = 165 TFLOP/s; on the narrow layers (C1,
// upconv4, the cls head: Cout <= 64) it is the bytes of the activations.
//
// What the design does about it: an implicit GEMM, M = pixels, N = Cout,
// K = k*k*Cin walked tap by tap in slabs of 32 input channels (128 bytes).
// - An M tile is an 8 x 16 patch of one image. Tap (dy, dx) of a slab is
//   one TMA box (32, 16, 8, 1) of a 4-D tensor map over (C, W, H, B),
//   loaded at the patch origin shifted by (dx - p, dy - p): TMA fills what
//   lies outside the image with zeros, so SAME padding needs no masks.
// - The weights come as a (2, Cout, k*k, Cin) tensor, hi and lo already
//   split by the wrapper: K-major, as the tf32 form of wgmma requires, and
//   loaded as one box (32, 1, BN, 2) per slab. Rows past Cout and channels
//   past Cin are zero-filled by TMA as well. A layer with Cin < 32 still
//   walks 32-channel slabs: C1's first layer (Cin 3, padded to 4 by the
//   wrapper for TMA's 16-byte strides) does 288 K where 27 are real.
// - One producer thread keeps a ring of kStages (activation, weight) slabs
//   in flight, each guarded by a full and an empty mbarrier; its warpgroup
//   gives its registers to the consumers (setmaxnreg). Two consumer
//   warpgroups, 64 pixels each, read their activation fragments from the
//   128-byte-swizzled slab into registers, split them into hi and lo there
//   (wgmma takes a register A operand for tf32), and issue three
//   wgmma.mma_async m64nBNk8 per 8 channels. The tensor cores' fp32 sums
//   are not rounded to nearest: one accumulator walked over K = 4608
//   drifted by up to 6e-5 of the output on the H100. So each slab's 12
//   products go to a fresh partial accumulator, added to the running sum
//   in fp32 (2e-6, as close to F.conv2d as fp32 itself).
// - BN, the Cout tile, is chosen per layer from Cout (8 ... 128), so the
//   cls head's Cout 2 and 16 do not pay for a 128-wide tile.
// - The epilogue adds the bias and ReLU in registers, stages the tile
//   through shared memory and stores it coalesced, masked at the image's
//   edge and past Cout. In the pooled mode patch origins are even, so every
//   2x2 window lies in one tile; partial windows at odd edges go to the tap
//   only.
//
// The TPU chain keeps a row strip of the whole chain in VMEM; here each
// layer's output goes through device memory (fusing the chain on chip is
// left for later, as is bf16).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 128;   // and a producer warpgroup
constexpr int kTileH = 8, kTileW = 16;       // the pixel patch of a tile
constexpr int kBM = kTileH * kTileW;         // 128 GEMM rows
constexpr int kSlab = 32;                    // input channels per K step
constexpr int kStages = 4;
constexpr int kABytes = kBM * kSlab * 4;     // 16 KB activation slab
constexpr int kEncodeError = 10000;          // + CUresult of a failed encode
// try_wait polls before a wedged pipeline traps instead of hanging.
constexpr long long kMaxPolls = 1LL << 24;

template <int BN>
struct Tile {
  static constexpr int kBBytes = 2 * BN * kSlab * 4;  // hi and lo weights
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kPitch = BN + 4;               // staged output row
  static constexpr int kPipeBytes = kStages * kStageBytes;
  static constexpr int kOutBytes = kBM * kPitch * 4;
  static constexpr int kDataBytes = kPipeBytes > kOutBytes ? kPipeBytes : kOutBytes;
  // 1 KB to align the ring for the 128-byte swizzle, then the barriers.
  static constexpr int kSmemBytes = 1024 + kDataBytes + 2 * kStages * 8;
};

// The Cout tile (wgmma N): the narrowest of 8, 16, 32 and 64 that holds
// Cout, else 128 (wider layers take several column tiles).
constexpr int conv_tile_n_for(int cout) {
  return cout <= 8 ? 8 : cout <= 16 ? 16 : cout <= 32 ? 32 : cout <= 64 ? 64 : 128;
}

struct Shape {
  int batch, height, width, cin, cout, ksize, relu;
  int tiles_w, tiles_h, n_tiles, chunks;  // chunks: 32-channel slabs per tap
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long polls = 0; !done; ++polls) {
    if (polls == kMaxPolls) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// x = hi + lo, both rounded to tf32 (nearest, ties away), as the wrapper
// splits the weights.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// wgmma descriptor of a K-major operand in 128-byte-swizzled 8-row atoms
// (1024 bytes apart); the leading offset is unused for this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ULL << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ULL << 62);
}

// Keeps a register's value where it is across the asynchronous wgmma.
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// d (64 x BN, fp32, the wgmma accumulator layout) = a (64 x 8 tf32, four
// registers per thread) * b (BN x 8 tf32, K-major in shared memory)
// (+ d if accumulate).
template <int BN>
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void mma<8>(float* d, const uint32_t* a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma<16>(float* d, const uint32_t* a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma<32>(float* d, const uint32_t* a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma<64>(float* d, const uint32_t* a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma<128>(float* d, const uint32_t* a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}


__device__ __forceinline__ float activate(float v, int relu) {
  return relu ? fmaxf(v, 0.0f) : v;
}

// Stores the staged rows (pixel m of the patch at m * kPitch) to a
// (batch, height, width, cout) tensor, masked at the edges.
template <int BN>
__device__ __forceinline__ void store_pixels(const float* staged, float* dst,
                                             const Shape& s, int b, int y0,
                                             int x0, int n0, int tid) {
  constexpr int kVecs = BN / 4;
  const bool vec = s.cout % 4 == 0;
  for (int idx = tid; idx < kBM * kVecs; idx += kConsumers) {
    const int m = idx / kVecs, c = (idx % kVecs) * 4;
    const int y = y0 + m / kTileW, x = x0 + m % kTileW, n = n0 + c;
    if (y >= s.height || x >= s.width || n >= s.cout) continue;
    const float4 v = *reinterpret_cast<const float4*>(staged + m * Tile<BN>::kPitch + c);
    float* p = dst + ((static_cast<long long>(b) * s.height + y) * s.width + x) * s.cout + n;
    if (vec) {
      *reinterpret_cast<float4*>(p) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int j = 0; j < 4 && n + j < s.cout; ++j) p[j] = vs[j];
    }
  }
}

// The 2x2/2 max of the staged patch, floored like F.max_pool2d(2, 2): a
// window that reaches past an odd edge is not stored.
template <int BN>
__device__ __forceinline__ void store_pooled(const float* staged, float* dst,
                                             const Shape& s, int b, int y0,
                                             int x0, int n0, int tid) {
  constexpr int kVecs = BN / 4;
  constexpr int kWinW = kTileW / 2;
  const bool vec = s.cout % 4 == 0;
  const int pooled_h = s.height / 2, pooled_w = s.width / 2;
  for (int idx = tid; idx < kBM / 4 * kVecs; idx += kConsumers) {
    const int win = idx / kVecs, c = (idx % kVecs) * 4;
    const int wy = win / kWinW, wx = win % kWinW;
    const int y = y0 / 2 + wy, x = x0 / 2 + wx, n = n0 + c;
    if (y >= pooled_h || x >= pooled_w || n >= s.cout) continue;
    const float* q = staged + (2 * wy * kTileW + 2 * wx) * Tile<BN>::kPitch + c;
    const float4 v00 = *reinterpret_cast<const float4*>(q);
    const float4 v01 = *reinterpret_cast<const float4*>(q + Tile<BN>::kPitch);
    const float4 v10 = *reinterpret_cast<const float4*>(q + kTileW * Tile<BN>::kPitch);
    const float4 v11 = *reinterpret_cast<const float4*>(q + (kTileW + 1) * Tile<BN>::kPitch);
    const float4 v = make_float4(fmaxf(fmaxf(v00.x, v01.x), fmaxf(v10.x, v11.x)),
                                 fmaxf(fmaxf(v00.y, v01.y), fmaxf(v10.y, v11.y)),
                                 fmaxf(fmaxf(v00.z, v01.z), fmaxf(v10.z, v11.z)),
                                 fmaxf(fmaxf(v00.w, v01.w), fmaxf(v10.w, v11.w)));
    float* p = dst + ((static_cast<long long>(b) * pooled_h + y) * pooled_w + x) * s.cout + n;
    if (vec) {
      *reinterpret_cast<float4*>(p) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int j = 0; j < 4 && n + j < s.cout; ++j) p[j] = vs[j];
    }
  }
}

template <int BN, bool kPool>
__global__ void __launch_bounds__(kThreads, 1)
conv_tc(const __grid_constant__ CUtensorMap act, const __grid_constant__ CUtensorMap wts,
        const float* __restrict__ bias, float* __restrict__ out,
        float* __restrict__ tap, Shape s) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t full0 = smem_u32(smem + T::kDataBytes);
  const uint32_t empty0 = full0 + kStages * 8;

  const int tid = threadIdx.x, lane = tid % 32;
  const int n0 = (blockIdx.x % s.n_tiles) * BN;
  const int tile = blockIdx.x / s.n_tiles;
  const int x0 = (tile % s.tiles_w) * kTileW;
  const int rest = tile / s.tiles_w;
  const int y0 = (rest % s.tiles_h) * kTileH;
  const int b = rest / s.tiles_h;
  const int pad = s.ksize / 2;
  const int steps = s.ksize * s.ksize * s.chunks;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumers / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: one thread keeps the ring full; the warpgroup drops to 40
    // registers so that the consumers can take 232.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) {
      for (int step = 0; step < steps; ++step) {
        const int stage = step % kStages;
        if (step >= kStages) mbar_wait(empty0 + 8 * stage, (step / kStages - 1) & 1);
        const int tap_index = step / s.chunks;
        const int c0 = (step - tap_index * s.chunks) * kSlab;
        const int dy = tap_index / s.ksize, dx = tap_index % s.ksize;
        const uint32_t dst = smem_u32(smem + stage * T::kStageBytes);
        const uint32_t bar = full0 + 8 * stage;
        mbar_expect_tx(bar, T::kStageBytes);
        tma_load_4d(dst, &act, bar, c0, x0 + dx - pad, y0 + dy - pad, b);
        tma_load_4d(dst + kABytes, &wts, bar, c0, tap_index, n0, 0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg takes patch rows 4*wg .. 4*wg + 3; warp q of it
  // one patch row (16 pixels, GEMM rows 16q .. 16q + 15 of the warpgroup).
  // Fragment rows g and g + 8 are the pixels g and g + 8 of that row.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, q = (tid / 32) % 4, g = lane / 4, t = lane % 4;
  const int row0 = wg * 64 + q * 16 + g;
  // Each slab's 12 products go to a fresh partial sum, added to acc in
  // fp32 (see the head of the file).
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.0f;

  for (int step = 0; step < steps; ++step) {
    const int stage = step % kStages;
    mbar_wait(full0 + 8 * stage, (step / kStages) & 1);
    const uint8_t* a_tile = smem + stage * T::kStageBytes;
    const uint32_t b_hi = smem_u32(a_tile + kABytes);
    const uint32_t b_lo = b_hi + BN * kSlab * 4;
    // Fragment of k8 block kk: a0 (row g, col t), a1 (row g+8, col t),
    // a2 (row g, col t+4), a3 (row g+8, col t+4); 16-byte chunk c of row r
    // lies at chunk c ^ (r % 8) under the 128-byte swizzle.
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + (r & 1) * 8;
        const int chunk = 2 * kk + (r >> 1);
        const float v = *reinterpret_cast<const float*>(
            a_tile + row * 128 + ((chunk ^ (row & 7)) << 4) + t * 4);
        split_tf32(v, hi[kk][r], lo[kk][r]);
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(part[i]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d_hi = sw128_desc(b_hi + kk * 32);
      const uint64_t d_lo = sw128_desc(b_lo + kk * 32);
      mma<BN>(part, lo[kk], d_hi, kk > 0);  // the small terms first
      mma<BN>(part, hi[kk], d_lo, 1);
      mma<BN>(part, hi[kk], d_hi, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        fence_reg(hi[kk][r]);
        fence_reg(lo[kk][r]);
      }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(part[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }

  // Epilogue. Every consumer is past the ring, whose slabs have all been
  // read, so the tile is staged where the ring was.
  consumers_sync();
  float* staged = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = 8 * i + 2 * t;
    const int n = n0 + col;
    const float b0 = n < s.cout ? bias[n] : 0.0f;
    const float b1 = n + 1 < s.cout ? bias[n + 1] : 0.0f;
    *reinterpret_cast<float2*>(staged + row0 * T::kPitch + col) =
        make_float2(activate(acc[4 * i] + b0, s.relu), activate(acc[4 * i + 1] + b1, s.relu));
    *reinterpret_cast<float2*>(staged + (row0 + 8) * T::kPitch + col) =
        make_float2(activate(acc[4 * i + 2] + b0, s.relu),
                    activate(acc[4 * i + 3] + b1, s.relu));
  }
  consumers_sync();
  if (kPool) {
    if (tap != nullptr) store_pixels<BN>(staged, tap, s, b, y0, x0, n0, tid);
    store_pooled<BN>(staged, out, s, b, y0, x0, n0, tid);
  } else {
    store_pixels<BN>(staged, out, s, b, y0, x0, n0, tid);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the CUDA runtime has
// already loaded; it is looked up there so the library links no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A 4-D fp32 tensor map, innermost dimension first, 128-byte swizzle,
// zeros outside the tensor.
CUresult encode_4d(CUtensorMap* map, const float* base, const cuuint64_t dims[4],
                   const cuuint32_t box[4]) {
  const cuuint64_t strides[3] = {dims[0] * 4, dims[0] * dims[1] * 4,
                                 dims[0] * dims[1] * dims[2] * 4};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BN, bool kPool>
int launch(const float* in, const float* w, const float* bias, float* out, float* tap,
           Shape s, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap act, wts;
  const cuuint64_t act_dims[4] = {static_cast<cuuint64_t>(s.cin), static_cast<cuuint64_t>(s.width),
                                  static_cast<cuuint64_t>(s.height), static_cast<cuuint64_t>(s.batch)};
  const cuuint32_t act_box[4] = {kSlab, kTileW, kTileH, 1};
  CUresult res = encode_4d(&act, in, act_dims, act_box);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);
  const cuuint64_t w_dims[4] = {static_cast<cuuint64_t>(s.cin),
                                static_cast<cuuint64_t>(s.ksize * s.ksize),
                                static_cast<cuuint64_t>(s.cout), 2};
  const cuuint32_t w_box[4] = {kSlab, 1, BN, 2};
  res = encode_4d(&wts, w, w_dims, w_box);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);

  s.tiles_w = (s.width + kTileW - 1) / kTileW;
  s.tiles_h = (s.height + kTileH - 1) / kTileH;
  s.n_tiles = (s.cout + BN - 1) / BN;
  s.chunks = (s.cin + kSlab - 1) / kSlab;
  const long long blocks = static_cast<long long>(s.batch) * s.tiles_h * s.tiles_w * s.n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = conv_tc<BN, kPool>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, Tile<BN>::kSmemBytes, stream>>>(
      act, wts, bias, out, tap, s);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPool>
int launch_tiled(const float* in, const float* w, const float* bias, float* out,
                 float* tap, const Shape& s, cudaStream_t stream) {
  switch (conv_tile_n_for(s.cout)) {
    case 8: return launch<8, kPool>(in, w, bias, out, tap, s, stream);
    case 16: return launch<16, kPool>(in, w, bias, out, tap, s, stream);
    case 32: return launch<32, kPool>(in, w, bias, out, tap, s, stream);
    case 64: return launch<64, kPool>(in, w, bias, out, tap, s, stream);
    default: return launch<128, kPool>(in, w, bias, out, tap, s, stream);
  }
}

}  // namespace

// The Cout tile (the wgmma N) a layer of `cout` output channels takes.
extern "C" int conv_tile_n(int cout) { return conv_tile_n_for(cout); }

// One SAME stride-1 conv layer on NHWC fp32 `in` (batch, height, width,
// cin), cin a multiple of 4 (16-byte TMA strides; the wrapper pads with
// zero channels). `w` is (2, cout, ksize*ksize, cin): the tf32 hi and lo
// parts of the kernel, K-major; `bias` (cout). Without `pool`, `out` is
// (batch, height, width, cout) and `tap` must be null. With `pool`, `out`
// is (batch, height/2, width/2, cout) and `tap`, if not null, receives the
// (batch, height, width, cout) pre-pool activation. `in` and `w` must be
// 16-byte aligned; inputs and outputs must not overlap. Returns 0 when the
// kernel was enqueued, else the launch's CUDA error code, or 10000 + the
// CUresult of a tensor map that could not be encoded.
extern "C" int conv_layer(const float* in, const float* w, const float* bias,
                          float* out, float* tap, int batch, int height,
                          int width, int cin, int cout, int ksize, int relu,
                          int pool, cudaStream_t stream) {
  if ((ksize != 1 && ksize != 3) || batch < 0 || height < 0 || width < 0 ||
      cin <= 0 || cin % 4 != 0 || cout <= 0 || (tap != nullptr && !pool) ||
      reinterpret_cast<uintptr_t>(in) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * height * width == 0) return 0;
  Shape s{batch, height, width, cin, cout, ksize, relu != 0, 0, 0, 0, 0};
  return pool ? launch_tiled<true>(in, w, bias, out, tap, s, stream)
              : launch_tiled<false>(in, w, bias, out, tap, s, stream);
}
