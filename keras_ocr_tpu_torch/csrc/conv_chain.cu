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
// on NHWC tensors, with zero padding p = k/2: fp32 in, out and sums, or
// in the bf16 mode (below) bf16 in and out with fp32 sums. In the pooled
// mode the epilogue also takes the 2x2/2 max (floored like
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
// The bf16 mode (conv_tc_bf16, a kernel of its own) is the TPU kernels'
// arithmetic on a bfloat16 input (conv_pallas.py: operands in the input's
// dtype, weights cast to it, float32 sums, float32 bias, the pool taken on
// float32, one rounding of each layer's output, its tap and the next
// layer's input to the buffer dtype): bf16 activations and bf16 K-major
// weights (cast once by the wrapper), wgmma.mma_async m64nBNk16.f32.bf16.bf16
// with A and B read from the swizzled slabs by descriptor, float32 bias,
// ReLU and pool, one round-to-nearest per stored value (pooling the rounded
// values gives the same maximum: rounding keeps the order).
//
// What bounds the bf16 mode: its ceiling is the 989 TFLOP/s dense bf16 rate,
// six times the 3xTF32 ceiling, so what the fp32 design hides behind its
// arithmetic shows. A one-tile block's fill and epilogue (the narrow layers
// ran 18 waves of 9-slab blocks), the tensor cores draining at every slab's
// wait, and 64-channel slabs that make C1's first layer (27 real K) walk
// 576 K held the first bf16 kernel to 13-16% of that rate. With those gone
// (below), what bounds it on the H100 is the TMA traffic from L2: every
// slab brings 128 activation rows and BN weight rows, each 3x3 tap fetches
// the activations again, and a box row costs an SM about 4.3 cycles (some
// 30 bytes a cycle for 128-byte rows, the L2's rate shared by 132 SMs;
// measured from the layers' times and row counts, scripts/conv_kernel_ab.py
// --tiles). So the wider the Cout tile, the more products a row feeds: the
// 256-wide layers run at 500-580 TFLOP/s of device time, the 32- and 16-wide
// cls layers at 35-65. What the design does:
// - Persistent blocks, min(tiles, SMs) of them, each walking a static tile
//   schedule (tile = blockIdx.x, + gridDim.x, ...), the Cout tiles of one
//   pixel patch adjacent so that blocks running together share activations
//   and weights in L2. The mbarriers are set up once per block and the ring's
//   stage and phase run on across tiles, so the producer loads the next
//   tile's slabs while the consumers run this tile's epilogue, which stages
//   through shared memory of its own (each warpgroup 64 rows), not the ring.
// - The sums stay in one register accumulator per tile: a bf16 output is
//   rounded to 8 bits, far above the tensor cores' fp32 truncation over
//   K = 4608 (6e-5 of the output), so there is no per-slab partial sum, and
//   one wgmma group stays in flight (wait_group 1): slab i's products are
//   issued before slab i-1's stage is released.
// - The Cout tile is 256 wide (m64n256k16, 128 accumulators a thread) where
//   Cout >= 256 and its rounds of the persistent grid cost less than the
//   128-wide tile's (a 256-wide tile takes about 1.5 times as long: 384 box
//   rows a slab against 256); else as in fp32. The wrapper decides
//   (ops/conv_cuda.py: tile_n, with slab_channels) and passes it in.
// - Slabs of 16, 32 or 64 channels (32-, 64- or 128-byte rows, the matching
//   TMA swizzle and wgmma descriptor layout) by Cin, so the cls head's
//   Cin-32 and Cin-16 layers walk exactly their channels.
// - C1's first layer (Cin 3) runs as a 1x1 layer on its im2col: the
//   im2col3x3_bf16 kernel below writes 32 columns a pixel (27 taps and
//   zeros), one 32-channel slab a tile. As a 3x3 layer on Cin padded to 8,
//   TMA fetched 9 boxes a tile of 32-byte rows half zero fill: 0.52 ms at
//   960x1280 on the H100, against about 0.2 ms for the columns (0.056 ms)
//   and the 1x1 layer (0.147 ms).
// - The stages fill what shared memory the staging leaves (up to 8).
//
// The TPU chain keeps a row strip of the whole chain in VMEM; here each
// layer's output goes through device memory (fusing the chain on chip is
// left for later).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 128;   // and a producer warpgroup
constexpr int kTileH = 8, kTileW = 16;       // the pixel patch of a tile
constexpr int kBM = kTileH * kTileW;         // 128 GEMM rows
constexpr int kRowBytes = 128;               // a pixel's (or weight row's) fp32 slab
constexpr int kStages = 4;
constexpr int kABytes = kBM * kRowBytes;     // 16 KB activation slab
constexpr int kSmemLimit = 232448;           // dynamic shared memory a block can take
constexpr int kEncodeError = 10000;          // + CUresult of a failed encode
// try_wait polls before a wedged pipeline traps instead of hanging.
constexpr long long kMaxPolls = 1LL << 24;

// The fp32 mode's operands: a K step is a slab of kSlab input channels
// (128 bytes).
template <typename T>
struct Operand;

template <>
struct Operand<float> {
  static constexpr int kSlab = 32;
  static constexpr int kWeightParts = 2;  // the tf32 hi and lo parts
  static constexpr int kCinMultiple = 4;  // 16-byte TMA strides
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <typename T, int BN>
struct Tile {
  static constexpr int kBBytes = Operand<T>::kWeightParts * BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kPitch = BN + 4;               // staged output row
  static constexpr int kPipeBytes = kStages * kStageBytes;
  static constexpr int kOutBytes = kBM * kPitch * 4;
  static constexpr int kDataBytes = kPipeBytes > kOutBytes ? kPipeBytes : kOutBytes;
  // 1 KB to align the ring for the 128-byte swizzle, then the barriers.
  static constexpr int kSmemBytes = 1024 + kDataBytes + 2 * kStages * 8;
};

// A bf16 slab of kSlab channels: rows of 32, 64 or 128 bytes in 8-row
// swizzle atoms, the TMA swizzle and the wgmma descriptor layout that match.
template <int kSlab>
struct Slab {
  static constexpr int kRowBytes = 2 * kSlab;
  static constexpr int kAtomBytes = 8 * kRowBytes;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kSlab == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                  : kSlab == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr uint64_t kLayout = kSlab == 16 ? 3 : kSlab == 32 ? 2 : 1;
};

// The bf16 kernel's shared memory: the ring (stages rounded to 1 KB, the
// largest swizzle atom), the epilogue's staging (64 rows of up to 128 bf16
// columns per warpgroup, its own so that the producer can run ahead), then
// the barriers.
template <int BN, int kSlab>
struct Bf16Tile {
  static constexpr int kABytes = kBM * Slab<kSlab>::kRowBytes;
  static constexpr int kBBytes = BN * Slab<kSlab>::kRowBytes;
  static constexpr int kStageBytes = (kABytes + kBBytes + 1023) / 1024 * 1024;
  static constexpr int kCols = BN < 128 ? BN : 128;   // staged columns per pass
  static constexpr int kPasses = BN / kCols;
  static constexpr int kChunks = kCols / 8;            // 16-byte chunks of a staged row
  static constexpr int kMask = (kChunks < 8 ? kChunks : 8) - 1;  // staging swizzle
  static constexpr int kStagedRowBytes = 2 * kCols;
  static constexpr int kStagedBytes = 2 * 64 * kStagedRowBytes;
  static constexpr int kMaxStages = 8;
  static constexpr int kFit =
      (kSmemLimit - 1024 - kStagedBytes - 2 * kMaxStages * 8) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kStagedBytes + 2 * kStages * 8;
  static_assert(kStages >= 3 && kSmemBytes <= kSmemLimit, "the ring does not fit");
};

struct Shape {
  int batch, height, width, cin, cout, ksize, relu;
  int tiles_w, tiles_h, n_tiles, chunks;  // chunks: slabs per tap
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

// The same for a bf16 slab of kSlab channels: 8-row atoms of 256, 512 or
// 1024 bytes under the 32-, 64- or 128-byte swizzle.
template <int kSlab>
__device__ __forceinline__ uint64_t slab_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ULL << 16) |
         (static_cast<uint64_t>(Slab<kSlab>::kAtomBytes >> 4) << 32) |
         (Slab<kSlab>::kLayout << 62);
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


// d (64 x BN, fp32) = a (64 x 16 bf16, K-major in shared memory) *
// b (BN x 16 bf16, K-major in shared memory) (+ d if accumulate).
template <int BN>
__device__ __forceinline__ void mma_bf16(float* d, uint64_t a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void mma_bf16<8>(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_bf16<16>(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_bf16<32>(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_bf16<64>(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_bf16<128>(float* d, uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_bf16<256>(float* d, uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ float activate(float v, int relu) {
  return relu ? fmaxf(v, 0.0f) : v;
}

// Four values at p (vec) or the first `count` of them.
__device__ __forceinline__ void store4(float* p, const float4& v, bool vec, int count) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const float vs[4] = {v.x, v.y, v.z, v.w};
  for (int j = 0; j < count; ++j) p[j] = vs[j];
}

// Stores the staged rows (pixel m of the patch at m * kPitch) to a
// (batch, height, width, cout) tensor, masked at the edges.
template <typename T, int BN>
__device__ __forceinline__ void store_pixels(const float* staged, T* dst,
                                             const Shape& s, int b, int y0,
                                             int x0, int n0, int tid) {
  constexpr int kVecs = BN / 4;
  constexpr int kPitch = Tile<T, BN>::kPitch;
  const bool vec = s.cout % 4 == 0;
  for (int idx = tid; idx < kBM * kVecs; idx += kConsumers) {
    const int m = idx / kVecs, c = (idx % kVecs) * 4;
    const int y = y0 + m / kTileW, x = x0 + m % kTileW, n = n0 + c;
    if (y >= s.height || x >= s.width || n >= s.cout) continue;
    const float4 v = *reinterpret_cast<const float4*>(staged + m * kPitch + c);
    T* p = dst + ((static_cast<long long>(b) * s.height + y) * s.width + x) * s.cout + n;
    store4(p, v, vec, min(4, s.cout - n));
  }
}

// The 2x2/2 max of the staged patch, floored like F.max_pool2d(2, 2): a
// window that reaches past an odd edge is not stored.
template <typename T, int BN>
__device__ __forceinline__ void store_pooled(const float* staged, T* dst,
                                             const Shape& s, int b, int y0,
                                             int x0, int n0, int tid) {
  constexpr int kVecs = BN / 4;
  constexpr int kPitch = Tile<T, BN>::kPitch;
  constexpr int kWinW = kTileW / 2;
  const bool vec = s.cout % 4 == 0;
  const int pooled_h = s.height / 2, pooled_w = s.width / 2;
  for (int idx = tid; idx < kBM / 4 * kVecs; idx += kConsumers) {
    const int win = idx / kVecs, c = (idx % kVecs) * 4;
    const int wy = win / kWinW, wx = win % kWinW;
    const int y = y0 / 2 + wy, x = x0 / 2 + wx, n = n0 + c;
    if (y >= pooled_h || x >= pooled_w || n >= s.cout) continue;
    const float* q = staged + (2 * wy * kTileW + 2 * wx) * kPitch + c;
    const float4 v00 = *reinterpret_cast<const float4*>(q);
    const float4 v01 = *reinterpret_cast<const float4*>(q + kPitch);
    const float4 v10 = *reinterpret_cast<const float4*>(q + kTileW * kPitch);
    const float4 v11 = *reinterpret_cast<const float4*>(q + (kTileW + 1) * kPitch);
    const float4 v = make_float4(fmaxf(fmaxf(v00.x, v01.x), fmaxf(v10.x, v11.x)),
                                 fmaxf(fmaxf(v00.y, v01.y), fmaxf(v10.y, v11.y)),
                                 fmaxf(fmaxf(v00.z, v01.z), fmaxf(v10.z, v11.z)),
                                 fmaxf(fmaxf(v00.w, v01.w), fmaxf(v10.w, v11.w)));
    T* p = dst + ((static_cast<long long>(b) * pooled_h + y) * pooled_w + x) * s.cout + n;
    store4(p, v, vec, min(4, s.cout - n));
  }
}

template <typename E, int BN, bool kPool>
__global__ void __launch_bounds__(kThreads, 1)
conv_tc(const __grid_constant__ CUtensorMap act, const __grid_constant__ CUtensorMap wts,
        const float* __restrict__ bias, E* __restrict__ out,
        E* __restrict__ tap, Shape s) {
  using T = Tile<E, BN>;
  constexpr int kSlab = Operand<E>::kSlab;
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
  // Each slab's products go to a fresh partial sum, added to acc in fp32
  // (see the head of the file).
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.0f;

  for (int step = 0; step < steps; ++step) {
    const int stage = step % kStages;
    mbar_wait(full0 + 8 * stage, (step / kStages) & 1);
    const uint8_t* a_tile = smem + stage * T::kStageBytes;
    const uint32_t b_hi = smem_u32(a_tile + kABytes);
    const uint32_t b_lo = b_hi + BN * kRowBytes;
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
    if (tap != nullptr) store_pixels<E, BN>(staged, tap, s, b, y0, x0, n0, tid);
    store_pooled<E, BN>(staged, out, s, b, y0, x0, n0, tid);
  } else {
    store_pixels<E, BN>(staged, out, s, b, y0, x0, n0, tid);
  }
}

// The bf16 kernel's epilogue: a warpgroup's 64 rows of one pass of up to 128
// columns, staged as bf16 with the 16-byte chunk c of row r at
// c ^ (r & kMask) (no bank conflicts on either side), then stored.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}

template <int BN, int kSlab>
__device__ __forceinline__ const uint4* staged_chunk(const uint8_t* staged, int r, int c) {
  using L = Bf16Tile<BN, kSlab>;
  return reinterpret_cast<const uint4*>(staged + r * L::kStagedRowBytes +
                                        ((c ^ (r & L::kMask)) << 4));
}

// Eight bf16 values at p, or the first `count` of them.
__device__ __forceinline__ void store8(bf16* p, const uint4& v, bool vec, int count) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < count)
      p[j] = __ushort_as_bfloat16(static_cast<unsigned short>(words[j / 2] >> (16 * (j % 2))));
}

// The larger of each pair of bf16 values (of a NaN and a number, the
// number, as fmaxf).
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint4 max4(const uint4& a, const uint4& b) {
  return make_uint4(max_bf16x2(a.x, b.x), max_bf16x2(a.y, b.y), max_bf16x2(a.z, b.z),
                    max_bf16x2(a.w, b.w));
}

// The staged rows (pixel r of the warpgroup's four patch rows, whose first
// image row is y0) to a (batch, height, width, cout) tensor, columns n0 ..
// n0 + kCols - 1, masked at the edges.
template <int BN, int kSlab>
__device__ __forceinline__ void store_rows_bf16(const uint8_t* staged, bf16* dst, const Shape& s,
                                                int b, int y0, int x0, int n0, int wtid) {
  using L = Bf16Tile<BN, kSlab>;
  const bool vec = s.cout % 8 == 0;
  for (int idx = wtid; idx < 64 * L::kChunks; idx += 128) {
    const int r = idx / L::kChunks, c = idx % L::kChunks;
    const int y = y0 + r / kTileW, x = x0 + r % kTileW, n = n0 + 8 * c;
    if (y >= s.height || x >= s.width || n >= s.cout) continue;
    bf16* p = dst + ((static_cast<long long>(b) * s.height + y) * s.width + x) * s.cout + n;
    store8(p, *staged_chunk<BN, kSlab>(staged, r, c), vec, min(8, s.cout - n));
  }
}

// The 2x2/2 max of the staged rows, floored like F.max_pool2d(2, 2): a
// window that reaches past an odd edge is not stored.
template <int BN, int kSlab>
__device__ __forceinline__ void store_pooled_bf16(const uint8_t* staged, bf16* dst,
                                                  const Shape& s, int b, int y0, int x0, int n0,
                                                  int wtid) {
  using L = Bf16Tile<BN, kSlab>;
  constexpr int kWinW = kTileW / 2;
  const bool vec = s.cout % 8 == 0;
  const int pooled_h = s.height / 2, pooled_w = s.width / 2;
  for (int idx = wtid; idx < 2 * kWinW * L::kChunks; idx += 128) {
    const int win = idx / L::kChunks, c = idx % L::kChunks;
    const int wy = win / kWinW, wx = win % kWinW;
    const int y = y0 / 2 + wy, x = x0 / 2 + wx, n = n0 + 8 * c;
    if (y >= pooled_h || x >= pooled_w || n >= s.cout) continue;
    const int r = 2 * wy * kTileW + 2 * wx;
    const uint4 v = max4(max4(*staged_chunk<BN, kSlab>(staged, r, c),
                              *staged_chunk<BN, kSlab>(staged, r + 1, c)),
                         max4(*staged_chunk<BN, kSlab>(staged, r + kTileW, c),
                              *staged_chunk<BN, kSlab>(staged, r + kTileW + 1, c)));
    bf16* p = dst + ((static_cast<long long>(b) * pooled_h + y) * pooled_w + x) * s.cout + n;
    store8(p, v, vec, min(8, s.cout - n));
  }
}

// The bf16 mode: a persistent warp-specialised block walks tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; tile t is Cout tile t % n_tiles of pixel
// patch t / n_tiles (patches x-fastest, then y, then the image).
template <int BN, int kSlab>
__global__ void __launch_bounds__(kThreads, 1)
conv_tc_bf16(const __grid_constant__ CUtensorMap act, const __grid_constant__ CUtensorMap wts,
             const float* __restrict__ bias, bf16* __restrict__ out, bf16* __restrict__ tap,
             Shape s, int pool) {
  using L = Bf16Tile<BN, kSlab>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* staging = smem + L::kStages * L::kStageBytes;
  const uint32_t full0 = smem_u32(staging + L::kStagedBytes);
  const uint32_t empty0 = full0 + L::kStages * 8;

  const int tid = threadIdx.x, lane = tid % 32;
  const int tiles = s.batch * s.tiles_h * s.tiles_w * s.n_tiles;
  const int pad = s.ksize / 2;
  const int steps = s.ksize * s.ksize * s.chunks;

  if (tid == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumers / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: one thread keeps the ring full across all the block's tiles,
    // so it loads the next tile's slabs during this tile's epilogue; the
    // warpgroup gives its registers to the consumers (a 256-wide tile keeps
    // 128 accumulators a thread).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % s.n_tiles) * BN;
        int rest = tile / s.n_tiles;
        const int x0 = (rest % s.tiles_w) * kTileW;
        rest /= s.tiles_w;
        const int y0 = (rest % s.tiles_h) * kTileH;
        const int b = rest / s.tiles_h;
        for (int step = 0; step < steps; ++step) {
          // A fresh barrier counts as released once: the first pass over
          // the ring does not wait.
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const int tap_index = step / s.chunks;
          const int c0 = (step - tap_index * s.chunks) * kSlab;
          const int dy = tap_index / s.ksize, dx = tap_index % s.ksize;
          const uint32_t dst = smem_u32(smem + stage * L::kStageBytes);
          const uint32_t bar = full0 + 8 * stage;
          mbar_expect_tx(bar, L::kABytes + L::kBBytes);
          tma_load_4d(dst, &act, bar, c0, x0 + dx - pad, y0 + dy - pad, b);
          tma_load_4d(dst + L::kABytes, &wts, bar, c0, tap_index, n0, 0);
          if (++stage == L::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg takes patch rows 4*wg .. 4*wg + 3 (GEMM rows
  // 64*wg ..), warp q of it one patch row; fragment rows g and g + 8 are the
  // pixels g and g + 8 of that row.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, q = (tid / 32) % 4, g = lane / 4, t = lane % 4;
  const int wtid = tid % 128;
  const int r0 = q * 16 + g;  // the fragment's first row among the warpgroup's 64
  uint8_t* staged = staging + wg * (L::kStagedBytes / 2);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;  // each tile's first product overwrites
  int stage = 0;
  uint32_t phase = 0;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % s.n_tiles) * BN;
    int rest = tile / s.n_tiles;
    const int x0 = (rest % s.tiles_w) * kTileW;
    rest /= s.tiles_w;
    const int y0 = (rest % s.tiles_h) * kTileH;
    const int b = rest / s.tiles_h;

    // Main loop: one accumulator over the tile's K, one wgmma group in
    // flight; a stage is released once the group after it has been issued.
    int held = -1;
    for (int step = 0; step < steps; ++step) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t a_rows =
          smem_u32(smem + stage * L::kStageBytes) + wg * 64 * Slab<kSlab>::kRowBytes;
      const uint32_t b_rows = smem_u32(smem + stage * L::kStageBytes + L::kABytes);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk)
        mma_bf16<BN>(acc, slab_desc<kSlab>(a_rows + kk * 32), slab_desc<kSlab>(b_rows + kk * 32),
                     step > 0 || kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
      if (held >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * held);
      }
      held = stage;
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * held);

    // Epilogue, per warpgroup and pass of kCols columns: bias and ReLU in
    // float32, one rounding to bf16, staged, then stored (pooled: the tap
    // first, then the 2x2 max).
    const int wy0 = y0 + 4 * wg;
#pragma unroll
    for (int h = 0; h < L::kPasses; ++h) {
      warpgroup_sync(wg);  // the previous pass or tile is stored
#pragma unroll
      for (int i = 0; i < L::kChunks; ++i) {
        const int j = h * L::kChunks + i;  // the accumulator's 8-column group
        const int n = n0 + 8 * j + 2 * t;
        // Each group's bias is loaded where it is used, not hoisted
        // (the loads beside 128 live accumulators spill).
        asm volatile("" ::: "memory");
        const float b0 = n < s.cout ? bias[n] : 0.0f;
        const float b1 = n + 1 < s.cout ? bias[n + 1] : 0.0f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + 8 * half;
          *reinterpret_cast<__nv_bfloat162*>(staged + r * L::kStagedRowBytes +
                                             ((i ^ (r & L::kMask)) << 4) + 4 * t) =
              __floats2bfloat162_rn(activate(acc[4 * j + 2 * half] + b0, s.relu),
                                    activate(acc[4 * j + 2 * half + 1] + b1, s.relu));
        }
      }
      warpgroup_sync(wg);
      const int nh = n0 + h * L::kCols;
      if (pool) {
        if (tap != nullptr) store_rows_bf16<BN, kSlab>(staged, tap, s, b, wy0, x0, nh, wtid);
        store_pooled_bf16<BN, kSlab>(staged, out, s, b, wy0, x0, nh, wtid);
      } else {
        store_rows_bf16<BN, kSlab>(staged, out, s, b, wy0, x0, nh, wtid);
      }
    }
  }
}

// The bf16 columns of a 3x3 SAME conv of a layer of kCin <= 3 channels
// (C1's first layer): for each pixel, tap (dy, dx) of channel c at column
// (dy * 3 + dx) * kCin + c, zero outside the image and past 9 * kCin, 32
// columns (64 bytes) a pixel, so that the layer runs as a 1x1 layer whose
// K is one 32-channel slab. One thread a pixel.
template <int kCin>
__global__ void im2col3x3_bf16(const bf16* __restrict__ in, bf16* __restrict__ out, int batch,
                               int height, int width) {
  const long long pixel = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (pixel >= static_cast<long long>(batch) * height * width) return;
  const int x = static_cast<int>(pixel % width);
  const long long rest = pixel / width;
  const int y = static_cast<int>(rest % height);
  const long long b = rest / height;
  uint32_t words[16] = {};
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
    const bool inside = yy >= 0 && yy < height && xx >= 0 && xx < width;
    const bf16* src = in + ((b * height + (inside ? yy : 0)) * width + (inside ? xx : 0)) * kCin;
#pragma unroll
    for (int c = 0; c < kCin; ++c) {
      const int col = tap * kCin + c;
      const uint32_t v = inside ? __bfloat16_as_ushort(src[c]) : 0u;
      words[col / 2] |= v << (16 * (col % 2));
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(out + pixel * 32);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dst[i] = make_uint4(words[4 * i], words[4 * i + 1], words[4 * i + 2], words[4 * i + 3]);
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

// A 4-D tensor map, innermost dimension first, zeros outside the tensor.
template <typename E>
CUresult encode_4d(CUtensorMap* map, CUtensorMapDataType type, const E* base,
                   const cuuint64_t dims[4], const cuuint32_t box[4],
                   CUtensorMapSwizzle swizzle) {
  constexpr cuuint64_t kBytes = sizeof(E);
  const cuuint64_t strides[3] = {dims[0] * kBytes, dims[0] * dims[1] * kBytes,
                                 dims[0] * dims[1] * dims[2] * kBytes};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, type, 4, const_cast<E*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename E, int BN, bool kPool>
int launch(const E* in, const E* w, const float* bias, E* out, E* tap, Shape s,
           cudaStream_t stream) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  constexpr int kSlab = Operand<E>::kSlab, kParts = Operand<E>::kWeightParts;
  CUtensorMap act, wts;
  const cuuint64_t act_dims[4] = {static_cast<cuuint64_t>(s.cin), static_cast<cuuint64_t>(s.width),
                                  static_cast<cuuint64_t>(s.height), static_cast<cuuint64_t>(s.batch)};
  const cuuint32_t act_box[4] = {kSlab, kTileW, kTileH, 1};
  CUresult res = encode_4d(&act, Operand<E>::kMapType, in, act_dims, act_box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);
  const cuuint64_t w_dims[4] = {static_cast<cuuint64_t>(s.cin),
                                static_cast<cuuint64_t>(s.ksize * s.ksize),
                                static_cast<cuuint64_t>(s.cout), kParts};
  const cuuint32_t w_box[4] = {kSlab, 1, BN, kParts};
  res = encode_4d(&wts, Operand<E>::kMapType, w, w_dims, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);

  s.tiles_w = (s.width + kTileW - 1) / kTileW;
  s.tiles_h = (s.height + kTileH - 1) / kTileH;
  s.n_tiles = (s.cout + BN - 1) / BN;
  s.chunks = (s.cin + kSlab - 1) / kSlab;
  const long long blocks = static_cast<long long>(s.batch) * s.tiles_h * s.tiles_w * s.n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = conv_tc<E, BN, kPool>;
  constexpr int kSmem = Tile<E, BN>::kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(act, wts, bias, out, tap, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, bool kPool>
int launch_tiled(const E* in, const E* w, const float* bias, E* out, E* tap, const Shape& s,
                 int bn, cudaStream_t stream) {
  switch (bn) {
    case 8: return launch<E, 8, kPool>(in, w, bias, out, tap, s, stream);
    case 16: return launch<E, 16, kPool>(in, w, bias, out, tap, s, stream);
    case 32: return launch<E, 32, kPool>(in, w, bias, out, tap, s, stream);
    case 64: return launch<E, 64, kPool>(in, w, bias, out, tap, s, stream);
    case 128: return launch<E, 128, kPool>(in, w, bias, out, tap, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool layer_args_ok(const void* in, const void* w, int batch, int height, int width, int cin,
                   int cin_multiple, int cout, int ksize, int pool, const void* tap) {
  return (ksize == 1 || ksize == 3) && batch >= 0 && height >= 0 && width >= 0 && cin > 0 &&
         cin % cin_multiple == 0 && cout > 0 && (tap == nullptr || pool) &&
         reinterpret_cast<uintptr_t>(in) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

// The bf16 kernel's launch: min(tiles, sms) persistent blocks.
template <int BN, int kSlab>
int launch_bf16(const bf16* in, const bf16* w, const float* bias, bf16* out, bf16* tap, Shape s,
                int pool, int sms, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  constexpr CUtensorMapSwizzle kSwizzle = Slab<kSlab>::kSwizzle;
  CUtensorMap act, wts;
  const cuuint64_t act_dims[4] = {static_cast<cuuint64_t>(s.cin), static_cast<cuuint64_t>(s.width),
                                  static_cast<cuuint64_t>(s.height), static_cast<cuuint64_t>(s.batch)};
  const cuuint32_t act_box[4] = {kSlab, kTileW, kTileH, 1};
  CUresult res =
      encode_4d(&act, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, in, act_dims, act_box, kSwizzle);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);
  const cuuint64_t w_dims[4] = {static_cast<cuuint64_t>(s.cin),
                                static_cast<cuuint64_t>(s.ksize * s.ksize),
                                static_cast<cuuint64_t>(s.cout), 1};
  const cuuint32_t w_box[4] = {kSlab, 1, BN, 1};
  res = encode_4d(&wts, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, w_dims, w_box, kSwizzle);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);

  s.tiles_w = (s.width + kTileW - 1) / kTileW;
  s.tiles_h = (s.height + kTileH - 1) / kTileH;
  s.n_tiles = (s.cout + BN - 1) / BN;
  s.chunks = (s.cin + kSlab - 1) / kSlab;
  const long long tiles = static_cast<long long>(s.batch) * s.tiles_h * s.tiles_w * s.n_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  auto kernel = conv_tc_bf16<BN, kSlab>;
  constexpr int kSmem = Bf16Tile<BN, kSlab>::kSmemBytes;
  // The shared-memory attribute once per device (of the first 64).
  static std::atomic<unsigned long long> configured{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = device < 64 ? 1ULL << device : 0;
  if ((configured.load(std::memory_order_relaxed) & bit) == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured.fetch_or(bit);
  }
  kernel<<<blocks, kThreads, kSmem, stream>>>(act, wts, bias, out, tap, s, pool);
  return static_cast<int>(cudaGetLastError());
}

template <int kSlab>
int launch_bf16_tiled(const bf16* in, const bf16* w, const float* bias, bf16* out, bf16* tap,
                      const Shape& s, int pool, int bn, int sms, cudaStream_t stream) {
  switch (bn) {
    case 8: return launch_bf16<8, kSlab>(in, w, bias, out, tap, s, pool, sms, stream);
    case 16: return launch_bf16<16, kSlab>(in, w, bias, out, tap, s, pool, sms, stream);
    case 32: return launch_bf16<32, kSlab>(in, w, bias, out, tap, s, pool, sms, stream);
    case 64: return launch_bf16<64, kSlab>(in, w, bias, out, tap, s, pool, sms, stream);
    case 128: return launch_bf16<128, kSlab>(in, w, bias, out, tap, s, pool, sms, stream);
    case 256: return launch_bf16<256, kSlab>(in, w, bias, out, tap, s, pool, sms, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One SAME stride-1 conv layer on NHWC fp32 `in` (batch, height, width,
// cin), cin a multiple of 4 (16-byte TMA strides; the wrapper pads with
// zero channels). `w` is (2, cout, ksize*ksize, cin): the tf32 hi and lo
// parts of the kernel, K-major; `bias` (cout). Without `pool`, `out` is
// (batch, height, width, cout) and `tap` must be null. With `pool`, `out`
// is (batch, height/2, width/2, cout) and `tap`, if not null, receives the
// (batch, height, width, cout) pre-pool activation. `bn` is the Cout tile
// (8, 16, 32, 64 or 128). `in` and `w` must be 16-byte aligned; inputs and
// outputs must not overlap. Returns 0 when the kernel was enqueued, else
// the launch's CUDA error code, or 10000 + the CUresult of a tensor map
// that could not be encoded.
extern "C" int conv_layer(const float* in, const float* w, const float* bias,
                          float* out, float* tap, int batch, int height,
                          int width, int cin, int cout, int ksize, int relu,
                          int pool, int bn, cudaStream_t stream) {
  if (!layer_args_ok(in, w, batch, height, width, cin, Operand<float>::kCinMultiple, cout, ksize,
                     pool, tap))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * height * width == 0) return 0;
  Shape s{batch, height, width, cin, cout, ksize, relu != 0, 0, 0, 0, 0};
  return pool ? launch_tiled<float, true>(in, w, bias, out, tap, s, bn, stream)
              : launch_tiled<float, false>(in, w, bias, out, tap, s, bn, stream);
}

// The bf16 mode of conv_layer: `in`, `out` and `tap` bf16 with cin a
// multiple of 8, `w` (cout, ksize*ksize, cin) bf16 K-major (one part, no
// split), `bias` fp32; float32 sums, each stored value rounded once to bf16.
// `bn` is the Cout tile (8 ... 256), `slab` the channels of a K step (16, 32
// or 64), `sms` the most blocks to run (the card's SMs).
extern "C" int conv_layer_bf16(const void* in, const void* w, const float* bias, void* out,
                               void* tap, int batch, int height, int width, int cin, int cout,
                               int ksize, int relu, int pool, int bn, int slab, int sms,
                               cudaStream_t stream) {
  if (!layer_args_ok(in, w, batch, height, width, cin, 8, cout, ksize, pool, tap) || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * height * width == 0) return 0;
  Shape s{batch, height, width, cin, cout, ksize, relu != 0, 0, 0, 0, 0};
  const auto* x = static_cast<const bf16*>(in);
  const auto* k = static_cast<const bf16*>(w);
  auto* y = static_cast<bf16*>(out);
  auto* t = static_cast<bf16*>(tap);
  switch (slab) {
    case 16: return launch_bf16_tiled<16>(x, k, bias, y, t, s, pool, bn, sms, stream);
    case 32: return launch_bf16_tiled<32>(x, k, bias, y, t, s, pool, bn, sms, stream);
    case 64: return launch_bf16_tiled<64>(x, k, bias, y, t, s, pool, bn, sms, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The columns of a 3x3 SAME conv for a bf16 layer of cin <= 3 channels:
// `in` (batch, height, width, cin) bf16, `out` (batch, height, width, 32)
// bf16, 16-byte aligned. Returns 0 when the kernel was enqueued, else the
// CUDA error code.
extern "C" int conv_im2col_bf16(const void* in, void* out, int batch, int height, int width,
                                int cin, cudaStream_t stream) {
  if (batch < 0 || height < 0 || width < 0 || cin < 1 || cin > 3 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels = static_cast<long long>(batch) * height * width;
  if (pixels == 0) return 0;
  constexpr int kBlock = 256;
  const long long blocks = (pixels + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* x = static_cast<const bf16*>(in);
  auto* y = static_cast<bf16*>(out);
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (cin) {
    case 1: im2col3x3_bf16<1><<<grid, kBlock, 0, stream>>>(x, y, batch, height, width); break;
    case 2: im2col3x3_bf16<2><<<grid, kBlock, 0, stream>>>(x, y, batch, height, width); break;
    default: im2col3x3_bf16<3><<<grid, kBlock, 0, stream>>>(x, y, batch, height, width); break;
  }
  return static_cast<int>(cudaGetLastError());
}
