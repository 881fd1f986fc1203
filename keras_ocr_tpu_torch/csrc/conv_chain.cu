// SAME stride-1 convolutions of the BN-folded CRAFT graph for Hopper (sm_90a).
//
// Replaces keras_ocr_tpu/ops/conv_pallas.py:conv3x3_bias_act (3x3 conv +
// bias (+ReLU) as one im2col product per row strip) and the layers of
// keras_ocr_tpu/ops/conv_pallas.py:conv_chain (a chain of 1x1 / 3x3 conv +
// bias (+ReLU) with BatchNorm folded in, an optional fused 2x2/2 max-pool
// and a pre-pool tap). One launch computes one layer:
//
//   out[b, y, x, n] = act(bias[n] + sum_{dy, dx, c} in[b, y+dy-p, x+dx-p, c]
//                                               * w[(dy*k + dx)*Cin + c, n])
//
// on NHWC fp32 tensors, with zero padding p = k/2 and w laid out as the
// TPU kernel's `w.reshape(k*k*Cin, Cout)` of an HWIO kernel. In the pooled
// mode the epilogue also takes the 2x2/2 max (floored like
// F.max_pool2d(2, 2)) and can write the pre-pool activation as a tap.
//
// What bounds it: arithmetic. The CRAFT layers do 2*9*Cin FLOP per output
// value and read each input value 9*Cout times, far above the card's
// 20 FLOP/byte fp32 balance point, so the limit is the fp32 FMA rate of
// the CUDA cores (67 TFLOP/s published); TF32 and the tensor cores are
// left out because the parity bars assume full fp32.
//
// What the design does about it: an implicit GEMM, M = pixels, N = Cout,
// K = k*k*Cin, never materialising the im2col matrix. A block computes a
// 128 x 128 tile of (pixels x output channels) with 256 threads, each
// holding an 8 x 8 register tile of fp32 accumulators, so every value
// read from shared memory feeds 8 FMAs. K is walked tap by tap and, within
// a tap, 8 input channels at a time; the block's input rows (shifted by the
// tap, zero outside the image) and the weight slab go through a double
// buffer in shared memory while the next step's tiles are loaded into
// registers. Bias, ReLU and the pool run in the epilogue. The pooled mode
// orders the GEMM rows window by window (row = 4 * window + position), so
// the four pixels of a 2x2 window sit in one thread's registers.
//
// The TPU chain keeps a row strip of the whole chain in VMEM; here each
// layer's output goes through device memory (keeping the chain on chip is
// left for later, as are wgmma and bf16).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;       // GEMM rows (pixels) per block
constexpr int kBN = 128;       // GEMM columns (output channels) per block
constexpr int kBK = 8;         // K per step
constexpr int kAPitch = kBM + 4;  // padded rows of the input tile

struct Layer {
  int batch, height, width, cin, cout, ksize, relu;
  int win_h, win_w;     // pooled mode: 2x2 windows per image column / row
  long long rows;       // GEMM rows: pixels, or 4 per window when pooled
};

// GEMM row -> pixel (b, y, x); false where the row is past the end or a
// window position lies outside the image (odd sizes with a tap).
template <bool kPool>
__device__ __forceinline__ bool pixel_of(long long m, const Layer& s, int& b,
                                         int& y, int& x) {
  if (m >= s.rows) return false;
  if (kPool) {
    const long long window = m >> 2;
    const int q = static_cast<int>(m & 3);
    const int px = static_cast<int>(window % s.win_w);
    const long long rest = window / s.win_w;
    const int py = static_cast<int>(rest % s.win_h);
    b = static_cast<int>(rest / s.win_h);
    y = 2 * py + (q >> 1);
    x = 2 * px + (q & 1);
    return y < s.height && x < s.width;
  }
  x = static_cast<int>(m % s.width);
  const long long rest = m / s.width;
  y = static_cast<int>(rest % s.height);
  b = static_cast<int>(rest / s.height);
  return true;
}

__device__ __forceinline__ float activate(float v, int relu) {
  return relu ? fmaxf(v, 0.0f) : v;
}

// kVecIn: Cin % 4 == 0 (16-byte input loads); kVecOut: Cout % 4 == 0
// (16-byte weight loads and output stores). Otherwise scalar tail paths.
template <bool kPool, bool kVecIn, bool kVecOut>
__global__ void __launch_bounds__(kThreads, 2)
conv_gemm(const float* __restrict__ in, const float* __restrict__ w,
          const float* __restrict__ bias, float* __restrict__ out,
          float* __restrict__ tap, Layer s, int n_tiles) {
  __shared__ __align__(16) float a_tile[2][kBK][kAPitch];
  __shared__ __align__(16) float b_tile[2][kBK][kBN];

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int pad = s.ksize >> 1;

  // Loader roles: each thread brings 4 channels of one pixel and 4 weights
  // of one K row per step.
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  int ab = 0, ay = 0, ax = 0;
  const bool a_pixel = pixel_of<kPool>(m0 + a_row, s, ab, ay, ax);
  const int b_k = tid >> 5;
  const int b_col = (tid & 31) * 4;

  const int chunks = (s.cin + kBK - 1) / kBK;
  const int steps = s.ksize * s.ksize * chunks;

  float a_reg[4], b_reg[4];
  auto load = [&](int step) {
    const int tap_index = step / chunks;
    const int c0 = (step - tap_index * chunks) * kBK;
    const int dy = tap_index / s.ksize;
    const int dx = tap_index - dy * s.ksize;
    const int yy = ay + dy - pad;
    const int xx = ax + dx - pad;
    const int ci = c0 + a_k;
    const bool inside = a_pixel && yy >= 0 && yy < s.height && xx >= 0 &&
                        xx < s.width;
    const long long a_off =
        ((static_cast<long long>(ab) * s.height + yy) * s.width + xx) * s.cin +
        ci;
    if (kVecIn) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (inside && ci < s.cin) v = *reinterpret_cast<const float4*>(in + a_off);
      a_reg[0] = v.x; a_reg[1] = v.y; a_reg[2] = v.z; a_reg[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a_reg[j] = (inside && ci + j < s.cin) ? in[a_off + j] : 0.0f;
    }
    const int k_row = c0 + b_k;
    const int col = n0 + b_col;
    const long long b_off =
        (static_cast<long long>(tap_index) * s.cin + k_row) * s.cout + col;
    if (kVecOut) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k_row < s.cin && col < s.cout)
        v = *reinterpret_cast<const float4*>(w + b_off);
      b_reg[0] = v.x; b_reg[1] = v.y; b_reg[2] = v.z; b_reg[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b_reg[j] = (k_row < s.cin && col + j < s.cout) ? w[b_off + j] : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a_tile[buf][a_k + j][a_row] = a_reg[j];
    *reinterpret_cast<float4*>(&b_tile[buf][b_k][b_col]) =
        make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
  };

  // Compute roles: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
  // tx*4 + {0..3} and 64 + tx*4 + {0..3} of the block tile.
  const int ty = tid >> 4;
  const int tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load(step + 1);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_tile[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_tile[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_tile[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_tile[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (step + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: bias, activation, and (pooled mode) the 2x2 max and the tap.
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int col = n0 + g * 64 + tx * 4;
    if (col >= s.cout) continue;
    float bias4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bias4[j] = col + j < s.cout ? bias[col + j] : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m_first = m0 + h * 64 + ty * 4;
      float v[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[r][j] = activate(acc[h * 4 + r][g * 4 + j] + bias4[j], s.relu);
      if (kPool) {
        // m_first is a multiple of 4: rows r = 0..3 are one window's pixels.
        if (m_first >= s.rows) continue;
        int b = 0, y = 0, x = 0;
        if (tap != nullptr) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (!pixel_of<kPool>(m_first + r, s, b, y, x)) continue;
            const long long off =
                ((static_cast<long long>(b) * s.height + y) * s.width + x) *
                    s.cout + col;
            if (kVecOut) {
              *reinterpret_cast<float4*>(tap + off) =
                  make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
            } else {
              for (int j = 0; j < 4 && col + j < s.cout; ++j) tap[off + j] = v[r][j];
            }
          }
        }
        pixel_of<kPool>(m_first, s, b, y, x);
        const int pooled_h = s.height / 2, pooled_w = s.width / 2;
        const int py = y >> 1, px = x >> 1;
        if (py >= pooled_h || px >= pooled_w) continue;  // partial window
        const long long off =
            ((static_cast<long long>(b) * pooled_h + py) * pooled_w + px) *
                s.cout + col;
        float p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[j] = fmaxf(fmaxf(v[0][j], v[1][j]), fmaxf(v[2][j], v[3][j]));
        if (kVecOut) {
          *reinterpret_cast<float4*>(out + off) = make_float4(p[0], p[1], p[2], p[3]);
        } else {
          for (int j = 0; j < 4 && col + j < s.cout; ++j) out[off + j] = p[j];
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const long long m = m_first + r;
          if (m >= s.rows) break;
          const long long off = m * s.cout + col;
          if (kVecOut) {
            *reinterpret_cast<float4*>(out + off) =
                make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
          } else {
            for (int j = 0; j < 4 && col + j < s.cout; ++j) out[off + j] = v[r][j];
          }
        }
      }
    }
  }
}

template <bool kPool>
cudaError_t launch(const float* in, const float* w, const float* bias,
                   float* out, float* tap, const Layer& s,
                   cudaStream_t stream) {
  const int n_tiles = (s.cout + kBN - 1) / kBN;
  const long long blocks = (s.rows + kBM - 1) / kBM * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  const bool vec_in = s.cin % 4 == 0, vec_out = s.cout % 4 == 0;
  if (vec_in && vec_out) {
    conv_gemm<kPool, true, true><<<grid, kThreads, 0, stream>>>(in, w, bias, out, tap, s, n_tiles);
  } else if (vec_in) {
    conv_gemm<kPool, true, false><<<grid, kThreads, 0, stream>>>(in, w, bias, out, tap, s, n_tiles);
  } else if (vec_out) {
    conv_gemm<kPool, false, true><<<grid, kThreads, 0, stream>>>(in, w, bias, out, tap, s, n_tiles);
  } else {
    conv_gemm<kPool, false, false><<<grid, kThreads, 0, stream>>>(in, w, bias, out, tap, s, n_tiles);
  }
  return cudaGetLastError();
}

}  // namespace

// One SAME stride-1 conv layer on NHWC fp32 `in` (batch, height, width,
// cin); `w` is (ksize*ksize*cin, cout), `bias` (cout). Without `pool`,
// `out` is (batch, height, width, cout) and `tap` must be null. With
// `pool`, `out` is (batch, height/2, width/2, cout) and `tap`, if not null,
// receives the (batch, height, width, cout) pre-pool activation. Inputs
// and outputs must not overlap. Returns the launch's CUDA error code (0
// when the kernel was enqueued).
extern "C" int conv_layer(const float* in, const float* w, const float* bias,
                          float* out, float* tap, int batch, int height,
                          int width, int cin, int cout, int ksize, int relu,
                          int pool, cudaStream_t stream) {
  if ((ksize != 1 && ksize != 3) || batch < 0 || height < 0 || width < 0 ||
      cin <= 0 || cout <= 0 || (tap != nullptr && !pool))
    return static_cast<int>(cudaErrorInvalidValue);
  Layer s{batch, height, width, cin, cout, ksize, relu != 0, 0, 0, 0};
  if (pool) {
    // With a tap every pixel is computed, so partial windows at odd edges
    // are kept; without one only the full windows the pool reads.
    s.win_h = tap != nullptr ? (height + 1) / 2 : height / 2;
    s.win_w = tap != nullptr ? (width + 1) / 2 : width / 2;
    s.rows = 4LL * batch * s.win_h * s.win_w;
  } else {
    s.rows = static_cast<long long>(batch) * height * width;
  }
  if (s.rows == 0) return 0;
  const cudaError_t err =
      pool ? launch<true>(in, w, bias, out, tap, s, stream)
           : launch<false>(in, w, bias, out, tap, s, stream);
  return static_cast<int>(err);
}
