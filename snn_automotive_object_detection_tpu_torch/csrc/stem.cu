// Fused ResNet stem for Hopper: normalise + 7x7/2 conv + frozen BN + ReLU +
// 3x3/2 max-pool, raw NHWC f32 image in, [N, H/4, W/4, 64] bf16 out.
//
// Replaces the TPU kernel ops/pallas_stem.py (_stem_kernel, launched by
// stem_pallas_apply). Normalisation and the BN affine arrive folded into
// the weights and a bias (ops/cuda_stem.py: fold_stem_weights). Per conv
// pixel and output channel o:
//   conv = bf16( sum over 7x7x3 taps of bf16(pixel) * bf16(w[tap, o]) )  (f32 sum)
//          where a tap outside the image reads bf16(mean[cin])
//   act  = bf16( max(float(conv) + bias[o], 0) )
// and the output is the max of act over the 3x3 stride-2 window, positions
// outside the conv map never winning.
//
// What bounds it on this card: memory. 28 MB of f32 image in and 19 MB of
// bf16 out per image pair against 11 GFLOP of products, so the kernel reads
// each image row about once (a 7x7 halo shared through shared memory; rows
// re-read only where tiles overlap) and writes the pooled map only: the
// 151 MB conv map never exists in device memory.
//
// Design: a block walks over tiles of 4 x 16 pooled pixels. For a tile it
// converts the 23 x 71 pixel input window to bf16 in shared memory, one
// row per image row with the three channels interleaved as they lie in
// memory. In that layout the 21 values (7 taps x 3 channels) that one conv
// pixel needs from one image row are contiguous, at element 6 * column, so
// the conv is an implicit GEMM with no im2col copy: M = the 9 x 33 conv
// pixels of the tile (one row and column of halo for the pool, recomputed:
// 1.16x), N = 64, K = 7 rows x 32 (21 taps, the other 11 weights zero).
// mma.sync m16n8k16 bf16 fragments are loaded straight from the window with
// 32-bit shared loads (every A row may start at any even element); the
// weights sit transposed in shared memory for the whole block. The conv
// tile goes through bias, ReLU and rounding into shared memory, and the
// pool reads it from there, two channels per thread, 128-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCo = 64;                  // output channels
constexpr int kTP = 4;                   // pooled rows per tile
constexpr int kTQ = 16;                  // pooled columns per tile
constexpr int kCR = 2 * kTP + 1;         // conv rows per tile
constexpr int kCC = 2 * kTQ + 1;         // conv columns per tile
constexpr int kM = kCR * kCC;            // conv pixels per tile
constexpr int kMT = (kM + 15) / 16;      // m-tiles of 16 conv pixels
constexpr int kIR = 2 * kCR + 5;         // input rows per tile
constexpr int kIE = (2 * kCC + 5) * 3;   // input elements per row that are read from the image
constexpr int kKRow = 32;                // k per image row: 21 taps, 11 zero weights
constexpr int kK = 7 * kKRow;
constexpr int kLdi = 232;                // window row stride; >= 6 * (kCC - 1) + kKRow
constexpr int kLdw = kK + 8;             // weight row stride: 116 words, conflict-free B loads
constexpr int kLdc = kCo + 8;            // conv tile row stride: 36 words
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

constexpr int kInBytes = kIR * kLdi * 2;
constexpr int kWBytes = kCo * kLdw * 2;
constexpr int kConvBytes = kM * kLdc * 2;
constexpr int kSmemBytes = kInBytes + kWBytes + kConvBytes + kCo * 4;

static_assert(kLdi >= 6 * (kCC - 1) + kKRow, "the zero-weight taps must stay inside the row");
static_assert(kLdi >= kIE && kLdi % 2 == 0, "window rows hold the image row");
static_assert(kInBytes % 16 == 0 && kWBytes % 16 == 0 && kConvBytes % 16 == 0, "alignment");
static_assert(kSmemBytes <= 113 * 1024, "two blocks per SM");

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads, 2)
stem_kernel(const float* __restrict__ img,            // [N, H, W, 3]
            const __nv_bfloat16* __restrict__ wk,     // [64, kK]
            const float* __restrict__ bias,           // [64]
            __nv_bfloat16* __restrict__ out,          // [N, H/4, W/4, 64]
            float mean0, float mean1, float mean2, int N, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* in_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem + kInBytes);
  __nv_bfloat16* conv_s = reinterpret_cast<__nv_bfloat16*>(smem + kInBytes + kWBytes);
  float* bias_s = reinterpret_cast<float*>(smem + kInBytes + kWBytes + kConvBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;     // fragment row within 8
  const int tig = lane & 3;    // thread in group: column pair
  const int Hc = H / 2, Wc = W / 2, Hp = H / 4, Wp = W / 4;
  const int tiles_x = (Wp + kTQ - 1) / kTQ;
  const int tiles_y = (Hp + kTP - 1) / kTP;
  const int total = N * tiles_y * tiles_x;

  const __nv_bfloat16 mean_b0 = __float2bfloat16_rn(mean0);
  const __nv_bfloat16 mean_b1 = __float2bfloat16_rn(mean1);
  const __nv_bfloat16 mean_b2 = __float2bfloat16_rn(mean2);
  const __nv_bfloat16 zero_b = __float2bfloat16_rn(0.0f);
  const __nv_bfloat16 ninf_b = __float2bfloat16_rn(-INFINITY);

  for (int q = tid; q < kCo * (kK / 8); q += kThreads) {
    const int row = q / (kK / 8);
    const int col = (q % (kK / 8)) * 8;
    *reinterpret_cast<uint4*>(w_s + row * kLdw + col) =
        *reinterpret_cast<const uint4*>(wk + row * kK + col);
  }
  if (tid < kCo) bias_s[tid] = bias[tid];

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int n = tile / (tiles_y * tiles_x);
    const int py0 = (tile / tiles_x) % tiles_y * kTP;
    const int px0 = (tile % tiles_x) * kTQ;
    const int cy0 = 2 * py0 - 1;          // first conv row and column of the tile
    const int cx0 = 2 * px0 - 1;
    const int iy0 = 2 * cy0 - 3;          // first image row and column of the window
    const int ix0 = 2 * cx0 - 3;

    // Image window -> bf16 in shared memory; outside the image the raw mean.
    for (int q = tid; q < kIR * kLdi; q += kThreads) {
      const int row = q / kLdi;
      const int e = q % kLdi;
      __nv_bfloat16 v = zero_b;            // columns past the window: finite, times zero weights
      if (e < kIE) {
        const int px = e / 3;
        const int ch = e - 3 * px;
        const int iy = iy0 + row;
        const int ix = ix0 + px;
        v = ch == 0 ? mean_b0 : (ch == 1 ? mean_b1 : mean_b2);
        if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
          v = __float2bfloat16_rn(img[(((int64_t)n * H + iy) * W + ix) * 3 + ch]);
        }
      }
      in_s[q] = v;
    }
    __syncthreads();   // window and (first tile) weights ready; previous pool done

    // Implicit GEMM: conv pixel m = r * kCC + c reads window row 2r + dy from
    // element 6c on, k = 0 .. 31 (dx * 3 + cin for k < 21).
    for (int mt = warp; mt < kMT; mt += kWarps) {
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
      }
      const int m_lo = min(mt * 16 + g, kM - 1);
      const int m_hi = min(mt * 16 + g + 8, kM - 1);
      const __nv_bfloat16* a_lo = in_s + 2 * (m_lo / kCC) * kLdi + 6 * (m_lo % kCC) + 2 * tig;
      const __nv_bfloat16* a_hi = in_s + 2 * (m_hi / kCC) * kLdi + 6 * (m_hi % kCC) + 2 * tig;
      const __nv_bfloat16* b_base = w_s + g * kLdw + 2 * tig;
#pragma unroll 1
      for (int dy = 0; dy < 7; ++dy) {
#pragma unroll
        for (int kk = 0; kk < kKRow; kk += 16) {
          uint32_t a[4];
          a[0] = lds32(a_lo + dy * kLdi + kk);
          a[1] = lds32(a_hi + dy * kLdi + kk);
          a[2] = lds32(a_lo + dy * kLdi + kk + 8);
          a[3] = lds32(a_hi + dy * kLdi + kk + 8);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const __nv_bfloat16* bp = b_base + nt * 8 * kLdw + dy * kKRow + kk;
            mma_bf16(acc[nt], a, lds32(bp), lds32(bp + 8));
          }
        }
      }
      // Round once, add the bias in f32, ReLU, round; positions outside the
      // conv map get -inf so that they never win the pool.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + g + 8 * h;
        if (m >= kM) continue;
        const int cy = cy0 + m / kCC;
        const int cx = cx0 + m % kCC;
        const bool inside = cy >= 0 && cy < Hc && cx >= 0 && cx < Wc;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int ch = nt * 8 + 2 * tig;
          __nv_bfloat162 v;
          const float c0 = __bfloat162float(__float2bfloat16_rn(acc[nt][2 * h]));
          const float c1 = __bfloat162float(__float2bfloat16_rn(acc[nt][2 * h + 1]));
          v.x = inside ? __float2bfloat16_rn(fmaxf(c0 + bias_s[ch], 0.0f)) : ninf_b;
          v.y = inside ? __float2bfloat16_rn(fmaxf(c1 + bias_s[ch + 1], 0.0f)) : ninf_b;
          *reinterpret_cast<__nv_bfloat162*>(conv_s + m * kLdc + ch) = v;
        }
      }
    }
    __syncthreads();   // conv tile complete

    // 3x3 stride-2 max: pooled (p, q) reads conv rows 2p .. 2p + 2 and
    // columns 2q .. 2q + 2 of the tile. Two channels per thread.
    for (int i = tid; i < kTP * kTQ * (kCo / 2); i += kThreads) {
      const int cp = i % (kCo / 2);
      const int q = (i / (kCo / 2)) % kTQ;
      const int p = i / (kCo / 2 * kTQ);
      const int py = py0 + p;
      const int px = px0 + q;
      if (py >= Hp || px >= Wp) continue;
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
              conv_s + ((2 * p + dr) * kCC + 2 * q + dc) * kLdc + 2 * cp);
          m0 = fmaxf(m0, __bfloat162float(v.x));
          m1 = fmaxf(m1, __bfloat162float(v.y));
        }
      }
      __nv_bfloat162 o;
      o.x = __float2bfloat16_rn(m0);
      o.y = __float2bfloat16_rn(m1);
      *reinterpret_cast<__nv_bfloat162*>(
          out + (((int64_t)n * Hp + py) * Wp + px) * kCo + 2 * cp) = o;
    }
    // The next tile's window is written before its first barrier; the
    // pool above reads only the conv tile, which is written after it.
  }
}

}  // namespace

// img [N, H, W, 3] f32 raw in [0, 1]; wk [64, 224] bf16 folded weights,
// column = dy * 32 + dx * 3 + cin, other columns zero; bias [64] f32; out
// [N, H/4, W/4, 64] bf16; mean: the per-channel raw mean (rounded to bf16
// here). H and W are multiples of 4.
extern "C" int stem_bf16(const float* img, const void* wk, const float* bias, void* out,
                         float mean0, float mean1, float mean2, int N, int H, int W,
                         void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || H % 4 || W % 4) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)N * ((H / 4 + kTP - 1) / kTP) * ((W / 4 + kTQ - 1) / kTQ);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < 2LL * sms ? tiles : 2LL * sms);
  stem_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      img, reinterpret_cast<const __nv_bfloat16*>(wk), bias,
      reinterpret_cast<__nv_bfloat16*>(out), mean0, mean1, mean2, N, H, W);
  return (int)cudaGetLastError();
}
