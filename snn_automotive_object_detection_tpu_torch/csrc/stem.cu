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
// 151 MB conv map never exists in device memory. What held the first
// design back was latency: each tile's window came in by scalar loads
// between two block barriers, with nothing else in flight.
//
// Design: a persistent grid, one block of three warpgroups per SM, walks
// over tiles of 8 x 16 pooled pixels (17 x 33 conv pixels, one row and
// column of halo for the pool, recomputed: 1.09x; a 39 x 71-pixel image
// window, read 1.35x). Each tile's f32 window arrives by TMA (a 3-D tensor map over the
// image as [N, H, 3 W] floats, the box 39 rows x 220 floats; out-of-image
// rows and columns arrive as zeros) in a ring of two stages, each with a
// full mbarrier: as soon as the block has converted a window, one thread
// asks for the window two tiles ahead into the stage just read, so it lands
// while this tile and the next are multiplied and pooled. (A producer warp
// of its own would make the block 13 warps, four of them on one SM
// sub-partition, which caps every thread at 128 registers: the products'
// accumulators then spill.) The warps convert the window to bf16 with the
// three channels interleaved as in memory, and write bf16(mean[c]) wherever
// the pixel lies outside the image, which they know from its coordinates.
// In that layout the 21 values (7 taps x 3 channels) that one conv pixel
// needs from one image row are contiguous, at element 6 * column, so the
// conv is an implicit GEMM with no im2col copy: M = the 561 conv pixels of
// the tile (9 m64 tiles, three per warpgroup), N = 64, K = 7 rows x 32 (21
// taps, the other 11 weights zero), on wgmma m64n64k16 with A from
// registers: each warp loads its 16 rows' A fragments straight from the
// window with 32-bit shared loads (every A row may start at any even
// element, which no shared-memory descriptor can express), and B is the
// folded weights, resident in shared memory for the whole block in the
// 128-byte-swizzled K-major layout. The conv tile goes through bias, ReLU
// and rounding into shared memory, and the pool reads it from there, 8
// channels (16 bytes) a thread, in 16-byte stores. The host-side setup (the
// SM count, the shared-memory attribute) runs once per process and device.

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kCo = 64;                  // output channels
constexpr int kTP = 8;                   // pooled rows per tile
constexpr int kTQ = 16;                  // pooled columns per tile
constexpr int kCR = 2 * kTP + 1;         // conv rows per tile
constexpr int kCC = 2 * kTQ + 1;         // conv columns per tile
constexpr int kM = kCR * kCC;            // conv pixels per tile
constexpr int kIR = 2 * kCR + 5;         // input rows per tile
constexpr int kIP = 2 * kCC + 5;         // input pixels per row of the window
constexpr int kGroups = (kIP + 3) / 4;   // 4-pixel groups per row (12 floats)
// Floats per window row that the TMA box brings: it starts one float early,
// at a 16-byte boundary (the box's first coordinate must be one), and ends
// past the last group's twelfth float.
constexpr int kIF = 12 * kGroups + 4;
constexpr int kKRow = 32;                // k per image row: 21 taps, 11 zero weights
constexpr int kK = 7 * kKRow;
constexpr int kLdi = 232;                // bf16 window row stride
constexpr int kLdc = kCo + 8;            // conv tile row stride: 36 words
constexpr int kWarps = 12;               // three warpgroups
constexpr int kThreads = 32 * kWarps;
constexpr int kWG = kWarps / 4;
constexpr int kM64 = (kM + 63) / 64;     // m64 tiles of conv pixels
constexpr int kJW = (kM64 + kWG - 1) / kWG;   // m64 tiles per warpgroup
constexpr int kStages = 2;

// The weights as wgmma's B: [64 out][224 k] bf16 in blocks of 64 k, each
// block 64 rows of 128 bytes with the 128-byte swizzle (16-byte chunk c of
// row n at chunk c ^ (n % 8)), K-major; the last block's k >= 224 zero.
constexpr int kWBlocks = (kK + 63) / 64;
constexpr int kWBlock = kCo * 128;

constexpr int kBoxBytes = kIR * kIF * 4;
constexpr int kStageBytes = (kBoxBytes + 127) / 128 * 128;
constexpr int kWinBytes = kIR * kLdi * 2;
constexpr int kConvBytes = kM * kLdc * 2;
constexpr int kOffRing = kWBlocks * kWBlock;   // the weights first: 1024-byte aligned
constexpr int kOffWin = kOffRing + kStages * kStageBytes;
constexpr int kOffConv = kOffWin + kWinBytes;
constexpr int kOffBias = kOffConv + kConvBytes;
constexpr int kOffBar = kOffBias + kCo * 4;
constexpr int kSmemBytes = kOffBar + kStages * 8;
constexpr int kSmemAlloc = kSmemBytes + 1024;      // the base is aligned to 1024 by hand
constexpr int kMaxDevices = 64;

static_assert(kWarps % 4 == 0, "whole warpgroups");
static_assert(kLdi >= 6 * (kCC - 1) + kKRow, "the zero-weight taps must stay inside the row");
static_assert(kLdi >= 12 * kGroups && kLdi % 4 == 0, "window rows hold the converted groups");
static_assert(kIF <= 256 && kIR <= 256 && (kIF * 4) % 16 == 0, "TMA box limits");
static_assert(kWinBytes % 16 == 0 && kConvBytes % 16 == 0, "alignment");
static_assert(kSmemAlloc <= 232448, "shared memory of one block");

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Tile {
  int n, py0, px0;
};

__device__ __forceinline__ Tile tile_at(int tile, int tiles_y, int tiles_x) {
  Tile t;
  t.n = tile / (tiles_y * tiles_x);
  t.py0 = (tile / tiles_x) % tiles_y * kTP;
  t.px0 = (tile % tiles_x) * kTQ;
  return t;
}

__global__ void __launch_bounds__(kThreads, 1)
stem_kernel(const __grid_constant__ CUtensorMap map_img,   // img [N, H, 3 W] f32
            const bf16* __restrict__ wk,                    // [64, kK]
            const float* __restrict__ bias,                 // [64]
            bf16* __restrict__ out,                         // [N, H/4, W/4, 64]
            float mean0, float mean1, float mean2, int N, int H, int W) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* w_s = smem;
  const float* ring = reinterpret_cast<const float*>(smem + kOffRing);
  bf16* win = reinterpret_cast<bf16*>(smem + kOffWin);
  bf16* conv_s = reinterpret_cast<bf16*>(smem + kOffConv);
  float* bias_s = reinterpret_cast<float*>(smem + kOffBias);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int Hc = H / 2, Wc = W / 2, Hp = H / 4, Wp = W / 4;
  const int tiles_x = (Wp + kTQ - 1) / kTQ;
  const int tiles_y = (Hp + kTP - 1) / kTP;
  const int total = N * tiles_y * tiles_x;

  const int g = lane >> 2;     // fragment row within 8
  const int tig = lane & 3;    // thread in group: column pair
  const bf16 mean_b[3] = {__float2bfloat16_rn(mean0), __float2bfloat16_rn(mean1),
                          __float2bfloat16_rn(mean2)};
  const bf16 ninf_b = __float2bfloat16_rn(-INFINITY);
  const __nv_bfloat162 ninf2 = __halves2bfloat162(ninf_b, ninf_b);

  // The ring: thread 0 loads the window of the block's s-th tile into
  // stage s % kStages, completing on full[s % kStages].
  auto load_window = [&](int s) {
    const int tile = blockIdx.x + s * gridDim.x;
    if (tile >= total) return;
    const Tile t = tile_at(tile, tiles_y, tiles_x);
    const int slot = s % kStages;
    mbar_expect_tx(&full[slot], kBoxBytes);
    tma_load_3d(smem + kOffRing + slot * kStageBytes, &map_img, &full[slot],
                3 * (4 * t.px0 - 5) - 1, 4 * t.py0 - 5, t.n);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    for (int s = 0; s < kStages; ++s) load_window(s);
  }

  for (int q = tid; q < kWBlocks * kCo * 8; q += kThreads) {
    const int blk = q / (kCo * 8);
    const int n = (q / 8) % kCo;
    const int c = q % 8;
    const int k0 = blk * 64 + c * 8;
    *reinterpret_cast<uint4*>(w_s + blk * kWBlock + n * 128 + ((c ^ (n & 7)) * 16)) =
        k0 < kK ? *reinterpret_cast<const uint4*>(wk + n * kK + k0) : make_uint4(0, 0, 0, 0);
  }
  if (tid < kCo) bias_s[tid] = bias[tid];
  // Window columns past the box: finite, read only against zero weights.
  constexpr int kPad = kLdi - 12 * kGroups;
  for (int q = tid; q < kIR * kPad; q += kThreads) {
    win[(q / kPad) * kLdi + 12 * kGroups + q % kPad] = __float2bfloat16_rn(0.0f);
  }
  fence_proxy_async();   // the weights are read by wgmma through descriptors
  __syncthreads();       // barriers initialised, weights and bias in place

  int s = 0;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++s) {
    const Tile t = tile_at(tile, tiles_y, tiles_x);
    const int cy0 = 2 * t.py0 - 1;       // first conv row and column of the tile
    const int cx0 = 2 * t.px0 - 1;
    const int iy0 = 2 * cy0 - 3;         // first image row and column of the window
    const int ix0 = 2 * cx0 - 3;
    const int slot = s % kStages;

    // Window -> bf16, the raw mean outside the image; then the stage is free.
    mbar_wait(&full[slot], (s / kStages) & 1);
    const float* st = ring + slot * (kStageBytes / 4);
    for (int q = tid; q < kIR * kGroups; q += kThreads) {
      const int row = q / kGroups;
      const int j = q % kGroups;
      const int iy = iy0 + row;
      const bool row_in = iy >= 0 && iy < H;
      // Float 0 of a stage row is the one before the window's first.
      const float* src = st + row * kIF + 12 * j;
      const float4 f0 = *reinterpret_cast<const float4*>(src);
      const float4 f1 = *reinterpret_cast<const float4*>(src + 4);
      const float4 f2 = *reinterpret_cast<const float4*>(src + 8);
      const float v[12] = {f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w, f2.x, f2.y, f2.z, f2.w,
                           src[12]};
      bf16 o[12];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int ix = ix0 + 4 * j + p;
        const bool in = row_in && ix >= 0 && ix < W;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          o[3 * p + ch] = in ? __float2bfloat16_rn(v[3 * p + ch]) : mean_b[ch];
        }
      }
      uint2* dst = reinterpret_cast<uint2*>(win + row * kLdi + 12 * j);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dst[k] = make_uint2(pack2(o[4 * k], o[4 * k + 1]), pack2(o[4 * k + 2], o[4 * k + 3]));
      }
    }
    __syncthreads();   // window ready, the stage read; the previous tile's pool is done
    if (tid == 0) load_window(s + kStages);

    // Implicit GEMM on wgmma: conv pixel m = r * kCC + c reads window row
    // 2r + dy from element 6c on, k = 0 .. 31 (dx * 3 + cin for k < 21).
    // Warpgroup G owns the m64 tiles G, G + 3, G + 6; its warp w supplies
    // rows 16w .. 16w + 15 of each as A fragments loaded straight from the
    // window (the m16n8k16 A layout), B is the weights' block in shared
    // memory.
    {
      const int wg = warp >> 2;
      const int wq = warp & 3;
      float acc[kJW][32];
      const bf16* a_lo[kJW];
      const bf16* a_hi[kJW];
      bool act[kJW];
#pragma unroll
      for (int j = 0; j < kJW; ++j) {
        const int J = wg + j * kWG;
        act[j] = (kM64 % kWG == 0) || J < kM64;
        const int m_lo = min(J * 64 + 16 * wq + g, kM - 1);
        const int m_hi = min(J * 64 + 16 * wq + g + 8, kM - 1);
        a_lo[j] = win + 2 * (m_lo / kCC) * kLdi + 6 * (m_lo % kCC) + 2 * tig;
        a_hi[j] = win + 2 * (m_hi / kCC) * kLdi + 6 * (m_hi % kCC) + 2 * tig;
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[j][e] = 0.0f;
      }
#pragma unroll 1
      for (int dy = 0; dy < 7; ++dy) {
        uint32_t a[2][kJW][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < kJW; ++j) {
            const int kk = dy * kLdi + 16 * h;
            a[h][j][0] = lds32(a_lo[j] + kk);
            a[h][j][1] = lds32(a_hi[j] + kk);
            a[h][j][2] = lds32(a_lo[j] + kk + 8);
            a[h][j][3] = lds32(a_hi[j] + kk + 8);
          }
        }
        // k = dy * 32 + 16 h: block dy / 2, 32-byte step (dy % 2) * 2 + h.
        const uint64_t db = desc_sw128(w_s + (dy / 2) * kWBlock) + (dy % 2) * 4;
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < kJW; ++j) {
            if (act[j]) wgmma_rs_n64(acc[j], a[h][j], db + h * 2);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int j = 0; j < kJW; ++j) fence_regs(acc[j]);
      }
      // Round once, add the bias in f32, ReLU, round; positions outside the
      // conv map get -inf so that they never win the pool. Element 4 nt +
      // 2 h + e of a tile's accumulator is row 16 w + g + 8 h, column
      // 8 nt + 2 tig + e.
#pragma unroll
      for (int j = 0; j < kJW; ++j) {
        const int J = wg + j * kWG;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = J * 64 + 16 * wq + g + 8 * h;
          if (!act[j] || m >= kM) continue;
          const int cy = cy0 + m / kCC;
          const int cx = cx0 + m % kCC;
          const bool inside = cy >= 0 && cy < Hc && cx >= 0 && cx < Wc;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int ch = nt * 8 + 2 * tig;
            const float2 b = *reinterpret_cast<const float2*>(bias_s + ch);
            const float2 c = __bfloat1622float2(__float22bfloat162_rn(
                make_float2(acc[j][4 * nt + 2 * h], acc[j][4 * nt + 2 * h + 1])));
            *reinterpret_cast<__nv_bfloat162*>(conv_s + m * kLdc + ch) =
                inside ? __float22bfloat162_rn(make_float2(fmaxf(c.x + b.x, 0.0f),
                                                           fmaxf(c.y + b.y, 0.0f)))
                       : ninf2;
          }
        }
      }
    }
    __syncthreads();   // conv tile complete; every warp is done with the window

    // 3x3 stride-2 max: pooled (p, q) reads conv rows 2p .. 2p + 2 and
    // columns 2q .. 2q + 2 of the tile. Eight channels per thread.
    for (int i = tid; i < kTP * kTQ * (kCo / 8); i += kThreads) {
      const int c8 = i % (kCo / 8);
      const int q = (i / (kCo / 8)) % kTQ;
      const int p = i / (kCo / 8 * kTQ);
      const int py = t.py0 + p;
      const int px = t.px0 + q;
      if (py >= Hp || px >= Wp) continue;
      __nv_bfloat162 m[4];
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              conv_s + ((2 * p + dr) * kCC + 2 * q + dc) * kLdc + 8 * c8);
          const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int k = 0; k < 4; ++k) m[k] = (dr == 0 && dc == 0) ? v[k] : __hmax2(m[k], v[k]);
        }
      }
      *reinterpret_cast<uint4*>(out + (((int64_t)t.n * Hp + py) * Wp + px) * kCo + 8 * c8) =
          make_uint4(bits2(m[0]), bits2(m[1]), bits2(m[2]), bits2(m[3]));
    }
    // The next tile's window is written before its first barrier; the
    // pool above reads only the conv tile, which is written after it.
  }
}

}  // namespace

// img [N, H, W, 3] f32 raw in [0, 1], 16-byte aligned; wk [64, 224] bf16
// folded weights, column = dy * 32 + dx * 3 + cin, other columns zero;
// bias [64] f32; out [N, H/4, W/4, 64] bf16; mean: the per-channel raw mean
// (rounded to bf16 here). H and W are multiples of 4.
extern "C" int stem_bf16(const float* img, const void* wk, const float* bias, void* out,
                         float mean0, float mean1, float mean2, int N, int H, int W,
                         void* stream) {
  static int sm_count[kMaxDevices] = {};
  if (N <= 0 || H <= 0 || W <= 0 || H % 4 || W % 4) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int sms = dev < kMaxDevices ? sm_count[dev] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemAlloc);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) sm_count[dev] = sms;
  }
  const long long tiles = (long long)N * ((H / 4 + kTP - 1) / kTP) * ((W / 4 + kTQ - 1) / kTQ);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const uint64_t dims[3] = {3 * (uint64_t)W, (uint64_t)H, (uint64_t)N};
  const uint32_t box[3] = {(uint32_t)kIF, (uint32_t)kIR, 1};
  if (!hopper_host::map_tiled(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, img, 3, dims, box,
                              CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = (int)(tiles < sms ? tiles : sms);
  stem_kernel<<<grid, kThreads, kSmemAlloc, (cudaStream_t)stream>>>(
      map, reinterpret_cast<const bf16*>(wk), bias, reinterpret_cast<bf16*>(out), mean0, mean1,
      mean2, N, H, W);
  return (int)cudaGetLastError();
}
