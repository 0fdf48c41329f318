// One FPN level for Hopper (bf16 maps): lateral 1x1 + bias + 2x nearest
// upsample of the coarser merged map, then the 3x3 output conv + bias.
//
// Replaces the TPU kernel ops/pallas_fpn.py (_fpn_level_kernel, launched by
// fpn_level_pallas). Per pixel and channel, in the reference's rounding
// order (every bf16() is a round-to-nearest of an f32 value):
//   lat    = bf16( sum over Cin of x * wlat )                     (f32 sum)
//   merged = bf16( bf16(lat + blat) + up[y / 2, x / 2] )          (no "+ up" on the top level)
//   merged = 0 outside the image (the 3x3 conv zero-pads; b_lat must not leak)
//   P      = bf16( bf16( sum over 9 taps x 256 of merged * w9 ) + bout )
//
// What bounds it on this card: operations. 36 GFLOP of lateral and 231
// GFLOP of 3x3 products per image pair against about 290 MB of compulsory
// traffic, so both products run on the tensor cores and the merged map of a
// tile stays in shared memory between them.
//
// Design: a block owns a tile of 8 x 16 output pixels and all 256 channels.
// Phase 1 computes the merged map on the tile plus a one-pixel halo (10 x
// 18 = 180 pixels: the lateral product is recomputed 1.41x) as a [180, Cin]
// x [Cin, 256] product in two passes of 96 rows, so that the f32
// accumulators stay in registers; x rows (gathered per halo pixel, clamped
// at the image edge and masked afterwards) and wlat rows stream through a
// ring of four 32-deep stages in shared memory, filled by cp.async three
// stages ahead. The coarser merged map is prefetched into the halo buffer
// by cp.async, and the epilogue rounds, adds bias and upsample, masks and
// overwrites it in place. Phase 2 is the 3x3 conv as 9 taps x 256 deep
// straight from the halo buffer (each ldmatrix row address is a pixel, so
// a tap is a shifted base pointer) with the tap weights streaming through
// the same ring. Products are mma.sync m16n8k16 bf16 with f32 accumulators,
// fragments by ldmatrix. Both outputs leave through shared memory as
// 16-byte stores. Every block streams all of w9 (1.2 MB) and wlat from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 256;                    // FPN channels
constexpr int kTH = 8;                     // tile rows
constexpr int kTW = 16;                    // tile columns: one m-tile per row
constexpr int kHW = kTW + 2;               // halo width
constexpr int kHalo = (kTH + 2) * kHW;     // halo pixels
constexpr int kPassRows = 96;              // halo pixels per lateral pass: 6 m-tiles
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kKS = 32;                    // k depth of a stage
constexpr int kStages = 4;
constexpr int kLdh = kC + 8;               // halo pixel stride: 132 words, conflict-free ldmatrix
constexpr int kLdb = kC + 8;               // weight stage row stride
constexpr int kLda = kKS + 8;              // x stage row stride: 20 words, conflict-free ldmatrix

constexpr int kHaloBytes = kHalo * kLdh * 2;
constexpr int kStageBBytes = kKS * kLdb * 2;
constexpr int kStageABytes = kPassRows * kLda * 2;
constexpr int kStageBytes = kStageBBytes + kStageABytes;
constexpr int kSmemBytes = kHaloBytes + kStages * kStageBytes;

static_assert(2 * kPassRows >= kHalo, "two passes cover the halo");
static_assert(kHaloBytes % 16 == 0 && kStageBBytes % 16 == 0 && kStageBytes % 16 == 0,
              "cp.async and ldmatrix need 16 B");
static_assert(kKS * (kC / 8) % kThreads == 0, "whole 16-byte copies per thread");
static_assert(kPassRows * (kKS / 8) <= kThreads, "one x copy per thread");
static_assert(kTH * kTW * kLdh * 2 <= kStages * kStageBytes, "P staging reuses the ring");
static_assert(kSmemBytes <= 232448, "shared memory of one block");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_two() {  // all but the two newest groups
  asm volatile("cp.async.wait_group 2;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 32 rows x 256 columns of a row-major [*, 256] weight matrix into a stage.
__device__ __forceinline__ void load_weight_rows(__nv_bfloat16* sb, const __nv_bfloat16* w,
                                                 int row0, int tid) {
#pragma unroll
  for (int i = 0; i < kKS * (kC / 8) / kThreads; ++i) {
    const int q = tid + kThreads * i;
    const int row = q / (kC / 8);
    const int col = (q % (kC / 8)) * 8;
    cp_async16(sb + row * kLdb + col, w + (int64_t)(row0 + row) * kC + col);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fpn_level_kernel(const __nv_bfloat16* __restrict__ x,      // [N, H, W, Cin]
                 const __nv_bfloat16* __restrict__ up,     // [N, ceil(H/2), ceil(W/2), 256] or null
                 const __nv_bfloat16* __restrict__ wlat,   // [Cin, 256]
                 const __nv_bfloat16* __restrict__ blat,   // [256]
                 const __nv_bfloat16* __restrict__ w9,     // [9, 256, 256]
                 const __nv_bfloat16* __restrict__ bout,   // [256]
                 __nv_bfloat16* __restrict__ out_p,        // [N, H, W, 256]
                 __nv_bfloat16* __restrict__ out_m,        // [N, H, W, 256] or null
                 int H, int W, int Cin) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + kHaloBytes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int lrow = lane & 15;          // ldmatrix: the row this lane addresses
  const int lcol = (lane >> 4) * 8;    // ... and its 8-column half
  const int tx0 = blockIdx.x * kTW;
  const int ty0 = blockIdx.y * kTH;
  const int n = blockIdx.z;

  // The coarser merged map under the halo, 512 B per pixel, joins the first
  // cp.async group. Pixels outside the image are masked later, not read.
  if (up != nullptr) {
    const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
    for (int q = tid; q < kHalo * (kC / 8); q += kThreads) {
      const int m = q / (kC / 8);
      const int col = (q % (kC / 8)) * 8;
      const int y = ty0 - 1 + m / kHW;
      const int xx = tx0 - 1 + m % kHW;
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        cp_async16(halo + m * kLdh + col,
                   up + (((int64_t)n * H2 + (y >> 1)) * W2 + (xx >> 1)) * kC + col);
      }
    }
  }

  // ---- Phase 1: merged map on the halo, two passes of 96 halo pixels.
  {
    const int pm = warp & 1;           // m-tiles pm * 3 .. pm * 3 + 2 of the pass
    const int cn = warp >> 1;          // channels cn * 32 .. cn * 32 + 31
    const int n_stages = Cin / kKS;
    for (int pass = 0; pass < 2; ++pass) {
      // This thread's x copy: halo pixel pass * 96 + tid / 4, 16 B piece tid % 4.
      const __nv_bfloat16* a_src = nullptr;
      if (tid < kPassRows * (kKS / 8)) {
        const int m = min(pass * kPassRows + tid / (kKS / 8), kHalo - 1);
        const int y = min(max(ty0 - 1 + m / kHW, 0), H - 1);
        const int xx = min(max(tx0 - 1 + m % kHW, 0), W - 1);
        a_src = x + (((int64_t)n * H + y) * W + xx) * Cin + (tid % (kKS / 8)) * 8;
      }
      auto load_stage = [&](int s) {
        if (s >= n_stages) return;
        unsigned char* st = ring + (s % kStages) * kStageBytes;
        load_weight_rows(reinterpret_cast<__nv_bfloat16*>(st), wlat, s * kKS, tid);
        if (a_src != nullptr) {
          __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(st + kStageBBytes);
          cp_async16(sa + (tid / (kKS / 8)) * kLda + (tid % (kKS / 8)) * 8, a_src + s * kKS);
        }
      };

      float acc[3][4][4];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[i][nt][0] = acc[i][nt][1] = acc[i][nt][2] = acc[i][nt][3] = 0.0f;
        }
      }
      for (int s = 0; s < kStages - 1; ++s) {
        load_stage(s);
        cp_async_commit();
      }
      for (int s = 0; s < n_stages; ++s) {
        cp_async_wait_two();   // stage s has landed (this thread's copies)
        __syncthreads();       // ... everyone's; stage s - 1 is consumed
        load_stage(s + kStages - 1);
        cp_async_commit();     // possibly empty: keeps the group count uniform
        const unsigned char* st = ring + (s % kStages) * kStageBytes;
        const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(st);
        const __nv_bfloat16* sa = reinterpret_cast<const __nv_bfloat16*>(st + kStageBBytes);
#pragma unroll
        for (int kk = 0; kk < kKS; kk += 16) {
          uint32_t a[3][4];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            ldsm_x4(a[i], sa + ((pm * 3 + i) * 16 + lrow) * kLda + kk + lcol);
          }
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t b[4];
            ldsm_x4_trans(b, sb + (kk + lrow) * kLdb + cn * 32 + np * 16 + lcol);
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              mma_bf16(acc[i][2 * np], a[i], b[0], b[1]);
              mma_bf16(acc[i][2 * np + 1], a[i], b[2], b[3]);
            }
          }
        }
      }
      // Epilogue: the three roundings, the border mask, in place in the halo.
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = pass * kPassRows + (pm * 3 + i) * 16 + g + 8 * h;
          if (m >= kHalo) continue;
          const int y = ty0 - 1 + m / kHW;
          const int xx = tx0 - 1 + m % kHW;
          const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int ch = cn * 32 + nt * 8 + 2 * tig;
            __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(halo + m * kLdh + ch);
            float v0 = 0.0f, v1 = 0.0f;
            if (inside) {
              v0 = bf16_round(bf16_round(acc[i][nt][2 * h]) + __bfloat162float(blat[ch]));
              v1 = bf16_round(bf16_round(acc[i][nt][2 * h + 1]) + __bfloat162float(blat[ch + 1]));
              if (up != nullptr) {
                const __nv_bfloat162 u = *dst;
                v0 = bf16_round(v0 + __bfloat162float(u.x));
                v1 = bf16_round(v1 + __bfloat162float(u.y));
              }
            }
            __nv_bfloat162 o;
            o.x = __float2bfloat16_rn(v0);
            o.y = __float2bfloat16_rn(v1);
            *dst = o;
          }
        }
      }
      __syncthreads();   // the ring is free for the next prologue; halo rows visible
    }
  }

  // The merged map of the tile itself, 16-byte stores.
  if (out_m != nullptr) {
    for (int q = tid; q < kTH * kTW * (kC / 8); q += kThreads) {
      const int p = q / (kC / 8);
      const int col = (q % (kC / 8)) * 8;
      const int r = p / kTW, c = p % kTW;
      const int y = ty0 + r, xx = tx0 + c;
      if (y < H && xx < W) {
        *reinterpret_cast<uint4*>(out_m + (((int64_t)n * H + y) * W + xx) * kC + col) =
            *reinterpret_cast<const uint4*>(halo + ((r + 1) * kHW + c + 1) * kLdh + col);
      }
    }
  }

  // ---- Phase 2: 3x3 conv from the halo, tap weights through the ring.
  {
    const int pm = warp & 3;           // tile rows pm * 2, pm * 2 + 1 (one m-tile each)
    const int cn = warp >> 2;          // channels cn * 64 .. cn * 64 + 63
    constexpr int n_stages = 9 * kC / kKS;
    auto load_stage = [&](int s) {
      if (s >= n_stages) return;
      load_weight_rows(reinterpret_cast<__nv_bfloat16*>(ring + (s % kStages) * kStageBytes), w9,
                       s * kKS, tid);   // taps are contiguous: row s * 32 of [2304, 256]
    };
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[i][nt][0] = acc[i][nt][1] = acc[i][nt][2] = acc[i][nt][3] = 0.0f;
      }
    }
    for (int s = 0; s < kStages - 1; ++s) {
      load_stage(s);
      cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
      cp_async_wait_two();
      __syncthreads();
      load_stage(s + kStages - 1);
      cp_async_commit();
      const __nv_bfloat16* sb =
          reinterpret_cast<const __nv_bfloat16*>(ring + (s % kStages) * kStageBytes);
      const int tap = s / (kC / kKS);
      const int dy = tap / 3, dx = tap % 3;           // 0 .. 2: halo offsets
      const int k0 = (s % (kC / kKS)) * kKS;
      // Output pixel (r, c) and tap (dy, dx) read halo pixel (r + dy, c + dx).
      const __nv_bfloat16* a_base = halo + ((pm * 2 + dy) * kHW + dx + lrow) * kLdh + k0 + lcol;
#pragma unroll
      for (int kk = 0; kk < kKS; kk += 16) {
        uint32_t a[2][4];
        ldsm_x4(a[0], a_base + kk);
        ldsm_x4(a[1], a_base + kHW * kLdh + kk);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, sb + (kk + lrow) * kLdb + cn * 64 + np * 16 + lcol);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i][2 * np], a[i], b[0], b[1]);
            mma_bf16(acc[i][2 * np + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();   // every warp is done with the ring: it now stages P
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(ring);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (pm * 2 + i) * kTW + g + 8 * h;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int ch = cn * 64 + nt * 8 + 2 * tig;
          __nv_bfloat162 o;
          o.x = __float2bfloat16_rn(bf16_round(acc[i][nt][2 * h]) + __bfloat162float(bout[ch]));
          o.y = __float2bfloat16_rn(bf16_round(acc[i][nt][2 * h + 1]) +
                                    __bfloat162float(bout[ch + 1]));
          *reinterpret_cast<__nv_bfloat162*>(stage + p * kLdh + ch) = o;
        }
      }
    }
    __syncthreads();
    for (int q = tid; q < kTH * kTW * (kC / 8); q += kThreads) {
      const int p = q / (kC / 8);
      const int col = (q % (kC / 8)) * 8;
      const int y = ty0 + p / kTW, xx = tx0 + p % kTW;
      if (y < H && xx < W) {
        *reinterpret_cast<uint4*>(out_p + (((int64_t)n * H + y) * W + xx) * kC + col) =
            *reinterpret_cast<const uint4*>(stage + p * kLdh + col);
      }
    }
  }
}

}  // namespace

// x [N, H, W, Cin] bf16 (Cin a multiple of 32); up [N, ceil(H/2), ceil(W/2),
// 256] bf16, the merged map of the level above, or null on the top level;
// wlat [Cin, 256], blat [256], w9 [9, 256, 256] (HWIO taps, dy-major), bout
// [256], all bf16; out_p [N, H, W, 256] bf16; out_m the merged map of this
// level, same shape, or null where no finer level needs it.
extern "C" int fpn_level_bf16(const void* x, const void* up, const void* wlat, const void* blat,
                              const void* w9, const void* bout, void* out_p, void* out_m, int N,
                              int H, int W, int Cin, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % kKS || N > 65535 ||
      (H + kTH - 1) / kTH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fpn_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, N);
  using bf = __nv_bfloat16;
  fpn_level_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      reinterpret_cast<const bf*>(x), reinterpret_cast<const bf*>(up),
      reinterpret_cast<const bf*>(wlat), reinterpret_cast<const bf*>(blat),
      reinterpret_cast<const bf*>(w9), reinterpret_cast<const bf*>(bout),
      reinterpret_cast<bf*>(out_p), reinterpret_cast<bf*>(out_m), H, W, Cin);
  return (int)cudaGetLastError();
}
