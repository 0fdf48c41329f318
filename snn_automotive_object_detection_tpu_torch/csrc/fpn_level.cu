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
// traffic, so both products run on the tensor cores at Hopper's rate
// (wgmma), and the merged map of a tile stays in shared memory between
// them. Next come the weight bytes from L2: every tile needs all of w9
// (1.2 MB) and wlat (Cin x 512 B), 1.5 GB for C2 alone; measured on an
// H100 (PERF.md), streaming them takes more of the time than the products.
//
// Design: a block owns a tile of TH x 16 output pixels (TH = 8, or 4 on a
// level whose 8-row tiles would leave most SMs idle: the wrapper picks it
// from the level's shape) and all 256 channels. Three warpgroups: two
// consumers and one producer whose single thread issues every load as a
// TMA tile into a ring of four 32 KB stages with full and empty mbarriers;
// the producer gives its registers to the consumers (setmaxnreg), which
// hold up to 192 f32 accumulators each. Two blocks on consecutive tile
// rows form a cluster and share the weight stages: each loads half of a
// stage's output channels and multicasts it into both, so the L2 weight
// reads halve (0.76 GB for C2), and a slot is refilled only when the
// consumers of both blocks have released it.
//   Phase 1, the lateral product on the tile plus a one-pixel halo
//   ((TH + 2) x 18 pixels): per 32-deep stage a 4-D TMA box of x (the
//   halo's pixels in order, zeros outside the image) and 32 rows of
//   wlat^T, both with the 64-byte swizzle, as wgmma's A and B from shared
//   memory; consumer warpgroup g takes output channels 128 g .. + 127 of
//   every 64-pixel m-tile. The coarser merged map is prefetched into the
//   halo buffer by cp.async meanwhile; the epilogue rounds, adds bias and
//   upsample, masks the border and overwrites it in place.
//   Phase 2, the 3x3 conv as 36 stages of 64 input channels of one tap
//   (w9^T rows by TMA with the 128-byte swizzle). A comes from registers:
//   ldmatrix from the halo buffer, whose rows are pixels, so a tap is a
//   shifted base pointer; each consumer warp owns one 16-pixel tile row.
//   With TH = 8 warpgroup g takes tile rows 4g .. 4g + 3 and all 256
//   channels (m64n256k16), with TH = 4 all four rows and channels
//   128 g .. + 127 (m64n128k16).
// The halo buffer is unpadded, 512 B per pixel, with the 16-byte chunks of
// a pixel XOR-swizzled by the pixel's low three bits, so that ldmatrix and
// the epilogue's stores hit 32 distinct banks. P leaves through the ring
// (after the last stage) as 16-byte stores. A consumer releases a stage
// when its products have completed (wgmma.wait_group 0); the other
// warpgroup's products fill the tensor cores meanwhile.

#include "hopper.cuh"

using namespace hopper;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 256;                   // FPN channels
constexpr int kTW = 16;                   // tile columns: one 16-row m-fragment per tile row
constexpr int kHW = kTW + 2;              // halo width
constexpr int kLatK = 32;                 // lateral stage depth (64 B rows)
constexpr int kConvK = 64;                // conv stage depth (128 B rows)
constexpr int kConvStages = 9 * kC / kConvK;
constexpr int kStages = 4;
constexpr int kSlotBytes = 32768;
constexpr int kThreads = 384;             // consumer warpgroups 0 and 1, producer 2
constexpr int kLdo = kC + 8;              // P staging row stride (bf16)
constexpr int kWlatBox = kC * kLatK * 2;
constexpr int kCluster = 2;               // blocks (consecutive tile rows) sharing weight stages

template <int TH>
struct Geo {
  static constexpr int kHalo = (TH + 2) * kHW;               // 180 or 108 pixels
  static constexpr int kLatMT = (kHalo + 63) / 64;           // 64-pixel m-tiles: 3 or 2
  static constexpr int kPx = TH * kTW;
  static constexpr int kHaloBytes = (kHalo * kC * 2 + 1023) / 1024 * 1024;
  static constexpr int kABytes = kLatMT * 64 * kLatK * 2;    // x part of a lateral stage
  static constexpr int kXBox = kHalo * kLatK * 2;            // bytes the x box brings
  static constexpr int kConvN = TH == 8 ? 256 : 128;         // conv channels per warpgroup
  static constexpr int kSmem = 1024 + kHaloBytes + kStages * kSlotBytes + 2 * kStages * 8;
  static_assert(kABytes % 1024 == 0 && kABytes + kWlatBox <= kSlotBytes, "lateral stage");
  static_assert(kPx * kLdo * 2 <= kStages * kSlotBytes, "P staging reuses the ring");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// Byte offset of channel ch (a multiple of 8 for 16-byte access, of 2 for
// pairs) of halo pixel m in the swizzled halo buffer.
__device__ __forceinline__ int halo_off(int m, int ch) {
  return m * (kC * 2) + ((((ch >> 3) ^ (m & 7))) << 4) + (ch & 7) * 2;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

template <int TH>
__global__ void __launch_bounds__(kThreads, 1)
fpn_level_kernel(const __grid_constant__ CUtensorMap map_x,     // x [N, H, W, Cin]
                 const __grid_constant__ CUtensorMap map_wlat,  // wlat^T [256, Cin]
                 const __grid_constant__ CUtensorMap map_w9,    // w9^T [9 * 256, 256]
                 const bf16* __restrict__ up,     // [N, ceil(H/2), ceil(W/2), 256] or null
                 const bf16* __restrict__ blat,   // [256]
                 const bf16* __restrict__ bout,   // [256]
                 bf16* __restrict__ out_p,        // [N, H, W, 256]
                 bf16* __restrict__ out_m,        // [N, H, W, 256] or null
                 int H, int W, int Cin) {
  using G = Geo<TH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* halo = smem;
  unsigned char* ring = smem + G::kHaloBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kSlotBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tx0 = blockIdx.x * kTW;
  const int ty0 = blockIdx.y * TH;
  const int n = blockIdx.z;
  const int n_lat = Cin / kLatK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * kCluster);   // one arrival per consumer warp of the cluster
    }
    fence_barrier_init();
  }
  cluster_sync();

  if (wg == 2) {
    // ---- Producer: the lateral stages, then the 36 conv stages. The x box
    // is the block's own; of each weight stage block r of the cluster loads
    // output channels r * 256 / kCluster .. into every block of the cluster, so
    // a slot is refilled once all of them have released it.
    reg_dealloc<40>();
    if (tid == 256) {
      const int rank = (int)cluster_rank();
      const uint16_t all = (uint16_t)((1 << kCluster) - 1);
      const int n_stages = n_lat + kConvStages;
      for (int s = 0; s < n_stages + kStages; ++s) {
        const int slot = s % kStages;
        mbar_wait(&empty[slot], ((s / kStages) & 1) ^ 1);
        if (s >= n_stages) continue;    // the tail: every remote release has landed
        unsigned char* dst = ring + slot * kSlotBytes;
        if (s < n_lat) {
          mbar_expect_tx(&full[slot], G::kXBox + kWlatBox);
          tma_load_4d(dst, &map_x, &full[slot], s * kLatK, tx0 - 1, ty0 - 1, n);
          tma_load_2d_multicast(dst + G::kABytes + rank * (kWlatBox / kCluster),
                                &map_wlat, &full[slot], all, s * kLatK,
                                rank * (kC / kCluster));
        } else {
          const int c = s - n_lat;   // tap c / 4, input channels (c % 4) * 64 ..
          mbar_expect_tx(&full[slot], kSlotBytes);
          tma_load_2d_multicast(dst + rank * (kSlotBytes / kCluster), &map_w9, &full[slot],
                                all, (c % 4) * kConvK, (c / 4) * kC + rank * (kC / kCluster));
        }
      }
    }
  } else {
    // ---- Consumers.
    reg_alloc<232>();
    const int warp = (tid >> 5) & 3;   // warp within the warpgroup
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;

    // The coarser merged map under the halo, 512 B per pixel. Pixels
    // outside the image are masked later, not read.
    if (up != nullptr) {
      const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
      for (int q = tid; q < G::kHalo * (kC / 8); q += 256) {
        const int m = q / (kC / 8);
        const int ch = (q % (kC / 8)) * 8;
        const int y = ty0 - 1 + m / kHW;
        const int xx = tx0 - 1 + m % kHW;
        if (y >= 0 && y < H && xx >= 0 && xx < W) {
          cp_async16(halo + halo_off(m, ch),
                     up + (((int64_t)n * H2 + (y >> 1)) * W2 + (xx >> 1)) * kC + ch);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);

    // ---- Phase 1: the lateral product on the halo's m-tiles, channels
    // 128 wg .. + 127.
    {
      float acc[G::kLatMT][64];
#pragma unroll
      for (int mt = 0; mt < G::kLatMT; ++mt) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[mt][i] = 0.0f;
      }
      for (int s = 0; s < n_lat; ++s) {
        const int slot = s % kStages;
        mbar_wait(&full[slot], (s / kStages) & 1);
        const unsigned char* st = ring + slot * kSlotBytes;
        const uint64_t da = desc_sw64(st);
        const uint64_t db = desc_sw64(st + G::kABytes + wg * 128 * kLatK * 2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kLatK / 16; ++kk) {
#pragma unroll
          for (int mt = 0; mt < G::kLatMT; ++mt) {
            wgmma_ss_n128(acc[mt], da + mt * (64 * kLatK * 2 >> 4) + kk * 2, db + kk * 2);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int mt = 0; mt < G::kLatMT; ++mt) fence_regs(acc[mt]);
        if (lane == 0) {
          for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(&empty[slot], r);
        }
      }

      // Epilogue: the three roundings and the border mask, in place.
      asm volatile("cp.async.wait_group 0;\n" ::);
      named_bar(1, 256);   // every thread's prefetch of the coarser map has landed
#pragma unroll
      for (int mt = 0; mt < G::kLatMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 64 + warp * 16 + g + 8 * h;
          if (m >= G::kHalo) continue;
          const int y = ty0 - 1 + m / kHW;
          const int xx = tx0 - 1 + m % kHW;
          const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int ch = wg * 128 + j * 8 + 2 * t4;
            __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(halo + halo_off(m, ch));
            float v0 = 0.0f, v1 = 0.0f;
            if (inside) {
              v0 = bf16_round(bf16_round(acc[mt][4 * j + 2 * h]) + __bfloat162float(blat[ch]));
              v1 = bf16_round(bf16_round(acc[mt][4 * j + 2 * h + 1]) +
                              __bfloat162float(blat[ch + 1]));
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
      named_bar(1, 256);   // the merged halo is complete
    }

    // The merged map of the tile itself, 16-byte stores.
    if (out_m != nullptr) {
      for (int q = tid; q < G::kPx * (kC / 8); q += 256) {
        const int p = q / (kC / 8);
        const int ch = (q % (kC / 8)) * 8;
        const int r = p / kTW, c = p % kTW;
        const int y = ty0 + r, xx = tx0 + c;
        if (y < H && xx < W) {
          *reinterpret_cast<uint4*>(out_m + (((int64_t)n * H + y) * W + xx) * kC + ch) =
              *reinterpret_cast<const uint4*>(halo + halo_off((r + 1) * kHW + c + 1, ch));
        }
      }
    }

    // ---- Phase 2: the 3x3 conv, A from the halo through registers.
    {
      constexpr int kN = G::kConvN;
      const int pm = (TH == 8 ? 4 * wg : 0) + warp;   // this warp's tile row
      const int ch0 = TH == 8 ? 0 : 128 * wg;         // this warpgroup's first channel
      const int lrow = lane & 15;                     // ldmatrix: the pixel this lane addresses
      const int lcol = (lane >> 4) * 8;               // ... and its 8-channel half
      float acc[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[i] = 0.0f;
      for (int c = 0; c < kConvStages; ++c) {
        const int s = n_lat + c;
        const int slot = s % kStages;
        const int tap = c / 4;
        const int k0 = (c % 4) * kConvK;
        // Output pixel (pm, col) and tap (dy, dx) read halo pixel (pm + dy, col + dx).
        const int m = (pm + tap / 3) * kHW + tap % 3 + lrow;
        uint32_t a[kConvK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kConvK / 16; ++kk) {
          ldsm_x4(a[kk], halo + halo_off(m, k0 + kk * 16 + lcol));
        }
        mbar_wait(&full[slot], (s / kStages) & 1);
        const uint64_t db = desc_sw128(ring + slot * kSlotBytes + ch0 * kConvK * 2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kConvK / 16; ++kk) {
          if constexpr (kN == 256) {
            wgmma_rs_n256(acc, a[kk], db + kk * 2);
          } else {
            wgmma_rs_n128(acc, a[kk], db + kk * 2);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        if (lane == 0) {
          for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(&empty[slot], r);
        }
      }
      named_bar(1, 256);   // both warpgroups are done with the ring: it now stages P
      bf16* stage = reinterpret_cast<bf16*>(ring);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = pm * kTW + g + 8 * h;
          const int ch = ch0 + j * 8 + 2 * t4;
          __nv_bfloat162 o;
          o.x = __float2bfloat16_rn(bf16_round(acc[4 * j + 2 * h]) + __bfloat162float(bout[ch]));
          o.y = __float2bfloat16_rn(bf16_round(acc[4 * j + 2 * h + 1]) +
                                    __bfloat162float(bout[ch + 1]));
          *reinterpret_cast<__nv_bfloat162*>(stage + p * kLdo + ch) = o;
        }
      }
      named_bar(1, 256);
      for (int q = tid; q < G::kPx * (kC / 8); q += 256) {
        const int p = q / (kC / 8);
        const int ch = (q % (kC / 8)) * 8;
        const int y = ty0 + p / kTW, xx = tx0 + p % kTW;
        if (y < H && xx < W) {
          *reinterpret_cast<uint4*>(out_p + (((int64_t)n * H + y) * W + xx) * kC + ch) =
              *reinterpret_cast<const uint4*>(stage + p * kLdo + ch);
        }
      }
    }
  }
}

template <int TH>
int launch(const void* x, const void* up, const void* wlat_t, const void* blat, const void* w9_t,
           const void* bout, void* out_p, void* out_m, int N, int H, int W, int Cin,
           cudaStream_t stream) {
  using G = Geo<TH>;
  CUtensorMap mx, mwlat, mw9;
  const uint64_t dx[4] = {(uint64_t)Cin, (uint64_t)W, (uint64_t)H, (uint64_t)N};
  const uint32_t bx[4] = {kLatK, kHW, TH + 2, 1};
  const uint64_t dl[2] = {(uint64_t)Cin, (uint64_t)kC};
  const uint32_t bl[2] = {kLatK, kC / kCluster};
  const uint64_t d9[2] = {(uint64_t)kC, (uint64_t)9 * kC};
  const uint32_t b9[2] = {kConvK, kC / kCluster};
  if (!hopper_host::bf16_map(&mx, x, 4, dx, bx, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hopper_host::bf16_map(&mwlat, wlat_t, 2, dl, bl, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hopper_host::bf16_map(&mw9, w9_t, 2, d9, b9, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = fpn_level_kernel<TH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return (int)err;
  // Tile rows at or past H pad the grid to whole clusters; they store nothing.
  const int rows = (H + TH - 1) / TH;
  dim3 grid((W + kTW - 1) / kTW, (rows + kCluster - 1) / kCluster * kCluster, N);
  err = hopper_host::launch_clustered(
      kernel, grid, kThreads, G::kSmem, kCluster, stream, mx, mwlat, mw9,
      reinterpret_cast<const bf16*>(up), reinterpret_cast<const bf16*>(blat),
      reinterpret_cast<const bf16*>(bout), reinterpret_cast<bf16*>(out_p),
      reinterpret_cast<bf16*>(out_m), H, W, Cin);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, H, W, Cin] bf16 (Cin a multiple of 32); up [N, ceil(H/2), ceil(W/2),
// 256] bf16, the merged map of the level above, or null on the top level;
// wlat_t [256, Cin] (the lateral weights transposed), blat [256], w9_t
// [9, 256, 256] (per tap dy-major, [output channel, input channel]), bout
// [256], all bf16; out_p [N, H, W, 256] bf16; out_m the merged map of this
// level, same shape, or null where no finer level needs it; tile_rows 8 or
// 4, the output rows of a block's tile.
extern "C" int fpn_level_bf16(const void* x, const void* up, const void* wlat_t,
                              const void* blat, const void* w9_t, const void* bout, void* out_p,
                              void* out_m, int N, int H, int W, int Cin, int tile_rows,
                              void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % kLatK || N > 65535 ||
      (H + 3) / 4 + kCluster > 65535 || (tile_rows != 8 && tile_rows != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return tile_rows == 8 ? launch<8>(x, up, wlat_t, blat, w9_t, bout, out_p, out_m, N, H, W, Cin, s)
                        : launch<4>(x, up, wlat_t, blat, w9_t, bout, out_p, out_m, N, H, W, Cin, s);
}
