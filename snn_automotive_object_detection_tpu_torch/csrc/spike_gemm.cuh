// Spike-code GEMM for Hopper, shared by the box head's kernels
// encoder_fc6.cu (K3: the encoder's spikes times w6), box_tail.cu (K4:
// LIF6's spikes times w7, LIF7's times the cls|bbox readout) and
// box_head_fused.cu (K9: all three, with f32 epilogues):
//
//   C[(t, r), n] = sum_k z_t[r, k] W[k, n]   for every step t < T,
//
// where z_t[r, k] in {0, 1} is bit t of a uint16 code per element,
// code[r, k], written once by the pass before (encoder periods, or a LIF
// scan). The spike tensor itself is never materialised.
//
// Tile. A block owns 16 RoI rows x all T steps (the GEMM rows) x kN output
// columns. Its GEMM rows are m64 tiles of 4 steps x 16 RoI rows: m-tile j
// holds steps 4j .. 4j + 3, and warp w of a warpgroup supplies step 4j + w.
// Consumer warpgroup g owns m-tiles g and g + 2, so up to 16 steps run on
// one pass over the weights; a step past T has no bits, and an m-tile past
// T is skipped (T = 12: three m-tiles, no padded rows; T = 10: the fourth
// and the last two steps of the third are zero rows).
//
// Operands. B (the weights as they are stored, [K, N]) streams through a
// ring of kStages slots, each a TMA stage of 64 k x kN in boxes of 64 x 64
// (128-byte swizzle: the MN-major layout wgmma reads with its transpose
// bit, so no weight is laid out anew) plus the block's 16 x 64 codes of
// the same k (128-byte swizzle too: the reads below are conflict-free). A
// producer warpgroup's one thread issues the stages, with full and empty
// mbarriers; two blocks on consecutive row tiles form a cluster and share
// each weight stage (each loads half of its rows and multicasts it into
// both), so a slot is refilled once the consumers of both blocks have
// released it. A is built in registers from the codes:
// the bf16 pair of two elements is ((code pair >> t) & 0x10001) * 0x3F80,
// three integer operations, then wgmma m64nNk16 with A from registers.
//
// The epilogue is a template parameter: store the f32 sums (K3); round
// them to bf16, stage them in shared memory and run the LIF (K4's fc7) or
// LI (K4's readout) scan over t per (row, column); or stage them as they
// are, in f32, and run the same scans (K9). The f32 staging of 16 rows x
// 16 steps x 128 columns (139 KB) does not fit beside an 8-stage ring (147
// KB), so it overlays the ring once every consumer has passed the last
// full barrier: by then every stage, the partner block's multicast shares
// included, has landed and been read, and nothing writes the ring again.
//
// Grid: x = row tiles (padded to whole clusters; a padded tile computes on
// zero codes and stores nothing), y = column tiles. Blocks start x-major,
// so the blocks in flight share one or two column slices of W, which stay
// in L2, and the codes are re-read once per slice.

#pragma once

#include "hopper.cuh"

namespace sgemm {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kRows = 16;        // RoI rows per block
constexpr int kMaxT = 16;        // steps, bits of a code
constexpr int kK = 64;           // k per stage: 128-byte rows of bf16 weights and uint16 codes
constexpr int kThreads = 384;    // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumers = 256;
constexpr int kCluster = 2;      // blocks (consecutive row tiles) sharing each weight stage
constexpr int kCodeBytes = kRows * kK * 2;

template <int kN, int kStages>
struct Ring {
  static constexpr int kWBytes = kN * kK * 2;
  static constexpr int kSlotBytes = kWBytes + kCodeBytes;
  static constexpr int kBytes = kStages * kSlotBytes;
  static constexpr int kChunkBytes = kK * 64 * 2;            // one 64 k x 64 n box
  static constexpr int kRankRows = kWBytes / 128 / kCluster;  // 128-byte rows each block loads
  static constexpr int kBoxRows = kRankRows < kK ? kRankRows : kK;   // rows of one TMA box
  static_assert(kN % 64 == 0 && kRankRows % kBoxRows == 0 && kBoxRows % 8 == 0,
                "each block's share of a stage is whole 1024-byte swizzle atoms");
};

// Where this consumer thread's accumulators lie: element i of m-tile j is
// step 4 (wg + 2 j) + warp, RoI row row0 + g + 8 ((i / 2) % 2), column
// col0 + 8 (i / 4) + 2 t4 + i % 2.
struct Ctx {
  int row0, col0, R, T, wg, warp, g, t4;
  __device__ __forceinline__ int step(int j) const { return 4 * (wg + 2 * j) + warp; }
};

// lif_feed_forward_step (norse 0.0.7): decay v with the OLD i, decay i,
// spike on the decayed v, reset, THEN add the input current.
__device__ __forceinline__ float lif_step(float& v, float& i, float cur) {
  const float vd = v + 0.1f * ((0.0f - v) + i);
  const float id = i + (-0.2f) * i;
  const float z = ((vd - 0.1f) > 0.0f) ? 1.0f : 0.0f;
  v = (1.0f - z) * vd;
  i = id + cur;
  return z;
}

template <int kN>
__device__ __forceinline__ void wgmma_rs(float (&d)[kN / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (kN == 128) {
    wgmma_rs_n128_tb(d, a, desc_b);
  } else {
    static_assert(kN == 64, "spike GEMM widths: 128 or 64");
    wgmma_rs_n64_tb(d, a, desc_b);
  }
}

// The sums of this warpgroup's kMt m-tiles over all of K, stage by stage;
// with kMt = 0 the warpgroup only waits for each stage and releases it.
template <int kN, int kStages, int kMt>
__device__ __forceinline__ void mainloop(float (&acc)[2][kN / 2], unsigned char* ring,
                                         uint64_t* full, uint64_t* empty, int n_k,
                                         const Ctx& c, int lane) {
  using RingT = Ring<kN, kStages>;
  const int t0 = c.step(0), t1 = c.step(1);
  for (int s = 0; s < n_k; ++s) {
    const int slot = s % kStages;
    unsigned char* base = ring + slot * RingT::kSlotBytes;
    mbar_wait(&full[slot], (s / kStages) & 1);
    if constexpr (kMt > 0) {
      const unsigned char* code = base + RingT::kWBytes;
      uint32_t a[kMt][4][4];
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
        // Elements 16 kk + 2 t4 (+1) and 16 kk + 8 + 2 t4 (+1) of rows g and
        // g + 8: 16-byte chunks 2 kk and 2 kk + 1, swizzled by row % 8 = g.
        const int lo = (((2 * kk) ^ c.g) << 4) + 4 * c.t4;
        const int hi = (((2 * kk + 1) ^ c.g) << 4) + 4 * c.t4;
        const uint32_t pair[4] = {
            *reinterpret_cast<const uint32_t*>(code + c.g * 128 + lo),
            *reinterpret_cast<const uint32_t*>(code + (c.g + 8) * 128 + lo),
            *reinterpret_cast<const uint32_t*>(code + c.g * 128 + hi),
            *reinterpret_cast<const uint32_t*>(code + (c.g + 8) * 128 + hi)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[0][kk][i] = ((pair[i] >> t0) & 0x10001u) * 0x3F80u;
          if constexpr (kMt == 2) a[kMt - 1][kk][i] = ((pair[i] >> t1) & 0x10001u) * 0x3F80u;
        }
      }
      // k16 step kk: two 8-row atoms (2048 B) into each 64-wide N chunk.
      const uint64_t db = desc_mn_sw128(base, RingT::kChunkBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) wgmma_rs<kN>(acc[0], a[0][kk], db + kk * 128);
      if constexpr (kMt == 2) {
#pragma unroll
        for (int kk = 0; kk < kK / 16; ++kk) wgmma_rs<kN>(acc[1], a[kMt - 1][kk], db + kk * 128);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc[0]);
      if constexpr (kMt == 2) fence_regs(acc[1]);
    }
    if (lane == 0) {
      for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(&empty[slot], r);
    }
  }
}

template <int kN, int kStages, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
spike_gemm_kernel(const __grid_constant__ CUtensorMap map_w,     // W [K, N] bf16
                  const __grid_constant__ CUtensorMap map_code,  // codes [R, K] uint16
                  int R, int K, int T, const typename Epi::Params ep) {
  using RingT = Ring<kN, kStages>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* stage = Epi::kInRing ? ring : ring + RingT::kBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + RingT::kBytes + (Epi::kInRing ? 0 : Epi::kStageBytes));
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kN;
  const int n_k = K / kK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * kCluster);   // one arrival per consumer warp of the cluster
    }
    fence_barrier_init();
  }
  cluster_sync();

  if (wg == 2) {
    // ---- Producer: block r of the cluster loads the r-th share of each
    // stage's 128-byte rows (row q is k = q % 64 of N chunk q / 64; with
    // two blocks, kN = 128: the r-th chunk, kN = 64: half of the k) into
    // every block of the cluster, and its own codes into itself.
    reg_dealloc<40>();
    if (tid == kConsumers) {
      const int first = (int)cluster_rank() * RingT::kRankRows;
      const int code_row = row0 < R ? row0 : 0;   // a padded tile reads any codes
      for (int s = 0; s < n_k + kStages; ++s) {
        const int slot = s % kStages;
        mbar_wait(&empty[slot], ((s / kStages) & 1) ^ 1);
        if (s >= n_k) continue;   // the tail: every remote release has landed
        unsigned char* dst = ring + slot * RingT::kSlotBytes;
        mbar_expect_tx(&full[slot], RingT::kSlotBytes);
        for (int q = first; q < first + RingT::kRankRows; q += RingT::kBoxRows) {
          tma_load_2d_multicast(dst + q * 128, &map_w, &full[slot],
                                (uint16_t)((1 << kCluster) - 1), col0 + 64 * (q / kK),
                                s * kK + q % kK);
        }
        tma_load_2d(dst + RingT::kWBytes, &map_code, &full[slot], s * kK, code_row);
      }
    }
  } else {
    // ---- Consumers.
    reg_alloc<232>();
    const int lane = tid & 31;
    const Ctx c{row0, col0, R, T, wg, (tid >> 5) & 3, lane >> 2, lane & 3};
    const int n_mt = (T + 3) / 4;
    const int mine = (n_mt > wg ? 1 : 0) + (n_mt > wg + 2 ? 1 : 0);
    float acc[2][kN / 2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[j][i] = 0.0f;
    }
    if (mine == 2) {
      mainloop<kN, kStages, 2>(acc, ring, full, empty, n_k, c, lane);
    } else if (mine == 1) {
      mainloop<kN, kStages, 1>(acc, ring, full, empty, n_k, c, lane);
    } else {
      mainloop<kN, kStages, 0>(acc, ring, full, empty, n_k, c, lane);
    }
    Epi::template run<kN>(acc, mine, c, stage, ep);
  }
}

// Rounds this thread's sums of its m-tiles to bf16 into the staging plane
// [step][row][kLd], then synchronises the consumers.
template <int kN, int kLd>
__device__ __forceinline__ void stage_bf16(const float (&acc)[2][kN / 2], int mine,
                                           const Ctx& c, bf16* st) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = c.step(j);
    if (j < mine && t < c.T) {
#pragma unroll
      for (int q = 0; q < kN / 8; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162 o;
          o.x = __float2bfloat16_rn(acc[j][4 * q + 2 * h]);
          o.y = __float2bfloat16_rn(acc[j][4 * q + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              st + (t * kRows + c.g + 8 * h) * kLd + 8 * q + 2 * c.t4) = o;
        }
      }
    }
  }
  named_bar(1, kConsumers);
}

// K3: the f32 sums to out [T, R, n_total].
struct StoreF32 {
  struct Params {
    float* out;
    int n_total;
  };
  static constexpr int kStageBytes = 0;
  static constexpr bool kInRing = false;

  template <int kN>
  static __device__ __forceinline__ void run(const float (&acc)[2][kN / 2], int mine,
                                             const Ctx& c, unsigned char*, const Params& p) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = c.step(j);
      if (j < mine && t < c.T) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = c.row0 + c.g + 8 * h;
          if (row < c.R) {
            float* o = p.out + ((int64_t)t * c.R + row) * p.n_total + c.col0 + 2 * c.t4;
#pragma unroll
            for (int q = 0; q < kN / 8; ++q) {
              *reinterpret_cast<float2*>(o + 8 * q) =
                  make_float2(acc[j][4 * q + 2 * h], acc[j][4 * q + 2 * h + 1]);
            }
          }
        }
      }
    }
  }
};

// K4's fc7: LIF7 on bf16(s6 @ w7) over the steps; emits the spike codes
// [R, n_total] uint16 and adds the spikes per row to counts[2 r + 1].
struct LifCodes {
  struct Params {
    uint16_t* code;
    int* counts;
    int n_total;
  };
  static constexpr int kLd = 128 + 8;   // staged row stride (bf16): conflict-free pair writes
  static constexpr int kStageBytes = kMaxT * kRows * kLd * 2;
  static constexpr bool kInRing = false;

  template <int kN>
  static __device__ __forceinline__ void run(const float (&acc)[2][kN / 2], int mine,
                                             const Ctx& c, unsigned char* stage,
                                             const Params& p) {
    static_assert(kN == 128, "16 threads x 8 columns per row");
    const bf16* st = reinterpret_cast<const bf16*>(stage);
    stage_bf16<kN, kLd>(acc, mine, c, reinterpret_cast<bf16*>(stage));
    // Thread tid runs columns 8 (tid % 16) .. + 7 of row tid / 16.
    const int tid = threadIdx.x;
    const int r = tid >> 4;
    const int c8 = (tid & 15) * 8;
    float v[8], i[8];
    uint32_t code[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = i[e] = 0.0f;
      code[e] = 0u;
    }
    int cnt = 0;
    for (int t = 0; t < c.T; ++t) {
      const uint4 raw = *reinterpret_cast<const uint4*>(st + (t * kRows + r) * kLd + c8);
      const bf16* cv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool z = lif_step(v[e], i[e], __bfloat162float(cv[e])) > 0.0f;
        code[e] |= (z ? 1u : 0u) << t;
        cnt += z ? 1 : 0;
      }
    }
    const int row = c.row0 + r;
    if (row < c.R) {
      uint4 o;
      o.x = code[0] | code[1] << 16;
      o.y = code[2] | code[3] << 16;
      o.z = code[4] | code[5] << 16;
      o.w = code[6] | code[7] << 16;
      *reinterpret_cast<uint4*>(p.code + (int64_t)row * p.n_total + c.col0 + c8) = o;
    }
    for (int off = 8; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    if ((tid & 15) == 0 && row < c.R && cnt != 0) atomicAdd(p.counts + 2 * row + 1, cnt);
  }
};

// K4's readout: the LI scan on bf16(s7 @ wro) of each column on its own;
// the final membranes to out [R, n_out].
struct LiOut {
  struct Params {
    float* out;
    int n_out;
  };
  static constexpr int kLd = 64 + 8;
  static constexpr int kStageBytes = kMaxT * kRows * kLd * 2;
  static constexpr bool kInRing = false;

  template <int kN>
  static __device__ __forceinline__ void run(const float (&acc)[2][kN / 2], int mine,
                                             const Ctx& c, unsigned char* stage,
                                             const Params& p) {
    static_assert(kN + 8 == kLd, "staged row stride");
    const bf16* st = reinterpret_cast<const bf16*>(stage);
    stage_bf16<kN, kLd>(acc, mine, c, reinterpret_cast<bf16*>(stage));
    for (int e = threadIdx.x; e < kRows * kN; e += kConsumers) {
      const int r = e / kN;
      const int col = c.col0 + e % kN;
      const int row = c.row0 + r;
      if (row >= c.R || col >= p.n_out) continue;
      float v = 0.0f, i = 0.0f;
      for (int t = 0; t < c.T; ++t) {
        const float cur = __bfloat162float(st[(t * kRows + r) * kLd + e % kN]);
        const float ij = i + cur;
        v = v + 0.1f * ((0.0f - v) + ij);
        i = ij + (-0.2f) * ij;
      }
      p.out[(int64_t)row * p.n_out + col] = v;
    }
  }
};

// Stores this thread's f32 sums of its m-tiles, unrounded, into the
// staging plane [step][row][kLd] (floats) that overlays the drained ring,
// then synchronises the consumers. kLd % 32 == 8 keeps the float2 writes
// of a half-warp on distinct banks.
template <int kN, int kLd>
__device__ __forceinline__ void stage_f32(const float (&acc)[2][kN / 2], int mine,
                                          const Ctx& c, float* st) {
  static_assert(kLd % 32 == 8, "conflict-free staging writes");
  named_bar(1, kConsumers);   // every consumer is past the last stage of the ring
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = c.step(j);
    if (j < mine && t < c.T) {
#pragma unroll
      for (int q = 0; q < kN / 8; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 s;
          s.x = acc[j][4 * q + 2 * h];
          s.y = acc[j][4 * q + 2 * h + 1];
          *reinterpret_cast<float2*>(st + (t * kRows + c.g + 8 * h) * kLd + 8 * q + 2 * c.t4) = s;
        }
      }
    }
  }
  named_bar(1, kConsumers);
}

// K9's fc6 and fc7: the LIF scan over t on the f32 sums as they are; emits
// the spike codes [R, n_total] uint16 and adds the spikes of each row to
// counts[2 r] (the caller offsets counts by the layer's column).
struct LifF32Codes {
  struct Params {
    uint16_t* code;
    int* counts;
    int n_total;
  };
  static constexpr int kLd = 128 + 8;
  static constexpr int kStageBytes = kMaxT * kRows * kLd * 4;
  static constexpr bool kInRing = true;

  template <int kN>
  static __device__ __forceinline__ void run(const float (&acc)[2][kN / 2], int mine,
                                             const Ctx& c, unsigned char* stage,
                                             const Params& p) {
    static_assert(kN == 128, "16 threads x 8 columns per row");
    const float* st = reinterpret_cast<const float*>(stage);
    stage_f32<kN, kLd>(acc, mine, c, reinterpret_cast<float*>(stage));
    // Thread tid runs columns c4 .. c4 + 3 and 64 + c4 .. 64 + c4 + 3 of row
    // tid / 16: a quarter-warp reads 128 contiguous bytes.
    const int tid = threadIdx.x;
    const int r = tid >> 4;
    const int c4 = (tid & 15) * 4;
    float v[8], i[8];
    uint32_t code[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = i[e] = 0.0f;
      code[e] = 0u;
    }
    int cnt = 0;
    for (int t = 0; t < c.T; ++t) {
      const float4 lo = *reinterpret_cast<const float4*>(st + (t * kRows + r) * kLd + c4);
      const float4 hi = *reinterpret_cast<const float4*>(st + (t * kRows + r) * kLd + 64 + c4);
      const float cur[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool z = lif_step(v[e], i[e], cur[e]) > 0.0f;
        code[e] |= (z ? 1u : 0u) << t;
        cnt += z ? 1 : 0;
      }
    }
    const int row = c.row0 + r;
    if (row < c.R) {
      uint16_t* o = p.code + (int64_t)row * p.n_total + c.col0 + c4;
      *reinterpret_cast<uint2*>(o) = make_uint2(code[0] | code[1] << 16, code[2] | code[3] << 16);
      *reinterpret_cast<uint2*>(o + 64) =
          make_uint2(code[4] | code[5] << 16, code[6] | code[7] << 16);
    }
    for (int off = 8; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    if ((tid & 15) == 0 && row < c.R && cnt != 0) atomicAdd(p.counts + 2 * row, cnt);
  }
};

// K9's readout: the LI scan on the f32 sums of each column as they are;
// the final membranes to out [R, n_out].
struct LiOutF32 {
  struct Params {
    float* out;
    int n_out;
  };
  static constexpr int kLd = 64 + 8;
  static constexpr int kStageBytes = kMaxT * kRows * kLd * 4;
  static constexpr bool kInRing = true;

  template <int kN>
  static __device__ __forceinline__ void run(const float (&acc)[2][kN / 2], int mine,
                                             const Ctx& c, unsigned char* stage,
                                             const Params& p) {
    static_assert(kN + 8 == kLd, "staged row stride");
    const float* st = reinterpret_cast<const float*>(stage);
    stage_f32<kN, kLd>(acc, mine, c, reinterpret_cast<float*>(stage));
    for (int e = threadIdx.x; e < kRows * kN; e += kConsumers) {
      const int r = e / kN;
      const int col = c.col0 + e % kN;
      const int row = c.row0 + r;
      if (row >= c.R || col >= p.n_out) continue;
      float v = 0.0f, i = 0.0f;
      for (int t = 0; t < c.T; ++t) {
        const float ij = i + st[(t * kRows + r) * kLd + e % kN];
        v = v + 0.1f * ((0.0f - v) + ij);
        i = ij + (-0.2f) * ij;
      }
      p.out[(int64_t)row * p.n_out + col] = v;
    }
  }
};

}  // namespace sgemm

namespace sgemm_host {

// Shared memory of one block: the alignment slack, the ring, the epilogue's
// staging unless it lies in the drained ring, the full and empty barriers.
template <int kN, int kStages, class Epi>
constexpr int smem_bytes() {
  using namespace sgemm;
  static_assert(!Epi::kInRing || Epi::kStageBytes <= Ring<kN, kStages>::kBytes,
                "the staging fits in the drained ring");
  constexpr int kExtra = Epi::kInRing ? 0 : Epi::kStageBytes;
  constexpr int kBytes = 1024 + Ring<kN, kStages>::kBytes + kExtra + 2 * kStages * 8;
  static_assert(kBytes <= 232448, "shared memory of one block");
  return kBytes;
}

// C = spike codes [R, K] (uint16) x W [K, n_total] bf16, through the
// epilogue Epi. Requires K % 64 == 0, n_total % 8 == 0 (16-byte rows for
// TMA) and T <= 16; columns past n_total read zero weights.
template <int kN, int kStages, class Epi>
int launch(const void* w, int n_total, const void* codes, int R, int K, int T,
           const typename Epi::Params& ep, cudaStream_t stream) {
  using namespace sgemm;
  if (R <= 0 || K <= 0 || K % kK != 0 || T < 1 || T > kMaxT || n_total <= 0 ||
      n_total % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map_w, map_code;
  const uint64_t wd[2] = {(uint64_t)n_total, (uint64_t)K};
  const uint32_t wb[2] = {64, (uint32_t)Ring<kN, kStages>::kBoxRows};
  const uint64_t cd[2] = {(uint64_t)K, (uint64_t)R};
  const uint32_t cbox[2] = {kK, kRows};
  if (!hopper_host::bf16_map(&map_w, w, 2, wd, wb, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper_host::map_tiled(&map_code, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, codes, 2, cd, cbox,
                              CU_TENSOR_MAP_SWIZZLE_128B)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = spike_gemm_kernel<kN, kStages, Epi>;
  constexpr int smem = smem_bytes<kN, kStages, Epi>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (R + kRows - 1) / kRows;
  const dim3 grid((tiles + kCluster - 1) / kCluster * kCluster, (n_total + kN - 1) / kN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  err = hopper_host::launch_clusters(kernel, grid, dim3(kCluster, 1, 1), kThreads, smem, stream,
                                     map_w, map_code, R, K, T, ep);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace sgemm_host
