// Backward of the spiking RPN head for its weights, one FPN level, for
// Hopper (bf16 planes, f32 neuron states and stored membranes).
//
// Replaces the TPU kernel snn/pallas_rpn.py (_rpn_level_bwd_kernel,
// launched by _run_level_bwd as the custom VJP of the fused level). Given
// the level's features, the weights and the cotangent g of the readout:
//   phase 0  encoder periods by threshold count, as the forward kernel;
//   phase 1  replay of the forward (rpn_head.cu through
//            rpn_head_common.cuh, so the same spikes), keeping each step's
//            decayed membrane vd_t in f32 and ssum = sum_t a_t s_t;
//   phase 2  gw = bf16(g) @ wout^T, then for t = T-1 .. 0:
//              dc_t = bf16(lam)                 (lam before this step's update)
//              sp   = 1 / (100 |vd_t - 0.1| + 1)^2          (SuperSpike)
//              ds   = a_t gw - vd_t lv
//              dvd  = (1 - s_t) lv + ds sp
//              lv   = 0.9 dvd;  lam = 0.1 dvd + 0.8 lam
//   dw9[k]   = sum over t and pixels of z_t(shifted by tap k)^T @ dc_t
//   dwout    = ssum^T @ g                                   (g in f32)
// Pixels outside the image never spike and carry no cotangent.
//
// What bounds it on this card: two products of the forward conv's size
// (the replayed conv and the weight gradient, 2 x 9 x 256 x 256 operations
// per pixel and step each), so both run on the tensor cores. The TPU
// kernel's accumulators are output blocks revisited by a grid that runs in
// order; here blocks run side by side and 2.36 MB of f32 dw9 fits no block.
//
// Design: two kernels, and a result that is the same on every run.
//   * The sweep kernel has the forward kernel's shape (a block owns a
//     32-pixel row segment, all 256 channels and all T steps, LIF state in
//     accumulator-shaped register fragments). The replay writes each
//     thread's vd_t elements to a global scratch in the thread's own
//     layout (8 KB per pixel at T = 8: shared memory would hold 28 pixels),
//     coalesced, and reads them back in the reverse sweep, which is
//     elementwise and stays in the same registers. Each step's lam goes
//     through shared memory to global memory as a bf16 plane
//     dc [N, H, W, T, 256]; the period map (uint8) and ssum (f32) go out
//     once.
//   * The weight-gradient kernel computes dw9 as a split-K product: a block
//     owns one (tap, 128 input channels, 128 output channels) tile of dw9
//     and one contiguous range of 32-pixel chunks; per chunk and group of 4
//     steps it rebuilds the shifted encoder spikes from the period map
//     (K x M, used as a column-major A), streams the dc rows in with
//     cp.async (K x N), both double-buffered, and multiplies with WMMA bf16
//     16x16x16 (at flagship shapes the result is within 3e-6 of the largest
//     element of an f64 sum of the same planes). Partial tiles go to global memory; the block that arrives
//     last at a tile (a counter per tile) adds the partials in split order,
//     so the sum does not depend on which block that was. The same grid's
//     last blocks compute dwout from ssum and g the same way, in f32 on the
//     CUDA cores (it is 1/150 of the work).

#include "rpn_head_common.cuh"

using namespace rpn;

namespace {

static_assert(Acc::num_elements == 8, "scratch layout: 16 values per thread and step");
static_assert(2 * kTP * kC * 4 <= kRingBytes, "two staging planes reuse the weight ring");
static_assert((kTP * kC + kTP * kMaxOut) * 4 <= kZBytes, "spike sum and g tile reuse the halo");

__global__ void __launch_bounds__(kThreads, 1)
rpn_level_bwd_sweep_kernel(const __nv_bfloat16* __restrict__ feat,   // [N, H, W, C]
                           const __nv_bfloat16* __restrict__ w9,     // [9, C, C]
                           const __nv_bfloat16* __restrict__ wout,   // [C, n_out]
                           const float* __restrict__ consts,         // thr[T], li[T]
                           const float* __restrict__ g,              // [N, H, W, n_out]
                           float* __restrict__ vd_scr,               // [blocks, T, 16, 512]
                           uint8_t* __restrict__ per_out,            // [N, H, W, C]
                           __nv_bfloat16* __restrict__ dc_out,       // [N, H, W, T, C]
                           float* __restrict__ ssum_out,             // [N, H, W, C]
                           int H, int W, int T, int n_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * kTP;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  const int ph = warp >> 3;
  const int cg = warp & 7;
  const int64_t row_px = ((int64_t)n * H + y) * W;      // first pixel of the row
  const int64_t blk = ((int64_t)n * H + y) * gridDim.x + blockIdx.x;
  float* vd_blk = vd_scr + blk * T * (16 * kThreads) + tid;

  load_constants(sm, consts, T, tid);
  __syncthreads();
  build_period_map(sm, feat, n, y, x0, H, W, T, tid);
  __syncthreads();

  // The block's own periods, for the weight-gradient kernel.
  for (int q = tid; q < kTP * kC / kVec; q += kThreads) {
    const int px = q / (kC / kVec);
    const int ch = (q % (kC / kVec)) * kVec;
    if (x0 + px < W) {
      *reinterpret_cast<uint2*>(per_out + (row_px + x0 + px) * kC + ch) =
          *reinterpret_cast<const uint2*>(sm.per + (kHalo + px + 1) * kC + ch);
    }
  }

  Acc acc[2], v[2], cu[2], ss[2];
  for (int f = 0; f < 2; ++f) {
    wmma::fill_fragment(v[f], 0.0f);
    wmma::fill_fragment(cu[f], 0.0f);
    wmma::fill_fragment(ss[f], 0.0f);
  }

  // Phase 1: the forward kernel's loop, with vd_t kept.
  for (int t = 0; t < T; ++t) {
    prefetch_weights(sm, w9, tid);
    build_spikes(sm, t, x0, W, tid);
    conv_step(acc, sm, w9, tid, ph * 16, cg);

    const float lit = sm.li[t];
    float* vd_t = vd_blk + (int64_t)t * (16 * kThreads);
    for (int f = 0; f < 2; ++f) {
      for (int e = 0; e < 8; ++e) {
        float vd;
        lif_element(acc[f].x[e], lit, v[f].x[e], cu[f].x[e], ss[f].x[e], vd);
        vd_t[(f * 8 + e) * kThreads] = vd;
      }
    }
    __syncthreads();
  }

  // The spike sum goes out once, through the spike halo's memory.
  float* stage_z = reinterpret_cast<float*>(sm.z);
  float* gs = stage_z + kTP * kC;                       // [kTP][kMaxOut] bf16(g)
  float* stage = reinterpret_cast<float*>(sm.ring);     // two planes of [kTP][kC]
  const int frag_off = (ph * 16) * kC + cg * 32;
  for (int f = 0; f < 2; ++f) {
    wmma::store_matrix_sync(stage_z + frag_off + f * 16, ss[f], kC, wmma::mem_row_major);
  }
  for (int o = tid; o < kTP * n_out; o += kThreads) {
    const int px = o / n_out;
    const int j = o % n_out;
    const float gv = (x0 + px < W) ? g[(row_px + x0 + px) * n_out + j] : 0.0f;
    gs[px * kMaxOut + j] = __bfloat162float(__float2bfloat16_rn(gv));
  }
  __syncthreads();
  for (int o = tid; o < kTP * kC; o += kThreads) {
    const int gx = x0 + o / kC;
    if (gx < W) ssum_out[(row_px + gx) * kC + o % kC] = stage_z[o];
  }

  // Phase 2: gw = bf16(g) @ wout^T, into accumulator-shaped fragments.
  for (int o = tid; o < kTP * kC; o += kThreads) {
    const int px = o / kC;
    const int ch = o % kC;
    float sum = 0.0f;
    for (int j = 0; j < n_out; ++j) {
      sum = sum + gs[px * kMaxOut + j] * __bfloat162float(wout[ch * n_out + j]);
    }
    stage[o] = sum;
  }
  __syncthreads();
  Acc gw[2], lv[2], lam[2];
  for (int f = 0; f < 2; ++f) {
    wmma::load_matrix_sync(gw[f], stage + frag_off + f * 16, kC, wmma::mem_row_major);
    wmma::fill_fragment(lv[f], 0.0f);
    wmma::fill_fragment(lam[f], 0.0f);
  }
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // dc_t = bf16(lam) as it stands before this step's update. The two
    // staging planes alternate, so one barrier per step is enough.
    float* st = stage + (t & 1) * (kTP * kC);
    for (int f = 0; f < 2; ++f) {
      wmma::store_matrix_sync(st + frag_off + f * 16, lam[f], kC, wmma::mem_row_major);
    }
    __syncthreads();
    for (int q = tid; q < kTP * kC / kVec; q += kThreads) {
      const int px = q / (kC / kVec);
      const int ch = (q % (kC / kVec)) * kVec;
      if (x0 + px >= W) continue;
      const float4 lo = *reinterpret_cast<const float4*>(st + px * kC + ch);
      const float4 hi = *reinterpret_cast<const float4*>(st + px * kC + ch + 4);
      __align__(16) __nv_bfloat16 o8[kVec] = {
          __float2bfloat16_rn(lo.x), __float2bfloat16_rn(lo.y), __float2bfloat16_rn(lo.z),
          __float2bfloat16_rn(lo.w), __float2bfloat16_rn(hi.x), __float2bfloat16_rn(hi.y),
          __float2bfloat16_rn(hi.z), __float2bfloat16_rn(hi.w)};
      *reinterpret_cast<uint4*>(dc_out + ((row_px + x0 + px) * T + t) * kC + ch) =
          *reinterpret_cast<const uint4*>(o8);
    }

    const float lit = sm.li[t];
    const float* vd_t = vd_blk + (int64_t)t * (16 * kThreads);
    for (int f = 0; f < 2; ++f) {
      for (int e = 0; e < 8; ++e) {
        const float vd = vd_t[(f * 8 + e) * kThreads];
        const float u = vd - 0.1f;
        const float keep = (u > 0.0f) ? 0.0f : 1.0f;     // 1 - s_t
        const float d = 100.0f * fabsf(u) + 1.0f;
        const float sp = 1.0f / (d * d);
        const float ds = lit * gw[f].x[e] - vd * lv[f].x[e];
        const float dvd = keep * lv[f].x[e] + ds * sp;
        lv[f].x[e] = 0.9f * dvd;
        lam[f].x[e] = 0.1f * dvd + 0.8f * lam[f].x[e];
      }
    }
  }
}

// ---------------------------------------------------------------- weights

constexpr int kGThreads = 256;       // 8 warps: 4 along input channels x 2 along output
constexpr int kTile = 128;           // dw9 tile: 128 input x 128 output channels
constexpr int kTG = 4;               // steps per stage
constexpr int kKRows = kTG * kTP;    // K rows of a stage: (step, pixel)
constexpr int kLdg = kTile + 8;      // row stride: 272 B keeps fragment pointers 32 B aligned
constexpr int kTilesPerTap = (kC / kTile) * (kC / kTile);
constexpr int kDw9Tiles = 9 * kTilesPerTap;
constexpr int kGStage = kKRows * kLdg;                 // elements of one z or dc stage
constexpr int kGSmemBytes = 4 * kGStage * 2;
static_assert(kGSmemBytes <= 232448, "shared memory of one block");
static_assert(kTP * kMaxOut * 4 <= kGSmemBytes, "g tile of the dwout blocks");
static_assert(kGThreads == kC, "a dwout block has one thread per channel");
constexpr int kOutChunk = 64;        // readout columns a dwout thread sums at a time

using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;

// True in exactly one block per counter: the one that arrives last. The
// partial results written before the call are then visible to it.
__device__ __forceinline__ bool arrives_last(int* counter, int parties) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = (atomicAdd(counter, 1) == parties - 1) ? 1 : 0;
  __syncthreads();
  if (last) __threadfence();
  return last != 0;
}

__global__ void __launch_bounds__(kGThreads, 1)
rpn_level_bwd_wgrad_kernel(const uint8_t* __restrict__ per,          // [N, H, W, C]
                           const __nv_bfloat16* __restrict__ dc,     // [N, H, W, T, C]
                           const float* __restrict__ ssum,           // [N, H, W, C]
                           const float* __restrict__ g,              // [N, H, W, n_out]
                           float* __restrict__ part9,                // [S, 9, C, C]
                           float* __restrict__ part_out,             // [S_out, C, n_out]
                           int* __restrict__ counters,               // [kDw9Tiles + 1], zero
                           float* __restrict__ dw9,                  // [9, C, C]
                           float* __restrict__ dwout,                // [C, n_out]
                           int N, int H, int W, int T, int n_out, int S, int S_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned long long spk_mask[kMaxT];
  const int tid = threadIdx.x;
  const int xcs = (W + kTP - 1) / kTP;
  if (tid < T) spk_mask[tid] = step_mask(tid, T);
  __syncthreads();
  const int n_chunks = N * H * xcs;

  if ((int)blockIdx.x >= kDw9Tiles * S) {
    // dwout = ssum^T @ g over this block's chunks: thread = channel.
    const int so = blockIdx.x - kDw9Tiles * S;
    const int per_split = (n_chunks + S_out - 1) / S_out;
    const int c0 = so * per_split;
    const int c1 = min(n_chunks, c0 + per_split);
    float* gs = reinterpret_cast<float*>(smem);         // [kTP][n_out]
    // Readout columns in chunks of kOutChunk, so that a thread's sums stay
    // in registers; a further chunk walks the block's pixels again.
    for (int j0 = 0; j0 < n_out; j0 += kOutChunk) {
      const int nj = min(kOutChunk, n_out - j0);
      float acc[kOutChunk];
#pragma unroll
      for (int j = 0; j < kOutChunk; ++j) acc[j] = 0.0f;
      for (int c = c0; c < c1; ++c) {
        const int x0 = (c % xcs) * kTP;
        const int64_t px0 = (int64_t)(c / xcs) * W + x0;  // c / xcs = n * H + y
        const int npx = min(kTP, W - x0);
        __syncthreads();
        for (int o = tid; o < npx * n_out; o += kGThreads) gs[o] = g[px0 * n_out + o];
        __syncthreads();
        for (int px = 0; px < npx; ++px) {
          const float sv = ssum[(px0 + px) * kC + tid];
#pragma unroll
          for (int j = 0; j < kOutChunk; ++j) {
            if (j < nj) acc[j] = acc[j] + sv * gs[px * n_out + j0 + j];
          }
        }
      }
      float* mine = part_out + ((int64_t)so * kC + tid) * n_out + j0;
#pragma unroll
      for (int j = 0; j < kOutChunk; ++j) {
        if (j < nj) mine[j] = acc[j];
      }
    }
    if (!arrives_last(counters + kDw9Tiles, S_out)) return;
    for (int j = 0; j < n_out; ++j) {
      float sum = 0.0f;
      for (int s = 0; s < S_out; ++s) {
        sum = sum + __ldcg(part_out + ((int64_t)s * kC + tid) * n_out + j);
      }
      dwout[tid * n_out + j] = sum;
    }
    return;
  }

  // dw9 tile (k, mi, ni), split s: consecutive blocks share a split, so the
  // blocks that run together read the same dc rows.
  const int tile = blockIdx.x % kDw9Tiles;
  const int s = blockIdx.x / kDw9Tiles;
  const int k = tile / kTilesPerTap;
  const int mi = (tile / (kC / kTile)) % (kC / kTile);
  const int ni = tile % (kC / kTile);
  const int dy = k / 3 - 1;
  const int dx = k % 3 - 1;
  const int per_split = (n_chunks + S - 1) / S;
  const int c0 = s * per_split;
  const int c1 = min(n_chunks, c0 + per_split);
  const int groups = (T + kTG - 1) / kTG;
  const int n_stages = max(0, c1 - c0) * groups;

  __nv_bfloat16* zb = reinterpret_cast<__nv_bfloat16*>(smem);            // [2][kKRows][kLdg]
  __nv_bfloat16* db = zb + 2 * kGStage;                                  // [2][kKRows][kLdg]
  const int warp = tid >> 5;
  const int wm = warp >> 1;          // input channels wm*32 .. +31 of the tile
  const int wn = warp & 1;           // output channels wn*64 .. +63 of the tile
  const __nv_bfloat16 one = __float2bfloat16(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  // The dc rows of stage i, by cp.async; rows outside the image are zero.
  auto load_dc = [&](int i) {
    const int c = c0 + i / groups;
    const int t0 = (i % groups) * kTG;
    const int tg = min(kTG, T - t0);
    const int x0 = (c % xcs) * kTP;
    const int64_t px0 = (int64_t)(c / xcs) * W + x0;
    __nv_bfloat16* dst = db + (i & 1) * kGStage;
    for (int q = tid; q < tg * kTP * (kTile / 8); q += kGThreads) {
      const int row = q / (kTile / 8);             // j * kTP + px
      const int col = (q % (kTile / 8)) * 8;
      const int j = row / kTP;
      const int px = row % kTP;
      __nv_bfloat16* d = dst + row * kLdg + col;
      if (x0 + px < W) {
        cp_async16(d, dc + ((px0 + px) * T + t0 + j) * kC + ni * kTile + col);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  // The encoder spikes of stage i, shifted by the tap, from the period map.
  auto build_z = [&](int i) {
    const int c = c0 + i / groups;
    const int t0 = (i % groups) * kTG;
    const int tg = min(kTG, T - t0);
    const int x0 = (c % xcs) * kTP;
    const int ny = c / xcs;                        // n * H + y
    const int gy = ny % H + dy;
    __nv_bfloat16* dst = zb + (i & 1) * kGStage;
    for (int q = tid; q < kTP * (kTile / 8); q += kGThreads) {
      const int px = q / (kTile / 8);
      const int col = (q % (kTile / 8)) * 8;
      const int gx = x0 + px + dx;
      uint2 praw = make_uint2(0u, 0u);             // period 0: bit 0 is never set
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        praw = *reinterpret_cast<const uint2*>(
            per + ((int64_t)(ny + dy) * W + gx) * kC + mi * kTile + col);
      }
      const uint8_t* p8 = reinterpret_cast<const uint8_t*>(&praw);
      for (int j = 0; j < tg; ++j) {
        __align__(16) __nv_bfloat16 zv[8];
        for (int e = 0; e < 8; ++e) zv[e] = ((spk_mask[t0 + j] >> p8[e]) & 1ull) ? one : zero;
        *reinterpret_cast<uint4*>(dst + (j * kTP + px) * kLdg + col) =
            *reinterpret_cast<const uint4*>(zv);
      }
    }
  };

  Acc acc[2][4];
  for (int a = 0; a < 2; ++a) {
    for (int b = 0; b < 4; ++b) wmma::fill_fragment(acc[a][b], 0.0f);
  }

  if (n_stages > 0) load_dc(0);
  cp_async_commit();
  for (int i = 0; i < n_stages; ++i) {
    build_z(i);
    cp_async_wait_all();
    __syncthreads();   // stage i is whole; every warp is done with stage i - 1
    if (i + 1 < n_stages) load_dc(i + 1);
    cp_async_commit();
    const int tg = min(kTG, T - (i % groups) * kTG);
    const __nv_bfloat16* za = zb + (i & 1) * kGStage + wm * 32;
    const __nv_bfloat16* da = db + (i & 1) * kGStage + wn * 64;
    for (int kk = 0; kk < tg * (kTP / 16); ++kk) {
      FragAT a[2];
      FragB b[4];
      for (int m = 0; m < 2; ++m) {
        wmma::load_matrix_sync(a[m], za + kk * 16 * kLdg + m * 16, kLdg);
      }
      for (int q = 0; q < 4; ++q) {
        wmma::load_matrix_sync(b[q], da + kk * 16 * kLdg + q * 16, kLdg);
      }
      for (int m = 0; m < 2; ++m) {
        for (int q = 0; q < 4; ++q) wmma::mma_sync(acc[m][q], a[m], b[q], acc[m][q]);
      }
    }
  }

  // This split's partial tile; with one split it is the result.
  float* base = (S == 1 ? dw9 : part9 + (int64_t)s * 9 * kC * kC) + (int64_t)k * kC * kC +
                (mi * kTile + wm * 32) * kC + ni * kTile + wn * 64;
  for (int m = 0; m < 2; ++m) {
    for (int q = 0; q < 4; ++q) {
      wmma::store_matrix_sync(base + m * 16 * kC + q * 16, acc[m][q], kC, wmma::mem_row_major);
    }
  }
  if (S == 1 || !arrives_last(counters + tile, S)) return;
  for (int o = tid; o < kTile * kTile / 4; o += kGThreads) {
    const int r = o / (kTile / 4);
    const int cc = (o % (kTile / 4)) * 4;
    const int64_t off = (int64_t)k * kC * kC + (mi * kTile + r) * kC + ni * kTile + cc;
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int sp = 0; sp < S; ++sp) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(part9 + (int64_t)sp * 9 * kC * kC + off));
      sum.x = sum.x + p.x;
      sum.y = sum.y + p.y;
      sum.z = sum.z + p.z;
      sum.w = sum.w + p.w;
    }
    *reinterpret_cast<float4*>(dw9 + off) = sum;
  }
}

}  // namespace

// feat [N, H, W, 256] bf16, w9 [9, 256, 256] bf16, wout [256, n_out] bf16,
// consts [2T] f32 (thresholds, LI coefficients), g [N, H, W, n_out] f32.
// Scratch, allocated by the caller: vd [N * H * ceil(W / 32) * T * 16 * 512]
// f32, per [N, H, W, 256] uint8, dc [N, H, W, T, 256] bf16, part9
// [S, 9, 256, 256] f32 (unused when S is 1), part_out [S_out, 256, n_out]
// f32, counters [37] int32 zeroed. Out: ssum [N, H, W, 256] f32 (the
// replay's LI-weighted spike sum), dw9 [9, 256, 256] f32, dwout
// [256, n_out] f32. S and S_out are the split counts, at most the number
// of 32-pixel chunks N * H * ceil(W / 32).
extern "C" int rpn_level_bwd_bf16(const void* feat, const void* w9, const void* wout,
                                  const float* consts, const float* g, float* vd, void* per,
                                  void* dc, float* ssum, float* part9, float* part_out,
                                  int* counters, float* dw9, float* dwout, int N, int H, int W,
                                  int T, int n_out, int S, int S_out, void* stream) {
  const int n_chunks = N * H * ((W + kTP - 1) / kTP);
  if (N <= 0 || H <= 0 || W <= 0 || T < 1 || T > kMaxT || n_out < 1 || n_out > kMaxOut ||
      H > 65535 || N > 65535 || S < 1 || S > n_chunks || S_out < 1 || S_out > n_chunks) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      rpn_level_bwd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      rpn_level_bwd_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTP - 1) / kTP, H, N);
  rpn_level_bwd_sweep_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(feat), reinterpret_cast<const __nv_bfloat16*>(w9),
      reinterpret_cast<const __nv_bfloat16*>(wout), consts, g, vd,
      reinterpret_cast<uint8_t*>(per), reinterpret_cast<__nv_bfloat16*>(dc), ssum, H, W, T,
      n_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rpn_level_bwd_wgrad_kernel<<<kDw9Tiles * S + S_out, kGThreads, kGSmemBytes,
                               (cudaStream_t)stream>>>(
      reinterpret_cast<const uint8_t*>(per), reinterpret_cast<const __nv_bfloat16*>(dc), ssum, g,
      part9, part_out, counters, dw9, dwout, N, H, W, T, n_out, S, S_out);
  return (int)cudaGetLastError();
}
