// Backward of the spiking RPN head for its weights, one FPN level, for
// Hopper (bf16 planes, f32 neuron states), from what the forward saved.
//
// Replaces the TPU kernel snn/pallas_rpn.py (_rpn_level_bwd_kernel,
// launched by _run_level_bwd as the custom VJP of the fused level). The
// forward (rpn_head.cu, training instance) saved the conv currents as the
// LIF took them, cur [N, H, W, T, 256] bf16, the encoder periods per
// [N, H, W, 256] uint8 and the LI-weighted spike sums ssum [N, H, W, 256]
// f32. Given those and the cotangent g [N, H, W, n_out] f32 of the readout:
//   sweep   the LIF recurrence rerun from cur through lif_element (the
//           forward's operations: the same vd_t and s_t bits), then
//           gw = bf16(g) @ bf16(wout)^T, summed over the readout channels
//           in order, and for t = T-1 .. 0:
//             dc_t = bf16(lam)                 (lam before this step's update)
//             sp   = 1 / (100 |vd_t - 0.1| + 1)^2          (SuperSpike)
//             ds   = a_t gw - vd_t lv
//             dvd  = (1 - s_t) lv + ds sp
//             lv   = 0.9 dvd;  lam = 0.1 dvd + 0.8 lam
//   dw9[k]  = sum over pixels and t of z_t(shifted by tap k)^T @ dc_t
//   dwout   = ssum^T @ g                                   (g in f32)
// Pixels outside the image never spike and carry no cotangent.
//
// bf16-state instance (template flag kS16 of the sweep, C entry
// rpn_level_bwd_s16_bf16; the reference's _run_level_bwd with lif_dtype =
// bf16, from rpn_level_save_s16_bf16's tensors): the rerun takes
// lif_element_s16, so vd_t is the bf16-rounded decayed membrane the JAX
// kernel stores in lif_dtype, and the spike test and u = vd_t - v_th take
// v_th = bf16(0.1); lv, lam and gw and the coefficients 0.9, 0.1 and 0.8
// stay f32, as the JAX kernel's f32 scratch and Python-float constants
// keep them. The weight gradient and dwout read only dc and the spike
// sums: one code for both instances.
//
// IN PLACE: the sweep writes dc over the saved currents (same shape and
// dtype; nothing reads the currents afterwards), so the buffer handed in
// as cur holds dc when the launch returns.
//
// What bounds it on this card: the weight gradient, a product of the
// forward conv's size (9 x 256 x 256 x 2 operations per pixel and step,
// 1.85 TFLOP dense for the five flagship levels), on the tensor cores;
// the sweep is elementwise and moves the currents once in and once out.
//
// Design: four kernels per launch, a result that is the same on every run
// (no float atomics), and no replay of the conv.
//   * The sweep: a thread owns four channels of one pixel for all T steps,
//     vd_t in registers (the step loop is unrolled up to 8, 16 or 32), so
//     the currents are read once and dc written once, 256 bytes a warp.
//   * The weight gradient is a spike-code GEMM on wgmma: M = input
//     channels, N = the 256 output channels, K = (pixel, step) with the
//     step fastest, padded to Tp = 8, 16 or 32 steps per pixel. B is dc as
//     stored ([K, N], MN-major): a producer thread streams 64-row stages
//     (8 pixels x 8 steps at Tp = 8) of a 5-D TMA box (channels, steps, x,
//     y, image) with the 128-byte swizzle into a ring of four, read with
//     wgmma's transpose bit; steps past T and pixels past the row's end
//     read as zeros. A is built in registers: beside each B stage lands the
//     4-D TMA box of the period map shifted by the tap (coordinates outside
//     the image read as period 0, which never spikes), and a bf16 pair of
//     A, two consecutive k, is steps t and t + 1 of one (pixel, channel):
//     both bits from one period byte and the thread's fixed step masks.
//     A block owns one tap and 128 input channels (two consumer
//     warpgroups of m64n256, 128 f32 accumulators a thread) over a range
//     of row segments; its cluster partner owns the other 128 input
//     channels of the same tap and range, and each loads half of every dc
//     stage and multicasts it into both. The 18 blocks of one range start
//     together, so the 9 taps read each dc stage from L2. The pixel range
//     is split S ways to fill the SMs; each block stores its partial tile,
//     and the block that arrives last at a tile (a counter per tile) adds
//     the partials in split order.
//   * dwout (1/150 of the work) in f32 on the CUDA cores: a block per
//     pixel range, a thread per channel, 32 pixels' spike sums loaded into
//     registers at once; a second small kernel adds the partials in range
//     order, a thread per element of dwout.

#include "hopper.cuh"
#include "rpn_head_common.cuh"

using namespace hopper;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 256;
constexpr int kMaxT = rpn::kMaxT;
constexpr int kMaxOut = rpn::kMaxOut;

// True in exactly one of `parties` calls on a counter: the last to arrive,
// among the 256 consumer threads, which synchronise on named barrier 1. The
// partial results written before the call are then visible to it.
__device__ __forceinline__ bool arrives_last(int* counter, int parties) {
  __shared__ int last;
  __threadfence();
  named_bar(1, 256);
  if (threadIdx.x == 0) last = (atomicAdd(counter, 1) == parties - 1) ? 1 : 0;
  named_bar(1, 256);
  if (last) __threadfence();
  return last != 0;
}

// ------------------------------------------------------------------ sweep

constexpr int kSweepThreads = 256;   // four pixels, four channels a thread

template <int kTMax, bool kS16>
__global__ void __launch_bounds__(kSweepThreads)
sweep_kernel(bf16* __restrict__ cur_dc,          // [P, T, C]: currents in, dc out
             const float* __restrict__ g,         // [P, n_out]
             const bf16* __restrict__ wout,       // [C, n_out]
             const float* __restrict__ consts,    // thr[T], li[T]
             float* __restrict__ ssum_out,        // [P, C] or null
             int64_t P, int T, int n_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* wt = reinterpret_cast<bf16*>(smem);      // [n_out][C]: wout transposed
  __shared__ float li[kMaxT];
  const int tid = threadIdx.x;
  for (int o = tid; o < n_out * kC; o += kSweepThreads) {
    wt[o] = wout[(o % kC) * n_out + o / kC];
  }
  if (tid < T) li[tid] = consts[T + tid];
  __syncthreads();

  const int ch = (tid & 63) * 4;
  for (int64_t p = (int64_t)blockIdx.x * 4 + (tid >> 6); p < P; p += (int64_t)gridDim.x * 4) {
    uint2* row = reinterpret_cast<uint2*>(cur_dc + p * T * kC + ch);
    // The forward's LIF from its own currents, keeping each step's vd_t.
    float vd[kTMax][4];
    float v[4], cu[4], ss[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = cu[e] = ss[e] = 0.0f;
#pragma unroll
    for (int t = 0; t < kTMax; ++t) {
      if (t < T) {
        const uint2 raw = row[t * (kC / 4)];
        const bf16* c4 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kS16) {
            rpn::lif_element_s16(__bfloat162float(c4[e]), li[t], v[e], cu[e], ss[e], vd[t][e]);
          } else {
            rpn::lif_element(__bfloat162float(c4[e]), li[t], v[e], cu[e], ss[e], vd[t][e]);
          }
        }
      }
    }
    if (ssum_out != nullptr) {
      *reinterpret_cast<float4*>(ssum_out + p * kC + ch) = make_float4(ss[0], ss[1], ss[2], ss[3]);
    }
    // gw = bf16(g) @ wout^T, the readout channels in order.
    float gw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* gp = g + p * n_out;
    for (int j = 0; j < n_out; ++j) {
      const float gv = __bfloat162float(__float2bfloat16_rn(gp[j]));
      const uint2 w4 = *reinterpret_cast<const uint2*>(wt + j * kC + ch);
      const bf16* wv = reinterpret_cast<const bf16*>(&w4);
#pragma unroll
      for (int e = 0; e < 4; ++e) gw[e] = gw[e] + gv * __bfloat162float(wv[e]);
    }
    float lv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, lam[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int t = kTMax - 1; t >= 0; --t) {
      if (t < T) {
        __align__(8) bf16 dc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) dc[e] = __float2bfloat16_rn(lam[e]);
        row[t * (kC / 4)] = *reinterpret_cast<const uint2*>(dc);   // dc_t, over cur_t
        const float lit = li[t];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float u = vd[t][e] - (kS16 ? rpn::kVth16 : 0.1f);
          const float keep = (u > 0.0f) ? 0.0f : 1.0f;     // 1 - s_t
          const float d = 100.0f * fabsf(u) + 1.0f;
          const float sp = 1.0f / (d * d);
          const float ds = lit * gw[e] - vd[t][e] * lv[e];
          const float dvd = keep * lv[e] + ds * sp;
          lv[e] = 0.9f * dvd;
          lam[e] = 0.1f * dvd + 0.8f * lam[e];
        }
      }
    }
  }
}

// ------------------------------------------------------- weight gradient

constexpr int kK = 64;                    // GEMM k rows per stage: (pixel, step)
constexpr int kMTile = 128;               // input channels per block
constexpr int kStages = 4;
constexpr int kChunkBytes = kK * 64 * 2;  // one 64 k x 64 output-channel box
constexpr int kBBytes = 4 * kChunkBytes;  // a dc stage: 32 KB
constexpr int kSlotBytes = kBBytes + 1024;  // + the stage's periods, kK / Tp x 128 bytes
constexpr int kGThreads = 384;            // consumer warpgroups 0 and 1, producer 2
constexpr int kCluster = 2;               // the two input-channel tiles of a tap
constexpr int kGSmem = 1024 + kStages * kSlotBytes + 2 * kStages * 8;

static_assert(kSlotBytes % 1024 == 0, "every dc stage starts on a swizzle atom");
static_assert(kGSmem <= 232448, "shared memory of one block");

// Two encoder spikes as a packed bf16 pair (1.0 = 0x3F80): period q at the
// steps of the masks `lo` (low half) and `hi`.
__device__ __forceinline__ uint32_t spike_pair(uint32_t q, unsigned long long lo,
                                               unsigned long long hi) {
  return (uint32_t)((lo >> q) & 1ull) * 0x3F80u | (uint32_t)((hi >> q) & 1ull) * 0x3F800000u;
}

template <int kTp>
__global__ void __launch_bounds__(kGThreads, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap map_dc,   // dc [N, H, W, T, C] bf16
             const __grid_constant__ CUtensorMap map_per,  // per [N, H, W, C] uint8
             float* __restrict__ part,                     // [S, 9, C, C] when S > 1
             int* __restrict__ counters,                   // [9 * 2], zero
             float* __restrict__ dw9,                      // [9, C, C]
             int N, int H, int W, int T, int S) {
  constexpr int kNpx = kK / kTp;          // pixels per stage
  constexpr int kGroups = kTp / 8;        // 8-step groups per pixel
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kSlotBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int mt = blockIdx.x;              // input channels mt * 128 .. ; the cluster rank
  const int tap = blockIdx.y;
  const int dy = tap / 3 - 1;
  const int dx = tap % 3 - 1;
  const int split = blockIdx.z;
  const int xcs = (W + kNpx - 1) / kNpx;  // stages per row
  const int total = N * H * xcs;
  const int per_split = (total + S - 1) / S;
  const int s0 = split * per_split;
  const int n_k = max(0, min(total, s0 + per_split) - s0);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * kCluster);   // one arrival per consumer warp of the cluster
    }
    fence_barrier_init();
  }
  cluster_sync();

  if (wg == 2) {
    // ---- Producer: block r of the cluster loads output-channel chunks 2r
    // and 2r + 1 of each dc stage into both blocks, and its own periods.
    reg_dealloc<40>();
    if (tid == 256) {
      const int rank = (int)cluster_rank();
      for (int s = 0; s < n_k + kStages; ++s) {
        const int slot = s % kStages;
        mbar_wait(&empty[slot], ((s / kStages) & 1) ^ 1);
        if (s >= n_k) continue;   // the tail: every remote release has landed
        const int st = s0 + s;
        const int x0 = (st % xcs) * kNpx;
        const int y = (st / xcs) % H;
        const int n = st / xcs / H;
        unsigned char* dst = ring + slot * kSlotBytes;
        mbar_expect_tx(&full[slot], kBBytes + kNpx * kMTile);
        for (int c = 2 * rank; c < 2 * rank + 2; ++c) {
          tma_load_5d_multicast(dst + c * kChunkBytes, &map_dc, &full[slot],
                                (uint16_t)((1 << kCluster) - 1), 64 * c, 0, x0, y, n);
        }
        tma_load_4d(dst + kBBytes, &map_per, &full[slot], mt * kMTile, x0 + dx, y + dy, n);
      }
    }
    return;
  }

  // ---- Consumers.
  reg_alloc<232>();
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = 64 * wg + 16 * warp + g;   // this thread's A rows: r0 and r0 + 8
  // Steps 8 j + 2 t4 (low half of a pair) and + 1 (high half) of group j;
  // steps past T have no bits.
  unsigned long long lo[kGroups], hi[kGroups];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int t = 8 * j + 2 * t4;
    lo[j] = t < T ? rpn::step_mask(t, T) : 0ull;
    hi[j] = t + 1 < T ? rpn::step_mask(t + 1, T) : 0ull;
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

  for (int s = 0; s < n_k; ++s) {
    const int slot = s % kStages;
    const unsigned char* base = ring + slot * kSlotBytes;
    mbar_wait(&full[slot], (s / kStages) & 1);
    // Rows 16 kk + 8 h + 2 t4 (+1) of the stage are pixel (16 kk + 8 h) / Tp
    // at steps 8 j + 2 t4 (+1) of group j = ((16 kk + 8 h) % Tp) / 8.
    const uint8_t* per = base + kBBytes;
    uint32_t a[kK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * kk + 8 * h;
        const uint8_t* q = per + (r / kTp) * kMTile + r0;
        const int j = (r % kTp) / 8;
        a[kk][2 * h] = spike_pair(q[0], lo[j], hi[j]);
        a[kk][2 * h + 1] = spike_pair(q[8], lo[j], hi[j]);
      }
    }
    const uint64_t db = desc_mn_sw128(base, kChunkBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) wgmma_rs_n256_tb(acc, a[kk], db + kk * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) {
      for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(&empty[slot], r);
    }
  }

  // This split's partial tile; with one split it is the result. Element i
  // of the accumulators is input channel r0 + 8 ((i / 2) % 2), output
  // channel 8 (i / 4) + 2 t4 + i % 2.
  float* out = (S == 1 ? dw9 : part + (int64_t)split * 9 * kC * kC) + (int64_t)tap * kC * kC +
               (int64_t)(mt * kMTile + r0) * kC + 2 * t4;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(out + 8 * h * kC + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  if (S == 1 || !arrives_last(counters + tap * (kC / kMTile) + mt, S)) return;
  const int64_t tile = (int64_t)tap * kC * kC + (int64_t)mt * kMTile * kC;
  for (int o = tid; o < kMTile * kC / 4; o += 256) {
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int sp = 0; sp < S; ++sp) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(
          part + (int64_t)sp * 9 * kC * kC + tile + 4 * o));
      sum.x = sum.x + p.x;
      sum.y = sum.y + p.y;
      sum.z = sum.z + p.z;
      sum.w = sum.w + p.w;
    }
    *reinterpret_cast<float4*>(dw9 + tile + 4 * o) = sum;
  }
}

// ------------------------------------------------------------------ dwout

constexpr int kGPx = 32;             // pixels of a range read at a time

// kJ readout columns a thread sums at a time (16, 32 or 64); a further
// chunk walks the range's pixels again.
template <int kJ>
__global__ void __launch_bounds__(kC)
dwout_kernel(const float* __restrict__ ssum,     // [P, C]
             const float* __restrict__ g,        // [P, n_out]
             float* __restrict__ part_out,       // [S_out, C, n_out]
             int64_t P, int n_out, int S_out) {
  __shared__ float gs[kGPx * kMaxOut];
  const int tid = threadIdx.x;   // the channel
  const int so = blockIdx.x;
  const int64_t per_split = (P + S_out - 1) / S_out;
  const int64_t p0 = so * per_split;
  const int64_t p1 = min(P, p0 + per_split);
  for (int j0 = 0; j0 < n_out; j0 += kJ) {
    const int nj = min(kJ, n_out - j0);
    float acc[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[j] = 0.0f;
    for (int64_t pb = p0; pb < p1; pb += kGPx) {
      const int npx = (int)min((int64_t)kGPx, p1 - pb);
      __syncthreads();
      for (int o = tid; o < npx * n_out; o += kC) gs[o] = g[pb * n_out + o];
      // The range's spike sums of this channel, all loads in flight at once.
      float sv[kGPx];
#pragma unroll
      for (int px = 0; px < kGPx; ++px) sv[px] = px < npx ? ssum[(pb + px) * kC + tid] : 0.0f;
      __syncthreads();
#pragma unroll
      for (int px = 0; px < kGPx; ++px) {
        if (px < npx) {
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            if (j < nj) acc[j] = acc[j] + sv[px] * gs[px * n_out + j0 + j];
          }
        }
      }
    }
    float* mine = part_out + ((int64_t)so * kC + tid) * n_out + j0;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      if (j < nj) mine[j] = acc[j];
    }
  }
}

// dwout = the S_out partials added in range order, a thread per element.
__global__ void dwout_sum_kernel(const float* __restrict__ part_out,  // [S_out, C * n_out]
                                 float* __restrict__ dwout, int n, int S_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.0f;
  for (int s = 0; s < S_out; ++s) sum = sum + part_out[(int64_t)s * n + e];
  dwout[e] = sum;
}

template <int kTMax, bool kS16>
cudaError_t launch_sweep(void* cur_dc, const float* g, const void* wout, const float* consts,
                         float* ssum_sweep, int64_t P, int T, int n_out, cudaStream_t stream) {
  const int smem = n_out * kC * 2;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<kTMax, kS16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t quads = (P + 3) / 4;
  const int blocks = (int)(quads < 132 * 16 ? quads : 132 * 16);
  sweep_kernel<kTMax, kS16><<<blocks, kSweepThreads, smem, stream>>>(
      reinterpret_cast<bf16*>(cur_dc), g, reinterpret_cast<const bf16*>(wout), consts,
      ssum_sweep, P, T, n_out);
  return cudaGetLastError();
}

template <int kTp>
cudaError_t launch_wgrad(const void* dc, const void* per, float* part9, int* counters,
                         float* dw9, int N, int H, int W, int T, int S, cudaStream_t stream) {
  constexpr int kNpx = kK / kTp;
  CUtensorMap map_dc, map_per;
  const uint64_t dd[5] = {(uint64_t)kC, (uint64_t)T, (uint64_t)W, (uint64_t)H, (uint64_t)N};
  const uint32_t db[5] = {64, (uint32_t)kTp, (uint32_t)kNpx, 1, 1};
  const uint64_t pd[4] = {(uint64_t)kC, (uint64_t)W, (uint64_t)H, (uint64_t)N};
  const uint32_t pb[4] = {kMTile, (uint32_t)kNpx, 1, 1};
  if (!hopper_host::bf16_map(&map_dc, dc, 5, dd, db, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper_host::map_tiled(&map_per, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, per, 4, pd, pb,
                              CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = wgrad_kernel<kTp>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
  if (err != cudaSuccess) return err;
  err = hopper_host::launch_clusters(kernel, dim3(kCluster, 9, S), dim3(kCluster, 1, 1),
                                     kGThreads, kGSmem, stream, map_dc, map_per, part9, counters,
                                     dw9, N, H, W, T, S);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Steps per pixel in the weight gradient's K: T padded to 8, 16 or 32.
int padded_steps(int T) { return T <= 8 ? 8 : (T <= 16 ? 16 : 32); }

template <bool kS16>
int level_bwd(void* cur, const void* per, const float* ssum, const void* wout,
              const float* consts, const float* g, float* ssum_sweep, float* part9,
              float* part_out, int* counters, float* dw9, float* dwout, int N, int H, int W,
              int T, int n_out, int S, int S_out, int phases, void* stream) {
  const int64_t P = (int64_t)N * H * W;
  const int tp = padded_steps(T);
  const int64_t stages = (int64_t)N * H * ((W + 64 / tp - 1) / (64 / tp));
  if (N <= 0 || H <= 0 || W <= 0 || T < 1 || T > kMaxT || n_out < 1 || n_out > kMaxOut ||
      S < 1 || S > stages || S > 65535 || S_out < 1 || S_out > P) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (phases & 1) {
    err = T <= 8    ? launch_sweep<8, kS16>(cur, g, wout, consts, ssum_sweep, P, T, n_out, st)
          : T <= 16 ? launch_sweep<16, kS16>(cur, g, wout, consts, ssum_sweep, P, T, n_out, st)
                    : launch_sweep<32, kS16>(cur, g, wout, consts, ssum_sweep, P, T, n_out, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & 2) {
    err = tp == 8    ? launch_wgrad<8>(cur, per, part9, counters, dw9, N, H, W, T, S, st)
          : tp == 16 ? launch_wgrad<16>(cur, per, part9, counters, dw9, N, H, W, T, S, st)
                     : launch_wgrad<32>(cur, per, part9, counters, dw9, N, H, W, T, S, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & 4) {
    if (n_out <= 16) {
      dwout_kernel<16><<<S_out, kC, 0, st>>>(ssum, g, part_out, P, n_out, S_out);
    } else if (n_out <= 32) {
      dwout_kernel<32><<<S_out, kC, 0, st>>>(ssum, g, part_out, P, n_out, S_out);
    } else {
      dwout_kernel<64><<<S_out, kC, 0, st>>>(ssum, g, part_out, P, n_out, S_out);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n = kC * n_out;
    dwout_sum_kernel<<<(n + 127) / 128, 128, 0, st>>>(part_out, dwout, n, S_out);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

// cur [N, H, W, T, 256] bf16, the forward's currents, which the launch
// overwrites with dc (same shape); per [N, H, W, 256] uint8 and ssum
// [N, H, W, 256] f32 from the forward; wout [256, n_out] bf16; consts [2T]
// f32 (thresholds, LI coefficients); g [N, H, W, n_out] f32. ssum_sweep
// [N, H, W, 256] f32, the sweep's own spike sums (may be null; checks hold
// them to the forward's). Scratch, allocated by the caller: part9
// [S, 9, 256, 256] f32 (unused when S is 1), part_out [S_out, 256, n_out]
// f32, counters [18] int32 zeroed. Out: dw9 [9, 256, 256] f32, dwout
// [256, n_out] f32. S is at most the number of stages, N H ceil(W / (64 /
// Tp)), S_out at most the number of pixels. `phases` picks the kernels
// (bit 0 the sweep, bit 1 dw9, bit 2 dwout): 7 computes the backward, the
// others serve timings.
extern "C" int rpn_level_bwd_bf16(void* cur, const void* per, const float* ssum,
                                  const void* wout, const float* consts, const float* g,
                                  float* ssum_sweep, float* part9, float* part_out,
                                  int* counters, float* dw9, float* dwout, int N, int H, int W,
                                  int T, int n_out, int S, int S_out, int phases, void* stream) {
  return level_bwd<false>(cur, per, ssum, wout, consts, g, ssum_sweep, part9, part_out,
                          counters, dw9, dwout, N, H, W, T, n_out, S, S_out, phases, stream);
}

// The bf16-state instance: the arguments of rpn_level_bwd_bf16, on what
// rpn_level_save_s16_bf16 saved; the sweep reruns the LIF with bf16 states
// and takes its surrogate at v_th = bf16(0.1).
extern "C" int rpn_level_bwd_s16_bf16(void* cur, const void* per, const float* ssum,
                                      const void* wout, const float* consts, const float* g,
                                      float* ssum_sweep, float* part9, float* part_out,
                                      int* counters, float* dw9, float* dwout, int N, int H,
                                      int W, int T, int n_out, int S, int S_out, int phases,
                                      void* stream) {
  return level_bwd<true>(cur, per, ssum, wout, consts, g, ssum_sweep, part9, part_out,
                         counters, dw9, dwout, N, H, W, T, n_out, S, S_out, phases, stream);
}
