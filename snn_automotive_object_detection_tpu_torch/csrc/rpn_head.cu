// Spiking RPN head, one FPN level, all T steps, for Hopper (bf16 planes,
// f32 neuron states): the evaluation route, in a training instance the
// forward of the training route, and in a pair instance the paired-image
// head (K8).
//
// Replaces the TPU kernels snn/pallas_rpn.py _rpn_level_kernel (launched by
// _run_level for rpn_head_snn_pallas_apply and, as the forward of the
// custom VJP _level_train, for rpn_head_snn_pallas_train_apply) and
// _rpn_x2_kernel (launched by _run_level_x2, two images per instance, no
// spike counters). Per level and step t:
//   z_t   = encoder spikes, from the closed-form period
//           p = 1 + sum_m [x * (1 - a^m) <= 0.25]: z_t = ((t + 1) % p == 0)
//   cur_t = bf16(conv3x3(z_t, w9))            (bias-free, zero padding)
//   LIF:    v' = v + 0.1 (i - v); i' = i - 0.2 i; s = v' - 0.1 > 0;
//           v = s ? 0 : v'; i = i' + cur_t
//   ssum += li[t] * s                          (LI readout, linear in s)
// and after the loop out = bf16(ssum @ wout), the fused cls+bbox readout.
//
// What bounds it on this card: the 3x3 conv, a [pixels, 2304] x [2304, 256]
// product per step (1.85 TFLOP dense for the five levels of an image pair
// over 8 steps), on the tensor cores; next, the tap weights (1.2 MB) that
// every 16-pixel tile needs from L2 for each chunk of 8 steps. Measured on
// an H100 (PERF.md), the weight stream and each block's prologue and
// epilogue take more of the time than the products.
//
// Design. The encoder is closed-form: z_t depends on the period map and t
// only, never on a state, so the conv currents of all T steps depend on
// nothing the recurrence computes, and one pass over the tap weights can
// serve a chunk of steps. A block owns 16 pixels of one row and all 256
// channels; its GEMM rows are 8 steps x 16 pixels = 128, K = 9 taps x 256,
// N = 256. Three warpgroups: warp w of consumer warpgroup g computes step
// 8 c + 4 g + w of chunk c for the 16 pixels (wgmma m64n256k16, 128 f32
// accumulators per thread); a producer warpgroup's one thread streams the
// tap weights (w9 laid out [tap, out, in] by the wrapper) as 36 TMA stages
// of 64 input channels with the 128-byte swizzle into a ring of four, with
// full and empty mbarriers, and gives its registers to the consumers
// (setmaxnreg). Two blocks on consecutive rows form a cluster and share
// the stages: each loads half of a stage's output channels and multicasts
// it into both, which halves the L2 weight reads (5.4 GB for P2 at T = 8),
// and a slot is refilled only when the consumers of both blocks have
// released it. A is built in registers from the uint8 period map in
// shared memory and the step's bit mask (bit p set when p divides t + 1):
// no spike plane is written, rebuilt or synchronised. For T above 8 the
// chunks run in step order and re-stream the weights.
// After a chunk's products each current is rounded to bf16, what
// lif_element rounds first, and staged in shared memory as [step][pixel]
// [channel]; then each consumer thread runs the LIF recurrence of one
// channel of the 16 pixels over the chunk's steps with f32 state in
// registers, through lif_element of rpn_head_common.cuh. The LI-weighted
// spike sum then goes through shared memory into the readout (up to 128
// channels). Spike counts are exact 64-bit integers; the encoder's are
// floor(T / p) per element.
//
// bf16-state instance (template flag kS16, C entry rpn_level_s16_bf16): the
// evaluation instance with the LIF v and i rounded to bf16 after every
// elementwise operation and the threshold rounded to bf16
// (lif_element_s16), as the reference's kernel runs with bf16 LIF states
// (_run_level with lif_dtype = bf16); the encoder periods, the currents
// rounded to bf16, the f32 LI-weighted spike sum and the bf16 readout are
// the evaluation instance's. A simple instance: the rounding adds a few
// conversions per neuron and step to the recurrence.
//
// Training instance (template flag kSave, C entry rpn_level_save_bf16):
// the same code, which also stores what the backward (rpn_head_bwd.cu)
// needs in place of a replay of the conv: each chunk's staged bf16
// currents as cur [N, H, W, T, 256] (16-byte stores along the channels,
// the pixel's T x 256 block contiguous), the block's own periods as
// per [N, H, W, 256] uint8 and the spike sums. Its readout, counts and
// spike sums are the evaluation instance's bits.
//
// Pair instance (cluster size 4, C entry rpn_level_x2_bf16): on the TPU
// the pair shared one copy of the weights in VMEM; here the blocks of both
// images share each weight stage. A cluster is two rows x the two images
// of a pair (cluster dims (1, 2, 2) over a grid of (W / 16, H padded to
// even, N)); each block loads a quarter of a stage's output channels and
// multicasts it into all four, so the L2 weight reads halve again, and a
// slot is refilled once the consumers of all four have released it. A
// block cannot hold both images' rows: 8 steps x 16 pixels x 256 channels
// of f32 accumulators already fill its consumers' registers. Per image the
// pair instance computes K1's sums in K1's order, so its readout and spike
// sums are K1's bits; it writes no spike counts.
//
// The plain version sums the conv in another order, so a current can
// round to the neighbouring bf16 value and, rarely, flip a spike: the
// checks count such neurons through the spike-sum output.

#include "hopper.cuh"
#include "rpn_head_common.cuh"

using namespace hopper;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 256;
constexpr int kPx = 16;                  // pixels per block
constexpr int kHw = kPx + 2;             // halo width
constexpr int kChunk = 8;                // steps per pass over the weights
constexpr int kStepsPerWg = 4;
constexpr int kK = 64;                   // input channels per stage (128 B rows)
constexpr int kTapStages = 9 * kC / kK;  // 36 stages per chunk
constexpr int kStages = 4;
constexpr int kSlotBytes = kC * kK * 2;  // 32 KB
constexpr int kThreads = 384;            // consumer warpgroups 0 and 1, producer 2
constexpr int kLdp = kC + 16;            // period row stride (bytes): conflict-free u16 reads
constexpr int kLdc = kC + 8;             // staged current row stride (bf16)
constexpr int kMaxT = rpn::kMaxT;
constexpr int kMaxOut = rpn::kMaxOut;
constexpr int kCluster = 2;              // blocks (consecutive rows) sharing each weight stage
constexpr int kPairCluster = 4;          // the pair instance: two rows x two images

constexpr int kRingOff = 0;
constexpr int kStageOff = kRingOff + kStages * kSlotBytes;
constexpr int kStageBytes = kChunk * kPx * kLdc * 2;
constexpr int kPerOff = kStageOff + kStageBytes;
constexpr int kPerBytes = 3 * kHw * kLdp;
constexpr int kConstOff = (kPerOff + kPerBytes + 15) / 16 * 16;
constexpr int kMaskOff = kConstOff + 2 * kMaxT * 4;
constexpr int kBarOff = kMaskOff + kMaxT * 8;
constexpr int kSmem = 1024 + kBarOff + 2 * kStages * 8;

static_assert(kPx * kC * 4 <= kStageBytes, "the spike sums reuse the current staging");
static_assert(kSmem <= 232448, "shared memory of one block");

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Two encoder spikes as a packed bf16 pair (1.0 = 0x3F80): bytes p0 and p1
// of `pp` are the periods, `mask` the step's bit mask over periods.
__device__ __forceinline__ uint32_t spike_pair(uint32_t pp, unsigned long long mask) {
  const uint32_t b0 = (uint32_t)(mask >> (pp & 0xff)) & 1u;
  const uint32_t b1 = (uint32_t)(mask >> (pp >> 8)) & 1u;
  return b0 * 0x3F80u | b1 * 0x3F800000u;
}

// A cluster of kCl blocks: up to two consecutive rows (y), then the two
// images of a pair (z).
template <int kCl>
dim3 cluster_dims() {
  return dim3(1, kCl < 2 ? kCl : 2, kCl < 2 ? 1 : kCl / 2);
}

template <bool kSave, int kCl, bool kS16>
__global__ void __launch_bounds__(kThreads, 1)
rpn_level_kernel(const __grid_constant__ CUtensorMap map_w9,  // w9 [9 * 256 out, 256 in]
                 const bf16* __restrict__ feat,     // [N, H, W, C]
                 const bf16* __restrict__ wout,     // [C, n_out]
                 const float* __restrict__ consts,  // thr[T], li[T]
                 float* __restrict__ out,           // [N, H, W, n_out]
                 unsigned long long* __restrict__ counts,  // [N, 2] enc, lif
                 float* __restrict__ ssum_out,      // [N, H, W, C]; null: none (kSave: never)
                 bf16* __restrict__ cur_out,        // kSave: [N, H, W, T, C]
                 uint8_t* __restrict__ per_out,     // kSave: [N, H, W, C]
                 int H, int W, int T, int n_out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = smem + kRingOff;
  bf16* stage = reinterpret_cast<bf16*>(smem + kStageOff);
  uint8_t* per = smem + kPerOff;
  float* thr = reinterpret_cast<float*>(smem + kConstOff);
  float* li = thr + kMaxT;
  unsigned long long* masks = reinterpret_cast<unsigned long long*>(smem + kMaskOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int x0 = blockIdx.x * kPx;
  const int y = blockIdx.y;          // rows from H on pad the grid to whole clusters
  const int n = blockIdx.z;          // the pair instance: images 2p, 2p + 1 in one cluster
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int n_stages = n_chunks * kTapStages;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * kCl);   // one arrival per consumer warp of the cluster
    }
    fence_barrier_init();
  }
  cluster_sync();

  if (wg == 2) {
    // ---- Producer: 36 stages per chunk, chunk after chunk. Block r of the
    // cluster loads output channels r * 256 / kCl .. of each stage into
    // every block of the cluster; a slot is refilled once all of them have
    // released it.
    reg_dealloc<40>();
    if (tid == 256) {
      const int rank = (int)cluster_rank();
      for (int s = 0; s < n_stages + kStages; ++s) {
        const int slot = s % kStages;
        const int c = s % kTapStages;   // tap c / 4, input channels (c % 4) * 64 ..
        mbar_wait(&empty[slot], ((s / kStages) & 1) ^ 1);
        if (s >= n_stages) continue;    // the tail: every remote release has landed
        mbar_expect_tx(&full[slot], kSlotBytes);
        tma_load_2d_multicast(ring + slot * kSlotBytes + rank * (kSlotBytes / kCl), &map_w9,
                              &full[slot], (uint16_t)((1 << kCl) - 1), (c % 4) * kK,
                              (c / 4) * kC + rank * (kC / kCl));
      }
    }
  } else {
    // ---- Consumers.
    reg_alloc<232>();
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;

    if (tid < T) {
      thr[tid] = consts[tid];
      li[tid] = consts[T + tid];
      masks[tid] = rpn::step_mask(tid, T);
    }
    named_bar(1, 256);

    // Period map of the 3 x 18 halo, 8 channels per item, and the encoder
    // spikes of the block's own pixels: floor(T / p) over the T steps.
    unsigned long long enc_cnt = 0, lif_cnt = 0;
    for (int q = tid; q < 3 * kHw * (kC / 8); q += 256) {
      const int row = q / (kHw * (kC / 8));
      const int col = (q / (kC / 8)) % kHw;
      const int ch = (q % (kC / 8)) * 8;
      const int gy = y + row - 1;
      const int gx = x0 + col - 1;
      uint8_t p8[8];
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            feat + (((int64_t)n * H + gy) * W + gx) * kC + ch);
        const bf16* xv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xf = __bfloat162float(xv[j]);
          int p = 1;
          for (int m = 0; m < T; ++m) p += (xf * thr[m] <= 0.25f) ? 1 : 0;
          p8[j] = (uint8_t)p;
          if (row == 1 && col >= 1 && col <= kPx && y < H) enc_cnt += T / p;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) p8[j] = (uint8_t)(T + 1);
      }
      *reinterpret_cast<uint2*>(per + (row * kHw + col) * kLdp + ch) =
          *reinterpret_cast<const uint2*>(p8);
    }
    named_bar(1, 256);
    if constexpr (kSave) {
      // The block's own periods (halo row 1, columns 1 .. 16), 16 bytes a thread.
      const int px = tid >> 4;
      const int c16 = (tid & 15) * 16;
      if (y < H && x0 + px < W) {
        *reinterpret_cast<uint4*>(per_out + (((int64_t)n * H + y) * W + x0 + px) * kC + c16) =
            *reinterpret_cast<const uint4*>(per + (kHw + 1 + px) * kLdp + c16);
      }
    }

    // Neuron state: this thread owns channel tid of the 16 pixels.
    float v[kPx], cu[kPx], ss[kPx];
#pragma unroll
    for (int k = 0; k < kPx; ++k) v[k] = cu[k] = ss[k] = 0.0f;

    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int t_first = chunk * kChunk + wg * kStepsPerWg;   // this warpgroup's first step
      const int t = t_first + warp;                              // this warp's step
      const unsigned long long mask = t < T ? masks[t] : 0ull;
      const bool active = t_first < T;
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      for (int c = 0; c < kTapStages; ++c) {
        const int s = chunk * kTapStages + c;
        const int slot = s % kStages;
        if (active) {
          const int tap = c / 4;
          const int k0 = (c % 4) * kK;
          // Pixel g (and g + 8) at this tap reads halo (tap / 3, g + tap % 3).
          const uint8_t* pr = per + ((tap / 3) * kHw + tap % 3 + g) * kLdp + k0 + 2 * t4;
          uint32_t a[kK / 16][4];
#pragma unroll
          for (int kk = 0; kk < kK / 16; ++kk) {
            const uint8_t* p = pr + kk * 16;
            a[kk][0] = spike_pair(*reinterpret_cast<const uint16_t*>(p), mask);
            a[kk][1] = spike_pair(*reinterpret_cast<const uint16_t*>(p + 8 * kLdp), mask);
            a[kk][2] = spike_pair(*reinterpret_cast<const uint16_t*>(p + 8), mask);
            a[kk][3] = spike_pair(*reinterpret_cast<const uint16_t*>(p + 8 * kLdp + 8), mask);
          }
          mbar_wait(&full[slot], (s / kStages) & 1);
          const uint64_t db = desc_sw128(ring + slot * kSlotBytes);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kK / 16; ++kk) wgmma_rs_n256(acc, a[kk], db + kk * 2);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc);
        } else {
          mbar_wait(&full[slot], (s / kStages) & 1);
        }
        if (lane == 0) {
          for (int r = 0; r < kCl; ++r) mbar_arrive_cluster(&empty[slot], r);
        }
      }

      // The chunk's currents, rounded to bf16, into [step][pixel][channel].
      named_bar(1, 256);   // the previous chunk's recurrence has read the staging
      if (active) {
        bf16* row = stage + (wg * kStepsPerWg + warp) * kPx * kLdc;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162 o;
            o.x = __float2bfloat16_rn(acc[4 * j + 2 * h]);
            o.y = __float2bfloat16_rn(acc[4 * j + 2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(row + (g + 8 * h) * kLdc + j * 8 + 2 * t4) = o;
          }
        }
      }
      named_bar(1, 256);
      const int steps = min(kChunk, T - chunk * kChunk);
      if constexpr (kSave) {
        // The chunk's currents of each pixel: steps chunk * 8 .. of its
        // contiguous T x 256 block, 16 bytes a thread along the channels.
        for (int q = tid; q < kPx * steps * (kC / 8); q += 256) {
          const int px = q / (steps * (kC / 8));
          const int sl = (q / (kC / 8)) % steps;
          const int c8 = (q % (kC / 8)) * 8;
          if (y < H && x0 + px < W) {
            *reinterpret_cast<uint4*>(
                cur_out + ((((int64_t)n * H + y) * W + x0 + px) * T + chunk * kChunk + sl) * kC +
                c8) = *reinterpret_cast<const uint4*>(stage + (sl * kPx + px) * kLdc + c8);
          }
        }
      }
      // LIF over the chunk's steps, in order, and the LI-weighted spike sum.
      for (int sl = 0; sl < steps; ++sl) {
        const float lit = li[chunk * kChunk + sl];
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
          float vd;
          const float conv = __bfloat162float(stage[(sl * kPx + k) * kLdc + tid]);
          const bool s = kS16 ? rpn::lif_element_s16(conv, lit, v[k], cu[k], ss[k], vd)
                              : rpn::lif_element(conv, lit, v[k], cu[k], ss[k], vd);
          if (s && x0 + k < W && y < H) ++lif_cnt;
        }
      }
    }

    // Spike sums -> shared memory -> fused readout, rounded to bf16.
    named_bar(1, 256);
    float* sst = reinterpret_cast<float*>(stage);
#pragma unroll
    for (int k = 0; k < kPx; ++k) sst[k * kC + tid] = ss[k];
    named_bar(1, 256);
    if (ssum_out != nullptr && y < H) {   // per-neuron spike sums, for checks only
      for (int o = tid; o < kPx * kC; o += 256) {
        const int gx = x0 + o / kC;
        if (gx < W) ssum_out[(((int64_t)n * H + y) * W + gx) * kC + o % kC] = sst[o];
      }
    }
    for (int o = tid; o < kPx * n_out; o += 256) {
      const int px = o / n_out;
      const int j = o % n_out;
      const int gx = x0 + px;
      if (gx >= W || y >= H) continue;
      float sum = 0.0f;
      for (int ch = 0; ch < kC; ++ch) {
        sum = sum + sst[px * kC + ch] * __bfloat162float(wout[ch * n_out + j]);
      }
      out[(((int64_t)n * H + y) * W + gx) * n_out + j] =
          __bfloat162float(__float2bfloat16_rn(sum));
    }

    enc_cnt = warp_sum(enc_cnt);
    lif_cnt = warp_sum(lif_cnt);
    if (lane == 0 && counts != nullptr) {
      atomicAdd(counts + 2 * n, enc_cnt);
      atomicAdd(counts + 2 * n + 1, lif_cnt);
    }
  }
}

// The grid of a level [N, H, W, 256]: a block per 16 pixels of a row, the
// rows padded to the cluster's (padded rows store nothing).
template <int kCl>
dim3 level_grid(int N, int H, int W) {
  const dim3 cluster = cluster_dims<kCl>();
  return dim3((W + kPx - 1) / kPx, (H + cluster.y - 1) / cluster.y * cluster.y, N);
}

template <bool kSave, int kCl, bool kS16 = false>
int launch_level(const void* feat, const void* w9_t, const void* wout, const float* consts,
                 float* out, void* counts, float* ssum, void* cur, void* per, int N, int H,
                 int W, int T, int n_out, void* stream) {
  const dim3 cluster = cluster_dims<kCl>();
  if (N <= 0 || H <= 0 || W <= 0 || T < 1 || T > kMaxT || n_out < 1 ||
      n_out > kMaxOut || H > 65534 || N > 65535 || N % cluster.z != 0 ||
      (kSave && ssum == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map;
  const uint64_t dims[2] = {(uint64_t)kC, (uint64_t)9 * kC};
  const uint32_t box[2] = {kK, kC / kCl};
  if (!hopper_host::bf16_map(&map, w9_t, 2, dims, box, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = rpn_level_kernel<kSave, kCl, kS16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  err = hopper_host::launch_clusters(
      kernel, level_grid<kCl>(N, H, W), cluster, kThreads, kSmem, (cudaStream_t)stream, map,
      reinterpret_cast<const bf16*>(feat), reinterpret_cast<const bf16*>(wout), consts, out,
      reinterpret_cast<unsigned long long*>(counts), ssum, reinterpret_cast<bf16*>(cur),
      reinterpret_cast<uint8_t*>(per), H, W, T, n_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// feat [N, H, W, 256] bf16; w9_t [9, 256, 256] bf16, per tap (dy-major)
// [output channel, input channel]; wout [256, n_out] bf16; consts [2T] f32
// (thresholds, LI coefficients); out [N, H, W, n_out] f32 (bf16-rounded
// values); counts [N, 2] uint64 (zeroed by the caller; may be null); ssum
// [N, H, W, 256] f32, the LI-weighted spike sum of every neuron (may be
// null; checks compare it to find flipped LIF spikes neuron by neuron).
extern "C" int rpn_level_bf16(const void* feat, const void* w9_t, const void* wout,
                              const float* consts, float* out, void* counts, float* ssum,
                              int N, int H, int W, int T, int n_out, void* stream) {
  return launch_level<false, kCluster>(feat, w9_t, wout, consts, out, counts, ssum, nullptr,
                                       nullptr, N, H, W, T, n_out, stream);
}

// The instance for bf16 neuron states (evaluation): the arguments of
// rpn_level_bf16; the LIF v and i are rounded to bf16 after every
// elementwise operation and the threshold is bf16(0.1) (lif_element_s16).
extern "C" int rpn_level_s16_bf16(const void* feat, const void* w9_t, const void* wout,
                                  const float* consts, float* out, void* counts, float* ssum,
                                  int N, int H, int W, int T, int n_out, void* stream) {
  return launch_level<false, kCluster, true>(feat, w9_t, wout, consts, out, counts, ssum,
                                             nullptr, nullptr, N, H, W, T, n_out, stream);
}

// The training instance: the same arguments (ssum required), and in
// addition cur [N, H, W, T, 256] bf16, the conv currents as the LIF took
// them, and per [N, H, W, 256] uint8, the encoder periods (T + 1: never).
extern "C" int rpn_level_save_bf16(const void* feat, const void* w9_t, const void* wout,
                                   const float* consts, float* out, void* counts, float* ssum,
                                   void* cur, void* per, int N, int H, int W, int T, int n_out,
                                   void* stream) {
  return launch_level<true, kCluster>(feat, w9_t, wout, consts, out, counts, ssum, cur, per, N,
                                      H, W, T, n_out, stream);
}

// The pair instance (K8): the arguments of rpn_level_bf16 with N even and
// no spike counts; the readout and ssum (may be null) are K1's bits.
extern "C" int rpn_level_x2_bf16(const void* feat, const void* w9_t, const void* wout,
                                 const float* consts, float* out, float* ssum, int N, int H,
                                 int W, int T, int n_out, void* stream) {
  return launch_level<false, kPairCluster>(feat, w9_t, wout, consts, out, nullptr, ssum,
                                           nullptr, nullptr, N, H, W, T, n_out, stream);
}

// The grid and the cluster dims that the evaluation instance (pair = 0) or
// the pair instance (pair = 1) launches on a level [N, H, W, 256], into
// dims[0..2] (grid x, y, z) and dims[3..5] (cluster x, y, z).
extern "C" int rpn_level_launch_dims(int pair, int N, int H, int W, int* dims) {
  const dim3 grid = pair ? level_grid<kPairCluster>(N, H, W) : level_grid<kCluster>(N, H, W);
  const dim3 cluster = pair ? cluster_dims<kPairCluster>() : cluster_dims<kCluster>();
  const unsigned v[6] = {grid.x, grid.y, grid.z, cluster.x, cluster.y, cluster.z};
  for (int i = 0; i < 6; ++i) dims[i] = (int)v[i];
  return 0;
}

// How many clusters of the evaluation instance (pair = 0) or of the pair
// instance (pair = 1) the card holds at once, into *clusters.
extern "C" int rpn_level_max_clusters(int pair, int* clusters) {
  auto kernel = pair ? rpn_level_kernel<false, kPairCluster, false>
                     : rpn_level_kernel<false, kCluster, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = pair ? cluster_dims<kPairCluster>() : cluster_dims<kCluster>();
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cfg.gridDim.x;
  attr[0].val.clusterDim.y = cfg.gridDim.y;
  attr[0].val.clusterDim.z = cfg.gridDim.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (void*)kernel, &cfg);
}
