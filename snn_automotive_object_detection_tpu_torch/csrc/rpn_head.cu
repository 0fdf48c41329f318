// Spiking RPN head, one FPN level, all T steps, for Hopper (bf16 planes,
// f32 neuron states).
//
// Replaces the TPU kernel snn/pallas_rpn.py (_rpn_level_kernel, launched by
// _run_level for rpn_head_snn_pallas_apply). Per level and step t:
//   z_t   = encoder spikes, from the closed-form period
//           p = 1 + sum_m [x * (1 - a^m) <= 0.25]: z_t = ((t + 1) % p == 0)
//   cur_t = bf16(conv3x3(z_t, w9))            (bias-free, zero padding)
//   LIF:    v' = v + 0.1 (i - v); i' = i - 0.2 i; s = v' - 0.1 > 0;
//           v = s ? 0 : v'; i = i' + cur_t
//   ssum += li[t] * s                          (LI readout, linear in s)
// and after the loop out = bf16(ssum @ wout), the fused cls+bbox readout.
//
// What bounds it on this card: the 3x3 conv, a [pixels, 2304] x [2304, 256]
// product per step (1.85 TFLOP for the five levels of an image pair over 8
// steps), so it must run on the tensor cores; next, the weight reads: every
// block re-reads the 1.2 MB tap weights from L2 at every step (about 58 GB
// of L2 reads per image pair), and the LIF state of 32 pixels x 256
// channels fills the register file, so a block holds no more pixels.
//
// Design: a block owns one 32-pixel row segment and all 256 channels for
// all T steps, so the recurrence never leaves the SM. The encoder needs no
// state: the uint8 period map of the 3 x 34 halo is computed once into
// shared memory and each step's bf16 spike halo is rebuilt from it with a
// per-step bit mask over the periods (bit p set when p divides t + 1). The
// conv is 9 taps x 16 k-chunks of WMMA bf16 16x16x16 products with f32
// accumulators; each of the 16 warps owns 16 pixels x 32 channels. The tap
// weights stream through a ring of three 64-row stages in shared memory
// filled by cp.async two stages ahead, so the B fragments come from shared
// memory while the next stages are in flight. The LIF membrane, current and LI-weighted spike sum live in
// registers as accumulator-shaped fragments (the element mapping is shared
// by fragments of one type; a fragment loaded from an index matrix
// recovers each element's pixel for the edge mask). After the loop the
// spike sum goes through shared memory into the 15-channel readout, so the
// level needs one launch and no second pass. Spike counts are exact 64-bit
// integers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kC = 256;            // channels in and out of the 3x3 conv
constexpr int kTP = 32;            // pixels per block (one row segment)
constexpr int kHalo = kTP + 2;     // halo width
constexpr int kLdz = 272;          // spike row stride: 544 B keeps WMMA pointers 32 B aligned
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 32;
constexpr int kMaxOut = 64;

constexpr int kStageRows = 64;     // tap-weight rows (input channels) per stage
constexpr int kStages = 3;         // ring depth: stage s + 2 loads while s computes
constexpr int kLdw = kC + 8;       // stage row stride: 528 B keeps fragment pointers 32 B aligned
constexpr int kStagesPerStep = 9 * kC / kStageRows;

constexpr int kPerBytes = 3 * kHalo * kC;                       // uint8 periods
constexpr int kZBytes = 3 * kHalo * kLdz * 2;                   // bf16 spikes
constexpr int kIdxOff = kPerBytes + kZBytes;
constexpr int kConstOff = kIdxOff + 256 * 4;
constexpr int kMaskOff = kConstOff + 2 * kMaxT * 4;
constexpr int kWOff = (kMaskOff + kMaxT * 8 + 127) / 128 * 128;
constexpr int kStageBytes = kStageRows * kLdw * 2;
constexpr int kSmemBytes = kWOff + kStages * kStageBytes;

static_assert(kPerBytes % 128 == 0, "spike halo must stay aligned");
static_assert(kIdxOff % 32 == 0 && kStageBytes % 32 == 0, "fragment pointers need 32 B");
static_assert(kTP * kC * 4 <= kZBytes, "spike-sum staging reuses the spike halo");
static_assert(kStageRows * kC / 8 % kThreads == 0, "whole 16-byte copies per thread");
static_assert(kSmemBytes <= 232448, "shared memory of one block");

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage s of a step: rows (s % 4) * 64 .. + 63 of tap s / 4, into the ring.
__device__ __forceinline__ void load_stage(__nv_bfloat16* ring, const __nv_bfloat16* w9,
                                           int s, int tid) {
  if (s >= kStagesPerStep) return;
  __nv_bfloat16* dst = ring + (s % kStages) * (kStageRows * kLdw);
  const __nv_bfloat16* src = w9 + (int64_t)s * kStageRows * kC;  // taps are contiguous
#pragma unroll
  for (int i = 0; i < kStageRows * kC / 8 / kThreads; ++i) {
    const int q = tid + kThreads * i;
    const int row = q / (kC / 8);
    const int col = (q % (kC / 8)) * 8;
    cp_async16(dst + row * kLdw + col, src + row * kC + col);
  }
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
rpn_level_kernel(const __nv_bfloat16* __restrict__ feat,   // [N, H, W, C]
                 const __nv_bfloat16* __restrict__ w9,     // [9, C, C]
                 const __nv_bfloat16* __restrict__ wout,   // [C, n_out]
                 const float* __restrict__ consts,         // thr[T], li[T]
                 float* __restrict__ out,                  // [N, H, W, n_out]
                 unsigned long long* __restrict__ counts,  // [N, 2] enc, lif
                 float* __restrict__ ssum_out,             // [N, H, W, C] or null
                 int H, int W, int T, int n_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint8_t* per = smem;
  __nv_bfloat16* z = reinterpret_cast<__nv_bfloat16*>(smem + kPerBytes);
  float* idx = reinterpret_cast<float*>(smem + kIdxOff);
  float* thr = reinterpret_cast<float*>(smem + kConstOff);
  float* li = thr + kMaxT;
  unsigned long long* spk_mask = reinterpret_cast<unsigned long long*>(smem + kMaskOff);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + kWOff);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int x0 = blockIdx.x * kTP;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  const int ph = warp >> 3;          // pixel half: pixels ph*16 .. ph*16+15
  const int cg = warp & 7;           // channels cg*32 .. cg*32+31

  if (tid < 256) idx[tid] = (float)tid;
  if (tid < T) {
    thr[tid] = consts[tid];
    li[tid] = consts[T + tid];
    unsigned long long m = 0;  // periods p <= T + 1 that spike at step tid
    for (int p = 1; p <= T + 1; ++p) m |= ((tid + 1) % p == 0) ? (1ull << p) : 0ull;
    spk_mask[tid] = m;
  }
  __syncthreads();

  // Period map of the 3 x 34 halo, 8 channels per item. Outside the image
  // the conv's zero padding never spikes: period T + 1.
  constexpr int kVec = 8;
  constexpr int kItems = 3 * kHalo * kC / kVec;
  for (int q = tid; q < kItems; q += kThreads) {
    const int e0 = q * kVec;
    const int row = e0 / (kHalo * kC);
    const int hp = (e0 / kC) % kHalo;
    const int ch = e0 % kC;
    const int gy = y + row - 1;
    const int gx = x0 + hp - 1;
    uint8_t p8[kVec];
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          feat + (((int64_t)n * H + gy) * W + gx) * kC + ch);
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
      for (int j = 0; j < kVec; ++j) {
        const float xf = __bfloat162float(xv[j]);
        int p = 1;
        for (int m = 0; m < T; ++m) p += (xf * thr[m] <= 0.25f) ? 1 : 0;
        p8[j] = (uint8_t)p;
      }
    } else {
      for (int j = 0; j < kVec; ++j) p8[j] = (uint8_t)(T + 1);
    }
    *reinterpret_cast<uint2*>(per + e0) = *reinterpret_cast<const uint2*>(p8);
  }

  Acc pos, acc[2], v[2], cu[2], ss[2];
  wmma::load_matrix_sync(pos, idx, 16, wmma::mem_row_major);
  for (int f = 0; f < 2; ++f) {
    wmma::fill_fragment(v[f], 0.0f);
    wmma::fill_fragment(cu[f], 0.0f);
    wmma::fill_fragment(ss[f], 0.0f);
  }
  unsigned long long enc_cnt = 0, lif_cnt = 0;
  const __nv_bfloat16 one = __float2bfloat16(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // The first two weight stages load while the spikes are built (the
    // previous step ended with a barrier, so the ring is free).
    load_stage(ring, w9, 0, tid);
    cp_async_commit();
    load_stage(ring, w9, 1, tid);
    cp_async_commit();

    // Encoder spikes of the halo for this step.
    const unsigned long long m_t = spk_mask[t];
    for (int q = tid; q < kItems; q += kThreads) {
      const int e0 = q * kVec;
      const int row = e0 / (kHalo * kC);
      const int hp = (e0 / kC) % kHalo;
      const int ch = e0 % kC;
      const uint2 praw = *reinterpret_cast<const uint2*>(per + e0);
      const uint8_t* p8 = reinterpret_cast<const uint8_t*>(&praw);
      __align__(16) __nv_bfloat16 zv[kVec];
      int nz = 0;
      for (int j = 0; j < kVec; ++j) {
        const bool s = (m_t >> p8[j]) & 1ull;
        zv[j] = s ? one : zero;
        nz += s ? 1 : 0;
      }
      *reinterpret_cast<uint4*>(z + (row * kHalo + hp) * kLdz + ch) =
          *reinterpret_cast<const uint4*>(zv);
      if (row == 1 && hp >= 1 && hp <= kTP && x0 + hp - 1 < W) enc_cnt += nz;
    }

    // 3x3 conv on the tensor cores, the tap weights streaming through the ring.
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int st = 0; st < kStagesPerStep; ++st) {
      cp_async_wait_one();  // stage st has landed (for this thread's copies)
      __syncthreads();      // ... for all threads; stage st - 1 is consumed
      load_stage(ring, w9, st + 2, tid);
      cp_async_commit();    // possibly empty, which keeps the group count uniform
      const int k = st / (kC / kStageRows);
      const int dy = k / 3 - 1;
      const int dx = k % 3 - 1;
      const int kc0 = (st % (kC / kStageRows)) * (kStageRows / 16);
      const __nv_bfloat16* a_base =
          z + ((1 + dy) * kHalo + ph * 16 + 1 + dx) * kLdz + kc0 * 16;
      const __nv_bfloat16* b_base = ring + (st % kStages) * (kStageRows * kLdw) + cg * 32;
#pragma unroll
      for (int kk = 0; kk < kStageRows / 16; ++kk) {
        FragA a;
        FragB b0, b1;
        wmma::load_matrix_sync(a, a_base + kk * 16, kLdz);
        wmma::load_matrix_sync(b0, b_base + kk * 16 * kLdw, kLdw);
        wmma::load_matrix_sync(b1, b_base + kk * 16 * kLdw + 16, kLdw);
        wmma::mma_sync(acc[0], a, b0, acc[0]);
        wmma::mma_sync(acc[1], a, b1, acc[1]);
      }
    }

    // LIF (f32 state; the conv current is rounded to bf16 first) and the
    // LI-weighted spike sum.
    const float lit = li[t];
    for (int f = 0; f < 2; ++f) {
      for (int e = 0; e < acc[f].num_elements; ++e) {
        const float cur = __bfloat162float(__float2bfloat16_rn(acc[f].x[e]));
        const float vv = v[f].x[e];
        const float iv = cu[f].x[e];
        const float vd = vv + 0.1f * (iv - vv);
        const float id = iv - 0.2f * iv;
        const bool s = (vd - 0.1f) > 0.0f;
        v[f].x[e] = s ? 0.0f : vd;
        cu[f].x[e] = id + cur;
        ss[f].x[e] = ss[f].x[e] + (s ? lit : 0.0f);
        const int r = ((int)pos.x[e]) >> 4;
        if (s && x0 + ph * 16 + r < W) ++lif_cnt;
      }
    }
    __syncthreads();
  }

  // Spike sum -> shared memory -> fused readout, rounded to bf16.
  float* stage = reinterpret_cast<float*>(z);
  for (int f = 0; f < 2; ++f) {
    wmma::store_matrix_sync(stage + (ph * 16) * kC + cg * 32 + f * 16, ss[f], kC,
                            wmma::mem_row_major);
  }
  __syncthreads();
  if (ssum_out != nullptr) {  // per-neuron spike sums, for checks only
    for (int o = tid; o < kTP * kC; o += kThreads) {
      const int gx = x0 + o / kC;
      if (gx < W) ssum_out[(((int64_t)n * H + y) * W + gx) * kC + o % kC] = stage[o];
    }
  }
  for (int o = tid; o < kTP * n_out; o += kThreads) {
    const int px = o / n_out;
    const int j = o % n_out;
    const int gx = x0 + px;
    if (gx >= W) continue;
    float sum = 0.0f;
    for (int ch = 0; ch < kC; ++ch) {
      sum = sum + stage[px * kC + ch] * __bfloat162float(wout[ch * n_out + j]);
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

}  // namespace

// feat [N, H, W, 256] bf16, w9 [9, 256, 256] bf16 (HWIO taps, dy-major),
// wout [256, n_out] bf16, consts [2T] f32 (thresholds, LI coefficients),
// out [N, H, W, n_out] f32 (bf16-rounded values), counts [N, 2] uint64
// (zeroed by the caller; may be null), ssum [N, H, W, 256] f32, the
// LI-weighted spike sum of every neuron (may be null; checks compare it to
// find flipped LIF spikes neuron by neuron).
extern "C" int rpn_level_bf16(const void* feat, const void* w9, const void* wout,
                              const float* consts, float* out, void* counts, float* ssum,
                              int N, int H, int W, int T, int n_out, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || T < 1 || T > kMaxT || n_out < 1 ||
      n_out > kMaxOut || H > 65535 || N > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      rpn_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTP - 1) / kTP, H, N);
  rpn_level_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(feat),
      reinterpret_cast<const __nv_bfloat16*>(w9),
      reinterpret_cast<const __nv_bfloat16*>(wout), consts, out,
      reinterpret_cast<unsigned long long*>(counts), ssum, H, W, T, n_out);
  return (int)cudaGetLastError();
}
