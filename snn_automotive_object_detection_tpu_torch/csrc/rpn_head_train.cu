// Spiking RPN head, one FPN level, all T steps, for Hopper (bf16 planes,
// f32 neuron states): the forward of the training route. The evaluation
// route runs rpn_head.cu, which computes the same function in another
// summation order.
//
// Replaces the TPU kernel snn/pallas_rpn.py (_rpn_level_kernel, launched by
// _run_level for rpn_head_snn_pallas_apply and, in training, for the
// forward of rpn_head_snn_pallas_train_apply). Per level and step t:
//   z_t   = encoder spikes, from the closed-form period
//           p = 1 + sum_m [x * (1 - a^m) <= 0.25]: z_t = ((t + 1) % p == 0)
//   cur_t = bf16(conv3x3(z_t, w9))            (bias-free, zero padding)
//   LIF:    v' = v + 0.1 (i - v); i' = i - 0.2 i; s = v' - 0.1 > 0;
//           v = s ? 0 : v'; i = i' + cur_t
//   ssum += li[t] * s                          (LI readout, linear in s)
// and after the loop out = bf16(ssum @ wout), the fused cls+bbox readout.
//
// It stays the training forward because the backward kernel
// (rpn_head_bwd.cu) replays it through the same device code
// (rpn_head_common.cuh), and the paired kernel (rpn_head_x2.cu) runs that
// code too: their conv sums, and with them their spikes, are bit-equal to
// this kernel's.
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
// spike sum goes through shared memory into the readout (15 channels at
// three anchors per location, up to 128), so the level needs one launch
// and no second pass. Spike counts are exact 64-bit
// integers.
//
// The shared-memory layout, the encoder's period map and spike halo and the
// conv step live in rpn_head_common.cuh, which the backward kernel
// (rpn_head_bwd.cu) includes too: its replay runs the same code.

#include "rpn_head_common.cuh"

using namespace rpn;

namespace {

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
  const Smem sm = carve(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int x0 = blockIdx.x * kTP;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  const int ph = warp >> 3;          // pixel half: pixels ph*16 .. ph*16+15
  const int cg = warp & 7;           // channels cg*32 .. cg*32+31

  load_constants(sm, consts, T, tid);
  __syncthreads();
  build_period_map(sm, feat, n, y, x0, H, W, T, tid);

  Acc pos, acc[2], v[2], cu[2], ss[2];
  wmma::load_matrix_sync(pos, sm.idx, 16, wmma::mem_row_major);
  for (int f = 0; f < 2; ++f) {
    wmma::fill_fragment(v[f], 0.0f);
    wmma::fill_fragment(cu[f], 0.0f);
    wmma::fill_fragment(ss[f], 0.0f);
  }
  unsigned long long enc_cnt = 0, lif_cnt = 0;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    prefetch_weights(sm, w9, tid);
    enc_cnt += build_spikes(sm, t, x0, W, tid);
    conv_step(acc, sm, w9, tid, ph * 16, cg);

    // LIF (f32 state; the conv current is rounded to bf16 first) and the
    // LI-weighted spike sum.
    const float lit = sm.li[t];
    for (int f = 0; f < 2; ++f) {
      for (int e = 0; e < acc[f].num_elements; ++e) {
        float vd;
        const bool s = lif_element(acc[f].x[e], lit, v[f].x[e], cu[f].x[e], ss[f].x[e], vd);
        const int r = ((int)pos.x[e]) >> 4;
        if (s && x0 + ph * 16 + r < W) ++lif_cnt;
      }
    }
    __syncthreads();
  }

  // Spike sum -> shared memory -> fused readout, rounded to bf16.
  float* stage = reinterpret_cast<float*>(sm.z);
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
extern "C" int rpn_level_train_bf16(const void* feat, const void* w9, const void* wout,
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
