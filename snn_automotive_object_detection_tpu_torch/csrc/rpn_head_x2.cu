// Spiking RPN head for a pair of images, one FPN level, all T steps, for
// Hopper (bf16 planes, f32 neuron states).
//
// Replaces the TPU kernel snn/pallas_rpn.py (_rpn_x2_kernel, launched by
// _run_level_x2 for rpn_head_snn_pallas_apply when rates are not
// collected): one FPN level for images 2p and 2p + 1 in one instance that
// shares one copy of the weights. Per image it computes what the plain
// version (cuda_rpn.rpn_level_plain) computes: the same encoder periods,
// the conv on bf16 spikes summed in f32 and rounded to bf16, the LIF
// update of lif_element and the readout loop. It keeps no spike counters.
// K1 (rpn_head.cu) sums the conv in another order, so a current can round
// to the neighbouring bf16 value and, rarely, flip a spike between the two.
//
// What bounds it on this card: the 3x3 conv on the tensor cores and the
// tap weights, which every block pulls from L2 once per step (1.2 MB). The
// LIF state of 32 pixels x 256 channels fills the register file of a block
// of 16 warps (v, i, the spike sum and the conv accumulator are 64
// registers of each thread), and shared memory has no room for a second
// 34-pixel halo beside the weight ring, so a block cannot hold 32 pixels
// of each image.
//
// Design: a block owns the same 16-pixel row segment of both images: warps
// 0-7 carry image 2p, warps 8-15 image 2p + 1, each warp 16 pixels x 32
// channels on WMMA 16x16x16. The two 3 x 18 halos lie side by side in the
// spike buffer, and one trip of the cp.async weight ring per step serves
// both images' products. The device code is rpn_head_common.cuh's.

#include "rpn_head_common.cuh"

using namespace rpn;

namespace {

using G = Tile;

__global__ void __launch_bounds__(kThreads, 1)
rpn_level_x2_kernel(const __nv_bfloat16* __restrict__ feat,   // [N, H, W, C], N even
                    const __nv_bfloat16* __restrict__ w9,     // [9, C, C]
                    const __nv_bfloat16* __restrict__ wout,   // [C, n_out]
                    const float* __restrict__ consts,         // thr[T], li[T]
                    float* __restrict__ out,                  // [N, H, W, n_out]
                    float* __restrict__ ssum_out,             // [N, H, W, C] or null
                    int H, int W, int T, int n_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = carve(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * G::kPx;
  const int y = blockIdx.y;
  const int n0 = 2 * blockIdx.z;
  const int img = warp >> 3;         // image of the pair
  const int cg = warp & 7;           // channels cg*32 .. cg*32+31
  const int col0 = img * G::kHw;     // where this image's halo begins

  load_constants(sm, consts, T, tid);
  __syncthreads();
  build_period_map(sm, feat, n0, y, x0, H, W, T, tid);

  Acc acc[2], v[2], cu[2], ss[2];
  for (int f = 0; f < 2; ++f) {
    wmma::fill_fragment(v[f], 0.0f);
    wmma::fill_fragment(cu[f], 0.0f);
    wmma::fill_fragment(ss[f], 0.0f);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    prefetch_weights(sm, w9, tid);
    build_spikes(sm, t, x0, W, tid);
    conv_step(acc, sm, w9, tid, col0, cg);
    const float lit = sm.li[t];
    for (int f = 0; f < 2; ++f) {
      for (int e = 0; e < acc[f].num_elements; ++e) {
        float vd;
        lif_element(acc[f].x[e], lit, v[f].x[e], cu[f].x[e], ss[f].x[e], vd);
      }
    }
    __syncthreads();
  }

  // Spike sums -> shared memory (row = image * 16 + pixel) -> fused
  // readout, rounded to bf16, summed over the channels in order.
  float* stage = reinterpret_cast<float*>(sm.z);
  for (int f = 0; f < 2; ++f) {
    wmma::store_matrix_sync(stage + (img * G::kPx) * kC + cg * 32 + f * 16, ss[f], kC,
                            wmma::mem_row_major);
  }
  __syncthreads();
  if (ssum_out != nullptr) {  // per-neuron spike sums, for checks only
    for (int o = tid; o < kTP * kC; o += kThreads) {
      const int row = o / kC;
      const int gx = x0 + row % G::kPx;
      if (gx < W) {
        ssum_out[(((int64_t)(n0 + row / G::kPx) * H + y) * W + gx) * kC + o % kC] = stage[o];
      }
    }
  }
  for (int o = tid; o < kTP * n_out; o += kThreads) {
    const int row = o / n_out;
    const int j = o % n_out;
    const int gx = x0 + row % G::kPx;
    if (gx >= W) continue;
    float sum = 0.0f;
    for (int ch = 0; ch < kC; ++ch) {
      sum = sum + stage[row * kC + ch] * __bfloat162float(wout[ch * n_out + j]);
    }
    out[(((int64_t)(n0 + row / G::kPx) * H + y) * W + gx) * n_out + j] =
        __bfloat162float(__float2bfloat16_rn(sum));
  }
}

}  // namespace

// feat [N, H, W, 256] bf16 with N even, w9 [9, 256, 256] bf16 (HWIO taps,
// dy-major), wout [256, n_out] bf16, consts [2T] f32 (thresholds, LI
// coefficients), out [N, H, W, n_out] f32 (bf16-rounded values), ssum
// [N, H, W, 256] f32, the LI-weighted spike sum of every neuron (may be
// null; checks hold it against the per-image kernel's).
extern "C" int rpn_level_x2_bf16(const void* feat, const void* w9, const void* wout,
                                 const float* consts, float* out, float* ssum, int N, int H,
                                 int W, int T, int n_out, void* stream) {
  if (N <= 0 || N % 2 != 0 || H <= 0 || W <= 0 || T < 1 || T > kMaxT || n_out < 1 ||
      n_out > kMaxOut || H > 65535 || N / 2 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      rpn_level_x2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + G::kPx - 1) / G::kPx, H, N / 2);
  rpn_level_x2_kernel<<<grid, kThreads, G::kSmemBytes, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(feat),
      reinterpret_cast<const __nv_bfloat16*>(w9),
      reinterpret_cast<const __nv_bfloat16*>(wout), consts, out, ssum, H, W, T, n_out);
  return (int)cudaGetLastError();
}
