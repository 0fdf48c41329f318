// Box-head encoder + fc6 for all T steps, for Hopper (bf16 operands, f32
// results).
//
// Replaces the TPU kernel snn/pallas_fc6.py (_encoder_fc6_kernel, launched
// by encoder_fc6_pallas): cur6[t] = z_t @ w6 for t < T, where z_t are the
// constant-current encoder's spikes of the flattened RoI features x, from
// the closed-form period p = 1 + sum_m [x * (1 - a^m) <= 0.25]:
// z_t = ((t + 1) % p == 0). Also the per-row encoder spike counts.
//
// What bounds it on this card: the products, [T R, 12544] x [12544, 1024]
// (0.617 dense TFLOP at R = 2000, T = 12), on the tensor cores; next, the
// weight slices that every row tile streams from L2. The 98 MB f32 output
// is written once.
//
// Design: two kernels in one launch of the wrapper. The code pass reads x
// once and writes each element's spike train as a uint16 code (bit t set
// when the element spikes at step t) and the exact encoder count per row.
// The encoder is closed-form, so fc6 is a plain GEMM over the T R rows:
// the spike-code GEMM of spike_gemm.cuh (wgmma with A built in registers
// from the codes, w6 streamed as it is stored by TMA through a ring of 8
// stages, two-block clusters sharing each stage) stores its f32 sums
// straight to cur6. A block owns 16 RoI rows x all T steps x 128 columns;
// blocks run row tile by row tile within a column slice, so a 3.2 MB slice
// of w6 stays in L2 while the codes stream past it.

#include "spike_gemm.cuh"

namespace {

using sgemm::bf16;

constexpr int kCodeThreads = 256;

// One block per row: periods by the threshold count, codes, and the row's
// encoder spikes (floor(T / p) per element, the code's popcount).
__global__ void __launch_bounds__(kCodeThreads)
encoder_code_kernel(const bf16* __restrict__ x,       // [R, D]
                    const float* __restrict__ thr_g,  // [T]
                    uint16_t* __restrict__ code,      // [R, D]
                    int* __restrict__ counts,         // [R]
                    int D, int T) {
  __shared__ float thr[sgemm::kMaxT];
  __shared__ int part[kCodeThreads / 32];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  if (tid < T) thr[tid] = thr_g[tid];
  __syncthreads();
  int cnt = 0;
  for (int q = tid; q < D / 8; q += kCodeThreads) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + row * D + 8 * q);
    const bf16* xv = reinterpret_cast<const bf16*>(&raw);
    uint32_t c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xf = __bfloat162float(xv[j]);
      int p = 1;
      for (int m = 0; m < T; ++m) p += (xf * thr[m] <= 0.25f) ? 1 : 0;
      // Spikes at t + 1 = p, 2p, ... up to T.
      uint32_t bits = 0u;
      for (int k = p; k <= T; k += p) bits |= 1u << (k - 1);
      c[j] = bits;
      cnt += __popc(bits);
    }
    uint4 o;
    o.x = c[0] | c[1] << 16;
    o.y = c[2] | c[3] << 16;
    o.z = c[4] | c[5] << 16;
    o.w = c[6] | c[7] << 16;
    *reinterpret_cast<uint4*>(code + row * D + 8 * q) = o;
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if ((tid & 31) == 0) part[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kCodeThreads / 32; ++w) total += part[w];
    counts[row] = total;
  }
}

}  // namespace

// x [R, D] bf16; w6 [D, rep] bf16; thr [T] f32 (thresholds 1 - a^m); out
// [T, R, rep] f32; counts [R] int32 encoder spikes per row; codes [R, D]
// uint16 scratch. Requires D % 64 == 0, rep % 128 == 0, 1 <= T <= 16.
extern "C" int encoder_fc6_bf16(const void* x, const void* w6, const float* thr, float* out,
                                int* counts, void* codes, int R, int D, int rep, int T,
                                void* stream) {
  if (R <= 0 || D % sgemm::kK != 0 || rep % 128 != 0 || T < 1 || T > sgemm::kMaxT) {
    return (int)cudaErrorInvalidValue;
  }
  encoder_code_kernel<<<R, kCodeThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const bf16*>(x), thr, reinterpret_cast<uint16_t*>(codes), counts, D, T);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sgemm_host::launch<128, 8, sgemm::StoreF32>(w6, rep, codes, R, D, T,
                                                     sgemm::StoreF32::Params{out, rep},
                                                     (cudaStream_t)stream);
}
