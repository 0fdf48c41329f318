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
// of w6 stays in L2 while the codes stream past it. For 16 < T <= 32 the
// code pass writes two code planes (steps 0-15 and 16-31) and the GEMM
// runs once per plane (sgemm_host::launch_steps), the second half's sums
// into cur6[16:].
//
// Training instance (encoder_fc6_train_bf16): the code pass carries the
// encoder's membrane as the training scan does (encoder_code_train_kernel)
// and writes no counts; the GEMM rounds its sums to bf16 as it stores them
// (StoreBF16); the codes are its output too, for the weight gradient.

#include "spike_gemm.cuh"

namespace {

// A code pass packs a train of up to 32 steps into two planes.
constexpr int kMaxSteps = 2 * sgemm::kMaxT;

using sgemm::bf16;

constexpr int kCodeThreads = 256;

// One block per row: periods by the threshold count, codes, and the row's
// encoder spikes (floor(T / p) per element, the code's popcount). With
// kPlanes = 2, bits 16-31 go to the second plane, R D elements on.
template <int kPlanes>
__global__ void __launch_bounds__(kCodeThreads)
encoder_code_kernel(const bf16* __restrict__ x,       // [R, D]
                    const float* __restrict__ thr_g,  // [T]
                    uint16_t* __restrict__ code,      // [kPlanes, R, D]
                    int* __restrict__ counts,         // [R]
                    int D, int T) {
  __shared__ float thr[sgemm::kMaxT * kPlanes];
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
    sgemm::store_codes8<kPlanes>(c, code + row * D + 8 * q,
                                 code + (gridDim.x + row) * D + 8 * q);
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

// The training instance's code pass: one block per row, no counts. An
// element's first spike from the encoder membrane carried in f32 as
// lif_current_encoder carries it (v += 0.1 ((0 - v) + x), a spike where
// v - 0.25 > 0), the same operations in the same order (--fmad=false); the
// reset leaves exactly 0, so the train repeats with that period. The
// threshold count above differs from it at x = 2.5 alone, where the
// membrane reaches 0.25 exactly after one step and spikes after two.
template <int kPlanes>
__global__ void __launch_bounds__(kCodeThreads)
encoder_code_train_kernel(const bf16* __restrict__ x,   // [R, D]
                          uint16_t* __restrict__ code,  // [kPlanes, R, D]
                          int D, int T) {
  const int64_t row = blockIdx.x;
  for (int q = threadIdx.x; q < D / 8; q += kCodeThreads) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + row * D + 8 * q);
    const bf16* xv = reinterpret_cast<const bf16*>(&raw);
    uint32_t c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xf = __bfloat162float(xv[j]);
      int p = T + 1;
      float v = 0.0f;
      for (int m = 1; m <= T; ++m) {
        v = v + 0.1f * ((0.0f - v) + xf);
        if (v - 0.25f > 0.0f) {
          p = m;
          break;
        }
      }
      uint32_t bits = 0u;
      for (int t = p - 1; t < T; t += p) bits |= 1u << t;   // steps p - 1, 2p - 1, ...
      c[j] = bits;
    }
    sgemm::store_codes8<kPlanes>(c, code + row * D + 8 * q,
                                 code + (gridDim.x + row) * D + 8 * q);
  }
}

}  // namespace

// x [R, D] bf16; w6 [D, rep] bf16; thr [T] f32 (thresholds 1 - a^m); out
// [T, R, rep] f32; counts [R] int32 encoder spikes per row; codes
// [R, D] uint16 scratch, [2, R, D] for T > 16. Requires D % 64 == 0,
// rep % 128 == 0, 1 <= T <= 32.
extern "C" int encoder_fc6_bf16(const void* x, const void* w6, const float* thr, float* out,
                                int* counts, void* codes, int R, int D, int rep, int T,
                                void* stream) {
  if (R <= 0 || D % sgemm::kK != 0 || rep % 128 != 0 || T < 1 || T > kMaxSteps) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const bf16* xb = reinterpret_cast<const bf16*>(x);
  uint16_t* code = reinterpret_cast<uint16_t*>(codes);
  if (T <= sgemm::kMaxT) {
    encoder_code_kernel<1><<<R, kCodeThreads, 0, s>>>(xb, thr, code, counts, D, T);
  } else {
    encoder_code_kernel<2><<<R, kCodeThreads, 0, s>>>(xb, thr, code, counts, D, T);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sgemm_host::launch_steps<128, 8, sgemm::StoreF32T>(w6, rep, codes, R, D, T,
                                                            sgemm::StoreF32::Params{out, rep}, s);
}

// The training instance: x [R, D] bf16; w6 [D, rep] bf16; out [T, R, rep]
// bf16, the f32 sums of the carried encoder's spikes rounded once; codes
// [R, D] uint16, [2, R, D] for T > 16, which the weight gradient
// (encoder_fc6_wgrad.cu) reads. Requires what encoder_fc6_bf16 does.
extern "C" int encoder_fc6_train_bf16(const void* x, const void* w6, void* out, void* codes,
                                      int R, int D, int rep, int T, void* stream) {
  if (R <= 0 || D % sgemm::kK != 0 || rep % 128 != 0 || T < 1 || T > kMaxSteps) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const bf16* xb = reinterpret_cast<const bf16*>(x);
  uint16_t* code = reinterpret_cast<uint16_t*>(codes);
  if (T <= sgemm::kMaxT) {
    encoder_code_train_kernel<1><<<R, kCodeThreads, 0, s>>>(xb, code, D, T);
  } else {
    encoder_code_train_kernel<2><<<R, kCodeThreads, 0, s>>>(xb, code, D, T);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sgemm_host::launch_steps<128, 8, sgemm::StoreBF16T>(
      w6, rep, codes, R, D, T, sgemm::StoreBF16::Params{reinterpret_cast<bf16*>(out), rep}, s);
}
