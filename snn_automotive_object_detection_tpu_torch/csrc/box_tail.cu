// Spiking box-head tail for Hopper: LIF6 -> fc7 -> LIF7 -> cls/bbox LI
// readouts over T steps (bf16 operands, f32 neuron states).
//
// Replaces the TPU kernel snn/pallas_tail.py (_tail_kernel, launched by
// box_tail_pallas). Per step t, with norse-0.0.7 ordering:
//   s6 = LIF6(cur6[t]);  s7 = LIF7(bf16(s6 @ w7));
//   LI_cls(bf16(s7 @ wc)); LI_bbox(bf16(s7 @ wb))
// and the final LI membranes are the class logits and box deltas; the
// fc6/fc7 spike counts per row are optional.
//
// What bounds it on this card: fc7 needs the whole 1024-wide s6 row of a
// RoI at every step, and the state of a row is 16 KB of f32 (v, i of two
// LIF layers), so a block can hold few rows; each block then re-reads the
// 2 MB fc7 weight from L2 at every step. The arithmetic (0.05 TFLOP at
// R = 2000, T = 12) is small.
//
// Design: a block owns 8 whole rows for all T steps, with their LIF states
// (128 KB) and the step's spikes in shared memory, so no state goes back
// to device memory between steps. fc7 runs on the tensor cores as WMMA
// bf16 m8n32k16 products (each of the 8 warps owns 128 output columns);
// its f32 result is staged in shared memory, rounded to bf16 and fed to
// LIF7. The two small readouts (45 columns) are one dot product per
// (row, column) and thread, followed by that thread's LI update, so every
// state element has one owner.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kTR = 8;          // rows per block
constexpr int kRep = 1024;      // representation size
constexpr int kLds = kRep + 8;  // spike row stride (bf16), breaks bank conflicts
constexpr int kMaxOut = 64;     // n_cls + n_reg
constexpr int kThreads = 256;

constexpr size_t kStateBytes = (size_t)kTR * kRep * 4;     // one f32 plane
constexpr size_t kSpikeOff = 5 * kStateBytes;              // v6 i6 v7 i7 stage
constexpr size_t kLiOff = kSpikeOff + (size_t)kTR * kLds * 2;
constexpr size_t kSmemBytes = kLiOff + 2 * (size_t)kTR * kMaxOut * 4;

using Acc = wmma::fragment<wmma::accumulator, 8, 32, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 8, 32, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 8, 32, 16, __nv_bfloat16, wmma::row_major>;

__device__ __forceinline__ float lif_step(float& v, float& i, float cur) {
  // lif_feed_forward_step: decay v with the OLD i, decay i, spike on the
  // decayed v, reset, THEN add the input current.
  const float vd = v + 0.1f * ((0.0f - v) + i);
  const float id = i + (-0.2f) * i;
  const float z = ((vd - 0.1f) > 0.0f) ? 1.0f : 0.0f;
  v = (1.0f - z) * vd;
  i = id + cur;
  return z;
}

__global__ void __launch_bounds__(kThreads, 1)
box_tail_kernel(const __nv_bfloat16* __restrict__ cur6,  // [T, R, rep]
                const __nv_bfloat16* __restrict__ w7,    // [rep, rep]
                const __nv_bfloat16* __restrict__ wro,   // [rep, n_out] cls|bbox
                float* __restrict__ out,                 // [R, n_out]
                int* __restrict__ counts,                // [R, 2] or null
                int R, int T, int n_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* v6 = reinterpret_cast<float*>(smem);
  float* i6 = v6 + kTR * kRep;
  float* v7 = i6 + kTR * kRep;
  float* i7 = v7 + kTR * kRep;
  float* stage = i7 + kTR * kRep;
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem + kSpikeOff);
  float* liv = reinterpret_cast<float*>(smem + kLiOff);
  float* lii = liv + kTR * kMaxOut;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kTR;

  for (int e = tid; e < kTR * kRep; e += kThreads) {
    v6[e] = 0.f; i6[e] = 0.f; v7[e] = 0.f; i7[e] = 0.f;
  }
  for (int e = tid; e < kTR * kMaxOut; e += kThreads) {
    liv[e] = 0.f; lii[e] = 0.f;
  }
  // Each thread owns the elements e = tid + 256 k (k = 0..31) of the
  // 8 x 1024 plane, which lie in row k / 4.
  int c6[kTR] = {0, 0, 0, 0, 0, 0, 0, 0};
  int c7[kTR] = {0, 0, 0, 0, 0, 0, 0, 0};
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // LIF6 on this step's fc6 currents.
#pragma unroll
    for (int k = 0; k < kTR * kRep / kThreads; ++k) {
      const int e = tid + kThreads * k;
      const int r = e / kRep;
      const int c = e % kRep;
      const float cur = (row0 + r < R)
          ? __bfloat162float(cur6[((int64_t)t * R + row0 + r) * kRep + c]) : 0.0f;
      const float z = lif_step(v6[e], i6[e], cur);
      sp[r * kLds + c] = __float2bfloat16(z);
      c6[k / 4] += (int)z;
    }
    __syncthreads();

    // fc7 on the tensor cores: warp w owns columns [128 w, 128 w + 128).
    {
      Acc acc[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.0f);
      for (int kc = 0; kc < kRep / 16; ++kc) {
        FragA a;
        wmma::load_matrix_sync(a, sp + kc * 16, kLds);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          FragB b;
          wmma::load_matrix_sync(b, w7 + (int64_t)kc * 16 * kRep + warp * 128 + f * 32, kRep);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::store_matrix_sync(stage + warp * 128 + f * 32, acc[f], kRep,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    // LIF7 on the bf16-rounded fc7 currents; its spikes replace s6.
#pragma unroll
    for (int k = 0; k < kTR * kRep / kThreads; ++k) {
      const int e = tid + kThreads * k;
      const int r = e / kRep;
      const int c = e % kRep;
      const float cur = __bfloat162float(__float2bfloat16_rn(stage[e]));
      const float z = lif_step(v7[e], i7[e], cur);
      sp[r * kLds + c] = __float2bfloat16(z);
      c7[k / 4] += (int)z;
    }
    __syncthreads();

    // Readouts + LI, one (row, column) per thread.
    for (int o = tid; o < kTR * n_out; o += kThreads) {
      const int r = o / n_out;
      const int j = o % n_out;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < kRep; c += 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          part[q] = part[q] + __bfloat162float(sp[r * kLds + c + q]) *
                                  __bfloat162float(wro[(c + q) * n_out + j]);
        }
      }
      const float sum = (part[0] + part[1]) + (part[2] + part[3]);
      const float cur = __bfloat162float(__float2bfloat16_rn(sum));
      const int s = r * kMaxOut + j;
      const float ij = lii[s] + cur;
      liv[s] = liv[s] + 0.1f * ((0.0f - liv[s]) + ij);
      lii[s] = ij + (-0.2f) * ij;
    }
    __syncthreads();
  }

  for (int o = tid; o < kTR * n_out; o += kThreads) {
    const int r = o / n_out;
    const int j = o % n_out;
    if (row0 + r < R) out[(int64_t)(row0 + r) * n_out + j] = liv[r * kMaxOut + j];
  }
  if (counts != nullptr) {
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      int a = c6[r], b = c7[r];
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_down_sync(0xffffffffu, a, off);
        b += __shfl_down_sync(0xffffffffu, b, off);
      }
      if (lane == 0 && row0 + r < R) {
        atomicAdd(counts + 2 * (row0 + r), a);
        atomicAdd(counts + 2 * (row0 + r) + 1, b);
      }
    }
  }
}

}  // namespace

// cur6 [T, R, 1024] bf16; w7 [1024, 1024] bf16; wro [1024, n_out] bf16 (the
// cls columns then the bbox columns); out [R, n_out] f32 final LI
// membranes; counts [R, 2] int32 fc6/fc7 spikes per row, zeroed by the
// caller (may be null).
extern "C" int box_tail_bf16(const void* cur6, const void* w7, const void* wro, float* out,
                             int* counts, int R, int T, int n_out, void* stream) {
  if (R <= 0 || T < 1 || n_out < 1 || n_out > kMaxOut) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      box_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  box_tail_kernel<<<(R + kTR - 1) / kTR, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(cur6),
      reinterpret_cast<const __nv_bfloat16*>(w7),
      reinterpret_cast<const __nv_bfloat16*>(wro), out, counts, R, T, n_out);
  return (int)cudaGetLastError();
}
