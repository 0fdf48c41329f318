// Spiking box-head tail for Hopper: LIF6 -> fc7 -> LIF7 -> cls/bbox LI
// readouts over T steps (bf16 operands, f32 neuron states).
//
// Replaces the TPU kernel snn/pallas_tail.py (_tail_kernel, launched by
// box_tail_pallas). Per step t, with norse-0.0.7 ordering:
//   s6 = LIF6(cur6[t]);  s7 = LIF7(bf16(s6 @ w7));
//   LI_cls(bf16(s7 @ wc)); LI_bbox(bf16(s7 @ wb))
// and the final LI membranes are the class logits and box deltas; the
// fc6/fc7 spike counts per row too.
//
// What bounds it on this card: reading the 49 MB of fc6 currents once
// (15 us at 3.35 TB/s); the products are small (0.05 TFLOP for fc7 at
// R = 2000, T = 12, 2.2 GFLOP for the readout).
//
// Design: nothing in the tail is recurrent across neurons. LIF6 reads only
// cur6[:, r, c]; LIF7 reads only fc7's current at (t, r, c); the LI
// readouts the same. So each layer is a GEMM over all T steps at once
// followed by an elementwise scan over t, and the tail runs as three
// passes of one launch of the wrapper:
//   (a) the LIF6 scan: a thread runs 8 neurons of a row over t and writes
//       the spike train of each neuron as a uint16 code (bit t) and the
//       exact fc6 count per row;
//   (b) fc7: the spike-code GEMM of spike_gemm.cuh on w7, whose epilogue
//       rounds each current to bf16, stages the block's 16 rows x T steps
//       x 128 columns in shared memory and runs LIF7 over t, writing s7
//       codes and adding the fc7 counts per row (integer atomics, so the
//       sums do not depend on their order);
//   (c) the readout: the same GEMM at n64 on wro = cls|bbox (columns past
//       n_out read zero weights), whose epilogue rounds each column's
//       current to bf16 on its own, as the separate bf16(s7 @ wc) and
//       bf16(s7 @ wb) do, and runs the LI scan.
// w7 is read from L2 once per row tile (not once per row block and step),
// and the readouts run on the tensor cores.

#include "spike_gemm.cuh"

namespace {

using sgemm::bf16;

constexpr int kLifThreads = 128;

// One block per row; thread tid runs neurons 8 tid .. 8 tid + 7 of each
// 1024 columns.
__global__ void __launch_bounds__(kLifThreads)
lif6_kernel(const bf16* __restrict__ cur6,  // [T, R, rep]
            uint16_t* __restrict__ code6,   // [R, rep]
            int* __restrict__ counts,       // [R, 2]
            int R, int rep, int T) {
  __shared__ int part[kLifThreads / 32];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  int cnt = 0;
  for (int c8 = tid * 8; c8 < rep; c8 += kLifThreads * 8) {
    // Every step's currents first: the loads do not wait for the scan.
    uint4 raw[sgemm::kMaxT];
#pragma unroll
    for (int t = 0; t < sgemm::kMaxT; ++t) {
      if (t < T) raw[t] = *reinterpret_cast<const uint4*>(cur6 + ((int64_t)t * R + row) * rep + c8);
    }
    float v[8], i[8];
    uint32_t code[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = i[e] = 0.0f;
      code[e] = 0u;
    }
#pragma unroll
    for (int t = 0; t < sgemm::kMaxT; ++t) {
      if (t < T) {
        const bf16* cv = reinterpret_cast<const bf16*>(&raw[t]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool z = sgemm::lif_step(v[e], i[e], __bfloat162float(cv[e])) > 0.0f;
          code[e] |= (z ? 1u : 0u) << t;
          cnt += z ? 1 : 0;
        }
      }
    }
    uint4 o;
    o.x = code[0] | code[1] << 16;
    o.y = code[2] | code[3] << 16;
    o.z = code[4] | code[5] << 16;
    o.w = code[6] | code[7] << 16;
    *reinterpret_cast<uint4*>(code6 + row * rep + c8) = o;
  }
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if ((tid & 31) == 0) part[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kLifThreads / 32; ++w) total += part[w];
    counts[2 * row] = total;
  }
}

}  // namespace

// cur6 [T, R, rep] bf16; w7 [rep, rep] bf16; wro [rep, ceil8(n_out)] bf16
// (the cls columns, the bbox columns, then zeros to a multiple of 8
// columns: 16-byte rows); out [R, n_out] f32 final LI membranes; counts
// [R, 2] int32
// fc6/fc7 spikes per row, zeroed by the caller; code6, code7 [R, rep]
// uint16 scratch. Requires rep % 128 == 0, 1 <= T <= 16.
extern "C" int box_tail_bf16(const void* cur6, const void* w7, const void* wro, float* out,
                             int* counts, void* code6, void* code7, int R, int T, int rep,
                             int n_out, void* stream) {
  if (R <= 0 || T < 1 || T > sgemm::kMaxT || rep % 128 != 0 || n_out < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  lif6_kernel<<<R, kLifThreads, 0, s>>>(reinterpret_cast<const bf16*>(cur6),
                                        reinterpret_cast<uint16_t*>(code6), counts, R, rep, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int code = sgemm_host::launch<128, 4, sgemm::LifCodes>(
      w7, rep, code6, R, rep, T,
      sgemm::LifCodes::Params{reinterpret_cast<uint16_t*>(code7), counts, rep}, s);
  if (code != 0) return code;
  return sgemm_host::launch<64, 4, sgemm::LiOut>(wro, (n_out + 7) / 8 * 8, code7, R, rep, T,
                                                 sgemm::LiOut::Params{out, n_out}, s);
}
