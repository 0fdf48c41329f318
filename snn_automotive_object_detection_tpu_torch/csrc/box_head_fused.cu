// The whole spiking box head in one call, for Hopper (bf16 operands, f32
// sums and neuron states).
//
// Replaces the TPU kernel snn/pallas_kernels.py (_head_kernel, launched by
// fastrcnn_snn_pallas). From the encoder's spike periods p of the flattened
// RoI features (closed form, computed by the caller; 255 = never), for
// every step t < T:
//   z_t  = ((t + 1) % p == 0)
//   s6_t = LIF6(z_t @ w6)          the f32 sum goes into the neuron as it is
//   s7_t = LIF7(s6_t @ w7)
//   LI_cls(s7_t @ wc); LI_bbox(s7_t @ wb)
// with  LIF: vd = v + 0.1 ((0 - v) + i); id = i - 0.2 i; z = vd - 0.1 > 0;
//            v = (1 - z) vd; i = id + cur
//       LI:  ij = i + cur; v = v + 0.1 ((0 - v) + ij); i = ij - 0.2 ij
// and the last LI membranes are the class logits and box deltas; the fc6
// and fc7 spike counts per row go out too. No sum is rounded to bf16
// between the layers (the two-kernel route of encoder_fc6.cu and
// box_tail.cu rounds the fc6 current, the fc7 current and the readouts).
//
// What bounds it on this card: the fc6 products, [T R, 12544] x [12544,
// 1024] (0.617 dense TFLOP at R = 2000, T = 12), on the tensor cores, as
// in encoder_fc6.cu; next, the weight slices each row tile streams from L2.
//
// Design: the encoder is closed-form and nothing in the head is recurrent
// across neurons, so each layer is one GEMM over all T steps followed by a
// scan over t per (row, column), and the head runs as four passes of one
// call, three of them the spike-code GEMM of spike_gemm.cuh:
//   (a) the periods [R, K] uint8 to spike-train codes [R, K] uint16 (bit t
//       set when the element spikes at step t), by a table of the 256
//       periods;
//   (b) fc6: the GEMM on w6 (an 8-stage TMA ring, two-block clusters) with
//       an f32 LIF epilogue: the block's 16 rows x T steps x 128 columns of
//       f32 sums are staged in the drained ring, LIF6 runs over t per
//       (row, column) and writes the s6 codes and adds the fc6 spikes of
//       each row (integer atomics, order-free);
//   (c) fc7: the same on the s6 codes and w7, writing s7 codes and the fc7
//       spikes;
//   (d) the readout: the GEMM at n64 on wro = cls|bbox (columns past n_out
//       read zero weights) with an f32 LI epilogue.
// So the only intermediates in device memory are the codes (two bytes per
// neuron for up to 16 steps); no current and no spike plane is stored. For
// T > 16 the codes are ceil(T / 16) planes (plane h: steps 16 h .. 16 h +
// 15) and each GEMM pass runs as one launch per plane
// (sgemm_host::launch_steps), each starting from the LIF or LI states the
// one before stored (f32, [2][R][1024]).

#include "spike_gemm.cuh"

namespace {

constexpr int kRep = 1024;        // representation size
constexpr int kMaxOut = 64;       // n_cls + n_reg: one n64 column tile
constexpr int kCodeThreads = 256;
// Steps of a train: the periods are uint8 with 255 for "never", so a step
// t + 1 = 255 would read a spike; 254 steps are 16 planes.
constexpr int kMaxSteps = 254;
constexpr int kMaxPlanes = (kMaxSteps + sgemm::kMaxT - 1) / sgemm::kMaxT;

// Periods to codes, 8 elements a thread: in plane h, code[p] has bit
// k - 1 - 16 h set for each k = p, 2p, ... up to T within steps 16 h + 1 ..
// 16 h + 16 (period 0 does not occur; it gets no bits). Plane h lies R K
// elements after plane h - 1.
__global__ void __launch_bounds__(kCodeThreads)
period_code_kernel(const uint8_t* __restrict__ per,   // [R, K]
                   uint16_t* __restrict__ code,       // [planes, R, K]
                   int64_t n8, int T) {
  __shared__ uint16_t table[kMaxPlanes][256];
  const int n_planes = (T + sgemm::kMaxT - 1) / sgemm::kMaxT;
  for (int h = 0; h < n_planes; ++h) {
    const int p = threadIdx.x;
    uint32_t bits = 0u;
    for (int k = p; p > 0 && k <= T; k += p) {
      if (k > 16 * h && k <= 16 * h + 16) bits |= 1u << (k - 1 - 16 * h);
    }
    table[h][p] = (uint16_t)bits;
  }
  __syncthreads();
  for (int64_t q = (int64_t)blockIdx.x * kCodeThreads + threadIdx.x; q < n8;
       q += (int64_t)gridDim.x * kCodeThreads) {
    const uint2 raw = reinterpret_cast<const uint2*>(per)[q];
    const uint8_t* p8 = reinterpret_cast<const uint8_t*>(&raw);
    for (int h = 0; h < n_planes; ++h) {
      uint4 o;
      o.x = table[h][p8[0]] | (uint32_t)table[h][p8[1]] << 16;
      o.y = table[h][p8[2]] | (uint32_t)table[h][p8[3]] << 16;
      o.z = table[h][p8[4]] | (uint32_t)table[h][p8[5]] << 16;
      o.w = table[h][p8[6]] | (uint32_t)table[h][p8[7]] << 16;
      *reinterpret_cast<uint4*>(code + 8 * (h * n8 + q)) = o;
    }
  }
}

}  // namespace

// per [R, D] uint8 encoder periods (255 = never); w6 [D, 1024] bf16; w7
// [1024, 1024] bf16; wro [1024, ceil8(n_out)] bf16 (the cls columns, the
// bbox columns, then zeros to a multiple of 8 columns: 16-byte rows for
// TMA); out [R, n_out] f32 final LI membranes; counts [R, 2] int32 fc6 and
// fc7 spikes per row, zeroed by the caller; code_x [P, R, D], code6 and
// code7 [P, R, 1024] uint16 scratch with P = ceil(T / 16), the encoder's,
// fc6's and fc7's spike trains (plane h: steps 16 h .. 16 h + 15, bit t - 16 h
// a spike at step t) when the call returns; state [2, R, 1024] f32 scratch
// for T > 16 (unused otherwise). Requires D % 64 == 0, 1 <= T <= 254,
// 1 <= n_out <= 64.
extern "C" int box_head_fused_bf16(const void* per, const void* w6, const void* w7,
                                   const void* wro, float* out, int* counts, void* code_x,
                                   void* code6, void* code7, void* state, int R, int D, int T,
                                   int n_out, void* stream) {
  using namespace sgemm;
  if (R <= 0 || D <= 0 || D % kK != 0 || T < 1 || T > kMaxSteps || n_out < 1 ||
      n_out > kMaxOut) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t n8 = (int64_t)R * D / 8;
  const int64_t blocks = (n8 + kCodeThreads - 1) / kCodeThreads;
  const int grid = (int)(blocks < 1056 ? blocks : 1056);
  const int n_w = (n_out + 7) / 8 * 8;
  period_code_kernel<<<grid, kCodeThreads, 0, s>>>(reinterpret_cast<const uint8_t*>(per),
                                                   reinterpret_cast<uint16_t*>(code_x), n8, T);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  uint16_t* c6 = reinterpret_cast<uint16_t*>(code6);
  uint16_t* c7 = reinterpret_cast<uint16_t*>(code7);
  float* st = reinterpret_cast<float*>(state);
  int code = sgemm_host::launch_steps<128, 8, LifF32CodesT>(
      w6, kRep, code_x, R, D, T, CodesParams{c6, counts, kRep, st}, s);
  if (code != 0) return code;
  code = sgemm_host::launch_steps<128, 8, LifF32CodesT>(
      w7, kRep, code6, R, kRep, T, CodesParams{c7, counts + 1, kRep, st}, s);
  if (code != 0) return code;
  return sgemm_host::launch_steps<64, 8, LiOutF32T>(wro, n_w, code7, R, kRep, T,
                                                    OutParams{out, n_out, st}, s);
}

// Shared memory per block of the fc6 and fc7 passes and of the readout
// pass, into bytes[0] and bytes[1].
extern "C" int box_head_fused_smem(int* bytes) {
  bytes[0] = sgemm_host::smem_bytes<128, 8, sgemm::LifF32Codes>();
  bytes[1] = sgemm_host::smem_bytes<64, 8, sgemm::LiOutF32>();
  return 0;
}
