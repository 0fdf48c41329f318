// Box-head encoder + fc6 for all T steps, for Hopper (bf16 operands, f32
// results).
//
// Replaces the TPU kernel snn/pallas_fc6.py (_encoder_fc6_kernel, launched
// by encoder_fc6_pallas): cur6[t] = z_t @ w6 for t < T, where z_t are the
// constant-current encoder's spikes of the flattened RoI features x, from
// the closed-form period p = 1 + sum_m [x * (1 - a^m) <= 0.25]:
// z_t = ((t + 1) % p == 0). Optionally the per-row encoder spike counts.
//
// What bounds it on this card: the T products of [R, 12544] x [12544, 1024]
// (0.6 TFLOP at R = 2000, T = 12) put a floor of about 1.3 ms on the
// tensor cores, but the T accumulator tiles of each warp (243 registers)
// leave one block of 8 warps per SM, so latency and the spike generation
// (T spikes per element, redone by each of the 16 column blocks) bound it.
// The 98 MB f32 output is written once.
//
// Design: the [T, R, 12544] spike tensor is never materialised. A block
// owns 32 rows x 64 output columns for ALL T steps: its T accumulator tiles
// stay in registers (one 16x16 tile per warp and step) while it walks the
// 12544-long k axis in chunks of 32. Per chunk it turns the x tile into
// periods and the periods into T spike tiles in shared memory by a
// countdown (compare, select, add; no integer division), and each 16x16
// w6 fragment feeds T tensor-core products, so the weights are read once
// per row tile instead of once per step. The next chunk's x values and w6
// tile are loaded into registers while the tensor cores run on this one;
// the w6 tile then goes to shared memory in coalesced 16-byte rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kMaxT = 16;
constexpr int kBR = 32;      // rows per block
constexpr int kBC = 64;      // output columns per block
constexpr int kKC = 32;      // k chunk
constexpr int kLda = 40;     // spike tile row stride (80 B; 16-row offsets stay 32 B aligned)
constexpr int kLdb = kBC + 8;  // w6 tile row stride (144 B; fragment pointers stay 32 B aligned)
constexpr int kThreads = 256;

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

__global__ void __launch_bounds__(kThreads, 1)
encoder_fc6_kernel(const __nv_bfloat16* __restrict__ x,    // [R, D]
                   const __nv_bfloat16* __restrict__ w6,   // [D, rep]
                   const float* __restrict__ thr_g,        // [T]
                   float* __restrict__ out,                // [T, R, rep]
                   int* __restrict__ counts,               // [R] or null
                   int R, int D, int rep, int T) {
  __shared__ __align__(128) __nv_bfloat16 zbuf[kMaxT][kBR][kLda];
  __shared__ __align__(128) __nv_bfloat16 wbuf[kKC][kLdb];
  __shared__ float thr[kMaxT];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kBR;
  const int col0 = blockIdx.y * kBC;
  const int rf = warp >> 2;         // row fragment 0..1
  const int cf = warp & 3;          // column fragment 0..3
  const bool count_rows = counts != nullptr && blockIdx.y == 0;
  // This thread's 16-byte share of a 32 x 64 w6 chunk.
  const int wrow = tid >> 3;
  const int wcol = (tid & 7) * 8;

  if (tid < T) thr[tid] = thr_g[tid];

  Acc acc[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) wmma::fill_fragment(acc[t], 0.0f);

  // Element e = tid + 256 j of a 32 x 32 x chunk: row warp + 8 j, column
  // lane. Rows past R never spike.
  int cnt[4] = {0, 0, 0, 0};
  const __nv_bfloat16 one = __float2bfloat16(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  __nv_bfloat16 xr[4];
  uint4 wr;
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = row0 + warp + 8 * j;
      xr[j] = gr < R ? x[(int64_t)gr * D + k0 + lane] : zero;
    }
    wr = *reinterpret_cast<const uint4*>(w6 + (int64_t)(k0 + wrow) * rep + col0 + wcol);
  };
  load_chunk(0);

  for (int k0 = 0; k0 < D; k0 += kKC) {
    __syncthreads();  // the previous chunk's products are done with zbuf, wbuf
    *reinterpret_cast<uint4*>(&wbuf[wrow][wcol]) = wr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = warp + 8 * j;
      int p = T + 1;
      if (row0 + r < R) {
        const float xf = __bfloat162float(xr[j]);
        p = 1;
        for (int m = 0; m < T; ++m) p += (xf * thr[m] <= 0.25f) ? 1 : 0;
      }
      // z_t = ((t + 1) % p == 0): spikes at t + 1 = p, 2p, ...
      int next = p;
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        if (t < T) {
          const bool s = (t + 1 == next);
          zbuf[t][r][lane] = s ? one : zero;
          next += s ? p : 0;
          cnt[j] += s ? 1 : 0;
        }
      }
    }
    __syncthreads();
    if (k0 + kKC < D) load_chunk(k0 + kKC);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      FragB b;
      wmma::load_matrix_sync(b, &wbuf[ks * 16][cf * 16], kLdb);
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        if (t < T) {
          FragA a;
          wmma::load_matrix_sync(a, &zbuf[t][rf * 16][ks * 16], kLda);
          wmma::mma_sync(acc[t], a, b, acc[t]);
        }
      }
    }
  }

  if (count_rows) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int c = cnt[j];
      for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
      const int gr = row0 + warp + 8 * j;
      if (lane == 0 && gr < R) counts[gr] = c;
    }
  }

  const int fr0 = row0 + rf * 16;
  const int fc0 = col0 + cf * 16;
  if (row0 + kBR <= R) {  // uniform across the block
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < T) {
        wmma::store_matrix_sync(out + ((int64_t)t * R + fr0) * rep + fc0, acc[t], rep,
                                wmma::mem_row_major);
      }
    }
  } else {
    // Ragged last row tile: stage each 16x16 tile in this warp's share of
    // the (now idle) spike buffer and copy the rows that exist.
    __syncthreads();
    float* stage = reinterpret_cast<float*>(&zbuf[0][0][0]) + warp * 256;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < T) {
        wmma::store_matrix_sync(stage, acc[t], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = fr0 + e / 16;
          if (r < R) out[((int64_t)t * R + r) * rep + fc0 + e % 16] = stage[e];
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

// x [R, D] bf16, w6 [D, rep] bf16, thr [T] f32 (thresholds 1 - a^m),
// out [T, R, rep] f32, counts [R] int32 encoder spikes per row (may be
// null). Requires D % 32 == 0, rep % 64 == 0, T <= 16.
extern "C" int encoder_fc6_bf16(const void* x, const void* w6, const float* thr,
                                float* out, int* counts, int R, int D, int rep, int T,
                                void* stream) {
  if (R <= 0 || D % kKC != 0 || rep % kBC != 0 || T < 1 || T > kMaxT ||
      rep / kBC > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((R + kBR - 1) / kBR, rep / kBC);
  encoder_fc6_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const __nv_bfloat16*>(w6), thr, out, counts, R, D, rep, T);
  return (int)cudaGetLastError();
}
