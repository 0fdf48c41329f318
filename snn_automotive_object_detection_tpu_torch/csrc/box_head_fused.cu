// The whole spiking box head in one launch, for Hopper (bf16 operands, f32
// accumulators and neuron states).
//
// Replaces the TPU kernel snn/pallas_kernels.py (_head_kernel, launched by
// fastrcnn_snn_pallas). From the encoder's spike periods p of the flattened
// RoI features (closed form, computed by the caller; 255 = never), for
// every step t < T:
//   z_t  = ((t + 1) % p == 0)
//   s6_t = LIF6(z_t @ w6)          the f32 sum goes into the neuron as it is
//   s7_t = LIF7(s6_t @ w7)
//   LI_cls(s7_t @ wc); LI_bbox(s7_t @ wb)
// with  LIF: vd = v + 0.1 (i - v); id = i - 0.2 i; z = vd > 0.1;
//            v = (1 - z) vd; i = id + cur
//       LI:  ij = i + cur; v = v + 0.1 (ij - v); i = ij - 0.2 ij
// and the last LI membranes are the class logits and box deltas; the fc6
// and fc7 spike counts per row go out too. No product is rounded to bf16
// between the layers (the two-kernel route of encoder_fc6.cu and
// box_tail.cu rounds the fc6 current, the fc7 current and the readouts).
//
// What bounds it on this card: the T products [R, 12544] x [12544, 1024]
// (0.6 TFLOP at R = 2000, T = 12) on the tensor cores, as in
// encoder_fc6.cu; next fc7, which needs the whole 1024-wide s6 row of a
// RoI. The TPU kernel holds a 128-row tile's states in on-chip memory and
// streams the 25.7 MB fc6 weight once per tile and step; here the weight
// stays in the 50 MB L2 and a block's shared memory (227 KB) cannot hold a
// row tile's fc6 state for all 1024 columns.
//
// Design: the encoder is closed-form, so the fc6 currents of all T steps
// depend on no neuron state, and LIF6 is elementwise. One cooperative
// launch runs two phases with one grid-wide barrier between them; every
// block is resident (the grid is what the card holds at once) and walks
// its share of each phase's tiles.
//   phase 1  a tile is 32 rows x 64 fc6 columns for ALL T steps: T
//            accumulator tiles per warp in registers while the block walks
//            the k axis (the spikes of a chunk are rebuilt from the periods
//            by a countdown; each w6 fragment feeds T products, so the
//            weight is read once per row tile, not once per step). Then
//            LIF6 runs over the T accumulators in registers, and only its
//            bf16 spikes go to a scratch in global memory
//            ([T, R padded to 32, 1024], which the L2 mostly holds).
//   barrier  a counter in global memory that every block increments and
//            then polls.
//   phase 2  a tile is 8 whole rows for all T steps, as in box_tail.cu:
//            per step the rows' s6 spikes come in from the scratch, fc7
//            runs on the tensor cores (m8n32k16), LIF7's state lives in
//            shared memory, and each (row, readout column) has one thread
//            that takes the dot product and updates its LI neuron.
// So no neuron state leaves the chip's registers and shared memory between
// steps, and the spikes are the only thing that passes between blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kMaxT = 16;
constexpr int kThreads = 256;
constexpr int kRep = 1024;       // representation size

// Phase 1.
constexpr int kBR = 32;          // rows per tile
constexpr int kBC = 64;          // fc6 columns per tile
constexpr int kKC = 32;          // k chunk
constexpr int kLda = 40;         // spike tile row stride (80 B; 16-row offsets stay 32 B aligned)
constexpr int kLdb = kBC + 8;    // w6 tile row stride (144 B; fragment pointers stay 32 B aligned)
constexpr int kZBufBytes = kMaxT * kBR * kLda * 2;
constexpr int kPhase1Bytes = kZBufBytes + kKC * kLdb * 2;
static_assert((kThreads / 32) * 256 * 4 <= kZBufBytes, "LIF6 staging reuses the spike tiles");

// Phase 2.
constexpr int kTR = 8;           // rows per tile
constexpr int kLds = kRep + 8;   // spike row stride (bf16), breaks bank conflicts
constexpr int kMaxOut = 64;      // n_cls + n_reg
constexpr int kStateBytes = kTR * kRep * 4;             // one f32 plane
constexpr int kSpikeOff = 3 * kStateBytes;              // v7 i7 stage
constexpr int kLiOff = kSpikeOff + kTR * kLds * 2;
constexpr int kPhase2Bytes = kLiOff + 2 * kTR * kMaxOut * 4;

constexpr int kSmemBytes = kPhase1Bytes > kPhase2Bytes ? kPhase1Bytes : kPhase2Bytes;
static_assert(kSmemBytes <= 232448, "shared memory of one block");

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using Acc7 = wmma::fragment<wmma::accumulator, 8, 32, 16, float>;
using FragA7 = wmma::fragment<wmma::matrix_a, 8, 32, 16, __nv_bfloat16, wmma::row_major>;
using FragB7 = wmma::fragment<wmma::matrix_b, 8, 32, 16, __nv_bfloat16, wmma::row_major>;

__device__ __forceinline__ float lif_step(float& v, float& i, float cur) {
  const float vd = v + 0.1f * (i - v);
  const float id = i - 0.2f * i;
  const float z = (vd > 0.1f) ? 1.0f : 0.0f;
  v = (1.0f - z) * vd;
  i = id + cur;
  return z;
}

// Every block of the grid arrives, then every block leaves; what a block
// wrote to global memory before is visible to all after. The launch is
// cooperative, so all blocks are resident and the poll cannot starve one.
__device__ __forceinline__ void grid_barrier(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (atomicAdd(counter, 0u) < gridDim.x) __nanosleep(100);
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
box_head_fused_kernel(const uint8_t* __restrict__ per,        // [R, D] encoder periods
                      const __nv_bfloat16* __restrict__ w6,   // [D, rep]
                      const __nv_bfloat16* __restrict__ w7,   // [rep, rep]
                      const __nv_bfloat16* __restrict__ wro,  // [rep, n_out] cls|bbox
                      __nv_bfloat16* s6,                      // [T, Rp, rep] scratch
                      float* __restrict__ out,                // [R, n_out]
                      int* __restrict__ counts,               // [R, 2] fc6, fc7; zeroed
                      unsigned int* barrier,                  // zeroed
                      int R, int Rp, int D, int T, int n_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const __nv_bfloat16 one = __float2bfloat16(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  // ------------------------------------------------------------- phase 1
  {
    auto zbuf = reinterpret_cast<__nv_bfloat16(*)[kBR][kLda]>(smem);              // [kMaxT]
    auto wbuf = reinterpret_cast<__nv_bfloat16(*)[kLdb]>(smem + kZBufBytes);      // [kKC]
    const int rf = warp >> 2;          // row fragment 0..1
    const int cf = warp & 3;           // column fragment 0..3
    const int wrow = tid >> 3;         // this thread's 16 bytes of a 32 x 64 w6 chunk
    const int wcol = (tid & 7) * 8;
    const int n_cb = kRep / kBC;
    const int n_tiles = (Rp / kBR) * n_cb;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row0 = (tile / n_cb) * kBR;
      const int col0 = (tile % n_cb) * kBC;

      Acc acc[kMaxT];
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) wmma::fill_fragment(acc[t], 0.0f);

      // Element tid + 256 j of a 32 x 32 period chunk: row warp + 8 j,
      // column lane. Rows past R never spike.
      uint8_t pr[4];
      uint4 wr;
      auto load_chunk = [&](int k0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gr = row0 + warp + 8 * j;
          pr[j] = gr < R ? per[(int64_t)gr * D + k0 + lane] : (uint8_t)255;
        }
        wr = *reinterpret_cast<const uint4*>(w6 + (int64_t)(k0 + wrow) * kRep + col0 + wcol);
      };
      load_chunk(0);

      for (int k0 = 0; k0 < D; k0 += kKC) {
        __syncthreads();  // the previous chunk's products (or LIF6) are done with the buffers
        *reinterpret_cast<uint4*>(&wbuf[wrow][wcol]) = wr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = warp + 8 * j;
          const int p = pr[j];
          // z_t = ((t + 1) % p == 0): spikes at t + 1 = p, 2p, ...
          int next = p;
#pragma unroll
          for (int t = 0; t < kMaxT; ++t) {
            if (t < T) {
              const bool s = (t + 1 == next);
              zbuf[t][r][lane] = s ? one : zero;
              next += s ? p : 0;
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

      // LIF6 over the T accumulators of this warp's 16 x 16 tile. Each f32
      // tile goes through this warp's staging area; lane l then owns
      // elements l + 32 j (row 2 j + l / 16, column l % 16) and their state.
      __syncthreads();  // every warp is done with the spike tiles
      float* stage = reinterpret_cast<float*>(smem) + warp * 256;
      float v[8], cu[8];
      int cnt[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = 0.0f;
        cu[j] = 0.0f;
        cnt[j] = 0;
      }
      const int fr0 = row0 + rf * 16 + (lane >> 4);
      const int fc0 = col0 + cf * 16 + (lane & 15);
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        if (t < T) {
          wmma::store_matrix_sync(stage, acc[t], 16, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float z = lif_step(v[j], cu[j], stage[lane + 32 * j]);
            s6[((int64_t)t * Rp + fr0 + 2 * j) * kRep + fc0] = (z != 0.0f) ? one : zero;
            cnt[j] += (int)z;
          }
          __syncwarp();
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int c = cnt[j];
        for (int o = 8; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
        if ((lane & 15) == 0 && fr0 + 2 * j < R && c != 0) atomicAdd(counts + 2 * (fr0 + 2 * j), c);
      }
    }
  }

  grid_barrier(barrier);

  // ------------------------------------------------------------- phase 2
  float* v7 = reinterpret_cast<float*>(smem);
  float* i7 = v7 + kTR * kRep;
  float* stage = i7 + kTR * kRep;
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem + kSpikeOff);
  float* liv = reinterpret_cast<float*>(smem + kLiOff);
  float* lii = liv + kTR * kMaxOut;

  for (int row0 = blockIdx.x * kTR; row0 < R; row0 += gridDim.x * kTR) {
    __syncthreads();  // the previous tile is done with the buffers
    for (int e = tid; e < kTR * kRep; e += kThreads) {
      v7[e] = 0.f;
      i7[e] = 0.f;
    }
    for (int e = tid; e < kTR * kMaxOut; e += kThreads) {
      liv[e] = 0.f;
      lii[e] = 0.f;
    }
    // Each thread owns the elements e = tid + 256 k (k = 0..31) of the
    // 8 x 1024 plane, which lie in row k / 4.
    int c7[kTR] = {0, 0, 0, 0, 0, 0, 0, 0};

    for (int t = 0; t < T; ++t) {
      // This step's s6 rows (rows up to Rp exist and are zero past R).
      for (int q = tid; q < kTR * kRep / 8; q += kThreads) {
        const int r = q / (kRep / 8);
        const int c = (q % (kRep / 8)) * 8;
        *reinterpret_cast<uint4*>(sp + r * kLds + c) = __ldcg(
            reinterpret_cast<const uint4*>(s6 + ((int64_t)t * Rp + row0 + r) * kRep + c));
      }
      __syncthreads();

      // fc7 on the tensor cores: warp w owns columns [128 w, 128 w + 128).
      {
        Acc7 acc[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.0f);
        for (int kc = 0; kc < kRep / 16; ++kc) {
          FragA7 a;
          wmma::load_matrix_sync(a, sp + kc * 16, kLds);
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            FragB7 b;
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

      // LIF7 on the f32 fc7 currents; its spikes replace s6.
#pragma unroll
      for (int k = 0; k < kTR * kRep / kThreads; ++k) {
        const int e = tid + kThreads * k;
        const float z = lif_step(v7[e], i7[e], stage[e]);
        sp[(e / kRep) * kLds + e % kRep] = (z != 0.0f) ? one : zero;
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
        const float cur = (part[0] + part[1]) + (part[2] + part[3]);
        const int s = r * kMaxOut + j;
        const float ij = lii[s] + cur;
        liv[s] = liv[s] + 0.1f * (ij - liv[s]);
        lii[s] = ij - 0.2f * ij;
      }
      __syncthreads();
    }

    for (int o = tid; o < kTR * n_out; o += kThreads) {
      const int r = o / n_out;
      const int j = o % n_out;
      if (row0 + r < R) out[(int64_t)(row0 + r) * n_out + j] = liv[r * kMaxOut + j];
    }
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      int c = c7[r];
      for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
      if (lane == 0 && row0 + r < R && c != 0) atomicAdd(counts + 2 * (row0 + r) + 1, c);
    }
  }
}

}  // namespace

// per [R, D] uint8 encoder periods (255 = never); w6 [D, 1024] bf16; w7
// [1024, 1024] bf16; wro [1024, n_out] bf16 (the cls columns then the bbox
// columns); s6 [T, Rp, 1024] bf16 scratch with Rp = R rounded up to 32;
// out [R, n_out] f32 final LI membranes; counts [R, 2] int32 fc6 and fc7
// spikes per row and barrier [1] uint32, both zeroed by the caller.
// Requires D % 32 == 0, T <= 16, n_out <= 64.
extern "C" int box_head_fused_bf16(const void* per, const void* w6, const void* w7,
                                   const void* wro, void* s6, float* out, int* counts,
                                   void* barrier, int R, int D, int T, int n_out, void* stream) {
  if (R <= 0 || D <= 0 || D % kKC != 0 || T < 1 || T > kMaxT || n_out < 1 || n_out > kMaxOut) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      box_head_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, box_head_fused_kernel, kThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  int Rp = (R + kBR - 1) / kBR * kBR;
  const int n_tiles = (Rp / kBR) * (kRep / kBC);   // phase 1 has the most tiles
  int grid = sms * per_sm < n_tiles ? sms * per_sm : n_tiles;
  void* args[] = {(void*)&per, (void*)&w6, (void*)&w7, (void*)&wro, (void*)&s6, (void*)&out,
                  (void*)&counts, (void*)&barrier, (void*)&R, (void*)&Rp, (void*)&D,
                  (void*)&T, (void*)&n_out};
  err = cudaLaunchCooperativeKernel((const void*)box_head_fused_kernel, dim3(grid),
                                    dim3(kThreads), args, (size_t)kSmemBytes,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
