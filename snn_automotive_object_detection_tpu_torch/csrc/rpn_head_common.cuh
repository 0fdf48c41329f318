// Device code of the spiking RPN head shared by its paired-image kernel
// (rpn_head_x2.cu, K8), whose block covers the same kTP / 2 pixels of a row
// in each image of a pair, and the neuron helpers that the level kernel
// (rpn_head.cu, K1) and the backward (rpn_head_bwd.cu, K7) take from here:
// lif_element, the LIF update of one neuron in the order every kernel and
// plain version runs it, and step_mask. For the pair: the shared-memory
// layout of a block, the encoder's period map and per-step spike halo (the
// two images' halos side by side), and the 3x3 conv on the tensor cores
// with the tap weights streaming through a cp.async ring.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace rpn {

using namespace nvcuda;

constexpr int kC = 256;            // channels in and out of the 3x3 conv
constexpr int kTP = 32;            // pixels per block (one row segment per image)
constexpr int kLdz = 272;          // spike row stride: 544 B keeps WMMA pointers 32 B aligned
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 32;
constexpr int kMaxOut = 128;       // readout channels (25 anchors)

constexpr int kStageRows = 64;     // tap-weight rows (input channels) per stage
constexpr int kStages = 3;         // ring depth: stage s + 2 loads while s computes
constexpr int kLdw = kC + 8;       // stage row stride: 528 B keeps fragment pointers 32 B aligned
constexpr int kStagesPerStep = 9 * kC / kStageRows;

constexpr int kStageBytes = kStageRows * kLdw * 2;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kVec = 8;                                  // channels per item

// Geometry and shared-memory layout of a block that covers a pair of images.
struct Tile {
  static constexpr int kImgs = 2;
  static constexpr int kPx = kTP / kImgs;                // pixels per image
  static constexpr int kHw = kPx + 2;                    // halo width per image
  static constexpr int kCols = kImgs * kHw;              // halo columns of the block
  static constexpr int kPerBytes = 3 * kCols * kC;       // uint8 periods
  static constexpr int kZBytes = 3 * kCols * kLdz * 2;   // bf16 spikes
  static constexpr int kConstOff = kPerBytes + kZBytes;
  static constexpr int kMaskOff = kConstOff + 2 * kMaxT * 4;
  static constexpr int kWOff = (kMaskOff + kMaxT * 8 + 127) / 128 * 128;
  static constexpr int kSmemBytes = kWOff + kRingBytes;
  static constexpr int kItems = 3 * kCols * kC / kVec;   // items of the halo

  static_assert(kPerBytes % 128 == 0, "spike halo must stay aligned");
  static_assert(kConstOff % 32 == 0 && kStageBytes % 32 == 0, "fragment pointers need 32 B");
  static_assert(kTP * kC * 4 <= kZBytes, "spike-sum staging reuses the spike halo");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

static_assert(kStageRows * kC / 8 % kThreads == 0, "whole 16-byte copies per thread");

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

// One block's shared memory.
struct Smem {
  uint8_t* per;                    // [3][kCols][kC] encoder periods
  __nv_bfloat16* z;                // [3][kCols][kLdz] this step's encoder spikes
  float* thr;                      // [T] encoder thresholds
  float* li;                       // [T] LI readout coefficients
  unsigned long long* spk_mask;    // [T] bit p set when period p spikes at the step
  __nv_bfloat16* ring;             // [kStages][kStageRows][kLdw] tap weights
};

__device__ __forceinline__ Smem carve(unsigned char* smem) {
  using G = Tile;
  Smem s;
  s.per = smem;
  s.z = reinterpret_cast<__nv_bfloat16*>(smem + G::kPerBytes);
  s.thr = reinterpret_cast<float*>(smem + G::kConstOff);
  s.li = s.thr + kMaxT;
  s.spk_mask = reinterpret_cast<unsigned long long*>(smem + G::kMaskOff);
  s.ring = reinterpret_cast<__nv_bfloat16*>(smem + G::kWOff);
  return s;
}

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

// Periods p <= T + 1 that spike at step t (0-based): bit p is set when
// p divides t + 1.
__device__ __forceinline__ unsigned long long step_mask(int t, int T) {
  unsigned long long m = 0;
  for (int p = 1; p <= T + 1; ++p) m |= ((t + 1) % p == 0) ? (1ull << p) : 0ull;
  return m;
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

// The thresholds, the LI coefficients and the step masks. The caller
// synchronises afterwards.
__device__ __forceinline__ void load_constants(const Smem& sm, const float* consts,
                                               int T, int tid) {
  if (tid < T) {
    sm.thr[tid] = consts[tid];
    sm.li[tid] = consts[T + tid];
    sm.spk_mask[tid] = step_mask(tid, T);
  }
}

// Period map of the halo around row y, pixels x0 .. x0 + kPx - 1 of
// images n and n + 1 (3 x 18 each), 8 channels per item:
// p = 1 + sum_m [x * thr[m] <= 0.25]. Outside the image the conv's zero
// padding never spikes: period T + 1.
__device__ __forceinline__ void build_period_map(const Smem& sm, const __nv_bfloat16* feat,
                                                 int n, int y, int x0, int H, int W, int T,
                                                 int tid) {
  using G = Tile;
  for (int q = tid; q < G::kItems; q += kThreads) {
    const int e0 = q * kVec;
    const int row = e0 / (G::kCols * kC);
    const int col = (e0 / kC) % G::kCols;
    const int hp = col % G::kHw;
    const int ch = e0 % kC;
    const int gy = y + row - 1;
    const int gx = x0 + hp - 1;
    uint8_t p8[kVec];
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          feat + (((int64_t)(n + col / G::kHw) * H + gy) * W + gx) * kC + ch);
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
      for (int j = 0; j < kVec; ++j) {
        const float xf = __bfloat162float(xv[j]);
        int p = 1;
        for (int m = 0; m < T; ++m) p += (xf * sm.thr[m] <= 0.25f) ? 1 : 0;
        p8[j] = (uint8_t)p;
      }
    } else {
      for (int j = 0; j < kVec; ++j) p8[j] = (uint8_t)(T + 1);
    }
    *reinterpret_cast<uint2*>(sm.per + e0) = *reinterpret_cast<const uint2*>(p8);
  }
}

// Encoder spikes of the halo at step t, from the period map. Returns this
// thread's count of spikes among the block's own pixels inside the image.
__device__ __forceinline__ int build_spikes(const Smem& sm, int t, int x0, int W, int tid) {
  using G = Tile;
  const __nv_bfloat16 one = __float2bfloat16(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const unsigned long long m_t = sm.spk_mask[t];
  int count = 0;
  for (int q = tid; q < G::kItems; q += kThreads) {
    const int e0 = q * kVec;
    const int row = e0 / (G::kCols * kC);
    const int col = (e0 / kC) % G::kCols;
    const int hp = col % G::kHw;
    const int ch = e0 % kC;
    const uint2 praw = *reinterpret_cast<const uint2*>(sm.per + e0);
    const uint8_t* p8 = reinterpret_cast<const uint8_t*>(&praw);
    __align__(16) __nv_bfloat16 zv[kVec];
    int nz = 0;
    for (int j = 0; j < kVec; ++j) {
      const bool s = (m_t >> p8[j]) & 1ull;
      zv[j] = s ? one : zero;
      nz += s ? 1 : 0;
    }
    *reinterpret_cast<uint4*>(sm.z + (row * G::kCols + col) * kLdz + ch) =
        *reinterpret_cast<const uint4*>(zv);
    if (row == 1 && hp >= 1 && hp <= G::kPx && x0 + hp - 1 < W) count += nz;
  }
  return count;
}

// The first two weight stages of a step; they load while the spikes are
// built (the previous step ended with a barrier, so the ring is free).
__device__ __forceinline__ void prefetch_weights(const Smem& sm, const __nv_bfloat16* w9,
                                                 int tid) {
  load_stage(sm.ring, w9, 0, tid);
  cp_async_commit();
  load_stage(sm.ring, w9, 1, tid);
  cp_async_commit();
}

// 3x3 conv of the spike halo on the tensor cores, the tap weights
// streaming through the ring: warp (img, cg) gets the 16 pixels of image
// img, whose halo begins at column col0 of the spike buffer, and channels
// cg*32 .. +31 as two accumulator fragments. One trip of the ring serves
// every warp of the block.
__device__ __forceinline__ void conv_step(Acc (&acc)[2], const Smem& sm,
                                          const __nv_bfloat16* w9, int tid, int col0, int cg) {
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int st = 0; st < kStagesPerStep; ++st) {
    cp_async_wait_one();  // stage st has landed (for this thread's copies)
    __syncthreads();      // ... for all threads; stage st - 1 is consumed
    load_stage(sm.ring, w9, st + 2, tid);
    cp_async_commit();    // possibly empty, which keeps the group count uniform
    const int k = st / (kC / kStageRows);
    const int dy = k / 3 - 1;
    const int dx = k % 3 - 1;
    const int kc0 = (st % (kC / kStageRows)) * (kStageRows / 16);
    const __nv_bfloat16* a_base =
        sm.z + ((1 + dy) * Tile::kCols + col0 + 1 + dx) * kLdz + kc0 * 16;
    const __nv_bfloat16* b_base = sm.ring + (st % kStages) * (kStageRows * kLdw) + cg * 32;
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
}

// One neuron's LIF step on its conv sum, rounded to bf16 first, and its
// LI-weighted spike sum; vd is the decayed membrane the spike was taken on.
__device__ __forceinline__ bool lif_element(float conv, float lit, float& v, float& cu,
                                            float& ss, float& vd) {
  const float cur = __bfloat162float(__float2bfloat16_rn(conv));
  vd = v + 0.1f * (cu - v);
  const float id = cu - 0.2f * cu;
  const bool s = (vd - 0.1f) > 0.0f;
  v = s ? 0.0f : vd;
  cu = id + cur;
  ss = ss + (s ? lit : 0.0f);
  return s;
}

}  // namespace rpn
