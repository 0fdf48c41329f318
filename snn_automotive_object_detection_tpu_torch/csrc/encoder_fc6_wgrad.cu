// Weight gradient of the box head's fc6 in training, for Hopper (bf16
// cotangent, f32 result), from the spike codes of K3's training instance.
//
// The port's own kernel: the JAX package takes this product from XLA's
// autodiff of its scan. With the features frozen, fc6's only gradient is
//   dW6[d, n] = sum over steps t and RoIs r of z_t[r, d] dcur6[t, r, n],
// where z_t[r, d] in {0, 1} is bit t of the encoder's code (codes [P, R, D]
// uint16, plane h holding steps 16 h .. 16 h + 15; encoder_fc6.cu's training
// instance writes them) and dcur6 [T, R, N] bf16 is the cotangent of fc6's
// currents as autograd hands it over. The spikes are never materialised.
//
// What bounds it on this card: the products, 2 D N T R operations (2.53
// dense TFLOP at D = 12544, N = 1024, T = 12, R = 8192), on the tensor
// cores; the operands are 205 MB of codes and 201 MB of cotangent.
//
// Design: K7's weight gradient (rpn_head_bwd.cu) on other operands. A
// spike-code GEMM on wgmma, M = the D input features, N = the output
// columns, K = (RoI, step) ordered by code plane, then 64-RoI tile, then
// step. A block owns 128 features (two consumer warpgroups of m64n256, 128
// f32 accumulators a thread) x 256 columns over all of K, in one fixed
// order: the result is the same on every run, with no float atomics and
// no partial sums. B is dcur6 as stored ([K, N], MN-major): a producer
// thread streams 64-row stages (64 RoIs of one step) of a 3-D TMA box
// (columns, RoIs, steps) with the 128-byte swizzle into a ring of four,
// read with wgmma's transpose bit; RoIs past R read as zeros. The two
// blocks of a cluster own consecutive feature tiles of the same columns,
// and each loads half of every stage and multicasts it into both. A is
// built in registers: once per 64-RoI tile of a plane the block's codes
// [64 RoIs][128 features] land by TMA in one of two code slots, each
// consumer thread reads the 32 codes of its fragment (two RoIs of one
// feature packed in a word), and for step t of the tile a bf16 pair of A
// is ((pair >> (t - 16 h)) & 0x10001) * 0x3F80, three integer operations.
// Features past D read as zero codes and store nothing.

#include "hopper.cuh"

using namespace hopper;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kK = 64;                        // GEMM k rows per stage: 64 RoIs of one step
constexpr int kMTile = 128;                   // input features per block
constexpr int kNTile = 256;                   // output columns per block
constexpr int kStages = 4;
constexpr int kChunkBytes = kK * 64 * 2;      // one 64 k x 64 column box
constexpr int kBBytes = (kNTile / 64) * kChunkBytes;   // a cotangent stage: 32 KB
constexpr int kCodeBytes = kK * kMTile * 2;   // a code tile: 16 KB
constexpr int kCodeSlots = 2;
constexpr int kPlaneSteps = 16;               // steps of one code plane
constexpr int kMaxT = 2 * kPlaneSteps;
constexpr int kThreads = 384;                 // consumer warpgroups 0 and 1, producer 2
constexpr int kCluster = 2;                   // consecutive feature tiles of the same columns
constexpr int kSmem =
    1024 + kStages * kBBytes + kCodeSlots * kCodeBytes + 2 * (kStages + kCodeSlots) * 8;

static_assert(kBBytes % 1024 == 0 && kCodeBytes % 1024 == 0, "stages start on swizzle atoms");
static_assert(kSmem <= 232448, "shared memory of one block");

__global__ void __launch_bounds__(kThreads, 1)
fc6_weight_grad_kernel(const __grid_constant__ CUtensorMap map_dc,    // dcur6 [T, R, N] bf16
                       const __grid_constant__ CUtensorMap map_code,  // codes [P, R, D] uint16
                       float* __restrict__ dw,                        // [D, N]
                       int R, int D, int N, int T) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* code_slots = ring + kStages * kBBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(code_slots + kCodeSlots * kCodeBytes);
  uint64_t* empty = full + kStages;
  uint64_t* code_full = empty + kStages;
  uint64_t* code_empty = code_full + kCodeSlots;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int d0 = blockIdx.x * kMTile;
  const int n0 = blockIdx.y * kNTile;
  const int r_tiles = (R + kK - 1) / kK;
  const int units = (T + kPlaneSteps - 1) / kPlaneSteps * r_tiles;   // (plane, RoI tile)

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * kCluster);   // one arrival per consumer warp of the cluster
    }
    for (int s = 0; s < kCodeSlots; ++s) {
      mbar_init(&code_full[s], 1);
      mbar_init(&code_empty[s], 8);         // one arrival per consumer warp of this block
    }
    fence_barrier_init();
  }
  cluster_sync();

  if (wg == 2) {
    // ---- Producer: each unit's code tile into this block, then its steps'
    // cotangent stages; block r of the cluster loads column chunks 2r and
    // 2r + 1 of each stage into both blocks.
    reg_dealloc<40>();
    if (tid == 256) {
      const int rank = (int)cluster_rank();
      int s = 0;
      for (int u = 0; u < units; ++u) {
        const int h = u / r_tiles;
        const int r0 = (u % r_tiles) * kK;
        const int cs = u % kCodeSlots;
        mbar_wait(&code_empty[cs], ((u / kCodeSlots) & 1) ^ 1);
        mbar_expect_tx(&code_full[cs], kCodeBytes);
        tma_load_3d(code_slots + cs * kCodeBytes, &map_code, &code_full[cs], d0, r0, h);
        const int t_end = min(T, (h + 1) * kPlaneSteps);
        for (int t = h * kPlaneSteps; t < t_end; ++t, ++s) {
          const int slot = s % kStages;
          mbar_wait(&empty[slot], ((s / kStages) & 1) ^ 1);
          unsigned char* dst = ring + slot * kBBytes;
          mbar_expect_tx(&full[slot], kBBytes);
          for (int c = 2 * rank; c < 2 * rank + 2; ++c) {
            tma_load_3d_multicast(dst + c * kChunkBytes, &map_dc, &full[slot],
                                  (uint16_t)((1 << kCluster) - 1), n0 + 64 * c, r0, t);
          }
        }
      }
      // The tail: every remote release of the ring has landed before the
      // block exits.
      for (int e = s; e < s + kStages; ++e) {
        mbar_wait(&empty[e % kStages], ((e / kStages) & 1) ^ 1);
      }
    }
    return;
  }

  // ---- Consumers.
  reg_alloc<232>();
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int m0 = 64 * wg + 16 * warp + g;   // this thread's A rows (features): m0 and m0 + 8
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

  int s = 0;
  for (int u = 0; u < units; ++u) {
    const int h = u / r_tiles;
    const int cs = u % kCodeSlots;
    mbar_wait(&code_full[cs], (u / kCodeSlots) & 1);
    // Register i of k16 step kk holds RoIs k and k + 1, k = 16 kk + 8 (i / 2)
    // + 2 t4, of feature m0 + 8 (i % 2): their codes as the low and high
    // halves of a word.
    const uint16_t* code = reinterpret_cast<const uint16_t*>(code_slots + cs * kCodeBytes);
    uint32_t pair[kK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 16 * kk + 8 * (i >> 1) + 2 * t4;
        const int m = m0 + 8 * (i & 1);
        pair[kk][i] = (uint32_t)code[k * kMTile + m] | (uint32_t)code[(k + 1) * kMTile + m] << 16;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&code_empty[cs]);
    const int t_end = min(T, (h + 1) * kPlaneSteps);
    for (int t = h * kPlaneSteps; t < t_end; ++t, ++s) {
      const int slot = s % kStages;
      const int bit = t - h * kPlaneSteps;
      uint32_t a[kK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[kk][i] = ((pair[kk][i] >> bit) & 0x10001u) * 0x3F80u;
      }
      mbar_wait(&full[slot], (s / kStages) & 1);
      const uint64_t db = desc_mn_sw128(ring + slot * kBBytes, kChunkBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) wgmma_rs_n256_tb(acc, a[kk], db + kk * 128);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) {
        for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(&empty[slot], r);
      }
    }
  }

  // Element i of the accumulators is feature m0 + 8 ((i / 2) % 2), column
  // 8 (i / 4) + 2 t4 + i % 2.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = d0 + m0 + 8 * h;
    if (d < D) {
      float* out = dw + (int64_t)d * N + n0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (n0 + 8 * j < N) {
          *reinterpret_cast<float2*>(out + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

}  // namespace

// codes [P, R, D] uint16 (P = ceil(T / 16)) from encoder_fc6_train_bf16;
// dc [T, R, N] bf16, the cotangent of its currents; dw [D, N] f32 out.
// Requires D % 8 == 0, N % 128 == 0 and 1 <= T <= 32.
extern "C" int encoder_fc6_wgrad_bf16(const void* codes, const void* dc, float* dw, int R,
                                      int D, int N, int T, void* stream) {
  if (R <= 0 || D <= 0 || D % 8 != 0 || N <= 0 || N % 128 != 0 || T < 1 || T > kMaxT) {
    return (int)cudaErrorInvalidValue;
  }
  // A runtime call first: it makes the card's context current on this
  // thread (autograd's backward thread may have none yet), which
  // cuTensorMapEncodeTiled needs.
  cudaError_t err =
      cudaFuncSetAttribute(fc6_weight_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_dc, map_code;
  const uint64_t dd[3] = {(uint64_t)N, (uint64_t)R, (uint64_t)T};
  const uint32_t db[3] = {64, kK, 1};
  const uint64_t cd[3] = {(uint64_t)D, (uint64_t)R, (uint64_t)((T + kPlaneSteps - 1) / kPlaneSteps)};
  const uint32_t cbox[3] = {kMTile, kK, 1};
  if (!hopper_host::bf16_map(&map_dc, dc, 3, dd, db, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper_host::map_tiled(&map_code, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, codes, 3, cd, cbox,
                              CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return (int)cudaErrorInvalidValue;
  }
  const int m_tiles = (D + kMTile - 1) / kMTile;
  const dim3 grid((m_tiles + kCluster - 1) / kCluster * kCluster, (N + kNTile - 1) / kNTile);
  err = hopper_host::launch_clusters(fc6_weight_grad_kernel, grid, dim3(kCluster, 1, 1), kThreads, kSmem,
                                     (cudaStream_t)stream, map_dc, map_code, dw, R, D, N, T);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
