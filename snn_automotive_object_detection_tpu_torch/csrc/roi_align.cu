// Multi-level RoIAlign (7x7, sampling ratio 2, aligned=False) for Hopper,
// with torchvision's FPN level mapper in its prologue: one launch, no other
// device op.
//
// Replaces the TPU kernel ops/pallas_roi_align.py (_roi_kernel, called by
// multiscale_roi_align_pallas), which DMAs a fixed 40x56 patch per RoI and
// turns the whole align into one matmul, with an exact gather fallback for
// RoIs whose samples overflow the patch.
//
// What bounds it on this card: memory traffic, not arithmetic. The 49 x C
// f32 outputs of a RoI are written once (100 MB at the main path's 2 x 1000
// RoIs); its 196 sample points read 4 bilinear corners of a C-channel bf16
// feature row each, mostly from L1 and L2, since neighbouring samples share
// corners. The kernel keeps as many of those reads in flight as it can and
// does no per-thread geometry.
//
// Design: one block of 7 warps per RoI. Its first 28 threads map the box to
// its level (the float expressions of ops/roi_align.py assign_fpn_levels,
// in the same order: sqrtf of the area, / 224, log2f, 4 +, + 1e-6, floorf,
// the clamp) and compute the RoI's separable sample geometry once into
// shared memory: 14 y-samples and 14 x-samples, each with its low and high
// corner index, its two interpolation weights and torchvision's validity.
// Warp py then owns output row py: each lane holds 8 channels (one 16-byte
// bf16 vector, a 512-byte coalesced row per warp at C = 256) and issues a
// bin's 16 corner loads before it sums them; each bin leaves as two float4
// stores per lane. The per-sample sums keep the plain version's order
// ((w00 v00 + w01 v01) + (w10 v10 + w11 v11), the four samples in (a, b)
// order, then / 4), and the weights its products (hy * hx * vm, ...), so,
// built with --fmad=false, the output equals the plain version up to
// nothing but the bf16 -> f32 reads they share.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kOut = 7;
constexpr int kS = 2 * kOut;             // samples per axis: 7 bins x 2
constexpr int kThreads = 32 * kOut;      // one warp per output row

struct Levels {
  const uint16_t* feat[kMaxLevels];      // [N, H, W, C] bf16 bits
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

// One sample coordinate along an axis of `size` pixels, torchvision's rule:
// corner indices, the weight of the low corner (h) and of the high one (l),
// and whether the sample lies in [-1, size].
struct Sample {
  int lo, hi;
  float l, h, valid;
};

__device__ __forceinline__ Sample axis_sample(float c, int size) {
  Sample s;
  s.valid = (c >= -1.0f && c <= (float)size) ? 1.0f : 0.0f;
  c = fmaxf(c, 0.0f);
  s.lo = min((int)c, size - 1);
  if (s.lo >= size - 1) c = (float)s.lo;
  s.hi = min(s.lo + 1, size - 1);
  s.l = c - (float)s.lo;
  s.h = 1.0f - s.l;
  return s;
}

__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// a[l] by selects over the unrolled levels: an index into a kernel
// parameter that is not a constant would copy the whole table to local
// memory.
template <typename T>
__device__ __forceinline__ T at(const T (&a)[kMaxLevels], int l) {
  T r = a[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) r = l == i ? a[i] : r;
  return r;
}

__device__ __forceinline__ uint4 ld16(const uint16_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__global__ void __launch_bounds__(kThreads)
roi_align_kernel(Levels lv, const float* __restrict__ boxes, int rois_per_image, int c,
                 int k_min, int k_max, float* __restrict__ out) {
  __shared__ Sample tab[2][kS];          // [0]: y-samples, [1]: x-samples
  __shared__ int s_lvl;

  const int roi = blockIdx.x;
  const int tid = threadIdx.x;

  if (tid < 2 * kS) {
    const float bx1 = boxes[4 * roi + 0];
    const float by1 = boxes[4 * roi + 1];
    const float bx2 = boxes[4 * roi + 2];
    const float by2 = boxes[4 * roi + 3];
    // torchvision's LevelMapper, as ops/roi_align.assign_fpn_levels.
    const float area = (bx2 - bx1) * (by2 - by1);
    float k = floorf(4.0f + log2f(sqrtf(area) / 224.0f) + 1e-6f);
    k = fminf(fmaxf(k, (float)k_min), (float)k_max);
    const int lvl = (int)(k - (float)k_min);
    if (tid == 0) s_lvl = lvl;
    const float scale = at(lv.scale, lvl);
    const int axis = tid / kS;           // 0: y, 1: x
    const int i = tid % kS;              // bin i / 2, sub-sample i % 2
    const float c1 = (axis == 0 ? by1 : bx1) * scale;
    const float c2 = (axis == 0 ? by2 : bx2) * scale;
    const float bin = fmaxf(c2 - c1, 1.0f) / (float)kOut;
    const float sub = (i % 2 == 0) ? 0.25f : 0.75f;   // (i + 0.5) / sampling_ratio
    const float coord = c1 + ((float)(i / 2) + sub) * bin;
    tab[axis][i] = axis_sample(coord, axis == 0 ? at(lv.h, lvl) : at(lv.w, lvl));
  }
  __syncthreads();

  const int lvl = s_lvl;
  const int W = at(lv.w, lvl);
  const int py = tid >> 5;
  const int lane = tid & 31;
  const uint16_t* f =
      at(lv.feat, lvl) + (int64_t)(roi / rois_per_image) * at(lv.h, lvl) * W * c;
  float* o = out + (int64_t)(roi * kOut + py) * kOut * c;

  for (int ch = 8 * lane; ch < c; ch += 256) {
#pragma unroll 1
    for (int px = 0; px < kOut; ++px) {
      uint4 v[2][2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const Sample& y = tab[0][2 * py + a];
        const int64_t r0 = (int64_t)y.lo * W, r1 = (int64_t)y.hi * W;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const Sample& x = tab[1][2 * px + b];
          v[a][b][0] = ld16(f + (r0 + x.lo) * c + ch);
          v[a][b][1] = ld16(f + (r0 + x.hi) * c + ch);
          v[a][b][2] = ld16(f + (r1 + x.lo) * c + ch);
          v[a][b][3] = ld16(f + (r1 + x.hi) * c + ch);
        }
      }
      float acc[8];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const Sample& y = tab[0][2 * py + a];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const Sample& x = tab[1][2 * px + b];
          const float vm = y.valid * x.valid;
          const float w00 = y.h * x.h * vm, w01 = y.h * x.l * vm;
          const float w10 = y.l * x.h * vm, w11 = y.l * x.l * vm;
          float f00[8], f01[8], f10[8], f11[8];
          unpack8(v[a][b][0], f00);
          unpack8(v[a][b][1], f01);
          unpack8(v[a][b][2], f10);
          unpack8(v[a][b][3], f11);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float s = (w00 * f00[j] + w01 * f01[j]) + (w10 * f10[j] + w11 * f11[j]);
            acc[j] = (a == 0 && b == 0) ? s : acc[j] + s;
          }
        }
      }
      float4* dst = reinterpret_cast<float4*>(o + (int64_t)px * c + ch);
      dst[0] = make_float4(acc[0] / 4.0f, acc[1] / 4.0f, acc[2] / 4.0f, acc[3] / 4.0f);
      dst[1] = make_float4(acc[4] / 4.0f, acc[5] / 4.0f, acc[6] / 4.0f, acc[7] / 4.0f);
    }
  }
}

}  // namespace

// The levels' geometry, in host memory (ops/cuda_roi_align.py builds it
// once per set of shapes): level l of the maps is mapper level k_min + l,
// k_max - k_min < num_levels; h, w the maps' sizes, scale their spatial
// scales.
struct Geometry {
  int num_levels, k_min, k_max;
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

// f0..f4: device pointers to the [N, H_l, W_l, C] bf16 maps of
// geo->num_levels levels (the rest ignored); boxes: [n_rois, 4] f32,
// rois_per_image per image; out: [n_rois, 7, 7, C] f32; C a multiple of 8,
// every pointer 16-byte aligned.
extern "C" int roi_align_bf16(const void* f0, const void* f1, const void* f2, const void* f3,
                              const void* f4, const Geometry* geo, const float* boxes,
                              int n_rois, int rois_per_image, int c, float* out, void* stream) {
  const int nl = geo->num_levels;
  if (nl < 1 || nl > kMaxLevels || c <= 0 || c % 8 != 0 || n_rois <= 0 ||
      rois_per_image <= 0 || geo->k_max < geo->k_min || geo->k_max - geo->k_min >= nl) {
    return (int)cudaErrorInvalidValue;
  }
  const void* fs[kMaxLevels] = {f0, f1, f2, f3, f4};
  Levels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int s = l < nl ? l : 0;
    lv.feat[l] = reinterpret_cast<const uint16_t*>(fs[s]);
    lv.h[l] = geo->h[s];
    lv.w[l] = geo->w[s];
    lv.scale[l] = geo->scale[s];
  }
  roi_align_kernel<<<n_rois, kThreads, 0, (cudaStream_t)stream>>>(
      lv, boxes, rois_per_image, c, geo->k_min, geo->k_max, out);
  return (int)cudaGetLastError();
}
