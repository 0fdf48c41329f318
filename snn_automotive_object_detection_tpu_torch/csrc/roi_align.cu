// Multi-level RoIAlign (7x7, sampling ratio 2, aligned=False) for Hopper.
//
// Replaces the TPU kernel ops/pallas_roi_align.py (_roi_kernel, called by
// multiscale_roi_align_pallas), which DMAs a fixed 40x56 patch per RoI and
// turns the whole align into one matmul, with an exact gather fallback for
// RoIs whose samples overflow the patch.
//
// What bounds it on this card: memory traffic, not arithmetic. Each RoI
// reads 7*7*2*2 sample points x 4 bilinear corners of a 256-channel bf16
// row (mostly L1/L2 hits, as a RoI's samples overlap) and writes 49 x 256
// f32 values; at the main path's 2 x 1000 RoIs that is 100 MB of output.
//
// Design: one block per RoI, each thread owning two adjacent channels, so
// every corner read is one coalesced 512-byte row across the block and the
// output rows are written once, coalesced. The direct per-sample gather
// has no patch limit, so unlike the TPU kernel no fallback branch exists.
// The per-sample arithmetic follows ops/roi_align.py operation for
// operation (built with --fmad=false), so results equal the plain version
// up to nothing but the bf16->f32 reads they share.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kOut = 7;

struct LevelTable {
  const __nv_bfloat16* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

__device__ __forceinline__ float2 load2(const __nv_bfloat16* f, int64_t idx) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f + idx));
}

__global__ void roi_align_kernel(LevelTable lt, const float* __restrict__ boxes,
                                 const int* __restrict__ levels, int rois_per_image,
                                 int c, float* __restrict__ out) {
  const int roi = blockIdx.x;
  const int img = roi / rois_per_image;
  const int lvl = levels[roi];
  const int H = lt.h[lvl];
  const int W = lt.w[lvl];
  const float scale = lt.scale[lvl];
  const __nv_bfloat16* f = lt.feat[lvl] + (int64_t)img * H * W * c;

  const float x1 = boxes[4 * roi + 0] * scale;
  const float y1 = boxes[4 * roi + 1] * scale;
  const float x2 = boxes[4 * roi + 2] * scale;
  const float y2 = boxes[4 * roi + 3] * scale;
  const float bin_w = fmaxf(x2 - x1, 1.0f) / (float)kOut;
  const float bin_h = fmaxf(y2 - y1, 1.0f) / (float)kOut;
  const float hf = (float)H;
  const float wf = (float)W;
  const float sub[2] = {0.25f, 0.75f};  // (i + 0.5) / sampling_ratio

  for (int ch = 2 * threadIdx.x; ch < c; ch += 2 * blockDim.x) {
    for (int py = 0; py < kOut; ++py) {
      for (int px = 0; px < kOut; ++px) {
        float2 acc = make_float2(0.f, 0.f);
        for (int a = 0; a < 2; ++a) {
          for (int b = 0; b < 2; ++b) {
            float y = y1 + ((float)py + sub[a]) * bin_h;
            float x = x1 + ((float)px + sub[b]) * bin_w;
            const float vm =
                (y >= -1.0f && y <= hf && x >= -1.0f && x <= wf) ? 1.0f : 0.0f;
            y = fmaxf(y, 0.0f);
            x = fmaxf(x, 0.0f);
            const int y_low = min((int)y, H - 1);
            const int x_low = min((int)x, W - 1);
            if (y_low >= H - 1) y = (float)y_low;
            if (x_low >= W - 1) x = (float)x_low;
            const int y_high = min(y_low + 1, H - 1);
            const int x_high = min(x_low + 1, W - 1);
            const float ly = y - (float)y_low;
            const float lx = x - (float)x_low;
            const float hy = 1.0f - ly;
            const float hx = 1.0f - lx;
            const float w00 = hy * hx * vm, w01 = hy * lx * vm;
            const float w10 = ly * hx * vm, w11 = ly * lx * vm;
            const float2 v00 = load2(f, ((int64_t)y_low * W + x_low) * c + ch);
            const float2 v01 = load2(f, ((int64_t)y_low * W + x_high) * c + ch);
            const float2 v10 = load2(f, ((int64_t)y_high * W + x_low) * c + ch);
            const float2 v11 = load2(f, ((int64_t)y_high * W + x_high) * c + ch);
            const float sx = (w00 * v00.x + w01 * v01.x) + (w10 * v10.x + w11 * v11.x);
            const float sy = (w00 * v00.y + w01 * v01.y) + (w10 * v10.y + w11 * v11.y);
            if (a == 0 && b == 0) {
              acc = make_float2(sx, sy);
            } else {
              acc.x = acc.x + sx;
              acc.y = acc.y + sy;
            }
          }
        }
        float2 res = make_float2(acc.x / 4.0f, acc.y / 4.0f);
        *reinterpret_cast<float2*>(out + ((int64_t)(roi * kOut + py) * kOut + px) * c + ch) = res;
      }
    }
  }
}

}  // namespace

// feat_ptrs/hs/ws/scales: host arrays of num_levels entries (device
// pointers to [N, H_l, W_l, C] bf16 maps). boxes: [n_rois, 4] f32;
// levels: [n_rois] int32 in [0, num_levels); out: [n_rois, 7, 7, C] f32.
extern "C" int roi_align_bf16(const int64_t* feat_ptrs, const int* hs, const int* ws,
                              const float* scales, int num_levels, const float* boxes,
                              const int* levels, int n_rois, int rois_per_image, int c,
                              float* out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || c % 2 != 0 || n_rois <= 0 ||
      rois_per_image <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  LevelTable lt;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int s = l < num_levels ? l : 0;
    lt.feat[l] = reinterpret_cast<const __nv_bfloat16*>(feat_ptrs[s]);
    lt.h[l] = hs[s];
    lt.w[l] = ws[s];
    lt.scale[l] = scales[s];
  }
  const int threads = c / 2 < 128 ? c / 2 : 128;
  roi_align_kernel<<<n_rois, threads, 0, (cudaStream_t)stream>>>(
      lt, boxes, levels, rois_per_image, c, out);
  return (int)cudaGetLastError();
}
