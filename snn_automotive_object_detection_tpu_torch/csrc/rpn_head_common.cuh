// Device code of the spiking RPN head shared by the level kernel
// (rpn_head.cu: K1 and its pair instance K8) and the backward
// (rpn_head_bwd.cu, K7): the head's limits, step_mask, and lif_element, the
// LIF update of one neuron in the order every kernel and plain version
// runs it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rpn {

constexpr int kC = 256;            // channels in and out of the 3x3 conv
constexpr int kMaxT = 32;
constexpr int kMaxOut = 128;       // readout channels (25 anchors)

// Periods p <= T + 1 that spike at step t (0-based): bit p is set when
// p divides t + 1.
__device__ __forceinline__ unsigned long long step_mask(int t, int T) {
  unsigned long long m = 0;
  for (int p = 1; p <= T + 1; ++p) m |= ((t + 1) % p == 0) ? (1ull << p) : 0ull;
  return m;
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
