// Device code of the spiking RPN head shared by the level kernel
// (rpn_head.cu: K1 and its pair instance K8) and the backward
// (rpn_head_bwd.cu, K7): the head's limits, step_mask, and lif_element, the
// LIF update of one neuron in the order every kernel and plain version
// runs it (lif_element_s16: the same with bf16 states).

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

// bf16 rounding of an f32 value, back in f32.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The constants of lif_element as bf16 values: the reference's kernel with
// bf16 LIF states multiplies bf16 states by 0.1 and 0.2 as bf16 scalars and
// rounds its threshold to the state dtype.
constexpr float kTauMem16 = 0.10009765625f;   // bf16(0.1)
constexpr float kTauSyn16 = 0.2001953125f;    // bf16(0.2)
constexpr float kVth16 = 0.10009765625f;      // bf16(0.1)

// lif_element with bf16 states (the K1 instance for bf16 neuron states): v
// and cu hold bf16 values, and every elementwise result is rounded to bf16,
// as an f32 operation on bf16 values rounded once, in the order of
// lif_element.
__device__ __forceinline__ bool lif_element_s16(float conv, float lit, float& v, float& cu,
                                                float& ss, float& vd) {
  const float cur = bf16r(conv);
  vd = bf16r(v + bf16r(kTauMem16 * bf16r(cu - v)));
  const float id = bf16r(cu - bf16r(kTauSyn16 * cu));
  const bool s = (vd - kVth16) > 0.0f;
  v = s ? 0.0f : vd;
  cu = bf16r(id + cur);
  ss = ss + (s ? lit : 0.0f);
  return s;
}

}  // namespace rpn
