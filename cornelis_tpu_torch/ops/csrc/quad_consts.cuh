// K4's constants (benchmarks/bf16_probe.py::build): object J's (c, d, k) =
// (0.1 + 0.01 J, 0.5 - 0.003 J, 1 + 0.02 J) as jnp.asarray(value, dtype)
// rounds them, the Python float to float32 and, for bfloat16, float32 to
// bfloat16 to nearest even; and c + c. All at compile time, so the kernel
// converts and adds nothing for them. Plain C++ (probes.cu includes it;
// tests/test_torch_probes.py compiles it on the host to pin the bits).

#pragma once

#include <stdint.h>

namespace quad {

// The bits of a positive normal float32 value.
constexpr uint32_t f32_bits(float f) {
  int e = 0;
  double m = f;
  while (m >= 2.0) {
    m *= 0.5;
    ++e;
  }
  while (m < 1.0) {
    m *= 2.0;
    --e;
  }
  return ((uint32_t)(e + 127) << 23) | (uint32_t)((m - 1.0) * 8388608.0);
}

// Finite float32 bits rounded to the nearest bfloat16's, ties to even.
constexpr uint16_t bf16_rne(uint32_t bits) {
  return (uint16_t)((bits + 0x7fffu + ((bits >> 16) & 1u)) >> 16);
}

template <int J>
struct Consts {
  static constexpr float c = (float)(0.1 + 0.01 * J);
  static constexpr float d = (float)(0.5 - 0.003 * J);
  static constexpr float k = (float)(1.0 + 0.02 * J);
  static constexpr uint16_t c_bf16 = bf16_rne(f32_bits(c));
  static constexpr uint16_t d_bf16 = bf16_rne(f32_bits(d));
  static constexpr uint16_t k_bf16 = bf16_rne(f32_bits(k));
  // c + c: doubling a normal bfloat16 adds one to its exponent field, exactly.
  static constexpr uint16_t c2_bf16 = (uint16_t)(c_bf16 + (1u << 7));
};

}  // namespace quad
