// CPU stand-in for cuda_bf16.h (see cuda_runtime.h): bf16 as its 16 bits,
// converted with round-to-nearest-even as the device intrinsics do.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};
inline float __bfloat162float(__nv_bfloat16 x) {
  uint32_t u = (uint32_t)x.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 x) { return x.bits; }
