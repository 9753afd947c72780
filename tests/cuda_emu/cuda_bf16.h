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
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;  // x in the low 16 bits, as on the device
};
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return __nv_bfloat162{__float2bfloat16(lo), __float2bfloat16(hi)};
}
inline float __low2float(__nv_bfloat162 x) { return __bfloat162float(x.x); }
inline float __high2float(__nv_bfloat162 x) { return __bfloat162float(x.y); }
