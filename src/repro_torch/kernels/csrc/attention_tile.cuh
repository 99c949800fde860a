// Helpers shared by the attention kernels (flash_attention.cu,
// decode_attention.cu): 16-byte loads of a row chunk converted to float,
// the store of one float back to the input's element type, and the PTX
// wrappers for cp.async copies into shared memory.
//
// Every row the kernels read starts on a 16-byte boundary and its length
// is a whole number of 16-byte chunks; the Python wrappers check both
// (data pointer and every stride but the last a multiple of 16 bytes,
// the last stride 1) before launching.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float kNegInf = -1e30f;   // the reference kernels' mask value
constexpr float kMinSum = 1e-30f;   // clamp of the softmax sum at the end

template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;  // elements per 16 bytes
  __device__ __forceinline__ static void unpack(const uint4& x, float* out) {
    out[0] = __uint_as_float(x.x);
    out[1] = __uint_as_float(x.y);
    out[2] = __uint_as_float(x.z);
    out[3] = __uint_as_float(x.w);
  }
  __device__ __forceinline__ static float to(float x) { return x; }
  __device__ __forceinline__ static float from(float x) { return x; }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& x, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 to(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ __forceinline__ static float from(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

// The raw 16 bytes of one chunk, or zero bits (0.0 in either type) when
// the row lies past the end. Kept raw so a caller can have several loads
// in flight before it converts any of them.
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* p, bool valid) {
  return valid ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
}

// Load one 16-byte chunk as floats.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, bool valid,
                                           float* out) {
  Chunk<T>::unpack(load_raw(p, valid), out);
}

// ---- cp.async: 16-byte copies global -> shared, in commit groups ----------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes, or write 16 zero bytes (nothing is read) when !valid;
// src must be a mapped address either way.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace attn
