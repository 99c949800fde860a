// Sorted segment sum with a fixed number of rows per segment — the reduce
// of an embedding bag — and the embedding bag itself (gather + reduce).
//
//   segment_sum_sorted_launch: rows [S*r, D], seg_ids [S*r] -> out [S, D];
//     segment s sums the rows of its window [s*r, (s+1)*r) whose seg_id is
//     s. Pad rows (seg_id = -1) are dropped.
//   embedding_bag_launch: table [V, D], ids [S*r] -> out [S, D]; bag s sums
//     table rows ids[s*r + j] for its ids >= 0 (-1 pads skipped), and with
//     `mean` divides by the number of those ids, clamped to 1. An id past
//     the table is not read: it counts as a row of NaN, as the reference's
//     gather (jnp.take, fill mode) makes it, so its bag comes out NaN.
//
// fp32 or bf16 rows in and out, fp32 accumulation inside.
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce/kernel.py
// (segment_sum_sorted, body _segsum_kernel) and its wrapper
// ops.embedding_bag_fused. Under their contract (ids sorted ascending,
// exactly r rows per segment, pads -1) segment s's rows are exactly its
// window, so this computes the oracle's function (ref.py: segment_sum
// with pads sent to a dropped dummy segment). The TPU kernel builds a
// one-hot [rows, segments] matrix per tile and multiplies it on the MXU;
// on Hopper that is wasted work: the function is a gather-reduce.
//
// Bound: bytes. Each row element is read once for one add; at the
// production shape (S = 65,536 bags of r = 16 rows, D = 128) the 537 MB
// of rows take 0.16 ms at 3.35 TB/s, the adds 0.002 ms at the fp32 rate.
// Design: threads across D, segments across lanes, warps and blocks, no
// atomics and no shared memory. A segment gets the smallest power-of-two
// group of lanes that covers its D / VEC vectors (VEC = 4 floats or 8
// bf16 when D and the pointers allow 16-byte loads, else 2 or 1), so a
// warp holds 32 / lanes segments: D = 10 (deepfm, 40-byte rows, only
// 8-byte aligned) is two floats a lane, 8 lanes, four bags a warp; D = 16
// (dcn-v2) four lanes of float4, eight bags a warp; D = 128 one bag a
// warp. Each lane walks its segment's r rows in order, so every output is
// one sequential fp32 sum and the result does not change from run to run;
// the walk is unrolled four ways so four row loads (and, for the bag, the
// four ids before them) are in flight per lane. Row offsets are 64-bit
// (id * D passes 2^31 for dcn-v2's 33.8M-row table at D = 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements loaded or stored as one access of VEC * sizeof(T) bytes.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC, bool GATHER>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                   T* __restrict__ out, long long n_seg, int r, int d,
                   int lanes, long long n_rows, int mean) {
  const int lane = threadIdx.x & 31;
  const long long s =
      (static_cast<long long>(blockIdx.x) * (kThreads / 32) +
       (threadIdx.x >> 5)) * (32 / lanes) + lane / lanes;
  if (s >= n_seg) return;
  const int sub = lane & (lanes - 1);
  const int chunks = d / VEC;
  const long long base = s * r;
  const int* ids = idx + base;
  for (int c = sub; c < chunks; c += lanes) {
    const long long col = static_cast<long long>(c) * VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    int count = 0;
#pragma unroll 4
    for (int j = 0; j < r; ++j) {
      const int id = __ldg(ids + j);
      long long row;
      if (GATHER) {
        if (id < 0) continue;
        if (id >= n_rows) {
          ++count;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = CUDART_NAN_F;
          continue;
        }
        row = id;
      } else {
        if (id != s) continue;
        row = base + j;
      }
      ++count;
      const Vec<T, VEC> x =
          *reinterpret_cast<const Vec<T, VEC>*>(src + row * d + col);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += to_float(x.v[e]);
    }
    const float n = static_cast<float>(count > 1 ? count : 1);
    Vec<T, VEC> y;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      y.v[e] = from_float<T>(mean ? acc[e] / n : acc[e]);
    *reinterpret_cast<Vec<T, VEC>*>(out + s * d + col) = y;
  }
}

template <typename T, int VEC, bool GATHER>
int launch(const void* src, const int* idx, void* out, long long n_seg, int r,
           int d, long long n_rows, int mean, cudaStream_t stream) {
  int lanes = 1;
  while (lanes < 32 && lanes * VEC < d) lanes *= 2;
  const long long per_block = (kThreads / 32) * (32 / lanes);
  const long long blocks = (n_seg + per_block - 1) / per_block;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_kernel<T, VEC, GATHER>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(src), idx, static_cast<T*>(out), n_seg, r, d,
          lanes, n_rows, mean);
  return static_cast<int>(cudaGetLastError());
}

// The widest access (at most 16 bytes) that divides D and both pointers'
// alignment; rows then start aligned because each is D elements long.
template <typename T, bool GATHER>
int dispatch(const void* src, const int* idx, void* out, long long n_seg,
             int r, int d, long long n_rows, int mean, cudaStream_t stream) {
  if (n_seg <= 0 || d <= 0) return 0;
  if (r < 0) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out);
  int vec = 1;
  for (int v = 16 / static_cast<int>(sizeof(T)); v > 1; v /= 2) {
    if (d % v == 0 && addr % (v * sizeof(T)) == 0) {
      vec = v;
      break;
    }
  }
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) * 8 <= 16)
        return launch<T, 8, GATHER>(src, idx, out, n_seg, r, d, n_rows, mean,
                                    stream);
      break;
    case 4:
      return launch<T, 4, GATHER>(src, idx, out, n_seg, r, d, n_rows, mean,
                                  stream);
    case 2:
      return launch<T, 2, GATHER>(src, idx, out, n_seg, r, d, n_rows, mean,
                                  stream);
    default:
      return launch<T, 1, GATHER>(src, idx, out, n_seg, r, d, n_rows, mean,
                                  stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int segment_sum_sorted_launch(const void* rows, const int* seg_ids,
                                         void* out, long long n_seg, int r,
                                         int d, int bf16,
                                         cudaStream_t stream) {
  return bf16 ? dispatch<__nv_bfloat16, false>(rows, seg_ids, out, n_seg, r,
                                               d, 0, 0, stream)
              : dispatch<float, false>(rows, seg_ids, out, n_seg, r, d, 0, 0,
                                       stream);
}

extern "C" int embedding_bag_launch(const void* table, const int* ids,
                                    void* out, long long n_bags, int nnz,
                                    int d, long long n_rows, int mean,
                                    int bf16, cudaStream_t stream) {
  return bf16 ? dispatch<__nv_bfloat16, true>(table, ids, out, n_bags, nnz, d,
                                              n_rows, mean, stream)
              : dispatch<float, true>(table, ids, out, n_bags, nnz, d, n_rows,
                                      mean, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
