// Fused skew metrics: [B, K] descending top-K scores (+ optional [B] valid
// counts) -> [B, 4] = (area, cumulative-k at P, entropy in bits, Gini).
//
// Replaces the TPU kernel src/repro/kernels/skew_metrics/kernel.py
// (skew_metrics, body _skew_kernel): same masked single-row arithmetic,
// same descending-order shortcuts (the CDF is a running sum, the Gini
// weight of column c is c + 1), same clamp of n_valid to [1, K].
//
// Bound: memory. Each row is K floats in and 4 out, ~20 flops per score,
// so at any real B the card could finish in well under a microsecond; in
// practice the launch itself dominates. Design: one warp per row, eight
// rows per 256-thread block; lanes stride the row's valid prefix (K=100
// is four coalesced 128-byte sweeps) and every reduction is a warp
// shuffle, so nothing but the [B, 4] result is written to device memory.
//
// Exactness: cumulative-k compares the running CDF against P - eps, so a
// sum taken in another order can move a row's count by one when its CDF
// lies within rounding of P. The row total and the CDF are therefore
// accumulated in double and rounded to float once: the float result no
// longer depends on the summation order, and the plain PyTorch version
// (kernel.py, which accumulates the same way) agrees with it exactly on
// that column. The other sums use double too; every elementwise step
// (normalisation, probabilities, log2f) is the reference's float math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
skew_metrics_kernel(const float* __restrict__ scores,
                    const int* __restrict__ n_valid, float* __restrict__ out,
                    int rows, int k, float p_thr) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warp leaves together
  const float* s = scores + static_cast<long long>(row) * k;
  int nv = n_valid ? n_valid[row] : k;
  nv = min(max(nv, 1), k);

  // min/max over the valid prefix
  float hi = -INFINITY, lo = INFINITY;
  for (int c = lane; c < nv; c += 32) {
    const float v = s[c];
    hi = fmaxf(hi, v);
    lo = fminf(lo, v);
  }
  hi = warp_max(hi);
  lo = warp_min(lo);
  const float range = (hi - lo) + kEps;
  const float shift = fminf(lo, 0.0f);  // shift only when negatives exist

  // area, total mass and the Gini weighted sum
  double area = 0.0, total = 0.0, weighted = 0.0;
  for (int c = lane; c < nv; c += 32) {
    const float v = s[c];
    const float sh = v - shift;
    area += static_cast<double>((v - lo) / range);
    total += static_cast<double>(sh);
    weighted += static_cast<double>(c + 1) * static_cast<double>(sh);
  }
  area = warp_sum(area);
  const float total_f = static_cast<float>(warp_sum(total));
  weighted = warp_sum(weighted);
  const float denom = total_f + kEps;

  // entropy and the running CDF, 32 columns per step: an inclusive warp
  // scan of the step's probabilities plus the carry of earlier steps
  double ent = 0.0, carry = 0.0;
  int below = 0;
  for (int c0 = 0; c0 < nv; c0 += 32) {
    const int c = c0 + lane;
    const float prob = c < nv ? (s[c] - shift) / denom : 0.0f;
    if (prob > kEps) ent += static_cast<double>(prob * log2f(prob + kEps));
    double x = static_cast<double>(prob);
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    const double cdf = carry + x;
    if (c < nv && static_cast<float>(cdf) < p_thr) ++below;
    carry = __shfl_sync(kFull, cdf, 31);
  }
  ent = warp_sum(ent);
  for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(kFull, below, o);

  if (lane == 0) {
    const double n1 = static_cast<double>(nv);
    double gini = (n1 + 1.0 - 2.0 * weighted / static_cast<double>(denom)) / n1;
    gini = fmin(fmax(gini, 0.0), 1.0);
    float* o = out + static_cast<long long>(row) * 4;
    o[0] = static_cast<float>(area);
    o[1] = static_cast<float>(min(below + 1, nv));
    o[2] = static_cast<float>(-ent);
    o[3] = static_cast<float>(gini);
  }
}

}  // namespace

extern "C" int skew_metrics_launch(const float* scores, const int* n_valid,
                                   float* out, int rows, int k, float p_thr,
                                   cudaStream_t stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  skew_metrics_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      scores, n_valid, out, rows, k, p_thr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
