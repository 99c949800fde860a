// Fused triple-scorer MLP: scores[q, n] = b2 + sum_h w2[h] *
//   relu(sum_d T[q, n, d] * W1t[d, h] + qbias[q, h])
// with qbias = query_emb @ W1q + b1 computed by the wrapper.
//
// Replaces the TPU kernels in src/repro/kernels/triple_score/kernel.py:
// triple_score_batched (each query scores its own candidate rows) and
// triple_score (all queries share one candidate set: the same kernel with
// a feature batch stride of 0). Like the Pallas body _score_kernel, the
// [N, H] hidden activations never reach device memory: each block keeps
// its tile of them in registers, applies bias + relu + the w2 product
// there, and writes one float per candidate.
//
// Bound: operations. At the paper-scale width (Dt=1156, H=1024) the first
// layer is 2*Dt*H flops per candidate against 4*Dt bytes of features, far
// above the card's fp32 ridge point, and the products run in full fp32
// FMA (no TF32, no tensor cores). Design: a classic register-blocked
// SGEMM tile, 128 candidates x 128 hidden units per 256-thread block, each
// thread an 8x8 sub-tile; Dt is walked in steps of 8 through a double-
// buffered shared-memory ring fed by register prefetch, so the next
// step's global loads overlap this step's FMAs. The block walks all of H
// in 128-wide chunks, folding each chunk into per-row partial scores, so
// every score is one deterministic sum and no atomics are needed. wgmma /
// TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;   // candidate rows per block
constexpr int BN = 128;   // hidden units per chunk
constexpr int BK = 8;     // feature depth per step
constexpr int PAD = 4;    // breaks bank conflicts on the transposed A store
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
triple_score_kernel(const float* __restrict__ feats, long long feat_stride,
                    const float* __restrict__ qbias,
                    const float* __restrict__ w1t,
                    const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out,
                    int n, int dt, int h) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];  // As[k][m] = T[m, k]
  __shared__ __align__(16) float Bs[2][BK][BN];        // Bs[k][j] = W1t[k, j]

  const int q = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const float* t = feats + q * feat_stride;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // global -> register prefetch slots: 4 A and 4 B elements per thread
  const int a_m = tid / BK, a_k = tid % BK;   // + 32 rows per slot
  const int b_k = tid / BN, b_j = tid % BN;   // + 2 depth rows per slot
  float a_reg[4], b_reg[4];

  float rowsum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rowsum[i] = 0.0f;

  for (int h0 = 0; h0 < h; h0 += BN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    auto load_global = [&](int k0) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int r = row0 + a_m + 32 * s, c = k0 + a_k;
        a_reg[s] = (r < n && c < dt) ? t[static_cast<long long>(r) * dt + c]
                                     : 0.0f;
        const int kk = k0 + b_k + 2 * s, j = h0 + b_j;
        b_reg[s] = (kk < dt && j < h) ? w1t[static_cast<long long>(kk) * h + j]
                                      : 0.0f;
      }
    };
    auto store_shared = [&](int buf) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        As[buf][a_k][a_m + 32 * s] = a_reg[s];
        Bs[buf][b_k + 2 * s][b_j] = b_reg[s];
      }
    };

    load_global(0);
    store_shared(0);
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < dt; k0 += BK) {
      const bool more = k0 + BK < dt;
      if (more) load_global(k0 + BK);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], b[8];
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) store_shared(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }

    // epilogue of this hidden chunk: bias, relu, w2 -> per-row partials
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int hj = h0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (hj < h) {
        const float qb = qbias[static_cast<long long>(q) * h + hj];
        const float w = w2[hj];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          rowsum[i] = fmaf(fmaxf(acc[i][j] + qb, 0.0f), w, rowsum[i]);
      }
    }
  }

  // the 16 threads of a row group (same ty, lanes of one half-warp)
  // hold partials over disjoint hidden units: reduce and write
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = rowsum[i];
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (tx == 0 && r < n) out[static_cast<long long>(q) * n + r] = v + b2[0];
  }
}

}  // namespace

extern "C" int triple_score_launch(const float* feats, long long feat_stride,
                                   const float* qbias, const float* w1t,
                                   const float* w2, const float* b2,
                                   float* out, int queries, int n, int dt,
                                   int h, cudaStream_t stream) {
  if (queries <= 0 || n <= 0) return 0;
  const dim3 grid((n + BM - 1) / BM, queries);
  triple_score_kernel<<<grid, THREADS, 0, stream>>>(
      feats, feat_stride, qbias, w1t, w2, b2, out, n, dt, h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
