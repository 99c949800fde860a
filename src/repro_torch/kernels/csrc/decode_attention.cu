// Decode attention: one new query token per sequence against the KV cache.
// q [B, H, Dh], k/v [B, S, KV, Dh] (strided views; the last dimension
// contiguous — the engine passes its flat [B, S, KV*Dh] cache viewed per
// head), kv_len -> o [B, H, Dh] (contiguous). fp32 or bf16 in and out,
// fp32 math inside.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention, body _decode_kernel): the same function — scale
// Dh^-0.5 applied to q, cache positions >= kv_len masked with -1e30, an
// online softmax over cache tiles, the final sum clamped at 1e-30 — and
// the same two savings: tiles at or past kv_len are never read, and the
// G = H / KV query heads of a kv head share every cache tile they load.
// One block of 128 threads owns (b, kv head) and walks the cache itself
// in 128-position tiles (the TPU grid's sequential cache dimension).
// Any S and any kv_len in [1, S] are taken (no S % block requirement).
//
// Bound: bytes. Each cache element is read once and used for G
// multiply-adds per query head group, far below the card's
// bytes-per-operation line. Design: the k tile (padded rows, so thread c
// reads its own key's row without bank conflicts) and the v tile sit in
// shared memory as fp32; thread c forms the G scores of key c from
// float4 steps over Dh with the G query rows broadcast from shared
// memory; one warp per head row takes the tile's max and sum with
// shuffles; thread d then accumulates output dim d for all G heads from
// P and the v column. B * KV blocks is few (32 for yi-6b at B = 8), so
// this first kernel leaves most SMs idle at small batch: splitting the
// cache across blocks with a combine pass (flash-decoding) is later work.

#include "attention_tile.cuh"

namespace {

constexpr int kBK = 128;        // cache positions per tile
constexpr int kThreads = 128;   // one key (scores) or one dim (output) each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;       // query heads per kv head

template <int DH>
__host__ __device__ constexpr int smem_floats() {
  return kMaxG * DH            // q rows, scaled
         + kBK * (DH + 4)      // k tile
         + kBK * DH            // v tile
         + kMaxG * kBK         // scores, then probabilities
         + 3 * kMaxG;          // running max, running sum, correction
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int S,
                        int H, int G, int kv_len, long long qsb,
                        long long qsh, long long ksb, long long kss,
                        long long ksh, long long vsb, long long vss,
                        long long vsh, float scale) {
  constexpr int VN = attn::Chunk<T>::N;
  constexpr int CH = DH / VN;
  constexpr int KLD = DH + 4;
  constexpr int kPer = kBK * CH / kThreads;   // chunks per thread per tile
  constexpr int kU = kPer < 8 ? kPer : 8;     // loads in flight per tensor
  static_assert(kPer % kU == 0, "whole batches of loads");

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [kMaxG][DH]
  float* Ks = Qs + kMaxG * DH;           // [kBK][KLD]
  float* Vs = Ks + kBK * KLD;            // [kBK][DH]
  float* Ps = Vs + kBK * DH;             // [kMaxG][kBK]
  float* Ms = Ps + kMaxG * kBK;          // [kMaxG]
  float* Ls = Ms + kMaxG;                // [kMaxG]
  float* Cs = Ls + kMaxG;                // [kMaxG]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    Qs[i] = attn::Chunk<T>::from(q[b * qsb + (kvh * G + g) * qsh + d]) *
            scale;
  }
  if (tid < kMaxG) {
    Ms[tid] = attn::kNegInf;
    Ls[tid] = 0.0f;
  }

  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.0f;

  const int n_valid = min(kv_len, S);
  for (int k0 = 0; k0 < n_valid; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    // kPer chunks of k and of v per thread, kU of each in flight at once
    // (all loads of a batch issue before any is converted and stored)
#pragma unroll 1
    for (int j0 = 0; j0 < kPer; j0 += kU) {
      uint4 rk[kU], rv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = tid + (j0 + u) * kThreads;
        const int r = i / CH, c = i % CH;
        const bool in = k0 + r < n_valid;
        rk[u] = attn::load_raw(kb + (k0 + r) * kss + c * VN, in);
        rv[u] = attn::load_raw(vb + (k0 + r) * vss + c * VN, in);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = tid + (j0 + u) * kThreads;
        const int r = i / CH, c = i % CH;
        float x[VN];
        attn::Chunk<T>::unpack(rk[u], x);
#pragma unroll
        for (int e = 0; e < VN; e += 4)
          *reinterpret_cast<float4*>(&Ks[r * KLD + c * VN + e]) =
              make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
        attn::Chunk<T>::unpack(rv[u], x);
#pragma unroll
        for (int e = 0; e < VN; e += 4)
          *reinterpret_cast<float4*>(&Vs[r * DH + c * VN + e]) =
              make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
      }
    }
    __syncthreads();

    // scores of key tid for the G heads
    {
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[tid * KLD + d]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float4 qq =
                *reinterpret_cast<const float4*>(&Qs[g * DH + d]);
            s[g] = fmaf(qq.x, kk.x, s[g]);
            s[g] = fmaf(qq.y, kk.y, s[g]);
            s[g] = fmaf(qq.z, kk.z, s[g]);
            s[g] = fmaf(qq.w, kk.w, s[g]);
          }
        }
      }
      const bool in = k0 + tid < n_valid;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) Ps[g * kBK + tid] = in ? s[g] : attn::kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per head row
    for (int g = warp; g < G; g += kWarps) {
      float* row = Ps + g * kBK;
      float mx = attn::kNegInf;
      for (int c = lane; c < kBK; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = lane; c < kBK; c += 32) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Cs[g] = corr;
        Ls[g] = Ls[g] * corr + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    // output dim tid for the G heads
    if (tid < DH) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= Cs[g];
      const int n_keys = min(kBK, n_valid - k0);
      for (int c = 0; c < n_keys; ++c) {
        const float vv = Vs[c * DH + tid];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] = fmaf(Ps[g * kBK + c], vv, acc[g]);
      }
    }
  }
  __syncthreads();
  if (tid < DH) {
    T* ob = o + (static_cast<long long>(b) * H + kvh * G) * DH + tid;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G)
        ob[g * DH] = attn::Chunk<T>::to(acc[g] / fmaxf(Ls[g], attn::kMinSum));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int kv_len, const long long* st,
           float scale, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, DH>;
  constexpr int bytes = smem_floats<DH>() * static_cast<int>(sizeof(float));
  // set on every launch: the attribute is per device, and cheap to set
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(KV, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, H / KV, kv_len,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int DH, const void* q, const void* k, const void* v, void* o,
             int B, int S, int H, int KV, int kv_len, const long long* st,
             float scale, cudaStream_t stream) {
  switch (DH) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, H, KV, kv_len, st, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, KV, kv_len, st, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, KV, kv_len, st, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, KV, kv_len, st, scale,
                            stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements: q's (batch, head) and k's and v's (batch,
// sequence, head); the head dimension is contiguous. o is a contiguous
// [B, H, DH] tensor. scale is DH^-0.5 rounded to float.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int KV, int DH, int bf16, int kv_len, long long qsb,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, float scale,
    cudaStream_t stream) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxG || kv_len < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[8] = {qsb, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return bf16 ? dispatch<__nv_bfloat16>(DH, q, k, v, o, B, S, H, KV, kv_len,
                                        st, scale, stream)
              : dispatch<float>(DH, q, k, v, o, B, S, H, KV, kv_len, st,
                                scale, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
