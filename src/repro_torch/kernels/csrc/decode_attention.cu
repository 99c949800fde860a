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
// Any S and any kv_len in [1, S] are taken (no S % block requirement).
//
// Bound: bytes. Each cache element is read once and used for G
// multiply-adds per query head group, far below the card's
// bytes-per-operation line, so the design is about keeping enough bytes
// in flight on every SM (flash-decoding):
//
// - Split kernel, grid (kv head, split, b). The TPU grid walks the cache
//   dimension in order on one core; here the cache up to kv_len is cut
//   into n_splits chunks of whole 128-position tiles, one block each,
//   so B * KV * n_splits blocks fill the card (the wrapper picks
//   n_splits for at least ~2 blocks per SM; B * KV alone is 32-64 blocks
//   at the served batch of 8). Per tile, the v tile goes to shared
//   memory by cp.async (16-byte copies, in its element type) while the
//   k tile is read straight into registers: two neighbouring threads per
//   key (256 a block), each taking every other 16-byte chunk of the row,
//   all its loads in flight at once. Each thread forms its half of its
//   key's G scores against the G query rows held in shared memory as
//   fp32, and an xor shuffle finishes them. One warp per head row takes
//   the tile's max and sum with shuffles; thread (d, r) then accumulates
//   output dim d of the G heads from P and the v tile over the r-th
//   range of keys (a half at Dh 128), four keys a step. The ranges are
//   added in a fixed order at the end, and the block writes its fp32
//   partial (m, l, acc[G, Dh]) to a scratch tensor the wrapper
//   allocates. The per-head register arrays are as long as G rounded up
//   to a power of two (a template argument), since predicated-off heads
//   still issue; registers are capped so two blocks share an SM, and
//   one block's loads overlap the other's arithmetic.
// - Combine kernel, grid (head, b), Dh threads: rescales the n_splits
//   partials by exp(m_i - m) and writes the output in q's type. With one
//   split the split kernel writes the output itself and there is no
//   second launch.

#include "attention_tile.cuh"

namespace {

constexpr int kBK = 128;        // cache positions per tile
constexpr int kKeyThreads = 2;  // threads sharing one key's row (at most)
constexpr int kMinBlocks = 2;   // blocks per SM the registers must allow
constexpr int kMaxG = 16;       // query heads per kv head
constexpr int kMaxSplits = 1024;   // chunks the combine takes

// Threads per key: kKeyThreads, or fewer when a row has fewer 16-byte
// chunks (Dh 16 in bf16).
template <typename T, int DH>
__host__ __device__ constexpr int key_threads() {
  return DH / attn::Chunk<T>::N < kKeyThreads ? DH / attn::Chunk<T>::N
                                               : kKeyThreads;
}

template <typename T, int DH>
__host__ __device__ constexpr int threads() {
  return kBK * key_threads<T, DH>();
}

template <typename T, int DH, int GP>
__host__ __device__ constexpr int smem_bytes() {
  // the v tile, and after the loop the per-part sums of the output
  constexpr int tile = kBK * DH * static_cast<int>(sizeof(T));
  constexpr int red = threads<T, DH>() / DH * GP * DH *
                      static_cast<int>(sizeof(float));
  return (GP * DH       // q rows, scaled (fp32)
          + GP * kBK    // scores, then probabilities (fp32)
          + 4 * GP)     // running max, sum, correction (+ padding)
             * static_cast<int>(sizeof(float))
         + (tile > red ? tile : red);
}

// GP: the query heads per kv head rounded up to a power of two, the
// length of the per-head register arrays (G itself is a kernel argument)
template <typename T, int DH, int GP>
__global__ void __launch_bounds__(threads<T, DH>(), kMinBlocks)
decode_attention_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ o,
                              float* __restrict__ part, int H, int G,
                              int kv_len, int tiles_per_split, int n_splits,
                              long long qsb, long long qsh, long long ksb,
                              long long kss, long long ksh, long long vsb,
                              long long vss, long long vsh, float scale) {
  constexpr int VN = attn::Chunk<T>::N;
  constexpr int CH = DH / VN;                // 16-byte chunks per row
  constexpr int KT = key_threads<T, DH>();   // threads per key
  constexpr int CPT = CH / KT;               // chunks per thread
  constexpr int NT = threads<T, DH>();
  constexpr int NW = NT / 32;
  constexpr int NPART = NT / DH;             // key ranges of the P V pass
  constexpr int KPP = kBK / NPART;           // keys per range
  static_assert(CH % KT == 0 && KPP % 4 == 0, "whole chunks and steps");

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // [GP][DH]
  float* Ps = Qs + GP * DH;             // [GP][kBK]
  float* Ms = Ps + GP * kBK;            // [GP]
  float* Ls = Ms + GP;                  // [GP]
  float* Cs = Ls + GP;                  // [GP]
  float* tail = Cs + 2 * GP;            // 16-byte aligned
  T* Vs = reinterpret_cast<T*>(tail);   // [kBK][DH], in the loop
  float* Red = tail;                    // [NPART][GP][DH], after it

  const int kvh = blockIdx.x;   // neighbouring blocks: the kv heads of one
  const int split = blockIdx.y; // chunk, which share the cache's rows
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int p0 = split * tiles_per_split * kBK;
  const int p1 = min(kv_len, p0 + tiles_per_split * kBK);

  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  // the G query rows, scaled: 16-byte loads, all in flight at once
  for (int i = tid; i < G * CH; i += NT) {
    const int g = i / CH, c = i % CH;
    float x[VN];
    attn::load_chunk(q + b * qsb + (kvh * G + g) * qsh + c * VN, true, x);
#pragma unroll
    for (int e = 0; e < VN; e += 4)
      *reinterpret_cast<float4*>(Qs + g * DH + c * VN + e) =
          make_float4(x[e] * scale, x[e + 1] * scale, x[e + 2] * scale,
                      x[e + 3] * scale);
  }
  if (tid < GP) {
    Ms[tid] = attn::kNegInf;
    Ls[tid] = 0.0f;
  }

  // scores: thread (key, j) takes chunks j, j + KT, ... of the key's row
  // (the KT threads of a key are neighbouring lanes: 16 * KT contiguous
  // bytes per load, and their q reads fall in distinct banks)
  const int key = tid / KT, j = tid % KT;
  // P V: thread (d, r) takes output dim d over keys r * KPP ..
  const int d = tid % DH, r = tid / DH;
  float acc[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) acc[g] = 0.0f;

  for (int k0 = p0; k0 < p1; k0 += kBK) {
    __syncthreads();  // the previous tile's P and v are consumed
    // the v tile, in flight while the scores are formed; positions at or
    // past p1 are zero-filled (their P is 0, so they add nothing)
    for (int i = tid; i < kBK * CH; i += NT) {
      const int rr = i / CH, c = i % CH;
      const bool in = k0 + rr < p1;
      attn::cp_async16(Vs + rr * DH + c * VN,
                       vb + (in ? k0 + rr : k0) * vss + c * VN, in);
    }
    attn::cp_async_commit();

    {
      const bool in = k0 + key < p1;
      const T* kr = kb + (in ? k0 + key : k0) * kss;
      uint4 raw[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u)
        raw[u] = attn::load_raw(kr + (u * KT + j) * VN, in);
      float s[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) s[g] = 0.0f;
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        float x[VN];
        attn::Chunk<T>::unpack(raw[u], x);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          if (g < G) {
            const float* qr = Qs + g * DH + (u * KT + j) * VN;
#pragma unroll
            for (int e = 0; e < VN; e += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qr + e);
              s[g] = fmaf(qq.x, x[e], s[g]);
              s[g] = fmaf(qq.y, x[e + 1], s[g]);
              s[g] = fmaf(qq.z, x[e + 2], s[g]);
              s[g] = fmaf(qq.w, x[e + 3], s[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g < G) {
#pragma unroll
          for (int off = 1; off < KT; off <<= 1)
            s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
          if (j == 0) Ps[g * kBK + key] = in ? s[g] : attn::kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per head row
    for (int g = warp; g < G; g += NW) {
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
    attn::cp_async_wait<0>();
    __syncthreads();

    // output dim d of the G heads over this thread's keys, four a step
#pragma unroll
    for (int g = 0; g < GP; ++g)
      if (g < G) acc[g] *= Cs[g];
#pragma unroll
    for (int c0 = 0; c0 < KPP; c0 += 4) {
      const int c = r * KPP + c0;
      float vv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vv[e] = attn::Chunk<T>::from(Vs[(c + e) * DH + d]);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g < G) {
          const float4 p = *reinterpret_cast<const float4*>(Ps + g * kBK + c);
          acc[g] = fmaf(p.x, vv[0], acc[g]);
          acc[g] = fmaf(p.y, vv[1], acc[g]);
          acc[g] = fmaf(p.z, vv[2], acc[g]);
          acc[g] = fmaf(p.w, vv[3], acc[g]);
        }
      }
    }
  }
  // the NPART key ranges' sums of each output, added in a fixed order
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GP; ++g)
    if (g < G) Red[(r * GP + g) * DH + d] = acc[g];
  __syncthreads();
  const long long bh = static_cast<long long>(b) * H + kvh * G;
  // partials: acc [B, H, n_splits, DH], then (m, l) [B, H, n_splits, 2]
  const long long n_acc =
      static_cast<long long>(gridDim.z) * H * n_splits * DH;
  for (int i = tid; i < G * DH; i += NT) {
    const int g = i / DH, dd = i % DH;
    float x = 0.0f;
#pragma unroll
    for (int rr = 0; rr < NPART; ++rr) x += Red[(rr * GP + g) * DH + dd];
    if (n_splits == 1) {
      o[(bh + g) * DH + dd] =
          attn::Chunk<T>::to(x / fmaxf(Ls[g], attn::kMinSum));
    } else {
      const long long pi = (bh + g) * n_splits + split;
      part[pi * DH + dd] = x;
      if (dd == 0) {
        part[n_acc + 2 * pi] = Ms[g];
        part[n_acc + 2 * pi + 1] = Ls[g];
      }
    }
  }
}

// o[b, h, d] = sum_i acc_i[d] e^(m_i - m) / max(sum_i l_i e^(m_i - m),
// 1e-30), m = max_i m_i; grid (H, B), DH threads. The (m_i, l_i) pairs
// are read once into shared memory; each thread keeps 8 of its acc
// loads in flight.
template <typename T>
__global__ void decode_attention_combine_kernel(
    const float* __restrict__ part, T* __restrict__ o, int n_splits) {
  __shared__ float ms[kMaxSplits], ls[kMaxSplits];
  const int H = gridDim.x, DH = blockDim.x, d = threadIdx.x;
  const long long bh = static_cast<long long>(blockIdx.y) * H + blockIdx.x;
  const long long n_acc =
      static_cast<long long>(gridDim.y) * H * n_splits * DH;
  const float* acc = part + bh * n_splits * DH + d;
  const float* ml = part + n_acc + bh * n_splits * 2;
  for (int i = d; i < n_splits; i += DH) {
    ms[i] = ml[2 * i];
    ls[i] = ml[2 * i + 1];
  }
  __syncthreads();
  float m = attn::kNegInf;
  for (int i = 0; i < n_splits; ++i) m = fmaxf(m, ms[i]);
  float l = 0.0f, x = 0.0f;
#pragma unroll 8
  for (int i = 0; i < n_splits; ++i) {
    const float w = expf(ms[i] - m);
    l = fmaf(ls[i], w, l);
    x = fmaf(acc[static_cast<long long>(i) * DH], w, x);
  }
  o[bh * DH + d] = attn::Chunk<T>::to(x / fmaxf(l, attn::kMinSum));
}

template <typename T, int DH, int GP>
int launch(const void* q, const void* k, const void* v, void* o, void* part,
           int B, int H, int KV, int kv_len, int n_splits,
           int tiles_per_split, const long long* st, float scale,
           cudaStream_t stream) {
  auto kern = decode_attention_split_kernel<T, DH, GP>;
  constexpr int bytes = smem_bytes<T, DH, GP>();
  // set on every launch: the attribute is per device, and cheap to set
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(KV, n_splits, B), threads<T, DH>(), bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(part), H, H / KV, kv_len, tiles_per_split,
      n_splits, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      scale);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || n_splits == 1) return static_cast<int>(rc);
  decode_attention_combine_kernel<T><<<dim3(H, B), DH, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(o), n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int dispatch_g(const void* q, const void* k, const void* v, void* o,
               void* part, int B, int H, int KV, int kv_len, int n_splits,
               int tps, const long long* st, float scale,
               cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 1)
    return launch<T, DH, 1>(q, k, v, o, part, B, H, KV, kv_len, n_splits,
                            tps, st, scale, stream);
  if (G <= 2)
    return launch<T, DH, 2>(q, k, v, o, part, B, H, KV, kv_len, n_splits,
                            tps, st, scale, stream);
  if (G <= 4)
    return launch<T, DH, 4>(q, k, v, o, part, B, H, KV, kv_len, n_splits,
                            tps, st, scale, stream);
  if (G <= 8)
    return launch<T, DH, 8>(q, k, v, o, part, B, H, KV, kv_len, n_splits,
                            tps, st, scale, stream);
  return launch<T, DH, kMaxG>(q, k, v, o, part, B, H, KV, kv_len, n_splits,
                              tps, st, scale, stream);
}

template <typename T>
int dispatch(int DH, const void* q, const void* k, const void* v, void* o,
             void* part, int B, int H, int KV, int kv_len, int n_splits,
             int tps, const long long* st, float scale, cudaStream_t stream) {
  switch (DH) {
    case 16:
      return dispatch_g<T, 16>(q, k, v, o, part, B, H, KV, kv_len, n_splits,
                               tps, st, scale, stream);
    case 32:
      return dispatch_g<T, 32>(q, k, v, o, part, B, H, KV, kv_len, n_splits,
                               tps, st, scale, stream);
    case 64:
      return dispatch_g<T, 64>(q, k, v, o, part, B, H, KV, kv_len, n_splits,
                               tps, st, scale, stream);
    case 128:
      return dispatch_g<T, 128>(q, k, v, o, part, B, H, KV, kv_len, n_splits,
                                tps, st, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements: q's (batch, head) and k's and v's (batch,
// sequence, head); the head dimension is contiguous. o is a contiguous
// [B, H, DH] tensor. scale is DH^-0.5 rounded to float. The cache up to
// kv_len is cut into n_splits <= 1024 chunks of tiles_per_split
// 128-position tiles, none empty; with n_splits > 1, part is fp32 scratch of
// B * H * n_splits * (DH + 2) floats (unused with one split).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* part, int B,
    int S, int H, int KV, int DH, int bf16, int kv_len, int n_splits,
    int tiles_per_split, long long qsb, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale, cudaStream_t stream) {
  if (B <= 0) return 0;
  const long long span = static_cast<long long>(tiles_per_split) * kBK;
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxG || kv_len < 1 ||
      kv_len > S || n_splits < 1 || n_splits > kMaxSplits ||
      tiles_per_split < 1 ||
      n_splits * span < kv_len || (n_splits - 1) * span >= kv_len ||
      (n_splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[8] = {qsb, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return bf16 ? dispatch<__nv_bfloat16>(DH, q, k, v, o, part, B, H, KV,
                                        kv_len, n_splits, tiles_per_split,
                                        st, scale, stream)
              : dispatch<float>(DH, q, k, v, o, part, B, H, KV, kv_len,
                                n_splits, tiles_per_split, st, scale,
                                stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
