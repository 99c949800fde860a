// Causal GQA prefill attention: q [B, S, H, Dh], k/v [B, S, KV, Dh]
// (strided views; the last dimension contiguous) -> o [B, S, H, Dh]
// (contiguous), fp32 or bf16 in and out, fp32 math inside.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _flash_kernel): the same function — scale
// Dh^-0.5 applied to q, keys above the diagonal masked with -1e30, an
// online softmax (running max m, running sum l, fp32 accumulator), the
// final sum clamped at 1e-30, kv head h / (H / KV) with no repeat — and
// the same skipping of key tiles wholly above the diagonal. It does not
// copy the Pallas tiling: the TPU grid walks key blocks in order per
// (b, h, q block) with VMEM scratch; here one block of 256 threads owns
// (b, h, 64 query rows) and loops over 64-key tiles itself, stopping at
// the tile that holds the diagonal. Any S is taken: rows and keys past S
// are masked in place (the Pallas kernel demands S % 128 == 0).
//
// Bound: operations. A causal prefill does ~2 S^2 H Dh multiply-adds
// against 2-4 bytes per element of q, k, v and o, so at S >= 100 the
// work is far above the card's bytes-per-operation line. This first
// kernel runs on the fp32 CUDA cores (67 TFLOP/s peak), not the tensor
// cores (989 TFLOP/s bf16): the TPU kernel's arithmetic is fp32
// throughout, P included, and an mma/wgmma version that rounds P to
// bf16 is later work. Design for the CUDA cores: q^T and k^T tiles in
// shared memory as fp32 (converted once per tile), each thread a 4 x 4
// register block of scores (float4 loads of 4 rows and 4 keys per step),
// row max and row sum as half-warp shuffles (the 16 threads of a row
// group are one half-warp), P^T written over the k^T tile, then a 4 x
// Dh/16 register block of the output accumulated from P^T and V.
// Shared memory at Dh = 128: 100 KB, two blocks per SM.

#include "attention_tile.cuh"

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;     // 16 x 16: (row group, key/dim group)
constexpr int kLD = kBQ + 4;      // leading dim of the transposed tiles

static_assert(kBQ == kBK, "P^T reuses the k^T tile");

// k^T holds DH rows; P^T, written over it, kBK rows.
template <int DH>
__host__ __device__ constexpr int kt_rows() { return DH > kBK ? DH : kBK; }

template <int DH>
__host__ __device__ constexpr int smem_bytes() {
  return ((DH + kt_rows<DH>()) * kLD + kBK * DH) *
         static_cast<int>(sizeof(float));
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int group, long long qsb, long long qss,
                       long long qsh, long long ksb, long long kss,
                       long long ksh, long long vsb, long long vss,
                       long long vsh, float scale) {
  constexpr int VN = attn::Chunk<T>::N;
  constexpr int CH = DH / VN;             // 16-byte chunks per row
  constexpr int ND = DH / 16;             // output dims per thread
  constexpr int VW = ND >= 4 ? 4 : ND;    // contiguous run of them
  constexpr int NG = ND / VW;             // runs, 16 * VW apart

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [DH][kLD]  q^T, scaled
  float* Ks = Qs + DH * kLD;         // [DH][kLD]  k^T, then P^T [kBK][kLD]
  float* Vs = Ks + kt_rows<DH>() * kLD;  // [kBK][DH]

  const int qt = gridDim.x - 1 - blockIdx.x;  // diagonal-heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // key group (scores), dim group (output)
  const int ty = tid / 16;   // row group: rows ty*4 .. ty*4+3

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;

  // q^T, scaled (row-fast mapping: conflict-free transposed stores)
  for (int i = tid; i < kBQ * CH; i += kThreads) {
    const int r = i % kBQ, c = i / kBQ;
    float x[VN];
    attn::load_chunk(qb + (q0 + r) * qss + c * VN, q0 + r < S, x);
#pragma unroll
    for (int e = 0; e < VN; ++e) Qs[(c * VN + e) * kLD + r] = x[e] * scale;
  }

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = attn::kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int a = 0; a < ND; ++a) acc[i][a] = 0.0f;
  }

  const int n_tiles = min((S + kBK - 1) / kBK, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's P^T and V are consumed
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i % kBK, c = i / kBK;
      float x[VN];
      attn::load_chunk(kb + (k0 + r) * kss + c * VN, k0 + r < S, x);
#pragma unroll
      for (int e = 0; e < VN; ++e) Ks[(c * VN + e) * kLD + r] = x[e];
    }
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      float x[VN];
      attn::load_chunk(vb + (k0 + r) * vss + c * VN, k0 + r < S, x);
#pragma unroll
      for (int e = 0; e < VN; e += 4)
        *reinterpret_cast<float4*>(&Vs[r * DH + c * VN + e]) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
    __syncthreads();

    // scores: rows ty*4+i, keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * kLD + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Ks[d * kLD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, then the online-softmax update of each row
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = attn::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        if (kp > qp || kp >= S) s[i][j] = attn::kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + half_warp_sum(rs);
      m[i] = m_new;
    }
    __syncthreads();  // every thread is done with k^T
    float* Ps = Ks;   // P^T [kBK][kLD]
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * kLD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int a = 0; a < ND; ++a) acc[i][a] *= corr[i];
    __syncthreads();

    const int n_keys = min(kBK, S - k0);
    for (int c = 0; c < n_keys; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[c * kLD + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      float vv[ND];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float* vr = &Vs[c * DH + g * 16 * VW + tx * VW];
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vr);
          vv[g * 4] = x.x; vv[g * 4 + 1] = x.y;
          vv[g * 4 + 2] = x.z; vv[g * 4 + 3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < VW; ++e) vv[g * VW + e] = vr[e];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int a = 0; a < ND; ++a) acc[i][a] = fmaf(pv[i], vv[a], acc[i][a]);
    }
  }

  const long long row = static_cast<long long>(H) * DH;
  T* ob = o + static_cast<long long>(b) * S * row + h * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float lsafe = fmaxf(l[i], attn::kMinSum);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        ob[qp * row + g * 16 * VW + tx * VW + e] =
            attn::Chunk<T>::to(acc[i][g * VW + e] / lsafe);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, const long long* st, float scale,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, DH>;
  constexpr int bytes = smem_bytes<DH>();
  // set on every launch: the attribute is per device, and cheap to set
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, H / KV, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int DH, const void* q, const void* k, const void* v, void* o,
             int B, int S, int H, int KV, const long long* st, float scale,
             cudaStream_t stream) {
  switch (DH) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, st, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, st, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, st, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, KV, st, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements, for the (batch, sequence, head) dimensions of
// q, k and v in that order; the head dimension is contiguous. o is a
// contiguous [B, S, H, DH] tensor. scale is DH^-0.5 rounded to float.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int KV, int DH, int bf16, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, float scale,
    cudaStream_t stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return bf16 ? dispatch<__nv_bfloat16>(DH, q, k, v, o, B, S, H, KV, st,
                                        scale, stream)
              : dispatch<float>(DH, q, k, v, o, B, S, H, KV, st, scale,
                                stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
