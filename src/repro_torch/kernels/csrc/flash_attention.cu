// Causal GQA prefill attention: q [B, S, H, Dh], k/v [B, S, KV, Dh]
// (strided views; the last dimension contiguous) -> o [B, S, H, Dh]
// (contiguous), fp32 or bf16 in and out.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _flash_kernel): the same function — scale
// Dh^-0.5, keys above the diagonal masked with -1e30, an online softmax
// (running max m, running sum l, fp32 accumulator), the final sum
// clamped at 1e-30, kv head h / (H / KV) with no repeat — and the same
// skipping of key tiles wholly above the diagonal. It does not copy the
// Pallas tiling: the TPU grid walks key blocks in order per (b, h, q
// block) with VMEM scratch; here one block owns (b, h, 64 query rows)
// and loops over 64-key tiles itself, stopping at the tile that holds
// the diagonal, the diagonal-heavy query tiles launched first. Any S is
// taken: rows and keys past S are masked in place (the Pallas kernel
// demands S % 128 == 0).
//
// Bound: operations. A causal prefill does ~2 S^2 H Dh multiply-adds
// against 2-4 bytes per element of q, k, v and o, so at S >= 100 the
// work is far above the card's bytes-per-operation line. Two kernels:
//
// bf16 (the served type): tensor cores. Four warps, each owning 16 query
// rows whose Q fragments stay in registers for the whole key loop. S =
// Q K^T is mma.sync.m16n8k16 on bf16 operands straight from memory with
// fp32 accumulation: the products are exact, so only the order of the
// sums differs from the plain version. The online softmax runs on the
// accumulator fragments (each row is held by the four threads of a quad;
// max by two xor shuffles, the sum kept per thread and reduced once at
// the end). P is not rounded once to bf16 (the reference's XLA flash
// does that, models/flash.py:85-87, and near-cancelling rows then miss
// the kernel-vs-plain bar of one bf16 ulp of the output): it is split
// into hi = bf16(P) and lo = bf16(P - hi), two MMAs against the same V
// fragment, so P V carries ~2^-16 relative error for 1.5x the MMA work
// of a plain flash kernel. K and V tiles sit in shared memory as bf16
// (rows padded by 16 bytes, so the ldmatrix reads of 8 rows hit 8
// different bank groups), filled by cp.async through a two-stage ring:
// K of tile t+1 and V of tile t+1 are in flight while tile t computes,
// and K of a tile is waited for apart from its V; Q passes through the
// second stage before the loop first fills it. 68 KB of shared memory
// at Dh = 128, and registers capped at 168 a thread, so three blocks
// (12 warps) share an SM.
//
// Why mma.sync and not wgmma/TMA yet: wgmma wants its B operand (K^T,
// then V) in shared memory in the canonical swizzled layouts and a
// 64-row warpgroup tile per MMA, and TMA wants a tensor map built on the
// host per (pointer, strides) — the strided q/k/v views change per
// layer call — plus mbarrier phases in place of cp.async groups. That is
// a rewrite of the whole pipeline, and the two-bf16 split of P has to be
// re-derived for register-sourced A in wgmma. The tile loop here is
// already in that shape: load_tile() is the producer (one call per K or
// V tile, its own commit group, a stage index) and the consumer only
// reads a stage after waiting on it, so TMA loads and an mbarrier per
// stage can replace the producer, and wgmma the two mma loops, without
// touching the masking and the softmax.
//
// fp32 (reaches the kernel only in the checks): the CUDA cores, as the
// first port of this kernel did: q^T and k^T tiles in shared memory as
// fp32, each thread a 4 x 4 register block of scores, row max and row
// sum as half-warp shuffles, P^T written over the k^T tile, then a 4 x
// Dh/16 register block of the output from P^T and V. 100 KB of shared
// memory at Dh = 128.

#include "attention_tile.cuh"

namespace {

// ---- fp32: CUDA cores -------------------------------------------------------
namespace simt {
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

}  // namespace simt

// ---- bf16: tensor cores (mma.sync.m16n8k16) --------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows per block, 16 per warp
constexpr int kBK = 64;            // keys per tile
constexpr int kStages = 2;         // K/V ring depth
constexpr int kMinBlocks = 3;      // blocks per SM the registers must allow

static_assert(kBQ == kBK, "the diagonal tile of query tile t is key tile t");
// Q is staged through the second ring stage before the key loop first
// fills it, so it takes no shared memory of its own.
static_assert(kStages >= 2, "Q fits in the second stage");

template <int DH>
__host__ __device__ constexpr int ld() { return DH + 8; }  // padded row

template <int DH>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * 2 * kBK * ld<DH>() * static_cast<int>(sizeof(bf16));
}

__device__ __forceinline__ void ldsm_x4(const bf16* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(attn::smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(const bf16* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(attn::smem_addr(p))
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), packed low element first
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The producer: one kBK-row tile (rows r0.. of src, row stride rs) into
// a padded shared tile, 16 bytes per cp.async; rows at or past S are
// zero-filled and read nothing.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rs, int r0, int S) {
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < kBK * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool in = r0 + r < S;
    attn::cp_async16(dst + r * ld<DH>() + c * 8,
                     src + (in ? r0 + r : 0) * rs + c * 8, in);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           int S, int H, int group, long long qsb,
                           long long qss, long long qsh, long long ksb,
                           long long kss, long long ksh, long long vsb,
                           long long vss, long long vsh, float scale_log2) {
  constexpr int LD = ld<DH>();
  constexpr int KS = DH / 16;   // k-steps of Q K^T
  constexpr int NT = kBK / 8;   // n-tiles of S per warp
  constexpr int DT = DH / 8;    // n-tiles of O per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring: stage st holds K [kBK][LD], then V [kBK][LD]
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  auto k_tile = [&](int st) { return ring + st * 2 * kBK * LD; };
  auto v_tile = [&](int st) { return ring + (st * 2 + 1) * kBK * LD; };
  bf16* Qs = k_tile(1);                           // [kBQ][LD], at first

  const int qt = gridDim.x - 1 - blockIdx.x;  // diagonal-heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + (h / group) * ksh;
  const bf16* vb = v + b * vsb + (h / group) * vsh;

  const int n_tiles = min((S + kBK - 1) / kBK, qt + 1);
  // groups in commit order: {Q, K0}, V0, then K t+1, V t+1 per tile t
  load_tile<DH>(Qs, qb, qss, q0, S);
  load_tile<DH>(k_tile(0), kb, kss, 0, S);
  attn::cp_async_commit();
  load_tile<DH>(v_tile(0), vb, vss, 0, S);
  attn::cp_async_commit();
  attn::cp_async_wait<1>();
  __syncthreads();

  // this warp's 16 rows of Q as A fragments, for the whole key loop
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(Qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8,
            qf[kk]);
  __syncthreads();   // every warp holds its Q before stage 1 is refilled

  // thread (g = lane / 4, t = lane % 4) holds rows g and g + 8 of the
  // warp's 16, columns 2t and 2t + 1 of every 8-wide n-tile
  const int row0 = q0 + warp * 16 + lane / 4;
  float oacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.0f;
  float m_r[2] = {attn::kNegInf, attn::kNegInf};
  float l_r[2] = {0.0f, 0.0f};   // this thread's share of the row sums

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    const bf16* Kt = k_tile(kt % kStages);
    const bf16* Vt = v_tile(kt % kStages);
    // the next tile into the other stage (consumed by tile kt - 1, and
    // every warp passed the barrier at the end of that iteration)
    const int nst = (kt + 1) % kStages;
    if (kt + 1 < n_tiles)
      load_tile<DH>(k_tile(nst), kb, kss, k0 + kBK, S);
    attn::cp_async_commit();
    if (kt + 1 < n_tiles)
      load_tile<DH>(v_tile(nst), vb, vss, k0 + kBK, S);
    attn::cp_async_commit();
    attn::cp_async_wait<3>();   // K of tile kt has landed
    __syncthreads();

    // S = Q K^T: K rows are the col-major B operand, no transpose
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(Kt + (np * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                    ((lane / 8) % 2) * 8,
                bk);
        mma(s[2 * np], qf[kk], bk[0], bk[1]);
        mma(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale (log2 units), mask the diagonal tile and keys past S
    const bool edge = k0 + kBK > q0 || k0 + kBK > S;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int kp = k0 + n * 8 + 2 * (lane % 4) + (e & 1);
          const int qp = row0 + (e >> 1) * 8;
          if (kp > qp || kp >= S) x = attn::kNegInf;
        }
        s[n][e] = x;
      }

    // online softmax on the fragments: rows g (e = 0, 1) and g + 8 (2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = attn::kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float corr = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      float rs = 0.0f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * r] = exp2f(s[n][2 * r] - m_new);
        s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - m_new);
        rs += s[n][2 * r] + s[n][2 * r + 1];
      }
      l_r[r] = l_r[r] * corr + rs;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        oacc[d][2 * r] *= corr;
        oacc[d][2 * r + 1] *= corr;
      }
    }

    attn::cp_async_wait<2>();   // V of tile kt has landed
    __syncthreads();

    // O += P V, P as hi + lo bf16 halves against the same V fragment;
    // the S accumulators of n-tiles 2j, 2j + 1 are the A fragment of
    // k-step j. V rows are row-major B: ldmatrix.trans.
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t ph[4], pl[4];
      split2(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
      split2(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
      split2(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
      split2(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(Vt + (j * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                      dp * 16 + (lane / 16) * 8,
                  bv);
        mma(oacc[2 * dp], ph, bv[0], bv[1]);
        mma(oacc[2 * dp], pl, bv[0], bv[1]);
        mma(oacc[2 * dp + 1], ph, bv[2], bv[3]);
        mma(oacc[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  attn::cp_async_wait<0>();   // (only empty groups remain)

  const long long row = static_cast<long long>(H) * DH;
  bf16* ob = o + static_cast<long long>(b) * S * row + h * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float lsafe = fmaxf(l, attn::kMinSum);
    const int qp = row0 + r * 8;
    if (qp >= S) continue;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(ob + qp * row + d * 8 +
                                         2 * (lane % 4)) =
          __floats2bfloat162_rn(oacc[d][2 * r] / lsafe,
                                oacc[d][2 * r + 1] / lsafe);
  }
}

}  // namespace tc

template <int DH>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, const long long* st, float scale,
                cudaStream_t stream) {
  using T = float;
  auto kern = simt::flash_attention_kernel<T, DH>;
  constexpr int bytes = simt::smem_bytes<DH>();
  // set on every launch: the attribute is per device, and cheap to set
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + simt::kBQ - 1) / simt::kBQ, H, B);
  kern<<<grid, simt::kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, H / KV, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, const long long* st, float scale,
              cudaStream_t stream) {
  using tc::bf16;
  auto kern = tc::flash_attention_mma_kernel<DH>;
  constexpr int bytes = tc::smem_bytes<DH>();
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + tc::kBQ - 1) / tc::kBQ, H, B);
  kern<<<grid, tc::kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, H / KV,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale * 1.4426950408889634f);   // exp(x) = exp2(x log2 e)
  return static_cast<int>(cudaGetLastError());
}

int dispatch_bf16(int DH, const void* q, const void* k, const void* v,
                  void* o, int B, int S, int H, int KV, const long long* st,
                  float scale, cudaStream_t stream) {
  switch (DH) {
    case 16: return launch_tc<16>(q, k, v, o, B, S, H, KV, st, scale, stream);
    case 32: return launch_tc<32>(q, k, v, o, B, S, H, KV, st, scale, stream);
    case 64: return launch_tc<64>(q, k, v, o, B, S, H, KV, st, scale, stream);
    case 128:
      return launch_tc<128>(q, k, v, o, B, S, H, KV, st, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_fp32(int DH, const void* q, const void* k, const void* v,
                  void* o, int B, int S, int H, int KV, const long long* st,
                  float scale, cudaStream_t stream) {
  switch (DH) {
    case 16:
      return launch_simt<16>(q, k, v, o, B, S, H, KV, st, scale, stream);
    case 32:
      return launch_simt<32>(q, k, v, o, B, S, H, KV, st, scale, stream);
    case 64:
      return launch_simt<64>(q, k, v, o, B, S, H, KV, st, scale, stream);
    case 128:
      return launch_simt<128>(q, k, v, o, B, S, H, KV, st, scale, stream);
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
  return bf16 ? dispatch_bf16(DH, q, k, v, o, B, S, H, KV, st, scale, stream)
              : dispatch_fp32(DH, q, k, v, o, B, S, H, KV, st, scale, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
