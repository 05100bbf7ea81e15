// Blockwise (flash) self-attention for Hopper: the forward (K7) and the
// recompute backward (K8: dq, and dk / dv summed over the query group).
//
// Replaces the TPU kernels `_fwd_kernel`, `_dq_kernel` and `_dkv_kernel` of
// src/repro/kernels/flash_attention.py (launched by `flash_attention_fwd`
// and `flash_attention_bwd`).
//
//   q [B, H, T, D], k / v [B, Hkv, T, D]   bf16 or f32, upcast to f32
//   do [B, H, T, D], lse / delta [B, H, T]  f32 (delta = rowsum(do * o))
//   -> o [B, H, T, D] f32, lse; dq [B, H, T, D]; dk, dv [B, Hkv, T, D] f32
//
// Semantics are the TPU kernels': s = (q . k) * scale, then s = cap *
// tanh(s / cap) when capped, then s = -1e30 where the key is outside the
// mask (causal: ki <= qi; window: ki > qi - window; and ki, qi < T).  The
// forward keeps (m, l, acc) per row with an online softmax in f32 and
// writes o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).  The
// backward recomputes p = exp(s - lse), ds = p * (do . v - delta), times
// 1 - (s / cap)^2 when capped; dq = ds @ k * scale, dk = ds^T @ q * scale,
// dv = p^T @ do.  p stays f32 throughout (never rounded to bf16).  The
// kv head of query head h is h / G (G = H / Hkv): k and v are read in
// place, never repeated.
//
// What bounds it: operations.  At T = 2048, D = 128 each K / V element
// read feeds 2 * BQ multiply-adds per tile, so the work is ~4 B H T^2 D / 2
// flops causal (backward ~2.5x), far above the bytes.  This first kernel
// runs them as f32 FMAs out of shared memory (no tensor cores), so it
// stays well below the card's bf16 tensor-core peak; `wgmma`, TMA and a
// pipelined tile ring are later work.
//
// Design:
//  * 256 threads as 16 x 16.  A thread owns rows ty + 16 i of the query
//    tile and columns tx + 16 j of the score tile / of D, so the 16 threads
//    of a row sit in one half-warp and reduce a row's max and sum with
//    4 shuffles.  Tiles are staged in shared memory as f32, rows padded to
//    D + 1 floats so the column-strided reads hit distinct banks.
//  * Tiles the mask closes are skipped: the forward and dq walk only the
//    kv tiles between the window's first key and the causal diagonal, dkv
//    only the q tiles that can see its keys.  Every row reaches a valid
//    key (its own, at least), after which a closed tile would contribute
//    exp(-1e30 - m) = 0 exactly, so skipping changes nothing.
//  * Ragged T is masked in the kernel: rows and keys past T stage as 0,
//    score -1e30, and are not stored.
//  * dkv: one block per (b, kv head, kv tile) walks the G query heads of
//    its group and their q tiles in order, accumulating dk / dv in
//    registers: no atomics, a rerun is bit-identical.
//  * Q, dO, K, V and two score tiles need up to ~116 KB at D = 128, above
//    the 48 KB static limit: dynamic shared memory with the opt-in.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TX = 16, TY = 16, NT = TX * TY;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// max / sum over the 16 threads of a row (one half-warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Params {
  int H, Hkv, T;
  int causal, window;  // window < 0: none
  float scale, cap;
  int has_cap;
};

__device__ __forceinline__ bool valid(int qi, int ki, const Params& p) {
  bool ok = qi < p.T && ki < p.T;
  if (p.causal) ok = ok && ki <= qi;
  if (p.window >= 0) ok = ok && ki > qi - p.window;
  return ok;
}

// scaled, then soft-capped score
__device__ __forceinline__ float cap_score(float dot, const Params& p) {
  float s = dot * p.scale;
  if (p.has_cap) s = p.cap * tanhf(s / p.cap);
  return s;
}

// rows [row0, row0 + nrows) of a [T, D] slab into dst (leading dim ld) as
// f32; rows past T stage as 0.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int row0, int nrows, int t_len,
                                      int tid) {
  for (int e = tid; e < nrows * D; e += NT) {
    const int r = e / D, c = e % D;
    dst[r * ld + c] =
        row0 + r < t_len ? to_f32<T>(src[(size_t)(row0 + r) * D + c]) : 0.f;
  }
}

// kv tiles [lo, hi] that the mask leaves open for queries [q0, q0 + bq)
__device__ __forceinline__ void kv_tiles(int q0, int bq, int bk,
                                         const Params& p, int& lo, int& hi) {
  lo = p.window >= 0 ? max(0, q0 - p.window + 1) / bk : 0;
  hi = (p.causal ? min(p.T - 1, q0 + bq - 1) : p.T - 1) / bk;
}

// q tiles [lo, hi] that can see keys [k0, k0 + bk)
__device__ __forceinline__ void q_tiles(int k0, int bq, int bk,
                                        const Params& p, int& lo, int& hi) {
  lo = p.causal ? k0 / bq : 0;
  const int last = p.window >= 0 ? min(p.T - 1, k0 + bk - 2 + p.window)
                                 : p.T - 1;
  hi = last / bq;
}

// ------------------------------------------------------------------ K7
// grid B * H * ceil(T / BQ), block (16, 16).
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(NT)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, Params p) {
  constexpr int RI = BQ / TY, CJ = BK / TX, DJ = D / TX, LD = D + 1;
  constexpr int LS = BK + 1;
  extern __shared__ float sm[];
  float* qs = sm;             // [BQ][LD]
  float* ks = qs + BQ * LD;   // [BK][LD]
  float* vs = ks + BK * LD;   // [BK][D]
  float* ps = vs + BK * D;    // [BQ][LS]
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int nq = (p.T + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq, q0 = (blockIdx.x % nq) * BQ;
  const int b = bh / p.H, G = p.H / p.Hkv, hk = (bh % p.H) / G;
  const size_t kv_off = (size_t)(b * p.Hkv + hk) * p.T * D;
  stage<T, D>(qs, LD, q + (size_t)bh * p.T * D, q0, BQ, p.T, tid);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  kv_tiles(q0, BQ, BK, p, lo, hi);
  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // previous tiles consumed
    stage<T, D>(ks, LD, k + kv_off, k0, BK, p.T, tid);
    stage<T, D>(vs, D, v + kv_off, k0, BK, p.T, tid);
    __syncthreads();
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RI], c[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = qs[(ty + TY * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) c[j] = ks[(tx + TX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + TY * i, qi = q0 + r;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float x = cap_score(s[i][j], p);
        s[i][j] = valid(qi, k0 + tx + TX * j, p) ? x : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mt));
      const float corr = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float e = expf(s[i][j] - mn);
        rs += e;
        ps[r * LS + tx + TX * j] = e;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * D + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float pr = ps[(ty + TY * i) * LS + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pr, vv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + TY * i;
    if (qi >= p.T) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    float* orow = o + ((size_t)bh * p.T + qi) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + TX * j] = acc[i][j] / lf;
    if (tx == 0) lse[(size_t)bh * p.T + qi] = m[i] + logf(lf);
  }
}

// ---------------------------------------------------------------- K8 dq
// grid B * H * ceil(T / BQ), block (16, 16).
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(NT)
    flash_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, Params p) {
  constexpr int RI = BQ / TY, CJ = BK / TX, DJ = D / TX, LD = D + 1;
  constexpr int LS = BK + 1;
  extern __shared__ float sm[];
  float* qs = sm;              // [BQ][LD]
  float* gs = qs + BQ * LD;    // dO [BQ][LD]
  float* ks = gs + BQ * LD;    // [BK][LD]
  float* vs = ks + BK * LD;    // [BK][LD]
  float* dss = vs + BK * LD;   // [BQ][LS]
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int nq = (p.T + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq, q0 = (blockIdx.x % nq) * BQ;
  const int b = bh / p.H, G = p.H / p.Hkv, hk = (bh % p.H) / G;
  const size_t kv_off = (size_t)(b * p.Hkv + hk) * p.T * D;
  stage<T, D>(qs, LD, q + (size_t)bh * p.T * D, q0, BQ, p.T, tid);
  stage<float, D>(gs, LD, dout + (size_t)bh * p.T * D, q0, BQ, p.T, tid);
  float lr[RI], dl[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + TY * i;
    lr[i] = qi < p.T ? lse[(size_t)bh * p.T + qi] : 0.f;
    dl[i] = qi < p.T ? delta[(size_t)bh * p.T + qi] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  kv_tiles(q0, BQ, BK, p, lo, hi);
  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();
    stage<T, D>(ks, LD, k + kv_off, k0, BK, p.T, tid);
    stage<T, D>(vs, LD, v + kv_off, k0, BK, p.T, tid);
    __syncthreads();
    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RI], g[RI], kc[CJ], vc[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        a[i] = qs[(ty + TY * i) * LD + d];
        g[i] = gs[(ty + TY * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kc[j] = ks[(tx + TX * j) * LD + d];
        vc[j] = vs[(tx + TX * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(a[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float sc = cap_score(s[i][j], p);
        const float sm_ = valid(q0 + r, k0 + tx + TX * j, p) ? sc : NEG_INF;
        float ds = expf(sm_ - lr[i]) * (dp[i][j] - dl[i]);
        if (p.has_cap) ds *= 1.f - (sc / p.cap) * (sc / p.cap);
        dss[r * LS + tx + TX * j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float kk[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kk[j] = ks[c * LD + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float x = dss[(ty + TY * i) * LS + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(x, kk[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + TY * i;
    if (qi >= p.T) continue;
    float* row = dq + ((size_t)bh * p.T + qi) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + TX * j] = acc[i][j] * p.scale;
  }
}

// --------------------------------------------------------------- K8 dkv
// grid B * Hkv * ceil(T / BK), block (16, 16).
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(NT)
    flash_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, Params p) {
  constexpr int RI = BQ / TY, CJ = BK / TX, KI = BK / TY, DJ = D / TX;
  constexpr int LD = D + 1, LS = BK + 1;
  extern __shared__ float sm[];
  float* ks = sm;              // [BK][LD]
  float* vs = ks + BK * LD;    // [BK][LD]
  float* qs = vs + BK * LD;    // [BQ][LD]
  float* gs = qs + BQ * LD;    // dO [BQ][LD]
  float* ps = gs + BQ * LD;    // [BQ][LS]
  float* dss = ps + BQ * LS;   // [BQ][LS]
  float* ls = dss + BQ * LS;   // lse [BQ]
  float* dls = ls + BQ;        // delta [BQ]
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int nk = (p.T + BK - 1) / BK;
  const int bk = blockIdx.x / nk, k0 = (blockIdx.x % nk) * BK;
  const int b = bk / p.Hkv, hk = bk % p.Hkv, G = p.H / p.Hkv;
  const size_t kv_off = (size_t)bk * p.T * D;
  stage<T, D>(ks, LD, k + kv_off, k0, BK, p.T, tid);
  stage<T, D>(vs, LD, v + kv_off, k0, BK, p.T, tid);
  float dka[KI][DJ], dva[KI][DJ];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.f;
  int lo, hi;
  q_tiles(k0, BQ, BK, p, lo, hi);
  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)b * p.H + hk * G + g;
    for (int it = lo; it <= hi; ++it) {
      const int q0 = it * BQ;
      __syncthreads();  // previous q tile consumed (K, V visible)
      stage<T, D>(qs, LD, q + bh * p.T * D, q0, BQ, p.T, tid);
      stage<float, D>(gs, LD, dout + bh * p.T * D, q0, BQ, p.T, tid);
      for (int r = tid; r < BQ; r += NT) {
        const int qi = q0 + r;
        ls[r] = qi < p.T ? lse[bh * p.T + qi] : 0.f;
        dls[r] = qi < p.T ? delta[bh * p.T + qi] : 0.f;
      }
      __syncthreads();
      float s[RI][CJ], dp[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[RI], gg[RI], kc[CJ], vc[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          a[i] = qs[(ty + TY * i) * LD + d];
          gg[i] = gs[(ty + TY * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          kc[j] = ks[(tx + TX * j) * LD + d];
          vc[j] = vs[(tx + TX * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            s[i][j] = fmaf(a[i], kc[j], s[i][j]);
            dp[i][j] = fmaf(gg[i], vc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + TY * i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = tx + TX * j;
          const float sc = cap_score(s[i][j], p);
          const float sm_ = valid(q0 + r, k0 + c, p) ? sc : NEG_INF;
          const float pr = expf(sm_ - ls[r]);
          float ds = pr * (dp[i][j] - dls[r]);
          if (p.has_cap) ds *= 1.f - (sc / p.cap) * (sc / p.cap);
          ps[r * LS + c] = pr;
          dss[r * LS + c] = ds;
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float go[DJ], qq[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          go[j] = gs[r * LD + tx + TX * j];
          qq[j] = qs[r * LD + tx + TX * j];
        }
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          const int c = ty + TY * i;
          const float pr = ps[r * LS + c], ds = dss[r * LS + c];
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dva[i][j] = fmaf(pr, go[j], dva[i][j]);
            dka[i][j] = fmaf(ds, qq[j], dka[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int ki = k0 + ty + TY * i;
    if (ki >= p.T) continue;
    const size_t row = ((size_t)bk * p.T + ki) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[row + tx + TX * j] = dka[i][j] * p.scale;
      dv[row + tx + TX * j] = dva[i][j];
    }
  }
}

// Tiles per head dim: (BQ, BK) of the forward and dq, and dkv's (BQ, BK).
template <int D>
struct Tiles;
template <>
struct Tiles<32> {
  static constexpr int FQ = 64, FK = 64, KQ = 32, KK = 64;
};
template <>
struct Tiles<64> {
  static constexpr int FQ = 64, FK = 64, KQ = 32, KK = 64;
};
template <>
struct Tiles<128> {
  static constexpr int FQ = 64, FK = 32, KQ = 32, KK = 32;
};

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, float* o, float* lse,
        int batch, const Params& p, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::FQ, BK = Tiles<D>::FK;
  const size_t smem = sizeof(float) *
                      (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  auto kern = flash_fwd<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = batch * p.H * ((p.T + BQ - 1) / BQ);
  kern<<<blocks, dim3(TX, TY), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o, lse, p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const float* dout,
       const float* lse, const float* delta, float* dqo, int batch,
       const Params& p, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::FQ, BK = Tiles<D>::FK;
  const size_t smem =
      sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
  auto kern = flash_dq<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = batch * p.H * ((p.T + BQ - 1) / BQ);
  kern<<<blocks, dim3(TX, TY), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dout, lse, delta, dqo, p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const float* dout,
        const float* lse, const float* delta, float* dko, float* dvo,
        int batch, const Params& p, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::KQ, BK = Tiles<D>::KK;
  const size_t smem = sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) +
                                       2 * BQ * (BK + 1) + 2 * BQ);
  auto kern = flash_dkv<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = batch * p.Hkv * ((p.T + BK - 1) / BK);
  kern<<<blocks, dim3(TX, TY), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dout, lse, delta, dko, dvo, p);
  return (int)cudaGetLastError();
}

bool make_params(int h, int hkv, int t, int causal, int window, float scale,
                 float cap, int has_cap, Params& p) {
  if (hkv <= 0 || h % hkv != 0 || t <= 0 || (has_cap && cap == 0.f))
    return false;
  p.H = h;
  p.Hkv = hkv;
  p.T = t;
  p.causal = causal;
  p.window = window < 0 ? -1 : window;
  p.scale = scale;
  p.cap = cap;
  p.has_cap = has_cap;
  return true;
}

}  // namespace

// kind: 0 = bf16 q / k / v, 1 = f32.  d in {32, 64, 128}.  window < 0 means
// no window.  o, dq [B, H, T, D]; lse, delta [B, H, T]; dk, dv [B, Hkv, T,
// D]; all f32 and contiguous.  Each returns the cudaError_t of its launch.
#define FA_DISPATCH(CALL)                                \
  if (kind == 0 && d == 32) return CALL(__nv_bfloat16, 32);   \
  if (kind == 0 && d == 64) return CALL(__nv_bfloat16, 64);   \
  if (kind == 0 && d == 128) return CALL(__nv_bfloat16, 128); \
  if (kind == 1 && d == 32) return CALL(float, 32);           \
  if (kind == 1 && d == 64) return CALL(float, 64);           \
  if (kind == 1 && d == 128) return CALL(float, 128);         \
  return (int)cudaErrorInvalidValue

extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int kind, int batch, int h, int hkv, int t, int d, int causal,
    int window, float scale, float cap, int has_cap, void* stream) {
  Params p;
  if (batch <= 0 ||
      !make_params(h, hkv, t, causal, window, scale, cap, has_cap, p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
#define FA_FWD(T_, D_) fwd<T_, D_>(q, k, v, of, lf, batch, p, s)
  FA_DISPATCH(FA_FWD);
#undef FA_FWD
}

extern "C" int flash_attention_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq_out, int kind, int batch,
    int h, int hkv, int t, int d, int causal, int window, float scale,
    float cap, int has_cap, void* stream) {
  Params p;
  if (batch <= 0 ||
      !make_params(h, hkv, t, causal, window, scale, cap, has_cap, p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* out = static_cast<float*>(dq_out);
#define FA_DQ(T_, D_) dq<T_, D_>(q, k, v, g, lf, dl, out, batch, p, s)
  FA_DISPATCH(FA_DQ);
#undef FA_DQ
}

extern "C" int flash_attention_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk_out, void* dv_out,
    int kind, int batch, int h, int hkv, int t, int d, int causal,
    int window, float scale, float cap, int has_cap, void* stream) {
  Params p;
  if (batch <= 0 ||
      !make_params(h, hkv, t, causal, window, scale, cap, has_cap, p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dko = static_cast<float*>(dk_out);
  float* dvo = static_cast<float*>(dv_out);
#define FA_DKV(T_, D_) dkv<T_, D_>(q, k, v, g, lf, dl, dko, dvo, batch, p, s)
  FA_DISPATCH(FA_DKV);
#undef FA_DKV
}
