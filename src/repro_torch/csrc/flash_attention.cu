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
// dv = p^T @ do.  p is never rounded to bf16 (K8 carries it as a bf16
// hi + lo pair, below).  The
// kv head of query head h is h / G (G = H / Hkv): k and v are read in
// place, never repeated.
//
// What bounds it: operations.  At T = 2048, D = 128 each K / V element
// read feeds 2 * 64 multiply-adds per tile, so the work (4 flops per open
// (query, key) pair and head dim forward, 6 for dq, 8 for dkv) sits far
// above the bytes, against the bf16 tensor-core peak.
//
// K7, the forward, runs its products as f32 FMAs out of shared memory:
// 256 threads as 16 x 16, a thread owning rows ty + 16 i of the query tile
// and columns tx + 16 j, tiles staged as f32 rows padded to D + 1 floats.
//
// K8, the backward, runs all five products on the tensor cores
// (`mma.sync` m16n8k16, bf16 operands, f32 accumulators, `ldmatrix`
// fragments; mma_tile.cuh):
//  * dq: one block per (b, h, 64 queries); dkv: one per (b, kv head, 64
//    keys).  Each open tile is two phases of 8 warps.  Phase 1 forms the
//    64 x 64 scores q . k and do . v (dkv: their transposes k . q, v . do),
//    then p and ds in registers in f32, written to shared memory as hi / lo
//    bf16 planes.  Phase 2 multiplies them: dq += ds k; dv += p^T do and
//    dk += ds^T q.  The next kv tile (dq) or q tile (dkv) is loaded into
//    registers while the current one computes.
//  * Precision: the reference keeps every operand in f32 and never rounds
//    p, ds or do.  Here each f32 operand enters a product split into bf16
//    hi + lo (mma_tile.cuh): two products where the other side is exact in
//    bf16 (the bf16 q / k / v of training), three where both are f32 (p^T
//    do always; everything for f32 inputs).  Each term is within ~2^-16 of
//    the exact product and the sums are f32, against a tolerance of 1e-3.
//  * dk / dv without atomics: a dkv block walks the G query heads of its
//    group and their open q tiles in a fixed order, accumulating in
//    registers, so a rerun is bit-identical; dq's block owns its rows.
//  * Blocks are ordered heaviest first (dq: the last q tiles, which see the
//    most keys; dkv: the first kv tiles) so the causal triangle's long
//    blocks start early.
//
// Shared by both:
//  * Tiles the mask closes are skipped: the forward and dq walk only the
//    kv tiles between the window's first key and the causal diagonal, dkv
//    only the q tiles that can see its keys.  Every row reaches a valid
//    key (its own, at least), after which a closed tile would contribute
//    exp(-1e30 - m) = 0 exactly, so skipping changes nothing.
//  * Ragged T is masked in the kernel: rows and keys past T stage as 0,
//    score -1e30, and are not stored.
//  * Tiles need up to ~177 KB of shared memory at D = 128 (dkv, f32),
//    above the 48 KB static limit: dynamic shared memory with the opt-in.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tile.cuh"

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

// ------------------------------------------------------- K8 tensor cores
// dq and dkv both work on 64 x 64 tiles with 8 warps.  Phase 1 of a tile
// computes the 64 x 64 scores and do . v products (warp w: 16 rows from
// 16 (w % 4), 32 columns from 32 (w / 4)), turns them into p and ds in
// registers and writes them to shared memory as hi / lo planes; phase 2
// multiplies those planes into the accumulators (warp w: 16 rows, D / 2
// columns from (D / 2) (w / 4)).
constexpr int BT = 64;          // query and key rows per tile
constexpr int NW = 8, NTH = 32 * NW;
constexpr int LDS_ = BT + 8;    // score planes: 144-byte rows

template <int D>
struct Ld {
  static constexpr int LDD = D + 8;  // bf16 per tile row, ldmatrix-friendly
};

// A [64][D] tile of T (rows past T as 0) through registers: 16-byte pieces
// loaded early (prefetch), stored later into the hi (and, for f32, lo)
// planes.
template <typename T, int D>
struct TileLoad {
  static constexpr int CH = D * (int)sizeof(T) / 16;  // pieces per row
  static constexpr int PER = BT * CH / NTH;
  uint4 r[PER];
  __device__ __forceinline__ void load(const T* src, int row0, int t_len,
                                       int tid) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * NTH, row = idx / CH, ch = idx % CH;
      r[i] = row0 + row < t_len
                 ? __ldg(reinterpret_cast<const uint4*>(
                             src + (size_t)(row0 + row) * D) + ch)
                 : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* hi,
                                        __nv_bfloat16* lo, int tid) const {
    constexpr int LDD = Ld<D>::LDD;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * NTH, row = idx / CH, ch = idx % CH;
      if constexpr (std::is_same<T, float>::value) {
        uint2 h, l;
        mt::split2(__uint_as_float(r[i].x), __uint_as_float(r[i].y), h.x,
                   l.x);
        mt::split2(__uint_as_float(r[i].z), __uint_as_float(r[i].w), h.y,
                   l.y);
        *reinterpret_cast<uint2*>(hi + row * LDD + 4 * ch) = h;
        *reinterpret_cast<uint2*>(lo + row * LDD + 4 * ch) = l;
      } else {
        *reinterpret_cast<uint4*>(hi + row * LDD + 8 * ch) = r[i];
      }
    }
  }
};

// acc[NT][4] += A (16 rows at r0 of the `ah` / `al` planes, row stride
// lda) times B (NT n-tiles from n0 of the `bh` / `bl` planes, stored
// n-major [n][ldb] when KN is false, k-major [k][ldb] when true) over depth
// K, as the split products a_hi b_hi + a_hi b_lo (BLO) + a_lo b_hi (ALO).
template <int NT, int K, bool ALO, bool BLO, bool KN>
__device__ __forceinline__ void mma_tile(float (*acc)[4],
                                         const __nv_bfloat16* ah,
                                         const __nv_bfloat16* al, int lda,
                                         int r0, const __nv_bfloat16* bh,
                                         const __nv_bfloat16* bl, int ldb,
                                         int n0, int lane) {
#pragma unroll
  for (int k = 0; k < K; k += 16) {
    uint32_t xh[4], xl[4];
    mt::load_a(xh, ah, lda, r0, k, lane);
    if (ALO) mt::load_a(xl, al, lda, r0, k, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t yh[4], yl[4];
      if (KN) {
        mt::load_b_kn(yh, bh, ldb, n0 + 16 * np, k, lane);
        if (BLO) mt::load_b_kn(yl, bl, ldb, n0 + 16 * np, k, lane);
      } else {
        mt::load_b_nk(yh, bh, ldb, n0 + 16 * np, k, lane);
        if (BLO) mt::load_b_nk(yl, bl, ldb, n0 + 16 * np, k, lane);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mt::mma(acc[2 * np + j], xh, yh + 2 * j);
        if (BLO) mt::mma(acc[2 * np + j], xh, yl + 2 * j);
        if (ALO) mt::mma(acc[2 * np + j], xl, yh + 2 * j);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// ds (and p) of accumulator element e of n-tile j: scores s, products dp,
// row's / column's lse and delta; the score is masked where (qi, ki) is
// closed.
__device__ __forceinline__ float grad_score(float s, float dp, float lse_,
                                            float delta_, int qi, int ki,
                                            const Params& p, float& prob) {
  const float sc = cap_score(s, p);
  const float sm_ = valid(qi, ki, p) ? sc : NEG_INF;
  prob = expf(sm_ - lse_);
  float ds = prob * (dp - delta_);
  if (p.has_cap) ds *= 1.f - (sc / p.cap) * (sc / p.cap);
  return ds;
}

// planes of one kernel, carved from dynamic shared memory
struct Carve {
  unsigned char* at;
  __device__ __forceinline__ __nv_bfloat16* take(int elems, bool keep = true) {
    if (!keep) return nullptr;
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(at);
    at += elems * 2;
    return out;
  }
};

template <typename T, int D>
constexpr size_t dq_smem() {
  constexpr bool S = std::is_same<T, float>::value;
  return (size_t)2 * BT * Ld<D>::LDD * ((S ? 2 : 1) * 3 + 2) +
         (size_t)2 * 2 * BT * LDS_;
}
template <typename T, int D>
constexpr size_t dkv_smem() {
  constexpr bool S = std::is_same<T, float>::value;
  return (size_t)2 * BT * Ld<D>::LDD * ((S ? 2 : 1) * 3 + 2) +
         (size_t)2 * 4 * BT * LDS_ + 2 * BT * sizeof(float);
}

// q and do tiles of query head bh from q0, and lse (threads 0-63) or
// delta (64-127) of their rows, into registers
template <typename T, int D>
__device__ __forceinline__ void fetch_q(TileLoad<T, D>& qt,
                                        TileLoad<float, D>& gt, float& rows,
                                        const T* __restrict__ q,
                                        const float* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        size_t bh, int q0, const Params& p,
                                        int tid) {
  qt.load(q + bh * p.T * D, q0, p.T, tid);
  gt.load(dout + bh * p.T * D, q0, p.T, tid);
  const int qi = q0 + (tid & (BT - 1));
  if (tid < 2 * BT)
    rows = qi < p.T ? (tid < BT ? lse : delta)[bh * p.T + qi] : 0.f;
}

// ---------------------------------------------------------------- K8 dq
// grid B * H * ceil(T / 64) (the q tiles with most kv tiles first), block
// 256.  dq = ds @ k * scale over the open kv tiles.
template <typename T, int D>
__global__ void __launch_bounds__(NTH, 1)
    flash_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int batch, Params p) {
  constexpr bool S = std::is_same<T, float>::value;
  constexpr int LDD = Ld<D>::LDD, NT2 = D / 16;  // phase-2 n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Carve cv{smem_raw};
  __nv_bfloat16 *qh = cv.take(BT * LDD), *ql = cv.take(BT * LDD, S);
  __nv_bfloat16 *gh = cv.take(BT * LDD), *gl = cv.take(BT * LDD);
  __nv_bfloat16 *kh = cv.take(BT * LDD), *kl = cv.take(BT * LDD, S);
  __nv_bfloat16 *vh = cv.take(BT * LDD), *vl = cv.take(BT * LDD, S);
  __nv_bfloat16 *dsh = cv.take(BT * LDS_), *dsl = cv.take(BT * LDS_);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, cq = lane & 3;
  const int nq = (p.T + BT - 1) / BT, nbh = batch * p.H;
  const int bh = blockIdx.x % nbh, q0 = (nq - 1 - blockIdx.x / nbh) * BT;
  const int b = bh / p.H, G = p.H / p.Hkv, hk = (bh % p.H) / G;
  const size_t kv_off = (size_t)(b * p.Hkv + hk) * p.T * D;
  {
    TileLoad<T, D> ql_;
    TileLoad<float, D> gl_;
    ql_.load(q + (size_t)bh * p.T * D, q0, p.T, tid);
    gl_.load(dout + (size_t)bh * p.T * D, q0, p.T, tid);
    ql_.store(qh, ql, tid);
    gl_.store(gh, gl, tid);
  }
  float lr[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 16 * wm + g + 8 * i;
    lr[i] = qi < p.T ? lse[(size_t)bh * p.T + qi] : 0.f;
    dl[i] = qi < p.T ? delta[(size_t)bh * p.T + qi] : 0.f;
  }
  float acc[NT2][4];
  zero<NT2>(acc);
  int lo, hi;
  kv_tiles(q0, BT, BT, p, lo, hi);
  TileLoad<T, D> kt, vt;
  kt.load(k + kv_off, lo * BT, p.T, tid);
  vt.load(v + kv_off, lo * BT, p.T, tid);
  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * BT;
    __syncthreads();  // previous tile's planes consumed
    kt.store(kh, kl, tid);
    vt.store(vh, vl, tid);
    if (jt < hi) {
      kt.load(k + kv_off, k0 + BT, p.T, tid);
      vt.load(v + kv_off, k0 + BT, p.T, tid);
    }
    __syncthreads();
    {  // phase 1: s = q k^T, dp = do v^T; 16 q rows x 32 keys per warp
      float s[4][4], dp[4][4];
      zero<4>(s);
      zero<4>(dp);
      mma_tile<4, D, S, S, false>(s, qh, ql, LDD, 16 * wm, kh, kl, LDD,
                                  32 * wn, lane);
      mma_tile<4, D, true, S, false>(dp, gh, gl, LDD, 16 * wm, vh, vl, LDD,
                                     32 * wn, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 16 * wm + g + 8 * i, c = 32 * wn + 8 * j + 2 * cq;
          float pr, ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            ds[e] = grad_score(s[j][2 * i + e], dp[j][2 * i + e], lr[i],
                               dl[i], q0 + r, k0 + c + e, p, pr);
          uint32_t h2, l2;
          mt::split2(ds[0], ds[1], h2, l2);
          *reinterpret_cast<uint32_t*>(dsh + r * LDS_ + c) = h2;
          *reinterpret_cast<uint32_t*>(dsl + r * LDS_ + c) = l2;
        }
    }
    __syncthreads();
    // phase 2: dq += ds k; 16 q rows x D / 2 columns per warp
    mma_tile<NT2, BT, true, S, true>(acc, dsh, dsl, LDS_, 16 * wm, kh, kl,
                                     LDD, (D / 2) * wn, lane);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 16 * wm + g + 8 * i;
    if (qi >= p.T) continue;
    float* row = dq + ((size_t)bh * p.T + qi) * D + (D / 2) * wn;
#pragma unroll
    for (int j = 0; j < NT2; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * cq) = make_float2(
          acc[j][2 * i] * p.scale, acc[j][2 * i + 1] * p.scale);
  }
}

// --------------------------------------------------------------- K8 dkv
// grid B * Hkv * ceil(T / 64) (the kv tiles seen by most q tiles first),
// block 256.  Walks the G query heads of its group and their open q tiles
// in order: dk = ds^T q * scale, dv = p^T do.
template <typename T, int D>
__global__ void __launch_bounds__(NTH, 1)
    flash_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int batch,
              Params p) {
  constexpr bool S = std::is_same<T, float>::value;
  constexpr int LDD = Ld<D>::LDD, NT2 = D / 16;  // phase-2 n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Carve cv{smem_raw};
  __nv_bfloat16 *kh = cv.take(BT * LDD), *kl = cv.take(BT * LDD, S);
  __nv_bfloat16 *vh = cv.take(BT * LDD), *vl = cv.take(BT * LDD, S);
  __nv_bfloat16 *qh = cv.take(BT * LDD), *ql = cv.take(BT * LDD, S);
  __nv_bfloat16 *gh = cv.take(BT * LDD), *gl = cv.take(BT * LDD);
  __nv_bfloat16 *ph = cv.take(BT * LDS_), *pl = cv.take(BT * LDS_);
  __nv_bfloat16 *dsh = cv.take(BT * LDS_), *dsl = cv.take(BT * LDS_);
  float* s_lse = reinterpret_cast<float*>(cv.at);
  float* s_dl = s_lse + BT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, cq = lane & 3;
  const int nbk = batch * p.Hkv;
  const int bk = blockIdx.x % nbk, k0 = (blockIdx.x / nbk) * BT;
  const int b = bk / p.Hkv, hk = bk % p.Hkv, G = p.H / p.Hkv;
  const size_t kv_off = (size_t)bk * p.T * D;
  {
    TileLoad<T, D> kt, vt;
    kt.load(k + kv_off, k0, p.T, tid);
    vt.load(v + kv_off, k0, p.T, tid);
    kt.store(kh, kl, tid);
    vt.store(vh, vl, tid);
  }
  float dka[NT2][4], dva[NT2][4];
  zero<NT2>(dka);
  zero<NT2>(dva);
  int lo, hi;
  q_tiles(k0, BT, BT, p, lo, hi);
  const int per = hi - lo + 1, n_it = G * per;
  // iteration i: query head hk * G + i / per, q tile lo + i % per; its
  // q / do tiles and lse (threads 0-63) or delta (64-127) rows are loaded
  // one iteration ahead
  TileLoad<T, D> qt;
  TileLoad<float, D> gt;
  float rows = 0.f;
  if (n_it > 0)
    fetch_q<T, D>(qt, gt, rows, q, dout, lse, delta,
                  (size_t)b * p.H + hk * G, lo * BT, p, tid);
  for (int it = 0; it < n_it; ++it) {
    const int q0 = (lo + it % per) * BT;
    __syncthreads();  // previous tile's planes consumed
    qt.store(qh, ql, tid);
    gt.store(gh, gl, tid);
    if (tid < 2 * BT) s_lse[tid] = rows;  // s_dl follows s_lse
    if (it + 1 < n_it)
      fetch_q<T, D>(qt, gt, rows, q, dout, lse, delta,
                    (size_t)b * p.H + hk * G + (it + 1) / per,
                    (lo + (it + 1) % per) * BT, p, tid);
    __syncthreads();
    {  // phase 1: s^T = k q^T, dp^T = v do^T; 16 keys x 32 queries a warp
      float s[4][4], dp[4][4];
      zero<4>(s);
      zero<4>(dp);
      mma_tile<4, D, S, S, false>(s, kh, kl, LDD, 16 * wm, qh, ql, LDD,
                                  32 * wn, lane);
      mma_tile<4, D, S, true, false>(dp, vh, vl, LDD, 16 * wm, gh, gl, LDD,
                                     32 * wn, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 16 * wm + g + 8 * i, c = 32 * wn + 8 * j + 2 * cq;
          float pr[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            ds[e] = grad_score(s[j][2 * i + e], dp[j][2 * i + e],
                               s_lse[c + e], s_dl[c + e], q0 + c + e,
                               k0 + r, p, pr[e]);
          uint32_t h2, l2;
          mt::split2(pr[0], pr[1], h2, l2);
          *reinterpret_cast<uint32_t*>(ph + r * LDS_ + c) = h2;
          *reinterpret_cast<uint32_t*>(pl + r * LDS_ + c) = l2;
          mt::split2(ds[0], ds[1], h2, l2);
          *reinterpret_cast<uint32_t*>(dsh + r * LDS_ + c) = h2;
          *reinterpret_cast<uint32_t*>(dsl + r * LDS_ + c) = l2;
        }
    }
    __syncthreads();
    // phase 2: dv += p^T do, dk += ds^T q; 16 keys x D / 2 columns a warp
    mma_tile<NT2, BT, true, true, true>(dva, ph, pl, LDS_, 16 * wm, gh, gl,
                                        LDD, (D / 2) * wn, lane);
    mma_tile<NT2, BT, true, S, true>(dka, dsh, dsl, LDS_, 16 * wm, qh, ql,
                                     LDD, (D / 2) * wn, lane);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ki = k0 + 16 * wm + g + 8 * i;
    if (ki >= p.T) continue;
    const size_t row = ((size_t)bk * p.T + ki) * D + (D / 2) * wn;
#pragma unroll
    for (int j = 0; j < NT2; ++j) {
      *reinterpret_cast<float2*>(dk + row + 8 * j + 2 * cq) = make_float2(
          dka[j][2 * i] * p.scale, dka[j][2 * i + 1] * p.scale);
      *reinterpret_cast<float2*>(dv + row + 8 * j + 2 * cq) =
          make_float2(dva[j][2 * i], dva[j][2 * i + 1]);
    }
  }
}

// Tiles per head dim: (BQ, BK) of the forward.
template <int D>
struct Tiles;
template <>
struct Tiles<32> {
  static constexpr int FQ = 64, FK = 64;
};
template <>
struct Tiles<64> {
  static constexpr int FQ = 64, FK = 64;
};
template <>
struct Tiles<128> {
  static constexpr int FQ = 64, FK = 32;
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
  constexpr size_t smem = dq_smem<T, D>();
  auto kern = flash_dq<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = batch * p.H * ((p.T + BT - 1) / BT);
  kern<<<blocks, NTH, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dout, lse, delta, dqo, batch, p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const float* dout,
        const float* lse, const float* delta, float* dko, float* dvo,
        int batch, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<T, D>();
  auto kern = flash_dkv<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = batch * p.Hkv * ((p.T + BT - 1) / BT);
  kern<<<blocks, NTH, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dout, lse, delta, dko, dvo, batch, p);
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
