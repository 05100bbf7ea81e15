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
// dv = p^T @ do.  p is never rounded to bf16 (both carry it as a bf16
// hi + lo pair, below).  The kv head of query head h is h / G (G = H /
// Hkv): k and v are read in place, never repeated.
//
// What bounds it: operations.  At T = 2048, D = 128 each K / V element
// read feeds 2 * 64 multiply-adds per tile, so the work (4 flops per open
// (query, key) pair and head dim forward, 6 for dq, 8 for dkv) sits far
// above the bytes, against the bf16 tensor-core peak.
//
// Both run every product on the tensor cores (`mma.sync` m16n8k16, bf16
// operands, f32 accumulators, `ldmatrix` fragments; mma_tile.cuh).
//
// K7, the forward:
//  * One block per (b, h, 64 queries), 4 warps, each owning 16 query rows
//    whose q fragments stay in registers for the whole kv walk.
//  * Per kv tile of 64 keys, s = q k^T lands in registers; scale, cap,
//    mask (only on tiles the mask cuts) and the online max and sum run
//    there, the row's four lanes combined by shuffles.
//  * p stays f32: it enters p v as bf16 hi + lo A fragments built from
//    the score accumulators in registers, never through shared memory.
//  * bf16 K / V tiles are double-buffered with `cp.async`, so the next
//    tile loads while this one computes; f32 ones are split into hi / lo
//    planes through registers.
//
// K8, the backward:
//  * dq: one block per (b, h, 64 queries); dkv: one per (b, kv head, 64
//    keys).  Each open tile is two phases of 8 warps.  Phase 1 forms the
//    64 x 64 scores q . k and do . v (dkv: their transposes k . q, v . do),
//    then p and ds in registers in f32, written to shared memory as hi / lo
//    bf16 planes.  Phase 2 multiplies them: dq += ds k; dv += p^T do and
//    dk += ds^T q.  The next kv tile (dq) or q tile (dkv) is loaded into
//    registers while the current one computes.
//  * dk / dv without atomics: a dkv block walks the G query heads of its
//    group and their open q tiles in a fixed order, accumulating in
//    registers, so a rerun is bit-identical; dq's block owns its rows.
//
// Shared by both:
//  * Precision: the reference keeps every operand in f32 and never rounds
//    p, ds or do.  Here each f32 operand enters a product split into bf16
//    hi + lo (mma_tile.cuh): one product where both sides are exact in
//    bf16 (q k^T of the bf16 q / k / v of training), two where one side is,
//    three where both are f32 (p^T do always; everything for f32 inputs).
//    Each term is within ~2^-16 of the exact product and the sums are f32,
//    against a tolerance of 1e-4 (K7) and 1e-3 (K8).
//  * Blocks are ordered heaviest first (the forward and dq: the last q
//    tiles, which see the most keys; dkv: the first kv tiles) so the
//    causal triangle's long blocks start early.
//  * Tiles the mask closes are skipped: the forward and dq walk only the
//    kv tiles between the window's first key and the causal diagonal, dkv
//    only the q tiles that can see its keys.  Every row reaches a valid
//    key (its own, at least), after which a closed tile would contribute
//    exp(-1e30 - m) = 0 exactly, so skipping changes nothing.
//  * Ragged T is masked in the kernel: rows and keys past T stage as 0,
//    score -1e30, and are not stored.
//  * Head dims 32, 64, 80, 96, 128 and 256.  Up to 128, K7 keeps its q
//    fragments in registers and K8 prefetches the next tile into them; at
//    256 the accumulators (D / 2 columns a warp) need those registers, so
//    K7 reads q's fragments from shared memory each kv tile and K8 stages
//    each tile straight into shared memory.  K8's f32 planes of 64 rows
//    at D = 256 would need 264-282 KB, so there its query tiles are 32
//    rows (bq_of).  D = 80 leaves K8's phase 2 an odd count of 8-column
//    n-tiles (40 columns a warp), taken by one ldmatrix.x2 step.
//  * Tiles need up to ~218 KB of shared memory (dkv, f32, D = 256; the
//    forward at D = 128 68 KB), above the 48 KB static limit: dynamic
//    shared memory with the opt-in.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tile.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
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

// A [R][D] tile of T (rows past T as 0) through registers: 16-byte pieces
// loaded early (prefetch), stored later into the hi (and, for f32, lo)
// planes.  N threads share the R * CH pieces; where N does not divide them
// (D = 80 in bf16: 640 pieces over 256 threads) the last round is partial.
template <typename T, int D, int N = NTH, int R = BT>
struct TileLoad {
  static constexpr int CH = D * (int)sizeof(T) / 16;  // pieces per row
  static constexpr int ALL = R * CH;
  static constexpr int PER = (ALL + N - 1) / N;
  uint4 r[PER];
  __device__ __forceinline__ static bool has(int idx) {
    return ALL % N == 0 || idx < ALL;
  }
  __device__ __forceinline__ void load(const T* src, int row0, int t_len,
                                       int tid) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * N, row = idx / CH, ch = idx % CH;
      if (has(idx))
        r[i] = row0 + row < t_len
                   ? __ldg(reinterpret_cast<const uint4*>(
                               src + (size_t)(row0 + row) * D) + ch)
                   : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ static void put(uint4 x, int idx,
                                             __nv_bfloat16* hi,
                                             __nv_bfloat16* lo) {
    constexpr int LDD = Ld<D>::LDD;
    const int row = idx / CH, ch = idx % CH;
    if constexpr (std::is_same<T, float>::value) {
      uint2 h, l;
      mt::split2(__uint_as_float(x.x), __uint_as_float(x.y), h.x, l.x);
      mt::split2(__uint_as_float(x.z), __uint_as_float(x.w), h.y, l.y);
      *reinterpret_cast<uint2*>(hi + row * LDD + 4 * ch) = h;
      *reinterpret_cast<uint2*>(lo + row * LDD + 4 * ch) = l;
    } else {
      *reinterpret_cast<uint4*>(hi + row * LDD + 8 * ch) = x;
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* hi,
                                        __nv_bfloat16* lo, int tid) const {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (has(tid + i * N)) put(r[i], tid + i * N, hi, lo);
  }
  // load and store at once, in rounds of at most 8 pieces a thread (no
  // tile stays in registers across the products)
  __device__ __forceinline__ static void copy(const T* src, int row0,
                                              int t_len, __nv_bfloat16* hi,
                                              __nv_bfloat16* lo, int tid) {
    constexpr int RB = PER < 8 ? PER : 8;
#pragma unroll
    for (int i0 = 0; i0 < PER; i0 += RB) {
      uint4 x[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int idx = tid + (i0 + i) * N, row = idx / CH, ch = idx % CH;
        if (i0 + i < PER && has(idx))
          x[i] = row0 + row < t_len
                     ? __ldg(reinterpret_cast<const uint4*>(
                                 src + (size_t)(row0 + row) * D) + ch)
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < RB; ++i)
        if (i0 + i < PER && has(tid + (i0 + i) * N))
          put(x[i], tid + (i0 + i) * N, hi, lo);
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
    if constexpr (NT % 2 == 1) {  // an odd last n-tile (D = 80: 40 columns)
      static_assert(KN, "an odd n-tile count needs a k-major B");
      uint32_t yh[2], yl[2];
      mt::load_b_kn1(yh, bh, ldb, n0 + 8 * (NT - 1), k, lane);
      if (BLO) mt::load_b_kn1(yl, bl, ldb, n0 + 8 * (NT - 1), k, lane);
      mt::mma(acc[NT - 1], xh, yh);
      if (BLO) mt::mma(acc[NT - 1], xh, yl);
      if (ALO) mt::mma(acc[NT - 1], xl, yh);
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

// A wide head (D > 128) needs the registers for its accumulators (D / 2
// columns a warp): K7 then reads q's fragments from shared memory each kv
// tile instead of keeping them, and K8 stages each tile straight into
// shared memory instead of prefetching the next one into registers.
__host__ __device__ constexpr bool wide(int d) { return d > 128; }

// The streamed query tile of K8 (dq: the block's own rows; dkv: the q / do
// tiles it walks): 64 rows, or 32 for f32 inputs of a wide head, whose
// planes of 64 rows would not fit in shared memory.
template <typename T, int D>
__host__ __device__ constexpr int bq_of() {
  return std::is_same<T, float>::value && wide(D) ? 32 : 64;
}

template <typename T, int D>
constexpr size_t dq_smem() {
  constexpr int P = std::is_same<T, float>::value ? 2 : 1, BQ = bq_of<T, D>();
  return (size_t)2 * Ld<D>::LDD * (BQ * (P + 2) + BT * 2 * P) +
         (size_t)2 * 2 * BQ * LDS_;
}
template <typename T, int D>
constexpr size_t dkv_smem() {
  constexpr int P = std::is_same<T, float>::value ? 2 : 1, BQ = bq_of<T, D>();
  return (size_t)2 * Ld<D>::LDD * (BT * 2 * P + BQ * (P + 2)) +
         (size_t)2 * 4 * BT * (BQ + 8) + 2 * BQ * sizeof(float);
}

// q and do tiles of query head bh from q0, and lse (threads 0 .. BQ - 1) or
// delta (BQ .. 2 BQ - 1) of their rows, into registers
template <typename T, int D, int BQ>
__device__ __forceinline__ void fetch_q(TileLoad<T, D, NTH, BQ>& qt,
                                        TileLoad<float, D, NTH, BQ>& gt,
                                        float& rows,
                                        const T* __restrict__ q,
                                        const float* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        size_t bh, int q0, const Params& p,
                                        int tid) {
  qt.load(q + bh * p.T * D, q0, p.T, tid);
  gt.load(dout + bh * p.T * D, q0, p.T, tid);
  const int qi = q0 + (tid & (BQ - 1));
  if (tid < 2 * BQ)
    rows = qi < p.T ? (tid < BQ ? lse : delta)[bh * p.T + qi] : 0.f;
}

// ---------------------------------------------------------------- K8 dq
// grid B * H * ceil(T / BQ) (the q tiles with most kv tiles first), block
// 256.  dq = ds @ k * scale over the open kv tiles.  Warp w: rows 16 (w %
// RG) of the BQ, and of the 64 keys (phase 1) or the D columns (phase 2)
// the (w / RG)-th of CG parts.
template <typename T, int D>
__global__ void __launch_bounds__(NTH, 1)
    flash_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int batch, Params p) {
  constexpr bool S = std::is_same<T, float>::value, PF = !wide(D);
  constexpr int BQ = bq_of<T, D>(), RG = BQ / 16, CG = NW / RG;
  constexpr int LDD = Ld<D>::LDD, NT1 = BT / CG / 8, DC = D / CG,
                NT2 = DC / 8;  // phase-1 and phase-2 n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Carve cv{smem_raw};
  __nv_bfloat16 *qh = cv.take(BQ * LDD), *ql = cv.take(BQ * LDD, S);
  __nv_bfloat16 *gh = cv.take(BQ * LDD), *gl = cv.take(BQ * LDD);
  __nv_bfloat16 *kh = cv.take(BT * LDD), *kl = cv.take(BT * LDD, S);
  __nv_bfloat16 *vh = cv.take(BT * LDD), *vl = cv.take(BT * LDD, S);
  __nv_bfloat16 *dsh = cv.take(BQ * LDS_), *dsl = cv.take(BQ * LDS_);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % RG, wn = warp / RG, g = lane >> 2, cq = lane & 3;
  const int nq = (p.T + BQ - 1) / BQ, nbh = batch * p.H;
  const int bh = blockIdx.x % nbh, q0 = (nq - 1 - blockIdx.x / nbh) * BQ;
  const int b = bh / p.H, G = p.H / p.Hkv, hk = (bh % p.H) / G;
  const size_t kv_off = (size_t)(b * p.Hkv + hk) * p.T * D;
  TileLoad<T, D, NTH, BQ>::copy(q + (size_t)bh * p.T * D, q0, p.T, qh, ql,
                                tid);
  TileLoad<float, D, NTH, BQ>::copy(dout + (size_t)bh * p.T * D, q0, p.T, gh,
                                    gl, tid);
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
  kv_tiles(q0, BQ, BT, p, lo, hi);
  TileLoad<T, D> kt, vt;
  if constexpr (PF) {
    kt.load(k + kv_off, lo * BT, p.T, tid);
    vt.load(v + kv_off, lo * BT, p.T, tid);
  }
  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * BT;
    __syncthreads();  // previous tile's planes consumed
    if constexpr (PF) {
      kt.store(kh, kl, tid);
      vt.store(vh, vl, tid);
      if (jt < hi) {
        kt.load(k + kv_off, k0 + BT, p.T, tid);
        vt.load(v + kv_off, k0 + BT, p.T, tid);
      }
    } else {
      TileLoad<T, D>::copy(k + kv_off, k0, p.T, kh, kl, tid);
      TileLoad<T, D>::copy(v + kv_off, k0, p.T, vh, vl, tid);
    }
    __syncthreads();
    {  // phase 1: s = q k^T, dp = do v^T; 16 q rows x 64 / CG keys a warp
      float s[NT1][4], dp[NT1][4];
      zero<NT1>(s);
      zero<NT1>(dp);
      mma_tile<NT1, D, S, S, false>(s, qh, ql, LDD, 16 * wm, kh, kl, LDD,
                                    (BT / CG) * wn, lane);
      mma_tile<NT1, D, true, S, false>(dp, gh, gl, LDD, 16 * wm, vh, vl, LDD,
                                       (BT / CG) * wn, lane);
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 16 * wm + g + 8 * i,
                    c = (BT / CG) * wn + 8 * j + 2 * cq;
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
    // phase 2: dq += ds k; 16 q rows x D / CG columns a warp
    mma_tile<NT2, BT, true, S, true>(acc, dsh, dsl, LDS_, 16 * wm, kh, kl,
                                     LDD, DC * wn, lane);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 16 * wm + g + 8 * i;
    if (qi >= p.T) continue;
    float* row = dq + ((size_t)bh * p.T + qi) * D + DC * wn;
#pragma unroll
    for (int j = 0; j < NT2; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * cq) = make_float2(
          acc[j][2 * i] * p.scale, acc[j][2 * i + 1] * p.scale);
  }
}

// --------------------------------------------------------------- K8 dkv
// grid B * Hkv * ceil(T / 64) (the kv tiles seen by most q tiles first),
// block 256.  Walks the G query heads of its group and their open q tiles
// of BQ rows in order: dk = ds^T q * scale, dv = p^T do.  Warp w: keys 16
// (w % 4); queries BQ / 2 (w / 4) in phase 1, columns D / 2 (w / 4) in
// phase 2.
template <typename T, int D>
__global__ void __launch_bounds__(NTH, 1)
    flash_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int batch,
              Params p) {
  constexpr bool S = std::is_same<T, float>::value, PF = !wide(D);
  constexpr int BQ = bq_of<T, D>(), LDP = BQ + 8;  // p / ds plane rows
  constexpr int LDD = Ld<D>::LDD, NT1 = BQ / 16, NT2 = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Carve cv{smem_raw};
  __nv_bfloat16 *kh = cv.take(BT * LDD), *kl = cv.take(BT * LDD, S);
  __nv_bfloat16 *vh = cv.take(BT * LDD), *vl = cv.take(BT * LDD, S);
  __nv_bfloat16 *qh = cv.take(BQ * LDD), *ql = cv.take(BQ * LDD, S);
  __nv_bfloat16 *gh = cv.take(BQ * LDD), *gl = cv.take(BQ * LDD);
  __nv_bfloat16 *ph = cv.take(BT * LDP), *pl = cv.take(BT * LDP);
  __nv_bfloat16 *dsh = cv.take(BT * LDP), *dsl = cv.take(BT * LDP);
  float* s_lse = reinterpret_cast<float*>(cv.at);
  float* s_dl = s_lse + BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, cq = lane & 3;
  const int nbk = batch * p.Hkv;
  const int bk = blockIdx.x % nbk, k0 = (blockIdx.x / nbk) * BT;
  const int b = bk / p.Hkv, hk = bk % p.Hkv, G = p.H / p.Hkv;
  const size_t kv_off = (size_t)bk * p.T * D;
  TileLoad<T, D>::copy(k + kv_off, k0, p.T, kh, kl, tid);
  TileLoad<T, D>::copy(v + kv_off, k0, p.T, vh, vl, tid);
  float dka[NT2][4], dva[NT2][4];
  zero<NT2>(dka);
  zero<NT2>(dva);
  int lo, hi;
  q_tiles(k0, BQ, BT, p, lo, hi);
  const int per = hi - lo + 1, n_it = G * per;
  // iteration i: query head hk * G + i / per, q tile lo + i % per; with PF
  // its q / do tiles and lse (threads 0 .. BQ - 1) or delta (BQ .. 2 BQ -
  // 1) rows are loaded one iteration ahead
  TileLoad<T, D, NTH, BQ> qt;
  TileLoad<float, D, NTH, BQ> gt;
  float rows = 0.f;
  if (PF && n_it > 0)
    fetch_q<T, D, BQ>(qt, gt, rows, q, dout, lse, delta,
                      (size_t)b * p.H + hk * G, lo * BQ, p, tid);
  for (int it = 0; it < n_it; ++it) {
    const int q0 = (lo + it % per) * BQ;
    __syncthreads();  // previous tile's planes consumed
    if constexpr (PF) {
      qt.store(qh, ql, tid);
      gt.store(gh, gl, tid);
      if (tid < 2 * BQ) s_lse[tid] = rows;  // s_dl follows s_lse
      if (it + 1 < n_it)
        fetch_q<T, D, BQ>(qt, gt, rows, q, dout, lse, delta,
                          (size_t)b * p.H + hk * G + (it + 1) / per,
                          (lo + (it + 1) % per) * BQ, p, tid);
    } else {
      const size_t bh = (size_t)b * p.H + hk * G + it / per;
      TileLoad<T, D, NTH, BQ>::copy(q + bh * p.T * D, q0, p.T, qh, ql, tid);
      TileLoad<float, D, NTH, BQ>::copy(dout + bh * p.T * D, q0, p.T, gh, gl,
                                        tid);
      const int qi = q0 + (tid & (BQ - 1));
      if (tid < 2 * BQ)
        s_lse[tid] = qi < p.T ? (tid < BQ ? lse : delta)[bh * p.T + qi] : 0.f;
    }
    __syncthreads();
    {  // phase 1: s^T = k q^T, dp^T = v do^T; 16 keys x BQ / 2 queries a warp
      float s[NT1][4], dp[NT1][4];
      zero<NT1>(s);
      zero<NT1>(dp);
      mma_tile<NT1, D, S, S, false>(s, kh, kl, LDD, 16 * wm, qh, ql, LDD,
                                    (BQ / 2) * wn, lane);
      mma_tile<NT1, D, S, true, false>(dp, vh, vl, LDD, 16 * wm, gh, gl, LDD,
                                       (BQ / 2) * wn, lane);
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 16 * wm + g + 8 * i,
                    c = (BQ / 2) * wn + 8 * j + 2 * cq;
          float pr[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            ds[e] = grad_score(s[j][2 * i + e], dp[j][2 * i + e],
                               s_lse[c + e], s_dl[c + e], q0 + c + e,
                               k0 + r, p, pr[e]);
          uint32_t h2, l2;
          mt::split2(pr[0], pr[1], h2, l2);
          *reinterpret_cast<uint32_t*>(ph + r * LDP + c) = h2;
          *reinterpret_cast<uint32_t*>(pl + r * LDP + c) = l2;
          mt::split2(ds[0], ds[1], h2, l2);
          *reinterpret_cast<uint32_t*>(dsh + r * LDP + c) = h2;
          *reinterpret_cast<uint32_t*>(dsl + r * LDP + c) = l2;
        }
    }
    __syncthreads();
    // phase 2: dv += p^T do, dk += ds^T q; 16 keys x D / 2 columns a warp
    mma_tile<NT2, BQ, true, true, true>(dva, ph, pl, LDP, 16 * wm, gh, gl,
                                        LDD, (D / 2) * wn, lane);
    mma_tile<NT2, BQ, true, S, true>(dka, dsh, dsl, LDP, 16 * wm, qh, ql,
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

// ------------------------------------------------------------------ K7
// grid B * H * ceil(T / 64) (the q tiles with most kv tiles first), block
// 128: warp w owns query rows 16 w .. 16 w + 15 of the block's 64, and
// keeps them in registers as mma A fragments for the whole kv walk.
constexpr int FW = 4, FTH = 32 * FW;  // warps, threads of a K7 block

// bf16 K7: the K and V tiles of keys [k0, k0 + 64) into the planes kd, vd
// by cp.async, rows past T as zeros (scored -1e30, and 0 * v stays 0).
template <int D>
__device__ __forceinline__ void issue_kv(const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, int k0,
                                         int t_len, __nv_bfloat16* kd,
                                         __nv_bfloat16* vd, int tid) {
  constexpr int CH = D / 8, LDD = Ld<D>::LDD;  // 16-byte pieces a row
  static_assert(BT * CH % FTH == 0, "whole rounds of pieces");
#pragma unroll
  for (int i = 0; i < BT * CH / FTH; ++i) {
    const int idx = tid + i * FTH, row = idx / CH, ch = idx % CH;
    const bool ok = k0 + row < t_len;
    const size_t at = (size_t)(ok ? k0 + row : 0) * D + 8 * ch;
    mt::cp_async16_zfill(kd + row * LDD + 8 * ch, k + at, ok);
    mt::cp_async16_zfill(vd + row * LDD + 8 * ch, v + at, ok);
  }
}

// a wide head keeps q in planes 4 and (f32) 5
template <typename T, int D>
constexpr size_t fwd_smem() {
  constexpr int QP = !wide(D) ? 0 : std::is_same<T, float>::value ? 2 : 1;
  return (size_t)(4 + QP) * BT * Ld<D>::LDD * 2;
}

template <typename T, int D>
__global__ void __launch_bounds__(FTH)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int batch, Params p) {
  constexpr bool S = std::is_same<T, float>::value, QR = !wide(D);
  constexpr int LDD = Ld<D>::LDD, KS = D / 16, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // four planes: bf16, K and V of two stages (stage s: 2 s, 2 s + 1);
  // f32, the hi and lo planes of K (0, 1) and of V (2, 3); then, for a
  // wide head, q's hi (4) and lo (5) planes
  Carve cv{smem_raw};
  __nv_bfloat16* pl[6];
#pragma unroll
  for (int i = 0; i < 4; ++i) pl[i] = cv.take(BT * LDD);
  pl[4] = cv.take(BT * LDD, !QR);
  pl[5] = cv.take(BT * LDD, !QR && S);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int nq = (p.T + BT - 1) / BT, nbh = batch * p.H;
  const int bh = blockIdx.x % nbh, q0 = (nq - 1 - blockIdx.x / nbh) * BT;
  const int b = bh / p.H, G = p.H / p.Hkv, hk = (bh % p.H) / G;
  const size_t kv_off = (size_t)(b * p.Hkv + hk) * p.T * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  // this warp's q rows as A fragments (hi, and lo for f32 inputs), staged
  // through planes 0 and 1; a wide head's stay in planes 4 and 5 (read
  // after the kv loop's first barrier)
  uint32_t qa[QR ? KS : 1][4], ql[S && QR ? KS : 1][4];
  TileLoad<T, D, FTH>::copy(q + (size_t)bh * p.T * D, q0, p.T,
                            pl[QR ? 0 : 4], pl[QR ? 1 : 5], tid);
  if constexpr (QR) {
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      mt::load_a(qa[kk], pl[0], LDD, 16 * warp, 16 * kk, lane);
      if constexpr (S)
        mt::load_a(ql[kk], pl[1], LDD, 16 * warp, 16 * kk, lane);
    }
    __syncthreads();
  }

  // rows g and g + 8 of the warp's 16: running max, sum and output
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
  zero<NO>(acc);
  const int r0 = q0 + 16 * warp + g;
  int lo, hi;
  kv_tiles(q0, BT, BT, p, lo, hi);
  if constexpr (!S) {
    issue_kv<D>(kb, vb, lo * BT, p.T, pl[0], pl[1], tid);
    mt::cp_commit();
  }
  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * BT;
    const __nv_bfloat16 *kh, *kl = nullptr, *vh, *vl = nullptr;
    if constexpr (S) {
      // f32 inputs (off the training path): split into the hi / lo planes
      // through registers, one tensor at a time
      __syncthreads();  // previous tile's planes read
      TileLoad<T, D, FTH>::copy(kb, k0, p.T, pl[0], pl[1], tid);
      TileLoad<T, D, FTH>::copy(vb, k0, p.T, pl[2], pl[3], tid);
      __syncthreads();
      kh = pl[0];
      kl = pl[1];
      vh = pl[2];
      vl = pl[3];
    } else {
      const int st = (jt - lo) & 1;
      if (jt < hi)
        issue_kv<D>(kb, vb, k0 + BT, p.T, pl[2 * (st ^ 1)],
                    pl[2 * (st ^ 1) + 1], tid);
      mt::cp_commit();
      mt::cp_wait<1>();
      __syncthreads();
      kh = pl[2 * st];
      vh = pl[2 * st + 1];
    }

    // s = q k^T: 16 rows x 64 keys, n-tile j holding keys 8 j .. 8 j + 7
    float s[8][4];
    zero<8>(s);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t fh[4], fl[4];
      const uint32_t* ah = fh;
      const uint32_t* al = fl;
      if constexpr (QR) {
        ah = qa[kk];
        al = ql[S ? kk : 0];
      } else {
        mt::load_a(fh, pl[4], LDD, 16 * warp, 16 * kk, lane);
        if constexpr (S) mt::load_a(fl, pl[5], LDD, 16 * warp, 16 * kk, lane);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t yh[4], yl[4];
        mt::load_b_nk(yh, kh, LDD, 16 * np, 16 * kk, lane);
        if constexpr (S) mt::load_b_nk(yl, kl, LDD, 16 * np, 16 * kk, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mt::mma(s[2 * np + j], ah, yh + 2 * j);
          if constexpr (S) {
            mt::mma(s[2 * np + j], ah, yl + 2 * j);
            mt::mma(s[2 * np + j], al, yh + 2 * j);
          }
        }
      }
    }

    // scale, cap and mask; the online softmax of rows g (i = 0), g + 8
    const bool open = k0 + BT <= p.T &&
                      (!p.causal || k0 + BT - 1 <= q0) &&
                      (p.window < 0 || q0 + BT - 1 - k0 < p.window);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mt_ = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = cap_score(s[j][2 * i + e], p);
          if (!open && !valid(r0 + 8 * i, k0 + 8 * j + 2 * cq + e, p))
            x = NEG_INF;
          s[j][2 * i + e] = x;
          mt_ = fmaxf(mt_, x);
        }
      mt_ = fmaxf(mt_, __shfl_xor_sync(~0u, mt_, 1));
      mt_ = fmaxf(mt_, __shfl_xor_sync(~0u, mt_, 2));
      const float mn = fmaxf(m[i], mt_);
      const float corr = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = expf(s[j][2 * i + e] - mn);
          s[j][2 * i + e] = pe;
          rs += pe;
        }
      rs += __shfl_xor_sync(~0u, rs, 1);
      rs += __shfl_xor_sync(~0u, rs, 2);
      l[i] = l[i] * corr + rs;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][2 * i] *= corr;
        acc[j][2 * i + 1] *= corr;
      }
    }

    // acc += p v: p (f32) as bf16 hi + lo A fragments straight from the
    // score accumulators (keys 16 kk .. 16 kk + 15 are n-tiles 2 kk and
    // 2 kk + 1), v as B
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      mt::split2(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      mt::split2(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      mt::split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      mt::split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t yh[4], yl[4];
        mt::load_b_kn(yh, vh, LDD, 16 * np, 16 * kk, lane);
        if constexpr (S) mt::load_b_kn(yl, vl, LDD, 16 * np, 16 * kk, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mt::mma(acc[2 * np + j], ah, yh + 2 * j);
          mt::mma(acc[2 * np + j], al, yh + 2 * j);
          if constexpr (S) mt::mma(acc[2 * np + j], ah, yl + 2 * j);
        }
      }
    }
    if constexpr (!S) __syncthreads();  // stage st read: it may be refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi >= p.T) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    float* row = o + ((size_t)bh * p.T + qi) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * cq) =
          make_float2(acc[j][2 * i] / lf, acc[j][2 * i + 1] / lf);
    if (cq == 0) lse[(size_t)bh * p.T + qi] = m[i] + logf(lf);
  }
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, float* o, float* lse,
        int batch, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<T, D>();
  auto kern = flash_fwd<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = batch * p.H * ((p.T + BT - 1) / BT);
  kern<<<blocks, FTH, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o, lse, batch, p);
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
  const int blocks = batch * p.H * ((p.T + bq_of<T, D>() - 1) / bq_of<T, D>());
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

// kind: 0 = bf16 q / k / v, 1 = f32.  d in {32, 64, 80, 96, 128, 256}.  window < 0 means
// no window.  o, dq [B, H, T, D]; lse, delta [B, H, T]; dk, dv [B, Hkv, T,
// D]; all f32 and contiguous.  Each returns the cudaError_t of its launch.
#define FA_DISPATCH(CALL)                                  \
  if (kind == 0 && d == 32) return CALL(__nv_bfloat16, 32);   \
  if (kind == 0 && d == 64) return CALL(__nv_bfloat16, 64);   \
  if (kind == 0 && d == 80) return CALL(__nv_bfloat16, 80);   \
  if (kind == 0 && d == 96) return CALL(__nv_bfloat16, 96);   \
  if (kind == 0 && d == 128) return CALL(__nv_bfloat16, 128); \
  if (kind == 0 && d == 256) return CALL(__nv_bfloat16, 256); \
  if (kind == 1 && d == 32) return CALL(float, 32);           \
  if (kind == 1 && d == 64) return CALL(float, 64);           \
  if (kind == 1 && d == 80) return CALL(float, 80);           \
  if (kind == 1 && d == 96) return CALL(float, 96);           \
  if (kind == 1 && d == 128) return CALL(float, 128);         \
  if (kind == 1 && d == 256) return CALL(float, 256);         \
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
