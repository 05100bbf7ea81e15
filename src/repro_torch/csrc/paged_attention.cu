// Paged attention for Hopper: decode (one query per sequence, K2) and
// chunked prefill (C queries per sequence at their own positions, K3)
// against the page pool, through the page table, with an online softmax.
//
// Replaces the TPU kernels `_paged_kernel` (decode, launched by
// `paged_attention_pallas`) and `_paged_chunk_kernel` (chunk, launched by
// `paged_attention_pallas_chunk`) of src/repro/kvstore/paged_attention.py.
//
//   q       [B, H, C, Dh]            bf16 or f32 (decode: C = 1)
//   pages   [n_pages, Hkv, ps, Dh]   bf16, or int8 times scale [n_pages, Hkv]
//   table   [B, npp] int32           -1 = no page (reads page 0, masked)
//   q_pos   [B, C] int32, window int -> out [B, H, C, Dh] f32
//   Dh a multiple of 16 up to 256.
//
// Semantics are the TPU kernels': s = (q . k) * scale, then softcap, then
// s = -1e30 where table < 0, pos > q_pos or (window >= 0 and pos <= q_pos -
// window), with pos = table_index * ps + offset and q_pos the query's own
// position.  The finite -1e30 (never -inf) makes a row with no valid key,
// as an idle batch slot or a padded chunk query gives, come out as the
// mean of the V rows it visited rather than NaN, as on the TPU.  Output is
// acc / max(l, 1e-30).
//
// What bounds it: bytes.  Each K/V element read feeds G * qt multiply-adds
// (G = H / Hkv query heads per kv head, qt chunk queries per block), far
// below the card's operations-per-byte balance on the tensor cores, so the
// floor is reading each live page once.  At short contexts a launch reads
// only a few pages, and its latency chain dominates.
//
// Design:
//  * The split plan (`split_plan` in kvstore/paged_attention.py): a row
//    (one query) visits the keys of its pages 0 .. min(npp - 1,
//    max(q_pos, 0) / ps), its live keys, cut into ranges of RK keys from
//    key 0; a range into stages of KB keys, a stage into KG groups of 16.
//    RK is the attention geometry's tuned range (kernels/tune.py; RANGE
//    untuned).  Nothing of it depends on B, C or the table width, and every
//    row runs the same arithmetic: a query's bits are its own, decoded
//    alone, among other rows, or as any row of a chunk (K2 is K3 at C = 1).
//  * One block per (sequence, kv head, query tile, range).  Blocks past
//    the tile's last range exit at once.  The tile's G * qt <= 32 query
//    rows pad to 16-row m-tiles; warp (m-tile, key group) keeps (m, l, acc)
//    of its 16 rows over the 16 keys of its group in every stage, and the
//    KG groups merge in group order at the end of the range.
//  * A row of one range is written at once.  A longer row's ranges write
//    (m, l, acc) partials, and the block of the tile that finishes last
//    (a counter per tile, reset by that block) merges them in range order:
//    one launch, and no atomic adds of values.
//  * The range's table entries (and int8 scales) are read into shared
//    memory once.  K and V stages are copied by 16-byte `cp.async` into a
//    ring of NS stages in flight (rows padded by 16 bytes, so `ldmatrix`
//    rows fall on distinct banks); int8 stages are widened to bf16 (exact)
//    in shared memory before use.  Keys past the tile's end stage as 0.
//  * q . k^T and p . v run on `mma.sync` m16n8k16 (mma_tile.cuh): q (f32
//    split hi + lo, bf16 as is) against bf16 K, exact products with f32
//    sums; p stays f32 and enters p . v as hi + lo.  An int8 page's scale
//    multiplies its keys' scores, and its keys' p before p . v, in f32.
//  * Keys past a row's own live keys score -inf: p = 0 exactly and they
//    leave the max alone, so the row's (m, l, acc) is exactly unchanged and
//    a row whose tile reaches further visits exactly its own keys.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
// RK, the keys of a range of the split plan, is a template parameter:
// 128, 256 or 512 (the tuner's candidates), so every layout stays static.
// RANGE is the untuned plan's.  Each build instantiates one, PA_RANGE
// (nvcc -DPA_RANGE=..., a library each, built side by side).
constexpr int RANGE = 256;
#ifndef PA_RANGE
#define PA_RANGE RANGE
#endif
static_assert(PA_RANGE == 128 || PA_RANGE == 256 || PA_RANGE == 512,
              "a range is 128, 256 or 512 keys");
constexpr int KB = 64;        // keys a stage
constexpr int KG = 4;         // key groups of 16 a stage: warps an m-tile
constexpr int MAX_ROWS = 32;  // query rows a block (two m-tiles)
constexpr int NW_MAX = KG * MAX_ROWS / 16;
// the ring's budget: three bf16 stages at Dh = 128, two blocks an SM
constexpr int RING_BYTES = 104 * 1024 + 512;

template <typename PT, int DH>
struct Geo {
  static constexpr bool I8 = sizeof(PT) == 1;
  static constexpr int LDD = DH + 8;        // bf16 a padded key row
  static constexpr int ROW = I8 ? DH : LDD; // PT a ring key row
  static constexpr int EPP = 16 / (int)sizeof(PT);  // PT a 16-byte piece
  static constexpr int PPR = DH / EPP;              // pieces a key row
  static constexpr int STAGE = 2 * KB * ROW * (int)sizeof(PT);  // K and V
  static constexpr int CONV = I8 ? 2 * KB * LDD * 2 : 0;  // widened stage
  static constexpr int FIT = (RING_BYTES - CONV) / STAGE;
  static constexpr int NS = FIT < 2 ? 2 : FIT > 4 ? 4 : FIT;
  static constexpr int KS = DH / 16, NO = DH / 8;
};

// byte offsets into dynamic shared memory
struct Layout {
  size_t q, tbl, ksc, vsc, rows, flag, total;
};

template <typename PT, int DH>
__host__ __device__ __forceinline__ Layout layout(int nw, int q_f32,
                                                  int npg) {
  using Gm = Geo<PT, DH>;
  Layout L;
  // the ring (then the merge of the warps' states) at offset 0
  const size_t pipe = (size_t)Gm::NS * Gm::STAGE + Gm::CONV;
  const size_t merge =
      ((size_t)nw * 16 * (DH + 2) + MAX_ROWS * (KG + 2)) * sizeof(float);
  size_t at = pipe > merge ? pipe : merge;
  L.q = at;
  at += (size_t)(q_f32 ? 2 : 1) * (nw / KG) * 16 * Gm::LDD * 2;
  L.tbl = at;
  at += (size_t)npg * 4;
  L.ksc = at;
  at += Gm::I8 ? (size_t)npg * 4 : 0;
  L.vsc = at;
  at += Gm::I8 ? (size_t)npg * 4 : 0;
  L.rows = at;
  at += 3 * MAX_ROWS * 4;
  L.flag = at;
  L.total = at + 16;
  return L;
}

// one past the last key a query at `pos` visits (split_plan's live keys)
__device__ __forceinline__ int live_keys(int pos, int ps, int npp) {
  return (min(npp - 1, max(pos, 0) / ps) + 1) * ps;
}

// x / ps for x >= 0, a shift when ps is a power of two (ps_log2 >= 0)
__device__ __forceinline__ int div_ps(int x, int ps, int ps_log2) {
  return ps_log2 >= 0 ? x >> ps_log2 : x / ps;
}

// grid (B * Hkv * C / qt, nrange), block 32 * KG * ceil(G * qt / 16).
template <typename PT, int DH, int RK>
__global__ void __launch_bounds__(32 * NW_MAX, DH <= 128 ? 2 : 1)
    paged_attn(const void* __restrict__ qv, int q_f32,
               const PT* __restrict__ kp, const PT* __restrict__ vp,
               const float* __restrict__ ks, const float* __restrict__ vs,
               const int* __restrict__ table, const int* __restrict__ q_pos,
               int c, int qt, int G, int hkv, int ps, int ps_log2, int npp,
               int nrange, int window, float scale, float cap, int has_cap,
               float* __restrict__ out, float* __restrict__ part,
               int* __restrict__ cnt) {
  using Gm = Geo<PT, DH>;
  constexpr int LDD = Gm::LDD, ROW = Gm::ROW, NS = Gm::NS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nthr >> 5;
  const int mtiles = nw / KG, mtile = warp / KG, kg = warp % KG;
  const int g = lane >> 2, cq = lane & 3;
  const int nq = c / qt, rows = G * qt, H = hkv * G;
  const int qi = blockIdx.x % nq, bk = blockIdx.x / nq;
  const int b = bk / hkv, hk = bk % hkv;
  // 16-byte pieces of q a thread: rows * DH / 8 <= 2 * DH * (nw / KG)
  constexpr int QP = (2 * DH + 32 * KG - 1) / (32 * KG);
  const int* pos_t = q_pos + (size_t)b * c + qi * qt;
  const int rg = blockIdx.y, r0 = rg * RK, p0 = r0 / ps;
  const int npg = (RK - 1) / ps + 2;  // most pages a range touches

  // Read what the block needs and no other read waits on at once: the
  // range's table entries, q (QP 16-byte pieces a thread at most) and the
  // tile's positions.
  int ent = -1;
  if (tid < npg && p0 + tid < npp) ent = table[(size_t)b * npp + p0 + tid];
  uint4 qr[QP][2];
#pragma unroll
  for (int k = 0; k < QP; ++k) {
    const int i = tid + k * nthr, r = i / (DH / 8), ch = i % (DH / 8);
    if (r < rows) {
      const size_t at =
          ((size_t)(b * H + hk * G + r / qt) * c + qi * qt + r % qt) * DH +
          8 * ch;
      if (q_f32) {
        const uint4* src = reinterpret_cast<const uint4*>(
            static_cast<const float*>(qv) + at);
        qr[k][0] = src[0];
        qr[k][1] = src[1];
      } else {
        qr[k][0] = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(qv) + at);
      }
    }
  }
  // the tile reaches as far as its furthest row; later ranges exit
  int tile_end = 0;
  for (int i = 0; i < qt; ++i)
    tile_end = max(tile_end, live_keys(pos_t[i], ps, npp));
  const int ntile = (tile_end + RK - 1) / RK;
  if (rg >= ntile) return;
  const int r1 = min(r0 + RK, tile_end);
  const int npr = div_ps(r1 - 1, ps, ps_log2) - p0 + 1;
  const Layout L = layout<PT, DH>(nw, q_f32, npg);
  PT* ring = reinterpret_cast<PT*>(smem);
  __nv_bfloat16* conv =
      reinterpret_cast<__nv_bfloat16*>(smem + (size_t)NS * Gm::STAGE);
  __nv_bfloat16* qh = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* ql = qh + mtiles * 16 * LDD;
  int* tbl = reinterpret_cast<int*>(smem + L.tbl);
  float* ksc = reinterpret_cast<float*>(smem + L.ksc);
  float* vsc = reinterpret_cast<float*>(smem + L.vsc);
  int* rend_s = reinterpret_cast<int*>(smem + L.rows);  // live keys
  int* rowg_s = rend_s + MAX_ROWS;                      // output row
  int* cur_s = rowg_s + MAX_ROWS;                       // q_pos
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  // into shared memory: the table entries and scales, the rows, and q as
  // bf16 planes (f32: hi and lo)
  for (int i = tid; i < npr; i += nthr) {
    const int e = i < nthr ? ent : table[(size_t)b * npp + p0 + i];
    tbl[i] = e;
    if constexpr (Gm::I8) {
      const size_t at = (size_t)(e < 0 ? 0 : e) * hkv + hk;
      ksc[i] = ks[at];
      vsc[i] = vs[at];
    }
  }
  for (int r = tid; r < mtiles * 16; r += nthr) {
    const bool real = r < rows;
    const int pos = real ? pos_t[r % qt] : 0;
    rend_s[r] = real ? live_keys(pos, ps, npp) : 0;
    rowg_s[r] = real ? (b * H + hk * G + r / qt) * c + qi * qt + r % qt : 0;
    cur_s[r] = pos;
  }
#pragma unroll
  for (int k = 0; k < QP; ++k) {
    const int i = tid + k * nthr, r = i / (DH / 8), ch = i % (DH / 8);
    if (r >= mtiles * 16) break;
    uint4 hi = make_uint4(0, 0, 0, 0), lo = hi;
    if (r < rows) {
      if (q_f32) {
        const uint4 x = qr[k][0], y = qr[k][1];
        mt::split2(__uint_as_float(x.x), __uint_as_float(x.y), hi.x, lo.x);
        mt::split2(__uint_as_float(x.z), __uint_as_float(x.w), hi.y, lo.y);
        mt::split2(__uint_as_float(y.x), __uint_as_float(y.y), hi.z, lo.z);
        mt::split2(__uint_as_float(y.z), __uint_as_float(y.w), hi.w, lo.w);
      } else {
        hi = qr[k][0];
      }
    }
    *reinterpret_cast<uint4*>(qh + r * LDD + 8 * ch) = hi;
    if (q_f32) *reinterpret_cast<uint4*>(ql + r * LDD + 8 * ch) = lo;
  }
  __syncthreads();

  // stage st: keys r0 + st * KB .. + KB of K and V into ring slot st % NS
  const int nst = (r1 - r0 + KB - 1) / KB;
  auto fetch = [&](int st) {
    PT* kd = ring + (size_t)(st % NS) * 2 * KB * ROW;
    PT* vd = kd + KB * ROW;
    const int k0 = r0 + st * KB;
    for (int e = tid; e < KB * Gm::PPR; e += nthr) {
      const int kr = e / Gm::PPR, pc = e % Gm::PPR, key = k0 + kr;
      const bool ok = key < r1;
      size_t at = (size_t)pc * Gm::EPP;
      if (ok) {
        const int pi = div_ps(key, ps, ps_log2), e = tbl[pi - p0];
        at += (((size_t)(e < 0 ? 0 : e) * hkv + hk) * ps +
               (key - pi * ps)) * DH;
      }
      mt::cp_async16_zfill(kd + kr * ROW + pc * Gm::EPP, kp + at, ok);
      mt::cp_async16_zfill(vd + kr * ROW + pc * Gm::EPP, vp + at, ok);
    }
  };

  // rows g and g + 8 of this warp's m-tile
  const int ra = 16 * mtile + g;
  int rend[2], cur[2];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rend[i] = rend_s[ra + 8 * i];
    cur[i] = cur_s[ra + 8 * i];
  }
  float acc[Gm::NO][4];
#pragma unroll
  for (int j = 0; j < Gm::NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float past = -__int_as_float(0x7f800000);  // -inf

#pragma unroll 1
  for (int st = 0; st < NS - 1; ++st) {
    if (st < nst) fetch(st);
    mt::cp_commit();
  }
#pragma unroll 1
  for (int st = 0; st < nst; ++st) {
    mt::cp_wait<NS - 2>();
    __syncthreads();  // stage st landed; stage st - 1 consumed by all
    if (st + NS - 1 < nst) fetch(st + NS - 1);
    mt::cp_commit();
    const PT* slot = ring + (size_t)(st % NS) * 2 * KB * ROW;
    const __nv_bfloat16 *kt, *vt;
    if constexpr (Gm::I8) {
      for (int e = tid; e < 2 * KB * (DH / 16); e += nthr) {
        const int kr = e / (DH / 16), pc = e % (DH / 16);
        uint4 lo, hi;
        mt::i8x16_bf16(
            *reinterpret_cast<const uint4*>(slot + kr * DH + 16 * pc), lo,
            hi);
        uint4* dst = reinterpret_cast<uint4*>(conv + kr * LDD + 16 * pc);
        dst[0] = lo;
        dst[1] = hi;
      }
      __syncthreads();
      kt = conv;
      vt = conv + KB * LDD;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(slot);
      vt = kt + KB * LDD;
    }

    // s = q k^T: 16 rows x the group's 16 keys (n-tiles 0, 1)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < Gm::KS; ++kk) {
      uint32_t a[4], bb[4];
      mt::load_b_nk(bb, kt, LDD, 16 * kg, 16 * kk, lane);
      mt::load_a(a, qh, LDD, 16 * mtile, 16 * kk, lane);
      mt::mma(s[0], a, bb);
      mt::mma(s[1], a, bb + 2);
      if (q_f32) {
        mt::load_a(a, ql, LDD, 16 * mtile, 16 * kk, lane);
        mt::mma(s[0], a, bb);
        mt::mma(s[1], a, bb + 2);
      }
    }

    // per key (n-tile j, column 2 cq + e): its page's entry and scales
    const int kbase = r0 + st * KB + 16 * kg + 2 * cq;
    bool page_ok[2][2];
    float kf[2][2], vf[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kbase + 8 * j + e;
        const int pi = key < r1 ? div_ps(key, ps, ps_log2) - p0 : 0;
        page_ok[j][e] = key < r1 && tbl[pi] >= 0;
        kf[j][e] = Gm::I8 ? ksc[pi] : 1.f;
        vf[j][e] = Gm::I8 ? vsc[pi] : 1.f;
      }

    // scale, cap, mask; the online softmax of rows g (i = 0), g + 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = past;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kbase + 8 * j + e;
          float x = past;
          if (key < rend[i]) {
            x = s[j][2 * i + e];
            if (Gm::I8) x *= kf[j][e];
            x *= scale;
            if (has_cap) x = cap * tanhf(x / cap);
            bool ok = page_ok[j][e] && key <= cur[i];
            if (window >= 0) ok = ok && key > cur[i] - window;
            x = ok ? x : NEG_INF;
          }
          s[j][2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[j][2 * i + e] - mn);
          rs += p;
          s[j][2 * i + e] = Gm::I8 ? p * vf[j][e] : p;
        }
      rs += __shfl_xor_sync(~0u, rs, 1);
      rs += __shfl_xor_sync(~0u, rs, 2);
      l[i] = l[i] * corr + rs;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < Gm::NO; ++j) {
        acc[j][2 * i] *= corr;
        acc[j][2 * i + 1] *= corr;
      }
    }

    // acc += p v over the group's 16 keys, p as bf16 hi + lo
    uint32_t pah[4], pal[4];
    mt::acc_to_a(s[0], s[1], pah, pal);
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t bb[4];
      mt::load_b_kn(bb, vt, LDD, 16 * np, 16 * kg, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mt::mma(acc[2 * np + j], pah, bb + 2 * j);
        mt::mma(acc[2 * np + j], pal, bb + 2 * j);
      }
    }
  }
  mt::cp_wait<0>();
  __syncthreads();  // the ring is free: the warps' states go there

  float* macc = reinterpret_cast<float*>(smem);  // [nw][16][DH]
  float* mm = macc + (size_t)nw * 16 * DH;       // [nw][16]
  float* ml = mm + nw * 16;
  float* gw = ml + nw * 16;                      // [MAX_ROWS][KG] weights
  float* gm = gw + MAX_ROWS * KG;                // [MAX_ROWS] m, l
  float* gl = gm + MAX_ROWS;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
#pragma unroll
    for (int j = 0; j < Gm::NO; ++j)
      *reinterpret_cast<float2*>(macc + (size_t)r * DH + 8 * j + 2 * cq) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    if (cq == 0) {
      mm[r] = m[i];
      ml[r] = l[i];
    }
  }
  __syncthreads();

  // the KG groups of a row in group order: a one-range row is done, a
  // longer one leaves this range's partial
  for (int r = tid; r < rows; r += nthr) {
    if (rend_s[r] <= r0) continue;  // the row ended before this range
    const int w0 = (r / 16) * KG * 16 + r % 16;  // group 0's state
    float mx = mm[w0];
#pragma unroll
    for (int k = 1; k < KG; ++k) mx = fmaxf(mx, mm[w0 + 16 * k]);
    float ls = 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const float w = expf(mm[w0 + 16 * k] - mx);
      gw[r * KG + k] = w;
      ls += w * ml[w0 + 16 * k];
    }
    gm[r] = mx;
    gl[r] = ls;
  }
  __syncthreads();
  const size_t nslot = (size_t)gridDim.x * rows * nrange;
  float* pa = part;  // [nslot][DH], then m and l [nslot]
  float* pm = pa + nslot * DH;
  float* pl = pm + nslot;
  for (int e = tid; e < rows * DH; e += nthr) {
    const int r = e / DH, d = e % DH, re = rend_s[r];
    if (re <= r0) continue;
    const int w0 = (r / 16) * KG * 16 + r % 16;
    float as = 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k)
      as += gw[r * KG + k] * macc[(size_t)(w0 + 16 * k) * DH + d];
    if (re <= RK) {
      out[(size_t)rowg_s[r] * DH + d] = as / fmaxf(gl[r], 1e-30f);
    } else {
      const size_t sl = (size_t)rowg_s[r] * nrange + rg;
      pa[sl * DH + d] = as;
      if (d == 0) {
        pm[sl] = gm[r];
        pl[sl] = gl[r];
      }
    }
  }
  if (ntile == 1) return;

  // The tile's last block to finish merges each longer row's ranges in
  // range order, KC ranges at a time: their m and l into shared memory,
  // the row's max, its weights and l (a thread a row), then acc (4 columns
  // a thread, U partials in flight).
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(cnt + blockIdx.x, 1) == ntile - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  constexpr int KC = 32, U = 8, EPT = (DH + 31) / 32;
  constexpr int LPT = 16 * KC / (32 * KG);  // (row, range) pairs a thread
  float* cm = reinterpret_cast<float*>(smem);  // [MAX_ROWS][KC] m, then w
  float* cl = cm + MAX_ROWS * KC;              // [MAX_ROWS][KC] l
  float* rmx = cl + MAX_ROWS * KC;             // [MAX_ROWS]
  float* rls = rmx + MAX_ROWS;                 // [MAX_ROWS]
  auto ranges = [&](int r) {  // a longer row's ranges, else 0
    return rend_s[r] > RK ? (rend_s[r] + RK - 1) / RK : 0;
  };
  auto load_chunk = [&](int k0, bool with_l) {
    float vm[LPT], vl[LPT];
#pragma unroll
    for (int t = 0; t < LPT; ++t) {
      const int i = tid + t * nthr, r = i / KC, k = k0 + i % KC;
      if (r < rows && k < ranges(r)) {
        const size_t sl = (size_t)rowg_s[r] * nrange + k;
        vm[t] = __ldcg(pm + sl);
        if (with_l) vl[t] = __ldcg(pl + sl);
      }
    }
#pragma unroll
    for (int t = 0; t < LPT; ++t) {
      const int i = tid + t * nthr, r = i / KC, k = k0 + i % KC;
      if (r < rows && k < ranges(r)) {
        cm[i] = vm[t];
        if (with_l) cl[i] = vl[t];
      }
    }
  };
  const bool one_chunk = ntile <= KC;
  if (tid < rows) rmx[tid] = NEG_INF;
  for (int k0 = 0; k0 < ntile; k0 += KC) {
    load_chunk(k0, one_chunk);
    __syncthreads();
    if (tid < rows) {
      const int kn = min(KC, ranges(tid) - k0);
      float mx = rmx[tid];
      for (int k = 0; k < kn; ++k) mx = fmaxf(mx, cm[tid * KC + k]);
      rmx[tid] = mx;
      rls[tid] = 0.f;
    }
    if (!one_chunk) __syncthreads();
  }
  float4 acc4[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) acc4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < ntile; k0 += KC) {
    if (!one_chunk) {
      load_chunk(k0, true);
      __syncthreads();
    }
    if (tid < rows) {
      const int kn = min(KC, ranges(tid) - k0);
      float ls = rls[tid];
      for (int k = 0; k < kn; ++k) {
        const float w = expf(cm[tid * KC + k] - rmx[tid]);
        cm[tid * KC + k] = w;
        ls += w * cl[tid * KC + k];
      }
      rls[tid] = ls;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const int e = tid + j * nthr, r = e / (DH / 4), d = 4 * (e % (DH / 4));
      if (r >= rows) continue;
      const int kn = min(KC, ranges(r) - k0);
      const float* src = pa + ((size_t)rowg_s[r] * nrange + k0) * DH + d;
      for (int k = 0; k < kn; k += U) {
        float4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k + u < kn)
            v[u] = __ldcg(reinterpret_cast<const float4*>(
                src + (size_t)(k + u) * DH));
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k + u < kn) {
            const float w = cm[r * KC + k + u];
            acc4[j].x += w * v[u].x;
            acc4[j].y += w * v[u].y;
            acc4[j].z += w * v[u].z;
            acc4[j].w += w * v[u].w;
          }
      }
    }
    __syncthreads();  // the chunk's weights consumed
  }
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int e = tid + j * nthr, r = e / (DH / 4), d = 4 * (e % (DH / 4));
    if (r >= rows || ranges(r) == 0) continue;
    const float lf = fmaxf(rls[r], 1e-30f);
    *reinterpret_cast<float4*>(out + (size_t)rowg_s[r] * DH + d) =
        make_float4(acc4[j].x / lf, acc4[j].y / lf, acc4[j].z / lf,
                    acc4[j].w / lf);
  }
  if (tid == 0) cnt[blockIdx.x] = 0;  // ready for the next launch
}

template <typename PT, int DH, int RK>
int launch(const void* q, int q_f32, const void* kp, const void* vp,
           const float* ks, const float* vs, const int* table,
           const int* q_pos, int batch, int h, int hkv, int c, int qt,
           int ps, int npp, int nrange, int window, float scale, float cap,
           int has_cap, float* out, float* part, int* cnt,
           cudaStream_t stream) {
  const int G = h / hkv, nw = KG * ((G * qt + 15) / 16);
  const size_t smem =
      layout<PT, DH>(nw, q_f32, (RK - 1) / ps + 2).total;
  auto kern = paged_attn<PT, DH, RK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int ps_log2 = -1;
  for (int k = 0; k < 31; ++k)
    if (ps == 1 << k) ps_log2 = k;
  const dim3 grid(batch * hkv * (c / qt), nrange);
  kern<<<grid, 32 * nw, smem, stream>>>(
      q, q_f32, static_cast<const PT*>(kp), static_cast<const PT*>(vp), ks,
      vs, table, q_pos, c, qt, G, hkv, ps, ps_log2, npp, nrange, window,
      scale, cap, has_cap, out, part, cnt);
  return (int)cudaGetLastError();
}

template <typename PT, int RK>
int by_head_dim(int dh, const void* q, int q_f32, const void* kp,
                const void* vp, const float* ks, const float* vs,
                const int* table, const int* q_pos, int batch, int h,
                int hkv, int c, int qt, int ps, int npp, int nrange,
                int window, float scale, float cap, int has_cap, float* out,
                float* part, int* cnt, cudaStream_t stream) {
#define PA_CALL(DH)                                                        \
  if (dh == DH)                                                            \
  return launch<PT, DH, RK>(q, q_f32, kp, vp, ks, vs, table, q_pos, batch, \
                            h, hkv, c, qt, ps, npp, nrange, window, scale, \
                            cap, has_cap, out, part, cnt, stream)
  PA_CALL(16);
  PA_CALL(32);
  PA_CALL(48);
  PA_CALL(64);
  PA_CALL(80);
  PA_CALL(96);
  PA_CALL(112);
  PA_CALL(128);
  PA_CALL(144);
  PA_CALL(160);
  PA_CALL(176);
  PA_CALL(192);
  PA_CALL(208);
  PA_CALL(224);
  PA_CALL(240);
  PA_CALL(256);
#undef PA_CALL
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_kind: 0 = bf16, 1 = f32.  page_kind: 0 = bf16, 1 = int8 (ks/vs given).
// qt must divide c, with (h / hkv) * qt <= 32; dh a multiple of 16 up to
// 256; range_keys (the keys of a range) this library's PA_RANGE; nrange
// = ceil(npp * ps / range_keys), the most ranges a row can have.
// part: scratch of batch * h * c * nrange * (dh + 2) floats (unused if
// nrange == 1); cnt: batch * hkv * (c / qt) int32 counters, 0 before the
// launch and 0 after it (launches that share them run one at a time, as
// on one stream).  q, kp and vp 16-byte aligned.  Returns the cudaError_t
// of the launch.
extern "C" int paged_attention_chunk_launch(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* q_pos, void* part,
    void* cnt, void* out, int q_kind, int page_kind, int batch, int h,
    int hkv, int dh, int c, int qt, int ps, int npp, int range_keys,
    int nrange, int window, float scale, float cap, int has_cap,
    void* stream) {
  if (hkv <= 0 || h % hkv != 0 || c <= 0 || qt <= 0 || c % qt != 0 ||
      h / hkv * qt > MAX_ROWS || ps <= 0 || npp <= 0 ||
      range_keys != PA_RANGE ||
      nrange != (npp * ps + range_keys - 1) / range_keys ||
      (q_kind != 0 && q_kind != 1) ||
      (page_kind == 1 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* ksf = page_kind == 1 ? static_cast<const float*>(ks) : nullptr;
  const float* vsf = page_kind == 1 ? static_cast<const float*>(vs) : nullptr;
  const int* tb = static_cast<const int*>(table);
  const int* qp = static_cast<const int*>(q_pos);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(cnt);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_KIND(PT, R)                                                      \
  return by_head_dim<PT, R>(dh, q, q_kind, kp, vp, ksf, vsf, tb, qp, batch, \
                            h, hkv, c, qt, ps, npp, nrange, window, scale,  \
                            cap, has_cap, o, pt, ct, s)
  if (page_kind == 0) PA_KIND(__nv_bfloat16, PA_RANGE);
  if (page_kind == 1) PA_KIND(int8_t, PA_RANGE);
#undef PA_KIND
  return (int)cudaErrorInvalidValue;
}
