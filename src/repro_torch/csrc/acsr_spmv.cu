// Blocked-ACSR sparse matrix times activations, act(W @ x + bias), for Hopper.
//
// Replaces the TPU kernel `_fused_spmv_kernel` of
// src/repro/kernels/acsr_spmv.py (launched by `_spmv_call` / `acsr_spmv`).
//
// Layout (the row-balanced slot schedule of `block_encode`):
//   values    [nb, rmax, br]   uint8 codes into a 16-entry codebook (aida),
//                              or f32 / bf16 values (acsr)
//   col_idx   [nb, rmax, br]   int16 (n_cols < 2^15) or int32; a row's live
//                              slots hold its columns in ascending order
//   row_nnz   [nb, br]         int32; slot s of lane r is live while
//                              s < row_nnz[r]
//   chunk_off [nb, nck+1, br]  int32; the first slot of each row whose
//                              column is >= c * KT (KT = 64), derived from
//                              col_idx and row_nnz when the container is made
//   x         [K, B] f32, out [nb*br, B] f32
//
// What bounds it.  The bound counts bytes (each live slot's value and
// column once, x and out) and 2 * nnz * B operations at the f32 rate: 0.05
// ms a layer of llama3-8b at B = 4 or 32.  x has no reuse across rows, so
// every multiply-add needs its own x value.  Two variants:
//
// The gather variant (B <= 8, a decode step).  One thread a row gathers
// its x values from L2 for each live slot, in f32 FMAs.  Each thread issues
// the loads of UNROLL = 4 slots before it uses any (the code -> column -> x
// chain is dependent) and reads a 4-column x row as one 16-byte load.  The
// slot axis is split across threadIdx.y and, when few row blocks would
// leave SMs idle, across blockIdx.y into slot ranges whose partials a
// second pass adds in split order.  Latency holds it at ~20 % of its byte
// bound; at B = 32 its 8-column passes reread the weights four times,
// which is why wider x takes the other variant.
//
// The tensor-core variant (B > 8, a chunked-prefill step).  It expands the
// sparse tile into a dense one in shared memory and multiplies it with
// `mma.sync` m16n8k16, paying for the zeros it multiplies:
//  * A block owns ROWS = 64 matrix rows and one range of K (a split), and
//    walks it in K tiles of KT = 64.  For each tile each row's live slots
//    of the tile are written as (bf16 hi | lo << 16) words into a [64][64]
//    word tile, x's [64][B] tile is staged as hi and lo bf16 planes, and
//    warps 0-3 multiply them, 16 rows and every 8-column n-tile each, the
//    split products in two independent accumulators.  Up to 32 columns go
//    through one pass over the weight stream; wider x loops over
//    32-column groups, each reading the weights once.
//  * Two tile buffers and one barrier a tile: while warps 0-3 stage x's
//    tile t + 1 and multiply tile t, warps 4-7 scatter tile t + 1 into the
//    other buffer; warps 0-3 then zero the rows they read.  The rows' tile
//    ends (chunk_off) are loaded three tiles ahead.
//  * Precision: a value w and x split into bf16 hi + lo, w x is summed as
//    w_hi x_hi + w_hi x_lo + w_lo x_hi (w_lo = 0 for bf16 values, so two
//    products), each term within ~2^-16 of the exact product, far inside
//    the 1e-4 the plain f32 version is held to.
//  * Walking a row tile by tile relies on its live slots holding ascending
//    columns (both encoders fill a row in row-major `nonzero` order): the
//    slots of tile c are the run [chunk_off[c], chunk_off[c + 1]).  Two
//    threads share a row, each taking every other slot, U = 8 at a time.
//  * The slot-major stream is read coalesced: slot-rows (one slot of all 64
//    rows, rows padded by 16 bytes to spread the banks) are copied by
//    `cp.async` into a ring of R slot-rows in shared memory, from the
//    lowest cursor of the block up to R ahead, a group a tile, each read
//    three tiles after it was issued.  Rows run apart (at a given column
//    their cursors differ by the spread of their nonzero counts); a slot
//    past what has landed in the ring is read from device memory directly,
//    so any spread stays correct.
//  * Few row blocks would leave most SMs idle (wk / wv have 16), so K is
//    split over blockIdx.y at tile boundaries, the rows' starting slots
//    read from chunk_off.  Each split writes its partial sums, and a second
//    pass adds them in split order, then bias and activation.  With one
//    split the first pass runs the epilogue.  No atomics, and the sum order
//    within a split is fixed by the tile and fragment order, so results
//    repeat bit for bit.
//  * What holds it: the shared-memory traffic and latency spent per dense
//    element (the scatter, the fragment loads, the zeroing), not the
//    tensor cores.
//
// Both variants: dead slots are never visited (a row's walk ends at
// row_nnz, never at a code of 0: a live nonzero may map to centroid 0;
// padding holds code 0, column 0); int16 and int32 column ids are separate
// instantiations, never widened; bias and activation run in the epilogue.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tile.cuh"

namespace {

constexpr int MAXB = 8;            // gather variant: columns per pass
constexpr int UNROLL = 4;          // gather variant: slots with loads in flight
constexpr int ROWS = 64;           // matrix rows per block: 4 m-tiles
constexpr int NTHREADS = 256;      // 8 warps: 0-3 multiply, 4-7 scatter
constexpr int NHALF = NTHREADS / 2;   // threads of each half
constexpr int TPR = NHALF / ROWS;  // scatter threads sharing a row's walk
constexpr int KT = 64;             // K tile
constexpr int LDW = KT + 8;        // A row in words: = 8 mod 32, so the
                                   // fragment loads hit every bank once
constexpr int GROUP = 32;          // x columns per pass over the weights
constexpr int U = 8;               // slots a scatter thread reads at once
constexpr int RING_BYTES = 56 * 1024;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

__device__ __forceinline__ float activate(float y, int act) {
  if (act == ACT_RELU) return y > 0.f ? y : 0.f;
  if (act == ACT_SILU) return y / (1.f + expf(-y));
  if (act == ACT_GELU) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * y * (1.f + tanhf(c * (y + 0.044715f * y * y * y)));
  }
  return y;
}

constexpr int pow2_floor(int v) {
  int p = 1;
  while (p * 2 <= v) p *= 2;
  return p;
}

template <typename VT>
__device__ __forceinline__ float load_value(const VT* p, const float* cents);

template <>
__device__ __forceinline__ float load_value<uint8_t>(const uint8_t* p,
                                                     const float* cents) {
  return cents[__ldg(p)];
}

template <>
__device__ __forceinline__ float load_value<float>(const float* p,
                                                   const float*) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ float load_value<__nv_bfloat16>(
    const __nv_bfloat16* p, const float*) {
  return __bfloat162float(*p);
}

// The gather variant (x <= 8 columns) ------------------------------------
// acc[j] += w * x[c, j0 + j] for the nbc batch columns; one 16-byte load
// when x has exactly four columns.
__device__ __forceinline__ void gather_fma(float* acc, float w,
                                           const float* __restrict__ x,
                                           int c, int ldx, int j0, int nbc) {
  const float* xr = x + (size_t)c * ldx + j0;
  if (ldx == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(xr));
    acc[0] += w * v.x;
    acc[1] += w * v.y;
    acc[2] += w * v.z;
    acc[3] += w * v.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < MAXB; ++j)
    if (j < nbc) acc[j] += w * __ldg(xr + j);
}

// grid (nb, nsplit), block (br, sy).  Each thread sums the live slots
// s0 + ty, s0 + ty + sy, ... of its lane for `nbc` batch columns starting
// at column j0 of x (row stride ldx); partials go through shared memory.
template <typename VT, typename CT>
__global__ void spmv_gather(const VT* __restrict__ vals,
                             const CT* __restrict__ cols,
                             const int* __restrict__ row_nnz,
                             const float* __restrict__ cents,
                             const float* __restrict__ x, int ldx, int j0,
                             int nbc, int rmax, int slots_per_split,
                             int nsplit, const float* __restrict__ bias,
                             int act, float* __restrict__ out, int ldo,
                             float* __restrict__ part) {
  extern __shared__ float red[];  // [sy][br][nbc]
  __shared__ float s_cents[16];
  const int br = blockDim.x, sy = blockDim.y;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int blk = blockIdx.x, split = blockIdx.y;
  const int nrows = gridDim.x * br;
  if (cents != nullptr && ty == 0 && lane < 16) s_cents[lane] = cents[lane];
  __syncthreads();

  const int row = blk * br + lane;
  const int nnz = row_nnz[row];
  const int s0 = split * slots_per_split;
  const int s1 = min(min(s0 + slots_per_split, rmax), nnz);
  float acc[MAXB];
#pragma unroll
  for (int j = 0; j < MAXB; ++j) acc[j] = 0.f;

  const size_t base = (size_t)blk * rmax * br + lane;
  int s = s0 + ty;
  // UNROLL slots at a time: their code/column loads are issued together,
  // then their x gathers, so each thread keeps several loads in flight
  for (; s + (UNROLL - 1) * sy < s1; s += UNROLL * sy) {
    float w[UNROLL];
    int c[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t idx = base + (size_t)(s + u * sy) * br;
      w[u] = load_value<VT>(vals + idx, s_cents);
      c[u] = (int)cols[idx];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      gather_fma(acc, w[u], x, c[u], ldx, j0, nbc);
  }
  for (; s < s1; s += sy) {
    const size_t idx = base + (size_t)s * br;
    gather_fma(acc, load_value<VT>(vals + idx, s_cents), x, (int)cols[idx],
               ldx, j0, nbc);
  }

#pragma unroll
  for (int j = 0; j < MAXB; ++j)
    if (j < nbc) red[(ty * br + lane) * nbc + j] = acc[j];
  __syncthreads();
  if (ty != 0) return;
  for (int j = 0; j < nbc; ++j) {
    float v = 0.f;
    for (int t = 0; t < sy; ++t) v += red[(t * br + lane) * nbc + j];
    if (nsplit == 1) {
      if (bias != nullptr) v += bias[row];
      out[(size_t)row * ldo + j0 + j] = activate(v, act);
    } else {
      part[((size_t)split * nrows + row) * nbc + j] = v;
    }
  }
}

// The tensor-core variant -------------------------------------------------
template <typename VT, typename CT>
struct Cfg {
  // a ring slot-row of values / column ids, in elements: 16 bytes past
  // the 64 rows, so the slots one row's threads read fall in other banks
  static constexpr int SV = ROWS + 16 / (int)sizeof(VT);
  static constexpr int SC = ROWS + 16 / (int)sizeof(CT);
  static constexpr int R =           // ring slot-rows (a power of two)
      pow2_floor(RING_BYTES / (SV * (int)sizeof(VT) + SC * (int)sizeof(CT)));
  static constexpr bool LO = !std::is_same<VT, __nv_bfloat16>::value;
  static constexpr int CV = ROWS * sizeof(VT) / 16;  // 16-byte pieces of
  static constexpr int CQ = CV + ROWS * sizeof(CT) / 16;  // one slot-row
  static constexpr int NS = NTHREADS / CQ;  // slot-rows per staging pass
};

template <int NT>
struct XTile {  // x tile [KT][LDX] bf16, NB = 8 * NT columns
  static constexpr int NB = 8 * NT;
  static constexpr int LDX = (NB < 16 ? 16 : NB) + 8;  // conflict-free
  static constexpr int PAIRS = KT * NB / 2 / NHALF;  // per multiplying thread
};

template <typename VT, typename CT, int NT>
struct Smem {
  // one tile buffer: A as [ROWS][LDW] words (bf16 hi | lo << 16), then
  // x's hi and lo planes [KT][LDX] bf16
  static constexpr int A_BYTES = ROWS * LDW * 4;
  static constexpr int BUF = A_BYTES + 2 * KT * XTile<NT>::LDX * 2;
  static constexpr size_t BYTES =
      (size_t)Cfg<VT, CT>::R * (Cfg<VT, CT>::SV * sizeof(VT) +
                                Cfg<VT, CT>::SC * sizeof(CT)) +
      2 * (size_t)BUF;
};

// min / max over a warp in one `redux.sync` (the block's eight are then
// combined in shared memory)
__device__ __forceinline__ int warp_min(int v) {
  return __reduce_min_sync(~0u, v);
}
__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(~0u, v);
}

// Copy slot-rows [s0, s1) into the ring: this thread copies one 16-byte
// piece (values or column ids of 16 / size rows) of every ns-th slot-row
// from s_off on (src0 null: none).  The caller commits the group.
template <int R>
__device__ __forceinline__ void stage(const unsigned char* src0,
                                      size_t src_step, unsigned char* dst0,
                                      int dst_step, int s_off, int ns,
                                      int s0, int s1) {
  if (src0 != nullptr)
    for (int s = s0 + s_off; s < s1; s += ns)
      mt::cp_async16(dst0 + (s & (R - 1)) * dst_step,
                     src0 + (size_t)s * src_step);
}

// x rows [k0, k0 + KT), columns [j0, j0 + nbc) as pairs of neighbouring
// columns, PAIRS per thread of the multiplying half (0 past K or nbc)
template <int NT>
__device__ __forceinline__ void load_x(float (&xr)[XTile<NT>::PAIRS][2],
                                       const float* __restrict__ x, int ldx,
                                       int j0, int nbc, int n_cols, int k0,
                                       int tid) {
  using X = XTile<NT>;
#pragma unroll
  for (int i = 0; i < X::PAIRS; ++i) {
    const int q = tid + i * NHALF;
    const int k = k0 + q / (X::NB / 2), n = 2 * (q % (X::NB / 2));
    const float* src = x + (size_t)k * ldx + j0 + n;
    xr[i][0] = k < n_cols && n < nbc ? src[0] : 0.f;
    xr[i][1] = k < n_cols && n + 1 < nbc ? src[1] : 0.f;
  }
}

// Scatter slots s0, s0 + TPR, ... below q of one row into its A words
// (w: the row's word row; rv / rc: the row's column of the ring), U at a
// time.  Rounds are warp-wide, as the codebook is read by shuffle.  With
// RING_ONLY every slot is known to have landed in the ring; otherwise a
// slot at or past `landed` is read from device memory.
template <typename VT, typename CT, int R, bool RING_ONLY>
__device__ __forceinline__ void scatter(uint32_t* w, const VT* rv,
                                        const CT* rc,
                                        const VT* __restrict__ vals,
                                        const CT* __restrict__ cols,
                                        size_t sbase, int br, int landed,
                                        uint32_t tab, int s0, int q, int k1) {
  using C = Cfg<VT, CT>;
  for (int s = s0; __any_sync(~0u, s < q); s += TPR * U) {
    int cc[U];
    VT vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int su = s + TPR * u;
      cc[u] = -1;
      vv[u] = VT{};
      if (su < q) {
        if (RING_ONLY || su < landed) {
          const int at = su & (R - 1);
          cc[u] = rc[at * C::SC];
          vv[u] = rv[at * C::SV];
        } else {
          cc[u] = cols[sbase + (size_t)su * br];
          vv[u] = vals[sbase + (size_t)su * br];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint32_t v;
      if constexpr (std::is_same<VT, uint8_t>::value) {
        v = __shfl_sync(~0u, tab, vv[u] & 15);
      } else if constexpr (std::is_same<VT, float>::value) {
        const mt::Split sp = mt::split(vv[u]);
        v = mt::pack(sp.hi, sp.lo);
      } else {
        v = (uint32_t)__bfloat16_as_ushort(vv[u]);
      }
      if (cc[u] >= 0) w[cc[u] - k1] = v;
    }
  }
}

// A fragment rows (g, g + 8), depth k0 .. k0 + 15 of the word tile: each
// 8-byte load gives two neighbouring words; their hi halves make the hi
// fragment register, their lo halves the lo one.
__device__ __forceinline__ void load_a_words(uint32_t* hi, uint32_t* lo,
                                             const uint32_t* w, int r0,
                                             int k0, int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a0 (g, 2c), a1 (g + 8), a2 (+8 deep), a3
    const uint2 v = *reinterpret_cast<const uint2*>(
        w + (r0 + g + (i & 1) * 8) * LDW + k0 + 2 * c + (i >> 1) * 8);
    hi[i] = __byte_perm(v.x, v.y, 0x5410);
    lo[i] = __byte_perm(v.x, v.y, 0x7632);
  }
}

// grid (ceil(nb * br / ROWS), nsplit), block NTHREADS.  Columns
// [j0, j0 + nbc) of x (row stride ldx), nbc <= 8 * NT.  chunk_off steps
// are tiles: chunk_cols == KT.
//
// Step t of the tile loop (t = -1 prepares only), between two barriers:
// every thread issues the ring's next copies; warps 4-7 scatter each row's
// slots of tile t + 1 into the other buffer, while warps 0-3 stage x's
// tile t + 1 and multiply tile t, then zero the A rows they read.
template <typename VT, typename CT, int NT>
__global__ void __launch_bounds__(NTHREADS, 2)
    spmv_mma(const VT* __restrict__ vals, const CT* __restrict__ cols,
             const int* __restrict__ row_nnz,
             const int* __restrict__ chunk_off,
             const float* __restrict__ cents, const float* __restrict__ x,
             int ldx, int j0, int nbc, int nb, int rmax, int br, int n_cols,
             int nck, int chunks_per_split, int nsplit,
             const float* __restrict__ bias, int act,
             float* __restrict__ out, int ldo, float* __restrict__ part) {
  using C = Cfg<VT, CT>;
  using X = XTile<NT>;
  using S = Smem<VT, CT, NT>;
  constexpr int R = C::R;
  extern __shared__ __align__(16) unsigned char smem[];
  VT* ring_v = reinterpret_cast<VT*>(smem);                      // [R][SV]
  CT* ring_c = reinterpret_cast<CT*>(ring_v + R * C::SV);        // [R][SC]
  unsigned char* bufs = reinterpret_cast<unsigned char*>(ring_c + R * C::SC);
  auto a_of = [&](int b) {
    return reinterpret_cast<uint32_t*>(bufs + b * S::BUF);
  };
  auto xh_of = [&](int b) {
    return reinterpret_cast<__nv_bfloat16*>(bufs + b * S::BUF + S::A_BYTES);
  };
  __shared__ int s_min[2][8], s_max[8];


  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool multiplier = tid < NHALF;
  const int nrows = nb * br, row0 = blockIdx.x * ROWS, split = blockIdx.y;
  // a scatter thread's row and its place among the row's TPR threads
  const int rl = multiplier ? 0 : (tid - NHALF) / TPR;
  const int h = (tid - NHALF) % TPR;
  const int row = multiplier ? nrows : row0 + rl;
  const int c_lo = split * chunks_per_split;
  const int c_hi = min(c_lo + chunks_per_split, nck);

  // the codebook as (hi | lo << 16), entry c in lanes c and c + 16 of every
  // warp, read by shuffle
  uint32_t tab = 0;
  if (cents != nullptr) {
    const mt::Split s = mt::split(cents[lane & 15]);
    tab = mt::pack(s.hi, s.lo);
  }
  // this row's tile offsets: off[c] is its first slot at or past column
  // c * KT; its slots of tile c are [off[c], off[c + 1])
  const int* off = chunk_off;
  int p = 0, end = 0;
  size_t sbase = 0;  // slot s of this row at sbase + s * br
  if (row < nrows) {
    const int blk = row / br, ln = row % br;
    off = chunk_off + (size_t)blk * (nck + 1) * br + ln;
    p = off[(size_t)c_lo * br];
    end = min(off[(size_t)c_hi * br], row_nnz[row]);
    sbase = (size_t)blk * rmax * br + ln;
  }
  {
    const int m = warp_min(p < end ? p : INT_MAX), mx = warp_max(end);
    if (lane == 0) {
      s_min[1][warp] = m;
      s_max[warp] = mx;
    }
  }
  // every A word starts at 0 (the tile's absent entries)
  for (int i = tid; i < 2 * S::A_BYTES / 16; i += NTHREADS)
    reinterpret_cast<uint4*>(bufs + (i / (S::A_BYTES / 16)) * S::BUF)
        [i % (S::A_BYTES / 16)] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  int lo = INT_MAX, smax = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    lo = min(lo, s_min[1][w]);
    smax = max(smax, s_max[w]);
  }

  // this thread's staging piece, its addresses set up once
  const unsigned char* src0 = nullptr;
  unsigned char* dst0 = nullptr;
  size_t src_step = 0;
  int dst_step = 0;
  const int s_off = tid / C::CQ;
  {
    const int q = tid % C::CQ;
    const bool is_v = q < C::CV;
    const int esz = is_v ? (int)sizeof(VT) : (int)sizeof(CT);
    const int r = (is_v ? q : q - C::CV) * (16 / esz), g = row0 + r;
    if (s_off < C::NS && g < nrows) {
      const unsigned char* base =
          is_v ? reinterpret_cast<const unsigned char*>(vals)
               : reinterpret_cast<const unsigned char*>(cols);
      src0 = base + ((size_t)(g / br) * rmax * br + g % br) * esz;
      src_step = (size_t)br * esz;
      dst0 = (is_v ? reinterpret_cast<unsigned char*>(ring_v)
                   : reinterpret_cast<unsigned char*>(ring_c)) + r * esz;
      dst_step = is_v ? C::SV * esz : C::SC * esz;
    }
  }

  // Ring bookkeeping: slot-rows below `fill` are issued; the three newest
  // groups may still be in flight, everything below `landed` (the start of
  // the oldest of them) has landed.  A new group never reaches R past the
  // lowest cursor nor past the start of the oldest group in flight, so it
  // only overwrites slot-rows every row has passed, and never a position a
  // group in flight writes.
  int fill = lo;
  if (lo != INT_MAX) {
    fill = min(lo + R, smax);
    stage<R>(src0, src_step, dst0, dst_step, s_off, C::NS, lo, fill);
  }
  mt::cp_commit();
  // the rows' tile ends, loaded three steps ahead: the end of tile c
  // (chunk_off entry c + 1) in qa, qb or qc by (c - c_lo) % 3
  int qa = 0, qb = 0, qc = 0;
  if (row < nrows) {
    qa = off[(size_t)min(c_lo + 1, c_hi) * br];
    qb = off[(size_t)min(c_lo + 2, c_hi) * br];
    qc = off[(size_t)min(c_lo + 3, c_hi) * br];
  }
  float xr[X::PAIRS][2];
  if (multiplier) load_x<NT>(xr, x, ldx, j0, nbc, n_cols, c_lo * KT, tid);
  mt::cp_wait<0>();
  // f1, f2, f3: the starts of the groups issued one, two and three steps
  // ago; up to three groups stay in flight
  int f1 = fill, f2 = fill, f3 = fill, landed = fill;
  __syncthreads();

  // two accumulators per n-tile (hi hi + hi lo, lo hi): independent mma
  // chains, added at the end; warps 0-3 multiply, 16 rows each, every
  // n-tile
  float acc[2][NT][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
  const int mrow = 16 * warp;

  for (int t = -1;; ++t) {
    const int c1 = c_lo + t + 1;  // the tile prepared this step
    const int buf = t & 1, nxt = buf ^ 1;
    int start = fill;  // of this step's group
    if (t >= 0) {
      lo = INT_MAX;
#pragma unroll
      for (int w = NHALF / 32; w < 8; ++w) lo = min(lo, s_min[buf][w]);
      if (lo != INT_MAX) {  // the ring's next copies
        start = max(fill, lo);
        const int to = max(start, min(min(lo, f3) + R, smax));
        stage<R>(src0, src_step, dst0, dst_step, s_off, C::NS, start, to);
        fill = to;
      }
    }
    mt::cp_commit();
    f3 = f2;
    f2 = f1;
    f1 = start;
    const bool more = c1 < c_hi && lo != INT_MAX;
    if (multiplier) {
      if (more) {  // x's tile c1 into buffer nxt
        __nv_bfloat16* x_hi = xh_of(nxt);
        __nv_bfloat16* x_lo = x_hi + KT * X::LDX;
#pragma unroll
        for (int i = 0; i < X::PAIRS; ++i) {
          const int q = tid + i * NHALF;
          const int k = q / (X::NB / 2), n = 2 * (q % (X::NB / 2));
          uint32_t hi, lo2;
          mt::split2(xr[i][0], xr[i][1], hi, lo2);
          *reinterpret_cast<uint32_t*>(x_hi + k * X::LDX + n) = hi;
          *reinterpret_cast<uint32_t*>(x_lo + k * X::LDX + n) = lo2;
        }
        if (c1 + 1 < c_hi)
          load_x<NT>(xr, x, ldx, j0, nbc, n_cols, (c1 + 1) * KT, tid);
      }
      if (t >= 0) {  // tile t on the tensor cores, then zero its rows
        uint32_t* aw = a_of(buf);
        const __nv_bfloat16* xhp = xh_of(buf);
        const __nv_bfloat16* xlp = xhp + KT * X::LDX;
#pragma unroll
        for (int ks = 0; ks < KT; ks += 16) {
          uint32_t fa[4], fl[4];
          load_a_words(fa, fl, aw, mrow, ks, lane);
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t bh[4], bl[4];
            if (NT == 1) {
              mt::load_b_kn1(bh, xhp, X::LDX, 0, ks, lane);
              mt::load_b_kn1(bl, xlp, X::LDX, 0, ks, lane);
            } else {
              mt::load_b_kn(bh, xhp, X::LDX, 8 * j, ks, lane);
              mt::load_b_kn(bl, xlp, X::LDX, 8 * j, ks, lane);
            }
#pragma unroll
            for (int jj = 0; jj < (NT == 1 ? 1 : 2); ++jj) {
              mt::mma(acc[0][j + jj], fa, bh + 2 * jj);
              mt::mma(acc[0][j + jj], fa, bl + 2 * jj);
              if (C::LO) mt::mma(acc[1][j + jj], fl, bh + 2 * jj);
            }
          }
        }
        __syncwarp();  // every lane's loads of these rows are done
        uint4* z = reinterpret_cast<uint4*>(aw + mrow * LDW);
        for (int i = lane; i < 16 * LDW / 4; i += 32)
          z[i] = make_uint4(0, 0, 0, 0);
      }
    } else if (more) {
      // Scatter this row's slots [p, q) of tile c1: thread h takes p + h,
      // p + h + TPR, ..., U at a time.  A warp whose rows all lie within
      // what has landed in the ring reads only the ring.
      uint32_t* aw = a_of(nxt) + rl * LDW;
      int q;
      const int cn = c1 + 4;  // the tile end read three steps on
      const bool ld = row < nrows && cn <= c_hi;
      switch ((c1 - c_lo) % 3) {
        case 0:
          q = qa;
          if (ld) qa = off[(size_t)cn * br];
          break;
        case 1:
          q = qb;
          if (ld) qb = off[(size_t)cn * br];
          break;
        default:
          q = qc;
          if (ld) qc = off[(size_t)cn * br];
      }
      q = min(q, end);
      if (__all_sync(~0u, q <= landed))
        scatter<VT, CT, R, true>(aw, ring_v + rl, ring_c + rl, vals, cols,
                                 sbase, br, landed, tab, p + h, q, c1 * KT);
      else
        scatter<VT, CT, R, false>(aw, ring_v + rl, ring_c + rl, vals, cols,
                                  sbase, br, landed, tab, p + h, q, c1 * KT);
      p = q;
      const int m = warp_min(p < end ? p : INT_MAX);
      if (lane == 0) s_min[nxt][warp] = m;
    }
    mt::cp_wait<3>();  // every group but the last three has landed
    landed = f3;
    __syncthreads();
    if (!more) break;  // tile t was the last with a slot
  }
  mt::cp_wait<0>();

  // epilogue: accumulator rows g, g + 8 and column pairs 2c, 2c + 1
  if (!multiplier) return;
  const int g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + mrow + g + (e >> 1) * 8;
      const int n = 8 * j + 2 * cq + (e & 1);
      if (r >= nrows || n >= nbc) continue;
      float v = acc[0][j][e] + acc[1][j][e];
      if (nsplit == 1) {
        if (bias != nullptr) v += bias[r];
        out[(size_t)r * ldo + j0 + n] = activate(v, act);
      } else {
        part[((size_t)split * nrows + r) * nbc + n] = v;
      }
    }
  }
}

// Second pass: sum the nsplit partials in split order, then bias + act.
__global__ void spmv_finalize(const float* __restrict__ part, int nsplit,
                              int nrows, int nbc,
                              const float* __restrict__ bias, int act,
                              float* __restrict__ out, int ldo, int j0) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nrows * nbc) return;
  float v = 0.f;
  for (int s = 0; s < nsplit; ++s) v += part[(size_t)s * nrows * nbc + i];
  const int row = i / nbc, j = i % nbc;
  if (bias != nullptr) v += bias[row];
  out[(size_t)row * ldo + j0 + j] = activate(v, act);
}

template <typename VT, typename CT>
int launch_gather(const void* vals, const void* cols, const int* row_nnz,
           const float* cents, const float* x, const float* bias,
           float* out, float* part, int nb, int rmax, int br, int sy,
           int batch, int nsplit, int slots_per_split, int act,
           cudaStream_t stream) {
  const dim3 grid(nb, nsplit), block(br, sy);
  const int nrows = nb * br;
  for (int j0 = 0; j0 < batch; j0 += MAXB) {
    const int nbc = batch - j0 < MAXB ? batch - j0 : MAXB;
    const size_t smem = (size_t)sy * br * nbc * sizeof(float);
    spmv_gather<VT, CT><<<grid, block, smem, stream>>>(
        static_cast<const VT*>(vals), static_cast<const CT*>(cols), row_nnz,
        cents, x, batch, j0, nbc, rmax, slots_per_split, nsplit, bias, act,
        out, batch, part);
    if (nsplit > 1) {
      const int n = nrows * nbc, threads = 256;
      spmv_finalize<<<(n + threads - 1) / threads, threads, 0, stream>>>(
          part, nsplit, nrows, nbc, bias, act, out, batch, j0);
    }
  }
  return (int)cudaGetLastError();
}


template <typename VT, typename CT, int NT>
int launch_group(const void* vals, const void* cols, const int* row_nnz,
                 const int* chunk_off, const float* cents, const float* x,
                 const float* bias, float* out, float* part, int nb,
                 int rmax, int br, int n_cols, int batch, int j0, int nbc,
                 int nck, int cps, int nsplit, int act, cudaStream_t stream) {
  constexpr size_t smem = Smem<VT, CT, NT>::BYTES;
  auto kern = spmv_mma<VT, CT, NT>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int nrows = nb * br;
  const dim3 grid((nrows + ROWS - 1) / ROWS, nsplit);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const VT*>(vals), static_cast<const CT*>(cols), row_nnz,
      chunk_off, cents, x, batch, j0, nbc, nb, rmax, br, n_cols, nck, cps,
      nsplit, bias, act, out, batch, part);
  if (nsplit > 1) {
    const int n = nrows * nbc, threads = 256;
    spmv_finalize<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        part, nsplit, nrows, nbc, bias, act, out, batch, j0);
  }
  return (int)cudaGetLastError();
}

template <typename VT, typename CT>
int launch_mma(const void* vals, const void* cols, const int* row_nnz,
           const int* chunk_off, const float* cents, const float* x,
           const float* bias, float* out, float* part, int nb, int rmax,
           int br, int n_cols, int batch, int nck, int cps, int nsplit,
           int act, cudaStream_t stream) {
  for (int j0 = 0; j0 < batch; j0 += GROUP) {
    const int nbc = batch - j0 < GROUP ? batch - j0 : GROUP;
    int err;
    if (nbc <= 8)
      err = launch_group<VT, CT, 1>(vals, cols, row_nnz, chunk_off, cents, x,
                                    bias, out, part, nb, rmax, br, n_cols,
                                    batch, j0, nbc, nck, cps, nsplit, act,
                                    stream);
    else if (nbc <= 16)
      err = launch_group<VT, CT, 2>(vals, cols, row_nnz, chunk_off, cents, x,
                                    bias, out, part, nb, rmax, br, n_cols,
                                    batch, j0, nbc, nck, cps, nsplit, act,
                                    stream);
    else
      err = launch_group<VT, CT, 4>(vals, cols, row_nnz, chunk_off, cents, x,
                                    bias, out, part, nb, rmax, br, n_cols,
                                    batch, j0, nbc, nck, cps, nsplit, act,
                                    stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// value_kind: 0 = uint8 codes (needs cents), 1 = f32, 2 = bf16.
// col_kind:   0 = int16, 1 = int32.
// chunk_off's steps are K tiles (chunk_cols must be KT = 64); K is split
// into nsplit ranges of `cps` tiles (nsplit = ceil(nck / cps)); part:
// scratch of nsplit * nb * br * min(batch, 32) floats (unused when
// nsplit == 1).  Returns the cudaError_t of the launches.
extern "C" int acsr_spmv_mma_launch(const void* vals, const void* cols,
                                const void* row_nnz, const void* chunk_off,
                                const void* cents, const void* x,
                                const void* bias, void* out, void* part,
                                int value_kind, int col_kind, int nb,
                                int rmax, int br, int n_cols, int batch,
                                int nck, int chunk_cols, int cps, int nsplit,
                                int act, void* stream) {
  if (br <= 0 || br % 32 || batch <= 0 || nck <= 0 || cps <= 0 ||
      nsplit != (nck + cps - 1) / cps || chunk_cols != KT ||
      (long)nck * chunk_cols < n_cols || (value_kind == 0 && cents == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* nnz = static_cast<const int*>(row_nnz);
  const int* off = static_cast<const int*>(chunk_off);
  const float* c = static_cast<const float*>(cents);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ACSR_CALL(VT, CT)                                                   \
  return launch_mma<VT, CT>(vals, cols, nnz, off, c, xf, bf, o, p, nb, rmax, \
                            br, n_cols, batch, nck, cps, nsplit, act, s)
  if (col_kind == 0) {
    if (value_kind == 0) ACSR_CALL(uint8_t, int16_t);
    if (value_kind == 1) ACSR_CALL(float, int16_t);
    if (value_kind == 2) ACSR_CALL(__nv_bfloat16, int16_t);
  } else if (col_kind == 1) {
    if (value_kind == 0) ACSR_CALL(uint8_t, int32_t);
    if (value_kind == 1) ACSR_CALL(float, int32_t);
    if (value_kind == 2) ACSR_CALL(__nv_bfloat16, int32_t);
  }
#undef ACSR_CALL
  return (int)cudaErrorInvalidValue;
}

// The gather variant: x of at most 8 columns; the slot axis is split over
// nsplit ranges of slots_per_split slots, sy threads a lane.  part:
// scratch of nsplit * nb * br * batch floats (unused when nsplit == 1).
extern "C" int acsr_spmv_gather_launch(const void* vals, const void* cols,
                                       const void* row_nnz,
                                       const void* cents, const void* x,
                                       const void* bias, void* out,
                                       void* part, int value_kind,
                                       int col_kind, int nb, int rmax, int br,
                                       int sy, int batch, int nsplit,
                                       int slots_per_split, int act,
                                       void* stream) {
  if (br <= 0 || br * sy > 1024 || batch <= 0 || batch > MAXB ||
      nsplit <= 0 || (value_kind == 0 && cents == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* nnz = static_cast<const int*>(row_nnz);
  const float* c = static_cast<const float*>(cents);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ACSR_CALL(VT, CT)                                                    \
  return launch_gather<VT, CT>(vals, cols, nnz, c, xf, bf, o, p, nb, rmax, br, \
                               sy, batch, nsplit, slots_per_split, act, s)
  if (col_kind == 0) {
    if (value_kind == 0) ACSR_CALL(uint8_t, int16_t);
    if (value_kind == 1) ACSR_CALL(float, int16_t);
    if (value_kind == 2) ACSR_CALL(__nv_bfloat16, int16_t);
  } else if (col_kind == 1) {
    if (value_kind == 0) ACSR_CALL(uint8_t, int32_t);
    if (value_kind == 1) ACSR_CALL(float, int32_t);
    if (value_kind == 2) ACSR_CALL(__nv_bfloat16, int32_t);
  }
#undef ACSR_CALL
  return (int)cudaErrorInvalidValue;
}
