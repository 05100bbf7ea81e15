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
//                              column is >= c * 64, derived from col_idx and
//                              row_nnz when the container is made
//   x         [K, B] f32, out [nb*br, B] f32
//
// One sum order a column, at every width.  Both variants compute column j
// of row r the same way, so a column's result never depends on how many
// columns x has (a chunked step and a decode step give the same bits):
//  * The split plan (`split_plan` in kernels/acsr_spmv.py, a function of
//    nb, rmax, br and the SM count only) cuts the slot axis into nsplit
//    ranges of per_split slots and each range into sy interleaved parts:
//    part t of range s holds slots s0 + t, s0 + t + sy, ... below
//    min(s0 + per_split, rmax, row_nnz[r]), s0 = s * per_split.
//  * A part is summed from 0.0f with fmaf(w, x[col, j], acc) in ascending
//    slot order; w is centroids[code] (aida) or the stored value (acsr).
//  * A range's sum is v = 0.0f, then v += part t for t = 0 .. sy - 1; the
//    ranges' sums are added the same way in range order; then the bias,
//    then the activation.
// The plain version (kernels/ref.py) sums in another order and is held
// within 1e-4.
//
// What bounds it.  The bound counts bytes (each live slot's value and
// column once, x and out) and 2 * nnz * B operations at the f32 rate: 0.05
// ms a layer of llama3-8b at B = 4 or 32.  x has no reuse across rows, so
// every multiply-add needs its own x value.  Two variants:
//
// The gather variant (B <= 8, a decode step).  One thread a row part,
// parts threadIdx.y, ranges blockIdx.y.  Each thread loads the entries of
// GATHER_U = 3 slots before it uses any (the code -> column -> x chain is
// dependent; a warp's loads of a slot-row are coalesced), at every width,
// and reads an x row of 4 or 8 columns as 16-byte loads.  It holds 40
// registers, so three blocks fit an SM and the split plan's grid runs in
// one wave.
// The ranges meet in the same launch: the row block's last block to
// finish adds them in range order (an int counter a row block, from
// `build.counters`, reset by it).  Two rings of slot-rows in shared memory
// were timed against these direct loads and lost (PERF.md): 16-byte
// `cp.async` with a block barrier a stage, and `cp.async.bulk` under
// mbarriers with the range's span of x columns copied beside it.
//
// The wide variant (B > 8, a chunked-prefill step).  Rereading x from L2
// per slot would cost 4 B a column, so x is staged in shared memory and
// read from there, on the CUDA cores (the tensor cores sum in an order
// the gather variant cannot follow):
//  * A block owns 32 rows (warp ty = part ty, lane = row) and one slot
//    range, and up to 32 columns of x (wider x loops over 32-column
//    groups, each reading the weights once).  Each thread keeps a
//    register accumulator per column.
//  * The block walks K in tiles of XT = 128 columns, from the tile of the
//    rows' first slot in the range to that of their last; each tile of x
//    ([XT][4 NCH] f32) is copied by `cp.async` into one of two buffers
//    while the other is read.  A row's slots of the tile are the run that
//    ends at its chunk_off entry of the tile's end (ascending columns).
//  * Each slot reads its x row as NCH 16-byte loads.  Rows fall on random
//    columns, so the loads are swizzled by lane: lane l reads chunk
//    q ^ (l % NCH) at step q into accumulator set q, which keeps the eight
//    lanes of a quarter-warp on eight different 16-byte bank groups at
//    every step whatever the rows (at NCH = 8), with no padding.
//  * Lanes reach different slots within a tile, so a lane loading its own
//    slot would scatter each warp load over 32 sectors.  Instead each warp
//    copies its part's whole slot-rows (values and column ids of its 32
//    rows), coalesced, into a ring of E = 64 entries (fewer with more
//    parts) in shared memory one tile ahead, and a lane reads its entry
//    there.  A warp whose tile lies wholly in the ring (nearly always)
//    walks it with no per-slot test; otherwise slots past the ring come
//    from device memory.
//  * What holds it: not shared-memory bandwidth (the floor, 128 B a slot,
//    is ~0.21 ms a llama3-8b layer) and not the x reads (leaving them out
//    saves 13 %), but the walk itself; see PERF.md for the designs timed.
//
// Both variants: dead slots are never visited (a row's walk ends at
// row_nnz, never at a code of 0: a live nonzero may map to centroid 0;
// padding holds code 0, column 0); int16 and int32 column ids are separate
// instantiations, never widened; bias and activation run in the epilogue.
// No atomics: results repeat bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tile.cuh"

namespace {

constexpr int MAXB = 8;            // gather variant: columns at most
constexpr int GATHER_U = 3;        // gather variant: slots with loads in flight
constexpr int CHUNK = 64;          // columns per chunk_off step
constexpr int XT = 2 * CHUNK;      // wide variant: x tile rows (K)
constexpr int XC = XT / CHUNK;     // chunk_off steps a tile
constexpr int RING = 256;          // wide variant: ring entries a block
constexpr int GROUP = 32;          // wide variant: x columns per pass

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

// a slot's weight: its code's centroid (aida) or its stored value (acsr)
template <typename VT>
__device__ __forceinline__ float to_value(VT v, const float* cents) {
  if constexpr (std::is_same<VT, uint8_t>::value)
    return cents[v];
  else if constexpr (std::is_same<VT, float>::value)
    return v;
  else
    return __bfloat162float(v);
}

// A column's partials merged: 0.f plus the nsplit partials at p, p +
// stride, ... in order (four loads in flight), then the bias, then the
// activation.  The gather variant's last block and the wide variant's
// second pass both add their ranges here, in this one order.
__device__ __forceinline__ float merge_column(const float* __restrict__ p,
                                              size_t stride, int nsplit,
                                              const float* __restrict__ bias,
                                              int row, int act) {
  constexpr int U = 4;
  float v = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += U) {
    float b[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      b[u] = s0 + u < nsplit ? __ldcg(p + (s0 + u) * stride) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (s0 + u < nsplit) v += b[u];
  }
  if (bias != nullptr) v += bias[row];
  return activate(v, act);
}

// The gather variant (x <= 8 columns) ------------------------------------
// The row block's ranges, added by its last block.  Kept out of line so
// that its registers do not count against the streaming loop's.
__device__ __noinline__ void merge_ranges(const float* __restrict__ part,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out, int blk,
                                          int br, int nbc, int nrows,
                                          int nsplit, int act, int tid,
                                          int nthreads) {
  const size_t stride = (size_t)nrows * nbc;
  for (int i = tid; i < br * nbc; i += nthreads) {
    const int r = blk * br + i / nbc;
    const size_t o = (size_t)r * nbc + i % nbc;
    out[o] = merge_column(part + o, stride, nsplit, bias, r, act);
  }
}

// x row c's NB columns into v: 16-byte loads when x has exactly NB
// columns (EXACT, NB a multiple of 4), else one load a column below nbc
// (row stride nbc).
template <int NB, bool EXACT>
__device__ __forceinline__ void load_row(float (&v)[NB],
                                         const float* __restrict__ x, int c,
                                         int nbc) {
  if constexpr (EXACT && NB % 4 == 0) {
    const float4* xr =
        reinterpret_cast<const float4*>(x) + (size_t)c * (NB / 4);
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      const float4 t = __ldg(xr + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
    const float* xr = x + (size_t)c * nbc;
#pragma unroll
    for (int j = 0; j < NB; ++j) v[j] = EXACT || j < nbc ? __ldg(xr + j) : 0.f;
  }
}

// One thread's part: acc[j] = fmaf(w, x[col, j], acc[j]) over the live
// slots s, s + sy, ... below s1 in order, for x's columns: exactly NB of
// them (EXACT), or nbc < NB.  The code and column loads of GATHER_U slots
// are issued before any is used (the code -> column -> x chain is
// dependent), then their x rows, XU rows at a time before their FMAs (all
// GATHER_U up to 4 columns; one at a time wider, as 40 registers hold no
// more).
template <int NB, bool EXACT, typename VT, typename CT>
__device__ __forceinline__ void sum_part(float (&acc)[MAXB],
                                         const VT* __restrict__ vals,
                                         const CT* __restrict__ cols,
                                         const float* cents,
                                         const float* __restrict__ x,
                                         int nbc, size_t base, int br, int s,
                                         int s1, int sy) {
  constexpr int XU = NB <= 4 ? GATHER_U : 1;
  for (; s + (GATHER_U - 1) * sy < s1; s += GATHER_U * sy) {
    float w[GATHER_U];
    int c[GATHER_U];
#pragma unroll
    for (int u = 0; u < GATHER_U; ++u) {
      const size_t idx = base + (size_t)(s + u * sy) * br;
      w[u] = to_value<VT>(vals[idx], cents);
      c[u] = (int)cols[idx];
    }
#pragma unroll
    for (int u0 = 0; u0 < GATHER_U; u0 += XU) {
      float xv[XU][NB];
#pragma unroll
      for (int u = 0; u < XU; ++u)
        load_row<NB, EXACT>(xv[u], x, c[u0 + u], nbc);
#pragma unroll
      for (int u = 0; u < XU; ++u)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (EXACT || j < nbc) acc[j] = fmaf(w[u0 + u], xv[u][j], acc[j]);
    }
  }
  for (; s < s1; s += sy) {
    const size_t idx = base + (size_t)s * br;
    const float w = to_value<VT>(vals[idx], cents);
    float xv[NB];
    load_row<NB, EXACT>(xv, x, (int)cols[idx], nbc);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (EXACT || j < nbc) acc[j] = fmaf(w, xv[j], acc[j]);
  }
}

// grid (nb, nsplit), block (br, sy): thread (lane, ty) sums part ty of its
// row's slot range, the live slots s0 + ty, s0 + ty + sy, ... below s1, for
// the nbc (<= MAXB) columns of x.  A warp's loads of one slot-row are
// coalesced (its 32 rows' entries are adjacent).  The parts are added
// through shared memory in part order.  With more than one range, each
// block writes its range's sums to `part`, and the row block's last block
// to finish (an int counter a row block, reset by it) adds the ranges in
// range order, then the bias and the activation.  At most 40 registers a
// thread, so three blocks fit an SM and the split plan's grid (about two
// blocks an SM) runs in one wave.
template <typename VT, typename CT>
__global__ void __launch_bounds__(512, 3)
    spmv_gather(const VT* __restrict__ vals, const CT* __restrict__ cols,
                const int* __restrict__ row_nnz,
                const float* __restrict__ cents, const float* __restrict__ x,
                int nbc, int rmax, int slots_per_split,
                const float* __restrict__ bias, int act,
                float* __restrict__ out, float* __restrict__ part,
                int* __restrict__ cnt) {
  extern __shared__ float red[];  // the parts' sums [sy][br][nbc]
  __shared__ float s_cents[16];
  __shared__ int s_last;
  const int br = blockDim.x, sy = blockDim.y;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * br + lane, nthreads = br * sy;
  const int blk = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int nrows = gridDim.x * br;
  const int row = blk * br + lane;
  const int s0 = split * slots_per_split;
  const int s1 = min(min(s0 + slots_per_split, rmax), row_nnz[row]);
  if (cents != nullptr && tid < 16) s_cents[tid] = cents[tid];
  __syncthreads();

  float acc[MAXB];
#pragma unroll
  for (int j = 0; j < MAXB; ++j) acc[j] = 0.f;
  const size_t base = (size_t)blk * rmax * br + lane;  // slot 0 of the row
  // x of 1, 4 or 8 columns (a decode step of 1, 4 or 8 slots) takes its
  // own loop; other widths the loop for up to MAXB
#define SUM_PART(NB, EXACT)                                                 \
  sum_part<NB, EXACT>(acc, vals, cols, s_cents, x, nbc, base, br, s0 + ty, \
                      s1, sy)
  if (nbc == 4)
    SUM_PART(4, true);
  else if (nbc == 1)
    SUM_PART(1, true);
  else if (nbc == MAXB)
    SUM_PART(MAXB, true);
  else
    SUM_PART(MAXB, false);
#undef SUM_PART

#pragma unroll
  for (int j = 0; j < MAXB; ++j)
    if (j < nbc) red[(ty * br + lane) * nbc + j] = acc[j];
  __syncthreads();
  if (ty == 0)
    for (int j = 0; j < nbc; ++j) {
      float v = 0.f;
      for (int t = 0; t < sy; ++t) v += red[(t * br + lane) * nbc + j];
      if (nsplit == 1) {
        if (bias != nullptr) v += bias[row];
        out[(size_t)row * nbc + j] = activate(v, act);
      } else {
        part[((size_t)split * nrows + row) * nbc + j] = v;
      }
    }
  if (nsplit == 1) return;

  // The row block's last block to finish adds the ranges in range order.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(cnt + blk, 1) == nsplit - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  merge_ranges(part, bias, out, blk, br, nbc, nrows, nsplit, act, tid,
               nthreads);
  if (tid == 0) cnt[blk] = 0;
}

// The wide variant (x > 8 columns) ---------------------------------------
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   mt::smem_addr(dst)),
               "l"(src));
}

// x rows [k0, k0 + XT) below n_cols, columns [j0, j0 + nbc), into the
// tile [XT][NC]: 16-byte pieces when `vec` (x rows and j0 16-byte
// aligned; a last piece may carry columns past nbc, which no result
// reads), else 4-byte ones.  Positions past n_cols or nbc are left as
// they are: no slot reads them.
template <int NC>
__device__ __forceinline__ void stage_x(float* tile,
                                        const float* __restrict__ x, int ldx,
                                        int j0, int nbc, int n_cols, int k0,
                                        bool vec, int tid, int nthreads) {
  if (vec) {
    constexpr int P = NC / 4;  // pieces a row
    for (int i = tid; i < XT * P; i += nthreads) {
      const int r = i / P, c = 4 * (i % P);
      if (k0 + r < n_cols && c < nbc)
        mt::cp_async16(tile + r * NC + c, x + (size_t)(k0 + r) * ldx + j0 + c);
    }
  } else {
    for (int i = tid; i < XT * NC; i += nthreads) {
      const int r = i / NC, c = i % NC;
      if (k0 + r < n_cols && c < nbc)
        cp_async4(tile + r * NC + c, x + (size_t)(k0 + r) * ldx + j0 + c);
    }
  }
}

// grid (nb * br / 32, nsplit), block (32, sy): thread (lane, ty) sums part
// ty of its row's slot range for columns [j0, j0 + nbc) of x, NC = 4 * NCH
// >= nbc, into acc[q][e] = column 4 (q ^ (lane % NCH)) + e.
//
// Warp ty walks the slot-rows of part ty (slots s0 + ty + k sy: entry k),
// each holding its 32 rows' values and column ids.  Its lanes advance at
// their own pace (a row's slots of a tile vary in number), so rather than
// each lane loading its own slot (32 scattered sectors a load), the warp
// copies whole slot-rows, coalesced, into its ring of E entries in shared
// memory, one tile ahead; a lane reads its entry there.  A slot-row past
// what the ring could take (lanes spread wider than E) is read from
// device memory.  Per tile t, one barrier: x's tile t and the rings'
// entries for it have landed, and every thread is done with tile t - 1,
// whose buffer then takes tile t + 1.
template <typename VT, typename CT, int NCH>
__global__ void __launch_bounds__(512)
    spmv_wide(const VT* __restrict__ vals, const CT* __restrict__ cols,
              const int* __restrict__ row_nnz,
              const int* __restrict__ chunk_off,
              const float* __restrict__ cents, const float* __restrict__ x,
              int ldx, int j0, int nbc, int rmax, int br, int n_cols, int nck,
              int slots_per_split, int nsplit, bool vec, int E,
              const float* __restrict__ bias, int act,
              float* __restrict__ out, int ldo, float* __restrict__ part) {
  constexpr int NC = 4 * NCH;
  constexpr int PV = 32 * sizeof(VT) / 16, PC = 32 * sizeof(CT) / 16;
  // 2 x [XT][NC] x tiles, then the warps' rings [sy][E][32] of values and
  // of column ids; the parts' sums reuse it all at the end
  extern __shared__ __align__(16) float sm[];
  __shared__ float s_cents[16];
  const int lane = threadIdx.x, ty = threadIdx.y, sy = blockDim.y;
  const int tid = ty * 32 + lane, nthreads = 32 * sy;
  const int split = blockIdx.y;
  const int nrows = gridDim.x * 32;
  const int row = blockIdx.x * 32 + lane;
  const int blk = row / br, ln = row % br;
  VT* ring_v = reinterpret_cast<VT*>(sm + 2 * XT * NC) + ty * E * 32;
  CT* ring_c = reinterpret_cast<CT*>(reinterpret_cast<VT*>(
                   sm + 2 * XT * NC) + sy * E * 32) + ty * E * 32;
  if (cents != nullptr && tid < 16) s_cents[tid] = cents[tid];

  const int nnz = row_nnz[row];
  const int s0 = split * slots_per_split;
  const int s_top = min(s0 + slots_per_split, rmax);
  const int s1 = min(s_top, nnz);
  const size_t base = (size_t)blk * rmax * br + ln;
  const size_t wbase = base - lane;  // the warp's slot-rows start here
  const int* off = chunk_off + (size_t)blk * (nck + 1) * br + ln;
  // the x tiles the block's rows reach in this range: from the tile of
  // their first slot to that of their last (every warp holds the same
  // rows, so each finds the same range without shared memory)
  int first = INT_MAX, last = -1;
  if (s0 < s1) {
    first = (int)cols[base + (size_t)s0 * br] / XT;
    last = (int)cols[base + (size_t)(s1 - 1) * br] / XT;
  }
  const int t_lo = __reduce_min_sync(~0u, first);
  const int t_hi = __reduce_max_sync(~0u, last);
  // this lane's entries below slot `end`, and the entries of part ty that
  // exist at all
  auto entries = [&](int end) {
    const int lim = min(end, s1) - (s0 + ty);
    return lim > 0 ? (lim + sy - 1) / sy : 0;
  };
  const int k_top = max(0, (s_top - (s0 + ty) + sy - 1) / sy);
  // copy entries [fill, min(k_need, k_low + E)) into the warp's ring
  int fill = 0;
  auto copy = [&](int k_need, int k_low) {
    const int to = min(min(k_need, k_low + E), k_top);
    for (int i = lane; i < (to - fill) * (PV + PC); i += 32) {
      const int k = fill + i / (PV + PC), piece = i % (PV + PC);
      const size_t slot_row = wbase + (size_t)(s0 + ty + k * sy) * br;
      const int at = (k & (E - 1)) * 32;
      if (piece < PV)
        mt::cp_async16(ring_v + at + piece * (16 / sizeof(VT)),
                       vals + slot_row + piece * (16 / sizeof(VT)));
      else
        mt::cp_async16(ring_c + at + (piece - PV) * (16 / sizeof(CT)),
                       cols + slot_row + (piece - PV) * (16 / sizeof(CT)));
    }
    fill = max(fill, to);
  };

  float acc[NCH][4];
#pragma unroll
  for (int q = 0; q < NCH; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  // step q reads chunk q ^ rot of an x row: the lanes of a quarter-warp
  // read eight different 16-byte bank groups whatever their rows
  const int rot = lane % NCH;
  float* tiles = sm;
  int s = s0 + ty, k = 0;  // this lane's next slot and its entry
  // slot k's weight and the float index of its x row's chunk rot, from
  // the ring or (RING false) from device memory
  auto fetch = [&](auto ring, int kk, int ss, int k0, float& w, int& xi) {
    VT v;
    int c;
    if constexpr (decltype(ring)::value) {
      const int at = (kk & (E - 1)) * 32 + lane;
      v = ring_v[at];
      c = (int)ring_c[at];
    } else {
      v = vals[base + (size_t)ss * br];
      c = (int)cols[base + (size_t)ss * br];
    }
    w = to_value<VT>(v, s_cents);
    xi = (c - k0) * NC + 4 * rot;  // rows start at multiples of NC
  };
  auto fma_row = [&](const float* tile, float w, int xi) {
#pragma unroll
    for (int q = 0; q < NCH; ++q) {
      const float4 xv =
          *reinterpret_cast<const float4*>(tile + (xi ^ (4 * q)));
      acc[q][0] = fmaf(w, xv.x, acc[q][0]);
      acc[q][1] = fmaf(w, xv.y, acc[q][1]);
      acc[q][2] = fmaf(w, xv.z, acc[q][2]);
      acc[q][3] = fmaf(w, xv.w, acc[q][3]);
    }
  };
  // this lane's slots below e of the tile at k0, two a step: from the
  // ring alone when the whole warp's are there (the common case: no
  // per-slot test), else slot by slot from the ring or device memory
  auto walk = [&](const float* tile, int k0, int e, int landed) {
    if (__all_sync(~0u, entries(e) <= landed)) {
      const std::true_type ring;
      for (; s + sy < e; s += 2 * sy, k += 2) {
        float w0, w1;
        int x0, x1;
        fetch(ring, k, s, k0, w0, x0);
        fetch(ring, k + 1, s + sy, k0, w1, x1);
        fma_row(tile, w0, x0);
        fma_row(tile, w1, x1);
      }
      if (s < e) {
        float w0;
        int x0;
        fetch(ring, k, s, k0, w0, x0);
        fma_row(tile, w0, x0);
        s += sy;
        ++k;
      }
    } else {
      for (; s < e; s += sy, ++k) {
        float w0;
        int x0;
        if (k < landed)
          fetch(std::true_type(), k, s, k0, w0, x0);
        else
          fetch(std::false_type(), k, s, k0, w0, x0);
        fma_row(tile, w0, x0);
      }
    }
  };
  // this row's ends (first slot past the tile) of tiles t and t + 1
  int e_cur = 0, e_nxt = 0;
  if (t_lo <= t_hi) {
    e_cur = off[(size_t)min((t_lo + 1) * XC, nck) * br];
    if (t_lo < t_hi) e_nxt = off[(size_t)min((t_lo + 2) * XC, nck) * br];
    stage_x<NC>(tiles, x, ldx, j0, nbc, n_cols, t_lo * XT, vec, tid,
                nthreads);
    copy(__reduce_max_sync(~0u, entries(e_cur)), 0);
  }
  mt::cp_commit();
  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    int e_nn = 0;  // tile t + 2's end, for the next step's copies
    if (t + 1 < t_hi) e_nn = off[(size_t)min((t + 3) * XC, nck) * br];
    const int landed = fill;  // entries below it are in the ring now
    mt::cp_wait<0>();
    __syncthreads();
    if (t < t_hi) {
      stage_x<NC>(tiles + (buf ^ 1) * XT * NC, x, ldx, j0, nbc, n_cols,
                  (t + 1) * XT, vec, tid, nthreads);
      const int k_low = __reduce_min_sync(~0u, s < s1 ? k : INT_MAX);
      const int k_need = __reduce_max_sync(~0u, entries(e_nxt));
      if (k_low != INT_MAX) copy(k_need, k_low);
    }
    mt::cp_commit();
    walk(tiles + buf * XT * NC, t * XT, min(e_cur, s1), landed);
    e_cur = e_nxt;
    e_nxt = e_nn;
  }
  mt::cp_wait<0>();
  __syncthreads();

  // the parts through shared memory ([sy][32][NC], columns in order), then
  // the part-0 warp sums them in part order
  float* red = sm;
#pragma unroll
  for (int q = 0; q < NCH; ++q)
    *reinterpret_cast<float4*>(red + (size_t)tid * NC + 4 * (q ^ rot)) =
        make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
  __syncthreads();
  if (ty != 0) return;
#pragma unroll
  for (int q = 0; q < NCH; ++q) {
    const int c0 = 4 * (q ^ rot);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < sy; ++t) {
      const float4 p = *reinterpret_cast<const float4*>(
          red + (size_t)(t * 32 + lane) * NC + c0);
      v[0] += p.x;
      v[1] += p.y;
      v[2] += p.z;
      v[3] += p.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c0 + e >= nbc) continue;
      if (nsplit == 1) {
        float y = v[e];
        if (bias != nullptr) y += bias[row];
        out[(size_t)row * ldo + j0 + c0 + e] = activate(y, act);
      } else {
        part[((size_t)split * nrows + row) * nbc + c0 + e] = v[e];
      }
    }
  }
}

// The wide variant's second pass: each column's nsplit partials merged.
__global__ void spmv_finalize(const float* __restrict__ part, int nsplit,
                              int nrows, int nbc,
                              const float* __restrict__ bias, int act,
                              float* __restrict__ out, int ldo, int j0) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nrows * nbc) return;
  const int row = i / nbc, j = i % nbc;
  out[(size_t)row * ldo + j0 + j] =
      merge_column(part + i, (size_t)nrows * nbc, nsplit, bias, row, act);
}

void finalize(const float* part, int nsplit, int nrows, int nbc,
              const float* bias, int act, float* out, int ldo, int j0,
              cudaStream_t stream) {
  const int n = nrows * nbc, threads = 256;
  spmv_finalize<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      part, nsplit, nrows, nbc, bias, act, out, ldo, j0);
}

template <typename VT, typename CT>
int launch_gather(const void* vals, const void* cols, const int* row_nnz,
                  const float* cents, const float* x, const float* bias,
                  float* out, float* part, int* cnt, int nb, int rmax, int br,
                  int sy, int batch, int nsplit, int slots_per_split,
                  int act, cudaStream_t stream) {
  const size_t smem = (size_t)sy * br * batch * sizeof(float);
  const dim3 grid(nb, nsplit), block(br, sy);
  spmv_gather<VT, CT><<<grid, block, smem, stream>>>(
      static_cast<const VT*>(vals), static_cast<const CT*>(cols), row_nnz,
      cents, x, batch, rmax, slots_per_split, bias, act, out, part, cnt);
  return (int)cudaGetLastError();
}

template <typename VT, typename CT, int NCH>
int launch_wide_group(const void* vals, const void* cols, const int* row_nnz,
                      const int* chunk_off, const float* cents,
                      const float* x, const float* bias, float* out,
                      float* part, int nb, int rmax, int br, int sy,
                      int n_cols, int batch, int j0, int nbc, int nck,
                      int nsplit, int slots_per_split, int act,
                      cudaStream_t stream) {
  constexpr int NC = 4 * NCH;
  // a warp's ring: RING / sy entries, at most 64 (a power of two)
  int E = 64;
  while (E > 16 && E * sy > RING) E /= 2;
  const size_t tiles = 2 * (size_t)XT * NC * sizeof(float) +
                       (size_t)sy * E * 32 * (sizeof(VT) + sizeof(CT));
  const size_t red = (size_t)sy * 32 * NC * sizeof(float);
  const size_t smem = tiles > red ? tiles : red;
  auto kern = spmv_wide<VT, CT, NCH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = batch % 4 == 0 && j0 % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int nrows = nb * br;
  const dim3 grid(nrows / 32, nsplit), block(32, sy);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const VT*>(vals), static_cast<const CT*>(cols), row_nnz,
      chunk_off, cents, x, batch, j0, nbc, rmax, br, n_cols, nck,
      slots_per_split, nsplit, vec, E, bias, act, out, batch, part);
  if (nsplit > 1)
    finalize(part, nsplit, nrows, nbc, bias, act, out, batch, j0, stream);
  return (int)cudaGetLastError();
}

template <typename VT, typename CT>
int launch_wide(const void* vals, const void* cols, const int* row_nnz,
                const int* chunk_off, const float* cents, const float* x,
                const float* bias, float* out, float* part, int nb, int rmax,
                int br, int sy, int n_cols, int batch, int nck, int nsplit,
                int slots_per_split, int act, cudaStream_t stream) {
  for (int j0 = 0; j0 < batch; j0 += GROUP) {
    const int nbc = batch - j0 < GROUP ? batch - j0 : GROUP;
#define WIDE_CALL(NCH_)                                                      \
  launch_wide_group<VT, CT, NCH_>(vals, cols, row_nnz, chunk_off, cents, x, \
                                  bias, out, part, nb, rmax, br, sy, n_cols, \
                                  batch, j0, nbc, nck, nsplit,               \
                                  slots_per_split, act, stream)
    const int err = nbc <= 8 ? WIDE_CALL(2) : nbc <= 16 ? WIDE_CALL(4)
                                                       : WIDE_CALL(8);
#undef WIDE_CALL
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// value_kind: 0 = uint8 codes (needs cents), 1 = f32, 2 = bf16.
// col_kind:   0 = int16, 1 = int32.
// Both launchers take the split plan (sy, nsplit, slots_per_split) of
// `split_plan`; part: scratch of nsplit * nb * br * min(batch, 8) floats
// (gather) or min(batch, 32) (wide), unused when nsplit == 1.  Each
// returns the cudaError_t of its launches.
#define ACSR_DISPATCH(CALL)                             \
  if (col_kind == 0) {                                  \
    if (value_kind == 0) return CALL(uint8_t, int16_t); \
    if (value_kind == 1) return CALL(float, int16_t);   \
    if (value_kind == 2) return CALL(__nv_bfloat16, int16_t); \
  } else if (col_kind == 1) {                           \
    if (value_kind == 0) return CALL(uint8_t, int32_t); \
    if (value_kind == 1) return CALL(float, int32_t);   \
    if (value_kind == 2) return CALL(__nv_bfloat16, int32_t); \
  }                                                     \
  return (int)cudaErrorInvalidValue

// The wide variant: x of more than 8 columns; chunk_off's steps are 64
// columns (chunk_cols must be 64).
extern "C" int acsr_spmv_wide_launch(const void* vals, const void* cols,
                                     const void* row_nnz,
                                     const void* chunk_off, const void* cents,
                                     const void* x, const void* bias,
                                     void* out, void* part, int value_kind,
                                     int col_kind, int nb, int rmax, int br,
                                     int sy, int n_cols, int batch, int nck,
                                     int chunk_cols, int nsplit,
                                     int slots_per_split, int act,
                                     void* stream) {
  if (br <= 0 || br % 32 || sy <= 0 || 32 * sy > 512 || batch <= 0 ||
      nck <= 0 || chunk_cols != CHUNK || (long)nck * chunk_cols < n_cols ||
      nsplit <= 0 || slots_per_split <= 0 ||
      (value_kind == 0 && cents == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* nnz = static_cast<const int*>(row_nnz);
  const int* off = static_cast<const int*>(chunk_off);
  const float* c = static_cast<const float*>(cents);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ACSR_CALL(VT, CT)                                                    \
  launch_wide<VT, CT>(vals, cols, nnz, off, c, xf, bf, o, p, nb, rmax, br,  \
                      sy, n_cols, batch, nck, nsplit, slots_per_split, act, \
                      s)
  ACSR_DISPATCH(ACSR_CALL);
#undef ACSR_CALL
}

// The gather variant: x [n_cols, batch] of at most 8 columns, 16-byte
// aligned; when nsplit > 1, part is scratch of nsplit * nb * br * batch
// floats and cnt holds nb int counters, zero and left zero.  One launch.
extern "C" int acsr_spmv_gather_launch(const void* vals, const void* cols,
                                       const void* row_nnz,
                                       const void* cents, const void* x,
                                       const void* bias, void* out,
                                       void* part, void* cnt, int value_kind,
                                       int col_kind, int nb, int rmax, int br,
                                       int sy, int batch, int nsplit,
                                       int slots_per_split, int act,
                                       void* stream) {
  if (br <= 0 || br % 32 || sy <= 0 || br * sy > 512 || batch <= 0 ||
      batch > MAXB || nsplit <= 0 || slots_per_split <= 0 ||
      (long)(nsplit - 1) * slots_per_split >= rmax ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      (value_kind == 0 && cents == nullptr) ||
      (nsplit > 1 && (part == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* nnz = static_cast<const int*>(row_nnz);
  const float* c = static_cast<const float*>(cents);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  int* k = static_cast<int*>(cnt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ACSR_CALL(VT, CT)                                                   \
  launch_gather<VT, CT>(vals, cols, nnz, c, xf, bf, o, p, k, nb, rmax, br,  \
                        sy, batch, nsplit, slots_per_split, act, s)
  ACSR_DISPATCH(ACSR_CALL);
#undef ACSR_CALL
}
