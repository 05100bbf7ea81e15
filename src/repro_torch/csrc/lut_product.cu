// Fully-coded FC for Hopper (K6): both operands are 4-bit codes and every
// multiply is a look-up in an nc x nc product table (AIDA's perfect
// induction):
//
//   out[b, n] = sum_{k < K} lut[w[n, k] * nc + x[b, k]]
//
// Replaces the TPU kernel `_lut_product_kernel` of
// src/repro/kernels/lut_matmul.py (launched by `lut_product_matmul`).
//
//   x     [B, K]    uint8 codes < nc      codes [N, K/2]  uint8, code 2j in
//   lut   [nc, nc]  f32, nc <= 16                          the low nibble
//   out   [B, N]    f32
//
// The arithmetic (kernels/ref.py's plain version repeats it bit for bit):
//  * s = 29 - e, where max |lut| = f * 2^e with f in [0.5, 1) (frexp), and
//    the table is scaled by 2^s (exact), so every entry is below 2^29.
//  * Weight byte j of row n and x row b give the pair
//    p = lut'[w_lo, x[b, 2j]] + lut'[w_hi, x[b, 2j + 1]] (one f32 add).
//  * Each run of four bytes j = 4q .. 4q + 3 (bytes past K/2 give 0) is
//    added in f32, ((p0 + p1) + p2) + p3, and rounded to the nearest
//    integer (ties to even) as an int64: the run is below 2^32.
//  * The runs are added in int64, which is exact, so their order is
//    immaterial: a rerun, any split of K and any grouping of x rows give
//    the same bits.  out = float(total) * 2^-s.
// The f32 roundings are those of the pair and run adds; the int64 step
// keeps 2^-30 of max |lut| (an integer table is exact).
//
// What bounds it: one f32 addition a weight byte and x row (B * N * K / 2
// of them) at B >= ~8, the bytes (half a byte a weight) below that.  On
// the card the look-ups are shared-memory loads, 32 a clock an SM.
//
// Design: pair tables.  For a run of four bytes and up to 32 x rows, the
// block builds in shared memory the 256 pair sums of every (x row, byte
// position): 4 tables [256 byte values][32 lanes] of f32, 128 KB.  Lane
// l = g * BP + b of a warp (BP = x rows rounded up to 4, 8, 16 or 32; G =
// 32 / BP) stands for x row b and the run of bytes 4 (h G + g) .. + 3 of a
// 32-byte step, h = 0 .. BP / 4 - 1 one table build each.  A lane reads
// entry [byte][l]: bank l whatever the bytes, so every look-up is
// conflict-free and costs no index arithmetic but one byte permute (the
// table row is 256 bytes, so `prmt` of the weight byte and the lane's
// offset is the address).  A warp walks ROWS output rows with one int64
// sum a row in registers; 16 warps share each table (512 rows a block),
// which pays for its build.  The weight bytes of a step ([512 rows][32
// bytes]) and the x codes the tables need ([32 rows][64 codes]) come by
// `cp.async` into one of two tiles while the other is read.  K is split over blocks in whole steps when the row tiles alone
// leave SMs idle; the splits' int64 sums meet by integer atomics in a
// scratch kept at zero (`build.counters`), and the tile's last block
// converts them to f32 and zeroes the scratch: one launch a call.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int THREADS = 512;            // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 32;                // output rows a warp
constexpr int NBLK = WARPS * ROWS;      // output rows a block
constexpr int STEP = 32;                // weight bytes a step (64 codes)
constexpr int XROWS = 32;               // x rows a block at most
constexpr int TABLE = 4 * 256 * 32 * 4;  // four pair tables, bytes
constexpr int XTILE = XROWS * 2 * STEP;  // x codes of a step, bytes
constexpr int TILE = NBLK * STEP + XTILE;  // weight and x tile, bytes
constexpr int SMEM = TABLE + 2 * TILE + 256 * 4;
constexpr int HQ = THREADS / 128;       // threads building a run byte and lane
constexpr int HPER = 16 / HQ;           // high codes a building thread
static_assert(THREADS % 128 == 0 && 16 % HQ == 0, "table build split");

// lut' transposed, [x code][w code], staged once; entries past nc are 0
__device__ __forceinline__ void stage_lut(float* lut_t,
                                          const float* __restrict__ lut,
                                          int nc, int shift, int tid) {
  for (int i = tid; i < 256; i += THREADS) {
    const int xc = i >> 4, wc = i & 15;
    lut_t[i] = xc < nc && wc < nc ? ldexpf(lut[wc * nc + xc], shift) : 0.f;
  }
}

// a step's tile: the weight bytes [c0, c0 + STEP) of rows n0 .. n0 +
// NBLK - 1, then the x codes [2 c0, 2 c0 + 2 STEP) of x rows b0 .. b0 + bt
// - 1 ([XROWS][2 STEP]); zeros past N, kb and K.  16-byte copies when
// every row is 16-byte aligned (kb % 16 == 0), else byte by byte.
__device__ __forceinline__ void load_tile(uint8_t* wt,
                                          const uint8_t* __restrict__ codes,
                                          const uint8_t* __restrict__ x,
                                          int n0, int N, int b0, int bt,
                                          int kb, int c0, bool vec, int tid) {
  uint8_t* xt = wt + NBLK * STEP;
  const int K = 2 * kb;
  if (vec) {
    for (int i = tid; i < NBLK * 2; i += THREADS) {
      const int r = i >> 1, c = c0 + 16 * (i & 1);
      const bool ok = n0 + r < N && c < kb;
      mt::cp_async16_zfill(wt + r * STEP + 16 * (i & 1),
                           ok ? codes + (size_t)(n0 + r) * kb + c : codes,
                           ok);
    }
    for (int i = tid; i < XROWS * 4; i += THREADS) {
      const int r = i >> 2, c = 2 * c0 + 16 * (i & 3);
      const bool ok = r < bt && c < K;
      mt::cp_async16_zfill(xt + r * 2 * STEP + 16 * (i & 3),
                           ok ? x + (size_t)(b0 + r) * K + c : x, ok);
    }
  } else {
    for (int i = tid; i < NBLK * STEP; i += THREADS) {
      const int r = i / STEP, c = c0 + i % STEP;
      wt[i] = n0 + r < N && c < kb ? codes[(size_t)(n0 + r) * kb + c] : 0;
    }
    for (int i = tid; i < XTILE; i += THREADS) {
      const int r = i / (2 * STEP), c = 2 * c0 + i % (2 * STEP);
      xt[i] = r < bt && c < K ? x[(size_t)(b0 + r) * K + c] : 0;
    }
  }
}

// grid (row tiles, K splits, x row groups of 32), THREADS threads.
template <int BP>
__global__ void __launch_bounds__(THREADS, 1)
    lut_product_kernel(const uint8_t* __restrict__ x,
                       const uint8_t* __restrict__ codes,
                       const float* __restrict__ lut, float* __restrict__ out,
                       unsigned long long* __restrict__ sums,
                       int* __restrict__ cnt, int B, int N, int K, int nc,
                       int steps_per_split) {
  constexpr int G = 32 / BP;  // runs a warp covers per table build
  constexpr int H = BP / 4;   // table builds a step
  extern __shared__ __align__(16) unsigned char sm[];
  unsigned char* tables = sm;
  uint8_t* tiles = sm + TABLE;
  float* lut_t = reinterpret_cast<float*>(sm + TABLE + 2 * TILE);
  __shared__ int s_shift, s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * NBLK, b0 = blockIdx.z * XROWS;
  const int bt = min(XROWS, B - b0);
  const int kb = K / 2;
  const int steps = (kb + STEP - 1) / STEP;
  const int st_lo = blockIdx.y * steps_per_split;
  const int st_hi = min(steps, st_lo + steps_per_split);
  const bool vec = kb % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(codes) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  if (warp == 0) {  // the scale: 2^(29 - e), max |lut| = f 2^e
    float m = 0.f;
    for (int i = lane; i < nc * nc; i += 32) m = fmaxf(m, fabsf(lut[i]));
    m = __uint_as_float(__reduce_max_sync(~0u, __float_as_uint(m)));
    int e;
    frexpf(m, &e);
    if (lane == 0) s_shift = 29 - e;
  }
  if (st_lo < st_hi)
    load_tile(tiles, codes, x, n0, N, b0, bt, kb, st_lo * STEP, vec, tid);
  mt::cp_commit();
  __syncthreads();
  const int shift = s_shift;
  stage_lut(lut_t, lut, nc, shift, tid);
  __syncthreads();

  // build: thread (lane l, run byte t, high-code group hq) writes entries
  // [t][16 hi + lo][l] for the HPER codes hi of its group, every lo
  const int bl = lane % BP, gl = lane / BP;
  const int t_b = (tid >> 5) & 3, hq = tid >> 7;
  const bool row_live = bl < bt;
  float* tb = reinterpret_cast<float*>(tables + (t_b >> 1) * 65536 +
                                       (t_b & 1) * 128) + lane;
  // look-up: the byte permute's second operand holds the lane's offset
  const uint32_t lane_off = lane * 4;
  const unsigned char* tl = tables;

  long long acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0;

  for (int st = st_lo; st < st_hi; ++st) {
    const int buf = (st - st_lo) & 1;
    if (st + 1 < st_hi)
      load_tile(tiles + (buf ^ 1) * TILE, codes, x, n0, N, b0, bt, kb,
                (st + 1) * STEP, vec, tid);
    mt::cp_commit();
    const uint32_t* wt =
        reinterpret_cast<const uint32_t*>(tiles + buf * TILE) +
        warp * ROWS * (STEP / 4);
    // the x row this thread builds tables for, in the step's x codes
    const uint8_t* xrow = tiles + buf * TILE + NBLK * STEP + bl * 2 * STEP;
#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      if (h == 0) {  // this step's tile is in
        mt::cp_wait<1>();
        __syncthreads();
      }
      {  // the tables of runs h G .. h G + G - 1 of this step
        const int jj = 4 * (h * G + gl) + t_b;  // byte position in the step
        const int j = st * STEP + jj;
        float a[16], bv[HPER];
        if (row_live && j < kb) {
          const float4* ra =
              reinterpret_cast<const float4*>(lut_t + 16 * xrow[2 * jj]);
          const float* rb = lut_t + 16 * xrow[2 * jj + 1] + HPER * hq;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = ra[q];
            a[4 * q] = v.x, a[4 * q + 1] = v.y, a[4 * q + 2] = v.z,
            a[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int q = 0; q < HPER; ++q) bv[q] = rb[q];
        } else {
#pragma unroll
          for (int q = 0; q < 16; ++q) a[q] = 0.f;
#pragma unroll
          for (int q = 0; q < HPER; ++q) bv[q] = 0.f;
        }
#pragma unroll
        for (int hi = 0; hi < HPER; ++hi)
#pragma unroll
          for (int lo = 0; lo < 16; ++lo)
            tb[(16 * (HPER * hq + hi) + lo) * 64] = a[lo] + bv[hi];
      }
      __syncthreads();
      const int word = h * G + gl;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const uint32_t w = wt[i * (STEP / 4) + word];
        // address of entry [byte t][lane]: byte t * 256 + lane * 4
        const float p0 =
            *reinterpret_cast<const float*>(tl + __byte_perm(w, lane_off,
                                                             0x5504));
        const float p1 = *reinterpret_cast<const float*>(
            tl + 128 + __byte_perm(w, lane_off, 0x5514));
        const float p2 = *reinterpret_cast<const float*>(
            tl + 65536 + __byte_perm(w, lane_off, 0x5524));
        const float p3 = *reinterpret_cast<const float*>(
            tl + 65536 + 128 + __byte_perm(w, lane_off, 0x5534));
        float r = p0 + p1;
        r += p2;
        r += p3;
        acc[i] += __float2ll_rn(r);
      }
      __syncthreads();  // the tables are rebuilt next
    }
  }
  mt::cp_wait<0>();

  // the G lanes of an x row add their sums (integers: any order)
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int o = BP; o < 32; o *= 2)
      acc[i] += __shfl_down_sync(~0u, acc[i], o);
  const int nsplit = gridDim.y;
  const int b = b0 + lane;
  if (nsplit == 1) {
    if (lane < bt)
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int n = n0 + warp * ROWS + i;
        if (n < N)
          out[(size_t)b * N + n] = ldexpf(__ll2float_rn(acc[i]), -shift);
      }
    return;
  }
  // sums [N][B]: a warp's lanes add to one row's consecutive entries
  if (lane < bt)
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int n = n0 + warp * ROWS + i;
      if (n < N)
        atomicAdd(sums + (size_t)n * B + b,
                  static_cast<unsigned long long>(acc[i]));
    }
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(cnt + tile, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = tid; e < NBLK * bt; e += THREADS) {
    const int n = n0 + e / bt, bb = b0 + e % bt;
    if (n >= N) continue;
    unsigned long long* p = sums + (size_t)n * B + bb;
    const long long v = static_cast<long long>(__ldcg(p));
    *p = 0ull;
    out[(size_t)bb * N + n] = ldexpf(__ll2float_rn(v), -shift);
  }
  if (tid == 0) cnt[tile] = 0;
}

template <int BP>
cudaError_t launch_bp(const uint8_t* x, const uint8_t* codes,
                      const float* lut, float* out, unsigned long long* sums,
                      int* cnt, int B, int N, int K, int nc, int ksplit,
                      int steps_per_split, cudaStream_t stream) {
  auto kern = lut_product_kernel<BP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + NBLK - 1) / NBLK, ksplit, (B + XROWS - 1) / XROWS);
  kern<<<grid, THREADS, SMEM, stream>>>(x, codes, lut, out, sums, cnt, B, N,
                                        K, nc, steps_per_split);
  return cudaGetLastError();
}

}  // namespace

// K even and >= 2, 1 <= nc <= 16; ksplit splits of steps_per_split steps
// of 32 weight bytes cover K / 2 bytes.  When ksplit > 1, `scratch` holds
// one int counter per (row tile, x row group) followed, at byte offset
// sums_offset (a multiple of 8), by N * B int64 sums, all zero, and left
// zero.  Returns the cudaError_t of the launch.
extern "C" int lut_product_launch(const void* x, const void* codes,
                                  const void* lut, void* out, void* scratch,
                                  int B, int N, int K, int nc, int ksplit,
                                  int steps_per_split, int sums_offset,
                                  void* stream) {
  const long long steps = (K / 2 + STEP - 1) / STEP;
  if (B < 1 || N < 1 || K < 2 || K % 2 != 0 || nc < 1 || nc > 16 ||
      ksplit < 1 || steps_per_split < 1 ||
      (long long)ksplit * steps_per_split < steps ||
      (long long)(ksplit - 1) * steps_per_split >= steps ||
      sums_offset % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  const float* lp = static_cast<const float*>(lut);
  float* op = static_cast<float*>(out);
  int* cnt = static_cast<int*>(scratch);
  unsigned long long* sums = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + sums_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = B <= 4 ? launch_bp<4>
           : B <= 8 ? launch_bp<8>
           : B <= 16 ? launch_bp<16>
                     : launch_bp<32>;
  return (int)f(xp, cp, lp, op, sums, cnt, B, N, K, nc, ksplit,
                steps_per_split, s);
}
