// Blocked-ACSR sparse matrix times activations, act(W @ x + bias), for Hopper.
//
// Replaces the TPU kernel `_fused_spmv_kernel` of
// src/repro/kernels/acsr_spmv.py (launched by `_spmv_call` / `acsr_spmv`).
//
// Layout (the row-balanced slot schedule of `block_encode`):
//   values  [nb, rmax, br]  uint8 codes into a 16-entry codebook (aida),
//                           or f32 / bf16 values (acsr)
//   col_idx [nb, rmax, br]  int16 (n_cols < 2^15) or int32
//   row_nnz [nb, br]        int32; slot s of lane r is live while
//                           s < row_nnz[r]
//   x       [K, B]          f32, B activations per column
//   out     [nb*br, B]      f32
//
// What bounds it: bytes.  At decode batch B <= 8 each live slot costs one
// code byte, two or four index bytes and B multiply-adds, far below the
// card's ~295 operations per byte, so the floor is reading the live slots
// once from device memory.  The x gather (B floats per slot, random column)
// is served from L1/L2: x is at most 14336 x 4 x 4 bytes here.
//
// Design:
//  * One thread per lane (matrix row) for a fixed slot, so a warp reads 32
//    neighbouring code bytes and 32 neighbouring column ids per slot.
//  * The loop is latency-bound (code -> column -> x gather are dependent
//    loads), so each thread issues the loads of UNROLL = 4 slots before it
//    uses any, and gathers a 4-column x row as one 16-byte load.
//  * The slot axis is split two ways, because one block per 128-row block
//    leaves most of the 132 SMs idle (wk/wv have 8 row blocks): across
//    threadIdx.y inside a block, and across blockIdx.y into `nsplit` slot
//    ranges.  Partial sums are reduced in shared memory (in threadIdx.y
//    order) and then, when nsplit > 1, by a second pass in split order, so
//    the sum order is fixed and results repeat bit for bit.  No atomics.
//  * Dead slots are masked by slot < row_nnz, never by code == 0: a live
//    nonzero may map to centroid 0, and padding slots hold code 0, col 0.
//    The slot loop stops at row_nnz, so dead slots cost no loads.
//  * int16 and int32 column ids are separate instantiations; the wrapper
//    never widens them.
//  * Bias and activation run in the epilogue (second pass, or the first
//    when nsplit == 1), as the TPU kernel does on its last K step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAXB = 8;    // batch columns per pass; larger B loops in chunks
constexpr int UNROLL = 4;  // slots per thread with loads in flight together

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
__global__ void spmv_partial(const VT* __restrict__ vals,
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
int launch(const void* vals, const void* cols, const int* row_nnz,
           const float* cents, const float* x, const float* bias,
           float* out, float* part, int nb, int rmax, int br, int sy,
           int batch, int nsplit, int slots_per_split, int act,
           cudaStream_t stream) {
  const dim3 grid(nb, nsplit), block(br, sy);
  const int nrows = nb * br;
  for (int j0 = 0; j0 < batch; j0 += MAXB) {
    const int nbc = batch - j0 < MAXB ? batch - j0 : MAXB;
    const size_t smem = (size_t)sy * br * nbc * sizeof(float);
    spmv_partial<VT, CT><<<grid, block, smem, stream>>>(
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

}  // namespace

// value_kind: 0 = uint8 codes (needs cents), 1 = f32, 2 = bf16.
// col_kind:   0 = int16, 1 = int32.
// part: scratch of nsplit * nb * br * min(batch, 8) floats (unused if
// nsplit == 1).  Returns the cudaError_t of the launches.
extern "C" int acsr_spmv_launch(const void* vals, const void* cols,
                                const void* row_nnz, const void* cents,
                                const void* x, const void* bias, void* out,
                                void* part, int value_kind, int col_kind,
                                int nb, int rmax, int br, int sy, int batch,
                                int nsplit, int slots_per_split, int act,
                                void* stream) {
  if (br <= 0 || br * sy > 1024 || batch <= 0 || nsplit <= 0 ||
      (value_kind == 0 && cents == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* nnz = static_cast<const int*>(row_nnz);
  const float* c = static_cast<const float*>(cents);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ACSR_CALL(VT, CT)                                                  \
  return launch<VT, CT>(vals, cols, nnz, c, xf, bf, o, p, nb, rmax, br, sy, \
                        batch, nsplit, slots_per_split, act, s)
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
