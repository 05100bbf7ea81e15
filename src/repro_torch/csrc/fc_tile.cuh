// Tiled f32 matrix product shared by the int8 (K4) and codebook4 (K5) FC
// kernels: out[M, N] = act(x[M, K] @ W[N, K]^T * scale[n] + bias[n]), with W
// kept compressed in device memory and decoded into a shared-memory tile.
//
// Design:
//  * A block owns a [BM, BN] output tile (BN = 64 output channels, BM = 8
//    or 32 rows of x) and walks its K range in BK = 64 steps.  Each step
//    stages the x tile [BM][BK] and the decoded weight tile, transposed to
//    [BK][BN], in shared memory; the weight policy `W` reads the compressed
//    rows (16-byte loads where the row is aligned and whole, byte loads at
//    a ragged edge) and decodes them, so no dense weight tile ever reaches
//    device memory.
//  * 128 threads, 16 along n x 8 along m; each accumulates TM x 4 outputs
//    in f32 FMA, so results stay within rounding of an f32 product.
//  * Ragged M, N and K are masked in the kernel: x rows past M and columns
//    past K stage as 0, outputs past M or N are not stored.
//  * Few output tiles (decode has M = 4; wk/wv have N = 1024) would leave
//    most SMs idle, so K is split over blockIdx.z; each split writes its
//    partial tile and a second pass sums the splits in split order, then
//    runs the epilogue.  No atomics: results repeat bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fc {

constexpr int BN = 64;   // output channels (weight rows) per block
constexpr int BK = 64;   // reduction depth per shared-memory step
constexpr int TN = 4;    // output channels per thread
constexpr int NT = 128;  // threads per block: 16 along n x 8 along m

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

// y * scale[n] (K4 only), + bias[n], then the activation.
__device__ __forceinline__ float epilogue(float y, int n,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias,
                                          int act) {
  if (scale != nullptr) y *= scale[n];
  if (bias != nullptr) y += bias[n];
  return activate(y, act);
}

typedef float WTile[BK][BN + 4];  // rows 16-byte aligned for float4 reads

// grid (ceil(N / BN), ceil(M / BM), ksplit), block NT.  `cents` ([16], K5
// only) is staged in shared memory for the weight policy.
template <int TM, typename W>
__global__ void __launch_bounds__(NT)
    fc_tiled(W w, const float* __restrict__ x, int M, int N, int K,
             int k_per_split, const float* __restrict__ scale,
             const float* __restrict__ bias, int act,
             const float* __restrict__ cents, float* __restrict__ out,
             float* __restrict__ part) {
  constexpr int BM = 8 * TM;
  __shared__ float xs[BM][BK + 1];
  __shared__ __align__(16) WTile ws;
  __shared__ float cs[16];
  const int tid = threadIdx.x, tn = tid % 16, tm = tid / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int kbeg = split * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  if (cents != nullptr && tid < 16) cs[tid] = cents[tid];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // previous tile consumed; centroids visible
    for (int e = tid; e < BM * BK; e += NT) {
      const int m = e / BK, k = e % BK;
      const int gm = m0 + m, gk = k0 + k;
      xs[m][k] = (gm < M && gk < K) ? __ldg(x + (size_t)gm * K + gk) : 0.f;
    }
    w.stage(ws, n0, k0, N, K, cs);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tn * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = xs[tm * TM + i][kk];
        acc[i][0] += a * b.x;
        acc[i][1] += a * b.y;
        acc[i][2] += a * b.z;
        acc[i][3] += a * b.w;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (m >= M || n >= N) continue;
      if (nsplit == 1)
        out[(size_t)m * N + n] = epilogue(acc[i][j], n, scale, bias, act);
      else
        part[((size_t)split * M + m) * N + n] = acc[i][j];
    }
  }
}

// Second pass: sum the nsplit partial tiles in split order, then epilogue.
__global__ void fc_finalize(const float* __restrict__ part, int nsplit, int M,
                            int N, const float* __restrict__ scale,
                            const float* __restrict__ bias, int act,
                            float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  float v = 0.f;
  for (int s = 0; s < nsplit; ++s) v += part[(size_t)s * M * N + i];
  out[i] = epilogue(v, (int)(i % N), scale, bias, act);
}

template <typename W>
int launch(const W& w, const float* x, const float* scale, const float* bias,
           const float* cents, float* out, float* part, int M, int N, int K,
           int ksplit, int k_per_split, int act, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ksplit <= 0 || k_per_split % BK != 0 ||
      (size_t)ksplit * k_per_split < (size_t)K)
    return (int)cudaErrorInvalidValue;
  const int tm = M <= 8 ? 1 : 4;
  const dim3 grid((N + BN - 1) / BN, (M + 8 * tm - 1) / (8 * tm), ksplit);
  if (tm == 1)
    fc_tiled<1, W><<<grid, NT, 0, stream>>>(w, x, M, N, K, k_per_split, scale,
                                            bias, act, cents, out, part);
  else
    fc_tiled<4, W><<<grid, NT, 0, stream>>>(w, x, M, N, K, k_per_split, scale,
                                            bias, act, cents, out, part);
  if (ksplit > 1) {
    const size_t n = (size_t)M * N;
    const int threads = 256;
    fc_finalize<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                  stream>>>(part, ksplit, M, N, scale, bias, act, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace fc
