// int8-weight FC for Hopper: act(x @ (q * scale)^T + bias), the per-output-
// channel dequant scale applied in the epilogue (K4).
//
// Replaces the TPU kernel `_int8_kernel` of src/repro/kernels/int8_matmul.py
// (launched by `int8_matmul`).
//
//   x      [M, K]  f32          q     [N, K]  int8 (w ~ q * scale)
//   scale  [N]     f32          bias  [N]     f32 or null
//   out    [M, N]  f32
//
// What bounds it: bytes at decode (M = B = 4 rows: each int8 weight byte
// feeds 4 multiply-adds, far below the card's balance), f32 operations
// once M reaches the rows of a chunked-prefill step (M = B * C = 32:
// 2 * 32 multiply-adds per weight byte against 67 TFLOP/s of f32 FMA).
//
// Design: the tiled product of fc_tile.cuh.  The weight policy below reads
// 16 int8 weights of one row per 16-byte load and converts them to f32 in
// the shared tile; the scale multiplies the accumulated sum once per
// output, as the TPU kernel does on its last K step.
#include "fc_tile.cuh"

namespace {

struct Int8Rows {
  const int8_t* __restrict__ q;  // [N, K]

  __device__ __forceinline__ void stage(fc::WTile& ws, int n0, int k0, int N,
                                        int K, const float*) const {
    for (int e = threadIdx.x; e < fc::BN * fc::BK / 16; e += fc::NT) {
      const int n = e % fc::BN, k = (e / fc::BN) * 16;
      const int gn = n0 + n, gk = k0 + k;
      union {
        int4 raw;
        int8_t b[16];
      } u;
      const int8_t* row = q + (size_t)gn * K;
      if (gn < N && gk + 16 <= K && K % 16 == 0) {
        u.raw = __ldg(reinterpret_cast<const int4*>(row + gk));
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          u.b[i] = (gn < N && gk + i < K) ? row[gk + i] : (int8_t)0;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) ws[k + i][n] = (float)u.b[i];
    }
  }
};

}  // namespace

// part: scratch of ksplit * M * N floats (unused if ksplit == 1); the
// splits cover K in k_per_split steps (a multiple of 64).  Returns the
// cudaError_t of the launches.
extern "C" int int8_matmul_launch(const void* x, const void* q,
                                  const void* scale, const void* bias,
                                  void* out, void* part, int M, int N, int K,
                                  int ksplit, int k_per_split, int act,
                                  void* stream) {
  if (scale == nullptr) return (int)cudaErrorInvalidValue;
  return fc::launch(Int8Rows{static_cast<const int8_t*>(q)},
                    static_cast<const float*>(x),
                    static_cast<const float*>(scale),
                    static_cast<const float*>(bias), nullptr,
                    static_cast<float*>(out), static_cast<float*>(part), M, N,
                    K, ksplit, k_per_split, act,
                    static_cast<cudaStream_t>(stream));
}
