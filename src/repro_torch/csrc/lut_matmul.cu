// Codebook4-weight FC for Hopper: act(x @ cents[unpack4(codes)]^T + bias),
// weights stored as 4-bit codes two per byte, low nibble first (K5).
//
// Replaces the TPU kernel `_lut_matmul_kernel` of
// src/repro/kernels/lut_matmul.py (launched by `lut_matmul`).
//
//   x      [M, K]    f32        codes [N, K/2]  uint8 (code 2j low, 2j+1 high)
//   cents  [16]      f32        bias  [N]       f32 or null
//   out    [M, N]    f32
//
// What bounds it: bytes at decode (M = B = 4: half a byte per weight feeds
// 4 multiply-adds), f32 operations at a chunked-prefill step (M = B * C =
// 32), as for the int8 kernel.
//
// Design: the tiled product of fc_tile.cuh.  The weight policy below reads
// 32 codes of one row per 16-byte load; each byte unpacks to its two codes,
// low nibble first, looked up in the 16 centroids held in shared memory,
// so the dense weights exist only as the shared tile.
#include "fc_tile.cuh"

namespace {

struct Codes4 {
  const uint8_t* __restrict__ codes;  // [N, K/2]

  __device__ __forceinline__ void stage(fc::WTile& ws, int n0, int k0, int N,
                                        int K, const float* cs) const {
    const int kb = K / 2;  // bytes per row
    for (int e = threadIdx.x; e < fc::BN * fc::BK / 32; e += fc::NT) {
      const int n = e % fc::BN, j = (e / fc::BN) * 16;  // byte in the tile
      const int gn = n0 + n, gj = k0 / 2 + j;
      union {
        int4 raw;
        uint8_t b[16];
      } u;
      const uint8_t* row = codes + (size_t)gn * kb;
      if (gn < N && gj + 16 <= kb && kb % 16 == 0) {
        u.raw = __ldg(reinterpret_cast<const int4*>(row + gj));
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          u.b[i] = (gn < N && gj + i < kb) ? row[gj + i] : (uint8_t)0;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        ws[2 * (j + i)][n] = cs[u.b[i] & 15];
        ws[2 * (j + i) + 1][n] = cs[u.b[i] >> 4];
      }
    }
  }
};

}  // namespace

// K must be even.  part: scratch of ksplit * M * N floats (unused if
// ksplit == 1); the splits cover K in k_per_split steps (a multiple of
// 64).  Returns the cudaError_t of the launches.
extern "C" int lut_matmul_launch(const void* x, const void* codes,
                                 const void* cents, const void* bias,
                                 void* out, void* part, int M, int N, int K,
                                 int ksplit, int k_per_split, int act,
                                 void* stream) {
  if (cents == nullptr || K % 2 != 0) return (int)cudaErrorInvalidValue;
  return fc::launch(Codes4{static_cast<const uint8_t*>(codes)},
                    static_cast<const float*>(x), nullptr,
                    static_cast<const float*>(bias),
                    static_cast<const float*>(cents),
                    static_cast<float*>(out), static_cast<float*>(part), M, N,
                    K, ksplit, k_per_split, act,
                    static_cast<cudaStream_t>(stream));
}
