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
// What bounds it: the B * N * K look-ups, each a shared-memory load; the
// bytes (half a byte per weight, one per activation) are far below them.
//
// Design: one thread per output row n keeps B (<= BT) sums in registers,
// so each packed weight byte is read once from device memory, 16 at a time,
// and unpacked low nibble first.  The table lives in shared memory 32 times
// over, entry e of lane l at e * 32 + l, so the 32 lanes of a warp, looking
// up 32 different entries, always hit 32 different banks; one extra zero
// entry stands for the codes past K.  The x codes of the block's rows are
// staged in shared memory KC at a time and read as broadcasts.  The sum
// runs exactly over k < K (no padded columns to correct for): the two
// products of each weight byte (codes 2j and 2j + 1) are added in f32 and
// the byte sums in f64, and the total is rounded to f32 once, so the order
// of the byte sums is immaterial (a run of f32 adds over K = 14336 would
// drift by ~1e-4).  The f64 adds run beside the look-ups, which bound the
// kernel.  Few rows (N = 1024) would leave SMs idle, so K is split over
// blocks in multiples of 32, each split writes f64 partial sums, and a
// second pass adds them in split order (no atomics: a rerun repeats bit
// for bit).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;        // threads = output rows of a block
constexpr int KC = 256;       // x codes staged per pass
constexpr int RUN = 32;       // codes of one 16-byte load
constexpr int ZERO = 16 * 16;  // the zero entry of the table

template <int BT>
__global__ void __launch_bounds__(NT)
    lut_product_kernel(const uint8_t* __restrict__ x,
                       const uint8_t* __restrict__ codes,
                       const float* __restrict__ lut, float* __restrict__ out,
                       double* __restrict__ part, int B, int N, int K, int nc,
                       int k_per_split) {
  __shared__ float lut_s[(ZERO + 1) * 32];
  __shared__ __align__(16) uint8_t xs[BT][KC];
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < (ZERO + 1) * 32; e += NT) {
    const int ent = e / 32;
    lut_s[e] = ent < nc * nc ? lut[ent] : 0.f;
  }
  const int n = blockIdx.x * NT + threadIdx.x, b0 = blockIdx.y * BT;
  const int k_lo = blockIdx.z * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const int kb = K / 2;  // bytes per row of codes
  const uint8_t* row = codes + (size_t)min(n, N - 1) * kb;
  const bool vec =
      kb % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  double acc[BT];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) acc[bb] = 0.0;

  for (int kc = k_lo; kc < k_hi; kc += KC) {
    __syncthreads();  // the table is filled / the last pass is done
    for (int e = threadIdx.x; e < BT * KC; e += NT) {
      const int bb = e / KC, kk = e % KC;
      xs[bb][kk] = (b0 + bb < B && kc + kk < k_hi)
                       ? x[(size_t)(b0 + bb) * K + kc + kk]
                       : (uint8_t)0;
    }
    __syncthreads();
    for (int c = kc; c < min(kc + KC, k_hi); c += RUN) {
      union {
        int4 raw;
        uint8_t b[16];
      } u;
      const int j = c / 2;  // first byte of the run
      if (vec && j + 16 <= kb) {
        u.raw = __ldg(reinterpret_cast<const int4*>(row + j));
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) u.b[i] = j + i < kb ? row[j + i] : 0;
      }
      // per code: the offset of its table row for this lane; codes past
      // the split's end point at the zero entry (their x codes are 0)
      int wofs[RUN];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        wofs[2 * i] = c + 2 * i < k_hi ? (u.b[i] & 15) * nc * 32 + lane
                                       : ZERO * 32 + lane;
        wofs[2 * i + 1] = c + 2 * i + 1 < k_hi
                              ? (u.b[i] >> 4) * nc * 32 + lane
                              : ZERO * 32 + lane;
      }
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        const uint32_t* xr =
            reinterpret_cast<const uint32_t*>(&xs[bb][c - kc]);
        double a = acc[bb];
#pragma unroll
        for (int q = 0; q < RUN / 4; ++q) {  // two weight bytes
          const uint32_t xw = xr[q];
          a += (double)(lut_s[wofs[4 * q] + ((xw & 15u) << 5)] +
                        lut_s[wofs[4 * q + 1] + (((xw >> 8) & 15u) << 5)]);
          a += (double)(lut_s[wofs[4 * q + 2] + (((xw >> 16) & 15u) << 5)] +
                        lut_s[wofs[4 * q + 3] + (((xw >> 24) & 15u) << 5)]);
        }
        acc[bb] = a;
      }
    }
  }
  if (n >= N) return;
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) {
    const int b = b0 + bb;
    if (b >= B) break;
    if (part == nullptr)
      out[(size_t)b * N + n] = (float)acc[bb];
    else
      part[((size_t)blockIdx.z * B + b) * N + n] = acc[bb];
  }
}

// out = the splits' partial sums added in split order, rounded once
__global__ void lut_product_reduce(const double* __restrict__ part,
                                   float* __restrict__ out, int BN,
                                   int ksplit) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= BN) return;
  double s = 0.0;
  for (int i = 0; i < ksplit; ++i) s += part[(size_t)i * BN + e];
  out[e] = (float)s;
}

template <int BT>
cudaError_t launch_bt(const uint8_t* x, const uint8_t* codes,
                      const float* lut, float* out, double* part, int B,
                      int N, int K, int nc, int ksplit, int k_per_split,
                      cudaStream_t stream) {
  dim3 grid((N + NT - 1) / NT, (B + BT - 1) / BT, ksplit);
  lut_product_kernel<BT><<<grid, NT, 0, stream>>>(
      x, codes, lut, out, ksplit > 1 ? part : nullptr, B, N, K, nc,
      k_per_split);
  return cudaGetLastError();
}

}  // namespace

// K even and >= 2, 1 <= nc <= 16; ksplit splits of k_per_split codes (a
// multiple of 32) cover K; part: scratch of ksplit * B * N doubles (unused
// when ksplit == 1).  Returns the cudaError_t of the launches.
extern "C" int lut_product_launch(const void* x, const void* codes,
                                  const void* lut, void* out, void* part,
                                  int B, int N, int K, int nc, int ksplit,
                                  int k_per_split, void* stream) {
  if (B < 1 || N < 1 || K < 2 || K % 2 != 0 || nc < 1 || nc > 16 ||
      ksplit < 1 || k_per_split % RUN != 0 ||
      (long long)ksplit * k_per_split < K)
    return (int)cudaErrorInvalidValue;
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  const float* lp = static_cast<const float*>(lut);
  float* op = static_cast<float*>(out);
  double* pp = static_cast<double*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = B <= 4 ? launch_bt<4>
           : B <= 8 ? launch_bt<8>
           : B <= 16 ? launch_bt<16>
                     : launch_bt<32>;
  const cudaError_t err =
      f(xp, cp, lp, op, pp, B, N, K, nc, ksplit, k_per_split, s);
  if (err != cudaSuccess || ksplit == 1) return (int)err;
  const int bn = B * N;
  lut_product_reduce<<<(bn + 255) / 256, 256, 0, s>>>(pp, op, bn, ksplit);
  return (int)cudaGetLastError();
}
