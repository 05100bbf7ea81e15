// RWKV6 ("Finch") WKV scan for Hopper (K9).
//
// Replaces the TPU kernel `_rwkv6_kernel` of src/repro/kernels/linear_scan.py
// (launched by `rwkv6_fwd`).
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T            S_0 = 0, S [Dk, Dv]
//   o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
//       = S_{t-1}^T r_t + v_t (sum_i r_t[i] u[i] k_t[i])
//
//   r, k, w [B, H, T, Dk]; v [B, H, T, Dv]; o [B, H, T, Dv] f32; u [H, Dk]
//   f32.  r, k, v are bf16 or f32 (one type), w is f32.  Every operand but
//   u is addressed by its own (b, h, t) strides in elements with a
//   contiguous last axis, so the model's head views [B, T, H, dh] ->
//   [B, H, T, dh] are read in place and o is written in [B, T, H, Dv].
//
// What bounds it: at rwkv6-7b's forward shape (B 2, H 64, T 2048, Dk = Dv =
// 64) the f32 state update, 5 flops per state element per step (r.S, k*v,
// w*S + kv), a little above the bytes of r, k, v, w in and o out.  The
// time axis is sequential, so the parallelism is B * H * Dk * Dv state
// elements, and every step waits on the one before it.
//
// Design: as the TPU kernel keeps S resident in VMEM for the whole
// sequence, one block per (b, h, tile of up to COLS value columns) keeps
// its columns of S in registers (the columns are independent).  Value
// column j belongs to SPLIT neighbouring threads, each holding every
// SPLIT-th row of S[:, j] (Dk zero-padded to DKP), so the state update is
// thread-local and the output dot product ends in two shuffles.  CT steps
// of (r, k, w) are staged in shared memory as float4, read by a warp as
// SPLIT neighbouring float4s (one wavefront), with v beside them; the
// staging issues its global loads PER at a time, so their latency is paid
// once per batch and not once per element.  The scalar r.(u*k) of each
// staged step is taken once, by one warp.  The exact recurrence runs in
// f32 (no cumulative-product factorisation), so decays near 0 stay exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPLIT = 4;   // threads per value column
constexpr int COLS = 64;   // value columns of a block
constexpr int PER = 8;     // global loads in flight per thread
constexpr int MAX_THREADS = SPLIT * COLS;

template <int DKP>
struct Steps {  // time steps staged per pass
  static constexpr int CT = DKP >= 128 ? 32 : 64;
};

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ long long at(const Strides& s, int b, int h,
                                        int t) {
  return (long long)b * s.b + (long long)h * s.h + (long long)t * s.t;
}

// shared memory: rkw [CT][DKP] float4 (r, k, w, 0), u [DKP], c [CT],
// v [CT][ncol]; blockDim.x = SPLIT * ncol, ncol = min(Dv, COLS) rounded up
// to 8; blockIdx.y picks the block's value columns
template <typename TIn, int DKP>
__global__ void __launch_bounds__(MAX_THREADS)
    rwkv6_kernel(const TIn* __restrict__ r, const TIn* __restrict__ k,
                 const TIn* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, float* __restrict__ o,
                 Strides sr, Strides sk, Strides sv, Strides sw, Strides so,
                 int H, int T, int dk, int dv) {
  constexpr int CT = Steps<DKP>::CT, RPT = DKP / SPLIT;
  extern __shared__ float4 smem4[];
  float4* rkw = smem4;                                    // [CT][DKP]
  float* us = reinterpret_cast<float*>(rkw + CT * DKP);  // [DKP]
  float* cs = us + DKP;                                   // [CT]
  float* vs = cs + CT;                                    // [CT][ncol]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, nt = blockDim.x, ncol = nt / SPLIT;
  const int j0 = blockIdx.y * ncol, jl = tid / SPLIT, part = tid % SPLIT;
  const int j = j0 + jl;
  for (int i = tid; i < DKP; i += nt) us[i] = i < dk ? u[h * dk + i] : 0.f;

  float S[RPT];  // rows part, part + SPLIT, ... of column j
#pragma unroll
  for (int m = 0; m < RPT; ++m) S[m] = 0.f;

  for (int t0 = 0; t0 < T; t0 += CT) {
    const int n = min(CT, T - t0);
    __syncthreads();  // the previous pass is done with the staged steps
    for (int e0 = tid; e0 < CT * DKP; e0 += nt * PER) {
      float4 q[PER];
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int e = e0 + p * nt, t = e / DKP, i = e % DKP;
        q[p] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < CT * DKP && t < n && i < dk) {
          q[p].x = f32(r[at(sr, b, h, t0 + t) + i]);
          q[p].y = f32(k[at(sk, b, h, t0 + t) + i]);
          q[p].z = w[at(sw, b, h, t0 + t) + i];
        }
      }
#pragma unroll
      for (int p = 0; p < PER; ++p)
        if (e0 + p * nt < CT * DKP) rkw[e0 + p * nt] = q[p];
    }
    for (int e0 = tid; e0 < CT * ncol; e0 += nt * PER) {
      float q[PER];
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int e = e0 + p * nt, t = e / ncol, i = j0 + e % ncol;
        q[p] = (e < CT * ncol && t < n && i < dv)
                   ? f32(v[at(sv, b, h, t0 + t) + i])
                   : 0.f;
      }
#pragma unroll
      for (int p = 0; p < PER; ++p)
        if (e0 + p * nt < CT * ncol) vs[e0 + p * nt] = q[p];
    }
    __syncthreads();
    // the bonus term's scalar of each staged step: one warp per step,
    // lanes over Dk, a shuffle sum
    for (int t = tid >> 5; t < n; t += nt >> 5) {
      float c = 0.f;
      for (int i = tid & 31; i < DKP; i += 32) {
        const float4 q = rkw[t * DKP + i];
        c = fmaf(q.x, us[i] * q.y, c);
      }
      for (int off = 16; off > 0; off >>= 1)
        c += __shfl_xor_sync(0xffffffffu, c, off);
      if ((tid & 31) == 0) cs[t] = c;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t * ncol + jl];
      const float4* row = rkw + t * DKP + part;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int m = 0; m < RPT; m += 2) {
        float4 q = row[m * SPLIT];
        a0 = fmaf(q.x, S[m], a0);
        S[m] = fmaf(q.z, S[m], q.y * vj);
        q = row[(m + 1) * SPLIT];
        a1 = fmaf(q.x, S[m + 1], a1);
        S[m + 1] = fmaf(q.z, S[m + 1], q.y * vj);
      }
      float a = a0 + a1;
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (part == 0 && j < dv)
        o[at(so, b, h, t0 + t) + j] = fmaf(vj, cs[t], a);
    }
  }
}

template <typename TIn, int DKP>
int launch_t(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* o, const Strides* st, int B, int H, int T,
             int dk, int dv, cudaStream_t stream) {
  constexpr int CT = Steps<DKP>::CT;
  const int ncol = ((min(dv, COLS) + 7) / 8) * 8;
  const size_t smem = sizeof(float4) * CT * DKP +
                      sizeof(float) * (DKP + CT + (size_t)CT * ncol);
  auto kern = rwkv6_kernel<TIn, DKP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (dv + ncol - 1) / ncol);
  kern<<<grid, SPLIT * ncol, smem, stream>>>(
      static_cast<const TIn*>(r), static_cast<const TIn*>(k),
      static_cast<const TIn*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(o), st[0], st[1],
      st[2], st[3], st[4], H, T, dk, dv);
  return (int)cudaGetLastError();
}

template <typename TIn>
int launch_dk(const void* r, const void* k, const void* v, const void* w,
              const void* u, void* o, const Strides* st, int B, int H, int T,
              int dk, int dv, cudaStream_t s) {
  auto f = dk <= 16   ? launch_t<TIn, 16>
           : dk <= 32 ? launch_t<TIn, 32>
           : dk <= 64 ? launch_t<TIn, 64>
                      : launch_t<TIn, 128>;
  return f(r, k, v, w, u, o, st, B, H, T, dk, dv, s);
}

}  // namespace

// kind: 0 = bf16 r / k / v, 1 = f32.  strides: 15 values, (b, h, t) of r,
// k, v, w and o in that order, in elements.  1 <= dk <= 128, dv >= 1,
// B * H >= 1, T >= 1.  Returns the cudaError_t of the launch.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* o,
                                 const long long* strides, int kind, int B,
                                 int H, int T, int dk, int dv, void* stream) {
  if (dk < 1 || dk > 128 || dv < 1 || B * H < 1 || T < 1 ||
      (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  Strides st[5];
  for (int i = 0; i < 5; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return launch_dk<__nv_bfloat16>(r, k, v, w, u, o, st, B, H, T, dk, dv, s);
  return launch_dk<float>(r, k, v, w, u, o, st, B, H, T, dk, dv, s);
}
