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
// elements (about 31 a lane of the card at that shape), and every step
// waits on the one before it: the kernel is bound by how few instructions
// and how little waiting a step costs each thread.
//
// Design.  As the TPU kernel keeps S resident in VMEM for the whole
// sequence, one block per (b, h, tile of NCOL value columns) keeps its
// columns of S in registers for the whole sequence, and walks T in passes
// of CT steps (16; 8 for heads past 64):
//  * Register tile: thread (rg, cg) holds rows rg R .. rg R + R - 1 (R =
//    DKP / RG) of columns 4 cg .. 4 cg + 3.  A step reads its R rows' r,
//    k, w and its 4 values of v from shared memory once (vector loads) and
//    reuses each 4 or R times: R * 4 state updates S = fmaf(w, S, k*v) (k*v
//    rounded to f32 first) and R * 4 output FMAs.
//  * Deferred output sum: at each step a thread stores its 4 partial dot
//    products (its rows' r.S) to pbuf [CT][RG][NCOL]; no shuffle and no
//    store to device memory sits on the step chain.  Once a pass, the
//    block adds the RG partials of each (step, column) in row-group order,
//    then the bonus v_t[j] * (r_t . (u * k_t)), and writes o coalesced.
//  * Staging ahead: the r, k, v (bf16 into a raw buffer, converted to f32
//    by the thread that copied them) and w (f32, straight into its plane)
//    of the pass PD ahead come by 16-byte cp.async while the scan runs, so
//    a copy has PD passes to land; one block barrier a pass.  Operands that
//    are not 16-byte aligned are loaded plainly a pass ahead instead.
// The exact recurrence runs in f32 (no cumulative-product factorisation),
// so decays near 0 stay exact; only the output's summation order differs
// from the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tile.cuh"

namespace {

constexpr int RG = 16;          // row groups: a thread holds DKP / RG rows
constexpr int CW = 4;           // value columns a thread
constexpr int NCOL = 64;        // value columns a block
constexpr int PD = 2;           // passes staged ahead of the scan
constexpr int THREADS = RG * NCOL / CW;
constexpr int MAX_SMEM = 232448;  // H100: shared memory a block can take

// time steps a pass: 16, or 8 for heads past 64 (shared memory)
constexpr int pass_steps(int dkp) { return dkp > 64 ? 8 : 16; }

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

// Shared memory of a block, in floats: u, r / k / w planes [PD + 1][CT]
// [DKP] each, v [PD + 2][CT][NCOL], pbuf [2][CT][RG][NCOL], c [2][CT], then
// (bf16 operands) the raw passes [PD][CT][2 DKP + NCOL].  Pass p uses
// planes p % (PD + 1), v p % (PD + 2) (read again when its outputs are
// added, a pass later), raw p % PD, pbuf and c p % 2.
template <typename TIn, int DKP>
struct Layout {
  static constexpr int CT = pass_steps(DKP);
  static constexpr int RAWROW = 2 * DKP + NCOL;  // a step's raw r, k, v
  static constexpr int u = 0;
  static constexpr int r = u + DKP;
  static constexpr int k = r + (PD + 1) * CT * DKP;
  static constexpr int w = k + (PD + 1) * CT * DKP;
  static constexpr int v = w + (PD + 1) * CT * DKP;
  static constexpr int p = v + (PD + 2) * CT * NCOL;
  static constexpr int c = p + 2 * CT * RG * NCOL;
  static constexpr int raw = c + 2 * CT;
  static constexpr bool RAW = !std::is_same<TIn, float>::value;
  static constexpr size_t bytes =
      sizeof(float) * raw + (RAW ? sizeof(TIn) * PD * CT * RAWROW : 0);
};

struct Args {
  const void *r, *k, *v;
  const float *w, *u;
  float* o;
  Strides sr, sk, sv, sw, so;
  int H, T, dk, dv;
  bool vec;  // every staged operand 16-byte aligned, rows whole pieces
};

// Pass p's operands: steps [p CT, p CT + n) of r, k (rows < dk), v
// (columns [j0, j0 + nc)) and w, cut into 16-byte pieces (vec): a step's
// pieces are r's, k's, v's, then w's, and piece e of a pass is thread e %
// THREADS's.  A thread finds its pieces once (init) and then only moves
// their sources a pass on.  issue(): the cp.async copies, r, k, v into
// the pass's raw buffer (bf16) or straight into their planes (f32), w into
// its plane.  finish(), once this thread's copies have landed: its raw
// pieces converted to f32 (bf16); or (not vec) every element loaded
// plainly.  A thread converts only what it copied.
template <typename TIn, int DKP>
struct Stage {
  using L = Layout<TIn, DKP>;
  static constexpr int CT = L::CT;
  static constexpr int E = 16 / sizeof(TIn);  // elements a 16-byte piece
  static constexpr int MAXP =                 // pieces a thread, at most
      (CT * (2 * DKP / E + NCOL / E + DKP / 4) + THREADS - 1) / THREADS;
  const Args& a;
  float* sm;
  int b, h, j0, nc, tid;
  // this thread's pieces: source at pass 0, bytes a pass on, step in the
  // pass, array (0 r, 1 k, 2 v, 3 w, -1 none), offset in the raw buffer
  // (bf16) and in its plane or v buffer
  const char* src[MAXP];
  long long step[MAXP];
  int t_[MAXP], kind[MAXP], raw_at[MAXP], at_[MAXP];

  __device__ void init() {
    const int pk = a.dk / E, pv = nc / E, pw = a.dk / 4;
    const int per = 2 * pk + pv + pw;  // pieces a step
#pragma unroll
    for (int m = 0; m < MAXP; ++m) {
      const int e = tid + m * THREADS, t = e / per, q = e % per;
      kind[m] = e < CT * per ? (q < pk ? 0 : q < 2 * pk ? 1
                                : q < 2 * pk + pv ? 2 : 3) : -1;
      t_[m] = t;
      const int z = kind[m];
      const int i = z < 2 ? (q - z * pk) * E
                          : z == 2 ? (q - 2 * pk) * E : (q - 2 * pk - pv) * 4;
      const Strides& s = z == 0 ? a.sr : z == 1 ? a.sk : z == 2 ? a.sv : a.sw;
      const size_t elem = z == 3 ? sizeof(float) : sizeof(TIn);
      const char* base = z == 0   ? static_cast<const char*>(a.r)
                         : z == 1 ? static_cast<const char*>(a.k)
                         : z == 2 ? static_cast<const char*>(a.v)
                                  : reinterpret_cast<const char*>(a.w);
      src[m] = base + (at(s, b, h, t) + i + (z == 2 ? j0 : 0)) * elem;
      step[m] = (long long)CT * s.t * elem;
      raw_at[m] = t * L::RAWROW + (z < 2 ? z * DKP : 2 * DKP) + i;
      at_[m] = t * (z == 2 ? NCOL : DKP) + i;
    }
  }

  __device__ TIn* raw(int p) const {
    return reinterpret_cast<TIn*>(sm + L::raw) + (p % PD) * CT * L::RAWROW;
  }
  __device__ float* plane(int base, int p) const {
    return sm + base + (p % (PD + 1)) * CT * DKP;
  }
  __device__ float* vbuf(int p) const {
    return sm + L::v + (p % (PD + 2)) * CT * NCOL;
  }
  // where piece m's f32 values go in pass p
  __device__ float* dest(int m, int p) const {
    const int z = kind[m];
    return (z == 2 ? vbuf(p) : plane(z == 0 ? L::r : z == 1 ? L::k : L::w, p))
           + at_[m];
  }

  __device__ void issue(int p, int n) const {
#pragma unroll
    for (int m = 0; m < MAXP; ++m) {
      if (kind[m] < 0 || t_[m] >= n) continue;
      const char* s = src[m] + p * step[m];
      if (L::RAW && kind[m] < 3)
        mt::cp_async16(raw(p) + raw_at[m], s);
      else
        mt::cp_async16(dest(m, p), s);
    }
  }

  __device__ void finish(int p, int n) const {
    if (a.vec) {
      if constexpr (L::RAW) {
#pragma unroll
        for (int m = 0; m < MAXP; ++m) {
          if (kind[m] < 0 || kind[m] == 3 || t_[m] >= n) continue;
          const uint4 piece =
              *reinterpret_cast<const uint4*>(raw(p) + raw_at[m]);
          const __nv_bfloat162* p2 =
              reinterpret_cast<const __nv_bfloat162*>(&piece);
          float4* d = reinterpret_cast<float4*>(dest(m, p));
          const float2 x0 = __bfloat1622float2(p2[0]);
          const float2 x1 = __bfloat1622float2(p2[1]);
          const float2 x2 = __bfloat1622float2(p2[2]);
          const float2 x3 = __bfloat1622float2(p2[3]);
          d[0] = make_float4(x0.x, x0.y, x1.x, x1.y);
          d[1] = make_float4(x2.x, x2.y, x3.x, x3.y);
        }
      }
      return;
    }
    const int t0 = p * CT, per = 3 * a.dk + nc;  // elements a step
    const TIn* r = static_cast<const TIn*>(a.r);
    const TIn* k = static_cast<const TIn*>(a.k);
    const TIn* v = static_cast<const TIn*>(a.v);
    for (int e = tid; e < n * per; e += THREADS) {
      const int t = e / per, q = e % per, tt = t0 + t;
      if (q < a.dk)
        plane(L::r, p)[t * DKP + q] = f32(r[at(a.sr, b, h, tt) + q]);
      else if (q < 2 * a.dk)
        plane(L::k, p)[t * DKP + q - a.dk] =
            f32(k[at(a.sk, b, h, tt) + q - a.dk]);
      else if (q < 3 * a.dk)
        plane(L::w, p)[t * DKP + q - 2 * a.dk] =
            a.w[at(a.sw, b, h, tt) + q - 2 * a.dk];
      else
        vbuf(p)[t * NCOL + q - 3 * a.dk] =
            f32(v[at(a.sv, b, h, tt) + j0 + q - 3 * a.dk]);
    }
  }
};

template <int R>
__device__ __forceinline__ void load_rows(float (&d)[R], const float* s) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(s + i);
      d[i] = q.x;
      d[i + 1] = q.y;
      d[i + 2] = q.z;
      d[i + 3] = q.w;
    }
  } else if constexpr (R == 2) {
    const float2 q = *reinterpret_cast<const float2*>(s);
    d[0] = q.x;
    d[1] = q.y;
  } else {
    d[0] = s[0];
  }
}

// grid (B * H, ceil(Dv / NCOL)), THREADS threads: thread tid is (row group
// rg = tid / (NCOL / CW), column group cg = tid % (NCOL / CW)).  Round kk:
// issue pass kk + PD's copies; add up pass kk - 1's outputs; take pass
// kk's bonus scalars and scan its steps; convert pass kk + 1's pieces
// (landed: PD - 1 later passes may still be in flight); barrier.
template <typename TIn, int DKP>
__global__ void __launch_bounds__(THREADS)
    rwkv6_kernel(const __grid_constant__ Args a) {
  using L = Layout<TIn, DKP>;
  constexpr int R = DKP / RG, CT = L::CT;
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.y * NCOL, nc = min(NCOL, a.dv - j0);
  const int cg = tid % (NCOL / CW), rg = tid / (NCOL / CW);
  Stage<TIn, DKP> stage{a, sm, b, h, j0, nc, tid};
  if (a.vec) stage.init();
  const int nch = (a.T + CT - 1) / CT;
  auto steps = [&](int p) { return min(CT, a.T - p * CT); };

  // rows past dk and columns past nc stay zero in every buffer (copies
  // never touch them), so their S stays 0 and they add nothing
  for (int i = tid; i < L::p; i += THREADS) sm[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < a.dk; i += THREADS) sm[L::u + i] = a.u[h * a.dk + i];
  for (int p = 0; p < PD; ++p) {  // one cp.async group a pass, empty or not
    if (a.vec && p < nch) stage.issue(p, steps(p));
    mt::cp_commit();
  }
  mt::cp_wait<PD - 1>();
  stage.finish(0, steps(0));
  __syncthreads();

  float S[R][CW];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) S[i][c] = 0.f;

  for (int kk = 0; kk <= nch; ++kk) {
    if (a.vec && kk + PD < nch) stage.issue(kk + PD, steps(kk + PD));
    mt::cp_commit();
    if (kk > 0) {  // pass kk - 1's outputs, partials in row-group order
      const int p = kk - 1, np = steps(p);
      const float* part = sm + L::p + (p & 1) * CT * RG * NCOL;
      const float* vs = stage.vbuf(p);
      const float* cs = sm + L::c + (p & 1) * CT;
      // four neighbouring columns a thread: 16-byte reads of the partials
      for (int e = tid; e < np * (NCOL / 4); e += THREADS) {
        const int t = e / (NCOL / 4), j = 4 * (e % (NCOL / 4));
        if (j >= nc) continue;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int g = 0; g < RG; ++g) {
          const float4 q =
              *reinterpret_cast<const float4*>(part + (t * RG + g) * NCOL + j);
          s.x += q.x;
          s.y += q.y;
          s.z += q.z;
          s.w += q.w;
        }
        const float4 vq = *reinterpret_cast<const float4*>(vs + t * NCOL + j);
        float* orow = a.o + at(a.so, b, h, p * CT + t) + j0 + j;
        const float y[4] = {fmaf(vq.x, cs[t], s.x), fmaf(vq.y, cs[t], s.y),
                            fmaf(vq.z, cs[t], s.z), fmaf(vq.w, cs[t], s.w)};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < nc) orow[q] = y[q];
      }
    }
    if (kk < nch) {
      const int n = steps(kk);
      const float* rs = stage.plane(L::r, kk);
      const float* ks = stage.plane(L::k, kk);
      const float* ws = stage.plane(L::w, kk);
      const float* vs = stage.vbuf(kk);
      float* part = sm + L::p + (kk & 1) * CT * RG * NCOL;
      // the bonus scalars r_t . (u * k_t): a warp a step
      for (int t = warp; t < n; t += THREADS / 32) {
        float c = 0.f;
        for (int i = lane; i < DKP; i += 32)
          c = fmaf(rs[t * DKP + i], sm[L::u + i] * ks[t * DKP + i], c);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          c += __shfl_xor_sync(0xffffffffu, c, off);
        if (lane == 0) sm[L::c + (kk & 1) * CT + t] = c;
      }
      // the scan: step t + 1's operands are read while step t computes
      float r[R], k[R], w[R], v[CW];
      auto load = [&](int t, float (&r_)[R], float (&k_)[R], float (&w_)[R],
                      float (&v_)[CW]) {
        load_rows<R>(r_, rs + t * DKP + rg * R);
        load_rows<R>(k_, ks + t * DKP + rg * R);
        load_rows<R>(w_, ws + t * DKP + rg * R);
        load_rows<CW>(v_, vs + t * NCOL + cg * CW);
      };
      load(0, r, k, w, v);
      for (int t = 0; t < n; ++t) {
        float r2[R], k2[R], w2[R], v2[CW];
        load(t + 1 < n ? t + 1 : t, r2, k2, w2, v2);
        float o[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c) o[c] = 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            o[c] = fmaf(r[i], S[i][c], o[c]);
            S[i][c] = fmaf(w[i], S[i][c], k[i] * v[c]);
          }
        *reinterpret_cast<float4*>(part + (t * RG + rg) * NCOL + cg * CW) =
            make_float4(o[0], o[1], o[2], o[3]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          r[i] = r2[i];
          k[i] = k2[i];
          w[i] = w2[i];
        }
#pragma unroll
        for (int c = 0; c < CW; ++c) v[c] = v2[c];
      }
    }
    if (kk + 1 < nch) {
      mt::cp_wait<PD - 1>();
      stage.finish(kk + 1, steps(kk + 1));
    }
    if (kk < nch) __syncthreads();
  }
}

template <typename TIn, int DKP>
int launch_t(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = Layout<TIn, DKP>::bytes;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = rwkv6_kernel<TIn, DKP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * a.H, (a.dv + NCOL - 1) / NCOL);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TIn>
int launch_dk(const Args& a, int B, cudaStream_t s) {
  auto f = a.dk <= 16   ? launch_t<TIn, 16>
           : a.dk <= 32 ? launch_t<TIn, 32>
           : a.dk <= 64 ? launch_t<TIn, 64>
                        : launch_t<TIn, 128>;
  return f(a, B, s);
}

bool aligned(const void* p, const Strides& s, size_t elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b * elem % 16 == 0 &&
         s.h * elem % 16 == 0 && s.t * elem % 16 == 0;
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
  const size_t e = kind == 0 ? 2 : 4;  // bytes of an r / k / v element
  Args a{r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),
         static_cast<float*>(o), st[0], st[1], st[2], st[3], st[4], H, T, dk,
         dv, false};
  a.vec = aligned(r, st[0], e) && aligned(k, st[1], e) &&
          aligned(v, st[2], e) && aligned(w, st[3], 4) && dk * e % 16 == 0 &&
          dv * e % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) return launch_dk<__nv_bfloat16>(a, B, s);
  return launch_dk<float>(a, B, s);
}
