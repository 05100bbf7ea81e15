// Paged-attention decode for Hopper: one query token per sequence against
// the page pool, through the page table, with an online softmax.
//
// Replaces the TPU kernel `_paged_kernel` of
// src/repro/kvstore/paged_attention.py (launched by `paged_attention_pallas`).
//
//   q       [B, H, Dh]               bf16 or f32, upcast to f32
//   pages   [n_pages, Hkv, ps, Dh]   bf16, or int8 times scale [n_pages, Hkv]
//   table   [B, npp] int32           -1 = no page (reads page 0, masked)
//   cur_pos [B] int32, window int    -> out [B, H, Dh] f32
//
// Semantics are the TPU kernel's: s = (q . k) * scale, then softcap, then
// s = -1e30 where table < 0, pos > cur or (window >= 0 and pos <= cur -
// window), with pos = table_index * ps + offset.  The finite -1e30 (never
// -inf) makes a row with no valid key, as an idle batch slot gives, come
// out as the mean of the page-0 V rows rather than NaN, as on the TPU.
// Output is acc / max(l, 1e-30).
//
// What bounds it: bytes.  Each K/V element read feeds G = H / Hkv
// multiply-adds, far below the card's operations-per-byte balance, so the
// floor is reading each live page once.
//
// Design:
//  * One block per (sequence, kv head, page range); one warp per query row
//    of the GQA group, so the group's G rows share every page load.  Each
//    lane owns Dh / 32 consecutive dimensions of q and of the accumulator.
//  * A page is staged once into shared memory as f32 (dequantised for
//    int8), then each warp takes its ps scores by warp-shuffle sums.
//  * Pages past cur_pos are masked for every offset, so the page loop stops
//    at the page holding cur_pos: the work follows the sequence's length,
//    not the table width.  (The TPU kernel's npp_bucket padding is a
//    compile-cache device that CUDA does not need.)
//  * Few (sequence, kv head) pairs would leave most SMs idle, so the page
//    range is split over blockIdx.y; each split writes its (m, l, acc) and
//    a second pass merges them in split order.  No atomics.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return (float)v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (B * Hkv, nsplit), block (32, G).  Shared: K and V page as f32
// ([ps][Dh] each) and the scores of one page ([G][ps]).
template <typename QT, typename PT, int DPL>
__global__ void paged_decode(const QT* __restrict__ q,
                             const PT* __restrict__ kp,
                             const PT* __restrict__ vp,
                             const float* __restrict__ ks,
                             const float* __restrict__ vs,
                             const int* __restrict__ table,
                             const int* __restrict__ cur_pos, int window,
                             float scale, float cap, int has_cap, int hkv,
                             int ps, int npp, int pages_per_split,
                             float* __restrict__ out,
                             float* __restrict__ part) {
  constexpr int DH = 32 * DPL;
  extern __shared__ float sm[];
  float* k_s = sm;                   // [ps][DH]
  float* v_s = k_s + ps * DH;        // [ps][DH]
  float* sc = v_s + ps * DH;         // [G][ps]
  const int lane = threadIdx.x, g = threadIdx.y, G = blockDim.y;
  const int tid = g * 32 + lane, nthr = 32 * G;
  const int b = blockIdx.x / hkv, hk = blockIdx.x % hkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int h = hk * G + g, H = hkv * G;
  const int cur = cur_pos[b];

  float qv[DPL], acc[DPL];
  const QT* qr = q + ((size_t)b * H + h) * DH + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qv[i] = to_f32<QT>(qr[i]);
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const int last = min(npp - 1, cur / ps);      // pages beyond are masked
  const int p0 = split * pages_per_split;
  const int p1 = min(p0 + pages_per_split, last + 1);
  for (int t = p0; t < p1; ++t) {
    const int entry = table[(size_t)b * npp + t];
    const int page = entry < 0 ? 0 : entry;
    const size_t off = ((size_t)page * hkv + hk) * ps * DH;
    const float ksc = ks != nullptr ? ks[(size_t)page * hkv + hk] : 1.f;
    const float vsc = vs != nullptr ? vs[(size_t)page * hkv + hk] : 1.f;
    __syncthreads();                             // previous page consumed
    for (int e = tid; e < ps * DH; e += nthr) {
      float kf = to_f32<PT>(kp[off + e]), vf = to_f32<PT>(vp[off + e]);
      if (ks != nullptr) {
        kf *= ksc;
        vf *= vsc;
      }
      k_s[e] = kf;
      v_s[e] = vf;
    }
    __syncthreads();
    float m_page = NEG_INF;
    for (int j = 0; j < ps; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) d += qv[i] * k_s[j * DH + lane * DPL + i];
      float s = warp_sum(d) * scale;
      if (has_cap) s = cap * tanhf(s / cap);
      const int pos = t * ps + j;
      bool valid = entry >= 0 && pos <= cur;
      if (window >= 0) valid = valid && pos > cur - window;
      s = valid ? s : NEG_INF;
      if (lane == 0) sc[g * ps + j] = s;
      m_page = fmaxf(m_page, s);
    }
    __syncwarp();
    const float m_new = fmaxf(m, m_page);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
    for (int j = 0; j < ps; ++j) {
      const float p = expf(sc[g * ps + j] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] += p * v_s[j * DH + lane * DPL + i];
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (nsplit == 1) {
    float* o = out + ((size_t)b * H + h) * DH + lane * DPL;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = acc[i] * inv;
    return;
  }
  // partials: m, l [B*H, nsplit], acc [B*H, nsplit, DH]
  const size_t row = (size_t)b * H + h;
  float* pm = part;
  float* pl = pm + (size_t)gridDim.x * G * nsplit;
  float* pa = pl + (size_t)gridDim.x * G * nsplit;
  if (lane == 0) {
    pm[row * nsplit + split] = m;
    pl[row * nsplit + split] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    pa[(row * nsplit + split) * DH + lane * DPL + i] = acc[i];
}

// Second pass: merge the nsplit (m, l, acc) partials of each query row.
// grid (B * H), block (DH).
__global__ void paged_combine(const float* __restrict__ part, int rows,
                              int nsplit, int dh, float* __restrict__ out) {
  const int row = blockIdx.x, d = threadIdx.x;
  const float* pm = part;
  const float* pl = pm + (size_t)rows * nsplit;
  const float* pa = pl + (size_t)rows * nsplit;
  float mx = NEG_INF;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pm[row * nsplit + s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(pm[row * nsplit + s] - mx);
    l += w * pl[row * nsplit + s];
    acc += w * pa[((size_t)row * nsplit + s) * dh + d];
  }
  out[(size_t)row * dh + d] = acc / fmaxf(l, 1e-30f);
}

template <typename QT, typename PT, int DPL>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* table, const int* cur_pos, int window,
           float scale, float cap, int has_cap, int batch, int h, int hkv,
           int ps, int npp, int nsplit, int pages_per_split, float* part,
           float* out, cudaStream_t stream) {
  constexpr int DH = 32 * DPL;
  const int G = h / hkv;
  const size_t smem = (size_t)(2 * ps * DH + G * ps) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(batch * hkv, nsplit), block(32, G);
  paged_decode<QT, PT, DPL><<<grid, block, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), ks, vs, table, cur_pos, window, scale, cap,
      has_cap, hkv, ps, npp, pages_per_split, out, part);
  if (nsplit > 1)
    paged_combine<<<batch * h, DH, 0, stream>>>(part, batch * h, nsplit, DH,
                                                out);
  return (int)cudaGetLastError();
}

template <typename QT, typename PT>
int by_head_dim(int dh, const void* q, const void* kp, const void* vp,
                const float* ks, const float* vs, const int* table,
                const int* cur_pos, int window, float scale, float cap,
                int has_cap, int batch, int h, int hkv, int ps, int npp,
                int nsplit, int pages_per_split, float* part, float* out,
                cudaStream_t stream) {
#define PA_CALL(DPL)                                                        \
  return launch<QT, PT, DPL>(q, kp, vp, ks, vs, table, cur_pos, window,     \
                             scale, cap, has_cap, batch, h, hkv, ps, npp,   \
                             nsplit, pages_per_split, part, out, stream)
  if (dh == 32) PA_CALL(1);
  if (dh == 64) PA_CALL(2);
  if (dh == 128) PA_CALL(4);
  if (dh == 256) PA_CALL(8);
#undef PA_CALL
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_kind: 0 = bf16, 1 = f32.  page_kind: 0 = bf16, 1 = int8 (ks/vs given).
// part: scratch of batch * h * nsplit * (dh + 2) floats (unused if
// nsplit == 1).  Returns the cudaError_t of the launches.
extern "C" int paged_attention_decode_launch(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* cur_pos, void* part,
    void* out, int q_kind, int page_kind, int batch, int h, int hkv, int dh,
    int ps, int npp, int window, float scale, float cap, int has_cap,
    int nsplit, int pages_per_split, void* stream) {
  if (hkv <= 0 || h % hkv != 0 || h / hkv > 32 || nsplit <= 0 || ps <= 0 ||
      (page_kind == 1 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* ksf = page_kind == 1 ? static_cast<const float*>(ks) : nullptr;
  const float* vsf = page_kind == 1 ? static_cast<const float*>(vs) : nullptr;
  const int* tb = static_cast<const int*>(table);
  const int* cp = static_cast<const int*>(cur_pos);
  float* pt = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_KIND(QT, PT)                                                     \
  return by_head_dim<QT, PT>(dh, q, kp, vp, ksf, vsf, tb, cp, window, scale, \
                             cap, has_cap, batch, h, hkv, ps, npp, nsplit,  \
                             pages_per_split, pt, o, s)
  if (q_kind == 0 && page_kind == 0) PA_KIND(__nv_bfloat16, __nv_bfloat16);
  if (q_kind == 0 && page_kind == 1) PA_KIND(__nv_bfloat16, int8_t);
  if (q_kind == 1 && page_kind == 0) PA_KIND(float, __nv_bfloat16);
  if (q_kind == 1 && page_kind == 1) PA_KIND(float, int8_t);
#undef PA_KIND
  return (int)cudaErrorInvalidValue;
}
