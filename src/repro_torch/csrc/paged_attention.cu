// Paged attention for Hopper: decode (one query per sequence, K2) and
// chunked prefill (C queries per sequence at their own positions, K3)
// against the page pool, through the page table, with an online softmax.
//
// Replaces the TPU kernels `_paged_kernel` (decode, launched by
// `paged_attention_pallas`) and `_paged_chunk_kernel` (chunk, launched by
// `paged_attention_pallas_chunk`) of src/repro/kvstore/paged_attention.py.
//
//   q       [B, H, C, Dh]            bf16 or f32, upcast to f32 (decode: C=1)
//   pages   [n_pages, Hkv, ps, Dh]   bf16, or int8 times scale [n_pages, Hkv]
//   table   [B, npp] int32           -1 = no page (reads page 0, masked)
//   q_pos   [B, C] int32, window int -> out [B, H, C, Dh] f32
//
// Semantics are the TPU kernels': s = (q . k) * scale, then softcap, then
// s = -1e30 where table < 0, pos > q_pos or (window >= 0 and pos <= q_pos -
// window), with pos = table_index * ps + offset and q_pos the query's own
// position.  The finite -1e30 (never -inf) makes a row with no valid key,
// as an idle batch slot or a padded chunk query gives, come out as the
// mean of the V rows it visited rather than NaN, as on the TPU.  Output is
// acc / max(l, 1e-30).
//
// What bounds it: bytes.  Each K/V element read feeds G * qt multiply-adds
// (G = H / Hkv query heads per kv head, qt chunk queries per block), far
// below the card's operations-per-byte balance, so the floor is reading
// each live page once.  At short contexts a launch reads only a few pages,
// and launch latency dominates.
//
// Design:
//  * One block per (sequence, kv head, query tile, page range); one warp
//    per query row of the [G, qt] block, so the block's G * qt <= 32 rows
//    share every page load.  Each lane owns Dh / 32 consecutive dimensions
//    of q and of the accumulator.  Decode is the chunk kernel at C = qt = 1.
//  * A page is staged once into shared memory as f32 (dequantised for
//    int8), then each warp takes its ps scores by warp-shuffle sums.
//  * Each row is masked against its own q_pos.  Pages past the tile's
//    largest q_pos are masked for every row, so the page loop stops at the
//    page holding it (clamped to the table): work follows the sequence's
//    length, not the table width, and a padded query row never reads past
//    the table.  A page fully masked for a row that has seen a valid key
//    leaves its (m, l, acc) exactly unchanged (corr = 1, p = 0).  (The TPU
//    kernels' npp_bucket padding is a compile-cache device CUDA does not
//    need.)
//  * Few (sequence, kv head, tile) triples would leave most SMs idle, so
//    the page range is split over blockIdx.y; each split writes its
//    (m, l, acc) and a second pass merges them in split order.  No atomics.
//    The wrapper sizes the split from the block count, so a C = 1 chunk
//    runs exactly the decode launch and is bit-identical to it.
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

// grid (B * Hkv * C / qt, nsplit), block (32, G * qt).  Shared: K and V
// page as f32 ([ps][Dh] each) and the scores of one page ([G * qt][ps]).
template <typename QT, typename PT, int DPL>
__global__ void paged_attn(const QT* __restrict__ q,
                           const PT* __restrict__ kp,
                           const PT* __restrict__ vp,
                           const float* __restrict__ ks,
                           const float* __restrict__ vs,
                           const int* __restrict__ table,
                           const int* __restrict__ q_pos, int c, int qt,
                           int window, float scale, float cap, int has_cap,
                           int hkv, int ps, int npp, int pages_per_split,
                           float* __restrict__ out,
                           float* __restrict__ part) {
  constexpr int DH = 32 * DPL;
  extern __shared__ float sm[];
  float* k_s = sm;                   // [ps][DH]
  float* v_s = k_s + ps * DH;        // [ps][DH]
  float* sc = v_s + ps * DH;         // [rows][ps]
  const int lane = threadIdx.x, w = threadIdx.y, rows = blockDim.y;
  const int tid = w * 32 + lane, nthr = 32 * rows;
  const int G = rows / qt, nq = c / qt;
  const int qi = blockIdx.x % nq, bk = blockIdx.x / nq;
  const int b = bk / hkv, hk = bk % hkv;
  const int g = w / qt, ci = qi * qt + w % qt;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int h = hk * G + g, H = hkv * G;
  const int* pos_b = q_pos + (size_t)b * c;
  const int cur = pos_b[ci];
  int tile_max = pos_b[qi * qt];
  for (int i = 1; i < qt; ++i) tile_max = max(tile_max, pos_b[qi * qt + i]);

  const size_t row = ((size_t)b * H + h) * c + ci;
  float qv[DPL], acc[DPL];
  const QT* qr = q + row * DH + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qv[i] = to_f32<QT>(qr[i]);
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const int last = min(npp - 1, tile_max / ps);  // pages beyond are masked
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
      if (lane == 0) sc[w * ps + j] = s;
      m_page = fmaxf(m_page, s);
    }
    __syncwarp();
    const float m_new = fmaxf(m, m_page);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
    for (int j = 0; j < ps; ++j) {
      const float p = expf(sc[w * ps + j] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] += p * v_s[j * DH + lane * DPL + i];
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (nsplit == 1) {
    float* o = out + row * DH + lane * DPL;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = acc[i] * inv;
    return;
  }
  // partials: m, l [B*H*C, nsplit], acc [B*H*C, nsplit, DH]
  float* pm = part;
  float* pl = pm + (size_t)gridDim.x * rows * nsplit;
  float* pa = pl + (size_t)gridDim.x * rows * nsplit;
  if (lane == 0) {
    pm[row * nsplit + split] = m;
    pl[row * nsplit + split] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    pa[(row * nsplit + split) * DH + lane * DPL + i] = acc[i];
}

// Second pass: merge the nsplit (m, l, acc) partials of each query row.
// grid (B * H * C), block (DH).
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
           const float* vs, const int* table, const int* q_pos, int c,
           int qt, int window, float scale, float cap, int has_cap,
           int batch, int h, int hkv, int ps, int npp, int nsplit,
           int pages_per_split, float* part, float* out,
           cudaStream_t stream) {
  constexpr int DH = 32 * DPL;
  const int rows = h / hkv * qt;
  const size_t smem = (size_t)(2 * ps * DH + rows * ps) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(batch * hkv * (c / qt), nsplit), block(32, rows);
  paged_attn<QT, PT, DPL><<<grid, block, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), ks, vs, table, q_pos, c, qt, window,
      scale, cap, has_cap, hkv, ps, npp, pages_per_split, out, part);
  if (nsplit > 1)
    paged_combine<<<batch * h * c, DH, 0, stream>>>(part, batch * h * c,
                                                    nsplit, DH, out);
  return (int)cudaGetLastError();
}

template <typename QT, typename PT>
int by_head_dim(int dh, const void* q, const void* kp, const void* vp,
                const float* ks, const float* vs, const int* table,
                const int* q_pos, int c, int qt, int window, float scale,
                float cap, int has_cap, int batch, int h, int hkv, int ps,
                int npp, int nsplit, int pages_per_split, float* part,
                float* out, cudaStream_t stream) {
#define PA_CALL(DPL)                                                        \
  return launch<QT, PT, DPL>(q, kp, vp, ks, vs, table, q_pos, c, qt,        \
                             window, scale, cap, has_cap, batch, h, hkv,    \
                             ps, npp, nsplit, pages_per_split, part, out,   \
                             stream)
  if (dh == 32) PA_CALL(1);
  if (dh == 64) PA_CALL(2);
  if (dh == 128) PA_CALL(4);
  if (dh == 256) PA_CALL(8);
#undef PA_CALL
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_kind: 0 = bf16, 1 = f32.  page_kind: 0 = bf16, 1 = int8 (ks/vs given).
// qt must divide c, with (h / hkv) * qt <= 32.  part: scratch of
// batch * h * c * nsplit * (dh + 2) floats (unused if nsplit == 1).
// Returns the cudaError_t of the launches.
extern "C" int paged_attention_chunk_launch(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* q_pos, void* part,
    void* out, int q_kind, int page_kind, int batch, int h, int hkv, int dh,
    int c, int qt, int ps, int npp, int window, float scale, float cap,
    int has_cap, int nsplit, int pages_per_split, void* stream) {
  if (hkv <= 0 || h % hkv != 0 || c <= 0 || qt <= 0 || c % qt != 0 ||
      h / hkv * qt > 32 || nsplit <= 0 || ps <= 0 ||
      (page_kind == 1 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* ksf = page_kind == 1 ? static_cast<const float*>(ks) : nullptr;
  const float* vsf = page_kind == 1 ? static_cast<const float*>(vs) : nullptr;
  const int* tb = static_cast<const int*>(table);
  const int* qp = static_cast<const int*>(q_pos);
  float* pt = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_KIND(QT, PT)                                                     \
  return by_head_dim<QT, PT>(dh, q, kp, vp, ksf, vsf, tb, qp, c, qt, window, \
                             scale, cap, has_cap, batch, h, hkv, ps, npp,   \
                             nsplit, pages_per_split, pt, o, s)
  if (q_kind == 0 && page_kind == 0) PA_KIND(__nv_bfloat16, __nv_bfloat16);
  if (q_kind == 0 && page_kind == 1) PA_KIND(__nv_bfloat16, int8_t);
  if (q_kind == 1 && page_kind == 0) PA_KIND(float, __nv_bfloat16);
  if (q_kind == 1 && page_kind == 1) PA_KIND(float, int8_t);
#undef PA_KIND
  return (int)cudaErrorInvalidValue;
}

