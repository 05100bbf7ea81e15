// FC product shared by the int8 (K4) and codebook4 (K5) kernels:
// out[M, N] = act(x[M, K] @ W[N, K]^T * scale[n] + bias[n]), with W kept
// compressed in device memory and decoded in registers straight into the
// tensor cores' A fragments.
//
// What bounds it: the compressed weight bytes (1 or 1/2 a weight) at
// both of the serve's shapes, M = 4 (decode) and M = 32 (a chunk-8 step):
// each weight feeds M multiply-adds, far below the card's balance.
//
// Design:
//  * A block owns CG channel groups of BN = 64 output channels (weight
//    rows) x MR = 8 * MT rows of x (MT = 1 and one group up to 8 rows;
//    MT = 4 and CG4 groups beyond, so each x row staged serves more
//    channels) over one K range of the split plan (kernels/fc_tile.py:
//    split_plan, which no row count enters) and walks it in stages of
//    BK = 128 k.
//  * Stages travel compressed: 16-byte cp.async of the weight rows (128 B
//    a row and stage for int8, 64 B for 4-bit codes) and of x's f32 rows
//    into a ring of NS stages in shared memory, NS - 1 of them in flight
//    while one is computed.  Rows past N, rows past M and k past K are
//    zero-filled.  Operands that are not 16-byte aligned take byte loads
//    into the same ring (same arithmetic, slower).
//  * Warp w of a group's 4 takes k 32w .. 32w + 31 of every stage for the
//    group's 64 channels: the weights are A (16 channels x 16 k, four
//    channel tiles), x's rows are B's 8 columns (MT n8 tiles), on mma.sync
//    m16n8k16 with bf16 operands and f32 sums.  k enters the tensor cores
//    permuted (the same way on both sides, so the products are unchanged):
//    in step j of 2, lane c of a quad holds physical k 32w + 8c + 4j .. + 3,
//    so its weights are one 8-byte (int8) or 4-byte (codes) shared load a
//    row and stage, its x values one 16-byte load a row and step.  Weight
//    rows are swizzled by 16-byte unit, x rows padded: no load conflicts.
//  * The weight policy decodes in registers: int8 to bf16 exactly (a
//    float magic number), a code byte to a (even k, odd k) bf16 pair by
//    one look-up in a 256-entry table the block builds from the 16
//    centroids (low nibble = even k), each centroid split into hi + lo.
//    No f32 or bf16 weight tile is ever written to shared memory.
//  * The reference's f32 product on bf16 tensor cores: x is split into
//    bf16 hi + lo as it is read (mma_tile.cuh); K4 runs x_hi q + x_lo q
//    (q is exact in bf16), K5 c_hi x_hi + c_hi x_lo + c_lo x_hi.  Scale,
//    bias and activation run in an f32 epilogue.
//  * A group's four k slices are added in order.  With a K split, each
//    block writes its partial tile and the tile's last block to finish (an
//    int counter per tile, reset by that block) adds the partials in split
//    order and runs the epilogue: one launch, no atomic adds of values,
//    results repeat bit for bit, and a row's sum order is the same in any
//    batch (the tensor cores give a row the same bits in any column).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace fc {

constexpr int BN = 64;               // output channels of a channel group
constexpr int BK = 128;              // k of a stage
constexpr int NS = 4;                // stages in the ring
constexpr int XLD = BK + 4;          // x row stride in a stage (floats)
constexpr int CG4 = 2;               // channel groups a block beyond 8 rows

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

// A block: CG channel groups of BN x MR = 8 * MT rows of x, 4 warps a
// group (warp w takes k 32w .. 32w + 31 of every stage).  Shared memory:
// the ring (weights then x, per stage), then the policy's table; after
// the walk it holds the warps' sums.
template <int MT, int CG, typename W>
struct Layout {
  static constexpr int MR = 8 * MT, BNB = CG * BN, NT = 128 * CG;
  static constexpr int RLD = BNB + 1;  // row stride of the warps' sums
  static constexpr int WBYTES = BNB * W::ROW;
  static constexpr int STAGE = WBYTES + MR * XLD * 4;
  static constexpr int TOTAL = NS * STAGE + W::TABLE;
  static_assert(4 * MR * RLD * 4 <= TOTAL, "the sums fit");
};

// Copy one 16-byte unit: cp.async when `vec`, else byte loads (src need
// not be aligned); `valid` bytes from src, the rest zero.
__device__ __forceinline__ void copy16(void* dst, const uint8_t* src,
                                       int valid, bool vec) {
  if (vec) {
    mt::cp_async16_zfill(dst, src, valid > 0);
    return;
  }
  union {
    uint4 v;
    uint8_t b[16];
  } u;
#pragma unroll
  for (int i = 0; i < 16; ++i) u.b[i] = i < valid ? src[i] : (uint8_t)0;
  *reinterpret_cast<uint4*>(dst) = u.v;
}

// grid (ceil(N / BNB), ceil(M / MR), ksplit), block NT.  Split s sums k in
// [s * kps, min(K, (s + 1) * kps)); `part` holds ksplit x [M, N] partials
// and `cnt` one counter per (n tile, m tile), both unused if ksplit == 1.
// The policy `w` carries the compressed rows (and K5's centroids).
template <int MT, int CG, typename W>
__global__ void __launch_bounds__(128 * CG)
    fc_mma(W w, const float* __restrict__ x, int M, int N, int K, int kps,
           bool vec, const float* __restrict__ scale,
           const float* __restrict__ bias, int act, float* __restrict__ out,
           float* __restrict__ part, int* __restrict__ cnt) {
  using L = Layout<MT, CG, W>;
  constexpr int MR = L::MR, BNB = L::BNB, NT = L::NT, RLD = L::RLD;
  constexpr int ROW = W::ROW, UNITS = ROW / 16;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* table = smem + NS * L::STAGE;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32 % 4, ch0 = tid / 128 * BN;  // k slice, group
  const int g = lane / 4, c = lane % 4;
  const int n0 = blockIdx.x * BNB, m0 = blockIdx.y * MR;
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int kbeg = split * kps, kend = min(K, kbeg + kps);
  const int nst = (kend - kbeg + BK - 1) / BK;
  const int rowbytes = K / W::KPB;
  w.build_table(table, tid, NT);

  // Each thread copies the same WU weight units and XU x units of every
  // stage (16 bytes each), so their addresses are worked out once: stage
  // st adds st * ROW bytes of a row, st * BK floats of x.
  constexpr int WU = BNB * UNITS / NT, XU = MR * (BK / 4) / NT;
  static_assert(WU * NT == BNB * UNITS && XU * NT == MR * (BK / 4),
                "the threads share the units evenly");
  const uint8_t* wsrc[WU];
  const uint8_t* xsrc[XU];
  int wdst[WU], woff[WU], xdst[XU], xoff[XU];
#pragma unroll
  for (int i = 0; i < WU; ++i) {
    const int e = tid + i * NT, r = e / UNITS, u = e % UNITS;
    wdst[i] = r * ROW + 16 * W::swizzle(r, u);
    woff[i] = n0 + r < N ? 16 * u : rowbytes;  // a row past N: none valid
    wsrc[i] = w.rows + (size_t)min(n0 + r, N - 1) * rowbytes +
              kbeg / W::KPB + 16 * u;
  }
#pragma unroll
  for (int i = 0; i < XU; ++i) {
    const int e = tid + i * NT, r = e / (BK / 4), u = e % (BK / 4);
    xdst[i] = L::WBYTES + 4 * (r * XLD + 4 * u);
    xoff[i] = m0 + r < M ? 4 * u : K;
    xsrc[i] = reinterpret_cast<const uint8_t*>(
        x + (size_t)min(m0 + r, M - 1) * K + kbeg + 4 * u);
  }

  // stage st: weight rows n0 .. + BNB at k kbeg + st * BK, then x rows m0 ..
  // + MR, into ring slot st % NS; bytes past a row's end are zero-filled
  auto fetch = [&](int st) {
    uint8_t* ws = smem + (st % NS) * L::STAGE;
    const int wleft = rowbytes - kbeg / W::KPB - st * ROW;  // bytes a row
    const int xleft = K - kbeg - st * BK;                   // x values a row
#pragma unroll
    for (int i = 0; i < WU; ++i)
      copy16(ws + wdst[i], wsrc[i] + st * ROW,
             min(16, max(0, wleft - woff[i])), vec);
#pragma unroll
    for (int i = 0; i < XU; ++i)
      copy16(ws + xdst[i], xsrc[i] + 4 * st * BK,
             4 * min(4, max(0, xleft - xoff[i])), vec);
  };

  float acc[4][MT][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][t][i] = 0.f;

  // ring slot `slot` into the accumulators: warp w's k 32w .. 32w + 31
  auto compute = [&](int slot) {
    const uint8_t* ws = smem + slot * L::STAGE;
    const float* xs = reinterpret_cast<const float*>(ws + L::WBYTES);
    // B fragments, hi and lo, of both steps: x[8t + g][32w + 8c + 4j ..]
    uint32_t bh[2][MT][2], bl[2][MT][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(
            xs + (8 * t + g) * XLD + 32 * warp + 8 * c + 4 * j);
        mt::split2(v.x, v.y, bh[j][t][0], bl[j][t][0]);
        mt::split2(v.z, v.w, bh[j][t][1], bl[j][t][1]);
      }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const auto r0 = W::load(ws, ch0 + 16 * q + g, warp, c);
      const auto r1 = W::load(ws, ch0 + 16 * q + g + 8, warp, c);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t ah[4], al[4];
        W::decode(r0, r1, j, table, lane, ah, al);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          mt::mma(acc[q][t], ah, bh[j][t]);
          mt::mma(acc[q][t], ah, bl[j][t]);
          if constexpr (W::LO) mt::mma(acc[q][t], al, bh[j][t]);
        }
      }
    }
  };

#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < nst) fetch(st);
    mt::cp_commit();
  }
  for (int st = 0; st < nst; ++st) {
    mt::cp_wait<NS - 2>();
    __syncthreads();  // stage st landed; slot (st - 1) % NS consumed
    if (st + NS - 1 < nst) fetch(st + NS - 1);
    mt::cp_commit();
    compute(st % NS);
  }
  mt::cp_wait<0>();
  __syncthreads();  // every warp done with the ring

  // the warps' sums, [k slice][row][channel], added in k-slice order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ch = ch0 + 16 * q + g + 8 * (i / 2);
        const int r = 8 * t + 2 * c + i % 2;
        red[(warp * MR + r) * RLD + ch] = acc[q][t][i];
      }
  __syncthreads();
  // four neighbouring channels a thread: 16-byte partials where N allows
  constexpr int Q = BNB / 4;
  const bool v4 = N % 4 == 0;
  for (int e = tid; e < MR * Q; e += NT) {
    const int r = e / Q, ch = 4 * (e % Q), m = m0 + r, n = n0 + ch;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = red[r * RLD + ch + i];
#pragma unroll
      for (int k = 1; k < 4; ++k) v[i] += red[(k * MR + r) * RLD + ch + i];
    }
    if (m >= M || n >= N) continue;
    float* dst = nsplit == 1 ? out + (size_t)m * N + n
                             : part + ((size_t)split * M + m) * N + n;
    if (nsplit == 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (n + i < N) dst[i] = epilogue(v[i], n + i, scale, bias, act);
      }
    else if (v4)
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    else
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (n + i < N) dst[i] = v[i];
      }
  }
  if (nsplit == 1) return;

  // The tile's last block to finish adds the partials in split order.
  __shared__ int last;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(cnt + tile, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int U = 8;  // partials in flight a thread
  const size_t step = (size_t)M * N;
  for (int e = tid; e < MR * Q; e += NT) {
    const int m = m0 + e / Q, n = n0 + 4 * (e % Q);
    if (m >= M || n >= N) continue;
    const float* p = part + (size_t)m * N + n;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < nsplit; s0 += U) {
      float b[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float* q = p + (s0 + u) * step;
        if (s0 + u >= nsplit) continue;
        if (v4) {
          const float4 t = __ldcg(reinterpret_cast<const float4*>(q));
          b[u][0] = t.x, b[u][1] = t.y, b[u][2] = t.z, b[u][3] = t.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) b[u][i] = n + i < N ? __ldcg(q + i) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (s0 + u < nsplit) v[i] = s0 + u == 0 ? b[u][i] : v[i] + b[u][i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n + i < N)
        out[(size_t)m * N + n + i] = epilogue(v[i], n + i, scale, bias, act);
  }
  if (tid == 0) cnt[tile] = 0;
}

template <int MT, int CG, typename W>
int launch_mt(const W& w, const float* x, const float* scale,
              const float* bias, float* out, float* part, int* cnt, int M,
              int N, int K, int ksplit, int kps, bool vec, int act,
              cudaStream_t stream) {
  using L = Layout<MT, CG, W>;
  auto kern = fc_mma<MT, CG, W>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::TOTAL);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + L::BNB - 1) / L::BNB, (M + L::MR - 1) / L::MR,
                  ksplit);
  kern<<<grid, L::NT, L::TOTAL, stream>>>(w, x, M, N, K, kps, vec, scale,
                                          bias, act, out, part, cnt);
  return (int)cudaGetLastError();
}

// The plan's ksplit ranges of kps k (a multiple of BK) must cover K with
// none empty; part and cnt are needed only if ksplit > 1 (part: ksplit x
// M x N floats, 16-byte aligned; cnt: one int per tile of BN channels x MR
// rows, 0 before the launch and 0 after it, so launches that share them
// run one at a time, as on one stream).  Up to 8 rows a block takes one
// channel group (4 warps); beyond, CG4 groups, so each row of x staged
// serves more channels.
template <typename W>
int launch(const W& w, const float* x, const float* scale, const float* bias,
           float* out, float* part, int* cnt, int M, int N, int K,
           int ksplit, int kps, int act, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % W::KPB != 0 || ksplit <= 0 ||
      kps <= 0 || kps % BK != 0 || (size_t)(ksplit - 1) * kps >= (size_t)K ||
      (size_t)ksplit * kps < (size_t)K ||
      (ksplit > 1 && (part == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(w.rows) % 16 == 0) &&
                   (K / W::KPB) % 16 == 0;
  if (M <= 8)
    return launch_mt<1, 1>(w, x, scale, bias, out, part, cnt, M, N, K,
                           ksplit, kps, vec, act, stream);
  return launch_mt<4, CG4>(w, x, scale, bias, out, part, cnt, M, N, K,
                           ksplit, kps, vec, act, stream);
}

}  // namespace fc
