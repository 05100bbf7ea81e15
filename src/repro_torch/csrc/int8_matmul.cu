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
// What bounds it: the int8 weight bytes at the serve's row counts (M = 4
// at decode, 32 at a chunk-8 step).
//
// Design: the product of fc_tile.cuh on the tensor cores.  The policy
// below keeps 128 int8 bytes of a row a stage (16-byte units swizzled by
// row, so a quad's 8-byte loads of 16 rows hit distinct banks) and turns
// each lane's 4 bytes of a step into two bf16 pairs exactly, by byte
// permutes and one bf16x2 subtraction a pair.  The scale multiplies the
// merged sum once per output, as the TPU kernel does on its last K step.
#include "fc_tile.cuh"

namespace {

// Four int8 values (bytes 0-3 of w) as bf16 pairs (0, 1) and (2, 3),
// exactly: a byte v = l - 128 s (sign bit s, low bits l < 128) is the
// bf16 with bytes (0x43, l), 128 + l, less the one with bytes (0x43,
// 0x80 s), 128 + 128 s.
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t& p01,
                                          uint32_t& p23) {
  const uint32_t l = w & 0x7f7f7f7fu, s = w & 0x80808080u;
  union {
    uint32_t u;
    __nv_bfloat162 h;
  } a, b, c, d;
  a.u = __byte_perm(l, 0x43434343u, 0x5140);
  b.u = __byte_perm(s, 0x43434343u, 0x5140);
  c.u = __byte_perm(l, 0x43434343u, 0x5342);
  d.u = __byte_perm(s, 0x43434343u, 0x5342);
  a.h = __hsub2(a.h, b.h);
  c.h = __hsub2(c.h, d.h);
  p01 = a.u;
  p23 = c.u;
}

struct Int8Rows {
  static constexpr int ROW = fc::BK;  // bytes of a row in a stage
  static constexpr int KPB = 1;       // k per byte
  static constexpr int TABLE = 0;     // bytes of shared table
  static constexpr bool LO = false;   // q is exact in bf16: no lo part
  const uint8_t* __restrict__ rows;   // q [N, K]

  __device__ __forceinline__ void build_table(uint8_t*, int, int) const {}
  __device__ __forceinline__ static int swizzle(int r, int u) {
    return u ^ ((r & 3) << 1);
  }
  // lane c's 8 bytes of row r: k 32 * warp + 8c .. + 7 of the stage
  __device__ __forceinline__ static uint2 load(const uint8_t* ws, int r,
                                               int warp, int c) {
    const int u = 2 * warp + (c >> 1);
    return *reinterpret_cast<const uint2*>(ws + r * ROW + 16 * swizzle(r, u) +
                                           8 * (c & 1));
  }
  // step j's A fragment from rows g (r0) and g + 8 (r1)
  __device__ __forceinline__ static void decode(uint2 r0, uint2 r1, int j,
                                                const uint8_t*, int,
                                                uint32_t* ah, uint32_t*) {
    i8x4_bf16(j ? r0.y : r0.x, ah[0], ah[2]);
    i8x4_bf16(j ? r1.y : r1.x, ah[1], ah[3]);
  }
};

}  // namespace

// part: scratch of ksplit * M * N floats and cnt: one int per tile of
// BN channels x (8 or 32) rows (both unused if ksplit == 1); the splits
// cover K in kps steps (a multiple of fc::BK), as kernels/fc_tile.py's
// split_plan gives them.  Returns the cudaError_t of the launch.
extern "C" int int8_matmul_launch(const void* x, const void* q,
                                  const void* scale, const void* bias,
                                  void* out, void* part, void* cnt, int M,
                                  int N, int K, int ksplit, int kps, int act,
                                  void* stream) {
  if (scale == nullptr) return (int)cudaErrorInvalidValue;
  return fc::launch(Int8Rows{static_cast<const uint8_t*>(q)},
                    static_cast<const float*>(x),
                    static_cast<const float*>(scale),
                    static_cast<const float*>(bias),
                    static_cast<float*>(out), static_cast<float*>(part),
                    static_cast<int*>(cnt), M, N, K, ksplit, kps, act,
                    static_cast<cudaStream_t>(stream));
}
