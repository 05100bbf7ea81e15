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
// What bounds it: the code bytes (half a byte a weight) at the serve's row
// counts (M = 4 at decode, 32 at a chunk-8 step).
//
// Design: the product of fc_tile.cuh on the tensor cores.  The policy
// below keeps 64 code bytes of a row a stage (16-byte units swizzled by
// row pair, so a warp's 4-byte loads hit distinct banks).  The block first
// builds a 256-entry table: byte b -> the bf16 pairs (hi(c[b & 15]),
// hi(c[b >> 4])) and (lo(..), lo(..)) of the centroids split into hi + lo,
// so one 8-byte look-up per code byte gives a fragment register's two
// weights (even k in the low half) in both parts.  The table is kept in
// REP interleaved copies, lane l reading copy l % REP, so the look-ups of
// a half-warp hit distinct banks whatever the codes.  The dense weights
// never exist outside registers.
#include "fc_tile.cuh"

namespace {

struct Codes4 {
  static constexpr int ROW = fc::BK / 2;  // bytes of a row in a stage
  static constexpr int KPB = 2;           // k per byte
  static constexpr int REP = 16;          // copies of the table
  static constexpr int TABLE = 256 * 8 * REP;  // bytes: a uint2 a byte
  static constexpr bool LO = true;        // centroids split hi + lo
  const uint8_t* __restrict__ rows;       // codes [N, K/2]
  const float* __restrict__ cents;        // [16]

  // entry b of copy r at b * REP + r
  __device__ __forceinline__ void build_table(uint8_t* t, int tid,
                                              int nt) const {
    uint2* tab = reinterpret_cast<uint2*>(t);
    for (int i = tid; i < 256 * REP; i += nt) {
      const int b = i / REP;
      const mt::Split ev = mt::split(cents[b & 15]);  // even k: low nibble
      const mt::Split od = mt::split(cents[b >> 4]);
      tab[i] = make_uint2(mt::pack(ev.hi, od.hi), mt::pack(ev.lo, od.lo));
    }
  }
  __device__ __forceinline__ static int swizzle(int r, int u) {
    return u ^ ((r >> 1) & 3);
  }
  // lane c's 4 bytes of row r: k 32 * warp + 8c .. + 7 of the stage
  __device__ __forceinline__ static uint32_t load(const uint8_t* ws, int r,
                                                  int warp, int c) {
    return *reinterpret_cast<const uint32_t*>(ws + r * ROW +
                                              16 * swizzle(r, warp) + 4 * c);
  }
  // step j's A fragments (hi, lo) from rows g (r0) and g + 8 (r1): bytes
  // 2j (k 2c, 2c + 1 of the fragment) and 2j + 1 (k 2c + 8, 2c + 9)
  __device__ __forceinline__ static void decode(uint32_t r0, uint32_t r1,
                                                int j, const uint8_t* t,
                                                int lane, uint32_t* ah,
                                                uint32_t* al) {
    const uint2* tab = reinterpret_cast<const uint2*>(t) + lane % REP;
    const uint2 e0 = tab[((r0 >> (16 * j)) & 0xffu) * REP];
    const uint2 e1 = tab[((r1 >> (16 * j)) & 0xffu) * REP];
    const uint2 e2 = tab[((r0 >> (16 * j + 8)) & 0xffu) * REP];
    const uint2 e3 = tab[((r1 >> (16 * j + 8)) & 0xffu) * REP];
    ah[0] = e0.x, ah[1] = e1.x, ah[2] = e2.x, ah[3] = e3.x;
    al[0] = e0.y, al[1] = e1.y, al[2] = e2.y, al[3] = e3.y;
  }
};

}  // namespace

// K must be even.  part: scratch of ksplit * M * N floats and cnt: one int
// per tile of BN channels x (8 or 32) rows (both unused if ksplit == 1);
// the splits cover K in kps steps (a multiple of fc::BK), as
// kernels/fc_tile.py's split_plan gives them.  Returns the cudaError_t of
// the launch.
extern "C" int lut_matmul_launch(const void* x, const void* codes,
                                 const void* cents, const void* bias,
                                 void* out, void* part, void* cnt, int M,
                                 int N, int K, int ksplit, int kps, int act,
                                 void* stream) {
  if (cents == nullptr) return (int)cudaErrorInvalidValue;
  return fc::launch(Codes4{static_cast<const uint8_t*>(codes),
                           static_cast<const float*>(cents)},
                    static_cast<const float*>(x), nullptr,
                    static_cast<const float*>(bias),
                    static_cast<float*>(out), static_cast<float*>(part),
                    static_cast<int*>(cnt), M, N, K, ksplit, kps, act,
                    static_cast<cudaStream_t>(stream));
}
