// Flash-attention backward in float32 on Hopper's tensor cores (sm_90a):
// split-TF32 warpgroup MMA ("3xTF32") fed by TMA with raw float32 tiles,
// which each block splits and transposes in shared memory; two launches,
// no atomics. Plain C entry points `flash_attn_bwd_f32` and
// `flash_attn_bwd_f32_workspace`, loaded with ctypes.
//
// Replaces the JAX package's backward of the Pallas TPU kernel,
// unast_tpu/ops/attention.py::_flash_vjp_bwd (a jnp recompute behind
// custom_vjp, with _ref_scores), for float32 inputs; bfloat16 inputs go to
// flash_attn_bwd_wgmma.cu. Given q [B, Tq, H, D], k and v [B, Tk, H, D],
// the forward output o, its lse [B, H, Tq] (natural log, written by
// flash_attn_fwd_f32.cu) and the gradient dO [B, Tq, H, D], it computes,
// with the forward's mask (key j of row b kept when j < kv_lens[b] and, if
// causal, j <= i + q_start; masked scores -1e9):
//   s = q k^T / sqrt(D), P = exp(s - lse), dV = P^T dO, dP = dO V^T,
//   delta = rowsum(dO o), dS = P (dP - delta) / sqrt(D),
//   dQ = dS K, dK = dS^T Q,
// each gradient a float32 tensor. JAX recomputes lse from s; here it is
// the forward's.
//
// Precision. Every product is three TF32 products of split operands,
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (round to nearest),
// summed lo*hi + hi*lo + hi*hi into one float32 accumulator, small terms
// first, as in the float32 forward: about 21 bits of each operand survive
// where one TF32 product keeps 10. q, k, v and dO are split in shared
// memory; P, P^T, dS and dS^T in registers.
//
// What bounds it on an H100 SXM: five products of 2 * pairs * D flops over
// the kept (query, key) pairs, each three TF32 products; at B4 H4 T816 D64
// causal that is 16.6 GFLOP of TF32, 0.020 ms at the 495 TFLOP/s TF32
// peak, against 6.7 MB for q, k, v, o, dO and the three gradients, 0.002
// ms at 3.35 TB/s: bound by operations. Inside a block shared memory is
// scarce, in room and in bandwidth: a float32 tile and its split take 4x
// a bf16 tile's bytes, and every product that reads both operands from it
// is bound by those reads. TF32 wgmma reads its shared-memory operands
// only K-major (no transpose for 32-bit types), so a product whose
// reduction runs over queries (dV = P^T dO, dK = dS^T Q) needs dO and Q
// with the queries contiguous, and dQ = dS K needs K with the keys
// contiguous. The design:
//   - a pre-pass (flash_bwd_f32_delta_kernel) forms only the row
//     statistics, lse2 = lse log2(e) and delta = rowsum(dO o), into a
//     workspace the wrapper allocates ([B*H, Tq rounded up to 64] each;
//     rows past Tq: lse2 = +inf, so P = 0, and delta 0);
//   - the grid reads q, k, v and dO as they are, raw float32 tiles by TMA
//     through 4-D tensor maps over the caller's [B, T, H, D] views (the
//     wrapper copies a layout that TMA refuses), zeros past T;
//   - the blocks split the streamed tiles in shared memory, into hi and
//     lo parts as they are (the B operands of S and dP) and, for the
//     products over their positions, transposed (Q^T and dO^T, or K^T),
//     in the swizzle TMA would have written; a block's 64 kept rows (K and
//     V of a dK/dV block, Q and dO of a dQ block) go into registers once,
//     as the split A operands of S and dP, so that those products read
//     only B from shared memory;
//   - inside each group of 8 positions the transposed parts hold the
//     positions in the order [0, 2, 4, 6, 1, 3, 5, 7] (key_at), so that
//     P^T, dS^T (over queries) and dS (over keys) go from the accumulator
//     to the A fragment without a shuffle; each such product sums over the
//     permuted index, so the order is exact as long as both operands agree
//     on it;
//   - one launch holds the dK/dV blocks and the dQ blocks (the card's
//     block scheduler fills every SM with whichever is left), each with
//     two warpgroups that share the products of every tile:
//     - dK/dV, one block per (64 keys, b*h), over query tiles of kTile
//       from the first that sees the block (causal: row i >= k0 -
//       q_start): warpgroup 0 forms S^T = K Q^T, P^T = 2^(S^T c - lse2)
//       and dV += P^T dO against dO^T; warpgroup 1 dP^T = V dO^T, dS^T =
//       P^T (dP^T - delta) with P^T passed to it through shared memory,
//       and dK += dS^T Q against Q^T. Key tiles past kv_len run no tile and
//       store zeros; masked keys get P = 0 exactly;
//     - dQ, one block per (64 query rows, b*h), over key tiles of kTile up
//       to the forward's key bound: warpgroup 0 forms S = Q K^T and P,
//       warpgroup 1 dP = dO V^T and dS = P (dP - delta), passed back; each
//       adds dS K into its half of dQ's columns, against K^T;
//   - each gradient element is summed by one thread over the tiles in
//     order, with no partial sums between warpgroups, so two calls agree
//     bit for bit;
//   - a two-stage ring of raw tiles (with each query tile's lse2 and
//     delta): tile i + 2 is loaded as soon as tile i is split; tile i is
//     split transposed while its S and dP run, tile i + 1 as it is while
//     tile i's gradient products run. ptxas serializes every wgmma of the
//     kernel where code reads or writes an accumulator while a product is
//     in flight, branches on the thread's index or may trap there: so the
//     products are waited out before P is formed, the mask is applied
//     without a branch, the loads are predicated, and a lost TMA arrival
//     traps only after the last product;
//   - tiles follow the float32 row width: a tile of D columns is boxes of
//     32 columns (128-byte swizzle; 16 columns and 64 bytes at D 16), a
//     transposed tile boxes of 32 positions (16 and 64 bytes for a tile of
//     16) by D rows; a k-step of 8 moves 32 bytes inside a swizzled row.
//     The sizes are what a block's registers hold (Plan): at D 128 the
//     kept rows take 128 of a thread's registers, so tiles of 16.
// dK and dQ take the scale once, at the store; rows past Tq or Tk are not
// stored.
//
// Precondition: every kv_len >= 1, as the forward's. A row with no visible
// key has no defined lse; that is not a contract.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kRowPad = 64;       // lse2 / delta rows per b*h: Tq rounded up
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kBarAll = 1;   // named barrier of a block's warpgroups

// Return codes besides cudaError_t values.
constexpr int kErrTensorMap = -1;  // a layout the TMA unit does not take
constexpr int kErrNoEncoder = -2;  // cuTensorMapEncodeTiled not found

__host__ __device__ constexpr int pos_box(int positions) {
  return positions < 32 ? positions : 32;
}

// Block shape and shared memory for head dim D (byte offsets from a
// 1024-byte aligned base). A natural tile of R rows is kBoxes boxes of
// R x kRowBytes; a transposed tile of R positions is R / pos_box(R) boxes
// of D rows x 4 pos_box(R) bytes. In order: the streamed tile as it is
// [X0 hi, X0 lo, X1 hi, X1 lo] (Q, dO in a dK/dV block, K, V in a dQ
// block), transposed [X0^T hi, X0^T lo, X1^T hi, X1^T lo] (a dQ block uses
// the first two, K^T), the ring of raw tiles [stage][X0, X1], the block's
// 64 kept rows raw [A0, A1] (K, V or Q, dO; in registers once loaded), the
// warpgroups' exchange [2][128 threads][kTile / 2], each stage's lse2 and
// delta (dK/dV), the barriers.
template <int D>
struct Plan {
  static constexpr int kThreads = 256;  // two warpgroups
  static constexpr int kTile = D == 128 ? 16 : 32;  // positions streamed
  static constexpr int kStages = 2;
  static constexpr int kBoxD = D < 32 ? D : 32;
  static constexpr int kBoxes = D / kBoxD;
  static constexpr int kRowBytes = kBoxD * 4;
  static constexpr uint32_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kBoxRes = 64 * kRowBytes;  // a kept column box
  static constexpr int kPartRes = kBoxes * kBoxRes;
  static constexpr int kBoxTile = kTile * kRowBytes;  // a streamed one
  static constexpr int kPart = kTile * D * 4;
  static constexpr int kStatBytes = 2 * kTile * 4;  // lse2, delta of a tile
  static constexpr int kTrans = 4 * kPart;
  static constexpr int kRaw = 8 * kPart;
  static constexpr int kKept = kRaw + kStages * 2 * kPart;
  static constexpr int kXchg = kKept + 2 * kPartRes;
  static constexpr int kStats = kXchg + 2 * 128 * (kTile / 2) * 4;
  static constexpr int kBarriers = kStats + kStages * kStatBytes;
  static constexpr int kSmem = kBarriers + 8 * (kStages + 1) + 1024;
  static_assert(kSmem <= 232448, "shared memory");
  static_assert(kPart % 1024 == 0 && kPartRes % 1024 == 0, "tile alignment");
};

struct Params {
  float* dq;
  float* dk;
  float* dv;
  const float* lse2;   // [B*H, Tq_pad], written by the pre-pass
  const float* delta;  // [B*H, Tq_pad]
  const int32_t* kv_lens;
  Strides dqs, dks, dvs;
  int H, Tq, Tk, Tq_pad, causal;
  int q_start;       // keys' position of query 0 (causal mask)
  float scale_log2;  // log2(e) / sqrt(D)
  float sm_scale;    // 1 / sqrt(D)
};

struct Stats {
  const float *o, *dout, *lse;  // lse: [B*H, Tq]
  float* lse2;                  // [B*H, Tq_pad]
  float* delta;                 // [B*H, Tq_pad]
  Strides os, dos;
  int H, Tq, Tq_pad;
};

// The raw float32 tiles: a box is kBoxD columns of kTile positions of one
// head of one batch row.
struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) x[e] = 0.f;
}

__device__ __forceinline__ int kv_len_of(const int32_t* kv_lens, int b,
                                         int Tk) {
  return kv_lens == nullptr ? Tk : min(max(kv_lens[b], 0), Tk);
}

// ---- 1. the pre-pass --------------------------------------------------------

// One block per (128 / (D / 4) rows, b*h): lse2 = lse log2(e) and
// delta = rowsum(dO o) of each row into the workspace; rows past Tq get
// lse2 = +inf (P = 0) and delta 0. A row is D / 4 lanes, each summing the
// products of 4 columns read as one 16-byte word of o and of dO, then the
// lanes' sums in a fixed butterfly. Every load is issued before the first
// sum: the launch is one memory round trip.
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_f32_delta_kernel(const Stats s) {
  constexpr int kLanes = D / 4;
  const int bh = blockIdx.x;
  const int b = bh / s.H;
  const int h = bh % s.H;
  const int c = threadIdx.x % kLanes * 4;
  const int row = blockIdx.y * (128 / kLanes) + threadIdx.x / kLanes;
  const bool first = threadIdx.x % kLanes == 0;  // the lane that stores
  float4 ow = make_float4(0.f, 0.f, 0.f, 0.f), dw = ow;
  float lse2 = INFINITY;
  if (row < s.Tq) {
    ow = *reinterpret_cast<const float4*>(s.o + b * s.os.b +
                                          (long long)row * s.os.t +
                                          h * s.os.h + c);
    dw = *reinterpret_cast<const float4*>(s.dout + b * s.dos.b +
                                          (long long)row * s.dos.t +
                                          h * s.dos.h + c);
    if (first) lse2 = s.lse[(long long)bh * s.Tq + row] * kLog2e;
  }
  float d = dw.x * ow.x;
  d = fmaf(dw.y, ow.y, d);
  d = fmaf(dw.z, ow.z, d);
  d = fmaf(dw.w, ow.w, d);
#pragma unroll
  for (int m = kLanes / 2; m > 0; m /= 2)
    d += __shfl_xor_sync(0xffffffffu, d, m);
  if (first) {
    const long long at = (long long)bh * s.Tq_pad + row;
    s.lse2[at] = lse2;
    s.delta[at] = d;
  }
}

// ---- products -----------------------------------------------------------------

// acc [64 x N] = A [64 x D] B [N x D]^T in split TF32: A from registers
// as the hi and lo fragments of its D / 8 k-steps (load_frags), B a
// natural tile in shared memory (its hi part at b, its lo part b_part
// bytes on, its column boxes b_box bytes apart, K-major): lo*hi, hi*lo,
// hi*hi in k-steps of 8 (32 bytes inside one swizzled row). Issues the
// wgmmas only: the caller fences, commits and waits.
template <int D, int N>
__device__ __forceinline__ void mma3_rs_bt(float (&acc)[N / 2],
                                           const uint32_t (&hi)[D / 8][4],
                                           const uint32_t (&lo)[D / 8][4],
                                           uint32_t b, int b_part, int b_box) {
  using P = Plan<D>;
  constexpr int kSteps = P::kBoxD / 8;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const uint32_t bt = b + (t == 1 ? b_part : 0);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint64_t db = make_desc(bt + kk / kSteps * b_box + 32 * (kk % kSteps),
                                    16, 8 * P::kRowBytes, P::kLayout);
      WgmmaTf32RS<N>::run(acc, t == 0 ? lo[kk] : hi[kk], db, t > 0 || kk > 0);
    }
  }
}

// acc [64 x NC] += X [64 x K] B [K x NC] in split TF32, X from registers as
// the hi and lo A fragments of its K / 8 k-steps (split_frags), B rows
// d0 .. d0 + NC of a transposed tile of K positions in shared memory (bt
// the address of row d0 of its hi part, its lo part b_part bytes on):
// lo*hi, hi*lo, hi*hi, the NC columns as products of at most 64. Issues the
// wgmmas only.
template <int D, int NC, int K>
__device__ __forceinline__ void mma3_rs(float (&acc)[NC / 2],
                                        const uint32_t (&hi)[K / 8][4],
                                        const uint32_t (&lo)[K / 8][4],
                                        uint32_t bt, int b_part) {
  constexpr int kPos = pos_box(K);
  constexpr int kRow = kPos * 4;            // bytes of a transposed row
  constexpr int kBox = D * kRow;            // one box of D rows
  constexpr int kSteps = kPos / 8;
  constexpr int kNV = NC < 64 ? NC : 64;
  constexpr uint32_t kLayoutT = kRow == 128 ? 1 : 2;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
#pragma unroll
    for (int j = 0; j < K / 8; ++j) {
#pragma unroll
      for (int c = 0; c < NC / kNV; ++c) {
        const uint64_t db = make_desc(
            bt + (t == 1 ? b_part : 0) + j / kSteps * kBox + c * kNV * kRow +
                32 * (j % kSteps),
            16, 8 * kRow, kLayoutT);
        WgmmaTf32RS<kNV>::run(
            *reinterpret_cast<float(*)[kNV / 2]>(acc + c * kNV / 2),
            t == 0 ? lo[j] : hi[j], db, 1);
      }
    }
  }
}

// This warpgroup's rows of a kept raw tile (64 rows x D in the natural
// layout at src) as the hi and lo TF32 A fragments of its D / 8 k-steps
// (sm90.cuh's layout: warp w's rows 16w + g and 16w + g + 8, columns
// 8 kk + t and 8 kk + t + 4, g = lane / 4, t = lane % 4); tw the thread's
// index in its warpgroup.
template <int D>
__device__ __forceinline__ void load_frags(const uint8_t* src,
                                           uint32_t (&hi)[D / 8][4],
                                           uint32_t (&lo)[D / 8][4], int tw) {
  using P = Plan<D>;
  const int r = 16 * (tw / 32) + (tw % 32) / 4;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e % 2);
      const int col = 8 * kk + tw % 4 + 4 * (e / 2);
      float h, l;
      split_tf32(*reinterpret_cast<const float*>(
                     src + col / P::kBoxD * P::kBoxRes +
                     swizzled<P::kRowBytes>(row, col % P::kBoxD * 4)),
                 h, l);
      hi[kk][e] = __float_as_uint(h);
      lo[kk][e] = __float_as_uint(l);
    }
}

// An accumulator [64 x N] as hi and lo TF32 A fragments of its N / 8
// k-steps: k-step j is the accumulator's column block j, columns
// 8j + [0, 2, 4, 6, 1, 3, 5, 7] in the fragment's order (a0 = row g col
// 2t, a1 = row g + 8 col 2t, a2 and a3 col 2t + 1), the transposed
// tiles' order (key_at).
template <int N>
__device__ __forceinline__ void split_frags(const float (&x)[N / 2],
                                            uint32_t (&hi)[N / 8][4],
                                            uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int src[4] = {4 * j, 4 * j + 2, 4 * j + 1, 4 * j + 3};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h, l;
      split_tf32(x[src[e]], h, l);
      hi[j][e] = __float_as_uint(h);
      lo[j][e] = __float_as_uint(l);
    }
  }
}

// Keeps A fragments in their registers up to here: a register-A wgmma
// reads them after it is issued, until the wait that ends it.
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&x)[K / 8][4]) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(x[j][r])::"memory");
}

// Stores rows [row0, row0 + 8] of an accumulator [64 x D] (D columns from
// x on) times `scale` into x (b, h fixed at x's base), rows >= n not.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float scale, float* x,
                                           long long st, int row0, int col0,
                                           int n) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < n) {
      float* out = x + (long long)row * st + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) = make_float2(
            acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// Zeros in this thread's elements of rows row0 and row0 + 8 (store_rows).
template <int D>
__device__ __forceinline__ void store_zero_rows(float* x, long long st,
                                                int row0, int col0, int n) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < n) {
      float* out = x + (long long)row * st + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) = make_float2(0.f, 0.f);
    }
  }
}

// ---- the tiles in shared memory ---------------------------------------------

// Copies rows [r0, r0 + rows) of head h of batch row b from a raw map to
// dst as a natural tile (kBoxes column boxes of rows x kRowBytes), each box
// as rows / kTile TMA boxes; rows past T arrive as zeros. Issued by the
// threads where `pred` holds (predicated, not branched: see
// tma_load_4d_if).
template <int D>
__device__ __forceinline__ void load_rows(bool pred, uint32_t dst,
                                          const CUtensorMap* map, uint32_t bar,
                                          int rows, int r0, int h, int b) {
  using P = Plan<D>;
#pragma unroll
  for (int x = 0; x < P::kBoxes; ++x)
#pragma unroll
    for (int y = 0; y < rows / P::kTile; ++y)
      tma_load_4d_if(pred, dst + x * rows * P::kRowBytes + y * P::kBoxTile,
                     map, bar, x * P::kBoxD, h, r0 + y * P::kTile, b);
}

// The raw tiles of X0 and X1 at positions r0 on into a warpgroup's raw
// stage, where `pred` holds; `full` completes on their bytes and `extra`
// more, which the caller loads after.
template <int D>
__device__ __forceinline__ void load_tile(bool pred, uint32_t raw,
                                          uint32_t full, const CUtensorMap* x0,
                                          const CUtensorMap* x1, int r0, int h,
                                          int b, int extra = 0) {
  using P = Plan<D>;
  mbar_arrive_expect_tx_if(pred, full, 2 * P::kPart + extra);
  load_rows<D>(pred, raw, x0, full, P::kTile, r0, h, b);
  load_rows<D>(pred, raw + P::kPart, x1, full, P::kTile, r0, h, b);
}

// hi and lo of kBytes of raw float32 at src, each element at its own
// offset of hi and of lo (any tile layout), split over the block's
// threads.
template <int kBytes>
__device__ __forceinline__ void split_natural(const uint8_t* src, uint8_t* hi,
                                              uint8_t* lo) {
  constexpr int kStep = 16 * 256;
  const int t = threadIdx.x;
#pragma unroll
  for (int n = 0; n < (kBytes + kStep - 1) / kStep; ++n) {
    // threads past the end redo the last word (the same values): no
    // branch
    const int i = min(16 * t + n * kStep, kBytes - 16);
    const float4 x = *reinterpret_cast<const float4*>(src + i);
    float4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<float4*>(hi + i) = h;
    *reinterpret_cast<float4*>(lo + i) = l;
  }
}

// The transposed hi and lo parts of a raw natural tile of kTile positions
// x D at src, split over the block's threads: position p, column d goes to
// row d of box p / pos_box(kTile) at the place of p in its group of 8
// (key_at's inverse), in the swizzle of the box's 4 pos_box(kTile)-byte
// rows. A thread's unit is 4 places (p0, p0 + 2, p0 + 4, p0 + 6 of one
// group) of one column, read as 4 floats and written as one 16-byte word
// of each part; a warp's lanes take consecutive columns, so that neither
// side has bank conflicts.
template <int D>
__device__ __forceinline__ void split_transposed(const uint8_t* src,
                                                 uint8_t* hi, uint8_t* lo) {
  using P = Plan<D>;
  constexpr int kPb = pos_box(P::kTile);
  constexpr int kTRow = 4 * kPb;
  constexpr int kUnits = P::kTile / 4 * D;
  const int t = threadIdx.x;
#pragma unroll
  for (int n = 0; n < (kUnits + 255) / 256; ++n) {
    const int u = min(t + n * 256, kUnits - 1);  // as split_natural
    const int d = u % D;
    const int c = u / D;                  // places 4c .. 4c + 3
    const int p0 = 8 * (c / 2) + c % 2;   // hold positions p0 + 2j
    const uint8_t* col = src + d / P::kBoxD * P::kBoxTile;
    const int cb = d % P::kBoxD * 4;
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = *reinterpret_cast<const float*>(
          col + swizzled<P::kRowBytes>(p0 + 2 * j, cb));
    float4 h, l;
    split_tf32(x[0], h.x, l.x);
    split_tf32(x[1], h.y, l.y);
    split_tf32(x[2], h.z, l.z);
    split_tf32(x[3], h.w, l.w);
    const int off = 4 * c / kPb * (D * kTRow) +
                    swizzled<kTRow>(d, 4 * c % kPb * 4);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// A block's streamed tiles: stage i % kStages of the raw ring holds tile i
// (positions r0 + i kTile on, with the lse2 and delta of those rows where
// `with_stats`); the block splits it as it is and transposed.
template <int D>
struct Tiles {
  uint32_t base;
  uint8_t* gen;
  const CUtensorMap *x0, *x1;
  int r0, h, b;
  const float *lse2, *delta;  // at row r0 of this b*h, or null
  __device__ uint32_t full(int i) const {
    return base + Plan<D>::kBarriers + 8 * (i % Plan<D>::kStages);
  }
  // tile i's loads, where `pred` holds (predicated, not branched)
  __device__ void load(bool pred, int i) const {
    using P = Plan<D>;
    const int st = i % P::kStages;
    const int extra = lse2 != nullptr ? P::kStatBytes : 0;
    load_tile<D>(pred, base + P::kRaw + st * 2 * P::kPart, full(i), x0, x1,
                 r0 + i * P::kTile, h, b, extra);
    if (lse2 == nullptr) return;
    const uint32_t dst = base + P::kStats + st * P::kStatBytes;
    bulk_load_if(pred, dst, lse2 + i * P::kTile, P::kTile * 4, full(i));
    bulk_load_if(pred, dst + P::kTile * 4, delta + i * P::kTile, P::kTile * 4,
                 full(i));
  }
  // whether tile i landed (false: its arrival was lost)
  __device__ bool wait(int i) const {
    return mbar_try_wait(full(i), (i / Plan<D>::kStages) & 1);
  }
  __device__ const uint8_t* raw(int i) const {
    using P = Plan<D>;
    return gen + P::kRaw + (i % P::kStages) * 2 * P::kPart;
  }
  // tile i split as it is, by all threads
  __device__ void split_nat(int i) const {
    using P = Plan<D>;
    split_natural<P::kPart>(raw(i), gen, gen + P::kPart);
    split_natural<P::kPart>(raw(i) + P::kPart, gen + 2 * P::kPart,
                            gen + 3 * P::kPart);
  }
  // tile i split transposed (X0 only, or X0 and X1), by all threads
  __device__ void split_trans(int i, int parts) const {
    using P = Plan<D>;
    uint8_t* tr = gen + P::kTrans;
    split_transposed<D>(raw(i), tr, tr + P::kPart);
    if (parts == 2)
      split_transposed<D>(raw(i) + P::kPart, tr + 2 * P::kPart,
                          tr + 3 * P::kPart);
  }
  // tile i's lse2, then its delta
  __device__ const float* stats(int i) const {
    using P = Plan<D>;
    return reinterpret_cast<const float*>(gen + P::kStats +
                                          (i % P::kStages) * P::kStatBytes);
  }
};

// A block's first steps: the barriers; thread 0 loads the kept rows
// [r0, r0 + 64) of A0 and A1 and tiles 0 and 1; the kept rows come back as
// this warpgroup's A fragments (A0 for warpgroup 0, A1 for 1), tile 0
// split as it is. Returns false if tile 0's arrival was lost.
template <int D>
__device__ __forceinline__ bool start_block(const Tiles<D>& tl,
                                            const CUtensorMap* a0,
                                            const CUtensorMap* a1, int r0,
                                            int n, uint32_t (&ah)[D / 8][4],
                                            uint32_t (&al)[D / 8][4]) {
  using P = Plan<D>;
  const int t = threadIdx.x;
  const uint32_t bar_kept = tl.base + P::kBarriers + 8 * P::kStages;
  init_barriers(tl.base + P::kBarriers, P::kStages, bar_kept);
  if (t == 0) {
    mbar_arrive_expect_tx(bar_kept, 2 * P::kPartRes);
    load_rows<D>(true, tl.base + P::kKept, a0, bar_kept, 64, r0, tl.h, tl.b);
    load_rows<D>(true, tl.base + P::kKept + P::kPartRes, a1, bar_kept, 64, r0,
                 tl.h, tl.b);
  }
  tl.load(t == 0, 0);
  tl.load(t == 0 && n > 1, 1);
  mbar_wait(bar_kept, 0);
  load_frags<D>(tl.gen + P::kKept + t / 128 * P::kPartRes, ah, al, t % 128);
  const bool landed = tl.wait(0);
  tl.split_nat(0);
  fence_proxy_async();
  bar_sync(kBarAll, P::kThreads);
  return landed;
}

// ---- 2. dQ ------------------------------------------------------------------

// dQ of the 64 query rows qblk of b*h blockIdx.x. Warpgroup 0 forms S =
// Q K^T and P, warpgroup 1 dP = dO V^T and dS = P (dP - delta), with P
// and dS passed through shared memory; each then adds dS K into its half
// of dQ's columns, against K^T.
template <int D>
__device__ __forceinline__ void dq_block(const Maps& m, const Params& p,
                                         int qblk) {
  using P = Plan<D>;
  constexpr int BN = P::kTile;
  constexpr int kS = BN / 2;
  constexpr int kO = D / 4;  // a warpgroup's half of dQ
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gen = smem_raw + (base - smem_u32(smem_raw));  // generic view
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = qblk * 64;
  const int kv_len = kv_len_of(p.kv_lens, b, p.Tk);
  const int n_keys = p.causal ? min(kv_len, p.q_start + min(p.Tq, q0 + 64))
                              : kv_len;
  const int n = (n_keys + BN - 1) / BN;
  const int t = threadIdx.x;
  const int wg = t / 128;
  const int tw = t % 128;
  const int lane = t % 32;
  const int row0 = q0 + 16 * (tw / 32) + lane / 4;
  const int col0 = 2 * (lane % 4);
  // this warpgroup's half of dQ's columns
  float* dq = p.dq + b * p.dqs.b + h * p.dqs.h + wg * (D / 2);
  // no tile (rows past every visible key: not a contract): zeros
  if (n == 0) {
    store_zero_rows<D / 2>(dq, p.dqs.t, row0, col0, p.Tq);
    return;
  }
  const Tiles<D> tl{base, gen, &m.k, &m.v, 0, h, b, nullptr, nullptr};
  uint32_t ah[D / 8][4], al[D / 8][4];  // Q (warpgroup 0) or dO (1)
  bool lost = !start_block<D>(tl, &m.q, &m.dout, q0, n, ah, al);
  float lse2[2], delta[2];  // of rows row0 and row0 + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = (long long)bh * p.Tq_pad + row0 + 8 * r;
    lse2[r] = p.lse2[at];
    delta[r] = p.delta[at];
  }
  float* xchg = reinterpret_cast<float*>(gen + P::kXchg);
  float sd[kS], dq_acc[kO];  // S (warpgroup 0) or dP (1); dQ's half
  uint32_t fh[BN / 8][4] = {}, fl[BN / 8][4] = {};  // dS
  zero(sd);
  zero(dq_acc);
  for (int li = 0; li < n; ++li) {
    const int kb = li * BN;
    // S = Q K^T or dP = dO V^T; K^T split while it runs. Nothing is in
    // flight at a branch, and the products are waited out before code
    // reads them: ptxas serializes every wgmma of the kernel where code
    // reads or writes an accumulator while a product is in flight, or
    // branches on the thread or may trap there (so the mask is
    // unconditional and the loads are predicated)
    fence_operands(sd);
    wgmma_fence();
    mma3_rs_bt<D, BN>(sd, ah, al, base + wg * 2 * P::kPart, P::kPart,
                      P::kBoxTile);
    wgmma_commit();
    tl.split_trans(li, 1);
    fence_proxy_async();
    bar_sync(kBarAll, P::kThreads);
    wgmma_wait<0>();
    fence_operands(sd);
    fence_frags<D>(ah);
    fence_frags<D>(al);
    // P = 2^(S c - lse2), 0 at masked keys (what exp(-1e9 - lse) rounds
    // to), by warpgroup 0; dS = P (dP - delta) by warpgroup 1; each
    // passed to the other
    float ds[kS];
    if (wg == 0) {
#pragma unroll
      for (int e = 0; e < kS; ++e)
        ds[e] = ex2(fmaf(sd[e], p.scale_log2, -lse2[(e / 2) % 2]));
      apply_mask<BN>(ds, kv_len, p.causal, p.q_start, 0.f, row0, kb, col0,
                     false);
      to_swap<kS>(ds, xchg, tw);
    }
    bar_sync(kBarAll, P::kThreads);
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < kS; ++e)
        ds[e] = xchg[e * 128 + tw] * (sd[e] - delta[(e / 2) % 2]);
      to_swap<kS>(ds, xchg + kS * 128, tw);
    }
    bar_sync(kBarAll, P::kThreads);
    if (wg == 0)
#pragma unroll
      for (int e = 0; e < kS; ++e) ds[e] = xchg[kS * 128 + e * 128 + tw];
    split_frags<BN>(ds, fh, fl);
    if (li + 1 < n && !lost) lost = !tl.wait(li + 1);
    // dQ's half += dS K against K^T, the next tile split as it is while it
    // runs (at the last tile, a stale stage: unused)
    fence_operands(dq_acc);
    wgmma_fence();
    mma3_rs<D, D / 2, BN>(dq_acc, fh, fl,
                          base + P::kTrans + wg * (D / 2) * 4 * pos_box(BN),
                          P::kPart);
    wgmma_commit();
    tl.split_nat(li + 1);
    wgmma_wait<0>();
    fence_operands(dq_acc);
    fence_frags<BN>(fh);
    fence_frags<BN>(fl);
    fence_proxy_async();
    bar_sync(kBarAll, P::kThreads);
    tl.load(t == 0 && li + 2 < n, li + 2);
  }
  if (lost) __trap();
  store_rows<D / 2>(dq_acc, p.sm_scale, dq, p.dqs.t, row0, col0, p.Tq);
}

// ---- 3. dK and dV -----------------------------------------------------------

// dK and dV of the 64 keys kblk of b*h blockIdx.x. Warpgroup 0 forms S^T =
// K Q^T, P^T and dV += P^T dO, warpgroup 1 dP^T = V dO^T, dS^T = P^T (dP^T
// - delta) and dK += dS^T Q, with P^T passed through shared memory.
template <int D>
__device__ __forceinline__ void dkdv_block(const Maps& m, const Params& p,
                                           int kblk) {
  using P = Plan<D>;
  constexpr int BQ = P::kTile;
  constexpr int kS = BQ / 2;  // S^T / dP^T accumulators per thread
  constexpr int kO = D / 2;   // dV / dK accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gen = smem_raw + (base - smem_u32(smem_raw));  // generic view
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = kblk * 64;
  const int kv_len = kv_len_of(p.kv_lens, b, p.Tk);
  // query tiles whose rows see a key of this block: causal, rows from
  // k0 - q_start on; none when the block lies past kv_len
  const int q_tiles = (p.Tq + BQ - 1) / BQ;
  const int first = p.causal ? max(0, k0 - p.q_start) / BQ : 0;
  const int n = k0 < kv_len ? max(0, q_tiles - first) : 0;
  const int t = threadIdx.x;
  const int wg = t / 128;
  const int tw = t % 128;
  const int lane = t % 32;
  // this thread's keys row0 and row0 + 8 (accumulator rows)
  const int row0 = k0 + 16 * (tw / 32) + lane / 4;
  const int col0 = 2 * (lane % 4);
  // dV (warpgroup 0) or dK (1)
  float* dx = wg == 0 ? p.dv + b * p.dvs.b + h * p.dvs.h
                      : p.dk + b * p.dks.b + h * p.dks.h;
  const long long dx_st = wg == 0 ? p.dvs.t : p.dks.t;
  // keys past kv_len (no tile): zeros
  if (n == 0) {
    store_zero_rows<D>(dx, dx_st, row0, col0, p.Tk);
    return;
  }
  const long long at = (long long)bh * p.Tq_pad + first * BQ;
  const Tiles<D> tl{base,  gen, &m.q, &m.dout, first * BQ, h, b,
                    p.lse2 + at, p.delta + at};
  uint32_t ah[D / 8][4], al[D / 8][4];  // K (warpgroup 0) or V (1)
  bool lost = !start_block<D>(tl, &m.k, &m.v, k0, n, ah, al);
  float* xchg = reinterpret_cast<float*>(gen + P::kXchg);
  float sd[kS], dx_acc[kO];  // S^T or dP^T; dV or dK
  // the A fragments of P^T or dS^T (hi and lo parts)
  uint32_t fh[BQ / 8][4] = {}, fl[BQ / 8][4] = {};
  zero(sd);
  zero(dx_acc);
  for (int li = 0; li < n; ++li) {
    const int qb = (first + li) * BQ;
    // S^T = K Q^T or dP^T = V dO^T; Q^T and dO^T split while it runs (as
    // in dq_block)
    fence_operands(sd);
    wgmma_fence();
    mma3_rs_bt<D, BQ>(sd, ah, al, base + wg * 2 * P::kPart, P::kPart,
                      P::kBoxTile);
    wgmma_commit();
    tl.split_trans(li, 2);
    fence_proxy_async();
    bar_sync(kBarAll, P::kThreads);
    wgmma_wait<0>();
    fence_operands(sd);
    fence_frags<D>(ah);
    fence_frags<D>(al);
    // P^T = 2^(S^T c - lse2), 0 at masked keys, by warpgroup 0, passed to
    // warpgroup 1 for dS^T = P^T (dP^T - delta), per query column
    const float* stats = tl.stats(li) + col0;
    float pt[kS];
    if (wg == 0) {
#pragma unroll
      for (int e = 0; e < kS; ++e)
        pt[e] = ex2(fmaf(sd[e], p.scale_log2, -stats[8 * (e / 4) + (e % 2)]));
      apply_mask<BQ>(pt, kv_len, p.causal, p.q_start, 0.f, row0, qb, col0,
                     true);
      to_swap<kS>(pt, xchg, tw);
    }
    bar_sync(kBarAll, P::kThreads);
    if (wg == 1)
#pragma unroll
      for (int e = 0; e < kS; ++e)
        pt[e] = xchg[e * 128 + tw] *
                (sd[e] - stats[BQ + 8 * (e / 4) + (e % 2)]);
    split_frags<BQ>(pt, fh, fl);
    if (li + 1 < n && !lost) lost = !tl.wait(li + 1);
    // dV += P^T dO against dO^T, or dK += dS^T Q against Q^T; the next
    // tile split as it is meanwhile (as in dq_block)
    fence_operands(dx_acc);
    wgmma_fence();
    mma3_rs<D, D, BQ>(dx_acc, fh, fl, base + P::kTrans + (1 - wg) * 2 * P::kPart,
                      P::kPart);
    wgmma_commit();
    tl.split_nat(li + 1);
    wgmma_wait<0>();
    fence_operands(dx_acc);
    fence_frags<BQ>(fh);
    fence_frags<BQ>(fl);
    fence_proxy_async();
    bar_sync(kBarAll, P::kThreads);
    tl.load(t == 0 && li + 2 < n, li + 2);
  }
  if (lost) __trap();
  store_rows<D>(dx_acc, wg == 0 ? 1.f : p.sm_scale, dx, dx_st, row0, col0,
                p.Tk);
}

// ---- 4. the dQ and dK/dV blocks in one launch -------------------------------

// blockIdx.z 0 holds the dK/dV blocks, which go out first, and 1 the dQ
// blocks; blockIdx.y is the block of its kind, heaviest first under the
// causal mask (the dK/dV blocks of the first keys, the dQ blocks of the
// last queries); past its kind's count none.
template <int D>
__global__ void __launch_bounds__(Plan<D>::kThreads, 1)
flash_bwd_f32_kernel(const __grid_constant__ Maps m, const Params p) {
  constexpr int kRows = 64;
  const int y = blockIdx.y;
  if (blockIdx.z == 0) {
    if (y < (p.Tk + kRows - 1) / kRows) dkdv_block<D>(m, p, y);
  } else {
    const int n = (p.Tq + kRows - 1) / kRows;
    if (y < n) dq_block<D>(m, p, p.causal ? n - 1 - y : y);
  }
}

// ---- host -------------------------------------------------------------------

// Tensor map over the (D, H, T, B) view of a float32 [B, T, H, D] tensor;
// a box is kBoxD columns of kTile positions of one head of one batch row,
// in the swizzle of kRowBytes-byte rows.
template <int D>
bool make_map(EncodeTiled encode, CUtensorMap* map, const float* ptr, int B,
              int T, int H, Strides st) {
  using P = Plan<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 4, (cuuint64_t)st.t * 4,
                                 (cuuint64_t)st.b * 4};
  const cuuint32_t box[4] = {(cuuint32_t)P::kBoxD, 1, (cuuint32_t)P::kTile, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<float*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                P::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Tensors {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
};

template <int D>
int launch(const Tensors& t, const int32_t* kv_lens, int B, int H, int Tq,
           int Tk, int causal, int q_start, float sm_scale,
           cudaStream_t stream, float* ws) {
  using P = Plan<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const int BH = B * H;
  const int Tq_pad = round_up(Tq, kRowPad);
  Maps m;
  if (!make_map<D>(encode, &m.q, t.q, B, Tq, H, t.qs) ||
      !make_map<D>(encode, &m.k, t.k, B, Tk, H, t.ks) ||
      !make_map<D>(encode, &m.v, t.v, B, Tk, H, t.vs) ||
      !make_map<D>(encode, &m.dout, t.dout, B, Tq, H, t.dos))
    return kErrTensorMap;

  auto grads = flash_bwd_f32_kernel<D>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        grads, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }

  Stats s;
  s.o = t.o, s.dout = t.dout, s.lse = t.lse;
  s.lse2 = ws;
  s.delta = ws + (long long)BH * Tq_pad;
  s.os = t.os, s.dos = t.dos;
  s.H = H, s.Tq = Tq, s.Tq_pad = Tq_pad;

  Params p;
  p.dq = t.dq, p.dk = t.dk, p.dv = t.dv;
  p.lse2 = s.lse2;
  p.delta = s.delta;
  p.kv_lens = kv_lens;
  p.dqs = t.dqs, p.dks = t.dks, p.dvs = t.dvs;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.Tq_pad = Tq_pad;
  p.causal = causal;
  p.q_start = q_start;
  p.scale_log2 = sm_scale * kLog2e;
  p.sm_scale = sm_scale;

  flash_bwd_f32_delta_kernel<D>
      <<<dim3(BH, Tq_pad / (128 / (D / 4))), 128, 0, stream>>>(s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // b*h in x, the block in y: blocks go out in order of y
  const int nq = (Tq + 63) / 64;
  const int nk = (Tk + 63) / 64;
  grads<<<dim3(BH, nq > nk ? nq : nk, 2), P::kThreads, P::kSmem, stream>>>(m,
                                                                           p);
  return cudaGetLastError();
}

}  // namespace

// Floats of workspace the backward needs for these sizes: lse2 and delta,
// each [B*H, Tq rounded up to 128].
extern "C" long long flash_attn_bwd_f32_workspace(int B, int H, int Tq, int Tk,
                                                  int D) {
  (void)Tk;
  (void)D;
  return 2LL * B * H * sm90::round_up(Tq, kRowPad);
}

// Strides are in elements, for the b, t and h dims of each [B, T, H, D]
// float32 tensor (the D stride must be 1; q, k, v and dO are read by TMA,
// so their bases and b, t, h strides must be multiples of 16 bytes; o is
// read in 16-byte words, so its base and strides too; dq, dk and dv are
// written with 8-byte stores, their bases 8-byte aligned). lse: the
// forward's float32 [B, H, Tq], contiguous. kv_lens: int32 [B] on the
// device, or null for "all Tk keys valid". workspace:
// flash_attn_bwd_f32_workspace(B, H, Tq, Tk, D) floats on the device,
// 16-byte aligned. Launches the pre-pass and the kernel on `stream`, in
// that order. Returns 0 when both were launched, a cudaError_t value if a
// launch failed, -1 if the TMA unit refused the layout of q, k, v or dO,
// -2 if libcuda has no cuTensorMapEncodeTiled.
extern "C" int flash_attn_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    const void* kv_lens, int B, int H, int Tq, int Tk, int D, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, long long do_sb,
    long long do_st, long long do_sh, long long dq_sb, long long dq_st,
    long long dq_sh, long long dk_sb, long long dk_st, long long dk_sh,
    long long dv_sb, long long dv_st, long long dv_sh, int causal,
    int q_start, float sm_scale, void* stream, void* workspace) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B * H > 65535 ||
      sm90::round_up(Tq, kRowPad) / 64 > 65535 ||
      sm90::round_up(Tk, kRowPad) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  const Tensors t{static_cast<const float*>(q),    static_cast<const float*>(k),
                  static_cast<const float*>(v),    static_cast<const float*>(o),
                  static_cast<const float*>(dout), static_cast<const float*>(lse),
                  static_cast<float*>(dq),         static_cast<float*>(dk),
                  static_cast<float*>(dv),
                  {q_sb, q_st, q_sh},   {k_sb, k_st, k_sh},
                  {v_sb, v_st, v_sh},   {o_sb, o_st, o_sh},
                  {do_sb, do_st, do_sh}, {dq_sb, dq_st, dq_sh},
                  {dk_sb, dk_st, dk_sh}, {dv_sb, dv_st, dv_sh}};
  const int32_t* lens = static_cast<const int32_t*>(kv_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  switch (D) {
    case 16:
      return launch<16>(t, lens, B, H, Tq, Tk, causal, q_start, sm_scale, s, ws);
    case 32:
      return launch<32>(t, lens, B, H, Tq, Tk, causal, q_start, sm_scale, s, ws);
    case 64:
      return launch<64>(t, lens, B, H, Tq, Tk, causal, q_start, sm_scale, s, ws);
    case 128:
      return launch<128>(t, lens, B, H, Tq, Tk, causal, q_start, sm_scale, s,
                         ws);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
