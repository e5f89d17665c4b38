// Flash-attention backward in float32 on Hopper's tensor cores (sm_90a):
// split-TF32 warpgroup MMA ("3xTF32") fed by TMA, after a pre-pass that
// splits and transposes the operands; two launches, no atomics. Plain C
// entry points `flash_attn_bwd_f32` and `flash_attn_bwd_f32_workspace`,
// loaded with ctypes.
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
// where one TF32 product keeps 10. q, k, v and dO are split by the
// pre-pass; P, P^T, dS and dS^T are split in registers.
//
// What bounds it on an H100 SXM: five products of 2 * pairs * D flops over
// the kept (query, key) pairs, each three TF32 products; at B4 H4 T816 D64
// causal that is 16.6 GFLOP of TF32, 0.020 ms at the 495 TFLOP/s TF32
// peak, against 6.7 MB for q, k, v, o, dO and the three gradients, 0.002
// ms at 3.35 TB/s: bound by operations. The design:
//   - TF32 wgmma takes its shared-memory operands only K-major (there is
//     no transpose for 32-bit types): a product whose reduction runs over
//     queries (dV = P^T dO, dK = dS^T Q) needs dO and Q with the queries
//     contiguous, and dQ = dS K needs K with the keys contiguous. A
//     pre-pass (flash_bwd_f32_prep_kernel) reads q, k, v, o and dO through
//     the caller's strides (so any layout is taken) and writes into a
//     workspace the wrapper allocates, rows zero-filled to the 64-row
//     tile (keys past kv_len as zeros): the hi and lo parts of q, dO, k
//     and v as they are ([part][B*H][T][D]); of q, dO and k transposed
//     ([part][B*H][D][T]), through a shared tile, as the forward's
//     tf32_split_kernel writes v; lse in base 2 (lse2 = lse log2(e)) and
//     delta = rowsum(dO o) per query row (rows past Tq: lse2 = +inf, so
//     P = 0, and delta 0);
//   - inside each group of 8 positions the transposed copies hold the
//     positions in the order [0, 2, 4, 6, 1, 3, 5, 7] (key_at). The
//     accumulator of S^T (S) gives a thread columns 2t and 2t + 1 of each
//     group of 8, where the TF32 register-A fragment wants t and t + 4;
//     in that order they are the same, so P^T, dS^T (over queries) and dS
//     (over keys) go from the accumulator to the A fragment without a
//     shuffle. Each such product sums over the permuted index, so the
//     order is exact as long as both operands agree on it;
//   - one launch holds the dK/dV blocks and the dQ blocks (the card's
//     block scheduler fills every SM with whichever is left), as the bf16
//     backward does:
//     - dK/dV, one block per (64 keys, b*h): the split K and V tiles loaded
//       once; query tiles of kBlockQ (the split Q and dO as they are and
//       transposed) through TMA rings; per tile S^T = K Q^T and dP^T =
//       V dO^T (both operands K-major over D), P^T = 2^(S^T c - lse2),
//       dS^T = P^T (dP^T - delta), then dV += P^T dO and dK += dS^T Q
//       with P^T and dS^T split in registers against the transposed dO
//       and Q. Causal: the loop starts at the first query tile whose rows
//       see the key tile (row i >= k0 - q_start). Key tiles past kv_len
//       run no tile and store zeros; masked keys get P = 0 exactly;
//     - dQ, one block per (64 query rows, b*h): the split Q and dO tiles
//       loaded once; key tiles of kBlockN (K and V as they are, K
//       transposed) through the rings, up to the forward's key bound;
//       S = Q K^T, dP = dO V^T, dS = P (dP - delta), dQ += dS K;
//   - each block runs kConsumers warpgroups, each on every kConsumers-th
//     tile and feeding its own ring from its first thread (no producer
//     warp); their partial sums meet in shared memory at the end and are
//     added in one fixed order, so two calls agree bit for bit;
//   - tiles follow the float32 row width: a tile of D columns is boxes of
//     32 columns (128-byte swizzle; 16 columns and 64 bytes at D 16), a
//     transposed tile boxes of 32 positions (16 and 64 bytes for a tile of
//     16) by D rows; a k-step of 8 moves 32 bytes inside a swizzled row.
//     The tile sizes are what a block's 227 KB hold (Plan).
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

constexpr int kBlockM = 64;       // dQ: query rows of a block
constexpr int kBlockK = 64;       // dK/dV: keys of a block
constexpr int kRowPad = 64;       // workspace rows per b*h: T rounded up
constexpr int kPrepRows = 32;     // positions per pre-pass block
constexpr int kPrepThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -1e9f;
constexpr uint32_t kBarAll = 1;   // named barrier of a block's warpgroups
                                  // (2 + w: warpgroup w's own)

// Return codes besides cudaError_t values.
constexpr int kErrTensorMap = -1;  // a layout the TMA unit does not take
constexpr int kErrNoEncoder = -2;  // cuTensorMapEncodeTiled not found

struct Strides {  // element strides of a [B, T, H, D] tensor (D stride 1)
  long long b, t, h;
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - hi);
}

// The position held at place p of a group of 8 in the transposed copies.
__device__ __forceinline__ int key_at(int p) { return p < 4 ? 2 * p : 2 * p - 7; }

// Tile geometry for head dim D (see the design above). A natural tile of
// R rows is kBoxes boxes of R x kRowBytes; a transposed tile of R
// positions is R / pos_box(R) boxes of D rows x 4 pos_box(R) bytes.
template <int D>
struct Plan {
  static constexpr int kBoxD = D < 32 ? D : 32;
  static constexpr int kBoxes = D / kBoxD;
  static constexpr int kRowBytes = kBoxD * 4;
  static constexpr uint32_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kBlockQ = D == 128 ? 16 : 32;   // dK/dV query tile
  static constexpr int kBlockN = D == 16 ? 64 : 32;    // dQ key tile
  static constexpr int kConsumers = D == 128 ? 1 : 2;  // warpgroups a block
  static constexpr int kStages = D <= 32 ? 2 : 1;      // each one's ring
  static constexpr int kThreads = 128 * kConsumers;
  static constexpr int kNV = D < 64 ? D : 64;  // columns of one RS product
  static constexpr int kPart64 = kBlockM * D * 4;      // a 64-row part
  static constexpr int kBox64 = kBlockM * kRowBytes;
  static constexpr int kPartQ = kBlockQ * D * 4;       // dK/dV query tile
  static constexpr int kBoxQ = kBlockQ * kRowBytes;
  static constexpr int kPartN = kBlockN * D * 4;       // dQ key tile
  static constexpr int kBoxN = kBlockN * kRowBytes;
  // stages: dK/dV Q, dO (hi, lo each) as they are, then transposed; dQ
  // K, V (hi, lo each) as they are, then K transposed
  static constexpr int kStageKV = 8 * kPartQ;
  static constexpr int kStageQ = 6 * kPartN;
  static constexpr int kStageBars = kConsumers * kStages;
  static constexpr int kRingKV = kStageBars * kStageKV;
  static constexpr int kRingQ = kStageBars * kStageQ;
  static constexpr int kRing = kRingKV > kRingQ ? kRingKV : kRingQ;
  static constexpr int kBarriers = 4 * kPart64 + kRing;  // byte offset
  static constexpr int kSmem = kBarriers + 8 * (kStageBars + 1) + 1024;
  // the partial sums the warpgroups hand each other at the end
  static constexpr int kSwap = 2 * (kConsumers - 1) * 128 * (D / 2) * 4;
  static_assert(kSmem <= 232448, "shared memory");
  static_assert(kSwap <= kRingKV && kSwap <= kRingQ, "swap space");
};

__host__ __device__ constexpr int pos_box(int positions) {
  return positions < 32 ? positions : 32;
}

struct Params {
  float* dq;
  float* dk;
  float* dv;
  const float* lse2;   // [B*H, Tq_pad], written by the pre-pass
  const float* delta;  // [B*H, Tq_pad]
  const int32_t* kv_lens;
  long long dq_sb, dq_st, dq_sh;  // element strides of the b, t, h dims
  long long dk_sb, dk_st, dk_sh;
  long long dv_sb, dv_st, dv_sh;
  int H, Tq, Tk, Tq_pad, causal;
  int q_start;       // keys' position of query 0 (causal mask)
  float scale_log2;  // log2(e) / sqrt(D)
  float mask_raw;    // -1e9 * sqrt(D): a masked score before the scale
  float sm_scale;    // 1 / sqrt(D)
};

struct Prep {
  const float *q, *k, *v, *o, *dout, *lse;  // lse: [B*H, Tq]
  const int32_t* kv_lens;
  Strides qs, ks, vs, os, dos;
  float* nq;     // [4][B*H][Tq_pad][D]: q hi, q lo, dO hi, dO lo
  float* nk;     // [4][B*H][Tk_pad][D]: k hi, k lo, v hi, v lo
  float* tq;     // [4][B*H][D][Tq_pad]: the same of q and dO, transposed
  float* tk;     // [2][B*H][D][Tk_pad]: k hi, k lo, transposed
  float* lse2;   // [B*H][Tq_pad]
  float* delta;  // [B*H][Tq_pad]
  int H, Tq, Tk, Tq_pad, Tk_pad;
};

__device__ __forceinline__ int kv_len_of(const int32_t* kv_lens, int b,
                                         int Tk) {
  return kv_lens == nullptr ? Tk : min(max(kv_lens[b], 0), Tk);
}

// ---- 1. the pre-pass --------------------------------------------------------

// One block per (32 positions, b*h, tensor): blockIdx.z 0 splits q, 1 dO
// (and forms lse2 and delta of its rows), 2 k, 3 v. Each writes the hi and
// lo parts as they are; q, dO and k also transposed through a shared tile,
// so that both the reads and the writes are coalesced. Element n of a
// thread is threadIdx.x + 256 n of the block's 32 x D, and all of a
// thread's loads are issued before its first store.
template <int D>
__global__ void __launch_bounds__(kPrepThreads)
flash_bwd_f32_prep_kernel(const Prep p) {
  constexpr int kPer = kPrepRows * D / kPrepThreads;
  __shared__ float tile[kPrepRows][D + 1];
  const int z = blockIdx.z;
  const int bh = blockIdx.y;
  const int BH = gridDim.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int r0 = blockIdx.x * kPrepRows;
  const bool query_side = z < 2;
  const int pad = query_side ? p.Tq_pad : p.Tk_pad;
  if (r0 >= pad) return;
  const int valid = query_side ? p.Tq : kv_len_of(p.kv_lens, b, p.Tk);
  const float* src = z == 0 ? p.q : z == 1 ? p.dout : z == 2 ? p.k : p.v;
  const Strides s = z == 0 ? p.qs : z == 1 ? p.dos : z == 2 ? p.ks : p.vs;
  src += b * s.b + h * s.h;
  float x[kPer];
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int i = threadIdx.x + kPrepThreads * n;
    const int r = r0 + i / D;
    x[n] = r < valid ? src[(long long)r * s.t + i % D] : 0.f;
  }
  const long long part = (long long)BH * pad * D;
  float* dst = (query_side ? p.nq : p.nk) + (z % 2) * 2 * part +
               ((long long)bh * pad + r0) * D;
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int i = threadIdx.x + kPrepThreads * n;
    float hi, lo;
    split_tf32(x[n], hi, lo);
    dst[i] = hi;
    dst[part + i] = lo;
  }
  if (z == 3) return;
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int i = threadIdx.x + kPrepThreads * n;
    tile[i / D][i % D] = x[n];
  }
  __syncthreads();
  const long long tpart = (long long)BH * D * pad;
  float* tdst = (z == 2 ? p.tk : p.tq) + (z == 1 ? 2 * tpart : 0) +
                (long long)bh * D * pad + r0;
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int i = threadIdx.x + kPrepThreads * n;
    const int d = i / kPrepRows;
    const int pos = i % kPrepRows;
    float hi, lo;
    split_tf32(tile[(pos & ~7) + key_at(pos & 7)][d], hi, lo);
    tdst[(long long)d * pad + pos] = hi;
    tdst[tpart + (long long)d * pad + pos] = lo;
  }
  if (z != 1) return;
  // lse2 and delta of the block's 32 rows, 8 lanes a row: each lane sums
  // the products of every 8th column, then the lanes' sums in a fixed
  // butterfly
  const int row = threadIdx.x / 8;
  const int lane8 = threadIdx.x % 8;
  const int r = r0 + row;
  float dsum = 0.f;
  if (r < p.Tq) {
    const float* o_row = p.o + b * p.os.b + (long long)r * p.os.t + h * p.os.h;
#pragma unroll
    for (int j = lane8; j < D; j += 8) dsum = fmaf(tile[row][j], o_row[j], dsum);
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 4);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  if (lane8 == 0) {
    const long long at = (long long)bh * p.Tq_pad + r;
    p.lse2[at] = r < p.Tq ? p.lse[(long long)bh * p.Tq + r] * kLog2e : INFINITY;
    p.delta[at] = dsum;
  }
}

// ---- products -----------------------------------------------------------------

// acc [64 x N] = A [64 x D] B [N x D]^T in split TF32: A's hi part at a
// (its lo part a_part bytes on, its column boxes a_box bytes apart), B's
// at b likewise; both K-major tiles in shared memory. lo*hi, hi*lo, hi*hi
// in k-steps of 8 (32 bytes inside one swizzled row). Issues the wgmmas
// only: the caller fences, commits and waits.
template <int D, int N>
__device__ __forceinline__ void mma3_abt(float (&acc)[N / 2], uint32_t a,
                                         int a_part, int a_box, uint32_t b,
                                         int b_part, int b_box) {
  using P = Plan<D>;
  constexpr int kSteps = P::kBoxD / 8;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const uint32_t at = a + (t == 0 ? a_part : 0);
    const uint32_t bt = b + (t == 1 ? b_part : 0);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int x = kk / kSteps;
      const int w = kk % kSteps;
      const uint64_t da = make_desc(at + x * a_box + 32 * w, 16,
                                    8 * P::kRowBytes, P::kLayout);
      const uint64_t db = make_desc(bt + x * b_box + 32 * w, 16,
                                    8 * P::kRowBytes, P::kLayout);
      WgmmaTf32SS<N>::run(acc, da, db, t > 0 || kk > 0);
    }
  }
}

// acc [64 x D] += X [64 x K] B [K x D] in split TF32, X from registers as
// the hi and lo A fragments of its K / 8 k-steps (split_frags), B a
// transposed tile of K positions in shared memory (its hi part at bt, its
// lo part b_part bytes on): lo*hi, hi*lo, hi*hi, the D columns as D / kNV
// products of kNV. Issues the wgmmas only.
template <int D, int K>
__device__ __forceinline__ void mma3_rs(float (&acc)[D / 2],
                                        const uint32_t (&hi)[K / 8][4],
                                        const uint32_t (&lo)[K / 8][4],
                                        uint32_t bt, int b_part) {
  using P = Plan<D>;
  constexpr int kPos = pos_box(K);
  constexpr int kRow = kPos * 4;            // bytes of a transposed row
  constexpr int kBox = D * kRow;            // one box of D rows
  constexpr int kSteps = kPos / 8;
  constexpr uint32_t kLayoutT = kRow == 128 ? 1 : 2;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
#pragma unroll
    for (int j = 0; j < K / 8; ++j) {
#pragma unroll
      for (int c = 0; c < D / P::kNV; ++c) {
        const uint64_t db = make_desc(
            bt + (t == 1 ? b_part : 0) + j / kSteps * kBox + c * P::kNV * kRow +
                32 * (j % kSteps),
            16, 8 * kRow, kLayoutT);
        WgmmaTf32RS<P::kNV>::run(
            *reinterpret_cast<float(*)[P::kNV / 2]>(acc + c * P::kNV / 2),
            t == 0 ? lo[j] : hi[j], db, 1);
      }
    }
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

// Sets masked scores of an accumulator [64 rows x N cols] to mask_raw. This
// thread's element e sits at row row0 + 8 ((e / 2) % 2) and column
// col_base + 8 (e / 4) + col0 + e % 2 (sm90.cuh). keys_are_rows: the rows
// are keys and the columns queries (S^T), else the transpose.
template <int N>
__device__ __forceinline__ void apply_mask(float (&s)[N / 2], const Params& p,
                                           int kv_len, int row0,
                                           int col_base, int col0,
                                           bool keys_are_rows) {
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const int row = row0 + 8 * ((e / 2) % 2);
    const int col = col_base + 8 * (e / 4) + col0 + (e % 2);
    const int key = keys_are_rows ? row : col;
    const int query = keys_are_rows ? col : row;
    const bool keep =
        key < kv_len && (!p.causal || key <= query + p.q_start);
    s[e] = keep ? s[e] : p.mask_raw;
  }
}

// Stores rows [row0, row0 + 8] of an accumulator [64 x D] times `scale`
// into x (b, h fixed at x's base), rows >= n not.
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

// Partial sums between warpgroups: thread t of one holds the same elements
// as thread t of another, so element e of thread t sits at buf[e * 128 +
// t].
template <int N>
__device__ __forceinline__ void to_swap(const float (&x)[N], float* buf,
                                        int t) {
#pragma unroll
  for (int e = 0; e < N; ++e) buf[e * 128 + t] = x[e];
}

template <int N>
__device__ __forceinline__ void add_swap(float (&x)[N], const float* buf,
                                         int t) {
#pragma unroll
  for (int e = 0; e < N; ++e) x[e] += buf[e * 128 + t];
}

// Ring barriers full[w][s] (warpgroup w's loads of stage s), n of them,
// then one for the tiles loaded once; each completes on its loader's
// arrival and bytes.
__device__ __forceinline__ void init_barriers(uint32_t bar_full, int n,
                                              uint32_t bar_once) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < n; ++s) mbar_init(bar_full + 8 * s, 1);
    mbar_init(bar_once, 1);
    fence_mbar_init();
  }
  __syncthreads();
}

// Copies `parts` parts of `rows` rows at row r0 of b*h `bh` from a natural
// workspace map (its box kBoxD x rows) to dst, the parts part_bytes apart.
template <int D>
__device__ __forceinline__ void load_natural(uint32_t dst, const CUtensorMap* map,
                                             uint32_t bar, int parts,
                                             int part_bytes, int box_bytes,
                                             int r0, int bh) {
  using P = Plan<D>;
  for (int part = 0; part < parts; ++part)
    for (int x = 0; x < P::kBoxes; ++x)
      tma_load_4d(dst + part * part_bytes + x * box_bytes, map, bar,
                  x * P::kBoxD, r0, bh, part);
}

// Copies `parts` parts of positions [r0, r0 + positions) of b*h `bh` from a
// transposed workspace map (its box pos_box(positions) x D) to dst.
template <int D>
__device__ __forceinline__ void load_transposed(uint32_t dst,
                                                const CUtensorMap* map,
                                                uint32_t bar, int parts,
                                                int positions, int r0, int bh) {
  const int pb = pos_box(positions);
  for (int part = 0; part < parts; ++part)
    for (int y = 0; y < positions / pb; ++y)
      tma_load_4d(dst + part * positions * D * 4 + y * D * pb * 4, map, bar,
                  r0 + pb * y, 0, bh, part);
}

// ---- 2. dQ ------------------------------------------------------------------

struct Maps {
  CUtensorMap qdo64;  // q / dO hi, lo as they are, boxes of 64 rows
  CUtensorMap qdo_q;  // the same, boxes of kBlockQ rows
  CUtensorMap kv64;   // k / v hi, lo as they are, boxes of 64 rows
  CUtensorMap kv_n;   // the same, boxes of kBlockN rows
  CUtensorMap qdo_t;  // q / dO transposed, boxes of pos_box(kBlockQ)
  CUtensorMap k_t;    // k transposed, boxes of pos_box(kBlockN)
};

// Warpgroup w's tile li of a dQ block: key tile w + kConsumers li into its
// ring's stage li % kStages (K, V as they are, then K transposed).
template <int D>
__device__ __forceinline__ void load_kv(const Maps& m, uint32_t s_ring,
                                        uint32_t bar_full, int wg, int li,
                                        int bh) {
  using P = Plan<D>;
  const int st = wg * P::kStages + li % P::kStages;
  const uint32_t full = bar_full + 8 * st;
  const uint32_t s = s_ring + st * P::kStageQ;
  const int kb = (wg + P::kConsumers * li) * P::kBlockN;
  mbar_arrive_expect_tx(full, P::kStageQ);
  load_natural<D>(s, &m.kv_n, full, 4, P::kPartN, P::kBoxN, kb, bh);
  load_transposed<D>(s + 4 * P::kPartN, &m.k_t, full, 2, P::kBlockN, kb, bh);
}

// dQ of the 64 query rows qblk of b*h blockIdx.x.
template <int D>
__device__ __forceinline__ void dq_block(const Maps& m, const Params& p,
                                         int qblk) {
  using P = Plan<D>;
  constexpr int BN = P::kBlockN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gen = smem_raw + (base - smem_u32(smem_raw));  // generic view
  const uint32_t s_q = base;  // Q hi, Q lo, dO hi, dO lo
  const uint32_t s_do = base + 2 * P::kPart64;
  const uint32_t s_ring = base + 4 * P::kPart64;
  const uint32_t bar_full = base + P::kBarriers;
  const uint32_t bar_q = bar_full + 8 * P::kStageBars;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = qblk * kBlockM;
  const int kv_len = kv_len_of(p.kv_lens, b, p.Tk);
  const int n_keys =
      p.causal ? min(kv_len, p.q_start + min(p.Tq, q0 + kBlockM)) : kv_len;
  const int n_tiles = (n_keys + BN - 1) / BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int wl = warp % 4;
  const bool loader = threadIdx.x % 128 == 0;  // the warpgroup's TMA thread
  // warpgroup w takes key tiles w, w + kConsumers, ...
  const int n_mine = (n_tiles - wg + P::kConsumers - 1) / P::kConsumers;
  init_barriers(bar_full, P::kStageBars, bar_q);
  if (loader) {
    if (wg == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(bar_q, 4 * P::kPart64);
      load_natural<D>(s_q, &m.qdo64, bar_q, 4, P::kPart64, P::kBox64, q0, bh);
    }
    for (int li = 0; li < min(P::kStages, n_mine); ++li)
      load_kv<D>(m, s_ring, bar_full, wg, li, bh);
  }

  const int row0 = q0 + 16 * wl + lane / 4;
  const int col0 = 2 * (lane % 4);
  float lse2[2], delta[2];  // of rows row0 and row0 + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = (long long)bh * p.Tq_pad + row0 + 8 * r;
    lse2[r] = p.lse2[at];
    delta[r] = p.delta[at];
  }

  constexpr int kS = BN / 2;
  constexpr int kO = D / 2;
  float dq_acc[kO], s_acc[kS], dp_acc[kS];
  uint32_t dh[BN / 8][4], dl[BN / 8][4];
#pragma unroll
  for (int e = 0; e < kO; ++e) dq_acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kS; ++e) s_acc[e] = dp_acc[e] = 0.f;
  if (n_mine > 0) mbar_wait(bar_q, 0);

  for (int li = 0; li < n_mine; ++li) {
    const int st = wg * P::kStages + li % P::kStages;
    const uint32_t s_k = s_ring + st * P::kStageQ;  // K hi, K lo, V hi, V lo
    const uint32_t s_kt = s_k + 4 * P::kPartN;      // K^T hi, K^T lo
    const int kb = (wg + P::kConsumers * li) * BN;
    mbar_wait(bar_full + 8 * st, (li / P::kStages) & 1);

    // S = Q K^T and dP = dO V^T
    fence_operands(s_acc);
    fence_operands(dp_acc);
    wgmma_fence();
    mma3_abt<D, BN>(s_acc, s_q, P::kPart64, P::kBox64, s_k, P::kPartN,
                    P::kBoxN);
    mma3_abt<D, BN>(dp_acc, s_do, P::kPart64, P::kBox64, s_k + 2 * P::kPartN,
                    P::kPartN, P::kBoxN);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s_acc);
    fence_operands(dp_acc);

    if (kb + BN > kv_len || (p.causal && kb + BN - 1 > p.q_start + q0))
      apply_mask<BN>(s_acc, p, kv_len, row0, kb, col0, false);
    // P = 2^(S c - lse2) and dS = P (dP - delta), per row
#pragma unroll
    for (int e = 0; e < kS; ++e) {
      const int r = (e / 2) % 2;
      const float pe = ex2(fmaf(s_acc[e], p.scale_log2, -lse2[r]));
      dp_acc[e] = pe * (dp_acc[e] - delta[r]);
    }
    split_frags<BN>(dp_acc, dh, dl);
    // the scores are dead until the next tile's product overwrites them;
    // zeros let their registers go free meanwhile
#pragma unroll
    for (int e = 0; e < kS; ++e) s_acc[e] = dp_acc[e] = 0.f;

    // dQ += dS K against K^T
    fence_operands(dq_acc);
    wgmma_fence();
    mma3_rs<D, BN>(dq_acc, dh, dl, s_kt, P::kPartN);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq_acc);
    fence_frags<BN>(dh);
    fence_frags<BN>(dl);

    // every product that read the stage has completed: reload it
    bar_sync(2 + wg, 128);
    if (loader && li + P::kStages < n_mine)
      load_kv<D>(m, s_ring, bar_full, wg, li + P::kStages, bh);
  }

  // dQ = the warpgroups' sums added in order, through the ring's memory
  // once all are done with it
  const int t = threadIdx.x % 128;
  if (P::kConsumers > 1) {
    float* swap = reinterpret_cast<float*>(gen + 4 * P::kPart64);
    bar_sync(kBarAll, P::kThreads);
    if (wg > 0) to_swap<kO>(dq_acc, swap + (wg - 1) * kO * 128, t);
    bar_sync(kBarAll, P::kThreads);
    if (wg == 0)
#pragma unroll
      for (int w = 1; w < P::kConsumers; ++w)
        add_swap<kO>(dq_acc, swap + (w - 1) * kO * 128, t);
  }
  if (wg == 0)
    store_rows<D>(dq_acc, p.sm_scale, p.dq + b * p.dq_sb + h * p.dq_sh,
                  p.dq_st, row0, col0, p.Tq);
}

// ---- 3. dK and dV -----------------------------------------------------------

// Warpgroup w's tile li of a dK/dV block: query tile first + w +
// kConsumers li into its ring's stage li % kStages (Q, dO as they are,
// then transposed).
template <int D>
__device__ __forceinline__ void load_qdo(const Maps& m, uint32_t s_ring,
                                         uint32_t bar_full, int wg, int li,
                                         int first, int bh) {
  using P = Plan<D>;
  const int st = wg * P::kStages + li % P::kStages;
  const uint32_t full = bar_full + 8 * st;
  const uint32_t s = s_ring + st * P::kStageKV;
  const int qb = (first + wg + P::kConsumers * li) * P::kBlockQ;
  mbar_arrive_expect_tx(full, P::kStageKV);
  load_natural<D>(s, &m.qdo_q, full, 4, P::kPartQ, P::kBoxQ, qb, bh);
  load_transposed<D>(s + 4 * P::kPartQ, &m.qdo_t, full, 4, P::kBlockQ, qb, bh);
}

// dK and dV of the 64 keys kblk of b*h blockIdx.x.
template <int D>
__device__ __forceinline__ void dkdv_block(const Maps& m, const Params& p,
                                           int kblk) {
  using P = Plan<D>;
  constexpr int BQ = P::kBlockQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gen = smem_raw + (base - smem_u32(smem_raw));  // generic view
  const uint32_t s_k = base;  // K hi, K lo, V hi, V lo
  const uint32_t s_v = base + 2 * P::kPart64;
  const uint32_t s_ring = base + 4 * P::kPart64;
  const uint32_t bar_full = base + P::kBarriers;
  const uint32_t bar_kv = bar_full + 8 * P::kStageBars;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = kblk * kBlockK;
  const int kv_len = kv_len_of(p.kv_lens, b, p.Tk);
  // query tiles whose rows see a key of this tile: causal, rows from
  // k0 - q_start on; none when the tile lies past kv_len
  const int q_tiles = (p.Tq + BQ - 1) / BQ;
  const int first = p.causal ? max(0, k0 - p.q_start) / BQ : 0;
  const int n_it = k0 < kv_len ? max(0, q_tiles - first) : 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int wl = warp % 4;
  const bool loader = threadIdx.x % 128 == 0;  // the warpgroup's TMA thread
  // warpgroup w takes query tiles first + w, first + w + kConsumers, ...
  const int n_mine = (n_it - wg + P::kConsumers - 1) / P::kConsumers;
  init_barriers(bar_full, P::kStageBars, bar_kv);
  if (loader) {
    if (wg == 0 && n_it > 0) {
      mbar_arrive_expect_tx(bar_kv, 4 * P::kPart64);
      load_natural<D>(s_k, &m.kv64, bar_kv, 4, P::kPart64, P::kBox64, k0, bh);
    }
    for (int li = 0; li < min(P::kStages, n_mine); ++li)
      load_qdo<D>(m, s_ring, bar_full, wg, li, first, bh);
  }

  // This thread holds keys row0 and row0 + 8 of the tile (accumulator
  // rows) in every warpgroup.
  const int row0 = k0 + 16 * wl + lane / 4;
  const int col0 = 2 * (lane % 4);
  constexpr int kS = BQ / 2;  // S^T / dP^T accumulators per thread
  constexpr int kO = D / 2;   // dK / dV accumulators per thread
  float dv_acc[kO], dk_acc[kO], s_acc[kS], dp_acc[kS];
  // the A fragments of P^T and of dS^T (hi and lo parts)
  uint32_t ph[BQ / 8][4], pl[BQ / 8][4], dh[BQ / 8][4], dl[BQ / 8][4];
#pragma unroll
  for (int e = 0; e < kO; ++e) dv_acc[e] = dk_acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kS; ++e) s_acc[e] = dp_acc[e] = 0.f;
  if (n_mine > 0) mbar_wait(bar_kv, 0);

  for (int li = 0; li < n_mine; ++li) {
    const int st = wg * P::kStages + li % P::kStages;
    const uint32_t s_q = s_ring + st * P::kStageKV;  // Q hi, lo, dO hi, lo
    const uint32_t s_do = s_q + 2 * P::kPartQ;
    const uint32_t s_qt = s_q + 4 * P::kPartQ;       // the same, transposed
    const uint32_t s_dot = s_qt + 2 * P::kPartQ;
    const int qb = (first + wg + P::kConsumers * li) * BQ;
    mbar_wait(bar_full + 8 * st, (li / P::kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T
    fence_operands(s_acc);
    fence_operands(dp_acc);
    wgmma_fence();
    mma3_abt<D, BQ>(s_acc, s_k, P::kPart64, P::kBox64, s_q, P::kPartQ,
                    P::kBoxQ);
    mma3_abt<D, BQ>(dp_acc, s_v, P::kPart64, P::kBox64, s_do, P::kPartQ,
                    P::kBoxQ);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s_acc);
    fence_operands(dp_acc);

    if (k0 + kBlockK > kv_len ||
        (p.causal && k0 + kBlockK - 1 > qb + p.q_start))
      apply_mask<BQ>(s_acc, p, kv_len, row0, qb, col0, true);
    // P^T = 2^(S^T c - lse2) and dS^T = P^T (dP^T - delta), per query
    // column
    const float* lse2 = p.lse2 + (long long)bh * p.Tq_pad + qb + col0;
    const float* delta = p.delta + (long long)bh * p.Tq_pad + qb + col0;
#pragma unroll
    for (int e = 0; e < kS; ++e) {
      const int c = 8 * (e / 4) + (e % 2);
      const float pe = ex2(fmaf(s_acc[e], p.scale_log2, -__ldg(lse2 + c)));
      s_acc[e] = pe;
      dp_acc[e] = pe * (dp_acc[e] - __ldg(delta + c));
    }
    split_frags<BQ>(s_acc, ph, pl);
    split_frags<BQ>(dp_acc, dh, dl);
#pragma unroll
    for (int e = 0; e < kS; ++e) s_acc[e] = dp_acc[e] = 0.f;

    // dV += P^T dO and dK += dS^T Q against the transposed dO and Q
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    wgmma_fence();
    mma3_rs<D, BQ>(dv_acc, ph, pl, s_dot, P::kPartQ);
    mma3_rs<D, BQ>(dk_acc, dh, dl, s_qt, P::kPartQ);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    fence_frags<BQ>(ph);
    fence_frags<BQ>(pl);
    fence_frags<BQ>(dh);
    fence_frags<BQ>(dl);

    // every product that read the stage has completed: reload it
    bar_sync(2 + wg, 128);
    if (loader && li + P::kStages < n_mine)
      load_qdo<D>(m, s_ring, bar_full, wg, li + P::kStages, first, bh);
  }

  // warpgroup 0 stores dK and the last warpgroup dV, each the warpgroups'
  // parts added in order 0 + 1 (IEEE addition commutes), through the
  // ring's memory once all are done with it: slot w - 1 holds warpgroup
  // w's dK part, and the slots after them warpgroup 0's dV part
  const int t = threadIdx.x % 128;
  if (P::kConsumers > 1) {
    static_assert(P::kConsumers <= 2, "dV's sum takes two warpgroups");
    float* swap = reinterpret_cast<float*>(gen + 4 * P::kPart64);
    float* dv_slot = swap + (P::kConsumers - 1) * kO * 128;
    bar_sync(kBarAll, P::kThreads);
    if (wg > 0) to_swap<kO>(dk_acc, swap + (wg - 1) * kO * 128, t);
    if (wg == 0) to_swap<kO>(dv_acc, dv_slot, t);
    bar_sync(kBarAll, P::kThreads);
    if (wg == 0) {
      add_swap<kO>(dk_acc, swap, t);
    } else {
      add_swap<kO>(dv_acc, dv_slot, t);
    }
  }
  if (wg == 0)
    store_rows<D>(dk_acc, p.sm_scale, p.dk + b * p.dk_sb + h * p.dk_sh,
                  p.dk_st, row0, col0, p.Tk);
  if (wg == P::kConsumers - 1)
    store_rows<D>(dv_acc, 1.f, p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_st,
                  row0, col0, p.Tk);
}

// ---- 4. the dQ and dK/dV blocks in one launch -------------------------------

// blockIdx.z 0 holds the dK/dV blocks, which go out first, and 1 the dQ
// blocks; blockIdx.y is the block of its kind, heaviest first under the
// causal mask (the dK/dV blocks of the first keys, the dQ blocks of the
// last queries); past its kind's count none.
template <int D>
__global__ void __launch_bounds__(Plan<D>::kThreads, 1)
flash_bwd_f32_kernel(const __grid_constant__ Maps m, const Params p) {
  const int y = blockIdx.y;
  if (blockIdx.z == 0) {
    if (y < (p.Tk + kBlockK - 1) / kBlockK) dkdv_block<D>(m, p, y);
  } else {
    const int n = p.Tq_pad / kBlockM;
    if (y < n) dq_block<D>(m, p, p.causal ? n - 1 - y : y);
  }
}

// ---- host -------------------------------------------------------------------

// Floats of each part of the workspace, in its order: nq, nk, tq, tk,
// lse2, delta (Prep).
struct Layout {
  long long nq, nk, tq, tk, stats;
  Layout(int BH, int Tq_pad, int Tk_pad, int D)
      : nq(4LL * BH * Tq_pad * D), nk(4LL * BH * Tk_pad * D), tq(nq),
        tk(2LL * BH * Tk_pad * D), stats((long long)BH * Tq_pad) {}
  long long floats() const { return nq + nk + tq + tk + 2 * stats; }
};

// A tensor map over a float32 workspace array [parts][B*H][rows][cols]; a
// box is box_cols x box_rows of one (part, b*h).
bool make_map(EncodeTiled encode, CUtensorMap* map, float* ptr, int parts,
              int BH, int rows, int cols, int box_cols, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)BH, (cuuint64_t)parts};
  const cuuint64_t row = (cuuint64_t)cols * 4;
  const cuuint64_t strides[3] = {row, row * rows, row * rows * BH};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols * 4 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
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
  const int Tk_pad = round_up(Tk, kRowPad);
  const Layout L(BH, Tq_pad, Tk_pad, D);
  Prep pp;
  pp.q = t.q, pp.k = t.k, pp.v = t.v, pp.o = t.o, pp.dout = t.dout;
  pp.lse = t.lse;
  pp.kv_lens = kv_lens;
  pp.qs = t.qs, pp.ks = t.ks, pp.vs = t.vs, pp.os = t.os, pp.dos = t.dos;
  pp.nq = ws;
  pp.nk = pp.nq + L.nq;
  pp.tq = pp.nk + L.nk;
  pp.tk = pp.tq + L.tq;
  pp.lse2 = pp.tk + L.tk;
  pp.delta = pp.lse2 + L.stats;
  pp.H = H, pp.Tq = Tq, pp.Tk = Tk, pp.Tq_pad = Tq_pad, pp.Tk_pad = Tk_pad;

  Maps m;
  if (!make_map(encode, &m.qdo64, pp.nq, 4, BH, Tq_pad, D, P::kBoxD, kBlockM) ||
      !make_map(encode, &m.qdo_q, pp.nq, 4, BH, Tq_pad, D, P::kBoxD,
                P::kBlockQ) ||
      !make_map(encode, &m.kv64, pp.nk, 4, BH, Tk_pad, D, P::kBoxD, kBlockK) ||
      !make_map(encode, &m.kv_n, pp.nk, 4, BH, Tk_pad, D, P::kBoxD,
                P::kBlockN) ||
      !make_map(encode, &m.qdo_t, pp.tq, 4, BH, D, Tq_pad,
                pos_box(P::kBlockQ), D) ||
      !make_map(encode, &m.k_t, pp.tk, 2, BH, D, Tk_pad, pos_box(P::kBlockN),
                D))
    return kErrTensorMap;

  auto grads = flash_bwd_f32_kernel<D>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        grads, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }

  Params p;
  p.dq = t.dq, p.dk = t.dk, p.dv = t.dv;
  p.lse2 = pp.lse2;
  p.delta = pp.delta;
  p.kv_lens = kv_lens;
  p.dq_sb = t.dqs.b, p.dq_st = t.dqs.t, p.dq_sh = t.dqs.h;
  p.dk_sb = t.dks.b, p.dk_st = t.dks.t, p.dk_sh = t.dks.h;
  p.dv_sb = t.dvs.b, p.dv_st = t.dvs.t, p.dv_sh = t.dvs.h;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.Tq_pad = Tq_pad;
  p.causal = causal;
  p.q_start = q_start;
  p.scale_log2 = sm_scale * kLog2e;
  p.mask_raw = kMaskValue / sm_scale;
  p.sm_scale = sm_scale;

  const int t_pad = Tq_pad > Tk_pad ? Tq_pad : Tk_pad;
  flash_bwd_f32_prep_kernel<D>
      <<<dim3(t_pad / kPrepRows, BH, 4), kPrepThreads, 0, stream>>>(pp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // b*h in x, the block in y: blocks go out in order of y
  const int nq = Tq_pad / kBlockM;
  const int nk = Tk_pad / kBlockK;
  grads<<<dim3(BH, nq > nk ? nq : nk, 2), P::kThreads, P::kSmem, stream>>>(m,
                                                                           p);
  return cudaGetLastError();
}

}  // namespace

// Floats of workspace the backward needs for these sizes (Layout).
extern "C" long long flash_attn_bwd_f32_workspace(int B, int H, int Tq, int Tk,
                                                  int D) {
  return Layout(B * H, round_up(Tq, kRowPad), round_up(Tk, kRowPad), D)
      .floats();
}

// Strides are in elements, for the b, t and h dims of each [B, T, H, D]
// float32 tensor (the D stride must be 1; q, k, v, o and dO are read with
// plain loads through any strides; dq, dk and dv written with 8-byte
// stores, their bases 8-byte aligned). lse: the forward's float32
// [B, H, Tq], contiguous. kv_lens: int32 [B] on the device, or null for
// "all Tk keys valid". workspace: flash_attn_bwd_f32_workspace(B, H, Tq,
// Tk, D) floats on the device, 16-byte aligned. Launches the pre-pass and
// the kernel on `stream`, in that order. Returns 0 when both were
// launched, a cudaError_t value if a launch failed, -1 if the TMA unit
// refused the workspace's layout, -2 if libcuda has no
// cuTensorMapEncodeTiled.
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
      round_up(Tk, kRowPad) / kBlockK > 65535 ||
      round_up(Tq, kRowPad) / kBlockM > 65535)
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
