// Flash-attention backward in bfloat16 on Hopper's tensor cores (sm_90a):
// warpgroup MMA (wgmma) fed by TMA, three launches, no atomics. Plain C
// entry point `flash_attn_bwd_wgmma`, loaded with ctypes.
//
// Replaces the JAX package's backward of the Pallas TPU kernel,
// unast_tpu/ops/attention.py::_flash_vjp_bwd (a jnp recompute behind
// custom_vjp, with _ref_scores), for bfloat16 inputs. Given q [B, Tq, H, D],
// k and v [B, Tk, H, D], the forward output o and its gradient dO [B, Tq, H,
// D], it computes, with the forward's mask (key j of row b kept when
// j < kv_lens[b] and, if causal, j <= i + q_start; masked scores -1e9):
//   s = q k^T / sqrt(D) in float32, lse = logsumexp(s), P = exp(s - lse),
//   dV = P^T dO, dP = dO V^T, delta = rowsum(dO o),
//   dS = P (dP - delta) / sqrt(D), dQ = dS K, dK = dS^T Q,
// each gradient cast to bfloat16. lse is recomputed here, as JAX does: the
// forward's schema keeps no residual but o.
//
// Accuracy: every product takes bf16 operands with float32 accumulation.
// q, k, v and dO are bf16 already, so S, dP and delta are exact products
// summed in float32. P and dS are float32 values; as operands of dV, dK and
// dQ they are split into a bf16 high part and a bf16 low part (split_bf16)
// and both go through the tensor cores, so the products carry 16 bits of P
// and dS, as JAX's float32 backward does, not the 8 of one bf16 rounding.
//
// What bounds it on an H100 SXM: five products of 2 * pairs * D flops (S,
// dV, dP, dQ, dK) over the kept (query, key) pairs; at B4 H4 T816 D64 that
// is 5.5 GFLOP, 5.5 us at the 989 TFLOP/s bf16 peak, against 3.3 us for
// the bytes of q, k, v, o, dO and the three gradients: compute-bound. This
// design does 11 products (the S and dP recomputes in two passes, the split
// doubling dV, dK and dQ), and a warpgroup overlaps only its own
// elementwise work with the product in flight (P is formed while dP runs,
// dS while dV runs), so it is simple first, not fast. Design:
//   1. pre-pass, one block per (64 query rows, b*h): S = Q K^T over the
//      key tiles the rows can see (the forward's key bound), the forward's
//      online max and sum in base 2, then lse2 = m c + log2(l) with
//      c = log2(e) / sqrt(D), so that P = 2^(S c - lse2); and delta from
//      o and dO read straight from global memory. Both float32 [B*H, Tq
//      rounded up to 64] in a workspace the wrapper allocates; rows past Tq
//      get lse2 = +inf (P = 0) and delta 0;
//   2. dK/dV, one block per (64 keys, b*h): K and V tiles loaded once by
//      TMA; Q and dO tiles of kBlockQ queries (64, or 32 at D 128 for the
//      registers: the dK and dV accumulators are D floats a thread) and
//      their lse2 and delta (a bulk copy) stream through a two-stage ring.
//      Per tile, S^T = K Q^T and dP^T = V dO^T (both operands K-major in
//      shared memory), then P^T = 2^(S^T c - lse2) and dS^T = P^T (dP^T -
//      delta) in registers, and dV += P^T dO, dK += dS^T Q with P^T and dS^T
//      as register A operands (the accumulator's fragment is the A
//      fragment, as P in the forward's P V) and dO and Q as MN-major
//      (trans-b) B operands. Causal: the loop starts at the first query
//      tile whose rows see the key tile (row i >= k0 - q_start). Key tiles
//      past kv_len, or past every query's reach, run no tile and store
//      zeros; masked keys inside a tile get P = 0, so their rows are 0;
//   3. dQ, one block per (64 query rows, b*h): Q and dO tiles loaded once,
//      K and V tiles through the ring (the forward's key bound); S = Q K^T,
//      dP = dO V^T, P and dS from the row's lse2 and delta, dQ += dS K with
//      K as the MN-major B operand.
// Each output element is summed by one thread in a fixed order, so two
// calls on the same inputs agree bit for bit. dK and dQ take the scale
// once, at the store; rows past Tq or Tk are neither read (TMA zero-fills
// them) nor stored.
//
// Precondition: every kv_len >= 1, as the forward's. A row with no visible
// key gets lse2 = +inf and zero gradients; that is not a contract.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 64;  // rows of a block: one consumer warpgroup
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kStages = 2;   // depth of the streamed ring
constexpr int kConsumerWarps = 4;
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr int kRowPad = 64;  // workspace rows per b*h: Tq rounded up to it
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -1e9f;

// Return codes besides cudaError_t values.
constexpr int kErrTensorMap = -1;  // a layout the TMA unit does not take
constexpr int kErrNoEncoder = -2;  // cuTensorMapEncodeTiled not found

// Tile geometry for head dim D: a tile of `rows` rows is kBoxes boxes of
// rows x kBoxD columns, each box rows x kRowBytes bytes in the TMA swizzle
// (32 B for D 16, 64 B for D 32, 128 B for D 64 and 128).
template <int D>
struct Plan {
  static constexpr int kBoxD = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kBoxD;
  static constexpr int kRowBytes = kBoxD * 2;
  static constexpr uint32_t kLayout =
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kBlockQ = D == 128 ? 32 : 64;  // dK/dV query tile
  static constexpr int kBox = 64 * kRowBytes;          // a 64-row box
  static constexpr int kBoxQ = kBlockQ * kRowBytes;    // a kBlockQ-row box
  static constexpr int kTile = kBoxes * kBox;
  static constexpr int kTileQ = kBoxes * kBoxQ;
};

// Shared memory of each kernel: 1024-byte aligned tiles, then the per-stage
// lse2 and delta rows (dK/dV only), then the mbarriers.
template <int D>
struct Smem {
  using P = Plan<D>;
  static constexpr int kBarriers = 8 * (2 * kStages + 1);
  // pre-pass: Q, then a ring of K tiles
  static constexpr int kPreBars = P::kTile + kStages * P::kTile;
  static constexpr int kPre = kPreBars + kBarriers + 1024;
  // dK/dV: K, V, then a ring of (Q, dO) tiles, then the ring's lse2 / delta
  static constexpr int kKVStats = 2 * P::kTile + kStages * 2 * P::kTileQ;
  static constexpr int kKVBars = kKVStats + kStages * 2 * P::kBlockQ * 4;
  static constexpr int kKV = kKVBars + kBarriers + 1024;
  // dQ: Q, dO, then a ring of (K, V) tiles
  static constexpr int kDQBars = 2 * P::kTile + kStages * 2 * P::kTile;
  static constexpr int kDQ = kDQBars + kBarriers + 1024;
};

struct Params {
  const __nv_bfloat16* o;     // forward output (pre-pass)
  const __nv_bfloat16* dout;  // its gradient (pre-pass)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* lse2;   // [B*H, Tq_pad] log2-domain logsumexp of the scaled scores
  float* delta;  // [B*H, Tq_pad] rowsum(dO o)
  const int32_t* kv_lens;
  long long o_sb, o_st, o_sh;  // element strides of the b, t, h dims
  long long do_sb, do_st, do_sh;
  long long dq_sb, dq_st, dq_sh;
  long long dk_sb, dk_st, dk_sh;
  long long dv_sb, dv_st, dv_sh;
  int H, Tq, Tk, Tq_pad, causal;
  int q_start;       // keys' position of query 0 (causal mask)
  float scale_log2;  // log2(e) / sqrt(D)
  float mask_raw;    // -1e9 * sqrt(D): a masked score before the scale
  float sm_scale;    // 1 / sqrt(D)
};

__device__ __forceinline__ int kv_len_of(const Params& p, int b) {
  return p.kv_lens == nullptr ? p.Tk : min(max(p.kv_lens[b], 0), p.Tk);
}

// Keys visible to some row of the query block [q0, q0 + kBlockM): the
// forward's key bound.
__device__ __forceinline__ int keys_seen(const Params& p, int kv_len, int q0) {
  return p.causal ? min(kv_len, p.q_start + min(p.Tq, q0 + kBlockM)) : kv_len;
}

__device__ __forceinline__ void init_barriers(uint32_t bar_full,
                                              uint32_t bar_empty,
                                              uint32_t bar_once) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    mbar_init(bar_once, 1);
    fence_mbar_init();
  }
  __syncthreads();
}

// acc [64 x N] = A [64 x D] B[N x D]^T, both K-major tiles in shared memory
// (A's boxes a_box bytes apart, B's b_box), in k-steps of 16 (32 bytes
// inside one swizzle row). Issues the wgmmas only: the caller fences,
// commits and waits.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 2], uint32_t s_a,
                                        int a_box, uint32_t s_b, int b_box) {
  using P = Plan<D>;
  constexpr int kSteps = P::kBoxD / 16;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int x = kk / kSteps;
    const int w = kk % kSteps;
    const uint64_t da = make_desc(s_a + x * a_box + 32 * w, 16,
                                  8 * P::kRowBytes, P::kLayout);
    const uint64_t db = make_desc(s_b + x * b_box + 32 * w, 16,
                                  8 * P::kRowBytes, P::kLayout);
    WgmmaSS<N>::run(acc, da, db, kk > 0);
  }
}

// acc [64 x D] += X [64 x K] B [K x D]: X from registers as high and low
// bf16 parts (the low part first, small terms first), B a [K rows x D]
// tile in shared memory read as the MN-major (trans-b) operand, its
// 64-column boxes b_box bytes apart. Issues the wgmmas only.
template <int D, int K>
__device__ __forceinline__ void mma_split(float (&acc)[D / 2],
                                          const uint32_t (&hi)[K / 16][4],
                                          const uint32_t (&lo)[K / 16][4],
                                          uint32_t s_b, int b_box) {
  using P = Plan<D>;
#pragma unroll
  for (int t = 0; t < K / 16; ++t) {
    const uint64_t db = make_desc(s_b + 16 * t * P::kRowBytes, b_box,
                                  8 * P::kRowBytes, P::kLayout);
    WgmmaRS<D>::run(acc, lo[t], db, 1);
    WgmmaRS<D>::run(acc, hi[t], db, 1);
  }
}

// An accumulator of N columns as the A fragments of N / 16 k-steps: step t
// covers columns 16t..16t+15, the accumulator's column blocks 2t and 2t+1.
template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N / 2],
                                           uint32_t (&hi)[N / 16][4],
                                           uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int t = 0; t < N / 16; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(x[8 * t + 2 * r], x[8 * t + 2 * r + 1], hi[t][r], lo[t][r]);
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

// Stores rows [r0, r0 + 64) of an accumulator [64 x D] times `scale` as
// bf16 into x (b, h fixed at x's base), rows >= n not.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float scale, __nv_bfloat16* x,
                                           long long st, int row0, int col0,
                                           int n) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < n) {
      __nv_bfloat16* out = x + (long long)row * st + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                  acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// ---- 1. pre-pass: lse2 and delta ------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_prepass_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const Params p) {
  using P = Plan<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = base + P::kTile;  // + stage * kTile
  const uint32_t bar_full = base + Smem<D>::kPreBars;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_q = bar_empty + 8 * kStages;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBlockM;
  const int kv_len = kv_len_of(p, b);
  const int n_tiles = (keys_seen(p, kv_len, q0) + kBlockN - 1) / kBlockN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  init_barriers(bar_full, bar_empty, bar_q);

  if (warp == kConsumerWarps) {
    if (lane == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(bar_q, P::kTile);
      for (int x = 0; x < P::kBoxes; ++x)
        tma_load_4d(s_q + x * P::kBox, &map_q, bar_q, x * P::kBoxD, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(bar_empty + 8 * s, (i / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_arrive_expect_tx(full, P::kTile);
        for (int x = 0; x < P::kBoxes; ++x)
          tma_load_4d(s_k + s * P::kTile + x * P::kBox, &map_k, full,
                      x * P::kBoxD, h, i * kBlockN, b);
      }
    }
    return;
  }

  // This thread holds rows row0 and row0 + 8 (accumulator layout).
  const int row0 = q0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);

  // delta = rowsum(dO o): each of the row's 4 lanes sums D / 4 products.
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < p.Tq) {
      const __nv_bfloat16* o_row =
          p.o + b * p.o_sb + (long long)row * p.o_st + h * p.o_sh + col0;
      const __nv_bfloat16* do_row =
          p.dout + b * p.do_sb + (long long)row * p.do_st + h * p.do_sh + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 ov = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o_row + 8 * j));
        const float2 dv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(do_row + 8 * j));
        delta[r] = fmaf(dv.x, ov.x, delta[r]);
        delta[r] = fmaf(dv.y, ov.y, delta[r]);
      }
    }
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
  }

  constexpr int kS = kBlockN / 2;
  float s_acc[kS];
#pragma unroll
  for (int e = 0; e < kS; ++e) s_acc[e] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};  // this thread's part of the row sums

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
    fence_operands(s_acc);
    wgmma_fence();
    mma_abt<D, kBlockN>(s_acc, s_q, P::kBox, s_k + s * P::kTile, P::kBox);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);

    const int kb = i * kBlockN;
    if (kb + kBlockN > kv_len ||
        (p.causal && kb + kBlockN - 1 > p.q_start + q0))
      apply_mask<kBlockN>(s_acc, p, kv_len, row0, kb, col0, false);

    // the forward's online max and sum, on unscaled scores
    float m_new[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int e = 0; e < kS; ++e)
      m_new[(e / 2) % 2] = fmaxf(m_new[(e / 2) % 2], s_acc[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      l_row[r] *= ex2((m_row[r] - m_new[r]) * p.scale_log2);  // 0 at first
      m_row[r] = m_new[r];
      m_new[r] *= p.scale_log2;
    }
#pragma unroll
    for (int e = 0; e < kS; ++e)
      l_row[(e / 2) % 2] += ex2(fmaf(s_acc[e], p.scale_log2, -m_new[(e / 2) % 2]));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    const bool valid = row < p.Tq && l > 0.f;
    if (lane % 4 == 0) {
      const long long at = (long long)bh * p.Tq_pad + row;
      p.lse2[at] = valid ? fmaf(m_row[r], p.scale_log2, log2f(l)) : INFINITY;
      p.delta[at] = valid ? delta[r] : 0.f;
    }
  }
}

// ---- 2. dK and dV -----------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const Params p) {
  using P = Plan<D>;
  constexpr int BQ = P::kBlockQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = base;
  const uint32_t s_v = base + P::kTile;
  const uint32_t s_ring = base + 2 * P::kTile;  // stage: Q tile, dO tile
  const uint32_t s_stats = base + Smem<D>::kKVStats;  // stage: lse2, delta
  const float* stats = reinterpret_cast<const float*>(
      smem_raw + (s_stats - smem_u32(smem_raw)));
  const uint32_t bar_full = base + Smem<D>::kKVBars;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_kv = bar_empty + 8 * kStages;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.x * kBlockN;
  const int kv_len = kv_len_of(p, b);
  // query tiles whose rows see a key of this tile: causal, rows from
  // k0 - q_start on; none when the tile lies past kv_len
  const int q_tiles = (p.Tq + BQ - 1) / BQ;
  const int first = p.causal ? max(0, k0 - p.q_start) / BQ : 0;
  const int n_it = k0 < kv_len ? max(0, q_tiles - first) : 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  init_barriers(bar_full, bar_empty, bar_kv);

  if (warp == kConsumerWarps) {
    if (lane == 0 && n_it > 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * P::kTile);
      for (int x = 0; x < P::kBoxes; ++x) {
        tma_load_4d(s_k + x * P::kBox, &map_k, bar_kv, x * P::kBoxD, h, k0, b);
        tma_load_4d(s_v + x * P::kBox, &map_v, bar_kv, x * P::kBoxD, h, k0, b);
      }
      for (int i = 0; i < n_it; ++i) {
        const int s = i % kStages;
        const int qb = (first + i) * BQ;
        if (i >= kStages) mbar_wait(bar_empty + 8 * s, (i / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t s_q = s_ring + s * 2 * P::kTileQ;
        const uint32_t s_do = s_q + P::kTileQ;
        const uint32_t s_st = s_stats + s * 2 * BQ * 4;
        mbar_arrive_expect_tx(full, 2 * P::kTileQ + 2 * BQ * 4);
        for (int x = 0; x < P::kBoxes; ++x) {
          tma_load_4d(s_q + x * P::kBoxQ, &map_q, full, x * P::kBoxD, h, qb, b);
          tma_load_4d(s_do + x * P::kBoxQ, &map_do, full, x * P::kBoxD, h, qb,
                      b);
        }
        const long long at = (long long)bh * p.Tq_pad + qb;
        bulk_load(s_st, p.lse2 + at, BQ * 4, full);
        bulk_load(s_st + BQ * 4, p.delta + at, BQ * 4, full);
      }
    }
    return;
  }

  // This thread holds keys row0 and row0 + 8 of the tile (accumulator rows).
  const int row0 = k0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  constexpr int kS = BQ / 2;  // S^T / dP^T accumulators per thread
  constexpr int kO = D / 2;   // dK / dV accumulators per thread
  float dv_acc[kO], dk_acc[kO], s_acc[kS], dp_acc[kS];
#pragma unroll
  for (int e = 0; e < kO; ++e) dv_acc[e] = dk_acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kS; ++e) s_acc[e] = dp_acc[e] = 0.f;

  if (n_it > 0) mbar_wait(bar_kv, 0);
  for (int i = 0; i < n_it; ++i) {
    const int s = i % kStages;
    const int qb = (first + i) * BQ;
    const uint32_t s_q = s_ring + s * 2 * P::kTileQ;
    const uint32_t s_do = s_q + P::kTileQ;
    const float* lse2 = stats + s * 2 * BQ;
    const float* delta = lse2 + BQ;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T, committed apart so that P^T is
    // formed while dP^T is still on the tensor cores
    fence_operands(s_acc);
    fence_operands(dp_acc);
    wgmma_fence();
    mma_abt<D, BQ>(s_acc, s_k, P::kBox, s_q, P::kBoxQ);
    wgmma_commit();
    mma_abt<D, BQ>(dp_acc, s_v, P::kBox, s_do, P::kBoxQ);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(s_acc);

    if (k0 + kBlockN > kv_len ||
        (p.causal && k0 + kBlockN - 1 > qb + p.q_start))
      apply_mask<BQ>(s_acc, p, kv_len, row0, qb, col0, true);

    // P^T = 2^(S^T c - lse2) per query column, then dV += P^T dO, which
    // runs while dS^T is formed
#pragma unroll
    for (int e = 0; e < kS; ++e) {
      const int col = 8 * (e / 4) + col0 + (e % 2);
      s_acc[e] = ex2(fmaf(s_acc[e], p.scale_log2, -lse2[col]));
    }
    uint32_t ph[BQ / 16][4], pl[BQ / 16][4], dh[BQ / 16][4], dl[BQ / 16][4];
    split_frag<BQ>(s_acc, ph, pl);
    fence_operands(dv_acc);
    wgmma_fence();
    mma_split<D, BQ>(dv_acc, ph, pl, s_do, P::kBoxQ);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T done
    fence_operands(dp_acc);

    // dS^T = P^T (dP^T - delta), then dK += dS^T Q
#pragma unroll
    for (int e = 0; e < kS; ++e) {
      const int col = 8 * (e / 4) + col0 + (e % 2);
      dp_acc[e] = s_acc[e] * (dp_acc[e] - delta[col]);
    }
    split_frag<BQ>(dp_acc, dh, dl);
    fence_operands(dk_acc);
    wgmma_fence();
    mma_split<D, BQ>(dk_acc, dh, dl, s_q, P::kBoxQ);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(dv_acc);
    fence_operands(dk_acc);

    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  store_rows<D>(dv_acc, 1.f, p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_st, row0,
                col0, p.Tk);
  store_rows<D>(dk_acc, p.sm_scale, p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_st,
                row0, col0, p.Tk);
}

// ---- 3. dQ --------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const Params p) {
  using P = Plan<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_do = base + P::kTile;
  const uint32_t s_ring = base + 2 * P::kTile;  // stage: K tile, V tile
  const uint32_t bar_full = base + Smem<D>::kDQBars;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_q = bar_empty + 8 * kStages;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBlockM;
  const int kv_len = kv_len_of(p, b);
  const int n_tiles = (keys_seen(p, kv_len, q0) + kBlockN - 1) / kBlockN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  init_barriers(bar_full, bar_empty, bar_q);

  if (warp == kConsumerWarps) {
    if (lane == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(bar_q, 2 * P::kTile);
      for (int x = 0; x < P::kBoxes; ++x) {
        tma_load_4d(s_q + x * P::kBox, &map_q, bar_q, x * P::kBoxD, h, q0, b);
        tma_load_4d(s_do + x * P::kBox, &map_do, bar_q, x * P::kBoxD, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(bar_empty + 8 * s, (i / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t s_k = s_ring + s * 2 * P::kTile;
        const uint32_t s_v = s_k + P::kTile;
        mbar_arrive_expect_tx(full, 2 * P::kTile);
        for (int x = 0; x < P::kBoxes; ++x) {
          tma_load_4d(s_k + x * P::kBox, &map_k, full, x * P::kBoxD, h,
                      i * kBlockN, b);
          tma_load_4d(s_v + x * P::kBox, &map_v, full, x * P::kBoxD, h,
                      i * kBlockN, b);
        }
      }
    }
    return;
  }

  const int row0 = q0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = (long long)bh * p.Tq_pad + row0 + 8 * r;
    lse2[r] = p.lse2[at];
    delta[r] = p.delta[at];
  }
  constexpr int kS = kBlockN / 2;
  constexpr int kO = D / 2;
  float dq_acc[kO], s_acc[kS], dp_acc[kS];
#pragma unroll
  for (int e = 0; e < kO; ++e) dq_acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kS; ++e) s_acc[e] = dp_acc[e] = 0.f;

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t s_k = s_ring + s * 2 * P::kTile;
    const uint32_t s_v = s_k + P::kTile;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);

    // S = Q K^T and dP = dO V^T, committed apart so that P is formed
    // while dP is still on the tensor cores
    fence_operands(s_acc);
    fence_operands(dp_acc);
    wgmma_fence();
    mma_abt<D, kBlockN>(s_acc, s_q, P::kBox, s_k, P::kBox);
    wgmma_commit();
    mma_abt<D, kBlockN>(dp_acc, s_do, P::kBox, s_v, P::kBox);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(s_acc);

    const int kb = i * kBlockN;
    if (kb + kBlockN > kv_len ||
        (p.causal && kb + kBlockN - 1 > p.q_start + q0))
      apply_mask<kBlockN>(s_acc, p, kv_len, row0, kb, col0, false);

    // P = 2^(S c - lse2), then dS = P (dP - delta), per row
#pragma unroll
    for (int e = 0; e < kS; ++e)
      s_acc[e] = ex2(fmaf(s_acc[e], p.scale_log2, -lse2[(e / 2) % 2]));
    wgmma_wait_all();
    fence_operands(dp_acc);
#pragma unroll
    for (int e = 0; e < kS; ++e)
      dp_acc[e] = s_acc[e] * (dp_acc[e] - delta[(e / 2) % 2]);
    uint32_t dh[kBlockN / 16][4], dl[kBlockN / 16][4];
    split_frag<kBlockN>(dp_acc, dh, dl);

    // dQ += dS K
    fence_operands(dq_acc);
    wgmma_fence();
    mma_split<D, kBlockN>(dq_acc, dh, dl, s_k, P::kBox);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(dq_acc);

    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  store_rows<D>(dq_acc, p.sm_scale, p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_st,
                row0, col0, p.Tq);
}

// ---- host ---------------------------------------------------------------------

struct Strides {  // element strides of a [B, T, H, D] tensor (D stride 1)
  long long b, t, h;
};

// Tensor map over the (D, H, T, B) view of a bf16 [B, T, H, D] tensor; a
// box is kBoxD columns of `rows` positions of one head of one batch row.
template <int D>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
              int T, int H, Strides st, int rows) {
  using P = Plan<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.t * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)P::kBoxD, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      P::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : P::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raises the kernel's dynamic shared-memory limit to `bytes`, once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

struct Tensors {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
};

template <int D>
int launch(const Tensors& t, const void* kv_lens, int B, int H, int Tq,
           int Tk, int causal, int q_start, float sm_scale,
           cudaStream_t stream, float* workspace) {
  using P = Plan<D>;
  using S = Smem<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  CUtensorMap map_q, map_q_tile, map_k, map_v, map_do, map_do_tile;
  if (!make_map<D>(encode, &map_q, t.q, B, Tq, H, t.qs, kBlockM) ||
      !make_map<D>(encode, &map_q_tile, t.q, B, Tq, H, t.qs, P::kBlockQ) ||
      !make_map<D>(encode, &map_k, t.k, B, Tk, H, t.ks, kBlockN) ||
      !make_map<D>(encode, &map_v, t.v, B, Tk, H, t.vs, kBlockN) ||
      !make_map<D>(encode, &map_do, t.dout, B, Tq, H, t.dos, kBlockM) ||
      !make_map<D>(encode, &map_do_tile, t.dout, B, Tq, H, t.dos, P::kBlockQ))
    return kErrTensorMap;
  auto prepass = flash_bwd_prepass_kernel<D>;
  auto dkdv = flash_bwd_dkdv_kernel<D>;
  auto dq = flash_bwd_dq_kernel<D>;
  static bool pre_set = false, kv_set = false, dq_set = false;
  cudaError_t err = allow_smem(prepass, S::kPre, pre_set);
  if (err == cudaSuccess) err = allow_smem(dkdv, S::kKV, kv_set);
  if (err == cudaSuccess) err = allow_smem(dq, S::kDQ, dq_set);
  if (err != cudaSuccess) return err;

  Params p;
  p.o = static_cast<const __nv_bfloat16*>(t.o);
  p.dout = static_cast<const __nv_bfloat16*>(t.dout);
  p.dq = static_cast<__nv_bfloat16*>(t.dq);
  p.dk = static_cast<__nv_bfloat16*>(t.dk);
  p.dv = static_cast<__nv_bfloat16*>(t.dv);
  p.Tq_pad = (Tq + kRowPad - 1) / kRowPad * kRowPad;
  p.lse2 = workspace;
  p.delta = workspace + (long long)B * H * p.Tq_pad;
  p.kv_lens = static_cast<const int32_t*>(kv_lens);
  p.o_sb = t.os.b, p.o_st = t.os.t, p.o_sh = t.os.h;
  p.do_sb = t.dos.b, p.do_st = t.dos.t, p.do_sh = t.dos.h;
  p.dq_sb = t.dqs.b, p.dq_st = t.dqs.t, p.dq_sh = t.dqs.h;
  p.dk_sb = t.dks.b, p.dk_st = t.dks.t, p.dk_sh = t.dks.h;
  p.dv_sb = t.dvs.b, p.dv_st = t.dvs.t, p.dv_sh = t.dvs.h;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.causal = causal;
  p.q_start = q_start;
  p.scale_log2 = sm_scale * kLog2e;
  p.mask_raw = kMaskValue / sm_scale;
  p.sm_scale = sm_scale;

  const dim3 q_grid(p.Tq_pad / kBlockM, B * H);
  const dim3 k_grid((Tk + kBlockN - 1) / kBlockN, B * H);
  prepass<<<q_grid, kThreads, S::kPre, stream>>>(map_q, map_k, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<k_grid, kThreads, S::kKV, stream>>>(map_q_tile, map_k, map_v,
                                              map_do_tile, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq<<<q_grid, kThreads, S::kDQ, stream>>>(map_q, map_k, map_v, map_do, p);
  return cudaGetLastError();
}

}  // namespace

// Floats of workspace the backward needs: lse2 and delta, each
// [B*H, Tq rounded up to 64].
extern "C" long long flash_attn_bwd_wgmma_workspace(int B, int H, int Tq,
                                                    int D) {
  (void)D;
  return 2LL * B * H * ((Tq + kRowPad - 1) / kRowPad * kRowPad);
}

// Strides are in elements, for the b, t and h dims of each [B, T, H, D]
// bfloat16 tensor (the D stride must be 1; q, k, v and dO strides and base
// addresses multiples of 16 bytes, as TMA reads them; o is read with plain
// loads, dq, dk and dv written with them). kv_lens: int32 [B] on the
// device, or null for "all Tk keys valid". workspace: float32, at least
// flash_attn_bwd_wgmma_workspace(B, H, Tq, D) of them, 16-byte aligned.
// Returns 0 when the three kernels were launched, a cudaError_t value if a
// launch failed, -1 if the TMA unit refused a tensor's layout, -2 if
// libcuda has no cuTensorMapEncodeTiled.
extern "C" int flash_attn_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* kv_lens,
    int B, int H, int Tq, int Tk, int D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, long long do_sb, long long do_st,
    long long do_sh, long long dq_sb, long long dq_st, long long dq_sh,
    long long dk_sb, long long dk_st, long long dk_sh, long long dv_sb,
    long long dv_st, long long dv_sh, int causal, int q_start, float sm_scale,
    void* stream, void* workspace) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Tensors t{q, k, v, o, dout, dq, dk, dv,
                  {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
                  {o_sb, o_st, o_sh}, {do_sb, do_st, do_sh},
                  {dq_sb, dq_st, dq_sh}, {dk_sb, dk_st, dk_sh},
                  {dv_sb, dv_st, dv_sh}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  switch (D) {
    case 16:
      return launch<16>(t, kv_lens, B, H, Tq, Tk, causal, q_start, sm_scale, s,
                        ws);
    case 32:
      return launch<32>(t, kv_lens, B, H, Tq, Tk, causal, q_start, sm_scale, s,
                        ws);
    case 64:
      return launch<64>(t, kv_lens, B, H, Tq, Tk, causal, q_start, sm_scale, s,
                        ws);
    case 128:
      return launch<128>(t, kv_lens, B, H, Tq, Tk, causal, q_start, sm_scale,
                         s, ws);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
