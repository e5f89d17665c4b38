// Flash-attention backward in bfloat16 on Hopper's tensor cores (sm_90a):
// warpgroup MMA (wgmma) fed by TMA, two launches, no atomics. Plain C
// entry point `flash_attn_bwd_wgmma`, loaded with ctypes.
//
// Replaces the JAX package's backward of the Pallas TPU kernel,
// unast_tpu/ops/attention.py::_flash_vjp_bwd (a jnp recompute behind
// custom_vjp, with _ref_scores), for bfloat16 inputs. Given q [B, Tq, H, D],
// k and v [B, Tk, H, D], the forward output o, its lse [B, H, Tq] (natural
// log, the residual the forward kernels write) and the gradient dO [B, Tq,
// H, D], it computes, with the forward's mask (key j of row b kept when
// j < kv_lens[b] and, if causal, j <= i + q_start; masked scores -1e9):
//   s = q k^T / sqrt(D) in float32, P = exp(s - lse),
//   dV = P^T dO, dP = dO V^T, delta = rowsum(dO o),
//   dS = P (dP - delta) / sqrt(D), dQ = dS K, dK = dS^T Q,
// each gradient cast to bfloat16. JAX recomputes lse from s; here it is
// the forward's, so no pass recomputes S only for it.
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
// design does 10 products (S and dP for both kinds of block, the split
// doubling dV, dK and dQ) on 64-wide tiles, and what holds it back is the
// latency of each warpgroup's chain S -> P -> dS -> products (an ex2 and
// two bf16 conversions a pair on the way). Against that:
//   - lse comes from the forward, so no pass recomputes S for it;
//   - the dQ and the dK/dV blocks share one launch, so the card's block
//     scheduler fills every SM with whichever work is left, and neither
//     kind leaves SMs idle in a last partial wave of its own;
//   - several warpgroups a block (3 at D <= 64, 2 at D 128, whose
//     accumulators are twice as large), each on every kConsumers-th tile,
//     so a block's chain is shorter and each SM holds as many chains to
//     fill the tensor cores with; their partial sums meet in shared memory
//     at the end, added in one fixed order;
//   - each warpgroup's loop is software-pipelined: the next tile's S and
//     dP are issued right behind this tile's gradient products, and those
//     go out a k-step (16 columns of P or dS) at a time, so the tensor
//     cores start on them while the rest is formed;
//   - each warpgroup feeds its own ring: its first thread reloads a stage
//     as soon as the products that read it have completed. With no
//     producer warp a block is 8 or 12 warps, 2 or 3 to each quarter of
//     the register file, so a thread may hold 255 or 168 registers (a
//     producer warp beside two warpgroups capped them at 168 and the D 128
//     loop spilled);
//   - P^T, dS^T and dS stay in registers as the A operands of their
//     products (bf16 hi and lo fragments, P^T's reused for dS^T k-step by
//     k-step), which measured faster than writing them to shared memory
//     for shared-memory operands.
// Launches:
//   1. lse2 and delta, one thread per 8 columns of a query row: lse2 = lse
//      log2(e), so that P = 2^(S c - lse2) with c = log2(e) / sqrt(D), and
//      delta = rowsum(dO o), into a workspace the wrapper allocates
//      (float32 [B*H, Tq rounded up to 64]; rows past Tq get lse2 = +inf,
//      so P = 0, and delta 0): one read of o and dO, one memory round trip;
//   2. the dK/dV blocks, which go out first, and the dQ blocks:
//      - dK/dV, one block per (64 keys, b*h): K and V tiles loaded once; Q
//        and dO tiles of kBlockQ queries (64, or 32 at D 128 for the
//        registers) and their lse2 and delta (a bulk copy) through the
//        rings; per tile S^T = K Q^T and dP^T = V dO^T, P^T and dS^T, then
//        dV += P^T dO and dK += dS^T Q with dO and Q read MN-major
//        (trans-b) from the same tiles. Causal: the loop starts at the
//        first query tile whose rows see the key tile (row i >= k0 -
//        q_start). Key tiles past kv_len run no tile and store zeros;
//        masked keys inside a tile get P = 0, so their rows are 0;
//      - dQ, one block per (64 query rows, b*h): Q and dO tiles loaded
//        once, K and V tiles of 64 keys through the rings (the forward's
//        key bound); S = Q K^T, dP = dO V^T, P, dS = P (dP - delta),
//        dQ += dS K.
// Each output element is the sum of the warpgroups' partials, each summed
// by one thread in a fixed order and added in a fixed order, so two calls
// on the same inputs agree bit for bit. dK and dQ take the scale once, at
// the store; rows past Tq or Tk are neither read (TMA zero-fills them) nor
// stored.
//
// Precondition: every kv_len >= 1, as the forward's. A row with no visible
// key has no defined lse; that is not a contract.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 64;    // dQ: query rows of a block
constexpr int kBlockN = 64;    // keys per K/V tile; dK/dV: keys of a block
constexpr int kStages = 2;     // depth of each warpgroup's ring
constexpr int kRowPad = 64;    // workspace rows per b*h: Tq rounded up to it
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -1e9f;
constexpr uint32_t kBarAll = 1;  // named barrier of a block's warpgroups

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
  // warpgroups a block, each on every kConsumers-th tile: 3 fit a thread's
  // 168 registers at D <= 64, D 128's accumulators want 2
  static constexpr int kConsumers = D == 128 ? 2 : 3;
  static constexpr int kThreads = kConsumers * 128;
  static constexpr int kBox = 64 * kRowBytes;          // a 64-row box
  static constexpr int kBoxQ = kBlockQ * kRowBytes;    // a kBlockQ-row box
  static constexpr int kTile = kBoxes * kBox;
  static constexpr int kTileQ = kBoxes * kBoxQ;
  // the partial sums the warpgroups hand each other: kConsumers - 1 dK or
  // dQ parts and as many dV parts, D / 2 floats each of 128 threads
  static constexpr int kSwap = 2 * (kConsumers - 1) * 128 * (D / 2) * 4;
};

// Shared memory of each kind of block (the launch reserves the larger):
// the tiles loaded once, then the rings (kConsumers x kStages stages,
// 1024-byte aligned), then the per-stage lse2 and delta rows (dK/dV only),
// then the mbarriers. At the end the rings hold the partial sums.
template <int D>
struct Smem {
  using P = Plan<D>;
  static constexpr int kStageBars = P::kConsumers * kStages;
  static constexpr int kBarriers = 8 * (kStageBars + 1);
  // dQ: Q, dO, then the rings of (K, V) tiles
  static constexpr int kDQRing = 2 * P::kTile;
  static constexpr int kDQBars = kDQRing + kStageBars * 2 * P::kTile;
  static constexpr int kDQ = kDQBars + kBarriers + 1024;
  // dK/dV: K, V, the rings of (Q, dO) tiles, then the rings' lse2 / delta
  static constexpr int kKVRing = 2 * P::kTile;
  static constexpr int kKVStats = kKVRing + kStageBars * 2 * P::kTileQ;
  static constexpr int kKVBars = kKVStats + kStageBars * 2 * P::kBlockQ * 4;
  static constexpr int kKV = kKVBars + kBarriers + 1024;
  static_assert(kStageBars * 2 * P::kTile >= P::kSwap, "dQ swap space");
  static_assert(kStageBars * 2 * P::kTileQ >= P::kSwap, "dK/dV swap space");
  static_assert(kDQ <= 232448 && kKV <= 232448, "shared memory");
};

struct Params {
  const __nv_bfloat16* o;     // forward output (delta)
  const __nv_bfloat16* dout;  // its gradient (delta)
  const float* lse;           // [B*H, Tq] the forward's natural-log lse
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* lse2;   // [B*H, Tq_pad] lse log2(e), written by the pre-pass
  float* delta;  // [B*H, Tq_pad] rowsum(dO o), written by the pre-pass
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

// acc [64 x D] += X[:, 16t:16t+16] B[16t:16t+16, :], k-step t of a product
// whose A operand X comes from registers as its high and low bf16 parts
// (split_bf16; the low part first, small terms first) and whose B is a
// [K rows x D] tile in shared memory read as the MN-major (trans-b)
// operand, its 64-column boxes b_box bytes apart. Issues the wgmmas only.
template <int D>
__device__ __forceinline__ void mma_split_step(float (&acc)[D / 2],
                                               const uint32_t (&hi)[4],
                                               const uint32_t (&lo)[4],
                                               uint32_t s_b, int b_box,
                                               int t) {
  using P = Plan<D>;
  const uint64_t db = make_desc(s_b + 16 * t * P::kRowBytes, b_box,
                                8 * P::kRowBytes, P::kLayout);
  WgmmaRS<D>::run(acc, lo, db, 1);
  WgmmaRS<D>::run(acc, hi, db, 1);
}

// Keeps A fragments in their registers up to here: a register-A wgmma
// reads them after it is issued, until the wait that ends it.
__device__ __forceinline__ void fence_frag_step(uint32_t (&x)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(x[r])::"memory");
}

template <int K>
__device__ __forceinline__ void fence_frag(uint32_t (&x)[K / 16][4]) {
#pragma unroll
  for (int t = 0; t < K / 16; ++t) fence_frag_step(x[t]);
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

// s_acc [64 x N] = A0 B0^T and dp_acc [64 x N] = A1 B1^T (mma_abt) once
// the ring stage's "full" barrier has completed the phase of `parity`,
// committed as two groups so that P is formed while dP still runs.
template <int D, int N>
__device__ __forceinline__ void issue_s_dp(float (&s_acc)[N / 2],
                                           float (&dp_acc)[N / 2],
                                           uint32_t a0, uint32_t b0,
                                           uint32_t a1, uint32_t b1,
                                           int a_box, int b_box,
                                           uint32_t full, uint32_t parity) {
  mbar_wait(full, parity);
  fence_operands(s_acc);
  fence_operands(dp_acc);
  wgmma_fence();
  mma_abt<D, N>(s_acc, a0, a_box, b0, b_box);
  wgmma_commit();
  mma_abt<D, N>(dp_acc, a1, a_box, b1, b_box);
  wgmma_commit();
}

// ---- 1. lse2 and delta ------------------------------------------------------

// One block per (128 / (D / 8) rows, b*h): lse2 = lse log2(e) and
// delta = rowsum(dO o) of each row into the workspace; rows past Tq get
// lse2 = +inf (P = 0) and delta 0. A row is D / 8 lanes, each summing the
// products of 8 columns read as one 16-byte word of o and of dO, then the
// lanes' sums in a fixed butterfly. Every load is issued before the first
// sum: the launch is one memory round trip.
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_delta_kernel(const Params p) {
  constexpr int kLanes = D / 8;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int c = (threadIdx.x % kLanes) * 8;
  const int row = blockIdx.y * (128 / kLanes) + threadIdx.x / kLanes;
  const bool first = threadIdx.x % kLanes == 0;  // the lane that stores
  uint4 ow = make_uint4(0, 0, 0, 0), dw = ow;
  float lse2 = INFINITY;
  if (row < p.Tq) {
    ow = *reinterpret_cast<const uint4*>(
        p.o + b * p.o_sb + (long long)row * p.o_st + h * p.o_sh + c);
    dw = *reinterpret_cast<const uint4*>(
        p.dout + b * p.do_sb + (long long)row * p.do_st + h * p.do_sh + c);
    if (first) lse2 = p.lse[(long long)bh * p.Tq + row] * kLog2e;
  }
  const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ow);
  const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dw);
  float d = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 of = __bfloat1622float2(op[j]);
    const float2 df = __bfloat1622float2(dp[j]);
    d = fmaf(df.x, of.x, d);
    d = fmaf(df.y, of.y, d);
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m /= 2)
    d += __shfl_xor_sync(0xffffffffu, d, m);
  if (first) {
    const long long at = (long long)bh * p.Tq_pad + row;
    p.lse2[at] = lse2;
    p.delta[at] = d;
  }
}

// ---- 2. dQ ------------------------------------------------------------------

// Warpgroup w's tile li of a dQ block: key tile w + kConsumers li into its
// ring's stage li % kStages (K, then V).
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* map_k,
                                        const CUtensorMap* map_v,
                                        uint32_t s_ring, uint32_t bar_full,
                                        int wg, int li, int h, int b) {
  using P = Plan<D>;
  const int st = wg * kStages + li % kStages;
  const uint32_t full = bar_full + 8 * st;
  const uint32_t s_k = s_ring + st * 2 * P::kTile;
  const int k0 = (wg + P::kConsumers * li) * kBlockN;
  mbar_arrive_expect_tx(full, 2 * P::kTile);
  for (int x = 0; x < P::kBoxes; ++x) {
    tma_load_4d(s_k + x * P::kBox, map_k, full, x * P::kBoxD, h, k0, b);
    tma_load_4d(s_k + P::kTile + x * P::kBox, map_v, full, x * P::kBoxD, h,
                k0, b);
  }
}

// dQ of the 64 query rows qblk of b*h blockIdx.x.
template <int D>
__device__ __forceinline__ void dq_block(const CUtensorMap& map_q,
                                         const CUtensorMap& map_k,
                                         const CUtensorMap& map_v,
                                         const CUtensorMap& map_do,
                                         const Params& p, int qblk) {
  using P = Plan<D>;
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gen = smem_raw + (base - smem_u32(smem_raw));  // generic view
  const uint32_t s_q = base;
  const uint32_t s_do = base + P::kTile;
  const uint32_t s_ring = base + S::kDQRing;  // [w][s]: K tile, V tile
  const uint32_t bar_full = base + S::kDQBars;
  const uint32_t bar_q = bar_full + 8 * S::kStageBars;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = qblk * kBlockM;
  const int kv_len = kv_len_of(p, b);
  const int n_keys =
      p.causal ? min(kv_len, p.q_start + min(p.Tq, q0 + kBlockM)) : kv_len;
  const int n_tiles = (n_keys + kBlockN - 1) / kBlockN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int wl = warp % 4;
  const bool loader = threadIdx.x % 128 == 0;  // the warpgroup's TMA thread
  // warpgroup w takes key tiles w, w + kConsumers, ...
  const int n_mine = (n_tiles - wg + P::kConsumers - 1) / P::kConsumers;
  init_barriers(bar_full, S::kStageBars, bar_q);
  if (loader) {
    if (wg == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(bar_q, 2 * P::kTile);
      for (int x = 0; x < P::kBoxes; ++x) {
        tma_load_4d(s_q + x * P::kBox, &map_q, bar_q, x * P::kBoxD, h, q0, b);
        tma_load_4d(s_do + x * P::kBox, &map_do, bar_q, x * P::kBoxD, h, q0, b);
      }
    }
    for (int li = 0; li < min(kStages, n_mine); ++li)
      load_kv<D>(&map_k, &map_v, s_ring, bar_full, wg, li, h, b);
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

  constexpr int kS = kBlockN / 2;
  constexpr int kO = D / 2;
  float dq_acc[kO], s_acc[kS], dp_acc[kS];
  uint32_t dh[kBlockN / 16][4] = {}, dl[kBlockN / 16][4] = {};
#pragma unroll
  for (int e = 0; e < kO; ++e) dq_acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kS; ++e) s_acc[e] = dp_acc[e] = 0.f;

  // S = Q K^T and dP = dO V^T of this warpgroup's li-th key tile
  auto stage_k = [&](int li) {
    return s_ring + (wg * kStages + li % kStages) * 2 * P::kTile;
  };
  if (n_mine > 0) {
    mbar_wait(bar_q, 0);
    issue_s_dp<D, kBlockN>(s_acc, dp_acc, s_q, stage_k(0), s_do,
                           stage_k(0) + P::kTile, P::kBox, P::kBox,
                           bar_full + 8 * wg * kStages, 0);
  }
  for (int li = 0; li < n_mine; ++li) {
    const uint32_t s_k = stage_k(li);
    const int kb = (wg + P::kConsumers * li) * kBlockN;
    wgmma_wait<1>();  // S, and the previous tile's dQ product
    fence_operands(s_acc);
    fence_operands(dq_acc);
    fence_frag<kBlockN>(dh);
    fence_frag<kBlockN>(dl);
    // the previous tile's stage is free: its tile li - 1 + kStages
    if (loader && li > 0 && li - 1 + kStages < n_mine)
      load_kv<D>(&map_k, &map_v, s_ring, bar_full, wg, li - 1 + kStages, h,
                 b);
    if (kb + kBlockN > kv_len ||
        (p.causal && kb + kBlockN - 1 > p.q_start + q0))
      apply_mask<kBlockN>(s_acc, kv_len, p.causal, p.q_start, p.mask_raw,
                          row0, kb, col0, false);

    // P = 2^(S c - lse2), then dS = P (dP - delta), per row
#pragma unroll
    for (int e = 0; e < kS; ++e)
      s_acc[e] = ex2(fmaf(s_acc[e], p.scale_log2, -lse2[(e / 2) % 2]));
    wgmma_wait<0>();
    fence_operands(dp_acc);

    // dQ += dS K one k-step (16 keys) at a time, each step's products
    // starting while the next step's dS is formed, then the next tile's S
    // and dP behind them
#pragma unroll
    for (int t = 0; t < kBlockN / 16; ++t) {
#pragma unroll
      for (int e = 8 * t; e < 8 * t + 8; ++e)
        dp_acc[e] = s_acc[e] * (dp_acc[e] - delta[(e / 2) % 2]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(dp_acc[8 * t + 2 * r], dp_acc[8 * t + 2 * r + 1], dh[t][r],
                   dl[t][r]);
      fence_operands(dq_acc);
      wgmma_fence();
      mma_split_step<D>(dq_acc, dh[t], dl[t], s_k, P::kBox, t);
      wgmma_commit();
    }
    if (li + 1 < n_mine) {
      const int nx = li + 1;
      issue_s_dp<D, kBlockN>(
          s_acc, dp_acc, s_q, stage_k(nx), s_do, stage_k(nx) + P::kTile,
          P::kBox, P::kBox, bar_full + 8 * (wg * kStages + nx % kStages),
          (nx / kStages) & 1);
    }
  }
  wgmma_wait<0>();
  fence_operands(dq_acc);
  fence_frag<kBlockN>(dh);
  fence_frag<kBlockN>(dl);

  // dQ = the warpgroups' sums added in order (0 + 1) + 2, through the
  // rings' memory once all are done with it
  float* swap = reinterpret_cast<float*>(gen + S::kDQRing);
  const int t = threadIdx.x % 128;
  bar_sync(kBarAll, P::kThreads);
  if (wg > 0) to_swap<kO>(dq_acc, swap + (wg - 1) * kO * 128, t);
  bar_sync(kBarAll, P::kThreads);
  if (wg == 0) {
#pragma unroll
    for (int w = 1; w < P::kConsumers; ++w)
      add_swap<kO>(dq_acc, swap + (w - 1) * kO * 128, t);
    store_rows<D>(dq_acc, p.sm_scale, p.dq + b * p.dq_sb + h * p.dq_sh,
                  p.dq_st, row0, col0, p.Tq);
  }
}

// ---- 3. dK and dV -----------------------------------------------------------

// Warpgroup w's tile li of a dK/dV block: query tile first + w +
// kConsumers li with its lse2 and delta into its ring's stage li % kStages.
template <int D>
__device__ __forceinline__ void load_qdo(const CUtensorMap* map_q,
                                         const CUtensorMap* map_do,
                                         const Params& p, uint32_t s_ring,
                                         uint32_t s_stats, uint32_t bar_full,
                                         int wg, int li, int first, int bh,
                                         int h, int b) {
  using P = Plan<D>;
  constexpr int BQ = P::kBlockQ;
  const int st = wg * kStages + li % kStages;
  const uint32_t full = bar_full + 8 * st;
  const uint32_t s_q = s_ring + st * 2 * P::kTileQ;
  const uint32_t s_st = s_stats + st * 2 * BQ * 4;
  const int qb = (first + wg + P::kConsumers * li) * BQ;
  mbar_arrive_expect_tx(full, 2 * P::kTileQ + 2 * BQ * 4);
  for (int x = 0; x < P::kBoxes; ++x) {
    tma_load_4d(s_q + x * P::kBoxQ, map_q, full, x * P::kBoxD, h, qb, b);
    tma_load_4d(s_q + P::kTileQ + x * P::kBoxQ, map_do, full, x * P::kBoxD, h,
                qb, b);
  }
  const long long at = (long long)bh * p.Tq_pad + qb;
  bulk_load(s_st, p.lse2 + at, BQ * 4, full);
  bulk_load(s_st + BQ * 4, p.delta + at, BQ * 4, full);
}

// dK and dV of the 64 keys kblk of b*h blockIdx.x.
template <int D>
__device__ __forceinline__ void dkdv_block(const CUtensorMap& map_q,
                                           const CUtensorMap& map_k,
                                           const CUtensorMap& map_v,
                                           const CUtensorMap& map_do,
                                           const Params& p, int kblk) {
  using P = Plan<D>;
  using S = Smem<D>;
  constexpr int BQ = P::kBlockQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gen = smem_raw + (base - smem_u32(smem_raw));  // generic view
  const uint32_t s_k = base;
  const uint32_t s_v = base + P::kTile;
  const uint32_t s_ring = base + S::kKVRing;  // [w][s]: Q tile, dO tile
  const uint32_t s_stats = base + S::kKVStats;  // [w][s]: lse2, delta
  const float* stats = reinterpret_cast<const float*>(gen + S::kKVStats);
  const uint32_t bar_full = base + S::kKVBars;
  const uint32_t bar_kv = bar_full + 8 * S::kStageBars;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = kblk * kBlockN;
  const int kv_len = kv_len_of(p, b);
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
  init_barriers(bar_full, S::kStageBars, bar_kv);
  if (loader) {
    if (wg == 0 && n_it > 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * P::kTile);
      for (int x = 0; x < P::kBoxes; ++x) {
        tma_load_4d(s_k + x * P::kBox, &map_k, bar_kv, x * P::kBoxD, h, k0, b);
        tma_load_4d(s_v + x * P::kBox, &map_v, bar_kv, x * P::kBoxD, h, k0, b);
      }
    }
    for (int li = 0; li < min(kStages, n_mine); ++li)
      load_qdo<D>(&map_q, &map_do, p, s_ring, s_stats, bar_full, wg, li, first,
                  bh, h, b);
  }

  // This thread holds keys row0 and row0 + 8 of the tile (accumulator rows)
  // in every warpgroup.
  const int row0 = k0 + 16 * wl + lane / 4;
  const int col0 = 2 * (lane % 4);
  constexpr int kS = BQ / 2;  // S^T / dP^T accumulators per thread
  constexpr int kO = D / 2;   // dK / dV accumulators per thread
  float dv_acc[kO], dk_acc[kO], s_acc[kS], dp_acc[kS];
  // the A fragments of P^T, then of dS^T (hi and lo parts), a k-step each
  uint32_t fh[BQ / 16][4] = {}, fl[BQ / 16][4] = {};
#pragma unroll
  for (int e = 0; e < kO; ++e) dv_acc[e] = dk_acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kS; ++e) s_acc[e] = dp_acc[e] = 0.f;

  // S^T = K Q^T and dP^T = V dO^T of this warpgroup's li-th query tile
  auto stage_q = [&](int li) {
    return s_ring + (wg * kStages + li % kStages) * 2 * P::kTileQ;
  };
  if (n_mine > 0) {
    mbar_wait(bar_kv, 0);
    issue_s_dp<D, BQ>(s_acc, dp_acc, s_k, stage_q(0), s_v,
                      stage_q(0) + P::kTileQ, P::kBox, P::kBoxQ,
                      bar_full + 8 * wg * kStages, 0);
  }
  for (int li = 0; li < n_mine; ++li) {
    const int st = wg * kStages + li % kStages;
    const int qb = (first + wg + P::kConsumers * li) * BQ;
    const uint32_t s_q = stage_q(li);
    const uint32_t s_do = s_q + P::kTileQ;
    const float* lse2 = stats + st * 2 * BQ;
    const float* delta = lse2 + BQ;
    wgmma_wait<1>();  // S^T, and the previous tile's dV and dK products
    fence_operands(s_acc);
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    fence_frag<BQ>(fh);
    fence_frag<BQ>(fl);
    // the previous tile's stage is free: its tile li - 1 + kStages
    if (loader && li > 0 && li - 1 + kStages < n_mine)
      load_qdo<D>(&map_q, &map_do, p, s_ring, s_stats, bar_full, wg,
                  li - 1 + kStages, first, bh, h, b);
    if (k0 + kBlockN > kv_len ||
        (p.causal && k0 + kBlockN - 1 > qb + p.q_start))
      apply_mask<BQ>(s_acc, kv_len, p.causal, p.q_start, p.mask_raw, row0,
                     qb, col0, true);

    // P^T = 2^(S^T c - lse2) per query column, and dV += P^T dO, one
    // k-step (16 query columns) at a time: each step's products start
    // while the next step's P^T is formed
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) {
#pragma unroll
      for (int e = 8 * t; e < 8 * t + 8; ++e) {
        const int col = 8 * (e / 4) + col0 + (e % 2);
        s_acc[e] = ex2(fmaf(s_acc[e], p.scale_log2, -lse2[col]));
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(s_acc[8 * t + 2 * r], s_acc[8 * t + 2 * r + 1], fh[t][r],
                   fl[t][r]);
      fence_operands(dv_acc);
      wgmma_fence();
      mma_split_step<D>(dv_acc, fh[t], fl[t], s_do, P::kBoxQ, t);
      wgmma_commit();
    }
    wgmma_wait<BQ / 16>();  // dP^T (dV's steps may still run)
    fence_operands(dp_acc);

    // dS^T = P^T (dP^T - delta) and dK += dS^T Q, a k-step at a time, each
    // step's fragments taking P^T's once dV's step t is done with them,
    // then the next tile's S^T and dP^T
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) {
      wgmma_wait<BQ / 16 - 1>();  // dV's step t
      fence_frag_step(fh[t]);
      fence_frag_step(fl[t]);
      fence_operands(dp_acc);
#pragma unroll
      for (int e = 8 * t; e < 8 * t + 8; ++e) {
        const int col = 8 * (e / 4) + col0 + (e % 2);
        dp_acc[e] = s_acc[e] * (dp_acc[e] - delta[col]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(dp_acc[8 * t + 2 * r], dp_acc[8 * t + 2 * r + 1], fh[t][r],
                   fl[t][r]);
      fence_operands(dk_acc);
      wgmma_fence();
      mma_split_step<D>(dk_acc, fh[t], fl[t], s_q, P::kBoxQ, t);
      wgmma_commit();
    }
    if (li + 1 < n_mine) {
      const int nx = li + 1;
      issue_s_dp<D, BQ>(
          s_acc, dp_acc, s_k, stage_q(nx), s_v, stage_q(nx) + P::kTileQ,
          P::kBox, P::kBoxQ, bar_full + 8 * (wg * kStages + nx % kStages),
          (nx / kStages) & 1);
    }
  }
  wgmma_wait<0>();
  fence_operands(dv_acc);
  fence_operands(dk_acc);
  fence_frag<BQ>(fh);
  fence_frag<BQ>(fl);

  // warpgroup 0 stores dK and warpgroup 1 dV, each the warpgroups' parts
  // added in order (0 + 1) + 2 (warpgroup 1 adds 0's part to its own: IEEE
  // addition commutes), through the rings' memory once all are done with
  // it: slot w - 1 holds warpgroup w's dK part, and the slots after them
  // the dV parts of warpgroups 0, 2, ... in that order
  const int t = threadIdx.x % 128;
  float* swap = reinterpret_cast<float*>(gen + S::kKVRing);
  float* dv_slot = swap + (P::kConsumers - 1) * kO * 128;
  auto dv_part = [&](int w) {
    return dv_slot + (w == 0 ? 0 : w - 1) * kO * 128;
  };
  bar_sync(kBarAll, P::kThreads);
  if (wg > 0) to_swap<kO>(dk_acc, swap + (wg - 1) * kO * 128, t);
  if (wg != 1) to_swap<kO>(dv_acc, dv_part(wg), t);
  bar_sync(kBarAll, P::kThreads);
  if (wg == 0) {
#pragma unroll
    for (int w = 1; w < P::kConsumers; ++w)
      add_swap<kO>(dk_acc, swap + (w - 1) * kO * 128, t);
    store_rows<D>(dk_acc, p.sm_scale, p.dk + b * p.dk_sb + h * p.dk_sh,
                  p.dk_st, row0, col0, p.Tk);
  } else if (wg == 1) {
#pragma unroll
    for (int w = 0; w < P::kConsumers; ++w)
      if (w != 1) add_swap<kO>(dv_acc, dv_part(w), t);
    store_rows<D>(dv_acc, 1.f, p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_st,
                  row0, col0, p.Tk);
  }
}

// ---- 4. the dQ and dK/dV blocks in one launch -------------------------------

// blockIdx.z 0 holds the dK/dV blocks, which go out first, and 1 the dQ
// blocks; blockIdx.y is the block of its kind, heaviest first under the
// causal mask (the dK/dV blocks of the first keys, the dQ blocks of the
// last queries); past its kind's count none.
template <int D>
__global__ void __launch_bounds__(Plan<D>::kThreads, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_q_tile,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do,
                 const __grid_constant__ CUtensorMap map_do_tile,
                 const Params p) {
  const int y = blockIdx.y;
  if (blockIdx.z == 0) {
    if (y < (p.Tk + kBlockN - 1) / kBlockN)
      dkdv_block<D>(map_q_tile, map_k, map_v, map_do_tile, p, y);
  } else {
    const int n = p.Tq_pad / kBlockM;
    if (y < n)
      dq_block<D>(map_q, map_k, map_v, map_do, p, p.causal ? n - 1 - y : y);
  }
}

// ---- host -------------------------------------------------------------------

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
  const void *q, *k, *v, *o, *dout, *lse;
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
  auto delta = flash_bwd_delta_kernel<D>;
  auto grads = flash_bwd_kernel<D>;
  static bool smem_set = false;
  const int smem = S::kDQ > S::kKV ? S::kDQ : S::kKV;
  cudaError_t err = allow_smem(grads, smem, smem_set);
  if (err != cudaSuccess) return err;

  Params p;
  p.o = static_cast<const __nv_bfloat16*>(t.o);
  p.dout = static_cast<const __nv_bfloat16*>(t.dout);
  p.lse = static_cast<const float*>(t.lse);
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

  // b*h in x, the block in y: blocks go out in order of y
  const int nq = p.Tq_pad / kBlockM;
  const int nk = (Tk + kBlockN - 1) / kBlockN;
  delta<<<dim3(B * H, p.Tq_pad / (128 / (D / 8))), 128, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grads<<<dim3(B * H, nq > nk ? nq : nk, 2), P::kThreads, smem, stream>>>(
      map_q, map_q_tile, map_k, map_v, map_do, map_do_tile, p);
  return cudaGetLastError();
}

}  // namespace

// Floats of workspace the backward needs: lse2 and delta, each
// [B*H, Tq rounded up to 64].
extern "C" long long flash_attn_bwd_wgmma_workspace(int B, int H, int Tq,
                                                    int Tk, int D) {
  (void)Tk;
  (void)D;
  return 2LL * B * H * ((Tq + kRowPad - 1) / kRowPad * kRowPad);
}

// Strides are in elements, for the b, t and h dims of each [B, T, H, D]
// bfloat16 tensor (the D stride must be 1; q, k, v and dO strides and base
// addresses multiples of 16 bytes, as TMA reads them; o is read with plain
// loads, dq, dk and dv written with them). lse: the forward's float32
// [B, H, Tq], contiguous. kv_lens: int32 [B] on the device, or null for
// "all Tk keys valid". workspace: float32, at least
// flash_attn_bwd_wgmma_workspace(B, H, Tq, Tk, D) of them, 16-byte
// aligned.
// Returns 0 when both kernels were launched, a cudaError_t value if a
// launch failed, -1 if the TMA unit refused a tensor's layout, -2 if
// libcuda has no cuTensorMapEncodeTiled.
extern "C" int flash_attn_bwd_wgmma(
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
      (Tk + kBlockN - 1) / kBlockN > 65535 ||
      (Tq + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  const Tensors t{q, k, v, o, dout, lse, dq, dk, dv,
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
