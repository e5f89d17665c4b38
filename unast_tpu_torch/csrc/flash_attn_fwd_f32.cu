// Flash-attention forward in float32 on Hopper's tensor cores (sm_90a):
// split-TF32 warpgroup MMA ("3xTF32") fed by TMA, after a pre-pass that
// splits K and V. Plain C entry points `flash_attn_fwd_f32` and
// `flash_attn_fwd_f32_workspace`, loaded with ctypes.
//
// Replaces the Pallas TPU kernel unast_tpu/ops/attention.py::_flash_fwd
// (body _attn_kernel, driven through _kernel_with_prefetch) for float32
// inputs; bfloat16 inputs go to flash_attn_fwd_wgmma.cu. Computes
//   o = softmax(q k^T / sqrt(D) + mask) v
// over q [B, Tq, H, D], k and v [B, Tk, H, D] and writes o [B, Tq, H, D].
// Key j of batch row b is kept when j < kv_lens[b] and, if causal, when
// j <= i + q_start (query i; q_start is the keys' position of query 0, a
// sequence-parallel rank's first frame, else 0). Masked scores are -1e9 (set on the unscaled product
// as -1e9 * sqrt(D)). The softmax state (m, l) and the accumulator are
// float32; o = acc / max(l, 1e-30), and lse = m / sqrt(D) + ln(l), the
// natural-log logsumexp of the row's scaled scores (float32 [B, H, Tq]).
//
// Precision. One TF32 product keeps 10 mantissa bits, too few for the
// float32 tolerance of 2e-5. Each operand is split, x = hi + lo with
// hi = tf32(x) and lo = tf32(x - hi) (round to nearest), and each product
// is formed as lo*hi + hi*lo + hi*hi: three TF32 wgmma into one float32
// accumulator, the small terms first. The dropped lo*lo is below 2^-22 of
// the product, so about 21 bits survive. Both S = Q K^T and O += P V are
// formed so; P is split in registers after the softmax.
//
// What bounds it on an H100 SXM: at B8 H4 T815 D64 with kv_lens from 815
// down to 272 the work is 3.6 GFLOP, three TF32 products of it 10.9 GFLOP,
// 22 us at the 495 TFLOP/s TF32 tensor-core peak (54 us for 3.6 GFLOP on
// the CUDA cores' 67 TFLOP/s), against 22 MB of q, the kept k/v rows and
// o, 6.6 us at 3.35 TB/s: bound by operations. Design:
//   - TF32 wgmma takes its shared-memory operands only K-major (there is
//     no transpose for 32-bit types). Q and K are (D contiguous); V, the B
//     operand of P V, is not. A pre-pass kernel (tf32_split_kernel) reads
//     k and v through the caller's strides and writes their hi and lo
//     parts into a workspace the wrapper allocates: k as [2][B*H][Tk][D],
//     v transposed as [2][B*H][D][Tk8] (keys contiguous; Tk8 = Tk rounded
//     up to 8). It writes only the keys the main kernel reads (kv_len
//     rounded up to 64), those past kv_len as zeros;
//   - inside each group of 8 keys the transposed v holds the keys in the
//     order [0, 2, 4, 6, 1, 3, 5, 7]. The S accumulator gives a thread
//     keys 2t and 2t + 1 of each group of 8, where the TF32 A fragment
//     wants keys t and t + 4; in that order they are the same, so P goes
//     from the accumulator to the A fragment without a shuffle. P V sums
//     over keys, so the order is exact as long as P and V agree on it;
//   - one block per (128 query rows, b*h) at D <= 64 (two consumer
//     warpgroups of 64 rows and one producer warp, 288 threads), 64 rows
//     at D 128; each consumer warpgroup loads its own Q rows with plain
//     loads (any strides), splits them and writes hi and lo into shared
//     memory in the TMA swizzle, then fences them for the async proxy;
//   - the producer's lane 0 loads K and V tiles (hi and lo) of the
//     workspace with TMA into a two-stage ring of "full"/"empty"
//     mbarriers, as in the bf16 kernel. Tiles are 64 keys (32 at D 128);
//   - S = Q K^T: 3 * D/8 wgmma m64nNk8 (N = the tile's keys), both from
//     shared memory; the mask on edge tiles, the online softmax on the
//     unscaled scores with the scale folded into one FFMA and one ex2 per
//     score, and the key loop stopped at the last visible key, as in the
//     bf16 kernel;
//   - O += P V: 3 * N/8 wgmma m64nDk8 (two of n64 at D 128) with P from
//     registers and V^T from shared memory;
//   - swizzle follows the float32 row width: 64 B for D 16, 128 B above
//     (D 64 and 128 as two and four 32-column boxes); a k-step of 8 moves
//     32 bytes inside a swizzled row.
//
// Precondition: every kv_len >= 1 (both Synthesizer paths guarantee it).
// A row with no visible key gets zeros; that is not a contract.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kStages = 2;        // depth of the K/V ring
constexpr int kKeyAlign = 64;     // the pre-pass writes keys up to kv_len
                                  // rounded up to this (a multiple of every
                                  // tile's keys)
constexpr int kPrepRows = 32;     // keys per pre-pass block
constexpr int kPrepThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskValue = -1e9f;

// Return codes besides cudaError_t values.
constexpr int kErrTensorMap = -1;    // a layout the TMA unit does not take
constexpr int kErrNoEncoder = -2;    // cuTensorMapEncodeTiled not found

// Pre-pass: blockIdx.z 0 splits 32 keys of k, 1 splits 32 key positions of
// v and writes them transposed (through a shared tile, so that both the
// reads and the writes are coalesced). Element n of a thread is
// threadIdx.x + 256 n of the block's 32 x D, and all of a thread's loads
// are issued before its first store.
template <int D>
__global__ void __launch_bounds__(kPrepThreads)
tf32_split_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ ws, const int32_t* __restrict__ kv_lens,
                  int H, int Tk, Strides ks, Strides vs) {
  constexpr int kPer = kPrepRows * D / kPrepThreads;
  __shared__ float tile[kPrepRows][D + 1];
  float x[kPer];
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int r0 = blockIdx.x * kPrepRows;
  const int tk8 = round_up(Tk, 8);
  int kv_len = Tk;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[b], 0), Tk);
  const int end = round_up(kv_len, kKeyAlign);
  const long long k_part = (long long)gridDim.y * Tk * D;

  if (blockIdx.z == 0) {
    const int rows = min(end, Tk);
    if (r0 >= rows) return;
    const float* src = k + b * ks.b + h * ks.h;
    float* dst = ws + (long long)bh * Tk * D;
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int i = threadIdx.x + kPrepThreads * n;
      const int r = r0 + i / D;
      x[n] = r < kv_len ? src[r * ks.t + i % D] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int i = threadIdx.x + kPrepThreads * n;
      const long long at = (long long)(r0 + i / D) * D + i % D;
      if (r0 + i / D >= rows) break;
      float hi, lo;
      split_tf32(x[n], hi, lo);
      dst[at] = hi;
      dst[k_part + at] = lo;
    }
    return;
  }

  const int rows = min(end, tk8);
  if (r0 >= rows) return;
  const float* src = v + b * vs.b + h * vs.h;
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int i = threadIdx.x + kPrepThreads * n;
    const int r = r0 + i / D;
    x[n] = r < kv_len ? src[r * vs.t + i % D] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int i = threadIdx.x + kPrepThreads * n;
    tile[i / D][i % D] = x[n];
  }
  __syncthreads();
  const long long vt_part = (long long)gridDim.y * D * tk8;
  float* dst = ws + 2 * k_part + (long long)bh * D * tk8 + r0;
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int i = threadIdx.x + kPrepThreads * n;
    const int d = i / kPrepRows;
    const int pos = i % kPrepRows;
    if (r0 + pos >= rows) continue;
    float hi, lo;
    split_tf32(tile[(pos & ~7) + key_at(pos & 7)][d], hi, lo);
    dst[(long long)d * tk8 + pos] = hi;
    dst[vt_part + (long long)d * tk8 + pos] = lo;
  }
}

// Block shape and shared-memory plan for head dim D (byte offsets from a
// 1024-aligned base): Q hi and Q lo, then per stage K hi, K lo, V^T hi and
// V^T lo, then the barriers. A Q or K part is kBoxes boxes of rows x kBoxD
// columns in the swizzle of kRowBytes-byte rows; a V^T part is one box of
// D rows x 32 keys (128 bytes) per 32 keys of the tile. At D <= 64 two
// consumer warpgroups (128 query rows) and 64-key tiles, the fastest of
// the shapes measured (PERF.md); D 128 takes one and 32, all that fits.
template <int D>
struct Plan {
  static constexpr int kWarpgroups = D == 128 ? 1 : 2;
  static constexpr int kBlockM = 64 * kWarpgroups;      // query rows
  static constexpr int kBlockN = D == 128 ? 32 : 64;    // keys per tile
  // the pre-pass writes whole tiles, and a V^T tile is whole 32-key boxes
  static_assert(kKeyAlign % kBlockN == 0 && kBlockN % 32 == 0, "tile keys");
  static constexpr int kThreads = (4 * kWarpgroups + 1) * 32;
  static constexpr int kBoxD = D < 32 ? D : 32;
  static constexpr int kBoxes = D / kBoxD;
  static constexpr int kRowBytes = kBoxD * 4;
  static constexpr uint32_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kQBox = kBlockM * kRowBytes;
  static constexpr int kQPart = kBoxes * kQBox;
  static constexpr int kKBox = kBlockN * kRowBytes;
  static constexpr int kKPart = kBoxes * kKBox;
  static constexpr int kVtBox = D * 128;
  static constexpr int kVtPart = kBlockN / 32 * kVtBox;
  static constexpr int kStageBytes = 2 * kKPart + 2 * kVtPart;
  static constexpr int kBarriers = 2 * kQPart + kStages * kStageBytes;
  static constexpr int kSmem = kBarriers + 8 * 2 * kStages + 1024;
  // two blocks an SM where two fit in its 228 KB (1 KB of it reserved
  // per block)
  static constexpr int kMinBlocks = 2 * (kSmem + 1024) <= 228 * 1024 ? 2 : 1;
  static constexpr int kNV = D < 64 ? D : 64;  // columns of one P V wgmma
};

struct Params {
  const float* q;
  float* o;
  float* lse;  // [B*H, Tq] natural-log logsumexp of the scaled scores
  const int32_t* kv_lens;
  long long q_sb, q_st, q_sh;  // element strides of q's b, t, h dims
  long long o_sb, o_st, o_sh;
  int H, Tq, Tk, causal;
  int q_start;       // keys' position of query 0 (causal mask)
  float scale_log2;  // log2(e) / sqrt(D)
  float mask_raw;    // -1e9 * sqrt(D): a masked score before the scale
};

template <int D>
__global__ void __launch_bounds__(Plan<D>::kThreads, Plan<D>::kMinBlocks)
flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_vt,
                        const Params p) {
  using P = Plan<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t s_q = base;  // Q hi; Q lo at + kQPart
  const uint32_t s_kv = base + 2 * P::kQPart;
  const uint32_t bar_full = base + P::kBarriers;  // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * P::kBlockM;
  int kv_len = p.Tk;
  if (p.kv_lens != nullptr) kv_len = min(max(p.kv_lens[b], 0), p.Tk);
  int n_keys = kv_len;
  if (p.causal) n_keys = min(n_keys, p.q_start + min(p.Tq, q0 + P::kBlockM));
  const int n_tiles = (n_keys + P::kBlockN - 1) / P::kBlockN;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * P::kWarpgroups);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * P::kWarpgroups) {
    // Producer: lane 0 keeps the ring full.
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        // the stage's previous tile (i - kStages) must have been released
        if (i >= kStages) mbar_wait(bar_empty + 8 * s, (i / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t s_k = s_kv + s * P::kStageBytes;
        const uint32_t s_vt = s_k + 2 * P::kKPart;
        mbar_arrive_expect_tx(full, P::kStageBytes);
        for (int part = 0; part < 2; ++part) {
          for (int x = 0; x < P::kBoxes; ++x)
            tma_load_4d(s_k + part * P::kKPart + x * P::kKBox, &map_k, full,
                        x * P::kBoxD, i * P::kBlockN, blockIdx.y, part);
          for (int y = 0; y < P::kBlockN / 32; ++y)
            tma_load_4d(s_vt + part * P::kVtPart + y * P::kVtBox, &map_vt,
                        full, i * P::kBlockN + 32 * y, 0, blockIdx.y, part);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63. It splits
  // its Q rows into shared memory first (rows past Tq as zeros): all of a
  // thread's loads are issued before the first store, so their latencies
  // overlap.
  const int wg = warp / 4;
  {
    constexpr int kLoads = 64 * D / 128;
    const float* q = p.q + b * p.q_sb + h * p.q_sh;
    float x[kLoads];
#pragma unroll
    for (int n = 0; n < kLoads; ++n) {
      const int i = threadIdx.x % 128 + 128 * n;
      const int row = q0 + 64 * wg + i / D;
      x[n] = row < p.Tq ? __ldg(q + row * p.q_st + i % D) : 0.f;
    }
#pragma unroll
    for (int n = 0; n < kLoads; ++n) {
      const int i = threadIdx.x % 128 + 128 * n;
      const int r = 64 * wg + i / D;
      const int c = i % D;
      float hi, lo;
      split_tf32(x[n], hi, lo);
      const uint32_t off = c / P::kBoxD * P::kQBox +
                           swizzled<P::kRowBytes>(r, c % P::kBoxD * 4);
      *reinterpret_cast<float*>(smem + off) = hi;
      *reinterpret_cast<float*>(smem + P::kQPart + off) = lo;
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);
  }

  // This thread holds rows row0 and row0 + 8 (accumulator layout in
  // sm90.cuh).
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  constexpr int kS = P::kBlockN / 2;   // score accumulators per thread
  constexpr int kO = D / 2;            // output accumulators per thread
  constexpr int kSteps = P::kBoxD / 8; // k-steps inside one box
  float o_acc[kO];
  float s_acc[kS];  // each tile overwrites it (scale_d 0 on the first step)
#pragma unroll
  for (int e = 0; e < kO; ++e) o_acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kS; ++e) s_acc[e] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};  // this thread's part of the row sums
  const uint32_t s_q_wg = s_q + 64 * wg * P::kRowBytes;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t s_k = s_kv + s * P::kStageBytes;
    const uint32_t s_vt = s_k + 2 * P::kKPart;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);

    // S = Q K^T over D in k-steps of 8: Q_lo K_hi, Q_hi K_lo, Q_hi K_hi.
    fence_operands(s_acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const uint32_t qa = s_q_wg + (t == 0 ? P::kQPart : 0);
      const uint32_t kb = s_k + (t == 1 ? P::kKPart : 0);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int x = kk / kSteps;
        const int w = kk % kSteps;
        const uint64_t da = make_desc(qa + x * P::kQBox + 32 * w, 16,
                                      8 * P::kRowBytes, P::kLayout);
        const uint64_t db = make_desc(kb + x * P::kKBox + 32 * w, 16,
                                      8 * P::kRowBytes, P::kLayout);
        WgmmaTf32SS<P::kBlockN>::run(s_acc, da, db, t > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s_acc);

    // Mask only where the tile needs it.
    const int k0 = i * P::kBlockN;
    if (k0 + P::kBlockN > kv_len ||
        (p.causal && k0 + P::kBlockN - 1 > p.q_start + q0 + 64 * wg)) {
#pragma unroll
      for (int e = 0; e < kS; ++e) {
        const int col = k0 + 8 * (e / 4) + col0 + (e % 2);
        const int row = row0 + 8 * ((e / 2) % 2);
        const bool keep =
            col < kv_len && (!p.causal || col <= row + p.q_start);
        s_acc[e] = keep ? s_acc[e] : p.mask_raw;
      }
    }

    // Online softmax over the two rows (a row spans the 4 lanes l/4), on
    // unscaled scores: the scale c > 0 does not move the max.
    float m_new[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int e = 0; e < kS; ++e)
      m_new[(e / 2) % 2] = fmaxf(m_new[(e / 2) % 2], s_acc[e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      alpha[r] = ex2((m_row[r] - m_new[r]) * p.scale_log2);  // 0 at first
      m_row[r] = m_new[r];
      l_row[r] *= alpha[r];
      m_new[r] *= p.scale_log2;
    }
#pragma unroll
    for (int e = 0; e < kS; ++e) {
      const float pe = ex2(fmaf(s_acc[e], p.scale_log2, -m_new[(e / 2) % 2]));
      l_row[(e / 2) % 2] += pe;
      s_acc[e] = pe;
    }
#pragma unroll
    for (int e = 0; e < kO; ++e) o_acc[e] *= alpha[(e / 2) % 2];

    // P as TF32 A fragments, hi and lo: k-step j is the accumulator's
    // column block j, keys 8j + [0, 2, 4, 6, 1, 3, 5, 7] in the fragment's
    // order (a0 = row g key 2t, a1 = row g + 8 key 2t, a2 and a3 key
    // 2t + 1), which is V^T's order in shared memory.
    uint32_t ph[P::kBlockN / 8][4], pl[P::kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < P::kBlockN / 8; ++j) {
      const int src[4] = {4 * j, 4 * j + 2, 4 * j + 1, 4 * j + 3};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float hi, lo;
        split_tf32(s_acc[src[e]], hi, lo);
        ph[j][e] = __float_as_uint(hi);
        pl[j][e] = __float_as_uint(lo);
      }
    }
    // The scores are dead until the next tile's product overwrites them;
    // zeros let their registers go free meanwhile.
#pragma unroll
    for (int e = 0; e < kS; ++e) s_acc[e] = 0.f;

    // O += P V: p_lo V_hi, p_hi V_lo, p_hi V_hi. V^T is K-major (keys
    // contiguous, D rows of 128 bytes per 32 keys); a k-step moves 32 bytes
    // along a row, and the D columns go as D / kNV products of kNV rows.
    fence_operands(o_acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 3; ++t) {
#pragma unroll
      for (int j = 0; j < P::kBlockN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < D / P::kNV; ++c) {
          const uint64_t dv = make_desc(
              s_vt + (t == 1 ? P::kVtPart : 0) + j / 4 * P::kVtBox +
                  c * P::kNV * 128 + 32 * (j % 4),
              16, 8 * 128, 1);
          WgmmaTf32RS<P::kNV>::run(
              *reinterpret_cast<float(*)[P::kNV / 2]>(o_acc + c * P::kNV / 2),
              t == 0 ? pl[j] : ph[j], dv, 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(o_acc);

    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  // o = acc / max(l, 1e-30) and lse = (m c + log2(l)) ln(2), rows past Tq
  // not stored.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = row0 + 8 * r;
    if (row < p.Tq) {
      if (lane % 4 == 0)
        p.lse[(long long)blockIdx.y * p.Tq + row] =
            fmaf(m_row[r], p.scale_log2, log2f(l)) * kLn2;
      float* o_row = p.o + b * p.o_sb + row * p.o_st + h * p.o_sh + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(o_row + 8 * j) = make_float2(
            o_acc[4 * j + 2 * r] * inv, o_acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// Floats of the workspace: k's and v's hi and lo parts.
long long workspace_floats(int B, int H, int Tk, int D) {
  return 2LL * B * H * D * ((long long)Tk + round_up(Tk, 8));
}

// A tensor map over a float32 workspace array [2][B*H][rows][cols]; a box
// is box_cols x box_rows of one (part, b*h).
bool make_map(EncodeTiled encode, CUtensorMap* map, float* ptr, int BH,
              int rows, int cols, int box_cols, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)BH, 2};
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

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, const int32_t* kv_lens, float* ws, int B, int H,
           int Tq, int Tk,
           Strides qs, Strides ks, Strides vs, Strides os, int causal,
           int q_start, float sm_scale, cudaStream_t stream) {
  using P = Plan<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const int BH = B * H;
  const int tk8 = round_up(Tk, 8);
  CUtensorMap map_k, map_vt;
  if (!make_map(encode, &map_k, ws, BH, Tk, D, P::kBoxD, P::kBlockN) ||
      !make_map(encode, &map_vt, ws + 2LL * BH * Tk * D, BH, D, tk8, 32, D))
    return kErrTensorMap;
  auto kernel = flash_fwd_tf32x3_kernel<D>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 prep_grid((tk8 + kPrepRows - 1) / kPrepRows, BH, 2);
  tf32_split_kernel<D><<<prep_grid, kPrepThreads, 0, stream>>>(
      k, v, ws, kv_lens, H, Tk, ks, vs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Params p;
  p.q = q;
  p.o = o;
  p.lse = lse;
  p.kv_lens = kv_lens;
  p.q_sb = qs.b;
  p.q_st = qs.t;
  p.q_sh = qs.h;
  p.o_sb = os.b;
  p.o_st = os.t;
  p.o_sh = os.h;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.causal = causal;
  p.q_start = q_start;
  p.scale_log2 = sm_scale * kLog2e;
  p.mask_raw = kMaskValue / sm_scale;
  dim3 grid((Tq + P::kBlockM - 1) / P::kBlockM, BH);
  kernel<<<grid, P::kThreads, P::kSmem, stream>>>(map_k, map_vt, p);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch that flash_attn_fwd_f32 needs for these sizes.
extern "C" long long flash_attn_fwd_f32_workspace(int B, int H, int Tk,
                                                  int D) {
  return workspace_floats(B, H, Tk, D);
}

// Strides are in elements, for the b, t and h dims of each [B, T, H, D]
// float32 tensor (the D stride must be 1; o's base 8-byte aligned). lse:
// float32 [B, H, Tq], contiguous. kv_lens: int32 [B] on the device, or
// null for "all Tk keys valid". workspace:
// flash_attn_fwd_f32_workspace(B, H, Tk, D) floats on the device, 16-byte
// aligned; the call launches the pre-pass and the kernel on `stream`, in
// that order. Returns 0 when launched, a cudaError_t value
// if a launch failed, -1 if the TMA unit refused the workspace's layout,
// -2 if libcuda has no cuTensorMapEncodeTiled.
extern "C" int flash_attn_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* kv_lens,
    int B, int H, int Tq, int Tk, int D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, int causal, int q_start, float sm_scale,
    void* stream, void* workspace) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_st, o_sh};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  const int32_t* lens = static_cast<const int32_t*>(kv_lens);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(qf, kf, vf, of, lf, lens, ws, B, H, Tq, Tk, qs, ks,
                        vs, os, causal, q_start, sm_scale, s);
    case 32:
      return launch<32>(qf, kf, vf, of, lf, lens, ws, B, H, Tq, Tk, qs, ks,
                        vs, os, causal, q_start, sm_scale, s);
    case 64:
      return launch<64>(qf, kf, vf, of, lf, lens, ws, B, H, Tq, Tk, qs, ks,
                        vs, os, causal, q_start, sm_scale, s);
    case 128:
      return launch<128>(qf, kf, vf, of, lf, lens, ws, B, H, Tq, Tk, qs, ks,
                         vs, os, causal, q_start, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
