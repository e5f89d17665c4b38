// Flash-attention forward in bfloat16 on Hopper's tensor cores (sm_90a):
// warpgroup MMA (wgmma) fed by TMA through a ring of shared-memory stages.
// Plain C entry point `flash_attn_fwd_wgmma`, loaded with ctypes.
//
// Replaces the Pallas TPU kernel unast_tpu/ops/attention.py::_flash_fwd
// (body _attn_kernel, driven through _kernel_with_prefetch) for bfloat16
// inputs; float32 inputs go to the CUDA-core kernel of flash_attn_fwd.cu.
// Computes
//   o = softmax(q k^T / sqrt(D) + mask) v
// over q [B, Tq, H, D], k and v [B, Tk, H, D] and writes o [B, Tq, H, D].
// Key j of batch row b is kept when j < kv_lens[b] and, if causal, when
// j <= i (query i). Masked scores are -1e9 (set on the unscaled product
// as -1e9 * sqrt(D)). The softmax state (m, l) and the accumulator are
// float32; o = acc / max(l, 1e-30), cast to bfloat16. P is rounded to
// bfloat16 before P.V, as the JAX attention_core does for bfloat16, so
// the output differs from the plain version (which keeps P in float32) by
// about one bfloat16 rounding.
//
// What bounds it on an H100 SXM: at the ASR encoder shape B8 H4 T815 D64
// the work is 4*B*H*T^2*D = 5.4 GFLOP (fewer with ragged kv_lens), 5.5 us
// at the 989 TFLOP/s bf16 tensor-core peak, against 13.4 MB of q/k/v/o,
// 4 us at 3.35 TB/s: compute-bound. Design:
//   - one block per (128 query rows, b*h): two consumer warpgroups of 64
//     rows each and one producer warp (288 threads). At B8 T815 H4 that is
//     7 x 32 = 224 blocks, and two blocks fit on an SM at D <= 64, so the
//     grid is one wave on 132 SMs;
//   - the producer's lane 0 loads the Q tile once and then K and V tiles of
//     64 keys into a two-stage ring with TMA, each stage's completion
//     counted on a "full" mbarrier; the eight consumer warps give a stage
//     back on its "empty" mbarrier once both products have read it;
//   - S = Q K^T: wgmma m64n64k16, Q and K both K-major in shared memory;
//     the mask is applied to the float32 accumulator, only on tiles that
//     reach past kv_len or the causal diagonal, and the scale inside the
//     exponent below; Q is never pre-scaled in bfloat16 (1/sqrt(D) is
//     exact in bf16 only for D 16 and 64);
//   - online softmax in registers on the unscaled scores: the row max m
//     of S, then p = 2^(S c - m c) with c = log2(e) / sqrt(D), one FFMA and
//     one ex2 per score; masked keys give p = 0 exactly, since
//     2^(-1e9 log2 e - m c) underflows;
//   - O += P V: wgmma m64nDk16 with P from registers (the S accumulator's
//     fragment is the A operand's, so P is packed to bf16 pairs in place)
//     and V from shared memory as the MN-major B operand (trans-b);
//   - the tensor maps are built per call on the host over the 4-D
//     (D, H, T, B) strided view, so the fused-QKV views are read in place;
//     the real T is their bound, so TMA zero-fills the ragged edge. The
//     swizzle follows the row width: 32 B for D 16, 64 B for D 32, 128 B
//     for D 64; D 128 is two 64-column boxes. The wgmma descriptors use
//     the same swizzle;
//   - the key loop stops at the last key any row of the block can see
//     (min of kv_len, Tk and, if causal, the block's last row + 1), as in
//     the CUDA-core kernel; O is stored from registers, rows past Tq not.
//
// Precondition: every kv_len >= 1 (both Synthesizer paths guarantee it).
// A row with no visible key gets zeros; that is not a contract.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;  // query rows per block
constexpr int kBlockN = 64;   // keys per K/V tile
constexpr int kStages = 2;    // depth of the K/V ring
constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -1e9f;

// Return codes besides cudaError_t values.
constexpr int kErrTensorMap = -1;    // a layout the TMA unit does not take
constexpr int kErrNoEncoder = -2;    // cuTensorMapEncodeTiled not found

// Shared-memory plan for head dim D (byte offsets from a 1024-aligned
// base): the Q tile, then per stage a K tile and a V tile, then the
// barriers. Each tile is kBoxes boxes of rows x kBoxD columns, each box
// rows x kRowBytes bytes in the TMA swizzle.
template <int D>
struct Plan {
  static constexpr int kBoxD = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kBoxD;
  static constexpr int kRowBytes = kBoxD * 2;
  static constexpr uint32_t kLayout =
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kQBox = kBlockM * kRowBytes;
  static constexpr int kKVBox = kBlockN * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;  // one K or one V tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarriers = kQBytes + kStages * kStageBytes;
  static constexpr int kSmem = kBarriers + 8 * (2 * kStages + 1) + 1024;
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
};

struct Params {
  __nv_bfloat16* o;
  const int32_t* kv_lens;
  long long o_sb, o_st, o_sh;  // element strides of o's b, t, h dims
  int H, Tq, Tk, causal;
  float scale_log2;  // log2(e) / sqrt(D)
  float mask_raw;    // -1e9 * sqrt(D): a masked score before the scale
};

// 2^x on the special-function unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, Plan<D>::kMinBlocks)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const Params p) {
  using P = Plan<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_kv = base + P::kQBytes;
  const uint32_t bar_full = base + P::kBarriers;  // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_q = bar_empty + 8 * kStages;

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kBlockM;
  int kv_len = p.Tk;
  if (p.kv_lens != nullptr) kv_len = min(max(p.kv_lens[b], 0), p.Tk);
  int n_keys = kv_len;
  if (p.causal) n_keys = min(n_keys, min(p.Tq, q0 + kBlockM));
  const int n_tiles = (n_keys + kBlockN - 1) / kBlockN;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    mbar_init(bar_q, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // Producer: lane 0 keeps the ring full.
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, P::kQBytes);
      for (int x = 0; x < P::kBoxes; ++x)
        tma_load_4d(s_q + x * P::kQBox, &map_q, bar_q, x * P::kBoxD, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        // the stage's previous tile (i - kStages) must have been released
        if (i >= kStages) mbar_wait(bar_empty + 8 * s, (i / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t s_k = s_kv + s * P::kStageBytes;
        const uint32_t s_v = s_k + P::kKVBytes;
        mbar_arrive_expect_tx(full, P::kStageBytes);
        for (int x = 0; x < P::kBoxes; ++x) {
          tma_load_4d(s_k + x * P::kKVBox, &map_k, full, x * P::kBoxD, h,
                      i * kBlockN, b);
          tma_load_4d(s_v + x * P::kKVBox, &map_v, full, x * P::kBoxD, h,
                      i * kBlockN, b);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this thread
  // holds rows row0 and row0 + 8 (accumulator layout in sm90.cuh).
  const int wg = warp / 4;
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  constexpr int kS = kBlockN / 2;  // score accumulators per thread
  constexpr int kO = D / 2;        // output accumulators per thread
  constexpr int kSteps = P::kBoxD / 16;  // k-steps inside one box
  float o_acc[kO];
  float s_acc[kS];  // each tile overwrites it (scale_d 0 on the first step)
#pragma unroll
  for (int e = 0; e < kO; ++e) o_acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kS; ++e) s_acc[e] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};  // this thread's part of the row sums
  const uint32_t s_q_wg = s_q + 64 * wg * P::kRowBytes;

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t s_k = s_kv + s * P::kStageBytes;
    const uint32_t s_v = s_k + P::kKVBytes;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);

    // S = Q K^T over D in k-steps of 16 (32 bytes inside one swizzle row).
    fence_operands(s_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int x = kk / kSteps;
      const int w = kk % kSteps;
      const uint64_t da = make_desc(s_q_wg + x * P::kQBox + 32 * w, 16,
                                    8 * P::kRowBytes, P::kLayout);
      const uint64_t db = make_desc(s_k + x * P::kKVBox + 32 * w, 16,
                                    8 * P::kRowBytes, P::kLayout);
      WgmmaSS<kBlockN>::run(s_acc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s_acc);

    // Mask only where the tile needs it.
    const int kb = i * kBlockN;
    if (kb + kBlockN > kv_len ||
        (p.causal && kb + kBlockN - 1 > q0 + 64 * wg)) {
#pragma unroll
      for (int e = 0; e < kS; ++e) {
        const int col = kb + 8 * (e / 4) + col0 + (e % 2);
        const int row = row0 + 8 * ((e / 2) % 2);
        const bool keep = col < kv_len && (!p.causal || col <= row);
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

    // P as bf16 A fragments: k-step t covers keys 16t..16t+15, which are
    // the accumulator's column blocks 2t and 2t + 1.
    uint32_t pa[kBlockN / 16][4];
#pragma unroll
    for (int t = 0; t < kBlockN / 16; ++t) {
      pa[t][0] = pack_bf16(s_acc[8 * t + 0], s_acc[8 * t + 1]);
      pa[t][1] = pack_bf16(s_acc[8 * t + 2], s_acc[8 * t + 3]);
      pa[t][2] = pack_bf16(s_acc[8 * t + 4], s_acc[8 * t + 5]);
      pa[t][3] = pack_bf16(s_acc[8 * t + 6], s_acc[8 * t + 7]);
    }

    // O += P V: V is [keys, D] with D contiguous, the MN-major B operand;
    // a k-step moves 16 key rows on, and a D-128 tile's second 64-column
    // box lies one box further (lbo).
    fence_operands(o_acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kBlockN / 16; ++t) {
      const uint64_t dv = make_desc(s_v + 16 * t * P::kRowBytes, P::kKVBox,
                                    8 * P::kRowBytes, P::kLayout);
      WgmmaRS<D>::run(o_acc, pa[t], dv, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(o_acc);

    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  // o = acc / max(l, 1e-30), rows past Tq not stored.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = row0 + 8 * r;
    if (row < p.Tq) {
      __nv_bfloat16* o_row = p.o + b * p.o_sb + (long long)row * p.o_st +
                             h * p.o_sh + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * j) =
            __floats2bfloat162_rn(o_acc[4 * j + 2 * r] * inv,
                                  o_acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query, so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

struct Strides {  // element strides of a [B, T, H, D] tensor (D stride 1)
  long long b, t, h;
};

// Tensor map over the (D, H, T, B) view of a bf16 [B, T, H, D] tensor; a
// box is box_d columns of `rows` positions of one head of one batch row.
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* kv_lens, int B, int H, int Tq, int Tk, Strides qs,
           Strides ks, Strides vs, Strides os, int causal, float sm_scale,
           cudaStream_t stream) {
  using P = Plan<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  CUtensorMap map_q, map_k, map_v;
  if (!make_map<D>(encode, &map_q, q, B, Tq, H, qs, kBlockM) ||
      !make_map<D>(encode, &map_k, k, B, Tk, H, ks, kBlockN) ||
      !make_map<D>(encode, &map_v, v, B, Tk, H, vs, kBlockN))
    return kErrTensorMap;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.kv_lens = static_cast<const int32_t*>(kv_lens);
  p.o_sb = os.b;
  p.o_st = os.t;
  p.o_sh = os.h;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.causal = causal;
  p.scale_log2 = sm_scale * kLog2e;
  p.mask_raw = kMaskValue / sm_scale;
  dim3 grid((Tq + kBlockM - 1) / kBlockM, B * H);
  kernel<<<grid, kThreads, P::kSmem, stream>>>(map_q, map_k, map_v, p);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements, for the b, t and h dims of each [B, T, H, D]
// bfloat16 tensor (the D stride must be 1; q, k and v strides and base
// addresses multiples of 16 bytes). kv_lens: int32 [B] on the device, or
// null for "all Tk keys valid". Returns 0 when launched, a cudaError_t
// value if the launch failed, -1 if the TMA unit refused a tensor's
// layout, -2 if libcuda has no cuTensorMapEncodeTiled.
extern "C" int flash_attn_fwd_wgmma(
    const void* q, const void* k, const void* v, void* o, const void* kv_lens,
    int B, int H, int Tq, int Tk, int D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, int causal, float sm_scale,
    void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_st, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, kv_lens, B, H, Tq, Tk, qs, ks, vs, os,
                        causal, sm_scale, s);
    case 32:
      return launch<32>(q, k, v, o, kv_lens, B, H, Tq, Tk, qs, ks, vs, os,
                        causal, sm_scale, s);
    case 64:
      return launch<64>(q, k, v, o, kv_lens, B, H, Tq, Tk, qs, ks, vs, os,
                        causal, sm_scale, s);
    case 128:
      return launch<128>(q, k, v, o, kv_lens, B, H, Tq, Tk, qs, ks, vs, os,
                         causal, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
