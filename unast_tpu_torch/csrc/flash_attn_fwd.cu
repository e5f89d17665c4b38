// Flash-attention forward in float32 on the CUDA cores (sm_90a), plain C
// entry point `flash_attn_fwd_f32`.
//
// Replaces the Pallas TPU kernel unast_tpu/ops/attention.py::_flash_fwd
// (body _attn_kernel, driven through _kernel_with_prefetch) for float32
// inputs; bfloat16 inputs go to the tensor-core kernel of
// flash_attn_fwd_wgmma.cu. Computes
//   o = softmax(q k^T / sqrt(D) + mask) v
// over q [B, Tq, H, D], k and v [B, Tk, H, D] and writes o [B, Tq, H, D].
// Key j of batch row b is kept when j < kv_lens[b] and, if causal, when
// j <= i (query i). Masked scores are -1e9, as on the TPU. The online
// softmax state (m, l, acc) is float32; o = acc / max(l, 1e-30), cast to the
// input type. No log-sum-exp is written.
//
// Design (simple and right first):
//   - one block per (64-row query tile, b*h); 256 threads, four per query
//     row. Thread `lane` of a row owns columns lane, lane+4, lane+8, ...,
//     so the four lanes read neighbouring shared-memory words and the eight
//     rows of a warp read the same words (broadcast, no bank conflict);
//   - K and V tiles of 64 keys are staged in shared memory as float32; a
//     row's 64 scores live in registers, each reduced over its four lanes
//     with two warp shuffles;
//   - the tensors are read in place through the strides the caller gives
//     (the [B, T, H, D] views of a fused QKV projection), the last dim
//     contiguous; the block loads kv_lens[b] itself (the TPU kernel got it
//     by scalar prefetch);
//   - the key loop stops at the last key any row of the tile can see
//     (min of kv_len, Tk and, if causal, the tile's last row + 1). Keys past
//     that point carry weight exp(-1e9 - m) = 0 exactly, so the result is
//     unchanged; the ragged Tq/Tk edges (815, 300) are masked here;
//   - float32 inputs, templated on D in {16, 32, 64, 128}.
//
// Precondition: every kv_len >= 1 (both Synthesizer paths guarantee it).
// For a row with no visible key the TPU kernel's output depends on its
// block padding; this kernel writes zeros there. Neither is a contract.
//
// What bounds it on an H100 SXM: at B8 H4 T815 D64 in float32 the work is
// 4*B*H*T^2*D = 5.4 GFLOP per call, 81 us at the CUDA cores' 67 TFLOP/s,
// against 26.8 MB of q/k/v/o, 8 us at 3.35 TB/s: compute-bound. The
// tensor cores would take float32 only as TF32, which keeps about three
// decimal digits, too few for the float32 tolerance of 2e-5, so the
// products stay on the CUDA cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kLanes = 4;                       // threads per query row
constexpr int kThreads = kBlockQ * kLanes;      // 256
constexpr float kMaskValue = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Strides {  // element strides of a [B, T, H, D] tensor (D stride 1)
  long long b, t, h;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int32_t* __restrict__ kv_lens, int H, int Tq, int Tk,
                 Strides qs, Strides ks, Strides vs, Strides os, int causal,
                 float sm_scale) {
  constexpr int kCols = D / kLanes;  // columns owned by one thread
  extern __shared__ float smem[];
  float* k_tile = smem;                    // [kBlockK][D]
  float* v_tile = smem + kBlockK * D;      // [kBlockK][D]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q_start = blockIdx.x * kBlockQ;
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int qpos = q_start + row;

  int kv_len = Tk;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[b], 0), Tk);
  int n_keys = kv_len;
  if (causal) n_keys = min(n_keys, min(Tq, q_start + kBlockQ));

  // This thread's slice of its query row, pre-scaled as on the TPU.
  float qr[kCols];
  const T* q_row = q + b * qs.b + (long long)qpos * qs.t + h * qs.h;
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    qr[i] = qpos < Tq ? to_f32(q_row[lane + kLanes * i]) * sm_scale : 0.f;

  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  const T* k_base = k + b * ks.b + h * ks.h;
  const T* v_base = v + b * vs.b + h * vs.h;

  for (int kb = 0; kb < n_keys; kb += kBlockK) {
    // Stage the K/V tile; keys past n_keys are zero (never NaN garbage).
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D;
      const int c = idx % D;
      const int kpos = kb + j;
      float kval = 0.f, vval = 0.f;
      if (kpos < n_keys) {
        kval = to_f32(k_base[(long long)kpos * ks.t + c]);
        vval = to_f32(v_base[(long long)kpos * vs.t + c]);
      }
      k_tile[idx] = kval;
      v_tile[idx] = vval;
    }
    __syncthreads();

    float s[kBlockK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        dot = fmaf(qr[i], k_tile[j * D + lane + kLanes * i], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = kb + j;
      const bool keep = kpos < kv_len && (!causal || kpos <= qpos);
      s[j] = keep ? dot : kMaskValue;
      m_tile = fmaxf(m_tile, s[j]);
    }

    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_new);
      l_tile += p;
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        acc[i] = fmaf(p, v_tile[j * D + lane + kLanes * i], acc[i]);
    }
    l = l * alpha + l_tile;
    m = m_new;
    __syncthreads();  // the next tile overwrites k_tile / v_tile
  }

  if (qpos < Tq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o_row = o + b * os.b + (long long)qpos * os.t + h * os.h;
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      o_row[lane + kLanes * i] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const void* kv_lens, int B, int H, int Tq, int Tk,
                   Strides qs, Strides ks, Strides vs, Strides os, int causal,
                   float sm_scale, cudaStream_t stream) {
  const size_t smem = 2 * kBlockK * D * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Tq + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int32_t*>(kv_lens), H, Tq, Tk, qs, ks, vs, os, causal,
      sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, const void* kv_lens, int B, int H, int Tq,
                       int Tk, Strides qs, Strides ks, Strides vs, Strides os,
                       int causal, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, kv_lens, B, H, Tq, Tk, qs, ks, vs, os,
                           causal, sm_scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, kv_lens, B, H, Tq, Tk, qs, ks, vs, os,
                           causal, sm_scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, kv_lens, B, H, Tq, Tk, qs, ks, vs, os,
                           causal, sm_scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, kv_lens, B, H, Tq, Tk, qs, ks, vs, os,
                            causal, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements, for the b, t and h dims of each [B, T, H, D]
// float32 tensor (the D stride must be 1). kv_lens: int32 [B] on the
// device, or null for "all Tk keys valid". Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int flash_attn_fwd_f32(
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
  return (int)dispatch_d<float>(D, q, k, v, o, kv_lens, B, H, Tq, Tk, qs, ks,
                                vs, os, causal, sm_scale,
                                static_cast<cudaStream_t>(stream));
}
