// PTX building blocks for Hopper (sm_90a) kernels: shared-memory
// addresses, mbarriers, TMA tensor and bulk loads, warpgroup MMA (wgmma) in
// bf16 and TF32, and the float conversions around them; the small pieces
// the attention kernels share (strides, the TF32 split and key order, the
// TMA swizzle, the mask, the warpgroups' partial sums, the ring
// barriers); on the host, the lookup of
// libcuda's tensor-map encoder.
//
// Each PTX helper is one instruction or a short fixed sequence, named
// after it. Header-only, included by the kernels under csrc/ that need it
// (ops/build.py hashes every file of csrc/, so an edit here rebuilds
// them).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; call once after the inits, before a block barrier.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// mbar_arrive_expect_tx by the threads where `pred` holds, predicated as
// tma_load_4d_if.
__device__ __forceinline__ void mbar_arrive_expect_tx_if(bool pred,
                                                         uint32_t bar,
                                                         uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes), "r"((int)pred)
      : "memory");
}

// Spin until the phase of parity `parity` has completed, or give up after
// 2^26 polls (each try_wait itself blocks for a while: seconds in all,
// where a real wait takes microseconds), which can only be a lost
// arrival. A barrier starts in phase 0, so the first completion is waited
// for with parity 0, the second with 1, and so on alternately. Returns
// whether the phase completed.
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done && ++polls < (1u << 26));
  return done;
}

// mbar_try_wait that traps when the phase never completes, so the launch
// fails with an error instead of hanging the card. (Between a wgmma and
// its wait, a trap makes ptxas serialize every wgmma of the kernel: there,
// call mbar_try_wait and trap once the products are done.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (!mbar_try_wait(bar, parity)) __trap();
}

// Orders this thread's earlier shared-memory writes (generic proxy) before
// later reads of the async proxy (wgmma, TMA); the readers must still
// synchronise with the writers after it (a barrier).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Block barrier `id` (1..15; 0 is __syncthreads) over `count` threads, a
// multiple of 32: a warpgroup's own barrier is bar_sync(id, 128).
__device__ __forceinline__ void bar_sync(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- TMA ------------------------------------------------------------------

// Copy the box of `map` at coordinates (c0, c1, c2, c3), innermost first,
// into shared memory at `dst`; completion adds the box's bytes to `bar`.
// Elements outside the tensor's bounds arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// tma_load_4d issued only where `pred` holds: a predicated instruction,
// not a branch. Between a wgmma and its wait, code that ptxas cannot prove
// uniform over the warpgroup (a branch on the thread's index) makes it
// serialize every wgmma of the kernel.
__device__ __forceinline__ void tma_load_4d_if(bool pred, uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int c0, int c1,
                                               int c2, int c3) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %7, 0;\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"((int)pred)
      : "memory");
}

// Copy `bytes` (a multiple of 16) from global `src` to shared memory at
// `dst`, both 16-byte aligned; completion adds the bytes to `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// bulk_load issued only where `pred` holds (predicated, as tma_load_4d_if).
__device__ __forceinline__ void bulk_load_if(bool pred, uint32_t dst,
                                             const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar),
      "r"((int)pred)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor. `layout`: 1 = 128-byte swizzle, 2 = 64,
// 3 = 32, the swizzle the TMA box was written with. For a K-major operand
// `sbo` is the byte stride between 8-row groups (8 rows of one swizzle
// span) and `lbo` is unused; for an MN-major operand `sbo` is the stride
// between groups of 8 K-rows and `lbo` the stride between swizzle-span-
// wide column blocks. The tile must start on a 1024-byte boundary (the
// 128-byte swizzle's period) apart from the offsets that step along K
// inside one swizzle span.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Waits until at most N of the warpgroup's committed wgmma groups are still
// pending; groups complete in the order they were committed.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers across the asynchronous wgmma: the compiler
// must not move or reuse them between the wgmma and the wait that ends it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] (+)= A[64 x 16] * B[16 x N], bf16 in, f32 accumulate, scale_d = 0
// overwrites d. The accumulator is spread over the warpgroup as the m16n8
// C fragment repeated: warp w holds rows 16w..16w+15, and d[4j + 2r + e]
// of lane l is row 16w + l/4 + 8r, column 8j + 2(l%4) + e.
//
// WgmmaSS: A and B both K-major in shared memory (descriptors).
// WgmmaRS: A from registers (four b32 of two bf16 each, the m16n8k16 A
// fragment of the warp's 16 rows), B MN-major in shared memory.
template <int N>
struct WgmmaSS;
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<32> {
  static __device__ __forceinline__ void run(
      float (&d)[16], uint64_t desc_a,
      uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void run(
      float (&d)[32], uint64_t desc_a,
      uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(
      float (&d)[8], const uint32_t (&a)[4],
      uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(
      float (&d)[16], const uint32_t (&a)[4],
      uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(
      float (&d)[32], const uint32_t (&a)[4],
      uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(
      float (&d)[64], const uint32_t (&a)[4],
      uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

// ---- TF32 ----------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero), as
// the float with the low 13 mantissa bits zero.
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// d[64 x N] (+)= A[64 x 8] * B[8 x N] in TF32, f32 accumulate, with the
// accumulator layout of the bf16 products above. TF32 has no transpose:
// both shared-memory operands are K-major (a k-step of 8 is 32 bytes, as a
// bf16 k-step of 16). The register A fragment of warp w is its 16 rows in
// the m16n8k8 TF32 layout: a0 = (row l/4, col l%4), a1 = (row l/4 + 8,
// col l%4), a2 and a3 the same rows at col l%4 + 4.
template <int N>
struct WgmmaTf32SS;
template <int N>
struct WgmmaTf32RS;

template <>
struct WgmmaTf32SS<32> {
  static __device__ __forceinline__ void run(
      float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32SS<64> {
  static __device__ __forceinline__ void run(
      float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32RS<8> {
  static __device__ __forceinline__ void run(
      float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaTf32RS<16> {
  static __device__ __forceinline__ void run(
      float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaTf32RS<32> {
  static __device__ __forceinline__ void run(
      float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaTf32RS<64> {
  static __device__ __forceinline__ void run(
      float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

// (x0, x1) rounded to a bf16 pair (x0 in the low half) and what the
// rounding left over, rounded to a bf16 pair too: x = hi + lo to 16 bits.
// Two products against the same bf16 operand then carry 16 bits of x.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - back.x, x1 - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2^x on the special-function unit (about 2^-22 relative error); results
// below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- shared by the attention kernels ----------------------------------------

struct Strides {  // element strides of a [B, T, H, D] tensor (D stride 1)
  long long b, t, h;
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both to nearest:
// about 21 bits of x survive in a sum of TF32 products of the parts.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - hi);
}

// The position held at place p of a group of 8 in the float32 kernels'
// transposed tiles: [0, 2, 4, 6, 1, 3, 5, 7]. A wgmma accumulator gives a
// thread columns 2t and 2t + 1 of each group of 8, where the TF32
// register-A fragment wants t and t + 4; in this order they are the same.
__device__ __forceinline__ int key_at(int p) { return p < 4 ? 2 * p : 2 * p - 7; }

// Byte offset of byte cb of row r in a tile that TMA would write with the
// swizzle of kRowBytes-byte rows (128 or 64; the tile 1024-byte aligned):
// the 16-byte chunk index is XORed with r % 8 (128 B) or (r / 2) % 4
// (64 B).
template <int kRowBytes>
__device__ __forceinline__ uint32_t swizzled(int r, int cb) {
  const int x = kRowBytes == 128 ? (r & 7) : ((r >> 1) & 3);
  return r * kRowBytes + (((cb >> 4) ^ x) << 4) + (cb & 15);
}

// Sets masked scores of an accumulator [64 rows x N cols] to mask_raw (the
// mask value before the scale). This thread's element e sits at row
// row0 + 8 ((e / 2) % 2) and column col_base + 8 (e / 4) + col0 + e % 2.
// keys_are_rows: the rows are keys and the columns queries (S^T), else
// the transpose. Key j is kept for query i when j < kv_len and, if
// causal, j <= i + q_start.
template <int N>
__device__ __forceinline__ void apply_mask(float (&s)[N / 2], int kv_len,
                                           int causal, int q_start,
                                           float mask_raw, int row0,
                                           int col_base, int col0,
                                           bool keys_are_rows) {
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const int row = row0 + 8 * ((e / 2) % 2);
    const int col = col_base + 8 * (e / 4) + col0 + (e % 2);
    const int key = keys_are_rows ? row : col;
    const int query = keys_are_rows ? col : row;
    const bool keep = key < kv_len && (!causal || key <= query + q_start);
    s[e] = keep ? s[e] : mask_raw;
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

// Ring barriers full[0 .. n) (a stage's loads each), then one for the
// tiles loaded once; each completes on its loader's arrival and bytes.
// Ends in a block barrier.
__device__ __forceinline__ void init_barriers(uint32_t bar_full, int n,
                                              uint32_t bar_once) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < n; ++s) mbar_init(bar_full + 8 * s, 1);
    mbar_init(bar_once, 1);
    fence_mbar_init();
  }
  __syncthreads();
}

// ---- host: the tensor-map encoder -------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query, so a library needs no link against libcuda. Null if not found.
inline EncodeTiled encode_tiled() {
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

}  // namespace sm90
