// Hopper (sm_90a) building blocks shared by the port's tensor-core
// kernels: the flash-attention kernels (flash_attention.cu) and the fused
// 1x1-conv + BatchNorm-statistics kernel (conv_bn.cu).
//
//   * cp.async 16- and 4-byte copies into shared memory (zero-filled past
//     the bytes asked for), their commit groups and waits, and the proxy
//     fence that makes shared-memory writes visible to wgmma;
//   * warpgroup MMAs (wgmma, bf16 in, float32 accumulate) with both
//     operands in shared memory (m64n64k16, m64n128k16) or A
//     in registers (m64n64k16), and their fences and waits;
//   * the 128-byte swizzle of the wgmma operand tiles: a bf16 tile [R][C]
//     is stored as C / 64 column blocks of [R][64], each row 128 bytes,
//     the 16-byte chunk c of row r at chunk c ^ (r % 8), block bases 1024-
//     byte aligned; an 8-row group is one 1024-byte swizzle atom;
//   * bf16 packing, exp2 on the special-function unit, and the tile loader
//     of the [B, L, H, D] attention tensors;
//   * on the host, a kernel's dynamic shared-memory limit raised once per
//     device, not before every launch.
//
// Each source of the port is compiled on its own into its own library,
// so everything here sits in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the first `bytes` are copied, the rest of
// the 16 zero-filled (bytes = 0 reads nothing).
__device__ __forceinline__ void cp_async16(bf16* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Makes this thread's shared-memory writes (cp.async or plain stores)
// visible to the wgmma operand reads that follow the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Pins an accumulator: the compiler may neither read it before the
// wgmma wait that precedes this nor write it after the fence that
// follows.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e]) :: "memory");
}

// Element offset of the 8-column chunk starting at column c (a multiple
// of 8) of row r in a 128-byte-swizzled [R][.] tile.
template <int R>
__device__ __forceinline__ int sw_offset(int r, int c) {
  return (c >> 6) * R * 64 + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3);
}

// wgmma descriptor of a 128-byte-swizzled operand starting at p: 8-row
// groups 1024 bytes apart, column blocks `lbo` bytes apart (read only
// for MN-major operands wider than one block).
__device__ __forceinline__ uint64_t sw128_desc(const bf16* p, uint32_t lbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 64) += A (64 x 16) B (16 x 64), A and B in shared memory,
// both K-major (B stored [n][k]). d holds this thread's 32 values in the
// mma C layout of its warp's 16 rows.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// The same with A from registers (the warp's 16 rows of the 64 x 16
// slice as an mma.sync m16n8k16 A fragment) and B MN-major (stored
// [k][n], transposed on the way in).
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A (64 x 16) B (16 x 128), both operands in shared
// memory and K-major, as wgmma_ss: d holds this thread's 64 values, 4 for
// each 8-column group.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

// The shared-memory wgmma of width N (64 or 128).
template <int N>
__device__ __forceinline__ void wgmma_ss_n(float (&d)[N / 8][4], uint64_t da,
                                           uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64) {
    wgmma_ss(d, da, db);
  } else {
    wgmma_ss_n128(d, da, db);
  }
}

// Two floats rounded to bf16, the first in the low half: the register
// layout of an mma operand pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (flushes denormal results to zero,
// about 2 ulp): one instruction per score.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

union Chunk8 {                         // 8 bf16 values, one 16-byte store
  uint4 u;
  bf16 h[8];
};

// The 1024-byte aligned start of the dynamic shared memory.
__device__ __forceinline__ bf16* smem_base(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return reinterpret_cast<bf16*>(raw + (((a + 1023) & ~1023u) - a));
}

// Rows [row0, row0 + R) of head (b, h) of a [B, L, H, D] bf16 tensor
// into a swizzled [R][kD] tile, zeros past L and past D. With `vec`
// (D % 8 == 0, 16-byte aligned rows) each 16-byte chunk is one cp.async
// that completes with the thread's next commit group; otherwise the
// chunk is gathered element by element and stored at once.
template <int R, int kD, int kThreadsT>
__device__ __forceinline__ void load_tile_bf16(bf16* tile, const bf16* base,
                                               const long long* s, int b,
                                               int h, int row0, int L,
                                               int D, bool vec) {
  constexpr int kC = kD / 8;
  static_assert(R * kC % kThreadsT == 0, "whole chunks per thread");
  const bf16* p = base + b * s[0] + h * s[2];
#pragma unroll
  for (int it = 0; it < R * kC / kThreadsT; ++it) {
    const int idx = threadIdx.x + it * kThreadsT;
    const int r = idx / kC;
    const int c = (idx % kC) * 8;
    const int row = row0 + r;
    const bf16* src = p + (long long)row * s[1] + c;
    bf16* dst = tile + sw_offset<R>(r, c);
    if (vec) {
      const bool in = row < L && c < D;
      cp_async16(dst, in ? src : p, in ? 16 : 0);
    } else {
      Chunk8 ch;
      ch.u = make_uint4(0, 0, 0, 0);
      if (row < L) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < D) ch.h[j] = src[j];
      }
      *reinterpret_cast<uint4*>(dst) = ch.u;
    }
  }
}

// Host: per device, whether one kernel's shared-memory limit is raised.
// Each launcher keeps its own (a function-local static), so a limit is
// asked for once per kernel and device, not on every launch.
constexpr int kMaxDevices = 64;
using SmemSet = std::atomic<bool>[kMaxDevices];

// Raises `kernel`'s dynamic shared-memory limit to `smem` bytes on the
// current device unless `done` says it already is. Returns 0 or the CUDA
// error; a failed attempt is tried again on the next launch.
template <typename K>
int set_smem_once(K kernel, size_t smem, SmemSet& done) {
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  const bool tracked = dev >= 0 && dev < kMaxDevices;
  if (tracked && done[dev].load(std::memory_order_acquire)) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess && tracked)
    done[dev].store(true, std::memory_order_release);
  return static_cast<int>(e);
}

}  // namespace
