// Paged-attention decode for Hopper (sm_90a): one query token per decode
// slot per head, attending over that slot's live KV pages through its
// page table.
//
// Replaces horovod_tpu/ops/paged_attention.py::_paged_decode_kernel (the
// Pallas kernel launched at paged_attention.py:204). The TPU kernel walks
// a sequential (slot, head, page-step) grid with the page tables and the
// lengths scalar-prefetched and carries its online-softmax state in VMEM
// scratch from one page step to the next. Here one thread block owns one
// (slot, head) pair and loops over the slot's live rows itself; the block
// reads its own lengths[s] and tables[s, j], which is what scalar prefetch
// did on the TPU.
//
// What bounds it on an H100: HBM bytes. Every live K and V row of the
// slot is read once, sum_s ceil(len_s/ps)*ps*H*D*2*sizeof(T), and there
// are 4 flops per element read, far below the card's flop/byte balance.
// The design keeps bytes at that minimum and keeps enough rows in flight:
//   * each warp takes a tile of kRows consecutive rows at a time and loads
//     all their K and V elements into registers before it reduces, so one
//     warp has 2*kRows row loads outstanding;
//   * lanes split the head dimension (lane + 32*i), so a row's load is one
//     coalesced stretch of D elements;
//   * each warp keeps its own running max m, sum l and accumulator acc in
//     float32 registers; the warps' states are merged once, at the end,
//     through shared memory;
//   * rows at or past len are masked to -1e30 before the running max and
//     are never read: the stale rows of a reused page and the null page 0
//     never enter a sum, and an idle lane (len == 0) reads nothing and
//     writes a zero row. The kernel is read-only over the pages.
// Types: float and bf16 (bf16 inputs, float32 statistics; the softmax
// weight is rounded to the input type before the P.V product, as the
// Pallas kernel does). Any page_size; D <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// kPerLane head-dim elements per lane (D <= 32 * kPerLane); kRows rows per
// warp per tile, fewer when each row takes more registers.
template <typename T, int kPerLane>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int D, int ps, int pps, float scale) {
  constexpr int kRows = kPerLane >= 8 ? 2 : (kPerLane >= 4 ? 4 : 8);
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = lengths[s];
  T* o = out + ((size_t)s * H + h) * D;

  if (len <= 0) {  // idle lane: a zero row, nothing read
    for (int d = threadIdx.x; d < D; d += kThreads) o[d] = from_float<T>(0.f);
    return;
  }

  const T* qs = q + ((size_t)s * H + h) * D;
  float qr[kPerLane], acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? to_float(qs[d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;
  const int* tab = tables + (size_t)s * pps;
  const size_t row_stride = (size_t)H * D;
  const size_t head_off = (size_t)h * D;

  // Rows base..base+kRows-1 of the slot's logical cache; the warps
  // interleave tiles, so together they walk the live pages once.
  for (int base = warp * kRows; base < len; base += kWarps * kRows) {
    float kf[kRows][kPerLane], vf[kRows][kPerLane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int pos = base + r;
      if (pos < len) {
        const int page = tab[pos / ps];
        const size_t off =
            ((size_t)page * ps + (pos % ps)) * row_stride + head_off;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int d = lane + 32 * i;
          kf[r][i] = d < D ? to_float(k_pages[off + d]) : 0.f;
          vf[r][i] = d < D ? to_float(v_pages[off + d]) : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          kf[r][i] = 0.f;
          vf[r][i] = 0.f;
        }
      }
    }
    float sc[kRows];
    float tile_max = kNegInf;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) part += qr[i] * kf[r][i];
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, w);
      // The cache mask, applied before the running max.
      sc[r] = (base + r < len) ? part * scale : kNegInf;
      tile_max = fmaxf(tile_max, sc[r]);
    }
    // Row `base` is live, so m_new is finite and a masked row's weight
    // exp(-1e30 - m_new) is exactly 0.
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] *= alpha;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p = expf(sc[r] - m_new);
      l += p;
      const float pv = to_float(from_float<T>(p));
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc[i] += pv * vf[r][i];
    }
    m = m_new;
  }

  // Merge the warps' (m, l, acc). A warp that saw no row holds
  // m = -1e30, l = 0, acc = 0 and gets weight exp(-1e30 - M) = 0.
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxD];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) sm_acc[warp][d] = acc[i];
  }
  __syncthreads();
  float M = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
  float L = 0.f;
  float wt[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wt[w] = expf(sm_m[w] - M);
    L += sm_l[w] * wt[w];
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w][d] * wt[w];
    o[d] = from_float<T>(a * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* tables,
           const int* lengths, void* out, int S, int H, int D, int ps,
           int pps, float scale, cudaStream_t stream) {
  const dim3 grid(S, H);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (D <= 32) {
    paged_decode_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, tables, lengths, ot, H, D, ps, pps, scale);
  } else if (D <= 64) {
    paged_decode_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, tables, lengths, ot, H, D, ps, pps, scale);
  } else if (D <= 128) {
    paged_decode_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, tables, lengths, ot, H, D, ps, pps, scale);
  } else {
    paged_decode_kernel<T, 8><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, tables, lengths, ot, H, D, ps, pps, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Shapes (all contiguous):
//   q [S, H, D], k/v pages [P, ps, H, D], tables [S, pps] int32,
//   lengths [S] int32, out [S, H, D].
// Returns cudaGetLastError() after the launch (0 = launched); -1 for an
// argument this kernel does not take.
extern "C" int hvd_paged_attention_decode(int dtype, const void* q,
                                          const void* k_pages,
                                          const void* v_pages,
                                          const int* tables,
                                          const int* lengths, void* out,
                                          int S, int H, int D, int ps,
                                          int pps, float scale,
                                          void* stream) {
  if (S < 0 || H <= 0 || D <= 0 || D > kMaxD || ps <= 0 || pps <= 0)
    return -1;
  if (S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, tables, lengths, out, S, H,
                         D, ps, pps, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, lengths, out,
                                 S, H, D, ps, pps, scale, st);
  return -1;
}
