// Paged-attention decode for Hopper (sm_90a): one query token per decode
// slot per head, attending over that slot's live KV pages through its
// page table, split over the key axis (flash-decoding).
//
// Replaces horovod_tpu/ops/paged_attention.py::_paged_decode_kernel (the
// Pallas kernel launched at paged_attention.py:204). The TPU kernel walks
// a sequential (slot, head, page-step) grid with the page tables and the
// lengths scalar-prefetched and carries its online-softmax state in VMEM
// scratch from one page step to the next. Blocks on this card run in no
// order and nothing carries between them, so the key axis is cut into
// chunks of R rows instead and each chunk is its own block:
//
//   1. paged_split_kernel, grid (splits, heads, slots), splits =
//      ceil(pps * ps / R) from the table width (the host never reads the
//      lengths, which would stall the stream). A block whose chunk starts
//      at or past lengths[s] exits at once. Each block reads its own
//      lengths[s] and page-table entries, which is what scalar prefetch
//      did on the TPU. It writes its chunk's float32 partial (m, l,
//      acc[D]) to the scratch [S, H, splits, D + 2]: m is the chunk's
//      largest score in log2 units (scale * log2(e) * q.k), l the sum of
//      2^(score - m), acc the sum of those weights times the V rows.
//   2. paged_merge_kernel, one warp per (slot, head): merges the slot's
//      live chunks in chunk order, out = sum_c acc_c w_c / max(sum_c l_c
//      w_c, 1e-30) with w_c = 2^(m_c - max_c m_c), in q's type. No float
//      atomics anywhere, so the result is the same bits from run to run.
//
// What bounds it on an H100: HBM bytes. Every live K and V row is read
// once, sum_s len_s * H * D * 2 * sizeof(T), with 4 flops per element
// read, far below the card's flop/byte balance. What the design does:
//   * lane groups: kLPR lanes share one (row, head) of D elements and each
//     loads 16 bytes (4 float32 or 8 bf16) of it, so one warp instruction
//     moves 512 bytes, 2 rows of float32 or 4 of bf16 at D = 64; the q.k
//     partial is summed over the group with shuffles. Rows whose bytes are
//     not a multiple of 16, or bases not 16-byte aligned, take the element
//     path (one element a lane, 32 lanes a row);
//   * each lane group holds kU rows, all their K and V loads issued before
//     the first reduction, and a block has the warps its chunk needs
//     (ceil(R / kU) lane groups a head): at R = 64 a chunk is one round
//     trip to memory. The block loads its length, q and the chunk's page
//     ids (into shared memory) at once, before it knows whether it has a
//     live row, so the K/V loads wait for one round trip, not three;
//   * each lane group keeps its running max m, sum l and acc in float32
//     registers (exp2 on the special-function unit, the scale folded into
//     its FMA); the lane groups of a warp, all of one head, merge by a
//     fixed butterfly of shuffles, then a head's warps in warp order
//     through shared memory;
//   * rows at or past len are never read: the stale rows of a reused page
//     and the null page 0 never enter a sum, and an idle lane (len == 0)
//     launches no live chunk and gets a zero row from the merge. The
//     kernels are read-only over the pages.
// At the long-context geometry (ops/paged_attention.py's LONG_GEOMETRY,
// 32 slots of up to 2048 keys) the split kernel reads at about the rate
// of PyTorch's own sum over the same K/V pools, and without its K/V
// loads it still takes about half its time: the launch, the prologue's
// round trip, the reductions (PERF.md).
// Types: float and bf16 (bf16 inputs, float32 statistics; the softmax
// weight is rounded to the input type before the P.V product, as the
// Pallas kernel does). Any page_size; D <= 256.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
// R, the key rows of a chunk; CHUNK_ROWS in ops/paged_attention.py, whose
// split plan gives the entry point ceil(pps * ps / R) chunks a slot.
// tune_paged.py on an H100 (PERF.md): at the serving shapes, the main
// path, 32 ties with 64, and 128 and 256 take 1.05-1.12x its device time;
// at the long-context geometry 32 doubles the merge's time, 256 saves 9%
// in float32 and loses 4% in bf16.
constexpr int kChunkRows = 64;
// Registers a lane gives to the K and V values of the rows it has in
// flight: 32 is 4 rows of 16-byte loads (64 bytes of K and of V a lane),
// 8 warps a float32 block and 4 a bf16 one at D = 64 and R = 64.
// tune_paged.py on an H100: at the long-context geometry 64 (half the
// warps) takes 1.06x the bf16 and 1.08x the float32 device time, 16
// (twice the warps) 1.23x and 1.16x; at the serving shapes all are
// within 7%.
constexpr int kKVRegs = 32;
constexpr int kMaxThreads = 512;
constexpr int kMergeWarps = 4;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// What one lane loads at a time: kEPV elements, 16 bytes (a uint4) on the
// vector path, one element on the element path.
template <typename T, int kEPV>
struct Packs {
  using P = T;
  static __device__ __forceinline__ P load(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ P zero() { return from_float<T>(0.f); }
  static __device__ __forceinline__ void to_f(P x, float (&f)[1]) {
    f[0] = to_float(x);
  }
};

template <>
struct Packs<float, 4> {
  using P = uint4;
  static __device__ __forceinline__ P load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ P zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ void to_f(P x, float (&f)[4]) {
    f[0] = __uint_as_float(x.x);
    f[1] = __uint_as_float(x.y);
    f[2] = __uint_as_float(x.z);
    f[3] = __uint_as_float(x.w);
  }
};

template <>
struct Packs<bf16, 8> {
  using P = uint4;
  static __device__ __forceinline__ P load(const bf16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ P zero() { return make_uint4(0, 0, 0, 0); }
  // A bf16 is the upper half of the float32 it stands for.
  static __device__ __forceinline__ void to_f(P x, float (&f)[8]) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* tables;
  const int* lengths;
  float* part;        // [S, H, splits, D + 2]: (m, l, acc[D]) per chunk
  int H, D, ps, pps;
  int splits;         // chunks a slot
  float sl2;          // scale * log2(e)
};

// Block (chunk c, head h, slot s): one head a block. tune_paged.py's
// all_heads variant (a block of one warp a head, so that a page row's
// [H, D] is read as one stretch) takes 1.7-5.1x the device time at the
// serving shapes (48 blocks for 132 SMs, against 576) and 0.86-1.05x at
// the long-context geometry. Warp w's lane groups take the row phases
// rp = w * (32 / kLPR) + lane / kLPR, the rows c*R + rp + nrp*j of the
// chunk.
template <typename T, int kEPV, int kLPR, int kVPL>
__global__ void __launch_bounds__(kMaxThreads)
paged_split_kernel(const SplitArgs a) {
  using PK = Packs<T, kEPV>;
  using P = typename PK::P;
  constexpr int kRegsPerPack = sizeof(P) >= 4 ? sizeof(P) / 4 : 1;
  constexpr int kU = kKVRegs / (2 * kVPL * kRegsPerPack) > 0
                         ? kKVRegs / (2 * kVPL * kRegsPerPack)
                         : 1;
  constexpr int R = kChunkRows;
  const int c = blockIdx.x;
  const int s = blockIdx.z;
  const int row0 = c * R;
  const int D = a.D;
  constexpr int kGroupsPerWarp = 32 / kLPR;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = threadIdx.x % kLPR;
  // The head, its warps and this warp's place among them.
  const int h = blockIdx.y;
  const int nw = blockDim.x / 32;
  const int wh = warp;
  const int rp = wh * kGroupsPerWarp + lane / kLPR;
  const int nrp = nw * kGroupsPerWarp;  // lane groups (row phases) a head
  const int* tab = a.tables + (size_t)s * a.pps;
  const int step = nrp * kU;
  const int W = D + 2;
  extern __shared__ float sm[];  // [warps][D + 2], then the page ids
  float* const red = sm;         // the head's warps' partials
  int* spage = reinterpret_cast<int*>(sm + blockDim.x / 32 * W);

  // The length, q and the page-table entries of the chunk's rows are
  // loaded together, before the block knows whether it has a live row:
  // one round trip to memory before the first K/V load, not three.
  const int p0 = row0 / a.ps;
  const int np = (min(row0 + R, a.pps * a.ps) - 1) / a.ps - p0 + 1;
  for (int i = threadIdx.x; i < np; i += blockDim.x)
    spage[i] = __ldg(tab + p0 + i);
  float qf[kVPL][kEPV], acc[kVPL][kEPV];
  const T* qs = static_cast<const T*>(a.q) + ((size_t)s * a.H + h) * D;
#pragma unroll
  for (int i = 0; i < kVPL; ++i) {
    const int d0 = (sub + kLPR * i) * kEPV;
    PK::to_f(d0 < D ? PK::load(qs + d0) : PK::zero(), qf[i]);
#pragma unroll
    for (int e = 0; e < kEPV; ++e) acc[i][e] = 0.f;
  }
  const int len = __ldg(a.lengths + s);
  if (row0 >= len) return;  // no live row in this chunk
  const int row_end = min(row0 + R, len);
  __syncthreads();          // the page ids are in shared memory
  float m = kNegInf;
  float l = 0.f;
  const size_t row_stride = (size_t)a.H * D;
  const T* kb = static_cast<const T*>(a.k) + (size_t)h * D;
  const T* vb = static_cast<const T*>(a.v) + (size_t)h * D;

  // One tile: kU rows a lane group, every K and V load issued before the
  // first use. Rows past the chunk or past len are masked, never read.
  auto load = [&](P (&kp)[kU][kVPL], P (&vp)[kU][kVPL], int t0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int pos = t0 + rp + nrp * u;
      const bool live = pos < row_end;
      const int page = live ? spage[pos / a.ps - p0] : 0;
      const size_t off = ((size_t)page * a.ps + pos % a.ps) * row_stride;
#pragma unroll
      for (int i = 0; i < kVPL; ++i) {
        const int d0 = (sub + kLPR * i) * kEPV;
        const bool in = live && d0 < D;
        kp[u][i] = in ? PK::load(kb + off + d0) : PK::zero();
        vp[u][i] = in ? PK::load(vb + off + d0) : PK::zero();
      }
    }
  };
  // The online softmax over one loaded tile. The bounds are the same for
  // the whole block, so every lane of a warp takes part in every shuffle.
  auto update = [&](const P (&kp)[kU][kVPL], const P (&vp)[kU][kVPL],
                    int t0) {
    float dot[kU];
    float tile_max = kNegInf;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kVPL; ++i) {
        float f[kEPV];
        PK::to_f(kp[u][i], f);
#pragma unroll
        for (int e = 0; e < kEPV; ++e) part = fmaf(qf[i][e], f[e], part);
      }
#pragma unroll
      for (int o = kLPR / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      dot[u] = part;
      // The cache mask, applied before the running max.
      if (t0 + rp + nrp * u < row_end)
        tile_max = fmaxf(tile_max, part * a.sl2);
    }
    // A group with no live row so far holds m = -1e30: its first live
    // row gives alpha = 2^(-1e30 - m_new) = 0, and while it has none its
    // weights are masked to 0 below.
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2_approx(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kVPL; ++i)
#pragma unroll
      for (int e = 0; e < kEPV; ++e) acc[i][e] *= alpha;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const bool live = t0 + rp + nrp * u < row_end;
      const float p = live ? exp2_approx(fmaf(dot[u], a.sl2, -m_new)) : 0.f;
      l += p;
      const float pv = round_to<T>(p);
#pragma unroll
      for (int i = 0; i < kVPL; ++i) {
        float f[kEPV];
        PK::to_f(vp[u][i], f);
#pragma unroll
        for (int e = 0; e < kEPV; ++e) acc[i][e] = fmaf(pv, f[e], acc[i][e]);
      }
    }
    m = m_new;
  };

  for (int t0 = row0; t0 < row_end; t0 += step) {
    P kp[kU][kVPL], vp[kU][kVPL];
    load(kp, vp, t0);
    update(kp, vp, t0);
  }

  // Merge into the chunk's partial: first the lane groups of each warp
  // by shuffles, a fixed butterfly, then the head's warps in warp order
  // through shared memory. A group that saw no live
  // row holds m = -1e30, l = 0, acc = 0 and gets weight 2^(-1e30 - M) = 0;
  // the chunk's first row is live, so each head's M is finite.
#pragma unroll
  for (int o = kLPR; o < 32; o <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, o);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, o);
    const float m_n = fmaxf(m, m_o);
    const float w = exp2_approx(m - m_n);
    const float w_o = exp2_approx(m_o - m_n);
    l = l * w + l_o * w_o;
#pragma unroll
    for (int i = 0; i < kVPL; ++i)
#pragma unroll
      for (int e = 0; e < kEPV; ++e)
        acc[i][e] = acc[i][e] * w +
                    __shfl_xor_sync(0xffffffffu, acc[i][e], o) * w_o;
    m = m_n;
  }
  if (lane < kLPR) {
    float* mine = red + wh * W;
    if (sub == 0) {
      mine[0] = m;
      mine[1] = l;
    }
#pragma unroll
    for (int i = 0; i < kVPL; ++i) {
      const int d0 = (sub + kLPR * i) * kEPV;
      if (d0 < D) {
#pragma unroll
        for (int e = 0; e < kEPV; ++e) mine[2 + d0 + e] = acc[i][e];
      }
    }
  }
  __syncthreads();
  constexpr int kMaxWarps = kMaxThreads / 32;
  float* const dst = a.part + (((size_t)s * a.H + h) * a.splits + c) * W;
  for (int j = wh * 32 + lane; j < W; j += nw * 32) {
    float M = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxWarps; ++r)
      if (r < nw) M = fmaxf(M, red[r * W]);
    float val = M;
    if (j > 0) {
      val = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxWarps; ++r)
        if (r < nw)
          val = fmaf(red[r * W + j], exp2_approx(red[r * W] - M), val);
    }
    dst[j] = val;
  }
}

// One warp per (slot, head): the slot's live chunks, in chunk order. Lane
// j holds chunk c0 + j's (m, l) and weight for each pass of 32 chunks;
// the sums take them from it by shuffle, one chunk after the other, from
// acc values loaded kB chunks at a time (kPer of them a lane, D <= 32 *
// kPer), so a pass is a few round trips to memory, not one a chunk.
template <typename T, int kPer>
__global__ void __launch_bounds__(kMergeWarps * 32)
paged_merge_kernel(const float* __restrict__ part,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   int pairs, int H, int D, int splits) {
  constexpr int kB = 32 / kPer < 16 ? 32 / kPer : 16;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (pair >= pairs) return;
  const int len = lengths[pair / H];
  const int n = min((max(len, 0) + kChunkRows - 1) / kChunkRows, splits);
  const int W = D + 2;
  const float* p = part + (size_t)pair * splits * W;
  float m_mine = lane < n ? p[(size_t)lane * W] : kNegInf;
  float l_mine = lane < n ? p[(size_t)lane * W + 1] : 0.f;
  float M = m_mine;
  for (int c = lane + 32; c < n; c += 32) M = fmaxf(M, p[(size_t)c * W]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  float L = 0.f;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < n; c0 += 32) {
    if (c0 > 0) {
      const int mine = c0 + lane;
      m_mine = mine < n ? p[(size_t)mine * W] : kNegInf;
      l_mine = mine < n ? p[(size_t)mine * W + 1] : 0.f;
    }
    // Chunks past n hold m = -1e30, l = 0: weight 0.
    const float w_mine = exp2_approx(m_mine - M);
    const int cn = min(32, n - c0);
    for (int b0 = 0; b0 < cn; b0 += kB) {
      float a[kB][kPer];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const float* pc = p + (size_t)(c0 + b0 + b) * W + 2;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int d = lane + 32 * i;
          a[b][i] = b0 + b < cn && d < D ? pc[d] : 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const float w = __shfl_sync(0xffffffffu, w_mine, (b0 + b) & 31);
        const float lc = __shfl_sync(0xffffffffu, l_mine, (b0 + b) & 31);
        if (b0 + b < cn) {
          L = fmaf(lc, w, L);
#pragma unroll
          for (int i = 0; i < kPer; ++i) acc[i] = fmaf(a[b][i], w, acc[i]);
        }
      }
    }
  }
  // An idle lane (n == 0) has acc = 0 and L = 0: a zero row.
  const float den = fmaxf(L, 1e-30f);
  T* o = out + (size_t)pair * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane + 32 * i;
    if (d < D) o[d] = from_float<T>(acc[i] / den);
  }
}

template <typename T, int kEPV, int kLPR, int kVPL>
int launch_split(SplitArgs a, int S, cudaStream_t st) {
  using P = typename Packs<T, kEPV>::P;
  constexpr int kRegsPerPack = sizeof(P) >= 4 ? sizeof(P) / 4 : 1;
  constexpr int kU = kKVRegs / (2 * kVPL * kRegsPerPack) > 0
                         ? kKVRegs / (2 * kVPL * kRegsPerPack)
                         : 1;
  // The warps a chunk needs: its rows over the kU rows of each of a
  // warp's lane groups.
  constexpr int kGroupsPerWarp = 32 / kLPR;
  const int nw = std::max(1, std::min((kChunkRows + kU * kGroupsPerWarp - 1) /
                                          (kU * kGroupsPerWarp),
                                      kMaxThreads / 32));
  const int threads = nw * 32;
  const size_t smem =
      ((size_t)nw * (a.D + 2) + (kChunkRows - 1) / a.ps + 2) * sizeof(float);
  const dim3 grid(a.splits, a.H, S);
  paged_split_kernel<T, kEPV, kLPR, kVPL><<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(SplitArgs a, void* out, int S, cudaStream_t st) {
  constexpr int kE = 16 / sizeof(T);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
        reinterpret_cast<uintptr_t>(a.v)) & 15) == 0;
  int rc;
  if (aligned && (a.D * sizeof(T)) % 16 == 0) {
    const int nv = a.D / kE;  // 16-byte packs a row
    if (nv <= 4)
      rc = launch_split<T, kE, 4, 1>(a, S, st);
    else if (nv <= 8)
      rc = launch_split<T, kE, 8, 1>(a, S, st);
    else if (nv <= 16)
      rc = launch_split<T, kE, 16, 1>(a, S, st);
    else if (nv <= 32)
      rc = launch_split<T, kE, 32, 1>(a, S, st);
    else
      rc = launch_split<T, kE, 32, 2>(a, S, st);
  } else if (a.D <= 128) {
    rc = launch_split<T, 1, 32, 4>(a, S, st);
  } else {
    rc = launch_split<T, 1, 32, 8>(a, S, st);
  }
  if (rc != 0) return rc;
  const int pairs = S * a.H;
  const dim3 grid((pairs + kMergeWarps - 1) / kMergeWarps);
  const dim3 block(kMergeWarps * 32);
  T* o = static_cast<T*>(out);
  if (a.D <= 32)
    paged_merge_kernel<T, 1><<<grid, block, 0, st>>>(
        a.part, a.lengths, o, pairs, a.H, a.D, a.splits);
  else if (a.D <= 64)
    paged_merge_kernel<T, 2><<<grid, block, 0, st>>>(
        a.part, a.lengths, o, pairs, a.H, a.D, a.splits);
  else if (a.D <= 128)
    paged_merge_kernel<T, 4><<<grid, block, 0, st>>>(
        a.part, a.lengths, o, pairs, a.H, a.D, a.splits);
  else
    paged_merge_kernel<T, 8><<<grid, block, 0, st>>>(
        a.part, a.lengths, o, pairs, a.H, a.D, a.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Shapes (all contiguous):
//   q [S, H, D], k/v pages [P, ps, H, D], tables [S, pps] int32,
//   lengths [S] int32, out [S, H, D], scratch [S, H, splits, D + 2]
//   float32 with splits = ceil(pps * ps / kChunkRows) (the host's split
//   plan).
// Returns cudaGetLastError() after each launch (0 = launched); -1 for an
// argument these kernels do not take, a split plan made for another
// chunk size included.
extern "C" int hvd_paged_attention_decode(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* lengths, void* out, void* scratch, int S,
    int H, int D, int ps, int pps, int splits, float scale, void* stream) {
  if (S < 0 || S > 65535 || H <= 0 || H > 65535 || D <= 0 || D > kMaxD ||
      ps <= 0 || pps <= 0 ||
      splits != ((long long)ps * pps + kChunkRows - 1) / kChunkRows)
    return -1;
  if (S == 0) return 0;
  SplitArgs a{q, k_pages, v_pages, tables, lengths,
              static_cast<float*>(scratch), H, D, ps, pps, splits,
              scale * 1.4426950408889634f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, out, S, st);
  if (dtype == 1) return launch<bf16>(a, out, S, st);
  return -1;
}
