// Flash attention for Hopper (sm_90a): the forward (K1), the dQ backward
// (K2) and the dK/dV backward (K3) of horovod_tpu_torch.ops.attention.
//
// Replaces, in horovod_tpu/ops/attention.py:
//   K1 hvd_flash_fwd     <- _flash_kernel          (pallas_call :482, :495)
//   K2 hvd_flash_bwd_dq  <- _flash_bwd_dq_kernel   (pallas_call :800, :833)
//   K3 hvd_flash_bwd_dkv <- _flash_bwd_dkv_kernel  (pallas_call :814, :850)
//
// The TPU kernels walk a sequential grid axis (k-blocks for K1/K2,
// q-blocks for K3) and carry their sums in VMEM scratch from one grid
// step to the next; on the causal square shape a packed grid enumerates
// only the at-or-below-diagonal block pairs. Hopper runs blocks in no
// order, so the sequential axis is a loop inside the block:
//   * K1, K2: one block per (q tile, batch*head); it loops over the key
//     tiles up to the causal bound min(Lk, last_row + delta + 1), so a
//     dead tile is never loaded (the GPU form of the packed grid);
//   * K3: one block per (key tile, batch*head); it loops over the query
//     tiles from the first one whose rows reach the key tile (row q sees
//     key j when q + delta >= j), accumulates dK and dV in float32
//     registers and writes each exactly once: no atomics, deterministic.
// Tensors are read as [B, L, H, D] with the caller's (batch, seq, head)
// strides and a contiguous head dim; outputs are contiguous [B, L, H, D]
// and the statistics [B, H, Lq] float32. Tiles are 64 rows; a ragged last
// tile is masked in the kernel (rows past L load as zeros, columns past
// Lk score -1e30).
//
// Rounding points are those of the Pallas kernels: float32 scores and
// statistics; K1 rounds p to v's type before p.V and writes
// acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)); K2 rounds dS to
// k's type before dS.K and scales after the product; K3 rounds P^T to
// dO's type and dS^T to q's type. bf16 products are exact in float32, so
// float32 FMAs on the CUDA cores give the input-dtype matmul with float32
// accumulation of the TPU kernels.
//
// What bounds them on an H100: operations. At the training slice's shapes
// (B=8, H=12, L=2048, D=64, causal, bf16) K1 does 4*B*H*D*(causal pairs)
// = about 51.5 GFLOP on about 101 MB of q/k/v/out/lse; K2 about 77 GFLOP
// and K3 about 103 GFLOP: far above the card's flop/byte balance, so
// the least time is the operations over the bf16 tensor-core peak
// (chip_smoke.py computes the exact figures from the shapes). This first
// version is simple and right rather than fast: it runs float32 FMAs on
// the CUDA cores from shared-memory tiles (a 16 x 16 thread grid, each
// thread a 4 x 4 block of scores), not wgmma/TMA; that is the work of a
// later change, and PERF.md records how far it is from the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;                 // rows of a query tile and a key tile
constexpr int kTX = 16;                // threads along a tile's columns
constexpr int kTY = 16;                // threads along a tile's rows
constexpr int kThreads = kTX * kTY;
constexpr int kRI = kB / kTY;          // tile rows per thread
constexpr int kCJ = kB / kTX;          // tile columns per thread
constexpr int kSP = kB + 1;            // pitch of a [64][64] score tile
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

struct Geom {
  int B, H, Lq, Lk, D;
  long long qs[3], ks[3], vs[3], dos[3];  // (batch, seq, head) strides
  float scale;
  int causal, delta;                      // delta = q_offset - k_offset
};

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

// x rounded to T and back: the "astype" of the Pallas kernels.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + kB) of head (b, h) of a [B, L, H, D] tensor into a
// float tile [kB][kD + 1]; rows past L and columns past D are zeros.
template <typename T, int kD>
__device__ void load_tile(float* tile, const T* base, const long long* s,
                          int b, int h, int row0, int L, int D) {
  const T* p = base + b * s[0] + h * s[2];
  for (int idx = threadIdx.x; idx < kB * kD; idx += kThreads) {
    const int r = idx / kD;
    const int d = idx % kD;
    const int row = row0 + r;
    float x = 0.f;
    if (row < L && d < D) x = to_float(p[(long long)row * s[1] + d]);
    tile[r * (kD + 1) + d] = x;
  }
}

// Rows [row0, row0 + kB) of a [B*H, L] float32 statistic; zeros past L.
__device__ void load_row_stat(float* dst, const float* stat, int bh,
                              int row0, int L) {
  for (int r = threadIdx.x; r < kB; r += kThreads) {
    const int row = row0 + r;
    dst[r] = row < L ? stat[(long long)bh * L + row] : 0.f;
  }
}

// acc[i][j] += sum_d a[(ty + kTY*i)][d] * b[(tx + kTX*j)][d] over two
// [kB][kD + 1] tiles: a 4 x 4 block of a tile product A B^T.
template <int kD>
__device__ __forceinline__ void tile_abt(float (&acc)[kRI][kCJ],
                                         const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int kP = kD + 1;
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float av[kRI], bv[kCJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i) av[i] = a[(ty + kTY * i) * kP + d];
#pragma unroll
    for (int j = 0; j < kCJ; ++j) bv[j] = b[(tx + kTX * j) * kP + d];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c p[(ty + kTY*i)][c] * v[c][(tx + kTX*j)] for a score
// tile p [kB][kSP] and a value tile v [kB][kD + 1]: rows of P.V.
template <int kD>
__device__ __forceinline__ void tile_pv(float (&acc)[kRI][kD / kTX],
                                        const float* p, const float* v,
                                        int ty, int tx) {
  constexpr int kP = kD + 1;
  constexpr int kDJ = kD / kTX;
#pragma unroll 4
  for (int c = 0; c < kB; ++c) {
    float pv[kRI], vv[kDJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i) pv[i] = p[(ty + kTY * i) * kSP + c];
#pragma unroll
    for (int j = 0; j < kDJ; ++j) vv[j] = v[c * kP + tx + kTX * j];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kDJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
  }
}

// Writes rows [row0, row0 + kB) of a contiguous [B, L, H, D] output.
template <typename T, int kD>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&acc)[kRI][kD / kTX],
                                           const Geom& g, int b, int h,
                                           int row0, int L, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int row = row0 + ty + kTY * i;
    if (row >= L) continue;
    T* o = out + (((long long)b * L + row) * g.H + h) * g.D;
#pragma unroll
    for (int j = 0; j < kD / kTX; ++j) {
      const int d = tx + kTX * j;
      if (d < g.D) o[d] = from_float<T>(acc[i][j]);
    }
  }
}

// ------------------------------------------------------------------- K1

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Geom g) {
  constexpr int kP = kD + 1;
  constexpr int kDJ = kD / kTX;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kB * kP;
  float* sv = sk + kB * kP;
  float* sp = sv + kB * kP;                    // p rounded to v's type
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int h = bh % g.H;
  const int q0 = blockIdx.x * kB;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  load_tile<T, kD>(sq, q, g.qs, b, h, q0, g.Lq, g.D);
  const int q_last = min(q0 + kB, g.Lq) - 1;
  const int k_end = g.causal ? min(g.Lk, q_last + g.delta + 1) : g.Lk;

  float m[kRI], l[kRI], acc[kRI][kDJ];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();                           // the last tile is consumed
    load_tile<T, kD>(sk, k, g.ks, b, h, k0, g.Lk, g.D);
    load_tile<T, kD>(sv, v, g.vs, b, h, k0, g.Lk, g.D);
    __syncthreads();
    float s[kRI][kCJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) s[i][j] = 0.f;
    tile_abt<kD>(s, sq, sk, ty, tx);
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int row = q0 + ty + kTY * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int col = k0 + tx + kTX * j;
        const bool live = col < g.Lk && (!g.causal || row + g.delta >= col);
        s[i][j] = live ? s[i][j] * g.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // Column 0 of the first tile is live for every row (delta >= 0),
      // so m is finite from the first tile on and a masked score's
      // weight exp(-1e30 - m) is exactly 0.
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sp[(ty + kTY * i) * kSP + tx + kTX * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
#pragma unroll
      for (int j = 0; j < kDJ; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
    tile_pv<kD>(acc, sp, sv, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int row = q0 + ty + kTY * i;
    if (row >= g.Lq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* o = out + (((long long)b * g.Lq + row) * g.H + h) * g.D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      const int d = tx + kTX * j;
      if (d < g.D) o[d] = from_float<T>(acc[i][j] / lc);
    }
    if (tx == 0) lse[(long long)bh * g.Lq + row] = m[i] + logf(lc);
  }
}

// ------------------------------------------------------------------- K2

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, T* __restrict__ dq,
                    Geom g) {
  constexpr int kP = kD + 1;
  constexpr int kDJ = kD / kTX;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kB * kP;
  float* sk = sdo + kB * kP;
  float* sv = sk + kB * kP;
  float* sds = sv + kB * kP;                   // dS rounded to k's type
  float* slse = sds + kB * kSP;
  float* sdd = slse + kB;
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int h = bh % g.H;
  const int q0 = blockIdx.x * kB;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  load_tile<T, kD>(sq, q, g.qs, b, h, q0, g.Lq, g.D);
  load_tile<T, kD>(sdo, dout, g.dos, b, h, q0, g.Lq, g.D);
  load_row_stat(slse, lse, bh, q0, g.Lq);
  load_row_stat(sdd, dvec, bh, q0, g.Lq);
  const int q_last = min(q0 + kB, g.Lq) - 1;
  const int k_end = g.causal ? min(g.Lk, q_last + g.delta + 1) : g.Lk;

  float acc[kRI][kDJ];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();
    load_tile<T, kD>(sk, k, g.ks, b, h, k0, g.Lk, g.D);
    load_tile<T, kD>(sv, v, g.vs, b, h, k0, g.Lk, g.D);
    __syncthreads();
    float s[kRI][kCJ], dp[kRI][kCJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt<kD>(s, sq, sk, ty, tx);
    tile_abt<kD>(dp, sdo, sv, ty, tx);
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int r = ty + kTY * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int c = tx + kTX * j;
        const int col = k0 + c;
        const bool live = col < g.Lk && (!g.causal || row + g.delta >= col);
        const float x = live ? s[i][j] * g.scale : kNegInf;
        const float p = expf(x - slse[r]);
        sds[r * kSP + c] = round_to<T>(p * (dp[i][j] - sdd[r]));
      }
    }
    __syncthreads();
    float part[kRI][kDJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kDJ; ++j) part[i][j] = 0.f;
    tile_pv<kD>(part, sds, sk, ty, tx);
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kDJ; ++j) acc[i][j] += part[i][j] * g.scale;
  }
  store_rows<T, kD>(dq, acc, g, b, h, q0, g.Lq, ty, tx);
}

// ------------------------------------------------------------------- K3

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk,
                     T* __restrict__ dv, Geom g) {
  constexpr int kP = kD + 1;
  constexpr int kDJ = kD / kTX;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kB * kP;
  float* sq = sv + kB * kP;
  float* sdo = sq + kB * kP;
  float* spt = sdo + kB * kP;                  // P^T rounded to dO's type
  float* sdst = spt + kB * kSP;                // dS^T rounded to q's type
  float* slse = sdst + kB * kSP;
  float* sdd = slse + kB;
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int h = bh % g.H;
  const int k0 = blockIdx.x * kB;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  load_tile<T, kD>(sk, k, g.ks, b, h, k0, g.Lk, g.D);
  load_tile<T, kD>(sv, v, g.vs, b, h, k0, g.Lk, g.D);
  // The first query tile with a row that sees a key of this tile: row q
  // sees key j when q + delta >= j (the k-major start of the packed grid,
  // generalised for delta).
  const int q_begin = g.causal ? (max(0, k0 - g.delta) / kB) * kB : 0;

  float dka[kRI][kDJ], dva[kRI][kDJ];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int q0 = q_begin; q0 < g.Lq; q0 += kB) {
    __syncthreads();
    load_tile<T, kD>(sq, q, g.qs, b, h, q0, g.Lq, g.D);
    load_tile<T, kD>(sdo, dout, g.dos, b, h, q0, g.Lq, g.D);
    load_row_stat(slse, lse, bh, q0, g.Lq);
    load_row_stat(sdd, dvec, bh, q0, g.Lq);
    __syncthreads();
    // Transposed scores: thread rows are keys, thread columns queries.
    float st[kRI][kCJ], dpt[kRI][kCJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) st[i][j] = dpt[i][j] = 0.f;
    tile_abt<kD>(st, sk, sq, ty, tx);
    tile_abt<kD>(dpt, sv, sdo, ty, tx);
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int r = ty + kTY * i;
      const int col = k0 + r;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int c = tx + kTX * j;
        const int row = q0 + c;
        const bool live = row < g.Lq && col < g.Lk &&
                          (!g.causal || row + g.delta >= col);
        const float x = live ? st[i][j] * g.scale : kNegInf;
        const float p = expf(x - slse[c]);
        spt[r * kSP + c] = round_to<T>(p);
        sdst[r * kSP + c] = round_to<T>(p * (dpt[i][j] - sdd[c]));
      }
    }
    __syncthreads();
    float part[kRI][kDJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kDJ; ++j) part[i][j] = 0.f;
    tile_pv<kD>(dva, spt, sdo, ty, tx);
    tile_pv<kD>(part, sdst, sq, ty, tx);
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kDJ; ++j) dka[i][j] += part[i][j] * g.scale;
  }
  store_rows<T, kD>(dk, dka, g, b, h, k0, g.Lk, ty, tx);
  store_rows<T, kD>(dv, dva, g, b, h, k0, g.Lk, ty, tx);
}

// ---------------------------------------------------------------- launch

template <int kD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kB * (kD + 1) + kB * kSP);
}
template <int kD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kB * (kD + 1) + kB * kSP + 2 * kB);
}
template <int kD>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kB * (kD + 1) + 2 * kB * kSP + 2 * kB);
}

// Every instance asks for its dynamic shared memory (above the 48 KB
// default at kD = 64 and 128) before its launch.
template <typename K>
int prepare(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int kD>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, const Geom& g, cudaStream_t st) {
  auto kern = flash_fwd_kernel<T, kD>;
  const size_t smem = fwd_smem<kD>();
  if (int rc = prepare(kern, smem)) return rc;
  const dim3 grid((g.Lq + kB - 1) / kB, g.B * g.H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dvec, void* dq, const Geom& g,
              cudaStream_t st) {
  auto kern = flash_bwd_dq_kernel<T, kD>;
  const size_t smem = dq_smem<kD>();
  if (int rc = prepare(kern, smem)) return rc;
  const dim3 grid((g.Lq + kB - 1) / kB, g.B * g.H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dvec,
      static_cast<T*>(dq), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* dvec,
               void* dk, void* dv, const Geom& g, cudaStream_t st) {
  auto kern = flash_bwd_dkv_kernel<T, kD>;
  const size_t smem = dkv_smem<kD>();
  if (int rc = prepare(kern, smem)) return rc;
  const dim3 grid((g.Lk + kB - 1) / kB, g.B * g.H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dvec,
      static_cast<T*>(dk), static_cast<T*>(dv), g);
  return static_cast<int>(cudaGetLastError());
}

Geom make_geom(int B, int H, int Lq, int Lk, int D, const long long* qs,
               const long long* ks, const long long* vs,
               const long long* dos, float scale, int causal, int delta) {
  Geom g;
  g.B = B;
  g.H = H;
  g.Lq = Lq;
  g.Lk = Lk;
  g.D = D;
  for (int i = 0; i < 3; ++i) {
    g.qs[i] = qs[i];
    g.ks[i] = ks[i];
    g.vs[i] = vs[i];
    g.dos[i] = dos[i];
  }
  g.scale = scale;
  g.causal = causal;
  g.delta = delta;
  return g;
}

bool bad_geom(int dtype, int B, int H, int Lq, int Lk, int D, int causal,
              int delta) {
  return (dtype != 0 && dtype != 1) || B <= 0 || H <= 0 || Lq <= 0 ||
         Lk <= 0 || D <= 0 || D > kMaxD || B * H > 65535 ||
         (causal && delta < 0);
}

// Picks the head-dim instance (D <= 32, 64, 128) and the type.
#define HVD_DISPATCH(dtype, D, FN, ...)                                  \
  do {                                                                   \
    if ((dtype) == 0) {                                                  \
      if ((D) <= 32) return FN<float, 32>(__VA_ARGS__);                  \
      if ((D) <= 64) return FN<float, 64>(__VA_ARGS__);                  \
      return FN<float, 128>(__VA_ARGS__);                                \
    }                                                                    \
    if ((D) <= 32) return FN<__nv_bfloat16, 32>(__VA_ARGS__);            \
    if ((D) <= 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__);            \
    return FN<__nv_bfloat16, 128>(__VA_ARGS__);                          \
  } while (0)

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs alike).
// q/dO [B, Lq, H, D] and k/v [B, Lk, H, D] are read through their
// (batch, seq, head) strides with a contiguous head dim; out, dq, dk, dv
// are contiguous [B, L, H, D]; lse and dvec (rowsum(dO * O)) contiguous
// float32 [B, H, Lq]. delta = q_offset - k_offset (>= 0 when causal).
// Each returns cudaGetLastError() after its launch (0 = launched), or -1
// for an argument the kernels do not take.
extern "C" int hvd_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* out, void* lse, int B,
                             int H, int Lq, int Lk, int D, long long qsb,
                             long long qsl, long long qsh, long long ksb,
                             long long ksl, long long ksh, long long vsb,
                             long long vsl, long long vsh, float scale,
                             int causal, int delta, void* stream) {
  if (bad_geom(dtype, B, H, Lq, Lk, D, causal, delta)) return -1;
  const long long qs[3] = {qsb, qsl, qsh}, ks[3] = {ksb, ksl, ksh},
                  vs[3] = {vsb, vsl, vsh};
  const Geom g = make_geom(B, H, Lq, Lk, D, qs, ks, vs, qs, scale, causal,
                           delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  HVD_DISPATCH(dtype, D, launch_fwd, q, k, v, out, l, g, st);
}

extern "C" int hvd_flash_bwd_dq(
    int dtype, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* dvec, void* dq, int B,
    int H, int Lq, int Lk, int D, long long qsb, long long qsl,
    long long qsh, long long ksb, long long ksl, long long ksh,
    long long vsb, long long vsl, long long vsh, long long dsb,
    long long dsl, long long dsh, float scale, int causal, int delta,
    void* stream) {
  if (bad_geom(dtype, B, H, Lq, Lk, D, causal, delta)) return -1;
  const long long qs[3] = {qsb, qsl, qsh}, ks[3] = {ksb, ksl, ksh},
                  vs[3] = {vsb, vsl, vsh}, dos[3] = {dsb, dsl, dsh};
  const Geom g = make_geom(B, H, Lq, Lk, D, qs, ks, vs, dos, scale, causal,
                           delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(dvec);
  HVD_DISPATCH(dtype, D, launch_dq, q, k, v, dout, l, dd, dq, g, st);
}

extern "C" int hvd_flash_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* dvec, void* dk, void* dv,
    int B, int H, int Lq, int Lk, int D, long long qsb, long long qsl,
    long long qsh, long long ksb, long long ksl, long long ksh,
    long long vsb, long long vsl, long long vsh, long long dsb,
    long long dsl, long long dsh, float scale, int causal, int delta,
    void* stream) {
  if (bad_geom(dtype, B, H, Lq, Lk, D, causal, delta)) return -1;
  const long long qs[3] = {qsb, qsl, qsh}, ks[3] = {ksb, ksl, ksh},
                  vs[3] = {vsb, vsl, vsh}, dos[3] = {dsb, dsl, dsh};
  const Geom g = make_geom(B, H, Lq, Lk, D, qs, ks, vs, dos, scale, causal,
                           delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(dvec);
  HVD_DISPATCH(dtype, D, launch_dkv, q, k, v, dout, l, dd, dk, dv, g, st);
}
