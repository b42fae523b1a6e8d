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
// and the statistics [B, H, Lq] float32. Tiles are 64 rows (128 for the
// bf16 K3's key tile); a ragged last tile is masked in the kernel (rows
// past L load as zeros, columns past Lk score -1e30, or weigh 0).
//
// Rounding points are those of the Pallas kernels: float32 scores and
// statistics; K1 rounds p to v's type before p.V and writes
// acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)); K2 rounds dS to
// k's type before dS.K; K3 rounds P^T to dO's type and dS^T to q's type.
// Products of the input type accumulate in float32, as the TPU kernels'
// input-dtype matmuls do.
//
// What bounds them on an H100: operations. At the training slice's shapes
// (B=8, H=12, L=2048, D=64, causal, bf16) K1 does 4*B*H*D*(causal pairs)
// = about 51.5 GFLOP on about 101 MB of q/k/v/out/lse; K2 about 77 GFLOP
// and K3 about 103 GFLOP: far above the card's flop/byte balance, so
// the least time is the operations over the bf16 tensor-core peak
// (chip_smoke.py computes the exact figures from the shapes).
//
// In float32, K1-K3 run float32 FMAs on the CUDA cores from float
// shared-memory tiles (a 16 x 16 thread grid, each thread a 4 x 4 block
// of scores): simple and right, 45-50x from the bound (PERF.md). Tensor
// cores would need TF32 for float32, which the port's float32 policy
// rules out.
//
// In bf16, the training path, all three are built for the tensor cores
// (the Hopper helpers are in hopper.cuh):
//   * every product is a warpgroup MMA, wgmma m64n64k16 (bf16 in,
//     float32 accumulate): K1 S = Q K^T, O += P V; K2 S = Q K^T,
//     dP = dO V^T, dQ += dS K; K3 S^T = K Q^T, dP^T = V dO^T,
//     dV += P^T dO, dK += dS^T Q. A warpgroup owns 64 rows of the
//     resident tile (K1: two per block, 64 of its 128 query rows each;
//     K2: one per block, its 64 query rows; K3: two per block, 64 of its
//     128 keys each) and reads the streamed tile's B operand from shared
//     memory by descriptor, K-major for the score products and MN-major
//     (transposed) for the products into O, dQ, dK and dV;
//   * register reuse: P and dS are formed in float32 from the score
//     accumulators, rounded to bf16 and re-packed as the register A
//     operand of the next wgmma (a warp's accumulator layout is its A
//     fragment layout); no score tile is stored to shared memory. K1's
//     online softmax stays in registers: row maxima over the 4 threads of
//     a quad, exp2 of log2-scaled scores on the special-function unit,
//     each thread's share of the row sums reduced once at the end;
//   * a ring of bf16 tiles in shared memory, in the 128-byte swizzle of
//     the wgmma descriptors (the head dim zero-padded to 64 or 128), is
//     filled by cp.async 16-byte copies that overlap the products of the
//     tile before. K1 and K2 stream K/V tiles of 64 rows against a
//     resident Q tile (K2 also dO); K3 streams Q/dO stages of 64 rows
//     with their lse/D rows against a resident 128-row K/V tile. Rows
//     past L and columns past D are zero-filled by the copy itself; a D
//     that is not a multiple of 8 or rows that are not 16-byte aligned
//     take element loads into the same ring;
//   * only the diagonal tiles and the ragged last tile are masked; tiles
//     above the causal bound are never loaded, and K1's first warpgroup
//     skips the last tile of a causal block, which lies above all its
//     rows;
//   * the heaviest blocks launch first (K1, K2: the last query tiles, K3:
//     the first key tiles, on a 1-D tile-major grid), so the short blocks
//     fill the tail;
//   * no atomics: out/lse, dQ, dK and dV are written exactly once each,
//     and a second launch repeats every bit.
// At the slice shapes they run at a quarter to a third of the bound:
// each warpgroup waits on its products before the softmax (K1) or the dS
// arithmetic (K2, K3) of the same tile, and overlap comes only from the
// other warpgroups on the SM (2 K1 blocks at 128 registers, 4 K2 blocks,
// K3's two warpgroups at about 210). In K1 the softmax's arithmetic, not
// its exp2, is the largest part (tune_flash.py timings of K1 without
// the softmax, without the exp2 or without a product; PERF.md), so its
// row maxima and sums are trees. Issuing tile t+1's scores before tile
// t's softmax (two score register sets) costs K1 a block an SM and was
// slower; so were 64-row K1 blocks and deeper rings. A producer warp
// with TMA loads and consumer warpgroups in ping-pong is the next lever.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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
  int vec;        // bf16 K1-K3: 16-byte async copies (D % 8 == 0, aligned)
};

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
template <int kD>
__device__ void load_tile(float* tile, const float* base, const long long* s,
                          int b, int h, int row0, int L, int D) {
  const float* p = base + b * s[0] + h * s[2];
  for (int idx = threadIdx.x; idx < kB * kD; idx += kThreads) {
    const int r = idx / kD;
    const int d = idx % kD;
    const int row = row0 + r;
    float x = 0.f;
    if (row < L && d < D) x = p[(long long)row * s[1] + d];
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
template <int kD>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[kRI][kD / kTX],
                                           const Geom& g, int b, int h,
                                           int row0, int L, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int row = row0 + ty + kTY * i;
    if (row >= L) continue;
    float* o = out + (((long long)b * L + row) * g.H + h) * g.D;
#pragma unroll
    for (int j = 0; j < kD / kTX; ++j) {
      const int d = tx + kTX * j;
      if (d < g.D) o[d] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------------- K1

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, Geom g) {
  constexpr int kP = kD + 1;
  constexpr int kDJ = kD / kTX;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kB * kP;
  float* sv = sk + kB * kP;
  float* sp = sv + kB * kP;                    // p
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int h = bh % g.H;
  const int q0 = blockIdx.x * kB;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  load_tile<kD>(sq, q, g.qs, b, h, q0, g.Lq, g.D);
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
    load_tile<kD>(sk, k, g.ks, b, h, k0, g.Lk, g.D);
    load_tile<kD>(sv, v, g.vs, b, h, k0, g.Lk, g.D);
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
        sp[(ty + kTY * i) * kSP + tx + kTX * j] = p;
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
    float* o = out + (((long long)b * g.Lq + row) * g.H + h) * g.D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      const int d = tx + kTX * j;
      if (d < g.D) o[d] = acc[i][j] / lc;
    }
    if (tx == 0) lse[(long long)bh * g.Lq + row] = m[i] + logf(lc);
  }
}

// ------------------------------------------------------------------- K2

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, float* __restrict__ dq,
                    Geom g) {
  constexpr int kP = kD + 1;
  constexpr int kDJ = kD / kTX;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kB * kP;
  float* sk = sdo + kB * kP;
  float* sv = sk + kB * kP;
  float* sds = sv + kB * kP;                   // dS
  float* slse = sds + kB * kSP;
  float* sdd = slse + kB;
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int h = bh % g.H;
  const int q0 = blockIdx.x * kB;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  load_tile<kD>(sq, q, g.qs, b, h, q0, g.Lq, g.D);
  load_tile<kD>(sdo, dout, g.dos, b, h, q0, g.Lq, g.D);
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
    load_tile<kD>(sk, k, g.ks, b, h, k0, g.Lk, g.D);
    load_tile<kD>(sv, v, g.vs, b, h, k0, g.Lk, g.D);
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
        sds[r * kSP + c] = p * (dp[i][j] - sdd[r]);
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
  store_rows<kD>(dq, acc, g, b, h, q0, g.Lq, ty, tx);
}

// ------------------------------------------------------------------- K3

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, float* __restrict__ dk,
                     float* __restrict__ dv, Geom g) {
  constexpr int kP = kD + 1;
  constexpr int kDJ = kD / kTX;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kB * kP;
  float* sq = sv + kB * kP;
  float* sdo = sq + kB * kP;
  float* spt = sdo + kB * kP;                  // P^T
  float* sdst = spt + kB * kSP;                // dS^T
  float* slse = sdst + kB * kSP;
  float* sdd = slse + kB;
  const int bh = blockIdx.y;
  const int b = bh / g.H;
  const int h = bh % g.H;
  const int k0 = blockIdx.x * kB;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  load_tile<kD>(sk, k, g.ks, b, h, k0, g.Lk, g.D);
  load_tile<kD>(sv, v, g.vs, b, h, k0, g.Lk, g.D);
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
    load_tile<kD>(sq, q, g.qs, b, h, q0, g.Lq, g.D);
    load_tile<kD>(sdo, dout, g.dos, b, h, q0, g.Lq, g.D);
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
        spt[r * kSP + c] = p;
        sdst[r * kSP + c] = p * (dpt[i][j] - sdd[c]);
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
  store_rows<kD>(dk, dka, g, b, h, k0, g.Lk, ty, tx);
  store_rows<kD>(dv, dva, g, b, h, k0, g.Lk, ty, tx);
}

// ---------------------------------------- bf16 K1-K3 on the tensor cores
//
// A warpgroup (4 warps, 128 threads) computes each product of a 64-row
// slice with wgmma m64n64k16. The score products (S, dP; S^T, dP^T) read
// both operands from shared memory by descriptor, so a streamed tile is
// read once per warpgroup; the products into O, dQ, dK and dV take P /
// dS from registers as their A operand and the streamed or resident tile
// as an MN-major B operand. Tiles are bf16 [R][kD] in the 128-byte
// swizzle (hopper.cuh), the head dim zero-padded to 64 or 128. The
// streamed tiles go through a ring of kStages1 / kStages2 / kStages3
// buffers filled by cp.async 16-byte copies, one barrier a tile.

// Tiles, chosen on an H100 with tune_flash.py. 64 rows is a wgmma's row
// count. K1's two warpgroups share each K/V tile, at 2 blocks an SM
// (launch bounds cap it at 128 registers): faster than 64-row blocks at
// 4 an SM, which load each tile twice as often. K2 fits 4 blocks an SM,
// faster than 3 or 2: the kernels are latency-bound and the other blocks
// fill each one's waits. A third ring stage gains nothing (and costs K2
// a block an SM); K3's 128-row key tile is as fast as a 64-row one and
// loads each Q/dO stage once for twice the keys.
constexpr int kQ1 = 128;               // K1: query rows (2 warpgroups)
constexpr int kN1 = 64;                // K1: rows of a streamed K/V tile
constexpr int kT1 = 2 * kQ1;           // K1: threads, a warpgroup per 64 rows
constexpr int kStages1 = 2;            // K1: ring depth of the K/V tiles
constexpr int kQ2 = 64;                // K2: query rows (1 warpgroup)
constexpr int kN2 = 64;                // K2: rows of a streamed key tile
constexpr int kT2 = 128;               // K2: threads
constexpr int kStages2 = 2;            // K2: ring depth of the K/V tiles
constexpr int kK3 = 128;               // K3: key rows (2 warpgroups)
constexpr int kQS = 64;                // K3: query rows of a streamed stage
constexpr int kT3 = 256;               // K3: threads
constexpr int kStages3 = 2;            // K3: ring depth of the Q/dO stages
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Row row0 + i of a [B*H, L] float32 statistic into dst[i] by a 4-byte
// cp.async; zero past L.
__device__ __forceinline__ void load_stat_async(float* dst, const float* stat,
                                                int bh, int row0, int L,
                                                int i) {
  const float* p = stat + (long long)bh * L;
  const bool in = row0 + i < L;
  cp_async4(dst + i, in ? p + row0 + i : p, in ? 4 : 0);
}

// Writes the warp's 16 rows of a [16, kD] float32 accumulator (mma C
// layout) times `mul` as rows [row0, row0 + 16) of a contiguous
// [B, L, H, D] bf16 output.
template <int kD>
__device__ __forceinline__ void store_rows_tc(bf16* out,
                                              const float (&acc)[kD / 8][4],
                                              float mul, const Geom& g,
                                              int b, int h, int row0, int L,
                                              int lane) {
  const int gq = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + gq + 8 * i;
    if (row >= L) continue;
    bf16* o = out + (((long long)b * L + row) * g.H + h) * g.D;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int d = n * 8 + 2 * tq;
      const float x0 = acc[n][2 * i] * mul;
      const float x1 = acc[n][2 * i + 1] * mul;
      if ((g.D & 1) == 0 && d + 1 < g.D) {
        *reinterpret_cast<__nv_bfloat162*>(o + d) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < g.D) o[d] = __float2bfloat16_rn(x0);
        if (d + 1 < g.D) o[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// The warp's C fragments of a [16, 64] score slice -> the four A
// fragments of the next product, rounded to bf16 (the mma C and A
// layouts agree lane by lane).
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4],
                                           const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// s = A B^T over the head dim, issued (not waited for): A the
// warpgroup's 64 rows of a resident swizzled tile of RA rows (a points
// at its first row), B a streamed swizzled tile of 64 rows; both
// K-major, stepped 16 columns (32 bytes) at a time.
template <int kD, int RA>
__device__ __forceinline__ void score_tile(float (&s)[8][4], const bf16* a,
                                           const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int blk = kk >> 2;
    const int off = (kk & 3) * 16;
    wgmma_ss(s, sw128_desc(a + blk * RA * 64 + off, 0),
                sw128_desc(b + blk * 64 * 64 + off, 0));
  }
}

// acc (64 x kD) += A (64 x 64 from registers) B, issued (not waited
// for): B a swizzled [64][kD] tile read along its rows (MN-major), 16
// rows (2048 bytes) a step, one wgmma per 64-column block.
template <int kD>
__device__ __forceinline__ void acc_tile(float (&acc)[kD / 8][4],
                                         const uint32_t (&a)[4][4],
                                         const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < kD / 64; ++j)
      wgmma_rs(*reinterpret_cast<float(*)[8][4]>(&acc[8 * j]), a[kk],
                  sw128_desc(b + j * 64 * 64 + kk * 16 * 64, 64 * 128));
}

// The online softmax of one tile of the warpgroup's scores, in place: s
// (the warp's C fragments of a [16, 64] slice, raw q.k) becomes the
// unrounded p = 2^(s * sl2 - m2) against the rows' new running maxima m2
// (log2 units: the scale is positive, so the row maximum of s times sl2
// is that of the scaled scores), l (this thread's share of each row's
// sum) is rescaled and grows by the tile's p, and alpha is what the rows'
// accumulators must be multiplied by. With `mask`, a column at or past
// its row's limit `lim` (relative to the tile: past Lk or above the
// causal diagonal) gets p = 0 exactly.
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m2)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float sl2, bool mask,
                                             const int (&lim)[2], int tq) {
  if (mask) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n * 8 + 2 * tq + (e & 1) >= lim[e >> 1]) s[n][e] = kNegInf;
  }
  // Each row's 16 values of this thread are reduced as a tree (short
  // dependency chains), then over the 4 threads of the quad.
  float mx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) t[n] = fmaxf(s[n][2 * i], s[n][2 * i + 1]);
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int n = 0; n < w; ++n) t[n] = fmaxf(t[n], t[n + w]);
    mx[i] = fmaxf(t[0], __shfl_xor_sync(0xffffffffu, t[0], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  // Key 0 is live for every row (delta >= 0), so from the first tile on
  // each row's m2 is finite and a masked score's 2^(-1e30 sl2 - m2) is 0.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m2[i], mx[i] * sl2);
    alpha[i] = exp2_approx(m2[i] - m_new);
    m2[i] = m_new;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = exp2_approx(fmaf(s[n][e], sl2, -m2[e >> 1]));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) t[n] = s[n][2 * i] + s[n][2 * i + 1];
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int n = 0; n < w; ++n) t[n] += t[n + w];
    l[i] = fmaf(l[i], alpha[i], t[0]);
  }
}

// K1 on the tensor cores. One block (kQ1 / 64 warpgroups) per (query
// tile, batch*head), the heaviest query tiles (the last under a causal
// mask) first; Q resident, K/V tiles streamed up to the causal bound,
// each read by every warpgroup of the block. A warpgroup skips the key
// tiles past its own rows' bound (the last one of a causal block for its
// first warpgroup).
template <int kD>
__global__ void __launch_bounds__(kT1, (kD > 64 ? 256 : 512) / kT1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, Geom g) {
  constexpr int kTile = kN1 * kD;              // elements of a K or V tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sq = smem_base(tc_smem);
  bf16* ring = sq + kQ1 * kD;                  // kStages1 x (K tile, V tile)
  const int BH = g.B * g.H;
  const int n_qt = (g.Lq + kQ1 - 1) / kQ1;
  const int bh = blockIdx.x % BH;
  const int b = bh / g.H;
  const int h = bh % g.H;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * kQ1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int q_last = min(q0 + kQ1, g.Lq) - 1;
  const int k_end = g.causal ? min(g.Lk, q_last + g.delta + 1) : g.Lk;
  const int nt = (k_end + kN1 - 1) / kN1;
  // The warpgroup's 64 rows and the key tiles they see.
  const int wg_lo = q0 + (warp >> 2) * 64;
  const int wg_end = g.causal ? min(k_end, wg_lo + 63 + g.delta + 1) : k_end;
  const int nt_wg = (wg_end + kN1 - 1) / kN1;
  const bf16* wq = sq + (warp >> 2) * 64 * 64;
  const bool vec = g.vec;

  auto load_kv = [&](int t) {
    bf16* dst = ring + (t % kStages1) * 2 * kTile;
    load_tile_bf16<kN1, kD, kT1>(dst, k, g.ks, b, h, t * kN1, g.Lk, g.D, vec);
    load_tile_bf16<kN1, kD, kT1>(dst + kTile, v, g.vs, b, h, t * kN1, g.Lk,
                                 g.D, vec);
  };
  load_tile_bf16<kQ1, kD, kT1>(sq, q, g.qs, b, h, q0, g.Lq, g.D, vec);
#pragma unroll
  for (int t = 0; t < kStages1 - 1; ++t) {
    if (t < nt) load_kv(t);
    cp_async_commit();
  }

  const float sl2 = g.scale * kLog2e;
  const int row_lo = q0 + warp * 16;           // the warp's first row
  // Each of this thread's two rows sees the keys below its limit.
  int row_end[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    row_end[i] = g.causal ? min(g.Lk, row_lo + gq + 8 * i + g.delta + 1)
                          : g.Lk;
  float m2[2] = {kNegInf, kNegInf};           // row maxima, log2 units
  float l[2] = {0.f, 0.f};                    // this thread's row sums
  float alpha[2];
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages1 - 2>();             // tile t has landed
    fence_proxy_async();
    __syncthreads();                           // ... for every thread, and
    if (t + kStages1 - 1 < nt) load_kv(t + kStages1 - 1);  // t-1 is free
    cp_async_commit();
    if (t >= nt_wg) continue;                  // warpgroup-uniform
    const bf16* sk = ring + (t % kStages1) * 2 * kTile;
    const bf16* sv = sk + kTile;
    const int k0 = t * kN1;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    fence_regs(s);
    wgmma_fence();
    score_tile<kD, kQ1>(s, wq, sk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    // Only the ragged last tile and the tiles that reach above the
    // diagonal of the warp's first row hold masked scores.
    const bool edge = k0 + kN1 > g.Lk ||
                      (g.causal && k0 + kN1 - 1 > row_lo + g.delta);
    const int lim[2] = {row_end[0] - k0, row_end[1] - k0};
    softmax_tile(s, m2, l, alpha, sl2, edge, lim, tq);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    uint32_t pa[4][4];                         // p rounded to v's type
    to_a_frags(pa, s);
    fence_regs(acc);
    wgmma_fence();
    acc_tile<kD>(acc, pa, sv);
    wgmma_commit();
    wgmma_wait_all();                          // before the tile is reused
    fence_regs(acc);
  }
  cp_async_wait<0>();

  // out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)) in natural
  // units, from the row sums of the 4 threads of a quad.
  float lc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lc[i] = fmaxf(l[i], 1e-30f);
    const int row = row_lo + gq + 8 * i;
    if (tq == 0 && row < g.Lq)
      lse[(long long)bh * g.Lq + row] = m2[i] * kLn2 + logf(lc[i]);
  }
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = acc[n][e] / lc[e >> 1];
  store_rows_tc<kD>(out, acc, 1.f, g, b, h, row_lo, g.Lq, lane);
}

// K2 on the tensor cores. One block (one warpgroup) per (64-row query
// tile, batch*head), the heaviest query tiles (the last under a causal
// mask) first; Q and dO resident, K/V tiles streamed up to the causal
// bound.
template <int kD>
__global__ void __launch_bounds__(kT2, kD > 64 ? 2 : 4)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dvec, bf16* __restrict__ dq,
                       Geom g) {
  constexpr int kTile = 64 * kD;               // elements of a 64-row tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sq = smem_base(tc_smem);
  bf16* sdo = sq + kTile;
  bf16* ring = sdo + kTile;                    // kStages2 x (K tile, V tile)
  const int BH = g.B * g.H;
  const int n_qt = (g.Lq + kQ2 - 1) / kQ2;
  const int bh = blockIdx.x % BH;
  const int b = bh / g.H;
  const int h = bh % g.H;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * kQ2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int q_last = min(q0 + kQ2, g.Lq) - 1;
  const int k_end = g.causal ? min(g.Lk, q_last + g.delta + 1) : g.Lk;
  const int nt = (k_end + kN2 - 1) / kN2;
  const bool vec = g.vec;

  auto load_kv = [&](int t) {
    bf16* dst = ring + (t % kStages2) * 2 * kTile;
    load_tile_bf16<kN2, kD, kT2>(dst, k, g.ks, b, h, t * kN2, g.Lk, g.D, vec);
    load_tile_bf16<kN2, kD, kT2>(dst + kTile, v, g.vs, b, h, t * kN2, g.Lk,
                                 g.D, vec);
  };
  load_tile_bf16<kQ2, kD, kT2>(sq, q, g.qs, b, h, q0, g.Lq, g.D, vec);
  load_tile_bf16<kQ2, kD, kT2>(sdo, dout, g.dos, b, h, q0, g.Lq, g.D, vec);
#pragma unroll
  for (int t = 0; t < kStages2 - 1; ++t) {
    if (t < nt) load_kv(t);
    cp_async_commit();
  }

  // This thread's two rows (gq and gq + 8 of the warp's 16): log2-scaled
  // lse and D, read once.
  float lse2[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + gq + 8 * i;
    const long long o = (long long)bh * g.Lq + row;
    lse2[i] = row < g.Lq ? lse[o] * kLog2e : 0.f;
    drow[i] = row < g.Lq ? dvec[o] : 0.f;
  }
  const float sl2 = g.scale * kLog2e;
  const int row_lo = q0 + warp * 16;           // the warp's first row

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages2 - 2>();             // tile t has landed
    fence_proxy_async();
    __syncthreads();                           // ... for every thread, and
    if (t + kStages2 - 1 < nt) load_kv(t + kStages2 - 1);  // t-1 is free
    cp_async_commit();
    const bf16* sk = ring + (t % kStages2) * 2 * kTile;
    const bf16* sv = sk + kTile;
    const int k0 = t * kN2;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    score_tile<kD, kQ2>(s, sq, sk);
    score_tile<kD, kQ2>(dp, sdo, sv);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // Only the diagonal tile and the ragged last one hold masked scores.
    const bool edge = k0 + kN2 > g.Lk ||
                      (g.causal && k0 + kN2 - 1 > row_lo + g.delta);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2_approx(fmaf(s[n][e], sl2, -lse2[i]));
        if (edge) {
          const int row = row_lo + gq + 8 * i;
          const int col = k0 + n * 8 + 2 * tq + (e & 1);
          if (col >= g.Lk || (g.causal && row + g.delta < col)) p = 0.f;
        }
        s[n][e] = p * (dp[n][e] - drow[i]);    // dS
      }
    uint32_t ds[4][4];                         // dS rounded to k's type
    to_a_frags(ds, s);
    fence_regs(acc);
    wgmma_fence();
    acc_tile<kD>(acc, ds, sk);
    wgmma_commit();
    wgmma_wait_all();                          // before the tile is reused
    fence_regs(acc);
  }
  cp_async_wait<0>();
  store_rows_tc<kD>(dq, acc, g.scale, g, b, h, row_lo, g.Lq, lane);
}

// K3 on the tensor cores. One block (two warpgroups) per (128-row key
// tile, batch*head), the heaviest key tiles (the first under a causal
// mask) first; K and V resident, Q/dO stages and their lse/D rows
// streamed from the first query row that sees the tile.
template <int kD>
__global__ void __launch_bounds__(kT3, 1)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, Geom g) {
  constexpr int kStage = 2 * kQS * kD;          // Q and dO of one stage
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sk = smem_base(tc_smem);
  bf16* sv = sk + kK3 * kD;
  bf16* ring = sv + kK3 * kD;                   // kStages3 x (Q, dO)
  float* stats = reinterpret_cast<float*>(ring + kStages3 * kStage);
  const int BH = g.B * g.H;
  const int bh = blockIdx.x % BH;
  const int b = bh / g.H;
  const int h = bh % g.H;
  const int k0 = (blockIdx.x / BH) * kK3;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  // Row q sees key j when q + delta >= j: the first stage holding a row
  // that sees key k0 (the k-major start of the packed grid).
  const int q_begin = g.causal ? (max(0, k0 - g.delta) / kQS) * kQS : 0;
  const int nt = q_begin < g.Lq ? (g.Lq - q_begin + kQS - 1) / kQS : 0;
  const bool vec = g.vec;

  auto load_q = [&](int t) {
    const int q0 = q_begin + t * kQS;
    bf16* dst = ring + (t % kStages3) * kStage;
    float* st = stats + (t % kStages3) * 2 * kQS;
    load_tile_bf16<kQS, kD, kT3>(dst, q, g.qs, b, h, q0, g.Lq, g.D, vec);
    load_tile_bf16<kQS, kD, kT3>(dst + kQS * kD, dout, g.dos, b, h, q0,
                                 g.Lq, g.D, vec);
    const int i = threadIdx.x;                 // kT3 >= 2 * kQS threads
    if (i < kQS)
      load_stat_async(st, lse, bh, q0, g.Lq, i);
    else if (i < 2 * kQS)
      load_stat_async(st + kQS, dvec, bh, q0, g.Lq, i - kQS);
  };
  load_tile_bf16<kK3, kD, kT3>(sk, k, g.ks, b, h, k0, g.Lk, g.D, vec);
  load_tile_bf16<kK3, kD, kT3>(sv, v, g.vs, b, h, k0, g.Lk, g.D, vec);
#pragma unroll
  for (int t = 0; t < kStages3 - 1; ++t) {
    if (t < nt) load_q(t);
    cp_async_commit();
  }

  const float sl2 = g.scale * kLog2e;
  const int key_lo = k0 + warp * 16;            // the warp's first key
  // The warpgroup's 64 keys: rows 64 * (warp / 4) on of the K/V tiles.
  const bf16* wk = sk + (warp >> 2) * 64 * 64;
  const bf16* wv = sv + (warp >> 2) * 64 * 64;
  float dka[kD / 8][4], dva[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages3 - 2>();
    fence_proxy_async();
    __syncthreads();
    if (t + kStages3 - 1 < nt) load_q(t + kStages3 - 1);
    cp_async_commit();
    const bf16* sq = ring + (t % kStages3) * kStage;
    const bf16* sdo = sq + kQS * kD;
    const float* slse = stats + (t % kStages3) * 2 * kQS;
    const float* sdd = slse + kQS;
    const int q0 = q_begin + t * kQS;

    // Transposed scores: the warpgroup's 64 keys x the stage's queries.
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    score_tile<kD, kK3>(st, wk, sq);
    score_tile<kD, kK3>(dpt, wv, sdo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    const bool edge = q0 + kQS > g.Lq || key_lo + 16 > g.Lk ||
                      (g.causal && q0 + g.delta < key_lo + 15);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(slse + n * 8 + 2 * tq);
      const float2 d2 = *reinterpret_cast<const float2*>(sdd + n * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? l2.y : l2.x;
        const float dr = (e & 1) ? d2.y : d2.x;
        float p = exp2_approx(fmaf(st[n][e], sl2, -lq * kLog2e));
        if (edge) {
          const int row = q0 + n * 8 + 2 * tq + (e & 1);
          const int col = key_lo + gq + 8 * (e >> 1);
          if (row >= g.Lq || col >= g.Lk || (g.causal && row + g.delta < col))
            p = 0.f;
        }
        dpt[n][e] = p * (dpt[n][e] - dr);      // dS^T
        st[n][e] = p;                          // P^T
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    to_a_frags(pa, st);                        // P^T rounded to dO's type
    to_a_frags(dsa, dpt);                      // dS^T rounded to q's type
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
    acc_tile<kD>(dva, pa, sdo);
    acc_tile<kD>(dka, dsa, sq);
    wgmma_commit();
    wgmma_wait_all();                          // before the stage is reused
    fence_regs(dva);
    fence_regs(dka);
  }
  cp_async_wait<0>();                          // (nt = 0: K/V still land)
  store_rows_tc<kD>(dk, dka, g.scale, g, b, h, key_lo, g.Lk, lane);
  store_rows_tc<kD>(dv, dva, 1.f, g, b, h, key_lo, g.Lk, lane);
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


// Shared memory of the bf16 kernels, with 1 KB of slack to align the
// swizzled tiles to 1024 bytes.
template <int kD>
constexpr size_t fwd_tc_smem() {
  return sizeof(bf16) * (kQ1 + kStages1 * 2 * kN1) * kD + 1024;
}
template <int kD>
constexpr size_t dq_tc_smem() {
  return sizeof(bf16) * (2 * kQ2 + kStages2 * 2 * kN2) * kD + 1024;
}
template <int kD>
constexpr size_t dkv_tc_smem() {
  return sizeof(bf16) * (2 * kK3 + kStages3 * 2 * kQS) * kD +
         sizeof(float) * kStages3 * 2 * kQS + 1024;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The bf16 kernels' geometry: 16-byte copies when every row of q, k, v
// and dO starts on a 16-byte boundary and D fills whole chunks.
Geom tc_geom(Geom g, const void* q, const void* k, const void* v,
             const void* dout) {
  bool vec = g.D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
             aligned16(dout);
  for (int i = 0; i < 3; ++i)
    vec = vec && g.qs[i] % 8 == 0 && g.ks[i] % 8 == 0 && g.vs[i] % 8 == 0 &&
          g.dos[i] % 8 == 0;
  g.vec = vec;
  return g;
}

// One block per (tile, batch*head) on a 1-D grid, tile-major.
int tc_blocks(const Geom& g, int L, int rows, unsigned* blocks) {
  const long long n = (long long)((L + rows - 1) / rows) * g.B * g.H;
  if (n > 0x7fffffffLL) return -1;
  *blocks = static_cast<unsigned>(n);
  return 0;
}

template <int kD>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* out,
                  float* lse, const Geom& g0, cudaStream_t st) {
  auto kern = flash_fwd_tc_kernel<kD>;
  const size_t smem = fwd_tc_smem<kD>();
  static SmemSet smem_set;
  if (int rc = set_smem_once(kern, smem, smem_set)) return rc;
  unsigned blocks;
  if (tc_blocks(g0, g0.Lq, kQ1, &blocks)) return -1;
  const Geom g = tc_geom(g0, q, k, v, q);
  kern<<<blocks, kT1, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, g);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* dvec,
                 void* dq, const Geom& g0, cudaStream_t st) {
  auto kern = flash_bwd_dq_tc_kernel<kD>;
  const size_t smem = dq_tc_smem<kD>();
  static SmemSet smem_set;
  if (int rc = set_smem_once(kern, smem, smem_set)) return rc;
  unsigned blocks;
  if (tc_blocks(g0, g0.Lq, kQ2, &blocks)) return -1;
  const Geom g = tc_geom(g0, q, k, v, dout);
  kern<<<blocks, kT2, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dvec,
      static_cast<bf16*>(dq), g);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* dvec,
                  void* dk, void* dv, const Geom& g0, cudaStream_t st) {
  auto kern = flash_bwd_dkv_tc_kernel<kD>;
  const size_t smem = dkv_tc_smem<kD>();
  static SmemSet smem_set;
  if (int rc = set_smem_once(kern, smem, smem_set)) return rc;
  unsigned blocks;
  if (tc_blocks(g0, g0.Lk, kK3, &blocks)) return -1;
  const Geom g = tc_geom(g0, q, k, v, dout);
  kern<<<blocks, kT3, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dvec,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), g);
  return static_cast<int>(cudaGetLastError());
}

// bf16 runs the tensor-core kernels; float32 the CUDA-core ones (tensor
// cores would need TF32, which the port's float32 policy rules out).
template <typename T, int kD>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, const Geom& g, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_fwd_tc<(kD < 64 ? 64 : kD)>(q, k, v, out, lse, g, st);
  } else {
    auto kern = flash_fwd_kernel<kD>;
    const size_t smem = fwd_smem<kD>();
    static SmemSet smem_set;
    if (int rc = set_smem_once(kern, smem, smem_set)) return rc;
    const dim3 grid((g.Lq + kB - 1) / kB, g.B * g.H);
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, g);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dvec, void* dq, const Geom& g,
              cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_dq_tc<(kD < 64 ? 64 : kD)>(q, k, v, dout, lse, dvec, dq, g,
                                             st);
  } else {
    auto kern = flash_bwd_dq_kernel<kD>;
    const size_t smem = dq_smem<kD>();
    static SmemSet smem_set;
    if (int rc = set_smem_once(kern, smem, smem_set)) return rc;
    const dim3 grid((g.Lq + kB - 1) / kB, g.B * g.H);
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        dvec,
        static_cast<float*>(dq), g);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int kD>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* dvec,
               void* dk, void* dv, const Geom& g, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_dkv_tc<(kD < 64 ? 64 : kD)>(q, k, v, dout, lse, dvec, dk,
                                              dv, g, st);
  } else {
    auto kern = flash_bwd_dkv_kernel<kD>;
    const size_t smem = dkv_smem<kD>();
    static SmemSet smem_set;
    if (int rc = set_smem_once(kern, smem, smem_set)) return rc;
    const dim3 grid((g.Lk + kB - 1) / kB, g.B * g.H);
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        dvec,
        static_cast<float*>(dk), static_cast<float*>(dv), g);
    return static_cast<int>(cudaGetLastError());
  }
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
  g.vec = 0;
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
