// Fused 1x1-conv (matmul) + BatchNorm statistics for Hopper (sm_90a):
// kernel K5 of horovod_tpu_torch.ops.conv_bn.
//
// Replaces horovod_tpu/ops/conv_bn.py:77 _make_kernel (its `kernel`
// closure, pallas_call at :202): y = h @ w with h = x, or, with the
// prologue, h = relu(x*a + b); y is written in x's type and the
// per-channel s1 = sum_rows(float32(y)), s2 = sum_rows(float32(y)^2) are
// taken over the ROUNDED y, so the fused and unfused BatchNorm see the
// same moments.
//
// The TPU kernel keeps the whole [K, N] weight in VMEM and carries s1/s2
// in a resident accumulator across a sequential grid over M tiles.
// Hopper runs blocks in no order, so here:
//   * the output is tiled over (M tile, N tile) blocks, each looping over
//     K in slices; the weight streams through shared memory with x, there
//     is no VMEM-style budget;
//   * each block writes the float32 column sums of its valid rows into a
//     [num_m_tiles, N] scratch (the wrapper allocates it), and a second
//     small kernel sums those partials over the M tiles in a fixed order:
//     no atomics, so y, s1 and s2 repeat bit for bit;
//   * rows past M are masked in the kernel (not padded in device memory);
//     with the prologue a masked row stays zero AFTER the affine, since
//     relu(0*a + b) = relu(b) is not zero and would poison the statistics
//     (conv_bn.py:103-108);
//   * x is read as [B, H, W, K] rows through the view's (b, h, w) strides
//     with a contiguous channel, so the stride-2 projection's input
//     x[:, ::2, ::2, :] is read in place, without a copy; a plain [M, K]
//     matrix is the case H = W = 1.
// The weight comes as wt [N, K] with K contiguous (the transpose of the
// JAX [K, N] kernel, which is exactly PyTorch's OIHW 1x1 weight viewed as
// [Cout, Cin]): the K-major B operand of a wgmma as it stands.
//
// Rounding points are those of the Pallas kernel: products accumulate in
// float32 and y is rounded once to x's type; the prologue's affine runs in
// the storage type (x*a rounded, then +b rounded, then the ReLU), with a
// and b already cast to x's type by the wrapper (conv_bn.py:102, :179).
//
// bfloat16 (the ResNet lane) runs on the tensor cores (hopper.cuh): a
// block is a 128-row M tile of two warpgroups (64 rows each) by 64 (N <=
// 64) or kWideN columns, two blocks an SM; K goes in 64-deep slices, each
// x and w slice a 128-byte-swizzled tile filled by cp.async 16-byte
// copies through a kStages-deep ring (rows past M, rows past N and
// channels past K zero-filled by the copy; element loads where K or a
// stride is not a multiple of 8); the prologue is applied to the landed x
// slice in shared memory by the threads that copied it; each warpgroup
// multiplies its 64 rows by the w slice with wgmma m64nBNk16, both
// operands from shared memory. The epilogue rounds y to bf16 into a
// staging tile in the freed ring, then each thread stores 16-byte chunks
// of one column of chunks and sums their values and squares, and the row
// groups' sums are added in order. float32 runs float32 FMAs on the CUDA
// cores (64 x 64 tiles, 4 x 4 outputs a thread).
//
// What bounds it on an H100: bytes. At ResNet-50's 1x1 shapes (batch 64,
// 224^2, bf16) a training step's 36 launches move about 2.1 GB (x and w
// read once, y written once) against about 0.27 TFLOP, below the card's
// 295 flop/byte balance, so the least time is the bytes over the HBM
// rate (chip_smoke.py computes it from the shapes); the last stage's
// small-M, large-K shapes are bound by operations instead. The design
// keeps the statistics pass out of device memory, which is the point of
// the fusion.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Args {
  const void* x;     // [B, H, W, K] rows via (sb, sh, sw), channel stride 1
  const void* a;     // [K] prologue scale in x's type, or null
  const void* b;     // [K] prologue shift in x's type, or null
  const void* wt;    // [N, K] contiguous
  void* y;           // [M, N] contiguous, x's type
  float* p1;         // [num_m_tiles, N] partial sums of y
  float* p2;         // [num_m_tiles, N] partial sums of y^2
  int M, K, N, H, W;
  long long sb, sh, sw;
  int prologue, vec;
  int yvec;           // 16-byte y stores: N % 8 == 0, y aligned
};

// Element offset of row r of x (rows are (b, h, w) in order).
__device__ __forceinline__ long long row_offset(const Args& g, int r) {
  const int hw = g.H * g.W;
  const int bi = r / hw;
  const int rem = r - bi * hw;
  const int hi = rem / g.W;
  const int wi = rem - hi * g.W;
  return bi * g.sb + hi * g.sh + wi * g.sw;
}

// ------------------------------------------------------------ bfloat16

constexpr int kBM = 128;           // rows of an M tile: 2 warpgroups of 64
constexpr int kBK = 64;            // K depth of a slice: one 128-byte row
constexpr int kThreads = 256;
constexpr int kStages = 3;         // ring depth of the (x, w) slices
constexpr int kWideN = 128;        // a tile's columns when N > 64

// Channels [k, k + 8) of one row of x or wt into a 16-byte chunk of a
// swizzled tile: a cp.async that zero-fills a row off the matrix or a
// chunk past K (vec: K % 8 == 0 and 16-byte aligned rows), else element
// loads with zeros past K, stored at once.
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src,
                                           const bf16* base, bool row_in,
                                           int k, int K, bool vec) {
  if (vec) {
    const bool in = row_in && k < K;
    cp_async16(dst, in ? src : base, in ? 16 : 0);
  } else {
    Chunk8 c;
    c.u = make_uint4(0, 0, 0, 0);
    if (row_in) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (k + j < K) c.h[j] = src[j];
    }
    *reinterpret_cast<uint4*>(dst) = c.u;
  }
}

// The ring holds kStages (x slice [kBM][kBK], w slice [BN][kBK]) pairs;
// after the K loop it becomes the y staging tile [kBM][BN + 8] and the
// row groups' column sums [2][kThreads * 8 / BN][BN]. 1 KB of slack
// aligns it to 1024 bytes.
template <int BN>
constexpr size_t bf16_smem() {
  constexpr size_t ring = sizeof(bf16) * kStages * (kBM + BN) * kBK;
  constexpr size_t epi = sizeof(bf16) * kBM * (BN + 8) +
                         sizeof(float) * 2 * kThreads * 8;
  return (ring > epi ? ring : epi) + 1024;
}

// One block per (128-row M tile, BN-column N tile), N tiles fastest so
// that neighbouring blocks read the same x rows from L2; two blocks an
// SM, so that one block's epilogue runs beside the other's loads and
// products. Every thread copies 16-byte chunks of the x and w slices
// into the ring (one cp.async group a slice, kStages - 1 slices ahead),
// applies the prologue to its own x chunks once they land (rows off the
// matrix stay zero), and each warpgroup multiplies its 64 rows by the
// whole w slice: four wgmma m64nBNk16, both operands K-major from the
// 128-byte-swizzled slices.
template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
conv_bn_bf16_kernel(Args g) {
  constexpr int kXS = kBM * kBK;           // elements of an x slice
  constexpr int kStage = (kBM + BN) * kBK;  // an x slice, then a w slice
  constexpr int kYP = BN + 8;              // pitch of the y staging tile
  extern __shared__ __align__(16) unsigned char conv_smem[];
  bf16* ring = smem_base(conv_smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int n_tiles = (g.N + BN - 1) / BN;
  const int mt = blockIdx.x / n_tiles;
  const int m0 = mt * kBM;
  const int n0 = blockIdx.x % n_tiles * BN;
  const int nk = (g.K + kBK - 1) / kBK;
  const bf16* x = static_cast<const bf16*>(g.x);
  const bf16* wt = static_cast<const bf16*>(g.wt);

  // This thread's chunks: channels [kc, kc + 8) of a slice, of the x rows
  // and w rows crow + 32 i of the tile.
  const int crow = tid >> 3;
  const int kc = (tid & 7) * 8;
  long long xoff[4];
  bool xin[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + crow + 32 * i;
    xin[i] = r < g.M;
    xoff[i] = xin[i] ? row_offset(g, r) : 0;
  }
  auto load_slice = [&](int t) {
    bf16* xs = ring + (t % kStages) * kStage;
    const int k = t * kBK + kc;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      copy_chunk(xs + sw_offset<kBM>(crow + 32 * i, kc), x + xoff[i] + k, x,
                 xin[i], k, g.K, g.vec);
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int n = n0 + crow + 32 * i;
      copy_chunk(xs + kXS + sw_offset<BN>(crow + 32 * i, kc),
                 wt + (long long)n * g.K + k, wt, n < g.N, k, g.K, g.vec);
    }
  };

  // The prologue on this thread's x chunks of slice t in place, after its
  // copies landed. Rows off the matrix and channels past K keep their
  // zeros: relu(0*a + b) = relu(b) would poison the statistics. x*a is
  // exact in float32, so the bf16x2 multiply rounds it once, as the
  // float32 product rounded to bf16 does.
  auto prologue = [&](int t) {
    const int k = t * kBK + kc;
    if (k >= g.K) return;
    const bf16* a = static_cast<const bf16*>(g.a);
    const bf16* b = static_cast<const bf16*>(g.b);
    Chunk8 ac, bc;
    if (g.vec) {
      ac.u = *reinterpret_cast<const uint4*>(a + k);
      bc.u = *reinterpret_cast<const uint4*>(b + k);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = k + j < g.K;
        ac.h[j] = in ? a[k + j] : __float2bfloat16_rn(0.f);
        bc.h[j] = in ? b[k + j] : __float2bfloat16_rn(0.f);
      }
    }
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    bf16* xs = ring + (t % kStages) * kStage;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!xin[i]) continue;
      uint4* p = reinterpret_cast<uint4*>(xs + sw_offset<kBM>(crow + 32 * i,
                                                              kc));
      Chunk8 c;
      c.u = *p;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 xa = __hmul2(
            *reinterpret_cast<const __nv_bfloat162*>(&c.h[2 * j]),
            *reinterpret_cast<const __nv_bfloat162*>(&ac.h[2 * j]));
        const float2 f = __bfloat1622float2(xa);
        const float2 fb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&bc.h[2 * j]));
        __nv_bfloat162 r = __floats2bfloat162_rn(__fadd_rn(f.x, fb.x),
                                                 __fadd_rn(f.y, fb.y));
        r = __hmax2(r, zero);
        // Channels past K (the ragged last chunk) stay zero.
        if (k + 2 * j >= g.K) r.x = zero.x;
        if (k + 2 * j + 1 >= g.K) r.y = zero.y;
        *reinterpret_cast<__nv_bfloat162*>(&c.h[2 * j]) = r;
      }
      *p = c.u;
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) load_slice(t);
    cp_async_commit();
  }
  float acc[BN / 8][4];
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();              // slice t has landed
    if (g.prologue) prologue(t);
    fence_proxy_async();
    __syncthreads();                           // ... for every thread, and
    if (t + kStages - 1 < nk) load_slice(t + kStages - 1);  // t-1 is free
    cp_async_commit();
    const bf16* xs = ring + (t % kStages) * kStage;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss_n<BN>(acc, sw128_desc(xs + wg * 64 * 64 + kk * 16, 0),
                     sw128_desc(xs + kXS + kk * 16, 0));
    wgmma_commit();
    wgmma_wait_all();                          // before the slot is reused
    fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();                             // the ring is free

  // Epilogue: y rounded once to bf16 into the staging tile; then each
  // thread stores a column of 16-byte chunks of it (a row of the tile is
  // kCR neighbouring chunks) and sums those 8 columns' rounded values and
  // their squares over its rows; the kRG row groups' sums are added in
  // order. Rows off the matrix are neither stored nor summed. No atomics:
  // y, s1 and s2 repeat bit for bit.
  constexpr int kCR = BN / 8;                  // chunks a tile row
  constexpr int kRG = kThreads / kCR;          // row groups
  bf16* ys = ring;
  float* red = reinterpret_cast<float*>(ys + kBM * kYP);  // [2][kRG][BN]
  const int rl = warp * 16 + gq;               // this thread's first row
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int c = n * 8 + 2 * tq;
    *reinterpret_cast<__nv_bfloat162*>(ys + rl * kYP + c) =
        __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(ys + (rl + 8) * kYP + c) =
        __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  bf16* y = static_cast<bf16*>(g.y);
  const int c = tid % kCR * 8;
  const int col = n0 + c;
  float s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.f;
#pragma unroll 4
  for (int r = tid / kCR; r < kBM; r += kRG) {
    const int row = m0 + r;
    if (row >= g.M || col >= g.N) break;
    Chunk8 v;
    v.u = *reinterpret_cast<const uint4*>(ys + r * kYP + c);
    bf16* dst = y + (long long)row * g.N + col;
    if (g.yvec) {
      *reinterpret_cast<uint4*>(dst) = v.u;
    } else {
      for (int e = 0; e < 8 && col + e < g.N; ++e) dst[e] = v.h[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float f = __bfloat162float(v.h[e]);
      s1[e] += f;
      s2[e] = fmaf(f, f, s2[e]);
    }
  }
  float* r1 = red + tid / kCR * BN + c;
  float* r2 = r1 + kRG * BN;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    r1[e] = s1[e];
    r2[e] = s2[e];
  }
  __syncthreads();
  if (tid < BN && n0 + tid < g.N) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int i = 0; i < kRG; ++i) {
      t1 += red[i * BN + tid];
      t2 += red[(kRG + i) * BN + tid];
    }
    const long long o = (long long)mt * g.N + n0 + tid;
    g.p1[o] = t1;
    g.p2[o] = t2;
  }
}

// ------------------------------------------------------------- float32

constexpr int kFM = 64;            // rows of a block tile
constexpr int kFN = 64;            // columns of a block tile
constexpr int kFK = 16;            // K depth of one shared slice
constexpr int kFT = 16;            // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kFT * kFT)
conv_bn_f32_kernel(Args g) {
  __shared__ float xs[kFK][kFM + 4];
  __shared__ float ws[kFK][kFN + 4];
  __shared__ float red1[kFT][kFN];
  __shared__ float red2[kFT][kFN];
  const int tid = threadIdx.x;
  const int tx = tid % kFT, ty = tid / kFT;
  const int n0 = blockIdx.x * kFN;
  const int m0 = blockIdx.y * kFM;
  const float* x = static_cast<const float*>(g.x);
  const float* wt = static_cast<const float*>(g.wt);
  const float* a = static_cast<const float*>(g.a);
  const float* b = static_cast<const float*>(g.b);

  // Each thread loads 4 consecutive channels of one x row and one w row.
  const int lrow = tid >> 2;               // 0..63
  const int lk = (tid & 3) * 4;            // 0, 4, 8, 12
  const int xr = m0 + lrow;
  const bool xvalid = xr < g.M;
  const long long xoff = xvalid ? row_offset(g, xr) : 0;
  const int wn = n0 + lrow;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < g.K; k0 += kFK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + lk + j;
      float v = 0.f;
      if (xvalid && k < g.K) {
        v = x[xoff + k];
        if (g.prologue) v = fmaxf(__fadd_rn(__fmul_rn(v, a[k]), b[k]), 0.f);
      }
      xs[lk + j][lrow] = v;
      ws[lk + j][lrow] = (wn < g.N && k < g.K) ? wt[(long long)wn * g.K + k]
                                                : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float xa[4], wb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = xs[kk][ty + kFT * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wb[j] = ws[kk][tx + kFT * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], wb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* y = static_cast<float*>(g.y);
  float cs1[4] = {}, cs2[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + kFT * i;
    if (r >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + kFT * j;
      if (c < g.N) y[(long long)r * g.N + c] = acc[i][j];
      cs1[j] += acc[i][j];
      cs2[j] += acc[i][j] * acc[i][j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red1[ty][tx + kFT * j] = cs1[j];
    red2[ty][tx + kFT * j] = cs2[j];
  }
  __syncthreads();
  if (tid < kFN && n0 + tid < g.N) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = 0; i < kFT; ++i) {
      s1 += red1[i][tid];
      s2 += red2[i][tid];
    }
    const long long o = (long long)blockIdx.y * g.N + n0 + tid;
    g.p1[o] = s1;
    g.p2[o] = s2;
  }
}

// ------------------------------------------------ the partials' reduction

constexpr int kRC = 8;             // columns of a reduction block: a sector
constexpr int kRGroups = 32;       // row groups of a reduction block

// s[c] = sum over the tiles t of p[t, c], in a fixed order: row group g
// of the block takes the tiles g, g + kRGroups, ... (8 at a time in flight),
// then the kRGroups group sums are added in group order. Narrow blocks spread
// the partials of a large M over many SMs.
__global__ void __launch_bounds__(kRC * kRGroups)
reduce_partials_kernel(const float* p1, const float* p2, float* s1,
                       float* s2, int tiles, int N) {
  __shared__ float r1[kRGroups][kRC];
  __shared__ float r2[kRGroups][kRC];
  const int cl = threadIdx.x % kRC;
  const int grp = threadIdx.x / kRC;
  const int c = blockIdx.x * kRC + cl;
  float a1 = 0.f, a2 = 0.f;
  if (c < N) {
    for (int t = grp; t < tiles; t += 8 * kRGroups) {
      float v1[8], v2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int u = t + j * kRGroups;
        v1[j] = u < tiles ? p1[(long long)u * N + c] : 0.f;
        v2[j] = u < tiles ? p2[(long long)u * N + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a1 += v1[j];
        a2 += v2[j];
      }
    }
  }
  r1[grp][cl] = a1;
  r2[grp][cl] = a2;
  __syncthreads();
  if (grp == 0 && c < N) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < kRGroups; ++i) {
      t1 += r1[i][cl];
      t2 += r2[i][cl];
    }
    s1[c] = t1;
    s2[c] = t2;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The bf16 kernel on a 1-D grid of (M tile, N tile) blocks, with its
// dynamic shared memory asked for at its first launch on a device.
template <int BN>
int launch_bf16(const Args& g, int m_tiles, cudaStream_t st) {
  const long long blocks = (long long)m_tiles * ((g.N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return -1;
  auto kern = conv_bn_bf16_kernel<BN>;
  constexpr size_t smem = bf16_smem<BN>();
  static SmemSet smem_set;
  if (int rc = set_smem_once(kern, smem, smem_set)) return rc;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows of one M tile of the scratch for a dtype (0 = float32, 1 = bf16):
// the wrapper allocates p1/p2 as [ceil(M / rows), N] float32.
int hvd_conv_bn_tile_rows(int dtype) { return dtype == 1 ? kBM : kFM; }

// dtype: 0 = float32, 1 = bfloat16 (x, a, b, wt and y alike). x holds M =
// B*H*W rows of K channels, row (b, h, w) at element b*sb + h*sh + w*sw
// with a contiguous channel; wt is [N, K] contiguous; y [M, N] contiguous;
// a/b are [K] (prologue != 0) or null; p1/p2 are the [tiles, N] float32
// scratch; s1/s2 [N] float32. Returns cudaGetLastError() after the two
// launches (0 = launched), or -1 for an argument the kernels do not take.
int hvd_conv_bn_stats(int dtype, const void* x, const void* a,
                      const void* b, const void* wt, void* y, void* p1,
                      void* p2, void* s1, void* s2, int M, int K, int N,
                      int H, int W, long long sb, long long sh, long long sw,
                      int prologue, void* stream) {
  if ((dtype != 0 && dtype != 1) || M <= 0 || K <= 0 || N <= 0 || H <= 0 ||
      W <= 0 || M % (H * W) != 0 || (prologue && (a == nullptr || b == nullptr)))
    return -1;
  Args g;
  g.x = x;
  g.a = a;
  g.b = b;
  g.wt = wt;
  g.y = y;
  g.p1 = static_cast<float*>(p1);
  g.p2 = static_cast<float*>(p2);
  g.M = M;
  g.K = K;
  g.N = N;
  g.H = H;
  g.W = W;
  g.sb = sb;
  g.sh = sh;
  g.sw = sw;
  g.prologue = prologue;
  // 16-byte copies of 8 bf16 channels: every row start, the weight's rows
  // and a/b must be 16-byte aligned.
  g.vec = dtype == 1 && K % 8 == 0 && sb % 8 == 0 && sh % 8 == 0 &&
          sw % 8 == 0 && aligned16(x) && aligned16(wt) &&
          (!prologue || (aligned16(a) && aligned16(b)));
  g.yvec = N % 8 == 0 && aligned16(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int tiles;
  if (dtype == 1) {
    tiles = (M + kBM - 1) / kBM;
    const int rc = N <= 64 ? launch_bf16<64>(g, tiles, st)
                           : launch_bf16<kWideN>(g, tiles, st);
    if (rc) return rc;
  } else {
    tiles = (M + kFM - 1) / kFM;
    if (tiles > 65535) return -1;
    conv_bn_f32_kernel<<<dim3((N + kFN - 1) / kFN, tiles), kFT * kFT, 0,
                         st>>>(g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<(N + kRC - 1) / kRC, kRC * kRGroups, 0, st>>>(
      g.p1, g.p2, static_cast<float*>(s1), static_cast<float*>(s2), tiles,
      N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
