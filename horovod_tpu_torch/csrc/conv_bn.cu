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
//     K in 32-deep (bf16) or 16-deep (f32) slices; the weight streams
//     through shared memory with x, there is no VMEM-style budget;
//   * each block writes the float32 column sums of its valid rows into a
//     [num_m_tiles, N] scratch (the wrapper allocates it), and a second
//     small kernel sums those partials over the M tiles in a fixed order:
//     no atomics, so y, s1 and s2 repeat bit for bit;
//   * rows past M are masked in the kernel (not padded in device memory);
//     with the prologue a masked row is zeroed AFTER the affine, since
//     relu(0*a + b) = relu(b) is not zero and would poison the statistics
//     (conv_bn.py:103-108);
//   * x is read as [B, H, W, K] rows through the view's (b, h, w) strides
//     with a contiguous channel, so the stride-2 projection's input
//     x[:, ::2, ::2, :] is read in place, without a copy; a plain [M, K]
//     matrix is the case H = W = 1.
// The weight comes as wt [N, K] with K contiguous (the transpose of the
// JAX [K, N] kernel, which is exactly PyTorch's OIHW 1x1 weight viewed as
// [Cout, Cin]).
//
// Rounding points are those of the Pallas kernel: products accumulate in
// float32 and y is rounded once to x's type; the prologue's affine runs in
// the storage type (x*a rounded, then +b rounded, then the ReLU), with a
// and b already cast to x's type by the wrapper (conv_bn.py:102, :179).
//
// bfloat16 (the ResNet lane) runs on the tensor cores: mma.sync
// m16n8k16 with float32 accumulators fed by ldmatrix from padded shared
// tiles, a 128 x BN block tile (BN 128, or 64 when N <= 64), 8 warps, the
// next K slice loaded into registers while the current one is multiplied
// (two shared buffers, one barrier a slice). float32 runs float32 FMAs on
// the CUDA cores (64 x 64 tiles, 4 x 4 outputs a thread).
//
// What bounds it on an H100: bytes. At ResNet-50's 1x1 shapes (batch 64,
// 224^2, bf16) a training step's 36 launches move about 2.1 GB (x and w
// read once, y written once) against about 0.27 TFLOP, below the card's
// 295 flop/byte balance, so the least time is the bytes over the HBM
// rate (chip_smoke.py computes it from the shapes). The design keeps the
// statistics pass out of device memory, which is the point of the fusion;
// wgmma/TMA and deeper pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kBM = 128;           // rows of a block tile
constexpr int kBK = 32;            // K depth of one shared slice
constexpr int kPitch = kBK + 8;    // padded row pitch (80 B): no conflicts
constexpr int kThreads = 256;      // 8 warps: 2 along M x 4 along N

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// relu(round(round(x*a) + b)): the storage-type affine of the prologue.
__device__ __forceinline__ float affine_bf16(float x, float a, float b) {
  return fmaxf(bf(__fadd_rn(bf(__fmul_rn(x, a)), b)), 0.f);
}

union Chunk {                       // 8 bf16 values, one 16-byte load
  uint4 u;
  __nv_bfloat16 h[8];
};

// Loads 8 consecutive channels [k, k+8) of one row (zero past K), applies
// the prologue when asked; a row that is off the matrix gives zeros.
__device__ __forceinline__ uint4 load_x_chunk(const Args& g, long long off,
                                              bool valid, int k) {
  Chunk c;
  c.u = make_uint4(0, 0, 0, 0);
  if (!valid) return c.u;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(g.x) + off;
  if (g.vec) {
    if (k < g.K) c.u = *reinterpret_cast<const uint4*>(x + k);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (k + j < g.K) c.h[j] = x[k + j];
  }
  if (g.prologue) {
    const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(g.a);
    const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(g.b);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = (k + j < g.K)
          ? affine_bf16(__bfloat162float(c.h[j]), __bfloat162float(a[k + j]),
                        __bfloat162float(b[k + j]))
          : 0.f;
      c.h[j] = __float2bfloat16_rn(v);
    }
  }
  return c.u;
}

__device__ __forceinline__ uint4 load_w_chunk(const Args& g, int n, int k) {
  Chunk c;
  c.u = make_uint4(0, 0, 0, 0);
  if (n >= g.N) return c.u;
  const __nv_bfloat16* w =
      static_cast<const __nv_bfloat16*>(g.wt) + (long long)n * g.K;
  if (g.vec) {
    if (k < g.K) c.u = *reinterpret_cast<const uint4*>(w + k);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (k + j < g.K) c.h[j] = w[k + j];
  }
  return c.u;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv_bn_bf16_kernel(Args g) {
  constexpr int WN = BN / 4;        // columns of a warp tile
  constexpr int NI = WN / 8;        // n8 tiles of a warp
  constexpr int MI = 4;             // m16 tiles of a warp (64 rows)
  constexpr int WCH = BN * kBK / 8 / kThreads;   // w chunks a thread loads
  __shared__ __align__(16) __nv_bfloat16 xs[2][kBM][kPitch];
  __shared__ __align__(16) __nv_bfloat16 ws[2][BN][kPitch];
  __shared__ float red1[2][BN];
  __shared__ float red2[2][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;         // 0..1
  const int wn = warp & 3;          // 0..3
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kBM;

  // This thread's two x rows and its w rows, fixed over the K loop.
  const int crow = tid >> 2;               // 0..63
  const int ck = (tid & 3) * 8;            // 0, 8, 16, 24
  long long xoff[2];
  bool xvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + crow + 64 * i;
    xvalid[i] = r < g.M;
    xoff[i] = xvalid[i] ? row_offset(g, r) : 0;
  }

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  uint4 xr[2], wr[WCH];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) xr[i] = load_x_chunk(g, xoff[i], xvalid[i],
                                                     k0 + ck);
#pragma unroll
    for (int i = 0; i < WCH; ++i)
      wr[i] = load_w_chunk(g, n0 + crow + 64 * i, k0 + ck);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(&xs[buf][crow + 64 * i][ck]) = xr[i];
#pragma unroll
    for (int i = 0; i < WCH; ++i)
      *reinterpret_cast<uint4*>(&ws[buf][crow + 64 * i][ck]) = wr[i];
  };

  const int nk = (g.K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kBK);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], &xs[buf][wm * 64 + i * 16 + (lane & 15)]
                               [ks + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, &ws[buf][wn * WN + j * 8 + (lane & 7) +
                                  (lane >> 4) * 8]
                            [ks + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16(acc[i][j], af[i], bfr[0], bfr[1]);
          mma_bf16(acc[i][j + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: round, write y, and the column sums of the rounded values.
  const int gq = lane >> 2;
  const int tq = lane & 3;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(g.y);
  const bool pair = (g.N & 1) == 0;        // bf16x2 stores are aligned
  float cs1[NI][2], cs2[NI][2];
#pragma unroll
  for (int j = 0; j < NI; ++j)
    cs1[j][0] = cs1[j][1] = cs2[j][0] = cs2[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 64 + i * 16 + gq + 8 * h;
      if (r >= g.M) continue;
      __nv_bfloat16* yrow = y + (long long)r * g.N;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = n0 + wn * WN + j * 8 + 2 * tq;
        const __nv_bfloat16 v0 = __float2bfloat16_rn(acc[i][j][2 * h]);
        const __nv_bfloat16 v1 = __float2bfloat16_rn(acc[i][j][2 * h + 1]);
        if (pair && c + 1 < g.N) {
          __nv_bfloat162 v2;
          v2.x = v0;
          v2.y = v1;
          *reinterpret_cast<__nv_bfloat162*>(yrow + c) = v2;
        } else {
          if (c < g.N) yrow[c] = v0;
          if (c + 1 < g.N) yrow[c + 1] = v1;
        }
        const float f0 = __bfloat162float(v0), f1 = __bfloat162float(v1);
        cs1[j][0] += f0;
        cs2[j][0] += f0 * f0;
        cs1[j][1] += f1;
        cs2[j][1] += f1 * f1;
      }
    }
  }
  // Sum over the 8 row groups of the warp (lanes with equal tq), then over
  // the two warps along M, in a fixed order.
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int s = 4; s < 32; s <<= 1) {
        cs1[j][c] += __shfl_xor_sync(0xffffffffu, cs1[j][c], s);
        cs2[j][c] += __shfl_xor_sync(0xffffffffu, cs2[j][c], s);
      }
  if (gq == 0) {
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        red1[wm][wn * WN + j * 8 + 2 * tq + c] = cs1[j][c];
        red2[wm][wn * WN + j * 8 + 2 * tq + c] = cs2[j][c];
      }
  }
  __syncthreads();
  if (tid < BN && n0 + tid < g.N) {
    const long long o = (long long)blockIdx.y * g.N + n0 + tid;
    g.p1[o] = red1[0][tid] + red1[1][tid];
    g.p2[o] = red2[0][tid] + red2[1][tid];
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

constexpr int kRC = 32;            // columns of a reduction block
constexpr int kRW = 32;            // warps of a reduction block

// s[c] = sum over the tiles t of p[t, c], in a fixed order: warp w takes
// the tiles w, w + 32, ... (lane = column), then the 32 warp sums are
// added in warp order.
__global__ void __launch_bounds__(kRC * kRW)
reduce_partials_kernel(const float* p1, const float* p2, float* s1,
                       float* s2, int tiles, int N) {
  __shared__ float r1[kRW][kRC];
  __shared__ float r2[kRW][kRC];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int c = blockIdx.x * kRC + lane;
  float a1 = 0.f, a2 = 0.f;
  if (c < N) {
    for (int t = w; t < tiles; t += kRW) {
      a1 += p1[(long long)t * N + c];
      a2 += p2[(long long)t * N + c];
    }
  }
  r1[w][lane] = a1;
  r2[w][lane] = a2;
  __syncthreads();
  if (w == 0 && c < N) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < kRW; ++i) {
      t1 += r1[i][lane];
      t2 += r2[i][lane];
    }
    s1[c] = t1;
    s2[c] = t2;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
  // 16-byte loads of 8 bf16 channels: every row start and the weight's
  // rows must be 16-byte aligned.
  g.vec = dtype == 1 && K % 8 == 0 && sb % 8 == 0 && sh % 8 == 0 &&
          sw % 8 == 0 && aligned16(x) && aligned16(wt) &&
          (!prologue || (aligned16(a) && aligned16(b)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int tiles;
  if (dtype == 1) {
    tiles = (M + kBM - 1) / kBM;
    if (tiles > 65535) return -1;
    if (N <= 64) {
      conv_bn_bf16_kernel<64><<<dim3((N + 63) / 64, tiles), kThreads, 0,
                                st>>>(g);
    } else {
      conv_bn_bf16_kernel<128><<<dim3((N + 127) / 128, tiles), kThreads, 0,
                                 st>>>(g);
    }
  } else {
    tiles = (M + kFM - 1) / kFM;
    if (tiles > 65535) return -1;
    conv_bn_f32_kernel<<<dim3((N + kFN - 1) / kFN, tiles), kFT * kFT, 0,
                         st>>>(g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<(N + kRC - 1) / kRC, kRC * kRW, 0, st>>>(
      g.p1, g.p2, static_cast<float*>(s1), static_cast<float*>(s2), tiles,
      N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
