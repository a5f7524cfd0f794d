// Fused factorized (2+1)D conv block for Hopper (sm_90a), "taps9" form,
// plain C interface: spatial (1,3,3) conv -> BatchNorm with batch statistics
// -> ReLU -> temporal (3,1,1) conv, stride 1, "same" padding, NDHWC bf16.
//
// Replaces cstp_tpu/ops/pallas/conv21d.py, tiling "taps9":
//   cstp_conv21d_taps9_stats <- _run_stats / _stats_kernel (pass A)
//   cstp_conv21d_taps9_fwd   <- _run_fwd / _fwd_kernel (pass B)
// They compute what csrc/conv21d.cu computes (tiling "clip"); what differs
// is how the work is cut.
//
// What bounds it on the H100: tensor-core operations. The spatial conv is
// (pixels) x (9*Cin) x (M) and pass B adds (pixels) x (3*M) x (Cout): at the
// main-path sites that is 150-300 operations per byte of input, near the
// card's 295 bf16 operations per byte, and the mid tensor (M = 144..1152
// channels) would be the largest tensor moved if it were stored.
//
// Design, kept from the TPU kernels:
//   * The input comes padded once (x_pad, (B, T, H+2, W+2, Cin)), so every
//     tap reads a dense shifted window with no bounds checks.
//   * The spatial conv is nine tap-wise K=Cin products, not one K=9*Cin
//     im2col product: a block stages the padded rows its pixel tile spans
//     (the tile's rows plus a 2-row halo) in shared memory, 16 channels at
//     a time, with the nine taps' 16 x BN slices of ws, and each tap's
//     product reads a shifted view of that one staged tile. Each warp runs
//     bf16 mma.sync m16n8k16 with f32 accumulation; ldmatrix takes one row
//     address per lane, so the 16 rows of a fragment are 16 pixels gathered
//     from the staged tile (a tile may cross image rows).
//   * Each mid value is rounded to bf16 before it is summed, squared or
//     normalised, as on the TPU.
// Design, changed for the card (the TPU ran a sequential grid that carried
// the statistics and the mid ring from step to step; CUDA blocks run in any
// order):
//   Pass A: one block per (frame, chunk of mid channels) walks the frame in
//   64-pixel tiles and writes the frame's per-channel sums of mid and mid^2,
//   scaled by 1/(H*W); a second small kernel reduces them per BN group in a
//   fixed order (deterministic, no float atomics): mean = sum / count,
//   var = sumsq / count - mean^2, count = (B/G)*T.
//   Pass B: one block per (pixel tile, output frame t, clip). It computes
//   the normalised bf16 mid of frames t-1, t, t+1 (those inside [0, T)) for
//   its tile into a 3-slot shared-memory ring, slot k for temporal tap k, then
//   the temporal product from the ring; taps outside [0, T) are skipped,
//   which is the zero temporal padding. That buys B*T*tiles-way parallelism
//   for the price of computing each frame's spatial conv three times (K3
//   walks the frames of a clip in order and computes it once). The tile is
//   the largest of 64/32/16 pixels whose ring of three (tile x M) bf16 frames
//   fits in 120 KB.
// Simple and right first: no TMA, wgmma or pipelining yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 16;               // Cin channels per staged chunk (K step)
constexpr int kLdX = kKC + 8;         // pitch (bf16) of a staged input pixel
constexpr int kMaxNT = 18;            // n8 accumulator tiles per warp
constexpr int kStatsP = 64;           // pass A pixel tile
constexpr int kKT = 64;               // mid rows of wt staged per temporal step
constexpr size_t kRingBudget = 120 * 1024;
constexpr size_t kSmemMax = 232448;

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// A block tile is 16*PR rows (PR in 1, 2, 4) by nb8 column tiles of 8. Warp w
// owns row strip w / WC and the column tiles j = wc + i*WC (i < kMaxNT) with
// WC = 4 / PR. Its accumulator acc[i][0..3] holds, for lane (g = lane/4,
// c = lane%4), rows g and g+8 of the strip at columns 8j+2c and 8j+2c+1.
struct WarpTile {
  int strip, wc, WC;
};

__device__ __forceinline__ WarpTile warp_tile(int PR) {
  const int warp = threadIdx.x >> 5, WC = kWarps / PR;
  return {warp / WC, warp % WC, WC};
}

__device__ __forceinline__ void zero_acc(float (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// acc += A (16 x kk) * B (kk x 8*nb8). A is k-contiguous in shared memory,
// `arow` pointing at this lane's row (lane % 16) of the strip; B is the
// row-major shared tile sB with pitch ldb.
__device__ __forceinline__ void warp_mma(float (*acc)[4], const bf16* arow, const bf16* sB,
                                         int ldb, int kk, WarpTile wt, int nb8) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < kk; k += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, arow + k + (lane >> 4) * 8);
    const bf16* brow = sB + (size_t)(k + (lane & 15)) * ldb;
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i) {
      const int j = wt.wc + i * wt.WC;
      if (j < nb8) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, brow + j * 8);
        mma_bf16(acc[i], a, b);
      }
    }
  }
}

// Stage `rows` rows x bn columns of a row-major global matrix into smem.
__device__ __forceinline__ void stage_rows(bf16* sB, int ldb, const bf16* __restrict__ g,
                                           int ldg, int rows, int bn) {
  const int vpr = bn / 8;
  for (int v = threadIdx.x; v < rows * vpr; v += kThreads) {
    const int r = v / vpr, q = v - r * vpr;
    *reinterpret_cast<uint4*>(sB + r * ldb + q * 8) =
        *reinterpret_cast<const uint4*>(g + (size_t)r * ldg + q * 8);
  }
}

// A pixel tile [p0, p0 + P) of an H x W frame reads padded rows
// [py0, py0 + nrows) of the padded frame; `hidx` is this lane's pixel
// (row lane % 16 of its warp's strip) in the staged rows for tap (0, 0).
// Lanes past the frame's end read pixel 0 and their results are dropped.
struct PixTile {
  int py0, nrows, hidx;
};

__host__ __device__ inline int tile_rows(int P, int H, int W) {
  const int span = (P + W - 2) / W + 3;  // most padded rows a tile touches
  return span < H + 2 ? span : H + 2;
}

__device__ __forceinline__ PixTile pix_tile(int p0, int P, int H, int W, WarpTile wt) {
  const int HW = H * W, last = min(p0 + P, HW) - 1;
  PixTile t;
  t.py0 = p0 / W;
  t.nrows = last / W - t.py0 + 3;
  const int p = p0 + wt.strip * 16 + (threadIdx.x & 15);
  t.hidx = p < HW ? (p / W - t.py0) * (W + 2) + p % W : 0;
  return t;
}

// acc = the spatial conv of one padded frame xf (H+2, W+2, Cin) at the
// tile's pixels and mid channels [n0, n0 + bn): nine tap-wise products per
// 16-channel chunk on shifted views of the staged rows sX; sB holds the
// nine taps' (16 x bn) slices of ws (3, 3, Cin, M).
__device__ __forceinline__ void spatial_tile(float (*acc)[4], const bf16* __restrict__ xf,
                                             const bf16* __restrict__ ws, int W, int Cin,
                                             int M, int n0, int bn, const PixTile& pt,
                                             WarpTile wt, bf16* sX, bf16* sB) {
  const int Wp = W + 2, ldb = bn + 8, nb8 = bn / 8;
  zero_acc(acc);
  for (int c0 = 0; c0 < Cin; c0 += kKC) {
    const bf16* rows = xf + (size_t)pt.py0 * Wp * Cin;
    for (int v = threadIdx.x; v < pt.nrows * Wp * 2; v += kThreads) {
      const int pix = v >> 1, q = v & 1;
      *reinterpret_cast<uint4*>(sX + pix * kLdX + q * 8) =
          *reinterpret_cast<const uint4*>(rows + (size_t)pix * Cin + c0 + q * 8);
    }
    for (int tap = 0; tap < 9; ++tap)
      stage_rows(sB + tap * kKC * ldb, ldb, ws + ((size_t)tap * Cin + c0) * M + n0, M,
                 kKC, bn);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * Wp + tap % 3;
      warp_mma(acc, sX + (size_t)(pt.hidx + off) * kLdX, sB + tap * kKC * ldb, ldb, kKC,
               wt, nb8);
    }
    __syncthreads();
  }
}

inline int largest_divisor_within(int n, int cap) {
  int best = 1;
  for (int d = 1; d <= n && d <= cap; ++d)
    if (n % d == 0) best = d;
  return best;
}

inline size_t halo_bytes(int P, int H, int W) {
  return align128(sizeof(bf16) * tile_rows(P, H, W) * (W + 2) * kLdX);
}

inline size_t ws_stage_bytes(int bn) { return align128(sizeof(bf16) * 9 * kKC * (bn + 8)); }

// ---------------------------------------------------------------- pass A --

__global__ void __launch_bounds__(kThreads)
taps9_stats_kernel(const bf16* __restrict__ x_pad, const bf16* __restrict__ ws,
                   float* __restrict__ psum, float* __restrict__ psq, int H, int W, int Cin,
                   int M, int bn, int ws_off, int red_off, float inv_hw) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + ws_off);
  float* sRed = reinterpret_cast<float*>(smem + red_off);  // [2][PR][bn]
  constexpr int PR = kStatsP / 16;
  const size_t frame = blockIdx.x;
  const int n0 = blockIdx.y * bn, nb8 = bn / 8;
  const int HW = H * W;
  const bf16* xf = x_pad + frame * (H + 2) * (W + 2) * Cin;
  const WarpTile wt = warp_tile(PR);
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};  // columns tid, tid + 128 (bn <= 144)
  for (int p0 = 0; p0 < HW; p0 += kStatsP) {
    const PixTile pt = pix_tile(p0, kStatsP, H, W, wt);
    float acc[kMaxNT][4];
    spatial_tile(acc, xf, ws, W, Cin, M, n0, bn, pt, wt, sX, sB);
    const int r0 = p0 + wt.strip * 16 + g;
    const bool v0 = r0 < HW, v1 = r0 + 8 < HW;
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i) {
      const int j = wt.wc + i * wt.WC;
      if (j < nb8) {
        const float a = v0 ? bf16_round(acc[i][0]) : 0.f, b = v0 ? bf16_round(acc[i][1]) : 0.f;
        const float d = v1 ? bf16_round(acc[i][2]) : 0.f, e = v1 ? bf16_round(acc[i][3]) : 0.f;
        float s0 = a + d, s1 = b + e, q0 = a * a + d * d, q1 = b * b + e * e;
        for (int o = 4; o < 32; o <<= 1) {  // sum over the 8 lanes of a column pair
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          q0 += __shfl_xor_sync(0xffffffffu, q0, o);
          q1 += __shfl_xor_sync(0xffffffffu, q1, o);
        }
        if (g == 0) {
          const int col = j * 8 + 2 * c;
          float* rs = sRed + wt.strip * bn;
          float* rq = sRed + (PR + wt.strip) * bn;
          rs[col] = s0;
          rs[col + 1] = s1;
          rq[col] = q0;
          rq[col + 1] = q1;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = threadIdx.x + h * kThreads;
      if (col < bn)
        for (int st = 0; st < PR; ++st) {
          s[h] += sRed[st * bn + col];
          q[h] += sRed[(PR + st) * bn + col];
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = threadIdx.x + h * kThreads;
    if (col < bn) {
      psum[frame * M + n0 + col] = s[h] * inv_hw;
      psq[frame * M + n0 + col] = q[h] * inv_hw;
    }
  }
}

// Per group g: frames [g*fpg, (g+1)*fpg), each holding its per-pixel means;
// mean = S / count, var = Q / count - mean^2 with count = fpg
// (conv21d.py:130-133, :167-169).
__global__ void taps9_stats_reduce_kernel(const float* __restrict__ psum,
                                          const float* __restrict__ psq,
                                          float* __restrict__ gmean, float* __restrict__ gvar,
                                          int fpg, int M) {
  __shared__ float ss[8][33], sq[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m = blockIdx.x * 32 + tx, g = blockIdx.y;
  float s = 0.f, q = 0.f;
  if (m < M)
    for (int r = ty; r < fpg; r += 8) {
      const size_t row = (size_t)g * fpg + r;
      s += psum[row * M + m];
      q += psq[row * M + m];
    }
  ss[ty][tx] = s;
  sq[ty][tx] = q;
  __syncthreads();
  if (ty == 0 && m < M) {
    float S = 0.f, Q = 0.f;
    for (int i = 0; i < 8; ++i) {
      S += ss[i][tx];
      Q += sq[i][tx];
    }
    const float mean = S / (float)fpg;
    gmean[g * M + m] = mean;
    gvar[g * M + m] = Q / (float)fpg - mean * mean;
  }
}

// ---------------------------------------------------------------- pass B --

struct FwdPlan {
  int PR, bn, bno;
  size_t ring, halo, work;
};

inline size_t ring_bytes(int P, int M) { return align128(sizeof(bf16) * 3 * P * (size_t)(M + 8)); }

bool plan_fwd(int H, int W, int M, int Cout, FwdPlan* pl) {
  int PR = 4;
  while (PR > 1 && ring_bytes(16 * PR, M) > kRingBudget) PR /= 2;
  pl->PR = PR;
  pl->bn = 16 * largest_divisor_within(M / 16, 9);
  pl->bno = 16 * largest_divisor_within(Cout / 16, 8);
  pl->ring = ring_bytes(16 * PR, M);
  pl->halo = halo_bytes(16 * PR, H, W);
  const size_t spatial = pl->halo + ws_stage_bytes(pl->bn);
  const size_t temporal = align128(sizeof(bf16) * kKT * (pl->bno + 8));
  pl->work = spatial > temporal ? spatial : temporal;
  return pl->ring + pl->work <= kSmemMax;
}

__global__ void __launch_bounds__(kThreads)
taps9_fwd_kernel(const bf16* __restrict__ x_pad, const bf16* __restrict__ ws,
                 const bf16* __restrict__ wt, const float* __restrict__ gmean,
                 const float* __restrict__ rstd, const float* __restrict__ scale,
                 const float* __restrict__ bias, bf16* __restrict__ out, int T, int H, int W,
                 int Cin, int M, int Cout, int clips_per_group, int PR, int bn, int bno,
                 int ring_bytes_, int halo_bytes_) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int P = 16 * PR, p0 = blockIdx.x * P, t = blockIdx.y, n = blockIdx.z;
  const int HW = H * W, ldr = M + 8;
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [3][P][ldr]
  bf16* sX = reinterpret_cast<bf16*>(smem + ring_bytes_);
  bf16* sB = reinterpret_cast<bf16*>(smem + ring_bytes_ + halo_bytes_);
  bf16* sBo = sX;  // the temporal step's wt stage reuses the spatial work space
  const int grp = n / clips_per_group;
  const float* mean_g = gmean + (size_t)grp * M;
  const float* rstd_g = rstd + (size_t)grp * M;
  const WarpTile wtl = warp_tile(PR);
  const PixTile pt = pix_tile(p0, P, H, W, wtl);
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int row0 = wtl.strip * 16 + g;  // this lane's rows: row0, row0 + 8
  const size_t frame_elems = (size_t)(H + 2) * (W + 2) * Cin;

  // mid frames t-1, t, t+1 of the tile, normalised, into ring slots 0, 1, 2
  for (int k = 0; k < 3; ++k) {
    const int f = t - 1 + k;
    if (f < 0 || f >= T) continue;
    const bf16* xf = x_pad + ((size_t)n * T + f) * frame_elems;
    bf16* slot = ring + (size_t)k * P * ldr;
    for (int n0 = 0; n0 < M; n0 += bn) {
      float acc[kMaxNT][4];
      spatial_tile(acc, xf, ws, W, Cin, M, n0, bn, pt, wtl, sX, sB);
#pragma unroll
      for (int i = 0; i < kMaxNT; ++i) {
        const int j = wtl.wc + i * wtl.WC;
        if (j < bn / 8) {
          const int m = n0 + j * 8 + 2 * c;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            float y[2] = {0.f, 0.f};
            if (p0 + row < HW) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float mid = bf16_round(acc[i][2 * h + e]);
                y[e] = fmaxf((mid - mean_g[m + e]) * rstd_g[m + e] * scale[m + e] + bias[m + e],
                             0.f);
              }
            }
            *reinterpret_cast<__nv_bfloat162*>(slot + (size_t)row * ldr + m) =
                __floats2bfloat162_rn(y[0], y[1]);
          }
        }
      }
    }
  }
  __syncthreads();

  // out frame t = sum over the valid taps k of ring slot k x wt[k]
  const int ldbo = bno + 8;
  for (int co0 = 0; co0 < Cout; co0 += bno) {
    float acc[kMaxNT][4];
    zero_acc(acc);
    for (int k = 0; k < 3; ++k) {
      const int f = t - 1 + k;
      if (f < 0 || f >= T) continue;
      const bf16* arow = ring + ((size_t)k * P + wtl.strip * 16 + (lane & 15)) * ldr;
      for (int m0 = 0; m0 < M; m0 += kKT) {
        const int kk = min(kKT, M - m0);
        stage_rows(sBo, ldbo, wt + ((size_t)k * M + m0) * Cout + co0, Cout, kk, bno);
        __syncthreads();
        warp_mma(acc, arow + m0, sBo, ldbo, kk, wtl, bno / 8);
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i) {
      const int j = wtl.wc + i * wtl.WC;
      if (j < bno / 8) {
        const int co = co0 + j * 8 + 2 * c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + row0 + 8 * h;
          if (p < HW)
            *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)n * T + t) * HW + p) * Cout +
                                               co) =
                __floats2bfloat162_rn(acc[i][2 * h], acc[i][2 * h + 1]);
        }
      }
    }
  }
}

inline bool shapes_ok(int B, int T, int H, int W, int Cin, int M, int Cout, int G) {
  return B > 0 && T > 0 && H > 0 && W > 0 && Cin > 0 && M > 0 && Cout > 0 &&
         Cin % kKC == 0 && M % 16 == 0 && Cout % 16 == 0 && G > 0 && B % G == 0;
}

}  // namespace

// x_pad (B, T, H+2, W+2, Cin) bf16; ws (3, 3, Cin, M) bf16;
// psum/psq (B*T, M) f32 scratch; gmean/gvar (G, M) f32 out.
extern "C" int cstp_conv21d_taps9_stats(const void* x_pad, const void* ws, void* psum,
                                        void* psq, void* gmean, void* gvar, int B, int T,
                                        int H, int W, int Cin, int M, int G, void* stream) {
  if (!shapes_ok(B, T, H, W, Cin, M, 16, G)) return (int)cudaErrorInvalidValue;
  const int bn = 16 * largest_divisor_within(M / 16, 9);
  const size_t halo = halo_bytes(kStatsP, H, W), wsb = ws_stage_bytes(bn);
  const size_t bytes = halo + wsb + sizeof(float) * 2 * (kStatsP / 16) * bn;
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      taps9_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  taps9_stats_kernel<<<dim3(B * T, M / bn), kThreads, bytes, s>>>(
      (const bf16*)x_pad, (const bf16*)ws, (float*)psum, (float*)psq, H, W, Cin, M, bn,
      (int)halo, (int)(halo + wsb), 1.f / (float)(H * W));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  taps9_stats_reduce_kernel<<<dim3((M + 31) / 32, G), dim3(32, 8), 0, s>>>(
      (const float*)psum, (const float*)psq, (float*)gmean, (float*)gvar, (B / G) * T, M);
  return (int)cudaGetLastError();
}

// x_pad, ws as above; wt (3, M, Cout) bf16; gmean/rstd (G, M) f32;
// scale/bias (M,) f32; out (B, T, H, W, Cout) bf16.
extern "C" int cstp_conv21d_taps9_fwd(const void* x_pad, const void* ws, const void* wt,
                                      const void* gmean, const void* rstd, const void* scale,
                                      const void* bias, void* out, int B, int T, int H, int W,
                                      int Cin, int M, int Cout, int G, void* stream) {
  FwdPlan pl;
  if (!shapes_ok(B, T, H, W, Cin, M, Cout, G) || B > 65535 || T > 65535 ||
      !plan_fwd(H, W, M, Cout, &pl))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = pl.ring + pl.work;
  cudaError_t err = cudaFuncSetAttribute(
      taps9_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int P = 16 * pl.PR;
  dim3 grid((H * W + P - 1) / P, T, B);
  taps9_fwd_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const bf16*)x_pad, (const bf16*)ws, (const bf16*)wt, (const float*)gmean,
      (const float*)rstd, (const float*)scale, (const float*)bias, (bf16*)out, T, H, W, Cin,
      M, Cout, B / G, pl.PR, pl.bn, pl.bno, (int)pl.ring, (int)pl.halo);
  return (int)cudaGetLastError();
}
