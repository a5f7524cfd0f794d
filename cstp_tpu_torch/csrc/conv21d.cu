// Fused factorized (2+1)D conv block for Hopper (sm_90a), plain C interface:
// spatial (1,3,3) conv -> BatchNorm with batch statistics -> ReLU ->
// temporal (3,1,1) conv, stride 1, "same" padding, NDHWC bf16.
//
// Replaces cstp_tpu/ops/pallas/conv21d.py, tiling "clip":
//   cstp_conv21d_stats <- _run_stats_clip / _stats_kernel_clip (pass A)
//   cstp_conv21d_fwd   <- _run_fwd_clip / _fwd_kernel_clip (pass B)
//
// What bounds it on the H100: tensor-core operations. The spatial conv is an
// implicit GEMM of (pixels) x (9*Cin) x (M) and pass B adds the temporal
// GEMM (pixels) x (3*M) x (Cout); at the main-path sites that is 150-300
// operations per byte of input, near the card's 295 bf16 ops/byte balance,
// and the mid tensor (M = 144..1152 channels) would be the largest tensor
// moved if it were stored.
//
// Design. Both passes compute the spatial conv with warp-level bf16 mma
// (nvcuda::wmma 16x16x16, f32 accumulation) on tiles staged in shared
// memory: A is gathered im2col-style from the unpadded input (out-of-frame
// taps read as zero, so no padded copy of x is made), B is a slice of
// ws (9*Cin, M). Each mid value is rounded to bf16 before it is used,
// as on the TPU.
//   Pass A: the TPU kernel carried its sums across a sequential grid; here
//   blocks run in any order, so each block (channel chunk, frame) writes
//   its frame's per-channel sums of mid and mid^2 to a scratch, and a second
//   small kernel reduces them per BN group in a fixed order (deterministic,
//   no float atomics) into the mean and the biased variance.
//   Pass B: the TPU kernel kept a whole clip's mid resident (14.5 MB at
//   layer 1), which cannot live in 227 KB of shared memory. One block owns
//   (clip, tile of whole image rows) and walks the frames in order, keeping
//   the normalised bf16 mid of the three most recent frames in a shared
//   memory ring; output frame t-1 is emitted once mid frame t is in (zero
//   temporal padding at both ends). Mid never reaches device memory and the
//   spatial conv is computed once per pass.
// Simple and right first: no TMA, wgmma or warp specialisation yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKStep = 32;             // K rows staged per iteration
constexpr int kLdA = kKStep + 8;       // padded pitch (bf16) of the A stage
constexpr int kMaxFragsPerWarp = 9;    // a tile holds at most 36 16x16 frags
constexpr int kMaxFrags = kMaxFragsPerWarp * kWarps;
constexpr int kStatsRowStrips = 4;     // pass A pixel tile: 64 pixels
constexpr size_t kRingBudget = 120 * 1024;
constexpr size_t kSmemMax = 232448;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

__device__ inline float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }

// Tile geometry shared by host and device: P = 16*PR rows, BN = 16*NF cols.
struct Tile {
  int PR, NF;
};

__host__ __device__ inline size_t stage_bytes(int PR, int NF) {
  const size_t a = align128(sizeof(bf16) * 16 * PR * kLdA);
  const size_t b = sizeof(bf16) * kKStep * (16 * NF + 8);
  const size_t c = sizeof(float) * 16 * PR * (16 * NF + 4);
  return align128(a + b > c ? a + b : c);
}

__device__ inline void zero_acc(Acc* acc) {
#pragma unroll
  for (int i = 0; i < kMaxFragsPerWarp; ++i) wmma::fill_fragment(acc[i], 0.f);
}

// acc += A[P x ks] * B[ks x BN] for one staged K chunk; frag f = warp + 4i
// covers row strip f / NF and column frag f % NF.
__device__ inline void mma_chunk(Acc* acc, const bf16* A, int lda, const bf16* B,
                                 int ldb, int kk, Tile tl) {
  const int warp = threadIdx.x >> 5, nfr = tl.PR * tl.NF;
  for (int ks = 0; ks < kk; ks += 16) {
#pragma unroll
    for (int i = 0; i < kMaxFragsPerWarp; ++i) {
      const int f = warp + i * kWarps;
      if (f < nfr) {
        const int rs = f / tl.NF, cf = f - rs * tl.NF;
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, A + rs * 16 * lda + ks, lda);
        wmma::load_matrix_sync(b, B + ks * ldb + cf * 16, ldb);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
  }
}

__device__ inline void store_acc(Acc* acc, float* C, int ldc, Tile tl) {
  const int warp = threadIdx.x >> 5, nfr = tl.PR * tl.NF;
#pragma unroll
  for (int i = 0; i < kMaxFragsPerWarp; ++i) {
    const int f = warp + i * kWarps;
    if (f < nfr) {
      const int rs = f / tl.NF, cf = f - rs * tl.NF;
      wmma::store_matrix_sync(C + rs * 16 * ldc + cf * 16, acc[i], ldc,
                              wmma::mem_row_major);
    }
  }
}

// Stage `rows` rows x BN columns of a row-major global matrix into smem.
__device__ inline void stage_b(bf16* sB, int ldb, const bf16* g, int ldg,
                               int rows, int bn) {
  const int vpr = bn / 8;
  for (int v = threadIdx.x; v < rows * vpr; v += kThreads) {
    const int r = v / vpr, q = v - r * vpr;
    *reinterpret_cast<uint4*>(sB + r * ldb + q * 8) =
        *reinterpret_cast<const uint4*>(g + (size_t)r * ldg + q * 8);
  }
}

// Spatial (1,3,3) conv of pixels [pix0, pix0 + npix) of one frame, mid
// channels [n0, n0 + BN): sC[r * ldc + j] = f32 conv value (rows >= npix 0).
// `work` holds the A and B stages, which sC overlays after the K loop.
__device__ void spatial_tile(const bf16* __restrict__ xf, int H, int W, int Cin,
                             int pix0, int npix, const bf16* __restrict__ ws,
                             int M, int n0, Tile tl, unsigned char* work,
                             float* sC, int ldc) {
  const int P = 16 * tl.PR, BN = 16 * tl.NF, ldb = BN + 8;
  bf16* sA = reinterpret_cast<bf16*>(work);
  bf16* sB = reinterpret_cast<bf16*>(work + align128(sizeof(bf16) * P * kLdA));
  Acc acc[kMaxFragsPerWarp];
  zero_acc(acc);
  const int K = 9 * Cin;
  for (int k0 = 0; k0 < K; k0 += kKStep) {
    const int tap = k0 / Cin, c0 = k0 - tap * Cin;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int v = threadIdx.x; v < P * 4; v += kThreads) {
      const int r = v >> 2, q = v & 3;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < npix) {
        const int p = pix0 + r;
        const int y = p / W + dy, x = p % W + dx;
        if (y >= 0 && y < H && x >= 0 && x < W)
          val = *reinterpret_cast<const uint4*>(xf + (size_t)(y * W + x) * Cin + c0 + q * 8);
      }
      *reinterpret_cast<uint4*>(sA + r * kLdA + q * 8) = val;
    }
    stage_b(sB, ldb, ws + (size_t)k0 * M + n0, M, kKStep, BN);
    __syncthreads();
    mma_chunk(acc, sA, kLdA, sB, ldb, kKStep, tl);
    __syncthreads();
  }
  store_acc(acc, sC, ldc, tl);
  __syncthreads();
}

// ---------------------------------------------------------------- pass A --

__global__ void __launch_bounds__(kThreads)
stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ws,
             float* __restrict__ psum, float* __restrict__ psq, int H, int W,
             int Cin, int M, int NF) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile tl{kStatsRowStrips, NF};
  const int P = 16 * tl.PR, BN = 16 * NF, ldc = BN + 4;
  const int n0 = blockIdx.x * BN;
  const size_t frame = blockIdx.y;
  const int HW = H * W;
  const bf16* xf = x + frame * HW * Cin;
  float* sC = reinterpret_cast<float*>(smem);
  const int j0 = threadIdx.x, j1 = threadIdx.x + kThreads;  // BN <= 144
  float s0 = 0.f, q0 = 0.f, s1 = 0.f, q1 = 0.f;
  for (int pix0 = 0; pix0 < HW; pix0 += P) {
    const int npix = min(P, HW - pix0);
    spatial_tile(xf, H, W, Cin, pix0, npix, ws, M, n0, tl, smem, sC, ldc);
    if (j0 < BN)
      for (int r = 0; r < npix; ++r) {
        const float v = bf16_round(sC[r * ldc + j0]);
        s0 += v;
        q0 += v * v;
      }
    if (j1 < BN)
      for (int r = 0; r < npix; ++r) {
        const float v = bf16_round(sC[r * ldc + j1]);
        s1 += v;
        q1 += v * v;
      }
    __syncthreads();
  }
  if (j0 < BN) {
    psum[frame * M + n0 + j0] = s0;
    psq[frame * M + n0 + j0] = q0;
  }
  if (j1 < BN) {
    psum[frame * M + n0 + j1] = s1;
    psq[frame * M + n0 + j1] = q1;
  }
}

// Per group g: frames [g*fpg, (g+1)*fpg); mean = S / count, var = Q / count
// - mean^2 with count = fpg * H * W (conv21d.py:369-371).
__global__ void stats_reduce_kernel(const float* __restrict__ psum,
                                    const float* __restrict__ psq,
                                    float* __restrict__ gmean,
                                    float* __restrict__ gvar, int fpg, int M,
                                    float inv_count) {
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
    const float mean = S * inv_count;
    gmean[g * M + m] = mean;
    gvar[g * M + m] = Q * inv_count - mean * mean;
  }
}

// ---------------------------------------------------------------- pass B --

struct FwdPlan {
  int R, PR, NF, NFo;
  size_t ring_bytes, work_bytes;
};

inline int largest_divisor_within(int n, int cap) {
  int best = 1;
  for (int d = 1; d <= n && d <= cap; ++d)
    if (n % d == 0) best = d;
  return best;
}

inline size_t ring_bytes(int PR, int M) {
  return align128(sizeof(bf16) * 3 * 16 * PR * (size_t)(M + 8));
}

// Row tile R: the most whole image rows with at most 64 pixels whose ring of
// three mid frames fits the budget (at least one row).
bool plan_fwd(int H, int W, int M, int Cout, FwdPlan* pl) {
  int R = 1;
  for (int r = 2; r <= H; ++r) {
    const int PR = (r * W + 15) / 16;
    if (r * W > 64 || ring_bytes(PR, M) > kRingBudget) break;
    R = r;
  }
  const int PR = (R * W + 15) / 16;
  if (PR > kMaxFrags) return false;
  pl->R = R;
  pl->PR = PR;
  pl->NF = largest_divisor_within(M / 16, kMaxFrags / PR);
  pl->NFo = largest_divisor_within(Cout / 16, kMaxFrags / PR);
  pl->ring_bytes = ring_bytes(PR, M);
  const size_t mid = stage_bytes(PR, pl->NF);
  const size_t outb = stage_bytes(PR, pl->NFo);
  pl->work_bytes = mid > outb ? mid : outb;
  return pl->ring_bytes + pl->work_bytes <= kSmemMax;
}

__device__ inline uint4 pack8(const float* v) {
  union {
    __nv_bfloat162 h[4];
    uint4 u;
  } r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return r.u;
}

__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ws,
           const bf16* __restrict__ wt, const float* __restrict__ gmean,
           const float* __restrict__ rstd, const float* __restrict__ scale,
           const float* __restrict__ bias, bf16* __restrict__ out, int T, int H,
           int W, int Cin, int M, int Cout, int clips_per_group, int R, int PR,
           int NF, int NFo, int ring_off) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = blockIdx.y, y0 = blockIdx.x * R;
  const int HW = H * W, pix0 = y0 * W, npix = min(R, H - y0) * W;
  const int g = n / clips_per_group;
  const int P = 16 * PR, ldr = M + 8;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  unsigned char* work = smem + ring_off;
  float* sC = reinterpret_cast<float*>(work);
  const float* mean_g = gmean + (size_t)g * M;
  const float* rstd_g = rstd + (size_t)g * M;

  const Tile tm{PR, NF}, to{PR, NFo};
  const int BN = 16 * NF, ldc = BN + 4;
  const int BNo = 16 * NFo, ldbo = BNo + 8, ldco = BNo + 4;

  // out frame `fo` from ring frames fo-1, fo, fo+1 (those inside [0, T))
  auto emit = [&](int fo) {
    for (int co0 = 0; co0 < Cout; co0 += BNo) {
      Acc acc[kMaxFragsPerWarp];
      zero_acc(acc);
      bf16* sB = reinterpret_cast<bf16*>(work);
      for (int k = 0; k < 3; ++k) {
        const int f = fo - 1 + k;
        if (f < 0 || f >= T) continue;
        const bf16* A = ring + (size_t)(f % 3) * P * ldr;
        for (int m0 = 0; m0 < M; m0 += kKStep) {
          const int kk = min(kKStep, M - m0);
          stage_b(sB, ldbo, wt + ((size_t)k * M + m0) * Cout + co0, Cout, kk, BNo);
          __syncthreads();
          mma_chunk(acc, A + m0, ldr, sB, ldbo, kk, to);
          __syncthreads();
        }
      }
      float* sO = reinterpret_cast<float*>(work);
      store_acc(acc, sO, ldco, to);
      __syncthreads();
      const int vpr = BNo / 8;
      for (int v = threadIdx.x; v < npix * vpr; v += kThreads) {
        const int r = v / vpr, q = v - r * vpr;
        const size_t o = ((size_t)(n * T + fo) * HW + pix0 + r) * Cout + co0 + q * 8;
        *reinterpret_cast<uint4*>(out + o) = pack8(sO + r * ldco + q * 8);
      }
      __syncthreads();
    }
  };

  for (int t = 0; t < T; ++t) {
    const bf16* xf = x + (size_t)(n * T + t) * HW * Cin;
    bf16* slot = ring + (size_t)(t % 3) * P * ldr;
    for (int n0 = 0; n0 < M; n0 += BN) {
      spatial_tile(xf, H, W, Cin, pix0, npix, ws, M, n0, tm, work, sC, ldc);
      for (int e = threadIdx.x; e < P * BN; e += kThreads) {
        const int r = e / BN, j = e - r * BN, m = n0 + j;
        float v = 0.f;
        if (r < npix) {
          const float mid = bf16_round(sC[r * ldc + j]);
          v = fmaxf((mid - mean_g[m]) * rstd_g[m] * scale[m] + bias[m], 0.f);
        }
        slot[r * ldr + m] = __float2bfloat16(v);
      }
      __syncthreads();
    }
    if (t >= 1) emit(t - 1);
  }
  emit(T - 1);
}

inline bool shapes_ok(int Cin, int M, int Cout) {
  return Cin % kKStep == 0 && M % 16 == 0 && Cout % 16 == 0;
}

}  // namespace

// x (B, T, H, W, Cin) bf16; ws (9*Cin, M) bf16 (tap-major, cin-minor);
// psum/psq (B*T, M) f32 scratch; gmean/gvar (G, M) f32 out.
extern "C" int cstp_conv21d_stats(const void* x, const void* ws, void* psum, void* psq,
                                  void* gmean, void* gvar, int B, int T, int H, int W,
                                  int Cin, int M, int G, void* stream) {
  if (!shapes_ok(Cin, M, 16) || G <= 0 || B % G) return (int)cudaErrorInvalidValue;
  const int NF = largest_divisor_within(M / 16, kMaxFragsPerWarp);
  const size_t bytes = stage_bytes(kStatsRowStrips, NF);
  cudaError_t err = cudaFuncSetAttribute(
      stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  stats_kernel<<<dim3(M / (16 * NF), B * T), kThreads, bytes, s>>>(
      (const bf16*)x, (const bf16*)ws, (float*)psum, (float*)psq, H, W, Cin, M, NF);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int fpg = (B / G) * T;
  stats_reduce_kernel<<<dim3((M + 31) / 32, G), dim3(32, 8), 0, s>>>(
      (const float*)psum, (const float*)psq, (float*)gmean, (float*)gvar, fpg, M,
      1.f / ((float)fpg * (float)(H * W)));
  return (int)cudaGetLastError();
}

// x, ws as above; wt (3, M, Cout) bf16; gmean/rstd (G, M) f32;
// scale/bias (M,) f32; out (B, T, H, W, Cout) bf16.
extern "C" int cstp_conv21d_fwd(const void* x, const void* ws, const void* wt,
                                const void* gmean, const void* rstd, const void* scale,
                                const void* bias, void* out, int B, int T, int H, int W,
                                int Cin, int M, int Cout, int G, void* stream) {
  FwdPlan pl;
  if (!shapes_ok(Cin, M, Cout) || G <= 0 || B % G || !plan_fwd(H, W, M, Cout, &pl))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = pl.ring_bytes + pl.work_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + pl.R - 1) / pl.R, B);
  fwd_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)ws, (const bf16*)wt, (const float*)gmean,
      (const float*)rstd, (const float*)scale, (const float*)bias, (bf16*)out, T, H, W,
      Cin, M, Cout, B / G, pl.R, pl.PR, pl.NF, pl.NFo, (int)pl.ring_bytes);
  return (int)cudaGetLastError();
}
