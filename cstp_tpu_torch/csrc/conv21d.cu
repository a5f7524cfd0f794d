// Fused factorized (2+1)D conv block for Hopper (sm_90a), plain C interface:
// spatial (1,3,3) conv -> BatchNorm with batch statistics -> ReLU ->
// temporal (3,1,1) conv, stride 1, "same" padding, NDHWC bf16.
//
// Replaces cstp_tpu/ops/pallas/conv21d.py, both tilings:
//   cstp_conv21d_stats       <- _run_stats_clip / _stats_kernel_clip (pass A, :347)
//   cstp_conv21d_fwd         <- _run_fwd_clip / _fwd_kernel_clip (pass B, :432)
//   cstp_conv21d_taps9_stats <- _run_stats / _stats_kernel (pass A, taps9, :145)
//   cstp_conv21d_taps9_fwd   <- _run_fwd / _fwd_kernel (pass B, taps9, :238)
// The two tilings compute one function; here they share both kernels and
// differ only in where the A gather reads (the A-source policy, a template
// parameter): "clip" takes the unpadded x and zero-fills out-of-frame taps,
// "taps9" takes x padded once, (B, T, H+2, W+2, Cin), as the TPU kernel
// does, so every tap reads a dense shifted window and the only predicate
// left is "row past the end". The K order (tap-major, cin-minor) and every
// reduction's order are the same, so on the same x the two tilings give
// bitwise the same statistics and output.
//
// What bounds it on the H100: tensor-core operations. The spatial conv is an
// implicit GEMM of (pixels) x (9*Cin) x (M) and pass B adds the temporal
// GEMM (pixels) x (3*M) x (Cout); at the main-path sites that is 150-300
// operations per byte of input, near the card's 295 bf16 ops/byte balance,
// and the mid tensor (M = 144..1152 channels) would be the largest tensor
// moved if it were stored.
//
// One spatial mainloop serves both passes. A block of 256 threads (8 warps)
// owns P consecutive rows of a flat row index (so no mma row idles on a 7x7
// or 14x14 frame); each thread precomputes its gather rows' frame base and
// (y, x) once per row tile (GatherRows). Every K step of 64 rows of 9 * Cin
// is staged with 16-byte cp.async.cg into a ring of 3-4 stages: A is the
// im2col gather of the unpadded input at the tile's rows (gather_a;
// out-of-frame taps and rows past the end by the zero-filling form, so no
// padded copy of x is made), B a slice of ws (9*Cin, M) (copy_b). One
// __syncthreads per step; 8 warps run ldmatrix + mma.sync m16n8k16 on
// 32 x (8 * ni) register tiles (warp_mma), and the epilogues go straight
// from the accumulator fragments. Each mid value is rounded to bf16 before
// it is used, as on the TPU (conv21d.py:327).
//
// Design of pass A (K2). The TPU kernel carried its sums across a
// sequential grid and staged whole frames; here blocks run in any order.
// A block walks tpb consecutive row tiles of the flat (frame, pixel) index
// of one BN group, for one chunk of bn mid channels, as one sequence of K
// steps whose producer runs S - 1 steps ahead across tile boundaries. Rows
// past the group's end are zero-filled, and a zero row adds exactly 0 to
// both sums, so tiles never mix groups and need no mask. After a tile's
// last K step each accumulator value is rounded to bf16; each thread adds
// its four rows' values and squares per column, and the 8 lanes that share
// columns reduce-scatter those sums with __shfl_xor (16, 8, 4), so each lane
// carries NI / 2 of its warp's column sums in registers from tile to tile.
// At the block's end the warps' sums meet in shared memory (over the
// stages), are added over the row strips in a fixed order, and the block
// writes one partial row of sums and one of squares to a (blocks, M) f32
// scratch; a second small kernel adds each group's partial rows in a fixed
// order into the mean and the biased variance Q / count - mean^2
// (conv21d.py:369-371). No float atomics: two launches give bitwise the same
// statistics. Shared memory is the stages alone (113.7 KB at P = 128,
// bn = 144, 3 stages), so two blocks are resident per SM, 16 warps. The
// launch plan (row tile, stages, chunk, tiles per block, blocks) comes
// from ops/conv21d.py plan_stats and is checked here again. Plans at the
// pretrain step's sites, N = 32, two groups, and the time on one H100 80GB
// HBM3 at 700 W (chip_smoke.py; the design this replaced, wmma tiles
// staged synchronously with one block per frame and chunk, took 6.67 /
// 3.48 / 2.08 / 1.05 ms):
//   site   P  chunk stages  tiles  per block  blocks    ms    TFLOP/s
//   conv2 128  144    3     12544     48       262    1.366    195
//   conv3 128  144    3      3136     12       264    0.675    197
//   conv4 128  144    3       784      3       264    0.328    203
//   conv5 128  144    3       208      1       208    0.218    153
// Plans with one block per SM, narrower chunks or smaller row tiles
// measured slower at every site (perf/sweep_conv21d_fwd.py --pass stats),
// and 3 or 4 stages time alike: by inference the warps' issue of ldmatrix,
// mma.sync and cp.async per K step bounds it, which the wider warp tile and
// the second block per SM amortise and hide. conv5 fills 208 of 264 block
// slots with 72 K steps each.
//
// Design of pass B (K3, replaces cstp_tpu/ops/pallas/conv21d.py:432). The
// TPU kernel kept a whole clip's mid resident (14.5 MB at layer 1), which
// cannot live in 227 KB of shared memory. A block owns P rows of the flat
// (clip, pixel) index (each row carries its own clip's frame base and BN
// group, and a tile may span clips and groups) and walks the frames in
// order, keeping the normalised bf16 mid of the min(3, T) latest frames in
// a shared-memory ring; output frame t-1 is computed from the ring once mid
// frame t is in (zero temporal padding at both ends). Mid never reaches
// device memory and each mid frame's spatial conv is computed once per
// launch (recompute factor 1). Its K steps (spatial: the mainloop above;
// temporal: a ring slot as A and a slice of wt) share one ring of stages.
// ws and wt stream from L2 once per mid frame or output frame per block.
// Where the ring of a wide mid does not fit one block at a large row tile,
// a cluster of C = 2 or 4 blocks shares the tile:
// block r computes mid channels [r M/C, (r+1) M/C) into its own ring and
// output channels [r Cout/C, ...) from all C rings, reading the others'
// A fragments through distributed shared memory; a cluster barrier at each
// frame's spatial and temporal step keeps the rings consistent.
// Plans at the pretrain step's sites, N = 32 (ops/conv21d.py plan_fwd;
// L2 -> SM bytes per launch: ws and the A gather per mid frame and mid chunk,
// wt per output frame and tap):
//   site   C   P  stages blocks  mid/out chunk  warp tile  L2 reads
//   conv2  1  128   3     784     144 / 64       32x80     4.60 GB
//   conv3  2  128   3     392     144 / 64       32x80     2.28 GB
//   conv4  4  128   3     196     144 / 64       32x80     1.13 GB
//   conv5  4   64   3     100     288 / 128      32x80     0.77 GB
// One block is resident per SM (the ring and stages take 217-230 KB), so
// conv4 runs 1.5 waves and conv5 fills 100 of 132 SMs; plans with more,
// smaller blocks measured slower (perf/sweep_conv21d_fwd.py). What bounds
// it on the H100 (chip_smoke.py, the sweep): not the operations (5-10% of
// the bf16 peak), nor L2 bandwidth (the reads above come to about 1 TB/s),
// nor the depth of the copy pipeline (3 to 6 stages time alike), but a
// fixed cost per K step: by inference, cp.async and ldmatrix issue through
// the same memory-instruction pipe, so staging and mma do not overlap, and
// 8 warps per SM hide little of each step's mma chain and barrier.
// No TMA, wgmma or warp specialisation yet, in either pass.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kKC = 64;                  // K rows per pipeline stage
constexpr int kLdA = kKC + 8;            // pitch (bf16) of the staged A gather
constexpr int kMI = 2;                   // 16-row mma strips per warp
constexpr int kMaxGatherRows = 4;        // rows per thread in the A gather (P <= 128)
constexpr size_t kSmemMax = 232448;      // dynamic shared memory of one block
constexpr size_t kSmemSM = 233472;       // of one SM; a resident block also takes 1 KB
constexpr int kStatsPerSM = 2;           // pass-A blocks resident per SM (launch bound)

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ inline float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }

// ------------------------------------------------------ spatial mainloop --

// This thread's rows of the A gather: rows (tid / 8) + 32 i of the row
// tile, channels 8 * (tid % 8) .. + 8 of each K step.
struct GatherRows {
  int frame0[kMaxGatherRows];  // the row's first frame; -1 past the end
  int y[kMaxGatherRows], x[kMaxGatherRows];
};

// This thread's rows r0 + (tid / 8) + 32 i of a flat row index whose unit
// is `fstride` frames of HW pixels (K3: clips, fstride T; K2: frames, 1);
// rows at or past `end` get frame0 -1.
__device__ inline GatherRows gather_rows(int r0, int end, int HW, int W, int fstride) {
  GatherRows gr;
#pragma unroll
  for (int i = 0; i < kMaxGatherRows; ++i) {
    const int r = r0 + (threadIdx.x >> 3) + 32 * i;
    const int n = r / HW, p = r - n * HW;
    gr.frame0[i] = r < end ? n * fstride : -1;
    gr.y[i] = p / W;
    gr.x[i] = p - gr.y[i] * W;
  }
  return gr;
}

// The A half of a spatial K step: the im2col gather, at K rows
// [k0, k0 + rows) of 9 * Cin (tap-major, cin-minor), of this thread's rows
// in frame frame0 + fu, into the first P rows of sA; rows past the end are
// zero-filled. kPad false: x is unpadded (H x W frames) and out-of-frame
// taps are zero-filled too. kPad true: x is padded, (H + 2) x (W + 2)
// frames, and tap (dy, dx) of pixel (y, x) is at (y + dy + 1, x + dx + 1),
// always inside the frame. A piece of 8 channels never crosses a tap, since
// Cin % 16 == 0.
template <bool kPad>
__device__ inline void gather_a(bf16* sA, const bf16* __restrict__ x, const GatherRows& gr,
                                int fu, int H, int W, int Cin, int P, int k0, int rows) {
  const int tid = threadIdx.x, q = tid & 7, k = k0 + 8 * q;
  if (8 * q >= rows) return;
  const int tap = k / Cin, ci = k - tap * Cin;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  if constexpr (kPad) {
    const int Wp = W + 2, off = (dy + 1) * Wp + dx + 1;
    const size_t HWp = (size_t)(H + 2) * Wp;
#pragma unroll
    for (int i = 0; i < kMaxGatherRows; ++i) {
      const int row = (tid >> 3) + 32 * i;
      if (row < P) {
        const bool ok = gr.frame0[i] >= 0;
        const bf16* g = x;
        if (ok) g += ((size_t)(gr.frame0[i] + fu) * HWp + gr.y[i] * Wp + gr.x[i] + off) * Cin + ci;
        cp_async16(sA + row * kLdA + 8 * q, g, ok);
      }
    }
  } else {
    const size_t HW = (size_t)H * W;
#pragma unroll
    for (int i = 0; i < kMaxGatherRows; ++i) {
      const int row = (tid >> 3) + 32 * i;
      if (row < P) {
        const int y = gr.y[i] + dy, xx = gr.x[i] + dx;
        const bool ok = gr.frame0[i] >= 0 && (unsigned)y < (unsigned)H && (unsigned)xx < (unsigned)W;
        const bf16* g = x;
        if (ok) g += ((size_t)(gr.frame0[i] + fu) * HW + y * W + xx) * Cin + ci;
        cp_async16(sA + row * kLdA + 8 * q, g, ok);
      }
    }
  }
}

// This thread's 16-byte column q and first row r of a B slice whose rows
// hold a full chunk's width / 8 vectors, rows r, r + rstep, ...; threads
// with q past a ragged chunk's width, or r >= rstep, copy nothing.
struct BMap {
  int q, r, rstep;
};

__device__ inline BMap bmap_for(int chunk) {
  const int vpr = chunk / 8, rstep = kThreads / vpr, r = threadIdx.x / vpr;
  return r < rstep ? BMap{(int)threadIdx.x - r * vpr, r, rstep} : BMap{vpr, 0, 1};
}

// The B half of a K step: rows x width columns of a row-major matrix
// (pitch ldg) from `src` into sB (pitch ldb).
__device__ inline void copy_b(bf16* sB, int ldb, const bf16* src, int ldg, int rows, int width,
                              BMap bm) {
  if (bm.q < width / 8)
    for (int r = bm.r; r < rows; r += bm.rstep)
      cp_async16(sB + r * ldb + bm.q * 8, src + (size_t)r * ldg + bm.q * 8, true);
}

// Wait for the oldest of the S - 1 copy groups in flight.
__device__ __forceinline__ void cp_async_wait_stages(int S) {
  switch (S) {
    case 3: cp_async_wait<1>(); break;
    case 4: cp_async_wait<2>(); break;
    case 5: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// The A fragments of this warp's 32-row strip at K offset k: from this
// block's shared memory by ldmatrix, or (cluster) by 32-bit loads from the
// distributed shared-memory address `ca` of another block's strip.
struct ALocal {
  const bf16* A;
  int lda;
  __device__ __forceinline__ void load(uint32_t (*af)[4], int k) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
      ldmatrix_x4(af[mi], A + (mi * 16 + (lane & 15)) * lda + k + (lane >> 4) * 8);
  }
};

struct ACluster {
  uint32_t ca;
  int lda;
  __device__ __forceinline__ void load(uint32_t (*af)[4], int k) const {
    const int lane = threadIdx.x & 31, pitch = 2 * lda;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const uint32_t p = ca + (mi * 16 + (lane >> 2)) * pitch + 2 * (k + 2 * (lane & 3));
      af[mi][0] = ld_cluster_u32(p);
      af[mi][1] = ld_cluster_u32(p + 8 * pitch);
      af[mi][2] = ld_cluster_u32(p + 16);
      af[mi][3] = ld_cluster_u32(p + 8 * pitch + 16);
    }
  }
};

// acc += A (32 rows of this warp's strip x 16) * B (16 x the warp's n8
// tiles), at K offset k of the staged step. Warp w holds a 32 x (8 * NI)
// accumulator tile: rows 32 * (w / WN) .. + 32 (WN = 256 / P warps share a
// row strip) and the chunk's n16 column tiles jj = w % WN + WN * i,
// i < NI / 2; accumulator slot s holds n8 tile 2 * jj + s % 2 of pair s / 2.
template <int NI, class ASrc>
__device__ __forceinline__ void mma_k16(float (*acc)[NI][4], const ASrc& A, const bf16* B,
                                        int ldb, int k, int wn, int WN, int nb8) {
  const int lane = threadIdx.x & 31;
  uint32_t af[kMI][4];
  A.load(af, k);
  const bf16* brow = B + (k + (lane & 15)) * ldb + (lane >> 4) * 8;
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) {
    const int jj = wn + WN * i;
    if (2 * jj < nb8) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, brow + jj * 16);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        mma_bf16(acc[mi][2 * i], af[mi], b);
        mma_bf16(acc[mi][2 * i + 1], af[mi], b + 2);
      }
    }
  }
}

// acc += A (32 x kk) * B (kk x ...). A full step of 64 is unrolled for warp
// tiles up to 32 x 48, so the fragments of one k16 load while the previous
// one multiplies; the 32 x 80 tile keeps the loop, which holds its
// registers down.
template <int NI, class ASrc>
__device__ __forceinline__ void warp_mma(float (*acc)[NI][4], const ASrc& A, const bf16* B,
                                         int ldb, int kk, int wn, int WN, int nb8) {
  if (NI <= 6 && kk == kKC) {
#pragma unroll
    for (int k = 0; k < kKC; k += 16) mma_k16<NI>(acc, A, B, ldb, k, wn, WN, nb8);
  } else {
    for (int k = 0; k < kk; k += 16) mma_k16<NI>(acc, A, B, ldb, k, wn, WN, nb8);
  }
}

template <int NI>
__device__ __forceinline__ void zero_tile(float (*acc)[NI][4]) {
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][i][e] = 0.f;
}

// ---------------------------------------------------------------- pass A --

struct StatsArgs {
  const bf16* x;
  const bf16* ws;
  float* psum;
  float* psq;
  int H, W, Cin, M, R;  // R: rows (frame, pixel) of one BN group
  int P, S, WN, bn, ldb, a_bytes, stage_bytes;
  int tpg, tpb, bpg;    // row tiles per group, per block; blocks per group
};

// Reduce-scatter of v[0, N) over the two lanes that differ in lane bit
// `mask`: the lane with the bit set keeps the upper half, the other the
// lower, and each adds its partner's copy of that half into v[0, N / 2).
template <int N>
__device__ __forceinline__ void reduce_scatter(float* v, int mask) {
  const bool upper = threadIdx.x & mask;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float keep = upper ? v[j + N / 2] : v[j];
    const float send = upper ? v[j] : v[j + N / 2];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// The statistics of a finished row tile. Entry e of a thread's 4 * NI
// sums: n8 tile e / 4, column c2 + e % 2, the values (e & 2 == 0) or their
// squares, over its rows g8, g8 + 8, g8 + 16, g8 + 24, each rounded to bf16
// first. The reduce-scatter over the 8 lanes of equal lane % 4 leaves lane
// (g8, c) with entries [NI / 2 * g8, + NI / 2) over the warp's 32 rows,
// which it adds to carry.
template <int NI>
__device__ __forceinline__ void tile_stats(float (*acc)[NI][4], float* carry) {
  float v[4 * NI];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float a0 = bf16_round(acc[0][i][c]), a1 = bf16_round(acc[0][i][2 + c]);
      const float a2 = bf16_round(acc[1][i][c]), a3 = bf16_round(acc[1][i][2 + c]);
      v[4 * i + c] = ((a0 + a1) + a2) + a3;
      v[4 * i + 2 + c] = ((a0 * a0 + a1 * a1) + a2 * a2) + a3 * a3;
    }
  reduce_scatter<4 * NI>(v, 16);
  reduce_scatter<2 * NI>(v, 8);
  reduce_scatter<NI>(v, 4);
#pragma unroll
  for (int l = 0; l < NI / 2; ++l) carry[l] += v[l];
}

// Block (x, y): tiles [t0, t0 + tpb) of BN group x / bpg, mid channels
// [y * bn, + bn); its partial sums go to row x of psum and psq. kPad: the
// A-source policy of gather_a.
template <int NI, bool kPad>
__global__ void __launch_bounds__(kThreads, kStatsPerSM) stats_kernel(const StatsArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % a.WN, strip = warp / a.WN;
  const int n0 = blockIdx.y * a.bn, width = min(a.bn, a.M - n0), nb8 = width / 8;
  const int g = blockIdx.x / a.bpg, t0 = (blockIdx.x - g * a.bpg) * a.tpb;
  const int r0 = g * a.R + t0 * a.P, rend = (g + 1) * a.R, HW = a.H * a.W;
  const int K = 9 * a.Cin, nks = cdiv(K, kKC), n_iter = min(a.tpb, a.tpg - t0) * nks;
  const BMap bm = bmap_for(a.bn);

  // the producer: K step pks of the block's tile pt, whose rows are gr
  int pt = 0, pks = 0;
  GatherRows gr = gather_rows(r0, rend, HW, a.W, 1);
  auto load = [&](unsigned char* st) {
    const int k0 = pks * kKC, rows = min(kKC, K - k0);
    gather_a<kPad>(reinterpret_cast<bf16*>(st), a.x, gr, 0, a.H, a.W, a.Cin, a.P, k0, rows);
    copy_b(reinterpret_cast<bf16*>(st + a.a_bytes), a.ldb, a.ws + (size_t)k0 * a.M + n0, a.M,
           rows, width, bm);
    if (++pks == nks) {
      pks = 0;
      gr = gather_rows(r0 + ++pt * a.P, rend, HW, a.W, 1);
    }
  };
  for (int s = 0; s < a.S - 1; ++s) {
    if (s < n_iter) load(smem + s * a.stage_bytes);
    cp_async_commit();
  }

  float acc[kMI][NI][4];
  zero_tile<NI>(acc);
  float carry[NI / 2];
#pragma unroll
  for (int l = 0; l < NI / 2; ++l) carry[l] = 0.f;
  int ks = 0;
  for (int it = 0; it < n_iter; ++it) {
    // step `it` has landed for this thread; the barrier makes it land for
    // all and frees the stage that step it - 1 read
    cp_async_wait_stages(a.S);
    __syncthreads();
    const int li = it + a.S - 1;
    if (li < n_iter) load(smem + (li % a.S) * a.stage_bytes);
    cp_async_commit();

    const unsigned char* st = smem + (it % a.S) * a.stage_bytes;
    const ALocal A{reinterpret_cast<const bf16*>(st) + 32 * strip * kLdA, kLdA};
    warp_mma<NI>(acc, A, reinterpret_cast<const bf16*>(st + a.a_bytes), a.ldb,
                 min(kKC, K - ks * kKC), wn, a.WN, nb8);
    if (++ks == nks) {
      ks = 0;
      tile_stats<NI>(acc, carry);
      zero_tile<NI>(acc);
    }
  }

  // every copy has landed and every warp has left the stages, which now
  // take the warps' sums: red[kind][strip][column], kind 0 sums, 1 squares
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int nstrips = a.P / 32, g8 = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int l = 0; l < NI / 2; ++l) {
    const int e = NI / 2 * g8 + l, i = e >> 2;
    const int j = 2 * (wn + a.WN * (i >> 1)) + (i & 1);
    if (j < nb8) red[(((e >> 1) & 1) * nstrips + strip) * a.bn + 8 * j + c2 + (e & 1)] = carry[l];
  }
  __syncthreads();
  for (int c = tid; c < width; c += kThreads) {
    float s = 0.f, q = 0.f;
    for (int k = 0; k < nstrips; ++k) {
      s += red[k * a.bn + c];
      q += red[(nstrips + k) * a.bn + c];
    }
    a.psum[(size_t)blockIdx.x * a.M + n0 + c] = s;
    a.psq[(size_t)blockIdx.x * a.M + n0 + c] = q;
  }
}

// Per group g: partial rows [g * rpg, (g + 1) * rpg); mean = S / count,
// var = Q / count - mean^2 (conv21d.py:369-371).
__global__ void stats_reduce_kernel(const float* __restrict__ psum,
                                    const float* __restrict__ psq,
                                    float* __restrict__ gmean,
                                    float* __restrict__ gvar, int rpg, int M,
                                    float inv_count) {
  __shared__ float ss[8][33], sq[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m = blockIdx.x * 32 + tx, g = blockIdx.y;
  float s = 0.f, q = 0.f;
  if (m < M)
    for (int r = ty; r < rpg; r += 8) {
      const size_t row = (size_t)g * rpg + r;
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

// The kernel instantiation for a warp tile of 32 x (8 * ni) and an A
// source; the plan (ops/conv21d.py plan_stats) picks ni from these.
template <bool kPad>
const void* stats_kernel_for(int ni) {
  switch (ni) {
    case 2: return (const void*)stats_kernel<2, kPad>;
    case 4: return (const void*)stats_kernel<4, kPad>;
    case 6: return (const void*)stats_kernel<6, kPad>;
    case 10: return (const void*)stats_kernel<10, kPad>;
  }
  return nullptr;
}

// Dynamic shared memory of a pass-A plan: S stages of (A gather P x 72,
// B 64 x (bn + 8)).
inline size_t stats_smem_bytes(int P, int bn, int S, size_t* a_bytes, size_t* stage_bytes) {
  *a_bytes = align128(sizeof(bf16) * (size_t)P * kLdA);
  *stage_bytes = align128(*a_bytes + sizeof(bf16) * (size_t)kKC * (bn + 8));
  return S * *stage_bytes;
}

// ---------------------------------------------------------------- pass B --
//
// One block of 256 threads (8 warps) owns P consecutive rows of the flat
// (clip, pixel) index and walks the frames in order. Its schedule is one
// sequence of K steps of 64, each staged by cp.async into a ring of S
// stages (S - 1 in flight while one is multiplied):
//   for u in 0..T:  spatial(u) if u < T, then temporal(u - 1) if u >= 1
//   spatial(u):  for each mid chunk of bn channels, K = 9 * Cin: A is the
//                im2col gather of frame u at the tile's rows, B a slice of ws;
//                epilogue: bf16 round, BN, ReLU, bf16 -> ring slot u % 3
//   temporal(f): for each out chunk of bno channels, for each tap k with
//                f - 1 + k in [0, T), K = M: A is ring slot (f - 1 + k) % 3,
//                B a slice of wt[k]; epilogue: bf16 -> out frame f

struct FwdArgs {
  const bf16* x;
  const bf16* ws;
  const bf16* wt;
  const float* gmean;
  const float* rstd;
  const float* scale;
  const float* bias;
  bf16* out;
  int T, H, W, Cin, M, Cout, cpg, nhw;
  int P, S, WN, bn, nch_s, bno, nch_t, ldb, a_bytes, stage_bytes, ring_off;
  int C, Mc, Coc, nks_c;  // cluster size, its blocks' slices of M and Cout
};

// Position in the block's schedule of K steps.
struct Cursor {
  int u, ph, ch, tap, ks;  // ph 0: spatial(u); ph 1: temporal(u - 1)

  __device__ int tap_lo() const { return u == 1 ? 1 : 0; }
  __device__ int tap_hi(int T) const { return u == T ? 1 : 2; }
  __device__ void next_item(int T) {
    if (ph == 0 && u >= 1) {
      ph = 1;
    } else {
      ++u;
      ph = u < T ? 0 : 1;
    }
    tap = tap_lo();
  }
  // the first K step of a spatial or temporal item
  __device__ bool item_start() const { return ks == 0 && ch == 0 && (ph == 0 || tap == tap_lo()); }
  // the last K step of a spatial mid chunk or of a temporal out chunk
  __device__ bool chunk_end(int T, int nks_s, int nks_t) const {
    return ph == 0 ? ks == nks_s - 1 : (ks == nks_t - 1 && tap == tap_hi(T));
  }
  __device__ void advance(const FwdArgs& a, int nks_s, int nks_t) {
    if (ph == 0) {
      if (++ks < nks_s) return;
      ks = 0;
      if (++ch < a.nch_s) return;
    } else {
      if (++ks < nks_t) return;
      ks = 0;
      if (++tap <= tap_hi(a.T)) return;
      tap = tap_lo();
      if (++ch < a.nch_t) return;
    }
    ch = 0;
    next_item(a.T);
  }
};

template <bool kPad>
__device__ inline void stage_load(const FwdArgs& a, const Cursor& c, const GatherRows& gr,
                                  BMap bmap_s, BMap bmap_t, int rank, unsigned char* stage) {
  bf16* sA = reinterpret_cast<bf16*>(stage);
  bf16* sB = reinterpret_cast<bf16*>(stage + a.a_bytes);
  if (c.ph == 0) {
    const int k0 = c.ks * kKC, rows = min(kKC, 9 * a.Cin - k0);
    gather_a<kPad>(sA, a.x, gr, c.u, a.H, a.W, a.Cin, a.P, k0, rows);
    copy_b(sB, a.ldb, a.ws + (size_t)k0 * a.M + rank * a.Mc + c.ch * a.bn, a.M, rows,
           min(a.bn, a.Mc - c.ch * a.bn), bmap_s);
  } else {
    // K runs over the mid slices of the cluster's blocks in rank order
    const int from = c.ks / a.nks_c, k0 = (c.ks - from * a.nks_c) * kKC;
    copy_b(sB, a.ldb,
           a.wt + ((size_t)c.tap * a.M + from * a.Mc + k0) * a.Cout + rank * a.Coc + c.ch * a.bno,
           a.Cout, min(kKC, a.Mc - k0), min(a.bno, a.Coc - c.ch * a.bno), bmap_t);
  }
}

// The TPU kernel's order: mid rounded to bf16, (mid - mean) * rstd * scale
// + bias, ReLU
__device__ __forceinline__ float bn_relu(float v, float mean, float rstd, float scale,
                                         float bias) {
  return fmaxf((bf16_round(v) - mean) * rstd * scale + bias, 0.f);
}

template <int NI, bool kPad>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  unsigned char* stages = smem + a.ring_off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % a.WN, row0 = 32 * (warp / a.WN);
  const int g8 = lane >> 2, c2 = 2 * (lane & 3);
  const int HW = a.H * a.W, ldr = a.Mc + 8;
  // a cluster of C blocks shares one row tile; block `rank` computes mid
  // channels [rank * Mc, + Mc) into its ring and output channels
  // [rank * Coc, + Coc) from all the cluster's rings
  const int rank = blockIdx.x % a.C, r0 = blockIdx.x / a.C * a.P;

  const GatherRows gr = gather_rows(r0, a.nhw, HW, a.W, a.T);

  const BMap bmap_s = bmap_for(a.bn), bmap_t = bmap_for(a.bno);

  const int nks_s = (9 * a.Cin + kKC - 1) / kKC, nks_t = a.C * a.nks_c;
  const int n_iter = a.T * a.nch_s * nks_s + a.nch_t * nks_t * (a.T == 1 ? 1 : 3 * a.T - 2);
  Cursor pc{0, 0, 0, 0, 0}, cc{0, 0, 0, 0, 0};
  for (int s = 0; s < a.S - 1; ++s) {
    if (s < n_iter) {
      stage_load<kPad>(a, pc, gr, bmap_s, bmap_t, rank, stages + s * a.stage_bytes);
      pc.advance(a, nks_s, nks_t);
    }
    cp_async_commit();
  }

  float acc[kMI][NI][4];
  zero_tile<NI>(acc);

  for (int it = 0; it < n_iter; ++it) {
    // step `it` has landed for this thread; the barrier makes it land for
    // all and frees the stage that step it - 1 read
    cp_async_wait_stages(a.S);
    __syncthreads();
    // a cluster's blocks enter each item together: the rings the temporal
    // items read are complete, and no block overwrites a ring slot that
    // another still reads
    if (a.C > 1 && cc.item_start()) cluster_sync();
    const int li = it + a.S - 1;
    if (li < n_iter) {
      stage_load<kPad>(a, pc, gr, bmap_s, bmap_t, rank, stages + (li % a.S) * a.stage_bytes);
      pc.advance(a, nks_s, nks_t);
    }
    cp_async_commit();

    const unsigned char* st = stages + (it % a.S) * a.stage_bytes;
    const bf16* sB = reinterpret_cast<const bf16*>(st + a.a_bytes);
    if (cc.ph == 0) {
      const int nb8 = min(a.bn, a.Mc - cc.ch * a.bn) / 8;
      const int kk = min(kKC, 9 * a.Cin - cc.ks * kKC);
      const ALocal A{reinterpret_cast<const bf16*>(st) + row0 * kLdA, kLdA};
      warp_mma<NI>(acc, A, sB, a.ldb, kk, wn, a.WN, nb8);
    } else {
      const int nb8 = min(a.bno, a.Coc - cc.ch * a.bno) / 8;
      const int from = cc.ks / a.nks_c, k0 = (cc.ks - from * a.nks_c) * kKC;
      const int kk = min(kKC, a.Mc - k0);
      const bf16* strip = ring + ((size_t)((cc.u - 2 + cc.tap) % 3) * a.P + row0) * ldr + k0;
      if (from == rank) {
        warp_mma<NI>(acc, ALocal{strip, ldr}, sB, a.ldb, kk, wn, a.WN, nb8);
      } else {
        warp_mma<NI>(acc, ACluster{cluster_map(strip, from), ldr}, sB, a.ldb, kk, wn, a.WN, nb8);
      }
    }

    if (cc.chunk_end(a.T, nks_s, nks_t)) {
      if (cc.ph == 0) {
        // mid chunk -> bf16 round, BN with its row's group stats, ReLU, bf16
        const int n0 = cc.ch * a.bn, nb8 = min(a.bn, a.Mc - n0) / 8;
        bf16* slot = ring + (size_t)(cc.u % 3) * a.P * ldr;
        int grp[kMI][2];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + row0 + mi * 16 + g8 + 8 * h;
            grp[mi][h] = r < a.nhw ? (r / HW) / a.cpg : 0;
          }
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int j = 2 * (wn + a.WN * (i >> 1)) + (i & 1);
          if (j < nb8) {
            const int ml = n0 + 8 * j + c2, m = rank * a.Mc + ml;
            const float2 sc = *reinterpret_cast<const float2*>(a.scale + m);
            const float2 bi = *reinterpret_cast<const float2*>(a.bias + m);
#pragma unroll
            for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const size_t gm = (size_t)grp[mi][h] * a.M + m;
                const float2 mu = *reinterpret_cast<const float2*>(a.gmean + gm);
                const float2 rs = *reinterpret_cast<const float2*>(a.rstd + gm);
                const float* v = acc[mi][i] + 2 * h;
                const int row = row0 + mi * 16 + g8 + 8 * h;
                *reinterpret_cast<__nv_bfloat162*>(slot + (size_t)row * ldr + ml) =
                    __floats2bfloat162_rn(bn_relu(v[0], mu.x, rs.x, sc.x, bi.x),
                                          bn_relu(v[1], mu.y, rs.y, sc.y, bi.y));
              }
          }
        }
      } else {
        // out chunk of frame u - 1 -> bf16
        const int nb8 = min(a.bno, a.Coc - cc.ch * a.bno) / 8, fo = cc.u - 1;
        const int co0 = rank * a.Coc + cc.ch * a.bno;
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + row0 + mi * 16 + g8 + 8 * h;
            if (r < a.nhw) {
              const int n = r / HW, p = r - n * HW;
              bf16* o = a.out + ((size_t)(n * a.T + fo) * HW + p) * a.Cout + co0 + c2;
#pragma unroll
              for (int i = 0; i < NI; ++i) {
                const int j = 2 * (wn + a.WN * (i >> 1)) + (i & 1);
                if (j < nb8)
                  *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
                      __floats2bfloat162_rn(acc[mi][i][2 * h], acc[mi][i][2 * h + 1]);
              }
            }
          }
      }
      zero_tile<NI>(acc);
    }
    cc.advance(a, nks_s, nks_t);
  }
  // no block leaves while another may still read its ring
  if (a.C > 1) cluster_sync();
}

// The kernel instantiation for a warp tile of 32 x (8 * ni) and an A
// source; the plan (ops/conv21d.py plan_fwd) picks ni from these.
template <bool kPad>
const void* fwd_kernel_for(int ni) {
  switch (ni) {
    case 2: return (const void*)fwd_kernel<2, kPad>;
    case 4: return (const void*)fwd_kernel<4, kPad>;
    case 6: return (const void*)fwd_kernel<6, kPad>;
    case 10: return (const void*)fwd_kernel<10, kPad>;
  }
  return nullptr;
}

// Dynamic shared memory of a pass-B plan: the ring of min(3, T) mid frames
// (P x (M + 8) bf16 each, M a block's slice of the mid channels) and S
// stages of (A gather P x 72, B 64 x ldb).
inline size_t fwd_smem_bytes(int P, int T, int M, int ldb, int S, size_t* a_bytes,
                             size_t* stage_bytes, size_t* ring) {
  *ring = align128(sizeof(bf16) * (size_t)(T < 3 ? T : 3) * P * (M + 8));
  *a_bytes = align128(sizeof(bf16) * (size_t)P * kLdA);
  *stage_bytes = align128(*a_bytes + sizeof(bf16) * (size_t)kKC * ldb);
  return *ring + S * *stage_bytes;
}

// Cin, M and Cout % 16, as the wrappers check: the mainloop's last K step
// may be 16 rows (9 * Cin % 16) and a gather piece of 8 channels stays
// within one tap.
inline bool shapes_ok(int Cin, int M, int Cout) {
  return Cin > 0 && Cin % 16 == 0 && M % 16 == 0 && Cout % 16 == 0;
}

// Pass A with the A source kPad: x (B, T, H, W, Cin) bf16, or padded
// (B, T, H + 2, W + 2, Cin) with H and W the unpadded sizes; the rest as
// cstp_conv21d_stats below.
template <bool kPad>
int launch_stats(const void* x, const void* ws, void* psum, void* psq, void* gmean, void* gvar,
                 int B, int T, int H, int W, int Cin, int M, int G, int P, int stages, int bn,
                 int ni, int tpb, int blocks, int smem_bytes, void* stream) {
  const long long nrows = (long long)B * T * H * W;
  const void* kernel = stats_kernel_for<kPad>(ni);
  if (!shapes_ok(Cin, M, 16) || B <= 0 || T <= 0 || H <= 0 || W <= 0 || G <= 0 || B % G ||
      nrows + P >= (1ll << 31) || kernel == nullptr || (P != 32 && P != 64 && P != 128) ||
      stages < 3 || stages > 4 || bn <= 0 || bn % 16 || bn > M || tpb <= 0 ||
      2 * cdiv(bn / 16, kThreads / P) > ni)
    return (int)cudaErrorInvalidValue;
  StatsArgs a{(const bf16*)x, (const bf16*)ws, (float*)psum, (float*)psq, H, W, Cin, M,
              (B / G) * T * H * W};
  a.P = P;
  a.S = stages;
  a.WN = kThreads / P;
  a.bn = bn;
  a.ldb = bn + 8;
  a.tpg = cdiv(a.R, P);
  a.tpb = tpb;
  a.bpg = cdiv(a.tpg, tpb);
  const int nch = cdiv(M, bn);
  size_t ab, sb;
  const size_t bytes = stats_smem_bytes(P, bn, stages, &ab, &sb);
  if ((long long)blocks != (long long)nch * G * a.bpg || nch > 65535 ||
      bytes != (size_t)smem_bytes || kStatsPerSM * (bytes + 1024) > kSmemSM)
    return (int)cudaErrorInvalidValue;
  a.a_bytes = (int)ab;
  a.stage_bytes = (int)sb;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  void* args[] = {&a};
  err = cudaLaunchKernel(kernel, dim3(G * a.bpg, nch), dim3(kThreads), args, bytes, s);
  if (err != cudaSuccess) return (int)err;
  stats_reduce_kernel<<<dim3(cdiv(M, 32), G), dim3(32, 8), 0, s>>>(
      (const float*)psum, (const float*)psq, (float*)gmean, (float*)gvar, a.bpg, M,
      1.f / (float)a.R);
  return (int)cudaGetLastError();
}

// Pass B with the A source kPad: x as launch_stats; the rest as
// cstp_conv21d_fwd below.
template <bool kPad>
int launch_fwd(const void* x, const void* ws, const void* wt, const void* gmean,
               const void* rstd, const void* scale, const void* bias, void* out, int B, int T,
               int H, int W, int Cin, int M, int Cout, int G, int P, int stages, int ring_slots,
               int blocks, int cluster, int smem_bytes, int ni, int bn, int bno, void* stream) {
  const long long nhw = (long long)B * H * W;
  const void* kernel = fwd_kernel_for<kPad>(ni);
  if (!shapes_ok(Cin, M, Cout) || B <= 0 || T <= 0 || H <= 0 || W <= 0 || G <= 0 ||
      B % G || nhw >= (1ll << 31) || kernel == nullptr || (P != 32 && P != 64 && P != 128) ||
      stages < 3 || stages > 6 || ring_slots != (T < 3 ? T : 3) ||
      (cluster != 1 && cluster != 2 && cluster != 4) || M % (16 * cluster) ||
      Cout % (16 * cluster) || bn <= 0 || bn % 16 || bno <= 0 || bno % 16 ||
      (long long)blocks * P < nhw || (long long)(blocks - 1) * P >= nhw)
    return (int)cudaErrorInvalidValue;
  const int WN = kThreads / P;
  if (2 * cdiv(bn / 16, WN) > ni || 2 * cdiv(bno / 16, WN) > ni)
    return (int)cudaErrorInvalidValue;
  FwdArgs a{(const bf16*)x, (const bf16*)ws, (const bf16*)wt, (const float*)gmean,
            (const float*)rstd, (const float*)scale, (const float*)bias, (bf16*)out,
            T, H, W, Cin, M, Cout, B / G, (int)nhw};
  a.P = P;
  a.S = stages;
  a.WN = WN;
  a.C = cluster;
  a.Mc = M / cluster;
  a.Coc = Cout / cluster;
  a.nks_c = cdiv(a.Mc, kKC);
  a.bn = bn;
  a.nch_s = cdiv(a.Mc, bn);
  a.bno = bno;
  a.nch_t = cdiv(a.Coc, bno);
  a.ldb = (bn > bno ? bn : bno) + 8;
  size_t ab, sb, ring;
  const size_t bytes = fwd_smem_bytes(P, T, a.Mc, a.ldb, stages, &ab, &sb, &ring);
  if (bytes != (size_t)smem_bytes || bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  a.a_bytes = (int)ab;
  a.stage_bytes = (int)sb;
  a.ring_off = (int)ring;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {&a};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Resident blocks per SM of a kernel instantiation at a plan's shared
// memory, from cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative on
// an error.
int occupancy(const void* kernel, int smem_bytes) {
  if (kernel == nullptr || smem_bytes < 0 || (size_t)smem_bytes > kSmemMax) return -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    (size_t)smem_bytes) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// x (B, T, H, W, Cin) bf16; ws (9*Cin, M) bf16 (tap-major, cin-minor);
// psum/psq (G * blocks per group, M) f32 scratch; gmean/gvar (G, M) f32
// out. The plan (P, stages, bn: the mid chunk, ni, tpb: row tiles per
// block, blocks, smem_bytes) comes from ops/conv21d.py plan_stats and is
// checked here again; its stages leave room for kStatsPerSM blocks per SM.
extern "C" int cstp_conv21d_stats(const void* x, const void* ws, void* psum, void* psq,
                                  void* gmean, void* gvar, int B, int T, int H, int W,
                                  int Cin, int M, int G, int P, int stages, int bn, int ni,
                                  int tpb, int blocks, int smem_bytes, void* stream) {
  return launch_stats<false>(x, ws, psum, psq, gmean, gvar, B, T, H, W, Cin, M, G, P, stages,
                             bn, ni, tpb, blocks, smem_bytes, stream);
}

// The same with x_pad (B, T, H+2, W+2, Cin) bf16 (H, W unpadded) and
// Cin % 16; the plan is plan_stats's for the unpadded shape.
extern "C" int cstp_conv21d_taps9_stats(const void* x_pad, const void* ws, void* psum,
                                        void* psq, void* gmean, void* gvar, int B, int T,
                                        int H, int W, int Cin, int M, int G, int P, int stages,
                                        int bn, int ni, int tpb, int blocks, int smem_bytes,
                                        void* stream) {
  return launch_stats<true>(x_pad, ws, psum, psq, gmean, gvar, B, T, H, W, Cin, M, G, P,
                            stages, bn, ni, tpb, blocks, smem_bytes, stream);
}

// x, ws as above; wt (3, M, Cout) bf16; gmean/rstd (G, M) f32;
// scale/bias (M,) f32; out (B, T, H, W, Cout) bf16. The plan (P, stages,
// ring_slots, blocks (row tiles), cluster (blocks per row tile), smem_bytes,
// ni, bn, bno: chunks of a block's M and Cout slices) comes from
// ops/conv21d.py plan_fwd and is checked here again.
extern "C" int cstp_conv21d_fwd(const void* x, const void* ws, const void* wt,
                                const void* gmean, const void* rstd, const void* scale,
                                const void* bias, void* out, int B, int T, int H, int W,
                                int Cin, int M, int Cout, int G, int P, int stages,
                                int ring_slots, int blocks, int cluster, int smem_bytes,
                                int ni, int bn, int bno, void* stream) {
  return launch_fwd<false>(x, ws, wt, gmean, rstd, scale, bias, out, B, T, H, W, Cin, M, Cout,
                           G, P, stages, ring_slots, blocks, cluster, smem_bytes, ni, bn, bno,
                           stream);
}

// The same with x_pad (B, T, H+2, W+2, Cin) bf16 (H, W unpadded) and
// Cin % 16; the plan is plan_fwd's for the unpadded shape.
extern "C" int cstp_conv21d_taps9_fwd(const void* x_pad, const void* ws, const void* wt,
                                      const void* gmean, const void* rstd, const void* scale,
                                      const void* bias, void* out, int B, int T, int H, int W,
                                      int Cin, int M, int Cout, int G, int P, int stages,
                                      int ring_slots, int blocks, int cluster, int smem_bytes,
                                      int ni, int bn, int bno, void* stream) {
  return launch_fwd<true>(x_pad, ws, wt, gmean, rstd, scale, bias, out, B, T, H, W, Cin, M,
                          Cout, G, P, stages, ring_slots, blocks, cluster, smem_bytes, ni, bn,
                          bno, stream);
}

// Resident pass-A (K2) and pass-B (K3) blocks per SM for a plan's kernel
// (ni) and shared memory; negative on an error.
extern "C" int cstp_conv21d_stats_occupancy(int ni, int smem_bytes) {
  return occupancy(stats_kernel_for<false>(ni), smem_bytes);
}

extern "C" int cstp_conv21d_fwd_occupancy(int ni, int smem_bytes) {
  return occupancy(fwd_kernel_for<false>(ni), smem_bytes);
}
