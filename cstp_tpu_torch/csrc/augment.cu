// Fused CSTP clip augmentation for Hopper (sm_90a), plain C interface.
//
// Replaces cstp_tpu/ops/pallas/augment.py fused_augment_clips /
// _augment_kernel (the Pallas TPU kernel, one grid step per clip): uint8
// frames -> crop + bicubic resize -> rot90 -> 3-shear small rotation ->
// brightness/contrast/saturation/hue jitter -> per-frame 3x3 gray mix ->
// Gaussian blur (radius 7) -> hflip -> tf/imagenet normalize -> NDHWC in
// bf16, f16 or f32 (the output type is a template parameter).
//
// What bounds it on the H100: by its work, the f32 arithmetic of the chain
// (separable resize taps, shears, blurs, jitter), a little above device
// memory: per frame it reads H0*W0*3 uint8 and writes S*S*3 values (main
// path 128x171 -> 112: 65.7 KB in, 75.3 KB out in bf16). In practice one
// block per SM runs the chain's phases one after another, with a barrier
// between them, so latency sets its time.
//
// Design: one block per (clip, frame). Every reduction of the chain (the
// contrast's luma mean) and every mix (shears, blur, gray) stays within one
// frame, so nothing crosses blocks. The frame lives in dynamic shared
// memory as f32 (112 x 112 x 3 = 147 KB, rows padded by one float so that
// column walks hit distinct banks), so no intermediate reaches device
// memory. Where it does not fit beside the other buffers (S above about
// 130, such as I3D's 224: 603 KB), the frame lives instead in a slice of a
// device-memory scratch that the wrapper allocates, one frame per block of
// a launch, and the launches walk the clips in chunks that fit it; every
// other buffer stays in shared memory, and the phase barriers, which order
// a block's device-memory accesses too, serve as they are (the kernel's
// template parameter kSmemFrame). The TPU kernel's dense band matrices are
// not materialised:
//  - crop + resize is separable. The box's source rows, uint8 and
//    contiguous in x, are copied into shared memory with 16-byte cp.async
//    in chunks of up to 16 rows, double-buffered, so the next chunk's copy
//    overlaps this chunk's arithmetic; every source byte is read from device
//    memory once. A horizontal pass resamples each staged row to S columns
//    (f32), and a vertical pass adds each chunk's share of every output row
//    it touches into the frame, where rot90 is an index map on the write.
//    Taps per output value: about nx + ny, not nx * ny.
//  - A resample row has as many taps as its box and scale give it: weights
//    are computed from the box on the fly (the bicubic kernel, masked to
//    the crop window), with each row's first and last tap and normaliser
//    in shared memory. The vertical pass reads its weights from a table of
//    the chunk's staged rows for each output row, filled once per chunk.
//    No table spans a whole row of taps, so no cap on the downscale.
//  - The chunk height is the largest of 16, 8, 4, 2, 1 rows whose buffers
//    fit (beside the frame, where it is in shared memory: chunk_rows);
//    their bytes depend on S and W0 only.
// The shears and the blur are in place, one row or column per warp, through
// a per-warp temp row that reuses the resample's buffers; the blur's
// normalisers are reciprocals taken once per output position.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlurRadius = 7;
constexpr int kMaxChunk = 16;
constexpr int kRowGroup = 4;  // staged rows per horizontal-pass item
constexpr size_t kMaxSmem = 232448;
constexpr float kPi = 3.14159265358979323846f;

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

// Bytes of one staged source row: 3*W0 plus up to 15 bytes on each side,
// since copies start and end on 16-byte boundaries of device memory.
__host__ __device__ inline size_t stage_pitch(int w0) {
  return ((3 * (size_t)w0 + 15) & ~size_t(15)) + 32;
}

__host__ __device__ inline size_t frame_bytes(int s) {
  return align128(sizeof(float) * (size_t)s * (3 * s + 1));
}

// The resample's buffers: per output row and column the first and last tap
// and the normaliser, two stages of `chunk` source rows, the horizontal
// pass's f32 rows, and the vertical weights of the staged rows for each
// output row.
__host__ __device__ inline size_t resample_bytes(int s, int w0, int chunk) {
  return align128(6 * sizeof(float) * (size_t)s) + align128(2 * (size_t)chunk * stage_pitch(w0)) +
         align128(sizeof(float) * (size_t)chunk * 3 * s) + align128(sizeof(float) * (size_t)s * chunk);
}

// The later stages' buffers, in the same bytes: per-warp temp rows, the
// block sum's slots, the blur's taps and per-position reciprocals.
__host__ __device__ inline size_t post_bytes(int s) {
  return align128(sizeof(float) * (size_t)kWarps * 3 * s) + align128(sizeof(float) * (kWarps + 1)) +
         align128(sizeof(float) * (2 * kBlurRadius + 1)) + align128(sizeof(float) * (size_t)s);
}

// One block's dynamic shared memory; the frame counts only when it is there.
__host__ __device__ inline size_t smem_bytes(int s, int w0, int chunk, bool smem_frame) {
  const size_t r = resample_bytes(s, w0, chunk), p = post_bytes(s);
  return (smem_frame ? frame_bytes(s) : 0) + (r > p ? r : p);
}

// The chunk height for (S, W0) and the frame's place, or 0 when not even
// one row fits.
__host__ inline int chunk_rows(int s, int w0, bool smem_frame) {
  for (int c = kMaxChunk; c >= 1; c /= 2)
    if (smem_bytes(s, w0, c, smem_frame) <= kMaxSmem) return c;
  return 0;
}

struct Smem {
  float* frame;  // [S][ldf], ldf = 3S + 1; shared or device memory
  int ldf;
  // resample
  int* lo_y;     // [S] first tap (clamped to the frame)
  int* hi_y;     // [S] last tap
  float* inv_y;  // [S] 1 / sum of the row's weights, 0 for an empty row
  int* lo_x;
  int* hi_x;
  float* inv_x;
  uint8_t* stage;  // [2][chunk][pitch]
  float* hrow;     // [chunk][3S]
  float* wy;       // [S][chunk] unnormalised weight of staged row r for output row y
  // later stages (same bytes as the resample's)
  float* temp;    // [kWarps][3S]
  float* red;     // [kWarps + 1]
  float* blur_w;  // [2 * kBlurRadius + 1]
  float* blur_d;  // [S] reciprocal of each position's weight sum
};

// The buffers in shared memory at `base`; the frame there too, or at
// `gframe` (device memory) when it is not null.
__device__ Smem carve(unsigned char* base, float* gframe, int s, int w0, int chunk) {
  Smem m;
  m.ldf = 3 * s + 1;
  m.frame = gframe ? gframe : reinterpret_cast<float*>(base);
  unsigned char* u = gframe ? base : base + frame_bytes(s);
  size_t off = 0;
  auto take = [&](size_t bytes) { unsigned char* p = u + off; off += align128(bytes); return p; };
  float* rows = reinterpret_cast<float*>(take(6 * sizeof(float) * (size_t)s));
  m.lo_y = reinterpret_cast<int*>(rows);
  m.hi_y = reinterpret_cast<int*>(rows + s);
  m.inv_y = rows + 2 * s;
  m.lo_x = reinterpret_cast<int*>(rows + 3 * s);
  m.hi_x = reinterpret_cast<int*>(rows + 4 * s);
  m.inv_x = rows + 5 * s;
  m.stage = take(2 * (size_t)chunk * stage_pitch(w0));
  m.hrow = reinterpret_cast<float*>(take(sizeof(float) * (size_t)chunk * 3 * s));
  m.wy = reinterpret_cast<float*>(take(sizeof(float) * (size_t)s * chunk));
  off = 0;
  m.temp = reinterpret_cast<float*>(take(sizeof(float) * kWarps * 3 * s));
  m.red = reinterpret_cast<float*>(take(sizeof(float) * (kWarps + 1)));
  m.blur_w = reinterpret_cast<float*>(take(sizeof(float) * (2 * kBlurRadius + 1)));
  m.blur_d = reinterpret_cast<float*>(take(sizeof(float) * s));
  return m;
}

__device__ inline float cubic(float d) {
  const float a = -0.5f;
  const float ad = fabsf(d), ad2 = ad * ad, ad3 = ad2 * ad;
  if (ad <= 1.f) return (a + 2.f) * ad3 - (a + 3.f) * ad2 + 1.f;
  if (ad < 2.f) return a * ad3 - 5.f * a * ad2 + 8.f * a * ad - 4.f * a;
  return 0.f;
}

// One axis of augment/ops.py resample_weights: the crop window [start,
// start + size) of `in_size` pixels resampled to `out_size`.
struct Axis {
  float start, scale, fscale, lo_edge, hi_edge;
  int in_size;

  // The scale and the sample positions are rounded as the plain version
  // rounds them on the card: PyTorch divides a CUDA tensor by a Python
  // scalar as a product with the scalar's rounded reciprocal, and
  // augment/ops.py forms a centre as a product, then a sum (not one fused
  // multiply-add). A position off by an ulp moves the output by the image's
  // slope times that ulp: up to 1e-2 on 0..255 for noisy frames.
  __device__ Axis(int in, int out, float st, float size) {
    start = st;
    scale = __fmul_rn(size, 1.f / (float)out);
    fscale = fmaxf(scale, 1.f);
    lo_edge = floorf(st);
    hi_edge = ceilf(st + size);
    in_size = in;
  }
  __device__ float center(int o) const {
    return __fadd_rn(start, __fmul_rn((float)o + 0.5f, scale));
  }
  // First and last source pixel with a possibly nonzero weight for output o.
  __device__ int lo(int o) const {
    return max((int)floorf(center(o) - 2.f * fscale - 0.5f) - 1, 0);
  }
  __device__ int hi(int o) const {
    return min((int)ceilf(center(o) + 2.f * fscale - 0.5f) + 1, in_size - 1);
  }
  // Unnormalised weight of source pixel `tap` for output o.
  __device__ float weight(float c, int tap) const {
    const float t = (float)tap + 0.5f;
    const float w = cubic((t - c) / fscale);
    return (t >= lo_edge && t <= hi_edge) ? w : 0.f;
  }
};

__device__ void build_row(const Axis& ax, int o, int* lo_out, int* hi_out, float* inv_out) {
  const int lo = ax.lo(o), hi = ax.hi(o);
  const float c = ax.center(o);
  float sum = 0.f;
  for (int tap = lo; tap <= hi; ++tap) sum += ax.weight(c, tap);
  *lo_out = lo;
  *hi_out = hi;
  *inv_out = sum > 1e-6f ? 1.f / sum : 0.f;
}

// Copy source rows [row0, row0 + rows), bytes [3 * x0, 3 * x0 + nbytes) of
// each, into `dst` (row pitch `pitch`), as 16-byte cp.async pieces aligned
// in device memory: a row's bytes start at dst + (its address % 16). The
// pieces that would cross the frames tensor's ends are copied byte by byte,
// in bounds only.
__device__ void stage_rows(const uint8_t* fr, const uint8_t* fbegin, const uint8_t* fend,
                           int row0, int rows, int w0, int x0, int nbytes, uint8_t* dst,
                           size_t pitch) {
  const int pieces = (int)(pitch / 16);
  for (int i = threadIdx.x; i < rows * pieces; i += kThreads) {
    const int r = i / pieces, p = i - r * pieces;
    const uint8_t* src = fr + ((size_t)(row0 + r) * w0 + x0) * 3;
    const uint8_t* g0 = reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15));
    const uint8_t* g = g0 + 16 * p;
    if (g >= src + nbytes) continue;
    uint8_t* d = dst + r * pitch + 16 * p;
    if (g >= fbegin && g + 16 <= fend) {
      cp_async16(d, g, true);
    } else {
      for (int b = 0; b < 16; ++b)
        if (g + b >= fbegin && g + b < fend) d[b] = g[b];
    }
  }
}

// Linear-interp resample of one length-S line (3 interleaved channels) at
// src = i + shift with zero fill, from `line` into `dst` (stride `dstride`
// floats between samples).
__device__ inline void shear_line(const float* line, float* dst, int dstride,
                                  int s, float shift, int lane) {
  for (int i = lane; i < s; i += 32) {
    const float src = (float)i + shift;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
    if (src >= 0.f && src <= (float)(s - 1)) {
      const int i0 = (int)floorf(src);
      const float wa = fmaxf(0.f, 1.f - fabsf((float)i0 - src));
      v0 = wa * line[3 * i0 + 0];
      v1 = wa * line[3 * i0 + 1];
      v2 = wa * line[3 * i0 + 2];
      if (i0 + 1 <= s - 1) {
        const float wb = fmaxf(0.f, 1.f - fabsf((float)(i0 + 1) - src));
        v0 += wb * line[3 * i0 + 3];
        v1 += wb * line[3 * i0 + 4];
        v2 += wb * line[3 * i0 + 5];
      }
    }
    dst[i * dstride + 0] = v0;
    dst[i * dstride + 1] = v1;
    dst[i * dstride + 2] = v2;
  }
}

// One pass over rows (along_rows) or columns of the frame: copy the line to
// the warp's temp, then write the resampled line back in place.
template <typename F>
__device__ void per_line(const Smem& m, int s, bool along_rows, F fn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* tmp = m.temp + warp * 3 * s;
  for (int l = warp; l < s; l += kWarps) {
    for (int i = lane; i < s; i += 32) {
      const float* src = along_rows ? m.frame + l * m.ldf + 3 * i
                                    : m.frame + i * m.ldf + 3 * l;
      tmp[3 * i + 0] = src[0];
      tmp[3 * i + 1] = src[1];
      tmp[3 * i + 2] = src[2];
    }
    __syncwarp();
    float* dst = along_rows ? m.frame + l * m.ldf : m.frame + 3 * l;
    fn(tmp, dst, along_rows ? 3 : m.ldf, l, lane);
    __syncwarp();
  }
  __syncthreads();
}

__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    red[kWarps] = s;
  }
  __syncthreads();
  const float total = red[kWarps];
  __syncthreads();
  return total;
}

__device__ inline float fmod1(float x) { return x - floorf(x); }

// HSV round trip with a hue shift, on [0, 255] values (ops/pallas/augment.py).
__device__ void hue_shift(float& R, float& G, float& B, float hue) {
  const float r = R / 255.f, g = G / 255.f, b = B / 255.f;
  const float mx = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float diff = mx - mn;
  const float safe = diff == 0.f ? 1.f : diff;
  float hh = mx == r ? (g - b) / safe
                     : (mx == g ? 2.f + (b - r) / safe : 4.f + (r - g) / safe);
  hh = diff == 0.f ? 0.f : hh / 6.f;
  hh = fmod1(hh);
  const float sat = mx == 0.f ? 0.f : diff / fmaxf(mx, 1e-12f);
  hh = fmod1(hh + hue);
  const float hsec = floorf(hh * 6.f);
  const float f = hh * 6.f - hsec;
  const float p = mx * (1.f - sat);
  const float q = mx * (1.f - f * sat);
  const float t = mx * (1.f - (1.f - f) * sat);
  int i = ((int)hsec % 6 + 6) % 6;
  float nr, ng, nb;
  switch (i) {
    case 0: nr = mx; ng = t; nb = p; break;
    case 1: nr = q; ng = mx; nb = p; break;
    case 2: nr = p; ng = mx; nb = t; break;
    case 3: nr = p; ng = q; nb = mx; break;
    case 4: nr = t; ng = p; nb = mx; break;
    default: nr = mx; ng = p; nb = q; break;
  }
  R = nr * 255.f;
  G = ng * 255.f;
  B = nb * 255.f;
}

__device__ inline void store(__nv_bfloat16* o, float v) { *o = __float2bfloat16(v); }
__device__ inline void store(__half* o, float v) { *o = __float2half_rn(v); }
__device__ inline void store(float* o, float v) { *o = v; }

// Crop + resize of one frame into m.frame through rot90^k: the separable
// resample over chunks of staged source rows (see the file's head).
__device__ void resample(const Smem& m, const uint8_t* fr, const uint8_t* fbegin,
                         const uint8_t* fend, const float* bx4, int k, int H0, int W0, int S,
                         int chunk) {
  const int tid = threadIdx.x;
  const Axis ay(H0, S, bx4[1], bx4[3]), ax(W0, S, bx4[0], bx4[2]);
  // rows and columns the box's taps reach (lo and hi are monotone in o)
  const int ylo = ay.lo(0), yhi = ay.hi(S - 1);
  const int x0 = ax.lo(0), x1 = ax.hi(S - 1);
  const int nbytes = 3 * max(x1 - x0 + 1, 0);
  const int nchunks = (x1 >= x0 && yhi >= ylo) ? (yhi - ylo + chunk) / chunk : 0;
  const size_t pitch = stage_pitch(W0);
  auto issue = [&](int c) {
    if (c < nchunks) {
      const int a = ylo + c * chunk;
      stage_rows(fr, fbegin, fend, a, min(chunk, yhi + 1 - a), W0, x0, nbytes,
                 m.stage + (size_t)(c & 1) * chunk * pitch, pitch);
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);
  for (int i = tid; i < S * m.ldf; i += kThreads) m.frame[i] = 0.f;
  for (int i = tid; i < 2 * S; i += kThreads) {
    if (i < S)
      build_row(ay, i, m.lo_y + i, m.hi_y + i, m.inv_y + i);
    else
      build_row(ax, i - S, m.lo_x + (i - S), m.hi_x + (i - S), m.inv_x + (i - S));
  }
  const int ld3 = 3 * S;
  for (int c = 0; c < nchunks; ++c) {
    const int a = ylo + c * chunk, rows = min(chunk, yhi + 1 - a);
    cp_async_wait<1>();
    __syncthreads();
    // output rows y0..y1 touch source rows [a, a + rows)
    int y0, y1;
    {
      int lo = 0, hi = S;  // first y with hi_y[y] >= a
      while (lo < hi) { const int mid = (lo + hi) >> 1; if (m.hi_y[mid] >= a) hi = mid; else lo = mid + 1; }
      y0 = lo;
      lo = 0; hi = S;      // first y with lo_y[y] > a + rows - 1
      while (lo < hi) { const int mid = (lo + hi) >> 1; if (m.lo_y[mid] > a + rows - 1) hi = mid; else lo = mid + 1; }
      y1 = lo - 1;
    }
    // each (output row, staged row) weight once, for every column of the
    // vertical pass to read
    for (int it = tid; it < (y1 - y0 + 1) * rows; it += kThreads) {
      const int y = y0 + it / rows, r = a + it % rows;
      m.wy[(y - y0) * chunk + (r - a)] =
          (r >= m.lo_y[y] && r <= m.hi_y[y]) ? ay.weight(ay.center(y), r) : 0.f;
    }
    // horizontal pass: staged row r, output column sx, kRowGroup rows an item
    const uint8_t* st = m.stage + (size_t)(c & 1) * chunk * pitch;
    const int groups = (rows + kRowGroup - 1) / kRowGroup;
    for (int it = tid; it < groups * S; it += kThreads) {
      const int g = it / S, sx = it - g * S;
      const int lo = m.lo_x[sx], hi = m.hi_x[sx];
      const float cx = ax.center(sx);
      const uint8_t* rp[kRowGroup];
      float acc[kRowGroup][3];
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q) {
        const int r = min(g * kRowGroup + q, rows - 1);
        const uintptr_t src = reinterpret_cast<uintptr_t>(fr + ((size_t)(a + r) * W0 + x0) * 3);
        rp[q] = st + r * pitch + (src & 15) + 3 * (lo - x0);
        acc[q][0] = acc[q][1] = acc[q][2] = 0.f;
      }
      for (int tap = lo; tap <= hi; ++tap) {
        const float w = ax.weight(cx, tap);
        const int b = 3 * (tap - lo);
#pragma unroll
        for (int q = 0; q < kRowGroup; ++q) {
          acc[q][0] += w * (float)rp[q][b + 0];
          acc[q][1] += w * (float)rp[q][b + 1];
          acc[q][2] += w * (float)rp[q][b + 2];
        }
      }
      const float inv = m.inv_x[sx];
#pragma unroll
      for (int q = 0; q < kRowGroup; ++q) {
        const int r = g * kRowGroup + q;
        if (r < rows) {
          float* h = m.hrow + r * ld3 + 3 * sx;
          h[0] = acc[q][0] * inv;
          h[1] = acc[q][1] * inv;
          h[2] = acc[q][2] * inv;
        }
      }
    }
    __syncthreads();
    issue(c + 2);  // into the stage this chunk has left
    // vertical pass
    for (int it = tid; it < (y1 - y0 + 1) * S; it += kThreads) {
      const int y = y0 + it / S, sx = it - (it / S) * S;
      const int r0 = max(a, m.lo_y[y]), r1 = min(a + rows - 1, m.hi_y[y]);
      const float* wrow = m.wy + (y - y0) * chunk;
      float v0 = 0.f, v1 = 0.f, v2 = 0.f;
      for (int r = r0; r <= r1; ++r) {
        const float w = wrow[r - a];
        const float* h = m.hrow + (r - a) * ld3 + 3 * sx;
        v0 += w * h[0];
        v1 += w * h[1];
        v2 += w * h[2];
      }
      int fy, fx;
      switch (k) {
        case 0: fy = y; fx = sx; break;
        case 1: fy = S - 1 - sx; fx = y; break;
        case 2: fy = S - 1 - y; fx = S - 1 - sx; break;
        default: fy = sx; fx = S - 1 - y; break;
      }
      const float inv = m.inv_y[y];
      float* d = m.frame + fy * m.ldf + 3 * fx;
      d[0] += v0 * inv;
      d[1] += v1 * inv;
      d[2] += v2 * inv;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Block (t, c): frame t of clip clip0 + c. kSmemFrame false: its frame is
// frame c * T + t of `scratch` (frame_bytes(S) apart).
template <typename OutT, bool kSmemFrame>
__global__ void __launch_bounds__(kThreads)
augment_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ box,
               const int* __restrict__ rotk, const float* __restrict__ angle,
               const float* __restrict__ factors, const float* __restrict__ graymix,
               const float* __restrict__ sigma, const int* __restrict__ flip,
               OutT* __restrict__ out, float* __restrict__ scratch, int clip0, int N, int T,
               int H0, int W0, int S, int norm_imagenet, int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* gframe = nullptr;
  if constexpr (!kSmemFrame)
    gframe = scratch + ((size_t)blockIdx.y * T + blockIdx.x) * (frame_bytes(S) / sizeof(float));
  const Smem m = carve(smem, gframe, S, W0, chunk);
  const int t = blockIdx.x, clip = clip0 + blockIdx.y, tid = threadIdx.x;
  const int npx = S * S;

  // ---- crop + resize, written through rot90^k ----
  const size_t fsize = (size_t)H0 * W0 * 3;
  const uint8_t* fr = frames + ((size_t)clip * T + t) * fsize;
  resample(m, fr, frames, frames + (size_t)N * T * fsize, box + clip * 4,
           ((rotk[clip] % 4) + 4) % 4, H0, W0, S, chunk);

  // ---- small rotation: shear_x(a) . shear_y(b) . shear_x(a); identity at 0 ----
  const float ang = angle[clip];
  if (ang != 0.f) {
    const float theta = __fmul_rn(ang * kPi, 1.f / 180.f);  // as the plain version
    const float a = -tanf(theta / 2.f), b = sinf(theta);
    const float ctr = (float)(S - 1) / 2.f;
    // each line's shift rounded on its own, as augment/ops.py rounds it
    auto shear_a = [&](const float* line, float* dst, int ds, int l, int lane) {
      shear_line(line, dst, ds, S, __fmul_rn(a, (float)l - ctr), lane);
    };
    auto shear_b = [&](const float* line, float* dst, int ds, int l, int lane) {
      shear_line(line, dst, ds, S, __fmul_rn(b, (float)l - ctr), lane);
    };
    per_line(m, S, true, shear_a);
    per_line(m, S, false, shear_b);
    per_line(m, S, true, shear_a);
  }

  // ---- colour jitter: brightness -> contrast -> saturation -> hue ----
  const float fb = factors[clip * 4 + 0], fc = factors[clip * 4 + 1];
  const float fs = factors[clip * 4 + 2], hue = factors[clip * 4 + 3];
  if (fb != 1.f || fc != 1.f || fs != 1.f || hue != 0.f) {
    float lsum = 0.f;
    for (int p = tid; p < npx; p += kThreads) {
      float* v = m.frame + (p / S) * m.ldf + 3 * (p % S);
      v[0] *= fb;
      v[1] *= fb;
      v[2] *= fb;
      lsum += 0.299f * v[0] + 0.587f * v[1] + 0.114f * v[2];
    }
    const float mean = block_sum(lsum, m.red) / (float)npx;
    for (int p = tid; p < npx; p += kThreads) {
      float* v = m.frame + (p / S) * m.ldf + 3 * (p % S);
      float r = v[0] * fc + (1.f - fc) * mean;
      float g = v[1] * fc + (1.f - fc) * mean;
      float b = v[2] * fc + (1.f - fc) * mean;
      const float luma = 0.299f * r + 0.587f * g + 0.114f * b;
      r = r * fs + (1.f - fs) * luma;
      g = g * fs + (1.f - fs) * luma;
      b = b * fs + (1.f - fs) * luma;
      if (hue != 0.f) hue_shift(r, g, b, hue);
      v[0] = fminf(fmaxf(r, 0.f), 255.f);
      v[1] = fminf(fmaxf(g, 0.f), 255.f);
      v[2] = fminf(fmaxf(b, 0.f), 255.f);
    }
    __syncthreads();
  }

  // ---- per-frame gray mix (identity when off) ----
  {
    const float* gm = graymix + ((size_t)clip * T + t) * 9;
    float g[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) g[i] = gm[i];
    for (int p = tid; p < npx; p += kThreads) {
      float* v = m.frame + (p / S) * m.ldf + 3 * (p % S);
      const float r = v[0], gg = v[1], b = v[2];
      v[0] = g[0] * r + g[1] * gg + g[2] * b;
      v[1] = g[3] * r + g[4] * gg + g[5] * b;
      v[2] = g[6] * r + g[7] * gg + g[8] * b;
    }
    __syncthreads();
  }

  // ---- Gaussian blur, y then x; identity when sigma == 0 ----
  const float sg = sigma[clip];
  if (sg > 0.f) {
    const float s2 = fmaxf(sg, 1e-3f);
    if (tid <= 2 * kBlurRadius) {
      const float off = (float)(tid - kBlurRadius);
      m.blur_w[tid] = expf(-(off * off) / (2.f * (s2 * s2)));
    }
    __syncthreads();
    for (int o = tid; o < S; o += kThreads) {
      float d = 0.f;
      for (int i = max(0, o - kBlurRadius); i <= min(S - 1, o + kBlurRadius); ++i)
        d += m.blur_w[i - o + kBlurRadius];
      m.blur_d[o] = 1.f / d;
    }
    __syncthreads();
    auto blur = [&](const float* line, float* dst, int ds, int, int lane) {
      for (int o = lane; o < S; o += 32) {
        float v0 = 0.f, v1 = 0.f, v2 = 0.f;
        for (int i = max(0, o - kBlurRadius); i <= min(S - 1, o + kBlurRadius); ++i) {
          const float w = m.blur_w[i - o + kBlurRadius];
          v0 += w * line[3 * i + 0];
          v1 += w * line[3 * i + 1];
          v2 += w * line[3 * i + 2];
        }
        const float inv = m.blur_d[o];
        dst[o * ds + 0] = v0 * inv;
        dst[o * ds + 1] = v1 * inv;
        dst[o * ds + 2] = v2 * inv;
      }
    };
    per_line(m, S, false, blur);
    per_line(m, S, true, blur);
  }

  // ---- hflip + normalize + NDHWC store in OutT ----
  const bool fl = flip[clip] != 0;
  const float mean_c[3] = {0.485f, 0.456f, 0.406f};
  const float std_c[3] = {0.229f, 0.224f, 0.225f};
  OutT* o = out + ((size_t)clip * T + t) * npx * 3;
  for (int e = tid; e < npx * 3; e += kThreads) {
    const int p = e / 3, c = e - p * 3;
    const int y = p / S, x = p - y * S;
    const int xs = fl ? S - 1 - x : x;
    float v = m.frame[y * m.ldf + 3 * xs + c];
    if (norm_imagenet)
      v = (v / 255.f - mean_c[c]) / std_c[c];
    else
      v = fminf(fmaxf(v / 255.f * 2.f - 1.f, -1.f), 1.f);
    store(o + e, v);
  }
}

// One launch per chunk of `per_launch` clips (all N with the frame in
// shared memory, scratch null).
template <typename OutT, bool kSmemFrame>
int launch(const void* frames, const void* box, const void* rotk, const void* angle,
           const void* factors, const void* graymix, const void* sigma, const void* flip,
           void* out, float* scratch, int per_launch, int N, int T, int H0, int W0, int S,
           int norm_imagenet, int chunk, cudaStream_t stream) {
  const size_t bytes = smem_bytes(S, W0, chunk, kSmemFrame);
  cudaError_t err = cudaFuncSetAttribute(augment_kernel<OutT, kSmemFrame>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  for (int clip0 = 0; clip0 < N; clip0 += per_launch) {
    dim3 grid(T, per_launch < N - clip0 ? per_launch : N - clip0);
    augment_kernel<OutT, kSmemFrame><<<grid, kThreads, bytes, stream>>>(
        (const uint8_t*)frames, (const float*)box, (const int*)rotk, (const float*)angle,
        (const float*)factors, (const float*)graymix, (const float*)sigma, (const int*)flip,
        (OutT*)out, scratch, clip0, N, T, H0, W0, S, norm_imagenet, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <typename OutT>
int launch_for(const void* frames, const void* box, const void* rotk, const void* angle,
               const void* factors, const void* graymix, const void* sigma, const void* flip,
               void* out, float* scratch, int per_launch, int N, int T, int H0, int W0, int S,
               int norm_imagenet, int chunk, cudaStream_t stream) {
  if (scratch == nullptr)
    return launch<OutT, true>(frames, box, rotk, angle, factors, graymix, sigma, flip, out,
                              nullptr, N, N, T, H0, W0, S, norm_imagenet, chunk, stream);
  return launch<OutT, false>(frames, box, rotk, angle, factors, graymix, sigma, flip, out,
                             scratch, per_launch, N, T, H0, W0, S, norm_imagenet, chunk, stream);
}

}  // namespace

// The chunk height (source rows per stage) for sample size S and frames W0
// wide, with the frame in shared memory (smem_frame 1) or not (0), 0 when
// none fits; the dynamic shared memory of one block; one frame's bytes in
// the device-memory scratch. ops/augment.py keeps a Python copy of all three.
extern "C" int cstp_augment_chunk_rows(int s, int w0, int smem_frame) {
  return chunk_rows(s, w0, smem_frame != 0);
}
extern "C" int cstp_augment_smem_bytes(int s, int w0, int chunk, int smem_frame) {
  return (int)smem_bytes(s, w0, chunk, smem_frame != 0);
}
extern "C" long long cstp_augment_frame_bytes(int s) { return (long long)frame_bytes(s); }

// frames (N, T, H0, W0, 3) u8; box (N, 4) f32; rotk (N,) i32; angle (N,) f32;
// factors (N, 4) f32; graymix (N, T, 3, 3) f32; sigma (N,) f32; flip (N,) i32;
// out (N, T, S, S, 3) in bf16 (out_type 0), f16 (1) or f32 (2). scratch:
// null to hold each frame in shared memory, or per_launch * T frames of
// cstp_augment_frame_bytes(S) each in device memory, and then one launch
// per per_launch clips. Returns cudaErrorInvalidValue when no chunk height
// fits (S, W0) with that frame place or for another out_type, else the CUDA
// error code of the launches.
extern "C" int cstp_augment_clips(const void* frames, const void* box, const void* rotk,
                                  const void* angle, const void* factors,
                                  const void* graymix, const void* sigma,
                                  const void* flip, void* out, void* scratch, int per_launch,
                                  int N, int T, int H0, int W0, int S, int norm_imagenet,
                                  int out_type, void* stream) {
  const bool smem_frame = scratch == nullptr;
  const int chunk = (S < 1 || H0 < 1 || W0 < 1) ? 0 : chunk_rows(S, W0, smem_frame);
  if (chunk == 0 || (!smem_frame && per_launch < 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* scr = (float*)scratch;
  switch (out_type) {
    case 0:
      return launch_for<__nv_bfloat16>(frames, box, rotk, angle, factors, graymix, sigma, flip,
                                       out, scr, per_launch, N, T, H0, W0, S, norm_imagenet,
                                       chunk, st);
    case 1:
      return launch_for<__half>(frames, box, rotk, angle, factors, graymix, sigma, flip, out,
                                scr, per_launch, N, T, H0, W0, S, norm_imagenet, chunk, st);
    case 2:
      return launch_for<float>(frames, box, rotk, angle, factors, graymix, sigma, flip, out,
                               scr, per_launch, N, T, H0, W0, S, norm_imagenet, chunk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
