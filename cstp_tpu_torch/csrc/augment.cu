// Fused CSTP clip augmentation for Hopper (sm_90a), plain C interface.
//
// Replaces cstp_tpu/ops/pallas/augment.py fused_augment_clips /
// _augment_kernel (the Pallas TPU kernel, one grid step per clip): uint8
// frames -> crop + bicubic resize -> rot90 -> 3-shear small rotation ->
// brightness/contrast/saturation/hue jitter -> per-frame 3x3 gray mix ->
// Gaussian blur (radius 7) -> hflip -> tf/imagenet normalize -> bf16 NDHWC.
//
// What bounds it on the H100: device memory. Per frame it reads H0*W0*3
// uint8 and writes S*S*3 bf16 (main path 128x171 -> 112: 65.7 KB in,
// 75.3 KB out); the arithmetic (about 30 taps per output value for the
// resize, 2-tap shears, 15-tap blurs) is far below the f32 rate.
//
// Design: one block per (clip, frame). Every reduction of the chain (the
// contrast's luma mean) and every mix (shears, blur, gray) stays within one
// frame, so nothing crosses blocks. The frame lives in dynamic shared
// memory as f32 (112 x 112 x 3 = 147 KB, rows padded by one float so that
// column walks hit distinct banks), so no intermediate reaches device
// memory. The TPU kernel's band matrices are not materialised: crop+resize
// is a direct band sum per output pixel over the nonzero taps of the two
// 1-D resample rows (tables built per block from the box; at most
// kMaxTaps per row, enough for a box up to 3.25x the output size), reading
// the uint8 frame from device memory through L1. rot90 and hflip are index
// maps. The shears and the blur are in place, one row or column per warp,
// through a per-warp temp row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 16;
constexpr int kBlurRadius = 7;
constexpr float kPi = 3.14159265358979323846f;

struct Smem {
  float* frame;   // [S][ldf], ldf = 3S + 1
  int ldf;
  float* tab_y;   // [S][kMaxTaps]
  float* tab_x;
  int* lo_y;      // [S]
  int* n_y;
  int* lo_x;
  int* n_x;
  float* temp;    // [kWarps][3S]
  float* red;     // [kWarps + 1]
  float* blur_w;  // [2 * kBlurRadius + 1]
  float* blur_d;  // [S]
};

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

__host__ __device__ inline size_t smem_bytes(int s) {
  size_t b = align128(sizeof(float) * (size_t)s * (3 * s + 1));
  b += 2 * align128(sizeof(float) * (size_t)s * kMaxTaps);
  b += 4 * align128(sizeof(int) * (size_t)s);
  b += align128(sizeof(float) * (size_t)kWarps * 3 * s);
  b += align128(sizeof(float) * (kWarps + 1));
  b += align128(sizeof(float) * (2 * kBlurRadius + 1));
  b += align128(sizeof(float) * (size_t)s);
  return b;
}

__device__ Smem carve(unsigned char* base, int s) {
  Smem m;
  size_t off = 0;
  auto take = [&](size_t bytes) { unsigned char* p = base + off; off += align128(bytes); return p; };
  m.ldf = 3 * s + 1;
  m.frame = reinterpret_cast<float*>(take(sizeof(float) * (size_t)s * m.ldf));
  m.tab_y = reinterpret_cast<float*>(take(sizeof(float) * (size_t)s * kMaxTaps));
  m.tab_x = reinterpret_cast<float*>(take(sizeof(float) * (size_t)s * kMaxTaps));
  m.lo_y = reinterpret_cast<int*>(take(sizeof(int) * s));
  m.n_y = reinterpret_cast<int*>(take(sizeof(int) * s));
  m.lo_x = reinterpret_cast<int*>(take(sizeof(int) * s));
  m.n_x = reinterpret_cast<int*>(take(sizeof(int) * s));
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

// Row `o` of the (out_size, in_size) resample matrix of augment/ops.py
// resample_weights: its nonzero taps from `lo` on, normalised.
__device__ void build_taps(int in_size, int out_size, float start, float size,
                           int o, int* lo_out, int* n_out, float* w_out) {
  const float scale = size / (float)out_size;
  const float fscale = fmaxf(scale, 1.f);
  const float center = start + ((float)o + 0.5f) * scale;
  const float lo_edge = floorf(start), hi_edge = ceilf(start + size);
  int lo = (int)floorf(center - 2.f * fscale - 0.5f) - 1;
  int hi = (int)ceilf(center + 2.f * fscale - 0.5f) + 1;
  lo = max(lo, 0);
  hi = min(hi, in_size - 1);
  int n = min(max(hi - lo + 1, 0), kMaxTaps);
  float sum = 0.f;
  for (int i = 0; i < n; ++i) {
    const float tap = (float)(lo + i) + 0.5f;
    float w = cubic((tap - center) / fscale);
    if (!(tap >= lo_edge && tap <= hi_edge)) w = 0.f;
    w_out[i] = w;
    sum += w;
  }
  const bool ok = sum > 1e-6f;
  const float denom = fmaxf(sum, 1e-6f);
  for (int i = 0; i < n; ++i) w_out[i] = ok ? w_out[i] / denom : 0.f;
  *lo_out = lo;
  *n_out = n;
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

__global__ void __launch_bounds__(kThreads)
augment_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ box,
               const int* __restrict__ rotk, const float* __restrict__ angle,
               const float* __restrict__ factors, const float* __restrict__ graymix,
               const float* __restrict__ sigma, const int* __restrict__ flip,
               __nv_bfloat16* __restrict__ out, int T, int H0, int W0, int S,
               int norm_imagenet) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem m = carve(smem, S);
  const int t = blockIdx.x, clip = blockIdx.y, tid = threadIdx.x;
  const int npx = S * S;

  // ---- resample tables for this clip's box ----
  const float bx = box[clip * 4 + 0], by = box[clip * 4 + 1];
  const float bw = box[clip * 4 + 2], bh = box[clip * 4 + 3];
  for (int i = tid; i < 2 * S; i += kThreads) {
    if (i < S)
      build_taps(H0, S, by, bh, i, m.lo_y + i, m.n_y + i, m.tab_y + i * kMaxTaps);
    else
      build_taps(W0, S, bx, bw, i - S, m.lo_x + (i - S), m.n_x + (i - S),
                 m.tab_x + (i - S) * kMaxTaps);
  }
  __syncthreads();

  // ---- crop + resize, read through rot90^k ----
  const uint8_t* fr = frames + ((size_t)clip * T + t) * H0 * W0 * 3;
  const int k = ((rotk[clip] % 4) + 4) % 4;
  for (int p = tid; p < npx; p += kThreads) {
    const int y = p / S, x = p - y * S;
    int sy, sx;
    switch (k) {
      case 0: sy = y; sx = x; break;
      case 1: sy = x; sx = S - 1 - y; break;
      case 2: sy = S - 1 - y; sx = S - 1 - x; break;
      default: sy = S - 1 - x; sx = y; break;
    }
    const int ly = m.lo_y[sy], ny = m.n_y[sy], lx = m.lo_x[sx], nx = m.n_x[sx];
    const float* wy = m.tab_y + sy * kMaxTaps;
    const float* wx = m.tab_x + sx * kMaxTaps;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int i = 0; i < ny; ++i) {
      const uint8_t* row = fr + ((size_t)(ly + i) * W0 + lx) * 3;
      float r0 = 0.f, r1 = 0.f, r2 = 0.f;
      for (int j = 0; j < nx; ++j) {
        const float w = wx[j];
        r0 += w * (float)__ldg(row + 3 * j + 0);
        r1 += w * (float)__ldg(row + 3 * j + 1);
        r2 += w * (float)__ldg(row + 3 * j + 2);
      }
      a0 += wy[i] * r0;
      a1 += wy[i] * r1;
      a2 += wy[i] * r2;
    }
    float* dst = m.frame + y * m.ldf + 3 * x;
    dst[0] = a0;
    dst[1] = a1;
    dst[2] = a2;
  }
  __syncthreads();

  // ---- small rotation: shear_x(a) . shear_y(b) . shear_x(a); identity at 0 ----
  const float ang = angle[clip];
  if (ang != 0.f) {
    const float theta = ang * kPi / 180.f;
    const float a = -tanf(theta / 2.f), b = sinf(theta);
    const float ctr = (float)(S - 1) / 2.f;
    auto shear_a = [&](const float* line, float* dst, int ds, int l, int lane) {
      shear_line(line, dst, ds, S, a * ((float)l - ctr), lane);
    };
    auto shear_b = [&](const float* line, float* dst, int ds, int l, int lane) {
      shear_line(line, dst, ds, S, b * ((float)l - ctr), lane);
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
      m.blur_d[o] = d;
    }
    __syncthreads();
    auto blur = [&](const float* line, float* dst, int ds, int, int lane) {
      for (int o = lane; o < S; o += 32) {
        float v0 = 0.f, v1 = 0.f, v2 = 0.f;
        const float d = m.blur_d[o];
        for (int i = max(0, o - kBlurRadius); i <= min(S - 1, o + kBlurRadius); ++i) {
          const float w = m.blur_w[i - o + kBlurRadius] / d;
          v0 += w * line[3 * i + 0];
          v1 += w * line[3 * i + 1];
          v2 += w * line[3 * i + 2];
        }
        dst[o * ds + 0] = v0;
        dst[o * ds + 1] = v1;
        dst[o * ds + 2] = v2;
      }
    };
    per_line(m, S, false, blur);
    per_line(m, S, true, blur);
  }

  // ---- hflip + normalize + bf16 NDHWC store ----
  const bool fl = flip[clip] != 0;
  const float mean_c[3] = {0.485f, 0.456f, 0.406f};
  const float std_c[3] = {0.229f, 0.224f, 0.225f};
  __nv_bfloat16* o = out + ((size_t)clip * T + t) * npx * 3;
  for (int e = tid; e < npx * 3; e += kThreads) {
    const int p = e / 3, c = e - p * 3;
    const int y = p / S, x = p - y * S;
    const int xs = fl ? S - 1 - x : x;
    float v = m.frame[y * m.ldf + 3 * xs + c];
    if (norm_imagenet)
      v = (v / 255.f - mean_c[c]) / std_c[c];
    else
      v = fminf(fmaxf(v / 255.f * 2.f - 1.f, -1.f), 1.f);
    o[e] = __float2bfloat16(v);
  }
}

}  // namespace

extern "C" int cstp_augment_smem_bytes(int s) { return (int)smem_bytes(s); }

// frames (N, T, H0, W0, 3) u8; box (N, 4) f32; rotk (N,) i32; angle (N,) f32;
// factors (N, 4) f32; graymix (N, T, 3, 3) f32; sigma (N,) f32; flip (N,) i32;
// out (N, T, S, S, 3) bf16. Returns the CUDA error code of the launch.
extern "C" int cstp_augment_clips(const void* frames, const void* box, const void* rotk,
                                  const void* angle, const void* factors,
                                  const void* graymix, const void* sigma,
                                  const void* flip, void* out, int N, int T, int H0,
                                  int W0, int S, int norm_imagenet, void* stream) {
  const size_t bytes = smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      augment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T, N);
  augment_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)box, (const int*)rotk, (const float*)angle,
      (const float*)factors, (const float*)graymix, (const float*)sigma,
      (const int*)flip, (__nv_bfloat16*)out, T, H0, W0, S, norm_imagenet);
  return (int)cudaGetLastError();
}
