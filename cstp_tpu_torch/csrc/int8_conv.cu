// int8 3D convolution for Hopper (sm_90a), plain C interface: an implicit
// GEMM of s8 NDHWC activations and s8 weights with int32 accumulation on the
// tensor cores, dequantized in the epilogue.
//
// Replaces no Pallas kernel. The JAX package computes its int8 conv
// (--quant; cstp_tpu/ops/quant.py:53 _conv) as lax.conv_general_dilated on
// int8 operands with an int32 accumulator, which XLA lowers to the TPU's
// int8 matrix unit. PyTorch has no int8 conv3d on CUDA, so the port writes
// it here (K6).
//
//   out[m, c] = float(acc[m, c]) * scale[c]   (scale = sx * sw[c], formed
//                                              by the caller in f32)
//   acc[m, c] = sum over taps (dt, dh, dw) and input channels ci of
//               x[n, to*st + dt - pt, ho*sh + dh - ph, wo*sw + dw - pw, ci]
//               * w[c, (dt, dh, dw, ci)]
//
// x is (N, T, H, W, Cin) s8; w is packed (Cout, Kp) s8, row c holding the
// K = kt*kh*kw*Cin weights in (dt, dh, dw, ci) order and zeros up to Kp (a
// multiple of 32); m runs over the flat (n, to, ho, wo) output index; out
// is (N, To, Ho, Wo, Cout) f32, bf16 or (out_kind 2) the int32 accumulator
// itself. A tap outside the frame (the low pads pt, ph, pw and whatever the
// high pads add) reads 0, the quantized zero, as JAX's conv on the s8 input
// pads with 0. The sums are exact: |acc| <= K * 127^2 < 2^31 up to K =
// 133,000 (the largest K of the port's families is C3D's 27 * 512 =
// 13,824), so any summation order gives the same integers, and the
// epilogue's one conversion and one product are rounded to nearest as
// PyTorch rounds them: the plain version (ops/quant.py) is bitwise equal.
//
// What bounds it on the H100: at the main path's shapes tensor-core
// operations (2 * M * Cout * K against 1,979 int8 TOPS) at the wide sites,
// device-memory bytes (the s8 input read once, the bf16 output written
// once) at the narrow ones (Cout of 64-83 and K of 64-147). This first
// kernel is simple: a block of 4 warps computes a 64 x 64 output tile, each
// warp 32 x 32 with mma.sync m16n8k32 (s8 x s8 -> s32), over K steps of 32
// staged in a 2-stage ring in shared memory (rows of 48 bytes, so the
// fragment reads hit 32 distinct banks). B (weights) arrives by 16-byte
// cp.async, zero-filled past Cout. A (the im2col gather) is two paths:
// where Cin % 16 == 0 each 16-byte chunk of a row's K step lies inside one
// tap and is contiguous in x, so it is one zero-filling cp.async; otherwise
// (the stems' Cin = 3, R(2+1)D's mid widths 83, 230, 921, ...) each thread
// gathers its 16 bytes one by one into registers, issued before the step's
// mma and stored to shared memory after it. No wgmma, TMA or fused
// quantize prologue yet: that is the redesign's work (ROADMAP).
//
// The storage epilogue (cstp_int8_conv3d_store; --quant int8_store, the
// s8 storage chain of ops/quant.py, whose JAX counterpart is the XLA fusion
// at cstp_tpu/ops/quant.py:187-227 and no Pallas call) keeps the chain's
// f32 mid out of device memory: per element h = acc * scale[c] as above,
// then hq = clip(rint(h / s_mid), -127, 127) (an IEEE division, as PyTorch
// divides by a 0-d tensor), written as s8; while observing, max |h| into
// one f32 (atomicMax on the bits of a non-negative float: exact and
// order-free); and per (sample, channel) the exact int64 sums of hq and
// hq^2. The block stages its 64 x 64 s8 tile in the A ring's shared memory;
// each of its 128 threads then walks 32 rows of one column, summing in
// int32 (|sum| <= 32 * 127^2) and adding to the (N, Cout) int64 sums with
// one atomicAdd per sample its rows touch; the tile leaves as rows of
// bytes, consecutive threads on consecutive addresses. The sums are
// integers and the absmax a maximum, so any order gives the same result:
// bitwise the plain version (ops/quant.py int8_conv3d_store_plain). What
// bounds it is K6's bound with a 1-byte output instead of 2 or 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int BM = 64;        // output positions per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // K per step: one m16n8k32
constexpr int LDS = 48;       // shared-memory bytes per staged row
constexpr int THREADS = 128;  // 4 warps, 2 x 2 over the 64 x 64 tile

struct Shape {
  int n, t, h, w, cin;
  int to, ho, wo, cout;
  int kt, kh, kw;
  int st, sh, sw;
  int pt, ph, pw;
  int k, kp;
  long long m;
};

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One A row of the block (an output position): its batch index and the
// input coordinates of tap (0, 0, 0), or ok = false past the last row.
struct Row {
  bool ok;
  int n, t0, h0, w0;
};

__device__ __forceinline__ Row make_row(const Shape& s, long long m) {
  Row r;
  r.ok = m < s.m;
  long long q = r.ok ? m : 0;
  const int wo = (int)(q % s.wo);
  q /= s.wo;
  const int ho = (int)(q % s.ho);
  q /= s.ho;
  const int to = (int)(q % s.to);
  r.n = (int)(q / s.to);
  r.t0 = to * s.st - s.pt;
  r.h0 = ho * s.sh - s.ph;
  r.w0 = wo * s.sw - s.pw;
  return r;
}

// The offset in x of tap `tap`, channel ci, of row r; -1 where the tap
// falls outside the frame.
__device__ __forceinline__ long long tap_offset(const Shape& s, const Row& r, int tap, int ci) {
  const int khw = s.kh * s.kw;
  const int dt = tap / khw;
  const int rem = tap - dt * khw;
  const int dh = rem / s.kw;
  const int dw = rem - dh * s.kw;
  const int ti = r.t0 + dt, hi = r.h0 + dh, wi = r.w0 + dw;
  if (ti < 0 || ti >= s.t || hi < 0 || hi >= s.h || wi < 0 || wi >= s.w) return -1;
  return ((((long long)r.n * s.t + ti) * s.h + hi) * s.w + wi) * s.cin + ci;
}

// Cin % 16 == 0: the 16 bytes of K [k, k + 16) of row r, one cp.async.
__device__ __forceinline__ void load_a_vec(int8_t* dst, const int8_t* x, const Shape& s,
                                           const Row& r, int k) {
  long long off = -1;
  if (r.ok && k < s.k) {
    const int tap = k / s.cin;
    off = tap_offset(s, r, tap, k - tap * s.cin);
  }
  cp_async16(dst, off >= 0 ? x + off : x, off >= 0);
}

// Any Cin: the 16 bytes of K [k, k + 16) of row r, one by one, into v.
__device__ __forceinline__ void gather_a(uint32_t* v, const int8_t* x, const Shape& s,
                                         const Row& r, int k) {
  v[0] = v[1] = v[2] = v[3] = 0u;
  if (!r.ok || k >= s.k) return;
  int tap = k / s.cin;
  int ci = k - tap * s.cin;
  long long base = tap_offset(s, r, tap, 0);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (k + j < s.k && base >= 0) {
      const uint32_t b = (uint8_t)__ldg(x + base + ci);
      v[j >> 2] |= b << (8 * (j & 3));
    }
    if (++ci == s.cin) {
      ci = 0;
      ++tap;
      if (k + j + 1 < s.k) base = tap_offset(s, r, tap, 0);
    }
  }
}

__device__ __forceinline__ void store16(int8_t* dst, const uint32_t* v) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// The storage epilogue's outputs (out is hq, s8): the (N, Cout) int64 sums
// of hq and hq^2, zeroed by the caller, and max |h| as float bits, zeroed
// too (written only when observe).
struct Store {
  const float* s_mid;
  unsigned long long* sum1;
  unsigned long long* sum2;
  unsigned int* amax;
  int observe;
};

constexpr int TS = BN + 4;  // the staged s8 tile's row stride, bytes

template <bool VEC, bool STORE>
__global__ void __launch_bounds__(THREADS)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, void* __restrict__ out, Shape s,
                     int out_kind, Store st) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // loads: thread tid stages row tid / 2, bytes 16 * (tid % 2) of a K step
  const int lrow = tid >> 1;
  const int lk = (tid & 1) * 16;
  const Row row = make_row(s, m0 + lrow);
  const int bn = n0 + lrow;
  const bool b_ok = bn < s.cout;
  const int8_t* wrow = w + (long long)(b_ok ? bn : 0) * s.kp + lk;

  // compute: warp (wm, wn) owns rows wm..wm+31 and columns wn..wn+31
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = s.kp / BK;
  uint32_t areg[4];
  cp_async16(&Bs[0][lrow * LDS + lk], b_ok ? wrow : w, b_ok);
  if (VEC) {
    load_a_vec(&As[0][lrow * LDS + lk], x, s, row, lk);
  } else {
    gather_a(areg, x, s, row, lk);
    store16(&As[0][lrow * LDS + lk], areg);
  }
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1, nxt = cur ^ 1;
    const bool more = kt + 1 < nk;
    if (more) {
      const int k = (kt + 1) * BK + lk;
      cp_async16(&Bs[nxt][lrow * LDS + lk], b_ok ? wrow + (kt + 1) * BK : w, b_ok);
      if (VEC) {
        load_a_vec(&As[nxt][lrow * LDS + lk], x, s, row, k);
      } else {
        gather_a(areg, x, s, row, k);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int8_t* A = As[cur];
    const int8_t* B = Bs[cur];
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* p = A + (wm + mi * 16 + g) * LDS + tq * 4;
      a[mi][0] = lds32(p);
      a[mi][1] = lds32(p + 8 * LDS);
      a[mi][2] = lds32(p + 16);
      a[mi][3] = lds32(p + 8 * LDS + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* p = B + (wn + ni * 8 + g) * LDS + tq * 4;
      b[ni][0] = lds32(p);
      b[ni][1] = lds32(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);

    if (!VEC && more) store16(&As[nxt][lrow * LDS + lk], areg);
    __syncthreads();
  }

  // epilogue: fragment element e of (mi, ni) is row g + 8 * (e / 2), column
  // 2 * tq + e % 2 of the m16 x n8 tile
  if (STORE) {
    // the mainloop ended on a barrier: the A ring is free for the s8 tile
    int8_t* tile = &As[0][0];
    const float smid = *st.s_mid;
    float amax = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm + mi * 16 + g + half * 8;
        const bool row_ok = m0 + r < s.m;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int cl = wn + ni * 8 + tq * 2 + j;
            const int c = n0 + cl;
            int q = 0;
            if (row_ok && c < s.cout) {
              const float h = __fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + j]), scale[c]);
              amax = fmaxf(amax, fabsf(h));
              const float v = fminf(fmaxf(rintf(__fdiv_rn(h, smid)), -127.f), 127.f);
              q = (int)v;
            }
            tile[r * TS + cl] = (int8_t)q;
          }
        }
      }
    }
    if (st.observe) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) atomicMax(st.amax, __float_as_uint(amax));
    }
    __syncthreads();

    // per-(sample, channel) sums: thread tid walks rows 32 * (tid / 64) ..
    // + 31 of column tid % 64, one atomicAdd pair per sample it touches
    const int col = tid & (BN - 1);
    const int c = n0 + col;
    const int r0 = (tid >> 6) * 32;
    const long long per = (long long)s.to * s.ho * s.wo;
    if (c < s.cout && m0 + r0 < s.m) {
      const long long left = s.m - (m0 + r0);
      const int nr = left < 32 ? (int)left : 32;
      long long n = (m0 + r0) / per;
      long long pos = (m0 + r0) - n * per;
      int a1 = 0, a2 = 0;
      for (int i = 0; i < nr; ++i) {
        const int q = tile[(r0 + i) * TS + col];
        a1 += q;
        a2 += q * q;
        if (++pos == per || i == nr - 1) {
          if (a2 != 0) {
            const long long o = n * s.cout + c;
            atomicAdd(st.sum1 + o, (unsigned long long)(long long)a1);
            atomicAdd(st.sum2 + o, (unsigned long long)(long long)a2);
          }
          a1 = a2 = 0;
          pos = 0;
          ++n;
        }
      }
    }
    // the tile's rows, byte by byte, consecutive threads on consecutive
    // columns
    int8_t* hq = static_cast<int8_t*>(out);
    for (int idx = tid; idx < BM * BN; idx += THREADS) {
      const int r = idx / BN, cl = idx - r * BN;
      const long long m = m0 + r;
      if (m < s.m && n0 + cl < s.cout) hq[m * s.cout + n0 + cl] = tile[r * TS + cl];
    }
    return;
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm + mi * 16 + g + half * 8;
      if (m >= s.m) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = n0 + wn + ni * 8 + tq * 2 + j;
          if (c >= s.cout) continue;
          const int v = acc[mi][ni][half * 2 + j];
          const long long o = m * s.cout + c;
          if (out_kind == 2) {
            static_cast<int*>(out)[o] = v;
          } else {
            const float f = __fmul_rn(__int2float_rn(v), scale[c]);
            if (out_kind == 1) {
              static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(f);
            } else {
              static_cast<float*>(out)[o] = f;
            }
          }
        }
      }
    }
  }
}

}  // namespace

namespace {

// Shared by both entries: checks the arguments and launches; returns 0 or a
// CUDA error code.
template <bool STORE>
int launch(const void* x, const void* w, const void* scale, void* out, int n, int t, int h, int wd,
           int cin, int to, int ho, int wo, int cout, int kt, int kh, int kw, int st, int sh,
           int sw, int pt, int ph, int pw, int kp, int out_kind, Store store, void* stream) {
  const int dims[] = {n, t, h, wd, cin, to, ho, wo, cout, kt, kh, kw, st, sh, sw};
  for (int d : dims)
    if (d <= 0) return (int)cudaErrorInvalidValue;
  if (pt < 0 || ph < 0 || pw < 0 || out_kind < 0 || out_kind > 3 || (out_kind == 3) != STORE)
    return (int)cudaErrorInvalidValue;
  const long long k = (long long)kt * kh * kw * cin;
  if (kp % BK != 0 || kp < k || k > 133000) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)w & 15) != 0 || x == nullptr || out == nullptr ||
      (out_kind != 2 && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (STORE && (store.s_mid == nullptr || store.sum1 == nullptr || store.sum2 == nullptr ||
                store.amax == nullptr))
    return (int)cudaErrorInvalidValue;
  Shape s{n, t, h, wd, cin, to, ho, wo, cout, kt, kh, kw, st, sh, sw, pt, ph, pw, (int)k, kp,
          (long long)n * to * ho * wo};
  const long long mblocks = (s.m + BM - 1) / BM;
  const int nblocks = (cout + BN - 1) / BN;
  if (mblocks > 0x7fffffffLL || nblocks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mblocks, (unsigned)nblocks);
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  if (cin % 16 == 0 && ((uintptr_t)x & 15) == 0) {
    int8_conv_kernel<true, STORE><<<grid, THREADS, 0, st_>>>(xs, ws, sc, out, s, out_kind, store);
  } else {
    int8_conv_kernel<false, STORE><<<grid, THREADS, 0, st_>>>(xs, ws, sc, out, s, out_kind, store);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, T, H, W, Cin) s8; w (Cout, Kp) s8, K = kt*kh*kw*Cin in (dt, dh,
// dw, ci) order then zeros; scale (Cout,) f32 (unread for out_kind 2);
// out (N, To, Ho, Wo, Cout): out_kind 0 f32, 1 bf16, 2 the int32
// accumulator. (pt, ph, pw) are the low pads; the high pads are implied by
// To, Ho, Wo. Returns 0 or a CUDA error code (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int cstp_int8_conv3d(const void* x, const void* w, const void* scale, void* out,
                                int n, int t, int h, int wd, int cin, int to, int ho, int wo,
                                int cout, int kt, int kh, int kw, int st, int sh, int sw,
                                int pt, int ph, int pw, int kp, int out_kind, void* stream) {
  return launch<false>(x, w, scale, out, n, t, h, wd, cin, to, ho, wo, cout, kt, kh, kw, st, sh,
                       sw, pt, ph, pw, kp, out_kind, Store{}, stream);
}

// The storage epilogue (out_kind 3): the same conv and scale; hq (N, To,
// Ho, Wo, Cout) s8 at the 0-d f32 s_mid (a device pointer); sum1, sum2
// (N, Cout) int64 sums of hq and hq^2, zeroed by the caller; amax one f32,
// zeroed by the caller, max |h| when observe.
extern "C" int cstp_int8_conv3d_store(const void* x, const void* w, const void* scale,
                                      const void* s_mid, void* hq, void* sum1, void* sum2,
                                      void* amax, int n, int t, int h, int wd, int cin, int to,
                                      int ho, int wo, int cout, int kt, int kh, int kw, int st,
                                      int sh, int sw, int pt, int ph, int pw, int kp, int observe,
                                      void* stream) {
  Store store{static_cast<const float*>(s_mid), static_cast<unsigned long long*>(sum1),
              static_cast<unsigned long long*>(sum2), static_cast<unsigned int*>(amax),
              observe};
  return launch<true>(x, w, scale, hq, n, t, h, wd, cin, to, ho, wo, cout, kt, kh, kw, st, sh,
                      sw, pt, ph, pw, kp, 3, store, stream);
}
