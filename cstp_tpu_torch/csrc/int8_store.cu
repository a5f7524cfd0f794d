// K7: the s8 storage chain's normalise -> affine -> ReLU -> requantize pass
// for Hopper (sm_90a), plain C interface. s8 in, s8 out.
//
// Replaces no Pallas kernel: the JAX package's --quant int8_store chain
// (cstp_tpu/ops/quant.py:187-227 _store_chain_fwd_impl) is one traced
// function that XLA fuses, with this pass as one s8-in/s8-out loop fusion.
// In the port it runs between K6's storage epilogue (which writes hq and
// the moments' integer sums) and K6's int8 temporal conv (which reads yq),
// so the chain's mid never exists in f32 in device memory:
//
//   hh = hq * s_mid
//   y1 = relu(((hh - mean[n, c]) * inv[n, c]) * gamma[c] + beta[c])
//   yq = clip(rint(y1 / s_act), -127, 127)       (s8)
//   amax = max y1                                (observe: the a_act
//                                                  observation's input)
//
// mean and inv are per (sample, channel), (N, M) f32, formed by the caller
// from the group moments (inv = rsqrt(var + eps) in PyTorch, so this pass
// computes no rsqrt). Every product, difference and sum is rounded on its
// own (__fmul_rn, __fsub_rn, __fadd_rn: nvcc would contract them into FMAs)
// and the division is IEEE, in JAX's order, so the kernel is bitwise the
// plain version (ops/quant.py bn_relu_requant_plain, eager PyTorch, one
// rounding per operation); the maximum is exact in any order (atomicMax on
// the bits of a non-negative float).
//
// What bounds it on the H100: bytes, one s8 read and one s8 write per
// element (the (N, M) and (M,) operands are small and stay in cache), at
// 3.35 TB/s. This first kernel is simple: one thread per 16 bytes of hq,
// read and written as one 16-byte vector where both pointers are aligned,
// its channel and sample advanced byte by byte (M need not divide 16).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;

__global__ void __launch_bounds__(THREADS)
    bn_relu_requant_kernel(const int8_t* __restrict__ hq, const float* __restrict__ s_mid,
                           const float* __restrict__ mean, const float* __restrict__ inv,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           const float* __restrict__ s_act, int8_t* __restrict__ yq,
                           unsigned int* __restrict__ amax, long long total, long long per_sample,
                           int m, int observe, bool vec) {
  const long long i0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  float mx = 0.f;
  if (i0 < total) {
    const float sm = *s_mid, sa = *s_act;
    const int nb = total - i0 < VEC ? (int)(total - i0) : VEC;
    int8_t v[VEC], o[VEC];
    if (vec && nb == VEC) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(hq + i0);
    } else {
      for (int k = 0; k < nb; ++k) v[k] = hq[i0 + k];
    }
    long long n = i0 / per_sample;
    long long e = i0 - n * per_sample;  // element within the sample
    int c = (int)(e % m);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (k < nb) {
        const long long nc = n * m + c;
        const float hh = __fmul_rn((float)v[k], sm);
        const float xn = __fmul_rn(__fsub_rn(hh, __ldg(mean + nc)), __ldg(inv + nc));
        float y = __fadd_rn(__fmul_rn(xn, __ldg(gamma + c)), __ldg(beta + c));
        y = y > 0.f ? y : 0.f;
        mx = fmaxf(mx, y);
        const float q = fminf(fmaxf(rintf(__fdiv_rn(y, sa)), -127.f), 127.f);
        o[k] = (int8_t)(int)q;
        if (++c == m) c = 0;
        if (++e == per_sample) {
          e = 0;
          ++n;
        }
      }
    }
    if (vec && nb == VEC) {
      *reinterpret_cast<uint4*>(yq + i0) = *reinterpret_cast<const uint4*>(o);
    } else {
      for (int k = 0; k < nb; ++k) yq[i0 + k] = o[k];
    }
  }
  if (observe) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if ((threadIdx.x & 31) == 0 && mx > 0.f) atomicMax(amax, __float_as_uint(mx));
  }
}

}  // namespace

// hq (N, ..., M) s8, contiguous, total = its element count, per_sample =
// total / N; s_mid, s_act 0-d f32 device scalars; mean, inv (N, M) f32;
// gamma, beta (M,) f32; yq like hq; amax one f32, zeroed by the caller,
// max y1 when observe. Returns 0 or a CUDA error code.
extern "C" int cstp_bn_relu_requant(const void* hq, const void* s_mid, const void* mean,
                                    const void* inv, const void* gamma, const void* beta,
                                    const void* s_act, void* yq, void* amax, long long total,
                                    long long per_sample, int m, int observe, void* stream) {
  if (total <= 0 || per_sample <= 0 || m <= 0 || per_sample % m != 0 || total % per_sample != 0)
    return (int)cudaErrorInvalidValue;
  if (!hq || !s_mid || !mean || !inv || !gamma || !beta || !s_act || !yq || !amax)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (total + (long long)THREADS * VEC - 1) / ((long long)THREADS * VEC);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = (((uintptr_t)hq | (uintptr_t)yq) & 15) == 0;
  bn_relu_requant_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(hq), static_cast<const float*>(s_mid),
      static_cast<const float*>(mean), static_cast<const float*>(inv),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(s_act), static_cast<int8_t*>(yq),
      static_cast<unsigned int*>(amax), total, per_sample, m, observe, vec);
  return (int)cudaGetLastError();
}
