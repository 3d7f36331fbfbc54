// int8 depthwise 3x3 convolution for Hopper (sm_90a), with exact int32
// accumulation and the dequantize and bias epilogue.
//
// Replaces the grouped case of the conv rewrite of
// ground_plane_polling_tpu/models/quantize.py::quantize_apply (`cb`: the
// int8 x int8 -> int32 conv_general_dilated with feature_group_count = C
// and its dequantize), which XLA lowers on the TPU; there is no Pallas
// kernel behind it. MobileNet's 13 depthwise convs run it under --int8.
// Plain PyTorch version: ops/int8_conv.py::int8_conv2d on a (C, 1, 3, 3)
// weight (an exact float64 grouped conv).
//
// x: B x H x W x C int8 (the quantize kernel's NHWC output); w: C x 3 x 3
// int8 ([C][9] in memory, the OIHW weight of a groups=C conv); s_w: C
// float32; stride any, zero padding given as (pad_h, pad_w) before the
// map (Flax's SAME pads the rest after it, which the bounds test covers).
// out[b][ho][wo][c] = sum over the 9 taps of x * w as an exact int32
// (|acc| <= 9 x 127^2), then, in the JAX package's order,
// y = float(acc) * (s_x * s_w[c]) in float32, cast to the output type, and
// + bias in that type. __fmul_rn / __fadd_rn keep the compiler from
// contracting them into an FMA; kind 2 writes the raw accumulators.
//
// What bounds it: bytes. Each output costs 9 multiply-adds, and a pixel's
// C int8 inputs are read by at most 9 outputs of its neighbourhood, which
// the L1 and L2 caches serve: from device memory the kernel needs the int8
// map once and writes 2 or 4 bytes an output. The design, simple and
// coalesced: one thread per output pixel and group of 8 channels (VEC 8,
// where C is a multiple of 8), channels innermost, so that a warp's 32
// threads read 256 contiguous bytes of a tap with 8-byte loads and write
// 512 (bf16) contiguous bytes with 16-byte stores. The thread's 72 weight
// bytes (8 channels x 9 taps) are contiguous in [C][9] and come in nine
// 8-byte loads. No shared memory. Any other C takes VEC 1, one thread an
// output element, byte by byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 9;  // 3 x 3

enum OutKind { kOutF32 = 0, kOutBF16 = 1, kOutS32 = 2 };

struct DwShape {
  int B, H, W, C;
  int stride, pad_h, pad_w;
  int Ho, Wo;
};

template <int VEC>
__device__ __forceinline__ void load_bytes(const int8_t* p, int8_t* v) {
  if constexpr (VEC == 8) {
    const int2 r = *reinterpret_cast<const int2*>(p);
    const int words[2] = {r.x, r.y};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = static_cast<int8_t>(words[e / 4] >> (8 * (e % 4)));
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = p[e];
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
depthwise_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const DwShape s, const float s_x,
                 const float* __restrict__ s_w,
                 const void* __restrict__ bias, void* __restrict__ out,
                 const int kind, const int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int groups = s.C / VEC;
  const int g = i % groups;
  int p = i / groups;  // output pixel: (b, ho, wo)
  const int wo = p % s.Wo;
  const int ho = (p / s.Wo) % s.Ho;
  const int b = p / (s.Wo * s.Ho);
  const int c0 = g * VEC;

  // the weights of channels c0 .. c0 + VEC - 1: VEC x 9 contiguous bytes
  int8_t wt[VEC * kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    load_bytes<VEC>(w + c0 * kTaps + k * VEC, wt + k * VEC);
  }
  int acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0;
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int hi = ho * s.stride - s.pad_h + kh;
    if (hi < 0 || hi >= s.H) continue;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int wi = wo * s.stride - s.pad_w + kw;
      if (wi < 0 || wi >= s.W) continue;
      int8_t v[VEC];
      load_bytes<VEC>(
          x + ((static_cast<long long>(b) * s.H + hi) * s.W + wi) * s.C + c0,
          v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc[e] += static_cast<int>(v[e]) *
                  static_cast<int>(wt[e * kTaps + kh * 3 + kw]);
      }
    }
  }

  const long long o = static_cast<long long>(p) * s.C + c0;
  if (kind == kOutS32) {
    int* to = static_cast<int*>(out) + o;
    if constexpr (VEC == 8) {
      reinterpret_cast<int4*>(to)[0] =
          make_int4(acc[0], acc[1], acc[2], acc[3]);
      reinterpret_cast<int4*>(to)[1] =
          make_int4(acc[4], acc[5], acc[6], acc[7]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) to[e] = acc[e];
    }
    return;
  }
  float y[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    y[e] = __fmul_rn(__int2float_rn(acc[e]), __fmul_rn(s_x, s_w[c0 + e]));
  }
  if (kind == kOutF32) {
    const float* bf = static_cast<const float*>(bias);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (bf) y[e] = __fadd_rn(y[e], bf[c0 + e]);
    }
    float* to = static_cast<float*>(out) + o;
    if constexpr (VEC == 8) {
      reinterpret_cast<float4*>(to)[0] = make_float4(y[0], y[1], y[2], y[3]);
      reinterpret_cast<float4*>(to)[1] = make_float4(y[4], y[5], y[6], y[7]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) to[e] = y[e];
    }
    return;
  }
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(bias);
  unsigned short h[VEC];  // bf16 bits
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    __nv_bfloat16 v = __float2bfloat16_rn(y[e]);
    if (bb) {
      v = __float2bfloat16_rn(
          __fadd_rn(__bfloat162float(v), __bfloat162float(bb[c0 + e])));
    }
    h[e] = __bfloat16_as_ushort(v);
  }
  unsigned short* to = static_cast<unsigned short*>(out) + o;
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(to) = make_uint4(
        h[0] | (static_cast<unsigned>(h[1]) << 16),
        h[2] | (static_cast<unsigned>(h[3]) << 16),
        h[4] | (static_cast<unsigned>(h[5]) << 16),
        h[6] | (static_cast<unsigned>(h[7]) << 16));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) to[e] = h[e];
  }
}

}  // namespace

// x: B x H x W x C int8; w: C x 9 int8; s_w: C float32 (may be null for
// kind 2); bias: C values of the output type, or null; out: B x Ho x Wo x C
// of kind 0 (float32), 1 (bf16) or 2 (int32). vec 8 needs C a multiple of
// 8 and x, w 8-byte and out 16-byte aligned (the wrapper checks). Returns
// the CUDA error of the launch (0 on success).
extern "C" int gpp_int8_depthwise(const int8_t* x, const int8_t* w, int B,
                                  int H, int W, int C, int stride, int pad_h,
                                  int pad_w, int Ho, int Wo, float s_x,
                                  const float* s_w, const void* bias,
                                  void* out, int kind, int vec,
                                  void* stream) {
  const DwShape s{B, H, W, C, stride, pad_h, pad_w, Ho, Wo};
  const long long n = static_cast<long long>(B) * Ho * Wo * C / vec;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if ((vec != 1 && vec != 8) || C % vec || n >= (1LL << 31) ||
      kind < kOutF32 || kind > kOutS32 || (kind != kOutS32 && !s_w))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8) {
    depthwise_kernel<8><<<blocks, kThreads, 0, st>>>(
        x, w, s, s_x, s_w, bias, out, kind, static_cast<int>(n));
  } else {
    depthwise_kernel<1><<<blocks, kThreads, 0, st>>>(
        x, w, s, s_x, s_w, bias, out, kind, static_cast<int>(n));
  }
  return static_cast<int>(cudaGetLastError());
}
