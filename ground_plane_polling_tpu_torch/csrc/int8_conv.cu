// int8 convolution for Hopper (sm_90a): the activation quantize pass and an
// implicit-GEMM int8 conv with exact int32 accumulation and the dequantize
// and bias epilogue.
//
// Replaces the conv rewrite of ground_plane_polling_tpu/models/quantize.py::
// quantize_apply (`cb`, the quantize of x, the int8 x int8 -> int32
// conv_general_dilated and the dequantize), which XLA lowers on the TPU;
// there is no Pallas kernel behind it. Plain PyTorch versions:
// ops/int8_conv.py.
//
// gpp_int8_quantize: x (float32 or bf16, any strides of an NCHW tensor)
// -> int8 NHWC, q = rint(x / s) clamped to +-127. True IEEE division
// (__fdiv_rn, also under -prec-div=true), as the JAX package divides; a
// multiplication by 1 / s rounds differently at half-way points. rintf
// rounds half to even, as jnp.round and torch.round do. One thread an
// element, reading along the input's channels when it is channels-last.
// Bound by bytes: 2 or 4 bytes read and 1 written an element.
//
// gpp_int8_conv: M = B Ho Wo output pixels by N = Cout channels over
// K = kh kw Cin, from int8 NHWC activations and int8 [Cout][kh][kw][Cin]
// weights. A block computes a 128 x 128 tile of the output with 8 warps
// (2 along M, 4 along N; 64 x 32 each) on mma.sync.m16n8k32 s8 x s8 -> s32,
// staging 64-deep slices of K in shared memory: the A tile is gathered from
// the activations (im2col on the fly, out-of-image taps are int8 zeros, so
// any padding, asymmetric SAME too, is a pair of offsets), the B tile from
// the weights. Rows of 80 bytes make the fragment reads conflict-free.
// Where Cin is a multiple of 16 every 16-byte piece of K lies in one tap and
// is loaded as one vector; otherwise (the stem, Cin 3, K 147) byte by byte.
// Every tile edge is masked: rows past M, channels past Cout and K past its
// end read zeros and are not stored.
// Epilogue, in the JAX package's order: deq = s_x * s_w[c] (float32),
// y = float(acc) * deq, cast to the output type, then + bias in that type
// (flax adds the bias after the conv). __fmul_rn / __fadd_rn keep the
// compiler from contracting them into an FMA. The output is [M][Cout], a
// channels-last NCHW tensor; kind 2 writes the raw int32 accumulators.
// What bounds it: int8 tensor-core operations (2 M N K at 1,979 TOP/s) for
// the trunk's 3x3 and wide 1x1 convs; the loads are plain (no cp.async or
// TMA, one stage), so this first version is far from that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kRow = kBK + 16;  // bytes per shared-memory row
constexpr int kThreads = 256;
constexpr int kQuantThreads = 256;

enum OutKind { kOutF32 = 0, kOutBF16 = 1, kOutS32 = 2 };

struct ConvShape {
  int B, H, W, C;         // input, NHWC
  int O, KH, KW;          // weights, [O][KH][KW][C]
  int stride, pad_h, pad_w;
  int Ho, Wo;
  int K;                  // KH * KW * C
  int M;                  // B * Ho * Wo
};

__device__ __forceinline__ float load_float(const void* p, int is_bf16,
                                            long long i) {
  return is_bf16 ? __bfloat162float(
                       static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const void* x, int x_bf16, int n, int C, int H, int W,
                long long sN, long long sC, long long sH, long long sW,
                float s, int8_t* out) {
  const int o = blockIdx.x * kQuantThreads + threadIdx.x;
  if (o >= n) return;
  const int c = o % C;
  int t = o / C;
  const int w = t % W;
  t /= W;
  const int h = t % H;
  const int b = t / H;
  const float v = load_float(x, x_bf16, b * sN + c * sC + h * sH + w * sW);
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
  out[o] = static_cast<int8_t>(__float2int_rn(q));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output value of the epilogue at (m, n).
__device__ __forceinline__ void store_out(void* out, int kind, long long idx,
                                          int acc, float deq,
                                          const void* bias, int n) {
  if (kind == kOutS32) {
    static_cast<int*>(out)[idx] = acc;
    return;
  }
  const float y = __fmul_rn(__int2float_rn(acc), deq);
  if (kind == kOutF32) {
    static_cast<float*>(out)[idx] =
        bias ? __fadd_rn(y, static_cast<const float*>(bias)[n]) : y;
  } else {
    __nv_bfloat16 h = __float2bfloat16_rn(y);
    if (bias) {
      h = __float2bfloat16_rn(__fadd_rn(
          __bfloat162float(h),
          __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n])));
    }
    static_cast<__nv_bfloat16*>(out)[idx] = h;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            ConvShape s, float s_x, const float* __restrict__ s_w,
            const void* bias, void* out, int kind) {
  __shared__ __align__(16) int8_t As[kBM * kRow];
  __shared__ __align__(16) int8_t Bs[kBN * kRow];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row / column group
  const int t = lane & 3;   // thread in the group
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;

  // each thread stages rows lr and lr + 64 of both tiles, 16 bytes of K
  // at 16 * lj
  const int lr = tid >> 2;
  const int lj = tid & 3;
  int a_b[2], a_ih[2], a_iw[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + lr + 64 * i;
    a_ok[i] = m < s.M;
    const int mm = a_ok[i] ? m : 0;
    const int ow = mm % s.Wo;
    const int r = mm / s.Wo;
    a_ih[i] = (r % s.Ho) * s.stride - s.pad_h;
    a_iw[i] = ow * s.stride - s.pad_w;
    a_b[i] = r / s.Ho;
  }

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  for (int k0 = 0; k0 < s.K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = lr + 64 * i;
      const int k = k0 + 16 * lj;
      int4 va = make_int4(0, 0, 0, 0);
      int4 vb = make_int4(0, 0, 0, 0);
      const int n = n0 + row;
      if (kVec) {
        if (a_ok[i] && k < s.K) {
          const int tap = k / s.C;
          const int ci = k - tap * s.C;
          const int kh = tap / s.KW;
          const int ih = a_ih[i] + kh;
          const int iw = a_iw[i] + (tap - kh * s.KW);
          if (ih >= 0 && ih < s.H && iw >= 0 && iw < s.W) {
            va = *reinterpret_cast<const int4*>(
                x + ((static_cast<long long>(a_b[i]) * s.H + ih) * s.W + iw) *
                        s.C + ci);
          }
        }
        if (n < s.O && k < s.K) {
          vb = *reinterpret_cast<const int4*>(
              w + static_cast<long long>(n) * s.K + k);
        }
      } else {
        int8_t* pa = reinterpret_cast<int8_t*>(&va);
        int8_t* pb = reinterpret_cast<int8_t*>(&vb);
#pragma unroll 4
        for (int e = 0; e < 16; ++e) {
          const int ke = k + e;
          if (ke >= s.K) break;
          if (a_ok[i]) {
            const int tap = ke / s.C;
            const int ci = ke - tap * s.C;
            const int kh = tap / s.KW;
            const int ih = a_ih[i] + kh;
            const int iw = a_iw[i] + (tap - kh * s.KW);
            if (ih >= 0 && ih < s.H && iw >= 0 && iw < s.W) {
              pa[e] = x[((static_cast<long long>(a_b[i]) * s.H + ih) * s.W +
                         iw) * s.C + ci];
            }
          }
          if (n < s.O) pb[e] = w[static_cast<long long>(n) * s.K + ke];
        }
      }
      *reinterpret_cast<int4*>(As + row * kRow + 16 * lj) = va;
      *reinterpret_cast<int4*>(Bs + row * kRow + 16 * lj) = vb;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = As + (wm + 16 * mi + g) * kRow + kk + 4 * t;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = Bs + (wn + 8 * ni + g) * kRow + kk + 4 * t;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // accumulator (mi, ni, c): row wm + 16 mi + g + 8 (c / 2), column
  // wn + 8 ni + 2 t + (c % 2)
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + wn + 8 * ni + 2 * t + c;
      if (n >= s.O) continue;
      const float deq = kind == kOutS32 ? 0.0f : __fmul_rn(s_x, s_w[n]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + 16 * mi + g + 8 * h;
          if (m < s.M) {
            store_out(out, kind, static_cast<long long>(m) * s.O + n,
                      acc[mi][ni][2 * h + c], deq, bias, n);
          }
        }
      }
    }
  }
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; `stream`
// is a cudaStream_t. Each returns cudaGetLastError() after its launch.

// x: the B x C x H x W tensor at element strides (sN, sC, sH, sW), float32
// or bf16; out: B * H * W * C int8, NHWC.
extern "C" int gpp_int8_quantize(const void* x, int x_bf16, int B, int C,
                                 int H, int W, long long sN, long long sC,
                                 long long sH, long long sW, float s,
                                 int8_t* out, void* stream) {
  const int n = B * C * H * W;
  if (n > 0) {
    quantize_kernel<<<(n + kQuantThreads - 1) / kQuantThreads, kQuantThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(
        x, x_bf16, n, C, H, W, sN, sC, sH, sW, s, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: B x H x W x C int8; w: O x KH x KW x C int8 (16-byte aligned when C is
// a multiple of 16); s_w: O float32; bias: O values of the output type, or
// null; out: (B Ho Wo) x O of kind 0 float32, 1 bf16, 2 int32 (the raw
// accumulators; scales and bias unused). Taps reach rows
// oh * stride - pad_h + [0, KH) and columns ow * stride - pad_w + [0, KW).
extern "C" int gpp_int8_conv(const int8_t* x, const int8_t* w, int B, int H,
                             int W, int C, int O, int KH, int KW, int stride,
                             int pad_h, int pad_w, int Ho, int Wo, float s_x,
                             const float* s_w, const void* bias, void* out,
                             int kind, void* stream) {
  ConvShape s{B, H, W, C, O, KH, KW, stride, pad_h, pad_w, Ho, Wo,
              KH * KW * C, B * Ho * Wo};
  if (s.M > 0 && O > 0) {
    const dim3 grid((s.M + kBM - 1) / kBM, (O + kBN - 1) / kBN);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C % 16 == 0) {
      conv_kernel<true><<<grid, kThreads, 0, st>>>(x, w, s, s_x, s_w, bias,
                                                   out, kind);
    } else {
      conv_kernel<false><<<grid, kThreads, 0, st>>>(x, w, s, s_x, s_w, bias,
                                                    out, kind);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
