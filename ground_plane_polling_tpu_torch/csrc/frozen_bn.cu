// The frozen batch norm of a ResNet site, its residual add and its ReLU in
// one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes the site as jnp
// elementwise code (ground_plane_polling_tpu/models/common.py::
// FrozenBatchNorm, models/resnet.py::BottleneckBlock), which XLA fuses
// into the conv's epilogue on the TPU. The port's plain form is the same
// expression in PyTorch (models/common.py::frozen_bn_act), which runs as
// one elementwise pass per operation: a multiply, an add, the residual
// add and the ReLU's clamp, each reading and writing the whole map, and
// the BN's broadcast over the innermost (channel) dimension of a
// channels-last map does not vectorize.
//
// x: an NCHW map in channels-last memory (B x H x W x C), float32 or
// bf16, C a multiple of 8; s, b (C,) of the same type. Every output is
//   y = x * s + b                     (kResidual 0)
//   y = (x * s + b) + r               (kResidual 1: identity shortcut)
//   y = (x * s + b) + (p * sp + bp)   (kResidual 2: the projection conv's
//                                      output p, its BN inline)
// then the ReLU where kRelu (every site with a shortcut takes it; the
// projection's own BN is inline here and takes none),
// with the roundings of the plain passes: each multiply and each add in
// float32 (__fmul_rn / __fadd_rn, no FMA), rounded to the map's type after
// every operation as a bf16 TensorIterator op rounds its float32 result;
// the ReLU is torch's clamp_min(y, 0): NaN stays NaN, else fmaxf(y, 0).
// So the output is bit for bit the plain passes'.
//
// What bounds it: bytes. A site reads its map once (twice with a
// shortcut) and writes it once, at a handful of float32 operations an
// element. The design moves each byte once, 16 at a time:
//   - a thread loads 16-byte vectors (8 bf16 or 4 float32 values, all of
//     one pixel's channels since C is a multiple of 8) and keeps kUnroll
//     of them (and their shortcut vectors) in flight before it computes;
//     a warp's loads are 512 contiguous bytes;
//   - a block copies s, b (and sp, bp) once into shared memory, in the
//     map's type, and reads a vector's channels there with one 16-byte
//     load each, the channel taken from the vector's flat index modulo C;
//   - the grid is a few waves of blocks over the SMs, each walking the map
//     with a stride of the whole grid.
// The wrapper (kernels/frozen_bn_cuda.py) allocates the output; the launch
// allocates nothing and does not synchronise, so it can be captured in a
// CUDA graph as it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // vectors a thread keeps in flight
constexpr int kBlocksPerSm = 8;   // blocks a launch gives each SM

__device__ __forceinline__ uint32_t& word(uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The lanes of a 16-byte vector of T as float32 values (exact), a float32
// result stored into a lane in T, and a float32 result rounded to T and
// back: the rounding of a plain pass whose output is T.
template <typename T> struct Lanes;

template <> struct Lanes<float> {
  static constexpr int kCount = 4;
  static __device__ __forceinline__ float get(uint4 v, int l) {
    return __uint_as_float(word(v, l));
  }
  static __device__ __forceinline__ void put(uint4& v, int l, float f) {
    word(v, l) = __float_as_uint(f);
  }
  static __device__ __forceinline__ float round(float f) { return f; }
};

template <> struct Lanes<__nv_bfloat16> {
  static constexpr int kCount = 8;
  static __device__ __forceinline__ float get(uint4 v, int l) {
    const uint32_t w = word(v, l / 2);
    return __uint_as_float(l % 2 ? w & 0xffff0000u : w << 16);
  }
  static __device__ __forceinline__ void put(uint4& v, int l, float f) {
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(f));
    uint32_t& w = word(v, l / 2);
    w = l % 2 ? (w & 0xffffu) | (h << 16) : (w & 0xffff0000u) | h;
  }
  static __device__ __forceinline__ float round(float f) {
    return __bfloat162float(__float2bfloat16_rn(f));
  }
};

// one binary op of the plain passes: float32 math, the result in T
template <typename T>
__device__ __forceinline__ float mul(float a, float b) {
  return Lanes<T>::round(__fmul_rn(a, b));
}
template <typename T>
__device__ __forceinline__ float add(float a, float b) {
  return Lanes<T>::round(__fadd_rn(a, b));
}

// torch's clamp_min(v, 0): NaN propagates, else ::max(v, 0) = fmaxf
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

template <typename T, bool kRelu, int kResidual>
__global__ void __launch_bounds__(kThreads)
frozen_bn_kernel(const T* __restrict__ x, const T* __restrict__ r,
                 const T* __restrict__ s, const T* __restrict__ b,
                 const T* __restrict__ sp, const T* __restrict__ bp,
                 T* __restrict__ out, uint32_t vectors,
                 uint32_t channel_vectors) {
  using L = Lanes<T>;
  constexpr int kArrays = kResidual == 2 ? 4 : 2;
  extern __shared__ uint4 params[];  // kArrays x channel_vectors vectors
  {
    const uint4* from[4] = {reinterpret_cast<const uint4*>(s),
                            reinterpret_cast<const uint4*>(b),
                            reinterpret_cast<const uint4*>(sp),
                            reinterpret_cast<const uint4*>(bp)};
#pragma unroll
    for (int a = 0; a < kArrays; ++a)
      for (uint32_t i = threadIdx.x; i < channel_vectors; i += kThreads)
        params[a * channel_vectors + i] = __ldg(from[a] + i);
  }
  __syncthreads();

  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* rv = reinterpret_cast<const uint4*>(r);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const uint32_t stride = gridDim.x * kThreads * kUnroll;
  for (uint32_t base = blockIdx.x * kThreads * kUnroll + threadIdx.x;
       base < vectors; base += stride) {
    uint4 in[kUnroll], res[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t v = base + u * kThreads;
      if (v < vectors) {
        in[u] = __ldcs(xv + v);  // read once: stream past the caches
        if (kResidual) res[u] = __ldcs(rv + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t v = base + u * kThreads;
      if (v >= vectors) continue;
      const uint32_t c = v % channel_vectors;
      const uint4 ps = params[c], pb = params[channel_vectors + c];
      uint4 psp = ps, pbp = pb, y = make_uint4(0, 0, 0, 0);
      if (kResidual == 2) {
        psp = params[2 * channel_vectors + c];
        pbp = params[3 * channel_vectors + c];
      }
#pragma unroll
      for (int l = 0; l < L::kCount; ++l) {
        float t = add<T>(mul<T>(L::get(in[u], l), L::get(ps, l)),
                         L::get(pb, l));
        if (kResidual) {
          float sc = L::get(res[u], l);
          if (kResidual == 2)
            sc = add<T>(mul<T>(sc, L::get(psp, l)), L::get(pbp, l));
          t = add<T>(t, sc);
        }
        if (kRelu) t = relu(t);
        L::put(y, l, t);
      }
      ov[v] = y;
    }
  }
}

template <typename T, bool kRelu, int kResidual>
int launch(const void* x, const void* r, const void* s, const void* b,
           const void* sp, const void* bp, void* out, long long numel,
           int channels, int sms, cudaStream_t stream) {
  constexpr int kLanes = Lanes<T>::kCount;
  constexpr int kArrays = kResidual == 2 ? 4 : 2;
  const uint32_t vectors = static_cast<uint32_t>(numel / kLanes);
  const uint32_t channel_vectors = static_cast<uint32_t>(channels / kLanes);
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  long long blocks = (vectors + per_block - 1) / per_block;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm)
    blocks = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks < 1) blocks = 1;
  const size_t smem = static_cast<size_t>(kArrays) * channels * sizeof(T);
  frozen_bn_kernel<T, kRelu, kResidual>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(r),
          static_cast<const T*>(s), static_cast<const T*>(b),
          static_cast<const T*>(sp), static_cast<const T*>(bp),
          static_cast<T*>(out), vectors, channel_vectors);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* r, const void* s, const void* b,
             const void* sp, const void* bp, void* out, int relu,
             int residual, long long numel, int channels, int sms,
             cudaStream_t stream) {
  // a site with a shortcut always takes its ReLU
  if (residual == 1)
    return launch<T, true, 1>(x, r, s, b, sp, bp, out, numel, channels, sms,
                              stream);
  if (residual == 2)
    return launch<T, true, 2>(x, r, s, b, sp, bp, out, numel, channels, sms,
                              stream);
  return relu ? launch<T, true, 0>(x, r, s, b, sp, bp, out, numel, channels,
                                   sms, stream)
              : launch<T, false, 0>(x, r, s, b, sp, bp, out, numel,
                                    channels, sms, stream);
}

}  // namespace

// kind: 0 float32, 1 bf16; residual: 0 none, 1 identity (r), 2 projected
// (r = p, with sp, bp), both with the ReLU whatever `relu` says. Returns
// the launch's CUDA error (0: launched).
extern "C" int gpp_frozen_bn(const void* x, const void* r, const void* s,
                             const void* b, const void* sp, const void* bp,
                             void* out, int kind, int relu, int residual,
                             long long numel, int channels, int sms,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 1)
    return dispatch<__nv_bfloat16>(x, r, s, b, sp, bp, out, relu, residual,
                                   numel, channels, sms, st);
  return dispatch<float>(x, r, s, b, sp, bp, out, relu, residual, numel,
                         channels, sms, st);
}
