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
// gpp_int8_quantize: x (float32 or bf16) -> int8 NHWC, q = rint(x / s)
// clamped to +-127. True IEEE division (__fdiv_rn, also under
// -prec-div=true), as the JAX package divides; a multiplication by 1 / s
// rounds differently at half-way points. rintf rounds half to even, as
// jnp.round and torch.round do. Bound by bytes: 2 or 4 bytes read and 1
// written an element. An input dense in channels-last memory (every conv
// site of the detector) is one flat array in the output's order: a thread
// converts 8 consecutive elements from 16- or 32-byte loads into one
// 8-byte store, and a grid the size of the card walks the array. Any
// other strides take the general path, one thread an element.
//
// gpp_int8_conv: M = B Ho Wo output pixels by N = Cout channels over
// K = kh kw Cin, from int8 NHWC activations and int8 [Cout][kh][kw][Cin]
// weights. What bounds it: int8 tensor-core operations (2 M N K at 1,979
// TOP/s) for the trunk's 3x3 and wide 1x1 convs, bytes for the narrow ones.
// A block computes a BM x BN tile of the output (BM 64 or 128, one
// warpgroup per 64 rows; BN one of the widths of wgmma_s8.cuh, so that
// 36-, 64-, 96- and 144-channel convs fill their tile) over a range of K:
//   - K goes in steps of 128 bytes through a ring of 3 shared-memory
//     stages, each a 128-byte row of K per output row (A, the im2col rows)
//     and per channel (B, the weights), in the 128-byte swizzle that the
//     wgmma descriptors name. cp.async.cg fills a stage in 16-byte pieces;
//     a piece that lies outside the image, past M, past Cout or past K is
//     read with a source size of 0, which writes zeros: that zero fill is
//     the conv's int8 zero padding, so any padding (asymmetric SAME too) is
//     a pair of offsets. Loads run two steps ahead of the math; one
//     __syncthreads a step hands a landed stage to the math and a retired
//     one to the loads.
//   - Each warpgroup issues wgmma.mma_async m64nBNk32 s32.s8.s8 from both
//     tiles in shared memory, four per step, and retires them before the
//     next step. With 3 stages two to four blocks share an SM and cover
//     each other's waits: on the H100 that measured as fast as or faster
//     than 4 stages with one batch left in flight across the step, and
//     rings of 4 to 6 stages for blocks alone on their SM gained 5% at
//     most.
//   - Where the tiles alone leave the card's SMs idle, the host splits K
//     (kernels/int8_conv_cuda.py::plan_conv): each split writes its int32
//     partial tile to a workspace, and the last block of the tile to
//     arrive (an atomic counter per tile, which it resets to 0) adds the
//     other splits' partials to its own and runs the epilogue. Integer
//     addition is exact in any order, so every plan gives the same bits.
//     |acc| <= 18,432 x 127^2 < 2^31 at the detector's largest K.
// Where Cin is a multiple of 16 every 16-byte piece of K lies in one tap;
// otherwise (the stem, Cin 3, K 147) the pieces are gathered byte by byte
// and stored to the same swizzled stage.
// Epilogue, in the JAX package's order: deq = s_x * s_w[c] (float32),
// y = float(acc) * deq, cast to the output type, then + bias in that type
// (flax adds the bias after the conv). __fmul_rn / __fadd_rn keep the
// compiler from contracting them into an FMA. The output is [M][Cout], a
// channels-last NCHW tensor: the block stages its tile in shared memory and
// writes whole 16-byte pieces of its rows where Cout keeps them aligned;
// kind 2 writes the raw int32 accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_s8.cuh"

namespace {

constexpr int kBK = 128;     // K bytes a stage: one 128-byte swizzle row
constexpr int kStages = 3;   // ring depth
constexpr int kAlign = 1024; // a 128-byte swizzle atom: 8 rows of 128 B
constexpr int kQuantThreads = 256;
constexpr int kQuantVec = 8;  // elements a thread converts at a time

enum OutKind { kOutF32 = 0, kOutBF16 = 1, kOutS32 = 2 };

struct ConvShape {
  int B, H, W, C;         // input, NHWC
  int O, KH, KW;          // weights, [O][KH][KW][C]
  int stride, pad_h, pad_w;
  int Ho, Wo;
  int K;                  // KH * KW * C
  int M;                  // B * Ho * Wo
};

__host__ __device__ constexpr int conv_smem_bytes(int bm, int bn) {
  return kStages * (bm + bn) * kBK + kAlign;
}

// ---- quantize --------------------------------------------------------------

__device__ __forceinline__ int quantize_one(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
  return __float2int_rn(q);
}

__device__ __forceinline__ float load_float(const void* p, int is_bf16,
                                            long long i) {
  return is_bf16 ? __bfloat162float(
                       static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// general strides: one thread an element of the NHWC output
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
  out[o] = static_cast<int8_t>(quantize_one(
      load_float(x, x_bf16, b * sN + c * sC + h * sH + w * sW), s));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) |
         (static_cast<uint32_t>(d & 0xff) << 24);
}

// x dense in the output's order (channels-last memory), 16-byte aligned
template <bool kBF16>
__global__ void __launch_bounds__(kQuantThreads)
quantize_dense_kernel(const void* __restrict__ x, long long n, float s,
                      int8_t* __restrict__ out) {
  const long long groups = n / kQuantVec;
  const long long step = static_cast<long long>(gridDim.x) * kQuantThreads;
  for (long long g = blockIdx.x * static_cast<long long>(kQuantThreads) +
                     threadIdx.x;
       g < groups; g += step) {
    float v[kQuantVec];
    if (kBF16) {
      const uint4 raw = __ldg(static_cast<const uint4*>(x) + g);
      const __nv_bfloat162* h =
          reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      const float4 a = __ldg(static_cast<const float4*>(x) + 2 * g);
      const float4 b = __ldg(static_cast<const float4*>(x) + 2 * g + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
    int q[kQuantVec];
#pragma unroll
    for (int i = 0; i < kQuantVec; ++i) q[i] = quantize_one(v[i], s);
    reinterpret_cast<uint2*>(out)[g] =
        make_uint2(pack4(q[0], q[1], q[2], q[3]),
                   pack4(q[4], q[5], q[6], q[7]));
  }
  const int tail = static_cast<int>(n - groups * kQuantVec);
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const long long i = groups * kQuantVec + threadIdx.x;
    out[i] = static_cast<int8_t>(quantize_one(load_float(x, kBF16, i), s));
  }
}

// ---- conv: pipeline pieces -------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of the 16-byte piece `c` of row `r` in a 128-byte-swizzled
// tile: piece c of row r lands at piece c ^ (r % 8)
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kBK + ((c ^ (r & 7)) << 4);
}

// 16 bytes from global to shared memory, or 16 zeros where !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the shared-memory descriptor of a K-major, 128-byte-swizzled tile at
// `addr` (1,024-byte aligned, or advanced from there along K): 8-row
// groups 1,024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |                 // LBO (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |         // SBO
         (static_cast<uint64_t>(1) << 62);                  // 128B swizzle
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- conv: the kernel ------------------------------------------------------

// grid (ceil(M / BM), ceil(O / BN), splits); split z covers the K steps
// [z per, min((z + 1) per, steps)), never empty (the host's plan).
template <int BM, int BN>
__global__ void __launch_bounds__(2 * BM, BM == 128 ? 2 : 1)
conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            ConvShape s, int vec, int per, float s_x,
            const float* __restrict__ s_w, const void* bias, void* out,
            int kind, int* __restrict__ partials,
            unsigned* __restrict__ counters) {
  constexpr int kThreads = 2 * BM;           // BM / 64 warpgroups
  constexpr int kRowsPass = kThreads / 8;    // rows one pass of loads fills
  constexpr int kARows = BM / kRowsPass;     // 4
  constexpr int kBRows = (BN + kRowsPass - 1) / kRowsPass;
  constexpr int kATile = BM * kBK;
  constexpr int kStage = (BM + BN) * kBK;
  constexpr int kAcc = BN / 2;
  static_assert(BM % 64 == 0 && BN % 8 == 0, "tile shape");

  extern __shared__ uint8_t smem_raw[];
  __shared__ bool last;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~static_cast<uintptr_t>(kAlign - 1));

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int steps = (s.K + kBK - 1) / kBK;
  const int step0 = split * per;
  const int nsteps = min(steps, step0 + per) - step0;

  // this thread loads the 16-byte piece lc of K in rows lr + i kRowsPass
  const int lc = tid & 7;
  const int lr = tid >> 3;
  // A rows: the image, the input pixel of tap (0, 0) (maybe outside the
  // image) and its row and column
  int a_img[kARows], a_pix[kARows], a_ih[kARows], a_iw[kARows];
  bool a_ok[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int m = m0 + lr + i * kRowsPass;
    a_ok[i] = m < s.M;
    const int mm = a_ok[i] ? m : 0;
    const int ow = mm % s.Wo;
    const int r = mm / s.Wo;
    a_ih[i] = (r % s.Ho) * s.stride - s.pad_h;
    a_iw[i] = ow * s.stride - s.pad_w;
    a_img[i] = r / s.Ho;
    a_pix[i] = (a_img[i] * s.H + a_ih[i]) * s.W + a_iw[i];
  }
  // B rows: the offset of this thread's piece of K in its weight row
  int b_off[kBRows];
  bool b_ok[kBRows];
#pragma unroll
  for (int j = 0; j < kBRows; ++j) {
    const int n = n0 + lr + j * kRowsPass;
    b_ok[j] = lr + j * kRowsPass < BN && n < s.O;
    b_off[j] = b_ok[j] ? n * s.K + 16 * lc : 0;
  }
  // the piece of K of the next step to load, and its tap (kh, kw) and
  // channel: stages load in order, so it moves on by one step a load
  int ld_k = step0 * kBK + 16 * lc;
  int ld_ci = ld_k % s.C;
  int ld_kh = ld_k / s.C / s.KW;
  int ld_kw = ld_k / s.C - ld_kh * s.KW;

  auto load_stage = [&](int t, int slot) {
    uint8_t* As = smem + slot * kStage;
    uint8_t* Bs = As + kATile;
    const int k = t * kBK + 16 * lc;
    const bool k_ok = k < s.K;
    if (vec) {
      const int tap_off = ld_kh * s.W + ld_kw;
#pragma unroll
      for (int i = 0; i < kARows; ++i) {
        const int row = lr + i * kRowsPass;
        const bool ok = k_ok && a_ok[i] &&
                        static_cast<unsigned>(a_ih[i] + ld_kh) <
                            static_cast<unsigned>(s.H) &&
                        static_cast<unsigned>(a_iw[i] + ld_kw) <
                            static_cast<unsigned>(s.W);
        const int8_t* src =
            ok ? x + static_cast<long long>(a_pix[i] + tap_off) * s.C + ld_ci
               : x;
        cp_async16(smem_addr(As + swizzled(row, lc)), src, ok);
      }
#pragma unroll
      for (int j = 0; j < kBRows; ++j) {
        const int row = lr + j * kRowsPass;
        if (row < BN) {
          const bool ok = k_ok && b_ok[j];
          cp_async16(smem_addr(Bs + swizzled(row, lc)),
                     ok ? w + b_off[j] + t * kBK : w, ok);
        }
      }
      ld_ci += kBK;
      while (ld_ci >= s.C) {
        ld_ci -= s.C;
        if (++ld_kw == s.KW) {
          ld_kw = 0;
          ++ld_kh;
        }
      }
      return;
    }
    // byte by byte: the 16 bytes of K from k on, tap by tap; unrolled,
    // so that a piece's 16 loads are in flight together
    const int k0 = min(k, s.K);
    const int tap0 = k0 / s.C;
    const int ci0 = k0 - tap0 * s.C;
    const int kh0 = tap0 / s.KW;
    const int kw0 = tap0 - kh0 * s.KW;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int row = lr + i * kRowsPass;
      uint64_t v[2] = {0, 0};  // byte e of the piece at bits 8 (e % 8)
      int ci = ci0, kh = kh0, kw = kw0;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int ih = a_ih[i] + kh;
        const int iw = a_iw[i] + kw;
        if (a_ok[i] && k + e < s.K && ih >= 0 && ih < s.H && iw >= 0 &&
            iw < s.W) {
          const uint64_t b = static_cast<uint8_t>(
              x[((static_cast<long long>(a_img[i]) * s.H + ih) * s.W + iw) *
                    s.C + ci]);
          v[e / 8] |= b << (8 * (e % 8));
        }
        if (++ci == s.C) {
          ci = 0;
          if (++kw == s.KW) {
            kw = 0;
            ++kh;
          }
        }
      }
      *reinterpret_cast<ulonglong2*>(As + swizzled(row, lc)) =
          make_ulonglong2(v[0], v[1]);
    }
#pragma unroll
    for (int j = 0; j < kBRows; ++j) {
      const int row = lr + j * kRowsPass;
      const int n = n0 + row;
      if (row < BN) {
        uint64_t v[2] = {0, 0};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          if (n < s.O && k + e < s.K) {
            const uint64_t b = static_cast<uint8_t>(
                w[static_cast<long long>(n) * s.K + k + e]);
            v[e / 8] |= b << (8 * (e % 8));
          }
        }
        *reinterpret_cast<ulonglong2*>(Bs + swizzled(row, lc)) =
            make_ulonglong2(v[0], v[1]);
      }
    }
  };

  int acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;

  const int wg = tid >> 7;
  // loads run kStages - 1 steps ahead of the math
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nsteps) load_stage(step0 + p, p);
    cp_async_commit();
  }
  int slot = 0;  // stage of step t; step t + kStages - 1 loads into the
                 // one before it, retired by step t - 1
#pragma unroll 1
  for (int t = 0; t < nsteps; ++t) {
    // step t has landed (this thread's pieces), is visible to the async
    // proxy that wgmma reads through, and every thread's pieces are in;
    // every warpgroup has also retired the wgmma of step t - 1, whose
    // stage the next load overwrites
    cp_async_wait<kStages - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + kStages - 1 < nsteps) {
      load_stage(step0 + t + kStages - 1, slot == 0 ? kStages - 1 : slot - 1);
    }
    cp_async_commit();

    const uint8_t* stage = smem + slot * kStage;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    const uint32_t a = smem_addr(stage + wg * 64 * kBK);
    const uint32_t b = smem_addr(stage + kATile);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      gpp::Wgmma<BN>::mma(acc, smem_desc(a + kk), smem_desc(b + kk));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  }
  if (splits > 1) {
    // partial tiles in accumulator order: coalesced, and summed in place
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int* part = partials + static_cast<long long>(tile) * splits * BM * BN;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      __stcg(part + split * BM * BN + i * kThreads + tid, acc[i]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      unsigned* count = counters + tile;
      last = atomicAdd(count, 1u) == static_cast<unsigned>(splits - 1);
      if (last) *count = 0;  // every split has arrived: ready for reuse
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll 1
    for (int z = 0; z < splits; ++z) {
      if (z == split) continue;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        acc[i] += __ldcg(part + z * BM * BN + i * kThreads + tid);
      }
    }
  }

  // The epilogue goes through shared memory (the ring is free once every
  // warpgroup has retired its wgmma): the accumulators into a BM x BN
  // int32 tile, beside each channel's deq = s_x * s_w[n] and bias (a bf16
  // bias widened, exactly); then each thread turns 16-byte pieces of the
  // output's rows into the output type and writes them, whole where
  // Cout's rows keep that alignment. The loop over the pieces stays
  // rolled: a small block is latency-bound, and unrolled code costs it
  // instruction fetches.
  __shared__ float deq_s[BN], bias_s[BN];
  constexpr int kPitch = BN + 4;  // ints; rows stay 16-byte aligned
  int* tile_s = reinterpret_cast<int*>(smem);
  cp_async_wait<0>();
  __syncthreads();
  for (int c = tid; c < BN; c += kThreads) {
    const int n = n0 + c;
    float d = 0.f, bv = 0.f;
    if (n < s.O && kind != kOutS32) {
      d = __fmul_rn(s_x, s_w[n]);
      if (bias) {
        bv = kind == kOutF32
                 ? static_cast<const float*>(bias)[n]
                 : __bfloat162float(
                       static_cast<const __nv_bfloat16*>(bias)[n]);
      }
    }
    deq_s[c] = d;
    bias_s[c] = bv;
  }
  const int lane = tid & 31;
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<int2*>(tile_s + (r0 + 8 * h) * kPitch + 8 * j +
                               2 * (lane & 3)) =
          make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  __syncthreads();
  const int per_piece = kind == kOutBF16 ? 8 : 4;
  const int pieces = BN / per_piece;  // per row
  const int cols = min(BN, s.O - n0);
  const bool whole = s.O % per_piece == 0;  // 16-byte aligned rows
#pragma unroll 1
  for (int i = tid; i < BM * pieces; i += kThreads) {
    const int r = i / pieces;
    const int c = (i - r * pieces) * per_piece;
    const int m = m0 + r;
    if (m >= s.M || c >= cols) continue;
    const int count = min(per_piece, cols - c);
    const int* a = tile_s + r * kPitch + c;
    const long long o = static_cast<long long>(m) * s.O + n0 + c;
    if (kind == kOutS32) {
      const int4 v = *reinterpret_cast<const int4*>(a);
      int* to = static_cast<int*>(out) + o;
      if (whole && count == 4) {
        *reinterpret_cast<int4*>(to) = v;
      } else {
        const int vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e < count) to[e] = vs[e];
        }
      }
    } else if (kind == kOutF32) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = __fmul_rn(__int2float_rn(a[e]), deq_s[c + e]);
        v[e] = bias ? __fadd_rn(y, bias_s[c + e]) : y;
      }
      float* to = static_cast<float*>(out) + o;
      if (whole && count == 4) {
        *reinterpret_cast<float4*>(to) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e < count) to[e] = v[e];
        }
      }
    } else {
      uint32_t v[8];  // bf16 bits
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        __nv_bfloat16 h = __float2bfloat16_rn(
            __fmul_rn(__int2float_rn(a[e]), deq_s[c + e]));
        if (bias) {
          h = __float2bfloat16_rn(
              __fadd_rn(__bfloat162float(h), bias_s[c + e]));
        }
        v[e] = __bfloat16_as_ushort(h);
      }
      unsigned short* to = static_cast<unsigned short*>(out) + o;
      if (whole && count == 8) {
        *reinterpret_cast<uint4*>(to) = make_uint4(
            v[0] | (v[1] << 16), v[2] | (v[3] << 16), v[4] | (v[5] << 16),
            v[6] | (v[7] << 16));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (e < count) to[e] = static_cast<unsigned short>(v[e]);
        }
      }
    }
  }
}

// ---- conv: host side -------------------------------------------------------

// the compiled tiles (BM, BN): kernels/int8_conv_cuda.py::TILES
#define GPP_INT8_TILES(X)                                 \
  X(64, 48) X(64, 64) X(64, 96) X(64, 128) X(64, 144)     \
  X(128, 48) X(128, 64) X(128, 96) X(128, 128) X(128, 144)

template <int BM, int BN>
cudaError_t opt_in_smem() {
  // once per device: above 48 KB a block's shared memory is opt-in
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(conv_kernel<BM, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             conv_smem_bytes(BM, BN));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int BM, int BN>
cudaError_t tile_config(int* threads, int* smem, int* per_sm) {
  *threads = 2 * BM;
  *smem = conv_smem_bytes(BM, BN);
  const cudaError_t err = opt_in_smem<BM, BN>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, conv_kernel<BM, BN>, 2 * BM, *smem);
}

template <int BM, int BN>
cudaError_t launch_conv(const int8_t* x, const int8_t* w, const ConvShape& s,
                        int splits, float s_x, const float* s_w,
                        const void* bias, void* out, int kind, int* partials,
                        unsigned* counters, cudaStream_t stream) {
  cudaError_t err = opt_in_smem<BM, BN>();
  if (err != cudaSuccess) return err;
  const int steps = (s.K + kBK - 1) / kBK;
  const int per = (steps + splits - 1) / splits;
  const dim3 grid((s.M + BM - 1) / BM, (s.O + BN - 1) / BN,
                  (steps + per - 1) / per);
  conv_kernel<BM, BN><<<grid, 2 * BM, conv_smem_bytes(BM, BN), stream>>>(
      x, w, s, s.C % 16 == 0, per, s_x, s_w, bias, out, kind, partials,
      counters);
  return cudaGetLastError();
}

int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev >= 64) dev = 63;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 1;
  }
  return counts[dev];
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; `stream`
// is a cudaStream_t. Each returns a CUDA error code, cudaGetLastError()
// after a launch.

// x: the B x C x H x W tensor at element strides (sN, sC, sH, sW), float32
// or bf16; out: B * H * W * C int8, NHWC. `dense`: x lies in channels-last
// memory without gaps (the strides of an NHWC array) from a 16-byte
// aligned address.
extern "C" int gpp_int8_quantize(const void* x, int x_bf16, int B, int C,
                                 int H, int W, long long sN, long long sC,
                                 long long sH, long long sW, int dense,
                                 float s, int8_t* out, void* stream) {
  const long long n = static_cast<long long>(B) * C * H * W;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (dense) {
    const long long groups = n / kQuantVec;
    const long long want = (groups + kQuantThreads - 1) / kQuantThreads;
    const long long cap = 8LL * sm_count();  // a grid the card holds
    const int blocks = static_cast<int>(want < cap ? want : cap);
    if (x_bf16) {
      quantize_dense_kernel<true><<<blocks, kQuantThreads, 0, st>>>(x, n, s,
                                                                    out);
    } else {
      quantize_dense_kernel<false><<<blocks, kQuantThreads, 0, st>>>(x, n, s,
                                                                     out);
    }
  } else {
    quantize_kernel<<<static_cast<int>((n + kQuantThreads - 1) /
                                       kQuantThreads),
                      kQuantThreads, 0, st>>>(x, x_bf16, static_cast<int>(n),
                                              C, H, W, sN, sC, sH, sW, s,
                                              out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Threads, dynamic shared memory and resident blocks per SM of the conv
// kernel's tile (bm, bn); cudaErrorInvalidValue for a tile not compiled.
extern "C" int gpp_int8_conv_config(int bm, int bn, int* threads, int* smem,
                                    int* blocks_per_sm) {
#define GPP_CONFIG(BM, BN)                                               \
  if (bm == BM && bn == BN)                                              \
    return static_cast<int>(                                             \
        tile_config<BM, BN>(threads, smem, blocks_per_sm));
  GPP_INT8_TILES(GPP_CONFIG)
#undef GPP_CONFIG
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: B x H x W x C int8; w: O x KH x KW x C int8 (16-byte aligned when C is
// a multiple of 16); s_w: O float32; bias: O values of the output type, or
// null; out: (B Ho Wo) x O of kind 0 float32, 1 bf16, 2 int32 (the raw
// accumulators; scales and bias unused). Taps reach rows
// oh * stride - pad_h + [0, KH) and columns ow * stride - pad_w + [0, KW).
// One launch of tile (bm, bn) over `splits` ranges of K (at most
// ceil(K / 128); fewer if the ranges round so). With more than one split,
// `partials` holds ceil(M / bm) ceil(O / bn) splits bm bn int32 and
// `counters` ceil(M / bm) ceil(O / bn) zeros, which the launch leaves at 0.
extern "C" int gpp_int8_conv(const int8_t* x, const int8_t* w, int B, int H,
                             int W, int C, int O, int KH, int KW, int stride,
                             int pad_h, int pad_w, int Ho, int Wo, float s_x,
                             const float* s_w, const void* bias, void* out,
                             int kind, int bm, int bn, int splits,
                             int* partials, unsigned* counters,
                             void* stream) {
  const ConvShape s{B, H, W, C, O, KH, KW, stride, pad_h, pad_w, Ho, Wo,
                    KH * KW * C, B * Ho * Wo};
  const int steps = (s.K + kBK - 1) / kBK;
  if (s.M <= 0 || O <= 0) return static_cast<int>(cudaGetLastError());
  if (splits < 1 || splits > steps || (splits > 1 && !(partials && counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GPP_LAUNCH(BM, BN)                                                 \
  if (bm == BM && bn == BN)                                                \
    return static_cast<int>(launch_conv<BM, BN>(x, w, s, splits, s_x, s_w, \
                                                bias, out, kind, partials, \
                                                counters, st));
  GPP_INT8_TILES(GPP_LAUNCH)
#undef GPP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
