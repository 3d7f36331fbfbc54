// Ground-plane polling, fused with its preparation and its arg-min
// epilogue, for Hopper (sm_90a).
//
// Replaces ground_plane_polling_tpu/kernels/polling_pallas.py::_poll_kernel
// together with what fit_road_planes_pallas runs around it: the plane
// normalization, the rays and expected distances before the pallas_call,
// and the jnp epilogue after it (vote gating, first-index argmin, keyplane
// gather, keypoint reconstruction, residual / 6). One launch takes the raw
// inputs of fit_road_planes (float32 or bf16, widened here, which is exact)
// and writes only each detection's winner: the (B, D, P) vote and residual
// scoreboards of the TPU kernel are never written.
//
// What bounds it: per (detection, plane) pair this formulation does 123
// f32 operations (3 ray-plane intersections with their divisions, the top
// point, the winding test, 6 distances, the votes and the arg-min state;
// counted in chip_smoke.py::POLL_OPS) on 16 bytes of plane, 9 of them on
// the MUFU pipe (4 reciprocals, 5 square roots), which issues 16 a clock
// per SM against 128 f32 lanes. At B 4, D 100 and P 21,634 that is
// 1.07 GFLOP (0.016 ms at 67 TFLOP/s) and 78 M MUFU operations (0.019 ms)
// on 1.4 MB of planes (under 0.001 ms): the MUFU pipe bounds it.
//
// Layout: a block holds kWarps detections of one batch element, one warp
// each, and one split of the plane axis. The block stages its split in
// tiles of kTile planes in shared memory, normalized once as they are
// loaded and read by all its warps; a warp's lanes stride over each tile.
// The grid is (splits, detection groups, batch); the wrapper picks the
// number of splits so that the grid fills the card once (see
// kernels/polling_cuda.py::plan_splits), at b1 as at b4. Every
// intermediate of a pair stays in registers; a plane is read from memory
// and normalized once per block, not once per detection.
//
// The splits merge exactly: each lane keeps a PollState of the planes it
// saw, the warp merges its lanes with shuffles, and lane 0 writes the state
// of its (detection, split) into a workspace. The last block of each
// detection group to finish (an atomic counter per group, which that block
// resets to 0 for the next launch) merges the splits' states, picks the
// winner and rebuilds its keypoints.
//
// Arithmetic: built with FMA contraction and approximate square root
// (-fmad=true -prec-sqrt=false -ftz=true); the plane loop divides with
// __fdividef, the winner's keypoints with IEEE division, and a plane is
// scaled by rsqrtf of its normal's squared length. Two identities of the
// geometry: the top point's
// perp = d_t x (n x d_t) = n |d_t|^2 - d_t (d_t . n), so perp . X_m and
// perp . n need d_t . n and two per-detection constants; and
// |X_m - X_t| = |t| |n| = |t| for a unit normal. The plain PyTorch twin
// computes the cross products and norms as written; the two agree within
// the comparison's tolerances (chip_smoke.py phase 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // detections per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 4 * kThreads;      // planes per shared-memory tile
constexpr int kStateInts = 5;
constexpr int kNone = 0x7fffffff;
constexpr float kPollThreshold = 0.7f;   // metres
constexpr float kDisqualified = 100.0f;
constexpr float kNumPolls = 6.0f;

// Running arg-min state over a set of planes, equivalent to keeping, per
// vote level, the least residual with its first index, the first index and
// the first NaN index, once only the highest level seen so far can win:
//   level  the highest vote count seen;
//   key    the least (key, index) at that level, where a NaN residual has
//          key 0 and a residual r >= 0 has key bits(r) + 1: unsigned order
//          of the key is the order of r, so the first NaN comes first and
//          then the least residual (winding-masked planes count with 100);
//   best   the index of that least key;
//   first  the first plane at that level;
//   low    the first plane at any lower level.
// Planes below the top level score 100 in the unfused formulation, so among
// them only the first index matters.
struct PollState {
  int level;
  unsigned key;
  int best;
  int first;
  int low;
};

__device__ __forceinline__ PollState empty_state() {
  return PollState{-1, 0xffffffffu, kNone, kNone, kNone};
}

__device__ __forceinline__ unsigned residual_key(float res) {
  return isnan(res) ? 0u : __float_as_uint(res) + 1u;
}

// Merge `b` into `a`; exact for any order of merging.
__device__ __forceinline__ void merge(PollState& a, const PollState& b) {
  if (b.level > a.level) {
    const int low = min(min(a.low, a.first), b.low);
    a = b;
    a.low = low;
  } else if (b.level == a.level) {
    if (b.key < a.key || (b.key == a.key && b.best < a.best)) {
      a.key = b.key;
      a.best = b.best;
    }
    a.first = min(a.first, b.first);
    a.low = min(a.low, b.low);
  } else {
    a.low = min(a.low, min(b.first, b.low));
  }
}

// Add plane `idx` to a state that has seen only planes of lower index (a
// lane walks its planes in increasing order).
__device__ __forceinline__ void add_plane(PollState& s, int level, float res,
                                          int idx) {
  const unsigned key = residual_key(res);
  if (level > s.level) {
    s.low = min(s.low, s.first);
    s.level = level;
    s.key = key;
    s.best = idx;
    s.first = idx;
  } else if (level == s.level) {
    if (key < s.key) {
      s.key = key;
      s.best = idx;
    }
  } else {
    s.low = min(s.low, idx);
  }
}

__device__ __forceinline__ PollState shfl_state(const PollState& s, int lane) {
  return PollState{__shfl_sync(0xffffffffu, s.level, lane),
                   __shfl_sync(0xffffffffu, s.key, lane),
                   __shfl_sync(0xffffffffu, s.best, lane),
                   __shfl_sync(0xffffffffu, s.first, lane),
                   __shfl_sync(0xffffffffu, s.low, lane)};
}

__device__ __forceinline__ PollState warp_merge(PollState s) {
  for (int off = 16; off > 0; off >>= 1) {
    merge(s, shfl_state(s, (threadIdx.x + off) & 31));
  }
  return s;
}

// element i of a float32 (bf16 == 0) or bf16 (bf16 != 0) array, widened
__device__ __forceinline__ float load_float(const void* p, int64_t i,
                                            int bf16) {
  if (bf16) {
    const unsigned short h = static_cast<const unsigned short*>(p)[i];
    return __uint_as_float(static_cast<unsigned>(h) << 16);
  }
  return static_cast<const float*>(p)[i];
}

// torch.sign: 1, -1, or 0 for 0 and NaN
__device__ __forceinline__ float torch_sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Plane p of batch element b, its b component made negative and its normal
// scaled to unit length; b == 0 gives a NaN plane (0 x inf), as in the JAX
// package.
__device__ __forceinline__ float4 load_plane(const void* planes, int bf16,
                                             int64_t p) {
  const float s = -torch_sign(load_float(planes, 4 * p + 1, bf16));
  const float a = load_float(planes, 4 * p, bf16) * s;
  const float b = load_float(planes, 4 * p + 1, bf16) * s;
  const float c = load_float(planes, 4 * p + 2, bf16) * s;
  const float d = load_float(planes, 4 * p + 3, bf16) * s;
  const float inv = rsqrtf(a * a + b * b + c * c);
  return make_float4(a * inv, b * inv, c * inv, d * inv);
}

// What a detection needs per plane: its four forward rays (l, m, r, t) and
// its six expected distances, plus |d_t|^2 and d_t . d_m for the top point.
struct Detection {
  float ray[12];
  float expected[6];
  float tt, tm;
};

// The rays P_inv (u, v, 1) of the four keypoints, sign-fixed by z as
// torch.sign does it (0 stays 0), and the expected distance of each poll;
// an orientation outside [0, 4) (padded rows carry -1) picks none, like
// JAX's one_hot, which leaves polls 1, 2, 4 and 5 at 0.
__device__ __forceinline__ Detection load_detection(
    const void* boxes, int boxes_bf16, const void* dims, int dims_bf16,
    const void* orients, int orients_int64, const void* p_inv,
    int p_inv_bf16, int64_t b, int64_t det) {
  Detection q;
  float P[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) P[i] = load_float(p_inv, 12 * b + i, p_inv_bf16);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float u = load_float(boxes, 12 * det + 4 + 2 * k, boxes_bf16);
    const float v = load_float(boxes, 12 * det + 5 + 2 * k, boxes_bf16);
    float r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) r[i] = P[3 * i] * u + P[3 * i + 1] * v + P[3 * i + 2];
    const float s = torch_sign(r[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) q.ray[3 * k + i] = r[i] * s;
  }
  const float h = load_float(dims, 3 * det, dims_bf16);
  const float w = load_float(dims, 3 * det + 1, dims_bf16);
  const float l = load_float(dims, 3 * det + 2, dims_bf16);
  const int64_t o = orients_int64 ? static_cast<const int64_t*>(orients)[det]
                                  : static_cast<const int*>(orients)[det];
  const float d_hw = sqrtf(h * h + w * w);
  const float d_wl = sqrtf(w * w + l * l);
  const float d_hl = sqrtf(h * h + l * l);
  const float f0 = o == 0, f1 = o == 1, f2 = o == 2, f3 = o == 3;
  q.expected[0] = h;
  q.expected[1] = f0 * l + f1 * w + f2 * w + f3 * l;
  q.expected[2] = f0 * w + f1 * l + f2 * l + f3 * w;
  q.expected[3] = d_wl;
  q.expected[4] = f0 * d_hl + f1 * d_hw + f2 * d_hw + f3 * d_hl;
  q.expected[5] = f0 * d_hw + f1 * d_hl + f2 * d_hl + f3 * d_hw;
  const float* t = q.ray + 9;
  q.tt = t[0] * t[0] + t[1] * t[1] + t[2] * t[2];
  q.tm = t[0] * q.ray[3] + t[1] * q.ray[4] + t[2] * q.ray[5];
  return q;
}

// Keypoints X (l, m, r, t) of a detection on a unit-normal plane: the l/m/r
// rays meet the plane at |off / (n.r)| r; the top point is
// X_t = X_m - t n with t = (perp . X_m) / (perp . n) and
// perp = d_t x (n x d_t) = n |d_t|^2 - d_t (d_t . n), so that
// perp . X_m = s_m (|d_t|^2 (n . d_m) - (d_t . n)(d_t . d_m)) and
// perp . n = |d_t|^2 - (d_t . n)^2. Returns t.
template <bool kIeee>
__device__ __forceinline__ float divide(float x, float y) {
  return kIeee ? __fdiv_rn(x, y) : __fdividef(x, y);
}

// Fast division (2 ulp) in the plane loop; IEEE division (kIeee) where the
// winner's keypoints are written, since a ray that grazes the plane
// amplifies the rounding of its intersection.
template <bool kIeee>
__device__ __forceinline__ float keypoints(const Detection& q, float4 pl,
                                           float X[12]) {
  float ndot[3], s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* r = q.ray + 3 * k;
    ndot[k] = r[0] * pl.x + r[1] * pl.y + r[2] * pl.z;
    s[k] = fabsf(divide<kIeee>(pl.w, ndot[k]));
    X[3 * k] = r[0] * s[k];
    X[3 * k + 1] = r[1] * s[k];
    X[3 * k + 2] = r[2] * s[k];
  }
  const float* d = q.ray + 9;
  const float tn = d[0] * pl.x + d[1] * pl.y + d[2] * pl.z;
  const float t =
      divide<kIeee>(s[1] * (q.tt * ndot[1] - tn * q.tm), q.tt - tn * tn);
  X[9] = X[3] - t * pl.x;
  X[10] = X[4] - t * pl.y;
  X[11] = X[5] - t * pl.z;
  return t;
}

__device__ __forceinline__ float dist3(const float* a, const float* b) {
  const float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
  return sqrtf(dx * dx + dy * dy + dz * dz);
}

// Votes and residual of a detection on a plane: six polls of keypoint
// distances against the expected ones, each voting within 0.7 m; the
// residual is their sum, 100 where the l/m/r triangle winds the wrong way.
__device__ __forceinline__ float score(const Detection& q, float4 pl,
                                       int& votes) {
  float X[12];
  const float t = keypoints<false>(q, pl, X);
  const float* Xl = X;
  const float* Xm = X + 3;
  const float* Xr = X + 6;
  const float* Xt = X + 9;
  // winding: y component of (X_l - X_m) x (X_r - X_m)
  const float wind_y =
      (Xl[2] - Xm[2]) * (Xr[0] - Xm[0]) - (Xl[0] - Xm[0]) * (Xr[2] - Xm[2]);
  const float* e = q.expected;
  const float r0 = fabsf(fabsf(t) - e[0]);  // |X_m - X_t| = |t|
  const float r1 = fabsf(dist3(Xl, Xm) - e[1]);
  const float r2 = fabsf(dist3(Xm, Xr) - e[2]);
  const float r3 = fabsf(dist3(Xl, Xr) - e[3]);
  const float r4 = fabsf(dist3(Xl, Xt) - e[4]);
  const float r5 = fabsf(dist3(Xr, Xt) - e[5]);
  votes = (r0 <= kPollThreshold) + (r1 <= kPollThreshold) +
          (r2 <= kPollThreshold) + (r3 <= kPollThreshold) +
          (r4 <= kPollThreshold) + (r5 <= kPollThreshold);
  return wind_y < 0.0f ? kDisqualified : r0 + r1 + r2 + r3 + r4 + r5;
}

__global__ void __launch_bounds__(kThreads, 4)
poll_kernel(const void* __restrict__ boxes, int boxes_bf16,     // (B, D, 12)
            const void* __restrict__ dims, int dims_bf16,       // (B, D, 3)
            const void* __restrict__ orients, int orients_int64,  // (B, D)
            const void* __restrict__ p_inv, int p_inv_bf16,     // (B, 4, 3)
            const void* __restrict__ planes, int planes_bf16,   // (B, P, 4)
            int D, int P,
            float* __restrict__ keypoints_out,  // (B, D, 12)
            float* __restrict__ keyplanes_out,  // (B, D, 4)
            float* __restrict__ residuals_out,  // (B, D)
            int* __restrict__ states,           // (B, D, splits, 5)
            unsigned* __restrict__ counters) {  // (B, detection groups)
  __shared__ float4 tile[kTile];
  __shared__ bool merging;

  const int splits = gridDim.x, split = blockIdx.x;
  const int64_t b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = blockIdx.y * kWarps + warp;
  const bool active = d < D;
  const int64_t det = b * D + d;

  Detection q;
  if (active) {
    q = load_detection(boxes, boxes_bf16, dims, dims_bf16, orients,
                       orients_int64, p_inv, p_inv_bf16, b, det);
  }

  const int chunk = (P + splits - 1) / splits;
  const int begin = min(P, split * chunk), end = min(P, begin + chunk);
  PollState st = empty_state();
  for (int t0 = begin; t0 < end; t0 += kTile) {
    const int n = min(kTile, end - t0);
    __syncthreads();  // the previous tile is read
    for (int i = threadIdx.x; i < n; i += kThreads) {
      tile[i] = load_plane(planes, planes_bf16, b * P + t0 + i);
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 1
    for (int i = lane; i < n; i += 32) {
      int votes;
      const float res = score(q, tile[i], votes);
      add_plane(st, votes, res, t0 + i);
    }
  }

  // this split's state of each detection into the workspace
  if (active) {
    st = warp_merge(st);
    if (lane == 0) {
      int* out = states + (det * splits + split) * kStateInts;
      out[0] = st.level;
      out[1] = static_cast<int>(st.key);
      out[2] = st.best;
      out[3] = st.first;
      out[4] = st.low;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* count = counters + b * gridDim.y + blockIdx.y;
    merging = atomicAdd(count, 1u) == static_cast<unsigned>(splits - 1);
    if (merging) *count = 0;  // every split has arrived: ready for reuse
  }
  __syncthreads();
  if (!merging || !active) return;
  __threadfence();

  // the last block of the group merges every split's state
  st = empty_state();
  for (int s = lane; s < splits; s += 32) {
    const int* in = states + (det * splits + s) * kStateInts;
    merge(st, PollState{__ldcg(in), static_cast<unsigned>(__ldcg(in + 1)),
                        __ldcg(in + 2), __ldcg(in + 3), __ldcg(in + 4)});
  }
  st = warp_merge(st);
  if (lane != 0) return;

  // arg-min of the gated scores: planes below the top level score 100
  unsigned key = st.key;
  int best = st.best;
  const unsigned key100 = residual_key(kDisqualified);
  if (st.low != kNone &&
      (key100 < key || (key100 == key && st.low < best))) {
    key = key100;
    best = st.low;
  }
  const float best_res =
      key == 0 ? __int_as_float(0x7fc00000) : __uint_as_float(key - 1);

  const float4 pl = load_plane(planes, planes_bf16, b * P + best);
  float X[12];
  keypoints<true>(q, pl, X);
#pragma unroll
  for (int i = 0; i < 12; ++i) keypoints_out[12 * det + i] = X[i];
  reinterpret_cast<float4*>(keyplanes_out)[det] = pl;
  residuals_out[det] = best_res / kNumPolls;
}

}  // namespace

// Plain C entry points for ctypes.

// Detections per block and resident blocks per SM of the polling kernel.
extern "C" int gpp_poll_config(int* warps, int* blocks_per_sm) {
  *warps = kWarps;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, poll_kernel, kThreads, 0));
}

// One launch over `splits` splits of the plane axis. Inputs are device
// pointers to contiguous arrays, float32 or bf16 as their flags say
// (orientations int32 or int64); outputs float32; `states` holds
// B * D * splits * 5 ints and `counters` B * ceil(D / warps) zeros.
// `stream` is a cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int gpp_poll_launch(const void* boxes, int boxes_bf16,
                               const void* dims, int dims_bf16,
                               const void* orients, int orients_int64,
                               const void* p_inv, int p_inv_bf16,
                               const void* planes, int planes_bf16, int B,
                               int D, int P, int splits, float* keypoints,
                               float* keyplanes, float* residuals,
                               int* states, unsigned* counters,
                               void* stream) {
  if (B > 0 && D > 0 && P > 0) {
    const dim3 grid(splits, (D + kWarps - 1) / kWarps, B);
    poll_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        boxes, boxes_bf16, dims, dims_bf16, orients, orients_int64, p_inv,
        p_inv_bf16, planes, planes_bf16, D, P, keypoints, keyplanes,
        residuals, states, counters);
  }
  return static_cast<int>(cudaGetLastError());
}
