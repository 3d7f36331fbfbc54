// Ground-plane polling, fused with its arg-min epilogue, for Hopper (sm_90a).
//
// Replaces ground_plane_polling_tpu/kernels/polling_pallas.py::_poll_kernel
// together with the jnp epilogue of fit_road_planes_pallas (vote gating,
// first-index argmin, keyplane gather, keypoint reconstruction, residual/6).
// The (B, D, P) vote and residual scoreboards of the TPU kernel are never
// written: each block reduces its detection's row in registers and shared
// memory and writes only the winner.
//
// What bounds it: per (detection, plane) pair about 150 f32 operations
// (3 ray-plane intersections, the winding test, the top point, 6 distances
// with square roots, 2 divisions) on 16 bytes of plane. At B 4, D 100 and
// P 21,634 that is about 1.3 GFLOP on 1.4 MB of planes that stay in L2, so
// the kernel is compute- and launch-bound, not memory-bound. The design
// keeps every intermediate in registers and reads each plane once per
// detection with one 16-byte load per thread, neighbouring threads on
// neighbouring planes.
//
// Layout: one thread block per (batch element, detection); its threads
// stride over the plane database. Each thread keeps a compressed state of
// the unfused semantics (see PollState), the block merges the states with
// a shared-memory tree, and thread 0 rebuilds the winning keypoints.
//
// Built without FMA contraction (-fmad=false) so the arithmetic rounds as
// the plain PyTorch twin's separate operations do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNone = 0x7fffffff;
constexpr float kPollThreshold = 0.7f;   // metres
constexpr float kDisqualified = 100.0f;
constexpr float kNumPolls = 6.0f;

// Running arg-min state over a set of planes, equivalent to keeping, per
// vote level, the least residual with its first index, the first index and
// the first NaN index, once only the highest level seen so far can win:
//   level      the highest vote count seen;
//   best_res   the least non-NaN residual at that level, at first index
//              best_idx (winding-masked planes count with residual 100);
//   nan_idx    the first plane at that level whose residual is NaN;
//   first_idx  the first plane at that level;
//   low_first  the first plane at any lower level.
// Planes below the top level score 100 in the unfused formulation, so among
// them only the first index matters.
struct PollState {
  int level;
  float best_res;
  int best_idx;
  int nan_idx;
  int first_idx;
  int low_first;
};

__device__ __forceinline__ PollState empty_state() {
  PollState s;
  s.level = -1;
  s.best_res = __int_as_float(0x7f800000);  // +inf
  s.best_idx = kNone;
  s.nan_idx = kNone;
  s.first_idx = kNone;
  s.low_first = kNone;
  return s;
}

__device__ __forceinline__ bool res_less(float ra, int ia, float rb, int ib) {
  return ra < rb || (ra == rb && ia < ib);
}

// Merge `b` into `a`; exact for any order of merging.
__device__ __forceinline__ void merge(PollState& a, const PollState& b) {
  if (b.level < 0) return;
  if (a.level < b.level) {
    const int low = min(a.low_first, a.first_idx);
    a = b;
    a.low_first = min(a.low_first, low);
    return;
  }
  if (a.level > b.level) {
    a.low_first = min(a.low_first, min(b.low_first, b.first_idx));
    return;
  }
  if (res_less(b.best_res, b.best_idx, a.best_res, a.best_idx)) {
    a.best_res = b.best_res;
    a.best_idx = b.best_idx;
  }
  a.nan_idx = min(a.nan_idx, b.nan_idx);
  a.first_idx = min(a.first_idx, b.first_idx);
  a.low_first = min(a.low_first, b.low_first);
}

__device__ __forceinline__ void add_plane(PollState& s, int level, float res,
                                          int idx) {
  PollState one;
  one.level = level;
  one.first_idx = idx;
  one.low_first = kNone;
  if (res != res) {  // NaN
    one.nan_idx = idx;
    one.best_res = __int_as_float(0x7f800000);
    one.best_idx = kNone;
  } else {
    one.nan_idx = kNone;
    one.best_res = res;
    one.best_idx = idx;
  }
  merge(s, one);
}

__device__ __forceinline__ float dist3(float ax, float ay, float az, float bx,
                                       float by, float bz) {
  const float dx = ax - bx, dy = ay - by, dz = az - bz;
  return sqrtf(dx * dx + dy * dy + dz * dz);
}

// Keypoints of one detection on one unit-normal plane (n, off): the l/m/r
// rays meet the plane at |off / (n.r)| r; the top point is
// X_t = X_m - (perp.X_m / perp.n) n with perp = d_t x (n x d_t).
__device__ void plane_keypoints(const float* ray, float n0, float n1, float n2,
                                float off, float* X /* 12 */) {
  for (int k = 0; k < 3; ++k) {
    const float rx = ray[3 * k], ry = ray[3 * k + 1], rz = ray[3 * k + 2];
    const float ndot = rx * n0 + ry * n1 + rz * n2;
    const float s = fabsf(off / ndot);
    X[3 * k] = rx * s;
    X[3 * k + 1] = ry * s;
    X[3 * k + 2] = rz * s;
  }
  const float tx = ray[9], ty = ray[10], tz = ray[11];
  const float cx = n1 * tz - n2 * ty;
  const float cy = n2 * tx - n0 * tz;
  const float cz = n0 * ty - n1 * tx;
  const float px = ty * cz - tz * cy;
  const float py = tz * cx - tx * cz;
  const float pz = tx * cy - ty * cx;
  const float mx = X[3], my = X[4], mz = X[5];
  const float t = (px * mx + py * my + pz * mz) / (px * n0 + py * n1 + pz * n2);
  X[9] = mx - t * n0;
  X[10] = my - t * n1;
  X[11] = mz - t * n2;
}

__global__ void __launch_bounds__(kThreads)
poll_kernel(const float* __restrict__ rays,      // (B, D, 12)
            const float* __restrict__ expected,  // (B, D, 6)
            const float4* __restrict__ planes,   // (B, P) unit-normal planes
            int D, int P,
            float* __restrict__ keypoints,       // (B, D, 12)
            float* __restrict__ keyplanes,       // (B, D, 4)
            float* __restrict__ residuals) {     // (B, D)
  const int det = blockIdx.x;  // b * D + d
  const int b = det / D;
  const float* ray = rays + 12 * (int64_t)det;
  const float* ex = expected + 6 * (int64_t)det;
  const float4* db = planes + (int64_t)b * P;

  const float lx = ray[0], ly = ray[1], lz = ray[2];
  const float mx = ray[3], my = ray[4], mz = ray[5];
  const float rx = ray[6], ry = ray[7], rz = ray[8];
  const float tx = ray[9], ty = ray[10], tz = ray[11];
  const float e0 = ex[0], e1 = ex[1], e2 = ex[2], e3 = ex[3], e4 = ex[4],
              e5 = ex[5];

  PollState st = empty_state();
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const float4 pl = db[p];
    const float n0 = pl.x, n1 = pl.y, n2 = pl.z, dd = pl.w;

    const float sl = fabsf(dd / (lx * n0 + ly * n1 + lz * n2));
    const float sm = fabsf(dd / (mx * n0 + my * n1 + mz * n2));
    const float sr = fabsf(dd / (rx * n0 + ry * n1 + rz * n2));
    const float Xlx = lx * sl, Xly = ly * sl, Xlz = lz * sl;
    const float Xmx = mx * sm, Xmy = my * sm, Xmz = mz * sm;
    const float Xrx = rx * sr, Xry = ry * sr, Xrz = rz * sr;

    // winding: y component of (X_l - X_m) x (X_r - X_m)
    const float wind_y = (Xlz - Xmz) * (Xrx - Xmx) - (Xlx - Xmx) * (Xrz - Xmz);

    const float cx = n1 * tz - n2 * ty;
    const float cy = n2 * tx - n0 * tz;
    const float cz = n0 * ty - n1 * tx;
    const float px = ty * cz - tz * cy;
    const float py = tz * cx - tx * cz;
    const float pz = tx * cy - ty * cx;
    const float t = (px * Xmx + py * Xmy + pz * Xmz) / (px * n0 + py * n1 + pz * n2);
    const float Xtx = Xmx - t * n0, Xty = Xmy - t * n1, Xtz = Xmz - t * n2;

    const float r0 = fabsf(dist3(Xmx, Xmy, Xmz, Xtx, Xty, Xtz) - e0);
    const float r1 = fabsf(dist3(Xlx, Xly, Xlz, Xmx, Xmy, Xmz) - e1);
    const float r2 = fabsf(dist3(Xmx, Xmy, Xmz, Xrx, Xry, Xrz) - e2);
    const float r3 = fabsf(dist3(Xlx, Xly, Xlz, Xrx, Xry, Xrz) - e3);
    const float r4 = fabsf(dist3(Xlx, Xly, Xlz, Xtx, Xty, Xtz) - e4);
    const float r5 = fabsf(dist3(Xrx, Xry, Xrz, Xtx, Xty, Xtz) - e5);
    const int votes = (r0 <= kPollThreshold) + (r1 <= kPollThreshold) +
                      (r2 <= kPollThreshold) + (r3 <= kPollThreshold) +
                      (r4 <= kPollThreshold) + (r5 <= kPollThreshold);
    float res = r0 + r1 + r2 + r3 + r4 + r5;
    if (wind_y < 0.0f) res = kDisqualified;
    add_plane(st, votes, res, p);
  }

  __shared__ PollState states[kThreads];
  states[threadIdx.x] = st;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      PollState a = states[threadIdx.x];
      merge(a, states[threadIdx.x + half]);
      states[threadIdx.x] = a;
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;

  // arg-min of the gated scores: planes below the top level score 100
  const PollState s = states[0];
  int best;
  float best_res;
  if (s.nan_idx != kNone) {
    best = s.nan_idx;
    best_res = __int_as_float(0x7fc00000);  // NaN
  } else if (s.low_first == kNone || s.best_res < kDisqualified) {
    best = s.best_idx;
    best_res = s.best_res;
  } else if (s.best_res > kDisqualified) {
    best = s.low_first;
    best_res = kDisqualified;
  } else {  // a tie at 100: the first index wins
    best = min(s.best_idx, s.low_first);
    best_res = kDisqualified;
  }

  const float4 pl = db[best];
  float X[12];
  plane_keypoints(ray, pl.x, pl.y, pl.z, pl.w, X);
  float* kp = keypoints + 12 * (int64_t)det;
  for (int i = 0; i < 12; ++i) kp[i] = X[i];
  float* kpl = keyplanes + 4 * (int64_t)det;
  kpl[0] = pl.x;
  kpl[1] = pl.y;
  kpl[2] = pl.z;
  kpl[3] = pl.w;
  residuals[det] = best_res / kNumPolls;
}

}  // namespace

// Plain C entry point for ctypes. All pointers are device pointers to
// contiguous float32 tensors; `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int gpp_poll_launch(const float* rays, const float* expected,
                               const float* planes, int B, int D, int P,
                               float* keypoints, float* keyplanes,
                               float* residuals, void* stream) {
  const int blocks = B * D;
  if (blocks > 0 && P > 0) {
    poll_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, expected, reinterpret_cast<const float4*>(planes), D, P,
        keypoints, keyplanes, residuals);
  }
  return static_cast<int>(cudaGetLastError());
}
