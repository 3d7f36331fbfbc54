// Exact greedy non-maximum suppression over score-sorted candidates, for
// Hopper (sm_90a).
//
// Replaces the greedy NMS of ground_plane_polling_tpu/ops/filtering.py::
// _greedy_nms, a fixpoint of "keep_i = valid_i and no kept higher-ranked j
// overlaps i" that XLA lowers to a while_loop on the device. The port's
// plain version (ops/filtering.py::greedy_nms) iterates the same fixpoint,
// and its convergence test is one host sync per round; this kernel pair
// needs none, so a detect call can be captured as one CUDA graph.
//
// Two kernels, one call (gpp_nms), per row s of S rows (image x candidate
// set), K candidates each:
//   * mask_kernel: thread (j, w) writes word w of row j of the upper
//     triangular "j suppresses i" bitmask: bit i - 32 w is set where
//     i > j and IoU(box j, box i) > threshold. ceil(K / 32) words a row, so
//     K = 1024 takes 128 KiB a set, in a scratch buffer of the wrapper's.
//     The grid covers every (j, w) of every row at once and fills the card.
//   * scan_kernel: one warp per row scans the candidates in rank order
//     with the "removed" mask in shared memory (invalid candidates, score
//     -inf, start removed). Each step takes the first live candidate of the
//     current word (__ffs), keeps it, and ORs its mask row into "removed",
//     lane w taking words w, w + 32, ...; it stops at max_out kept or at K.
//     So it walks kept candidates and words, not every candidate, and needs
//     no fixpoint rounds. Slots past the kept ones get index 0, valid 0
//     and score -inf, as the plain version writes them.
//
// What bounds it: the IoU decisions, K (K - 1) / 2 of them a row, 14 f32
// operations each (one an IEEE division): at K = 1024 that is 7.3 M
// operations a row, 0.11 us at the card's 67 TFLOP/s, beside 21 KB of
// inputs and outputs (6 ns at 3.35 TB/s). In practice it is latency: two
// launches, and the scan's dependent steps (a shared-memory round trip and
// an L2 read of one mask row for every kept candidate).
//
// Exactness: each decision must equal the plain version's
// `iou_matrix(boxes4, boxes4) > iou_threshold` (ops/overlap.py), so the IoU
// is computed with the same operations in the same order, each rounded to
// float32 (the __f*_rn intrinsics; the file is also built with
// -fmad=false), the union clamped at float64's eps (exact in float32), and
// min, max and the clamps propagating NaN as torch.minimum, torch.maximum
// and clamp do (a NaN IoU suppresses nothing). The threshold arrives as a
// float, rounded as torch rounds a Python float against a float32 tensor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaskThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// np.finfo(np.float64).eps = 2^-52, exact in float32
constexpr float kEps = 2.220446049250313e-16f;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// clamp(x, min=lo) as torch computes it: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ float4 load_box(const float* p) {
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// iou_matrix(a, b) > thr for one pair, a = box j (row), b = box i
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float thr) {
  const float iw = clamp_min(
      __fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)), 0.0f);
  const float ih = clamp_min(
      __fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = clamp_min(__fsub_rn(__fadd_rn(area_a, area(b)), inter),
                              kEps);
  return __fdiv_rn(inter, uni) > thr;
}

__global__ void mask_kernel(const float* __restrict__ boxes, int K, int W,
                            float thr, uint32_t* __restrict__ mask) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(K) * W) return;
  const int j = static_cast<int>(t / W);
  const int w = static_cast<int>(t - static_cast<long long>(j) * W);
  const float* bx = boxes + static_cast<size_t>(blockIdx.y) * K * 4;
  const int lo = max(32 * w, j + 1);
  const int hi = min(32 * w + 32, K);
  uint32_t bits = 0;
  if (lo < hi) {
    const float4 a = load_box(bx + 4 * j);
    const float area_a = area(a);
    for (int i = lo; i < hi; ++i) {
      if (suppresses(a, area_a, load_box(bx + 4 * i), thr)) {
        bits |= 1u << (i - 32 * w);
      }
    }
  }
  mask[static_cast<size_t>(blockIdx.y) * K * W + t] = bits;
}

__global__ void scan_kernel(const uint32_t* __restrict__ mask,
                            const float* __restrict__ scores, int K, int W,
                            int max_out, long long* __restrict__ idx,
                            uint8_t* __restrict__ valid,
                            float* __restrict__ score) {
  extern __shared__ uint32_t removed[];  // W words
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* sc = scores + row * K;
  const uint32_t* m = mask + row * K * W;
  long long* out_idx = idx + row * max_out;
  uint8_t* out_valid = valid + row * max_out;
  float* out_score = score + row * max_out;

  // invalid candidates (score -inf) and the bits past K start removed
  for (int base = 0; base < 32 * W; base += 32) {
    const int j = base + lane;
    const bool live = j < K && sc[j] > -INFINITY;
    const uint32_t word = __ballot_sync(kFull, live);
    if (lane == 0) removed[base / 32] = ~word;
  }
  __syncwarp();

  int n = 0;  // kept so far; the loops are uniform across the warp
  for (int w = 0; w < W && n < max_out; ++w) {
    uint32_t live = ~removed[w];
    __syncwarp();  // every lane has read word w before any lane writes it
    while (live != 0u && n < max_out) {
      const int b = __ffs(live) - 1;
      const int j = 32 * w + b;
      if (lane == 0) {
        out_idx[n] = j;
        out_valid[n] = 1;
        out_score[n] = sc[j];
      }
      ++n;
      const uint32_t* mrow = m + static_cast<size_t>(j) * W;
      for (int v = w + lane; v < W; v += 32) removed[v] |= mrow[v];
      __syncwarp();
      live = ~removed[w] & (b == 31 ? 0u : (kFull << (b + 1)));
      __syncwarp();
    }
  }
  for (int s = n + lane; s < max_out; s += 32) {
    out_idx[s] = 0;
    out_valid[s] = 0;
    out_score[s] = -INFINITY;
  }
}

}  // namespace

// Plain C entry point for ctypes.
//
// boxes: S x K x 4 float32 (x1, y1, x2, y2); scores: S x K float32, each
// row sorted descending, -inf for an invalid candidate; mask: S x K x
// ceil(K / 32) uint32 scratch; outputs idx (int64), valid (bool as uint8)
// and score (float32), S x max_out each, all contiguous on one device.
// `stream` is a cudaStream_t. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int gpp_nms(const float* boxes, const float* scores, int S, int K,
                       int max_out, float thr, uint32_t* mask, long long* idx,
                       uint8_t* valid, float* score, void* stream) {
  if (S > 0 && K > 0 && max_out > 0) {
    const int W = (K + 31) / 32;
    const long long words = static_cast<long long>(K) * W;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>((words + kMaskThreads - 1) /
                                          kMaskThreads),
                    S);
    mask_kernel<<<grid, kMaskThreads, 0, st>>>(boxes, K, W, thr, mask);
    scan_kernel<<<S, 32, W * sizeof(uint32_t), st>>>(mask, scores, K, W,
                                                     max_out, idx, valid,
                                                     score);
  }
  return static_cast<int>(cudaGetLastError());
}
