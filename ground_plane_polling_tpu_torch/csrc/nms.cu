// Exact greedy non-maximum suppression over score-sorted candidates, for
// Hopper (sm_90a).
//
// Replaces the greedy NMS of ground_plane_polling_tpu/ops/filtering.py::
// _greedy_nms, a fixpoint of "keep_i = valid_i and no kept higher-ranked j
// overlaps i" that XLA lowers to a while_loop on the device. The port's
// plain version (ops/filtering.py::greedy_nms) iterates the same fixpoint,
// and its convergence test is one host sync per round; this kernel needs
// none, so a detect call can be captured as one CUDA graph.
//
// One launch a call (gpp_nms): one block of 1,024 threads a candidate set
// (row s of S rows, image x candidate set, K candidates each). The block
// walks the candidates in rank order one word (32 candidates) at a time
// and decides each word with everything it depends on already in shared
// memory or registers:
//   * the candidates stream through a ring of 32 words (1,024 boxes and
//     scores, 20 KiB) filled with cp.async: the first 32 words at the
//     start, then one word an iteration, 28 iterations ahead of its use,
//     so K has no limit from shared memory. A first pass over the scores
//     finds the last valid candidate (score above -inf): words past it
//     are never reached and cost nothing.
//   * warp 0 resolves word w in registers: lane r holds candidate r's
//     validity and its row of the word's 32 x 32 "r suppresses c" tile.
//     keep = live, then keep = live & ~OR(rows of keep) (__reduce_or_sync)
//     until it stops changing: one round a link of the word's longest
//     suppression chain, where a walk of __ffs / __shfl_sync would take
//     one step a kept candidate. The first max_out - n of them in rank
//     order are kept, appended to the kept list (box, area, score, index),
//     and their precomputed rows against word w + 1 ORed into that word's
//     suppressed bits. No read of device memory sits in this chain.
//   * meanwhile warps 1-31 prepare word w + 1: its columns against every
//     candidate kept before word w (the rows split over the warps, each
//     lane a column, stopping at the first suppressor); then, after a
//     barrier of their own, the rows of its diagonal tile and of its tile
//     against word w + 2 (speculative: they do not depend on any
//     decision), a warp row each, of only the candidates that those
//     columns left live (valid, suppressed by no earlier kept one): no
//     other candidate can be kept, so warp 0 never reads its rows. One
//     __syncthreads an iteration.
// So each IoU computed is one that the greedy result depends on: a kept
// candidate against a later candidate up to the last one decided, plus
// the live rows of two 32 x 32 tiles a word reached. The work stops at
// max_out kept or past the last valid candidate; nothing is written to
// device memory but the outputs, once at the end, by the whole block.
// There is no bitmask and no scratch. The kept list lives in shared
// memory up to 896 entries (the block stays under 48 KiB, so no launch
// attribute is needed); kept candidates past that (max_out above 896) are
// read back from the idx output, written when they are kept. Empty slots
// get index 0, valid 0 and score -inf, as the plain version writes them.
//
// What bounds it: not the IoU operations (the real candidates of a b1
// call keep 100 of their first 102: about 5 k decisions, 14 f32
// operations each, nanoseconds at the card's 67 TFLOP/s) nor the bytes
// (4 KB up to the last decided candidate: about 1 ns at 3.35 TB/s), but
// one SM working through a word's decisions, (kept so far) warp rows of
// columns, then up to 63 tile rows, each about 40 instructions, and the
// two barriers after them: 2-3 us a word while most candidates are kept,
// about 1 us once few are live (clustered candidates, where the tiles
// shrink to a few rows), for ceil(last decided / 32) + 1 words. Sets run
// on their own SMs in parallel, so S = 1 to 48 cost about the same.
//
// Exactness: each decision must equal the plain version's
// `iou_matrix(boxes4, boxes4) > iou_threshold` (ops/overlap.py), so the IoU
// is computed with the same operations in the same order, each rounded to
// float32 (the __f*_rn intrinsics; the file is also built with
// -fmad=false), the union clamped at float64's eps (exact in float32),
// and the clamps at 0 propagating NaN as torch's clamp does. min and max
// are fminf and fmaxf, which differ from torch.minimum and torch.maximum
// only on a NaN input; a NaN coordinate makes its box's area NaN, hence
// the union NaN and the IoU NaN whatever min and max returned, and a NaN
// IoU suppresses nothing either way. A zero intersection gives 0 / union,
// 0 or NaN, without the division (whose slow path a zero dividend
// takes). The threshold arrives as a float, rounded as torch rounds a
// Python float against a float32 tensor. Ties break by rank (the input
// order), as in the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kWorkers = kWarps - 1;  // warps 1..31 prepare; warp 0 resolves
constexpr int kLoader = 1;            // the worker warp that streams the ring
constexpr int kRing = 32;             // words of candidates in shared memory
constexpr int kKeptSmem = 896;        // kept candidates held in shared memory
constexpr unsigned kFull = 0xffffffffu;
// np.finfo(np.float64).eps = 2^-52, exact in float32
constexpr float kEps = 2.220446049250313e-16f;

// clamp(x, min=lo) as torch computes it: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// iou_matrix(a, b) > thr for one pair, a = box j (row), b = box i
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, float thr) {
  const float iw = clamp_min(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)),
                             0.0f);
  const float ih = clamp_min(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)),
                             0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float sum = __fadd_rn(area_a, area_b);
  // 0 / union is 0 (the union is at least eps) or NaN (the union is NaN):
  // no division, whose slow path a zero dividend takes
  if (inter == 0.0f) return sum == sum && 0.0f > thr;
  const float uni = clamp_min(__fsub_rn(sum, inter), kEps);
  return __fdiv_rn(inter, uni) > thr;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this lane's candidate of word v into its ring slot; candidates past K
// are left as they are (they are never valid)
__device__ __forceinline__ void stage(float4* rbox, float* rsc,
                                      const float* boxes,
                                      const float* scores, int v, int K,
                                      int lane) {
  const int j = 32 * v + lane;
  if (j < K) {
    const int slot = (v & (kRing - 1)) * 32 + lane;
    cp_async16(rbox + slot, boxes + 4 * static_cast<size_t>(j));
    cp_async4(rsc + slot, scores + j);
  }
}

// the workers' own barrier (named barrier 1): warp 0 does not wait on it
__device__ __forceinline__ void workers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWorkers * 32) : "memory");
}

// the position of the i-th set bit of m (i < popc(m)), in every lane
__device__ __forceinline__ int nth_bit(uint32_t m, int i, int lane) {
  const bool at = ((m >> lane) & 1u) && __popc(m & ((1u << lane) - 1u)) == i;
  return __ffs(__ballot_sync(kFull, at)) - 1;
}

// the rows of word v's two 32 x 32 tiles that warp 0 can use: those of
// the candidates in `rows`, the word's valid candidates that no candidate
// kept before word v - 1 suppresses (any other is never kept, so warp 0
// never reads its rows). Lane c's bit of a row is set where the row's
// candidate suppresses column c: the diagonal tile's row r against the
// later columns of word v (lanes c > r; row 31 has none), the cross
// tile's row r against the columns of word v + 1, where `next_word` is
// true. The workers take the rows in turn, worker q the q-th, q +
// kWorkers-th, ...; lane 0 stores each.
__device__ __forceinline__ void tiles(const float4* word, float4 col,
                                      float col_area, float4 next,
                                      float next_area, bool next_word,
                                      uint32_t rows, float thr, int q,
                                      int lane, uint32_t* diag,
                                      uint32_t* cross) {
  const uint32_t drows = rows & ~(1u << 31);
  const int nd = __popc(drows);
  const int n = nd + (next_word ? __popc(rows) : 0);
  for (int i = q; i < n; i += kWorkers) {
    const bool d = i < nd;
    const int r = nth_bit(d ? drows : rows, d ? i : i - nd, lane);
    const float4 a = word[r];
    const bool s = d ? lane > r && suppresses(a, area(a), col, col_area, thr)
                     : suppresses(a, area(a), next, next_area, thr);
    const uint32_t bits = __ballot_sync(kFull, s);
    if (lane == 0) (d ? diag : cross)[r] = bits;
  }
}

__global__ void __launch_bounds__(kThreads)
    nms_kernel(const float* __restrict__ boxes_all,
               const float* __restrict__ scores_all, int K, int max_out,
               int cap, float thr, long long* idx_all,
               uint8_t* __restrict__ valid_all,
               float* __restrict__ score_all) {
  // ring (boxes, then scores) and kept list (boxes, areas, scores,
  // indices), sized by the host: ring_words * 32 and cap entries
  extern __shared__ float4 smem[];
  const int ring_words = min(kRing, (K + 31) / 32);
  float4* rbox = smem;
  float4* kbox = rbox + ring_words * 32;
  float* rsc = reinterpret_cast<float*>(kbox + cap);
  float* karea = rsc + ring_words * 32;
  float* kscore = karea + cap;
  int* kidx = reinterpret_cast<int*>(kscore + cap);
  // double-buffered by word parity x & 1, written for word x during the
  // iteration before warp 0 resolves it
  __shared__ uint32_t diag[2][32];   // row r: later columns of its word
  __shared__ uint32_t cross[2][32];  // row r: columns of the next word
  __shared__ uint32_t part[2][kWorkers];  // columns hit by worker q's rows
  __shared__ uint32_t fresh[2];  // columns hit by the last word's kept
  __shared__ int kept_n[2];      // kept before word x
  __shared__ int last[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t set = blockIdx.x;
  const float* boxes = boxes_all + set * K * 4;
  const float* scores = scores_all + set * K;
  long long* out_idx = idx_all + set * max_out;
  uint8_t* out_valid = valid_all + set * max_out;
  float* out_score = score_all + set * max_out;

  // stage the first words; meanwhile find the last valid candidate
  for (int v = warp; v < ring_words; v += kWarps) {
    stage(rbox, rsc, boxes, scores, v, K, lane);
  }
  cp_async_commit();
  int lv = -1;
  for (int j = tid; j < K; j += kThreads) {
    if (__ldg(scores + j) > -INFINITY) lv = j;
  }
  lv = __reduce_max_sync(kFull, lv);
  if (lane == 0) last[warp] = lv;
  if (tid == 0) {
    kept_n[0] = kept_n[1] = 0;
    fresh[0] = 0u;
  }
  cp_async_wait<0>();
  __syncthreads();
  int k_eff = -1;
  for (int i = 0; i < kWarps; ++i) k_eff = max(k_eff, last[i]);
  k_eff += 1;
  const int w_eff = (k_eff + 31) / 32;

  int n = 0;  // kept so far, uniform across the block after each barrier
  // iteration w: warp 0 resolves word w, warps 1-31 prepare word w + 1
  for (int w = -1; w_eff > 0; ++w) {
    const int v = w + 1;
    if (warp == 0) {
      if (w >= 0) {
        const int slot = (w & (kRing - 1)) * 32 + lane;
        const int j = 32 * w + lane;
        const float sc = rsc[slot];
        uint32_t live = __ballot_sync(kFull, j < k_eff && sc > -INFINITY);
        const uint32_t hit = __reduce_or_sync(
            kFull, lane < kWorkers ? part[w & 1][lane] : 0u);
        live &= ~(hit | fresh[w & 1]);
        // greedy inside the word: keep_r = live_r and no kept r' < r
        // suppresses r, iterated from keep = live to its fixpoint (one
        // round a link of the word's longest suppression chain)
        const uint32_t drow = lane < 31 ? diag[w & 1][lane] : 0u;
        uint32_t kept = live, before;
        do {
          before = kept;
          kept = live & ~__reduce_or_sync(kFull,
                                          (kept >> lane) & 1u ? drow : 0u);
        } while (kept != before);
        // the first max_out - n0 of them in rank order
        const int n0 = kept_n[w & 1];
        while (__popc(kept) > max_out - n0) {
          kept &= ~(0x80000000u >> __clz(kept));
        }
        const int m = n0 + __popc(kept);
        const bool mine = (kept >> lane) & 1u;
        if (mine) {
          const int pos = n0 + __popc(kept & ((1u << lane) - 1u));
          const float4 bx = rbox[slot];
          if (pos < cap) {
            kbox[pos] = bx;
            karea[pos] = area(bx);
            kscore[pos] = sc;
            kidx[pos] = j;
          } else {
            out_idx[pos] = j;
            out_valid[pos] = 1;
            out_score[pos] = sc;
          }
        }
        const uint32_t next =
            __reduce_or_sync(kFull, mine ? cross[w & 1][lane] : 0u);
        if (lane == 0) {
          kept_n[v & 1] = m;
          fresh[v & 1] = next;
        }
      }
    } else {
      if (warp == kLoader) {
        const int u = w + kRing - 1;  // into the slot of word w - 1
        if (w >= 1 && u < w_eff) stage(rbox, rsc, boxes, scores, u, K, lane);
        cp_async_commit();
      }
      if (v < w_eff) {
        const int q = warp - 1;
        const int nprev = kept_n[w & 1];  // kept before word w
        const float4* word = rbox + (v & (kRing - 1)) * 32;
        const float4 col = word[lane];
        const float col_area = area(col);
        const int j = 32 * v + lane;
        bool hit = false;
        const bool valid =
            j < k_eff && rsc[(v & (kRing - 1)) * 32 + lane] > -INFINITY;
        if (valid) {
          for (int i = q; i < nprev; i += kWorkers) {
            float4 a;
            float area_a;
            if (i < cap) {
              a = kbox[i];
              area_a = karea[i];
            } else {
              // kept past the shared list: its index is in the output
              const float* p = boxes + 4 * __ldcg(out_idx + i);
              a = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2),
                              __ldg(p + 3));
              area_a = area(a);
            }
            if (suppresses(a, area_a, col, col_area, thr)) {
              hit = true;
              break;
            }
          }
        }
        const uint32_t bits = __ballot_sync(kFull, hit);
        if (lane == 0) part[v & 1][q] = bits;
        workers_sync();
        const uint32_t dead = __reduce_or_sync(
            kFull, lane < kWorkers ? part[v & 1][lane] : 0u);
        const uint32_t rows = __ballot_sync(kFull, valid) & ~dead;
        const bool more = v + 1 < w_eff;
        const float4 next =
            more ? rbox[((v + 1) & (kRing - 1)) * 32 + lane] : col;
        tiles(word, col, col_area, next, area(next), more, rows, thr, q,
              lane, diag[v & 1], cross[v & 1]);
      }
      // word w + 3, which the workers read next iteration, has landed
      if (warp == kLoader) cp_async_wait<kRing - 4>();
    }
    __syncthreads();
    n = kept_n[v & 1];
    if (n >= max_out || v >= w_eff) break;
  }

  for (int s = tid; s < max_out; s += kThreads) {
    if (s >= n) {
      out_idx[s] = 0;
      out_valid[s] = 0;
      out_score[s] = -INFINITY;
    } else if (s < cap) {
      out_idx[s] = kidx[s];
      out_valid[s] = 1;
      out_score[s] = kscore[s];
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.
//
// boxes: S x K x 4 float32 (x1, y1, x2, y2), 16-byte aligned; scores: S x K
// float32, each row sorted descending, -inf for an invalid candidate;
// outputs idx (int64), valid (bool as uint8) and score (float32), S x
// max_out each, all contiguous on one device. `stream` is a cudaStream_t.
// Launches one kernel and returns cudaGetLastError() after it (0 on
// success).
extern "C" int gpp_nms(const float* boxes, const float* scores, int S, int K,
                       int max_out, float thr, long long* idx,
                       uint8_t* valid, float* score, void* stream) {
  if (S > 0 && K > 0 && max_out > 0) {
    const int ring_words = min(kRing, (K + 31) / 32);
    const int cap = min(min(max_out, K), kKeptSmem);
    const size_t smem = static_cast<size_t>(ring_words) * 32 * (16 + 4) +
                        static_cast<size_t>(cap) * (16 + 4 + 4 + 4);
    nms_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        boxes, scores, K, max_out, cap, thr, idx, valid, score);
  }
  return static_cast<int>(cudaGetLastError());
}
