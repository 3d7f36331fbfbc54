// Device timestamps of the detect call's stage boundaries, for Hopper
// (sm_90a). Replaces no TPU kernel: the JAX package times its stages
// from the host (utils/profiling.py::StageTimer), which here would wait
// for the card at each boundary and serialise the pipeline it times.
//
// One launch of one thread a boundary (gpp_stamp), queued in the detect
// call's stream at the start, after the trunk, the filter and polling, and
// at the end, so that it runs when the stage before it has finished on the
// device. It reads the card's nanosecond clock (%globaltimer) and writes it
// into a ring of `calls` rows of `boundaries` stamps; the row is the call
// counter, a 64-bit word after the ring, modulo `calls`, and the end stamp
// advances the counter. Inside a CUDA graph every replay so writes the next
// row, in stream order, with no host sync: calls in flight keep their own
// rows. What bounds it is the launch (a few microseconds at most), not its
// 16 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gpp_stage_stamp(unsigned long long* ring, int boundary,
                                int boundaries, int calls) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long* counter =
      ring + static_cast<size_t>(boundaries) * calls;
  const unsigned long long call = *counter;
  ring[(call % calls) * boundaries + boundary] = now;
  if (boundary == boundaries - 1) *counter = call + 1;
}

extern "C" int gpp_stamp(void* ring, int boundary, int boundaries,
                         int calls, void* stream) {
  gpp_stage_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring), boundary, boundaries, calls);
  return static_cast<int>(cudaGetLastError());
}
