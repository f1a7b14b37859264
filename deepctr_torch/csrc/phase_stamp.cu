// Device phase stamps: one thread writes the card's clock into a ring.
//
// Replaces no TPU kernel. It exists for ``deepctr_torch/utils/prof.py``: a
// CUDA graph of K train steps replays as one launch, so nothing on the host
// can say how long the sparse update, the exchange or the tower took inside
// it. A graph captured while tracing is on holds one stamp at each boundary
// of each step; each stamp writes ``%globaltimer`` (nanoseconds) into the
// row of the current replay. The difference of two neighbouring stamps is
// the device time of the work between them, idle inside the graph included.
//
// Layout: ``buf`` is int64 ``[replays + 1, width]``; rows ``0 .. replays-1``
// are the ring, and ``buf[replays][0]`` counts the replays whose first stamp
// has run. Slot 0 is each replay's first stamp: it takes the count as its
// row and advances it. Every later slot writes into row ``count - 1``. The
// stamps of a graph run in stream order, so no two of them race.
//
// Bound: one launch. A stamp costs the launch and a few hundred nanoseconds
// on one SM; a replay of 8 FNN steps holds 33 of them (41 sharded).

#include <cuda_runtime.h>

__global__ void phase_stamp_kernel(long long* buf, int replays, int width, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long* count = buf + static_cast<long long>(replays) * width;
  long long n = *count;
  if (slot == 0) {
    *count = n + 1;
  } else {
    n -= 1;
  }
  buf[(n % replays) * width + slot] = static_cast<long long>(now);
}

extern "C" int phase_stamp(void* buf, int replays, int width, int slot, void* stream) {
  phase_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(buf), replays, width, slot);
  return static_cast<int>(cudaGetLastError());
}
