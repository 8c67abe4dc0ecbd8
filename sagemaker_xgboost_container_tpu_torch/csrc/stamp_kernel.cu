// Stage clocks inside a round: one thread reads the card's nanosecond clock
// (%globaltimer) and charges the time since the previous stamp to one stage.
//
// Replaces no Pallas kernel: the JAX package splits its round by
// jax.named_scope in the profiler's trace, which a replayed CUDA graph does
// not carry (a record_function range opened while capturing is not
// replayed). Added so that the captured round's device time splits by stage
// (ops/stamps.py names the stages; models/booster.py's round body and the two
// tree builders stamp at their boundaries).
//
// rows: f64 [capacity, stages + 2], one row a round of a dispatch: the
// stages' nanoseconds, then the round's first stamp, then its latest. state:
// int64 [2], the latest stamp exactly and the row the round writes. A begin
// stamp (stage < 0) zeroes the row's stages and sets both times; every other
// stamp adds now - latest to row[stage], so the stages together cover the
// time from the round's first stamp to its last. The round's last stamp
// (advance) moves state to the next row, modulo capacity. The row index
// lives on the card because a captured round is replayed with the same
// arguments for every round of a dispatch; the rows are the dispatch's
// output, copied with the trees, so the stamps need no copy of their own.
// The times are whole nanoseconds held in doubles: a stage's sum exact, the
// first and latest stamp to 256 ns.
//
// What bounds it: one launch, one thread, a few 8-byte loads and stores; a
// stamp costs the graph node's launch on the card, a few microseconds.
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

__global__ void stage_stamp_kernel(double* rows, long long* state, int stage, int stages,
                                   int capacity, int advance) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long t = static_cast<long long>(now);
  long long r = state[1];
  double* row = rows + r * (stages + 2);
  if (stage < 0) {
    for (int s = 0; s < stages; ++s) row[s] = 0.0;
    row[stages] = static_cast<double>(t);
  } else {
    row[stage] += static_cast<double>(t - state[0]);
  }
  row[stages + 1] = static_cast<double>(t);
  state[0] = t;
  if (advance) state[1] = (r + 1) % capacity;
}

}  // namespace

extern "C" int stage_stamp_launch(double* rows, long long* state, int stage, int stages,
                                  int capacity, int advance, void* stream) {
  stage_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(rows, state, stage, stages,
                                                                     capacity, advance);
  return static_cast<int>(cudaGetLastError());
}
