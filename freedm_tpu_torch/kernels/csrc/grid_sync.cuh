// The grid-wide barrier of the port's persistent cooperative launches,
// for Hopper (sm_90a): I2 cim_vjp_walk (solvers.cu) and G1 form_groups
// (dgi.cu).
//
// grid_sync works on integer counters in device memory, [arrivals,
// generation]: the last CTA to arrive resets the count and advances the
// generation the others wait on.  Every barrier leaves the count at 0, so
// the buffer serves launch after launch on one stream: it is zeroed once,
// when made (build.grid_barrier keeps one a (device, stream)).  Every CTA
// of the launch must be resident (cudaLaunchCooperativeKernel checks it).

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();  // this CTA's writes, and the read of g, before arriving
    if (atomicAdd(bar, 1u) == blocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}
