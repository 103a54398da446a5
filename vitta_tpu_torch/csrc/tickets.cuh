// Tickets and clusters: how a kernel of the port finishes a sum across its
// blocks inside the one launch, without float atomics.  Shared by
// bn_stats.cu (the BatchNorm statistics), ln.cu (the bfloat16 LayerNorm
// backward) and tam.cu (the bfloat16 TAM backward).
//
// A CUDA grid runs its blocks in no order, so each block writes its partial
// sums to device memory and then draws a ticket: one thread's integer
// acquire-release atomic on a counter, after the block's barrier (as a grid
// barrier of cooperative groups orders a block's writes).  The block that
// draws the last ticket of a counter has acquired every other block's
// partials; it adds them in a fixed order, writes the outputs and resets
// the counter to 0.  Whichever block draws it, the sums are the same bits.
//
// The counters are this library's own zero-initialised device array (each
// csrc/<name>.cu is built into a library of its own, so each has one), cut
// into kTicketSlots slots of kSlotTickets counters: a slot per stream that
// runs the kernels at once (the wrapper hands them out:
// ops/_launch.py:TicketSlots), a counter per tile of a call.  A counter is
// 0 between launches, so a CUDA graph captures and replays the launch as it
// is: nothing is allocated or zeroed a call.
//
// Clusters (up to 8 blocks on neighbouring SMs) add their blocks' sums
// first, through distributed shared memory (st.async into another block's
// shared memory, counted on its mbarrier), so that fewer partials reach
// device memory and the last block reads fewer.

#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "launches.cuh"

namespace vitta {
namespace {

constexpr int kTicketSlots = 64;      // streams of a device, one slot each
constexpr int kSlotTickets = 2048;    // counters (tiles of a call) a slot

// The counters: zero when the library is loaded, reset by the block that
// draws a counter's last ticket.
__device__ unsigned int g_tickets[kTicketSlots * kSlotTickets];

__device__ __forceinline__ unsigned int* slot_tickets(int slot) {
  return g_tickets + (long long)slot * kSlotTickets;
}

// One thread, after the block's barrier that follows its partials' writes:
// draws a ticket of `counter`, `count` blocks drawing in all.  True for the
// block that draws the last: it has acquired every other block's writes
// (read them with ld.cg, __ldcg) and resets the counter to 0 for the next
// launch.
__device__ __forceinline__ bool draw_last_ticket(unsigned int* counter,
                                                 unsigned int count) {
  unsigned int drawn;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(drawn) : "l"(counter) : "memory");
  if (drawn + 1 != count) return false;
  *counter = 0u;
  return true;
}

// Clusters: the block's shared-memory addresses, its rank, and the
// cluster's barrier (arrived at once a block has made its mbarrier, waited
// on before the first store into another block's shared memory).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The cluster-dimension attribute of a launch of clusters of `csize`
// blocks along x.
inline cudaLaunchAttribute cluster_attr(int csize) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// Clusters of `csize` blocks of `block` threads of `kernel`, with `smem`
// bytes of dynamic shared memory each, that the card holds at once (at least
// 1; `per_sm` blocks an SM where the card cannot say).
inline int query_resident(const void* kernel, dim3 block, int csize,
                          size_t smem, int per_sm) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize);
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr = cluster_attr(csize);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    n = per_sm * sm_count() / csize;
  }
  return n > 1 ? n : 1;
}

}  // namespace
}  // namespace vitta
