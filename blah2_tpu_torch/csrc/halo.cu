// Neighbour halo exchange on a ring of logical ranks, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel blah2_tpu/parallel/halo.py::_rdma_permute
// (Pallas: a neighbour barrier on semaphores, then a remote DMA of a small
// f32 buffer to ring neighbour d-1 or d+1). What it computes: every rank of
// a ring sends its payload into the receive buffer of its neighbour; the
// send is circular and the caller masks the wrap-around edge.
//
// Design. One process drives every rank (the mesh is single-controller, as
// shard_map is), so one call covers every rank: per device one launch whose
// blocks are that device's ranks, one block each. All of a device's ranks
// are then co-resident in one launch, so the spin-waits below cannot
// deadlock on one card. Block b, for rank r sending to rank q:
//
//   1. arrive: thread 0 stores arrive[r] = epoch (release), then waits until
//      arrive[q] >= epoch (acquire). Rank q's block runs only after every
//      earlier kernel on q's stream, so once q has arrived nothing earlier
//      still reads q's receive buffer: this is the neighbour barrier of the
//      TPU kernel, and it matters where q lives on another card, whose
//      stream the writer does not share.
//   2. copy: the block pushes the payload into q's receive buffer through
//      the pointer table (same card, or a peer card by unified addressing).
//   3. signal: __syncthreads, a fence, then thread 0 stores ready[q] = epoch
//      (release).
//   4. wait: thread 0 waits until ready[r] >= epoch (acquire): the rank's
//      own buffer has arrived before the launch ends, so the stream's next
//      kernels may read it.
//
// The flags are 64-bit words in device memory, one arrive and one ready
// word per (collective_id, rank), on the rank's own card: call sites with
// no data dependency on each other get their own slot (the collective_id
// rule of the TPU kernel). The wrapper passes an epoch that grows by one
// per call and collective_id, so no flag is ever reset between calls. The
// stores are st.release and the loads ld.acquire, at .gpu scope on one card
// and .sys scope where a peer card takes part.
//
// No hang: a wait that runs past kSpinLimit clock cycles (about half a
// second) writes a nonzero error word (1 for the barrier, 2 for the data)
// and leaves the block. A debugger, the profiler or CUDA_LAUNCH_BLOCKING
// can serialise the launches of two cards, and then the first would wait
// for ever on a rank whose launch has not been issued. The wrapper reads
// the word where the caller synchronises anyway.
//
// Bound: a call moves a few KB (a (409, 2) f32 halo is 3,272 B a rank), a
// few ns at 3.35 TB/s. What it costs is one launch plus two flag round
// trips (arrive, ready), a few us, not bytes. Payloads are moved as 32-bit
// words, so float32 and float64 planes both pass.
//
// Interface: plain C, bound from Python with ctypes. The launcher enqueues
// on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRanks = 32;
constexpr long long kSpinLimit = 1000000000LL;

// Per block: source payload, neighbour's receive buffer, and the four flag
// words (own arrive, neighbour's arrive, neighbour's ready, own ready).
struct HaloArgs {
  const unsigned int* src[kMaxRanks];
  unsigned int* dst[kMaxRanks];
  unsigned long long* my_arrive[kMaxRanks];
  unsigned long long* dst_arrive[kMaxRanks];
  unsigned long long* dst_ready[kMaxRanks];
  unsigned long long* my_ready[kMaxRanks];
};

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v, bool sys) {
  if (sys) {
    asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
  } else {
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
  }
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p, bool sys) {
  unsigned long long v;
  if (sys) {
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
  } else {
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
  }
  return v;
}

// Spin until *p >= epoch; false if the wait ran past kSpinLimit cycles.
__device__ bool wait_for(const unsigned long long* p, unsigned long long epoch,
                         bool sys) {
  const long long t0 = clock64();
  while (load_acquire(p, sys) < epoch) {
    if (clock64() - t0 > kSpinLimit) return false;
    __nanosleep(64);
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
halo_permute(const HaloArgs args, int n_words, unsigned long long epoch,
             int sys_scope, unsigned int* err) {
  __shared__ int s_ok;
  const int b = blockIdx.x;
  const bool sys = sys_scope != 0;
  if (threadIdx.x == 0) {
    store_release(args.my_arrive[b], epoch, sys);
    s_ok = wait_for(args.dst_arrive[b], epoch, sys);
    if (!s_ok) atomicOr(err, 1u);
  }
  __syncthreads();
  if (!s_ok) return;

  const unsigned int* src = args.src[b];
  unsigned int* dst = args.dst[b];
  for (int i = threadIdx.x; i < n_words; i += kThreads) dst[i] = src[i];
  __syncthreads();

  if (threadIdx.x == 0) {
    if (sys) {
      __threadfence_system();
    } else {
      __threadfence();
    }
    store_release(args.dst_ready[b], epoch, sys);
    if (!wait_for(args.my_ready[b], epoch, sys)) atomicOr(err, 2u);
  }
}

}  // namespace

extern "C" int halo_max_ranks() { return kMaxRanks; }

// ptrs holds 6 * n_blocks addresses, in this order, each a run of n_blocks:
// source payloads, neighbours' receive buffers, own arrive flags,
// neighbours' arrive flags, neighbours' ready flags, own ready flags.
extern "C" int halo_launch(int n_blocks, void* const* ptrs, int n_words,
                           long long epoch, int sys_scope, void* err,
                           void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxRanks || n_words < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HaloArgs args;
  for (int b = 0; b < n_blocks; ++b) {
    args.src[b] = static_cast<const unsigned int*>(ptrs[b]);
    args.dst[b] = static_cast<unsigned int*>(ptrs[n_blocks + b]);
    args.my_arrive[b] = static_cast<unsigned long long*>(ptrs[2 * n_blocks + b]);
    args.dst_arrive[b] =
        static_cast<unsigned long long*>(ptrs[3 * n_blocks + b]);
    args.dst_ready[b] = static_cast<unsigned long long*>(ptrs[4 * n_blocks + b]);
    args.my_ready[b] = static_cast<unsigned long long*>(ptrs[5 * n_blocks + b]);
  }
  halo_permute<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args, n_words, static_cast<unsigned long long>(epoch), sys_scope,
      static_cast<unsigned int*>(err));
  return static_cast<int>(cudaGetLastError());
}

// Let the current card write into ``peer``'s memory (a mesh over several
// cards). Already enabled counts as success.
extern "C" int halo_enable_peer(int peer) {
  cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return static_cast<int>(e);
}
