// Neighbour halo exchange on a ring of logical ranks, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel blah2_tpu/parallel/halo.py::_rdma_permute
// (Pallas: a neighbour barrier on semaphores, then a remote DMA of a small
// f32 buffer to ring neighbour d-1 or d+1). What it computes: every rank of
// a ring sends its payload into the receive buffer of its neighbour,
// circularly; with the edge mask, the receive buffer of the ring's edge
// rank is zero-filled instead (the wrap-around that the JAX caller masks).
//
// Design. One process drives all of its ranks, so one call covers every
// rank of the process: per device one launch whose grid's y index b is one
// block of work, most often the sending for one of that device's ranks r to
// the rank q that receives from r.
//
// Blocks. Each block has a source, a destination and four flag words, and
// any of the destination and the flags may be null: a null part is skipped.
// So one launch serves a mix of pairs: pairs whose both ends the launch
// holds, pairs whose other end lies in another process (its receive buffer
// and flags mapped here by CUDA IPC), and blocks that only zero-fill a
// receive buffer (the masked edge whose sender is in another process that
// this launch cannot reach; such pairs move through the process group, off
// the kernel). A block with a null destination copies nothing; one with null
// flags waits for nothing.
//
// Payload layout. A payload is `rows` runs of `words` 32-bit words, run k
// starting at word k * `stride` of the rank's source pointer: a (B, n)
// block sliced [..., :count] or [..., -count:] is read where it lies, with
// no copy first. complex64 and complex128 pass as their interleaved real
// and imaginary words, float32 and float64 as theirs, so the copy is
// bit-exact whatever the type. Receive buffers are contiguous: on one card
// the wrapper allocates one (ranks on the card, *shape) tensor per call;
// with flags they lie in the plan's window (see below).
//
// One card (`sys_scope` == 0): a plain strided copy, no flags, over a grid
// of (chunks, ranks) blocks, kChunk words a block. Every rank
// of the call lies on one device and the launch is on that device's one
// stream, so (1) the launch starts only after every earlier kernel on the
// stream has finished, which is all the arrive barrier below guarantees
// (no earlier kernel still reads a receive buffer), and (2) the stream's
// next kernel starts only after the launch ends, which is all the ready
// wait guarantees (every receive buffer is written).
//
// Across cards (`sys_scope` != 0), where a peer's stream is not ordered
// with ours (another card of the process, or a card of another process on
// the host, reached through CUDA IPC), the TPU kernel's barrier:
// semaphores that are signalled and then consumed by the wait
// (pltpu.semaphore_signal, then semaphore_wait, which takes away what it
// waited for), one block per rank (a grid of (1, blocks)). Block b,
// sending rank r's payload to rank q:
//
//   1. arrive: thread 0 signals arrive[r] (stores 1, release), then
//      consumes arrive[q]: waits until it is 1 (acquire) and stores 0.
//      Rank q's block runs only after every earlier kernel on q's stream,
//      so once q has arrived nothing earlier still reads q's receive
//      buffer.
//   2. copy: the block writes the payload (or zeros) into q's receive
//      buffer on q's card, through unified addressing.
//   3. signal: __syncthreads, a system fence, then thread 0 signals
//      ready[q] (stores 1, release).
//   4. wait: thread 0 consumes ready[r] (acquire, then stores 0): the
//      rank's own buffer has arrived before the launch ends, so the
//      stream's next kernels may read it.
//
// Every arrive and every ready word has one producer and one consumer a
// call (the wrapper's routes build the blocks so), and a word is signalled
// again only after its consumer has cleared the last signal: the thread
// that clears arrive[q] then signals ready[q] with release, and q signals
// arrive[q] in its next call only after it acquired ready[q]; the thread
// that clears ready[r] does so before its launch ends, and r's next call
// signals arrive[r], which r's sender acquires before it signals ready[r]
// again. So each clear happens before the next signal of its word, a word
// is only ever 0 or 1, and a store is all a signal or a consume needs:
// no atomic operation touches a peer card's memory, which CUDA guarantees
// only on pairs with native peer atomics, not over every PCIe link.
// Nothing is reset and nothing travels from the host: a launch's
// parameters are the same on every call, so one graph node replays any
// number of times. The flags are 64-bit words in device memory, one arrive
// and one ready word per rank, on the rank's own card.
// The flag words, the error word and the receive buffers of a plan (one per
// call site, shape and direction: call sites with no data dependency on
// each other get their own, the collective_id rule of the TPU kernel) live
// in one cudaMalloc'ed window per card (halo_window_alloc), outside
// PyTorch's caching allocator, so that an exported handle maps the window
// itself and not the base of a pooled block; across processes each process
// opens its peers' windows once (halo_ipc_open). Signals are
// st.release.sys, waits ld.acquire.sys, and clears st.relaxed.sys: a word
// may lie on a peer card. The error word lies on the launch's own card.
// The receive buffers are reused from call to call, and the arrive wait is
// what keeps a fast sender from overwriting a buffer that its receiver
// still reads: the receiver arrives only when every earlier kernel on its
// stream, the readers of the last call's buffer included, has finished.
//
// On one card the wrapper can take this protocol too (a plan made with
// flags on one card): then every block of the one launch waits on another
// block of it, which is safe for the few blocks (one a rank, at most
// kMaxRanks) that a card holds at once.
//
// No hang: a wait that runs past kSpinLimit clock cycles (about half a
// second) writes a nonzero error word (1 for the barrier, 2 for the data)
// and leaves the block; the plan's semaphores are then out of step, and
// the wrapper raises on the word. A debugger, the profiler or CUDA_LAUNCH_BLOCKING
// can serialise the launches of two cards, and then the first would wait
// for ever on a rank whose launch has not been issued. The wrapper reads
// the word where the caller synchronises anyway.
//
// Bound: a call moves a few KB (a (409,) complex64 halo is 3,272 B a rank),
// a few ns at 3.35 TB/s. On one card what it costs is one short launch and
// one memory latency: each thread issues its kUnroll loads before it
// stores any, so a thread does not wait on one load after another. The
// flag round trips are paid only across cards.
//
// Interface: plain C, bound from Python with ctypes. The launcher makes
// `device` current where it is not, enqueues on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunk = kThreads * kUnroll;
constexpr int kMaxRanks = 32;
constexpr long long kSpinLimit = 1000000000LL;

// Per block: source payload, neighbour's receive buffer, and (across cards)
// the four flag words (own arrive, neighbour's arrive, neighbour's ready,
// own ready). Bit b of zero_mask: block b writes zeros.
struct HaloArgs {
  const unsigned int* src[kMaxRanks];
  unsigned int* dst[kMaxRanks];
  unsigned long long* my_arrive[kMaxRanks];
  unsigned long long* dst_arrive[kMaxRanks];
  unsigned long long* dst_ready[kMaxRanks];
  unsigned long long* my_ready[kMaxRanks];
  unsigned int zero_mask;
};

// Signal a semaphore: store 1, with release semantics at system scope.
__device__ __forceinline__ void signal_sys(unsigned long long* p) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(1ULL)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Consume the signal of a semaphore: spin until *p is 1, then store 0;
// false if the wait ran past kSpinLimit cycles (nothing cleared).
__device__ bool consume(unsigned long long* p) {
  const long long t0 = clock64();
  while (load_acquire_sys(p) < 1ULL) {
    if (clock64() - t0 > kSpinLimit) return false;
    __nanosleep(64);
  }
  asm volatile("st.relaxed.sys.global.u64 [%0], %1;" ::"l"(p), "l"(0ULL)
               : "memory");
  return true;
}

// Chunks blockIdx.x, blockIdx.x + gridDim.x, ... of the payload.
__device__ __forceinline__ void copy_payload(const unsigned int* src,
                                             unsigned int* dst, bool zero,
                                             int rows, int words,
                                             long long stride) {
  const int n = rows * words;
  for (int i0 = blockIdx.x * kChunk + threadIdx.x; i0 < n;
       i0 += gridDim.x * kChunk) {
    unsigned int v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      const int k = i / words;
      v[u] = (!zero && i < n) ? src[k * stride + (i - k * words)] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) dst[i] = v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
halo_permute(const HaloArgs args, int rows, int words, long long stride,
             int sys_scope, unsigned int* err) {
  const int b = blockIdx.y;
  const bool zero = (args.zero_mask >> b) & 1u;
  unsigned int* dst = args.dst[b];
  if (sys_scope == 0) {
    if (dst != nullptr) {
      copy_payload(args.src[b], dst, zero, rows, words, stride);
    }
    return;
  }

  __shared__ int s_ok;
  if (threadIdx.x == 0) {
    if (args.my_arrive[b] != nullptr) signal_sys(args.my_arrive[b]);
    s_ok = args.dst_arrive[b] == nullptr || consume(args.dst_arrive[b]);
    if (!s_ok) atomicOr(err, 1u);
  }
  __syncthreads();
  if (!s_ok) return;

  if (dst != nullptr) {
    copy_payload(args.src[b], dst, zero, rows, words, stride);
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    if (args.dst_ready[b] != nullptr) {
      __threadfence_system();
      signal_sys(args.dst_ready[b]);
    }
    if (args.my_ready[b] != nullptr && !consume(args.my_ready[b])) {
      atomicOr(err, 2u);
    }
  }
}

}  // namespace

extern "C" int halo_max_ranks() { return kMaxRanks; }

// ptrs holds 2 * n_blocks addresses on one card (sources, then neighbours'
// receive buffers) or 6 * n_blocks across cards (then own arrive flags,
// neighbours' arrive flags, neighbours' ready flags, own ready flags), each
// a run of n_blocks; any but a source may be null (that part is skipped).
extern "C" int halo_launch(int n_blocks, void* const* ptrs, int rows,
                           int words, long long stride, unsigned int zero_mask,
                           int sys_scope, void* err,
                           int device, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxRanks || rows < 0 || words < 0 ||
      stride < words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  HaloArgs args;
  for (int b = 0; b < n_blocks; ++b) {
    args.src[b] = static_cast<const unsigned int*>(ptrs[b]);
    args.dst[b] = static_cast<unsigned int*>(ptrs[n_blocks + b]);
    if (sys_scope != 0) {
      args.my_arrive[b] =
          static_cast<unsigned long long*>(ptrs[2 * n_blocks + b]);
      args.dst_arrive[b] =
          static_cast<unsigned long long*>(ptrs[3 * n_blocks + b]);
      args.dst_ready[b] =
          static_cast<unsigned long long*>(ptrs[4 * n_blocks + b]);
      args.my_ready[b] =
          static_cast<unsigned long long*>(ptrs[5 * n_blocks + b]);
    } else {
      args.my_arrive[b] = args.dst_arrive[b] = nullptr;
      args.dst_ready[b] = args.my_ready[b] = nullptr;
    }
  }
  args.zero_mask = zero_mask;
  const long long n = static_cast<long long>(rows) * words;
  const int chunks = sys_scope != 0 || n <= kChunk
                         ? 1
                         : static_cast<int>((n + kChunk - 1) / kChunk);
  const dim3 grid(chunks, n_blocks);
  halo_permute<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args, rows, words, stride, sys_scope, static_cast<unsigned int*>(err));
  e = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(e);
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

// The window entries below make `device` current for their calls and give
// the previous current device back, as halo_launch does.
namespace {

struct OnDevice {
  int previous = -1;
  cudaError_t error;
  explicit OnDevice(int device) {
    error = cudaGetDevice(&previous);
    if (error == cudaSuccess && previous != device) {
      error = cudaSetDevice(device);
    }
  }
  ~OnDevice() {
    if (previous >= 0) cudaSetDevice(previous);
  }
};

}  // namespace

extern "C" int halo_ipc_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

// A window of `bytes` zeroed bytes on `device` for a plan that takes flags:
// cudaMalloc'ed, so that its IPC handle (written to `handle` where that is
// not null, halo_ipc_handle_bytes() long) maps exactly this allocation.
// Synchronises the card, so the zeros are in place before a launch or a
// peer uses the window.
extern "C" int halo_window_alloc(long long bytes, int device, void** ptr,
                                 void* handle) {
  OnDevice on(device);
  cudaError_t e = on.error;
  if (e == cudaSuccess) e = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess && handle != nullptr) {
    e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  }
  return static_cast<int>(e);
}

// Map a peer process's window (its handle) into this process, for launches
// on `device`; the peer's card becomes reachable from `device`.
extern "C" int halo_ipc_open(const void* handle, int device, void** ptr) {
  OnDevice on(device);
  cudaError_t e = on.error;
  if (e == cudaSuccess) {
    cudaIpcMemHandle_t h;
    memcpy(&h, handle, sizeof(h));
    e = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  }
  return static_cast<int>(e);
}

// Unmap a peer's window (`opened`) or free one's own.
extern "C" int halo_window_release(void* ptr, int device, int opened) {
  OnDevice on(device);
  cudaError_t e = on.error;
  if (e == cudaSuccess) {
    e = opened ? cudaIpcCloseMemHandle(ptr) : cudaFree(ptr);
  }
  return static_cast<int>(e);
}
