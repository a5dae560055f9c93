"""A host compiler's stand-in for the CUDA execution model, for the tests
that build a csrc/ kernel with g++ and run it on the CPU.

HOST_BLOCK_STUB is a header (g++ -include) that stubs the CUDA qualifiers,
makes threadIdx and blockIdx thread-local, and gives two ways to run a
launch, its blocks one after another:
- `host_grid(blocks, threads, run)`: each block's threads side by side as
  threads of the host; __syncthreads() is a barrier of the block's
  threads, __syncwarp() one of the warp's 32 threads, and the warp
  intrinsics (__shfl_sync, __shfl_up_sync, __shfl_xor_sync, __ballot_sync,
  __any_sync) exchange values through the warp's barrier. A kernel whose threads meet at
  barriers or exchange values in warps runs as on the card, with every
  block alone on the machine (a look-back over earlier blocks finds them
  done).
- `host_grid_in_turn(blocks, threads, run)`: each block's threads one after
  another, the barrier passing at once: for kernels whose threads share
  nothing a barrier orders, or whose first thread fills what the others
  read (far faster than the threads side by side).
`__shared__` variables are static, one copy that a block's threads share.
"""

HOST_BLOCK_STUB = r"""
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__ static
struct HostDim { unsigned x; };
static HostDim blockDim, gridDim;
static thread_local HostDim blockIdx, threadIdx;
template <class T> static inline T __ldg(const T* p) { return *p; }
struct alignas(16) ulonglong2 { unsigned long long x, y; };

// a barrier of `parties` host threads
struct HostBarrier {
  std::mutex m;
  std::condition_variable cv;
  unsigned parties = 1, count = 0, generation = 0;
  void wait() {
    std::unique_lock<std::mutex> lock(m);
    const unsigned gen = generation;
    if (++count == parties) {
      count = 0;
      ++generation;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return gen != generation; });
    }
  }
};
static HostBarrier host_block_barrier;
static HostBarrier host_warp_barrier[32];
static unsigned long long host_lane_value[32][32];
static inline void __syncthreads() { host_block_barrier.wait(); }
static inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  host_warp_barrier[threadIdx.x / 32].wait();
}

// every lane's v in the calling thread's warp (all its lanes call)
static inline void host_warp_values(unsigned long long v,
                                    unsigned long long* all) {
  const unsigned w = threadIdx.x / 32, lane = threadIdx.x % 32;
  host_warp_barrier[w].wait();  // the warp's last exchange has been read
  host_lane_value[w][lane] = v;
  host_warp_barrier[w].wait();
  for (int i = 0; i < 32; ++i) all[i] = host_lane_value[w][i];
}
static inline unsigned long long __shfl_sync(unsigned, unsigned long long v,
                                             int src) {
  unsigned long long all[32];
  host_warp_values(v, all);
  return all[src & 31];
}
static inline unsigned long long __shfl_up_sync(unsigned,
                                                unsigned long long v,
                                                unsigned d) {
  unsigned long long all[32];
  host_warp_values(v, all);
  const unsigned lane = threadIdx.x % 32;
  return lane >= d ? all[lane - d] : v;
}
static inline unsigned long long __shfl_xor_sync(unsigned,
                                                 unsigned long long v,
                                                 int d) {
  unsigned long long all[32];
  host_warp_values(v, all);
  return all[(threadIdx.x % 32) ^ d];
}
static inline unsigned __ballot_sync(unsigned, int p) {
  unsigned long long all[32];
  host_warp_values(p != 0, all);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= static_cast<unsigned>(all[i] != 0) << i;
  return m;
}
static inline int __any_sync(unsigned, int p) { return __ballot_sync(0, p) != 0; }
static inline int __ffs(unsigned x) { return __builtin_ffs(x); }

// blocks 0, 1, ... in turn, each block's threads one after another
static void host_grid_in_turn(unsigned blocks, unsigned threads,
                              void (*run)()) {
  gridDim.x = blocks;
  blockDim.x = threads;
  host_block_barrier.parties = 1;
  for (auto& b : host_warp_barrier) b.parties = 1;
  for (blockIdx.x = 0; blockIdx.x < blocks; ++blockIdx.x)
    for (threadIdx.x = 0; threadIdx.x < threads; ++threadIdx.x) run();
}

// blocks 0, 1, ... in turn, each block's `threads` threads side by side
static void host_grid(unsigned blocks, unsigned threads, void (*run)()) {
  gridDim.x = blocks;
  blockDim.x = threads;
  host_block_barrier.parties = threads;
  for (auto& b : host_warp_barrier) b.parties = threads < 32 ? threads : 32;
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t)
    pool.emplace_back([=] {
      threadIdx.x = t;
      for (unsigned b = 0; b < blocks; ++b) {
        blockIdx.x = b;
        run();
        host_block_barrier.wait();  // the block's shared memory is free
      }
    });
  for (auto& th : pool) th.join();
}
"""
