// Launch facts of a kernel, computed once and then read from a table.
//
// A launcher that sizes its grid by the occupancy calculator would otherwise
// ask the runtime for the SM count, the occupancy and (for more than 48 KB of
// dynamic shared memory) raise the kernel's limit on every launch: host calls
// on a path whose launches the host already holds back. Here they are made
// the first time a (kernel, device, dynamic shared memory) triple is seen.
// Only cudaGetDevice stays a call a launch (it reads the thread's current
// device, a cheap runtime call).
//
// Included by one .cu file each (each is its own library): the table is the
// file's own.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

struct LaunchFacts {
  int per_sm;  // resident blocks an SM at this block size and shared memory
  int sms;     // the device's SM count
};

// The facts of `kern` at `threads` threads a block and `smem` bytes of dynamic
// shared memory on the current device. The kernel's dynamic shared memory
// limit is raised to the largest `smem` seen for it on that device (never
// lowered: an entry made for less must not undo one made for more).
cudaError_t launch_facts(const void* kern, int threads, int smem, LaunchFacts* out) {
  struct Entry {
    const void* kern;
    int dev, threads, smem;
    LaunchFacts facts;
  };
  constexpr int kEntries = 64;
  static std::mutex mu;
  static Entry table[kEntries];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  int largest = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = table[i];
    if (e.kern != kern || e.dev != dev) continue;
    if (e.threads == threads && e.smem == smem) {
      *out = e.facts;
      return cudaSuccess;
    }
    largest = e.smem > largest ? e.smem : largest;
  }
  if (smem > largest &&
      (err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
    return err;
  LaunchFacts f{0, 0};
  if ((err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.per_sm, kern, threads, smem)) !=
      cudaSuccess)
    return err;
  if (f.per_sm < 1) return cudaErrorInvalidConfiguration;
  if (used < kEntries) table[used++] = Entry{kern, dev, threads, smem, f};
  *out = f;
  return cudaSuccess;
}

}  // namespace
