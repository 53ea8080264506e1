// Host-side launch helper shared by the scan kernels (flat_scan.cu,
// union_scan.cu).
#pragma once

#include <cuda_runtime.h>

#include <mutex>

// Opt kernel `fn` in to `smem` bytes of dynamic shared memory (needed above
// 48 KB) on the current device, once per (kernel, device, size): a launch
// on the request path then makes no CUDA call for it. A size the card
// refuses (the wrappers probe for the largest tile that fits) leaves no
// error behind for the next launch's cudaGetLastError().
static cudaError_t prepare(const void* fn, size_t smem) {
  struct Done {
    const void* fn;
    int device;
    size_t smem;
  };
  static std::mutex mu;
  static Done done[256];
  static int n_done = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_done; ++i)
    if (done[i].fn == fn && done[i].device == device && done[i].smem >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) cudaGetLastError();  // clear it: the caller reports e
  else if (n_done < 256) done[n_done++] = {fn, device, smem};
  return e;
}
