// Kernel A: gradient histogram for the GBDT grower.
//
// Replaces: synapseml_tpu/gbdt/histogram.py::_hist_scatter / _hist_onehot
// (histogram.py:27-86), reached through histogram_panel (histogram.py:89).
// For every (feature f, bin b) it sums [g*w, h*w, w] over the rows whose bin
// in feature f is b, giving a (d, B, 3) f32 histogram. The products are taken
// here, from the (n,) g, h and w vectors, so no (n, 3) panel is built first.
//
// Bound on the H100: bytes. Each row is read once: d bins at their stored
// width plus 12 bytes of g, h and w, n*d*sizeof(bin) + 12n bytes at
// 3.35 TB/s. The arithmetic (2 multiplies and 3 adds per element) is
// negligible; the practical limit is the throughput of shared-memory atomics
// on hot cells.
//
// Design: each block keeps a private (dt, B, 3) f32 sub-histogram in shared
// memory for a tile of dt features (all d features when d*B*12 bytes fit;
// the grid's y axis walks feature tiles otherwise). Blocks grid-stride over
// the flattened (row, feature-in-tile) elements, so neighbouring threads
// read neighbouring bins (coalesced, at the stored width: int8/int16/int32,
// never widened on the host), and add the row's [g*w, h*w, w] with shared-memory
// atomics. At the end each block merges its non-zero cells into the global
// histogram with global atomics. The grid is sized by the occupancy
// calculator: as many blocks as can be resident, so the merge cost stays
// proportional to the number of SMs, not to n.
//
// Sums are taken in an order that changes from run to run. On gradients that
// were pre-rounded to a summation-exact grid (boost._preround), with 0/1
// weights, every partial sum is exact, and the result is bit-equal to any
// other order. The products round as PyTorch's do (__fmul_rn, no contraction).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 200 * 1024;  // bytes of one block's sub-histogram

template <typename BinT>
__global__ void hist_kernel(const BinT* __restrict__ bins,
                            const float* __restrict__ grad,
                            const float* __restrict__ hess,
                            const float* __restrict__ weight,
                            float* __restrict__ out, long long n, int d,
                            int n_bins, int tile) {
  extern __shared__ float sh[];
  const int f0 = blockIdx.y * tile;
  const int dt = min(tile, d - f0);
  const int cells = dt * n_bins * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  const long long total = n * dt;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long row = e / dt;
    const int j = (int)(e - row * dt);
    const int b = (int)bins[row * d + f0 + j];
    if (b < 0 || b >= n_bins) continue;  // out-of-range bins are dropped
    const float w = __ldg(weight + row);
    float* cell = sh + (j * n_bins + b) * 3;
    atomicAdd(cell, __fmul_rn(__ldg(grad + row), w));
    atomicAdd(cell + 1, __fmul_rn(__ldg(hess + row), w));
    atomicAdd(cell + 2, w);
  }
  __syncthreads();

  float* o = out + (long long)f0 * n_bins * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = sh[i];
    if (v != 0.f) atomicAdd(o + i, v);
  }
}

template <typename BinT>
cudaError_t launch(const void* bins, const float* grad, const float* hess,
                   const float* weight, float* out, long long n, int d, int n_bins,
                   cudaStream_t stream) {
  const int cell_bytes = n_bins * 3 * (int)sizeof(float);
  const int tile = min(d, max(1, kSmemBudget / cell_bytes));
  const int n_tiles = (d + tile - 1) / tile;
  const int smem = tile * cell_bytes;
  auto kern = hist_kernel<BinT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long work = (n * tile + kThreads - 1) / kThreads;
  long long gx = (long long)per_sm * sms / n_tiles;
  if (gx < 1) gx = 1;
  if (gx > work) gx = work;
  dim3 grid((unsigned)gx, (unsigned)n_tiles);
  kern<<<grid, kThreads, smem, stream>>>((const BinT*)bins, grad, hess, weight, out, n,
                                         d, n_bins, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" int smt_histogram(const void* bins, int bin_bytes, const void* grad,
                             const void* hess, const void* weight, void* out,
                             long long n, int d, int n_bins, void* stream) {
  const float* g = (const float*)grad;
  const float* h = (const float*)hess;
  const float* w = (const float*)weight;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bin_bytes) {
    case 1: return (int)launch<int8_t>(bins, g, h, w, o, n, d, n_bins, s);
    case 2: return (int)launch<int16_t>(bins, g, h, w, o, n, d, n_bins, s);
    case 4: return (int)launch<int32_t>(bins, g, h, w, o, n, d, n_bins, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
