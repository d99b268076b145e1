// Kernel B: replay-list tree scoring for GBDT prediction.
//
// Replaces: synapseml_tpu/gbdt/device_predict.py::_score_kernel
// (device_predict.py:61-101), reached through device_raw_scores. For every
// row it replays the splits s = 0..S-1 of every tree (split s turns leaf
// parent[s] into (parent[s], s+1); a row in leaf parent[s] goes right when
// its bin in feature[s] exceeds bin[s]) and adds scale_t * leaf_value[node]
// to an f32 accumulator per class, tree after tree.
//
// Bound on the H100: bytes. The rows' bins are read once (n*d*sizeof(bin))
// and the (n, C) f32 scores written once; the tree arrays are small. The
// replay itself is T*C*S compares per row, far below the integer rate.
//
// Design: one thread per row; the row's bins stay in L1 (one row is d bytes
// at int8). The tree arrays are staged into shared memory in chunks of
// trees, so every thread of a block reads the same split from shared memory
// (a broadcast). The sum is taken in tree order with separately rounded
// multiply and add (__fmul_rn / __fadd_rn, never a fused multiply-add), so
// it is bit-equal to the plain version's acc = acc + scale_t * value and to
// the reference's scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 8;
constexpr int kSmemBytes = 32 * 1024;

template <typename BinT>
__global__ void score_kernel(const BinT* __restrict__ bins, long long n, int d,
                             const int* __restrict__ parent,
                             const int* __restrict__ feature,
                             const int* __restrict__ split_bin,
                             const float* __restrict__ leaf_value,
                             const float* __restrict__ scale, int T, int C, int S,
                             int chunk, float* __restrict__ out) {
  extern __shared__ int shm[];
  const int L = S + 1;
  int* sp = shm;                              // chunk*C*S parents
  int* sf = sp + chunk * C * S;               // features
  int* sb = sf + chunk * C * S;               // split bins
  float* sl = (float*)(sb + chunk * C * S);   // chunk*C*L leaf values
  float* ss = sl + chunk * C * L;             // chunk scales

  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < n;
  const BinT* rb = bins + (live ? row : 0) * d;
  float acc[kMaxClasses];
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) acc[c] = 0.f;

  for (int t0 = 0; t0 < T; t0 += chunk) {
    const int tc = min(chunk, T - t0);
    __syncthreads();
    const int nsplit = tc * C * S;
    const long long base = (long long)t0 * C * S;
    for (int i = threadIdx.x; i < nsplit; i += blockDim.x) {
      sp[i] = parent[base + i];
      sf[i] = feature[base + i];
      sb[i] = split_bin[base + i];
    }
    const long long lbase = (long long)t0 * C * L;
    for (int i = threadIdx.x; i < tc * C * L; i += blockDim.x) sl[i] = leaf_value[lbase + i];
    for (int i = threadIdx.x; i < tc; i += blockDim.x) ss[i] = scale[t0 + i];
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < tc; ++t) {
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c) {
        if (c >= C) break;
        const int off = (t * C + c) * S;
        int node = 0;
        for (int s = 0; s < S; ++s) {
          const int p = sp[off + s];
          if (p >= 0 && node == p && (int)rb[sf[off + s]] > sb[off + s]) node = s + 1;
        }
        acc[c] = __fadd_rn(acc[c], __fmul_rn(ss[t], sl[(t * C + c) * L + node]));
      }
    }
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c)
      if (c < C) out[row * C + c] = acc[c];
  }
}

template <typename BinT>
cudaError_t launch(const void* bins, long long n, int d, const int* parent,
                   const int* feature, const int* split_bin, const float* leaf_value,
                   const float* scale, int T, int C, int S, float* out,
                   cudaStream_t stream) {
  if (C < 1 || C > kMaxClasses || S < 0) return cudaErrorInvalidValue;
  const int per_tree = C * (3 * S + (S + 1)) * 4 + 4;
  int chunk = kSmemBytes / per_tree;
  if (chunk < 1) chunk = 1;
  if (chunk > T) chunk = T;
  const int smem = chunk * per_tree;
  auto kern = score_kernel<BinT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kThreads - 1) / kThreads;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const BinT*)bins, n, d, parent, feature, split_bin, leaf_value, scale, T, C, S,
      chunk, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int smt_tree_score(const void* bins, int bin_bytes, long long n, int d,
                              const void* parent, const void* feature,
                              const void* split_bin, const void* leaf_value,
                              const void* scale, int T, int C, int S, void* out,
                              void* stream) {
  const int* p = (const int*)parent;
  const int* f = (const int*)feature;
  const int* b = (const int*)split_bin;
  const float* lv = (const float*)leaf_value;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bin_bytes) {
    case 1: return (int)launch<int8_t>(bins, n, d, p, f, b, lv, sc, T, C, S, o, s);
    case 2: return (int)launch<int16_t>(bins, n, d, p, f, b, lv, sc, T, C, S, o, s);
    case 4: return (int)launch<int32_t>(bins, n, d, p, f, b, lv, sc, T, C, S, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
