// Kernel L: the lasso's cyclic coordinate descent of the local explainers.
//
// Replaces: synapseml_tpu/explainers/regression.py::_fit_core's lasso
// branch (:72-85), vmapped over every (instance, target) fit by
// fit_regression_batch (:106-141): fori_loop over max_iter sweeps of a
// fori_loop over the k coordinates, each step
//   rho  = Xty[j] - gram[j] @ beta + gram[j, j] * beta[j]
//   b_j  = sign(rho) * max(|rho| - lam, 0)
//   b_j  = sq[j] > 0 ? b_j / sq[j] : 0
// on the rescaled system's Gram matrix, which the wrapper
// (explainers/regression.py) forms with one batched matmul beforehand, as
// the reference forms it with an XLA dot outside the loop. The fits of one
// instance share its Gram matrix and sq (the targets differ only in Xty).
//
// Design (a first, correct one):
// - one block of kThreads threads a fit, one launch for all fits and all
//   max_iter sweeps;
// - the whole block stages the fit's Gram matrix (k x k), Xty, sq and
//   gram's diagonal into shared memory; beta starts at 0 there;
// - warp 0 then runs the descent alone (the steps are a chain: step j + 1
//   reads beta[j]): lane l sums gram[j][i] * beta[i] for i = l, l + 32, ...
//   in i order, a butterfly of shuffles gives every lane the dot, lane 0
//   writes b_j, __syncwarp orders it before the next dot;
// - every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
//   __fsub_rn: no fused multiply-add), in the reference's expression order;
// - past the k whose Gram matrix fits the card's shared memory per block
//   (227 KB on the H100: k <= 239), the rows of gram are read from global
//   memory (they stay in L2: a fit reads its k x k matrix max_iter times).
//
// Bound on the H100: max_iter * k * 2k flops a fit at the f32 rate, against
// the Gram matrices read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
lasso_cd_kernel(const float* __restrict__ gram, const float* __restrict__ xty,
                const float* __restrict__ sq, float* __restrict__ beta, int t, int k,
                int max_iter, float lam, int gram_in_smem) {
  extern __shared__ float smem[];
  float* s_beta = smem;
  float* s_xty = s_beta + k;
  float* s_sq = s_xty + k;
  float* s_diag = s_sq + k;
  float* s_gram = s_diag + k;
  const long long fit = blockIdx.x;
  const long long inst = fit / t;
  const float* g = gram + inst * (long long)k * k;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    s_beta[i] = 0.0f;
    s_xty[i] = xty[fit * k + i];
    s_sq[i] = sq[inst * k + i];
    s_diag[i] = g[(long long)i * k + i];
  }
  if (gram_in_smem) {
    const long long kk = (long long)k * k;
    for (long long i = threadIdx.x; i < kk; i += kThreads) s_gram[i] = g[i];
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const float* G = gram_in_smem ? s_gram : g;
  for (int it = 0; it < max_iter; ++it) {
    for (int j = 0; j < k; ++j) {
      const float* row = G + (long long)j * k;
      float acc = 0.0f;
      for (int i = lane; i < k; i += 32) acc = __fadd_rn(acc, __fmul_rn(row[i], s_beta[i]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
      if (lane == 0) {
        const float bj = s_beta[j];
        const float rho = __fadd_rn(__fsub_rn(s_xty[j], acc), __fmul_rn(s_diag[j], bj));
        const float mag = fmaxf(__fsub_rn(fabsf(rho), lam), 0.0f);
        const float sign = rho > 0.0f ? 1.0f : (rho < 0.0f ? -1.0f : 0.0f);
        const float soft = rho != rho ? rho : __fmul_rn(sign, mag);  // NaN stays NaN
        const float s = s_sq[j];
        s_beta[j] = s > 0.0f ? __fdiv_rn(soft, s) : 0.0f;
      }
      __syncwarp();
    }
  }
  for (int i = lane; i < k; i += 32) beta[fit * k + i] = s_beta[i];
}

}  // namespace

// Largest k whose Gram matrix the kernel keeps in shared memory on the
// current device (the rest is 4 vectors of k).
extern "C" int smt_lasso_smem_k(int* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int k = 0;
  while ((long long)(k + 1) * (k + 1) * 4 + 16LL * (k + 1) <= optin) ++k;
  *out = k;
  return 0;
}

// gram (n, k, k), sq (n, k): one per instance; xty, beta (n * t, k): one per
// fit, fit = instance * t + target. All f32, contiguous, on the device.
extern "C" int smt_lasso_cd(const void* gram, const void* xty, const void* sq, void* beta,
                            long long n_fits, int t, int k, int max_iter, float lam,
                            void* stream) {
  if (n_fits <= 0 || k <= 0) return 0;
  if (t <= 0 || max_iter < 0 || n_fits % t != 0 || n_fits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int smem_k = 0;
  int err = smt_lasso_smem_k(&smem_k);
  if (err != 0) return err;
  const int in_smem = k <= smem_k;
  const size_t smem = sizeof(float) * (4 * (size_t)k + (in_smem ? (size_t)k * k : 0));
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(lasso_cd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (err != 0) return err;
  }
  lasso_cd_kernel<<<(unsigned)n_fits, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)gram, (const float*)xty, (const float*)sq, (float*)beta, t, k, max_iter,
      lam, in_smem);
  return (int)cudaGetLastError();
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
