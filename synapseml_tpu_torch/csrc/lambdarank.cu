// Kernel F: the LambdaRank gradient and hessian of every row.
//
// Replaces: synapseml_tpu/gbdt/boost.py::_lambda_grads (:170-211), with the
// group tables of ::_group_tables (:156), which XLA computes as dense
// (Q, G, G) tensors over queries padded to the largest one (G). At
// MSLR-WEB30K's training shape (18,919 queries, G = 1,251) one such f32
// tensor is about 118 GB; here a query's documents sit in shared memory and
// its pairs never leave registers.
//
// Rows are contiguous by query (offsets (Q+1,) int32). Over query q's m
// documents, with its scores s, labels l and gains gain = 2^l - 1 (computed
// once a fit, as is the query's truncated ideal DCG max_dcg, floored at
// 1e-12: both depend on the labels only):
//   rank_i = #{s_j > s_i} + #{s_j == s_i, j < i}, the stable descending
//            order (jnp.argsort is stable; at iteration 0 every score ties);
//   disc_i = disc[rank_i], the table 1 / log2(2 + r);
//   a pair (i, j) counts when l_i > l_j and rank_i or rank_j < truncation:
//     rho   = 1 / (1 + exp(sigma * (s_i - s_j)))
//     delta = |gain_i - gain_j| * |disc_i - disc_j| / max_dcg
//     lam   = sigma * rho * delta
//     hp    = sigma^2 * rho * (1 - rho) * delta
//   g_i = -(sum_j lam_ij) + sum_j lam_ji,  h_i = sum_j hp_ij + sum_j hp_ji,
//   out: g_i * w_i and max(h_i, 1e-12) * w_i.
// Each product and sum is rounded on its own (__f*_rn, IEEE division), in
// the order the plain version (gbdt/lambdarank.py::lambda_grads_plain) takes
// them, and each sum over j in j order; the exponential is exp_f32 below,
// the plain version's exp_f32 op for op (CUDA's expf and the CPU's differ in
// the last place). So the kernel gives the plain version's bits, on the
// card and on the CPU.
//
// Bound on the H100: the larger of the rows' bytes (score, label, weight,
// gain read once, g and h written once: n * 16) at the memory rate and one
// exponential a counted pair at the SFU rate (the function needs one rho a
// pair, which feeds both its documents). This kernel evaluates each pair's
// rho twice, once from each document's side (each thread owns its
// documents' sums), and spends about 20 FMA-pipe operations on exp_f32
// where the SFU would take one.
//
// Design (a first version, simple and exact):
// - one block of 256 threads a query; its documents go to shared memory as
//   {score, label, gain, disc} (16 bytes, one load a pair step, broadcast to
//   the warp) plus a score array for the rank count; a query of more than
//   kSmemDocs documents keeps the same records in a global scratch buffer
//   (L2-resident), so no group is refused;
// - ranks by counting, no sort: each thread counts for its documents over all
//   m, then stores disc[rank] with the truncation flag in the sign bit;
// - each thread owns documents i = tid, tid + 256, ... and walks j = 0..m-1,
//   keeping two accumulators per output (i the winner, i the loser), and
//   combines them as the reference does (-a + b).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemDocs = 2048;  // 20 bytes each: 40 KB, five blocks an SM

// e^x, the plain version's exp_f32: Cody-Waite reduction by ln 2 and a
// degree-8 Taylor polynomial, every operation rounded on its own
__device__ __forceinline__ float exp_f32(float x) {
  if (x > 88.f) return __int_as_float(0x7f800000);  // +inf
  const float xc = x < -20.f ? -20.f : x;
  const float k = rintf(__fmul_rn(xc, 1.44269502f));
  const float r = __fsub_rn(__fsub_rn(xc, __fmul_rn(k, 0.693145751953125f)),
                            __fmul_rn(k, 1.42860677e-06f));
  float p = 2.48015876e-05f;  // 1/8!
  p = __fadd_rn(__fmul_rn(p, r), 0.000198412701f);
  p = __fadd_rn(__fmul_rn(p, r), 0.00138888892f);
  p = __fadd_rn(__fmul_rn(p, r), 0.00833333377f);
  p = __fadd_rn(__fmul_rn(p, r), 0.0416666679f);
  p = __fadd_rn(__fmul_rn(p, r), 0.166666672f);
  p = __fadd_rn(__fmul_rn(p, r), 0.5f);
  p = __fadd_rn(__fmul_rn(p, r), 1.f);
  p = __fadd_rn(__fmul_rn(p, r), 1.f);
  return __fmul_rn(p, __int_as_float(((int)k + 127) << 23));
}

struct Args {
  const float* score;    // (n,)
  const float* label;    // (n,)
  const float* gain;     // (n,) 2^label - 1
  const float* weight;   // (n,)
  const int* offsets;    // (Q+1,)
  const float* max_dcg;  // (Q,)
  const float* disc;     // (G,) 1 / log2(2 + r)
  float4* scratch;       // (n,) records of queries over kSmemDocs, or null
  float* g;              // (n,)
  float* h;              // (n,)
  int truncation;
  float sigma, sigma2;
};

// the records of one query, given where they live (shared or global memory)
__device__ __forceinline__ void rank_pass(const float* sc, float4* docs, int m, const Args& a) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float si = sc[i];
    int r = 0;
    for (int j = 0; j < m; ++j) {
      const float sj = sc[j];
      r += (sj > si) | ((sj == si) & (j < i));
    }
    const float d = a.disc[r];
    docs[i].w = r < a.truncation ? d : -d;  // disc > 0: the sign carries rank < truncation
  }
}

__device__ __forceinline__ void pair_pass(const float4* docs, int m, int start, float max_dcg,
                                          const Args& a) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float4 di = docs[i];
    const bool top_i = di.w > 0.f;
    const float disc_i = fabsf(di.w);
    float ga = 0.f, gb = 0.f, ha = 0.f, hb = 0.f;
    for (int j = 0; j < m; ++j) {
      const float4 dj = docs[j];
      const bool win = di.y > dj.y, lose = dj.y > di.y;
      if (!(win | lose) || !(top_i | (dj.w > 0.f))) continue;
      const float sd = win ? __fsub_rn(di.x, dj.x) : __fsub_rn(dj.x, di.x);
      const float rho = __fdiv_rn(1.f, __fadd_rn(1.f, exp_f32(__fmul_rn(a.sigma, sd))));
      const float delta = __fdiv_rn(
          __fmul_rn(fabsf(__fsub_rn(di.z, dj.z)), fabsf(__fsub_rn(disc_i, fabsf(dj.w)))),
          max_dcg);
      const float lam = __fmul_rn(__fmul_rn(a.sigma, rho), delta);
      const float hp = __fmul_rn(__fmul_rn(__fmul_rn(a.sigma2, rho), __fsub_rn(1.f, rho)), delta);
      if (win) {
        ga = __fadd_rn(ga, lam);
        ha = __fadd_rn(ha, hp);
      } else {
        gb = __fadd_rn(gb, lam);
        hb = __fadd_rn(hb, hp);
      }
    }
    const float g = __fadd_rn(-ga, gb);
    float h = __fadd_rn(ha, hb);
    h = h < 1e-12f ? 1e-12f : h;
    const float w = a.weight[start + i];
    a.g[start + i] = __fmul_rn(g, w);
    a.h[start + i] = __fmul_rn(h, w);
  }
}

// one query: its records in shared memory (kShared: up to kSmemDocs
// documents, with a copy of the scores) or in the global scratch (the
// scores read where they lie); a template, so that each loop's loads take
// their own address space
template <bool kShared>
__device__ __forceinline__ void run_query(float4* smem, int q, int start, int m, const Args& a) {
  float4* docs = kShared ? smem : a.scratch + start;
  float* sc_smem = reinterpret_cast<float*>(smem + m);
  const float* sc = kShared ? sc_smem : a.score + start;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float s = a.score[start + i];
    if (kShared) sc_smem[i] = s;
    docs[i] = make_float4(s, a.label[start + i], a.gain[start + i], 0.f);
  }
  __syncthreads();
  rank_pass(sc, docs, m, a);
  __syncthreads();
  pair_pass(docs, m, start, a.max_dcg[q], a);
}

__global__ void __launch_bounds__(kThreads) lambdarank_kernel(Args a) {
  extern __shared__ float4 smem[];
  const int q = blockIdx.x;
  const int start = a.offsets[q];
  const int m = a.offsets[q + 1] - start;
  if (m <= 0) return;
  if (m <= kSmemDocs)
    run_query<true>(smem, q, start, m, a);
  else
    run_query<false>(smem, q, start, m, a);
}

}  // namespace

extern "C" int smt_lambdarank(const void* score, const void* label, const void* gain,
                              const void* weight, const void* offsets, const void* max_dcg,
                              const void* disc, int Q, int G, int truncation, float sigma,
                              float sigma2, void* scratch, void* g, void* h, void* stream) {
  if (Q <= 0) return 0;
  if (G > kSmemDocs && scratch == nullptr) return (int)cudaErrorInvalidValue;
  Args a{(const float*)score, (const float*)label,   (const float*)gain,
         (const float*)weight, (const int*)offsets, (const float*)max_dcg,
         (const float*)disc,  (float4*)scratch,      (float*)g,
         (float*)h,           truncation,            sigma,
         sigma2};
  const int docs = G < kSmemDocs ? (G > 0 ? G : 1) : kSmemDocs;
  const size_t smem = (size_t)docs * (sizeof(float4) + sizeof(float));
  lambdarank_kernel<<<(unsigned)Q, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
