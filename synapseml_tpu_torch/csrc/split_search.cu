// Kernel E: the split search of one GBDT growth step.
//
// Replaces: synapseml_tpu/gbdt/grow.py::best_splits (grow.py:300, its
// non-voting branch) over combined_gain / gain_table (:255-298) and
// _prefix_bins (:95). From the (L, d, B, 3) f32 histograms [G, H, C] of every
// leaf it finds each leaf's best (gain, feature, bin):
//   numeric feature f, bin b: the split 'bin <= b', from inclusive prefixes
//     GL, HL, CL over bins 0..b;
//   categorical feature (cat_mask[f] > 0): the bins ordered by the key
//     -G/(H + cat_smooth) + 0, ascending and stable (NaN last), and entry b
//     is the set of the first b + 1 bins in that order, valid only when
//     b + 1 <= max_cat_threshold;
//   gain = (t(GL)^2/(HL + l2) + t(GR)^2/(HR + l2)) - t(G)^2/(H + l2), with
//     t the L1 soft threshold, GR = G - GL (and so on), counted where
//     b < B - 1, CL, CR >= min_data, HL, HR >= min_hess and feature_mask[f] > 0,
//     else -inf;
//   per leaf the first maximum of the flattened (d * B) table, a NaN counting
//     as the maximum (torch.argmax and jnp.argmax agree on both), and gain
//     -inf for the leaves at or beyond n_active.
// Every multiply, divide and add is the _rn intrinsic, in the order of the
// torch ops of split_search_plain, so nvcc contracts nothing into an FMA and
// the gain rounds as there. On histograms of pre-rounded gradients every
// prefix and total is exact in any order, so the bits are the plain
// version's.
//
// Bound on the H100: bytes, L*d*B*12 (0.67 MB at L=31, d=28, B=64: 0.2 us
// at the H100 SXM's 3.35 TB/s), so launch latency, not the card, sets the
// time. The point of the kernel is to replace the ~45 small torch launches
// of the gain table, the argmax and the categorical sort with two.
//
// Design: launch 1 has one block per (feature, leaf). It reduces the row's
// totals, then walks the bins in chunks of blockDim: a block-wide inclusive
// scan of (G, H, C) (warp shuffles, then the warps' totals), plus the carry
// of the earlier chunks, gives each thread its bin's prefix; the thread
// keeps its best (gain, bin), and a block reduction gives the feature's.
// A categorical feature first ranks its bins: each bin counts the bins that
// come before it in the stable order (B compares a bin, keys in shared
// memory), which is the stable sort's position, and the scan then reads the
// bins through that permutation. Any B that kernel A takes works: the key
// and permutation need 8*B bytes of shared memory (155 KB at kernel A's
// largest B), and the scan loops over chunks. Launch 2 has one block per
// leaf and reduces the features' bests to the leaf's, smallest feature first
// among equals.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float l1, l2, min_data, min_hess, cat_smooth;
  int max_cat;
};

// (a, ia) comes before (b, ib) in the argmax: NaN first, then the larger
// value, then the smaller index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  if (a != b) return a > b;
  return ia < ib;
}

// t(G)^2 / (H + l2), with t(G) = sign(G) * max(|G| - l1, 0) (NaN stays NaN)
__device__ __forceinline__ float gain_term(float g, float h, const Params& p) {
  float m = __fsub_rn(fabsf(g), p.l1);
  m = m < 0.f ? 0.f : m;
  const float s = g > 0.f ? 1.f : (g < 0.f ? -1.f : 0.f);
  const float t = __fmul_rn(s, m);
  return __fdiv_rn(__fmul_rn(t, t), __fadd_rn(h, p.l2));
}

// Block-wide argmax of (v, i) over all threads; every thread gets the result.
__device__ void block_best(float& v, int& i, float* s_v, int* s_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, o);
    const int oi = __shfl_down_sync(kFull, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { s_v[warp] = v; s_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? s_v[lane] : -INFINITY;
    i = lane < nw ? s_i[lane] : INT32_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(kFull, v, o);
      const int oi = __shfl_down_sync(kFull, i, o);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { s_v[0] = v; s_i[0] = i; }
  }
  __syncthreads();
  v = s_v[0];
  i = s_i[0];
  __syncthreads();
}

// Block-wide sum of three values; every thread gets the result. The order
// of the additions does not matter on the pre-rounded grid.
__device__ void block_sum3(float& a, float& b, float& c, float* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_down_sync(kFull, a, o));
    b = __fadd_rn(b, __shfl_down_sync(kFull, b, o));
    c = __fadd_rn(c, __shfl_down_sync(kFull, c, o));
  }
  if (lane == 0) { s[warp] = a; s[32 + warp] = b; s[64 + warp] = c; }
  __syncthreads();
  if (warp == 0) {
    a = lane < nw ? s[lane] : 0.f;
    b = lane < nw ? s[32 + lane] : 0.f;
    c = lane < nw ? s[64 + lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      a = __fadd_rn(a, __shfl_down_sync(kFull, a, o));
      b = __fadd_rn(b, __shfl_down_sync(kFull, b, o));
      c = __fadd_rn(c, __shfl_down_sync(kFull, c, o));
    }
    if (lane == 0) { s[0] = a; s[32] = b; s[64] = c; }
  }
  __syncthreads();
  a = s[0];
  b = s[32];
  c = s[64];
  __syncthreads();
}

// Block-wide inclusive scan of three values (blockDim a multiple of 32).
// Returns the block's totals through tot_*.
__device__ void block_scan3(float& a, float& b, float& c, float* s, float& tot_a,
                            float& tot_b, float& tot_c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const float ta = __shfl_up_sync(kFull, a, o);
    const float tb = __shfl_up_sync(kFull, b, o);
    const float tc = __shfl_up_sync(kFull, c, o);
    if (lane >= o) {
      a = __fadd_rn(a, ta);
      b = __fadd_rn(b, tb);
      c = __fadd_rn(c, tc);
    }
  }
  if (lane == 31) { s[warp] = a; s[32 + warp] = b; s[64 + warp] = c; }
  __syncthreads();
  if (warp == 0) {
    float wa = lane < nw ? s[lane] : 0.f;
    float wb = lane < nw ? s[32 + lane] : 0.f;
    float wc = lane < nw ? s[64 + lane] : 0.f;
    for (int o = 1; o < 32; o <<= 1) {
      const float ta = __shfl_up_sync(kFull, wa, o);
      const float tb = __shfl_up_sync(kFull, wb, o);
      const float tc = __shfl_up_sync(kFull, wc, o);
      if (lane >= o) {
        wa = __fadd_rn(wa, ta);
        wb = __fadd_rn(wb, tb);
        wc = __fadd_rn(wc, tc);
      }
    }
    if (lane < nw) { s[lane] = wa; s[32 + lane] = wb; s[64 + lane] = wc; }
  }
  __syncthreads();
  if (warp > 0) {
    a = __fadd_rn(a, s[warp - 1]);
    b = __fadd_rn(b, s[32 + warp - 1]);
    c = __fadd_rn(c, s[64 + warp - 1]);
  }
  tot_a = s[nw - 1];
  tot_b = s[32 + nw - 1];
  tot_c = s[64 + nw - 1];
  __syncthreads();
}

__global__ void feature_best_kernel(const float* __restrict__ hists, int d, int B,
                                    const float* __restrict__ fmask,
                                    const float* __restrict__ cmask, Params p,
                                    float* __restrict__ out_gain, int* __restrict__ out_bin) {
  extern __shared__ float smem[];  // categorical: key[B], then perm[B]
  __shared__ float s_red[96];
  __shared__ int s_idx[32];
  const int f = blockIdx.x, l = blockIdx.y;
  const int slot = l * d + f;
  if (!(fmask[f] > 0.f)) {  // every entry is -inf: the first (bin 0) wins
    if (threadIdx.x == 0) { out_gain[slot] = -INFINITY; out_bin[slot] = 0; }
    return;
  }
  const float* row = hists + (size_t)slot * B * 3;
  const bool is_cat = cmask != nullptr && cmask[f] > 0.f;

  float GT = 0.f, HT = 0.f, CT = 0.f;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    GT = __fadd_rn(GT, row[3 * b]);
    HT = __fadd_rn(HT, row[3 * b + 1]);
    CT = __fadd_rn(CT, row[3 * b + 2]);
  }
  block_sum3(GT, HT, CT, s_red);

  int* perm = reinterpret_cast<int*>(smem + B);
  if (is_cat) {
    float* key = smem;
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      const float r = __fdiv_rn(row[3 * b], __fadd_rn(row[3 * b + 1], p.cat_smooth));
      key[b] = __fadd_rn(-r, 0.f);
    }
    __syncthreads();
    // the stable order's position: the bins that come before b
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      const float kb = key[b];
      const bool nb = isnan(kb);
      int rank = 0;
      for (int q = 0; q < B; ++q) {
        const float kq = key[q];
        const bool nq = isnan(kq);
        const bool before = nb ? (!nq || q < b) : (!nq && (kq < kb || (kq == kb && q < b)));
        rank += before;
      }
      perm[rank] = b;
    }
    __syncthreads();
  }

  const float gain_total = gain_term(GT, HT, p);
  float best = -INFINITY;
  int best_b = INT32_MAX;
  float cg = 0.f, ch = 0.f, cc = 0.f;  // carry: the sums of the earlier chunks
  for (int base = 0; base < B; base += blockDim.x) {
    const int pos = base + threadIdx.x;
    float g = 0.f, h = 0.f, c = 0.f;
    if (pos < B) {
      const int b = is_cat ? perm[pos] : pos;
      g = row[3 * b];
      h = row[3 * b + 1];
      c = row[3 * b + 2];
    }
    float tg, th, tc;
    block_scan3(g, h, c, s_red, tg, th, tc);
    if (pos < B) {
      const float GL = __fadd_rn(cg, g), HL = __fadd_rn(ch, h), CL = __fadd_rn(cc, c);
      const float GR = __fsub_rn(GT, GL), HR = __fsub_rn(HT, HL), CR = __fsub_rn(CT, CL);
      const bool valid = pos < B - 1 && CL >= p.min_data && CR >= p.min_data &&
                         HL >= p.min_hess && HR >= p.min_hess &&
                         (!is_cat || pos + 1 <= p.max_cat);
      const float gain =
          __fsub_rn(__fadd_rn(gain_term(GL, HL, p), gain_term(GR, HR, p)), gain_total);
      const float v = valid ? gain : -INFINITY;
      if (better(v, pos, best, best_b)) { best = v; best_b = pos; }
    }
    cg = __fadd_rn(cg, tg);
    ch = __fadd_rn(ch, th);
    cc = __fadd_rn(cc, tc);
  }
  block_best(best, best_b, s_red, s_idx);
  if (threadIdx.x == 0) { out_gain[slot] = best; out_bin[slot] = best_b; }
}

__global__ void leaf_best_kernel(const float* __restrict__ feat_gain,
                                 const int* __restrict__ feat_bin, int d, int n_active,
                                 float* __restrict__ gain, int* __restrict__ feature,
                                 int* __restrict__ bin) {
  __shared__ float s_v[32];
  __shared__ int s_i[32];
  const int l = blockIdx.x;
  float best = -INFINITY;
  int best_f = INT32_MAX;
  for (int f = threadIdx.x; f < d; f += blockDim.x) {
    const float v = feat_gain[l * d + f];
    if (better(v, f, best, best_f)) { best = v; best_f = f; }
  }
  block_best(best, best_f, s_v, s_i);
  if (threadIdx.x == 0) {
    gain[l] = l < n_active ? best : -INFINITY;
    feature[l] = best_f;
    bin[l] = feat_bin[l * d + best_f];
  }
}

}  // namespace

extern "C" int smt_split_search(const void* hists, int L, int d, int B, const void* fmask,
                                const void* cmask, int n_active, float l1, float l2,
                                float min_data, float min_hess, float cat_smooth,
                                int max_cat, void* scratch_gain, void* scratch_bin,
                                void* gain, void* feature, void* bin, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (L <= 0 || d <= 0 || B <= 0 || L > 65535) return (int)cudaErrorInvalidValue;
  const Params p{l1, l2, min_data, min_hess, cat_smooth, max_cat};
  const int threads = B <= 32 ? 32 : B <= 64 ? 64 : B <= 128 ? 128 : 256;
  const size_t smem = cmask != nullptr ? (size_t)B * (sizeof(float) + sizeof(int)) : 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(feature_best_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  feature_best_kernel<<<dim3(d, L), threads, smem, s>>>(
      (const float*)hists, d, B, (const float*)fmask, (const float*)cmask, p,
      (float*)scratch_gain, (int*)scratch_bin);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  leaf_best_kernel<<<L, 256, 0, s>>>((const float*)scratch_gain, (const int*)scratch_bin, d,
                                     n_active, (float*)gain, (int*)feature, (int*)bin);
  return (int)cudaGetLastError();
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
