// Kernel E: the decision half of one GBDT growth step, in one launch.
//
// Replaces: synapseml_tpu/gbdt/grow.py's growth step (grow.py:362-425) minus
// the row routing and the child histogram: best_splits (grow.py:300, its
// non-voting branch) over combined_gain / gain_table (:255-298) and
// _prefix_bins (:95), the depth cap, the argmax over leaves, split_detail
// (:320) and the writes of the step's record. From the (L, d, B, 3) f32
// histograms [G, H, C] of the leaves it scores each (leaf, feature):
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
//     as the maximum (torch.argmax and jnp.argmax agree on both).
// Every multiply, divide and add is the _rn intrinsic, in the order of the
// torch ops of split_search_plain, so nvcc contracts nothing into an FMA and
// the gain rounds as there. On histograms of pre-rounded gradients every
// prefix and total is exact in any order, so the bits are the plain
// version's.
//
// Two modes share the kernel (SplitArgs::full):
//   full: every leaf is scored and each leaf's best (gain, feature, bin)
//     written, gain -inf at or beyond n_active (split_search's table entry);
//   step s: only the leaves step s - 1 changed are scored -- leaf 0 at s = 0,
//     then leaf s (new, or empty after an inert step) and, when step s - 1
//     split, its parent leaf, read from the record on the device (no host
//     sync). A leaf keeps its histogram bits until a split changes it, so the
//     workspace's per-(leaf, feature) and per-leaf bests equal a full
//     rescoring. The last block then applies the max_depth cap, takes the
//     first maximum over the active leaves 0..s, sets ok = gain >
//     max(min_gain_to_split, 0), and writes the step's record (parent[s],
//     feat[s], bin[s] (-1 when categorical), gains[s], cat_sets[s], depth),
//     the chosen (leaf, feature) and ok for the routing, and the (B,) left
//     set of the split taken (split_detail's: bins <= b, or the categorical
//     bins of rank <= b that hold rows; all false on an inert step).
//
// Bound on the H100: bytes, the histograms read once, 12 bytes a cell (a
// step reads the one or two leaves it rescores: 43 KB at d=28, B=64, 0.01 us
// at 3.35 TB/s), so launch latency and the host's call cost set the time.
// The point of the step mode is one launch a split step, with nothing
// allocated and only the step index passed from the host.
//
// Design: one block per (feature, rescored leaf). It reduces the row's
// totals, then walks the bins in chunks of blockDim: a block-wide inclusive
// scan of (G, H, C) (warp shuffles, then the warps' totals), plus the carry
// of the earlier chunks, gives each thread its bin's prefix; the thread
// keeps its best (gain, bin), and a block reduction gives the feature's.
// A categorical feature first sorts its (key, bin) pairs in shared memory by
// a bitonic sort over P = the next power of two >= B (padding keys are NaN
// with bins >= B, so they sort last); the order is total (ties by bin), so
// it is the stable order, at O(B log^2 B) compare-exchanges (36 stages at
// B = 256) where ranking by counting took B compares a bin. The scan then
// reads the bins in that order. In step mode the block also writes its
// feature's left set for its best entry (cat_left), since the decision needs
// the chosen feature's order. Every B that kernel A takes works: the sort
// needs 6*P bytes of shared memory (192 KB at P = 32768); where P equals
// the block size (B in (nt/2, nt]), the stages of distance < 32 run on warp
// shuffles and only 6 of the 36 at B = 256 touch shared memory. Then, in
// full mode, each block takes its leaf's ticket (a __threadfence, then an
// atomic counter that the last block resets), and the last of a leaf's
// feature blocks reduces the leaf, so the leaves reduce in parallel; in
// step mode every block takes the step's ticket, and the last one reduces
// the one or two leaves scored (a warp each) and decides the split.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrored field for field by gbdt/split_search.py::_SplitArgs. Outside the
// anonymous namespace: smt_split_search takes it, and a type with internal
// linkage would give that entry point internal linkage too.
struct SplitArgs {
  const float* hists;     // (L, d, B, 3)
  const float* fmask;     // (d,)
  const float* cmask;     // (d,) or null: every feature numeric
  float* feat_gain;       // (L, d) workspace: best gain of each (leaf, feature)
  int* feat_bin;          // (L, d)
  float* leaf_gain;       // (L,) each leaf's best (full mode: the outputs)
  int* leaf_feat;         // (L,)
  int* leaf_bin;          // (L,)
  int8_t* cat_left;       // (L, d, B) step mode with cmask: left set of each best
  unsigned* tickets;      // (L + 1,) per leaf, then the step's; 0 between launches
  int* parent;            // (L - 1,) step record
  int* feat;              // (L - 1,)
  int* bin;               // (L - 1,)
  float* gains;           // (L - 1,)
  int8_t* cat_sets;       // (L - 1, B) or null
  int* depth;             // (L,)
  long long* choice;      // (2,): the chosen leaf and feature
  int8_t* ok;             // (1,) bool
  int8_t* in_set;         // (B,) bool
  int L, d, B, n_active, full, max_depth, max_cat, device;
  float l1, l2, min_data, min_hess, cat_smooth, min_gain;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;

// (a, ia) comes before (b, ib) in the argmax: NaN first, then the larger
// value, then the smaller index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  if (a != b) return a > b;
  return ia < ib;
}

// (ka, ia) comes before (kb, ib) in the categorical order: key ascending,
// NaN last, ties by bin. A total order, so every sort gives the stable one.
__device__ __forceinline__ bool key_before(float ka, int ia, float kb, int ib) {
  const bool an = isnan(ka), bn = isnan(kb);
  if (an) return bn && ia < ib;
  if (bn) return true;
  return ka < kb || (ka == kb && ia < ib);
}

// t(G)^2 / (H + l2), with t(G) = sign(G) * max(|G| - l1, 0) (NaN stays NaN)
__device__ __forceinline__ float gain_term(float g, float h, const SplitArgs& p) {
  float m = __fsub_rn(fabsf(g), p.l1);
  m = m < 0.f ? 0.f : m;
  const float s = g > 0.f ? 1.f : (g < 0.f ? -1.f : 0.f);
  const float t = __fmul_rn(s, m);
  return __fdiv_rn(__fmul_rn(t, t), __fadd_rn(h, p.l2));
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, o);
    const int oi = __shfl_down_sync(kFull, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Block-wide argmax of (v, i) over all threads; every thread gets the result.
__device__ void block_best(float& v, int& i, float* s_v, int* s_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  warp_best(v, i);
  if (lane == 0) { s_v[warp] = v; s_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? s_v[lane] : -INFINITY;
    i = lane < nw ? s_i[lane] : INT32_MAX;
    warp_best(v, i);
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

// The leaf that block row y scores at step s, or -1 (no leaf: the previous
// step was inert).
__device__ __forceinline__ int leaf_of(const SplitArgs& a, int s, int y) {
  if (a.full) return y;
  return y == 0 ? s : a.parent[s - 1];
}

// Bitonic sort of the P (key, bin) pairs in shared memory under key_before.
// With one pair a thread (P == blockDim, which holds for B in (nt/2, nt]),
// each thread keeps its pair in registers: the stages of partner distance
// j < 32 are warp shuffles, and only those of j >= 32 go through shared
// memory. Otherwise every stage is a pass over shared memory.
__device__ void bitonic_sort(float* key, uint16_t* order, int P) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (P == nt) {
    float k = key[tid];
    int i = order[tid];
    for (int kk = 2; kk <= P; kk <<= 1) {
      for (int j = kk >> 1; j > 0; j >>= 1) {
        float pk;
        int pi;
        if (j >= 32) {
          __syncthreads();
          key[tid] = k;
          order[tid] = (uint16_t)i;
          __syncthreads();
          pk = key[tid ^ j];
          pi = order[tid ^ j];
        } else {
          pk = __shfl_xor_sync(kFull, k, j);
          pi = __shfl_xor_sync(kFull, i, j);
        }
        // the lower position of an ascending pair (or the upper one of a
        // descending pair) keeps the pair's first element in the order
        const bool first = ((tid & j) == 0) == ((tid & kk) == 0);
        if (first ? key_before(pk, pi, k, i) : key_before(k, i, pk, pi)) {
          k = pk;
          i = pi;
        }
      }
    }
    __syncthreads();
    key[tid] = k;
    order[tid] = (uint16_t)i;
    __syncthreads();
    return;
  }
  for (int kk = 2; kk <= P; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < P / 2; t += nt) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo + j;
        const float k_lo = key[lo], k_hi = key[hi];
        const int i_lo = order[lo], i_hi = order[hi];
        const bool swap = (lo & kk) == 0 ? key_before(k_hi, i_hi, k_lo, i_lo)
                                         : key_before(k_lo, i_lo, k_hi, i_hi);
        if (swap) {
          key[lo] = k_hi;
          key[hi] = k_lo;
          order[lo] = (uint16_t)i_hi;
          order[hi] = (uint16_t)i_lo;
        }
      }
      __syncthreads();
    }
  }
}

// Best (gain, bin) of feature f of one leaf into feat_gain / feat_bin; in
// step mode a categorical feature also writes the left set of its best.
__device__ void score_feature(const SplitArgs& a, int leaf, int f, int P, char* smem,
                              float* s_red, int* s_idx) {
  const int B = a.B, tid = threadIdx.x, nt = blockDim.x;
  const int slot = leaf * a.d + f;
  if (!(a.fmask[f] > 0.f)) {  // every entry is -inf: the first (bin 0) wins
    if (tid == 0) { a.feat_gain[slot] = -INFINITY; a.feat_bin[slot] = 0; }
    return;
  }
  const float* row = a.hists + (size_t)slot * B * 3;
  const bool is_cat = a.cmask != nullptr && a.cmask[f] > 0.f;

  float GT = 0.f, HT = 0.f, CT = 0.f;
  for (int b = tid; b < B; b += nt) {
    GT = __fadd_rn(GT, row[3 * b]);
    HT = __fadd_rn(HT, row[3 * b + 1]);
    CT = __fadd_rn(CT, row[3 * b + 2]);
  }
  block_sum3(GT, HT, CT, s_red);

  float* key = reinterpret_cast<float*>(smem);       // categorical: P keys,
  uint16_t* order = reinterpret_cast<uint16_t*>(key + P);  // then P bins
  if (is_cat) {
    for (int i = tid; i < P; i += nt) {
      float k = __int_as_float(0x7fc00000);  // padding: NaN, after every bin
      if (i < B) {
        const float r = __fdiv_rn(row[3 * i], __fadd_rn(row[3 * i + 1], a.cat_smooth));
        k = __fadd_rn(-r, 0.f);
      }
      key[i] = k;
      order[i] = (uint16_t)i;
    }
    __syncthreads();
    bitonic_sort(key, order, P);
  }

  const float gain_total = gain_term(GT, HT, a);
  float best = -INFINITY;
  int best_b = INT32_MAX;
  float cg = 0.f, ch = 0.f, cc = 0.f;  // carry: the sums of the earlier chunks
  for (int base = 0; base < B; base += nt) {
    const int pos = base + tid;
    float g = 0.f, h = 0.f, c = 0.f;
    if (pos < B) {
      const int b = is_cat ? order[pos] : pos;
      g = row[3 * b];
      h = row[3 * b + 1];
      c = row[3 * b + 2];
    }
    float tg, th, tc;
    block_scan3(g, h, c, s_red, tg, th, tc);
    if (pos < B) {
      const float GL = __fadd_rn(cg, g), HL = __fadd_rn(ch, h), CL = __fadd_rn(cc, c);
      const float GR = __fsub_rn(GT, GL), HR = __fsub_rn(HT, HL), CR = __fsub_rn(CT, CL);
      const bool valid = pos < B - 1 && CL >= a.min_data && CR >= a.min_data &&
                         HL >= a.min_hess && HR >= a.min_hess &&
                         (!is_cat || pos + 1 <= a.max_cat);
      const float gain =
          __fsub_rn(__fadd_rn(gain_term(GL, HL, a), gain_term(GR, HR, a)), gain_total);
      const float v = valid ? gain : -INFINITY;
      if (better(v, pos, best, best_b)) { best = v; best_b = pos; }
    }
    cg = __fadd_rn(cg, tg);
    ch = __fadd_rn(ch, th);
    cc = __fadd_rn(cc, tc);
  }
  block_best(best, best_b, s_red, s_idx);
  if (tid == 0) { a.feat_gain[slot] = best; a.feat_bin[slot] = best_b; }
  if (is_cat && a.cat_left != nullptr) {
    // split_detail's left set: the bins of rank <= best_b that hold rows
    int8_t* left = a.cat_left + (size_t)slot * B;
    for (int pos = tid; pos < B; pos += nt) {
      const int b = order[pos];
      left[b] = (int8_t)(pos <= best_b && row[3 * b + 2] > 0.f);
    }
  }
}

// Leaf `leaf`'s best over its features (the first maximum, smallest feature
// first among equals), by one warp; full mode gives gain -inf at or beyond
// n_active.
__device__ void leaf_best(const SplitArgs& a, int leaf) {
  const int lane = threadIdx.x & 31, d = a.d;
  float best = -INFINITY;
  int best_f = INT32_MAX;
  for (int f = lane; f < d; f += 32) {
    const float v = __ldcg(a.feat_gain + leaf * d + f);
    if (better(v, f, best, best_f)) { best = v; best_f = f; }
  }
  warp_best(best, best_f);
  if (lane == 0) {
    a.leaf_gain[leaf] = a.full && leaf >= a.n_active ? -INFINITY : best;
    a.leaf_feat[leaf] = best_f;
    a.leaf_bin[leaf] = __ldcg(a.feat_bin + leaf * d + best_f);
  }
}

// Step mode, the last block: the best of the one or two leaves scored (a
// warp a leaf), then the decision and the record of step s.
__device__ void decide(const SplitArgs& a, int s, float* s_red, int* s_idx) {
  const int tid = threadIdx.x, nt = blockDim.x, d = a.d, B = a.B;
  for (int y = tid >> 5; y < (s == 0 ? 1 : 2); y += nt >> 5) {
    const int leaf = leaf_of(a, s, y);
    if (leaf >= 0) leaf_best(a, leaf);
  }
  if (s == 0) {
    for (int i = tid; i < a.L; i += nt) a.depth[i] = 0;
  }
  __syncthreads();

  // the first maximum over the active leaves 0..s, under the depth cap
  float g = -INFINITY;
  int l = INT32_MAX;
  for (int i = tid; i <= s; i += nt) {
    float v = a.leaf_gain[i];
    if (a.max_depth > 0 && !(a.depth[i] < a.max_depth)) v = -INFINITY;
    if (better(v, i, g, l)) { g = v; l = i; }
  }
  block_best(g, l, s_red, s_idx);
  const bool ok = g > a.min_gain;
  const int f = a.leaf_feat[l], b = a.leaf_bin[l];
  const bool is_cat = a.cmask != nullptr && a.cmask[f] > 0.f;
  const int8_t* cat_left = is_cat ? a.cat_left + (size_t)(l * d + f) * B : nullptr;
  for (int i = tid; i < B; i += nt) {
    const bool left = ok && (is_cat ? __ldcg(cat_left + i) != 0 : i <= b);
    a.in_set[i] = (int8_t)left;
    if (a.cat_sets != nullptr) a.cat_sets[(size_t)s * B + i] = (int8_t)(left && is_cat);
  }
  if (tid == 0) {
    a.parent[s] = ok ? l : -1;
    a.feat[s] = f;
    a.bin[s] = is_cat ? -1 : b;
    a.gains[s] = ok ? g : 0.f;
    if (ok) {
      const int child_depth = a.depth[l] + 1;
      a.depth[s + 1] = child_depth;
      a.depth[l] = child_depth;
    }
    a.choice[0] = l;
    a.choice[1] = f;
    a.ok[0] = (int8_t)ok;
  }
}

// Takes a ticket of `counter` (`blocks` blocks take one); true in the last
// block, which resets the counter for the next launch and then sees every
// other block's writes.
__device__ bool last_block(unsigned* counter, unsigned blocks, bool* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(counter, 1u) == blocks - 1;
  __syncthreads();
  if (!*s_last) return false;
  __threadfence();
  if (threadIdx.x == 0) *counter = 0;
  return true;
}

__global__ void split_kernel(const SplitArgs a, int s, int P) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float s_red[96];
  __shared__ int s_idx[32];
  __shared__ bool s_last;
  const int leaf = leaf_of(a, s, blockIdx.y);
  if (leaf >= 0) {
    score_feature(a, leaf, blockIdx.x, P, smem, s_red, s_idx);
    if (a.full && last_block(a.tickets + leaf, gridDim.x, &s_last) && threadIdx.x < 32) {
      leaf_best(a, leaf);
    }
  }
  if (!a.full && last_block(a.tickets + a.L, gridDim.x * gridDim.y, &s_last)) {
    decide(a, s, s_red, s_idx);
  }
}

}  // namespace

// Full mode: every leaf (s is ignored). Step mode: step s of a tree, after
// steps 0..s-1 of the same tree ran on this workspace.
extern "C" int smt_split_search(const SplitArgs* a, int s, void* stream) {
  if (a->L <= 0 || a->d <= 0 || a->B <= 0 || a->L > 65535 || a->B > 32768)
    return (int)cudaErrorInvalidValue;
  if (!a->full && (s < 0 || s >= a->L - 1)) return (int)cudaErrorInvalidValue;
  int P = 1;
  while (P < a->B) P <<= 1;
  const int B = a->B;
  const int threads = B <= 32 ? 32 : B <= 64 ? 64 : B <= 128 ? 128 : 256;
  const size_t smem = a->cmask != nullptr ? (size_t)P * (sizeof(float) + sizeof(uint16_t)) : 0;
  const dim3 grid(a->d, a->full ? a->L : (s == 0 ? 1 : 2));
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != a->device && (err = cudaSetDevice(a->device)) != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err == cudaSuccess) {
    split_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(*a, s, P);
    err = cudaGetLastError();
  }
  if (prev != a->device) cudaSetDevice(prev);
  return (int)err;
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
