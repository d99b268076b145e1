// Kernel K: the k largest entries of every row of a score matrix, in the
// reference's order.
//
// Replaces: jax.lax.top_k over the score matrices of
// synapseml_tpu/nn/knn.py:46 (Q @ K.T, the KNN / ConditionalKNN search) and
// synapseml_tpu/recommendation/sar.py:211 (SARModel._top_k over
// affinity @ similarity). lax.top_k ranks by XLA's total order on f32:
// +NaN, +inf down to +0.0, then -0.0, down to -inf, then -NaN, and entries
// with the same bits come lower index first. Neither torch.topk (its own tie
// order) nor a descending sort (-NaN first, -0.0 equal to +0.0) gives that,
// so the port selects by the order-preserving key
//   u = bits ^ (sign ? 0xFFFFFFFF : 0x80000000)
// (ascending u is the total order), descending u, ties by ascending index,
// and returns the input's own bits. No float comparison is made anywhere.
//
// Bound on the H100: the scores read once and the (rows, k) values and
// indices written once, at the memory rate. What holds this design is that
// it reads a row several times.
//
// Design (the first; a simple one that is right):
// - one block of 1,024 threads a row;
// - radix select of the k-th largest key in 8-bit digits, most significant
//   first: each pass histograms the digit of the keys whose higher digits
//   match the prefix found so far (a shared-memory histogram, lanes with the
//   same digit combined by __match_any_sync before one atomic), and warp 0
//   finds the bucket that holds the k-th key. A pass ends the search early
//   when that bucket holds exactly as many keys as are still to be taken;
// - compaction: every key above the selected group is taken, and so is
//   the group itself when it is taken whole (slots from a block counter, in
//   no order). Otherwise the group is the keys equal to the k-th, of which
//   the lowest-index ones are taken: the row is walked in index order, a
//   block-wide scan a 1,024 keys, until enough are taken;
// - the k candidates, each one 64-bit word (~key << 32 | index: ascending
//   words are descending keys, ties by ascending index), are sorted by a
//   bitonic sort, in shared memory up to kSmemK candidates (TOPK_SMEM_K in
//   nn/topk.py) and past it in the global scratch the wrapper passes.
// Every pass reads the row from device memory (through the read-only
// cache); fewer passes over the row and the product fused into the select
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;
// candidates sorted in shared memory up to this k (32 KB of words)
constexpr int kSmemK = 4096;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v);
  return b ^ ((b & 0x80000000u) ? kFull : 0x80000000u);
}

__device__ __forceinline__ unsigned long long word_of(unsigned key, unsigned idx) {
  return ((unsigned long long)(~key) << 32) | idx;
}

struct Select {
  unsigned hist[256];
  unsigned warp_count[kWarps];
  unsigned prefix;   // the selected group's high digits
  unsigned mask;     // which digits the prefix fixes
  unsigned need;     // keys still to take from the group
  unsigned bucket;   // keys in the group
  unsigned n_above;  // slots handed out to keys above the group
  unsigned n_group;  // group keys taken so far (ordered walk)
  unsigned chunk;    // group keys in the current chunk (ordered walk)
};

// One radix pass over the digit at `shift`.
__device__ void radix_pass(const float* __restrict__ x, long long n, int shift, Select& s) {
  for (int i = threadIdx.x; i < 256; i += kThreads) s.hist[i] = 0;
  __syncthreads();
  const unsigned prefix = s.prefix, mask = s.mask;
  const int lane = threadIdx.x & 31;
  for (long long base = 0; base < n; base += (long long)kThreads * kUnroll) {
    unsigned u[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = base + (long long)j * kThreads + threadIdx.x;
      u[j] = i < n ? order_key(__ldg(x + i)) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = base + (long long)j * kThreads + threadIdx.x;
      const unsigned digit = (i < n && (u[j] & mask) == prefix) ? (u[j] >> shift) & 255u : 256u;
      const unsigned same = __match_any_sync(kFull, digit);
      if (digit < 256u && lane == __ffs(same) - 1) atomicAdd(&s.hist[digit], __popc(same));
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // lane l holds the buckets 255 - 8l down to 248 - 8l
    unsigned c[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = s.hist[255 - 8 * lane - j];
      sum += c[j];
    }
    unsigned incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const unsigned need = s.need;
    const unsigned hit = __ballot_sync(kFull, incl >= need);
    if (lane == __ffs(hit) - 1) {
      unsigned above = incl - sum;
      int j = 0;
      for (; j < 7; ++j) {
        if (above + c[j] >= need) break;
        above += c[j];
      }
      s.need = need - above;
      s.bucket = c[j];
      s.prefix = prefix | ((unsigned)(255 - 8 * lane - j) << shift);
      s.mask = mask | (255u << shift);
    }
  }
  __syncthreads();
}

// Hands out slots to the keys that satisfy `take`, one atomic a warp.
__device__ __forceinline__ void take_unordered(bool take, unsigned key, long long i,
                                               unsigned* counter,
                                               unsigned long long* cand) {
  const int lane = threadIdx.x & 31;
  const unsigned bal = __ballot_sync(kFull, take);
  if (bal == 0u) return;
  unsigned base = 0;
  if (lane == __ffs(bal) - 1) base = atomicAdd(counter, __popc(bal));
  base = __shfl_sync(kFull, base, __ffs(bal) - 1);
  if (take) cand[base + __popc(bal & ((1u << lane) - 1u))] = word_of(key, (unsigned)i);
}

__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ scores, long long n, int k, int pow2k, bool smem_cand,
            float* __restrict__ values, long long* __restrict__ indices,
            unsigned long long* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Select s;
  const long long r = blockIdx.x;
  const float* x = scores + r * n;
  unsigned long long* cand = smem_cand ? reinterpret_cast<unsigned long long*>(dyn)
                                       : scratch + r * (long long)pow2k;
  if (threadIdx.x == 0) {
    s.prefix = 0u;
    s.mask = 0u;
    s.need = (unsigned)k;
    s.bucket = 0u;
    s.n_above = 0u;
    s.n_group = 0u;
  }
  __syncthreads();

  for (int shift = 24; shift >= 0; shift -= 8) {
    radix_pass(x, n, shift, s);
    if (s.bucket == s.need) break;   // the group is taken whole
  }
  const unsigned prefix = s.prefix, mask = s.mask;
  const unsigned need = s.need;
  const bool whole = s.bucket == need;

  long long start = 0;
  if (!whole) {
    // mask is full: the group is the keys equal to `prefix`; the above ones
    // take slots [0, k - need), the `need` lowest-index equal ones follow
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned n_above = (unsigned)k - need;
    for (long long base = 0; base < n; base += kThreads) {
      const long long i = base + threadIdx.x;
      const unsigned u = i < n ? order_key(__ldg(x + i)) : 0u;
      const bool eq = i < n && u == prefix;
      take_unordered(i < n && u > prefix, u, i, &s.n_above, cand);
      const unsigned bal = __ballot_sync(kFull, eq);
      if (lane == 0) s.warp_count[warp] = __popc(bal);
      __syncthreads();
      if (warp == 0) {
        const unsigned c = s.warp_count[lane];
        unsigned incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned t = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += t;
        }
        s.warp_count[lane] = incl - c;
        if (lane == 31) s.chunk = incl;
      }
      __syncthreads();
      const unsigned rank = s.n_group + s.warp_count[warp] + __popc(bal & ((1u << lane) - 1u));
      if (eq && rank < need) cand[n_above + rank] = word_of(u, (unsigned)i);
      __syncthreads();
      if (threadIdx.x == 0) s.n_group += s.chunk;
      __syncthreads();
      if (s.n_group >= need) {
        start = base + kThreads;
        break;
      }
    }
    // the rest of the row: only keys above the group
    for (long long base = start; base < n; base += kThreads) {
      const long long i = base + threadIdx.x;
      const unsigned u = i < n ? order_key(__ldg(x + i)) : 0u;
      take_unordered(i < n && u > prefix, u, i, &s.n_above, cand);
    }
  } else {
    for (long long base = 0; base < n; base += kThreads) {
      const long long i = base + threadIdx.x;
      const unsigned u = i < n ? order_key(__ldg(x + i)) : 0u;
      take_unordered(i < n && (u & mask) >= prefix, u, i, &s.n_above, cand);
    }
  }
  for (int j = k + threadIdx.x; j < pow2k; j += kThreads) cand[j] = ~0ULL;
  __syncthreads();

  // bitonic sort of the pow2k words, ascending
  for (int size = 2; size <= pow2k; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < pow2k / 2; t += kThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = cand[lo], b = cand[hi];
        if ((a > b) == ((lo & size) == 0)) {
          cand[lo] = b;
          cand[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int j = threadIdx.x; j < k; j += kThreads) {
    const unsigned idx = (unsigned)(cand[j] & 0xFFFFFFFFULL);
    indices[r * k + j] = (long long)idx;
    values[r * k + j] = x[idx];
  }
}

int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

}  // namespace

// scores (rows, n) f32, contiguous, on the device; values (rows, k) f32 and
// indices (rows, k) int64 written. scratch: rows * pow2(k) 8-byte words of
// device memory when k > kSmemK, else unused (may be null). 1 <= k <= n < 2^31.
extern "C" int smt_topk_select(const void* scores, long long rows, long long n, int k,
                               void* values, void* indices, void* scratch, void* stream) {
  if (rows <= 0 || k <= 0) return 0;
  if (n < k || n >= 0x7fffffffLL || k > (1 << 30) || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int p = pow2_at_least(k);
  const bool smem_cand = k <= kSmemK;
  if (!smem_cand && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_cand ? 8ULL * p : 0ULL;
  cudaStream_t s = (cudaStream_t)stream;
  const float* x = static_cast<const float*>(scores);
  float* v = static_cast<float*>(values);
  long long* ix = static_cast<long long*>(indices);
  unsigned long long* sc = static_cast<unsigned long long*>(scratch);
  const cudaError_t err = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  topk_kernel<<<(unsigned)rows, kThreads, bytes, s>>>(x, n, k, p, smem_cand, v, ix, sc);
  return (int)cudaGetLastError();
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
