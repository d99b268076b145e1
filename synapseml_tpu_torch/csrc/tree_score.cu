// Kernel B: GBDT tree scoring as a top-down walk over packed trees.
//
// Replaces: synapseml_tpu/gbdt/device_predict.py::_score_kernel (:60-101),
// reached through device_raw_scores (entry smt_tree_score: (n, C) f32
// scores), and ::_leaf_kernel (:25-57), reached through device_leaf_indices
// (entry smt_tree_leaf: (T, C, n) int32 leaf ids). The reference replays
// every split s = 0..S-1 of every tree for every row. The wrapper
// (gbdt/device_predict.py::pack_trees) turns each replay list into a
// top-down tree with the same leaf ids, so a row takes one step per level
// of the leaf it reaches instead of one per split.
//
// Packed tree: one block of `units` 16-byte units per tree (t, c), at
// t*C + c: the records, then one bitset of ceil(B/32) words per categorical
// record; record 0 is the root. A row goes left at a categorical record
// when its bin is in the set, as the reference's jnp.take(cat_set[s], col)
// > 0 (a negative bin counts from the end, one outside [-B, B) is in no
// set); at a numeric record it goes right when bin > threshold. A child >= 0
// is a record, < 0 is ~leaf. Records come in two widths (pack_trees picks):
// - narrow, 8 bytes: {feature | cat << 15 | threshold (int16) or bitset
//   word << 16, left (int16) | right << 16}, when features, thresholds,
//   records and leaves fit 15 or 16 bits (every model of up to 32,767
//   leaves and bins);
// - wide, 16 bytes: {feature | cat << 31, threshold or bitset word, left,
//   right}, for the rest.
//
// Bound on the H100: one decision per node on each row's path (the
// visits), at the INT32 rate, against the bins read once and the output
// written once. What holds the walk: each step is a dependent record load
// and then a dependent bin load from shared memory, at addresses that spread
// over the banks once the rows of a warp part ways, and the latency of the
// pair is what the warps of an SM have to hide.
//
// Design:
// - a block owns 256 rows, one a thread, and six blocks share an SM where
//   their shared memory allows: the walk is held by the latency of its
//   dependent loads, and more warps an SM hide more of it (2 or 4 rows a
//   thread at 2 to 4 blocks an SM measured slower, PERF.md §6, PR 4); the
//   rows' bins are staged in shared memory once, each row padded to an odd
//   number of words so that 32 rows reading one feature hit 32 banks (rows
//   too wide to stage are read from global);
// - trees stream through a two-stage shared-memory ring by cp.async: chunk
//   j+1 (records, and for scores the leaf values and scales) lands while
//   chunk j is walked; a tree too large for the ring is read from global;
// - narrow records halve the bytes of a divergent record load and fit twice
//   the trees in a ring stage;
// - each row walks the chunk's trees on its own (a row that reaches a leaf
//   goes on to its next tree), so a warp waits for its slowest row only at
//   a chunk's end;
// - classes are walked one after another, so any C; within a class the sum
//   runs in tree order with __fmul_rn / __fadd_rn (never a fused
//   multiply-add), bit-equal to the plain version and the reference's scan;
// - leaf ids go to a (chunk, 256) shared staging area, then out to
//   (T, C, n) with stores coalesced along n.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 1;                   // rows per thread
constexpr int kTile = kThreads * kRows;    // rows per block
constexpr int kBlocksPerSm = 6;            // blocks an SM holds at once, at most
constexpr int kSmemPerSm = 228 * 1024;     // shared memory of an SM
constexpr int kMaxSmem = 227 * 1024;       // one block per SM
constexpr int kMaxRowBytes = 160 * 1024;   // staged rows up to this at all

// shared memory a block may take when `blocks` blocks share an SM
constexpr int smem_budget(int blocks) { return kSmemPerSm / blocks - 1024; }

struct Args {
  const void* bins;         // (n, d) int8 / int16 / int32
  long long n;
  int d;
  const int4* nodes;        // (T*C, units) packed trees
  int units;                // int4 units per tree
  const float* leaf_value;  // (T, C, L)
  const float* scale;       // (T,)
  int T, C, L;
  int cat_bins;             // B of the categorical bitsets, 0 if none
  int chunk;                // trees per pass
  int row_stride;           // bytes per staged row
  void* out;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// words of one ring stage: records, then (scores) leaf values and scales
__host__ __device__ inline int stage_words(int units, int chunk, int L, bool leaf) {
  return units * 4 * chunk + (leaf ? 0 : (chunk * L + chunk + 3) / 4 * 4);
}

struct Node {
  int feature, threshold, left, right;  // threshold: bitset word when cat
  bool cat;
};

__device__ __forceinline__ Node decode(int2 r) {
  const bool cat = (r.x & 0x8000) != 0;
  return {r.x & 0x7fff, cat ? (int)((unsigned)r.x >> 16) : (int)(int16_t)(r.x >> 16),
          (int)(int16_t)(r.y & 0xffff), (int)(int16_t)(r.y >> 16), cat};
}

__device__ __forceinline__ Node decode(int4 r) {
  return {r.x & 0x7fffffff, r.y, r.z, r.w, r.x < 0};
}

template <typename BinT, bool kLeaf, bool kStageRows, bool kRing, bool kNarrow>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) tree_kernel(Args a) {
  extern __shared__ __align__(16) int smem[];
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kTile;
  const int rows_here = (int)min((long long)kTile, a.n - row0);
  const int L = a.L;
  const int sw = kRing ? stage_words(a.units, a.chunk, L, kLeaf) : 0;
  int* lid = smem + 2 * sw;  // leaf ids, (chunk, kTile)
  unsigned char* rows = reinterpret_cast<unsigned char*>(lid + (kLeaf ? a.chunk * kTile : 0));
  const BinT* gbins = static_cast<const BinT*>(a.bins);

  if (kStageRows) {
    const BinT* src = gbins + row0 * a.d;
    const int total = rows_here * a.d;
    for (int i = tid; i < total; i += kThreads) {
      const int r = i / a.d;
      *reinterpret_cast<BinT*>(rows + r * a.row_stride + (i - r * a.d) * (int)sizeof(BinT)) =
          src[i];
    }
  }

  const int per_class = (a.T + a.chunk - 1) / a.chunk;
  const int n_chunks = a.C * per_class;

  auto issue = [&](int j) {
    const int c = j / per_class;
    const int t0 = (j - c * per_class) * a.chunk;
    const int tc = min(a.chunk, a.T - t0);
    int* stg = smem + (j & 1) * sw;
    int4* dn = reinterpret_cast<int4*>(stg);
    for (int i = tid; i < tc * a.units; i += kThreads) {
      const int k = i / a.units;
      cp_async16(dn + i, a.nodes + ((long long)(t0 + k) * a.C + c) * a.units + (i - k * a.units));
    }
    if (!kLeaf) {
      float* dl = reinterpret_cast<float*>(stg) + a.chunk * a.units * 4;
      for (int i = tid; i < tc * L; i += kThreads) {
        const int k = i / L;
        cp_async4(dl + i, a.leaf_value + ((long long)(t0 + k) * a.C + c) * L + (i - k * L));
      }
      if (tid < tc) cp_async4(dl + a.chunk * L + tid, a.scale + t0 + tid);
    }
    cp_async_commit();
  };

  if (kRing) issue(0);
  float acc[kRows] = {};
  for (int j = 0; j < n_chunks; ++j) {
    const int c = j / per_class;
    const int t0 = (j - c * per_class) * a.chunk;
    const int tc = min(a.chunk, a.T - t0);
    if (kRing) {
      if (j + 1 < n_chunks) {
        issue(j + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    }
    __syncthreads();  // chunk j (and, at j = 0, the rows) visible to every thread

    const int* stg = smem + (j & 1) * sw;
    const float* sval = reinterpret_cast<const float*>(stg) + a.chunk * a.units * 4;
    auto record = [&](int k, int node) -> Node {
      using Rec = typename std::conditional<kNarrow, int2, int4>::type;
      constexpr int kPerUnit = 16 / sizeof(Rec);  // records per 16-byte unit
      if (kRing) return decode(reinterpret_cast<const Rec*>(stg)[k * a.units * kPerUnit + node]);
      return decode(__ldg(reinterpret_cast<const Rec*>(
                              a.nodes + ((long long)(t0 + k) * a.C + c) * a.units) + node));
    };
    auto word = [&](int k, int w) -> int {
      if (kRing) return stg[k * a.units * 4 + w];
      return __ldg(reinterpret_cast<const int*>(a.nodes) +
                   ((long long)(t0 + k) * a.C + c) * a.units * 4 + w);
    };
    auto leaf_term = [&](int k, int leaf) -> float {
      if (kRing) return __fmul_rn(sval[a.chunk * L + k], sval[k * L + leaf]);
      return __fmul_rn(__ldg(a.scale + t0 + k),
                       __ldg(a.leaf_value + ((long long)(t0 + k) * a.C + c) * L + leaf));
    };
    auto bin_at = [&](int r, int f) -> int {
      const int rl = tid + r * kThreads;
      if (kStageRows)
        return *reinterpret_cast<const BinT*>(rows + rl * a.row_stride + f * (int)sizeof(BinT));
      return __ldg(gbins + (row0 + rl) * a.d + f);
    };

    if (t0 == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    }
    int k[kRows], ref[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      k[r] = tid + r * kThreads < rows_here ? 0 : tc;
      ref[r] = 0;
    }
    for (;;) {
      bool busy = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (k[r] >= tc) continue;
        busy = true;
        const Node nd = record(k[r], ref[r]);
        const int v = bin_at(r, nd.feature);
        bool right = v > nd.threshold;
        if (nd.cat) {
          const int u = v < 0 ? v + a.cat_bins : v;
          right = !((unsigned)u < (unsigned)a.cat_bins &&
                    ((word(k[r], nd.threshold + (u >> 5)) >> (u & 31)) & 1));
        }
        const int next = right ? nd.right : nd.left;
        if (next >= 0) {
          ref[r] = next;
          continue;
        }
        if (kLeaf) {
          lid[k[r] * kTile + tid + r * kThreads] = ~next;
        } else {
          acc[r] = __fadd_rn(acc[r], leaf_term(k[r], ~next));
        }
        ++k[r];
        ref[r] = 0;
      }
      if (!busy) break;
    }

    if (!kLeaf && t0 + tc == a.T) {
      float* out = static_cast<float*>(a.out);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int rl = tid + r * kThreads;
        if (rl < rows_here) out[(row0 + rl) * a.C + c] = acc[r];
      }
    }
    __syncthreads();  // stage j & 1 and the leaf ids are free again
    if (kLeaf) {
      int* out = static_cast<int*>(a.out);
      for (int i = tid; i < tc * kTile; i += kThreads) {
        const int kk = i / kTile, rl = i - kk * kTile;
        if (rl < rows_here) out[((long long)(t0 + kk) * a.C + c) * a.n + row0 + rl] = lid[i];
      }
    }
  }
}

int row_stride_bytes(int d, int esz) {
  int w = (d * esz + 3) / 4;
  if (w % 2 == 0) w += 1;  // odd words: 32 rows at one feature hit 32 banks
  return w * 4;
}

template <typename BinT, bool kLeaf, bool kNarrow>
cudaError_t launch(Args a, cudaStream_t stream) {
  a.row_stride = row_stride_bytes(a.d, (int)sizeof(BinT));
  const long long row_bytes = (long long)kTile * a.row_stride;
  const bool stage_rows = row_bytes <= kMaxRowBytes;
  const int rows_b = stage_rows ? (int)row_bytes : 0;
  // as many blocks an SM as leave at least half of each one's share to trees
  int per_sm = kBlocksPerSm;
  while (per_sm > 1 && 2 * rows_b > smem_budget(per_sm)) --per_sm;
  const int budget = smem_budget(per_sm);
  const int lid_b = kLeaf ? kTile * 4 : 0;  // per tree of a pass
  auto smem_for = [&](int chunk, bool ring) {
    return (ring ? 2 * 4 * stage_words(a.units, chunk, a.L, kLeaf) : 0) + chunk * lid_b + rows_b;
  };
  bool ring = smem_for(1, true) <= budget;
  int chunk = 1;
  if (ring || kLeaf) {
    while (chunk < a.T && smem_for(chunk + 1, ring) <= budget) ++chunk;
  } else {
    chunk = a.T;
  }
  a.chunk = chunk;
  const int smem = smem_for(chunk, ring);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;

  void (*kern)(Args);
  if (stage_rows) {
    kern = ring ? tree_kernel<BinT, kLeaf, true, true, kNarrow>
                : tree_kernel<BinT, kLeaf, true, false, kNarrow>;
  } else {
    kern = ring ? tree_kernel<BinT, kLeaf, false, true, kNarrow>
                : tree_kernel<BinT, kLeaf, false, false, kNarrow>;
  }
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (a.n + kTile - 1) / kTile;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kLeaf, bool kNarrow>
int launch_bins(Args a, int bin_bytes, cudaStream_t s) {
  switch (bin_bytes) {
    case 1: return (int)launch<int8_t, kLeaf, kNarrow>(a, s);
    case 2: return (int)launch<int16_t, kLeaf, kNarrow>(a, s);
    case 4: return (int)launch<int32_t, kLeaf, kNarrow>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kLeaf>
int dispatch(Args a, int bin_bytes, int narrow, void* stream) {
  if (a.n <= 0 || a.T <= 0 || a.C <= 0 || a.units <= 0 || a.L < 1 || a.d < 0 ||
      a.cat_bins < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return narrow ? launch_bins<kLeaf, true>(a, bin_bytes, s)
                : launch_bins<kLeaf, false>(a, bin_bytes, s);
}

Args make_args(const void* bins, long long n, int d, const void* nodes, int units, int T,
               int C, int S, int cat_bins, void* out) {
  Args a{};
  a.bins = bins;
  a.n = n;
  a.d = d;
  a.nodes = static_cast<const int4*>(nodes);
  a.units = units;
  a.T = T;
  a.C = C;
  a.L = S + 1;
  a.cat_bins = cat_bins;
  a.out = out;
  return a;
}

}  // namespace

// (n, C) f32 sum over trees, in tree order per class, of scale_t * leaf_value
extern "C" int smt_tree_score(const void* bins, int bin_bytes, long long n, int d,
                              const void* nodes, int units, int narrow,
                              const void* leaf_value, const void* scale, int T, int C, int S,
                              int cat_bins, void* out, void* stream) {
  Args a = make_args(bins, n, d, nodes, units, T, C, S, cat_bins, out);
  a.leaf_value = static_cast<const float*>(leaf_value);
  a.scale = static_cast<const float*>(scale);
  return dispatch<false>(a, bin_bytes, narrow, stream);
}

// (T, C, n) int32 leaf id of every row in every tree
extern "C" int smt_tree_leaf(const void* bins, int bin_bytes, long long n, int d,
                             const void* nodes, int units, int narrow, int T, int C, int S,
                             int cat_bins, void* out, void* stream) {
  Args a = make_args(bins, n, d, nodes, units, T, C, S, cat_bins, out);
  return dispatch<true>(a, bin_bytes, narrow, stream);
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
