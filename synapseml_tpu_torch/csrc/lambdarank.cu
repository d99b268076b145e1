// Kernel F: the LambdaRank gradient and hessian of every row.
//
// Replaces: synapseml_tpu/gbdt/boost.py::_lambda_grads (:170-211), with the
// group tables of ::_group_tables (:156), which XLA computes as dense
// (Q, G, G) tensors over queries padded to the largest one (G). At
// MSLR-WEB30K's training shape (18,919 queries, G = 1,251) one such f32
// tensor is about 118 GB; here a query's pairs never leave the SM.
//
// Rows are contiguous by query (a block reads its query's {id, first row,
// size}). Over query q's m documents, with its scores s, labels l and gains
// gain = 2^l - 1 (computed once a fit, as is the query's truncated ideal DCG
// max_dcg, floored at 1e-12: both depend on the labels only):
//   rank_i = the place of i in the stable descending order of s (ties in
//            index order; -0.0 ties +0.0; NaN after every other score, in
//            index order: torch.argsort(-s, stable=True) of the query);
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
// them, and each of a document's two sums over j runs in j order; the
// exponential is exp_f32 below, the plain version's exp_f32 op for op
// (CUDA's expf and the CPU's differ in the last place). A pair's lam and hp
// are the same bits from either side (rho from the winner's side, delta
// symmetric), so one evaluation can feed both documents' sums. So the
// kernel gives the plain version's bits, on the card and on the CPU.
//
// Design: one block of kThreads a query, blocks in descending query size
// (the largest queries start first, so none is the launch's tail). With
// T = min(truncation, m) the top documents:
// 1. ranks by a bitonic sort of 64-bit keys (score made an ordered integer,
//    descending, then the index): steps over distances under 32 in
//    registers (warp shuffles), the wider ones in shared memory; a query
//    over kSmemDocs documents sorts in a global scratch (L2-resident);
// 2. T <= kTopMax (the main loop): every counted pair is evaluated once,
//    from its top side, and no pair of two documents ranked >= T is visited.
//    A table holds a row a top document (by rank): kCols columns of a chunk
//    of the documents below T (in index order), then the T x T top pairs.
//    All threads fill it, one cell at a time (one exp_f32 a counted cell;
//    the top pairs with the first chunk). Then a column's thread sums its
//    column over the top documents in index order (a document below T pairs
//    only with them: its whole sum lives in its chunk), while one warp of
//    walkers, a lane a top document, walks the chunk in j order: its columns
//    and the top pairs of the top documents between them, from a list the
//    fill writes, carrying the sums in registers across chunks;
// 3. T > kTopMax (a truncation past the tables, e.g. past the largest
//    query: every document is top): the same launch's second loop, the
//    first version's schedule. Each thread owns documents i and walks every
//    j, evaluating each counted pair from both sides (same bits).
//
// Bound on the H100: the larger of the rows' bytes (score, label, weight,
// gain read once, g and h written once: n * 16) at the memory rate and one
// exponential a counted pair at the SFU rate. The main loop issues about 75
// instructions a cell (exp_f32 is ~25 FMA-pipe operations where the SFU
// would take one; two IEEE divisions) over T(T-1)/2 + T(m - T) cells a
// query; cells of one label are visited but not evaluated (their lanes
// idle). At MSLR's shape on an H100 a block's cycles go 43 % to the fills,
// 31 % to the sort (with the loads of its keys), 16 % to the loads that
// start the main loop and 10 % to the sums (tools/lambdarank_phases.py): a
// block's phases are short chains separated by barriers, so latency, hidden
// only by the other blocks on the SM, bounds it. Left: the SFU exponential
// (it needs the CPU to emulate ex2.approx), one block a query (a
// 20,000-document query holds one SM), and the lanes that idle on cells of
// one label.
//
// Shared memory a block reserves: 2 * min(G, kSmemDocs) bytes of ranks, a
// region that holds in turn the sort keys (8 * the next power of two over
// min(G, kSmemDocs), at least 32), the table (lam and hp: 8 * T_L * row
// bytes, T_L = min(truncation, G, kTopMax), row = (kCols + T_L) | 1) and, where the
// second loop can run, 16-byte records of min(G, kSmemDocs) documents, plus
// 3,712 bytes of static arrays. At MSLR's shape (G = 1,251, truncation 30):
// 2,502 + 30,480 + 3,712 = 36,694 bytes: six blocks an SM, as the 40
// registers a thread of __launch_bounds__(kThreads, 6) allow.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemDocs = 2048;  // larger queries keep their keys and ranks in the scratch
constexpr int kTopMax = 32;      // largest T the tables take
constexpr int kCols = 96;        // columns of a chunk
static_assert(kThreads >= kCols + kTopMax, "the walkers' warp follows the column threads");

typedef unsigned long long u64;

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
  const int4* blocks;    // (Q,) {query, first row, size, 0}, the largest queries first
  const float* max_dcg;  // (Q,)
  const float* disc;     // (G,) 1 / log2(2 + r)
  u64* keys;             // scratch (2n,) keys, then (n,) float4 records; or null
  int* rank;             // scratch (n,) ranks; or null
  float* g;              // (n,)
  float* h;              // (n,)
  int truncation;
  int rank_off;          // byte offset of the ranks in shared memory
  int row;               // a table row's floats: kCols + T_L, made odd
  float sigma, sigma2;
};

// the pair's lam and hp, rho from the winner's side: the same bits whichever
// of its documents asks
__device__ __forceinline__ void pair_terms(float s_win, float s_lose, float gain_a, float gain_b,
                                           float disc_a, float disc_b, float max_dcg,
                                           const Args& a, float& lam, float& hp) {
  const float sd = __fsub_rn(s_win, s_lose);
  const float rho = __frcp_rn(__fadd_rn(1.f, exp_f32(__fmul_rn(a.sigma, sd))));  // = 1 / x
  const float delta = __fdiv_rn(
      __fmul_rn(fabsf(__fsub_rn(gain_a, gain_b)), fabsf(__fsub_rn(disc_a, disc_b))), max_dcg);
  lam = __fmul_rn(__fmul_rn(a.sigma, rho), delta);
  hp = __fmul_rn(__fmul_rn(__fmul_rn(a.sigma2, rho), __fsub_rn(1.f, rho)), delta);
}

// -a + b and max(ha + hb, 1e-12), times the row's weight, as the plain version
__device__ __forceinline__ void write_row(const Args& a, int row, float ga, float gb, float ha,
                                          float hb) {
  const float g = __fadd_rn(-ga, gb);
  float h = __fadd_rn(ha, hb);
  h = h < 1e-12f ? 1e-12f : h;
  const float w = a.weight[row];
  a.g[row] = __fmul_rn(g, w);
  a.h[row] = __fmul_rn(h, w);
}

// ascending in the key = descending in the score, then ascending in the index
__device__ __forceinline__ u64 sort_key(float s, int i) {
  unsigned d;
  if (s != s) {
    d = 0xffffffffu;  // NaN: after -inf
  } else {
    const unsigned u = s == 0.f ? 0u : __float_as_uint(s);  // -0.0 ties +0.0
    d = (u & 0x80000000u) ? u : ~(u | 0x80000000u);
  }
  return ((u64)d << 32) | (unsigned)i;
}

// one compare-exchange step of a bitonic sort between the key at position i
// (this lane's) and the one at i ^ j (lane ^ j, j < 32), in registers
__device__ __forceinline__ u64 warp_step(u64 x, int i, int j, int k) {
  const u64 y = __shfl_xor_sync(0xffffffffu, x, j);
  const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
  return keep_min == (x < y) ? x : y;
}

// bitonic sort of keys[0, P), P a power of two >= 32, by the whole block:
// steps over distances under 32 run in registers, one key a lane (all the
// stages up to 32 at once, then the tail of each later stage); only the
// wider steps go through memory, each followed by a barrier
__device__ __forceinline__ void bitonic_sort(u64* keys, int P) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int seg = threadIdx.x >> 5; seg * 32 < P; seg += warps) {
    const int i = seg * 32 + lane;
    u64 x = keys[i];
    for (int k = 2; k <= 32; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) x = warp_step(x, i, j, k);
    keys[i] = x;
  }
  __syncthreads();
  for (int k = 64; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int p = threadIdx.x; p < (P >> 1); p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));  // bit j clear
        const u64 x = keys[i], y = keys[i + j];
        if ((x > y) == ((i & k) == 0)) {
          keys[i] = y;
          keys[i + j] = x;
        }
      }
      __syncthreads();
    }
    for (int seg = threadIdx.x >> 5; seg * 32 < P; seg += warps) {
      const int i = seg * 32 + lane;
      u64 x = keys[i];
      for (int j = 16; j > 0; j >>= 1) x = warp_step(x, i, j, k);
      keys[i] = x;
    }
    __syncthreads();
  }
}

// the second loop (T > kTopMax): records {score, label, gain, +-disc} (the
// sign carries rank < truncation), each thread owning documents i and
// evaluating each counted pair from its own side
template <typename RankT>
__device__ __forceinline__ void two_sided(float4* docs, const RankT* rank, int m, int start,
                                          float max_dcg, const Args& a) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int r = rank[i];
    const float d = a.disc[r];
    docs[i] = make_float4(a.score[start + i], a.label[start + i], a.gain[start + i],
                          r < a.truncation ? d : -d);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float4 di = docs[i];
    const bool top_i = di.w > 0.f;
    const float disc_i = fabsf(di.w);
    float ga = 0.f, gb = 0.f, ha = 0.f, hb = 0.f;
    for (int j = 0; j < m; ++j) {
      const float4 dj = docs[j];
      const bool win = di.y > dj.y, lose = dj.y > di.y;
      if (!(win | lose) || !(top_i | (dj.w > 0.f))) continue;
      float lam, hp;
      pair_terms(win ? di.x : dj.x, win ? dj.x : di.x, di.z, dj.z, disc_i, fabsf(dj.w),
                 max_dcg, a, lam, hp);
      if (win) {
        ga = __fadd_rn(ga, lam);
        ha = __fadd_rn(ha, hp);
      } else {
        gb = __fadd_rn(gb, lam);
        hb = __fadd_rn(hb, hp);
      }
    }
    write_row(a, start + i, ga, gb, ha, hb);
  }
}

__shared__ int s_top_doc[kTopMax];     // the top documents, in rank order
__shared__ float4 s_top[kTopMax];      // {score, label, gain, disc} by rank
__shared__ int4 s_top_index[kTopMax];  // {rank, label bits, index, index - place} of the top
                                       // documents, in index order
__shared__ float4 s_col[kCols];        // the chunk's columns: {score, label, gain, disc}
__shared__ int2 s_walk[kCols + kTopMax];  // the chunk's walk: {table column, label bits}

// the document of column k: the k-th document below T in index order, k
// plus the top documents i whose index less their place is at most k
__device__ __forceinline__ int column_doc(int k, int T) {
  int c = 0;
  for (int i = 0; i < T; ++i) c += s_top_index[i].w <= k;
  return k + c;
}

// acc += the term of a counted pair where `win` or `lose` holds: the adds
// of a sum in j order, with the loads of later terms free to run ahead
__device__ __forceinline__ void add_term(bool win, bool lose, float lam, float hp, float& ga,
                                         float& gb, float& ha, float& hb) {
  ga = win ? __fadd_rn(ga, lam) : ga;
  ha = win ? __fadd_rn(ha, hp) : ha;
  gb = lose ? __fadd_rn(gb, lam) : gb;
  hb = lose ? __fadd_rn(hb, hp) : hb;
}

// the main loop (T <= kTopMax). The table in the shared region `tab` has a
// row a top document, by rank, of a.row columns: the chunk's kCols columns,
// then the T x T pairs (column kCols + rank); an odd row length keeps a
// column's reads by rank free of bank conflicts
template <typename RankT>
__device__ __forceinline__ void top_pairs(float* tab, const RankT* rank, int m, int T, int start,
                                          float max_dcg, const Args& a) {
  const int tid = threadIdx.x, kRow = a.row;
  float* lam_c = tab;
  float* hp_c = lam_c + T * kRow;
  if (tid < T) {
    const int d = s_top_doc[tid];
    const float l = a.label[start + d];
    s_top[tid] = make_float4(a.score[start + d], l, a.gain[start + d], a.disc[tid]);
    int pos = 0;
    for (int r = 0; r < T; ++r) pos += s_top_doc[r] < d;
    s_top_index[pos] = make_int4(tid, __float_as_int(l), d, d - pos);
  }
  __syncthreads();
  // column k of the chunks is the k-th document below T in index order;
  // thread c < kCols loads column c of each chunk a chunk ahead (the
  // document's index and label stay in its registers for the column's sums)
  const int below = m - T;
  int j = 0;
  float lj = 0.f;
  auto load_column = [&](int k) {
    if (tid < kCols && k < below) {
      j = column_doc(k, T);
      lj = a.label[start + j];
      s_col[tid] = make_float4(a.score[start + j], lj, a.gain[start + j], a.disc[rank[j]]);
    }
  };
  load_column(tid);
  // the walkers: the warp after the column threads, top rank r on lane r
  const int walker = tid >= kCols && tid - kCols < T ? tid - kCols : -1;
  const float l_walk = walker >= 0 ? s_top[walker].y : 0.f;
  const float* lam_r = lam_c + (walker >= 0 ? walker : 0) * kRow;
  const float* hp_r = hp_c + (walker >= 0 ? walker : 0) * kRow;
  float ga = 0.f, gb = 0.f, ha = 0.f, hb = 0.f;
  int w0 = 0;  // the walk so far covers the documents before w0
  __syncthreads();
  for (int k0 = 0;; k0 += kCols) {  // at least once: a query of top documents only walks
    const int ncol = min(kCols, below - k0);
    int w1 = m;  // column_doc(k0 + ncol) unless this is the last chunk, by a ballot
    {
      const int lane = tid & 31, k = k0 + ncol;
      const unsigned le =
          __ballot_sync(0xffffffffu, lane < T && s_top_index[lane < T ? lane : 0].w <= k);
      if (k < below) w1 = k + __popc(le);
    }
    // fill, one cell a thread in turn: the T(T-1)/2 top pairs x < y (p =
    // y(y-1)/2 + x, first chunk only), then the chunk's T x ncol cells
    const int n_top = k0 == 0 ? T * (T - 1) / 2 : 0;
    const float inv_ncol = ncol > 0 ? 1.f / ncol : 0.f;
    for (int id = tid; id < n_top + T * ncol; id += kThreads) {
      int x, y;
      float4 tx, ty;
      if (id < n_top) {
        y = (int)((1.f + sqrtf(8.f * id + 1.f)) * 0.5f);
        while (y * (y - 1) / 2 > id) --y;
        while ((y + 1) * y / 2 <= id) ++y;
        x = id - y * (y - 1) / 2;
        tx = s_top[x];
        ty = s_top[y];
      } else {  // (id - n_top + 0.5) / ncol is within 2^-11 of its value: exact floor
        const int c = id - n_top;
        x = (int)(((float)c + 0.5f) * inv_ncol);
        y = c - x * ncol;
        tx = s_top[x];
        ty = s_col[y];
      }
      const bool xw = tx.y > ty.y;
      if (!(xw | (ty.y > tx.y))) continue;
      float lam, hp;
      pair_terms(xw ? tx.x : ty.x, xw ? ty.x : tx.x, tx.z, ty.z, tx.w, ty.w, max_dcg, a, lam,
                 hp);
      if (id < n_top) {
        lam_c[x * kRow + kCols + y] = lam;
        lam_c[y * kRow + kCols + x] = lam;
        hp_c[x * kRow + kCols + y] = hp;
        hp_c[y * kRow + kCols + x] = hp;
      } else {
        lam_c[x * kRow + y] = lam;
        hp_c[x * kRow + y] = hp;
      }
    }
    // the walk of this chunk: documents w0..w1 in j order, its columns and
    // the top documents between them
    if (tid < ncol) s_walk[j - w0] = make_int2(tid, __float_as_int(lj));
    if (tid < T) {
      const int4 e = s_top_index[tid];
      if (e.z >= w0 && e.z < w1) s_walk[e.z - w0] = make_int2(kCols + e.x, e.y);
    }
    __syncthreads();
    // the sums read every cell and keep the counted ones (no branches: the
    // loads run ahead of the adds)
    if (tid < ncol) {  // a column: its sums over the top documents, in index order
      float ca = 0.f, cb = 0.f, cha = 0.f, chb = 0.f;
#pragma unroll 8
      for (int k = 0; k < T; ++k) {
        const int4 e = s_top_index[k];
        const float lt = __int_as_float(e.y);
        add_term(lj > lt, lt > lj, lam_c[e.x * kRow + tid], hp_c[e.x * kRow + tid], ca, cb,
                 cha, chb);
      }
      write_row(a, start + j, ca, cb, cha, chb);
    } else if (walker >= 0) {  // a top document: the chunk's walk, in j order
      const int n = w1 - w0;
      int e = 0;
      for (; e + 8 <= n; e += 8) {
        int2 c[8];
        float lam[8], hp[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) c[u] = s_walk[e + u];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          lam[u] = lam_r[c[u].x];
          hp[u] = hp_r[c[u].x];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float lc = __int_as_float(c[u].y);
          add_term(l_walk > lc, lc > l_walk, lam[u], hp[u], ga, gb, ha, hb);
        }
      }
      for (; e < n; ++e) {
        const int2 c = s_walk[e];
        const float lc = __int_as_float(c.y);
        add_term(l_walk > lc, lc > l_walk, lam_r[c.x], hp_r[c.x], ga, gb, ha, hb);
      }
    }
    w0 = w1;
    if (k0 + kCols >= below) break;
    load_column(k0 + kCols + tid);  // the next chunk's, while the sums finish
    __syncthreads();
  }
  if (walker >= 0) write_row(a, start + s_top_doc[walker], ga, gb, ha, hb);
}

// one query: keys and ranks in shared memory (kShared: up to kSmemDocs
// documents) or in the global scratch; a template, so that each loop's
// loads take their own address space
template <bool kShared>
__device__ __forceinline__ void run_query(unsigned char* smem, int q, int start, int m,
                                          const Args& a) {
  typedef typename std::conditional<kShared, unsigned short, int>::type RankT;
  u64* keys = kShared ? reinterpret_cast<u64*>(smem) : a.keys + 2 * (size_t)start;
  RankT* rank = kShared ? reinterpret_cast<RankT*>(smem + a.rank_off)
                        : reinterpret_cast<RankT*>(a.rank + start);
  int P = 32;
  while (P < m) P <<= 1;
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    keys[i] = i < m ? sort_key(a.score[start + i], i) : ~0ull;
  __syncthreads();
  bitonic_sort(keys, P);
  const int T = min(max(a.truncation, 0), m);
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const int i = (int)(unsigned)keys[r];
    rank[i] = r;
    if (r < T && T <= kTopMax) s_top_doc[r] = i;
  }
  __syncthreads();  // the keys are dead: their region takes the tables or the records
  const float max_dcg = a.max_dcg[q];
  if (T > kTopMax) {
    float4* docs = kShared ? reinterpret_cast<float4*>(smem)
                           : reinterpret_cast<float4*>(a.keys) + start;
    two_sided(docs, rank, m, start, max_dcg, a);
  } else {
    top_pairs(reinterpret_cast<float*>(smem), rank, m, T, start, max_dcg, a);
  }
}

__global__ void __launch_bounds__(kThreads, 6) lambdarank_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int4 b = a.blocks[blockIdx.x];
  const int q = b.x, start = b.y, m = b.z;
  if (m <= 0) return;
  if (m <= kSmemDocs)
    run_query<true>(smem, q, start, m, a);
  else
    run_query<false>(smem, q, start, m, a);
}

}  // namespace

// scratch: null when G <= kSmemDocs, else 20 * n bytes (16-byte aligned):
// the keys or records of the large queries, then their ranks
extern "C" int smt_lambdarank(const void* score, const void* label, const void* gain,
                              const void* weight, const void* blocks,
                              const void* max_dcg, const void* disc, int n, int Q, int G,
                              int truncation, float sigma, float sigma2, void* scratch, void* g,
                              void* h, void* stream) {
  if (Q <= 0) return 0;
  if (G > kSmemDocs && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int docs = G < kSmemDocs ? (G > 0 ? G : 1) : kSmemDocs;
  int pow2 = 32;  // the sort takes at least one warp's keys
  while (pow2 < docs) pow2 <<= 1;
  const int t_rows = truncation < 0 ? 0 : (truncation < G ? truncation : G);
  const int t_tab = t_rows < kTopMax ? t_rows : kTopMax;
  size_t region = (size_t)pow2 * sizeof(u64);
  const int row = (kCols + t_tab) | 1;
  const size_t tables = sizeof(float) * 2 * (size_t)t_tab * row;
  if (tables > region) region = tables;
  if (t_rows > kTopMax && docs * sizeof(float4) > region) region = docs * sizeof(float4);
  region = (region + 15) & ~(size_t)15;
  const size_t smem = region + (size_t)docs * sizeof(unsigned short);
  // past 48 KB with the static arrays, a launch needs the limit raised
  const cudaError_t err = cudaFuncSetAttribute(
      lambdarank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Args a{(const float*)score,  (const float*)label,   (const float*)gain,
         (const float*)weight, (const int4*)blocks,
         (const float*)max_dcg, (const float*)disc,   (u64*)scratch,
         scratch ? (int*)((char*)scratch + 16 * (size_t)n) : nullptr,
         (float*)g,            (float*)h,             truncation,
         (int)region,          row,                   sigma,
         sigma2};
  lambdarank_kernel<<<(unsigned)Q, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
