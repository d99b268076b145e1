// Kernel C: flash attention forward.
//
// Replaces: synapseml_tpu/parallel/flash.py::_flash_bh_impl (flash.py:193,
// the Pallas kernel launched by pl.pallas_call at flash.py:272). Forward-only
// blockwise attention with an online softmax: scores q.k^T / sqrt(D), the
// causal diagonal aligned to the END of the keys (diag_off = S_k - S_q),
// masked scores a finite -1e30, key tiles wholly above the diagonal skipped,
// running max m and denominator l in f32, an f32 accumulator, P cast to the
// input dtype before P.V, output acc / max(l, 1e-30) in the input dtype. GQA:
// query head h reads K/V head h / (H / H_kv); K/V are never expanded. The
// *_lse entries also write each query row's log-sum-exp (natural log, of
// the scaled scores over the keys the row sees) to an f32 (B, H, S_q) array:
// one store a row in the epilogue, which is what ring attention merges
// blocks by (parallel/ring.py).
//
// Layout: q/o (B, S_q, H, D), k/v (B, S_k, H_kv, D), read strided in place
// (a row of D values is contiguous; rows of one head are H*D apart), so the
// caller needs no transposes.
//
// Bound on the H100: operations for long sequences. 4*B*H*S_q*S_k*D flops
// (about half of that causal) on the tensor cores, against q, k, v, o read or
// written once at 3.35 TB/s. Beside the products, every score takes one ex2
// on the SFU (16 a clock per SM): at D = 64 the two floors meet, and at D =
// 16 and 32 the exponentials, not the tensor cores, set the floor.
//
// Two kernels, chosen by dtype (never on a failure):
//
// bf16, D = 16, 32, 64, 128: flash_wgmma_kernel, warp-specialised. A CTA of
// three warpgroups covers 128 query rows of one (b, h): warpgroup 0 is the
// producer (it gives its registers to the others with setmaxnreg; one thread
// issues every TMA load), warpgroups 1 and 2 are consumers of 64 rows each.
// TMA loads the Q tile once and BK-key tiles of K and V into a ring of
// shared-memory stages, through 4-D tensor maps over (B, S, H, D) with the
// real strides. A tile is stored as parts of [rows x min(D, 64)] bf16 whose
// row width (32, 64 or 128 bytes) picks TMA's swizzle and the matching wgmma
// descriptor layout. Each stage has a full barrier for K, one for V, and an
// empty barrier the eight consumer warps arrive on when done with it. TMA
// zero-fills rows past S_q and S_k. S = Q.K^T is wgmma m64nBKk16 with Q and
// K from shared memory (K-major); its f32 accumulator becomes, in registers,
// the bf16 A operand of O += P.V, wgmma m64n{D or 64}k16 with V from shared
// memory as an MN-major B (V's tile is D-contiguous). The softmax takes one
// ex2 per score with scale*log2(e) folded into one FMA, masks only tiles that
// cross the diagonal or the ragged end, and keeps m and the per-thread part
// of l in registers. With OVERLAP, a consumer issues tile j's Q.K^T and tile
// j-1's P.V together and runs tile j's softmax while P.V is in flight, so the
// SFU and the tensor cores overlap inside one warpgroup (one S buffer: the
// new P is packed only after P.V has read the old one). The key tile is 256
// at D = 16 and 32, where O takes only 8 or 16 registers a thread, halving
// the barrier and ring work per score, and 128 above; the overlap pays at
// D = 16 only (wgmma_key_tile, wgmma_overlap). Causal query tiles
// are launched heaviest first (grid y reversed, all heads of a tile side by
// side). Not done: a persistent grid, a TMA store of O.
//
// f32, D = 16, 32, 64, 128: flash_f32_kernel, on the tensor cores in 3xTF32.
// Each operand x is split into hi = tf32(x) and lo = tf32(x - hi) (rounded
// as cvt.rna.tf32.f32 rounds), and each product is hi.hi + (lo.hi + hi.lo)
// (mma.sync.m16n8k8.tf32), for Q.K^T and for P.V, with P split in registers:
// about f32 accuracy at a third of the TF32 rate. The tensor cores round
// their f32 sums toward zero, so hi.hi is summed apart from the two small
// terms, and each key tile's P.V is summed from zero and added to O with one
// rounded FMA: the bias then never builds up over the whole key loop (it
// took the error from 1.1e-5 to 2e-6 at S = 8192). A CTA of 4 warps holds 64
// query rows (16 a warp, Q in registers); K/V tiles of 64 keys (32 at D =
// 128) pass through a double-buffered cp.async ring, rows padded so the
// B-fragment loads hit distinct banks. The k index inside each 8-wide mma
// step is permuted (slot t <-> 2t, slot t+4 <-> 2t+1) so that the S
// accumulator already is P.V's A fragment and Q and K fragments load as
// float2. The same online softmax as the bf16 kernel.
//
// TMA descriptors are encoded on the host with cuTensorMapEncodeTiled, which
// is reached through cudaGetDriverEntryPoint, so the library does not link
// against libcuda (csrc/hopper.cuh, shared with kernel Q).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, Hkv, D;
  int causal;
  float* lse;  // (B, H, Sq) f32, or null: each row's log-sum-exp
};

// The natural log-sum-exp of one query row's scaled scores over the keys it
// sees, from the kernel's running max m (a raw score) and sum l of
// 2^((s - m) * cl2): m * cl2 * ln 2 + ln l. A row always sees a key (the
// causal diagonal, S_k >= 1), so l >= 1.
__device__ __forceinline__ void store_lse(float* lse, long long row_base, int row0, int Sq,
                                          const float (&m)[2], const float (&l)[2],
                                          float cl2) {
  if (row0 < Sq) lse[row_base + row0] = fmaf(m[0], cl2 * kLn2, logf(l[0]));
  if (row0 + 8 < Sq) lse[row_base + row0 + 8] = fmaf(m[1], cl2 * kLn2, logf(l[1]));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Pin registers at this point of the program, so the compiler neither reads
// an accumulator before a wgmma wait nor reuses an operand's registers while
// the wgmma that reads them is in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) fence_regs(r[i]);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Online-softmax step for the two rows a thread holds (mma / wgmma
// accumulator layout: register i is row i/2 % 2, column 8*(i/4) + 2t + i%2).
// Masks when asked, turns s into p = 2^(s*cl2 - m*cl2), updates m and the
// thread's part of l, and returns the factor the accumulator is rescaled by.
template <int N>
__device__ __forceinline__ void softmax_step(float (&s)[N], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool need_mask, int k0, int t,
                                             const int (&qpos)[2], int Sk, bool causal,
                                             float cl2) {
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int kpos = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      if (kpos >= Sk || (causal && kpos > qpos[(i >> 1) & 1])) s[i] = kNeg;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float msc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    msc[r] = mx[r] * cl2;
    corr[r] = ex2(fmaf(m[r], cl2, -msc[r]));
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float p = ex2(fmaf(s[i], cl2, -msc[(i >> 1) & 1]));
    s[i] = p;
    l[(i >> 1) & 1] += p;
  }
}

// ------------------------------------------------------------ f32, 3xTF32 ----

constexpr int kFWarps = 4;             // warps per CTA, 16 query rows each
constexpr int kFBQ = 16 * kFWarps;     // query rows per CTA

template <int D>
struct FLayout {
  static constexpr int BK = D == 128 ? 32 : 64;  // keys per tile
  static constexpr int LK = D + 8;   // K row stride (floats): float2 loads of a half-warp
                                     // cover 8 rows x 8 words on distinct banks
  static constexpr int LV = D + 4;   // V row stride: rows 2t, 2t+1 and column g on
                                     // distinct banks
  static constexpr int kStage = BK * (LK + LV);            // floats per stage
  static constexpr int kSmem = 2 * kStage * 4;             // bytes, two stages
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Round to tf32: 10 mantissa bits, nearest, ties away from zero, the low 13
// bits cleared. Two integer operations on the bits give what cvt.rna.tf32.f32
// gives for every finite value, at the full integer rate.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 22 bits: hi = tf32(x), lo = tf32(x - hi) (the
// difference is exact in f32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a.b in 3xTF32 into two accumulators: big += hi.hi, small += lo.hi + hi.lo.
// The tensor cores round each accumulation toward zero; keeping the large
// term apart bounds that bias to one add per k-step of the large sum, and
// the two chains run side by side. b is given as two f32 values.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(big, ah, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
}

// Copy key rows [k0, k0 + BK) of K and V into one stage; rows past S_k are
// zero-filled (source size 0).
template <int D>
__device__ __forceinline__ void f32_load_tile(uint32_t ks, uint32_t vs, const float* kg,
                                              const float* vg, long long stride, int k0,
                                              int Sk) {
  using L = FLayout<D>;
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < L::BK * kChunks; i += kFWarps * 32) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = k0 + r < Sk;
    const long long off = (long long)(ok ? k0 + r : 0) * stride + c;
    cp_async16(ks + (r * L::LK + c) * 4, kg + off, ok);
    cp_async16(vs + (r * L::LV + c) * 4, vg + off, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kFWarps * 32)
flash_f32_kernel(Args a, int n_qblocks) {
  using L = FLayout<D>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(16) float fsm[];
  const uint32_t sbase = smem_u32(fsm);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int qb = a.causal ? n_qblocks - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qb * kFBQ;
  const int diag = a.Sk - a.Sq;
  const float cl2 = kLog2e / sqrtf((float)D);
  const long long qstride = (long long)a.H * D;
  const long long kstride = (long long)a.Hkv * D;
  const float* kg = (const float*)a.k + (long long)b * a.Sk * kstride + (long long)hk * D;
  const float* vg = (const float*)a.v + (long long)b * a.Sk * kstride + (long long)hk * D;

  int n_tiles = (a.Sk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + kFBQ, a.Sq) - 1 + diag) / BK + 1);
  f32_load_tile<D>(sbase, sbase + BK * L::LK * 4, kg, vg, kstride, 0, a.Sk);
  cp_async_commit();

  // Q as the A operand. With the permuted k index, k-step kc holds
  // Q[r][8kc+2t], Q[r+8][8kc+2t], Q[r][8kc+2t+1], Q[r+8][8kc+2t+1] for r =
  // row0. Up to D = 64 it is split once, here; at D = 128 its halves would
  // not fit in registers beside O, so the raw values are split per tile.
  constexpr bool kSplitOnce = D <= 64;
  const int row0 = q0 + 16 * warp + g;
  const int qpos[2] = {row0 + diag, row0 + 8 + diag};
  float qf[D / 8][4];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    const float* qr = (const float*)a.q + ((long long)b * a.Sq + min(row, a.Sq - 1)) * qstride +
                      (long long)h * D;
#pragma unroll
    for (int kc = 0; kc < D / 8; ++kc) {
      float2 x = make_float2(0.f, 0.f);
      if (row < a.Sq) x = *reinterpret_cast<const float2*>(qr + 8 * kc + 2 * t);
      qf[kc][rr] = x.x;
      qf[kc][2 + rr] = x.y;
    }
  }
  uint32_t qh[kSplitOnce ? D / 8 : 1][4], ql[kSplitOnce ? D / 8 : 1][4];
  if (kSplitOnce) {
#pragma unroll
    for (int kc = 0; kc < (kSplitOnce ? D / 8 : 1); ++kc)
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(qf[kc][i], qh[kc][i], ql[kc][i]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < n_tiles) {
      const uint32_t nxt = sbase + ((j + 1) & 1) * L::kStage * 4;
      f32_load_tile<D>(nxt, nxt + BK * L::LK * 4, kg, vg, kstride, k0 + BK, a.Sk);
    }
    cp_async_commit();
    cp_async_wait_1();  // tile j has landed
    __syncthreads();
    const float* Ks = fsm + (j & 1) * L::kStage;
    const float* Vs = Ks + BK * L::LK;

    // S = Q.K^T (16 rows x BK keys per warp); B = K[key g][8kc+2t, +1]
    float s[BK / 8][4], s_lo[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = s_lo[nt][i] = 0.f;
    if (!kSplitOnce) fence_regs(qf);  // split per tile, not hoisted out of the loop
#pragma unroll
    for (int kc = 0; kc < D / 8; ++kc) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kSplitOnce) {
          ah[i] = qh[kSplitOnce ? kc : 0][i];
          al[i] = ql[kSplitOnce ? kc : 0][i];
        } else {
          split_tf32(qf[kc][i], ah[i], al[i]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const float2 kv =
            *reinterpret_cast<const float2*>(Ks + (nt * 8 + g) * L::LK + 8 * kc + 2 * t);
        mma_3xtf32(s[nt], s_lo[nt], ah, al, kv.x, kv.y);
      }
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] += s_lo[nt][i];

    float corr[2];
    softmax_step(reinterpret_cast<float(&)[BK / 2]>(s), m, l, corr,
                 k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > q0 + diag), k0, t, qpos, a.Sk,
                 a.causal, cl2);

    // O = O * corr + P.V, the tile's P.V summed on the tensor cores from zero
    // and added with one rounded FMA. The S accumulator of keys 8kk.. is the
    // A fragment (rows g, g+8; slots t, t+4 = keys 2t, 2t+1);
    // B = V[key 8kk+2t, +1][8dn+g].
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      split_tf32(s[kk][0], ph[kk][0], pl[kk][0]);
      split_tf32(s[kk][2], ph[kk][1], pl[kk][1]);
      split_tf32(s[kk][1], ph[kk][2], pl[kk][2]);
      split_tf32(s[kk][3], ph[kk][3], pl[kk][3]);
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f}, pv_lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const float* vr = Vs + (kk * 8 + 2 * t) * L::LV + 8 * dn + g;
        mma_3xtf32(pv, pv_lo, ph[kk], pl[kk], vr[0], vr[L::LV]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) o[dn][i] = fmaf(o[dn][i], corr[i >> 1], pv[i] + pv_lo[i]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
  if (a.lse != nullptr && t == 0)
    store_lse(a.lse, ((long long)b * a.H + h) * a.Sq, row0, a.Sq, m, l, cl2);
  float* og = (float*)a.o + (long long)b * a.Sq * qstride + (long long)h * D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = 8 * dn + 2 * t;
    if (row0 < a.Sq)
      *reinterpret_cast<float2*>(og + row0 * qstride + col) =
          make_float2(o[dn][0] * inv0, o[dn][1] * inv0);
    if (row0 + 8 < a.Sq)
      *reinterpret_cast<float2*>(og + (row0 + 8) * qstride + col) =
          make_float2(o[dn][2] * inv1, o[dn][3] * inv1);
  }
}

// ------------------------------------------------------ bf16, wgmma + TMA ----

constexpr int kWBQ = 128;      // query rows per CTA: two consumer warpgroups x 64
constexpr int kWStages = 2;    // K/V ring depth (three measured no faster)
constexpr int kWThreads = 384; // producer warpgroup + two consumer warpgroups

// Per head dim, the faster of each pair measured on the H100 (PERF.md): keys
// per tile, and whether the softmax overlaps P.V inside a warpgroup.
__host__ __device__ constexpr int wgmma_key_tile(int D) { return D <= 32 ? 256 : 128; }
__host__ __device__ constexpr bool wgmma_overlap(int D) { return D == 16; }

// Shared-memory plan of one CTA (offsets from a 1024-byte aligned base). Each
// tile is stored as D / kCols parts of [rows x kCols] bf16, the layout TMA's
// swizzle of the row width (kRow = 32, 64 or 128 bytes) writes and a wgmma
// descriptor of the same swizzle reads; 8 rows make one swizzle atom.
template <int D, int BK>
struct WLayout {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kParts = D / kCols;
  static constexpr uint32_t kRow = 2 * kCols;
  static constexpr uint32_t kAtom = 8 * kRow;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kSwizzle = kRow == 128 ? 1 : (kRow == 64 ? 2 : 3);
  static constexpr uint32_t kQBytes = kWBQ * D * 2;
  static constexpr uint32_t kKVBytes = BK * D * 2;
  static constexpr uint32_t kK = kQBytes;                     // K stages
  static constexpr uint32_t kV = kK + kWStages * kKVBytes;      // V stages
  static constexpr uint32_t kBar = kV + kWStages * kKVBytes;    // mbarriers
  static constexpr uint32_t kSmem = kBar + 8 * (1 + 3 * kWStages) + 1024;
};

struct WArgs {
  void* o;
  int Sq, Sk, H, Hkv, causal, n_qblocks;
  float scale_log2;  // log2(e) / sqrt(D)
  float* lse;        // (B, H, Sq) f32, or null
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128 f32) (+)= A (64 x 16, shared) . B (16 x 128, shared), both K-major;
// scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 256 f32) (+)= A (64 x 16, shared) . B (16 x 256, shared), both K-major;
// scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16 f32) += A (64 x 16, registers) . B (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32 f32) += A (64 x 16, registers) . B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64 f32) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S (64 x BK) = Q (this warpgroup's 64 rows) . K^T, both K-major in shared
// memory; each k-step of 16 columns advances the start address by 32 bytes
// inside its part's swizzle atom.
template <class L, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t qa, uint32_t ks) {
  constexpr int kSteps = L::kCols / 16;  // k-steps per part
#pragma unroll
  for (int kc = 0; kc < L::kParts * kSteps; ++kc) {
    const uint32_t part = kc / kSteps, koff = (kc % kSteps) * 32;
    wgmma_ss(s, smem_desc(qa + part * kWBQ * L::kRow + koff, 16, L::kAtom, L::kSwizzle),
             smem_desc(ks + part * BK * L::kRow + koff, 16, L::kAtom, L::kSwizzle), kc > 0);
  }
}

// O += P . V: V (BK keys x kCols columns per part) is MN-major; a k-step of
// 16 keys is two swizzle atoms further on.
template <class L, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[L::kParts][L::kCols / 2],
                                         const uint32_t (&pa)[BK / 16][4], uint32_t vs) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
    for (int part = 0; part < L::kParts; ++part)
      wgmma_rs(o[part], pa[kc],
               smem_desc(vs + part * BK * L::kRow + kc * 16 * L::kRow, L::kAtom, L::kAtom,
                         L::kSwizzle));
}

// P in bf16 as the register A operand, 16 keys per k-step
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    pa[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
    pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

template <class L>
__device__ __forceinline__ void rescale(float (&o)[L::kParts][L::kCols / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int part = 0; part < L::kParts; ++part)
#pragma unroll
    for (int i = 0; i < L::kCols / 2; ++i) o[part][i] *= corr[(i >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, WArgs a) {
  constexpr int BK = wgmma_key_tile(D);
  constexpr bool OVERLAP = wgmma_overlap(D);
  using L = WLayout<D, BK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;              // + 8 * stage
  const uint32_t v_full = k_full + 8 * kWStages;     // + 8 * stage
  const uint32_t empty = v_full + 8 * kWStages;      // + 8 * stage

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int qb = a.causal ? a.n_qblocks - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qb * kWBQ;
  const int diag = a.Sk - a.Sq;
  int n_tiles = (a.Sk + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + kWBQ, a.Sq) - 1 + diag) / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kWStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int part = 0; part < L::kParts; ++part)
        tma_load_4d(base + part * kWBQ * L::kRow, &tq, q_full, L::kCols * part, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kWStages;
        const uint32_t ph = (j / kWStages) & 1;
        const uint32_t ks = base + L::kK + st * L::kKVBytes;
        const uint32_t vs = base + L::kV + st * L::kKVBytes;
        mbar_wait(empty + 8 * st, ph ^ 1);
        mbar_expect_tx(k_full + 8 * st, L::kKVBytes);
#pragma unroll
        for (int part = 0; part < L::kParts; ++part)
          tma_load_4d(ks + part * BK * L::kRow, &tk, k_full + 8 * st, L::kCols * part, hk,
                      j * BK, b);
        mbar_expect_tx(v_full + 8 * st, L::kKVBytes);
#pragma unroll
        for (int part = 0; part < L::kParts; ++part)
          tma_load_4d(vs + part * BK * L::kRow, &tv, v_full + 8 * st, L::kCols * part, hk,
                      j * BK, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32, t = lane & 3;
    // accumulator layout (m64nN): this thread holds rows row0 and row0 + 8,
    // columns 8*j + 2*t + {0, 1} in registers 4*j + {0, 1} and 4*j + {2, 3}
    const int qfirst = q0 + 64 * c;
    const int row0 = qfirst + 16 * warp + (lane >> 2);
    const int qpos[2] = {row0 + diag, row0 + 8 + diag};
    const float cl2 = a.scale_log2;
    const uint32_t qa = base + c * 64 * L::kRow;
    auto k_stage = [&](int j) { return base + L::kK + (j % kWStages) * L::kKVBytes; };
    auto v_stage = [&](int j) { return base + L::kV + (j % kWStages) * L::kKVBytes; };
    auto phase = [&](int j) { return (uint32_t)((j / kWStages) & 1); };
    auto need_mask = [&](int k0) {
      return k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > qfirst + diag);
    };

    float o[L::kParts][L::kCols / 2];
#pragma unroll
    for (int part = 0; part < L::kParts; ++part)
#pragma unroll
      for (int i = 0; i < L::kCols / 2; ++i) o[part][i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, corr[2];
    float s[BK / 2];
    uint32_t pa[BK / 16][4];

    mbar_wait(q_full, 0);
    if (OVERLAP) {
      // tile 0: S, softmax, P
      mbar_wait(k_full, 0);
      wgmma_fence();
      issue_qk<L, BK>(s, qa, k_stage(0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      softmax_step(s, m, l, corr, need_mask(0), 0, t, qpos, a.Sk, a.causal, cl2);
      pack_p<BK>(pa, s);
      for (int j = 1; j < n_tiles; ++j) {
        // S_j = Q.K_j^T and O += P_{j-1}.V_{j-1} in flight together; the
        // softmax of S_j runs under P.V, and P_j is packed after it
        mbar_wait(k_full + 8 * (j % kWStages), phase(j));
        mbar_wait(v_full + 8 * ((j - 1) % kWStages), phase(j - 1));
        fence_regs(o);
        wgmma_fence();
        issue_qk<L, BK>(s, qa, k_stage(j));
        wgmma_commit();
        issue_pv<L, BK>(o, pa, v_stage(j - 1));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        softmax_step(s, m, l, corr, need_mask(j * BK), j * BK, t, qpos, a.Sk, a.causal, cl2);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(empty + 8 * ((j - 1) % kWStages));
        rescale<L>(o, corr);
        pack_p<BK>(pa, s);
      }
      const int j = n_tiles - 1;
      mbar_wait(v_full + 8 * (j % kWStages), phase(j));
      fence_regs(o);
      wgmma_fence();
      issue_pv<L, BK>(o, pa, v_stage(j));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(empty + 8 * (j % kWStages));
    } else {
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(k_full + 8 * (j % kWStages), phase(j));
        fence_regs(s);
        wgmma_fence();
        issue_qk<L, BK>(s, qa, k_stage(j));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        softmax_step(s, m, l, corr, need_mask(j * BK), j * BK, t, qpos, a.Sk, a.causal, cl2);
        rescale<L>(o, corr);
        pack_p<BK>(pa, s);
        mbar_wait(v_full + 8 * (j % kWStages), phase(j));
        fence_regs(o);
        wgmma_fence();
        issue_pv<L, BK>(o, pa, v_stage(j));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);  // the A operand stays in its registers until the wait
        if (lane == 0) mbar_arrive(empty + 8 * (j % kWStages));
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
    if (a.lse != nullptr && t == 0)
      store_lse(a.lse, ((long long)b * a.H + h) * a.Sq, row0, a.Sq, m, l, cl2);
    const long long stride = (long long)a.H * D;
    __nv_bfloat16* og = (__nv_bfloat16*)a.o + (long long)b * a.Sq * stride + (long long)h * D;
#pragma unroll
    for (int part = 0; part < L::kParts; ++part)
#pragma unroll
      for (int jj = 0; jj < L::kCols / 8; ++jj) {
        const int col = L::kCols * part + 8 * jj + 2 * t;
        if (row0 < a.Sq)
          *reinterpret_cast<uint32_t*>(og + row0 * stride + col) =
              pack_bf16(o[part][4 * jj] * inv0, o[part][4 * jj + 1] * inv0);
        if (row0 + 8 < a.Sq)
          *reinterpret_cast<uint32_t*>(og + (row0 + 8) * stride + col) =
              pack_bf16(o[part][4 * jj + 2] * inv1, o[part][4 * jj + 3] * inv1);
      }
  }
}

// ------------------------------------------------------------- launchers ----

// Tensor map over a (B, S, heads, D) bf16 tensor, innermost first, whose box
// is `cols` columns of one head over `rows` positions, swizzled by the box's
// row width (2 * cols bytes). Rows past S read as zeros.
bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int D, int heads, int S,
              int B, int cols, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA and cp.async read from 16-byte aligned q, k and v.
bool aligned16(const Args& a) {
  return (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
          reinterpret_cast<uintptr_t>(a.v)) % 16 == 0;
}

template <int D>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  constexpr int BK = wgmma_key_tile(D);
  using L = WLayout<D, BK>;
  if (!aligned16(a)) return cudaErrorMisalignedAddress;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, a.q, D, a.H, a.Sq, a.B, L::kCols, kWBQ) ||
      !make_map(enc, &tk, a.k, D, a.Hkv, a.Sk, a.B, L::kCols, BK) ||
      !make_map(enc, &tv, a.v, D, a.Hkv, a.Sk, a.B, L::kCols, BK))
    return cudaErrorInvalidValue;
  const int n_qblocks = (a.Sq + kWBQ - 1) / kWBQ;
  if (n_qblocks > 65535) return cudaErrorInvalidConfiguration;
  const WArgs w{a.o,       a.Sq,      a.Sk, a.H, a.Hkv, a.causal, n_qblocks,
                kLog2e / sqrtf((float)D), a.lse};
  auto kern = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.B * a.H, n_qblocks), kWThreads, L::kSmem, stream>>>(tq, tk, tv, w);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  if (!aligned16(a)) return cudaErrorMisalignedAddress;
  const int n_qblocks = (a.Sq + kFBQ - 1) / kFBQ;
  if (n_qblocks > 65535) return cudaErrorInvalidConfiguration;
  auto kern = flash_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         FLayout<D>::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.B * a.H, n_qblocks), kFWarps * 32, FLayout<D>::kSmem, stream>>>(a, n_qblocks);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  return a.B >= 1 && a.Sq >= 1 && a.Sk >= 1 && a.Hkv >= 1 && a.H % a.Hkv == 0 &&
         !(a.causal && a.Sq > a.Sk);
}

cudaError_t launch(const Args& a, bool bf16, cudaStream_t s) {
  if (!valid(a)) return cudaErrorInvalidValue;
  switch (a.D) {
    case 16: return bf16 ? launch_wgmma<16>(a, s) : launch_f32<16>(a, s);
    case 32: return bf16 ? launch_wgmma<32>(a, s) : launch_f32<32>(a, s);
    case 64: return bf16 ? launch_wgmma<64>(a, s) : launch_f32<64>(a, s);
    case 128: return bf16 ? launch_wgmma<128>(a, s) : launch_f32<128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 q, k, v at D = 16 / 32 / 64 / 128 on the wgmma kernel.
extern "C" int smt_flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
                             int Sq, int Sk, int H, int Hkv, int D, int causal, void* stream) {
  return (int)launch(Args{q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, nullptr}, true,
                     (cudaStream_t)stream);
}

// f32 q, k, v at D = 16 / 32 / 64 / 128 on the 3xTF32 kernel.
extern "C" int smt_flash_fwd_f32(const void* q, const void* k, const void* v, void* o, int B,
                                 int Sq, int Sk, int H, int Hkv, int D, int causal,
                                 void* stream) {
  return (int)launch(Args{q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, nullptr}, false,
                     (cudaStream_t)stream);
}

// The same two kernels writing each row's log-sum-exp to lse (B, H, Sq) f32
// as well: one f32 store a row in the epilogue.
extern "C" int smt_flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                                 int causal, void* stream) {
  return (int)launch(Args{q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, (float*)lse}, true,
                     (cudaStream_t)stream);
}

extern "C" int smt_flash_fwd_f32_lse(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                                     int causal, void* stream) {
  return (int)launch(Args{q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, (float*)lse}, false,
                     (cudaStream_t)stream);
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
