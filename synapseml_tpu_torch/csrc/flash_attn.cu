// Kernel C: flash attention forward.
//
// Replaces: synapseml_tpu/parallel/flash.py::_flash_bh_impl (flash.py:193,
// the Pallas kernel launched by pl.pallas_call at flash.py:272). Forward-only
// blockwise attention with an online softmax: scores q.k^T / sqrt(D), the
// causal diagonal aligned to the END of the keys (diag_off = S_k - S_q),
// masked scores a finite -1e30, key tiles wholly above the diagonal skipped,
// running max m and denominator l in f32, an f32 accumulator, P cast to the
// input dtype before P.V, output acc / max(l, 1e-30) in the input dtype. GQA:
// query head h reads K/V head h / (H / H_kv); K/V are never expanded.
//
// Layout: q/o (B, S_q, H, D), k/v (B, S_k, H_kv, D), read strided in place
// (a row of D values is contiguous; rows of one head are H*D apart), so the
// caller needs no transposes.
//
// Bound on the H100: operations for long sequences. 4*B*H*S_q*S_k*D flops
// (about half of that causal) at 989 TFLOP/s in bf16, against q, k, v, o
// read or written once at 3.35 TB/s. At S = 8k..32k, D = 64 the flop bound
// is 10-100x the byte bound, so the tensor-core rate is what counts, and on
// Hopper only wgmma reaches it.
//
// Three kernels, chosen by dtype and head dim (never on a failure):
//
// bf16, D = 64 and 128: flash_wgmma_kernel, warp-specialised. A CTA of three
// warpgroups covers 128 query rows of one (b, h): warpgroup 0 is the
// producer (it gives its registers to the others with setmaxnreg; one thread
// issues every TMA load), warpgroups 1 and 2 are consumers of 64 rows each.
// TMA loads the Q tile once and 128-key tiles of K and V into a two-stage
// ring in dynamic shared memory, through 4-D tensor maps over (B, S, H, D)
// with the real strides and the 128-byte swizzle; each stage has a full
// barrier for K, one for V, and an empty barrier the eight consumer warps
// arrive on when they are done with it. TMA zero-fills rows past S_q and
// S_k. S = Q.K^T is wgmma m64n128k16 with Q and K from shared memory
// (K-major), its f32 accumulator converted in registers into the bf16
// A operand of O += P.V, which is wgmma m64n64k16 per 64 columns of D with V
// from shared memory as an MN-major B (V's tile is D-contiguous). The softmax
// takes one ex2 per score with scale*log2(e) folded into one FMA, masks only
// tiles that cross the diagonal or the ragged end, and keeps m and the
// per-thread part of l in registers. Causal query tiles are launched
// heaviest first (grid y reversed, all heads of a tile side by side).
// What it does not do yet: overlap one warpgroup's softmax with its own
// next Q.K^T (the two consumers overlap each other only), a persistent grid,
// or a TMA store of O.
//
// bf16, D = 16 and 32: flash_bf16_kernel, the first version (mma.sync): one
// CTA of 4 warps per (batch*head, 64-query tile); each warp owns 16 query
// rows. Q fragments stay in registers for the whole key loop; 64-key tiles
// of K and V are staged in shared memory (rows padded by 16 bytes) by every
// thread. S = Q.K^T and O += P.V run as mma.sync.m16n8k16 (bf16 in, f32
// accumulate); the S accumulator's layout is the A layout of P.V, so P never
// leaves registers. A wgmma tile at these head dims would need the 64- and
// 32-byte swizzles; the small head dims stay here until that is done.
//
// f32: flash_f32_kernel, one thread per query row, 128 rows per CTA, 32-key
// tiles of K and V in shared memory read as broadcasts, FMA dot products, the
// same online-softmax recurrence per tile.
//
// TMA descriptors are encoded on the host with cuTensorMapEncodeTiled, which
// is reached through cudaGetDriverEntryPoint, so the library does not link
// against libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, Hkv, D;
  int causal;
};

// ------------------------------------------- bf16, mma.sync (D = 16, 32) ----

constexpr int kBQ = 64;   // query rows per CTA (4 warps x 16)
constexpr int kBK = 64;   // keys per tile
constexpr int kWarps = 4;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Copy `rows` rows of D bf16 (global row stride `stride` elements) into a
// shared tile with row stride D+8; rows past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                         long long stride, int rows, int valid) {
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * kVec; i += blockDim.x) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bf16_kernel(Args a) {
  constexpr int LD = D + 8;
  static_assert(kBQ == kBK, "the Q tile is staged in the K buffer");
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int diag = a.Sk - a.Sq;
  const float scale = 1.f / sqrtf((float)D);

  const long long qstride = (long long)a.H * D;
  const long long kstride = (long long)a.Hkv * D;
  const __nv_bfloat16* qg = (const __nv_bfloat16*)a.q + ((long long)b * a.Sq + q0) * qstride + (long long)h * D;
  const __nv_bfloat16* kg = (const __nv_bfloat16*)a.k + (long long)b * a.Sk * kstride + (long long)hk * D;
  const __nv_bfloat16* vg = (const __nv_bfloat16*)a.v + (long long)b * a.Sk * kstride + (long long)hk * D;

  // the Q tile passes through the K buffer (static shared memory stays
  // under 48 KB at D = 128) on its way to registers
  const __nv_bfloat16* Qs = Ks;
  load_tile<D>(Ks, qg, qstride, kBQ, min(kBQ, a.Sq - q0));
  __syncthreads();

  // Q fragments (A operand, 16 x 16 per k-chunk) for this warp's 16 rows
  uint32_t qf[D / 16][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    qf[kc][0] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * LD + c]);
    qf[kc][1] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * LD + c]);
    qf[kc][2] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * LD + c + 8]);
    qf[kc][3] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * LD + c + 8]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int qpos[2] = {q0 + r0 + diag, q0 + r0 + 8 + diag};

  int n_tiles = (a.Sk + kBK - 1) / kBK;
  if (a.causal) {
    // the block's last live query sees keys up to its position; later tiles
    // lie wholly above the diagonal
    const int last = min(q0 + kBQ, a.Sq) - 1 + diag;
    n_tiles = min(n_tiles, last / kBK + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();
    load_tile<D>(Ks, kg + (long long)k0 * kstride, kstride, kBK, min(kBK, a.Sk - k0));
    load_tile<D>(Vs, vg + (long long)k0 * kstride, kstride, kBK, min(kBK, a.Sk - k0));
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int nc = 0; nc < kBK / 8; ++nc) {
      s[nc][0] = s[nc][1] = s[nc][2] = s[nc][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const __nv_bfloat16* kr = &Ks[(nc * 8 + g) * LD + kc * 16 + 2 * t];
        mma_bf16(s[nc], qf[kc], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    const bool need_mask = (k0 + kBK > a.Sk) ||
                           (a.causal && k0 + kBK - 1 > q0 + diag);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nc = 0; nc < kBK / 8; ++nc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float val = s[nc][i] * scale;
        if (need_mask) {
          const int kpos = k0 + nc * 8 + 2 * t + (i & 1);
          if (kpos >= a.Sk || (a.causal && qpos[i >> 1] < kpos)) val = kNeg;
        }
        s[nc][i] = val;
        mx[i >> 1] = fmaxf(mx[i >> 1], val);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nc = 0; nc < kBK / 8; ++nc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[nc][i] - m[i >> 1]);
        s[nc][i] = p;
        rs[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffff, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffff, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= corr[0];
      o[dn][1] *= corr[0];
      o[dn][2] *= corr[1];
      o[dn][3] *= corr[1];
    }
    // O += P.V: P (16 x 64 keys) from registers, V from shared memory
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const int kr = kc * 16 + 2 * t;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int col = dn * 8 + g;
        const uint32_t b0 = pack_raw(Vs[kr * LD + col], Vs[(kr + 1) * LD + col]);
        const uint32_t b1 = pack_raw(Vs[(kr + 8) * LD + col], Vs[(kr + 9) * LD + col]);
        mma_bf16(o[dn], pa, b0, b1);
      }
    }
  }

  __nv_bfloat16* og = (__nv_bfloat16*)a.o + ((long long)b * a.Sq + q0) * qstride + (long long)h * D;
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (q0 + r0 < a.Sq)
      *reinterpret_cast<uint32_t*>(og + r0 * qstride + col) =
          pack_bf16(o[dn][0] * inv0, o[dn][1] * inv0);
    if (q0 + r0 + 8 < a.Sq)
      *reinterpret_cast<uint32_t*>(og + (r0 + 8) * qstride + col) =
          pack_bf16(o[dn][2] * inv1, o[dn][3] * inv1);
  }
}

// ----------------------------------------------------------------- f32 ----

constexpr int kBQ32 = 128;
constexpr int kBK32 = 32;

template <int D>
__global__ void __launch_bounds__(kBQ32) flash_f32_kernel(Args a) {
  __shared__ float Ks[kBK32 * D];
  __shared__ float Vs[kBK32 * D];
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * kBQ32;
  const int qi = q0 + threadIdx.x;
  const int diag = a.Sk - a.Sq;
  const float scale = 1.f / sqrtf((float)D);
  const long long qstride = (long long)a.H * D;
  const long long kstride = (long long)a.Hkv * D;
  const float* kg = (const float*)a.k + (long long)b * a.Sk * kstride + (long long)hk * D;
  const float* vg = (const float*)a.v + (long long)b * a.Sk * kstride + (long long)hk * D;

  float q[D], acc[D];
  const bool live = qi < a.Sq;
  const float* qr = (const float*)a.q + ((long long)b * a.Sq + (live ? qi : 0)) * qstride + (long long)h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = live ? qr[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNeg, l = 0.f;
  const int qpos = qi + diag;

  int n_tiles = (a.Sk + kBK32 - 1) / kBK32;
  if (a.causal) {
    const int last = min(q0 + kBQ32, a.Sq) - 1 + diag;
    n_tiles = min(n_tiles, last / kBK32 + 1);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK32;
    const int valid = min(kBK32, a.Sk - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kBK32 * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      Ks[i] = r < valid ? kg[(long long)(k0 + r) * kstride + c] : 0.f;
      Vs[i] = r < valid ? vg[(long long)(k0 + r) * kstride + c] : 0.f;
    }
    __syncthreads();
    float sc[kBK32];
    float mx = kNeg;
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(q[d], Ks[kk * D + d], dot);
      float val = dot * scale;
      const int kpos = k0 + kk;
      if (kpos >= a.Sk || (a.causal && qpos < kpos)) val = kNeg;
      sc[kk] = val;
      mx = fmaxf(mx, val);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    m = m_new;
    float rs = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      const float p = expf(sc[kk] - m_new);
      rs += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[kk * D + d], acc[d]);
    }
    l = l * corr + rs;
  }
  if (live) {
    float* orow = (float*)a.o + ((long long)b * a.Sq + qi) * qstride + (long long)h * D;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
  }
}

// ------------------------------------------------------ bf16, wgmma + TMA ----

constexpr int kWBQ = 128;      // query rows per CTA: two consumer warpgroups x 64
constexpr int kWBK = 128;      // keys per tile
constexpr int kWStages = 2;    // K/V ring depth
constexpr int kWThreads = 384; // producer warpgroup + two consumer warpgroups
constexpr int kRow = 128;      // bytes of one swizzled row: 64 bf16 columns

// Shared-memory plan of one CTA (offsets from a 1024-byte aligned base). Each
// tile is stored as D/64 column halves of [rows x 64] bf16, the layout TMA's
// 128-byte swizzle writes and a SWIZZLE_128B wgmma descriptor reads.
template <int D>
struct WLayout {
  static constexpr int kHalves = D / 64;
  static constexpr uint32_t kQBytes = kWBQ * D * 2;
  static constexpr uint32_t kKVBytes = kWBK * D * 2;
  static constexpr uint32_t kK = kQBytes;                       // K stages
  static constexpr uint32_t kV = kK + kWStages * kKVBytes;      // V stages
  static constexpr uint32_t kBar = kV + kWStages * kKVBytes;    // mbarriers
  static constexpr uint32_t kSmem = kBar + 8 * (1 + 3 * kWStages) + 1024;
};

struct WArgs {
  void* o;
  int Sq, Sk, H, Hkv, causal, n_qblocks;
  float scale_log2;  // log2(e) / sqrt(D)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA load of a 4-D box, completing on `bar` with its byte count.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin accumulator registers at this point of the program, so the compiler
// neither reads them before a wgmma wait nor moves writes past a fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 128 f32) += A (64 x 16, shared) . B (16 x 128, shared), both K-major
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64 f32) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, WArgs a) {
  using L = WLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;                 // + 8 * stage
  const uint32_t v_full = k_full + 8 * kWStages;      // + 8 * stage
  const uint32_t empty = v_full + 8 * kWStages;       // + 8 * stage

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int qb = a.causal ? a.n_qblocks - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qb * kWBQ;
  const int diag = a.Sk - a.Sq;
  int n_tiles = (a.Sk + kWBK - 1) / kWBK;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + kWBQ, a.Sq) - 1 + diag) / kWBK + 1);

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
      for (int hh = 0; hh < L::kHalves; ++hh)
        tma_load_4d(base + hh * kWBQ * kRow, &tq, q_full, 64 * hh, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kWStages;
        const uint32_t ph = (j / kWStages) & 1;
        const uint32_t ks = base + L::kK + st * L::kKVBytes;
        const uint32_t vs = base + L::kV + st * L::kKVBytes;
        mbar_wait(empty + 8 * st, ph ^ 1);
        mbar_expect_tx(k_full + 8 * st, L::kKVBytes);
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh)
          tma_load_4d(ks + hh * kWBK * kRow, &tk, k_full + 8 * st, 64 * hh, hk, j * kWBK, b);
        mbar_expect_tx(v_full + 8 * st, L::kKVBytes);
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh)
          tma_load_4d(vs + hh * kWBK * kRow, &tv, v_full + 8 * st, 64 * hh, hk, j * kWBK, b);
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

    float o[L::kHalves][32];
#pragma unroll
    for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kWStages;
      const uint32_t ph = (j / kWStages) & 1;
      const uint32_t ks = base + L::kK + st * L::kKVBytes;
      const uint32_t vs = base + L::kV + st * L::kKVBytes;
      const int k0 = j * kWBK;

      // S = Q.K^T (64 x 128 keys), both operands K-major in shared memory
      float s[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.f;
      mbar_wait(k_full + 8 * st, ph);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t half = kc / 4, koff = (kc % 4) * 32;
        wgmma_ss_m64n128k16(
            s, sw128_desc(base + half * kWBQ * kRow + c * 64 * kRow + koff, 16, 1024),
            sw128_desc(ks + half * kWBK * kRow + koff, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      if (k0 + kWBK > a.Sk || (a.causal && k0 + kWBK - 1 > qfirst + diag)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int kpos = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (kpos >= a.Sk || (a.causal && kpos > qpos[(i >> 1) & 1])) s[i] = kNeg;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float msc[2], corr[2];
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
      for (int i = 0; i < 64; ++i) {
        const float p = ex2(fmaf(s[i], cl2, -msc[(i >> 1) & 1]));
        s[i] = p;
        l[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[hh][i] *= corr[(i >> 1) & 1];

      // P in bf16 as the register A operand, 16 keys per k-step
      uint32_t pa[kWBK / 16][4];
#pragma unroll
      for (int kc = 0; kc < kWBK / 16; ++kc) {
        pa[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
        pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
        pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
        pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
      }

      // O += P.V: V (128 keys x 64 columns per half) is MN-major; 8 keys of
      // 128-byte rows make one 1024-byte swizzle atom, the K-step stride
      mbar_wait(v_full + 8 * st, ph);
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) fence_regs(o[hh]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kWBK / 16; ++kc)
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh)
          wgmma_rs_m64n64k16(o[hh], pa[kc],
                             sw128_desc(vs + hh * kWBK * kRow + kc * 16 * kRow, 1024, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) fence_regs(o[hh]);
      fence_regs(pa);  // the A operand stays in its registers until the wait
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
    const long long stride = (long long)a.H * D;
    __nv_bfloat16* og = (__nv_bfloat16*)a.o + (long long)b * a.Sq * stride + (long long)h * D;
#pragma unroll
    for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 64 * hh + 8 * jj + 2 * t;
        if (row0 < a.Sq)
          *reinterpret_cast<uint32_t*>(og + row0 * stride + col) =
              pack_bf16(o[hh][4 * jj] * inv0, o[hh][4 * jj + 1] * inv0);
        if (row0 + 8 < a.Sq)
          *reinterpret_cast<uint32_t*>(og + (row0 + 8) * stride + col) =
              pack_bf16(o[hh][4 * jj + 2] * inv1, o[hh][4 * jj + 3] * inv1);
      }
  }
}

// ------------------------------------------------------------- launchers ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map over a (B, S, heads, D) bf16 tensor, innermost first, whose box
// is 64 columns of one head over `rows` positions, with the 128-byte swizzle.
// Rows past S read as zeros.
bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int D, int heads, int S,
              int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA and the 16-byte vector loads need 16-byte aligned q, k and v.
bool aligned16(const Args& a) {
  return (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
          reinterpret_cast<uintptr_t>(a.v)) % 16 == 0;
}

template <int D>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  if (!aligned16(a)) return cudaErrorMisalignedAddress;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, a.q, D, a.H, a.Sq, a.B, kWBQ) ||
      !make_map(enc, &tk, a.k, D, a.Hkv, a.Sk, a.B, kWBK) ||
      !make_map(enc, &tv, a.v, D, a.Hkv, a.Sk, a.B, kWBK))
    return cudaErrorInvalidValue;
  const int n_qblocks = (a.Sq + kWBQ - 1) / kWBQ;
  if (n_qblocks > 65535) return cudaErrorInvalidConfiguration;
  const WArgs w{a.o, a.Sq, a.Sk, a.H, a.Hkv, a.causal, n_qblocks,
                1.4426950408889634f / sqrtf((float)D)};
  auto kern = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)WLayout<D>::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.B * a.H, n_qblocks), kWThreads, WLayout<D>::kSmem, stream>>>(tq, tk, tv, w);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma_sync(const Args& a, cudaStream_t stream) {
  if ((long long)a.B * a.H > 65535) return cudaErrorInvalidConfiguration;
  if (!aligned16(a)) return cudaErrorMisalignedAddress;
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  flash_bf16_kernel<D><<<grid, kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  if ((long long)a.B * a.H > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((a.Sq + kBQ32 - 1) / kBQ32, a.B * a.H);
  flash_f32_kernel<D><<<grid, kBQ32, 0, stream>>>(a);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  return a.B >= 1 && a.Sq >= 1 && a.Sk >= 1 && a.Hkv >= 1 && a.H % a.Hkv == 0 &&
         !(a.causal && a.Sq > a.Sk);
}

}  // namespace

// bf16 at D = 64 / 128 (the wgmma kernel) or f32 at D = 16 / 32 / 64 / 128.
extern "C" int smt_flash_fwd(const void* q, const void* k, const void* v, void* o, int bf16,
                             int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
                             void* stream) {
  const Args a{q, k, v, o, B, Sq, Sk, H, Hkv, D, causal};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    switch (D) {
      case 64: return (int)launch_wgmma<64>(a, s);
      case 128: return (int)launch_wgmma<128>(a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16: return (int)launch_f32<16>(a, s);
    case 32: return (int)launch_f32<32>(a, s);
    case 64: return (int)launch_f32<64>(a, s);
    case 128: return (int)launch_f32<128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 at D = 16 / 32 on the mma.sync kernel.
extern "C" int smt_flash_fwd_mma_sync(const void* q, const void* k, const void* v, void* o,
                                      int bf16, int B, int Sq, int Sk, int H, int Hkv, int D,
                                      int causal, void* stream) {
  const Args a{q, k, v, o, B, Sq, Sk, H, Hkv, D, causal};
  if (!bf16 || !valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return (int)launch_mma_sync<16>(a, s);
    case 32: return (int)launch_mma_sync<32>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
