// Kernel Q: integer GEMM and implicit-GEMM convolution over 8-bit operands,
// int32 accumulation, zero points, and an optional requantizing epilogue.
//
// Replaces: synapseml_tpu/onnx/ops.py's int32 contractions, which XLA computes
// (torch has no integer GEMM or convolution on CUDA):
//   - jnp.matmul(..., preferred_element_type=int32) of MatMulInteger (:795)
//     and QLinearMatMul (:860-861);
//   - lax.conv_general_dilated(..., preferred_element_type=int32) of
//     ConvInteger (:814-818), which QLinearConv calls (:834).
// The reference widens both operands to int32 and subtracts the zero points
// before the contraction (_zp_shift, :773-785). Here the raw uint8 / int8
// operands go to the tensor cores as they are (wgmma m64nNk32, s32
// accumulation, in all four signedness pairs), and the zero points enter in
// the epilogue:
//   sum_k (a - za)(b - zb) = sum ab - zb * sum a - za * sum b + K * za * zb,
// taken in uint32 arithmetic, so the result equals the reference's int32 sum
// modulo 2^32 exactly, as XLA's int32 sum (and the tensor cores') wraps.
//
// smt_qmatmul: C[z, m, n] = sum_k A[z, m, k] B[z, k, n] over a batch z; a 1-D
// a zero point lies along M, a 1-D b zero point along N (the ONNX spec's
// rule). smt_qconv: NCHW x OIHW convolution with strides, dilations, groups
// and the resolved begin pads (the end pads are implied by OH, OW) as a GEMM
// per group: M = images x OH x OW, N = output channels of the group, K = the
// group's taps x channels. A padded tap is the raw value x_zp (real zero, as
// in the reference, ops.py:799-801), not raw 0. The w zero point may be per
// output channel.
//
// Epilogue (out_mode 1 / 2, QLinearMatMul / QLinearConv): add the optional
// int32 bias (per output channel, wrapping as int32 does), multiply by the f32
// scale that the wrapper computed in the reference's op order
// ((x_scale * w_scale) / y_scale, ops.py:839-840, :864-865), round half to
// even (rintf), add y_zp in f32, saturate to uint8 / int8. out_mode 0 writes
// the int32 sum.
//
// Bound on the H100: at BERT-base's projections and ResNet-50's convolutions
// the int32 output's bytes (4 M N) outweigh 2 M N K operations at the int8
// tensor-core rate, so the design keeps the tensor cores fed and the output
// stream in whole sectors:
//   - 8-bit wgmma takes both operands K-major, so B comes packed: rows of
//     ldb bytes (a multiple of 16), k contiguous, zero past K -- a matmul's
//     B transposed to (N, K), a conv's weight reordered to (Cout, KH, KW,
//     cin_p). The wrapper packs a graph's weight once (onnx/qgemm.py:
//     pack_matmul_b / pack_conv_w, kept beside the initializer), with its
//     sums along k (sum b, needed whenever A has a zero point); a B computed
//     in the graph is packed a call.
//   - A CTA of three warpgroups computes a 128 x BN tile (BN = 64 for N <=
//     64, else 128; a 128 x 256 tile was built and measured slower at the
//     main path's shapes, PERF.md):
//     warpgroup 0 produces, warpgroups 1 and 2 consume 64 rows each with
//     wgmma from a ring of kStages shared-memory stages of 128 k, stored in
//     TMA's 128-byte swizzle, on full / empty mbarriers.
//   - Operand A of a matmul and every B tile arrive by TMA (2-D tensor maps,
//     rows past the tensor zero-filled). A conv's A (the im2col tile) cannot:
//     x is NCHW, and TMA's im2col mode needs channels innermost and a
//     channel run of 16 bytes or more. So x is first written channels-last
//     ((images, groups, H, W, cin_p), channels padded to a multiple of 4
//     with x_zp) by this file's channels_last_kernel, once a call, and the
//     producer warpgroup gathers the tile with cp.async straight into the
//     swizzled layout: 16-byte pieces where cin_p is a multiple of 16,
//     4-byte pieces otherwise (ResNet-50's stem); a padded tap is x_zp's
//     byte, written with st.shared; k past K is 0. A thread arrives on the
//     stage's full barrier kLag stages later, after cp.async.wait_group and
//     fence.proxy.async (the generic proxy's writes made visible to wgmma's
//     async proxy).
//   - sum a (a row's sum, needed only where B's zero point may be non-zero,
//     which a plan knows for a 0 initializer) is taken by the consumers from
//     the stage with dp4a (a 128-byte swizzle permutes chunks within a row,
//     so a row's sum reads the row as it lies).
//   - The epilogue stores from the accumulators' registers: a lane group's
//     eight rows (consecutive output pixels of a conv, whose NCHW planes are
//     contiguous along them) and four column pairs fill whole 32-byte
//     sectors, a matmul's pairs as 8-byte stores. A tile staged through the
//     ring's shared memory first was built and measured no faster (the
//     staging pass cost what the wider stores saved; PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "occupancy.cuh"

struct QArgs {
  const void* a;          // matmul: A rows (batch x M rows of lda bytes); conv: x channels-last
  const void* bt;         // packed B: rows of ldb bytes, k contiguous
  void* out;              // (batch, M, N) int32 / uint8 / int8; (images, Cout, OH, OW)
  const int* b_colsum;    // sum_k b of each packed row; null: A has no zero point
  const int* a_zp_vec;    // zero point of A along m (stride a_zp_sm); null: a_zp
  const int* b_zp_vec;    // zero point of B along the output channel (stride b_zp_sn); null: b_zp
  const int* bias;        // int32 per output channel; null: none
  const float* scale_vec; // requantizing scale (strides scale_sm, scale_sn); null: scale
  const int* y_zp_vec;    // output zero point (strides yzp_sm, yzp_sn); null: y_zp
  long long out_batch;    // element stride of one batch of the output
  long long a_zp_sm, b_zp_sn, scale_sm, scale_sn, yzp_sm, yzp_sn;
  float scale;
  int M, N, K, batch, lda, ldb, b_batched;  // K: the identity's K (a conv's taps x cin_p);
                                            // lda: a matmul's A row stride
  int a_signed, b_signed, out_mode, a_zp, b_zp, y_zp, row_sums;  // out_mode: 0 int32, 1 uint8, 2 int8
  int n_img, H, W, KH, KW, OH, OW, sh, sw, ph, pw, dh, dw, groups, cin_p, cout_g;
  int device;
};

namespace {

constexpr int kBM = 128, kBK = 128, kStages = 4, kLag = 2, kThreads = 384;

// Shared-memory plan of one CTA (offsets from a 1024-byte aligned base): the
// ring of stages (A tile, then B tile, each rows of 128 bytes in TMA's
// 128-byte swizzle), the mbarriers, and per-row tables. The epilogue's staged
// tile reuses the ring.
template <int BN>
struct QLayout {
  static constexpr uint32_t kATile = kBM * kBK;
  static constexpr uint32_t kBTile = BN * kBK;
  static constexpr uint32_t kStage = kATile + kBTile;
  static constexpr uint32_t kBar = kStages * kStage;        // full[kStages], empty[kStages]
  static constexpr uint32_t kRowSum = kBar + 16 * kStages;  // int[kBM]: sum a of a row
  static constexpr uint32_t kRowIh = kRowSum + 4 * kBM;     // conv, int[kBM]: oh * sh - ph
  static constexpr uint32_t kRowIw = kRowIh + 4 * kBM;      // conv, int[kBM]: ow * sw - pw
  static constexpr uint32_t kRowIn = kRowIw + 4 * kBM;      // conv, long long[kBM]: x plane (-1: past M)
  static constexpr uint32_t kRowOut = kRowIn + 8 * kBM;     // conv, long long[kBM]: output offset
  static constexpr uint32_t kColCs = kRowOut + 8 * kBM;     // int[BN]: sum b of a column
  static constexpr uint32_t kColZb = kColCs + 4 * BN;       // int[BN]: b's zero point
  static constexpr uint32_t kSmem = kColZb + 4 * BN + 1024;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void st_shared4(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared1(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_sync() {  // the two consumer warpgroups
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define SMT_REGS32 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" "}"

#define SMT_REGS64 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" "}"

#define SMT_D8(i)                                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])
#define SMT_D32 SMT_D8(0), SMT_D8(8), SMT_D8(16), SMT_D8(24)
#define SMT_D64 SMT_D32, SMT_D8(32), SMT_D8(40), SMT_D8(48), SMT_D8(56)
#define SMT_WGMMA(SHAPE, AT, BT, REGS, IA, IB, IS, ...)                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                              \
               "wgmma.mma_async.sync.aligned." SHAPE ".s32." AT "." BT " " REGS ", %" IA  \
               ", %" IB ", p;\n}\n"                                                       \
               : __VA_ARGS__                                                              \
               : "l"(da), "l"(db), "r"(1))
#define SMT_WGMMA_TYPES(SHAPE, REGS, IA, IB, IS, ...)    \
  if constexpr (UA && UB) {                              \
    SMT_WGMMA(SHAPE, "u8", "u8", REGS, IA, IB, IS, __VA_ARGS__); \
  } else if constexpr (UA) {                             \
    SMT_WGMMA(SHAPE, "u8", "s8", REGS, IA, IB, IS, __VA_ARGS__); \
  } else if constexpr (UB) {                             \
    SMT_WGMMA(SHAPE, "s8", "u8", REGS, IA, IB, IS, __VA_ARGS__); \
  } else {                                               \
    SMT_WGMMA(SHAPE, "s8", "s8", REGS, IA, IB, IS, __VA_ARGS__); \
  }

// D (64 x BN s32) += A (64 x 32 bytes, shared) . B (BN x 32 bytes, shared)^T,
// both K-major in the 128-byte swizzle
template <typename TA, typename TB, int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  constexpr bool UA = std::is_same<TA, uint8_t>::value, UB = std::is_same<TB, uint8_t>::value;
  static_assert(BN == 64 || BN == 128, "tiles are 64 or 128 wide");
  if constexpr (BN == 64) {
    SMT_WGMMA_TYPES("m64n64k32", SMT_REGS32, "32", "33", "34", SMT_D32)
  } else {
    SMT_WGMMA_TYPES("m64n128k32", SMT_REGS64, "64", "65", "66", SMT_D64)
  }
}

// sum of the four bytes of w, as T (uint8_t or int8_t) values, added to acc
template <typename T>
__device__ __forceinline__ int byte_sum(uint32_t w, int acc) {
  if constexpr (std::is_same<T, uint8_t>::value) {
    return (int)__dp4a(w, 0x01010101u, (unsigned)acc);
  } else {
    return __dp4a((int)w, 0x01010101, acc);
  }
}

// The producer warpgroup's im2col gather of a conv's A tile kt into the stage
// at `sa`: a thread covers 16-byte chunk q = lane % 8 of rows
// 32 w + 4 i + lane / 8 (i < 8), so a warp reads four rows' 128 bytes.
template <bool PIECE16>
__device__ __forceinline__ void gather_a(const QArgs& p, const uint8_t* x, uint32_t sa, int kt,
                                         const int* row_ih, const int* row_iw,
                                         const long long* row_in, uint32_t zp4) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int q = lane & 7, rsub = lane >> 3;
  constexpr int kPieces = PIECE16 ? 1 : 4;
#pragma unroll
  for (int e = 0; e < kPieces; ++e) {
    const int k = kt * kBK + q * 16 + (PIECE16 ? 0 : 4 * e);
    const bool kin = k < p.K;
    int c = 0, kh = 0, kw = 0;
    if (kin) {
      const int tap = k / p.cin_p;
      c = k - tap * p.cin_p;
      kh = tap / p.KW;
      kw = tap - kh * p.KW;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = w * 32 + i * 4 + rsub;
      const uint32_t dst = sa + r * kBK + ((q ^ (r & 7)) << 4) + (PIECE16 ? 0 : 4 * e);
      const long long in = row_in[r];
      uint32_t fill = 0;
      bool load = false;
      if (kin && in >= 0) {
        const int ih = row_ih[r] + kh * p.dh, iw = row_iw[r] + kw * p.dw;
        load = ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
        fill = zp4;
        if (load) {
          const uint8_t* src = x + in + ((long long)ih * p.W + iw) * p.cin_p + c;
          if (PIECE16) {
            cp_async16(dst, src);
          } else {
            cp_async4(dst, src);
          }
        }
      }
      if (!load) {
        if (PIECE16) {
          st_shared4(dst, fill);
        } else {
          st_shared1(dst, fill);
        }
      }
    }
  }
}

template <typename TA, typename TB, bool CONV, int BN>
__global__ void __launch_bounds__(kThreads, 1)
qgemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
             const QArgs p) {
  using L = QLayout<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t full = base + L::kBar, empty = full + 8 * kStages;
  int* const row_sum = reinterpret_cast<int*>(gbase + L::kRowSum);
  int* const row_ih = reinterpret_cast<int*>(gbase + L::kRowIh);
  int* const row_iw = reinterpret_cast<int*>(gbase + L::kRowIw);
  long long* const row_in = reinterpret_cast<long long*>(gbase + L::kRowIn);
  long long* const row_out = reinterpret_cast<long long*>(gbase + L::kRowOut);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int nk = (p.K + kBK - 1) / kBK;

  if (CONV && tid < kBM) {
    const int m = m0 + tid;
    if (m < p.M) {
      const int ow = m % p.OW, q = m / p.OW, oh = q % p.OH, img = q / p.OH;
      row_ih[tid] = oh * p.sh - p.ph;
      row_iw[tid] = ow * p.sw - p.pw;
      row_in[tid] = ((long long)img * p.groups + z) * p.H * p.W * p.cin_p;
      row_out[tid] = ((long long)img * p.groups + z) * p.cout_g * p.OH * p.OW +
                     (long long)oh * p.OW + ow;
    } else {
      row_in[tid] = -1;
      row_out[tid] = -1;
    }
  }
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, CONV ? 1 + 128 : 1);  // TMA's arrival (+ the gathering threads)
      mbar_init(empty + 8 * st, 8);                  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int brow = CONV ? z * p.cout_g + n0 : (p.b_batched ? z * p.N : 0) + n0;
    if (!CONV) {
      if (tid == 0) {
        for (int kt = 0; kt < nk; ++kt) {
          const int st = kt % kStages;
          const uint32_t sa = base + st * L::kStage;
          mbar_wait(empty + 8 * st, ((kt / kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * st, L::kStage);
          tma_load_2d(sa, &ta, full + 8 * st, kt * kBK, z * p.M + m0);
          tma_load_2d(sa + L::kATile, &tb, full + 8 * st, kt * kBK, brow);
        }
      }
    } else {
      const uint8_t* x = static_cast<const uint8_t*>(p.a);
      const uint32_t zp4 = (uint32_t)(uint8_t)(p.a_zp_vec ? p.a_zp_vec[0] : p.a_zp) * 0x01010101u;
      const bool piece16 = p.cin_p % 16 == 0;
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kStages;
        const uint32_t sa = base + st * L::kStage;
        mbar_wait(empty + 8 * st, ((kt / kStages) & 1) ^ 1);
        if (tid == 0) {
          mbar_expect_tx(full + 8 * st, L::kBTile);
          tma_load_2d(sa + L::kATile, &tb, full + 8 * st, kt * kBK, brow);
        }
        if (piece16) {
          gather_a<true>(p, x, sa, kt, row_ih, row_iw, row_in, zp4);
        } else {
          gather_a<false>(p, x, sa, kt, row_ih, row_iw, row_in, zp4);
        }
        cp_async_commit();
        if (kt >= kLag) {
          cp_async_wait<kLag>();
          fence_proxy_async();
          mbar_arrive(full + 8 * ((kt - kLag) % kStages));
        }
      }
      cp_async_wait<0>();
      fence_proxy_async();
      for (int kt = nk - kLag > 0 ? nk - kLag : 0; kt < nk; ++kt)
        mbar_arrive(full + 8 * (kt % kStages));
    }
  } else {
    // ---- consumers: 64 rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int c = wg - 1, tc = tid - 128 * wg;
    const int warp = tc >> 5, lane = tc & 31, g = lane >> 2, t4 = lane & 3;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int rs = 0;  // sum a over the half (tc & 1) of row 64 c + tc / 2
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % kStages;
      const uint32_t sa = base + st * L::kStage, sb = sa + L::kATile;
      mbar_wait(full + 8 * st, (kt / kStages) & 1);
      if (p.row_sums) {
        const uint4* row = reinterpret_cast<const uint4*>(gbase + st * L::kStage +
                                                          (64 * c + (tc >> 1)) * kBK) +
                           4 * (tc & 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint4 v = row[i];
          rs = byte_sum<TA>(v.x, rs);
          rs = byte_sum<TA>(v.y, rs);
          rs = byte_sum<TA>(v.z, rs);
          rs = byte_sum<TA>(v.w, rs);
        }
      }
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kBK / 32; ++s)
        wgmma_s8<TA, TB, BN>(acc, smem_desc(sa + 64 * c * kBK + 32 * s, 16, 8 * kBK, 1),
                             smem_desc(sb + 32 * s, 16, 8 * kBK, 1));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    if (p.row_sums && (tc & 1) == 0) row_sum[64 * c + (tc >> 1)] = rs;
    // the tile's columns: sum b and b's zero point
    int* const col_cs = reinterpret_cast<int*>(gbase + L::kColCs);
    int* const col_zb = reinterpret_cast<int*>(gbase + L::kColZb);
    const int cs0 = CONV ? z * p.cout_g + n0 : (p.b_batched ? z * p.N : 0) + n0;
    for (int i = tid - 128; i < BN; i += 256) {
      const int n = n0 + i;
      const bool nin = n < p.N;
      col_cs[i] = nin && p.b_colsum ? p.b_colsum[cs0 + i] : 0;
      col_zb[i] = !nin ? 0 : p.b_zp_vec ? p.b_zp_vec[(CONV ? z * p.cout_g + n : n) * p.b_zp_sn]
                                        : p.b_zp;
    }
    consumer_sync();  // both warpgroups are done with the ring; row and column sums are in

    // ---- epilogue: the identity (and the requantization) ----
    const float lo = p.out_mode == 1 ? 0.f : -128.f, hi = p.out_mode == 1 ? 255.f : 127.f;
    const uint32_t K = (uint32_t)p.K;
    // this thread's two rows: their zero point and sum a
    uint32_t za[2], rsum[2];
    bool m_in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ml = 64 * c + 16 * warp + g + 8 * h, m = m0 + ml;
      m_in[h] = m < p.M;
      za[h] = (uint32_t)(!p.a_zp_vec ? p.a_zp
                         : m_in[h] ? __ldg(p.a_zp_vec + (CONV ? 0 : m) * p.a_zp_sm) : 0);
      rsum[h] = p.row_sums ? (uint32_t)row_sum[ml] : 0u;
    }
    {
      // straight from the accumulators: a lane group's 8 rows (consecutive
      // output pixels of a conv) and 4 column pairs fill whole 32-byte sectors
      const long long plane = (long long)p.OH * p.OW;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int nl = 8 * j + 2 * t4, n = n0 + nl;
        const uint32_t zb[2] = {(uint32_t)col_zb[nl], (uint32_t)col_zb[nl + 1]};
        const uint32_t cs[2] = {(uint32_t)col_cs[nl], (uint32_t)col_cs[nl + 1]};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!m_in[h]) continue;
          const int ml = 64 * c + 16 * warp + g + 8 * h, m = m0 + ml;
          uint32_t v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = (uint32_t)acc[4 * j + 2 * h + e] - zb[e] * rsum[h] - za[h] * cs[e] +
                   K * za[h] * zb[e];
          const long long o = CONV ? row_out[ml] + (long long)n * plane
                                   : (long long)z * p.out_batch + (long long)m * p.N + n;
          const long long step = CONV ? plane : 1;  // between the pair's two columns
          if (p.out_mode == 0) {
            int* const out = static_cast<int*>(p.out);
            if (!CONV && n + 1 < p.N && (p.N & 1) == 0) {
              *reinterpret_cast<int2*>(out + o) = make_int2((int)v[0], (int)v[1]);
            } else {
              if (n < p.N) out[o] = (int)v[0];
              if (n + 1 < p.N) out[o + step] = (int)v[1];
            }
            continue;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (n + e >= p.N) continue;
            const int nc = CONV ? z * p.cout_g + n + e : n + e;
            uint32_t u = v[e];
            if (p.bias) u += (uint32_t)__ldg(p.bias + nc);
            const int mm = CONV ? 0 : m;
            const float sc = p.scale_vec ? __ldg(p.scale_vec + mm * p.scale_sm + nc * p.scale_sn)
                                         : p.scale;
            const int yz =
                p.y_zp_vec ? __ldg(p.y_zp_vec + mm * p.yzp_sm + nc * p.yzp_sn) : p.y_zp;
            float y = __fadd_rn(rintf(__fmul_rn(__int2float_rn((int)u), sc)), (float)yz);
            y = fminf(fmaxf(y, lo), hi);
            if (p.out_mode == 1) {
              static_cast<uint8_t*>(p.out)[o + e * step] = (uint8_t)(int)y;
            } else {
              static_cast<int8_t*>(p.out)[o + e * step] = (int8_t)(int)y;
            }
          }
        }
      }
    }
  }
}

// x (images, groups x cin_g, H, W) as (images, groups, H, W, cin_p): a block
// moves a 4 KB tile of CT channels x 4096 / CT pixels of one image's group
// through shared memory (CT = 64, or cin_p rounded up to a power of two when
// it is smaller, as ResNet-50's stem's 4), reading along the pixels and
// writing four channels a thread; the channels past cin_g are x_zp's byte.
template <int CT>
__global__ void __launch_bounds__(256)
channels_last_kernel(const uint8_t* x, uint8_t* out, const int* zp_vec, int zp, int cin_g,
                     int cin_p, long long hw) {
  constexpr int PT = 4096 / CT;
  __shared__ uint8_t tile[CT][PT + 4];
  const int c0 = blockIdx.y * CT;
  const long long p0 = (long long)blockIdx.x * PT, ig = blockIdx.z;
  const uint8_t fill = (uint8_t)(zp_vec ? zp_vec[0] : zp);
  const uint8_t* src = x + ig * cin_g * hw;
  for (int e = threadIdx.x; e < CT * PT; e += 256) {
    const int c = e / PT, q = e % PT, cc = c0 + c;
    const long long pp = p0 + q;
    tile[c][q] = pp >= hw ? 0 : cc < cin_g ? src[cc * hw + pp] : fill;
  }
  __syncthreads();
  uint8_t* dst = out + ig * hw * cin_p;
  for (int e = threadIdx.x; e < PT * (CT / 4); e += 256) {
    const int q = e / (CT / 4), cq = (e % (CT / 4)) * 4, cc = c0 + cq;
    const long long pp = p0 + q;
    if (pp >= hw || cc >= cin_p) continue;
    *reinterpret_cast<uint32_t*>(dst + pp * cin_p + cc) =
        (uint32_t)tile[cq][q] | (uint32_t)tile[cq + 1][q] << 8 |
        (uint32_t)tile[cq + 2][q] << 16 | (uint32_t)tile[cq + 3][q] << 24;
  }
}

template <int CT>
cudaError_t launch_channels_last(const void* x, void* out, const int* zp, int zp_scalar,
                                 long long nz, int cin_g, int cin_p, long long hw,
                                 cudaStream_t stream) {
  const long long pt = (hw + 4096 / CT - 1) / (4096 / CT);
  if (pt > 0x7fffffffLL || nz > 65535) return cudaErrorInvalidConfiguration;
  channels_last_kernel<CT><<<dim3((unsigned)pt, (cin_p + CT - 1) / CT, (unsigned)nz), 256, 0,
                             stream>>>(static_cast<const uint8_t*>(x),
                                       static_cast<uint8_t*>(out), zp, zp_scalar, cin_g, cin_p,
                                       hw);
  return cudaGetLastError();
}

// Tensor map over `rows` rows of `width` bytes (a multiple of 16), whose box
// is 128 bytes of `box_rows` rows in the 128-byte swizzle; reads past the
// tensor are zeros.
bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, long long width,
              long long rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <typename TA, typename TB, bool CONV, int BN>
cudaError_t launch_tile(const QArgs& p, const CUtensorMap& ta, const CUtensorMap& tb,
                        cudaStream_t stream) {
  auto kern = qgemm_kernel<TA, TB, CONV, BN>;
  LaunchFacts facts;
  cudaError_t err =
      launch_facts(reinterpret_cast<const void*>(kern), kThreads, QLayout<BN>::kSmem, &facts);
  if (err != cudaSuccess) return err;
  const long long mt = (p.M + kBM - 1) / kBM;
  const int nt = (p.N + BN - 1) / BN, nz = CONV ? p.groups : p.batch;
  if (mt > 0x7fffffffLL || nt > 65535 || nz > 65535) return cudaErrorInvalidConfiguration;
  kern<<<dim3((unsigned)mt, nt, nz), kThreads, QLayout<BN>::kSmem, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

// BN by N: 64 for N <= 64, else 128 (a 256-wide tile was measured slower at
// the main path's shapes)
int pick_bn(const QArgs& p) { return p.N <= 64 ? 64 : 128; }

template <typename TA, typename TB, bool CONV>
cudaError_t launch_types(const QArgs& p, const CUtensorMap& ta, const CUtensorMap& tb,
                         cudaStream_t stream, int bn) {
  if (bn == 64) return launch_tile<TA, TB, CONV, 64>(p, ta, tb, stream);
  return launch_tile<TA, TB, CONV, 128>(p, ta, tb, stream);
}

template <bool CONV>
cudaError_t launch(const QArgs& p, cudaStream_t stream) {
  const int nz = CONV ? p.groups : p.batch;
  if (p.M <= 0 || p.N <= 0 || nz <= 0) return cudaSuccess;
  if (p.ldb % 16 || (reinterpret_cast<uintptr_t>(p.bt) & 15) ||
      (!CONV && (p.lda % 16 || (reinterpret_cast<uintptr_t>(p.a) & 15))))
    return cudaErrorMisalignedAddress;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int bn = pick_bn(p);
  const long long b_rows = CONV ? (long long)p.groups * p.cout_g
                                : (long long)(p.b_batched ? p.batch : 1) * p.N;
  CUtensorMap ta, tb;
  if (!make_map(enc, &tb, p.bt, p.ldb, b_rows, bn)) return cudaErrorInvalidValue;
  if (CONV) {
    ta = tb;  // unused: a conv gathers its A
  } else if (!make_map(enc, &ta, p.a, p.lda, (long long)p.batch * p.M, kBM)) {
    return cudaErrorInvalidValue;
  }
  if (p.a_signed && p.b_signed) return launch_types<int8_t, int8_t, CONV>(p, ta, tb, stream, bn);
  if (p.a_signed) return launch_types<int8_t, uint8_t, CONV>(p, ta, tb, stream, bn);
  if (p.b_signed) return launch_types<uint8_t, int8_t, CONV>(p, ta, tb, stream, bn);
  return launch_types<uint8_t, uint8_t, CONV>(p, ta, tb, stream, bn);
}

template <bool CONV>
int entry(QArgs* a, void* stream) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != a->device && (err = cudaSetDevice(a->device)) != cudaSuccess) return (int)err;
  err = launch<CONV>(*a, (cudaStream_t)stream);
  if (prev != a->device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

extern "C" int smt_qmatmul(QArgs* a, void* stream) { return entry<false>(a, stream); }

extern "C" int smt_qconv(QArgs* a, void* stream) { return entry<true>(a, stream); }

// x (images, groups x cin_g, H, W) uint8 / int8 into out (images, groups, H,
// W, cin_p), cin_p a multiple of 4 and out 4-byte aligned; the padded
// channels take *zp (zp null: zp_scalar).
extern "C" int smt_qchannels_last(const void* x, void* out, const int* zp, int zp_scalar,
                                  int n_img, int groups, int cin_g, int cin_p, long long hw,
                                  int device, void* stream) {
  if (n_img <= 0 || hw <= 0 || cin_p <= 0) return (int)cudaSuccess;
  if (cin_p % 4 || cin_p < cin_g || (reinterpret_cast<uintptr_t>(out) & 3))
    return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const long long nz = (long long)n_img * groups;
  cudaStream_t s = (cudaStream_t)stream;
  err = cin_p <= 4    ? launch_channels_last<4>(x, out, zp, zp_scalar, nz, cin_g, cin_p, hw, s)
        : cin_p <= 8  ? launch_channels_last<8>(x, out, zp, zp_scalar, nz, cin_g, cin_p, hw, s)
        : cin_p <= 16 ? launch_channels_last<16>(x, out, zp, zp_scalar, nz, cin_g, cin_p, hw, s)
        : cin_p <= 32 ? launch_channels_last<32>(x, out, zp, zp_scalar, nz, cin_g, cin_p, hw, s)
                      : launch_channels_last<64>(x, out, zp, zp_scalar, nz, cin_g, cin_p, hw, s);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
