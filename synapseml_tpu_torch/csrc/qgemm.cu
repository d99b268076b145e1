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
// operands go to the tensor cores as they are (mma.sync m16n8k32, s32
// accumulation, in all four signedness pairs), and the zero points enter in
// the epilogue:
//   sum_k (a - za)(b - zb) = sum ab - zb * sum a - za * sum b + K * za * zb,
// taken in uint32 arithmetic, so the result equals the reference's int32 sum
// modulo 2^32 exactly, as XLA's int32 sum (and mma.sync's) wraps. The row
// sums of A and column sums of B are taken from the shared-memory tiles with
// dp4a as the tiles go by.
//
// smt_qmatmul: C[z, m, n] = sum_k A[z, m, k] B[z, k, n] over a batch z (a
// batch stride of 0 broadcasts an operand); a 1-D a zero point lies along M,
// a 1-D b zero point along N (the ONNX spec's rule).
// smt_qconv: NCHW x OIHW convolution with strides, dilations, groups and the
// resolved begin pads (the end pads are implied by OH, OW) as a GEMM per
// group: M = images x OH x OW, N = output channels of the group, K = input
// channels of the group x KH x KW. A padded tap is the raw value x_zp (real
// zero, as in the reference, ops.py:799-801), not raw 0. The w zero point may
// be per output channel.
//
// Epilogue (out_mode 1 / 2, QLinearMatMul / QLinearConv): add the optional
// int32 bias (per output channel, wrapping as int32 does), multiply by the f32
// scale that the wrapper computed in the reference's op order
// ((x_scale * w_scale) / y_scale, ops.py:839-840, :864-865), round half to
// even (rintf), add y_zp in f32, saturate to uint8 / int8. out_mode 0 writes
// the int32 sum.
//
// Bound on the H100: operations, 2 M N K at the int8 tensor-core rate, at
// BERT-base's projections; bytes (each operand read once, the output written
// once) at small K. This first design is right and simple: a 128 x 128 tile
// a block, k in steps of 64 through one shared-memory stage (no cp.async
// pipeline), 8 warps of 64 x 32 each; operands that are k-contiguous and
// 16-byte aligned load 16 bytes a thread, the rest (B of a matmul, the
// im2col gather of a convolution) a byte a thread, neighbouring threads on
// neighbouring addresses. wgmma with TMA is the later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

struct QArgs {
  const void* a;          // A: (batch, M, K) of a matmul; x (images, C, H, W) of a conv
  const void* b;          // B: (batch, K, N) strided; w (Cout, Cin / groups, KH, KW)
  void* out;              // (batch, M, N) int32 / uint8 / int8; (images, Cout, OH, OW)
  const int* a_zp_vec;    // zero point of A along m (stride a_zp_sm); null: a_zp
  const int* b_zp_vec;    // zero point of B along the output channel (stride b_zp_sn); null: b_zp
  const int* bias;        // int32 per output channel; null: none
  const float* scale_vec; // requantizing scale (strides scale_sm, scale_sn); null: scale
  const int* y_zp_vec;    // output zero point (strides yzp_sm, yzp_sn); null: y_zp
  long long a_batch, b_batch, out_batch;  // element strides of one batch (0: broadcast)
  long long lda, ldb_k, ldb_n;            // A's row stride; B's strides along k and n
  long long a_zp_sm, b_zp_sn, scale_sm, scale_sn, yzp_sm, yzp_sn;
  float scale;
  int M, N, K, batch;
  int a_signed, b_signed, out_mode;       // out_mode: 0 int32, 1 uint8, 2 int8
  int a_zp, b_zp, y_zp;
  int n_img, C, H, W, KH, KW, OH, OW, sh, sw, ph, pw, dh, dw, groups, cin_g, cout_g;
  int device;
};

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kLds = kBK + 16;  // 80-byte rows: the fragment reads of a warp hit 32 banks
constexpr int kThreads = 256;

template <typename TA, typename TB>
__device__ __forceinline__ void mma_k32(int* d, const uint32_t* a, const uint32_t* b) {
#define SMT_QMMA(AT, BT)                                                                   \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." AT "." BT                         \
               ".s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"              \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))
  if constexpr (std::is_same<TA, uint8_t>::value && std::is_same<TB, uint8_t>::value) {
    SMT_QMMA("u8", "u8");
  } else if constexpr (std::is_same<TA, uint8_t>::value) {
    SMT_QMMA("u8", "s8");
  } else if constexpr (std::is_same<TB, uint8_t>::value) {
    SMT_QMMA("s8", "u8");
  } else {
    SMT_QMMA("s8", "s8");
  }
#undef SMT_QMMA
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

// A tile (kBM rows of M, kBK of K) into shared memory, rows k-contiguous.
template <typename TA, bool CONV>
__device__ __forceinline__ void load_a(const QArgs& p, const uint8_t* a, uint8_t* As, int m0,
                                       int k0, int g, bool vec) {
  const int t = threadIdx.x;
  if (!CONV && vec) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = i * kThreads + t, row = e >> 2, kq = (e & 3) * 16;
      const int m = m0 + row, k = k0 + kq;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < p.M && k < p.K) v = *reinterpret_cast<const uint4*>(a + m * p.lda + k);
      *reinterpret_cast<uint4*>(As + row * kLds + kq) = v;
    }
    return;
  }
  if (!CONV) {
    // k-fast: a thread keeps one k, rows in steps of 4
    const int kl = t & 63, k = k0 + kl;
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      const int row = 4 * i + (t >> 6), m = m0 + row;
      uint8_t v = 0;
      if (m < p.M && k < p.K) v = a[m * p.lda + k];
      As[row * kLds + kl] = v;
    }
    return;
  }
  // im2col gather, m-fast: a thread keeps one output pixel
  const int row = t & (kBM - 1), m = m0 + row;
  const int khw = p.KH * p.KW;
  int img = 0, oh = 0, ow = 0;
  const bool live = m < p.M;
  if (live) {
    ow = m % p.OW;
    const int q = m / p.OW;
    oh = q % p.OH;
    img = q / p.OH;
  }
  const uint8_t pad = (uint8_t)(p.a_zp_vec ? p.a_zp_vec[0] : p.a_zp);  // real zero
  const uint8_t* xg = a + ((long long)img * p.C + (long long)g * p.cin_g) * p.H * p.W;
  const int ih0 = oh * p.sh - p.ph, iw0 = ow * p.sw - p.pw;
#pragma unroll 4
  for (int i = 0; i < 32; ++i) {
    const int kl = 2 * i + (t >> 7), k = k0 + kl;
    uint8_t v = 0;
    if (live && k < p.K) {
      const int c = k / khw, r = k - c * khw;
      const int kh = r / p.KW, kw = r - kh * p.KW;
      const int ih = ih0 + kh * p.dh, iw = iw0 + kw * p.dw;
      v = (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
              ? xg[((long long)c * p.H + ih) * p.W + iw] : pad;
    }
    As[row * kLds + kl] = v;
  }
}

// B tile (kBN columns of N, kBK of K) into shared memory, columns k-contiguous.
template <bool CONV>
__device__ __forceinline__ void load_b(const QArgs& p, const uint8_t* b, uint8_t* Bs, int n0,
                                       int k0, int g, bool vec) {
  const int t = threadIdx.x;
  if (CONV) {
    const uint8_t* wg = b + (long long)g * p.cout_g * p.K;
    if (vec) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = i * kThreads + t, col = e >> 2, kq = (e & 3) * 16;
        const int n = n0 + col, k = k0 + kq;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n < p.N && k < p.K) v = *reinterpret_cast<const uint4*>(wg + (long long)n * p.K + k);
        *reinterpret_cast<uint4*>(Bs + col * kLds + kq) = v;
      }
      return;
    }
    const int kl = t & 63, k = k0 + kl;
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      const int col = 4 * i + (t >> 6), n = n0 + col;
      uint8_t v = 0;
      if (n < p.N && k < p.K) v = wg[(long long)n * p.K + k];
      Bs[col * kLds + kl] = v;
    }
    return;
  }
  // matmul B (K, N): n-fast, a thread keeps one column
  const int col = t & (kBN - 1), n = n0 + col;
#pragma unroll 4
  for (int i = 0; i < 32; ++i) {
    const int kl = 2 * i + (t >> 7), k = k0 + kl;
    uint8_t v = 0;
    if (n < p.N && k < p.K) v = b[k * p.ldb_k + n * p.ldb_n];
    Bs[col * kLds + kl] = v;
  }
}

template <typename TA, typename TB, bool CONV>
__global__ void __launch_bounds__(kThreads) qgemm_kernel(const QArgs p) {
  __shared__ __align__(16) uint8_t As[kBM * kLds];
  __shared__ __align__(16) uint8_t Bs[kBN * kLds];
  __shared__ int row_sum[kBM];
  __shared__ int col_sum[kBN];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm = warp & 1, wn = warp >> 1;   // 2 x 4 warps of 64 x 32
  const int gq = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, z = blockIdx.z;
  const int g = CONV ? z : 0;
  const uint8_t* a = static_cast<const uint8_t*>(p.a) + (CONV ? 0 : z * p.a_batch);
  const uint8_t* b = static_cast<const uint8_t*>(p.b) + (CONV ? 0 : z * p.b_batch);
  const bool vec_a = !CONV && p.K % 16 == 0 && p.lda % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool vec_b = CONV && p.K % 16 == 0 && (reinterpret_cast<uintptr_t>(p.b) & 15) == 0 &&
                     ((long long)p.cout_g * p.K) % 16 == 0;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  int rsum = 0, csum = 0;   // this thread's half of row / column (t >> 1) of the tile

  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    load_a<TA, CONV>(p, a, As, m0, k0, g, vec_a);
    load_b<CONV>(p, b, Bs, n0, k0, g, vec_b);
    __syncthreads();
    {
      const int r = t >> 1, h = (t & 1) * 32;
      const uint32_t* ra = reinterpret_cast<const uint32_t*>(As + r * kLds + h);
      const uint32_t* rb = reinterpret_cast<const uint32_t*>(Bs + r * kLds + h);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        rsum = byte_sum<TA>(ra[w], rsum);
        csum = byte_sum<TB>(rb[w], csum);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* r0 = As + (wm * 64 + mi * 16 + gq) * kLds + kk + t4 * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * kLds);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * kLds + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* c0 = Bs + (wn * 32 + ni * 8 + gq) * kLds + kk + t4 * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(c0);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(c0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_k32<TA, TB>(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }
  rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
  csum += __shfl_xor_sync(0xffffffffu, csum, 1);
  if ((t & 1) == 0) {
    row_sum[t >> 1] = rsum;
    col_sum[t >> 1] = csum;
  }
  __syncthreads();

  const int cout = CONV ? p.groups * p.cout_g : p.N;
  const float lo = p.out_mode == 1 ? 0.f : -128.f, hi = p.out_mode == 1 ? 255.f : 127.f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ml = wm * 64 + mi * 16 + gq + half * 8, m = m0 + ml;
      if (m >= p.M) continue;
      const uint32_t za = (uint32_t)(p.a_zp_vec ? p.a_zp_vec[(CONV ? 0 : m) * p.a_zp_sm] : p.a_zp);
      long long obase;
      long long ostep;   // element step of the output between neighbouring n
      if (CONV) {
        const int ow = m % p.OW, q = m / p.OW, oh = q % p.OH, img = q / p.OH;
        obase = (((long long)img * cout + (long long)g * p.cout_g) * p.OH + oh) * p.OW + ow;
        ostep = (long long)p.OH * p.OW;
      } else {
        obase = (long long)z * p.out_batch + (long long)m * p.N;
        ostep = 1;
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nl = wn * 32 + ni * 8 + t4 * 2 + e, n = n0 + nl;
          if (n >= p.N) continue;
          const int nc = CONV ? g * p.cout_g + n : n;   // output channel / column
          const uint32_t zb = (uint32_t)(p.b_zp_vec ? p.b_zp_vec[nc * p.b_zp_sn] : p.b_zp);
          uint32_t v = (uint32_t)acc[mi][ni][half * 2 + e] - zb * (uint32_t)row_sum[ml] -
                       za * (uint32_t)col_sum[nl] + (uint32_t)p.K * za * zb;
          const long long o = obase + (long long)n * ostep;
          if (p.out_mode == 0) {
            static_cast<int*>(p.out)[o] = (int)v;
            continue;
          }
          if (p.bias) v += (uint32_t)p.bias[nc];
          const float s = p.scale_vec ? p.scale_vec[m * p.scale_sm + nc * p.scale_sn] : p.scale;
          const int yz = p.y_zp_vec ? p.y_zp_vec[m * p.yzp_sm + nc * p.yzp_sn] : p.y_zp;
          float y = __fadd_rn(rintf(__fmul_rn(__int2float_rn((int)v), s)), (float)yz);
          y = fminf(fmaxf(y, lo), hi);
          if (p.out_mode == 1) {
            static_cast<uint8_t*>(p.out)[o] = (uint8_t)(int)y;
          } else {
            static_cast<int8_t*>(p.out)[o] = (int8_t)(int)y;
          }
        }
      }
    }
  }
}

template <bool CONV>
cudaError_t launch(const QArgs& p, cudaStream_t stream) {
  const long long mt = (p.M + kBM - 1) / kBM;
  const int nt = (p.N + kBN - 1) / kBN;
  const int nz = CONV ? p.groups : p.batch;
  if (p.M <= 0 || p.N <= 0 || nz <= 0) return cudaSuccess;
  if (mt > 0x7fffffffLL || nt > 65535 || nz > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)mt, (unsigned)nt, (unsigned)nz);
  if (p.a_signed && p.b_signed) {
    qgemm_kernel<int8_t, int8_t, CONV><<<grid, kThreads, 0, stream>>>(p);
  } else if (p.a_signed) {
    qgemm_kernel<int8_t, uint8_t, CONV><<<grid, kThreads, 0, stream>>>(p);
  } else if (p.b_signed) {
    qgemm_kernel<uint8_t, int8_t, CONV><<<grid, kThreads, 0, stream>>>(p);
  } else {
    qgemm_kernel<uint8_t, uint8_t, CONV><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
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

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
