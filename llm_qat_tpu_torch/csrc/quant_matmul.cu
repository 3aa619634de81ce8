// Dequantize-and-multiply GEMM for int8 and nibble-packed int4 weights, for
// sm_90a.
//
// Replaces two Pallas kernels of llm_qat_tpu/ops/quant_matmul.py:
// `_int8_kernel` (called by `quant_matmul_int8`, kernel #10) and
// `_int4_kernel` (called by `quant_matmul_int4`, kernel #11):
//     out[M,N] = (bf16(x)[M,K] . bf16(codes)[K,N]) * scale[N]
// with float32 sums and the per-column scale applied after the sum. One
// kernel serves both, templated on how it decodes a weight byte: int8 codes
// (K, N), or (K/2, N) bytes whose low nibble holds row 2k and high nibble
// row 2k + 1, each as q + 8. The Python wrappers are
// llm_qat_tpu_torch/ops/quant_matmul.py::quant_matmul_int8 and
// ::quant_matmul_int4, with their plain PyTorch versions beside them.
//
// Codes in [-127, 127] are exact in bf16 and a bf16 x bf16 product is exact
// in float32, as the MXU dot with a float32 result is, so the kernel and its
// plain version differ by the order of the float32 sums only.
//
// Bound. The kernel must read x (2MK bytes as bf16), the codes (KN or KN/2
// bytes) and the scales, and write the float32 output (4MN bytes); it does
// 2MNK operations. For decode (M = 8) that is bytes: the GPT-2 QKV weight
// (768 x 2304 int8, 1.8 MB) alone takes 0.53 us at 3.35 TB/s. At the
// prefill's M = 1024 the two bounds meet (3.7 us each at (768, 2304)).
//
// Design (a plain tiled one): one block of 128 threads per 64 x 64 output
// tile, the reduction in steps of 32 through shared memory. Each step stages
// the bf16 activation tile and decodes the weight tile to bf16 (transposed
// to k-contiguous rows, row pitch 40 bf16), then four warps (2 x 2, each
// 32 x 32) run mma.sync m16n8k16 with float32 accumulators. Each thread
// issues all its global loads of a step before its first shared store. Rows
// past M and columns past N are masked, so any M and N work; K must be even.
// No split-K and no pipelining: at M = 8 the grid is N/64 blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BM 64
#define BN 64
#define BK 32
#define NT 128
#define LDS (BK + 8)

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

typedef __nv_bfloat16 bf16;

// The codes of rows k and k + 1 (k even) of column n, as floats.
struct DecodeInt8 {
  static __device__ __forceinline__ float2 pair(const uint8_t* __restrict__ w, int N, int k,
                                                int n) {
    const int8_t* c = reinterpret_cast<const int8_t*>(w);
    return make_float2((float)c[(size_t)k * N + n], (float)c[(size_t)(k + 1) * N + n]);
  }
};

struct DecodeInt4 {
  static __device__ __forceinline__ float2 pair(const uint8_t* __restrict__ w, int N, int k,
                                                int n) {
    const int p = w[(size_t)(k >> 1) * N + n];
    return make_float2((float)((p & 0xF) - 8), (float)(((p >> 4) & 0xF) - 8));
  }
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Pairs each thread stages per tile: BM * BK / 2 / NT (= BN * BK / 2 / NT).
#define PAIRS (BM * BK / 2 / NT)

template <typename Dec>
__global__ void __launch_bounds__(NT)
qmm(const bf16* __restrict__ x, const uint8_t* __restrict__ w, const float* __restrict__ scale,
    float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) bf16 As[BM * LDS];
  __shared__ __align__(16) bf16 Bs[BN * LDS];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    uint32_t av[PAIRS];
    float2 bv[PAIRS];
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = tid + i * NT;
      const int r = p / (BK / 2), gk = k0 + 2 * (p % (BK / 2));
      av[i] = (m0 + r < M && gk < K) ? ld32(x + (size_t)(m0 + r) * K + gk) : 0u;
      // B: thread keeps column c; K is even, so a pair is in or out whole
      const int c = tid % BN, kk = k0 + 2 * (tid / BN + i * (NT / BN));
      bv[i] = (n0 + c < N && kk < K) ? Dec::pair(w, N, kk, n0 + c) : make_float2(0.f, 0.f);
    }
    __syncthreads();  // the previous step's fragments are read
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = tid + i * NT;
      *reinterpret_cast<uint32_t*>(As + (p / (BK / 2)) * LDS + 2 * (p % (BK / 2))) = av[i];
      const int c = tid % BN, kk = 2 * (tid / BN + i * (NT / BN));
      *reinterpret_cast<__nv_bfloat162*>(Bs + c * LDS + kk) =
          __floats2bfloat162_rn(bv[i].x, bv[i].y);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* p = As + (wm * 32 + mi * 16 + g) * LDS + ks + 2 * t;
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * LDS);
        a[mi][2] = ld32(p + 8);
        a[mi][3] = ld32(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* p = Bs + (wn * 32 + ni * 8 + g) * LDS + ks + 2 * t;
        b[ni][0] = ld32(p);
        b[ni][1] = ld32(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc + (mi * 4 + ni) * 4, a[mi], b[ni]);
    }
  }
  // acc[(mi*4 + ni)*4 + h*2 + c]: row g + 8h, column 2t + c of tile (mi, ni)
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int mi = e >> 4, ni = (e >> 2) & 3, h = (e >> 1) & 1, c = e & 1;
    const int gm = m0 + wm * 32 + mi * 16 + g + 8 * h;
    const int gn = n0 + wn * 32 + ni * 8 + 2 * t + c;
    if (gm < M && gn < N) out[(size_t)gm * N + gn] = __fmul_rn(acc[e], scale[gn]);
  }
}

// out (M, N) float32 = (x (M, K) bf16 . codes) * scale (N,) float32. bits 8:
// w is (K, N) int8; bits 4: (K/2, N) bytes of two +8 nibbles. K even.
extern "C" int quant_matmul(const void* x, const void* w, const float* scale, float* out, int M,
                            int K, int N, int bits, cudaStream_t stream) {
  if (K % 2 || M < 1 || N < 1 || (bits != 8 && bits != 4)) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  if (bits == 8)
    qmm<DecodeInt8><<<grid, NT, 0, stream>>>(xb, wb, scale, out, M, K, N);
  else
    qmm<DecodeInt4><<<grid, NT, 0, stream>>>(xb, wb, scale, out, M, K, N);
  return (int)cudaGetLastError();
}
