// Fused QAT linear for sm_90a: the SP training forward and its two
// backward products, with the weight fake-quant.
//
// Replaces three Pallas kernels of llm_qat_tpu/ops/fused_linear.py:
// - `_fwd_kernel` (called by `_fwd_call`) with `fused_linear_fwd`:
//     out[M,N] = xq[M,K] . cdt(FQ(w[K,N])) + s * xa[M,r] . bq[r,N] + bias[N];
// - `_bwd_dx_kernel` (called by `_bwd_dx_call`) with `fused_linear_bwd_dx`:
//     dxq[M,K] = g[M,N] . cdt(FQ(w))^T,  dxa[M,r] = s * g . bq^T;
// - `_bwd_dw_kernel` (called by `_bwd_dw_call`) with `fused_linear_bwd_dw`:
//     dw[K,N] = STE_w(xq^T . g), the +-10 clamp iff kind = log and bits < 32.
// The Python wrappers are llm_qat_tpu_torch/ops/fused_linear.py::
// fused_linear_fwd, ::fused_linear_bwd_dx, ::fused_linear_bwd_dw and, for
// the weight prologue of the first two, ::fq_weight; the `*_plain`
// functions beside them compute the same functions in plain PyTorch.
//
// xq, xa, bq and g are in the operand type (bf16, or float when
// compute_dtype is float32); w, its per-column scale/zero-point vectors, the
// bias and every output are float32. bits, kind and the LoRA scaling s are
// read from a (4,) float32 device tensor (the JAX kernels' SMEM scalars), so
// one build serves every precision slot and switching precision needs no
// host sync.
//
// FQ follows the JAX `_fq_tile` (not `fake_quant_flat`: its symmetric log
// code normalizes as qv/(2n) + 0.5) operation by operation, each rounded on
// its own as PyTorch's elementwise ops are: IEEE division, rintf (round half
// to even, as jnp.round), log2f/exp2f without fast math, and the
// __fmul_rn/__fadd_rn intrinsics where a product feeds a sum, so that nvcc
// contracts nothing into an FMA. The weight codes therefore equal those of
// the plain version on the card, and kernel and plain differ only in the
// order of the float32 sums.
//
// Design, bf16 operands (the training path's compute dtype):
// - The TPU kernels keep w's whole K (or N) strip in VMEM and rerun the
//   fake-quant on it for every M block. Shared memory cannot hold such a
//   strip (786 KB at K = 3072), so here `fl_fq_weight` fake-quantizes each
//   weight exactly once per call and writes cdt(FQ(w)) to a bf16 workspace
//   in the layout its GEMM reads K-major: WqT (N, K) for #14, with bq^T
//   (N, r) from the same launch, and Wq (K, N) for #15. Unlike on the TPU,
//   the quantized weight goes to device memory, once, in bf16 (at most
//   4.7 MB at GPT-2's shapes, so it stays in the 50 MB L2 for the GEMM).
// - One GEMM, C[M, n] = A[M, R] . B[n, R]^T with both operands K-major
//   (`gemm_tile`), serves both kernels: one block of 288 threads per
//   128 x 128 output tile, two blocks to an SM. The first thread of warp 8
//   is the producer and keeps a ring of 3 shared-memory stages (32 KB
//   each) filled by TMA (cp.async.bulk.tensor, 128-byte swizzle, one
//   mbarrier per stage for "full" and one for "empty"); warpgroups 0 and 1
//   each own 64 rows and run wgmma.mma_async m64n128k16 (bf16 in, float32
//   accumulators in registers; a bf16 product is exact in float32, as the
//   MXU dot's), one commit group per 64-wide step, keeping one group in
//   flight. With two blocks on an SM one block's epilogue overlaps the
//   other's products (on an H100 this was faster at every GPT-2 shape than
//   one block of three warpgroups with a 5-stage ring). TMA fills
//   out-of-range rows and columns with zeros, so any M works; global
//   strides must be multiples of 16 bytes, so K, N and r are multiples of 8
//   (the wrappers raise otherwise).
// - Each bf16 entry point launches the prologue and its GEMM from one host
//   call, into a workspace the wrapper allocates, so that a wrapper call
//   costs the host one C call.
// - #14: the LoRA steps (xa against bq^T) run first; after them the
//   accumulators are scaled by s in registers, then the K steps (xq
//   against WqT) accumulate on top, and the epilogue adds the bias.
// - #15: blocks x < ceil(K/128) are dxq tiles (g against Wq), the rest dxa
//   tiles (g against bq, scaled by s after the sum).
// - Epilogue: float32 stores straight from the accumulators, masked at the
//   ragged M and n edges.
//
// float operands (compute_dtype float32, off the main path) keep the plain
// tiled design: one block of 256 threads per 128 x 128 output tile, the
// reduction in steps of 32 through shared memory, the float32 w tile
// fake-quantized while it is staged, float32 FMA on the CUDA cores (each
// thread an 8 x 8 patch). #16 (`fl_bwd_dw`, both types) does the same with
// mma.sync m16n8k16 for bf16: one block per (K tile, N tile) and chunk of
// M, both operands transposed while staged; when the (K, N) tiles alone
// would not fill the card, M is cut into chunks whose partial sums go to a
// float32 workspace that a second kernel sums in a fixed order and clamps
// (no atomics, deterministic).
//
// Bounds, at the GPT-2 124M training shapes (M = 8192, r = 64, bf16):
// #14 reads xq, w, xa, bq once and writes out (2MK + 4KN + 2Mr + 2rN + 4MN
// bytes) and does 2MN(K + r) flops; at (K, N) = (768, 3072) that is
// 124 MB (37 us at 3.35 TB/s) against 41.9 GFLOP (42 us at 989 TFLOP/s):
// close to balanced, bound by operations at three of the four GPT-2 shapes
// and by bytes at (768, 768). #15 moves 2MN + 4KN + 2rN + 4MK + 4Mr bytes
// for the same flops; #16 moves 2MK + 2MN + 4KN bytes for 2MKN flops. The
// prologue adds 4KN read and 2KN written (14 MB at (768, 3072), 4 us), and
// the GEMM re-reads A once per 128-column tile of the output (from L2).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <initializer_list>

#define TILE 128    // output tile rows and columns
#define BK 32       // reduction step
#define NT 256      // threads per block
#define KIND_LOG 1.0f

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// Row pitch of the shared tiles, in elements: 40 bf16 (20 words: the 8 rows
// a fragment load touches fall in distinct banks) or 33 float.
template <typename T>
struct Pitch;
template <>
struct Pitch<bf16> { static constexpr int value = BK + 8; };
template <>
struct Pitch<float> { static constexpr int value = BK + 1; };

// ---------------------------------------------------------------------------
// The weight fake-quant (the JAX `_fq_tile`, one element)
// ---------------------------------------------------------------------------

struct FQ {
  float bits, kind;
  bool symmetric;
  float eps;

  // w fake-quantized with its column's (scale, zp); for the log kind scale
  // holds log_range and zp log_min. Pass-through at bits >= 32.
  __device__ __forceinline__ float operator()(float w, float scale, float zp) const {
    if (bits >= 32.f) return w;
    if (kind != KIND_LOG) {
      if (symmetric) {
        const float qmax = exp2f(__fsub_rn(bits, 1.f)) - 1.f;
        const float q = fminf(fmaxf(rintf(__fdiv_rn(w, scale)), -qmax), qmax);
        return __fmul_rn(q, scale);
      }
      const float qmax = exp2f(bits) - 1.f;
      const float q = fminf(fmaxf(rintf(__fadd_rn(__fdiv_rn(w, scale), zp)), 0.f), qmax);
      return __fmul_rn(__fsub_rn(q, zp), scale);
    }
    const float log_range = scale, log_min = zp;
    if (fabsf(w) < eps) return 0.f;
    const float sign = w > 0.f ? 1.f : -1.f;
    const float la = log2f(fmaxf(fabsf(w), eps));
    const float ln =
        fminf(fmaxf(__fdiv_rn(__fsub_rn(la, log_min), fmaxf(log_range, eps)), 0.f), 1.f);
    float qn;
    if (symmetric) {
      const float nl = exp2f(__fsub_rn(bits, 1.f)) - 1.f;
      const float qv =
          fminf(fmaxf(rintf(__fmul_rn(__fmul_rn(__fsub_rn(ln, 0.5f), 2.f), nl)), -nl), nl);
      qn = __fadd_rn(__fdiv_rn(qv, __fmul_rn(2.f, nl)), 0.5f);
    } else {
      const float full = exp2f(bits) - 1.f;
      const float qc = fminf(fmaxf(rintf(__fmul_rn(ln, full)), 0.f), full);
      qn = __fdiv_rn(qc, full);
    }
    return __fmul_rn(exp2f(__fadd_rn(__fmul_rn(qn, log_range), log_min)), sign);
  }
};

// Elementwise transforms applied while staging: the identity, and the
// weight fake-quant with the scales of the source column.
struct Identity {
  __device__ __forceinline__ float operator()(float v, int) const { return v; }
};

struct WeightFQ {
  FQ fq;
  const float* ws;
  const float* wz;
  __device__ __forceinline__ float operator()(float v, int col) const {
    return fq(v, __ldg(ws + col), __ldg(wz + col));
  }
};

// ---------------------------------------------------------------------------
// Staging into shared memory (k-contiguous tiles of TILE rows x BK)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st_pair(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}
__device__ __forceinline__ void st_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Each thread stages STAGE_PAIRS pairs of a tile. All of its global loads
// are issued before the first shared-memory store, so that they are in
// flight together (one memory latency per tile, not one per pair).
#define STAGE_PAIRS (TILE * BK / 2 / NT)

// dst[r][k] = op(src[r0 + r][k0 + k]) for r < TILE, k < BK: the source is
// already k-contiguous (row stride ld). Zero outside rows x cols. op takes
// the value and its source column.
template <typename T, typename S, typename Op>
__device__ __forceinline__ void stage_direct(T* dst, const S* __restrict__ src, int ld,
                                             int rows, int r0, int cols, int k0, Op op) {
  constexpr int LDS = Pitch<T>::value;
  float2 v[STAGE_PAIRS];
#pragma unroll
  for (int i = 0; i < STAGE_PAIRS; ++i) {
    const int p = threadIdx.x + i * NT;
    const int gr = r0 + p / (BK / 2), gk = k0 + 2 * (p % (BK / 2));
    // cols is even: a pair is in or out as a whole
    v[i] = (gr < rows && gk < cols) ? ld_pair(src + (size_t)gr * ld + gk)
                                    : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < STAGE_PAIRS; ++i) {
    const int p = threadIdx.x + i * NT;
    const int r = p / (BK / 2), k = 2 * (p % (BK / 2));
    const bool in = r0 + r < rows && k0 + k < cols;
    st_pair(dst + r * LDS + k, in ? op(v[i].x, k0 + k) : 0.f,
            in ? op(v[i].y, k0 + k + 1) : 0.f);
  }
}

// dst[c][k] = op(src[k0 + k][c0 + c]) for c < TILE, k < BK: the source's
// rows are the reduction (row stride ld), so the tile is transposed. Each
// thread keeps one column c and takes pairs of reduction rows.
template <typename T, typename S, typename Op>
__device__ __forceinline__ void stage_trans(T* dst, const S* __restrict__ src, int ld,
                                            int rows, int k0, int cols, int c0, Op op) {
  constexpr int LDS = Pitch<T>::value;
  const int c = threadIdx.x % TILE, gc = c0 + c;
  float v[2 * STAGE_PAIRS];
#pragma unroll
  for (int i = 0; i < 2 * STAGE_PAIRS; ++i) {
    const int gk = k0 + 2 * ((threadIdx.x + (i / 2) * NT) / TILE) + (i & 1);
    v[i] = (gc < cols && gk < rows) ? to_f(src[(size_t)gk * ld + gc]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < STAGE_PAIRS; ++i) {
    const int k = 2 * ((threadIdx.x + i * NT) / TILE), gk = k0 + k;
    st_pair(dst + c * LDS + k, (gc < cols && gk < rows) ? op(v[2 * i], gc) : 0.f,
            (gc < cols && gk + 1 < rows) ? op(v[2 * i + 1], gc) : 0.f);
  }
}

// ---------------------------------------------------------------------------
// The tile product: acc += A . B^T over one BK step, A and B k-contiguous
// ---------------------------------------------------------------------------

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

// bf16: warp (wm, wn) of 2 x 4 owns rows wm*64 + [0, 64) and columns
// wn*32 + [0, 32): 4 x 4 m16n8 tiles, acc[(mi*4 + ni)*4 + c] in mma.sync's
// C layout.
__device__ __forceinline__ void tile_product(const bf16* As, const bf16* Bs, float* acc) {
  constexpr int LDS = Pitch<bf16>::value;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const bf16* p = As + (wm * 64 + mi * 16 + g) * LDS + ks + 2 * t;
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
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc + (mi * 4 + ni) * 4, a[mi], b[ni]);
  }
}

// float: thread (ty, tx) of 16 x 16 owns rows ty + 16 i and columns
// tx + 16 j, acc[i*8 + j], as float32 FMA.
__device__ __forceinline__ void tile_product(const float* As, const float* Bs, float* acc) {
  constexpr int LDS = Pitch<float>::value;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * LDS + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = Bs[(tx + 16 * j) * LDS + k];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(a[i], b[j], acc[i * 8 + j]);
  }
}

// (row, col) in the tile of the thread's accumulator e.
__device__ __forceinline__ void owner(const bf16*, int e, int& row, int& col) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = e >> 4, ni = (e >> 2) & 3, h = (e >> 1) & 1, c = e & 1;
  row = (warp >> 2) * 64 + mi * 16 + (lane >> 2) + 8 * h;
  col = (warp & 3) * 32 + ni * 8 + 2 * (lane & 3) + c;
}
__device__ __forceinline__ void owner(const float*, int e, int& row, int& col) {
  row = (threadIdx.x >> 4) + 16 * (e >> 3);
  col = (threadIdx.x & 15) + 16 * (e & 7);
}

// ---------------------------------------------------------------------------
// The plain tiled kernels: #14/#15 for float operands, #16 for both types
// ---------------------------------------------------------------------------

// #14 for float operands: one block per 128 x 128 output tile.
__global__ void __launch_bounds__(NT, 2)
fl_fwd(const float* __restrict__ xq, const float* __restrict__ xa, const float* __restrict__ w,
       const float* __restrict__ ws, const float* __restrict__ wz, const float* __restrict__ bq,
       const float* __restrict__ bias, const float* __restrict__ scal, float* __restrict__ out,
       int M, int K, int N, int r, bool symmetric, float eps) {
  constexpr int LDS = Pitch<float>::value;
  __shared__ __align__(16) float As[TILE * LDS];
  __shared__ __align__(16) float Bs[TILE * LDS];
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  const WeightFQ wfq{{scal[0], scal[1], symmetric, eps}, ws, wz};
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  if (r > 0) {  // s * (xa . bq) first, scaled in registers
    for (int k0 = 0; k0 < r; k0 += BK) {
      __syncthreads();
      stage_direct(As, xa, r, M, m0, r, k0, Identity());
      stage_trans(Bs, bq, N, r, k0, N, n0, Identity());
      __syncthreads();
      tile_product(As, Bs, acc);
    }
    const float s = scal[2];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] *= s;
  }
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    stage_direct(As, xq, K, M, m0, K, k0, Identity());
    stage_trans(Bs, w, N, K, k0, N, n0, wfq);
    __syncthreads();
    tile_product(As, Bs, acc);
  }
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    int row, col;
    owner(As, e, row, col);
    const int gm = m0 + row, gn = n0 + col;
    if (gm < M && gn < N) out[(size_t)gm * N + gn] = acc[e] + bias[gn];
  }
}

// #15 for float operands. Blocks x < nk: dxq columns [x*TILE, ...); blocks
// x >= nk: dxa columns.
__global__ void __launch_bounds__(NT, 2)
fl_bwd_dx(const float* __restrict__ g, const float* __restrict__ w, const float* __restrict__ ws,
          const float* __restrict__ wz, const float* __restrict__ bq,
          const float* __restrict__ scal, float* __restrict__ dxq, float* __restrict__ dxa,
          int M, int K, int N, int r, int nk, bool symmetric, float eps) {
  constexpr int LDS = Pitch<float>::value;
  __shared__ __align__(16) float As[TILE * LDS];
  __shared__ __align__(16) float Bs[TILE * LDS];
  const bool lora = (int)blockIdx.x >= nk;
  const int c0 = (lora ? blockIdx.x - nk : blockIdx.x) * TILE, m0 = blockIdx.y * TILE;
  const WeightFQ wfq{{scal[0], scal[1], symmetric, eps}, ws, wz};
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  for (int n0 = 0; n0 < N; n0 += BK) {
    __syncthreads();
    stage_direct(As, g, N, M, m0, N, n0, Identity());
    if (lora)
      stage_direct(Bs, bq, N, r, c0, N, n0, Identity());
    else
      stage_direct(Bs, w, N, K, c0, N, n0, wfq);
    __syncthreads();
    tile_product(As, Bs, acc);
  }
  const float s = scal[2];
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    int row, col;
    owner(As, e, row, col);
    const int gm = m0 + row, gc = c0 + col;
    if (gm >= M) continue;
    if (!lora && gc < K) dxq[(size_t)gm * K + gc] = acc[e];
    if (lora && gc < r) dxa[(size_t)gm * r + gc] = s * acc[e];
  }
}

__device__ __forceinline__ bool ste_clamps(const float* scal) {
  return scal[1] == KIND_LOG && scal[0] < 32.f;
}

// Block (x, y, z): dw tile (rows y*TILE of K, columns x*TILE of N) over the
// z-th of `splits` chunks of M; with one chunk it writes dw through the
// STE, otherwise its partial sum to work[z].
template <typename T>
__global__ void __launch_bounds__(NT, 2)
fl_bwd_dw(const T* __restrict__ xq, const T* __restrict__ g, const float* __restrict__ scal,
          float* __restrict__ out, int M, int K, int N, int splits) {
  constexpr int LDS = Pitch<T>::value;
  __shared__ __align__(16) T As[TILE * LDS];
  __shared__ __align__(16) T Bs[TILE * LDS];
  const int n0 = blockIdx.x * TILE, k0 = blockIdx.y * TILE, z = blockIdx.z;
  const int steps = (M + BK - 1) / BK;
  const int m_begin = (int)((long long)steps * z / splits) * BK;
  const int m_end = min(M, (int)((long long)steps * (z + 1) / splits) * BK);
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += BK) {
    __syncthreads();
    stage_trans(As, xq, K, M, m0, K, k0, Identity());
    stage_trans(Bs, g, N, M, m0, N, n0, Identity());
    __syncthreads();
    tile_product(As, Bs, acc);
  }
  const bool clamp = splits == 1 && ste_clamps(scal);
  float* dst = out + (size_t)z * K * N;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    int row, col;
    owner(As, e, row, col);
    const int gk = k0 + row, gn = n0 + col;
    if (gk < K && gn < N)
      dst[(size_t)gk * N + gn] = clamp ? fminf(fmaxf(acc[e], -10.f), 10.f) : acc[e];
  }
}

// dw = STE_w(sum over z of work[z]), summed in the order z = 0, 1, ...
__global__ void fl_dw_reduce(const float* __restrict__ work, const float* __restrict__ scal,
                             float* __restrict__ dw, size_t n, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = work[i];
  for (int z = 1; z < splits; ++z) s += work[(size_t)z * n + i];
  dw[i] = ste_clamps(scal) ? fminf(fmaxf(s, -10.f), 10.f) : s;
}

// ---------------------------------------------------------------------------
// bf16 operands: the weight prologue and the wgmma GEMM of #14/#15
// ---------------------------------------------------------------------------

// dst = bf16(FQ(w)), each weight fake-quantized once: Wq (K, N) in w's own
// layout (trans = 0) or WqT (N, K) (trans = 1). With trans, the blocks of y
// >= ceil(K/32) copy bq (r, N) to bqT (N, r). 32 x 8 threads per 32 x 32
// tile; the transposes go through shared memory so that both the loads
// and the stores are coalesced.
__global__ void __launch_bounds__(256)
fl_fq_weight(const float* __restrict__ w, const float* __restrict__ ws,
             const float* __restrict__ wz, const float* __restrict__ scal,
             const bf16* __restrict__ bq, bf16* __restrict__ dst, bf16* __restrict__ bqt, int K,
             int N, int r, int trans, bool symmetric, float eps) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y, n0 = blockIdx.x * 32;
  const int kt = (K + 31) / 32;
  if ((int)blockIdx.y >= kt) {  // bq^T
    const int r0 = (blockIdx.y - kt) * 32;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = r0 + ty + 8 * j, n = n0 + tx;
      tile[ty + 8 * j][tx] = (rr < r && n < N) ? __bfloat162float(bq[(size_t)rr * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + ty + 8 * j, rr = r0 + tx;
      if (n < N && rr < r) bqt[(size_t)n * r + rr] = __float2bfloat16_rn(tile[tx][ty + 8 * j]);
    }
    return;
  }
  const FQ fq{scal[0], scal[1], symmetric, eps};
  const int k0 = blockIdx.y * 32, n = n0 + tx;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + ty + 8 * j;
    v[j] = (k < K && n < N) ? fq(w[(size_t)k * N + n], __ldg(ws + n), __ldg(wz + n)) : 0.f;
  }
  if (!trans) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ty + 8 * j;
      if (k < K && n < N) dst[(size_t)k * N + n] = __float2bfloat16_rn(v[j]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) tile[ty + 8 * j][tx] = v[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nn = n0 + ty + 8 * j, k = k0 + tx;
    if (nn < N && k < K) dst[(size_t)nn * K + k] = __float2bfloat16_rn(tile[tx][ty + 8 * j]);
  }
}

#define GM 128            // output tile rows (two consumer warpgroups of 64)
#define GN 128            // output tile columns
#define GK 64             // reduction step: 64 bf16 = one 128-byte swizzle row
#define STAGES 3          // shared-memory ring (two blocks per SM)
#define GEMM_THREADS 288  // two consumer warpgroups + one producer warp
constexpr int TILE_BYTES = GM * GK * 2;  // an A or a B tile (GM == GN)
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int GEMM_SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase of the given parity has completed. A wait
// of more than about 2^34 cycles (seconds; a stage normally arrives within
// microseconds) can only be a lost arrival: the kernel then traps, and the
// launch fails with an error instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  }
}

// A GK x 128-row box of a K-major bf16 matrix at (k, row) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int k, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), LBO unused (1),
// layout type 1 (128B swizzle). The tile base is 1024-byte aligned; a
// k16 slice starts 32 bytes further.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Pins the accumulators, so that the compiler moves no access to them
// across an asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] . B[128 x 16]^T from shared memory.
__device__ __forceinline__ void wgmma_128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// One 128 x 128 tile of C = s * (A0 . B0^T) + A1 . B1^T (+ bias), rows m0
// of A and columns c0 of C (rows c0 of B): n0 steps of GK over (A0, B0),
// whose sum is scaled by s = scal[2] in registers, then n1 steps over
// (A1, B1) on top. Stores float32 to out (row stride ld), masked to
// rows x cols; cols is even. Called by all GEMM_THREADS threads of a block
// launched with GEMM_SMEM bytes of dynamic shared memory: warpgroups 0 and
// 1 are the consumers, warp 8 the producer.
__device__ __forceinline__ void gemm_tile(const CUtensorMap* a0, const CUtensorMap* b0, int n0,
                                          const CUtensorMap* a1, const CUtensorMap* b1, int n1,
                                          int m0, int c0, const float* __restrict__ scal,
                                          const float* __restrict__ bias, float* __restrict__ out,
                                          int ld, int rows, int cols) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, total = n0 + n1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread keeps the ring full
    if (t == 0) {
      for (int i = 0; i < total; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
        const bool first = i < n0;
        const int k = (first ? i : i - n0) * GK;
        const uint32_t dst = base + s * STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load(dst, first ? a0 : a1, k, m0, full + 8 * s);
        tma_load(dst + TILE_BYTES, first ? b0 : b1, k, c0, full + 8 * s);
      }
    }
    return;
  }

  // consumers: warpgroup 0 rows [0, 64), warpgroup 1 rows [64, 128)
  const int row_off = wg * 64;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  int released = 0;  // steps whose stage has been handed back
  for (int i = 0; i < total; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint32_t a = base + s * STAGE_BYTES + row_off * (GK * 2);
    const uint32_t b = base + s * STAGE_BYTES + TILE_BYTES;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk) wgmma_128(acc, sdesc(a + 32 * kk), sdesc(b + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(acc);
    int done;  // steps [0, done) have finished reading shared memory
    if (i == n0 - 1) {  // the end of the scaled sum
      wgmma_wait<0>();
      fence_acc(acc);
      const float sc = scal[2];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] *= sc;
      done = i + 1;
    } else {
      wgmma_wait<1>();
      done = i;
    }
    fence_acc(acc);
    for (; released < done; ++released)
      if (t == 0) mbar_arrive(empty + 8 * (released % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator e of thread t: row 16*warp + lane/4 + 8*((e>>1)&1),
  // column 8*(e>>2) + 2*(lane&3) + (e&1)
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int j = 0; j < GN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + row_off + warp * 16 + lane / 4 + 8 * h;
      const int col = c0 + 8 * j + 2 * (lane & 3);
      if (row < rows && col < cols) {
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (bias) {
          v0 += bias[col];
          v1 += bias[col + 1];
        }
        *reinterpret_cast<float2*>(out + (size_t)row * ld + col) = make_float2(v0, v1);
      }
    }
  }
}

// #14: out = s * (xa . bq) + xq . WqT^T + bias, one block per output tile
// (x over N, y over M). nr LoRA steps (xa against bq^T), nk K steps.
__global__ void __launch_bounds__(GEMM_THREADS, 2)
fl_fwd_wgmma(const __grid_constant__ CUtensorMap xa, const __grid_constant__ CUtensorMap bqt,
             const __grid_constant__ CUtensorMap xq, const __grid_constant__ CUtensorMap wqt,
             int nr, int nk, const float* __restrict__ scal, const float* __restrict__ bias,
             float* __restrict__ out, int M, int N) {
  gemm_tile(&xa, &bqt, nr, &xq, &wqt, nk, blockIdx.y * GM, blockIdx.x * GN, scal, bias, out, N,
            M, N);
}

// #15: blocks x < nkt are dxq tiles (g against Wq, n steps over N), the
// rest dxa tiles (g against bq, scaled by s).
__global__ void __launch_bounds__(GEMM_THREADS, 2)
fl_bwd_dx_wgmma(const __grid_constant__ CUtensorMap g, const __grid_constant__ CUtensorMap wq,
                const __grid_constant__ CUtensorMap bq, int n, int nkt,
                const float* __restrict__ scal, float* __restrict__ dxq, float* __restrict__ dxa,
                int M, int K, int r) {
  const int m0 = blockIdx.y * GM;
  if ((int)blockIdx.x < nkt)
    gemm_tile(&g, &wq, 0, &g, &wq, n, m0, blockIdx.x * GN, scal, nullptr, dxq, K, M, K);
  else
    gemm_tile(&g, &bq, n, &g, &bq, 0, m0, (blockIdx.x - nkt) * GN, scal, nullptr, dxa, r, M, r);
}

// ---------------------------------------------------------------------------
// Host entry points (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------

static inline int tiles(int n) { return (n + TILE - 1) / TILE; }
static inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime; it is taken
// with dlopen from the libcuda.so.1 the runtime has already loaded, so that
// nothing links against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (h) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The map of a K-major bf16 matrix (rows, inner) with row stride ld
// elements, read in GK x 128-row boxes with the 128-byte swizzle; boxes
// past the edge are filled with zeros.
static int kmajor_map(CUtensorMap* map, const void* ptr, int inner, int rows, int ld) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {GK, GM};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult rc = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                          strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// K, N, r multiples of 8 (16-byte TMA strides), 16-byte aligned operands.
static bool tma_ok(int K, int N, int r, std::initializer_list<const void*> ptrs) {
  if ((K | N | r) & 7) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
}

template <typename T>
static int dw_launch(const void* xq, const void* g, const float* scal, float* dw, float* work,
                     int M, int K, int N, int splits, cudaStream_t stream) {
  fl_bwd_dw<T><<<dim3(tiles(N), tiles(K), splits), NT, 0, stream>>>(
      static_cast<const T*>(xq), static_cast<const T*>(g), scal, splits > 1 ? work : dw, M, K,
      N, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t n = (size_t)K * N;
  fl_dw_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(work, scal, dw, n, splits);
  return (int)cudaGetLastError();
}

// #14 with float operands: out (M, N) float32 from float xq (M, K),
// xa (M, r), bq (r, N), and float32 w (K, N), ws, wz, bias (N), scal (4).
extern "C" int fused_linear_fwd_f32(const float* xq, const float* xa, const float* w,
                                    const float* ws, const float* wz, const float* bq,
                                    const float* bias, const float* scal, float* out, int M,
                                    int K, int N, int r, int symmetric, float eps,
                                    cudaStream_t stream) {
  if ((K | N | r) & 1) return (int)cudaErrorInvalidValue;
  fl_fwd<<<dim3(tiles(N), tiles(M)), NT, 0, stream>>>(xq, xa, w, ws, wz, bq, bias, scal, out,
                                                      M, K, N, r, symmetric, eps);
  return (int)cudaGetLastError();
}

// #15 with float operands: dxq (M, K) and dxa (M, r) float32 from float
// g (M, N) and bq (r, N), float32 w (K, N), ws, wz (N), scal (4).
extern "C" int fused_linear_bwd_dx_f32(const float* g, const float* w, const float* ws,
                                       const float* wz, const float* bq, const float* scal,
                                       float* dxq, float* dxa, int M, int K, int N, int r,
                                       int symmetric, float eps, cudaStream_t stream) {
  if ((K | N | r) & 1) return (int)cudaErrorInvalidValue;
  const int nk = tiles(K), nr = r > 0 ? tiles(r) : 0;
  fl_bwd_dx<<<dim3(nk + nr, tiles(M)), NT, 0, stream>>>(g, w, ws, wz, bq, scal, dxq, dxa, M, K,
                                                        N, r, nk, symmetric, eps);
  return (int)cudaGetLastError();
}

static int fq_launch(const float* w, const float* ws, const float* wz, const float* scal,
                     const void* bq, void* dst, void* bqt, int K, int N, int r, int trans,
                     int symmetric, float eps, cudaStream_t stream) {
  const int rt = trans && r > 0 ? cdiv(r, 32) : 0;
  fl_fq_weight<<<dim3(cdiv(N, 32), cdiv(K, 32) + rt), dim3(32, 8), 0, stream>>>(
      w, ws, wz, scal, static_cast<const bf16*>(bq), static_cast<bf16*>(dst),
      static_cast<bf16*>(bqt), K, N, r, trans, symmetric, eps);
  return (int)cudaGetLastError();
}

// The weight prologue of #14/#15 alone: dst = bf16(FQ(w)) from float32
// w (K, N), ws, wz (N), scal (4); (K, N) with trans = 0, (N, K) with
// trans = 1, when bq (r, N) bf16 is also copied to bqt (N, r).
extern "C" int fused_linear_fq_weight(const float* w, const float* ws, const float* wz,
                                      const float* scal, const void* bq, void* dst, void* bqt,
                                      int K, int N, int r, int trans, int symmetric, float eps,
                                      cudaStream_t stream) {
  return fq_launch(w, ws, wz, scal, bq, dst, bqt, K, N, r, trans, symmetric, eps, stream);
}

// #14 with bf16 operands: out (M, N) float32 from xq (M, K), xa (M, r),
// bq (r, N), float32 w (K, N), ws, wz, bias (N), scal (4). The prologue
// writes WqT (N, K) and then bqT (N, r) into the bf16 workspace `work` of
// N * (K + r) elements; then the GEMM reads them. One call, two launches.
extern "C" int fused_linear_fwd_wgmma(const void* xq, const void* xa, const float* w,
                                      const float* ws, const float* wz, const void* bq,
                                      const float* bias, const float* scal, void* work,
                                      float* out, int M, int K, int N, int r, int symmetric,
                                      float eps, cudaStream_t stream) {
  bf16* wqt = static_cast<bf16*>(work);
  bf16* bqt = wqt + (size_t)N * K;
  if (!tma_ok(K, N, r, {xq, wqt}) || (r > 0 && !tma_ok(0, 0, 0, {xa, bqt})))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mxq, mwqt, mxa, mbqt;
  int rc = kmajor_map(&mxq, xq, K, M, K);
  if (!rc) rc = kmajor_map(&mwqt, wqt, K, N, K);
  if (!rc && r > 0) rc = kmajor_map(&mxa, xa, r, M, r);
  if (!rc && r > 0) rc = kmajor_map(&mbqt, bqt, r, N, r);
  if (rc) return rc;
  if (r == 0) mxa = mxq, mbqt = mwqt;  // never loaded
  static const cudaError_t e = cudaFuncSetAttribute(
      fl_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (e != cudaSuccess) return (int)e;
  rc = fq_launch(w, ws, wz, scal, bq, wqt, bqt, K, N, r, 1, symmetric, eps, stream);
  if (rc) return rc;
  fl_fwd_wgmma<<<dim3(cdiv(N, GN), cdiv(M, GM)), GEMM_THREADS, GEMM_SMEM, stream>>>(
      mxa, mbqt, mxq, mwqt, r > 0 ? cdiv(r, GK) : 0, cdiv(K, GK), scal, bias, out, M, N);
  return (int)cudaGetLastError();
}

// #15 with bf16 operands: dxq (M, K) and dxa (M, r) float32 from g (M, N),
// bq (r, N), float32 w (K, N), ws, wz (N), scal (4). The prologue writes Wq
// (K, N) into the bf16 workspace `work` of K * N elements; then the GEMM
// reads it. One call, two launches.
extern "C" int fused_linear_bwd_dx_wgmma(const void* g, const float* w, const float* ws,
                                         const float* wz, const void* bq, const float* scal,
                                         void* work, float* dxq, float* dxa, int M, int K, int N,
                                         int r, int symmetric, float eps, cudaStream_t stream) {
  if (!tma_ok(K, N, r, {g, work}) || (r > 0 && !tma_ok(0, 0, 0, {bq})))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mg, mwq, mbq;
  int rc = kmajor_map(&mg, g, N, M, N);
  if (!rc) rc = kmajor_map(&mwq, work, N, K, N);
  if (!rc && r > 0) rc = kmajor_map(&mbq, bq, N, r, N);
  if (rc) return rc;
  if (r == 0) mbq = mwq;  // never loaded
  static const cudaError_t e = cudaFuncSetAttribute(
      fl_bwd_dx_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (e != cudaSuccess) return (int)e;
  rc = fq_launch(w, ws, wz, scal, nullptr, work, nullptr, K, N, 0, 0, symmetric, eps, stream);
  if (rc) return rc;
  const int nkt = cdiv(K, GN), nrt = r > 0 ? cdiv(r, GN) : 0;
  fl_bwd_dx_wgmma<<<dim3(nkt + nrt, cdiv(M, GM)), GEMM_THREADS, GEMM_SMEM, stream>>>(
      mg, mwq, mbq, cdiv(N, GK), nkt, scal, dxq, dxa, M, K, r);
  return (int)cudaGetLastError();
}

// dw (K, N) float32 from xq (M, K) and g (M, N) in the operand type, over
// `splits` chunks of M; work is (splits, K, N) float32 scratch when
// splits > 1.
extern "C" int fused_linear_bwd_dw(const void* xq, const void* g, const float* scal, float* dw,
                                   float* work, int M, int K, int N, int splits, int is_bf16,
                                   cudaStream_t stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) return dw_launch<bf16>(xq, g, scal, dw, work, M, K, N, splits, stream);
  return dw_launch<float>(xq, g, scal, dw, work, M, K, N, splits, stream);
}
