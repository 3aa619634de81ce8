// Fused QAT linear for sm_90a: the weight fake-quant inside the GEMM, for
// the SP training forward and its two backward products.
//
// Replaces three Pallas kernels of llm_qat_tpu/ops/fused_linear.py:
// - `_fwd_kernel` (called by `_fwd_call`) with `fused_linear_fwd`:
//     out[M,N] = xq[M,K] . cdt(FQ(w[K,N])) + s * xa[M,r] . bq[r,N] + bias[N];
// - `_bwd_dx_kernel` (called by `_bwd_dx_call`) with `fused_linear_bwd_dx`:
//     dxq[M,K] = g[M,N] . cdt(FQ(w))^T,  dxa[M,r] = s * g . bq^T;
// - `_bwd_dw_kernel` (called by `_bwd_dw_call`) with `fused_linear_bwd_dw`:
//     dw[K,N] = STE_w(xq^T . g), the +-10 clamp iff kind = log and bits < 32.
// The Python wrappers are llm_qat_tpu_torch/ops/fused_linear.py::
// fused_linear_fwd, ::fused_linear_bwd_dx and ::fused_linear_bwd_dw;
// `fused_linear_fwd_plain`, `fused_linear_bwd_dx_plain` and
// `fused_linear_bwd_dw_plain` beside them compute the same functions in
// plain PyTorch, and `fq_tile_plain` the weight fake-quant FQ.
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
// contracts nothing into an FMA. The in-tile weight codes therefore equal
// those of the plain version on the card, and kernel and plain differ only
// in the order of the float32 sums.
//
// Design (a plain tiled one): one block of 256 threads per 128 x 128 output
// tile, the reduction in steps of 32 through shared memory. A float32 w tile
// is fake-quantized while it is staged, rounded to the operand type and
// stored beside the activation tile; both tiles are held k-contiguous
// (row pitch 40 bf16 / 33 float, which keeps the fragment loads free of bank
// conflicts). bf16 products run on the tensor cores with mma.sync
// m16n8k16 and float32 accumulators (8 warps as 2 x 4, each 64 x 32); a
// bf16 product is exact in float32, as the MXU dot with a float32 result
// is. float operands run as float32 FMA on the CUDA cores (each thread an
// 8 x 8 patch). Edges are masked, so any M and any even K, N, r work; the
// Python gate still picks the JAX shapes.
// - #14: one block per (M tile, N tile); the LoRA product runs first, is
//   scaled by s in registers, then the K loop accumulates on top, then the
//   bias is added.
// - #15: one block per (M tile, K tile) of dxq plus one per (M tile, r tile)
//   of dxa, each reducing over N. The dxq blocks fake-quantize w row by row
//   (the weight is read in its own layout, no transpose).
// - #16: one block per (K tile, N tile) and chunk of M, both operands
//   transposed while staged. When the (K, N) tiles alone would not fill the
//   card, M is cut into chunks whose partial sums go to a float32 workspace;
//   a second kernel sums them in a fixed order and applies the STE clamp
//   (no atomics, deterministic).
//
// Bounds, at the GPT-2 124M training shapes (M = 8192, r = 64, bf16):
// #14 reads xq, w, xa, bq once and writes out (2MK + 4KN + 2Mr + 2rN + 4MN
// bytes) and does 2MN(K + r) flops; at (K, N) = (768, 3072) that is
// 124 MB (37 us at 3.35 TB/s) against 41.9 GFLOP (42 us at 989 TFLOP/s):
// close to balanced, bound by operations at three of the four GPT-2 shapes
// and by bytes at (768, 768). #15 moves
// 2MN + 4KN + 2rN + 4MK + 4Mr bytes for the same flops; #16 moves
// 2MK + 2MN + 4KN bytes for 2MKN flops. This design re-reads each w tile
// and re-runs its fake-quant once per 128-row M tile (64 times at
// M = 8192), with no cp.async/TMA pipelining and mma.sync instead of wgmma:
// the fake-quant's division and log2f/exp2f per staged weight, not the
// products, is its expected cost at the log slot. TMA-fed wgmma with the
// quantized w tile kept across M tiles is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// Kernels
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT, 2)
fl_fwd(const T* __restrict__ xq, const T* __restrict__ xa, const float* __restrict__ w,
       const float* __restrict__ ws, const float* __restrict__ wz, const T* __restrict__ bq,
       const float* __restrict__ bias, const float* __restrict__ scal, float* __restrict__ out,
       int M, int K, int N, int r, bool symmetric, float eps) {
  constexpr int LDS = Pitch<T>::value;
  __shared__ __align__(16) T As[TILE * LDS];
  __shared__ __align__(16) T Bs[TILE * LDS];
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

// Blocks x < nk: dxq columns [x*TILE, ...); blocks x >= nk: dxa columns.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
fl_bwd_dx(const T* __restrict__ g, const float* __restrict__ w, const float* __restrict__ ws,
          const float* __restrict__ wz, const T* __restrict__ bq,
          const float* __restrict__ scal, float* __restrict__ dxq, float* __restrict__ dxa,
          int M, int K, int N, int r, int nk, bool symmetric, float eps) {
  constexpr int LDS = Pitch<T>::value;
  __shared__ __align__(16) T As[TILE * LDS];
  __shared__ __align__(16) T Bs[TILE * LDS];
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
// Host entry points (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------

static inline int tiles(int n) { return (n + TILE - 1) / TILE; }

template <typename T>
static int fwd_launch(const void* xq, const void* xa, const float* w, const float* ws,
                      const float* wz, const void* bq, const float* bias, const float* scal,
                      float* out, int M, int K, int N, int r, bool symmetric, float eps,
                      cudaStream_t stream) {
  fl_fwd<T><<<dim3(tiles(N), tiles(M)), NT, 0, stream>>>(
      static_cast<const T*>(xq), static_cast<const T*>(xa), w, ws, wz,
      static_cast<const T*>(bq), bias, scal, out, M, K, N, r, symmetric, eps);
  return (int)cudaGetLastError();
}

template <typename T>
static int dx_launch(const void* g, const float* w, const float* ws, const float* wz,
                     const void* bq, const float* scal, float* dxq, float* dxa, int M, int K,
                     int N, int r, bool symmetric, float eps, cudaStream_t stream) {
  const int nk = tiles(K), nr = r > 0 ? tiles(r) : 0;
  fl_bwd_dx<T><<<dim3(nk + nr, tiles(M)), NT, 0, stream>>>(
      static_cast<const T*>(g), w, ws, wz, static_cast<const T*>(bq), scal, dxq, dxa, M, K, N,
      r, nk, symmetric, eps);
  return (int)cudaGetLastError();
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

// out (M, N) float32 from xq (M, K), xa (M, r), bq (r, N) in float
// (is_bf16 = 0) or bf16, and float32 w (K, N), ws, wz, bias (N), scal (4).
extern "C" int fused_linear_fwd(const void* xq, const void* xa, const float* w,
                                const float* ws, const float* wz, const void* bq,
                                const float* bias, const float* scal, float* out, int M, int K,
                                int N, int r, int is_bf16, int symmetric, float eps,
                                cudaStream_t stream) {
  if ((K | N | r) & 1) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return fwd_launch<bf16>(xq, xa, w, ws, wz, bq, bias, scal, out, M, K, N, r, symmetric,
                            eps, stream);
  return fwd_launch<float>(xq, xa, w, ws, wz, bq, bias, scal, out, M, K, N, r, symmetric, eps,
                           stream);
}

// dxq (M, K) and dxa (M, r) float32 from g (M, N) and bq (r, N) in the
// operand type, float32 w (K, N), ws, wz (N), scal (4).
extern "C" int fused_linear_bwd_dx(const void* g, const float* w, const float* ws,
                                   const float* wz, const void* bq, const float* scal,
                                   float* dxq, float* dxa, int M, int K, int N, int r,
                                   int is_bf16, int symmetric, float eps, cudaStream_t stream) {
  if ((K | N | r) & 1) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dx_launch<bf16>(g, w, ws, wz, bq, scal, dxq, dxa, M, K, N, r, symmetric, eps,
                           stream);
  return dx_launch<float>(g, w, ws, wz, bq, scal, dxq, dxa, M, K, N, r, symmetric, eps,
                          stream);
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
