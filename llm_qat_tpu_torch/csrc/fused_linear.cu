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
// Every kernel takes a student axis, as JAX's batched pallas_call does
// under `jax.vmap` over the students (student_mode="vmap"), which prepends
// the vmapped axis to the kernel's grid: S students in one launch, the
// student index a grid dimension. Per student: xq, xa, g, bq, the weight's
// scale and zero-point vectors, the scalars and every output, each the
// next of S equal blocks in memory; shared: w and the bias. #16 writes each
// student's dW, clamped by that student's STE, to its own (K, N) block of
// an (S, K, N) output, which the wrapper sums (JAX's batched #16 and the
// sum over the vmapped axis that follows it); a sum of the students' rows
// in one GEMM with one clamp would be wrong wherever a student clamps. S =
// 1 is the unbatched call.
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
// - One GEMM template (`gemm_tile`) serves #14-#16. For #14/#15 it is
//   C[M, n] = A[M, R] . B[n, R]^T with both operands K-major: one block of
//   288 threads per 128 x 128 output tile, two blocks to an SM. The first
//   thread of warp 8 is the producer and keeps a ring of 3 shared-memory
//   stages (32 KB each) filled by TMA (cp.async.bulk.tensor, 128-byte swizzle, one
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
// - #16: dw = xq^T . g reduces over M, which is the row index of both xq
//   (M, K) and g (M, N): both operands are MN-major, and the same ring and
//   warpgroups read them as they lie (`gemm_tile<BN, true, S>`, wgmma's
//   imm-trans-a/b = 1), with no transposing copy. With the 128-byte swizzle
//   a TMA box is at most 64 bf16 wide, so an MN-major tile is boxes of 64
//   columns x GK rows of M; warpgroup w's A slice is box w, and B spans all
//   of its boxes. A k16 slice is 16 rows of M, 2048 bytes further.
// - #16's tile is 128 x 256 (m64n256k16 per warpgroup, 128 float32
//   accumulators a thread) with a 4-stage ring of 48 KB, one block per SM.
//   A 128 x 128 tile reads 80 KB of shared memory per 64-deep step (B once
//   per warpgroup, plus the TMA's writes) for 4.2 MFLOP; 128 x 256 reads
//   128 KB for 8.4 MFLOP, within the SM's 128 bytes a cycle at the tensor
//   cores' rate: the wider tile reads a fifth less per flop, which is why it
//   was chosen over 128 x 128 tiles two to an SM (PERF.md §6).
// - #16's 18-72 (K, N) tiles per GPT-2 linear do not fill 132 SMs, so M is
//   cut into `split` chunks of whole GK steps, one per block of a thread
//   block cluster (at most 8; the plan is `ops/fused_linear.py::
//   dw_splits`, which also keeps each chunk's chain of float32 sums short
//   enough for the kernel to agree with its plain version, and the chunk
//   bounds come from `dw_chunks` there, passed by value). Each block
//   stores its float32 partial tile into its own shared memory (the ring,
//   now idle); after a cluster barrier block z sums the z-th slice of rows
//   over the cluster's blocks through distributed shared memory, in the
//   order of rank, clamps (the weight STE) and stores. No atomics, no
//   workspace in device memory, one launch; repeat calls give bit-equal
//   dw. Consecutive blocks share the tile index of the smaller of K and N,
//   so the blocks in flight at once read the same slices of xq and g.
// - Epilogue: float32 stores straight from the accumulators, masked at the
//   ragged edges (#16 with a split: from the summed shared-memory tiles).
// - Students: every bf16 operand is read through a 3-D tensor map (inner,
//   rows, student), so a box past one student's rows is filled with zeros
//   and never reads the next student's (#16 sums over M, where that would
//   matter); the grid's z dimension (#14/#15, the prologue) or the outer
//   part of it (#16) is the student.
//
// float operands (compute_dtype float32, off the main path) keep the plain
// tiled design: one block of 256 threads per 128 x 128 output tile, the
// reduction in steps of 32 through shared memory, the float32 w tile
// fake-quantized while it is staged, float32 FMA on the CUDA cores (each
// thread an 8 x 8 patch). #16 (`fl_bwd_dw`) does the same over all of M,
// both operands transposed while staged.
//
// Bounds, at the GPT-2 124M training shapes (M = 8192, r = 64, bf16):
// #14 reads xq, w, xa, bq once and writes out (2MK + 4KN + 2Mr + 2rN + 4MN
// bytes) and does 2MN(K + r) flops; at (K, N) = (768, 3072) that is
// 124 MB (37 us at 3.35 TB/s) against 41.9 GFLOP (42 us at 989 TFLOP/s):
// close to balanced, bound by operations at three of the four GPT-2 shapes
// and by bytes at (768, 768). #15 moves 2MN + 4KN + 2rN + 4MK + 4Mr bytes
// for the same flops; #16 moves 2MK + 2MN + 4KN bytes for 2MKN flops
// (at (768, 3072): 73 MB, 22 us, against 38.7 GFLOP, 39 us: bound by
// operations at every GPT-2 shape). The prologue adds 4KN read and 2KN
// written (14 MB at (768, 3072), 4 us), and the GEMM re-reads A once per
// 128-column tile of the output (from L2).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

#include "sm90.cuh"

namespace cg = cooperative_groups;

#define TILE 128    // output tile rows and columns
#define BK 32       // reduction step
#define LDS 33      // row pitch of the float tiles in shared memory
#define NT 256      // threads per block
#define KIND_LOG 1.0f

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

typedef __nv_bfloat16 bf16;

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

// Elementwise transforms of a value and its column: the identity, the
// weight fake-quant with the scales of the source column (while staging),
// the bias (#14's epilogue) and the weight STE (#16's).
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

struct AddBias {
  const float* bias;
  __device__ __forceinline__ float operator()(float v, int col) const { return v + bias[col]; }
};

// dW passes the weight STE: clamped to +-10 iff kind = log and bits < 32.
__device__ __forceinline__ bool ste_clamps(const float* scal) {
  return scal[1] == KIND_LOG && scal[0] < 32.f;
}

struct SteClamp {
  bool on;
  __device__ __forceinline__ float operator()(float v, int) const {
    return on ? fminf(fmaxf(v, -10.f), 10.f) : v;
  }
};

// ---------------------------------------------------------------------------
// float operands: staging into shared memory (k-contiguous tiles of TILE
// rows x BK)
// ---------------------------------------------------------------------------

// Each thread stages STAGE_PAIRS pairs of a tile. All of its global loads
// are issued before the first shared-memory store, so that they are in
// flight together (one memory latency per tile, not one per pair).
#define STAGE_PAIRS (TILE * BK / 2 / NT)

// dst[r][k] = op(src[r0 + r][k0 + k]) for r < TILE, k < BK: the source is
// already k-contiguous (row stride ld). Zero outside rows x cols. op takes
// the value and its source column.
template <typename Op>
__device__ __forceinline__ void stage_direct(float* dst, const float* __restrict__ src, int ld,
                                             int rows, int r0, int cols, int k0, Op op) {
  float2 v[STAGE_PAIRS];
#pragma unroll
  for (int i = 0; i < STAGE_PAIRS; ++i) {
    const int p = threadIdx.x + i * NT;
    const int gr = r0 + p / (BK / 2), gk = k0 + 2 * (p % (BK / 2));
    // cols is even: a pair is in or out as a whole
    v[i] = (gr < rows && gk < cols) ? *reinterpret_cast<const float2*>(src + (size_t)gr * ld + gk)
                                    : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < STAGE_PAIRS; ++i) {
    const int p = threadIdx.x + i * NT;
    const int r = p / (BK / 2), k = 2 * (p % (BK / 2));
    const bool in = r0 + r < rows && k0 + k < cols;
    dst[r * LDS + k] = in ? op(v[i].x, k0 + k) : 0.f;
    dst[r * LDS + k + 1] = in ? op(v[i].y, k0 + k + 1) : 0.f;
  }
}

// dst[c][k] = op(src[k0 + k][c0 + c]) for c < TILE, k < BK: the source's
// rows are the reduction (row stride ld), so the tile is transposed. Each
// thread keeps one column c and takes pairs of reduction rows.
template <typename Op>
__device__ __forceinline__ void stage_trans(float* dst, const float* __restrict__ src, int ld,
                                            int rows, int k0, int cols, int c0, Op op) {
  const int c = threadIdx.x % TILE, gc = c0 + c;
  float v[2 * STAGE_PAIRS];
#pragma unroll
  for (int i = 0; i < 2 * STAGE_PAIRS; ++i) {
    const int gk = k0 + 2 * ((threadIdx.x + (i / 2) * NT) / TILE) + (i & 1);
    v[i] = (gc < cols && gk < rows) ? src[(size_t)gk * ld + gc] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < STAGE_PAIRS; ++i) {
    const int k = 2 * ((threadIdx.x + i * NT) / TILE), gk = k0 + k;
    dst[c * LDS + k] = (gc < cols && gk < rows) ? op(v[2 * i], gc) : 0.f;
    dst[c * LDS + k + 1] = (gc < cols && gk + 1 < rows) ? op(v[2 * i + 1], gc) : 0.f;
  }
}

// acc += A . B^T over one BK step, A and B k-contiguous: thread (ty, tx) of
// 16 x 16 owns rows ty + 16 i and columns tx + 16 j, acc[i*8 + j], as
// float32 FMA.
__device__ __forceinline__ void tile_product(const float* As, const float* Bs, float* acc) {
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
__device__ __forceinline__ void owner(int e, int& row, int& col) {
  row = (threadIdx.x >> 4) + 16 * (e >> 3);
  col = (threadIdx.x & 15) + 16 * (e & 7);
}

// ---------------------------------------------------------------------------
// The plain tiled kernels for float operands: #14, #15, #16
// ---------------------------------------------------------------------------

// #14 for float operands: one block per 128 x 128 output tile.
__global__ void __launch_bounds__(NT, 2)
fl_fwd(const float* __restrict__ xq, const float* __restrict__ xa, const float* __restrict__ w,
       const float* __restrict__ ws, const float* __restrict__ wz, const float* __restrict__ bq,
       const float* __restrict__ bias, const float* __restrict__ scal, float* __restrict__ out,
       int M, int K, int N, int r, bool symmetric, float eps) {
  __shared__ __align__(16) float As[TILE * LDS];
  __shared__ __align__(16) float Bs[TILE * LDS];
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  const size_t stu = blockIdx.z;  // the student
  xq += stu * M * K, xa += stu * M * r, ws += stu * N, wz += stu * N, bq += stu * r * N;
  scal += 4 * stu, out += stu * M * N;
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
    owner(e, row, col);
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
  __shared__ __align__(16) float As[TILE * LDS];
  __shared__ __align__(16) float Bs[TILE * LDS];
  const bool lora = (int)blockIdx.x >= nk;
  const int c0 = (lora ? blockIdx.x - nk : blockIdx.x) * TILE, m0 = blockIdx.y * TILE;
  const size_t stu = blockIdx.z;  // the student
  g += stu * M * N, ws += stu * N, wz += stu * N, bq += stu * r * N, scal += 4 * stu;
  dxq += stu * M * K, dxa += stu * M * r;
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
    owner(e, row, col);
    const int gm = m0 + row, gc = c0 + col;
    if (gm >= M) continue;
    if (!lora && gc < K) dxq[(size_t)gm * K + gc] = acc[e];
    if (lora && gc < r) dxa[(size_t)gm * r + gc] = s * acc[e];
  }
}

// #16 for float operands: block (x, y, s) is student s's dw tile of rows
// y*TILE of K and columns x*TILE of N, summed over all of its M rows,
// through its STE.
__global__ void __launch_bounds__(NT, 2)
fl_bwd_dw(const float* __restrict__ xq, const float* __restrict__ g,
          const float* __restrict__ scal, float* __restrict__ dw, int M, int K, int N) {
  __shared__ __align__(16) float As[TILE * LDS];
  __shared__ __align__(16) float Bs[TILE * LDS];
  const int n0 = blockIdx.x * TILE, k0 = blockIdx.y * TILE;
  const size_t stu = blockIdx.z;  // the student
  xq += stu * M * K, g += stu * M * N, scal += 4 * stu, dw += stu * K * N;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  for (int m0 = 0; m0 < M; m0 += BK) {
    __syncthreads();
    stage_trans(As, xq, K, M, m0, K, k0, Identity());
    stage_trans(Bs, g, N, M, m0, N, n0, Identity());
    __syncthreads();
    tile_product(As, Bs, acc);
  }
  const SteClamp ste{ste_clamps(scal)};
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    int row, col;
    owner(e, row, col);
    const int gk = k0 + row, gn = n0 + col;
    if (gk < K && gn < N) dw[(size_t)gk * N + gn] = ste(acc[e], gn);
  }
}

// ---------------------------------------------------------------------------
// bf16 operands: the weight prologue of #14/#15 and the wgmma GEMM of #14-#16
// ---------------------------------------------------------------------------

// dst = bf16(FQ(w)), each weight fake-quantized once: Wq (K, N) in w's own
// layout (trans = 0) or WqT (N, K) (trans = 1). With trans, the blocks of y
// >= ceil(K/32) copy bq (r, N) to bqT (N, r). 32 x 8 threads per 32 x 32
// tile; the transposes go through shared memory so that both the loads
// and the stores are coalesced. Block z is student z: its scales, scalars,
// bq, and its own K x N (and N x r) block of dst (bqt); w is shared.
__global__ void __launch_bounds__(256)
fl_fq_weight(const float* __restrict__ w, const float* __restrict__ ws,
             const float* __restrict__ wz, const float* __restrict__ scal,
             const bf16* __restrict__ bq, bf16* __restrict__ dst, bf16* __restrict__ bqt, int K,
             int N, int r, int trans, bool symmetric, float eps) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y, n0 = blockIdx.x * 32;
  const size_t stu = blockIdx.z;  // the student
  ws += stu * N, wz += stu * N, scal += 4 * stu, dst += stu * K * N;
  if (r > 0) bq += stu * r * N, bqt += stu * N * r;
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
#define GN 128            // #14/#15's output tile columns
#define DW_BN 256         // #16's output tile columns
#define GK 64             // reduction step: 64 bf16 = one 128-byte swizzle row
#define STAGES 3          // #14/#15's shared-memory ring (two blocks per SM)
#define DW_STAGES 4       // #16's ring (one block per SM)
#define GEMM_THREADS 288  // two consumer warpgroups + one producer warp
#define MAX_SPLIT 8       // #16: blocks of a cluster (the portable limit)
#define RED_PITCH (DW_BN + 8)  // #16: floats per row of a partial tile in shared memory

// #16's chunks of M: block z of a cluster sums rows [row[z], row[z + 1]),
// every bound but the last (M) on a GK step
struct DwChunks {
  int row[MAX_SPLIT + 1];
};
constexpr int A_BYTES = GM * GK * 2;  // an A tile: GM rows or columns x GK
constexpr int BOX_BYTES = 64 * GK * 2;  // 64 rows or columns of a tile: one MN-major box
// a stage: an A tile and a B tile of bn rows or columns
__host__ __device__ constexpr int stage_bytes(int bn) { return A_BYTES + bn * GK * 2; }
// dynamic shared memory of a block with a ring of `stages`: 1024 bytes of
// alignment, the stages, a full and an empty mbarrier per stage
constexpr int gemm_smem(int stages, int bn) {
  return 1024 + stages * stage_bytes(bn) + 2 * stages * 8;
}
static_assert(GM * RED_PITCH * 4 <= DW_STAGES * stage_bytes(DW_BN),
              "#16's partial tile fits the ring");
static_assert(gemm_smem(DW_STAGES, DW_BN) <= 232448, "#16's ring fits a block's shared memory");
static_assert(BOX_BYTES == SW128_BOX, "sdesc's default LBO is one MN-major box");

// The main loop of one 128 x BN tile of C = s * (A0 . B0) + A1 . B1, rows
// m0 and columns c0 of C: n0 steps of GK over (A0, B0) from reduction index
// 0, whose sum is scaled by s = scal[2] in registers, then n1 steps over
// (A1, B1) from reduction index k1 on top. K-major operands (MN = false,
// #14/#15) are tensor maps of (rows, reduction) matrices read in GK x 128
// (or BN) boxes, C = A . B^T; MN-major ones (MN = true, #16) maps of
// (reduction, rows) matrices read in 64 x GK boxes, 128 / 64 per A tile
// and BN / 64 per B tile, C = A^T . B. Every map is 3-D (`bf16_map_s`): the
// matrices of student `stu` are read. A ring of S stages. Called by all
// GEMM_THREADS threads of a block launched with gemm_smem(S, BN) bytes of
// dynamic shared memory: warpgroups 0 and 1 are the consumers, and each
// returns true with its 64 rows of C in acc (BN / 2 floats, the layout of
// `store_tile`); the producer warp returns false once it has started every
// load (the consumers have waited for all of them when they return).
template <int BN, bool MN, int S>
__device__ __forceinline__ bool gemm_tile(const CUtensorMap* a0, const CUtensorMap* b0, int n0,
                                          const CUtensorMap* a1, const CUtensorMap* b1, int n1,
                                          int k1, int m0, int c0, int stu,
                                          const float* __restrict__ scal, float* acc) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  constexpr int SB = stage_bytes(BN), NA = BN / 2;
  const uint32_t full = base + S * SB, empty = full + 8 * S;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, total = n0 + n1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread keeps the ring full
    if (t == 0) {
      for (int i = 0; i < total; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(empty + 8 * s, (i / S - 1) & 1);
        const bool first = i < n0;
        const CUtensorMap* a = first ? a0 : a1;
        const CUtensorMap* b = first ? b0 : b1;
        const int k = first ? i * GK : k1 + (i - n0) * GK;
        const uint32_t dst = base + s * SB;
        mbar_expect_tx(full + 8 * s, SB);
        if (MN) {
          tma_load3(dst, a, m0, k, stu, full + 8 * s);
          tma_load3(dst + BOX_BYTES, a, m0 + 64, k, stu, full + 8 * s);
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma_load3(dst + A_BYTES + h * BOX_BYTES, b, c0 + 64 * h, k, stu, full + 8 * s);
        } else {
          tma_load3(dst, a, k, m0, stu, full + 8 * s);
          tma_load3(dst + A_BYTES, b, k, c0, stu, full + 8 * s);
        }
      }
    }
    return false;
  }

  // consumers: warpgroup w owns rows [64 w, 64 w + 64), which are the first
  // BOX_BYTES of an A tile (K-major) or its box w (MN-major) alike
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] = 0.f;
  int released = 0;  // steps whose stage has been handed back
  for (int i = 0; i < total; ++i) {
    const int s = i % S;
    mbar_wait(full + 8 * s, (i / S) & 1);
    const uint32_t a = base + s * SB + wg * BOX_BYTES;
    const uint32_t b = base + s * SB + A_BYTES;
    fence_acc<NA>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk) wgmma<BN, MN>(acc, sdesc<MN>(a, kk), sdesc<MN>(b, kk));
    wgmma_commit();
    fence_acc<NA>(acc);
    int done;  // steps [0, done) have finished reading shared memory
    if (i == n0 - 1) {  // the end of the scaled sum
      wgmma_wait<0>();
      fence_acc<NA>(acc);
      const float sc = scal[2];
#pragma unroll
      for (int e = 0; e < NA; ++e) acc[e] *= sc;
      done = i + 1;
    } else {
      wgmma_wait<1>();
      done = i;
    }
    fence_acc<NA>(acc);
    for (; released < done; ++released)
      if (t == 0) mbar_arrive(empty + 8 * (released % S));
  }
  wgmma_wait<0>();
  fence_acc<NA>(acc);
  return true;
}

// Accumulator e of consumer thread t of warpgroup w: row 64 w + 16 (t/32)
// + (t%32)/4 + 8 ((e>>1)&1), column 8 (e>>2) + 2 (t%4) + (e&1).
__device__ __forceinline__ int acc_row(int h) {
  const int t = threadIdx.x % 128;
  return 64 * (threadIdx.x / 128) + 16 * (t / 32) + (t % 32) / 4 + 8 * h;
}
__device__ __forceinline__ int acc_col(int j) { return 8 * j + 2 * (threadIdx.x % 4); }

// Stores a consumer's BN / 2 accumulators, tile rows m0 and columns c0 of
// out (row stride ld), as op(value, column), masked to rows x cols (cols
// even).
template <int BN, typename Op>
__device__ __forceinline__ void store_tile(const float* acc, float* __restrict__ out, int ld,
                                           int m0, int c0, int rows, int cols, Op op) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + acc_row(h), col = c0 + acc_col(j);
      if (row < rows && col < cols)
        *reinterpret_cast<float2*>(out + (size_t)row * ld + col) =
            make_float2(op(acc[4 * j + 2 * h], col), op(acc[4 * j + 2 * h + 1], col + 1));
    }
  }
}

// #14: out = s * (xa . bq) + xq . WqT^T + bias, one block per output tile
// (x over N, y over M, z the student). nr LoRA steps (xa against bq^T), nk
// K steps.
__global__ void __launch_bounds__(GEMM_THREADS, 2)
fl_fwd_wgmma(const __grid_constant__ CUtensorMap xa, const __grid_constant__ CUtensorMap bqt,
             const __grid_constant__ CUtensorMap xq, const __grid_constant__ CUtensorMap wqt,
             int nr, int nk, const float* __restrict__ scal, const float* __restrict__ bias,
             float* __restrict__ out, int M, int N) {
  const int m0 = blockIdx.y * GM, c0 = blockIdx.x * GN, stu = blockIdx.z;
  float acc[64];
  if (gemm_tile<GN, false, STAGES>(&xa, &bqt, nr, &xq, &wqt, nk, 0, m0, c0, stu,
                                   scal + 4 * stu, acc))
    store_tile<GN>(acc, out + (size_t)stu * M * N, N, m0, c0, M, N, AddBias{bias});
}

// #15: blocks x < nkt are dxq tiles (g against Wq, n steps over N), the
// rest dxa tiles (g against bq, scaled by s); z is the student.
__global__ void __launch_bounds__(GEMM_THREADS, 2)
fl_bwd_dx_wgmma(const __grid_constant__ CUtensorMap g, const __grid_constant__ CUtensorMap wq,
                const __grid_constant__ CUtensorMap bq, int n, int nkt,
                const float* __restrict__ scal, float* __restrict__ dxq, float* __restrict__ dxa,
                int M, int K, int r) {
  const int m0 = blockIdx.y * GM, stu = blockIdx.z;
  scal += 4 * stu;
  float acc[64];
  if ((int)blockIdx.x < nkt) {
    const int c0 = blockIdx.x * GN;
    if (gemm_tile<GN, false, STAGES>(&g, &wq, 0, &g, &wq, n, 0, m0, c0, stu, scal, acc))
      store_tile<GN>(acc, dxq + (size_t)stu * M * K, K, m0, c0, M, K, Identity());
  } else {
    const int c0 = (blockIdx.x - nkt) * GN;
    if (gemm_tile<GN, false, STAGES>(&g, &bq, n, &g, &bq, 0, 0, m0, c0, stu, scal, acc))
      store_tile<GN>(acc, dxa + (size_t)stu * M * r, r, m0, c0, M, r, Identity());
  }
}

// #16: student stu's dw tile of rows k0 of K and columns n0 of N over the
// z-th of `split` chunks of its M rows (`chunks`; z = blockIdx.x, the
// block's rank in a cluster of split = gridDim.x blocks). The grid's y
// dimension and z modulo nz walk the tiles of K and N, the smaller count on
// y (kfast: y over K); z / nz is the student, outermost, so that the blocks
// in flight at once read one student's operands. Unsplit, the block stores
// dw through the student's STE; split, the cluster's blocks sum their
// partial tiles through distributed shared memory, then clamp. Student
// stu's tile goes to its own (K, N) block of dw.
__global__ void __launch_bounds__(GEMM_THREADS, 1)
fl_bwd_dw_wgmma(const __grid_constant__ CUtensorMap xq, const __grid_constant__ CUtensorMap g,
                const float* __restrict__ scal, float* __restrict__ dw, int K, int N,
                DwChunks chunks, int kfast, int nz) {
  const int split = gridDim.x, z = blockIdx.x;
  const int stu = blockIdx.z / nz, tz = blockIdx.z - stu * nz;
  const int k0 = (kfast ? blockIdx.y : tz) * GM;
  const int n0 = (kfast ? tz : blockIdx.y) * DW_BN;
  scal += 4 * stu;
  dw += (size_t)stu * K * N;
  int r0 = 0, r1 = 0;  // selected, not indexed: no copy of chunks in local memory
#pragma unroll
  for (int q = 0; q < MAX_SPLIT; ++q)
    if (q == z) r0 = chunks.row[q], r1 = chunks.row[q + 1];
  const int steps = (r1 - r0 + GK - 1) / GK;
  float acc[DW_BN / 2];
  const bool consumer = gemm_tile<DW_BN, true, DW_STAGES>(&xq, &g, 0, &xq, &g, steps, r0, k0,
                                                          n0, stu, scal, acc);
  if (split == 1) {
    if (consumer) store_tile<DW_BN>(acc, dw, N, k0, n0, K, N, SteClamp{ste_clamps(scal)});
    return;
  }

  // The cluster's sum. The ring is idle once both warpgroups have waited
  // for their last wgmma; each consumer stores its accumulators there (row
  // pitch RED_PITCH: a half-warp's float2 stores fall in distinct banks).
  // The producer warp stays to the end: it takes part in the barriers.
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ uint8_t smem_raw[];
  float* part = reinterpret_cast<float*>(
      smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw)));
  __syncthreads();
  if (consumer) {
#pragma unroll
    for (int j = 0; j < DW_BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + acc_row(h) * RED_PITCH + acc_col(j)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  cluster.sync();
  // block z finishes rows [z * per, (z + 1) * per) of the tile, 4 columns a
  // thread, summing the cluster's partials in the order of rank
  const bool clamp = ste_clamps(scal);
  const int per = (GM + split - 1) / split, e1 = min(GM, (z + 1) * per) * (DW_BN / 4);
  for (int e = z * per * (DW_BN / 4) + (int)threadIdx.x; e < e1; e += GEMM_THREADS) {
    const int r = e / (DW_BN / 4), c = 4 * (e % (DW_BN / 4));
    float4* p = reinterpret_cast<float4*>(part + r * RED_PITCH + c);
    float4 v[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)  // all loads first: they overlap
      if (q < split) v[q] = *cluster.map_shared_rank(p, q);
    float4 sum = v[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q)
      if (q < split) {
        sum.x += v[q].x;
        sum.y += v[q].y;
        sum.z += v[q].z;
        sum.w += v[q].w;
      }
    const SteClamp ste{clamp};
    // N is a multiple of 8: four columns are in or out together
    if (k0 + r < K && n0 + c < N)
      *reinterpret_cast<float4*>(dw + (size_t)(k0 + r) * N + n0 + c) =
          make_float4(ste(sum.x, 0), ste(sum.y, 0), ste(sum.z, 0), ste(sum.w, 0));
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// ---------------------------------------------------------------------------
// Host entry points (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------
//
// Each takes S >= 1 students: every per-student operand and output holds S
// equal blocks one after the other (xq (S, M, K), ws (S, N), scal (S, 4),
// ...), w and the bias one block shared by all. One call launches each
// kernel once for all S.

static inline int tiles(int n) { return (n + TILE - 1) / TILE; }
static inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// K, N, r multiples of 8 (16-byte TMA strides), 16-byte aligned operands.
static bool tma_ok(int K, int N, int r, std::initializer_list<const void*> ptrs) {
  if ((K | N | r) & 7) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
}

// The map of S bf16 matrices (rows, inner), row-major, one after the other
// (one per student), read in boxes of 64 inner values (128 bytes, the
// 128-byte swizzle) x box_rows rows x one student: GM rows for the K-major
// operands of #14/#15, GK for the MN-major ones of #16. A box is laid out
// in shared memory as the 2-D map's box of `bf16_map` is. Boxes past a
// matrix's edge are filled with zeros: a box never reads the next
// student's rows.
static int bf16_map_s(CUtensorMap* map, const void* ptr, int inner, int rows, int S,
                      int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)S};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, (cuuint64_t)inner * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult rc = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                          strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// #14 with float operands: out (S, M, N) float32 from float xq (S, M, K),
// xa (S, M, r), bq (S, r, N), float32 ws, wz (S, N), scal (S, 4), and the
// shared float32 w (K, N) and bias (N).
extern "C" int fused_linear_fwd_f32(const float* xq, const float* xa, const float* w,
                                    const float* ws, const float* wz, const float* bq,
                                    const float* bias, const float* scal, float* out, int M,
                                    int K, int N, int r, int S, int symmetric, float eps,
                                    cudaStream_t stream) {
  if (((K | N | r) & 1) || S < 1) return (int)cudaErrorInvalidValue;
  fl_fwd<<<dim3(tiles(N), tiles(M), S), NT, 0, stream>>>(xq, xa, w, ws, wz, bq, bias, scal, out,
                                                         M, K, N, r, symmetric, eps);
  return (int)cudaGetLastError();
}

// #15 with float operands: dxq (S, M, K) and dxa (S, M, r) float32 from
// float g (S, M, N) and bq (S, r, N), float32 ws, wz (S, N), scal (S, 4)
// and the shared w (K, N).
extern "C" int fused_linear_bwd_dx_f32(const float* g, const float* w, const float* ws,
                                       const float* wz, const float* bq, const float* scal,
                                       float* dxq, float* dxa, int M, int K, int N, int r, int S,
                                       int symmetric, float eps, cudaStream_t stream) {
  if (((K | N | r) & 1) || S < 1) return (int)cudaErrorInvalidValue;
  const int nk = tiles(K), nr = r > 0 ? tiles(r) : 0;
  fl_bwd_dx<<<dim3(nk + nr, tiles(M), S), NT, 0, stream>>>(g, w, ws, wz, bq, scal, dxq, dxa, M,
                                                           K, N, r, nk, symmetric, eps);
  return (int)cudaGetLastError();
}

static int fq_launch(const float* w, const float* ws, const float* wz, const float* scal,
                     const void* bq, void* dst, void* bqt, int K, int N, int r, int S, int trans,
                     int symmetric, float eps, cudaStream_t stream) {
  const int rt = trans && r > 0 ? cdiv(r, 32) : 0;
  fl_fq_weight<<<dim3(cdiv(N, 32), cdiv(K, 32) + rt, S), dim3(32, 8), 0, stream>>>(
      w, ws, wz, scal, static_cast<const bf16*>(bq), static_cast<bf16*>(dst),
      static_cast<bf16*>(bqt), K, N, r, trans, symmetric, eps);
  return (int)cudaGetLastError();
}

// The weight prologue of #14/#15 alone: dst = bf16(FQ(w)) of each of S
// students from the shared float32 w (K, N) and its ws, wz (S, N), scal
// (S, 4); (S, K, N) with trans = 0, (S, N, K) with trans = 1, when bq
// (S, r, N) bf16 is also copied to bqt (S, N, r).
extern "C" int fused_linear_fq_weight(const float* w, const float* ws, const float* wz,
                                      const float* scal, const void* bq, void* dst, void* bqt,
                                      int K, int N, int r, int S, int trans, int symmetric,
                                      float eps, cudaStream_t stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  return fq_launch(w, ws, wz, scal, bq, dst, bqt, K, N, r, S, trans, symmetric, eps, stream);
}

// #14 with bf16 operands: out (S, M, N) float32 from xq (S, M, K),
// xa (S, M, r), bq (S, r, N), float32 ws, wz (S, N), scal (S, 4), and the
// shared float32 w (K, N) and bias (N). The prologue writes WqT (S, N, K)
// and then bqT (S, N, r) into the bf16 workspace `work` of S * N * (K + r)
// elements; then the GEMM reads them. One call, two launches.
extern "C" int fused_linear_fwd_wgmma(const void* xq, const void* xa, const float* w,
                                      const float* ws, const float* wz, const void* bq,
                                      const float* bias, const float* scal, void* work,
                                      float* out, int M, int K, int N, int r, int S,
                                      int symmetric, float eps, cudaStream_t stream) {
  bf16* wqt = static_cast<bf16*>(work);
  bf16* bqt = wqt + (size_t)S * N * K;
  if (S < 1 || !tma_ok(K, N, r, {xq, wqt}) || (r > 0 && !tma_ok(0, 0, 0, {xa, bqt})))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mxq, mwqt, mxa, mbqt;
  int rc = bf16_map_s(&mxq, xq, K, M, S, GM);
  if (!rc) rc = bf16_map_s(&mwqt, wqt, K, N, S, GM);
  if (!rc && r > 0) rc = bf16_map_s(&mxa, xa, r, M, S, GM);
  if (!rc && r > 0) rc = bf16_map_s(&mbqt, bqt, r, N, S, GM);
  if (rc) return rc;
  if (r == 0) mxa = mxq, mbqt = mwqt;  // never loaded
  static const cudaError_t e = cudaFuncSetAttribute(
      fl_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, gemm_smem(STAGES, GN));
  if (e != cudaSuccess) return (int)e;
  rc = fq_launch(w, ws, wz, scal, bq, wqt, bqt, K, N, r, S, 1, symmetric, eps, stream);
  if (rc) return rc;
  fl_fwd_wgmma<<<dim3(cdiv(N, GN), cdiv(M, GM), S), GEMM_THREADS, gemm_smem(STAGES, GN),
                 stream>>>(
      mxa, mbqt, mxq, mwqt, r > 0 ? cdiv(r, GK) : 0, cdiv(K, GK), scal, bias, out, M, N);
  return (int)cudaGetLastError();
}

// #15 with bf16 operands: dxq (S, M, K) and dxa (S, M, r) float32 from
// g (S, M, N), bq (S, r, N), float32 ws, wz (S, N), scal (S, 4) and the
// shared w (K, N). The prologue writes Wq (S, K, N) into the bf16
// workspace `work` of S * K * N elements; then the GEMM reads it. One call,
// two launches.
extern "C" int fused_linear_bwd_dx_wgmma(const void* g, const float* w, const float* ws,
                                         const float* wz, const void* bq, const float* scal,
                                         void* work, float* dxq, float* dxa, int M, int K, int N,
                                         int r, int S, int symmetric, float eps,
                                         cudaStream_t stream) {
  if (S < 1 || !tma_ok(K, N, r, {g, work}) || (r > 0 && !tma_ok(0, 0, 0, {bq})))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mg, mwq, mbq;
  int rc = bf16_map_s(&mg, g, N, M, S, GM);
  if (!rc) rc = bf16_map_s(&mwq, work, N, K, S, GM);
  if (!rc && r > 0) rc = bf16_map_s(&mbq, bq, N, r, S, GM);
  if (rc) return rc;
  if (r == 0) mbq = mwq;  // never loaded
  static const cudaError_t e = cudaFuncSetAttribute(
      fl_bwd_dx_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, gemm_smem(STAGES, GN));
  if (e != cudaSuccess) return (int)e;
  rc = fq_launch(w, ws, wz, scal, nullptr, work, nullptr, K, N, 0, S, 0, symmetric, eps, stream);
  if (rc) return rc;
  const int nkt = cdiv(K, GN), nrt = r > 0 ? cdiv(r, GN) : 0;
  fl_bwd_dx_wgmma<<<dim3(nkt + nrt, cdiv(M, GM), S), GEMM_THREADS, gemm_smem(STAGES, GN),
                    stream>>>(
      mg, mwq, mbq, cdiv(N, GK), nkt, scal, dxq, dxa, M, K, r);
  return (int)cudaGetLastError();
}

// #16 with float operands: dw (S, K, N) float32, each student's own sum
// through its STE, from float xq (S, M, K) and g (S, M, N), scal (S, 4);
// one block per 128 x 128 tile of a student's dw over all of its M rows.
extern "C" int fused_linear_bwd_dw_f32(const float* xq, const float* g, const float* scal,
                                       float* dw, int M, int K, int N, int S,
                                       cudaStream_t stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  fl_bwd_dw<<<dim3(tiles(N), tiles(K), S), NT, 0, stream>>>(xq, g, scal, dw, M, K, N);
  return (int)cudaGetLastError();
}

// #16 with bf16 operands: dw (S, K, N) float32, each student's own sum
// through its STE, from xq (S, M, K) and g (S, M, N), scal (S, 4); each
// student's M rows in `split` (1-8) chunks, one per block of a cluster:
// chunk z is rows [rows[z], rows[z + 1]) (host memory, split + 1 bounds
// from 0 to M, each but the last on a GK step, rising; the plan comes from
// ops/fused_linear.py::dw_splits and dw_chunks). One call: the two
// MN-major tensor maps, one launch.
extern "C" int fused_linear_bwd_dw_wgmma(const void* xq, const void* g, const float* scal,
                                         float* dw, int M, int K, int N, int S, int split,
                                         const int* rows, cudaStream_t stream) {
  if (S < 1 || split < 1 || split > MAX_SPLIT || !tma_ok(K, N, 0, {xq, g}) || rows[0] != 0 ||
      rows[split] != M)
    return (int)cudaErrorInvalidValue;
  DwChunks chunks = {};
  for (int z = 0; z <= split; ++z) {
    if (z < split && (rows[z] % GK != 0 || rows[z] >= rows[z + 1]))
      return (int)cudaErrorInvalidValue;
    chunks.row[z] = rows[z];
  }
  CUtensorMap mxq, mg;
  int rc = bf16_map_s(&mxq, xq, K, M, S, GK);
  if (!rc) rc = bf16_map_s(&mg, g, N, M, S, GK);
  if (rc) return rc;
  static const cudaError_t e = cudaFuncSetAttribute(
      fl_bwd_dw_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gemm_smem(DW_STAGES, DW_BN));
  if (e != cudaSuccess) return (int)e;
  int kt = cdiv(K, GM), nt = cdiv(N, DW_BN), kfast = kt <= nt, nz = kfast ? nt : kt;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, kfast ? kt : nt, nz * S);
  cfg.blockDim = dim3(GEMM_THREADS);
  cfg.dynamicSmemBytes = gemm_smem(DW_STAGES, DW_BN);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&mxq, &mg, &scal, &dw, &K, &N, &chunks, &kfast, &nz};
  return (int)cudaLaunchKernelExC(&cfg, (const void*)fl_bwd_dw_wgmma, args);
}
