// Causal flash attention for sm_90a: the forward (serving, and training
// with the log-sum-exp rows) and the training backward.
//
// Replaces three Pallas kernels of llm_qat_tpu/ops/attention.py:
// - `_flash_kernel` (serving prefill, #2) and `_flash_fwd_kernel` (called by
//   `_flash_fwd_call`, #5) with `flash_forward_wgmma` (bf16 operands, at
//   head_dim 64 and 128) or `flash_forward_f32` (float32 operands), the one
//   forward without or with the log-sum-exp rows;
// - `_flash_bwd_kernel` (called by `_flash_train_bwd`) with
//   `flash_bwd_wgmma` (bf16 operands) or `flash_bwd_f32` (float32
//   operands), each two or three CUDA kernels that together compute what
//   the one TPU kernel does.
// The Python wrappers are llm_qat_tpu_torch/ops/attention.py::
// flash_attention, ::flash_fwd_lse and ::flash_bwd; `flash_attention_plain`,
// `flash_fwd_lse_plain` and `flash_bwd_plain` beside them compute the same
// functions in plain PyTorch.
//
// Operands q, k, v, o, dO are (B*H, T, D) in the operand type (float or
// bf16), LSE and the row dots D are (B*H, T) float32. As in the JAX
// kernels, every product is taken from the operand values (a bf16 x bf16
// product is exact in float32) and summed in float32, with no TF32;
// `sm_scale` is applied to the float32 sums; P is rounded to the operand
// type before P.V and before dV = P^T.dO, and dS = P*(dP - D) before
// dQ = dS.K and dK = dS^T.Q; the running max/sum and all accumulators stay
// float32, and the outputs are written in the operand type. The bf16
// kernels take 128-row blocks and 64-row steps, and all kernels mask the
// ragged tail themselves (keys and query rows >= T), so T
// need not be a multiple of the tile.
//
// Where the forward rounds P. The JAX kernels take k-blocks of block_k keys
// (128 or 256, `flash_blocks`) and round P at the running max of the row
// over the blocks so far, m = max(m_prev, the block's max), so the rounding
// depends on the block. The forwards here take block_k as an argument and
// keep that rule: a k-block is 1, 2 or 4 of their 64-key tiles, its row
// maxima are taken over all its tiles before any of its P is formed, and O
// and l are rescaled by exp(m_prev - m) once per block.
//
// Forward, float32 operands (`flash_fwd_f32<D, RM, LSE>`; the served
// prefill's q, k, v and the evaluation and RPI forwards): float32 has no
// exact product on the tensor cores, so both products are float32 FMA on
// the CUDA cores, fed from shared memory. One block of 128 threads per
// (b*h, 16*RM-row q tile; RM = 4, or 2 for a call too narrow to fill the
// card, from `ops/attention.py::flash_fwd_plan`), the longest causal walks
// launched first. Each thread owns RM rows x 4 keys of S and RM rows x D/8
// columns of O in registers: at RM = 4, per 4 of d Q.K^T takes one 128-bit
// shared read per 8 FMAs, and per key P.V one per 10.7 (12.8 at D = 128).
// Shared memory delivers 32 floats a clock an SM, broadcast or not, against
// 128 FMAs issued, so the products wait on shared memory at about its
// rate; three blocks an SM (two at D = 128) hide the reads' latency. (8
// rows a thread, 224 registers and two blocks an SM, reads less but hid
// less, and was no faster at any shape.) RM = 2 halves a thread's work a
// tile for calls with fewer blocks than SMs, where the walk's latency
// counts and shared memory is not busy. P goes to shared memory once, laid
// out so that a thread's RM rows at one key are one float4 (float2). Q is
// loaded once and the 32-key K/V tiles stream through a two-stage ring by
// 16-byte cp.async copies, the next tile's issued before the current one
// is used (zero-filled past T), row-major at pitch D + 4: every shared
// read and copy is free of bank conflicts. With float32
// operands P is exact, so each 32-key tile is its own block of the running
// max (the JAX k-block's rounding point changes nothing). With bf16
// operands (head_dim 64, every GPT-2 size, and 128) the forward is
// `flash_fwd_wgmma<D, LSE>`, on the tensor cores, in the wgmma backward's block
// layout (below): one block per (b*h, 128-row q tile), Q loaded once, the
// K/V tiles up to the causal limit through the TMA ring, which holds a
// whole k-block. Per k-block a warpgroup takes S = Q.K^T of each tile by
// wgmma from shared memory for the row maxima (over the thread's 16 values
// and its quad), scales O and l by exp(m_old - m) once, then per tile forms
// P from the accumulators' registers (the float32 P into the thread's share
// of the row sum, which the quad adds up at the end), rounds it to bf16
// pairs in place and takes O += P.V in wgmma's register form, V read
// MN-major. The block's last tile's S is kept from the first walk and goes
// first; its other tiles are taken again (one more Q.K^T each, no more
// expf). At head_dim 128 a row is two 128-byte swizzle boxes: Q.K^T takes
// its k16 slices from box kk / 4, P.V is two products of 64 columns, and
// the block's 195 KB of shared memory (the ring of 32 KB stages still holds
// a 256-key k-block) and 64 output accumulators a thread leave one block an
// SM, where head_dim 64 has two. The template flag LSE writes the
// log-sum-exp rows (#5) or not (#2). Each output row is written by one
// block, so repeat calls are bit-equal.
//
// Backward (FlashAttention-2 order, deterministic, no atomics). The JAX
// kernel holds the whole T x T of one (b, h) in VMEM; at T = 1024 that is
// 4 MB in float32, far over a block's 227 KB of shared memory, so here it
// is blocked in two passes, each output element written by exactly one
// block, which recompute S and dP:
//   1. D = rowsum(dO * O) in float32;
//   2. dK and dV per k tile: the tile's K and V stay, the q tiles from the
//      causal start stream past; per q tile S and P = exp(S*scale - LSE)
//      from the saved LSE, dP = dO.V^T, then dV += P^T.dO and dK += dS^T.Q;
//   3. dQ per q tile: Q and dO stay, the k tiles up to the causal limit
//      stream past; per k tile P and dS again, then dQ += dS.K.
// With bf16 operands (`flash_bwd_wgmma`, the training path; head_dim 64 at
// every GPT-2 size, and 128) the three are `flash_bwd_prep<D>`,
// `flash_bwd_dkdv_wgmma<D>` and `flash_bwd_dq_wgmma<D>`, on the tensor
// cores:
// - A block of 288 threads owns a 128-row tile: two consumer warpgroups of
//   64 rows each and one producer warp. The producer's first thread loads
//   the own tiles once and keeps a 4-stage ring of 64-row tiles filled by
//   TMA (3-D tensor maps over (B*H, T, D), boxes of 64 columns with the
//   128-byte swizzle, D / 64 a tile: a box past T is zero-filled and never
//   reads the next head's rows) and bulk copies
//   of the row vectors, with a full and an empty mbarrier per stage.
// - Per step a warpgroup runs two m64n64 wgmma products from shared memory
//   (S^T = K.Q^T and dP^T = V.dO^T, or S = Q.K^T and dP = dO.V^T; every
//   operand K-major over head_dim), computes P and dS in the accumulators'
//   registers, rounds them to bf16 pairs in place, and feeds them as the A
//   operand of wgmma's register form (the accumulator layout of columns
//   16 kk .. 16 kk + 15 is the A operand's layout of the k16 slice kk), so
//   P and dS never go to shared memory. The B operands of those products
//   (dO and Q for dV and dK, K for dQ) are the same shared tiles read
//   MN-major, since their reduction index is the tile's row.
// - At head_dim 128 a warpgroup's dK and dV for 64 keys would take 128
//   accumulators a thread, with S^T, dP^T, P^T and dS^T 224 registers, over
//   the 168 ptxas gives a thread of 288 (it spilled). So a dK/dV block there
//   owns 64 keys: both warpgroups take the whole S^T and dP^T of them (in
//   the same registers as at head_dim 64), and warpgroup w accumulates the
//   64 columns of dK and dV in box w. S^T and dP^T are taken twice (six
//   64 x 64 x 128 products a step for the 64 keys where four would do), and
//   Q and dO stream once per 64 keys.
// - Tiles wholly above the diagonal are skipped; tiles on the diagonal or
//   past T are masked element by element. The blocks whose walk is longest
//   launch first (the dK/dV kernel's first k tile, the dQ kernel's last q
//   tile), so that the short walks fill the last wave.
// - `flash_bwd_prep` pads each head's LSE and D to t_pad rows (a multiple
//   of 128) with zeros, so that the bulk copies of the vectors stay within
//   the head; it reads O and dO in 16-byte loads, eight threads a row.
// Float32 operands (`flash_bwd_f32`: the RPI gradient importance, and SP
// training at compute_dtype "float32") run `flash_bwd_rowdot` and then the
// kernels of `ops/attention.py::flash_bwd_plan`'s order, on the float32
// forward's template: exact float32 FMA on the CUDA cores, 128 threads a
// block, each thread RM rows x 4 streamed indices of S and dP and RM rows x
// D / 8 columns of its accumulators, the block's own tile (16 RM rows:
// K and V for dK/dV; Q, dO and their LSE and D rows for dQ) loaded once,
// the streamed 32-row tiles (Q, dO, LSE, D; or K, V) through a two-stage
// ring of cp.async copies issued a tile ahead, zero-filled past T, at pitch
// D + 4; P and dS through shared memory once each (a thread's RM rows at one
// index are one float4 or float2, within its warp); a warp whose rows all
// lie on the far side of a tile's diagonal skips it (the same bits). The
// bound at the RPI importance's (1, 12, 1024, 64): five causal products,
// 4.03 GFLOP, 0.060 ms at the 67 TFLOP/s float32 peak, beside 25 MB of
// operands and outputs (7.5 us): operations. Both products of a step wait
// on shared memory (8 FMAs a 128-bit read at RM = 4, 5.3 at RM = 2), so the
// orders trade products against balance:
// - "paired" (`flash_bwd_f32_pair`, one launch): block (bh, j) walks the dK/dV
//   pass of tile j (the q tiles from j * 16 RM to T) and then the dQ pass of
//   tile j (the k tiles up to (j + 1) * 16 RM), so every block walks about
//   T + 16 RM rows: seven products (the dQ pass recomputes S and dP), but a
//   call whose blocks fit in one wave is balanced. At (1, 12, 1024, 64) the
//   two-launch order leaves the card to the dK/dV pass's tile 0, whose 32
//   q tiles a lone block on its SM walks at about half the SM's rate;
// - "scratch" (`flash_bwd_f32_dkdv` then `flash_bwd_f32_dq_ds`): the dK/dV
//   pass also writes dS (float32, the causal tiles and the zeros of
//   skipped ones) to a scratch in the dQ pass's shared layout, and the dQ
//   pass is one product, dS.K: five products, 4 MB a head at T = 1024
//   written and read again (mostly from L2); taken where the call spans
//   several waves.
// The two passes of seven products as two launches lost to one of these at
// every shape measured. Each kernel launches its longest walks first.
//
// Bounds. Serving forward at the prefill's (8, 12, 128, 64) in bf16: q, k,
// v read once and o written once (8 * T * D bytes per (b, h), 6.29 MB,
// 1.9 us at 3.35 TB/s) and 2*T*(T+1)*D flops per (b, h) for QK^T and PV
// over the causal half (0.2 GFLOP, 0.2 us at the bf16 tensor-core peak):
// bound by bytes. In float32 the bytes double (12.6 MB, 3.8 us) and the
// products run on the CUDA cores (67 TFLOP/s: 3.0 us), still bound by
// bytes; from T = 512 on that route is bound by operations: at the
// evaluation's (16, 12, 1024, 64) with the LSE, 25.8 GFLOP, 0.385 ms,
// beside 202 MB, 0.060 ms. `flash_fwd_f32` spends about 10 more operations
// a causal score than the 128 FMAs of its two products (the scale, the
// mask on edge tiles, the max, an expf, the row sum) and computes the
// diagonal tiles whole (6-12 % more pairs than the causal half at T =
// 1024). Training, at (B, H, T, D) = (8, 12, 1024, 64) in bf16.
// Forward: q, k, v and o once (4 x 12.58 MB) plus LSE (0.39 MB), 50.7 MB,
// 15 us at 3.35 TB/s; Q.K^T and P.V over the causal half,
// 2 * 2 * D * T(T+1)/2 per (b, h), 12.9 GFLOP, 13 us at the bf16
// tensor-core peak (989 TFLOP/s): bound by bytes, and nearly as much by
// operations. `flash_fwd_wgmma` reads each K/V tile once per 128 q rows
// (8 x 0.5 of K and V over the causal half at T = 1024, mostly from L2)
// and runs the element-wise chain (two expf per score and a dozen other
// operations) on the CUDA cores beside the products. Backward: q, k, v, o, dO
// read and dq, dk, dv written, 8 x 12.58 MB plus LSE, 101 MB, 30 us; five
// causal products (S, dP, dV, dQ, dK), 32.2 GFLOP, 33 us: bound by
// operations. The two-pass order recomputes S and dP: seven products,
// 45 GFLOP, 46 us at the bf16 peak, plus P and dS twice on the CUDA cores
// (an expf and about a dozen other operations per causal element and
// pass). At head_dim 128 with half the heads, (8, 6, 1024, 128), the
// bytes and the products are the same; the element-wise work halves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "sm90.cuh"

#define NEG_INF (-1e30f)

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float to_f(float x) { return x; }

// ---------------------------------------------------------------------------
// Forward with float32 operands (#2's served route, #5's float32 route)
// ---------------------------------------------------------------------------

#define F32_THREADS 128  // 16 x 8 threads (ty, tx)
#define F32_BK 32        // keys a tile

// A 16-byte asynchronous copy into shared memory; with in == false it reads
// nothing and writes zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) of one head's (seq, D) float32 rows into dst, row-major at
// pitch D + 4, by 16-byte asynchronous copies (consecutive threads take
// consecutive 16 bytes of a row); rows past seq are zero-filled.
template <int D, int R>
__device__ __forceinline__ void f32_rows_async(float* dst, const float* __restrict__ src, int r0,
                                               int seq, int tid) {
  constexpr int CH = D / 4;
  static_assert(R * CH % F32_THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int n = 0; n < R * CH / F32_THREADS; ++n) {
    const int i = tid + n * F32_THREADS, r = i / CH, c = i % CH, gr = r0 + r;
    const bool in = gr < seq;
    cp_async16(dst + r * (D + 4) + 4 * c, src + (size_t)(in ? gr : 0) * D + 4 * c, in);
  }
}

// The block's tile: ROWS = 16 * RM query rows, the K/V ring's depth, the
// blocks an SM holds (BLOCKS: shared memory and registers allow them) and
// the shared-memory layout of `flash_fwd_f32`. RM = 4: 60 KB and 150
// registers at D = 64, three blocks an SM; 108 KB and about 200 registers
// at D = 128, two. RM = 2 (D = 64): 48 KB, four.
template <int D, int RM>
struct F32Tile {
  static_assert(RM == 2 || RM == 4, "a thread's rows at one key are one float2 or float4");
  static constexpr int ROWS = 16 * RM, DP = D + 4, PP = ROWS + 4;
  static constexpr int STAGES = 2;
  static constexpr int BLOCKS = RM == 2 ? 4 : (D == 64 ? 3 : 2);
  static constexpr size_t SMEM =
      sizeof(float) * (ROWS * DP + 2 * STAGES * F32_BK * DP + F32_BK * PP);
};

// One block per (b*h, ROWS-row q tile), the last q tile (the longest causal
// walk) first. Thread (ty, tx) owns rows 4 RM w + ty % 4 + 4 i (i < RM, w =
// ty / 4 its warp), keys tx + 8 j of each tile (j < 4) and O's columns
// 32 c + 4 tx .. + 3 (c < D / 32). A warp's rows are contiguous, so on the
// diagonal a warp whose rows all lie above a tile's keys skips the tile
// (its P would be 0 and its m, l and O unchanged: the same bits). Q is
// loaded once and the K/V tiles up to the causal limit stream through the
// ring, each by asynchronous copies issued STAGES - 1 tiles ahead. Per tile:
// S = Q.K^T as float32 FMA over d ascending, times sm_scale, -1e30 above the
// diagonal and past seq; the row max over the 8 threads of the row; m, O and
// the thread's share of l rescaled by expf(m_old - m); P = expf(S - m) into
// Pt (a thread's RM rows at one key are adjacent: one float4 or float2 is
// read back; a row's P is written and read within its warp, so the warp
// alone waits for it); then O += P.V over the tile's keys ascending.
// One block barrier a tile, for the ring. At the end the shares of l are
// added in a fixed order, o = O / max(l, 1e-30) and, with LSE, lse = m +
// log(max(l, 1e-30)). Each output row is written by one block in a fixed
// order, so repeat calls are bit-equal.
template <int D, int RM, bool LSE>
__global__ void __launch_bounds__(F32_THREADS, (F32Tile<D, RM>::BLOCKS))
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int seq, float sm_scale) {
  using Tile = F32Tile<D, RM>;
  constexpr int ROWS = Tile::ROWS, DP = Tile::DP, PP = Tile::PP, ST = Tile::STAGES;
  constexpr int NC = D / 32;  // float4 groups of O's columns a thread owns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [ROWS][DP]
  float* Ks = Qs + ROWS * DP;                   // [ST][F32_BK][DP]
  float* Vs = Ks + ST * F32_BK * DP;            // [ST][F32_BK][DP]
  float* Pt = Vs + ST * F32_BK * DP;            // [F32_BK][PP], P[r0 + 4 i][c] at [c][RM ty + i]

  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const size_t off = (size_t)bh * seq * D;
  const float* kb = k + off;
  const float* vb = v + off;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int r0 = 4 * RM * (ty >> 2) + (ty & 3);  // the thread's first row in the tile
  const int w_end = q0 + 4 * RM * ((ty >> 2) + 1);  // past the warp's last row
  const int nt = (min(seq, q0 + ROWS) + F32_BK - 1) / F32_BK;  // key tiles to the causal limit

  // Q with the first ST - 1 tiles (one copy group each, empty past nt)
  f32_rows_async<D, ROWS>(Qs, q + off, q0, seq, tid);
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < nt) {
      f32_rows_async<D, F32_BK>(Ks + t * F32_BK * DP, kb, t * F32_BK, seq, tid);
      f32_rows_async<D, F32_BK>(Vs + t * F32_BK * DP, vb, t * F32_BK, seq, tid);
    }
    cp_async_commit();
  }

  float acc[RM][4 * NC], m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<ST - 2>();  // this thread's copies of tile t have landed
    __syncthreads();          // everyone's; and tile t - 1's stage and Pt are consumed
    const int tn = t + ST - 1;
    if (tn < nt) {
      f32_rows_async<D, F32_BK>(Ks + tn % ST * F32_BK * DP, kb, tn * F32_BK, seq, tid);
      f32_rows_async<D, F32_BK>(Vs + tn % ST * F32_BK * DP, vb, tn * F32_BK, seq, tid);
    }
    cp_async_commit();
    const float* Kt = Ks + t % ST * F32_BK * DP;
    const float* Vt = Vs + t % ST * F32_BK * DP;
    const int k0 = t * F32_BK;
    const bool live = k0 < w_end;  // the warp has a row at or below a key of the tile

    if (live) {
      float s[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 kf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kf[j] = *reinterpret_cast<const float4*>(Kt + (tx + 8 * j) * DP + d);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float4 qf = *reinterpret_cast<const float4*>(Qs + (r0 + 4 * i) * DP + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
            s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
            s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
            s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
          }
        }
      }

      // a tile with a key past the block's first row or past seq is masked
      const bool edge = k0 + F32_BK - 1 > q0 || k0 + F32_BK > seq;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int qi = q0 + r0 + 4 * i;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k0 + tx + 8 * j;
          float x = s[i][j] * sm_scale;
          if (edge && (kj > qi || kj >= seq)) x = NEG_INF;
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int w = 1; w < 8; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
        const float m_new = fmaxf(m[i], mx);
        const float corr = expf(m[i] - m_new);
        m[i] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          rs += s[i][j];
        }
        l[i] = l[i] * corr + rs;
#pragma unroll
        for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* dst = Pt + (tx + 8 * j) * PP + ty * RM;
        if constexpr (RM == 4)
          *reinterpret_cast<float4*>(dst) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        else
          *reinterpret_cast<float2*>(dst) = make_float2(s[0][j], s[1][j]);
      }
      __syncwarp();  // P complete: a row's P is written and read by the 8 threads of its row
#pragma unroll 8
      for (int kk = 0; kk < F32_BK; ++kk) {
        float p[RM];
        if constexpr (RM == 4) {
          const float4 pf = *reinterpret_cast<const float4*>(Pt + kk * PP + ty * RM);
          p[0] = pf.x;
          p[1] = pf.y;
          p[2] = pf.z;
          p[3] = pf.w;
        } else {
          const float2 pf = *reinterpret_cast<const float2*>(Pt + kk * PP + ty * RM);
          p[0] = pf.x;
          p[1] = pf.y;
        }
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float4 vf = *reinterpret_cast<const float4*>(Vt + kk * DP + 32 * cc + 4 * tx);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc[i][4 * cc] = fmaf(p[i], vf.x, acc[i][4 * cc]);
            acc[i][4 * cc + 1] = fmaf(p[i], vf.y, acc[i][4 * cc + 1]);
            acc[i][4 * cc + 2] = fmaf(p[i], vf.z, acc[i][4 * cc + 2]);
            acc[i][4 * cc + 3] = fmaf(p[i], vf.w, acc[i][4 * cc + 3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // the trailing groups are empty; none is left in flight

  float* ob = o + off;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float li = l[i];
#pragma unroll
    for (int w = 1; w < 8; w <<= 1) li += __shfl_xor_sync(0xffffffffu, li, w);
    const float den = fmaxf(li, 1e-30f);
    const int qi = q0 + r0 + 4 * i;
    if (qi < seq) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        *reinterpret_cast<float4*>(ob + (size_t)qi * D + 32 * cc + 4 * tx) =
            make_float4(acc[i][4 * cc] / den, acc[i][4 * cc + 1] / den,
                        acc[i][4 * cc + 2] / den, acc[i][4 * cc + 3] / den);
      if (LSE && tx == 0) lse[(size_t)bh * seq + qi] = m[i] + logf(den);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// D = rowsum(dO * O) in float32, one warp per row of the (B*H*T, D) view.
template <typename T, int D>
__global__ void flash_bwd_rowdot(const T* __restrict__ o, const T* __restrict__ dout,
                                 float* __restrict__ dvec, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const T* orow = o + (size_t)row * D;
  const T* drow = dout + (size_t)row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f(drow[c]) * to_f(orow[c]);
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) dvec[row] = s;
}

// ---------------------------------------------------------------------------
// Backward with float32 operands (#6's float32 route)
// ---------------------------------------------------------------------------

// A 4-byte asynchronous copy into shared memory (zero-filled with in ==
// false): the row vectors (LSE and D) of a streamed tile, whose first row
// need not be 16-byte aligned.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// The float32 backward's block: ROWS = 16 * RM own rows (k rows for dK/dV,
// q rows for dQ), F32_BK-row tiles streamed through a two-stage ring, the
// blocks an SM holds and the dynamic shared memory, the larger of the two
// passes' layouts (a paired block runs one after the other in it). D = 64:
// RM = 4, 77 KB, two blocks an SM; RM = 2, 56 KB, three. D = 128, RM = 2:
// 104 KB, two.
template <int D, int RM>
struct F32Bwd {
  static_assert(RM == 4 || RM == 2, "a thread's rows at one index are one float4 or float2");
  static constexpr int ROWS = 16 * RM, DP = D + 4, PP = ROWS + 4, ST = 2;
  static constexpr int BLOCKS = (D == 64 && RM == 2) ? 3 : 2;
  // dK/dV: own K and V; per stage Q, dO and their LSE and D rows; P, then dS
  static constexpr int KV_STAGE = 2 * F32_BK * DP + 2 * F32_BK;
  static constexpr int KV = 2 * ROWS * DP + ST * KV_STAGE + F32_BK * PP;
  // dQ: own Q, dO, LSE and D rows; per stage K and V; dS
  static constexpr int Q_STAGE = 2 * F32_BK * DP;
  static constexpr int QF = 2 * ROWS * DP + 2 * ROWS + ST * Q_STAGE + F32_BK * PP;
  static constexpr size_t SMEM = sizeof(float) * (KV > QF ? KV : QF);
};

// acc[i][j] = sum over d ascending of A[r0 + 4 i][d] * B[tx + 8 j][d]: the
// thread's RM x 4 scores of a (ROWS own rows) x (F32_BK streamed rows) tile,
// both row-major at pitch D + 4, float32 FMA.
template <int D, int RM>
__device__ __forceinline__ void f32_dots(const float* A, const float* B, int r0, int tx,
                                         float acc[RM][4]) {
  constexpr int DP = D + 4;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 bf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bf[j] = *reinterpret_cast<const float4*>(B + (tx + 8 * j) * DP + c);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 af = *reinterpret_cast<const float4*>(A + (r0 + 4 * i) * DP + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(af.x, bf[j].x, acc[i][j]);
        acc[i][j] = fmaf(af.y, bf[j].y, acc[i][j]);
        acc[i][j] = fmaf(af.z, bf[j].z, acc[i][j]);
        acc[i][j] = fmaf(af.w, bf[j].w, acc[i][j]);
      }
    }
  }
}

// The thread's RM x 4 values x[i][j] (own row r0 + 4 i, streamed index tx +
// 8 j) into Xt[tx + 8 j][ty * RM + i]: a thread's RM rows at one index are
// one float4 (float2). A row's values are written and read by the 8 threads
// of its row, within one warp.
template <int RM>
__device__ __forceinline__ void f32_put(float* Xt, int ty, int tx, const float x[RM][4]) {
  constexpr int PP = 16 * RM + 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* dst = Xt + (tx + 8 * j) * PP + ty * RM;
    if constexpr (RM == 4)
      *reinterpret_cast<float4*>(dst) = make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
    else
      *reinterpret_cast<float2*>(dst) = make_float2(x[0][j], x[1][j]);
  }
}

// acc[i][32 c + 4 tx + e] += sum over r ascending of Xt[r][ty * RM + i] *
// Y[r][32 c + 4 tx + e]: the thread's RM rows x D / 8 columns of a second
// product over the tile's F32_BK streamed rows (Y row-major at pitch D + 4).
template <int D, int RM>
__device__ __forceinline__ void f32_accumulate(const float* Xt, const float* Y, int ty, int tx,
                                               float acc[RM][D / 8]) {
  constexpr int DP = D + 4, PP = 16 * RM + 4;
#pragma unroll 8
  for (int r = 0; r < F32_BK; ++r) {
    float x[RM];
    if constexpr (RM == 4) {
      const float4 xf = *reinterpret_cast<const float4*>(Xt + r * PP + ty * RM);
      x[0] = xf.x;
      x[1] = xf.y;
      x[2] = xf.z;
      x[3] = xf.w;
    } else {
      const float2 xf = *reinterpret_cast<const float2*>(Xt + r * PP + ty * RM);
      x[0] = xf.x;
      x[1] = xf.y;
    }
#pragma unroll
    for (int cc = 0; cc < D / 32; ++cc) {
      const float4 yf = *reinterpret_cast<const float4*>(Y + r * DP + 32 * cc + 4 * tx);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        acc[i][4 * cc] = fmaf(x[i], yf.x, acc[i][4 * cc]);
        acc[i][4 * cc + 1] = fmaf(x[i], yf.y, acc[i][4 * cc + 1]);
        acc[i][4 * cc + 2] = fmaf(x[i], yf.z, acc[i][4 * cc + 2]);
        acc[i][4 * cc + 3] = fmaf(x[i], yf.w, acc[i][4 * cc + 3]);
      }
    }
  }
}

// The thread's RM rows x D / 8 columns of acc * scale into one head's (seq,
// D) rows: its row r0 + 4 i at row0 + r0 + 4 i, those past seq left out.
template <int D, int RM>
__device__ __forceinline__ void f32_store_rows(float* dst, const float acc[RM][D / 8],
                                               int row0, int r0, int tx, int seq, float scale) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + r0 + 4 * i;
    if (r < seq) {
#pragma unroll
      for (int cc = 0; cc < D / 32; ++cc)
        *reinterpret_cast<float4*>(dst + (size_t)r * D + 32 * cc + 4 * tx) =
            make_float4(acc[i][4 * cc] * scale, acc[i][4 * cc + 1] * scale,
                        acc[i][4 * cc + 2] * scale, acc[i][4 * cc + 3] * scale);
    }
  }
}

// The index in the dS scratch of (q, k) of head bh: per head, per q tile of
// ROWS rows and per key tile of F32_BK keys, a [F32_BK][ROWS] block in the
// dQ pass's shared layout (row q0 + r0 + 4 i of thread (ty, tx) at slot
// ty * RM + i), so that the dQ pass copies it as it stands.
template <int RM>
__device__ __forceinline__ size_t f32_ds_index(int bh, int seq, int q, int k) {
  constexpr int ROWS = 16 * RM;
  const int nqt = (seq + ROWS - 1) / ROWS, nkt = (seq + F32_BK - 1) / F32_BK;
  const int r = q % ROWS, w = r / (4 * RM), rr = r % (4 * RM);
  const int slot = (4 * w + rr % 4) * RM + rr / 4;
  return (((size_t)bh * nqt + q / ROWS) * nkt + k / F32_BK) * (F32_BK * ROWS) +
         (k % F32_BK) * ROWS + slot;
}

// x as dS of (q, k) into the scratch, for keys in the tiles the dQ pass
// reads (those past seq included: zeros); the last k tile's rows past them
// have no place.
template <int RM>
__device__ __forceinline__ void f32_ds_put(float* ds, int bh, int seq, int q, int k, float x) {
  if (k < (seq + F32_BK - 1) / F32_BK * F32_BK) ds[f32_ds_index<RM>(bh, seq, q, k)] = x;
}

// dK and dV of the k tile [k0, k0 + ROWS) of head bh. Thread (ty, tx) owns
// k rows r0 + 4 i (i < RM; a warp's 4 RM rows are contiguous), q index
// tx + 8 j (j < 4) of each streamed tile, and dK's and dV's columns 32 c +
// 4 tx .. + 3. K and V are loaded once; the q tiles from the causal start
// (k0 / F32_BK) to seq stream through the ring with their LSE and D rows,
// each issued a tile ahead by asynchronous copies (zero-filled past seq).
// Per q tile: S^T = K.Q^T and dP^T = V.dO^T (d ascending), P^T = exp(S^T *
// scale - LSE) (0 where q < k or q >= seq), dS^T = P^T * (dP^T - D); P^T to
// shared memory, dV += P^T.dO; then dS^T in its place, dK += dS^T.Q (q
// ascending). A warp whose rows all lie past the tile's last q skips the
// tile (its P^T would be 0: the same bits). Written: dk = dK * scale, dv;
// with DS also dS^T, the zeros of skipped tiles included, to the scratch
// `ds` at `f32_ds_index` (as float32, exactly what dK used).
template <int D, int RM, bool DS>
__device__ __forceinline__ void f32_dkdv_block(float* sm, const float* __restrict__ q,
                                               const float* __restrict__ k,
                                               const float* __restrict__ v,
                                               const float* __restrict__ dout,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ dvec,
                                               float* __restrict__ dk, float* __restrict__ dv,
                                               float* __restrict__ ds, int bh, int k0, int seq,
                                               float sm_scale) {
  using Tile = F32Bwd<D, RM>;
  constexpr int ROWS = Tile::ROWS, DP = Tile::DP, ST = Tile::ST, STAGE = Tile::KV_STAGE;
  float* Ks = sm;                  // [ROWS][DP]
  float* Vs = Ks + ROWS * DP;      // [ROWS][DP]
  float* ring = Vs + ROWS * DP;    // [ST] x (Q [F32_BK][DP], dO [F32_BK][DP], LSE, D)
  float* Xt = ring + ST * STAGE;   // [F32_BK][PP]: P^T, then dS^T
  const size_t off = (size_t)bh * seq * D;
  const float* qb = q + off;
  const float* dob = dout + off;
  const float* lb = lse + (size_t)bh * seq;
  const float* db = dvec + (size_t)bh * seq;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int r0 = 4 * RM * (ty >> 2) + (ty & 3);
  const int w0 = k0 + 4 * RM * (ty >> 2);  // the warp's first k row
  const int t0 = k0 / F32_BK, nt = (seq + F32_BK - 1) / F32_BK;

  auto issue = [&](int t) {
    float* st = ring + t % ST * STAGE;
    f32_rows_async<D, F32_BK>(st, qb, t * F32_BK, seq, tid);
    f32_rows_async<D, F32_BK>(st + F32_BK * DP, dob, t * F32_BK, seq, tid);
    if (tid < 2 * F32_BK) {
      const int gr = t * F32_BK + (tid & (F32_BK - 1));
      const bool in = gr < seq;
      cp_async4(st + 2 * F32_BK * DP + tid, (tid < F32_BK ? lb : db) + (in ? gr : 0), in);
    }
  };
  f32_rows_async<D, ROWS>(Ks, k + off, k0, seq, tid);
  f32_rows_async<D, ROWS>(Vs, v + off, k0, seq, tid);
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (t0 + s < nt) issue(t0 + s);
    cp_async_commit();
  }

  float adk[RM][D / 8], adv[RM][D / 8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) adk[i][c] = adv[i][c] = 0.f;

  for (int t = t0; t < nt; ++t) {
    cp_async_wait<ST - 2>();  // this thread's copies of tile t have landed
    __syncthreads();          // everyone's; and tile t - 1's stage and Xt are consumed
    if (t + ST - 1 < nt) issue(t + ST - 1);
    cp_async_commit();
    const int q0 = t * F32_BK;
    if (q0 + F32_BK - 1 < w0) {  // every q of the tile lies before the warp's k rows
      if constexpr (DS) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            f32_ds_put<RM>(ds, bh, seq, q0 + tx + 8 * j, k0 + r0 + 4 * i, 0.f);
      }
      continue;
    }
    const float* Qt = ring + t % ST * STAGE;
    const float* dOt = Qt + F32_BK * DP;
    const float* Lt = dOt + F32_BK * DP;
    const float* Dt = Lt + F32_BK;

    float s[RM][4], dp[RM][4];
    f32_dots<D, RM>(Ks, Qt, r0, tx, s);
    f32_dots<D, RM>(Vs, dOt, r0, tx, dp);
    const bool edge = q0 < k0 + ROWS || q0 + F32_BK > seq;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 8 * j, qi = q0 + c;
      const float lq = Lt[c], dr = Dt[c];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float p = expf(s[i][j] * sm_scale - lq);
        if (edge && (qi < k0 + r0 + 4 * i || qi >= seq)) p = 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dr);
        if constexpr (DS) f32_ds_put<RM>(ds, bh, seq, qi, k0 + r0 + 4 * i, dp[i][j]);
      }
    }
    f32_put<RM>(Xt, ty, tx, s);
    __syncwarp();
    f32_accumulate<D, RM>(Xt, dOt, ty, tx, adv);
    __syncwarp();  // the warp's P^T is read before its dS^T replaces it
    f32_put<RM>(Xt, ty, tx, dp);
    __syncwarp();
    f32_accumulate<D, RM>(Xt, Qt, ty, tx, adk);
  }
  cp_async_wait<0>();  // the trailing groups are empty; none is left in flight

  f32_store_rows<D, RM>(dk + off, adk, k0, r0, tx, seq, sm_scale);
  f32_store_rows<D, RM>(dv + off, adv, k0, r0, tx, seq, 1.f);
}

// dQ of the q tile [q0, q0 + ROWS) of head bh. Thread (ty, tx) owns q rows
// r0 + 4 i, key index tx + 8 j of each streamed tile and dQ's columns 32 c
// + 4 tx .. + 3. Q, dO and their LSE and D rows are loaded once; the K/V
// tiles up to the causal limit stream through the ring. Per k tile: S =
// Q.K^T and dP = dO.V^T, P = exp(S * scale - LSE) (0 above the diagonal
// and past seq), dS = P * (dP - D) to shared memory, dQ += dS.K (keys
// ascending); a warp whose rows all lie above the tile's keys skips it.
// Written: dq = dQ * scale.
template <int D, int RM>
__device__ __forceinline__ void f32_dq_block(float* sm, const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const float* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ dvec,
                                             float* __restrict__ dq, int bh, int q0, int seq,
                                             float sm_scale) {
  using Tile = F32Bwd<D, RM>;
  constexpr int ROWS = Tile::ROWS, DP = Tile::DP, ST = Tile::ST, STAGE = Tile::Q_STAGE;
  float* Qs = sm;                   // [ROWS][DP]
  float* dOs = Qs + ROWS * DP;      // [ROWS][DP]
  float* Ls = dOs + ROWS * DP;      // [ROWS]
  float* Ds = Ls + ROWS;            // [ROWS]
  float* ring = Ds + ROWS;          // [ST] x (K [F32_BK][DP], V [F32_BK][DP])
  float* Xt = ring + ST * STAGE;    // [F32_BK][PP]: dS
  const size_t off = (size_t)bh * seq * D;
  const float* kb = k + off;
  const float* vb = v + off;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int r0 = 4 * RM * (ty >> 2) + (ty & 3);
  const int w_end = q0 + 4 * RM * ((ty >> 2) + 1);  // past the warp's last row
  const int nt = (min(seq, q0 + ROWS) + F32_BK - 1) / F32_BK;  // key tiles to the causal limit

  f32_rows_async<D, ROWS>(Qs, q + off, q0, seq, tid);
  f32_rows_async<D, ROWS>(dOs, dout + off, q0, seq, tid);
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nt) {
      f32_rows_async<D, F32_BK>(ring + s * STAGE, kb, s * F32_BK, seq, tid);
      f32_rows_async<D, F32_BK>(ring + s * STAGE + F32_BK * DP, vb, s * F32_BK, seq, tid);
    }
    cp_async_commit();
  }
  if (tid < ROWS) {
    const bool in = q0 + tid < seq;
    Ls[tid] = in ? lse[(size_t)bh * seq + q0 + tid] : 0.f;
    Ds[tid] = in ? dvec[(size_t)bh * seq + q0 + tid] : 0.f;
  }

  float adq[RM][D / 8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) adq[i][c] = 0.f;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    const int tn = t + ST - 1;
    if (tn < nt) {
      f32_rows_async<D, F32_BK>(ring + tn % ST * STAGE, kb, tn * F32_BK, seq, tid);
      f32_rows_async<D, F32_BK>(ring + tn % ST * STAGE + F32_BK * DP, vb, tn * F32_BK, seq, tid);
    }
    cp_async_commit();
    const int k0 = t * F32_BK;
    if (k0 >= w_end) continue;  // every key of the tile lies past the warp's rows
    const float* Kt = ring + t % ST * STAGE;
    const float* Vt = Kt + F32_BK * DP;

    float s[RM][4], dp[RM][4];
    f32_dots<D, RM>(Qs, Kt, r0, tx, s);
    f32_dots<D, RM>(dOs, Vt, r0, tx, dp);
    const bool edge = k0 + F32_BK - 1 > q0 || k0 + F32_BK > seq;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + r0 + 4 * i;
      const float lq = Ls[r0 + 4 * i], dr = Ds[r0 + 4 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 8 * j;
        float p = expf(s[i][j] * sm_scale - lq);
        if (edge && (kj > qi || kj >= seq)) p = 0.f;
        s[i][j] = p * (dp[i][j] - dr);
      }
    }
    f32_put<RM>(Xt, ty, tx, s);
    __syncwarp();
    f32_accumulate<D, RM>(Xt, Kt, ty, tx, adq);
  }
  cp_async_wait<0>();

  f32_store_rows<D, RM>(dq + off, adq, q0, r0, tx, seq, sm_scale);
}

// dQ of the q tile [q0, q0 + ROWS) of head bh from the dS scratch (written
// by the dK/dV pass with DS): per key tile up to the causal limit, the K
// tile and the tile's dS block stream through a two-stage ring (the block
// copied as it stands into the [F32_BK][PP] layout), then dQ += dS.K (keys
// ascending); a warp whose rows all lie above the tile's keys skips it.
template <int D, int RM>
__device__ __forceinline__ void f32_dq_ds_block(float* sm, const float* __restrict__ k,
                                                const float* __restrict__ ds,
                                                float* __restrict__ dq, int bh, int q0, int seq,
                                                float sm_scale) {
  constexpr int ROWS = 16 * RM, DP = D + 4, PP = ROWS + 4, ST = 2;
  constexpr int STAGE = F32_BK * DP + F32_BK * PP;  // K, dS
  const size_t off = (size_t)bh * seq * D;
  const float* kb = k + off;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int r0 = 4 * RM * (ty >> 2) + (ty & 3);
  const int w_end = q0 + 4 * RM * ((ty >> 2) + 1);
  const int nt = (min(seq, q0 + ROWS) + F32_BK - 1) / F32_BK;
  const float* dsb = ds + f32_ds_index<RM>(bh, seq, q0, 0);  // the q tile's first block

  auto issue = [&](int t) {
    float* st = sm + t % ST * STAGE;
    f32_rows_async<D, F32_BK>(st, kb, t * F32_BK, seq, tid);
    constexpr int CH = ROWS / 4;  // 16-byte chunks of a dS row
#pragma unroll
    for (int n = 0; n < F32_BK * CH / F32_THREADS; ++n) {
      const int i = tid + n * F32_THREADS, r = i / CH, c = i % CH;
      cp_async16(st + F32_BK * DP + r * PP + 4 * c,
                 dsb + (size_t)t * F32_BK * ROWS + r * ROWS + 4 * c, true);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nt) issue(s);
    cp_async_commit();
  }
  float adq[RM][D / 8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) adq[i][c] = 0.f;
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (t + ST - 1 < nt) issue(t + ST - 1);
    cp_async_commit();
    if (t * F32_BK >= w_end) continue;
    const float* Kt = sm + t % ST * STAGE;
    f32_accumulate<D, RM>(Kt + F32_BK * DP, Kt, ty, tx, adq);
  }
  cp_async_wait<0>();
  f32_store_rows<D, RM>(dq + off, adq, q0, r0, tx, seq, sm_scale);
}

// Blocks (bh, y): the k tile y, so the longest walk over the q tiles comes
// first; dK and dV, and dS to the scratch for `flash_bwd_f32_dq_ds`.
template <int D, int RM>
__global__ void __launch_bounds__(F32_THREADS, (F32Bwd<D, RM>::BLOCKS))
flash_bwd_f32_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dvec,
                   float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ ds,
                   int seq, float sm_scale) {
  extern __shared__ float4 smem4[];
  f32_dkdv_block<D, RM, true>(reinterpret_cast<float*>(smem4), q, k, v, dout, lse, dvec, dk,
                              dv, ds, blockIdx.x, blockIdx.y * F32Bwd<D, RM>::ROWS, seq,
                              sm_scale);
}

// Blocks (bh, y): the q tile gridDim.y - 1 - y, the longest walk first; dQ
// from the dS scratch, one product. Three blocks an SM at D = 64 (39 KB).
template <int D, int RM>
__global__ void __launch_bounds__(F32_THREADS, 3)
flash_bwd_f32_dq_ds(const float* __restrict__ k, const float* __restrict__ ds,
                    float* __restrict__ dq, int seq, float sm_scale) {
  extern __shared__ float4 smem4[];
  f32_dq_ds_block<D, RM>(reinterpret_cast<float*>(smem4), k, ds, dq, blockIdx.x,
                         (gridDim.y - 1 - blockIdx.y) * F32Bwd<D, RM>::ROWS, seq, sm_scale);
}

// Blocks (bh, y): dK and dV of tile y, then dQ of tile y. The dK/dV walk of
// tile j covers the q tiles from j * ROWS to seq and the dQ walk the k tiles
// up to (j + 1) * ROWS, so every block walks about seq / F32_BK + ROWS /
// F32_BK tiles, and a call whose blocks fit in one wave is balanced; y = 0,
// whose walk has the most dK/dV tiles (four products against three), comes
// first.
template <int D, int RM>
__global__ void __launch_bounds__(F32_THREADS, (F32Bwd<D, RM>::BLOCKS))
flash_bwd_f32_pair(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dvec,
                   float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                   int seq, float sm_scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int r = blockIdx.y * F32Bwd<D, RM>::ROWS;
  f32_dkdv_block<D, RM, false>(sm, q, k, v, dout, lse, dvec, dk, dv, nullptr, blockIdx.x, r,
                               seq, sm_scale);
  __syncthreads();  // the dK/dV pass's shared memory is consumed
  f32_dq_block<D, RM>(sm, q, k, v, dout, lse, dvec, dq, blockIdx.x, r, seq, sm_scale);
}

// ---------------------------------------------------------------------------
// Forward and backward, bf16 operands at head_dim 64 and 128: TMA-fed wgmma
// kernels
// ---------------------------------------------------------------------------

#define W_ROWS 64      // rows of a consumer warpgroup's tile and of a streamed tile
#define W_TILE 128     // rows of a block's own tile: two consumer warpgroups
#define W_STAGES 4     // the ring of streamed tiles
#define W_THREADS 288  // two consumer warpgroups + one producer warp

typedef __nv_bfloat16 bf16;

// The shared-memory layout of the wgmma kernels at head_dim D. A 64-row
// bf16 tile is D / 64 TMA boxes of 64 rows x 64 columns, one 128-byte
// swizzle row each (box h holds the columns 64 h .. 64 h + 63), so every
// wgmma descriptor addresses one box: a k16 slice of the head_dim lies in
// box kk / 4, and an MN-major operand N = 128 wide is two products of 64.
// D = 64: 99 KB, two blocks an SM. D = 128: 195 KB, one (the ring still
// holds a whole 256-key JAX k-block, so the forward's row maxima are taken
// from shared memory, not by walking the k-block twice from device memory).
template <int D>
struct Wg {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static constexpr int HALVES = D / 64;
  static constexpr int TILE = HALVES * SW128_BOX;  // one 64-row tile: 8 or 16 KB
  static constexpr int OWN = 4 * TILE;             // the block's own two 128-row tiles
  static constexpr int STAGE = 2 * TILE;           // a stage: two 64-row tiles
  // the row vectors (lse and D): 2 x 64 floats per stage for dK/dV, 2 x 128
  // once for dQ
  static constexpr int VEC = W_STAGES * 2 * W_ROWS * 4;
  // dynamic shared memory: 1024 bytes of alignment, the own tiles, the ring,
  // the vectors, a full and an empty mbarrier per stage and one for the own
  // tiles
  static constexpr int SMEM = 1024 + OWN + W_STAGES * STAGE + VEC + (2 * W_STAGES + 1) * 8;
  // keys of a dK/dV block. At D = 128 a consumer thread would hold 64
  // accumulators of dK and 64 of dV for its warpgroup's 64 keys, over the
  // 168 registers ptxas gives 288 threads; there both warpgroups take the
  // block's 64 keys and each accumulates half of the columns.
  static constexpr int KEYS = D == 64 ? 128 : 64;
  // blocks an SM: shared memory and registers
  static constexpr int BLOCKS = D == 64 ? 2 : 1;
  static_assert(VEC >= 2 * W_TILE * 4, "dQ's vectors fit");
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// x, y rounded to bf16 (to nearest) as one register of the wgmma register
// form's A operand, x in the low half.
__device__ __forceinline__ uint32_t bf16x2(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared-memory addresses of a block of any of the three kernels, its
// barriers initialised (called by all threads).
struct WgSmem {
  uint32_t own;    // the own tiles: Q (forward), K, V (dK/dV; 1 each at D = 128) or Q, dO (dQ)
  uint32_t ring;   // W_STAGES stages of two 64-row tiles
  uint32_t vec_s;  // the row vectors
  const float* vec;
  uint32_t full, empty, own_bar;
};

template <int D>
__device__ __forceinline__ WgSmem wg_smem() {
  extern __shared__ uint8_t wg_raw[];
  const uint32_t raw = smem_u32(wg_raw);
  WgSmem m;
  m.own = (raw + 1023) & ~1023u;
  m.ring = m.own + Wg<D>::OWN;
  m.vec_s = m.ring + W_STAGES * Wg<D>::STAGE;
  m.vec = reinterpret_cast<const float*>(wg_raw + (m.vec_s - raw));
  m.full = m.vec_s + Wg<D>::VEC;
  m.empty = m.full + 8 * W_STAGES;
  m.own_bar = m.empty + 8 * W_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(m.full + 8 * s, 1);
      mbar_init(m.empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(m.own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return m;
}

// The 64-row tile of head bh from row `row` into shared memory at dst, box
// by box, completing on `bar`.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int row, int bh,
                                          uint32_t bar) {
#pragma unroll
  for (int h = 0; h < Wg<D>::HALVES; ++h)
    tma_load3(dst + h * SW128_BOX, map, 64 * h, row, bh, bar);
}

// Issues S = A . B^T of one warpgroup, 64 x 64, both operands K-major
// 64-row tiles over head_dim, the k16 slice kk in box kk / 4 (the first
// slice overwrites S).
template <int D>
__device__ __forceinline__ void issue_scores(float* sa, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t box = (kk / 4) * SW128_BOX;
    wgmma<64, false>(sa, sdesc<false>(a + box, kk % 4), sdesc<false>(b + box, kk % 4), kk);
  }
}

// S = A . B^T (the forward), waited for.
template <int D>
__device__ __forceinline__ void scores(float* sa, uint32_t a, uint32_t b) {
  wgmma_fence();
  issue_scores<D>(sa, a, b);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc<32>(sa);
}

// S = A . B^T and dP = A2 . B2^T (the backward), waited for.
template <int D>
__device__ __forceinline__ void scores(float* sa, float* pa, uint32_t a, uint32_t b, uint32_t a2,
                                       uint32_t b2) {
  wgmma_fence();
  issue_scores<D>(sa, a, b);
  issue_scores<D>(pa, a2, b2);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc<32>(sa);
  fence_acc<32>(pa);
}

// d (64 x N) += A . B: A (64 x 64) the bf16 pairs `a` in registers, B a
// 64-row tile whose rows are the reduction index (MN-major), N columns of
// it, one product of 64 columns per box. Issued, not waited for.
template <int N>
__device__ __forceinline__ void rs_accumulate(float* d, const uint32_t* a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < W_ROWS / 16; ++kk)
#pragma unroll
    for (int h = 0; h < N / 64; ++h)
      wgmma_rs64<true>(d + 32 * h, a + 4 * kk, sdesc<true>(b + h * SW128_BOX, kk));
}

// In the three kernels accumulator e of consumer thread t of a warpgroup is
// row 16 (t/32) + (t%32)/4 + 8 ((e>>1)&1) and column 8 (e>>2) + 2 (t%4) +
// (e&1) of its 64-row tile (of S, 64 or 32 wide, or of an output, D wide:
// the product of box h writes accumulators 32 h ..): the four threads of a
// quad (t/4) hold the columns each of two rows. P and dS are computed as
// the JAX kernels do, each operation rounded on its own (no FMA
// contraction), with expf: in the forward exp(S*scale - m) at the running
// max m, in the backward exp(S*scale - lse) and dS = P*(dP - D) from the
// float32 P.

// S*scale of the consumer thread's accumulators of tile k0 (sa, in place),
// -1e30 above the diagonal, and with MAX the running maxima of its two rows
// (mx, over the quad). Keys past seq lie above every written row's diagonal.
template <bool MAX>
__device__ __forceinline__ void fwd_mask(float* sa, float mx[2], int k0, int qw, int qrow, int c,
                                         float sm_scale) {
  const bool diag = k0 + W_ROWS - 1 > qw;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int h = (e >> 1) & 1, q = qrow + 8 * h, k = k0 + 8 * (e >> 2) + 2 * c + (e & 1);
    float x = __fmul_rn(sa[e], sm_scale);
    if (diag && k > q) x = NEG_INF;
    sa[e] = x;
    if (MAX) mx[h] = fmaxf(mx[h], x);
  }
  if (!MAX) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
}

// One tile's P = exp(S*scale - m) at the k-block's running max m, the
// float32 P into the thread's shares of the row sums, then O += bf16(P).V
// (V the tile at vs, read MN-major), waited for.
template <int D>
__device__ __forceinline__ void fwd_pv(float* oa, const float* sa, const float mr[2], float lr[2],
                                       uint32_t vs) {
  uint32_t pf[16];
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h;
      const float p[2] = {expf(__fsub_rn(sa[e], mr[h])), expf(__fsub_rn(sa[e + 1], mr[h]))};
      rs[h] = __fadd_rn(__fadd_rn(rs[h], p[0]), p[1]);  // the row sum takes the float32 P
      pf[2 * j + h] = bf16x2(p[0], p[1]);               // P.V takes P in bf16
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) lr[h] = __fadd_rn(lr[h], rs[h]);
  fence_acc<D / 2>(oa);
  wgmma_fence();
  rs_accumulate<D>(oa, pf, vs);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc<D / 2>(oa);
  fence_frag<16>(pf);
}

// o (and lse, when given) of the queries [q0, q0 + 128) of head bh:
// warpgroup w owns queries q0 + 64 w .. + 63 and walks the 64-row k tiles
// from 0 to its causal limit in k-blocks of nb tiles (the JAX kernel's
// block_k / 64; nb <= W_STAGES, so a whole k-block stays in the ring). Per
// k-block: first S = Q.K^T of each of its tiles by wgmma, for the block's
// row maxima m (S*scale, masked to -1e30 above the diagonal); then
// corr = exp(m_old - m), O and l scaled by corr once; then per tile
// P = exp(S*scale - m), l += the float32 P, O += bf16(P).V. The block's
// last tile's S stays in registers from the first walk and goes first; the
// others are taken again. So with nb = 1 nothing is taken twice. Rows past
// seq compute on zero-filled Q and are not written; keys past seq lie
// above every written row's diagonal.
template <int D>
__device__ __forceinline__ void fwd_block(const CUtensorMap* mq, const CUtensorMap* mk,
                                          const CUtensorMap* mv, bf16* __restrict__ o,
                                          float* __restrict__ lse, int bh, int q0, int seq,
                                          int nb, float sm_scale) {
  using L = Wg<D>;
  const WgSmem m = wg_smem<D>();
  const int n = (min(seq, q0 + W_TILE) + W_ROWS - 1) / W_ROWS;  // k tiles to the causal limit
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 2) {  // producer: one thread keeps the ring full
    if (t == 0) {
      mbar_expect_tx(m.own_bar, 2 * L::TILE);
      for (int b = 0; b < 2; ++b) load_tile<D>(m.own + b * L::TILE, mq, q0 + b * W_ROWS, bh, m.own_bar);
      for (int i = 0; i < n; ++i) {
        const int s = i % W_STAGES;
        if (i >= W_STAGES) mbar_wait(m.empty + 8 * s, (i / W_STAGES - 1) & 1);
        const uint32_t st = m.ring + s * L::STAGE, full = m.full + 8 * s;
        mbar_expect_tx(full, L::STAGE);
        load_tile<D>(st, mk, i * W_ROWS, bh, full);
        load_tile<D>(st + L::TILE, mv, i * W_ROWS, bh, full);
      }
    }
    return;
  }

  const int qw = q0 + W_ROWS * wg, warp = t / 32, lane = t % 32, c = lane % 4;
  const int qrow = qw + 16 * warp + lane / 4;  // the thread's queries qrow, qrow + 8
  const uint32_t qa = m.own + wg * L::TILE;
  const int active = qw / W_ROWS + 1;  // tiles with a key at or below one of the rows
  float oa[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) oa[e] = 0.f;
  // per row h: the running max, and the thread's share of the row sum
  float mr[2] = {NEG_INF, NEG_INF}, lr[2] = {0.f, 0.f};
  mbar_wait(m.own_bar, 0);
  for (int b0 = 0; b0 < n; b0 += nb) {
    const int b1 = min(n, b0 + nb), a1 = min(b1, active);
    float sa[32];
    if (b0 < a1) {
      float mx[2] = {mr[0], mr[1]};
      for (int i = b0; i < a1; ++i) {  // the k-block's row maxima
        const int s = i % W_STAGES;
        mbar_wait(m.full + 8 * s, (i / W_STAGES) & 1);
        scores<D>(sa, qa, m.ring + s * L::STAGE);
        fwd_mask<true>(sa, mx, i * W_ROWS, qw, qrow, c, sm_scale);
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        corr[h] = expf(__fsub_rn(mr[h], mx[h]));
        mr[h] = mx[h];
      }
      fence_acc<D / 2>(oa);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) oa[e] = __fmul_rn(oa[e], corr[(e >> 1) & 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) lr[h] = __fmul_rn(lr[h], corr[h]);
      {  // the last tile first: its S is in sa
        const int s = (a1 - 1) % W_STAGES;
        fwd_pv<D>(oa, sa, mr, lr, m.ring + s * L::STAGE + L::TILE);
        if (lane == 0) mbar_arrive(m.empty + 8 * s);
      }
      for (int i = b0; i < a1 - 1; ++i) {
        const int s = i % W_STAGES;
        const uint32_t ks = m.ring + s * L::STAGE;
        scores<D>(sa, qa, ks);
        fwd_mask<false>(sa, nullptr, i * W_ROWS, qw, qrow, c, sm_scale);
        fwd_pv<D>(oa, sa, mr, lr, ks + L::TILE);
        if (lane == 0) mbar_arrive(m.empty + 8 * s);
      }
    }
    for (int i = max(b0, a1); i < b1; ++i) {  // tiles wholly above the diagonal
      const int s = i % W_STAGES;
      mbar_wait(m.full + 8 * s, (i / W_STAGES) & 1);
      if (lane == 0) mbar_arrive(m.empty + 8 * s);
    }
  }

  const size_t off = (size_t)bh * seq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = lr[h];  // the quad's four shares, added in a fixed order
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 1));
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 2));
    const float den = fmaxf(l, 1e-30f);
    const int q = qrow + 8 * h;
    if (q < seq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int e = 4 * j + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(o + (off + q) * D + 8 * j + 2 * c) =
            __floats2bfloat162_rn(oa[e] / den, oa[e + 1] / den);
      }
      if (lse != nullptr && c == 0) lse[off + q] = __fadd_rn(mr[h], logf(den));
    }
  }
}

// dK and dV of the keys [k0, k0 + Wg<D>::KEYS) of head bh. The block walks
// the 64-row q tiles from q0 = k0 to the end and per tile computes S^T =
// K.Q^T and dP^T = V.dO^T, then P^T = exp(S^T*scale - lse) and dS^T =
// P^T*(dP^T - D) in registers, then dV += bf16(P^T).dO and dK +=
// bf16(dS^T).Q. At head_dim 64 warpgroup w owns the keys k0 + 64 w .. + 63
// and all 64 columns of their dK and dV; at 128 (KEYS = 64) both
// warpgroups take the block's 64 keys, each computes the whole S^T and
// dP^T, and warpgroup w owns the columns 64 w .. + 63 of dK and dV.
template <int D>
__device__ __forceinline__ void dkdv_block(const CUtensorMap* mq, const CUtensorMap* mk,
                                           const CUtensorMap* mv, const CUtensorMap* mdo,
                                           const float* __restrict__ lse_p,
                                           const float* __restrict__ d_p, bf16* __restrict__ dk,
                                           bf16* __restrict__ dv, int bh, int k0, int seq,
                                           int t_pad, float sm_scale) {
  using L = Wg<D>;
  constexpr int OWN_TILES = L::KEYS / W_ROWS;  // own K (and V) tiles: 2, or 1 at D = 128
  const WgSmem m = wg_smem<D>();
  const int n = (seq - k0 + W_ROWS - 1) / W_ROWS;  // q tiles from the causal start
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 2) {  // producer: one thread keeps the ring full
    if (t == 0) {
      mbar_expect_tx(m.own_bar, 2 * OWN_TILES * L::TILE);
      for (int b = 0; b < OWN_TILES; ++b) {
        load_tile<D>(m.own + b * L::TILE, mk, k0 + b * W_ROWS, bh, m.own_bar);
        load_tile<D>(m.own + (OWN_TILES + b) * L::TILE, mv, k0 + b * W_ROWS, bh, m.own_bar);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % W_STAGES, q0 = k0 + i * W_ROWS;
        if (i >= W_STAGES) mbar_wait(m.empty + 8 * s, (i / W_STAGES - 1) & 1);
        const uint32_t st = m.ring + s * L::STAGE, full = m.full + 8 * s;
        const size_t row = (size_t)bh * t_pad + q0;
        mbar_expect_tx(full, L::STAGE + 2 * W_ROWS * 4);
        load_tile<D>(st, mq, q0, bh, full);
        load_tile<D>(st + L::TILE, mdo, q0, bh, full);
        bulk_load(m.vec_s + s * 2 * W_ROWS * 4, lse_p + row, W_ROWS * 4, full);
        bulk_load(m.vec_s + (s * 2 + 1) * W_ROWS * 4, d_p + row, W_ROWS * 4, full);
      }
    }
    return;
  }

  // the warpgroup's keys, own K and V tiles, and the box (64 columns) of
  // dK and dV it accumulates
  const int kt = OWN_TILES == 2 ? wg : 0, box = OWN_TILES == 2 ? 0 : wg;
  const int kw = k0 + W_ROWS * kt, warp = t / 32, lane = t % 32, c = lane % 4;
  const int krow = kw + 16 * warp + lane / 4;  // the thread's keys: krow, krow + 8
  const uint32_t ka = m.own + kt * L::TILE, va = m.own + (OWN_TILES + kt) * L::TILE;
  float dka[32], dva[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dka[e] = dva[e] = 0.f;
  mbar_wait(m.own_bar, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % W_STAGES, q0 = k0 + i * W_ROWS;
    mbar_wait(m.full + 8 * s, (i / W_STAGES) & 1);
    if (q0 + W_ROWS > kw) {  // not every (k, q) of the tile has k > q
      const uint32_t qs = m.ring + s * L::STAGE, dos = qs + L::TILE;
      const float* lse_s = m.vec + s * 2 * W_ROWS;
      const float* d_s = lse_s + W_ROWS;
      float sa[32], pa[32];
      scores<D>(sa, pa, ka, qs, va, dos);
      const bool masked = kw + W_ROWS - 1 > q0 || q0 + W_ROWS > seq;
      uint32_t pf[16], sf[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * c;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(d_s + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h, k = krow + 8 * h, q = q0 + col;
          float p0 = expf(__fsub_rn(__fmul_rn(sa[e], sm_scale), l2.x));
          float p1 = expf(__fsub_rn(__fmul_rn(sa[e + 1], sm_scale), l2.y));
          if (masked) {
            if (k > q || q >= seq) p0 = 0.f;
            if (k > q + 1 || q + 1 >= seq) p1 = 0.f;
          }
          pf[2 * j + h] = bf16x2(p0, p1);
          sf[2 * j + h] = bf16x2(p0 * (pa[e] - d2.x), p1 * (pa[e + 1] - d2.y));
        }
      }
      fence_acc<32>(dva);
      fence_acc<32>(dka);
      wgmma_fence();
      rs_accumulate<64>(dva, pf, dos + box * SW128_BOX);
      rs_accumulate<64>(dka, sf, qs + box * SW128_BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<32>(dva);
      fence_acc<32>(dka);
      fence_frag<16>(pf);
      fence_frag<16>(sf);
    }
    if (lane == 0) mbar_arrive(m.empty + 8 * s);
  }

  const size_t off = (size_t)bh * seq * D + 64 * box;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h, k = krow + 8 * h;
      if (k < seq) {
        const size_t o = off + (size_t)k * D + 8 * j + 2 * c;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) =
            __floats2bfloat162_rn(dka[e] * sm_scale, dka[e + 1] * sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) = __floats2bfloat162_rn(dva[e], dva[e + 1]);
      }
    }
}

// dQ of the queries [q0, q0 + 128) of head bh: warpgroup w owns queries
// q0 + 64 w .. + 63, walks the 64-row k tiles from 0 to the causal limit,
// and per tile computes S = Q.K^T and dP = dO.V^T, then P and dS in
// registers, then dQ += bf16(dS).K.
template <int D>
__device__ __forceinline__ void dq_block(const CUtensorMap* mq, const CUtensorMap* mk,
                                         const CUtensorMap* mv, const CUtensorMap* mdo,
                                         const float* __restrict__ lse_p,
                                         const float* __restrict__ d_p, bf16* __restrict__ dq,
                                         int bh, int q0, int seq, int t_pad, float sm_scale) {
  using L = Wg<D>;
  const WgSmem m = wg_smem<D>();
  const int n = (min(seq, q0 + W_TILE) + W_ROWS - 1) / W_ROWS;  // k tiles to the causal limit
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 2) {
    if (t == 0) {
      const size_t row = (size_t)bh * t_pad + q0;
      mbar_expect_tx(m.own_bar, L::OWN + 2 * W_TILE * 4);
      for (int b = 0; b < 2; ++b) {
        load_tile<D>(m.own + b * L::TILE, mq, q0 + b * W_ROWS, bh, m.own_bar);
        load_tile<D>(m.own + (2 + b) * L::TILE, mdo, q0 + b * W_ROWS, bh, m.own_bar);
      }
      bulk_load(m.vec_s, lse_p + row, W_TILE * 4, m.own_bar);
      bulk_load(m.vec_s + W_TILE * 4, d_p + row, W_TILE * 4, m.own_bar);
      for (int i = 0; i < n; ++i) {
        const int s = i % W_STAGES;
        if (i >= W_STAGES) mbar_wait(m.empty + 8 * s, (i / W_STAGES - 1) & 1);
        const uint32_t st = m.ring + s * L::STAGE, full = m.full + 8 * s;
        mbar_expect_tx(full, L::STAGE);
        load_tile<D>(st, mk, i * W_ROWS, bh, full);
        load_tile<D>(st + L::TILE, mv, i * W_ROWS, bh, full);
      }
    }
    return;
  }

  const int qw = q0 + W_ROWS * wg, warp = t / 32, lane = t % 32, c = lane % 4;
  const int r = W_ROWS * wg + 16 * warp + lane / 4;  // the thread's rows r, r + 8 of the tile
  const uint32_t qa = m.own + wg * L::TILE, doa = m.own + (2 + wg) * L::TILE;
  float dqa[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dqa[e] = 0.f;
  mbar_wait(m.own_bar, 0);
  const float lr[2] = {m.vec[r], m.vec[r + 8]};
  const float dr[2] = {m.vec[W_TILE + r], m.vec[W_TILE + r + 8]};
  for (int i = 0; i < n; ++i) {
    const int s = i % W_STAGES, k0 = i * W_ROWS;
    mbar_wait(m.full + 8 * s, (i / W_STAGES) & 1);
    if (k0 < qw + W_ROWS) {  // not every (q, k) of the tile has k > q
      const uint32_t ks = m.ring + s * L::STAGE, vs = ks + L::TILE;
      float sa[32], pa[32];
      scores<D>(sa, pa, qa, ks, doa, vs);
      const bool masked = k0 + W_ROWS - 1 > qw || qw + W_ROWS > seq;
      uint32_t sf[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h, q = q0 + r + 8 * h, k = k0 + 8 * j + 2 * c;
          float p0 = expf(__fsub_rn(__fmul_rn(sa[e], sm_scale), lr[h]));
          float p1 = expf(__fsub_rn(__fmul_rn(sa[e + 1], sm_scale), lr[h]));
          if (masked) {
            if (k > q || q >= seq) p0 = 0.f;
            if (k + 1 > q || q >= seq) p1 = 0.f;
          }
          sf[2 * j + h] = bf16x2(p0 * (pa[e] - dr[h]), p1 * (pa[e + 1] - dr[h]));
        }
      fence_acc<D / 2>(dqa);
      wgmma_fence();
      rs_accumulate<D>(dqa, sf, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<D / 2>(dqa);
      fence_frag<16>(sf);
    }
    if (lane == 0) mbar_arrive(m.empty + 8 * s);
  }

  const size_t off = (size_t)bh * seq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h, q = q0 + r + 8 * h;
      if (q < seq)
        *reinterpret_cast<__nv_bfloat162*>(dq + off + (size_t)q * D + 8 * j + 2 * c) =
            __floats2bfloat162_rn(dqa[e] * sm_scale, dqa[e + 1] * sm_scale);
    }
}

// Blocks (bh, y): the q tile gridDim.y - 1 - y, so the last q tile, whose
// walk over the k tiles is longest, comes first. D = 64: two blocks per SM
// (99 KB of shared memory each, at most 112 registers a thread); D = 128:
// one (195 KB). LSE: write the log-sum-exp rows (#5) or not (#2).
template <int D, bool LSE>
__global__ void __launch_bounds__(W_THREADS, Wg<D>::BLOCKS)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                float* __restrict__ lse, int seq, int nb, float sm_scale) {
  fwd_block<D>(&mq, &mk, &mv, o, LSE ? lse : nullptr, blockIdx.x,
               (gridDim.y - 1 - blockIdx.y) * W_TILE, seq, nb, sm_scale);
}

// Blocks (bh, y): the keys from y * Wg<D>::KEYS, so the block whose walk
// over the q tiles is longest comes first.
template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                     const float* __restrict__ lse_p, const float* __restrict__ d_p,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int t_pad,
                     float sm_scale) {
  dkdv_block<D>(&mq, &mk, &mv, &mdo, lse_p, d_p, dk, dv, blockIdx.x, blockIdx.y * Wg<D>::KEYS,
                seq, t_pad, sm_scale);
}

// Blocks (bh, y): the q tile gridDim.y - 1 - y, so the last q tile, whose
// walk over the k tiles is longest, comes first.
template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                   const float* __restrict__ lse_p, const float* __restrict__ d_p,
                   bf16* __restrict__ dq, int seq, int t_pad, float sm_scale) {
  const int y = gridDim.y - 1 - blockIdx.y;
  dq_block<D>(&mq, &mk, &mv, &mdo, lse_p, d_p, dq, blockIdx.x, y * W_TILE, seq, t_pad, sm_scale);
}

// The row vectors of the wgmma kernels, each head's rows padded to t_pad
// with zeros: lse_p[bh][t] = lse and d_p[bh][t] = D = rowsum(dO * O) in
// float32. Eight threads a row, 16 bytes of O and of dO each per 64
// columns.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ lse_p, float* __restrict__ d_p,
               int seq, int t_pad) {
  const int id = blockIdx.x * 256 + threadIdx.x, row = id / 8, part = id % 8;
  const int bh = row / t_pad, tt = row % t_pad;  // rows = BH * t_pad, a multiple of 32
  float s = 0.f;
  if (tt < seq) {
#pragma unroll
    for (int u = 0; u < D / 64; ++u) {
      const size_t at = ((size_t)bh * seq + tt) * D + 64 * u + part * 8;
      const uint4 a = *reinterpret_cast<const uint4*>(o + at);
      const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(b2[i]);
        s += y.x * x.x;
        s += y.y * x.y;
      }
    }
  }
  for (int w = 4; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (part == 0) {
    lse_p[row] = tt < seq ? lse[(size_t)bh * seq + tt] : 0.f;
    d_p[row] = s;
  }
}

// ---------------------------------------------------------------------------
// Host entry points (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------

template <typename K>
static cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// k-blocks of block_k keys as 64-key tiles: 1, 2 or 4 (the wgmma forward's
// ring holds a whole k-block), 0 for any other block_k.
static int tiles_per_block(int block_k) {
  return (block_k == 64 || block_k == 128 || block_k == 256) ? block_k / W_ROWS : 0;
}

template <int D, int RM>
static int f32_launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                      int seq, float sm_scale, cudaStream_t stream) {
  using Tile = F32Tile<D, RM>;
  static const cudaError_t e_lse = set_smem(flash_fwd_f32<D, RM, true>, Tile::SMEM);
  static const cudaError_t e_o = set_smem(flash_fwd_f32<D, RM, false>, Tile::SMEM);
  if (e_lse != cudaSuccess) return (int)e_lse;
  if (e_o != cudaSuccess) return (int)e_o;
  const dim3 grid(BH, (seq + Tile::ROWS - 1) / Tile::ROWS);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  if (lse != nullptr)
    flash_fwd_f32<D, RM, true><<<grid, F32_THREADS, Tile::SMEM, stream>>>(
        qf, kf, vf, static_cast<float*>(o), lse, seq, sm_scale);
  else
    flash_fwd_f32<D, RM, false><<<grid, F32_THREADS, Tile::SMEM, stream>>>(
        qf, kf, vf, static_cast<float*>(o), nullptr, seq, sm_scale);
  return (int)cudaGetLastError();
}

// #2 and #5 with float32 operands: o and, when lse is not null, lse (BH *
// seq) float32 from q, k, v (BH, seq, D) float32, each 16-byte aligned, in
// q tiles of block_q rows (ops/attention.py::flash_fwd_plan): 64 or 32 at
// head_dim 64, 64 at 128; any other value is refused. One launch.
extern "C" int flash_forward_f32(const void* q, const void* k, const void* v, void* o,
                                 float* lse, int BH, int seq, int D, int block_q,
                                 float sm_scale, cudaStream_t stream) {
  if (seq < 1 || BH < 1) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, (const void*)o})
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorInvalidValue;
  if (D == 64 && block_q == 64)
    return f32_launch<64, 4>(q, k, v, o, lse, BH, seq, sm_scale, stream);
  if (D == 64 && block_q == 32)
    return f32_launch<64, 2>(q, k, v, o, lse, BH, seq, sm_scale, stream);
  if (D == 128 && block_q == 64)
    return f32_launch<128, 4>(q, k, v, o, lse, BH, seq, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

template <int D>
static int fwd_wgmma_launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                            void* o, float* lse, int BH, int seq, int nb, float sm_scale,
                            cudaStream_t stream) {
  static const cudaError_t e_lse = set_smem(flash_fwd_wgmma<D, true>, Wg<D>::SMEM);
  static const cudaError_t e_o = set_smem(flash_fwd_wgmma<D, false>, Wg<D>::SMEM);
  if (e_lse != cudaSuccess) return (int)e_lse;
  if (e_o != cudaSuccess) return (int)e_o;
  const dim3 grid(BH, (seq + W_TILE - 1) / W_TILE);
  if (lse != nullptr)
    flash_fwd_wgmma<D, true><<<grid, W_THREADS, Wg<D>::SMEM, stream>>>(
        mq, mk, mv, static_cast<bf16*>(o), lse, seq, nb, sm_scale);
  else
    flash_fwd_wgmma<D, false><<<grid, W_THREADS, Wg<D>::SMEM, stream>>>(
        mq, mk, mv, static_cast<bf16*>(o), nullptr, seq, nb, sm_scale);
  return (int)cudaGetLastError();
}

// #2 and #5 with bf16 operands at head_dim D (64 or 128): o (BH, seq, D)
// bf16 and, when lse is not null, lse (BH * seq) float32 from q, k, v (BH,
// seq, D) bf16, each 16-byte aligned, P rounded at the running max of
// k-blocks of block_k keys. One call: the three tensor maps, then one
// launch.
extern "C" int flash_forward_wgmma(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int BH, int seq, int D, int block_k,
                                   float sm_scale, cudaStream_t stream) {
  const int nb = tiles_per_block(block_k);
  if (seq < 1 || nb == 0 || nb > W_STAGES || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, (const void*)o})
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int rc = bf16_map3(&mq, q, D, seq, BH, W_ROWS);
  if (!rc) rc = bf16_map3(&mk, k, D, seq, BH, W_ROWS);
  if (!rc) rc = bf16_map3(&mv, v, D, seq, BH, W_ROWS);
  if (rc) return rc;
  if (D == 64) return fwd_wgmma_launch<64>(mq, mk, mv, o, lse, BH, seq, nb, sm_scale, stream);
  return fwd_wgmma_launch<128>(mq, mk, mv, o, lse, BH, seq, nb, sm_scale, stream);
}

// The float32 backward's orders (`mode` of flash_bwd_f32)
#define F32_BWD_PAIRED 0  // one launch, each block dK/dV of tile j, then its dQ
#define F32_BWD_DS 1      // the dK/dV pass writes dS; the dQ pass is dS.K: five products

template <int D, int RM>
static int bwd_f32_launch(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* dvec, float* ds, void* dq,
                          void* dk, void* dv, int BH, int seq, int mode, float sm_scale,
                          cudaStream_t stream) {
  using Tile = F32Bwd<D, RM>;
  constexpr size_t SMEM_DS = sizeof(float) * 2 * F32_BK * (Tile::DP + Tile::PP);
  static const cudaError_t e_kv = set_smem(flash_bwd_f32_dkdv<D, RM>, Tile::SMEM);
  static const cudaError_t e_q = set_smem(flash_bwd_f32_dq_ds<D, RM>, SMEM_DS);
  static const cudaError_t e_pair = set_smem(flash_bwd_f32_pair<D, RM>, Tile::SMEM);
  for (cudaError_t e : {e_kv, e_q, e_pair})
    if (e != cudaSuccess) return (int)e;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  const int rows = BH * seq;
  flash_bwd_rowdot<float, D><<<(rows + 7) / 8, 256, 0, stream>>>(static_cast<const float*>(o),
                                                                 dof, dvec, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (seq + Tile::ROWS - 1) / Tile::ROWS);
  if (mode == F32_BWD_PAIRED) {
    flash_bwd_f32_pair<D, RM><<<grid, F32_THREADS, Tile::SMEM, stream>>>(
        qf, kf, vf, dof, lse, dvec, dqf, dkf, dvf, seq, sm_scale);
    return (int)cudaGetLastError();
  }
  flash_bwd_f32_dkdv<D, RM><<<grid, F32_THREADS, Tile::SMEM, stream>>>(
      qf, kf, vf, dof, lse, dvec, dkf, dvf, ds, seq, sm_scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_f32_dq_ds<D, RM><<<grid, F32_THREADS, SMEM_DS, stream>>>(kf, ds, dqf, seq, sm_scale);
  return (int)cudaGetLastError();
}

// #6 with float32 operands: dq, dk, dv from q, k, v, o, dout (BH, seq, D)
// float32, each 16-byte aligned, and lse (BH * seq) float32; dvec is (BH *
// seq) float32 scratch for D = rowsum(dO * O), ds (mode F32_BWD_DS only,
// else unused) float32 scratch of BH * ceil(seq / block) * block *
// ceil(seq / 32) * 32 floats, 16-byte aligned. Own tiles of block rows
// (ops/attention.py::flash_bwd_plan): 64 or 32 at head_dim 64, 32 at 128;
// any other value, or another mode, is refused. The row dots, then one
// launch (F32_BWD_PAIRED) or two (F32_BWD_DS).
extern "C" int flash_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* dvec, float* ds, void* dq,
                             void* dk, void* dv, int BH, int seq, int D, int block, int mode,
                             float sm_scale, cudaStream_t stream) {
  if (seq < 1 || BH < 1 || (mode != F32_BWD_PAIRED && mode != F32_BWD_DS))
    return (int)cudaErrorInvalidValue;
  if (mode == F32_BWD_DS && (ds == nullptr || reinterpret_cast<uintptr_t>(ds) & 15))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, o, dout, (const void*)dq, (const void*)dk, (const void*)dv})
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorInvalidValue;
  if (D == 64 && block == 64)
    return bwd_f32_launch<64, 4>(q, k, v, o, dout, lse, dvec, ds, dq, dk, dv, BH, seq, mode,
                                 sm_scale, stream);
  if (D == 64 && block == 32)
    return bwd_f32_launch<64, 2>(q, k, v, o, dout, lse, dvec, ds, dq, dk, dv, BH, seq, mode,
                                 sm_scale, stream);
  if (D == 128 && block == 32)
    return bwd_f32_launch<128, 2>(q, k, v, o, dout, lse, dvec, ds, dq, dk, dv, BH, seq, mode,
                                  sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

template <int D>
static int bwd_wgmma_launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                            const CUtensorMap& mdo, const void* o, const void* dout,
                            const float* lse, float* aux, void* dq, void* dk, void* dv, int BH,
                            int seq, int t_pad, float sm_scale, cudaStream_t stream) {
  static const cudaError_t e_kv = set_smem(flash_bwd_dkdv_wgmma<D>, Wg<D>::SMEM);
  static const cudaError_t e_q = set_smem(flash_bwd_dq_wgmma<D>, Wg<D>::SMEM);
  if (e_kv != cudaSuccess) return (int)e_kv;
  if (e_q != cudaSuccess) return (int)e_q;
  float* lse_p = aux;
  float* d_p = aux + (size_t)BH * t_pad;
  flash_bwd_prep<D><<<BH * t_pad / 32, 256, 0, stream>>>(static_cast<const bf16*>(o),
                                                         static_cast<const bf16*>(dout), lse,
                                                         lse_p, d_p, seq, t_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_kv(BH, (seq + Wg<D>::KEYS - 1) / Wg<D>::KEYS);
  flash_bwd_dkdv_wgmma<D><<<grid_kv, W_THREADS, Wg<D>::SMEM, stream>>>(
      mq, mk, mv, mdo, lse_p, d_p, static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, t_pad,
      sm_scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 grid_q(BH, (seq + W_TILE - 1) / W_TILE);
  flash_bwd_dq_wgmma<D><<<grid_q, W_THREADS, Wg<D>::SMEM, stream>>>(
      mq, mk, mv, mdo, lse_p, d_p, static_cast<bf16*>(dq), seq, t_pad, sm_scale);
  return (int)cudaGetLastError();
}

// #6 with bf16 operands at head_dim D (64 or 128): dq, dk, dv from q, k, v,
// o, dout (BH, seq, D) bf16, 16-byte aligned, and lse (BH * seq) float32;
// aux is (2, BH, t_pad) float32 scratch, t_pad a multiple of 128 and at
// least seq. One call: the four tensor maps, then the row vectors, the
// dK/dV kernel and the dQ kernel, three launches.
extern "C" int flash_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, float* aux, void* dq,
                               void* dk, void* dv, int BH, int seq, int D, int t_pad,
                               float sm_scale, cudaStream_t stream) {
  if (seq < 1 || t_pad < seq || t_pad % W_TILE || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, o, dout, (const void*)dq, (const void*)dk, (const void*)dv})
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  int rc = bf16_map3(&mq, q, D, seq, BH, W_ROWS);
  if (!rc) rc = bf16_map3(&mk, k, D, seq, BH, W_ROWS);
  if (!rc) rc = bf16_map3(&mv, v, D, seq, BH, W_ROWS);
  if (!rc) rc = bf16_map3(&mdo, dout, D, seq, BH, W_ROWS);
  if (rc) return rc;
  if (D == 64)
    return bwd_wgmma_launch<64>(mq, mk, mv, mdo, o, dout, lse, aux, dq, dk, dv, BH, seq, t_pad,
                                sm_scale, stream);
  return bwd_wgmma_launch<128>(mq, mk, mv, mdo, o, dout, lse, aux, dq, dk, dv, BH, seq, t_pad,
                               sm_scale, stream);
}
