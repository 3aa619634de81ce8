// The fused int8 decode layer for sm_90a: LN1 + QKV, and everything after
// the attention (proj, residual, LN2, fc, GELU, mlp, residual).
//
// Replaces two Pallas kernels of llm_qat_tpu/ops/fused_decode.py:
// - `_qkv_kernel` (called by `fused_ln_qkv`, kernel #12) with the entry
//   `fused_ln_qkv`:  hn = LN1(h); qkv = i8dot(q8(hn)) + LoRA(hn);
// - `_post_kernel` (called by `fused_post_attention`, kernel #13) with the
//   entry `fused_post_attention`:
//     h1 = h + i8dot(q8(attn)) + LoRA(attn);  hn = LN2(h1);
//     g = GELU(i8dot(q8(hn)) + LoRA(hn));      out = h1 + i8dot(q8(g)) + LoRA(g)
// where q8(x) = clamp(rne(x / xs), +-127) with a static activation scale xs,
// i8dot(qx) = float(qx . w_i8) * (xs * ws[n]) + b[n] with an exact int32
// dot, and LoRA(x) = bank(bank(x) . A) . B with float32 sums (bank(): the
// LoRA bank's dtype, bf16 or float32). The Python wrappers are
// llm_qat_tpu_torch/ops/fused_decode.py::fused_ln_qkv and
// ::fused_post_attention, with their plain PyTorch versions beside them.
//
// Every float32 step follows the JAX kernel's order, each rounded on its
// own as PyTorch's elementwise ops are: IEEE division in q8 and LN (not a
// reciprocal), rintf (round half to even), xs * ws formed first and then
// acc * (xs * ws) + b, the A&S 7.1.26 erf of the JAX `_erf` (not erff), and
// the __fmul_rn/__fadd_rn intrinsics wherever a product feeds a sum, so
// that nvcc contracts nothing into an FMA. LN's rsqrt is rsqrtf, which is
// what torch.rsqrt runs on the card. The int8 dots are exact (__dp4a in
// int32), so the kernel and its plain version differ only where the
// float32 sums of LN and LoRA are taken in another order; such a difference
// moves an activation code now and then, when a value sits on a rounding
// boundary of q8.
//
// Bound. At decode batch sizes (B <= 16) the layer is a GEMV, far below
// the card's operations-per-byte line: it must read its int8 weights (#13:
// 8 d^2 bytes, 4.7 MB at d = 768; #12: 3 d^2, 1.8 MB), the LoRA banks (1.2
// and 0.4 MB at rank 64 in bf16), scales, biases and the activations, about
// 2 us and 0.7 us at 3.35 TB/s.
//
// Design. The TPU kernels are one grid-less program each, the weights in
// VMEM. Here each entry is one cooperative launch of the persistent kernel
// k_fused on one block per SM (ops/fused_decode.py::fused_grid; a grid the
// card cannot hold at once is refused and the wrapper raises, there is no
// other path); a launch takes at most MAXB batch rows and the wrappers
// launch once per 16 rows, and an output width that is not a multiple of
// E_COLS runs on operands padded with zero columns. The plan
// (ops/fused_decode.py::fused_plan, passed as an
// int32 table of one record per block) gives each block pieces of each
// linear's weight (a column group of CW columns x a range of K rows), its
// LoRA-A items (la_rows input rows x every LoRA output) and its epilogue
// items (E_COLS columns x every batch row), balanced by bytes over the
// whole layer, and where each lands in the block's shared memory. The
// layer's bytes fit the card's shared memory at once (6.5 MB for #13 at
// GPT-2 124M width, 50 KB a block over 132 SMs): the prologue asks for all
// of a block's operands, in phase order, each linear's on its own
// mbarrier: its weight rows and LoRA-B slices as 2-D TMA boxes (BOX_ROWS
// rows x CW bytes of codes; r rows x E_COLS of a bank; tensor maps built
// once per weight), its LoRA-A rows, scales, biases and LN parameters as
// bulk copies. No phase waits on device memory for a weight byte: a
// phase's first use of its linear's operands waits on that mbarrier, which
// the copies have long completed (a few dozen requests a block; one per
// 128-byte row took about 3 us to issue). Then the phases, a grid barrier
// (sm90.cuh's grid_sync, one counter in device memory, zeroed once per
// device) after each but the last:
//   #13  G_proj | E_proj | G_fc | E_fc | G_mlp | E_mlp     (5 barriers)
//   #12  G_qkv  | E_qkv                                    (1 barrier)
//   G  the block's inputs first, every load of the phase in flight at once:
//      the raw rows of its pieces' and items' K ranges (attn, g), or for the
//      LN linear (#12's qkv, #13's fc) all B x d input rows, LN statistics
//      per row by one warp in one fixed order (the same in every block),
//      and the normalized values of its rows; q8 codes and bank-rounded
//      floats in shared memory. Then the int32 dots of its pieces (warp w:
//      batch rows w and w + 8, lane: 4 columns, __dp4a on 4 K rows of codes
//      from shared memory), each piece to a partial-sum slot of its own in
//      device memory; then its LoRA-A items, float partials per item, from
//      inputs stored k-major and read as float4.
//   E  per epilogue item: the rounded LoRA-A sums (every item's partials
//      added in item order), the column group's slots in the plan's order
//      (int32, exact), scale and bias, LoRA-B from its bank slice in shared
//      memory, then the residual (h, or h1 for the mlp) or the A&S GELU;
//      rows go to h1 / g in device memory, or to the output.
// Sum orders: int32 sums are exact in any order; every float sum runs in a
// fixed order (LN per row over lanes then a shuffle tree, LoRA-A per item
// over strided K rows then over the strides, items in order, LoRA-B over
// four rank groups joined by shuffles), so two calls on the same inputs and
// grid are bit-equal. No memset and no atomics but the grid barrier's.
// Loads from device memory inside a phase are issued unconditionally at
// clamped indices, only their use guarded: behind a runtime guard each
// load compiled to a branch of its own, and a round of them took 3 us
// instead of 0.25.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "sm90.cuh"

#define PT 256          // threads of a block
#define NWARPS (PT / 32)
#define CW 128          // columns of a weight piece: 32 lanes x 4
#define E_COLS 32       // columns of an epilogue item
#define MAXB 16         // batch rows of one launch (the wrappers launch once per 16)
#define MAXR 128        // LoRA rank: a loop bound and a TMA box dimension (<= 256)
#define MAX_LIN 3       // linears of a launch
#define LA_LOADS 24     // LoRA-A partials an epilogue output adds (items of a linear, at most)
#define SLOT_LOADS 8    // partial-sum slots a lane loads at once
#define IN_LOADS 8      // input values a thread loads at once
#define COPY_CHUNK 4096 // bytes of one bulk copy of a contiguous operand
#define BOX_ROWS 16     // weight rows of one TMA box (CW bytes wide)
#define FIXED_BYTES 256 // mbarriers (32 bytes), then the scalars below
// the block record (ops/fused_decode.py::fused_plan): a header of RH ints
// (per linear j: pieces, LoRA-A items, epilogue items at 3j..3j+2; the
// shared-memory offset of the LN parameters at R_LN), then per linear its
// pieces (column group, first K row, end K row, slot, shared-memory offset
// of the codes, offset of the activation codes in the activation region),
// items (t, offset of the bank rows, offset of the inputs in the
// activation region) and epilogue items (e, offset of the LoRA-B slice,
// offset of the scale and bias slices, first and end slot of the group)
#define RH 16
#define R_LN 9
#define P_PIECE 6
#define P_ITEM 3
#define P_EPI 5
// the launch header (host memory): fused_plan's H_*
#define H_NB 0
#define H_NLIN 1
#define H_SMEM 2
#define H_REC_LEN 3
#define H_REC 4
#define H_WORK 5
#define H_ACT 6
#define H_RED 7
#define H_XA 8
#define H_LA0 9
#define H_SC_LAP 12
#define H_SC_H1 13
#define H_SC_G 14
#define H_LN_AT 16
// scalars in shared memory (floats after the mbarriers)
#define S_XS 0          // xs of each linear
#define S_WS0 4         // the per-tensor weight scale of each linear
#define S_MEAN 8        // LN statistics per batch row
#define S_RSTD (S_MEAN + MAXB)
static_assert(32 + 4 * (S_RSTD + MAXB) <= FIXED_BYTES, "the scalars fit before the record");
#define MODE_OUT 0      // out = y
#define MODE_RESID 1    // out = resid + y
#define MODE_GELU 2     // out = GELU(y)

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// x rounded to the LoRA bank's dtype
template <typename T> __device__ __forceinline__ float in_bank(float x);
template <> __device__ __forceinline__ float in_bank<float>(float x) { return x; }
template <> __device__ __forceinline__ float in_bank<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float q8(float x, float xs) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, xs)), -127.f), 127.f);
}

// Abramowitz & Stegun 7.1.26, as the JAX `_erf`
__device__ __forceinline__ float erf_as(float z) {
  const float s = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  const float za = fabsf(z);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(0.3275911f, za)));
  float poly = __fmul_rn(1.061405429f, t);
  poly = __fmul_rn(__fsub_rn(poly, 1.453152027f), t);
  poly = __fmul_rn(__fadd_rn(poly, 1.421413741f), t);
  poly = __fmul_rn(__fsub_rn(poly, 0.284496736f), t);
  poly = __fmul_rn(__fadd_rn(poly, 0.254829592f), t);
  return __fmul_rn(s, __fsub_rn(1.f, __fmul_rn(poly, expf(__fmul_rn(-za, za)))));
}

__device__ __forceinline__ float gelu(float x) {
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, erf_as(__fmul_rn(x, 0.70710678118654752f))));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One linear of a launch. Its input rows are x (B, K), or LN(x) for the
// launch's LN linear; its output rows out (B, N), with the residual resid
// (B, N) for MODE_RESID.
struct FLin {
  const int8_t* w;      // (K, N) codes
  const float* ws;      // (N) scales, or (1)
  const float* bias;    // (N)
  const void* la;       // (K, r) LoRA-A bank
  const void* lb;       // (r, N) LoRA-B bank
  const float* x;
  const float* resid;
  float* out;
  int K, N, ws_col, mode, la_rows;
};

struct Fused {
  CUtensorMap wmap[MAX_LIN];   // each linear's codes (K rows of N bytes), boxes of BOX_ROWS x CW
  CUtensorMap lbmap[MAX_LIN];  // its LoRA-B bank (r rows of N), boxes of r x E_COLS
  FLin lin[MAX_LIN];
  const float* ln_g; const float* ln_b;  // (d) of the LN linear
  const float* xs;                       // (n_lin) static input scales
  int32_t* slots;                        // (slots, B, CW) int32 partial sums
  float* lap;                            // (items, B, r) LoRA-A partials
  unsigned* bar;                         // the grid barrier's counter
  unsigned long long* clk;               // barrier clock, or null
  const int* plan;                       // the blocks' records, rec_len ints each
  int n_lin, ln_at, B, r, rec_len, rec_off, work_off, act_off, red_off, xa_off;
  float eps;
};

// The block's entries of linear j start at rec + RH + ent_off(rec, j).
__device__ __forceinline__ int ent_off(const int* rec, int j) {
  int off = 0;
  for (int i = 0; i < j; ++i) off += P_PIECE * rec[3 * i] + P_ITEM * rec[3 * i + 1] + P_EPI * rec[3 * i + 2];
  return off;
}

// Thread tid's share of njobs jobs, dealt round-robin from a running base
// (so that consecutive lists spread over the block): calls job(i).
template <typename F>
__device__ __forceinline__ void deal(int njobs, int& base, F job) {
  for (int i = (threadIdx.x - base % PT + PT) % PT; i < njobs; i += PT) job(i);
  base += njobs;
}

// Contiguous bytes [src, src + bytes) into shared memory at dst, in
// COPY_CHUNK pieces (bytes, dst and src 16-byte aligned).
template <typename F>
__device__ __forceinline__ void copy_jobs(int bytes, int& base, F issue) {
  deal((bytes + COPY_CHUNK - 1) / COPY_CHUNK, base, [&](int i) {
    issue(i * COPY_CHUNK, min(COPY_CHUNK, bytes - i * COPY_CHUNK));
  });
}

// The prologue's copies of the block's operands of linear j, on mbarrier
// bar: its pieces' weight rows (TMA boxes of BOX_ROWS rows: a piece's last
// box may reach past it, into the padding of its shared-memory range), its
// LoRA-A rows (bulk copies), LoRA-B slices (one box each) and its epilogue
// columns' scales and biases (bulk copies), and the LN parameters if j is
// the LN linear. With count, thread 0 only adds up the bytes instead.
template <typename TB>
__device__ int lin_copies(const Fused& a, int j, const int* rec, uint8_t* sm, uint32_t bar,
                          int& base, bool count) {
  const FLin& L = a.lin[j];
  const int np = rec[3 * j], ni = rec[3 * j + 1], ne = rec[3 * j + 2], r = a.r;
  const int* e = rec + RH + ent_off(rec, j);
  int bytes = 0;
  auto copy = [&](uint32_t dst, const void* src, int n) {
    if (!count) bulk_load(dst, src, n, bar);
  };
  const uint32_t s0 = smem_u32(sm);
  if (j == a.ln_at) {
    const int nbytes = 4 * L.K;
    bytes += 2 * nbytes;
    if (!count) {
      copy_jobs(nbytes, base, [&](int o, int n) {
        copy(s0 + rec[R_LN] + o, reinterpret_cast<const char*>(a.ln_g) + o, n);
      });
      copy_jobs(nbytes, base, [&](int o, int n) {
        copy(s0 + rec[R_LN] + nbytes + o, reinterpret_cast<const char*>(a.ln_b) + o, n);
      });
    }
  }
  for (int p = 0; p < np; ++p, e += P_PIECE) {
    const int g = e[0], r0 = e[1], boxes = (e[2] - e[1] + BOX_ROWS - 1) / BOX_ROWS, soff = e[4];
    bytes += boxes * BOX_ROWS * CW;  // a box past the codes' edge is filled with zeros
    if (!count)
      deal(boxes, base, [&](int i) {
        tma_load(s0 + soff + i * BOX_ROWS * CW, &a.wmap[j], g * CW, r0 + i * BOX_ROWS, bar);
      });
  }
  const int esz = sizeof(TB);
  for (int q = 0; q < ni; ++q, e += P_ITEM) {
    const int t = e[0], rows = min(L.la_rows, L.K - t * L.la_rows);
    const int nbytes = rows * r * esz;
    bytes += nbytes;
    if (!count) {
      const char* src = static_cast<const char*>(L.la) + (size_t)t * L.la_rows * r * esz;
      copy_jobs(nbytes, base, [&](int o, int n) { copy(s0 + e[1] + o, src + o, n); });
    }
  }
  for (int q = 0; q < ne; ++q, e += P_EPI) {
    const int c0 = e[0] * E_COLS;
    bytes += r * E_COLS * esz + (L.ws_col ? 2 : 1) * E_COLS * 4;
    if (count) continue;
    deal(3, base, [&](int i) {
      if (i == 0 && r > 0) tma_load(s0 + e[1], &a.lbmap[j], c0, 0, bar);
      if (i == 1 && L.ws_col) copy(s0 + e[2], L.ws + c0, E_COLS * 4);
      if (i == 2) copy(s0 + e[2] + E_COLS * 4, L.bias + c0, E_COLS * 4);
    });
  }
  return bytes;
}

// G phase of linear j: inputs, the dots of the block's pieces (to their
// slots), its LoRA-A items (to the LoRA-A partials).
template <typename TB>
__device__ void phase_g(const Fused& a, int j, const int* rec, uint8_t* sm, float* scal,
                        uint32_t bar) {
  const FLin& L = a.lin[j];
  const int B = a.B, K = L.K, r = a.r, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int np = rec[3 * j], ni = rec[3 * j + 1];
  const int* pc = rec + RH + ent_off(rec, j);
  const int* it = pc + P_PIECE * np;
  uint8_t* work = sm + a.work_off;
  int8_t* act = reinterpret_cast<int8_t*>(work + a.act_off);
  const float xs = scal[S_XS + j];
  const bool ln = j == a.ln_at;
  float* rows = reinterpret_cast<float*>(work);  // the LN linear's input rows (B, K)
  if (np == 0 && ni == 0) return;
  if (ln) {
    // the rows, IN_LOADS float4 a thread in flight before any is stored
    const float4* src = reinterpret_cast<const float4*>(L.x);
    float4* dst = reinterpret_cast<float4*>(rows);
    const int n4 = B * K / 4;
    for (int i0 = tid; i0 < n4; i0 += IN_LOADS * PT) {
      float4 v[IN_LOADS];
#pragma unroll
      for (int u = 0; u < IN_LOADS; ++u) v[u] = __ldcg(src + min(i0 + u * PT, n4 - 1));
#pragma unroll
      for (int u = 0; u < IN_LOADS; ++u)
        if (i0 + u * PT < n4) dst[i0 + u * PT] = v[u];
    }
    __syncthreads();
    // statistics of each row: one warp, lanes over K in a fixed order
    for (int b = warp; b < B; b += NWARPS) {
      const float* xr = rows + b * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s = __fadd_rn(s, xr[k]);
      const float mu = __fdiv_rn(warp_sum(s), (float)K);
      float v = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float dl = __fsub_rn(xr[k], mu);
        v = __fadd_rn(v, __fmul_rn(dl, dl));
      }
      v = warp_sum(v);
      if (lane == 0) {
        scal[S_MEAN + b] = mu;
        scal[S_RSTD + b] = rsqrtf(__fadd_rn(__fdiv_rn(v, (float)K), a.eps));
      }
    }
    mbar_wait(bar, 0);  // the LN parameters
    __syncthreads();
  }
  const float* lng = reinterpret_cast<const float*>(sm + rec[R_LN]);
  const float* lnb = lng + K;
  auto xin = [&](int b, int k) -> float {
    if (ln)
      return __fadd_rn(__fmul_rn(__fmul_rn(lng[k], __fsub_rn(rows[b * K + k], scal[S_MEAN + b])),
                                 scal[S_RSTD + b]),
                       lnb[k]);
    return __ldcg(L.x + (size_t)b * K + k);
  };
  // n input values, IN_LOADS a thread in flight before any is stored
  // (loads at clamped indices, so that none waits on a branch): value o is
  // x(at(o)) and goes to put(o, x)
  auto inputs = [&](int n, auto at, auto put) {
    for (int o0 = tid; o0 < n; o0 += IN_LOADS * PT) {
      float v[IN_LOADS];
#pragma unroll
      for (int u = 0; u < IN_LOADS; ++u) {
        const int2 bk = at(min(o0 + u * PT, n - 1));
        v[u] = xin(bk.x, bk.y);
      }
#pragma unroll
      for (int u = 0; u < IN_LOADS; ++u)
        if (o0 + u * PT < n) put(o0 + u * PT, v[u]);
    }
  };
  // activation codes of the pieces' rows ([b][k]); bank-rounded inputs of
  // the items, k-major ([k][b], b padded to B4) for float4 reads
  const int B4 = (B + 3) & ~3;
  for (int p = 0; p < np; ++p) {
    const int* e = pc + P_PIECE * p;
    const int r0 = e[1], R = e[2] - e[1];
    int8_t* dst = act + e[5];
    inputs(B * R, [&](int o) { return make_int2(o / R, r0 + o % R); },
           [&](int o, float x) { dst[o] = (int8_t)q8(x, xs); });
  }
  for (int q = 0; q < ni; ++q) {
    const int* e = it + P_ITEM * q;
    const int k0 = e[0] * L.la_rows, nr = min(L.la_rows, K - k0);
    float* dst = reinterpret_cast<float*>(act + e[2]);
    for (int o = tid; o < nr * B4; o += PT)
      if (o % B4 >= B) dst[o] = 0.f;
    inputs(B * nr, [&](int o) { return make_int2(o % B, k0 + o / B); },
           [&](int o, float x) { dst[(o / B) * B4 + o % B] = in_bank<TB>(x); });
  }
  if (!ln) mbar_wait(bar, 0);
  __syncthreads();

  // the dots of each piece: warp w takes batch rows w and w + 8, a lane 4
  // columns, over all of the piece's K rows
  for (int p = 0; p < np; ++p) {
    const int* e = pc + P_PIECE * p;
    const int R = e[2] - e[1], slot = e[3];
    const uint8_t* wsm = sm + e[4] + lane * 4;
    const int8_t* ap = act + e[5];
    int acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0;
#pragma unroll 4
    for (int s = 0; s < R / 4; ++s) {
      const uint8_t* base = wsm + 4 * s * CW;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(base);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(base + CW);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(base + 2 * CW);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(base + 3 * CW);
      // four K rows of four columns as four column words, row 4s in the low byte
      const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
      const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
      const int cw[4] = {(int)__byte_perm(t0, t2, 0x5410), (int)__byte_perm(t0, t2, 0x7632),
                         (int)__byte_perm(t1, t3, 0x5410), (int)__byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = warp + NWARPS * i;
        if (b < B) {
          const int av = *reinterpret_cast<const int*>(ap + b * R + 4 * s);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = __dp4a(av, cw[jj], acc[i][jj]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = warp + NWARPS * i;
      if (b < B)
        *reinterpret_cast<int4*>(a.slots + ((size_t)slot * B + b) * CW + lane * 4) =
            make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }

  if (r == 0 || ni == 0) return;
  // LoRA-A items: thread (jj, kgi) sums input rows kgi, kgi + kg, ... of
  // output jj; the kg sums are then added in order
  const int kg = PT / r, jj = tid % r, kgi = tid / r;
  float* red = reinterpret_cast<float*>(work + a.red_off);  // (kg, B, r)
  for (int q = 0; q < ni; ++q) {
    const int* e = it + P_ITEM * q;
    const int t = e[0], nr = min(L.la_rows, K - t * L.la_rows);
    const TB* bank = reinterpret_cast<const TB*>(sm + e[1]);
    const float4* x4 = reinterpret_cast<const float4*>(act + e[2]);  // (nr, B4 / 4)
    if (kgi < kg) {
      float acc[MAXB];
#pragma unroll
      for (int b = 0; b < MAXB; ++b) acc[b] = 0.f;
#pragma unroll 4
      for (int k = kgi; k < nr; k += kg) {
        const float w = to_f(bank[k * r + jj]);  // bank x bank products: exact in float32 for bf16
#pragma unroll
        for (int b4 = 0; b4 < MAXB / 4; ++b4) {
          if (4 * b4 < B) {
            const float4 x = x4[k * (B4 / 4) + b4];
            acc[4 * b4] = fmaf(x.x, w, acc[4 * b4]);
            acc[4 * b4 + 1] = fmaf(x.y, w, acc[4 * b4 + 1]);
            acc[4 * b4 + 2] = fmaf(x.z, w, acc[4 * b4 + 2]);
            acc[4 * b4 + 3] = fmaf(x.w, w, acc[4 * b4 + 3]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < MAXB; ++b)
        if (b < B) red[(kgi * B + b) * r + jj] = acc[b];
    }
    __syncthreads();
    for (int o = tid; o < B * r; o += PT) {
      float v = red[o];
      for (int l = 1; l < kg; ++l) v = __fadd_rn(v, red[l * B * r + o]);
      a.lap[(size_t)t * B * r + o] = v;
    }
    __syncthreads();
  }
}

// xa[o] = bank(sum of the n_items LoRA-A partials lap[t][o], in item
// order) for o < n: every partial of two outputs loaded at once (NI loads
// an output at clamped indices, none behind a branch), then added.
template <int NI, typename TB>
__device__ void lora_a_sums(const float* lap, int n_items, int n, float* xa) {
  for (int o0 = threadIdx.x; o0 < n; o0 += 2 * PT) {
    const int ob = min(o0 + PT, n - 1);
    float pa[NI], pb[NI];
#pragma unroll
    for (int t = 0; t < NI; ++t) {
      const size_t tt = (size_t)min(t, n_items - 1) * n;
      pa[t] = __ldcg(lap + tt + o0);
      pb[t] = __ldcg(lap + tt + ob);
    }
    float sa = pa[0], sb = pb[0];
#pragma unroll
    for (int t = 1; t < NI; ++t)
      if (t < n_items) {
        sa = __fadd_rn(sa, pa[t]);
        sb = __fadd_rn(sb, pb[t]);
      }
    xa[o0] = in_bank<TB>(sa);
    if (o0 + PT < n) xa[o0 + PT] = in_bank<TB>(sb);
  }
}

// E phase of linear j: the block's epilogue items.
template <typename TB>
__device__ void phase_e(const Fused& a, int j, const int* rec, uint8_t* sm, const float* scal,
                        uint32_t bar) {
  const FLin& L = a.lin[j];
  const int B = a.B, N = L.N, r = a.r, tid = threadIdx.x;
  const int np = rec[3 * j], ni = rec[3 * j + 1], ne = rec[3 * j + 2];
  if (ne == 0) return;
  mbar_wait(bar, 0);  // its LoRA-B slices, scales and biases
  const int* ep = rec + RH + ent_off(rec, j) + P_PIECE * np + P_ITEM * ni;
  uint8_t* work = sm + a.work_off;
  float* xa = reinterpret_cast<float*>(work + a.xa_off);  // (B, r), rounded
  const float xs = scal[S_XS + j], ws0 = scal[S_WS0 + j];
  // outputs (item, batch row, 4 columns, lane group p of 4): p sums every
  // fourth slot of the group and a quarter of the LoRA-B ranks; the four
  // join by shuffles in a fixed order
  constexpr int NQ = E_COLS / 4;
  const int rpg = (r + 3) / 4;
  const int nout = ne * B * NQ * 4;  // a multiple of 32
  int4 v[SLOT_LOADS];
  float4 res = make_float4(0.f, 0.f, 0.f, 0.f);
  // output o's residual and its first SLOT_LOADS slots of lane group p
  auto load = [&](int o) {
    const int p = o & 3, q = (o >> 2) % NQ, rest = (o >> 2) / NQ;
    const int b = rest % B, *e = ep + P_EPI * (rest / B);
    const int n = e[0] * E_COLS + 4 * q, s0 = e[3] + p, s1 = e[4];
    if (L.mode == MODE_RESID) res = __ldcg(reinterpret_cast<const float4*>(L.resid + (size_t)b * N + n));
#pragma unroll
    for (int u = 0; u < SLOT_LOADS; ++u)  // clamped: slots past the group's are loaded, not added
      v[u] = __ldcg(reinterpret_cast<const int4*>(
          a.slots + ((size_t)min(s0 + 4 * u, s1 - 1) * B + b) * CW + n % CW));
  };
  // the slots and residual of this thread's first output are asked for
  // before the LoRA-A sums, so that the two wait on device memory together
  if (tid < nout) load(tid);
  if (r > 0) {
    const int n_items = (L.K + L.la_rows - 1) / L.la_rows;
    if (n_items <= 8) lora_a_sums<8, TB>(a.lap, n_items, B * r, xa);
    else if (n_items <= 16) lora_a_sums<16, TB>(a.lap, n_items, B * r, xa);
    else lora_a_sums<LA_LOADS, TB>(a.lap, n_items, B * r, xa);
    __syncthreads();
  }
  for (int o = tid; o < nout; o += PT) {
    if (o != tid) load(o);
    const int p = o & 3, q = (o >> 2) % NQ, rest = (o >> 2) / NQ;
    const int b = rest % B, *e = ep + P_EPI * (rest / B);
    const int n = e[0] * E_COLS + 4 * q, s0 = e[3] + p, s1 = e[4];
    int qa[4] = {0, 0, 0, 0};
#pragma unroll
    for (int u = 0; u < SLOT_LOADS; ++u)
      if (s0 + 4 * u < s1) {
        qa[0] += v[u].x; qa[1] += v[u].y; qa[2] += v[u].z; qa[3] += v[u].w;
      }
    for (int sb = s0 + 4 * SLOT_LOADS; sb < s1; sb += 4) {  // groups of more slots
      const int4 w = __ldcg(reinterpret_cast<const int4*>(a.slots + ((size_t)sb * B + b) * CW + n % CW));
      qa[0] += w.x; qa[1] += w.y; qa[2] += w.z; qa[3] += w.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      qa[jj] += __shfl_xor_sync(0xffffffffu, qa[jj], 1);
      qa[jj] += __shfl_xor_sync(0xffffffffu, qa[jj], 2);
    }
    float lo[4] = {0.f, 0.f, 0.f, 0.f};
    if (r > 0) {
      const TB* lbs = reinterpret_cast<const TB*>(sm + e[1]) + 4 * q;
      const int j0 = p * rpg, j1 = min(r, j0 + rpg);
      for (int jr = j0; jr < j1; ++jr) {
        const float x = xa[b * r + jr];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) lo[jj] = fmaf(x, to_f(lbs[jr * E_COLS + jj]), lo[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        lo[jj] = __fadd_rn(lo[jj], __shfl_xor_sync(0xffffffffu, lo[jj], 1));
        lo[jj] = __fadd_rn(lo[jj], __shfl_xor_sync(0xffffffffu, lo[jj], 2));
      }
    }
    if (p != 0) continue;
    const float* vec = reinterpret_cast<const float*>(sm + e[2]);  // ws (E_COLS), bias (E_COLS)
    const float rv[4] = {res.x, res.y, res.z, res.w};
    float y[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float sc = __fmul_rn(xs, L.ws_col ? vec[4 * q + jj] : ws0);
      float val = __fadd_rn(__fmul_rn((float)qa[jj], sc), vec[E_COLS + 4 * q + jj]);
      if (r > 0) val = __fadd_rn(val, lo[jj]);
      if (L.mode == MODE_RESID) val = __fadd_rn(rv[jj], val);
      else if (L.mode == MODE_GELU) val = gelu(val);
      y[jj] = val;
    }
    *reinterpret_cast<float4*>(L.out + (size_t)b * N + n) = make_float4(y[0], y[1], y[2], y[3]);
  }
}

template <typename TB>
__global__ void __launch_bounds__(PT, 1) k_fused(const __grid_constant__ Fused a) {
  extern __shared__ __align__(128) uint8_t sm[];
  const int nb = gridDim.x, tid = threadIdx.x;
  const unsigned long long t_start = a.clk ? global_ns() : 0ull;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(sm);
  float* scal = reinterpret_cast<float*>(sm + 32);
  int* rec = reinterpret_cast<int*>(sm + a.rec_off);

  // prologue: the block's record and scalars, then every operand's bulk copy
  if (tid == 0) {
    for (int j = 0; j < a.n_lin; ++j) mbar_init(smem_u32(mbar + j), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int* grec = a.plan + (size_t)blockIdx.x * a.rec_len;
  for (int i = tid; i < a.rec_len; i += PT) rec[i] = grec[i];
  if (tid < a.n_lin) {
    scal[S_XS + tid] = a.xs[tid];
    scal[S_WS0 + tid] = a.lin[tid].ws_col ? 0.f : a.lin[tid].ws[0];
  }
  __syncthreads();
  if (tid == 0) {
    int base = 0;
    for (int j = 0; j < a.n_lin; ++j)
      mbar_expect_tx(smem_u32(mbar + j), lin_copies<TB>(a, j, rec, sm, 0, base, true));
  }
  __syncthreads();
  int base = 0;
  for (int j = 0; j < a.n_lin; ++j) lin_copies<TB>(a, j, rec, sm, smem_u32(mbar + j), base, false);

  int nbar = 0;
  for (int j = 0; j < a.n_lin; ++j) {
    phase_g<TB>(a, j, rec, sm, scal, smem_u32(mbar + j));
    grid_sync(a.bar, a.clk, nb, nbar);
    phase_e<TB>(a, j, rec, sm, scal, smem_u32(mbar + j));
    if (j + 1 < a.n_lin) grid_sync(a.bar, a.clk, nb, nbar);
  }
  // every operand copy has landed before the block's shared memory goes
  for (int j = 0; j < a.n_lin; ++j) mbar_wait(smem_u32(mbar + j), 0);
  if (a.clk && tid == 0) {
    a.clk[(size_t)2 * nbar * nb + blockIdx.x] = global_ns();
    a.clk[(size_t)(2 * nbar + 1) * nb + blockIdx.x] = t_start;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

#define SMEM_MAX 232448  // dynamic shared memory a block may ask for (227 KB)

// Set by fused_phase_clock: the buffer the next launches write their barrier
// times to (instrumentation), or null.
static unsigned long long* g_clk = nullptr;

extern "C" int fused_phase_clock(unsigned long long* clk) {
  g_clk = clk;
  return 0;
}

static FLin make_lin(const int8_t* w, const float* ws, const float* bias, const void* la,
                     const void* lb, const float* x, const float* resid, float* out, int K,
                     int N, int ws_col, int mode, int la_rows) {
  FLin l = {};
  l.w = w; l.ws = ws; l.bias = bias; l.la = la; l.lb = lb; l.x = x; l.resid = resid;
  l.out = out; l.K = K; l.N = N; l.ws_col = ws_col; l.mode = mode; l.la_rows = la_rows;
  return l;
}

// The launch's layout from the plan's header (hdr: host memory), the
// scratch (slots at 0, then the LoRA-A partials, h1 and g) and the
// counters.
static void set_layout(Fused& f, const int* hdr, char* scratch, unsigned* bar,
                       const int* plan, const float* xs, int B, int r, float eps) {
  f.n_lin = hdr[H_NLIN]; f.ln_at = hdr[H_LN_AT]; f.B = B; f.r = r;
  f.rec_len = hdr[H_REC_LEN]; f.rec_off = hdr[H_REC]; f.work_off = hdr[H_WORK];
  f.act_off = hdr[H_ACT]; f.red_off = hdr[H_RED]; f.xa_off = hdr[H_XA]; f.eps = eps;
  f.slots = reinterpret_cast<int32_t*>(scratch);
  f.lap = reinterpret_cast<float*>(scratch + hdr[H_SC_LAP]);
  f.bar = bar; f.clk = g_clk; f.plan = plan; f.xs = xs;
}

template <typename TB>
static int launch(Fused& f, int grid, int smem, cudaStream_t stream) {
  const void* fn = (const void*)k_fused<TB>;
  int rc = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (rc) return rc;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  void* args[] = {&f};
  rc = (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(PT), args, smem, stream);
  if (rc) {
    cudaGetLastError();  // a refused launch (a grid the card cannot hold) leaves no error behind
    return rc;
  }
  return (int)cudaGetLastError();
}

static bool bad_shape(int B, int r) { return B < 1 || B > MAXB || r < 0 || r > MAXR; }

// The 2-D tensor map of a row-major matrix (outer rows of inner elements of
// type dt, `esz` bytes each), read in boxes of box_in x box_out with no
// swizzle; built once per (matrix, box) and kept in a small cache (a map
// describes addresses and shapes only, so a reused address stays right).
static int tile_map(CUtensorMap* out, CUtensorMapDataType dt, int esz, const void* ptr,
                    int inner, int outer, int box_in, int box_out) {
  struct Entry {
    const void* ptr;
    int dt, inner, outer, box_in, box_out;
    CUtensorMap map;
  };
  static Entry cache[256];
  static int n_cached = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cached; ++i) {
    const Entry& c = cache[i];
    if (c.ptr == ptr && c.dt == (int)dt && c.inner == inner && c.outer == outer &&
        c.box_in == box_in && c.box_out == box_out) {
      *out = c.map;
      return 0;
    }
  }
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorSharedObjectSymbolNotFound;
  Entry& c = cache[next];
  next = (next + 1) % 256;
  n_cached = n_cached < 256 ? n_cached + 1 : 256;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * esz};
  const cuuint32_t box[2] = {(cuuint32_t)box_in, (cuuint32_t)box_out};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult rc = enc(&c.map, dt, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) {
    c.ptr = nullptr;
    return (int)cudaErrorInvalidValue;
  }
  c.ptr = ptr; c.dt = (int)dt; c.inner = inner; c.outer = outer; c.box_in = box_in;
  c.box_out = box_out;
  *out = c.map;
  return 0;
}

// The maps of linear j's codes and LoRA-B bank.
static int lin_maps(Fused& f, int j, int bank_bf16) {
  const FLin& l = f.lin[j];
  int rc = tile_map(&f.wmap[j], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, l.w, l.N, l.K, CW, BOX_ROWS);
  if (rc || f.r == 0) return rc;
  return tile_map(&f.lbmap[j],
                  bank_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  bank_bf16 ? 2 : 4, l.lb, l.N, f.r, E_COLS, f.r);
}

// #12: out (B, N) float32. h (B, d) float32; g, bln (d); w (d, N) int8; ws
// (N) if ws_col, else (1); bias (N); xs (1) float32 on the device; la (d, r),
// lb (r, N) in the bank dtype (bf16 if bank_bf16, else float32), unused when
// r = 0; scratch: the plan's scratch bytes; bar: the grid barrier's counter;
// plan: the records on the device, hdr: the plan's header in host memory.
// Every device pointer 16-byte aligned, every width a multiple of 32.
extern "C" int fused_ln_qkv(const float* h, const float* g, const float* bln, const int8_t* w,
                            const float* ws, const float* bias, const float* xs, const void* la,
                            const void* lb, float* out, void* scratch, unsigned* bar,
                            const int* plan, const int* hdr, int B, int d, int N, int r,
                            int ws_col, int bank_bf16, float eps, cudaStream_t stream) {
  if (bad_shape(B, r) || hdr[H_NLIN] != 1) return (int)cudaErrorInvalidValue;
  Fused f = {};
  set_layout(f, hdr, static_cast<char*>(scratch), bar, plan, xs, B, r, eps);
  f.lin[0] = make_lin(w, ws, bias, la, lb, h, nullptr, out, d, N, ws_col, MODE_OUT, hdr[H_LA0]);
  f.ln_g = g; f.ln_b = bln;
  const int rc = lin_maps(f, 0, bank_bf16);
  if (rc) return rc;
  return bank_bf16 ? launch<bf16>(f, hdr[H_NB], hdr[H_SMEM], stream)
                   : launch<float>(f, hdr[H_NB], hdr[H_SMEM], stream);
}

// #13: out (B, d) float32. attn, h (B, d) float32; g2, b2 (d); proj (wp
// (d, d), wps, bp (d)), fc (wf (d, dff), wfs, bf (dff)), mlp (wm (dff, d),
// wms, bm (d)), each with LoRA banks (d or dff, r) and (r, d or dff) in the
// bank dtype; bit i of ws_cols set when linear i has a scale per column
// (else one); xs3 (3) float32 on the device; scratch, bar, plan, hdr as
// for #12 (h1 and g live in the scratch).
extern "C" int fused_post_attention(
    const float* attn, const float* h, const float* g2, const float* b2, const int8_t* wp,
    const float* wps, const float* bp, const void* pa, const void* pb, const int8_t* wf,
    const float* wfs, const float* bf, const void* fa, const void* fb, const int8_t* wm,
    const float* wms, const float* bm, const void* ma, const void* mb, const float* xs3,
    float* out, void* scratch, unsigned* bar, const int* plan, const int* hdr, int B, int d,
    int dff, int r, int ws_cols, int bank_bf16, float eps, cudaStream_t stream) {
  if (bad_shape(B, r) || hdr[H_NLIN] != 3) return (int)cudaErrorInvalidValue;
  Fused f = {};
  char* sc = static_cast<char*>(scratch);
  set_layout(f, hdr, sc, bar, plan, xs3, B, r, eps);
  float* h1 = reinterpret_cast<float*>(sc + hdr[H_SC_H1]);
  float* gb = reinterpret_cast<float*>(sc + hdr[H_SC_G]);
  f.lin[0] = make_lin(wp, wps, bp, pa, pb, attn, h, h1, d, d, ws_cols & 1, MODE_RESID,
                      hdr[H_LA0]);
  f.lin[1] = make_lin(wf, wfs, bf, fa, fb, h1, nullptr, gb, d, dff, (ws_cols >> 1) & 1,
                      MODE_GELU, hdr[H_LA0 + 1]);
  f.lin[2] = make_lin(wm, wms, bm, ma, mb, gb, h1, out, dff, d, (ws_cols >> 2) & 1, MODE_RESID,
                      hdr[H_LA0 + 2]);
  f.ln_g = g2; f.ln_b = b2;
  for (int j = 0; j < 3; ++j) {
    const int rc = lin_maps(f, j, bank_bf16);
    if (rc) return rc;
  }
  return bank_bf16 ? launch<bf16>(f, hdr[H_NB], hdr[H_SMEM], stream)
                   : launch<float>(f, hdr[H_NB], hdr[H_SMEM], stream);
}
