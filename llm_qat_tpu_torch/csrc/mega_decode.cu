// Whole-model decode step, for sm_90a, in three attention variants.
//
// Replaces three Pallas kernels of llm_qat_tpu/ops/mega_decode.py:
//   `_mega_kernel_kv8` (per_slot=False) behind `mega_decode_step_kv8`:
//     int8 / int4 KV codes with row scales, one shared position (#1, entry
//     point mega_decode_step_kv);
//   `_mega_kernel_kv8` (per_slot=True) behind `mega_decode_step_cb`:
//     continuous batching, per-slot lengths over read-only main caches
//     plus a chunk-local recent buffer appended at a uniform rpos (#4,
//     entry point mega_decode_step_cb);
//   `_mega_kernel` behind `mega_decode_step`: a float32 or bf16
//     head-interleaved cache (#3, entry point mega_decode_step_f).
// The Python wrappers are in llm_qat_tpu_torch/ops/mega_decode.py, each
// with a plain PyTorch version beside it that computes the same function.
//
// Bound. One token per sequence streams every weight it uses once: at
// GPT-2 124M with int4 tiles that is 12 layers x 12 tiles x (384 x 768)
// bytes = 42.5 MB, plus the LoRA tiles the step reads (int8: A tiles 0, 3,
// 4, 8-11 and B tiles 0-7, 11, 9.4 MB; the zero-padded 12-tile layout holds
// 14.2 MB), the scales, biases and LN vectors of those tiles (0.8 MB), and
// the KV prefix (per layer, sequence and row: 2 x d/2 code bytes + 2 x 4
// scale bytes, 74.5 KB per position at B = 8). At B = 8 the step is a GEMV,
// far below the card's operations-per-byte line, so it is bound by
// device-memory bytes (3.35 TB/s on an H100 SXM): 64.8 MB, 19.3 us, at
// pos 160. The float-cache step reads 2 x d x 2 bytes per bf16 cache row
// instead (95.2 MB, 28.4 us, at B = 8 and pos 143); the per-slot step reads
// each slot's own main prefix plus its recent rows.
//
// One persistent cooperative kernel per step (k_mega, templated on the
// attention kind: codes, float32 or bf16 cache rows). The TPU kernel runs a
// sequential (layer, tile) grid, double-buffers the next tile's DMA under
// the current tile's compute and keeps the hidden state in VMEM. Here one
// launch of PT-thread blocks, as many as the card holds at once
// (cudaLaunchCooperativeKernel; a refused launch is an error, there is no
// fallback), lives for the whole step, and grid barriers (grid_sync: one
// counter in device memory, acquire / release, left as found after the
// step's even number of barriers, a trap after about 2^34 cycles) take the
// place of kernel boundaries. Per layer, each phase spread over the grid:
//   G_qkv  s8 x s8 -> s32 dots of the prepared activation codes with the
//          block's pieces of tiles 0-2 (int32 partial sums per piece), and
//          LoRA-A items (64 input rows x all r outputs, float partials) | barrier
//   E_qkv  epilogue in 32-column items: scale, bias, LoRA-B -> qkv rows | barrier
//   ATT    one (b, h) item per block: the cached prefix a pass of several
//          tbp-row blocks at a time (per-slot lengths for #4, then the
//          recent block), the new token merged in float32, the append at
//          the write target's row; codes (#1, #4): q and the new K/V row
//          quantized first; float rows (#3): q and the new K/V rounded to
//          the cache dtype                             | barrier
//   G_proj dots over the attention row, quantized as the pieces load it | barrier
//   R1     one batch row per block: proj epilogue, residual, LN2, the fc
//          prologue (codes and floats)                | barrier
//   G_fc   | barrier   E_fc: epilogue, A&S GELU, the mlp prologue | barrier
//   G_mlp  dots over all 4d (int32), LoRA-A items per d-wide chunk | barrier
//   R2     mlp epilogue, residual, the next layer's LN1 and qkv prologue
// (and one row phase before layer 0: h_in -> h_out, LN1): 9 barriers a
// layer, 108 a 12-layer step. The plan (ops/mega_decode.py::mega_plan,
// passed as an int32 table) fixes which block owns which pieces (a column
// group of CW = 128 columns x a range of byte rows) of each GEMV and which
// LoRA-A items (on blocks that hold no piece of that GEMV, where the grid
// has room); it is the same for every layer, so a block knows all the
// weight bytes it will read. Its warp 0 keeps NST = 8 stages of up to 64
// byte rows x 128 columns in flight (one 2-D TMA box a stage, completing
// on an mbarrier per stage): the next stages are requested as
// soon as a piece is done, so the next layer's slices stream in while the
// grid runs the attention and row phases, and a GEMV waits on its stage's
// mbarrier, not on device memory. The LoRA banks, per-tile vectors and the
// next layer's KV rows are asked into L2 one layer ahead
// (cp.async.bulk.prefetch.L2), each block its share. The int tiles keep the
// JAX per-tile K-halves layout: byte row k holds K rows k and k + d/2, so a
// chunk of byte rows takes two pieces of the activation row. A piece's
// int32 dot sums go to its own slot (plain stores; int32 atomics into one
// accumulator measured slower); the consumer of a column adds its group's
// slots in the plan's order. Every float sum runs in a fixed order (LoRA-A
// partials per item, summed in item order, the mlp's four d-wide chunks in
// turn as the TPU kernel does): two calls on the same inputs are
// bit-equal. Each phase issues its device-memory loads in groups (a
// chunk's LoRA-A partials, 8 partial-sum slots, a pass's cached rows)
// before it uses them, and copies operands that do not depend on the
// phase before (LoRA-B slices, LoRA-A bank rows, a pass's float V rows)
// with cp.async under the dependent loads: at B = 8 a phase is a few
// chains of dependent loads, and their count, not the bytes, sets its
// time. The float sums run in another order than the plain version's, so
// the two differ by float32 rounding, which can flip an activation code at
// a rounding boundary.
// Per slot, the TPU kernel streams every slot's main prefix up to the
// batch's longest and masks; here each (b, h) item stops at its own length,
// which gives the same result: a block that a row masks entirely adds
// exactly 0 once the row has a score, and before that its running max is
// -1e30, so the final correction exp(m - m_f) zeroes what it added.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

#define NEG_INF (-1e30f)
#define N_TILES 12
#define MAX_SLOTS 256   // batch rows of a per-slot step (lengths passed by value)

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ---------------------------------------------------------------------------
// numerics shared with the plain version
// ---------------------------------------------------------------------------

__device__ __forceinline__ float rt(float x, int act_bf16) {
  return act_bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// clamp(rne(x / s), -qmax, qmax)
__device__ __forceinline__ float q8f(float x, float s, float qmax) {
  return fminf(fmaxf(rintf(x / s), -qmax), qmax);
}

__device__ __forceinline__ float erf_as(float z) {
  float s = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  float za = fabsf(z);
  float t = 1.0f / (1.0f + 0.3275911f * za);
  float poly = ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t
                 - 0.284496736f) * t + 0.254829592f) * t;
  return s * (1.0f - poly * expf(-za * za));
}

__device__ __forceinline__ float gelu_as(float x) {
  return 0.5f * x * (1.0f + erf_as(x * 0.7071067811865476f));
}

// 4 signed nibbles (low / high half of each byte) -> 4 sign-extended bytes
__device__ __forceinline__ int sext_lo(uint32_t w) {
  uint32_t x = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  return static_cast<int>(__vsub4(x, 0x08080808u));
}
__device__ __forceinline__ int sext_hi(uint32_t w) {
  uint32_t x = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  return static_cast<int>(__vsub4(x, 0x08080808u));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reductions; `red` holds 33 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < nw ? red[lane] : 0.f;
    x = warp_sum(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  float r = red[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float rd(float x, int lora_round) {
  return lora_round ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

struct SlotLen {
  int v[MAX_SLOTS];
};

// float32 / bf16 cache elements (#3): to float, from float (round to
// nearest even), and a float32 value rounded to the cache dtype
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float in_cdt(float x) {
  return to_f(from_f<T>(x));
}

#define STEP_ARGS                                                                          \
  const float *h_in, float *h_out, const int8_t *wt, const float *ws, const float *bias,  \
      const void *at, const void *bt, const float *at_s, const float *bt_s,                 \
      const float *ln, const float *xs

// ---------------------------------------------------------------------------
// k_mega: the persistent step (see the comment at the top)
// ---------------------------------------------------------------------------

#define PT 256                  // threads of a block
#define PWARPS (PT / 32)
#define CW 128                  // columns of a GEMV piece: 32 lanes x 4
#define CH_ROWS 64              // weight byte rows of a ring stage
#define NST 8                   // ring stages
#define STAGE_BYTES (CH_ROWS * CW)
#define BP 32                   // batch rows of one GEMV pass (4 per warp)
#define EB 8                    // batch rows of one LoRA-A / epilogue pass
#define E_COLS 32               // columns of an epilogue item
#define MAX_D 4096              // row floats a row phase holds
#define MAX_R 256               // LoRA rank
#define SLOT_LOADS 8            // partial-sum slots a thread loads at once
#define LA_LOADS 12             // LoRA-A partials a thread loads at once
#define MAX_LAYERS 64           // layers whose scalars a block keeps in shared memory
#define GS_MAX (4 * (4 * MAX_D / CW + 1))  // the group slot tables of the 4 GEMVs
#define WORK_BYTES (128 * 1024) // the phases' work area
#define MAX_BP 512              // pieces of one block (all GEMVs of a layer)
#define MAX_BI 512              // LoRA-A items of one block
#define MAX_HD 128              // head_dim of a float-cache attention item
#define ATT_FIXED 8192          // its arrays before the staged V rows (bytes)
// attention kinds, k_mega's template argument: KV codes with row scales
// (#1, #4), float32 or bf16 cache rows (#3)
#define AK_CODES 0
#define AK_F32 1
#define AK_BF16 2
// the plan table (ops/mega_decode.py::mega_plan): a header, then per GEMV
// the blocks' offsets into the piece list and into the LoRA-A item list,
// then the pieces (column group, first byte row, end byte row, partial-sum
// slot), the items (index t: input rows [t * la_rows, (t + 1) * la_rows))
// and per GEMV each column group's first slot
#define P_LA_ROWS 1  // (entry 0: the block count the plan was made for)
#define P_PIECES 2
#define P_LAS 3
#define P_GSLOTS 8   // 4 offsets: GEMV j's group slot starts
#define P_HDR 16

struct Mega {
  CUtensorMap wmap;  // the weight tiles (L x 12 x dk rows of d bytes), boxes of 64 x CW
  const float* h_in; float* h_out; const int8_t* wt; const float* ws; const float* bias;
  const void* at; const void* bt; const float* at_s; const float* bt_s; const float* ln;
  const float* xs;
  // scratch: activation codes and floats of the current GEMV input (B, 4d),
  // the int32 partial sums (slots, B, CW), LoRA-A partials (items, B, r),
  // the qkv rows (B, 3d), the attention rows (B, d), the grid barrier's
  // counter, the plan
  int8_t* qx; float* xf; int32_t* part; float* la; float* qkv; float* attn; unsigned* bar;
  const int* plan;
  // caches: main codes (L, B, T, dc) + (L, B, T) scales, or float rows
  // (L, B, T, d) of the cache dtype and no scales (#3, kv_bits 16); #4's
  // recent buffer (L, B, Tr, dc) + (L, B, Tr), or null
  void* kc; void* vc; float* ksc; float* vsc;
  int8_t* kr; int8_t* vr; float* ksr; float* vsr;
  int T, Tr, pos, rpos, tbp, kv_bits;  // the write target: main at pos (#1, #3), recent at rpos (#4)
  int att_blocks;  // #3: JAX blocks of one attention pass (ops/mega_decode.py::attn_pass_blocks)
  int L, B, d, H, r, wbits, has_lora, lora_dt, act_bf16, lora_round;
  float eps, aq_max, sm_scale;
  SlotLen lens;  // main rows each batch row reads
  // instrumentation, or null: per barrier k and block i, the global timer
  // (ns) at arrival clk[(2k) nb + i] and at release clk[(2k + 1) nb + i]
  unsigned long long* clk;
};

// What every phase reads again and again, kept in shared memory for the
// whole step: every layer's activation scales and LoRA tile scales, and the
// plan's LoRA-A item size and column-group slot tables.
struct alignas(16) Consts {
  float xs[MAX_LAYERS * 4];
  float at_s[MAX_LAYERS * N_TILES];
  float bt_s[MAX_LAYERS * N_TILES];
  int la_rows;
  int gs_off[4];   // GEMV j's group slot starts at gs[gs_off[j]]
  int gs[GS_MAX];
  // this block's pieces of GEMV j: entries [p_lo[j], p_lo[j + 1]) of pieces
  // (column group, first byte row, end byte row, slot); its LoRA-A items:
  // [q_lo[j], q_lo[j + 1]) of items
  int p_lo[5], q_lo[5];
  int pieces[MAX_BP * 4];
  int items[MAX_BI];
};

// GEMV j: 0 qkv (tiles 0-2 out), 1 proj (tile 3), 2 fc (tiles 4-7 out),
// 3 mlp (tiles 8-11 in)
__device__ __forceinline__ int gemv_tile0(int j) { return j == 0 ? 0 : (j == 1 ? 3 : (j == 2 ? 4 : 8)); }
__device__ __forceinline__ int gemv_cols(int j, int d) { return j == 0 ? 3 * d : (j == 2 ? 4 * d : d); }
__device__ __forceinline__ int gemv_nin(int j) { return j == 3 ? 4 : 1; }

__device__ __forceinline__ int piece_off(const int* plan, int nb, int j, int i) {
  return plan[P_HDR + j * (nb + 1) + i];
}
__device__ __forceinline__ int la_off(const int* plan, int nb, int j, int i) {
  return plan[P_HDR + (4 + j) * (nb + 1) + i];
}

// Layer l's LoRA banks, per-tile vectors and KV rows into L2, this block's
// share (range i of the list goes to block i % nb), asked by its thread 0.
template <int AK>
__device__ void prefetch_layer(const Mega& a, int l, int nb) {
  if (threadIdx.x != 0) return;
  const int d = a.d, B = a.B, r = a.r;
  const int dc = a.kv_bits == 8 ? d : d / 2;
  const size_t esz = a.lora_dt == 0 ? 4 : (a.lora_dt == 1 ? 2 : 1);
  const size_t bank = (size_t)N_TILES * d * r * esz;
  const int nfix = 4, per_b = AK != AK_CODES ? 2 : (a.kr ? 8 : 4);
  const int n = nfix + per_b * B;
  for (int i = blockIdx.x; i < n; i += nb) {
    if (i < nfix) {
      if (i == 0 && a.has_lora) l2_prefetch(static_cast<const char*>(a.at) + l * bank, bank);
      if (i == 1 && a.has_lora) l2_prefetch(static_cast<const char*>(a.bt) + l * bank, bank);
      if (i == 2) l2_prefetch(a.ws + (size_t)l * N_TILES * d, sizeof(float) * N_TILES * d);
      if (i == 3) l2_prefetch(a.bias + (size_t)l * N_TILES * d, sizeof(float) * N_TILES * d);
      continue;
    }
    const int b = (i - nfix) / per_b, w = (i - nfix) % per_b;
    if constexpr (AK != AK_CODES) {  // float rows [0, pos) of K (w 0) or V (w 1)
      const size_t row_bytes = (size_t)d * (AK == AK_F32 ? 4 : 2);
      l2_prefetch(static_cast<const char*>(w ? a.vc : a.kc) + ((size_t)l * B + b) * a.T * row_bytes,
                  (size_t)a.lens.v[b] * row_bytes);
      continue;
    }
    const bool rec = w >= 4;
    const int rows = rec ? a.rpos : a.lens.v[b];
    const int Tn = rec ? a.Tr : a.T;
    const size_t row0 = ((size_t)l * B + b) * Tn;
    const int wk = w % 4;
    if (wk < 2) {
      const int8_t* base = rec ? (wk ? a.vr : a.kr) : static_cast<const int8_t*>(wk ? a.vc : a.kc);
      l2_prefetch(base + row0 * dc, (size_t)rows * dc);
    } else {
      const float* base = rec ? (wk == 3 ? a.vsr : a.ksr) : (wk == 3 ? a.vsc : a.ksc);
      l2_prefetch(base + row0, sizeof(float) * rows);
    }
  }
}

// ---- the weight ring ------------------------------------------------------

// The next chunk this block streams: layer l, GEMV j, piece p (absolute
// index into the plan's piece list), chunk c of the piece. Kept by warp 0.
struct WIter {
  int l, j, p, c;
};

__device__ __forceinline__ void wit_norm(const Mega& a, const Consts& cs, WIter& it) {
  while (it.l < a.L) {
    if (it.p < cs.p_lo[it.j + 1]) {
      const int* pc = cs.pieces + 4 * it.p;
      if (it.c * CH_ROWS < pc[2] - pc[1]) return;
      ++it.p;
      it.c = 0;
      continue;
    }
    it.c = 0;
    if (++it.j == 4) {
      it.j = 0;
      ++it.l;
    }
    it.p = cs.p_lo[it.j];
  }
}

// Warp 0: request the next chunk into the next stage (if the step has one).
__device__ void ring_issue(const Mega& a, const Consts& cs, uint8_t* ring, uint32_t mbar0,
                           WIter& it, int& issued, int dk) {
  const int lane = threadIdx.x & 31;
  wit_norm(a, cs, it);
  if (it.l >= a.L) return;
  const int* pc = cs.pieces + 4 * it.p;
  const int r0 = pc[1] + it.c * CH_ROWS;
  const int nr = min(CH_ROWS, pc[2] - r0);
  const int stage = issued % NST;
  const uint32_t bar = mbar0 + 8 * stage;
  if (lane == 0) {
    // one box of CH_ROWS rows (rows past the piece are loaded and unused)
    const int g = pc[0], d = a.d;
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load(smem_u32(ring + (size_t)stage * STAGE_BYTES), &a.wmap, (g * CW) % d,
             (it.l * N_TILES + gemv_tile0(it.j) + (g * CW) / d) * dk + r0, bar);
  }
  ++issued;
  ++it.c;
}

// ---- phases ---------------------------------------------------------------

// Layer lp's LayerNorm (pair ln_i) of xrow (d floats in shared memory),
// then the prologue of the next GEMV: codes qx[b] (static scale xs_i) and
// floats xf[b], row stride d.
__device__ void row_ln_prep(const Mega& a, const Consts& cs, float* xrow, float* red, int b,
                            int lp, int ln_i, int xs_i) {
  const int d = a.d, tid = threadIdx.x;
  float s = 0.f;
  for (int k = tid; k < d; k += PT) s += xrow[k];
  const float mean = block_sum(s, red) / (float)d;
  float v = 0.f;
  for (int k = tid; k < d; k += PT) {
    const float dx = xrow[k] - mean;
    v += dx * dx;
  }
  const float var = block_sum(v, red) / (float)d;
  const float rstd = 1.0f / sqrtf(var + a.eps);
  const float* g = a.ln + ((size_t)lp * 4 + ln_i) * d;
  const float* bb = g + d;
  const float pxs = cs.xs[lp * 4 + xs_i];
  for (int k = tid; k < d; k += PT) {
    const float x = rt(g[k] * (xrow[k] - mean) * rstd + bb[k], a.act_bf16);
    a.qx[(size_t)b * d + k] = (int8_t)q8f(x, pxs, a.aq_max);
    a.xf[(size_t)b * d + k] = x;
  }
}

// LoRA-B of 4 adjacent columns: sum_j xa[j] * rd(B[j][jj]) for the bank
// row j at btl + j * ld elements (type DT; device or shared memory); xa
// already rounded. The bank words of U ranks are loaded before any is used.
template <int DT>
__device__ __forceinline__ void lora_b4(const void* btl, int r, size_t ld, const float* xa,
                                        int lr, float o[4]) {
  constexpr int U = DT == 0 ? 4 : 8;  // 8 to 16 registers of bank words
  using W = typename std::conditional<DT == 0, float4, typename std::conditional<DT == 1, uint2, int>::type>::type;
  using E = typename std::conditional<DT == 0, float, typename std::conditional<DT == 1, __nv_bfloat16, int8_t>::type>::type;
  const E* base = static_cast<const E*>(btl);
  o[0] = o[1] = o[2] = o[3] = 0.f;
  for (int j0 = 0; j0 < r; j0 += U) {
    W v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j0 + u < r) v[u] = *reinterpret_cast<const W*>(base + (size_t)(j0 + u) * ld);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < r) {
        float w[4];
        if constexpr (DT == 0) {
          w[0] = v[u].x; w[1] = v[u].y; w[2] = v[u].z; w[3] = v[u].w;
        } else if constexpr (DT == 1) {
          const __nv_bfloat162 p0 = *reinterpret_cast<const __nv_bfloat162*>(&v[u].x);
          const __nv_bfloat162 p1 = *reinterpret_cast<const __nv_bfloat162*>(&v[u].y);
          w[0] = __low2float(p0); w[1] = __high2float(p0); w[2] = __low2float(p1); w[3] = __high2float(p1);
        } else {
          w[0] = (float)(int8_t)(v[u] & 0xFF); w[1] = (float)(int8_t)((v[u] >> 8) & 0xFF);
          w[2] = (float)(int8_t)((v[u] >> 16) & 0xFF); w[3] = (float)(int8_t)(v[u] >> 24);
        }
        const float x = xa[j0 + u];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) o[jj] += x * rd(w[jj], lr);
      }
    }
  }
}

__device__ __forceinline__ void lora_b4_dt(const Mega& a, const void* btl, int r, size_t ld,
                                           const float* xa, float o[4]) {
  if (a.lora_dt == 0) lora_b4<0>(btl, r, ld, xa, a.lora_round, o);
  else if (a.lora_dt == 1) lora_b4<1>(btl, r, ld, xa, a.lora_round, o);
  else lora_b4<2>(btl, r, ld, xa, a.lora_round, o);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Columns [c0, c0 + ncol) of rows [0, r) of a LoRA-B bank tile into shared
// memory at dst (rows of ncol elements), asynchronously: 16-byte copies
// (cp.async), waited for by cp_async_wait and a block barrier.
__device__ __forceinline__ void stage_bank(const Mega& a, const void* btl, int c0, int ncol,
                                           void* dst) {
  const int esz = a.lora_dt == 0 ? 4 : (a.lora_dt == 1 ? 2 : 1);
  const int per_row = ncol * esz / 16;
  const char* src = static_cast<const char*>(btl) + (size_t)c0 * esz;
  for (int i = threadIdx.x; i < a.r * per_row; i += PT) {
    const int j = i / per_row, k = i % per_row;
    cp_async16(static_cast<char*>(dst) + (size_t)i * 16,
               src + (size_t)j * a.d * esz + (size_t)k * 16);
  }
}

__device__ __forceinline__ const void* bank_tile(const Mega& a, const void* bank, int l, int tile) {
  const size_t esz = a.lora_dt == 0 ? 4 : (a.lora_dt == 1 ? 2 : 1);
  return static_cast<const char*>(bank) + ((size_t)l * N_TILES + tile) * a.d * a.r * esz;
}

// xa[bi][j] = rd(LoRA-A of row b0 + bi through GEMV j's tile(s)): the items'
// partial sums in item order, times the tile scale; the mlp's four d-wide
// chunks (12 items each at d = 768) summed in turn, as the TPU kernel does.
// A thread loads LA_LOADS items of an output before it adds them.
__device__ void lora_a_reduce(const Mega& a, const Consts& cs, int l, int j, int b0, int nbp,
                              float* xa) {
  const int r = a.r, per_chunk = a.d / cs.la_rows, nch = gemv_nin(j);
  const size_t stride = (size_t)a.B * r;  // from one item's partials to the next
  const float* ats = cs.at_s + l * N_TILES + gemv_tile0(j);
  if (nch == 4 && nbp * r * 4 <= PT) {
    // the mlp's chunks on 4 adjacent lanes, joined in chunk order
    const int o = threadIdx.x / 4, ch = threadIdx.x % 4;
    float tv = 0.f;
    if (o < nbp * r) {
      const float* base = a.la + (size_t)(b0 + o / r) * r + o % r;
      float sum = 0.f;
      for (int t0 = ch * per_chunk; t0 < (ch + 1) * per_chunk; t0 += LA_LOADS) {
        float v[LA_LOADS];
#pragma unroll
        for (int u = 0; u < LA_LOADS; ++u)
          v[u] = t0 + u < (ch + 1) * per_chunk ? __ldcg(base + (size_t)(t0 + u) * stride) : 0.f;
#pragma unroll
        for (int u = 0; u < LA_LOADS; ++u)
          if (t0 + u < (ch + 1) * per_chunk) sum += v[u];
      }
      tv = sum * ats[ch];
    }
    const int lane0 = threadIdx.x & ~3 & 31;
    const float t1 = __shfl_sync(0xffffffffu, tv, lane0 + 1);
    const float t2 = __shfl_sync(0xffffffffu, tv, lane0 + 2);
    const float t3 = __shfl_sync(0xffffffffu, tv, lane0 + 3);
    if (ch == 0 && o < nbp * r) xa[o] = rd(((tv + t1) + t2) + t3, a.lora_round);
    return;
  }
  for (int o = threadIdx.x; o < nbp * r; o += PT) {
    const float* base = a.la + (size_t)(b0 + o / r) * r + o % r;
    float x = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int t1 = (ch + 1) * per_chunk;
      float sum = 0.f;
      for (int t0 = ch * per_chunk; t0 < t1; t0 += LA_LOADS) {
        float v[LA_LOADS];
#pragma unroll
        for (int u = 0; u < LA_LOADS; ++u)
          v[u] = t0 + u < t1 ? __ldcg(base + (size_t)(t0 + u) * stride) : 0.f;
#pragma unroll
        for (int u = 0; u < LA_LOADS; ++u)
          if (t0 + u < t1) sum += v[u];
      }
      const float tv = sum * ats[ch];
      x = ch == 0 ? tv : x + tv;
    }
    xa[o] = rd(x, a.lora_round);
  }
}

// The epilogue value of column n of GEMV j for batch row b: the int32
// partial sums of the column's group, slot by slot in the plan's order
// (SLOT_LOADS loaded at once), then scale, bias and the LoRA-B sums lora_o
// (with LoRA), for 4 adjacent columns n..n+3 of one tile.
__device__ __forceinline__ void epi4(const Mega& a, const Consts& cs, int l, int j, int b, int n,
                                     const float* lora_o, float y[4]) {
  const int d = a.d;
  const int tile = j == 3 ? 11 : gemv_tile0(j) + n / d, c = n % d;
  const int* gs = cs.gs + cs.gs_off[j];
  const int s0 = gs[n / CW], s1 = gs[n / CW + 1];
  const float4 wsv = __ldg(reinterpret_cast<const float4*>(a.ws + ((size_t)l * N_TILES + tile) * d + c));
  const float4 bsv = __ldg(reinterpret_cast<const float4*>(a.bias + ((size_t)l * N_TILES + tile) * d + c));
  int qa[4] = {0, 0, 0, 0};
  for (int s = s0; s < s1; s += SLOT_LOADS) {
    int4 v[SLOT_LOADS];
#pragma unroll
    for (int u = 0; u < SLOT_LOADS; ++u)
      if (s + u < s1)
        v[u] = __ldcg(reinterpret_cast<const int4*>(a.part + ((size_t)(s + u) * a.B + b) * CW + n % CW));
#pragma unroll
    for (int u = 0; u < SLOT_LOADS; ++u)
      if (s + u < s1) {
        qa[0] += v[u].x; qa[1] += v[u].y; qa[2] += v[u].z; qa[3] += v[u].w;
      }
  }
  const float xsv = cs.xs[l * 4 + j];
  const float wsr[4] = {wsv.x, wsv.y, wsv.z, wsv.w}, bsr[4] = {bsv.x, bsv.y, bsv.z, bsv.w};
  const float bts = cs.bt_s[l * N_TILES + tile];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    float v = (float)qa[jj] * (xsv * wsr[jj]) + bsr[jj];
    if (a.has_lora) v = v + lora_o[jj] * bts;
    y[jj] = v;
  }
}

// E phase of GEMV j (0 qkv, 2 fc): items of E_COLS columns x every batch
// row; qkv stores the float rows, fc applies the A&S GELU and writes the
// mlp prologue (codes with xs[3], floats), row stride 4d.
__device__ void phase_epilogue(const Mega& a, const Consts& cs, int l, int j, int nb,
                               float* work) {
  const int d = a.d, B = a.B, ncols = gemv_cols(j, d);
  const int n_items = ncols / E_COLS;
  if ((int)blockIdx.x >= n_items) return;
  const int esz = a.lora_dt == 0 ? 4 : (a.lora_dt == 1 ? 2 : 1);
  float* xa = work;                                  // EB x r
  char* lb = reinterpret_cast<char*>(xa + EB * MAX_R);  // r x E_COLS bank elements
  for (int b0 = 0; b0 < B; b0 += EB) {
    const int nbp = min(EB, B - b0);
    for (int e = blockIdx.x; e < n_items; e += nb) {
      const int tile = gemv_tile0(j) + e * E_COLS / d, c0 = e * E_COLS % d;
      // the item's LoRA-B slice streams in while the LoRA-A partials are added
      if (a.has_lora) stage_bank(a, bank_tile(a, a.bt, l, tile), c0, E_COLS, lb);
      if (a.has_lora && e == (int)blockIdx.x) lora_a_reduce(a, cs, l, j, b0, nbp, xa);
      cp_async_wait();
      __syncthreads();
      // (batch row, 4 columns, rank group): the LoRA-B ranks of an output
      // split over RG adjacent lanes, their sums added by shuffles in a
      // fixed order
      constexpr int RG = 4;
      const int nq = E_COLS / 4, rpg = (a.r + RG - 1) / RG;
      const int nout = nbp * nq * RG;  // a multiple of 32
      for (int o = threadIdx.x; o < nout; o += PT) {
        const int g = o % RG, q = (o / RG) % nq, bi = o / (RG * nq);
        const int cc = 4 * q, n = e * E_COLS + cc, b = b0 + bi;
        float lo4[4] = {0.f, 0.f, 0.f, 0.f};
        const int j0 = g * rpg, nr = max(0, min(a.r, j0 + rpg) - j0);
        if (a.has_lora && nr > 0)
          lora_b4_dt(a, lb + (size_t)(cc + j0 * E_COLS) * esz, nr, E_COLS, xa + bi * a.r + j0, lo4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          lo4[jj] += __shfl_xor_sync(0xffffffffu, lo4[jj], 1);
          lo4[jj] += __shfl_xor_sync(0xffffffffu, lo4[jj], 2);
        }
        if (g != 0) continue;
        float y[4];
        epi4(a, cs, l, j, b, n, lo4, y);
        if (j == 0) {
          *reinterpret_cast<float4*>(a.qkv + (size_t)b * ncols + n) = make_float4(y[0], y[1], y[2], y[3]);
        } else {
          const float gxs = cs.xs[l * 4 + 3];
          float g[4];
          int8_t qc[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            g[jj] = rt(gelu_as(y[jj]), a.act_bf16);
            qc[jj] = (int8_t)q8f(g[jj], gxs, a.aq_max);
          }
          *reinterpret_cast<float4*>(a.xf + (size_t)b * ncols + n) = make_float4(g[0], g[1], g[2], g[3]);
          *reinterpret_cast<char4*>(a.qx + (size_t)b * ncols + n) = make_char4(qc[0], qc[1], qc[2], qc[3]);
        }
      }
      __syncthreads();
    }
  }
}

// R phase after GEMV j (1 proj, 3 mlp): one batch row per block: epilogue,
// residual into h_out, then LN2 and the fc prologue (after proj) or the next
// layer's LN1 and qkv prologue (after mlp, if there is a next layer).
__device__ void phase_row(const Mega& a, const Consts& cs, int l, int j, int nb, float* work) {
  const int d = a.d;
  const int tile = j == 3 ? 11 : gemv_tile0(j);
  const int esz = a.lora_dt == 0 ? 4 : (a.lora_dt == 1 ? 2 : 1);
  float* red = work;           // 33
  float* xa = red + 64;        // r
  float* xrow = xa + MAX_R;    // d
  float* lbo = xrow + MAX_D;   // d: the LoRA-B sums of the row
  char* lb = reinterpret_cast<char*>(lbo + MAX_D);  // the LoRA-B tile, r x d, if it fits
  const void* btl = bank_tile(a, a.bt, l, tile);
  const bool staged = (size_t)a.r * d * esz <= WORK_BYTES - sizeof(float) * (64 + MAX_R + 2 * MAX_D);
  for (int b = blockIdx.x; b < a.B; b += nb) {
    if (a.has_lora && staged) stage_bank(a, btl, 0, d, lb);
    if (a.has_lora) lora_a_reduce(a, cs, l, j, b, 1, xa);
    cp_async_wait();
    __syncthreads();
    // LoRA-B of the row: (4 columns, rank group) pairs over every thread,
    // the groups' sums added by shuffles in a fixed order
    if (a.has_lora) {
      constexpr int RG = 4;
      const int rpg = (a.r + RG - 1) / RG;
      for (int o = threadIdx.x; o < d / 4 * RG; o += PT) {  // d / 4 * RG: a multiple of 32
        const int g = o % RG, n = 4 * (o / RG), j0 = g * rpg;
        const int nr = max(0, min(a.r, j0 + rpg) - j0);
        float lo4[4] = {0.f, 0.f, 0.f, 0.f};
        const char* src = staged ? lb : static_cast<const char*>(btl);
        if (nr > 0) lora_b4_dt(a, src + ((size_t)j0 * d + n) * esz, nr, d, xa + j0, lo4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          lo4[jj] += __shfl_xor_sync(0xffffffffu, lo4[jj], 1);
          lo4[jj] += __shfl_xor_sync(0xffffffffu, lo4[jj], 2);
        }
        if (g == 0) *reinterpret_cast<float4*>(lbo + n) = make_float4(lo4[0], lo4[1], lo4[2], lo4[3]);
      }
      __syncthreads();
    }
    for (int n = 4 * threadIdx.x; n < d; n += 4 * PT) {
      float y[4];
      epi4(a, cs, l, j, b, n, lbo + n, y);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float* hp = a.h_out + (size_t)b * d + n + jj;
        const float hv = rt(*hp + rt(y[jj], a.act_bf16), a.act_bf16);
        *hp = hv;
        xrow[n + jj] = hv;
      }
    }
    __syncthreads();
    if (j == 1) row_ln_prep(a, cs, xrow, red, b, l, 2, 2);
    else if (l + 1 < a.L) row_ln_prep(a, cs, xrow, red, b, l + 1, 0, 0);
    __syncthreads();
  }
}

// Before layer 0: h_out = h_in, LN1, the qkv prologue.
__device__ void phase_first(const Mega& a, const Consts& cs, int nb, float* work) {
  const int d = a.d;
  float* red = work;
  float* xrow = red + 64 + MAX_R;
  for (int b = blockIdx.x; b < a.B; b += nb) {
    for (int k = threadIdx.x; k < d; k += PT) {
      const float v = a.h_in[(size_t)b * d + k];
      a.h_out[(size_t)b * d + k] = v;
      xrow[k] = v;
    }
    __syncthreads();
    row_ln_prep(a, cs, xrow, red, b, 0, 0, 0);
    __syncthreads();
  }
}

// LoRA-A item t of GEMV j: partial sums over input rows [k0, k0 + la_rows)
// of every batch row and every output j', into la[t]. The item's bank rows
// (contiguous: la_rows x r elements) and input rows are staged in shared
// memory with one round of loads.
__device__ void lora_a_item(const Mega& a, const Consts& cs, int l, int j, int t, float* work) {
  const int d = a.d, B = a.B, r = a.r, la_rows = cs.la_rows;
  const int K = gemv_nin(j) * d, k0 = t * la_rows;
  const int tile = gemv_tile0(j) + k0 / d, kt0 = k0 % d;  // tile and row of the bank
  const float* src = j == 1 ? a.attn : a.xf;
  const int jn = r, kg = PT / jn, tid = threadIdx.x;
  const int jj = tid % jn, kgi = tid / jn;
  const size_t esz = a.lora_dt == 0 ? 4 : (a.lora_dt == 1 ? 2 : 1);
  const int nbytes = (int)(la_rows * r * esz);            // a multiple of 16
  uint8_t* bank_s = reinterpret_cast<uint8_t*>(work);     // la_rows x r elements
  float* xs_s = reinterpret_cast<float*>(bank_s + nbytes);  // EB x la_rows
  float* part = xs_s + EB * la_rows;                       // kg x EB x r
  const uint4* bsrc = reinterpret_cast<const uint4*>(
      static_cast<const char*>(bank_tile(a, a.at, l, tile)) + (size_t)kt0 * r * esz);
  for (int i = tid; i < nbytes / 16; i += PT) reinterpret_cast<uint4*>(bank_s)[i] = __ldg(bsrc + i);
  for (int b0 = 0; b0 < B; b0 += EB) {
    const int nbp = min(EB, B - b0);
    for (int o = tid; o < nbp * la_rows; o += PT) {
      const int bi = o / la_rows, k = o % la_rows;
      xs_s[o] = rd(__ldcg(src + (size_t)(b0 + bi) * K + k0 + k), a.lora_round);
    }
    __syncthreads();
    if (kgi < kg) {
      float acc[EB];
#pragma unroll
      for (int bi = 0; bi < EB; ++bi) acc[bi] = 0.f;
      for (int k = kgi; k < la_rows; k += kg) {
        const size_t i = (size_t)k * r + jj;
        const float w = rd(a.lora_dt == 0 ? reinterpret_cast<const float*>(bank_s)[i]
                           : a.lora_dt == 1 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(bank_s)[i])
                                            : (float)reinterpret_cast<const int8_t*>(bank_s)[i],
                           a.lora_round);
#pragma unroll
        for (int bi = 0; bi < EB; ++bi)
          if (bi < nbp) acc[bi] += xs_s[bi * la_rows + k] * w;
      }
#pragma unroll
      for (int bi = 0; bi < EB; ++bi) part[(kgi * EB + bi) * r + jj] = acc[bi];
    }
    __syncthreads();
    for (int o = tid; o < nbp * r; o += PT) {
      const int bi = o / r, j2 = o % r;
      float s = 0.f;
      for (int q = 0; q < kg; ++q) s += part[(q * EB + bi) * r + j2];
      a.la[((size_t)t * B + b0 + bi) * r + j2] = s;
    }
    __syncthreads();
  }
}

// G phase of GEMV j: the block's pieces, chunk by chunk from the ring, then
// its LoRA-A items.
__device__ void phase_gemv(const Mega& a, const Consts& cs, int l, int j, int nb, uint8_t* ring,
                           uint32_t mbar0, WIter& it, int& issued, int& consumed, int dk,
                           float* work) {
  const int d = a.d, B = a.B, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = gemv_nin(j) * d, d2 = d / 2;
  const int8_t* act = reinterpret_cast<const int8_t*>(work);  // BP x 2 x CH_ROWS codes
  int8_t* act_w = reinterpret_cast<int8_t*>(work);
  const float pxs = cs.xs[l * 4 + j];
  for (int p = cs.p_lo[j]; p < cs.p_lo[j + 1]; ++p) {
    const int* pc = cs.pieces + 4 * p;
    const int g = pc[0], pr0 = pc[1], pr1 = pc[2], slot = pc[3];
    const int nch = (pr1 - pr0 + CH_ROWS - 1) / CH_ROWS;  // pieces of 2+ stages: B <= BP
    for (int b0 = 0; b0 < B; b0 += BP) {
      const int nbp = min(BP, B - b0);
      int acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0;
      for (int c = 0; c < nch; ++c) {
        const int r0 = pr0 + c * CH_ROWS, nr = min(CH_ROWS, pr1 - r0), ti0 = r0 / dk;
        const int stage = (consumed + c) % NST;
        const uint8_t* st = ring + (size_t)stage * STAGE_BYTES;
        // the activation codes of these byte rows: K row rr (int8), or K rows
        // k and k + d/2 of the byte row's tile (int4, lo half then hi half)
        const int halves = a.wbits == 4 ? 2 : 1;
        for (int o = tid; o < nbp * halves * nr; o += PT) {
          const int bi = o / (halves * nr), rem = o % (halves * nr);
          const int hh = rem / nr, rr = r0 + rem % nr;
          int kk = rr;  // int4: tile ti = rr / dk (a stage crosses at most one tile edge)
          if (a.wbits == 4) {
            const int ti = ti0 + (rr >= (ti0 + 1) * dk);
            kk = ti * d + rr - ti * dk + hh * d2;
          }
          const int b = b0 + bi;
          int8_t cv;
          if (j == 1) cv = (int8_t)q8f(__ldcg(a.attn + (size_t)b * d + kk), pxs, a.aq_max);
          else cv = __ldcg(a.qx + (size_t)b * K + kk);
          act_w[bi * 2 * CH_ROWS + hh * CH_ROWS + rem % nr] = cv;
        }
        if (b0 == 0) mbar_wait(mbar0 + 8 * stage, ((consumed + c) / NST) & 1);
        __syncthreads();
        for (int s = 0; s < nr / 4; ++s) {
          const uint8_t* base = st + (4 * s) * CW + lane * 4;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(base);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(base + CW);
          const uint32_t w2 = *reinterpret_cast<const uint32_t*>(base + 2 * CW);
          const uint32_t w3 = *reinterpret_cast<const uint32_t*>(base + 3 * CW);
          const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
          const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
          const uint32_t cw[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                                  __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
          if (a.wbits == 4) {
            int lo[4], hi[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) { lo[jj] = sext_lo(cw[jj]); hi[jj] = sext_hi(cw[jj]); }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int bi = warp + PWARPS * i;
              if (bi < nbp) {
                const int alo = *reinterpret_cast<const int*>(act + bi * 2 * CH_ROWS + 4 * s);
                const int ahi = *reinterpret_cast<const int*>(act + bi * 2 * CH_ROWS + CH_ROWS + 4 * s);
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                  acc[i][jj] = __dp4a(alo, lo[jj], acc[i][jj]);
                  acc[i][jj] = __dp4a(ahi, hi[jj], acc[i][jj]);
                }
              }
            }
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int bi = warp + PWARPS * i;
              if (bi < nbp) {
                const int av = *reinterpret_cast<const int*>(act + bi * 2 * CH_ROWS + 4 * s);
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                  acc[i][jj] = __dp4a(av, static_cast<int>(cw[jj]), acc[i][jj]);
              }
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int bi = warp + PWARPS * i;
        if (bi < nbp)
          *reinterpret_cast<int4*>(a.part + ((size_t)slot * B + b0 + bi) * CW + lane * 4) =
              make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    if (warp == 0)
      for (int c = 0; c < nch; ++c) ring_issue(a, cs, ring, mbar0, it, issued, dk);
    consumed += nch;
  }
  if (a.has_lora) {
    for (int q = cs.q_lo[j]; q < cs.q_lo[j + 1]; ++q) lora_a_item(a, cs, l, j, cs.items[q], work);
  }
}

// One (b, h) item of layer l's attention. The prologue as the TPU kernel:
// q * sm_scale quantized per (b, h) row, the new K/V rows per row (absmax
// over all d lanes, from the qkv rows; one block reduction for the three
// maxima). Then the cached rows, a pass of up to 8 JAX blocks of tbp rows
// (PT rows) at a time, one row a thread: its K and V codes (every load of
// the pass in flight at once), its s8 score in registers; each block's max
// by one warp, and the running max at each block as the prefix max over
// the blocks before it (as the plain version's cummax), so every block of
// the pass computes its probabilities at the same maximum as a sequential
// walk would; each block's probability sum and max by one warp, the
// probabilities quantized per block after the per-row V scale is folded
// in, the s8 P.V sums per (block, lane) from the V codes staged in shared
// memory; then the blocks fold into (m, l, acc) in order, with the plain
// version's recurrence. Main prefix rows [0, lens[b]), then (#4) the recent
// block [0, rpos), in the last main pass where it fits. The new token
// merges in float32 from its dequantized codes, and the item appends the
// code bytes of its head.
__device__ void attn_item(const Mega& a, int l, int b, int h, float* work) {
  const int d = a.d, H = a.H, D = d / H, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d2 = d / 2, dc = a.kv_bits == 8 ? d : d2, tbp = a.tbp, DW = D / 4;
  const float kvq = a.kv_bits == 8 ? 127.f : 7.f;
  float* red = work;                                   // 64
  float* qf = red + 64;                                // D
  float* vn = qf + D;                                  // D
  float* s_p = vn + D;                                 // PT
  float* s_psc = s_p + PT;                             // PT
  float* bmax = s_psc + PT;                            // 8 block maxima, then running maxima
  float* bsum = bmax + 8;                              // 8
  float* bpm = bsum + 8;                               // 8
  int* s_pq = reinterpret_cast<int*>(bpm + 8);         // PT
  int* s_pv = s_pq + PT;                               // 8 x D
  int* s_v = s_pv + 8 * D;                             // PT x DW words of V codes
  int* qwords = s_v + PT * DW;                         // DW

  const float* qrow = a.qkv + (size_t)b * 3 * d;
  const float* krow = qrow + d;
  const float* vrow = qrow + 2 * d;
  const int bpp = min(8, PT / tbp);  // JAX blocks a pass
  const size_t lb = (size_t)l * a.B + b;
  // A row's codes as 16-byte loads where the head's lanes lie in one half
  // of a KV4 row and D is 16, 32 or 64.
  const int hoff = a.kv_bits == 8 ? h * D : (h * D < d2 ? h * D : h * D - d2);
  const bool khi = a.kv_bits == 4 && h * D >= d2;
  const bool vec = D % 16 == 0 && D <= 64 && (a.kv_bits == 8 || (h * D < d2) == ((h + 1) * D <= d2));
  // |q|, |k| and |v| maxima in one block reduction
  float qa = 0.f, ka = 0.f, va = 0.f;
  for (int i = tid; i < D; i += PT) {
    const float v = __ldcg(qrow + h * D + i) * a.sm_scale;
    qf[i] = v;
    qa = fmaxf(qa, fabsf(v));
  }
  for (int i = tid; i < d; i += PT) {
    ka = fmaxf(ka, fabsf(__ldcg(krow + i)));
    va = fmaxf(va, fabsf(__ldcg(vrow + i)));
  }
  qa = warp_max(qa);
  ka = warp_max(ka);
  va = warp_max(va);
  if (lane == 0) {
    red[warp] = qa;
    red[PWARPS + warp] = ka;
    red[2 * PWARPS + warp] = va;
  }
  __syncthreads();
  qa = ka = va = 0.f;
#pragma unroll
  for (int w = 0; w < PWARPS; ++w) {
    qa = fmaxf(qa, red[w]);
    ka = fmaxf(ka, red[PWARPS + w]);
    va = fmaxf(va, red[2 * PWARPS + w]);
  }
  const float qs = fmaxf(qa, 1e-8f) / 127.f;
  const float ks_new = fmaxf(ka, 1e-8f) / kvq;
  const float vs_new = fmaxf(va, 1e-8f) / kvq;
  __syncthreads();  // red is reused by block_sum
  float sn = 0.f;
  int8_t* qcode = reinterpret_cast<int8_t*>(qwords);
  for (int i = tid; i < D; i += PT) {
    qcode[i] = (int8_t)q8f(qf[i], qs, 127.f);
    const float kn = q8f(__ldcg(krow + h * D + i), ks_new, kvq) * ks_new;
    vn[i] = q8f(__ldcg(vrow + h * D + i), vs_new, kvq) * vs_new;
    sn += qf[i] * kn;
  }
  const float s_new = block_sum(sn, red);  // syncs: qwords / vn visible

  float m = NEG_INF, lsum = 0.f, accv[2] = {0.f, 0.f};  // lanes tid and tid + PT (D <= 2 PT)
  // the JAX blocks in order: the main prefix's, then (#4) the recent one,
  // which shares a pass with the last main blocks where it fits
  const int lim_m = a.lens.v[b], nblk_m = (lim_m + tbp - 1) / tbp;
  const int nvb = nblk_m + (a.kr && a.rpos > 0 ? 1 : 0);
  for (int v0 = 0; v0 < nvb; v0 += bpp) {
    const int nbk = min(bpp, nvb - v0);   // blocks of this pass
    const int vbk = v0 + tid / tbp;       // this thread's block
    const bool rec = vbk >= nblk_m;
    const int t = rec ? tid % tbp : vbk * tbp + tid % tbp;  // its row there
    const int lim = rec ? a.rpos : lim_m, Tn = rec ? a.Tr : a.T;
    const int8_t* kb = (rec ? a.kr : static_cast<const int8_t*>(a.kc)) + lb * Tn * dc;
    const int8_t* vb = (rec ? a.vr : static_cast<const int8_t*>(a.vc)) + lb * Tn * dc;
    const float* ksb = (rec ? a.ksr : a.ksc) + lb * Tn;
    const float* vsb = (rec ? a.vsr : a.vsc) + lb * Tn;
    const bool mine = tid < nbk * tbp, valid = mine && t < lim;
    float sc = NEG_INF, vsv = 0.f;
    if (valid && vec) {
      int4 kq[4], vq[4];
      const int4* kp = reinterpret_cast<const int4*>(kb + (size_t)t * dc + hoff);
      const int4* vp = reinterpret_cast<const int4*>(vb + (size_t)t * dc + hoff);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < DW / 4) {
          kq[i] = kp[i];
          vq[i] = vp[i];
        }
      const float ksv = ksb[t];
      vsv = vsb[t];
      int s32 = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < DW / 4) {
          const int kw4[4] = {kq[i].x, kq[i].y, kq[i].z, kq[i].w};
          const int vw4[4] = {vq[i].x, vq[i].y, vq[i].z, vq[i].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            int kc = kw4[u], vc = vw4[u];
            if (a.kv_bits == 4) {
              kc = khi ? sext_hi((uint32_t)kc) : sext_lo((uint32_t)kc);
              vc = khi ? sext_hi((uint32_t)vc) : sext_lo((uint32_t)vc);
            }
            s32 = __dp4a(qwords[4 * i + u], kc, s32);
            s_v[tid * DW + 4 * i + u] = vc;
          }
        }
      }
      sc = (float)s32 * qs * ksv;
    } else if (valid) {
      // the row's K words (lane w*4 .. w*4+3 of the head), scored at once
      const int8_t* kr = kb + (size_t)t * dc;
      const int8_t* vr = vb + (size_t)t * dc;
      int s32 = 0;
      for (int w0 = 0; w0 < DW; w0 += 16) {
        int kw[16], vw[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          if (w0 + u < DW) {
            const int L0 = h * D + 4 * (w0 + u);
            const int off = a.kv_bits == 8 ? L0 : (L0 < d2 ? L0 : L0 - d2);
            kw[u] = *reinterpret_cast<const int*>(kr + off);
            vw[u] = *reinterpret_cast<const int*>(vr + off);
          }
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          if (w0 + u < DW) {
            int kc = kw[u], vc = vw[u];
            if (a.kv_bits == 4) {
              const bool hi = h * D + 4 * (w0 + u) >= d2;
              kc = hi ? sext_hi((uint32_t)kc) : sext_lo((uint32_t)kc);
              vc = hi ? sext_hi((uint32_t)vc) : sext_lo((uint32_t)vc);
            }
            s32 = __dp4a(qwords[w0 + u], kc, s32);
            s_v[tid * DW + w0 + u] = vc;
          }
        }
      }
      sc = (float)s32 * qs * ksb[t];
      vsv = vsb[t];
    } else if (mine) {
      for (int w = 0; w < DW; ++w) s_v[tid * DW + w] = 0;
    }
    s_p[tid] = sc;
    __syncthreads();
    // each block's max (warp j of the pass), then the running maxima
    if (warp < nbk) {
      float mx = NEG_INF;
      for (int i = lane; i < tbp; i += 32) mx = fmaxf(mx, s_p[warp * tbp + i]);
      mx = warp_max(mx);
      if (lane == 0) bmax[warp] = mx;
    }
    __syncthreads();
    if (tid == 0) {
      float run = m;
      for (int jb = 0; jb < nbk; ++jb) {
        run = fmaxf(run, bmax[jb]);
        bmax[jb] = run;
      }
    }
    __syncthreads();
    if (mine) {
      const float p = expf(sc - bmax[tid / tbp]);
      s_p[tid] = p;
      s_psc[tid] = valid ? p * vsv : 0.f;
    }
    __syncthreads();
    if (warp < nbk) {
      float ps = 0.f, pm = 0.f;
      for (int i = lane; i < tbp; i += 32) {
        ps += s_p[warp * tbp + i];
        pm = fmaxf(pm, s_psc[warp * tbp + i]);
      }
      ps = warp_sum(ps);
      pm = warp_max(pm);
      if (lane == 0) {
        bsum[warp] = ps;
        bpm[warp] = fmaxf(pm, 1e-30f) / 127.f;
      }
    }
    __syncthreads();
    if (mine) s_pq[tid] = (int)q8f(s_psc[tid], bpm[tid / tbp], 127.f);
    __syncthreads();
    // P.V per (block, lane): the block's rows in order
    for (int o = tid; o < nbk * D; o += PT) {
      const int jb = o / D, i = o % D;
      const int8_t* vcol = reinterpret_cast<const int8_t*>(s_v) + i;
      int pv = 0;
      for (int r = jb * tbp; r < (jb + 1) * tbp; ++r) pv += s_pq[r] * (int)vcol[r * D];
      s_pv[jb * D + i] = pv;
    }
    __syncthreads();
    for (int jb = 0; jb < nbk; ++jb) {
      const float corr = expf(m - bmax[jb]);
      lsum = lsum * corr + bsum[jb];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (tid + q * PT < D)
          accv[q] = accv[q] * corr + (float)s_pv[jb * D + tid + q * PT] * bpm[jb];
      m = bmax[jb];
    }
    __syncthreads();  // the pass's shared arrays are reused by the next
  }

  const float m_f = fmaxf(m, s_new);
  const float corr = expf(m - m_f);
  const float p_new = expf(s_new - m_f);
  const float l_f = lsum * corr + p_new;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = tid + q * PT;
    if (i < D) {
      const float out = accv[q] * corr + p_new * vn[i];
      a.attn[(size_t)b * d + h * D + i] = rt(out / fmaxf(l_f, 1e-30f), a.act_bf16);
    }
  }
  // append: this item writes the code bytes [h*D, (h+1)*D) of [0, dc)
  int8_t* kwr;
  int8_t* vwr;
  float* ksw;
  float* vsw;
  if (a.kr) {
    const size_t row = lb * a.Tr + a.rpos;
    kwr = a.kr + row * dc; vwr = a.vr + row * dc; ksw = a.ksr + row; vsw = a.vsr + row;
  } else {
    const size_t row = lb * a.T + a.pos;
    kwr = static_cast<int8_t*>(a.kc) + row * dc; vwr = static_cast<int8_t*>(a.vc) + row * dc;
    ksw = a.ksc + row; vsw = a.vsc + row;
  }
  const int j1 = min((h + 1) * D, dc);
  for (int jb = h * D + tid; jb < j1; jb += PT) {
    if (a.kv_bits == 8) {
      kwr[jb] = (int8_t)q8f(__ldcg(krow + jb), ks_new, kvq);
      vwr[jb] = (int8_t)q8f(__ldcg(vrow + jb), vs_new, kvq);
    } else {
      const int klo = (int)q8f(__ldcg(krow + jb), ks_new, kvq);
      const int khi = (int)q8f(__ldcg(krow + jb + d2), ks_new, kvq);
      const int vlo = (int)q8f(__ldcg(vrow + jb), vs_new, kvq);
      const int vhi = (int)q8f(__ldcg(vrow + jb + d2), vs_new, kvq);
      kwr[jb] = (int8_t)((klo & 0xF) | (khi << 4));
      vwr[jb] = (int8_t)((vlo & 0xF) | (vhi << 4));
    }
  }
  if (h == 0 && tid == 0) {
    *ksw = ks_new;
    *vsw = vs_new;
  }
  __syncthreads();  // the work area is reused by the next item
}

// ---- the float-cache attention item (#3) ----------------------------------

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}
__device__ __forceinline__ uint32_t word_of(const uint2& v, int i) { return i == 0 ? v.x : v.y; }

// Element k of a 32-bit word of T values as float: a float32, or the low
// (k = 0) or high bf16 of a pair.
template <typename T>
__device__ __forceinline__ float elem_of(uint32_t w, int k) {
  if constexpr (std::is_same<T, float>::value) return __uint_as_float(w);
  else return __uint_as_float(k ? w & 0xFFFF0000u : w << 16);
}

template <int VW>
__device__ __forceinline__ void cp_async_vw(void* dst, const void* src) {
  if constexpr (VW == 16) {
    cp_async16(dst, src);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  }
}

// One (b, h) item of layer l's attention over float head-interleaved cache
// rows of type T (the JAX `_mega_kernel`'s attention, at its rounding
// points): q * sm_scale rounded to T for the scores, the new K row rounded
// to T for its own score against the unrounded q, the new V row rounded to
// T for the merge. The cached rows [0, pos) a pass of att_blocks JAX blocks
// of tbp rows at a time (one row a thread, the host's plan: the pass's V
// rows fit the work area): the thread's V lanes stream into shared memory
// by cp.async (VW bytes a copy: 16, or 8 where a bf16 head's lanes are not
// 16-byte aligned) while its K lanes load 128 bytes (32 registers) at a
// time and are dotted with q. Each block's max by one warp, the running
// maxima as prefix maxima of the block maxima (the plain version's
// cummax), p = exp(s - m) at the block's running max, its sum l over the
// unrounded p, P rounded to T before the float32 P.V sums per (block,
// lane), the blocks folded into (m, l, acc) in order with the plain
// version's recurrence. Then the new token merges in float32, the output
// is out / max(l, 1e-30) rounded at `_rt`, and the item appends its head's
// lanes [hD, (h+1)D) of row pos in T. With float32 rows every rounding is
// the identity.
template <typename T, int VW>
__device__ void attn_item_f(const Mega& a, int l, int b, int h, float* work) {
  using V = typename std::conditional<VW == 16, uint4, uint2>::type;
  constexpr int WPV = VW / 4;                      // 32-bit words a copy
  constexpr int EPW = 4 / (int)sizeof(T);          // elements a word
  constexpr int GL = 128 / VW;                     // K copies in flight at once
  const int d = a.d, D = d / a.H, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tbp = a.tbp, nv = D * (int)sizeof(T) / VW;  // copies of a head's row
  float* red = work;                               // 64
  float* qf = red + 64;                            // MAX_HD: q * sm_scale in T
  float* vn = qf + MAX_HD;                         // MAX_HD: the new V row in T
  float* s_p = vn + MAX_HD;                        // PT scores, then probabilities
  float* s_pr = s_p + PT;                          // PT probabilities rounded to T
  float* bmax = s_pr + PT;                         // 8 block maxima, then running maxima
  float* bsum = bmax + 8;                          // 8
  float* s_pv = bsum + 8;                          // 8 x MAX_HD P.V sums
  T* s_v = reinterpret_cast<T*>(reinterpret_cast<char*>(work) + ATT_FIXED);  // pass rows x D

  const float* qrow = a.qkv + (size_t)b * 3 * d + h * D;
  const float* krow = qrow + d;
  const float* vrow = qrow + 2 * d;
  float sn = 0.f;
  for (int i = tid; i < D; i += PT) {
    const float q = __ldcg(qrow + i) * a.sm_scale;
    qf[i] = in_cdt<T>(q);
    vn[i] = in_cdt<T>(__ldcg(vrow + i));
    sn += q * in_cdt<T>(__ldcg(krow + i));
  }
  const float s_new = block_sum(sn, red);  // syncs: qf / vn visible

  const size_t lb = (size_t)l * a.B + b;
  const T* kb = static_cast<const T*>(a.kc) + lb * a.T * d + h * D;
  const T* vb = static_cast<const T*>(a.vc) + lb * a.T * d + h * D;
  const int lim = a.lens.v[b], nvb = (lim + tbp - 1) / tbp, bpp = a.att_blocks;
  float m = NEG_INF, lsum = 0.f, acc = 0.f;  // acc: lane tid of the head (D <= PT)
  for (int v0 = 0; v0 < nvb; v0 += bpp) {
    const int nbk = min(bpp, nvb - v0);    // blocks of this pass
    const int t = v0 * tbp + tid;          // this thread's row
    const bool mine = tid < nbk * tbp, valid = mine && t < lim;
    T* sv = s_v + (size_t)tid * D;
    float sc = NEG_INF;
    if (valid) {
      const V* vp = reinterpret_cast<const V*>(vb + (size_t)t * d);
      for (int u = 0; u < nv; ++u) cp_async_vw<VW>(reinterpret_cast<V*>(sv) + u, vp + u);
      const V* kp = reinterpret_cast<const V*>(kb + (size_t)t * d);
      float s = 0.f;
      for (int g0 = 0; g0 < nv; g0 += GL) {
        V kw[GL];
#pragma unroll
        for (int u = 0; u < GL; ++u)
          if (g0 + u < nv) kw[u] = kp[g0 + u];
#pragma unroll
        for (int u = 0; u < GL; ++u) {
          if (g0 + u < nv) {
            const float* qk = qf + (g0 + u) * WPV * EPW;
#pragma unroll
            for (int w = 0; w < WPV; ++w)
#pragma unroll
              for (int k = 0; k < EPW; ++k)
                s += qk[w * EPW + k] * elem_of<T>(word_of(kw[u], w), k);
          }
        }
      }
      sc = s;
    } else if (mine) {  // a row past the prefix: probability 0 against a V of 0
      for (int u = 0; u < nv; ++u) reinterpret_cast<V*>(sv)[u] = V{};
    }
    s_p[tid] = sc;
    cp_async_wait();
    __syncthreads();
    // each block's max (warp j of the pass), then the running maxima
    if (warp < nbk) {
      float mx = NEG_INF;
      for (int i = lane; i < tbp; i += 32) mx = fmaxf(mx, s_p[warp * tbp + i]);
      mx = warp_max(mx);
      if (lane == 0) bmax[warp] = mx;
    }
    __syncthreads();
    if (tid == 0) {
      float run = m;
      for (int jb = 0; jb < nbk; ++jb) {
        run = fmaxf(run, bmax[jb]);
        bmax[jb] = run;
      }
    }
    __syncthreads();
    if (mine) {
      const float p = expf(sc - bmax[tid / tbp]);
      s_p[tid] = p;
      s_pr[tid] = in_cdt<T>(p);
    }
    __syncthreads();
    // each block's probability sum, and the P.V sums per (block, lane):
    // the block's rows in order
    if (warp < nbk) {
      float ps = 0.f;
      for (int i = lane; i < tbp; i += 32) ps += s_p[warp * tbp + i];
      ps = warp_sum(ps);
      if (lane == 0) bsum[warp] = ps;
    }
    for (int o = tid; o < nbk * D; o += PT) {
      const int jb = o / D, i = o % D;
      const T* vcol = s_v + i;
      float pv = 0.f;
      for (int r = jb * tbp; r < (jb + 1) * tbp; ++r) pv += s_pr[r] * to_f(vcol[(size_t)r * D]);
      s_pv[jb * MAX_HD + i] = pv;
    }
    __syncthreads();
    for (int jb = 0; jb < nbk; ++jb) {
      const float corr = expf(m - bmax[jb]);
      lsum = lsum * corr + bsum[jb];
      if (tid < D) acc = acc * corr + s_pv[jb * MAX_HD + tid];
      m = bmax[jb];
    }
    __syncthreads();  // the pass's shared arrays are reused by the next
  }

  const float m_f = fmaxf(m, s_new);
  const float corr = expf(m - m_f);
  const float p_new = expf(s_new - m_f);
  const float l_f = lsum * corr + p_new;
  if (tid < D) {
    const float out = acc * corr + p_new * vn[tid];
    a.attn[(size_t)b * d + h * D + tid] = rt(out / fmaxf(l_f, 1e-30f), a.act_bf16);
    const size_t row = (lb * a.T + a.pos) * d + h * D + tid;
    static_cast<T*>(a.kc)[row] = from_f<T>(__ldcg(krow + tid));
    static_cast<T*>(a.vc)[row] = from_f<T>(__ldcg(vrow + tid));
  }
  __syncthreads();  // the work area is reused by the next item
}

// Layer l's attention, the item (b, h) of attention kind AK.
template <int AK>
__device__ __forceinline__ void att_item(const Mega& a, int l, int b, int h, float* work) {
  if constexpr (AK == AK_CODES) {
    attn_item(a, l, b, h, work);
  } else if constexpr (AK == AK_F32) {
    attn_item_f<float, 16>(a, l, b, h, work);
  } else {
    if ((a.d / a.H) % 8 == 0) attn_item_f<__nv_bfloat16, 16>(a, l, b, h, work);
    else attn_item_f<__nv_bfloat16, 8>(a, l, b, h, work);
  }
}

template <int AK>
__global__ void __launch_bounds__(PT, 1) k_mega(const __grid_constant__ Mega a) {
  extern __shared__ __align__(1024) uint8_t msm[];
  uint8_t* ring = msm;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(msm + NST * STAGE_BYTES);
  Consts& cs = *reinterpret_cast<Consts*>(msm + NST * STAGE_BYTES + 8 * NST);
  float* work = reinterpret_cast<float*>(msm + NST * STAGE_BYTES + 8 * NST + sizeof(Consts));
  const uint32_t mbar0 = smem_u32(mbar);
  const int nb = gridDim.x, warp = threadIdx.x >> 5;
  const int dk = a.wbits == 4 ? a.d / 2 : a.d;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(mbar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    cs.la_rows = a.plan[P_LA_ROWS];
    int off = 0;
    for (int j = 0; j < 4; ++j) {
      cs.gs_off[j] = off;
      off += gemv_cols(j, a.d) / CW + 1;
    }
  }
  for (int i = threadIdx.x; i < a.L * 4; i += PT) cs.xs[i] = a.xs[i];
  for (int i = threadIdx.x; i < a.L * N_TILES; i += PT) {
    cs.at_s[i] = a.at_s[i];
    cs.bt_s[i] = a.bt_s[i];
  }
  for (int j = 0, off = 0; j < 4; ++j) {
    const int n = gemv_cols(j, a.d) / CW + 1;
    for (int i = threadIdx.x; i < n; i += PT) cs.gs[off + i] = a.plan[a.plan[P_GSLOTS + j] + i];
    off += n;
  }
  for (int j = 0, np = 0, nq = 0; j < 4; ++j) {
    const int p0 = piece_off(a.plan, nb, j, blockIdx.x), p1 = piece_off(a.plan, nb, j, blockIdx.x + 1);
    const int q0 = la_off(a.plan, nb, j, blockIdx.x), q1 = la_off(a.plan, nb, j, blockIdx.x + 1);
    for (int i = threadIdx.x; i < 4 * (p1 - p0); i += PT)
      cs.pieces[4 * np + i] = a.plan[a.plan[P_PIECES] + 4 * p0 + i];
    for (int i = threadIdx.x; i < q1 - q0; i += PT) cs.items[nq + i] = a.plan[a.plan[P_LAS] + q0 + i];
    if (threadIdx.x == 0) {
      cs.p_lo[j] = np;
      cs.q_lo[j] = nq;
    }
    np += p1 - p0;
    nq += q1 - q0;
    if (threadIdx.x == 0) {
      cs.p_lo[j + 1] = np;
      cs.q_lo[j + 1] = nq;
    }
  }
  __syncthreads();
  WIter it = {0, 0, 0, 0};
  int issued = 0, consumed = 0, nbar = 0;
  if (warp == 0)
    for (int s = 0; s < NST; ++s) ring_issue(a, cs, ring, mbar0, it, issued, dk);
  prefetch_layer<AK>(a, 0, nb);
  phase_first(a, cs, nb, work);
  grid_sync(a.bar, a.clk, nb, nbar);
  for (int l = 0; l < a.L; ++l) {
    if (l + 1 < a.L) prefetch_layer<AK>(a, l + 1, nb);
    phase_gemv(a, cs, l, 0, nb, ring, mbar0, it, issued, consumed, dk, work);
    grid_sync(a.bar, a.clk, nb, nbar);
    phase_epilogue(a, cs, l, 0, nb, work);
    grid_sync(a.bar, a.clk, nb, nbar);
    for (int e = blockIdx.x; e < a.B * a.H; e += nb) att_item<AK>(a, l, e / a.H, e % a.H, work);
    grid_sync(a.bar, a.clk, nb, nbar);
    phase_gemv(a, cs, l, 1, nb, ring, mbar0, it, issued, consumed, dk, work);
    grid_sync(a.bar, a.clk, nb, nbar);
    phase_row(a, cs, l, 1, nb, work);
    grid_sync(a.bar, a.clk, nb, nbar);
    phase_gemv(a, cs, l, 2, nb, ring, mbar0, it, issued, consumed, dk, work);
    grid_sync(a.bar, a.clk, nb, nbar);
    phase_epilogue(a, cs, l, 2, nb, work);
    grid_sync(a.bar, a.clk, nb, nbar);
    phase_gemv(a, cs, l, 3, nb, ring, mbar0, it, issued, consumed, dk, work);
    grid_sync(a.bar, a.clk, nb, nbar);
    phase_row(a, cs, l, 3, nb, work);
    if (l + 1 < a.L) grid_sync(a.bar, a.clk, nb, nbar);
  }
  if (nbar & 1) grid_sync(a.bar, a.clk, nb, nbar);  // leave the counter as the step found it
}

// Dynamic shared memory of a k_mega block: the ring, its mbarriers, the
// constants and the phases' work area (WORK_BYTES: the largest users are a
// LoRA-A item's bank rows, inputs and partial sums, up to 64 x 256 float32
// bank values, and a float attention item's arrays and staged V rows; then
// a code attention item's rows of V codes).
static size_t mega_smem() {
  return (size_t)NST * STAGE_BYTES + 8 * NST + sizeof(Consts) + WORK_BYTES;
}

// k_mega<AK> with its dynamic shared memory allowed.
template <int AK>
static int mega_kernel(const void** fn) {
  *fn = (const void*)k_mega<AK>;
  return (int)cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)mega_smem());
}

// The cooperative grid of k_mega on the current device: SMs x the blocks
// of PT threads and mega_smem() bytes each SM holds at once, the least
// over the attention kinds' instantiations.
extern "C" int mega_step_grid(int* grid) {
  int rc, dev = 0, nsm = 0, least = 1 << 30;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))) return rc;
  const void* fns[3];
  if ((rc = mega_kernel<AK_CODES>(&fns[0])) || (rc = mega_kernel<AK_F32>(&fns[1]))
      || (rc = mega_kernel<AK_BF16>(&fns[2])))
    return rc;
  for (const void* fn : fns) {
    int per = 0;
    if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, PT, mega_smem())))
      return rc;
    least = per < least ? per : least;
  }
  *grid = nsm * least;
  return 0;
}

// The map of the weight tiles as a 2-D uint8 tensor of L x 12 x dk rows of
// d bytes, read in boxes of CW bytes x CH_ROWS rows (no swizzle: a stage
// holds its rows at a stride of CW bytes). Boxes past the last row are
// filled with zeros.
static int weight_map(CUtensorMap* map, const void* wt, int d, long long rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d};
  const cuuint32_t box[2] = {CW, CH_ROWS};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult rc = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wt), dims,
                          strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int AK>
static int launch_mega(Mega& m, int grid, cudaStream_t stream) {
  const void* fn;
  int rc = mega_kernel<AK>(&fn);
  if (rc) return rc;
  const int dk = m.wbits == 4 ? m.d / 2 : m.d;
  if ((rc = weight_map(&m.wmap, m.wt, m.d, (long long)m.L * N_TILES * dk))) return rc;
  void* args[] = {&m};
  rc = (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(PT), args, mega_smem(), stream);
  if (rc) {
    cudaGetLastError();  // a refused launch (a grid the card cannot hold) leaves no error behind
    return rc;
  }
  return (int)cudaGetLastError();
}

#define MEGA_SCRATCH                                                                      \
  int8_t *qx, float *xf, int32_t *part, float *la, float *qkv, float *attn, unsigned *bar, \
      const int *plan

// Set by mega_phase_clock: the buffer the next steps write their barrier
// times to (instrumentation), or null.
static unsigned long long* g_clk = nullptr;

extern "C" int mega_phase_clock(unsigned long long* clk) {
  g_clk = clk;
  return 0;
}

static Mega make_mega(STEP_ARGS, MEGA_SCRATCH, int L, int B, int d, int H, int r, int wbits,
                      int has_lora, int lora_dt, int act_bf16, int lora_round, float eps,
                      float aq_max, float sm_scale) {
  Mega m = {};
  m.h_in = h_in; m.h_out = h_out; m.wt = wt; m.ws = ws; m.bias = bias; m.at = at; m.bt = bt;
  m.at_s = at_s; m.bt_s = bt_s; m.ln = ln; m.xs = xs;
  m.qx = qx; m.xf = xf; m.part = part; m.la = la; m.qkv = qkv; m.attn = attn; m.bar = bar;
  m.plan = plan;
  m.L = L; m.B = B; m.d = d; m.H = H; m.r = r; m.wbits = wbits; m.has_lora = has_lora;
  m.lora_dt = lora_dt; m.act_bf16 = act_bf16; m.lora_round = lora_round;
  m.eps = eps; m.aq_max = aq_max; m.sm_scale = sm_scale;
  m.clk = g_clk;
  return m;
}

// #1: int8 / int4 codes + (L, B, T) row scales, appended at the shared pos;
// one launch of k_mega on `grid` blocks (the plan's).
extern "C" int mega_decode_step_kv(
    STEP_ARGS, int8_t* kc, int8_t* vc, float* ksc, float* vsc, MEGA_SCRATCH, int L, int B,
    int d, int H, int T, int r, int pos, int tbp, int wbits, int kv_bits, int has_lora,
    int lora_dt, int act_bf16, int lora_round, int grid, float eps, float aq_max,
    float sm_scale, cudaStream_t stream) {
  if (B > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  Mega m = make_mega(h_in, h_out, wt, ws, bias, at, bt, at_s, bt_s, ln, xs, qx, xf, part, la,
                     qkv, attn, bar, plan, L, B, d, H, r, wbits, has_lora, lora_dt, act_bf16,
                     lora_round, eps, aq_max, sm_scale);
  m.kc = kc; m.vc = vc; m.ksc = ksc; m.vsc = vsc;
  m.T = T; m.pos = pos; m.tbp = tbp; m.kv_bits = kv_bits;
  for (int b = 0; b < B; ++b) m.lens.v[b] = pos;
  return launch_mega<AK_CODES>(m, grid, stream);
}

// #3: float head-interleaved (L, B, T, d) caches (cdt 0 float32, 1 bf16),
// appended at the shared pos; one launch of k_mega on `grid` blocks (the
// plan's), each attention pass att_blocks JAX blocks of tbp rows.
extern "C" int mega_decode_step_f(
    STEP_ARGS, void* kc, void* vc, MEGA_SCRATCH, int L, int B, int d, int H, int T, int r,
    int pos, int tbp, int att_blocks, int wbits, int cdt, int has_lora, int lora_dt,
    int act_bf16, int lora_round, int grid, float eps, float aq_max, float sm_scale,
    cudaStream_t stream) {
  if (B > MAX_SLOTS || d / H > MAX_HD) return (int)cudaErrorInvalidValue;
  Mega m = make_mega(h_in, h_out, wt, ws, bias, at, bt, at_s, bt_s, ln, xs, qx, xf, part, la,
                     qkv, attn, bar, plan, L, B, d, H, r, wbits, has_lora, lora_dt, act_bf16,
                     lora_round, eps, aq_max, sm_scale);
  m.kc = kc; m.vc = vc;
  m.T = T; m.pos = pos; m.tbp = tbp; m.kv_bits = 16; m.att_blocks = att_blocks;
  for (int b = 0; b < B; ++b) m.lens.v[b] = pos;
  return cdt == 0 ? launch_mega<AK_F32>(m, grid, stream) : launch_mega<AK_BF16>(m, grid, stream);
}

// #4: per-slot main lengths (lens_host: B ints in host memory, copied into
// the launch's arguments) over read-only main caches (L, B, T, dc) + (L, B,
// T), then the recent buffer (L, B, Tr, dc) + (L, B, Tr) rows [0, rpos),
// which receives the new codes and scales at rpos; one launch of k_mega.
extern "C" int mega_decode_step_cb(
    STEP_ARGS, int8_t* kc, int8_t* vc, float* ksc, float* vsc, int8_t* kr, int8_t* vr,
    float* ksr, float* vsr, const int* lens_host, MEGA_SCRATCH, int L, int B, int d, int H,
    int T, int Tr, int r, int rpos, int tbp, int wbits, int kv_bits, int has_lora,
    int lora_dt, int act_bf16, int lora_round, int grid, float eps, float aq_max,
    float sm_scale, cudaStream_t stream) {
  if (B > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  Mega m = make_mega(h_in, h_out, wt, ws, bias, at, bt, at_s, bt_s, ln, xs, qx, xf, part, la,
                     qkv, attn, bar, plan, L, B, d, H, r, wbits, has_lora, lora_dt, act_bf16,
                     lora_round, eps, aq_max, sm_scale);
  m.kc = kc; m.vc = vc; m.ksc = ksc; m.vsc = vsc;
  m.kr = kr; m.vr = vr; m.ksr = ksr; m.vsr = vsr;
  m.T = T; m.Tr = Tr; m.rpos = rpos; m.tbp = tbp; m.kv_bits = kv_bits;
  for (int b = 0; b < B; ++b) m.lens.v[b] = lens_host[b];
  return launch_mega<AK_CODES>(m, grid, stream);
}
