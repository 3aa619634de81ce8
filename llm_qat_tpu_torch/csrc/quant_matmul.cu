// Dequantize-and-multiply GEMM for int8 and nibble-packed int4 weights, for
// sm_90a.
//
// Replaces two Pallas kernels of llm_qat_tpu/ops/quant_matmul.py:
// `_int8_kernel` (:91, launched by `quant_matmul_int8` at :124, kernel #10)
// and `_int4_kernel` (:98, launched by `quant_matmul_int4` at :151, #11):
//     out[M,N] = (bf16(x)[M,K] . bf16(codes)[K,N]) * scale[N]
// with float32 sums and the per-column scale applied after the whole sum.
// Both kernels below are templated on the weight's bits: int8 codes (K, N),
// or (K/2, N) bytes whose low nibble holds row 2k and high nibble row
// 2k + 1, each as q + 8. The Python wrappers are
// llm_qat_tpu_torch/ops/quant_matmul.py::quant_matmul_int8 and
// ::quant_matmul_int4, with their plain PyTorch versions beside them; the
// plan (regime, columns per block, K split) is `launch_plan` there.
//
// Codes in [-127, 127] are exact in bf16 (and in float32), and a bf16 x
// bf16 product is exact in float32, as the MXU dot with a float32 result
// is, so the kernels and the plain version differ by the order of the
// float32 sums only. Every sum runs in a fixed order (no atomics), so two
// calls on the same inputs give bit-equal outputs.
//
// Bound. A call must read x (2MK bytes as bf16), the codes (KN or KN/2
// bytes) and the scales, and write the float32 output (4MN bytes); it does
// 2MNK operations. At a decode step (M = 8) that is bytes: one GPT-2 layer's
// four linears (768 x 2304, 768 x 768, 768 x 3072, 3072 x 768) hold 7.1 MB
// of int8 codes, 2.2 us at 3.35 TB/s, and a single linear is 0.6-2.4 MB,
// about what the card keeps in flight in one memory latency. At the
// prefill's M = 1024 it is operations: 14.5 GFLOP per layer, 14.7 us at
// 989 TFLOP/s bf16.
//
// Design: two kernels, chosen by the wrapper from M (`launch_plan`). Both
// run mma.sync m16n8k16 on bf16 with float32 accumulators, stream x and the
// codes through a cp.async ring in steps of 64 k rows (neighbouring threads
// copy neighbouring 16-byte chunks of a row; a 6- or 3-stage ring keeps
// several steps in flight while one is multiplied), and decode each code
// to bf16 once, in registers: a code byte placed under the exponent of 2^23
// is the float 2^23 + code (+ 128 or 8), one subtraction gives the code
// exactly, and the high half of that float is its bf16.
//
// Small M (M <= 16, `qmm_small`), the decode step. The product is computed
// as out^T = W^T . x^T, so that 8 rows of x fill the mma's n8 side and no
// row is padding. A block of 4 warps owns 8 rows of x and 64 columns; each
// warp takes a 16-row slice of every step, so K is split over the warps,
// whose partial tiles are summed in shared memory in the order 0, 1, 2, 3.
// Even so, GPT-2's narrow linears give few blocks (N / 64), so K is also
// split over the `split` blocks of a thread block cluster (at most 8, each
// a whole number of steps); their tiles are summed through distributed
// shared memory in the order of rank. One launch, no workspace, at least
// 72 blocks per GPT-2 linear. At M = 8 the time is not the bytes (0.6-2.4
// MB per linear, about what the card has in flight in one latency): it is
// the launch, the first step's copies, the steps and the two cluster
// barriers, so the split keeps a block's steps few.
//
// Large M (`qmm_large`), the prefill: out = x . W on 128 x 128 tiles, 8
// warps of 64 x 32, two blocks per SM; K is split over a cluster (at most 4
// ways) where the tiles give fewer than two blocks per SM. The warps
// sharing columns each decode them; the A fragments of x are read as 8-byte
// words in the k order that the register decode fixes. At M = 1024 it
// runs at about a seventh of the card's bf16 peak (PERF.md).
//
// Edges are handled in the kernels: rows past M, columns past N and rows
// past K are zero-filled in shared memory and never stored. A 16-byte chunk
// goes through cp.async when its source rows are 16-byte aligned (x: K a
// multiple of 8 and x aligned; codes: N a multiple of 16 and the codes
// aligned); otherwise it is read byte by byte. K must be even.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

typedef __nv_bfloat16 bf16;

#define KS 64            // K rows per step of the cp.async rings
#define XP (KS + 16)     // bf16 row pitch of an x tile in shared memory
#define MAX_SPLIT 8      // blocks of a cluster (the portable limit)
#define NT 128           // small M: threads of a block, one warp per 16 k rows
#define BN 64            // small M: weight columns per block
#define MT 8             // small M: rows of x per block
#define STAGES 6         // small M: steps in the ring
#define LNT 256          // large M: threads of a block, 2 x 4 warps of 64 x 32
#define LBM 128          // large M: rows of x per block
#define LBN 128          // large M: weight columns per block
#define LSTAGES 3        // large M: steps in the ring
#define LDR (LBN + 4)    // large M: float row pitch of the partial tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int nbytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(nbytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes [off, off + 16) of a row of `len` bytes into 16 bytes of shared
// memory, zero past the row's end (len 0: a row past the matrix; `row` is
// then any valid address). vec: the row is 16-byte aligned and len a
// multiple of 16, so a chunk is wholly in or wholly out and cp.async copies
// it; otherwise the bytes are read one by one and stored at once.
__device__ __forceinline__ void chunk16(void* dst, const uint8_t* row, int off, int len,
                                        bool vec) {
  if (vec) {
    const bool in = off < len;
    cp_async16(dst, in ? row + off : row, in ? 16 : 0);
    return;
  }
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (off + i < len) v[i >> 2] |= (uint32_t)row[off + i] << (8 * (i & 3));
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Codes to bf16 without the slow integer conversion: a byte u placed under
// the exponent of 2^23 reads as the float 2^23 + u, and a small integer's
// bf16 is the high half of its float32, exactly.
__device__ __forceinline__ uint32_t bf16x2_of(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Byte c (0-7) of a pair of code words.
__device__ __forceinline__ uint32_t word_of(uint2 w, int c) { return c < 4 ? w.x : w.y; }

// The int8 code in byte j (0-3) of w, given w ^ 0x80808080 (code + 128):
// (2^23 + code + 128) - (2^23 + 128).
__device__ __forceinline__ float i8f(uint32_t wx, int j) {
  return __int_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 + j)) - 8388736.f;
}

// The nibble code (stored + 8) in bits 4h .. 4h + 3 of byte j of w:
// (2^23 + code + 8) - (2^23 + 8).
__device__ __forceinline__ float i4f(uint32_t w, int j, int h) {
  return __int_as_float(0x4B000000u | ((w >> (8 * j + 4 * h)) & 0xFu)) - 8388616.f;
}

// The partial tiles of the blocks of a cluster (`part`, G4 groups of 4
// floats each, in shared memory), summed in the order of rank, scaled and
// stored for the rows [m0, m0 + rows) and columns [n0, n0 + cols) of out;
// each block finishes a slice of the tile, in coalesced stores. The caller
// has synchronized the cluster after writing `part`.
template <int THREADS>
__device__ __forceinline__ void finish_tile(cg::cluster_group& cluster, float4* part, int G4,
                                            int cols, int pitch4, int m0, int n0,
                                            const float* __restrict__ scale,
                                            float* __restrict__ out, int M, int N) {
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int per = (G4 + split - 1) / split, e1 = min(G4, (rank + 1) * per);
  const bool ovec = N % 4 == 0;
  for (int e = rank * per + (int)threadIdx.x; e < e1; e += THREADS) {
    const int r = e / (cols / 4), c = 4 * (e % (cols / 4));
    float4* p = part + r * pitch4 + c / 4;
    float4 v[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)  // all loads first: they overlap
      if (q < split) v[q] = *cluster.map_shared_rank(p, q);
    float4 s = v[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q)
      if (q < split) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M) continue;
    float* o = out + (size_t)gm * N + gn;
    if (ovec && gn + 3 < N) {
      const float4 sc = *reinterpret_cast<const float4*>(scale + gn);
      *reinterpret_cast<float4*>(o) = make_float4(__fmul_rn(s.x, sc.x), __fmul_rn(s.y, sc.y),
                                                  __fmul_rn(s.z, sc.z), __fmul_rn(s.w, sc.w));
    } else {
      const float f[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) o[j] = __fmul_rn(f[j], scale[gn + j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Small M: out^T = W^T . x^T on mma.sync m16n8k16. 16 weight columns are the
// m16 side and 8 rows of x the n8 side, so a decode step (M = 8) fills the
// mma with no padding. A block owns 64 weight columns and 8 rows of x; K is
// split over its 4 warps and over the blocks of a cluster.
// grid = (ceil(N / 64) * split, ceil(M / 8)); cluster (split, 1, 1).
//
// Lane (g, t) of warp w takes, in each step, the k rows 16w + 4t .. + 3 and
// the columns 8g .. 8g + 7: one 8-byte word of codes per row (int4: two
// byte rows, each holding a pair of k rows). The mma's order of k and of
// the A rows is free as long as x follows it: fragment row g of tile T is
// column 8g + 2T and row g + 8 column 8g + 2T + 1; fragment k pairs (2t,
// 2t + 1) and (2t + 8, 2t + 9) are rows 4t, 4t + 1 and 4t + 2, 4t + 3, so
// the B fragment is one 8-byte word of x. Each code goes to bf16 once, in
// registers.
// ---------------------------------------------------------------------------

template <int BITS>
__global__ void __launch_bounds__(NT)
qmm_small(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N,
          bool xvec, bool wvec) {
  constexpr int WARPS = NT / 32;
  constexpr int CROWS = BITS == 8 ? KS : KS / 2;  // code byte rows per step
  __shared__ __align__(16) uint8_t cs[STAGES][CROWS * BN];
  __shared__ __align__(16) bf16 xs[STAGES][MT * XP];
  __shared__ __align__(16) float4 red[WARPS * MT * BN / 4];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / split) * BN, m0 = blockIdx.y * MT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nk = (K + KS - 1) / KS, steps = (nk + split - 1) / split;
  const int s0 = rank * steps, ns = max(0, min(nk, s0 + steps) - s0);
  const int rows = BITS == 8 ? K : K / 2;  // code byte rows

  auto load = [&](int slot, int step) {
    const int k0 = step * KS;
    if (tid < MT * KS / 8) {  // x: 8 rows of 128 bytes
      const int r = tid / (KS / 8), q = tid % (KS / 8);
      const bool in = m0 + r < M;
      const uint8_t* row = reinterpret_cast<const uint8_t*>(x + (size_t)(in ? m0 + r : 0) * K);
      chunk16(&xs[slot][r * XP + q * 8], row, 2 * k0 + 16 * q, in ? 2 * K : 0, xvec);
    }
    for (int c = tid; c < CROWS * BN / 16; c += NT) {
      const int r = c / (BN / 16), q = c % (BN / 16);
      const int gr = (BITS == 8 ? k0 : k0 / 2) + r;
      const bool in = gr < rows;
      chunk16(&cs[slot][r * BN + q * 16], w + (size_t)(in ? gr : 0) * N, n0 + 16 * q,
              in ? N : 0, wvec);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int T = 0; T < 4; ++T)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[T][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ns) load(s, s0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step i has landed; every warp is done with step i - 1
    const int nxt = i + STAGES - 1;
    if (nxt < ns) load(nxt % STAGES, s0 + nxt);
    cp_async_commit();
    const int slot = i % STAGES;
    uint32_t a[4][4];
    if constexpr (BITS == 8) {
      uint2 q[4];  // k rows 16w + 4t + j, columns 8g .. 8g + 7
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        q[j] = *reinterpret_cast<const uint2*>(&cs[slot][(16 * warp + 4 * t + j) * BN + 8 * g]);
        q[j].x ^= 0x80808080u;
        q[j].y ^= 0x80808080u;
      }
      auto code = [&](int j, int c) { return i8f(word_of(q[j], c), c & 3); };
#pragma unroll
      for (int T = 0; T < 4; ++T) {
        a[T][0] = bf16x2_of(code(0, 2 * T), code(1, 2 * T));
        a[T][1] = bf16x2_of(code(0, 2 * T + 1), code(1, 2 * T + 1));
        a[T][2] = bf16x2_of(code(2, 2 * T), code(3, 2 * T));
        a[T][3] = bf16x2_of(code(2, 2 * T + 1), code(3, 2 * T + 1));
      }
    } else {
      uint2 q[2];  // byte rows 8w + 2t + j: k rows 16w + 4t + 2j (low nibble), + 1 (high)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        q[j] = *reinterpret_cast<const uint2*>(&cs[slot][(8 * warp + 2 * t + j) * BN + 8 * g]);
      auto code = [&](int j, int c, int h) { return i4f(word_of(q[j], c), c & 3, h); };
#pragma unroll
      for (int T = 0; T < 4; ++T) {
        a[T][0] = bf16x2_of(code(0, 2 * T, 0), code(0, 2 * T, 1));
        a[T][1] = bf16x2_of(code(0, 2 * T + 1, 0), code(0, 2 * T + 1, 1));
        a[T][2] = bf16x2_of(code(1, 2 * T, 0), code(1, 2 * T, 1));
        a[T][3] = bf16x2_of(code(1, 2 * T + 1, 0), code(1, 2 * T + 1, 1));
      }
    }
    const uint2 xw = *reinterpret_cast<const uint2*>(&xs[slot][g * XP + 16 * warp + 4 * t]);
    const uint32_t b[2] = {xw.x, xw.y};
#pragma unroll
    for (int T = 0; T < 4; ++T) mma_bf16(acc[T], a[T], b);
  }
  cp_async_wait<0>();

  // acc[T]: rows 2t (c0, c2) and 2t + 1 (c1, c3) of x at columns 8g + 2T
  // (c0, c1) and 8g + 2T + 1 (c2, c3). The warps' partials are summed in the
  // order 0, 1, ... into warp 0's tile.
  float* redf = reinterpret_cast<float*>(red);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* p = &redf[(warp * MT + 2 * t + h) * BN + 8 * g];
    *reinterpret_cast<float4*>(p) = make_float4(acc[0][h], acc[0][2 + h], acc[1][h], acc[1][2 + h]);
    *reinterpret_cast<float4*>(p + 4) =
        make_float4(acc[2][h], acc[2][2 + h], acc[3][h], acc[3][2 + h]);
  }
  __syncthreads();
  constexpr int G4 = MT * BN / 4;
  for (int e = tid; e < G4; e += NT) {
    float4 s = red[e];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) {
      const float4 v = red[k * G4 + e];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    red[e] = s;
  }
  cluster.sync();
  finish_tile<NT>(cluster, red, G4, BN, BN / 4, m0, n0, scale, out, M, N);
  cluster.sync();  // no block leaves while another reads its tile
}

// ---------------------------------------------------------------------------
// Large M: out = x . W on mma.sync m16n8k16, 128 x 128 tiles, 8 warps of
// 64 rows x 32 columns; K split over the blocks of a cluster where the
// tiles alone leave SMs idle.
// grid = (ceil(N / 128) * split, ceil(M / 128)); cluster (split, 1, 1).
//
// The codes are decoded in registers, as in the small-M kernel: lane (g, t)
// of warp (wm, wn) reads, per 16-row slice of a step, the k rows 4t .. 4t + 3
// at the columns 32wn + 4g .. + 3 (one 4-byte word per row; int4: two byte
// rows), which give its B fragments: n index g of tile ni is column
// 32wn + 4g + ni, and fragment k pairs (2t, 2t + 1), (2t + 8, 2t + 9) are
// rows 4t, 4t + 1 and 4t + 2, 4t + 3, so an A fragment of x is two 8-byte
// words. The code rows are stored with their 16-byte chunks swizzled
// (chunk q of row r at q ^ 2((r >> SH) & 3)) so that the four t of a warp
// read distinct banks.
// ---------------------------------------------------------------------------

template <int BITS>
struct LargeSmem {
  static constexpr int CROWS = BITS == 8 ? KS : KS / 2;
  static constexpr int X = LBM * XP * 2;     // one step's x tile, bf16
  static constexpr int C = CROWS * LBN;      // one step's codes
  static constexpr int RING = LSTAGES * (X + C);
  static constexpr int RED = LBM * LDR * 4;  // the partial tile, for a split
  static constexpr int BYTES = RING > RED ? RING : RED;
};

template <int BITS>
__global__ void __launch_bounds__(LNT, 2)
qmm_large(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N,
          bool xvec, bool wvec) {
  typedef LargeSmem<BITS> L;
  constexpr int CROWS = L::CROWS;
  constexpr int SH = BITS == 8 ? 2 : 1;  // code byte row >> SH & 3 is the lane's t
  extern __shared__ __align__(16) uint8_t smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / split) * LBN, m0 = blockIdx.y * LBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int nk = (K + KS - 1) / KS, steps = (nk + split - 1) / split;
  const int s0 = rank * steps, ns = max(0, min(nk, s0 + steps) - s0);
  const int rows = BITS == 8 ? K : K / 2;

  auto xs = [&](int slot) { return reinterpret_cast<bf16*>(smem + slot * (L::X + L::C)); };
  auto cs = [&](int slot) { return smem + slot * (L::X + L::C) + L::X; };
  auto load = [&](int slot, int step) {
    const int k0 = step * KS;
    bf16* xd = xs(slot);
    for (int c = tid; c < LBM * KS / 8; c += LNT) {
      const int r = c / (KS / 8), q = c % (KS / 8);
      const bool in = m0 + r < M;
      const uint8_t* row = reinterpret_cast<const uint8_t*>(x + (size_t)(in ? m0 + r : 0) * K);
      chunk16(xd + r * XP + q * 8, row, 2 * k0 + 16 * q, in ? 2 * K : 0, xvec);
    }
    uint8_t* cd = cs(slot);
    for (int c = tid; c < CROWS * LBN / 16; c += LNT) {
      const int r = c / (LBN / 16), q = c % (LBN / 16);
      const int gr = (BITS == 8 ? k0 : k0 / 2) + r;
      const bool in = gr < rows;
      chunk16(cd + r * LBN + 16 * (q ^ (2 * ((r >> SH) & 3))), w + (size_t)(in ? gr : 0) * N,
              n0 + 16 * q, in ? N : 0, wvec);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // the lane's byte offset in a swizzled code row (its t is the row's swizzle)
  const int coff = 16 * ((2 * wn + (g >> 2)) ^ (2 * t)) + 4 * (g & 3);

#pragma unroll
  for (int s = 0; s < LSTAGES - 1; ++s) {
    if (s < ns) load(s, s0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<LSTAGES - 2>();
    __syncthreads();  // step i has landed; every warp is done with step i - 1
    const int nxt = i + LSTAGES - 1;
    if (nxt < ns) load(nxt % LSTAGES, s0 + nxt);
    cp_async_commit();
    const int slot = i % LSTAGES;
    const uint8_t* cb = cs(slot);
    const bf16* xb = xs(slot);
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {
      uint32_t b[4][2];
      if constexpr (BITS == 8) {
        uint32_t q[4];  // k rows 16ks + 4t + j
#pragma unroll
        for (int j = 0; j < 4; ++j)
          q[j] = *reinterpret_cast<const uint32_t*>(cb + (16 * ks + 4 * t + j) * LBN + coff) ^
                 0x80808080u;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          b[ni][0] = bf16x2_of(i8f(q[0], ni), i8f(q[1], ni));
          b[ni][1] = bf16x2_of(i8f(q[2], ni), i8f(q[3], ni));
        }
      } else {
        uint32_t q[2];  // byte rows 8ks + 2t + j: k rows 16ks + 4t + 2j, + 1
#pragma unroll
        for (int j = 0; j < 2; ++j)
          q[j] = *reinterpret_cast<const uint32_t*>(cb + (8 * ks + 2 * t + j) * LBN + coff);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          b[ni][0] = bf16x2_of(i4f(q[0], ni, 0), i4f(q[0], ni, 1));
          b[ni][1] = bf16x2_of(i4f(q[1], ni, 0), i4f(q[1], ni, 1));
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const bf16* p = xb + (64 * wm + 16 * mi + g) * XP + 16 * ks + 4 * t;
        const uint2 lo = *reinterpret_cast<const uint2*>(p);           // row g
        const uint2 hi = *reinterpret_cast<const uint2*>(p + 8 * XP);  // row g + 8
        const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a, b[ni]);
      }
    }
  }
  cp_async_wait<0>();

  // acc[mi][ni]: rows 64wm + 16mi + g (c0, c1) and + 8 (c2, c3); n index 2t
  // (c0, c2) is column 32wn + 8t + ni, 2t + 1 (c1, c3) column 32wn + 8t + 4 + ni:
  // each lane holds 8 adjacent columns of 8 rows.
  const int c0 = 32 * wn + 8 * t;
  if (split == 1) {
    const bool ovec = N % 4 == 0;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + 64 * wm + 16 * mi + g + 8 * h;
        if (gm >= M) continue;
        float v[8];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          v[ni] = acc[mi][ni][2 * h];
          v[4 + ni] = acc[mi][ni][2 * h + 1];
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int gn = n0 + c0 + 4 * u;
          float* o = out + (size_t)gm * N + gn;
          if (ovec && gn + 3 < N) {
            const float4 sc = *reinterpret_cast<const float4*>(scale + gn);
            *reinterpret_cast<float4*>(o) =
                make_float4(__fmul_rn(v[4 * u], sc.x), __fmul_rn(v[4 * u + 1], sc.y),
                            __fmul_rn(v[4 * u + 2], sc.z), __fmul_rn(v[4 * u + 3], sc.w));
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (gn + j < N) o[j] = __fmul_rn(v[4 * u + j], scale[gn + j]);
          }
        }
      }
    return;
  }
  __syncthreads();  // the ring is drained: its memory holds the partial tile
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = red + (64 * wm + 16 * mi + g + 8 * h) * LDR + c0;
      *reinterpret_cast<float4*>(p) = make_float4(acc[mi][0][2 * h], acc[mi][1][2 * h],
                                                  acc[mi][2][2 * h], acc[mi][3][2 * h]);
      *reinterpret_cast<float4*>(p + 4) = make_float4(acc[mi][0][2 * h + 1], acc[mi][1][2 * h + 1],
                                                      acc[mi][2][2 * h + 1], acc[mi][3][2 * h + 1]);
    }
  cluster.sync();
  finish_tile<LNT>(cluster, reinterpret_cast<float4*>(red), LBM * LBN / 4, LBN, LDR / 4, m0, n0,
                   scale, out, M, N);
  cluster.sync();  // no block leaves while another reads its tile
}

// ---------------------------------------------------------------------------

template <typename Kernel>
static cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, int split,
                          cudaStream_t stream, const bf16* x, const uint8_t* w,
                          const float* scale, float* out, int M, int K, int N, bool xvec,
                          bool wvec) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, w, scale, out, M, K, N, xvec, wvec);
}

template <int BITS>
static cudaError_t launch_large(const bf16* x, const uint8_t* w, const float* scale, float* out,
                                int M, int K, int N, int split, bool xvec, bool wvec,
                                cudaStream_t stream) {
  static bool attr_set = false;  // the attribute is per function and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_large<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, LargeSmem<BITS>::BYTES);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((unsigned)(((N + LBN - 1) / LBN) * split), (unsigned)((M + LBM - 1) / LBM));
  return launch(qmm_large<BITS>, grid, LNT, LargeSmem<BITS>::BYTES, split, stream, x, w, scale,
                out, M, K, N, xvec, wvec);
}

// out (M, N) float32 = (x (M, K) bf16 . codes) * scale (N,) float32. bits 8:
// w is (K, N) int8; bits 4: (K/2, N) bytes of two +8 nibbles. K even.
// rows: rows of x per block, 8 (qmm_small) or 128 (qmm_large); K split over
// `split` (1-8) blocks of a cluster. The plan comes from
// ops/quant_matmul.py::launch_plan.
extern "C" int quant_matmul(const void* x, const void* w, const float* scale, float* out, int M,
                            int K, int N, int bits, int rows, int split, cudaStream_t stream) {
  if (K % 2 || K < 2 || M < 1 || N < 1 || (bits != 8 && bits != 4) ||
      (rows != MT && rows != LBM) || split < 1 || split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const bool xvec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool wvec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (rows == LBM)
    return (int)(bits == 8 ? launch_large<8>(xb, wb, scale, out, M, K, N, split, xvec, wvec, stream)
                           : launch_large<4>(xb, wb, scale, out, M, K, N, split, xvec, wvec, stream));
  const dim3 grid((unsigned)(((N + BN - 1) / BN) * split), (unsigned)((M + MT - 1) / MT));
  return (int)(bits == 8 ? launch(qmm_small<8>, grid, NT, 0, split, stream, xb, wb, scale, out, M,
                                  K, N, xvec, wvec)
                         : launch(qmm_small<4>, grid, NT, 0, split, stream, xb, wb, scale, out, M,
                                  K, N, xvec, wvec));
}
