// Flash attention of a block's queries over one layer of the KV cache, with
// an additive float32 bias per KV token.  Hopper (sm_90a), bf16 in, bf16 out,
// float32 softmax state.
//
// Replaces: longlive_tpu/ops/attention.py::_flash_kernel (the Pallas TPU
// kernel) in all its modes: bias + kv_layer, the mode every self-attention
// of the cached DiT forward runs in; q_rope, the same with q's rotary
// embedding applied in the prologue (fused_rope serving); qk_int8 (with or
// without stored k_scales), QK^T on the int8 tensor cores for the int8 K
// cache (kv_int8) and the int8 recache (pallas_qk8); two-segment with dead-
// tile elision (the serving decode under LONGLIVE_TWO_SEGMENT=1); and the
// exp2 and mxu_lsum switches (LONGLIVE_EXP2=1, LONGLIVE_MXU_LSUM=1), which
// combine with every mode.
//
// Semantics kept from the TPU kernel:
//   * q is pre-scaled by 1/sqrt(D) and rounded to bf16 (done here while the
//     q tile is staged, so no separate pass over q exists);
//   * q_rope mode (cos, sin given, [Sq, 64] f32 indexed by query row, shared
//     by every head): q arrives un-roped and the staged tile is
//     bf16(q * cs + swap(q) * sn) with cs = scale * [cos ++ cos],
//     sn = scale * [-sin ++ sin] and swap exchanging the two 64-wide halves
//     (the halfsplit rotation, softmax scale folded in).  Each product and
//     the sum are rounded separately (__fmul_rn / __fadd_rn, no FMA
//     contraction), as the plain PyTorch version and XLA's separate
//     multiply and add compute it;
//   * logits are float32 q.k plus the bias; masked tokens carry the finite
//     -1e30, never -inf, so a fully masked tile cannot produce NaN in the
//     running max or the rescale factor;
//   * P is rounded to bf16 before the PV product, the row sum uses the
//     unrounded float32 P, and the output is divided by the row sum once at
//     the end;
//   * qk_int8 mode: q arrives quantized per (token, head) over D (the
//     wrapper's pass: q pre-scaled by 1/sqrt(D), rounded to bf16, then
//     round(q * (127 / amax)) with its scale amax / 127), K int8 with one
//     float32 scale per (head, token); the logits are
//     (float(int32 q.k) * qscale[row]) * kscale[col] + bias[col], each
//     product and the sum rounded separately.  P and PV are the bf16 path;
//   * two-segment mode (k2, v2 given, [B, S2, N, D] as the block's roped K
//     and its V come out of the projections): after the cache's tiles the
//     CTA walks the S2 tokens of the second segment in the same online
//     softmax, read in their token-major layout with a token stride of
//     N * D, as q is (no transposed copy of the block exists).  Its bias is
//     0 and its ragged tail -1e30 (finite: in a block's first forward no
//     cache token is valid, so the state must come out of segment 2 free
//     of NaN).  In the qk_int8 mode k2 arrives quantized per (token, head)
//     with scales [B, S2, N];
//   * dead-tile elision (use_skip): the host's live-tile mask names the
//     cache tiles of 64 tokens that the disjoint skip ranges cover
//     completely (the block's own slots); those are neither loaded nor
//     computed.  Tiles that are only partly covered are computed and the
//     bias masks them, so elision changes no result.  The cp.async
//     prefetch of the next tile skips dead tiles and crosses from the
//     cache into segment 2;
//   * exp2 (EXP2): the wrapper folds log2(e) into the softmax scale (so into
//     q's bf16 rounding, the q_rope multipliers or q's int8 quantization),
//     the kernel multiplies the bias by log2(e) (one float32 product, as the
//     TPU kernel's wrapper does) and takes ex2.approx instead of
//     exp = ex2.approx(x * log2 e);
//   * mxu_lsum (LSUM): the row sum is the float32 sum of P rounded to bf16,
//     taken on the tensor cores: one extra mma.sync m16n8k16 per k-step of
//     PV, of the bf16 P fragments against a B fragment of ones (1/16 more
//     than PV), the TPU kernel's p.astype(v.dtype) @ ones.
//
// What bounds it on an H100: at the decode shape (q 4680 x 12 heads, cache
// 18720 tokens, D = 128) the work is ~0.54 TFLOP against ~0.12 GB of
// operands, about 4,600 operations per byte: far above the card's ~295
// operations per byte, so tensor-core throughput bounds it.  The two-
// segment decode attends the same 18720 valid tokens (14040 of the cache +
// the block's 4680) when the block's 4680 dead cache slots are elided.
//
// Design: one CTA per (q tile of 128 rows, head); 8 warps, 16 query rows
// each.  The CTA loops over KV tiles of 64 tokens with the online-softmax
// state (running max, running sum, output accumulator) in registers.  Both
// products run on the tensor cores with mma.sync m16n8k16 (bf16 -> f32);
// S = Q K^T stays in registers and is re-packed in place as the A operand of
// P V, so the logits never touch shared memory.  K/V tiles are double
// buffered in shared memory with cp.async so the next tile streams while
// the current one is multiplied.  The ragged last KV tile is zero-filled
// and masked with -1e30; ragged query rows are neither loaded nor stored.
// Rows are padded by 16 bytes in shared memory so the fragment loads and
// ldmatrix reads are free of bank conflicts.  In the two-segment and
// elision modes (the LISTED instantiations) the KV loop walks a virtual tile
// list, the live cache tiles then the tiles of segment 2, with the tile body
// compiled once per segment so that each stays straight-line code around
// the products; one segment without elision keeps the plain tile loop (on
// an H100 a shared loop read 7-15% slower at the bias decode).  The qk_int8
// mode stages q and K as int8 rows (128 + 16 bytes) and runs QK^T on
// mma.sync m16n8k32 (s8 x s8 -> s32, 4 k-steps over D); it halves K's bytes
// and doubles the QK^T rate, while PV keeps the bf16 rate, so at the decode
// shape it is bounded by ~3/4 of the bf16 mode's operation time.  wgmma,
// TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Bit i of word i / 32 is set when cache tile i (tokens [64 i, 64 i + 64))
// is computed.  Passed by value in the kernel's parameters; at global scope,
// since the exported entry point takes it (64 words: 131072 cache tokens).
struct LiveTiles {
  uint32_t bits[64];
};

namespace {

constexpr int D = 128;
constexpr int BM = 128;         // query rows per CTA
constexpr int BN = 64;          // KV tokens per tile
constexpr int NWARPS = BM / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = D + 8;      // padded shared-memory row, in bf16
constexpr float NEG = -1e30f;
constexpr int LD8 = D + 16;     // padded int8 row of the qk_int8 mode, in bytes
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t BF16_ONES = 0x3F803F80u;  // two bf16 1.0: the B fragment of the row sum
// bf16 mode: q [BM][LDS], K and V [2][BN][LDS] bf16; qk_int8 mode: q and
// K [.][LD8] int8, V as in the bf16 mode
constexpr size_t SMEM_BF16 = sizeof(__nv_bfloat16) * (size_t)(BM + 4 * BN) * LDS;
constexpr size_t SMEM_INT8 = (size_t)(BM + 2 * BN) * LD8 + sizeof(__nv_bfloat16) * 2 * BN * LDS;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  // src-size 0 zero-fills the 16 destination bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(x), or 2^x in the exp2 mode (the argument already in the log2 domain)
template <bool EXP2>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (EXP2) return ex2_approx(x);
  else return __expf(x);
}

// INT8 = false: q, k, k2 are bf16 ([B, Sq, N, D], [B*N, S, D],
// [B, S2, N, D]); rope_cos / rope_sin select the q_rope mode.  INT8 = true:
// q8, k8, k2 are int8 in the same layouts with qscale [B, Sq, N], kscale
// [B*N, S] and k2scale [B, S2, N] float32.  k2 == nullptr: one segment.
// LISTED: the KV loop walks a tile list (segment 2 after the cache, or
// dead cache tiles elided); otherwise every cache tile in order, as one
// segment without elision compiles.
template <bool INT8, bool EXP2, bool LSUM, bool LISTED>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_attention_kernel(const void* __restrict__ q_, const void* __restrict__ k_,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                       const float* __restrict__ rope_cos, const float* __restrict__ rope_sin,
                       const float* __restrict__ qscale, const float* __restrict__ kscale,
                       const void* __restrict__ k2_, const float* __restrict__ k2scale,
                       const __nv_bfloat16* __restrict__ v2, const LiveTiles live, int use_skip,
                       __nv_bfloat16* __restrict__ out, int Sq, int N, int S, int S2,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // bf16 mode: sQ [BM][LDS], sK [2][BN][LDS] bf16; int8 mode: sQ8 [BM][LD8],
  // sK8 [2][BN][LD8] int8; sV [2][BN][LDS] bf16 in both
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BM * LDS;
  int8_t* sQ8 = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* sK8 = sQ8 + BM * LD8;
  __nv_bfloat16* sV = INT8 ? reinterpret_cast<__nv_bfloat16*>(sK8 + 2 * BN * LD8)
                           : sK + 2 * BN * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / N, n = bh % N;
  const int q0 = blockIdx.x * BM;
  const size_t row_stride = (size_t)N * D;  // q / out / k2 / v2 token stride, in elements
  const size_t qoff = (size_t)b * Sq * row_stride + (size_t)n * D;
  __nv_bfloat16* ob = out + qoff;
  const float* biasb = bias + (size_t)b * S;
  // segment 2 of this (batch, head): token j at j * row_stride
  const size_t seg2off = (size_t)b * S2 * row_stride + (size_t)n * D;

  // the virtual tile list: cache tiles [0, nt1) (those live), then the
  // tiles of segment 2 [nt1, nt1 + nt2)
  const int nt1 = (S + BN - 1) / BN;
  const int ntot = nt1 + (LISTED && k2_ != nullptr ? (S2 + BN - 1) / BN : 0);
  auto next_live = [&](int j) {
    if (LISTED && use_skip)
      while (j < nt1 && !((live.bits[j >> 5] >> (j & 31)) & 1u)) ++j;
    return j;
  };

  auto load_kv = [&](int tile, int buf) {
    const bool seg2 = LISTED && tile >= nt1;
    const int kv0 = (seg2 ? tile - nt1 : tile) * BN;
    const int len = seg2 ? S2 : S;
    // this (batch, head)'s token 0 and token stride, in elements: the
    // cache's [B*N, S, D] rows or segment 2's [B, S2, N, D] tokens
    const size_t base = seg2 ? seg2off : (size_t)bh * S * D;
    const size_t tstride = seg2 ? row_stride : (size_t)D;
    const __nv_bfloat16* vsrc = (seg2 ? v2 : v) + base;
    const void* ksrc = seg2 ? k2_ : k_;
    for (int i = tid; i < BN * (D / 8); i += NTHREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = kv0 + r < len;
      const size_t off = (size_t)(ok ? kv0 + r : 0) * tstride;
      cp_async16(sV + (buf * BN + r) * LDS + c, vsrc + off + c, ok);
      if constexpr (INT8) {
        if (c < D / 2) {  // an int8 row is D bytes: 8 chunks of 16
          const int c8 = c * 2;
          cp_async16(sK8 + (buf * BN + r) * LD8 + c8,
                     static_cast<const int8_t*>(ksrc) + base + off + c8, ok);
        }
      } else {
        cp_async16(sK + (buf * BN + r) * LDS + c,
                   static_cast<const __nv_bfloat16*>(ksrc) + base + off + c, ok);
      }
    }
    cp_async_commit();
  };

  int cur = next_live(0);
  if (cur < ntot) load_kv(cur, 0);

  // this warp's 16 query rows as A fragments: 8 bf16 k-steps of 16, or 4
  // int8 k-steps of 32 over D
  uint32_t qf[INT8 ? D / 32 : D / 16][4];
  float qs0 = 0.f, qs1 = 0.f;  // int8 mode: the scales of rows g and g + 8
  if constexpr (INT8) {
    const int8_t* qb = static_cast<const int8_t*>(q_) + qoff;
    for (int i = tid; i < BM * (D / 16); i += NTHREADS) {
      const int r = i / (D / 16), c = (i % (D / 16)) * 16;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * row_stride + c);
      *reinterpret_cast<uint4*>(sQ8 + r * LD8 + c) = val;
    }
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
    if (r0 < Sq) qs0 = __ldg(qscale + ((size_t)b * Sq + r0) * N + n);
    if (r1 < Sq) qs1 = __ldg(qscale + ((size_t)b * Sq + r1) * N + n);
    __syncthreads();
    const int8_t* sq = sQ8 + (warp * 16) * LD8;
#pragma unroll
    for (int ks = 0; ks < D / 32; ++ks) {
      const int c = ks * 32 + t4 * 4;
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(sq + g * LD8 + c);
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(sq + (g + 8) * LD8 + c);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(sq + g * LD8 + c + 16);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(sq + (g + 8) * LD8 + c + 16);
    }
  } else {
    // stage q: bf16(float(q) * scale), or the rotated form in q_rope mode;
    // ragged rows are zero and read neither q nor cos/sin
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q_) + qoff;
    for (int i = tid; i < BM * (D / 8); i += NTHREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < Sq) {
        const __nv_bfloat16* qrow = qb + (size_t)(q0 + r) * row_stride;
        val = *reinterpret_cast<const uint4*>(qrow + c);
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
        if (rope_cos == nullptr) {
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
        } else {
          // the partner chunk 64 columns away, and this chunk's 8 angles
          const uint4 pv = *reinterpret_cast<const uint4*>(qrow + (c ^ (D / 2)));
          const __nv_bfloat16* pe = reinterpret_cast<const __nv_bfloat16*>(&pv);
          const int h = c & (D / 2 - 1);
          const float4* cp = reinterpret_cast<const float4*>(rope_cos + (size_t)(q0 + r) * (D / 2) + h);
          const float4* sp = reinterpret_cast<const float4*>(rope_sin + (size_t)(q0 + r) * (D / 2) + h);
          const float4 c0 = __ldg(cp), c1 = __ldg(cp + 1), s0 = __ldg(sp), s1 = __ldg(sp + 1);
          const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
          const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
          const float sgn = c < D / 2 ? -1.f : 1.f;  // re half: -sin, im half: +sin
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float cs = __fmul_rn(cv[j], scale), sn = sgn * __fmul_rn(sv[j], scale);
            e[j] = __float2bfloat16(__fadd_rn(__fmul_rn(__bfloat162float(e[j]), cs),
                                              __fmul_rn(__bfloat162float(pe[j]), sn)));
          }
        }
      }
      *reinterpret_cast<uint4*>(sQ + r * LDS + c) = val;
    }
    __syncthreads();
    const __nv_bfloat16* sq = sQ + (warp * 16) * LDS;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks * 16 + t4 * 2;
      qf[ks][0] = lds32(sq + g * LDS + c);
      qf[ks][1] = lds32(sq + (g + 8) * LDS + c);
      qf[ks][2] = lds32(sq + g * LDS + c + 8);
      qf[ks][3] = lds32(sq + (g + 8) * LDS + c + 8);
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const float* kscb = INT8 ? kscale + (size_t)bh * S : nullptr;

  int buf = 0;
  // one KV tile's online-softmax step from buffer buf, tokens [kv0, kv0 +
  // 64) of the cache (SEG2 false) or of segment 2: instantiated per segment
  // so that each is straight-line code around the tensor-core products
  auto tile_step = [&](auto seg2_tag, int kv0) {
    constexpr bool SEG2 = decltype(seg2_tag)::value;
    const __nv_bfloat16* sv = sV + buf * BN * LDS;
    const int len = SEG2 ? S2 : S;

    // the additive term of a column: the cache's bias (times log2 e in the
    // exp2 mode), 0 in segment 2, -1e30 past either segment's end
    auto col_bias = [&](int col) {
      if constexpr (SEG2) return col < len ? 0.f : NEG;
      else if constexpr (EXP2) return col < len ? __fmul_rn(__ldg(biasb + col), LOG2E) : NEG;
      else return col < len ? __ldg(biasb + col) : NEG;
    };

    // S = Q K^T: 16 x 64 per warp, 8 n-tiles of 8 tokens; then the bias
    float s[BN / 8][4];
    if constexpr (INT8) {
      const int8_t* sk = sK8 + buf * BN * LD8;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        int si[4] = {0, 0, 0, 0};
        const int8_t* kp = sk + (nt * 8 + g) * LD8 + t4 * 4;
#pragma unroll
        for (int ks = 0; ks < D / 32; ++ks)
          mma_s8(si, qf[ks], *reinterpret_cast<const uint32_t*>(kp + ks * 32),
                 *reinterpret_cast<const uint32_t*>(kp + ks * 32 + 16));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = kv0 + nt * 8 + t4 * 2 + j;
          const bool ok = col < len;
          float ks_ = 0.f;
          if constexpr (SEG2) {
            if (ok) ks_ = __ldg(k2scale + ((size_t)b * S2 + col) * N + n);
          } else {
            if (ok) ks_ = __ldg(kscb + col);
          }
          const float bv = col_bias(col);
          s[nt][j] = __fadd_rn(__fmul_rn(__fmul_rn((float)si[j], qs0), ks_), bv);
          s[nt][2 + j] = __fadd_rn(__fmul_rn(__fmul_rn((float)si[2 + j], qs1), ks_), bv);
        }
      }
    } else {
      const __nv_bfloat16* sk = sK + buf * BN * LDS;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const __nv_bfloat16* kp = sk + (nt * 8 + g) * LDS + t4 * 2;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          mma16816(s[nt], qf[ks], lds32(kp + ks * 16), lds32(kp + ks * 16 + 8));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float bv = col_bias(kv0 + nt * 8 + t4 * 2 + j);
          s[nt][j] += bv;
          s[nt][2 + j] += bv;
        }
      }
    }

    // tile row max
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = softmax_exp<EXP2>(m0 - mn0), a1 = softmax_exp<EXP2>(m1 - mn1);

    // P = exp(S - m), packed as bf16 A fragments of P V (4 k-steps of 16)
    uint32_t pf[BN / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const float p0 = softmax_exp<EXP2>(s[nt][0] - mn0), p1 = softmax_exp<EXP2>(s[nt][1] - mn0);
      const float p2 = softmax_exp<EXP2>(s[nt][2] - mn1), p3 = softmax_exp<EXP2>(s[nt][3] - mn1);
      if constexpr (!LSUM) {
        rs0 += p0 + p1;
        rs1 += p2 + p3;
      }
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    if constexpr (LSUM) {
      // row sums of the bf16 P on the tensor cores: every column of
      // P (16 x 64) @ ones (64 x 8) holds the row's sum
      float ls[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) mma16816(ls, pf[ks], BF16_ONES, BF16_ONES);
      rs0 = ls[0];
      rs1 = ls[2];
    } else {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
      }
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }

    // O += P V; V fragments via ldmatrix.trans (V is [token][d] in smem)
    const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sv + (ks * 16 + (mi & 1) * 8 + ri) * LDS + dp * 16 + (mi >> 1) * 8);
        mma16816(o[2 * dp], pf[ks], vf[0], vf[1]);
        mma16816(o[2 * dp + 1], pf[ks], vf[2], vf[3]);
      }
    }
  };

  while (cur < ntot) {
    const int nxt = next_live(cur + 1);
    if (nxt < ntot) {
      load_kv(nxt, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (LISTED) {
      if (cur < nt1)
        tile_step(std::false_type{}, cur * BN);
      else
        tile_step(std::true_type{}, (cur - nt1) * BN);
    } else {
      tile_step(std::false_type{}, cur * BN);
    }
    __syncthreads();  // this buffer is refilled by the next iteration's load
    cur = nxt;
    buf ^= 1;
  }

  // out = acc / l
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * row_stride + c) =
          __floats2bfloat162_rn(o[dt][0] / l0, o[dt][1] / l0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * row_stride + c) =
          __floats2bfloat162_rn(o[dt][2] / l1, o[dt][3] / l1);
  }
}

struct Args {
  const void *q, *qscale, *k, *kscale, *v, *bias, *rope_cos, *rope_sin, *k2, *k2scale, *v2;
  LiveTiles live;
  int use_skip;
  void* out;
  int B, Sq, N, S, S2;
  float scale;
};

template <bool INT8, bool EXP2, bool LSUM, bool LISTED>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = INT8 ? SMEM_INT8 : SMEM_BF16;
  auto kernel = flash_attention_kernel<INT8, EXP2, LSUM, LISTED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BM - 1) / BM, a.B * a.N);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      a.q, a.k, static_cast<const __nv_bfloat16*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const float*>(a.rope_cos), static_cast<const float*>(a.rope_sin),
      static_cast<const float*>(a.qscale), static_cast<const float*>(a.kscale), a.k2,
      static_cast<const float*>(a.k2scale), static_cast<const __nv_bfloat16*>(a.v2), a.live,
      a.use_skip, static_cast<__nv_bfloat16*>(a.out), a.Sq, a.N, a.S, a.S2, a.scale);
  return (int)cudaGetLastError();
}

template <bool INT8, bool LISTED>
int launch_switches(const Args& a, int exp2, int lsum, cudaStream_t stream) {
  if (exp2)
    return lsum ? launch<INT8, true, true, LISTED>(a, stream)
                : launch<INT8, true, false, LISTED>(a, stream);
  return lsum ? launch<INT8, false, true, LISTED>(a, stream)
              : launch<INT8, false, false, LISTED>(a, stream);
}

}  // namespace

extern "C" {

// q, out: [B, Sq, N, 128] (q bf16, or int8 with qscale [B, Sq, N] f32 and
// the softmax scale folded in); k: [B*N, S, 128] bf16, or int8 with kscale
// [B*N, S] f32; v: [B*N, S, 128] bf16; bias: [B, S] f32; rope_cos,
// rope_sin: [Sq, 64] f32 for the q_rope mode (bf16 only), else null; k2, v2:
// [B, S2, N, 128] (k2 int8 with k2scale [B, S2, N] in the int8 mode) for the
// two-segment mode, else null; live / use_skip: the cache's live-tile mask;
// scale: the softmax scale (times log2 e when exp2); int8, exp2, lsum: the
// mode and the two switches.
int longlive_flash_attention(const void* q, const void* qscale, const void* k,
                             const void* kscale, const void* v, const void* bias,
                             const void* rope_cos, const void* rope_sin, const void* k2,
                             const void* k2scale, const void* v2, LiveTiles live, int use_skip,
                             void* out, int B, int Sq, int N, int S, int S2, float scale,
                             int int8, int exp2, int lsum, void* stream) {
  const Args a{q, qscale, k, kscale, v, bias, rope_cos, rope_sin, k2, k2scale, v2,
               live, use_skip, out, B, Sq, N, S, S2, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (k2 != nullptr || use_skip)
    return int8 ? launch_switches<true, true>(a, exp2, lsum, st)
                : launch_switches<false, true>(a, exp2, lsum, st);
  return int8 ? launch_switches<true, false>(a, exp2, lsum, st)
              : launch_switches<false, false>(a, exp2, lsum, st);
}

const char* longlive_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
