// Flash attention of a block's queries over one layer of the KV cache, with
// an additive float32 bias per KV token.  Hopper (sm_90a), bf16 in, bf16 out,
// float32 softmax state.
//
// Replaces: longlive_tpu/ops/attention.py::_flash_kernel (the Pallas TPU
// kernel) in three of its modes: bias + kv_layer, the mode every
// self-attention of the cached DiT forward runs in; q_rope, the same with
// q's rotary embedding applied in the prologue (fused_rope serving); and
// qk_int8 (with or without stored k_scales), QK^T on the int8 tensor cores
// for the int8 K cache (kv_int8) and the int8 recache (pallas_qk8).
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
//     product and the sum rounded separately.  P and PV are the bf16 path.
//
// What bounds it on an H100: at the decode shape (q 4680 x 12 heads, cache
// 18720 tokens, D = 128) the work is ~0.54 TFLOP against ~0.12 GB of
// operands, about 4,600 operations per byte: far above the card's ~295
// operations per byte, so tensor-core throughput bounds it.
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
// ldmatrix reads are free of bank conflicts.  The qk_int8 mode stages q and
// K as int8 rows (128 + 16 bytes) and runs QK^T on mma.sync m16n8k32
// (s8 x s8 -> s32, 4 k-steps over D); it halves K's bytes and doubles the
// QK^T rate, while PV keeps the bf16 rate, so at the decode shape it is
// bounded by ~3/4 of the bf16 mode's operation time.  wgmma, TMA and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int BM = 128;         // query rows per CTA
constexpr int BN = 64;          // KV tokens per tile
constexpr int NWARPS = BM / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = D + 8;      // padded shared-memory row, in bf16
constexpr float NEG = -1e30f;
constexpr int LD8 = D + 16;     // padded int8 row of the qk_int8 mode, in bytes
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

// INT8 = false: q, k are bf16 ([B, Sq, N, D], [B*N, S, D]); rope_cos /
// rope_sin select the q_rope mode.  INT8 = true: q8, k8 are int8 in the same
// layouts with qscale [B, Sq, N] and kscale [B*N, S] float32.
template <bool INT8>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_attention_kernel(const void* __restrict__ q_, const void* __restrict__ k_,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                       const float* __restrict__ rope_cos, const float* __restrict__ rope_sin,
                       const float* __restrict__ qscale, const float* __restrict__ kscale,
                       __nv_bfloat16* __restrict__ out, int Sq, int N, int S, float scale) {
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
  const size_t row_stride = (size_t)N * D;  // q / out token stride, in elements
  const size_t qoff = (size_t)b * Sq * row_stride + (size_t)n * D;
  __nv_bfloat16* ob = out + qoff;
  const __nv_bfloat16* vb = v + (size_t)bh * S * D;
  const float* biasb = bias + (size_t)b * S;

  auto load_kv = [&](int tile, int buf) {
    const int kv0 = tile * BN;
    for (int i = tid; i < BN * (D / 8); i += NTHREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = kv0 + r < S;
      const size_t off = (size_t)(ok ? kv0 + r : 0) * D + c;
      cp_async16(sV + (buf * BN + r) * LDS + c, vb + off, ok);
      if constexpr (INT8) {
        if (c < D / 2) {  // an int8 row is D bytes: 8 chunks of 16
          const int c8 = c * 2;
          cp_async16(sK8 + (buf * BN + r) * LD8 + c8,
                     static_cast<const int8_t*>(k_) + (size_t)bh * S * D +
                         (size_t)(ok ? kv0 + r : 0) * D + c8,
                     ok);
        }
      } else {
        cp_async16(sK + (buf * BN + r) * LDS + c,
                   static_cast<const __nv_bfloat16*>(k_) + (size_t)bh * S * D + off, ok);
      }
    }
    cp_async_commit();
  };

  const int ntiles = (S + BN - 1) / BN;
  load_kv(0, 0);

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

  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < ntiles) {
      load_kv(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sv = sV + buf * BN * LDS;
    const int kv0 = tile * BN;

    // S = Q K^T: 16 x 64 per warp, 8 n-tiles of 8 tokens; then the bias
    // (ragged tail: -1e30)
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
          const bool ok = col < S;
          const float ks_ = ok ? __ldg(kscb + col) : 0.f;
          const float bv = ok ? __ldg(biasb + col) : NEG;
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
          const int col = kv0 + nt * 8 + t4 * 2 + j;
          const float bv = col < S ? __ldg(biasb + col) : NEG;
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
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);

    // P = exp(S - m), packed as bf16 A fragments of P V (4 k-steps of 16)
    uint32_t pf[BN / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const float p0 = __expf(s[nt][0] - mn0), p1 = __expf(s[nt][1] - mn0);
      const float p2 = __expf(s[nt][2] - mn1), p3 = __expf(s[nt][3] - mn1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
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
    __syncthreads();  // this buffer is refilled by the next iteration's load
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

template <bool INT8>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* rope_cos,
           const void* rope_sin, const void* qscale, const void* kscale, void* out, int B,
           int Sq, int N, int S, float scale, void* stream) {
  const size_t smem = INT8 ? SMEM_INT8 : SMEM_BF16;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<INT8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BM - 1) / BM, B * N);
  flash_attention_kernel<INT8><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      q, k, static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin),
      static_cast<const float*>(qscale), static_cast<const float*>(kscale),
      static_cast<__nv_bfloat16*>(out), Sq, N, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: [B, Sq, N, 128] bf16; k, v: [B*N, S, 128] bf16; bias: [B, S] f32;
// rope_cos, rope_sin: [Sq, 64] f32 for the q_rope mode, both null otherwise.
int longlive_flash_attention(const void* q, const void* k, const void* v, const void* bias,
                             const void* rope_cos, const void* rope_sin, void* out, int B,
                             int Sq, int N, int S, float scale, void* stream) {
  return launch<false>(q, k, v, bias, rope_cos, rope_sin, nullptr, nullptr, out, B, Sq, N, S,
                       scale, stream);
}

// The qk_int8 mode: q8 [B, Sq, N, 128] int8 with qscale [B, Sq, N] f32 (the
// softmax scale already folded in); k8 [B*N, S, 128] int8 with kscale
// [B*N, S] f32; v [B*N, S, 128] bf16; bias [B, S] f32; out as above.
int longlive_flash_attention_qk8(const void* q8, const void* qscale, const void* k8,
                                 const void* kscale, const void* v, const void* bias, void* out,
                                 int B, int Sq, int N, int S, void* stream) {
  return launch<true>(q8, k8, v, bias, nullptr, nullptr, qscale, kscale, out, B, Sq, N, S, 1.f,
                      stream);
}

const char* longlive_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
