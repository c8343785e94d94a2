// Differentiable flash attention for the training paths: one forward kernel
// and a backward of two kernels (dQ, then dK/dV).  Hopper (sm_90a), bf16
// operands, float32 accumulation and softmax statistics.
//
// Replaces: longlive_tpu/ops/attention.py::flash_attention_trainable, which
// wraps the upstream Pallas TPU flash attention (forward and backward
// pallas_calls behind a custom_vjp) with a kv-valid mask given as segment
// ids.  What it computes is kept:
//   O = softmax(mask(Q K^T * scale)) V     scale = 1 / sqrt(D)
// with a [B, Skv] kv-valid mask (no mask = all valid); the TPU tiling
// workarounds (id-0 padding rows, an extra kv block) are not carried over.
//
// Layout: q, k, v, o, dout, dq, dk, dv are contiguous [B, S, N, 128] bf16
// (the linears' output layout, no transpose); lse and delta are [B, N, Sq]
// float32; mask is [B, Skv] uint8 or null.
//
// Arithmetic (each plain PyTorch version in ops/attention.py repeats it):
//   forward   s = (q.k) * scale in f32; masked tokens (and the ragged tail)
//             get the finite -1e30, so a fully masked tile cannot put NaN
//             into the running max; online softmax with f32 running max and
//             sum; P is rounded to bf16 for P V while the row sum takes the
//             unrounded P; O = acc / l; lse = m + log(l).  A row with no
//             valid token writes O = 0 and lse = +1e30, so its backward
//             recomputes P = 0 (no NaN anywhere).
//   backward  P = exp(s - lse) (0 where masked), Delta = rowsum(dO * O),
//             dV = P^T dO (P in bf16), dP = dO V^T, dS = P * (dP - Delta),
//             dK = scale * dS^T Q and dQ = scale * dS K (dS in bf16).  No
//             atomics: dQ and dK/dV are two kernels that each own their
//             output rows, so repeated runs agree bit for bit.  The dQ
//             kernel also writes Delta (its prologue), which the dK/dV
//             kernel, launched after it on the same stream, reads.
//
// What bounds it on an H100: at the critic's self-attention (32760 tokens
// over 32760, 12 heads of 128) the forward is ~6.6 TFLOP against ~0.3 GB of
// operands, tens of thousands of operations per byte, so tensor-core
// throughput bounds all three kernels; the 512-token cross-attention is far
// smaller but still operation-bound.
//
// Design (FlashAttention-2 style, mma.sync m16n8k16 bf16 -> f32):
//   forward  one CTA per (128 query rows, b*n); 8 warps of 16 rows; K/V
//            tiles of 64 tokens double buffered with cp.async; S stays in
//            registers and is re-packed as the A operand of P V.
//   dQ       one CTA per (128 query rows, b*n); Q and dO staged once; loops
//            over K/V tiles of 64 (double buffered): S and dP in registers,
//            dS re-packed as the A operand of dS K.
//   dK/dV    one CTA per (128 kv rows, b*n); 8 warps of 16 kv rows; K and V
//            staged once; loops over query tiles of 32 (Q, dO, lse, Delta
//            double buffered), computing S^T and dP^T directly so each warp
//            owns its kv rows' dK and dV accumulators in registers.
// Rows are padded by 16 bytes in shared memory (bank-conflict-free fragment
// and ldmatrix reads).  Dead-tile skipping, wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int LDS = D + 8;        // padded shared-memory row, in bf16
constexpr int NTHREADS = 256;     // 8 warps
constexpr int BM = 128;           // query rows per forward / dQ CTA
constexpr int BN = 64;            // kv tokens per forward / dQ tile
constexpr int BKV = 128;          // kv rows per dK/dV CTA
constexpr int BQ = 32;            // query rows per dK/dV tile
constexpr float NEG = -1e30f;
constexpr float EMPTY_LSE = 1e30f;

constexpr size_t FWD_SMEM = sizeof(__nv_bfloat16) * (size_t)(BM + 4 * BN) * LDS;
constexpr size_t DQ_SMEM = sizeof(__nv_bfloat16) * (size_t)(2 * BM + 4 * BN) * LDS;
constexpr size_t DKDV_SMEM =
    sizeof(__nv_bfloat16) * (size_t)(2 * BKV + 4 * BQ) * LDS + sizeof(float) * 4 * BQ;

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows x 16 k) of a row-major [row][k] tile in shared memory
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* rows, int g, int t4, int k0) {
  const bf16* p = rows + g * LDS + k0 + t4 * 2;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * LDS);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * LDS + 8);
}

// Copies `nrows` rows of 128 bf16 (token stride `rs`) starting at row `r0`
// into a padded shared tile with cp.async; rows at or past `limit` are zero.
__device__ __forceinline__ void async_rows(bf16* dst, const bf16* src, size_t rs, int r0,
                                           int nrows, int limit, int tid) {
  for (int i = tid; i < nrows * (D / 8); i += NTHREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * LDS + c, src + (size_t)(ok ? r0 + r : 0) * rs + c, ok);
  }
}

__device__ __forceinline__ bool kv_ok(const uint8_t* maskb, int col, int Skv) {
  return col < Skv && (maskb == nullptr || __ldg(maskb + col) != 0);
}

// ---------------------------------------------------------------------------
// forward

__global__ void __launch_bounds__(NTHREADS, 1)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const uint8_t* __restrict__ mask, bf16* __restrict__ out, float* __restrict__ lse,
           int Sq, int Skv, int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BM][LDS]
  bf16* sK = sQ + BM * LDS;                      // [2][BN][LDS]
  bf16* sV = sK + 2 * BN * LDS;                  // [2][BN][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / N, n = bh % N;
  const int q0 = blockIdx.x * BM;
  const size_t rs = (size_t)N * D;  // token stride
  const bf16* qb = q + (size_t)b * Sq * rs + (size_t)n * D;
  bf16* ob = out + (size_t)b * Sq * rs + (size_t)n * D;
  const bf16* kb = k + (size_t)b * Skv * rs + (size_t)n * D;
  const bf16* vb = v + (size_t)b * Skv * rs + (size_t)n * D;
  const uint8_t* maskb = mask == nullptr ? nullptr : mask + (size_t)b * Skv;

  auto load_kv = [&](int tile, int buf) {
    async_rows(sK + buf * BN * LDS, kb, rs, tile * BN, BN, Skv, tid);
    async_rows(sV + buf * BN * LDS, vb, rs, tile * BN, BN, Skv, tid);
    cp_async_commit();
  };

  const int ntiles = (Skv + BN - 1) / BN;
  async_rows(sQ, qb, rs, q0, BM, Sq, tid);
  load_kv(0, 0);  // one group with the q tile

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  uint32_t qf[D / 16][4];
  const bf16* sq = sQ + (warp * 16) * LDS;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < ntiles) {
      load_kv(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) load_a(qf[ks], sq, g, t4, ks * 16);
    }
    const bf16* sk = sK + buf * BN * LDS;
    const bf16* sv = sV + buf * BN * LDS;

    // S = Q K^T: 16 x 64 per warp
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kp = sk + (nt * 8 + g) * LDS + t4 * 2;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma16816(s[nt], qf[ks], lds32(kp + ks * 16), lds32(kp + ks * 16 + 8));
    }

    // scale, mask, tile row max
    const int kv0 = tile * BN;
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = kv_ok(maskb, kv0 + nt * 8 + t4 * 2 + j, Skv);
        s[nt][j] = ok ? s[nt][j] * scale : NEG;
        s[nt][2 + j] = ok ? s[nt][2 + j] * scale : NEG;
        mx0 = fmaxf(mx0, s[nt][j]);
        mx1 = fmaxf(mx1, s[nt][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);

    // P = exp(S - m) as bf16 A fragments of P V
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

  // a row that saw no valid token (m still -1e30) writes zeros
  const bool e0 = m0 == NEG, e1 = m1 == NEG;
  const float i0 = e0 ? 0.f : 1.f / l0, i1 = e1 ? 0.f : 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * rs + c) =
          __floats2bfloat162_rn(o[dt][0] * i0, o[dt][1] * i0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * rs + c) =
          __floats2bfloat162_rn(o[dt][2] * i1, o[dt][3] * i1);
  }
  if (t4 == 0) {
    float* lb = lse + (size_t)bh * Sq;
    if (r0 < Sq) lb[r0] = e0 ? EMPTY_LSE : m0 + logf(l0);
    if (r1 < Sq) lb[r1] = e1 ? EMPTY_LSE : m1 + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// backward, kernel 1: dQ (and Delta = rowsum(dO * O) in its prologue)

__global__ void __launch_bounds__(NTHREADS, 1)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const uint8_t* __restrict__ mask, const bf16* __restrict__ out,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Skv, int N,
              float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BM][LDS]
  bf16* sO = sQ + BM * LDS;                      // dO, [BM][LDS]
  bf16* sK = sO + BM * LDS;                      // [2][BN][LDS]
  bf16* sV = sK + 2 * BN * LDS;                  // [2][BN][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / N, n = bh % N;
  const int q0 = blockIdx.x * BM;
  const size_t rs = (size_t)N * D;
  const size_t qoff = (size_t)b * Sq * rs + (size_t)n * D;
  const bf16* kb = k + (size_t)b * Skv * rs + (size_t)n * D;
  const bf16* vb = v + (size_t)b * Skv * rs + (size_t)n * D;
  const uint8_t* maskb = mask == nullptr ? nullptr : mask + (size_t)b * Skv;

  auto load_kv = [&](int tile, int buf) {
    async_rows(sK + buf * BN * LDS, kb, rs, tile * BN, BN, Skv, tid);
    async_rows(sV + buf * BN * LDS, vb, rs, tile * BN, BN, Skv, tid);
    cp_async_commit();
  };

  const int ntiles = (Skv + BN - 1) / BN;
  async_rows(sQ, q + qoff, rs, q0, BM, Sq, tid);
  async_rows(sO, dout + qoff, rs, q0, BM, Sq, tid);
  load_kv(0, 0);

  // Delta for this warp's 16 rows: lane l reads 4 of the 128 columns
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  float dl0 = 0.f, dl1 = 0.f;
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float acc = 0.f;
    if (row < Sq) {
      const size_t off = qoff + (size_t)row * rs + lane * 4;
      const uint2 ov = *reinterpret_cast<const uint2*>(out + off);
      const uint2 dv = *reinterpret_cast<const uint2*>(dout + off);
      const bf16* oe = reinterpret_cast<const bf16*>(&ov);
      const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc += __bfloat162float(oe[j]) * __bfloat162float(de[j]);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (r == g) dl0 = acc;
    if (r == g + 8) dl1 = acc;
    if (lane == 0 && row < Sq) delta[(size_t)bh * Sq + row] = acc;
  }
  const float L0 = r0 < Sq ? lse[(size_t)bh * Sq + r0] : EMPTY_LSE;
  const float L1 = r1 < Sq ? lse[(size_t)bh * Sq + r1] : EMPTY_LSE;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const bf16* sq = sQ + (warp * 16) * LDS;
  const bf16* so = sO + (warp * 16) * LDS;
  const int mi = lane >> 3, ri = lane & 7;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < ntiles) {
      load_kv(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sk = sK + buf * BN * LDS;
    const bf16* sv = sV + buf * BN * LDS;

    // S = Q K^T and dP = dO V^T, 16 x 64 each per warp
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = dp[nt][0] = dp[nt][1] = dp[nt][2] =
          dp[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4], ao[4];
      load_a(a, sq, g, t4, ks * 16);
      load_a(ao, so, g, t4, ks * 16);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const bf16* kp = sk + (nt * 8 + g) * LDS + ks * 16 + t4 * 2;
        const bf16* vp = sv + (nt * 8 + g) * LDS + ks * 16 + t4 * 2;
        mma16816(s[nt], a, lds32(kp), lds32(kp + 8));
        mma16816(dp[nt], ao, lds32(vp), lds32(vp + 8));
      }
    }

    // P = exp(S * scale - lse), dS = P (dP - Delta), packed as bf16 A fragments
    const int kv0 = tile * BN;
    uint32_t dsf[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = kv_ok(maskb, kv0 + nt * 8 + t4 * 2 + j, Skv);
        const float p0 = ok ? __expf(s[nt][j] * scale - L0) : 0.f;
        const float p1 = ok ? __expf(s[nt][2 + j] * scale - L1) : 0.f;
        ds[j] = p0 * (dp[nt][j] - dl0);
        ds[2 + j] = p1 * (dp[nt][2 + j] - dl1);
      }
      dsf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K; K fragments via ldmatrix.trans (K is [token][d] in smem)
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
#pragma unroll
      for (int dpi = 0; dpi < D / 16; ++dpi) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, sk + (ks * 16 + (mi & 1) * 8 + ri) * LDS + dpi * 16 + (mi >> 1) * 8);
        mma16816(acc[2 * dpi], dsf[ks], kf[0], kf[1]);
        mma16816(acc[2 * dpi + 1], dsf[ks], kf[2], kf[3]);
      }
    }
    __syncthreads();
  }

  bf16* dqb = dq + qoff;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)r0 * rs + c) =
          __floats2bfloat162_rn(acc[dt][0] * scale, acc[dt][1] * scale);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)r1 * rs + c) =
          __floats2bfloat162_rn(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward, kernel 2: dK and dV

__global__ void __launch_bounds__(NTHREADS, 1)
bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                int Sq, int Skv, int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [BKV][LDS]
  bf16* sV = sK + BKV * LDS;                     // [BKV][LDS]
  bf16* sQ = sV + BKV * LDS;                     // [2][BQ][LDS]
  bf16* sO = sQ + 2 * BQ * LDS;                  // dO, [2][BQ][LDS]
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * LDS);  // [2][BQ]
  float* sD = sL + 2 * BQ;                                  // [2][BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / N, n = bh % N;
  const int kv0 = blockIdx.x * BKV;
  const size_t rs = (size_t)N * D;
  const size_t qoff = (size_t)b * Sq * rs + (size_t)n * D;
  const size_t koff = (size_t)b * Skv * rs + (size_t)n * D;
  const float* lb = lse + (size_t)bh * Sq;
  const float* db = delta + (size_t)bh * Sq;
  const uint8_t* maskb = mask == nullptr ? nullptr : mask + (size_t)b * Skv;

  // this thread's two kv rows, fixed for the whole kernel
  const int r0 = kv0 + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = kv_ok(maskb, r0, Skv), ok1 = kv_ok(maskb, r1, Skv);

  auto load_q = [&](int tile, int buf) {
    const int qs = tile * BQ;
    async_rows(sQ + buf * BQ * LDS, q + qoff, rs, qs, BQ, Sq, tid);
    async_rows(sO + buf * BQ * LDS, dout + qoff, rs, qs, BQ, Sq, tid);
    cp_async_commit();
    if (tid < BQ) {  // ragged rows: lse +1e30 makes P = 0 there
      const int row = qs + tid;
      sL[buf * BQ + tid] = row < Sq ? lb[row] : EMPTY_LSE;
      sD[buf * BQ + tid] = row < Sq ? db[row] : 0.f;
    }
  };

  async_rows(sK, k + koff, rs, kv0, BKV, Skv, tid);
  async_rows(sV, v + koff, rs, kv0, BKV, Skv, tid);
  cp_async_commit();
  const int ntiles = (Sq + BQ - 1) / BQ;
  load_q(0, 0);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = dva[i][0] = dva[i][1] = dva[i][2] =
        dva[i][3] = 0.f;
  const bf16* skw = sK + (warp * 16) * LDS;
  const bf16* svw = sV + (warp * 16) * LDS;
  const int mi = lane >> 3, ri = lane & 7;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < ntiles) {
      load_q(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sq = sQ + buf * BQ * LDS;
    const bf16* so = sO + buf * BQ * LDS;
    const float* sl = sL + buf * BQ;
    const float* sd = sD + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 32 query columns per warp
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = dpt[nt][0] = dpt[nt][1] = dpt[nt][2] =
          dpt[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t ak[4], av[4];
      load_a(ak, skw, g, t4, ks * 16);
      load_a(av, svw, g, t4, ks * 16);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const bf16* qp = sq + (nt * 8 + g) * LDS + ks * 16 + t4 * 2;
        const bf16* op = so + (nt * 8 + g) * LDS + ks * 16 + t4 * 2;
        mma16816(st[nt], ak, lds32(qp), lds32(qp + 8));
        mma16816(dpt[nt], av, lds32(op), lds32(op + 8));
      }
    }

    // P^T = exp(S^T * scale - lse[col]); dS^T = P^T (dP^T - Delta[col])
    uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + t4 * 2 + j;
        const float L = sl[col], dl = sd[col];
        p[j] = ok0 ? __expf(st[nt][j] * scale - L) : 0.f;
        p[2 + j] = ok1 ? __expf(st[nt][2 + j] * scale - L) : 0.f;
        ds[j] = p[j] * (dpt[nt][j] - dl);
        ds[2 + j] = p[2 + j] * (dpt[nt][2 + j] - dl);
      }
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO and dK += dS^T Q; B fragments via ldmatrix.trans
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks) {
#pragma unroll
      for (int dpi = 0; dpi < D / 16; ++dpi) {
        const int off = (ks * 16 + (mi & 1) * 8 + ri) * LDS + dpi * 16 + (mi >> 1) * 8;
        uint32_t of[4], qf[4];
        ldmatrix_x4_trans(of, so + off);
        ldmatrix_x4_trans(qf, sq + off);
        mma16816(dva[2 * dpi], pf[ks], of[0], of[1]);
        mma16816(dva[2 * dpi + 1], pf[ks], of[2], of[3]);
        mma16816(dka[2 * dpi], dsf[ks], qf[0], qf[1]);
        mma16816(dka[2 * dpi + 1], dsf[ks], qf[2], qf[3]);
      }
    }
    __syncthreads();
  }

  bf16* dkb = dk + koff;
  bf16* dvb = dv + koff;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)r0 * rs + c) =
          __floats2bfloat162_rn(dka[dt][0] * scale, dka[dt][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)r0 * rs + c) =
          __floats2bfloat162_rn(dva[dt][0], dva[dt][1]);
    }
    if (r1 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)r1 * rs + c) =
          __floats2bfloat162_rn(dka[dt][2] * scale, dka[dt][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)r1 * rs + c) =
          __floats2bfloat162_rn(dva[dt][2], dva[dt][3]);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// q, out: [B, Sq, N, 128] bf16; k, v: [B, Skv, N, 128] bf16; mask: [B, Skv]
// uint8 or null; lse: [B, N, Sq] f32 (written).
int longlive_flash_train_fwd(const void* q, const void* k, const void* v, const void* mask,
                             void* out, void* lse, int B, int Sq, int Skv, int N, float scale,
                             void* stream) {
  cudaError_t err = set_smem(fwd_kernel, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BM - 1) / BM, B * N);
  fwd_kernel<<<grid, NTHREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), static_cast<float*>(lse), Sq,
      Skv, N, scale);
  return (int)cudaGetLastError();
}

// dQ and Delta = rowsum(dO * O) ([B, N, Sq] f32, written).
int longlive_flash_train_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                                const void* out, const void* dout, const void* lse, void* delta,
                                void* dq, int B, int Sq, int Skv, int N, float scale,
                                void* stream) {
  cudaError_t err = set_smem(bwd_dq_kernel, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BM - 1) / BM, B * N);
  bwd_dq_kernel<<<grid, NTHREADS, DQ_SMEM, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<bf16*>(dq), Sq, Skv, N, scale);
  return (int)cudaGetLastError();
}

// dK and dV; reads the Delta the dQ kernel wrote (launch it after that one).
int longlive_flash_train_bwd_dkdv(const void* q, const void* k, const void* v, const void* mask,
                                  const void* dout, const void* lse, const void* delta, void* dk,
                                  void* dv, int B, int Sq, int Skv, int N, float scale,
                                  void* stream) {
  cudaError_t err = set_smem(bwd_dkdv_kernel, DKDV_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Skv + BKV - 1) / BKV, B * N);
  bwd_dkdv_kernel<<<grid, NTHREADS, DKDV_SMEM, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Skv, N, scale);
  return (int)cudaGetLastError();
}

const char* longlive_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
