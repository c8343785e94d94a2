// Flash attention of a block's queries over one layer of the KV cache, with
// an additive float32 bias per KV token.  Hopper (sm_90a), bf16 in, bf16 out,
// float32 softmax state.
//
// Replaces: longlive_tpu/ops/attention.py::_flash_kernel (the Pallas TPU
// kernel) in its bias + kv_layer mode, the mode every self-attention of the
// cached DiT forward runs in.
//
// Semantics kept from the TPU kernel:
//   * q is pre-scaled by 1/sqrt(D) and rounded to bf16 (done here while the
//     q tile is staged, so no separate pass over q exists);
//   * logits are float32 q.k plus the bias; masked tokens carry the finite
//     -1e30, never -inf, so a fully masked tile cannot produce NaN in the
//     running max or the rescale factor;
//   * P is rounded to bf16 before the PV product, the row sum uses the
//     unrounded float32 P, and the output is divided by the row sum once at
//     the end.
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
// ldmatrix reads are free of bank conflicts.  wgmma, TMA and warp
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
constexpr size_t SMEM_BYTES = sizeof(__nv_bfloat16) * (size_t)(BM + 4 * BN) * LDS;

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

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int Sq, int N, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LDS]
  __nv_bfloat16* sK = sQ + BM * LDS;                                 // [2][BN][LDS]
  __nv_bfloat16* sV = sK + 2 * BN * LDS;                             // [2][BN][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / N, n = bh % N;
  const int q0 = blockIdx.x * BM;
  const size_t row_stride = (size_t)N * D;  // q / out token stride
  const __nv_bfloat16* qb = q + (size_t)b * Sq * row_stride + (size_t)n * D;
  __nv_bfloat16* ob = out + (size_t)b * Sq * row_stride + (size_t)n * D;
  const __nv_bfloat16* kb = k + (size_t)bh * S * D;
  const __nv_bfloat16* vb = v + (size_t)bh * S * D;
  const float* biasb = bias + (size_t)b * S;

  auto load_kv = [&](int tile, int buf) {
    const int kv0 = tile * BN;
    for (int i = tid; i < BN * (D / 8); i += NTHREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = kv0 + r < S;
      const size_t off = (size_t)(ok ? kv0 + r : 0) * D + c;
      cp_async16(sK + (buf * BN + r) * LDS + c, kb + off, ok);
      cp_async16(sV + (buf * BN + r) * LDS + c, vb + off, ok);
    }
    cp_async_commit();
  };

  const int ntiles = (S + BN - 1) / BN;
  load_kv(0, 0);

  // stage q: bf16(float(q) * scale), ragged rows zero
  for (int i = tid; i < BM * (D / 8); i += NTHREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq) {
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * row_stride + c);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(sQ + r * LDS + c) = val;
  }
  __syncthreads();

  // this warp's 16 query rows as A fragments, 8 k-steps over D
  uint32_t qf[D / 16][4];
  {
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

  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < ntiles) {
      load_kv(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sk = sK + buf * BN * LDS;
    const __nv_bfloat16* sv = sV + buf * BN * LDS;

    // S = Q K^T: 16 x 64 per warp, 8 n-tiles of 8 tokens
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kp = sk + (nt * 8 + g) * LDS + t4 * 2;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma16816(s[nt], qf[ks], lds32(kp + ks * 16), lds32(kp + ks * 16 + 8));
    }

    // bias (ragged tail: -1e30), tile row max
    const int kv0 = tile * BN;
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = kv0 + nt * 8 + t4 * 2 + j;
        const float bv = col < S ? __ldg(biasb + col) : NEG;
        s[nt][j] += bv;
        s[nt][2 + j] += bv;
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

}  // namespace

extern "C" {

// q, out: [B, Sq, N, 128] bf16; k, v: [B*N, S, 128] bf16; bias: [B, S] f32.
int longlive_flash_attention(const void* q, const void* k, const void* v, const void* bias,
                             void* out, int B, int Sq, int N, int S, float scale,
                             void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BM - 1) / BM, B * N);
  flash_attention_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), Sq, N, S, scale);
  return (int)cudaGetLastError();
}

const char* longlive_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
