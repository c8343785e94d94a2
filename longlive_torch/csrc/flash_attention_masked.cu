// Full-sequence self-attention under a frame-structured mask, forward only.
// Hopper (sm_90a), bf16 operands, float32 accumulation and softmax state.
//
// Replaces: longlive_tpu/ops/attention.py::_masked_flash_kernel and
// _masked_accumulate (driven by flash_attention_frame_masked), the Pallas
// kernel of the full-sequence DiT forwards (dit_forward_full and
// dit_forward_teacher_forcing).  What it computes is kept:
//   O = softmax(mask(Q' K^T)) V      Q' = bf16(q * 1/sqrt(D)), scaled by the wrapper
// with the mask computed from token indices (no mask tensor anywhere):
//   block_causal     kv frame < end of q's block [and >= end - local]
//   sink_window      kv frame < end of q's block and (kv frame < sink or
//                    kv frame >= end - (local - sink))
//   teacher_forcing  [clean | noisy] of clean_frames frames each: clean q
//                    attends clean kv of its block and earlier ones; noisy q
//                    of block i attends noisy kv of block i and clean kv of
//                    blocks < i; kv past both halves never
// and every q attends its own token (qi == ki).  Kv tokens past Skv are
// masked here: the port does not pad the sequence.
//
// Layout: q, k, v, out are contiguous [B, S, N, 128] bf16 (the linears'
// output layout, token stride N * 128, no transpose).
//
// Arithmetic (flash_attention_frame_masked_plain in ops/attention.py repeats
// it): s = q'.k in float32; masked logits get the finite -1e30; online
// softmax with a float32 running max m and sum l; P = exp(s - m) is rounded
// to bf16 for P V while l takes the unrounded P; O = acc / max(l, 1e-30).
//
// Per-element mask: for one query token each kind's allowed kv tokens are
// two intervals, [0, A) and [L, H) (token thresholds computed once per row
// from the frame arithmetic), so the mask is four integer comparisons, no
// division.  A warp whose 16 rows all allow the whole 64-token tile skips
// the per-element mask (the same values either way).
//
// Dead tiles: a CTA first evaluates, for each of its kv tiles, the per-tile
// frame-range arithmetic of ops/attention.py::frame_mask_live_tiles (the JAX
// package's _frame_mask_tile_arrays liveness, at this kernel's 128 x 64
// tiles) and compacts the live ones into a list in shared memory; the main
// loop loads and computes only those.  No host state, no device sync.  With
// elision off the list holds every tile.  Elision changes no bit: a dead
// tile's logits are all -1e30, so after a row's first unmasked entry it adds
// exactly 0 (P = exp(-1e30 - m) = 0, alpha = 1); before it, it adds finite
// state that the first unmasked entry's alpha = exp(-1e30 - m) = 0 wipes
// exactly; every real row has its diagonal.
//
// What bounds it on an H100: the teacher-forcing call of the 21-frame
// training geometry (65520 tokens, 12 heads of 128) has 28.6% of its frame
// pairs unmasked, ~7.5 TFLOP against ~0.6 GB of operands: tensor-core
// throughput bounds it (7.6 ms at 989 TFLOP/s), as it bounds the 32760-token
// sink_window and block_causal calls.
//
// Design (FlashAttention-2 style, like csrc/flash_attention_train.cu's
// forward; mma.sync m16n8k16 bf16 -> f32): one CTA per (128 query rows,
// b*n); 8 warps of 16 rows; live kv tiles of 64 tokens double buffered with
// cp.async; S stays in registers and is re-packed as the A operand of P V.
// Rows are padded by 16 bytes in shared memory.  wgmma, TMA and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int LDS = D + 8;        // padded shared-memory row, in bf16
constexpr int NTHREADS = 256;     // 8 warps
constexpr int BM = 128;           // query rows per CTA
constexpr int BN = 64;            // kv tokens per tile
constexpr int MAX_TILES = 4096;   // kv tiles a CTA can list (262144 tokens)
constexpr int NWORDS = MAX_TILES / 32;
constexpr float NEG = -1e30f;

enum { BLOCK_CAUSAL = 0, SINK_WINDOW = 1, TEACHER_FORCING = 2 };

typedef __nv_bfloat16 bf16;

constexpr size_t TILE_SMEM = sizeof(bf16) * (size_t)(BM + 4 * BN) * LDS;
constexpr size_t SMEM = TILE_SMEM + sizeof(uint16_t) * MAX_TILES + sizeof(uint32_t) * NWORDS +
                        sizeof(int) * (NWORDS + 1);

struct Mask {
  int kind, fs, nfb, local, sink, clean_frames;
};

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

// One half [start, end) of the [clean | noisy] sequence: does [lo, hi) reach
// into it, and the first and last block (blk tokens, counted from start) it
// reaches there.
__device__ __forceinline__ bool tf_part(int lo, int hi, int start, int end, int blk, int& b0,
                                        int& b1) {
  const int a = max(lo, start), b = min(hi, end);
  b0 = (a - start) / blk;
  b1 = (b - 1 - start) / blk;
  return b > a;
}

// Is the tile [q_lo, q_hi) x [k_lo, k_hi) live: does the mask leave any pair
// of it unmasked, or does it hold a q == kv pair?  The frame-range arithmetic
// of ops/attention.py::frame_mask_live_tiles, term by term.
__device__ bool tile_live(const Mask& mk, int q_lo, int q_hi, int k_lo, int k_hi) {
  bool alive;
  if (mk.kind == TEACHER_FORCING) {
    const int cl = mk.clean_frames * mk.fs, blk = mk.fs * mk.nfb;
    int qc0, qc1, qn0, qn1, kc0, kc1, kn0, kn1;
    const bool qc = tf_part(q_lo, q_hi, 0, cl, blk, qc0, qc1);
    const bool qn = tf_part(q_lo, q_hi, cl, 2 * cl, blk, qn0, qn1);
    const bool kc = tf_part(k_lo, k_hi, 0, cl, blk, kc0, kc1);
    const bool kn = tf_part(k_lo, k_hi, cl, 2 * cl, blk, kn0, kn1);
    alive = (qc && kc && kc0 <= qc1) || (qn && kn && kn0 <= qn1 && kn1 >= qn0) ||
            (qn && kc && kc0 < qn1);
  } else {
    const int qf_lo = q_lo / mk.fs, qf_hi = (q_hi - 1) / mk.fs;
    const int kf_lo = k_lo / mk.fs, kf_hi = (k_hi - 1) / mk.fs;
    const int ends_lo = (qf_lo / mk.nfb + 1) * mk.nfb, ends_hi = (qf_hi / mk.nfb + 1) * mk.nfb;
    if (mk.kind == BLOCK_CAUSAL) {
      alive = kf_hi >= (mk.local != -1 ? ends_lo - mk.local : 0) && kf_lo < ends_hi;
    } else {
      alive = kf_lo < min(mk.sink, ends_hi) ||
              (kf_hi >= ends_lo - (mk.local - mk.sink) && kf_lo < ends_hi);
    }
  }
  return alive || (q_lo < k_hi && k_lo < q_hi);
}

// The kv tokens query token qi attends (its own token aside): [0, A) and
// [L, H), from the frame arithmetic of _masked_accumulate in token units.
__device__ void row_intervals(const Mask& mk, int qi, int& A, int& L, int& H) {
  if (mk.kind == TEACHER_FORCING) {
    const int cl = mk.clean_frames * mk.fs, blk = mk.fs * mk.nfb;
    if (qi < cl) {
      A = min(cl, (qi / blk + 1) * blk);  // clean kv of its block and the earlier ones
      L = H = 0;
    } else {
      const int b0 = (qi - cl) / blk * blk;
      A = min(cl, b0);                          // clean kv of the earlier blocks
      L = cl + b0;                              // noisy kv of its own block
      H = min(2 * cl, cl + b0 + blk);
    }
    return;
  }
  const int ends = (qi / mk.fs / mk.nfb + 1) * mk.nfb;  // in frames
  if (mk.kind == BLOCK_CAUSAL) {
    if (mk.local == -1) {
      A = ends * mk.fs;
      L = H = 0;
    } else {
      A = 0;
      L = (ends - mk.local) * mk.fs;
      H = ends * mk.fs;
    }
  } else {
    A = min(ends, mk.sink) * mk.fs;
    L = (ends - (mk.local - mk.sink)) * mk.fs;
    H = ends * mk.fs;
  }
}

__device__ __forceinline__ bool attends(int A, int L, int H, int ki) {
  return ki < A || (ki >= L && ki < H);
}

// all of [k0, k0 + BN) attended by a row with intervals (A, L, H)
__device__ __forceinline__ bool covers(int A, int L, int H, int k0) {
  return k0 + BN <= A || (k0 >= L && k0 + BN <= H);
}

__global__ void __launch_bounds__(NTHREADS, 1)
masked_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              bf16* __restrict__ out, int Sq, int Skv, int N, Mask mk, int elide) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BM][LDS]
  bf16* sK = sQ + BM * LDS;                      // [2][BN][LDS]
  bf16* sV = sK + 2 * BN * LDS;                  // [2][BN][LDS]
  uint16_t* sList = reinterpret_cast<uint16_t*>(smem_raw + TILE_SMEM);  // live tiles
  uint32_t* sWord = reinterpret_cast<uint32_t*>(sList + MAX_TILES);    // liveness bits
  int* sOff = reinterpret_cast<int*>(sWord + NWORDS);                  // list offset per word

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / N, n = bh % N;
  const int q0 = blockIdx.x * BM;
  const size_t rs = (size_t)N * D;  // token stride
  const bf16* qb = q + (size_t)b * Sq * rs + (size_t)n * D;
  bf16* ob = out + (size_t)b * Sq * rs + (size_t)n * D;
  const bf16* kb = k + (size_t)b * Skv * rs + (size_t)n * D;
  const bf16* vb = v + (size_t)b * Skv * rs + (size_t)n * D;

  async_rows(sQ, qb, rs, q0, BM, Sq, tid);
  cp_async_commit();

  // the live-tile list: one ballot per 32 tiles, then offsets, then compaction
  const int ntiles = (Skv + BN - 1) / BN, nwords = (ntiles + 31) / 32;
  for (int t = tid; t < nwords * 32; t += NTHREADS) {
    const bool live = t < ntiles && (!elide || tile_live(mk, q0, q0 + BM, t * BN, t * BN + BN));
    const uint32_t word = __ballot_sync(0xffffffffu, live);
    if (lane == 0) sWord[t >> 5] = word;
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int w = 0; w < nwords; ++w) {
      sOff[w] = acc;
      acc += __popc(sWord[w]);
    }
    sOff[nwords] = acc;
  }
  __syncthreads();
  for (int t = tid; t < nwords * 32; t += NTHREADS) {
    const uint32_t word = sWord[t >> 5];
    if ((word >> lane) & 1u) sList[sOff[t >> 5] + __popc(word & ((1u << lane) - 1u))] = (uint16_t)t;
  }
  __syncthreads();
  const int nlive = sOff[nwords];

  auto load_kv = [&](int tile, int buf) {
    async_rows(sK + buf * BN * LDS, kb, rs, tile * BN, BN, Skv, tid);
    async_rows(sV + buf * BN * LDS, vb, rs, tile * BN, BN, Skv, tid);
    cp_async_commit();
  };
  if (nlive > 0) load_kv(sList[0], 0);

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  int A0, L0, H0, A1, L1, H1;
  row_intervals(mk, r0, A0, L0, H0);
  row_intervals(mk, r1, A1, L1, H1);

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  uint32_t qf[D / 16][4];
  const bf16* sq = sQ + (warp * 16) * LDS;

  for (int j = 0; j < nlive; ++j) {
    const int buf = j & 1;
    if (j + 1 < nlive) {
      load_kv(sList[j + 1], buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) load_a(qf[ks], sq, g, t4, ks * 16);
    }
    const bf16* sk = sK + buf * BN * LDS;
    const bf16* sv = sV + buf * BN * LDS;
    const int kv0 = sList[j] * BN;

    // S = Q' K^T: 16 x 64 per warp
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kp = sk + (nt * 8 + g) * LDS + t4 * 2;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma16816(s[nt], qf[ks], lds32(kp + ks * 16), lds32(kp + ks * 16 + 8));
    }

    // mask (skipped when every row of the warp attends the whole tile), row max
    const bool whole = __all_sync(0xffffffffu, kv0 + BN <= Skv && covers(A0, L0, H0, kv0) &&
                                                   covers(A1, L1, H1, kv0));
    if (!whole) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = kv0 + nt * 8 + t4 * 2 + jj;
          if (!((c < Skv && attends(A0, L0, H0, c)) || c == r0)) s[nt][jj] = NEG;
          if (!((c < Skv && attends(A1, L1, H1, c)) || c == r1)) s[nt][2 + jj] = NEG;
        }
      }
    }
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

    // P = exp(S - m) as bf16 A fragments of P V; l takes the unrounded P
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
  cp_async_wait<0>();  // the q tile of a CTA with no live tile

  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
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
}

}  // namespace

extern "C" {

// q, k, v, out: [B, S, N, 128] bf16, q pre-scaled by 1/sqrt(128) and
// rounded to bf16; kind: 0 block_causal, 1 sink_window, 2 teacher_forcing;
// elide: skip the dead tiles.
int longlive_flash_masked(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                          int Skv, int N, int kind, int frame_seq, int nfb, int local, int sink,
                          int clean_frames, int elide, void* stream) {
  if ((Skv + BN - 1) / BN > MAX_TILES) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(masked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const Mask mk{kind, frame_seq, nfb, local, sink, clean_frames};
  dim3 grid((Sq + BM - 1) / BM, B * N);
  masked_kernel<<<grid, NTHREADS, SMEM, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Sq, Skv, N, mk, elide);
  return (int)cudaGetLastError();
}

const char* longlive_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
