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
// division.  A warp whose 16 rows all attend the whole 128-token tile skips
// the per-element mask (the same values either way).
//
// Dead tiles: a CTA first evaluates, for each of its kv tiles, the per-tile
// frame-range arithmetic of ops/attention.py::frame_mask_live_tiles (the JAX
// package's _frame_mask_tile_arrays liveness, at this kernel's 128 x 128
// tiles) and compacts the live ones into a list in shared memory; the
// producer loads and the consumers compute only those.  No host state, no
// device sync.  With elision off the list holds every tile.  Elision changes
// no bit: a dead tile's logits are all -1e30, so after a row's first
// unmasked entry it adds exactly 0 (P = exp(-1e30 - m) = 0, alpha = 1);
// before it, it adds finite state that the first unmasked entry's
// alpha = exp(-1e30 - m) = 0 wipes exactly; every real row has its diagonal.
//
// What bounds it on an H100: the teacher-forcing call of the 21-frame
// training geometry (65520 tokens, 12 heads of 128) has 28.6% of its frame
// pairs unmasked, ~7.5 TFLOP against ~0.6 GB of operands: tensor-core
// throughput bounds it (7.6 ms at 989 TFLOP/s), as it bounds the 32760-token
// sink_window and block_causal calls.  Only wgmma reaches that rate, and the
// work is uneven: a teacher-forcing q tile has 37 to 294 live kv tiles.
//
// Design: K4's forward pipeline (flash_fwd_sm90.cuh): 384 threads, two
// consumer warpgroups of 64 query rows on wgmma (S = Q K^T m64n128, the
// softmax in registers, O += P V with P from registers) and a producer warp
// that stages Q once and streams the listed K/V tiles of 128 tokens through
// a 2-stage mbarrier ring by TMA (rows past S arrive as zeros).  The CTAs
// run heaviest first: the wrapper passes the q tiles in descending order of
// their live-tile count (ops/attention.py::frame_mask_cta_order), so the
// long CTAs start in the first wave and the short ones fill the tail.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"  // K4's forward pipeline: producer, S = Q K^T, softmax and P V
#include "sm90.cuh"

namespace {

constexpr int D = FWD_D;
constexpr int BM = FWD_BM;        // query rows per CTA
constexpr int BN = FWD_BN;        // kv tokens per tile
constexpr int THREADS = 384;      // consumer warpgroups 0-1, producer warpgroup 2
constexpr int STAGES = 2;
constexpr int MAX_TILES = 2048;   // kv tiles a CTA can list (262144 tokens)
constexpr int NWORDS = MAX_TILES / 32;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

enum { BLOCK_CAUSAL = 0, SINK_WINDOW = 1, TEACHER_FORCING = 2 };

typedef __nv_bfloat16 bf16;

constexpr int META = 8 * (1 + 2 * STAGES) + 2 * MAX_TILES + 4 * NWORDS + 4 * (NWORDS + 1);
constexpr size_t SMEM = 1024 + BM * FWD_ROWB + STAGES * FWD_STAGE + META;

struct Mask {
  int kind, fs, nfb, local, sink, clean_frames;
};

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

// Lists the kv tiles of q tile [q0, q0 + BM) that the mask leaves live
// (every tile when elide is 0) in sList, in order: one ballot per 32 tiles,
// a prefix over the words, then compaction.  Every thread of the CTA takes
// part; the barriers make the list (and the mbarriers initialised before the
// call) visible to all.  Returns the count.
__device__ int list_live_tiles(const Mask& mk, int q0, int Skv, int elide, uint16_t* sList,
                               uint32_t* sWord, int* sOff) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int ntiles = (Skv + BN - 1) / BN, nwords = (ntiles + 31) / 32;
  for (int t = tid; t < nwords * 32; t += THREADS) {
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
  for (int t = tid; t < nwords * 32; t += THREADS) {
    const uint32_t word = sWord[t >> 5];
    if ((word >> lane) & 1u) sList[sOff[t >> 5] + __popc(word & ((1u << lane) - 1u))] = (uint16_t)t;
  }
  __syncthreads();
  return sOff[nwords];
}

// grid: (B * N, q tiles); blockIdx.y walks the q tiles in the order of
// `order` (heaviest first).
__global__ void __launch_bounds__(THREADS, 1)
frame_masked_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const int* __restrict__ order,
                    bf16* __restrict__ out, int Sq, int Skv, int N, Mask mk, int elide) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  const uint32_t ring = sQ + BM * FWD_ROWB;
  uint8_t* meta = smem_raw + (ring - raw) + STAGES * FWD_STAGE;
  const uint32_t qbar = smem_u32(meta), full = qbar + 8, empty = full + 8 * STAGES;
  uint16_t* sList = reinterpret_cast<uint16_t*>(meta + 8 * (1 + 2 * STAGES));
  uint32_t* sWord = reinterpret_cast<uint32_t*>(sList + MAX_TILES);
  int* sOff = reinterpret_cast<int*>(sWord + NWORDS);

  const int bh = blockIdx.x, b = bh / N, n = bh % N;
  const int q0 = __ldg(order + blockIdx.y) * BM;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int nlive = list_live_tiles(mk, q0, Skv, elide, sList, sWord, sOff);

  if (threadIdx.x >= 256) {  // producer warpgroup: one thread issues every TMA load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256)
      fwd_produce<STAGES>(&qmap, &kmap, &vmap, sQ, ring, qbar, full, empty, q0, n, b, nlive,
                          [&](int i) { return (int)sList[i]; });
    return;
  }

  // consumer warpgroups: 64 query rows each
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  int A0, L0, H0, A1, L1, H1;
  row_intervals(mk, r0, A0, L0, H0);
  row_intervals(mk, r1, A1, L1, H1);
  float o[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // l per thread, summed at the end
  mbar_wait(qbar, 0);
  for (int i = 0; i < nlive; ++i) {
    const int s = i % STAGES;
    const uint32_t kt = ring + s * FWD_STAGE, vt = kt + FWD_KV;
    const int kv0 = sList[i] * BN;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);

    float sc[BN / 2];
    fwd_scores(sc, sQ, wg, kt);
    // the per-element mask, unless every row of the warp attends the whole tile
    const bool whole = __all_sync(0xffffffffu, kv0 + BN <= Skv && covers(A0, L0, H0, kv0) &&
                                                   covers(A1, L1, H1, kv0));
    if (!whole) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = kv0 + j * 8 + tq * 2 + c;
          if (!((col < Skv && attends(A0, L0, H0, col)) || col == r0)) sc[4 * j + c] = NEG;
          if (!((col < Skv && attends(A1, L1, H1, col)) || col == r1)) sc[4 * j + 2 + c] = NEG;
        }
      }
    }
    fwd_softmax_pv(sc, o, m0, m1, l0, l1, vt);
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  const size_t rs = (size_t)N * D;  // token stride
  bf16* ob = out + (size_t)b * Sq * rs + (size_t)n * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + tq * 2;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * rs + c) =
          __floats2bfloat162_rn(o[4 * j] * i0, o[4 * j + 1] * i0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * rs + c) =
          __floats2bfloat162_rn(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
}

}  // namespace

extern "C" {

// q, k, v, out: [B, S, N, 128] bf16, q pre-scaled by 1/sqrt(128) and
// rounded to bf16; order: the ceil(Sq / 128) q tiles, int32 on the device,
// in launch order; kind: 0 block_causal, 1 sink_window, 2 teacher_forcing;
// elide: skip the dead tiles.
int longlive_flash_masked(const void* q, const void* k, const void* v, void* out,
                          const void* order, int B, int Sq, int Skv, int N, int kind,
                          int frame_seq, int nfb, int local, int sink, int clean_frames,
                          int elide, void* stream) {
  if ((Skv + BN - 1) / BN > MAX_TILES) return (int)cudaErrorInvalidValue;
  // a runtime call first: it makes the device's context current on this
  // thread, which the driver's tensor-map encoder needs
  const cudaError_t err = cudaFuncSetAttribute(
      frame_masked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm;
  if (!rows_map(&qm, q, B, Sq, N, BM) || !rows_map(&km, k, B, Skv, N, BN) ||
      !rows_map(&vm, v, B, Skv, N, BN))
    return (int)cudaErrorInvalidValue;
  const Mask mk{kind, frame_seq, nfb, local, sink, clean_frames};
  dim3 grid(B * N, (Sq + BM - 1) / BM);
  frame_masked_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      qm, km, vm, static_cast<const int*>(order), static_cast<bf16*>(out), Sq, Skv, N, mk,
      elide);
  return (int)cudaGetLastError();
}

const char* longlive_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
