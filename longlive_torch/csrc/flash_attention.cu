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
//   * q is pre-scaled by 1/sqrt(D) and rounded to bf16 (done in the
//     prologue, on the staged q tile, so no separate pass over q exists);
//   * q_rope mode (cos, sin given, [Sq, 64] f32 indexed by query row, shared
//     by every head): q arrives un-roped and the staged tile is
//     bf16(q * cs + swap(q) * sn) with cs = scale * [cos ++ cos],
//     sn = scale * [-sin ++ sin] and swap exchanging the two 64-wide halves
//     (the halfsplit rotation, softmax scale folded in).  Each product and
//     the sum are rounded separately (__fmul_rn / __fadd_rn, no FMA
//     contraction), as the plain PyTorch version and XLA's separate
//     multiply and add compute it;
//   * logits are float32 q.k plus the bias (the bf16 modes start QK^T's
//     float32 accumulator from the bias); masked tokens carry the finite
//     -1e30, never -inf, so a fully masked tile cannot produce NaN in the
//     running max or the rescale factor;
//   * P is rounded to bf16 before the PV product, the row sum uses the
//     unrounded float32 P, and the output is divided by the row sum once at
//     the end;
//   * qk_int8 mode: q is quantized per (token, head) over D in the prologue,
//     bit for bit as the wrapper's plain pass (ops/attention.py::
//     _qk_int8_operands) computes it: q pre-scaled and rounded to bf16,
//     amax = max|q| + 1e-30, q8 = rint(q * (127 / amax)) with one IEEE
//     division, scale amax * (1/127); K int8 with one float32 scale per
//     (head, token).  The logits are
//     (float(int32 q.k) * qscale[row]) * kscale[col] + bias[col], each
//     product and the sum rounded separately.  P and PV are the bf16 path;
//   * two-segment mode (k2, v2 given, [B, S2, N, D] as the block's roped K
//     and its V come out of the projections): after the cache's tiles the
//     CTA walks the S2 tokens of the second segment in the same online
//     softmax, read in their token-major layout by their own tensor maps
//     (no transposed copy of the block exists).  Its bias is 0 and its
//     ragged tail -1e30 (finite: in a block's first forward no cache token
//     is valid, so the state must come out of segment 2 free of NaN).  In
//     the qk_int8 mode k2 arrives quantized per (token, head) with scales
//     [B, S2, N];
//   * dead-tile elision (use_skip): the host's live-tile mask names the
//     cache tiles of 64 tokens that the disjoint skip ranges cover
//     completely (the block's own slots).  This kernel's tile is 128 tokens:
//     it is dead, neither loaded nor computed, when both of its 64-token
//     halves are.  Tiles that are only partly covered are computed and the
//     bias masks them, so elision changes no result;
//   * exp2 (EXP2): the wrapper folds log2(e) into the softmax scale (so into
//     q's bf16 rounding, the q_rope multipliers or q's int8 quantization),
//     the kernel multiplies the bias by log2(e) (one float32 product, as the
//     TPU kernel's wrapper does) and takes ex2.approx instead of
//     exp = ex2.approx(x * log2 e);
//   * mxu_lsum (LSUM): the row sum is the float32 sum of P rounded to bf16,
//     taken on the tensor cores, the TPU kernel's p.astype(v.dtype) @ ones:
//     P V runs 136 columns wide (m64n136k16), V's 128 and 8 of bf16 ones
//     staged after V in each stage, so the accumulator's last columns carry
//     the row sums, rescaled with O (1/16 more than P V).
//
// What bounds it on an H100: at the decode shape (q 4680 x 12 heads, cache
// 18720 tokens, D = 128) the work is ~0.54 TFLOP against ~0.12 GB of
// operands, about 4,600 operations per byte: far above the card's ~295
// operations per byte, so tensor-core throughput bounds it, and only wgmma
// reaches the tensor cores' full rate.  The two-segment decode attends the
// same 18720 valid tokens (14040 of the cache + the block's 4680) when the
// block's 4680 dead cache slots are elided.
//
// Design (FlashAttention-3's shape, as K4's forward in
// flash_attention_train.cu): a CTA per item (128 query rows, b*n), 384
// threads.  Consumer warpgroups 0 and 1 own 64 query rows each and compute
// on wgmma with f32 accumulators in registers; warpgroup 2 hands its
// registers back (setmaxnreg) and its first warp is the producer, which
// keeps TMA loads of K/V tiles of 128 tokens in flight through a 2-stage
// ring of shared memory with mbarriers (full: the bytes arrived; empty: both
// consumer warpgroups' wgmma that read the stage completed).  The producer
// warp also stages each tile's per-column terms in the stage: the additive
// term (the bias, times log2 e under exp2; 0 in segment 2; -1e30 past either
// segment's end) and, in the qk_int8 mode, K's scale; so the consumers never
// index a segment and the tile list (live cache tiles, then segment 2) is
// the producer's alone.  Operands are 4-D tensor maps: q and out, k2 and v2
// over [B, S, N, 128] (dims {128, N, S, B}); the cache layer's
// [B*N, S, 128] rows the same map with N = 1.  A bf16 tile of R rows is two
// boxes of 64 columns, [R][128 bytes] each, swizzled 128B; an int8 tile one
// box of all 128 columns; TMA zero-fills rows past S (and past Sq), so the
// ragged tails need no halo code.  S = Q K^T reads both tiles K-major
// (m64n128k16 bf16, or m64n128k32 s8 x s8 -> s32 in the qk_int8 mode: the
// s32 fragment has the f32 layout, so the softmax is shared); P V reads V
// MN-major through the transpose bit, with P rounded to bf16 as the A
// operand from registers.  The warpgroups take turns at issuing S = Q K^T
// (two named barriers, FlashAttention-3's ping-pong), so one's softmax runs
// under the other's products.  The q prologue (the scale, the rotation or
// the quantization) runs once per CTA on the staged tile: it rewrites it in
// place (bf16) or into an int8 tile, through generic-proxy stores into the
// swizzled layout (a logical 16-byte chunk c of row r lies at chunk
// c ^ (r & 7)), fenced to the async proxy before the first wgmma.
// The grid: at the decode, 37 q tiles x 12 heads = 444 items fill 3.36
// waves of 132 SMs.  The items of the last, part-empty wave are split over
// 2-4 CTAs along the tile list (ops/attention.py::split_plan picks the
// split); each such CTA keeps its unnormalised O, running max and sum in a
// workspace, and the last to finish (an atomic count per item) merges them
// as the online softmax merges tiles, every share in share order, so the
// bits do not depend on which share finished last.
// The registers bound the tiles: ptxas gives a 384-thread CTA's consumers
// about 168 registers, and one 64 x 128 S beside one 64 x 128 O accumulator
// take 128 of them, so a warpgroup waits on each product before the next
// (FlashAttention-3's overlap of a warpgroup's softmax with its own next
// product needs a second S); on an H100 the softmax's exponentials (16384
// per tile on 16 units per SM) and its other float work, not the loads,
// hold it below the tensor cores' rate.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // mbarriers, TMA, tensor maps, wgmma and its descriptors

// Bit i of word i / 32 is set when cache tile i (tokens [64 i, 64 i + 64))
// is computed.  Passed by value in the kernel's parameters; at global scope,
// since the exported entry point takes it (64 words: 131072 cache tokens).
struct LiveTiles {
  uint32_t bits[64];
};

namespace {

constexpr int D = 128;
constexpr int ROWB = D * 2;     // bytes of one bf16 token row of one head
constexpr int THREADS = 384;    // consumer warpgroups 0-1, producer warpgroup 2
constexpr int BM = 128;         // query rows per CTA, 64 per consumer warpgroup
constexpr int BN = 128;         // kv tokens per tile: two 64-token tiles of the live mask
constexpr int STAGES = 2;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

typedef __nv_bfloat16 bf16;

// Shared memory from a 1024-byte-aligned base: the q tile as TMA brings it
// (bf16, two boxes); in the qk_int8 mode the quantized q tile (one box);
// the ring of stages, each a K tile, a V tile and, under mxu_lsum, a block
// of bf16 ones right after V (P V's B operand read 136 columns wide: the
// ones are its last 8); then the barriers, the stages' per-column terms,
// the int8 mode's q scales and the split flag.
template <bool INT8, bool LSUM>
struct Smem {
  static constexpr int Q = BM * ROWB;
  static constexpr int Q8 = INT8 ? BM * D : 0;
  static constexpr int KT = BN * (INT8 ? D : ROWB);
  static constexpr int VT = BN * ROWB;
  static constexpr int ONES = LSUM ? BN * 128 : 0;
  static constexpr int STAGE = KT + VT + ONES;
  static constexpr int BARS = 8 * (1 + 2 * STAGES);
  static constexpr size_t BYTES =
      1024 + Q + Q8 + STAGES * STAGE + BARS + 4 * (2 * STAGES * BN + BM + 1);
};

// A split item's partial result in the workspace: per tile row, the
// unnormalised output (D floats), then per row its running max and sum.
constexpr int PART = BM * (D + 2);

// D += A B, m64n136k16: A from registers, B MN-major in shared memory (the
// transpose bit): V's 128 columns, then 8 columns of ones, so d[64..67]
// accumulate the row sums of the bf16 A (mxu_lsum).
__device__ __forceinline__ void wgmma_rs_n136(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67"
      "}, {%68, %69, %70, %71}, %72, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

// Is cache tile t (128 tokens) live: either of its 64-token halves is.
__device__ __forceinline__ bool tile_live(const LiveTiles& live, int use_skip, int t) {
  return !use_skip || ((live.bits[t >> 4] >> ((2 * t) & 31)) & 3u) != 0u;
}

// The cache tiles a CTA computes: every one, or the live ones.
__device__ __forceinline__ int live_count(const LiveTiles& live, int use_skip, int nt1) {
  if (!use_skip) return nt1;
  int count = 0;
  for (int w = 0; w < (2 * nt1 + 31) / 32; ++w)
    count += __popc((live.bits[w] | (live.bits[w] >> 1)) & 0x55555555u);
  return count;
}

// Barrier of the 256 consumer threads (id 3).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// The consumer warpgroups' turns at the tensor cores (ids 4 and 5, 256
// threads: the 128 of the warpgroup waiting, the 128 of the other arriving).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(4 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(5 - wg) : "memory");
}

// INT8 = false: K is bf16; q_rope when rope_cos is given.  INT8 = true: K is
// int8 with kscale [B*N, S] (k2 with k2scale [B, S2, N]) and q is quantized
// in the prologue (also written to q8_out / qs_out when given).  The grid
// is 1-D over items (b*n, q tile), q tiles fastest: items [0, nfull) have
// one CTA each, every later one ksplit CTAs, each walking its share of the
// item's tile list; the last of them to finish (counters: zero at the
// launch, and zero again at the end) merges the shares kept in `part` and
// writes the output.
template <bool INT8, bool EXP2, bool LSUM>
__global__ void __launch_bounds__(THREADS, 1)
serving_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap k2map,
                         const __grid_constant__ CUtensorMap v2map,
                         const float* __restrict__ bias, const float* __restrict__ rope_cos,
                         const float* __restrict__ rope_sin, const float* __restrict__ kscale,
                         const float* __restrict__ k2scale,
                         const __grid_constant__ LiveTiles live, int use_skip,
                         bf16* __restrict__ out, int8_t* __restrict__ q8_out,
                         float* __restrict__ qs_out, float* __restrict__ part,
                         int* __restrict__ counters, int Sq, int N, int S, int S2, int nq,
                         int nfull, int ksplit, float scale) {
  using L = Smem<INT8, LSUM>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  const uint32_t sQ8 = sQ + L::Q;
  const uint32_t ring = sQ8 + L::Q8;
  uint8_t* meta = smem_raw + (ring + STAGES * L::STAGE - raw);
  const uint32_t qbar = smem_u32(meta), full = qbar + 8, empty = full + 8 * STAGES;
  float* sAdd = reinterpret_cast<float*>(meta + L::BARS);  // [STAGES][BN]
  float* sKs = sAdd + STAGES * BN;                          // [STAGES][BN]
  float* sQs = sKs + STAGES * BN;                           // [BM]
  int* sLast = reinterpret_cast<int*>(sQs + BM);            // this CTA merges the shares

  int item = blockIdx.x, share = 0, nshares = 1;
  if (item >= nfull) {
    item = nfull + (blockIdx.x - nfull) / ksplit;
    share = (blockIdx.x - nfull) % ksplit;
    nshares = ksplit;
  }
  const int bh = item / nq, b = bh / N, n = bh % N;
  const int q0 = (item % nq) * BM;
  const int nt1 = (S + BN - 1) / BN, nt2 = (S2 + BN - 1) / BN;
  const int nlive = live_count(live, use_skip, nt1);
  // this CTA's share [t_begin, t_end) of the item's tile list: the live
  // cache tiles, then segment 2's
  const int ntiles = nlive + nt2;
  const int t_begin = share * ntiles / nshares, t_end = (share + 1) * ntiles / nshares;
  const int nwalk = t_end - t_begin;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup: warp 8 stages the terms and issues TMA
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(qbar, BM * ROWB);
        load_rows<BM>(sQ, &qmap, qbar, q0, n, b);
      }
      const float* biasb = bias + (size_t)b * S;
      const float* kscb = INT8 ? kscale + (size_t)bh * S : nullptr;
      int t = 0;  // the next cache tile to consider
      for (int i = 0; i < t_end; ++i) {
        while (t < nt1 && !tile_live(live, use_skip, t)) ++t;
        const bool seg2 = i >= nlive;
        const int kv0 = (seg2 ? i - nlive : t++) * BN;
        if (i < t_begin) continue;  // another CTA's share
        // the tile's additive terms (and K scales), read before the stage is free
        float add[BN / 32], ks[BN / 32];
#pragma unroll
        for (int x = 0; x < BN / 32; ++x) {
          const int col = kv0 + x * 32 + lane;
          ks[x] = 0.f;
          if (seg2) {
            add[x] = col < S2 ? 0.f : NEG;
            if (INT8 && col < S2) ks[x] = __ldg(k2scale + ((size_t)b * S2 + col) * N + n);
          } else {
            add[x] = NEG;
            if (col < S) {
              add[x] = EXP2 ? __fmul_rn(__ldg(biasb + col), LOG2E) : __ldg(biasb + col);
              if (INT8) ks[x] = __ldg(kscb + col);
            }
          }
        }
        const int s = (i - t_begin) % STAGES, round = (i - t_begin) / STAGES;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
#pragma unroll
        for (int x = 0; x < BN / 32; ++x) {
          sAdd[s * BN + x * 32 + lane] = add[x];
          if (INT8) sKs[s * BN + x * 32 + lane] = ks[x];
        }
        __syncwarp();  // the lanes' stores precede lane 0's arrival on full
        if (lane == 0) {
          const uint32_t dst = ring + s * L::STAGE;
          const CUtensorMap* km = seg2 ? &k2map : &kmap;
          const CUtensorMap* vm = seg2 ? &v2map : &vmap;
          const int hn = seg2 ? n : 0, hb = seg2 ? b : bh;  // map coordinates of the head
          mbar_expect_tx(full + 8 * s, L::KT + L::VT);
          if (INT8)
            tma_load_4d(dst, km, full + 8 * s, 0, hn, kv0, hb);
          else
            load_rows<BN>(dst, km, full + 8 * s, kv0, hn, hb);
          load_rows<BN>(dst + L::KT, vm, full + 8 * s, kv0, hn, hb);
        }
        __syncwarp();
      }
    }
    return;
  }

  // consumer warpgroups: 64 query rows each
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  uint8_t* q_tile = smem_raw + (sQ - raw);
  if constexpr (LSUM) {  // every stage's block of ones: bf16 1.0
    for (int x = threadIdx.x; x < STAGES * L::ONES / 16; x += 256) {
      const int st = x / (L::ONES / 16), c = x % (L::ONES / 16);
      reinterpret_cast<uint4*>(smem_raw + (ring + st * L::STAGE + L::KT + L::VT - raw))[c] =
          make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
    }
  }
  mbar_wait(qbar, 0);

  // The q prologue on this warpgroup's 64 rows of the staged tile.  A row r
  // of a box is 128 bytes, its logical 16-byte chunk c at chunk c ^ (r & 7).
  if constexpr (INT8) {
    // two threads per row, one 64-column box each: bf16(q * scale), the
    // row's amax over both halves, then q8 into the int8 tile (its 128-byte
    // row holds all 128 columns: logical chunk c / 16)
    const int r = wg * 64 + (tid >> 1), h = tid & 1;
    const uint8_t* src = q_tile + h * (BM * 128) + r * 128;
    float amax = 0.f;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + p * 16);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        amax = fmaxf(amax, fabsf(__bfloat162float(
                               __float2bfloat16(__bfloat162float(e[j]) * scale))));
    }
    amax = __fadd_rn(fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1)), (float)1e-30);
    const float r127 = __fdiv_rn(127.f, amax);
    const int row = q0 + r;
    uint8_t* dst8 = smem_raw + (sQ8 - raw) + r * 128;
    int8_t* dump = q8_out != nullptr && row < Sq
                       ? q8_out + (((size_t)b * Sq + row) * N + n) * D
                       : nullptr;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + p * 16);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      uint32_t w[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t packed = 0;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float qv =
              __bfloat162float(__float2bfloat16(__bfloat162float(e[4 * j + x]) * scale));
          const int qi = (int)rintf(__fmul_rn(qv, r127));
          packed |= (uint32_t)(qi & 0xff) << (8 * x);
        }
        w[j] = packed;
      }
      const int c = h * 64 + ((p ^ (r & 7)) * 8);  // the chunk's first column
      *reinterpret_cast<uint2*>(dst8 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 8))) =
          make_uint2(w[0], w[1]);
      if (dump != nullptr) *reinterpret_cast<uint2*>(dump + c) = make_uint2(w[0], w[1]);
    }
    if (h == 0) {
      sQs[r] = __fmul_rn(amax, (float)(1.0 / 127.0));
      if (qs_out != nullptr && row < Sq) qs_out[((size_t)b * Sq + row) * N + n] = sQs[r];
    }
  } else if (rope_cos == nullptr) {
    // bf16(q * scale) in place, 8 chunks per thread
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int idx = tid + it * 128, r = wg * 64 + (idx >> 4), chunk = idx & 15;
      uint4* p = reinterpret_cast<uint4*>(q_tile + (chunk >> 3) * (BM * 128) + r * 128 +
                                          (chunk & 7) * 16);
      uint4 v = *p;
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      *p = v;
    }
  } else {
    // the rotation in place: a chunk of the re half (box 0) and its partner
    // of the im half lie at the same offset of the two boxes
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int idx = tid + it * 128, r = wg * 64 + (idx >> 3), p = idx & 7;
      const int row = q0 + r;
      if (row >= Sq) continue;  // zeros from TMA; cos/sin have no such row
      uint4* pre = reinterpret_cast<uint4*>(q_tile + r * 128 + p * 16);
      uint4* pim = reinterpret_cast<uint4*>(q_tile + BM * 128 + r * 128 + p * 16);
      uint4 vre = *pre, vim = *pim;
      bf16* re = reinterpret_cast<bf16*>(&vre);
      bf16* im = reinterpret_cast<bf16*>(&vim);
      const int h = (p ^ (r & 7)) * 8;  // the chunk's first column within the half
      const float4* cp = reinterpret_cast<const float4*>(rope_cos + (size_t)row * (D / 2) + h);
      const float4* sp = reinterpret_cast<const float4*>(rope_sin + (size_t)row * (D / 2) + h);
      const float4 c0 = __ldg(cp), c1 = __ldg(cp + 1), s0 = __ldg(sp), s1 = __ldg(sp + 1);
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float cs = __fmul_rn(cv[j], scale), sn = __fmul_rn(sv[j], scale);
        const float a = __bfloat162float(re[j]), c = __bfloat162float(im[j]);
        re[j] = __float2bfloat16(__fadd_rn(__fmul_rn(a, cs), __fmul_rn(c, -sn)));
        im[j] = __float2bfloat16(__fadd_rn(__fmul_rn(c, cs), __fmul_rn(a, sn)));
      }
      *pre = vre;
      *pim = vim;
    }
  }
  fence_proxy_async();  // the prologue's stores precede wgmma's reads of them
  consumers_sync();

  const int tr0 = wg * 64 + warp * 16 + g;  // this thread's rows tr0 and tr0 + 8 of the tile
  const float qs0 = INT8 ? sQs[tr0] : 0.f, qs1 = INT8 ? sQs[tr0 + 8] : 0.f;
  // O (and under LSUM the row sums, o[64..67]: columns 128-135)
  constexpr int NO = LSUM ? D / 2 + 4 : D / 2;
  float o[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) o[x] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // l per thread (without LSUM)

  // Ping-pong: a warpgroup issues its S = Q K^T only in its turn and then
  // passes the turn, so the two warpgroups' products alternate on the
  // tensor cores and one's softmax runs under the other's products.
  // Warpgroup 0 takes the first turn; warpgroup 1 passes none after its
  // last tile, so every arrival meets a wait.
  if (wg == 1 && nwalk > 0) turn_pass(wg);
  for (int i = 0; i < nwalk; ++i) {
    const int s = i % STAGES;
    const uint32_t kt = ring + s * L::STAGE, vt = kt + L::KT;
    const float* add = sAdd + s * BN;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);

    // S = Q K^T (64 x BN), then the per-column terms
    float sc[BN / 2];
    turn_wait(wg);
    if constexpr (INT8) {
      int si[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        wgmma_ss_s8_n128(si, smem_desc<64>(sQ8 + wg * 64 * D + kk * 32),
                         smem_desc<64>(kt + kk * 32), kk > 0);
      wgmma_commit();
      if (wg == 0 || i + 1 < nwalk) turn_pass(wg);
      wgmma_wait<0>();
      const float* ksc = sKs + s * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(add + j * 8 + tq * 2);
        const float2 k = *reinterpret_cast<const float2*>(ksc + j * 8 + tq * 2);
        sc[4 * j] = __fadd_rn(__fmul_rn(__fmul_rn((float)si[4 * j], qs0), k.x), a.x);
        sc[4 * j + 1] = __fadd_rn(__fmul_rn(__fmul_rn((float)si[4 * j + 1], qs0), k.y), a.y);
        sc[4 * j + 2] = __fadd_rn(__fmul_rn(__fmul_rn((float)si[4 * j + 2], qs1), k.x), a.x);
        sc[4 * j + 3] = __fadd_rn(__fmul_rn(__fmul_rn((float)si[4 * j + 3], qs1), k.y), a.y);
      }
    } else {
      // the accumulator starts from the column's additive term: the tensor
      // cores add q.k to it
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(add + j * 8 + tq * 2);
        sc[4 * j] = a.x;
        sc[4 * j + 1] = a.y;
        sc[4 * j + 2] = a.x;
        sc[4 * j + 3] = a.y;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(sc, desc_k<BM>(sQ, wg * 64, kk), desc_k<BN>(kt, 0, kk), 1);
      wgmma_commit();
      if (wg == 0 || i + 1 < nwalk) turn_pass(wg);
      wgmma_wait<0>();
    }

    // row max over the tile and the running max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float a0 = softmax_exp<EXP2>(m0 - mx0), a1 = softmax_exp<EXP2>(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // P = exp(S - m) as bf16 A fragments of P V; the row sums take the
    // unrounded P (under LSUM, P V sums the rounded P on the tensor cores)
    uint32_t pf[BN / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float p0 = softmax_exp<EXP2>(sc[4 * j] - m0);
      const float p1 = softmax_exp<EXP2>(sc[4 * j + 1] - m0);
      const float p2 = softmax_exp<EXP2>(sc[4 * j + 2] - m1);
      const float p3 = softmax_exp<EXP2>(sc[4 * j + 3] - m1);
      if constexpr (!LSUM) {
        rs0 += p0 + p1;
        rs1 += p2 + p3;
      }
      pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }

    // O += P V (under LSUM 136 columns wide: the last 8 are the row sums)
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb) {
      if constexpr (LSUM)
        wgmma_rs_n136(o, pf[kb], desc_mn<BN>(vt, kb));
      else
        wgmma_rs_n128(o, pf[kb], desc_mn<BN>(vt, kb));
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (tid == 0) mbar_arrive(empty + 8 * s);
    if constexpr (!LSUM) {
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
    }
  }

  // the rows' sums
  if constexpr (LSUM) {
    l0 = o[D / 2];
    l1 = o[D / 2 + 2];
  } else {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
  }

  if (nshares > 1) {
    // keep this share, count it in; the last share of the item merges them
    float* mine = part + ((size_t)(item - nfull) * nshares + share) * PART;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + tq * 2;
      *reinterpret_cast<float2*>(mine + tr0 * D + c) = make_float2(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<float2*>(mine + (tr0 + 8) * D + c) =
          make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
    if (tq == 0) {
      *reinterpret_cast<float2*>(mine + BM * D + 2 * tr0) = make_float2(m0, l0);
      *reinterpret_cast<float2*>(mine + BM * D + 2 * (tr0 + 8)) = make_float2(m1, l1);
    }
    __threadfence();
    consumers_sync();
    if (threadIdx.x == 0) *sLast = atomicAdd(counters + (item - nfull), 1) == nshares - 1;
    consumers_sync();
    if (!*sLast) return;
    if (threadIdx.x == 0) counters[item - nfull] = 0;  // zero again for the next call
    __threadfence();
    const float* all = part + (size_t)(item - nfull) * nshares * PART;
    float mx0 = m0, mx1 = m1;
    for (int p = 0; p < nshares; ++p) {
      mx0 = fmaxf(mx0, __ldcg(all + p * PART + BM * D + 2 * tr0));
      mx1 = fmaxf(mx1, __ldcg(all + p * PART + BM * D + 2 * (tr0 + 8)));
    }
    // every share, this one's too (read back), summed in share order: the
    // bits do not depend on which share finished last
    l0 = l1 = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] = o[4 * j + 1] = o[4 * j + 2] = o[4 * j + 3] = 0.f;
    }
    for (int p = 0; p < nshares; ++p) {
      const float* other = all + p * PART;
      const float2 ml0 = __ldcg(reinterpret_cast<const float2*>(other + BM * D + 2 * tr0));
      const float2 ml1 =
          __ldcg(reinterpret_cast<const float2*>(other + BM * D + 2 * (tr0 + 8)));
      const float b0 = softmax_exp<EXP2>(ml0.x - mx0), b1 = softmax_exp<EXP2>(ml1.x - mx1);
      l0 += ml0.y * b0;
      l1 += ml1.y * b1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + tq * 2;
        const float2 v0 = __ldcg(reinterpret_cast<const float2*>(other + tr0 * D + c));
        const float2 v1 = __ldcg(reinterpret_cast<const float2*>(other + (tr0 + 8) * D + c));
        o[4 * j] += v0.x * b0;
        o[4 * j + 1] += v0.y * b0;
        o[4 * j + 2] += v1.x * b1;
        o[4 * j + 3] += v1.y * b1;
      }
    }
  }

  // out = acc / l
  const int r0 = q0 + tr0, r1 = r0 + 8;
  const size_t rs = (size_t)N * D;
  bf16* ob = out + (size_t)b * Sq * rs + (size_t)n * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + tq * 2;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * rs + c) =
          __floats2bfloat162_rn(o[4 * j] / l0, o[4 * j + 1] / l0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * rs + c) =
          __floats2bfloat162_rn(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
  }
}

struct Args {
  const void *q, *k, *kscale, *v, *bias, *rope_cos, *rope_sin, *k2, *k2scale, *v2;
  LiveTiles live;
  int use_skip;
  void *out, *q8_out, *qs_out, *part, *counters;
  int B, Sq, N, S, S2, nfull, ksplit;
  float scale;
};

template <bool INT8, bool EXP2, bool LSUM>
int launch(const Args& a, cudaStream_t stream) {
  using L = Smem<INT8, LSUM>;
  const auto kernel = serving_attention_kernel<INT8, EXP2, LSUM>;
  // a runtime call first: it makes the device's context current on this
  // thread, which the driver's tensor-map encoder needs
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm{}, km{}, vm{}, k2m{}, v2m{};  // a segment without tokens keeps its zero map
  if (!rows_map(&qm, a.q, a.B, a.Sq, a.N, BM) ||
      (a.S > 0 && (!rows_map(&km, a.k, a.B * a.N, a.S, 1, BN, INT8) ||
                   !rows_map(&vm, a.v, a.B * a.N, a.S, 1, BN))) ||
      (a.S2 > 0 && (!rows_map(&k2m, a.k2, a.B, a.S2, a.N, BN, INT8) ||
                    !rows_map(&v2m, a.v2, a.B, a.S2, a.N, BN))))
    return (int)cudaErrorInvalidValue;
  const int nq = (a.Sq + BM - 1) / BM, items = nq * a.B * a.N;
  if (a.nfull > items || (a.nfull < items && (a.ksplit < 2 || a.part == nullptr ||
                                               a.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int grid = a.nfull + (items - a.nfull) * a.ksplit;
  kernel<<<grid, THREADS, L::BYTES, stream>>>(
      qm, km, vm, k2m, v2m, static_cast<const float*>(a.bias),
      static_cast<const float*>(a.rope_cos), static_cast<const float*>(a.rope_sin),
      static_cast<const float*>(a.kscale), static_cast<const float*>(a.k2scale), a.live,
      a.use_skip, static_cast<bf16*>(a.out), static_cast<int8_t*>(a.q8_out),
      static_cast<float*>(a.qs_out), static_cast<float*>(a.part), static_cast<int*>(a.counters),
      a.Sq, a.N, a.S, a.S2, nq, a.nfull, a.ksplit, a.scale);
  return (int)cudaGetLastError();
}

template <bool INT8>
int launch_switches(const Args& a, int exp2, int lsum, cudaStream_t stream) {
  if (exp2)
    return lsum ? launch<INT8, true, true>(a, stream) : launch<INT8, true, false>(a, stream);
  return lsum ? launch<INT8, false, true>(a, stream) : launch<INT8, false, false>(a, stream);
}

}  // namespace

extern "C" {

// q, out: [B, Sq, N, 128] bf16 (q un-scaled: the kernel applies the softmax
// scale, and in the int8 mode quantizes it); k: [B*N, S, 128] bf16, or int8
// with kscale [B*N, S] f32; v: [B*N, S, 128] bf16; bias: [B, S] f32;
// rope_cos, rope_sin: [Sq, 64] f32 for the q_rope mode (bf16 only), else
// null; k2, v2: [B, S2, N, 128] (k2 int8 with k2scale [B, S2, N] in the int8
// mode) for the two-segment mode, else null with S2 = 0; live / use_skip:
// the cache's live-tile mask; q8_out [B, Sq, N, 128] int8 and qs_out
// [B, Sq, N] f32: the int8 mode's quantized q and its scales, written when
// not null; nfull, ksplit, part, counters: the items (b*n, q tile of 128
// rows; q tiles fastest) from nfull on are split into ksplit CTAs each,
// with a workspace `part` of (items - nfull) * ksplit * 128 * 130 floats and
// (items - nfull) int counters, zero at the call and left zero (nfull = the
// item count: no split);
// scale: the softmax scale (times log2 e when exp2); int8, exp2, lsum: the
// mode and the two switches.  Every operand 16-byte aligned.
int longlive_flash_attention(const void* q, const void* k, const void* kscale, const void* v,
                             const void* bias, const void* rope_cos, const void* rope_sin,
                             const void* k2, const void* k2scale, const void* v2,
                             LiveTiles live, int use_skip, void* out, void* q8_out,
                             void* qs_out, int nfull, int ksplit, void* part, void* counters,
                             int B, int Sq, int N, int S, int S2, float scale, int int8,
                             int exp2, int lsum, void* stream) {
  const Args a{q, k, kscale, v, bias, rope_cos, rope_sin, k2, k2scale, v2, live, use_skip,
               out, q8_out, qs_out, part, counters, B, Sq, N, S, k2 != nullptr ? S2 : 0,
               nfull, ksplit, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return int8 ? launch_switches<true>(a, exp2, lsum, st)
              : launch_switches<false>(a, exp2, lsum, st);
}

// The kernel's tiles: out[0] query rows per CTA, out[1] kv tokens per tile.
void longlive_flash_attention_tiles(int* out) {
  out[0] = BM;
  out[1] = BN;
}

const char* longlive_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
