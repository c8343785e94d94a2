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
// throughput bounds all three kernels (forward 4, dQ 6, dK/dV 8 units of
// B N Sq Skv_valid D operations: the backward recomputes S in both kernels
// and dP in both, the price of having no atomics); the 512-token
// cross-attention is far smaller but still operation-bound.  Only wgmma
// reaches the tensor cores' full rate, and a masked kv tile is work that
// the bound does not count.
//
// Design (FlashAttention-3's shape): every kernel is warp-specialised,
// 384 threads: consumer warpgroups 0 and 1 compute on wgmma (m64 tiles, f32
// accumulators in registers), warpgroup 2 hands its registers back
// (setmaxnreg) and one of its warps is the producer, which keeps TMA loads
// in flight through a ring of shared-memory stages with mbarriers (full:
// the bytes arrived; empty: both consumer warpgroups' wgmma that read the
// stage completed).  Operands are 4-D tensor maps over [B, S, N, 128]
// (dims {128, N, S, B}): a tile of R token rows of one head is two boxes
// of 64 columns, each [R][128 bytes] swizzled 128B, so no transpose exists
// anywhere and TMA fills rows past S with zeros (the ragged tail needs no
// halo code; epilogues drop rows past S).  A tile is read K-major by the
// first products (S = Q K^T and the like) and MN-major, through wgmma's
// transpose bit, as the B operand of the second (P V and the like), whose
// A operand, P or dS rounded to bf16, comes from registers.
//   forward  one CTA per (128 query rows, b*n), 64 per consumer warpgroup;
//            Q staged once, K/V tiles of 128 tokens in a 2-stage ring (the
//            pipeline of flash_fwd_sm90.cuh, which K3 shares);
//            S = Q K^T (m64n128), the online softmax in registers, then
//            O += P V (m64n128, P from registers).
//   dQ       one CTA per (128 query rows, b*n); Q and dO staged once, lse
//            and Delta in registers; K/V tiles of 64 tokens in a 3-stage
//            ring: S = Q K^T and dP = dO V^T (m64n64), then dQ += dS K.
//            Its prologue computes Delta from O and dO.
//   dK/dV    one CTA per (64 kv rows, b*n); K and V staged once; Q, dO,
//            lse and Delta tiles of 128 query rows in a 2-stage ring (the
//            producer warp copies lse and Delta).  The consumer warpgroups
//            split the products over the same 64 kv rows: warpgroup 0
//            computes S^T = K Q^T (m64n128), P^T and dV += P^T dO;
//            warpgroup 1 computes dP^T = V dO^T, takes P^T (float32)
//            from warpgroup 0 through shared memory, and computes dS^T and
//            dK += dS^T Q.  P^T and dS^T sit in registers as A operands.
// What bounds the design is registers: ptxas compiles a 384-thread CTA's
// consumers to at most ~180 a thread whatever setmaxnreg asks for (a
// consumer holding both dK and dV accumulators spills with setmaxnreg at
// 184-240 as without it), and a CTA with a producer warp beside two
// warpgroups is given registers as if it had three (at 288 threads a
// 217-register build is refused at launch).  So a warpgroup holds one
// 64 x 128 accumulator beside one product tile, the tiles above are the
// largest that fit, and Q, K or V cannot stay in registers as A operands.
// The loops wait on each product before the next (no overlap of the
// softmax with the tensor cores inside a warpgroup): the variants that
// overlapped them, with or without alternating the warpgroups' turns, ran
// slower or no faster on an H100 (PERF.md §6).
// Dead kv tiles are skipped.  The forward and dQ CTAs classify each kv
// tile from the mask, one warp ballot per 32 tokens (dead: no valid token;
// full: all valid and inside Skv; partial otherwise), and list the live
// ones in shared memory; the producer loads and the consumers compute only
// those, and only partial tiles apply the per-token mask.  A dK/dV CTA
// whose 64 kv rows are all masked writes zero rows and exits.  Skipping
// changes no result: a dead tile adds exactly 0 to a row that has seen a
// valid token, and every row of a CTA sees its first valid token in the
// first live tile (validity is per kv token), so the -1e30 state a dead
// tile would have left never arises.  A kv longer than the list (MAX_TILES
// tiles: 524,288 tokens in the forward, 262,144 in dQ) is walked whole by
// the kernels' unlisted instantiation (chosen at launch from Skv, so the
// listed loop carries no check), every tile masked per token: a dead tile
// then computes P = 1 under the finite -1e30, which the rescale at the
// row's first valid tile wipes (in dQ, P = exp(-1e30 - lse) = 0), so no kv
// length is refused.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"  // the forward's pipeline, shared with K3
#include "sm90.cuh"  // mbarriers, TMA, tensor maps, wgmma and its descriptors

namespace {

constexpr int D = 128;
constexpr int ROWB = D * 2;       // bytes of one token row of one head
constexpr int THREADS = 384;      // consumer warpgroups 0-1, producer warpgroup 2
constexpr int BM = FWD_BM;        // query rows per forward / dQ CTA
constexpr int FWD_STAGES = 2;     // kv tiles of FWD_BN = 128 tokens (flash_fwd_sm90.cuh)
constexpr int DQ_BN = 64;         // kv tokens per dQ tile
constexpr int DQ_STAGES = 3;
constexpr int BKV = 64;           // kv rows per dK/dV CTA
constexpr int BQ = 128;           // query rows per dK/dV tile
constexpr int DKDV_STAGES = 2;
constexpr int MAX_TILES = 4096;   // kv tiles a forward / dQ CTA can list
constexpr uint16_t PARTIAL = 0x8000;  // list flag: the tile needs the per-token mask
constexpr float EMPTY_LSE = 1e30f;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

typedef __nv_bfloat16 bf16;

// D (+)= A B, m64n64k16: A and B K-major in shared memory; scale_d = 0
// overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Validity bits of kv tile t's BN tokens (one ballot per 32; tokens past
// Skv are invalid).  maskb null: all tokens below Skv are valid.
template <int BN>
__device__ __forceinline__ void tile_bits(uint32_t* bits, const uint8_t* __restrict__ maskb,
                                          int t, int Skv) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w < BN / 32; ++w) {
    const int col = t * BN + w * 32 + lane;
    bits[w] = __ballot_sync(0xffffffffu,
                            col < Skv && (maskb == nullptr || __ldg(maskb + col) != 0));
  }
}

// Is column 8 j + 2 tq + c of a tile valid, from its tile_bits.
__device__ __forceinline__ bool col_ok(const uint32_t* bits, int j, int tq, int c) {
  return (bits[j >> 2] >> (8 * (j & 3) + 2 * tq + c)) & 1u;
}

// Classifies the kv tiles of BN tokens (dead: no valid token; full: all
// valid; partial otherwise) and lists the live ones in sList in order, a
// partial one flagged PARTIAL; at most MAX_TILES tiles.  Every thread of
// the CTA takes part; the barriers make the list (and the mbarriers
// initialised before the call) visible to all.  Returns the count.
template <int BN>
__device__ int list_live_tiles(const uint8_t* __restrict__ maskb, int Skv, uint8_t* sState,
                               uint16_t* sList, int* sCount) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (Skv + BN - 1) / BN;
  for (int t = warp; t < ntiles; t += THREADS / 32) {
    uint32_t bits[BN / 32];
    tile_bits<BN>(bits, maskb, t, Skv);
    bool any = false, all = true;
#pragma unroll
    for (int w = 0; w < BN / 32; ++w) {
      any |= bits[w] != 0u;
      all &= bits[w] == 0xffffffffu;
    }
    if (lane == 0) sState[t] = any ? (all ? 2 : 1) : 0;
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + lane;
      const int st = t < ntiles ? sState[t] : 0;
      const uint32_t live = __ballot_sync(0xffffffffu, st != 0);
      if (st != 0)
        sList[count + __popc(live & ((1u << lane) - 1u))] =
            (uint16_t)(t | (st == 1 ? PARTIAL : 0));
      count += __popc(live);
    }
    if (lane == 0) *sCount = count;
  }
  __syncthreads();
  return *sCount;
}

// The kv tiles a forward / dQ CTA walks: LISTED, the live ones that
// list_live_tiles lists; otherwise (a kv of more than MAX_TILES tiles)
// every tile, each masked per token.  Returns the count; ends with a CTA
// barrier either way.
template <int BN, bool LISTED>
__device__ __forceinline__ int walk_tiles(const uint8_t* __restrict__ maskb, int Skv,
                                          uint8_t* sState, uint16_t* sList, int* sCount) {
  if (LISTED) return list_live_tiles<BN>(maskb, Skv, sState, sList, sCount);
  __syncthreads();
  return (Skv + BN - 1) / BN;
}

// ---------------------------------------------------------------------------
// forward

constexpr int FWD_META = 8 * (1 + 2 * FWD_STAGES) + 4 + 3 * MAX_TILES;
constexpr size_t FWD_SMEM = 1024 + BM * ROWB + FWD_STAGES * FWD_STAGE + FWD_META;

template <bool LISTED>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, const uint8_t* __restrict__ mask,
           bf16* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int N,
           float scale) {
  constexpr int BN = FWD_BN, STAGES = FWD_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  const uint32_t ring = sQ + BM * ROWB;
  uint8_t* meta = smem_raw + (ring - raw) + STAGES * FWD_STAGE;
  const uint32_t qbar = smem_u32(meta), full = qbar + 8, empty = full + 8 * STAGES;
  int* sCount = reinterpret_cast<int*>(meta + 8 * (1 + 2 * STAGES));
  uint16_t* sList = reinterpret_cast<uint16_t*>(sCount + 1);
  uint8_t* sState = reinterpret_cast<uint8_t*>(sList + MAX_TILES);

  const int bh = blockIdx.y, b = bh / N, n = bh % N;
  const int q0 = blockIdx.x * BM;
  const uint8_t* maskb = mask == nullptr ? nullptr : mask + (size_t)b * Skv;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int nwalk = walk_tiles<BN, LISTED>(maskb, Skv, sState, sList, sCount);

  if (threadIdx.x >= 256) {  // producer warpgroup: one thread issues every TMA load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256)
      fwd_produce<STAGES>(&qmap, &kmap, &vmap, sQ, ring, qbar, full, empty, q0, n, b, nwalk,
                          [&](int i) { return LISTED ? sList[i] & ~PARTIAL : i; });
  } else {  // consumer warpgroups: 64 query rows each
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    float o[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows g and g + 8; l per thread
    mbar_wait(qbar, 0);
    for (int i = 0; i < nwalk; ++i) {
      const int s = i % STAGES, e = LISTED ? sList[i] : PARTIAL;
      const uint32_t kt = ring + s * FWD_STAGE, vt = kt + FWD_KV;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);

      float sc[BN / 2];
      fwd_scores(sc, sQ, wg, kt);

      // scale, mask (partial tiles only)
      uint32_t bits[BN / 32];
      if (e & PARTIAL) {
        tile_bits<BN>(bits, maskb, LISTED ? e & ~PARTIAL : i, Skv);
      } else {
#pragma unroll
        for (int w = 0; w < BN / 32; ++w) bits[w] = 0xffffffffu;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool ok = col_ok(bits, j, tq, c);
          sc[4 * j + c] = ok ? sc[4 * j + c] * scale : NEG;
          sc[4 * j + 2 + c] = ok ? sc[4 * j + 2 + c] * scale : NEG;
        }
      }
      fwd_softmax_pv(sc, o, m0, m1, l0, l1, vt);
      if ((threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * s);
    }

    // a row that saw no valid token (no live tile) writes zeros
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const bool e0 = m0 == NEG, e1 = m1 == NEG;
    const float i0 = e0 ? 0.f : 1.f / l0, i1 = e1 ? 0.f : 1.f / l1;
    const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
    const size_t rs = (size_t)N * D;
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
    if (tq == 0) {
      float* lb = lse + (size_t)bh * Sq;
      if (r0 < Sq) lb[r0] = e0 ? EMPTY_LSE : m0 + logf(l0);
      if (r1 < Sq) lb[r1] = e1 ? EMPTY_LSE : m1 + logf(l1);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, kernel 1: dQ (and Delta = rowsum(dO * O) in its prologue)

constexpr int DQ_KV = DQ_BN * ROWB;  // one K or V tile
constexpr int DQ_STAGE = 2 * DQ_KV;
constexpr int DQ_META = 8 * (1 + 2 * DQ_STAGES) + 4 * BM + 4 + 3 * MAX_TILES;
constexpr size_t DQ_SMEM = 1024 + 2 * BM * ROWB + DQ_STAGES * DQ_STAGE + DQ_META;

template <bool LISTED>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
              const uint8_t* __restrict__ mask, const bf16* __restrict__ out,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Skv, int N,
              float scale) {
  constexpr int BN = DQ_BN, STAGES = DQ_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sO = sQ + BM * ROWB;  // dO
  const uint32_t ring = sO + BM * ROWB;
  uint8_t* meta = smem_raw + (ring - raw) + STAGES * DQ_STAGE;
  const uint32_t qbar = smem_u32(meta), full = qbar + 8, empty = full + 8 * STAGES;
  float* sDelta = reinterpret_cast<float*>(meta + 8 * (1 + 2 * STAGES));  // [BM]
  int* sCount = reinterpret_cast<int*>(sDelta + BM);
  uint16_t* sList = reinterpret_cast<uint16_t*>(sCount + 1);
  uint8_t* sState = reinterpret_cast<uint8_t*>(sList + MAX_TILES);

  const int bh = blockIdx.y, b = bh / N, n = bh % N;
  const int q0 = blockIdx.x * BM;
  const uint8_t* maskb = mask == nullptr ? nullptr : mask + (size_t)b * Skv;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int nwalk = walk_tiles<BN, LISTED>(maskb, Skv, sState, sList, sCount);

  if (threadIdx.x >= 256) {  // producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, 2 * BM * ROWB);
      load_rows<BM>(sQ, &qmap, qbar, q0, n, b);
      load_rows<BM>(sO, &domap, qbar, q0, n, b);
      for (int i = 0; i < nwalk; ++i) {
        const int s = i % STAGES, round = i / STAGES;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const int kv0 = (LISTED ? sList[i] & ~PARTIAL : i) * BN;
        const uint32_t dst = ring + s * DQ_STAGE;
        mbar_expect_tx(full + 8 * s, DQ_STAGE);
        load_rows<BN>(dst, &kmap, full + 8 * s, kv0, n, b);
        load_rows<BN>(dst + DQ_KV, &vmap, full + 8 * s, kv0, n, b);
      }
    }
  } else {  // consumer warpgroups: 64 query rows each
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const size_t rs = (size_t)N * D;
    const size_t qoff = (size_t)b * Sq * rs + (size_t)n * D;

    // Delta of this warpgroup's 64 rows: two threads per row, 64 columns each
    {
      const int rr = (threadIdx.x & 127) >> 1, h = threadIdx.x & 1;
      const int row = q0 + wg * 64 + rr;
      float acc = 0.f;
      if (row < Sq) {
        const size_t off = qoff + (size_t)row * rs + h * 64;
#pragma unroll
        for (int c = 0; c < 64; c += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(out + off + c);
          const uint4 dv = *reinterpret_cast<const uint4*>(dout + off + c);
          const bf16* oe = reinterpret_cast<const bf16*>(&ov);
          const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
          for (int x = 0; x < 8; ++x) acc += __bfloat162float(oe[x]) * __bfloat162float(de[x]);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (h == 0) {
        sDelta[wg * 64 + rr] = acc;
        if (row < Sq) delta[(size_t)bh * Sq + row] = acc;
      }
    }
    warpgroup_sync(wg);
    const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
    const float dl0 = sDelta[r0 - q0], dl1 = sDelta[r1 - q0];
    const float L0 = r0 < Sq ? lse[(size_t)bh * Sq + r0] : EMPTY_LSE;
    const float L1 = r1 < Sq ? lse[(size_t)bh * Sq + r1] : EMPTY_LSE;

    float acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
    mbar_wait(qbar, 0);
    for (int i = 0; i < nwalk; ++i) {
      const int s = i % STAGES, e = LISTED ? sList[i] : PARTIAL;
      const uint32_t kt = ring + s * DQ_STAGE, vt = kt + DQ_KV;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);

      // S = Q K^T and dP = dO V^T: 64 x BN each
      float sc[BN / 2], dp[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, desc_k<BM>(sQ, wg * 64, kk), desc_k<BN>(kt, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_k<BM>(sO, wg * 64, kk), desc_k<BN>(vt, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();

      // P = exp(S * scale - lse) (0 where masked), dS = P (dP - Delta), as
      // bf16 A fragments of dS K
      uint32_t bits[BN / 32];
      if (e & PARTIAL) {
        tile_bits<BN>(bits, maskb, LISTED ? e & ~PARTIAL : i, Skv);
      } else {
#pragma unroll
        for (int w = 0; w < BN / 32; ++w) bits[w] = 0xffffffffu;
      }
      uint32_t dsf[BN / 16][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool ok = col_ok(bits, j, tq, c);
          const float p0 = ok ? __expf(sc[4 * j + c] * scale - L0) : 0.f;
          const float p1 = ok ? __expf(sc[4 * j + 2 + c] * scale - L1) : 0.f;
          ds[c] = p0 * (dp[4 * j + c] - dl0);
          ds[2 + c] = p1 * (dp[4 * j + 2 + c] - dl1);
        }
        dsf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dQ += dS K
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb) wgmma_rs_n128(acc, dsf[kb], desc_mn<BN>(kt, kb));
      wgmma_commit();
      wgmma_wait<0>();
      if ((threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * s);
    }

    bf16* dqb = dq + qoff;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + tq * 2;
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)r0 * rs + c) =
            __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (r1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)r1 * rs + c) =
            __floats2bfloat162_rn(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, kernel 2: dK and dV
//
// The two consumer warpgroups share the CTA's BKV = 64 kv rows and split
// the products: warpgroup 0 computes S^T = K Q^T, P^T and dV += P^T dO,
// and hands P^T (float32) to warpgroup 1 through shared memory; warpgroup
// 1 computes dP^T = V dO^T, dS^T = P^T (dP^T - Delta) and dK += dS^T Q.
// Each thread so holds one 64 x 128 accumulator (dV or dK) beside one
// 64 x BQ product, which fits the 168 registers a 384-thread CTA gives;
// both accumulators in one warpgroup spill.

constexpr int DKDV_KV = BKV * ROWB;  // the K or V rows of the CTA
constexpr int DKDV_Q = BQ * ROWB;    // one Q or dO tile
constexpr int DKDV_STAGE = 2 * DKDV_Q;
constexpr int P_SLOT = 64 * BQ * 4;  // one P^T tile, float32
constexpr int DKDV_META = 8 * (1 + 2 * DKDV_STAGES + 2) + 2 * 4 * DKDV_STAGES * BQ;
constexpr size_t DKDV_SMEM = 1024 + 2 * DKDV_KV + DKDV_STAGES * DKDV_STAGE + P_SLOT + DKDV_META;

__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap domap, const uint8_t* __restrict__ mask,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int N,
                float scale) {
  constexpr int STAGES = DKDV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + DKDV_KV;
  const uint32_t ring = sV + DKDV_KV;  // stages of (Q tile, dO tile)
  float4* sP = reinterpret_cast<float4*>(smem_raw + (ring - raw) + STAGES * DKDV_STAGE);
  uint8_t* meta = reinterpret_cast<uint8_t*>(sP) + P_SLOT;
  const uint32_t kvbar = smem_u32(meta), full = kvbar + 8, empty = full + 8 * STAGES;
  const uint32_t pfull = empty + 8 * STAGES, pempty = pfull + 8;  // the P^T slot
  float* sL = reinterpret_cast<float*>(meta + 8 * (1 + 2 * STAGES + 2));  // [STAGES][BQ] lse
  float* sD = sL + STAGES * BQ;                                            // [STAGES][BQ] Delta

  const int bh = blockIdx.y, b = bh / N, n = bh % N;
  const int kv0 = blockIdx.x * BKV;
  const size_t rs = (size_t)N * D;
  const size_t koff = (size_t)b * Skv * rs + (size_t)n * D;
  const uint8_t* maskb = mask == nullptr ? nullptr : mask + (size_t)b * Skv;

  // a CTA whose kv rows are all masked writes zero rows and exits
  const int own = kv0 + threadIdx.x;
  const bool live_row = threadIdx.x < BKV && own < Skv &&
                        (maskb == nullptr || __ldg(maskb + own) != 0);
  if (!__syncthreads_or(live_row)) {
    const int rows = min(BKV, Skv - kv0);
    for (int x = threadIdx.x; x < rows * (D / 8); x += THREADS) {
      const size_t off = koff + (size_t)(kv0 + x / (D / 8)) * rs + (x % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(dk + off) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv + off) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    mbar_init(pfull, 4);   // every warp of warpgroup 0 wrote its P^T
    mbar_init(pempty, 4);  // every warp of warpgroup 1 read it
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nq = (Sq + BQ - 1) / BQ;

  if (threadIdx.x >= 256) {  // producer warpgroup: warp 8 copies lse / Delta and issues TMA
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * DKDV_KV);
        load_rows<BKV>(sK, &kmap, kvbar, kv0, n, b);
        load_rows<BKV>(sV, &vmap, kvbar, kv0, n, b);
      }
      const float* lb = lse + (size_t)bh * Sq;
      const float* db = delta + (size_t)bh * Sq;
      for (int i = 0; i < nq; ++i) {
        const int s = i % STAGES, round = i / STAGES;
        // the tile's lse and Delta, read before the stage is free (ragged
        // rows: lse +1e30 makes P = 0 there)
        float lr[BQ / 32], dr[BQ / 32];
#pragma unroll
        for (int x = 0; x < BQ / 32; ++x) {
          const int row = i * BQ + x * 32 + lane;
          lr[x] = row < Sq ? lb[row] : EMPTY_LSE;
          dr[x] = row < Sq ? db[row] : 0.f;
        }
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
#pragma unroll
        for (int x = 0; x < BQ / 32; ++x) {
          sL[s * BQ + x * 32 + lane] = lr[x];
          sD[s * BQ + x * 32 + lane] = dr[x];
        }
        __syncwarp();  // the lanes' copies precede lane 0's arrival on full
        if (lane == 0) {
          const uint32_t dst = ring + s * DKDV_STAGE;
          mbar_expect_tx(full + 8 * s, DKDV_STAGE);
          load_rows<BQ>(dst, &qmap, full + 8 * s, i * BQ, n, b);
          load_rows<BQ>(dst + DKDV_Q, &domap, full + 8 * s, i * BQ, n, b);
        }
        __syncwarp();
      }
    }
  } else {  // consumer warpgroups: the same 64 kv rows, dV (0) or dK (1)
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
    const int r0 = kv0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two kv rows
    float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
    mbar_wait(kvbar, 0);
    if (wg == 0) {
      const bool ok0 = r0 < Skv && (maskb == nullptr || __ldg(maskb + r0) != 0);
      const bool ok1 = r1 < Skv && (maskb == nullptr || __ldg(maskb + r1) != 0);
      for (int i = 0; i < nq; ++i) {
        const int s = i % STAGES;
        const uint32_t qt = ring + s * DKDV_STAGE, ot = qt + DKDV_Q;
        const float* sl = sL + s * BQ;
        mbar_wait(full + 8 * s, (i / STAGES) & 1);

        // S^T = K Q^T: 64 kv rows x BQ query columns
        float st[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n128(st, desc_k<BKV>(sK, 0, kk), desc_k<BQ>(qt, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();

        // P^T = exp(S^T * scale - lse[col]) (0 for a masked kv row), to
        // warpgroup 1 in float32 and as the bf16 A fragments of P^T dO
        if (i > 0) mbar_wait(pempty, (i - 1) & 1);
        uint32_t pf[BQ / 16][4];
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 L = *reinterpret_cast<const float2*>(sl + j * 8 + tq * 2);
          const float p0 = ok0 ? __expf(st[4 * j] * scale - L.x) : 0.f;
          const float p1 = ok0 ? __expf(st[4 * j + 1] * scale - L.y) : 0.f;
          const float p2 = ok1 ? __expf(st[4 * j + 2] * scale - L.x) : 0.f;
          const float p3 = ok1 ? __expf(st[4 * j + 3] * scale - L.y) : 0.f;
          sP[j * 128 + tid] = make_float4(p0, p1, p2, p3);
          pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
          pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
        __syncwarp();  // the lanes' stores precede lane 0's arrival
        if (lane == 0) mbar_arrive(pfull);

        // dV += P^T dO
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < BQ / 16; ++kb) wgmma_rs_n128(acc, pf[kb], desc_mn<BQ>(ot, kb));
        wgmma_commit();
        wgmma_wait<0>();
        if (tid == 0) mbar_arrive(empty + 8 * s);
      }
    } else {
      for (int i = 0; i < nq; ++i) {
        const int s = i % STAGES;
        const uint32_t qt = ring + s * DKDV_STAGE, ot = qt + DKDV_Q;
        const float* sd = sD + s * BQ;
        mbar_wait(full + 8 * s, (i / STAGES) & 1);

        // dP^T = V dO^T: 64 kv rows x BQ query columns
        float dpt[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n128(dpt, desc_k<BKV>(sV, 0, kk), desc_k<BQ>(ot, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();

        // dS^T = P^T (dP^T - Delta[col]), as the bf16 A fragments of dS^T Q
        mbar_wait(pfull, i & 1);
        uint32_t dsf[BQ / 16][4];
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(sd + j * 8 + tq * 2);
          const float4 p = sP[j * 128 + tid];
          dsf[j >> 1][(j & 1) * 2 + 0] =
              pack_bf16(p.x * (dpt[4 * j] - dl.x), p.y * (dpt[4 * j + 1] - dl.y));
          dsf[j >> 1][(j & 1) * 2 + 1] =
              pack_bf16(p.z * (dpt[4 * j + 2] - dl.x), p.w * (dpt[4 * j + 3] - dl.y));
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(pempty);

        // dK += dS^T Q
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < BQ / 16; ++kb) wgmma_rs_n128(acc, dsf[kb], desc_mn<BQ>(qt, kb));
        wgmma_commit();
        wgmma_wait<0>();
        if (tid == 0) mbar_arrive(empty + 8 * s);
      }
    }

    // warpgroup 0 writes dV, warpgroup 1 dK = scale dS^T Q
    bf16* ob = (wg == 0 ? dv : dk) + koff;
    const float f = wg == 0 ? 1.f : scale;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + tq * 2;
      if (r0 < Skv)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * rs + c) =
            __floats2bfloat162_rn(acc[4 * j] * f, acc[4 * j + 1] * f);
      if (r1 < Skv)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * rs + c) =
            __floats2bfloat162_rn(acc[4 * j + 2] * f, acc[4 * j + 3] * f);
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
  const auto kernel = (Skv + FWD_BN - 1) / FWD_BN <= MAX_TILES ? fwd_kernel<true>
                                                                : fwd_kernel<false>;
  // a runtime call first: it makes the device's context current on this
  // thread, which the driver's tensor-map encoder needs
  const cudaError_t err = set_smem(kernel, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm;
  if (!rows_map(&qm, q, B, Sq, N, BM) || !rows_map(&km, k, B, Skv, N, FWD_BN) ||
      !rows_map(&vm, v, B, Skv, N, FWD_BN))
    return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + BM - 1) / BM, B * N);
  kernel<<<grid, THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      qm, km, vm, static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
      static_cast<float*>(lse), Sq, Skv, N, scale);
  return (int)cudaGetLastError();
}

// dQ and Delta = rowsum(dO * O) ([B, N, Sq] f32, written).
int longlive_flash_train_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                                const void* out, const void* dout, const void* lse, void* delta,
                                void* dq, int B, int Sq, int Skv, int N, float scale,
                                void* stream) {
  const auto kernel = (Skv + DQ_BN - 1) / DQ_BN <= MAX_TILES ? bwd_dq_kernel<true>
                                                              : bwd_dq_kernel<false>;
  const cudaError_t err = set_smem(kernel, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm, om;
  if (!rows_map(&qm, q, B, Sq, N, BM) || !rows_map(&om, dout, B, Sq, N, BM) ||
      !rows_map(&km, k, B, Skv, N, DQ_BN) || !rows_map(&vm, v, B, Skv, N, DQ_BN))
    return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + BM - 1) / BM, B * N);
  kernel<<<grid, THREADS, DQ_SMEM, (cudaStream_t)stream>>>(
      qm, km, vm, om, static_cast<const uint8_t*>(mask), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<bf16*>(dq), Sq, Skv, N, scale);
  return (int)cudaGetLastError();
}

// dK and dV; reads the Delta the dQ kernel wrote (launch it after that one).
int longlive_flash_train_bwd_dkdv(const void* q, const void* k, const void* v, const void* mask,
                                  const void* dout, const void* lse, const void* delta, void* dk,
                                  void* dv, int B, int Sq, int Skv, int N, float scale,
                                  void* stream) {
  const cudaError_t err = set_smem(bwd_dkdv_kernel, DKDV_SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qm, km, vm, om;
  if (!rows_map(&qm, q, B, Sq, N, BQ) || !rows_map(&om, dout, B, Sq, N, BQ) ||
      !rows_map(&km, k, B, Skv, N, BKV) || !rows_map(&vm, v, B, Skv, N, BKV))
    return (int)cudaErrorInvalidValue;
  dim3 grid((Skv + BKV - 1) / BKV, B * N);
  bwd_dkdv_kernel<<<grid, THREADS, DKDV_SMEM, (cudaStream_t)stream>>>(
      qm, km, vm, om, static_cast<const uint8_t*>(mask), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv,
      N, scale);
  return (int)cudaGetLastError();
}

// The kernels' kv tiles: out[0] tokens per forward tile, out[1] per dQ
// tile, out[2] kv rows per dK/dV CTA, out[3] the most tiles a forward or
// dQ CTA lists (past it, it walks every tile).
void longlive_flash_train_kv_tiles(int* out) {
  out[0] = FWD_BN;
  out[1] = DQ_BN;
  out[2] = BKV;
  out[3] = MAX_TILES;
}

const char* longlive_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
