// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel, f32 and bf16 inputs, head dims 32, 64 and 128.
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py:_bwd_dq_kernel and
// :_bwd_dkv_kernel (the two Pallas TPU kernels launched by _flash_bwd).
// Same function: with the scores s = scale * Q K^T masked as the forward
// masks them (a (B, Tk) 0/1 key mask and causal masking by absolute
// position, both as scores of NEG = -1e30; _masked_scores), the
// probabilities are recomputed from the forward's per-row log-sum-exp,
// p = exp(s - lse), and set to exactly 0 where s <= NEG/2 (_bwd_scores),
// so the +1e30 LSE sentinel of a fully-masked row gives p = 0 and never
// inf * 0. With dp = dO V^T and the row term delta = rowsum(dO * O) - g_lse
// (computed by the caller):
//
//   ds = p * (dp - delta)
//   dQ = scale * ds K,   dK = scale * ds^T Q,   dV = p^T dO
//
// Accumulation is f32; the gradients are written once, in the input type.
//
// Design. The TPU kernels walk sequential grids and carry the dQ (resp.
// dK, dV) sums in VMEM scratch from one grid step to the next. CUDA blocks
// run in parallel and in no order, so each block owns one 64-row output
// tile and loops over the other operand's 64-row tiles, with the sums in
// registers:
//
// - dQ kernel: one block per (batch*head, query tile). Q and dO (with
//   their LSE and delta) stay in shared memory; K/V tiles stream through
//   (stopping at the diagonal when causal). Query tiles issue heaviest
//   first.
// - dK/dV kernel: one block per (batch*head, key tile). K and V stay;
//   Q/dO tiles (with their LSE and delta) stream through (starting at the
//   first tile that reaches the diagonal when causal). It computes the
//   transposed tiles S^T = K Q^T and dP^T = V dO^T, so its rows are keys.
//
// Streamed tiles go through a two-stage ring filled by cp.async (16-byte
// copies; rows past T are zero-filled through the src-size operand, so the
// ragged edge needs no branch): tile t+1 is in flight while tile t is
// computed, and a block passes one barrier per tile. Two passes, as in the
// reference, and no atomics: every gradient element is summed by one
// thread (f32) or one fixed wgmma chain (bf16) in a fixed order, so two
// calls give bitwise-equal results. (A fused one-pass FlashAttention-2
// backward with atomic dQ adds would save recomputing p once, at the
// price of that determinism.) Operands are read in place through their
// (B, T, H, D) strides. Rows past Tq and keys past Tk add nothing: a query
// row past Tq has p = 0 (LSE +1e30 in dQ, an explicit bound in dK/dV), a
// key past Tk a zero validity.
//
// What bounds it on the H100. Per live (query, key) pair the dQ pass does
// 6*D flops (Q.K, dO.V, ds.K) and the dK/dV pass 8*D (Q.K, dO.V, p.dO,
// ds.Q); operands are staged in shared memory, so device-memory traffic is
// a few passes over Q, K, V and dO and the functions are bound by
// arithmetic at the repo's shapes (T = 2048, D = 64). Two routes:
//
// - float32: CUDA cores (67 TFLOP/s peak), exact f32 (TF32 tensor cores
//   would break the 1e-4 agreement with the plain version). Each thread
//   owns 4 rows (16 apart) x 8 interleaved columns of the 64x64 score tile
//   and the same 4 rows x D/8 columns of the output tile; inner products
//   read shared memory with 16-byte, bank-conflict-free loads (rows padded
//   by 4 floats). The 8 threads of a row group are in one warp and hold
//   their rows' p and ds over all 64 columns between them, so the second
//   product takes them by __shfl_sync: no p/ds tile in shared memory and no
//   barrier for it (dK/dV runs p^T dO and ds^T Q in one loop, and at D <= 64
//   S^T and dP^T too). What holds it below its bound is instruction issue
//   and latency on the CUDA cores rather than occupancy: 3 blocks of
//   32-row streamed tiles per SM ran slower than 2 blocks of 64-row tiles.
// - bfloat16: tensor cores (989 TFLOP/s peak) through wgmma. A block is
//   one warpgroup over 64 rows, wgmma's M. Tiles are stored once, in
//   wgmma's swizzled layout (128-byte swizzle; 64-byte rows and swizzle at
//   D = 32; two 64-column atoms at D = 128). S = Q K^T and dP = dO V^T
//   (dK/dV: S^T = K Q^T, dP^T = V dO^T) read both operands K-major from
//   shared memory; dQ += dS K, dV += P^T dO and dK += dS^T Q take A from
//   registers (the previous product's f32 accumulator, p and ds rounded to
//   bf16 pairs, as FlashAttention does) and read the same K, dO and Q bytes
//   MN-major through wgmma's transpose-B bit, so no tile is staged
//   transposed.
//
// In both routes a score tile that needs no mask test (no key mask, no row
// or key past the end, wholly below the causal diagonal) skips the test per
// score; bf16 takes p as exp2 of one FMA with log2(e) folded in.
//
// Budget per block at D = 32/64/128. Shared memory, f32: dQ and dK/dV
// 55/103/199 KB (two blocks per SM at D <= 64); bf16: 26/50/98 KB (four
// blocks per SM at D = 64, by shared memory). Above 48 KB it must be
// granted, so each launch first calls cudaFuncSetAttribute (Hopper allows
// 227 KB). Registers (ptxas, CUDA 12.9): f32 dQ 171/250/254, dK/dV
// 254/254/255; bf16 dQ 128/152/176, dK/dV 159/168/251; no spills.
//
// Not yet: TMA with a producer warp, a second consumer warpgroup sharing
// each streamed tile, and f32 on tensor cores (3xTF32 split).
//
// Interface: one plain C function per kernel, bound with ctypes. Each
// launches on the given stream, allocates nothing, and returns
// cudaGetLastError() after the launch so a refused launch is seen by the
// caller. The copy helpers, the f32 tile products, the swizzled layout and
// the wgmma wrappers are sm90_common.cuh's, shared with the forward.

#include "sm90_common.cuh"

namespace {

// LSE and delta of rows [q0, q0 + BQ) into Ls and Dl (one value per
// thread); zero past Tq (the caller excludes those rows itself)
__device__ __forceinline__ void async_row_terms(float* Ls, float* Dl,
                                                const float* lse,
                                                const float* delta,
                                                long long bh, int q0,
                                                int Tq) {
  const int i = threadIdx.x & (BQ - 1);
  const int row = q0 + i;
  const bool ok = row < Tq;
  const long long at = bh * Tq + (ok ? row : 0);
  if (threadIdx.x < BQ) cp_async4(Ls + i, lse + at, ok);
  else cp_async4(Dl + i, delta + at, ok);
}

// Row LSE and delta of rows [q0, q0 + BQ), read once; rows past Tq get LSE
// +1e30 (so p = 0) and delta 0
__device__ __forceinline__ void load_row_terms(float* Ls, float* Dl,
                                               const float* lse,
                                               const float* delta,
                                               long long bh, int q0, int Tq) {
  for (int i = threadIdx.x; i < BQ; i += NT) {
    const int row = q0 + i;
    Ls[i] = row < Tq ? lse[bh * Tq + row] : -NEG;
    Dl[i] = row < Tq ? delta[bh * Tq + row] : 0.f;
  }
}

// is key k0 + kl valid (inside Tk, unmasked)
__device__ __forceinline__ bool key_ok(const float* mb, int kpos, int Tk) {
  return kpos < Tk && (mb == nullptr || mb[kpos] > 0.f);
}

// ---------------------------------------------------------------- float32
// Two tile_dot products in one loop: acc1 += A1 . B1 and acc2 += A2 . B2.
template <int D, int ROW>
__device__ __forceinline__ void tile_dot2(float (&acc1)[RQ][RK],
                                          const float* A1, const float* B1,
                                          float (&acc2)[RQ][RK],
                                          const float* A2, const float* B2,
                                          int rg, int cg) {
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const float* A = w ? A2 : A1;
      const float* B = w ? B2 : B1;
      float4 av[RQ], bv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        av[i] = *reinterpret_cast<const float4*>(A + trow(rg, i) * ROW + d);
#pragma unroll
      for (int j = 0; j < RK; ++j)
        bv[j] = *reinterpret_cast<const float4*>(B + (cg + 8 * j) * ROW + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          float& a = w ? acc2[i][j] : acc1[i][j];
          float t = a;
          t = fmaf(av[i].x, bv[j].x, t);
          t = fmaf(av[i].y, bv[j].y, t);
          t = fmaf(av[i].z, bv[j].z, t);
          t = fmaf(av[i].w, bv[j].w, t);
          a = t;
        }
    }
  }
}

template <int D>
struct SmemF32 {
  static constexpr int ROW = D + 4;    // +4 floats: conflict-free float4 rows
  static constexpr int TILE = BQ * ROW;   // floats of one 64-row tile
  // dQ: Q, dO; two stages of K, V and key validity; row LSE and delta
  static constexpr size_t DQ_BYTES =
      sizeof(float) * (2 * TILE + 2 * (2 * TILE + BK) + 2 * BQ);
  // dK/dV: K, V; two stages of Q, dO, row LSE and delta
  static constexpr size_t DKV_BYTES =
      sizeof(float) * (2 * TILE + 2 * (2 * TILE + 2 * BQ));
};

// ------------------------------------------------------------------- dQ
template <int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 2 : 1)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const float* __restrict__ mask, float* __restrict__ dq, int H,
             int Tq, int Tk, long long qsB, long long qsT, long long qsH,
             long long ksB, long long ksT, long long ksH, long long vsB,
             long long vsT, long long vsH, long long osB, long long osT,
             long long osH, long long gsB, long long gsT, long long gsH,
             int causal, float scale) {
  using S = SmemF32<D>;
  constexpr int NC = D / 32;  // float4 output chunks per thread and row

  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // BQ x ROW
  float* dOs = Qs + S::TILE;                      // BQ x ROW
  float* ring = dOs + S::TILE;   // stage s: K at ring + 2s TILE, V after it
  float* Ms = ring + 4 * S::TILE;                // stage s: BK at Ms + s BK
  float* Ls = Ms + 2 * BK;                        // BQ row LSE
  float* Dl = Ls + BQ;                            // BQ row delta

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int src0 = (tid & 31) & ~7;  // lane of the row group's first thread

  const float* kb = k + b * ksB + h * ksH;
  const float* vb = v + b * vsB + h * vsH;
  const float* mb = mask == nullptr ? nullptr : mask + (long long)b * Tk;

  async_rows<D, S::ROW, BQ>(Qs, q + b * qsB + h * qsH, q0, Tq, qsT);
  async_rows<D, S::ROW, BQ>(dOs, dO + b * gsB + h * gsH, q0, Tq, gsT);
  load_row_terms(Ls, Dl, lse, delta, bh, q0, Tq);

  auto issue = [&](int kt) {  // K/V tile kt into stage kt & 1
    float* Ks = ring + (kt & 1) * 2 * S::TILE;
    async_rows<D, S::ROW, BK>(Ks, kb, kt * BK, Tk, ksT);
    async_rows<D, S::ROW, BK>(Ks + S::TILE, vb, kt * BK, Tk, vsT);
    async_key_valid(Ms + (kt & 1) * BK, mb, kt * BK, Tk);
    cp_async_commit();
  };

  float acc[RQ][NC][4];
  zero_acc(acc);

  int n_kt = (Tk + BK - 1) / BK;
  if (causal) {
    // key tiles wholly above the diagonal are fully masked: stop before them
    const int last = (q0 + BQ - 1) / BK + 1;
    n_kt = n_kt < last ? n_kt : last;
  }

  issue(0);  // with Q and dO
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait_all();
    // tile kt has landed for every thread, and every thread is past tile
    // kt-1, so its stage can be refilled
    __syncthreads();
    if (kt + 1 < n_kt) issue(kt + 1);
    const float* Ks = ring + (kt & 1) * 2 * S::TILE;
    const float* Vs = Ks + S::TILE;
    const float* Mk = Ms + (kt & 1) * BK;

    float p[RQ][RK], ds[RQ][RK];
    zero_tile(p);
    zero_tile(ds);
    tile_dot<D, S::ROW>(p, Qs, Ks, rg, cg);     // raw scores
    tile_dot<D, S::ROW>(ds, dOs, Vs, rg, cg);   // dp = dO V^T
    // a tile with no key mask, no key past Tk and wholly below the
    // diagonal needs no test per score (rows past Tq have LSE +1e30)
    const bool plain = mb == nullptr && k0 + BK <= Tk &&
                       (!causal || k0 + BK - 1 <= q0);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = trow(rg, i);
      const int qpos = q0 + r;
      const float l = Ls[r];
      const float dl = Dl[r];
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kl = cg + 8 * j;
        const bool ok =
            plain || (Mk[kl] > 0.f && (!causal || qpos >= k0 + kl));
        const float s = ok ? scale * p[i][j] : NEG;
        const float pr = plain || s > 0.5f * NEG ? expf(s - l) : 0.f;
        ds[i][j] = pr * (ds[i][j] - dl);
      }
    }
    shfl_acc<1, NC, S::ROW>(acc, ds, Ks, acc, ds, Ks, src0, cg);  // ds K
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + trow(rg, i);
    if (row >= Tq) continue;
    float* orow = dq + b * osB + (long long)row * osT + h * osH;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store4(orow + 4 * (cg + 8 * n), scale * acc[i][n][0],
             scale * acc[i][n][1], scale * acc[i][n][2],
             scale * acc[i][n][3]);
  }
}

// ----------------------------------------------------------------- dK/dV
template <int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 2 : 1)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ mask, float* __restrict__ dk,
              float* __restrict__ dv, int H, int Tq, int Tk, long long qsB,
              long long qsT, long long qsH, long long ksB, long long ksT,
              long long ksH, long long vsB, long long vsT, long long vsH,
              long long gsB, long long gsT, long long gsH, long long dksB,
              long long dksT, long long dksH, long long dvsB, long long dvsT,
              long long dvsH, int causal, float scale) {
  using S = SmemF32<D>;
  constexpr int NC = D / 32;
  constexpr int STAGE = 2 * S::TILE + 2 * BQ;   // Q, dO, LSE, delta

  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);  // BK x ROW
  float* Vs = Ks + S::TILE;                       // BK x ROW
  float* ring = Vs + S::TILE;                     // stage s at ring + s STAGE

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BK;  // causal: tile 0 is the heaviest
  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // keys trow(rg, i) (score and output rows)
  const int cg = tid & 7;   // score columns: queries cg + 8j
  const int src0 = (tid & 31) & ~7;

  const float* qb = q + b * qsB + h * qsH;
  const float* gb = dO + b * gsB + h * gsH;
  const float* mb = mask == nullptr ? nullptr : mask + (long long)b * Tk;

  async_rows<D, S::ROW, BK>(Ks, k + b * ksB + h * ksH, k0, Tk, ksT);
  async_rows<D, S::ROW, BK>(Vs, v + b * vsB + h * vsH, k0, Tk, vsT);
  bool kok[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) kok[i] = key_ok(mb, k0 + trow(rg, i), Tk);

  const int n_qt = (Tq + BQ - 1) / BQ;
  // causal: query tiles wholly before this key tile see none of its keys
  const int qt0 = causal ? k0 / BQ : 0;

  auto issue = [&](int qt) {  // Q/dO tile qt into stage (qt - qt0) & 1
    float* Qs = ring + ((qt - qt0) & 1) * STAGE;
    async_rows<D, S::ROW, BQ>(Qs, qb, qt * BQ, Tq, qsT);
    async_rows<D, S::ROW, BQ>(Qs + S::TILE, gb, qt * BQ, Tq, gsT);
    async_row_terms(Qs + 2 * S::TILE, Qs + 2 * S::TILE + BQ, lse, delta,
                    bh, qt * BQ, Tq);
    cp_async_commit();
  };

  float adk[RQ][NC][4], adv[RQ][NC][4];
  zero_acc(adk);
  zero_acc(adv);

  if (qt0 < n_qt) issue(qt0);  // with K and V
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    cp_async_wait_all();
    __syncthreads();  // tile qt is in; the stage of tile qt-1 is free
    if (qt + 1 < n_qt) issue(qt + 1);
    const float* Qs = ring + ((qt - qt0) & 1) * STAGE;
    const float* dOs = Qs + S::TILE;
    const float* Ls = dOs + S::TILE;
    const float* Dl = Ls + BQ;

    float st[RQ][RK], dst[RQ][RK];
    zero_tile(st);
    zero_tile(dst);
    if constexpr (D <= 64) {   // S^T and dP^T in one loop (spills at 128)
      tile_dot2<D, S::ROW>(st, Ks, Qs, dst, Vs, dOs, rg, cg);
    } else {
      tile_dot<D, S::ROW>(st, Ks, Qs, rg, cg);    // S^T
      tile_dot<D, S::ROW>(dst, Vs, dOs, rg, cg);  // dP^T
    }
    // a tile with no key mask, no row or key past the end and wholly
    // below the diagonal needs no test per score
    const bool plain = mb == nullptr && k0 + BK <= Tk && q0 + BQ <= Tq &&
                       (!causal || q0 >= k0 + BK - 1);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int kpos = k0 + trow(rg, i);
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int ql = cg + 8 * j;
        const int qpos = q0 + ql;
        const bool ok =
            plain || (kok[i] && qpos < Tq && (!causal || qpos >= kpos));
        const float s = ok ? scale * st[i][j] : NEG;
        const float pr = plain || s > 0.5f * NEG ? expf(s - Ls[ql]) : 0.f;
        st[i][j] = pr;
        dst[i][j] = pr * (dst[i][j] - Dl[ql]);
      }
    }
    // dV += p^T dO, dK += ds^T Q
    shfl_acc<2, NC, S::ROW>(adv, st, dOs, adk, dst, Qs, src0, cg);
  }
  cp_async_drain();  // no copy outlives the block (an empty loop)

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int key = k0 + trow(rg, i);
    if (key >= Tk) continue;
    float* krow = dk + b * dksB + (long long)key * dksT + h * dksH;
    float* vrow = dv + b * dvsB + (long long)key * dvsT + h * dvsH;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      store4(krow + 4 * (cg + 8 * n), scale * adk[i][n][0],
             scale * adk[i][n][1], scale * adk[i][n][2],
             scale * adk[i][n][3]);
      store4(vrow + 4 * (cg + 8 * n), adv[i][n][0], adv[i][n][1],
             adv[i][n][2], adv[i][n][3]);
    }
  }
}

// --------------------------------------------------------------- bfloat16
template <int D>
struct SmemBf16 {
  static constexpr int TILE = Swz<D>::TILE;
  // +1 KB to align the tiles; dQ: Q, dO, two stages of K, V and key
  // validity
  static constexpr size_t DQ_BYTES =
      1024 + 2 * TILE + 2 * 2 * TILE + sizeof(float) * 2 * BK;
  // dK/dV: K, V, two stages of Q, dO, row LSE and delta
  static constexpr size_t DKV_BYTES =
      1024 + 2 * TILE + 2 * 2 * TILE + sizeof(float) * 2 * 2 * BQ;
};

// One warpgroup owns query rows q0 .. q0 + 63 (warp w: rows 16w ..).
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dO,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ mask, bf16* __restrict__ dq,
                  int H, int Tq, int Tk, long long qsB, long long qsT,
                  long long qsH, long long ksB, long long ksT, long long ksH,
                  long long vsB, long long vsT, long long vsH, long long osB,
                  long long osT, long long osH, long long gsB, long long gsT,
                  long long gsH, int causal, float scale) {
  using S = SmemBf16<D>;
  constexpr int KS = D / 16;   // k-steps over D
  constexpr int NDT = D / 8;   // 8-column n-tiles of the output

  extern __shared__ float4 smem_f4[];
  uint8_t* Qs = align1k(reinterpret_cast<uint8_t*>(smem_f4));
  uint8_t* dOs = Qs + S::TILE;
  uint8_t* ring = dOs + S::TILE;  // stage s: K at ring + 2s TILE, V after it
  float* Ms = reinterpret_cast<float*>(ring + 4 * S::TILE);  // 2 x BK

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;

  const bf16* kb = k + b * ksB + h * ksH;
  const bf16* vb = v + b * vsB + h * vsH;
  const float* mb = mask == nullptr ? nullptr : mask + (long long)b * Tk;

  async_tile<D>(Qs, q + b * qsB + h * qsH, q0, Tq, qsT);
  async_tile<D>(dOs, dO + b * gsB + h * gsH, q0, Tq, gsT);
  // this thread's rows warp*16 + g (+8): LSE (+1e30 past Tq) in base 2,
  // and delta
  float lrow[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    lrow[i] = LOG2E * (row < Tq ? lse[(long long)bh * Tq + row] : -NEG);
    drow[i] = row < Tq ? delta[(long long)bh * Tq + row] : 0.f;
  }

  auto issue = [&](int kt) {  // K/V tile kt into stage kt & 1
    uint8_t* Ks = ring + (kt & 1) * 2 * S::TILE;
    async_tile<D>(Ks, kb, kt * BK, Tk, ksT);
    async_tile<D>(Ks + S::TILE, vb, kt * BK, Tk, vsT);
    async_key_valid(Ms + (kt & 1) * BK, mb, kt * BK, Tk);
    cp_async_commit();
  };

  const float scale_log2 = scale * LOG2E;
  const uint32_t q_a = smem_addr(Qs);
  const uint32_t o_a = smem_addr(dOs);
  const uint32_t ring_a = smem_addr(ring);
  float acc[D / 2], s[32], dp[32];
  zero(acc);
  zero(s);
  zero(dp);

  int n_kt = (Tk + BK - 1) / BK;
  if (causal) {
    const int last = (q0 + BQ - 1) / BK + 1;
    n_kt = n_kt < last ? n_kt : last;
  }

  issue(0);  // with Q and dO
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait_all();
    fence_async_proxy();
    __syncthreads();  // tile kt is in; the stage of tile kt-1 is free
    if (kt + 1 < n_kt) issue(kt + 1);
    const uint32_t k_a = ring_a + (kt & 1) * 2 * S::TILE;
    const uint32_t v_a = k_a + S::TILE;
    const float* Mk = Ms + (kt & 1) * BK;

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss64(s, desc_k<D>(q_a, kk), desc_k<D>(k_a, kk), kk);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss64(dp, desc_k<D>(o_a, kk), desc_k<D>(v_a, kk), kk);
    wg_commit();
    wg_wait0();
    reg_fence(s);
    reg_fence(dp);
    // s <- ds = p * (dp - delta), p = 2^(s scale log2e - lse log2e). A
    // tile with no key mask, no key past Tk and wholly below the diagonal
    // needs no test per score.
    if (mb == nullptr && k0 + BK <= Tk && (!causal || k0 + BK - 1 <= q0)) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int i = (x >> 1) & 1;
        s[x] = exp2f(fmaf(s[x], scale_log2, -lrow[i])) * (dp[x] - drow[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = q0 + warp * 16 + g + 8 * i;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kl = nt * 8 + 2 * t4 + e;
            const int x = 4 * nt + 2 * i + e;
            const bool ok = Mk[kl] > 0.f && (!causal || qpos >= k0 + kl);
            const float sv = ok ? scale * s[x] : NEG;
            const float p =
                sv > 0.5f * NEG ? exp2f(fmaf(sv, LOG2E, -lrow[i])) : 0.f;
            s[x] = p * (dp[x] - drow[i]);
          }
      }
    }
    uint32_t a[4][4];
    acc_to_a(a, s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], desc_mn<D>(k_a, kk));
    wg_commit();
    wg_wait0();
    reg_fence(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= Tq) continue;
    bf16* orow = dq + b * osB + (long long)row * osT + h * osH;
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(scale * acc[4 * nd + 2 * i],
                                scale * acc[4 * nd + 2 * i + 1]);
  }
}

// One warpgroup owns keys k0 .. k0 + 63 (warp w: keys 16w ..) and computes
// the transposed tiles S^T = K Q^T and dP^T = V dO^T.
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dO,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ mask, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int H, int Tq, int Tk,
                   long long qsB, long long qsT, long long qsH, long long ksB,
                   long long ksT, long long ksH, long long vsB, long long vsT,
                   long long vsH, long long gsB, long long gsT, long long gsH,
                   long long dksB, long long dksT, long long dksH,
                   long long dvsB, long long dvsT, long long dvsH,
                   int causal, float scale) {
  using S = SmemBf16<D>;
  constexpr int KS = D / 16;
  constexpr int NDT = D / 8;

  extern __shared__ float4 smem_f4[];
  uint8_t* Ks = align1k(reinterpret_cast<uint8_t*>(smem_f4));
  uint8_t* Vs = Ks + S::TILE;
  uint8_t* ring = Vs + S::TILE;  // stage s: Q at ring + 2s TILE, dO after it
  float* Lr = reinterpret_cast<float*>(ring + 4 * S::TILE);  // stage s: LSE
                                                              // at 2s BQ, delta

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BK;  // causal: tile 0 is the heaviest
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;

  const bf16* qb = q + b * qsB + h * qsH;
  const bf16* gb = dO + b * gsB + h * gsH;
  const float* mb = mask == nullptr ? nullptr : mask + (long long)b * Tk;

  async_tile<D>(Ks, k + b * ksB + h * ksH, k0, Tk, ksT);
  async_tile<D>(Vs, v + b * vsB + h * vsH, k0, Tk, vsT);
  bool kok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kok[i] = key_ok(mb, k0 + warp * 16 + g + 8 * i, Tk);

  const int n_qt = (Tq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;

  auto issue = [&](int qt) {  // Q/dO tile qt into stage (qt - qt0) & 1
    const int st = (qt - qt0) & 1;
    uint8_t* Qs = ring + st * 2 * S::TILE;
    async_tile<D>(Qs, qb, qt * BQ, Tq, qsT);
    async_tile<D>(Qs + S::TILE, gb, qt * BQ, Tq, gsT);
    async_row_terms(Lr + st * 2 * BQ, Lr + st * 2 * BQ + BQ, lse, delta, bh,
                    qt * BQ, Tq);
    cp_async_commit();
  };

  const float scale_log2 = scale * LOG2E;
  const uint32_t k_a = smem_addr(Ks);
  const uint32_t v_a = smem_addr(Vs);
  const uint32_t ring_a = smem_addr(ring);
  float adk[D / 2], adv[D / 2], st[32], dpt[32];
  zero(adk);
  zero(adv);
  zero(st);
  zero(dpt);

  if (qt0 < n_qt) issue(qt0);  // with K and V
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    const int stage = (qt - qt0) & 1;
    cp_async_wait_all();
    fence_async_proxy();
    __syncthreads();  // tile qt is in; the stage of tile qt-1 is free
    if (qt + 1 < n_qt) issue(qt + 1);
    const uint32_t q_a = ring_a + stage * 2 * S::TILE;
    const uint32_t o_a = q_a + S::TILE;
    const float* Ls = Lr + stage * 2 * BQ;
    const float* Dl = Ls + BQ;

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss64(st, desc_k<D>(k_a, kk), desc_k<D>(q_a, kk), kk);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss64(dpt, desc_k<D>(v_a, kk), desc_k<D>(o_a, kk), kk);
    wg_commit();
    wg_wait0();
    reg_fence(st);
    reg_fence(dpt);
    // st <- p^T, dpt <- ds^T; row i: key g (+8), column: query. A tile
    // with no key mask, no row or key past the end and wholly below the
    // diagonal needs no test per score.
    if (mb == nullptr && k0 + BK <= Tk && q0 + BQ <= Tq &&
        (!causal || q0 >= k0 + BK - 1)) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int ql = (x >> 2) * 8 + 2 * t4 + (x & 1);
        const float p = exp2f(fmaf(st[x], scale_log2, -LOG2E * Ls[ql]));
        st[x] = p;
        dpt[x] = p * (dpt[x] - Dl[ql]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kpos = k0 + warp * 16 + g + 8 * i;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ql = nt * 8 + 2 * t4 + e;
            const int qpos = q0 + ql;
            const int x = 4 * nt + 2 * i + e;
            const bool ok = kok[i] && qpos < Tq && (!causal || qpos >= kpos);
            const float sv = ok ? scale * st[x] : NEG;
            const float p =
                sv > 0.5f * NEG ? exp2f(fmaf(sv, LOG2E, -LOG2E * Ls[ql]))
                                : 0.f;
            st[x] = p;
            dpt[x] = p * (dpt[x] - Dl[ql]);
          }
      }
    }
    uint32_t pa[4][4], da[4][4];
    acc_to_a(pa, st);
    acc_to_a(da, dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(adv, pa[kk], desc_mn<D>(o_a, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(adk, da[kk], desc_mn<D>(q_a, kk));
    wg_commit();
    wg_wait0();
    reg_fence(adv);
    reg_fence(adk);
  }
  cp_async_drain();  // no copy outlives the block (an empty loop)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + g + 8 * i;
    if (key >= Tk) continue;
    bf16* krow = dk + b * dksB + (long long)key * dksT + h * dksH;
    bf16* vrow = dv + b * dvsB + (long long)key * dvsT + h * dvsH;
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(krow + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(scale * adk[4 * nd + 2 * i],
                                scale * adk[4 * nd + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(adv[4 * nd + 2 * i], adv[4 * nd + 2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------------ launch
template <typename T>
using DqFn = void (*)(const T*, const T*, const T*, const T*, const float*,
                      const float*, const float*, T*, int, int, int,
                      long long, long long, long long, long long, long long,
                      long long, long long, long long, long long, long long,
                      long long, long long, long long, long long, long long,
                      int, float);
template <typename T>
using DkvFn = void (*)(const T*, const T*, const T*, const T*, const float*,
                       const float*, const float*, T*, T*, int, int, int,
                       long long, long long, long long, long long, long long,
                       long long, long long, long long, long long, long long,
                       long long, long long, long long, long long, long long,
                       long long, long long, long long, int, float);

template <typename T>
cudaError_t launch_dq(DqFn<T> kernel, size_t smem, const void* q,
                      const void* k, const void* v, const void* dO,
                      const float* lse, const float* delta,
                      const float* mask, void* dq, int B, int H, int Tq,
                      int Tk, const long long* st, int causal, float scale,
                      cudaStream_t stream) {
  const cudaError_t e = grant(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta, mask,
      static_cast<T*>(dq), H, Tq, Tk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13],
      st[14], causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(DkvFn<T> kernel, size_t smem, const void* q,
                       const void* k, const void* v, const void* dO,
                       const float* lse, const float* delta,
                       const float* mask, void* dk, void* dv, int B, int H,
                       int Tq, int Tk, const long long* st, int causal,
                       float scale, cudaStream_t stream) {
  const cudaError_t e = grant(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Tk + BK - 1) / BK);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta, mask,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14], st[15], st[16], st[17], causal, scale);
  return cudaGetLastError();
}

}  // namespace


extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// (B, T, H, D) layout with a unit D stride: q, k, v, dO, then the
// outputs. lse and delta are contiguous (B*H, Tq) float32; mask is a
// contiguous (B, Tk) float32 0/1 array, or null.
int dl4j_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dO,
    const float* lse, const float* delta, const float* mask, void* dq, int B,
    int H, int Tq, int Tk, int D, long long qsB, long long qsT, long long qsH,
    long long ksB, long long ksT, long long ksH, long long vsB, long long vsT,
    long long vsH, long long gsB, long long gsT, long long gsH, long long osB,
    long long osT, long long osH, int dtype, int causal, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
  // the kernel's argument order: q, k, v, dq, dO strides
  const long long st[15] = {qsB, qsT, qsH, ksB, ksT, ksH, vsB, vsT,
                            vsH, osB, osT, osH, gsB, gsT, gsH};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DL4J_F32(DIM)                                                      \
  launch_dq<float>(flash_bwd_dq_f32<DIM>, SmemF32<DIM>::DQ_BYTES, q, k, v,  \
                   dO, lse, delta, mask, dq, B, H, Tq, Tk, st, causal,      \
                   scale, s)
#define DL4J_BF16(DIM)                                                     \
  launch_dq<bf16>(flash_bwd_dq_bf16<DIM>, SmemBf16<DIM>::DQ_BYTES, q, k, v, \
                  dO, lse, delta, mask, dq, B, H, Tq, Tk, st, causal, scale, \
                  s)
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    if (D == 32) e = DL4J_F32(32);
    else if (D == 64) e = DL4J_F32(64);
    else if (D == 128) e = DL4J_F32(128);
  } else if (dtype == 1) {
    if (D == 32) e = DL4J_BF16(32);
    else if (D == 64) e = DL4J_BF16(64);
    else if (D == 128) e = DL4J_BF16(128);
  }
#undef DL4J_F32
#undef DL4J_BF16
  return (int)e;
}

int dl4j_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dO,
    const float* lse, const float* delta, const float* mask, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int D, long long qsB,
    long long qsT, long long qsH, long long ksB, long long ksT, long long ksH,
    long long vsB, long long vsT, long long vsH, long long gsB, long long gsT,
    long long gsH, long long dksB, long long dksT, long long dksH,
    long long dvsB, long long dvsT, long long dvsH, int dtype, int causal,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
  const long long st[18] = {qsB,  qsT,  qsH,  ksB,  ksT,  ksH,
                            vsB,  vsT,  vsH,  gsB,  gsT,  gsH,
                            dksB, dksT, dksH, dvsB, dvsT, dvsH};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DL4J_F32(DIM)                                                      \
  launch_dkv<float>(flash_bwd_dkv_f32<DIM>, SmemF32<DIM>::DKV_BYTES, q, k,  \
                    v, dO, lse, delta, mask, dk, dv, B, H, Tq, Tk, st,      \
                    causal, scale, s)
#define DL4J_BF16(DIM)                                                     \
  launch_dkv<bf16>(flash_bwd_dkv_bf16<DIM>, SmemBf16<DIM>::DKV_BYTES, q, k, \
                   v, dO, lse, delta, mask, dk, dv, B, H, Tq, Tk, st, causal, \
                   scale, s)
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    if (D == 32) e = DL4J_F32(32);
    else if (D == 64) e = DL4J_F32(64);
    else if (D == 128) e = DL4J_F32(128);
  } else if (dtype == 1) {
    if (D == 32) e = DL4J_BF16(32);
    else if (D == 64) e = DL4J_BF16(64);
    else if (D == 128) e = DL4J_BF16(128);
  }
#undef DL4J_F32
#undef DL4J_BF16
  return (int)e;
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
