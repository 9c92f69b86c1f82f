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
// run in parallel and in no order, so each block owns one output tile and
// loops over the other operand's tiles itself, with the sums in registers:
//
// - dQ kernel: one block per (batch*head, 64-row query tile). It stages
//   the Q and dO tiles with their LSE and delta once, then loops over
//   64-key K/V tiles (stopping at the diagonal when causal); per tile it
//   recomputes p, then dp, writes ds to shared memory, and accumulates
//   ds K into registers. Query tiles issue heaviest first.
// - dK/dV kernel: one block per (batch*head, 64-key tile). It stages K and
//   V once, then loops over 64-row Q/dO tiles (starting at the first tile
//   that reaches the diagonal when causal); per tile it writes p and ds to
//   shared memory and accumulates p^T dO and ds^T Q into registers.
//
// Two passes, as in the reference, and no atomics: every gradient element
// is summed by one thread in a fixed order, so results are the same from
// run to run. (A fused one-pass FlashAttention-2 backward with atomic dQ
// adds would save recomputing p once, at the price of that determinism.)
// Operands are read in place through their (B, T, H, D) strides. Ragged
// edges are handled here: rows past Tq are zero with an LSE of +1e30 (so
// p = 0 and they add nothing), keys past Tk are masked (so padded keys get
// dK = dV = 0 through p = ds = 0).
//
// What bounds it on the H100. Per live (query, key) pair the dQ pass does
// 6*D flops (Q.K, dO.V, ds.K) and the dK/dV pass 8*D (Q.K, dO.V, p.dO,
// ds.Q); operands are staged in shared memory, so device-memory traffic is
// a few passes over Q, K, V and dO and the functions are bound by
// arithmetic at the repo's shapes (T = 2048, D = 64). Two routes:
//
// - float32: CUDA cores (67 TFLOP/s peak), which keeps f32 exact to the
//   reference (TF32 tensor cores would not be). Inner products read
//   shared memory with 16-byte, bank-conflict-free loads (rows padded by
//   4 floats; each thread owns 4 rows x 8 interleaved columns of a 64x64
//   score tile, and 4 rows x D/8 columns of an output tile).
// - bfloat16: tensor cores (989 TFLOP/s peak) through mma.sync m16n8k16,
//   FlashAttention-2 style: each warp owns 16 rows of the block's tile
//   (query rows for dQ, key rows for dK/dV) and keeps their Q/dO (resp.
//   K/V) fragments in registers; the f32 score fragments are reused as
//   the A operand of the next product after rounding p and ds to bf16,
//   as FlashAttention does. Operands read along the reduction's other
//   axis (K for ds.K; Q and dO for the dK/dV products) are also staged
//   transposed, so every B fragment is a 32-bit shared load.
//
// Not yet: cp.async/TMA double buffering, ldmatrix, wgmma.
//
// Shared memory per block, f32: dQ 55/88/153 KB and dK/dV 67/105/171 KB
// at D = 32/64/128; bf16: dQ 28/46/88 KB and dK/dV 29/56/107 KB. Above 48
// KB it must be granted, so each launch first calls cudaFuncSetAttribute
// (Hopper allows 227 KB).
//
// Interface: one plain C function per kernel, bound with ctypes. Each
// launches on the given stream, allocates nothing, and returns
// cudaGetLastError() after the launch so a refused launch is seen by the
// caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 128;   // threads per block
constexpr int RQ = 4;     // tile rows per thread (16 row groups x 4 = 64)
constexpr int RK = 8;     // tile columns per thread (8 x 8 = 64), interleaved
constexpr float NEG = -1e30f;

// ---------------------------------------------------------------- float32
// Stage rows [t0, t0 + ROWS) of one (batch, head) slice into shared memory,
// SROW floats apart; rows past t_len are zero.
template <int D, int SROW, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          int t0, int t_len, long long s_t) {
  constexpr int VPR = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
    const int r = idx / VPR;
    const int c = (idx - r * VPR) * 4;
    const int t = t0 + r;
    const float4 val = t < t_len
        ? *reinterpret_cast<const float4*>(base + (long long)t * s_t + c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * SROW + c) = val;
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[i][j] += A row (rg*RQ+i) . B row (cg+8j) over D, both tiles in
// shared memory ROW floats apart: one 4x8 block of a 64x64 product.
template <int D, int ROW>
__device__ __forceinline__ void tile_dot(float (&acc)[RQ][RK], const float* A,
                                         const float* B, int rg, int cg) {
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[RQ], bv[RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (rg * RQ + i) * ROW + d);
#pragma unroll
    for (int j = 0; j < RK; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (cg + 8 * j) * ROW + d);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        float t = acc[i][j];
        t = fmaf(av[i].x, bv[j].x, t);
        t = fmaf(av[i].y, bv[j].y, t);
        t = fmaf(av[i].z, bv[j].z, t);
        t = fmaf(av[i].w, bv[j].w, t);
        acc[i][j] = t;
      }
  }
}

// For one (64-query, 64-key) tile: p = exp(s - lse) on live entries (else
// 0) and ds = p * (dp - delta), for this thread's 4 rows x 8 columns.
// Qs/dOs/Ks/Vs are staged tiles QROW floats apart; Ms the keys' validity,
// Ls/Dl the rows' LSE and delta.
template <int D, int QROW>
__device__ __forceinline__ void probs_and_dscores(
    float (&p)[RQ][RK], float (&ds)[RQ][RK], const float* Qs,
    const float* dOs, const float* Ks, const float* Vs, const float* Ms,
    const float* Ls, const float* Dl, int q0, int k0, int causal,
    float scale, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      p[i][j] = 0.f;
      ds[i][j] = 0.f;
    }
  tile_dot<D, QROW>(p, Qs, Ks, rg, cg);     // raw scores
  tile_dot<D, QROW>(ds, dOs, Vs, rg, cg);   // dp = dO V^T
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = rg * RQ + i;
    const int qpos = q0 + r;
    const float l = Ls[r];
    const float dl = Dl[r];
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int kl = cg + 8 * j;
      const bool ok = Ms[kl] > 0.f && (!causal || qpos >= k0 + kl);
      const float s = ok ? scale * p[i][j] : NEG;
      const float pr = s > 0.5f * NEG ? expf(s - l) : 0.f;
      p[i][j] = pr;
      ds[i][j] = pr * (ds[i][j] - dl);
    }
  }
}

// Row LSE and delta of rows [q0, q0 + BQ); rows past Tq get LSE +1e30 (so
// p = 0) and delta 0. Key validity of keys [k0, k0 + BK); keys past Tk 0.
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

__device__ __forceinline__ void load_key_valid(float* Ms, const float* mb,
                                               int k0, int Tk) {
  for (int i = threadIdx.x; i < BK; i += NT) {
    const int kk = k0 + i;
    Ms[i] = kk < Tk ? (mb == nullptr ? 1.f : mb[kk]) : 0.f;
  }
}

template <int D>
struct Smem {
  static constexpr int ROW = D + 4;    // +4 floats: conflict-free float4 rows
  static constexpr int PROW = BK + 4;
  // dQ: Q, dO, K, V tiles; ds tile; key validity, row LSE and delta
  static constexpr size_t DQ_BYTES =
      sizeof(float) * (2 * BQ * ROW + 2 * BK * ROW + BQ * PROW + BK + 2 * BQ);
  // dK/dV: K, V, Q, dO tiles; p and ds tiles; the same vectors
  static constexpr size_t DKV_BYTES = sizeof(float) *
      (2 * BK * ROW + 2 * BQ * ROW + 2 * BQ * PROW + BK + 2 * BQ);
};

// ------------------------------------------------------------------- dQ
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const float* __restrict__ mask, float* __restrict__ dq, int H,
             int Tq, int Tk, long long qsB, long long qsT, long long qsH,
             long long ksB, long long ksT, long long ksH, long long vsB,
             long long vsT, long long vsH, long long osB, long long osT,
             long long osH, long long gsB, long long gsT, long long gsH,
             int causal, float scale) {
  using S = Smem<D>;
  constexpr int NC = D / 32;  // float4 output chunks per thread and row

  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // BQ x ROW
  float* dOs = Qs + BQ * S::ROW;                  // BQ x ROW
  float* Ks = dOs + BQ * S::ROW;                  // BK x ROW
  float* Vs = Ks + BK * S::ROW;                   // BK x ROW
  float* Ds = Vs + BK * S::ROW;                   // BQ x PROW: ds
  float* Ms = Ds + BQ * S::PROW;                  // BK key validity
  float* Ls = Ms + BK;                            // BQ row LSE
  float* Dl = Ls + BQ;                            // BQ row delta

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;

  const float* kb = k + b * ksB + h * ksH;
  const float* vb = v + b * vsB + h * vsH;
  const float* mb = mask == nullptr ? nullptr : mask + (long long)b * Tk;

  load_rows<D, S::ROW, BQ>(Qs, q + b * qsB + h * qsH, q0, Tq, qsT);
  load_rows<D, S::ROW, BQ>(dOs, dO + b * gsB + h * gsH, q0, Tq, gsT);
  load_row_terms(Ls, Dl, lse, delta, bh, q0, Tq);

  float acc[RQ][NC][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  int n_kt = (Tk + BK - 1) / BK;
  if (causal) {
    // key tiles wholly above the diagonal are fully masked: stop before them
    const int last = (q0 + BQ - 1) / BK + 1;
    n_kt = n_kt < last ? n_kt : last;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_rows<D, S::ROW, BK>(Ks, kb, k0, Tk, ksT);
    load_rows<D, S::ROW, BK>(Vs, vb, k0, Tk, vsT);
    load_key_valid(Ms, mb, k0, Tk);
    __syncthreads();

    float p[RQ][RK], ds[RQ][RK];
    probs_and_dscores<D, S::ROW>(p, ds, Qs, dOs, Ks, Vs, Ms, Ls, Dl, q0, k0,
                                 causal, scale, rg, cg);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) Ds[(rg * RQ + i) * S::PROW + cg + 8 * j] =
          ds[i][j];
    __syncthreads();  // ds complete

    // acc += ds K for this thread's 4 rows x D/8 columns
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float da[RQ][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float4 d4 =
            *reinterpret_cast<const float4*>(Ds + (rg * RQ + i) * S::PROW + kk);
        da[i][0] = d4.x;
        da[i][1] = d4.y;
        da[i][2] = d4.z;
        da[i][3] = d4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 kv[NC];
#pragma unroll
        for (int n = 0; n < NC; ++n)
          kv[n] = *reinterpret_cast<const float4*>(Ks + (kk + u) * S::ROW +
                                                   4 * (cg + 8 * n));
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float a = da[i][u];
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            acc[i][n][0] = fmaf(a, kv[n].x, acc[i][n][0]);
            acc[i][n][1] = fmaf(a, kv[n].y, acc[i][n][1]);
            acc[i][n][2] = fmaf(a, kv[n].z, acc[i][n][2]);
            acc[i][n][3] = fmaf(a, kv[n].w, acc[i][n][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + rg * RQ + i;
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
__global__ void __launch_bounds__(NT)
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
  using S = Smem<D>;
  constexpr int NC = D / 32;

  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);  // BK x ROW
  float* Vs = Ks + BK * S::ROW;                   // BK x ROW
  float* Qs = Vs + BK * S::ROW;                   // BQ x ROW
  float* dOs = Qs + BQ * S::ROW;                  // BQ x ROW
  float* Ps = dOs + BQ * S::ROW;                  // BQ x PROW: p
  float* Ds = Ps + BQ * S::PROW;                  // BQ x PROW: ds
  float* Ms = Ds + BQ * S::PROW;                  // BK key validity
  float* Ls = Ms + BK;                            // BQ row LSE
  float* Dl = Ls + BQ;                            // BQ row delta

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BK;  // causal: tile 0 is the heaviest
  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // score tile: query rows; output: key rows
  const int cg = tid & 7;

  const float* qb = q + b * qsB + h * qsH;
  const float* gb = dO + b * gsB + h * gsH;

  load_rows<D, S::ROW, BK>(Ks, k + b * ksB + h * ksH, k0, Tk, ksT);
  load_rows<D, S::ROW, BK>(Vs, v + b * vsB + h * vsH, k0, Tk, vsT);
  load_key_valid(Ms, mask == nullptr ? nullptr : mask + (long long)b * Tk,
                 k0, Tk);

  float adk[RQ][NC][4], adv[RQ][NC][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        adk[i][n][e] = 0.f;
        adv[i][n][e] = 0.f;
      }

  const int n_qt = (Tq + BQ - 1) / BQ;
  // causal: query tiles wholly before this key tile see none of its keys
  const int qt0 = causal ? k0 / BQ : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_rows<D, S::ROW, BQ>(Qs, qb, q0, Tq, qsT);
    load_rows<D, S::ROW, BQ>(dOs, gb, q0, Tq, gsT);
    load_row_terms(Ls, Dl, lse, delta, bh, q0, Tq);
    __syncthreads();

    float p[RQ][RK], ds[RQ][RK];
    probs_and_dscores<D, S::ROW>(p, ds, Qs, dOs, Ks, Vs, Ms, Ls, Dl, q0, k0,
                                 causal, scale, rg, cg);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int at = (rg * RQ + i) * S::PROW + cg + 8 * j;
        Ps[at] = p[i][j];
        Ds[at] = ds[i][j];
      }
    __syncthreads();  // p and ds complete

    // dV += p^T dO and dK += ds^T Q for keys rg*RQ.. and D/8 columns
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(Ps + r * S::PROW + rg * RQ);
      const float4 d4 =
          *reinterpret_cast<const float4*>(Ds + r * S::PROW + rg * RQ);
      const float pa[RQ] = {p4.x, p4.y, p4.z, p4.w};
      const float da[RQ] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 g4 =
            *reinterpret_cast<const float4*>(dOs + r * S::ROW + 4 * (cg + 8 * n));
        const float4 q4 =
            *reinterpret_cast<const float4*>(Qs + r * S::ROW + 4 * (cg + 8 * n));
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          adv[i][n][0] = fmaf(pa[i], g4.x, adv[i][n][0]);
          adv[i][n][1] = fmaf(pa[i], g4.y, adv[i][n][1]);
          adv[i][n][2] = fmaf(pa[i], g4.z, adv[i][n][2]);
          adv[i][n][3] = fmaf(pa[i], g4.w, adv[i][n][3]);
          adk[i][n][0] = fmaf(da[i], q4.x, adk[i][n][0]);
          adk[i][n][1] = fmaf(da[i], q4.y, adk[i][n][1]);
          adk[i][n][2] = fmaf(da[i], q4.z, adk[i][n][2]);
          adk[i][n][3] = fmaf(da[i], q4.w, adk[i][n][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int key = k0 + rg * RQ + i;
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
constexpr int KPAD = 8;  // bf16 pad per shared row: conflict-free 32-bit loads
constexpr int NST = 8;   // 8-column n-tiles of a 64-wide score tile

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// d += A (16x16, row) * B (16x8, col), bf16 in, f32 accumulate. Fragments
// (PTX ISA, mma.m16n8k16): with g = lane/4 and t = lane%4,
//   a0 (row g, cols 2t..2t+1)  a1 (row g+8, same)  a2/a3 the same at cols +8
//   b0 (rows 2t..2t+1, col g)  b1 (rows +8)
//   d0,d1 (row g, cols 2t..2t+1)  d2,d3 (row g+8, same)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage rows [t0, t0 + ROWS) (rows past t_len zero) as bf16: row-major,
// SROW apart, into `rows`; and, when `cols` is not null, transposed too,
// element (r, c) at cols[c * TROW + r].
template <int D, int ROWS, int SROW, int TROW>
__device__ __forceinline__ void stage_bf16(bf16* rows, bf16* cols,
                                           const bf16* base, int t0,
                                           int t_len, long long s_t) {
  constexpr int VPR = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
    const int r = idx / VPR;
    const int c = (idx - r * VPR) * 8;
    const int t = t0 + r;
    const uint4 val = t < t_len
        ? *reinterpret_cast<const uint4*>(base + (long long)t * s_t + c)
        : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(rows + r * SROW + c) = val;
    if (cols != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) cols[(c + i) * TROW + r] = e[i];
    }
  }
}

// A fragments of 16 rows [row0, row0 + 16) x D of a row-major tile
template <int KS, int SROW>
__device__ __forceinline__ void load_a(uint32_t (&f)[KS][4], const bf16* tile,
                                       int row0, int g, int t4) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* p = tile + (row0 + g) * SROW + ks * 16 + 2 * t4;
    f[ks][0] = ld32(p);
    f[ks][1] = ld32(p + 8 * SROW);
    f[ks][2] = ld32(p + 8);
    f[ks][3] = ld32(p + 8 * SROW + 8);
  }
}

// c = A (16 x D, fragments) . B^T for the 64 rows of row-major tile B:
// a 16 x 64 f32 product in NST n-tile fragments
template <int KS, int SROW>
__device__ __forceinline__ void frag_dot(float (&c)[NST][4],
                                         const uint32_t (&a)[KS][4],
                                         const bf16* B, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < NST; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const bf16* p = B + (nt * 8 + g) * SROW + ks * 16 + 2 * t4;
      mma_bf16(c[nt], a[ks][0], a[ks][1], a[ks][2], a[ks][3], ld32(p),
               ld32(p + 8));
    }
  }
}

// acc (16 x D) += c (16 x 64, f32 fragments rounded to bf16) . B, with B
// (64 x D) staged transposed (Bt[d * TROW + row]): the fragments of
// n-tiles 2kk and 2kk+1 are the A fragment of k-step kk
template <int NDT, int TROW>
__device__ __forceinline__ void frag_acc(float (&acc)[NDT][4],
                                         const float (&c)[NST][4],
                                         const bf16* Bt, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < NST / 2; ++kk) {
    const uint32_t a0 = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    const uint32_t a1 = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    const uint32_t a2 = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd) {
      const bf16* p = Bt + (nd * 8 + g) * TROW + kk * 16 + 2 * t4;
      mma_bf16(acc[nd], a0, a1, a2, a3, ld32(p), ld32(p + 8));
    }
  }
}

template <int D>
struct SmemBf16 {
  static constexpr int ROW = D + KPAD;    // row-major tiles
  static constexpr int TROW = BQ + KPAD;  // transposed tiles: D rows of 64
  // dQ: Q, dO, K, V row-major, K transposed; key validity, LSE, delta
  static constexpr size_t DQ_BYTES =
      sizeof(bf16) * (2 * BQ * ROW + 2 * BK * ROW + D * TROW) +
      sizeof(float) * (BK + 2 * BQ);
  // dK/dV: K, V, Q, dO row-major, Q and dO transposed; the same vectors
  static constexpr size_t DKV_BYTES =
      sizeof(bf16) * (2 * BK * ROW + 2 * BQ * ROW + 2 * D * TROW) +
      sizeof(float) * (BK + 2 * BQ);
};

// Each warp owns query rows warp*16 .. +15 of the block's 64.
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
  bf16* Qs = reinterpret_cast<bf16*>(smem_f4);   // BQ x ROW
  bf16* dOs = Qs + BQ * S::ROW;                  // BQ x ROW
  bf16* Ks = dOs + BQ * S::ROW;                  // BK x ROW
  bf16* Vs = Ks + BK * S::ROW;                   // BK x ROW
  bf16* Kt = Vs + BK * S::ROW;                   // D x TROW (K transposed)
  float* Ms = reinterpret_cast<float*>(Kt + D * S::TROW);
  float* Ls = Ms + BK;
  float* Dl = Ls + BQ;

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

  stage_bf16<D, BQ, S::ROW, S::TROW>(Qs, nullptr, q + b * qsB + h * qsH, q0,
                                     Tq, qsT);
  stage_bf16<D, BQ, S::ROW, S::TROW>(dOs, nullptr, dO + b * gsB + h * gsH,
                                     q0, Tq, gsT);
  load_row_terms(Ls, Dl, lse, delta, bh, q0, Tq);
  __syncthreads();
  uint32_t qf[KS][4], of[KS][4];
  load_a<KS, S::ROW>(qf, Qs, warp * 16, g, t4);
  load_a<KS, S::ROW>(of, dOs, warp * 16, g, t4);

  float acc[NDT][4];
#pragma unroll
  for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  int n_kt = (Tk + BK - 1) / BK;
  if (causal) {
    const int last = (q0 + BQ - 1) / BK + 1;
    n_kt = n_kt < last ? n_kt : last;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<D, BK, S::ROW, S::TROW>(Ks, Kt, kb, k0, Tk, ksT);
    stage_bf16<D, BK, S::ROW, S::TROW>(Vs, nullptr, vb, k0, Tk, vsT);
    load_key_valid(Ms, mb, k0, Tk);
    __syncthreads();

    float s[NST][4], dp[NST][4];
    frag_dot<KS, S::ROW>(s, qf, Ks, g, t4);
    frag_dot<KS, S::ROW>(dp, of, Vs, g, t4);
    // s <- ds = p * (dp - delta); i = 0: row g, i = 1: row g+8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      const int qpos = q0 + r;
      const float l = Ls[r];
      const float dl = Dl[r];
#pragma unroll
      for (int nt = 0; nt < NST; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kl = nt * 8 + 2 * t4 + e;
          const bool ok = Ms[kl] > 0.f && (!causal || qpos >= k0 + kl);
          const float sv = ok ? scale * s[nt][2 * i + e] : NEG;
          const float p = sv > 0.5f * NEG ? expf(sv - l) : 0.f;
          s[nt][2 * i + e] = p * (dp[nt][2 * i + e] - dl);
        }
    }
    frag_acc<NDT, S::TROW>(acc, s, Kt, g, t4);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= Tq) continue;
    bf16* orow = dq + b * osB + (long long)row * osT + h * osH;
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(scale * acc[nd][2 * i],
                                scale * acc[nd][2 * i + 1]);
  }
}

// Each warp owns keys warp*16 .. +15 of the block's 64 and computes the
// transposed tiles S^T = K Q^T and dP^T = V dO^T directly.
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
  bf16* Ks = reinterpret_cast<bf16*>(smem_f4);   // BK x ROW
  bf16* Vs = Ks + BK * S::ROW;                   // BK x ROW
  bf16* Qs = Vs + BK * S::ROW;                   // BQ x ROW
  bf16* dOs = Qs + BQ * S::ROW;                  // BQ x ROW
  bf16* Qt = dOs + BQ * S::ROW;                  // D x TROW (Q transposed)
  bf16* dOt = Qt + D * S::TROW;                  // D x TROW (dO transposed)
  float* Ms = reinterpret_cast<float*>(dOt + D * S::TROW);
  float* Ls = Ms + BK;
  float* Dl = Ls + BQ;

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

  stage_bf16<D, BK, S::ROW, S::TROW>(Ks, nullptr, k + b * ksB + h * ksH, k0,
                                     Tk, ksT);
  stage_bf16<D, BK, S::ROW, S::TROW>(Vs, nullptr, v + b * vsB + h * vsH, k0,
                                     Tk, vsT);
  load_key_valid(Ms, mask == nullptr ? nullptr : mask + (long long)b * Tk,
                 k0, Tk);
  __syncthreads();
  uint32_t kf[KS][4], vf[KS][4];
  load_a<KS, S::ROW>(kf, Ks, warp * 16, g, t4);
  load_a<KS, S::ROW>(vf, Vs, warp * 16, g, t4);

  float adk[NDT][4], adv[NDT][4];
#pragma unroll
  for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      adk[nd][e] = 0.f;
      adv[nd][e] = 0.f;
    }

  const int n_qt = (Tq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<D, BQ, S::ROW, S::TROW>(Qs, Qt, qb, q0, Tq, qsT);
    stage_bf16<D, BQ, S::ROW, S::TROW>(dOs, dOt, gb, q0, Tq, gsT);
    load_row_terms(Ls, Dl, lse, delta, bh, q0, Tq);
    __syncthreads();

    float st[NST][4], dst[NST][4];
    frag_dot<KS, S::ROW>(st, kf, Qs, g, t4);    // S^T for this warp's keys
    frag_dot<KS, S::ROW>(dst, vf, dOs, g, t4);  // dP^T
    // st <- p^T, dst <- ds^T; i = 0: key g, i = 1: key g+8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kl = warp * 16 + g + 8 * i;
      const bool key_ok = Ms[kl] > 0.f;
      const int kpos = k0 + kl;
#pragma unroll
      for (int nt = 0; nt < NST; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = nt * 8 + 2 * t4 + e;
          const bool ok = key_ok && (!causal || q0 + ql >= kpos);
          const float sv = ok ? scale * st[nt][2 * i + e] : NEG;
          const float p = sv > 0.5f * NEG ? expf(sv - Ls[ql]) : 0.f;
          st[nt][2 * i + e] = p;
          dst[nt][2 * i + e] = p * (dst[nt][2 * i + e] - Dl[ql]);
        }
    }
    frag_acc<NDT, S::TROW>(adv, st, dOt, g, t4);   // dV += p^T dO
    frag_acc<NDT, S::TROW>(adk, dst, Qt, g, t4);   // dK += ds^T Q
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + g + 8 * i;
    if (key >= Tk) continue;
    bf16* krow = dk + b * dksB + (long long)key * dksT + h * dksH;
    bf16* vrow = dv + b * dvsB + (long long)key * dvsT + h * dvsH;
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(krow + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(scale * adk[nd][2 * i],
                                scale * adk[nd][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(adv[nd][2 * i], adv[nd][2 * i + 1]);
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

// above 48 KB a block's shared memory must be granted explicitly; the
// grant is per device, so it is made on every launch (it costs ~1 us)
template <typename K>
cudaError_t grant(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

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
#define DL4J_F32(DIM)                                                     \
  launch_dq<float>(flash_bwd_dq_f32<DIM>, Smem<DIM>::DQ_BYTES, q, k, v, dO, lse, \
                   delta, mask, dq, B, H, Tq, Tk, st, causal, scale, s)
#define DL4J_BF16(DIM)                                                    \
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
#define DL4J_F32(DIM)                                                     \
  launch_dkv<float>(flash_bwd_dkv_f32<DIM>, Smem<DIM>::DKV_BYTES, q, k, v, dO,   \
                    lse, delta, mask, dk, dv, B, H, Tq, Tk, st, causal,      \
                    scale, s)
#define DL4J_BF16(DIM)                                                    \
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
