// Flash-attention forward for Hopper (sm_90a), f32 and bf16 inputs, head
// dims 32, 64 and 128.
//
// Replaces: deeplearning4j_tpu/ops/flash_attention.py:_attn_kernel (the
// Pallas TPU kernel launched by _flash_call). Same function: for each
// (batch, head) and query row, the online-softmax attention output O and
// the per-row log-sum-exp, with scale 1/sqrt(D), an optional (B, Tk) 0/1
// key mask and optional causal masking, both applied as scores of
// NEG = -1e30 (_masked_scores); p = 0 where a score is <= NEG/2. A
// fully-masked row gives O = 0 and an LSE of +1e30 (_finish), the sentinel
// the backward kernels depend on. Accumulation is f32; O is written in the
// input type.
//
// Design. The TPU kernel walks a sequential grid (B*H, Tq/bq, Tk/bk) and
// carries (m, l, acc) in VMEM scratch from one k-step to the next. CUDA
// blocks run in parallel and in no order, so here a block owns a (batch *
// head, 64- or 128-row query tile) and loops over 64-key K/V tiles
// itself: the loop replaces the TPU's sequential kj grid axis, and m, l
// and acc live in registers. The causal loop stops at the diagonal tile,
// and the query tiles are issued heaviest first so the causal tail is
// short. Operands are read in place through their (B, T, H, D) strides.
// The reference's 512-row TPU tile would need more than Hopper's 227 KB of
// shared memory per block, so the kernels use their own tiles and handle
// ragged edges themselves; the caller's block_q/block_k only set the
// wrapper's padding.
//
// Q is staged once. K/V tiles (with the key-validity vector) stream
// through a two-stage ring filled by cp.async (16-byte copies; rows past
// Tk are zero-filled through the src-size operand, so the ragged edge
// needs no branch): tile t+1 is in flight while tile t is computed, and a
// block passes one barrier per tile. No tensor map (TMA): the wrapper hands
// strided views (packed QKV, padded heads), and a map per operand per call
// would need the driver's encoder on every launch. The online softmax runs
// in base 2 (log2(e) folded into the scale; p is one FMA and one
// ex2.approx.ftz), and a tile with no key mask, no key past Tk and wholly
// below the causal diagonal skips the mask test per score. No atomics and
// a fixed order: two calls give bitwise-equal O and LSE.
//
// What bounds it on the H100. Per live (query, key) pair the work is 4*D
// flops (Q.K and P.V) and one exponential; operands are staged in shared
// memory, so device-memory traffic is one pass over Q, K, V and O and the
// function is bound by arithmetic at the repo's shapes (T = 2048, D = 64).
// Two routes:
//
// - float32: CUDA cores (67 TFLOP/s peak), f32 arithmetic with p by the
//   hardware ex2 (<= 2 ulp, ftz); TF32 tensor cores would break the 1e-4
//   agreement with the plain version. A block is one
//   warpgroup over 16 R query rows: each thread owns R rows (16 apart) x 8
//   interleaved keys of the score tile and the same R rows x D/8 output
//   columns, R = 8 at D <= 64 (128 rows per block; R = 4 at D = 128, where
//   8 would spill). Q.K reads shared memory with 16-byte, bank-conflict-
//   free loads (Q and K rows padded by 4 floats); 8 rows per thread feed
//   256 FMAs from 16 of them and share each K/V tile among 128 rows. The 8
//   threads of a row group are in one warp and hold their rows' p over the
//   64 keys between them, so P.V takes p by __shfl_sync: no P tile in
//   shared memory and no barrier for it. What holds it below its bound is
//   instruction issue and latency on the CUDA cores (FMAs, shared loads and
//   shuffles, at two blocks of four warps per SM).
// - bfloat16: tensor cores (989 TFLOP/s peak) through wgmma. A block is
//   two consumer warpgroups over 128 query rows (64 each, wgmma's M) that
//   share every K/V tile, which halves the K/V traffic from L2 against one
//   warpgroup per block. Tiles are stored once, in wgmma's swizzled layout
//   (128-byte swizzle; 64-byte rows and swizzle at D = 32; two 64-column
//   atoms at D = 128). S = Q K^T reads both operands K-major (m64n64k16,
//   SS); O += P V takes P from registers (S's accumulator after the
//   softmax, rounded to bf16 pairs as FlashAttention does) and reads the
//   same V bytes MN-major through wgmma's transpose-B bit (RS, N = D), so
//   no tile is staged transposed. At D = 64 a pair costs 256 matrix flops
//   per exponential, so the exponentials (16 per clock per SM) alone take
//   about as long as the bound's matrix work; each warpgroup waits for a
//   product before its softmax, and the other warpgroups on the SM fill
//   the tensor cores meanwhile.
//
// Budget per block at D = 32/64/128. Shared memory, f32: 52.5/100.5/163.5
// KB (two blocks per SM at D = 64, one at D = 128); bf16: 25.5/49.5/97.5
// KB. Above 48 KB it must be granted, so each launch first calls
// cudaFuncSetAttribute (Hopper allows 227 KB). Registers (ptxas, CUDA
// 12.8): f32 254/254/218 under __launch_bounds__(128, 2) at D <= 64 and
// (128, 1) at D = 128; bf16 111/126/157 under __launch_bounds__(256, 2)
// at D <= 64 (two blocks, 16 warps per SM) and (256, 1) at D = 128; no
// spills.
//
// Not yet: TMA with a producer warp, f32 on tensor cores (3xTF32 split),
// and S of tile t+1 in flight during the softmax of tile t at full
// occupancy (tried: see PERF.md).
//
// Interface: a plain C function, bound with ctypes. It launches on the
// given stream, allocates nothing, and returns cudaGetLastError() after
// the launch so a refused launch is seen by the caller. The copy helpers,
// the f32 tile products, the swizzled layout and the wgmma wrappers are
// sm90_common.cuh's, shared with the backward.

#include "sm90_common.cuh"

namespace {

// 2^x in one MUFU op; flushes results below 2^-126 to 0 (p that small adds
// nothing a f32 sum can keep)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- float32
template <int D>
struct SmemF32 {
  static constexpr int R = D <= 64 ? 8 : 4;  // rows per thread (8 spill at 128)
  static constexpr int ROWS = 16 * R;        // query rows per block
  static constexpr int ROW = D + 4;     // Q, K rows: conflict-free float4 reads
  static constexpr int TILE = BK * ROW;  // floats of a padded 64-row tile
  static constexpr int VTILE = BK * D;   // V rows are read whole: no pad
  static constexpr int STAGE = TILE + VTILE + BK;  // K, V, key validity
  // Q, then two stages
  static constexpr size_t BYTES = sizeof(float) * (ROWS * ROW + 2 * STAGE);
};

template <int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 2 : 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              float* __restrict__ o, float* __restrict__ lse, int H, int Tq,
              int Tk, long long qsB, long long qsT, long long qsH,
              long long ksB, long long ksT, long long ksH, long long vsB,
              long long vsT, long long vsH, long long osB, long long osT,
              long long osH, int causal, float scale) {
  using S = SmemF32<D>;
  constexpr int R = S::R;
  constexpr int NC = D / 32;  // float4 output chunks per thread and row

  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // ROWS x ROW
  float* ring = Qs + S::ROWS * S::ROW;  // stage s at ring + s STAGE: K, V,
                                        // key validity

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // heaviest tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * S::ROWS;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;           // rows trow(rg, i)
  const int cg = tid & 7;            // keys cg + 8j; output columns 4(cg + 8n)
  const int src0 = (tid & 31) & ~7;  // lane of the row group's first thread

  const float* kb = k + b * ksB + h * ksH;
  const float* vb = v + b * vsB + h * vsH;
  const float* mb = mask == nullptr ? nullptr : mask + (long long)b * Tk;

  async_rows<D, S::ROW, S::ROWS>(Qs, q + b * qsB + h * qsH, q0, Tq, qsT);

  auto issue = [&](int kt) {  // K/V tile kt into stage kt & 1
    float* Ks = ring + (kt & 1) * S::STAGE;
    async_rows<D, S::ROW, BK>(Ks, kb, kt * BK, Tk, ksT);
    async_rows<D, D, BK>(Ks + S::TILE, vb, kt * BK, Tk, vsT);
    async_key_valid(Ks + S::TILE + S::VTILE, mb, kt * BK, Tk);
    cp_async_commit();
  };

  // m is the running row maximum of scale * log2(e) * s
  const float scale_log2 = scale * LOG2E;
  float m[R], l[R], acc[R][NC][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
  }
  zero_acc(acc);

  int n_kt = (Tk + BK - 1) / BK;
  if (causal) {
    // key tiles wholly above the diagonal are fully masked: stop before them
    const int last = (q0 + S::ROWS - 1) / BK + 1;
    n_kt = n_kt < last ? n_kt : last;
  }

  issue(0);  // with Q
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait_all();
    // tile kt has landed for every thread, and every thread is past tile
    // kt-1, so its stage can be refilled
    __syncthreads();
    if (kt + 1 < n_kt) issue(kt + 1);
    const float* Ks = ring + (kt & 1) * S::STAGE;
    const float* Vs = Ks + S::TILE;
    const float* Mk = Vs + S::VTILE;

    float p[R][RK];  // raw scores, then probabilities
    zero_tile(p);
    tile_dot<D, S::ROW>(p, Qs, Ks, rg, cg);
    // a tile with no key mask, no key past Tk and wholly below the
    // diagonal needs no test per score (rows past Tq are never stored)
    const bool plain = mb == nullptr && k0 + BK <= Tk &&
                       (!causal || k0 + BK - 1 <= q0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = NEG;
      if (plain) {
#pragma unroll
        for (int j = 0; j < RK; ++j) mx = fmaxf(mx, p[i][j]);
        mx *= scale_log2;
      } else {
        const int qpos = q0 + trow(rg, i);
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          const int kl = cg + 8 * j;
          const bool ok = Mk[kl] > 0.f && (!causal || qpos >= k0 + kl);
          p[i][j] = ok ? scale_log2 * p[i][j] : NEG;
          mx = fmaxf(mx, p[i][j]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      // exp(NEG - NEG) == 1 on all-masked rows: those terms are zeroed
      const float alpha = m[i] > 0.5f * NEG ? ex2(m[i] - m_new) : 0.f;
      if (plain) {
#pragma unroll
        for (int j = 0; j < RK; ++j)
          p[i][j] = ex2(fmaf(p[i][j], scale_log2, -m_new));
      } else {
#pragma unroll
        for (int j = 0; j < RK; ++j)
          p[i][j] = p[i][j] > 0.5f * NEG ? ex2(p[i][j] - m_new) : 0.f;
      }
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) rs += p[i][j];
      rs += __shfl_xor_sync(FULL, rs, 1);
      rs += __shfl_xor_sync(FULL, rs, 2);
      rs += __shfl_xor_sync(FULL, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] *= alpha;
    }
    shfl_acc<1, NC, D>(acc, p, Vs, acc, p, Vs, src0, cg);  // acc += P V
  }

  // finish: O = acc / l (0 on fully-masked rows), LSE = m ln2 + log(l)
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + trow(rg, i);
    if (row >= Tq) continue;
    const bool dead = m[i] <= 0.5f * NEG;
    const float inv = dead ? 0.f : 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + b * osB + (long long)row * osT + h * osH;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store4(orow + 4 * (cg + 8 * n), acc[i][n][0] * inv,
             acc[i][n][1] * inv, acc[i][n][2] * inv, acc[i][n][3] * inv);
    if (cg == 0)
      lse[(long long)bh * Tq + row] =
          dead ? -NEG : m[i] * LN2 + logf(fmaxf(l[i], 1e-30f));
  }
}

// --------------------------------------------------------------- bfloat16
constexpr int NW = 2;  // consumer warpgroups per bf16 block

template <int D>
struct SmemBf16 {
  static constexpr int TILE = Swz<D>::TILE;
  // +1 KB to align the tiles; a Q tile per warpgroup, then two stages of
  // K, V and key validity
  static constexpr size_t BYTES =
      1024 + NW * TILE + 2 * 2 * TILE + sizeof(float) * 2 * BK;
};

// Warpgroup wg owns query rows q0 .. q0 + 63, q0 = q0b + 64 wg (warp w:
// rows 16w ..); the block's NW * 128 threads fill the ring together.
template <int D>
__global__ void __launch_bounds__(NW * NT, D <= 64 ? 2 : 1)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ mask,
               bf16* __restrict__ o, float* __restrict__ lse, int H, int Tq,
               int Tk, long long qsB, long long qsT, long long qsH,
               long long ksB, long long ksT, long long ksH, long long vsB,
               long long vsT, long long vsH, long long osB, long long osT,
               long long osH, int causal, float scale) {
  using S = SmemBf16<D>;
  constexpr int KS = D / 16;   // k-steps of Q K^T
  constexpr int NDT = D / 8;   // 8-column n-tiles of the output

  extern __shared__ float4 smem_f4[];
  uint8_t* Qs = align1k(reinterpret_cast<uint8_t*>(smem_f4));  // NW tiles
  uint8_t* ring = Qs + NW * S::TILE;  // stage s: K at ring + 2s TILE, V next
  float* Ms = reinterpret_cast<float*>(ring + 4 * S::TILE);  // 2 x BK

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // heaviest tiles first
  const int q0b = (gridDim.y - 1 - blockIdx.y) * (NW * BQ);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int q0 = q0b + wg * BQ;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;  // accumulator row group
  const int t4 = tid & 3;         // accumulator column pair (shuffle partners)

  const bf16* kb = k + b * ksB + h * ksH;
  const bf16* vb = v + b * vsB + h * vsH;
  const float* mb = mask == nullptr ? nullptr : mask + (long long)b * Tk;

  for (int w = 0; w < NW; ++w)
    async_tile<D, NW * NT>(Qs + w * S::TILE, q + b * qsB + h * qsH,
                           q0b + w * BQ, Tq, qsT);

  auto issue = [&](int kt) {  // K/V tile kt into stage kt & 1
    uint8_t* Ks = ring + (kt & 1) * 2 * S::TILE;
    async_tile<D, NW * NT>(Ks, kb, kt * BK, Tk, ksT);
    async_tile<D, NW * NT>(Ks + S::TILE, vb, kt * BK, Tk, vsT);
    async_key_valid(Ms + (kt & 1) * BK, mb, kt * BK, Tk);
    cp_async_commit();
  };

  // m is the running row maximum of scale * log2(e) * s; i = 0: row g,
  // i = 1: row g + 8; s[4nt + 2i + e] is key 8nt + 2 t4 + e of row i
  const float scale_log2 = scale * LOG2E;
  const uint32_t q_a = smem_addr(Qs + wg * S::TILE);
  const uint32_t ring_a = smem_addr(ring);
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[D / 2], s[32];
  zero(acc);
  zero(s);

  // the block streams the tiles its last warpgroup needs; a warpgroup
  // computes only its own (the first one stops a tile earlier when causal,
  // and one wholly past Tq computes none)
  int n_kt = (Tk + BK - 1) / BK;
  int my_kt = n_kt;
  if (causal) {
    const int last = (q0b + NW * BQ - 1) / BK + 1;
    n_kt = n_kt < last ? n_kt : last;
    const int mine = (q0 + BQ - 1) / BK + 1;
    my_kt = my_kt < mine ? my_kt : mine;
  }
  if (q0 >= Tq) my_kt = 0;

  issue(0);  // with Q
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait_all();
    fence_async_proxy();
    __syncthreads();  // tile kt is in; the stage of tile kt-1 is free
    if (kt + 1 < n_kt) issue(kt + 1);
    if (kt < my_kt) {
      const uint32_t k_a = ring_a + (kt & 1) * 2 * S::TILE;
      const uint32_t v_a = k_a + S::TILE;
      const float* Mk = Ms + (kt & 1) * BK;

      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss64(s, desc_k<D>(q_a, kk), desc_k<D>(k_a, kk), kk);
      wg_commit();
      wg_wait0();
      reg_fence(s);

      // a tile with no key mask, no key past Tk and wholly below the
      // diagonal needs no test per score
      const bool plain = mb == nullptr && k0 + BK <= Tk &&
                         (!causal || k0 + BK - 1 <= q0);
      float mx[2] = {NEG, NEG};
      if (plain) {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int i = (x >> 1) & 1;
          mx[i] = fmaxf(mx[i], s[x]);
        }
        mx[0] *= scale_log2;
        mx[1] *= scale_log2;
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
              s[x] = ok ? scale_log2 * s[x] : NEG;
              mx[i] = fmaxf(mx[i], s[x]);
            }
        }
      }
      float m_new[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        m_new[i] = fmaxf(m[i], mx[i]);
        alpha[i] = m[i] > 0.5f * NEG ? ex2(m[i] - m_new[i]) : 0.f;
      }
      if (plain) {
#pragma unroll
        for (int x = 0; x < 32; ++x)
          s[x] = ex2(fmaf(s[x], scale_log2, -m_new[(x >> 1) & 1]));
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x)
          s[x] = s[x] > 0.5f * NEG ? ex2(s[x] - m_new[(x >> 1) & 1]) : 0.f;
      }
#pragma unroll
      for (int x = 0; x < 32; ++x) rs[(x >> 1) & 1] += s[x];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(FULL, rs[i], 1);
        rs[i] += __shfl_xor_sync(FULL, rs[i], 2);
        l[i] = l[i] * alpha[i] + rs[i];
        m[i] = m_new[i];
      }
#pragma unroll
      for (int x = 0; x < D / 2; ++x) acc[x] *= alpha[(x >> 1) & 1];

      // O += P V: P rounded to bf16 pairs, V read MN-major
      uint32_t a[4][4];
      acc_to_a(a, s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, a[kk], desc_mn<D>(v_a, kk));
      wg_commit();
      wg_wait0();
      reg_fence(acc);
    }
  }

  // finish: O = acc / l (0 on fully-masked rows), LSE = m ln2 + log(l)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= Tq) continue;
    const bool dead = m[i] <= 0.5f * NEG;
    const float inv = dead ? 0.f : 1.f / fmaxf(l[i], 1e-30f);
    bf16* orow = o + b * osB + (long long)row * osT + h * osH;
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * nd + 2 * i] * inv,
                                acc[4 * nd + 2 * i + 1] * inv);
    if (t4 == 0)
      lse[(long long)bh * Tq + row] =
          dead ? -NEG : m[i] * LN2 + logf(fmaxf(l[i], 1e-30f));
  }
}

// ------------------------------------------------------------------ launch
template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, const float*, T*,
                          float*, int, int, int, long long, long long,
                          long long, long long, long long, long long,
                          long long, long long, long long, long long,
                          long long, long long, int, float);

// one block of `threads` per (batch * head, `rows` query rows)
template <typename T>
cudaError_t launch(KernelFn<T> kernel, size_t smem, int threads, int rows,
                   const void* q,
                   const void* k, const void* v, const float* mask, void* o,
                   float* lse, int B, int H, int Tq, int Tk,
                   const long long* st, int causal, float scale,
                   cudaStream_t stream) {
  const cudaError_t e = grant(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Tq + rows - 1) / rows);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, H, Tq, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// (B, T, H, D) layout with a unit D stride; lse is (B*H, Tq) float32.
// mask is a contiguous (B, Tk) float32 0/1 array, or null.
int dl4j_flash_attention_fwd(const void* q, const void* k, const void* v,
                             const float* mask, void* o, float* lse, int B,
                             int H, int Tq, int Tk, int D, long long qsB,
                             long long qsT, long long qsH, long long ksB,
                             long long ksT, long long ksH, long long vsB,
                             long long vsT, long long vsH, long long osB,
                             long long osT, long long osH, int dtype,
                             int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
  const long long st[12] = {qsB, qsT, qsH, ksB, ksT, ksH,
                            vsB, vsT, vsH, osB, osT, osH};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DL4J_F32(DIM)                                                     \
  launch<float>(flash_fwd_f32<DIM>, SmemF32<DIM>::BYTES, NT,               \
                SmemF32<DIM>::ROWS, q, k, v, mask, o, lse, B, H, Tq, Tk, st, \
                causal, scale, s)
#define DL4J_BF16(DIM)                                                     \
  launch<bf16>(flash_fwd_bf16<DIM>, SmemBf16<DIM>::BYTES, NW * NT, NW * BQ, \
               q, k, v, mask, o, lse, B, H, Tq, Tk, st, causal, scale, s)
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
