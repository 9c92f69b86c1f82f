// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): tile shapes, cp.async
// copies and the f32 register-tile products fed from shared memory, and
// for bf16 the swizzled tile layout, wgmma's shared-memory descriptors, the
// wgmma wrappers and their fences. Everything is reached by inline PTX, so
// a source needs no CUTLASS include and no -lcuda.
//
// Each including source is its own shared library, so the anonymous
// namespace gives every library one private copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 128;   // threads per block (one warpgroup)
constexpr int RQ = 4;     // tile rows per thread, the helpers' default R
                          // (16 row groups x 4 = 64)
constexpr int RK = 8;     // tile columns per thread (8 x 8 = 64), interleaved
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(BQ == BK && NT == 2 * BQ, "tile shapes the loaders assume");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// f32 tiles: row i of row group rg (rows 16 apart, so the 4 row groups of
// a warp read 4 consecutive, bank-disjoint rows)
__device__ __forceinline__ int trow(int rg, int i) { return rg + 16 * i; }

// above 48 KB a block's shared memory must be granted explicitly; the
// grant is per device, so it is made on every launch (it costs ~1 us)
template <typename K>
cudaError_t grant(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ------------------------------------------------------------ async copy
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until cp_async_wait_all; zeros
// (and no read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// every copy this thread issued, committed or not, has landed
__device__ __forceinline__ void cp_async_drain() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Validity of keys [k0, k0 + BK): the mask's value, 0 past Tk
__device__ __forceinline__ void async_key_valid(float* Ms, const float* mb,
                                                int k0, int Tk) {
  for (int i = threadIdx.x; i < BK; i += NT) {
    const int kk = k0 + i;
    const bool ok = kk < Tk;
    if (mb != nullptr) cp_async4(Ms + i, mb + (ok ? kk : 0), ok);
    else Ms[i] = ok ? 1.f : 0.f;
  }
}

// ---------------------------------------------------------------- float32
// Stage rows [t0, t0 + ROWS) of one (batch, head) slice into shared memory,
// SROW floats apart, by cp.async; rows past t_len are zero.
template <int D, int SROW, int ROWS>
__device__ __forceinline__ void async_rows(float* dst, const float* base,
                                           int t0, int t_len, long long s_t) {
  constexpr int VPR = D / 4;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
    const int r = idx / VPR;
    const int c = (idx - r * VPR) * 4;
    const int t = t0 + r;
    const bool ok = t < t_len;
    cp_async16(dst + r * SROW + c, base + (ok ? (long long)t * s_t + c : 0),
               ok);
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[i][j] += A row trow(rg, i) . B row (cg + 8j) over D, both tiles in
// shared memory ROW floats apart: one R x 8 block of a (16 R) x 64 product.
template <int D, int ROW, int R = RQ>
__device__ __forceinline__ void tile_dot(float (&acc)[R][RK], const float* A,
                                         const float* B, int rg, int cg) {
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[R], bv[RK];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + trow(rg, i) * ROW + d);
#pragma unroll
    for (int j = 0; j < RK; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (cg + 8 * j) * ROW + d);
#pragma unroll
    for (int i = 0; i < R; ++i)
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

// acc[i] += a[i][:] B for the rows trow(rg, i): a holds 64 columns spread
// over the row group's 8 threads (thread s: columns s + 8j), B has 64 rows
// SROW floats apart, and this thread sums output columns 4(cg + 8n) .. +3.
// The row group's values arrive by shuffle from lane src0 + s, columns in
// the fixed order s, then j. Two products at once (dK/dV: p^T dO and
// ds^T Q) share the loop; dQ and the forward pass the same one twice with
// NP = 1.
template <int NP, int NC, int SROW, int R = RQ>
__device__ __forceinline__ void shfl_acc(float (&acc1)[R][NC][4],
                                         const float (&a1)[R][RK],
                                         const float* B1,
                                         float (&acc2)[R][NC][4],
                                         const float (&a2)[R][RK],
                                         const float* B2, int src0, int cg) {
#pragma unroll 2
  for (int s = 0; s < 8; ++s) {
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int off = (s + 8 * j) * SROW;
      float4 b1[NC], b2[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        b1[n] = *reinterpret_cast<const float4*>(B1 + off + 4 * (cg + 8 * n));
        if (NP == 2)
          b2[n] = *reinterpret_cast<const float4*>(B2 + off + 4 * (cg + 8 * n));
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float x1 = __shfl_sync(FULL, a1[i][j], src0 + s);
        const float x2 = NP == 2 ? __shfl_sync(FULL, a2[i][j], src0 + s) : 0.f;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          acc1[i][n][0] = fmaf(x1, b1[n].x, acc1[i][n][0]);
          acc1[i][n][1] = fmaf(x1, b1[n].y, acc1[i][n][1]);
          acc1[i][n][2] = fmaf(x1, b1[n].z, acc1[i][n][2]);
          acc1[i][n][3] = fmaf(x1, b1[n].w, acc1[i][n][3]);
          if (NP == 2) {
            acc2[i][n][0] = fmaf(x2, b2[n].x, acc2[i][n][0]);
            acc2[i][n][1] = fmaf(x2, b2[n].y, acc2[i][n][1]);
            acc2[i][n][2] = fmaf(x2, b2[n].z, acc2[i][n][2]);
            acc2[i][n][3] = fmaf(x2, b2[n].w, acc2[i][n][3]);
          }
        }
      }
    }
  }
}

template <int NC, int R = RQ>
__device__ __forceinline__ void zero_acc(float (&acc)[R][NC][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
}

template <int R = RQ>
__device__ __forceinline__ void zero_tile(float (&t)[R][RK]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) t[i][j] = 0.f;
}

// --------------------------------------------------------------- bfloat16
// A 64-row bf16 tile in wgmma's swizzled layout: column blocks of AC
// columns (one swizzle atom wide), each 64 rows of RB bytes; the 16-byte
// chunk c of row r sits at chunk c ^ (row bits), as the hardware reads it
// (128-byte swizzle: r & 7; 64-byte swizzle: (r >> 1) & 3). Tiles start
// 1024-byte aligned.
template <int D>
struct Swz {
  static constexpr int AC = D < 64 ? D : 64;
  static constexpr int RB = 2 * AC;              // bytes per atom row
  static constexpr int CPR = RB / 16;            // 16-byte chunks per atom row
  static constexpr int CB = D / AC;              // column blocks
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : 2;  // 128B / 64B swizzle
  static constexpr int TILE = BQ * D * 2;        // bytes of a 64-row tile
  static_assert(RB == 128 || RB == 64, "head dims 32, 64, 128");

  static __device__ __forceinline__ int at(int r, int ch) {
    const int cb = ch / CPR;
    const int c = ch - cb * CPR;
    const int sw = RB == 128 ? (r & 7) : ((r >> 1) & 3);
    return cb * (BQ * RB) + r * RB + ((c ^ sw) << 4);
  }
};

// Stage rows [t0, t0 + 64) by cp.async into a swizzled tile, shared out
// over a block of NTH threads; rows past t_len are zero.
template <int D, int NTH = NT>
__device__ __forceinline__ void async_tile(uint8_t* dst, const bf16* base,
                                           int t0, int t_len, long long s_t) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int idx = threadIdx.x; idx < BQ * CH; idx += NTH) {
    const int r = idx / CH;
    const int ch = idx - r * CH;
    const int t = t0 + r;
    const bool ok = t < t_len;
    cp_async16(dst + Swz<D>::at(r, ch),
               base + (ok ? (long long)t * s_t + ch * 8 : 0), ok);
  }
}

__device__ __forceinline__ uint8_t* align1k(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// A tile read K-major (the reduction runs along D): k-step kk is columns
// [16kk, 16kk + 16); 8-row groups are 8 atom rows apart. Within an atom
// the step is a 32-byte offset of the start address.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using W = Swz<D>;
  const int byte = kk * 32;
  return gmma_desc(tile + (byte / W::RB) * (BQ * W::RB) + byte % W::RB, 16,
                   8 * W::RB, W::LAYOUT);
}

// A tile read MN-major (the reduction runs along its rows; transpose-B):
// k-step kk is rows [16kk, 16kk + 16) over all D columns; 8-row groups
// 8 atom rows apart, column blocks 64 rows apart.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using W = Swz<D>;
  return gmma_desc(tile + kk * 16 * W::RB, BQ * W::RB, 8 * W::RB, W::LAYOUT);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the generic-proxy (cp.async) writes to shared memory are seen by wgmma
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads across wgmma's wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DL4J_F4(b) "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3])
#define DL4J_F16(b) DL4J_F4(b), DL4J_F4(b + 4), DL4J_F4(b + 8), DL4J_F4(b + 12)

// d (64 x 64) = A (64 x 16) B (16 x 64) (+ d when `accumulate`), A and B
// both read K-major from shared memory. Accumulator layout (per warp w,
// lane g*4 + t): d[4j + 2i + e] is row 16w + g + 8i, column 8j + 2t + e.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DL4J_F16(0), DL4J_F16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N) += A (64 x 16, bf16 pairs in registers, mma.sync's A
// fragment per warp) B (16 x N), B read MN-major (transpose-B)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : DL4J_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DL4J_F16(0), DL4J_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : DL4J_F16(0), DL4J_F16(16), DL4J_F16(32), DL4J_F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef DL4J_F16
#undef DL4J_F4

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // one cvt.rn.bf16x2
  return *reinterpret_cast<uint32_t*>(&h);
}

// The 64 x 64 f32 accumulator c rounded to bf16 as the A operand of four
// k-steps over its 64 columns: k-step kk is n-tiles 2kk and 2kk + 1.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4],
                                         const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

}  // namespace
