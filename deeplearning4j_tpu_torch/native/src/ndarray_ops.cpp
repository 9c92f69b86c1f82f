// ndarray_ops — the host half of the INDArray op contract.
//
// SURVEY.md §2.1: the reference consumes ND4J's C++ kernel library
// (libnd4j) through the INDArray surface — gemm
// (LSTMHelpers.java:212,522,616), im2col (ConvolutionLayer.java:215),
// elementwise Transforms, reductions, broadcasts, random. On TPU the
// device half of that contract IS XLA (by-design collapse, SURVEY §7);
// this file is the "nd4j-native backend" analog: the host CPU fallback /
// ETL path of the same op surface, OpenMP-parallel, plain C ABI for
// ctypes. Consumers: deeplearning4j_tpu/native/ndarray.py (HostNDArray),
// clustering (pairwise distances), data fetchers (u8→f32 scale).
//
// All matrices are row-major f32; callers flatten leading dims so every
// reduction/broadcast is a (rows, cols) problem.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline uint64_t splitmix(uint64_t* s) {
    uint64_t z = (*s += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

inline float u01(uint64_t* s) {
    return (float)((splitmix(s) >> 40) * (1.0 / 16777216.0));
}

}  // namespace

extern "C" {

// ---------------------------------------------------------- BLAS L1 ----
float dot_f32(const float* x, const float* y, int64_t n) {
    double acc = 0.0;
#ifdef _OPENMP
#pragma omp parallel for reduction(+ : acc) if (n > 65536)
#endif
    for (int64_t i = 0; i < n; ++i) acc += (double)x[i] * y[i];
    return (float)acc;
}

void axpy_f32(float alpha, const float* x, float* y, int64_t n) {
#ifdef _OPENMP
#pragma omp parallel for if (n > 65536)
#endif
    for (int64_t i = 0; i < n; ++i) y[i] += alpha * x[i];
}

float nrm2_f32(const float* x, int64_t n) {
    double acc = 0.0;
#ifdef _OPENMP
#pragma omp parallel for reduction(+ : acc) if (n > 65536)
#endif
    for (int64_t i = 0; i < n; ++i) acc += (double)x[i] * x[i];
    return (float)std::sqrt(acc);
}

// ---------------------------------------------------------- BLAS L3 ----
// C = alpha * op(A) @ op(B) + beta * C, row-major. Blocked + OpenMP over
// row panels; the inner kernel is the k-outer ikj order so the compiler
// vectorizes the j loop (no transposed loads in the hot path: op(A)/op(B)
// are materialized panel-wise).
void gemm_f32(int32_t trans_a, int32_t trans_b, int64_t m, int64_t n,
              int64_t k, float alpha, const float* A, const float* B,
              float beta, float* C) {
    const int64_t MC = 64, KC = 256;
#ifdef _OPENMP
#pragma omp parallel if (m * n * k > 1 << 18)
#endif
    {
        float* a_panel = new float[MC * KC];
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
        for (int64_t i0 = 0; i0 < m; i0 += MC) {
            int64_t ib = std::min(MC, m - i0);
            for (int64_t i = i0; i < i0 + ib; ++i)
                for (int64_t j = 0; j < n; ++j)
                    C[i * n + j] = beta == 0.0f ? 0.0f : C[i * n + j] * beta;
            for (int64_t k0 = 0; k0 < k; k0 += KC) {
                int64_t kb = std::min(KC, k - k0);
                // pack op(A)[i0:i0+ib, k0:k0+kb]
                for (int64_t i = 0; i < ib; ++i)
                    for (int64_t kk = 0; kk < kb; ++kk)
                        a_panel[i * kb + kk] =
                            trans_a ? A[(k0 + kk) * m + (i0 + i)]
                                    : A[(i0 + i) * k + (k0 + kk)];
                for (int64_t i = 0; i < ib; ++i) {
                    float* c_row = C + (i0 + i) * n;
                    for (int64_t kk = 0; kk < kb; ++kk) {
                        float a = alpha * a_panel[i * kb + kk];
                        const float* b_row =
                            trans_b ? nullptr : B + (k0 + kk) * n;
                        if (trans_b) {
                            for (int64_t j = 0; j < n; ++j)
                                c_row[j] += a * B[j * k + (k0 + kk)];
                        } else {
                            for (int64_t j = 0; j < n; ++j)
                                c_row[j] += a * b_row[j];
                        }
                    }
                }
            }
        }
        delete[] a_panel;
    }
}

// ------------------------------------------------------- elementwise ----
// Transform op codes (keep in sync with ndarray.py):
// 0 exp 1 log 2 tanh 3 sigmoid 4 relu 5 sqrt 6 abs 7 neg 8 square
// 9 add_scalar 10 mul_scalar 11 pow_scalar 12 clip_min 13 clip_max
// 14 sign 15 reciprocal
void transform_f32(int32_t op, const float* x, int64_t n, float arg,
                   float* out) {
#ifdef _OPENMP
#pragma omp parallel for if (n > 32768)
#endif
    for (int64_t i = 0; i < n; ++i) {
        float v = x[i];
        switch (op) {
            case 0: v = std::exp(v); break;
            case 1: v = std::log(v); break;
            case 2: v = std::tanh(v); break;
            case 3: v = 1.0f / (1.0f + std::exp(-v)); break;
            case 4: v = std::max(v, 0.0f); break;  // NaN propagates, as numpy
            case 5: v = std::sqrt(v); break;
            case 6: v = std::fabs(v); break;
            case 7: v = -v; break;
            case 8: v = v * v; break;
            case 9: v = v + arg; break;
            case 10: v = v * arg; break;
            case 11: v = std::pow(v, arg); break;
            case 12: v = std::max(v, arg); break;
            case 13: v = std::min(v, arg); break;
            case 14: v = (v > 0.0f) - (v < 0.0f); break;
            case 15: v = 1.0f / v; break;
        }
        out[i] = v;
    }
}

// Binary op codes: 0 add 1 sub 2 mul 3 div 4 max 5 min
void binary_f32(int32_t op, const float* a, const float* b, int64_t n,
                float* out) {
#ifdef _OPENMP
#pragma omp parallel for if (n > 32768)
#endif
    for (int64_t i = 0; i < n; ++i) {
        float x = a[i], y = b[i], v = 0.0f;
        switch (op) {
            case 0: v = x + y; break;
            case 1: v = x - y; break;
            case 2: v = x * y; break;
            case 3: v = x / y; break;
            case 4: v = std::max(x, y); break;
            case 5: v = std::min(x, y); break;
        }
        out[i] = v;
    }
}

// Broadcast a length-`cols` vector over each row. Same binary op codes.
void broadcast_row_f32(int32_t op, const float* x, int64_t rows,
                       int64_t cols, const float* vec, float* out) {
#ifdef _OPENMP
#pragma omp parallel for if (rows * cols > 32768)
#endif
    for (int64_t r = 0; r < rows; ++r) {
        const float* xr = x + r * cols;
        float* or_ = out + r * cols;
        for (int64_t c = 0; c < cols; ++c) {
            float a = xr[c], b = vec[c], v = 0.0f;
            switch (op) {
                case 0: v = a + b; break;
                case 1: v = a - b; break;
                case 2: v = a * b; break;
                case 3: v = a / b; break;
                case 4: v = std::max(a, b); break;
                case 5: v = std::min(a, b); break;
            }
            or_[c] = v;
        }
    }
}

// -------------------------------------------------------- reductions ----
// Reduce op codes: 0 sum 1 mean 2 max 3 min 4 argmax 5 norm2
// axis=1 (per row, out[rows]) or axis=0 (per col, out[cols]).
void reduce_f32(int32_t op, const float* x, int64_t rows, int64_t cols,
                int32_t axis, float* out) {
    if (rows == 0 || cols == 0) {   // empty reduced dim: sum→0, else NaN
        int64_t n = (axis == 1) ? rows : cols;
        float fill = (op == 0) ? 0.0f
                               : std::numeric_limits<float>::quiet_NaN();
        for (int64_t i = 0; i < n; ++i) out[i] = fill;
        return;
    }
    if (axis == 1) {
#ifdef _OPENMP
#pragma omp parallel for if (rows * cols > 32768)
#endif
        for (int64_t r = 0; r < rows; ++r) {
            const float* xr = x + r * cols;
            double acc = 0.0;
            float best = xr[0];
            int64_t arg = 0;
            for (int64_t c = 0; c < cols; ++c) {
                float v = xr[c];
                acc += (op == 5) ? (double)v * v : (double)v;
                if ((op == 2 || op == 4) ? v > best : v < best) {
                    best = v;
                    arg = c;
                }
            }
            switch (op) {
                case 0: out[r] = (float)acc; break;
                case 1: out[r] = (float)(acc / (double)cols); break;
                case 2: case 3: out[r] = best; break;
                case 4: out[r] = (float)arg; break;
                case 5: out[r] = (float)std::sqrt(acc); break;
            }
        }
    } else {
        for (int64_t c = 0; c < cols; ++c) {
            double acc = 0.0;
            float best = x[c];
            int64_t arg = 0;
            for (int64_t r = 0; r < rows; ++r) {
                float v = x[r * cols + c];
                acc += (op == 5) ? (double)v * v : (double)v;
                if ((op == 2 || op == 4) ? v > best : v < best) {
                    best = v;
                    arg = r;
                }
            }
            switch (op) {
                case 0: out[c] = (float)acc; break;
                case 1: out[c] = (float)(acc / (double)rows); break;
                case 2: case 3: out[c] = best; break;
                case 4: out[c] = (float)arg; break;
                case 5: out[c] = (float)std::sqrt(acc); break;
            }
        }
    }
}

// ------------------------------------------------------------ im2col ----
// NCHW im2col (ConvolutionLayer.java:215 contract): input [C,H,W] →
// columns [C*kh*kw, oh*ow]. Host-side only (XLA convs never materialize
// this); exists for op-contract parity and CPU fallback testing.
void im2col_f32(const float* img, int64_t C, int64_t H, int64_t W,
                int64_t kh, int64_t kw, int64_t sh, int64_t sw,
                int64_t ph, int64_t pw, float* cols) {
    int64_t oh = (H + 2 * ph - kh) / sh + 1;
    int64_t ow = (W + 2 * pw - kw) / sw + 1;
#ifdef _OPENMP
#pragma omp parallel for collapse(2) if (C * kh * kw > 64)
#endif
    for (int64_t c = 0; c < C; ++c)
        for (int64_t ki = 0; ki < kh; ++ki)
            for (int64_t kj = 0; kj < kw; ++kj) {
                float* dst = cols + ((c * kh + ki) * kw + kj) * oh * ow;
                for (int64_t y = 0; y < oh; ++y) {
                    int64_t iy = y * sh + ki - ph;
                    for (int64_t x = 0; x < ow; ++x) {
                        int64_t ix = x * sw + kj - pw;
                        dst[y * ow + x] =
                            (iy >= 0 && iy < H && ix >= 0 && ix < W)
                                ? img[(c * H + iy) * W + ix]
                                : 0.0f;
                    }
                }
            }
}

void col2im_f32(const float* cols, int64_t C, int64_t H, int64_t W,
                int64_t kh, int64_t kw, int64_t sh, int64_t sw,
                int64_t ph, int64_t pw, float* img) {
    int64_t oh = (H + 2 * ph - kh) / sh + 1;
    int64_t ow = (W + 2 * pw - kw) / sw + 1;
    std::memset(img, 0, sizeof(float) * (size_t)(C * H * W));
    for (int64_t c = 0; c < C; ++c)
        for (int64_t ki = 0; ki < kh; ++ki)
            for (int64_t kj = 0; kj < kw; ++kj) {
                const float* src = cols + ((c * kh + ki) * kw + kj) * oh * ow;
                for (int64_t y = 0; y < oh; ++y) {
                    int64_t iy = y * sh + ki - ph;
                    if (iy < 0 || iy >= H) continue;
                    for (int64_t x = 0; x < ow; ++x) {
                        int64_t ix = x * sw + kj - pw;
                        if (ix >= 0 && ix < W)
                            img[(c * H + iy) * W + ix] += src[y * ow + x];
                    }
                }
            }
}

// ------------------------------------------------------------ random ----
void random_uniform_f32(uint64_t seed, int64_t n, float lo, float hi,
                        float* out) {
    uint64_t s = seed ? seed : 1;
    for (int64_t i = 0; i < n; ++i) out[i] = lo + (hi - lo) * u01(&s);
}

void random_gaussian_f32(uint64_t seed, int64_t n, float mean, float std,
                         float* out) {
    uint64_t s = seed ? seed : 1;
    for (int64_t i = 0; i < n; i += 2) {
        float u1 = std::max(u01(&s), 1e-12f), u2 = u01(&s);
        float r = std::sqrt(-2.0f * std::log(u1));
        out[i] = mean + std * r * std::cos(6.28318530718f * u2);
        if (i + 1 < n)
            out[i + 1] = mean + std * r * std::sin(6.28318530718f * u2);
    }
}

// ---------------------------------------------------- distance / ETL ----
// out[i,j] = ||X[i] - Q[j]||² — the host hot loop of VP-tree/KD-tree/
// k-means/KNN-server queries (reference keeps these host-side too,
// SURVEY §7 "host-side algorithms don't belong on TPU").
void pairwise_sqdist_f32(const float* X, int64_t n, const float* Q,
                         int64_t m, int64_t d, float* out) {
#ifdef _OPENMP
#pragma omp parallel for if (n * m * d > 1 << 16)
#endif
    for (int64_t i = 0; i < n; ++i) {
        const float* xi = X + i * d;
        for (int64_t j = 0; j < m; ++j) {
            const float* qj = Q + j * d;
            double acc = 0.0;
            for (int64_t k = 0; k < d; ++k) {
                float diff = xi[k] - qj[k];
                acc += (double)diff * diff;
            }
            out[i * m + j] = (float)acc;
        }
    }
}

// u8 → f32 scale+shift: the byte-image ETL inner loop of the dataset
// fetchers (MnistDataFetcher-style normalization) without a Python pass.
void scale_u8_f32(const uint8_t* src, int64_t n, float scale, float shift,
                  float* out) {
#ifdef _OPENMP
#pragma omp parallel for if (n > 1 << 16)
#endif
    for (int64_t i = 0; i < n; ++i) out[i] = (float)src[i] * scale + shift;
}

}  // extern "C"
