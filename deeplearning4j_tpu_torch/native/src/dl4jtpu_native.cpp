// dl4jtpu_native — host-side native kernels.
//
// The reference keeps its host hot loops in native code (SURVEY.md §2.1):
// ND4J's C++ threshold/bitmap compression ops (consumed via
// Nd4j.getExecutioner().thresholdEncode, EncodingHandler.java:136-178) and
// the HogWild AggregateSkipGram/CBOW aggregates behind
// SkipGram.iterateSample (SkipGram.java:224-272). This module is their
// TPU-framework equivalent: the DCN-path gradient codec and the lock-free
// multithreaded skip-gram trainer run here; TPU compute stays in XLA.
//
// Built on demand with g++ -O3 (-fopenmp when available) — see
// deeplearning4j_tpu/native/__init__.py; every entry point is plain C ABI
// for ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// --------------------------------------------------------------- codec ----
// Sparse exact-magnitude threshold encoding (the host twin of
// encoding.threshold_encode_values): selects the top-`cap` elements with
// |g| >= threshold, writes (idx, val) pairs sorted by index, and the
// residual g - decoded. Returns the number of sent elements.
int64_t threshold_encode_f32(const float* grad, int64_t n, float threshold,
                             int64_t cap, int32_t* idx_out, float* val_out,
                             float* residual_out) {
    std::vector<int64_t> over;
    over.reserve(1024);
    for (int64_t i = 0; i < n; ++i) {
        if (std::fabs(grad[i]) >= threshold) over.push_back(i);
    }
    if ((int64_t)over.size() > cap) {
        std::nth_element(over.begin(), over.begin() + cap, over.end(),
                         [&](int64_t a, int64_t b) {
                             return std::fabs(grad[a]) > std::fabs(grad[b]);
                         });
        over.resize(cap);
    }
    std::sort(over.begin(), over.end());
    std::memcpy(residual_out, grad, sizeof(float) * (size_t)n);
    int64_t m = (int64_t)over.size();
    for (int64_t j = 0; j < m; ++j) {
        int64_t i = over[j];
        idx_out[j] = (int32_t)i;
        val_out[j] = grad[i];
        residual_out[i] = 0.0f;
    }
    return m;
}

// dense += scatter(idx, vals)
void decode_accumulate_f32(float* dense, int64_t n, const int32_t* idx,
                           const float* vals, int64_t m) {
    for (int64_t j = 0; j < m; ++j) {
        int32_t i = idx[j];
        if (i >= 0 && i < n) dense[i] += vals[j];
    }
}

// ------------------------------------------------------------- word2vec ----
// HogWild skip-gram + negative sampling over a flat id corpus.
// corpus: concatenated sentence ids; offsets[s]..offsets[s+1] delimit
// sentence s (n_sents+1 offsets). table: negative-sampling table of word
// ids (classic word2vec unigram^0.75 expansion). Threads race on
// syn0/syn1neg without locks — the HogWild contract the reference's
// AggregateSkipGram relies on too. Linear lr decay by processed-word
// count. Returns mean pair loss.
static inline uint64_t next_rand(uint64_t* s) {
    *s = *s * 6364136223846793005ULL + 1442695040888963407ULL;
    return *s;
}

static inline float fast_sigmoid(float x) {
    if (x > 8.0f) return 1.0f;
    if (x < -8.0f) return 0.0f;
    return 1.0f / (1.0f + std::exp(-x));
}

double sg_ns_train(float* syn0, float* syn1neg, int64_t vocab, int64_t dim,
                   const int32_t* corpus, const int64_t* offsets,
                   int64_t n_sents, int32_t window, int32_t negative,
                   const int32_t* table, int64_t table_size,
                   float lr_start, float lr_min, int64_t total_words,
                   uint64_t seed, int32_t n_threads) {
    std::atomic<int64_t> word_counter(0);
    double loss_sum = 0.0;
    int64_t pair_count = 0;
#ifdef _OPENMP
    if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel reduction(+ : loss_sum, pair_count)
#endif
    {
#ifdef _OPENMP
        int tid = omp_get_thread_num();
        int nth = omp_get_num_threads();
#else
        int tid = 0, nth = 1;
        (void)n_threads;
#endif
        uint64_t rng = seed + 0x9E3779B97F4A7C15ULL * (uint64_t)(tid + 1);
        std::vector<float> neu1e((size_t)dim);
        for (int64_t s = tid; s < n_sents; s += nth) {
            int64_t beg = offsets[s], end = offsets[s + 1];
            for (int64_t pos = beg; pos < end; ++pos) {
                int64_t seen = word_counter.fetch_add(1);
                float frac = total_words > 0
                                 ? (float)seen / (float)total_words
                                 : 0.0f;
                float lr = lr_start * (1.0f - frac);
                if (lr < lr_min) lr = lr_min;
                int32_t center = corpus[pos];
                int32_t b = (int32_t)(next_rand(&rng) % (uint64_t)window);
                for (int64_t j = pos - window + b; j <= pos + window - b;
                     ++j) {
                    if (j == pos || j < beg || j >= end) continue;
                    int32_t ctx = corpus[j];
                    float* v_in = syn0 + (int64_t)ctx * dim;
                    std::fill(neu1e.begin(), neu1e.end(), 0.0f);
                    for (int32_t k = 0; k <= negative; ++k) {
                        int32_t target;
                        float label;
                        if (k == 0) {
                            target = center;
                            label = 1.0f;
                        } else {
                            target = table[next_rand(&rng) %
                                           (uint64_t)table_size];
                            if (target == center) continue;
                            label = 0.0f;
                        }
                        float* v_out = syn1neg + (int64_t)target * dim;
                        float f = 0.0f;
                        for (int64_t d = 0; d < dim; ++d)
                            f += v_in[d] * v_out[d];
                        float p = fast_sigmoid(f);
                        float g = (label - p) * lr;
                        loss_sum += label > 0.5f
                                        ? -std::log(std::max(p, 1e-7f))
                                        : -std::log(std::max(1.0f - p,
                                                             1e-7f));
                        for (int64_t d = 0; d < dim; ++d) {
                            neu1e[(size_t)d] += g * v_out[d];
                            v_out[d] += g * v_in[d];
                        }
                    }
                    for (int64_t d = 0; d < dim; ++d)
                        v_in[d] += neu1e[(size_t)d];
                    ++pair_count;
                }
            }
        }
    }
    return pair_count > 0
               ? loss_sum / (double)(pair_count * (negative + 1))
               : 0.0;
}

int32_t native_abi_version() { return 1; }

}  // extern "C"
