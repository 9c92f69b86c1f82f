// Native batch tokenizer / corpus encoder.
//
// The reference's text pipeline tokenizes on the JVM
// (text/tokenization/tokenizerfactory/DefaultTokenizerFactory.java with
// CommonPreprocessor — whitespace split, strip [digits .:,"'()[]|/?!;],
// lowercase). Word2Vec/TF-IDF re-tokenize the whole corpus every epoch,
// which makes tokenization a real host-side hot path; this is the C++
// analog, OpenMP-parallel over documents.
//
// Semantics mirror the Python DefaultTokenizerFactory(CommonPreprocessor)
// for ASCII text (lowercasing here is byte-level; callers fall back to
// the Python path for non-ASCII input — text/native_tokenizer.py guards).
//
// Exposed via ctypes (no pybind11 in the image):
//   dl4j_vocab_create / dl4j_vocab_free        word -> id hash
//   dl4j_tokenize_encode                       corpus -> per-doc id arrays
//   dl4j_count_tokens / dl4j_counts_*          corpus -> (word, count) set
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline bool is_space(unsigned char c) {
    // Python str.split() whitespace, ASCII part: space, \t, \r, \f, \v
    // plus the FS/GS/RS/US separators 0x1c-0x1f ('\n' is the doc
    // delimiter, handled by split_lines)
    return c == ' ' || c == '\t' || c == '\r' || c == '\f' || c == '\v' ||
           (c >= 0x1c && c <= 0x1f);
}

inline bool is_stripped(unsigned char c) {
    // CommonPreprocessor regex class: [\d.:,"'()\[\]|/?!;]
    switch (c) {
        case '.': case ':': case ',': case '"': case '\'':
        case '(': case ')': case '[': case ']': case '|':
        case '/': case '?': case '!': case ';':
            return true;
        default:
            return c >= '0' && c <= '9';
    }
}

inline char low(unsigned char c) {
    return (c >= 'A' && c <= 'Z') ? char(c - 'A' + 'a') : char(c);
}

// preprocess one whitespace-delimited raw token into `out`; returns false
// if the token is empty after stripping
bool preprocess(const char* s, int64_t len, bool common, std::string& out) {
    out.clear();
    for (int64_t i = 0; i < len; ++i) {
        unsigned char c = (unsigned char)s[i];
        if (common) {
            if (is_stripped(c)) continue;
            out.push_back(low(c));
        } else {
            out.push_back((char)c);
        }
    }
    return !out.empty();
}

// tokenize one line into preprocessed tokens
template <typename F>
void for_tokens(const char* s, int64_t len, bool common, F&& f) {
    std::string buf;
    int64_t i = 0;
    while (i < len) {
        while (i < len && is_space((unsigned char)s[i])) ++i;
        int64_t start = i;
        while (i < len && !is_space((unsigned char)s[i])) ++i;
        if (i > start && preprocess(s + start, i - start, common, buf))
            f(buf);
    }
}

struct Vocab {
    std::unordered_map<std::string, int32_t> map;
};

struct Counts {
    std::unordered_map<std::string, int64_t> map;
    // export staging (filled by dl4j_counts_export_prepare)
    std::string blob;
    std::vector<int64_t> offsets;   // n+1 entries into blob
    std::vector<int64_t> counts;
};

std::vector<std::pair<int64_t, int64_t>> split_lines(const char* text,
                                                     int64_t len) {
    std::vector<std::pair<int64_t, int64_t>> lines;
    int64_t start = 0;
    for (int64_t i = 0; i < len; ++i) {
        if (text[i] == '\n') {
            lines.emplace_back(start, i);
            start = i + 1;
        }
    }
    if (start < len) lines.emplace_back(start, len);
    return lines;
}

}  // namespace

extern "C" {

void* dl4j_vocab_create(const char* blob, const int64_t* offsets,
                        int64_t n_words) {
    auto* v = new Vocab();
    v->map.reserve((size_t)n_words * 2);
    for (int64_t i = 0; i < n_words; ++i) {
        v->map.emplace(std::string(blob + offsets[i],
                                   (size_t)(offsets[i + 1] - offsets[i])),
                       (int32_t)i);
    }
    return v;
}

void dl4j_vocab_free(void* h) { delete (Vocab*)h; }

// Encode a '\n'-separated corpus. Writes token ids to out_ids (OOV tokens
// are skipped unless keep_oov, then written as -1), per-doc END offsets
// into doc_ends. Returns total ids written, or -(needed) if max_out was
// too small (call again with a bigger buffer), or INT64_MIN when
// max_docs is too small (distinct from the resize protocol — a resize
// loop must not spin on it).
int64_t dl4j_tokenize_encode(void* vocab_h, const char* text, int64_t len,
                             int common, int keep_oov,
                             int32_t* out_ids, int64_t max_out,
                             int64_t* doc_ends, int64_t max_docs,
                             int64_t* n_docs_out) {
    auto* vocab = (Vocab*)vocab_h;
    auto lines = split_lines(text, len);
    int64_t n_docs = (int64_t)lines.size();
    if (n_docs > max_docs) return INT64_MIN;
    std::vector<std::vector<int32_t>> per_doc((size_t)n_docs);

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
    for (int64_t d = 0; d < n_docs; ++d) {
        auto& ids = per_doc[(size_t)d];
        for_tokens(text + lines[(size_t)d].first,
                   lines[(size_t)d].second - lines[(size_t)d].first,
                   common != 0, [&](const std::string& tok) {
                       auto it = vocab->map.find(tok);
                       if (it != vocab->map.end())
                           ids.push_back(it->second);
                       else if (keep_oov)
                           ids.push_back(-1);
                   });
    }

    int64_t total = 0;
    for (auto& ids : per_doc) total += (int64_t)ids.size();
    if (total > max_out) return -total;
    int64_t pos = 0;
    for (int64_t d = 0; d < n_docs; ++d) {
        auto& ids = per_doc[(size_t)d];
        if (!ids.empty())
            std::memcpy(out_ids + pos, ids.data(),
                        ids.size() * sizeof(int32_t));
        pos += (int64_t)ids.size();
        doc_ends[d] = pos;
    }
    *n_docs_out = n_docs;
    return total;
}

// Count unique preprocessed tokens across the corpus (vocab building).
void* dl4j_count_tokens(const char* text, int64_t len, int common) {
    auto lines = split_lines(text, len);
    int64_t n_docs = (int64_t)lines.size();
#ifdef _OPENMP
    int n_threads = omp_get_max_threads();
#else
    int n_threads = 1;
#endif
    std::vector<std::unordered_map<std::string, int64_t>> partial(
        (size_t)n_threads);

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
    for (int64_t d = 0; d < n_docs; ++d) {
#ifdef _OPENMP
        auto& local = partial[(size_t)omp_get_thread_num()];
#else
        auto& local = partial[0];
#endif
        for_tokens(text + lines[(size_t)d].first,
                   lines[(size_t)d].second - lines[(size_t)d].first,
                   common != 0,
                   [&](const std::string& tok) { ++local[tok]; });
    }

    auto* c = new Counts();
    for (auto& p : partial)
        for (auto& kv : p) c->map[kv.first] += kv.second;

    c->offsets.reserve(c->map.size() + 1);
    c->counts.reserve(c->map.size());
    c->offsets.push_back(0);
    for (auto& kv : c->map) {
        c->blob += kv.first;
        c->offsets.push_back((int64_t)c->blob.size());
        c->counts.push_back(kv.second);
    }
    return c;
}

int64_t dl4j_counts_size(void* h) { return (int64_t)((Counts*)h)->counts.size(); }
int64_t dl4j_counts_blob_len(void* h) { return (int64_t)((Counts*)h)->blob.size(); }

void dl4j_counts_export(void* h, char* blob, int64_t* offsets,
                        int64_t* counts) {
    auto* c = (Counts*)h;
    std::memcpy(blob, c->blob.data(), c->blob.size());
    std::memcpy(offsets, c->offsets.data(),
                c->offsets.size() * sizeof(int64_t));
    std::memcpy(counts, c->counts.data(),
                c->counts.size() * sizeof(int64_t));
}

void dl4j_counts_free(void* h) { delete (Counts*)h; }

}  // extern "C"
