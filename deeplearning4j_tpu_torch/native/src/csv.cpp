// Fast numeric CSV parsing for the DataVec record-reader bridge.
//
// Parity role: the reference's data loading leans on native code (DataVec
// readers over libnd4j buffers); here the hot path of
// data/records.py:CSVRecordReader — all-numeric CSV -> float32 matrix —
// is one strict C++ pass. STRICT means: every field must parse fully as
// a number and every row must have the same arity; anything else returns
// an error code and the caller falls back to the Python csv module
// (which handles quoting, mixed types, etc.). No silent zeros.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <locale.h>

namespace {
// strtof is LC_NUMERIC-dependent; parse under an explicit "C" locale so
// accept/reject behavior matches python float() regardless of process
// locale settings
locale_t c_locale() {
    static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
    return loc;
}
}   // namespace

extern "C" {

// Pass 1 (out == nullptr): validate + count; writes column count to
// *n_cols_io and returns the row count.
// Pass 2 (out != nullptr): fill out[rows * cols] row-major.
// Returns >= 0 rows on success; -1 non-numeric field; -2 ragged row;
// -3 overflow of max_rows (pass 2 only).
int64_t csv_parse_f32(const char* buf, int64_t n, char delim,
                      int64_t skip_lines, float* out, int64_t max_rows,
                      int64_t* n_cols_io) {
    int64_t pos = 0;
    for (int64_t s = 0; s < skip_lines && pos < n; ++s) {
        while (pos < n && buf[pos] != '\n') ++pos;
        if (pos < n) ++pos;
    }
    int64_t rows = 0;
    int64_t cols = (out != nullptr && n_cols_io) ? *n_cols_io : -1;
    if (out == nullptr) {
        // counting pass: newline scan + first-line arity only; full
        // numeric + arity validation happens in the fill pass
        int64_t p = pos;
        while (p < n) {
            if (buf[p] == '\n' || buf[p] == '\r') {
                ++p;
                continue;
            }
            const char* nl = (const char*)std::memchr(buf + p, '\n', n - p);
            int64_t line_end = nl ? (nl - buf) : n;
            if (cols < 0) {
                cols = 1;
                for (int64_t i = p; i < line_end; ++i)
                    if (buf[i] == delim) ++cols;
            }
            ++rows;
            p = line_end + 1;
        }
        if (n_cols_io) *n_cols_io = cols < 0 ? 0 : cols;
        return rows;
    }
    while (pos < n) {
        // skip blank lines (incl. a trailing newline at EOF)
        if (buf[pos] == '\n' || buf[pos] == '\r') {
            ++pos;
            continue;
        }
        int64_t line_end = pos;
        while (line_end < n && buf[line_end] != '\n') ++line_end;
        int64_t end = line_end;
        if (end > pos && buf[end - 1] == '\r') --end;

        // in-place strtof: the caller's buffer is NUL-terminated (CPython
        // bytes) and strtof stops at the delimiter/newline on its own
        int64_t c = 0;
        int64_t field_start = pos;
        for (int64_t i = pos; i <= end; ++i) {
            if (i == end || buf[i] == delim) {
                const char* fs = buf + field_start;
                const char* fe = buf + i;
                while (fs < fe && std::isspace((unsigned char)*fs)) ++fs;
                if (fs == fe) return -1;        // empty field: not numeric
                // strtof accepts hex floats ("0x10") and nan payloads
                // ("nan(abc)") that python float() rejects — refuse both
                // so the parsers agree
                for (const char* q = fs; q < fe; ++q)
                    if (*q == 'x' || *q == 'X' || *q == '(') return -1;
                char* parse_end = nullptr;
                float v = strtof_l(fs, &parse_end, c_locale());
                if (parse_end == fs) return -1;
                while (parse_end < fe &&
                       std::isspace((unsigned char)*parse_end))
                    ++parse_end;
                if (parse_end != fe) return -1; // partial parse
                if (!std::isfinite(v)) {
                    // only accept non-finite when the text says so
                    // (python float() parses "inf"/"nan" too); a finite
                    // literal overflowing f32 (1e39) must fall back
                    const char* t = fs;
                    if (*t == '+' || *t == '-') ++t;
                    char c0 = (char)std::tolower((unsigned char)*t);
                    if (c0 != 'i' && c0 != 'n') return -1;
                }
                if (out != nullptr) {
                    if (rows >= max_rows) return -3;
                    if (c >= cols) return -2;
                    out[rows * cols + c] = v;
                }
                ++c;
                field_start = i + 1;
            }
        }
        if (cols < 0)
            cols = c;
        else if (c != cols)
            return -2;                           // ragged row
        ++rows;
        pos = line_end + 1;
    }
    if (n_cols_io) *n_cols_io = cols < 0 ? 0 : cols;
    return rows;
}

}   // extern "C"
