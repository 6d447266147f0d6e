// Fast LETOR svmlight/tsv parser.
//
// TPU-native replacement for the dependency-native layer the reference
// leans on for data IO (SURVEY §2.1: the reference has no first-party
// native code; h5py/HDF5 and torch DataLoader workers carry the IO).
// Parsing MSLR-Web10K (723k rows x 136 features) in Python costs tens of
// seconds per epoch of preprocessing; this parser does one pass with no
// allocation per token and feeds the numpy buffer directly.
//
// Exposed C ABI (ctypes):
//   parse_svmlight(path, num_features, out_rows) -> float* (caller frees
//     via free_buffer); layout [label, qid, f0..fN-1] per row, row-major.
//   parse_tsv(path, out_rows, out_cols) -> float*
//   free_buffer(ptr)

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Hand-rolled decimal float parser (sign, digits, '.', digits, e±exp) —
// ~10x strtod, which dominates parse time at LETOR scale. Falls back to
// strtod for anything unusual (inf/nan/hex).
inline double parse_num(const char* p, char** end) {
    const char* s = p;
    bool neg = false;
    if (*s == '-') { neg = true; ++s; }
    else if (*s == '+') { ++s; }
    if (*s < '0' || *s > '9') {
        if (*s != '.') return strtod(p, end);  // inf/nan/garbage
    }
    double mant = 0.0;
    while (*s >= '0' && *s <= '9') mant = mant * 10.0 + (*s++ - '0');
    int frac = 0;
    if (*s == '.') {
        ++s;
        while (*s >= '0' && *s <= '9') {
            mant = mant * 10.0 + (*s++ - '0');
            ++frac;
        }
    }
    int exp = 0;
    if (*s == 'e' || *s == 'E') {
        const char* mark = s;
        ++s;
        bool eneg = false;
        if (*s == '-') { eneg = true; ++s; }
        else if (*s == '+') { ++s; }
        if (*s < '0' || *s > '9') { s = mark; }  // bare 'e': not an exponent
        else {
            int e = 0;
            while (*s >= '0' && *s <= '9') e = e * 10 + (*s++ - '0');
            exp = eneg ? -e : e;
        }
    }
    static const double pow10[] = {
        1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11,
        1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
    int net = exp - frac;
    double v = mant;
    if (net > 22 || net < -22) return strtod(p, end);  // precision path
    if (net >= 0) v *= pow10[net];
    else v /= pow10[-net];
    *end = const_cast<char*>(s);
    return neg ? -v : v;
}

// A number must start here — without this guard the strtod fallback in
// parse_num skips whitespace INCLUDING newlines and would silently
// consume the next line's label as this token's value.
inline bool is_num_start(char c) {
    return (c >= '0' && c <= '9') || c == '-' || c == '+' || c == '.';
}

struct FileBuf {
    char* data = nullptr;
    size_t size = 0;
    bool ok = false;

    explicit FileBuf(const char* path) {
        FILE* f = fopen(path, "rb");
        if (!f) return;
        fseek(f, 0, SEEK_END);
        long n = ftell(f);
        fseek(f, 0, SEEK_SET);
        if (n < 0) { fclose(f); return; }
        data = static_cast<char*>(malloc(static_cast<size_t>(n) + 1));
        if (!data) { fclose(f); return; }
        size = fread(data, 1, static_cast<size_t>(n), f);
        data[size] = '\0';
        fclose(f);
        ok = true;
    }
    ~FileBuf() { free(data); }
};

}  // namespace

extern "C" {

// Returns malloc'd buffer of (*out_rows) * (2 + num_features) floats,
// or nullptr on error. Rows keep file order (caller sorts by qid).
float* parse_svmlight(const char* path, int num_features,
                      long* out_rows) {
    *out_rows = 0;
    FileBuf fb(path);
    if (!fb.ok) return nullptr;

    const int stride = 2 + num_features;
    std::vector<float> rows;
    rows.reserve(1 << 20);

    const char* p = fb.data;
    const char* end = fb.data + fb.size;
    while (p < end) {
        // skip blank lines
        while (p < end && (*p == '\n' || *p == '\r')) ++p;
        if (p >= end) break;
        if (*p == '#') {  // full-line comment (sklearn dump headers)
            while (p < end && *p != '\n') ++p;
            continue;
        }
        // a non-blank DATA line that fails to parse FAILS the whole
        // parse: the numpy fallback raises on the same input, and
        // silently dropping rows would shrink the training set
        char* q;
        if (!is_num_start(*p)) { *out_rows = 0; return nullptr; }
        double label = parse_num(p, &q);
        if (q == p) { *out_rows = 0; return nullptr; }
        p = q;
        // expect " qid:N"
        while (p < end && *p == ' ') ++p;
        if (strncmp(p, "qid:", 4) != 0) { *out_rows = 0; return nullptr; }
        p += 4;
        if (p >= end || !is_num_start(*p)) { *out_rows = 0; return nullptr; }
        double qid = parse_num(p, &q);
        p = q;

        size_t base = rows.size();
        rows.resize(base + stride, 0.0f);
        rows[base] = static_cast<float>(label);
        rows[base + 1] = static_cast<float>(qid);

        // feature pairs until newline or '#' comment ('\r' is line-end
        // whitespace: CRLF files must parse natively, not fail over)
        while (p < end && *p != '\n') {
            while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
            if (p >= end || *p == '\n') break;
            if (*p == '#') {  // trailing comment
                while (p < end && *p != '\n') ++p;
                break;
            }
            double idx = parse_num(p, &q);
            if (q == p || *q != ':') { *out_rows = 0; return nullptr; }
            p = q + 1;  // skip ':'
            // malformed value ('idx:' at end of line) or an
            // out-of-range index: FAIL the parse — the numpy fallback
            // raises loudly on the same input, and silently dropping
            // data here would corrupt training without a trace
            if (p >= end || !is_num_start(*p)) { *out_rows = 0; return nullptr; }
            double val = parse_num(p, &q);
            if (q == p) { *out_rows = 0; return nullptr; }
            p = q;
            int fi = static_cast<int>(idx) - 1;  // svmlight is 1-based
            if (fi < 0 || fi >= num_features) { *out_rows = 0; return nullptr; }
            rows[base + 2 + fi] = static_cast<float>(val);
        }
        ++*out_rows;
    }

    float* out = static_cast<float*>(
        malloc(rows.size() * sizeof(float)));
    if (!out) { *out_rows = 0; return nullptr; }
    memcpy(out, rows.data(), rows.size() * sizeof(float));
    return out;
}

// Dense tsv of floats -> row-major buffer; infers column count from the
// first line.
float* parse_tsv(const char* path, long* out_rows, long* out_cols) {
    *out_rows = 0;
    *out_cols = 0;
    FileBuf fb(path);
    if (!fb.ok) return nullptr;

    std::vector<float> rows;
    rows.reserve(1 << 20);
    const char* p = fb.data;
    const char* end = fb.data + fb.size;
    long cols = 0;
    while (p < end) {
        while (p < end && (*p == '\n' || *p == '\r')) ++p;
        if (p >= end) break;
        long c = 0;
        while (p < end && *p != '\n') {
            char* q;
            double v = parse_num(p, &q);
            if (q == p) { ++p; continue; }
            p = q;
            rows.push_back(static_cast<float>(v));
            ++c;
            while (p < end && (*p == '\t' || *p == ' ' || *p == '\r')) ++p;
        }
        if (c == 0) continue;
        if (cols == 0) cols = c;
        if (c != cols) { return nullptr; }  // ragged
        ++*out_rows;
    }
    *out_cols = cols;
    float* out = static_cast<float*>(malloc(rows.size() * sizeof(float)));
    if (!out) { *out_rows = 0; return nullptr; }
    memcpy(out, rows.data(), rows.size() * sizeof(float));
    return out;
}

void free_buffer(float* ptr) { free(ptr); }

}  // extern "C"
