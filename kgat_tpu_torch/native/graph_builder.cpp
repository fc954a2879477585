// Host-side text parsing and graph indexing for kgat_tpu_torch.
//
// The port's own copy of the parse and index functions of
// kgat_tpu/native/graph_builder.cpp, with the same semantics:
//
//   * kgat_count_pairs / kgat_parse_pairs: "uid iid iid ..." lines ->
//     (uid, iid) pairs; a line without items gives none;
//   * kgat_count_triples / kgat_parse_triples: a stream of whitespace-
//     separated integer tokens -> (h, r, t) triples, three tokens at a
//     time, whatever the line breaks;
//   * kgat_sort_perm: the stable counting sort of edge ids by key;
//   * kgat_csr_offsets: CSR offsets over sorted keys.
//
// kgat_tpu's TPU layout fill (its kgat_aligned_fill) has no counterpart:
// the port's graph holds plain CSR rows.
//
// A plain C interface, bound with ctypes (kgat_tpu_torch/native/__init__.py).
// Every buffer is allocated by the caller.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

extern "C" {

// The whole file, with a '\0' after its last byte; false on an IO error.
static bool read_file(const char* path, std::vector<char>& buf) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (size < 0) {
        std::fclose(f);
        return false;
    }
    buf.resize(static_cast<size_t>(size) + 1);
    size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
    std::fclose(f);
    if (got != static_cast<size_t>(size)) return false;
    buf[got] = '\0';
    return true;
}

static inline bool blank(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// One pass over "uid iid iid ..." lines. With out_u null it only counts.
// Returns the pairs seen, -1 on an IO error, -2 past cap.
static int64_t pairs_pass(const char* path, int64_t* out_u, int64_t* out_i,
                          int64_t cap) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    const char* p = buf.data();
    const char* end = p + buf.size() - 1;
    int64_t n = 0;
    while (p < end) {
        while (p < end && blank(*p)) ++p;
        if (p >= end) break;
        if (*p == '\n') {
            ++p;
            continue;
        }
        char* next = nullptr;
        long long uid = std::strtoll(p, &next, 10);
        if (next == p) {  // not a number: skip the line
            while (p < end && *p != '\n') ++p;
            continue;
        }
        p = next;
        while (p < end && *p != '\n') {
            while (p < end && blank(*p)) ++p;
            if (p >= end || *p == '\n') break;
            long long item = std::strtoll(p, &next, 10);
            if (next == p) break;  // the rest of the line is skipped above
            p = next;
            if (out_u) {
                if (n >= cap) return -2;
                out_u[n] = uid;
                out_i[n] = item;
            }
            ++n;
        }
    }
    return n;
}

int64_t kgat_count_pairs(const char* path) {
    return pairs_pass(path, nullptr, nullptr, 0);
}

int64_t kgat_parse_pairs(const char* path, int64_t* out_u, int64_t* out_i,
                         int64_t cap) {
    return pairs_pass(path, out_u, out_i, cap);
}

// Triples from the token stream: up to three integer tokens are read
// across any whitespace, newlines included. A token that is not a number
// drops the triple begun so far, and the scan goes on one byte after it.
// Returns the triples written, -1 on an IO error, -2 past cap3.
int64_t kgat_parse_triples(const char* path, int64_t* out, int64_t cap3) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    const char* p = buf.data();
    const char* end = p + buf.size() - 1;
    int64_t n = 0;
    while (p < end) {
        char* next = nullptr;
        long long v[3];
        int got = 0;
        for (; got < 3; ++got) {
            while (p < end && (blank(*p) || *p == '\n')) ++p;
            if (p >= end) break;
            v[got] = std::strtoll(p, &next, 10);
            if (next == p) {
                ++p;
                break;
            }
            p = next;
        }
        if (got == 3) {
            if (out) {
                if (n >= cap3) return -2;
                out[n * 3 + 0] = v[0];
                out[n * 3 + 1] = v[1];
                out[n * 3 + 2] = v[2];
            }
            ++n;
        }
    }
    return n;
}

// An upper bound on the triples: whitespace-separated tokens / 3.
int64_t kgat_count_triples(const char* path) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    int64_t tokens = 0;
    bool in_token = false;
    for (char c : buf) {
        bool ws = blank(c) || c == '\n' || c == '\0';
        if (!ws && !in_token) ++tokens;
        in_token = !ws;
    }
    return tokens / 3;
}

// Stable counting sort: perm lists the ids 0..n-1 ordered by keys[id],
// ids of one key in increasing order. Every key lies in [0, n_keys).
void kgat_sort_perm(const int32_t* keys, int64_t n, int32_t n_keys,
                    int64_t* perm) {
    std::vector<int64_t> start(static_cast<size_t>(n_keys) + 1, 0);
    for (int64_t e = 0; e < n; ++e) start[keys[e] + 1]++;
    for (int32_t k = 0; k < n_keys; ++k) start[k + 1] += start[k];
    for (int64_t e = 0; e < n; ++e) perm[start[keys[e]]++] = e;
}

// offsets[k], k in [0, n_segments], is the first index whose key is >= k
// (n where there is none): numpy's searchsorted(sorted_keys, k, "left").
void kgat_csr_offsets(const int32_t* sorted_keys, int64_t n,
                      int32_t n_segments, int64_t* offsets) {
    int64_t pos = 0;
    for (int32_t k = 0; k <= n_segments; ++k) {
        while (pos < n && sorted_keys[pos] < k) ++pos;
        offsets[k] = pos;
    }
}

}  // extern "C"
