// Hash factorization of int64 keys: codes by FIRST APPEARANCE, distinct
// keys returned in appearance order — the host string tier's hottest
// primitive (flink_ml_tpu/models/feature/text.py _token_codes views the
// '<U' token buffer as integers and factorizes; the pandas hash engine
// measured ~1.9 s per 1e8 keys on this host, the dominant cost of the
// CountVectorizer/StringIndexer fits at the 1e9-token benchmark scale).
//
// Open-addressing table with linear probing; slots store the code, keys
// are re-read from the caller's uniq buffer (one array serves as both
// output and table keys — no separate key store, and growth rehashes
// from it).
//
// Threading (FLINK_ML_TPU_NATIVE_THREADS via the n_threads argument):
// each worker factorizes a contiguous key chunk against its own local
// table, then ONE sequential pass merges the local alphabets in chunk
// order — the global code of a key is its first-appearance rank across
// the concatenated chunks, which IS the sequential first-appearance
// rank, so the threaded output is byte-identical to n_threads=1 — and a
// final parallel pass remaps each chunk's local codes through its
// local→global map. n_threads <= 1 runs the original sequential loop
// (the default: callers already shard rows via the forked host pool,
// and threads×workers must not oversubscribe the cores).

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

static inline uint64_t mix64(uint64_t z) {
    z += 0x9E3779B97F4A7C15ull;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}

// Open-addressing code table backed by the caller's appearance-order
// `uniq` key store — ONE probe/insert/grow implementation shared by the
// per-chunk factorize and the sequential merge, so the threaded
// byte-identity guarantee cannot drift between two copies of the
// probing/load-factor semantics.
struct CodeTable {
    std::vector<int64_t> slots;
    uint64_t mask;
    int64_t nu = 0;
    int64_t* uniq;
    int64_t uniq_cap;

    CodeTable(int64_t* uniq_, int64_t uniq_cap_)
        : slots(2048, -1), mask(2047), uniq(uniq_), uniq_cap(uniq_cap_) {}

    // code of k (first-appearance rank), inserting when new; -2 on
    // uniq_cap overflow (codes are >= 0, -1 is the empty-slot marker)
    int64_t lookup_or_insert(int64_t k) {
        uint64_t h = mix64((uint64_t)k) & mask;
        for (;;) {
            const int64_t s = slots[h];
            if (s < 0) break;
            if (uniq[s] == k) return s;
            h = (h + 1) & mask;
        }
        if (nu >= uniq_cap) return -2;
        const int64_t code = nu;
        uniq[nu++] = k;
        slots[h] = code;
        if ((uint64_t)nu * 2 > mask) {  // load 0.5: grow + rehash
            const uint64_t cap = (mask + 1) << 1;
            mask = cap - 1;
            std::vector<int64_t> grown(cap, -1);
            for (int64_t c = 0; c < nu; ++c) {
                uint64_t hh = mix64((uint64_t)uniq[c]) & mask;
                while (grown[hh] >= 0) hh = (hh + 1) & mask;
                grown[hh] = c;
            }
            slots.swap(grown);
        }
        return code;
    }
};

// Factorize keys[start, end) against the open-addressing table backed by
// `uniq` (appearance-order key store, capacity uniq_cap). Local codes are
// written into codes[start, end). Returns the distinct count or -1 on
// uniq_cap overflow.
static int64_t factorize_range(const int64_t* keys, int64_t start,
                               int64_t end, int64_t* codes, int64_t* uniq,
                               int64_t uniq_cap) {
    CodeTable table(uniq, uniq_cap);
    for (int64_t i = start; i < end; ++i) {
        const int64_t code = table.lookup_or_insert(keys[i]);
        if (code < 0) return -1;
        codes[i] = code;
    }
    return table.nu;
}

// Clamp the requested worker count so every worker owns a chunk worth
// spinning a thread for (below ~64k keys per worker the spawn + merge
// overheads beat the scan).
static int64_t clamp_threads(int64_t n_threads, int64_t n_items,
                             int64_t min_per_thread) {
    if (n_threads < 1) n_threads = 1;
    const int64_t by_work = n_items / (min_per_thread > 0
                                       ? min_per_thread : 1);
    if (n_threads > by_work) n_threads = by_work;
    return n_threads < 1 ? 1 : n_threads;
}

// keys[n] -> codes[n] (first-appearance labels), uniq[<=uniq_cap] (keys in
// appearance order). Returns the distinct count, or -1 when uniq_cap would
// be exceeded (caller falls back to its Python engine). n_threads > 1
// runs the deterministic chunked merge above — output byte-identical to
// the sequential pass.
extern "C" int64_t factorize_i64(const int64_t* keys, int64_t n,
                                 int64_t* codes, int64_t* uniq,
                                 int64_t uniq_cap, int64_t n_threads) {
    const int64_t t = clamp_threads(n_threads, n, 1 << 16);
    if (t <= 1)
        return factorize_range(keys, 0, n, codes, uniq, uniq_cap);

    const int64_t chunk = (n + t - 1) / t;
    std::vector<std::vector<int64_t>> local_uniq((size_t)t);
    std::vector<int64_t> local_nu((size_t)t, 0);
    {
        std::vector<std::thread> workers;
        for (int64_t c = 0; c < t; ++c) {
            workers.emplace_back([&, c]() {
                const int64_t lo = c * chunk;
                const int64_t hi = std::min(n, lo + chunk);
                // local cap: a chunk holds at most hi-lo distinct keys;
                // the global uniq_cap check happens at merge time
                local_uniq[(size_t)c].resize((size_t)(hi - lo));
                local_nu[(size_t)c] = factorize_range(
                    keys, lo, hi, codes, local_uniq[(size_t)c].data(),
                    hi - lo);
            });
        }
        for (auto& w : workers) w.join();
    }

    // sequential merge in chunk order: global code = first-appearance
    // rank across concatenated chunks = the sequential rank (the SAME
    // CodeTable the sequential pass uses, so byte-identity holds by
    // construction)
    CodeTable table(uniq, uniq_cap);
    std::vector<std::vector<int64_t>> remap((size_t)t);
    for (int64_t c = 0; c < t; ++c) {
        if (local_nu[(size_t)c] < 0) return -1;  // local overflow
        remap[(size_t)c].resize((size_t)local_nu[(size_t)c]);
        for (int64_t l = 0; l < local_nu[(size_t)c]; ++l) {
            const int64_t code = table.lookup_or_insert(
                local_uniq[(size_t)c][(size_t)l]);
            if (code < 0) return -1;
            remap[(size_t)c][(size_t)l] = code;
        }
    }
    const int64_t nu = table.nu;

    // parallel remap: local chunk codes -> global codes
    {
        std::vector<std::thread> workers;
        for (int64_t c = 0; c < t; ++c) {
            workers.emplace_back([&, c]() {
                const int64_t lo = c * chunk;
                const int64_t hi = std::min(n, lo + chunk);
                const std::vector<int64_t>& m = remap[(size_t)c];
                for (int64_t i = lo; i < hi; ++i)
                    codes[i] = m[(size_t)codes[i]];
            });
        }
        for (auto& w : workers) w.join();
    }
    return nu;
}

// Document frequency over an (n_rows, w) matrix of codes in [0, u):
// df[c] = number of rows containing code c at least once. One pass with a
// per-code last-seen-row stamp — replaces the per-chunk bincount-matrix
// (small u) and row-sort (large u) python engines in the CountVectorizer
// fit (text.py _doc_freq_small_domain / _rowwise_counts), both of which
// materialize large temporaries this kernel never needs.
//
// Returns 0, or -1 when any code falls outside [0, u) — this is a
// module-level API and the python engines it replaces raised IndexError
// on bad codes, so an unchecked write here would be silent heap
// corruption in the parent or a forked worker; the wrapper returns None
// and the caller falls back to the (bounds-checked) python engine.
// n_threads > 1 splits the rows: each worker stamps its own last-seen
// array into its own df partial (8·u bytes each — the wrapper's domain
// cap bounds it) and the partials merge by exact integer sum, so the
// threaded result is byte-identical; ANY worker's bounds hit fails the
// whole call (the guard contract is thread-count-invariant).
static int64_t doc_freq_rows(const int64_t* codes, int64_t r0, int64_t r1,
                             int64_t w, int64_t u, int64_t* df) {
    std::vector<int64_t> last(u, -1);
    for (int64_t r = r0; r < r1; ++r) {
        const int64_t* row = codes + r * w;
        for (int64_t j = 0; j < w; ++j) {
            const int64_t c = row[j];
            if (c < 0 || c >= u) return -1;
            if (last[c] != r) {
                last[c] = r;
                ++df[c];
            }
        }
    }
    return 0;
}

extern "C" int64_t doc_freq_i64(const int64_t* codes, int64_t n_rows,
                                int64_t w, int64_t u, int64_t* df,
                                int64_t n_threads) {
    const int64_t t = clamp_threads(
        n_threads, n_rows * (w > 0 ? w : 1), 1 << 16);
    if (t <= 1)
        return doc_freq_rows(codes, 0, n_rows, w, u, df);

    const int64_t chunk = (n_rows + t - 1) / t;
    std::vector<std::vector<int64_t>> partial(
        (size_t)t, std::vector<int64_t>((size_t)u, 0));
    std::vector<int64_t> rc((size_t)t, 0);
    std::vector<std::thread> workers;
    for (int64_t c = 0; c < t; ++c) {
        workers.emplace_back([&, c]() {
            const int64_t lo = c * chunk;
            const int64_t hi = std::min(n_rows, lo + chunk);
            rc[(size_t)c] = doc_freq_rows(codes, lo, hi, w, u,
                                          partial[(size_t)c].data());
        });
    }
    for (auto& wk : workers) wk.join();
    for (int64_t c = 0; c < t; ++c)
        if (rc[(size_t)c] < 0) return -1;
    for (int64_t c = 0; c < t; ++c)
        for (int64_t v = 0; v < u; ++v)
            df[v] += partial[(size_t)c][(size_t)v];
    return 0;
}

// Per-row value counts of an (n_rows, w) code matrix with domain [0, u):
// emits CSR-canonical triples (row ascending, value ascending within each
// row) in one pass — a per-row count array plus a touched-value list,
// reset per row. Replaces text.py _rowwise_counts' k-pass / bincount /
// row-sort python engines on the HashingTF/CountVectorizer transform hot
// path. Returns nnz, or -1 if more than cap triples would be written or
// any code falls outside [0, u) — cnt[c] with an unvalidated c is heap
// corruption, where the python engines raised IndexError (caller falls
// back to them either way). Templated over the narrow code dtypes the
// callers actually store (relabeled bucket alphabets are uint8/uint16).
#include <algorithm>

template <typename T>
static int64_t rowwise_counts_impl(const T* codes, int64_t n_rows,
                                   int64_t w, int64_t u, int64_t* row_out,
                                   int64_t* val_out, int64_t* cnt_out,
                                   int64_t cap) {
    std::vector<int64_t> cnt(u, 0);
    std::vector<int64_t> touched;
    touched.reserve((size_t)std::min<int64_t>(w, u));
    int64_t nnz = 0;
    for (int64_t r = 0; r < n_rows; ++r) {
        const T* row = codes + r * w;
        for (int64_t j = 0; j < w; ++j) {
            const int64_t c = (int64_t)row[j];
            if (c < 0 || c >= u) return -1;
            if (cnt[c] == 0) touched.push_back(c);
            ++cnt[c];
        }
        std::sort(touched.begin(), touched.end());
        if (nnz + (int64_t)touched.size() > cap) return -1;
        for (const int64_t c : touched) {
            row_out[nnz] = r;
            val_out[nnz] = c;
            cnt_out[nnz] = cnt[c];
            cnt[c] = 0;
            ++nnz;
        }
        touched.clear();
    }
    return nnz;
}

extern "C" int64_t rowwise_counts_u8(const uint8_t* codes, int64_t n_rows,
                                     int64_t w, int64_t u, int64_t* row_out,
                                     int64_t* val_out, int64_t* cnt_out,
                                     int64_t cap) {
    return rowwise_counts_impl(codes, n_rows, w, u, row_out, val_out,
                               cnt_out, cap);
}

extern "C" int64_t rowwise_counts_u16(const uint16_t* codes, int64_t n_rows,
                                      int64_t w, int64_t u,
                                      int64_t* row_out, int64_t* val_out,
                                      int64_t* cnt_out, int64_t cap) {
    return rowwise_counts_impl(codes, n_rows, w, u, row_out, val_out,
                               cnt_out, cap);
}

extern "C" int64_t rowwise_counts_u32(const uint32_t* codes, int64_t n_rows,
                                      int64_t w, int64_t u,
                                      int64_t* row_out, int64_t* val_out,
                                      int64_t* cnt_out, int64_t cap) {
    return rowwise_counts_impl(codes, n_rows, w, u, row_out, val_out,
                               cnt_out, cap);
}

extern "C" int64_t rowwise_counts_i64(const int64_t* codes, int64_t n_rows,
                                      int64_t w, int64_t u,
                                      int64_t* row_out, int64_t* val_out,
                                      int64_t* cnt_out, int64_t cap) {
    return rowwise_counts_impl(codes, n_rows, w, u, row_out, val_out,
                               cnt_out, cap);
}
