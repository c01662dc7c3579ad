// Copy of `jaeger_tpu/native/jaeger_host.cpp`, built and loaded by the
// port's own loader (jaeger_tpu_torch/native/__init__.py).
//
// jaeger-tpu native host library.
//
// C++ equivalents of the host-side hot paths the reference delegates to
// compiled dependencies (SURVEY §2.5): FASTA/gzip streaming (pyfastx),
// SDUST low-complexity masking (pydustmasker), ASCII->base-ID encoding +
// window composition (numba kernels in dataops/convert.py), and
// affine-gap Smith-Waterman with traceback (parasail sw_trace_scan_16).
// Exposed through a plain C ABI consumed via ctypes
// (jaeger_tpu/native/__init__.py). Behaviour is pinned against the pure
// Python oracles by tests/test_native.py.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cfenv>
#include <chrono>
#include <clocale>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// FASTA reader (plain + gzip via zlib; gzread handles both)
// ---------------------------------------------------------------------------

struct JtFastaReader {
    gzFile fh = nullptr;
    std::string pending;   // next header line (without '>')
    std::string header;
    std::string seq;
    std::string error;     // non-empty after a real read error (not EOF)
    char buf[1 << 16];
};

void* jt_open_fasta(const char* path) {
    gzFile fh = gzopen(path, "rb");
    if (!fh) return nullptr;
    auto* r = new JtFastaReader();
    r->fh = fh;
    return r;
}

// "" when the stream ended cleanly; a message when gzgets stopped on a
// zlib/IO error (e.g. a TRUNCATED OR CORRUPT .gz, which gzgets reports
// identically to EOF). Callers that treat jt_next_contig's -1 as
// end-of-stream must check this, or a partial read looks complete.
const char* jt_fasta_error(void* handle) {
    return static_cast<JtFastaReader*>(handle)->error.c_str();
}

static bool jt_getline(JtFastaReader* r, std::string& line) {
    line.clear();
    while (true) {
        if (gzgets(r->fh, r->buf, sizeof(r->buf)) == nullptr) {
            int errnum = Z_OK;
            const char* msg = gzerror(r->fh, &errnum);
            if (errnum == Z_ERRNO) {
                r->error = std::string("read error: ")
                    + std::strerror(errno);
            } else if (errnum != Z_OK && errnum != Z_STREAM_END) {
                r->error = std::string("decompression error: ")
                    + (msg ? msg : "unknown");
            } else if (!gzeof(r->fh)) {
                r->error = "read stopped before end of file";
            }
            return !line.empty() && r->error.empty();
        }
        line += r->buf;
        if (!line.empty() && line.back() == '\n') {
            line.pop_back();
            if (!line.empty() && line.back() == '\r') line.pop_back();
            return true;
        }
    }
}

// Returns sequence length, or -1 at EOF. header/seq pointers stay valid
// until the next call.
long jt_next_contig(void* handle, const char** header, const char** seq) {
    auto* r = static_cast<JtFastaReader*>(handle);
    std::string line;
    if (r->pending.empty()) {
        // scan forward to the first header
        while (jt_getline(r, line)) {
            if (!line.empty() && line[0] == '>') {
                r->pending = line.substr(1);
                break;
            }
        }
        if (r->pending.empty()) return -1;
    }
    r->header = r->pending;
    // strip leading/trailing whitespace from header
    size_t a = r->header.find_first_not_of(" \t");
    size_t b = r->header.find_last_not_of(" \t");
    r->header = (a == std::string::npos)
        ? std::string()
        : r->header.substr(a, b - a + 1);
    r->pending.clear();
    r->seq.clear();
    while (jt_getline(r, line)) {
        if (!line.empty() && line[0] == '>') {
            r->pending = line.substr(1);
            break;
        }
        r->seq += line;
    }
    *header = r->header.c_str();
    *seq = r->seq.c_str();
    return static_cast<long>(r->seq.size());
}

void jt_close_fasta(void* handle) {
    auto* r = static_cast<JtFastaReader*>(handle);
    if (r->fh) gzclose(r->fh);
    delete r;
}

// ---------------------------------------------------------------------------
// ASCII -> base-ID encoding + composition
// (IDs: A=0 T=1 G=2 C=3 N/other=4, a=5 t=6 g=7 c=8 — see seqops/windows.py)
// ---------------------------------------------------------------------------

static uint8_t ASCII_LUT[256];
static bool LUT_INIT = [] {
    memset(ASCII_LUT, 4, sizeof(ASCII_LUT));
    ASCII_LUT[(unsigned char)'A'] = 0; ASCII_LUT[(unsigned char)'T'] = 1;
    ASCII_LUT[(unsigned char)'G'] = 2; ASCII_LUT[(unsigned char)'C'] = 3;
    ASCII_LUT[(unsigned char)'a'] = 5; ASCII_LUT[(unsigned char)'t'] = 6;
    ASCII_LUT[(unsigned char)'g'] = 7; ASCII_LUT[(unsigned char)'c'] = 8;
    return true;
}();

void jt_encode_ascii(const char* seq, long len, unsigned char* out) {
    for (long i = 0; i < len; ++i)
        out[i] = ASCII_LUT[(unsigned char)seq[i]];
}

// counts[0..3] = G, C, A, T over base IDs (upper+lower folded)
void jt_composition(const unsigned char* ids, long len, long* counts) {
    long g = 0, c = 0, a = 0, t = 0;
    for (long i = 0; i < len; ++i) {
        switch (ids[i] >= 5 ? ids[i] - 5 : ids[i]) {
            case 0: ++a; break;
            case 1: ++t; break;
            case 2: ++g; break;
            case 3: ++c; break;
            default: break;
        }
    }
    counts[0] = g; counts[1] = c; counts[2] = a; counts[3] = t;
}

// ---------------------------------------------------------------------------
// SDUST (same algorithm as jaeger_tpu/seqops/dust.py)
// ---------------------------------------------------------------------------

struct PerfIntv { long start_t, finish_b; long num, den; };

static void sdust_run(const uint8_t* codes, long n, int W, int T,
                      long run_offset, std::vector<long>& out) {
    if (n < 3) return;
    std::vector<std::pair<long, long>> res;  // merged base intervals
    std::vector<PerfIntv> P;                 // sorted by start descending
    // triplet window as a flat ring: wbuf[(whead + k) & wmask] is w[k]
    long wcap = 4;
    while (wcap < (long)W) wcap <<= 1;  // power of 2 >= W-2
    const long wmask = wcap - 1;
    std::vector<int> wbuf(wcap);
    long wn = 0, whead = 0;
    int cw[64] = {0}, cv[64] = {0};
    long L = 0, rv = 0, rw = 0;

    auto emit = [&](long s, long f) {
        if (!res.empty() && s <= res.back().second + 1) {
            if (f > res.back().second) res.back().second = f;
        } else {
            res.emplace_back(s, f);
        }
    };
    auto wat = [&](long k) { return wbuf[(whead + k) & wmask]; };

    long num_tri = n - 2;
    std::vector<int> cbuf(64);
    std::vector<PerfIntv> fresh;
    for (long i = 0; i < num_tri; ++i) {
        long start = i - (W - 2) + 1;
        if (start < 0) start = 0;
        while (!P.empty() && P.back().start_t < start) {
            emit(P.back().start_t, P.back().finish_b);
            P.pop_back();
        }

        int t = (codes[i] << 4) | (codes[i + 1] << 2) | codes[i + 2];

        if (wn >= W - 2) {
            int s = wbuf[whead];
            whead = (whead + 1) & wmask;
            --wn;
            cw[s] -= 1;
            rw -= cw[s];
            if (L > wn) {
                --L;
                cv[s] -= 1;
                rv -= cv[s];
            }
        }
        wbuf[(whead + wn) & wmask] = t;
        ++wn;
        ++L;
        rw += cw[t]; cw[t] += 1;
        rv += cv[t]; cv[t] += 1;
        if (cv[t] * 10 > 2 * T) {
            while (true) {
                int s = wat(wn - L);
                cv[s] -= 1;
                rv -= cv[s];
                --L;
                if (s == t) break;
            }
        }

        // Gate the perfect-interval scan on the whole-window score
        // (sdust's classic pruning): every candidate suffix scanned
        // below has new_len >= L and score r <= rw (its triplet counts
        // are dominated by the whole window's), so r*10 > T*new_len
        // implies rw*10 > T*L — when the gate is false the scan can
        // emit nothing and is skipped. On non-repetitive DNA the gate
        // almost never fires, which removes the per-triplet
        // 64-int copy + O(W) backward scan (measured 35 -> ~500 MB/s).
        if (rw * 10 <= (long)T * L) continue;

        // find perfect intervals ending at the current position
        memcpy(cbuf.data(), cv, sizeof(cv));
        long r = rv;
        long w_len = wn;
        long w_start = i + 1 - w_len;
        long max_num = 0, max_den = 1;
        fresh.clear();
        for (long idx = w_len - L - 1; idx >= 0; --idx) {
            int tt = wat(idx);
            r += cbuf[tt];
            cbuf[tt] += 1;
            long new_len = w_len - idx - 1;
            if (r * 10 > (long)T * new_len) {
                long new_start = idx + w_start;
                for (auto& p : P) {
                    if (p.start_t < new_start) break;
                    if (max_num * p.den < p.num * max_den) {
                        max_num = p.num; max_den = p.den;
                    }
                }
                for (auto& p : fresh) {
                    if (max_num * p.den < p.num * max_den) {
                        max_num = p.num; max_den = p.den;
                    }
                }
                if (r * max_den >= max_num * new_len)
                    fresh.push_back({new_start, i + 2, r, new_len});
            }
        }
        // sort fresh by start descending, then insert keeping P ordered
        for (size_t a2 = 0; a2 < fresh.size(); ++a2)
            for (size_t b2 = a2 + 1; b2 < fresh.size(); ++b2)
                if (fresh[b2].start_t > fresh[a2].start_t)
                    std::swap(fresh[a2], fresh[b2]);
        for (auto& e : fresh) {
            size_t j = 0;
            while (j < P.size() && P[j].start_t >= e.start_t) ++j;
            P.insert(P.begin() + j, e);
        }
    }
    while (!P.empty()) {
        emit(P.back().start_t, P.back().finish_b);
        P.pop_back();
    }
    for (auto& [s, f] : res) {
        out.push_back(run_offset + s);
        out.push_back(run_offset + f + 1);  // half-open end
    }
}

// All (start, end) half-open pairs for a sequence, uncapped.
static void sdust_all(const char* seq, long len, int window, int threshold,
                      std::vector<long>& intervals) {
    static int8_t BCODE[256];
    static bool binit = [] {
        memset(BCODE, -1, sizeof(BCODE));
        BCODE[(unsigned char)'A'] = 0; BCODE[(unsigned char)'a'] = 0;
        BCODE[(unsigned char)'C'] = 1; BCODE[(unsigned char)'c'] = 1;
        BCODE[(unsigned char)'G'] = 2; BCODE[(unsigned char)'g'] = 2;
        BCODE[(unsigned char)'T'] = 3; BCODE[(unsigned char)'t'] = 3;
        return true;
    }();
    (void)binit;

    std::vector<uint8_t> codes;
    long run_start = -1;
    for (long pos = 0; pos <= len; ++pos) {
        int code = pos < len ? BCODE[(unsigned char)seq[pos]] : -1;
        if (code < 0) {
            if (run_start >= 0) {
                sdust_run(codes.data(), (long)codes.size(), window,
                          threshold, run_start, intervals);
                codes.clear();
                run_start = -1;
            }
        } else {
            if (run_start < 0) run_start = pos;
            codes.push_back((uint8_t)code);
        }
    }
}

// Fills out with (start, end) half-open pairs; returns the TOTAL interval
// count (may exceed cap; only cap pairs are written — callers retry with
// a bigger buffer when the return value is > cap).
long jt_sdust(const char* seq, long len, int window, int threshold,
              long* out, long cap) {
    std::vector<long> intervals;
    sdust_all(seq, len, window, threshold, intervals);
    long n_pairs = (long)intervals.size() / 2;
    long n_copy = n_pairs > cap ? cap : n_pairs;
    memcpy(out, intervals.data(), n_copy * 2 * sizeof(long));
    return n_pairs;
}

// Soft-mask in place: lowercase masked ranges (uncapped — parity with the
// pure-Python dust_mask fallback). Returns interval count.
long jt_dust_mask(char* seq, long len, int window, int threshold) {
    std::vector<long> iv;
    sdust_all(seq, len, window, threshold, iv);
    long n = (long)iv.size() / 2;
    for (long i = 0; i < n; ++i) {
        for (long p = iv[2 * i]; p < iv[2 * i + 1]; ++p) {
            char c = seq[p];
            if (c >= 'A' && c <= 'Z') seq[p] = c + 32;
        }
    }
    return n;
}

// Uppercase + SDUST soft-mask + base-ID encode in ONE pass over the contig.
// Replaces the hot-path round trip str->bytes->sdust->str->bytes->LUT that
// `seqops.windows._contig_rows` paid per contig (dust soft-masking encoded
// directly as lowercase IDs 5-8). Returns the dust-interval count.
long jt_contig_ids(const char* seq, long len, int do_dust, int window,
                   int threshold, unsigned char* out) {
    std::vector<char> up(len);
    for (long i = 0; i < len; ++i) {
        char c = seq[i];
        up[i] = (c >= 'a' && c <= 'z') ? (char)(c - 32) : c;
    }
    for (long i = 0; i < len; ++i)
        out[i] = ASCII_LUT[(unsigned char)up[i]];
    if (!do_dust) return 0;
    std::vector<long> iv;
    sdust_all(up.data(), len, window, threshold, iv);
    long n = (long)iv.size() / 2;
    for (long i = 0; i < n; ++i)
        for (long p = iv[2 * i]; p < iv[2 * i + 1]; ++p)
            if (out[p] < 4) out[p] = (unsigned char)(out[p] + 5);
    return n;
}

// Per-window composition over UPPERCASE base IDs only (soft-masked bases
// excluded, matching the reference's case-sensitive counts). out is
// (n_windows, 4) int64 laid out A, T, G, C.
void jt_window_counts(const unsigned char* ids, const long* starts,
                      long n_windows, long width, long* out) {
    for (long w = 0; w < n_windows; ++w) {
        long a = 0, t = 0, g = 0, c = 0;
        const unsigned char* p = ids + starts[w];
        // branchless equality sums vectorize (byte compares + psadbw
        // reductions under -march=native); the switch version ran at
        // 143 MB/s, this at several GB/s
        for (long k = 0; k < width; ++k) {
            unsigned char v = p[k];
            a += (v == 0); t += (v == 1);
            g += (v == 2); c += (v == 3);
        }
        out[w * 4] = a; out[w * 4 + 1] = t;
        out[w * 4 + 2] = g; out[w * 4 + 3] = c;
    }
}

// Reference-parity 2-decimal rounding of (g-c)/(g+c): CPython's
// round(x, 2) correctly rounds the double's exact decimal expansion
// (ties to even), which glibc's printf shortest-correct conversion also
// does — np.round's scale-by-100 trick does NOT (it rounds the binary
// product) and disagrees on half-way-straddling values. Fuzz-pinned
// against Python round() in tests/test_native.py.
static double jt_gc_skew(long g, long c) {
    long den = g + c;
    if (den == 0) return 0.0;
    double v = (double)(g - c) / (double)den;
    // Python round(v, 2) parity via correctly-rounded decimal text.
    // snprintf/strtod honour LC_NUMERIC — an embedding process in a
    // comma-decimal locale would print "0,33" and strtod would stop at
    // the comma — so pin the C locale for this call (magic-static init
    // is thread-safe; on newlocale failure uselocale(0) is a no-op and
    // we keep the process locale, the pre-fix behaviour).
    static locale_t c_loc = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
    locale_t prev = uselocale(c_loc);
    char buf[32];
    snprintf(buf, sizeof(buf), "%.2f", v);
    double out = strtod(buf, nullptr);
    if (prev != (locale_t)0) uselocale(prev);
    return out;
}

// The whole per-contig window loop in ONE GIL-released call:
// uppercase + SDUST + encode (jt_contig_ids), per-window A/T/G/C counts
// (jt_window_counts), reference-parity gc_skew, window slicing, and the
// 11-column meta block the batcher consumes. Replaces four native
// calls + per-contig numpy/python glue that serialized the thread pool
// on the GIL (round-5 ingest scaling; experiments/ingest_profile.py).
//
// wins: (n_windows, fragsize) uint8 row-major.
// meta: (n_windows, 11) float64 laid out
//   [length, hidx(left 0), start, contig_end, ordinal, seqlen,
//    g, c, a, t, gc_skew]
// Returns the dust-interval count (parity with jt_contig_ids).
long jt_contig_rows(const char* seq, long len, int do_dust, int window,
                    int threshold, const long* starts, long n_windows,
                    long fragsize, long seqlen_meta,
                    unsigned char* wins, double* meta) {
    std::vector<unsigned char> ids(len);
    long n_iv = jt_contig_ids(seq, len, do_dust, window, threshold,
                              ids.data());
    for (long w = 0; w < n_windows; ++w) {
        const unsigned char* p = ids.data() + starts[w];
        memcpy(wins + w * fragsize, p, fragsize);
        long a = 0, t = 0, g = 0, c = 0;
        for (long k = 0; k < fragsize; ++k) {
            unsigned char v = p[k];
            a += (v == 0); t += (v == 1);
            g += (v == 2); c += (v == 3);
        }
        double* m = meta + w * 11;
        m[0] = (double)fragsize;
        m[1] = 0.0;                       // hidx, filled by the batcher
        m[2] = (double)starts[w];
        m[3] = (w == n_windows - 1) ? 1.0 : 0.0;
        m[4] = (double)w;
        m[5] = (double)seqlen_meta;
        m[6] = (double)g;
        m[7] = (double)c;
        m[8] = (double)a;
        m[9] = (double)t;
        m[10] = jt_gc_skew(g, c);
    }
    return n_iv;
}

// ---------------------------------------------------------------------------
// Full window pipeline: reader thread + worker pool + ordered batcher,
// entirely native. Python calls jt_pipeline_next once per BATCH, so the
// GIL is held only for a handful of calls per 4096 windows — the
// round-4 worker curve regressed past 2 threads because per-contig
// Python (submit/result glue, meta assembly, flush) serialized on the
// GIL. Semantics are byte-identical to seqops.windows.window_batches
// (pinned by tests/test_native.py::test_pipeline_matches_python).
// ---------------------------------------------------------------------------

namespace {

// window start positions, mirroring seqops.windows.window_indices
// (incl. the dynamic-stride spread with Python round()'s half-even)
static void jt_window_starts(long seqlen, long fragsize, long stride,
                             int dynamic, double dyn_threshold,
                             std::vector<long>& out) {
    out.clear();
    if (!dynamic || (double)seqlen >= dyn_threshold * (double)fragsize) {
        long step = stride > 0 ? stride : fragsize;
        for (long s = 0; s <= seqlen - fragsize; s += step) out.push_back(s);
        return;
    }
    long n_windows = (seqlen + fragsize - 1) / fragsize;
    if (n_windows < 1) n_windows = 1;
    if (n_windows == 1) { out.push_back(0); return; }
    double raw_stride = (double)(seqlen - fragsize) / (double)(n_windows - 1);
    std::vector<long> idx(n_windows);
    for (long i = 0; i < n_windows; ++i) {
        // Python round() on a float: correctly-rounded half-even
        double v = raw_stride * (double)i;
        idx[i] = (long)nearbyint(v);
    }
    idx[n_windows - 1] = seqlen - fragsize;
    // de-dup preserving order
    for (long i = 0; i < n_windows; ++i) {
        bool seen = false;
        for (long v : out) if (v == idx[i]) { seen = true; break; }
        if (!seen) out.push_back(idx[i]);
    }
}

struct JtContigJob {
    long ord = 0;              // submission order
    std::string header;        // stripped, commas replaced
    std::string seq;
};

struct JtContigResult {
    std::string header;
    long n_win = 0;            // 0 = headerless slot only (sub-min_len)
    std::vector<unsigned char> wins;   // n_win * fragsize, N-padded rows
    std::vector<double> meta;          // n_win * 11, hidx left 0
};

struct JtPipeline {
    // config
    std::string path;
    long fragsize, stride, min_len, max_len, batch_capacity;
    int dynamic_stride, dustmask, dust_window, dust_threshold;
    double dyn_threshold;
    int n_workers;

    // reader -> workers
    std::mutex mu;
    std::condition_variable cv_submit, cv_result;
    std::deque<JtContigJob> jobs;
    std::map<long, JtContigResult> done;   // keyed by ord
    long next_ord_submit = 0;              // reader side
    long next_ord_consume = 0;             // batcher side
    bool reader_done = false, abort = false;
    std::string reader_error;
    std::string err_copy;                  // stable buffer for the getter

    // batcher state (consumer side, no lock needed: single consumer)
    JtContigResult cur;                    // contig being drained
    long cur_off = 0;                      // rows consumed from cur
    bool cur_live = false;
    long global_hidx = 0;                  // headers consumed so far
    std::vector<std::string> new_headers;  // since last drain

    std::vector<std::thread> threads;

    // where the time goes (jt_pipeline_stats): the consumer blocked on
    // cv_result, the workers inside jt_worker_process, since open
    std::atomic<long long> consumer_wait_ns{0}, worker_busy_ns{0};
    std::chrono::steady_clock::time_point opened;
};

static long long jt_ns_since(std::chrono::steady_clock::time_point t0) {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now() - t0).count();
}

static void jt_worker_process(JtPipeline* p, JtContigJob& job,
                              JtContigResult& res) {
    res.header = std::move(job.header);
    const std::string& seq = job.seq;
    long seqlen = (long)seq.size();
    if (seqlen >= p->fragsize) {
        std::vector<long> starts;
        jt_window_starts(seqlen, p->fragsize, p->stride, p->dynamic_stride,
                         p->dyn_threshold, starts);
        res.n_win = (long)starts.size();
        res.wins.resize(res.n_win * p->fragsize);
        res.meta.resize(res.n_win * 11);
        jt_contig_rows(seq.data(), seqlen, p->dustmask, p->dust_window,
                       p->dust_threshold, starts.data(), res.n_win,
                       p->fragsize, seqlen, res.wins.data(),
                       res.meta.data());
    } else if (seqlen >= p->min_len) {
        std::vector<unsigned char> ids(seqlen);
        jt_contig_ids(seq.data(), seqlen, p->dustmask, p->dust_window,
                      p->dust_threshold, ids.data());
        res.n_win = 1;
        res.wins.assign(p->fragsize, 4);   // N-padded tail
        memcpy(res.wins.data(), ids.data(), seqlen);
        // reference counts UPPERCASE base IDs only (soft-masked excluded)
        long a = 0, t = 0, g = 0, c = 0;
        for (long i = 0; i < seqlen; ++i) {
            unsigned char v = ids[i];
            a += (v == 0); t += (v == 1); g += (v == 2); c += (v == 3);
        }
        res.meta.assign(11, 0.0);
        res.meta[0] = (double)seqlen;
        res.meta[3] = 1.0;                 // contig_end
        res.meta[5] = (double)seqlen;
        res.meta[6] = (double)g; res.meta[7] = (double)c;
        res.meta[8] = (double)a; res.meta[9] = (double)t;
        res.meta[10] = jt_gc_skew(g, c);
    } else {
        res.n_win = 0;                     // header slot only
    }
}

static void jt_worker_main(JtPipeline* p) {
    while (true) {
        JtContigJob job;
        {
            std::unique_lock<std::mutex> lk(p->mu);
            p->cv_submit.wait(lk, [&] {
                return p->abort || !p->jobs.empty() || p->reader_done;
            });
            if (p->abort || (p->jobs.empty() && p->reader_done)) return;
            job = std::move(p->jobs.front());
            p->jobs.pop_front();
        }
        JtContigResult res;
        auto t0 = std::chrono::steady_clock::now();
        jt_worker_process(p, job, res);
        p->worker_busy_ns += jt_ns_since(t0);
        {
            std::lock_guard<std::mutex> lk(p->mu);
            p->done.emplace(job.ord, std::move(res));
        }
        p->cv_result.notify_all();
    }
}

static void jt_reader_main(JtPipeline* p) {
    void* fh = jt_open_fasta(p->path.c_str());
    if (!fh) {
        std::lock_guard<std::mutex> lk(p->mu);
        p->reader_error = "cannot open " + p->path;
        p->reader_done = true;
        p->cv_submit.notify_all();
        p->cv_result.notify_all();
        return;
    }
    const char* header; const char* seq;
    bool aborted = false;
    while (true) {
        long n = jt_next_contig(fh, &header, &seq);
        if (n < 0) break;
        if (p->max_len >= 0 && n > p->max_len) continue;  // no header slot
        JtContigJob job;
        job.header.assign(header);
        // commas -> ___ (reference header normalization)
        size_t pos = 0;
        while ((pos = job.header.find(',', pos)) != std::string::npos) {
            job.header.replace(pos, 1, "___");
            pos += 3;
        }
        job.seq.assign(seq, n);
        {
            std::unique_lock<std::mutex> lk(p->mu);
            // bounded queue: cap in-flight contigs like the Python pool
            p->cv_result.wait(lk, [&] {
                return p->abort ||
                    (long)(p->jobs.size() + p->done.size())
                        < 2 * p->n_workers + 2;
            });
            if (p->abort) { aborted = true; break; }
            job.ord = p->next_ord_submit++;
            p->jobs.push_back(std::move(job));
        }
        p->cv_submit.notify_one();
    }
    // a truncated/corrupt input ends the contig loop exactly like EOF —
    // surface it as an error, not a short-but-complete stream
    std::string read_err = aborted ? "" : jt_fasta_error(fh);
    jt_close_fasta(fh);
    {
        std::lock_guard<std::mutex> lk(p->mu);
        if (!read_err.empty())
            // zlib's gzerror text already names the file; only add the
            // path when the message doesn't carry it
            p->reader_error = read_err.find(p->path) != std::string::npos
                ? read_err : read_err + " in " + p->path;
        p->reader_done = true;
    }
    p->cv_submit.notify_all();
    p->cv_result.notify_all();
}

}  // namespace

void* jt_pipeline_open(const char* path, long fragsize, long stride,
                       int dynamic_stride, double dyn_threshold,
                       long min_len, long max_len, int dustmask,
                       int dust_window, int dust_threshold,
                       long batch_capacity, int workers) {
    auto* p = new JtPipeline();
    p->path = path;
    p->fragsize = fragsize;
    p->stride = stride;
    p->dynamic_stride = dynamic_stride;
    p->dyn_threshold = dyn_threshold;
    p->min_len = min_len;
    p->max_len = max_len;
    p->dustmask = dustmask;
    p->dust_window = dust_window;
    p->dust_threshold = dust_threshold;
    p->batch_capacity = batch_capacity;
    p->n_workers = workers < 1 ? 1 : workers;
    p->opened = std::chrono::steady_clock::now();
    p->threads.emplace_back(jt_reader_main, p);
    for (int i = 0; i < p->n_workers; ++i)
        p->threads.emplace_back(jt_worker_main, p);
    return p;
}

// Assemble the next batch into caller-provided buffers:
//   bases (batch_capacity, fragsize) uint8, meta (batch_capacity, 11) f64
// Returns rows written (0 = end of stream, -1 = reader error).
// New headers encountered while assembling accumulate internally; drain
// them with jt_pipeline_header_bytes / jt_pipeline_drain_headers after
// each call (hidx in meta indexes the GLOBAL header list).
long jt_pipeline_next(void* handle, unsigned char* bases, double* meta) {
    auto* p = static_cast<JtPipeline*>(handle);
    long row = 0;
    while (row < p->batch_capacity) {
        if (!p->cur_live) {
            std::unique_lock<std::mutex> lk(p->mu);
            auto t0 = std::chrono::steady_clock::now();
            p->cv_result.wait(lk, [&] {
                return p->abort || !p->reader_error.empty()
                    || p->done.count(p->next_ord_consume)
                    || (p->reader_done && p->jobs.empty()
                        && p->next_ord_consume >= p->next_ord_submit);
            });
            p->consumer_wait_ns += jt_ns_since(t0);
            if (!p->reader_error.empty()) return -1;
            if (p->abort) return 0;
            auto it = p->done.find(p->next_ord_consume);
            if (it == p->done.end()) break;  // stream exhausted
            p->cur = std::move(it->second);
            p->done.erase(it);
            ++p->next_ord_consume;
            lk.unlock();
            p->cv_result.notify_all();  // reader may refill the bound
            p->cur_off = 0;
            p->cur_live = true;
            p->new_headers.push_back(std::move(p->cur.header));
            ++p->global_hidx;
            if (p->cur.n_win == 0) { p->cur_live = false; continue; }
        }
        long take = std::min(p->cur.n_win - p->cur_off,
                             p->batch_capacity - row);
        memcpy(bases + row * p->fragsize,
               p->cur.wins.data() + p->cur_off * p->fragsize,
               take * p->fragsize);
        memcpy(meta + row * 11, p->cur.meta.data() + p->cur_off * 11,
               take * 11 * sizeof(double));
        double hidx = (double)(p->global_hidx - 1);
        for (long r = 0; r < take; ++r) meta[(row + r) * 11 + 1] = hidx;
        row += take;
        p->cur_off += take;
        if (p->cur_off >= p->cur.n_win) p->cur_live = false;
    }
    return row;
}

// Total bytes + count of headers pending drain (call after next()).
long jt_pipeline_header_bytes(void* handle, long* count) {
    auto* p = static_cast<JtPipeline*>(handle);
    long total = 0;
    for (auto& h : p->new_headers) total += (long)h.size();
    *count = (long)p->new_headers.size();
    return total;
}

// Write pending headers (concatenated) + per-header lengths; clears them.
void jt_pipeline_drain_headers(void* handle, char* buf, long* lens) {
    auto* p = static_cast<JtPipeline*>(handle);
    long off = 0, i = 0;
    for (auto& h : p->new_headers) {
        memcpy(buf + off, h.data(), h.size());
        off += (long)h.size();
        lens[i++] = (long)h.size();
    }
    p->new_headers.clear();
}

// out[0..3]: ns the consumer spent blocked in jt_pipeline_next waiting
// for a worker's contig, ns the workers spent on contigs (summed over
// workers), ns since jt_pipeline_open, and the number of workers.
void jt_pipeline_stats(void* handle, long long* out) {
    auto* p = static_cast<JtPipeline*>(handle);
    out[0] = p->consumer_wait_ns.load();
    out[1] = p->worker_busy_ns.load();
    out[2] = jt_ns_since(p->opened);
    out[3] = p->n_workers;
}

// Error message after jt_pipeline_next returned -1 ("" otherwise).
// Valid until jt_pipeline_close; single-consumer like next().
const char* jt_pipeline_error(void* handle) {
    auto* p = static_cast<JtPipeline*>(handle);
    std::lock_guard<std::mutex> lk(p->mu);
    p->err_copy = p->reader_error;
    return p->err_copy.c_str();
}

void jt_pipeline_close(void* handle) {
    auto* p = static_cast<JtPipeline*>(handle);
    {
        std::lock_guard<std::mutex> lk(p->mu);
        p->abort = true;
    }
    p->cv_submit.notify_all();
    p->cv_result.notify_all();
    for (auto& t : p->threads) t.join();
    delete p;
}

// ---------------------------------------------------------------------------
// Affine-gap Smith-Waterman with traceback (parasail-convention scoring)
// ---------------------------------------------------------------------------

long jt_smith_waterman(const char* q, long qn, const char* r, long rn,
                       int open_, int extend, int match, int mismatch,
                       long* end_q, long* end_r,
                       char* q_out, char* r_out, long cap) {
    if (qn == 0 || rn == 0) { *end_q = -1; *end_r = -1; q_out[0] = 0; r_out[0] = 0; return 0; }
    const int NEG = -1000000;
    auto sub = [&](long i, long j) -> int {
        char a = q[i] & ~0x20;   // uppercase
        char b = r[j] & ~0x20;
        bool an = (a=='A'||a=='C'||a=='G'||a=='T');
        bool bn = (b=='A'||b=='C'||b=='G'||b=='T');
        return (an && bn && a == b) ? match : mismatch;
    };

    std::vector<int> H((qn + 1) * (rn + 1), 0);
    std::vector<int> E((qn + 1) * (rn + 1), NEG);
    std::vector<int> F((qn + 1) * (rn + 1), NEG);
    auto idx = [&](long i, long j) { return i * (rn + 1) + j; };

    int best = 0; long bi = 0, bj = 0;
    for (long i = 1; i <= qn; ++i) {
        int e = NEG;
        for (long j = 1; j <= rn; ++j) {
            int f = std::max(H[idx(i-1,j)] - open_, F[idx(i-1,j)] - extend);
            F[idx(i,j)] = f;
            e = std::max(H[idx(i,j-1)] - open_, e - extend);
            E[idx(i,j)] = e;
            int h = H[idx(i-1,j-1)] + sub(i-1, j-1);
            if (e > h) h = e;
            if (f > h) h = f;
            if (h < 0) h = 0;
            H[idx(i,j)] = h;
            if (h > best) { best = h; bi = i; bj = j; }
        }
    }
    if (best == 0) { *end_q = -1; *end_r = -1; q_out[0] = 0; r_out[0] = 0; return 0; }

    // traceback
    std::string qa, ra;
    long i = bi, j = bj;
    char state = 'H';
    while (i > 0 && j > 0) {
        if (state == 'H') {
            int h = H[idx(i,j)];
            if (h == 0) break;
            if (h == H[idx(i-1,j-1)] + sub(i-1, j-1)) {
                qa += q[i-1]; ra += r[j-1]; --i; --j;
            } else if (h == E[idx(i,j)]) state = 'E';
            else if (h == F[idx(i,j)]) state = 'F';
            else break;
        } else if (state == 'E') {
            qa += '-'; ra += r[j-1];
            if (E[idx(i,j)] == H[idx(i,j-1)] - open_) state = 'H';
            --j;
        } else {
            qa += q[i-1]; ra += '-';
            if (F[idx(i,j)] == H[idx(i-1,j)] - open_) state = 'H';
            --i;
        }
    }
    long alen = (long)qa.size();
    if (alen >= cap) alen = cap - 1;
    std::string qr(qa.rbegin(), qa.rend()), rr(ra.rbegin(), ra.rend());
    memcpy(q_out, qr.data(), alen);
    memcpy(r_out, rr.data(), alen);
    q_out[alen] = 0; r_out[alen] = 0;
    *end_q = bi - 1;
    *end_r = bj - 1;
    return best;
}

}  // extern "C"
