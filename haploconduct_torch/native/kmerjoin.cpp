// Native candidate-join kernels for the host k-mer overlap engine
// (ops/kmer.py). The sort-join over seed hits is coverage-quadratic — at
// deep coverage the numpy expansion materializes ~10 flat int64 passes over
// tens of millions of rows and a giant np.unique. Here each OpenMP thread
// expands its query range into a local buffer of packed candidate keys, the
// buffers are merged, parallel-sorted, and uniqued: one pass over the hits,
// one sort. (Reference's equivalent stage is rust-overlaps' FM-index
// search, savage.py:664; candidate *semantics* are unchanged — the output
// is byte-equal to the numpy join's np.unique result.)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#include <parallel/algorithm>
#define SORT_KEYS(b, e) __gnu_parallel::sort((b), (e))
#else
#define SORT_KEYS(b, e) std::sort((b), (e))
#endif

extern "C" {

// Expand searchsorted group ranges into packed unique candidate keys.
// Key layout must match ops/kmer.py _pack_keys: 19b idA | 19b idB |
// 24b shift+2^23 | 1b rev.
// q_sid/q_pos: per query k-mer; left/count: its hash group in the sorted
// forward table (count already zeroed for over-max_group groups).
//
// When the query stream is sid-major (non-decreasing q_sid — ops/kmer.py
// passes the un-hash-sorted table as the query side), the packed key's
// high bits equal q_sid, so a globally sorted-unique output is just the
// concatenation of per-read sorted-unique runs: each read's hits are
// expanded into a small reusable buffer, sorted cache-resident, and
// deduped — no global sort over the (coverage-quadratic) hit count, and
// peak memory is O(unique + per-read hits) instead of O(total hits).
// Threads take contiguous read ranges balanced by hit counts, so their
// outputs concatenate in order. Falls back to the global-sort path when
// q_sid is not sorted.
// lens/min_ov: when min_ov > 0, candidates whose overlap length in the
// query frame (min(la, shift+lb) - max(0, shift)) is below min_ov are
// dropped at emission — the same predicate ops/kmer.py applies after
// unpacking, hoisted here so the per-read buffers and the unique output
// only hold survivors.
static int64_t join_unique(const int64_t* q_sid, const int64_t* q_pos,
                           const int64_t* left, const int64_t* count,
                           int64_t nq, const int64_t* t_sid,
                           const int64_t* t_pos, int64_t rev,
                           const int64_t* lens, int64_t min_ov,
                           std::vector<int64_t>& out) {
    int nthreads = 1;
#if defined(_OPENMP)
    nthreads = omp_get_max_threads();
#endif
    bool sid_major = true;
    for (int64_t q = 1; q < nq; q++) {
        if (q_sid[q] < q_sid[q - 1]) { sid_major = false; break; }
    }
    if (!sid_major) {
        // legacy path: expand everything, global parallel sort + unique
        std::vector<std::vector<int64_t>> local(nthreads);
#pragma omp parallel
        {
            int tid = 0;
#if defined(_OPENMP)
            tid = omp_get_thread_num();
#endif
            std::vector<int64_t>& buf = local[tid];
#pragma omp for schedule(dynamic, 4096)
            for (int64_t q = 0; q < nq; q++) {
                int64_t qa = q_sid[q];
                int64_t qp = q_pos[q];
                int64_t lo = left[q], n = count[q];
                for (int64_t j = 0; j < n; j++) {
                    int64_t tb = t_sid[lo + j];
                    if (tb == qa) continue;
                    int64_t shift = qp - t_pos[lo + j];
                    if (min_ov > 0) {
                        int64_t la = lens[qa], lb = lens[tb];
                        int64_t s0 = shift > 0 ? shift : 0;
                        int64_t e0 = shift + lb < la ? shift + lb : la;
                        if (e0 - s0 < min_ov) continue;
                    }
                    buf.push_back((((qa << 19) | tb) << 25) |
                                  ((shift + (int64_t(1) << 23)) << 1) | rev);
                }
            }
        }
        size_t total = 0;
        for (auto& b : local) total += b.size();
        out.resize(total);
        size_t off = 0;
        for (auto& b : local) {
            std::copy(b.begin(), b.end(), out.begin() + off);
            off += b.size();
            b.clear();
            b.shrink_to_fit();
        }
        SORT_KEYS(out.begin(), out.end());
        out.erase(std::unique(out.begin(), out.end()), out.end());
        return (int64_t)out.size();
    }

    // read boundaries in the query stream + per-read hit prefix sums
    std::vector<int64_t> rd_start;  // query index where each read begins
    rd_start.reserve(1024);
    for (int64_t q = 0; q < nq; q++) {
        if (q == 0 || q_sid[q] != q_sid[q - 1]) rd_start.push_back(q);
    }
    rd_start.push_back(nq);
    int64_t nreads = (int64_t)rd_start.size() - 1;
    std::vector<int64_t> hits_cum(nreads + 1, 0);
    for (int64_t r = 0; r < nreads; r++) {
        int64_t h = 0;
        for (int64_t q = rd_start[r]; q < rd_start[r + 1]; q++) h += count[q];
        hits_cum[r + 1] = hits_cum[r] + h;
    }
    int64_t total_hits = hits_cum[nreads];

    // thread read-ranges balanced by hit share (contiguous, in order)
    int T = nthreads;
    std::vector<int64_t> t_lo(T + 1, nreads);
    t_lo[0] = 0;
    for (int t = 1; t < T; t++) {
        int64_t want = total_hits * t / T;
        t_lo[t] = std::lower_bound(hits_cum.begin(), hits_cum.end() - 1, want)
                  - hits_cum.begin();
        if (t_lo[t] < t_lo[t - 1]) t_lo[t] = t_lo[t - 1];
    }
    t_lo[T] = nreads;

    std::vector<std::vector<int64_t>> local(T);
#pragma omp parallel num_threads(T)
    {
        int tid = 0;
#if defined(_OPENMP)
        tid = omp_get_thread_num();
#endif
        std::vector<int64_t>& uniq = local[tid];
        std::vector<int64_t> buf;  // per-read hit scratch, reused
        for (int64_t r = t_lo[tid]; r < t_lo[tid + 1]; r++) {
            buf.clear();
            int64_t expect = hits_cum[r + 1] - hits_cum[r];
            if ((int64_t)buf.capacity() < expect) buf.reserve(expect);
            for (int64_t q = rd_start[r]; q < rd_start[r + 1]; q++) {
                int64_t qa = q_sid[q];
                int64_t qp = q_pos[q];
                int64_t la = lens ? lens[qa] : 0;
                int64_t lo = left[q], n = count[q];
                for (int64_t j = 0; j < n; j++) {
                    int64_t tb = t_sid[lo + j];
                    if (tb == qa) continue;
                    int64_t shift = qp - t_pos[lo + j];
                    if (min_ov > 0) {
                        int64_t lb = lens[tb];
                        int64_t s0 = shift > 0 ? shift : 0;
                        int64_t e0 = shift + lb < la ? shift + lb : la;
                        if (e0 - s0 < min_ov) continue;
                    }
                    buf.push_back((((qa << 19) | tb) << 25) |
                                  ((shift + (int64_t(1) << 23)) << 1) | rev);
                }
            }
            std::sort(buf.begin(), buf.end());
            int64_t prev = -1;  // keys are non-negative
            for (int64_t kkey : buf) {
                if (kkey != prev) { uniq.push_back(kkey); prev = kkey; }
            }
        }
    }
    size_t total = 0;
    for (auto& b : local) total += b.size();
    out.resize(total);
    size_t off = 0;
    for (auto& b : local) {
        std::copy(b.begin(), b.end(), out.begin() + off);
        off += b.size();
    }
    return (int64_t)out.size();
}

// Canonicalize unique query-frame candidate keys into the final
// idA < idB canonical key set (ops/kmer.py find_overlap_candidates'
// frame-mapping/swap algebra, hoisted: the numpy chain of ~20 full-array
// passes over the raw key set is memory-bound on small hosts). Input keys
// are already min_ov-filtered at emission; with drop_inclusions,
// contained candidates (query frame) are dropped here. Output = sorted
// unique canonical keys — byte-equal to the numpy
// np.unique(_pack_keys(canonical...)) result.
static int64_t canonicalize_keys(const int64_t* keys, int64_t n,
                                 const int64_t* lens, int64_t drop_inclusions,
                                 std::vector<int64_t>& out) {
    out.resize(n);
    int64_t m = 0;
#pragma omp parallel
    {
        std::vector<int64_t> loc;
        loc.reserve(4096);
#pragma omp for schedule(static) nowait
        for (int64_t i = 0; i < n; i++) {
            int64_t key = keys[i];
            int64_t rev = key & 1;
            int64_t shift = ((key >> 1) & ((int64_t(1) << 24) - 1)) -
                            (int64_t(1) << 23);
            int64_t tb = (key >> 25) & ((int64_t(1) << 19) - 1);
            int64_t qa = key >> 44;
            int64_t la = lens[qa], lb = lens[tb];
            if (drop_inclusions) {
                bool contained = (shift <= 0 && shift + lb >= la) ||
                                 (shift >= 0 && shift + lb <= la);
                if (contained) continue;
            }
            // map rev-query diagonal back to A's forward frame
            if (rev) shift = la - (shift + lb);
            int64_t ida = qa, idb = tb;
            if (qa > tb) {
                ida = tb;
                idb = qa;
                shift = rev ? shift + lb - la : -shift;
            }
            loc.push_back((((ida << 19) | idb) << 25) |
                          ((shift + (int64_t(1) << 23)) << 1) | rev);
        }
#pragma omp critical
        {
            std::copy(loc.begin(), loc.end(), out.begin() + m);
            m += (int64_t)loc.size();
        }
    }
    out.resize(m);
    SORT_KEYS(out.begin(), out.end());
    out.erase(std::unique(out.begin(), out.end()), out.end());
    return (int64_t)out.size();
}

// Per-candidate gapless diagonal mismatch counting (ops/kmer.py
// _verify_candidates): codes is the (2n, w) fwd+revcomp matrix, row_first
// is shifted by pos against row_second. Early-exits once the mismatch
// count provably exceeds ceil(error_rate * L) >= the final allowance.
static void diag_mismatch(const int8_t* codes, const int64_t* lens,
                          int64_t width, const int64_t* row_first,
                          const int64_t* row_second, const int64_t* pos,
                          int64_t n, double error_rate, int64_t* out_counted,
                          int64_t* out_mism) {
#pragma omp parallel for schedule(dynamic, 1024)
    for (int64_t t = 0; t < n; t++) {
        const int8_t* a = codes + row_first[t] * width;
        const int8_t* b = codes + row_second[t] * width;
        int64_t p0 = pos[t];
        int64_t la = lens[row_first[t]], lb = lens[row_second[t]];
        int64_t L = la - p0 < lb ? la - p0 : lb;
        if (L < 0) L = 0;
        int64_t max_allowed = (int64_t)ceil(error_rate * (double)L);
        int64_t counted = 0, mism = 0;
        for (int64_t i = 0; i < L; i++) {
            int8_t c1 = a[p0 + i], c2 = b[i];
            if (c1 >= 4 || c2 >= 4) continue;  // N / pad skipped
            counted++;
            if (c1 != c2 && ++mism > max_allowed) break;
        }
        out_counted[t] = counted;
        out_mism[t] = mism;
    }
}

}  // extern "C"

static PyObject* py_join_unique(PyObject*, PyObject* args) {
    PyObject *qs_o, *qp_o, *l_o, *c_o, *ts_o, *tp_o, *lens_o;
    long long nq, rev, min_ov;
    if (!PyArg_ParseTuple(args, "OOOOLOOLOL", &qs_o, &qp_o, &l_o, &c_o, &nq,
                          &ts_o, &tp_o, &rev, &lens_o, &min_ov))
        return nullptr;
    Py_buffer bufs[7];
    PyObject* objs[7] = {qs_o, qp_o, l_o, c_o, ts_o, tp_o, lens_o};
    for (int i = 0; i < 7; i++) {
        if (PyObject_GetBuffer(objs[i], &bufs[i], PyBUF_CONTIG_RO) < 0) {
            for (int j = 0; j < i; j++) PyBuffer_Release(&bufs[j]);
            return nullptr;
        }
    }
    std::vector<int64_t> out;
    int64_t n_out = 0;
    Py_BEGIN_ALLOW_THREADS
    n_out = join_unique((const int64_t*)bufs[0].buf,
                        (const int64_t*)bufs[1].buf,
                        (const int64_t*)bufs[2].buf,
                        (const int64_t*)bufs[3].buf, nq,
                        (const int64_t*)bufs[4].buf,
                        (const int64_t*)bufs[5].buf, rev,
                        (const int64_t*)bufs[6].buf, min_ov, out);
    Py_END_ALLOW_THREADS
    for (int i = 0; i < 7; i++) PyBuffer_Release(&bufs[i]);
    PyObject* keys_b = PyBytes_FromStringAndSize((const char*)out.data(),
                                                 n_out * sizeof(int64_t));
    return keys_b;
}

static PyObject* py_canonicalize_keys(PyObject*, PyObject* args) {
    PyObject *keys_o, *lens_o;
    long long n, drop_inc;
    if (!PyArg_ParseTuple(args, "OLOL", &keys_o, &n, &lens_o, &drop_inc))
        return nullptr;
    Py_buffer bufs[2];
    PyObject* objs[2] = {keys_o, lens_o};
    for (int i = 0; i < 2; i++) {
        if (PyObject_GetBuffer(objs[i], &bufs[i], PyBUF_CONTIG_RO) < 0) {
            for (int j = 0; j < i; j++) PyBuffer_Release(&bufs[j]);
            return nullptr;
        }
    }
    std::vector<int64_t> out;
    int64_t n_out = 0;
    Py_BEGIN_ALLOW_THREADS
    n_out = canonicalize_keys((const int64_t*)bufs[0].buf, n,
                              (const int64_t*)bufs[1].buf, drop_inc, out);
    Py_END_ALLOW_THREADS
    for (int i = 0; i < 2; i++) PyBuffer_Release(&bufs[i]);
    return PyBytes_FromStringAndSize((const char*)out.data(),
                                     n_out * sizeof(int64_t));
}

static PyObject* py_diag_mismatch(PyObject*, PyObject* args) {
    PyObject *codes_o, *lens_o, *rf_o, *rs_o, *pos_o;
    long long width, n;
    double error_rate;
    if (!PyArg_ParseTuple(args, "OOLOOOLd", &codes_o, &lens_o, &width, &rf_o,
                          &rs_o, &pos_o, &n, &error_rate))
        return nullptr;
    Py_buffer bufs[5];
    PyObject* objs[5] = {codes_o, lens_o, rf_o, rs_o, pos_o};
    for (int i = 0; i < 5; i++) {
        if (PyObject_GetBuffer(objs[i], &bufs[i], PyBUF_CONTIG_RO) < 0) {
            for (int j = 0; j < i; j++) PyBuffer_Release(&bufs[j]);
            return nullptr;
        }
    }
    PyObject* counted_b =
        PyBytes_FromStringAndSize(nullptr, n * sizeof(int64_t));
    PyObject* mism_b = PyBytes_FromStringAndSize(nullptr, n * sizeof(int64_t));
    if (!counted_b || !mism_b) {
        for (int i = 0; i < 5; i++) PyBuffer_Release(&bufs[i]);
        Py_XDECREF(counted_b);
        Py_XDECREF(mism_b);
        return nullptr;  // exception already set by the failed allocation
    }
    Py_BEGIN_ALLOW_THREADS
    diag_mismatch((const int8_t*)bufs[0].buf, (const int64_t*)bufs[1].buf,
                  width, (const int64_t*)bufs[2].buf,
                  (const int64_t*)bufs[3].buf, (const int64_t*)bufs[4].buf, n,
                  error_rate, (int64_t*)PyBytes_AS_STRING(counted_b),
                  (int64_t*)PyBytes_AS_STRING(mism_b));
    Py_END_ALLOW_THREADS
    for (int i = 0; i < 5; i++) PyBuffer_Release(&bufs[i]);
    PyObject* result = PyTuple_Pack(2, counted_b, mism_b);
    Py_XDECREF(counted_b);
    Py_XDECREF(mism_b);
    return result;
}

static PyMethodDef methods[] = {
    {"join_unique", py_join_unique, METH_VARARGS,
     "expand seed-hash groups into unique packed candidate keys"},
    {"canonicalize_keys", py_canonicalize_keys, METH_VARARGS,
     "map query-frame keys to the sorted unique idA<idB canonical set"},
    {"diag_mismatch", py_diag_mismatch, METH_VARARGS,
     "gapless diagonal mismatch counts with early reject"},
    {nullptr, nullptr, 0, nullptr},
};

static PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_kmerjoin",
    "OpenMP k-mer candidate join + diagonal verification", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

PyMODINIT_FUNC PyInit__kmerjoin(void) { return PyModule_Create(&module); }
