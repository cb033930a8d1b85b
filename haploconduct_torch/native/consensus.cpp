// Native consensus kernel for SuperreadBuilder.batch_consensus (pass 2 +
// per-position base call). Replaces the numpy scatter formulation — four
// np.bincount passes plus ~8 flat float64 temporaries over every member
// window character — with ONE pass per character and one pass per output
// position, OpenMP-parallel over cliques (reference: the per-clique OpenMP
// loop in SRBuilder.cpp:972-1012; the Bayesian call math is
// SRBuilder.cpp:297-533).
//
// Bit-exactness contract (asserted by tests/test_assemble.py): each job owns
// a disjoint output range, so parallelizing over jobs preserves the
// per-bin accumulation order of the sequential numpy bincount (members in
// job order, positions ascending, characters left to right). Per-position
// math mirrors the numpy expressions operation for operation:
//   probs = 10**scores; total = ((0+p0)+p1)+p2)+p3 (numpy pairwise sum,
//   sequential for n<8); p_correct = max_prob / max(total, 1e-320);
//   phred = floor(-10*log10(max(1-p_correct, 1e-320)) + 0.5).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cmath>
#include <cstdint>
#include <cstdlib>

extern "C" {

// seq/qual: concatenated member windows' source arrays (int8 codes 0..3
//   bases / 4 N, uint8 phred).
// src0/dst0/wlen: per member — first source index, first output position,
//   window length (0 for members of non-live jobs).
// job_start: member-index boundaries per job (nj+1 entries).
// lmatch/lmis: 94-entry phred -> log10 likelihood LUTs (built by the
//   caller with the exact doubles of the numpy path).
// Outputs: codes/quals per output position, counts (member coverage incl.
//   N characters, for the caller's min-coverage abort).
static int consensus_scatter(
    const int8_t* seq, const uint8_t* qual, const int64_t* src0,
    const int64_t* dst0, const int64_t* wlen, const int64_t* job_start,
    int64_t nj, int64_t W, const double* lmatch, const double* lmis,
    double min_qual, int8_t n_code, uint8_t n_qual, int8_t* out_codes,
    uint8_t* out_quals, int64_t* out_counts) {
    double* scores = (double*)malloc((size_t)W * 4 * sizeof(double));
    if (W > 0 && scores == nullptr) return -1;

#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < W; i++) {
        scores[i * 4] = scores[i * 4 + 1] = 0.0;
        scores[i * 4 + 2] = scores[i * 4 + 3] = 0.0;
        out_counts[i] = 0;
    }

#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t j = 0; j < nj; j++) {
        for (int64_t m = job_start[j]; m < job_start[j + 1]; m++) {
            const int8_t* s = seq + src0[m];
            const uint8_t* q = qual + src0[m];
            double* out = scores + dst0[m] * 4;
            int64_t* cnt = out_counts + dst0[m];
            for (int64_t k = 0; k < wlen[m]; k++) {
                int8_t w = s[k];
                cnt[k] += 1;
                if (w >= 4) continue;  // N: zero contribution to every base
                int qv = q[k] < 93 ? q[k] : 93;
                double lm = lmatch[qv], lx = lmis[qv];
                double* sc = out + k * 4;
                sc[0] += w == 0 ? lm : lx;
                sc[1] += w == 1 ? lm : lx;
                sc[2] += w == 2 ? lm : lx;
                sc[3] += w == 3 ? lm : lx;
            }
        }
    }

    const double TEN_M93 = pow(10.0, -9.3);
    // tie-break priority A, T, C, G in code space (consensus_pos:390-393)
    const int prio[4] = {0, 3, 1, 2};
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < W; i++) {
        const double* sc = scores + i * 4;
        double max_score = sc[0];
        int call = 0;
        for (int t = 1; t < 4; t++) {
            double v = sc[prio[t]];
            if (v > max_score) {
                max_score = v;
                call = prio[t];
            }
        }
        double total = 0.0;
        for (int b = 0; b < 4; b++) total += pow(10.0, sc[b]);
        double max_prob = pow(10.0, max_score);
        double denom = total > 1e-320 ? total : 1e-320;
        double p_correct = total > 0.0 ? max_prob / denom : 0.0;
        double p_inc = 1.0 - p_correct;
        bool n_mask = (max_score == 0.0) || (total == 0.0) ||
                      (out_counts[i] > 1 && p_correct < min_qual);
        double ph =
            floor(-10.0 * log10(p_inc > 1e-320 ? p_inc : 1e-320) + 0.5);
        if (p_inc < TEN_M93) ph = 93.0;
        if (ph < 0.0) ph = 0.0;
        if (ph > 93.0) ph = 93.0;
        out_codes[i] = n_mask ? n_code : (int8_t)call;
        out_quals[i] = n_mask ? n_qual : (uint8_t)ph;
    }

    free(scores);
    return 0;
}

}  // extern "C"

static PyObject* py_consensus_scatter(PyObject*, PyObject* args) {
    PyObject *seq_o, *qual_o, *src_o, *dst_o, *wlen_o, *js_o, *lm_o, *lx_o;
    long long nj, W, n_code, n_qual;
    double min_qual;
    if (!PyArg_ParseTuple(args, "OOOOOOLLOOdLL", &seq_o, &qual_o, &src_o,
                          &dst_o, &wlen_o, &js_o, &nj, &W, &lm_o, &lx_o,
                          &min_qual, &n_code, &n_qual))
        return nullptr;
    Py_buffer bufs[8];
    PyObject* objs[8] = {seq_o, qual_o, src_o, dst_o, wlen_o, js_o, lm_o, lx_o};
    for (int i = 0; i < 8; i++) {
        if (PyObject_GetBuffer(objs[i], &bufs[i], PyBUF_CONTIG_RO) < 0) {
            for (int j = 0; j < i; j++) PyBuffer_Release(&bufs[j]);
            return nullptr;
        }
    }
    PyObject* codes_b = PyBytes_FromStringAndSize(nullptr, W * sizeof(int8_t));
    PyObject* quals_b = PyBytes_FromStringAndSize(nullptr, W * sizeof(uint8_t));
    PyObject* counts_b =
        PyBytes_FromStringAndSize(nullptr, W * sizeof(int64_t));
    if (!codes_b || !quals_b || !counts_b) {
        for (int i = 0; i < 8; i++) PyBuffer_Release(&bufs[i]);
        Py_XDECREF(codes_b);
        Py_XDECREF(quals_b);
        Py_XDECREF(counts_b);
        return nullptr;  // exception already set by the failed allocation
    }
    int rc = 0;
    Py_BEGIN_ALLOW_THREADS
    rc = consensus_scatter(
        (const int8_t*)bufs[0].buf, (const uint8_t*)bufs[1].buf,
        (const int64_t*)bufs[2].buf, (const int64_t*)bufs[3].buf,
        (const int64_t*)bufs[4].buf, (const int64_t*)bufs[5].buf, nj, W,
        (const double*)bufs[6].buf, (const double*)bufs[7].buf, min_qual,
        (int8_t)n_code, (uint8_t)n_qual, (int8_t*)PyBytes_AS_STRING(codes_b),
        (uint8_t*)PyBytes_AS_STRING(quals_b),
        (int64_t*)PyBytes_AS_STRING(counts_b));
    Py_END_ALLOW_THREADS
    for (int i = 0; i < 8; i++) PyBuffer_Release(&bufs[i]);
    if (rc != 0) {
        Py_XDECREF(codes_b);
        Py_XDECREF(quals_b);
        Py_XDECREF(counts_b);
        return PyErr_NoMemory();
    }
    PyObject* result = PyTuple_Pack(3, codes_b, quals_b, counts_b);
    Py_XDECREF(codes_b);
    Py_XDECREF(quals_b);
    Py_XDECREF(counts_b);
    return result;
}

static PyMethodDef methods[] = {
    {"consensus_scatter", py_consensus_scatter, METH_VARARGS,
     "OpenMP clique-consensus scatter + Bayesian base call"},
    {nullptr, nullptr, 0, nullptr},
};

static PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_consensus",
    "OpenMP consensus kernel for SuperreadBuilder", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

PyMODINIT_FUNC PyInit__consensus(void) { return PyModule_Create(&module); }
