// CPU baseline for the overlap-verification benchmark: the reference
// EdgeCalculator's per-position scoring math (src/EdgeCalculator.cpp:26-139
// — phred->prob via pow() per position, per-position probability, log
// accumulation, geometric-mean score) in a tight OpenMP parallel-for over
// tasks, mirroring the reference's chunk parallelism
// (src/EdgeCalculator.cpp:395-423). This is what bench.py's vs_baseline
// compares the TPU kernel against; it is deliberately *faster* than the
// real reference path (no string copies / vector push_backs), making the
// reported speedup conservative.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cmath>
#include <cstdint>

extern "C" {

// codes: (rows, W) int8 (0..3 bases, 4 N, 5 pad); quals: (rows, W) uint8
// lens: per-row int32; tasks: row_a/row_b/pos int32 arrays of length n
// out_score/out_mism: double arrays of length n
static void score_tasks(const int8_t* codes, const uint8_t* quals,
                        const int32_t* lens, int64_t width,
                        const int32_t* row_a, const int32_t* row_b,
                        const int32_t* pos, int64_t n, double mismatch_thresh,
                        double* out_score, double* out_mism) {
#pragma omp parallel for schedule(static)
    for (int64_t t = 0; t < n; t++) {
        const int8_t* a = codes + (int64_t)row_a[t] * width;
        const int8_t* b = codes + (int64_t)row_b[t] * width;
        const uint8_t* qa = quals + (int64_t)row_a[t] * width;
        const uint8_t* qb = quals + (int64_t)row_b[t] * width;
        int32_t la = lens[row_a[t]];
        int32_t lb = lens[row_b[t]];
        int32_t p0 = pos[t];
        out_score[t] = 0.0;
        out_mism[t] = 1.0;
        if (p0 >= la) continue;
        int32_t L = la - p0 < lb ? la - p0 : lb;
        double total = 0.0;
        int64_t counted = 0;
        int64_t mism = 0;
        bool rejected = false;
        for (int32_t i = 0; i < L; i++) {
            int8_t n1 = a[p0 + i];
            int8_t n2 = b[i];
            if (n1 >= 4 || n2 >= 4) continue;  // N or pad: skipped
            double p1 = pow(10.0, -qa[p0 + i] / 10.0);
            double p2 = pow(10.0, -qb[i] / 10.0);
            double p;
            if (n1 == n2) {
                p = (1 - p1) * (1 - p2) + (p1 * p2) / 3.0;
            } else {
                p = p1 * (1 - p2) / 3.0 + p2 * (1 - p1) / 3.0 + (2 / 9.0) * p1 * p2;
                mism++;
            }
            if (p < mismatch_thresh) {
                rejected = true;
                break;
            }
            total += log(p);
            counted++;
        }
        if (rejected || counted == 0) continue;
        out_mism[t] = (double)mism / (double)counted;
        out_score[t] = exp(total / (double)counted);
    }
}

// Production host backend (backend="native"): same task contract as
// score_tasks_numpy (ops/score.py) — full counted/mismatch/rejected
// bookkeeping with NO early break, degenerate handling, and probabilities
// gathered from caller-supplied 256x256 (q1,q2) float64 LUTs (built by
// _pair_luts with the identical elementwise expressions, so per-position
// values are bit-identical to the oracle; only the serial accumulation
// order differs from numpy's pairwise sum, which the caller's
// RECHECK_MARGIN f64 re-scoring absorbs so edge *decisions* stay exact).
static void score_tasks_exact(
    const int8_t* codes, const uint8_t* quals, const int32_t* lens,
    int64_t width, const int32_t* row_a, const int32_t* row_b,
    const int32_t* pos, int64_t n, double mismatch_thresh,
    int64_t min_read_len, const double* lut_match, const double* lut_mis,
    const double* lut_logm, const double* lut_logx, double* out_score,
    double* out_mism_rate, double* out_sumlog, int64_t* out_counted,
    int64_t* out_mism, uint8_t* out_rejected) {
#pragma omp parallel for schedule(static)
    for (int64_t t = 0; t < n; t++) {
        const int8_t* a = codes + (int64_t)row_a[t] * width;
        const int8_t* b = codes + (int64_t)row_b[t] * width;
        const uint8_t* qa = quals + (int64_t)row_a[t] * width;
        const uint8_t* qb = quals + (int64_t)row_b[t] * width;
        int32_t la = lens[row_a[t]];
        int32_t lb = lens[row_b[t]];
        int32_t p0 = pos[t];
        int32_t L = p0 < la ? (la - p0 < lb ? la - p0 : lb) : 0;
        double sum_log = 0.0;
        int64_t counted = 0, mism = 0;
        bool rejected = false;
        for (int32_t i = 0; i < L; i++) {
            int8_t n1 = a[p0 + i];
            int8_t n2 = b[i];
            if (n1 >= 4 || n2 >= 4) continue;  // N or pad: skipped
            int idx = ((int)qa[p0 + i] << 8) | qb[i];
            if (n1 == n2) {
                if (lut_match[idx] < mismatch_thresh) rejected = true;
                sum_log += lut_logm[idx];
            } else {
                if (lut_mis[idx] < mismatch_thresh) rejected = true;
                sum_log += lut_logx[idx];
                mism++;
            }
            counted++;
        }
        bool degenerate = p0 >= la || la < min_read_len || lb < min_read_len ||
                          counted == 0;
        bool ok = !degenerate && !rejected;
        int64_t c1 = counted > 0 ? counted : 1;
        out_score[t] = ok ? exp(sum_log / (double)c1) : 0.0;
        out_mism_rate[t] = ok ? (double)mism / (double)c1 : 1.0;
        out_sumlog[t] = sum_log;
        out_counted[t] = counted;
        out_mism[t] = mism;
        out_rejected[t] = rejected ? 1 : 0;
    }
}

}  // extern "C"

static PyObject* py_score_tasks(PyObject*, PyObject* args) {
    PyObject *codes_o, *quals_o, *lens_o, *ra_o, *rb_o, *pos_o;
    long long width, n;
    double thresh;
    if (!PyArg_ParseTuple(args, "OOOLOOOLd", &codes_o, &quals_o, &lens_o, &width,
                          &ra_o, &rb_o, &pos_o, &n, &thresh))
        return nullptr;
    Py_buffer codes, quals, lens, ra, rb, pos;
    if (PyObject_GetBuffer(codes_o, &codes, PyBUF_CONTIG_RO) < 0) return nullptr;
    if (PyObject_GetBuffer(quals_o, &quals, PyBUF_CONTIG_RO) < 0) return nullptr;
    if (PyObject_GetBuffer(lens_o, &lens, PyBUF_CONTIG_RO) < 0) return nullptr;
    if (PyObject_GetBuffer(ra_o, &ra, PyBUF_CONTIG_RO) < 0) return nullptr;
    if (PyObject_GetBuffer(rb_o, &rb, PyBUF_CONTIG_RO) < 0) return nullptr;
    if (PyObject_GetBuffer(pos_o, &pos, PyBUF_CONTIG_RO) < 0) return nullptr;

    PyObject* score_bytes = PyBytes_FromStringAndSize(nullptr, n * sizeof(double));
    PyObject* mism_bytes = PyBytes_FromStringAndSize(nullptr, n * sizeof(double));
    Py_BEGIN_ALLOW_THREADS
    score_tasks((const int8_t*)codes.buf, (const uint8_t*)quals.buf,
                (const int32_t*)lens.buf, width, (const int32_t*)ra.buf,
                (const int32_t*)rb.buf, (const int32_t*)pos.buf, n, thresh,
                (double*)PyBytes_AS_STRING(score_bytes),
                (double*)PyBytes_AS_STRING(mism_bytes));
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&codes);
    PyBuffer_Release(&quals);
    PyBuffer_Release(&lens);
    PyBuffer_Release(&ra);
    PyBuffer_Release(&rb);
    PyBuffer_Release(&pos);
    PyObject* result = PyTuple_Pack(2, score_bytes, mism_bytes);
    Py_XDECREF(score_bytes);
    Py_XDECREF(mism_bytes);
    return result;
}

static PyObject* py_score_tasks_exact(PyObject*, PyObject* args) {
    PyObject *codes_o, *quals_o, *lens_o, *ra_o, *rb_o, *pos_o;
    PyObject *lm_o, *lx_o, *llm_o, *llx_o;
    long long width, n, min_read_len;
    double thresh;
    if (!PyArg_ParseTuple(args, "OOOLOOOLdLOOOO", &codes_o, &quals_o, &lens_o,
                          &width, &ra_o, &rb_o, &pos_o, &n, &thresh,
                          &min_read_len, &lm_o, &lx_o, &llm_o, &llx_o))
        return nullptr;
    Py_buffer bufs[10];
    PyObject* objs[10] = {codes_o, quals_o, lens_o, ra_o, rb_o,
                          pos_o,   lm_o,    lx_o,   llm_o, llx_o};
    for (int i = 0; i < 10; i++) {
        if (PyObject_GetBuffer(objs[i], &bufs[i], PyBUF_CONTIG_RO) < 0) {
            for (int j = 0; j < i; j++) PyBuffer_Release(&bufs[j]);
            return nullptr;
        }
    }
    PyObject* score_b = PyBytes_FromStringAndSize(nullptr, n * sizeof(double));
    PyObject* mrate_b = PyBytes_FromStringAndSize(nullptr, n * sizeof(double));
    PyObject* sumlog_b = PyBytes_FromStringAndSize(nullptr, n * sizeof(double));
    PyObject* counted_b = PyBytes_FromStringAndSize(nullptr, n * sizeof(int64_t));
    PyObject* mism_b = PyBytes_FromStringAndSize(nullptr, n * sizeof(int64_t));
    PyObject* rej_b = PyBytes_FromStringAndSize(nullptr, n * sizeof(uint8_t));
    Py_BEGIN_ALLOW_THREADS
    score_tasks_exact(
        (const int8_t*)bufs[0].buf, (const uint8_t*)bufs[1].buf,
        (const int32_t*)bufs[2].buf, width, (const int32_t*)bufs[3].buf,
        (const int32_t*)bufs[4].buf, (const int32_t*)bufs[5].buf, n, thresh,
        min_read_len, (const double*)bufs[6].buf, (const double*)bufs[7].buf,
        (const double*)bufs[8].buf, (const double*)bufs[9].buf,
        (double*)PyBytes_AS_STRING(score_b),
        (double*)PyBytes_AS_STRING(mrate_b),
        (double*)PyBytes_AS_STRING(sumlog_b),
        (int64_t*)PyBytes_AS_STRING(counted_b),
        (int64_t*)PyBytes_AS_STRING(mism_b),
        (uint8_t*)PyBytes_AS_STRING(rej_b));
    Py_END_ALLOW_THREADS
    for (int i = 0; i < 10; i++) PyBuffer_Release(&bufs[i]);
    PyObject* result = PyTuple_Pack(6, score_b, mrate_b, sumlog_b, counted_b,
                                    mism_b, rej_b);
    Py_XDECREF(score_b);
    Py_XDECREF(mrate_b);
    Py_XDECREF(sumlog_b);
    Py_XDECREF(counted_b);
    Py_XDECREF(mism_b);
    Py_XDECREF(rej_b);
    return result;
}

static PyMethodDef methods[] = {
    {"score_tasks", py_score_tasks, METH_VARARGS, "baseline OpenMP task scoring"},
    {"score_tasks_exact", py_score_tasks_exact, METH_VARARGS,
     "full-contract OpenMP task scoring from (q1,q2) LUTs"},
    {nullptr, nullptr, 0, nullptr},
};

static PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_baseline_score",
    "OpenMP CPU baseline of the overlap-verification kernel", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

PyMODINIT_FUNC PyInit__baseline_score(void) { return PyModule_Create(&module); }
