// Native transitive-edge mask: edge (u, w) is transitive iff some 2-path
// u -> x -> w exists. The reference computes this by intersecting sorted
// adjacency lists per edge (src/GraphAlgos.cpp:746-776, driver 938-1123);
// the numpy path (graph/algos.py:find_transitive_mask) computes the full
// boolean A@A through scipy, which at envelope patch scale (4.8M edges)
// costs ~4.5s per call across 2-3 calls per iteration. Here each query
// edge intersects out(u) with in(w) with early exit on the first hit,
// OpenMP over the query edges — the same output bit for bit.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// out_* : CSR of the digraph's out-adjacency, target lists SORTED.
// in_*  : CSR of the in-adjacency, source lists SORTED.
// q1/q2 : query edges (u, w); mask[i] = 1 iff exists x with u->x and x->w.
static void transitive_mask(const int64_t* out_ptr, const int64_t* out_idx,
                            const int64_t* in_ptr, const int64_t* in_idx,
                            const int64_t* q1, const int64_t* q2, int64_t nq,
                            uint8_t* mask) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 4096)
#endif
    for (int64_t i = 0; i < nq; i++) {
        const int64_t u = q1[i];
        const int64_t w = q2[i];
        const int64_t* a = out_idx + out_ptr[u];
        const int64_t* ae = out_idx + out_ptr[u + 1];
        const int64_t* b = in_idx + in_ptr[w];
        const int64_t* be = in_idx + in_ptr[w + 1];
        uint8_t hit = 0;
        // galloping when one list is much longer than the other
        if (ae - a > 16 * (be - b)) {
            for (const int64_t* p = b; p < be; p++) {
                if (std::binary_search(a, ae, *p)) { hit = 1; break; }
            }
        } else if (be - b > 16 * (ae - a)) {
            for (const int64_t* p = a; p < ae; p++) {
                if (std::binary_search(b, be, *p)) { hit = 1; break; }
            }
        } else {
            while (a < ae && b < be) {
                if (*a < *b) a++;
                else if (*b < *a) b++;
                else { hit = 1; break; }
            }
        }
        mask[i] = hit;
    }
}

static PyObject* py_transitive_mask(PyObject*, PyObject* args) {
    PyObject *op_o, *oi_o, *ip_o, *ii_o, *q1_o, *q2_o;
    long long nq;
    if (!PyArg_ParseTuple(args, "OOOOOOL", &op_o, &oi_o, &ip_o, &ii_o, &q1_o,
                          &q2_o, &nq))
        return nullptr;
    Py_buffer bufs[6];
    PyObject* objs[6] = {op_o, oi_o, ip_o, ii_o, q1_o, q2_o};
    for (int i = 0; i < 6; i++) {
        if (PyObject_GetBuffer(objs[i], &bufs[i], PyBUF_CONTIG_RO) < 0) {
            for (int j = 0; j < i; j++) PyBuffer_Release(&bufs[j]);
            return nullptr;
        }
    }
    PyObject* mask_b = PyBytes_FromStringAndSize(nullptr, nq);
    if (!mask_b) {
        for (int i = 0; i < 6; i++) PyBuffer_Release(&bufs[i]);
        return nullptr;  // exception set by the failed allocation
    }
    Py_BEGIN_ALLOW_THREADS
    transitive_mask((const int64_t*)bufs[0].buf, (const int64_t*)bufs[1].buf,
                    (const int64_t*)bufs[2].buf, (const int64_t*)bufs[3].buf,
                    (const int64_t*)bufs[4].buf, (const int64_t*)bufs[5].buf,
                    nq, (uint8_t*)PyBytes_AS_STRING(mask_b));
    Py_END_ALLOW_THREADS
    for (int i = 0; i < 6; i++) PyBuffer_Release(&bufs[i]);
    return mask_b;
}

static PyMethodDef methods[] = {
    {"transitive_mask", py_transitive_mask, METH_VARARGS,
     "per-edge 2-path existence via sorted CSR intersection"},
    {nullptr, nullptr, 0, nullptr}};

static PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_transitive",
    "native transitive-edge mask (sorted-adjacency intersection)", -1,
    methods};

PyMODINIT_FUNC PyInit__transitive(void) { return PyModule_Create(&module); }

}  // extern "C"
