// Native BFS orientation labelling (vertexLabellingHeuristic pass kernel).
//
// The reference labels vertices by BFS over the merged in+out adjacency,
// visiting each node's neighbours in a std::random_shuffle order seeded by
// a fresh srand(seed) per node (src/GraphAlgos.cpp:250-349). The Python
// driver (graph/algos.py _LabelCtx.bfs) walks a deque with per-node list
// conversions — 13-21s per 44k-read envelope patch. This kernel runs the
// identical traversal natively: the caller supplies the glibc rand()
// stream for the seed (GlibcRand — bit-exact, shared across all nodes
// exactly like ShufflePerms), and the libstdc++ random_shuffle permutation
// for degree k is rebuilt per node pop from that stream:
//   p = identity(k); for i in 1..k-1: swap(p[i], p[rands[i-1] % (i+1)])
// which is byte-for-byte ShufflePerms.perm(k).
//
// orientations/visited/comp are written in place; `ci` counts EVERY start
// (including already-visited ones that are skipped), matching the Python
// enumerate(starts).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <vector>

extern "C" {

static void bfs_label(const int64_t* start_ptr, const int64_t* merged_nb,
                      const uint8_t* merged_sm, const int64_t* rands,
                      const int64_t* starts, int64_t n_starts,
                      uint8_t* orientations, uint8_t* visited, int64_t* comp,
                      int use_comp, int64_t n, int64_t maxdeg) {
    std::vector<int64_t> queue;
    queue.reserve(n);
    std::vector<int64_t> perm(maxdeg > 0 ? maxdeg : 1);
    for (int64_t ci = 0; ci < n_starts; ci++) {
        const int64_t root = starts[ci];
        if (visited[root]) continue;
        visited[root] = 1;
        if (use_comp) comp[root] = ci;
        queue.clear();
        queue.push_back(root);
        size_t head = 0;
        while (head < queue.size()) {
            const int64_t node = queue[head++];
            const int64_t s0 = start_ptr[node];
            const int64_t k = start_ptr[node + 1] - s0;
            if (k == 0) continue;
            int64_t* p = perm.data();
            for (int64_t i = 0; i < k; i++) p[i] = i;
            for (int64_t i = 1; i < k; i++) {
                const int64_t j = rands[i - 1] % (i + 1);
                const int64_t t = p[i];
                p[i] = p[j];
                p[j] = t;
            }
            const uint8_t o_node = orientations[node];
            for (int64_t i = 0; i < k; i++) {
                const int64_t idx = s0 + p[i];
                const int64_t nb = merged_nb[idx];
                if (!visited[nb]) {
                    visited[nb] = 1;
                    orientations[nb] = (o_node == merged_sm[idx]) ? 1 : 0;
                    if (use_comp) comp[nb] = ci;
                    queue.push_back(nb);
                }
            }
        }
    }
}

static PyObject* py_bfs_label(PyObject*, PyObject* args) {
    PyObject *sp_o, *nb_o, *sm_o, *rands_o, *starts_o, *ori_o, *vis_o,
        *comp_o;
    int use_comp;
    long long n, maxdeg;
    if (!PyArg_ParseTuple(args, "OOOOOOOOiLL", &sp_o, &nb_o, &sm_o, &rands_o,
                          &starts_o, &ori_o, &vis_o, &comp_o, &use_comp, &n,
                          &maxdeg))
        return nullptr;
    Py_buffer ro[5];
    PyObject* ro_objs[5] = {sp_o, nb_o, sm_o, rands_o, starts_o};
    for (int i = 0; i < 5; i++) {
        if (PyObject_GetBuffer(ro_objs[i], &ro[i], PyBUF_CONTIG_RO) < 0) {
            for (int j = 0; j < i; j++) PyBuffer_Release(&ro[j]);
            return nullptr;
        }
    }
    Py_buffer rw[3];
    PyObject* rw_objs[3] = {ori_o, vis_o, comp_o};
    for (int i = 0; i < 3; i++) {
        if (PyObject_GetBuffer(rw_objs[i], &rw[i], PyBUF_CONTIG) < 0) {
            for (int j = 0; j < 5; j++) PyBuffer_Release(&ro[j]);
            for (int j = 0; j < i; j++) PyBuffer_Release(&rw[j]);
            return nullptr;
        }
    }
    const int64_t n_starts = ro[4].len / (int64_t)sizeof(int64_t);
    Py_BEGIN_ALLOW_THREADS
    bfs_label((const int64_t*)ro[0].buf, (const int64_t*)ro[1].buf,
              (const uint8_t*)ro[2].buf, (const int64_t*)ro[3].buf,
              (const int64_t*)ro[4].buf, n_starts, (uint8_t*)rw[0].buf,
              (uint8_t*)rw[1].buf, (int64_t*)rw[2].buf, use_comp, n, maxdeg);
    Py_END_ALLOW_THREADS
    for (int i = 0; i < 5; i++) PyBuffer_Release(&ro[i]);
    for (int i = 0; i < 3; i++) PyBuffer_Release(&rw[i]);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"bfs_label", py_bfs_label, METH_VARARGS,
     "seeded-shuffle BFS orientation labelling over merged CSR adjacency"},
    {nullptr, nullptr, 0, nullptr}};

static PyModuleDef module = {PyModuleDef_HEAD_INIT, "_bfslabel",
                             "native BFS labelling (GraphAlgos.cpp:250-349)",
                             -1, methods};

PyMODINIT_FUNC PyInit__bfslabel(void) { return PyModule_Create(&module); }

}  // extern "C"
