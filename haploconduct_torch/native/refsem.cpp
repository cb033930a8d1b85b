// Reference-semantics helpers for bit-identical parity with the
// HaploConduct reference binaries.
//
// Two concerns live here:
//
// 1. umap_order: the iteration order of a libstdc++ std::unordered_map
//    given its (first-appearance) key insertion sequence. The reference
//    C++ iterates unordered_maps in several output-determining places
//    (FindNextOverlaps3.cpp:29-134 pair selection, SRBuilder.cpp:751-867
//    originals construction, subreads.txt writing). Rather than
//    reverse-engineering the hashtable (prime bucket growth, per-bucket
//    chain splicing), we REPLAY the insertions through a real
//    std::unordered_map compiled with the same libstdc++ — faithful by
//    construction. Copies preserve iteration order (verified empirically),
//    so one replay per insertion sequence covers the reference's
//    by-value map passing.
//
// 2. enumerate_cliques_ref: degeneracy-ordered Bron-Kerbosch whose clique
//    EMISSION ORDER matches quick-cliques' qc --algorithm=degeneracy
//    exactly (quick-cliques/src/DegeneracyAlgorithm.cpp:107-528,
//    DegeneracyTools.cpp:321-428). Clique order feeds SRBuilder's
//    used_nodes / remove_multi_occ filters, so order parity is required
//    for bit-identical contigs. The order is determined by:
//      - adjacency built by appending per input edge line (graph.txt order);
//      - degeneracy removal with FRONT-insertion degree buckets (LIFO),
//        scanning degrees from 0 upward, reset after each removal;
//      - the top-level vertex loop running in VERTEX-ID order (the
//        reference's orderingArray is indexed by vertex id);
//      - P filled by swapping later-neighbors downward (reversing their
//        order), candidates = P-segment copy with swap-from-tail removal
//        of pivot neighbors, pivot = first maximum of |P ∩ N(u)| scanning
//        the X-then-P array segment.
//    All array-position mechanics below reproduce that dance; they are a
//    re-implementation against the observed semantics, not a transcription.
//
// Exposed via the CPython C API (no pybind11 in this environment).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// ------------------------------------------------------------------ oracle

// Replay first-appearance insertions of `keys` into a std::unordered_map
// (read_id_t/node_id_t are `unsigned long`, src/Types.h:93-94) and return
// the keys in iteration order.
std::vector<uint64_t> umap_iteration_order(const uint64_t* keys, int64_t m) {
    // default-constructed: bucket_count starts at 1 and follows the prime
    // growth policy, exactly as the reference's maps (reserve() would
    // change the bucket-count trajectory and therefore the order)
    std::unordered_map<unsigned long, unsigned long> map;
    for (int64_t i = 0; i < m; i++) map.emplace((unsigned long)keys[i], 0UL);
    std::vector<uint64_t> out;
    out.reserve(map.size());
    for (auto& kv : map) out.push_back((uint64_t)kv.first);
    return out;
}

// --------------------------------------------- reference-order degeneracy BK

struct RefOrderState {
    int64_t n;
    // per-vertex later/earlier neighbor arrays in degeneracy order
    std::vector<std::vector<int>> later, earlier;
    // the X|P|R position array and its inverse
    std::vector<int> sets, where;
    // neighbors-in-P arrays: in-P entries kept compacted at the front
    std::vector<std::vector<int>> nbrP;
    std::vector<int> numNbr;
    std::vector<int> clique;                 // R, in push order
    std::vector<int64_t>* flat;
    std::vector<int64_t>* offsets;

    void emit() {
        flat->insert(flat->end(), clique.begin(), clique.end());
        offsets->push_back((int64_t)flat->size());
    }

    void swap_into(int pos, int v) {
        int old = where[v];
        sets[old] = sets[pos];
        where[sets[pos]] = old;
        sets[pos] = v;
        where[v] = pos;
    }

    // pivot selection + candidate list (findBestPivotNonNeighborsDegeneracy)
    void candidates(int bX, int bP, int bR, std::vector<int>& cand) {
        int pivot = -1, best = -1;
        for (int j = bX; j < bR; j++) {
            int u = sets[j];
            int lim = std::min(bR - bP, numNbr[u]);
            int c = 0;
            for (int k = 0; k < lim; k++) {
                int loc = where[nbrP[u][k]];
                if (loc >= bP && loc < bR) c++;
                else break;  // in-P entries lead; stop at the first stale one
            }
            if (c > best) { best = c; pivot = u; }
        }
        cand.assign(sets.begin() + bP, sets.begin() + bR);
        int num = bR - bP;
        int lim = std::min(num, numNbr[pivot]);
        for (int k = 0; k < lim; k++) {
            int loc = where[nbrP[pivot][k]];
            if (loc >= bP && loc < bR) cand[loc - bP] = -1;
            else break;
        }
        // swap-from-tail compaction: scrambles order exactly as the reference
        int j = 0;
        while (j < num) {
            if (cand[j] == -1) { num--; cand[j] = cand[num]; continue; }
            j++;
        }
        cand.resize(num);
    }

    // moveToRDegeneracy
    void move_to_r(int v, int& bX, int& bP, int& bR,
                   int& nX, int& nP, int& nR) {
        swap_into(--bR, v);
        nX = nP = nR = bP;
        int sizeP = bR - bP;
        // X members adjacent to v move to the new X region
        for (int j = bX; j < nX; ) {
            int u = sets[j];
            int lim = std::min(sizeP, numNbr[u]);
            bool moved = false;
            for (int k = 0; k < lim; k++) {
                if (nbrP[u][k] == v) { swap_into(--nX, u); moved = true; }
            }
            if (!moved) j++;
        }
        // P members adjacent to v move to the front of the new P region
        for (int j = bP; j < bR; j++) {
            int u = sets[j];
            int lim = std::min(sizeP, numNbr[u]);
            for (int k = 0; k < lim; k++) {
                if (nbrP[u][k] == v) swap_into(nR++, u);
            }
        }
        // compact each member's in-P neighbors to the array front
        for (int j = nX; j < nR; j++) {
            int u = sets[j];
            int lim = std::min(sizeP, numNbr[u]);
            int c = 0;
            for (int k = 0; k < lim; k++) {
                int w = nbrP[u][k];
                int loc = where[w];
                if (loc >= nP && loc < nR) {
                    nbrP[u][k] = nbrP[u][c];
                    nbrP[u][c] = w;
                    c++;
                }
            }
        }
    }

    void recurse(int bX, int bP, int bR) {
        if (bX >= bP && bP >= bR) { emit(); return; }
        if (bP >= bR) return;
        std::vector<int> cand;
        candidates(bX, bP, bR, cand);
        for (int v : cand) {
            clique.push_back(v);
            int nX, nP, nR;
            move_to_r(v, bX, bP, bR, nX, nP, nR);
            recurse(nX, nP, nR);
            clique.pop_back();
            // move v from R to X (moveFromRToXDegeneracy)
            swap_into(bP, v);
            bP++; bR++;
        }
        // return the branched vertices from X to P for the caller
        for (int v : cand) swap_into(--bP, v);
    }
};

// degeneracy order with the reference's front-insertion degree buckets
// (DegeneracyTools.cpp:321-398): intrusive doubly-linked bucket lists so
// erase-by-vertex and push_front are O(1) with identical ordering.
void degeneracy_arrays(int64_t n, const std::vector<std::vector<int>>& adj,
                       std::vector<std::vector<int>>& later,
                       std::vector<std::vector<int>>& earlier) {
    std::vector<int> deg(n), head(n + 1, -1), nxt(n, -1), prv(n, -1);
    auto push_front = [&](int d, int v) {
        nxt[v] = head[d];
        prv[v] = -1;
        if (head[d] >= 0) prv[head[d]] = v;
        head[d] = v;
    };
    auto erase = [&](int d, int v) {
        if (prv[v] >= 0) nxt[prv[v]] = nxt[v];
        else head[d] = nxt[v];
        if (nxt[v] >= 0) prv[nxt[v]] = prv[v];
    };
    for (int64_t v = 0; v < n; v++) deg[v] = (int)adj[v].size();
    for (int64_t v = 0; v < n; v++) push_front(deg[v], (int)v);
    later.assign(n, {});
    earlier.assign(n, {});
    std::vector<char> removed(n, 0);
    int cur = 0;
    for (int64_t removed_n = 0; removed_n < n; ) {
        if (cur <= n && head[cur] >= 0) {
            int v = head[cur];
            erase(cur, v);
            removed[v] = 1;
            for (int w : adj[v]) {
                if (!removed[w]) {
                    erase(deg[w], w);
                    later[v].push_back(w);
                    if (--deg[w] >= 0) push_front(deg[w], w);
                } else {
                    earlier[v].push_back(w);
                }
            }
            removed_n++;
            cur = 0;
        } else {
            cur++;
        }
    }
}

void enumerate_ref(int64_t n, const int64_t* eu, const int64_t* ev, int64_t m,
                   std::vector<int64_t>& flat, std::vector<int64_t>& offsets) {
    // adjacency by append in input (graph.txt line) order
    std::vector<std::vector<int>> adj(n);
    for (int64_t i = 0; i < m; i++) adj[eu[i]].push_back((int)ev[i]);

    RefOrderState st;
    st.n = n;
    degeneracy_arrays(n, adj, st.later, st.earlier);
    st.sets.resize(n);
    st.where.resize(n);
    st.nbrP.assign(n, std::vector<int>(1, 0));
    st.numNbr.assign(n, 1);
    for (int64_t i = 0; i < n; i++) { st.sets[i] = (int)i; st.where[i] = (int)i; }
    st.flat = &flat;
    st.offsets = &offsets;
    offsets.push_back(0);

    int bX = 0, bP = 0, bR = (int)n;
    for (int v = 0; v < (int)n; v++) {
        st.clique.assign(1, v);
        // fillInPandXForRecursiveCallDegeneracy: move v to R, swap later
        // neighbors downward into P (reversing their order), earlier
        // neighbors below them into X, then rebuild neighbors-in-P
        st.swap_into(--bR, v);
        int nR = bR, nP = bR;
        for (int w : st.later[v]) st.swap_into(--nP, w);
        int nX = nP;
        for (int w : st.earlier[v]) {
            st.swap_into(--nX, w);
            auto& arr = st.nbrP[w];
            arr.assign(std::max(1, std::min(nR - nP, (int)st.later[w].size())), 0);
            st.numNbr[w] = 0;
            for (int lw : st.later[w]) {
                int loc = st.where[lw];
                if (loc >= nP && loc < nR) arr[st.numNbr[w]++] = lw;
            }
        }
        for (int j = nP; j < nR; j++) {
            int u = st.sets[j];
            st.numNbr[u] = 0;
            st.nbrP[u].assign(
                std::max(1, std::min(nR - nP,
                                     (int)(st.later[u].size() + st.earlier[u].size()))),
                0);
        }
        for (int j = nP; j < nR; j++) {
            int u = st.sets[j];
            for (int lw : st.later[u]) {
                int loc = st.where[lw];
                if (loc >= nP && loc < nR) {
                    st.nbrP[u][st.numNbr[u]++] = lw;
                    st.nbrP[lw][st.numNbr[lw]++] = u;
                }
            }
        }
        st.recurse(nX, nP, nR);
        bR++;
    }
}

// ------------------------------------------------------------ python glue

PyObject* py_umap_order(PyObject*, PyObject* args) {
    PyObject* keys_obj;
    if (!PyArg_ParseTuple(args, "O", &keys_obj)) return nullptr;
    Py_buffer b;
    if (PyObject_GetBuffer(keys_obj, &b, PyBUF_CONTIG_RO) < 0) return nullptr;
    int64_t m = (int64_t)(b.len / sizeof(uint64_t));
    std::vector<uint64_t> out;
    Py_BEGIN_ALLOW_THREADS
    out = umap_iteration_order((const uint64_t*)b.buf, m);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&b);
    return PyBytes_FromStringAndSize((const char*)out.data(),
                                     (Py_ssize_t)(out.size() * sizeof(uint64_t)));
}

PyObject* py_enumerate_ref(PyObject*, PyObject* args) {
    PyObject *u_obj, *v_obj;
    long long n;
    if (!PyArg_ParseTuple(args, "LOO", &n, &u_obj, &v_obj)) return nullptr;
    Py_buffer bu, bv;
    if (PyObject_GetBuffer(u_obj, &bu, PyBUF_CONTIG_RO) < 0) return nullptr;
    if (PyObject_GetBuffer(v_obj, &bv, PyBUF_CONTIG_RO) < 0) {
        PyBuffer_Release(&bu);
        return nullptr;
    }
    int64_t m = (int64_t)(bu.len / sizeof(int64_t));
    if (bv.len != bu.len) {
        PyBuffer_Release(&bu);
        PyBuffer_Release(&bv);
        PyErr_SetString(PyExc_ValueError, "edge array length mismatch");
        return nullptr;
    }
    std::vector<int64_t> flat, offsets;
    Py_BEGIN_ALLOW_THREADS
    enumerate_ref((int64_t)n, (const int64_t*)bu.buf, (const int64_t*)bv.buf, m,
                  flat, offsets);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&bu);
    PyBuffer_Release(&bv);
    PyObject* flat_bytes = PyBytes_FromStringAndSize(
        (const char*)flat.data(), (Py_ssize_t)(flat.size() * sizeof(int64_t)));
    PyObject* off_bytes = PyBytes_FromStringAndSize(
        (const char*)offsets.data(), (Py_ssize_t)(offsets.size() * sizeof(int64_t)));
    PyObject* result = PyTuple_Pack(2, flat_bytes, off_bytes);
    Py_XDECREF(flat_bytes);
    Py_XDECREF(off_bytes);
    return result;
}

PyMethodDef methods[] = {
    {"umap_order", py_umap_order, METH_VARARGS,
     "umap_order(keys_uint64_buf) -> bytes(uint64 iteration order)"},
    {"enumerate_cliques_ref_raw", py_enumerate_ref, METH_VARARGS,
     "enumerate_cliques_ref_raw(n, u_int64_buf, v_int64_buf) -> (flat, offsets)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_refsem",
    "reference-semantics order helpers (libstdc++ map order, qc clique order)",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__refsem(void) { return PyModule_Create(&module); }
