// Maximal clique enumeration: degeneracy-ordered Bron-Kerbosch with
// pivoting (Eppstein-Löffler-Strash, O(d·n·3^(d/3))).
//
// Native replacement for the reference's vendored quick-cliques binary
// (invoked via system() at src/ViralQuasispecies.cpp:397-410). Written
// from the published algorithm with a fully specified deterministic order
// matching haploconduct_tpu/graph/cliques.py::enumerate_cliques_py:
//   - degeneracy order: min-degree first, smallest id on ties
//   - pivot: max |P ∩ N(u)| over P then X ascending, first max wins
//   - branch vertices ascending
//
// Exposed as a CPython extension (no pybind11 in this environment):
//   enumerate_cliques(n, v1: int64[], v2: int64[]) -> (flat, offsets)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

namespace {

struct Graph {
    int64_t n;
    std::vector<int64_t> adj_off;   // CSR offsets (n+1)
    std::vector<int64_t> adj;       // sorted neighbor lists
};

Graph build_graph(int64_t n, const int64_t* v1, const int64_t* v2, int64_t m) {
    std::vector<std::pair<int64_t, int64_t>> edges;
    edges.reserve(2 * m);
    for (int64_t i = 0; i < m; i++) {
        if (v1[i] == v2[i]) continue;
        edges.emplace_back(v1[i], v2[i]);
        edges.emplace_back(v2[i], v1[i]);
    }
    std::sort(edges.begin(), edges.end());
    edges.erase(std::unique(edges.begin(), edges.end()), edges.end());
    Graph g;
    g.n = n;
    g.adj_off.assign(n + 1, 0);
    for (auto& e : edges) g.adj_off[e.first + 1]++;
    for (int64_t i = 0; i < n; i++) g.adj_off[i + 1] += g.adj_off[i];
    g.adj.reserve(edges.size());
    for (auto& e : edges) g.adj.push_back(e.second);
    return g;
}

std::vector<int64_t> degeneracy_order(const Graph& g) {
    int64_t n = g.n;
    std::vector<int64_t> deg(n), order;
    order.reserve(n);
    for (int64_t v = 0; v < n; v++) deg[v] = g.adj_off[v + 1] - g.adj_off[v];
    using Item = std::pair<int64_t, int64_t>;  // (degree, vertex)
    std::priority_queue<Item, std::vector<Item>, std::greater<Item>> heap;
    for (int64_t v = 0; v < n; v++) heap.push({deg[v], v});
    std::vector<char> removed(n, 0);
    while (!heap.empty()) {
        auto [d, v] = heap.top();
        heap.pop();
        if (removed[v] || d != deg[v]) continue;
        removed[v] = 1;
        order.push_back(v);
        for (int64_t k = g.adj_off[v]; k < g.adj_off[v + 1]; k++) {
            int64_t w = g.adj[k];
            if (!removed[w]) heap.push({--deg[w], w});
        }
    }
    return order;
}

struct BK {
    const Graph& g;
    std::vector<char> in_nbr;       // scratch membership bitmap
    std::vector<int64_t> r;
    std::vector<int64_t>& flat;
    std::vector<int64_t>& offsets;

    BK(const Graph& g_, std::vector<int64_t>& flat_, std::vector<int64_t>& offsets_)
        : g(g_), in_nbr(g_.n, 0), flat(flat_), offsets(offsets_) {}

    void mark(int64_t v, char val) {
        for (int64_t k = g.adj_off[v]; k < g.adj_off[v + 1]; k++) in_nbr[g.adj[k]] = val;
    }

    int64_t count_p_in_n(const std::vector<int64_t>& p, int64_t u) {
        // |P ∩ N(u)| via merged scan (p sorted, adj sorted)
        int64_t c = 0;
        const int64_t* nb = g.adj.data() + g.adj_off[u];
        const int64_t* nb_end = g.adj.data() + g.adj_off[u + 1];
        for (int64_t w : p) {
            while (nb != nb_end && *nb < w) nb++;
            if (nb == nb_end) break;
            if (*nb == w) c++;
        }
        return c;
    }

    void run(std::vector<int64_t>& p, std::vector<int64_t>& x) {
        // p and x are kept sorted ascending
        if (p.empty() && x.empty()) {
            flat.insert(flat.end(), r.begin(), r.end());
            offsets.push_back((int64_t)flat.size());
            return;
        }
        int64_t pivot = -1, best = -1;
        for (int64_t u : p) {
            int64_t c = count_p_in_n(p, u);
            if (c > best) { best = c; pivot = u; }
        }
        for (int64_t u : x) {
            int64_t c = count_p_in_n(p, u);
            if (c > best) { best = c; pivot = u; }
        }
        mark(pivot, 1);
        std::vector<int64_t> branch;
        for (int64_t v : p)
            if (!in_nbr[v]) branch.push_back(v);
        mark(pivot, 0);
        for (int64_t v : branch) {
            mark(v, 1);
            std::vector<int64_t> p2, x2;
            for (int64_t w : p) if (in_nbr[w]) p2.push_back(w);
            for (int64_t w : x) if (in_nbr[w]) x2.push_back(w);
            mark(v, 0);
            r.push_back(v);
            run(p2, x2);
            r.pop_back();
            // move v from P to X
            p.erase(std::lower_bound(p.begin(), p.end(), v));
            x.insert(std::lower_bound(x.begin(), x.end(), v), v);
        }
    }
};

void enumerate_all(int64_t n, const int64_t* v1, const int64_t* v2, int64_t m,
                   std::vector<int64_t>& flat, std::vector<int64_t>& offsets) {
    Graph g = build_graph(n, v1, v2, m);
    std::vector<int64_t> order = degeneracy_order(g);
    std::vector<int64_t> rank(n);
    for (int64_t i = 0; i < n; i++) rank[order[i]] = i;
    offsets.push_back(0);
    BK bk(g, flat, offsets);
    for (int64_t v : order) {
        std::vector<int64_t> p, x;
        for (int64_t k = g.adj_off[v]; k < g.adj_off[v + 1]; k++) {
            int64_t w = g.adj[k];
            if (rank[w] > rank[v]) p.push_back(w);
            else x.push_back(w);
        }
        std::sort(p.begin(), p.end());
        std::sort(x.begin(), x.end());
        bk.r.assign(1, v);
        bk.run(p, x);
    }
}

PyObject* py_enumerate_cliques(PyObject*, PyObject* args) {
    PyObject *v1_obj, *v2_obj;
    long long n;
    if (!PyArg_ParseTuple(args, "LOO", &n, &v1_obj, &v2_obj)) return nullptr;

    Py_buffer b1, b2;
    if (PyObject_GetBuffer(v1_obj, &b1, PyBUF_CONTIG_RO) < 0) return nullptr;
    if (PyObject_GetBuffer(v2_obj, &b2, PyBUF_CONTIG_RO) < 0) {
        PyBuffer_Release(&b1);
        return nullptr;
    }
    int64_t m = (int64_t)(b1.len / sizeof(int64_t));
    if (b2.len != b1.len) {
        PyBuffer_Release(&b1);
        PyBuffer_Release(&b2);
        PyErr_SetString(PyExc_ValueError, "v1/v2 length mismatch");
        return nullptr;
    }
    std::vector<int64_t> flat, offsets;
    Py_BEGIN_ALLOW_THREADS
    enumerate_all((int64_t)n, (const int64_t*)b1.buf, (const int64_t*)b2.buf, m,
                  flat, offsets);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&b1);
    PyBuffer_Release(&b2);

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
    {"enumerate_cliques_raw", py_enumerate_cliques, METH_VARARGS,
     "enumerate_cliques_raw(n, v1_int64_buf, v2_int64_buf) -> (flat_bytes, offsets_bytes)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_cliques", "degeneracy Bron-Kerbosch clique enumeration",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__cliques(void) { return PyModule_Create(&module); }
