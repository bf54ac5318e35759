// Host-side native kernels for irotavg_tpu (C API, loaded via ctypes).
//
// The reference implements its whole host runtime in C++; the pieces that
// stay host-side in this build and are hot enough to matter are
// implemented here:
//
//  * vocab_parse    — DBoW2 text-vocabulary reader.  The ORB-SLAM
//    vocabulary is a ~145 MB / ~1M-line text file
//    (TemplatedVocabulary::loadFromTextFile,
//    third_party/DBoW2/DBoW2/TemplatedVocabulary.h:1337-1424); a
//    line-by-line Python parse takes minutes, this takes ~1 s.
//  * spanning_tree_init — the solver's rotation initialiser
//    (semantics of init_mst, ral/l1_irls.cpp:915-979): repeated sweeps
//    over the edge list propagating quaternions from node 0, preserving
//    the first f rows.  Sweep order is part of the contract (it selects
//    which tree edges initialise each node).
//  * bow_l1_scores  — batched L1 BoW similarity s = 1 - 0.5*sum|v-w|
//    over sorted sparse vectors (ScoringObject.cpp:23-68), used by the
//    loop-closure cascade against many candidates at once.
//
// Build: see build.py (g++ -O3 -shared -fPIC).  Everything is plain C
// structs + malloc so ctypes can own the lifetime.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// DBoW2 text vocabulary parser
// ---------------------------------------------------------------------------

struct VocabData {
    int32_t k, L, scoring, weighting;
    int64_t n_nodes;        // excluding the implicit root
    int32_t *parent;        // [n_nodes]
    uint8_t *is_leaf;       // [n_nodes]
    uint8_t *desc;          // [n_nodes * 32] descriptor bytes
    double  *weight;        // [n_nodes]
};

static inline const char *skip_ws(const char *p, const char *end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
        ++p;
    return p;
}

static inline const char *read_long(const char *p, const char *end,
                                    long *out) {
    p = skip_ws(p, end);
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    long v = 0;
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    *out = neg ? -v : v;
    return p;
}

static inline const char *read_double(const char *p, const char *end,
                                      double *out) {
    p = skip_ws(p, end);
    char *q = nullptr;
    *out = strtod(p, &q);
    return q ? q : p;
}

VocabData *vocab_parse(const char *path) {
    FILE *f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char *buf = (char *)malloc((size_t)size + 1);
    if (!buf) { fclose(f); return nullptr; }
    if (fread(buf, 1, (size_t)size, f) != (size_t)size) {
        free(buf); fclose(f); return nullptr;
    }
    fclose(f);
    buf[size] = '\0';
    const char *p = buf, *end = buf + size;

    long k = 0, L = 0, sc = 0, wt = 0;
    p = read_long(p, end, &k);
    p = read_long(p, end, &L);
    p = read_long(p, end, &sc);
    p = read_long(p, end, &wt);
    if (k <= 0 || L <= 0) { free(buf); return nullptr; }

    // Node count upper bound: geometric series sum k^1..k^L; grow vectors.
    std::vector<int32_t> parent;
    std::vector<uint8_t> leaf;
    std::vector<uint8_t> desc;
    std::vector<double> weight;
    parent.reserve(1 << 20);

    while (true) {
        p = skip_ws(p, end);
        if (p >= end) break;
        long par = 0, isl = 0;
        p = read_long(p, end, &par);
        p = read_long(p, end, &isl);
        uint8_t row[32];
        for (int b = 0; b < 32; ++b) {
            long v = 0;
            p = read_long(p, end, &v);
            row[b] = (uint8_t)v;
        }
        double w = 0.0;
        p = read_double(p, end, &w);
        parent.push_back((int32_t)par);
        leaf.push_back(isl > 0 ? 1 : 0);
        desc.insert(desc.end(), row, row + 32);
        weight.push_back(w);
    }
    free(buf);

    int64_t n = (int64_t)parent.size();
    VocabData *out = (VocabData *)malloc(sizeof(VocabData));
    out->k = (int32_t)k;
    out->L = (int32_t)L;
    out->scoring = (int32_t)sc;
    out->weighting = (int32_t)wt;
    out->n_nodes = n;
    out->parent = (int32_t *)malloc(sizeof(int32_t) * (size_t)n);
    out->is_leaf = (uint8_t *)malloc((size_t)n);
    out->desc = (uint8_t *)malloc((size_t)n * 32);
    out->weight = (double *)malloc(sizeof(double) * (size_t)n);
    memcpy(out->parent, parent.data(), sizeof(int32_t) * (size_t)n);
    memcpy(out->is_leaf, leaf.data(), (size_t)n);
    memcpy(out->desc, desc.data(), (size_t)n * 32);
    memcpy(out->weight, weight.data(), sizeof(double) * (size_t)n);
    return out;
}

void vocab_free(VocabData *v) {
    if (!v) return;
    free(v->parent);
    free(v->is_leaf);
    free(v->desc);
    free(v->weight);
    free(v);
}

// ---------------------------------------------------------------------------
// Spanning-tree rotation initialisation
// ---------------------------------------------------------------------------

// Hamilton product on [x y z w] rows: out = a * b.
static inline void qprod(const double *a, const double *b, double *out) {
    const double x1 = a[0], y1 = a[1], z1 = a[2], w1 = a[3];
    const double x2 = b[0], y2 = b[1], z2 = b[2], w2 = b[3];
    out[0] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
    out[1] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
    out[2] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
    out[3] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
}

// Propagate Q along edges until all nodes are covered; first f rows are
// never overwritten.  Returns the number of reached nodes (== n when the
// graph is connected; the caller raises otherwise).
int64_t spanning_tree_init(int64_t m, int64_t n, int64_t f,
                           const int32_t *edges,   // [m, 2]
                           const double *QQ,       // [m, 4]
                           double *Q) {            // [n, 4], in/out
    std::vector<uint8_t> seen((size_t)n, 0);
    seen[0] = 1;
    int64_t covered = 1;
    bool progressed = true;
    while (covered < n && progressed) {
        progressed = false;
        for (int64_t e = 0; e < m; ++e) {
            const int32_t a = edges[2 * e], b = edges[2 * e + 1];
            if (seen[a] && !seen[b]) {
                if (b >= f) qprod(QQ + 4 * e, Q + 4 * a, Q + 4 * b);
                seen[b] = 1;
                ++covered;
                progressed = true;
            } else if (seen[b] && !seen[a]) {
                if (a >= f) {
                    double inv[4] = {QQ[4 * e], QQ[4 * e + 1],
                                     QQ[4 * e + 2], -QQ[4 * e + 3]};
                    qprod(inv, Q + 4 * b, Q + 4 * a);
                }
                seen[a] = 1;
                ++covered;
                progressed = true;
            }
        }
    }
    return covered;
}

// ---------------------------------------------------------------------------
// Batched L1 BoW scoring
// ---------------------------------------------------------------------------

// Query (q_ids, q_w, nq) against nc candidate vectors stored CSR-style
// (ids/w sorted by id within each row).  scores[i] = 1 - 0.5*sum|v - w|
// for L1-normalised inputs, computed as sum over shared ids of
// (|v| + |w| - |v - w|) * 0.5 (the merge-join identity the reference
// scorer uses).
void bow_l1_scores(const int64_t *q_ids, const double *q_w, int64_t nq,
                   const int64_t *c_ids, const double *c_w,
                   const int64_t *c_off, int64_t nc,
                   double *scores) {
    for (int64_t c = 0; c < nc; ++c) {
        const int64_t lo = c_off[c], hi = c_off[c + 1];
        double acc = 0.0;
        int64_t i = 0, j = lo;
        while (i < nq && j < hi) {
            const int64_t a = q_ids[i], b = c_ids[j];
            if (a == b) {
                const double v = q_w[i], w = c_w[j];
                acc += fabs(v) + fabs(w) - fabs(v - w);
                ++i; ++j;
            } else if (a < b) {
                ++i;
            } else {
                ++j;
            }
        }
        scores[c] = 0.5 * acc;
    }
}

}  // extern "C"
