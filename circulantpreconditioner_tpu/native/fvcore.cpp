// Native runtime core: the host-side preprocessing hot paths.
//
// The reference's native layer is PETSc/C++ doing assembly and ILU setup;
// the device compute path here is JAX/XLA, but the O(n) host preprocessing
// (mesh face extraction, ILU(0) numeric factorization, triangular level
// scheduling) is genuinely hot for million-cell meshes and is implemented
// natively with a plain C ABI (loaded via ctypes — no pybind11 dependency).
// Python/NumPy fallbacks exist for every entry point (see native.py).
//
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp fvcore.cpp -o libfvcore.so

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

// 64-bit mix for hashing sorted vertex keys
inline uint64_t mix(uint64_t h, uint64_t v) {
    h ^= v + 0x9e3779b97f4a7c15ULL + (h << 6) + (h >> 2);
    return h;
}

struct FaceKey {
    int64_t v[4];  // sorted vertex ids, -1 padded (tri faces)
    bool operator==(const FaceKey& o) const {
        return std::memcmp(v, o.v, sizeof(v)) == 0;
    }
};

struct FaceKeyHash {
    size_t operator()(const FaceKey& k) const {
        uint64_t h = 0;
        for (int i = 0; i < 4; i++) h = mix(h, (uint64_t)k.v[i]);
        return (size_t)h;
    }
};

// local face tables (must match mesh/unstructured.py)
const int HEX_FACES[6][4] = {
    {0, 3, 2, 1}, {4, 5, 6, 7}, {0, 1, 5, 4}, {3, 7, 6, 2}, {0, 4, 7, 3}, {1, 2, 6, 5}};
const int TET_FACES[4][3] = {{1, 2, 3}, {0, 3, 2}, {0, 1, 3}, {0, 2, 1}};

}  // namespace

extern "C" {

// Extract shared faces from a homogeneous cell block (nv_per_cell = 8 hex or
// 4 tet). Outputs (caller-allocated, worst case n_cells * n_faces_per_cell):
//   face_vertices: (max_faces, 4) int64, -1 padded, ORIENTED as seen from
//                  the first incident cell
//   face_cells:    (max_faces, 2) int64, second = -1 for boundary
// Returns the number of unique faces, or -1 if a face is shared by >2 cells.
int64_t fv_extract_faces(
    int64_t n_cells, int32_t nv_per_cell, const int64_t* cells,
    int64_t* face_vertices, int64_t* face_cells) {
    const int nf = nv_per_cell == 8 ? 6 : 4;
    const int fverts = nv_per_cell == 8 ? 4 : 3;
    std::unordered_map<FaceKey, int64_t, FaceKeyHash> map;
    map.reserve((size_t)(n_cells * nf));
    int64_t count = 0;
    for (int64_t c = 0; c < n_cells; c++) {
        const int64_t* cv = cells + c * nv_per_cell;
        for (int f = 0; f < nf; f++) {
            int64_t gv[4] = {-1, -1, -1, -1};
            for (int i = 0; i < fverts; i++)
                gv[i] = cv[nv_per_cell == 8 ? HEX_FACES[f][i] : TET_FACES[f][i]];
            FaceKey key;
            std::memcpy(key.v, gv, sizeof(gv));
            std::sort(key.v, key.v + 4);
            auto it = map.find(key);
            if (it == map.end()) {
                map.emplace(key, count);
                std::memcpy(face_vertices + count * 4, gv, sizeof(gv));
                face_cells[count * 2 + 0] = c;
                face_cells[count * 2 + 1] = -1;
                count++;
            } else {
                int64_t idx = it->second;
                if (face_cells[idx * 2 + 1] != -1) return -1;
                face_cells[idx * 2 + 1] = c;
            }
        }
    }
    return count;
}

// In-place ILU(0), IKJ variant (matches preconditioners._ilu0_factor_host).
// Column indices within each row must be sorted. Returns 0 on success,
// -(row+1) if a diagonal is missing.
int64_t fv_ilu0_factor(
    int64_t n, const int32_t* indptr, const int32_t* indices, double* data,
    int64_t* diag_pos_out) {
    std::vector<int64_t> diag(n);
    for (int64_t i = 0; i < n; i++) {
        const int32_t s = indptr[i], e = indptr[i + 1];
        const int32_t* cols = indices + s;
        const int32_t* found = std::lower_bound(cols, indices + e, (int32_t)i);
        if (found == indices + e || *found != (int32_t)i) return -(i + 1);
        diag[i] = s + (found - cols);
    }
    for (int64_t i = 0; i < n; i++) {
        const int32_t s = indptr[i], e = indptr[i + 1];
        for (int32_t kk = s; kk < (int32_t)diag[i]; kk++) {
            const int32_t k = indices[kk];
            double piv = data[diag[k]];
            if (piv == 0.0) piv = 1e-300;
            const double lik = data[kk] / piv;
            data[kk] = lik;
            // row k entries with col > k
            const int32_t ks = (int32_t)diag[k] + 1, ke = indptr[k + 1];
            // merge against row i's pattern (both sorted)
            int32_t pi = kk + 1;
            for (int32_t pk = ks; pk < ke; pk++) {
                const int32_t j = indices[pk];
                while (pi < e && indices[pi] < j) pi++;
                if (pi < e && indices[pi] == j) data[pi] -= lik * data[pk];
            }
        }
    }
    if (diag_pos_out)
        for (int64_t i = 0; i < n; i++) diag_pos_out[i] = diag[i];
    return 0;
}

// Level schedule for triangular solves: level_out[i] = dependency depth.
// lower != 0: strictly-lower dependencies (forward); else strictly-upper
// (backward). Returns number of levels.
int64_t fv_level_schedule(
    int64_t n, const int32_t* indptr, const int32_t* indices, int32_t lower,
    int32_t* level_out) {
    int32_t maxlev = -1;
    if (lower) {
        for (int64_t i = 0; i < n; i++) {
            int32_t lm = 0;
            for (int32_t p = indptr[i]; p < indptr[i + 1]; p++) {
                const int32_t j = indices[p];
                if (j < i && level_out[j] + 1 > lm) lm = level_out[j] + 1;
            }
            level_out[i] = lm;
            if (lm > maxlev) maxlev = lm;
        }
    } else {
        for (int64_t i = n - 1; i >= 0; i--) {
            int32_t lm = 0;
            for (int32_t p = indptr[i]; p < indptr[i + 1]; p++) {
                const int32_t j = indices[p];
                if (j > i && level_out[j] + 1 > lm) lm = level_out[j] + 1;
            }
            level_out[i] = lm;
            if (lm > maxlev) maxlev = lm;
        }
    }
    return (int64_t)maxlev + 1;
}

}  // extern "C"
