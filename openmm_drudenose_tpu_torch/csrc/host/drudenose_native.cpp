// Native host-side runtime of openmm_drudenose_tpu_torch: a copy of the
// JAX package's native/drudenose_native.cpp, kept in this package so that
// the port builds and loads its own library (utils/native.py).
//
// It covers the host hot paths that the reference implements in C++
// inside OpenMM (molecule detection in Context::getMolecules /
// DrudeTGNHIntegrator::initialize, PDB ingestion for million-atom
// systems).  Python fallbacks exist for every entry point
// (core/topology.py, io/pdbfile.py); this makes 1M-atom system builds
// interactive instead of minutes.
//
// Build: g++ -O2 -shared -fPIC -o libdrudenose_native.so drudenose_native.cpp
// ABI: plain C, consumed via ctypes (utils/native.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Union-find molecule labelling.
//   n        : number of particles
//   edges    : 2*m int64 array of (a, b) links
//   labels   : out, n int32 molecule ids numbered by first appearance
// returns number of molecules.
// ---------------------------------------------------------------------------
int64_t dn_molecule_ids(int64_t n, const int64_t* edges, int64_t m,
                        int32_t* labels) {
    std::vector<int64_t> parent(n);
    for (int64_t i = 0; i < n; i++) parent[i] = i;

    // iterative find with path halving
    auto find = [&](int64_t i) {
        while (parent[i] != i) {
            parent[i] = parent[parent[i]];
            i = parent[i];
        }
        return i;
    };
    for (int64_t e = 0; e < m; e++) {
        int64_t ra = find(edges[2 * e]);
        int64_t rb = find(edges[2 * e + 1]);
        if (ra != rb) parent[rb] = ra;
    }
    std::vector<int32_t> remap(n, -1);
    int32_t next = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t root = find(i);
        if (remap[root] < 0) remap[root] = next++;
        labels[i] = remap[root];
    }
    return next;
}

// ---------------------------------------------------------------------------
// PDB ATOM/HETATM fast scan.
//   path     : file path
//   max_atoms: capacity of the output arrays
//   coords   : out, 3*max_atoms doubles (nm)
//   res_seq  : out, residue sequence numbers
//   names    : out, 8*max_atoms chars (atom name, NUL padded)
//   res_names: out, 8*max_atoms chars
//   box      : out, 3 doubles (nm; 0 if no CRYST1)
// returns atom count, or -1 on open failure, -(2+count) on overflow.
// ---------------------------------------------------------------------------
static double field_to_double(const char* line, int start, int len) {
    char buf[32];
    int n = len < 31 ? len : 31;
    memcpy(buf, line + start, n);
    buf[n] = 0;
    return atof(buf);
}

int64_t dn_parse_pdb(const char* path, int64_t max_atoms, double* coords,
                     int32_t* res_seq, char* names, char* res_names,
                     double* box) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    char line[512];
    int64_t count = 0;
    box[0] = box[1] = box[2] = 0.0;
    while (fgets(line, sizeof line, f)) {
        if (!strncmp(line, "CRYST1", 6)) {
            box[0] = field_to_double(line, 6, 9) * 0.1;
            box[1] = field_to_double(line, 15, 9) * 0.1;
            box[2] = field_to_double(line, 24, 9) * 0.1;
        } else if (!strncmp(line, "ATOM  ", 6) || !strncmp(line, "HETATM", 6)) {
            if (count >= max_atoms) { fclose(f); return -(2 + count); }
            size_t len = strlen(line);
            if (len < 54) continue;
            coords[3 * count + 0] = field_to_double(line, 30, 8) * 0.1;
            coords[3 * count + 1] = field_to_double(line, 38, 8) * 0.1;
            coords[3 * count + 2] = field_to_double(line, 46, 8) * 0.1;
            res_seq[count] = (int32_t) field_to_double(line, 22, 4);
            // atom name cols 12-15, residue name cols 17-20 (trimmed)
            char* nm = names + 8 * count;
            char* rn = res_names + 8 * count;
            memset(nm, 0, 8);
            memset(rn, 0, 8);
            int k = 0;
            for (int c = 12; c < 16 && c < (int) len; c++)
                if (line[c] != ' ') nm[k++] = line[c];
            k = 0;
            for (int c = 17; c < 21 && c < (int) len; c++)
                if (line[c] != ' ') rn[k++] = line[c];
            count++;
        }
    }
    fclose(f);
    return count;
}

// ---------------------------------------------------------------------------
// Residue mass accumulation (masses of massless sites contribute 0).
// ---------------------------------------------------------------------------
void dn_residue_masses(int64_t n, const int32_t* resid, const double* masses,
                       int64_t n_res, double* out) {
    memset(out, 0, n_res * sizeof(double));
    for (int64_t i = 0; i < n; i++) out[resid[i]] += masses[i];
}

}  // extern "C"
