// Native preprocessing kernels for krylov_tpu.
//
// Host-side hot paths that sit in front of the device compute path: Matrix
// Market parsing and CSR format conversion/analysis.  The reference leaned
// on scipy for these (reference: requirements.txt pins scipy; matrices were
// loaded from gitignored *.mtx / *.npz files, reference: .gitignore:1-19);
// for >=10M-row systems the pure-python paths dominate end-to-end time, so
// they are implemented natively here and exposed via ctypes
// (krylov_tpu/native.py) with numpy fallbacks.
//
// Build: `make -C native` (produces libkrylov_native.so).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Matrix Market (coordinate, real/integer/pattern, general/symmetric) parser.
//
// Two-phase API so the caller owns all allocations:
//   mm_read_header(path, &rows, &cols, &nnz, &symmetric, &pattern) -> 0/err
//   mm_read_data(path, row_idx, col_idx, values, nnz_capacity, &nnz_out)
// Symmetric files are expanded by the CALLER (mirroring), keeping this layer
// allocation-free.  Indices are converted to 0-based.
// ---------------------------------------------------------------------------

static const char* skip_ws(const char* p) {
    while (*p == ' ' || *p == '\t') p++;
    return p;
}

int mm_read_header(const char* path, int64_t* rows, int64_t* cols,
                   int64_t* nnz, int* symmetric, int* pattern) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    char line[1024];
    if (!fgets(line, sizeof line, f)) { fclose(f); return -2; }
    if (strncmp(line, "%%MatrixMarket", 14) != 0) { fclose(f); return -3; }
    *symmetric = (strstr(line, "symmetric") != nullptr) ? 1 : 0;
    *pattern = (strstr(line, "pattern") != nullptr) ? 1 : 0;
    if (strstr(line, "coordinate") == nullptr) { fclose(f); return -4; }
    // skip comments
    while (fgets(line, sizeof line, f)) {
        if (line[0] != '%') break;
    }
    if (sscanf(line, "%lld %lld %lld", (long long*)rows, (long long*)cols,
               (long long*)nnz) != 3) {
        fclose(f);
        return -5;
    }
    fclose(f);
    return 0;
}

int mm_read_data(const char* path, int32_t* row_idx, int32_t* col_idx,
                 double* values, int64_t capacity, int64_t* nnz_out) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    char line[1024];
    if (!fgets(line, sizeof line, f)) { fclose(f); return -2; }
    int pattern = (strstr(line, "pattern") != nullptr) ? 1 : 0;
    while (fgets(line, sizeof line, f)) {
        if (line[0] != '%') break;  // size line consumed
    }
    int64_t n = 0;
    while (fgets(line, sizeof line, f)) {
        const char* p = skip_ws(line);
        if (*p == '\0' || *p == '\n') continue;
        if (n >= capacity) { fclose(f); return -6; }
        char* end;
        long r = strtol(p, &end, 10);
        long c = strtol(end, &end, 10);
        double v = pattern ? 1.0 : strtod(end, &end);
        row_idx[n] = (int32_t)(r - 1);
        col_idx[n] = (int32_t)(c - 1);
        values[n] = v;
        n++;
    }
    fclose(f);
    *nnz_out = n;
    return 0;
}

// ---------------------------------------------------------------------------
// COO -> CSR (counting sort by row; caller allocates).
// ---------------------------------------------------------------------------

int coo_to_csr(int64_t nrows, int64_t nnz, const int32_t* row_idx,
               const int32_t* col_idx, const double* values, int64_t* indptr,
               int32_t* indices, double* data) {
    memset(indptr, 0, sizeof(int64_t) * (nrows + 1));
    for (int64_t i = 0; i < nnz; i++) {
        if (row_idx[i] < 0 || row_idx[i] >= nrows) return -1;
        indptr[row_idx[i] + 1]++;
    }
    for (int64_t r = 0; r < nrows; r++) indptr[r + 1] += indptr[r];
    // temp write cursor reuses a scratch copy in indices? keep simple: shift.
    for (int64_t i = 0; i < nnz; i++) {
        int64_t dst = indptr[row_idx[i]]++;
        indices[dst] = col_idx[i];
        data[dst] = values[i];
    }
    // undo cursor shift
    for (int64_t r = nrows; r > 0; r--) indptr[r] = indptr[r - 1];
    indptr[0] = 0;
    return 0;
}

// ---------------------------------------------------------------------------
// CSR analysis + ELL packing.
// ---------------------------------------------------------------------------

// Returns max row nnz; fills row_nnz if non-null.
int64_t csr_max_row_nnz(int64_t nrows, const int64_t* indptr,
                        int32_t* row_nnz) {
    int64_t mx = 0;
    for (int64_t r = 0; r < nrows; r++) {
        int64_t c = indptr[r + 1] - indptr[r];
        if (row_nnz) row_nnz[r] = (int32_t)c;
        if (c > mx) mx = c;
    }
    return mx;
}

// Pack CSR into ELL (row-major (nrows, width)); pads with value 0, col 0.
int csr_to_ell(int64_t nrows, int64_t width, const int64_t* indptr,
               const int32_t* indices, const double* data, double* ell_data,
               int32_t* ell_indices) {
    for (int64_t r = 0; r < nrows; r++) {
        int64_t lo = indptr[r], hi = indptr[r + 1];
        int64_t w = hi - lo;
        if (w > width) w = width;
        for (int64_t s = 0; s < w; s++) {
            ell_data[r * width + s] = data[lo + s];
            ell_indices[r * width + s] = indices[lo + s];
        }
        for (int64_t s = w; s < width; s++) {
            ell_data[r * width + s] = 0.0;
            ell_indices[r * width + s] = 0;
        }
    }
    return 0;
}

// Count distinct diagonals of a CSR matrix; writes up to max_offsets into
// offsets (sorted ascending).  Returns the count, or -1 if it exceeds
// max_offsets.
int64_t csr_count_diagonals(int64_t nrows, const int64_t* indptr,
                            const int32_t* indices, int64_t max_offsets,
                            int64_t* offsets) {
    // bitmap over [-nrows, +nrows)
    int64_t span = 2 * nrows + 1;
    unsigned char* seen = (unsigned char*)calloc(span, 1);
    if (!seen) return -2;
    for (int64_t r = 0; r < nrows; r++) {
        for (int64_t k = indptr[r]; k < indptr[r + 1]; k++) {
            seen[(int64_t)indices[k] - r + nrows] = 1;
        }
    }
    int64_t cnt = 0;
    for (int64_t o = 0; o < span; o++) {
        if (seen[o]) {
            if (cnt < max_offsets) offsets[cnt] = o - nrows;
            cnt++;
        }
    }
    free(seen);
    return (cnt <= max_offsets) ? cnt : -1;
}

// Pack CSR into row-indexed DIA storage: dia_data[(d, i)] = A[i, i + off_d].
int csr_to_dia(int64_t nrows, int64_t noffsets, const int64_t* offsets,
               const int64_t* indptr, const int32_t* indices,
               const double* data, double* dia_data) {
    memset(dia_data, 0, sizeof(double) * noffsets * nrows);
    // offset -> slot lookup via binary search (offsets sorted)
    for (int64_t r = 0; r < nrows; r++) {
        for (int64_t k = indptr[r]; k < indptr[r + 1]; k++) {
            int64_t off = (int64_t)indices[k] - r;
            int64_t lo = 0, hi = noffsets - 1, slot = -1;
            while (lo <= hi) {
                int64_t mid = (lo + hi) / 2;
                if (offsets[mid] == off) { slot = mid; break; }
                if (offsets[mid] < off) lo = mid + 1; else hi = mid - 1;
            }
            if (slot < 0) return -1;
            dia_data[slot * nrows + r] += data[k];
        }
    }
    return 0;
}

}  // extern "C"
