// Incomplete-Cholesky factorization and sparse triangular solves: the
// port's copy of native/sparse_factor.cpp (code-identical below this
// header), built with g++ at first use by base/sparse_native.py.  These
// are host algorithms in both packages: the factorisation and the
// triangular solves run row after row.
//
// IC(0): L has the sparsity of tril(A, -1) plus the diagonal;
//   L[i][j] = (A[i][j] - sum_k L[i][k] L[j][k]) / L[j][j]   (k < j <= i)
//   L[i][i] = sqrt(A[i][i] - sum_k L[i][k]^2)

#include <cstdint>
#include <cmath>
#include <vector>

extern "C" {

// A in CSR (full symmetric pattern, sorted indices).  Outputs:
//   Lindptr/Lindices/Ldata: strictly-lower CSR rows of L
//   diag: L's diagonal
// Returns 0 on success, i+1 if the pivot at row i was not positive
// (caller should fall back or shift).
int64_t ichol_csr(int64_t n,
                  const int64_t* indptr, const int64_t* indices,
                  const double* data,
                  int64_t* Lindptr, int64_t* Lindices, double* Ldata,
                  double* diag)
{
    // build strictly-lower pattern row-wise
    Lindptr[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t cnt = 0;
        for (int64_t jj = indptr[i]; jj < indptr[i + 1]; ++jj)
            if (indices[jj] < i) ++cnt;
        Lindptr[i + 1] = Lindptr[i] + cnt;
    }
    for (int64_t i = 0; i < n; ++i) {
        int64_t p = Lindptr[i];
        diag[i] = 0.0;
        for (int64_t jj = indptr[i]; jj < indptr[i + 1]; ++jj) {
            const int64_t j = indices[jj];
            if (j < i) {
                Lindices[p] = j;
                Ldata[p] = data[jj];
                ++p;
            } else if (j == i) {
                diag[i] = data[jj];
            }
        }
    }
    // factorization: process rows in order; rows are sorted by column
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t jj = Lindptr[i]; jj < Lindptr[i + 1]; ++jj) {
            const int64_t j = Lindices[jj];
            // dot of sparse rows i and j over columns < j
            double s = Ldata[jj];
            int64_t a = Lindptr[i], b = Lindptr[j];
            while (a < jj && b < Lindptr[j + 1]) {
                const int64_t ca = Lindices[a], cb = Lindices[b];
                if (ca == cb) { s -= Ldata[a] * Ldata[b]; ++a; ++b; }
                else if (ca < cb) ++a;
                else ++b;
            }
            Ldata[jj] = s / diag[j];
        }
        double d = diag[i];
        for (int64_t jj = Lindptr[i]; jj < Lindptr[i + 1]; ++jj)
            d -= Ldata[jj] * Ldata[jj];
        if (d <= 0.0)
            return i + 1;
        diag[i] = std::sqrt(d);
    }
    return 0;
}

// L x = b with L = strict-lower CSR + diag (forward substitution)
void forward_solve_lower(int64_t n, const int64_t* Lindptr,
                         const int64_t* Lindices, const double* Ldata,
                         const double* diag, const double* b, double* x)
{
    for (int64_t i = 0; i < n; ++i) {
        double s = b[i];
        for (int64_t jj = Lindptr[i]; jj < Lindptr[i + 1]; ++jj)
            s -= Ldata[jj] * x[Lindices[jj]];
        x[i] = s / diag[i];
    }
}

// L^T x = b using L's row structure (backward substitution, column sweeps)
void backward_solve_lower_t(int64_t n, const int64_t* Lindptr,
                            const int64_t* Lindices, const double* Ldata,
                            const double* diag, const double* b, double* x)
{
    for (int64_t i = 0; i < n; ++i) x[i] = b[i];
    for (int64_t i = n - 1; i >= 0; --i) {
        x[i] /= diag[i];
        const double xi = x[i];
        for (int64_t jj = Lindptr[i]; jj < Lindptr[i + 1]; ++jj)
            x[Lindices[jj]] -= Ldata[jj] * xi;
    }
}

}  // extern "C"
