/* nmftpu_io — native host-side IO/preprocessing for the nmftpu engine.
 *
 * Flat extern "C" surface in the spirit of the reference's C API
 * (SURVEY.md C1: a dlopen-able .so with C entry points so any host
 * language can bind). This library owns the CPU-side hot paths that feed
 * the engine: MovieLens ratings parsing (u.data / ratings.csv), id
 * remapping to contiguous indices, and COO->CSR conversion.
 *
 * Lifetime model: nmio_parse returns an opaque handle; the caller copies
 * out with nmio_fill_* into buffers it allocates (sizes from the getter
 * functions), then releases with nmio_free. All functions return 0 /
 * non-NULL on success unless documented otherwise.
 */

#ifndef NMFTPU_IO_H_
#define NMFTPU_IO_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Library version (major * 10000 + minor * 100 + patch). */
int32_t nmio_version(void);

/* Parse a MovieLens ratings file.
 *   path     : u.data (tab-separated, no header) or ratings.csv
 *              (comma-separated, optional "userId,..." header line).
 *   implicit : nonzero -> all values become 1.0f (click events).
 * Returns an opaque handle, or NULL on error (see nmio_last_error). */
void* nmio_parse(const char* path, int32_t implicit);

/* Dimensions of the parsed matrix. */
int64_t nmio_nnz(const void* handle);
int32_t nmio_n_users(const void* handle);
int32_t nmio_n_items(const void* handle);

/* Copy the remapped triplets (+timestamps) into caller buffers.
 * rows/cols: int32[nnz]; vals: float[nnz]; ts: int64[nnz] (ts may be
 * NULL to skip). Returns 0 on success. */
int32_t nmio_fill_coo(const void* handle, int32_t* rows, int32_t* cols,
                      float* vals, int64_t* ts);

/* Copy the original ids for each contiguous index.
 * user_ids: int64[n_users]; item_ids: int64[n_items]. */
int32_t nmio_fill_ids(const void* handle, int64_t* user_ids,
                      int64_t* item_ids);

void nmio_free(void* handle);

/* Thread-local description of the last error ("" if none). */
const char* nmio_last_error(void);

/* Standalone COO -> CSR conversion (row-major sort): fills indptr
 * (int64[n_rows+1]) and writes the permutation that sorts the triplets
 * into CSR order into perm (int64[nnz]). Returns 0 on success. */
int32_t nmio_coo_to_csr(int64_t nnz, int32_t n_rows, const int32_t* rows,
                        const int32_t* cols, int64_t* indptr,
                        int64_t* perm);

/* Fused COO -> CSR build: counting-sort by row DIRECTLY into the output
 * arrays (no permutation round-trip through the caller), then each
 * row's (col, val) pairs are sorted ascending by col in parallel.
 * indptr: int64[n_rows+1]; out_cols: int32[nnz]; out_vals: float[nnz].
 * Canonical CSR, identical ordering to the numpy (row, col) lexsort
 * except among duplicate (row, col) coordinates (unspecified there,
 * same caveat as sparse._two_key_order). Returns 0 on success. */
int32_t nmio_csr_build(int64_t nnz, int64_t n_rows, const int32_t* rows,
                       const int32_t* cols, const float* vals,
                       int64_t* indptr, int32_t* out_cols,
                       float* out_vals);

/* Bucketed-ELL builder (the device layout of nmftpu/sparse_ell.py):
 * rows split into segments of <= seg_max nonzeros; each segment goes to
 * the smallest bucket with width >= its length, zero-padded.
 *
 * Pass 1 — nmio_ell_count: segment count per bucket (int64[n_widths]).
 * Pass 2 — nmio_ell_fill: the caller allocates ZEROED per-bucket arrays
 * (vals float[nseg_b * width_b], cols int32[nseg_b * width_b], rows
 * int32[nseg_b], possibly over-allocated with padding tails) and passes
 * them as pointer arrays; segments are written in global (row-major,
 * then within-row) order — the same order as the numpy builder.
 * Returns 0 on success. */
int32_t nmio_ell_count(const int64_t* indptr, int64_t n_rows,
                       int32_t seg_max, const int32_t* widths,
                       int32_t n_widths, int64_t* seg_counts);
int32_t nmio_ell_fill(const int64_t* indptr, const int32_t* indices,
                      const float* data, int64_t n_rows, int32_t seg_max,
                      const int32_t* widths, int32_t n_widths,
                      float** vals_ptrs, int32_t** cols_ptrs,
                      int32_t** rows_ptrs);

#ifdef __cplusplus
}
#endif

#endif /* NMFTPU_IO_H_ */
