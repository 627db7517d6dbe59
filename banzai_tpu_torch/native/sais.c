/* SA-IS suffix array construction + cyclic BWT for the host backend.
 *
 * Original implementation of the SA-IS algorithm (Nong, Zhang & Chan,
 * "Linear Suffix Array Construction by Almost Pure Induced-Sorting",
 * DCC'09) over an int32 alphabet with an explicit unique sentinel.  The
 * reference encoder also builds its BWT on SA-IS (lib/bwt.rs:526-756) —
 * the standard published technique for the cyclic transform: sort the
 * suffixes of block+block and keep those starting in the first copy.
 *
 * This file is written from the algorithm, not from any existing code:
 * recursion passes an int32 text; every level classifies L/S types,
 * bucket-places LMS suffixes, induces, names LMS substrings, and recurses
 * only when names collide.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static void counts(const int32_t *T, int32_t *C, int32_t n, int32_t K) {
    memset(C, 0, (size_t)K * sizeof(int32_t));
    for (int32_t i = 0; i < n; i++) C[T[i]]++;
}

/* B <- bucket heads (end=0) or bucket ends (end=1) from counts C. */
static void buckets(const int32_t *C, int32_t *B, int32_t K, int end) {
    int32_t s = 0;
    for (int32_t k = 0; k < K; k++) {
        s += C[k];
        B[k] = end ? s : s - C[k];
    }
}

static void induce_L(const int32_t *T, int32_t *SA, int32_t n, int32_t K,
                     const uint8_t *st, const int32_t *C, int32_t *B) {
    buckets(C, B, K, 0);
    for (int32_t i = 0; i < n; i++) {
        int32_t j = SA[i];
        if (j > 0 && !st[j - 1]) SA[B[T[j - 1]]++] = j - 1;
    }
}

static void induce_S(const int32_t *T, int32_t *SA, int32_t n, int32_t K,
                     const uint8_t *st, const int32_t *C, int32_t *B) {
    buckets(C, B, K, 1);
    for (int32_t i = n - 1; i >= 0; i--) {
        int32_t j = SA[i];
        if (j > 0 && st[j - 1]) SA[--B[T[j - 1]]] = j - 1;
    }
}

/* T[n-1] must be 0, unique and smallest; 0 <= T[i] < K.  SA: length n. */
static int sais(const int32_t *T, int32_t *SA, int32_t n, int32_t K) {
    if (n == 1) { SA[0] = 0; return 0; }

    uint8_t *st = (uint8_t *)malloc((size_t)n);
    int32_t *C = (int32_t *)malloc((size_t)K * sizeof(int32_t));
    int32_t *B = (int32_t *)malloc((size_t)K * sizeof(int32_t));
    if (!st || !C || !B) { free(st); free(C); free(B); return -1; }

    st[n - 1] = 1;                                  /* sentinel: S-type */
    for (int32_t i = n - 2; i >= 0; i--)
        st[i] = (T[i] < T[i + 1]) || (T[i] == T[i + 1] && st[i + 1]);

    counts(T, C, n, K);

    /* ---- stage 1: sort LMS substrings by induction ---- */
    for (int32_t i = 0; i < n; i++) SA[i] = -1;
    buckets(C, B, K, 1);
    for (int32_t i = n - 1; i >= 1; i--)
        if (st[i] && !st[i - 1]) SA[--B[T[i]]] = i;
    induce_L(T, SA, n, K, st, C, B);
    induce_S(T, SA, n, K, st, C, B);

    /* compact sorted LMS positions to SA[0..m) */
    int32_t m = 0;
    for (int32_t i = 0; i < n; i++) {
        int32_t j = SA[i];
        if (j > 0 && st[j] && !st[j - 1]) SA[m++] = j;
    }

    /* name LMS substrings in the upper half of SA (positions / 2) */
    int32_t *name = SA + m;
    for (int32_t i = 0; i < n - m; i++) name[i] = -1;
    int32_t nm = 0, prev = -1;
    for (int32_t i = 0; i < m; i++) {
        int32_t pos = SA[i];
        int diff = 0;
        if (prev < 0) {
            diff = 1;
        } else {
            for (int32_t d = 0;; d++) {
                if (pos + d >= n || prev + d >= n) { diff = 1; break; }
                int lms_p = d > 0 && st[pos + d] && !st[pos + d - 1];
                int lms_q = d > 0 && st[prev + d] && !st[prev + d - 1];
                if (lms_p && lms_q) break;          /* substrings ended equal */
                if (lms_p != lms_q ||
                    T[pos + d] != T[prev + d] ||
                    st[pos + d] != st[prev + d]) { diff = 1; break; }
            }
        }
        if (diff) { nm++; prev = pos; }
        name[pos / 2] = nm - 1;
    }

    /* gather names in text order into the tail of SA.  Right-to-left with
       j <= i at every step, so the in-place compaction never clobbers an
       unread name slot. */
    for (int32_t i = n - 1, j = n - 1; i >= m; i--)
        if (SA[i] >= 0) SA[j--] = SA[i];
    int32_t *s1 = SA + n - m;

    /* ---- stage 2: order the LMS suffixes ---- */
    int32_t *SA1 = SA;                              /* reuse the front */
    if (nm < m) {
        if (sais(s1, SA1, m, nm) != 0) {
            free(st); free(C); free(B); return -1;
        }
    } else {
        for (int32_t i = 0; i < m; i++) SA1[s1[i]] = i;
    }

    /* map SA1 (indices into the LMS list) back to text positions: collect
       LMS positions in text order into s1 */
    {
        int32_t j = 0;
        for (int32_t i = 1; i < n; i++)
            if (st[i] && !st[i - 1]) s1[j++] = i;
    }
    for (int32_t i = 0; i < m; i++) SA1[i] = s1[SA1[i]];

    /* ---- stage 3: induce the full SA from the sorted LMS order ---- */
    for (int32_t i = m; i < n; i++) SA[i] = -1;
    buckets(C, B, K, 1);
    for (int32_t i = m - 1; i >= 0; i--) {
        int32_t j = SA[i];
        SA[i] = -1;
        SA[--B[T[j]]] = j;
    }
    induce_L(T, SA, n, K, st, C, B);
    induce_S(T, SA, n, K, st, C, B);

    free(st); free(C); free(B);
    return 0;
}

/* Suffix array of data+data+sentinel: SA gets 2n+1 entries.  Rotation
 * order = SA entries < n, in SA order (identical rotations tie-ordered by
 * their tails — harmless for the BWT column; the Python wrapper computes
 * the group-head ptr via the fundamental cyclic period). */
int bwt_doubled_sa(const uint8_t *data, int64_t n, int32_t *SA) {
    int64_t N = 2 * n + 1;
    if (n <= 0 || N > INT32_MAX) return -1;
    int32_t *T = (int32_t *)malloc((size_t)N * sizeof(int32_t));
    if (!T) return -1;
    for (int64_t i = 0; i < n; i++) {
        T[i] = (int32_t)data[i] + 1;
        T[n + i] = (int32_t)data[i] + 1;
    }
    T[N - 1] = 0;
    int rc = sais(T, SA, (int32_t)N, 257);
    free(T);
    return rc;
}

/* Serial MTF over the BWT column: `init` is the initial recency list (the
 * `k` present byte values ascending, per the bzip2 format); out[i] is the
 * list position of data[i] (the dense-renamed MTF index). */
void mtf_encode(const uint8_t *data, int64_t n, const uint8_t *init,
                int32_t k, uint8_t *out) {
    uint8_t list[256];
    memcpy(list, init, (size_t)k);
    for (int64_t i = 0; i < n; i++) {
        uint8_t b = data[i];
        int32_t j = 0;
        while (list[j] != b) j++;
        out[i] = (uint8_t)j;
        memmove(list + 1, list, (size_t)j);
        list[0] = b;
    }
}

/* MTF stack indices of a selector sequence (bzip2 selector coding):
 * out_idx[i] = current stack position of sel[i]; used for both the
 * planner's cost accounting and the emitted unary codes. */
void selector_mtf(const uint8_t *sel, int64_t n, int32_t nt,
                  uint8_t *out_idx) {
    uint8_t stack[8];
    for (int32_t t = 0; t < nt; t++) stack[t] = (uint8_t)t;
    for (int64_t i = 0; i < n; i++) {
        uint8_t s = sel[i];
        int32_t j = 0;
        while (stack[j] != s) j++;
        out_idx[i] = (uint8_t)j;
        if (j) {
            memmove(stack + 1, stack, (size_t)j);
            stack[0] = s;
        }
    }
}
