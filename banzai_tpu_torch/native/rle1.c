/* RLE1 block splitter — native host runtime component.
 *
 * Exact implementation of the reference RLE1 state machine semantics
 * (lib/rle.rs:102-253, as specified in SURVEY.md §2.2): runs of >=4 equal
 * bytes become 4 literals + a count byte (<=251), the block output is
 * bounded, and the boundary partial-emission rules are preserved.  This is
 * the byte-serial hot loop of the host data loader; the NumPy event-table
 * implementation in rle1.py is its vectorized twin and differential oracle.
 *
 * Built on demand with cc -O3 -shared -fPIC (see native/__init__.py) and
 * called through ctypes.
 */

#include <stdint.h>
#include <stddef.h>

/* Encode one block starting at data[i0], with at most `bound` output
 * bytes.  Writes RLE1 bytes to out, returns the new input position.
 * *out_len receives the number of output bytes written. */
int64_t rle1_block(const uint8_t *data, int64_t n, int64_t i0,
                   int64_t bound, uint8_t *out, int64_t *out_len)
{
    int64_t i = i0;
    int64_t floor_ = i0;
    int64_t o = 0;
    uint8_t b;

    if (i >= n) { *out_len = 0; return i; }
    b = data[i];

    for (;;) {
        int64_t d;
        uint8_t hop;

        if (bound == 0) break;
        if (bound == 1) { out[o++] = b; i += 1; break; }
        out[o++] = b; bound -= 1;

        d = n - i;
        if (d == 1) { i += 1; break; }
        if (d == 2) { out[o++] = data[i + 1]; bound -= 1; i += 2; break; }

        hop = data[i + 2];
        out[o++] = data[i + 1]; bound -= 1;

        if (b == hop && b == data[i + 1]) {
            int run = 0;
            /* run overlapping the previous pair: [i-1, i, i+1, i+2] */
            if (i > floor_ && b == data[i - 1]) {
                if (bound < 2) { i += 2; goto done; }
                out[o++] = hop; bound -= 1;
                i += 3; run = 1;
            }
            /* fresh run [i, i+1, i+2, i+3] */
            if (!run && i + 3 < n && b == data[i + 3]) {
                if (bound == 0) { i += 2; goto done; }
                out[o++] = hop; bound -= 1;
                if (bound < 2) { i += 3; goto done; }
                out[o++] = data[i + 3]; bound -= 1;
                i += 4; run = 1;
            }
            if (run) {
                uint8_t rep = 0;
                while (rep < 251 && i < n && data[i] == b) { rep++; i++; }
                out[o++] = rep; bound -= 1;
                floor_ = i;
                if (i >= n) break;
                b = data[i];
                continue;
            }
        }

        i += 2;
        b = hop;
    }
done:
    *out_len = o;
    return i;
}
