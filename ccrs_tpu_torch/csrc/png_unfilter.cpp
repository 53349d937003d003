// PNG scanline unfiltering for the two filter types that are sequential
// within a row: Average (3) and Paeth (4).  The other three (None, Sub,
// Up) are vectorised in Python (ccrs_tpu_torch/pngio.py).
//
// Built with g++ into ccrs_tpu_torch/_build/libpngunfilter.so at first use
// and called through ctypes.  Plain C interface: no Python or torch headers.

#include <cstdint>
#include <cstdlib>

extern "C" {

// Reconstruct one scanline in place.
//   cur:  the row's filtered bytes (without the leading filter-type byte),
//         overwritten with the reconstructed bytes
//   prev: the previous reconstructed row (all zeros for the first row)
//   n:    bytes per row; bpp: bytes per complete pixel (>= 1)
// Returns 0, or -1 for a filter type this routine does not take.
int ccrs_png_unfilter_row(uint8_t* cur, const uint8_t* prev, int filter,
                          int n, int bpp) {
    if (filter == 3) {  // Average: x + floor((a + b) / 2)
        for (int i = 0; i < n; ++i) {
            int a = i >= bpp ? cur[i - bpp] : 0;
            cur[i] = static_cast<uint8_t>(cur[i] + ((a + prev[i]) >> 1));
        }
        return 0;
    }
    if (filter == 4) {  // Paeth: x + the predictor among a, b, c
        for (int i = 0; i < n; ++i) {
            int a = i >= bpp ? cur[i - bpp] : 0;
            int b = prev[i];
            int c = i >= bpp ? prev[i - bpp] : 0;
            int p = a + b - c;
            int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
            int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
            cur[i] = static_cast<uint8_t>(cur[i] + pred);
        }
        return 0;
    }
    return -1;
}

}  // extern "C"
