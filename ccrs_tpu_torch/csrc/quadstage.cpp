// quadstage: the detector's whole quad stage for one chunk of frames, in
// one native call.
//
// Input:  the threshold front-end's packed bitmaps, (C, Hp, row_bytes)
//         uint8, MSB first, 1 = white, rows and columns padded; the
//         frames' own (H, W) at the bitmap's scale.
// Output: (C, max_quads, 4, 2) float32 quads in full-resolution pixels and
//         (C,) counts, written in place.
//
// Per frame, on one OpenMP thread:
//   1. level 1: quadproc_extract's quads of the bitmap, max_quads / 2 slots;
//   2. the level-2 need rule: every frame without a board; with one, a
//      frame with fewer than n_tags candidates or with a candidate whose
//      float32 shoelace area is at least (100 / scale)^2;
//   3. level 2 where needed: the same on the bitmap dilated 3x3 in white
//      (False padding);
//   4. scale 2: corners pushed out from each quad's centre by 1.5 / 2.75 px;
//   5. the merge: level-1 rows first, then the level-2 rows whose centre
//      is not within 0.7 x the mean corner radius of a valid level-1 quad;
//      the other rows follow in the same order, the buffer holds the first
//      max_quads;
//   6. scale 2: pyramid to full-resolution pixels, x * 2 + 0.5.
//
// Steps 1 and 3 give quadproc_extract's quads without calling it: the
// frame stays packed, 64 pixels to a word (the dilation is word logic), its
// dark 4-connected components come from runs joined row to row by
// union-find instead of a flood fill, and each component then goes through
// quadproc.cpp's own trace, simplification and checks in the same order.
// The components, their seeds (top-most, then left-most pixel), areas,
// boxes and labels are the flood fill's, so the quads are too.  Steps 2, 4,
// 5 and 6 repeat the float32 arithmetic of the numpy composition they
// replace, operation for operation and in its order (sums of the four
// corners left to right, each product rounded before its sum).
//
// Build: g++ -O3 -shared -fPIC -fopenmp -std=c++17 quadstage.cpp (this file
// includes quadproc.cpp, so one library holds both).

#include "quadproc.cpp"

#include <omp.h>

namespace {

struct Run {
    int y, x0, x1;  // dark pixels x0..x1 (inclusive) of row y
};

struct StageScratch {
    std::vector<uint64_t> white, dilated;  // H x words, bit 63 = leftmost pixel
    std::vector<Run> runs;
    std::vector<int> row_start, parent, label;
    std::vector<Component> comps;
    std::vector<int32_t> labels;  // H x W, all zero between frames
    std::vector<Pt> contour;
    std::vector<float> q1, q2, level1;  // level1: centres and radii
    std::vector<uint8_t> keep2;
};

// one per OpenMP thread, kept across calls
thread_local StageScratch tls_scratch;

// rows [0, H) of a packed frame as 64-pixel words, white = 1; pixels past W
// read as not white
void load_white(const uint8_t* src, int row_bytes, int H, int W, int words,
                uint64_t* out) {
    const int tail = W % 64;
    const uint64_t last_mask = tail ? ~0ULL << (64 - tail) : ~0ULL;
    for (int y = 0; y < H; ++y) {
        const uint8_t* s = src + (size_t)y * row_bytes;
        uint64_t* o = out + (size_t)y * words;
        for (int k = 0; k < words; ++k) {
            uint64_t w = 0;
            for (int b = 0; b < 8; ++b) {
                int j = 8 * k + b;
                w = (w << 8) | (j < row_bytes ? s[j] : 0);
            }
            o[k] = w;
        }
        o[words - 1] &= last_mask;
    }
}

// 3x3 OR of white with False padding (rows past H and pixels past W are
// not white, and the input holds no white past W)
void dilate_white(const uint64_t* in, int H, int words, uint64_t* out) {
    for (int y = 0; y < H; ++y) {
        const uint64_t* mid = in + (size_t)y * words;
        const uint64_t* up = y > 0 ? mid - words : nullptr;
        const uint64_t* down = y + 1 < H ? mid + words : nullptr;
        uint64_t* o = out + (size_t)y * words;
        for (int k = 0; k < words; ++k) {
            uint64_t v = mid[k];
            if (up) v |= up[k];
            if (down) v |= down[k];
            o[k] = v;
        }
        // horizontal: bit i takes its neighbours i - 1 and i + 1, across words
        uint64_t carry = 0;  // the previous word's last pixel, as bit 63
        for (int k = 0; k < words; ++k) {
            uint64_t v = o[k];
            uint64_t next = k + 1 < words ? o[k + 1] >> 63 : 0;
            o[k] = v | (v >> 1) | carry | (v << 1) | next;
            carry = v << 63;
        }
    }
}

// dark 4-connected components of a packed frame (white = 1 words), numbered
// 1.. in raster order of their first pixel, as quadproc_extract's flood fill
// numbers them, with its statistics.  Returns the number of components.
int label_components(const uint64_t* white, int H, int W, int words, StageScratch& s) {
    const int tail = W % 64;
    const uint64_t last_mask = tail ? ~0ULL << (64 - tail) : ~0ULL;
    s.runs.clear();
    s.row_start.assign(H + 1, 0);
    for (int y = 0; y < H; ++y) {
        s.row_start[y] = (int)s.runs.size();
        const uint64_t* row = white + (size_t)y * words;
        for (int k = 0; k < words; ++k) {
            uint64_t dark = ~row[k];
            if (k == words - 1) dark &= last_mask;
            const int base = 64 * k;
            while (dark) {
                int a = __builtin_clzll(dark);
                uint64_t rest = ~dark & (~0ULL >> a);  // white at or after a
                int b = rest ? __builtin_clzll(rest) : 64;
                if (a == 0 && (int)s.runs.size() > s.row_start[y] &&
                    s.runs.back().x1 == base - 1)
                    s.runs.back().x1 = base + b - 1;  // a run across words
                else
                    s.runs.push_back({y, base + a, base + b - 1});
                dark = b < 64 ? dark & (~0ULL >> b) : 0;
            }
        }
    }
    s.row_start[H] = (int)s.runs.size();
    const int n = (int)s.runs.size();
    s.parent.resize(n);
    for (int i = 0; i < n; ++i) s.parent[i] = i;
    auto find = [&](int i) {
        while (s.parent[i] != i) {
            s.parent[i] = s.parent[s.parent[i]];
            i = s.parent[i];
        }
        return i;
    };
    // join each run to the runs of the row above that share a column; the
    // root of a component is its first run in raster order
    for (int y = 1; y < H; ++y) {
        int i = s.row_start[y - 1];
        const int i_end = s.row_start[y];
        for (int r = s.row_start[y]; r < s.row_start[y + 1]; ++r) {
            const Run& run = s.runs[r];
            while (i < i_end && s.runs[i].x1 < run.x0) ++i;
            for (int j = i; j < i_end && s.runs[j].x0 <= run.x1; ++j) {
                int a = find(j), b = find(r);
                if (a != b) s.parent[std::max(a, b)] = std::min(a, b);
            }
        }
    }
    s.label.resize(n);
    s.comps.assign(1, Component());
    for (int i = 0; i < n; ++i) {
        const Run& run = s.runs[i];
        int root = find(i);
        if (root == i) {
            s.label[i] = (int)s.comps.size();
            s.comps.push_back(Component());
            s.comps.back().seed = {run.x0, run.y};
        } else {
            s.label[i] = s.label[root];
        }
        Component& c = s.comps[s.label[i]];
        c.area += run.x1 - run.x0 + 1;
        c.minx = std::min(c.minx, run.x0);
        c.maxx = std::max(c.maxx, run.x1);
        c.miny = std::min(c.miny, run.y);
        c.maxy = std::max(c.maxy, run.y);
        if (run.y == 0 || run.y == H - 1 || run.x0 == 0 || run.x1 == W - 1)
            c.touches_border = true;
    }
    return (int)s.comps.size() - 1;
}

// the checks quadproc_extract makes before it traces a component
bool worth_tracing(const Component& comp, int min_area) {
    if (comp.area < min_area || comp.touches_border) return false;
    int bw = comp.maxx - comp.minx + 1, bh = comp.maxy - comp.miny + 1;
    if (bw < 4 || bh < 4) return false;
    double ar = (double)bw / bh;
    return !(ar > 12.0 || ar < 1.0 / 12.0);
}

// paint the runs of the components worth tracing with their label in
// s.labels, or with 0 to clear them
void paint_runs(int W, int min_area, bool clear, StageScratch& s) {
    for (size_t i = 0; i < s.runs.size(); ++i) {
        const Run& run = s.runs[i];
        int label = s.label[i];
        if (!worth_tracing(s.comps[label], min_area)) continue;
        std::fill_n(s.labels.data() + (size_t)run.y * W + run.x0, run.x1 - run.x0 + 1,
                    clear ? 0 : label);
    }
}

// quadproc_extract's steps 2-4, line for line, on the components of
// label_components, with the pixels of those it traces painted in s.labels
// for the trace, and cleared again.  Returns the number of quads written.
// (quadproc.cpp stays the JAX package's file; tests/test_torch_quad_stage.py
// holds this stage to the JAX package's quads, so a drift of either shows.)
int quads_of_components(int H, int W, float* quads, int max_quads, int min_area,
                        StageScratch& s) {
    paint_runs(W, min_area, false, s);
    const int32_t* labels = s.labels.data();
    std::vector<Pt>& contour = s.contour;
    int out = 0;
    int idx4[16];
    for (int label = 1; label < (int)s.comps.size() && out < max_quads; ++label) {
        const Component& comp = s.comps[label];
        if (!worth_tracing(comp, min_area)) continue;
        trace_boundary(nullptr, labels, H, W, label, comp.seed, contour);
        if ((int)contour.size() < 8) continue;

        double perim = (double)contour.size();
        float best_quad[8];
        bool got = false;
        for (double frac : {0.04, 0.02, 0.06, 0.08, 0.10, 0.12}) {
            int m = simplify_quad(contour, std::max(2.0, frac * perim), idx4);
            if (m == 4) {
                for (int i = 0; i < 4; ++i) {
                    best_quad[2 * i] = (float)contour[idx4[i]].x;
                    best_quad[2 * i + 1] = (float)contour[idx4[i]].y;
                }
                got = true;
                break;
            }
        }
        if (!got) continue;
        refine_corners_linefit(contour, idx4, best_quad);

        double qa = poly_area(best_quad, 4);
        double aqa = std::fabs(qa);
        if (aqa < 0.6 * comp.area || aqa > 12.0 * comp.area) continue;
        if (aqa < min_area) continue;
        bool convex = true;
        double sign = 0;
        for (int i = 0; i < 4; ++i) {
            int j = (i + 1) % 4, k = (i + 2) % 4;
            double ux = best_quad[2 * j] - best_quad[2 * i];
            double uy = best_quad[2 * j + 1] - best_quad[2 * i + 1];
            double vx = best_quad[2 * k] - best_quad[2 * j];
            double vy = best_quad[2 * k + 1] - best_quad[2 * j + 1];
            double cr = ux * vy - uy * vx;
            if (i == 0) sign = cr;
            if (cr * sign <= 0) { convex = false; break; }
        }
        if (!convex) continue;

        if (qa < 0) {
            std::swap(best_quad[2], best_quad[6]);
            std::swap(best_quad[3], best_quad[7]);
        }
        std::memcpy(quads + out * 8, best_quad, sizeof(best_quad));
        out++;
    }
    paint_runs(W, min_area, true, s);
    return out;
}

int extract_level(const uint64_t* white, int H, int W, int words, float* quads,
                  int max_quads, int min_area, StageScratch& s) {
    label_components(white, H, W, words, s);
    return quads_of_components(H, W, quads, max_quads, min_area, s);
}

}  // namespace

// What follows repeats numpy's float32 arithmetic: products are rounded
// before they are summed, so no fused multiply-add here.
#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")

namespace {

// q: 8 floats x0, y0, ..., x3, y3; the mean of the four corners
inline void quad_centre(const float* q, float* cx, float* cy) {
    *cx = (((q[0] + q[2]) + q[4]) + q[6]) / 4.0f;
    *cy = (((q[1] + q[3]) + q[5]) + q[7]) / 4.0f;
}

inline float norm2(float dx, float dy) {
    float xx = dx * dx;
    float yy = dy * dy;
    return std::sqrt(xx + yy);
}

// any of the first n quads with a shoelace area of at least big_area
bool has_big_quad(const float* q, int n, double big_area) {
    for (int k = 0; k < n; ++k) {
        const float* p = q + 8 * k;
        float s1 = 0.0f, s2 = 0.0f;
        for (int i = 0; i < 4; ++i) {
            int j = (i + 1) % 4;
            float a = p[2 * i] * p[2 * j + 1];
            float b = p[2 * j] * p[2 * i + 1];
            s1 += a;
            s2 += b;
        }
        float area = 0.5f * std::fabs(s1 - s2);
        if ((double)area >= big_area) return true;
    }
    return false;
}

// push each corner of n quads out from the quad's centre by px
void expand_quads(float* q, int n, float px) {
    for (int k = 0; k < n; ++k) {
        float* p = q + 8 * k;
        float cx, cy;
        quad_centre(p, &cx, &cy);
        for (int c = 0; c < 4; ++c) {
            float dx = p[2 * c] - cx, dy = p[2 * c + 1] - cy;
            float m = std::max(norm2(dx, dy), 1e-6f);
            float ox = dx / m;
            float oy = dy / m;
            ox = ox * px;
            oy = oy * px;
            p[2 * c] = p[2 * c] + ox;
            p[2 * c + 1] = p[2 * c + 1] + oy;
        }
    }
}

// level-1 rows, then the level-2 rows not near a level-1 quad, then the
// rest in the same order; the first max_quads rows go to out.  Returns the
// count of valid rows.
int merge_levels(const float* q1, int c1, const float* q2, int c2, int half,
                 int max_quads, float* out, StageScratch& s) {
    // per level-1 quad: centre x, y and 0.7 x mean corner radius
    s.level1.resize((size_t)3 * c1);
    s.keep2.resize(half);
    float* c1x = s.level1.data();
    float* c1y = c1x + c1;
    float* thr = c1y + c1;
    for (int k = 0; k < c1; ++k) {
        const float* p = q1 + 8 * k;
        quad_centre(p, &c1x[k], &c1y[k]);
        float r[4];
        for (int c = 0; c < 4; ++c) r[c] = norm2(p[2 * c] - c1x[k], p[2 * c + 1] - c1y[k]);
        float rad = (((r[0] + r[1]) + r[2]) + r[3]) / 4.0f;
        thr[k] = 0.7f * rad;
    }
    uint8_t* keep2 = s.keep2.data();
    int kept = 0;
    for (int j = 0; j < half; ++j) {
        keep2[j] = 0;
        if (j >= c2) continue;
        float cx, cy;
        quad_centre(q2 + 8 * j, &cx, &cy);
        bool dup = false;
        for (int k = 0; k < c1 && !dup; ++k) dup = norm2(c1x[k] - cx, c1y[k] - cy) < thr[k];
        keep2[j] = !dup;
        kept += !dup;
    }
    const int m = std::min(max_quads, 2 * half);
    int n = 0;
    auto put = [&](const float* row) {
        if (n < m) std::memcpy(out + 8 * (n++), row, 8 * sizeof(float));
    };
    for (int k = 0; k < c1; ++k) put(q1 + 8 * k);
    for (int j = 0; j < half; ++j)
        if (keep2[j]) put(q2 + 8 * j);
    for (int k = c1; k < half; ++k) put(q1 + 8 * k);
    for (int j = 0; j < half; ++j)
        if (!keep2[j]) put(q2 + 8 * j);
    std::memset(out + 8 * n, 0, sizeof(float) * 8 * (size_t)(max_quads - n));
    return std::min(c1 + kept, max_quads);
}

// steps 4-6 of one frame: the buffer and count of the merged levels
int finish_frame(float* q1, int c1, float* q2, int c2, int half, int max_quads,
                 int scale, float* out, StageScratch& s) {
    if (scale == 2) {
        expand_quads(q1, half, 1.5f);
        expand_quads(q2, half, 2.75f);
    }
    int count = merge_levels(q1, c1, q2, c2, half, max_quads, out, s);
    if (scale == 2)
        for (int i = 0; i < max_quads * 8; ++i) out[i] = out[i] * 2.0f + 0.5f;
    return count;
}

}  // namespace

#pragma GCC pop_options

extern "C" {

// The quad stage of C frames.  packed: (C, Hp, row_bytes); H, W: the
// frames at the bitmap's scale (H <= Hp, W <= 8 * row_bytes); scale 1 or 2;
// n_tags: the board's tag count, or -1 without a board.  quads: (C,
// max_quads, 8) float32 out; counts: (C,) out.  Returns the number of
// frames that ran level 2.
int quadstage_extract_batch(const uint8_t* packed, int C, int Hp, int row_bytes,
                            int H, int W, int scale, int n_tags, float* quads,
                            int32_t* counts, int max_quads, int min_area) {
    if (C <= 0) return 0;
    const int half = max_quads / 2;
    const double big_area = (100.0 / scale) * (100.0 / scale);
    const int words = (W + 63) / 64;
    const size_t nwords = (size_t)H * words;
    const int threads = std::max(1, std::min(C, omp_get_max_threads()));
    int level2 = 0;
#pragma omp parallel num_threads(threads) reduction(+ : level2)
    {
        StageScratch& s = tls_scratch;
        if (s.labels.size() < (size_t)H * W) s.labels.assign((size_t)H * W, 0);
        s.white.resize(nwords);
        s.dilated.resize(nwords);
        s.q1.resize((size_t)8 * half);
        s.q2.resize((size_t)8 * half);
#pragma omp for schedule(dynamic)
        for (int b = 0; b < C; ++b) {
            load_white(packed + (size_t)b * Hp * row_bytes, row_bytes, H, W, words,
                       s.white.data());
            float* q1 = s.q1.data();
            float* q2 = s.q2.data();
            std::fill(s.q1.begin(), s.q1.end(), 0.0f);
            std::fill(s.q2.begin(), s.q2.end(), 0.0f);
            int c1 = extract_level(s.white.data(), H, W, words, q1, half, min_area, s);
            int c2 = 0;
            if (n_tags < 0 || c1 < n_tags || has_big_quad(q1, c1, big_area)) {
                dilate_white(s.white.data(), H, words, s.dilated.data());
                c2 = extract_level(s.dilated.data(), H, W, words, q2, half, min_area, s);
                level2 += 1;
            }
            counts[b] = finish_frame(q1, c1, q2, c2, half, max_quads, scale,
                                     quads + (size_t)b * max_quads * 8, s);
        }
    }
    return level2;
}

}  // extern "C"
