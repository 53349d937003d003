// quadproc: native quad-extraction stage of the AprilGrid detector.
//
// The irregular, data-dependent part of tag detection — connected
// components, boundary tracing, polygon simplification — does not map to
// XLA's static-shape model, so it runs as a small native runtime component
// (the TPU-native analogue of the reference's native Rust detector core,
// see SURVEY.md §2.2 "aprilgrid").  Everything before (adaptive threshold)
// and after (homography decode, code matching, subpixel refinement) is
// batched JAX on device.
//
// Input:  binary images (1 = white, 0 = black) from the device front-end.
// Output: candidate quads = 4 ordered corner points of dark square blobs.
//
// Pipeline per image:
//   1. label dark 4-connected components (BFS, reusable scratch),
//      tracking area/bbox/border contact;
//   2. Moore boundary trace of each surviving component;
//   3. Douglas-Peucker simplification with an epsilon sweep to exactly 4
//      vertices; convexity + fill-ratio checks;
//   4. clockwise corner ordering (image coordinates).
//
// Build: g++ -O3 -shared -fPIC -fopenmp quadproc.cpp -o libquadproc.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct Pt {
    int x, y;
};

struct Component {
    int area = 0;
    int minx = 1 << 30, miny = 1 << 30, maxx = -1, maxy = -1;
    bool touches_border = false;
    Pt seed{0, 0};  // top-most then left-most dark pixel
};

// Moore-neighbor boundary tracing (8-connected boundary of a 4-connected
// dark region). Returns contour in clockwise order for image coords.
void trace_boundary(const uint8_t* bin, const int32_t* labels, int H, int W,
                    int label, Pt start, std::vector<Pt>& contour) {
    // 8 neighbors clockwise starting from W
    static const int dx[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
    static const int dy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
    contour.clear();
    Pt cur = start;
    int backtrack = 0;  // direction pointing to the previous (white) pixel
    // start: came from the left (outside), so backtrack = 0 (west)
    int guard = 4 * (H + W) * 8 + 64;
    do {
        contour.push_back(cur);
        bool found = false;
        for (int i = 0; i < 8; ++i) {
            int dir = (backtrack + 1 + i) % 8;
            int nx = cur.x + dx[dir];
            int ny = cur.y + dy[dir];
            if (nx < 0 || ny < 0 || nx >= W || ny >= H) continue;
            if (labels[(size_t)ny * W + nx] == label) {
                // new backtrack: direction from the new pixel back toward
                // the previously scanned (white) neighbor
                int prev_dir = (dir + 7) % 8;
                int px = cur.x + dx[prev_dir];
                int py = cur.y + dy[prev_dir];
                // direction index from (nx,ny) to (px,py)
                int bdx = px - nx, bdy = py - ny;
                int bt = 0;
                for (int k = 0; k < 8; ++k)
                    if (dx[k] == ((bdx > 0) - (bdx < 0)) && dy[k] == ((bdy > 0) - (bdy < 0))) { bt = k; break; }
                backtrack = bt;
                cur = {nx, ny};
                found = true;
                break;
            }
        }
        if (!found) break;  // isolated pixel
        if ((int)contour.size() > guard) break;
    } while (!(cur.x == start.x && cur.y == start.y));
}

double point_line_dist2(const Pt& p, const Pt& a, const Pt& b) {
    double vx = b.x - a.x, vy = b.y - a.y;
    double wx = p.x - a.x, wy = p.y - a.y;
    double cross = vx * wy - vy * wx;
    double len2 = vx * vx + vy * vy;
    if (len2 < 1e-12) return wx * wx + wy * wy;
    return cross * cross / len2;
}

void dp_simplify(const std::vector<Pt>& pts, int lo, int hi, double eps2,
                 std::vector<int>& keep) {
    // indices lo..hi (inclusive endpoints already kept)
    if (hi - lo < 2) return;
    double best = -1.0;
    int besti = -1;
    for (int i = lo + 1; i < hi; ++i) {
        double d = point_line_dist2(pts[i], pts[lo], pts[hi]);
        if (d > best) { best = d; besti = i; }
    }
    if (best > eps2) {
        keep.push_back(besti);
        dp_simplify(pts, lo, besti, eps2, keep);
        dp_simplify(pts, besti, hi, eps2, keep);
    }
}

// closed-contour DP: anchor at the two mutually farthest-ish points
int simplify_quad(const std::vector<Pt>& c, double eps, int* out_idx) {
    int n = (int)c.size();
    if (n < 4) return 0;
    // anchor 0: fixed; anchor 1: farthest from it
    int a0 = 0, a1 = 0;
    double best = -1;
    for (int i = 1; i < n; ++i) {
        double dx = c[i].x - c[0].x, dy = c[i].y - c[0].y;
        double d = dx * dx + dy * dy;
        if (d > best) { best = d; a1 = i; }
    }
    std::vector<int> keep = {a0, a1};
    double eps2 = eps * eps;
    dp_simplify(c, a0, a1, eps2, keep);
    // second half: a1..n-1..a0 — build wrapped index list
    std::vector<Pt> half2(c.begin() + a1, c.end());
    half2.push_back(c[a0]);
    std::vector<int> keep2 = {0, (int)half2.size() - 1};
    dp_simplify(half2, 0, (int)half2.size() - 1, eps2, keep2);
    for (int k : keep2)
        if (k != 0 && k != (int)half2.size() - 1) keep.push_back(a1 + k);
    std::sort(keep.begin(), keep.end());
    keep.erase(std::unique(keep.begin(), keep.end()), keep.end());
    int m = (int)keep.size();
    if (m > 16) return m;  // way too jagged at this eps
    for (int i = 0; i < std::min(m, 16); ++i) out_idx[i] = keep[i];
    return m;
}

// Total-least-squares line fit through a span of contour points.
// Returns centroid (cx,cy) and unit direction (dx,dy).
bool fit_line(const std::vector<Pt>& c, int n, int from, int count,
              double* cx, double* cy, double* dx, double* dy) {
    if (count < 2) return false;
    double sx = 0, sy = 0;
    for (int k = 0; k < count; ++k) {
        const Pt& p = c[(from + k) % n];
        sx += p.x;
        sy += p.y;
    }
    sx /= count;
    sy /= count;
    double sxx = 0, sxy = 0, syy = 0;
    for (int k = 0; k < count; ++k) {
        const Pt& p = c[(from + k) % n];
        double ux = p.x - sx, uy = p.y - sy;
        sxx += ux * ux;
        sxy += ux * uy;
        syy += uy * uy;
    }
    // principal eigenvector of [[sxx,sxy],[sxy,syy]]
    double tr = sxx + syy, det = sxx * syy - sxy * sxy;
    double lam = tr / 2 + std::sqrt(std::max(tr * tr / 4 - det, 0.0));
    double vx, vy;
    if (std::fabs(sxy) > 1e-12) {
        vx = lam - syy;
        vy = sxy;
    } else if (sxx >= syy) {
        vx = 1;
        vy = 0;
    } else {
        vx = 0;
        vy = 1;
    }
    double nrm = std::sqrt(vx * vx + vy * vy);
    if (nrm < 1e-12) return false;
    *cx = sx;
    *cy = sy;
    *dx = vx / nrm;
    *dy = vy / nrm;
    return true;
}

// Refine the 4 DP corners: fit a line to the interior span of each edge
// (skipping the blur-rounded ends) and intersect adjacent edge lines.
// Curved (fisheye) edges bias a full-edge fit far less than the raw
// contour-pixel corners the DP step returns.
void refine_corners_linefit(const std::vector<Pt>& contour, const int* idx4,
                            float* quad /*x0,y0,..x3,y3 (already filled)*/) {
    int n = (int)contour.size();
    double lc[4][4];  // cx, cy, dx, dy per edge
    bool ok[4];
    for (int e = 0; e < 4; ++e) {
        int a = idx4[e], b = idx4[(e + 1) % 4];
        int len = (b - a + n) % n;
        int skip = std::max(1, (int)(0.18 * len));
        int count = len - 2 * skip + 1;
        ok[e] = len >= 6 && count >= 3 &&
                fit_line(contour, n, (a + skip) % n, count, &lc[e][0], &lc[e][1],
                         &lc[e][2], &lc[e][3]);
    }
    for (int c = 0; c < 4; ++c) {
        int e_prev = (c + 3) % 4;  // edge ending at corner c
        int e_next = c;            // edge starting at corner c
        if (!ok[e_prev] || !ok[e_next]) continue;
        // intersect p1 + t d1 = p2 + s d2
        double x1 = lc[e_prev][0], y1 = lc[e_prev][1], d1x = lc[e_prev][2],
               d1y = lc[e_prev][3];
        double x2 = lc[e_next][0], y2 = lc[e_next][1], d2x = lc[e_next][2],
               d2y = lc[e_next][3];
        double den = d1x * d2y - d1y * d2x;
        if (std::fabs(den) < 1e-9) continue;  // near-parallel: keep DP corner
        double t = ((x2 - x1) * d2y - (y2 - y1) * d2x) / den;
        double ix = x1 + t * d1x, iy = y1 + t * d1y;
        // sanity: intersection must stay near the DP corner
        double ddx = ix - quad[2 * c], ddy = iy - quad[2 * c + 1];
        if (ddx * ddx + ddy * ddy > 36.0) continue;
        quad[2 * c] = (float)ix;
        quad[2 * c + 1] = (float)iy;
    }
}

double poly_area(const float* q /*x0,y0,..*/, int n) {
    double a = 0;
    for (int i = 0; i < n; ++i) {
        int j = (i + 1) % n;
        a += (double)q[2 * i] * q[2 * j + 1] - (double)q[2 * j] * q[2 * i + 1];
    }
    return 0.5 * a;
}

}  // namespace

extern "C" {

// Extract dark quads from one binary image.
// quads: out buffer [max_quads * 8] (x0,y0,x1,y1,x2,y2,x3,y3), clockwise in
// image coordinates (y down), starting corner arbitrary.
// Returns number of quads written.
int quadproc_extract(const uint8_t* bin, int H, int W, float* quads,
                     int max_quads, int min_area, float min_fill,
                     int32_t* labels_scratch /* H*W */) {
    int32_t* labels = labels_scratch;
    std::memset(labels, 0, sizeof(int32_t) * (size_t)H * W);
    std::vector<Component> comps(1);  // index 0 unused
    std::vector<Pt> stack;
    stack.reserve(4096);

    // 1. 4-connected labeling of dark pixels.  The seed scan visits every
    // pixel; calibration frames are mostly white (1), so test 8 bytes at
    // a time and skip all-white words (values are exactly {0,1}).
    constexpr uint64_t WHITE8 = 0x0101010101010101ULL;
    for (int y = 0; y < H; ++y) {
        for (int x = 0; x < W; ++x) {
            size_t idx = (size_t)y * W + x;
            while (x + 8 <= W) {
                uint64_t w8;
                std::memcpy(&w8, bin + idx, 8);
                if (w8 != WHITE8) break;
                x += 8;
                idx += 8;
            }
            if (x >= W) break;
            if (bin[idx] != 0 || labels[idx] != 0) continue;
            int label = (int)comps.size();
            comps.push_back(Component());
            Component& comp = comps.back();
            comp.seed = {x, y};
            stack.clear();
            stack.push_back({x, y});
            labels[idx] = label;
            while (!stack.empty()) {
                Pt p = stack.back();
                stack.pop_back();
                comp.area++;
                comp.minx = std::min(comp.minx, p.x);
                comp.maxx = std::max(comp.maxx, p.x);
                comp.miny = std::min(comp.miny, p.y);
                comp.maxy = std::max(comp.maxy, p.y);
                if (p.x == 0 || p.y == 0 || p.x == W - 1 || p.y == H - 1)
                    comp.touches_border = true;
                const int ddx[4] = {1, -1, 0, 0};
                const int ddy[4] = {0, 0, 1, -1};
                for (int k = 0; k < 4; ++k) {
                    int nx = p.x + ddx[k], ny = p.y + ddy[k];
                    if (nx < 0 || ny < 0 || nx >= W || ny >= H) continue;
                    size_t nidx = (size_t)ny * W + nx;
                    if (bin[nidx] == 0 && labels[nidx] == 0) {
                        labels[nidx] = label;
                        stack.push_back({nx, ny});
                    }
                }
            }
        }
    }

    // 2-4. per component: trace, simplify, validate
    int out = 0;
    std::vector<Pt> contour;
    int idx4[16];
    for (int label = 1; label < (int)comps.size() && out < max_quads; ++label) {
        const Component& comp = comps[label];
        if (comp.area < min_area) continue;
        if (comp.touches_border) continue;
        int bw = comp.maxx - comp.minx + 1, bh = comp.maxy - comp.miny + 1;
        if (bw < 4 || bh < 4) continue;
        double ar = (double)bw / bh;
        if (ar > 12.0 || ar < 1.0 / 12.0) continue;  // extreme slivers
        trace_boundary(bin, labels, H, W, label, comp.seed, contour);
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

        // validity: convex, sane area.  The lower fill bound rejects
        // degenerate simplifications; the upper bound must stay loose:
        // large tags get hollowed into thin shells by the low-contrast
        // rule (area << hull area) and the decoder is the real junk
        // filter.
        double qa = poly_area(best_quad, 4);
        double aqa = std::fabs(qa);
        if (aqa < 0.6 * comp.area || aqa > 12.0 * comp.area) continue;
        if (aqa < min_area) continue;
        // convexity: all cross products same sign
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

        // clockwise order in image coords (positive area with y down)
        if (qa < 0) {
            std::swap(best_quad[2], best_quad[6]);
            std::swap(best_quad[3], best_quad[7]);
        }
        std::memcpy(quads + out * 8, best_quad, sizeof(best_quad));
        out++;
    }
    return out;
}

// Batched entry: n images, outputs counts[i] quads per image.
void quadproc_extract_batch(const uint8_t* bins, int B, int H, int W,
                            float* quads /* B*max_quads*8 */, int* counts,
                            int max_quads, int min_area, float min_fill) {
#pragma omp parallel
    {
        std::vector<int32_t> scratch((size_t)H * W);
#pragma omp for schedule(dynamic)
        for (int b = 0; b < B; ++b) {
            counts[b] = quadproc_extract(
                bins + (size_t)b * H * W, H, W, quads + (size_t)b * max_quads * 8,
                max_quads, min_area, min_fill, scratch.data());
        }
    }
}

// ---------------------------------------------------------------------------
// Subpixel corner refinement (cornerSubPix-style saddle/corner solve).
//
// The access pattern (tiny windows at scattered positions) is gather-bound
// and maps poorly to the TPU vector units, so like quad extraction it lives
// in the native layer; the math matches ccrs_tpu/detect/refine.py (which
// stays as the reference implementation for tests).

static inline float bilin(const float* img, int H, int W, float x, float y) {
    if (x < 0) x = 0;
    if (y < 0) y = 0;
    if (x > W - 1.001f) x = W - 1.001f;
    if (y > H - 1.001f) y = H - 1.001f;
    int x0 = (int)x, y0 = (int)y;
    float fx = x - x0, fy = y - y0;
    const float* r0 = img + (size_t)y0 * W + x0;
    const float* r1 = r0 + W;
    return r0[0] * (1 - fx) * (1 - fy) + r0[1] * fx * (1 - fy) +
           r1[0] * (1 - fx) * fy + r1[1] * fx * fy;
}

extern "C" {

// corners: (n, 2) in-place. imgs: (B, H, W) float32. idx: (n,) image index
// per corner.
void refine_corners_native(const float* imgs, int B, int H, int W,
                           float* corners, const int32_t* img_idx, int n,
                           int win, int iters) {
    const float sigma = win / 2.0f;
    const int wsize = 2 * win + 1;
    std::vector<float> weights((size_t)wsize * wsize);
    for (int i = -win; i <= win; ++i)
        for (int j = -win; j <= win; ++j)
            weights[(i + win) * wsize + (j + win)] =
                std::exp(-(float)(i * i + j * j) / (2.0f * sigma * sigma));

#pragma omp parallel for schedule(static)
    for (int c = 0; c < n; ++c) {
        const float* img = imgs + (size_t)img_idx[c] * H * W;
        float cx = corners[2 * c], cy = corners[2 * c + 1];
        const float ox = cx, oy = cy;
        for (int it = 0; it < iters; ++it) {
            double a = 0, b = 0, d = 0, bx = 0, by = 0;
            for (int i = -win; i <= win; ++i) {
                for (int j = -win; j <= win; ++j) {
                    float px = cx + j, py = cy + i;
                    float gx = 0.5f * (bilin(img, H, W, px + 1, py) -
                                       bilin(img, H, W, px - 1, py));
                    float gy = 0.5f * (bilin(img, H, W, px, py + 1) -
                                       bilin(img, H, W, px, py - 1));
                    float wgt = weights[(i + win) * wsize + (j + win)];
                    a += wgt * gx * gx;
                    b += wgt * gx * gy;
                    d += wgt * gy * gy;
                    bx += wgt * (gx * gx * px + gx * gy * py);
                    by += wgt * (gx * gy * px + gy * gy * py);
                }
            }
            double det = a * d - b * b;
            if (std::fabs(det) < 1e-9) break;
            double qx = (d * bx - b * by) / det;
            double qy = (a * by - b * bx) / det;
            double dx = qx - cx, dy = qy - cy;
            if (dx > 1) dx = 1;
            if (dx < -1) dx = -1;
            if (dy > 1) dy = 1;
            if (dy < -1) dy = -1;
            cx += (float)dx;
            cy += (float)dy;
        }
        // total-shift clamp to the window radius (divergence guard)
        float tx = cx - ox, ty = cy - oy;
        float norm = std::sqrt(tx * tx + ty * ty);
        if (norm > win) {
            cx = ox + tx * (win / norm);
            cy = oy + ty * (win / norm);
        }
        corners[2 * c] = cx;
        corners[2 * c + 1] = cy;
    }
}

}  // extern "C"
extern "C" {

// Patch-based variant: each corner refines inside its own small patch
// (extracted on the accelerator; only ~P*P floats per corner cross the
// link instead of whole images).  corners are PATCH-LOCAL coordinates,
// refined in place.
void refine_corners_patches(const float* patches, int n, int P,
                            float* corners_local, int win, int iters) {
    const float sigma = win / 2.0f;
    const int wsize = 2 * win + 1;
    std::vector<float> weights((size_t)wsize * wsize);
    for (int i = -win; i <= win; ++i)
        for (int j = -win; j <= win; ++j)
            weights[(i + win) * wsize + (j + win)] =
                std::exp(-(float)(i * i + j * j) / (2.0f * sigma * sigma));

#pragma omp parallel for schedule(static)
    for (int c = 0; c < n; ++c) {
        const float* img = patches + (size_t)c * P * P;
        float cx = corners_local[2 * c], cy = corners_local[2 * c + 1];
        const float ox = cx, oy = cy;
        for (int it = 0; it < iters; ++it) {
            double a = 0, b = 0, d = 0, bx = 0, by = 0;
            for (int i = -win; i <= win; ++i) {
                for (int j = -win; j <= win; ++j) {
                    float px = cx + j, py = cy + i;
                    float gx = 0.5f * (bilin(img, P, P, px + 1, py) -
                                       bilin(img, P, P, px - 1, py));
                    float gy = 0.5f * (bilin(img, P, P, px, py + 1) -
                                       bilin(img, P, P, px, py - 1));
                    float wgt = weights[(i + win) * wsize + (j + win)];
                    a += wgt * gx * gx;
                    b += wgt * gx * gy;
                    d += wgt * gy * gy;
                    bx += wgt * (gx * gx * px + gx * gy * py);
                    by += wgt * (gx * gy * px + gy * gy * py);
                }
            }
            double det = a * d - b * b;
            if (std::fabs(det) < 1e-9) break;
            double qx = (d * bx - b * by) / det;
            double qy = (a * by - b * bx) / det;
            double dx = qx - cx, dy = qy - cy;
            if (dx > 1) dx = 1;
            if (dx < -1) dx = -1;
            if (dy > 1) dy = 1;
            if (dy < -1) dy = -1;
            cx += (float)dx;
            cy += (float)dy;
        }
        float tx = cx - ox, ty = cy - oy;
        float norm = std::sqrt(tx * tx + ty * ty);
        if (norm > win) {
            cx = ox + tx * (win / norm);
            cy = oy + ty * (win / norm);
        }
        corners_local[2 * c] = cx;
        corners_local[2 * c + 1] = cy;
    }
}

}  // extern "C"

}  // extern "C" (outer)
