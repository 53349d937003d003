// Adaptive-threshold front-end of the AprilGrid detector, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// ccrs_tpu/ops/threshold_pallas.py::_kernel (wrapped by
// adaptive_threshold_pallas) and fuses the rest of
// ccrs_tpu/detect/threshold.py::threshold_front around it.  Per frame:
//
//   1. scale == 2: crop odd trailing rows/cols, 2x2 mean;
//   2. pad with white (255): rows to a multiple of 4, columns of 8 — padded
//      pixels take part in the tile statistics;
//   3. 4x4 tile min/max, dilated over the 3x3 tile neighbourhood with
//      out-of-range tiles ignored;
//   4. binary = x > (nmin+nmax)/2, forced white where nmax-nmin < min_contrast;
//   5. separation pass: 3x3 OR of the binary with out-of-range pixels as 0;
//   6. pack 8 horizontally adjacent bits per byte, MSB first.
//
// What bounds it: device-memory bytes.  Per input byte the work is a few
// integer operations, far below the card's compute rate, so the least time
// is (input bytes + output bytes) / 3.35 TB/s.  The first design lost to
// that bound in four ways: two launches with a float2-per-tile scratch
// buffer in device memory (half the size of a 512x512 input) that the
// second launch read nine times per tile; the input read once per launch;
// one 1-byte load per pixel; and packing that read 72 bytes of shared
// memory per output byte with bank conflicts.  (Measured on the H100, this
// design still spends more time in its shared-memory phases than in its
// copies, so it stays below that bound: PERF.md has the numbers.)  It:
//
// - One launch, no scratch.  A block owns a strip of BC output columns of
//   a frame and walks down a run of bands of BR output rows.  A band reads a
//   window of its rows plus an 8-row halo, and its strip plus an 8-column
//   halo: a boundary pixel's separation needs the binary one pixel out, that
//   pixel's threshold needs its tile, and that tile's dilation needs the next
//   tile out (1 + 3 + 4 pixels, two tiles).  The window lives in a ring in
//   shared memory, so the next band reuses the 16 halo rows it shares with
//   this one and copies only its BR new rows; its first four tile-statistics
//   rows are likewise this band's last four.  Tile statistics, thresholds and
//   binary rows live only in shared memory; device memory sees the input
//   about once (the column halo and the first window of a run are read
//   again, mostly from L2) and the packed output once.
// - Wide asynchronous loads.  Rows are copied with 16-byte cp.async.cg,
//   double-buffered: the next band's rows (or the next run's first window)
//   are in flight while this band computes.  cp.async rather than TMA: a TMA
//   box fills out-of-frame elements with zero, while this kernel needs white
//   (255) there, and a TMA tensor map needs a row pitch that is a multiple
//   of 16 bytes and the driver API to encode it per shape.  With cp.async
//   the out-of-frame chunks are written white by plain stores in the same
//   pass.  Frames whose row pitch or base address is not a multiple of 16
//   bytes (751- or 9-pixel rows) are staged with element loads.
// - Exact integer arithmetic for uint8.  Every float32 value of the plain
//   pipeline is an integer or a quarter/half of one, so each float test has
//   an integer twin with the same answer.  Scale 1: x > (nmin+nmax)/2 is
//   2x > nmin+nmax, i.e. x >= q with q = ((nmin+nmax) >> 1) + 1, and the
//   contrast test is (float)(nmax-nmin) >= min_contrast (the plain version
//   also compares an exact float with the float32 min_contrast).  Scale 2:
//   keep the 2x2 sums s in [0, 1020] (white padding is 1020); the mean is
//   s/4 exactly, so the compare is 2s > smin+smax, i.e. s >= q, and the
//   contrast test (float)(smax-smin) >= 4*min_contrast (a power-of-two
//   scaling, exact).  A low-contrast tile gets q = 0: always white.  Values
//   are held as pairs of 16-bit lanes in a 32-bit word: adding 0x8000 - q to
//   a lane sets its bit 15 exactly where the value is >= q, so one add tests
//   two pixels.  A tile's statistics are one word (min, 0xFFFF - max), so
//   one lane-wise minimum (__vminu2) dilates both.  16-bit lanes at scale 1
//   too: the 4-byte forms (__vminu4, __vcmpgtu4) compile to sequences of
//   several instructions on sm_90, the 16-bit-pair minimum and maximum to
//   one.  Float32 input keeps float arithmetic with the _rn intrinsics
//   (nothing contracted) in the same structure; min/max ignore NaN.
// - Bitmask separation.  A thread classifies 32 pixels into one 32-bit mask
//   (bit i = column base+i).  The 3x3 OR is the OR of three rows' masks,
//   each shifted by -1, 0 and +1, with the edge bits from the neighbouring
//   words (a band keeps one extra word each side holding the single halo
//   column).  __brev and a byte swap give most-significant-bit-first bytes
//   in a little-endian word; the store is one 4-byte word where the output
//   row is 4-byte aligned, two 2-byte halves where it is 2-byte aligned
//   (the 94-byte rows at 752) and bytes otherwise.
// - Enough blocks: each frame's bands are cut into as many runs as keep
//   about one block per slot on the card, dealt round robin to the blocks of
//   its strip, so a chunk of 64 frames fills all 132 SMs and any number of
//   frames is handled by the loop.  Shared memory above 48 KB is enabled
//   once per device.
//
// The kernel runs on the caller's stream and allocates nothing; the C entry
// points return a cudaError_t code.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int MAX_DEV = 64;  // devices with a cached launch set-up

std::atomic<unsigned long long> kernel_launches{0};  // kernels launched by this library

// Block shape per input type and scale: bands of BR output rows, strips of
// BC output columns (a multiple of 32); HL scaled columns staged left of the
// strip (>= 8, and enough to keep the staged rows 16-byte aligned).
template <typename T, int S> struct Cfg;
template <> struct Cfg<uint8_t, 1> { static constexpr int BR = 48, BC = 256, HL = 16; };
template <> struct Cfg<uint8_t, 2> { static constexpr int BR = 48, BC = 128, HL = 8; };
template <> struct Cfg<float, 1> { static constexpr int BR = 48, BC = 128, HL = 8; };
template <> struct Cfg<float, 2> { static constexpr int BR = 16, BC = 64, HL = 8; };

template <typename T, int S>
struct Shape {
  using C = Cfg<T, S>;
  static constexpr int BR = C::BR, BC = C::BC, HL = C::HL;
  static constexpr bool U8 = std::is_same<T, uint8_t>::value;
  static constexpr int WIN = BR + 16;                     // scaled rows a band reads
  static constexpr int RING = 2 * WIN;                    // staged rows: window + next
  static constexpr int RAWC = S * (BC + 2 * HL);          // input columns per input row
  static constexpr int SLOT = S * RAWC;                   // elements per staged row
  static constexpr int TR = BR / 4 + 4, TC = BC / 4 + 4;  // tile statistics of a window
  static constexpr int DR = BR / 4 + 2, DC = BC / 4 + 2;  // thresholds of a band
  static constexpr int DCP = (DC + 3 + 3) / 4 * 4;        // threshold row pitch, column j at j+3
  static constexpr int NW = BC / 32;                      // mask words per row
  static constexpr int BW = NW + 2;                       // + one halo word each side
  using Stat = typename std::conditional<U8, uint32_t, float2>::type;
  using Thr = typename std::conditional<U8, uint32_t, float>::type;
  static constexpr int RAW_BYTES = RING * SLOT * (int)sizeof(T);
  static constexpr int STAT_OFF = RAW_BYTES;
  static constexpr int THR_OFF = STAT_OFF + ((TR * TC * (int)sizeof(Stat) + 15) / 16) * 16;
  static constexpr int BIN_OFF = THR_OFF + DR * DCP * (int)sizeof(Thr);
  // uint8 at scale 2: the 2x2 sums of the window's rows, 16 bits each, kept
  // beside the tile statistics (row 4i+k of stats row i is sums row 4i+k)
  static constexpr bool SUMS = U8 && S == 2;
  static constexpr int SUMC = BC + 2 * HL;
  static constexpr int SUM_OFF = BIN_OFF + (((BR + 2) * BW * 4 + 15) / 16) * 16;
  static constexpr int SMEM = SUM_OFF + (SUMS ? 4 * TR * SUMC * 2 : 0);
  static_assert(BC % 32 == 0 && BR % 4 == 0, "block shape");
  static_assert((RING & (RING - 1)) == 0 && (TR & (TR - 1)) == 0, "ring slots by mask");
  static_assert(2 * (BR + 2) <= NT, "one thread per halo pixel of a band");
  static_assert((RAWC * sizeof(T)) % 16 == 0, "16-byte rows");
};

struct Geom {
  int H, W;         // input frame size
  int Hc, Wc;       // input rows/cols that feed the scaled frame (odd crop)
  int sHp, sWp;     // padded scaled size: rows % 4 == 0, cols % 8 == 0
  int th, tw;       // tile grid (sHp / 4, sWp / 4)
  int out_w;        // output bytes per row (sWp / 8)
  int out_align;    // 4 or 2 when every output row start is 4- or 2-byte aligned, else 1
  int nbands;       // bands per frame
  int groups;       // walks per frame: runs of consecutive bands
  long long walks;  // frames * groups (per column strip)
  int vec;          // stage with 16-byte cp.async
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 16-bit lanes (x0 + x1, x2 + x3) of the four bytes of w.
__device__ __forceinline__ uint32_t pair_sums(uint32_t w) {
  return (w & 0x00FF00FFu) + ((w >> 8) & 0x00FF00FFu);
}

// Spread the eight 2-bit units of a 16-bit x to bits 4k, 4k+1.
__device__ __forceinline__ uint32_t spread2(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  return (x | (x << 2)) & 0x33333333u;
}

// Scaled pixel of a staged row as the compare sees it: the pixel at scale 1;
// the 2x2 sum (uint8) or the 2x2 mean in the plain version's order
// (float32) at scale 2.  ``row`` is the staged row, x its scaled column.
template <typename T, int S>
__device__ __forceinline__ auto px(const T* row, int x) {
  using P = Shape<T, S>;
  if constexpr (S == 1) {
    if constexpr (P::U8) {
      return (uint32_t)row[x];
    } else {
      return row[x];
    }
  } else {
    const T* p = row + 2 * x;
    if constexpr (P::U8) {
      return (uint32_t)p[0] + p[1] + p[P::RAWC] + p[P::RAWC + 1];
    } else {
      return __fmul_rn(__fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[P::RAWC], p[P::RAWC + 1])),
                       0.25f);
    }
  }
}

// uint8: the scaled values of pixels 4k..4k+3 of a staged row as two words
// of 16-bit lanes, (pixel 0, pixel 1) and (pixel 2, pixel 3).
template <int S>
__device__ __forceinline__ uint2 lanes4(const uint8_t* row, int x) {
  if constexpr (S == 1) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + x);
    return make_uint2(__byte_perm(w, 0u, 0x4140), __byte_perm(w, 0u, 0x4342));
  } else {
    constexpr int RAWC = Shape<uint8_t, 2>::RAWC;
    const uint2 a = *reinterpret_cast<const uint2*>(row + 2 * x);
    const uint2 c = *reinterpret_cast<const uint2*>(row + RAWC + 2 * x);
    return make_uint2(pair_sums(a.x) + pair_sums(c.x), pair_sums(a.y) + pair_sums(c.y));
  }
}

// Statistics of the 4x4 tile at scaled column x0 of four consecutive staged
// rows from row0.  uint8: one word, min in the low lane, 0xFFFF - max in the
// high one, so one 16-bit-lane min takes both over a neighbourhood; at scale
// 2 the tile's sums also go to `sums` (four rows of SUMC).
template <typename T, int S>
__device__ __forceinline__ typename Shape<T, S>::Stat tile_stat(const T* row0, int x0,
                                                                uint16_t* sums) {
  using P = Shape<T, S>;
  if constexpr (P::U8) {
    uint32_t mn = 0xFFFFFFFFu, mx = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint2 v = lanes4<S>(row0 + k * P::SLOT, x0);
      if constexpr (P::SUMS) *reinterpret_cast<uint2*>(sums + k * P::SUMC + x0) = v;
      mn = __vminu2(mn, __vminu2(v.x, v.y));
      mx = __vmaxu2(mx, __vmaxu2(v.x, v.y));
    }
    const uint32_t lo = min(mn & 0xFFFFu, mn >> 16);
    const uint32_t hi = max(mx & 0xFFFFu, mx >> 16);
    return lo | ((0xFFFFu - hi) << 16);
  } else {
    float mn = INFINITY, mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = px<T, S>(row0 + k * P::SLOT, x0 + j);
        mn = fminf(mn, v);
        mx = fmaxf(mx, v);
      }
    }
    return make_float2(mn, mx);
  }
}

// Stage scaled rows [r_lo, r_hi) of frame b, columns [C0-HL, C0+BC+HL), as
// input (S x S per scaled pixel) into the ring from slot `slot`; everything
// outside the cropped frame is white.
template <typename T, int S>
__device__ __forceinline__ void stage(T* ring, const T* __restrict__ in, const Geom& g,
                                      long long b, int r_lo, int r_hi, int slot, int C0) {
  using P = Shape<T, S>;
  const T* img = in + (size_t)b * g.H * g.W;
  const int rc0 = S * (C0 - P::HL);
  const int rows = (r_hi - r_lo) * S;  // input rows
  if (g.vec) {
    constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
    constexpr int CH = P::RAWC / EPC;    // chunks per input row
    const uint32_t wv = P::U8 ? 0xFFFFFFFFu : 0x437F0000u;  // 255
    for (int i = threadIdx.x; i < rows * CH; i += NT) {
      const int rr = i / CH;
      const int k = i - rr * CH;
      const int sr = rr / S;
      const int R = S * r_lo + rr;
      const int Cc = rc0 + k * EPC;
      T* dst = ring + ((slot + sr) & (P::RING - 1)) * P::SLOT + (rr - S * sr) * P::RAWC + k * EPC;
      // W is a multiple of EPC here, so a chunk is wholly in or out
      if (R >= 0 && R < g.Hc && Cc >= 0 && Cc < g.Wc) {
        cp_async16(dst, img + (size_t)R * g.W + Cc);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(wv, wv, wv, wv);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * P::RAWC; i += NT) {
      const int rr = i / P::RAWC;
      const int x = i - rr * P::RAWC;
      const int sr = rr / S;
      const int R = S * r_lo + rr;
      const int Cc = rc0 + x;
      ring[((slot + sr) & (P::RING - 1)) * P::SLOT + (rr - S * sr) * P::RAWC + x] =
          (R >= 0 && R < g.Hc && Cc >= 0 && Cc < g.Wc) ? img[(size_t)R * g.W + Cc]
                                                      : static_cast<T>(255);
    }
  }
}

// Threshold, separate and pack the band of output rows [R0, R0+BR) of frame
// b, whose window (scaled rows R0-8 ..) starts at ring slot `slot0` and
// whose tile statistics (tile rows R0/4-2 ..) start at stats slot `tslot0`.
// `fresh`: the statistics ring holds nothing of this band yet (else its first
// four tile rows are the previous band's last four).
template <typename T, int S>
__device__ __forceinline__ void band(const T* __restrict__ ring, unsigned char* smem,
                                     uint8_t* __restrict__ out, const Geom& g,
                                     float min_contrast, long long b, int R0, int C0, int slot0,
                                     int tslot0, bool fresh) {
  using P = Shape<T, S>;
  using Stat = typename P::Stat;
  using Thr = typename P::Thr;
  Stat* __restrict__ st = reinterpret_cast<Stat*>(smem + P::STAT_OFF);
  Thr* __restrict__ thr = reinterpret_cast<Thr*>(smem + P::THR_OFF);
  uint32_t* __restrict__ bin = reinterpret_cast<uint32_t*>(smem + P::BIN_OFF);
  uint16_t* __restrict__ sums = reinterpret_cast<uint16_t*>(smem + P::SUM_OFF);
  const int tr0 = R0 / 4 - 2;  // tile row of the window's first statistics row
  const int tc0 = C0 / 4 - 2;  // tile col of st[.][0]
  auto row = [&](int ys) { return ring + ((slot0 + ys) & (P::RING - 1)) * P::SLOT; };

  // 1. tile statistics of the window's new tile rows; tiles outside the
  //    padded frame get a neutral sentinel
  const int t_from = fresh ? 0 : 4;
  const int n1 = (P::TR - t_from) * P::TC;
#pragma unroll
  for (int it = 0; it < (P::TR * P::TC + NT - 1) / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    if (i >= n1) break;
    const int ti = t_from + (int)((unsigned)i / P::TC);
    const int tj = i - (ti - t_from) * P::TC;
    const int gr = tr0 + ti, gc = tc0 + tj;
    const int slot = (tslot0 + ti) & (P::TR - 1);
    Stat s;
    if (gr >= 0 && gr < g.th && gc >= 0 && gc < g.tw) {
      s = tile_stat<T, S>(row(4 * ti), 4 * tj + P::HL - 8, sums + slot * 4 * P::SUMC);
    } else if constexpr (P::U8) {
      s = 0xFFFFFFFFu;
    } else {
      s = make_float2(INFINITY, -INFINITY);
    }
    st[slot * P::TC + tj] = s;
  }
  __syncthreads();

  // 2. thresholds of tile rows tr0+1 .. tr0+DR, dilated over 3x3 tiles.
  //    uint8: the word K added to a pair of 16-bit values sets bit 15 of a
  //    lane exactly where the pixel is white: K = (0x8000 - q) per lane with
  //    q = ((nmin+nmax) >> 1) + 1, or q = 0 (always white) at low contrast
#pragma unroll
  for (int it = 0; it < (P::DR * P::DC + NT - 1) / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    if (i >= P::DR * P::DC) break;
    const int di = (int)((unsigned)i / P::DC);
    const int dj = i - di * P::DC;
    const Stat* s0 = st + dj;
    if constexpr (P::U8) {
      uint32_t m = 0xFFFFFFFFu;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const uint32_t* s = s0 + ((tslot0 + di + a) & (P::TR - 1)) * P::TC;
        m = __vminu2(m, __vminu2(s[0], __vminu2(s[1], s[2])));
      }
      const int nmin = (int)(m & 0xFFFFu), nmax = 0xFFFF - (int)(m >> 16);
      const float need = S == 1 ? min_contrast : __fmul_rn(4.0f, min_contrast);
      const uint32_t q =
          ((float)(nmax - nmin) >= need) ? (uint32_t)((nmin + nmax) >> 1) + 1u : 0u;
      thr[di * P::DCP + dj + 3] = (0x8000u - q) * 0x00010001u;
    } else {
      float nmin = INFINITY, nmax = -INFINITY;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float2* s = s0 + ((tslot0 + di + a) & (P::TR - 1)) * P::TC;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          nmin = fminf(nmin, s[c].x);
          nmax = fmaxf(nmax, s[c].y);
        }
      }
      thr[di * P::DCP + dj + 3] = (__fsub_rn(nmax, nmin) >= min_contrast)
                                      ? __fmul_rn(__fadd_rn(nmin, nmax), 0.5f)
                                      : -INFINITY;
    }
  }
  __syncthreads();

  // 3. binary masks of rows R0-1 .. R0+BR: word 0 holds column C0-1 in bit
  //    31, word NW+1 column C0+BC in bit 0, word x column C0+32(x-1)+i in
  //    bit i; pixels outside the padded frame are 0
  //    (the two halo columns first, then the interior words)
  if (threadIdx.x < 2 * (P::BR + 2)) {
    const int y = threadIdx.x >> 1;
    const bool right = threadIdx.x & 1;
    const int r = R0 - 1 + y;
    const int c = right ? C0 + P::BC : C0 - 1;
    uint32_t w = 0;
    if (r >= 0 && r < g.sHp && c >= 0 && c < g.sWp) {
      const Thr t = thr[(r / 4 - tr0 - 1) * P::DCP + 3 + c / 4 - tc0 - 1];
      const auto v = px<T, S>(row(y + 7), c - C0 + P::HL);
      bool on;
      if constexpr (P::U8) {
        on = ((v + (t & 0xFFFFu)) & 0x8000u) != 0;
      } else {
        on = v > t;
      }
      w = on ? (right ? 1u : 0x80000000u) : 0u;
    }
    bin[y * P::BW + (right ? P::BW - 1 : 0)] = w;
  }
#pragma unroll
  for (int it = 0; it < ((P::BR + 2) * P::NW + NT - 1) / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    if (i >= (P::BR + 2) * P::NW) break;
    const int y = (int)((unsigned)i / P::NW);
    const int x = i - y * P::NW + 1;
    const int r = R0 - 1 + y;
    const int cb = C0 + 32 * (x - 1);  // first column of the word
    uint32_t w = 0;
    if (r >= 0 && r < g.sHp && cb < g.sWp) {
      const T* rp = row(y + 7);
      const int xs = cb - C0 + P::HL;  // staged column of cb
      // the word's 8 tiles, 16-byte aligned
      const Thr* t8 = thr + (r / 4 - tr0 - 1) * P::DCP + 8 * (x - 1) + 4;
      if constexpr (P::U8) {
        const uint4 ka = reinterpret_cast<const uint4*>(t8)[0];
        const uint4 kb = reinterpret_cast<const uint4*>(t8)[1];
        const uint32_t kk[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
        // the 32 values as 16 words of 16-bit lane pairs
        uint32_t v[16];
        if constexpr (S == 1) {
          const uint4* p = reinterpret_cast<const uint4*>(rp + xs);
          const uint4 p0 = p[0], p1 = p[1];
          const uint32_t b[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            v[2 * k] = __byte_perm(b[k], 0u, 0x4140);
            v[2 * k + 1] = __byte_perm(b[k], 0u, 0x4342);
          }
        } else {
          const int ys = y + 7;
          const uint4* p = reinterpret_cast<const uint4*>(
              sums + (((tslot0 + ys / 4) & (P::TR - 1)) * 4 + ys % 4) * P::SUMC + xs);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint4 q = p[k];
            v[4 * k] = q.x;
            v[4 * k + 1] = q.y;
            v[4 * k + 2] = q.z;
            v[4 * k + 3] = q.w;
          }
        }
        uint32_t A = 0, Bw = 0;  // bit 2k / 16+2k: pixels 4k, 4k+1 (A), 4k+2, 4k+3 (Bw)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          A |= ((v[2 * k] + kk[k]) & 0x80008000u) >> (15 - 2 * k);
          Bw |= ((v[2 * k + 1] + kk[k]) & 0x80008000u) >> (15 - 2 * k);
        }
        const uint32_t a = (A & 0x5555u) | ((A >> 15) & 0xAAAAu);
        const uint32_t c = (Bw & 0x5555u) | ((Bw >> 15) & 0xAAAAu);
        w = spread2(a) | (spread2(c) << 2);
      } else {
#pragma unroll 4
        for (int k = 0; k < 32; ++k) {
          w |= (uint32_t)(px<T, S>(rp, xs + k) > t8[k / 4]) << k;
        }
      }
      const int left = g.sWp - cb;  // columns of the word inside the frame
      if (left < 32) w &= (1u << left) - 1u;
    }
    bin[y * P::BW + x] = w;
  }
  __syncthreads();

  // 4. 3x3 OR and packing: one 32-pixel word per thread
#pragma unroll
  for (int it = 0; it < (P::BR * P::NW + NT - 1) / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    if (i >= P::BR * P::NW) break;
    const int y = (int)((unsigned)i / P::NW);
    const int k = i - y * P::NW;
    const int r = R0 + y;
    const int cb = C0 + 32 * k;
    if (r >= g.sHp || cb >= g.sWp) continue;
    uint32_t v = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const uint32_t* brow = bin + (y + d) * P::BW + k;
      const uint32_t pv = brow[0], m = brow[1], nx = brow[2];
      v |= m | (m << 1) | (pv >> 31) | (m >> 1) | (nx << 31);
    }
    // bit i = column cb+i  ->  byte j = columns cb+8j.., first column in bit 7
    const uint32_t packed = __byte_perm(__brev(v), 0u, 0x0123);
    uint8_t* dst = out + ((size_t)b * g.sHp + r) * g.out_w + cb / 8;
    const int nbytes = min(4, g.out_w - cb / 8);
    // the widest store every row of the output allows (uniform over the
    // grid, so no divergence between even and odd rows)
    if (nbytes == 4 && g.out_align == 4) {
      *reinterpret_cast<uint32_t*>(dst) = packed;
    } else if (nbytes == 4 && g.out_align == 2) {  // e.g. the 94-byte rows at 752
      reinterpret_cast<uint16_t*>(dst)[0] = static_cast<uint16_t>(packed);
      reinterpret_cast<uint16_t*>(dst)[1] = static_cast<uint16_t>(packed >> 16);
    } else {
      for (int j = 0; j < nbytes; ++j) dst[j] = static_cast<uint8_t>(packed >> (8 * j));
    }
  }
}

// Frame and bands [lo, hi) of walk w: each frame's bands are cut into
// `groups` runs of consecutive bands.
__device__ __forceinline__ void walk_bounds(const Geom& g, long long w, long long& b, int& lo,
                                            int& hi) {
  b = w / g.groups;
  const int k = (int)(w - b * g.groups);
  lo = (int)((long long)k * g.nbands / g.groups);
  hi = (int)((long long)(k + 1) * g.nbands / g.groups);
}

// grid (column strips, blocks per strip): block q of a strip walks down the
// bands of walks q, q + gridDim.y, ...  A band reuses the 16 window rows and
// the 4 statistics rows it shares with the band above; the rows of the next
// band (or the next walk's first window) are copied while this one computes.
template <typename T, int S>
__global__ void __launch_bounds__(NT) threshold_kernel(const T* __restrict__ in,
                                                       uint8_t* __restrict__ out, Geom g,
                                                       float min_contrast) {
  using P = Shape<T, S>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int C0 = blockIdx.x * P::BC;
  long long w = blockIdx.y;
  if (w >= g.walks) return;
  long long b;
  int bnd, bnd_end;
  walk_bounds(g, w, b, bnd, bnd_end);
  int slot0 = 0, tslot0 = 0;
  bool fresh = true;
  stage<T, S>(ring, in, g, b, bnd * P::BR - 8, bnd * P::BR + P::BR + 8, slot0, C0);
  cp_async_commit();
  for (;;) {
    const int R0 = bnd * P::BR;
    long long nw = w, nb = b;
    int nbnd = bnd + 1, nend = bnd_end;
    bool next = true, nfresh = false;
    if (nbnd >= bnd_end) {
      nw = w + gridDim.y;
      next = nw < g.walks;
      if (next) walk_bounds(g, nw, nb, nbnd, nend);
      nfresh = true;
    }
    if (next) {
      if (nfresh) {  // the next walk's whole window, after this window
        stage<T, S>(ring, in, g, nb, nbnd * P::BR - 8, nbnd * P::BR + P::BR + 8,
                    (slot0 + P::WIN) & (P::RING - 1), C0);
      } else {       // the BR rows below this window
        stage<T, S>(ring, in, g, b, R0 + P::BR + 8, R0 + 2 * P::BR + 8,
                    (slot0 + P::WIN) & (P::RING - 1), C0);
      }
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    // the syncs inside band() keep the next iteration's copies off rows
    // this band still reads: they land after its classification
    band<T, S>(ring, smem, out, g, min_contrast, b, R0, C0, slot0, tslot0, fresh);
    if (!next) break;
    slot0 = (slot0 + (nfresh ? P::WIN : P::BR)) & (P::RING - 1);
    tslot0 = nfresh ? 0 : (tslot0 + P::BR / 4) & (P::TR - 1);
    fresh = nfresh;
    w = nw;
    b = nb;
    bnd = nbnd;
    bnd_end = nend;
  }
}

// Per device and instantiation: shared memory above 48 KB enabled once, and
// how many blocks fit on the card at once.
template <typename T, int S>
cudaError_t resident_blocks(int* out) {
  static std::atomic<int> cached[MAX_DEV];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEV) {
    const int c = cached[dev].load(std::memory_order_relaxed);
    if (c > 0) {
      *out = c;
      return cudaSuccess;
    }
  }
  using P = Shape<T, S>;
  err = cudaFuncSetAttribute(threshold_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, threshold_kernel<T, S>, NT,
                                                      P::SMEM);
  if (err != cudaSuccess) return err;
  const int c = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < MAX_DEV) cached[dev].store(c, std::memory_order_relaxed);
  *out = c;
  return cudaSuccess;
}

template <typename T, int S>
int launch(const void* in, void* out, int B, int H, int W, float min_contrast,
           cudaStream_t stream) {
  using P = Shape<T, S>;
  Geom g;
  g.H = H;
  g.W = W;
  const int sH = H / S, sW = W / S;
  if (sH <= 0 || sW <= 0) return static_cast<int>(cudaErrorInvalidValue);
  g.Hc = sH * S;
  g.Wc = sW * S;
  g.sHp = (sH + 3) / 4 * 4;
  g.sWp = (sW + 7) / 8 * 8;
  g.th = g.sHp / 4;
  g.tw = g.sWp / 4;
  g.out_w = g.sWp / 8;
  const uintptr_t base = reinterpret_cast<uintptr_t>(out);
  g.out_align = (g.out_w % 4 == 0 && base % 4 == 0) ? 4 : (g.out_w % 2 == 0 && base % 2 == 0) ? 2 : 1;
  g.nbands = (g.sHp + P::BR - 1) / P::BR;
  g.vec = ((size_t)W * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(in) & 15u) == 0;

  int resident = 0;
  cudaError_t err = resident_blocks<T, S>(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int strips = (g.sWp + P::BC - 1) / P::BC;
  // one wave: about as many walks as blocks fit, each as long as that allows
  const int per_strip = resident / strips > 1 ? resident / strips : 1;
  const int groups = per_strip / B;
  g.groups = groups < 1 ? 1 : (groups > g.nbands ? g.nbands : groups);
  g.walks = (long long)B * g.groups;
  long long blocks = g.walks < per_strip ? g.walks : per_strip;
  if (blocks > 65535) blocks = 65535;
  const dim3 grid(strips, (unsigned)blocks);
  threshold_kernel<T, S><<<grid, NT, P::SMEM, stream>>>(
      static_cast<const T*>(in), static_cast<uint8_t*>(out), g, min_contrast);
  err = cudaGetLastError();
  if (err == cudaSuccess) kernel_launches.fetch_add(1, std::memory_order_relaxed);
  return static_cast<int>(err);
}

template <typename T>
int launch_scale(const void* in, void* out, int B, int H, int W, int scale, float min_contrast,
                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scale == 1) return launch<T, 1>(in, out, B, H, W, min_contrast, s);
  if (scale == 2) return launch<T, 2>(in, out, B, H, W, min_contrast, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// in: (B, H, W) uint8 / float32, contiguous; out: (B, sHp, sWp/8) uint8.
// One kernel launch; returns a cudaError_t code.
extern "C" int ccrs_threshold_front_u8(const void* in, void* out, int B, int H, int W, int scale,
                                       float min_contrast, void* stream) {
  return launch_scale<uint8_t>(in, out, B, H, W, scale, min_contrast, stream);
}

extern "C" int ccrs_threshold_front_f32(const void* in, void* out, int B, int H, int W, int scale,
                                        float min_contrast, void* stream) {
  return launch_scale<float>(in, out, B, H, W, scale, min_contrast, stream);
}

// Kernels this library has launched in the process (one per entry call).
extern "C" unsigned long long ccrs_threshold_kernel_launches() {
  return kernel_launches.load(std::memory_order_relaxed);
}

extern "C" const char* ccrs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
