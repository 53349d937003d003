// Adaptive-threshold front-end of the AprilGrid detector, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// ccrs_tpu/ops/threshold_pallas.py::_kernel (wrapped by
// adaptive_threshold_pallas) and fuses the rest of
// ccrs_tpu/detect/threshold.py::threshold_front around it.  Per frame:
//
//   1. scale == 2: crop odd trailing rows/cols, 2x2 mean in float32;
//   2. pad with white (255): rows to a multiple of 4, columns of 8 — padded
//      pixels take part in the tile statistics;
//   3. 4x4 tile min/max, dilated over the 3x3 tile neighbourhood with
//      out-of-range tiles ignored;
//   4. binary = x > (nmin+nmax)/2, forced white where nmax-nmin < min_contrast
//      (folded into the threshold as -inf, as the Pallas kernel does);
//   5. separation pass: 3x3 OR of the binary with out-of-range pixels as 0;
//   6. pack 8 horizontally adjacent bits per byte, MSB first.
//
// Every value is exact in float32 (the 2x2 mean sums in a fixed order and the
// adds/multiplies use the _rn intrinsics so nothing is contracted), so the
// output equals the plain torch version bit for bit.
//
// What bounds it on the card: device-memory bytes.  The work per pixel is a
// handful of compares, far below the card's compute rate.  The design reads
// each input pixel once per pass — once for the tile statistics, once to
// classify it (for one frame the second read is mostly served by L2) — keeps
// the tile thresholds and the 1-pixel halo of the binary image in shared
// memory instead of device memory, and writes one bit per pixel.
//
// Launches: tile_stats_kernel (one thread per 4x4 tile -> (B, th, tw) float2
// scratch), then classify_pack_kernel (one thread per output byte; a block
// stages 8 rows x 256 pixels plus halo).  Both run on the caller's stream and
// allocate nothing; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4;
constexpr int BX = 32;             // output bytes per block row
constexpr int BY = 8;              // pixel rows per block
constexpr int PX = BX * 8;         // pixels per block row
constexpr int THR_R = BY / TILE + 2;  // tile rows staged (1-tile halo)
constexpr int THR_C = PX / TILE + 2;  // tile cols staged (1-tile halo)
constexpr int MAX_GRID_Z = 65535;

struct Geom {
  int H, W;      // input frame size
  int scale;     // 1 or 2
  int sH, sW;    // scaled size before padding
  int sHp, sWp;  // padded size: rows % 4 == 0, cols % 8 == 0
  int th, tw;    // tile grid (sHp / 4, sWp / 4)
};

// Pixel (r, c) of the scaled, white-padded frame; r < sHp, c < sWp.
template <typename T>
__device__ __forceinline__ float load_px(const T* __restrict__ img,
                                         const Geom& g, int r, int c) {
  if (r >= g.sH || c >= g.sW) return 255.0f;
  if (g.scale == 1) return static_cast<float>(img[(size_t)r * g.W + c]);
  const T* p = img + (size_t)(2 * r) * g.W + 2 * c;
  const float a = static_cast<float>(p[0]);
  const float b = static_cast<float>(p[1]);
  const float c2 = static_cast<float>(p[g.W]);
  const float d = static_cast<float>(p[g.W + 1]);
  return __fmul_rn(__fadd_rn(__fadd_rn(a, b), __fadd_rn(c2, d)), 0.25f);
}

template <typename T>
__global__ void tile_stats_kernel(const T* __restrict__ in,
                                  float2* __restrict__ stats, Geom g, int B) {
  const int tc = blockIdx.x * blockDim.x + threadIdx.x;
  const int tr = blockIdx.y * blockDim.y + threadIdx.y;
  if (tc >= g.tw || tr >= g.th) return;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const T* img = in + (size_t)b * g.H * g.W;
    float mn = INFINITY, mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
#pragma unroll
      for (int j = 0; j < TILE; ++j) {
        const float v = load_px(img, g, tr * TILE + i, tc * TILE + j);
        mn = fminf(mn, v);
        mx = fmaxf(mx, v);
      }
    }
    stats[((size_t)b * g.th + tr) * g.tw + tc] = make_float2(mn, mx);
  }
}

template <typename T>
__global__ void classify_pack_kernel(const T* __restrict__ in,
                                     const float2* __restrict__ stats,
                                     uint8_t* __restrict__ out, Geom g, int B,
                                     float min_contrast) {
  __shared__ float thr_s[THR_R][THR_C];
  __shared__ uint8_t bin_s[BY + 2][PX + 2];

  const int R0 = blockIdx.y * BY;   // first pixel row of the block
  const int C0 = blockIdx.x * PX;   // first pixel col of the block
  const int tr0 = R0 / TILE - 1;    // tile row of thr_s[0]
  const int tc0 = C0 / TILE - 1;    // tile col of thr_s[.][0]
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int nt = BX * BY;
  const int out_w = g.sWp / 8;

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const T* img = in + (size_t)b * g.H * g.W;
    const float2* st = stats + (size_t)b * g.th * g.tw;

    // 1. per-tile thresholds, dilated over the 3x3 tile neighbourhood
    for (int i = tid; i < THR_R * THR_C; i += nt) {
      const int tr = tr0 + i / THR_C;
      const int tc = tc0 + i % THR_C;
      float t = INFINITY;  // outside the frame: never read
      if (tr >= 0 && tr < g.th && tc >= 0 && tc < g.tw) {
        float nmin = INFINITY, nmax = -INFINITY;
        for (int dr = -1; dr <= 1; ++dr) {
          const int r2 = tr + dr;
          if (r2 < 0 || r2 >= g.th) continue;
          for (int dc = -1; dc <= 1; ++dc) {
            const int c2 = tc + dc;
            if (c2 < 0 || c2 >= g.tw) continue;
            const float2 s = st[(size_t)r2 * g.tw + c2];
            nmin = fminf(nmin, s.x);
            nmax = fmaxf(nmax, s.y);
          }
        }
        t = (__fsub_rn(nmax, nmin) >= min_contrast)
                ? __fmul_rn(__fadd_rn(nmin, nmax), 0.5f)
                : -INFINITY;
      }
      thr_s[i / THR_C][i % THR_C] = t;
    }
    __syncthreads();

    // 2. binary image of the block plus a 1-pixel halo (0 outside the frame)
    for (int i = tid; i < (BY + 2) * (PX + 2); i += nt) {
      const int rr = i / (PX + 2);
      const int cc = i % (PX + 2);
      const int r = R0 - 1 + rr;
      const int c = C0 - 1 + cc;
      uint8_t v = 0;
      if (r >= 0 && r < g.sHp && c >= 0 && c < g.sWp) {
        const float t = thr_s[r / TILE - tr0][c / TILE - tc0];
        v = load_px(img, g, r, c) > t ? 1 : 0;
      }
      bin_s[rr][cc] = v;
    }
    __syncthreads();

    // 3. separation (3x3 OR) and packing: one output byte per thread
    const int r = R0 + threadIdx.y;
    const int cb = C0 / 8 + threadIdx.x;
    if (r < g.sHp && cb < out_w) {
      const int rr = threadIdx.y + 1;
      unsigned byte = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int cc = threadIdx.x * 8 + k + 1;
        const unsigned v =
            bin_s[rr - 1][cc - 1] | bin_s[rr - 1][cc] | bin_s[rr - 1][cc + 1] |
            bin_s[rr][cc - 1] | bin_s[rr][cc] | bin_s[rr][cc + 1] |
            bin_s[rr + 1][cc - 1] | bin_s[rr + 1][cc] | bin_s[rr + 1][cc + 1];
        byte |= v << (7 - k);
      }
      out[((size_t)b * g.sHp + r) * out_w + cb] = static_cast<uint8_t>(byte);
    }
    __syncthreads();  // shared memory is reused by the next frame
  }
}

template <typename T>
int launch(const void* in, void* out, void* scratch, int B, int H, int W,
           int scale, float min_contrast, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || (scale != 1 && scale != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geom g;
  g.H = H;
  g.W = W;
  g.scale = scale;
  g.sH = H / scale;
  g.sW = W / scale;
  if (g.sH <= 0 || g.sW <= 0) return static_cast<int>(cudaErrorInvalidValue);
  g.sHp = (g.sH + TILE - 1) / TILE * TILE;
  g.sWp = (g.sW + 7) / 8 * 8;
  g.th = g.sHp / TILE;
  g.tw = g.sWp / TILE;
  const int gz = B < MAX_GRID_Z ? B : MAX_GRID_Z;

  const dim3 block(BX, BY);
  const dim3 grid1((g.tw + BX - 1) / BX, (g.th + BY - 1) / BY, gz);
  tile_stats_kernel<T><<<grid1, block, 0, stream>>>(
      static_cast<const T*>(in), static_cast<float2*>(scratch), g, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid2((g.sWp / 8 + BX - 1) / BX, (g.sHp + BY - 1) / BY, gz);
  classify_pack_kernel<T><<<grid2, block, 0, stream>>>(
      static_cast<const T*>(in), static_cast<const float2*>(scratch),
      static_cast<uint8_t*>(out), g, B, min_contrast);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: (B, H, W) uint8 / float32, contiguous; out: (B, sHp, sWp/8) uint8;
// scratch: (B, sHp/4, sWp/4, 2) float32.  Returns a cudaError_t code.
extern "C" int ccrs_threshold_front_u8(const void* in, void* out,
                                       void* scratch, int B, int H, int W,
                                       int scale, float min_contrast,
                                       void* stream) {
  return launch<uint8_t>(in, out, scratch, B, H, W, scale, min_contrast,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int ccrs_threshold_front_f32(const void* in, void* out,
                                        void* scratch, int B, int H, int W,
                                        int scale, float min_contrast,
                                        void* stream) {
  return launch<float>(in, out, scratch, B, H, W, scale, min_contrast,
                       static_cast<cudaStream_t>(stream));
}

extern "C" const char* ccrs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
