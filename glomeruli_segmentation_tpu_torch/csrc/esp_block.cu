// Fused ESP residual block (ESPNet's DilatedParllelResidualBlockB), inference.
//
// Replaces the Pallas TPU kernel glomeruli_segmentation_tpu/ops/pallas/
// esp_block.py::_esp_kernel (called through esp_block_fused).  Same math:
//   r    = x @ w1                       1x1 reduce C -> n, f32 sums, rounded
//                                       to the activation type
//   d_i  = dilated 3x3 conv of r        d = 1, 2, 4, 8, 16 (d1 is n1 wide),
//                                       zero padding, f32 sums
//   cat  = [d1, d2, d2+d4, d2+d4+d8, d2+d4+d8+d16]   (C = n1 + 4n channels)
//   y    = prelu((cat + x) * scale + bias, alpha)     in f32, cast to x's type
//
// Layout: x and y are NHWC (B, H, W, C), contiguous; w1 is (C, n); wd is
// (5, 9n, n_pad) with tap = (dy+1)*3 + (dx+1) over offsets (-d, 0, +d);
// scale, bias and alpha are (C,) f32.  w1 and wd have x's type (f32 or bf16).
//
// What bounds it on an H100: at the main-path shape (B=32, 64x128, C=128,
// n=25, n1=28) one call moves 134 MB in bf16 (x in, y out: 40 us at
// 3.35 TB/s) and does 16.8 GFLOP (64,000 per pixel: 17 us at 989 TFLOP/s
// on bf16 tensor cores), so with its products on the tensor cores it is
// bound by bytes.  Two designs, chosen by the activation type; both are two
// passes on the caller's stream.
//
// bf16, the production path: every product is a tensor-core
// mma.sync.m16n8k16 (bf16 operands, f32 sums), fed by ldmatrix from shared
// memory that cp.async fills.
//   pass A (esp_reduce_mma_kernel): persistent blocks stream 128-pixel
//     tiles of x through shared memory (double-buffered) and hold all of w1
//     as mma B fragments in registers.  r goes to a (B, H, W, KP) bf16
//     scratch, KP = n rounded up to 16 or 32, with channels n..KP-1 written
//     as exact zeros (pass B multiplies them).  At the main-path shape r is
//     16.8 MB and stays in the 50 MB L2 for pass B.  The same blocks also
//     lay wd out in mma fragment order (K padded to KP, N to NP, zeros) in a
//     second scratch, once per call.
//   pass B (esp_branch_mma_kernel): one persistent block per SM holds all 45
//     taps' weights in shared memory (92 KB at n=25) and walks tiles of
//     kRows image rows x kSeg columns.  For each branch d and each dy in
//     {-d, 0, +d} it stages the tile's rows of r at h + dy, with d zero
//     columns on each side, into a kStages-deep ring of shared-memory bands
//     (rows and columns outside the image are zero-filled by cp.async, not
//     loaded; 16-byte chunks XOR-swizzled so that the 8 rows of an ldmatrix
//     fall in 8 different bank groups).  The three dx taps are ldmatrix
//     reads of the same band at column offsets -d, 0, +d: 15 band loads per
//     tile for 45 taps, the next loads in flight while the current band is
//     multiplied.  A warp owns 32 pixels (two m16 tiles) and all NP outputs:
//     the branch's f32 accumulator and the running sum add1..add4 stay in
//     registers.  When a branch is complete, its slice of the concat gets
//     the residual (x, staged in shared memory with the tile), the affine
//     and the PReLU in f32 and is rounded to bf16 in place; the finished
//     tile leaves as 16-byte stores.  Only the summation order differs from
//     the plain version: the reduce is rounded once, the branch sums and
//     add1..add4 are f32, the output is rounded once.
//
// f32, the "highest" parity path: CUDA cores, so that no operand is rounded
// to TF32 (that would break the f32 bar of 1e-4).
//   pass A (esp_reduce_kernel): a block stages 64 pixels of x and all of w1
//     in shared memory and writes r into a (B, H, W, n) scratch.
//   pass B (esp_branch_kernel): one thread per output pixel.  The block
//     walks the five branches in order; for each it stages that branch's
//     (9n, n_pad) weight slab in shared memory, and every thread
//     accumulates its pixel's branch output in registers, reading r through
//     the cache.  A running sum carries add1 -> add4, and each 25- or
//     28-wide slice of the concat is finished (residual, affine, PReLU) and
//     written as soon as it is complete.  Warps read the same weight address
//     at once (a broadcast), four outputs per 16-byte load.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // cp.async, ldmatrix, mma.sync, band_chunk

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

constexpr int kReducePixels = 64;
constexpr int kReduceThreads = 256;
constexpr int kBranchThreads = 256;

// Pass A: r[p, k] = sum_c x[p, c] * w1[c, k], rounded to T.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    esp_reduce_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      T* __restrict__ r, long long n_pixels, int c, int n) {
  extern __shared__ float smem[];
  const int xs_stride = c + 1;  // odd stride: two pixels of a warp differ in bank
  float* xs = smem;                                 // [kReducePixels][c + 1]
  float* ws = smem + kReducePixels * xs_stride;     // [c][n]
  const long long p0 = (long long)blockIdx.x * kReducePixels;
  const long long left = n_pixels - p0;
  const int pixels = left < kReducePixels ? (int)left : kReducePixels;

  for (int i = threadIdx.x; i < c * n; i += blockDim.x) ws[i] = to_f32(w1[i]);
  const T* xb = x + p0 * c;
  for (int i = threadIdx.x; i < pixels * c; i += blockDim.x) {
    const int p = i / c;
    xs[p * xs_stride + (i - p * c)] = to_f32(xb[i]);
  }
  __syncthreads();

  T* rb = r + p0 * n;
  for (int i = threadIdx.x; i < pixels * n; i += blockDim.x) {
    const int p = i / n;
    const int k = i - p * n;
    const float* xp = xs + p * xs_stride;
    float acc = 0.f;
    for (int ci = 0; ci < c; ++ci) acc = fmaf(xp[ci], ws[ci * n + k], acc);
    rb[i] = from_f32<T>(acc);
  }
}

// Pass B: the five dilated branches, hierarchical adds, residual, affine and
// PReLU.  NP4 is n_pad rounded up to a multiple of 4: the register width of
// one branch's accumulator.
template <typename T, int NP4>
__global__ void __launch_bounds__(kBranchThreads)
    esp_branch_kernel(const T* __restrict__ x, const T* __restrict__ r,
                      const T* __restrict__ wd, const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const float* __restrict__ alpha, T* __restrict__ y,
                      int batch, int height, int width, int c, int n, int n1,
                      int n_pad, int add_residual) {
  constexpr int Q = NP4 / 4;
  extern __shared__ float4 wsm[];  // [9n][Q]: one branch's taps, f32
  float* wsf = reinterpret_cast<float*>(wsm);

  const long long n_pixels = (long long)batch * height * width;
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = pix < n_pixels;
  int b = 0, h = 0, w = 0;
  if (valid) {
    w = (int)(pix % width);
    const long long t = pix / width;
    h = (int)(t % height);
    b = (int)(t / height);
  }
  const T* xp = x + pix * c;
  T* yp = y + pix * c;

  float run[NP4];  // add1 .. add4, carried from branch to branch
#pragma unroll
  for (int o = 0; o < NP4; ++o) run[o] = 0.f;

  for (int br = 0; br < 5; ++br) {
    __syncthreads();  // every thread is done with the previous slab
    const T* wb = wd + (long long)br * 9 * n * n_pad;
    for (int i = threadIdx.x; i < 9 * n * NP4; i += blockDim.x) {
      const int row = i / NP4;
      const int col = i - row * NP4;
      wsf[i] = col < n_pad ? to_f32(wb[row * n_pad + col]) : 0.f;
    }
    __syncthreads();
    if (!valid) continue;

    const int d = 1 << br;
    float acc[NP4];
#pragma unroll
    for (int o = 0; o < NP4; ++o) acc[o] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int hh = h + (tap / 3 - 1) * d;
      const int ww = w + (tap % 3 - 1) * d;
      if (hh < 0 || hh >= height || ww < 0 || ww >= width) continue;
      const T* rp = r + (((long long)b * height + hh) * width + ww) * n;
      const float4* wrow = wsm + tap * n * Q;
      for (int k = 0; k < n; ++k) {
        const float v = to_f32(rp[k]);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float4 wv = wrow[k * Q + q];
          acc[4 * q + 0] = fmaf(v, wv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v, wv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, wv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, wv.w, acc[4 * q + 3]);
        }
      }
    }

    // this branch's slice of the concat: d1 -> [0, n1); addk -> n1 + (k-1)n
    const int c0 = br == 0 ? 0 : n1 + (br - 1) * n;
    const int width_out = br == 0 ? n1 : n;
#pragma unroll
    for (int o = 0; o < NP4; ++o) {
      if (br > 0) run[o] += acc[o];
      if (o < width_out) {
        const int ch = c0 + o;
        float v = br == 0 ? acc[o] : run[o];
        if (add_residual) v += to_f32(xp[ch]);
        v = v * scale[ch] + bias[ch];
        v = v > 0.f ? v : alpha[ch] * v;
        yp[ch] = from_f32<T>(v);
      }
    }
  }
}

template <typename T, int NP4>
cudaError_t launch_branches(const void* x, const void* r, const void* wd,
                            const float* scale, const float* bias,
                            const float* alpha, void* y, int batch, int height,
                            int width, int c, int n, int n1, int n_pad,
                            int add_residual, cudaStream_t stream) {
  const long long n_pixels = (long long)batch * height * width;
  const unsigned blocks =
      (unsigned)((n_pixels + kBranchThreads - 1) / kBranchThreads);
  const size_t smem = (size_t)9 * n * NP4 * sizeof(float);
  esp_branch_kernel<T, NP4><<<blocks, kBranchThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(wd), scale, bias, alpha, static_cast<T*>(y), batch,
      height, width, c, n, n1, n_pad, add_residual);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const void* x, const void* w1, const void* wd,
                       const float* scale, const float* bias,
                       const float* alpha, void* r, void* y, int batch,
                       int height, int width, int c, int n, int n1, int n_pad,
                       int add_residual, cudaStream_t stream) {
  const long long n_pixels = (long long)batch * height * width;
  const unsigned blocks =
      (unsigned)((n_pixels + kReducePixels - 1) / kReducePixels);
  const size_t smem = ((size_t)kReducePixels * (c + 1) + (size_t)c * n) *
                      sizeof(float);
  esp_reduce_kernel<T><<<blocks, kReduceThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<T*>(r),
      n_pixels, c, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int np4 = (n_pad + 3) / 4 * 4;
  switch (np4) {
    case 16:  // C = 64: n = 12, n1 = 16 (ESPNet level 2)
      return launch_branches<T, 16>(x, r, wd, scale, bias, alpha, y, batch,
                                    height, width, c, n, n1, n_pad,
                                    add_residual, stream);
    case 28:  // C = 128: n = 25, n1 = 28 (ESPNet level 3)
      return launch_branches<T, 28>(x, r, wd, scale, bias, alpha, y, batch,
                                    height, width, c, n, n1, n_pad,
                                    add_residual, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------- the bf16 path: tensor cores ----------------

constexpr int kMmaThreads = 256;  // pass A: 8 warps
constexpr int kHalo = 16;         // the largest dilation
constexpr int kRows = 2;          // pass B tile: kRows image rows ...
constexpr int kSeg = 128;         // ... x kSeg columns
constexpr int kMt = 2;            // m16 tiles of a pass-B warp, all in one row
constexpr int kWarpPix = 16 * kMt;
constexpr int kTileThreads = kRows * kSeg / kWarpPix * 32;
constexpr int kBandPix = kSeg + 2 * kHalo;
constexpr int kStages = 3;        // depth of the band ring
// A unit's loads start kStages - 1 units ahead, and the third unit of
// a tile brings the tile's x into the buffer the previous tile is written
// out from: that load must come after the writeout, at the next tile's
// first unit at the earliest.
static_assert(kStages <= 3, "x of the next tile would overwrite this one");
constexpr int kUnits = 15;        // band loads per tile: 5 branches x 3 dy
constexpr int kReduceTile = 128;  // pass A tile: 16 pixels a warp
constexpr int kReduceStages = 2;  // depth of its ring of x tiles

// Sizes of one width: C channels, KP = n padded (the reduce scratch's
// channels and the branch products' K), NP = n_pad padded (their N).
template <int C, int KP, int NP>
struct Mma {
  static_assert(KP == 16 || KP == 32, "KP is 16 or 32");
  static_assert(NP % 16 == 0 && C % 16 == 0, "NP and C are multiples of 16");
  static constexpr int KS = KP / 16;   // k16 steps of one tap
  static constexpr int CH = KP / 8;    // 16-byte chunks of one r pixel
  static constexpr int NT = NP / 8;    // n8 tiles of the outputs
  static constexpr int XS = C + 8;     // pixel stride of the x/y tiles: the 8
                                       // rows of an ldmatrix in 8 bank groups
  static constexpr int kFragVecs = 45 * KS * (NT / 2) * 32;  // uint4 each
  static constexpr int kWeightBytes = kFragVecs * 16;
  static constexpr int kBandBytes = kRows * kBandPix * KP * 2;
  static constexpr int kIoBytes = kRows * kSeg * XS * 2;
  static constexpr int kBranchSmem =
      kWeightBytes + kStages * kBandBytes + kIoBytes + 3 * C * 4;
  static constexpr int kReduceSmem = kReduceStages * kReduceTile * XS * 2;
};

// wd (5, 9n, n_pad) -> B fragments of every (branch, tap, k step, pair of n8
// tiles), one uint4 per lane: {tile 2j: k rows 2t..2t+1, 2t+8..2t+9; tile
// 2j+1: the same}, column g = lane / 4, t = lane % 4.  K beyond n and the
// columns beyond the branch's width (n1 for d1, n for the others) are zero.
template <int KS, int NT>
__device__ void pack_branch_weights(const bf16* __restrict__ wd,
                                    uint32_t* __restrict__ frag, int n,
                                    int n1, int n_pad) {
  constexpr int kWords = 45 * KS * (NT / 2) * 32 * 4;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < kWords;
       i += gridDim.x * blockDim.x) {
    const int word = i & 3;
    const int lane = (i >> 2) & 31;
    int rest = i >> 7;
    const int pair = rest % (NT / 2);
    rest /= NT / 2;
    const int ks = rest % KS;
    const int bt = rest / KS;  // branch * 9 + tap
    const int br = bt / 9;
    const int col = (pair * 2 + (word >> 1)) * 8 + (lane >> 2);
    const int k = ks * 16 + (word & 1) * 8 + (lane & 3) * 2;
    const bool live = col < (br == 0 ? n1 : n);
    const bf16* src = wd + ((long long)bt * n + k) * n_pad + col;
    const bf16 lo = live && k < n ? src[0] : zero;
    const bf16 hi = live && k + 1 < n ? src[n_pad] : zero;
    frag[i] = pack_bf16(lo, hi);
  }
}

// Pass A: r = x @ w1 on tensor cores, rounded to bf16, pad channels zero;
// and wd in fragment order for pass B.
template <int C, int KP, int NP>
__global__ void __launch_bounds__(kMmaThreads, 2)
    esp_reduce_mma_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ w1,
                          const bf16* __restrict__ wd,
                          uint32_t* __restrict__ wfrag, bf16* __restrict__ r,
                          long long n_pixels, int n, int n1, int n_pad) {
  using S = Mma<C, KP, NP>;
  constexpr int KSA = C / 16;   // k steps of the reduce
  constexpr int NTA = KP / 8;   // its n8 tiles
  constexpr int CPP = C / 8;    // 16-byte chunks of one x pixel
  extern __shared__ uint4 mma_smem[];
  bf16* xs = reinterpret_cast<bf16*>(mma_smem);  // [stages][kReduceTile][XS]

  pack_branch_weights<S::KS, S::NT>(wd, wfrag, n, n1, n_pad);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  // w1 (C, n) as B fragments, zero beyond column n
  const bf16 zero = __float2bfloat16_rn(0.f);
  uint32_t bw[KSA][NTA][2];
#pragma unroll
  for (int ks = 0; ks < KSA; ++ks)
#pragma unroll
    for (int nt = 0; nt < NTA; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + g;
        const int k = ks * 16 + j * 8 + t2;
        bw[ks][nt][j] = pack_bf16(col < n ? w1[k * n + col] : zero,
                                  col < n ? w1[(k + 1) * n + col] : zero);
      }

  const long long n_tiles = (n_pixels + kReduceTile - 1) / kReduceTile;
  auto load = [&](long long tile, int buf) {
    bf16* dst = xs + buf * kReduceTile * S::XS;
    for (int i = threadIdx.x; i < kReduceTile * CPP; i += kMmaThreads) {
      const int p = i / CPP;
      const int c8 = i - p * CPP;
      const long long pix = tile * kReduceTile + p;
      const bool ok = pix < n_pixels;
      cp_async16(smem_u32(dst + p * S::XS + c8 * 8),
                 ok ? x + pix * C + c8 * 8 : x, ok);
    }
  };

  for (int s = 0; s < kReduceStages - 1; ++s) {
    const long long tile = blockIdx.x + (long long)s * gridDim.x;
    if (tile < n_tiles) load(tile, s);
    cp_async_commit();
  }
  int buf = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    cp_async_wait<kReduceStages - 2>();
    __syncthreads();  // this tile has landed; every warp is done with the last
    const long long ahead = tile + (long long)(kReduceStages - 1) * gridDim.x;
    if (ahead < n_tiles)
      load(ahead, buf == 0 ? kReduceStages - 1 : buf - 1);
    cp_async_commit();
    const bf16* src = xs + buf * kReduceTile * S::XS;
    float acc[NTA][4] = {};
#pragma unroll
    for (int ks = 0; ks < KSA; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(src + (warp * 16 + (lane & 15)) * S::XS +
                              ks * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int nt = 0; nt < NTA; ++nt)
        mma_bf16(acc[nt], a, bw[ks][nt][0], bw[ks][nt][1]);
    }
    const long long p0 = tile * kReduceTile + warp * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NTA; ++nt) {
      const int col = nt * 8 + t2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long pix = p0 + half * 8;
        if (pix >= n_pixels) continue;
        const float v0 = col < n ? acc[nt][2 * half] : 0.f;
        const float v1 = col + 1 < n ? acc[nt][2 * half + 1] : 0.f;
        *reinterpret_cast<uint32_t*>(r + pix * KP + col) =
            pack_bf16(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
      }
    }
    buf = buf + 1 == kReduceStages ? 0 : buf + 1;
  }
  cp_async_wait<0>();
}

// Pass B: the five dilated branches as an implicit GEMM on tensor cores,
// hierarchical adds, residual, affine and PReLU.
template <int C, int KP, int NP>
__global__ void __launch_bounds__(kTileThreads, 1)
    esp_branch_mma_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ r,
                          const uint4* __restrict__ wfrag,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          const float* __restrict__ alpha,
                          bf16* __restrict__ y, int batch, int height,
                          int width, int n, int n1, int add_residual) {
  using S = Mma<C, KP, NP>;
  constexpr int CPP = C / 8;  // 16-byte chunks of one x/y pixel
  extern __shared__ uint4 mma_smem[];
  uint4* wsm = mma_smem;  // [45][KS][NT/2][32] B fragments
  unsigned char* bands =
      reinterpret_cast<unsigned char*>(mma_smem) + S::kWeightBytes;
  bf16* io = reinterpret_cast<bf16*>(bands + kStages * S::kBandBytes);
  float* prm = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(io) + S::kIoBytes);  // scale|bias|alpha

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const int seg_tiles = (width + kSeg - 1) / kSeg;
  const int tiles_per_image = (height + kRows - 1) / kRows * seg_tiles;
  const int n_tiles = batch * tiles_per_image;
  const int my_tiles =
      ((int)blockIdx.x < n_tiles)
          ? (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
          : 0;
  const int n_units = my_tiles * kUnits;

  for (int i = threadIdx.x; i < C; i += kTileThreads) {
    prm[i] = scale[i];
    prm[C + i] = bias[i];
    prm[2 * C + i] = alpha[i];
  }

  // A place in this block's sequence of units: the tile, the unit within
  // it (branch unit / 3, dy index unit % 3) and the ring stage that holds
  // its band.  Advancing divides only when it enters a new tile.
  struct Cursor {
    int tile, unit, stage, b, h0, w0;
  };
  auto enter_tile = [&](Cursor& c) {
    c.b = c.tile / tiles_per_image;
    const int rem = c.tile - c.b * tiles_per_image;
    const int row_tile = rem / seg_tiles;
    c.h0 = row_tile * kRows;
    c.w0 = (rem - row_tile * seg_tiles) * kSeg;
  };
  auto advance = [&](Cursor& c) {
    c.stage = c.stage + 1 == kStages ? 0 : c.stage + 1;
    if (++c.unit == kUnits) {
      c.unit = 0;
      c.tile += gridDim.x;
      enter_tile(c);
    }
  };

  // Stages the band of unit c; the third unit of a tile also brings the
  // tile's x (its epilogue is the first to need it), the block's first
  // unit the weights.
  auto load_unit = [&](const Cursor& c, bool first) {
    const int d = 1 << (c.unit / 3);
    const int dy = (c.unit % 3 - 1) * d;
    const int cols = kSeg + 2 * d;
    unsigned char* band = bands + c.stage * S::kBandBytes;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int hs = c.h0 + rr + dy;
      const bool row_ok = hs >= 0 && hs < height;
      const long long row = ((long long)c.b * height + hs) * width;
      for (int i = threadIdx.x; i < cols * S::CH; i += kTileThreads) {
        const int j = i / S::CH;
        const int k8 = i % S::CH;
        const int ws = c.w0 - d + j;
        const bool ok = row_ok && ws >= 0 && ws < width;
        cp_async16(
            smem_u32(band + band_chunk<S::CH>(rr * kBandPix + j, k8) * 16),
            ok ? r + (row + ws) * KP + k8 * 8 : r, ok);
      }
    }
    if (c.unit == 2 && add_residual) {
      for (int i = threadIdx.x; i < kRows * kSeg * CPP; i += kTileThreads) {
        const int lp = i / CPP;
        const int c8 = i - lp * CPP;
        const int h = c.h0 + lp / kSeg;
        const int w = c.w0 + lp % kSeg;
        const bool ok = h < height && w < width;
        const bf16* src =
            ok ? x + (((long long)c.b * height + h) * width + w) * C + c8 * 8
               : x;
        cp_async16(smem_u32(io + lp * S::XS + c8 * 8), src, ok);
      }
    }
    if (first)
      for (int i = threadIdx.x; i < S::kFragVecs; i += kTileThreads)
        cp_async16(smem_u32(wsm + i), wfrag + i, true);
  };

  Cursor ld{(int)blockIdx.x, 0, 0, 0, 0, 0};  // the next unit to load
  enter_tile(ld);
  Cursor cu = ld;                              // the unit to compute
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_units) {
      load_unit(ld, s == 0);
      advance(ld);
    }
    cp_async_commit();
  }

  // this warp's pixels of the tile: row rr, columns col0 .. col0 + kWarpPix - 1
  const int rr = warp / (kSeg / kWarpPix);
  const int col0 = (warp % (kSeg / kWarpPix)) * kWarpPix;
  float acc[kMt][S::NT][4];  // the current branch
  float run[kMt][S::NT][4];  // add1 .. add4
  for (int u = 0; u < n_units; ++u) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // unit u has landed; every warp is done with u - 1
    if (u + kStages - 1 < n_units) {
      load_unit(ld, false);
      advance(ld);
    }
    cp_async_commit();

    const int unit = cu.unit;
    const int br = unit / 3;
    const int dyi = unit - br * 3;
    const int d = 1 << br;
    if (dyi == 0) {
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][nt][e] = 0.f;
            if (unit == 0) run[mt][nt][e] = 0.f;
          }
    }
    const bool active = cu.h0 + rr < height && cu.w0 + col0 < width;
    if (active) {
      const unsigned char* band = bands + cu.stage * S::kBandBytes;
#pragma unroll
      for (int dxi = 0; dxi < 3; ++dxi) {
        // band pixel of this lane's ldmatrix row: column col0 + i + dx + d
        const int q = rr * kBandPix + col0 + (lane & 15) + dxi * d;
        const uint4* wt = wsm + (br * 9 + dyi * 3 + dxi) * S::KS * (S::NT / 2)
                              * 32 + lane;
#pragma unroll
        for (int ks = 0; ks < S::KS; ++ks) {
          uint32_t a[kMt][4];
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt)
            ldmatrix_x4(a[mt], smem_u32(band + band_chunk<S::CH>(
                                                   q + mt * 16,
                                                   ks * 2 + (lane >> 4)) *
                                                   16));
#pragma unroll
          for (int pair = 0; pair < S::NT / 2; ++pair) {
            const uint4 bv = wt[(ks * (S::NT / 2) + pair) * 32];
#pragma unroll
            for (int mt = 0; mt < kMt; ++mt) {
              mma_bf16(acc[mt][2 * pair], a[mt], bv.x, bv.y);
              mma_bf16(acc[mt][2 * pair + 1], a[mt], bv.z, bv.w);
            }
          }
        }
      }
      if (dyi == 2) {
        // this branch's slice of the concat: d1 -> [0, n1); addk -> n1+(k-1)n.
        // Branch-free, so that the shared-memory loads of all 32 values
        // go out together: a column past the slice reads the pixel row's
        // padding (c0 + NP <= C + 8 for every width mma_width takes) and the
        // last channel's parameters, and is not stored.
        const int c0 = br == 0 ? 0 : n1 + (br - 1) * n;
        const int width_out = br == 0 ? n1 : n;
        bf16* px = io + (rr * kSeg + col0 + g) * S::XS + c0 + t2;
        float res[kMt][S::NT][4];
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              res[mt][nt][e] =
                  add_residual
                      ? __bfloat162float(px[(mt * 16 + (e >> 1) * 8) * S::XS +
                                            nt * 8 + (e & 1)])
                      : 0.f;
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            // one channel: rows g and g + 8 of both m tiles
            const int col = nt * 8 + t2 + e1;
            const int ch = min(c0 + col, C - 1);
            const float sc = prm[ch];
            const float bi = prm[C + ch];
            const float al = prm[2 * C + ch];
#pragma unroll
            for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int e = half * 2 + e1;
                float v = acc[mt][nt][e];
                if (br > 0) {
                  run[mt][nt][e] += v;
                  v = run[mt][nt][e];
                }
                v = (v + res[mt][nt][e]) * sc + bi;
                v = v > 0.f ? v : al * v;
                if (col < width_out)
                  px[(mt * 16 + half * 8) * S::XS + nt * 8 + e1] =
                      __float2bfloat16_rn(v);
              }
          }
      }
    }
    if (unit == kUnits - 1) {
      __syncthreads();  // the whole tile is finished in io
      for (int i = threadIdx.x; i < kRows * kSeg * CPP; i += kTileThreads) {
        const int lp = i / CPP;
        const int c8 = i - lp * CPP;
        const int h = cu.h0 + lp / kSeg;
        const int w = cu.w0 + lp % kSeg;
        if (h < height && w < width)
          *reinterpret_cast<uint4*>(
              y + (((long long)cu.b * height + h) * width + w) * C + c8 * 8) =
              *reinterpret_cast<const uint4*>(io + lp * S::XS + c8 * 8);
      }
    }
    advance(cu);
  }
  cp_async_wait<0>();
}

template <int C, int KP, int NP>
long long mma_scratch_bytes(long long n_pixels) {
  // r (B, H, W, KP) bf16, then the fragment-ordered wd, 256-byte aligned
  return (n_pixels * KP * 2 + 255) / 256 * 256 + Mma<C, KP, NP>::kWeightBytes;
}

template <int C, int KP, int NP>
cudaError_t launch_mma(const void* x, const void* w1, const void* wd,
                       const float* scale, const float* bias,
                       const float* alpha, void* scratch, void* y, int batch,
                       int height, int width, int n, int n1, int n_pad,
                       int add_residual, cudaStream_t stream) {
  using S = Mma<C, KP, NP>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long n_pixels = (long long)batch * height * width;
  bf16* r = static_cast<bf16*>(scratch);
  uint32_t* wfrag = reinterpret_cast<uint32_t*>(
      static_cast<unsigned char*>(scratch) +
      (mma_scratch_bytes<C, KP, NP>(n_pixels) - S::kWeightBytes));

  err = cudaFuncSetAttribute(esp_reduce_mma_kernel<C, KP, NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::kReduceSmem);
  if (err != cudaSuccess) return err;
  const long long reduce_tiles = (n_pixels + kReduceTile - 1) / kReduceTile;
  const unsigned grid_a =
      (unsigned)(reduce_tiles < 2LL * sms ? reduce_tiles : 2LL * sms);
  esp_reduce_mma_kernel<C, KP, NP><<<grid_a, kMmaThreads, S::kReduceSmem,
                                     stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(wd), wfrag, r, n_pixels, n, n1, n_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(esp_branch_mma_kernel<C, KP, NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::kBranchSmem);
  if (err != cudaSuccess) return err;
  const int tiles = batch * ((height + kRows - 1) / kRows) *
                    ((width + kSeg - 1) / kSeg);
  const unsigned grid_b = (unsigned)(tiles < sms ? tiles : sms);
  esp_branch_mma_kernel<C, KP, NP><<<grid_b, kTileThreads, S::kBranchSmem,
                                     stream>>>(
      static_cast<const bf16*>(x), r, reinterpret_cast<const uint4*>(wfrag),
      scale, bias, alpha, static_cast<bf16*>(y), batch, height, width, n, n1,
      add_residual);
  return cudaGetLastError();
}

// The bf16 widths this library is compiled for: 1 -> C=128, n <= 32 (ESPNet
// level 3: n=25, n1=28); 2 -> C=64, n <= 16 (level 2: n=12, n1=16); 0 none.
int mma_width(int c, int n, int n_pad) {
  if (c == 128 && n <= 32 && n_pad <= 32) return 1;
  if (c == 64 && n <= 16 && n_pad <= 16) return 2;
  return 0;
}

}  // namespace

extern "C" {

// Bytes of scratch esp_block_forward needs for this call, or -1 when the
// library is not compiled for the width (f32: n_pad rounded up to 4 must be
// 16 or 28; bf16: see mma_width).
long long esp_block_scratch_bytes(int batch, int height, int width, int c,
                                  int n, int n_pad, int is_bf16) {
  const long long n_pixels = (long long)batch * height * width;
  if (!is_bf16) {
    const int np4 = (n_pad + 3) / 4 * 4;
    return np4 == 16 || np4 == 28 ? n_pixels * n * 4 : -1;
  }
  switch (mma_width(c, n, n_pad)) {
    case 1:
      return mma_scratch_bytes<128, 32, 32>(n_pixels);
    case 2:
      return mma_scratch_bytes<64, 16, 16>(n_pixels);
    default:
      return -1;
  }
}

// Launches both passes on `stream`; returns cudaGetLastError() (0 on success).
// `scratch` holds esp_block_scratch_bytes(...) bytes, 256-byte aligned.
// is_bf16 selects the type of x, w1, wd and y (bf16 when nonzero, f32
// otherwise); bf16 needs x 16-byte aligned.
int esp_block_forward(const void* x, const void* w1, const void* wd,
                      const void* scale, const void* bias, const void* alpha,
                      void* scratch, void* y, int batch, int height, int width,
                      int c, int n, int n1, int n_pad, int add_residual,
                      int is_bf16, void* stream) {
  if ((long long)batch * height * width == 0) return 0;
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* a = static_cast<const float*>(alpha);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return (int)launch_all<float>(x, w1, wd, s, bi, a, scratch, y, batch,
                                  height, width, c, n, n1, n_pad, add_residual,
                                  st);
  switch (mma_width(c, n, n_pad)) {
    case 1:
      return (int)launch_mma<128, 32, 32>(x, w1, wd, s, bi, a, scratch, y,
                                          batch, height, width, n, n1, n_pad,
                                          add_residual, st);
    case 2:
      return (int)launch_mma<64, 16, 16>(x, w1, wd, s, bi, a, scratch, y,
                                         batch, height, width, n, n1, n_pad,
                                         add_residual, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
