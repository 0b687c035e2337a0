// Fused ESP residual block on the padded layout, over groups (K2), inference.
//
// Replaces the Pallas TPU kernel glomeruli_segmentation_tpu/ops/pallas/
// esp_block.py::_esp_kernel_dma (called through _esp_dma_call and
// esp_block_fused_dma).  Same function as K1 (csrc/esp_block.cu):
//   r    = x @ w1                       1x1 reduce C -> n, f32 sums, rounded
//                                       to the activation type
//   d_i  = dilated 3x3 conv of r        d = 1, 2, 4, 8, 16 (d1 is n1 wide),
//                                       zero padding, f32 sums
//   cat  = [d1, d2, d2+d4, d2+d4+d8, d2+d4+d8+d16]   (C = n1 + 4n channels)
//   y    = prelu((cat + x) * scale + bias, alpha)     in f32, cast to x's type
// on the padded layout: x and y are (B, H, W + 2*HALO, C_pad), contiguous,
// with HALO = 16 zero columns on each side and C_pad >= C.  The output's
// halo columns and pad channels are written as zeros, so blocks chain on
// this layout.  The input's pad channels are not read, and neither are its
// halo columns: they are zero by contract, so r there is zero, and the
// branch passes take it as zero padding without reducing it.
//
// Groups.  The fold-packed level 2 is G independent blocks side by side
// (G folds of C=64, n=12, n1=16), whose dense weights are block-diagonal.
// K2 takes the G diagonal blocks only (ops/esp_block.py::pack_esp_groups,
// run once when the model is built): w1 (G, 64, n) and wd (G, 5, 9n, np),
// np = max(n, n1), per group, of x's type; scale, bias and alpha stay (C,)
// f32.  Group f's channels follow the packed engine's part-major concat:
// local channel lc < n1 (its d1) is channel f*n1 + lc, and local channel
// n1 + k*n + j (its add_{k+1}) is channel G*n1 + k*G*n + f*n + j.  Its r
// channels are f*n .. f*n + n - 1 of the dense reduce; here r is a
// (B, H, W, G*16) scratch, group f at [f*16, f*16 + 16), channels n..15
// exact zeros.  Dense operands are one group.
//
// What bounds it on an H100: at the main-path shape (the fold-packed level
// 2: B=32, 128x256, C=320 padded to 384, G=5, n=60, n1=80) one call must
// move 1.578 GB in bf16 (x's logical pixels in, the padded y out, the
// weights: 0.471 ms at 3.35 TB/s) and does 80.5 GFLOP of per-group products
// (2 * pixels * G * (64*12 + 9*12*64): 0.08 ms on bf16 tensor cores; the
// dense block-diagonal products would be 402.7 GFLOP), so it is bound by
// bytes.  This design reads x twice (reduce, residual) and writes and reads
// r (168 MB), about 2.7 GB in all, and each group's block reads and writes
// its pixels' 64 channels as five runs of 32 or 24 bytes, which cost more
// than their bytes (PERF.md has the measured split).
//
// Three kernels on the caller's stream in both types: esp_dma_pad_kernel
// writes y's halo columns and pad channels (zeros, one block per image
// row), then the two passes.
//
// bf16, the production path: every product is a tensor-core
// mma.sync.m16n8k16 (bf16 operands, f32 sums), fed by ldmatrix from shared
// memory that cp.async fills (primitives in mma_bf16.cuh, shared with K1).
//   pass A (esp_dma_reduce_mma_kernel): persistent blocks of 8 warps stream
//     128-pixel tiles of x's logical channels through shared memory
//     (double-buffered, a warp a pixel and a lane a 16-byte chunk).  The
//     reduce runs over the dense C channels in k16 steps, but a group
//     multiplies only the k steps that hold its own channels (7 of 20 at
//     C=320), so the zero cross-group blocks are skipped; the B fragments
//     (51 KB at C=320) sit in shared memory.  The same blocks lay each
//     group's wd out in mma fragment order in a scratch.
//   pass B (esp_dma_branch_mma_kernel): K1's banded implicit GEMM at K1's
//     C=64 width (Mma<64, 16, 16>), one group per block.  A block walks one
//     64-column strip of one image down its rows, 4 rows a step, and holds
//     its group's 45 taps (23 KB) and a ring of 40 rows of the group's 16 r
//     channels (96 pixels each: the strip and 16 on each side; 123 KB) in
//     shared memory.  Each r row is loaded once (cp.async, rows and
//     columns outside the image zero-filled, 16-byte chunks XOR-swizzled),
//     the next step's 4 rows while this step's are multiplied; the three dx
//     taps of a row are ldmatrix reads at offsets -d, 0, +d.  A warp owns
//     32 pixels of a row and all 16 outputs: the branch accumulator and
//     add1..add4 stay in registers.  Its residual values are loaded from x
//     at the start of the step; each branch's slice is finished in
//     registers (residual, affine, PReLU in f32, one rounding) and stored
//     as channel pairs to the part-major channels.  The groups of a strip
//     are neighbours in the grid, so that they walk the same rows of x and
//     y at about the same time.
//
// f32, the "highest" parity path: CUDA cores, so that no operand is rounded
// to TF32; both passes over a grid of (pixel blocks, groups), so only the
// diagonal blocks are multiplied.
//   pass A (esp_dma_reduce_kernel): a thread owns one pixel and its group's
//     n reduce outputs; the block stages 32-channel chunks of the group's
//     channels of x and of w1 in shared memory.
//   pass B (esp_dma_branch_kernel): a thread owns one pixel of its group
//     and the group's outputs of every branch; the block stages each
//     branch's (9n, 16) group slab of taps in shared memory, the running
//     sum add1..add4 stays in registers, and each slice of the concat is
//     finished (residual, affine, PReLU) as soon as it is complete.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // cp.async, ldmatrix, mma.sync, band_chunk

namespace {

constexpr int kHalo = 16;       // zero columns on each side; the largest d
constexpr int kGroupCh = 64;    // channels of one group (n1 + 4n)
constexpr int kRP = 16;         // r channels of one group: n padded to 16
constexpr int kMaxGroups = 5;   // pass A's fragments and accumulators

// Channel of local channel lc of group f in the part-major layout.
__device__ __forceinline__ int group_channel(int f, int lc, int groups,
                                             int n, int n1) {
  if (lc < n1) return f * n1 + lc;
  const int t = lc - n1;
  const int k = t / n;
  return groups * n1 + k * groups * n + f * n + (t - k * n);
}

// The group and local channel of channel ch (inverse of group_channel).
__device__ __forceinline__ void channel_group(int ch, int groups, int n,
                                              int n1, int& f, int& lc) {
  if (ch < groups * n1) {
    f = ch / n1;
    lc = ch - f * n1;
    return;
  }
  const int t = ch - groups * n1;
  const int k = t / (groups * n);
  const int rem = t - k * groups * n;
  f = rem / n;
  lc = n1 + k * n + rem - f * n;
}

// y's halo columns (every channel) and pad channels (channels >= C of the
// other pixels) as zeros, 16-byte stores: one block per image row, `cp`
// 16-byte chunks a pixel, `cc` of them logical.
__global__ void __launch_bounds__(256)
    esp_dma_pad_kernel(uint4* __restrict__ y, int width, int cp, int cc) {
  const int wp = width + 2 * kHalo;
  uint4* yr = y + (long long)blockIdx.x * wp * cp;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < kHalo * cp; i += blockDim.x) {
    yr[i] = zero;                         // the left halo, contiguous
    yr[(kHalo + width) * cp + i] = zero;  // the right one
  }
  const int pad = cp - cc;
  for (int i = threadIdx.x; i < width * pad; i += blockDim.x) {
    const int w = i / pad;
    yr[(kHalo + w) * cp + cc + (i - w * pad)] = zero;
  }
}

// ---------------- the f32 path: CUDA cores ----------------
constexpr int kThreads = 256;  // pixels of a block, in both passes
constexpr int kChunk = 32;     // local channels of x staged per step

// Pass A: r[p, f*16 + o] = sum_lc x[p, ch(f, lc)] * w1[f, lc, o]; the
// grid's second axis is the group.
__global__ void __launch_bounds__(kThreads)
    esp_dma_reduce_kernel(const float* __restrict__ x,
                          const float* __restrict__ w1,
                          float* __restrict__ r, int batch, int height,
                          int width, int c_pad, int groups, int n, int n1) {
  __shared__ float xs[kThreads][kChunk + 1];  // odd stride: no bank conflicts
  __shared__ __align__(16) float ws[kChunk][kRP];
  const int n_pixels = batch * height * width;
  const int wp = width + 2 * kHalo;
  const int p0 = blockIdx.x * kThreads;
  const int pixels = min(n_pixels - p0, kThreads);
  const int f = blockIdx.y;
  const int t = threadIdx.x;

  float acc[kRP];
#pragma unroll
  for (int o = 0; o < kRP; ++o) acc[o] = 0.f;
  for (int c0 = 0; c0 < kGroupCh; c0 += kChunk) {
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = t; i < pixels * kChunk; i += kThreads) {
      const int p = i / kChunk;
      const int cc = i - p * kChunk;
      const int pix = p0 + p;
      const int row = pix / width;
      const int w = pix - row * width;
      xs[p][cc] = x[((long long)row * wp + kHalo + w) * c_pad +
                    group_channel(f, c0 + cc, groups, n, n1)];
    }
    for (int i = t; i < kChunk * kRP; i += kThreads) {
      const int cc = i / kRP;
      const int o = i - cc * kRP;
      ws[cc][o] = o < n ? w1[((long long)f * kGroupCh + c0 + cc) * n + o]
                        : 0.f;
    }
    __syncthreads();
    if (t < pixels) {
      for (int cc = 0; cc < kChunk; ++cc) {
        const float v = xs[t][cc];
        const float4* wrow = reinterpret_cast<const float4*>(ws[cc]);
#pragma unroll
        for (int q = 0; q < kRP / 4; ++q) {
          const float4 wv = wrow[q];
          acc[4 * q + 0] = fmaf(v, wv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v, wv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, wv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, wv.w, acc[4 * q + 3]);
        }
      }
    }
  }
  if (t < pixels) {
    float* rp = r + ((long long)(p0 + t) * groups + f) * kRP;
#pragma unroll
    for (int o = 0; o < kRP; ++o)
      if (o < n) rp[o] = acc[o];
  }
}

// Pass B: group f's outputs of the five dilated branches, the hierarchical
// adds, residual, affine and PReLU, at the pixels inside the halo.
__global__ void __launch_bounds__(kThreads)
    esp_dma_branch_kernel(const float* __restrict__ x,
                          const float* __restrict__ r,
                          const float* __restrict__ wd,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          const float* __restrict__ alpha,
                          float* __restrict__ y, int batch, int height,
                          int width, int c_pad, int groups, int n, int n1,
                          int np, int add_residual) {
  extern __shared__ float4 wsm[];  // [9n][kRP / 4]: one branch, f32
  float* wsf = reinterpret_cast<float*>(wsm);
  const int wp = width + 2 * kHalo;
  const int n_pixels = batch * height * width;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = pix < n_pixels;
  const int f = blockIdx.y;
  int b = 0, h = 0, w = 0;
  if (valid) {
    w = pix % width;
    const int t = pix / width;
    h = t % height;
    b = t / height;
  }
  const long long pp = ((long long)b * height + h) * wp + w + kHalo;
  const float* xp = x + pp * c_pad;
  float* yp = y + pp * c_pad;

  float run[kRP];  // add1 .. add4, branch to branch
#pragma unroll
  for (int o = 0; o < kRP; ++o) run[o] = 0.f;

  for (int br = 0; br < 5; ++br) {
    const int width_out = br == 0 ? n1 : n;
    __syncthreads();  // every thread is done with the previous slab
    const float* wb = wd + ((long long)f * 5 + br) * 9 * n * np;
    for (int i = threadIdx.x; i < 9 * n * kRP; i += kThreads) {
      const int row = i / kRP;
      const int o = i - row * kRP;
      wsf[i] = o < width_out ? wb[(long long)row * np + o] : 0.f;
    }
    __syncthreads();
    if (!valid) continue;

    const int d = 1 << br;
    float acc[kRP];
#pragma unroll
    for (int o = 0; o < kRP; ++o) acc[o] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int hh = h + (tap / 3 - 1) * d;
      const int ww = w + (tap % 3 - 1) * d;
      if (hh < 0 || hh >= height || ww < 0 || ww >= width) continue;
      // the group's r at the tap, four channels a load (n % 4 == 0)
      const float4* rp = reinterpret_cast<const float4*>(
          r + ((((long long)b * height + hh) * width + ww) * groups + f) *
                  kRP);
      const float4* wrow = wsm + tap * n * (kRP / 4);
      for (int k4 = 0; k4 < n / 4; ++k4) {
        const float4 v4 = rp[k4];
        const float vs[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float v = vs[kk];
#pragma unroll
          for (int q = 0; q < kRP / 4; ++q) {
            const float4 wv = wrow[(k4 * 4 + kk) * (kRP / 4) + q];
            acc[4 * q + 0] = fmaf(v, wv.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(v, wv.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(v, wv.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(v, wv.w, acc[4 * q + 3]);
          }
        }
      }
    }

    // this branch's slice of the group's concat: d1 -> [0, n1); addk ->
    // n1 + (k-1)n; then to the part-major channel
    const int c0 = br == 0 ? 0 : n1 + (br - 1) * n;
#pragma unroll
    for (int o = 0; o < kRP; ++o) {
      if (br > 0) run[o] += acc[o];
      if (o < width_out) {
        const int ch = group_channel(f, c0 + o, groups, n, n1);
        float v = br == 0 ? acc[o] : run[o];
        if (add_residual) v += xp[ch];
        v = v * scale[ch] + bias[ch];
        v = v > 0.f ? v : alpha[ch] * v;
        yp[ch] = v;
      }
    }
  }
}

cudaError_t launch_f32(const float* x, const float* w1, const float* wd,
                       const float* scale, const float* bias,
                       const float* alpha, float* r, float* y, int batch,
                       int height, int width, int c, int c_pad, int groups,
                       int n, int n1, int np, int add_residual,
                       cudaStream_t stream) {
  const long long pixels = (long long)batch * height * width;
  esp_dma_pad_kernel<<<batch * height, 256, 0, stream>>>(
      reinterpret_cast<uint4*>(y), width, c_pad / 4, c / 4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((pixels + kThreads - 1) / kThreads),
                  (unsigned)groups);
  esp_dma_reduce_kernel<<<grid, kThreads, 0, stream>>>(
      x, w1, r, batch, height, width, c_pad, groups, n, n1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  esp_dma_branch_kernel<<<grid, kThreads, (size_t)9 * n * kRP * 4, stream>>>(
      x, r, wd, scale, bias, alpha, y, batch, height, width, c_pad, groups, n,
      n1, np, add_residual);
  return cudaGetLastError();
}

// ---------------- the bf16 path: tensor cores ----------------
constexpr int kRedTile = 128;    // pass A tile: 16 pixels a warp
constexpr int kRedThreads = 256;
constexpr int kRedStages = 2;    // depth of its ring of x tiles
constexpr int kSeg = 64;         // pass B strip: kSeg columns ...
constexpr int kStep = 4;         // ... walked kStep image rows a step
constexpr int kMt = 2;           // m16 tiles of a pass-B warp, all in one row
constexpr int kWarpPix = 16 * kMt;
constexpr int kStripThreads = kStep * kSeg / kWarpPix * 32;
constexpr int kRingPix = kSeg + 2 * kHalo;  // r pixels of a ring row
// rows h0 - 16 .. h0 + kStep + 15 for the current step, and kStep more
// for the next one, loading meanwhile
constexpr int kRing = 2 * kHalo + 2 * kStep;
constexpr int kCH = kRP / 8;     // 16-byte chunks of one group's r pixel
constexpr int kNT = kRP / 8;     // n8 tiles of a branch's outputs
constexpr int kFragVecs = 45 * (kNT / 2) * 32;  // one group's taps, uint4
constexpr int kWeightBytes = kFragVecs * 16;
constexpr int kRingRowBytes = kRingPix * kRP * 2;
constexpr int kBranchSmem =
    kWeightBytes + kRing * kRingRowBytes + 3 * kGroupCh * 4;

// Pass A: r = x @ w1 per group on tensor cores, rounded to bf16, channels
// n..15 of each group zero; and wd in fragment order.
__global__ void __launch_bounds__(kRedThreads, 1)
    esp_dma_reduce_mma_kernel(const bf16* __restrict__ x,
                              const bf16* __restrict__ w1,
                              const bf16* __restrict__ wd,
                              uint32_t* __restrict__ wfrag,
                              bf16* __restrict__ r, int batch, int height,
                              int width, int c, int c_pad, int groups, int n,
                              int n1, int np) {
  extern __shared__ uint4 mma_smem[];
  __shared__ uint32_t used_s[kMaxGroups];  // k16 steps holding a group's x
  const int ksa = c / 16;
  uint4* bfr = mma_smem;  // [ksa][groups][32] B fragments of the reduce
  const int xs_stride = c + 8;  // 8 rows of an ldmatrix in 8 bank groups
  bf16* xs = reinterpret_cast<bf16*>(mma_smem + ksa * groups * 32);
  const int wp = width + 2 * kHalo;
  const int n_pixels = batch * height * width;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // wd (G, 5, 9n, np) -> per group, B fragments of every (branch, tap) and
  // the pair of n8 tiles, one uint4 per lane: {tile 0: k rows 2t..2t+1,
  // 2t+8..2t+9; tile 1: the same}, column g = lane / 4, t = lane % 4.  K
  // beyond n and columns beyond the branch's width are zero.
  const int frag_words = groups * kFragVecs * 4;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < frag_words;
       i += gridDim.x * blockDim.x) {
    const int word = i & 3;
    const int fl = (i >> 2) & 31;
    const int gbt = i >> 7;  // group * 45 + branch * 9 + tap
    const int br = (gbt % 45) / 9;
    const int col = (word >> 1) * 8 + (fl >> 2);
    const int k = (word & 1) * 8 + (fl & 3) * 2;
    const bool live = col < (br == 0 ? n1 : n);
    const bf16* src = wd + ((long long)gbt * n + k) * np + col;
    wfrag[i] = pack_bf16(live && k < n ? src[0] : zero,
                         live && k + 1 < n ? src[np] : zero);
  }

  if (threadIdx.x < kMaxGroups) used_s[threadIdx.x] = 0;
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    int f, lc;
    channel_group(ch, groups, n, n1, f, lc);
    atomicOr(&used_s[f], 1u << (ch >> 4));
  }
  // the reduce's B fragments: element (channel k, column f*n + col) of the
  // dense block-diagonal w1, zero outside group f's block
  for (int i = threadIdx.x; i < ksa * groups * 32 * 4; i += blockDim.x) {
    const int word = i & 3;
    const int fl = (i >> 2) & 31;
    const int rest = i >> 7;
    const int f = rest % groups;
    const int ks = rest / groups;
    const int col = (word >> 1) * 8 + (fl >> 2);
    const int k = ks * 16 + (word & 1) * 8 + (fl & 3) * 2;
    bf16 v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int fk, lc;
      channel_group(k + j, groups, n, n1, fk, lc);
      v[j] = fk == f && col < n
                 ? w1[((long long)f * kGroupCh + lc) * n + col]
                 : zero;
    }
    reinterpret_cast<uint32_t*>(bfr)[i] = pack_bf16(v[0], v[1]);
  }
  __syncthreads();
  uint32_t used[kMaxGroups];
#pragma unroll
  for (int f = 0; f < kMaxGroups; ++f) used[f] = used_s[f];

  const int cpp = c / 8;  // 16-byte chunks of a pixel's logical channels
  const int n_tiles = (n_pixels + kRedTile - 1) / kRedTile;
  auto load = [&](int tile, int buf) {  // a warp a pixel, a lane a chunk
    bf16* dst = xs + buf * kRedTile * xs_stride;
    for (int p = warp; p < kRedTile; p += kRedThreads / 32) {
      const int pix = tile * kRedTile + p;
      const bool ok = pix < n_pixels;
      const int row = pix / width;
      const bf16* src =
          x + ((long long)row * wp + kHalo + pix - row * width) * c_pad;
      for (int c8 = lane; c8 < cpp; c8 += 32)
        cp_async16(smem_u32(dst + p * xs_stride + c8 * 8),
                   ok ? src + c8 * 8 : x, ok);
    }
  };

  for (int s = 0; s < kRedStages - 1; ++s) {
    const int tile = blockIdx.x + s * gridDim.x;
    if (tile < n_tiles) load(tile, s);
    cp_async_commit();
  }
  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    cp_async_wait<kRedStages - 2>();
    __syncthreads();  // this tile has landed; every warp is done with the last
    const int ahead = tile + (kRedStages - 1) * gridDim.x;
    if (ahead < n_tiles) load(ahead, buf == 0 ? kRedStages - 1 : buf - 1);
    cp_async_commit();
    const bf16* src = xs + buf * kRedTile * xs_stride;
    float acc[kMaxGroups][2][4] = {};
#pragma unroll 20  // all of them: ksa <= 20 (C <= kMaxGroups * 64)
    for (int ks = 0; ks < ksa; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(src + (warp * 16 + (lane & 15)) * xs_stride +
                              ks * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int f = 0; f < kMaxGroups; ++f) {
        if (f < groups && ((used[f] >> ks) & 1u)) {
          const uint4 bv = bfr[(ks * groups + f) * 32 + lane];
          mma_bf16(acc[f][0], a, bv.x, bv.y);
          mma_bf16(acc[f][1], a, bv.z, bv.w);
        }
      }
    }
    const int p0 = tile * kRedTile + warp * 16 + g;
#pragma unroll
    for (int f = 0; f < kMaxGroups; ++f) {
      if (f >= groups) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = nt * 8 + t2;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pix = p0 + half * 8;
          if (pix >= n_pixels) continue;
          const float v0 = col < n ? acc[f][nt][2 * half] : 0.f;
          const float v1 = col + 1 < n ? acc[f][nt][2 * half + 1] : 0.f;
          *reinterpret_cast<uint32_t*>(
              r + ((long long)pix * groups + f) * kRP + col) =
              pack_bf16(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
        }
      }
    }
    buf = buf + 1 == kRedStages ? 0 : buf + 1;
  }
  cp_async_wait<0>();
}

// Pass B: the five dilated branches of one group as an implicit GEMM on
// tensor cores, hierarchical adds, residual, affine and PReLU.  A block
// walks one kSeg-column strip of one image down its rows, kStep rows a
// step, for one group; r's rows live in a ring in shared memory, each
// loaded once (rows and columns outside the image zero-filled), and the
// next step's rows load while this step's are multiplied.
__global__ void __launch_bounds__(kStripThreads, 1)
    esp_dma_branch_mma_kernel(const bf16* __restrict__ x,
                              const bf16* __restrict__ r,
                              const uint4* __restrict__ wfrag,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              const float* __restrict__ alpha,
                              bf16* __restrict__ y, int batch, int height,
                              int width, int c_pad, int groups, int n,
                              int n1, int add_residual) {
  extern __shared__ uint4 mma_smem[];
  uint4* wsm = mma_smem;  // [45][32] B fragments of this group
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(mma_smem) + kWeightBytes;
  float* prm = reinterpret_cast<float*>(
      ring + kRing * kRingRowBytes);  // scale | bias | alpha, local order

  // the groups of one strip are neighbours in the grid, so that they walk
  // the same rows of x and y at about the same time
  const int f = blockIdx.x % groups;
  const int strips = (width + kSeg - 1) / kSeg;
  const int task = blockIdx.x / groups;
  const int b = task / strips;
  const int w0 = (task - b * strips) * kSeg;
  const int rs = groups * kRP;  // r's pixel stride
  const int wp = width + 2 * kHalo;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const int wr = warp / (kSeg / kWarpPix);               // row in the step
  const int col0 = (warp % (kSeg / kWarpPix)) * kWarpPix;
  wfrag += f * kFragVecs;

  for (int i = threadIdx.x; i < kFragVecs; i += kStripThreads)
    cp_async16(smem_u32(wsm + i), wfrag + i, true);
  for (int i = threadIdx.x; i < kGroupCh; i += kStripThreads) {
    const int ch = group_channel(f, i, groups, n, n1);
    prm[i] = scale[ch];
    prm[kGroupCh + i] = bias[ch];
    prm[2 * kGroupCh + i] = alpha[ch];
  }
  // this lane's channel pair of each branch and n8 tile (-1: past the
  // branch's width)
  int chan[5][kNT];
#pragma unroll
  for (int br = 0; br < 5; ++br)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = nt * 8 + t2;
      const int c0 = br == 0 ? 0 : n1 + (br - 1) * n;
      chan[br][nt] = col < (br == 0 ? n1 : n)
                         ? group_channel(f, c0 + col, groups, n, n1)
                         : -1;
    }

  // rows [first, first + count) of r into the ring, slot (row + 16) % kRing
  auto load_rows = [&](int first, int count) {
    for (int i = threadIdx.x; i < count * kRingPix * kCH;
         i += kStripThreads) {
      const int rr = i / (kRingPix * kCH);
      const int rest = i - rr * kRingPix * kCH;
      const int j = rest / kCH;
      const int k8 = rest - j * kCH;
      const int hr = first + rr;
      const int ws = w0 - kHalo + j;
      const bool ok = hr >= 0 && hr < height && ws >= 0 && ws < width;
      cp_async16(smem_u32(ring + ((hr + kHalo) % kRing) * kRingRowBytes +
                          band_chunk<kCH>(j, k8) * 16),
                 ok ? r + (((long long)b * height + hr) * width + ws) * rs +
                          f * kRP + k8 * 8
                    : r,
                 ok);
    }
  };
  load_rows(-kHalo, kStep + 2 * kHalo);
  cp_async_commit();

  for (int h0 = 0; h0 < height; h0 += kStep) {
    cp_async_wait<0>();
    __syncthreads();  // this step's rows have landed; the last step is done
    if (h0 + kStep < height) load_rows(h0 + kStep + kHalo, kStep);
    cp_async_commit();

    const int h = h0 + wr;
    if (h >= height || w0 + col0 >= width) continue;
    // this lane's pixels: columns w0 + col0 + mt*16 + half*8 + g
    long long base[kMt][2];
    bool live[kMt][2];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = w0 + col0 + mt * 16 + half * 8 + g;
        live[mt][half] = w < width;
        base[mt][half] =
            (((long long)b * height + h) * wp + kHalo + w) * c_pad;
      }
    // the residual of every branch's slice, loaded now, used at its end
    uint32_t res[5][kNT][kMt][2];
#pragma unroll
    for (int br = 0; br < 5; ++br)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            res[br][nt][mt][half] =
                add_residual && chan[br][nt] >= 0 && live[mt][half]
                    ? *reinterpret_cast<const uint32_t*>(
                          x + base[mt][half] + chan[br][nt])
                    : 0u;

    float run[kMt][kNT][4] = {};  // add1 .. add4
#pragma unroll
    for (int br = 0; br < 5; ++br) {
      const int d = 1 << br;
      float acc[kMt][kNT][4] = {};
#pragma unroll
      for (int dyi = 0; dyi < 3; ++dyi) {
        const unsigned char* row =
            ring + ((h + (dyi - 1) * d + kHalo) % kRing) * kRingRowBytes;
#pragma unroll
        for (int dxi = 0; dxi < 3; ++dxi) {
          // ring pixel of this lane's ldmatrix row: column
          // col0 + i + dx, 16 to the right of the strip's first
          const int q = col0 + (lane & 15) + kHalo + (dxi - 1) * d;
          const uint4 bv = wsm[(br * 9 + dyi * 3 + dxi) * 32 + lane];
          uint32_t a[kMt][4];
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt)
            ldmatrix_x4(a[mt], smem_u32(row + band_chunk<kCH>(
                                                  q + mt * 16, lane >> 4) *
                                                  16));
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt) {
            mma_bf16(acc[mt][0], a[mt], bv.x, bv.y);
            mma_bf16(acc[mt][1], a[mt], bv.z, bv.w);
          }
        }
      }
      // this branch's slice of the group's concat (d1 -> [0, n1); addk ->
      // n1 + (k-1)n) in f32, rounded once, to its part-major channels
      const int c0 = br == 0 ? 0 : n1 + (br - 1) * n;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (chan[br][nt] < 0) continue;
        const int lc = c0 + nt * 8 + t2;
        const float sc0 = prm[lc], sc1 = prm[lc + 1];
        const float bi0 = prm[kGroupCh + lc], bi1 = prm[kGroupCh + lc + 1];
        const float al0 = prm[2 * kGroupCh + lc];
        const float al1 = prm[2 * kGroupCh + lc + 1];
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float v0 = acc[mt][nt][half * 2];
            float v1 = acc[mt][nt][half * 2 + 1];
            if (br > 0) {
              run[mt][nt][half * 2] += v0;
              run[mt][nt][half * 2 + 1] += v1;
              v0 = run[mt][nt][half * 2];
              v1 = run[mt][nt][half * 2 + 1];
            }
            const uint32_t rv = res[br][nt][mt][half];
            v0 = (v0 + __bfloat162float(__ushort_as_bfloat16(
                           (unsigned short)(rv & 0xffffu)))) * sc0 + bi0;
            v1 = (v1 + __bfloat162float(__ushort_as_bfloat16(
                           (unsigned short)(rv >> 16)))) * sc1 + bi1;
            v0 = v0 > 0.f ? v0 : al0 * v0;
            v1 = v1 > 0.f ? v1 : al1 * v1;
            if (live[mt][half])
              *reinterpret_cast<uint32_t*>(y + base[mt][half] +
                                           chan[br][nt]) =
                  pack_bf16(__float2bfloat16_rn(v0),
                            __float2bfloat16_rn(v1));
          }
      }
    }
  }
  cp_async_wait<0>();
}

long long r_bytes(long long n_pixels, int groups, int elt) {
  return (n_pixels * groups * kRP * elt + 255) / 256 * 256;
}

cudaError_t launch_mma(const bf16* x, const bf16* w1, const bf16* wd,
                       const float* scale, const float* bias,
                       const float* alpha, void* scratch, bf16* y, int batch,
                       int height, int width, int c, int c_pad, int groups,
                       int n, int n1, int np, int add_residual,
                       cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long n_pixels = (long long)batch * height * width;
  esp_dma_pad_kernel<<<batch * height, 256, 0, stream>>>(
      reinterpret_cast<uint4*>(y), width, c_pad / 8, c / 8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bf16* r = static_cast<bf16*>(scratch);
  uint32_t* wfrag = reinterpret_cast<uint32_t*>(
      static_cast<unsigned char*>(scratch) + r_bytes(n_pixels, groups, 2));

  const int smem_a = (c / 16) * groups * 32 * 16 +
                     kRedStages * kRedTile * (c + 8) * 2;
  err = cudaFuncSetAttribute(esp_dma_reduce_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_a);
  if (err != cudaSuccess) return err;
  const int reduce_tiles = (int)((n_pixels + kRedTile - 1) / kRedTile);
  const unsigned grid_a = (unsigned)(reduce_tiles < sms ? reduce_tiles : sms);
  esp_dma_reduce_mma_kernel<<<grid_a, kRedThreads, smem_a, stream>>>(
      x, w1, wd, wfrag, r, batch, height, width, c, c_pad, groups, n, n1, np);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(esp_dma_branch_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBranchSmem);
  if (err != cudaSuccess) return err;
  const int strips = (width + kSeg - 1) / kSeg;
  esp_dma_branch_mma_kernel<<<(unsigned)(groups * batch * strips),
                              kStripThreads, kBranchSmem, stream>>>(
      x, r, reinterpret_cast<const uint4*>(wfrag), scale, bias, alpha, y,
      batch, height, width, c_pad, groups, n, n1, add_residual);
  return cudaGetLastError();
}

// The widths K2 is built for: 1 to kMaxGroups groups of ESPNet level 2
// (64 channels, n and n1 at most 16 and multiples of 4, C = 64 * groups).
bool widths_ok(int c, int c_pad, int groups, int n, int n1, int np) {
  return groups >= 1 && groups <= kMaxGroups && c == groups * kGroupCh &&
         n1 + 4 * n == kGroupCh && n >= 4 && n <= kRP && n1 >= 4 &&
         n1 <= kRP && n % 4 == 0 && n1 % 4 == 0 && np >= n && np >= n1 &&
         np <= kRP && c_pad >= c && c_pad % 8 == 0;
}

// 32-bit pixel and chunk indices: y must hold fewer than 2^31 16-byte
// chunks (34 GB), which also bounds the pixel count.
bool sizes_ok(int batch, int height, int width, int c_pad, int elt) {
  return (long long)batch * height * (width + 2 * kHalo) * c_pad * elt / 16 <
         (1LL << 31);
}

}  // namespace

extern "C" {

// Bytes of scratch esp_dma_forward needs for this call, or -1 when K2 is
// not built for the widths (see widths_ok).  n, n1 and np are per group.
long long esp_dma_scratch_bytes(int batch, int height, int width, int c,
                                int c_pad, int groups, int n, int n1, int np,
                                int is_bf16) {
  if (!widths_ok(c, c_pad, groups, n, n1, np) ||
      !sizes_ok(batch, height, width, c_pad, is_bf16 ? 2 : 4))
    return -1;
  const long long n_pixels = (long long)batch * height * width;
  return is_bf16 ? r_bytes(n_pixels, groups, 2) + (long long)groups *
                                                      kWeightBytes
                 : r_bytes(n_pixels, groups, 4);
}

// Launches both passes on `stream`; returns cudaGetLastError() (0 on
// success).  `width` is the logical width W (the rows hold W + 32 columns);
// w1 is (groups, 64, n), wd (groups, 5, 9n, np); `scratch` holds
// esp_dma_scratch_bytes(...) bytes, 256-byte aligned.  is_bf16 selects the
// type of x, w1, wd and y (bf16 when nonzero, f32 otherwise); x and y are
// 16-byte aligned.
int esp_dma_forward(const void* x, const void* w1, const void* wd,
                    const void* scale, const void* bias, const void* alpha,
                    void* scratch, void* y, int batch, int height, int width,
                    int c, int c_pad, int groups, int n, int n1, int np,
                    int add_residual, int is_bf16, void* stream) {
  if (!widths_ok(c, c_pad, groups, n, n1, np) ||
      !sizes_ok(batch, height, width, c_pad, is_bf16 ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  if ((long long)batch * height * width == 0) return 0;
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* a = static_cast<const float*>(alpha);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_mma(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
        static_cast<const bf16*>(wd), s, bi, a, scratch,
        static_cast<bf16*>(y), batch, height, width, c, c_pad, groups, n, n1,
        np, add_residual, st);
  return (int)launch_f32(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(wd), s, bi, a, static_cast<float*>(scratch),
      static_cast<float*>(y), batch, height, width, c, c_pad, groups, n, n1,
      np, add_residual, st);
}

}  // extern "C"
