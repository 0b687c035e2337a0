// Fused ESP residual block on the padded layout (K2), inference.
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
// this layout.  The input's pad channels are not read (the TPU kernel
// multiplies them by zero rows of w1); its halo columns are reduced like any
// other column, as the TPU kernel reduces its strips.  w1 is (C, n), wd
// (5, 9n, n_pad) with tap = (dy+1)*3 + (dx+1) over offsets (-d, 0, +d), both
// of x's type; scale, bias and alpha are (C,) f32.  Any wd is taken: no
// block-diagonal structure is assumed.
//
// What bounds it on an H100: at the main-path shape (the fold-packed level
// 2: B=32, 128x256, C=320 padded to 384, n=60, n1=80) one call moves
// 1.81 GB in bf16 (the padded x in, y out: 0.54 ms at 3.35 TB/s) and does
// 402.7 GFLOP (192,000 per pixel: 0.41 ms on bf16 tensor cores), so its
// bound is by bytes.  This first version does its products on the CUDA
// cores in f32, so it is bound by operations (FMA issue and the shared-
// memory weight reads that feed it), far above that bound.  Four fifths of
// the products multiply the zero cross-fold blocks of the packed weights;
// skipping them, and tensor cores (wgmma), are the work of a later version.
//
// Design, two passes on the caller's stream, both over a grid of
// (pixel blocks, groups of kGroup channels):
//   pass A (esp_dma_reduce_kernel): a thread owns one pixel of the padded
//     width and kGroup reduce outputs.  The block stages 32-channel chunks
//     of x for its 256 pixels and the matching (32, kGroup) slice of w1 in
//     shared memory (f32) and writes r, rounded to x's type, into a
//     (B, H, W + 2*HALO, n) scratch, halo columns included.  At the main-
//     path shape that scratch is 141 MB in bf16, more than the 50 MB L2,
//     so pass B's tap reads go to device memory.  The blocks of group 0
//     also write the constant parts of y: every channel of the halo
//     columns and the pad channels of the other pixels, all zero.
//   pass B (esp_dma_branch_kernel): a thread owns one pixel inside the halo
//     and kGroup output channels of every branch (groups of 20 divide both
//     n1 = 80 and n = 60).  The block walks the five branches in order; for
//     each it stages its (9n, kGroup) slice of the branch's taps in shared
//     memory as f32 (43 KB at n=60), and every thread accumulates in
//     registers, reading r through the cache.  The running sum add1..add4
//     is carried over the thread's channel slice, and each slice of the
//     concat is finished (residual, affine, PReLU) and written as soon as
//     it is complete.  The halo columns keep every horizontal tap inside
//     the row (|dx| <= 16 = HALO), so only vertical bounds are checked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kHalo = 16;
constexpr int kGroup = 20;      // channels a thread owns, in both passes
constexpr int kQ = kGroup / 4;  // float4s in one weight row of a group
constexpr int kThreads = 256;   // pixels of a block, in both passes
constexpr int kChunk = 32;      // x channels staged per step of pass A

// Pass A: r[p, k0 + o] = sum_c x[p, c] * w1[c, k0 + o], rounded to T, over
// every pixel of the padded width; group 0 also zeroes y's constant parts.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    esp_dma_reduce_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                          T* __restrict__ r, T* __restrict__ y,
                          long long n_pixels, int wp, int width, int c,
                          int c_pad, int n) {
  __shared__ float xs[kThreads][kChunk + 1];  // odd stride: no bank conflicts
  __shared__ __align__(16) float ws[kChunk][kGroup];
  const long long p0 = (long long)blockIdx.x * kThreads;
  const long long left = n_pixels - p0;
  const int pixels = left < kThreads ? (int)left : kThreads;
  const int k0 = blockIdx.y * kGroup;
  const int kw = n - k0 < kGroup ? n - k0 : kGroup;
  const int t = threadIdx.x;

  float acc[kGroup];
#pragma unroll
  for (int o = 0; o < kGroup; ++o) acc[o] = 0.f;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    const int cw = c - c0 < kChunk ? c - c0 : kChunk;
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = t; i < pixels * kChunk; i += kThreads) {
      const int p = i / kChunk;
      const int cc = i - p * kChunk;
      xs[p][cc] = cc < cw ? to_f32(x[(p0 + p) * c_pad + c0 + cc]) : 0.f;
    }
    for (int i = t; i < kChunk * kGroup; i += kThreads) {
      const int cc = i / kGroup;
      const int o = i - cc * kGroup;
      ws[cc][o] = cc < cw && o < kw
                      ? to_f32(w1[(long long)(c0 + cc) * n + k0 + o])
                      : 0.f;
    }
    __syncthreads();
    if (t < pixels) {
      for (int cc = 0; cc < cw; ++cc) {
        const float v = xs[t][cc];
        const float4* wrow = reinterpret_cast<const float4*>(ws[cc]);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
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
    T* rp = r + (p0 + t) * n + k0;
#pragma unroll
    for (int o = 0; o < kGroup; ++o)
      if (o < kw) rp[o] = from_f32<T>(acc[o]);
  }

  if (blockIdx.y != 0) return;
  // y's halo columns (every channel) and pad channels (the other pixels)
  const T zero = from_f32<T>(0.f);
  for (int p = 0; p < pixels; ++p) {
    const int col = (int)((p0 + p) % wp);
    const bool halo = col < kHalo || col >= kHalo + width;
    T* yp = y + (p0 + p) * c_pad;
    for (int ch = (halo ? 0 : c) + t; ch < c_pad; ch += kThreads)
      yp[ch] = zero;
  }
}

// Pass B: channels [g0, g0 + kGroup) of the five dilated branches, the
// hierarchical adds, residual, affine and PReLU, at the pixels inside the
// halo.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    esp_dma_branch_kernel(const T* __restrict__ x, const T* __restrict__ r,
                          const T* __restrict__ wd,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          const float* __restrict__ alpha, T* __restrict__ y,
                          int batch, int height, int width, int c_pad, int n,
                          int n1, int n_pad, int add_residual) {
  extern __shared__ float4 wsm[];  // [9n][kQ]: one branch's group slice, f32
  float* wsf = reinterpret_cast<float*>(wsm);
  const int wp = width + 2 * kHalo;
  const long long n_pixels = (long long)batch * height * width;
  const long long pix = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool valid = pix < n_pixels;
  const int g0 = blockIdx.y * kGroup;
  int b = 0, h = 0, w = 0;
  if (valid) {
    w = (int)(pix % width);
    const long long t = pix / width;
    h = (int)(t % height);
    b = (int)(t / height);
  }
  const long long pp = ((long long)b * height + h) * wp + w + kHalo;
  const T* xp = x + pp * c_pad;
  T* yp = y + pp * c_pad;

  float run[kGroup];  // this slice of add1 .. add4, branch to branch
#pragma unroll
  for (int o = 0; o < kGroup; ++o) run[o] = 0.f;

  for (int br = 0; br < 5; ++br) {
    const int width_out = br == 0 ? n1 : n;
    if (g0 >= width_out) continue;  // the same for the whole block
    const int cols = width_out - g0 < kGroup ? width_out - g0 : kGroup;
    __syncthreads();  // every thread is done with the previous slab
    const T* wb = wd + (long long)br * 9 * n * n_pad + g0;
    for (int i = threadIdx.x; i < 9 * n * kGroup; i += kThreads) {
      const int row = i / kGroup;
      const int o = i - row * kGroup;
      wsf[i] = o < cols ? to_f32(wb[(long long)row * n_pad + o]) : 0.f;
    }
    __syncthreads();
    if (!valid) continue;

    const int d = 1 << br;
    float acc[kGroup];
#pragma unroll
    for (int o = 0; o < kGroup; ++o) acc[o] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int hh = h + (tap / 3 - 1) * d;
      if (hh < 0 || hh >= height) continue;
      const int ww = w + kHalo + (tap % 3 - 1) * d;  // in [0, wp): d <= kHalo
      const T* rp = r + (((long long)b * height + hh) * wp + ww) * n;
      const float4* wrow = wsm + tap * n * kQ;
      for (int k = 0; k < n; ++k) {
        const float v = to_f32(rp[k]);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float4 wv = wrow[k * kQ + q];
          acc[4 * q + 0] = fmaf(v, wv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v, wv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, wv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, wv.w, acc[4 * q + 3]);
        }
      }
    }

    // this slice of the concat: d1 -> [0, n1); addk -> n1 + (k-1)n
    const int c0 = (br == 0 ? 0 : n1 + (br - 1) * n) + g0;
#pragma unroll
    for (int o = 0; o < kGroup; ++o) {
      if (br > 0) run[o] += acc[o];
      if (o < cols) {
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

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* wd,
                   const float* scale, const float* bias, const float* alpha,
                   void* r, void* y, int batch, int height, int width, int c,
                   int c_pad, int n, int n1, int n_pad, int add_residual,
                   cudaStream_t stream) {
  const int wp = width + 2 * kHalo;
  const long long padded_pixels = (long long)batch * height * wp;
  const dim3 grid_a((unsigned)((padded_pixels + kThreads - 1) / kThreads),
                    (unsigned)((n + kGroup - 1) / kGroup));
  esp_dma_reduce_kernel<T><<<grid_a, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<T*>(r),
      static_cast<T*>(y), padded_pixels, wp, width, c, c_pad, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long pixels = (long long)batch * height * width;
  const int widest = n1 > n ? n1 : n;
  const dim3 grid_b((unsigned)((pixels + kThreads - 1) / kThreads),
                    (unsigned)((widest + kGroup - 1) / kGroup));
  const size_t smem = (size_t)9 * n * kGroup * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(esp_dma_branch_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  esp_dma_branch_kernel<T><<<grid_b, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(wd), scale, bias, alpha, static_cast<T*>(y),
      batch, height, width, c_pad, n, n1, n_pad, add_residual);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; returns cudaGetLastError() (0 on success).
// `width` is the logical width W (the rows hold W + 32 columns); r is a
// (B, H, W + 32, n) scratch of x's type.  is_bf16 selects the type of x, w1,
// wd, r and y (bf16 when nonzero, f32 otherwise).
int esp_dma_forward(const void* x, const void* w1, const void* wd,
                    const void* scale, const void* bias, const void* alpha,
                    void* r, void* y, int batch, int height, int width, int c,
                    int c_pad, int n, int n1, int n_pad, int add_residual,
                    int is_bf16, void* stream) {
  if ((long long)batch * height == 0) return 0;
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* a = static_cast<const float*>(alpha);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, w1, wd, s, bi, a, r, y, batch,
                                      height, width, c, c_pad, n, n1, n_pad,
                                      add_residual, st);
  return (int)launch<float>(x, w1, wd, s, bi, a, r, y, batch, height, width,
                            c, c_pad, n, n1, n_pad, add_residual, st);
}

}  // extern "C"
