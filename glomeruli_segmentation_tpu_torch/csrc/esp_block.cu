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
// 3.35 TB/s) and does 16.8 GFLOP (64,000 per pixel).  This first version
// does its products on the CUDA cores in f32, so it is bound by operations
// (FMA throughput and the shared-memory weight reads that feed it), not by
// bytes: tensor cores (wgmma), keeping the reduce on chip and TMA are the
// work of a later version.
//
// Design, two passes on the caller's stream:
//   pass A (esp_reduce_kernel): a block stages 64 pixels of x and all of w1
//     in shared memory (f32) and writes r, rounded to x's type, into a
//     (B, H, W, n) scratch.  At B=32 in bf16 that is 13 MB: it stays in L2
//     for pass B.
//   pass B (esp_branch_kernel): one thread per output pixel.  The block
//     walks the five branches in order; for each it stages that branch's
//     (9n, n_pad) weight slab in shared memory as f32 (25 KB at n=25), and
//     every thread accumulates its pixel's branch output in registers,
//     reading r through the cache.  A running sum carries add1 -> add4, and
//     each 25- or 28-wide slice of the concat is finished (residual, affine,
//     PReLU) and written as soon as it is complete, so nothing but y leaves
//     the block.  Warps read the same weight address at once (a broadcast),
//     four outputs per 16-byte load.
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

}  // namespace

extern "C" {

// Branch widths (n_pad rounded up to 4) this library is compiled for.
int esp_block_supports_width(int n_pad) {
  const int np4 = (n_pad + 3) / 4 * 4;
  return np4 == 16 || np4 == 28;
}

// Launches both passes on `stream`; returns cudaGetLastError() (0 on success).
// r is a (B, H, W, n) scratch of x's type.  is_bf16 selects the type of x,
// w1, wd, r and y (bf16 when nonzero, f32 otherwise).
int esp_block_forward(const void* x, const void* w1, const void* wd,
                      const void* scale, const void* bias, const void* alpha,
                      void* r, void* y, int batch, int height, int width,
                      int c, int n, int n1, int n_pad, int add_residual,
                      int is_bf16, void* stream) {
  if ((long long)batch * height * width == 0) return 0;
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* a = static_cast<const float*>(alpha);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_all<__nv_bfloat16>(x, w1, wd, s, bi, a, r, y, batch,
                                          height, width, c, n, n1, n_pad,
                                          add_residual, st);
  return (int)launch_all<float>(x, w1, wd, s, bi, a, r, y, batch, height,
                                width, c, n, n1, n_pad, add_residual, st);
}

}  // extern "C"
