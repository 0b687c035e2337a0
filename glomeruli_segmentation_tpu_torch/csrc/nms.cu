// Greedy non-maximum suppression, batched over independent problems.
//
// Replaces the Pallas TPU kernel glomeruli_segmentation_tpu/ops/pallas/
// nms_pallas.py::_nms_kernel (called through nms_pallas).  Same function,
// for each problem p:
//   live = scores[p]
//   repeat max_outputs times:
//     idx  = first index of max(live)              (lowest index on ties)
//     stop emitting once live[idx] <= NEG_INF / 2  (the rest are -1)
//     kill idx and every box whose IoU with box idx is >= iou_threshold
//   num_valid[p] = number of indices emitted
//
// Layout: boxes (P, N, 4) f32 [ymin, xmin, ymax, xmax], scores (P, N) f32,
// both contiguous; out_idx (P, max_outputs) int32, num_valid (P,) int32.
// The wrapper has already set scores <= score_threshold to NEG_INF.
//
// What bounds it on an H100: the function reads 20 bytes per box and does
// about 14 operations per box and step, so on the detector's RPN problem
// (P=8, N=2000, 300 steps) the least time is about 1 us, by operations.
// The kernel is far from that: the steps form a chain, each a block-wide
// argmax that depends on the previous step's suppression, so one problem
// is one block walking 300 dependent reductions (two __syncthreads each),
// and only P of the 132 SMs work.  Making it fast (a bitmask IoU matrix
// computed in parallel, then a short serial scan) is a later version's
// work.
//
// Design: one block per problem, up to 1024 threads.  Thread t holds boxes
// t, t + blockDim, ... (up to 8, ITEMS is a template parameter so the
// arrays stay in registers), with their areas and live scores.  Each step
// is a per-thread scan, a warp-shuffle argmax, a shared-memory argmax over
// the warps, and one suppression pass over the thread's own boxes.  The
// winner's box is read from device memory (the same 16 bytes for every
// thread: one broadcast, a cache hit after the first step).
//
// Exactness: the plain version rounds after every product, sum and
// quotient.  nvcc would contract barea + area - iy * ix into an FMA, which
// moves the IoU by an ulp and can flip iou >= threshold, so the IoU is
// written with the _rn intrinsics, which are never contracted.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr float kNegInf = -1e10f;
constexpr float kValidFloor = -5e9f;  // NEG_INF / 2, exact in f32
constexpr int kMaxThreads = 1024;
constexpr int kMaxItems = 8;

__device__ __forceinline__ float box_area(float y1, float x1, float y2,
                                          float x2) {
  return __fmul_rn(fmaxf(__fsub_rn(y2, y1), 0.f),
                   fmaxf(__fsub_rn(x2, x1), 0.f));
}

// (score a, index a) wins over (score b, index b)
__device__ __forceinline__ bool wins(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__device__ __forceinline__ void warp_argmax(float& best, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, idx, off);
    if (wins(s, i, best, idx)) {
      best = s;
      idx = i;
    }
  }
}

template <int ITEMS>
__global__ void __launch_bounds__(kMaxThreads)
    nms_kernel(const float4* __restrict__ boxes,
               const float* __restrict__ scores, int* __restrict__ out_idx,
               int* __restrict__ num_valid, int n, int k,
               float iou_threshold) {
  __shared__ float warp_best[32];
  __shared__ int warp_idx[32];
  __shared__ float win_score;
  __shared__ int win_idx;

  const int p = blockIdx.x;
  boxes += (size_t)p * n;
  scores += (size_t)p * n;
  out_idx += (size_t)p * k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  float y1[ITEMS], x1[ITEMS], y2[ITEMS], x2[ITEMS], area[ITEMS], live[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = tid + j * blockDim.x;
    if (i < n) {
      const float4 b = boxes[i];
      y1[j] = b.x;
      x1[j] = b.y;
      y2[j] = b.z;
      x2[j] = b.w;
      area[j] = box_area(b.x, b.y, b.z, b.w);
      live[j] = scores[i];
    } else {  // padding: below every real score, never a winner
      y1[j] = x1[j] = y2[j] = x2[j] = area[j] = 0.f;
      live[j] = -INFINITY;
    }
  }

  int emitted = 0;
  for (int step = 0; step < k; ++step) {
    // the thread's own boxes come in increasing index order, so a strict >
    // keeps the lowest index on ties
    float best = -INFINITY;
    int idx = INT_MAX;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (live[j] > best) {
        best = live[j];
        idx = tid + j * blockDim.x;
      }
    }
    warp_argmax(best, idx);
    if (lane == 0) {
      warp_best[warp] = best;
      warp_idx[warp] = idx;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? warp_best[lane] : -INFINITY;
      idx = lane < nwarps ? warp_idx[lane] : INT_MAX;
      warp_argmax(best, idx);
      if (lane == 0) {
        win_score = best;
        win_idx = idx;
      }
    }
    __syncthreads();
    // the same shared values for every thread: the whole block stops here
    if (!(win_score > kValidFloor)) break;
    const int w = win_idx;
    const float4 wb = boxes[w];
    const float warea = box_area(wb.x, wb.y, wb.z, wb.w);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = tid + j * blockDim.x;
      if (i < n) {
        const float iy =
            fmaxf(__fsub_rn(fminf(wb.z, y2[j]), fmaxf(wb.x, y1[j])), 0.f);
        const float ix =
            fmaxf(__fsub_rn(fminf(wb.w, x2[j]), fmaxf(wb.y, x1[j])), 0.f);
        const float inter = __fmul_rn(iy, ix);
        const float uni = __fsub_rn(__fadd_rn(warea, area[j]), inter);
        const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
        if (iou >= iou_threshold || i == w) live[j] = kNegInf;
      }
    }
    if (tid == 0) out_idx[step] = w;
    ++emitted;
  }
  if (tid == 0) {
    for (int s = emitted; s < k; ++s) out_idx[s] = -1;
    num_valid[p] = emitted;
  }
}

template <int ITEMS>
cudaError_t launch(const void* boxes, const void* scores, void* out_idx,
                   void* num_valid, int problems, int n, int k,
                   float iou_threshold, int threads, cudaStream_t stream) {
  nms_kernel<ITEMS><<<problems, threads, 0, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<int*>(out_idx), static_cast<int*>(num_valid), n, k,
      iou_threshold);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one block per problem on `stream`; returns cudaGetLastError()
// (0 on success).  1 <= n <= 8192; boxes 16-byte aligned.
int nms_forward(const void* boxes, const void* scores, void* out_idx,
                void* num_valid, int problems, int n, int k,
                float iou_threshold, void* stream) {
  if (problems == 0 || k == 0) return 0;
  if (n < 1 || n > kMaxItems * kMaxThreads) return (int)cudaErrorInvalidValue;
  const int threads = n < kMaxThreads ? (n + 31) / 32 * 32 : kMaxThreads;
  const int items = (n + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (items <= 1)
    err = launch<1>(boxes, scores, out_idx, num_valid, problems, n, k,
                    iou_threshold, threads, st);
  else if (items <= 2)
    err = launch<2>(boxes, scores, out_idx, num_valid, problems, n, k,
                    iou_threshold, threads, st);
  else if (items <= 4)
    err = launch<4>(boxes, scores, out_idx, num_valid, problems, n, k,
                    iou_threshold, threads, st);
  else
    err = launch<8>(boxes, scores, out_idx, num_valid, problems, n, k,
                    iou_threshold, threads, st);
  return (int)err;
}

}  // extern "C"
