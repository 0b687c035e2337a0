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
// The same function as a scan.  Order each problem's boxes by (score
// descending, index ascending): the greedy step's winner is then the first
// box of that order that no earlier kept box suppresses, so greedy NMS is
// "walk the order, keep a box unless a kept box has IoU >= threshold with
// it, stop after max_outputs kept boxes or at the first score <= NEG_INF /
// 2".  The IoU below is symmetric in its two boxes (min, max, sub per side,
// inter = iy * ix, union = a_i + a_j - inter), so which box is the winner
// does not matter.
//
// What bounds it on an H100: the greedy definition reads 20 bytes per box
// and does about 14 operations per box and step, so on the detector's RPN
// problem (P=8, N=2000, 300 steps) the least time is about 1 us, by
// operations.  Three kernels, one after the other on the caller's stream:
//   nms_sort_kernel: one block per problem sorts (score, index) keys, one
//     64-bit key per box, with a bitonic sort in shared memory (N <= 8192:
//     64 KB), and writes the order, the boxes in that order and the number
//     of valid scores (a prefix of the order).
//   nms_mask_kernel: the upper-triangular bitmask "IoU(i, j) >= threshold"
//     over the sorted order, j > i, on many blocks at once: a grid of
//     (N/64 column blocks, N/64 row blocks, P), one uint64 word per thread
//     and row, rows and columns past the valid prefix skipped; the
//     division is skipped where the IoU is far from the threshold.
//   nms_scan_kernel: one block per problem keeps the "removed" bits (up to
//     128 words) in shared memory and walks the order 64 boxes at a time.
//     One warp scans the 64 bits serially: a kept box removes what its
//     diagonal word says at once.  Meanwhile two other warps fetch the next
//     64 rows' diagonal words and indices, and after each block of 64 all
//     warps OR the kept rows' later words in (independent loads, shared-
//     memory atomics).  It stops at max_outputs kept boxes and writes
//     original indices, -1 padding and num_valid.
// The mask scratch is (P, N, ceil(N/64)) words: 4 MB at (8, 2000).
//
// Exactness: the plain version rounds after every product, sum and
// quotient.  nvcc would contract a_i + a_j - iy * ix into an FMA, which
// moves the IoU by an ulp and can flip iou >= threshold, so the IoU is
// written with the _rn intrinsics, which are never contracted.  -0.0 scores
// are keyed as +0.0, since the two compare equal (a tie, lowest index
// first).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kValidFloor = -5e9f;  // NEG_INF / 2, exact in f32
constexpr int kMaxBoxes = 8192;
constexpr int kSortThreads = 1024;
constexpr int kWords = kMaxBoxes / 64;  // mask words of a row, at most
constexpr int kScanThreads = 512;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// iou(a, b) >= threshold, with the IoU rounded where the plain version
// rounds.  Far from the threshold the side of the rounded quotient is
// known without dividing: inter > 1.00001 * thr * union puts inter / union
// more than 9.9e-6 (relative) above thr, far more than the 2^-24 that the
// rounding of the product and of the quotient can move it, and likewise
// below.  Near it, and for a product outside the normal range, the
// correctly rounded quotient decides.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, float threshold) {
  const float iy = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ix = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iy, ix);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (!(uni > 0.f)) return 0.f >= threshold;
  const float t = __fmul_rn(threshold, uni);
  if (t > 1e-30f) {
    if (inter > __fmul_rn(t, 1.00001f)) return true;
    if (inter < __fmul_rn(t, 0.99999f)) return false;
  }
  return __fdiv_rn(inter, uni) >= threshold;
}

// Ascending order of keys = (score descending, index ascending).
__device__ __forceinline__ unsigned long long sort_key(float s, int i) {
  const uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);
  const uint32_t ascending = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)~ascending << 32) | (uint32_t)i;
}

__global__ void __launch_bounds__(kSortThreads)
    nms_sort_kernel(const float4* __restrict__ boxes,
                    const float* __restrict__ scores, int n, int m,
                    int* __restrict__ order, float4* __restrict__ sorted,
                    int* __restrict__ n_valid) {
  extern __shared__ unsigned long long keys[];  // [m], m = 2^k >= n
  const int p = blockIdx.x;
  boxes += (size_t)p * n;
  scores += (size_t)p * n;
  order += (size_t)p * n;
  sorted += (size_t)p * n;
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    keys[i] = i < n ? sort_key(scores[i], i) : ~0ull;
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const int partner = i ^ j;
        if (partner > i) {
          const unsigned long long a = keys[i], b = keys[partner];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[partner] = a;
          }
        }
      }
    }
  }
  __syncthreads();
  int valid = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    bool ok = false;
    if (i < n) {
      const int idx = (int)(keys[i] & 0xffffffffu);
      order[i] = idx;
      sorted[i] = boxes[idx];
      ok = scores[idx] > kValidFloor;
    }
    valid += __syncthreads_count(ok);
  }
  if (threadIdx.x == 0) n_valid[p] = valid;
}

__global__ void __launch_bounds__(64)
    nms_mask_kernel(const float4* __restrict__ sorted,
                    const int* __restrict__ n_valid,
                    unsigned long long* __restrict__ mask, int n,
                    float iou_threshold) {
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  const int p = blockIdx.z;
  const int nv = n_valid[p];
  // the scan reads words at or right of the row's own block, of valid rows
  if (cb < rb || cb * 64 >= nv) return;
  __shared__ float4 cbox[64];
  __shared__ float carea[64];
  const int words = (n + 63) / 64;
  sorted += (size_t)p * n;
  const int j0 = cb * 64;
  if (j0 + (int)threadIdx.x < nv) {
    const float4 b = sorted[j0 + threadIdx.x];
    cbox[threadIdx.x] = b;
    carea[threadIdx.x] = box_area(b);
  }
  __syncthreads();
  const int i = rb * 64 + threadIdx.x;
  if (i >= nv) return;
  const float4 me = sorted[i];
  const float area = box_area(me);
  const int cols = min(64, nv - j0);
  unsigned long long bits = 0;
  for (int jj = 0; jj < cols; ++jj)
    if (j0 + jj > i &&
        suppresses(me, area, cbox[jj], carea[jj], iou_threshold))
      bits |= 1ull << jj;
  mask[((size_t)p * n + i) * words + cb] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
    nms_scan_kernel(const int* __restrict__ order,
                    const int* __restrict__ n_valid,
                    const unsigned long long* __restrict__ mask,
                    int* __restrict__ out_idx, int* __restrict__ num_valid,
                    int n, int k) {
  __shared__ unsigned long long removed[kWords];
  __shared__ unsigned long long diag[2][64];  // a block's diagonal words
  __shared__ int idx[2][64];                  // and original indices
  __shared__ int kept_rows[64];
  __shared__ int kept_n, count;
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nv = n_valid[p];
  const int words = (n + 63) / 64;
  const int blocks = (nv + 63) / 64;
  order += (size_t)p * n;
  mask += (size_t)p * n * words;
  out_idx += (size_t)p * k;

  // row w*64 + t of block w into buffer w % 2, by the thread of slot t
  auto fetch = [&](int w, int t) {
    const int row = w * 64 + t;
    diag[w & 1][t] = row < nv ? mask[(size_t)row * words + w] : 0;
    idx[w & 1][t] = row < nv ? order[row] : -1;
  };
  for (int i = tid; i < kWords; i += kScanThreads) removed[i] = 0;
  if (tid < 64 && blocks > 0) fetch(0, tid);
  if (tid == 0) count = 0;
  __syncthreads();
  for (int w = 0; w < blocks; ++w) {
    if (warp == 0) {
      // the serial part, warp-uniform: every lane walks the same bits; a
      // kept box drops itself and the boxes it suppresses
      const int left = nv - w * 64;
      unsigned long long cand =
          ~removed[w] & (left >= 64 ? ~0ull : ((1ull << left) - 1));
      const unsigned long long* d = diag[w & 1];
      unsigned long long kept = 0;
      int c = count;
      while (cand && c < k) {
        const int b = __ffsll((long long)cand) - 1;
        kept |= 1ull << b;
        ++c;
        cand = (cand & (cand - 1)) & ~d[b];
      }
      // the kept boxes' original indices, in order, two bits a lane
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int b = lane + 32 * half;
        if ((kept >> b) & 1ull) {
          const int u = __popcll(kept & ((1ull << b) - 1));
          out_idx[count + u] = idx[w & 1][b];
          kept_rows[u] = w * 64 + b;
        }
      }
      __syncwarp();  // every lane has read count
      if (lane == 0) {
        kept_n = c - count;
        count = c;
      }
    } else if (tid < 96 && w + 1 < blocks) {
      fetch(w + 1, tid - 32);  // the next block's rows, meanwhile
    }
    __syncthreads();
    if (count >= k || w + 1 >= blocks) break;
    // the kept rows' words right of this block, up to the last valid
    // block, over every thread: all loads independent
    const int later = blocks - w - 1;
    const int pairs = kept_n * later;
    for (int i = tid; i < pairs; i += kScanThreads) {
      const int u = i / later;
      const int word = w + 1 + (i - u * later);
      atomicOr(&removed[word], mask[(size_t)kept_rows[u] * words + word]);
    }
    __syncthreads();
  }
  for (int s = count + tid; s < k; s += kScanThreads) out_idx[s] = -1;
  if (tid == 0) num_valid[p] = count;
}

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

// Scratch: order (P, N) int32, sorted boxes (P, N) float4, n_valid (P,)
// int32, mask (P, N, ceil(N/64)) uint64; each 256-byte aligned.
struct Scratch {
  size_t order, sorted, n_valid, mask, total;
};

Scratch scratch_layout(int problems, int n) {
  Scratch s;
  const size_t pn = (size_t)problems * n;
  s.order = 0;
  s.sorted = align256(pn * 4);
  s.n_valid = s.sorted + align256(pn * 16);
  s.mask = s.n_valid + align256((size_t)problems * 4);
  s.total = s.mask + pn * ((n + 63) / 64) * 8;
  return s;
}

}  // namespace

extern "C" {

// Bytes of scratch nms_forward needs, or -1 when n is out of 1..8192.
long long nms_scratch_bytes(int problems, int n) {
  if (n < 1 || n > kMaxBoxes) return -1;
  return (long long)scratch_layout(problems, n).total;
}

// Launches the three kernels on `stream`; returns cudaGetLastError() (0 on
// success).  1 <= n <= 8192; boxes 16-byte aligned; `scratch` holds
// nms_scratch_bytes(problems, n) bytes, 256-byte aligned.
int nms_forward(const void* boxes, const void* scores, void* scratch,
                void* out_idx, void* num_valid, int problems, int n, int k,
                float iou_threshold, void* stream) {
  if (problems == 0 || k == 0) return 0;
  if (n < 1 || n > kMaxBoxes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch lay = scratch_layout(problems, n);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  int* order = reinterpret_cast<int*>(base + lay.order);
  float4* sorted = reinterpret_cast<float4*>(base + lay.sorted);
  int* n_valid = reinterpret_cast<int*>(base + lay.n_valid);
  unsigned long long* mask =
      reinterpret_cast<unsigned long long*>(base + lay.mask);

  int m = 64;
  while (m < n) m <<= 1;
  const size_t sort_smem = (size_t)m * 8;
  cudaError_t err = cudaFuncSetAttribute(
      nms_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sort_smem);
  if (err != cudaSuccess) return (int)err;
  nms_sort_kernel<<<problems, m < kSortThreads ? m : kSortThreads, sort_smem,
                    st>>>(static_cast<const float4*>(boxes),
                          static_cast<const float*>(scores), n, m, order,
                          sorted, n_valid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int words = (n + 63) / 64;
  nms_mask_kernel<<<dim3(words, words, problems), 64, 0, st>>>(
      sorted, n_valid, mask, n, iou_threshold);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<problems, kScanThreads, 0, st>>>(order, n_valid, mask,
                                           static_cast<int*>(out_idx),
                                           static_cast<int*>(num_valid), n,
                                           k);
  return (int)cudaGetLastError();
}

}  // extern "C"
