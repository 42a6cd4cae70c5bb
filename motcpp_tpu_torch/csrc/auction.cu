// Jacobi auction for masked, cost-limited assignment, one CTA per problem.
//
// Replaces motcpp_tpu/ops/auction_pallas.py::_auction_kernel (the TPU
// kernel that ByteTrack's three assignment stages reach through
// ops/lap.py::solve_lap_masked(impl="auction_pallas")). The plain PyTorch
// version with the same arithmetic is motcpp_tpu_torch/ops/auction.py.
//
// What bounds it on an H100: not bytes. Each problem reads its K*N cost
// tile once (8 KB at K=64, N=32), but then runs a data-dependent number
// of bidding rounds, each a pass over the whole tile plus a K-long scan
// per column, with two block barriers. Latency of those dependent rounds
// bounds it, and the slowest problem of the launch sets the tail.
//
// What the design does about that: the benefit tile, prices and both
// assignment maps live in shared memory for the whole solve, so a round
// touches no device memory; each problem loops to its own convergence
// (a solved problem is a fixed point of a round, so this gives the same
// matching as the TPU's blocks of B problems), and many small CTAs share
// an SM, so problems that finish early free their slot for others.
//
// Exactness: float32 only, built with -fmad=false; the bid is added in
// the reference's order (p[j*] + (v1 - v2)) + eps; maxima are exact in
// any order, and both tie-breaks (first column for a row's best, lowest
// row for a column's best bid) are coded explicitly.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kBig = 1e7f;
constexpr float kClip = 1e6f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (value, index) max with first-index tie-break across a warp.
__device__ __forceinline__ void warp_argmax(float& v, int& j) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oj = __shfl_xor_sync(0xffffffffu, j, off);
    if (ov > v || (ov == v && oj < j)) {
      v = ov;
      j = oj;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ cost,
               const unsigned char* __restrict__ row_mask,
               const unsigned char* __restrict__ col_mask,
               const float* __restrict__ thresh, int K, int N,
               float eps_frac, int max_rounds, int* __restrict__ row2col,
               int* __restrict__ col2row) {
  extern __shared__ float smem[];
  float* b = smem;                                   // K*N benefits
  float* price = b + K * N;                          // N
  float* bid_val = price + N;                        // K
  int* bid_col = reinterpret_cast<int*>(bid_val + K);  // K
  int* r2c = bid_col + K;                            // K
  int* c2r = r2c + K;                                // N
  __shared__ float warp_red[kWarps];

  const int prob = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* c = cost + static_cast<size_t>(prob) * K * N;
  const unsigned char* rm = row_mask + static_cast<size_t>(prob) * K;
  const unsigned char* cm = col_mask + static_cast<size_t>(prob) * N;
  const float th = thresh[prob];

  // Benefit tile and its largest entry over valid pairs, floored at 0
  // (the TPU kernel takes the max with 0 on invalid pairs; eps floors
  // it at 1e-6 anyway).
  float local_max = 0.0f;
  for (int idx = tid; idx < K * N; idx += kThreads) {
    const int i = idx / N;
    const int j = idx - i * N;
    float x = c[idx];
    // clip first, then NaN -> BIG: +-inf clip to +-1e6 as on the TPU
    x = isnan(x) ? kBig : fminf(fmaxf(x, -kClip), kClip);
    float v = kNeg;
    if (rm[i] && cm[j]) {
      v = th - x;
      local_max = fmaxf(local_max, v);
    }
    b[idx] = v;
  }
  local_max = warp_max(local_max);
  if (lane == 0) warp_red[warp] = local_max;
  for (int j = tid; j < N; j += kThreads) {
    price[j] = 0.0f;
    c2r[j] = -1;
  }
  for (int i = tid; i < K; i += kThreads) r2c[i] = rm[i] ? -1 : -2;
  __syncthreads();
  float b_max = warp_red[0];
  for (int w = 1; w < kWarps; ++w) b_max = fmaxf(b_max, warp_red[w]);
  const float eps = fmaxf(fmaxf(b_max, 1e-6f) * eps_frac, 1e-7f);

  int pending = 0;
  for (int i = tid; i < K; i += kThreads) pending |= (r2c[i] == -1);
  int rounds = 0;
  while (__syncthreads_or(pending) && rounds < max_rounds) {
    // Rows: one warp per row computes v1, j*, v2 and its bid.
    for (int i = warp; i < K; i += kWarps) {
      if (r2c[i] != -1) {
        if (lane == 0) bid_col[i] = -1;
        continue;
      }
      const float* bi = b + i * N;
      float v1 = kNeg;
      int js = N;
      for (int j = lane; j < N; j += 32) {
        const float v = bi[j] - price[j];
        if (v > v1 || js == N) {
          v1 = v;
          js = j;
        }
      }
      warp_argmax(v1, js);
      float v2 = kNeg;
      for (int j = lane; j < N; j += 32)
        if (j != js) v2 = fmaxf(v2, bi[j] - price[j]);
      v2 = fmaxf(warp_max(v2), 0.0f);
      if (lane == 0) {
        if (v1 > 0.0f) {
          bid_col[i] = js;
          bid_val[i] = (price[js] + (v1 - v2)) + eps;
        } else {
          bid_col[i] = -1;
          r2c[i] = -2;  // opts out for good: prices only rise
        }
      }
    }
    __syncthreads();
    // Columns: highest bid wins, lowest row among equal bids.
    for (int j = tid; j < N; j += kThreads) {
      int win = -1;
      float best = 0.0f;
      for (int i = 0; i < K; ++i) {
        if (bid_col[i] == j && (win < 0 || bid_val[i] > best)) {
          best = bid_val[i];
          win = i;
        }
      }
      if (win >= 0) {
        const int old = c2r[j];
        if (old >= 0) r2c[old] = -1;  // evicted rows bid again
        price[j] = best;
        c2r[j] = win;
        r2c[win] = j;
      }
    }
    ++rounds;
    __syncthreads();
    pending = 0;
    for (int i = tid; i < K; i += kThreads) pending |= (r2c[i] == -1);
  }

  int* out_r = row2col + static_cast<size_t>(prob) * K;
  int* out_c = col2row + static_cast<size_t>(prob) * N;
  for (int i = tid; i < K; i += kThreads) out_r[i] = r2c[i] >= 0 ? r2c[i] : -1;
  // col2row rebuilt from row2col: the lowest row assigned to each column
  for (int j = tid; j < N; j += kThreads) {
    int r = -1;
    for (int i = 0; i < K; ++i) {
      if (r2c[i] == j) {
        r = i;
        break;
      }
    }
    out_c[j] = r;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one problem of shape (K, N) needs.
size_t auction_smem_bytes(int K, int N) {
  return static_cast<size_t>(K) * N * sizeof(float) +
         static_cast<size_t>(N) * (sizeof(float) + sizeof(int)) +
         static_cast<size_t>(K) * (sizeof(float) + 2 * sizeof(int));
}

// Solves P problems on `stream`; returns the CUDA error of the launch.
int auction_solve(const float* cost, const unsigned char* row_mask,
                  const unsigned char* col_mask, const float* thresh, int P,
                  int K, int N, float eps_frac, int max_rounds, int* row2col,
                  int* col2row, void* stream) {
  if (P == 0) return 0;
  const size_t smem = auction_smem_bytes(K, N);
  cudaError_t err = cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auction_kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, row_mask, col_mask, thresh, K, N, eps_frac, max_rounds, row2col,
      col2row);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
