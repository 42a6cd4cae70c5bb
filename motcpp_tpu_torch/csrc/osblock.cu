// One whole OSNet OSBlock on BN-folded weights, for NVIDIA Hopper (sm_90a).
//
// Replaces motcpp_tpu/appearance/osblock_pallas.py::_osblock_kernel (the
// TPU kernel, launched per block by osblock_fused). Its plain PyTorch
// version is motcpp_tpu_torch/appearance/osblock.py::osblock_reference;
// the wrapper is appearance/osblock_cuda.py. Per crop, NHWC, element type
// T (float or __nv_bfloat16) with float accumulation:
//
//   x1  = relu(x . K1 + b1)                                   -> T
//   s_k = lite chains of depth 1, 2, 3, 4 from x1, each lite
//         v -> (v . Kp) -> T -> dw3x3 (zero pad) + b -> relu -> T
//   x2  = sum_k s_k * sigmoid(fc2(relu(fc1(mean_hw(s_k)))))   (float) -> T
//   out = relu(T(x2 . K3 + b3) + (T(x . Kd + bd) or x))       -> T
//
// Rounded to T exactly where the TPU kernel rounds, so the plain version
// reproduces it up to summation order.
//
// What bounds it on the H100 (SXM, 700 W): in float32, operations at the
// 67 TFLOP/s of the CUDA cores (about 1.3 GFLOP per 256x128 crop over the
// six blocks of osnet_x1_0); in bf16 the work would fit the tensor cores'
// 989 TFLOP/s, and reading each input once and writing each output once
// (about 5.3 MB per crop) at 3.35 TB/s bounds it. This first kernel runs
// its 1x1 convolutions as shared-memory-tiled products on the CUDA cores
// in float (wgmma and TMA are later work), so it sits on the operations
// side in both types.
//
// Design. The TPU kernel keeps a tile of crops in VMEM. Here one stage-2
// bottleneck map is 64*32*64 floats (512 KB), more than a block's 227 KB
// of shared memory, and the channel gate needs each stream's mean over the
// whole map before any stream can be scaled. So one CTA owns whole crops
// (a persistent loop over crops b = blockIdx.x, +gridDim.x, ...) and walks
// each crop in tiles of 64 pixels: the gate's mean is then a reduction
// inside the CTA, taken in a fixed order with no atomics (reproducible),
// and a block is ONE launch. The maps between passes (the lite chains'
// pointwise outputs y and the four stream outputs s) live in a per-CTA
// scratch region of device memory, already rounded to T: 12 maps of
// H*W*mid, written once and read back by the next pass (the 3x3 stencil
// reads its halo from there, through L1/L2). Within a tile everything
// else stays in shared memory: the x1, s or x2 tile feeds the next 1x1
// product directly, and each dw3x3 + bias + relu is computed while the
// tile is formed. Passes over a crop:
//
//   0.  per tile: x1 tile (GEMM over x, K1), then the first pointwise of
//       the four streams -> y[0][k];
//   L = 0..3, per tile, for streams k >= L: s = relu(dw(y[L%2][k]) + b);
//       the last lite of stream k writes s to scratch and adds the tile's
//       channel sums to the gate sums; the others run the next pointwise
//       -> y[(L+1)%2][k];
//   gate: four (mid -> mid/16 -> mid) products on the means;
//   final, per tile: x2 tile, then K3 and the downsample (or identity),
//       the residual add and relu -> out.
//
// Parallelism is over crops: 2 CTAs of 256 threads per SM, so the grid
// fills the card when B >= 264 (the main path gives 2048, or 256 under
// BoT-SORT's cadence 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int TP = 64;       // pixels per tile
constexpr int LDP = TP + 4;  // row length of a [channel][pixel] tile
constexpr int NC = 64;       // output columns per GEMM chunk
constexpr int KC = 32;       // reduction depth per staged chunk
constexpr int N_LITES = 10;
constexpr int N_STREAMS = 4;

// first lite of each stream in LITE_NAMES order (conv2a, conv2b_0..1,
// conv2c_0..2, conv2d_0..3)
__device__ __forceinline__ int lite_index(int stream, int depth) {
  return stream * (stream + 1) / 2 + depth;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a cast in JAX
}
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <typename T>
struct Params {
  const T* x;          // (B, H, W, cin)
  T* out;              // (B, H, W, cout)
  const T* wt;         // packed matrices and dw kernels (block_weights)
  const float* wb;     // packed biases
  T* scratch;          // gridDim.x slots of 12 * H * W * mid
  int B, H, W, cin, mid, cout, hidden, has_ds;
};

// Offsets into the packed weights, in block_weights' order.
struct Layout {
  size_t k1, kp0, lite_stride, fc1, fc2, k3, kd;   // into wt
  size_t b1, bdw0, fb1, fb2, b3, bd;               // into wb
  __device__ Layout(int cin, int mid, int cout, int hidden) {
    k1 = 0;
    kp0 = (size_t)cin * mid;
    lite_stride = (size_t)mid * mid + 9 * (size_t)mid;  // Kp then Kdw
    fc1 = kp0 + N_LITES * lite_stride;
    fc2 = fc1 + (size_t)mid * hidden;
    k3 = fc2 + (size_t)hidden * mid;
    kd = k3 + (size_t)mid * cout;
    b1 = 0;
    bdw0 = mid;
    fb1 = bdw0 + (size_t)N_LITES * mid;
    fb2 = fb1 + hidden;
    b3 = fb2 + mid;
    bd = b3 + cout;
  }
};

// acc (4 pixels x 4 columns per thread) += A (TP x K) . W[:, n0:n0+NC].
// A is either resident in shared memory as a [K][LDP] tile (a_res), or
// staged chunk by chunk from pixel-major rows in device memory (a_glob,
// npix valid rows of ld elements; rows past npix read as 0). Thread t
// owns pixels 4*(t/16)+i and columns n0+4*(t%16)+j.
template <typename T>
__device__ void gemm_acc(float (&acc)[4][4], const float* a_res,
                         const T* __restrict__ a_glob, int npix, int ld,
                         int K, const T* __restrict__ w, int N, int n0,
                         float* As, float* Ws) {
  const int t = threadIdx.x;
  const int pg = t >> 4, cg = t & 15;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    if (a_res == nullptr) {
      for (int e = t; e < KC * TP; e += THREADS) {
        const int kk = e % KC, pp = e / KC;
        As[kk * LDP + pp] = (kk < kc && pp < npix)
            ? to_f(a_glob[(size_t)pp * ld + k0 + kk]) : 0.f;
      }
    }
    for (int e = t; e < KC * NC; e += THREADS) {
      const int nn = e % NC, kk = e / NC;
      const int n = n0 + nn;
      Ws[kk * NC + nn] =
          (kk < kc && n < N) ? to_f(w[(size_t)(k0 + kk) * N + n]) : 0.f;
    }
    __syncthreads();
    const float* a = a_res != nullptr ? a_res + (size_t)k0 * LDP : As;
#pragma unroll 4
    for (int kk = 0; kk < kc; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(a + kk * LDP + pg * 4);
      const float4 wv = *reinterpret_cast<const float4*>(Ws + kk * NC + cg * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * wr[j];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// dst[pixel][n] = T(tile . w) for the tile's valid pixels: the pointwise
// conv of a lite (no bias, no relu), tile resident as [mid][LDP].
template <typename T>
__device__ void pointwise_to(T* dst, int pix0, int npix, const float* tile,
                             const T* w, int mid, float* As, float* Ws) {
  const int pg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  for (int n0 = 0; n0 < mid; n0 += NC) {
    float acc[4][4];
    zero(acc);
    gemm_acc<T>(acc, tile, nullptr, 0, 0, mid, w, mid, n0, As, Ws);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pp = pg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + cg * 4 + j;
        if (pp < npix && n < mid)
          dst[(size_t)(pix0 + pp) * mid + n] = from_f<T>(acc[i][j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) osblock_kernel(Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  const int mid = p.mid, hidden = p.hidden;
  float* tile = smem;                      // [mid][LDP]
  float* As = tile + (size_t)mid * LDP;    // [KC][LDP]
  float* Ws = As + KC * LDP;               // [KC][NC]
  float* gsum = Ws + KC * NC;              // [4][mid] stream channel sums
  float* gate = gsum + N_STREAMS * mid;    // [4][mid]
  float* gmean = gate + N_STREAMS * mid;   // [mid]
  float* ghid = gmean + mid;               // [hidden]

  const int t = threadIdx.x;
  const int pg = t >> 4, cg = t & 15;
  const int H = p.H, W = p.W, HW = H * W;
  const int ntiles = (HW + TP - 1) / TP;
  const Layout L(p.cin, mid, p.cout, hidden);
  const size_t map = (size_t)HW * mid;
  T* y_base = p.scratch + (size_t)blockIdx.x * 12 * map;  // y[2][4]
  T* s_base = y_base + 8 * map;                            // s[4]
  auto y_map = [&](int buf, int k) { return y_base + (size_t)(buf * 4 + k) * map; };

  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const T* xb = p.x + (size_t)b * HW * p.cin;
    T* ob = p.out + (size_t)b * HW * p.cout;
    for (int e = t; e < N_STREAMS * mid; e += THREADS) gsum[e] = 0.f;

    // ---- pass 0: x1 and the first pointwise of each stream ----------
    for (int tl = 0; tl < ntiles; ++tl) {
      const int pix0 = tl * TP, npix = min(TP, HW - pix0);
      for (int n0 = 0; n0 < mid; n0 += NC) {
        float acc[4][4];
        zero(acc);
        gemm_acc<T>(acc, nullptr, xb + (size_t)pix0 * p.cin, npix, p.cin,
                    p.cin, p.wt + L.k1, mid, n0, As, Ws);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + cg * 4 + j;
            if (n < mid)
              tile[n * LDP + pg * 4 + i] =
                  round_to<T>(fmaxf(acc[i][j] + p.wb[L.b1 + n], 0.f));
          }
      }
      __syncthreads();
      for (int k = 0; k < N_STREAMS; ++k)
        pointwise_to<T>(y_map(0, k), pix0, npix, tile,
                        p.wt + L.kp0 + lite_index(k, 0) * L.lite_stride,
                        mid, As, Ws);
      __syncthreads();
    }

    // ---- lite levels: dw3x3 + bias + relu, then the next pointwise ----
    for (int lv = 0; lv < N_STREAMS; ++lv) {
      for (int tl = 0; tl < ntiles; ++tl) {
        const int pix0 = tl * TP, npix = min(TP, HW - pix0);
        for (int k = lv; k < N_STREAMS; ++k) {
          const int li = lite_index(k, lv);
          const T* yin = y_map(lv & 1, k);
          const T* kdw = p.wt + L.kp0 + li * L.lite_stride + (size_t)mid * mid;
          const float* bdw = p.wb + L.bdw0 + (size_t)li * mid;
          const bool last = lv == k;
          T* s_out = s_base + (size_t)k * map;
          for (int e = t; e < TP * mid; e += THREADS) {
            const int c = e % mid, pp = e / mid;
            float v = 0.f;
            if (pp < npix) {
              const int pix = pix0 + pp, h = pix / W, w = pix % W;
              float acc = 0.f;
              for (int i = 0; i < 3; ++i) {
                const int hh = h + i - 1;
                if (hh < 0 || hh >= H) continue;
                for (int j = 0; j < 3; ++j) {
                  const int ww = w + j - 1;
                  if (ww < 0 || ww >= W) continue;
                  acc += to_f(yin[(size_t)(hh * W + ww) * mid + c]) *
                         to_f(kdw[(i * 3 + j) * mid + c]);
                }
              }
              v = round_to<T>(fmaxf(acc + bdw[c], 0.f));
              if (last) s_out[(size_t)pix * mid + c] = from_f<T>(v);
            }
            tile[c * LDP + pp] = v;
          }
          __syncthreads();
          if (last) {
            if (t < mid) {  // fixed order: reproducible without atomics
              float s = 0.f;
              for (int pp = 0; pp < npix; ++pp) s += tile[t * LDP + pp];
              gsum[k * mid + t] += s;
            }
          } else {
            pointwise_to<T>(y_map((lv + 1) & 1, k), pix0, npix, tile,
                            p.wt + L.kp0 + (li + 1) * L.lite_stride, mid, As,
                            Ws);
          }
          __syncthreads();
        }
      }
    }

    // ---- the shared channel gate, once per stream --------------------
    const float inv_hw = 1.f / (float)HW;
    for (int k = 0; k < N_STREAMS; ++k) {
      if (t < mid) gmean[t] = round_to<T>(gsum[k * mid + t] * inv_hw);
      __syncthreads();
      if (t < hidden) {
        float h = 0.f;
        for (int c = 0; c < mid; ++c)
          h += gmean[c] * to_f(p.wt[L.fc1 + (size_t)c * hidden + t]);
        ghid[t] = round_to<T>(fmaxf(h + p.wb[L.fb1 + t], 0.f));
      }
      __syncthreads();
      if (t < mid) {
        float g = 0.f;
        for (int j = 0; j < hidden; ++j)
          g += ghid[j] * to_f(p.wt[L.fc2 + (size_t)j * mid + t]);
        gate[k * mid + t] = 1.f / (1.f + expf(-(g + p.wb[L.fb2 + t])));
      }
      __syncthreads();
    }

    // ---- final: x2, conv3, identity or downsample, relu ----------------
    for (int tl = 0; tl < ntiles; ++tl) {
      const int pix0 = tl * TP, npix = min(TP, HW - pix0);
      for (int e = t; e < TP * mid; e += THREADS) {
        const int c = e % mid, pp = e / mid;
        float v = 0.f;
        if (pp < npix) {
          const size_t at = (size_t)(pix0 + pp) * mid + c;
          float a = 0.f;
          for (int k = 0; k < N_STREAMS; ++k)
            a += to_f(s_base[k * map + at]) * gate[k * mid + c];
          v = round_to<T>(a);
        }
        tile[c * LDP + pp] = v;
      }
      __syncthreads();
      const T* xt = xb + (size_t)pix0 * p.cin;
      for (int n0 = 0; n0 < p.cout; n0 += NC) {
        float acc3[4][4], accd[4][4];
        zero(acc3);
        zero(accd);
        gemm_acc<T>(acc3, tile, nullptr, 0, 0, mid, p.wt + L.k3, p.cout, n0,
                    As, Ws);
        if (p.has_ds)
          gemm_acc<T>(accd, nullptr, xt, npix, p.cin, p.cin, p.wt + L.kd,
                      p.cout, n0, As, Ws);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pp = pg * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + cg * 4 + j;
            if (pp >= npix || n >= p.cout) continue;
            const float o = round_to<T>(acc3[i][j] + p.wb[L.b3 + n]);
            const float id =
                p.has_ds ? round_to<T>(accd[i][j] + p.wb[L.bd + n])
                         : to_f(xt[(size_t)pp * p.cin + n]);
            ob[(size_t)(pix0 + pp) * p.cout + n] = from_f<T>(fmaxf(o + id, 0.f));
          }
        }
      }
      __syncthreads();
    }
  }
}

size_t smem_bytes(int mid, int hidden) {
  return sizeof(float) * ((size_t)mid * LDP + KC * LDP + KC * NC +
                          (2 * N_STREAMS + 1) * (size_t)mid + hidden);
}

template <typename T>
int launch(const void* x, void* out, const void* wt, const void* wb,
           void* scratch, int B, int H, int W, int cin, int mid, int cout,
           int hidden, int has_ds, int grid, cudaStream_t stream) {
  Params<T> p{static_cast<const T*>(x), static_cast<T*>(out),
              static_cast<const T*>(wt), static_cast<const float*>(wb),
              static_cast<T*>(scratch), B, H, W, cin, mid, cout, hidden,
              has_ds};
  const size_t smem = smem_bytes(mid, hidden);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        osblock_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  osblock_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes.
size_t osblock_smem_bytes(int mid, int hidden) {
  return smem_bytes(mid, hidden);
}

// Elements of T in one CTA's scratch slot: y[2][4] and s[4] maps.
size_t osblock_scratch_elems(int H, int W, int mid) {
  return (size_t)12 * H * W * mid;
}

// Launches one OSBlock over B crops on `stream` with `grid` CTAs (and
// grid scratch slots); bf16 selects __nv_bfloat16, else float. Returns
// cudaGetLastError() after the launch (0 on success).
int osblock_forward(const void* x, void* out, const void* wt, const void* wb,
                    void* scratch, int B, int H, int W, int cin, int mid,
                    int cout, int hidden, int has_ds, int grid, int bf16,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, out, wt, wb, scratch, B, H, W, cin, mid,
                                 cout, hidden, has_ds, grid, s);
  return launch<float>(x, out, wt, wb, scratch, B, H, W, cin, mid, cout,
                       hidden, has_ds, grid, s);
}

}  // extern "C"
