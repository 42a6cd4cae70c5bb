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
// What bounds it on the H100 (SXM, 700 W): in bf16 the 1x1 products (about
// 1.3 GFLOP per 256x128 crop over the six blocks of osnet_x1_0) fit the
// tensor cores' 989 TFLOP/s, and reading each input once and writing each
// output once (about 5.3 MB per crop) at 3.35 TB/s bounds the block. This
// design also moves the maps between passes through device memory (below),
// about 10x those bytes (about 60 GB, 18 ms at the HBM rate, a frame of
// 2048 crops), and it reaches neither rate: each tile's phases (halo
// copy, taps, product, stores) are short and separated by CTA barriers,
// and with two CTAs of 8 warps per SM, capped at 128 registers a thread,
// latency is what it waits on (PERF.md has the split). Keeping the lite
// chains on chip across a halo, and wgmma with TMA, are the next steps.
// In float32 the products run as float FMAs on the CUDA cores (67
// TFLOP/s; no TF32, which would miss the float32 bar).
//
// Passes. The TPU kernel keeps a tile of crops in VMEM. Here one stage-2
// bottleneck map is 64*32*64 bf16 (256 KB), more than a block's 227 KB of
// shared memory, and the channel gate needs each stream's mean over the
// whole map before any stream can be scaled. So one CTA owns whole crops
// (a persistent loop over crops b = blockIdx.x, +gridDim.x, ...) and walks
// each crop in tiles of whole image rows (at most TP = 128 pixels): the
// gate's mean is then a reduction inside the CTA, taken in a fixed order
// with no atomics (reproducible), and a block is ONE launch. The maps
// between passes (the lite chains' pointwise outputs y and the four stream
// outputs s) live in a per-CTA scratch region of device memory, already
// rounded to T: 12 maps of H*W*mid, written once and read back by the next
// pass. Passes over a crop:
//
//   0.  per tile: x1 tile (x . K1), then the first pointwise of the four
//       streams -> y[0][k];
//   L = 0..3, per stream k >= L, per tile: s = relu(dw(y[L%2][k]) + b);
//       the last lite of stream k writes s to scratch and adds the tile's
//       channel sums to the gate sums; the others run the next pointwise
//       -> y[(L+1)%2][k];
//   gate: four (mid -> hidden -> mid) products on the means;
//   final, per tile: x2 tile, then K3 and the downsample (or identity),
//       the residual add and relu -> out.
//
// Engine. 8 warps; warp w owns pixels 16w..16w+15 of a tile, and a product
// is computed in chunks of NC = 64 output columns, 8 n-tiles of 8 per warp
// (32 float accumulators a thread). In bf16 each 16x8x16 step is one
// mma.sync.m16n8k16 (bf16 in, float accumulate) with both operands read by
// ldmatrix from shared memory, where every tile is held in T as [pixel]
// [channel] and [depth][column] rows padded by 16 bytes (conflict-free
// ldmatrix). Depths are padded to a multiple of 16 with zeros in shared
// memory; the packed weights keep block_weights' layout. In float the same
// warp tile runs as FMAs on the CUDA cores, in the mma accumulator layout,
// so the two types share every copy and epilogue. Shared memory per CTA:
//
//   act   [TP][kp+8]        x1, the lite input (the taps' output) and x2
//                           tiles: the A operand, resident;
//   halo  [(rows+2)*W][kp+8] a tile's rows of a y map and one halo row
//                           above and below, for the 3x3 taps; the next
//                           tile's rows are copied in (cp.async) while this
//                           tile's product runs. The final pass stages the
//                           identity and the output of 64 columns here;
//   wbuf  each lite's Kp [kp][mid+8], loaded once for the whole pass over
//                           a crop (lite levels); in passes 0 and final,
//                           two 64-deep chunks of K1, Kp, K3 or Kd streamed
//                           with cp.async, so that the next chunk's copy
//                           overlaps this chunk's mma (a product over x
//                           streams x's chunks too, across halo and wbuf);
//   the gate's sums (then gates), mean and hidden layer in float.
//
// The taps: lane l of a warp takes channels 2l, 2l+1 of a run of 8 pixels
// of one row, keeps the nine taps in registers and slides the three rows
// along, 3 shared loads per output. The pointwise outputs go straight from
// the accumulators to the scratch; every other copy between device and
// shared memory moves 16 bytes a thread (cp.async in, vector stores out),
// which needs cin, mid and cout to be multiples of 8 (all OSNet widths
// are). The wrapper launches one persistent wave: as many CTAs as the SMs
// hold (osblock_ctas_per_sm; in bf16 at osnet_x1_0's widths two of 256
// threads per SM, at most 109 KB of shared memory each; in float32 one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int TP = 16 * (THREADS / 32);  // pixels per tile, 16 per warp
constexpr int NC = 64;                   // output columns per product chunk
constexpr int KC = 64;                   // depth of a streamed chunk
constexpr int PAD = 8;                   // elements added to a shared row
constexpr int LDSA = KC + PAD;           // row of a streamed A chunk
constexpr int LDSB = NC + PAD;           // row of a streamed B chunk
constexpr int N_LITES = 10;
constexpr int N_STREAMS = 4;

template <typename T>
constexpr int VEC = 16 / (int)sizeof(T);  // elements in 16 bytes

constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

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

// two neighbouring channels, as float
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zero bytes (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[p][0:C] = src[p * lds : p * lds + C] for p < npix, 16 bytes a copy
template <typename T>
__device__ void load_rows(T* dst, int ldd, const T* __restrict__ src, int lds,
                          int C, int npix) {
  const int vpr = C / VEC<T>;
  for (int e = threadIdx.x; e < npix * vpr; e += THREADS) {
    const int pp = e / vpr, c = (e - pp * vpr) * VEC<T>;
    cp_async16(dst + pp * ldd + c, src + (size_t)pp * lds + c, true);
  }
}

// dst[p * ldd : p * ldd + C] = src[p][0:C] for p < npix, 16 bytes a store
template <typename T>
__device__ void store_rows(T* __restrict__ dst, int ldd, const T* src, int lds,
                           int C, int npix) {
  const int vpr = C / VEC<T>;
  for (int e = threadIdx.x; e < npix * vpr; e += THREADS) {
    const int pp = e / vpr, c = (e - pp * vpr) * VEC<T>;
    *reinterpret_cast<uint4*>(dst + (size_t)pp * ldd + c) =
        *reinterpret_cast<const uint4*>(src + pp * lds + c);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// acc[j] += A[0:16)[0:K) . B[0:K)[8j : 8j+8) for the n-tiles j < 8 with
// 8j < nvalid: A the warp's 16 pixel rows ([pixel][depth], lda), B
// [depth][column] (ldb), both in shared memory, K a multiple of 16. The
// accumulators are in mma.m16n8k16's layout: acc[j][0..1] at row lane/4,
// columns 8j + 2*(lane%4) + 0..1; acc[j][2..3] the same 8 rows further.
template <typename T>
__device__ void warp_product(float (&acc)[8][4], const T* A, int lda,
                             const T* B, int ldb, int K, int nvalid);

// bf16: tensor cores. ldmatrix.x4 reads the 16x16 A step (lane l gives row
// l%16, depth 8*(l/16)); ldmatrix.x4.trans reads two 16x8 B steps from
// [depth][column] rows (row l%16, columns 8*(l/16)), which is the "col"
// operand layout that mma wants.
template <>
__device__ void warp_product<__nv_bfloat16>(float (&acc)[8][4],
                                            const __nv_bfloat16* A, int lda,
                                            const __nv_bfloat16* B, int ldb,
                                            int K, int nvalid) {
  const int lane = threadIdx.x & 31;
  const unsigned a_base = smem_addr(A + (lane & 15) * lda + (lane >> 4) * 8);
  const unsigned b_base = smem_addr(B + (lane & 15) * ldb + (lane >> 4) * 8);
  for (int k = 0; k < K; k += 16) {
    unsigned a[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(a_base + 2 * k));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (16 * jj >= nvalid) break;
      unsigned b[4];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
          "{%0, %1, %2, %3}, [%4];\n"
          : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
          : "r"(b_base + 2 * (k * ldb + 16 * jj)));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* c = acc[2 * jj + h];
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[2 * h]),
              "r"(b[2 * h + 1]));
      }
    }
  }
}

// float: FMAs on the CUDA cores (no TF32), in the same layout
template <>
__device__ void warp_product<float>(float (&acc)[8][4], const float* A,
                                    int lda, const float* B, int ldb, int K,
                                    int nvalid) {
  const int lane = threadIdx.x & 31;
  const float* a_lo = A + (lane >> 2) * lda;
  const float* a_hi = a_lo + 8 * lda;
  const float* b_col = B + 2 * (lane & 3);
  for (int k = 0; k < K; ++k) {
    const float a0 = a_lo[k], a1 = a_hi[k];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j >= nvalid) break;
      const float2 b =
          *reinterpret_cast<const float2*>(b_col + k * ldb + 8 * j);
      acc[j][0] += a0 * b.x;
      acc[j][1] += a0 * b.y;
      acc[j][2] += a1 * b.x;
      acc[j][3] += a1 * b.y;
    }
  }
}

// f(row, column, v0, v1) for each pair of this warp's accumulators in a
// column (chunk-relative) below nvalid; rows are tile rows 0..TP-1
template <typename F>
__device__ __forceinline__ void for_pairs(const float (&acc)[8][4], int nvalid,
                                          F f) {
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (8 * j >= nvalid) break;
    f(r, 8 * j + c, acc[j][0], acc[j][1]);
    f(r + 8, 8 * j + c, acc[j][2], acc[j][3]);
  }
}

// dst[r * ld + c] = T(acc) for the tile rows r < npix and the columns
// c < nvalid of a product chunk: stores of two channels straight from
// the accumulators (a row's 8 n-tiles fill its 128 bytes of a chunk)
template <typename T>
__device__ __forceinline__ void store_pairs(T* __restrict__ dst, int ld,
                                            const float (&acc)[8][4],
                                            int nvalid, int npix) {
  for_pairs(acc, nvalid, [&](int r, int c, float v0, float v1) {
    if (r < npix) store2(dst + (size_t)r * ld + c, v0, v1);
  });
}

// acc = A . B[:, n0 : n0 + NC] for this warp's 16 pixels of the tile. B
// ([K][N] in device memory) streams through shared memory in KC-deep
// chunks, double-buffered with cp.async. A is resident in shared memory
// (a_res, lda; stage: two [KC][LDSB] B chunks), or, when a_res is null,
// streams beside B from npix pixel rows of ld elements in device memory
// (stage: two [TP][LDSA] A chunks, then two B chunks). Rows past npix
// and depth past K read as 0.
template <typename T>
__device__ void product(float (&acc)[8][4], const T* a_res, int lda,
                        const T* __restrict__ a_glob, int ld, int npix,
                        const T* __restrict__ b, int K, int N, int n0,
                        T* stage) {
  constexpr int V = VEC<T>;
  const int warp = threadIdx.x >> 5;
  T* sa = stage;
  T* sb = a_res != nullptr ? stage : stage + 2 * TP * LDSA;
  const int nchunks = (K + KC - 1) / KC;
  auto fetch = [&](int c) {
    const int k0 = c * KC;
    T* db = sb + (c & 1) * KC * LDSB;
    for (int e = threadIdx.x; e < KC * (NC / V); e += THREADS) {
      const int kk = e / (NC / V), nn = (e - kk * (NC / V)) * V;
      const bool ok = k0 + kk < K && n0 + nn < N;
      cp_async16(db + kk * LDSB + nn,
                 ok ? b + (size_t)(k0 + kk) * N + n0 + nn : b, ok);
    }
    if (a_res == nullptr) {
      T* da = sa + (c & 1) * TP * LDSA;
      for (int e = threadIdx.x; e < TP * (KC / V); e += THREADS) {
        const int pp = e / (KC / V), kk = (e - pp * (KC / V)) * V;
        const bool ok = pp < npix && k0 + kk < K;
        cp_async16(da + pp * LDSA + kk,
                   ok ? a_glob + (size_t)pp * ld + k0 + kk : a_glob, ok);
      }
    }
    cp_async_commit();
  };
  zero(acc);
  fetch(0);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      fetch(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp * 16 < npix) {
      const int k0 = c * KC;
      const T* a = a_res != nullptr
                       ? a_res + warp * 16 * lda + k0
                       : sa + (c & 1) * TP * LDSA + warp * 16 * LDSA;
      warp_product<T>(acc, a, a_res != nullptr ? lda : LDSA,
                      sb + (c & 1) * KC * LDSB, LDSB, min(KC, round16(K - k0)),
                      N - n0);
    }
    __syncthreads();
  }
}

// act[p][c] = T(relu(dw3x3(map)[p][c] + bdw[c])) for the tile's rows
// r0 .. r0 + nrows - 1 of an H x W map, zero padded, from the halo tile
// (halo row i holds map row r0 - 1 + i). A warp takes a segment of SEG
// pixels of one row and lane l the channel pair 2(l + 32 cb) of it: the
// nine taps of that pair stay in registers (a warp keeps one cb while
// the number of 32-pair blocks divides the warps), and each of the three
// rows is read once for the segment (SEG + 2 values), so each output
// reads about 3 values, not 9, from shared memory. Float accumulation in
// the taps' order, as the TPU kernel.
constexpr int SEG = 8;
template <typename T>
__device__ void depthwise(T* act, const T* halo, int ldm,
                          const T* __restrict__ kdw,
                          const float* __restrict__ bdw, int mid, int H, int W,
                          int r0, int nrows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int segs = (W + SEG - 1) / SEG;
  const int blocks = (mid / 2 + 31) / 32;
  float2 kw[9], bias;
  int kw_block = -1;
  for (int it = warp; it < blocks * nrows * segs; it += THREADS / 32) {
    const int cb = it % blocks, rem = it / blocks;
    const int ph = rem / segs, w0 = (rem - ph * segs) * SEG;
    const int c = 2 * (32 * cb + lane);
    if (c >= mid) continue;
    if (cb != kw_block) {
#pragma unroll
      for (int j = 0; j < 9; ++j) kw[j] = load2(kdw + j * mid + c);
      bias = make_float2(bdw[c], bdw[c + 1]);
      kw_block = cb;
    }
    float2 acc[SEG];
#pragma unroll
    for (int s = 0; s < SEG; ++s) acc[s] = make_float2(0.f, 0.f);
    // branch-free: taps outside the map read zero, which adds nothing
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int hh = r0 + ph + i - 1;
      const bool row_in = hh >= 0 && hh < H;
      const T* hrow = halo + (ph + i) * W * ldm + c;
      float2 v[SEG + 2];  // columns w0 - 1 .. w0 + SEG
#pragma unroll
      for (int s = 0; s < SEG + 2; ++s) {
        const int w = w0 + s - 1;
        v[s] = row_in && w >= 0 && w < W ? load2(hrow + w * ldm)
                                         : make_float2(0.f, 0.f);
      }
      const float2 k0 = kw[3 * i], k1 = kw[3 * i + 1], k2 = kw[3 * i + 2];
#pragma unroll
      for (int s = 0; s < SEG; ++s) {
        acc[s].x += v[s].x * k0.x;
        acc[s].y += v[s].y * k0.y;
        acc[s].x += v[s + 1].x * k1.x;
        acc[s].y += v[s + 1].y * k1.y;
        acc[s].x += v[s + 2].x * k2.x;
        acc[s].y += v[s + 2].y * k2.y;
      }
    }
#pragma unroll
    for (int s = 0; s < SEG; ++s)
      if (w0 + s < W)
        store2(act + (ph * W + w0 + s) * ldm + c,
               fmaxf(acc[s].x + bias.x, 0.f), fmaxf(acc[s].y + bias.y, 0.f));
  }
}

// Offsets into the packed weights, in block_weights' order.
struct Layout {
  int k1, kp0, lite_stride, fc1, fc2, k3, kd;   // into wt
  int b1, bdw0, fb1, fb2, b3, bd;               // into wb
  Layout(int cin, int mid, int cout, int hidden) {
    k1 = 0;
    kp0 = cin * mid;
    lite_stride = mid * mid + 9 * mid;  // Kp then Kdw
    fc1 = kp0 + N_LITES * lite_stride;
    fc2 = fc1 + mid * hidden;
    k3 = fc2 + hidden * mid;
    kd = k3 + mid * cout;
    b1 = 0;
    bdw0 = mid;
    fb1 = bdw0 + N_LITES * mid;
    fb2 = fb1 + hidden;
    b3 = fb2 + mid;
    bd = b3 + cout;
  }
};

// Shared memory regions, in elements of T (see the header comment). The
// streamed A and B chunks of a product over x (K1, Kd) span halo and
// wbuf; those of a product over a resident tile sit in wbuf.
struct Smem {
  int kp, ldm, rows, act, halo, wbuf;
  Smem(int W, int mid) {
    kp = round16(mid);
    ldm = kp + PAD;
    rows = TP / W;
    act = TP * ldm;
    halo = imax(imax((rows + 2) * W, TP) * ldm, TP * LDSB);
    wbuf = imax(imax(kp * (mid + PAD), 2 * KC * LDSB),
                2 * TP * LDSA + 2 * KC * LDSB - halo);
  }
  int elems() const { return act + halo + wbuf; }
};

// Everything a launch reads from its parameters: computed on the host,
// so that the offsets stay in the constant bank, not in registers.
template <typename T>
struct Params {
  const T* x;          // (B, H, W, cin)
  T* out;              // (B, H, W, cout)
  const T* wt;         // packed matrices and dw kernels (block_weights)
  const float* wb;     // packed biases
  T* scratch;          // gridDim.x slots of 12 * H * W * mid
  int B, H, W, cin, mid, cout, hidden, has_ds;
  Layout L;
  Smem S;
};

// Two CTAs of 256 threads per SM cap a thread at 128 registers (a few
// spill); one CTA (no spills) and three (more spills) measured slower.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) osblock_kernel(Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mid = p.mid, hidden = p.hidden, cin = p.cin, cout = p.cout;
  const int H = p.H, W = p.W, HW = H * W;
  const int kp = p.S.kp, ldm = p.S.ldm, rows = p.S.rows, ldw = mid + PAD;
  T* act = reinterpret_cast<T*>(smem_raw);
  T* halo = act + p.S.act;
  T* wbuf = halo + p.S.halo;
  float* gstat = reinterpret_cast<float*>(wbuf + p.S.wbuf);  // [4][mid]
  float* gmean = gstat + N_STREAMS * mid;                    // [mid]
  float* ghid = gmean + mid;                                 // [hidden]

  const int t = threadIdx.x, warp = t >> 5;
  const int ntiles = (H + rows - 1) / rows;
  const T* wt = p.wt;
  const float* wb = p.wb;
  const size_t map = (size_t)HW * mid;
  T* y_base = p.scratch + (size_t)blockIdx.x * 12 * map;  // y[2][4]
  T* s_base = y_base + 8 * map;                            // s[4]
  auto y_map = [&](int buf, int k) {
    return y_base + (size_t)(buf * 4 + k) * map;
  };

  // the activation tile's depth padding is zero for the whole launch
  if (kp > mid)
    for (int e = t; e < TP * (kp - mid); e += THREADS)
      act[(e / (kp - mid)) * ldm + mid + e % (kp - mid)] = from_f<T>(0.f);

  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const T* xb = p.x + (size_t)b * HW * cin;
    T* ob = p.out + (size_t)b * HW * cout;
    for (int e = t; e < N_STREAMS * mid; e += THREADS) gstat[e] = 0.f;

    // ---- pass 0: x1 and the first pointwise of each stream ----------
    for (int tl = 0; tl < ntiles; ++tl) {
      const int r0 = tl * rows, pix0 = r0 * W;
      const int npix = min(rows, H - r0) * W;
      const T* xt = xb + (size_t)pix0 * cin;
      for (int n0 = 0; n0 < mid; n0 += NC) {
        float acc[8][4];
        product<T>(acc, nullptr, 0, xt, cin, npix, wt + p.L.k1, cin, mid, n0,
                   halo);
        for_pairs(acc, mid - n0, [&](int r, int c, float v0, float v1) {
          const int n = n0 + c;
          store2(act + r * ldm + n, fmaxf(v0 + wb[p.L.b1 + n], 0.f),
                 fmaxf(v1 + wb[p.L.b1 + n + 1], 0.f));
        });
      }
      __syncthreads();
      for (int k = 0; k < N_STREAMS; ++k) {
        const T* kpw = wt + p.L.kp0 + lite_index(k, 0) * p.L.lite_stride;
        for (int n0 = 0; n0 < mid; n0 += NC) {
          float acc[8][4];
          product<T>(acc, act, ldm, nullptr, 0, npix, kpw, mid, mid, n0,
                     wbuf);
          store_pairs(y_map(0, k) + (size_t)pix0 * mid + n0, mid, acc,
                      mid - n0, npix);
        }
      }
    }

    // ---- lite levels: dw3x3 + bias + relu, then the next pointwise ----
    for (int lv = 0; lv < N_STREAMS; ++lv) {
      for (int k = lv; k < N_STREAMS; ++k) {
        const int li = lite_index(k, lv);
        const bool last = lv == k;
        const T* yin = y_map(lv & 1, k);
        const T* kdw = wt + p.L.kp0 + li * p.L.lite_stride + mid * mid;
        const float* bdw = wb + p.L.bdw0 + li * mid;
        if (!last) {  // the next lite's Kp, resident for the whole pass
          const T* kpw = wt + p.L.kp0 + (li + 1) * p.L.lite_stride;
          const int vpr = mid / VEC<T>;
          for (int e = t; e < kp * vpr; e += THREADS) {
            const int kk = e / vpr, nn = (e - kk * vpr) * VEC<T>;
            cp_async16(wbuf + kk * ldw + nn,
                       kk < mid ? kpw + (size_t)kk * mid + nn : kpw, kk < mid);
          }
          cp_async_commit();
        }
        // tile tl's rows and the halo rows r0 - 1 and r0 + rows that lie
        // inside the map; halo row i holds map row r0 - 1 + i
        auto load_halo = [&](int tl) {
          const int r0 = tl * rows;
          const int h_lo = max(r0 - 1, 0), h_hi = min(r0 + rows + 1, H);
          load_rows(halo + (h_lo - r0 + 1) * W * ldm, ldm,
                    yin + (size_t)h_lo * W * mid, mid, mid, (h_hi - h_lo) * W);
          cp_async_commit();
        };
        load_halo(0);
        for (int tl = 0; tl < ntiles; ++tl) {
          const int r0 = tl * rows, pix0 = r0 * W;
          const int npix = min(rows, H - r0) * W;
          cp_async_wait<0>();
          __syncthreads();
          depthwise<T>(act, halo, ldm, kdw, bdw, mid, H, W, r0, npix / W);
          __syncthreads();
          // the taps are done with the halo: the next tile's copy overlaps
          // the rest of this one
          if (tl + 1 < ntiles) load_halo(tl + 1);
          if (last) {
            store_rows(s_base + k * map + (size_t)pix0 * mid, mid, act, ldm,
                       mid, npix);
            if (t < mid) {  // fixed order: reproducible without atomics
              float s = 0.f;
              for (int pp = 0; pp < npix; ++pp) s += to_f(act[pp * ldm + t]);
              gstat[k * mid + t] += s;
            }
          } else {
            for (int n0 = 0; n0 < mid; n0 += NC) {
              float acc[8][4];
              zero(acc);
              if (warp * 16 < npix)
                warp_product<T>(acc, act + warp * 16 * ldm, ldm, wbuf + n0,
                                ldw, kp, mid - n0);
              store_pairs(y_map((lv + 1) & 1, k) + (size_t)pix0 * mid + n0,
                          mid, acc, mid - n0, npix);
            }
          }
          __syncthreads();
        }
      }
    }

    // ---- the shared channel gate, once per stream --------------------
    // gstat[k] holds stream k's channel sums, and then its gate
    const float inv_hw = 1.f / (float)HW;
    for (int k = 0; k < N_STREAMS; ++k) {
      if (t < mid) gmean[t] = round_to<T>(gstat[k * mid + t] * inv_hw);
      __syncthreads();
      if (t < hidden) {
        float h = 0.f;
        for (int c = 0; c < mid; ++c)
          h += gmean[c] * to_f(wt[p.L.fc1 + (size_t)c * hidden + t]);
        ghid[t] = round_to<T>(fmaxf(h + wb[p.L.fb1 + t], 0.f));
      }
      __syncthreads();
      if (t < mid) {
        float g = 0.f;
        for (int j = 0; j < hidden; ++j)
          g += ghid[j] * to_f(wt[p.L.fc2 + (size_t)j * mid + t]);
        gstat[k * mid + t] = 1.f / (1.f + expf(-(g + wb[p.L.fb2 + t])));
      }
      __syncthreads();
    }

    // ---- final: x2, conv3, identity or downsample, relu ----------------
    for (int tl = 0; tl < ntiles; ++tl) {
      const int r0 = tl * rows, pix0 = r0 * W;
      const int npix = min(rows, H - r0) * W;
      constexpr int V = VEC<T>;
      const int vpr = mid / V;
      for (int e = t; e < npix * vpr; e += THREADS) {
        const int pp = e / vpr, c = (e - pp * vpr) * V;
        const size_t at = (size_t)(pix0 + pp) * mid + c;
        float a[V];
#pragma unroll
        for (int i = 0; i < V; ++i) a[i] = 0.f;
        for (int k = 0; k < N_STREAMS; ++k) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(s_base + k * map + at);
          const T* s = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int i = 0; i < V; ++i)
            a[i] += to_f(s[i]) * gstat[k * mid + c + i];
        }
        alignas(16) T v[V];
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = from_f<T>(a[i]);
        *reinterpret_cast<uint4*>(act + pp * ldm + c) =
            *reinterpret_cast<const uint4*>(v);
      }
      __syncthreads();
      const T* xt = xb + (size_t)pix0 * cin;
      for (int n0 = 0; n0 < cout; n0 += NC) {
        const int nv = min(NC, cout - n0);
        // the identity (x, or T(x . Kd + bd)) of these columns -> halo
        if (p.has_ds) {
          float acc[8][4];
          product<T>(acc, nullptr, 0, xt, cin, npix, wt + p.L.kd, cin, cout, n0,
                     halo);
          for_pairs(acc, nv, [&](int r, int c, float v0, float v1) {
            const int n = n0 + c;
            store2(halo + r * LDSB + c, v0 + wb[p.L.bd + n],
                   v1 + wb[p.L.bd + n + 1]);
          });
        } else {
          load_rows(halo, LDSB, xt + n0, cin, nv, npix);
          cp_async_commit();
          cp_async_wait<0>();
        }
        // product() synchronises before its first read, so the identity
        // tile is complete when the epilogue below reads it
        float acc[8][4];
        product<T>(acc, act, ldm, nullptr, 0, npix, wt + p.L.k3, mid, cout, n0,
                   wbuf);
        for_pairs(acc, nv, [&](int r, int c, float v0, float v1) {
          const int n = n0 + c;
          T* o = halo + r * LDSB + c;
          const float2 id = load2(o);
          store2(o, fmaxf(round_to<T>(v0 + wb[p.L.b3 + n]) + id.x, 0.f),
                 fmaxf(round_to<T>(v1 + wb[p.L.b3 + n + 1]) + id.y, 0.f));
        });
        __syncthreads();
        store_rows(ob + (size_t)pix0 * cout + n0, cout, halo, LDSB, nv, npix);
        __syncthreads();
      }
    }
  }
}

size_t smem_bytes(int W, int mid, int hidden, size_t elem) {
  return Smem(W, mid).elems() * elem +
         sizeof(float) * ((N_STREAMS + 1) * (size_t)mid + hidden);
}

// Lets osblock_kernel<T> take `smem` bytes of dynamic shared memory.
template <typename T>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(osblock_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int ctas_per_sm(int W, int mid, int hidden) {
  const size_t smem = smem_bytes(W, mid, hidden, sizeof(T));
  int n = 0;
  if (allow_smem<T>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, osblock_kernel<T>,
                                                    THREADS, smem) !=
          cudaSuccess)
    return 0;
  return n;
}

template <typename T>
int launch(const void* x, void* out, const void* wt, const void* wb,
           void* scratch, int B, int H, int W, int cin, int mid, int cout,
           int hidden, int has_ds, int grid, cudaStream_t stream) {
  Params<T> p{static_cast<const T*>(x), static_cast<T*>(out),
              static_cast<const T*>(wt), static_cast<const float*>(wb),
              static_cast<T*>(scratch), B, H, W, cin, mid, cout, hidden,
              has_ds, Layout(cin, mid, cout, hidden), Smem(W, mid)};
  const size_t smem = smem_bytes(W, mid, hidden, sizeof(T));
  cudaError_t err = allow_smem<T>(smem);
  if (err != cudaSuccess) return (int)err;
  osblock_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Widest map row the kernel takes (a tile is whole rows of at most TP
// pixels).
int osblock_max_width() { return TP; }

// Dynamic shared memory of one CTA, in bytes.
size_t osblock_smem_bytes(int W, int mid, int hidden, int bf16) {
  return smem_bytes(W, mid, hidden, bf16 ? 2 : 4);
}

// CTAs of this block's shape that one SM holds at once (0 if none).
int osblock_ctas_per_sm(int W, int mid, int hidden, int bf16) {
  return bf16 ? ctas_per_sm<__nv_bfloat16>(W, mid, hidden)
              : ctas_per_sm<float>(W, mid, hidden);
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
