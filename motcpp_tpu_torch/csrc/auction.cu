// Jacobi auction for masked, cost-limited assignment: one warp per
// problem, many problems per SM.
//
// Replaces motcpp_tpu/ops/auction_pallas.py::_auction_kernel (the TPU
// kernel that ByteTrack's and BoT-SORT's assignment stages reach through
// ops/lap.py::solve_lap_masked(impl="auction_pallas")). The plain PyTorch
// version with the same arithmetic is motcpp_tpu_torch/ops/auction.py.
//
// What bounds it on an H100: the latency of dependent bidding rounds.
// A problem reads at most one K*N cost tile (8 KB at K=64, N=32), but then
// runs a data-dependent number of rounds, each of which needs every
// bidder's best and second-best column before any price moves; on dense
// near-tie inputs the slowest problems take hundreds of rounds. Inside a
// round the chain is a warp reduction (REDUX, about 36 cycles on this
// card), a ballot, and a second reduction; shared-memory atomics (90-190
// cycles), shuffles and find-first-set (about 30 each) are kept off it.
//
// What the design does about that:
//   * one warp owns one problem, and a CTA holds as many problems as
//     shared memory allows (the host picks the warps per CTA that keep
//     the most problems resident on an SM); rounds are warp-synchronous,
//     with no block barrier, and each problem loops to its own
//     convergence (a solved problem is a fixed point of a round, so this
//     gives the matching it would get in any batch). Where that would
//     leave the card underfilled (fewer problems than one wave, or tiles
//     so large that an SM holds one), eight warps share each problem
//     instead, one problem a CTA: each takes every eighth batch of
//     bidders, and their best bids merge through shared memory behind
//     one CTA barrier a round;
//   * columns live on lanes: lane l holds the price, owner and this
//     round's best bid of columns l + 32t, t < T. A bidder's best value is
//     one warp max (__reduce_max_sync on an order-preserving float -> int
//     key), the lanes that reach it a ballot, and the first of them
//     (lowest t, then lowest lane) leaves its value out of a second warp
//     max, which gives the second best. That lane holds the column's
//     price, so it forms the bid itself;
//   * the column phase merges into the row phase: rows bid in ascending
//     order and the owning lane keeps a strictly greater running best, so
//     the lowest row wins among equal bids; prices and owners change only
//     after every bidder has bid (Jacobi). Bidders are evaluated eight at
//     a time (fewer where a lane holds several columns), each step for
//     all of them before the next, so their reductions issue back to back
//     (each warp collective is a point the compiler schedules around);
//   * the unassigned rows are a bit set held alike by every lane; each
//     round lists them in shared memory (prefix popcounts); the rows that
//     won or lost a column update it by one XOR reduction per 32-row
//     word, the rows that opted out by a ballot;
//   * a problem with no valid row or no valid column writes -1 everywhere
//     without reading its tile; otherwise only the cost rows of valid rows,
//     in 16-byte chunks that hold a valid column, are copied in with
//     cp.async, several rows per instruction.
//
// Exactness: float32 only, built with -fmad=false; costs are clipped,
// then NaN becomes BIG, as on the TPU; the bid is added in the
// reference's order (p[j*] + (v1 - v2)) + eps with v2 floored at 0; a row
// whose v1 <= 0 opts out for good; maxima are exact in any order, -0.0
// keys as +0.0 (the float comparisons treat them as equal), and both
// tie-breaks (first column for a row's best, lowest row for a column's
// best bid) hold as described above. col2row is read from the owners:
// a column's owner is the only row assigned to it, which is what the
// plain version's rebuild (the lowest row assigned to it) returns.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kBig = 1e7f;
constexpr float kClip = 1e6f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;
constexpr int kGroup = 8;  // warps on one problem where few fill the card
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a CTA can take

// Order-preserving map of a float to a signed int key, -0.0 as +0.0
// (adding +0.0 turns -0.0 into +0.0 and leaves every other value as it
// is); the map is its own inverse.
__device__ __forceinline__ int key_of(float v) {
  const int i = __float_as_int(v + 0.0f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float float_of(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__host__ __device__ __forceinline__ size_t tile_bytes(int K, int N) {
  return (static_cast<size_t>(K) * N * sizeof(float) + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ size_t list_bytes(int K) {
  return (static_cast<size_t>(K + 8) * sizeof(int) + 15) / 16 * 16;
}

// Columns a warp's lanes hold: 32 T.
__host__ __device__ __forceinline__ int lane_cols(int N) {
  return N <= 32 ? 32 : N <= 64 ? 64 : 128;
}

// One problem's slot: its tile and, per warp on it, a list of up to K
// rows and 8 more; with several warps, two rounds' worth of each warp's
// best bids and opt-outs, and their largest benefits.
__host__ __device__ __forceinline__ size_t slot_bytes(int K, int N,
                                                      int group) {
  size_t bytes = tile_bytes(K, N) + group * list_bytes(K);
  if (group > 1)
    bytes += 2 * group * (lane_cols(N) * (sizeof(float) + sizeof(int)) +
                          32 * sizeof(unsigned)) +
             32 * sizeof(float);
  return bytes;
}

// Writes the rows of the bit set `rows` to list[0, n) in ascending order,
// then 8 copies of the last one (so that a batch that starts below n
// reads rows of the set); returns n. Every lane calls it alike.
template <int KW>
__device__ __forceinline__ int list_rows(const unsigned (&rows)[KW], int* list,
                                         int lane, unsigned below) {
  int n = 0, last = -1;
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    if ((rows[w] >> lane) & 1u) list[n + __popc(rows[w] & below)] = 32 * w + lane;
    n += __popc(rows[w]);
    if (rows[w]) last = 32 * w + 31 - __clz(rows[w]);
  }
  if (lane < 8) list[n + lane] = last;
  __syncwarp();
  return n;
}

// Bids of the `count` rows at rows[0, count) (ascending; reads B entries)
// on the prices of the round's start. For each bidder: its best value v1
// (a warp max of keys), the first column that reaches it (lowest t with
// a hit in the ballot, then its lowest lane), and its second best value
// v2 (a warp max without that column, floored at 0). Each step runs for
// all B bidders before the next, so that their reductions issue back to
// back. The lane that holds a bidder's best column forms the bid from its
// own price and keeps the strictly greater running best, so the lowest
// row wins among equal bids; a row r whose best value is not positive
// opts out, which lane r % 32 records as bit r / 32 of `opted_out`.
template <int T, int B>
__device__ __forceinline__ void bid(const int* rows, int count,
                                    const float* tile, int N, int lane,
                                    unsigned lane_bit, float eps,
                                    const float (&price)[T], float (&best)[T],
                                    int (&best_row)[T], unsigned& opted_out) {
  int r[B], key[B][T], m1[B], m2[B], t_best[B];
  bool mine[B];
#pragma unroll
  for (int k = 0; k < B; ++k) {
    r[k] = rows[k];
    m1[k] = key_of(-INFINITY);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int j = lane + 32 * t;
      key[k][t] = key_of(j < N ? tile[r[k] * N + j] - price[t] : -INFINITY);
      m1[k] = max(m1[k], key[k][t]);
    }
  }
#pragma unroll
  for (int k = 0; k < B; ++k) m1[k] = __reduce_max_sync(kFull, m1[k]);
#pragma unroll
  for (int k = 0; k < B; ++k) {
    unsigned first = 0u;
    t_best[k] = 0;
#pragma unroll
    for (int t = T - 1; t >= 0; --t) {
      const unsigned hit = __ballot_sync(kFull, key[k][t] == m1[k]);
      first = hit ? hit & (0u - hit) : first;
      t_best[k] = hit ? t : t_best[k];
    }
    mine[k] = first == lane_bit;
    m2[k] = key_of(-INFINITY);
#pragma unroll
    for (int t = 0; t < T; ++t)
      if (!(mine[k] && t == t_best[k])) m2[k] = max(m2[k], key[k][t]);
  }
#pragma unroll
  for (int k = 0; k < B; ++k) m2[k] = __reduce_max_sync(kFull, m2[k]);
  // in order of rows, with selects rather than branches (a branch per
  // bidder costs more than the whole batch's arithmetic)
#pragma unroll
  for (int k = 0; k < B; ++k) {
    const float v1 = float_of(m1[k]);
    const float v2 = fmaxf(float_of(m2[k]), 0.0f);
    float p = price[0], cur = best[0];
    int cur_row = best_row[0];
#pragma unroll
    for (int t = 1; t < T; ++t) {
      p = t == t_best[k] ? price[t] : p;
      cur = t == t_best[k] ? best[t] : cur;
      cur_row = t == t_best[k] ? best_row[t] : cur_row;
    }
    const float b = (p + (v1 - v2)) + eps;
    const bool take = k < count && v1 > 0.0f && mine[k] &&
                      (cur_row < 0 || b > cur);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      best[t] = take && t == t_best[k] ? b : best[t];
      best_row[t] = take && t == t_best[k] ? r[k] : best_row[t];
    }
    const bool out = k < count && !(v1 > 0.0f) && lane == (r[k] & 31);
    opted_out |= out ? 1u << (r[k] >> 5) : 0u;
  }
}

// The last `count` bidders of a round (0 < count <= B) in the smallest
// batch that holds them.
template <int T, int B>
__device__ __forceinline__ void bid_rest(const int* rows, int count,
                                         const float* tile, int N, int lane,
                                         unsigned lane_bit, float eps,
                                         const float (&price)[T],
                                         float (&best)[T], int (&best_row)[T],
                                         unsigned& opted_out) {
  if constexpr (B > 1) {
    if (count <= B / 2) {
      bid_rest<T, B / 2>(rows, count, tile, N, lane, lane_bit, eps, price,
                         best, best_row, opted_out);
      return;
    }
  }
  bid<T, B>(rows, count, tile, N, lane, lane_bit, eps, price, best, best_row,
            opted_out);
}

// T = columns per lane, KW = 32-row words of the row sets, G = warps on
// one problem (1, or kGroup with one problem a CTA).
template <int T, int KW, int G>
__global__ void __launch_bounds__(32 * kMaxWarps)
auction_kernel(const float* __restrict__ cost,
               const unsigned char* __restrict__ row_mask,
               const unsigned char* __restrict__ col_mask,
               const float* __restrict__ thresh, int P, int K, int N,
               int vec16, float eps_frac, int max_rounds,
               int* __restrict__ row2col, int* __restrict__ col2row) {
  // bidders evaluated together: 8 at one column per lane, fewer where a
  // lane holds more (registers)
  constexpr int kBatch = 8 / T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const unsigned lane_bit = 1u << lane;
  // with G > 1 the CTA is the problem's, and its barrier is its warps'
  const int warp = threadIdx.x >> 5;
  const int gw = G > 1 ? warp : 0;
  const int prob = G > 1 ? blockIdx.x : blockIdx.x * (blockDim.x >> 5) + warp;
  if (prob >= P) return;
  unsigned char* slot = smem + (warp - gw) * slot_bytes(K, N, G);
  float* tile = reinterpret_cast<float*>(slot);
  int* list = reinterpret_cast<int*>(slot + tile_bytes(K, N) +
                                     gw * list_bytes(K));
  // with several warps: [round % 2][warp] best bids, their rows and
  // opt-outs, then each warp's largest benefit
  float* merge_best = reinterpret_cast<float*>(
      slot + tile_bytes(K, N) + G * list_bytes(K));
  int* merge_row = reinterpret_cast<int*>(merge_best + 2 * G * 32 * T);
  unsigned* merge_out =
      reinterpret_cast<unsigned*>(merge_row + 2 * G * 32 * T);
  float* merge_max = reinterpret_cast<float*>(merge_out + 2 * G * 32);
  int* out_r = row2col + static_cast<size_t>(prob) * K;
  int* out_c = col2row + static_cast<size_t>(prob) * N;

  // Masks: the valid rows as a bit set every lane holds (later the
  // unassigned rows), the valid columns per lane.
  const unsigned char* rm = row_mask + static_cast<size_t>(prob) * K;
  const unsigned char* cm = col_mask + static_cast<size_t>(prob) * N;
  unsigned rows[KW];
  unsigned any_row = 0u;
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    const int i = 32 * w + lane;
    rows[w] = __ballot_sync(kFull, i < K && rm[i]);
    any_row |= rows[w];
  }
  bool col_ok[T];
  unsigned col_bits[T];
  unsigned any_col = 0u;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int j = lane + 32 * t;
    col_ok[t] = j < N && cm[j];
    col_bits[t] = __ballot_sync(kFull, col_ok[t]);
    any_col |= col_bits[t];
  }
  if (any_row == 0u || any_col == 0u) {
    if (gw == 0) {
      for (int i = lane; i < K; i += 32) out_r[i] = -1;
      for (int j = lane; j < N; j += 32) out_c[j] = -1;
    }
    return;
  }
  int n = list_rows(rows, list, lane, lane_bit - 1u);

  // Cost rows of valid rows, only the chunks that hold a valid column.
  const float* c = cost + static_cast<size_t>(prob) * K * N;
  if (vec16) {
    // lane -> (row of the pass, 16-byte chunk of the row)
    const int chunks = N / 4;
    const int per_pass = 32 / chunks;
    const int q = lane % chunks;
    unsigned word = col_bits[0];
#pragma unroll
    for (int t = 1; t < T; ++t)
      if ((q >> 3) == t) word = col_bits[t];
    if (lane < per_pass * chunks && ((word >> ((4 * q) & 31)) & 0xfu)) {
      for (int k = gw * per_pass + lane / chunks; k < n;
           k += G * per_pass) {
        const int i = list[k];
        cp_async16(tile + i * N + 4 * q,
                   c + static_cast<size_t>(i) * N + 4 * q);
      }
    }
  } else {
    for (int k = gw; k < n; k += G) {
      const int i = list[k];
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (col_ok[t])
          cp_async4(tile + i * N + lane + 32 * t,
                    c + static_cast<size_t>(i) * N + lane + 32 * t);
    }
  }
  cp_async_wait_all();
  if constexpr (G > 1) __syncthreads();
  __syncwarp();

  // Benefits in place, four rows at a time (all four read before any is
  // written: past n the list repeats its last row, which then gets the
  // same values twice), and their largest value over valid pairs,
  // floored at 0 (the TPU kernel takes the max with 0 on invalid pairs).
  const float th = thresh[prob];
  float b_max = 0.0f;
  for (int k = 4 * gw; k < n; k += 4 * G) {
    float x[4][T];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int t = 0; t < T; ++t)
        x[u][t] = col_ok[t] ? tile[list[k + u] * N + lane + 32 * t] : 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int j = lane + 32 * t;
        if (j >= N) continue;
        float v = kNeg;
        if (col_ok[t]) {
          // clip first, then NaN -> BIG: +-inf clip to +-1e6 as on the TPU
          const float xc =
              isnan(x[u][t]) ? kBig : fminf(fmaxf(x[u][t], -kClip), kClip);
          v = th - xc;
          b_max = fmaxf(b_max, v);
        }
        tile[list[k + u] * N + j] = v;
      }
    }
  }
  b_max = float_of(__reduce_max_sync(kFull, key_of(b_max)));
  if constexpr (G > 1) {
    if (lane == 0) merge_max[gw] = b_max;
    __syncthreads();  // every row's benefits are in place past here
    for (int g = 0; g < G; ++g) b_max = fmaxf(b_max, merge_max[g]);
  }
  const float eps = fmaxf(fmaxf(b_max, 1e-6f) * eps_frac, 1e-7f);

  float price[T], best[T];
  int owner[T], best_row[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    price[t] = 0.0f;
    best[t] = 0.0f;
    owner[t] = -1;
    best_row[t] = -1;
  }
  __syncwarp();

  // The first round's bidders are the valid rows listed above.
  for (int round = 0; round < max_rounds; ++round) {
    if (round > 0) n = list_rows(rows, list, lane, lane_bit - 1u);
    if (n == 0) break;

    // Rows: kBatch at a time, then the rest; with several warps, each
    // takes every G-th batch.
    unsigned opted_out = 0u;
    int k = gw * kBatch;
    for (; k + kBatch <= n; k += G * kBatch)
      bid<T, kBatch>(list + k, kBatch, tile, N, lane, lane_bit, eps, price,
                     best, best_row, opted_out);
    if (k < n)
      bid_rest<T, kBatch>(list + k, n - k, tile, N, lane, lane_bit, eps,
                          price, best, best_row, opted_out);
    if constexpr (G > 1) {
      // Each warp's best bid per column and opt-outs, merged alike by
      // every warp: the highest bid, the lowest row among equal ones.
      // Two buffers by round parity, so one barrier a round suffices.
      const int base = (round & 1) * G;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        merge_best[((base + gw) * T + t) * 32 + lane] = best[t];
        merge_row[((base + gw) * T + t) * 32 + lane] = best_row[t];
      }
      merge_out[(base + gw) * 32 + lane] = opted_out;
      __syncthreads();
      opted_out = 0u;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        best_row[t] = -1;
        for (int g = 0; g < G; ++g) {
          const float b = merge_best[((base + g) * T + t) * 32 + lane];
          const int r = merge_row[((base + g) * T + t) * 32 + lane];
          if (r >= 0 && (best_row[t] < 0 || b > best[t] ||
                         (b == best[t] && r < best_row[t]))) {
            best[t] = b;
            best_row[t] = r;
          }
        }
      }
      for (int g = 0; g < G; ++g)
        opted_out |= merge_out[(base + g) * 32 + lane];
    }

    // Columns: the best bid takes the column; its old owner bids again.
    // The rows that opted out or won leave the set and the evicted ones
    // join it; the three are disjoint (the first two bid, the last did
    // not), so each word flips by their XOR over the lanes.
    unsigned flip[KW];
#pragma unroll
    for (int w = 0; w < KW; ++w) flip[w] = 0u;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int win = best_row[t];
      if (win >= 0) {
        const int old = owner[t];
#pragma unroll
        for (int w = 0; w < KW; ++w) {
          if ((win >> 5) == w) flip[w] ^= 1u << (win & 31);
          if (old >= 0 && (old >> 5) == w) flip[w] ^= 1u << (old & 31);
        }
        owner[t] = win;
        price[t] = best[t];
        best_row[t] = -1;
      }
    }
#pragma unroll
    for (int w = 0; w < KW; ++w)
      rows[w] ^= __ballot_sync(kFull, (opted_out >> w) & 1u) ^
                 __reduce_xor_sync(kFull, flip[w]);
    __syncwarp();
  }

  if (gw > 0) return;
  int* r2c = list;
  for (int i = lane; i < K; i += 32) r2c[i] = -1;
  __syncwarp();
#pragma unroll
  for (int t = 0; t < T; ++t)
    if (owner[t] >= 0) r2c[owner[t]] = lane + 32 * t;
  __syncwarp();
  for (int i = lane; i < K; i += 32) out_r[i] = r2c[i];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int j = lane + 32 * t;
    if (j < N) out_c[j] = owner[t];
  }
}

// Launch shape for (K, N), found once per shape: the warps per CTA (one
// problem each) that keep the most problems resident on an SM, the
// larger up to 4 on a tie (fewer CTAs to launch where most problems are
// empty, and a slow problem keeps at most three finished ones' slots),
// and how many problems that is per SM.
struct Shape {
  int warps, resident, sms;
};

Shape one_warp_shape(const void* kernel, int K, int N, cudaError_t* err) {
  static Shape chosen[257][129];
  if (chosen[K][N].warps) return chosen[K][N];
  Shape best{1, 0, 0};
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&best.sms, cudaDevAttrMultiProcessorCount,
                                  device);
  if (*err != cudaSuccess) return best;
  for (int w = 1; w <= kMaxWarps; w *= 2) {
    const size_t smem = w * slot_bytes(K, N, 1);
    if (smem > kMaxSmem) break;
    int ctas = 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, 32 * w,
                                                         smem);
    if (*err != cudaSuccess) return best;
    if (ctas * w > best.resident || (ctas * w == best.resident && w <= 4)) {
      best.resident = ctas * w;
      best.warps = w;
    }
  }
  chosen[K][N] = best;
  return best;
}

// The kernel's shared-memory limit, raised once per instantiation on each
// device: the attribute belongs to the function as loaded on the current
// device, so a second card (a shard of a stream-sharded runner) needs its
// own (one bit per device ordinal below 64).
template <int T, int KW, int G>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> raised{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (raised.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      auction_kernel<T, KW, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int T, int KW>
int launch(const float* cost, const unsigned char* row_mask,
           const unsigned char* col_mask, const float* thresh, int P, int K,
           int N, float eps_frac, int max_rounds, int* row2col, int* col2row,
           cudaStream_t stream) {
  cudaError_t err = allow_smem<T, KW, 1>();
  if (err == cudaSuccess) err = allow_smem<T, KW, kGroup>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape one = one_warp_shape(
      reinterpret_cast<const void*>(auction_kernel<T, KW, 1>), K, N, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec16 =
      N % 4 == 0 && reinterpret_cast<std::uintptr_t>(cost) % 16 == 0;
  // One warp a problem while the problems fill a wave of the card and an
  // SM holds more than one; otherwise kGroup warps on each problem.
  if (one.resident > 1 && P >= one.sms * one.resident)
    auction_kernel<T, KW, 1>
        <<<(P + one.warps - 1) / one.warps, 32 * one.warps,
           one.warps * slot_bytes(K, N, 1), stream>>>(
            cost, row_mask, col_mask, thresh, P, K, N, vec16, eps_frac,
            max_rounds, row2col, col2row);
  else
    auction_kernel<T, KW, kGroup>
        <<<P, 32 * kGroup, slot_bytes(K, N, kGroup), stream>>>(
            cost, row_mask, col_mask, thresh, P, K, N, vec16, eps_frac,
            max_rounds, row2col, col2row);
  return static_cast<int>(cudaGetLastError());
}

template <int KW>
int launch_n(const float* cost, const unsigned char* row_mask,
             const unsigned char* col_mask, const float* thresh, int P, int K,
             int N, float eps_frac, int max_rounds, int* row2col,
             int* col2row, cudaStream_t stream) {
  if (N <= 32)
    return launch<1, KW>(cost, row_mask, col_mask, thresh, P, K, N, eps_frac,
                         max_rounds, row2col, col2row, stream);
  if (N <= 64)
    return launch<2, KW>(cost, row_mask, col_mask, thresh, P, K, N, eps_frac,
                         max_rounds, row2col, col2row, stream);
  return launch<4, KW>(cost, row_mask, col_mask, thresh, P, K, N, eps_frac,
                       max_rounds, row2col, col2row, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one problem of shape (K, N) needs when
// one warp solves it.
size_t auction_smem_bytes(int K, int N) { return slot_bytes(K, N, 1); }

// Solves P problems on `stream`; returns the CUDA error of the launch.
int auction_solve(const float* cost, const unsigned char* row_mask,
                  const unsigned char* col_mask, const float* thresh, int P,
                  int K, int N, float eps_frac, int max_rounds, int* row2col,
                  int* col2row, void* stream) {
  if (P == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (K <= 64)
    return launch_n<2>(cost, row_mask, col_mask, thresh, P, K, N, eps_frac,
                       max_rounds, row2col, col2row, s);
  return launch_n<8>(cost, row_mask, col_mask, thresh, P, K, N, eps_frac,
                     max_rounds, row2col, col2row, s);
}

}  // extern "C"
