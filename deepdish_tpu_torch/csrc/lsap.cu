// Scipy-exact linear sum assignment (shortest augmenting path), one warp per
// matrix, for sm_90a.
//
// Replaces the Pallas TPU kernel deepdish_tpu/ops/assignment_pallas.py
// `_kernel` (:49). Same algorithm, float32 arithmetic and tie rules as the
// plain version deepdish_tpu_torch/ops/assignment.py `solve_lsap_plain`
// (and scipy.optimize.linear_sum_assignment):
//   * rows augmented in ascending order; the Dijkstra scan starts in
//     descending column order and loses its picks by swap-with-last, kept
//     here as a scan position per column: the pick at position idx leaves
//     (position -1) and the column at position num_rem - 1 takes idx;
//   * relaxation r = ((min_val + cost[i][j]) - u[i]) - v[j], in that order,
//     rounded op by op (__fadd_rn / __fsub_rn; no fast math);
//   * argmin over the scan: the first tied position wins, unless a tied
//     column is unmatched, then the last tied unmatched one;
//   * duals: v[j] -= min_val - spc[j] for each picked column j, and
//     u[col2row[j]] += min_val - spc[j] for the matched ones (the rows the
//     scan visited); u[cur_row] += min_val; every other entry adds +0;
//   * n_rows > n_cols solves the transpose; its answer is col2row.
//
// What bounds it: not bytes (the live 32x32 block is 4 KB, ~1.3 ns at
// 3.35 TB/s) but the serial chain of Dijkstra steps (97 on the tracker's
// 32x32 timed problem), each a relaxation of the scan and an argmin over
// it. The design makes a step short: one warp owns a matrix, so nothing waits on another
// warp and there is no __syncthreads anywhere. Lane l owns columns l + 32 q
// (q < Q, unrolled, so the column state stays in registers); a step has no
// divergent branch; the argmin is two redux.sync: a min over
// order-preserving int keys of the costs, then a max over one key that
// encodes scipy's tie rule and carries the pick's row and column. Rows are
// owned the same way (u and row2col in registers), so the dual update and
// the augmenting walk are shuffles. Only the live n_rows x n_cols block of
// the cost (and a copy of u, which a scan step reads as a broadcast) sits
// in the block's shared memory, loaded with 32 coalesced loads in
// flight a lane, at an odd row stride so that the transposed store of a
// wide matrix hits 32 banks. A block is one warp and solves one matrix: an
// SM holds up to 32 such blocks, as many as their shared memory allows, so a
// batch fills the SMs without packing warps into a block. The launch (Q,
// grid, shared memory) is kernels/lsap.py `plan`'s. `sizes` is read on the
// device, so a launch needs no host sync.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxQ = 8;            // columns per lane: K <= 256
constexpr int kMaxDevices = 64;

// Order-preserving int32 key of a float: -0 and +0 share one, -inf < finite
// < +inf keep their order (NaN is not a cost).
__device__ __forceinline__ int order_key(float x) {
  int b = __float_as_int(x);
  b = b == INT_MIN ? 0 : b;                      // -0.0 ties +0.0
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// Row stride of the cost in shared memory: odd, so lanes that store one
// column of a wide matrix (stride apart) hit distinct banks. The block's
// shared memory is the K x stride cost and then u, K floats: kernels/lsap.py
// `plan` sizes it.
__device__ __forceinline__ int cost_stride(int K) { return K | 1; }

// The value of register slot q of lane l's array, for (q, l) = (k / 32,
// k % 32) given the same k in every lane: an unrolled select (a run-time
// index would put the array in local memory) and one shuffle.
template <int Q, typename T>
__device__ __forceinline__ T lane_get(const T (&a)[Q], int k) {
  T x = a[0];
#pragma unroll
  for (int q = 1; q < Q; ++q) x = (k >> 5) == q ? a[q] : x;
  return __shfl_sync(kFull, x, k & 31);
}

// lane_get for a different k in each lane: Q shuffles, then a select.
template <int Q, typename T>
__device__ __forceinline__ T lane_gather(const T (&a)[Q], int k) {
  T x = a[0];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const T y = __shfl_sync(kFull, a[q], k & 31);
    x = (k >> 5) == q ? y : x;
  }
  return x;
}

template <int Q>
__global__ void lsap_kernel(const float* __restrict__ costs,
                            const int* __restrict__ sizes,
                            int* __restrict__ out, int B, int K) {
  extern __shared__ float C[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  if (b >= B) return;
  const int S = cost_stride(K);
  float* u_copy = C + K * S;          // u as the scan reads it: a broadcast

  const int nr0 = min(max(sizes[2 * b], 0), K);
  const int nc0 = min(max(sizes[2 * b + 1], 0), K);
  const bool transposed = nr0 > nc0;
  const int n_rows = min(nr0, nc0);
  const int n_cols = max(nr0, nc0);

  // the live block, in the solved orientation (C[i * S + j]): coalesced
  // loads, 32 in flight a lane
  const float* src = costs + static_cast<size_t>(b) * K * K;
  constexpr int kRows = 32 / Q;
  for (int r0 = 0; r0 < nr0; r0 += kRows) {
    float x[kRows][Q];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int r = r0 + m, c = lane + 32 * q;
        x[m][q] = r < nr0 && c < nc0 ? src[r * K + c] : 0.f;
      }
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int r = r0 + m, c = lane + 32 * q;
        if (r < nr0 && c < nc0)
          C[transposed ? c * S + r : r * S + c] = x[m][q];
      }
    }
  }

  // lane l, slot q: column l + 32 q (spc, v, path, c2r, pos) and row
  // l + 32 q (u, r2c)
  float spc[Q], v[Q], u[Q];
  int path[Q], c2r[Q], pos[Q], r2c[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    v[q] = 0.f;
    u[q] = 0.f;
    c2r[q] = -1;
    r2c[q] = -1;
    if (lane + 32 * q < K) u_copy[lane + 32 * q] = 0.f;
  }
  __syncwarp();

  // The argmin's one max: tied unmatched columns score kTie + pos (the last
  // wins), tied matched ones kTie - 1 - pos (the first wins), which is
  // scipy's rule; below the score the key carries the column's row + 1 and
  // the column, so the max also names the next row or the sink.
  constexpr int kTie = 32 * Q;
  for (int cur_row = 0; cur_row < n_rows; ++cur_row) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int j = lane + 32 * q;
      spc[q] = INFINITY;
      path[q] = -1;
      pos[q] = j < n_cols ? n_cols - 1 - j : -1;
    }
    int i = cur_row;
    float min_val = 0.f;
    int num_rem = n_cols;
    int sink = -1;
    // a step has no divergent branch: the loads of a lane's columns issue
    // together and every update is a select
    while (sink < 0 && num_rem > 0) {
      const float* row = C + i * S;
      float cost[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) cost[q] = row[min(lane + 32 * q, K - 1)];
      const float ui = u_copy[i];
      int key[Q], packed[Q];
      int kmin = INT_MAX;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const bool live = pos[q] >= 0;
        const float r =
            __fsub_rn(__fsub_rn(__fadd_rn(min_val, cost[q]), ui), v[q]);
        const bool better = live && r < spc[q];
        spc[q] = better ? r : spc[q];
        path[q] = better ? i : path[q];
        key[q] = live ? order_key(spc[q]) : INT_MAX;
        kmin = min(kmin, key[q]);
        const int score = c2r[q] < 0 ? kTie + pos[q] : kTie - 1 - pos[q];
        packed[q] = live ? (score << 17) | ((c2r[q] + 1) << 8) | (lane + 32 * q)
                         : -1;
      }
      const int lowest = __reduce_min_sync(kFull, kmin);
      int tk = -1;
#pragma unroll
      for (int q = 0; q < Q; ++q) tk = max(tk, key[q] == lowest ? packed[q] : -1);
      const int best = __reduce_max_sync(kFull, tk);
      const int score = best >> 17;
      const int idx = score >= kTie ? score - kTie : kTie - 1 - score;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        pos[q] = pos[q] == idx ? -1 : (pos[q] == num_rem - 1 ? idx : pos[q]);
      }
      --num_rem;
      min_val = key_value(lowest);
      if (score >= kTie) {
        sink = best & 255;                       // unmatched: the scan ends
      } else {
        i = ((best >> 8) & 511) - 1;             // the pick's row scans next
      }
    }

    // dual updates, as the plain version: v[j] -= d_j and u[col2row[j]] +=
    // d_j for each picked column j, d_j = min_val - spc[j]; u[cur_row] +=
    // min_val; every other entry adds +0. A row gathers d of its column
    // from the column's lane.
    float d[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const bool picked = lane + 32 * q < n_cols && pos[q] < 0;
      d[q] = picked ? __fsub_rn(min_val, spc[q]) : 0.f;
      v[q] = __fsub_rn(v[q], d[q]);
    }
#pragma unroll
    for (int s = 0; s < Q; ++s) {                 // row lane + 32 s
      const float du = lane_gather(d, max(r2c[s], 0));
      const int r = lane + 32 * s;
      u[s] = __fadd_rn(u[s], r == cur_row ? min_val : r2c[s] >= 0 ? du : 0.f);
      if (r < K) u_copy[r] = u[s];
    }

    // augment along the alternating path. A path meets each row once, so
    // the column that each hop moves on to, row2col[path[j]], can be
    // gathered for every column first; a hop is then two shuffles from one
    // lane at once.
    int next[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) next[q] = lane_gather(r2c, max(path[q], 0));
    int j = sink;
    while (j >= 0) {
      const int r = lane_get(path, j);
      const int old = lane_get(next, j);
      if (r < 0) break;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        c2r[q] = lane + 32 * q == j ? r : c2r[q];
        r2c[q] = lane + 32 * q == r ? j : r2c[q];
      }
      if (r == cur_row) break;
      j = old;
    }
    __syncwarp();                    // u_copy as written, before the scan
  }

  int* dst = out + static_cast<size_t>(b) * K;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int k = lane + 32 * q;
    // a transposed solve's rows are the original columns: its col2row is
    // the original row -> column map
    if (k < K) dst[k] = transposed ? c2r[q] : r2c[q];
  }
}

template <int Q>
cudaError_t launch(const float* costs, const int* sizes, int* out, int B,
                   int K, int grid, int smem_bytes, int device,
                   cudaStream_t stream) {
  // the opt-in shared-memory attribute, once per (device, Q)
  static bool attribute_set[kMaxDevices];
  if (!attribute_set[device]) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(lsap_kernel<Q>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return err;
    attribute_set[device] = true;
  }
  lsap_kernel<Q><<<grid, 32, smem_bytes, stream>>>(costs, sizes, out, B, K);
  return cudaGetLastError();
}

}  // namespace

// The opt-in shared memory a block of `device` may take, in bytes, or
// -(CUDA error) if the query fails: kernels/lsap.py's capacity.
extern "C" int lsap_smem_optin(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? optin : -static_cast<int>(err);
}

// costs (B, K, K) f32, sizes (B, 2) int32, out (B, K) int32, all contiguous
// memory of CUDA device `device`, under kernels/lsap.py's plan: Q columns a
// lane, `grid` one-warp blocks (at least B), `smem_bytes` each. Launches on
// `stream` (made current on `device` for the call) and returns
// cudaGetLastError().
extern "C" int lsap_launch(const void* costs, const void* sizes, void* out,
                           int B, int K, int q, int grid, int smem_bytes,
                           int device, void* stream) {
  if (B <= 0 || K <= 0 || q < 1 || q > kMaxQ || (K + 31) / 32 != q ||
      grid < B || smem_bytes <= 0 || device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const float* c = static_cast<const float*>(costs);
  const int* s = static_cast<const int*>(sizes);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q) {
    case 1: err = launch<1>(c, s, o, B, K, grid, smem_bytes, device, st); break;
    case 2: err = launch<2>(c, s, o, B, K, grid, smem_bytes, device, st); break;
    case 3: err = launch<3>(c, s, o, B, K, grid, smem_bytes, device, st); break;
    case 4: err = launch<4>(c, s, o, B, K, grid, smem_bytes, device, st); break;
    case 5: err = launch<5>(c, s, o, B, K, grid, smem_bytes, device, st); break;
    case 6: err = launch<6>(c, s, o, B, K, grid, smem_bytes, device, st); break;
    case 7: err = launch<7>(c, s, o, B, K, grid, smem_bytes, device, st); break;
    default: err = launch<8>(c, s, o, B, K, grid, smem_bytes, device, st); break;
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
