// Scipy-exact linear sum assignment (shortest augmenting path), one CTA per
// matrix, for sm_90a.
//
// Replaces the Pallas TPU kernel deepdish_tpu/ops/assignment_pallas.py
// `_kernel` (:49). Same algorithm, float32 arithmetic and tie rules as the
// plain version deepdish_tpu_torch/ops/assignment.py `solve_lsap_plain`
// (and scipy.optimize.linear_sum_assignment):
//   * rows augmented in ascending order; Dijkstra over `remaining`, which
//     starts in descending column order and loses entries by swap-with-last;
//   * relaxation r = ((min_val + cost[i][j]) - u[i]) - v[j], in that order
//     (no multiplies, so no FMA contraction; built without fast math);
//   * argmin over positions p < num_rem: the first tied position wins,
//     unless a tied column is unmatched, then the last tied unmatched one;
//   * duals: u[r] += min_val - spc[row2col[r]] for r in SR, r != cur_row;
//     u[cur_row] += min_val; v[j] -= min_val - spc[j] for j in SC;
//   * n_rows > n_cols solves the transpose and inverts the result here.
//
// What bounds it: not bytes (a 64x64 cost is 16 KB, ~5 ns at 3.35 TB/s) but
// the serial chain of up to K augmentations x K Dijkstra steps, each a
// block-wide argmin. The design keeps that chain on chip and short: the
// cost and every state vector live in shared memory for the whole solve,
// one thread owns one column (relax is one step for the whole frontier),
// and the argmin is a warp shuffle reduction plus one shared-memory step
// across at most 8 warps. `sizes` is read from device memory, so a launch
// needs no host sync. Matrices of a batch are independent CTAs.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;

__device__ __forceinline__ float warp_min_f(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int warp_min_i(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int warp_max_i(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__global__ void lsap_kernel(const float* __restrict__ costs,
                            const int* __restrict__ sizes,
                            int* __restrict__ out, int K) {
  extern __shared__ float smem[];
  float* C = smem;            // K*K, the solved orientation
  float* u = C + K * K;       // row duals
  float* v = u + K;           // column duals
  float* spc = v + K;         // shortest path costs
  int* path = reinterpret_cast<int*>(spc + K);
  int* remaining = path + K;
  int* col2row = remaining + K;
  int* row2col = col2row + K;
  int* sr = row2col + K;
  int* sc = sr + K;
  __shared__ float red_min[kMaxWarps];
  __shared__ int red_first[kMaxWarps];
  __shared__ int red_last[kMaxWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  const int nr0 = min(max(sizes[2 * b], 0), K);
  const int nc0 = min(max(sizes[2 * b + 1], 0), K);
  const bool transposed = nr0 > nc0;
  const int n_rows = min(nr0, nc0);
  const int n_cols = max(nr0, nc0);

  const float* src = costs + static_cast<size_t>(b) * K * K;
  for (int e = tid; e < K * K; e += blockDim.x) {
    const int r = e / K, c = e - r * K;
    C[transposed ? c * K + r : e] = src[e];
  }
  if (tid < K) {
    u[tid] = 0.f;
    v[tid] = 0.f;
    col2row[tid] = -1;
    row2col[tid] = -1;
  }
  __syncthreads();

  for (int cur_row = 0; cur_row < n_rows; ++cur_row) {
    if (tid < K) {
      spc[tid] = INFINITY;
      path[tid] = -1;
      sr[tid] = 0;
      sc[tid] = 0;
      remaining[tid] = tid < n_cols ? n_cols - 1 - tid : 0;
    }
    __syncthreads();

    int i = cur_row;
    float min_val = 0.f;
    int num_rem = n_cols;
    int sink = -1;
    while (sink < 0 && num_rem > 0) {
      if (tid == 0) sr[i] = 1;
      // relax every remaining column from row i
      if (tid < n_cols && !sc[tid]) {
        const float r = ((min_val + C[i * K + tid]) - u[i]) - v[tid];
        if (r < spc[tid]) {
          spc[tid] = r;
          path[tid] = i;
        }
      }
      __syncthreads();

      // argmin over scan positions p < num_rem with scipy's tie rule
      const bool valid = tid < num_rem;
      const int col = valid ? remaining[tid] : 0;
      const float val = valid ? spc[col] : INFINITY;
      float m = warp_min_f(val);
      if (lane == 0) red_min[warp] = m;
      __syncthreads();
      float lowest = red_min[0];
      for (int w = 1; w < nwarps; ++w) lowest = fminf(lowest, red_min[w]);

      const bool tied = valid && val == lowest;
      const bool unm = tied && col2row[col] < 0;
      int first = warp_min_i(tied ? tid : K);
      int last = warp_max_i(unm ? tid : -1);
      if (lane == 0) {
        red_first[warp] = first;
        red_last[warp] = last;
      }
      __syncthreads();
      first = red_first[0];
      last = red_last[0];
      for (int w = 1; w < nwarps; ++w) {
        first = min(first, red_first[w]);
        last = max(last, red_last[w]);
      }
      const int idx = min(max(last >= 0 ? last : first, 0), K - 1);
      const int j = remaining[idx];
      const int last_rem = remaining[max(num_rem - 1, 0)];
      const int c2r_j = col2row[j];
      __syncthreads();  // every thread has read `remaining` before the swap

      if (tid == 0) {
        remaining[idx] = last_rem;
        sc[j] = 1;
      }
      num_rem -= 1;
      min_val = lowest;
      if (c2r_j < 0) {
        sink = j;
      } else {
        i = c2r_j;
      }
      __syncthreads();
    }

    // dual updates (thread = row for u, column for v)
    if (tid < K) {
      if (sr[tid] && tid != cur_row) {
        u[tid] += min_val - spc[max(row2col[tid], 0)];
      } else if (tid == cur_row) {
        u[tid] += min_val;
      }
      if (sc[tid]) v[tid] -= min_val - spc[tid];
    }
    __syncthreads();

    // augment along the alternating path (serial, short)
    if (tid == 0) {
      int j = sink;
      while (j >= 0) {
        const int r = path[j];
        if (r < 0) break;
        col2row[j] = r;
        const int old = row2col[r];
        row2col[r] = j;
        if (r == cur_row) break;
        j = old;
      }
    }
    __syncthreads();
  }

  int* dst = out + static_cast<size_t>(b) * K;
  if (!transposed) {
    if (tid < K) dst[tid] = row2col[tid];
    return;
  }
  // solved rows are the original columns: out[row2col[c]] = c
  if (tid < K) path[tid] = -1;
  __syncthreads();
  if (tid < K && row2col[tid] >= 0) path[row2col[tid]] = tid;
  __syncthreads();
  if (tid < K) dst[tid] = path[tid];
}

// Dynamic shared memory of one block: the K*K cost and nine K-vectors.
size_t lsap_smem_bytes(int K) {
  return static_cast<size_t>(K) * K * sizeof(float) +
         static_cast<size_t>(9) * K * sizeof(float);
}

}  // namespace

// Largest K one block of `device` can take: its dynamic shared memory plus
// the kernel's static reduction buffers within the opt-in per-block limit,
// and at most kMaxWarps warps. Returns -(CUDA error) if a query fails.
extern "C" int lsap_max_capacity(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, lsap_kernel);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int k = 0;
  while ((k + 32) / 32 <= kMaxWarps &&
         lsap_smem_bytes(k + 1) + attr.sharedSizeBytes <=
             static_cast<size_t>(optin)) {
    ++k;
  }
  return k;
}

// costs (B, K, K) f32, sizes (B, 2) int32, out (B, K) int32, all contiguous
// device memory. Launches on `stream` and returns cudaGetLastError().
extern "C" int lsap_launch(const void* costs, const void* sizes, void* out,
                           int B, int K, void* stream) {
  if (B <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((K + 31) / 32) * 32;
  if (threads > kMaxWarps * 32) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lsap_smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      lsap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lsap_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(costs), static_cast<const int*>(sizes),
      static_cast<int*>(out), K);
  return static_cast<int>(cudaGetLastError());
}
