// Fused depthwise-separable block (MobileNetV1's ds layer), NHWC, for sm_90a:
//   depthwise 3x3, TF SAME padding, stride 1 or 2 -> folded BN -> ReLU6
//   -> pointwise 1x1 (f32 accumulation) -> folded BN -> ReLU6,
// with the (pixels, Cin) intermediate kept in shared memory.
//
// Replaces the Pallas TPU kernels deepdish_tpu/ops/dsconv_pallas.py
// `_dsconv_s1_kernel` (:83) and `_dsconv_s2_kernel` (:110): two kernels,
// each instantiated for stride 1 / 2. Same arithmetic as the plain version
// deepdish_tpu_torch/ops/dsconv.py `dsconv_plain` (and the TPU kernel):
//   * the depthwise sum starts at 0 and adds the nine taps in row-major
//     (i, j) order in f32, each tap x * w and each add rounded on its own
//     (__fmul_rn / __fadd_rn: nvcc may not contract them into an FMA);
//     taps outside the image read 0, at TF SAME offsets (150 -> 75 pads
//     (0, 1), 75 -> 38 pads (1, 1));
//   * acc * dw_scale + dw_bias as two rounded f32 operations, clip to [0, 6],
//     one rounding to the element type: bit-equal to the plain version;
//   * the pointwise product of that rounded intermediate with the pointwise
//     kernel accumulates in f32 (bf16 products are exact in f32, so only the
//     order of the sum differs from the plain version's matmul);
//   * y * pw_scale + pw_bias, clip, one rounding to the element type.
//
// The GEMM view: M = B*Ho*Wo output pixels (flattened, so the 19^2 and 10^2
// stages leave no ragged spatial tiles), N = Cout, K = Cin.
//
// What bounds it on the H100 (batch 32, bf16): bytes at the 150^2 and 75^2
// stages (input + output + weights at 3.35 TB/s: 138 MB = 41 us at ds1), the
// tensor-core rate at 19^2 and 10^2 (ds13: 6.7 GFLOP = 6.8 us at 989
// TFLOP/s). At batch 1 no stage is near either bound (ds13 is 0.76 us of
// work): what bounds a call there is how many SMs it keeps busy.
//
// bfloat16 (dsconv_bf16_kernel), the design for this card:
//   * operations: the pointwise product runs on the tensor cores, wgmma
//     m64nNk16 (N = the block's 64, 128 or 256 output channels) with bf16
//     operands from shared memory and the f32 sum in registers. A is the
//     depthwise intermediate, computed on CUDA cores and stored K-major in
//     wgmma's no-swizzle core-matrix layout; B is the pointwise kernel as it
//     lies in memory, (Cin, Cout) N-major, read with wgmma's transpose flag
//     (no copy per call), staged by 16-byte cp.async;
//   * overlap: one warpgroup per block; per 64-channel slice of K it starts
//     the slice's four k16 wgmmas asynchronously, then stages the next B
//     slice and computes the next A slice into the other half of a two-stage
//     ring while the tensor cores run; it waits for a wgmma group only
//     before overwriting its buffers (ptxas reports no serialized wgmma);
//   * what is left is the depthwise sum on CUDA cores: per tap and channel
//     an unpack, a multiply and an add, against one tensor-core MAC per
//     output channel of the tile. Each tap is one unconditional 16-byte load
//     of 8 channels (a tap outside the image reads 16 zero bytes, so no
//     branch holds a load back), the tap masks and window offsets are
//     computed once per block, and the bf16 -> f32 unpacking is two integer
//     operations a pair;
//   * occupancy: 128 registers a thread at block_n 64 (4 blocks an SM), 168
//     at 128 (3), 249 at 256 (2), no spills; two pixels' sums at a time and
//     a rolled B-staging loop keep the depthwise registers beside the
//     accumulators;
//   * bytes: the intermediate never goes to device memory; the epilogue
//     passes the accumulators through shared memory, so that the output
//     leaves in 16-byte stores along rows;
//   * batch 1: the launch plan (kernels/dsconv.py `plan`) splits K across
//     blocks until a call fills a wave of ~128 blocks; each split writes its
//     f32 partial sums to a workspace, and dsconv_splitk_epilogue adds them
//     in split order (deterministic, no atomics), then BN, ReLU6, rounding.
//   The depthwise sum is recomputed once per N tile (Cout / block_n times)
//   and each block re-reads its 64-channel slices of the pointwise kernel:
//   those two, not the product, are what the kernel spends its time on. The
//   plan's block_n trades the recomputation against blocks an SM. Times on
//   an H100 SXM at 700 W, against cuDNN's two-convolution composition and
//   the bound, are in PERF.md section 5 (chip_smoke.py phase 3).
//
// float32 (dsconv_f32_kernel) is the parity configuration and keeps the
// CUDA-core product (wgmma has no full-f32 mode, and TF32 would break the
// f32 tolerance): one block owns 64 pixels x 64 output channels and loops
// over Cin in slices of 32, the intermediate in shared memory, 4 x 4 outputs
// per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.f), 6.f);
}

// TF SAME: the padding before the first row (column) of one axis
int same_pad_before(int size, int stride) {
  const int out = (size + stride - 1) / stride;
  const int total = (out - 1) * stride + 3 - size;
  return total > 0 ? total / 2 : 0;
}

// ------------------------------------------------------------------ float32

constexpr int kTileM = 64;    // output pixels per block
constexpr int kTileN = 64;    // output channels per block
constexpr int kTileK = 32;    // input channels per slice (one warp's lanes)
constexpr int kThreads = 256;
constexpr int kPixPerThread = kTileM * kTileK / kThreads;   // 8

template <int S>
__global__ void __launch_bounds__(kThreads)
    dsconv_f32_kernel(const float* __restrict__ x, const float* __restrict__ dw,
                      const float* __restrict__ dw_scale,
                      const float* __restrict__ dw_bias,
                      const float* __restrict__ pw,
                      const float* __restrict__ pw_scale,
                      const float* __restrict__ pw_bias, float* __restrict__ out,
                      int B, int H, int W, int Cin, int Cout, int Ho, int Wo,
                      int pad_top, int pad_left, int n_tiles) {
  // A tile pixel-major with one pad column: the depthwise stores (a warp =
  // 32 channels of one pixel) and the product's loads (2 pixels per warp,
  // 4 rows apart) are both free of bank conflicts
  __shared__ float a_s[kTileM][kTileK + 1];
  __shared__ __align__(16) float b_s[kTileK][kTileN];
  __shared__ long long pix_base[kTileM];   // offset of x[b, 0, 0, 0]; -1 past M
  __shared__ int pix_y[kTileM];            // top input row of the 3x3 window
  __shared__ int pix_x[kTileM];            // left input column

  const int tid = threadIdx.x;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * kTileM;
  const int n0 = (blockIdx.x % n_tiles) * kTileN;

  if (tid < kTileM) {
    const long long m = m0 + tid;
    if (m < M) {
      const int ox = static_cast<int>(m % Wo);
      const long long r = m / Wo;
      const int oy = static_cast<int>(r % Ho);
      const long long b = r / Ho;
      pix_base[tid] = b * H * W * Cin;
      pix_y[tid] = oy * S - pad_top;
      pix_x[tid] = ox * S - pad_left;
    } else {
      pix_base[tid] = -1;
    }
  }

  const int lane_c = tid % kTileK;      // depthwise: channel in the slice
  const int pix0 = tid / kTileK;        // and pixels pix0 + 8q
  const int ty = tid / (kTileN / 4);    // product: rows ty*4 .. ty*4+3
  const int tx = tid % (kTileN / 4);    // columns tx*4 .. tx*4+3
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < Cin; k0 += kTileK) {
    __syncthreads();  // pixel table written; last slice's tiles consumed

    // depthwise 3x3 + BN + ReLU6 of this slice
    const int c = k0 + lane_c;
    const bool c_ok = c < Cin;
    float w[9];
    float s = 0.f, bias = 0.f;
    if (c_ok) {
#pragma unroll
      for (int t = 0; t < 9; ++t) w[t] = dw[t * Cin + c];
      s = dw_scale[c];
      bias = dw_bias[c];
    }
#pragma unroll
    for (int q = 0; q < kPixPerThread; ++q) {
      const int p = pix0 + q * (kThreads / kTileK);
      const long long base = pix_base[p];
      float mid = 0.f;
      if (c_ok && base >= 0) {
        const int y0 = pix_y[p], x0 = pix_x[p];
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int iy = y0 + i;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int ix = x0 + j;
            float v = 0.f;
            if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
              v = x[base + (static_cast<long long>(iy) * W + ix) * Cin + c];
            }
            sum = __fadd_rn(sum, __fmul_rn(v, w[i * 3 + j]));
          }
        }
        mid = relu6(__fadd_rn(__fmul_rn(sum, s), bias));
      }
      a_s[p][lane_c] = mid;
    }

    // the matching slice of the pointwise kernel; zeros past Cin and Cout
    for (int e = tid; e < kTileK * kTileN; e += kThreads) {
      const int kk = e / kTileN, nn = e % kTileN;
      const int k = k0 + kk, n = n0 + nn;
      b_s[kk][nn] =
          (k < Cin && n < Cout) ? pw[static_cast<long long>(k) * Cout + n] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = a_s[ty * 4 + r][kk];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(a, bv[cc], acc[r][cc]);
      }
    }
  }

  // pointwise BN + ReLU6, NHWC store
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long m = m0 + ty * 4 + r;
    if (m >= M) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = n0 + tx * 4 + cc;
      if (n < Cout) {
        out[m * Cout + n] =
            relu6(__fadd_rn(__fmul_rn(acc[r][cc], pw_scale[n]), pw_bias[n]));
      }
    }
  }
}

template <int S>
cudaError_t launch_f32(const float* x, const float* dw, const float* dw_scale,
                       const float* dw_bias, const float* pw,
                       const float* pw_scale, const float* pw_bias, float* out,
                       int B, int H, int W, int Cin, int Cout,
                       cudaStream_t stream) {
  const int Ho = (H + S - 1) / S, Wo = (W + S - 1) / S;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const long long m_tiles = (M + kTileM - 1) / kTileM;
  const int n_tiles = (Cout + kTileN - 1) / kTileN;
  if (m_tiles * n_tiles > INT_MAX) return cudaErrorInvalidValue;
  dsconv_f32_kernel<S><<<static_cast<int>(m_tiles * n_tiles), kThreads, 0,
                         stream>>>(
      x, dw, dw_scale, dw_bias, pw, pw_scale, pw_bias, out, B, H, W, Cin, Cout,
      Ho, Wo, same_pad_before(H, S), same_pad_before(W, S), n_tiles);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;     // output pixels per block: one wgmma m64
constexpr int kBK = 64;     // input channels per slice of K
constexpr int kWG = 128;    // one warpgroup
constexpr int kPixPerWG = kBM * (kBK / 8) / kWG;   // 4 pixels x 8 channels
// A slice: kBK / 8 column groups x kBM / 8 row groups of 128-byte core
// matrices, K-major; B slice: block_n / 8 x kBK / 8 core matrices, N-major
constexpr int kABytes = kBM * kBK * 2;
constexpr uint32_t kALbo = (kBM / 8) * 128;   // next 8 channels of A
constexpr uint32_t kASbo = 128;               // next 8 pixels of A
constexpr uint32_t kBLbo = 128;               // next 8 channels of B
constexpr uint32_t kBSbo = (kBK / 8) * 128;   // next 8 output channels of B

constexpr int kPixValid = 1 << 9;   // pixel-table mask bit: m < M

constexpr int smem_bytes(int bn) {
  return 2 * kABytes + 2 * kBK * bn * 2 + kBM * (4 + 4);
}

struct Bf16Args {
  const bf16* x;
  const bf16* dw;
  const float* dw_scale;
  const float* dw_bias;
  const bf16* pw;
  const float* pw_scale;
  const float* pw_bias;
  bf16* out;
  float* partial;   // (k_splits, M, Cout) f32 when K is split, else null
  long long M;
  int H, W, Cin, Cout, Ho, Wo, pad_top, pad_left;
  int m_tiles, n_tiles, k_chunk;
  int x_vec;        // x, dw, dw_scale, dw_bias take 16-byte loads
  int b_vec;        // pw rows take 16-byte copies
};

// 8 bf16 as f32, zero where !ok. VEC: one 16-byte load, unconditional
// (the caller passes a valid address even when !ok) so that the compiler can
// hoist a tap's loads ahead of the arithmetic; else masked scalar loads of
// the first n.
template <bool VEC>
__device__ __forceinline__ void load8(const bf16* src, int n, bool ok,
                                      float (&v)[8]) {
  if constexpr (VEC) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
    const uint32_t w[4] = {ok ? u.x : 0u, ok ? u.y : 0u, ok ? u.z : 0u,
                           ok ? u.w : 0u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = ok && e < n ? __bfloat162float(src[e]) : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void load8(const float* src, int n, float (&v)[8]) {
  if constexpr (VEC) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < n ? src[e] : 0.f;
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 zero bytes: the tap that falls outside the image reads them
__device__ const uint4 kZeros = {0, 0, 0, 0};

// The 64 x 64 depthwise intermediate of channels [k0, min(k0 + 64, k_end))
// into an A slice. Thread: 8 channels (one 16-byte chunk) of 4 pixels,
// taken 2 at a time; a warp reads 4 pixels x 8 chunks, 128 contiguous bytes
// a pixel. Each tap is one unconditional load (a tap outside the image reads
// kZeros), so a row of taps has its loads in flight together, and the
// integer work per tap is one add and one select of the address.
template <bool VEC>
__device__ __forceinline__ void depthwise(const Bf16Args& p,
                                          unsigned char* a_buf,
                                          const int* pix_off,
                                          const int* pix_mask, int k0,
                                          int k_end, int tid) {
  constexpr int kPass = 2;                 // pixels summed together
  const int lane = tid & 31, warp = tid >> 5;
  const int chunk = lane & 7;
  const int c = k0 + chunk * 8;
  const int nvalid = min(8, k_end - c);   // VEC: 8, or <= 0 past the slice
#pragma unroll 1
  for (int q0 = 0; q0 < kPixPerWG; q0 += kPass) {
    uint4 mid[kPass];
#pragma unroll
    for (int q = 0; q < kPass; ++q) mid[q] = make_uint4(0, 0, 0, 0);
    if (nvalid > 0) {
      int off[kPass];
      int mask[kPass];
#pragma unroll
      for (int q = 0; q < kPass; ++q) {
        const int m = (lane >> 3) + 4 * warp + 16 * (q0 + q);
        off[q] = pix_off[m] + c;
        mask[q] = pix_mask[m];
      }
      float sum[kPass][8];
#pragma unroll
      for (int q = 0; q < kPass; ++q) {
#pragma unroll
        for (int e = 0; e < 8; ++e) sum[q][e] = 0.f;
      }
#pragma unroll 1
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int t = i * 3 + j;
          const int tap = (i * p.W + j) * p.Cin;
          float w[8];
          load8<VEC>(p.dw + t * p.Cin + c, nvalid, true, w);
#pragma unroll
          for (int q = 0; q < kPass; ++q) {
            const bool ok = (mask[q] >> t) & 1;
            float v[8];
            load8<VEC>(ok ? p.x + (off[q] + tap)
                          : reinterpret_cast<const bf16*>(&kZeros),
                       nvalid, ok, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              sum[q][e] = __fadd_rn(sum[q][e], __fmul_rn(v[e], w[e]));
            }
          }
        }
      }
      float sc[8], bi[8];
      load8<VEC>(p.dw_scale + c, nvalid, sc);
      load8<VEC>(p.dw_bias + c, nvalid, bi);
#pragma unroll
      for (int q = 0; q < kPass; ++q) {
        if (!(mask[q] & kPixValid)) continue;   // past M: the row stays 0
        float r[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          r[e] = relu6(__fadd_rn(__fmul_rn(sum[q][e], sc[e]), bi[e]));
        }
        mid[q] = make_uint4(pack2(r[0], r[1]), pack2(r[2], r[3]),
                            pack2(r[4], r[5]), pack2(r[6], r[7]));
      }
    }
#pragma unroll
    for (int q = 0; q < kPass; ++q) {
      const int m = (lane >> 3) + 4 * warp + 16 * (q0 + q);
      *reinterpret_cast<uint4*>(a_buf + (chunk * (kBM / 8) + (m >> 3)) * 128 +
                                (m & 7) * 16) = mid[q];
    }
  }
}

__device__ __forceinline__ void produce_a(const Bf16Args& p,
                                          unsigned char* a_buf,
                                          const int* pix_off,
                                          const int* pix_mask, int k0,
                                          int k_end, int tid) {
  if (p.x_vec) {
    depthwise<true>(p, a_buf, pix_off, pix_mask, k0, k_end, tid);
  } else {
    depthwise<false>(p, a_buf, pix_off, pix_mask, k0, k_end, tid);
  }
}

// Rows [k0, min(k0 + 64, k_end)) x columns [n0, n0 + BN) of the pointwise
// kernel into a B slice, zeros past k_end and Cout. Eight consecutive lanes
// take the 8 rows of one core matrix (all 32 banks), four core matrices
// side by side (64 contiguous bytes of each row).
template <int BN>
__device__ __forceinline__ void stage_b(const Bf16Args& p,
                                        unsigned char* b_buf, int k0,
                                        int k_end, int n0, int tid) {
#pragma unroll 1   // unrolled, its per-thread addresses would take registers
  for (int r = 0; r < kBK * BN / 8 / kWG; ++r) {
    const int e = tid + r * kWG;
    const int k = (e & 7) + 8 * ((e >> 5) & 7);
    const int nc = ((e >> 3) & 3) + 4 * (e >> 8);
    unsigned char* dst = b_buf + (nc * (kBK / 8) + (k >> 3)) * 128 +
                         (k & 7) * 16;
    const int kk = k0 + k, n = n0 + nc * 8;
    if (p.b_vec) {
      const bool ok = kk < k_end && n < p.Cout;   // Cout % 8 == 0
      hopper::cp_async16(
          dst, ok ? p.pw + static_cast<long long>(kk) * p.Cout + n : p.pw,
          ok ? 16 : 0);
    } else {
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kk < k_end) {
        load8<false>(p.pw + static_cast<long long>(kk) * p.Cout + n,
                     p.Cout - n, true, v);
      }
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                     pack2(v[6], v[7]));
    }
  }
}

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t a,
                                    uint64_t b) {
  if constexpr (BN == 64) {
    hopper::wgmma_m64n64k16(d, a, b);
  } else if constexpr (BN == 128) {
    hopper::wgmma_m64n128k16(d, a, b);
  } else {
    hopper::wgmma_m64n256k16(d, a, b);
  }
}

// Blocks an SM should hold: the register cap this sets (65536 / (128 x
// blocks)) holds the 64 x BN f32 accumulators and a row of tap loads
// without spilling.
constexpr int min_blocks(int bn) { return bn == 64 ? 4 : bn == 128 ? 3 : 2; }

// One block: 64 output pixels x BN output channels over K split
// blockIdx.x / (m_tiles * n_tiles), the (m, n) tile by the rest, n fastest
// (blocks of one pixel tile run together and share their taps in L2).
template <int BN, int S>
__global__ void __launch_bounds__(kWG, min_blocks(BN))
    dsconv_bf16_kernel(const Bf16Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* a_s = smem;                       // 2 A slices
  unsigned char* b_s = smem + 2 * kABytes;         // 2 B slices
  // per output pixel: element offset of x[b, y0, x0, 0] (the window's top
  // left, possibly outside the image; x has < 2^31 elements, the launcher
  // checks) and a mask of its taps inside it
  int* pix_off = reinterpret_cast<int*>(b_s + 2 * kBK * BN * 2);
  int* pix_mask = pix_off + kBM;

  const int tid = threadIdx.x;
  const int tiles = p.m_tiles * p.n_tiles;
  const int split = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const long long m0 = static_cast<long long>(tile / p.n_tiles) * kBM;
  const int n0 = (tile % p.n_tiles) * BN;
  const int k_begin = split * p.k_chunk;
  const int k_end = min(p.Cin, k_begin + p.k_chunk);
  const int n_slices = (k_end - k_begin + kBK - 1) / kBK;

  if (tid < kBM) {
    const long long m = m0 + tid;
    int mask = 0, off = 0;
    if (m < p.M) {   // M < 2^31 (the launcher checks): 32-bit divisions
      const int mi = static_cast<int>(m);
      const int ox = mi % p.Wo, r = mi / p.Wo;
      const int oy = r % p.Ho, b = r / p.Ho;
      const int y0 = oy * S - p.pad_top, x0 = ox * S - p.pad_left;
      off = ((b * p.H + y0) * p.W + x0) * p.Cin;
      mask = kPixValid;
      for (int t = 0; t < 9; ++t) {
        const int iy = y0 + t / 3, ix = x0 + t % 3;
        if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) mask |= 1 << t;
      }
    }
    pix_off[tid] = off;
    pix_mask[tid] = mask;
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  hopper::fence_operands(acc);   // the zeros are set before any wgmma

  stage_b<BN>(p, b_s, k_begin, k_end, n0, tid);
  hopper::cp_async_commit();
  produce_a(p, a_s, pix_off, pix_mask, k_begin, k_end, tid);

  for (int s = 0; s < n_slices; ++s) {
    hopper::cp_async_wait_all();
    hopper::fence_proxy_async();
    __syncthreads();   // slice s of A and B complete in shared memory

    const int k0 = k_begin + s * kBK;
    const unsigned char* a = a_s + (s & 1) * kABytes;
    const unsigned char* b = b_s + (s & 1) * (kBK * BN * 2);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {   // a short slice is zero-padded
      mma<BN>(acc, hopper::desc(a + j * 2 * kALbo, kALbo, kASbo),
              hopper::desc(b + j * 2 * kBLbo, kBLbo, kBSbo));
    }
    hopper::wgmma_commit();

    if (s + 1 < n_slices) {
      // slice s - 1's wgmmas, the last readers of the other buffers, done
      hopper::wgmma_wait<1>();
      __syncthreads();   // every warp's share of them
      const int nxt = (s + 1) & 1;
      stage_b<BN>(p, b_s + nxt * (kBK * BN * 2), k0 + kBK, k_end, n0, tid);
      hopper::cp_async_commit();
      produce_a(p, a_s + nxt * kABytes, pix_off, pix_mask, k0 + kBK, k_end,
                tid);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);

  // epilogue through shared memory, the rings being free now: the
  // accumulators as a 64 x BN f32 tile (row stride BN + 8 floats, so a
  // warp's float2 stores take the minimum two wavefronts), then 8
  // consecutive outputs a thread, consecutive threads along a row: 16-byte
  // bf16 stores (BN + ReLU6 + one rounding), or 32-byte f32 partial sums
  // when K is split
  constexpr int kLd = BN + 8;
  static_assert(kBM * kLd * 4 <= 2 * kABytes + 2 * kBK * BN * 2,
                "the f32 acc_s fits in the A and B rings");
  float* acc_s = reinterpret_cast<float*>(smem);
  __syncthreads();   // every warp's share of the last wgmmas is done
  {
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<float2*>(acc_s + row * kLd + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
  __syncthreads();
  const bool vec = (p.Cout & 7) == 0;
#pragma unroll 1
  for (int e = tid; e < kBM * BN / 8; e += kWG) {
    const int row = e / (BN / 8), col = (e % (BN / 8)) * 8;
    const long long m = m0 + row;
    const int n = n0 + col;
    if (m >= p.M || n >= p.Cout) continue;
    const int nv = min(8, p.Cout - n);
    const float4 lo = *reinterpret_cast<const float4*>(acc_s + row * kLd + col);
    const float4 hi =
        *reinterpret_cast<const float4*>(acc_s + row * kLd + col + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if (p.partial != nullptr) {
      float* dst = p.partial + (split * p.M + m) * p.Cout + n;
      if (vec) {
        reinterpret_cast<float4*>(dst)[0] = lo;
        reinterpret_cast<float4*>(dst)[1] = hi;
      } else {
        for (int k = 0; k < nv; ++k) dst[k] = v[k];
      }
      continue;
    }
    float sc[8], bi[8];
    if (vec) {
      load8<true>(p.pw_scale + n, nv, sc);
      load8<true>(p.pw_bias + n, nv, bi);
    } else {
      load8<false>(p.pw_scale + n, nv, sc);
      load8<false>(p.pw_bias + n, nv, bi);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = relu6(__fadd_rn(__fmul_rn(v[k], sc[k]), bi[k]));
    }
    bf16* dst = p.out + m * p.Cout + n;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                     pack2(v[6], v[7]));
    } else {
      for (int k = 0; k < nv; ++k) dst[k] = __float2bfloat16_rn(v[k]);
    }
  }
}

// Split K: out = bf16(relu6(sum_s partial[s] * pw_scale + pw_bias)), the
// splits added in order 0, 1, ... (the same order on every run).
__global__ void dsconv_splitk_epilogue(const float* __restrict__ partial,
                                       int k_splits, long long mn, int Cout,
                                       const float* __restrict__ pw_scale,
                                       const float* __restrict__ pw_bias,
                                       bf16* __restrict__ out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < mn; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(i % Cout);
    float y = partial[i];
    for (int s = 1; s < k_splits; ++s) y = __fadd_rn(y, partial[s * mn + i]);
    out[i] = __float2bfloat16_rn(
        relu6(__fadd_rn(__fmul_rn(y, pw_scale[n]), pw_bias[n])));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int BN, int S>
cudaError_t launch_bf16(const Bf16Args& p, int k_splits, cudaStream_t stream) {
  auto kernel = dsconv_bf16_kernel<BN, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(BN));
  if (err != cudaSuccess) return err;
  const long long grid =
      static_cast<long long>(p.m_tiles) * p.n_tiles * k_splits;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<int>(grid), kWG, smem_bytes(BN), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || k_splits == 1) return err;
  const long long mn = p.M * p.Cout;
  const long long blocks = (mn + 255) / 256;
  dsconv_splitk_epilogue<<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                           256, 0, stream>>>(p.partial, k_splits, mn, p.Cout,
                                             p.pw_scale, p.pw_bias, p.out);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_bf16_n(const Bf16Args& p, int block_n, int k_splits,
                          cudaStream_t stream) {
  switch (block_n) {
    case 64: return launch_bf16<64, S>(p, k_splits, stream);
    case 128: return launch_bf16<128, S>(p, k_splits, stream);
    case 256: return launch_bf16<256, S>(p, k_splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, H, W, Cin), dw (3, 3, Cin), pw (Cin, Cout) float32; dw_scale,
// dw_bias (Cin,) and pw_scale, pw_bias (Cout,) float32; out (B,
// ceil(H/stride), ceil(W/stride), Cout) float32. All contiguous device
// memory. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments it cannot take).
extern "C" int dsconv_f32_launch(const void* x, const void* dw,
                                 const void* dw_scale, const void* dw_bias,
                                 const void* pw, const void* pw_scale,
                                 const void* pw_bias, void* out, int B, int H,
                                 int W, int Cin, int Cout, int stride,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (stride == 1) {
    err = launch_f32<1>(f(x), f(dw), f(dw_scale), f(dw_bias), f(pw),
                        f(pw_scale), f(pw_bias), static_cast<float*>(out), B,
                        H, W, Cin, Cout, s);
  } else if (stride == 2) {
    err = launch_f32<2>(f(x), f(dw), f(dw_scale), f(dw_bias), f(pw),
                        f(pw_scale), f(pw_bias), static_cast<float*>(out), B,
                        H, W, Cin, Cout, s);
  }
  return static_cast<int>(err);
}

// The same block in bfloat16 (x, dw, pw, out bf16; BN vectors float32), with
// the launch plan of kernels/dsconv.py `plan`: block_n output channels per
// block (64, 128 or 256) and K split into chunks of k_chunk channels (a
// multiple of 16); when that makes more than one split, `partial` is an f32
// workspace of (ceil(Cin / k_chunk), M, Cout), M = B * Ho * Wo.
extern "C" int dsconv_bf16_launch(const void* x, const void* dw,
                                  const void* dw_scale, const void* dw_bias,
                                  const void* pw, const void* pw_scale,
                                  const void* pw_bias, void* out,
                                  void* partial, int B, int H, int W, int Cin,
                                  int Cout, int stride, int block_n,
                                  int k_chunk, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      (stride != 1 && stride != 2) || k_chunk <= 0 || k_chunk % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k_splits = (Cin + k_chunk - 1) / k_chunk;
  if (k_splits > 1 && partial == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Bf16Args p;
  p.x = static_cast<const bf16*>(x);
  p.dw = static_cast<const bf16*>(dw);
  p.dw_scale = static_cast<const float*>(dw_scale);
  p.dw_bias = static_cast<const float*>(dw_bias);
  p.pw = static_cast<const bf16*>(pw);
  p.pw_scale = static_cast<const float*>(pw_scale);
  p.pw_bias = static_cast<const float*>(pw_bias);
  p.out = static_cast<bf16*>(out);
  p.partial = k_splits > 1 ? static_cast<float*>(partial) : nullptr;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.Ho = (H + stride - 1) / stride;
  p.Wo = (W + stride - 1) / stride;
  p.M = static_cast<long long>(B) * p.Ho * p.Wo;
  p.pad_top = same_pad_before(H, stride);
  p.pad_left = same_pad_before(W, stride);
  if (static_cast<long long>(B) * H * W * Cin > INT_MAX) {   // 32-bit offsets
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.m_tiles = static_cast<int>((p.M + kBM - 1) / kBM);
  p.n_tiles = (Cout + block_n - 1) / block_n;
  p.k_chunk = k_chunk;
  p.x_vec = Cin % 8 == 0 && aligned16(x) && aligned16(dw) &&
            aligned16(dw_scale) && aligned16(dw_bias);
  p.b_vec = Cout % 8 == 0 && aligned16(pw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = stride == 1
                              ? launch_bf16_n<1>(p, block_n, k_splits, s)
                              : launch_bf16_n<2>(p, block_n, k_splits, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of one bf16 block of block_n output channels (the
// A and B rings and the pixel table), or -1 for a width it does not take.
extern "C" int dsconv_bf16_smem_bytes(int block_n) {
  return block_n == 64 || block_n == 128 || block_n == 256
             ? smem_bytes(block_n)
             : -1;
}
