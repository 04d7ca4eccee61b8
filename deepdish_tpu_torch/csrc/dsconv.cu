// Fused depthwise-separable block (MobileNetV1's ds layer), NHWC, for sm_90a:
//   depthwise 3x3, TF SAME padding, stride 1 or 2 -> folded BN -> ReLU6
//   -> pointwise 1x1 (f32 accumulation) -> folded BN -> ReLU6,
// with the (pixels, Cin) intermediate kept in shared memory.
//
// Replaces the Pallas TPU kernels deepdish_tpu/ops/dsconv_pallas.py
// `_dsconv_s1_kernel` (:83) and `_dsconv_s2_kernel` (:110): one template,
// instantiated for float / __nv_bfloat16 and stride 1 / 2. Same arithmetic as
// the plain version deepdish_tpu_torch/ops/dsconv.py `dsconv_plain` (and the
// TPU kernel):
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
// What bounds it on the H100 (batch 32, bf16): bytes at the 150^2 and 75^2
// stages (input + output + weights at 3.35 TB/s, e.g. 138 MB = 41 us at ds1),
// the tensor-core rate at 19^2 and 10^2 (ds13: 6.7 GFLOP = 6.8 us at
// 989 TFLOP/s). The design answers the bytes side: the intermediate never
// goes to device memory, so the block reads its input once from DRAM (the
// nine taps of neighbouring pixels hit L1/L2) and writes its output once.
// It does not answer the operations side: the product runs on CUDA cores
// (FMA in f32 registers, 4x4 outputs per thread), well above the tensor-core
// bound at 19^2 and 10^2; wgmma and TMA are later work.
//
// Tiling: the GEMM view is M = B*Ho*Wo output pixels (flattened, so the 10^2
// and 19^2 stages leave no ragged spatial tiles), N = Cout, K = Cin. One
// block owns 64 pixels x 64 output channels and loops over Cin in slices of
// 32: per slice it computes the 64 x 32 depthwise intermediate (one thread
// per channel and 8 pixels, each tap a coalesced read along C), stores it
// rounded in shared memory as the A tile, stages the 32 x 64 slice of the
// pointwise kernel as the B tile, and accumulates. The depthwise work is
// recomputed once per Cout tile: at Cout = 1024 (16 tiles) that is 9
// multiply-adds per pixel-channel per tile against 64 for the tile's share
// of the product, ~14% extra work, in exchange for no intermediate traffic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTileM = 64;    // output pixels per block
constexpr int kTileN = 64;    // output channels per block
constexpr int kTileK = 32;    // input channels per slice (one warp's lanes)
constexpr int kThreads = 256;
constexpr int kPixPerThread = kTileM * kTileK / kThreads;   // 8

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

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.f), 6.f);
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
    dsconv_kernel(const T* __restrict__ x, const T* __restrict__ dw,
                  const float* __restrict__ dw_scale,
                  const float* __restrict__ dw_bias,
                  const T* __restrict__ pw, const float* __restrict__ pw_scale,
                  const float* __restrict__ pw_bias, T* __restrict__ out,
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

    // depthwise 3x3 + BN + ReLU6 of this slice, rounded once to T
    const int c = k0 + lane_c;
    const bool c_ok = c < Cin;
    float w[9];
    float s = 0.f, bias = 0.f;
    if (c_ok) {
#pragma unroll
      for (int t = 0; t < 9; ++t) w[t] = to_f32(dw[t * Cin + c]);
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
              v = to_f32(x[base + (static_cast<long long>(iy) * W + ix) * Cin +
                           c]);
            }
            sum = __fadd_rn(sum, __fmul_rn(v, w[i * 3 + j]));
          }
        }
        mid = to_f32(from_f32<T>(relu6(__fadd_rn(__fmul_rn(sum, s), bias))));
      }
      a_s[p][lane_c] = mid;
    }

    // the matching slice of the pointwise kernel; zeros past Cin and Cout
    for (int e = tid; e < kTileK * kTileN; e += kThreads) {
      const int kk = e / kTileN, nn = e % kTileN;
      const int k = k0 + kk, n = n0 + nn;
      b_s[kk][nn] = (k < Cin && n < Cout)
                        ? to_f32(pw[static_cast<long long>(k) * Cout + n])
                        : 0.f;
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

  // pointwise BN + ReLU6, one rounding, NHWC store
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long m = m0 + ty * 4 + r;
    if (m >= M) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = n0 + tx * 4 + cc;
      if (n < Cout) {
        out[m * Cout + n] = from_f32<T>(relu6(
            __fadd_rn(__fmul_rn(acc[r][cc], pw_scale[n]), pw_bias[n])));
      }
    }
  }
}

// TF SAME: the padding before the first row (column) of one axis
int same_pad_before(int size, int stride) {
  const int out = (size + stride - 1) / stride;
  const int total = (out - 1) * stride + 3 - size;
  return total > 0 ? total / 2 : 0;
}

template <typename T, int S>
cudaError_t launch(const void* x, const void* dw, const void* dw_scale,
                   const void* dw_bias, const void* pw, const void* pw_scale,
                   const void* pw_bias, void* out, int B, int H, int W,
                   int Cin, int Cout, cudaStream_t stream) {
  const int Ho = (H + S - 1) / S, Wo = (W + S - 1) / S;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const long long m_tiles = (M + kTileM - 1) / kTileM;
  const int n_tiles = (Cout + kTileN - 1) / kTileN;
  if (m_tiles * n_tiles > INT_MAX) return cudaErrorInvalidValue;
  dsconv_kernel<T, S><<<static_cast<int>(m_tiles * n_tiles), kThreads, 0,
                        stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dw),
      static_cast<const float*>(dw_scale), static_cast<const float*>(dw_bias),
      static_cast<const T*>(pw), static_cast<const float*>(pw_scale),
      static_cast<const float*>(pw_bias), static_cast<T*>(out), B, H, W, Cin,
      Cout, Ho, Wo, same_pad_before(H, S), same_pad_before(W, S), n_tiles);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin), dw (3, 3, Cin), pw (Cin, Cout) in the element type
// (dtype 0: float32, 1: bfloat16); dw_scale, dw_bias (Cin,) and pw_scale,
// pw_bias (Cout,) float32; out (B, ceil(H/stride), ceil(W/stride), Cout) in
// the element type. All contiguous device memory. Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for arguments it cannot
// take).
extern "C" int dsconv_launch(const void* x, const void* dw,
                             const void* dw_scale, const void* dw_bias,
                             const void* pw, const void* pw_scale,
                             const void* pw_bias, void* out, int B, int H,
                             int W, int Cin, int Cout, int stride, int dtype,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && stride == 1) {
    err = launch<float, 1>(x, dw, dw_scale, dw_bias, pw, pw_scale, pw_bias,
                           out, B, H, W, Cin, Cout, s);
  } else if (dtype == 0 && stride == 2) {
    err = launch<float, 2>(x, dw, dw_scale, dw_bias, pw, pw_scale, pw_bias,
                           out, B, H, W, Cin, Cout, s);
  } else if (dtype == 1 && stride == 1) {
    err = launch<__nv_bfloat16, 1>(x, dw, dw_scale, dw_bias, pw, pw_scale,
                                   pw_bias, out, B, H, W, Cin, Cout, s);
  } else if (dtype == 1 && stride == 2) {
    err = launch<__nv_bfloat16, 2>(x, dw, dw_scale, dw_bias, pw, pw_scale,
                                   pw_bias, out, B, H, W, Cin, Cout, s);
  }
  return static_cast<int>(err);
}
