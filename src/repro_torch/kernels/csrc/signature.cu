// Eq. 3 per-channel threshold-zero counts, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/signature.py:signature_td, the Pallas TPU
// kernel, together with the vmap over samples that
// src/repro/kernels/ops.py:signature_per_channel wraps around it.
//
// What it computes: for x (N, T, C) with explicit strides, per (n, c) the
// count over the T rows of x == 0 (tau <= 0, the CNN's ReLU kill count) or
// |x| < tau (tau > 0), compared in float32 against the float32 value of
// tau.  x is float32 or bfloat16 (the LM's final-norm output at full
// width); a bfloat16 value converts to float32 exactly, so both give the
// flags the reference's f32 comparison gives.  mean != 0 scales the count
// by the float32 reciprocal of T, which is what the reference's
// `acc / total_t` becomes under XLA.
//
// What bounds it: bytes read.  Each input element is read once and costs
// one compare and one integer add (at the main path's (128, 1024, 64)
// float32: 33.5 MB to read, 10 us at 3.35 TB/s, against 0.13 us of work
// at 67 TFLOP/s).  The TPU kernel walks T in blocks on one core and
// carries a (d,) VMEM accumulator across grid steps; blocks on Hopper run
// in parallel and in no order, so here a block owns 32 channels of one
// sample and loops over all of T itself.  The 32 lanes of a warp read 32
// neighbouring channels of one row (one coalesced 128-byte line when C is
// contiguous, as in channels-last activations), and the block's 8 warps
// walk interleaved rows.  One shared-memory reduction joins the 8 row
// groups: no atomics, so the result is deterministic.  Counts are exact in
// int32 and emitted as float, exact up to 2^24 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;     // channels per block, one per lane
constexpr int kRowGroups = 8;  // warps per block, each on its own rows

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename Elem>
__global__ void __launch_bounds__(kLanes * kRowGroups)
signature_counts_kernel(const Elem* __restrict__ x, float* __restrict__ out,
                        int T, int C, int64_t stride_n, int64_t stride_t,
                        int64_t stride_c, float tau, int mean) {
  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  const int group = threadIdx.y;
  const int c = blockIdx.y * kLanes + lane;

  int count = 0;
  if (c < C) {
    const Elem* col = x + n * stride_n + c * stride_c;
    if (tau <= 0.0f) {
#pragma unroll 4
      for (int t = group; t < T; t += kRowGroups) {
        count += load_f32(col + t * stride_t) == 0.0f;
      }
    } else {
#pragma unroll 4
      for (int t = group; t < T; t += kRowGroups) {
        count += fabsf(load_f32(col + t * stride_t)) < tau;
      }
    }
  }

  __shared__ int partial[kRowGroups][kLanes];
  partial[group][lane] = count;
  __syncthreads();
  if (group == 0 && c < C) {
    int total = 0;
#pragma unroll
    for (int g = 0; g < kRowGroups; ++g) total += partial[g][lane];
    float value = static_cast<float>(total);
    if (mean) value *= 1.0f / static_cast<float>(T);
    out[static_cast<int64_t>(n) * C + c] = value;
  }
}

template <typename Elem>
void launch(const void* x, void* out, int N, int T, int C,
            long long stride_n, long long stride_t, long long stride_c,
            float tau, int mean, cudaStream_t stream) {
  const dim3 grid(N, (C + kLanes - 1) / kLanes);
  const dim3 block(kLanes, kRowGroups);
  signature_counts_kernel<Elem><<<grid, block, 0, stream>>>(
      static_cast<const Elem*>(x), static_cast<float*>(out), T, C, stride_n,
      stride_t, stride_c, tau, mean);
}

}  // namespace

// x (N, T, C) float32 (dtype 0) or bfloat16 (dtype 1) with element strides;
// out (N, C) float32, contiguous.  Launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and only this code
// reports it.
extern "C" int repro_signature_counts(const void* x, void* out, int dtype,
                                      int N, int T, int C,
                                      long long stride_n, long long stride_t,
                                      long long stride_c, float tau, int mean,
                                      void* stream) {
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0 && C > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      launch<float>(x, out, N, T, C, stride_n, stride_t, stride_c, tau, mean,
                    s);
    else
      launch<__nv_bfloat16>(x, out, N, T, C, stride_n, stride_t, stride_c,
                            tau, mean, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
