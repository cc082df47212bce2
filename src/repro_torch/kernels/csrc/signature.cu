// Eq. 3 per-channel threshold-zero counts, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/signature.py:signature_td, the Pallas TPU
// kernel, together with the vmap over samples that
// src/repro/kernels/ops.py:signature_per_channel wraps around it.
//
// What it computes: for x (N, T, C) with explicit strides, per (n, c) the
// count over the T rows of x == 0 (tau <= 0, the CNN's ReLU kill count) or
// |x| < tau (tau > 0), compared in float32 against the float32 value of
// tau.  x is float32 or bfloat16 (the LM-family paths' final-norm output);
// a bfloat16 value converts to float32 exactly, so both give the flags the
// reference's f32 comparison gives.  mean != 0 scales the count by the
// float32 reciprocal of T, which is what the reference's `acc / total_t`
// becomes under XLA.
//
// What bounds it on this card: bytes read.  Each element is read once and
// costs a compare and an integer add: at the LM path's (1, 4096, 2048)
// bfloat16 that is 16.8 MB, 5 us at 3.35 TB/s; at the CNN path's
// (128, 1024, 64) float32, 33.5 MB and 10 us.  The TPU kernel walks T in
// blocks on one core and carries a (d,) VMEM accumulator across grid
// steps.  The first kernel here gave a block 32 channels of one sample and
// all of T, and each lane read 2 or 4 bytes a row: 64 blocks for 132 SMs at
// the LM shape, too few bytes in flight to reach the bound.
//
// Two routes, chosen by the caller from dtype, strides and alignment:
// - "vec", when channels are contiguous (stride_c == 1), C is a multiple of
//   the vector width and every row starts on 16 bytes (the CNN's
//   channels-last (N, HW, C) view, the LM's contiguous (1, B*S, d)): a
//   thread loads 16 bytes a row (8 bfloat16 or 4 float32 channels) and
//   keeps one counter per channel in registers; lanes run along channels,
//   so a warp reads whole 128-byte lines.  T is split over blocks so the
//   grid has at least kBlocksPerSm blocks for each SM.  A block sums its
//   row groups in shared memory and adds each channel's count into an int32
//   scratch with atomicAdd; integer adds give the same total in any order.
//   The last block of each (sample, channel group), found with a ticket
//   counter, takes the totals (atomicExch, which leaves the scratch zero
//   for the next launch), converts them to float and scales them once.
//   One launch; the scratch is zero before and after it.
// - "strided", any strides: a block owns 32 channels of one sample and
//   walks all of T with 8 warps of interleaved rows, one element a lane;
//   one shared-memory reduction joins them.
// Counts are exact in int32 and emitted as float, exact up to 2^24 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kLanes = 32;     // strided route: channels per block
constexpr int kRowGroups = 8;  // strided route: warps per block
constexpr int kThreads = 256;  // vec route: threads per block
constexpr int kBlocksPerSm = 4;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename Elem>
__global__ void __launch_bounds__(kLanes * kRowGroups)
signature_strided_kernel(const Elem* __restrict__ x, float* __restrict__ out,
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

// The flags of one 16-byte vector: 4 float32 or 8 bfloat16 channels.
template <bool kBf16, bool kZero>
__device__ __forceinline__ void count_vector(const uint4 v, float tau,
                                             int (&cnt)[kBf16 ? 8 : 4]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kBf16) {
      // a bfloat16 is the high half of its float32 value
      const float lo = __uint_as_float(w[i] << 16);
      const float hi = __uint_as_float(w[i] & 0xffff0000u);
      if constexpr (kZero) {
        cnt[2 * i] += lo == 0.0f;
        cnt[2 * i + 1] += hi == 0.0f;
      } else {
        cnt[2 * i] += fabsf(lo) < tau;
        cnt[2 * i + 1] += fabsf(hi) < tau;
      }
    } else {
      const float f = __uint_as_float(w[i]);
      if constexpr (kZero) {
        cnt[i] += f == 0.0f;
      } else {
        cnt[i] += fabsf(f) < tau;
      }
    }
  }
}

// 16 bytes through the read-only path, not kept in L1 (each is read
// once), with a hint to fetch the whole 256-byte L2 line
__device__ __forceinline__ uint4 load16(const char* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Grid: one block per (sample n, channel group g, row split s), numbered
// ((n * groups) + g) * splits + s.  A channel group is `lanes` vectors of
// channels; the block's 256 threads are `lanes` columns x 256 / lanes row
// groups over the split's rows.  scratch holds N * C counts, then N *
// groups tickets; all zero on entry, and left zero.
template <bool kBf16, bool kZero>
__global__ void __launch_bounds__(kThreads)
signature_vec_kernel(const char* __restrict__ x, float* __restrict__ out,
                     int* __restrict__ counts,
                     unsigned* __restrict__ tickets, int T, int C,
                     int64_t row_bytes_n, int64_t row_bytes_t, float tau,
                     int mean, int lanes_log2, int groups, int splits,
                     int rows_per_split) {
  constexpr int kVec = kBf16 ? 8 : 4;       // channels per 16 bytes
  constexpr int kElem = kBf16 ? 2 : 4;
  __shared__ int partial[kThreads * kVec];  // [row group][channel in group]
  __shared__ bool last;

  const int lanes = 1 << lanes_log2;
  const int rows_step = kThreads >> lanes_log2;
  const int tid = threadIdx.x;
  const int lane = tid & (lanes - 1);
  const int group_row = tid >> lanes_log2;
  const int split = blockIdx.x % splits;
  const int g = (blockIdx.x / splits) % groups;
  const int n = blockIdx.x / (splits * groups);
  const int c_first = g * lanes * kVec;     // the group's first channel
  const int c = c_first + lane * kVec;      // this thread's first channel
  const int t_begin = split * rows_per_split;
  const int t_end = min(T, t_begin + rows_per_split);

  int cnt[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) cnt[k] = 0;
  if (c < C) {
    const char* col = x + n * row_bytes_n + static_cast<int64_t>(c) * kElem;
    int t = t_begin + group_row;
    for (; t + 3 * rows_step < t_end; t += 4 * rows_step) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = load16(col + (t + u * rows_step) * row_bytes_t);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) count_vector<kBf16, kZero>(v[u], tau, cnt);
    }
    for (; t < t_end; t += rows_step) {
      count_vector<kBf16, kZero>(load16(col + t * row_bytes_t), tau, cnt);
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    partial[group_row * lanes * kVec + lane * kVec + k] = cnt[k];
  }
  __syncthreads();

  const int width = lanes * kVec;           // channels in the group
  const int64_t row_out = static_cast<int64_t>(n) * C;
  for (int j = tid; j < width; j += kThreads) {
    int total = 0;
    for (int r = 0; r < rows_step; ++r) total += partial[r * width + j];
    if (c_first + j < C && total != 0) {
      atomicAdd(&counts[row_out + c_first + j], total);
    }
  }
  // the classic last-block pattern: each thread's adds are ordered before
  // the ticket, and the last block sees every other block's adds
  __threadfence();
  __syncthreads();
  unsigned* ticket = tickets + static_cast<int64_t>(n) * groups + g;
  if (tid == 0) last = atomicAdd(ticket, 1u) == static_cast<unsigned>(
      splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float scale = 1.0f / static_cast<float>(T);
  for (int j = tid; j < width; j += kThreads) {
    if (c_first + j < C) {
      float value = static_cast<float>(
          atomicExch(&counts[row_out + c_first + j], 0));
      if (mean) value *= scale;
      out[row_out + c_first + j] = value;
    }
  }
  if (tid == 0) atomicExch(ticket, 0u);
}

template <typename Elem>
void launch_strided(const void* x, void* out, int N, int T, int C,
                    long long stride_n, long long stride_t,
                    long long stride_c, float tau, int mean,
                    cudaStream_t stream) {
  const dim3 grid(N, (C + kLanes - 1) / kLanes);
  const dim3 block(kLanes, kRowGroups);
  signature_strided_kernel<Elem><<<grid, block, 0, stream>>>(
      static_cast<const Elem*>(x), static_cast<float*>(out), T, C, stride_n,
      stride_t, stride_c, tau, mean);
}

template <bool kBf16>
int launch_vec(const void* x, void* out, void* scratch,
               long long scratch_ints, int N, int T, int C,
               long long stride_n, long long stride_t, float tau, int mean,
               cudaStream_t stream) {
  constexpr int kVec = kBf16 ? 8 : 4;
  constexpr int kElem = kBf16 ? 2 : 4;
  const long long row_bytes_n = stride_n * kElem;
  const long long row_bytes_t = stride_t * kElem;
  if (C % kVec != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (N > 1 && row_bytes_n % 16 != 0) || (T > 1 && row_bytes_t % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vectors = C / kVec;             // 16-byte columns
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < vectors && lanes_log2 < 5) ++lanes_log2;
  const int lanes = 1 << lanes_log2;
  const int rows_step = kThreads / lanes;
  const int groups = (vectors + lanes - 1) / lanes;
  if (scratch_ints < static_cast<long long>(N) * C +
                         static_cast<long long>(N) * groups)
    return static_cast<int>(cudaErrorInvalidValue);

  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // enough row splits for kBlocksPerSm blocks an SM, each split at least
  // one row for every row group
  const long long blocks_wanted = static_cast<long long>(kBlocksPerSm) * sms;
  const long long per_split = static_cast<long long>(N) * groups;
  long long splits = (blocks_wanted + per_split - 1) / per_split;
  splits = std::max(1LL, std::min(splits, static_cast<long long>(
                                              T / rows_step)));
  const int rows_per_split = std::max(1, static_cast<int>(T / splits));
  splits = T > 0 ? (T + rows_per_split - 1) / rows_per_split : 1;
  const long long blocks = per_split * splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  int* counts = static_cast<int*>(scratch);
  auto* tickets = reinterpret_cast<unsigned*>(counts +
                                              static_cast<int64_t>(N) * C);
  const auto* xb = static_cast<const char*>(x);
  auto* o = static_cast<float*>(out);
  const int s = static_cast<int>(splits);
  const auto kernel = tau <= 0.0f ? signature_vec_kernel<kBf16, true>
                                  : signature_vec_kernel<kBf16, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      xb, o, counts, tickets, T, C, row_bytes_n, row_bytes_t, tau, mean,
      lanes_log2, groups, s, rows_per_split);
  return 0;
}

}  // namespace

// x (N, T, C) float32 (dtype 0) or bfloat16 (dtype 1) with element strides;
// out (N, C) float32, contiguous.  vec != 0 takes the "vec" route, which
// needs stride_c == 1, C a multiple of 16 bytes' worth of channels, x and
// its row strides on 16 bytes (else cudaErrorInvalidValue), and `scratch`:
// at least N * C + N * ceil(C / 256) int32 (float32: N * ceil(C / 128)),
// zero, which the launch leaves zero.  Launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and only this code
// reports it.
extern "C" int repro_signature_counts(const void* x, void* out, int dtype,
                                      int N, int T, int C,
                                      long long stride_n, long long stride_t,
                                      long long stride_c, float tau, int mean,
                                      int vec, void* scratch,
                                      long long scratch_ints, void* stream) {
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0 && C > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec) {
      if (stride_c != 1 || scratch == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      const int err =
          dtype == 0
              ? launch_vec<false>(x, out, scratch, scratch_ints, N, T, C,
                                  stride_n, stride_t, tau, mean, s)
              : launch_vec<true>(x, out, scratch, scratch_ints, N, T, C,
                                 stride_n, stride_t, tau, mean, s);
      if (err != 0) return err;
    } else if (dtype == 0) {
      launch_strided<float>(x, out, N, T, C, stride_n, stride_t, stride_c,
                            tau, mean, s);
    } else {
      launch_strided<__nv_bfloat16>(x, out, N, T, C, stride_n, stride_t,
                                    stride_c, tau, mean, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
