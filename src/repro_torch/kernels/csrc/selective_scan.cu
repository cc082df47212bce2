// Mamba selective scan, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/selective_scan.py:selective_scan_bsd, the
// Pallas TPU kernel.
//
// What it computes: for x, dt (B, S, D), A (D, N), Bc, Cc (B, S, N) and
// h0 (B, D, N), all float32, per (b, channel c) the recurrence
//   h[n] <- exp(dt_t * A[c, n]) * h[n] + (dt_t * x_t) * B_t[n]
//   y_t  =  sum_n h[n] * C_t[n]
// over t = 0 .. S-1, writing y (B, S, D) and h_last (B, D, N).
//
// What bounds it on this card: two floors of about the same height.  x and
// dt are read and y written once, 12 bytes per (b, t, c): at the hybrid
// path's (8, 512, 8192, 16) that is 412 MB, 0.123 ms at 3.35 TB/s.  And one
// exponential per (b, t, c, n), 537 M of them, on the special-function
// units (16 a clock on each SM): 0.128 ms at the 1.98 GHz boost clock.
// The first kernel reached neither (0.37 ms): one thread carried all N
// states of a (b, c), so each step issued about 14 instructions per state
// (expf's range reduction around its MUFU.EX2, two scalar shared-memory
// loads, the multiplies and adds), with 16 warps an SM to hide a 16-long
// chain of dependent adds; probes that took out one part at a time showed
// it bound by that issue and latency, the exponential its largest part.
//
// The TPU kernel walks S in chunks over a (B, n_chunks) grid and carries
// the (D, N) state in VMEM from one grid step to the next.  Blocks on
// Hopper run in parallel and carry nothing between them, so here a block
// owns 128 channels of one batch row and loops over all of S.  Its design:
// - The N states of a channel are split over kSplit = 2 threads (N >= 4;
//   N = 2 needs no split), lanes l and l + 16 of one warp.  Each carries
//   N/2 states and the sum of its half of y_t; one __shfl_xor_sync joins
//   the halves.  That doubles the resident warps (32 an SM at the path's
//   shape, 64 registers each) and halves each thread's chain of adds.
// - exp(dt * A) is computed as 2^(dt * A2), A2 = A * log2(e) rounded once
//   to float32 and held in registers: one multiply and one MUFU.EX2
//   (ex2.approx.ftz) per state instead of expf's ten or so instructions.
//   Its error (2 ulp of the power, and dt * A2's rounding scaled by |dt *
//   A|, which only matters where the power is small) keeps y and h_last
//   within the reference's 1e-5 of the plain version.
// - x, dt and B_t, C_t travel through a ring of kStages shared-memory
//   tiles of kTile steps, filled by cp.async kStages - 1 tiles ahead, so
//   loads stay in flight without holding registers.  x and dt go in 16-byte
//   pieces that skip L1 (cp.async.cg) when D % 4 == 0 and both start on 16
//   bytes, as the model's are, else one float at a time; the launch picks
//   from D and the two pointers.  Bc and Cc are read through their strides
//   (the model's views into the x_proj output, row stride dt_rank + 2N),
//   one float a copy.  A thread reads its halves of B_t and C_t as float4
//   loads (two LDS.128 each at N = 16).
// - Past the end of S or of D a copy fills zeros; partial tiles stop at S.
// What still holds it back (an H100 SXM at 700 W): its arithmetic alone,
// with no loads, takes about 0.19 ms, half again the exponentials' floor,
// and no one unit is full; the loads of x, dt, B and C and the y stores add
// about 0.06 ms (PERF.md section 5, probe variants timed on the card).
// Three stages beat four (less shared memory, a larger L1) and two (too
// little in flight).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 128;  // channels per block
constexpr int kTile = 8;        // steps per tile of the ring
constexpr int kStages = 3;      // tiles in the ring (kStages - 1 in flight)
constexpr double kLog2e = 1.4426950408889634;

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Copy 4 or 16 bytes from global to shared memory, asynchronously; zeros
// when `valid` is false (the source is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// K (2, 4 or 8) consecutive floats from aligned shared memory.
template <int K>
__device__ __forceinline__ void load_floats(const float* p, float (&v)[K]) {
  static_assert(K == 2 || K % 4 == 0, "2, 4 or 8 states a thread");
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  }
}

template <int N>
struct Geometry {
  static constexpr int kSplit = N >= 4 ? 2 : 1;      // threads per channel
  static constexpr int kStates = N / kSplit;         // states per thread
  static constexpr int kThreads = kChannels * kSplit;
  static constexpr int kHalfLanes = 32 / kSplit;     // channels per warp
};

// kVec: x and dt copied in 16-byte pieces (D % 4 == 0, x and dt on 16
// bytes), else one float at a time.
template <int N, bool kVec>
__global__ void __launch_bounds__(Geometry<N>::kThreads, 4)
selective_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bc,
                      const float* __restrict__ Cc,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int D,
                      int64_t sb_b, int64_t sb_t, int64_t sb_n,
                      int64_t sc_b, int64_t sc_t, int64_t sc_n) {
  using G = Geometry<N>;
  constexpr int K = G::kStates;
  // [x | dt][stage][step][channel] and [stage][step][B | C][n]
  __shared__ __align__(16) float xs[2][kStages][kTile][kChannels];
  __shared__ __align__(16) float bc[kStages][kTile][2][N];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int half = lane / G::kHalfLanes;
  const int local = (tid / 32) * G::kHalfLanes + lane % G::kHalfLanes;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + local;
  const bool active = c < D;
  const int64_t state = (static_cast<int64_t>(b) * D + c) * N + half * K;

  float a2[K], h[K];
#pragma unroll
  for (int n = 0; n < K; ++n) {
    const int64_t an = static_cast<int64_t>(c) * N + half * K + n;
    a2[n] = active ? static_cast<float>(static_cast<double>(A[an]) * kLog2e)
                   : 0.0f;
    h[n] = active ? h0[state + n] : 0.0f;
  }

  // Copies: x and dt as 16-byte pieces (kVec) or, else, one channel of x
  // or dt for each thread (rows q, q + R, ... of a tile's 2 * kTile rows,
  // R = kThreads / kChannels); and at most one element of B_t or C_t (N = 16
  // takes all 256 threads).
  constexpr int R = G::kThreads / kChannels;
  const int ch = tid % kChannels;
  const int q = tid / kChannels;
  const float* xrow = x + static_cast<int64_t>(b) * S * D + c0;
  const float* dtrow = dt + static_cast<int64_t>(b) * S * D + c0;
  constexpr int kBc = kTile * 2 * N;
  static_assert(kBc <= G::kThreads, "one B or C element a thread");
  const int bc_n = tid % N;
  const int bc_which = (tid / N) % 2;
  const int bc_t = tid / (2 * N);
  const float* bc_src = bc_which ? Cc + b * sc_b + bc_n * sc_n
                                 : Bc + b * sb_b + bc_n * sb_n;
  const int64_t bc_step = bc_which ? sc_t : sb_t;
  // tile k's x, dt, B and C into ring stage k % kStages
  auto issue = [&](int k) {
    const int t0 = k * kTile;
    const int stage = k % kStages;
    const int64_t row0 = static_cast<int64_t>(t0) * D;
    if constexpr (kVec) {
      constexpr int kPieces = 2 * kTile * kChannels / 4;
#pragma unroll
      for (int i = 0; i < kPieces / G::kThreads; ++i) {
        const int e = i * G::kThreads + tid;
        const int c4 = e % (kChannels / 4) * 4;
        const int t = e / (kChannels / 4) % kTile;
        const int which = e / (kTile * kChannels / 4);
        const bool ok = c0 + c4 < D && t0 + t < S;
        const float* src = (which ? dtrow : xrow) + row0 +
                           static_cast<int64_t>(t) * D + c4;
        cp_async16(&xs[which][stage][t][c4], ok ? src : x, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kTile * 2 / R; ++i) {
        const int r = i * R + q;
        const int t = r / 2;
        const bool ok = c0 + ch < D && t0 + t < S;
        const float* src = ((r & 1) ? dtrow : xrow) + row0 +
                           static_cast<int64_t>(t) * D + ch;
        cp_async4(&xs[r & 1][stage][t][ch], ok ? src : x, ok);
      }
    }
    if (tid < kBc) {
      const bool ok = t0 + bc_t < S;
      cp_async4(&bc[stage][bc_t][bc_which][bc_n],
                ok ? bc_src + (t0 + bc_t) * bc_step : x, ok);
    }
  };

  const int n_tiles = (S + kTile - 1) / kTile;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_tiles) issue(k);
    cp_async_commit();
  }
  float* yb = y + static_cast<int64_t>(b) * S * D + c;
  for (int k = 0; k < n_tiles; ++k) {
    // tile k has landed, and every thread is done with tile k - 1, whose
    // stage the next issue refills
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (k + kStages - 1 < n_tiles) issue(k + kStages - 1);
    cp_async_commit();
    const int stage = k % kStages;
    const int t0 = k * kTile;
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      if (t0 + t < S) {
        const float d = xs[1][stage][t][local];
        const float dx = d * xs[0][stage][t][local];
        float bv[K], cv[K];
        load_floats<K>(&bc[stage][t][0][half * K], bv);
        load_floats<K>(&bc[stage][t][1][half * K], cv);
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < K; ++n) {
          h[n] = fmaf(exp2_approx(d * a2[n]), h[n], dx * bv[n]);
          acc = fmaf(h[n], cv[n], acc);
        }
        if constexpr (G::kSplit == 2) {
          acc += __shfl_xor_sync(0xffffffffu, acc, G::kHalfLanes);
        }
        if (half == 0 && active) yb[static_cast<int64_t>(t0 + t) * D] = acc;
      }
    }
  }
  cp_async_wait<0>();

  if (active) {
#pragma unroll
    for (int n = 0; n < K; ++n) h_last[state + n] = h[n];
  }
}

template <int N>
void launch(const float* x, const float* dt, const float* A, const float* Bc,
            const float* Cc, const float* h0, float* y, float* h_last, int B,
            int S, int D, const long long* s, cudaStream_t stream) {
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dt) % 16 == 0;
  const auto kernel = vec ? selective_scan_kernel<N, true>
                          : selective_scan_kernel<N, false>;
  kernel<<<grid, Geometry<N>::kThreads, 0, stream>>>(
      x, dt, A, Bc, Cc, h0, y, h_last, S, D, s[0], s[1], s[2], s[3], s[4],
      s[5]);
}

}  // namespace

// x, dt, y (B, S, D), A (D, N), h0, h_last (B, D, N): contiguous float32.
// Bc, Cc (B, S, N) float32 with element strides: strides[0..2] are Bc's
// (b, t, n), strides[3..5] Cc's.  N is 2, 4, 8 or 16.  Launches on
// `stream` and returns cudaGetLastError(): a refused launch never runs,
// and only this code reports it.
extern "C" int repro_selective_scan(const void* x, const void* dt,
                                    const void* A, const void* Bc,
                                    const void* Cc, const void* h0, void* y,
                                    void* h_last, int B, int S, int D, int N,
                                    const long long* strides, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Bf = static_cast<const float*>(Bc);
  const auto* Cf = static_cast<const float*>(Cc);
  const auto* h0f = static_cast<const float*>(h0);
  auto* yf = static_cast<float*>(y);
  auto* hf = static_cast<float*>(h_last);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0 && D > 0) {
    switch (N) {
      case 2:
        launch<2>(xf, dtf, Af, Bf, Cf, h0f, yf, hf, B, S, D, strides, s);
        break;
      case 4:
        launch<4>(xf, dtf, Af, Bf, Cf, h0f, yf, hf, B, S, D, strides, s);
        break;
      case 8:
        launch<8>(xf, dtf, Af, Bf, Cf, h0f, yf, hf, B, S, D, strides, s);
        break;
      case 16:
        launch<16>(xf, dtf, Af, Bf, Cf, h0f, yf, hf, B, S, D, strides, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
