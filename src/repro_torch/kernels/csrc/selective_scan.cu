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
// What bounds it: bytes.  x and dt are read and y written once, 12 bytes
// per (b, t, c); h0, h_last, A, Bc and Cc add little.  At the hybrid
// path's (8, 512, 8192, 16) that is 412 MB, 0.123 ms at 3.35 TB/s.  Close
// behind come the exponentials, one per (b, t, c, n): 537 M of them on the
// special-function units, 16 per clock on each SM, about 0.13 ms.  The
// TPU kernel walks S in chunks over a (B, n_chunks) grid and carries the
// (D, N) state in VMEM from one grid step to the next.  Blocks on Hopper
// run in parallel and carry nothing between them, so here one thread owns
// one (b, c): its N states and its row of A live in registers, and it
// loops over all of S itself.  A block holds 128 consecutive channels of
// one batch row, so the x, dt and y accesses of a warp are single 128-byte
// lines.  The S loop is sequential, so what the design must hide is the
// latency of each step's loads: it walks S in tiles of kTile steps, and
// while it computes one tile it already holds the next tile's x and dt in
// registers and B_t, C_t (shared by the block's 128 channels) in two
// shared-memory buffers.  Each of a thread's N states is its own chain of
// dependent operations, so the N chains of one step run side by side.
// expf, not __expf, and no fast-math: the reference's tolerance is 1e-5.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // channels per block, one per thread
constexpr int kTile = 8;       // timesteps per tile

template <int N>
__global__ void __launch_bounds__(kThreads, 4)
selective_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bc,
                      const float* __restrict__ Cc,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int D,
                      int64_t sb_b, int64_t sb_t, int64_t sb_n,
                      int64_t sc_b, int64_t sc_t, int64_t sc_n) {
  constexpr int kStage = 2 * kTile * N;                 // B and C values
  constexpr int kPerThread = (kStage + kThreads - 1) / kThreads;
  __shared__ float bc_tile[2][2][kTile][N];             // [buffer][B|C]

  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool active = c < D;
  const int64_t row = static_cast<int64_t>(b) * S * D + c;
  const float* xb = x + row;
  const float* dtb = dt + row;
  float* yb = y + row;
  const float* Bb = Bc + b * sb_b;
  const float* Cb = Cc + b * sc_b;
  const int64_t state = (static_cast<int64_t>(b) * D + c) * N;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[static_cast<int64_t>(c) * N + n] : 0.0f;
    h[n] = active ? h0[state + n] : 0.0f;
  }

  // the next tile's values, loaded into registers before the current
  // tile's compute and stored to shared memory after it
  auto load_bc = [&](int t0, float (&reg)[kPerThread]) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int which = e / (kTile * N);
      const int t = (e / N) % kTile;
      const int n = e % N;
      float v = 0.0f;
      if (e < kStage && t0 + t < S) {
        v = which ? Cb[(t0 + t) * sc_t + n * sc_n]
                  : Bb[(t0 + t) * sb_t + n * sb_n];
      }
      reg[i] = v;
    }
  };
  auto store_bc = [&](int buffer, const float (&reg)[kPerThread]) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kStage) {
        bc_tile[buffer][e / (kTile * N)][(e / N) % kTile][e % N] = reg[i];
      }
    }
  };
  auto load_xdt = [&](int t0, float (&xr)[kTile], float (&dr)[kTile]) {
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const bool ok = active && t0 + t < S;
      const int64_t at = static_cast<int64_t>(t0 + t) * D;
      xr[t] = ok ? xb[at] : 0.0f;
      dr[t] = ok ? dtb[at] : 0.0f;
    }
  };

  float xr[kTile], dr[kTile], bc[kPerThread];
  load_xdt(0, xr, dr);
  load_bc(0, bc);
  store_bc(0, bc);

  const int n_tiles = (S + kTile - 1) / kTile;
  for (int k = 0; k < n_tiles; ++k) {
    const int cur = k & 1;
    const int t0 = k * kTile;
    const bool more = k + 1 < n_tiles;
    // buffer `cur` is complete, and every thread is done with the other
    __syncthreads();
    float xn[kTile], dn[kTile];
    if (more) {
      load_xdt(t0 + kTile, xn, dn);
      load_bc(t0 + kTile, bc);
    }
    if (active) {
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        if (t0 + t < S) {
          const float d = dr[t];
          const float dx = d * xr[t];
          float acc = 0.0f;
#pragma unroll
          for (int n = 0; n < N; ++n) {
            const float da = expf(d * a[n]);
            h[n] = da * h[n] + dx * bc_tile[cur][0][t][n];
            acc += h[n] * bc_tile[cur][1][t][n];
          }
          yb[static_cast<int64_t>(t0 + t) * D] = acc;
        }
      }
    }
    if (more) {
      store_bc(cur ^ 1, bc);
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        xr[t] = xn[t];
        dr[t] = dn[t];
      }
    }
  }

  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[state + n] = h[n];
  }
}

template <int N>
void launch(const float* x, const float* dt, const float* A, const float* Bc,
            const float* Cc, const float* h0, float* y, float* h_last, int B,
            int S, int D, const long long* s, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  selective_scan_kernel<N><<<grid, kThreads, 0, stream>>>(
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
