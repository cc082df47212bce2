// sLSTM recurrence, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/slstm.py:slstm_scan_bsd, the Pallas TPU
// kernel.
//
// What it computes: for gates_x (B, S, 4d), R (d, 4d) and the states c0,
// n0, h0, m0 (B, d), all float32, per step t
//   gates = gates_x[:, t] + h @ R            (columns i | f | z | o)
//   m' = max(f + m, i);  i' = exp(i - m');  f' = exp(f + m - m')
//   c <- f' c + i' tanh(z);  n <- f' n + i';  h <- sigmoid(o) c / max(n, 1e-6)
// writing hs (B, S, d) and the last c, n, h, m (B, d).
//
// What bounds it: at xlstm-125m's (B, S, d) = (8, 512, 768) the h @ R
// products are 19.3 GFLOP of float32 FMAs, 0.29 ms at 67 TFLOP/s, against
// 72 MB of bytes (gates_x 50.3 MB, hs 12.6 MB, R 9.4 MB), 0.022 ms at
// 3.35 TB/s: the float32 rate.  Below both lies the recurrence itself:
// every step needs all of the step before's h, so the 512 steps are 512
// dependent rounds across the card.  The TPU kernel keeps R (9.4 MB)
// resident in VMEM; one SM holds 227 KB, and Hopper's blocks carry nothing
// from one launch or grid step to the next.  So one persistent,
// cooperative grid: each block owns U hidden units j and their four gate
// columns j, d+j, 2d+j, 3d+j of R, held transposed in shared memory for
// the whole sequence (U = 6 at d = 768: 128 blocks of 72 KB), and the
// state of its units in the registers of one thread each.  Each step a
// block reads all of h_{t-1} (from hs, or h0) through L2 into shared
// memory, computes its B x 4U dot products of length d (a warp owns
// 4U / 8 columns, its lanes split k and read 16 bytes at a time, and one
// shuffle butterfly, level by level for all the warp's sums, ends them),
// applies the gating to its units, writes their h to hs, and waits at a
// grid barrier: a counter in device memory that every block increments
// once per step.  The launch is cooperative, so every block is resident
// and the barrier cannot deadlock.  Each step is a chain of latencies (h
// from L2, the dot products and their butterfly, the gating, the
// barrier), not of FMAs: the kernel is latency-bound.  expf, tanhf, the
// exact sigmoid and IEEE division, no fast-math: the reference's
// tolerance is 1e-5.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // batch rows per pass of the dot products
constexpr int kBatch = 8; // loads a thread issues before it stores any

// Every block arrives once per step; the barrier of step t releases when
// the counter (zero at launch) reaches (t + 1) * gridDim.x.  The fences
// make the block's writes before the barrier visible to every block after
// it, and the spin's volatile load reads the counter from L2.
__device__ __forceinline__ void grid_barrier(unsigned int* counter,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*static_cast<volatile unsigned int*>(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// CPW gate columns per warp: a block owns U = 2 * CPW hidden units, whose
// 4U = kWarps * CPW columns of R it holds transposed in shared memory.
template <int CPW>
__global__ void __launch_bounds__(kThreads, 1)
slstm_kernel(const float* __restrict__ gx, const float* __restrict__ R,
             const float* __restrict__ c0, const float* __restrict__ n0,
             const float* __restrict__ h0, const float* __restrict__ m0,
             float* hs, float* __restrict__ c_out, float* __restrict__ n_out,
             float* __restrict__ h_out, float* __restrict__ m_out,
             unsigned int* counter, int B, int S, int d, bool vec4) {
  constexpr int U = 2 * CPW;
  constexpr int NC = 4 * U;
  extern __shared__ __align__(16) float smem[];
  // row pitch: odd for scalar reads, no bank conflicts; a multiple of 4
  // floats where rows are read 16 bytes at a time
  const int ldr = vec4 ? d + 4 : d + 1;
  float* Rt = smem;                    // [NC][ldr]: Rt[g*U + u][k]
  float* hsm = Rt + NC * ldr;          // [B][d]: h_{t-1}, 16-byte aligned
  float* gsm = hsm + B * d;            // [B][NC]: (h_{t-1} @ R) of the block
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int j0 = blockIdx.x * U;
  const int64_t d4 = 4 * static_cast<int64_t>(d);

  for (int e = tid; e < NC * d; e += kThreads) {
    const int k = e / NC;
    const int cc = e % NC;
    const int j = j0 + cc % U;
    Rt[cc * ldr + k] = j < d ? R[k * d4 + (cc / U) * d + j] : 0.0f;
  }

  // thread tid < B * U owns unit j0 + tid % U of batch row tid / U
  const int ob = tid / U;
  const int ou = tid % U;
  const bool live = tid < B * U && j0 + ou < d;
  const int64_t own = static_cast<int64_t>(ob) * d + j0 + ou;
  float c = 0.0f, n = 0.0f, h = 0.0f, m = 0.0f;
  if (live) {
    c = c0[own];
    n = n0[own];
    h = h0[own];
    m = m0[own];
  }

  for (int t = 0; t < S; ++t) {
    // this step's input side of the owned unit's gates, loaded early
    float xi = 0.0f, xf = 0.0f, xz = 0.0f, xo = 0.0f;
    if (live) {
      const float* g = gx + (static_cast<int64_t>(ob) * S + t) * d4 + j0 + ou;
      xi = g[0];
      xf = g[d];
      xz = g[2 * d];
      xo = g[3 * d];
    }
    // h_{t-1} of every unit: h0, or row t - 1 of hs, read through L2; a
    // thread issues kBatch loads (of 16 bytes where rows are aligned)
    // before it stores any, so their latencies overlap
    const float* hp = t == 0 ? h0 : hs + static_cast<int64_t>(t - 1) * d;
    const int64_t pitch = t == 0 ? d : static_cast<int64_t>(S) * d;
    if (vec4) {
      const int q4 = d / 4;
      const int n4 = B * q4;
      for (int base = tid; base < n4; base += kBatch * kThreads) {
        float4 r[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = base + u * kThreads;
          if (e < n4) {
            r[u] = __ldcg(reinterpret_cast<const float4*>(hp + (e / q4) * pitch) +
                          e % q4);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = base + u * kThreads;
          if (e < n4) reinterpret_cast<float4*>(hsm)[e] = r[u];
        }
      }
    } else {
      for (int base = tid; base < B * d; base += kBatch * kThreads) {
        float r[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = base + u * kThreads;
          if (e < B * d) r[u] = __ldcg(hp + (e / d) * pitch + e % d);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = base + u * kThreads;
          if (e < B * d) hsm[e] = r[u];
        }
      }
    }
    __syncthreads();

    for (int b0 = 0; b0 < B; b0 += kRows) {
      float acc[kRows][CPW];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int q = 0; q < CPW; ++q) acc[r][q] = 0.0f;
      }
      if (vec4) {  // each lane 4 consecutive k at a time
        for (int k4 = lane; k4 < d / 4; k4 += 32) {
          float4 rv[CPW];
#pragma unroll
          for (int q = 0; q < CPW; ++q) {
            rv[q] = reinterpret_cast<const float4*>(
                Rt + (warp + kWarps * q) * ldr)[k4];
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (b0 + r < B) {
              const float4 hv =
                  reinterpret_cast<const float4*>(hsm + (b0 + r) * d)[k4];
#pragma unroll
              for (int q = 0; q < CPW; ++q) {
                acc[r][q] = fmaf(hv.x, rv[q].x, acc[r][q]);
                acc[r][q] = fmaf(hv.y, rv[q].y, acc[r][q]);
                acc[r][q] = fmaf(hv.z, rv[q].z, acc[r][q]);
                acc[r][q] = fmaf(hv.w, rv[q].w, acc[r][q]);
              }
            }
          }
        }
      } else {
        for (int k = lane; k < d; k += 32) {
          float rv[CPW];
#pragma unroll
          for (int q = 0; q < CPW; ++q) {
            rv[q] = Rt[(warp + kWarps * q) * ldr + k];
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (b0 + r < B) {
              const float hv = hsm[(b0 + r) * d + k];
#pragma unroll
              for (int q = 0; q < CPW; ++q) {
                acc[r][q] = fmaf(hv, rv[q], acc[r][q]);
              }
            }
          }
        }
      }
      // the lanes' partial sums, one butterfly level at a time for all
      // kRows x CPW sums, so that their shuffles overlap
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int q = 0; q < CPW; ++q) {
            acc[r][q] += __shfl_xor_sync(0xffffffffu, acc[r][q], o);
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (b0 + r < B) {
#pragma unroll
            for (int q = 0; q < CPW; ++q) {
              gsm[(b0 + r) * NC + warp + kWarps * q] = acc[r][q];
            }
          }
        }
      }
    }
    __syncthreads();

    if (live) {
      const float* gr = gsm + ob * NC + ou;
      const float gi = xi + gr[0];
      const float gf = xf + gr[U];
      const float gz = xz + gr[2 * U];
      const float go = xo + gr[3 * U];
      const float m_new = fmaxf(gf + m, gi);
      const float ip = expf(gi - m_new);
      const float fp = expf((gf + m) - m_new);
      c = __fadd_rn(__fmul_rn(fp, c), __fmul_rn(ip, tanhf(gz)));
      n = __fadd_rn(__fmul_rn(fp, n), ip);
      const float sig = 1.0f / (1.0f + expf(-go));
      h = __fdiv_rn(__fmul_rn(sig, c), fmaxf(n, 1e-6f));
      m = m_new;
      hs[(static_cast<int64_t>(ob) * S + t) * d + j0 + ou] = h;
    }
    if (t + 1 < S) grid_barrier(counter, (t + 1) * gridDim.x);
  }

  if (live) {
    c_out[own] = c;
    n_out[own] = n;
    h_out[own] = h;
    m_out[own] = m;
  }
}

template <int CPW>
int launch(const float* gx, const float* R, const float* c0, const float* n0,
           const float* h0, const float* m0, float* hs, float* c, float* n,
           float* h, float* m, unsigned int* counter, int B, int S, int d,
           cudaStream_t stream) {
  constexpr int U = 2 * CPW;
  // rows of h0 and hs start on 16 bytes: 16-byte loads
  bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(h0) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(hs) % 16 == 0;
  const int ldr = vec4 ? d + 4 : d + 1;
  const size_t smem = sizeof(float) * (static_cast<size_t>(4 * U) * ldr +
                                       static_cast<size_t>(B) * d +
                                       static_cast<size_t>(B) * 4 * U);
  auto* kernel = slstm_kernel<CPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (d + U - 1) / U;
  if (blocks > per_sm * sms) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  void* args[] = {&gx, &R, &c0, &n0,      &h0, &m0, &hs, &c,
                  &n,  &h, &m,  &counter, &B,  &S,  &d,  &vec4};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), args, smem,
                                    stream);
  return static_cast<int>(err);
}

}  // namespace

// gates_x (B, S, 4d), R (d, 4d), c0, n0, h0, m0 and the outputs c, n, h,
// m (B, d), hs (B, S, d): contiguous float32.  counter: one zeroed 32-bit
// word of device memory for the grid barrier.  cols_per_warp (1..4) sets
// the units per block, 2 * cols_per_warp; B * 2 * cols_per_warp must not
// exceed 256.  Launches cooperatively on `stream` and returns the launch's
// error code (cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// resident at once): a refused launch never runs, and only this code
// reports it.
extern "C" int repro_slstm_scan(const void* gates_x, const void* R,
                                const void* c0, const void* n0,
                                const void* h0, const void* m0, void* hs,
                                void* c, void* n, void* h, void* m,
                                void* counter, int B, int S, int d,
                                int cols_per_warp, void* stream) {
  const auto* gx = static_cast<const float*>(gates_x);
  const auto* Rf = static_cast<const float*>(R);
  const auto* c0f = static_cast<const float*>(c0);
  const auto* n0f = static_cast<const float*>(n0);
  const auto* h0f = static_cast<const float*>(h0);
  const auto* m0f = static_cast<const float*>(m0);
  auto* hsf = static_cast<float*>(hs);
  auto* cf = static_cast<float*>(c);
  auto* nf = static_cast<float*>(n);
  auto* hf = static_cast<float*>(h);
  auto* mf = static_cast<float*>(m);
  auto* cnt = static_cast<unsigned int*>(counter);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || d <= 0 || B * 2 * cols_per_warp > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (cols_per_warp) {
    case 1:
      return launch<1>(gx, Rf, c0f, n0f, h0f, m0f, hsf, cf, nf, hf, mf, cnt, B,
                       S, d, s);
    case 2:
      return launch<2>(gx, Rf, c0f, n0f, h0f, m0f, hsf, cf, nf, hf, mf, cnt, B,
                       S, d, s);
    case 3:
      return launch<3>(gx, Rf, c0f, n0f, h0f, m0f, hsf, cf, nf, hf, mf, cnt, B,
                       S, d, s);
    case 4:
      return launch<4>(gx, Rf, c0f, n0f, h0f, m0f, hsf, cf, nf, hf, mf, cnt, B,
                       S, d, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
