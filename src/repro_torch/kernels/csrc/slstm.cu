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
// dependent exchanges across the card, and the kernel is latency-bound.
// R (9.4 MB) fits in no cluster's shared memory, so one persistent,
// cooperative grid holds it: each block owns U hidden units j and their
// four gate columns j, d+j, 2d+j, 3d+j of R, in shared memory for the
// whole sequence (U = 6 at d = 768: 128 blocks of 72 KB).
//
// Each step is one exchange through L2 and the products behind it:
// - The exchange carries its own step tag.  Each unit's h_t goes out as one
//   64-bit word, (t + 1) << 32 | bits(h_t), into one of two buffers (by the
//   step's parity), and readers spin on the words themselves until every
//   tag reads t: no counter, no fence, no flag.  A block writes h_{t+2} of a
//   row over h_t only after all its warps have read h_{t+1} of that row,
//   which every block writes after its warps have read h_t, so two buffers
//   suffice.  The spin is bounded: a lost word traps (a launch error)
//   instead of hanging.
// - Warps split k, not columns: warp w owns a slice of d / 8 of the k
//   range, reads only that slice of h_{t-1} from the exchange, and starts
//   its products as soon as its own words have come, with no barrier
//   between the exchange and the products.  A lane owns 2U of the block's
//   4U columns and KPT consecutive k for 8 batch rows: per 16 bytes of h it
//   reads from shared memory (the four lanes of a column group read the
//   same h: one broadcast) it does 8U FMAs, so the products are bound by
//   the FMA rate, not by shared memory.
// - The lanes' partial sums end in a transposing butterfly (each level
//   halves the rows a lane carries) across the lanes of a column group;
//   the eight warps' sums meet in shared memory, where the gating threads
//   add them: one block barrier a pass of 8 rows.
// - gates_x of step t + 1 is copied into shared memory (cp.async) while step
//   t runs, and waited for only before step t + 1's gating.
// - Any batch: 8 rows a pass, the states in shared memory, one slot per
//   (row, unit); a launch takes as many rows as its per-row buffers leave
//   room for (the wrapper plans them and slices larger batches; rows are
//   independent).
// expf, tanhf, the exact sigmoid and IEEE division, no fast-math: the
// reference's tolerance is 1e-5.
//
// `products` = 0 runs the same grid and step loop without the h @ R
// products (the gates are gates_x alone): the exchange's own floor.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;        // batch rows per pass
constexpr int kGroups = 4;      // column groups of a warp's lanes
constexpr int kSlices = 8;      // k slices of a warp's lanes
constexpr long long kSpinLimit = 1ll << 24;   // polling rounds: seconds

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// k per lane for width d: the smallest supported multiple of 4 that covers
// d with kWarps * kSlices lanes
__host__ __device__ constexpr int kpt_for(int d) {
  return d <= 256 ? 4 : d <= 512 ? 8 : d <= 768 ? 12 : 16;
}

// floats of a lane's k in shared memory: an odd number of 16-byte units, so
// that the 8 slices' reads of one row fall in distinct banks
__host__ __device__ constexpr int kpt_pitch(int kpt) {
  return (kpt / 4) % 2 ? kpt : kpt + 4;
}

// One level of the transposing butterfly over v[2 * HALF][N]: a lane
// sends the half of its rows that its partner across lane bit `o` keeps,
// and adds the partner's half to the half it keeps (the upper half where
// its own bit `o` is set), which ends up in rows 0 .. HALF - 1.
template <int HALF, int N>
__device__ __forceinline__ void halve_rows(float (&v)[kRows][N], int lane,
                                           int o) {
  const bool hi = lane & o;
#pragma unroll
  for (int r = 0; r < HALF; ++r) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const float send = hi ? v[r][q] : v[r + HALF][q];
      const float keep = hi ? v[r + HALF][q] : v[r][q];
      v[r][q] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
}

// The row sums of v[kRows][N] over the kSlices lanes of a column group
// (lane bits 2..4): levels 16, 8 and 4 of the butterfly, written out so
// that every index is a constant and v stays in registers.  Lane l then
// holds the N sums of row l >> 2 in v[0].
template <int N>
__device__ __forceinline__ void reduce_rows(float (&v)[kRows][N], int lane) {
  halve_rows<4>(v, lane, 16);
  halve_rows<2>(v, lane, 8);
  halve_rows<1>(v, lane, 4);
}

// Shared memory of one block, in floats: R's columns (per lane, KPT x 2U),
// each warp's h tile (8 rows x 8 slices x pitch), the warps' partial sums
// (two passes' worth), and per row two steps of gates_x and the four
// states.
__host__ __device__ constexpr size_t smem_floats(int cpw, int B, int kpt) {
  return static_cast<size_t>(kThreads) * kpt * 2 * cpw +
         static_cast<size_t>(kWarps) * kRows * kSlices * kpt_pitch(kpt) +
         2 * kWarps * kRows * 8 * cpw +
         static_cast<size_t>(B) * (2 * 8 * cpw + 4 * 2 * cpw);
}

// CPW sets the units per block, U = 2 CPW; the block's 4U columns split
// into kGroups groups of NCT = 2 CPW, one per lane of a column group.
template <int CPW, int KPT>
__global__ void __launch_bounds__(kThreads, 1)
slstm_kernel(const float* __restrict__ gx, const float* __restrict__ R,
             const float* __restrict__ c0, const float* __restrict__ n0,
             const float* __restrict__ h0, const float* __restrict__ m0,
             float* __restrict__ hs, float* __restrict__ c_out,
             float* __restrict__ n_out, float* __restrict__ h_out,
             float* __restrict__ m_out, unsigned long long* xchg, int B,
             int S, int d, bool products) {
  constexpr int U = 2 * CPW;
  constexpr int NC = 4 * U;             // the block's columns
  constexpr int NCT = NC / kGroups;     // a lane's columns
  constexpr int KW = kSlices * KPT;     // a warp's k
  constexpr int KP = kpt_pitch(KPT);
  constexpr int WORDS = kRows * KW / 32;   // exchange words a lane polls
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;                           // [KPT * NCT / 4][lane][4]
  float* hsm = Rs + kThreads * KPT * NCT;     // [warp][row][slice][KP]
  float* part = hsm + kWarps * kRows * kSlices * KP;   // [2][warp][row][NC]
  float* gxs = part + 2 * kWarps * kRows * NC;         // [2][B][NC]
  float* st = gxs + 2 * B * NC;                        // [4][B * U]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cg = lane % kGroups;              // column group
  const int ks = lane / kGroups;              // k slice
  const int j0 = blockIdx.x * U;
  const int64_t d4 = 4 * static_cast<int64_t>(d);
  const int pairs = B * U;                    // (row, unit) slots
  const int64_t plane = static_cast<int64_t>(B) * d;
  float* hw = hsm + warp * kRows * kSlices * KP;
  // the lane's exchange words: M = KW / 32 per row, at k = k_lane + 32 m,
  // kept in the tile at row * kSlices * KP + h_off[m]
  constexpr int M = KW / 32;
  const int k_lane = warp * KW + lane;
  int h_off[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int kk = lane + 32 * m;
    h_off[m] = kk / KPT * KP + kk % KPT;
  }

  // R, lane-major: float4 i of lane `tid` holds its (k, column) entries
  // 4i .. 4i + 3 in the order k-major, columns cg * NCT .. + NCT - 1
  for (int e = tid; e < kThreads * KPT * NCT; e += kThreads) {
    const int who = e % kThreads;             // lane of the block
    const int idx = e / kThreads;             // its entry
    const int w = who / 32, l = who % 32;
    const int k = w * KW + (l / kGroups) * KPT + idx / NCT;
    const int cc = (l % kGroups) * NCT + idx % NCT;
    const int j = j0 + cc % U;
    Rs[(idx / 4 * kThreads + who) * 4 + idx % 4] =
        k < d && j < d ? R[k * d4 + (cc / U) * d + j] : 0.0f;
  }
  for (int e = tid; e < pairs; e += kThreads) {
    const int j = j0 + e % U;
    const int64_t own = static_cast<int64_t>(e / U) * d + j;
    const bool live = j < d;
    st[e] = live ? c0[own] : 0.0f;
    st[pairs + e] = live ? n0[own] : 0.0f;
    st[2 * pairs + e] = live ? h0[own] : 0.0f;
    st[3 * pairs + e] = live ? m0[own] : 0.0f;
  }
  // step t's gates_x of the block's columns, into buffer t & 1
  auto fetch_gates = [&](int t) {
    if (t < S) {
      float* dst = gxs + (t & 1) * B * NC;
      for (int e = tid; e < B * NC; e += kThreads) {
        const int b = e / NC;
        const int cc = e % NC;
        const int j = j0 + cc % U;
        if (j < d) {
          copy4_async(dst + e,
                      gx + (static_cast<int64_t>(b) * S + t) * d4 +
                          (cc / U) * d + j);
        }
      }
    }
    async_commit();
  };
  fetch_gates(0);
  __syncthreads();

  int pass = 0;                               // passes so far, for `part`
  for (int t = 0; t < S; ++t) {
    const unsigned long long* src =
        xchg + ((t - 1) & 1) * plane;         // h_{t-1}, tagged t
    for (int p0 = 0; p0 < B; p0 += kRows, ++pass) {
      const int rows = min(kRows, B - p0);
      // the warp's slice of h_{t-1} for rows p0 .. p0 + 7, into its tile:
      // word u of a lane is row u / M, k = k_lane + 32 (u % M)
      __syncwarp();
      if (t == 0) {
#pragma unroll
        for (int u = 0; u < WORDS; ++u) {
          const int r = u / M, m = u % M;
          hw[r * kSlices * KP + h_off[m]] =
              r < rows && k_lane + 32 * m < d
                  ? h0[static_cast<int64_t>(p0 + r) * d + k_lane + 32 * m]
                  : 0.0f;
        }
      } else {
        const unsigned long long* base =
            src + static_cast<int64_t>(p0) * d + k_lane;
        unsigned long long w[WORDS];
#pragma unroll
        for (int u = 0; u < WORDS; ++u) {
          const int r = u / M, m = u % M;
          w[u] = static_cast<unsigned long long>(t) << 32;   // padding
          if (r < rows && k_lane + 32 * m < d) {
            w[u] = load_word(base + r * d + 32 * m);
          }
        }
        // poll in rounds: each round reloads every word whose tag is not
        // yet t, all of them in flight together
        for (long long spins = 0;; ++spins) {
          bool pending = false;
#pragma unroll
          for (int u = 0; u < WORDS; ++u) {
            if (static_cast<unsigned>(w[u] >> 32) !=
                static_cast<unsigned>(t)) {
              pending = true;
              w[u] = load_word(base + (u / M) * d + 32 * (u % M));
            }
          }
          if (!pending) break;
          if (spins > kSpinLimit) __trap();
        }
#pragma unroll
        for (int u = 0; u < WORDS; ++u) {
          const int r = u / M, m = u % M;
          hw[r * kSlices * KP + h_off[m]] =
              r < rows && k_lane + 32 * m < d
                  ? __uint_as_float(static_cast<unsigned>(w[u]))
                  : 0.0f;
        }
      }
      __syncwarp();

      float* pw = part + (pass & 1) * kWarps * kRows * NC;
      if (products) {
        // acc[r][c]: row p0 + r, column cg * NCT + c, over the lane's k
        float acc[kRows][NCT];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int c = 0; c < NCT; ++c) acc[r][c] = 0.0f;
        }
        const float4* R4 = reinterpret_cast<const float4*>(Rs);
        const float4* h4 = reinterpret_cast<const float4*>(hw);
#pragma unroll
        for (int i = 0; i < KPT / 4; ++i) {
          float rf[4 * NCT];                  // k 4i .. 4i + 3, all columns
#pragma unroll
          for (int q = 0; q < NCT; ++q) {
            const float4 v = R4[(i * NCT + q) * kThreads + tid];
            rf[4 * q] = v.x;
            rf[4 * q + 1] = v.y;
            rf[4 * q + 2] = v.z;
            rf[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 hv = h4[((r * kSlices + ks) * KP) / 4 + i];
            const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
            for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
              for (int c = 0; c < NCT; ++c) {
                acc[r][c] = fmaf(hk[kq], rf[kq * NCT + c], acc[r][c]);
              }
            }
          }
        }
        reduce_rows<NCT>(acc, lane);
        // lane (cg, ks) now holds row ks's sums of its NCT columns
#pragma unroll
        for (int c = 0; c < NCT; ++c) {
          pw[(warp * kRows + ks) * NC + cg * NCT + c] = acc[0][c];
        }
      }
      if (p0 == 0) async_wait_all();         // gates_x of step t is in
      __syncthreads();
      if (p0 == 0) fetch_gates(t + 1);       // every thread is past step t - 1

      // gating of rows p0 .. p0 + 7: one thread a (row, unit)
      const float* gxt = gxs + (t & 1) * B * NC;
      unsigned long long* dst = xchg + (t & 1) * plane;   // h_t, tag t + 1
      const unsigned long long tag = static_cast<unsigned long long>(t + 1)
                                     << 32;
      if (tid < rows * U) {
        const int r = tid / U;
        const int u = tid % U;
        const int b = p0 + r;
        const int j = j0 + u;
        if (j < d) {
          float g4[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float sum = 0.0f;
            if (products) {
#pragma unroll
              for (int w = 0; w < kWarps; ++w) {
                sum += pw[(w * kRows + r) * NC + g * U + u];
              }
            }
            g4[g] = gxt[b * NC + g * U + u] + sum;
          }
          const int e = b * U + u;
          const float c = st[e], nn = st[pairs + e], m = st[3 * pairs + e];
          const float m_new = fmaxf(g4[1] + m, g4[0]);
          const float ip = expf(g4[0] - m_new);
          const float fp = expf((g4[1] + m) - m_new);
          const float c_new =
              __fadd_rn(__fmul_rn(fp, c), __fmul_rn(ip, tanhf(g4[2])));
          const float n_new = __fadd_rn(__fmul_rn(fp, nn), ip);
          const float sig = 1.0f / (1.0f + expf(-g4[3]));
          const float h =
              __fdiv_rn(__fmul_rn(sig, c_new), fmaxf(n_new, 1e-6f));
          st[e] = c_new;
          st[pairs + e] = n_new;
          st[2 * pairs + e] = h;
          st[3 * pairs + e] = m_new;
          const int64_t own = static_cast<int64_t>(b) * d + j;
          hs[(static_cast<int64_t>(b) * S + t) * d + j] = h;
          if (t + 1 < S) store_word(dst + own, tag | __float_as_uint(h));
        }
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < pairs; e += kThreads) {
    const int j = j0 + e % U;
    if (j >= d) continue;
    const int64_t own = static_cast<int64_t>(e / U) * d + j;
    c_out[own] = st[e];
    n_out[own] = st[pairs + e];
    h_out[own] = st[2 * pairs + e];
    m_out[own] = st[3 * pairs + e];
  }
}

template <int CPW, int KPT>
int launch(const float* gx, const float* R, const float* c0, const float* n0,
           const float* h0, const float* m0, float* hs, float* c, float* n,
           float* h, float* m, unsigned long long* xchg, int B, int S, int d,
           bool products, cudaStream_t stream) {
  constexpr int U = 2 * CPW;
  const size_t smem = sizeof(float) * smem_floats(CPW, B, KPT);
  auto* kernel = slstm_kernel<CPW, KPT>;
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
  void* args[] = {&gx, &R, &c0, &n0,   &h0, &m0, &hs, &c, &n,
                  &h,  &m, &xchg, &B,  &S,  &d,  &products};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), args, smem,
                                    stream);
  return static_cast<int>(err);
}

template <int CPW>
int by_width(const float* gx, const float* R, const float* c0,
             const float* n0, const float* h0, const float* m0, float* hs,
             float* c, float* n, float* h, float* m, unsigned long long* x,
             int B, int S, int d, bool products, cudaStream_t s) {
  switch (kpt_for(d)) {
    case 4:
      return launch<CPW, 4>(gx, R, c0, n0, h0, m0, hs, c, n, h, m, x, B, S,
                            d, products, s);
    case 8:
      return launch<CPW, 8>(gx, R, c0, n0, h0, m0, hs, c, n, h, m, x, B, S,
                            d, products, s);
    case 12:
      return launch<CPW, 12>(gx, R, c0, n0, h0, m0, hs, c, n, h, m, x, B, S,
                             d, products, s);
    default:
      return launch<CPW, 16>(gx, R, c0, n0, h0, m0, hs, c, n, h, m, x, B, S,
                             d, products, s);
  }
}

}  // namespace

// gates_x (B, S, 4d), R (d, 4d), c0, n0, h0, m0 and the outputs c, n, h,
// m (B, d), hs (B, S, d): contiguous float32; d at most 1024.  xchg:
// 2 * B * d zeroed 64-bit words of device memory, the exchange of h between
// blocks.  cols_per_warp (1..4) sets the units per block, 2 *
// cols_per_warp.  products = 0 leaves out the h @ R products (the
// exchange's floor).  Launches cooperatively on `stream` and returns the
// launch's error code (cudaErrorCooperativeLaunchTooLarge when the grid
// cannot be resident at once, cudaErrorInvalidValue when the block's
// shared memory would exceed the card's): a refused launch never runs, and
// only this code reports it.
extern "C" int repro_slstm_scan(const void* gates_x, const void* R,
                                const void* c0, const void* n0,
                                const void* h0, const void* m0, void* hs,
                                void* c, void* n, void* h, void* m,
                                void* xchg, int B, int S, int d,
                                int cols_per_warp, int products,
                                void* stream) {
  if (B <= 0 || d <= 0 || d > 1024 || S < 0 || cols_per_warp < 1 ||
      cols_per_warp > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  auto* x = static_cast<unsigned long long*>(xchg);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool p = products != 0;
  switch (cols_per_warp) {
    case 1:
      return by_width<1>(gx, Rf, c0f, n0f, h0f, m0f, hsf, cf, nf, hf, mf, x,
                         B, S, d, p, s);
    case 2:
      return by_width<2>(gx, Rf, c0f, n0f, h0f, m0f, hsf, cf, nf, hf, mf, x,
                         B, S, d, p, s);
    case 3:
      return by_width<3>(gx, Rf, c0f, n0f, h0f, m0f, hsf, cf, nf, hf, mf, x,
                         B, S, d, p, s);
    default:
      return by_width<4>(gx, Rf, c0f, n0f, h0f, m0f, hsf, cf, nf, hf, mf, x,
                         B, S, d, p, s);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
