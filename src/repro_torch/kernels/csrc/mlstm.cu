// Chunkwise mLSTM, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mlstm.py:mlstm_chunkwise_bshd, the Pallas TPU
// kernel.
//
// What it computes: for q, k (B, S, H, dk), v (B, S, H, dv) (float32 or
// bfloat16, converted exactly to float32 on load) and the raw gates i, f
// (B, S, H) float32, per (b, head) the stabilised mLSTM from C = 0, n = 0,
// m = -1e30, in chunks of kL = 64 steps: with b_t the cumulative log
// sigmoid(f) in the chunk, D[t,s] = b_t - b_s + i_s (s <= t),
// m_t = max(b_t + m, max_s D[t,s]),
//   h_t = (w_t q_t C + sum_s W[t,s] v_s) / max(|w_t q_t n + sum_s W[t,s]|,
//                                              exp(-m_t)),
// w_t = exp(b_t + m - m_t), W[t,s] = exp(D[t,s] - m_t) q_t.k_s, and the
// carry C <- C exp(g + m - m') + sum_s exp(g - b_s + i_s - m') k_s v_s^T
// (and n likewise), g = b_L, m' = max(g + m, max_s (g - b_s + i_s)).  It
// writes h (B, S, H, dv) float32 and the last C (B, H, dk, dv), n (B, H,
// dk), m (B, H).  Padded steps of the last chunk take log sigmoid(f) = 0 and
// i = -1e30, as the TPU kernel's.
//
// What bounds it: float32 operations.  At xlstm-125m's (B, S, H, dk, dv) =
// (8, 512, 4, 192, 384) the products (q k^T and W v within a chunk, q C and
// k^T v across chunks) are 5.48 GFLOP at this kernel's 64-step chunk, about
// 0.08 ms at 67 TFLOP/s, against 60 MB of bytes (q, k 6.3 MB each in bf16,
// v 12.6 MB, h 25.2 MB and the last C 9.4 MB in float32), 0.018 ms at
// 3.35 TB/s.  The TPU kernel walks the chunks of one (b, head) in order as
// its innermost grid axis, C resident in VMEM.  Hopper's blocks run in no
// order and carry nothing between them, and one (b, head) after another is
// 32 serial chains for 132 SMs.  The chunkwise form is exact at any chunk
// length and its carries combine, so the work splits into three launches
// that each fill the card:
// 1. scores, grid (chunk, b * head): the chunk's gate terms (the cumulative
//    log sigmoid by a warp scan; u_s = g - b_s + i_s and their maximum for
//    the carry), its intra-chunk maxima m_intra_t = max_{s<=t} D[t,s], and
//    W'[t,s] = exp(D[t,s] - m_intra_t) q_t.k_s, into scratch: computed once,
//    not once per v tile;
// 2. the carry, grid (dv / 64, dk / 64, b * head): each block walks the
//    chunks for one 64 x 64 tile of C (in registers), with the chunk's gate
//    terms from the scores pass (no reduction and two barriers a chunk),
//    and writes the state entering every chunk, C_c, n_c and m_c, to
//    scratch;
// 3. the outputs, grid (dv / 64, chunk, b * head): with r_t =
//    exp(m_intra_t - m_t), h_t = (w_t q_t C_c + r_t sum_s W'[t,s] v_s) /
//    max(|w_t q_t n_c + r_t sum_s W'[t,s]|, exp(-m_t)).
// Every product is a 4 x 4 tile of float32 FMAs per thread (256 threads as
// 16 x 16) over operands in shared memory read 16 bytes at a time.  Tiles of
// q, k and v come in 16 bytes at a time where their rows allow it (else one
// element at a time, through their strides: the gate views that the model
// splits out of one projection need no copy), and the next slice or chunk is
// loaded into registers while the current one is computed.  The scratch
// (the scores, the gate terms and the chunk states: 80.1 MB at the main
// shape, 75.5 MB of it the states) comes from the wrapper.  expf, log1pf
// and IEEE division, no fast-math: the reference's tolerance is 1e-4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kL = 64;         // steps per chunk
constexpr int kT = 64;         // C tile (dk x dv) and h tile (steps x dv)
constexpr int kK = 32;         // dk slice of q k^T and of q C
constexpr int kP = kT + 4;     // pitch of the 64-wide shared tiles
constexpr int kMaxDk = 256;
constexpr float kNeg = -1e30f;
// the output kernel's shared memory: q^T and C slices, W'^T and the v tile,
// n, and five vectors of the chunk
constexpr int kOutputSmem =
    sizeof(float) * ((2 * kK + 2 * kL) * kP + kMaxDk + 5 * kL);

struct Strides {               // element strides of q, k, v (b, s, h, d)
  long long q[4], k[4], v[4];  // and of the gates (b, s, h)
  long long i[3], f[3];
};

struct Scratch {               // per (b, head, chunk)
  float* gb;                   // [kL]: cumulative log sigmoid(f)
  float* gm;                   // [kL]: m_intra_t
  float* gu;                   // [kL]: u_s = g - b_s + i_s
  float* gl;                   // [2]: g = b_L, max_s u_s
  float* W;                    // [kL][kL]: W'[t][s]
  float* C;                    // [dk][dv]: C entering the chunk
  float* n;                    // [dk]
  float* m;                    // [1]
};

size_t scratch_floats(long long bhc, int dk, int dv) {
  return static_cast<size_t>(bhc) *
         (3 * kL + 2 + kL * kL + static_cast<size_t>(dk) * dv + dk + 1);
}

Scratch split(float* base, long long bhc, int dk, int dv) {
  Scratch s;
  s.gb = base;
  s.gm = s.gb + bhc * kL;
  s.gu = s.gm + bhc * kL;
  s.gl = s.gu + bhc * kL;
  s.W = s.gl + bhc * 2;
  s.C = s.W + bhc * kL * kL;
  s.n = s.C + bhc * static_cast<long long>(dk) * dv;
  s.m = s.n + bhc * dk;
  return s;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// log sigmoid(x) = min(x, 0) - log1p(exp(-|x|)), as PyTorch computes it
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// 8 consecutive elements of a row, as float: one or two 16-byte loads where
// `vec` (unit stride, 16-byte aligned rows, all 8 inside the row), else one
// element at a time through the stride, zeros past `n` columns.
__device__ __forceinline__ void load8(const float* p, long long cs, int n,
                                      bool vec, float (&r)[8]) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
    r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] = e < n ? p[e * cs] : 0.0f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, long long cs,
                                      int n, bool vec, float (&r)[8]) {
  if (vec) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      r[2 * e] = __uint_as_float(w[e] << 16);
      r[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] = e < n ? to_float(p[e * cs]) : 0.0f;
  }
}

// One thread's share of a ROWS x COLS tile (ROWS * COLS = 8 * kThreads):
// row tid / (COLS / 8), columns 8 (tid % (COLS / 8)) .. + 7.  Rows past
// `rows` and columns past `cols` read as zeros.
template <int COLS, typename T>
__device__ __forceinline__ void load_tile(const T* base, long long rs,
                                          long long cs, int rows, int cols,
                                          bool vec, float (&r)[8]) {
  const int row = threadIdx.x / (COLS / 8);
  const int col = threadIdx.x % (COLS / 8) * 8;
  const int n = cols - col;
  if (row < rows && n > 0) {
    load8(base + row * rs + col * cs, cs, n, vec && n >= 8, r);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] = 0.0f;
  }
}

// Whether 8-element runs of a tile's rows can be read 16 bytes at a time.
template <typename T>
__device__ __forceinline__ bool vec_rows(const T* base, long long rs,
                                         long long cs) {
  return cs == 1 && (rs * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

// The thread's share stored as rows (dst[row][col]) or transposed
// (dst[col][row]), each scaled by `scale`.
template <int COLS>
__device__ __forceinline__ void store_rows(float* dst, int pitch,
                                           const float (&r)[8], float scale) {
  const int row = threadIdx.x / (COLS / 8);
  const int col = threadIdx.x % (COLS / 8) * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[row * pitch + col + e] = r[e] * scale;
}

template <int COLS>
__device__ __forceinline__ void store_cols(float* dst, int pitch,
                                           const float (&r)[8], float scale) {
  const int row = threadIdx.x / (COLS / 8);
  const int col = threadIdx.x % (COLS / 8) * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[(col + e) * pitch + row] = r[e] * scale;
}

// acc[a][c] += x[a] * y[c]
__device__ __forceinline__ void outer4(float4 x, float4 y, float (&acc)[4][4]) {
  const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    acc[a][0] = fmaf(xs[a], y.x, acc[a][0]);
    acc[a][1] = fmaf(xs[a], y.y, acc[a][1]);
    acc[a][2] = fmaf(xs[a], y.z, acc[a][2]);
    acc[a][3] = fmaf(xs[a], y.w, acc[a][3]);
  }
}

// ---------------------------------------------------------------------
// 1. scores: grid (chunks, B * H)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const float* __restrict__ ig, const float* __restrict__ fg,
                    Scratch sc, int S, int H, int dk, float scale,
                    Strides st) {
  __shared__ __align__(16) float qT[kK][kP];   // [k][t]
  __shared__ __align__(16) float kT[kK][kP];   // [k][s]
  __shared__ float bv[kL], iv[kL], mi[kL];
  __shared__ float red[2];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int c = blockIdx.x;
  const int nch = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const int s0 = c * kL;
  const long long bhc = static_cast<long long>(bh) * nch + c;
  const int steps = min(kL, S - s0);
  const T* qb = q + b * st.q[0] + hh * st.q[2] + s0 * st.q[1];
  const T* kb = k + b * st.k[0] + hh * st.k[2] + s0 * st.k[1];
  const bool vq = vec_rows(qb, st.q[1], st.q[3]);
  const bool vk = vec_rows(kb, st.k[1], st.k[3]);

  // the cumulative log sigmoid(f): a scan in each of two warps, then the
  // first warp's total added to the second's
  if (tid < kL) {
    // the raw gates, the padded steps past S at log sigmoid(f) = 0 and
    // i = -1e30
    const int s = s0 + tid;
    float lf = s < S ? log_sigmoid(fg[b * st.f[0] + hh * st.f[2] +
                                      s * st.f[1]])
                     : 0.0f;
    const float ivv =
        s < S ? ig[b * st.i[0] + hh * st.i[2] + s * st.i[1]] : kNeg;
    const int lane = tid % 32;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float x = __shfl_up_sync(0xffffffffu, lf, o);
      if (lane >= o) lf += x;
    }
    bv[tid] = lf;
    iv[tid] = ivv;
  }
  __syncthreads();
  if (tid >= 32 && tid < kL) bv[tid] += bv[31];
  __syncthreads();
  if (tid < kL) {
    const float bt = bv[tid];
    float mx = (bt - bv[0]) + iv[0];
    for (int s = 1; s <= tid; ++s) mx = fmaxf(mx, (bt - bv[s]) + iv[s]);
    mi[tid] = mx;
    sc.gb[bhc * kL + tid] = bt;
    sc.gm[bhc * kL + tid] = mx;
    // the carry's terms: u_s = g - b_s + i_s and their maximum
    const float u = (bv[kL - 1] - bt) + iv[tid];
    sc.gu[bhc * kL + tid] = u;
    float um = u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      um = fmaxf(um, __shfl_xor_sync(0xffffffffu, um, o));
    }
    if (tid % 32 == 0) red[tid / 32] = um;
  }

  // q_t . k_s for rows t = 4 ty .. 4 ty + 3, columns s = 4 tx .. 4 tx + 3;
  // tiles wholly above the diagonal are left at zero
  const bool live = 4 * tx <= 4 * ty + 3;
  float acc[4][4] = {};
  float rq[8], rk[8];
  load_tile<kK>(qb, st.q[1], st.q[3], steps, dk, vq, rq);
  load_tile<kK>(kb, st.k[1], st.k[3], steps, dk, vk, rk);
  for (int k0 = 0; k0 < dk; k0 += kK) {
    __syncthreads();
    store_cols<kK>(&qT[0][0], kP, rq, scale);
    store_cols<kK>(&kT[0][0], kP, rk, 1.0f);
    __syncthreads();
    if (k0 + kK < dk) {              // the next slice, while this one runs
      load_tile<kK>(qb + (k0 + kK) * st.q[3], st.q[1], st.q[3], steps,
                    dk - k0 - kK, vq, rq);
      load_tile<kK>(kb + (k0 + kK) * st.k[3], st.k[1], st.k[3], steps,
                    dk - k0 - kK, vk, rk);
    }
    if (live) {
#pragma unroll 8
      for (int kk = 0; kk < kK; ++kk) {
        outer4(reinterpret_cast<const float4*>(qT[kk])[ty],
               reinterpret_cast<const float4*>(kT[kk])[tx], acc);
      }
    }
  }

  if (tid == 0) {                    // red is in since the slices' barriers
    sc.gl[bhc * 2] = bv[kL - 1];
    sc.gl[bhc * 2 + 1] = fmaxf(red[0], red[1]);
  }
  float* W = sc.W + bhc * kL * kL;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = 4 * ty + a;
    float w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = 4 * tx + e;
      w[e] = s <= t ? __fmul_rn(expf(((bv[t] - bv[s]) + iv[s]) - mi[t]),
                                acc[a][e])
                    : 0.0f;
    }
    reinterpret_cast<float4*>(W + t * kL)[tx] =
        make_float4(w[0], w[1], w[2], w[3]);
  }
}

// ---------------------------------------------------------------------
// 2. the carry: grid (ceil(dv / kT), ceil(dk / kT), B * H)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   Scratch sc, float* __restrict__ C_out,
                   float* __restrict__ n_out, float* __restrict__ m_out,
                   int S, int H, int dk, int dv, int nch, Strides st) {
  __shared__ __align__(16) float kw[kL][kP];   // [s][r]: k_s w_s
  __shared__ __align__(16) float vs[kL][kP];   // [s][j]
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int j0 = blockIdx.x * kT;
  const int r0 = blockIdx.y * kT;
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int hh = bh % H;
  const bool first_col = blockIdx.x == 0;
  const T* kb = k + b * st.k[0] + hh * st.k[2] + r0 * st.k[3];
  const T* vb = v + b * st.v[0] + hh * st.v[2] + j0 * st.v[3];
  const int rn = min(kT, dk - r0);
  const int jn = min(kT, dv - j0);
  const bool vk = vec_rows(kb, st.k[1], st.k[3]);
  const bool vv = vec_rows(vb, st.v[1], st.v[3]);
  const bool c4 = dv % 4 == 0;

  float C[4][4] = {};
  float n = 0.0f;                    // threads < kL of the first dv tile
  float m = kNeg;
  float rk[2][8], rv[2][8];
  // chunk c's gate terms (from the scores pass: g, max_s u_s, and u_s of
  // the row s = tid / 4 whose k the thread stores) and its k and v tiles
  float pg = 0.0f, pml = kNeg, pu = kNeg;
  auto fetch = [&](int c) {
    const int s0 = c * kL;
    const int steps = min(kL, S - s0);
    const long long bhc = static_cast<long long>(bh) * nch + c;
    pg = sc.gl[bhc * 2];
    pml = sc.gl[bhc * 2 + 1];
    pu = sc.gu[bhc * kL + tid / (kK / 8)];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      load_tile<kK>(kb + s0 * st.k[1] + h2 * kK * st.k[3], st.k[1], st.k[3],
                    steps, rn - h2 * kK, vk, rk[h2]);
      load_tile<kK>(vb + s0 * st.v[1] + h2 * kK * st.v[3], st.v[1], st.v[3],
                    steps, jn - h2 * kK, vv, rv[h2]);
    }
  };
  if (nch > 0) fetch(0);

  for (int c = 0; c < nch; ++c) {
    const long long bhc = static_cast<long long>(bh) * nch + c;
    // the state entering chunk c
    float* Cc = sc.C + bhc * dk * dv;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = 4 * ty + a;
      const int j = 4 * tx;
      if (r < rn && j < jn) {
        float* p = Cc + static_cast<long long>(r0 + r) * dv + j0 + j;
        if (c4) {
          *reinterpret_cast<float4*>(p) =
              make_float4(C[a][0], C[a][1], C[a][2], C[a][3]);
        } else {
          for (int e = 0; e < 4 && j + e < jn; ++e) p[e] = C[a][e];
        }
      }
    }
    if (first_col && tid < rn) sc.n[bhc * dk + r0 + tid] = n;
    if (first_col && blockIdx.y == 0 && tid == 0) sc.m[bhc] = m;

    // the chunk's weights: m' = max(g + m, max_s u_s), w_s = exp(u_s - m')
    const float g = pg;
    const float m_next = fmaxf(g + m, pml);
    const float w_c = expf((g + m) - m_next);
    const float w = expf(pu - m_next);
    store_rows<kK>(&vs[0][0], kP, rv[0], 1.0f);
    store_rows<kK>(&vs[0][kK], kP, rv[1], 1.0f);
    store_rows<kK>(&kw[0][0], kP, rk[0], w);
    store_rows<kK>(&kw[0][kK], kP, rk[1], w);
    __syncthreads();
    if (c + 1 < nch) fetch(c + 1);   // the next chunk, while this one runs

    float acc[4][4] = {};
#pragma unroll 8
    for (int s = 0; s < kL; ++s) {
      outer4(reinterpret_cast<const float4*>(kw[s])[ty],
             reinterpret_cast<const float4*>(vs[s])[tx], acc);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        C[a][e] = __fadd_rn(__fmul_rn(C[a][e], w_c), acc[a][e]);
      }
    }
    if (first_col && tid < kL) {
      float ks = 0.0f;
      for (int s = 0; s < kL; ++s) ks += kw[s][tid];
      n = __fadd_rn(__fmul_rn(n, w_c), ks);
    }
    m = m_next;
    __syncthreads();                 // the tiles are read
  }

  const long long bh64 = bh;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * ty + a;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * tx + e;
      if (r < rn && j < jn) {
        C_out[(bh64 * dk + r0 + r) * dv + j0 + j] = C[a][e];
      }
    }
  }
  if (first_col && tid < rn) n_out[bh64 * dk + r0 + tid] = n;
  if (first_col && blockIdx.y == 0 && tid == 0) m_out[bh] = m;
}

// ---------------------------------------------------------------------
// 3. the outputs: grid (ceil(dv / kT), chunks, B * H)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_output_kernel(const T* __restrict__ q, const T* __restrict__ v,
                    Scratch sc, float* __restrict__ h, int S, int H, int dk,
                    int dv, float scale, Strides st) {
  extern __shared__ __align__(16) float smem[];   // kOutputSmem bytes
  auto* qT = reinterpret_cast<float(*)[kP]>(smem);           // [kK][kP]: q^T
  auto* Cs = qT + kK;                                        // [kK][kP]: C
  auto* WT = Cs + kK;                                        // [kL][kP]: W'^T
  auto* vs = WT + kL;                                        // [kL][kP]: v
  float* ns = &vs[kL][0];                                    // [kMaxDk]
  float* wt = ns + kMaxDk;                                   // [kL] each
  float* rt = wt + kL;
  float* mt = rt + kL;
  float* qn = mt + kL;
  float* wsum = qn + kL;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int j0 = blockIdx.x * kT;
  const int c = blockIdx.y;
  const int nch = gridDim.y;
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int hh = bh % H;
  const int s0 = c * kL;
  const int steps = min(kL, S - s0);
  const int jn = min(kT, dv - j0);
  const long long bhc = static_cast<long long>(bh) * nch + c;
  const T* qb = q + b * st.q[0] + hh * st.q[2] + s0 * st.q[1];
  const T* vb = v + b * st.v[0] + hh * st.v[2] + s0 * st.v[1] + j0 * st.v[3];
  const float* Cc = sc.C + bhc * dk * dv + j0;
  const bool vq = vec_rows(qb, st.q[1], st.q[3]);
  const bool vv = vec_rows(vb, st.v[1], st.v[3]);
  const bool vc = vec_rows(Cc, dv, 1);

  if (tid < kL) {
    const float bt = sc.gb[bhc * kL + tid];
    const float mi = sc.gm[bhc * kL + tid];
    const float m = sc.m[bhc];
    const float m_t = fmaxf(bt + m, mi);
    mt[tid] = m_t;
    wt[tid] = expf((bt + m) - m_t);
    rt[tid] = expf(mi - m_t);
  }
  // q C_c over dk in slices of kK (C's slice: kK rows of kT columns); the
  // first slice's loads go out before the tiles of the chunk
  float rq[8], rc[8];
  auto fetch = [&](int k0) {
    load_tile<kK>(qb + k0 * st.q[3], st.q[1], st.q[3], steps, dk - k0, vq,
                  rq);
    load_tile<kT>(Cc + static_cast<long long>(k0) * dv, dv, 1, dk - k0, jn,
                  vc, rc);
  };
  fetch(0);
  for (int e = tid; e < dk; e += kThreads) ns[e] = sc.n[bhc * dk + e];
  {
    float r[8];
    const float* W = sc.W + bhc * kL * kL;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      load_tile<kK>(W + h2 * kK, kL, 1, kL, kK, true, r);
      store_cols<kK>(&WT[h2 * kK][0], kP, r, 1.0f);
      load_tile<kK>(vb + h2 * kK * st.v[3], st.v[1], st.v[3], steps,
                    jn - h2 * kK, vv, r);
      store_rows<kK>(&vs[0][h2 * kK], kP, r, 1.0f);
    }
  }

  float acc[4][4] = {};
  float qnp = 0.0f;                  // threads < kL: q_t . n
  for (int k0 = 0; k0 < dk; k0 += kK) {
    __syncthreads();
    store_cols<kK>(&qT[0][0], kP, rq, scale);
    store_rows<kT>(&Cs[0][0], kP, rc, 1.0f);
    __syncthreads();
    if (k0 + kK < dk) fetch(k0 + kK);   // the next slice, while this runs
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      outer4(reinterpret_cast<const float4*>(qT[kk])[ty],
             reinterpret_cast<const float4*>(Cs[kk])[tx], acc);
    }
    if (tid < kL) {
      const int kn = min(kK, dk - k0);
      for (int kk = 0; kk < kn; ++kk) qnp = fmaf(qT[kk][tid], ns[k0 + kk], qnp);
    }
  }

  // W' v within the chunk: columns s <= 4 ty + 3 only
  float wv[4][4] = {};
  const int s_end = 4 * ty + 4;
  for (int s = 0; s < s_end; ++s) {
    outer4(reinterpret_cast<const float4*>(WT[s])[ty],
           reinterpret_cast<const float4*>(vs[s])[tx], wv);
  }
  if (tid < kL) {
    float ws = 0.0f;
    for (int s = 0; s <= tid; ++s) ws += WT[s][tid];
    qn[tid] = qnp;
    wsum[tid] = ws;
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = 4 * ty + a;
    if (t >= steps) continue;
    const float den = __fadd_rn(__fmul_rn(qn[t], wt[t]),
                                __fmul_rn(wsum[t], rt[t]));
    const float lim = fmaxf(fabsf(den), expf(-mt[t]));
    float* hr = h + ((static_cast<long long>(b) * S + s0 + t) * H + hh) *
                        static_cast<long long>(dv) + j0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * tx + e;
      if (j < jn) {
        const float num = __fadd_rn(__fmul_rn(acc[a][e], wt[t]),
                                    __fmul_rn(wv[a][e], rt[t]));
        hr[j] = __fdiv_rn(num, lim);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* ig,
           const float* fg, float* h, float* C, float* n, float* m,
           float* scratch, int B, int S, int H, int dk, int dv, float scale,
           const long long* s, cudaStream_t stream) {
  Strides st;
  for (int a = 0; a < 4; ++a) {
    st.q[a] = s[a];
    st.k[a] = s[4 + a];
    st.v[a] = s[8 + a];
  }
  for (int a = 0; a < 3; ++a) {
    st.i[a] = s[12 + a];
    st.f[a] = s[15 + a];
  }
  const int nch = (S + kL - 1) / kL;
  const Scratch sc =
      split(scratch, static_cast<long long>(B) * H * nch, dk, dv);
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  if (nch > 0) {
    mlstm_scores_kernel<T><<<dim3(nch, B * H), kThreads, 0, stream>>>(
        qt, kt, ig, fg, sc, S, H, dk, scale, st);
  }
  const dim3 state_grid((dv + kT - 1) / kT, (dk + kT - 1) / kT, B * H);
  mlstm_state_kernel<T><<<state_grid, kThreads, 0, stream>>>(
      kt, vt, sc, C, n, m, S, H, dk, dv, nch, st);
  if (nch > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlstm_output_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kOutputSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 output_grid((dv + kT - 1) / kT, nch, B * H);
    mlstm_output_kernel<T><<<output_grid, kThreads, kOutputSmem, stream>>>(
        qt, vt, sc, h, S, H, dk, dv, scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch that repro_mlstm_chunkwise needs.
extern "C" long long repro_mlstm_scratch_floats(int B, int S, int H, int dk,
                                                int dv) {
  const long long nch = (S + kL - 1) / kL;
  return static_cast<long long>(
      scratch_floats(static_cast<long long>(B) * H * nch, dk, dv));
}

// q, k (B, S, H, dk) and v (B, S, H, dv), float32 (bf16 == 0) or bfloat16
// (bf16 != 0); the gates i, f (B, S, H) float32; any element strides:
// strides[0..3] are q's (b, s, h, d), [4..7] k's, [8..11] v's, [12..14]
// i's (b, s, h), [15..17] f's.  Writes h (B, S, H, dv), C (B, H, dk, dv),
// n (B, H, dk) and m (B, H), contiguous float32.  scratch: the float32
// device memory repro_mlstm_scratch_floats asks for.  scale is 1 / sqrt(dk)
// in float32; dk is at most 256.  Launches its three kernels on `stream`
// and returns cudaGetLastError(): a refused launch never runs, and only
// this code reports it.
extern "C" int repro_mlstm_chunkwise(const void* q, const void* k,
                                     const void* v, const void* i_gate,
                                     const void* f_gate, void* h, void* C,
                                     void* n, void* m, void* scratch, int B,
                                     int S, int H, int dk, int dv, int bf16,
                                     float scale, const long long* strides,
                                     void* stream) {
  if (dk <= 0 || dk > kMaxDk) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || dv <= 0) return static_cast<int>(cudaSuccess);
  const auto* ig = static_cast<const float*>(i_gate);
  const auto* fg = static_cast<const float*>(f_gate);
  auto* hf = static_cast<float*>(h);
  auto* Cf = static_cast<float*>(C);
  auto* nf = static_cast<float*>(n);
  auto* mf = static_cast<float*>(m);
  auto* sf = static_cast<float*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(q, k, v, ig, fg, hf, Cf, nf, mf, sf, B, S,
                                 H, dk, dv, scale, strides, s);
  }
  return launch<float>(q, k, v, ig, fg, hf, Cf, nf, mf, sf, B, S, H, dk, dv,
                       scale, strides, s);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
