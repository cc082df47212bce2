// Chunkwise mLSTM, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mlstm.py:mlstm_chunkwise_bshd, the Pallas TPU
// kernel.
//
// What it computes: for q, k (B, S, H, dk), v (B, S, H, dv) (float32 or
// bfloat16, converted exactly to float32 on load) and the raw gates i, f
// (B, S, H) float32, per (b, head) the stabilised mLSTM from C = 0, n = 0,
// m = -1e30, chunk by chunk: with b_t the cumulative log sigmoid(f) in the
// chunk, D[t,s] = b_t - b_s + i_s (s <= t), m_t = max(b_t + m, max_s D),
//   h_t = (w_t q_t C + sum_s W[t,s] v_s) / max(|w_t q_t n + sum_s W[t,s]|,
//                                              exp(-m_t)),
// w_t = exp(b_t + m - m_t), W[t,s] = exp(D[t,s] - m_t) q_t.k_s, then the
// carry C <- C exp(g + m - m') + sum_s exp(g - b_s + i_s - m') k_s v_s^T
// (and n likewise), g = b_L.  It writes h (B, S, H, dv) float32 and the
// last C (B, H, dk, dv), n (B, H, dk), m (B, H).  Padded steps of the last
// chunk take log sigmoid(f) = 0 and i = -1e30, as the TPU kernel's.
//
// What bounds it: float32 operations.  At xlstm-125m's (B, S, H, dk, dv) =
// (8, 512, 4, 192, 384) the chunk's products (q k^T and W v within the
// chunk, q C and k^T v across chunks) are 5.2 GFLOP at this kernel's
// 32-step chunk (7.3 at the model's 256), 0.076 ms at 67 TFLOP/s, against
// 59.9 MB of bytes (q, k 6.3 MB each in bf16, v 12.6 MB, h 25.2 MB and the
// last C 9.4 MB in float32), 0.018 ms at 3.35 TB/s.  The TPU kernel keeps
// one head's C (192 x 384 floats, 295 KB) and a 256-step chunk's q and k
// (196 KB each) in VMEM and walks the chunks as its innermost grid axis;
// one block on Hopper has 227 KB and carries nothing between grid steps.
// So a block owns one (b, head) and 64 of the dv columns, C[:, tile] and
// n in shared memory for the whole sequence (n is recomputed by each of
// the dv tiles, which is cheap), and loops over the sequence itself in
// chunks of 32 steps, so that a chunk's q, k, its v tile and the 32 x 32
// score matrix fit beside C: 113 KB at dk 192, two blocks to an SM, 192
// blocks for the 132 SMs at the main shape.  The chunkwise form is exact
// at any chunk length, so the 32 steps change the result only in
// rounding.  Warp 0 computes the chunk's gate terms, one lane per step;
// the 256 threads, as 16 x 16, each compute 2 x 2 scores, 2 rows x 4
// adjacent columns of h and 4 x 4 entries of C at a time, in float32 FMAs
// on the CUDA cores.  Shared memory is read 16 bytes at a time: dk is
// padded with zeros to a multiple of 4, and the q and k rows' pitch is an
// odd number of 16-byte units, so 8 rows' reads fall in distinct banks.
// q, k, v and the gates are read through their strides, so the gate
// views that the model splits out of one projection need no copy.  expf,
// log1pf and IEEE division, no fast-math: the reference's tolerance is
// 1e-4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kL = 32;         // steps per chunk: one lane of warp 0 each
constexpr int kTV = 64;        // v columns per block: 16 tx x 4
constexpr int kMaxDk = 256;    // one thread per n entry in the update
constexpr float kNeg = -1e30f;

struct Strides {               // element strides of q, k, v (b, s, h, d)
  long long q[4], k[4], v[4];  // and of the gates (b, s, h)
  long long i[3], f[3];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// acc + a . b, the four products in order
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[j] += a * b[j]
__device__ __forceinline__ void axpy4(float a, float4 b, float (&acc)[4]) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// log sigmoid(x) = min(x, 0) - log1p(exp(-|x|)), as PyTorch computes it
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// Row pitch of the q and k tiles: dk rounded up to 4 floats (zero pad),
// plus 4, and an odd number of 16-byte units, so that the 16-byte reads
// of 8 consecutive rows fall in distinct banks.
__host__ __device__ __forceinline__ int tile_pitch(int dk4) {
  return (dk4 / 4) % 2 == 1 ? dk4 + 8 : dk4 + 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ ig,
             const float* __restrict__ fg, float* __restrict__ h,
             float* __restrict__ C_out, float* __restrict__ n_out,
             float* __restrict__ m_out, int S, int H, int dk, int dv,
             float scale, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int dk4 = (dk + 3) / 4 * 4;  // dk with a zero pad to 4 floats
  const int ldk = tile_pitch(dk4);
  float* qs = smem;                  // [kL][ldk]: q / sqrt(dk)
  float* ks = qs + kL * ldk;         // [kL][ldk]
  float* vs = ks + kL * ldk;         // [kL][kTV]: the block's v columns
  float* Ws = vs + kL * kTV;         // [kL][kL + 1]: decay-masked scores
  float* Cs = Ws + kL * (kL + 1);    // [dk4][kTV]: C[:, tile]
  float* ns = Cs + dk4 * kTV;        // [dk4]
  float* bv = ns + dk4;              // [kL]: log f, then its cumulative sum
  float* iv = bv + kL;               // [kL]: i, -1e30 on padded steps
  float* mt = iv + kL;               // [kL]: m_t
  float* wi = mt + kL;               // [kL]: exp(b_t + m - m_t)
  float* wsv = wi + kL;              // [kL]: exp(g - b_s + i_s - m')
  float* sc = wsv + kL;              // m, m', exp(g + m - m')
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);
  float4* Cs4 = reinterpret_cast<float4*>(Cs);
  const int ldk4 = ldk / 4;
  constexpr int kTV4 = kTV / 4;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int c0 = blockIdx.x * kTV;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * st.q[0] + hh * st.q[2];
  const T* kb = k + b * st.k[0] + hh * st.k[2];
  const T* vb = v + b * st.v[0] + hh * st.v[2];
  const float* ib = ig + b * st.i[0] + hh * st.i[2];
  const float* fb = fg + b * st.f[0] + hh * st.f[2];

  for (int e = tid; e < dk4 * kTV; e += kThreads) Cs[e] = 0.0f;
  for (int e = tid; e < dk4; e += kThreads) ns[e] = 0.0f;
  if (tid == 0) sc[0] = kNeg;
  __syncthreads();

  for (int t0 = 0; t0 < S; t0 += kL) {
    // the chunk: q (scaled), k, the v tile, the gates; zeros past S and dk
    for (int e = tid; e < kL * dk4; e += kThreads) {
      const int t = e / dk4;
      const int dd = e % dk4;
      const int s = t0 + t;
      float qv = 0.0f, kv = 0.0f;
      if (s < S && dd < dk) {
        qv = to_float(qb[s * st.q[1] + dd * st.q[3]]) * scale;
        kv = to_float(kb[s * st.k[1] + dd * st.k[3]]);
      }
      qs[t * ldk + dd] = qv;
      ks[t * ldk + dd] = kv;
    }
    for (int e = tid; e < kL * kTV; e += kThreads) {
      const int s = t0 + e / kTV;
      const int col = c0 + e % kTV;
      vs[e] = s < S && col < dv ? to_float(vb[s * st.v[1] + col * st.v[3]])
                                : 0.0f;
    }
    if (tid < kL) {
      const int s = t0 + tid;
      bv[tid] = s < S ? log_sigmoid(fb[s * st.f[1]]) : 0.0f;
      iv[tid] = s < S ? ib[s * st.i[1]] : kNeg;
    }
    __syncthreads();

    // the gate terms, one lane of warp 0 per step
    if (tid < 32) {
      if (lane == 0) {
        float acc = 0.0f;
        for (int t = 0; t < kL; ++t) {
          acc += bv[t];
          bv[t] = acc;
        }
      }
      __syncwarp();
      const float m = sc[0];
      const float bt = bv[lane];
      const float g = bv[kL - 1];
      float mi = (bt - bv[0]) + iv[0];
      for (int s = 1; s <= lane; ++s) mi = fmaxf(mi, (bt - bv[s]) + iv[s]);
      const float m_t = fmaxf(bt + m, mi);
      mt[lane] = m_t;
      wi[lane] = expf((bt + m) - m_t);
      const float u = (g - bt) + iv[lane];
      float mx = u;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_next = fmaxf(g + m, mx);
      wsv[lane] = expf(u - m_next);
      if (lane == 0) {
        sc[1] = m_next;
        sc[2] = expf((g + m) - m_next);
      }
    }
    __syncthreads();

    // scores: rows ty, ty + 16; columns tx, tx + 16; 4 of dk at a time
    {
      float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
      for (int d4 = 0; d4 < dk4 / 4; ++d4) {
        const float4 qa = qs4[ty * ldk4 + d4];
        const float4 qb4 = qs4[(ty + 16) * ldk4 + d4];
        const float4 ka = ks4[tx * ldk4 + d4];
        const float4 kb4 = ks4[(tx + 16) * ldk4 + d4];
        acc[0][0] = dot4(qa, ka, acc[0][0]);
        acc[0][1] = dot4(qa, kb4, acc[0][1]);
        acc[1][0] = dot4(qb4, ka, acc[1][0]);
        acc[1][1] = dot4(qb4, kb4, acc[1][1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int t = ty + 16 * r;
          const int s = tx + 16 * c;
          float w = 0.0f;
          if (s <= t) {
            const float D = (bv[t] - bv[s]) + iv[s];
            w = __fmul_rn(expf(D - mt[t]), acc[r][c]);
          }
          Ws[t * (kL + 1) + s] = w;
        }
      }
    }
    __syncthreads();

    // h: rows ty, ty + 16; columns 4 tx .. 4 tx + 3
    {
      float qc[2][4] = {}, wv[2][4] = {};
      float qn[2] = {0.0f, 0.0f}, wsum[2] = {0.0f, 0.0f};
      for (int d4 = 0; d4 < dk4 / 4; ++d4) {
        const float4 qa = qs4[ty * ldk4 + d4];
        const float4 qb4 = qs4[(ty + 16) * ldk4 + d4];
        const float q0[4] = {qa.x, qa.y, qa.z, qa.w};
        const float q1[4] = {qb4.x, qb4.y, qb4.z, qb4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 cv = Cs4[(4 * d4 + e) * kTV4 + tx];
          axpy4(q0[e], cv, qc[0]);
          axpy4(q1[e], cv, qc[1]);
        }
      }
      for (int s = 0; s < kL; ++s) {
        const float4 vv = vs4[s * kTV4 + tx];
        axpy4(Ws[ty * (kL + 1) + s], vv, wv[0]);
        axpy4(Ws[(ty + 16) * (kL + 1) + s], vv, wv[1]);
      }
      // q n and the score row sums, split over the 16 tx lanes
      for (int dd = tx; dd < dk4; dd += 16) {
        qn[0] = fmaf(qs[ty * ldk + dd], ns[dd], qn[0]);
        qn[1] = fmaf(qs[(ty + 16) * ldk + dd], ns[dd], qn[1]);
      }
      for (int s = tx; s < kL; s += 16) {
        wsum[0] += Ws[ty * (kL + 1) + s];
        wsum[1] += Ws[(ty + 16) * (kL + 1) + s];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], o);
          wsum[r] += __shfl_xor_sync(0xffffffffu, wsum[r], o);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = ty + 16 * r;
        const float den = __fadd_rn(__fmul_rn(qn[r], wi[t]), wsum[r]);
        const float lim = fmaxf(fabsf(den), expf(-mt[t]));
        if (t0 + t < S) {
          float* hr = h + ((static_cast<int64_t>(b) * S + t0 + t) * H + hh) *
                              static_cast<int64_t>(dv);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = c0 + 4 * tx + j;
            if (col < dv) {
              const float num = __fadd_rn(__fmul_rn(qc[r][j], wi[t]), wv[r][j]);
              hr[col] = __fdiv_rn(num, lim);
            }
          }
        }
      }
    }
    __syncthreads();

    // the carry: C[:, tile], rows ty + 16 i, columns 4 tx .. 4 tx + 3
    {
      const float w_c = sc[2];
      for (int d0 = 0; d0 < dk4; d0 += 64) {
        float acc[4][4] = {};
        for (int s = 0; s < kL; ++s) {
          const float w = wsv[s];
          const float4 vv = vs4[s * kTV4 + tx];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int dd = d0 + ty + 16 * i;
            const float kw = dd < dk4 ? __fmul_rn(ks[s * ldk + dd], w) : 0.0f;
            axpy4(kw, vv, acc[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int dd = d0 + ty + 16 * i;
          if (dd < dk4) {
            float4 c = Cs4[dd * kTV4 + tx];
            c.x = __fadd_rn(__fmul_rn(c.x, w_c), acc[i][0]);
            c.y = __fadd_rn(__fmul_rn(c.y, w_c), acc[i][1]);
            c.z = __fadd_rn(__fmul_rn(c.z, w_c), acc[i][2]);
            c.w = __fadd_rn(__fmul_rn(c.w, w_c), acc[i][3]);
            Cs4[dd * kTV4 + tx] = c;
          }
        }
      }
      if (tid < dk4) {
        float acc = 0.0f;
        for (int s = 0; s < kL; ++s) {
          acc += __fmul_rn(ks[s * ldk + tid], wsv[s]);
        }
        ns[tid] = __fadd_rn(__fmul_rn(ns[tid], w_c), acc);
      }
      if (tid == 0) sc[0] = sc[1];
    }
    __syncthreads();
  }

  const int64_t bh = static_cast<int64_t>(b) * H + hh;
  for (int e = tid; e < dk * kTV; e += kThreads) {
    const int col = c0 + e % kTV;
    if (col < dv) C_out[(bh * dk + e / kTV) * dv + col] = Cs[e];
  }
  if (blockIdx.x == 0) {
    for (int e = tid; e < dk; e += kThreads) n_out[bh * dk + e] = ns[e];
    if (tid == 0) m_out[bh] = sc[0];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* ig,
           const float* fg, float* h, float* C, float* n, float* m, int B,
           int S, int H, int dk, int dv, float scale, const long long* s,
           cudaStream_t stream) {
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
  const int dk4 = (dk + 3) / 4 * 4;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(2 * kL) * tile_pitch(dk4) +
                       kL * kTV + kL * (kL + 1) +
                       static_cast<size_t>(dk4) * kTV + dk4 + 5 * kL + 4);
  auto* kernel = mlstm_kernel<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((dv + kTV - 1) / kTV, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ig, fg, h, C, n, m, S, H, dk, dv, scale, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k (B, S, H, dk) and v (B, S, H, dv), float32 (bf16 == 0) or bfloat16
// (bf16 != 0); the gates i, f (B, S, H) float32; any element strides:
// strides[0..3] are q's (b, s, h, d), [4..7] k's, [8..11] v's, [12..14]
// i's (b, s, h), [15..17] f's.  Writes h (B, S, H, dv), C (B, H, dk, dv),
// n (B, H, dk) and m (B, H), contiguous float32.  scale is 1 / sqrt(dk) in
// float32; dk is at most 256.  Launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and only this code
// reports it.
extern "C" int repro_mlstm_chunkwise(const void* q, const void* k,
                                     const void* v, const void* i_gate,
                                     const void* f_gate, void* h, void* C,
                                     void* n, void* m, int B, int S, int H,
                                     int dk, int dv, int bf16, float scale,
                                     const long long* strides, void* stream) {
  if (dk <= 0 || dk > kMaxDk) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || dv <= 0) return static_cast<int>(cudaSuccess);
  const auto* ig = static_cast<const float*>(i_gate);
  const auto* fg = static_cast<const float*>(f_gate);
  auto* hf = static_cast<float*>(h);
  auto* Cf = static_cast<float*>(C);
  auto* nf = static_cast<float*>(n);
  auto* mf = static_cast<float*>(m);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(q, k, v, ig, fg, hf, Cf, nf, mf, B, S, H, dk,
                                 dv, scale, strides, s);
  }
  return launch<float>(q, k, v, ig, fg, hf, Cf, nf, mf, B, S, H, dk, dv,
                       scale, strides, s);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
