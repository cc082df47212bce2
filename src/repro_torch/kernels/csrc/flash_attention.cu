// Forward flash attention for Hopper (sm_90a): GQA, causal, sliding window,
// tanh soft-cap.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_bhsd, the
// Pallas TPU kernel, and computes the same function: for every query row,
// an online softmax over the key rows of its KV head (h / (H / K)), with
// q scaled by 1/sqrt(hd) in float32, scores soft-capped as
// cap * tanh(s / cap), masked scores set to -2e9 (key or query rows past S,
// row < col when causal, row - col >= window), running max m starting at
// -inf, float32 accumulators, and the output acc / max(l, 1e-30) written in
// q's dtype (float32 or bfloat16).
//
// Layout: q, k, v and o are addressed through explicit (batch, sequence,
// head) strides with a contiguous head dimension, so the model's
// (B, S, H, hd) tensors go in as they are, without transposes or copies.
//
// Design.  Grid (ceil(S/64), H, B): a block owns 64 query rows of one head.
// The TPU kernel walks kv blocks as the innermost sequential grid axis and
// keeps (m, l, acc) in VMEM scratch between steps; Hopper's blocks run in
// parallel and in no order, so here the kv loop runs inside the block, from
// the first tile the window leaves live to the causal frontier (the TPU
// kernel's pl.when(live) skip), and (m, l, acc) stay in registers.
//   - Q (64 x hd) is staged once in shared memory as float32, already
//     scaled; each kv tile stages K and V (64 x hd) as float32.  Rows are
//     padded by 4 floats so that 16-byte reads of neighbouring rows fall in
//     distinct banks.
//   - 256 threads as 16 x 16: thread (ty, tx) computes the scores of rows
//     ty + 16 i and columns tx + 16 j (i, j < 4) with float32 FMAs, then
//     owns rows ty + 16 i of the output, hd / 16 columns each.  The row max
//     and row sum are reduced over the 16 threads of a half-warp with
//     shuffles, so every thread holds its rows' m and l.
//   - The probabilities go through a 64 x 64 float32 tile in shared memory
//     to the P.V product.
//   - Where q, k and v rows start on 16 bytes (the model's tensors do),
//     tiles load 16 bytes a thread, and the next K and V tile is fetched
//     into registers while the block computes on the current one; at hd 256
//     those registers are not there and the loads go one element at a time.
//   - Blocks are launched last query tile first: under a causal mask those
//     have the longest kv loops, and starting them first shortens the tail.
// Shared memory: (3 * 64 * (hd + 4) + 64 * 68) * 4 bytes: 116 KB at hd 128,
// 164 KB at hd 192 (MLA's 128 + 64), 212 KB at hd 256, so one block
// (8 warps) per SM.  Both exceed the 48 KB
// default, so the host code raises the limit with cudaFuncSetAttribute once
// per instantiation.
//
// No tensor cores and no TF32: scores and products are float32 FMAs on the
// CUDA cores, so float32 inputs meet the reference's 2e-5 tolerance.
//
// What bounds it on this card: the FLOPs of the two products on the CUDA
// cores, and the shared-memory reads that feed them (12 16-byte reads per
// 64 to 128 FMAs).  At the main path's (B 8, H 16, K 8, S 512, hd 128)
// causal bf16 call, 8.6 GFLOP take at least 0.13 ms at the float32 rate of
// 67 TFLOP/s, while the 50 MB of q, k, v and o take 15 us at 3.35 TB/s
// (the bound the bf16 tensor cores would reach, at 989 TFLOP/s, is the
// bytes').  Tensor cores (wgmma) and TMA are work for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int BQ = 64;          // query rows per block: 16 ty x 4
constexpr int BK = 64;          // key rows per tile: 16 tx x 4
constexpr int kPad = 4;         // floats of padding per shared-memory row
constexpr float kNeg = -2.0e9f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ + 2 * BK) * (HD + kPad) + BQ * (BK + kPad));
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Rows row0 .. row0 + 63 of one head (src points at its row 0), times
// `scale`, into `dst` as float32; rows at or past S read as zero.  One
// element per load: for inputs whose rows are not 16-byte aligned.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride_s, int row0, int S,
                                          float scale) {
  for (int e = threadIdx.x; e < 64 * HD; e += kThreads) {
    const int r = e / HD;
    const int d = e % HD;
    const int row = row0 + r;
    float value = 0.0f;
    if (row < S) value = to_float(src[row * stride_s + d]) * scale;
    dst[r * (HD + kPad) + d] = value;
  }
}

// The same tile in 16-byte loads (4 floats or 8 bfloat16 values), in two
// halves: fetch_tile starts the loads into registers, store_tile converts
// and writes them to shared memory.  Between the two the block computes on
// the previous tile, so the loads' latency hides behind its arithmetic.
template <typename T, int HD>
struct TileRegs {
  static constexpr int kVec = 16 / sizeof(T);               // elements
  static constexpr int kPerThread = 64 * HD / kVec / kThreads;
  uint4 part[kPerThread];
};

template <typename T, int HD>
__device__ __forceinline__ void fetch_tile(TileRegs<T, HD>& regs,
                                           const T* src, int64_t stride_s,
                                           int row0, int S) {
  constexpr int kVec = TileRegs<T, HD>::kVec;
#pragma unroll
  for (int i = 0; i < TileRegs<T, HD>::kPerThread; ++i) {
    const int e = (threadIdx.x + i * kThreads) * kVec;
    const int row = row0 + e / HD;
    regs.part[i] = row < S ? *reinterpret_cast<const uint4*>(
                                 src + row * stride_s + e % HD)
                           : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <typename T, int HD>
__device__ __forceinline__ void store_tile(float* dst,
                                           const TileRegs<T, HD>& regs,
                                           float scale) {
  constexpr int kVec = TileRegs<T, HD>::kVec;
#pragma unroll
  for (int i = 0; i < TileRegs<T, HD>::kPerThread; ++i) {
    const int e = (threadIdx.x + i * kThreads) * kVec;
    float* out = dst + (e / HD) * (HD + kPad) + e % HD;
    const uint4 u = regs.part[i];
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(out) = make_float4(
          __uint_as_float(u.x) * scale, __uint_as_float(u.y) * scale,
          __uint_as_float(u.z) * scale, __uint_as_float(u.w) * scale);
    } else {
      *reinterpret_cast<float4*>(out) = make_float4(
          bf16_lo(u.x) * scale, bf16_hi(u.x) * scale, bf16_lo(u.y) * scale,
          bf16_hi(u.y) * scale);
      *reinterpret_cast<float4*>(out + 4) = make_float4(
          bf16_lo(u.z) * scale, bf16_hi(u.z) * scale, bf16_lo(u.w) * scale,
          bf16_hi(u.w) * scale);
    }
  }
}

// W consecutive floats of a shared-memory row (W = 4 or 2).
template <int W>
__device__ __forceinline__ void load_chunk(const float* p, float* out) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  }
}

struct Strides {
  int64_t b, s, h;   // the head dimension is contiguous
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int G,
                       int S, Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, int causal, int window, float softcap,
                       int aligned) {
  constexpr int RS = HD + kPad;       // row stride of the Q, K, V tiles
  constexpr int PS = BK + kPad;       // row stride of the P tile
  constexpr int OC = HD / 16;         // output columns per thread
  constexpr int W = OC >= 4 ? 4 : OC; // floats per output chunk
  constexpr int NC = OC / W;          // output chunks per thread
  static_assert(HD % 32 == 0 && OC % W == 0,
                "head_dim 32, 64, 128, 192 or 256");

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * RS;
  float* Vs = Ks + BK * RS;
  float* Ps = Vs + BK * RS;

  // 16-byte loads with the next tile in flight; at head_dim 192 and 256
  // the registers that takes are not there, and the loads go one by one
  aligned = aligned && HD <= 128;
  // the last query tiles (the longest causal kv loops) start first
  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + (h / G) * sk.h;
  const T* vh = v + b * sv.b + (h / G) * sv.h;

  // kv tiles from the window's first live tile to the causal frontier
  int j_hi = (S + BK - 1) / BK - 1;
  if (causal) j_hi = min(j_hi, (q_start + BQ - 1) / BK);
  int j_lo = 0;
  if (window > 0) {
    const int first = q_start - window + 2 - BK;  // live: k_start >= first
    if (first > 0) j_lo = (first + BK - 1) / BK;
  }

  float m[4], l[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  }

  TileRegs<T, HD> k_next, v_next;
  if (aligned) {
    fetch_tile<T, HD>(k_next, kh, sk.s, j_lo * BK, S);
    fetch_tile<T, HD>(v_next, vh, sv.s, j_lo * BK, S);
    TileRegs<T, HD> q_regs;
    fetch_tile<T, HD>(q_regs, qh, sq.s, q_start, S);
    store_tile<T, HD>(Qs, q_regs, scale);
  } else {
    load_tile<T, HD>(Qs, qh, sq.s, q_start, S, scale);
  }

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k_start = j * BK;
    __syncthreads();                    // Q staged; last tile consumed
    if (aligned) {
      store_tile<T, HD>(Ks, k_next, 1.0f);
      store_tile<T, HD>(Vs, v_next, 1.0f);
    } else {
      load_tile<T, HD>(Ks, kh, sk.s, k_start, S, 1.0f);
      load_tile<T, HD>(Vs, vh, sv.s, k_start, S, 1.0f);
    }
    __syncthreads();
    if (aligned && j < j_hi) {          // the next tile, in flight
      fetch_tile<T, HD>(k_next, kh, sk.s, k_start + BK, S);
      fetch_tile<T, HD>(v_next, vh, sv.s, k_start + BK, S);
    }

    // scores: rows ty + 16 i, columns tx + 16 jj
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * RS + d]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        kv[jj] =
            *reinterpret_cast<const float4*>(&Ks[(tx + 16 * jj) * RS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float t = s[i][jj];
          t = fmaf(qv[i].x, kv[jj].x, t);
          t = fmaf(qv[i].y, kv[jj].y, t);
          t = fmaf(qv[i].z, kv[jj].z, t);
          t = fmaf(qv[i].w, kv[jj].w, t);
          s[i][jj] = t;
        }
    }

    // soft-cap, mask, online softmax; P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_start + ty + 16 * i;
      float row_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k_start + tx + 16 * jj;
        float x = s[i][jj];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool ok = col < S && row < S;
        if (causal) ok = ok && row >= col;
        if (window > 0) ok = ok && (row - col) < window;
        x = ok ? x : kNeg;
        s[i][jj] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        row_sum += p;
        Ps[(ty + 16 * i) * PS + tx + 16 * jj] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P . V over the tile's 64 key rows
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PS + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = &Vs[(c + cc) * RS];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          float vv[W];
          load_chunk<W>(vrow + W * tx + 16 * W * n, vv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = lane(p4[i], cc);
#pragma unroll
            for (int e = 0; e < W; ++e)
              acc[i][n * W + e] = fmaf(p, vv[e], acc[i][n * W + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_start + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + b * so.b + row * so.s + h * so.h;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < W; ++e)
        store(orow + W * tx + 16 * W * n + e, acc[i][n * W + e] / denom);
  }
}

// cudaFuncSetAttribute applies to the current device only: the limit is
// raised once per device and kernel, so that the first launch on another
// card does not run without it.
template <auto Kernel>
cudaError_t raise_smem_limit(int bytes, int device) {
  static std::atomic<unsigned long long> done{0};    // one bit a device
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit != 0 && (done.load() & bit) != 0) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int S, const long long* strides, float scale,
           int causal, int window, float softcap, int aligned,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = raise_smem_limit<flash_attention_kernel<T, HD>>(
        static_cast<int>(smem), device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / K, S, sq, sk, sv, so,
      scale, causal, window, softcap, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int H, int K, int S, const long long* strides,
                float scale, int causal, int window, float softcap,
                int aligned, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, K, S, strides, scale, causal,
                           window, softcap, aligned, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, K, S, strides, scale, causal,
                           window, softcap, aligned, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, K, S, strides, scale, causal,
                            window, softcap, aligned, stream);
    case 192:
      return launch<T, 192>(q, k, v, o, B, H, K, S, strides, scale, causal,
                            window, softcap, aligned, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, K, S, strides, scale, causal,
                            window, softcap, aligned, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, S, H, hd), k and v (B, S, K, hd), o like q, each given by its
// (batch, sequence, head) element strides in `strides` (12 values: q, k, v,
// o) with a contiguous head dimension.  dtype 0 is float32, 1 bfloat16.
// aligned != 0 says that q, k and v start on 16 bytes and their strides
// are multiples of 16 bytes, so their rows load 16 bytes at a time.
// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and only this code reports it.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype, int B,
                                     int H, int K, int S, int hd,
                                     const long long* strides, float scale,
                                     int causal, int window, float softcap,
                                     int aligned, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (K <= 0 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, H, K, S, strides, scale,
                              causal, window, softcap, aligned, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, K, S, strides,
                                      scale, causal, window, softcap,
                                      aligned, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
