// Forward flash attention for Hopper (sm_90a), bfloat16: wgmma tensor-core
// products, TMA loads and a warp-specialised pipeline.  GQA, causal, sliding
// window, tanh soft-cap.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_bhsd, the
// Pallas TPU kernel, for bfloat16 inputs, and computes the same function:
// for every query row an online softmax over the key rows of its KV head
// (h / (H / K)), scores scaled by the float32 1/sqrt(hd), soft-capped as
// cap * tanh(s / cap), masked scores set to -2e9 (key rows past S, row < col
// when causal, row - col >= window), the running max m starting at -inf,
// float32 accumulators, and the output acc / max(l, 1e-30) in bfloat16.
// float32 inputs take csrc/flash_attention.cu (float32 FMAs, the
// reference's 2e-5), which bf16 tensor cores cannot meet.
//
// Layout: q, k, v and o are addressed through their (batch, sequence, head)
// strides with a contiguous head dimension: the model's (B, S, H, hd)
// tensors and the strided views of a fused qkv projection go in as they are.
// The tensor maps need 16-byte aligned bases and strides that are multiples
// of 16 bytes; the wrapper sends only such inputs here.
//
// What bounds it: at the LM path's (B 8, H 16, K 8, S 512, hd 128) causal
// call the 50 MB of q, k, v and o take 0.015 ms at 3.35 TB/s, while the
// 8.6 GFLOP of the two products take 0.0087 ms on the bf16 tensor cores at
// 989 TFLOP/s: the tensor cores make the bytes the bound (the float32 FMAs
// of csrc/flash_attention.cu put its floor at 0.13 ms).
//
// Design.  A persistent grid, one block per SM (at most one per work
// item); block k takes items k, k + grid, ...  An item is 128 query rows of
// one (b, h); items are numbered last query tile first, so that the
// longest causal kv loops start first.  384 threads in three warpgroups:
//   - a producer (setmaxnreg down to 40 registers) whose one thread issues
//     every TMA load: each item's Q (128 x hd) into one of two Q buffers
//     (one at hd 256), so the next item's Q arrives while this one runs;
//     K and V tiles of BN keys (128; 64 at hd 192 and 256) through two
//     rings of their own, 2 stages each, on full/empty mbarriers.  4-D
//     tensor maps over (hd, heads, S, B) with byte strides, boxes of 64
//     columns (32 at hd 32) and the matching 128-byte (64-byte) swizzle;
//     rows past S arrive as zeros and the masks do the rest.
//   - two consumers (setmaxnreg up to 232) of 64 query rows each.  S = Q K^T
//     is wgmma m64nBNk16 f32 += bf16 . bf16 with Q and K from shared memory
//     (both K-major).  The softmax runs in registers in the accumulator's
//     layout, in base 2 (scores times scale log2 e, ex2.approx): a thread
//     holds two rows, and the row max and sum reduce over the 4 threads of
//     a quad.  The soft-cap, then the mask, which runs only on tiles that
//     straddle the causal diagonal, the window edge or the end of S; the kv
//     loop runs from the window's first live tile to the causal frontier.
//     P goes pairwise to bfloat16 in registers and is wgmma's A operand
//     (the m64 accumulator layout is the A-fragment layout); V is B from
//     shared memory in its (keys, hd) layout, MN-major (the transpose bit),
//     one m64n{hd}k16 product per 16 keys.  S(j+1) is issued before
//     P(j) V(j), so P(j+1)'s softmax runs while P(j) V(j) does; a stage of
//     K is released when its S is done, a stage of V after the
//     wgmma.wait_group of the P V that read it.  The consumers take turns
//     to issue their products (named barriers), so one's products run while
//     the other computes its softmax.
//   - the epilogue multiplies by 1 / max(l, 1e-30), rounds to bfloat16,
//     stages the rows in the consumer's part of its Q buffer in the tensor
//     map's swizzled layout, and one thread stores them with a TMA store
//     (rows past S are dropped); then the Q buffer goes back to the
//     producer.
// Shared memory: 2 x Q 32 KB + 2 x K 32 KB + 2 x V 32 KB = 192 KB at
// hd 128; at hd 192 (MLA: 128 nope + 64 rope, v padded to 192) 2 x Q
// 48 KB + 2 x K 24 KB + 2 x V 24 KB = 192 KB, three 64-column TMA boxes a
// row and one m64n192k16 product per 16 keys of P V; 192 KB at hd 256
// (one Q buffer): one block per SM, above the 48 KB default.
//
// Where bfloat16 rounding enters: q, k and v are bfloat16, and their
// products are exact in float32; P is rounded to bfloat16 before P.V (at
// most 2^-9 relative on each weight); the output is rounded to bfloat16.
// l sums the float32 P, before its rounding.  Within the reference's 2e-2
// bfloat16 tolerance; flash_attention_tc_plain repeats this arithmetic
// (with the exact 2^x where this kernel has ex2.approx).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int BQ = 128;              // query rows per block, 64 a consumer
constexpr int kTurn = 3;             // named barriers 3, 4: issue turns
constexpr float kNeg = -2.0e9f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int BN = HD >= 192 ? 64 : 128;   // keys per kv tile
  static constexpr int STAGES = 2;                  // K ring and V ring
  static constexpr int Q_BUFS = HD == 256 ? 1 : 2;  // Q tiles in flight
  static constexpr int CB = HD < 64 ? HD : 64;      // columns per TMA box
  static constexpr int NCB = HD / CB;               // boxes per row
  static constexpr int ROW = CB * 2;                // box row bytes: swizzle
  static constexpr int LAYOUT = ROW == 128 ? 1 : 2; // wgmma: 128B / 64B swizzle
  static constexpr uint32_t SBO = 8 * ROW;          // bytes per 8 rows
  static constexpr uint32_t Q_BYTES = BQ * HD * 2;
  static constexpr uint32_t KV_BYTES = BN * HD * 2; // one K or V tile
  // Q[Q_BUFS], then K[STAGES], then V[STAGES], then the mbarriers
  static constexpr uint32_t K_OFF = Q_BUFS * Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 16 * (Q_BUFS + 2 * STAGES) + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block can have");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---- TMA -------------------------------------------------------------------

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// One box from shared memory to a 4-D tensor map; rows past the tensor's
// end are dropped.  Completion is tracked by the issuing thread's bulk
// groups.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a box whose rows are
// `row_bytes` long, in the layout TMA's matching swizzle gives it.
__device__ __forceinline__ uint32_t swizzled(int row, int chunk,
                                             int row_bytes) {
  const int x = row_bytes == 128 ? row & 7 : (row >> 1) & 3;
  return row * row_bytes + ((chunk ^ x) << 4);
}

// ---- named barriers --------------------------------------------------------

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor: start address; leading byte offset
// (K-major swizzled layouts do not read it; an MN-major operand wider than
// the swizzle steps by it from one column box to the next); stride byte
// offset between 8-row groups; the swizzle (1: 128 bytes, 2: 64 bytes).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t sbo,
                                              int layout,
                                              uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the wgmma fences and waits around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory,
// both K-major; scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B from shared memory,
// both K-major; scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (four bf16 pairs
// a thread, in the accumulator's layout), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256], A from registers (four bf16 pairs
// a thread, in the accumulator's layout), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 192] += A[64 x 16] . B[16 x 192], A from registers (four bf16 pairs
// a thread, in the accumulator's layout), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (four bf16 pairs
// a thread, in the accumulator's layout), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A from registers (four bf16 pairs
// a thread, in the accumulator's layout), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// bfloat16 pair (lo in the low half) as one 32-bit register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, desc_a, desc_b, scale_d);
  else
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
}

// The accumulator layout of an m64nN product: register i of a thread holds
// row 16 warp + lane / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) +
// 2 (lane % 4) + i % 2.

// s = Q K^T: this consumer's 64 rows of Q against the BN keys of a stage.
template <int HD>
__device__ __forceinline__ void qk_product(float (&s)[Tile<HD>::BN / 2],
                                           uint32_t q_rows, uint32_t k_tile) {
  using T = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t box = kk * 16 / T::CB;     // and bytes into its row:
    const uint32_t off = (kk * 16 % T::CB) * 2;  // the swizzle is by address
    wgmma_ss<T::BN>(
        s, make_desc(q_rows + box * BQ * T::ROW + off, T::SBO, T::LAYOUT),
        make_desc(k_tile + box * T::BN * T::ROW + off, T::SBO, T::LAYOUT),
        kk > 0);
  }
}

// acc += P V: P from registers, V MN-major, keys 16 kk .. 16 kk + 15; one
// product spans the whole head dimension, box to box by the leading byte
// offset.
template <int HD>
__device__ __forceinline__ void pv_product(
    float (&acc)[HD / 2], const uint32_t (&p)[Tile<HD>::BN / 16][4],
    uint32_t v_tile) {
  using T = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < T::BN / 16; ++kk) {
    const uint64_t dv = make_desc(v_tile + kk * 16 * T::ROW, T::SBO,
                                  T::LAYOUT, T::BN * T::ROW);
    if constexpr (HD == 256)
      wgmma_rs_n256(acc, p[kk], dv);
    else if constexpr (HD == 192)
      wgmma_rs_n192(acc, p[kk], dv);
    else if constexpr (HD == 128)
      wgmma_rs_n128(acc, p[kk], dv);
    else if constexpr (HD == 64)
      wgmma_rs_n64(acc, p[kk], dv);
    else
      wgmma_rs_n32(acc, p[kk], dv);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile, in place, in base 2: the scores scaled
// by scale log2 e (soft-capped first, then times log2 e), masked (only on
// a tile that straddles an edge), then s becomes P = 2^(s - m) against the
// new running max m; l takes P's float32 sum (this thread's share), and
// corr the factor that the earlier accumulators take.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale, float softcap,
                                             bool edge, int row0, int col0,
                                             int S, int causal, int window) {
  const float scale_log2 = scale * kLog2e;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    float x;
    if (softcap > 0.0f)
      x = softcap * tanhf(s[i] * scale / softcap) * kLog2e;
    else
      x = s[i] * scale_log2;
    if (edge) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = col0 + 8 * (i >> 2) + (i & 1);
      bool ok = col < S;
      if (causal) ok = ok && row >= col;
      if (window > 0) ok = ok && row - col < window;
      x = ok ? x : kNeg;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(s[i] - m[r]);
    l[r] += s[i];
  }
}

// P in bfloat16 pairs as wgmma's A fragments: the k16 step kk of the tile
// is registers 8 kk .. 8 kk + 7 of the accumulator layout.
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BN / 16][4],
                                       const float (&s)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2)
    p[i / 8][(i % 8) / 2] = pack_bf16(s[i], s[i + 1]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_o, int B,
                            int H, int G, int S, float scale, int causal,
                            int window, float softcap) {
  using T = Tile<HD>;
  constexpr int BN = T::BN;
  constexpr int CB = T::CB;
  constexpr int ROW = T::ROW;
  constexpr int STAGES = T::STAGES;
  constexpr int Q_BUFS = T::Q_BUFS;

  // tiles on 1024 bytes, where the 128-byte swizzle pattern repeats
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + T::K_OFF;
  const uint32_t v_s = base + T::V_OFF;
  const uint32_t q_full0 = base + T::BAR_OFF;       // [Q_BUFS]
  const uint32_t q_empty0 = q_full0 + 8 * Q_BUFS;   // [Q_BUFS]
  const uint32_t k_full0 = q_empty0 + 8 * Q_BUFS;   // [STAGES] each
  const uint32_t k_empty0 = k_full0 + 8 * STAGES;
  const uint32_t v_full0 = k_empty0 + 8 * STAGES;
  const uint32_t v_empty0 = v_full0 + 8 * STAGES;

  // A persistent grid: block k takes items k, k + gridDim.x, ...; item w
  // is query tile nq - 1 - w / (B H) (the longest causal loops first) of
  // (b, h) = divmod(w % (B H), H).
  const int nq = (S + BQ - 1) / BQ;
  const int n_items = nq * B * H;
  auto decode = [&](int w, int& q_start, int& h, int& b, int& j_lo,
                    int& n_tiles) {
    const int bh = w % (B * H);
    q_start = (nq - 1 - w / (B * H)) * BQ;
    h = bh % H;
    b = bh / H;
    const int q_last = min(q_start + BQ, S) - 1;
    int j_hi = (S - 1) / BN;
    if (causal) j_hi = min(j_hi, q_last / BN);
    j_lo = window > 0 ? max(0, q_start - window + 1) / BN : 0;
    n_tiles = j_hi - j_lo + 1;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < Q_BUFS; ++i) {
      mbar_init(q_full0 + 8 * i, 1);
      mbar_init(q_empty0 + 8 * i, 2);    // each consumer's storing thread
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full0 + 8 * st, 1);
      mbar_init(k_empty0 + 8 * st, 256); // every consumer thread
      mbar_init(v_full0 + 8 * st, 1);
      mbar_init(v_empty0 + 8 * st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every load -----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;                                   // kv tiles so far
      int qi = 0;                                   // items so far
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++qi) {
        int q_start, h, b, j_lo, n_tiles;
        decode(w, q_start, h, b, j_lo, n_tiles);
        const int qb = qi % Q_BUFS;
        const uint32_t q_full = q_full0 + 8 * qb;
        mbar_wait(q_empty0 + 8 * qb, ((qi / Q_BUFS) & 1) ^ 1);
        mbar_expect_tx(q_full, T::Q_BYTES);
        for (int cb = 0; cb < T::NCB; ++cb)
          tma_load_4d(q_s + qb * T::Q_BYTES + cb * BQ * ROW, &tm_q, q_full,
                      cb * CB, h, q_start, b);
        const int kvh = h / G;
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int st = it % STAGES;
          const uint32_t parity = ((it / STAGES) & 1) ^ 1;
          const int k0 = (j_lo + j) * BN;
          mbar_wait(k_empty0 + 8 * st, parity);
          mbar_expect_tx(k_full0 + 8 * st, T::KV_BYTES);
          for (int cb = 0; cb < T::NCB; ++cb)
            tma_load_4d(k_s + st * T::KV_BYTES + cb * BN * ROW, &tm_k,
                        k_full0 + 8 * st, cb * CB, kvh, k0, b);
          mbar_wait(v_empty0 + 8 * st, parity);
          mbar_expect_tx(v_full0 + 8 * st, T::KV_BYTES);
          for (int cb = 0; cb < T::NCB; ++cb)
            tma_load_4d(v_s + st * T::KV_BYTES + cb * BN * ROW, &tm_v,
                        v_full0 + 8 * st, cb * CB, kvh, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each -------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int col_lane = 2 * (lane % 4);
    // The two consumers take turns to issue their products (named
    // barriers kTurn + c): one's products run on the tensor cores while
    // the other computes its softmax.  Consumer 0 goes first.
    if (c == 1) bar_arrive(kTurn, 256);
    int it = 0;                                     // kv tiles so far
    int qi = 0;                                     // items so far
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++qi) {
      int q_start, h, b, j_lo, n_tiles;
      decode(w, q_start, h, b, j_lo, n_tiles);
      const int qb = qi % Q_BUFS;
      const int row_lo = q_start + 64 * c;
      const int row0 = row_lo + 16 * warp + lane / 4;
      const uint32_t q_rows = q_s + qb * T::Q_BYTES + 64 * c * ROW;
      // a tile needs the mask where it straddles the causal diagonal, the
      // window's edge or the end of S
      auto edge = [&](int k0) {
        return k0 + BN > S || (causal && k0 + BN - 1 > row_lo) ||
               (window > 0 && row_lo + 63 - k0 >= window);
      };

      float acc[HD / 2];
      float s[BN / 2];
      uint32_t p[BN / 16][4];
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.0f, 0.0f};
      float corr[2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;

      // The loop keeps the tensor cores busy while the softmax runs: with
      // P(j) in registers, it issues S(j+1) = Q K(j+1)^T and then
      // acc += P(j) V(j), waits for S(j+1) only (and releases K(j+1)),
      // and computes P(j+1) while P(j) V(j) runs; then it waits for that,
      // releases V(j) and rescales.  K and V have rings of their own, so
      // K(j+2) loads while P(j) V(j) still reads V(j).
      mbar_wait(q_full0 + 8 * qb, (qi / Q_BUFS) & 1);
      {
        const int st = it % STAGES;
        mbar_wait(k_full0 + 8 * st, (it / STAGES) & 1);
        bar_sync(kTurn + c, 256);
        wgmma_fence();
        qk_product<HD>(s, q_rows, k_s + st * T::KV_BYTES);
        wgmma_commit();
        bar_arrive(kTurn + 1 - c, 256);
        wgmma_wait<0>();
        mbar_arrive(k_empty0 + 8 * st);
        fence_regs(s);
        softmax_tile<BN>(s, m, l, corr, scale, softcap, edge(j_lo * BN),
                         row0, j_lo * BN + col_lane, S, causal, window);
        pack_p<BN>(p, s);
      }
      for (int j = 0; j + 1 < n_tiles; ++j, ++it) {
        const int st = it % STAGES;
        const int st_next = (it + 1) % STAGES;
        const int k0 = (j_lo + j + 1) * BN;
        mbar_wait(k_full0 + 8 * st_next, ((it + 1) / STAGES) & 1);
        mbar_wait(v_full0 + 8 * st, (it / STAGES) & 1);
        bar_sync(kTurn + c, 256);
        wgmma_fence();
        qk_product<HD>(s, q_rows, k_s + st_next * T::KV_BYTES);
        wgmma_commit();
        pv_product<HD>(acc, p, v_s + st * T::KV_BYTES);
        wgmma_commit();
        bar_arrive(kTurn + 1 - c, 256);
        wgmma_wait<1>();                  // S(j+1); P(j) V(j) runs on
        mbar_arrive(k_empty0 + 8 * st_next);
        fence_regs(s);
        softmax_tile<BN>(s, m, l, corr, scale, softcap, edge(k0), row0,
                         k0 + col_lane, S, causal, window);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(v_empty0 + 8 * st);
        fence_regs(s);                    // P(j+1) replaces P(j) only now
        pack_p<BN>(p, s);
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      }
      {
        const int st = it % STAGES;       // the last P V
        mbar_wait(v_full0 + 8 * st, (it / STAGES) & 1);
        bar_sync(kTurn + c, 256);
        wgmma_fence();
        pv_product<HD>(acc, p, v_s + st * T::KV_BYTES);
        wgmma_commit();
        bar_arrive(kTurn + 1 - c, 256);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(v_empty0 + 8 * st);
        ++it;
      }

      // ---- epilogue: acc / l in bfloat16, staged in this consumer's rows
      // of its Q tile in the tensor map's swizzled layout, stored by TMA;
      // then the Q tile goes back to the producer
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
      }
      bar_sync(1 + c, 128);
#pragma unroll
      for (int i = 0; i < HD / 2; i += 2) {
        const int row = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
        const int chunk = i >> 2;              // 16-byte chunk of the row
        const uint32_t dst = q_rows + chunk / (CB / 8) * BQ * ROW +
                             swizzled(row, chunk % (CB / 8), ROW) +
                             col_lane * 2;
        const float r_inv = inv[(i >> 1) & 1];
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                     "r"(pack_bf16(acc[i] * r_inv, acc[i + 1] * r_inv))
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1 + c, 128);
      if (t == 0) {
        for (int cb = 0; cb < T::NCB; ++cb)
          tma_store_4d(&tm_o, q_rows + cb * BQ * ROW, cb * CB, h, row_lo, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(q_empty0 + 8 * qb);   // the Q tile is free again
      }
    }
    if (c == 0) bar_sync(kTurn, 256);     // consumer 1's last turn
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links against nothing beyond it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

constexpr int kNoEncoder = -1;
constexpr int kBadTensorMap = -2;

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (hd, heads, S, B) of bfloat16 with element strides st
// (batch, sequence, head); boxes of `cols` x `rows`, swizzled to match.
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int hd,
            int heads, int S, int B, const long long* st, int cols, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int S, const long long* strides, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  using T = Tile<HD>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kNoEncoder;
  CUtensorMap tq, tk, tv, to;
  if (!encode(enc, &tq, q, HD, H, S, B, strides, T::CB, BQ) ||
      !encode(enc, &tk, k, HD, K, S, B, strides + 3, T::CB, T::BN) ||
      !encode(enc, &tv, v, HD, K, S, B, strides + 6, T::CB, T::BN) ||
      !encode(enc, &to, o, HD, H, S, B, strides + 9, T::CB, BQ / 2))
    return kBadTensorMap;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = raise_smem_limit<flash_attention_sm90_kernel<HD>>(
        static_cast<int>(T::SMEM), device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = (S + BQ - 1) / BQ * H * B;     // one block per SM
  flash_attention_sm90_kernel<HD>
      <<<items < sms ? items : sms, kThreads, T::SMEM, stream>>>(
          tq, tk, tv, to, B, H, H / K, S, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, H, hd), k and v (B, S, K, hd), o like q, bfloat16, each given by
// its (batch, sequence, head) element strides in `strides` (12 values: q,
// k, v, o) with a contiguous head dimension; every base 16-byte aligned and
// every stride a multiple of 8 elements.  Launches on `stream` and returns
// cudaGetLastError(), or kNoEncoder / kBadTensorMap (negative) when a
// tensor map cannot be made: a refused launch never runs, and only this code
// reports it.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int H, int K, int S, int hd,
                                          const long long* strides,
                                          float scale, int causal, int window,
                                          float softcap, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (K <= 0 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, B, H, K, S, strides, scale, causal,
                        window, softcap, s);
    case 64:
      return launch<64>(q, k, v, o, B, H, K, S, strides, scale, causal,
                        window, softcap, s);
    case 128:
      return launch<128>(q, k, v, o, B, H, K, S, strides, scale, causal,
                         window, softcap, s);
    case 192:
      return launch<192>(q, k, v, o, B, H, K, S, strides, scale, causal,
                         window, softcap, s);
    case 256:
      return launch<256>(q, k, v, o, B, H, K, S, strides, scale, causal,
                         window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  if (code == kNoEncoder) return "cuTensorMapEncodeTiled is not available";
  if (code == kBadTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
