// Fused FiLM-SIREN trunk, forward and backward, for Hopper (sm_90a).
//
// Replaces lightning_gan_zoo_tpu/ops/pallas/siren_trunk.py: `_trunk_fwd_impl`
// (the pl.pallas_call at :220, kernel `_fwd_kernel`) and `_trunk_bwd_impl`
// (the pl.pallas_call at :271, kernel `_bwd_kernel`). π-GAN's radiance field
// runs every ray point through L = 7 sine layers of width H = 256; the plain
// layer loop writes and rereads every layer's activation (B·M rows × H) from
// device memory several times per layer. These kernels keep a tile of rows
// on chip for the whole trunk.
//
// Numerics are the TPU kernel's (and ops/siren_trunk.py's, the plain
// version): layer 0 fully in f32; later layers multiply bf16 operands with
// f32 accumulation, round the product to bf16, add the bf16 bias in bf16 and
// apply FiLM in bf16 (γ·a rounded, then + β rounded); the sine argument
// w0·f is f32; the sine is fast_sin's polynomial, and the backward uses the
// polynomial's own derivative with f32 FiLM. The elementwise f32 steps are
// written with round-to-nearest intrinsics, so they round where PyTorch's
// eager ops round.
//
// What bounds it on this card. Per row the trunk does 6 products of
// 256×256 (0.79 MFLOP forward) against 12 bytes of input and 512 bytes of
// output, so once the activations stay on chip it is bound by the tensor
// cores, by feeding them the weights and by the sine's elementwise work on
// the CUDA cores. The six bf16 weight matrices (768 KB) do not fit in a
// block's 227 KB of shared memory, so each layer's matrix is streamed
// through shared memory in 64-row chunks; every block reads the same
// weights, which stay in L2.
//
// The product core, shared by both directions: a 64-row tile (one wgmma M)
// on chip, four warpgroups each multiplying it by a quarter of the columns
// (`wgmma` m64nNk16, bf16, f32 accumulators in registers), both operands in
// shared memory: the activation tile as K-major 8×8 core matrices, the
// weights from a 3-stage ring of 64-row chunks that one thread fills with
// 1-D `cp.async.bulk` copies completing on mbarriers. The wrapper packs W
// and Wᵀ once per autograd call into that layout (pack_weights), so a chunk
// is one contiguous copy and no tensor map is needed; the ring runs across
// products and across a block's tiles, so the next layer's chunks land while
// the elementwise steps run. The f32 product tile (st) is the meeting point
// of the products and the elementwise steps, which are unrolled and
// branch-free so their long dependent chains interleave across 16 warps.
//
// The forward, `trunk_fwd_kernel`: per 64-row tile, layer 0 in f32, then
// L−1 ring products, each followed by the elementwise step that the
// backward's recompute runs (the same routines, without the stash), and the
// last layer's bf16 rows copied out as 16-byte vectors. A block walks
// rows_per_block rows of one sample, so the ring never refills between its
// tiles. The 64-row tile halves the L2 weight traffic of a 32-row tile
// (25 GB instead of 50 GB per million rows).
//
// The backward (three kernels, one call):
//   1. `trunk_bwd_chain_kernel`: per 64-row tile, recompute the forward
//      (the forward's code, plus stash writes), then walk the layers back
//      keeping dh on chip, 12 products per tile on the same core. The TPU
//      kernel kept the per-layer stash (pre-activations and layer inputs,
//      ~5 MB for 512 rows) in VMEM; here it does not fit, so each layer's
//      pre-activation a_i and input h_i (both exactly bf16 for layers ≥ 1)
//      are spilled to device scratch the wrapper allocates, and a_0 (f32) is
//      recomputed from x. The slot of a_i is overwritten with the bf16 da_i
//      once the walk has read it. Column sums (db, dγ, dβ) and dW0 = xᵀ·da_0
//      (Cin ≤ 64 rows, read from the tile's f32 da_0 after the walk)
//      accumulate in one partial per block; dx is finished in the block.
//   2. `trunk_bwd_dw_kernel`: dWmid_i = h_iᵀ·da_i, a sum over all rows, as a
//      split-K `wgmma` GEMM over the two stashes: each block takes a range
//      of 64-row k-steps for 128 rows of dW (two warpgroups, m64nHk16), fed
//      by a 4-stage `cp.async.bulk` ring, and writes one partial. The stash
//      is stored in 8-row slabs so that a k-step of either operand is the
//      K-major layout wgmma reads for hᵀ and daᵀ (see "The stash" below).
//   3. `trunk_bwd_sum_*_kernel`s reduce the partials in a fixed order.
// No atomics: both directions are deterministic run to run, and the
// backward differentiates the very function the forward computed.
//
// Plain C interface, loaded with ctypes: each function launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kKC = 64;        // weight rows (columns, in the backward) per chunk
constexpr int kMaxL = 16;
constexpr int kMaxCin = 64;

// fast_sin (lightning_gan_zoo_tpu/ops/fast_math.py), constants as f32
constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr float kC1 = 6.2831854820251465f;
constexpr float kC2 = -1.7484556025237907e-07f;
constexpr float kS1 = 0.9994501731f;
constexpr float kS3 = -0.1658384295f;
constexpr float kS5 = 0.0079985753f;
constexpr float kS7 = -0.0001477404f;
constexpr float kD3 = static_cast<float>(3.0 * -0.1658384295);
constexpr float kD5 = static_cast<float>(5.0 * 0.0079985753);
constexpr float kD7 = static_cast<float>(7.0 * -0.0001477404);

struct W0s {
  float v[kMaxL];
};

__device__ __forceinline__ float bfr(float v) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16(v));
}

// rintf(t) (round half to even) on the FP32 pipe instead of the slower
// conversion unit: adding and taking away 2^23 leaves an integer, rounded
// to even, for |t| < 2^23; a larger t is an integer already. (The sign of a
// zero result may differ, and a sine of ±0 is ±0 either way.)
__device__ __forceinline__ float round_even(float t) {
  const float c = copysignf(8388608.0f, t);
  const float k = __fsub_rn(__fadd_rn(t, c), c);
  return fabsf(t) < 8388608.0f ? k : t;
}

// Cody–Waite reduction, each step rounded as the JAX code rounds it
__device__ __forceinline__ float sin_reduce(float x) {
  const float k = round_even(__fmul_rn(x, kInvTwoPi));
  return __fsub_rn(__fsub_rn(x, __fmul_rn(k, kC1)), __fmul_rn(k, kC2));
}

// Horner steps c + r2·p, each product and sum rounded on its own: nvcc would
// otherwise fuse them into FMAs, whose single rounding flips the bf16
// rounding of ~0.3 % of the outputs against the plain version. Written
// this way the forward matches it bit for bit on the card.
__device__ __forceinline__ float horner(float c, float r2, float p) {
  return __fadd_rn(c, __fmul_rn(r2, p));
}

__device__ __forceinline__ float sin_poly(float x) {
  const float r = sin_reduce(x);
  const float r2 = __fmul_rn(r, r);
  return __fmul_rn(r, horner(kS1, r2, horner(kS3, r2, horner(kS5, r2, kS7))));
}

__device__ __forceinline__ float dsin_poly(float x) {
  const float r = sin_reduce(x);
  const float r2 = __fmul_rn(r, r);
  return horner(kS1, r2, horner(kD3, r2, horner(kD5, r2, kD7)));
}

// Layer 0's f32 pre-activation x·W0[:, c] + b0[c]: a chain of fused
// multiply-adds, then the bias, as an f32 GEMM and a separate add round it.
// With w0 = 30 the sine magnifies a last-bit difference here into a flipped
// bf16 rounding of h_1, so this order is kept deliberately.
__device__ __forceinline__ float layer0_pre(const float* __restrict__ xr,
                                            const float* __restrict__ w0k,
                                            float b0, int Cin, int H, int c) {
  float a = __fmul_rn(xr[0], w0k[c]);
  for (int k = 1; k < Cin; ++k) a = __fmaf_rn(xr[k], w0k[k * H + c], a);
  return __fadd_rn(a, b0);
}

// ---------------------------------------------------------------------------
// Hopper building blocks: mbarriers, 1-D bulk copies (the
// TMA's plain-copy form: no tensor map), wgmma on operands in shared memory.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// The one arrival of a stage's "full" barrier, expecting `bytes` of copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Makes this thread's shared-memory stores visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of the accumulators above the wait.
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor without swizzle: the operand is stored as
// 8×8 bf16 "core matrices" of 128 contiguous bytes (8 rows of 16 bytes, K
// innermost). `lbo`: bytes between core matrices adjacent along K; `sbo`:
// bytes between core matrices adjacent along M (or N).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D (64×N f32, in registers) += A (64×16, K-major in shared memory) ·
// B (16×N, K-major in shared memory), bf16 operands. Thread t of the
// warpgroup holds D[16·(t/32) + (t%32)/4 + 8·((i%4)/2)][8·(i/4) + 2·(t%4) +
// i%2] in d[i]. scale_d 0 overwrites D.
template <int N>
struct Wgmma;
template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// ---------------------------------------------------------------------------
// The product core, the forward and the backward.

// The slots of the per-block column sums: db_i, dγ_i, dβ_i, dW0_k.
struct Slots {
  int L, n_film;
  __host__ __device__ int db(int i) const { return i; }
  __host__ __device__ int dg(int i) const { return L + i; }
  __host__ __device__ int dbt(int i) const { return L + n_film + i; }
  __host__ __device__ int dw0(int k) const { return L + 2 * n_film + k; }
  __host__ __device__ int count(int Cin) const { return L + 2 * n_film + Cin; }
};

// The stash. Sample b's rows sit at b·Mp + row, Mp = M rounded up to a
// k-step of the weight gradient (kStepRows); the padding rows hold h = 0 at
// layer 0, finite h after it and da = 0, so they add nothing to dW. Each
// slot is stored in slabs of 8 rows, column by column ([R/8][H][8] bf16): a
// thread writes the 8 rows of its column as one 16-byte vector (a warp, 512
// contiguous bytes), and every 8-row slab is 8×8 bf16 core matrices laid
// side by side, K (the row) innermost: the K-major operand layout wgmma
// reads for hᵀ and daᵀ, so a k-step of dW is one contiguous block per
// operand.
constexpr int kStepRows = 64;

__host__ __device__ __forceinline__ int padded_rows(int M) {
  return (M + kStepRows - 1) / kStepRows * kStepRows;
}

// Eight bf16 of one column as one 16-byte vector. Element indices are
// compile-time constants (unrolled loops), so the words stay in registers.
struct Pack8 {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  __device__ __forceinline__ void set(int e, bf16 v) {
    w[e >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(v))
                 << (16 * (e & 1));
  }
  __device__ __forceinline__ uint4 vec() const {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Element e of such a vector, as f32 (exact).
__device__ __forceinline__ float unpack8(const uint4& v, int e) {
  const int k = e >> 1;
  const uint32_t w = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  return __uint_as_float((e & 1) ? (w & 0xFFFF0000u) : (w << 16));
}

template <int H>
__device__ __forceinline__ uint4* slab_at(bf16* slot, size_t slab, int c) {
  return reinterpret_cast<uint4*>(slot + (slab * H + c) * 8);
}

// The product core of the forward and the chain kernel: a 64-row tile (one
// wgmma M) on chip for the whole trunk, four warpgroups, each multiplying it
// by a quarter of the columns. 16 warps per SM hide the latency of the
// elementwise steps' long chains.
constexpr int kCTM = 64;        // rows per tile
constexpr int kCThreads = 512;  // four warpgroups
constexpr int kCWarpgroups = kCThreads / 128;
// Bytes between K-adjacent core matrices of the activation tile: its 8 row
// groups of 128 bytes, plus 16, so the 4 column groups a warp writes in the
// elementwise map fall on distinct banks.
constexpr int kActLbo = 8 * 128 + 16;
// Per-layer column sums a thread hands over: db, dγ, dβ.
constexpr int kRedSums = 3;
// Weight chunks in flight: 3 of a product's 4 at H = 256 land while the
// elementwise steps before it run.
constexpr int kRingStages = 3;

template <int H>
struct ChainLayout {
  static constexpr int NW = H / kCWarpgroups;  // columns of a warpgroup
  static constexpr int RG = kCThreads / H;     // row groups of the elementwise map
  static constexpr int NSL = kCTM / 8 / RG;    // 8-row slabs of a thread per tile
  // slabs the elementwise loops unroll together (the registers of 512
  // threads allow two)
  static constexpr int NSU = NSL < 2 ? NSL : 2;
  static constexpr int SP = H + 8;             // st row stride (f32)
  static constexpr int KCH = H / kKC;          // ring chunks per product
  static constexpr int kChunkBytes = kKC * H * 2;
  static constexpr int kActOff = 128;          // after the ring's mbarriers
  static constexpr int kActBytes = (H / 8) * kActLbo;
  static constexpr int kProdOff = kActOff + kActBytes;
  static constexpr int kRedOff = kProdOff + kCTM * SP * 4;
  static constexpr int kRingOff = kRedOff + kRedSums * kCThreads * 4;
  static constexpr int kBytes = kRingOff + kRingStages * kChunkBytes;
};

// Element (r, k) of the activation tile: K-major 8×8 core matrices, the 8
// row groups of each column group side by side (128 bytes apart), column
// groups kActLbo bytes apart.
__device__ __forceinline__ int act_at(int r, int k) {
  return (k >> 3) * (kActLbo / 2) + (r >> 3) * 64 + (r & 7) * 8 + (k & 7);
}

// The ring of packed weight chunks. Every tile multiplies by the same
// sequence of per_tile·KCH chunks. The forward's per_tile = L−1 products
// use W packed as its transpose, matrices 0…L−2; the backward's per_tile =
// 2(L−1) are those L−1 (its recompute), then the walk back's (W itself,
// matrices L−1…2L−3, used from the last layer down). Chunk q of the
// block's sequence goes to stage q % kRingStages; its "full" barrier
// completes when its bytes land, its "empty" one when all 16 warps are done
// reading it.
struct Ring {
  unsigned char* buf;
  uint64_t* full;
  uint64_t* empty;
};

// Thread 0: issue chunk q once its stage is free.
template <int H>
__device__ __forceinline__ void ring_issue(const Ring& rg,
                                           const bf16* __restrict__ wpack,
                                           int q, int L, int per_tile) {
  using Cl = ChainLayout<H>;
  const int stage = q % kRingStages;
  if (q >= kRingStages) {
    mbar_wait(&rg.empty[stage], (q / kRingStages - 1) & 1);
  }
  const int p = q % (per_tile * Cl::KCH);
  const int j = p / Cl::KCH, kc = p % Cl::KCH;
  const int mat = j < L - 1 ? j : (L - 1) + (2 * L - 3 - j);
  mbar_expect_tx(&rg.full[stage], Cl::kChunkBytes);
  bulk_g2s(rg.buf + stage * Cl::kChunkBytes,
           wpack + ((size_t)mat * Cl::KCH + kc) * kKC * H, Cl::kChunkBytes,
           &rg.full[stage]);
}

// st[64 × H] = act[64 × H] · B, B the next matrix of the ring's sequence
// (W for a forward product, Wᵀ on the walk back), one chunk of 64 K-rows
// at a time from the ring. Warpgroup w takes columns [w·NW, (w+1)·NW), NW =
// H/4: four m64nNWk16 wgmmas per chunk, f32 accumulators in registers, then
// written to st. Every thread enters it past its last act store and leaves
// past a barrier with the product in st; q counts the chunks consumed.
template <int H>
__device__ __forceinline__ void ring_product(const bf16* act, float* st,
                                             const Ring& rg,
                                             const bf16* __restrict__ wpack,
                                             int& q, int total, int L,
                                             int per_tile, int tid) {
  using Cl = ChainLayout<H>;
  fence_proxy_async();  // this thread's act stores, visible to wgmma
  __syncthreads();      // act complete; every thread done reading st
  const int wg = tid / 128, lane = tid % 32;
  float acc[Cl::NW / 2];
#pragma unroll
  for (int k = 0; k < Cl::NW / 2; ++k) acc[k] = 0.0f;
  for (int kc = 0; kc < Cl::KCH; ++kc, ++q) {
    const int stage = q % kRingStages;
    mbar_wait(&rg.full[stage], (q / kRingStages) & 1);
    __syncwarp();
    const unsigned char* bw =
        rg.buf + stage * Cl::kChunkBytes + wg * Cl::NW * 16;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      const bf16* a = act + ((kc * kKC + kk * 16) >> 3) * (kActLbo / 2);
      Wgmma<Cl::NW>::mma(acc, smem_desc(a, kActLbo, 128),
                         smem_desc(bw + kk * 2 * H * 16, H * 16, 128), 1);
    }
    wg_commit();
    wg_wait_all();
    acc_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&rg.empty[stage]);
    if (tid == 0 && q + kRingStages < total)
      ring_issue<H>(rg, wpack, q + kRingStages, L, per_tile);
  }
  const int row = ((tid / 32) % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < Cl::NW / 8; ++j) {
    const int col = wg * Cl::NW + 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(st + row * Cl::SP + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(st + (row + 8) * Cl::SP + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
}

// The elementwise steps. Thread (c, g0) owns column c of the
// tile's 8-row slabs g0, g0 + RG, …, NSU of them at a time. The loops over
// those rows are unrolled and free of branches, so the compiler interleaves
// their dependent chains: a layer without FiLM runs with γ = 1 and β = 0
// (exact: a_i is a bf16 value), a row past M reads a row of x that exists
// and has its result masked, and its cotangent is 0, so its gradients are.
struct Tile {
  size_t slab0;   // the tile's first stash slab
  size_t xrow0;   // its first row in x, dy and dx
  int nrows;      // rows before M
  int c, g0;      // the thread's column and first slab
  // the row of x a thread may read for tile row r
  __device__ __forceinline__ size_t xrow(int r) const {
    return nrows > 0 ? xrow0 + min(r, nrows - 1) : 0;
  }
};

// Two bf16 as the 32-bit word of a Pack8 (the first in the low half).
__device__ __forceinline__ uint32_t word(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Layer 0 of the forward: h_1 = sin(w0·FiLM(x·W0 + b0)), f32, into act
// (0 in the rows past M) and, with kStash (the backward's recompute), into
// the stash.
template <int H, bool kStash>
__device__ __forceinline__ void recompute_layer0(
    const Tile& t, const float* __restrict__ x, const float* __restrict__ w0k,
    float b0, int Cin, float g, float bt, float w0, bf16* __restrict__ act,
    bf16* __restrict__ hstash) {
  using Cl = ChainLayout<H>;
#pragma unroll 1
  for (int j0 = 0; j0 < Cl::NSL; j0 += Cl::NSU) {
#pragma unroll
    for (int j = 0; j < Cl::NSU; ++j) {
      const int s = t.g0 + (j0 + j) * Cl::RG;
      float h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = s * 8 + e;
        const float a = layer0_pre(x + t.xrow(r) * Cin, w0k, b0, Cin, H, t.c);
        h[e] = sin_poly(__fmul_rn(w0, __fadd_rn(__fmul_rn(g, a), bt)));
        h[e] = r < t.nrows ? h[e] : 0.0f;
      }
      Pack8 hp;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(h[2 * q], h[2 * q + 1]);
        hp.w[q] = word(h2);
        act[act_at(s * 8 + 2 * q, t.c)] = h2.x;
        act[act_at(s * 8 + 2 * q + 1, t.c)] = h2.y;
      }
      if (kStash) *slab_at<H>(hstash, t.slab0 + s, t.c) = hp.vec();
    }
  }
}

// Layer i ≥ 1 of the forward, after its product (in st): a_i =
// bf16(bf16(product) + b_i); unless kLast, h_{i+1} = sin(w0·FiLM(a_i)),
// FiLM in bf16, into act. With kStash (the backward's recompute) a_i also
// goes to its stash slot and h_{i+1} to the next. The bf16 steps run on
// pairs of rows (bf16x2 instructions, each rounded once to nearest, as the
// plain version's bf16 ops round), so the product is converted once and
// the f32 sine's result once per pair.
template <int H, bool kLast, bool kStash>
__device__ __forceinline__ void recompute_layer(
    const Tile& t, const float* __restrict__ st, float bb, float g, float bt,
    float w0, bf16* __restrict__ act, bf16* __restrict__ a_slot,
    bf16* __restrict__ h_slot) {
  using Cl = ChainLayout<H>;
  const __nv_bfloat162 bb2 = __float2bfloat162_rn(bb);
  const __nv_bfloat162 g2 = __float2bfloat162_rn(g);
  const __nv_bfloat162 bt2 = __float2bfloat162_rn(bt);
#pragma unroll 1
  for (int j0 = 0; j0 < Cl::NSL; j0 += Cl::NSU) {
    float sv[Cl::NSU][8];  // every load before the first store
#pragma unroll
    for (int j = 0; j < Cl::NSU; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sv[j][e] = st[((t.g0 + (j0 + j) * Cl::RG) * 8 + e) * Cl::SP + t.c];
#pragma unroll
    for (int j = 0; j < Cl::NSU; ++j) {
      const int s = t.g0 + (j0 + j) * Cl::RG;
      Pack8 ap, hp;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 a2 = __hadd2_rn(
            __floats2bfloat162_rn(sv[j][2 * q], sv[j][2 * q + 1]), bb2);
        ap.w[q] = word(a2);
        if (!kLast) {
          const float2 f = __bfloat1622float2(
              __hadd2_rn(__hmul2_rn(g2, a2), bt2));
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(
              sin_poly(__fmul_rn(w0, f.x)), sin_poly(__fmul_rn(w0, f.y)));
          hp.w[q] = word(h2);
          act[act_at(s * 8 + 2 * q, t.c)] = h2.x;
          act[act_at(s * 8 + 2 * q + 1, t.c)] = h2.y;
        }
      }
      if (kStash) *slab_at<H>(a_slot, t.slab0 + s, t.c) = ap.vec();
      if (kStash && !kLast) *slab_at<H>(h_slot, t.slab0 + s, t.c) = hp.vec();
    }
  }
}

// grid (n_chunks, B), n_chunks = ceil(M / rows_per_block): block (chunk, b)
// takes rows [chunk·rows_per_block, ...) of sample b, 64 at a time, up to
// M, and writes their (·, H) bf16 outputs. wpack: the packed weights
// (pack_weights in ops/cuda/siren_trunk.py); only its first L−1 matrices
// are read.
template <int H>
__global__ void __launch_bounds__(kCThreads, 1)
trunk_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w0k,
                 const bf16* __restrict__ wpack,
                 const float* __restrict__ bias,
                 const float* __restrict__ gam, const float* __restrict__ bet,
                 bf16* __restrict__ out, int M, int Cin, int L, int n_film,
                 int rows_per_block, W0s w0s) {
  using Cl = ChainLayout<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  bf16* act = reinterpret_cast<bf16*>(smem + Cl::kActOff);
  float* st = reinterpret_cast<float*>(smem + Cl::kProdOff);
  const Ring rg{smem + Cl::kRingOff, bars, bars + kRingStages};

  const int tid = threadIdx.x, b = blockIdx.y;
  const int c = tid % H;
  auto film = [&](const float* rows, int i, float none) {
    return i < n_film ? rows[((size_t)b * n_film + i) * H + c] : none;
  };

  const int first = blockIdx.x * rows_per_block;
  const int last = min(M, first + rows_per_block);
  const int per_tile = L - 1;
  const int total = (last - first + kCTM - 1) / kCTM * per_tile * Cl::KCH;
  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&rg.full[s], 1);
      mbar_init(&rg.empty[s], kCThreads / 32);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int q = 0; q < min(kRingStages, total); ++q)
      ring_issue<H>(rg, wpack, q, L, per_tile);
  }
  int q = 0;  // chunks consumed

  for (int row0 = first; row0 < last; row0 += kCTM) {
    const Tile t{0, (size_t)b * M + row0, min(kCTM, M - row0), c, tid / H};
    recompute_layer0<H, false>(t, x, w0k, bias[c], Cin, film(gam, 0, 1.0f),
                               film(bet, 0, 0.0f), w0s.v[0], act, nullptr);
    for (int i = 1; i < L; ++i) {
      ring_product<H>(act, st, rg, wpack, q, total, L, per_tile, tid);
      const float bb = bfr(bias[i * H + c]);
      const float g = bfr(film(gam, i, 1.0f)), bt = bfr(film(bet, i, 0.0f));
      recompute_layer<H, false, false>(t, st, bb, g, bt, w0s.v[i], act,
                                       nullptr, nullptr);
    }
    __syncthreads();  // act holds the last layer's output
    // 8 columns of a row are 16 contiguous bytes of act: one vector each
    for (int v = tid; v < t.nrows * (H / 8); v += kCThreads) {
      const int r = v / (H / 8), k = (v % (H / 8)) * 8;
      *reinterpret_cast<uint4*>(out + (t.xrow0 + r) * H + k) =
          *reinterpret_cast<const uint4*>(act + act_at(r, k));
    }
    __syncthreads();  // act is rewritten by the next tile
  }
}

// Column sums of one layer of the walk back.
struct Sums {
  float db = 0.0f, dg = 0.0f, dbt = 0.0f;
};

// Layer i ≥ 1 of the walk back, dh_i in st: da_i = w0·dsin(w0·f)·dh·γ, with
// f from the stashed a_i; da_i (bf16) overwrites a_i in the stash and goes
// to act for the product that passes it down.
template <int H>
__device__ __forceinline__ void walk_layer(const Tile& t,
                                           const float* __restrict__ st,
                                           float g, float bt, float w0,
                                           bf16* __restrict__ act,
                                           bf16* __restrict__ ad_slot,
                                           Sums& sum) {
  using Cl = ChainLayout<H>;
#pragma unroll 1
  for (int j0 = 0; j0 < Cl::NSL; j0 += Cl::NSU) {
    uint4 av[Cl::NSU];  // NSU slabs of a_i at once: one wait for them all
    float sv[Cl::NSU][8];
#pragma unroll
    for (int j = 0; j < Cl::NSU; ++j) {
      av[j] = *slab_at<H>(ad_slot, t.slab0 + t.g0 + (j0 + j) * Cl::RG, t.c);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sv[j][e] = st[((t.g0 + (j0 + j) * Cl::RG) * 8 + e) * Cl::SP + t.c];
    }
#pragma unroll
    for (int j = 0; j < Cl::NSU; ++j) {
      const int s = t.g0 + (j0 + j) * Cl::RG;
      Pack8 dp;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = s * 8 + e;
        const float a = unpack8(av[j], e);
        const float f = __fadd_rn(__fmul_rn(g, a), bt);
        const float ds = dsin_poly(__fmul_rn(w0, f));
        const float df = __fmul_rn(__fmul_rn(sv[j][e], ds), w0);
        sum.dg += df * a;
        sum.dbt += df;
        const float da = __fmul_rn(df, g);
        sum.db += da;
        const bf16 db16 = __float2bfloat16(da);
        dp.set(e, db16);
        act[act_at(r, t.c)] = db16;
      }
      *slab_at<H>(ad_slot, t.slab0 + s, t.c) = dp.vec();
    }
  }
}

// Layer 0 of the walk back: a_0 recomputed in f32 from x; da_0 (f32) goes
// to st, for dx and dW0.
template <int H>
__device__ __forceinline__ void walk_layer0(const Tile& t, float* st,
                                            const float* __restrict__ x,
                                            const float* __restrict__ w0k,
                                            float b0, int Cin, float g,
                                            float bt, float w0, Sums& sum) {
  using Cl = ChainLayout<H>;
#pragma unroll 1
  for (int j0 = 0; j0 < Cl::NSL; j0 += Cl::NSU) {
#pragma unroll
    for (int j = 0; j < Cl::NSU; ++j) {
      const int s = t.g0 + (j0 + j) * Cl::RG;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = s * 8 + e;
        const float* xr = x + t.xrow(r) * Cin;
        const float a = layer0_pre(xr, w0k, b0, Cin, H, t.c);
        const float f = __fadd_rn(__fmul_rn(g, a), bt);
        const float ds = dsin_poly(__fmul_rn(w0, f));
        const float df = __fmul_rn(__fmul_rn(st[r * Cl::SP + t.c], ds), w0);
        sum.dg += df * a;
        sum.dbt += df;
        const float da = __fmul_rn(df, g);
        sum.db += da;
        st[r * Cl::SP + t.c] = da;
      }
    }
  }
}

// grid (n_chunks, B): block (chunk, b) takes rows [chunk·rows_per_block, ...)
// of sample b, 64 at a time, up to Mp. Writes dx, the stashes (h_i, then a_i
// overwritten by da_i) and one column-sum partial per block:
// part[(b·n_chunks + chunk)][slot][H]. wpack: the packed weights
// (pack_weights in ops/cuda/siren_trunk.py).
template <int H>
__global__ void __launch_bounds__(kCThreads, 1)
trunk_bwd_chain_kernel(const float* __restrict__ x,
                       const float* __restrict__ w0k,
                       const bf16* __restrict__ wpack,
                       const float* __restrict__ bias,
                       const float* __restrict__ gam,
                       const float* __restrict__ bet,
                       const bf16* __restrict__ dy, float* __restrict__ dx,
                       bf16* __restrict__ hstash, bf16* __restrict__ adstash,
                       float* __restrict__ part, int M, int Cin, int L,
                       int n_film, int rows_per_block, W0s w0s) {
  using Cl = ChainLayout<H>;
  constexpr int SP = Cl::SP, NSL = Cl::NSL, RG = Cl::RG;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  bf16* act = reinterpret_cast<bf16*>(smem + Cl::kActOff);
  float* st = reinterpret_cast<float*>(smem + Cl::kProdOff);
  float* red = reinterpret_cast<float*>(smem + Cl::kRedOff);  // [sum][tid]
  const Ring rg{smem + Cl::kRingOff, bars, bars + kRingStages};

  const Slots sl{L, n_film};
  const int nslot = sl.count(Cin);
  const int tid = threadIdx.x, b = blockIdx.y;
  const int c = tid % H;
  const int Mp = padded_rows(M);
  const size_t R = (size_t)gridDim.y * Mp;  // stash rows of the whole batch
  // The block's column sums accumulate in its partial, each column's by
  // the thread of row group 0 (one writer, a fixed order: deterministic).
  float* p = part + ((size_t)b * gridDim.x + blockIdx.x) * nslot * H;
  if (tid < H) {
    for (int s = 0; s < nslot; ++s) p[s * H + c] = 0.0f;
  }
  // FiLM row i of the sample, γ = 1 and β = 0 past n_film
  auto film = [&](const float* rows, int i, float none) {
    return i < n_film ? rows[((size_t)b * n_film + i) * H + c] : none;
  };

  const int first = blockIdx.x * rows_per_block;
  const int last = min(Mp, first + rows_per_block);
  const int per_tile = 2 * (L - 1);
  const int total = (last - first) / kCTM * per_tile * Cl::KCH;
  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&rg.full[s], 1);
      mbar_init(&rg.empty[s], kCThreads / 32);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int q = 0; q < min(kRingStages, total); ++q)
      ring_issue<H>(rg, wpack, q, L, per_tile);
  }
  int q = 0;  // chunks consumed

  for (int row0 = first; row0 < last; row0 += kCTM) {
    const Tile t{((size_t)b * Mp + row0) / 8, (size_t)b * M + row0,
                 max(0, min(kCTM, M - row0)), c, tid / H};

    // ---- recompute the forward, stashing h_i (i ≥ 1) and a_i (i ≥ 1)
    recompute_layer0<H, true>(t, x, w0k, bias[c], Cin, film(gam, 0, 1.0f),
                              film(bet, 0, 0.0f), w0s.v[0], act, hstash);
    for (int i = 1; i < L; ++i) {
      ring_product<H>(act, st, rg, wpack, q, total, L, per_tile, tid);
      const float bb = bfr(bias[i * H + c]);
      const float g = bfr(film(gam, i, 1.0f)), bt = bfr(film(bet, i, 0.0f));
      bf16* a_slot = adstash + (size_t)(i - 1) * R * H;
      if (i == L - 1) {  // the walk back needs no output
        recompute_layer<H, true, true>(t, st, bb, g, bt, w0s.v[i], act,
                                       a_slot, nullptr);
      } else {
        recompute_layer<H, false, true>(t, st, bb, g, bt, w0s.v[i], act,
                                        a_slot, hstash + (size_t)i * R * H);
      }
    }

    // ---- walk back; dh (f32) lives in st, 0 in the rows past M. Each
    // thread touches only its own (r, c) elements between the products,
    // which end in a barrier.
    for (int j = 0; j < NSL; ++j) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = (t.g0 + j * RG) * 8 + e;
        const float v = __bfloat162float(dy[t.xrow(r) * H + c]);
        st[r * SP + c] = r < t.nrows ? v : 0.0f;
      }
    }
    for (int i = L - 1; i >= 0; --i) {
      const float g = film(gam, i, 1.0f), bt = film(bet, i, 0.0f);
      Sums sum;
      if (i > 0) {
        walk_layer<H>(t, st, g, bt, w0s.v[i], act,
                      adstash + (size_t)(i - 1) * R * H, sum);
      } else {
        walk_layer0<H>(t, st, x, w0k, bias[c], Cin, g, bt, w0s.v[0], sum);
      }
      // hand this layer's sums to row group 0, which adds them up in order
      red[0 * kCThreads + tid] = sum.db;
      red[1 * kCThreads + tid] = sum.dg;
      red[2 * kCThreads + tid] = sum.dbt;
      __syncthreads();
      if (tid < H) {
        auto fold = [&](int k) {
          float v = 0.0f;
          for (int grp = 0; grp < RG; ++grp) {
            v += red[k * kCThreads + grp * H + c];
          }
          return v;
        };
        p[sl.db(i) * H + c] += fold(0);
        if (i < n_film) {
          p[sl.dg(i) * H + c] += fold(1);
          p[sl.dbt(i) * H + c] += fold(2);
        }
      }
      if (i > 0) {
        ring_product<H>(act, st, rg, wpack, q, total, L, per_tile, tid);
      }
    }
    // From da_0 (f32, in st): dx = da_0 · W0ᵀ, and the tile's dW0 = xᵀ·da_0
    // added to the block's partial. Each element is one thread's, summed
    // over the tile's rows in order, so any Cin takes the same code and the
    // result is the same every call.
    __syncthreads();
    for (int e = tid; e < t.nrows * Cin; e += kCThreads) {
      const int r = e / Cin, k = e % Cin;
      float s = 0.0f;
      for (int j = 0; j < H; ++j) s += st[r * SP + j] * w0k[k * H + j];
      dx[(t.xrow0 + r) * Cin + k] = s;
    }
    for (int e = tid; e < Cin * H; e += kCThreads) {
      const int k = e / H, col = e % H;
      const float* xk = x + t.xrow0 * Cin + k;
      float s = 0.0f;
      for (int r = 0; r < t.nrows; ++r) {
        s = __fmaf_rn(xk[(size_t)r * Cin], st[r * SP + col], s);
      }
      p[sl.dw0(k) * H + col] += s;
    }
    __syncthreads();  // st and act are reused by the next tile
  }
}

// The weight gradient's shared memory: a ring of kDwStages k-steps, each
// the 64-row blocks of both stashes (hᵀ's MT columns, all of daᵀ).
constexpr int kDwStages = 4;

template <int H>
struct DwLayout {
  static constexpr int NWG = H >= 128 ? 2 : 1;  // warpgroups, 64 dW rows each
  static constexpr int kThreads = NWG * 128;
  static constexpr int MT = 64 * NWG;           // dW rows of a block
  static constexpr int kABytes = kStepRows * MT * 2;
  static constexpr int kBBytes = kStepRows * H * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBarBytes = 128;
  static constexpr int kBytes = kBarBytes + kDwStages * kStageBytes;
};

// Thread 0 issues k-step q of the block's range into stage q % kDwStages,
// once the stage's last readers have released it.
template <int H>
__device__ __forceinline__ void dw_issue(unsigned char* ring, uint64_t* full,
                                         uint64_t* empty, const bf16* hsrc,
                                         const bf16* dsrc, size_t step,
                                         int q, int m0) {
  using Dl = DwLayout<H>;
  const int stage = q % kDwStages;
  if (q >= kDwStages) mbar_wait(&empty[stage], (q / kDwStages - 1) & 1);
  unsigned char* a = ring + stage * Dl::kStageBytes;
  mbar_expect_tx(&full[stage], Dl::kStageBytes);
  const size_t slab = step * (kStepRows / 8);
#pragma unroll
  for (int k1 = 0; k1 < kStepRows / 8; ++k1) {  // hᵀ: MT columns of 8 slabs
    bulk_g2s(a + k1 * Dl::MT * 16, hsrc + ((slab + k1) * H + m0) * 8,
             Dl::MT * 16, &full[stage]);
  }
  bulk_g2s(a + Dl::kABytes, dsrc + slab * H * 8, Dl::kBBytes, &full[stage]);
}

// dWmid_i partial over one range of k-steps: rows [m0, m0 + MT) of
// h_iᵀ · da_i, all H columns. grid (H / MT, n_split, L−1). Warpgroup w
// multiplies dW rows m0 + 64w.. by all H columns, f32 accumulators in
// registers, with one m64nHk16 wgmma per 16 stash rows. Writes
// part2[(i·n_split + split)][H][H].
template <int H>
__global__ void __launch_bounds__(DwLayout<H>::kThreads, 1)
trunk_bwd_dw_kernel(const bf16* __restrict__ hstash,
                    const bf16* __restrict__ adstash,
                    float* __restrict__ part2, int n_steps,
                    int steps_per_split) {
  using Dl = DwLayout<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kDwStages;
  unsigned char* ring = smem + Dl::kBarBytes;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int m0 = blockIdx.x * Dl::MT, layer = blockIdx.z;
  const size_t R = (size_t)n_steps * kStepRows;
  const bf16* hsrc = hstash + (size_t)layer * R * H;
  const bf16* dsrc = adstash + (size_t)layer * R * H;
  const int t0 = blockIdx.y * steps_per_split;
  const int nt = max(0, min(n_steps, t0 + steps_per_split) - t0);
  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Dl::kThreads / 32);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int q = 0; q < min(nt, kDwStages); ++q)
      dw_issue<H>(ring, full, empty, hsrc, dsrc, t0 + q, q, m0);
  }

  float acc[H / 2];
#pragma unroll
  for (int k = 0; k < H / 2; ++k) acc[k] = 0.0f;
  for (int q = 0; q < nt; ++q) {
    const int stage = q % kDwStages;
    mbar_wait(&full[stage], (q / kDwStages) & 1);
    __syncwarp();
    const unsigned char* a = ring + stage * Dl::kStageBytes + wg * 64 * 16;
    const unsigned char* bm = ring + stage * Dl::kStageBytes + Dl::kABytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kStepRows / 16; ++kk) {
      Wgmma<H>::mma(acc, smem_desc(a + kk * 2 * Dl::MT * 16, Dl::MT * 16, 128),
                    smem_desc(bm + kk * 2 * H * 16, H * 16, 128), 1);
    }
    wg_commit();
    wg_wait_all();
    acc_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (tid == 0 && q + kDwStages < nt)
      dw_issue<H>(ring, full, empty, hsrc, dsrc, t0 + q + kDwStages,
                  q + kDwStages, m0);
  }

  float* out = part2 + ((size_t)layer * gridDim.y + blockIdx.y) * H * H;
  const int row = m0 + wg * 64 + ((tid / 32) % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(out + (size_t)row * H + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(row + 8) * H + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// dWmid[e] = Σ_split part2[layer][split][e] over (L−1)·H·H elements.
__global__ void trunk_bwd_sum_dw_kernel(const float* __restrict__ part2,
                                        float* __restrict__ dwm, int HH,
                                        int n_split, int n_layers) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)HH * n_layers) return;
  const size_t layer = e / HH, j = e % HH;
  const float* p = part2 + layer * n_split * HH + j;
  float v = 0.0f;
  for (int s = 0; s < n_split; ++s) v += p[(size_t)s * HH];
  dwm[e] = v;
}

// Per sample: ps[b][slot][c] = Σ_chunk part[b][chunk][slot][c]; dγ and dβ
// are final there, db and dW0 still sum over b.
__global__ void trunk_bwd_sum_chunks_kernel(const float* __restrict__ part,
                                            float* __restrict__ ps,
                                            float* __restrict__ dg,
                                            float* __restrict__ dbt, int B,
                                            int n_chunks, int nslot, int H,
                                            int L, int n_film) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_b = (size_t)nslot * H;
  if (e >= per_b * B) return;
  const size_t b = e / per_b, j = e % per_b;
  const int s = static_cast<int>(j / H), c = static_cast<int>(j % H);
  const float* p = part + b * n_chunks * per_b + j;
  float v = 0.0f;
  for (int k = 0; k < n_chunks; ++k) v += p[(size_t)k * per_b];
  ps[e] = v;
  if (s >= L && s < L + n_film) {
    dg[(b * n_film + (s - L)) * H + c] = v;
  } else if (s >= L + n_film && s < L + 2 * n_film) {
    dbt[(b * n_film + (s - L - n_film)) * H + c] = v;
  }
}

// db[i][c] and dW0[k][c]: Σ_b ps[b][slot][c].
__global__ void trunk_bwd_sum_batch_kernel(const float* __restrict__ ps,
                                           float* __restrict__ db,
                                           float* __restrict__ dw0, int B,
                                           int nslot, int H, int L,
                                           int n_film, int Cin) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (L + Cin) * H) return;
  const int q = e / H, c = e % H;
  const int s = q < L ? q : L + 2 * n_film + (q - L);
  float v = 0.0f;
  for (int b = 0; b < B; ++b) v += ps[((size_t)b * nslot + s) * H + c];
  if (q < L) {
    db[q * H + c] = v;
  } else {
    dw0[(q - L) * H + c] = v;
  }
}

bool shape_ok(int B, int M, int Cin, int H, int L, int n_film) {
  return B > 0 && B <= 65535 && M >= 0 && Cin >= 1 && Cin <= kMaxCin &&
         (H == 64 || H == 128 || H == 256) && L >= 2 && L <= kMaxL &&
         n_film >= 0 && n_film <= L;
}

W0s pack_w0s(const float* w0s, int L) {
  W0s p{};
  for (int i = 0; i < L; ++i) p.v[i] = w0s[i];
  return p;
}

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can use

template <int H>
cudaError_t launch_fwd(const float* x, const float* w0k, const bf16* wpack,
                       const float* bias, const float* gam, const float* bet,
                       bf16* out, int B, int M, int Cin, int L, int n_film,
                       int rows_per_block, W0s w0s, cudaStream_t stream) {
  constexpr int bytes = ChainLayout<H>::kBytes;
  static_assert(bytes <= kMaxSmem, "the forward's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      trunk_fwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + rows_per_block - 1) / rows_per_block, B);
  trunk_fwd_kernel<H><<<grid, kCThreads, bytes, stream>>>(
      x, w0k, wpack, bias, gam, bet, out, M, Cin, L, n_film, rows_per_block,
      w0s);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_bwd(const float* x, const float* w0k, const bf16* wpack,
                       const float* bias, const float* gam, const float* bet,
                       const bf16* dy, float* dx, float* dw0, float* dwm,
                       float* db, float* dg, float* dbt, bf16* hstash,
                       bf16* adstash, float* part, float* part2, float* ps,
                       int B, int M, int Cin, int L, int n_film,
                       int rows_per_block, int n_split, W0s w0s,
                       cudaStream_t stream) {
  const Slots sl{L, n_film};
  const int nslot = sl.count(Cin);
  using Cl = ChainLayout<H>;
  constexpr int bytes = Cl::kBytes;
  static_assert(bytes <= kMaxSmem, "the chain kernel's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_chain_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int n_chunks = (M + rows_per_block - 1) / rows_per_block;
  trunk_bwd_chain_kernel<H><<<dim3(n_chunks, B), kCThreads, bytes, stream>>>(
      x, w0k, wpack, bias, gam, bet, dy, dx, hstash, adstash, part, M, Cin, L,
      n_film, rows_per_block, w0s);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  using Dl = DwLayout<H>;
  const int n_steps = B * (padded_rows(M) / kStepRows);
  const int steps_per_split = (n_steps + n_split - 1) / n_split;
  err = cudaFuncSetAttribute(trunk_bwd_dw_kernel<H>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Dl::kBytes);
  if (err != cudaSuccess) return err;
  trunk_bwd_dw_kernel<H><<<dim3(H / Dl::MT, n_split, L - 1), Dl::kThreads,
                           Dl::kBytes, stream>>>(hstash, adstash, part2,
                                                 n_steps, steps_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int HH = H * H;
  trunk_bwd_sum_dw_kernel<<<(HH * (L - 1) + 255) / 256, 256, 0, stream>>>(
      part2, dwm, HH, n_split, L - 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t n_ps = (size_t)B * nslot * H;
  trunk_bwd_sum_chunks_kernel<<<(unsigned)((n_ps + 255) / 256), 256, 0,
                                stream>>>(part, ps, dg, dbt, B, n_chunks,
                                          nslot, H, L, n_film);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  trunk_bwd_sum_batch_kernel<<<((L + Cin) * H + 255) / 256, 256, 0, stream>>>(
      ps, db, dw0, B, nslot, H, L, n_film, Cin);
  return cudaGetLastError();
}

}  // namespace

// wpack: the middle weights packed for the ring (pack_weights in
// ops/cuda/siren_trunk.py; the first L−1 of its matrices are read).
// rows_per_block must be a positive multiple of 64.
extern "C" int lgzt_siren_trunk_fwd(const float* x, const float* w0k,
                                    const void* wpack, const float* bias,
                                    const float* gam, const float* bet,
                                    void* out, int B, int M, int Cin, int H,
                                    int L, int n_film, int rows_per_block,
                                    const float* w0s, void* stream) {
  if (!shape_ok(B, M, Cin, H, L, n_film) || rows_per_block <= 0 ||
      rows_per_block % kCTM != 0) {
    return cudaErrorInvalidValue;
  }
  if (M == 0) return static_cast<int>(cudaGetLastError());
  const W0s p = pack_w0s(w0s, L);
  const auto* wp = static_cast<const bf16*>(wpack);
  auto* o = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (H) {
    case 64: err = launch_fwd<64>(x, w0k, wp, bias, gam, bet, o, B, M, Cin, L, n_film, rows_per_block, p, s); break;
    case 128: err = launch_fwd<128>(x, w0k, wp, bias, gam, bet, o, B, M, Cin, L, n_film, rows_per_block, p, s); break;
    default: err = launch_fwd<256>(x, w0k, wp, bias, gam, bet, o, B, M, Cin, L, n_film, rows_per_block, p, s); break;
  }
  return static_cast<int>(err);
}

// wpack: the middle weights packed for the ring (pack_weights in
// ops/cuda/siren_trunk.py: 2·(L−1) bf16 matrices of H×H). Scratch the
// caller allocates (Mp = M rounded up to a multiple of 64, R = B·Mp,
// n_chunks = ceil(M / rows_per_block), nslot = L + 2·n_film + Cin): hstash
// and adstash (L−1)·R·H bf16 (slot j holds layer j+1's input and
// pre-activation, in the slab layout above), part B·n_chunks·nslot·H f32,
// part2 (L−1)·n_split·H·H f32, ps B·nslot·H f32. rows_per_block must be a
// positive multiple of 64.
extern "C" int lgzt_siren_trunk_bwd(
    const float* x, const float* w0k, const void* wpack, const float* bias,
    const float* gam, const float* bet, const void* dy, float* dx, float* dw0,
    float* dwm, float* db, float* dg, float* dbt, void* hstash, void* adstash,
    float* part, float* part2, float* ps, int B, int M, int Cin, int H, int L,
    int n_film, int rows_per_block, int n_split, const float* w0s,
    void* stream) {
  if (!shape_ok(B, M, Cin, H, L, n_film) || M == 0 || rows_per_block <= 0 ||
      rows_per_block % kStepRows != 0 || n_split <= 0 ||
      (long long)B * padded_rows(M) > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const W0s p = pack_w0s(w0s, L);
  const auto* wm = static_cast<const bf16*>(wpack);
  const auto* d = static_cast<const bf16*>(dy);
  auto* hst = static_cast<bf16*>(hstash);
  auto* ads = static_cast<bf16*>(adstash);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (H) {
    case 64: err = launch_bwd<64>(x, w0k, wm, bias, gam, bet, d, dx, dw0, dwm, db, dg, dbt, hst, ads, part, part2, ps, B, M, Cin, L, n_film, rows_per_block, n_split, p, s); break;
    case 128: err = launch_bwd<128>(x, w0k, wm, bias, gam, bet, d, dx, dw0, dwm, db, dg, dbt, hst, ads, part, part2, ps, B, M, Cin, L, n_film, rows_per_block, n_split, p, s); break;
    default: err = launch_bwd<256>(x, w0k, wm, bias, gam, bet, d, dx, dw0, dwm, db, dg, dbt, hst, ads, part, part2, ps, B, M, Cin, L, n_film, rows_per_block, n_split, p, s); break;
  }
  return static_cast<int>(err);
}
