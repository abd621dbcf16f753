// The radiance field's rgb/α head, forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA's
// fusion. On the port's eager path it was ~20 memory-bound passes over the
// trunk's (B·M, 256) features per field evaluation, and its autograd ~35
// more, 35–40 % of π-GAN's card time; these kernels run it in one pass each
// way. The head (nerf/siren.py): [features x ‖ view direction d] → the FiLM
// sine layer h = sin(w0·(γ·([x ‖ d]·W + b) + β)) → rgb = σ(h·W_rgbᵀ +
// b_rgb), and, where the field has one on the same features, α = σ(x·w_αᵀ
// + b_α).
//
// Numerics are the plain version's (ops/siren_head.py), the eager bf16
// policy: the product's f32 sums rounded to bf16, the bf16 bias added in
// bf16, FiLM in bf16 (γ·a rounded, then + β rounded), the sine argument in
// f32 through fast_sin's polynomial, h rounded to bf16; rgb and α as an
// autocast linear computes them (bf16 operands, f32 sums, the bf16 bias
// added before the one rounding), the sigmoids as PyTorch's, in f32 rounded
// to bf16. The backward follows the trunk backward's rule (f32 FiLM and the
// polynomial's own derivative; bf16 operands with f32 sums in every
// product).
//
// What bounds it on this card. Per row the head reads H bf16 features and
// writes four outputs; its product is (H+3)×H bf16 MACs. At π-GAN's fine
// pass (1,048,576 rows, H = 256) that is 0.54 GB against 139 GFLOP: 0.16 ms
// by bytes, 0.14 ms by the tensor cores, and ~0.2 ms by the FP32 pipe for
// the FiLM and sine (~25 operations an element). The backward's least is
// ~0.42 ms, by the tensor cores (the product three times); as built it also
// writes a bf16 da stash that the weight gradient reads twice, ~3.2 GB in
// all with the features and dx, ~1 ms by bytes.
//
// The forward, `siren_head_fwd_kernel`: grid (n_chunks, B); a block walks
// 64-row tiles of one sample (so γ, β and the per-column constants sit in
// shared memory for the block's life) with W, packed once per call as the
// wgmma B operand (K padded to H+16: the 3 direction rows and zeros), held
// whole in shared memory after one set of bulk copies. The feature tiles
// come through a 2-stage cp.async ring into the K-major core-matrix layout
// wgmma reads; the directions' 16 columns are written by threads from the
// per-ray (B, N, 3) array. Four warpgroups multiply the tile by a quarter of
// W's columns each (m64nNk16, f32 accumulators in registers); the epilogue
// runs on the accumulators in registers: bias, FiLM, sine, and the rgb dot
// products reduced over the 4 lanes of a row and the 4 warpgroups; α's dot
// product reads the tile while the wgmma runs. No (M, H) intermediate
// touches device memory.
// M need not be whole tiles: a sample's last tile reads its last row in
// place of the rows past M and writes nothing for them; the backward gives
// those rows a zero cotangent, and the weight gradient's last step reads
// zeros past the last row.
//
// The backward (four kernels, one call):
//   1. `siren_head_bwd_kernel`: per tile, recompute the product (the
//      forward's wgmma) into a bf16 tile in shared memory, then one thread
//      per column walks the tile's rows: FiLM, the sine and its derivative,
//      dh = g_rgb·W_rgb, da = w0·dh·sin′·γ, and the column sums (db, dγ,
//      dβ, dW_rgb, the directions' rows of dW, dw_α) in registers for the
//      block's life. bf16(da) overwrites the feature tile, where a second
//      wgmma takes it as A against W's pack read transposed: dx = da·W_xᵀ
//      (+ g_α ⊗ w_α in the same tile, so the two gradients of the features
//      are one output) and the directions' gradient da·W_dᵀ. da also goes
//      to a row-major stash for the weight gradient.
//   2. `siren_head_bwd_dw_kernel`: dW_x = xᵀ·da over all rows, a split-K
//      wgmma GEMM reading the features and the stash row-major (both
//      operands N/M-major), fed by a 4-stage cp.async ring.
//   3. `siren_head_bwd_sum_kernel` and `siren_head_bwd_dw_sum_kernel` add
//      the partials in a fixed order.
// No atomics: both directions are deterministic run to run.
//
// Plain C interface, loaded with ctypes: each function launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take).

#include "hopper_common.cuh"

namespace {

// PyTorch's sigmoid of a bf16 value, computed in f32 and rounded to bf16
__device__ __forceinline__ bf16 sigmoid16(float v) {
  return __float2bfloat16(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v))));
}

// ---------------------------------------------------------------------------
// The tile. 64 rows of [x ‖ d], K-major 8×8 core matrices: the 8 row groups
// of each 8-column group side by side (128 bytes apart), column groups kLbo
// bytes apart (16 more than 8 × 128, so that the 16-byte chunks a warp
// writes or reads along a row fall on distinct banks). Columns H..H+2 hold
// bf16(d), H+3..H+15 zeros: the product's K is H + 16.

constexpr int kTM = 64;           // rows per tile (one wgmma M)
constexpr int kThreads = 512;     // four warpgroups
constexpr int kWarpgroups = kThreads / 128;
constexpr int kLbo = 8 * 128 + 16;
// the backward's per-block column sums: db, dγ, dβ, dW_rgb (3), the
// directions' rows of dW (3), dw_α, and the scalars (db_rgb, db_α)
constexpr int kSlots = 11;
constexpr int kScalarSlot = 10;

__device__ __forceinline__ int tile_at(int r, int k) {  // byte offset
  return (k >> 3) * kLbo + (r >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

template <int H>
struct HeadLayout {
  static constexpr int KP = H + 16;                 // the product's K
  static constexpr int NW = H / kWarpgroups;        // columns of a warpgroup
  static constexpr int kWBytes = KP * H * 2;        // the packed W
  static constexpr int kTileBytes = (KP / 8) * kLbo;
  static constexpr int RG = kThreads / H;           // row groups of the column walk
  static constexpr int RPT = kTM / RG;              // its rows per thread
  static constexpr int SP = H + 8;                  // st row stride (bf16)
  // forward: mbarrier | b, γ, β (bf16) | W_rgb (3 × H), w_α (f32) |
  // rgb partials [warpgroup][row][3] | W | two tiles
  static constexpr int kFConst = 128;
  static constexpr int kFRed = kFConst + 3 * H * 2 + 4 * H * 4;
  static constexpr int kFW = kFRed + kWarpgroups * kTM * 3 * 4;
  static constexpr int kFX = kFW + kWBytes;
  static constexpr int kFBytes = kFX + 2 * kTileBytes;
  // backward: mbarrier | b, γ, β (bf16) | γ, β, W_rgb (3 × H), w_α (f32) |
  // per-row cotangents [row][4] and directions [row][4] | W | one tile |
  // st, the bf16 product tile (then dx, then the column sums' hand-over)
  static constexpr int kBConst = 128;
  static constexpr int kBRows = kBConst + 3 * H * 2 + 6 * H * 4;
  static constexpr int kBW = kBRows + 2 * kTM * 4 * 4;
  static constexpr int kBX = kBW + kWBytes;
  static constexpr int kBSt = kBX + kTileBytes;
  static constexpr int kStBytes = kTM * SP * 2 > kSlots * kThreads * 4
                                      ? kTM * SP * 2
                                      : kSlots * kThreads * 4;
  static constexpr int kBBytes = kBSt + kStBytes;
  static_assert(kFW % 128 == 0 && kBW % 128 == 0 && kBX % 16 == 0 &&
                    kBSt % 16 == 0,
                "shared-memory alignment");
};

// A tile's rows: the last tile of a sample may have fewer than 64 before
// M. Its rows past M read the sample's last row, so that every value in the
// tile is one the op computes, and nothing is written for them.
__device__ __forceinline__ int tile_rows(int M, int row0) {
  return min(kTM, M - row0);
}

// The block's 64×H feature rows from `row0` (the sample's first row at
// `rows_b`) into the tile, 16 bytes a thread-copy (a warp copies 512
// contiguous bytes of a row); `nrows` of them lie before M.
template <int H>
__device__ __forceinline__ void load_x_tile(unsigned char* xs,
                                            const bf16* __restrict__ x,
                                            size_t rows_b, int row0,
                                            int nrows, int tid) {
  constexpr int kCpr = H / 8;
#pragma unroll
  for (int q = tid; q < kTM * kCpr; q += kThreads) {
    const int r = q / kCpr, kg = q % kCpr;
    cp_async16(xs + tile_at(r, kg * 8),
               x + (rows_b + row0 + min(r, nrows - 1)) * H + kg * 8);
  }
}

// The tile's direction columns H..H+7 (bf16(d) of each row's ray, then
// zeros); with `dr` also each row's bf16(d) as f32.
template <int H>
__device__ __forceinline__ void put_dirs(unsigned char* xs,
                                         const float* __restrict__ dirs,
                                         size_t ray0, int row0, int nrows,
                                         int P, int tid, float* dr) {
  if (tid < kTM) {
    const float* d = dirs + (ray0 + (row0 + min(tid, nrows - 1)) / P) * 3;
    const __nv_bfloat162 d01 = __floats2bfloat162_rn(d[0], d[1]);
    const __nv_bfloat162 d2z = __floats2bfloat162_rn(d[2], 0.0f);
    *reinterpret_cast<uint4*>(xs + tile_at(tid, H)) =
        make_uint4(word(d01), word(d2z), 0u, 0u);
    if (dr != nullptr) {
      const float2 a = __bfloat1622float2(d01), c = __bfloat1622float2(d2z);
      dr[tid * 4 + 0] = a.x;
      dr[tid * 4 + 1] = a.y;
      dr[tid * 4 + 2] = c.x;
    }
  }
}

// Columns H+8..H+15 of a tile: zero, once for the kernel's life.
template <int H>
__device__ __forceinline__ void zero_pad(unsigned char* xs, int r) {
  *reinterpret_cast<uint4*>(xs + tile_at(r, H + 8)) = make_uint4(0, 0, 0, 0);
}

// Thread 0: the packed W into shared memory, completing on `bar`.
template <int H>
__device__ __forceinline__ void load_w(unsigned char* wsm,
                                       const bf16* __restrict__ wpack,
                                       uint64_t* bar) {
  constexpr int kBytes = HeadLayout<H>::kWBytes;
  mbar_expect_tx(bar, kBytes);
  const auto* src = reinterpret_cast<const unsigned char*>(wpack);
  for (int off = 0; off < kBytes; off += 32768) {
    bulk_g2s(wsm + off, src + off, min(32768, kBytes - off), bar);
  }
}

// acc (64 × NW, warpgroup wg's columns) = the tile · W: K = H + 16, W
// packed as the B operand (N × K, K-major: [k/8][n][k%8]).
template <int H>
__device__ __forceinline__ void head_product(
    float (&acc)[HeadLayout<H>::NW / 2], const unsigned char* xs,
    const unsigned char* wsm, int wg) {
  using Hl = HeadLayout<H>;
#pragma unroll
  for (int kk = 0; kk < Hl::KP / 16; ++kk) {
    Wgmma<Hl::NW, 0, 0>::mma(
        acc, smem_desc(xs + 2 * kk * kLbo, kLbo, 128),
        smem_desc(wsm + wg * Hl::NW * 16 + kk * 2 * H * 16, H * 16, 128),
        kk > 0);
  }
}

// grid (n_chunks, B): block (chunk, b) takes rows [chunk·rows_per_block,
// ...) of sample b, 64 at a time, up to M, and writes their rgb (·, 3)
// and, with w_α, α (·, 1), bf16. P: rows per ray.
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
siren_head_fwd_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ dirs,
                      const bf16* __restrict__ wpack,
                      const float* __restrict__ bias,
                      const float* __restrict__ gam,
                      const float* __restrict__ bet,
                      const float* __restrict__ wrgb,
                      const float* __restrict__ brgb,
                      const float* __restrict__ walpha,
                      const float* __restrict__ balpha,
                      bf16* __restrict__ rgb, bf16* __restrict__ alpha, int M,
                      int P, int rows_per_block, float w0) {
  using Hl = HeadLayout<H>;
  constexpr int NW = Hl::NW;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem);
  bf16* cb = reinterpret_cast<bf16*>(smem + Hl::kFConst);
  bf16* cg = cb + H;
  bf16* cbt = cg + H;
  float* cwr = reinterpret_cast<float*>(cbt + H);  // [3][H]
  float* cwa = cwr + 3 * H;
  float* red = reinterpret_cast<float*>(smem + Hl::kFRed);
  unsigned char* wsm = smem + Hl::kFW;
  unsigned char* xs0 = smem + Hl::kFX;

  const int tid = threadIdx.x, b = blockIdx.y;
  const int wg = tid / 128, lane = tid % 32;
  const int first = blockIdx.x * rows_per_block;
  const int n_tiles =
      (min(M, first + rows_per_block) - first + kTM - 1) / kTM;
  const size_t rows_b = (size_t)b * M;
  const size_t ray0 = (size_t)b * (M / P);
  const bool has_alpha = walpha != nullptr;

  if (tid == 0) {
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) load_w<H>(wsm, wpack, wbar);
  for (int c = tid; c < H; c += kThreads) {
    cb[c] = __float2bfloat16(bias[c]);
    cg[c] = __float2bfloat16(gam[(size_t)b * H + c]);
    cbt[c] = __float2bfloat16(bet[(size_t)b * H + c]);
    for (int k = 0; k < 3; ++k) cwr[k * H + c] = bfr(wrgb[k * H + c]);
    cwa[c] = has_alpha ? bfr(walpha[c]) : 0.0f;
  }
  if (tid < 2 * kTM) zero_pad<H>(xs0 + (tid / kTM) * Hl::kTileBytes, tid % kTM);
  if (n_tiles > 0) {
    load_x_tile<H>(xs0, x, rows_b, first, tile_rows(M, first), tid);
  }
  cp_async_commit();
  const float brgb16[3] = {bfr(brgb[0]), bfr(brgb[1]), bfr(brgb[2])};
  const float ba16 = has_alpha ? bfr(balpha[0]) : 0.0f;
  const int r0 = ((tid / 32) % 4) * 16 + lane / 4;  // the fragment's rows

  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int row0 = first + t * kTM, nrows = tile_rows(M, row0);
    unsigned char* xs = xs0 + (t & 1) * Hl::kTileBytes;
    if (t + 1 < n_tiles) {
      load_x_tile<H>(xs0 + ((t + 1) & 1) * Hl::kTileBytes, x, rows_b,
                     row0 + kTM, tile_rows(M, row0 + kTM), tid);
    }
    cp_async_commit();
    put_dirs<H>(xs, dirs, ray0, row0, nrows, P, tid, nullptr);
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();  // the tile complete; the previous tile's readers done
    if (t == 0) mbar_wait(wbar, 0);
    wg_fence();
    head_product<H>(acc, xs, wsm, wg);
    wg_commit();
    if (has_alpha) {  // α = σ(x·w_α + b_α) while the product runs: 8 threads a row
      const int r = tid >> 3, part = tid & 7;
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < H / 64; ++i) {
        const int kg = part + 8 * i;
        const uint4 v =
            *reinterpret_cast<const uint4*>(xs + tile_at(r, kg * 8));
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(unpack8(v, e), cwa[kg * 8 + e], s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (part == 0 && r < nrows) {
        alpha[rows_b + row0 + r] = sigmoid16(bfr(s + ba16));
      }
    }
    wg_wait_all();
    acc_fence(acc);

    // bias, FiLM and sine on the accumulators (pairs of columns in bf16x2),
    // and each row's partial rgb dot products
    float s[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int c = wg * NW + 8 * j + 2 * (lane % 4);
      const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(cb + c);
      const __nv_bfloat162 g2 = *reinterpret_cast<const __nv_bfloat162*>(cg + c);
      const __nv_bfloat162 t2 = *reinterpret_cast<const __nv_bfloat162*>(cbt + c);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const __nv_bfloat162 a2 = __hadd2_rn(
            __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]),
            b2);
        const float2 f = __bfloat1622float2(__hadd2_rn(__hmul2_rn(g2, a2), t2));
        const float2 h = __bfloat1622float2(__floats2bfloat162_rn(
            sin_poly(__fmul_rn(w0, f.x)), sin_poly(__fmul_rn(w0, f.y))));
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          s[hh][k] = fmaf(h.y, cwr[k * H + c + 1],
                          fmaf(h.x, cwr[k * H + c], s[hh][k]));
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s[hh][k] += __shfl_xor_sync(0xffffffffu, s[hh][k], 1);
        s[hh][k] += __shfl_xor_sync(0xffffffffu, s[hh][k], 2);
        if (lane % 4 == 0) red[(wg * kTM + r0 + 8 * hh) * 3 + k] = s[hh][k];
      }
    }
    __syncthreads();  // the partials complete; the tile's readers done
    if (tid < nrows) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarpgroups; ++w) v += red[(w * kTM + tid) * 3 + k];
        rgb[(rows_b + row0 + tid) * 3 + k] = sigmoid16(bfr(v + brgb16[k]));
      }
    }
  }
}

// grid (n_chunks, B), as the forward. Per tile: the rows' cotangents of the
// linears (the sigmoids' backward, rounded to bf16 as autograd rounds it;
// 0 for a row past M, so that it adds nothing to any gradient),
// the product recomputed into st (bf16), the column walk, then dx and the
// directions' gradient by a second product and the da stash. ddir (per row)
// may be null. part[(b·n_chunks + chunk)][kSlots][H]: the block's sums.
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
siren_head_bwd_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ dirs,
                      const bf16* __restrict__ wpack,
                      const float* __restrict__ bias,
                      const float* __restrict__ gam,
                      const float* __restrict__ bet,
                      const float* __restrict__ wrgb,
                      const float* __restrict__ walpha,
                      const bf16* __restrict__ rgb,
                      const bf16* __restrict__ alpha,
                      const bf16* __restrict__ grgb,
                      const bf16* __restrict__ galpha, bf16* __restrict__ dx,
                      float* __restrict__ ddir, bf16* __restrict__ dastash,
                      float* __restrict__ part, int M, int P,
                      int rows_per_block, float w0) {
  using Hl = HeadLayout<H>;
  constexpr int NW = Hl::NW, SP = Hl::SP;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem);
  bf16* cb = reinterpret_cast<bf16*>(smem + Hl::kBConst);
  bf16* cg = cb + H;
  bf16* cbt = cg + H;
  float* cgf = reinterpret_cast<float*>(cbt + H);
  float* cbtf = cgf + H;
  float* cwr = cbtf + H;  // [3][H]
  float* cwa = cwr + 3 * H;
  float* gl = reinterpret_cast<float*>(smem + Hl::kBRows);  // [row][4]
  float* dr = gl + kTM * 4;                                 // [row][4]
  unsigned char* wsm = smem + Hl::kBW;
  unsigned char* xs = smem + Hl::kBX;
  bf16* st = reinterpret_cast<bf16*>(smem + Hl::kBSt);

  const int tid = threadIdx.x, b = blockIdx.y;
  const int wg = tid / 128, lane = tid % 32;
  const int c = tid % H, g0 = tid / H;  // the column walk's column and rows
  const int first = blockIdx.x * rows_per_block;
  const int n_tiles =
      (min(M, first + rows_per_block) - first + kTM - 1) / kTM;
  const size_t rows_b = (size_t)b * M;
  const size_t ray0 = (size_t)b * (M / P);
  const bool has_alpha = walpha != nullptr;

  if (tid == 0) {
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) load_w<H>(wsm, wpack, wbar);
  for (int k = tid; k < H; k += kThreads) {
    cb[k] = __float2bfloat16(bias[k]);
    cgf[k] = gam[(size_t)b * H + k];
    cbtf[k] = bet[(size_t)b * H + k];
    cg[k] = __float2bfloat16(cgf[k]);
    cbt[k] = __float2bfloat16(cbtf[k]);
    for (int j = 0; j < 3; ++j) cwr[j * H + k] = bfr(wrgb[j * H + k]);
    cwa[k] = has_alpha ? bfr(walpha[k]) : 0.0f;
  }
  if (tid < kTM) {
    zero_pad<H>(xs, tid);
    gl[tid * 4 + 3] = 0.0f;
  }
  if (n_tiles > 0) {
    load_x_tile<H>(xs, x, rows_b, first, tile_rows(M, first), tid);
  }
  cp_async_commit();
  const int r0 = ((tid / 32) % 4) * 16 + lane / 4;  // the fragment's rows

  // the block's column sums (slots), each the thread's over its rows
  float s_db = 0.0f, s_dg = 0.0f, s_dbt = 0.0f, s_wa = 0.0f, s_scalar = 0.0f;
  float s_wr[3] = {0.0f, 0.0f, 0.0f}, s_wd[3] = {0.0f, 0.0f, 0.0f};
  float acc[NW / 2], accd[8];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) accd[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int row0 = first + t * kTM, nrows = tile_rows(M, row0);
    if (tid < kTM && tid >= nrows) {
      for (int k = 0; k < 4; ++k) gl[tid * 4 + k] = 0.0f;
    } else if (tid < kTM) {  // the linears' cotangents g·(1 − y)·y, in bf16
      const size_t row = rows_b + row0 + tid;
      for (int k = 0; k < 3; ++k) {
        const float y = __bfloat162float(rgb[row * 3 + k]);
        gl[tid * 4 + k] = bfr(__fmul_rn(
            __fmul_rn(__bfloat162float(grgb[row * 3 + k]), __fsub_rn(1.0f, y)),
            y));
      }
      if (has_alpha) {
        const float y = __bfloat162float(alpha[row]);
        gl[tid * 4 + 3] = bfr(__fmul_rn(
            __fmul_rn(__bfloat162float(galpha[row]), __fsub_rn(1.0f, y)), y));
      }
    }
    put_dirs<H>(xs, dirs, ray0, row0, nrows, P, tid, dr);
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // the tile and the rows' tables complete
    if (t == 0) mbar_wait(wbar, 0);

    // ---- recompute the product; its bf16 rounding into st
    wg_fence();
    head_product<H>(acc, xs, wsm, wg);
    wg_commit();
    if (tid < 4) {  // db_rgb, db_α: the rows in order
      for (int r = 0; r < kTM; ++r) s_scalar += gl[r * 4 + tid];
    }
    wg_wait_all();
    acc_fence(acc);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int k = wg * NW + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(st + r0 * SP + k) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(st + (r0 + 8) * SP + k) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
    __syncthreads();  // st complete; the product done reading the tile

    // ---- the column walk: thread (c, g0) takes rows g0·RPT.. of column c.
    // x(r, c) is read from the tile and replaced there by bf16(da(r, c)).
    {
      const float b16 = __bfloat162float(cb[c]), g16 = __bfloat162float(cg[c]);
      const float t16 = __bfloat162float(cbt[c]);
      const float gf = cgf[c], tf = cbtf[c];
      const float wr0 = cwr[c], wr1 = cwr[H + c], wr2 = cwr[2 * H + c];
#pragma unroll 4
      for (int i = 0; i < Hl::RPT; ++i) {
        const int r = g0 * Hl::RPT + i;
        const float* g4 = gl + r * 4;
        const float a =
            bfr(__fadd_rn(__bfloat162float(st[r * SP + c]), b16));
        const float f16 = bfr(__fadd_rn(bfr(__fmul_rn(g16, a)), t16));
        const float h = bfr(sin_poly(__fmul_rn(w0, f16)));
        const float ds = dsin_poly(__fmul_rn(w0, __fadd_rn(__fmul_rn(gf, a), tf)));
        const float dh = fmaf(g4[2], wr2, fmaf(g4[1], wr1, g4[0] * wr0));
        const float df = __fmul_rn(__fmul_rn(dh, ds), w0);
        const float da = __fmul_rn(df, gf);
        s_dg = fmaf(df, a, s_dg);
        s_dbt += df;
        s_db += da;
        s_wr[0] = fmaf(g4[0], h, s_wr[0]);
        s_wr[1] = fmaf(g4[1], h, s_wr[1]);
        s_wr[2] = fmaf(g4[2], h, s_wr[2]);
        bf16* xe = reinterpret_cast<bf16*>(xs + tile_at(r, c));
        s_wa = fmaf(g4[3], __bfloat162float(*xe), s_wa);
        const bf16 da16 = __float2bfloat16(da);
        *xe = da16;
        const float daf = __bfloat162float(da16);
        s_wd[0] = fmaf(dr[r * 4 + 0], daf, s_wd[0]);
        s_wd[1] = fmaf(dr[r * 4 + 1], daf, s_wd[1]);
        s_wd[2] = fmaf(dr[r * 4 + 2], daf, s_wd[2]);
      }
    }
    fence_proxy_async();
    __syncthreads();  // bf16(da) complete in the tile

    // ---- dx = da·W_xᵀ and the directions' gradient da·W_dᵀ: W's pack read
    // N-major (its rows k are the output's columns)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      Wgmma<NW, 0, 1>::mma(
          acc, smem_desc(xs + 2 * kk * kLbo, kLbo, 128),
          smem_desc(wsm + (wg * NW / 8) * (H * 16) + kk * 2 * 128, 128,
                    H * 16),
          kk > 0);
    }
    if (wg == 0 && ddir != nullptr) {
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        Wgmma<16, 0, 1>::mma(
            accd, smem_desc(xs + 2 * kk * kLbo, kLbo, 128),
            smem_desc(wsm + (H / 8) * (H * 16) + kk * 2 * 128, 128,
                      H * 16),
            kk > 0);
      }
    }
    wg_commit();
    for (int q = tid; q < kTM * (H / 8); q += kThreads) {  // the da stash
      const int r = q / (H / 8), kg = q % (H / 8);
      if (r < nrows) {
        *reinterpret_cast<uint4*>(dastash + (rows_b + row0 + r) * H + kg * 8) =
            *reinterpret_cast<const uint4*>(xs + tile_at(r, kg * 8));
      }
    }
    wg_wait_all();
    acc_fence(acc);
    acc_fence(accd);
    // dx + g_α ⊗ w_α, rounded to bf16, into st
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int k = wg * NW + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        const float ga = gl[r * 4 + 3];
        *reinterpret_cast<__nv_bfloat162*>(st + r * SP + k) =
            __floats2bfloat162_rn(fmaf(ga, cwa[k], acc[4 * j + 2 * hh]),
                                  fmaf(ga, cwa[k + 1], acc[4 * j + 2 * hh + 1]));
      }
    }
    if (wg == 0 && ddir != nullptr && lane % 4 < 2) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (r0 + 8 * hh >= nrows) continue;
        const size_t row = rows_b + row0 + r0 + 8 * hh;
        const int col = 2 * (lane % 4);
        ddir[row * 3 + col] = accd[2 * hh];
        if (col + 1 < 3) ddir[row * 3 + col + 1] = accd[2 * hh + 1];
      }
    }
    __syncthreads();  // dx complete in st; every reader of the tile done
    if (t + 1 < n_tiles) {
      load_x_tile<H>(xs, x, rows_b, row0 + kTM, tile_rows(M, row0 + kTM),
                     tid);
    }
    cp_async_commit();
    for (int q = tid; q < kTM * (H / 8); q += kThreads) {
      const int r = q / (H / 8), kg = q % (H / 8);
      if (r < nrows) {
        *reinterpret_cast<uint4*>(dx + (rows_b + row0 + r) * H + kg * 8) =
            *reinterpret_cast<const uint4*>(st + r * SP + kg * 8);
      }
    }
  }

  // the block's sums: row group 0 adds the others' in order
  __syncthreads();
  float* red = reinterpret_cast<float*>(st);  // [slot][tid]
  const float mine[kSlots] = {s_db,    s_dg,    s_dbt,   s_wr[0],
                              s_wr[1], s_wr[2], s_wd[0], s_wd[1],
                              s_wd[2], s_wa,    s_scalar};
#pragma unroll
  for (int s = 0; s < kSlots; ++s) red[s * kThreads + tid] = mine[s];
  __syncthreads();
  float* p = part + ((size_t)b * gridDim.x + blockIdx.x) * kSlots * H;
  if (tid < H) {
    for (int s = 0; s < kScalarSlot; ++s) {
      float v = 0.0f;
      for (int grp = 0; grp < Hl::RG; ++grp) v += red[s * kThreads + grp * H + tid];
      p[s * H + tid] = v;
    }
    p[kScalarSlot * H + tid] = tid < 4 ? red[kScalarSlot * kThreads + tid] : 0.0f;
  }
}

// dW_x = xᵀ·da over all rows, split over K: block (mt, split) takes rows
// [mt·128, +128) of dW_x (features), all H columns, over the row steps
// [split·steps_per_split, ...) of 64 rows. Two warpgroups of 64 dW rows
// each; both operands come row-major from device memory (x's features and
// da's columns contiguous), so both are M- (N-) major in shared memory, in
// core matrices padded kLbo bytes apart along M (N). The last step's rows
// past n_rows (all samples' rows) are zeros. Writes part2[split][H][H].
constexpr int kDwStages = 4;
constexpr int kDwThreads = 256;

template <int H>
struct DwLayout {
  static constexpr int kABytes = (128 / 8) * kLbo;
  static constexpr int kBBytes = (H / 8) * kLbo;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBytes = kDwStages * kStageBytes;
};

template <int H>
__global__ void __launch_bounds__(kDwThreads, 1)
siren_head_bwd_dw_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ da,
                         float* __restrict__ part2, int n_rows,
                         int n_steps, int steps_per_split) {
  using Dl = DwLayout<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int m0 = blockIdx.x * 128;
  const int s0 = blockIdx.y * steps_per_split;
  const int nt = max(0, min(n_steps, s0 + steps_per_split) - s0);
  // an element (row r of the step, column n) of a stage's operand
  auto at = [](int r, int n) { return (n >> 3) * kLbo + (r >> 3) * 128 + (r & 7) * 16; };
  auto load = [&](int q) {
    unsigned char* a = smem + (q % kDwStages) * Dl::kStageBytes;
    unsigned char* bm = a + Dl::kABytes;
    const int row0 = (s0 + q) * 64;
    for (int i = tid; i < 64 * 16; i += kDwThreads) {
      const int r = i / 16, g = i % 16;
      const bool in = row0 + r < n_rows;
      cp_async16_zfill(a + at(r, g * 8),
                       x + (size_t)(in ? row0 + r : 0) * H + m0 + g * 8, in);
    }
    for (int i = tid; i < 64 * (H / 8); i += kDwThreads) {
      const int r = i / (H / 8), g = i % (H / 8);
      const bool in = row0 + r < n_rows;
      cp_async16_zfill(bm + at(r, g * 8),
                       da + (size_t)(in ? row0 + r : 0) * H + g * 8, in);
    }
  };
  for (int q = 0; q < kDwStages - 1; ++q) {
    if (q < nt) load(q);
    cp_async_commit();
  }
  float acc[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) acc[i] = 0.0f;
  for (int q = 0; q < nt; ++q) {
    cp_async_wait<kDwStages - 2>();
    fence_proxy_async();
    __syncthreads();  // step q landed; step q−1's stage free
    if (q + kDwStages - 1 < nt) load(q + kDwStages - 1);
    cp_async_commit();
    const unsigned char* a = smem + (q % kDwStages) * Dl::kStageBytes;
    const unsigned char* bm = a + Dl::kABytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma<H, 1, 1>::mma(
          acc, smem_desc(a + wg * 8 * kLbo + kk * 2 * 128, 128, kLbo),
          smem_desc(bm + kk * 2 * 128, 128, kLbo), 1);
    }
    wg_commit();
    wg_wait_all();
    acc_fence(acc);
  }
  float* out = part2 + (size_t)blockIdx.y * H * H;
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

// dw[k][c] = Σ_split part2[split][k][c], k < H.
__global__ void siren_head_bwd_dw_sum_kernel(const float* __restrict__ part2,
                                             float* __restrict__ dw, int HH,
                                             int n_split) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= HH) return;
  float v = 0.0f;
  for (int s = 0; s < n_split; ++s) v += part2[(size_t)s * HH + e];
  dw[e] = v;
}

// From the blocks' sums part[B][n_chunks][kSlots][H]: dγ, dβ (B, H), each a
// sample's chunks in order; db, dW_rgb (3, H), dW's direction rows (3, H),
// dw_α (H), db_rgb (3), db_α: the samples in order, each its chunks.
__global__ void siren_head_bwd_sum_kernel(const float* __restrict__ part,
                                          float* __restrict__ dg,
                                          float* __restrict__ dbt,
                                          float* __restrict__ db,
                                          float* __restrict__ dwr,
                                          float* __restrict__ dwd,
                                          float* __restrict__ dwa,
                                          float* __restrict__ dbr,
                                          float* __restrict__ dba, int B,
                                          int n_chunks, int H) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_b = (size_t)n_chunks * kSlots * H;
  if (e < 2 * B * H) {
    const int which = e / (B * H), b = (e % (B * H)) / H, c = e % H;
    const float* p = part + b * per_b + (size_t)(1 + which) * H + c;
    float v = 0.0f;
    for (int k = 0; k < n_chunks; ++k) v += p[(size_t)k * kSlots * H];
    (which == 0 ? dg : dbt)[(size_t)b * H + c] = v;
    return;
  }
  const int g = e - 2 * B * H;
  if (g >= 8 * H + 4) return;
  // outputs: db (slot 0) | dW_rgb (3–5) | dW's direction rows (6–8) |
  // dw_α (9) | the scalars
  const int slot = g >= 8 * H ? kScalarSlot : g < H ? 0 : g / H + 2;
  const int c = g < 8 * H ? g % H : g - 8 * H;
  float v = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float* p = part + b * per_b + (size_t)slot * H + c;
    for (int k = 0; k < n_chunks; ++k) v += p[(size_t)k * kSlots * H];
  }
  if (slot == 0) {
    db[c] = v;
  } else if (slot <= 5) {
    dwr[(slot - 3) * H + c] = v;
  } else if (slot <= 8) {
    dwd[(slot - 6) * H + c] = v;
  } else if (slot == 9) {
    if (dwa != nullptr) dwa[c] = v;
  } else if (c < 3) {
    dbr[c] = v;
  } else if (dba != nullptr) {
    dba[0] = v;
  }
}

bool shape_ok(int B, int M, int N, int H, int rows_per_block) {
  return B > 0 && B <= 65535 && M > 0 && N > 0 &&
         M % N == 0 && (H == 128 || H == 256) && rows_per_block > 0 &&
         rows_per_block % kTM == 0 && (long long)B * M + kTM <= 0x7fffffffLL;
}

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can use

template <int H>
cudaError_t launch_fwd(const bf16* x, const float* dirs, const bf16* wpack,
                       const float* bias, const float* gam, const float* bet,
                       const float* wrgb, const float* brgb,
                       const float* walpha, const float* balpha, bf16* rgb,
                       bf16* alpha, int B, int M, int P, int rows_per_block,
                       float w0, cudaStream_t stream) {
  constexpr int bytes = HeadLayout<H>::kFBytes;
  static_assert(bytes <= kMaxSmem, "the forward's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      siren_head_fwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + rows_per_block - 1) / rows_per_block, B);
  siren_head_fwd_kernel<H><<<grid, kThreads, bytes, stream>>>(
      x, dirs, wpack, bias, gam, bet, wrgb, brgb, walpha, balpha, rgb, alpha,
      M, P, rows_per_block, w0);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_bwd(const bf16* x, const float* dirs, const bf16* wpack,
                       const float* bias, const float* gam, const float* bet,
                       const float* wrgb, const float* walpha, const bf16* rgb,
                       const bf16* alpha, const bf16* grgb,
                       const bf16* galpha, bf16* dx, float* ddir,
                       bf16* dastash, float* part, float* part2, float* dw,
                       float* db, float* dg, float* dbt, float* dwr,
                       float* dbr, float* dwa, float* dba, int B, int M, int P,
                       int rows_per_block, int n_split, float w0,
                       cudaStream_t stream) {
  constexpr int bytes = HeadLayout<H>::kBBytes;
  static_assert(bytes <= kMaxSmem, "the backward's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      siren_head_bwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int n_chunks = (M + rows_per_block - 1) / rows_per_block;
  siren_head_bwd_kernel<H><<<dim3(n_chunks, B), kThreads, bytes, stream>>>(
      x, dirs, wpack, bias, gam, bet, wrgb, walpha, rgb, alpha, grgb, galpha,
      dx, ddir, dastash, part, M, P, rows_per_block, w0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  using Dl = DwLayout<H>;
  static_assert(Dl::kBytes <= kMaxSmem, "the weight gradient's shared memory");
  const int n_steps = (B * M + 63) / 64;
  const int steps_per_split = (n_steps + n_split - 1) / n_split;
  err = cudaFuncSetAttribute(siren_head_bwd_dw_kernel<H>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Dl::kBytes);
  if (err != cudaSuccess) return err;
  siren_head_bwd_dw_kernel<H><<<dim3(H / 128, n_split), kDwThreads,
                                Dl::kBytes, stream>>>(
      x, dastash, part2, B * M, n_steps, steps_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  siren_head_bwd_dw_sum_kernel<<<(H * H + 255) / 256, 256, 0, stream>>>(
      part2, dw, H * H, n_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_sums = 2 * B * H + 8 * H + 4;
  siren_head_bwd_sum_kernel<<<(n_sums + 255) / 256, 256, 0, stream>>>(
      part, dg, dbt, db, dwr, dw + (size_t)H * H, dwa, dbr, dba, B, n_chunks,
      H);
  return cudaGetLastError();
}

}  // namespace

// x (B, M, H) bf16; dirs (B, N, 3) f32, M = N·P rows ray by ray; wpack: W
// (H+3, H) packed as the product's B operand (pack_weight in
// ops/cuda/siren_head.py); bias (H); gam, bet (B, H); wrgb (3, H), brgb
// (3); walpha (1, H) and balpha (1), or both null (no α). rgb (B, M, 3)
// and alpha (B, M, 1) bf16. rows_per_block a multiple of 64.
extern "C" int lgzt_siren_head_fwd(const void* x, const float* dirs,
                                   const void* wpack, const float* bias,
                                   const float* gam, const float* bet,
                                   const float* wrgb, const float* brgb,
                                   const float* walpha, const float* balpha,
                                   void* rgb, void* alpha, int B, int M, int N,
                                   int H, int rows_per_block, float w0,
                                   void* stream) {
  if (!shape_ok(B, M, N, H, rows_per_block) ||
      (walpha == nullptr) != (balpha == nullptr) ||
      (walpha != nullptr && alpha == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wp = static_cast<const bf16*>(wpack);
  auto* o = static_cast<bf16*>(rgb);
  auto* oa = static_cast<bf16*>(alpha);
  auto s = static_cast<cudaStream_t>(stream);
  const int P = M / N;
  cudaError_t err;
  if (H == 128) {
    err = launch_fwd<128>(xb, dirs, wp, bias, gam, bet, wrgb, brgb, walpha, balpha, o, oa, B, M, P, rows_per_block, w0, s);
  } else {
    err = launch_fwd<256>(xb, dirs, wp, bias, gam, bet, wrgb, brgb, walpha, balpha, o, oa, B, M, P, rows_per_block, w0, s);
  }
  return static_cast<int>(err);
}

// The forward's inputs but the biases of the linears, its outputs rgb and
// alpha and their cotangents grgb (B, M, 3) and galpha (B, M, 1), bf16
// (alpha, galpha, walpha, dwa and dba null without α). Writes dx (B, M, H)
// bf16, ddir (B, M, 3) per row (may be null), dw (H+3, H), db (H), dg, dbt
// (B, H), dwr (3, H), dbr (3), dwa (H), dba (1), f32. Scratch the caller
// allocates: dastash (B, M, H) bf16, part B·n_chunks·11·H f32 (n_chunks =
// ceil(M / rows_per_block)), part2 n_split·H·H f32.
extern "C" int lgzt_siren_head_bwd(
    const void* x, const float* dirs, const void* wpack, const float* bias,
    const float* gam, const float* bet, const float* wrgb,
    const float* walpha, const void* rgb, const void* alpha, const void* grgb,
    const void* galpha, void* dx, float* ddir, void* dastash, float* part,
    float* part2, float* dw, float* db, float* dg, float* dbt, float* dwr,
    float* dbr, float* dwa, float* dba, int B, int M, int N, int H,
    int rows_per_block, int n_split, float w0, void* stream) {
  const bool a = walpha != nullptr;
  if (!shape_ok(B, M, N, H, rows_per_block) || n_split <= 0 ||
      a != (alpha != nullptr) || a != (galpha != nullptr) ||
      a != (dwa != nullptr) || a != (dba != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wp = static_cast<const bf16*>(wpack);
  const auto* yr = static_cast<const bf16*>(rgb);
  const auto* ya = static_cast<const bf16*>(alpha);
  const auto* gr = static_cast<const bf16*>(grgb);
  const auto* ga = static_cast<const bf16*>(galpha);
  auto* dxb = static_cast<bf16*>(dx);
  auto* st = static_cast<bf16*>(dastash);
  auto s = static_cast<cudaStream_t>(stream);
  const int P = M / N;
  cudaError_t err;
  if (H == 128) {
    err = launch_bwd<128>(xb, dirs, wp, bias, gam, bet, wrgb, walpha, yr, ya, gr, ga, dxb, ddir, st, part, part2, dw, db, dg, dbt, dwr, dbr, dwa, dba, B, M, P, rows_per_block, n_split, w0, s);
  } else {
    err = launch_bwd<256>(xb, dirs, wp, bias, gam, bet, wrgb, walpha, yr, ya, gr, ga, dxb, ddir, st, part, part2, dw, db, dg, dbt, dwr, dbr, dwa, dba, B, M, P, rows_per_block, n_split, w0, s);
  }
  return static_cast<int>(err);
}
