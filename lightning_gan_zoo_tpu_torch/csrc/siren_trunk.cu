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
// output, so once the activations stay on chip the forward is bound by the
// tensor cores and by feeding them the weights. The six bf16 weight
// matrices (768 KB) do not fit in a block's 227 KB of shared memory, so each
// layer's matrix is streamed through shared memory in 64-row chunks; every
// block reads the same 0.8 MB, which stays in L2. A block holds 32 rows:
// their activations (32×256 bf16, 16 KB) and the f32 product tile (32 KB)
// never leave the SM between layers, and two blocks fit on an SM so one
// block's weight loads overlap the other's products. The products are
// warp-level tensor-core MMAs (nvcuda::wmma, bf16 16×16×16, f32
// accumulate); wgmma, TMA and warp specialisation are later work.
//
// The backward (three kernels, one call):
//   1. `trunk_bwd_chain_kernel`: per tile, recompute the forward, then walk
//      the layers back keeping dh on chip. The TPU kernel kept the per-layer
//      stash (pre-activations and layer inputs, ~5 MB for 512 rows) in VMEM;
//      here it does not fit, so each layer's pre-activation a_i and input h_i
//      (both exactly bf16 for layers ≥ 1) are spilled to device scratch the
//      wrapper allocates, and a_0 (f32) is recomputed from x. The slot of a_i
//      is overwritten with the bf16 da_i once the walk has read it.
//      Column sums (db, dγ, dβ, and dW0 = xᵀ·da_0 with Cin ≤ 4 rows) are
//      accumulated per thread across the block's tiles and written as one
//      partial per block; dx is finished in the block.
//   2. `trunk_bwd_dw_kernel`: dWmid_i = h_iᵀ·da_i, a sum over all B·M rows,
//      as a split-K product of the two stashes: each block sums its row range
//      for one output tile into a partial buffer.
//   3. `trunk_bwd_sum_*_kernel`s reduce the partials in a fixed order.
// No atomics: the backward is deterministic run to run.
//
// Plain C interface, loaded with ctypes: each function launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kTM = 32;        // rows per tile: 2 row tiles of 16
constexpr int kKC = 64;        // weight rows (columns, in the backward) per chunk
constexpr int kPad = 8;        // bf16 row padding: 16 bytes
constexpr int kPadF = 4;       // f32 row padding: 16 bytes
constexpr int kMaxL = 16;
constexpr int kMaxCin = 4;

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

// Cody–Waite reduction, each step rounded as the JAX code rounds it
__device__ __forceinline__ float sin_reduce(float x) {
  const float k = rintf(__fmul_rn(x, kInvTwoPi));
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

template <int H>
struct Layout {
  static constexpr int HP = H + kPad;   // activation row stride (bf16)
  static constexpr int SP = H + kPadF;  // product row stride (f32)
  static constexpr int KP = kKC + kPad; // transposed weight chunk stride
  static constexpr int NF = H / 64;     // 16-column fragments per warp
  static constexpr int RG = kThreads / H;  // row groups of the elementwise map
  static constexpr int kActBytes = kTM * HP * 2;
  static constexpr int kProdBytes = kTM * SP * 4;
  static constexpr int kWBytes =
      (kKC * HP > H * KP ? kKC * HP : H * KP) * 2;
  static constexpr int kBytes = kActBytes + kProdBytes + kWBytes;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// st[kTM × H] = hs[kTM × H] · W[H × H] (W row-major, (in, out)), W streamed
// through ws in kKC-row chunks. Warp w owns row tile w % 2 and the column
// block of NF fragments w / 2. Leaves every thread past a __syncthreads with
// the product in st.
template <int H>
__device__ __forceinline__ void product_fwd(const bf16* __restrict__ hs,
                                            const bf16* __restrict__ W,
                                            bf16* ws, float* st, int tid) {
  using Lt = Layout<H>;
  const int warp = tid / 32, rt = warp % 2, cg = warp / 2;
  FragC acc[Lt::NF];
#pragma unroll
  for (int f = 0; f < Lt::NF; ++f) wmma::fill_fragment(acc[f], 0.0f);
  for (int k0 = 0; k0 < H; k0 += kKC) {
    __syncthreads();  // ws free, hs written
    for (int v = tid; v < kKC * H / 8; v += kThreads) {
      const int r = v / (H / 8), c = (v % (H / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + r * Lt::HP + c) =
          *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * H + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, hs + rt * 16 * Lt::HP + k0 + kk, Lt::HP);
#pragma unroll
      for (int f = 0; f < Lt::NF; ++f) {
        FragBr fb;
        wmma::load_matrix_sync(fb, ws + kk * Lt::HP + (cg * Lt::NF + f) * 16,
                               Lt::HP);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < Lt::NF; ++f) {
    wmma::store_matrix_sync(st + rt * 16 * Lt::SP + (cg * Lt::NF + f) * 16,
                            acc[f], Lt::SP, wmma::mem_row_major);
  }
  __syncthreads();
}

// st[kTM × H] = hs[kTM × H] · Wᵀ (the gradient passed down through a layer),
// Wᵀ streamed through ws in kKC-column chunks of W.
template <int H>
__device__ __forceinline__ void product_bwd(const bf16* __restrict__ hs,
                                            const bf16* __restrict__ W,
                                            bf16* ws, float* st, int tid) {
  using Lt = Layout<H>;
  const int warp = tid / 32, rt = warp % 2, cg = warp / 2;
  FragC acc[Lt::NF];
#pragma unroll
  for (int f = 0; f < Lt::NF; ++f) wmma::fill_fragment(acc[f], 0.0f);
  for (int k0 = 0; k0 < H; k0 += kKC) {
    __syncthreads();
    // ws[n][kk] = W[n][k0 + kk]: column n of Wᵀ's chunk, stored by rows
    for (int v = tid; v < H * kKC / 8; v += kThreads) {
      const int n = v / (kKC / 8), kk = (v % (kKC / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + n * Lt::KP + kk) =
          *reinterpret_cast<const uint4*>(W + (size_t)n * H + k0 + kk);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, hs + rt * 16 * Lt::HP + k0 + kk, Lt::HP);
#pragma unroll
      for (int f = 0; f < Lt::NF; ++f) {
        FragBc fb;  // (k, n) = Wᵀ[k0+kk+k][n] = ws[n][kk+k]
        wmma::load_matrix_sync(fb, ws + (cg * Lt::NF + f) * 16 * Lt::KP + kk,
                               Lt::KP);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < Lt::NF; ++f) {
    wmma::store_matrix_sync(st + rt * 16 * Lt::SP + (cg * Lt::NF + f) * 16,
                            acc[f], Lt::SP, wmma::mem_row_major);
  }
  __syncthreads();
}

// grid (ceil(M / kTM), B); block kThreads; dynamic smem Layout<H>::kBytes.
template <int H>
__global__ void __launch_bounds__(kThreads, 2)
trunk_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w0k,
                 const bf16* __restrict__ wmid, const float* __restrict__ bias,
                 const float* __restrict__ gam, const float* __restrict__ bet,
                 bf16* __restrict__ out, int M, int Cin, int L, int n_film,
                 W0s w0s) {
  using Lt = Layout<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);
  float* st = reinterpret_cast<float*>(smem + Lt::kActBytes);
  bf16* ws = reinterpret_cast<bf16*>(smem + Lt::kActBytes + Lt::kProdBytes);

  const int tid = threadIdx.x, b = blockIdx.y;
  const int row0 = blockIdx.x * kTM, nrows = min(kTM, M - row0);
  const size_t base = (size_t)b * M + row0;
  const int c = tid % H, r0 = tid / H;  // this thread's column and rows

  {  // layer 0, f32
    const bool filmed = n_film > 0;
    const float g = filmed ? gam[(size_t)b * n_film * H + c] : 1.0f;
    const float bt = filmed ? bet[(size_t)b * n_film * H + c] : 0.0f;
    for (int r = r0; r < kTM; r += Lt::RG) {
      float h = 0.0f;
      if (r < nrows) {
        const float a = layer0_pre(x + (base + r) * Cin, w0k, bias[c], Cin, H, c);
        const float f = filmed ? __fadd_rn(__fmul_rn(g, a), bt) : a;
        h = sin_poly(__fmul_rn(w0s.v[0], f));
      }
      hs[r * Lt::HP + c] = __float2bfloat16(h);
    }
  }
  for (int i = 1; i < L; ++i) {
    product_fwd<H>(hs, wmid + (size_t)(i - 1) * H * H, ws, st, tid);
    const bool filmed = i < n_film;
    const float bb = bfr(bias[i * H + c]);
    const float g = filmed ? bfr(gam[((size_t)b * n_film + i) * H + c]) : 1.0f;
    const float bt = filmed ? bfr(bet[((size_t)b * n_film + i) * H + c]) : 0.0f;
    for (int r = r0; r < kTM; r += Lt::RG) {
      const float a = bfr(bfr(st[r * Lt::SP + c]) + bb);
      const float f = filmed ? bfr(bfr(g * a) + bt) : a;
      hs[r * Lt::HP + c] = __float2bfloat16(sin_poly(__fmul_rn(w0s.v[i], f)));
    }
  }
  // each thread reads back only the elements it wrote: no barrier needed
  for (int r = r0; r < nrows; r += Lt::RG) {
    out[(base + r) * H + c] = hs[r * Lt::HP + c];
  }
}

// The slots of the per-block column sums: db_i, dγ_i, dβ_i, dW0_k.
struct Slots {
  int L, n_film;
  __host__ __device__ int db(int i) const { return i; }
  __host__ __device__ int dg(int i) const { return L + i; }
  __host__ __device__ int dbt(int i) const { return L + n_film + i; }
  __host__ __device__ int dw0(int k) const { return L + 2 * n_film + k; }
  __host__ __device__ int count(int Cin) const { return L + 2 * n_film + Cin; }
};

// grid (n_chunks, B): block (chunk, b) takes rows [chunk·rows_per_block, ...)
// of sample b, kTM at a time. Writes dx, the stashes' da slots and one
// column-sum partial per block: part[(b·n_chunks + chunk)][slot][H].
template <int H>
__global__ void __launch_bounds__(kThreads, 2)
trunk_bwd_chain_kernel(const float* __restrict__ x,
                       const float* __restrict__ w0k,
                       const bf16* __restrict__ wmid,
                       const float* __restrict__ bias,
                       const float* __restrict__ gam,
                       const float* __restrict__ bet,
                       const bf16* __restrict__ dy, float* __restrict__ dx,
                       bf16* __restrict__ hstash, bf16* __restrict__ adstash,
                       float* __restrict__ part, int M, int Cin, int L,
                       int n_film, int rows_per_block, W0s w0s) {
  using Lt = Layout<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);
  float* st = reinterpret_cast<float*>(smem + Lt::kActBytes);
  bf16* ws = reinterpret_cast<bf16*>(smem + Lt::kActBytes + Lt::kProdBytes);
  float* colacc = reinterpret_cast<float*>(smem + Lt::kBytes);  // [slot][tid]

  const Slots sl{L, n_film};
  const int nslot = sl.count(Cin);
  const int tid = threadIdx.x, b = blockIdx.y;
  const int c = tid % H, r0 = tid / H;
  const size_t R = (size_t)gridDim.y * M;  // rows of the whole batch
  for (int s = 0; s < nslot; ++s) colacc[s * kThreads + tid] = 0.0f;

  const int first = blockIdx.x * rows_per_block;
  const int last = min(M, first + rows_per_block);
  for (int row0 = first; row0 < last; row0 += kTM) {
    const int nrows = min(kTM, last - row0);
    const size_t base = (size_t)b * M + row0;

    // ---- recompute the forward, spilling h_i (i ≥ 1) and a_i (i ≥ 1)
    {
      const bool filmed = n_film > 0;
      const float g = filmed ? gam[(size_t)b * n_film * H + c] : 1.0f;
      const float bt = filmed ? bet[(size_t)b * n_film * H + c] : 0.0f;
      for (int r = r0; r < kTM; r += Lt::RG) {
        float h = 0.0f;
        if (r < nrows) {
          const float a =
              layer0_pre(x + (base + r) * Cin, w0k, bias[c], Cin, H, c);
          const float f = filmed ? __fadd_rn(__fmul_rn(g, a), bt) : a;
          h = sin_poly(__fmul_rn(w0s.v[0], f));
        }
        const bf16 hb = __float2bfloat16(h);
        hs[r * Lt::HP + c] = hb;
        if (r < nrows) hstash[(base + r) * H + c] = hb;
      }
    }
    for (int i = 1; i < L; ++i) {
      product_fwd<H>(hs, wmid + (size_t)(i - 1) * H * H, ws, st, tid);
      const bool filmed = i < n_film;
      const bool last_layer = i == L - 1;
      const float bb = bfr(bias[i * H + c]);
      const float g =
          filmed ? bfr(gam[((size_t)b * n_film + i) * H + c]) : 1.0f;
      const float bt =
          filmed ? bfr(bet[((size_t)b * n_film + i) * H + c]) : 0.0f;
      bf16* a_slot = adstash + (size_t)(i - 1) * R * H;
      bf16* h_slot = hstash + (size_t)i * R * H;
      for (int r = r0; r < kTM; r += Lt::RG) {
        const float a = bfr(bfr(st[r * Lt::SP + c]) + bb);
        if (r < nrows) a_slot[(base + r) * H + c] = __float2bfloat16(a);
        if (last_layer) continue;  // the walk back needs no output
        const float f = filmed ? bfr(bfr(g * a) + bt) : a;
        const bf16 hb = __float2bfloat16(sin_poly(__fmul_rn(w0s.v[i], f)));
        hs[r * Lt::HP + c] = hb;
        if (r < nrows) h_slot[(base + r) * H + c] = hb;
      }
    }

    // ---- walk back; dh (f32) lives in st. Each thread touches only its
    // own (r, c) elements between the products, which end in a barrier.
    for (int r = r0; r < kTM; r += Lt::RG) {
      st[r * Lt::SP + c] =
          r < nrows ? __bfloat162float(dy[(base + r) * H + c]) : 0.0f;
    }
    for (int i = L - 1; i >= 0; --i) {
      const bool filmed = i < n_film;
      const float w0 = w0s.v[i];
      const float g = filmed ? gam[((size_t)b * n_film + i) * H + c] : 1.0f;
      const float bt = filmed ? bet[((size_t)b * n_film + i) * H + c] : 0.0f;
      float s_dg = 0.0f, s_dbt = 0.0f, s_db = 0.0f;
      float s_dw0[kMaxCin] = {0.0f, 0.0f, 0.0f, 0.0f};
      bf16* ad_slot = i > 0 ? adstash + (size_t)(i - 1) * R * H : nullptr;
      for (int r = r0; r < kTM; r += Lt::RG) {
        float da = 0.0f;
        if (r < nrows) {
          const float* xr = x + (base + r) * Cin;
          const float a =
              i > 0 ? __bfloat162float(ad_slot[(base + r) * H + c])
                    : layer0_pre(xr, w0k, bias[c], Cin, H, c);
          const float f = filmed ? __fadd_rn(__fmul_rn(g, a), bt) : a;
          const float ds = dsin_poly(__fmul_rn(w0, f));
          const float df = __fmul_rn(__fmul_rn(st[r * Lt::SP + c], ds), w0);
          if (filmed) {
            s_dg += df * a;
            s_dbt += df;
            da = __fmul_rn(df, g);
          } else {
            da = df;
          }
          s_db += da;
          if (i == 0) {
            for (int k = 0; k < Cin; ++k) s_dw0[k] += xr[k] * da;
          }
        }
        if (i > 0) {
          const bf16 db16 = __float2bfloat16(da);
          hs[r * Lt::HP + c] = db16;
          if (r < nrows) ad_slot[(base + r) * H + c] = db16;
        } else {
          st[r * Lt::SP + c] = da;
        }
      }
      colacc[sl.db(i) * kThreads + tid] += s_db;
      if (filmed) {
        colacc[sl.dg(i) * kThreads + tid] += s_dg;
        colacc[sl.dbt(i) * kThreads + tid] += s_dbt;
      }
      if (i == 0) {
        for (int k = 0; k < Cin; ++k) colacc[sl.dw0(k) * kThreads + tid] += s_dw0[k];
      } else {
        product_bwd<H>(hs, wmid + (size_t)(i - 1) * H * H, ws, st, tid);
      }
    }
    // dx = da_0 · W0ᵀ, f32
    __syncthreads();
    for (int e = tid; e < nrows * Cin; e += kThreads) {
      const int r = e / Cin, k = e % Cin;
      float s = 0.0f;
      for (int j = 0; j < H; ++j) s += st[r * Lt::SP + j] * w0k[k * H + j];
      dx[(base + r) * Cin + k] = s;
    }
    __syncthreads();  // st and hs are reused by the next tile
  }

  // one partial per block: sum the thread row groups of each column
  __syncthreads();
  float* p = part + ((size_t)b * gridDim.x + blockIdx.x) * nslot * H;
  for (int e = tid; e < nslot * H; e += kThreads) {
    const int s = e / H, cc = e % H;
    float v = 0.0f;
    for (int g = 0; g < Lt::RG; ++g) v += colacc[s * kThreads + g * H + cc];
    p[e] = v;
  }
}

// dWmid_i partial over one row range: out tile (TO × TO) of h_iᵀ · da_i.
// grid ((H/TO)², n_split, L−1); 8 warps, warp w owns rows (w % 4)·TO/4 and
// columns (w / 4)·TO/2 of the tile. part2[(i·n_split + split)][H][H].
template <int H, int TO>
__global__ void __launch_bounds__(kThreads)
trunk_bwd_dw_kernel(const bf16* __restrict__ hstash,
                    const bf16* __restrict__ adstash,
                    float* __restrict__ part2, int R, int rows_per_split) {
  constexpr int KB = 32;
  constexpr int LD = TO + kPad;
  constexpr int FM = TO / 64, FN = TO / 32;  // fragments per warp
  __shared__ __align__(128) bf16 As[KB * LD];
  __shared__ __align__(128) bf16 Bs[KB * LD];
  const int tid = threadIdx.x, warp = tid / 32;
  const int tiles = H / TO;
  const int m0 = (blockIdx.x / tiles) * TO, n0 = (blockIdx.x % tiles) * TO;
  const int i = blockIdx.z;  // layer i + 1
  const bf16* hsrc = hstash + (size_t)i * R * H;
  const bf16* dsrc = adstash + (size_t)i * R * H;
  const int wm = (warp % 4) * (TO / 4), wn = (warp / 4) * (TO / 2);
  const int k_begin = blockIdx.y * rows_per_split;
  const int k_end = min(R, k_begin + rows_per_split);

  FragC acc[FM][FN];
#pragma unroll
  for (int a = 0; a < FM; ++a)
#pragma unroll
    for (int q = 0; q < FN; ++q) wmma::fill_fragment(acc[a][q], 0.0f);

  for (int k0 = k_begin; k0 < k_end; k0 += KB) {
    __syncthreads();
    for (int v = tid; v < KB * TO / 8; v += kThreads) {
      const int r = v / (TO / 8), cc = (v % (TO / 8)) * 8;
      uint4 hv = make_uint4(0, 0, 0, 0), dv = make_uint4(0, 0, 0, 0);
      if (k0 + r < k_end) {
        hv = *reinterpret_cast<const uint4*>(hsrc + (size_t)(k0 + r) * H + m0 + cc);
        dv = *reinterpret_cast<const uint4*>(dsrc + (size_t)(k0 + r) * H + n0 + cc);
      }
      *reinterpret_cast<uint4*>(As + r * LD + cc) = hv;
      *reinterpret_cast<uint4*>(Bs + r * LD + cc) = dv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KB; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[FM];
#pragma unroll
      for (int a = 0; a < FM; ++a) {  // (m, k) = h[k0+kk+k][m0+wm+16a+m]
        wmma::load_matrix_sync(fa[a], As + kk * LD + wm + a * 16, LD);
      }
#pragma unroll
      for (int q = 0; q < FN; ++q) {
        FragBr fb;
        wmma::load_matrix_sync(fb, Bs + kk * LD + wn + q * 16, LD);
#pragma unroll
        for (int a = 0; a < FM; ++a) wmma::mma_sync(acc[a][q], fa[a], fb, acc[a][q]);
      }
    }
  }
  float* out = part2 + ((size_t)i * gridDim.y + blockIdx.y) * H * H;
#pragma unroll
  for (int a = 0; a < FM; ++a)
#pragma unroll
    for (int q = 0; q < FN; ++q) {
      wmma::store_matrix_sync(out + (size_t)(m0 + wm + a * 16) * H + n0 + wn + q * 16,
                              acc[a][q], H, wmma::mem_row_major);
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

template <int H>
cudaError_t launch_fwd(const float* x, const float* w0k, const bf16* wmid,
                       const float* bias, const float* gam, const float* bet,
                       bf16* out, int B, int M, int Cin, int L, int n_film,
                       W0s w0s, cudaStream_t stream) {
  constexpr int bytes = Layout<H>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      trunk_fwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kTM - 1) / kTM, B);
  trunk_fwd_kernel<H><<<grid, kThreads, bytes, stream>>>(
      x, w0k, wmid, bias, gam, bet, out, M, Cin, L, n_film, w0s);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_bwd(const float* x, const float* w0k, const bf16* wmid,
                       const float* bias, const float* gam, const float* bet,
                       const bf16* dy, float* dx, float* dw0, float* dwm,
                       float* db, float* dg, float* dbt, bf16* hstash,
                       bf16* adstash, float* part, float* part2, float* ps,
                       int B, int M, int Cin, int L, int n_film,
                       int rows_per_block, int n_split, W0s w0s,
                       cudaStream_t stream) {
  const Slots sl{L, n_film};
  const int nslot = sl.count(Cin);
  const int bytes = Layout<H>::kBytes + nslot * kThreads * 4;
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_chain_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int n_chunks = (M + rows_per_block - 1) / rows_per_block;
  trunk_bwd_chain_kernel<H><<<dim3(n_chunks, B), kThreads, bytes, stream>>>(
      x, w0k, wmid, bias, gam, bet, dy, dx, hstash, adstash, part, M, Cin, L,
      n_film, rows_per_block, w0s);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int R = B * M;
  constexpr int TO = H < 128 ? H : 128;
  const int rows_per_split = ((R + n_split - 1) / n_split + 31) / 32 * 32;
  trunk_bwd_dw_kernel<H, TO><<<dim3((H / TO) * (H / TO), n_split, L - 1),
                               kThreads, 0, stream>>>(hstash, adstash, part2,
                                                      R, rows_per_split);
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

extern "C" int lgzt_siren_trunk_fwd(const float* x, const float* w0k,
                                    const void* wmid, const float* bias,
                                    const float* gam, const float* bet,
                                    void* out, int B, int M, int Cin, int H,
                                    int L, int n_film, const float* w0s,
                                    void* stream) {
  if (!shape_ok(B, M, Cin, H, L, n_film)) return cudaErrorInvalidValue;
  if (M == 0) return static_cast<int>(cudaGetLastError());
  const W0s p = pack_w0s(w0s, L);
  const auto* wm = static_cast<const bf16*>(wmid);
  auto* o = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (H) {
    case 64: err = launch_fwd<64>(x, w0k, wm, bias, gam, bet, o, B, M, Cin, L, n_film, p, s); break;
    case 128: err = launch_fwd<128>(x, w0k, wm, bias, gam, bet, o, B, M, Cin, L, n_film, p, s); break;
    default: err = launch_fwd<256>(x, w0k, wm, bias, gam, bet, o, B, M, Cin, L, n_film, p, s); break;
  }
  return static_cast<int>(err);
}

// Scratch the caller allocates (R = B·M, n_chunks = ceil(M / rows_per_block),
// nslot = L + 2·n_film + Cin): hstash and adstash (L−1)·R·H bf16 (slot j
// holds layer j+1's input and pre-activation), part B·n_chunks·nslot·H f32, part2
// (L−1)·n_split·H·H f32, ps B·nslot·H f32. rows_per_block must be a
// positive multiple of 32.
extern "C" int lgzt_siren_trunk_bwd(
    const float* x, const float* w0k, const void* wmid, const float* bias,
    const float* gam, const float* bet, const void* dy, float* dx, float* dw0,
    float* dwm, float* db, float* dg, float* dbt, void* hstash, void* adstash,
    float* part, float* part2, float* ps, int B, int M, int Cin, int H, int L,
    int n_film, int rows_per_block, int n_split, const float* w0s,
    void* stream) {
  if (!shape_ok(B, M, Cin, H, L, n_film) || M == 0 || rows_per_block <= 0 ||
      rows_per_block % kTM != 0 || n_split <= 0 ||
      (long long)B * M > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const W0s p = pack_w0s(w0s, L);
  const auto* wm = static_cast<const bf16*>(wmid);
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
