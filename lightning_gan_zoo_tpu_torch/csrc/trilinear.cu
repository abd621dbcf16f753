// Border-clamped trilinear resample of a channels-last feature volume, and
// its gradient with respect to the volume, for Hopper (sm_90a).
//
// Replaces lightning_gan_zoo_tpu/ops/pallas/trilinear.py: `_forward` (the
// pl.pallas_call at :155) and `_backward_vox` (the pl.pallas_call at :181),
// reached through `trilinear_resample_mxu`. The TPU kernel rewrote the
// gather as factored one-hot matmuls because gathers serialise on a TPU;
// on this card a gather from L1/L2 is cheap, so these kernels compute the
// same function directly: eight weighted corner reads per output value.
//
// What bounds it: HoloGAN resamples a (32, 16, 16, 16, 64) f32 volume at
// 32 x 4096 points, so the forward reads a 33.5 MB volume and writes a
// 33.5 MB result, and the backward reads a 33.5 MB cotangent and writes a
// 33.5 MB gradient, against ~0.1 GFLOP of arithmetic: memory-bound. One
// sample's volume is 1 MB, so the eight corner reads of neighbouring points
// hit L2 after the first touch and device memory sees each byte about once.
//
// The forward is a gather with no tensor-core work, so its design is about
// loads in flight and instructions per byte. Threads run along C, the
// innermost axis of (B, D, H, W, C), in 16-byte float4 vectors where C % 4
// == 0 (a scalar path of the same code otherwise): at C = 64 sixteen lanes
// cover a point, so every corner read and every output write of a warp is
// two 256-byte rows. Each thread takes one (point, vector) item and issues
// its 8 corner loads, through the non-coherent path, before any arithmetic.
// Each lane computes its point's corner setup in registers (the coordinates
// are a broadcast read), so there is no shared-memory staging and no
// barrier. The result leaves as streaming stores; blocks run sample-major
// (gridDim.x walks one sample's points), so one sample's 1 MB volume stays
// hot in L2 while its points are read. One item per thread was the fastest
// on an H100 (PERF.md's stage table): 8 float4 loads in flight per thread at
// 40 registers keep 64 warps on an SM, where 4 items take 160 registers and
// a quarter of the warps. An L2 evict-last policy on the volume reads made
// no measurable difference and is not used.
//
// Semantics (lightning_gan_zoo_tpu/ops/grid_sample.py:39-73): corner indices
// are clamped to the volume from the UNCLAMPED floor, and the weights come
// from the unclamped fractions. All arithmetic is f32. The forward rounds
// every product and every sum on its own (no FMA), each weight as
// (g_x·g_y)·g_z and the eight terms summed left to right from the first, in
// the order of ops/grid_sample.py::trilinear_resample: it equals the plain
// version on the card bit for bit.
//
// The backward is deterministic: no float atomics, every voxel's gradient
// summed in one fixed order. The TPU kernel summed its point tiles into one
// VMEM scratch in grid order; here blocks run in no order, so the backward
// gathers instead of scattering. Entry e = point·8 + corner of a sample
// touches one voxel; the inverse map lists each voxel's entries (its bin)
// in ascending order of e, built by a stable counting sort over groups of
// kGroupPoints points, every count in shared memory (integer atomics there
// count, and the counts do not depend on the order). Three kernels, one
// call:
//   1. `trilinear_count_kernel`, a block per (group, sample): the group's
//      entries per voxel;
//   2. `trilinear_place_kernel`, a block per (group, sample): from all
//      groups' counts, the start of each voxel's bin (a scan of the totals)
//      plus the entries of earlier groups there; then the group's entries
//      sorted stably by voxel in shared memory (its counts scanned, the
//      entries placed with cursors, then each moved to its rank among the
//      smaller entries of its local bin), each written, as its point and
//      weight, to that base + its rank: the map comes out sorted without a
//      sort pass;
//   3. `trilinear_bwd_kernel`: a thread per voxel and kVec channels
//      (threads along C, so the cotangent reads are coalesced 16-byte
//      vectors where C allows) sums g[point]·w over the voxel's bin in bin
//      order and writes the result once; a voxel without entries writes 0,
//      so the gradient needs no zero fill. Each cotangent row is read once
//      per corner, as the forward reads the volume, mostly from L2.
// At HoloGAN's shapes a bin holds 8 entries on average (108 at most) and
// the scratch is ~10 MB, small beside the 67 MB the kernels must move. A
// product and a sum are rounded separately (no FMA), so the result equals
// ops/cuda/trilinear.py::ordered_vox_grad, the same order in plain
// PyTorch. A group's counts live in shared memory, so the backward takes
// volumes of up to kMaxVox voxels.
//
// Plain C interface, loaded with ctypes: each function launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kGroupPoints = 1024;  // points (and threads) of a sort group
constexpr int kMaxVox = 16 * 1024;   // three int counts per voxel: 192 KB

// Corner k of point (x, y, z): voxel index (z*H + y)*W + x and weight, in
// the order of the plain version's eight terms.
__device__ __forceinline__ void corner_setup(float x, float y, float z,
                                             int D, int H, int W,
                                             int* idx, float* wt) {
  const float x0 = floorf(x), y0 = floorf(y), z0 = floorf(z);
  const int xl = static_cast<int>(x0), yl = static_cast<int>(y0),
            zl = static_cast<int>(z0);
  const int x0i = min(max(xl, 0), W - 1), x1i = min(max(xl + 1, 0), W - 1);
  const int y0i = min(max(yl, 0), H - 1), y1i = min(max(yl + 1, 0), H - 1);
  const int z0i = min(max(zl, 0), D - 1), z1i = min(max(zl + 1, 0), D - 1);
  const float fx = x - x0, fy = y - y0, fz = z - z0;
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const int zs[2] = {z0i, z1i};
  const float wz[2] = {gz, fz};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int p = zs[a] * H;
    idx[4 * a + 0] = (p + y0i) * W + x0i;
    idx[4 * a + 1] = (p + y1i) * W + x0i;
    idx[4 * a + 2] = (p + y0i) * W + x1i;
    idx[4 * a + 3] = (p + y1i) * W + x1i;
    wt[4 * a + 0] = gx * gy * wz[a];
    wt[4 * a + 1] = gx * fy * wz[a];
    wt[4 * a + 2] = fx * gy * wz[a];
    wt[4 * a + 3] = fx * fy * wz[a];
  }
}

// Σ_k t[k]·w[k], k = 0..7, each product and each sum rounded on its own,
// summed left to right from the first term.
__device__ __forceinline__ float corner_sum(const float* t, int stride,
                                            const float* w) {
  float acc = __fmul_rn(t[0], w[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k)
    acc = __fadd_rn(acc, __fmul_rn(t[k * stride], w[k]));
  return acc;
}

// grid (ceil(N·C / (kVec·kThreads)), B); block kThreads. Item i of a sample
// is vector j = i mod (C / kVec) of point i div (C / kVec).
template <int kVec>
__global__ void __launch_bounds__(kThreads)
trilinear_fwd_kernel(const float* __restrict__ vox,
                     const float* __restrict__ coords,
                     float* __restrict__ out,
                     int D, int H, int W, int C, int N) {
  using Vec = typename std::conditional<kVec == 4, float4, float>::type;
  const int b = blockIdx.y, cv = C / kVec, items = N * cv;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const Vec* v = reinterpret_cast<const Vec*>(vox) +
                 static_cast<long long>(b) * D * H * W * cv;
  const float* q = coords + static_cast<long long>(b) * N * 3;
  const int p = i / cv, j = i - p * cv;
  const float x = __ldg(q + 3 * p), y = __ldg(q + 3 * p + 1),
              z = __ldg(q + 3 * p + 2);
  const float x0 = floorf(x), y0 = floorf(y), z0 = floorf(z);
  const int xl = static_cast<int>(x0), yl = static_cast<int>(y0),
            zl = static_cast<int>(z0);
  const int xs[2] = {min(max(xl, 0), W - 1), min(max(xl + 1, 0), W - 1)};
  const int ys[2] = {min(max(yl, 0), H - 1), min(max(yl + 1, 0), H - 1)};
  const int zs[2] = {min(max(zl, 0), D - 1), min(max(zl + 1, 0), D - 1)};
  // every corner load first
  Vec t[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {  // corner c = 4·z + 2·x + y
    const int vi = (zs[c >> 2] * H + ys[c & 1]) * W + xs[(c >> 1) & 1];
    t[c] = __ldg(v + static_cast<long long>(vi) * cv + j);
  }
  const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0),
              fz = __fsub_rn(z, z0);
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy),
              gz = __fsub_rn(1.0f, fz);
  const float xy[4] = {__fmul_rn(gx, gy), __fmul_rn(gx, fy),
                       __fmul_rn(fx, gy), __fmul_rn(fx, fy)};
  float w[8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    w[c] = __fmul_rn(xy[c], gz);
    w[c + 4] = __fmul_rn(xy[c], fz);
  }
  Vec acc;
  const float* tk = reinterpret_cast<const float*>(t);
  float* a = reinterpret_cast<float*>(&acc);
#pragma unroll
  for (int u = 0; u < kVec; ++u) a[u] = corner_sum(tk + u, kVec, w);
  __stcs(reinterpret_cast<Vec*>(out) + static_cast<long long>(b) * items + i,
         acc);
}

// ---------------------------------------------------------------------------
// The backward. cnt (B·G·V ints, G = ceil(N / kGroupPoints)), off
// (B·(V+1) ints) and map (B·8N (point, weight) pairs) are the caller's
// scratch. Blocks of the map kernels have kGroupPoints threads.

// Exclusive scan of the n ints of in, in shared memory, into out (which may
// be in). Returns the total; every thread is past a barrier on return.
__device__ __forceinline__ int block_scan(const int* in, int* out, int n,
                                          int* s_warp) {
  constexpr int nw = kGroupPoints / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = (n + kGroupPoints - 1) / kGroupPoints;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += in[i];
  int incl = s;  // inclusive over the warp
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    s_warp[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int run = (warp > 0 ? s_warp[warp - 1] : 0) + incl - s;
  for (int i = lo; i < hi; ++i) {
    const int c = in[i];
    out[i] = run;
    run += c;
  }
  const int total = s_warp[nw - 1];
  __syncthreads();
  return total;
}

// This thread's point of group (g, b), if it has one: its eight corners.
__device__ __forceinline__ bool group_point(const float* coords, int g, int b,
                                            int D, int H, int W, int N,
                                            int* idx, float* wt) {
  const int p = g * kGroupPoints + threadIdx.x;
  if (p >= N) return false;
  const float* q = coords + (static_cast<long long>(b) * N + p) * 3;
  corner_setup(q[0], q[1], q[2], D, H, W, idx, wt);
  return true;
}

// grid (G, B); dynamic shared memory V ints. cnt[b][g][v] = entries of
// group g at v.
__global__ void __launch_bounds__(kGroupPoints)
trilinear_count_kernel(const float* __restrict__ coords, int* __restrict__ cnt,
                       int D, int H, int W, int N) {
  extern __shared__ int s_cnt[];
  const int g = blockIdx.x, b = blockIdx.y, V = D * H * W;
  for (int v = threadIdx.x; v < V; v += kGroupPoints) s_cnt[v] = 0;
  __syncthreads();
  int idx[8];
  float wt[8];
  if (group_point(coords, g, b, D, H, W, N, idx, wt)) {
#pragma unroll
    for (int k = 0; k < 8; ++k) atomicAdd(s_cnt + idx[k], 1);
  }
  __syncthreads();
  int* c = cnt + (static_cast<long long>(b) * gridDim.x + g) * V;
  for (int v = threadIdx.x; v < V; v += kGroupPoints) c[v] = s_cnt[v];
}

// grid (G, B); dynamic shared memory 3·V + 8·kGroupPoints ints. Writes the
// (point, weight) of group g's entries of sample b to their places in map;
// the block of group 0 writes off[b][v] = Σ_{u<v} of the voxels' totals,
// the start of v's bin (off[b][V] = 8N).
__global__ void __launch_bounds__(kGroupPoints)
trilinear_place_kernel(const float* __restrict__ coords,
                       const int* __restrict__ cnt, int* __restrict__ off,
                       int2* __restrict__ map, int D, int H, int W, int N) {
  extern __shared__ int smem[];
  __shared__ int s_warp[32];
  const int g = blockIdx.x, b = blockIdx.y, V = D * H * W, G = gridDim.x;
  int* s_base = smem;           // where the group's entries at v begin
  int* s_cnt = smem + V;        // the voxels' totals; the placing cursors
  int* s_start = smem + 2 * V;  // the group's counts; its local bins' starts
  int* s_list = smem + 3 * V;   // the group's entries by local bin
  const int* cb = cnt + static_cast<long long>(b) * G * V;
  for (int v = threadIdx.x; v < V; v += kGroupPoints) {
    int tot = 0, pre = 0, own = 0;
#pragma unroll 4
    for (int h = 0; h < G; ++h) {
      const int n = cb[static_cast<long long>(h) * V + v];
      tot += n;
      pre += h < g ? n : 0;
      own = h == g ? n : own;
    }
    s_cnt[v] = tot;
    s_base[v] = pre;
    s_start[v] = own;
  }
  __syncthreads();
  const int total = block_scan(s_cnt, s_cnt, V, s_warp);
  int* o = off + static_cast<long long>(b) * (V + 1);
  for (int v = threadIdx.x; v < V; v += kGroupPoints) {
    s_base[v] += s_cnt[v];
    if (g == 0) o[v] = s_cnt[v];
  }
  if (g == 0 && threadIdx.x == 0) o[V] = total;
  block_scan(s_start, s_start, V, s_warp);
  for (int v = threadIdx.x; v < V; v += kGroupPoints) s_cnt[v] = s_start[v];
  __syncthreads();
  int idx[8];
  float wt[8];
  const bool has = group_point(coords, g, b, D, H, W, N, idx, wt);
  const int p = g * kGroupPoints + threadIdx.x;
  if (has) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      s_list[atomicAdd(s_cnt + idx[k], 1)] = p * 8 + k;
  }
  __syncthreads();  // s_cnt[v] is the end of v's local bin
  if (!has) return;
  int2* m = map + static_cast<long long>(b) * 8 * N;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int v = idx[k], e = p * 8 + k;
    int rank = 0;
    for (int i = s_start[v]; i < s_cnt[v]; ++i) rank += s_list[i] < e;
    m[s_base[v] + rank] = make_int2(p, __float_as_int(wt[k]));
  }
}

// grid (ceil(V·C / (kVec·kThreads)), B); block kThreads. dvox[b][v][c] =
// Σ over v's bin, in order, of g[b][point][c]·w, kVec channels per thread.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
trilinear_bwd_kernel(const float* __restrict__ g,
                     const int* __restrict__ off,
                     const int2* __restrict__ map,
                     float* __restrict__ dvox, int V, int C, int N) {
  using Vec = typename std::conditional<kVec == 4, float4, float>::type;
  const int b = blockIdx.y, cv = C / kVec;  // vectors per voxel
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= V * cv) return;
  const int v = i / cv, c = (i - v * cv) * kVec;
  const int* o = off + static_cast<long long>(b) * (V + 1);
  const int2* mb = map + static_cast<long long>(b) * 8 * N;
  const float* gb = g + static_cast<long long>(b) * N * C + c;
  const int lo = __ldg(o + v), hi = __ldg(o + v + 1);
  float acc[kVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u) acc[u] = 0.0f;
#pragma unroll 4
  for (int j = lo; j < hi; ++j) {
    const int2 pw = __ldg(mb + j);
    const Vec t = __ldg(reinterpret_cast<const Vec*>(
        gb + static_cast<long long>(pw.x) * C));
    const float* tv = reinterpret_cast<const float*>(&t);
    const float w = __int_as_float(pw.y);
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      acc[u] = __fadd_rn(acc[u], __fmul_rn(tv[u], w));
  }
  Vec res;
  float* rv = reinterpret_cast<float*>(&res);
#pragma unroll
  for (int u = 0; u < kVec; ++u) rv[u] = acc[u];
  *reinterpret_cast<Vec*>(dvox + (static_cast<long long>(b) * V + v) * C +
                          c) = res;
}

template <int kVec>
int launch_fwd(const float* vox, const float* coords, float* out, int B,
               int D, int H, int W, int C, int N, cudaStream_t s) {
  const long long items = static_cast<long long>(N) * (C / kVec);
  const dim3 grid(static_cast<unsigned>((items + kThreads - 1) / kThreads), B);
  trilinear_fwd_kernel<kVec><<<grid, kThreads, 0, s>>>(vox, coords, out, D, H,
                                                       W, C, N);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// float4 vectors where C % 4 == 0 and the volume and the output are 16-byte
// aligned, single floats otherwise.
extern "C" int lgzt_trilinear_fwd(const float* vox, const float* coords,
                                  float* out, int B, int D, int H, int W,
                                  int C, int N, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (C % 4 == 0 && aligned16(vox) && aligned16(out))
    return launch_fwd<4>(vox, coords, out, B, D, H, W, C, N, s);
  return launch_fwd<1>(vox, coords, out, B, D, H, W, C, N, s);
}

// cnt B·G·D·H·W ints (G = ceil(N / 1024)), off B·(D·H·W + 1) ints and map
// B·8N int pairs: the caller's scratch (its contents on entry do not
// matter). D·H·W at most kMaxVox.
extern "C" int lgzt_trilinear_bwd(const float* g, const float* coords,
                                  float* dvox, int* cnt, int* off, void* map,
                                  int B, int D, int H, int W, int C, int N,
                                  void* stream) {
  const int V = D * H * W;
  if (V > kMaxVox) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<int2*>(map);
  const int G = (N + kGroupPoints - 1) / kGroupPoints;
  const int count_smem = static_cast<int>(sizeof(int)) * V;
  const int place_smem =
      static_cast<int>(sizeof(int)) * (3 * V + 8 * kGroupPoints);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(trilinear_count_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  count_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(trilinear_place_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  place_smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  trilinear_count_kernel<<<dim3(G, B), kGroupPoints, count_smem, s>>>(
      coords, cnt, D, H, W, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  trilinear_place_kernel<<<dim3(G, B), kGroupPoints, place_smem, s>>>(
      coords, cnt, off, m, D, H, W, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (C % 4 == 0) {
    const int n = V * (C / 4);
    trilinear_bwd_kernel<4><<<dim3((n + kThreads - 1) / kThreads, B),
                              kThreads, 0, s>>>(g, off, m, dvox, V, C, N);
  } else {
    const int n = V * C;
    trilinear_bwd_kernel<1><<<dim3((n + kThreads - 1) / kThreads, B),
                              kThreads, 0, s>>>(g, off, m, dvox, V, C, N);
  }
  return static_cast<int>(cudaGetLastError());
}
