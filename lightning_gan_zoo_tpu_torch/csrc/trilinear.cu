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
// The design keeps every access coalesced: threads run along C, the
// innermost axis of (B, D, H, W, C), so a warp reads 32 consecutive floats
// of one corner and writes 32 consecutive floats of one output point. Each
// block first computes the corner offsets and weights of its points once,
// into shared memory, instead of once per channel.
//
// Semantics (lightning_gan_zoo_tpu/ops/grid_sample.py:39-73): corner indices
// are clamped to the volume from the UNCLAMPED floor, and the weights come
// from the unclamped fractions. All arithmetic is f32.
//
// The backward scatters g * w into a zero-filled gradient with f32
// atomicAdd. Atomics make the order of the sum at each voxel vary from run
// to run, so the gradient is not bit-reproducible; it agrees with an
// ordered sum to f32 rounding (about 1e-6 relative at these sizes).
//
// Plain C interface, loaded with ctypes: each function launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTilePoints = 64;  // points per block

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

// grid (ceil(N / kTilePoints), B); block kThreads.
__global__ void __launch_bounds__(kThreads)
trilinear_fwd_kernel(const float* __restrict__ vox,
                     const float* __restrict__ coords,
                     float* __restrict__ out,
                     int D, int H, int W, int C, int N) {
  __shared__ int s_idx[kTilePoints][8];
  __shared__ float s_w[kTilePoints][8];
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTilePoints;
  const int np = min(kTilePoints, N - p0);
  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const float* q = coords + (static_cast<long long>(b) * N + p0 + p) * 3;
    corner_setup(q[0], q[1], q[2], D, H, W, s_idx[p], s_w[p]);
  }
  __syncthreads();
  const float* v = vox + static_cast<long long>(b) * D * H * W * C;
  float* o = out + (static_cast<long long>(b) * N + p0) * C;
  for (int i = threadIdx.x; i < np * C; i += blockDim.x) {
    const int p = i / C, c = i - p * C;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc += __ldg(v + static_cast<long long>(s_idx[p][k]) * C + c)
             * s_w[p][k];
    }
    o[i] = acc;
  }
}

// grid (ceil(N / kTilePoints), B); block kThreads. dvox must be zeroed.
__global__ void __launch_bounds__(kThreads)
trilinear_bwd_kernel(const float* __restrict__ g,
                     const float* __restrict__ coords,
                     float* __restrict__ dvox,
                     int D, int H, int W, int C, int N) {
  __shared__ int s_idx[kTilePoints][8];
  __shared__ float s_w[kTilePoints][8];
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTilePoints;
  const int np = min(kTilePoints, N - p0);
  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const float* q = coords + (static_cast<long long>(b) * N + p0 + p) * 3;
    corner_setup(q[0], q[1], q[2], D, H, W, s_idx[p], s_w[p]);
  }
  __syncthreads();
  float* dv = dvox + static_cast<long long>(b) * D * H * W * C;
  const float* gb = g + (static_cast<long long>(b) * N + p0) * C;
  for (int i = threadIdx.x; i < np * C; i += blockDim.x) {
    const int p = i / C, c = i - p * C;
    const float gv = gb[i];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      atomicAdd(dv + static_cast<long long>(s_idx[p][k]) * C + c,
                gv * s_w[p][k]);
    }
  }
}

dim3 grid_for(int B, int N) {
  return dim3((N + kTilePoints - 1) / kTilePoints, B);
}

}  // namespace

extern "C" int lgzt_trilinear_fwd(const float* vox, const float* coords,
                                  float* out, int B, int D, int H, int W,
                                  int C, int N, void* stream) {
  if (B > 0 && N > 0) {
    trilinear_fwd_kernel<<<grid_for(B, N), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        vox, coords, out, D, H, W, C, N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lgzt_trilinear_bwd(const float* g, const float* coords,
                                  float* dvox, int B, int D, int H, int W,
                                  int C, int N, void* stream) {
  if (B > 0 && N > 0) {
    trilinear_bwd_kernel<<<grid_for(B, N), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        g, coords, dvox, D, H, W, C, N);
  }
  return static_cast<int>(cudaGetLastError());
}
