// Hopper (sm_90a) kernels for the LSQR solver tail of the seismic flagship.
//
// Built by jets_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded through ctypes: every entry point below is plain `extern "C"`,
// takes raw device pointers, sizes as int64 and the caller's CUDA stream,
// launches on that stream without synchronising, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch. Scalars (t1, t2, inv_a, s) arrive as POINTERS to f32 values in
// device memory: they are 0-d tensors produced by the LSQR recurrence on
// the card, and reading them here keeps the host out of the loop (the
// counterpart of the Pallas kernels' SMEM scalar operand).
//
// Rounding contract: every multiply and add is written with
// __fmul_rn/__fadd_rn, so nvcc cannot contract them into FMAs. Each kernel
// then rounds exactly as PyTorch's eager elementwise ops do, and its
// outputs are bitwise equal to the plain versions in
// jets_tpu_torch/ops/cuda_solver.py on the same card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K1  xw_update:  x' = x + t1*w,  w' = inv_a*vh + t2*w   (x, w in place)
//
// Replaces jets_tpu/ops/pallas_solver.py:xw_update (_xw_kernel).
// Bound: device memory. Five touches of 4 bytes per element (read x, w, vh;
// write x, w) and four flops: 0.2 flop/byte, far below the card's balance
// point, so the only thing that matters is streaming at full bandwidth.
// Design: a grid-stride loop over 16-byte float4 vectors when all three
// buffers are 16-byte aligned (one 128-byte transaction per 8 threads),
// a scalar tail, and a scalar fallback for unaligned views. The TPU
// kernel's leading-dim VMEM tiling has no counterpart: any rank and any
// last dimension are accepted.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void xw_one(float& x, float& w, float vh, float t1,
                                       float t2, float inv_a) {
  float wv = w;
  x = __fadd_rn(x, __fmul_rn(t1, wv));
  w = __fadd_rn(__fmul_rn(inv_a, vh), __fmul_rn(t2, wv));
}

__global__ void xw_update_vec4(float* __restrict__ x, float* __restrict__ w,
                               const float* __restrict__ vh,
                               const float* __restrict__ t1p,
                               const float* __restrict__ t2p,
                               const float* __restrict__ inv_ap, int64_t n) {
  const float t1 = *t1p, t2 = *t2p, inv_a = *inv_ap;
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float4* x4 = reinterpret_cast<float4*>(x);
  float4* w4 = reinterpret_cast<float4*>(w);
  const float4* v4 = reinterpret_cast<const float4*>(vh);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 xv = x4[i], wv = w4[i], vv = v4[i];
    xw_one(xv.x, wv.x, vv.x, t1, t2, inv_a);
    xw_one(xv.y, wv.y, vv.y, t1, t2, inv_a);
    xw_one(xv.z, wv.z, vv.z, t1, t2, inv_a);
    xw_one(xv.w, wv.w, vv.w, t1, t2, inv_a);
    x4[i] = xv;
    w4[i] = wv;
  }
  // scalar tail: the last n % 4 elements
  for (int64_t i = 4 * n4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    xw_one(x[i], w[i], vh[i], t1, t2, inv_a);
  }
}

__global__ void xw_update_scalar(float* __restrict__ x, float* __restrict__ w,
                                 const float* __restrict__ vh,
                                 const float* __restrict__ t1p,
                                 const float* __restrict__ t2p,
                                 const float* __restrict__ inv_ap, int64_t n) {
  const float t1 = *t1p, t2 = *t2p, inv_a = *inv_ap;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    xw_one(x[i], w[i], vh[i], t1, t2, inv_a);
  }
}

// ---------------------------------------------------------------------------
// K3  laplacian3d:       out = L7(z)
// K2  lap3d_axpy_norm2:  vh = L7(z) + s*v,  n2 = sum(vh*vh)
//
// Replace jets_tpu/ops/pallas_solver.py:laplacian3d and :lap3d_axpy_norm2
// (one _lap3d_kernel body with a with_axpy flag; here one template with an
// AXPY flag). L7 is the 7-point order-2 Laplacian with a zero boundary.
// Bound: device memory. K3 reads z once and writes once (8 B/point), K2
// also reads v (12 B/point); 8-10 flops per point. The TPU version streams
// z-slabs through a double-buffered VMEM ring with one-slice halos. On
// Hopper each thread computes one point from its 7 neighbours, threads of
// a warp run along x (the contiguous axis) so every load coalesces, and
// the 50 MB L2 catches the y/z-neighbour reuse between blocks (a 256x256
// f32 plane is 256 KB). Staging z-slabs in shared memory with TMA is later
// work.
//
// Add order: exactly ops/stencil.laplacian_nd's,
//   ((((((-6*c + zlo) + zhi) + ylo) + yhi) + xlo) + xhi)
// including the +0.0f of an out-of-grid neighbour, so the result is bitwise
// equal to laplacian_nd.
//
// The norm: the TPU grid runs in order and carries sum(vh^2) in a (1,1)
// accumulator. Hopper blocks run in parallel in no order, so each block
// reduces its squares into partials[block] (warp shuffles, then one warp
// over the per-warp sums) and a second one-block kernel adds the partials
// in a fixed order. Both stages accumulate in f64: deterministic run to
// run, no atomics, and within 1e-7 relative of an exact sum at 256^3.
// ---------------------------------------------------------------------------

constexpr int kLapBX = 32;  // threads along x (W, contiguous)
constexpr int kLapBY = 8;   // threads along y (H)

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <bool AXPY>
__global__ void __launch_bounds__(kLapBX * kLapBY)
lap3d_kernel(const float* __restrict__ z, const float* __restrict__ v,
             const float* __restrict__ sp, float* __restrict__ out,
             double* __restrict__ partials, int64_t D, int64_t H, int64_t W) {
  const int64_t ix = (int64_t)blockIdx.x * kLapBX + threadIdx.x;
  const int64_t iy = (int64_t)blockIdx.y * kLapBY + threadIdx.y;
  const int64_t iz = blockIdx.z;
  double sq = 0.0;
  if (ix < W && iy < H) {
    const int64_t HW = H * W;
    const int64_t i = (iz * H + iy) * W + ix;
    const float c = z[i];
    const float zlo = iz > 0 ? z[i - HW] : 0.0f;
    const float zhi = iz < D - 1 ? z[i + HW] : 0.0f;
    const float ylo = iy > 0 ? z[i - W] : 0.0f;
    const float yhi = iy < H - 1 ? z[i + W] : 0.0f;
    const float xlo = ix > 0 ? z[i - 1] : 0.0f;
    const float xhi = ix < W - 1 ? z[i + 1] : 0.0f;
    float acc = __fmul_rn(-6.0f, c);
    acc = __fadd_rn(acc, zlo);
    acc = __fadd_rn(acc, zhi);
    acc = __fadd_rn(acc, ylo);
    acc = __fadd_rn(acc, yhi);
    acc = __fadd_rn(acc, xlo);
    acc = __fadd_rn(acc, xhi);
    if (AXPY) {
      acc = __fadd_rn(acc, __fmul_rn(*sp, v[i]));
      sq = (double)acc * (double)acc;
    }
    out[i] = acc;
  }
  if (AXPY) {
    __shared__ double warp_sums[kLapBX * kLapBY / 32];
    const int tid = threadIdx.y * kLapBX + threadIdx.x;
    sq = warp_sum(sq);
    if ((tid & 31) == 0) warp_sums[tid >> 5] = sq;
    __syncthreads();
    if (tid < 32) {
      double t = tid < kLapBX * kLapBY / 32 ? warp_sums[tid] : 0.0;
      t = warp_sum(t);
      if (tid == 0) {
        const int64_t b =
            ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
        partials[b] = t;
      }
    }
  }
}

constexpr int kSumThreads = 1024;

// One block: thread t adds partials t, t+1024, ... in order, then a fixed
// shuffle tree over the block. Deterministic for a given partial count.
__global__ void __launch_bounds__(kSumThreads)
sum_partials(const double* __restrict__ partials, int64_t n,
             float* __restrict__ n2) {
  __shared__ double warp_sums[kSumThreads / 32];
  double t = 0.0;
  for (int64_t i = threadIdx.x; i < n; i += kSumThreads) t += partials[i];
  t = warp_sum(t);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = t;
  __syncthreads();
  if (threadIdx.x < 32) {
    double u = warp_sums[threadIdx.x];
    u = warp_sum(u);
    if (threadIdx.x == 0) *n2 = (float)u;
  }
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline dim3 lap_grid(int64_t D, int64_t H, int64_t W) {
  return dim3((unsigned)cdiv(W, kLapBX), (unsigned)cdiv(H, kLapBY), (unsigned)D);
}

}  // namespace

extern "C" {

const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Number of f64 partial sums lap3d_axpy_norm2 needs for a (D, H, W) grid.
int64_t jt_lap3d_num_partials(int64_t D, int64_t H, int64_t W) {
  return cdiv(W, kLapBX) * cdiv(H, kLapBY) * D;
}

int jt_xw_update(void* x, void* w, const void* vh, const void* t1,
                 const void* t2, const void* inv_a, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(vh)) & 15u) == 0;
  const int64_t work = aligned ? cdiv(n, 4) : n;
  const int64_t blocks = work < 8192 * threads ? cdiv(work, threads) : 8192;
  float* xf = static_cast<float*>(x);
  float* wf = static_cast<float*>(w);
  const float* vf = static_cast<const float*>(vh);
  const float* a = static_cast<const float*>(t1);
  const float* b = static_cast<const float*>(t2);
  const float* c = static_cast<const float*>(inv_a);
  if (aligned) {
    xw_update_vec4<<<(unsigned)blocks, threads, 0, st>>>(xf, wf, vf, a, b, c, n);
  } else {
    xw_update_scalar<<<(unsigned)blocks, threads, 0, st>>>(xf, wf, vf, a, b, c, n);
  }
  return (int)cudaGetLastError();
}

int jt_laplacian3d(const void* z, void* out, int64_t D, int64_t H, int64_t W,
                   void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lap3d_kernel<false><<<lap_grid(D, H, W), dim3(kLapBX, kLapBY), 0, st>>>(
      static_cast<const float*>(z), nullptr, nullptr, static_cast<float*>(out),
      nullptr, D, H, W);
  return (int)cudaGetLastError();
}

int jt_lap3d_axpy_norm2(const void* z, const void* v, const void* s, void* out,
                        void* partials, void* n2, int64_t D, int64_t H,
                        int64_t W, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lap3d_kernel<true><<<lap_grid(D, H, W), dim3(kLapBX, kLapBY), 0, st>>>(
      static_cast<const float*>(z), static_cast<const float*>(v),
      static_cast<const float*>(s), static_cast<float*>(out),
      static_cast<double*>(partials), D, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<1, kSumThreads, 0, st>>>(static_cast<const double*>(partials),
                                          jt_lap3d_num_partials(D, H, W),
                                          static_cast<float*>(n2));
  return (int)cudaGetLastError();
}

}  // extern "C"
