// Hopper (sm_90a) kernels for the Krylov solver tails (LSQR, CG, LSMR) and
// the Laplacian adjoint tail of the seismic flagship.
//
// Built by jets_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded through ctypes: every entry point below is plain `extern "C"`,
// takes raw device pointers, sizes as int64 and the caller's CUDA stream,
// launches on that stream without synchronising, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch. Scalars (t1, t2, inv_a, s, alpha, beta, c_hb, c_x, c_h) arrive as
// POINTERS to f32 values in device memory: they are 0-d tensors produced by
// the solver recurrences on the card, and reading them here keeps the host
// out of the loop (the
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

// ---------------------------------------------------------------------------
// K1  xw_update:  x' = x + t1*w,  w' = inv_a*vh + t2*w   (x, w in place)
//
// Replaces jets_tpu/ops/pallas_solver.py:xw_update (_xw_kernel).
// Bound: device memory. Five touches of 4 bytes per element (read x, w, vh;
// write x, w) and four flops: 0.2 flop/byte, far below the card's balance
// point, so the only thing that matters is streaming at full bandwidth.
// Design: the elementwise pass shared with K6a, K6b and K7 (below): a
// grid-stride loop over 16-byte float4 vectors when all three buffers are
// 16-byte aligned (one 128-byte transaction per 8 threads) with a scalar
// tail, and a scalar loop for unaligned views. The TPU kernel's leading-dim
// VMEM tiling has no counterpart: any rank and any last dimension are
// accepted.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void xw_one(float& x, float& w, float vh, float t1,
                                       float t2, float inv_a) {
  float wv = w;
  x = __fadd_rn(x, __fmul_rn(t1, wv));
  w = __fadd_rn(__fmul_rn(inv_a, vh), __fmul_rn(t2, wv));
}

// ---------------------------------------------------------------------------
// K6a cg_update:    x' = x + alpha*p,  r' = r - alpha*q,  rho' = sum(r'*r')
// K6b p_update:     p' = r + beta*p
// K7  lsmr_update:  hbar' = h + c_hb*hbar,  x' = x + c_x*hbar',
//                   h' = inv_a*vh + c_h*h
//
// Replace jets_tpu/ops/pallas_solver.py:cg_update (_cg_kernel), :p_update
// (_p_kernel) and :lsmr_update (_lsmr_kernel), the solver tails of CG and
// LSMR. In place, as the Pallas input_output_aliases: K6a writes x and r,
// K6b p, K7 h, hbar and x.
// Bound: device memory. Per element K6a moves 6 touches of 4 bytes (read x,
// r, p, q; write x, r), K6b 3, K7 7, for 2-5 flops: far below the card's
// balance point. Design, shared with K1: a grid-stride loop over float4
// vectors when every buffer is 16-byte aligned plus a scalar tail, and a
// scalar loop for unaligned views; any rank and length. The grid is a fixed
// function of the length (elem_blocks: 256 threads, one float4 per thread
// up to 8192 blocks), so K6a's reduction order depends on nothing else.
// Each element's outputs are computed from its inputs alone, so reading an
// element and writing it back from the same thread is safe in place; K7
// reads h before it writes h' and uses hbar' for x'.
//
// K6a's norm: the TPU grid carries sum(r'^2) in a (1,1) accumulator. Here
// each thread sums its squares in f64, each block reduces its threads
// (warp shuffles, then one warp) into partials[block], and sum_partials
// adds the partials in a fixed order into the 0-d f32 rho: deterministic,
// no atomics, as K2.
// ---------------------------------------------------------------------------

constexpr int kElemThreads = 256;
constexpr int64_t kElemMaxBlocks = 8192;

inline int64_t elem_blocks(int64_t n) {
  const int64_t b = cdiv(n, 4 * (int64_t)kElemThreads);
  return b < 1 ? 1 : (b > kElemMaxBlocks ? kElemMaxBlocks : b);
}

inline bool aligned16(const void* a, const void* b, const void* c = nullptr,
                      const void* d = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15u) == 0;
}

template <bool VEC>
__global__ void __launch_bounds__(kElemThreads)
xw_update_kernel(float* __restrict__ x, float* __restrict__ w,
                 const float* __restrict__ vh, const float* __restrict__ t1p,
                 const float* __restrict__ t2p, const float* __restrict__ inv_ap,
                 int64_t n) {
  const float t1 = *t1p, t2 = *t2p, inv_a = *inv_ap;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (VEC) {
    head = 4 * (n / 4);
    float4* x4 = reinterpret_cast<float4*>(x);
    float4* w4 = reinterpret_cast<float4*>(w);
    const float4* v4 = reinterpret_cast<const float4*>(vh);
    for (int64_t i = t; i < n / 4; i += stride) {
      float4 xv = x4[i], wv = w4[i];
      const float4 vv = v4[i];
      xw_one(xv.x, wv.x, vv.x, t1, t2, inv_a);
      xw_one(xv.y, wv.y, vv.y, t1, t2, inv_a);
      xw_one(xv.z, wv.z, vv.z, t1, t2, inv_a);
      xw_one(xv.w, wv.w, vv.w, t1, t2, inv_a);
      x4[i] = xv;
      w4[i] = wv;
    }
  }
  for (int64_t i = head + t; i < n; i += stride) xw_one(x[i], w[i], vh[i], t1, t2, inv_a);
}

__device__ __forceinline__ double cg_one(float& x, float& r, float p, float q,
                                         float alpha) {
  x = __fadd_rn(x, __fmul_rn(alpha, p));
  r = __fsub_rn(r, __fmul_rn(alpha, q));
  return (double)r * (double)r;
}

template <bool VEC>
__global__ void __launch_bounds__(kElemThreads)
cg_update_kernel(float* __restrict__ x, float* __restrict__ r,
                 const float* __restrict__ p, const float* __restrict__ q,
                 const float* __restrict__ alphap, double* __restrict__ partials,
                 int64_t n) {
  const float alpha = *alphap;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  double sq = 0.0;
  int64_t head = 0;
  if (VEC) {
    head = 4 * (n / 4);
    float4* x4 = reinterpret_cast<float4*>(x);
    float4* r4 = reinterpret_cast<float4*>(r);
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int64_t i = t; i < n / 4; i += stride) {
      float4 xv = x4[i], rv = r4[i];
      const float4 pv = p4[i], qv = q4[i];
      sq += cg_one(xv.x, rv.x, pv.x, qv.x, alpha);
      sq += cg_one(xv.y, rv.y, pv.y, qv.y, alpha);
      sq += cg_one(xv.z, rv.z, pv.z, qv.z, alpha);
      sq += cg_one(xv.w, rv.w, pv.w, qv.w, alpha);
      x4[i] = xv;
      r4[i] = rv;
    }
  }
  for (int64_t i = head + t; i < n; i += stride) {
    float xv = x[i], rv = r[i];
    sq += cg_one(xv, rv, p[i], q[i], alpha);
    x[i] = xv;
    r[i] = rv;
  }
  __shared__ double warp_sums[kElemThreads / 32];
  sq = warp_sum(sq);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
  __syncthreads();
  if (threadIdx.x < 32) {
    double u = threadIdx.x < kElemThreads / 32 ? warp_sums[threadIdx.x] : 0.0;
    u = warp_sum(u);
    if (threadIdx.x == 0) partials[blockIdx.x] = u;
  }
}

__device__ __forceinline__ float p_one(float r, float p, float beta) {
  return __fadd_rn(r, __fmul_rn(beta, p));
}

template <bool VEC>
__global__ void __launch_bounds__(kElemThreads)
p_update_kernel(const float* __restrict__ r, float* __restrict__ p,
                const float* __restrict__ betap, int64_t n) {
  const float beta = *betap;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (VEC) {
    head = 4 * (n / 4);
    const float4* r4 = reinterpret_cast<const float4*>(r);
    float4* p4 = reinterpret_cast<float4*>(p);
    for (int64_t i = t; i < n / 4; i += stride) {
      const float4 rv = r4[i];
      float4 pv = p4[i];
      pv.x = p_one(rv.x, pv.x, beta);
      pv.y = p_one(rv.y, pv.y, beta);
      pv.z = p_one(rv.z, pv.z, beta);
      pv.w = p_one(rv.w, pv.w, beta);
      p4[i] = pv;
    }
  }
  for (int64_t i = head + t; i < n; i += stride) p[i] = p_one(r[i], p[i], beta);
}

struct LsmrScalars {
  float c_hb, c_x, c_h, inv_a;
};

__device__ __forceinline__ void lsmr_one(float vh, float& h, float& hb, float& x,
                                         const LsmrScalars& s) {
  const float hv = h;
  hb = __fadd_rn(hv, __fmul_rn(s.c_hb, hb));
  x = __fadd_rn(x, __fmul_rn(s.c_x, hb));
  h = __fadd_rn(__fmul_rn(s.inv_a, vh), __fmul_rn(s.c_h, hv));
}

template <bool VEC>
__global__ void __launch_bounds__(kElemThreads)
lsmr_update_kernel(const float* __restrict__ vh, float* __restrict__ h,
                   float* __restrict__ hbar, float* __restrict__ x,
                   const float* __restrict__ c_hbp, const float* __restrict__ c_xp,
                   const float* __restrict__ c_hp, const float* __restrict__ inv_ap,
                   int64_t n) {
  const LsmrScalars s{*c_hbp, *c_xp, *c_hp, *inv_ap};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (VEC) {
    head = 4 * (n / 4);
    const float4* v4 = reinterpret_cast<const float4*>(vh);
    float4* h4 = reinterpret_cast<float4*>(h);
    float4* b4 = reinterpret_cast<float4*>(hbar);
    float4* x4 = reinterpret_cast<float4*>(x);
    for (int64_t i = t; i < n / 4; i += stride) {
      const float4 vv = v4[i];
      float4 hv = h4[i], bv = b4[i], xv = x4[i];
      lsmr_one(vv.x, hv.x, bv.x, xv.x, s);
      lsmr_one(vv.y, hv.y, bv.y, xv.y, s);
      lsmr_one(vv.z, hv.z, bv.z, xv.z, s);
      lsmr_one(vv.w, hv.w, bv.w, xv.w, s);
      h4[i] = hv;
      b4[i] = bv;
      x4[i] = xv;
    }
  }
  for (int64_t i = head + t; i < n; i += stride) {
    float hv = h[i], bv = hbar[i], xv = x[i];
    lsmr_one(vh[i], hv, bv, xv, s);
    h[i] = hv;
    hbar[i] = bv;
    x[i] = xv;
  }
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
  const unsigned blocks = (unsigned)elem_blocks(n);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* xf = static_cast<float*>(x);
  float* wf = static_cast<float*>(w);
  if (aligned16(x, w, vh)) {
    xw_update_kernel<true><<<blocks, kElemThreads, 0, st>>>(xf, wf, f(vh), f(t1), f(t2),
                                                            f(inv_a), n);
  } else {
    xw_update_kernel<false><<<blocks, kElemThreads, 0, st>>>(xf, wf, f(vh), f(t1), f(t2),
                                                             f(inv_a), n);
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

// Number of f64 partial sums cg_update needs for n elements.
int64_t jt_cg_num_partials(int64_t n) { return elem_blocks(n); }

// K6a. x, r in place; p, q read only; rho a 0-d f32 output. All distinct.
int jt_cg_update(void* x, void* r, const void* p, const void* q, const void* alpha,
                 void* partials, void* rho, int64_t n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t blocks = elem_blocks(n);
  float* xf = static_cast<float*>(x);
  float* rf = static_cast<float*>(r);
  const float* pf = static_cast<const float*>(p);
  const float* qf = static_cast<const float*>(q);
  const float* a = static_cast<const float*>(alpha);
  double* part = static_cast<double*>(partials);
  if (aligned16(x, r, p, q)) {
    cg_update_kernel<true><<<(unsigned)blocks, kElemThreads, 0, st>>>(xf, rf, pf, qf,
                                                                      a, part, n);
  } else {
    cg_update_kernel<false><<<(unsigned)blocks, kElemThreads, 0, st>>>(xf, rf, pf, qf,
                                                                       a, part, n);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<1, kSumThreads, 0, st>>>(part, blocks, static_cast<float*>(rho));
  return (int)cudaGetLastError();
}

// K6b. p in place; r read only, another buffer.
int jt_p_update(const void* r, void* p, const void* beta, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)elem_blocks(n);
  const float* rf = static_cast<const float*>(r);
  float* pf = static_cast<float*>(p);
  const float* b = static_cast<const float*>(beta);
  if (aligned16(r, p)) {
    p_update_kernel<true><<<blocks, kElemThreads, 0, st>>>(rf, pf, b, n);
  } else {
    p_update_kernel<false><<<blocks, kElemThreads, 0, st>>>(rf, pf, b, n);
  }
  return (int)cudaGetLastError();
}

// K7. h, hbar, x in place; vh read only. All distinct.
int jt_lsmr_update(const void* vh, void* h, void* hbar, void* x, const void* c_hb,
                   const void* c_x, const void* c_h, const void* inv_a, int64_t n,
                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)elem_blocks(n);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* hf = static_cast<float*>(h);
  float* bf = static_cast<float*>(hbar);
  float* xf = static_cast<float*>(x);
  if (aligned16(vh, h, hbar, x)) {
    lsmr_update_kernel<true><<<blocks, kElemThreads, 0, st>>>(
        f(vh), hf, bf, xf, f(c_hb), f(c_x), f(c_h), f(inv_a), n);
  } else {
    lsmr_update_kernel<false><<<blocks, kElemThreads, 0, st>>>(
        f(vh), hf, bf, xf, f(c_hb), f(c_x), f(c_h), f(inv_a), n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
