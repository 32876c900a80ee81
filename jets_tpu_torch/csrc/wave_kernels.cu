// Hopper (sm_90a) kernels of the isotropic acoustic wave path: the forward
// leapfrog step (K4), the stored-wavefield adjoint step (K5) and the
// Kosloff constant-Q (visco-acoustic) step (K14).
//
// Built by jets_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded through ctypes, like csrc/solver_kernels.cu: every entry point
// is plain `extern "C"`, takes raw device pointers, sizes as int64 and the
// caller's CUDA stream, launches on that stream without synchronising,
// allocates nothing, and returns cudaGetLastError(). The per-step scalars
// (the wavelet sample s_t, the source amplitude amp, the history scale sc)
// arrive as POINTERS to f32 values in device memory, so a time loop never
// waits on the host.
//
// Rounding contract: every multiply and add is __fmul_rn/__fadd_rn/
// __fsub_rn (no FMA contraction), and the Laplacian keeps the add tree of
// ops/stencil.laplacian_nd at every order:
//   lap = ((c0*3) * c)  then per axis z, y, x, per tap s = 1..hw:
//         (lap + lo) + hi          when the tap coefficient is 1 (order 2)
//         lap + coef*(lo + hi)     otherwise
// with an out-of-grid tap read as exactly +0.0f (the zero padding). The
// kernels are then bitwise equal to their plain versions in
// jets_tpu_torch/ops/cuda_wave.py on the same card.
//
// Bound: device memory. Both kernels do tens of flops per point against
// 16-25 bytes moved, far below the card's balance point. Each thread
// computes one grid point; threads of a warp run along x (the contiguous
// axis) so every load coalesces, and the stencil's neighbour reads are
// served by L1 and the 50 MB L2 (a 256x256 f32 plane is 256 KB), which is
// the Hopper counterpart of the Pallas kernels' double-buffered VMEM slab
// ring with z halos. Staging z-slabs in shared memory with TMA is later
// work. Flat indices are int64, so any grid the launch limits admit works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;  // threads along x (W, contiguous)
constexpr int kBY = 8;   // threads along y (H)

// Second-derivative coefficients of ops/stencil._D2_COEFFS, rounded to f32
// from the same double expressions the Python code evaluates.
template <int ORDER>
struct Stencil;

template <>
struct Stencil<2> {
  static constexpr int HW = 1;
  static constexpr bool UNIT = true;  // the only tap coefficient is 1.0
  __device__ static float center() { return (float)(-2.0 * 3); }
  __device__ static float coef(int) { return 1.0f; }
};

template <>
struct Stencil<4> {
  static constexpr int HW = 2;
  static constexpr bool UNIT = false;
  __device__ static float center() { return (float)((-5.0 / 2.0) * 3); }
  __device__ static float coef(int s) {
    return s == 1 ? (float)(4.0 / 3.0) : (float)(-1.0 / 12.0);
  }
};

template <>
struct Stencil<8> {
  static constexpr int HW = 4;
  static constexpr bool UNIT = false;
  __device__ static float center() { return (float)((-205.0 / 72.0) * 3); }
  __device__ static float coef(int s) {
    return s == 1   ? (float)(8.0 / 5.0)
           : s == 2 ? (float)(-1.0 / 5.0)
           : s == 3 ? (float)(8.0 / 315.0)
                    : (float)(-1.0 / 560.0);
  }
};

template <int ORDER>
__device__ __forceinline__ float tap(float acc, int s, float lo, float hi) {
  if constexpr (Stencil<ORDER>::UNIT) {
    return __fadd_rn(__fadd_rn(acc, lo), hi);
  } else {
    return __fadd_rn(acc, __fmul_rn(Stencil<ORDER>::coef(s), __fadd_rn(lo, hi)));
  }
}

// laplacian_nd's tree at one point; at(dz, dy, dx) returns the field at the
// offset point, or +0.0f outside the grid.
template <int ORDER, class At>
__device__ __forceinline__ float lap_tree(const At& at) {
  constexpr int HW = Stencil<ORDER>::HW;
  float acc = __fmul_rn(Stencil<ORDER>::center(), at(0, 0, 0));
#pragma unroll
  for (int s = 1; s <= HW; ++s) acc = tap<ORDER>(acc, s, at(-s, 0, 0), at(s, 0, 0));
#pragma unroll
  for (int s = 1; s <= HW; ++s) acc = tap<ORDER>(acc, s, at(0, -s, 0), at(0, s, 0));
#pragma unroll
  for (int s = 1; s <= HW; ++s) acc = tap<ORDER>(acc, s, at(0, 0, -s), at(0, 0, s));
  return acc;
}

struct Grid {
  int64_t D, H, W;
  __device__ bool inside(int64_t z, int64_t y, int64_t x) const {
    return z >= 0 && z < D && y >= 0 && y < H && x >= 0 && x < W;
  }
};

// ---------------------------------------------------------------------------
// K4  leapfrog step:
//   u_next = ((2u - u_prev) + c2dt2*L(u)) * ((sz*sy)*sx) + s_t*onehot(src)*amp
//
// Replaces jets_tpu/ops/pallas_wave.py:fused_leapfrog_step (_wave_kernel).
// Four touches of 4 bytes per point: u (stencilled; its neighbours come
// from cache), u_prev, c2dt2, u_next. The sponge is the per-axis factors
// (D + H + W floats, cache-resident) multiplied in registers, and the
// one-hot source is a compare of the flat index, so neither is a full-grid
// read. u_next may be u_prev's buffer: u_prev is read only at the output
// point, by the thread that writes it (so u_prev and out are not
// __restrict__).
// ---------------------------------------------------------------------------

template <int ORDER>
__global__ void __launch_bounds__(kBX * kBY)
leapfrog_kernel(const float* u_prev, const float* __restrict__ u,
                const float* __restrict__ c2, const float* __restrict__ spz,
                const float* __restrict__ sy, const float* __restrict__ sx,
                const float* __restrict__ s_tp, const float* __restrict__ ampp,
                int64_t src, float* out, Grid g) {
  const int64_t ix = (int64_t)blockIdx.x * kBX + threadIdx.x;
  const int64_t iy = (int64_t)blockIdx.y * kBY + threadIdx.y;
  const int64_t iz = blockIdx.z;
  if (ix >= g.W || iy >= g.H) return;
  const int64_t HW = g.H * g.W;
  const int64_t i = (iz * g.H + iy) * g.W + ix;
  auto at = [&](int dz, int dy, int dx) -> float {
    if (!g.inside(iz + dz, iy + dy, ix + dx)) return 0.0f;
    return __ldg(u + i + dz * HW + dy * g.W + dx);
  };
  const float lap = lap_tree<ORDER>(at);
  const float e = __fadd_rn(__fsub_rn(__fmul_rn(2.0f, u[i]), u_prev[i]),
                            __fmul_rn(c2[i], lap));
  const float sponge = __fmul_rn(__fmul_rn(spz[iz], sy[iy]), sx[ix]);
  const float mask = i == src ? *ampp : 0.0f;
  out[i] = __fadd_rn(__fmul_rn(e, sponge), __fmul_rn(*s_tp, mask));
}

// ---------------------------------------------------------------------------
// K5  stored-wavefield adjoint step:
//   ebar   = S*a1,  S = (sz*sy)*sx
//   a_core = (2*ebar + L(c2dt2*ebar)) - S*a2
//   gc2'   = gc2 + L(dec(q))*ebar,   dec(q) = float(q)*sc
//
// Replaces jets_tpu/ops/pallas_wave.py:fused_adjoint_step (_adjoint_kernel).
// Three fields are stencilled: a1 and c2dt2 (through w = c2dt2*ebar,
// recomputed at every tap, as the Pallas kernel does per slice) and the
// history q, read at its stored width (f32, bf16 or int8: an int8 history
// costs a quarter of a touch). a2 and gc2 are read only at the output
// point, which makes writing a_core into a2's buffer and gc2' into gc2's
// safe. About 6.25 touches per point with an int8 history. The receiver
// injection is not part of the kernel (ops/wave.py adds it with index_add_).
// ---------------------------------------------------------------------------

template <typename Q>
__device__ __forceinline__ float to_f32(Q v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t v) { return (float)v; }

template <int ORDER, typename Q>
__global__ void __launch_bounds__(kBX * kBY)
adjoint_kernel(const float* __restrict__ a1, const float* a2, const float* gc2,
               const float* __restrict__ c2, const Q* __restrict__ q,
               const float* __restrict__ scp, const float* __restrict__ spz,
               const float* __restrict__ sy, const float* __restrict__ sx,
               float* core_out, float* gc2_out, Grid g) {
  const int64_t ix = (int64_t)blockIdx.x * kBX + threadIdx.x;
  const int64_t iy = (int64_t)blockIdx.y * kBY + threadIdx.y;
  const int64_t iz = blockIdx.z;
  if (ix >= g.W || iy >= g.H) return;
  const int64_t HW = g.H * g.W;
  const int64_t i = (iz * g.H + iy) * g.W + ix;
  const float sc = *scp;
  auto sponge = [&](int64_t z, int64_t y, int64_t x) -> float {
    return __fmul_rn(__fmul_rn(__ldg(spz + z), __ldg(sy + y)), __ldg(sx + x));
  };
  auto w_at = [&](int dz, int dy, int dx) -> float {
    if (!g.inside(iz + dz, iy + dy, ix + dx)) return 0.0f;
    const int64_t j = i + dz * HW + dy * g.W + dx;
    const float ebar = __fmul_rn(__ldg(a1 + j), sponge(iz + dz, iy + dy, ix + dx));
    return __fmul_rn(__ldg(c2 + j), ebar);
  };
  auto u_at = [&](int dz, int dy, int dx) -> float {
    if (!g.inside(iz + dz, iy + dy, ix + dx)) return 0.0f;
    return __fmul_rn(to_f32<Q>(__ldg(q + i + dz * HW + dy * g.W + dx)), sc);
  };
  const float lap_w = lap_tree<ORDER>(w_at);
  const float lap_u = lap_tree<ORDER>(u_at);
  const float s = sponge(iz, iy, ix);
  const float ebar = __fmul_rn(a1[i], s);
  const float ebar_next = __fmul_rn(a2[i], s);
  const float g_new = __fadd_rn(gc2[i], __fmul_rn(lap_u, ebar));
  const float core = __fsub_rn(__fadd_rn(__fmul_rn(2.0f, ebar), lap_w), ebar_next);
  gc2_out[i] = g_new;
  core_out[i] = core;
}

// ---------------------------------------------------------------------------
// K14  constant-Q step (Kosloff friction, g = gamma*dt = pi*f0*dt/Q):
//   u_next = (((2u - (1-g)*u_prev) + c2dt2*L(u)) * (1/(1+g))) * ((sz*sy)*sx)
//            + s_t*onehot(src)*amp
//
// Replaces jets_tpu/ops/pallas_wave.py:fused_q_step (_q_kernel). K4's
// layout and stencil, plus the friction field g, templated on its stored
// type (f32, or bf16 upcast on load as the TTI kernels upcast their
// coefficients); om1g = 1-g and inv1pg = 1/(1+g) are recomputed per point
// with __fsub_rn/__fdiv_rn, the ops the plain version applies to the same
// upcast field, so the result is bitwise equal to it. Five touches of 4
// bytes per point with an f32 g (u, u_prev, c2dt2, g, u_next), 4.5 with a
// bf16 g. u_next may be u_prev's buffer: u_prev is read only at the output
// point. With g = 0 (Q = inf) every factor is exactly 1 and the step is
// K4's, bit for bit.
// ---------------------------------------------------------------------------

template <int ORDER, typename G>
__global__ void __launch_bounds__(kBX * kBY)
q_step_kernel(const float* u_prev, const float* __restrict__ u,
              const float* __restrict__ c2, const G* __restrict__ gf,
              const float* __restrict__ spz, const float* __restrict__ sy,
              const float* __restrict__ sx, const float* __restrict__ s_tp,
              const float* __restrict__ ampp, int64_t src, float* out, Grid g) {
  const int64_t ix = (int64_t)blockIdx.x * kBX + threadIdx.x;
  const int64_t iy = (int64_t)blockIdx.y * kBY + threadIdx.y;
  const int64_t iz = blockIdx.z;
  if (ix >= g.W || iy >= g.H) return;
  const int64_t HW = g.H * g.W;
  const int64_t i = (iz * g.H + iy) * g.W + ix;
  auto at = [&](int dz, int dy, int dx) -> float {
    if (!g.inside(iz + dz, iy + dy, ix + dx)) return 0.0f;
    return __ldg(u + i + dz * HW + dy * g.W + dx);
  };
  const float lap = lap_tree<ORDER>(at);
  const float gv = to_f32<G>(gf[i]);
  const float om1g = __fsub_rn(1.0f, gv);
  const float inv1pg = __fdiv_rn(1.0f, __fadd_rn(1.0f, gv));
  const float e = __fmul_rn(
      __fadd_rn(__fsub_rn(__fmul_rn(2.0f, u[i]), __fmul_rn(om1g, u_prev[i])),
                __fmul_rn(c2[i], lap)),
      inv1pg);
  const float sponge = __fmul_rn(__fmul_rn(spz[iz], sy[iy]), sx[ix]);
  const float mask = i == src ? *ampp : 0.0f;
  out[i] = __fadd_rn(__fmul_rn(e, sponge), __fmul_rn(*s_tp, mask));
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline dim3 grid_of(const Grid& g) {
  return dim3((unsigned)cdiv(g.W, kBX), (unsigned)cdiv(g.H, kBY), (unsigned)g.D);
}

template <typename Q>
int launch_adjoint(int order, const void* a1, const void* a2, const void* gc2,
                   const void* c2, const void* q, const void* sc,
                   const void* spz, const void* sy, const void* sx,
                   void* core_out, void* gc2_out, Grid g, cudaStream_t st) {
  const dim3 grid = grid_of(g), block(kBX, kBY);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Q* qq = static_cast<const Q*>(q);
  float* co = static_cast<float*>(core_out);
  float* go = static_cast<float*>(gc2_out);
  switch (order) {
    case 2:
      adjoint_kernel<2, Q><<<grid, block, 0, st>>>(f(a1), f(a2), f(gc2), f(c2), qq,
                                                   f(sc), f(spz), f(sy), f(sx), co, go, g);
      break;
    case 4:
      adjoint_kernel<4, Q><<<grid, block, 0, st>>>(f(a1), f(a2), f(gc2), f(c2), qq,
                                                   f(sc), f(spz), f(sy), f(sx), co, go, g);
      break;
    case 8:
      adjoint_kernel<8, Q><<<grid, block, 0, st>>>(f(a1), f(a2), f(gc2), f(c2), qq,
                                                   f(sc), f(spz), f(sy), f(sx), co, go, g);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename G>
int launch_q(int order, const void* u_prev, const void* u, const void* c2,
             const void* gf, const void* spz, const void* sy, const void* sx,
             const void* s_t, const void* amp, int64_t src, void* out, Grid g,
             cudaStream_t st) {
  const dim3 grid = grid_of(g), block(kBX, kBY);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const G* gg = static_cast<const G*>(gf);
  float* o = static_cast<float*>(out);
  switch (order) {
    case 2:
      q_step_kernel<2, G><<<grid, block, 0, st>>>(f(u_prev), f(u), f(c2), gg, f(spz),
                                                  f(sy), f(sx), f(s_t), f(amp), src, o, g);
      break;
    case 4:
      q_step_kernel<4, G><<<grid, block, 0, st>>>(f(u_prev), f(u), f(c2), gg, f(spz),
                                                  f(sy), f(sx), f(s_t), f(amp), src, o, g);
      break;
    case 8:
      q_step_kernel<8, G><<<grid, block, 0, st>>>(f(u_prev), f(u), f(c2), gg, f(spz),
                                                  f(sy), f(sx), f(s_t), f(amp), src, o, g);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K4. out may equal u_prev (in place); u must be another buffer.
int jt_leapfrog_step(const void* u_prev, const void* u, const void* c2,
                     const void* spz, const void* sy, const void* sx,
                     const void* s_t, const void* amp, int64_t src, void* out,
                     int64_t D, int64_t H, int64_t W, int order, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Grid g{D, H, W};
  const dim3 grid = grid_of(g), block(kBX, kBY);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o = static_cast<float*>(out);
  switch (order) {
    case 2:
      leapfrog_kernel<2><<<grid, block, 0, st>>>(f(u_prev), f(u), f(c2), f(spz), f(sy),
                                                 f(sx), f(s_t), f(amp), src, o, g);
      break;
    case 4:
      leapfrog_kernel<4><<<grid, block, 0, st>>>(f(u_prev), f(u), f(c2), f(spz), f(sy),
                                                 f(sx), f(s_t), f(amp), src, o, g);
      break;
    case 8:
      leapfrog_kernel<8><<<grid, block, 0, st>>>(f(u_prev), f(u), f(c2), f(spz), f(sy),
                                                 f(sx), f(s_t), f(amp), src, o, g);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K5. store: 0 = f32, 1 = bf16, 2 = int8 history. core_out may equal a2 and
// gc2_out may equal gc2 (in place); a1, c2 and q must be other buffers.
int jt_adjoint_step(const void* a1, const void* a2, const void* gc2,
                    const void* c2, const void* q, const void* sc,
                    const void* spz, const void* sy, const void* sx,
                    void* core_out, void* gc2_out, int64_t D, int64_t H,
                    int64_t W, int order, int store, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Grid g{D, H, W};
  switch (store) {
    case 0:
      return launch_adjoint<float>(order, a1, a2, gc2, c2, q, sc, spz, sy, sx,
                                   core_out, gc2_out, g, st);
    case 1:
      return launch_adjoint<__nv_bfloat16>(order, a1, a2, gc2, c2, q, sc, spz, sy,
                                           sx, core_out, gc2_out, g, st);
    case 2:
      return launch_adjoint<int8_t>(order, a1, a2, gc2, c2, q, sc, spz, sy, sx,
                                    core_out, gc2_out, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K14. gtype: 0 = f32, 1 = bf16 friction field. out may equal u_prev (in
// place); u, c2 and g must be other buffers.
int jt_q_step(const void* u_prev, const void* u, const void* c2, const void* gf,
              const void* spz, const void* sy, const void* sx, const void* s_t,
              const void* amp, int64_t src, void* out, int64_t D, int64_t H,
              int64_t W, int order, int gtype, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Grid g{D, H, W};
  switch (gtype) {
    case 0:
      return launch_q<float>(order, u_prev, u, c2, gf, spz, sy, sx, s_t, amp, src, out,
                             g, st);
    case 1:
      return launch_q<__nv_bfloat16>(order, u_prev, u, c2, gf, spz, sy, sx, s_t, amp,
                                     src, out, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
