// Hopper (sm_90a) kernels of the VTI pseudo-acoustic wave path: the coupled
// forward step (K8), the same step with the stored-adjoint history encode
// (K9), and the reverse step of the stored-history adjoint (K10).
//
// Built by jets_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded through ctypes, like csrc/wave_kernels.cu: every entry point is
// plain `extern "C"`, takes raw device pointers, sizes as int64 and the
// caller's CUDA stream, launches on that stream without synchronising,
// allocates nothing, and returns cudaGetLastError(). The scalars (wavelet
// sample s_t, source amplitude amp, 1/dx^2, history quantization factors
// and decode scales) arrive as POINTERS to f32 values in device memory, so
// a time loop never waits on the host.
//
// Rounding contract: every multiply and add is __fmul_rn/__fadd_rn/
// __fsub_rn (no FMA contraction), and each second derivative keeps the
// tree of ops/stencil.d2_axis (the JAX package's ops/wave._d2_axis):
//   d2 = (c0*x + sum_s coef_s*(x[+s] + x[-s])) * inv_dx2
// one axis at a time, with Lh = d2_y + d2_x and dzz = d2_z. A tap outside
// the grid reads exactly +0.0f, also for the derived fields of K10 (the
// zero padding of the plain version). The kernels are then bitwise equal
// to their plain versions in jets_tpu_torch/ops/cuda_vti.py on the card.
//
// Bound: device memory. K8 reads p, q (stencilled; neighbours from L1/L2),
// p_prev, q_prev, C = c^2 dt^2, ah = 1+2eps and av = sqrt(1+2delta), and
// writes p_next and q_next: 9 touches of 4 bytes per point for some 60
// flops. K9 adds the history codes of the input p and q (a quarter touch
// each for int8) and one partial max per block. K10 reads ap1, aq1, C, av
// (stencilled), ah, both histories, ap2, aq2 and the three accumulators,
// and writes five fields: about 15.5 touches with int8 histories, ~150
// flops per point. As in K4/K5, one thread computes one grid point, the 32
// threads of a warp run along x (the contiguous axis) so every load
// coalesces, and z-planes go in launch order so the z-neighbour planes of
// the stencils stay in the 50 MB L2 (a 256x256 f32 plane is 256 KB): the
// Hopper counterpart of the Pallas kernels' z-slab DMA rings. The derived
// fields of K10 are recomputed at each tap from cached loads rather than
// staged; shared-memory/TMA staging is later work. Flat indices are int64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;  // threads along x (W, contiguous): one warp
constexpr int kBY = 8;   // threads along y (H)

// Second-derivative coefficients of ops/stencil._D2_COEFFS, (c0, c_s),
// rounded to f32 from the same double expressions the Python code uses.
template <int ORDER>
struct D2;

template <>
struct D2<2> {
  static constexpr int HW = 1;
  __device__ static float c0() { return -2.0f; }
  __device__ static float coef(int) { return 1.0f; }
};

template <>
struct D2<4> {
  static constexpr int HW = 2;
  __device__ static float c0() { return (float)(-5.0 / 2.0); }
  __device__ static float coef(int s) {
    return s == 1 ? (float)(4.0 / 3.0) : (float)(-1.0 / 12.0);
  }
};

template <>
struct D2<8> {
  static constexpr int HW = 4;
  __device__ static float c0() { return (float)(-205.0 / 72.0); }
  __device__ static float coef(int s) {
    return s == 1   ? (float)(8.0 / 5.0)
           : s == 2 ? (float)(-1.0 / 5.0)
           : s == 3 ? (float)(8.0 / 315.0)
                    : (float)(-1.0 / 560.0);
  }
};

// d2_axis's tree at one point: center is the field there, at(s) the field
// at offset s along the axis (+0.0f outside the grid).
template <int ORDER, class At>
__device__ __forceinline__ float d2(float center, const At& at, float inv_dx2) {
  float acc = __fmul_rn(D2<ORDER>::c0(), center);
#pragma unroll
  for (int s = 1; s <= D2<ORDER>::HW; ++s)
    acc = __fadd_rn(acc, __fmul_rn(D2<ORDER>::coef(s), __fadd_rn(at(s), at(-s))));
  return __fmul_rn(acc, inv_dx2);
}

// Two fields that share their loads, stencilled together.
struct F2 {
  float a, b;
};

template <int ORDER, class At>
__device__ __forceinline__ F2 d2_pair(F2 center, const At& at, float inv_dx2) {
  float a = __fmul_rn(D2<ORDER>::c0(), center.a);
  float b = __fmul_rn(D2<ORDER>::c0(), center.b);
#pragma unroll
  for (int s = 1; s <= D2<ORDER>::HW; ++s) {
    const F2 hi = at(s), lo = at(-s);
    a = __fadd_rn(a, __fmul_rn(D2<ORDER>::coef(s), __fadd_rn(hi.a, lo.a)));
    b = __fadd_rn(b, __fmul_rn(D2<ORDER>::coef(s), __fadd_rn(hi.b, lo.b)));
  }
  return F2{__fmul_rn(a, inv_dx2), __fmul_rn(b, inv_dx2)};
}

struct Grid {
  int64_t D, H, W;
};

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline dim3 grid_of(const Grid& g) {
  return dim3((unsigned)cdiv(g.W, kBX), (unsigned)cdiv(g.H, kBY), (unsigned)g.D);
}

// History codes, as ops/wave._store_codec's enc: 0 = f32 (a copy),
// 1 = bf16 (round to nearest even), 2 = int8 (round(v*qf), half to even).
template <int STORE>
__device__ __forceinline__ void put_code(void* out, int64_t i, float v, float qf) {
  if constexpr (STORE == 0) {
    static_cast<float*>(out)[i] = v;
  } else if constexpr (STORE == 1) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<int8_t*>(out)[i] = (int8_t)__float2int_rn(__fmul_rn(v, qf));
  }
}

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

// ---------------------------------------------------------------------------
// K8 / K9  coupled VTI step:
//   e_p = (2p - p_prev) + C*(ah*Lh(p) + av*dzz(q))
//   e_q = (2q - q_prev) + C*(av*Lh(p) + dzz(q))
//   p_next = e_p*((sz*sy)*sx) + s_t*mask,  q_next likewise
// with mask = amp at the flat source index and 0 elsewhere (s_t*mask is
// computed at every point, so its sign of zero is the plain version's).
//
// K8 (STORE < 0) replaces jets_tpu/ops/pallas_wave.py:fused_vti_step and
// K9 (STORE = 0/1/2) fused_vti_hist_step (_vti_kernel with hist=): K9 also
// writes the codes of the INPUT p and q (the snapshot of step k, at the
// one-step-deferred quantization factors qfp/qfq = 127/scale_k) and the
// block's max|p_next| and max|q_next| into partials[0][b] and
// partials[1][b]; the wrapper reduces them into the next step's scales (a
// max is exact in any order). p_next/q_next may be p_prev's/q_prev's
// buffers: those are read only at the output point, by the thread that
// writes it.
// ---------------------------------------------------------------------------

struct StepArgs {
  const float* pp;
  const float* p;
  const float* qp;
  const float* q;
  const float* C;
  const float* ah;
  const float* av;
  const float* spz;
  const float* sy;
  const float* sx;
  const float* s_t;
  const float* amp;
  const float* inv_dx2;
  const float* qfp;
  const float* qfq;
  int64_t src;
  float* pn;
  float* qn;
  void* penc;
  void* qenc;
  float* partials;
};

template <int ORDER, int STORE>
__global__ void __launch_bounds__(kBX * kBY) vti_step_kernel(StepArgs a, Grid g) {
  const int64_t ix = (int64_t)blockIdx.x * kBX + threadIdx.x;
  const int64_t iy = (int64_t)blockIdx.y * kBY + threadIdx.y;
  const int64_t iz = blockIdx.z;
  float mp = 0.0f, mq = 0.0f;
  // no early return: K9's block reduction needs every thread
  if (ix < g.W && iy < g.H) {
    const int64_t HW = g.H * g.W;
    const int64_t i = (iz * g.H + iy) * g.W + ix;
    const float inv = *a.inv_dx2;
    const float pc = __ldg(a.p + i), qc = __ldg(a.q + i);
    auto p_y = [&](int s) -> float {
      const int64_t y = iy + s;
      return (y >= 0 && y < g.H) ? __ldg(a.p + i + s * g.W) : 0.0f;
    };
    auto p_x = [&](int s) -> float {
      const int64_t x = ix + s;
      return (x >= 0 && x < g.W) ? __ldg(a.p + i + s) : 0.0f;
    };
    auto q_z = [&](int s) -> float {
      const int64_t z = iz + s;
      return (z >= 0 && z < g.D) ? __ldg(a.q + i + s * HW) : 0.0f;
    };
    const float lh = __fadd_rn(d2<ORDER>(pc, p_y, inv), d2<ORDER>(pc, p_x, inv));
    const float dz = d2<ORDER>(qc, q_z, inv);
    const float c = __ldg(a.C + i), ah = __ldg(a.ah + i), av = __ldg(a.av + i);
    const float e_p =
        __fadd_rn(__fsub_rn(__fmul_rn(2.0f, pc), a.pp[i]),
                  __fmul_rn(c, __fadd_rn(__fmul_rn(ah, lh), __fmul_rn(av, dz))));
    const float e_q = __fadd_rn(__fsub_rn(__fmul_rn(2.0f, qc), a.qp[i]),
                                __fmul_rn(c, __fadd_rn(__fmul_rn(av, lh), dz)));
    const float sponge =
        __fmul_rn(__fmul_rn(__ldg(a.spz + iz), __ldg(a.sy + iy)), __ldg(a.sx + ix));
    const float src = __fmul_rn(*a.s_t, i == a.src ? *a.amp : 0.0f);
    const float p_next = __fadd_rn(__fmul_rn(e_p, sponge), src);
    const float q_next = __fadd_rn(__fmul_rn(e_q, sponge), src);
    a.pn[i] = p_next;
    a.qn[i] = q_next;
    if constexpr (STORE >= 0) {
      put_code<STORE>(a.penc, i, pc, *a.qfp);
      put_code<STORE>(a.qenc, i, qc, *a.qfq);
      mp = fabsf(p_next);
      mq = fabsf(q_next);
    }
  }
  if constexpr (STORE >= 0) {
    __shared__ float smax[2][kBY];
#pragma unroll
    for (int o = kBX / 2; o > 0; o >>= 1) {
      mp = fmaxf(mp, __shfl_xor_sync(0xffffffffu, mp, o));
      mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, o));
    }
    if (threadIdx.x == 0) {
      smax[0][threadIdx.y] = mp;
      smax[1][threadIdx.y] = mq;
    }
    __syncthreads();
    if (threadIdx.y == 0 && threadIdx.x < 2) {  // thread 0: p, thread 1: q
      float m = 0.0f;
#pragma unroll
      for (int w = 0; w < kBY; ++w) m = fmaxf(m, smax[threadIdx.x][w]);
      const int64_t nb = (int64_t)gridDim.x * gridDim.y * gridDim.z;
      const int64_t b =
          ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      a.partials[threadIdx.x * nb + b] = m;
    }
  }
}

template <int STORE>
int launch_step(int order, const StepArgs& a, const Grid& g, cudaStream_t st) {
  const dim3 grid = grid_of(g), block(kBX, kBY);
  switch (order) {
    case 2:
      vti_step_kernel<2, STORE><<<grid, block, 0, st>>>(a, g);
      break;
    case 4:
      vti_step_kernel<4, STORE><<<grid, block, 0, st>>>(a, g);
      break;
    case 8:
      vti_step_kernel<8, STORE><<<grid, block, 0, st>>>(a, g);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10  VTI stored-history adjoint step (S = (sz*sy)*sx, ebp = S*ap1,
// ebq = S*aq1, p = dec(p_enc) = float(p_enc)*psc, q likewise):
//   gC'  = gC + ((ah*Lh(p) + av*dzz(q))*ebp + (av*Lh(p) + dzz(q))*ebq)
//   gah' = gah + (C*Lh(p))*ebp
//   gav' = gav + C*(dzz(q)*ebp + Lh(p)*ebq)
//   ap_core = ((2*ebp + Lh((C*ah)*ebp)) + Lh((C*av)*ebq)) - S*ap2
//   aq_core = ((2*ebq + dzz((C*av)*ebp)) + dzz(C*ebq)) - S*aq2
//
// Replaces jets_tpu/ops/pallas_wave.py:fused_vti_adjoint_step
// (_vti_adjoint_kernel). Lh is in-plane only and dzz vertical only, so the
// in-plane taps need (C, ah, av, ap1, aq1, sponge) for m1/m2 and the
// p-history, the z taps (C, av, ap1, aq1, sponge) for w3/w4 and the
// q-history; each derived field is recomputed per tap from cached loads
// (m1/m2 and w3/w4 in pairs that share them). ap2, aq2, gC, gah and gav
// are read only at the output point, so ap_core, aq_core and the three
// accumulators may be written into their buffers (in place). The receiver
// injection is not part of the kernel (ops/wave.py adds it with
// index_add_).
// ---------------------------------------------------------------------------

struct AdjArgs {
  const float* ap1;
  const float* aq1;
  const float* ap2;
  const float* aq2;
  const float* gC;
  const float* gah;
  const float* gav;
  const float* C;
  const float* av;
  const float* ah;
  const void* p_enc;
  const void* q_enc;
  const float* psc;
  const float* qsc;
  const float* inv_dx2;
  const float* spz;
  const float* sy;
  const float* sx;
  float* ap_out;
  float* aq_out;
  float* gC_out;
  float* gah_out;
  float* gav_out;
};

template <int ORDER, typename Q>
__global__ void __launch_bounds__(kBX * kBY) vti_adjoint_kernel(AdjArgs a, Grid g) {
  const int64_t ix = (int64_t)blockIdx.x * kBX + threadIdx.x;
  const int64_t iy = (int64_t)blockIdx.y * kBY + threadIdx.y;
  const int64_t iz = blockIdx.z;
  if (ix >= g.W || iy >= g.H) return;
  const int64_t HW = g.H * g.W;
  const int64_t i = (iz * g.H + iy) * g.W + ix;
  const Q* pq = static_cast<const Q*>(a.p_enc);
  const Q* qq = static_cast<const Q*>(a.q_enc);
  const float inv = *a.inv_dx2, psc = *a.psc, qsc = *a.qsc;
  auto sponge = [&](int64_t z, int64_t y, int64_t x) -> float {
    return __fmul_rn(__fmul_rn(__ldg(a.spz + z), __ldg(a.sy + y)), __ldg(a.sx + x));
  };
  // in-plane tap (dy, dx): m1 = (C*ah)*ebp and m2 = (C*av)*ebq
  auto m12 = [&](int dy, int dx) -> F2 {
    const int64_t y = iy + dy, x = ix + dx;
    if (y < 0 || y >= g.H || x < 0 || x >= g.W) return F2{0.0f, 0.0f};
    const int64_t j = i + dy * g.W + dx;
    const float s = sponge(iz, y, x);
    const float c = __ldg(a.C + j);
    return F2{__fmul_rn(__fmul_rn(c, __ldg(a.ah + j)), __fmul_rn(__ldg(a.ap1 + j), s)),
              __fmul_rn(__fmul_rn(c, __ldg(a.av + j)), __fmul_rn(__ldg(a.aq1 + j), s))};
  };
  // z tap dz: w3 = (C*av)*ebp and w4 = C*ebq
  auto w34 = [&](int dz) -> F2 {
    const int64_t z = iz + dz;
    if (z < 0 || z >= g.D) return F2{0.0f, 0.0f};
    const int64_t j = i + dz * HW;
    const float s = sponge(z, iy, ix);
    const float c = __ldg(a.C + j);
    return F2{__fmul_rn(__fmul_rn(c, __ldg(a.av + j)), __fmul_rn(__ldg(a.ap1 + j), s)),
              __fmul_rn(c, __fmul_rn(__ldg(a.aq1 + j), s))};
  };
  auto p_at = [&](int dy, int dx) -> float {
    const int64_t y = iy + dy, x = ix + dx;
    if (y < 0 || y >= g.H || x < 0 || x >= g.W) return 0.0f;
    return __fmul_rn(to_f32<Q>(__ldg(pq + i + dy * g.W + dx)), psc);
  };
  auto q_z = [&](int dz) -> float {
    const int64_t z = iz + dz;
    if (z < 0 || z >= g.D) return 0.0f;
    return __fmul_rn(to_f32<Q>(__ldg(qq + i + dz * HW)), qsc);
  };

  const float s_c = sponge(iz, iy, ix);
  const float ebp = __fmul_rn(__ldg(a.ap1 + i), s_c);
  const float ebq = __fmul_rn(__ldg(a.aq1 + i), s_c);
  const float c = __ldg(a.C + i), ah = __ldg(a.ah + i), av = __ldg(a.av + i);
  const float pc = p_at(0, 0), qc = q_z(0);
  const float lh = __fadd_rn(d2<ORDER>(pc, [&](int s) { return p_at(s, 0); }, inv),
                             d2<ORDER>(pc, [&](int s) { return p_at(0, s); }, inv));
  const float dz = d2<ORDER>(qc, q_z, inv);
  const F2 mc{__fmul_rn(__fmul_rn(c, ah), ebp), __fmul_rn(__fmul_rn(c, av), ebq)};
  const F2 my = d2_pair<ORDER>(mc, [&](int s) { return m12(s, 0); }, inv);
  const F2 mx = d2_pair<ORDER>(mc, [&](int s) { return m12(0, s); }, inv);
  const F2 wc{__fmul_rn(__fmul_rn(c, av), ebp), __fmul_rn(c, ebq)};
  const F2 wz = d2_pair<ORDER>(wc, w34, inv);

  const float gC = __fadd_rn(
      a.gC[i], __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(ah, lh), __fmul_rn(av, dz)), ebp),
                         __fmul_rn(__fadd_rn(__fmul_rn(av, lh), dz), ebq)));
  const float gah = __fadd_rn(a.gah[i], __fmul_rn(__fmul_rn(c, lh), ebp));
  const float gav =
      __fadd_rn(a.gav[i], __fmul_rn(c, __fadd_rn(__fmul_rn(dz, ebp), __fmul_rn(lh, ebq))));
  const float ebp1 = __fmul_rn(a.ap2[i], s_c);
  const float ebq1 = __fmul_rn(a.aq2[i], s_c);
  const float ap = __fsub_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(2.0f, ebp), __fadd_rn(my.a, mx.a)), __fadd_rn(my.b, mx.b)),
      ebp1);
  const float aq =
      __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(2.0f, ebq), wz.a), wz.b), ebq1);
  a.gC_out[i] = gC;
  a.gah_out[i] = gah;
  a.gav_out[i] = gav;
  a.ap_out[i] = ap;
  a.aq_out[i] = aq;
}

template <typename Q>
int launch_adjoint(int order, const AdjArgs& a, const Grid& g, cudaStream_t st) {
  const dim3 grid = grid_of(g), block(kBX, kBY);
  switch (order) {
    case 2:
      vti_adjoint_kernel<2, Q><<<grid, block, 0, st>>>(a, g);
      break;
    case 4:
      vti_adjoint_kernel<4, Q><<<grid, block, 0, st>>>(a, g);
      break;
    case 8:
      vti_adjoint_kernel<8, Q><<<grid, block, 0, st>>>(a, g);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const float* f32(const void* p) { return static_cast<const float*>(p); }
float* f32(void* p) { return static_cast<float*>(p); }

}  // namespace

extern "C" {

const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Number of per-block partial maxima K9 writes for each of p and q.
int64_t jt_vti_num_partials(int64_t D, int64_t H, int64_t W) {
  return cdiv(W, kBX) * cdiv(H, kBY) * D;
}

// K8. pn/qn may equal pp/qp (in place); p, q, C, ah, av must be other
// buffers.
int jt_vti_step(const void* pp, const void* p, const void* qp, const void* q,
                const void* C, const void* ah, const void* av, const void* spz,
                const void* sy, const void* sx, const void* s_t, const void* amp,
                const void* inv_dx2, int64_t src, void* pn, void* qn, int64_t D,
                int64_t H, int64_t W, int order, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const StepArgs a{f32(pp), f32(p),   f32(qp),  f32(q),   f32(C),   f32(ah),
                   f32(av), f32(spz), f32(sy),  f32(sx),  f32(s_t), f32(amp),
                   f32(inv_dx2), nullptr, nullptr, src, f32(pn), f32(qn),
                   nullptr, nullptr, nullptr};
  return launch_step<-1>(order, a, Grid{D, H, W}, static_cast<cudaStream_t>(stream));
}

// K9. As K8, plus penc/qenc (the codes of p and q; store: 0 = f32,
// 1 = bf16, 2 = int8) and partials (2 x jt_vti_num_partials floats).
int jt_vti_hist_step(const void* pp, const void* p, const void* qp, const void* q,
                     const void* C, const void* ah, const void* av, const void* spz,
                     const void* sy, const void* sx, const void* s_t, const void* amp,
                     const void* inv_dx2, const void* qfp, const void* qfq,
                     int64_t src, void* pn, void* qn, void* penc, void* qenc,
                     void* partials, int64_t D, int64_t H, int64_t W, int order,
                     int store, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const StepArgs a{f32(pp), f32(p),   f32(qp),  f32(q),   f32(C),   f32(ah),
                   f32(av), f32(spz), f32(sy),  f32(sx),  f32(s_t), f32(amp),
                   f32(inv_dx2), f32(qfp), f32(qfq), src, f32(pn), f32(qn),
                   penc, qenc, f32(partials)};
  const Grid g{D, H, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (store) {
    case 0:
      return launch_step<0>(order, a, g, st);
    case 1:
      return launch_step<1>(order, a, g, st);
    case 2:
      return launch_step<2>(order, a, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K10. store: 0 = f32, 1 = bf16, 2 = int8 histories (both of one type).
// Each output may equal its input (ap_out = ap2, aq_out = aq2, gC_out = gC,
// gah_out = gah, gav_out = gav); ap1, aq1, C, av, ah and the histories
// must be other buffers.
int jt_vti_adjoint_step(const void* ap1, const void* aq1, const void* ap2,
                        const void* aq2, const void* gC, const void* gah,
                        const void* gav, const void* C, const void* av, const void* ah,
                        const void* p_enc, const void* q_enc, const void* psc,
                        const void* qsc, const void* inv_dx2, const void* spz,
                        const void* sy, const void* sx, void* ap_out, void* aq_out,
                        void* gC_out, void* gah_out, void* gav_out, int64_t D,
                        int64_t H, int64_t W, int order, int store, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const AdjArgs a{f32(ap1), f32(aq1), f32(ap2),     f32(aq2), f32(gC),  f32(gah),
                  f32(gav), f32(C),   f32(av),      f32(ah),  p_enc,    q_enc,
                  f32(psc), f32(qsc), f32(inv_dx2), f32(spz), f32(sy),  f32(sx),
                  f32(ap_out), f32(aq_out), f32(gC_out), f32(gah_out), f32(gav_out)};
  const Grid g{D, H, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (store) {
    case 0:
      return launch_adjoint<float>(order, a, g, st);
    case 1:
      return launch_adjoint<__nv_bfloat16>(order, a, g, st);
    case 2:
      return launch_adjoint<int8_t>(order, a, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
