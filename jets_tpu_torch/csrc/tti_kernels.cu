// Hopper (sm_90a) kernels of the 3-D TTI pseudo-acoustic wave path: the
// coupled forward step (K11), the same step with the stored-adjoint history
// encode (K12), and the reverse step of the stored-history adjoint (K13).
//
// Built by jets_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded through ctypes, like csrc/vti_kernels.cu: every entry point is
// plain `extern "C"`, takes raw device pointers, sizes as int64 and the
// caller's CUDA stream, launches on that stream without synchronising,
// allocates nothing, and returns cudaGetLastError(). The scalars (s_t, amp,
// 1/dx^2, 1/dx, history quantization factors and decode scales) arrive as
// POINTERS to f32 values in device memory. The five coefficient fields
// ah = 1+2eps, av = sqrt(1+2delta) and the symmetry axis (nz, ny, nx) are
// f32 or bf16 (coeff = 0 / 1), upcast on load; C = c^2 dt^2 is f32.
//
// Rounding contract: every multiply and add is __fmul_rn/__fadd_rn/
// __fsub_rn (no FMA contraction), in the trees of ops/stencil.d2_axis
//   d2 = (c0*x + sum_s c_s*(x[+s] + x[-s])) * inv_dx2
// and ops/stencil.d1_axis
//   d1 = (c_1*(x[+1] - x[-1]) + sum_{s>1} c_s*(x[+s] - x[-s])) * inv_dx
// with the cross derivatives composed as d_zy = d1_y(d1_z(u)),
// d_zx = d1_x(d1_z(u)) and d_yx = d1_x(d1_y(u)). A tap outside the grid
// reads exactly +0.0f, and so does an intermediate first difference whose
// point lies outside the grid (the plain version pads the intermediate
// field with zeros; it never clamps). The direction coefficients are
// rebuilt from the upcast axis as czz = nz*nz, czy = (2*nz)*ny, ... and
// (1 - czz) is an explicit subtraction, so they equal the plain route's
// fields bit for bit. The kernels are then bitwise equal to their plain
// versions in jets_tpu_torch/ops/cuda_tti.py on the card.
//
// Layout: one thread per output point, a block of 32 (x) by 8 (y) threads
// on one z-plane per gridDim.z, as K4-K10. The six derivatives of a field
// need its values on the block's (y, x) tile plus a halo of ORDER/2 points
// and its first z-difference there, so each block first stages those
// planes in shared memory (phase 1: one tile-plus-halo point per thread at
// a time, z taps from L1/L2), then the in-plane first y-difference of the
// tile rows over the halo columns (phase 2), then computes its points from
// shared memory alone (phase 3). The TPU kernels' z-slab DMA rings become
// the launch order of the z-planes, whose neighbours stay in the 50 MB L2.
//
// Bound: device memory. K11 reads p, q, p_prev, q_prev and C (f32) and the
// five coefficient fields, and writes p_next, q_next: 12 touches of 4 bytes
// per point with f32 coefficients, 9.5 with bf16, for ~200 flops. K12 adds
// the two history codes (a quarter touch each for int8). K13 reads ap1,
// aq1, ap2, aq2, C, the six accumulators, the five coefficients and the two
// histories and writes eight fields: 24.5 touches with int8 histories and
// f32 coefficients. Its transposed operators need the weight fields
// w12 = C*ah*ebp + C*av*ebq and w34 = C*av*ebp + C*ebq, times the direction
// coefficients, on the tile plus halo and their first z-difference there:
// phase 1 evaluates each weight at 2*ORDER/2 z offsets per halo point (the
// TPU kernel likewise rebuilds its window lists once per z), about 10 cached
// loads per evaluation, which makes K13 bound by the L1/L2 traffic of that
// recompute rather than by device memory. A z-marching block that keeps a
// ring of weight planes would evaluate each weight once; that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;  // threads along x (W, contiguous): one warp
constexpr int kBY = 8;   // threads along y (H)
constexpr int kThreads = kBX * kBY;

// Stencil taps of ops/stencil._D2_COEFFS (c0, c_s) and _D1_COEFFS (c_s),
// rounded to f32 from the same double expressions the Python code uses.
template <int ORDER>
struct St;

template <>
struct St<2> {
  static constexpr int HW = 1;
  __device__ static float c0() { return -2.0f; }
  __device__ static float d2(int) { return 1.0f; }
  __device__ static float d1(int) { return 0.5f; }
};

template <>
struct St<4> {
  static constexpr int HW = 2;
  __device__ static float c0() { return (float)(-5.0 / 2.0); }
  __device__ static float d2(int s) {
    return s == 1 ? (float)(4.0 / 3.0) : (float)(-1.0 / 12.0);
  }
  __device__ static float d1(int s) {
    return s == 1 ? (float)(2.0 / 3.0) : (float)(-1.0 / 12.0);
  }
};

template <>
struct St<8> {
  static constexpr int HW = 4;
  __device__ static float c0() { return (float)(-205.0 / 72.0); }
  __device__ static float d2(int s) {
    return s == 1   ? (float)(8.0 / 5.0)
           : s == 2 ? (float)(-1.0 / 5.0)
           : s == 3 ? (float)(8.0 / 315.0)
                    : (float)(-1.0 / 560.0);
  }
  __device__ static float d1(int s) {
    return s == 1   ? (float)(4.0 / 5.0)
           : s == 2 ? (float)(-1.0 / 5.0)
           : s == 3 ? (float)(4.0 / 105.0)
                    : (float)(-1.0 / 280.0);
  }
};

// d2_axis's tree at one point: center is the field there, at(s) the field
// at offset s along the axis (+0.0f outside the grid).
template <int ORDER, class At>
__device__ __forceinline__ float d2(float center, const At& at, float inv_dx2) {
  float acc = __fmul_rn(St<ORDER>::c0(), center);
#pragma unroll
  for (int s = 1; s <= St<ORDER>::HW; ++s)
    acc = __fadd_rn(acc, __fmul_rn(St<ORDER>::d2(s), __fadd_rn(at(s), at(-s))));
  return __fmul_rn(acc, inv_dx2);
}

// d1_axis's tree at one point.
template <int ORDER, class At>
__device__ __forceinline__ float d1(const At& at, float inv_dx) {
  float acc = __fmul_rn(St<ORDER>::d1(1), __fsub_rn(at(1), at(-1)));
#pragma unroll
  for (int s = 2; s <= St<ORDER>::HW; ++s)
    acc = __fadd_rn(acc, __fmul_rn(St<ORDER>::d1(s), __fsub_rn(at(s), at(-s))));
  return __fmul_rn(acc, inv_dx);
}

// The six derivatives of a field at a point: zz, yy, xx, zy, zx, yx.
struct D6 {
  float zz, yy, xx, zy, zx, yx;
};

// The six direction coefficients nz*nz, ny*ny, nx*nx, (2nz)*ny, (2nz)*nx,
// (2ny)*nx.
struct Dir {
  float zz, yy, xx, zy, zx, yx;
};

__device__ __forceinline__ Dir directions(float nz, float ny, float nx) {
  return Dir{__fmul_rn(nz, nz),
             __fmul_rn(ny, ny),
             __fmul_rn(nx, nx),
             __fmul_rn(__fmul_rn(2.0f, nz), ny),
             __fmul_rn(__fmul_rn(2.0f, nz), nx),
             __fmul_rn(__fmul_rn(2.0f, ny), nx)};
}

// H = (1-czz)*uzz + (1-cyy)*uyy + (1-cxx)*uxx - czy*uzy - czx*uzx - cyx*uyx
__device__ __forceinline__ float h_of(const D6& d, const Dir& c) {
  float h = __fmul_rn(__fsub_rn(1.0f, c.zz), d.zz);
  h = __fadd_rn(h, __fmul_rn(__fsub_rn(1.0f, c.yy), d.yy));
  h = __fadd_rn(h, __fmul_rn(__fsub_rn(1.0f, c.xx), d.xx));
  h = __fsub_rn(h, __fmul_rn(c.zy, d.zy));
  h = __fsub_rn(h, __fmul_rn(c.zx, d.zx));
  return __fsub_rn(h, __fmul_rn(c.yx, d.yx));
}

// V = czz*uzz + cyy*uyy + cxx*uxx + czy*uzy + czx*uzx + cyx*uyx
__device__ __forceinline__ float v_of(const D6& d, const Dir& c) {
  float v = __fmul_rn(c.zz, d.zz);
  v = __fadd_rn(v, __fmul_rn(c.yy, d.yy));
  v = __fadd_rn(v, __fmul_rn(c.xx, d.xx));
  v = __fadd_rn(v, __fmul_rn(c.zy, d.zy));
  v = __fadd_rn(v, __fmul_rn(c.zx, d.zx));
  return __fadd_rn(v, __fmul_rn(c.yx, d.yx));
}

struct Grid {
  int64_t D, H, W;
};

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline dim3 grid_of(const Grid& g) {
  return dim3((unsigned)cdiv(g.W, kBX), (unsigned)cdiv(g.H, kBY), (unsigned)g.D);
}

// A coefficient field's value as f32 (CT = float or __nv_bfloat16).
template <typename CT>
__device__ __forceinline__ float ldc(const void* p, int64_t i);
template <>
__device__ __forceinline__ float ldc<float>(const void* p, int64_t i) {
  return __ldg(static_cast<const float*>(p) + i);
}
template <>
__device__ __forceinline__ float ldc<__nv_bfloat16>(const void* p, int64_t i) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
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
// K11 / K12  coupled TTI step:
//   e_p = (2p - p_prev) + C*(ah*H(p) + av*V(q))
//   e_q = (2q - q_prev) + C*(av*H(p) + V(q))
//   p_next = e_p*((sz*sy)*sx) + s_t*mask,  q_next likewise
// with mask = amp at the flat source index and 0 elsewhere.
//
// K11 (STORE < 0) replaces jets_tpu/ops/pallas_wave.py:fused_tti_step and
// K12 (STORE = 0/1/2) fused_tti_hist_step (_tti_kernel with hist=): K12 also
// writes the codes of the INPUT p and q (at the one-step-deferred
// quantization factors qfp/qfq = 127/scale_k) and the block's max|p_next|
// and max|q_next| into partials[0][b] and partials[1][b], reduced by the
// wrapper into the next step's scales. p_next/q_next may be p_prev's/
// q_prev's buffers: those are read only at the output point, by the thread
// that writes it.
// ---------------------------------------------------------------------------

struct StepArgs {
  const float* pp;
  const float* p;
  const float* qp;
  const float* q;
  const float* C;
  const void* ah;
  const void* av;
  const void* nz;
  const void* ny;
  const void* nx;
  const float* spz;
  const float* sy;
  const float* sx;
  const float* s_t;
  const float* amp;
  const float* inv_dx2;
  const float* inv_dx;
  const float* qfp;
  const float* qfq;
  int64_t src;
  float* pn;
  float* qn;
  void* penc;
  void* qenc;
  float* partials;
};

template <int ORDER, typename CT, int STORE>
__global__ void __launch_bounds__(kThreads) tti_step_kernel(StepArgs a, Grid g) {
  constexpr int HW = St<ORDER>::HW, SY = kBY + 2 * HW, SX = kBX + 2 * HW;
  // the fields and their first z-difference on the tile plus halo, and
  // their first y-difference on the tile rows over the halo columns
  __shared__ float sP[SY][SX], sQ[SY][SX], sGP[SY][SX], sGQ[SY][SX];
  __shared__ float sYP[kBY][SX], sYQ[kBY][SX];
  const int tid = threadIdx.y * kBX + threadIdx.x;
  const int64_t x0 = (int64_t)blockIdx.x * kBX, y0 = (int64_t)blockIdx.y * kBY;
  const int64_t iz = blockIdx.z, plane = g.H * g.W;
  const float inv2 = *a.inv_dx2, inv1 = *a.inv_dx;

  for (int t = tid; t < SY * SX; t += kThreads) {  // phase 1
    const int ly = t / SX, lx = t % SX;
    const int64_t y = y0 + ly - HW, x = x0 + lx - HW;
    float pv = 0.0f, qv = 0.0f, gp = 0.0f, gq = 0.0f;
    if (y >= 0 && y < g.H && x >= 0 && x < g.W) {
      const int64_t j = (iz * g.H + y) * g.W + x;
      pv = __ldg(a.p + j);
      qv = __ldg(a.q + j);
      gp = d1<ORDER>(
          [&](int s) -> float {
            const int64_t z = iz + s;
            return (z >= 0 && z < g.D) ? __ldg(a.p + j + s * plane) : 0.0f;
          },
          inv1);
      gq = d1<ORDER>(
          [&](int s) -> float {
            const int64_t z = iz + s;
            return (z >= 0 && z < g.D) ? __ldg(a.q + j + s * plane) : 0.0f;
          },
          inv1);
    }
    sP[ly][lx] = pv;
    sQ[ly][lx] = qv;
    sGP[ly][lx] = gp;
    sGQ[ly][lx] = gq;
  }
  __syncthreads();
  for (int t = tid; t < kBY * SX; t += kThreads) {  // phase 2
    const int ly = t / SX, lx = t % SX;
    const int64_t y = y0 + ly, x = x0 + lx - HW;
    float yp = 0.0f, yq = 0.0f;
    if (y < g.H && x >= 0 && x < g.W) {
      yp = d1<ORDER>([&](int s) { return sP[ly + HW + s][lx]; }, inv1);
      yq = d1<ORDER>([&](int s) { return sQ[ly + HW + s][lx]; }, inv1);
    }
    sYP[ly][lx] = yp;
    sYQ[ly][lx] = yq;
  }
  __syncthreads();

  const int ty = threadIdx.y, tx = threadIdx.x, cy = ty + HW, cx = tx + HW;
  const int64_t ix = x0 + tx, iy = y0 + ty;
  float mp = 0.0f, mq = 0.0f;
  // no early return: K12's block reduction needs every thread
  if (ix < g.W && iy < g.H) {  // phase 3
    const int64_t i = (iz * g.H + iy) * g.W + ix;
    const float pc = sP[cy][cx], qc = sQ[cy][cx];
    auto z_tap = [&](const float* u) {
      return [&, u](int s) -> float {
        const int64_t z = iz + s;
        return (z >= 0 && z < g.D) ? __ldg(u + i + s * plane) : 0.0f;
      };
    };
    const D6 dp{d2<ORDER>(pc, z_tap(a.p), inv2),
                d2<ORDER>(pc, [&](int s) { return sP[cy + s][cx]; }, inv2),
                d2<ORDER>(pc, [&](int s) { return sP[cy][cx + s]; }, inv2),
                d1<ORDER>([&](int s) { return sGP[cy + s][cx]; }, inv1),
                d1<ORDER>([&](int s) { return sGP[cy][cx + s]; }, inv1),
                d1<ORDER>([&](int s) { return sYP[ty][cx + s]; }, inv1)};
    const D6 dq{d2<ORDER>(qc, z_tap(a.q), inv2),
                d2<ORDER>(qc, [&](int s) { return sQ[cy + s][cx]; }, inv2),
                d2<ORDER>(qc, [&](int s) { return sQ[cy][cx + s]; }, inv2),
                d1<ORDER>([&](int s) { return sGQ[cy + s][cx]; }, inv1),
                d1<ORDER>([&](int s) { return sGQ[cy][cx + s]; }, inv1),
                d1<ORDER>([&](int s) { return sYQ[ty][cx + s]; }, inv1)};
    const Dir cf = directions(ldc<CT>(a.nz, i), ldc<CT>(a.ny, i), ldc<CT>(a.nx, i));
    const float hp = h_of(dp, cf), vq = v_of(dq, cf);
    const float c = __ldg(a.C + i), ah = ldc<CT>(a.ah, i), av = ldc<CT>(a.av, i);
    const float e_p =
        __fadd_rn(__fsub_rn(__fmul_rn(2.0f, pc), a.pp[i]),
                  __fmul_rn(c, __fadd_rn(__fmul_rn(ah, hp), __fmul_rn(av, vq))));
    const float e_q = __fadd_rn(__fsub_rn(__fmul_rn(2.0f, qc), a.qp[i]),
                                __fmul_rn(c, __fadd_rn(__fmul_rn(av, hp), vq)));
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

template <typename CT, int STORE>
int launch_step(int order, const StepArgs& a, const Grid& g, cudaStream_t st) {
  const dim3 grid = grid_of(g), block(kBX, kBY);
  switch (order) {
    case 2:
      tti_step_kernel<2, CT, STORE><<<grid, block, 0, st>>>(a, g);
      break;
    case 4:
      tti_step_kernel<4, CT, STORE><<<grid, block, 0, st>>>(a, g);
      break;
    case 8:
      tti_step_kernel<8, CT, STORE><<<grid, block, 0, st>>>(a, g);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int STORE>
int launch_step_coeff(int order, int coeff, const StepArgs& a, const Grid& g,
                      cudaStream_t st) {
  switch (coeff) {
    case 0:
      return launch_step<float, STORE>(order, a, g, st);
    case 1:
      return launch_step<__nv_bfloat16, STORE>(order, a, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K13  TTI stored-history adjoint step (S = (sz*sy)*sx, ebp = S*ap1,
// ebq = S*aq1, p = float(p_enc)*psc, q likewise, Hp = H(p), Vq = V(q)):
//   gC'  = gC + ((ah*Hp + av*Vq)*ebp + (av*Hp + Vq)*ebq)
//   gah' = gah + (C*Hp)*ebp
//   gav' = gav + C*(Vq*ebp + Hp*ebq)
//   dc_d = C*((av*q_d - ah*p_d)*ebp + (q_d - av*p_d)*ebq)   (d = zz..yx)
//   gnz' = gnz + ((2nz)*dc_zz + (2ny)*dc_zy + (2nx)*dc_zx)
//   gny' = gny + ((2ny)*dc_yy + (2nz)*dc_zy + (2nx)*dc_yx)
//   gnx' = gnx + ((2nx)*dc_xx + (2nz)*dc_zx + (2ny)*dc_yx)
//   ap_core = (2*ebp + HT(w12)) - S*ap2,  w12 = (C*ah)*ebp + (C*av)*ebq
//   aq_core = (2*ebq + VT(w34)) - S*aq2,  w34 = (C*av)*ebp + C*ebq
// with HT(w) = d2z((1-czz)w) + d2y((1-cyy)w) + d2x((1-cxx)w)
//              - d1y(d1z(czy w)) - d1x(d1z(czx w)) - d1x(d1y(cyx w))
// and VT(w) the same with czz, cyy, cxx and + signs: each transposed
// operator applied once, on the summed weight field.
//
// Replaces jets_tpu/ops/pallas_wave.py:fused_tti_adjoint_step
// (_tti_adjoint_kernel). Phase 1 stages, on the tile plus halo: both decoded
// histories and their first z-difference, w12, w34, ny, nx and the first
// z-differences of czy*w12, czx*w12, czy*w34, czx*w34; points of the tile
// itself also keep the z second differences of p, q, (1-czz)*w12 and
// czz*w34. Phase 2 stages the first y-differences of p, q, cyx*w12 and
// cyx*w34. ap2, aq2 and the six accumulators are read only at the output
// point, so the outputs may be written into their buffers (in place). The
// receiver injection is not part of the kernel (ops/wave.py adds it with
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
  const float* gnz;
  const float* gny;
  const float* gnx;
  const float* C;
  const void* ah;
  const void* av;
  const void* nz;
  const void* ny;
  const void* nx;
  const void* p_enc;
  const void* q_enc;
  const float* psc;
  const float* qsc;
  const float* inv_dx2;
  const float* inv_dx;
  const float* spz;
  const float* sy;
  const float* sx;
  float* ap_out;
  float* aq_out;
  float* gC_out;
  float* gah_out;
  float* gav_out;
  float* gnz_out;
  float* gny_out;
  float* gnx_out;
};

// The derived values of K13 at one grid point (all +0.0f outside the grid,
// the zero padding of the plain version's product fields).
struct Win {
  float p, q, w12, w34, nz, ny, nx;
};

template <int ORDER, typename CT, typename Q>
__global__ void __launch_bounds__(kThreads) tti_adjoint_kernel(AdjArgs a, Grid g) {
  constexpr int HW = St<ORDER>::HW, SY = kBY + 2 * HW, SX = kBX + 2 * HW;
  __shared__ float sP[SY][SX], sQ[SY][SX], sGP[SY][SX], sGQ[SY][SX];
  __shared__ float sW12[SY][SX], sW34[SY][SX], sNY[SY][SX], sNX[SY][SX];
  __shared__ float sG12y[SY][SX], sG12x[SY][SX], sG34y[SY][SX], sG34x[SY][SX];
  __shared__ float sYP[kBY][SX], sYQ[kBY][SX], sY12[kBY][SX], sY34[kBY][SX];
  __shared__ float sZ[4][kBY][kBX];  // d2z of p, q, (1-czz)*w12, czz*w34
  const int tid = threadIdx.y * kBX + threadIdx.x;
  const int64_t x0 = (int64_t)blockIdx.x * kBX, y0 = (int64_t)blockIdx.y * kBY;
  const int64_t iz = blockIdx.z, plane = g.H * g.W;
  const float inv2 = *a.inv_dx2, inv1 = *a.inv_dx, psc = *a.psc, qsc = *a.qsc;
  const Q* pq = static_cast<const Q*>(a.p_enc);
  const Q* qq = static_cast<const Q*>(a.q_enc);

  // the derived values at (z, y, x), flat index j, inside the grid
  auto win = [&](int64_t j, int64_t z, int64_t y, int64_t x) -> Win {
    const float s =
        __fmul_rn(__fmul_rn(__ldg(a.spz + z), __ldg(a.sy + y)), __ldg(a.sx + x));
    const float ebp = __fmul_rn(__ldg(a.ap1 + j), s);
    const float ebq = __fmul_rn(__ldg(a.aq1 + j), s);
    const float c = __ldg(a.C + j);
    const float cav = __fmul_rn(c, ldc<CT>(a.av, j));
    return Win{__fmul_rn(to_f32<Q>(pq[j]), psc),
               __fmul_rn(to_f32<Q>(qq[j]), qsc),
               __fadd_rn(__fmul_rn(__fmul_rn(c, ldc<CT>(a.ah, j)), ebp),
                         __fmul_rn(cav, ebq)),
               __fadd_rn(__fmul_rn(cav, ebp), __fmul_rn(c, ebq)),
               ldc<CT>(a.nz, j),
               ldc<CT>(a.ny, j),
               ldc<CT>(a.nx, j)};
  };

  for (int t = tid; t < SY * SX; t += kThreads) {  // phase 1
    const int ly = t / SX, lx = t % SX;
    const int64_t y = y0 + ly - HW, x = x0 + lx - HW;
    Win w0{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float gp = 0.0f, gq = 0.0f, g12y = 0.0f, g12x = 0.0f, g34y = 0.0f, g34x = 0.0f;
    float zp = 0.0f, zq = 0.0f, z12 = 0.0f, z34 = 0.0f;
    if (y >= 0 && y < g.H && x >= 0 && x < g.W) {
      const int64_t j = (iz * g.H + y) * g.W + x;
      w0 = win(j, iz, y, x);
      const float czz0 = __fmul_rn(w0.nz, w0.nz);
      zp = __fmul_rn(St<ORDER>::c0(), w0.p);
      zq = __fmul_rn(St<ORDER>::c0(), w0.q);
      z12 = __fmul_rn(St<ORDER>::c0(), __fmul_rn(__fsub_rn(1.0f, czz0), w0.w12));
      z34 = __fmul_rn(St<ORDER>::c0(), __fmul_rn(czz0, w0.w34));
#pragma unroll
      for (int s = 1; s <= HW; ++s) {
        Win hi{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, lo = hi;
        if (iz + s < g.D) hi = win(j + s * plane, iz + s, y, x);
        if (iz - s >= 0) lo = win(j - s * plane, iz - s, y, x);
        const float zy_h = __fmul_rn(__fmul_rn(2.0f, hi.nz), hi.ny);
        const float zy_l = __fmul_rn(__fmul_rn(2.0f, lo.nz), lo.ny);
        const float zx_h = __fmul_rn(__fmul_rn(2.0f, hi.nz), hi.nx);
        const float zx_l = __fmul_rn(__fmul_rn(2.0f, lo.nz), lo.nx);
        const float zz_h = __fmul_rn(hi.nz, hi.nz), zz_l = __fmul_rn(lo.nz, lo.nz);
        const float c1 = St<ORDER>::d1(s), c2 = St<ORDER>::d2(s);
        const float tp = __fmul_rn(c1, __fsub_rn(hi.p, lo.p));
        const float tq = __fmul_rn(c1, __fsub_rn(hi.q, lo.q));
        const float t12y =
            __fmul_rn(c1, __fsub_rn(__fmul_rn(zy_h, hi.w12), __fmul_rn(zy_l, lo.w12)));
        const float t12x =
            __fmul_rn(c1, __fsub_rn(__fmul_rn(zx_h, hi.w12), __fmul_rn(zx_l, lo.w12)));
        const float t34y =
            __fmul_rn(c1, __fsub_rn(__fmul_rn(zy_h, hi.w34), __fmul_rn(zy_l, lo.w34)));
        const float t34x =
            __fmul_rn(c1, __fsub_rn(__fmul_rn(zx_h, hi.w34), __fmul_rn(zx_l, lo.w34)));
        if (s == 1) {
          gp = tp;
          gq = tq;
          g12y = t12y;
          g12x = t12x;
          g34y = t34y;
          g34x = t34x;
        } else {
          gp = __fadd_rn(gp, tp);
          gq = __fadd_rn(gq, tq);
          g12y = __fadd_rn(g12y, t12y);
          g12x = __fadd_rn(g12x, t12x);
          g34y = __fadd_rn(g34y, t34y);
          g34x = __fadd_rn(g34x, t34x);
        }
        zp = __fadd_rn(zp, __fmul_rn(c2, __fadd_rn(hi.p, lo.p)));
        zq = __fadd_rn(zq, __fmul_rn(c2, __fadd_rn(hi.q, lo.q)));
        z12 = __fadd_rn(z12, __fmul_rn(c2, __fadd_rn(
                                               __fmul_rn(__fsub_rn(1.0f, zz_h), hi.w12),
                                               __fmul_rn(__fsub_rn(1.0f, zz_l), lo.w12))));
        z34 = __fadd_rn(z34, __fmul_rn(c2, __fadd_rn(__fmul_rn(zz_h, hi.w34),
                                                     __fmul_rn(zz_l, lo.w34))));
      }
      gp = __fmul_rn(gp, inv1);
      gq = __fmul_rn(gq, inv1);
      g12y = __fmul_rn(g12y, inv1);
      g12x = __fmul_rn(g12x, inv1);
      g34y = __fmul_rn(g34y, inv1);
      g34x = __fmul_rn(g34x, inv1);
    }
    sP[ly][lx] = w0.p;
    sQ[ly][lx] = w0.q;
    sW12[ly][lx] = w0.w12;
    sW34[ly][lx] = w0.w34;
    sNY[ly][lx] = w0.ny;
    sNX[ly][lx] = w0.nx;
    sGP[ly][lx] = gp;
    sGQ[ly][lx] = gq;
    sG12y[ly][lx] = g12y;
    sG12x[ly][lx] = g12x;
    sG34y[ly][lx] = g34y;
    sG34x[ly][lx] = g34x;
    if (ly >= HW && ly < HW + kBY && lx >= HW && lx < HW + kBX) {
      sZ[0][ly - HW][lx - HW] = __fmul_rn(zp, inv2);
      sZ[1][ly - HW][lx - HW] = __fmul_rn(zq, inv2);
      sZ[2][ly - HW][lx - HW] = __fmul_rn(z12, inv2);
      sZ[3][ly - HW][lx - HW] = __fmul_rn(z34, inv2);
    }
  }
  __syncthreads();
  for (int t = tid; t < kBY * SX; t += kThreads) {  // phase 2
    const int ly = t / SX, lx = t % SX, r = ly + HW;
    const int64_t y = y0 + ly, x = x0 + lx - HW;
    float yp = 0.0f, yq = 0.0f, y12 = 0.0f, y34 = 0.0f;
    if (y < g.H && x >= 0 && x < g.W) {
      yp = d1<ORDER>([&](int s) { return sP[r + s][lx]; }, inv1);
      yq = d1<ORDER>([&](int s) { return sQ[r + s][lx]; }, inv1);
      auto cyx = [&](int s) {
        return __fmul_rn(__fmul_rn(2.0f, sNY[r + s][lx]), sNX[r + s][lx]);
      };
      y12 = d1<ORDER>([&](int s) { return __fmul_rn(cyx(s), sW12[r + s][lx]); }, inv1);
      y34 = d1<ORDER>([&](int s) { return __fmul_rn(cyx(s), sW34[r + s][lx]); }, inv1);
    }
    sYP[ly][lx] = yp;
    sYQ[ly][lx] = yq;
    sY12[ly][lx] = y12;
    sY34[ly][lx] = y34;
  }
  __syncthreads();

  const int ty = threadIdx.y, tx = threadIdx.x, cy = ty + HW, cx = tx + HW;
  const int64_t ix = x0 + tx, iy = y0 + ty;
  if (ix >= g.W || iy >= g.H) return;  // phase 3 (no barrier follows)
  const int64_t i = (iz * g.H + iy) * g.W + ix;
  const float pc = sP[cy][cx], qc = sQ[cy][cx];
  const D6 dp{sZ[0][ty][tx],
              d2<ORDER>(pc, [&](int s) { return sP[cy + s][cx]; }, inv2),
              d2<ORDER>(pc, [&](int s) { return sP[cy][cx + s]; }, inv2),
              d1<ORDER>([&](int s) { return sGP[cy + s][cx]; }, inv1),
              d1<ORDER>([&](int s) { return sGP[cy][cx + s]; }, inv1),
              d1<ORDER>([&](int s) { return sYP[ty][cx + s]; }, inv1)};
  const D6 dq{sZ[1][ty][tx],
              d2<ORDER>(qc, [&](int s) { return sQ[cy + s][cx]; }, inv2),
              d2<ORDER>(qc, [&](int s) { return sQ[cy][cx + s]; }, inv2),
              d1<ORDER>([&](int s) { return sGQ[cy + s][cx]; }, inv1),
              d1<ORDER>([&](int s) { return sGQ[cy][cx + s]; }, inv1),
              d1<ORDER>([&](int s) { return sYQ[ty][cx + s]; }, inv1)};
  const float nz = ldc<CT>(a.nz, i), ny = sNY[cy][cx], nx = sNX[cy][cx];
  const Dir cf = directions(nz, ny, nx);
  const float hp = h_of(dp, cf), vq = v_of(dq, cf);
  const float s_c =
      __fmul_rn(__fmul_rn(__ldg(a.spz + iz), __ldg(a.sy + iy)), __ldg(a.sx + ix));
  const float ebp = __fmul_rn(__ldg(a.ap1 + i), s_c);
  const float ebq = __fmul_rn(__ldg(a.aq1 + i), s_c);
  const float c = __ldg(a.C + i), ah = ldc<CT>(a.ah, i), av = ldc<CT>(a.av, i);

  a.gC_out[i] = __fadd_rn(
      a.gC[i], __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(ah, hp), __fmul_rn(av, vq)), ebp),
                         __fmul_rn(__fadd_rn(__fmul_rn(av, hp), vq), ebq)));
  a.gah_out[i] = __fadd_rn(a.gah[i], __fmul_rn(__fmul_rn(c, hp), ebp));
  a.gav_out[i] =
      __fadd_rn(a.gav[i], __fmul_rn(c, __fadd_rn(__fmul_rn(vq, ebp), __fmul_rn(hp, ebq))));
  auto dc = [&](float p_d, float q_d) {
    return __fmul_rn(
        c, __fadd_rn(__fmul_rn(__fsub_rn(__fmul_rn(av, q_d), __fmul_rn(ah, p_d)), ebp),
                     __fmul_rn(__fsub_rn(q_d, __fmul_rn(av, p_d)), ebq)));
  };
  const float dzz = dc(dp.zz, dq.zz), dyy = dc(dp.yy, dq.yy), dxx = dc(dp.xx, dq.xx);
  const float dzy = dc(dp.zy, dq.zy), dzx = dc(dp.zx, dq.zx), dyx = dc(dp.yx, dq.yx);
  const float nz2 = __fmul_rn(2.0f, nz), ny2 = __fmul_rn(2.0f, ny),
              nx2 = __fmul_rn(2.0f, nx);
  a.gnz_out[i] = __fadd_rn(
      a.gnz[i], __fadd_rn(__fadd_rn(__fmul_rn(nz2, dzz), __fmul_rn(ny2, dzy)),
                          __fmul_rn(nx2, dzx)));
  a.gny_out[i] = __fadd_rn(
      a.gny[i], __fadd_rn(__fadd_rn(__fmul_rn(ny2, dyy), __fmul_rn(nz2, dzy)),
                          __fmul_rn(nx2, dyx)));
  a.gnx_out[i] = __fadd_rn(
      a.gnx[i], __fadd_rn(__fadd_rn(__fmul_rn(nx2, dxx), __fmul_rn(nz2, dzx)),
                          __fmul_rn(ny2, dyx)));

  // HT(w12): the coefficient times the weight at each tap, then the stencil
  const float w12c = sW12[cy][cx], w34c = sW34[cy][cx];
  auto one_m = [](float n) { return __fsub_rn(1.0f, __fmul_rn(n, n)); };
  float ht = __fadd_rn(
      sZ[2][ty][tx],
      d2<ORDER>(__fmul_rn(__fsub_rn(1.0f, cf.yy), w12c),
                [&](int s) { return __fmul_rn(one_m(sNY[cy + s][cx]), sW12[cy + s][cx]); },
                inv2));
  ht = __fadd_rn(
      ht, d2<ORDER>(__fmul_rn(__fsub_rn(1.0f, cf.xx), w12c),
                    [&](int s) { return __fmul_rn(one_m(sNX[cy][cx + s]), sW12[cy][cx + s]); },
                    inv2));
  ht = __fsub_rn(ht, d1<ORDER>([&](int s) { return sG12y[cy + s][cx]; }, inv1));
  ht = __fsub_rn(ht, d1<ORDER>([&](int s) { return sG12x[cy][cx + s]; }, inv1));
  ht = __fsub_rn(ht, d1<ORDER>([&](int s) { return sY12[ty][cx + s]; }, inv1));
  float vt = __fadd_rn(
      sZ[3][ty][tx],
      d2<ORDER>(__fmul_rn(cf.yy, w34c),
                [&](int s) {
                  const float n = sNY[cy + s][cx];
                  return __fmul_rn(__fmul_rn(n, n), sW34[cy + s][cx]);
                },
                inv2));
  vt = __fadd_rn(vt, d2<ORDER>(__fmul_rn(cf.xx, w34c),
                               [&](int s) {
                                 const float n = sNX[cy][cx + s];
                                 return __fmul_rn(__fmul_rn(n, n), sW34[cy][cx + s]);
                               },
                               inv2));
  vt = __fadd_rn(vt, d1<ORDER>([&](int s) { return sG34y[cy + s][cx]; }, inv1));
  vt = __fadd_rn(vt, d1<ORDER>([&](int s) { return sG34x[cy][cx + s]; }, inv1));
  vt = __fadd_rn(vt, d1<ORDER>([&](int s) { return sY34[ty][cx + s]; }, inv1));
  const float ebp1 = __fmul_rn(a.ap2[i], s_c);
  const float ebq1 = __fmul_rn(a.aq2[i], s_c);
  a.ap_out[i] = __fsub_rn(__fadd_rn(__fmul_rn(2.0f, ebp), ht), ebp1);
  a.aq_out[i] = __fsub_rn(__fadd_rn(__fmul_rn(2.0f, ebq), vt), ebq1);
}

template <typename CT, typename Q>
int launch_adjoint(int order, const AdjArgs& a, const Grid& g, cudaStream_t st) {
  const dim3 grid = grid_of(g), block(kBX, kBY);
  switch (order) {
    case 2:
      tti_adjoint_kernel<2, CT, Q><<<grid, block, 0, st>>>(a, g);
      break;
    case 4:
      tti_adjoint_kernel<4, CT, Q><<<grid, block, 0, st>>>(a, g);
      break;
    case 8:
      tti_adjoint_kernel<8, CT, Q><<<grid, block, 0, st>>>(a, g);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename CT>
int launch_adjoint_store(int order, int store, const AdjArgs& a, const Grid& g,
                         cudaStream_t st) {
  switch (store) {
    case 0:
      return launch_adjoint<CT, float>(order, a, g, st);
    case 1:
      return launch_adjoint<CT, __nv_bfloat16>(order, a, g, st);
    case 2:
      return launch_adjoint<CT, int8_t>(order, a, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const float* f32(const void* p) { return static_cast<const float*>(p); }
float* f32(void* p) { return static_cast<float*>(p); }

}  // namespace

extern "C" {

const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Number of per-block partial maxima K12 writes for each of p and q.
int64_t jt_tti_num_partials(int64_t D, int64_t H, int64_t W) {
  return cdiv(W, kBX) * cdiv(H, kBY) * D;
}

// K11. pn/qn may equal pp/qp (in place); p, q, C and the coefficients must
// be other buffers. coeff: 0 = f32, 1 = bf16 coefficient fields.
int jt_tti_step(const void* pp, const void* p, const void* qp, const void* q,
                const void* C, const void* ah, const void* av, const void* nz,
                const void* ny, const void* nx, const void* spz, const void* sy,
                const void* sx, const void* s_t, const void* amp, const void* inv_dx2,
                const void* inv_dx, int64_t src, void* pn, void* qn, int64_t D,
                int64_t H, int64_t W, int order, int coeff, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const StepArgs a{f32(pp),  f32(p),      f32(qp),     f32(q),  f32(C),  ah,
                   av,       nz,          ny,          nx,      f32(spz), f32(sy),
                   f32(sx),  f32(s_t),    f32(amp),    f32(inv_dx2), f32(inv_dx),
                   nullptr,  nullptr,     src,         f32(pn), f32(qn), nullptr,
                   nullptr,  nullptr};
  return launch_step_coeff<-1>(order, coeff, a, Grid{D, H, W},
                               static_cast<cudaStream_t>(stream));
}

// K12. As K11, plus penc/qenc (the codes of p and q; store: 0 = f32,
// 1 = bf16, 2 = int8) and partials (2 x jt_tti_num_partials floats).
int jt_tti_hist_step(const void* pp, const void* p, const void* qp, const void* q,
                     const void* C, const void* ah, const void* av, const void* nz,
                     const void* ny, const void* nx, const void* spz, const void* sy,
                     const void* sx, const void* s_t, const void* amp,
                     const void* inv_dx2, const void* inv_dx, const void* qfp,
                     const void* qfq, int64_t src, void* pn, void* qn, void* penc,
                     void* qenc, void* partials, int64_t D, int64_t H, int64_t W,
                     int order, int coeff, int store, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const StepArgs a{f32(pp),  f32(p),   f32(qp),  f32(q),  f32(C),       ah,
                   av,       nz,       ny,       nx,      f32(spz),     f32(sy),
                   f32(sx),  f32(s_t), f32(amp), f32(inv_dx2), f32(inv_dx),
                   f32(qfp), f32(qfq), src,      f32(pn), f32(qn),      penc,
                   qenc,     f32(partials)};
  const Grid g{D, H, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (store) {
    case 0:
      return launch_step_coeff<0>(order, coeff, a, g, st);
    case 1:
      return launch_step_coeff<1>(order, coeff, a, g, st);
    case 2:
      return launch_step_coeff<2>(order, coeff, a, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K13. coeff: 0 = f32, 1 = bf16 coefficient fields; store: 0 = f32,
// 1 = bf16, 2 = int8 histories (both of one type). Each output may equal
// its input (ap_out = ap2, aq_out = aq2, g*_out = g*); ap1, aq1, C, the
// coefficients and the histories must be other buffers.
int jt_tti_adjoint_step(const void* ap1, const void* aq1, const void* ap2,
                        const void* aq2, const void* gC, const void* gah,
                        const void* gav, const void* gnz, const void* gny,
                        const void* gnx, const void* C, const void* ah, const void* av,
                        const void* nz, const void* ny, const void* nx,
                        const void* p_enc, const void* q_enc, const void* psc,
                        const void* qsc, const void* inv_dx2, const void* inv_dx,
                        const void* spz, const void* sy, const void* sx, void* ap_out,
                        void* aq_out, void* gC_out, void* gah_out, void* gav_out,
                        void* gnz_out, void* gny_out, void* gnx_out, int64_t D,
                        int64_t H, int64_t W, int order, int coeff, int store,
                        void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const AdjArgs a{f32(ap1),     f32(aq1),     f32(ap2),     f32(aq2),    f32(gC),
                  f32(gah),     f32(gav),     f32(gnz),     f32(gny),    f32(gnx),
                  f32(C),       ah,           av,           nz,          ny,
                  nx,           p_enc,        q_enc,        f32(psc),    f32(qsc),
                  f32(inv_dx2), f32(inv_dx),  f32(spz),     f32(sy),     f32(sx),
                  f32(ap_out),  f32(aq_out),  f32(gC_out),  f32(gah_out),
                  f32(gav_out), f32(gnz_out), f32(gny_out), f32(gnx_out)};
  const Grid g{D, H, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (coeff) {
    case 0:
      return launch_adjoint_store<float>(order, store, a, g, st);
    case 1:
      return launch_adjoint_store<__nv_bfloat16>(order, store, a, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
