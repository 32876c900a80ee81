// Hopper (sm_90a) kernels of the 3-D TTI pseudo-acoustic wave path: the
// coupled forward step (K11, replaces jets_tpu/ops/pallas_wave.py:869
// fused_tti_step), the same step with the stored-adjoint history encode
// (K12, pallas_wave.py:922 fused_tti_hist_step), and the reverse step of the
// stored-history adjoint (K13, pallas_wave.py:2014 fused_tti_adjoint_step).
//
// Built by jets_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded through ctypes, like csrc/vti_kernels.cu: every entry point is
// plain `extern "C"`, takes raw device pointers, sizes as int64 and the
// caller's CUDA stream, launches on that stream without synchronising,
// allocates nothing, and returns the first CUDA error of the launch (a
// refused shared-memory size included). The scalars (s_t, amp, 1/dx^2,
// 1/dx, history quantization factors and decode scales) arrive as POINTERS
// to f32 values in device memory. The five coefficient fields
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
// Bound: device memory. K11 reads p, q, p_prev, q_prev and C (f32) and the
// five coefficient fields, and writes p_next, q_next: 12 touches of 4 bytes
// per point with f32 coefficients, 9.5 with bf16, for ~110 flops. K12 adds
// the two history codes (a quarter touch each for int8). K13 reads ap1,
// aq1, ap2, aq2, C, the six accumulators, the five coefficients and the two
// histories and writes eight fields: 24.5 touches with int8 histories and
// f32 coefficients, for ~300 flops. None of them is near the 67 TFLOP/s
// f32 rate.
//
// Layout: z-marching. A block of 32 (x, one warp per row) by 8 (y) threads
// owns one (y, x) tile, one thread per point, and walks kZChunk consecutive
// z-planes in a loop; this loop takes the place of the TPU kernels' z-slab
// grid axis, and the tiles and z-chunks run as independent blocks. For the
// block's staged points, the tile plus a halo of HW = ORDER/2 (SY x SX), a
// ring in shared memory keeps the last 2*HW+2 planes of what the operators
// need: p and q (K11/K12); the decoded histories p and q, the summed weights
// w12 = C*ah*ebp + C*av*ebq and w34 = C*av*ebp + C*ebq, and the axis nz, ny,
// nx (K13). Each of those values is computed once per staged point and block
// from one read of each raw input (the tile's own points coalesced, the
// halo mostly from L2). Per plane z, two phases between barriers:
//   1  from the ring: the first z-differences on the staged points (K13: of
//      p, q, czy*w and czx*w for both weights, on the tile's rows and
//      columns only) and K13's in-plane products (1-cyy)*w12, (1-cxx)*w12,
//      cyy*w34, cxx*w34; the first y-differences on the tile rows over the
//      halo columns; then plane z+HW+1, fetched into registers one step
//      earlier, goes into the ring slot plane z-HW-1 left, and plane z+HW+2
//      is fetched (with 2*HW+2 slots that write meets no read of the step);
//   2  each thread's output point: the z second differences from the ring,
//      the in-plane taps from shared memory, the inputs needed at the point
//      from device memory (K11/K12 load them one plane ahead).
// A prefetch only hides latency if nothing waits on it early: loads keep
// the bits they read (bf16 and int8 codes unconverted) until their use.
//
// What holds them below that bound (NVIDIA H100 80GB HBM3, 256^3, order 2):
// occupancy and latency, not the ALUs or shared memory. With every staged
// value computed once, the cached traffic is close to the device bytes,
// and the time is set by how many warps an SM holds to cover the loads and
// the two barriers per plane. Launch bounds cap K11/K12 at 64 registers (4
// blocks of 256 threads per SM) and K13 at 85 (3 blocks, as many as its
// 55 KB of ring and per-plane arrays allow); past those caps ptxas spills.
// K11/K12 then reach 0.75-0.80 of the byte bound with f32 coefficients and
// K13 about 0.65.
//
// Tile and chunk: 32 x 8 keeps one warp per tile row (128-byte rows) and
// 256 threads, so blocks are small enough to fit several per SM; its halo
// factor is (34*10)/256 = 1.33 at order 2 (2.5 at order 8), paid once per
// plane, not per tap. A taller tile would cut that factor but double a
// block's registers and shared memory. kZChunk = 32 gives 256 tiles x 8
// chunks = 2048 blocks at 256^3, about 15 per SM on 132 SMs, and re-stages
// 2*HW of every 32 planes at the chunk ends (chunks of 16 to 64 measured
// within 2%). A ragged last chunk, D below one chunk, and tiles past the
// grid's edge are masked (out-of-grid staged values are +0.0f; no barrier
// is skipped). The shared memory (above 48 KB for K13 and for order 8) is
// dynamic; each launch first sets the kernel's limit to it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;  // threads along x (W, contiguous): one warp
constexpr int kBY = 8;   // threads along y (H)
constexpr int kThreads = kBX * kBY;
constexpr int kZChunk = 32;  // z-planes one block walks

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
  return dim3((unsigned)cdiv(g.W, kBX), (unsigned)cdiv(g.H, kBY),
              (unsigned)cdiv(g.D, kZChunk));
}

// A field element of type T (float, __nv_bfloat16 or int8_t) as loaded,
// bits(): its register form, f32(): its value. The two are apart so that a
// load issued ahead of its use (a prefetch) is not waited for by a
// conversion placed right after it.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using Bits = float;
  __device__ static Bits bits(const void* p, int64_t i) {
    return __ldg(static_cast<const float*>(p) + i);
  }
  __device__ static float f32(Bits v) { return v; }
};
template <>
struct Elem<__nv_bfloat16> {
  using Bits = unsigned short;
  __device__ static Bits bits(const void* p, int64_t i) {
    return __ldg(static_cast<const unsigned short*>(p) + i);
  }
  __device__ static float f32(Bits v) { return __uint_as_float((unsigned)v << 16); }
};
template <>
struct Elem<int8_t> {
  using Bits = signed char;
  __device__ static Bits bits(const void* p, int64_t i) {
    return __ldg(static_cast<const signed char*>(p) + i);
  }
  __device__ static float f32(Bits v) { return (float)v; }
};

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

// The staged points of a block (its tile plus a halo of HW, SY x SX points
// in row-major order) and the ring depth.
template <int ORDER>
struct Stage {
  static constexpr int HW = St<ORDER>::HW;
  static constexpr int SY = kBY + 2 * HW, SX = kBX + 2 * HW, R = SY * SX;
  static constexpr int NZ = 2 * HW + 2;  // ring planes
  static constexpr int NH = R - kThreads;  // halo points
  static constexpr int KS = 1 + (NH + kThreads - 1) / kThreads;  // per thread
};

// The staged points one thread loads: its own tile point first, then halo
// points tid, tid + kThreads, ... (the HW rows above the tile, the HW rows
// below, then the HW columns on each side of the tile rows).
template <int ORDER>
struct Mine {
  using S = Stage<ORDER>;
  int64_t org;         // flat index of staged point (0, 0) on plane 0
  int idx[S::KS];      // index into a staged plane, -1: no point
  int rel[S::KS];      // flat offset from org, -1: outside the grid (or no point)
  float sy[S::KS], sx[S::KS];  // the sponge factors there

  __device__ Mine(int tid, int64_t y0, int64_t x0, const Grid& g, const float* spy,
                  const float* spx) {
    constexpr int HW = S::HW, SX = S::SX;
    org = (y0 - HW) * g.W + (x0 - HW);
#pragma unroll
    for (int k = 0; k < S::KS; ++k) {
      int ly = tid / kBX + HW, lx = tid % kBX + HW;
      if (k > 0) {
        int h = (k - 1) * kThreads + tid;
        if (h < 2 * HW * SX) {
          const int r = h / SX;
          ly = r < HW ? r : r + kBY;
          lx = h % SX;
        } else {
          h -= 2 * HW * SX;
          const int c = h % (2 * HW);
          ly = HW + h / (2 * HW);
          lx = c < HW ? c : c + kBX;
        }
      }
      const bool live = k == 0 || (k - 1) * kThreads + tid < S::NH;
      const int64_t y = y0 + ly - HW, x = x0 + lx - HW;
      const bool in = live && y >= 0 && y < g.H && x >= 0 && x < g.W;
      idx[k] = live ? ly * SX + lx : -1;
      rel[k] = in ? (int)(ly * g.W + lx) : -1;
      sy[k] = in ? __ldg(spy + y) : 0.0f;
      sx[k] = in ? __ldg(spx + x) : 0.0f;
    }
  }
};

// Ring slot of plane z + s in the step whose base slot is `base`.
template <int ORDER>
__device__ __forceinline__ int slot(int base, int s) {
  constexpr int NZ = Stage<ORDER>::NZ;
  const int k = base + Stage<ORDER>::HW + s;
  return k >= NZ ? k - NZ : k;
}

// ---------------------------------------------------------------------------
// K11 / K12  coupled TTI step:
//   e_p = (2p - p_prev) + C*(ah*H(p) + av*V(q))
//   e_q = (2q - q_prev) + C*(av*H(p) + V(q))
//   p_next = e_p*((sz*sy)*sx) + s_t*mask,  q_next likewise
// with mask = amp at the flat source index and 0 elsewhere.
//
// K11 (STORE < 0) replaces jets_tpu/ops/pallas_wave.py:869 fused_tti_step
// and K12 (STORE = 0/1/2) pallas_wave.py:922 fused_tti_hist_step
// (_tti_kernel with hist=): K12 also writes the codes of the INPUT p and q
// (at the one-step-deferred quantization factors qfp/qfq = 127/scale_k) and
// the block's max|p_next| and max|q_next| over its tile and z-chunk into
// partials[0][b] and partials[1][b], reduced by the wrapper into the next
// step's scales. The ring holds p and q; phase 1 stages d1z of both on the
// staged points and d1y on the tile rows. p_next/q_next may be p_prev's/
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

// Blocks per SM each kernel is compiled for, which caps its registers at
// 65536 / (256 * blocks): as many as the shared memory lets in, up to the
// count past which the registers spill (K11/K12: 4 at 64 registers, 3 for
// order 8's 58 KB; K13: 3 at 85 registers for order 2's 55 KB, 2 and 1
// for order 4's 92 KB and order 8's 205 KB).
constexpr int step_blocks(int order) { return order == 8 ? 3 : 4; }
constexpr int adjoint_blocks(int order) { return order == 2 ? 3 : order == 4 ? 2 : 1; }

template <int ORDER>
constexpr size_t step_smem() {
  using S = Stage<ORDER>;
  return sizeof(float) * (2 * S::NZ * S::R + 2 * S::R + 2 * kBY * S::SX);
}

template <int ORDER, typename CT, int STORE>
__global__ void __launch_bounds__(kThreads, step_blocks(ORDER))
    tti_step_kernel(StepArgs a, Grid g) {
  using S = Stage<ORDER>;
  constexpr int HW = S::HW, SX = S::SX, R = S::R, NZ = S::NZ, KS = S::KS;
  extern __shared__ __align__(16) float jt_smem[];
  float* const rP = jt_smem;       // [NZ][R] ring of p
  float* const rQ = rP + NZ * R;   // [NZ][R] ring of q
  float* const sGP = rQ + NZ * R;  // [R] d1z(p) on plane z
  float* const sGQ = sGP + R;      // [R] d1z(q)
  float* const sYP = sGQ + R;      // [kBY][SX] d1y(p) on the tile rows
  float* const sYQ = sYP + kBY * SX;
  const int ty = threadIdx.y, tx = threadIdx.x, tid = ty * kBX + tx;
  const int64_t x0 = (int64_t)blockIdx.x * kBX, y0 = (int64_t)blockIdx.y * kBY;
  const int64_t z0 = (int64_t)blockIdx.z * kZChunk;
  const int64_t z1 = z0 + kZChunk < g.D ? z0 + kZChunk : g.D;
  const int64_t plane = g.H * g.W;
  const float inv2 = *a.inv_dx2, inv1 = *a.inv_dx;
  const Mine<ORDER> mine(tid, y0, x0, g, a.sy, a.sx);

  float pr[KS], qr[KS];  // the staged values of the plane to be put next
  auto fetch = [&](int64_t z) {
    const bool live = z >= 0 && z < g.D && z < z1 + HW;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      pr[k] = qr[k] = 0.0f;
      if (live && mine.rel[k] >= 0) {
        pr[k] = __ldg(a.p + z * plane + mine.org + mine.rel[k]);
        qr[k] = __ldg(a.q + z * plane + mine.org + mine.rel[k]);
      }
    }
  };
  auto put = [&](int sl) {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (mine.idx[k] >= 0) {
        rP[sl * R + mine.idx[k]] = pr[k];
        rQ[sl * R + mine.idx[k]] = qr[k];
      }
    }
  };
  for (int s = -HW; s <= HW; ++s) {  // planes z0-HW .. z0+HW
    fetch(z0 + s);
    put(HW + s);
  }
  fetch(z0 + HW + 1);
  __syncthreads();

  const int cy = ty + HW, cx = tx + HW, c = cy * SX + cx;
  const int64_t ix = x0 + tx, iy = y0 + ty;
  const bool out = ix < g.W && iy < g.H;
  const float qfp = STORE >= 0 ? *a.qfp : 0.0f, qfq = STORE >= 0 ? *a.qfq : 0.0f;
  const float syx = out ? __ldg(a.sy + iy) : 0.0f, sxx = out ? __ldg(a.sx + ix) : 0.0f;
  // the inputs read only at the output point, loaded one plane ahead
  using E = Elem<CT>;
  struct At {
    float pp, qp, c;
    typename E::Bits ah, av, nz, ny, nx;
    float sz;
  };
  auto at_point = [&](int64_t z) {
    At v{};
    if (out && z < z1) {
      const int64_t i = (z * g.H + iy) * g.W + ix;
      v = At{a.pp[i],          a.qp[i],          __ldg(a.C + i),   E::bits(a.ah, i),
             E::bits(a.av, i), E::bits(a.nz, i), E::bits(a.ny, i), E::bits(a.nx, i),
             __ldg(a.spz + z)};
    }
    return v;
  };
  At ahead = at_point(z0);
  float mp = 0.0f, mq = 0.0f;
  int base = 0;  // ring slot of plane z - HW
  for (int64_t z = z0; z < z1; ++z) {
    const At cur = ahead;
    ahead = at_point(z + 1);
    const float* const P = rP + slot<ORDER>(base, 0) * R;
    const float* const Q = rQ + slot<ORDER>(base, 0) * R;
    for (int t = tid; t < R; t += kThreads) {  // phase 1: d1z
      const int64_t y = y0 + t / SX - HW, x = x0 + t % SX - HW;
      float gp = 0.0f, gq = 0.0f;
      if (y >= 0 && y < g.H && x >= 0 && x < g.W) {
        gp = d1<ORDER>([&](int s) { return rP[slot<ORDER>(base, s) * R + t]; }, inv1);
        gq = d1<ORDER>([&](int s) { return rQ[slot<ORDER>(base, s) * R + t]; }, inv1);
      }
      sGP[t] = gp;
      sGQ[t] = gq;
    }
    for (int t = tid; t < kBY * SX; t += kThreads) {  // phase 1: d1y
      const int ly = t / SX, lx = t % SX, r = ly + HW;
      const int64_t y = y0 + ly, x = x0 + lx - HW;
      float yp = 0.0f, yq = 0.0f;
      if (y < g.H && x >= 0 && x < g.W) {
        yp = d1<ORDER>([&](int s) { return P[(r + s) * SX + lx]; }, inv1);
        yq = d1<ORDER>([&](int s) { return Q[(r + s) * SX + lx]; }, inv1);
      }
      sYP[t] = yp;
      sYQ[t] = yq;
    }
    put(slot<ORDER>(base, HW + 1));
    fetch(z + HW + 2);
    __syncthreads();

    if (out) {  // phase 2
      const int64_t i = (z * g.H + iy) * g.W + ix;
      const float pc = P[c], qc = Q[c];
      const D6 dp{d2<ORDER>(pc, [&](int s) { return rP[slot<ORDER>(base, s) * R + c]; }, inv2),
                  d2<ORDER>(pc, [&](int s) { return P[c + s * SX]; }, inv2),
                  d2<ORDER>(pc, [&](int s) { return P[c + s]; }, inv2),
                  d1<ORDER>([&](int s) { return sGP[c + s * SX]; }, inv1),
                  d1<ORDER>([&](int s) { return sGP[c + s]; }, inv1),
                  d1<ORDER>([&](int s) { return sYP[ty * SX + cx + s]; }, inv1)};
      const D6 dq{d2<ORDER>(qc, [&](int s) { return rQ[slot<ORDER>(base, s) * R + c]; }, inv2),
                  d2<ORDER>(qc, [&](int s) { return Q[c + s * SX]; }, inv2),
                  d2<ORDER>(qc, [&](int s) { return Q[c + s]; }, inv2),
                  d1<ORDER>([&](int s) { return sGQ[c + s * SX]; }, inv1),
                  d1<ORDER>([&](int s) { return sGQ[c + s]; }, inv1),
                  d1<ORDER>([&](int s) { return sYQ[ty * SX + cx + s]; }, inv1)};
      const Dir cf = directions(E::f32(cur.nz), E::f32(cur.ny), E::f32(cur.nx));
      const float hp = h_of(dp, cf), vq = v_of(dq, cf);
      const float ah = E::f32(cur.ah), av = E::f32(cur.av);
      const float e_p =
          __fadd_rn(__fsub_rn(__fmul_rn(2.0f, pc), cur.pp),
                    __fmul_rn(cur.c, __fadd_rn(__fmul_rn(ah, hp), __fmul_rn(av, vq))));
      const float e_q = __fadd_rn(__fsub_rn(__fmul_rn(2.0f, qc), cur.qp),
                                  __fmul_rn(cur.c, __fadd_rn(__fmul_rn(av, hp), vq)));
      const float sponge = __fmul_rn(__fmul_rn(cur.sz, syx), sxx);
      const float src = __fmul_rn(*a.s_t, i == a.src ? *a.amp : 0.0f);
      const float p_next = __fadd_rn(__fmul_rn(e_p, sponge), src);
      const float q_next = __fadd_rn(__fmul_rn(e_q, sponge), src);
      a.pn[i] = p_next;
      a.qn[i] = q_next;
      if constexpr (STORE >= 0) {
        put_code<STORE>(a.penc, i, pc, qfp);
        put_code<STORE>(a.qenc, i, qc, qfq);
        mp = fmaxf(mp, fabsf(p_next));
        mq = fmaxf(mq, fabsf(q_next));
      }
    }
    __syncthreads();
    base = base + 1 == NZ ? 0 : base + 1;
  }
  if constexpr (STORE >= 0) {
    __shared__ float smax[2][kBY];
#pragma unroll
    for (int o = kBX / 2; o > 0; o >>= 1) {
      mp = fmaxf(mp, __shfl_xor_sync(0xffffffffu, mp, o));
      mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, o));
    }
    if (tx == 0) {
      smax[0][ty] = mp;
      smax[1][ty] = mq;
    }
    __syncthreads();
    if (ty == 0 && tx < 2) {  // thread 0: p, thread 1: q
      float m = 0.0f;
#pragma unroll
      for (int w = 0; w < kBY; ++w) m = fmaxf(m, smax[tx][w]);
      const int64_t nb = (int64_t)gridDim.x * gridDim.y * gridDim.z;
      const int64_t b =
          ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      a.partials[tx * nb + b] = m;
    }
  }
}

// Sets the kernel's dynamic shared memory limit and launches it: a size the
// card refuses comes back as the attribute's error or the launch's.
template <typename Args>
int launch(void (*kern)(Args, Grid), size_t smem, const Args& a, const Grid& g,
           cudaStream_t st) {
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid_of(g), dim3(kBX, kBY), smem, st>>>(a, g);
  return (int)cudaGetLastError();
}

template <typename CT, int STORE>
int launch_step(int order, const StepArgs& a, const Grid& g, cudaStream_t st) {
  switch (order) {
    case 2:
      return launch(tti_step_kernel<2, CT, STORE>, step_smem<2>(), a, g, st);
    case 4:
      return launch(tti_step_kernel<4, CT, STORE>, step_smem<4>(), a, g, st);
    case 8:
      return launch(tti_step_kernel<8, CT, STORE>, step_smem<8>(), a, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
// Replaces jets_tpu/ops/pallas_wave.py:2014 fused_tti_adjoint_step
// (_tti_adjoint_kernel), which rebuilds its weight windows once per z-slab
// in VMEM. Here the ring holds p, q, w12, w34, nz, ny, nx: a staged point's
// sponge, ap1, aq1, C, ah, av, axis and two history codes are read once per
// block and turned into those seven values once. Phase 1 forms, per staged
// point, d1z of p, q, czy*w12, czx*w12, czy*w34 and czx*w34 (the products at
// each z tap from the ring) and the four in-plane products, then d1y of p,
// q, cyx*w12 and cyx*w34 on the tile rows; phase 2 reads ap2, aq2 and the
// six accumulators at the output point only, so the outputs may be written
// into their buffers (in place). The receiver injection is not part of the
// kernel (ops/wave.py adds it with index_add_).
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

template <int ORDER>
constexpr size_t adjoint_smem() {
  using S = Stage<ORDER>;
  return sizeof(float) * (7 * S::NZ * S::R + 10 * S::R + 4 * kBY * S::SX);
}

// The raw inputs of one staged point on one plane, as loaded.
template <typename CT, typename Q>
struct Raw {
  float ap1, aq1, c;
  typename Elem<CT>::Bits ah, av, nz, ny, nx;
  typename Elem<Q>::Bits p, q;
};

template <int ORDER, typename CT, typename Q>
__global__ void __launch_bounds__(kThreads, adjoint_blocks(ORDER))
    tti_adjoint_kernel(AdjArgs a, Grid g) {
  using S = Stage<ORDER>;
  constexpr int HW = S::HW, SX = S::SX, R = S::R, NZ = S::NZ, KS = S::KS;
  extern __shared__ __align__(16) float jt_smem[];
  float* const rP = jt_smem;  // [NZ][R] rings: decoded histories,
  float* const rQ = rP + NZ * R;
  float* const rW12 = rQ + NZ * R;  // the weights,
  float* const rW34 = rW12 + NZ * R;
  float* const rNZ = rW34 + NZ * R;  // the axis
  float* const rNY = rNZ + NZ * R;
  float* const rNX = rNY + NZ * R;
  // [6][R] on plane z: d1z of p, q, czy*w12, czx*w12, czy*w34, czx*w34
  float* const sG = rNX + NZ * R;
  // [4][R] on plane z: (1-cyy)w12, (1-cxx)w12, cyy w34, cxx w34
  float* const sM = sG + 6 * R;
  // [4][kBY][SX] d1y of p, q, cyx*w12, cyx*w34 on the tile rows
  float* const sY = sM + 4 * R;
  const int ty = threadIdx.y, tx = threadIdx.x, tid = ty * kBX + tx;
  const int64_t x0 = (int64_t)blockIdx.x * kBX, y0 = (int64_t)blockIdx.y * kBY;
  const int64_t z0 = (int64_t)blockIdx.z * kZChunk;
  const int64_t z1 = z0 + kZChunk < g.D ? z0 + kZChunk : g.D;
  const int64_t plane = g.H * g.W;
  const float inv2 = *a.inv_dx2, inv1 = *a.inv_dx, psc = *a.psc, qsc = *a.qsc;
  const Mine<ORDER> mine(tid, y0, x0, g, a.sy, a.sx);

  using E = Elem<CT>;
  using EQ = Elem<Q>;
  Raw<CT, Q> raw[KS];  // the raw inputs of the plane to be put next,
  float rsz = 0.0f;    // its z sponge factor,
  bool rlive = false;  // and whether it is a plane the chunk needs
  auto fetch = [&](int64_t z) {
    const bool live = z >= 0 && z < g.D && z < z1 + HW;
    rlive = live;
    rsz = live ? __ldg(a.spz + z) : 0.0f;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      raw[k] = Raw<CT, Q>{};
      if (live && mine.rel[k] >= 0) {
        const int64_t j = z * plane + mine.org + mine.rel[k];
        raw[k] = Raw<CT, Q>{__ldg(a.ap1 + j), __ldg(a.aq1 + j), __ldg(a.C + j),
                            E::bits(a.ah, j),  E::bits(a.av, j),  E::bits(a.nz, j),
                            E::bits(a.ny, j),  E::bits(a.nx, j),  EQ::bits(a.p_enc, j),
                            EQ::bits(a.q_enc, j)};
      }
    }
  };
  auto put = [&](int sl) {  // the fetched plane into ring slot sl
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (mine.idx[k] < 0) continue;
      float p = 0.0f, q = 0.0f, w12 = 0.0f, w34 = 0.0f;
      if (rlive && mine.rel[k] >= 0) {
        const Raw<CT, Q>& r = raw[k];
        const float s = __fmul_rn(__fmul_rn(rsz, mine.sy[k]), mine.sx[k]);
        const float ebp = __fmul_rn(r.ap1, s), ebq = __fmul_rn(r.aq1, s);
        const float ah = E::f32(r.ah), av = E::f32(r.av);
        const float cav = __fmul_rn(r.c, av);
        p = __fmul_rn(EQ::f32(r.p), psc);
        q = __fmul_rn(EQ::f32(r.q), qsc);
        w12 = __fadd_rn(__fmul_rn(__fmul_rn(r.c, ah), ebp), __fmul_rn(cav, ebq));
        w34 = __fadd_rn(__fmul_rn(cav, ebp), __fmul_rn(r.c, ebq));
      }
      const int o = sl * R + mine.idx[k];
      rP[o] = p;
      rQ[o] = q;
      rW12[o] = w12;
      rW34[o] = w34;
      rNZ[o] = E::f32(raw[k].nz);
      rNY[o] = E::f32(raw[k].ny);
      rNX[o] = E::f32(raw[k].nx);
    }
  };
  for (int s = -HW; s <= HW; ++s) {  // planes z0-HW .. z0+HW
    fetch(z0 + s);
    put(HW + s);
  }
  fetch(z0 + HW + 1);
  __syncthreads();

  const int cy = ty + HW, cx = tx + HW, c = cy * SX + cx;
  const int64_t ix = x0 + tx, iy = y0 + ty;
  const bool out = ix < g.W && iy < g.H;
  // the inputs read at the output point: ap2, aq2 and the accumulators
  // (only there), and the point's own ap1, aq1, C, ah, av and z sponge
  // factor, read again (from L2) rather than held in registers since the
  // ring write, which keeps K13 at 3 blocks per SM
  struct At {
    float ap2, aq2, gC, gah, gav, gnz, gny, gnx, ap1, aq1, c;
    typename E::Bits ah, av;
    float sz;
  };
  const float syx = out ? __ldg(a.sy + iy) : 0.0f, sxx = out ? __ldg(a.sx + ix) : 0.0f;
  auto at_point = [&](int64_t z) {
    At v{};
    if (out) {
      const int64_t i = (z * g.H + iy) * g.W + ix;
      v = At{a.ap2[i],         a.aq2[i],         a.gC[i],          a.gah[i],
             a.gav[i],         a.gnz[i],         a.gny[i],         a.gnx[i],
             __ldg(a.ap1 + i), __ldg(a.aq1 + i), __ldg(a.C + i),   E::bits(a.ah, i),
             E::bits(a.av, i), __ldg(a.spz + z)};
    }
    return v;
  };
  int base = 0;  // ring slot of plane z - HW
  for (int64_t z = z0; z < z1; ++z) {
    const int64_t i = (z * g.H + iy) * g.W + ix;
    const At cur = at_point(z);
    const int o0 = slot<ORDER>(base, 0) * R;
    for (int t = tid; t < R; t += kThreads) {  // phase 1: d1z
      const int ly = t / SX, lx = t % SX;
      const int64_t y = y0 + ly - HW, x = x0 + lx - HW;
      float gp = 0.0f, gq = 0.0f, g12y = 0.0f, g12x = 0.0f, g34y = 0.0f, g34x = 0.0f;
      float m12y = 0.0f, m12x = 0.0f, m34y = 0.0f, m34x = 0.0f;
      // d1z(czy*w) and (1-cyy)*w, cyy*w are read on the tile's columns
      // (d1y taps), d1z(czx*w) and the cxx terms on its rows (d1x taps),
      // d1z(p), d1z(q) on both; nothing on the halo's corners
      const bool ycol = lx >= HW && lx < HW + kBX, xrow = ly >= HW && ly < HW + kBY;
      if (y >= 0 && y < g.H && x >= 0 && x < g.W && (ycol || xrow)) {
        const float w12 = rW12[o0 + t], w34 = rW34[o0 + t];
        if (ycol) {
          const float cyy = __fmul_rn(rNY[o0 + t], rNY[o0 + t]);
          m12y = __fmul_rn(__fsub_rn(1.0f, cyy), w12);
          m34y = __fmul_rn(cyy, w34);
        }
        if (xrow) {
          const float cxx = __fmul_rn(rNX[o0 + t], rNX[o0 + t]);
          m12x = __fmul_rn(__fsub_rn(1.0f, cxx), w12);
          m34x = __fmul_rn(cxx, w34);
        }
#pragma unroll
        for (int s = 1; s <= HW; ++s) {
          const int hi = slot<ORDER>(base, s) * R + t, lo = slot<ORDER>(base, -s) * R + t;
          const float c1 = St<ORDER>::d1(s);
          const float tp = __fmul_rn(c1, __fsub_rn(rP[hi], rP[lo]));
          const float tq = __fmul_rn(c1, __fsub_rn(rQ[hi], rQ[lo]));
          gp = s == 1 ? tp : __fadd_rn(gp, tp);
          gq = s == 1 ? tq : __fadd_rn(gq, tq);
          const float nz2_h = __fmul_rn(2.0f, rNZ[hi]), nz2_l = __fmul_rn(2.0f, rNZ[lo]);
          const float w12_h = rW12[hi], w12_l = rW12[lo];
          const float w34_h = rW34[hi], w34_l = rW34[lo];
          if (ycol) {
            const float zy_h = __fmul_rn(nz2_h, rNY[hi]), zy_l = __fmul_rn(nz2_l, rNY[lo]);
            const float t12 =
                __fmul_rn(c1, __fsub_rn(__fmul_rn(zy_h, w12_h), __fmul_rn(zy_l, w12_l)));
            const float t34 =
                __fmul_rn(c1, __fsub_rn(__fmul_rn(zy_h, w34_h), __fmul_rn(zy_l, w34_l)));
            g12y = s == 1 ? t12 : __fadd_rn(g12y, t12);
            g34y = s == 1 ? t34 : __fadd_rn(g34y, t34);
          }
          if (xrow) {
            const float zx_h = __fmul_rn(nz2_h, rNX[hi]), zx_l = __fmul_rn(nz2_l, rNX[lo]);
            const float t12 =
                __fmul_rn(c1, __fsub_rn(__fmul_rn(zx_h, w12_h), __fmul_rn(zx_l, w12_l)));
            const float t34 =
                __fmul_rn(c1, __fsub_rn(__fmul_rn(zx_h, w34_h), __fmul_rn(zx_l, w34_l)));
            g12x = s == 1 ? t12 : __fadd_rn(g12x, t12);
            g34x = s == 1 ? t34 : __fadd_rn(g34x, t34);
          }
        }
        gp = __fmul_rn(gp, inv1);
        gq = __fmul_rn(gq, inv1);
        g12y = __fmul_rn(g12y, inv1);
        g12x = __fmul_rn(g12x, inv1);
        g34y = __fmul_rn(g34y, inv1);
        g34x = __fmul_rn(g34x, inv1);
      }
      sG[t] = gp;
      sG[R + t] = gq;
      sG[2 * R + t] = g12y;
      sG[3 * R + t] = g12x;
      sG[4 * R + t] = g34y;
      sG[5 * R + t] = g34x;
      sM[t] = m12y;
      sM[R + t] = m12x;
      sM[2 * R + t] = m34y;
      sM[3 * R + t] = m34x;
    }
    const float* const P = rP + o0;
    const float* const Qz = rQ + o0;
    constexpr int YS = kBY * SX;
    for (int t = tid; t < YS; t += kThreads) {  // phase 1: d1y
      const int ly = t / SX, lx = t % SX, r = ly + HW;
      const int64_t y = y0 + ly, x = x0 + lx - HW;
      float yp = 0.0f, yq = 0.0f, y12 = 0.0f, y34 = 0.0f;
      if (y < g.H && x >= 0 && x < g.W) {
        yp = d1<ORDER>([&](int s) { return P[(r + s) * SX + lx]; }, inv1);
        yq = d1<ORDER>([&](int s) { return Qz[(r + s) * SX + lx]; }, inv1);
        // cyx*w12 and cyx*w34 at the y taps, from the ring
#pragma unroll
        for (int s = 1; s <= HW; ++s) {
          const int hi = o0 + (r + s) * SX + lx, lo = o0 + (r - s) * SX + lx;
          const float cyx_h = __fmul_rn(__fmul_rn(2.0f, rNY[hi]), rNX[hi]);
          const float cyx_l = __fmul_rn(__fmul_rn(2.0f, rNY[lo]), rNX[lo]);
          const float c1 = St<ORDER>::d1(s);
          const float t12 =
              __fmul_rn(c1, __fsub_rn(__fmul_rn(cyx_h, rW12[hi]), __fmul_rn(cyx_l, rW12[lo])));
          const float t34 =
              __fmul_rn(c1, __fsub_rn(__fmul_rn(cyx_h, rW34[hi]), __fmul_rn(cyx_l, rW34[lo])));
          y12 = s == 1 ? t12 : __fadd_rn(y12, t12);
          y34 = s == 1 ? t34 : __fadd_rn(y34, t34);
        }
        y12 = __fmul_rn(y12, inv1);
        y34 = __fmul_rn(y34, inv1);
      }
      sY[t] = yp;
      sY[YS + t] = yq;
      sY[2 * YS + t] = y12;
      sY[3 * YS + t] = y34;
    }
    put(slot<ORDER>(base, HW + 1));
    fetch(z + HW + 2);
    __syncthreads();

    if (out) {  // phase 2
      const float pc = P[c], qc = Qz[c];
      const float* const gy = sY + ty * SX + cx;
      const D6 dp{d2<ORDER>(pc, [&](int s) { return rP[slot<ORDER>(base, s) * R + c]; }, inv2),
                  d2<ORDER>(pc, [&](int s) { return P[c + s * SX]; }, inv2),
                  d2<ORDER>(pc, [&](int s) { return P[c + s]; }, inv2),
                  d1<ORDER>([&](int s) { return sG[c + s * SX]; }, inv1),
                  d1<ORDER>([&](int s) { return sG[c + s]; }, inv1),
                  d1<ORDER>([&](int s) { return gy[s]; }, inv1)};
      const D6 dq{d2<ORDER>(qc, [&](int s) { return rQ[slot<ORDER>(base, s) * R + c]; }, inv2),
                  d2<ORDER>(qc, [&](int s) { return Qz[c + s * SX]; }, inv2),
                  d2<ORDER>(qc, [&](int s) { return Qz[c + s]; }, inv2),
                  d1<ORDER>([&](int s) { return sG[R + c + s * SX]; }, inv1),
                  d1<ORDER>([&](int s) { return sG[R + c + s]; }, inv1),
                  d1<ORDER>([&](int s) { return gy[YS + s]; }, inv1)};
      const float nz = rNZ[o0 + c], ny = rNY[o0 + c], nx = rNX[o0 + c];
      const Dir cf = directions(nz, ny, nx);
      const float hp = h_of(dp, cf), vq = v_of(dq, cf);
      const float s_c = __fmul_rn(__fmul_rn(cur.sz, syx), sxx);
      const float ebp = __fmul_rn(cur.ap1, s_c), ebq = __fmul_rn(cur.aq1, s_c);
      const float cc = cur.c, ah = E::f32(cur.ah), av = E::f32(cur.av);

      a.gC_out[i] = __fadd_rn(
          cur.gC, __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(ah, hp), __fmul_rn(av, vq)), ebp),
                        __fmul_rn(__fadd_rn(__fmul_rn(av, hp), vq), ebq)));
      a.gah_out[i] = __fadd_rn(cur.gah, __fmul_rn(__fmul_rn(cc, hp), ebp));
      a.gav_out[i] =
          __fadd_rn(cur.gav, __fmul_rn(cc, __fadd_rn(__fmul_rn(vq, ebp), __fmul_rn(hp, ebq))));
      auto dc = [&](float p_d, float q_d) {
        return __fmul_rn(
            cc, __fadd_rn(__fmul_rn(__fsub_rn(__fmul_rn(av, q_d), __fmul_rn(ah, p_d)), ebp),
                          __fmul_rn(__fsub_rn(q_d, __fmul_rn(av, p_d)), ebq)));
      };
      const float dzz = dc(dp.zz, dq.zz), dyy = dc(dp.yy, dq.yy), dxx = dc(dp.xx, dq.xx);
      const float dzy = dc(dp.zy, dq.zy), dzx = dc(dp.zx, dq.zx), dyx = dc(dp.yx, dq.yx);
      const float nz2 = __fmul_rn(2.0f, nz), ny2 = __fmul_rn(2.0f, ny),
                  nx2 = __fmul_rn(2.0f, nx);
      a.gnz_out[i] = __fadd_rn(
          cur.gnz, __fadd_rn(__fadd_rn(__fmul_rn(nz2, dzz), __fmul_rn(ny2, dzy)),
                         __fmul_rn(nx2, dzx)));
      a.gny_out[i] = __fadd_rn(
          cur.gny, __fadd_rn(__fadd_rn(__fmul_rn(ny2, dyy), __fmul_rn(nz2, dzy)),
                         __fmul_rn(nx2, dyx)));
      a.gnx_out[i] = __fadd_rn(
          cur.gnx, __fadd_rn(__fadd_rn(__fmul_rn(nx2, dxx), __fmul_rn(nz2, dzx)),
                         __fmul_rn(ny2, dyx)));

      // (1-czz)*w12 and czz*w34 at the z taps of the tile point
      auto zw12 = [&](int s) {
        const int o = slot<ORDER>(base, s) * R + c;
        return __fmul_rn(__fsub_rn(1.0f, __fmul_rn(rNZ[o], rNZ[o])), rW12[o]);
      };
      auto zw34 = [&](int s) {
        const int o = slot<ORDER>(base, s) * R + c;
        return __fmul_rn(__fmul_rn(rNZ[o], rNZ[o]), rW34[o]);
      };
      const float* const m = sM + c;
      float ht = __fadd_rn(d2<ORDER>(zw12(0), zw12, inv2),
                           d2<ORDER>(m[0], [&](int s) { return m[s * SX]; }, inv2));
      ht = __fadd_rn(ht, d2<ORDER>(m[R], [&](int s) { return m[R + s]; }, inv2));
      ht = __fsub_rn(ht, d1<ORDER>([&](int s) { return sG[2 * R + c + s * SX]; }, inv1));
      ht = __fsub_rn(ht, d1<ORDER>([&](int s) { return sG[3 * R + c + s]; }, inv1));
      ht = __fsub_rn(ht, d1<ORDER>([&](int s) { return gy[2 * YS + s]; }, inv1));
      float vt = __fadd_rn(d2<ORDER>(zw34(0), zw34, inv2),
                           d2<ORDER>(m[2 * R], [&](int s) { return m[2 * R + s * SX]; }, inv2));
      vt = __fadd_rn(vt, d2<ORDER>(m[3 * R], [&](int s) { return m[3 * R + s]; }, inv2));
      vt = __fadd_rn(vt, d1<ORDER>([&](int s) { return sG[4 * R + c + s * SX]; }, inv1));
      vt = __fadd_rn(vt, d1<ORDER>([&](int s) { return sG[5 * R + c + s]; }, inv1));
      vt = __fadd_rn(vt, d1<ORDER>([&](int s) { return gy[3 * YS + s]; }, inv1));
      const float ebp1 = __fmul_rn(cur.ap2, s_c);
      const float ebq1 = __fmul_rn(cur.aq2, s_c);
      a.ap_out[i] = __fsub_rn(__fadd_rn(__fmul_rn(2.0f, ebp), ht), ebp1);
      a.aq_out[i] = __fsub_rn(__fadd_rn(__fmul_rn(2.0f, ebq), vt), ebq1);
    }
    __syncthreads();
    base = base + 1 == NZ ? 0 : base + 1;
  }
}

template <typename CT, typename Q>
int launch_adjoint(int order, const AdjArgs& a, const Grid& g, cudaStream_t st) {
  switch (order) {
    case 2:
      return launch(tti_adjoint_kernel<2, CT, Q>, adjoint_smem<2>(), a, g, st);
    case 4:
      return launch(tti_adjoint_kernel<4, CT, Q>, adjoint_smem<4>(), a, g, st);
    case 8:
      return launch(tti_adjoint_kernel<8, CT, Q>, adjoint_smem<8>(), a, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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

// Number of per-block partial maxima K12 writes for each of p and q: one
// per (tile, z-chunk) block.
int64_t jt_tti_num_partials(int64_t D, int64_t H, int64_t W) {
  return cdiv(W, kBX) * cdiv(H, kBY) * cdiv(D, kZChunk);
}

// Dynamic shared memory per block in bytes of K11/K12 (kernel 0) or K13
// (kernel 1) at a stencil order; -1 for anything else.
int64_t jt_tti_smem_bytes(int kernel, int order) {
  switch (order * 2 + kernel) {
    case 4: return (int64_t)step_smem<2>();
    case 8: return (int64_t)step_smem<4>();
    case 16: return (int64_t)step_smem<8>();
    case 5: return (int64_t)adjoint_smem<2>();
    case 9: return (int64_t)adjoint_smem<4>();
    case 17: return (int64_t)adjoint_smem<8>();
    default: return -1;
  }
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
