// Hopper (sm_90a) kernels of the isotropic acoustic wave path: the forward
// leapfrog step (K4), the stored-wavefield adjoint step (K5, a z-marching
// kernel), the Kosloff constant-Q (visco-acoustic) step (K14), the batched
// 2-D pair K4-2D and K5-2D (the same two steps over a (B, H, W) batch of 2-D
// shots), and the reverse constant-Q step of the stored-history (c, Q)
// adjoint (K15, z-marching too). Design notes of K5 and the last three at
// their definitions.
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
// Bound: device memory. Every kernel here does tens of flops per point
// against 16-45 bytes moved, far below the card's balance point. K4 and K14
// compute one grid point a thread; threads of a warp run along x (the
// contiguous axis) so every load coalesces, and the stencil's neighbour reads
// are served by L1 and the 50 MB L2; the 2-D pair stages a tile in shared
// memory (note at its definition). K5 and K15 march along z instead: a
// register ring of planes for the z taps and the plane with its cross halo
// in shared memory, each staged value computed once and every load issued a
// plane ahead (the Hopper counterpart of the Pallas kernels' double-buffered
// VMEM slab ring with z halos). Flat indices are int64, so any grid the
// launch limits admit works.
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
  __device__ static float center2d() { return (float)(-2.0 * 2); }
  __device__ static float coef(int) { return 1.0f; }
};

template <>
struct Stencil<4> {
  static constexpr int HW = 2;
  static constexpr bool UNIT = false;
  __device__ static float center() { return (float)((-5.0 / 2.0) * 3); }
  __device__ static float center2d() { return (float)((-5.0 / 2.0) * 2); }
  __device__ static float coef(int s) {
    return s == 1 ? (float)(4.0 / 3.0) : (float)(-1.0 / 12.0);
  }
};

template <>
struct Stencil<8> {
  static constexpr int HW = 4;
  static constexpr bool UNIT = false;
  __device__ static float center() { return (float)((-205.0 / 72.0) * 3); }
  __device__ static float center2d() { return (float)((-205.0 / 72.0) * 2); }
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

// laplacian_nd's tree at a point whose z column is the ring zr (planes
// z-HW .. z+HW) and whose plane lies in shared memory around p (row pitch
// PITCH): the same taps in the same order as lap_tree.
template <int ORDER, int PITCH>
__device__ __forceinline__ float lap_ring(const float (&zr)[2 * Stencil<ORDER>::HW + 1],
                                          const float* p) {
  constexpr int HW = Stencil<ORDER>::HW;
  float acc = __fmul_rn(Stencil<ORDER>::center(), zr[HW]);
#pragma unroll
  for (int s = 1; s <= HW; ++s) acc = tap<ORDER>(acc, s, zr[HW - s], zr[HW + s]);
#pragma unroll
  for (int s = 1; s <= HW; ++s) acc = tap<ORDER>(acc, s, p[-s * PITCH], p[s * PITCH]);
#pragma unroll
  for (int s = 1; s <= HW; ++s) acc = tap<ORDER>(acc, s, p[-s], p[s]);
  return acc;
}

// The cross halo of a TX x TY tile in its (TY + 2HW) x (TX + 2HW) shared
// plane: HW rows above and below the tile, then HW columns left and right
// of it (no corners), NH = 2HW(TX + TY) slots dealt to the block's threads
// in turn. Slot t of thread tid (valid while tid + t*TX*TY < NH) is at row
// hrow[t], column hcol[t] of the plane.
template <int HW, int TX, int TY, int NHT>
__device__ __forceinline__ void halo_slots(int tid, int (&hrow)[NHT], int (&hcol)[NHT]) {
#pragma unroll
  for (int t = 0; t < NHT; ++t) {
    const int k = tid + t * TX * TY;
    if (k < 2 * HW * TX) {
      const int j = k / TX;
      hrow[t] = j < HW ? j : TY + j;
      hcol[t] = HW + k % TX;
    } else {
      const int k2 = k - 2 * HW * TX, j = k2 % (2 * HW);
      hrow[t] = HW + k2 / (2 * HW);
      hcol[t] = j < HW ? j : TX + j;
    }
  }
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
//   a_core = (2*ebar + L(w)) - S*a2,   w = c2dt2*ebar
//   gc2'   = gc2 + L(u)*ebar,          u = dec(q) = float(q)*sc
//
// Replaces jets_tpu/ops/pallas_wave.py:fused_adjoint_step (_adjoint_kernel).
// Two values are stencilled: w, from a1 and c2dt2, and the history u, with
// q read at its stored width (f32, bf16 or int8). a2 and gc2 are read only
// at the output point, by the thread that writes it, which makes writing
// a_core into a2's buffer and gc2' into gc2's safe; a1, c2dt2 and q are
// never written. The receiver injection is not part of the kernel
// (ops/wave.py adds it with index_add_).
//
// Bound: device memory. A cell moves 25 B with an int8 history (a1, a2,
// gc2, c2dt2 and q read, a_core and gc2' written) against ~70 operations:
// 224 us at the (187, 401, 401) window of the 3-D gradient cell, 125 us at
// 256^3.
//
// Layout: z-marching, as K15. A block of 32 (x, one warp per tile row) by
// 16 (y) threads owns a 32 x 16 tile of (y, x), one point a thread, and
// walks kAZChunk = 64 consecutive z-planes. Each thread keeps w and u of its
// point on the planes z-HW .. z+HW in a register ring (the z taps; HW =
// ORDER/2). Plane z of both, with the in-plane halo of the cross (HW rows
// above and below the tile, HW columns on each side; no corners), is staged
// in shared memory for the y and x taps, two planes' buffers in turn, so a
// plane needs one barrier. w and u are computed once per staged point and
// block: the tile's points as they enter the ring (coalesced rows of a1,
// c2dt2 and q), the halo's per plane (384 halo points to the tile's 512 at
// order 8, mostly from L2). A thread's columns (its point and its halo
// points) keep their plane offset, grid test and sy, sx factors in
// registers; each plane adds one sz. Every load of plane z+1 (the ring's new
// plane z+1+HW, the halo's a1, c2dt2 and q, and a1, a2, gc2 at the thread's
// point, a1 mostly from cache) is issued before plane z's outputs are
// computed, and kept as the bits read until its use, so the memory's
// latency hides behind a plane of work. The chunk ends re-read 2*HW planes
// into the ring. Indices are 32-bit where the whole grid's flat index fits
// (the launcher picks the instantiation from the grid), else 64-bit.
// Out-of-grid values are +0.0f (the zero padding); threads past the grid's
// edge stage zeros and write nothing, and no barrier is skipped.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; order 8, int8 history, the window
// with the cell's 20-cell free-surface sponge, through jt_adjoint_step, CUDA
// events over 50 calls): 0.390 ms, 57% of the bound (order 2 at 256^3:
// 185-188 us, 67%); 64 registers (2 blocks an SM), no spills with 32-bit
// indices (36 bytes with 64-bit ones). The one-point-a-thread layout it
// replaced (w rebuilt at each of the 25 taps from two field and three sponge
// loads, each history tap a global load) took 1.45 ms in the same calls
// (1.62 ms a launch in the gradient cell's trace), 231 us at 256^3. Tried on
// the way, each against the last kept: K15's parameters (a 32 x 8 tile,
// 32-plane chunks, 3 blocks, an ebar ring beside w and u) 0.565 ms; tiles
// of 32 x 4, 32 x 12, 64 x 8 and 32 x 8 with 4 blocks 0.53-0.72; 32 x 16
// 0.487 and 32 x 32 (one block an SM) 0.474 but 209 us at order 2; chunks
// of 16, 24 and 48 planes no faster; an L2 prefetch of the planes 2-8 ahead
// 0.54-0.56; the per-column registers 0.456; a1 reloaded at the point in
// place of the ebar ring 0.439; 64-plane chunks 0.429; 32-bit indices
// 0.391. TMA loads were not tried.
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

constexpr int kAX = 32;         // threads along x: one warp per tile row
constexpr int kAY = 16;         // threads along y: the tile is kAX x kAY
constexpr int kAZChunk = 64;    // z-planes a block walks
constexpr int kAMinBlocks = 2;  // blocks an SM holds

// A column (y, x) of the grid that a thread stages: its offset in a plane,
// whether it lies in the grid, and its sponge factors sy[y] and sx[x] (0
// outside), which stay the same down the column.
template <typename I>
struct Column {
  I j;
  bool in;
  float sy, sx;
};

// I: the index type, int32_t where every flat index of the grid fits it (no
// spills at order 8, and cheaper address arithmetic), else int64_t.
template <int ORDER, typename Q, typename I>
__global__ void __launch_bounds__(kAX * kAY, kAMinBlocks)
adjoint_kernel(const float* __restrict__ a1, const float* a2, const float* gc2,
               const float* __restrict__ c2, const Q* __restrict__ q,
               const float* __restrict__ scp, const float* __restrict__ spz,
               const float* __restrict__ sy, const float* __restrict__ sx,
               float* core_out, float* gc2_out, Grid g) {
  constexpr int HW = Stencil<ORDER>::HW;
  constexpr int R = 2 * HW + 1;                        // ring: planes z-HW .. z+HW
  constexpr int SY = kAY + 2 * HW, SX = kAX + 2 * HW;  // shared plane with its halo
  constexpr int NT = kAX * kAY;
  constexpr int NH = 2 * HW * (kAX + kAY);             // halo points of the cross
  constexpr int NHT = (NH + NT - 1) / NT;              // of them, per thread
  __shared__ float ws[2][SY][SX];  // w = c2dt2*(a1*S), even and odd planes z
  __shared__ float us[2][SY][SX];  // u = q*sc
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kAX + tx;
  const I D = (I)g.D, H = (I)g.H, W = (I)g.W, plane = H * W;
  const I x = (I)blockIdx.x * kAX + tx, y = (I)blockIdx.y * kAY + ty;
  const I z0 = (I)blockIdx.z * kAZChunk;
  const I z1 = z0 + kAZChunk < D ? z0 + kAZChunk : D;
  const float sc = *scp;
  auto column = [&](I yy, I xx) -> Column<I> {
    const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
    return {in ? yy * W + xx : 0, in, in ? __ldg(sy + yy) : 0.0f, in ? __ldg(sx + xx) : 0.0f};
  };
  const Column<I> pc = column(y, x);  // this thread's point
  // this thread's halo points of the cross, the same in every plane
  int hrow[NHT], hcol[NHT];
  halo_slots<HW, kAX, kAY>(tid, hrow, hcol);
  Column<I> hc[NHT];
#pragma unroll
  for (int t = 0; t < NHT; ++t) {
    hc[t] = tid + t * NT < NH ? column(y - ty + hrow[t] - HW, x - tx + hcol[t] - HW)
                              : Column<I>{0, false, 0.0f, 0.0f};
  }
  auto in_z = [&](I z) { return z >= 0 && z < D; };
  auto sz_of = [&](I z) { return in_z(z) ? __ldg(spz + z) : 0.0f; };
  // (a1, c2dt2) and q at column c of plane z, as loaded
  auto w_bits = [&](I z, const Column<I>& c) -> float2 {
    if (!c.in || !in_z(z)) return make_float2(0.0f, 0.0f);
    const I j = z * plane + c.j;
    return make_float2(__ldg(a1 + j), __ldg(c2 + j));
  };
  auto q_bits = [&](I z, const Column<I>& c) -> Q {
    return c.in && in_z(z) ? __ldg(q + z * plane + c.j) : Q();
  };
  // ebar = a1*S and u = q*sc from the bits, sz the plane's sponge factor
  auto ebar_of = [&](I z, float sz, const Column<I>& c, float2 b) -> float {
    return c.in && in_z(z) ? __fmul_rn(b.x, __fmul_rn(__fmul_rn(sz, c.sy), c.sx)) : 0.0f;
  };
  auto u_of = [&](I z, const Column<I>& c, Q b) -> float {
    return c.in && in_z(z) ? __fmul_rn(to_f32<Q>(b), sc) : 0.0f;
  };
  // the bits plane z's step reads: the ring's new plane z+HW, the halo and
  // this thread's point
  float2 rw, hwb[NHT];
  Q rq, hq[NHT];
  float pa1, pa2, pgc2;
  auto load_plane = [&](I z) {
    rw = w_bits(z + HW, pc);
    rq = q_bits(z + HW, pc);
    const I i = z * plane + pc.j;
    pa1 = pc.in ? __ldg(a1 + i) : 0.0f;
    pa2 = pc.in ? a2[i] : 0.0f;
    pgc2 = pc.in ? gc2[i] : 0.0f;
#pragma unroll
    for (int t = 0; t < NHT; ++t) {
      hwb[t] = w_bits(z, hc[t]);
      hq[t] = q_bits(z, hc[t]);
    }
  };
  float wr[R], ur[R];
#pragma unroll
  for (int k = 0; k < R - 1; ++k) {
    const I zk = z0 - HW + k;
    const float2 bk = w_bits(zk, pc);
    wr[k] = __fmul_rn(bk.y, ebar_of(zk, sz_of(zk), pc, bk));
    ur[k] = u_of(zk, pc, q_bits(zk, pc));
  }
  load_plane(z0);
  for (I z = z0; z < z1; ++z) {
    const int b = (int)(z & 1);
    const float sz = sz_of(z);
    wr[R - 1] = __fmul_rn(rw.y, ebar_of(z + HW, sz_of(z + HW), pc, rw));
    ur[R - 1] = u_of(z + HW, pc, rq);
    ws[b][ty + HW][tx + HW] = wr[HW];
    us[b][ty + HW][tx + HW] = ur[HW];
#pragma unroll
    for (int t = 0; t < NHT; ++t) {
      if (tid + t * NT < NH) {
        ws[b][hrow[t]][hcol[t]] = __fmul_rn(hwb[t].y, ebar_of(z, sz, hc[t], hwb[t]));
        us[b][hrow[t]][hcol[t]] = u_of(z, hc[t], hq[t]);
      }
    }
    // plane z is staged; the buffer written next (plane z+1) was last read
    // at plane z-1, before this barrier
    __syncthreads();
    const float ca1 = pa1, ca2 = pa2, cgc2 = pgc2;
    if (z + 1 < z1) load_plane(z + 1);  // in flight while plane z is computed
    if (pc.in) {
      const float lap_w = lap_ring<ORDER, SX>(wr, &ws[b][ty + HW][tx + HW]);
      const float lap_u = lap_ring<ORDER, SX>(ur, &us[b][ty + HW][tx + HW]);
      const I i = z * plane + pc.j;
      const float s = __fmul_rn(__fmul_rn(sz, pc.sy), pc.sx);
      const float ebar = __fmul_rn(ca1, s);
      const float ebar_next = __fmul_rn(ca2, s);
      gc2_out[i] = __fadd_rn(cgc2, __fmul_rn(lap_u, ebar));
      core_out[i] = __fsub_rn(__fadd_rn(__fmul_rn(2.0f, ebar), lap_w), ebar_next);
    }
#pragma unroll
    for (int k = 0; k < R - 1; ++k) {
      wr[k] = wr[k + 1];
      ur[k] = ur[k + 1];
    }
  }
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

// ---------------------------------------------------------------------------
// K4-2D and K5-2D: K4's and K5's functions over a batch of B two-dimensional
// shots, (B, H, W), in one launch each.
//
// Replaces no TPU kernel: the JAX package's 2-D step is XLA (pallas_wave.py
// has 3-D kernels only). Added because a 2-D gradient stacks its shots
// under torch.func.vmap, where each plain step was ~37 device operations a
// shot and the host's dispatch of them, not the card, set the pace. The
// batching rule of ops/cuda_wave.py hands the stacked shots to these kernels
// as their leading dimension, so a step of the whole batch is one launch.
//
//   K4-2D: u' = ((2u - u_prev) + c2dt2*L(u))*S + s_t*amp*[cell == src_b]
//   K5-2D: ebar = S*a1,  a_core = (2*ebar + L(c2dt2*ebar)) - S*a2,
//          gc2' = gc2 + L(q*sc)*ebar
//
// with S the full-grid 2-D sponge (a 2-D grid keeps its sponge whole) and
// L the 2-D tree of ops/stencil.laplacian_nd: ((c0*2)*c), then axis 0's
// (y's) taps, then axis 1's (x's). Every operand has a batch stride in
// elements, 0 for one the batch shares (S, s_t, amp, a field made before
// the batch diverged) or H*W (one for the per-shot scalars src, sc). The
// per-shot source index src_b and history scale sc_b are read from device
// memory, so a vmapped loop needs no host read of a batched value.
//
// Bound: device memory. A cell moves 16 B forward (u_prev, u, c2dt2 read,
// u' written; S is shared by the batch and stays in the 50 MB L2 while the
// shots pass) and 25 B reverse (a1, a2, gc2, c2dt2 and the int8 q read,
// a_core and gc2' written), against ~30 and ~70 operations. At the
// Marmousi window (751, 895) one f32 field of one shot is 2.69 MB. Each
// block stages a (32 + 2*HW) x (32 + 2*HW) tile of the stencilled field(s)
// with their order/2-cell halos in shared memory (40 x 40 floats at order
// 8; K5-2D stages w = c2dt2*ebar and q*sc, 12.8 KB), so the 17-point cross
// is read from shared memory and each input cell leaves device memory once
// (the halos, 1.56x the tile at order 8, come from L2). 256 threads, 32
// along x (coalesced rows) by 8 along y, each computing 4 rows of the
// 32 x 32 tile. Grid (W/32, H/32, B): one launch covers the batch.
// Out-of-grid taps read +0.0f, as the zero padding does.
// ---------------------------------------------------------------------------

constexpr int kT2 = 32;  // 2-D tile: 32 x 32 cells
constexpr int kR2 = 8;   // thread rows; each thread computes kT2 / kR2 rows

template <int ORDER, class At>
__device__ __forceinline__ float lap_tree2d(const At& at) {
  constexpr int HW = Stencil<ORDER>::HW;
  float acc = __fmul_rn(Stencil<ORDER>::center2d(), at(0, 0));
#pragma unroll
  for (int s = 1; s <= HW; ++s) acc = tap<ORDER>(acc, s, at(-s, 0), at(s, 0));
#pragma unroll
  for (int s = 1; s <= HW; ++s) acc = tap<ORDER>(acc, s, at(0, -s), at(0, s));
  return acc;
}

// Fills a (kT2 + 2HW)^2 shared tile, row-major, with value(j) at each cell
// j = y*W + x of the tile and its halo that lies in the grid, +0.0f outside.
template <int HW, class Value>
__device__ __forceinline__ void fill_tile(float (*tile)[kT2 + 2 * HW], int64_t y0,
                                          int64_t x0, int64_t H, int64_t W,
                                          const Value& value) {
  constexpr int SW = kT2 + 2 * HW;
  for (int k = threadIdx.y * kT2 + threadIdx.x; k < SW * SW; k += kT2 * kR2) {
    const int r = k / SW, c = k - (k / SW) * SW;
    const int64_t y = y0 + r - HW, x = x0 + c - HW;
    tile[r][c] = (y >= 0 && y < H && x >= 0 && x < W) ? value(y * W + x) : 0.0f;
  }
}

template <int ORDER>
__global__ void __launch_bounds__(kT2 * kR2)
leapfrog2d_kernel(const float* u_prev, int64_t sb_up, const float* __restrict__ u,
                  int64_t sb_u, const float* __restrict__ c2, int64_t sb_c2,
                  const float* __restrict__ sp, int64_t sb_sp,
                  const float* __restrict__ s_tp, int64_t sb_st,
                  const float* __restrict__ ampp, int64_t sb_amp,
                  const int64_t* __restrict__ src, int64_t sb_src, float* out,
                  int64_t H, int64_t W) {
  constexpr int HW = Stencil<ORDER>::HW;
  __shared__ float tile[kT2 + 2 * HW][kT2 + 2 * HW];
  const int64_t b = blockIdx.z, HWn = H * W;
  const int64_t y0 = (int64_t)blockIdx.y * kT2, x0 = (int64_t)blockIdx.x * kT2;
  const float* ub = u + b * sb_u;
  fill_tile<HW>(tile, y0, x0, H, W, [&](int64_t j) { return __ldg(ub + j); });
  __syncthreads();
  const int64_t x = x0 + threadIdx.x;
  if (x >= W) return;
  const float* upb = u_prev + b * sb_up;
  const float* c2b = c2 + b * sb_c2;
  const float* spb = sp + b * sb_sp;
  float* ob = out + b * HWn;
  const float s_t = s_tp[b * sb_st], amp = ampp[b * sb_amp];
  const int64_t sb = src[b * sb_src];
#pragma unroll
  for (int k = 0; k < kT2 / kR2; ++k) {
    const int ly = threadIdx.y + k * kR2;
    const int64_t y = y0 + ly;
    if (y >= H) break;
    auto at = [&](int dy, int dx) -> float {
      return tile[ly + HW + dy][threadIdx.x + HW + dx];
    };
    const float lap = lap_tree2d<ORDER>(at);
    const int64_t i = y * W + x;
    const float e = __fadd_rn(__fsub_rn(__fmul_rn(2.0f, at(0, 0)), upb[i]),
                              __fmul_rn(c2b[i], lap));
    const float mask = i == sb ? amp : 0.0f;
    ob[i] = __fadd_rn(__fmul_rn(e, spb[i]), __fmul_rn(s_t, mask));
  }
}

template <int ORDER, typename Q>
__global__ void __launch_bounds__(kT2 * kR2)
adjoint2d_kernel(const float* __restrict__ a1, int64_t sb_a1, const float* a2,
                 int64_t sb_a2, const float* gc2, int64_t sb_g,
                 const float* __restrict__ c2, int64_t sb_c2, const Q* __restrict__ q,
                 int64_t sb_q, const float* __restrict__ scp, int64_t sb_sc,
                 const float* __restrict__ sp, int64_t sb_sp, float* core_out,
                 float* gc2_out, int64_t H, int64_t W) {
  constexpr int HW = Stencil<ORDER>::HW;
  __shared__ float wt[kT2 + 2 * HW][kT2 + 2 * HW];  // c2dt2 * (a1 * S)
  __shared__ float ut[kT2 + 2 * HW][kT2 + 2 * HW];  // dec(q) = q * sc
  const int64_t b = blockIdx.z, HWn = H * W;
  const int64_t y0 = (int64_t)blockIdx.y * kT2, x0 = (int64_t)blockIdx.x * kT2;
  const float* a1b = a1 + b * sb_a1;
  const float* c2b = c2 + b * sb_c2;
  const float* spb = sp + b * sb_sp;
  const Q* qb = q + b * sb_q;
  const float sc = scp[b * sb_sc];
  fill_tile<HW>(wt, y0, x0, H, W, [&](int64_t j) {
    return __fmul_rn(__ldg(c2b + j), __fmul_rn(__ldg(a1b + j), __ldg(spb + j)));
  });
  fill_tile<HW>(ut, y0, x0, H, W,
                [&](int64_t j) { return __fmul_rn(to_f32<Q>(__ldg(qb + j)), sc); });
  __syncthreads();
  const int64_t x = x0 + threadIdx.x;
  if (x >= W) return;
  const float* a2b = a2 + b * sb_a2;
  const float* gb = gc2 + b * sb_g;
  float* cob = core_out + b * HWn;
  float* gob = gc2_out + b * HWn;
#pragma unroll
  for (int k = 0; k < kT2 / kR2; ++k) {
    const int ly = threadIdx.y + k * kR2;
    const int64_t y = y0 + ly;
    if (y >= H) break;
    const int tx = threadIdx.x + HW, ty = ly + HW;
    const float lap_w = lap_tree2d<ORDER>(
        [&](int dy, int dx) -> float { return wt[ty + dy][tx + dx]; });
    const float lap_u = lap_tree2d<ORDER>(
        [&](int dy, int dx) -> float { return ut[ty + dy][tx + dx]; });
    const int64_t i = y * W + x;
    const float s = spb[i];
    const float ebar = __fmul_rn(a1b[i], s);
    const float ebar_next = __fmul_rn(a2b[i], s);
    const float g_new = __fadd_rn(gb[i], __fmul_rn(lap_u, ebar));
    const float core = __fsub_rn(__fadd_rn(__fmul_rn(2.0f, ebar), lap_w), ebar_next);
    gob[i] = g_new;
    cob[i] = core;
  }
}

// ---------------------------------------------------------------------------
// K15  reverse constant-Q step of the stored-history (c, Q) adjoint, with
// og = 1-g, ig = 1/(1+g), S = (sz*sy)*sx and u = dec(q) = float(q)*sc:
//   sbar = a1*S,  ebar = ig*sbar,  sbar_next = a2*S,  ebar_next = ig*sbar_next
//   gC'  = gC + L(u)*ebar
//   gig' = gig + (sbar*(2u + C*L(u)) - og*(u*sbar_next))
//   gog' = gog - u*ebar_next
//   core = (2*ebar + L(w)) - og*ebar_next,   w = C*ebar
//
// Replaces no TPU kernel: the JAX package's reverse Q sweep
// (jets_tpu/ops/wave.py, _adjoint_stored_q) is XLA. Added because that
// sweep, as plain PyTorch, ran each reverse step as ~100 device operations
// over whole fields, more than 25 times the bytes of one fused pass. Every
// term is formed in the order of ops/cuda_wave.q_adjoint_plain, as K14 forms
// og and ig from the loaded g (f32, or bf16 upcast: template G), and the
// history q is read at its stored width (template Q), so the kernel is
// bitwise equal to the plain step. core may be written into a2's buffer and
// gC', gig', gog' into their inputs' (each is read only at the output
// point, by the thread that writes it); a1 is stencilled and never written.
// The receiver injection is not part of the kernel (ops/wave.py adds it with
// index_add_).
//
// Bound: device memory. A cell moves 45 B: a1, a2, C, g, gC, gig, gog read
// (f32) with the int8 snapshot, core, gC', gig', gog' written; about 130
// operations, far below the card's balance point. 404 us at the (187, 401,
// 401) window. The one-point-a-thread layout K5 had before it marched too
// (each tap re-read through the caches and w rebuilt per tap) reached 14% of
// its bound at order 8 and would pay a division per tap here, so K15 stages
// instead:
//
// Layout: z-marching (K11-K13's pattern, with a register ring). A block of
// 32 (x, one warp per row) by 8 (y) threads owns a 32 x 8 tile of (y, x),
// one point a thread, and walks kQZChunk = 32 consecutive z-planes. Each
// thread keeps the stencilled values w and u of its point on the planes
// z-HW .. z+HW in a register ring (the z taps; HW = ORDER/2); plane z of
// both, with the in-plane halo of the cross (HW rows above and below the
// tile, HW columns on each side; no corners), is staged in shared memory for
// the y and x taps, two planes' buffers in turn, so a plane needs one
// barrier. w and u are computed once per staged point and block: the tile's
// points as they enter the ring (coalesced rows of a1, C, g and q), the
// halo's per plane from L2 (320 halo points to the tile's 256 at order 8).
// Every load of plane z+1 (the ring's new plane z+1+HW, the halo, a1, a2,
// C, g and the accumulators at the thread's point; a1, C and g again, mostly
// from L2) is issued before plane z's outputs are computed, and kept as the
// bits read until its use, so the memory's latency hides behind a plane of
// work. The chunk ends re-read 2*HW planes into the ring. Out-of-grid values
// are +0.0f (the zero padding); threads past the grid's edge stage zeros and
// write nothing, and no barrier is skipped.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; order 8, int8 history, f32 g, the
// (187, 401, 401) window): 80 registers (3 blocks an SM; 44 bytes of spill
// loads), 0.80 ms, 50% of the bound. Latency, not bytes, is what is left. With each
// plane's loads issued at the start of that plane (two barriers a plane),
// the same layout took 1.23-1.47 ms, and 1.90 ms with the point's loads
// after the barriers; 2 points a thread (a 32 x 16 tile, less halo, 128
// registers, 2 blocks) 0.79 ms; chunks of 48 or 64 planes were no faster.
// ---------------------------------------------------------------------------

constexpr int kQX = 32;         // threads along x: one warp per tile row
constexpr int kQY = 8;          // threads along y: the tile is 32 x 8
constexpr int kQZChunk = 32;    // z-planes a block walks
constexpr int kQMinBlocks = 3;  // blocks an SM holds: at most 80 registers

// What K15 reads of a1, C and g at one point to form w there: the bits as
// loaded (g unconverted), so that a load waits on nothing until its use.
template <typename G>
struct WBits {
  float a1, c2;
  G g;
};

template <int ORDER, typename Q, typename G>
__global__ void __launch_bounds__(kQX * kQY, kQMinBlocks)
q_adjoint_kernel(const float* __restrict__ a1, const float* a2, const float* gC,
                 const float* gig, const float* gog, const float* __restrict__ c2,
                 const G* __restrict__ gf, const Q* __restrict__ q,
                 const float* __restrict__ scp, const float* __restrict__ spz,
                 const float* __restrict__ sy, const float* __restrict__ sx,
                 float* core_out, float* gC_out, float* gig_out, float* gog_out, Grid g) {
  constexpr int HW = Stencil<ORDER>::HW;
  constexpr int R = 2 * HW + 1;                        // ring: planes z-HW .. z+HW
  constexpr int SY = kQY + 2 * HW, SX = kQX + 2 * HW;  // shared plane with its halo
  constexpr int NT = kQX * kQY;
  constexpr int NH = 2 * HW * (kQX + kQY);             // halo points of the cross
  constexpr int NHT = (NH + NT - 1) / NT;              // of them, per thread
  __shared__ float ws[2][SY][SX];  // w = C*(ig*(a1*S)), even and odd planes z
  __shared__ float us[2][SY][SX];  // u = q*sc
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kQX + tx;
  const int64_t x = (int64_t)blockIdx.x * kQX + tx, y = (int64_t)blockIdx.y * kQY + ty;
  const int64_t z0 = (int64_t)blockIdx.z * kQZChunk;
  const int64_t z1 = z0 + kQZChunk < g.D ? z0 + kQZChunk : g.D;
  const int64_t plane = g.H * g.W;
  const bool on = x < g.W && y < g.H;  // this thread's point lies in the grid
  const float sc = *scp;
  auto w_bits = [&](int64_t z, int64_t yy, int64_t xx) -> WBits<G> {
    if (!g.inside(z, yy, xx)) return {0.0f, 0.0f, G()};
    const int64_t j = z * plane + yy * g.W + xx;
    return {__ldg(a1 + j), __ldg(c2 + j), __ldg(gf + j)};
  };
  auto q_bits = [&](int64_t z, int64_t yy, int64_t xx) -> Q {
    return g.inside(z, yy, xx) ? __ldg(q + z * plane + yy * g.W + xx) : Q();
  };
  auto w_of = [&](int64_t z, int64_t yy, int64_t xx, const WBits<G>& b) -> float {
    if (!g.inside(z, yy, xx)) return 0.0f;
    const float s = __fmul_rn(__fmul_rn(__ldg(spz + z), __ldg(sy + yy)), __ldg(sx + xx));
    const float ig = __fdiv_rn(1.0f, __fadd_rn(1.0f, to_f32<G>(b.g)));
    return __fmul_rn(b.c2, __fmul_rn(ig, __fmul_rn(b.a1, s)));
  };
  auto u_of = [&](int64_t z, int64_t yy, int64_t xx, Q b) -> float {
    return g.inside(z, yy, xx) ? __fmul_rn(to_f32<Q>(b), sc) : 0.0f;
  };
  // this thread's halo points of the cross, the same in every plane: the
  // strips above and below the tile, then those left and right of it
  int hrow[NHT], hcol[NHT];
  halo_slots<HW, kQX, kQY>(tid, hrow, hcol);
  auto mine = [&](int t) { return tid + t * NT < NH; };
  auto hy = [&](int t) { return y - ty + hrow[t] - HW; };
  auto hx = [&](int t) { return x - tx + hcol[t] - HW; };
  // the bits plane z's step reads: the ring's new plane z+HW, the halo and
  // this thread's point
  WBits<G> rw, hwb[NHT], pw;
  Q rq, hq[NHT];
  float pa2, pgC, pgig, pgog;
  auto load_plane = [&](int64_t z) {
    rw = w_bits(z + HW, y, x);
    rq = q_bits(z + HW, y, x);
    pw = w_bits(z, y, x);
    const int64_t i = z * plane + y * g.W + x;
    pa2 = on ? a2[i] : 0.0f;
    pgC = on ? gC[i] : 0.0f;
    pgig = on ? gig[i] : 0.0f;
    pgog = on ? gog[i] : 0.0f;
#pragma unroll
    for (int t = 0; t < NHT; ++t) {
      hwb[t] = mine(t) ? w_bits(z, hy(t), hx(t)) : WBits<G>{0.0f, 0.0f, G()};
      hq[t] = mine(t) ? q_bits(z, hy(t), hx(t)) : Q();
    }
  };
  float wr[R], ur[R];  // the ring up to plane z0+HW-1
#pragma unroll
  for (int k = 0; k < R - 1; ++k) {
    wr[k] = w_of(z0 - HW + k, y, x, w_bits(z0 - HW + k, y, x));
    ur[k] = u_of(z0 - HW + k, y, x, q_bits(z0 - HW + k, y, x));
  }
  load_plane(z0);
  for (int64_t z = z0; z < z1; ++z) {
    const int b = (int)(z & 1);
    wr[R - 1] = w_of(z + HW, y, x, rw);
    ur[R - 1] = u_of(z + HW, y, x, rq);
    ws[b][ty + HW][tx + HW] = wr[HW];
    us[b][ty + HW][tx + HW] = ur[HW];
#pragma unroll
    for (int t = 0; t < NHT; ++t) {
      if (mine(t)) {
        ws[b][hrow[t]][hcol[t]] = w_of(z, hy(t), hx(t), hwb[t]);
        us[b][hrow[t]][hcol[t]] = u_of(z, hy(t), hx(t), hq[t]);
      }
    }
    // plane z is staged; the buffer written next (plane z+1) was last read
    // at plane z-1, before this barrier
    __syncthreads();
    const WBits<G> cw = pw;
    const float ca2 = pa2, cgC = pgC, cgig = pgig, cgog = pgog;
    if (z + 1 < z1) load_plane(z + 1);  // in flight while plane z is computed
    if (on) {
      const float lap_w = lap_ring<ORDER, SX>(wr, &ws[b][ty + HW][tx + HW]);
      const float lap_u = lap_ring<ORDER, SX>(ur, &us[b][ty + HW][tx + HW]);
      const int64_t i = z * plane + y * g.W + x;
      const float s = __fmul_rn(__fmul_rn(__ldg(spz + z), __ldg(sy + y)), __ldg(sx + x));
      const float gv = to_f32<G>(cw.g);
      const float og = __fsub_rn(1.0f, gv);
      const float ig = __fdiv_rn(1.0f, __fadd_rn(1.0f, gv));
      const float sbar = __fmul_rn(cw.a1, s);
      const float ebar = __fmul_rn(ig, sbar);
      const float sbar_next = __fmul_rn(ca2, s);
      const float ebar_next = __fmul_rn(ig, sbar_next);
      const float u = ur[HW];
      const float c_lap = __fmul_rn(cw.c2, lap_u);
      gC_out[i] = __fadd_rn(cgC, __fmul_rn(lap_u, ebar));
      gig_out[i] = __fadd_rn(
          cgig, __fsub_rn(__fmul_rn(sbar, __fadd_rn(__fmul_rn(2.0f, u), c_lap)),
                          __fmul_rn(og, __fmul_rn(u, sbar_next))));
      gog_out[i] = __fsub_rn(cgog, __fmul_rn(u, ebar_next));
      core_out[i] =
          __fsub_rn(__fadd_rn(__fmul_rn(2.0f, ebar), lap_w), __fmul_rn(og, ebar_next));
    }
#pragma unroll
    for (int k = 0; k < R - 1; ++k) {
      wr[k] = wr[k + 1];
      ur[k] = ur[k + 1];
    }
  }
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline dim3 grid2d_of(int64_t B, int64_t H, int64_t W) {
  return dim3((unsigned)cdiv(W, kT2), (unsigned)cdiv(H, kT2), (unsigned)B);
}

template <typename Q>
int launch_adjoint2d(int order, const void* a1, int64_t sb_a1, const void* a2,
                     int64_t sb_a2, const void* gc2, int64_t sb_g, const void* c2,
                     int64_t sb_c2, const void* q, int64_t sb_q, const void* sc,
                     int64_t sb_sc, const void* sp, int64_t sb_sp, void* core_out,
                     void* gc2_out, int64_t B, int64_t H, int64_t W, cudaStream_t st) {
  const dim3 grid = grid2d_of(B, H, W), block(kT2, kR2);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Q* qq = static_cast<const Q*>(q);
  float* co = static_cast<float*>(core_out);
  float* go = static_cast<float*>(gc2_out);
  switch (order) {
    case 2:
      adjoint2d_kernel<2, Q><<<grid, block, 0, st>>>(
          f(a1), sb_a1, f(a2), sb_a2, f(gc2), sb_g, f(c2), sb_c2, qq, sb_q, f(sc), sb_sc,
          f(sp), sb_sp, co, go, H, W);
      break;
    case 4:
      adjoint2d_kernel<4, Q><<<grid, block, 0, st>>>(
          f(a1), sb_a1, f(a2), sb_a2, f(gc2), sb_g, f(c2), sb_c2, qq, sb_q, f(sc), sb_sc,
          f(sp), sb_sp, co, go, H, W);
      break;
    case 8:
      adjoint2d_kernel<8, Q><<<grid, block, 0, st>>>(
          f(a1), sb_a1, f(a2), sb_a2, f(gc2), sb_g, f(c2), sb_c2, qq, sb_q, f(sc), sb_sc,
          f(sp), sb_sp, co, go, H, W);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

inline dim3 grid_of(const Grid& g) {
  return dim3((unsigned)cdiv(g.W, kBX), (unsigned)cdiv(g.H, kBY), (unsigned)g.D);
}

template <int ORDER, typename Q>
int launch_adjoint_at(const void* a1, const void* a2, const void* gc2, const void* c2,
                      const void* q, const void* sc, const void* spz, const void* sy,
                      const void* sx, void* core_out, void* gc2_out, Grid g,
                      cudaStream_t st) {
  const dim3 grid((unsigned)cdiv(g.W, kAX), (unsigned)cdiv(g.H, kAY),
                  (unsigned)cdiv(g.D, kAZChunk));
  const dim3 block(kAX, kAY);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Q* qq = static_cast<const Q*>(q);
  float* co = static_cast<float*>(core_out);
  float* go = static_cast<float*>(gc2_out);
  if (g.D * g.H * g.W <= INT32_MAX) {
    adjoint_kernel<ORDER, Q, int32_t><<<grid, block, 0, st>>>(
        f(a1), f(a2), f(gc2), f(c2), qq, f(sc), f(spz), f(sy), f(sx), co, go, g);
  } else {
    adjoint_kernel<ORDER, Q, int64_t><<<grid, block, 0, st>>>(
        f(a1), f(a2), f(gc2), f(c2), qq, f(sc), f(spz), f(sy), f(sx), co, go, g);
  }
  return (int)cudaGetLastError();
}

template <typename Q>
int launch_adjoint(int order, const void* a1, const void* a2, const void* gc2,
                   const void* c2, const void* q, const void* sc,
                   const void* spz, const void* sy, const void* sx,
                   void* core_out, void* gc2_out, Grid g, cudaStream_t st) {
  switch (order) {
    case 2:
      return launch_adjoint_at<2, Q>(a1, a2, gc2, c2, q, sc, spz, sy, sx, core_out,
                                     gc2_out, g, st);
    case 4:
      return launch_adjoint_at<4, Q>(a1, a2, gc2, c2, q, sc, spz, sy, sx, core_out,
                                     gc2_out, g, st);
    case 8:
      return launch_adjoint_at<8, Q>(a1, a2, gc2, c2, q, sc, spz, sy, sx, core_out,
                                     gc2_out, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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

template <int ORDER, typename Q, typename G>
int launch_q_adjoint_at(const void* const* in, void* const* out, Grid g, cudaStream_t st) {
  const dim3 grid((unsigned)cdiv(g.W, kQX), (unsigned)cdiv(g.H, kQY),
                  (unsigned)cdiv(g.D, kQZChunk));
  const dim3 block(kQX, kQY);
  auto f = [&](int k) { return static_cast<const float*>(in[k]); };
  auto o = [&](int k) { return static_cast<float*>(out[k]); };
  q_adjoint_kernel<ORDER, Q, G><<<grid, block, 0, st>>>(
      f(0), f(1), f(2), f(3), f(4), f(5), static_cast<const G*>(in[6]),
      static_cast<const Q*>(in[7]), f(8), f(9), f(10), f(11), o(0), o(1), o(2), o(3), g);
  return (int)cudaGetLastError();
}

template <typename Q, typename G>
int launch_q_adjoint(int order, const void* const* in, void* const* out, Grid g,
                     cudaStream_t st) {
  switch (order) {
    case 2:
      return launch_q_adjoint_at<2, Q, G>(in, out, g, st);
    case 4:
      return launch_q_adjoint_at<4, Q, G>(in, out, g, st);
    case 8:
      return launch_q_adjoint_at<8, Q, G>(in, out, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename G>
int launch_q_adjoint_store(int order, int store, const void* const* in, void* const* out,
                           Grid g, cudaStream_t st) {
  switch (store) {
    case 0:
      return launch_q_adjoint<float, G>(order, in, out, g, st);
    case 1:
      return launch_q_adjoint<__nv_bfloat16, G>(order, in, out, g, st);
    case 2:
      return launch_q_adjoint<int8_t, G>(order, in, out, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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

// K4-2D over a (B, H, W) batch. Each operand comes with its batch stride in
// elements (0: shared by the batch). src is int64. out is (B, H, W) dense
// and may equal u_prev when u_prev is (in place); u must be another buffer.
int jt_leapfrog_step2d(const void* u_prev, int64_t sb_up, const void* u, int64_t sb_u,
                       const void* c2, int64_t sb_c2, const void* sp, int64_t sb_sp,
                       const void* s_t, int64_t sb_st, const void* amp, int64_t sb_amp,
                       const void* src, int64_t sb_src, void* out, int64_t B, int64_t H,
                       int64_t W, int order, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid2d_of(B, H, W), block(kT2, kR2);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int64_t* s = static_cast<const int64_t*>(src);
  float* o = static_cast<float*>(out);
  switch (order) {
    case 2:
      leapfrog2d_kernel<2><<<grid, block, 0, st>>>(f(u_prev), sb_up, f(u), sb_u, f(c2),
                                                   sb_c2, f(sp), sb_sp, f(s_t), sb_st,
                                                   f(amp), sb_amp, s, sb_src, o, H, W);
      break;
    case 4:
      leapfrog2d_kernel<4><<<grid, block, 0, st>>>(f(u_prev), sb_up, f(u), sb_u, f(c2),
                                                   sb_c2, f(sp), sb_sp, f(s_t), sb_st,
                                                   f(amp), sb_amp, s, sb_src, o, H, W);
      break;
    case 8:
      leapfrog2d_kernel<8><<<grid, block, 0, st>>>(f(u_prev), sb_up, f(u), sb_u, f(c2),
                                                   sb_c2, f(sp), sb_sp, f(s_t), sb_st,
                                                   f(amp), sb_amp, s, sb_src, o, H, W);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K5-2D over a (B, H, W) batch, batch strides as for K4-2D. store: 0 = f32,
// 1 = bf16, 2 = int8 history. core_out may equal a2 and gc2_out may equal
// gc2 when those are (B, H, W) dense (in place); a1, c2 and q must be other
// buffers.
int jt_adjoint_step2d(const void* a1, int64_t sb_a1, const void* a2, int64_t sb_a2,
                      const void* gc2, int64_t sb_g, const void* c2, int64_t sb_c2,
                      const void* q, int64_t sb_q, const void* sc, int64_t sb_sc,
                      const void* sp, int64_t sb_sp, void* core_out, void* gc2_out,
                      int64_t B, int64_t H, int64_t W, int order, int store,
                      void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (store) {
    case 0:
      return launch_adjoint2d<float>(order, a1, sb_a1, a2, sb_a2, gc2, sb_g, c2, sb_c2,
                                     q, sb_q, sc, sb_sc, sp, sb_sp, core_out, gc2_out, B,
                                     H, W, st);
    case 1:
      return launch_adjoint2d<__nv_bfloat16>(order, a1, sb_a1, a2, sb_a2, gc2, sb_g, c2,
                                             sb_c2, q, sb_q, sc, sb_sc, sp, sb_sp,
                                             core_out, gc2_out, B, H, W, st);
    case 2:
      return launch_adjoint2d<int8_t>(order, a1, sb_a1, a2, sb_a2, gc2, sb_g, c2, sb_c2,
                                      q, sb_q, sc, sb_sc, sp, sb_sp, core_out, gc2_out,
                                      B, H, W, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K15. store: 0 = f32, 1 = bf16, 2 = int8 history; gtype: 0 = f32, 1 = bf16
// friction field. core_out may equal a2 and gC_out, gig_out, gog_out may
// equal gC, gig, gog (in place); a1, c2, gf and q must be other buffers.
int jt_q_adjoint_step(const void* a1, const void* a2, const void* gC, const void* gig,
                      const void* gog, const void* c2, const void* gf, const void* q,
                      const void* sc, const void* spz, const void* sy, const void* sx,
                      void* core_out, void* gC_out, void* gig_out, void* gog_out,
                      int64_t D, int64_t H, int64_t W, int order, int store, int gtype,
                      void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Grid g{D, H, W};
  const void* in[12] = {a1, a2, gC, gig, gog, c2, gf, q, sc, spz, sy, sx};
  void* out[4] = {core_out, gC_out, gig_out, gog_out};
  switch (gtype) {
    case 0:
      return launch_q_adjoint_store<float>(order, store, in, out, g, st);
    case 1:
      return launch_q_adjoint_store<__nv_bfloat16>(order, store, in, out, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
