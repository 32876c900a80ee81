#!/usr/bin/env python3
"""Drive the PyTorch port (``jets_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``jets_tpu_torch/csrc`` (nvcc,
``sm_90a``), holds each against its plain PyTorch version at the shapes the
main path gives it, then runs the main path — the seismic flagship's LSQR
through the package's own entry points (``make_seismic_problem``,
``lsqr``) — at the repository's full sizes: the 3-D flagship (256³,
16 shots, 4096 receivers) with and without the fused adjoint epilogue,
the same problem against the CPU, and the 2-D headline (2048², 64 shots,
4096 receivers) — the second path, the 3-D FWI gradient
(``wave_propagator``, ``born_operator``, ``multishot_wave_operator``) at
the sizes of ``bench.py``'s wave stages: 256³ f32, order 2, 128
receivers, a single-shot forward and int8-stored gradient at nt=220, a
Born dot-product gate, and 16 shots in ``shot_map="map"`` mode at nt=120
— and the third, the 3-D VTI anisotropic FWI gradient
(``vti_wave_propagator``, ``multishot_vti_wave_operator``) at the size of
``bench.py``'s VTI stage: 256³ f32, model (c, ε, δ), a forward at nt=220,
an int8-stored gradient at nt=160 (all three blocks), the card against the
CPU, a Jacobian dot-product gate with an f32 history, and 16 shots in map
mode at nt=120 — and the fourth, the 3-D TTI anisotropic FWI gradient
(``tti_wave_propagator``, ``multishot_tti_wave_operator``) at the size of
``bench.py``'s TTI stages: 256³ f32, model (c, ε, δ, θ, φ), with f32 and
bf16 coefficient fields, a forward and an int8-stored gradient (all five
blocks) at nt=60, the card against the CPU on a (32, 64, 128) grid, the
θ = φ = 0 reduction to VTI, a Jacobian dot-product gate with an f32
history and the int8 gradient's cosine to it, and 2 shots in map mode —
and the fifth, the Krylov solvers after LSQR on the flagship (``cg`` on
``normal_operator(A, damp=0.1)``, preconditioned CG with a 32-probe
``jacobi_preconditioner``, ``cgls``, ``lsmr`` plain and hooked; 50
iterations at 3-D, 100 at 2-D, the card against the CPU at 10) — and the
sixth, the constant-Q visco-acoustic path (``q_wave_propagator``) at the
wave stages' geometry: model (c, Q) with Q = 50 and one seeded low-Q
anomaly to 25, f0 15 Hz, forwards at nt=220 with f32 and bf16 friction
fields, an int8-stored gradient at nt=120 (both blocks), the card against
the CPU on (32, 64, 128) (forward, stored and autodiff adjoints), the Q = ∞
reduction to ``wave_propagator``, a Jacobian gate with an f32 history and
the int8 gradient's cosines to it — and the seventh, the five BASELINE
configurations (``jets_tpu_torch.models.configs``) at their full sizes
through ``run_config``: CG on the 1000 × 1000 SPD composite (float64, and
float32 through K6a/K6b), LSQR deconvolution on 10⁴ samples, CGLS
deblurring on 512², LSQR on the 64-shot 128² and the 256-shot
128 × 128 × 64 seismic operators (K1, and K3 in 3-D), each with its
dot-product gate, its residual threshold, the card against the CPU and
its ms per iteration, then MINRES, BiCGStab, GMRES(20) and Chebyshev on
config 1's operator — and the eighth, the FWI inversion path at the wave
stages' geometry: bounded L-BFGS (``lbfgs`` on
``least_squares_objective``) over 16 shots in overlapping Ginsu windows
of (256, 128, 128) with int8 histories, the windowed gradient against
explicit slices and the windowed Born gate, NLCG on the VTI int8 gradient
with velocity-only bounds, Gauss–Newton with CGLS on 4 shots,
``remat_blocks`` 12 against 1 (traces and autograd gradients bitwise, peak
memory; VTI, TTI and Q at (32, 64, 128)), and CPML
(``cpml_wave_propagator``, its Born gates, its reflection against the
sponge's, and 2 shots of ``multishot_wave_operator(boundary="cpml")``),
each solve's launches held against its objective evaluations — and the
ninth, the wave physics no kernel computes, at the wave stages' geometry:
variable density and IsoDenQ (``vd_wave_propagator``,
``vdq_wave_propagator``; a seeded ±20% density anomaly, Q as the sixth
path) forwards at nt=220 and int8 gradients at nt=120, Q = ∞ bitwise
variable density, a Jacobian gate and int8-vs-f32 cosines; static Q on
VTI (forward nt=220, int8 gradient nt=160) and TTI (forward and int8
gradient nt=60, f32 and bf16 coefficients), Q = ∞ bitwise the K8/K9/K10
and K11/K12/K13 routes, ``fused=True`` refused, Jacobian gates; and
off-grid RTM (``offgrid_wave_propagator`` at order 8, nt=160, a
fractional source and a 64 × 64 receiver plane at depth 4.5): the Born
gate, the int8 RTM image against the autodiff adjoint, 3 LSQR iterations
of least-squares migration, integer positions against ``wave_propagator``
on K4 and the ``ops/sampling`` gates; each against the CPU at
(32, 64, 128), and each asserting that no wave kernel ran on the new
physics — and the tenth, the symmetric spaces and the DSP/transform
operator packs at the width of a 16-shot block of gathers (16, 4096, 2048)
float32: the processing chain of examples/06 (shift @ bandpass @ taper)
inverted by damped LSQR (50 iterations) and its db2 wavelet compression,
``rfft_operator`` onto the ``SymmetricSpace`` with its weighted gate and
``to_logical`` against ``fftn``, GMRES(16) on an FFT composite over
(1024, 1024) complex64, the deblending of examples/07 at one receiver's
full size (1024 shots of 2000 samples, LSQR on ``blend @ integration``,
100 iterations), and the gates of every other operator of the packs at
gather width (envelope, mix, roughness, nim, difference, integration,
translation, resampling, mute, square, sqrt, interpolation with a bitwise
repeat of its adjoint, DCT, LMO, ghost, Radon with its 1.07 GiB phase
tensor, and the structural transforms and projection), each against the
CPU at a small shape; K1 runs only in the two LSQR solves — and the
eleventh, ``remat_blocks`` under the ``"vmap"`` shot stacks: 4 shots of
``multishot_wave_operator`` at 256³, nt=120, remat 12 against 1 (traces,
autograd gradients and derived adjoints bitwise, the peak device memory,
no wave kernel launched), against the same shots in map mode at remat 12
(K4), and the VTI and TTI vmap stacks at (32, 64, 128) — and the twelfth,
the ``utils`` layer: on the 3-D flagship, an LSQR checkpoint saved from the
card, loaded back and resumed bitwise an uninterrupted run with its
``tree_hash`` checked, ``checked(A)`` and its NaN guard, a ``trace`` of 5
hooked iterations holding exactly 5 K1 kernel events, the native CRC32C,
codec and loader libraries; snapshots of the 256³ K4 forward in a disk
``SnapshotStore`` at 12 bits (the native bytes equal the numpy codec's),
and the flagship's data streamed to the card by ``ShotGatherLoader`` —
and the thirteenth, distribution (``jets_tpu_torch.parallel``): at world
size 1 on NCCL in this process, the 3-D flagship's LSQR, configs 4 and 5,
the 16-shot isotropic int8 multishot gradient and the VTI and TTI
multishots with ``mesh=``, and the z-slab propagator in one slab, each
bitwise its ``mesh=None`` run; then 2 ranks on the one card over gloo
(this script run as ``--rank r 2 dir`` in two subprocesses under a hard
time limit): the flagship's LSQR with 8 shots a rank, the z-slab forward
and int8 gradient in 2 slabs of 128 planes, bitwise the unsharded K4 run,
and the 16-shot multishot gradient. Each path runs with the kernels'
launch counts set to 0 just before it and read just after. Every phase asserts; a failure
raises and exits non-zero. Every entry point runs on the card by default;
the CPU runs ask for ``device="cpu"``.
The last lines are a JSON object of the kernels (route, source, launches
on the main path, error against the plain version, times, the bound from
the bytes each call moves and its operations, and the time of the one
PyTorch call that computes the same function where there is one), the
card's name and power limit from ``nvidia-smi``, the script's total time,
and the result line ``{"ok": true, "device": {...}}``.

Needs one CUDA card, ``nvcc`` (``CUDA_HOME``, ``PATH`` or
``/usr/local/cuda``) and a few minutes. Times are CUDA-event times on the
card it runs on; compare two versions only within one run.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch


def log(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def rel(a, b):
    """The relative 2-norm difference on ``b``'s device, in float64
    (complex128 for complex tensors)."""
    wide = torch.complex128 if b.is_complex() else torch.float64
    a, b = a.to(device=b.device, dtype=wide), b.to(wide)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _blocks(t):
    from jets_tpu_torch import BlockVector
    return t.blocks if isinstance(t, BlockVector) else (t,)


def live(t, name):
    """Every block of ``t`` finite and not identically zero, or fail."""
    for i, x in enumerate(_blocks(t)):
        assert bool(torch.isfinite(x).all()), f"{name}[{i}] is not finite"
        assert float(x.abs().max()) > 0.0, f"{name}[{i}] is identically zero"


def same(a, b, name):
    """Bitwise equality of every block (a tensor or a BlockVector), or fail."""
    pa, pb = _blocks(a), _blocks(b)
    for i, (x, y) in enumerate(zip(pa, pb)):
        live(y, f"{name}[{i}]")
        assert torch.equal(x, y), f"{name}[{i}] not bitwise: rel {rel(x, y)}"
    return f"{name} bitwise ({len(pa)} block{'s' * (len(pa) > 1)})"


def agree(a, b, name, tol):
    """Every block of ``a`` within ``tol`` of ``b``'s (the relative 2-norm,
    on ``b``'s device), or fail."""
    msgs = []
    for i, (x, y) in enumerate(zip(_blocks(a), _blocks(b))):
        live(y, f"{name}[{i}]")
        x = x.to(y.device)
        r = rel(x, y)
        assert r <= tol, f"{name}[{i}]: rel {r} > {tol}"
        msgs.append(f"{r:.3e} (bitwise: {bool(torch.equal(x, y))})")
    return f"{name} rel {', '.join(msgs)} (<= {tol:g})"


def _cosine(x, y):
    return float(torch.vdot(x.double().reshape(-1), y.double().reshape(-1))
                 / (torch.linalg.vector_norm(x.double()) * torch.linalg.vector_norm(y.double())))


def cuda_ms(fn, reps):
    """Mean CUDA-event time of ``fn()`` over ``reps`` back-to-back calls, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_of(mangled):
    """``(name, order)`` of a mangled kernel symbol: its last
    length-prefixed name (after any namespaces) and its first template
    argument when that is an int (the stencil order), else 0."""
    i = len("_ZN") if mangled.startswith("_ZN") else len("_Z")
    names = []
    while (d := re.match(r"\d+", mangled[i:])):
        i += d.end()
        names.append(mangled[i:i + int(d.group())])
        i += int(d.group())
    order = re.match(r"ILi(\d+)E", mangled[i:])
    return (names[-1] if names else mangled), int(order.group(1)) if order else 0


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# Per grid point operation counts of each kernel's function at order 2 (each
# derived field counted once, as the least work the function needs); with
# the bytes each call moves they give the bound below.
FLOPS_PER_POINT = {
    "xw_update": 5, "lap3d_axpy_norm2": 11, "laplacian3d": 7,
    "cg_update": 6, "p_update": 2, "lsmr_update": 7, "fused_q_step": 21,
    "fused_leapfrog_step": 16, "fused_adjoint_step": 25,
    "fused_vti_step": 36, "fused_vti_hist_step": 40, "fused_vti_adjoint_step": 85,
    "fused_tti_step": 110, "fused_tti_hist_step": 114, "fused_tti_adjoint_step": 300,
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def bound_ms(nbytes_moved, npoints, name):
    """The least time for a call: the larger of its bytes over the memory
    rate and its operations over the float32 peak, and which bounds it."""
    t_b = nbytes_moved / HBM_BYTES_PER_S
    t_f = FLOPS_PER_POINT[name] * npoints / F32_FLOPS_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def ms_per_iter(solve, op, rhs, lo, hi, reps=3):
    """Marginal ms per iteration of ``solve`` between budgets lo and hi
    (median of reps, CUDA events)."""
    def run(n):
        s0 = torch.cuda.Event(enable_timing=True)
        s1 = torch.cuda.Event(enable_timing=True)
        s0.record()
        res = solve(op, rhs, maxiter=n, tol=0.0)
        s1.record()
        torch.cuda.synchronize()
        assert res.iterations == n
        return s0.elapsed_time(s1)

    run(lo)  # warm-up
    t_lo = sorted(run(lo) for _ in range(reps))[reps // 2]
    t_hi = sorted(run(hi) for _ in range(reps))[reps // 2]
    return (t_hi - t_lo) / (hi - lo)


def event_ms(fn):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def busy_share(fn):
    """Under ``torch.profiler``: the share of ``fn``'s CUDA-event time in
    which some kernel ran (None with no device events), that time in ms,
    the number of device events, and the six kernels with the most device
    time (µs total, count)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = event_ms(fn)
    ivs = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a0, a1_ in ivs:  # union of the kernel intervals, in µs
        if end is None or a0 > end:
            busy += a1_ - a0
            end = a1_
        elif a1_ > end:
            busy += a1_ - end
            end = a1_
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = by_name.setdefault(e.name[:48], [0.0, 0])
            t[0] += e.time_range.end - e.time_range.start
            t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return (busy / (1e3 * wall) if ivs else None), wall, len(ivs), top


def check_history(res, maxiter, dnorm, phase):
    h = res.history
    assert res.iterations == maxiter, f"ran {res.iterations} of {maxiter} iterations"
    assert bool(torch.isfinite(h).all()), "history is not finite"
    # |phibar_k| = |s_k|·|phibar_{k-1}| with |s_k| <= 1 (the rotations use
    # hypot): exactly non-increasing, also after convergence
    assert bool((h[1:] <= h[:-1]).all()), "history increased"
    assert float(res.resnorm) < dnorm, f"resnorm {float(res.resnorm)} >= ||d|| {dnorm}"
    log(phase, f"history {float(h[0]):.6g} -> {float(h[-1]):.6g}, "
               f"resnorm {float(res.resnorm):.9g} < ||d|| {dnorm:.9g}")


# The BASELINE configurations at their full sizes (``BASELINE.json``): phase,
# builder, solver budget, the relative-residual threshold of
# The shapes (and view offsets) at which phase 1 holds the solver-update
# kernels K1, K6a, K6b and K7 against their plain versions: the 3-D and 2-D
# flagships, configs 5 and 4, config 1 at float32, then an odd length (vector
# path + scalar tail) and its offset view (the unaligned scalar path), then
# the LSQR models of the tenth path (phases 57 and 59).
# The grid slabs of phases 67-68 (the 3-D flagship and configs 5 and 4 on a
# (2, 2) block x grid mesh, each rank its half of the leading dimension) for
# K1, and the halo-extended slabs K3 runs on there (one plane each side; the
# (1, 1) mesh's slab is the whole grid).
GRID_SLABS = ((128, 256, 256), (64, 128, 64), (64, 128))
K3_SLABS = ((258, 256, 256), (130, 256, 256), (130, 128, 64), (66, 128, 64))
SOLVER_SHAPES = [((256, 256, 256), 0), ((2048, 2048), 0), ((128, 128, 64), 0),
                 ((128, 128), 0), ((1000,), 0), ((1000003,), 0), ((1000003,), 1),
                 ((16, 4096, 2048), 0), ((1024, 2000), 0)] + [(s, 0) for s in GRID_SLABS]
SOLVER_SHAPES_TEXT = ("256^3, 2048^2, 128x128x64, 128^2, 1000 and 1000003 "
                      "aligned/unaligned, the tenth path's 16x4096x2048 and 1024x2000, and "
                      "the grid slabs of phases 67-68")

# The shapes at which phase 1 holds the wave kernels against their plain
# versions, one list per kernel family: the 256^3 flagship first, then every
# other shape that the FWI phases give the kernels (phase 45's Ginsu windows
# and those of its card-vs-CPU check, phase 46's windows, phase 49's remat
# grid), the halo-extended z-slabs of phases 65-66 (the 256^3 grid in one
# and in two slabs, an order-2 halo plane on each side; K4 there also with no
# source, -1, as on the ranks that do not hold it) and, for K11-K13, two
# ragged shapes. The FWI and distribution phases assert that the shapes they
# run are listed here.
SLAB_SHAPES = ((258, 256, 256), (130, 256, 256))
ISO_SHAPES = ((256, 256, 256), (256, 128, 128), (32, 32, 32), (48, 32, 32),
              (32, 64, 128)) + SLAB_SHAPES  # K4, K5
VTI_SHAPES = ((256, 256, 256), (32, 64, 128))  # K8, K9, K10
TTI_SHAPES = ((256, 256, 256), (37, 45, 70), (5, 19, 33), (32, 64, 128))  # K11-K13
Q_SHAPES = ((256, 256, 256), (32, 64, 128))  # K14


def shapes_text(shapes):
    return ", ".join("x".join(map(str, s)) for s in shapes)


# tests/test_configs.py (float32 config 1: 1e-4, its roundoff floor), dtype
# (None: the builder's default), the budgets of the marginal ms/iter (config 1
# stops short of 40: in float32 CG's recursive residual underflows to 0 soon
# after, which ends the loop), and the solver-kernel launches the solve must
# make after ``it`` iterations.
CONFIGS = (
    (38, "config1_spd_cg", 400, 1e-8, None, (10, 30), lambda it: {}),
    (39, "config1_spd_cg", 400, 1e-4, torch.float32, (10, 30),
     lambda it: {"cg_update": it, "p_update": it}),
    (40, "config2_deconv_lsqr", 150, 0.05, None, (10, 60), lambda it: {}),
    (41, "config3_deblur_cgls", 60, 0.05, None, (10, 60), lambda it: {}),
    (42, "config4_distributed_lsqr", 40, 0.2, None, (10, 40),
     lambda it: {"xw_update": it}),
    (43, "config5_seismic3d_pod", 30, 0.3, None, (10, 30),
     lambda it: {"xw_update": it, "laplacian3d": it + 1}),
)


# the configurations phase 65 runs with mesh=: phase, solver budget, threshold
MESH_CONFIGS = {name: (phase, maxiter, threshold)
                for phase, name, maxiter, threshold, *_ in CONFIGS
                if name in ("config4_distributed_lsqr", "config5_seismic3d_pod")}
BASELINE_X = {}  # the solutions of phases 42-43


def baseline_configs(smi):
    """Phases 38-44: each BASELINE configuration built by its builder's
    defaults and solved through ``run_config`` on the card, launch counts set
    to 0 just before the solve and read just after; its dot-product gate
    (float64 rtol 1e-8, float32 1e-4), its residual threshold, the card
    against the CPU at 10 iterations (x rel 1e-8 in float64, 1e-4 in
    float32), its marginal ms per iteration and a profile of 10 iterations
    (device busy share, the kernels with the most device time). Then
    MINRES, BiCGStab, GMRES(20) and Chebyshev with estimated bounds on
    config 1's operator, the card against the CPU. Returns the solver
    kernels' launches of the counted solves."""
    from jets_tpu_torch import dot_product_test
    from jets_tpu_torch.models import configs
    from jets_tpu_torch.ops import cuda_solver as cs
    from jets_tpu_torch.solvers import (bicgstab, chebyshev, estimate_spectral_bounds,
                                        gmres, minres)

    launched = {}
    for phase, name, maxiter, threshold, dtype, (lo, hi), expect in CONFIGS:
        builder = getattr(configs, name)
        kw = {} if dtype is None else {"dtype": dtype}
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        res, relres, A = configs.run_config(builder, maxiter=maxiter, tol=1e-10, **kw)
        wall = time.perf_counter() - t0
        counts = {k: n for k, n in cs.launch_counts().items() if n}
        it = res.iterations
        assert counts == expect(it), f"{name}: launches {counts} after {it} iterations"
        for k, n in counts.items():
            launched[k] = launched.get(k, 0) + n
        assert A.dom.device.type == A.rng.device.type == res.x.device.type == "cuda", \
            f"{name} was not built on the card"
        assert bool(torch.isfinite(res.history[:it]).all()), f"{name}: history not finite"
        assert relres < threshold, f"{name}: relative residual {relres} >= {threshold}"
        single = A.dom.dtype == torch.float32
        g = torch.Generator().manual_seed(0)
        lhs, rhs = dot_product_test(A, A.dom.randn(g), A.rng.randn(g))
        gate = abs(float(lhs) - float(rhs)) / abs(float(rhs))
        gate_tol = 1e-4 if single else 1e-8
        assert gate <= gate_tol, f"{name}: dot-product gate rel {gate}"
        if name in MESH_CONFIGS:
            BASELINE_X[name] = res.x  # phase 65 holds the mesh runs to these bits
        del res, A
        Ac, solve, dc, _ = builder(device="cpu", **kw)
        Ag, _, dg, _ = builder(**kw)
        c0 = cs.launch_counts()
        t1 = time.perf_counter()
        rc = solve(Ac, dc, maxiter=10, tol=0.0)
        t_cpu = time.perf_counter() - t1
        assert cs.launch_counts() == c0, "a CPU run launched a kernel"
        rg = solve(Ag, dg, maxiter=10, tol=0.0)
        dx = rel(rg.x.cpu(), rc.x)
        cpu_tol = 1e-4 if single else 1e-8
        assert dx <= cpu_tol, f"{name}: card vs CPU x rel {dx}"
        ms = ms_per_iter(solve, Ag, dg, lo, hi)
        sh, wall10, nev, top = busy_share(lambda: solve(Ag, dg, maxiter=10, tol=0.0))
        log(phase, f"{name} ({Ag.dom.shape} {Ag.dom.dtype} -> {Ag.rng.shape}): "
                   f"run_config {it} iterations in {wall:.2f} s incl. build, relative "
                   f"residual {relres:.6e} (< {threshold:g}); launches {counts}; "
                   f"dot-product gate rel {gate:.3e} (<= {gate_tol:g}); card vs CPU at "
                   f"10 iterations (CPU {t_cpu:.2f} s) ||dx||/||x|| {dx:.3e} (<= "
                   f"{cpu_tol:g}); {ms:.4f} ms/iter (marginal {lo}->{hi}, CUDA events); "
                   "under the profiler, 10 iterations from the start: "
                   + ("device busy not measured" if sh is None else
                      f"device busy {sh:.3f} of {wall10:.2f} ms")
                   + f" ({nev} device events; top kernels, us total/count: "
                   + "; ".join(f"{nm} {t:.0f}/{c}" for nm, (t, c) in top) + f") [{smi}]")
        del Ac, dc, Ag, dg, rc, rg

    A, _, d, _ = configs.config1_spd_cg()
    Ac, _, dc, _ = configs.config1_spd_cg(device="cpu")
    bounds = [estimate_spectral_bounds(op, torch.Generator().manual_seed(0))
              for op in (A, Ac)]
    runs = {
        "minres": lambda op, b, lo, hi: minres(op, b, maxiter=60, tol=1e-10),
        "bicgstab": lambda op, b, lo, hi: bicgstab(op, b, maxiter=60, tol=1e-10),
        "gmres(20)": lambda op, b, lo, hi: gmres(op, b, maxiter=60, restart=20, tol=1e-10),
        "chebyshev": lambda op, b, lo, hi: chebyshev(op, b, lo, hi, maxiter=200, tol=1e-10),
    }
    c0 = cs.launch_counts()
    msgs = []
    for nm, run in runs.items():
        t0 = time.perf_counter()
        rg = run(A, d, *bounds[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rc = run(Ac, dc, *bounds[1])
        relres = float(torch.linalg.vector_norm(A(rg.x) - d) / torch.linalg.vector_norm(d))
        assert relres < 1e-8, f"{nm}: relative residual {relres}"
        dx = rel(rg.x.cpu(), rc.x)
        assert dx <= 1e-8, f"{nm}: card vs CPU x rel {dx}"
        msgs.append(f"{nm} {rg.iterations} iterations ({rc.iterations} on the CPU) in "
                    f"{1e3 * wall:.1f} ms, relative residual {relres:.3e}, card vs CPU "
                    f"||dx||/||x|| {dx:.3e}")
    assert cs.launch_counts() == c0, "a plain solver launched a solver kernel"
    log(44, f"config 1 ({A.dom.shape} {A.dom.dtype}) on the card against the CPU: "
            "spectral bounds "
            f"({float(bounds[0][0]):.6g}, {float(bounds[0][1]):.6g}) (CPU "
            f"{float(bounds[1][0]):.6g}, {float(bounds[1][1]):.6g}); " + "; ".join(msgs)
            + f" (< 1e-8, <= 1e-8); no solver kernel launched [{smi}]")
    return launched


def _counts():
    """The launch counts of every wave kernel (K4, K5, K14; K8-K10; K11-K13)."""
    from jets_tpu_torch.ops import cuda_tti as ct
    from jets_tpu_torch.ops import cuda_vti as cv
    from jets_tpu_torch.ops import cuda_wave as cw
    return {**cw.launch_counts(), **cv.launch_counts(), **ct.launch_counts()}


def _reset_counts():
    from jets_tpu_torch.ops import cuda_tti as ct
    from jets_tpu_torch.ops import cuda_vti as cv
    from jets_tpu_torch.ops import cuda_wave as cw
    for mod in (cw, cv, ct):
        mod.reset_launch_counts()


def _launched(before):
    """The launches of each wave kernel since ``before``, zeros left out."""
    return {k: n - before[k] for k, n in _counts().items() if n != before[k]}


def _counted(fg):
    """``fg`` with a count of its calls (the objective evaluations)."""
    calls = [0]

    def wrapped(m):
        calls[0] += 1
        return fg(m)

    return wrapped, calls


def fwi_inversion(smi, c_true, wkw):
    """Phases 45-51, the FWI inversion path at the wave stages' geometry
    (256^3 f32, order 2, dt 5e-4, dx 10, 15 Hz, sponge 12): bounded L-BFGS
    on 16 Ginsu-windowed shots with int8 histories (K4, K5), the windowed
    gradient against explicit slices and the windowed Born gate, NLCG on
    the VTI gradient with velocity-only bounds (K8-K10), Gauss-Newton with
    CGLS on 4 shots (K4, K5), ``remat_blocks`` against one segment (iso at
    256^3; VTI, TTI and Q at (32, 64, 128)), and CPML. Each solve runs with
    the launch counts set to 0 just before it and read just after, and holds
    them exactly against the objective evaluations it made. Returns the
    kernels' launches of the counted runs."""
    from jets_tpu_torch import BlockVector, dot_product_test
    from jets_tpu_torch.ops.wave import (born_operator, cpml_wave_propagator,
                                         multishot_tti_wave_operator,
                                         multishot_vti_wave_operator,
                                         multishot_wave_operator, q_wave_propagator,
                                         tti_wave_propagator, vti_wave_propagator,
                                         wave_propagator)
    from jets_tpu_torch.solvers import gauss_newton, lbfgs, least_squares_objective, nlcg

    dev = c_true.device
    wshape = tuple(c_true.shape)
    launched = {}

    def add(counts):
        for k, n in counts.items():
            launched[k] = launched.get(k, 0) + n

    def finite(t, name):
        leaves = t.blocks if isinstance(t, BlockVector) else (t,)
        assert all(bool(torch.isfinite(x).all()) for x in leaves), f"{name} not finite"

    # ---- phase 45: bounded L-BFGS on 16 windowed shots -------------------------
    # windows of (256, 128, 128) at y, x corners on a 4 x 4 lattice of step 42/43:
    # neighbouring windows overlap by 85 of their 128 points
    lattice = (0, 43, 85, 128)
    corners = np.array([(0, y, x) for y in lattice for x in lattice])
    win = (256, 128, 128)
    nsh, nt = len(corners), 120
    assert wshape in ISO_SHAPES and win in ISO_SHAPES, "phase 1 did not check K4/K5 here"
    wsrc = int(np.ravel_multi_index((128, 64, 64), win))  # each window's centre
    wrcv = [int(np.ravel_multi_index((128, 64, x), win)) for x in range(128)]
    lkw = dict(dt=wkw["dt"], dx=wkw["dx"], freq=wkw["freq"], sponge_width=12,
               store_adjoint="int8", shot_map="map")
    F = multishot_wave_operator(wshape, [wsrc] * nsh, nt=nt, rcv_idx=wrcv,
                                window_shape=win, window_corners=corners, **lkw)
    d_obs = F(c_true)
    finite(d_obs, "observed data")
    objective = least_squares_objective(F, d_obs)
    fg, calls = _counted(objective)
    c0 = torch.full(wshape, 1500.0, device=dev)
    phi0 = float(fg(c0)[0])
    calls[0] = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    b = _counts()
    t0 = time.perf_counter()
    res = lbfgs(fg, c0, maxiter=3, mem=5, bounds=(1400.0, 1700.0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _launched(b)
    peak = torch.cuda.max_memory_allocated()
    peak_gib, above_gib = peak / 2**30, (peak - base) / 2**30
    per = {"fused_leapfrog_step": 2 * nsh * nt, "fused_adjoint_step": nsh * nt}
    assert got == {k: calls[0] * n for k, n in per.items()}, (got, calls[0])
    add(got)
    finite(res.history, "L-BFGS history")
    assert res.iterations == 3, res.iterations
    assert float(res.phi) < phi0, f"phi {float(res.phi)} not below fg(c0) {phi0}"
    assert float(res.m.min()) >= 1400.0 and float(res.m.max()) <= 1700.0, "left the box"
    b = _counts()
    sh, wall1, nev, top = busy_share(lambda: objective(res.m))
    add(_launched(b))
    # the same windowed objective, scaled down, on the card and on the CPU
    sgrid, swin = (32, 64, 64), (32, 32, 32)
    assert swin in ISO_SHAPES, "phase 1 did not check K4/K5 at the small windows"
    scorners = corners // 4
    ssrc = int(np.ravel_multi_index((16, 16, 16), swin))
    srcv = [int(np.ravel_multi_index((16, 16, x), swin)) for x in range(32)]
    c_s = c_true[::8, ::4, ::4].contiguous()

    def small(device):
        Fs = multishot_wave_operator(sgrid, [ssrc] * nsh, nt=60, rcv_idx=srcv,
                                     window_shape=swin, window_corners=scorners,
                                     device=device, **lkw)
        return least_squares_objective(Fs, Fs(c_s.to(device)))

    phis, gs = small(dev)(torch.full(sgrid, 1480.0, device=dev))
    phic, gc = small("cpu")(torch.full(sgrid, 1480.0))
    rphi = abs(float(phis) - float(phic)) / abs(float(phic))
    rg = rel(gs.cpu(), gc)
    assert rphi <= 1e-5 and rg <= 1e-5, (rphi, rg)
    log(45, f"bounded L-BFGS, {nsh} shots in Ginsu windows {win} of 256^3 (corners y, x "
            f"in {lattice}), nt={nt}, map, int8: 3 iterations, {calls[0]} objective "
            f"evaluations; launches {got} = evaluations x (K4 {2 * nsh * nt}, K5 "
            f"{nsh * nt}); phi {phi0:.6e} -> {float(res.phi):.6e}, history "
            + ", ".join(f"{float(h):.6e}" for h in res.history)
            + f"; model in [{float(res.m.min()):.3f}, {float(res.m.max()):.3f}] within "
            f"(1400, 1700); {1e3 * wall / calls[0]:.1f} ms per objective evaluation, "
            f"{1e3 * wall / res.iterations:.1f} ms per L-BFGS iteration (the start's "
            f"evaluation included), peak device memory {peak_gib:.2f} GiB ({above_gib:.2f} "
            "above the phase's start); one evaluation under the profiler: "
            + ("device busy not measured" if sh is None else
               f"device busy {sh:.3f} of {wall1:.1f} ms")
            + f" ({nev} device events; top kernels, us total/count: "
            + "; ".join(f"{nm} {t:.0f}/{c}" for nm, (t, c) in top)
            + f"); card vs CPU on {sgrid} windows {swin}: phi rel {rphi:.3e}, gradient "
            f"rel {rg:.3e} (<= 1e-5) [{smi}]")
    del F, d_obs, res, fg

    # ---- phase 46: windowed gradient against explicit slices; Born gate --------
    ggrid, gwin = (48, 64, 64), (48, 32, 32)
    assert gwin in ISO_SHAPES, "phase 1 did not check K4/K5 at phase 46's windows"
    gcorners = np.array([(0, 0, 0), (0, 16, 24), (0, 32, 8)])  # overlapping
    gsrc = int(np.ravel_multi_index((24, 16, 16), gwin))
    grcv = [int(np.ravel_multi_index((24, 16, x), gwin)) for x in range(32)]
    c_g = c_true[::5, ::4, ::4][:48].contiguous()
    gkw = dict(dt=wkw["dt"], dx=wkw["dx"], freq=wkw["freq"], sponge_width=6, nt=80)
    Fw = multishot_wave_operator(ggrid, [gsrc] * 3, rcv_idx=grcv, window_shape=gwin,
                                 window_corners=gcorners, store_adjoint="int8",
                                 shot_map="map", **gkw)
    dd = torch.randn(Fw.rng.shape, generator=torch.Generator().manual_seed(5)).to(dev)
    b = _counts()
    gw = Fw.linearize(c_g).H(dd)
    add(_launched(b))
    want = torch.zeros(ggrid, device=dev)
    single = wave_propagator(gwin, src_idx=gsrc, rcv_idx=grcv, store_adjoint="int8", **gkw)
    for k, (z, y, x) in enumerate(gcorners):
        sl = (slice(z, z + 48), slice(y, y + 32), slice(x, x + 32))
        want[sl] += single.linearize(c_g[sl].contiguous()).H(dd[k])
    finite(gw, "windowed gradient")
    assert torch.equal(gw, want), f"windowed gradient vs slices rel {rel(gw, want)}"
    Fb = multishot_wave_operator(ggrid, [gsrc] * 3, rcv_idx=grcv, window_shape=gwin,
                                 window_corners=gcorners, store_adjoint="f32",
                                 shot_map="map", **gkw)
    J = born_operator(Fb, c_g)
    gb = torch.Generator().manual_seed(6)
    lhs, rhs = dot_product_test(J, J.dom.randn(gb), J.rng.randn(gb))
    gate = abs(float(lhs) - float(rhs)) / abs(float(rhs))
    assert gate <= 1e-4, f"windowed Born gate rel {gate}"
    log(46, f"{ggrid} in 3 overlapping windows {gwin}, nt=80, int8: the stacked adjoint "
            "equals the single-shot gradients on the explicit slices scattered back, "
            f"bitwise; windowed Born operator (f32 history) dot-product gate rel "
            f"{gate:.3e} (<= 1e-4) [{smi}]")
    del Fw, Fb, J, gw, want

    # ---- phase 47: NLCG on the VTI gradient, velocity-only bounds --------------
    vnt = 160
    assert wshape in VTI_SHAPES, "phase 1 did not check K8-K10 at this grid"
    src0 = int(np.ravel_multi_index((128, 128, 128), wshape))
    Fv = vti_wave_propagator(wshape, nt=vnt, src_idx=src0, store_adjoint="int8", **wkw)

    def vti(c, eps, delta):
        return BlockVector((c, torch.full(wshape, eps, device=dev),
                            torch.full(wshape, delta, device=dev)), Fv.dom)

    dv_obs = Fv(vti(c_true, 0.12, 0.06))
    fgv, vcalls = _counted(least_squares_objective(Fv, dv_obs))
    # the true velocity (1422.7 to 1506.9 m/s) in a box of [1450, 1500], which
    # the solve must clamp it into at both ends; eps and delta are free
    c_lo, c_hi = 1450.0, 1500.0
    inf = torch.full(wshape, float("inf"), device=dev)
    lo = BlockVector((torch.full(wshape, c_lo, device=dev), -inf, -inf), Fv.dom)
    hi = BlockVector((torch.full(wshape, c_hi, device=dev), inf, inf), Fv.dom)
    mv0 = vti(c_true, 0.1, 0.05)
    phiv0 = float(fgv(vti(c_true.clamp(c_lo, c_hi), 0.1, 0.05))[0])
    vcalls[0] = 0
    _reset_counts()
    b = _counts()
    t0 = time.perf_counter()
    rv = nlcg(fgv, mv0, maxiter=2, bounds=(lo, hi))
    torch.cuda.synchronize()
    wall_v = time.perf_counter() - t0
    got = _launched(b)
    assert got == {"fused_vti_step": vcalls[0] * vnt, "fused_vti_hist_step": vcalls[0] * vnt,
                   "fused_vti_adjoint_step": vcalls[0] * vnt}, (got, vcalls[0])
    add(got)
    finite(rv.m, "VTI model")
    cv_, ev_, dv_ = rv.m.blocks
    assert rv.iterations == 2 and float(rv.phi) < phiv0, (rv.iterations, float(rv.phi))
    assert float(cv_.min()) == c_lo and float(cv_.max()) == c_hi, "c not clamped to its box"
    assert bool((ev_ != 0.1).any()) and bool((dv_ != 0.05).any()), "eps/delta did not move"
    n_lo, n_hi = int((cv_ == c_lo).sum()), int((cv_ == c_hi).sum())
    log(47, f"NLCG on the VTI int8 gradient, 256^3, nt={vnt}, model (c, eps, delta) from "
            f"(c_true, 0.1, 0.05) against data of (c_true, 0.12, 0.06), c bounded to "
            f"[{c_lo:g}, {c_hi:g}], eps and delta unbounded: 2 iterations, "
            f"{vcalls[0]} objective evaluations, launches {got} (K8 = K9 = K10 = "
            f"evaluations x {vnt}); phi at the clamped start {phiv0:.6e} -> "
            f"{float(rv.phi):.6e}; c in [{float(cv_.min()):.4f}, {float(cv_.max()):.4f}] "
            f"({n_lo} points on the lower bound, {n_hi} on the upper), eps in "
            f"[{float(ev_.min()):.6f}, {float(ev_.max()):.6f}], delta in "
            f"[{float(dv_.min()):.6f}, {float(dv_.max()):.6f}]; "
            f"{1e3 * wall_v / vcalls[0]:.1f} ms per objective evaluation [{smi}]")
    del Fv, dv_obs, rv, fgv, lo, hi, mv0, inf

    # ---- phase 48: Gauss-Newton with CGLS on 4 shots --------------------------
    gsrcs = np.ravel_multi_index((np.full(4, 128), np.full(4, 128), 40 + 58 * np.arange(4)),
                                 wshape)
    Fgn = multishot_wave_operator(wshape, gsrcs, nt=nt, store_adjoint="int8",
                                  shot_map="map", **wkw)
    dgn = Fgn(c_true)
    _reset_counts()
    b = _counts()
    t0 = time.perf_counter()
    rgn = gauss_newton(Fgn, dgn, torch.full(wshape, 1500.0, device=dev), outer_iters=2,
                       inner_iters=3)
    torch.cuda.synchronize()
    wall_gn = time.perf_counter() - t0
    got = _launched(b)
    # per outer iteration: F(m), then CGLS: A^H b, and per inner iteration A p
    # (the primal under torch.func.jvp) and A^H r; then the last residual's F(m)
    its = rgn.inner_iterations
    sweeps = 4 * nt
    want = {"fused_leapfrog_step": sweeps * (len(its) + 1 + sum(1 + 2 * i for i in its)),
            "fused_adjoint_step": sweeps * sum(1 + i for i in its)}
    assert got == want, (got, want, its)
    add(got)
    finite(rgn.m, "Gauss-Newton model")
    r = rgn.residuals
    assert len(r) == 3 and r[-1] < r[0], r
    log(48, f"Gauss-Newton, 4 shots of 256^3, nt={nt}, map, int8, outer 2 x CGLS 3: "
            f"inner iterations {its}; residual norms " + ", ".join(f"{x:.6e}" for x in r)
            + f"; launches {got}; {wall_gn:.2f} s [{smi}]")
    del Fgn, dgn, rgn

    # ---- phase 49: remat_blocks 1 vs 12 at 256^3; VTI, TTI, Q small ------------
    d_ref = wave_propagator(wshape, nt=nt, src_idx=src0, **wkw)(c_true)

    def loss_grad(Fr, m, target):
        leaves = [t.clone().requires_grad_() for t in
                  (m.blocks if isinstance(m, BlockVector) else (m,))]
        mm = BlockVector(leaves, m.space) if isinstance(m, BlockVector) else leaves[0]
        out = Fr(mm)
        r_ = out - target
        grads = torch.autograd.grad(0.5 * torch.sum(r_ * r_), leaves)
        return out.detach(), grads

    rem = {}
    for rb in (1, 12):
        Fr = wave_propagator(wshape, nt=nt, src_idx=src0, remat_blocks=rb, **wkw)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        b = _counts()
        t0 = time.perf_counter()
        out, (g,) = loss_grad(Fr, torch.full(wshape, 1500.0, device=dev), d_ref)
        torch.cuda.synchronize()
        rem[rb] = (out, g, (torch.cuda.max_memory_allocated() - base) / 2**30,
                   time.perf_counter() - t0, _launched(b))
        add(rem[rb][4])
    (o1, g1, m1, t1, n1), (o12, g12, m12, t12, n12) = rem[1], rem[12]
    finite(g1, "autograd gradient")
    assert n1 == {"fused_leapfrog_step": nt} and n12 == {"fused_leapfrog_step": 2 * nt}, \
        (n1, n12)
    assert torch.equal(o1, o12), "remat traces differ"
    g_bitwise = bool(torch.equal(g1, g12))
    assert g_bitwise or rel(g12, g1) <= 1e-6, f"remat gradient rel {rel(g12, g1)}"
    assert m12 < m1, f"remat peak {m12} GiB not below {m1} GiB"
    small_msgs = []
    sshape = (32, 64, 128)
    assert all(sshape in sh for sh in (ISO_SHAPES, VTI_SHAPES, TTI_SHAPES, Q_SHAPES)), \
        "phase 1 did not check K4, K8, K11 and K14 at the remat grid"
    ssrc = int(np.ravel_multi_index((16, 32, 64), sshape))
    srcv2 = [int(np.ravel_multi_index((16, 32, x), sshape)) for x in range(128)]
    skw = dict(nt=24, dt=wkw["dt"], dx=wkw["dx"], freq=wkw["freq"], src_idx=ssrc,
               rcv_idx=srcv2, sponge_width=6)
    cs_ = c_true[::8, ::4, ::2].contiguous()

    def full(v):
        return torch.full(sshape, v, device=dev)

    shots = [ssrc, ssrc + 16]  # map-mode stacks of two shots
    mkw2 = {k: v for k, v in skw.items() if k != "src_idx"}

    def vti_m(dom):
        return BlockVector((cs_, full(0.1), full(0.05)), dom)

    def tti_m(dom):
        return BlockVector((cs_, full(0.1), full(0.05), full(0.2), full(0.7)), dom)

    # every propagator that takes remat_blocks: (constructor, model, shots)
    cases = {
        "VTI": (lambda **r: vti_wave_propagator(sshape, **skw, **r), vti_m, 1),
        "TTI": (lambda **r: tti_wave_propagator(sshape, **skw, **r), tti_m, 1),
        "Q": (lambda **r: q_wave_propagator(sshape, **skw, **r),
              lambda dom: BlockVector((cs_, full(40.0)), dom), 1),
        "iso multishot": (lambda **r: multishot_wave_operator(
            sshape, shots, shot_map="map", **mkw2, **r), lambda dom: cs_, 2),
        "VTI multishot": (lambda **r: multishot_vti_wave_operator(
            sshape, shots, shot_map="map", **mkw2, **r), vti_m, 2),
        "TTI multishot": (lambda **r: multishot_tti_wave_operator(
            sshape, shots, shot_map="map", **mkw2, **r), tti_m, 2),
    }
    for name, (ctor, model, nshots) in cases.items():
        outs = []
        for rb in (1, 4):
            Fs = ctor(remat_blocks=rb)
            ms_ = model(Fs.dom)
            b = _counts()
            outs.append(loss_grad(Fs, ms_, torch.zeros(Fs.rng.shape, device=dev)))
            n = _launched(b)
            want_n = (1 if rb == 1 else 2) * 24 * nshots
            assert n and all(v == want_n for v in n.values()), (name, n)
            add(n)
        (oa, ga), (ob, gb_) = outs
        assert torch.equal(oa, ob), f"{name} remat traces differ"
        for i, (x, y) in enumerate(zip(ga, gb_)):
            finite(x, f"{name} gradient {i}")
            assert torch.equal(x, y), f"{name} remat gradient {i} rel {rel(y, x)}"
        small_msgs.append(f"{name} {list(n)} bitwise ({len(ga)} blocks)")
    log(49, f"remat_blocks 1 vs 12, wave_propagator 256^3, nt={nt}, gradient of "
            "0.5||F(c) - d||^2 by torch.autograd: traces bitwise, gradient "
            + ("bitwise" if g_bitwise else f"rel {rel(g12, g1):.3e} (<= 1e-6)")
            + f"; K4 {nt} vs {2 * nt} launches (the segments recompute through K4); peak "
            f"device memory above the start {m1:.2f} vs {m12:.2f} GiB; {t1:.2f} vs "
            f"{t12:.2f} s; at {sshape}, nt=24, remat 1 vs 4 on the kernel route (the "
            "multishot stacks: 2 shots in map mode): "
            + ", ".join(small_msgs) + f" [{smi}]")
    del rem, o1, g1, o12, g12, d_ref

    # ---- phase 50: CPML at 256^3 -----------------------------------------------
    ckw = dict(dt=wkw["dt"], dx=wkw["dx"], freq=wkw["freq"], rcv_idx=wkw["rcv_idx"],
               pml_width=12, cmax=2000.0)
    Fc = cpml_wave_propagator(wshape, nt=220, src_idx=src0, **ckw)
    t0 = time.perf_counter()
    dc = Fc(c_true)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    finite(dc, "CPML traces")
    assert float(dc.abs().max()) > 0, "CPML traces are zero"
    b = _counts()
    Fcg = cpml_wave_propagator(wshape, nt=60, src_idx=src0, remat_blocks=6, **ckw)
    J = born_operator(Fcg, c_true)
    gb = torch.Generator().manual_seed(7)
    lhs, rhs = dot_product_test(J, J.dom.randn(gb), J.rng.randn(gb))
    gate32 = abs(float(lhs) - float(rhs)) / abs(float(rhs))
    assert gate32 <= 1e-4, f"CPML f32 Born gate rel {gate32}"
    J64 = born_operator(cpml_wave_propagator((20, 20), nt=40, dt=8e-4, dx=10.0, freq=18.0,
                                             src_idx=210, pml_width=4, cmax=2500.0,
                                             dtype=torch.float64),
                        torch.full((20, 20), 2000.0, dtype=torch.float64, device=dev))
    lhs, rhs = dot_product_test(J64, J64.dom.randn(gb), J64.rng.randn(gb))
    gate64 = abs(float(lhs) - float(rhs)) / abs(float(rhs))
    assert gate64 <= 1e-9, f"CPML f64 Born gate rel {gate64}"
    # reflection: a centred pulse in 64^3 run until it has crossed the boundary
    # and come back, all points recorded, with CPML and with the sponge
    rshape, rw = (64, 64, 64), 10
    rkw = dict(nt=300, dt=1e-3, dx=10.0, freq=15.0,
               src_idx=int(np.ravel_multi_index((32, 32, 32), rshape)),
               rcv_idx=np.arange(64 ** 3))
    c_r = torch.full(rshape, 2000.0, device=dev)
    ratios = {}
    for kind, Fr in (("cpml", cpml_wave_propagator(rshape, pml_width=rw, cmax=2000.0,
                                                   **rkw)),
                     ("sponge", wave_propagator(rshape, sponge_width=rw, fused=False,
                                                **rkw))):
        tr_ = Fr(c_r)
        inner = tr_[-1].reshape(rshape)[rw + 4:-(rw + 4), rw + 4:-(rw + 4), rw + 4:-(rw + 4)]
        ratios[kind] = float(inner.abs().max() / tr_.abs().max())
        del tr_
    assert ratios["cpml"] < 0.05 * ratios["sponge"], ratios
    Fmc = multishot_wave_operator(wshape, [src0, src0 + 40], nt=60, boundary="cpml",
                                  shot_map="map", cmax=2000.0, **wkw)
    dmc = Fmc(c_true)
    finite(dmc, "CPML multishot traces")
    d1c = cpml_wave_propagator(wshape, nt=60, src_idx=src0 + 40, **ckw)(c_true)
    assert torch.equal(dmc[1], d1c), f"CPML shot 1 vs single shot rel {rel(dmc[1], d1c)}"
    assert _launched(b) == {}, "a CPML run launched a kernel"
    log(50, f"CPML 256^3, nt=220 forward in {t_fwd:.2f} s (plain PyTorch); Born "
            f"dot-product gate f32 256^3 nt=60 (remat_blocks 6) rel {gate32:.3e} (<= 1e-4), "
            f"f64 20^2 rel {gate64:.3e} (<= 1e-9); reflection at 64^3, width {rw}: CPML "
            f"{ratios['cpml']:.3e} vs sponge {ratios['sponge']:.3e} of the peak; 2-shot "
            f"CPML multishot at 256^3, shot 1 bitwise the single-shot propagator [{smi}]")
    return launched


def other_physics(smi, c_true, q_true, wkw):
    """Phases 51-56, the wave physics no kernel computes, at the wave stages'
    geometry (256^3 f32, dt 5e-4, dx 10, 15 Hz, sponge 12, centre source, 128
    receivers): variable density and IsoDenQ (``vd_wave_propagator``,
    ``vdq_wave_propagator``), static Q on VTI and TTI (``q=``) and off-grid
    RTM (``offgrid_wave_propagator``, ``ops/sampling``). Every run of the new
    physics asserts that it launched no wave kernel; K4, K8-K13 launch only
    where a reduction check holds a new path against a kernel route (Q = inf,
    integer positions), and K1 in the LSQR of the least-squares migration.
    Each timed run prints its ms per step and its peak device memory above
    its start. Returns the kernels' launches of the counted runs."""
    from jets_tpu_torch import BlockVector, dot_product_test
    from jets_tpu_torch.ops import cuda_solver as cs
    from jets_tpu_torch.ops.sampling import (sinc_point_sampling_operator,
                                             sinc_sampling_operator)
    from jets_tpu_torch.ops.wave import (born_operator, offgrid_wave_propagator,
                                         tti_wave_propagator, vd_wave_propagator,
                                         vdq_wave_propagator, vti_wave_propagator,
                                         wave_propagator)
    from jets_tpu_torch.solvers import lsqr

    dev = c_true.device
    wshape = tuple(c_true.shape)
    n = wshape[0]  # 256; the geometry scales with it
    src0 = int(np.ravel_multi_index((n // 2,) * 3, wshape))
    skw = dict(src_idx=src0, **wkw)
    launched = {}

    def add(counts):
        for k, n in counts.items():
            launched[k] = launched.get(k, 0) + n

    def plain(fn, name):
        """``fn()``, asserting that it launched no wave kernel."""
        b = _counts()
        out = fn()
        assert _launched(b) == {}, f"{name} launched {_launched(b)}"
        return out

    def timed(fn, nt, name):
        """``fn()`` with no wave kernel launched: (out, ms per step by CUDA
        events, peak device memory above the start in GiB)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = []
        ms = plain(lambda: event_ms(lambda: out.append(fn())), name)
        return out[0], ms / nt, (torch.cuda.max_memory_allocated() - base) / 2**30

    def busy(fn, name):
        """The device busy share of ``fn()`` under the profiler, as text."""
        sh, wall, nev, top = plain(lambda: busy_share(fn), name)
        return (f"{name}: device busy {'not measured' if sh is None else f'{sh:.3f}'} of "
                f"{wall:.2f} ms ({nev} device events; top kernels, us total/count: "
                + "; ".join(f"{nm} {t:.0f}/{c}" for nm, (t, c) in top) + ")")

    def reference(fn, want):
        """``fn()`` on a kernel route, asserting exactly the launches ``want``."""
        b = _counts()
        out = fn()
        got = _launched(b)
        assert got == want, (got, want)
        add(got)
        return out

    def gate(J, seed, name):
        """The dot-product gate of ``J`` with f32 sums and with f64 sums of the
        same products (rel <= 1e-4 each)."""
        gb = torch.Generator().manual_seed(seed)
        mb, db = J.dom.randn(gb), J.rng.randn(gb)
        lhs, rhs = plain(lambda: dot_product_test(J, mb, db), name)
        g32 = abs(float(lhs) - float(rhs)) / abs(float(rhs))
        Jm, Jd = plain(lambda: (J(mb), J.H(db)), name)
        lhs64 = float(torch.vdot(db.double().reshape(-1), Jm.double().reshape(-1)))
        rhs64 = sum(float(torch.vdot(x.double().reshape(-1), y.double().reshape(-1)))
                    for x, y in zip(_blocks(Jd), _blocks(mb)))
        g64 = abs(lhs64 - rhs64) / abs(rhs64)
        assert g32 <= 1e-4 and g64 <= 1e-4, f"{name} gate rel {g32}, f64 sums {g64}"
        return f"{name} dot-product gate rel {g32:.3e}, f64 sums {g64:.3e} (<= 1e-4)"

    def cosines(ga, gb, name):
        cs_ = [_cosine(x, y) for x, y in zip(ga.blocks, gb.blocks)]
        assert all(c_ > 0.95 for c_ in cs_), (name, cs_)
        return f"{name} cosines " + ", ".join(f"{c_:.6f}" for c_ in cs_) + " (> 0.95)"

    def full(v, shape=wshape):
        return torch.full(shape, v, device=dev)

    def ones(op):
        return torch.ones(op.rng.shape, device=dev)

    # the (32, 64, 128) corner for the card-vs-CPU checks
    cshape = (n // 8, n // 4, n // 2)
    ckw = dict(dt=wkw["dt"], dx=wkw["dx"], freq=wkw["freq"], sponge_width=6,
               src_idx=int(np.ravel_multi_index(tuple(s // 2 for s in cshape), cshape)),
               rcv_idx=[int(np.ravel_multi_index((cshape[0] // 2, cshape[1] // 2, x), cshape))
                        for x in range(0, cshape[2], 2)])
    r12 = torch.from_numpy(np.random.default_rng(12).standard_normal((12, cshape[2] // 2))
                           .astype(np.float32))

    def corner(t):
        return t[:cshape[0], :cshape[1], :cshape[2]].contiguous()

    def card_vs_cpu(ctor, blocks, store, name, tol=1e-5):
        """Forward and ``store``-history gradient at (32, 64, 128), nt=12, on
        the card and on the CPU."""
        Fk = ctor(cshape, nt=12, store_adjoint=store, **ckw)
        Fc = ctor(cshape, nt=12, store_adjoint=store, device="cpu", **ckw)
        mk = BlockVector(tuple(corner(t) for t in blocks), Fk.dom)
        mc = BlockVector(tuple(t.cpu() for t in mk.blocks), Fc.dom)
        dk, gk = plain(lambda: (Fk(mk), Fk.linearize(mk).H(r12.to(dev))), name)
        dc, gc = Fc(mc), Fc.linearize(mc).H(r12)
        return (agree(dk, dc, f"{name} card vs CPU traces", tol) + "; "
                + agree(gk, gc, f"{name} card vs CPU {store} gradient", tol))

    # ---- phase 51: variable density and IsoDenQ at 256^3 --------------------------
    # buoyancy b = 1/rho, rho = 1000 kg/m^3 with one smooth seeded anomaly of +-20%
    rs = np.random.default_rng(9)
    axis = torch.arange(n, dtype=torch.float32, device=dev)
    (bz, by, bx), sign = rs.uniform(n / 4, 3 * n / 4, 3), rs.choice((-1.0, 1.0))
    gz, gy, gx = (torch.exp(-0.5 * ((axis - float(o)) / (0.11 * n)) ** 2)
                  for o in (bz, by, bx))
    rho = 1000.0 * (1.0 + 0.2 * sign * (gz[:, None, None] * gy[None, :, None]
                                        * gx[None, None, :]))
    b_true = 1.0 / rho
    b_bg = full(1e-3)
    msgs = []
    stats = {}
    for kind, ctor, extra in (("vd", vd_wave_propagator, ()),
                              ("vdq", vdq_wave_propagator, (q_true,))):
        F = ctor(wshape, nt=220, **skw)
        m = BlockVector((c_true, b_true, *extra), F.dom)
        d, ms, gib = timed(lambda: F(m), 220, f"{kind} forward")
        live(d, f"{kind} traces")
        assert d.shape == (220, len(wkw["rcv_idx"]))
        stats[f"{kind} forward nt=220"] = (ms, gib)
        Fg = ctor(wshape, nt=120, store_adjoint="int8", **skw)
        mbg = BlockVector((full(1500.0), b_bg, *extra), Fg.dom)
        res = plain(lambda: Fg(m) - Fg(mbg), f"{kind} residual")  # a physical residual
        live(res, f"{kind} residual")
        g, ms, gib = timed(lambda: Fg.linearize(m).H(res), 120, f"{kind} int8 gradient")
        live(g, f"{kind} int8 gradient")
        stats[f"{kind} int8 gradient nt=120"] = (ms, gib)
        msgs.append(f"{kind}: {F.dom.nblocks} blocks, gradient blocks all finite and live")
        del d, res, g
    F20 = vdq_wave_propagator(wshape, nt=20, store_adjoint="int8", **skw)
    msgs.append(busy(lambda: F20.linearize(m).H(ones(F20)), "vdq int8 gradient nt=20"))
    log(51, "variable density (c, b) and IsoDenQ (c, b, Q) at 256^3, (c, b, Q) = "
            "(1500 + anomalies, 1/rho with rho 1000 and a seeded smooth "
            f"{'+' if sign > 0 else '-'}20% anomaly, 50 with a low-Q anomaly to 25), no "
            "kernel launched: " + "; ".join(
                f"{k} {ms:.3f} ms/step, peak {gib:.2f} GiB" for k, (ms, gib) in stats.items())
            + "; " + "; ".join(msgs) + f" [{smi}]")

    # ---- phase 52: IsoDenQ checks ---------------------------------------------------
    inf = full(float("inf"))
    Fv = vd_wave_propagator(wshape, nt=60, store_adjoint="f32", **skw)
    Fq = vdq_wave_propagator(wshape, nt=60, store_adjoint="f32", **skw)
    mv = BlockVector((c_true, b_true), Fv.dom)
    mq_inf = BlockVector((c_true, b_true, inf), Fq.dom)
    mq = BlockVector((c_true, b_true, q_true), Fq.dom)
    dv = plain(lambda: Fv(mv), "vd forward")
    res60 = dv - plain(lambda: Fv(BlockVector((full(1500.0), b_bg), Fv.dom)), "vd forward")
    msg_inf = same(plain(lambda: Fq(mq_inf), "vdq forward"), dv, "vdq(Q = inf) vs vd traces")
    gv = plain(lambda: Fv.linearize(mv).H(res60), "vd gradient")
    gq_inf = plain(lambda: Fq.linearize(mq_inf).H(res60), "vdq gradient")
    msg_inf += "; " + same(BlockVector(gq_inf.blocks[:2], Fv.dom), gv,
                           "vdq(Q = inf) vs vd f32-history gradient (gc, gb)")
    del gq_inf
    msg_gate = gate(born_operator(Fq, mq), 8, "vdq Jacobian, nt=60, f32 history")
    g32 = plain(lambda: Fq.linearize(mq).H(res60), "vdq gradient")
    Fq8 = vdq_wave_propagator(wshape, nt=60, store_adjoint="int8", **skw)
    Fv8 = vd_wave_propagator(wshape, nt=60, store_adjoint="int8", **skw)
    msg_cos = (cosines(plain(lambda: Fq8.linearize(mq).H(res60), "vdq int8"), g32,
                       "vdq int8 vs f32 history gradient (c, b, Q)") + "; "
               + cosines(plain(lambda: Fv8.linearize(mv).H(res60), "vd int8"), gv,
                         "vd int8 vs f32 history gradient (c, b)"))
    del g32, gv, dv
    msg_cpu = "; ".join(card_vs_cpu(ctor, blocks, "f32", kind) for kind, ctor, blocks in (
        ("vd", vd_wave_propagator, (c_true, b_true)),
        ("vdq", vdq_wave_propagator, (c_true, b_true, q_true))))
    log(52, f"IsoDenQ checks at 256^3, nt=60, no kernel launched: {msg_inf}; {msg_gate}; "
            f"{msg_cos}; at {cshape}, nt=12: {msg_cpu} [{smi}]")

    # ---- phase 53: static Q on VTI --------------------------------------------------
    def vti_m(dom, c, shape=wshape):
        return BlockVector((c, full(0.1, shape), full(0.05, shape)), dom)

    qkw = dict(q=q_true, f0=15.0, **skw)
    stats = {}
    F = vti_wave_propagator(wshape, nt=220, **qkw)
    m = vti_m(F.dom, c_true)
    d, ms, gib = timed(lambda: F(m), 220, "VTI Q forward")
    live(d, "VTI Q traces")
    stats["forward nt=220"] = (ms, gib)
    d0 = reference(lambda: vti_wave_propagator(wshape, nt=220, **skw)(m),
                   {"fused_vti_step": 220})
    e_tail = [float(torch.linalg.vector_norm(x[110:])) for x in (d, d0)]
    assert e_tail[0] < e_tail[1], f"Q did not attenuate the late arrivals: {e_tail}"
    del d, d0
    Fg = vti_wave_propagator(wshape, nt=160, store_adjoint="int8", **qkw)
    res = plain(lambda: Fg(m) - Fg(vti_m(Fg.dom, full(1500.0))), "VTI Q residual")
    g, ms, gib = timed(lambda: Fg.linearize(m).H(res), 160, "VTI Q int8 gradient")
    live(g, "VTI Q int8 gradient")
    stats["int8 gradient nt=160"] = (ms, gib)
    del g, res
    F20 = vti_wave_propagator(wshape, nt=20, store_adjoint="int8", **qkw)
    msg_busy = busy(lambda: F20.linearize(m).H(ones(F20)), "VTI Q int8 gradient nt=20")
    # Q = inf multiplies by exact ones: the traces and the int8 gradient are
    # the lossless kernel route's (K8; K9 + K10) bit for bit
    F_inf = vti_wave_propagator(wshape, nt=60, store_adjoint="int8",
                                **{**qkw, "q": float("inf")})
    F_k = vti_wave_propagator(wshape, nt=60, store_adjoint="int8", **skw)
    r60 = torch.from_numpy(np.random.default_rng(53).standard_normal((60, len(wkw["rcv_idx"])))
                           .astype(np.float32)).to(dev)
    msg_inf = same(plain(lambda: F_inf(m), "VTI Q = inf"),
                   reference(lambda: F_k(m), {"fused_vti_step": 60}),
                   "VTI Q = inf vs K8 traces")
    msg_inf += "; " + same(plain(lambda: F_inf.linearize(m).H(r60), "VTI Q = inf"),
                           reference(lambda: F_k.linearize(m).H(r60),
                                     {"fused_vti_hist_step": 60,
                                      "fused_vti_adjoint_step": 60}),
                           "VTI Q = inf vs K9 + K10 int8 gradient")
    del F_inf, F_k
    try:
        vti_wave_propagator(wshape, nt=60, fused=True, **qkw)
        raise AssertionError("fused=True with q= did not raise")
    except ValueError as e:
        assert "static Q" in str(e), e
    msg_gate = gate(born_operator(vti_wave_propagator(wshape, nt=60, store_adjoint="f32",
                                                      **qkw), m),
                    9, "VTI Q Jacobian, nt=60, f32 history")
    msg_cpu = card_vs_cpu(lambda shape, **kw: vti_wave_propagator(
        shape, q=corner(q_true).cpu() if kw.get("device") == "cpu" else corner(q_true),
        f0=15.0, **kw), (c_true, full(0.1), full(0.05)), "int8", "VTI Q")
    log(53, "static Q on VTI at 256^3, (c, eps, delta) = (1500 + anomalies, 0.1, 0.05), Q "
            "= 50 with a low-Q anomaly to 25, f0 15 Hz, no kernel launched on a Q'ed run: "
            + "; ".join(f"{k} {ms:.3f} ms/step, peak {gib:.2f} GiB"
                        for k, (ms, gib) in stats.items())
            + f"; {msg_busy}; late-arrival energy {e_tail[0]:.4g} vs lossless "
            f"{e_tail[1]:.4g}; "
            f"{msg_inf}; fused=True with q= raises; {msg_gate}; at {cshape}, nt=12: "
            f"{msg_cpu} [{smi}]")

    # ---- phase 54: static Q on TTI, f32 and bf16 coefficients -----------------------
    def tti_m(dom, c, shape=wshape):
        return BlockVector((c, *(full(v, shape) for v in (0.1, 0.05, 0.2, 0.7))), dom)

    stats, msgs = {}, []
    for cdt in (None, torch.bfloat16):
        tag = "bf16" if cdt else "f32"
        F = tti_wave_propagator(wshape, nt=60, coeff_dtype=cdt, **qkw)
        m = tti_m(F.dom, c_true)
        d, ms, gib = timed(lambda: F(m), 60, f"TTI Q forward {tag}")
        live(d, "TTI Q traces")
        stats[f"forward nt=60, {tag} coefficients"] = (ms, gib)
        Fg = tti_wave_propagator(wshape, nt=60, store_adjoint="int8", coeff_dtype=cdt, **qkw)
        res = plain(lambda: Fg(m) - Fg(tti_m(Fg.dom, full(1500.0))), "TTI Q residual")
        g, ms, gib = timed(lambda: Fg.linearize(m).H(res), 60, f"TTI Q int8 gradient {tag}")
        live(g, "TTI Q int8 gradient")
        stats[f"int8 gradient nt=60, {tag} coefficients"] = (ms, gib)
        del d, res, g
        F_inf = tti_wave_propagator(wshape, nt=60, coeff_dtype=cdt,
                                    **{**qkw, "q": float("inf")})
        msgs.append(same(plain(lambda: F_inf(m), "TTI Q = inf"),
                         reference(lambda: tti_wave_propagator(
                             wshape, nt=60, coeff_dtype=cdt, **skw)(m),
                             {"fused_tti_step": 60}),
                         f"TTI Q = inf vs K11 traces, {tag} coefficients"))
        try:
            tti_wave_propagator(wshape, nt=60, fused=True, coeff_dtype=cdt, **qkw)
            raise AssertionError("fused=True with q= did not raise")
        except ValueError as e:
            assert "static Q" in str(e), e
        msgs.append(card_vs_cpu(lambda shape, **kw: tti_wave_propagator(
            shape, q=corner(q_true).cpu() if kw.get("device") == "cpu" else corner(q_true),
            f0=15.0, coeff_dtype=cdt, **kw), (c_true, *(full(v) for v in (0.1, 0.05, 0.2,
                                                                           0.7))),
            "int8", f"TTI Q {tag}"))
    m = tti_m(F.dom, c_true)
    F_inf = tti_wave_propagator(wshape, nt=30, store_adjoint="int8",
                                **{**qkw, "q": float("inf")})
    F_k = tti_wave_propagator(wshape, nt=30, store_adjoint="int8", **skw)
    msgs.append(same(plain(lambda: F_inf.linearize(m).H(r60[:30]), "TTI Q = inf"),
                     reference(lambda: F_k.linearize(m).H(r60[:30]),
                               {"fused_tti_hist_step": 30, "fused_tti_adjoint_step": 30}),
                     "TTI Q = inf vs K12 + K13 int8 gradient (nt=30)"))
    del F_inf, F_k
    msgs.append(gate(born_operator(tti_wave_propagator(wshape, nt=30, store_adjoint="f32",
                                                       **qkw), m),
                     10, "TTI Q Jacobian, nt=30, f32 history"))
    log(54, "static Q on TTI at 256^3, (c, eps, delta, theta, phi) = (1500 + anomalies, "
            "0.1, 0.05, 0.2, 0.7), Q as phase 53, no kernel launched on a Q'ed run: "
            + "; ".join(f"{k} {ms:.3f} ms/step, peak {gib:.2f} GiB"
                        for k, (ms, gib) in stats.items())
            + "; fused=True with q= raises; " + "; ".join(msgs) + f" [{smi}]")

    # ---- phase 55: off-grid RTM and least-squares migration ------------------------
    okw = dict(src_pos=(3.37, n / 2 - 0.4, n / 2 + 0.3), rcv_depth=4.5,
               rcv_coords=(np.linspace(0.056 * n, 0.944 * n, 64),
                           np.linspace(0.053 * n, 0.946 * n, 64)),
               dt=wkw["dt"], dx=wkw["dx"], freq=wkw["freq"],
               sponge_width=wkw["sponge_width"], space_order=8)
    stats = {}
    Fo = offgrid_wave_propagator(wshape, nt=160, **okw)
    c_bg = full(1500.0)
    d_obs, ms, gib = timed(lambda: Fo(c_true), 160, "off-grid forward")
    assert d_obs.shape == (160, 64, 64)
    live(d_obs, "off-grid traces")
    stats["forward nt=160"] = (ms, gib)
    d_obs = d_obs - plain(lambda: Fo(c_bg), "off-grid forward")  # the scattered data
    live(d_obs, "off-grid scattered data")
    J32 = born_operator(offgrid_wave_propagator(wshape, nt=160, store_adjoint="f32", **okw),
                        c_bg)
    msg_gate = gate(J32, 11, "off-grid Born, nt=160, f32 history")
    J8 = born_operator(offgrid_wave_propagator(wshape, nt=160, store_adjoint="int8", **okw),
                       c_bg)
    img, ms, gib = timed(lambda: J8.H(d_obs), 160, "off-grid RTM int8")
    live(img, "RTM image")
    stats["RTM image (int8 adjoint) nt=160"] = (ms, gib)
    J20 = born_operator(offgrid_wave_propagator(wshape, nt=20, store_adjoint="int8", **okw),
                        c_bg)
    msg_busy = busy(lambda: J20.H(d_obs[:20]), "off-grid int8 RTM nt=20")
    Ja = born_operator(offgrid_wave_propagator(wshape, nt=160, remat_blocks=8, **okw), c_bg)
    img_a, ms, gib = timed(lambda: Ja.H(d_obs), 160, "off-grid RTM autodiff")
    stats["autodiff adjoint (remat_blocks 8) nt=160"] = (ms, gib)
    cos_rtm = _cosine(img, img_a)
    assert cos_rtm > 0.95, f"RTM int8 vs autodiff cosine {cos_rtm}"
    cos_32 = _cosine(plain(lambda: J32.H(d_obs), "off-grid RTM f32"), img_a)
    assert cos_32 > 1.0 - 1e-4, f"RTM f32 history vs autodiff cosine {cos_32}"
    del img_a, Ja, J32
    b1 = cs.launch_counts()["xw_update"]
    t0 = time.perf_counter()
    res = plain(lambda: lsqr(J8, d_obs, maxiter=3, tol=0.0), "LSQR")
    torch.cuda.synchronize()
    t_lsqr = time.perf_counter() - t0
    n_k1 = cs.launch_counts()["xw_update"] - b1
    assert n_k1 == 3, f"LSQR made {n_k1} K1 launches"
    add({"xw_update": n_k1})
    h = [float(x) for x in res.history]
    assert res.iterations == 3 and all(np.isfinite(h))
    assert all(a > b_ for a, b_ in zip(h, h[1:])), f"LSQR residual not decreasing: {h}"
    live(res.x, "LSQR model")
    log(55, f"off-grid RTM at 256^3, order 8, source at {okw['src_pos']}, a 64 x 64 "
            "receiver plane at depth 4.5, no wave kernel launched: "
            + "; ".join(f"{k} {ms:.3f} ms/step, peak {gib:.2f} GiB"
                        for k, (ms, gib) in stats.items())
            + f"; {msg_busy}; {msg_gate}; RTM image int8 vs autodiff cosine "
            f"{cos_rtm:.6f} (> 0.95), "
            f"f32 history vs autodiff {cos_32:.8f} (> 1 - 1e-4); "
            f"LSQR 3 iterations on the int8 Born operator in {t_lsqr:.2f} s, residual norms "
            + ", ".join(f"{x:.6e}" for x in h) + f" (decreasing), K1 {n_k1} launches [{smi}]")
    del J8, img, res, d_obs, Fo

    # ---- phase 56: off-grid checks ---------------------------------------------------
    # integer positions against wave_propagator on its kernel route (K4 at order 8)
    ys, xs = np.arange(8, n - 8, n // 16 - 1), np.arange(10, n - 6, n // 16 - 1)
    Fi = offgrid_wave_propagator(wshape, nt=60, **{
        **okw, "src_pos": (4.0, n / 2, n / 2), "rcv_depth": 4.0,
        "rcv_coords": (ys.astype(float), xs.astype(float))})
    rcv_i = [int(np.ravel_multi_index((4, y, x), wshape)) for y in ys for x in xs]
    Fw = wave_propagator(wshape, nt=60, src_idx=int(np.ravel_multi_index((4, n // 2, n // 2),
                                                                         wshape)),
                         rcv_idx=rcv_i, space_order=8,
                         **{k: v for k, v in wkw.items() if k != "rcv_idx"})
    d_i = plain(lambda: Fi(c_true), "off-grid integer positions")
    d_w = reference(lambda: Fw(c_true), {"fused_leapfrog_step": 60})
    msg_int = agree(d_i.reshape(60, -1), d_w, "integer positions vs K4 (order 8) traces",
                    1e-5)
    # the sampling operators' gates at 256^3
    sp = Fi.dom
    S = sinc_sampling_operator(sp, [np.linspace(3.3, n - 5.9, 64),
                                    np.linspace(2.7, n - 4.6, 48),
                                    np.linspace(5.5, n - 6.5, 40)])
    P = sinc_point_sampling_operator(sp, np.random.default_rng(56).uniform(
        4.0, n - 5.0, (64, 3)))
    msg_s = "; ".join(gate(A, 12 + i, name) for i, (A, name) in enumerate(
        ((S, "sinc_sampling_operator 256^3 -> (64, 48, 40)"),
         (P, "sinc_point_sampling_operator 256^3, 64 points"))))
    okw_c = dict(okw, src_pos=(3.37, cshape[1] / 2 - 0.4, cshape[2] / 2 + 0.3),
                 rcv_coords=(np.linspace(0.1 * cshape[1], 0.9 * cshape[1], 16),
                             np.linspace(0.05 * cshape[2], 0.95 * cshape[2], 32)),
                 sponge_width=6)
    Fk = offgrid_wave_propagator(cshape, nt=12, store_adjoint="int8", **okw_c)
    Fc = offgrid_wave_propagator(cshape, nt=12, store_adjoint="int8", device="cpu", **okw_c)
    ck = corner(c_true)
    rr = torch.from_numpy(np.random.default_rng(57).standard_normal((12, 16, 32))
                          .astype(np.float32))
    dk, gk = plain(lambda: (Fk(ck), Fk.linearize(ck).H(rr.to(dev))), "off-grid corner")
    msg_cpu = (agree(dk, Fc(ck.cpu()), "off-grid card vs CPU traces", 1e-5) + "; "
               + agree(gk, Fc.linearize(ck.cpu()).H(rr), "off-grid card vs CPU int8 gradient",
                       1e-5))
    log(56, f"off-grid checks: {msg_int}; {msg_s}; at {cshape}, nt=12: {msg_cpu} [{smi}]")
    return launched


# The DSP/transform sizes of the tenth path (phases 57-60): a 16-shot block
# of gathers with the flagship's 4096 receivers and 2048 samples at 4 ms
# (8.2 s records), float32, and the deblending geometry of one receiver
# (examples/07_deblending.py at full size). SMALL is the shape at which each
# phase holds the card against the CPU.
GATHER = (16, 4096, 2048)
PANEL = GATHER[1:]
DEBLEND = (1024, 2000)  # shots, samples at 2 ms
SMALL = (2, 64, 512)
DSP_ITERS, DEBLEND_ITERS = 50, 100  # the examples run 200 and 400


def _wide_space(sp):
    """``sp`` with float64 (complex128) members, for the gates' f64 sums."""
    from jets_tpu_torch import Space, SymmetricSpace
    wide = torch.complex128 if sp.dtype.is_complex else torch.float64
    if isinstance(sp, SymmetricSpace):
        return SymmetricSpace(sp.shape, sp.logical_shape, wide, sp.axis, sp.device)
    return Space(sp.shape, wide, sp.device)


def dsp_path(smi):
    """Phases 57-60, the tenth path: the symmetric spaces and the
    DSP/transform operator packs on the card at the width of a 16-shot block
    of gathers (16, 4096, 2048) float32. Phase 57: the processing chain of
    examples/06 (shift @ bandpass @ taper) inverted by damped LSQR through
    K1, and its wavelet compression; 58: ``rfft_operator`` onto the
    ``SymmetricSpace`` and GMRES(16) on an FFT composite; 59: the deblending
    of examples/07 at one receiver's full size (1024 shots of 2000 samples),
    LSQR through K1; 60: every other operator of the packs at gather width.
    Each operator passes its dot-product gate (f32 sums and f64 sums of the
    same products, <= 1e-4), each nonlinear one its linearization gate, each
    phase holds the card against the CPU at a small shape (bitwise for the
    elementwise and data-movement operators, <= 1e-6 for FFT, cuBLAS and
    reductions) and asserts that no kernel ran but K1 in its two LSQR
    solves, counted from 0. Returns K1's launches of the counted solves."""
    from jets_tpu_torch import Space, dot_product_test, linearization_test
    from jets_tpu_torch import ops as O
    from jets_tpu_torch.ops import cuda_solver as cs
    from jets_tpu_torch.solvers import gmres, lsqr

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    dt = 0.004
    launched = {}

    def reset():
        cs.reset_launch_counts()
        _reset_counts()

    def counts():
        """Every kernel's launches since the last reset, zeros left out."""
        return {k: n for k, n in {**cs.launch_counts(), **_counts()}.items() if n}

    def no_kernels(fn, name):
        reset()
        out = fn()
        assert counts() == {}, f"{name} launched {counts()}"
        return out

    base = [0]

    def start():
        """A phase starts: its time, and its peak memory counted from here."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base[0] = torch.cuda.memory_allocated()
        return time.perf_counter()

    def peak():
        return (f"peak device memory {(torch.cuda.max_memory_allocated() - base[0]) / 2**30:.2f}"
                " GiB above the phase's start")

    def draw(sp, seed, positive=False, shift=0.0):
        """A seeded numpy draw of a member of ``sp`` as a CPU tensor."""
        rng = np.random.default_rng(seed)
        x = rng.standard_normal(sp.shape)
        if sp.dtype.is_complex:
            x = x + 1j * rng.standard_normal(sp.shape)
        x = np.abs(x) + 0.5 if positive else x + shift
        return torch.from_numpy(x).to(sp.dtype)

    def gate(A, seed, name):
        """The dot-product gate of ``A`` on the card with f32 sums and with f64
        sums of the same products (rel <= 1e-4 each)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        m, d = A.dom.randn(g), A.rng.randn(g)
        lhs, rhs = dot_product_test(A, m, d)
        Am, Ad = A(m), A.H(d)
        wd, wr = _wide_space(A.dom), _wide_space(A.rng)
        lhs64 = complex(wr.dot(d.to(wr.dtype), Am.to(wr.dtype)))
        rhs64 = complex(wd.dot(Ad.to(wd.dtype), m.to(wd.dtype)))
        if A.dom.dtype.is_complex != A.rng.dtype.is_complex:
            lhs64, rhs64 = lhs64.real, rhs64.real
        g32 = abs(complex(lhs) - complex(rhs)) / abs(complex(rhs))
        g64 = abs(lhs64 - rhs64) / abs(rhs64)
        assert g32 <= 1e-4 and g64 <= 1e-4, f"{name} gate rel {g32}, f64 sums {g64}"
        return f"{name} gate {g32:.1e}/{g64:.1e}"

    def lin_gate(F, m0, name):
        """The linearization (Taylor) gate of ``F`` at ``m0`` with a small
        perturbation: the last two ratios within 20% of 4."""
        g = torch.Generator(device=dev).manual_seed(5)
        obs, exp = linearization_test(F, m0, delta_m=0.1 * F.dom.randn(g))
        obs = obs.cpu().numpy()
        assert np.allclose(obs[-2:], exp.cpu().numpy()[-2:], rtol=0.2), (name, obs)
        return f"{name} Taylor ratios " + "/".join(f"{o:.3f}" for o in obs)

    def versus_cpu(build, name, exact, nonlinear=False, **kw):
        """``build(device)`` on the card and on the CPU, applied to the same
        numpy draws: forward and adjoint (nonlinear: forward, tangent and its
        adjoint); bitwise when ``exact``, else rel <= 1e-6. Returns text with
        the observed difference."""
        Ak, Ac = build(dev), build(cpu)
        m, d = draw(Ac.dom, 1, **kw), draw(Ac.rng, 2)
        if nonlinear:
            dm = draw(Ac.dom, 3)
            Jk, Jc = Ak.linearize(m.to(dev)), Ac.linearize(m)
            pairs = [(Ak(m.to(dev)), Ac(m)), (Jk(dm.to(dev)), Jc(dm)), (Jk.H(d.to(dev)), Jc.H(d))]
        else:
            pairs = [(Ak(m.to(dev)), Ac(m)), (Ak.H(d.to(dev)), Ac.H(d))]
        bits = all(torch.equal(k.cpu(), c) for k, c in pairs)
        worst = max(rel(k, c) for k, c in pairs)
        if exact:
            assert bits, f"{name}: card and CPU not bitwise (rel {worst})"
        else:
            assert worst <= 1e-6, f"{name}: card vs CPU rel {worst} > 1e-6"
        return f"{name} {'bitwise' if bits else f'{worst:.1e}'}"

    def solve_ms(solve, iters, name):
        """Marginal ms per iteration of ``solve(maxiter)`` between ``iters/5``
        and ``iters`` iterations (CUDA events, median of 3), and the device
        busy share of 10 iterations under the profiler."""
        def run(n):
            return event_ms(lambda: solve(n))
        lo = iters // 5
        run(lo)
        t_lo = sorted(run(lo) for _ in range(3))[1]
        t_hi = sorted(run(iters) for _ in range(3))[1]
        sh, wall, nev, top = busy_share(lambda: solve(10))
        return ((t_hi - t_lo) / (iters - lo),
                f"{name}: device busy {'not measured' if sh is None else f'{sh:.3f}'} of "
                f"{wall:.2f} ms for 10 iterations ({nev / 10:.1f} device events per "
                "iteration; top kernels, us total/count: "
                + "; ".join(f"{nm} {t:.0f}/{c}" for nm, (t, c) in top) + ")")

    # ---- phase 57: the processing chain, inverted by LSQR through K1 ----------------
    t_ph = start()
    sp = Space(GATHER)

    def chain(space):
        return (O.shift_operator(space, 3.5 * dt, dt=dt)
                @ O.bandpass_operator(space, dt, 8.0, 45.0, f_taper=4.0)
                @ O.taper_operator(space, (0, 0, 32)))

    A = chain(sp)
    msgs = [gate(A, 57, "chain")]
    g = torch.Generator(device=dev).manual_seed(7)
    m_true = O.bandpass_operator(sp, dt, 2.0, 18.0)(sp.randn(g))
    d_obs = A(m_true)
    reset()
    res = lsqr(A, d_obs, maxiter=DSP_ITERS, tol=0.0, damp=1e-4)
    torch.cuda.synchronize()
    got = counts()
    assert got == {"xw_update": DSP_ITERS}, f"chain LSQR launched {got}"
    launched["xw_update"] = launched.get("xw_update", 0) + DSP_ITERS
    live(res.x, "chain LSQR x")
    misfit = rel(A(res.x), d_obs)
    assert misfit < 0.05, f"chain misfit {misfit}"
    ms_it, busy_txt = solve_ms(lambda n: lsqr(A, d_obs, maxiter=n, tol=0.0, damp=1e-4),
                               DSP_ITERS, "chain LSQR")
    # the wavelet view of the result: keep the coefficients above the 90%
    # quantile of |c| (torch.quantile refuses more than 2^24 elements, so the
    # quantile's linear interpolation between two kthvalue order statistics)
    W = O.wavelet_operator(sp, "db2", levels=3, axes=(2,))
    msgs.append(gate(W, 58, "wavelet db2 x3"))
    c = W(res.x)
    a = c.abs().reshape(-1)
    pos = 0.9 * (a.numel() - 1)
    k = int(np.floor(pos))
    q0, q1 = (torch.kthvalue(a, k + 1 + i).values for i in (0, 1))
    thresh = q0 + (pos - k) * (q1 - q0)
    kept = float((a > thresh).sum()) / a.numel()
    x_c = W.H(torch.where(c.abs() > thresh, c, torch.zeros_like(c)))
    werr = rel(x_c, res.x)
    assert 0.0 < werr < 1.0, f"wavelet reconstruction error {werr}"
    del c, a, x_c
    # K1 at the gather's shape: its time against its bound and its plain version
    xs = [torch.randn(GATHER, generator=g, device=dev) for _ in range(3)]
    sc = [torch.tensor(v, device=dev) for v in (0.37, -0.21, 1.7)]
    k1_ms = cuda_ms(lambda: cs.xw_update(xs[0], xs[1], xs[2], *sc), 20)
    k1_plain = cuda_ms(lambda: cs.xw_update_torch(xs[0], xs[1], xs[2], *sc), 20)
    k1_bound, k1_by = bound_ms(nbytes(*xs, *xs[:2]), xs[0].numel(), "xw_update")
    del xs
    small = Space(SMALL)
    cpu_txt = "; ".join((
        versus_cpu(lambda dv: chain(Space(SMALL, device=dv)), "chain", exact=False),
        versus_cpu(lambda dv: O.taper_operator(Space(SMALL, device=dv), (0, 0, 32)), "taper",
                   exact=True),
        versus_cpu(lambda dv: O.wavelet_operator(Space(SMALL, device=dv), "db2", 3, (2,)),
                   "wavelet", exact=False)))
    log(57, f"processing chain shift(3.5 dt) @ bandpass(8-45 Hz, taper 4) @ taper(0, 0, 32) on "
            f"{GATHER} f32, dt {dt}: {msgs[0]}; LSQR damp 1e-4, {DSP_ITERS} iterations (the "
            f"example runs 200): relative data misfit {misfit:.4e}, exactly {DSP_ITERS} K1 "
            f"launches and no other kernel, {ms_it:.3f} ms/iteration (marginal, CUDA events); "
            f"{busy_txt}; {msgs[1]}: kept {kept:.4f} of the coefficients (90% quantile "
            f"{float(thresh):.6g} by kthvalue), reconstruction error {werr:.4f}; K1 at "
            f"{GATHER}: {1e3 * k1_ms:.1f} us vs plain {1e3 * k1_plain:.1f} us, bound "
            f"{1e3 * k1_bound:.1f} us by {k1_by}; card vs CPU at {SMALL}: {cpu_txt}; "
            f"{peak()}; {time.perf_counter() - t_ph:.1f} s [{smi}]")
    del A, W, res, m_true, d_obs

    # ---- phase 58: rfft onto the SymmetricSpace; GMRES on an FFT composite -----------
    t_ph = start()

    def phase58():
        R = O.rfft_operator(sp)
        assert R.rng.shape == GATHER[:2] + (GATHER[2] // 2 + 1,)
        assert R.rng.dtype == torch.complex64 and R.rng._weights().device.type == dev.type
        out = [gate(R, 59, f"rfft {GATHER} -> SymmetricSpace {R.rng.shape}")]
        x = Space((16, 512, 2048)).randn(g)
        lg = O.rfft_operator(Space((16, 512, 2048))).rng.to_logical(torch.fft.rfftn(x))
        r_log = rel(lg, torch.fft.fftn(x))
        assert r_log <= 1e-6, f"to_logical(rfftn) vs fftn rel {r_log}"
        out.append(f"to_logical(rfftn(x)) vs fftn(x) at (16, 512, 2048) rel {r_log:.2e}")
        del x, lg
        csp = Space((1024, 1024), torch.complex64)
        F = O.fft_operator(csp)
        dvals = draw(csp, 4).to(dev) * 0.5 / np.sqrt(2.0)
        Ag = (F.H @ O.diagonal_operator(dvals, device=dev) @ F) + 2.0 * O.identity_operator(csp)
        x_true = draw(csp, 5).to(dev) / np.sqrt(2.0)
        t0 = time.perf_counter()
        rg = gmres(Ag, Ag(x_true), maxiter=96, restart=16, tol=1e-6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        err = rel(rg.x, x_true)
        assert err <= 1e-4, f"GMRES error {err}"
        out.append(f"GMRES(16) on F^H D F + 2I over fft_operator on (1024, 1024) complex64: "
                   f"{rg.iterations} iterations, relative error {err:.3e} (<= 1e-4), "
                   f"{wall:.3f} s")
        out.append("card vs CPU at " + f"{SMALL}: " + "; ".join((
            versus_cpu(lambda dv: O.rfft_operator(Space(SMALL, device=dv)), "rfft",
                       exact=False),
            versus_cpu(lambda dv: O.fft_operator(Space(SMALL[1:], torch.complex64, device=dv)),
                       "fft", exact=False))))
        return out

    log(58, "; ".join(no_kernels(phase58, "phase 58")) + f"; no kernel launched; {peak()}; "
            f"{time.perf_counter() - t_ph:.1f} s [{smi}]")

    # ---- phase 59: deblending, LSQR through K1 -----------------------------------
    t_ph = start()
    nshots, nt = DEBLEND
    rng = np.random.default_rng(0)  # examples/07_deblending.py's schedule and spikes
    t0s = np.sort(rng.integers(0, (3 * nshots * nt) // 4, nshots))
    T = int(t0s.max()) + nt
    spikes = np.zeros((nshots, nt), np.float32)
    for s in range(nshots):
        idx = rng.integers(20, nt - 20, 4)
        spikes[s, idx] = rng.standard_normal(4)
    B = O.blend_operator(nshots, nt, t0s, T)
    S = O.integration_operator(Space((nshots, nt)), axis=1)
    m_true = S(torch.from_numpy(spikes).to(dev))
    d = B(m_true)
    A = B @ S
    msgs = [gate(B, 60, "blend"), gate(A, 61, "blend @ integration")]
    reset()
    res = lsqr(A, d, maxiter=DEBLEND_ITERS, tol=0.0, damp=1e-3)
    torch.cuda.synchronize()
    got = counts()
    assert got == {"xw_update": DEBLEND_ITERS}, f"deblending LSQR launched {got}"
    launched["xw_update"] += DEBLEND_ITERS
    m_est = S(res.x)
    merr, relres = rel(m_est, m_true), rel(B(m_est), d)
    assert merr < 1.0 and relres < 0.5, (merr, relres)
    ms_it, busy_txt = solve_ms(lambda n: lsqr(A, d, maxiter=n, tol=0.0, damp=1e-3),
                               DEBLEND_ITERS, "deblending LSQR")
    ft = np.array([0, 30, 45, 100, 101, 170, 200, 230])

    def blend_small(dv):
        return O.blend_operator(8, 64, ft, 294, device=dv)

    cpu_txt = "; ".join((
        versus_cpu(blend_small, "blend", exact=True),
        versus_cpu(lambda dv: O.integration_operator(Space((8, 64), device=dv), axis=1),
                   "integration", exact=False),
        versus_cpu(lambda dv: blend_small(dv) @ O.integration_operator(
            Space((8, 64), device=dv), axis=1), "blend @ integration", exact=False)))
    log(59, f"deblending {nshots} shots x {nt} samples into T = {T} (firing times of "
            f"examples/07, seed 0; {B.jet.state['table'].shape[0]} gather rows): "
            + "; ".join(msgs) + f"; LSQR damp 1e-3, {DEBLEND_ITERS} iterations (the example "
            f"runs 400): model error {merr:.4f}, blended residual {relres:.4e}, exactly "
            f"{DEBLEND_ITERS} K1 launches and no other kernel, {ms_it:.3f} ms/iteration "
            f"(marginal, CUDA events); {busy_txt}; card vs CPU: {cpu_txt}; {peak()}; "
            f"{time.perf_counter() - t_ph:.1f} s [{smi}]")
    del A, B, S, res, m_true, d, m_est

    # ---- phase 60: the rest of the packs at gather width ----------------------------
    t_ph = start()
    nx = PANEL[0]
    offsets = 12.5 * np.arange(nx)
    # a linear mute: sample t of receiver x is kept from 20 + 0.2 |x - nx/2| on
    mute_mask = (np.arange(GATHER[2])[None, :] >= 20 + 0.2 * np.abs(
        np.arange(nx) - nx / 2)[:, None]).astype(np.float32)

    def mute(sp):
        return O.mute_operator(sp, np.broadcast_to(
            mute_mask[:sp.shape[1], :sp.shape[2]], sp.shape))

    def interp(sp):
        pos = np.sort(np.random.default_rng(8).uniform(0, sp.shape[1] - 1, sp.shape[1]))
        return O.interp_operator(sp, pos, axis=1)

    def projection(sp):
        V = np.random.default_rng(9).standard_normal((8,) + sp.shape).astype(np.float32)
        return O.projection_operator(V, device=sp.device)

    def complex_of(sp):
        return Space(sp.shape, torch.complex64, sp.device)

    # (name, constructor on a space, card vs CPU bitwise?, nonlinear?, start keywords)
    gather_ops = [
        ("envelope", O.envelope_operator, False, True, {"shift": 2.0}),
        ("mix (1, 5, 11)", lambda s: O.mix_operator(s, (1, 5, 11)), True, False, {}),
        ("roughness (1, 5, 11)", lambda s: O.roughness_operator(s, (1, 5, 11)), True, False,
         {}),
        ("nim", O.nim_operator, False, True, {"shift": 0.1}),
        ("difference", O.difference_operator, True, False, {}),
        ("integration 0.95", lambda s: O.integration_operator(s, 0.95), False, False, {}),
        ("translation (0, 1.5, 2.25)", lambda s: O.translation_operator(s, (0.0, 1.5, 2.25)),
         False, False, {}),
        ("resample x2 down", lambda s: O.resample_operator(s, s.shape[2] // 2), False, False,
         {}),
        ("mute", mute, True, False, {}),
        ("square", O.square_operator, True, True, {}),
        # PyTorch's float32 sqrt on the CPU is not correctly rounded (the
        # card's is), so the two differ by an ulp on a few elements
        ("sqrt", O.sqrt_operator, False, True, {"positive": True}),
        ("interp (duplicate bins)", interp, True, False, {}),
    ]
    panel_ops = [
        ("dct", O.dct_operator, False, False, {}),
        ("lmo", lambda s: O.lmo_operator(s, dt, offsets[:s.shape[0]] - offsets[s.shape[0] // 2],
                                         1.0 / 3000.0), False, False, {}),
        ("reghost", lambda s: O.reghost_operator(s, dt, 12.5, 15.0), False, False, {}),
        ("identity", O.identity_operator, True, False, {}),
        ("pad", lambda s: O.pad_operator(s, [(3, 5), (0, 64)]), True, False, {}),
        ("restriction", lambda s: O.restriction_operator(
            s, [(s.shape[0] // 4, 3 * s.shape[0] // 4), (8, s.shape[1] - 8)]), True, False, {}),
        ("reshape", lambda s: O.reshape_operator(s, (s.shape[0] // 2, 2 * s.shape[1])), True,
         False, {}),
        ("transpose", lambda s: O.transpose_operator(s, (1, 0)), True, False, {}),
        ("flip", lambda s: O.flip_operator(s, (0, 1)), True, False, {}),
        ("permutation", lambda s: O.permutation_operator(
            s, np.random.default_rng(10).permutation(s.size)), True, False, {}),
        ("circshift", lambda s: O.circshift_operator(s, (17, -300)), True, False, {}),
        ("projection k=8", projection, False, False, {}),
        ("real", lambda s: O.real_operator(complex_of(s)), True, False, {}),
        ("imag", lambda s: O.imag_operator(complex_of(s)), True, False, {}),
    ]

    def radon(nt_, nx_, np_, dv):
        return O.radon_operator(nt_, np.linspace(-nx_ / 2, nx_ / 2, nx_) * 25.0,
                                np.linspace(-4e-4, 4e-4, np_), dt, device=dv)

    def phase60():
        out, small_out = [], []
        for shape, small_shape, specs in ((GATHER, SMALL, gather_ops),
                                          (PANEL, SMALL[1:], panel_ops)):
            for name, make, exact, nonlinear, kw in specs:
                op = make(Space(shape))
                if nonlinear:
                    m0 = (op.dom.rand(g) + 0.5 if kw.get("positive")
                          else op.dom.randn(g) + kw.get("shift", 0.0))
                    out.append(gate(op.linearize(m0), 62, name + " tangent") + ", "
                               + lin_gate(op, m0, name))
                else:
                    out.append(gate(op, 62, name))
                if make is interp:
                    dd = op.rng.randn(g)
                    assert torch.equal(op.H(dd), op.H(dd)), "interp adjoint not repeatable"
                    out[-1] += (f", onto {op.rng.shape[1]} positions, adjoint bitwise on a "
                                f"repeat ({op.jet.state['table'].shape[0]} gather rows)")
                del op
                small_out.append(versus_cpu(
                    lambda dv, make=make, small_shape=small_shape: make(
                        Space(small_shape, device=dv)), name, exact, nonlinear, **kw))
        Rd = radon(2048, 512, 256, dev)
        out.append(gate(Rd, 63, f"radon nt 2048, 256 slownesses, 512 offsets (phase tensor "
                                f"{nbytes(Rd.jet.state['phase']) / 1e9:.2f} GB)"))
        del Rd
        small_out.append(versus_cpu(lambda dv: radon(64, 16, 8, dv), "radon", exact=False))
        return out, small_out

    out, small_out = no_kernels(phase60, "phase 60")
    log(60, f"at {GATHER} and {PANEL} f32: " + "; ".join(out) + f"; card vs CPU at {SMALL} "
            f"and {SMALL[1:]}: " + "; ".join(small_out) + f"; no kernel launched; {peak()}; "
            f"{time.perf_counter() - t_ph:.1f} s [{smi}]")
    return launched


def _counts_all():
    """Every kernel's launches (solver and wave) since the last reset, zeros
    left out."""
    from jets_tpu_torch.ops import cuda_solver as cs
    return {k: n for k, n in {**cs.launch_counts(), **_counts()}.items() if n}


def _reset_all():
    from jets_tpu_torch.ops import cuda_solver as cs
    cs.reset_launch_counts()
    _reset_counts()


def _grad_and_adjoint(F, m, d_obs, func_vjp=False):
    """The autograd gradient of ``0.5||F(m) - d_obs||^2`` over every block of
    ``m`` and the derived adjoint ``F.linearize(m).H(F(m) - d_obs)`` (and,
    with ``func_vjp``, ``torch.func.vjp`` of ``F`` at the same residual),
    each with its peak device memory above the start (GiB) and its seconds:
    ``(traces, grads, adjoint blocks, (peak_g, peak_a[, peak_v]), (t_g,
    t_a[, t_v])[, vjp blocks])``."""
    from jets_tpu_torch import BlockVector

    def run(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2**30, \
            time.perf_counter() - t0

    def grad():
        leaves = [t.clone().requires_grad_() for t in _blocks(m)]
        mm = BlockVector(leaves, m.space) if isinstance(m, BlockVector) else leaves[0]
        out = F(mm)
        r_ = out - d_obs
        return out.detach(), torch.autograd.grad(0.5 * torch.sum(r_ * r_), leaves)

    (out, g), peak_g, t_g = run(grad)
    a, peak_a, t_a = run(lambda: _blocks(F.linearize(m).H(out - d_obs)))
    if not func_vjp:
        return out, g, a, (peak_g, peak_a), (t_g, t_a)
    v, peak_v, t_v = run(lambda: _blocks(torch.func.vjp(F, m)[1](out - d_obs)[0]))
    return out, g, a, (peak_g, peak_a, peak_v), (t_g, t_a, t_v), v


def vmap_remat(smi, c_true, wkw):
    """Phase 62: ``remat_blocks`` under the ``"vmap"`` shot stacks at full
    width. ``multishot_wave_operator`` at 256^3 f32, ``shot_map="vmap"``, 4
    shots, nt=120, ``remat_blocks`` 12 against 1: the autograd gradient of
    ``0.5||F(c) - d||^2`` and the derived adjoint ``linearize(c).H(r)`` (the
    ``_Segment`` route), traces bitwise, gradients and adjoints bitwise or
    within 1e-6, the remat-12 peak below the remat-1 peak, no wave kernel
    launched (the vmap stack runs the plain step), and the same 4 shots in
    ``shot_map="map"`` at remat 12 (the checkpoint route, its segments
    recomputing through K4) within a stated tolerance; then the VTI and TTI
    vmap stacks at (32, 64, 128), nt=24, 2 shots, remat 1 against 4,
    bitwise. Counts from 0; returns K4's launches (the observed data and
    the map-mode reference)."""
    from jets_tpu_torch import BlockVector
    from jets_tpu_torch.ops.wave import (multishot_tti_wave_operator,
                                         multishot_vti_wave_operator,
                                         multishot_wave_operator)

    dev = c_true.device
    t_ph = time.perf_counter()
    _reset_all()
    wshape = tuple(c_true.shape)
    nt, nz, ny, nx = 120, *wshape
    srcs = [int(np.ravel_multi_index((nz // 2, ny // 2, nx * k // 8), wshape))
            for k in (2, 3, 5, 6)]
    kw = dict(nt=nt, **wkw)
    d_obs = multishot_wave_operator(wshape, srcs, shot_map="map", **kw)(c_true)
    assert _counts_all() == {"fused_leapfrog_step": 4 * nt}, _counts_all()
    c0 = torch.full(wshape, 1500.0, device=dev)
    runs = {}
    for rb in (1, 12):
        F = multishot_wave_operator(wshape, srcs, shot_map="vmap", remat_blocks=rb, **kw)
        before = _counts_all()
        runs[rb] = _grad_and_adjoint(F, c0, d_obs, func_vjp=True)
        assert _counts_all() == before, f"the vmap stack launched {_counts_all()}"
        del F
    (o1, g1, a1, p1, t1, v1), (o12, g12, a12, p12, t12, v12) = runs[1], runs[12]
    msgs = [same(o12, o1, "traces")]
    for name, x, y in (("gradient", g12[0], g1[0]), ("derived adjoint", a12[0], a1[0]),
                       ("torch.func.vjp", v12[0], v1[0]),
                       ("adjoint vs gradient", a12[0], g12[0]),
                       ("torch.func.vjp vs gradient", v12[0], g12[0])):
        msgs.append(agree(x, y, name, 1e-6))
    assert all(x < y for x, y in zip(p12, p1)), f"remat peaks {p12} not below {p1}"
    # the map-mode stack at remat 12: checkpointed segments recomputing on K4
    Fm = multishot_wave_operator(wshape, srcs, shot_map="map", remat_blocks=12, **kw)
    before = _counts_all()
    om, gm, am, pm, tm_ = _grad_and_adjoint(Fm, c0, d_obs)
    n_map = {k: v - before.get(k, 0) for k, v in _counts_all().items()}
    assert n_map == {"fused_leapfrog_step": 2 * 2 * 4 * nt}, n_map  # gradient + adjoint
    msgs.append(agree(o12, om, "vmap vs map traces", 1e-6))
    msgs.append(agree(g12[0], gm[0], "vmap vs map gradient", 1e-5))
    msgs.append(agree(a12[0], am[0], "vmap vs map adjoint", 1e-5))
    del Fm, o1, g1, a1, v1, o12, g12, a12, v12, om, gm, am, d_obs
    log(62, f"multishot_wave_operator {wshape} f32, vmap, 4 shots, nt={nt}, remat_blocks 12 "
            "vs 1, gradient of 0.5||F(c) - d||^2, linearize(c).H(r) and torch.func.vjp: "
            + "; ".join(msgs[:6])
            + "; no wave kernel launched; peak device memory above the start (GiB) and "
            "seconds, remat 1 vs 12: " + ", ".join(
                f"{name} {p1[i]:.2f} vs {p12[i]:.2f} GiB, {t1[i]:.2f} vs {t12[i]:.2f} s"
                for i, name in enumerate(("gradient", "derived adjoint", "torch.func.vjp")))
            + f"; map mode at remat 12 (K4 {n_map['fused_leapfrog_step']} launches, peak "
            f"{pm[0]:.2f} GiB, {tm_[0]:.2f} s): " + "; ".join(msgs[6:]) + f" [{smi}]")
    # VTI and TTI vmap stacks at phase 49's small grid, (32, 64, 128) at 256^3
    cs_ = c_true[::8, ::4, ::2].contiguous()
    sshape = tuple(cs_.shape)
    ssrc = int(np.ravel_multi_index(tuple(n // 2 for n in sshape), sshape))
    skw = dict(nt=24, dt=wkw["dt"], dx=wkw["dx"], freq=wkw["freq"], sponge_width=6,
               rcv_idx=[int(np.ravel_multi_index((sshape[0] // 2, sshape[1] // 2, x), sshape))
                        for x in range(sshape[2])])

    def full(v):
        return torch.full(sshape, v, device=dev)

    small = []
    for name, ctor, extra in (
            ("VTI", multishot_vti_wave_operator, (0.1, 0.05)),
            ("TTI", multishot_tti_wave_operator, (0.1, 0.05, 0.2, 0.7))):
        outs = []
        for rb in (1, 4):
            F = ctor(sshape, [ssrc, ssrc + 16], shot_map="vmap", remat_blocks=rb, **skw)
            m = BlockVector((cs_, *(full(v) for v in extra)), F.dom)
            before = _counts_all()
            outs.append(_grad_and_adjoint(F, m, torch.zeros(F.rng.shape, device=dev)))
            assert _counts_all() == before, f"{name} vmap launched {_counts_all()}"
        (oa, ga, aa, pa, _), (ob, gb, ab, pb, _) = outs
        assert torch.equal(oa, ob), f"{name} remat traces differ"
        for i, (x, y, u, v) in enumerate(zip(ga, gb, aa, ab)):
            live(x, f"{name} gradient {i}")
            assert torch.equal(x, y) and torch.equal(u, v), f"{name} block {i} not bitwise"
        small.append(f"{name} traces, {len(ga)} gradient and adjoint blocks bitwise, peak "
                     f"{pa[0]:.3f} vs {pb[0]:.3f} GiB")
    log(62, f"vmap stacks at {sshape}, nt=24, 2 shots, remat 1 vs 4, no wave kernel "
            "launched: " + "; ".join(small)
            + f"; phase 62 in {time.perf_counter() - t_ph:.1f} s [{smi}]")
    return _counts_all()


def _trace_kernel(name):
    """The kernel function of a trace event's name, mangled (``kernel_of``)
    or demangled (``void ns::name<...>(...)``)."""
    if name.startswith("_Z"):
        return kernel_of(name)[0]
    head = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", head)[0].split("::")[-1].strip()


def utils_path(smi, c_true, wkw, flagship=((256, 256, 256), 16, 4096)):
    """Phases 63-64: the ``utils`` layer on the card. Phase 63, on phase 2's
    3-D flagship (256^3, 16 shots, 4096 receivers; K1 on the LSQR route,
    K3 on the adjoint tail, K2 on the hooked one): LSQR for 10 iterations,
    ``save_checkpoint`` of the card state, ``load_checkpoint`` onto the card
    and 10 more, bitwise an uninterrupted 20-iteration run, ``tree_hash``
    of the card state equal to its CPU copy's and to the file's CRC32C;
    ``checked(A, "A")`` bitwise ``A`` and raising on a NaN, its overhead
    per apply; ``trace`` around 5 hooked LSQR iterations, its Chrome trace
    holding exactly 5 K1 kernel events; the native CRC32C, codec and loader
    libraries built and loaded. Phase 64: the 256^3 iso forward on K4 for
    120 steps with every 10th snapshot appended to a disk ``SnapshotStore``
    at 12 bits (one snapshot's bytes equal the numpy codec's, each read-back
    within 2e-3 of its max at a ratio > 2.6), and the flagship's data
    streamed to the card in blocks of 4 shots by
    ``ShotGatherLoader(device_put=True)``, the blockwise ``A^H(A m - d)``
    against the in-memory one. Counts from 0; returns the launches."""
    import os
    import shutil
    import tempfile

    from jets_tpu_torch import utils
    from jets_tpu_torch.models.seismic import (make_seismic_problem,
                                               seismic_operator_from_arrays)
    from jets_tpu_torch.ops import cuda_wave as cw
    from jets_tpu_torch.ops import wave as W
    from jets_tpu_torch.solvers import lsqr
    from jets_tpu_torch.utils import compression, hashing
    from jets_tpu_torch.utils.dataloader import ShotGatherLoader, ShotGatherStore

    dev = c_true.device
    t_ph = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_utils_")
    try:
        # ---- phase 63: checkpoint/resume, guards, profiling on the flagship ----
        grid3, nshots3, nrecv = flagship
        A, m_true, d = make_seismic_problem(grid3, nshots3, nrecv, seed=0, noise=0.05)
        _reset_all()
        r10 = lsqr(A, d, maxiter=10, tol=0.0)
        path = os.path.join(tmp, "lsqr_state.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = utils.save_checkpoint(path, r10.state, meta={"iteration": 10})
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        st, meta = utils.load_checkpoint(path, like=r10.state)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        assert st.x.device == r10.state.x.device == dev and meta["iteration"] == 10
        cpu_state = type(r10.state)(*(f.cpu() if isinstance(f, torch.Tensor) else f
                                      for f in r10.state))
        h_card, h_cpu = utils.tree_hash(r10.state), utils.tree_hash(cpu_state)
        assert h_card == h_cpu == meta["crc32c"] == h, (h_card, h_cpu, meta, h)
        resumed = lsqr(A, d, maxiter=20, tol=0.0, state=st)
        r20 = lsqr(A, d, maxiter=20, tol=0.0)
        msg_resume = same(resumed.x, r20.x, "resumed x")
        assert torch.equal(resumed.history[10:], r20.history[10:]) and \
            torch.equal(r10.history, r20.history[:10]), "resumed history not bitwise"
        n_resume = _counts_all()
        assert n_resume.get("xw_update") == 40, n_resume
        CA = utils.checked(A, "A")
        m = 0.5 * m_true
        msg_guard = same(CA(m), A(m), "checked(A)(m)")
        m_nan = m.clone()  # one NaN where the model reaches the data
        hot = int(torch.argmax(A.H(torch.ones(A.rng.shape, device=dev)).abs()))
        m_nan.view(-1)[hot] = float("nan")
        try:
            CA(m_nan)
            raise AssertionError("checked(A) let a NaN through")
        except FloatingPointError as e:
            # a linear operator's apply is its tangent, as in the JAX package
            assert str(e) == "non-finite output of A.tangent", str(e)
        ms_plain, ms_checked = cuda_ms(lambda: A(m), 20), cuda_ms(lambda: CA(m), 20)
        A_hook = seismic_operator_from_arrays(grid3, nshots3, nrecv,
                                              wr=A.jet.state["bstate"]["wr"],
                                              epilogue_hook=True)
        logdir = os.path.join(tmp, "trace")
        before = _counts_all()
        with utils.trace(logdir):
            lsqr(A_hook, d, maxiter=5, tol=0.0)
        n_traced = {k: v - before.get(k, 0) for k, v in _counts_all().items()
                    if v != before.get(k, 0)}
        assert n_traced.get("xw_update") == 5 and n_traced.get("lap3d_axpy_norm2") == 5, \
            n_traced
        files = os.listdir(logdir)
        assert len(files) == 1 and files[0].endswith(".json"), files
        with open(os.path.join(logdir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        kernels_seen = {}
        for e in events:
            if e.get("cat") == "kernel":
                k = _trace_kernel(e["name"])
                kernels_seen[k] = kernels_seen.get(k, 0) + 1
        assert kernels_seen.get("xw_update_kernel") == 5, kernels_seen
        loader_probe = ShotGatherLoader(ShotGatherStore.create(
            os.path.join(tmp, "probe.bin"), np.zeros((1, 4), np.float32)))
        native = {"crc32c": hashing.native(), "codec": compression.native(),
                  "loader": loader_probe.native}
        assert all(native.values()), native
        log(63, f"flagship {grid3} x {nshots3} shots x {nrecv} rcv: LSQR 10 + checkpoint "
                f"({os.path.getsize(path) / 2**20:.1f} MiB, save {1e3 * t_save:.1f} ms, load "
                f"to the card {1e3 * t_load:.1f} ms) + 10 resumed: {msg_resume}, history "
                f"bitwise; tree_hash card = CPU copy = file CRC32C {h:#010x}; {msg_guard}, "
                f"a NaN raises 'non-finite output of A.tangent'; A apply {ms_plain:.3f} ms, "
                f"checked {ms_checked:.3f} ms (+{ms_checked - ms_plain:.3f} ms); trace of 5 "
                f"hooked LSQR iterations: {len(events)} events, kernels {kernels_seen} "
                f"(K1 5 = the counters {n_traced}); native libraries {native} [{smi}]")
        # ---- phase 64: snapshots of the K4 forward; shot streaming ---------------
        wshape = tuple(c_true.shape)
        nt, dt, dx = 120, wkw["dt"], wkw["dx"]
        c2 = W._c2dt2(c_true, dt, dx)
        spz, spy, spx = W._factors_1d(W._make_sponge(wshape, wkw["sponge_width"]))
        spz, spy, spx = spz.to(dev), spy.to(dev), spx.to(dev)
        wav = W._ricker(nt, dt, wkw["freq"]).to(dev)
        amp = torch.tensor(dt * dt, device=dev)
        src = int(np.ravel_multi_index(tuple(n // 2 for n in wshape), wshape))
        up, u = torch.zeros(wshape, device=dev), torch.zeros(wshape, device=dev)
        store = compression.SnapshotStore(wshape, bits=12, path=os.path.join(tmp, "snaps"))
        before = _counts_all()
        kept, host_ms = [], []
        for k in range(nt):
            up = cw.fused_leapfrog_step(up, u, c2, spz, spy, spx, wav[k], src, amp,
                                        order=2, out=up)
            up, u = u, up
            if (k + 1) % 10 == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                store.append(u)
                host_ms.append(1e3 * (time.perf_counter() - t0))
                kept.append(u.to("cpu", copy=True))
        n_snap = {k: v - before.get(k, 0) for k, v in _counts_all().items()
                  if v != before.get(k, 0)}
        assert n_snap == {"fused_leapfrog_step": nt}, n_snap
        store.close()
        last = kept[-1].numpy()
        assert compression.compress_array(last, 12) == compression._compress_np(
            last.ravel(), 12), "native snapshot bytes differ from the numpy codec's"
        ro = compression.SnapshotStore.open(os.path.join(tmp, "snaps"))
        errs = []
        for i, snap in enumerate(kept):
            ref = snap.numpy()
            err_i = float(np.max(np.abs(ro.read(i) - ref))) / float(np.max(np.abs(ref)))
            assert err_i < 2e-3, f"snapshot {i}: max error {err_i} of its max"
            errs.append(err_i)
        assert ro.ratio > 2.6, ro.ratio
        # the flagship's data, streamed in blocks of 4 shots
        spath = os.path.join(tmp, "shots.bin")
        ShotGatherStore.create(spath, d)
        m = 0.5 * m_true
        pred = A(m)
        before = _counts_all()
        g_mem = A.H(pred - d)
        t0 = time.perf_counter()
        blocks = list(ShotGatherLoader(ShotGatherStore(spath), batch_shots=4,
                                       device_put=True))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        assert all(b.device == dev for _, b in blocks)
        g_blk = torch.zeros_like(g_mem)
        for idx, block in blocks:
            r = torch.zeros_like(pred)
            r[4 * idx:4 * idx + 4] = pred[4 * idx:4 * idx + 4] - block
            g_blk = g_blk + A.H(r)
        n_stream = {k: v - before.get(k, 0) for k, v in _counts_all().items()
                    if v != before.get(k, 0)}
        msg_stream = agree(g_blk, g_mem, "blockwise A^H(A m - d)", 1e-5)
        log(64, f"K4 forward {wshape}, nt={nt} (K4 {nt} launches), every 10th snapshot to a "
                f"disk SnapshotStore at 12 bits: {len(kept)} snapshots, bytes of the last "
                f"= the numpy codec's, read-back max error / max {min(errs):.3e}-"
                f"{max(errs):.3e} (< 2e-3), ratio {ro.ratio:.4f} (> 2.6), host ms per "
                f"snapshot (D2H + compress + write) {min(host_ms):.1f}-{max(host_ms):.1f}; "
                f"the flagship's d ({tuple(d.shape)}, {d.numel() * 4 / 2**20:.2f} MiB) "
                f"streamed in {len(blocks)} blocks of 4 shots at "
                f"{d.numel() * 4 / 2**20 / t_load:.1f} MiB/s: {msg_stream} (adjoint "
                f"launches {n_stream}); phases 63-64 in {time.perf_counter() - t_ph:.1f} s "
                f"[{smi}]")
        return _counts_all()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The distribution phases: the 3-D flagship, the 16-shot isotropic
# multishot of phase 12 (its sources along x at (128, 128, 16 + 14k)), the
# ranks of phase 66 and their hard limit (seconds; every collective of their
# group has half of it).
FLAGSHIP = ((256, 256, 256), 16, 4096)
MSRC = np.ravel_multi_index((np.full(16, 128), np.full(16, 128), 16 + 14 * np.arange(16)),
                            (256, 256, 256))
RANKS, RANK_TIMEOUT = 2, 480.0
DIST_REF = {}  # phase 65's 16-shot multishot gradient


def _wall_ms(fn, mesh=None):
    """Host milliseconds of ``fn`` from a synchronised start (every rank of
    ``mesh`` at a barrier) to its synchronised end."""
    import torch.distributed as dist

    if mesh is not None:
        dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _add(into, counts):
    for k, n in counts.items():
        into[k] = into.get(k, 0) + n


def distribution(smi, c_true, src0, wkw, flagship_ref):
    """Phases 65-66: the distribution layer (``jets_tpu_torch.parallel``).

    Phase 65, world size 1 on NCCL in this process (``make_block_mesh()``):
    the 3-D flagship's LSQR (50 iterations) with ``mesh=``, x and history
    bitwise phase 3's; configs 4 and 5 with ``mesh=`` through
    ``run_config``, under their thresholds and bitwise phases 42-43; the
    16-shot isotropic int8 multishot gradient at 256^3, nt 220, map mode
    (K4, K5) with and without ``mesh=``, bitwise; VTI and TTI 2-shot map
    multishots at (32, 64, 128), forward and int8 gradient, bitwise; the
    z-slab propagator at 256^3 in one slab, traces bitwise the unsharded K4
    route's, and its int8 gradient against the unsharded K4/K5 one.

    Phase 66, 2 ranks on the one card over gloo (this script run as
    ``--rank r 2 dir``, each a subprocess under a hard time limit): the
    flagship LSQR (8 shots per rank), the replicas' ``tree_hash`` equal and
    x against phase 65's; the z-slab forward in 2 slabs of 128 planes at nt
    220 (host-staged halos), traces bitwise the unsharded K4 run's, and its
    int8 gradient; the 16-shot multishot gradient against phase 65's; ms
    per LSQR iteration, µs per slab step, the all_reduce and halo times,
    and a profiler trace's all_reduce and halo spans. Counts from 0;
    returns the launches, the ranks' included."""
    import os
    import shutil
    import tempfile

    from jets_tpu_torch import BlockVector
    from jets_tpu_torch.models import configs
    from jets_tpu_torch.models.seismic import make_seismic_problem
    from jets_tpu_torch.ops.wave import (multishot_tti_wave_operator,
                                         multishot_vti_wave_operator,
                                         multishot_wave_operator, wave_propagator)
    from jets_tpu_torch.parallel.sharded import block_sharding, make_block_mesh
    from jets_tpu_torch.solvers import lsqr

    dev = c_true.device
    wshape = tuple(c_true.shape)
    t_ph = time.perf_counter()
    launched = {}

    # ---- phase 65: world size 1 on NCCL ------------------------------------------
    mesh = make_block_mesh()
    assert mesh.backend == "nccl" and mesh.shape == {"block": 1}, mesh
    assert mesh.device.type == "cuda", mesh
    grid3, nshots3, nrecv = FLAGSHIP
    _reset_all()
    A, _, d = make_seismic_problem(grid3, nshots3, nrecv, seed=0, noise=0.05, mesh=mesh)
    r = lsqr(A, d, maxiter=50, tol=0.0)
    c = _counts_all()
    assert c == {"xw_update": 50, "laplacian3d": 51}, c
    _add(launched, c)
    assert torch.equal(r.x, flagship_ref[0]), "mesh LSQR x differs from phase 3's"
    assert torch.equal(r.history, flagship_ref[1]), "mesh LSQR history differs from phase 3's"
    x1 = r.x
    ms1 = ms_per_iter(lsqr, A, d, 10, 60)
    msgs = [f"flagship LSQR {grid3} x {nshots3} shots x {nrecv} rcv with mesh {mesh.shape} "
            f"on {mesh.backend} ({mesh.device}): x and history of 50 iterations bitwise "
            f"phase 3's; launches {c}; {ms1:.4f} ms/iter (marginal 10->60, CUDA events)"]
    del A, d, r
    for name, (phase, maxiter, threshold) in MESH_CONFIGS.items():
        _reset_all()
        res, relres, A = configs.run_config(getattr(configs, name), maxiter=maxiter,
                                            tol=1e-10, mesh=mesh)
        it = res.iterations
        c = _counts_all()
        expect = {"xw_update": it, **({"laplacian3d": it + 1} if A.dom.ndim == 3 else {})}
        assert c == expect, f"{name}: launches {c} after {it} iterations"
        _add(launched, c)
        assert relres < threshold, f"{name}: relative residual {relres} >= {threshold}"
        assert torch.equal(res.x, BASELINE_X[name]), f"{name}: x differs from phase {phase}'s"
        msgs.append(f"{name} with mesh: {it} iterations, relative residual {relres:.6e} "
                    f"(< {threshold:g}), x bitwise phase {phase}'s, launches {c}")
        del res, A

    nsh = len(MSRC)
    mkw = dict(nt=220, store_adjoint="int8", shot_map="map", **wkw)
    c_bg = torch.full(wshape, 1500.0, device=dev)
    F1 = multishot_wave_operator(wshape, MSRC, **mkw)
    Fm = multishot_wave_operator(wshape, MSRC, mesh=mesh, **mkw)
    _reset_all()
    d1 = F1(c_true)
    g1 = F1.linearize(c_bg).H(d1)
    n1 = _counts_all()
    _reset_all()
    dm = Fm(c_true)
    gm = Fm.linearize(c_bg).H(dm)
    c = _counts_all()
    assert c == n1 == {"fused_leapfrog_step": 2 * nsh * 220,
                       "fused_adjoint_step": nsh * 220}, (c, n1)
    _add(launched, c)
    live(g1, "multishot gradient")
    assert torch.equal(dm, d1) and torch.equal(gm, g1), "mesh multishot differs"
    DIST_REF["ms_grad"] = g1  # phase 68 holds its block x grid multishot to it
    msgs.append(f"iso multishot {wshape}, {nsh} shots, nt 220, map, int8 gradient at 1500 "
                f"m/s: traces and gradient bitwise with and without mesh; launches {c}")
    del F1, Fm, dm, gm

    sshape = (32, 64, 128)
    assert sshape in VTI_SHAPES and sshape in TTI_SHAPES, "phase 1 did not check K8-K13 here"
    ssrc = int(np.ravel_multi_index((16, 32, 64), sshape))
    skw = dict(nt=24, dt=wkw["dt"], dx=wkw["dx"], freq=wkw["freq"], sponge_width=6,
               rcv_idx=[int(np.ravel_multi_index((16, 32, x), sshape)) for x in range(128)],
               store_adjoint="int8", shot_map="map")
    cs_ = c_true[::8, ::4, ::2].contiguous()
    for name, make, extra in (
            ("VTI", multishot_vti_wave_operator, (0.1, 0.05)),
            ("TTI", multishot_tti_wave_operator, (0.1, 0.05, 0.2, 0.7))):
        runs = []
        for kw in ({}, {"mesh": mesh}):
            F = make(sshape, [ssrc, ssrc + 16], **skw, **kw)
            m = BlockVector((cs_,) + tuple(torch.full(sshape, v, device=dev) for v in extra),
                            F.dom)
            _reset_all()
            dv = F(m)
            gv = F.linearize(m).H(dv)
            runs.append((dv, gv, _counts_all()))
        (d0v, g0v, n0v), (dmv, gmv, nmv) = runs
        assert n0v == nmv and len(n0v) == 3 and all(n > 0 for n in n0v.values()), (n0v, nmv)
        _add(launched, nmv)
        assert torch.equal(dmv, d0v), f"{name} mesh traces differ"
        for i, (a, b) in enumerate(zip(gmv, g0v)):
            live(b, f"{name} gradient block {i}")
            assert torch.equal(a, b), f"{name} mesh gradient block {i} differs"
        msgs.append(f"{name} multishot {sshape}, 2 shots, nt 24, map, int8: traces and "
                    f"{g0v.nblocks} gradient blocks bitwise with and without mesh; launches "
                    f"{nmv}")

    assert SLAB_SHAPES == ((wshape[0] + 2,) + wshape[1:],
                           (wshape[0] // RANKS + 2,) + wshape[1:]), \
        "phase 1 did not check K4 at the halo-extended slabs"
    ws = block_sharding(make_block_mesh(axis="grid"), "grid")
    kw220 = dict(nt=220, src_idx=src0, **wkw)
    _reset_all()
    F0 = wave_propagator(wshape, **kw220)
    Fs = wave_propagator(wshape, wavefield_sharding=ws, **kw220)
    assert Fs.dom.local_shape == wshape
    d0 = F0(c_true)
    ds = Fs(c_true)
    live(d0, "traces")
    assert torch.equal(ds, d0), "one-slab traces differ from the unsharded K4 route's"
    resid = d0 - F0(c_bg)
    g0 = wave_propagator(wshape, store_adjoint="int8", **kw220).linearize(c_true).H(resid)
    gs = wave_propagator(wshape, store_adjoint="int8", wavefield_sharding=ws,
                         **kw220).linearize(c_true).H(resid)
    c = _counts_all()
    assert c == {"fused_leapfrog_step": 5 * 220, "fused_adjoint_step": 220}, c
    _add(launched, c)
    us = {}
    for name, kw in (("unsharded", {}), ("one slab", {"wavefield_sharding": ws})):
        t = {n: min(event_ms(lambda op=op: op(c_true)) for _ in range(3)) for n, op in (
            (n, wave_propagator(wshape, nt=n, src_idx=src0, **wkw, **kw)) for n in (20, 220))}
        us[name] = 1e3 * (t[220] - t[20]) / 200
    # the slab's reverse sweep is the plain one (K5 takes no halo), which is
    # K5's tree; the receiver injection differs only in the sign of a zero
    msgs.append(f"z-slab propagator {wshape} in one slab, nt 220: traces bitwise the "
                "unsharded K4 route's; int8 gradient (forward on K4, plain reverse sweep) vs the "
                "unsharded K4/K5 one " + agree(gs, g0, "gradient", 1e-6) + f"; launches {c}; "
                f"forward {us['one slab']:.1f} us/step in one slab against {us['unsharded']:.1f} "
                "unsharded (marginal nt 20->220, CUDA events, best of 3)")
    log(65, "; ".join(msgs) + f"; phase 65 in {time.perf_counter() - t_ph:.1f} s [{smi}]")
    del F0, Fs, ds, gs

    # ---- phase 66: 2 ranks on the one card over gloo -----------------------------
    t66 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    try:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r), str(RANKS), tmp],
            env={**os.environ, "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
        outs, deadline = [], time.perf_counter() + RANK_TIMEOUT
        try:
            for p in procs:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            print(out, end="", flush=True)
            assert p.returncode == 0, f"phase 66 rank {r} failed (rc {p.returncode})"
        res = []
        for r in range(RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
        assert len({q["x_hash"] for q in res}) == 1, "the model replicas differ across ranks"
        x2 = torch.load(os.path.join(tmp, "x.pt")).to(dev)
        msgs = [f"{RANKS} ranks over gloo ({res[0]['transport']} for the halos) in "
                f"{time.perf_counter() - t66:.1f} s; flagship LSQR 50 iterations, "
                f"{nshots3 // RANKS} shots per rank: replicas' tree_hash equal "
                f"({res[0]['x_hash']:#010x}); x vs phase 65 " + agree(x2, x1, "x", 1e-4)
                + " (the ranks' partial sums add in another order)"]
        for r in range(RANKS):
            tr = torch.load(os.path.join(tmp, f"slab_traces_r{r}.pt")).to(dev)
            assert torch.equal(tr, d0), f"rank {r}'s slab traces differ from the K4 run's"
        gsl = torch.cat([torch.load(os.path.join(tmp, f"slab_grad_r{r}.pt"))
                         for r in range(RANKS)]).to(dev)
        msgs.append(f"z-slab forward {RANKS} x {wshape[0] // RANKS} planes, nt 220: every "
                    "rank's traces bitwise the unsharded K4 run's; int8 gradient vs the "
                    "unsharded K4/K5 one " + agree(gsl, g0, "gradient", 1e-6))
        gm2 = torch.load(os.path.join(tmp, "gm.pt")).to(dev)
        msgs.append(f"{nsh}-shot int8 multishot gradient over {RANKS} ranks vs world size 1 "
                    + agree(gm2, g1, "gradient", 1e-5) + " (the shots' sum in another order)")
        for q in res:
            _add(launched, q["launches"])
        q = res[0]
        msgs.append(
            f"rank 0: {q['ms_per_iter']:.3f} ms per LSQR iteration (marginal 10->30, host "
            f"clock); all_reduce of the {grid3} model {q['allreduce_ms']:.2f} ms; slab step "
            f"{q['us_per_step']:.1f} us (marginal nt 20->220); halo exchange of 1 plane "
            f"each way {q['halo_us']:.1f} us; under the profiler (5 LSQR iterations, 20 "
            f"slab steps): all_reduce {q['prof_allreduce_ms']:.2f} ms in "
            f"{q['prof_allreduce_n']} calls, halo exchange {q['prof_halo_ms']:.2f} ms in "
            f"{q['prof_halo_n']} calls; launches per rank {[q_['launches'] for q_ in res]}")
        log(66, "; ".join(msgs) + f" [{smi}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.distributed.destroy_process_group()  # phase 65's world of one
    return launched


def rank_main(rank, world, tmp):
    """One rank of phase 66: ``python3 chip_smoke.py --rank r world dir``. Joins
    a gloo group of ``world`` ranks on this card through a file in ``dir``,
    runs the flagship LSQR, the z-slab forward and int8 gradient and the
    16-shot multishot gradient with their launches counted, then times
    them, and writes what the parent compares into ``dir``."""
    import os

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from jets_tpu_torch.models.seismic import make_seismic_problem
    from jets_tpu_torch.ops.wave import multishot_wave_operator, wave_propagator
    from jets_tpu_torch.parallel import runner
    from jets_tpu_torch.parallel.collectives import (halo_exchange, halo_transport,
                                                     sum_replicated)
    from jets_tpu_torch.parallel.sharded import block_sharding, make_block_mesh, shard_blocks
    from jets_tpu_torch.solvers import lsqr
    from jets_tpu_torch.utils import hashing

    t0 = time.perf_counter()
    runner.init_distributed("gloo", device="cuda",
                            init_method="file://" + os.path.join(tmp, "store"), rank=rank,
                            world_size=world, timeout=RANK_TIMEOUT / 2)
    mesh = make_block_mesh(device="cuda")
    mesh_g = make_block_mesh(axis="grid", device="cuda")
    assert mesh.backend == "gloo" and mesh.size == world, mesh
    dev = mesh.device
    out = {"transport": halo_transport(mesh)}
    _reset_all()

    grid3, nshots3, nrecv = FLAGSHIP
    A, _, d = make_seismic_problem(grid3, nshots3, nrecv, seed=0, noise=0.05, mesh=mesh)
    assert tuple(d.shape) == (nshots3 // world, nrecv)
    r = lsqr(A, d, maxiter=50, tol=0.0)
    out["x_hash"] = hashing.tree_hash(r.x)
    if rank == 0:
        torch.save(r.x.cpu(), os.path.join(tmp, "x.pt"))

    c_true, src0, wkw, _ = wave_model(dev)
    wshape = tuple(c_true.shape)
    ws = block_sharding(mesh_g, "grid")
    c_l = shard_blocks(c_true, mesh_g, "grid")
    bg_l = torch.full_like(c_l, 1500.0)
    Fs = wave_propagator(wshape, nt=220, src_idx=src0, wavefield_sharding=ws, **wkw)
    ds = Fs(c_l)
    torch.save(ds.cpu(), os.path.join(tmp, f"slab_traces_r{rank}.pt"))
    Gs = wave_propagator(wshape, nt=220, src_idx=src0, store_adjoint="int8",
                         wavefield_sharding=ws, **wkw)
    gs = Gs.linearize(c_l).H(ds - Fs(bg_l))
    torch.save(gs.cpu(), os.path.join(tmp, f"slab_grad_r{rank}.pt"))

    Fm = multishot_wave_operator(wshape, MSRC, nt=220, store_adjoint="int8", shot_map="map",
                                 mesh=mesh, **wkw)
    gm = Fm.linearize(torch.full(wshape, 1500.0, device=dev)).H(Fm(c_true))
    if rank == 0:
        torch.save(gm.cpu(), os.path.join(tmp, "gm.pt"))
    out["launches"] = _counts_all()
    del Gs, gs, Fm, gm
    print(f"[phase 66 rank {rank}/{world}] main path done in {time.perf_counter() - t0:.1f} s "
          f"(start-up included) on {dev}: launches {out['launches']}", flush=True)

    t = {n: _wall_ms(lambda n=n: lsqr(A, d, maxiter=n, tol=0.0), mesh) for n in (10, 30)}
    out["ms_per_iter"] = (t[30] - t[10]) / 20
    x = torch.ones(grid3, device=dev)
    out["allreduce_ms"] = _wall_ms(lambda: [sum_replicated(x, mesh) for _ in range(5)],
                                   mesh) / 5
    Fs20 = wave_propagator(wshape, nt=20, src_idx=src0, wavefield_sharding=ws, **wkw)
    t = {n: _wall_ms(lambda op=op: op(c_l), mesh)
         for n, op in ((20, Fs20), (220, Fs))}
    out["us_per_step"] = 1e3 * (t[220] - t[20]) / 200
    out["halo_us"] = 1e3 * _wall_ms(lambda: [halo_exchange(c_l, 1, mesh_g)
                                             for _ in range(50)], mesh) / 50
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lsqr(A, d, maxiter=5, tol=0.0)
        Fs20(c_l)
        torch.cuda.synchronize()
    spans = {"allreduce": [0.0, 0], "halo": [0.0, 0]}
    for e in prof.key_averages():
        key = ("allreduce" if "all_reduce" in e.key else
               "halo" if "halo_exchange" in e.key else None)
        if key:
            spans[key][0] += e.cpu_time_total / 1e3
            spans[key][1] += e.count
    for key, (ms, n) in spans.items():
        out[f"prof_{key}_ms"], out[f"prof_{key}_n"] = ms, n
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


# Phases 67-68: the block x grid mesh. The wave checks' shardings (phase 67
# on the (1, 1) mesh; phase 68 runs the pencil), the physics with their model
# blocks beyond c, the 4 ranks of phase 68 as a (2, 2) mesh and their hard
# limit (seconds; every collective of their group has half of it).
SPECS67 = {"P(grid)": ("grid",), "P(None, grid)": (None, "grid"),
           "P(block, grid)": ("block", "grid")}
PHYSICS = {"iso": (), "VTI": (0.1, 0.05), "TTI": (0.1, 0.05, 0.2, 0.7)}
MESH68, RANK68_TIMEOUT = (2, 2), 600.0
# config 5's x is compared across meshes after this many iterations: in
# float32 its LSQR reaches the noise floor by then, and later iterates drift
# by roundoff (shots split over 4 ranks alone move x by a relative 6 at 30
# iterations on the CPU, with the same residual)
CONFIG5_EARLY = 10


def _physics_model(name, F, c):
    """The model of ``name`` on ``F``'s domain: ``c`` (a slab under a
    sharding) and the constant blocks of :data:`PHYSICS`."""
    from jets_tpu_torch import BlockVector

    if name == "iso":
        return c
    return BlockVector((c,) + tuple(torch.full_like(c, v) for v in PHYSICS[name]), F.dom)


def _grid_space(F):
    """The grid space of a propagator: its domain, or its first block's."""
    return F.dom if F.dom.__class__.__name__ != "BlockSpace" else F.dom.subspace(0)


def _make(name):
    from jets_tpu_torch.ops.wave import (tti_wave_propagator, vti_wave_propagator,
                                         wave_propagator)

    return {"iso": wave_propagator, "VTI": vti_wave_propagator,
            "TTI": tti_wave_propagator}[name]


def _dcp_tree(A, state):
    """The LSQR state with its sharded leaves as DTensors of their global
    arrays (the layout a checkpoint writes and loads)."""
    return state._replace(x=A.dom.to_dtensor(state.x), v=A.dom.to_dtensor(state.v),
                          w=A.dom.to_dtensor(state.w), u=A.rng.to_dtensor(state.u))


def block_by_grid(smi, c_true, src0, wkw, flagship_ref):
    """Phases 67-68: the block x grid mesh (``parallel.gspmd``).

    Phase 67, world size 1 on NCCL in this process (``make_mesh_2d(1, 1)``):
    the 3-D flagship's LSQR (50 iterations) with the grid-sharded model, x
    and history bitwise phase 3's, and a DCP round trip of its LSQR state
    (DTensor leaves) bitwise; configs 4 and 5 with ``mesh=`` bitwise phases
    42-43; iso, VTI and TTI at 256^3, nt 220, under P(grid), P(None, grid)
    and P(block, grid): traces and int8 gradients (every block) bitwise the
    unsharded plain route (K4 is bitwise the plain step, so the P(grid)
    slab on K4 is held to it too).

    Phase 68, 4 gloo ranks on the one card as a (2, 2) mesh (this script run
    as ``--rank2d r 4 dir``, each a subprocess under a hard time limit):
    config 5 at its defaults under its threshold and at phase 67's residual,
    and its x after 10 iterations against phase 67's;
    the flagship's LSQR with ms per iteration and x against phase 67's;
    iso, VTI and TTI at 256^3 under the pencil P(block, grid): traces and
    int8 gradients against phase 67's unsharded plain route; the 16-shot
    iso block x grid multishot gradient against phase 65's; the LSQR state
    written by the 4 ranks as a DCP checkpoint and reloaded here, bitwise
    the ranks' gathered state; us per pencil step, halo time per dimension,
    all-reduce time per group, peak memory per rank. Counts from 0; returns
    the launches, the ranks' included."""
    import os
    import shutil
    import tempfile

    from jets_tpu_torch.models import configs
    from jets_tpu_torch.models.seismic import make_seismic_problem
    from jets_tpu_torch.parallel.gspmd import make_mesh_2d
    from jets_tpu_torch.parallel.sharded import BlockSharding, ShardedSpace
    from jets_tpu_torch.solvers import lsqr
    from jets_tpu_torch.solvers.krylov import LSQRState
    from jets_tpu_torch.utils import load_checkpoint_orbax, save_checkpoint_orbax

    dev = c_true.device
    wshape = tuple(c_true.shape)
    t_ph = time.perf_counter()
    launched = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_block_grid_")
    try:
        # ---- phase 67: world size 1 on NCCL, the (1, 1) block x grid mesh --------
        mesh2 = make_mesh_2d(1, 1)
        assert mesh2.backend == "nccl" and mesh2.shape == {"block": 1, "grid": 1}, mesh2
        grid3, nshots3, nrecv = FLAGSHIP
        _reset_all()
        A, _, d = make_seismic_problem(grid3, nshots3, nrecv, seed=0, noise=0.05, mesh=mesh2)
        assert isinstance(A.dom, ShardedSpace) and A.dom.spec == ("grid",), A.dom
        r = lsqr(A, d, maxiter=50, tol=0.0)
        c = _counts_all()
        assert c == {"xw_update": 50, "laplacian3d": 51}, c
        _add(launched, c)
        assert torch.equal(r.x, flagship_ref[0]), "block x grid LSQR x differs from phase 3's"
        assert torch.equal(r.history, flagship_ref[1]), "... history differs from phase 3's"
        x67 = r.x
        relres67 = {}
        ms67 = ms_per_iter(lsqr, A, d, 10, 60)
        ck = os.path.join(tmp, "state67")
        save_checkpoint_orbax(ck, _dcp_tree(A, r.state))
        like = lsqr(A, d, maxiter=1, tol=0.0).state
        back = load_checkpoint_orbax(ck, _dcp_tree(A, like))
        for k in ("x", "v", "w", "u"):
            sp = A.rng if k == "u" else A.dom
            assert torch.equal(sp.from_dtensor(getattr(back, k)), getattr(r.state, k)), k
        for k in ("alpha", "phibar", "rhobar"):
            assert torch.equal(getattr(back, k).to(dev), getattr(r.state, k)), k
        assert back.i == r.state.i == 50
        msgs = [f"flagship LSQR {grid3} x {nshots3} shots x {nrecv} rcv on mesh "
                f"{mesh2.shape} ({mesh2.backend}, model sharded over grid): x and history of "
                f"50 iterations bitwise phase 3's; launches {c}; {ms67:.4f} ms/iter (marginal "
                "10->60, CUDA events); its LSQR state through a DCP checkpoint (DTensor "
                "leaves) bitwise"]
        del A, d, r, like, back
        for name, (phase, maxiter, threshold) in MESH_CONFIGS.items():
            _reset_all()
            res, relres, A = configs.run_config(getattr(configs, name), maxiter=maxiter,
                                                tol=1e-10, mesh=mesh2)
            it = res.iterations
            c = _counts_all()
            expect = {"xw_update": it,
                      **({"laplacian3d": it + 1} if A.dom.ndim == 3 else {})}
            assert c == expect, f"{name}: launches {c} after {it} iterations"
            _add(launched, c)
            assert relres < threshold, f"{name}: relative residual {relres} >= {threshold}"
            assert torch.equal(res.x, BASELINE_X[name]), f"{name}: x differs from phase {phase}'s"
            msgs.append(f"{name} on mesh {mesh2.shape}: {it} iterations, relative residual "
                        f"{relres:.6e} (< {threshold:g}), x bitwise phase {phase}'s, launches {c}")
            relres67[name] = relres
            del res, A
        _reset_all()
        x10 = configs.run_config(configs.config5_seismic3d_pod, maxiter=CONFIG5_EARLY,
                                 tol=1e-10, mesh=mesh2)[0].x
        _add(launched, _counts_all())
        wkw220 = dict(nt=220, src_idx=src0, **wkw)
        refs = {}
        for name in PHYSICS:
            make = _make(name)
            _reset_all()
            F0 = make(wshape, fused=False, **wkw220)
            m = _physics_model(name, F0, c_true)
            d0 = F0(m)
            live(d0, f"{name} traces")
            g0 = make(wshape, fused=False, store_adjoint="int8", **wkw220).linearize(m).H(d0)
            assert _counts_all() == {}, f"{name} plain route launched {_counts_all()}"
            torch.save(d0.cpu(), os.path.join(tmp, f"dd_{name}.pt"))
            refs[name] = (d0.cpu(), [b.cpu() for b in _blocks(g0)])
            del F0, g0
            for sname, spec in SPECS67.items():
                ws = BlockSharding(mesh2, spec)
                _reset_all()
                Fs = make(wshape, wavefield_sharding=ws, **wkw220)
                ms = _physics_model(name, Fs, c_true)
                ds = Fs(ms)
                gs = make(wshape, wavefield_sharding=ws, store_adjoint="int8",
                          **wkw220).linearize(ms).H(d0)
                c = _counts_all()
                k4 = name == "iso" and spec == ("grid",)
                assert c == ({"fused_leapfrog_step": 2 * 220} if k4 else {}), (name, sname, c)
                _add(launched, c)
                assert torch.equal(ds, d0), f"{name} {sname}: traces not bitwise"
                for i, (a, b) in enumerate(zip(_blocks(gs), refs[name][1])):
                    assert torch.equal(a.cpu(), b), f"{name} {sname}: gradient[{i}] not bitwise"
                del Fs, ms, ds, gs
            msgs.append(f"{name} {wshape}, nt 220, under {', '.join(SPECS67)}: traces and "
                        f"{len(refs[name][1])} int8 gradient block(s) bitwise the unsharded "
                        "plain route" + (" (P(grid) on K4: 440 launches)" if name == "iso"
                                         else ""))
            del d0
        log(67, "; ".join(msgs) + f"; phase 67 in {time.perf_counter() - t_ph:.1f} s "
                f"[{smi}]")

        # ---- phase 68: 4 ranks on the one card over gloo, a (2, 2) mesh -----------
        t68 = time.perf_counter()
        world = MESH68[0] * MESH68[1]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank2d", str(r), str(world), tmp],
            env={**os.environ, "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        outs, deadline = [], time.perf_counter() + RANK68_TIMEOUT
        try:
            for p in procs:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            print(out, end="", flush=True)
            assert p.returncode == 0, f"phase 68 rank {r} failed (rc {p.returncode})"
        res = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank2d_{r}.json")) as f:
                res.append(json.load(f))
        q = res[0]
        load = lambda n: torch.load(os.path.join(tmp, n))  # noqa: E731
        x5 = load("x5.pt").to(dev)
        name5 = "config5_seismic3d_pod"
        thr5 = MESH_CONFIGS[name5][2]
        assert q["relres5"] < thr5, f"config 5 on (2, 2): relative residual {q['relres5']}"
        drift = abs(q["relres5"] - relres67[name5]) / relres67[name5]
        assert drift <= 1e-3, f"config 5 relative residual {q['relres5']} vs {relres67[name5]}"
        msgs = [f"{world} ranks over gloo as a {MESH68} mesh ({q['transport']} for the halos) "
                f"in {time.perf_counter() - t68:.1f} s; config 5 at its defaults: "
                f"{q['it5']} iterations, relative residual {q['relres5']:.6e} (< {thr5:g}; "
                f"phase 67's {relres67[name5]:.6e}, rel diff {drift:.2e} <= 1e-3); x after "
                f"{CONFIG5_EARLY} iterations vs phase 67's " + agree(x5, x10, "x", 1e-5)
                + " (the ranks' partial sums add in another order; later float32 iterates "
                "sit at the noise floor and drift by roundoff, so x is held there)"]
        x68 = load("x.pt").to(dev)
        msgs.append(f"flagship LSQR 50 iterations, {nshots3 // MESH68[0]} shots and "
                    f"{grid3[0] // MESH68[1]} planes per rank: x vs phase 67's "
                    + agree(x68, x67, "x", 1e-4) + f"; {q['ms_per_iter']:.3f} ms per LSQR "
                    "iteration (rank 0, marginal 10->30, host clock)")
        gathered = load("state68.pt")
        zero = {k: torch.zeros_like(v) for k, v in gathered.items() if k != "i"}
        back = load_checkpoint_orbax(os.path.join(tmp, "state68"),
                                     LSQRState(**zero, i=0))
        for k, v in gathered.items():
            got = getattr(back, k)
            assert (got == v) if k == "i" else torch.equal(got, v), f"DCP state {k} differs"
        msgs.append("the LSQR state the 4 ranks wrote (DCP, each its slabs) reloaded in a "
                    "world of one: every leaf bitwise the ranks' gathered state")
        nb, ng = MESH68
        for name in PHYSICS:
            d0, g0 = refs[name]
            for r in range(world):
                tr = load(f"traces_{name}_{r}.pt")
                assert torch.equal(tr, d0), f"rank {r}'s {name} pencil traces differ"
            gs = [torch.zeros_like(b) for b in g0]
            for r in range(world):
                zb, yb = r // ng, r % ng
                D, H = wshape[0] // nb, wshape[1] // ng
                for b, slab in zip(gs, load(f"grad_{name}_{r}.pt")):
                    b[zb * D:(zb + 1) * D, yb * H:(yb + 1) * H] = slab
            msgs.append(f"{name} under the pencil P(block, grid), nt 220: every rank's traces "
                        "bitwise the unsharded plain route's; int8 gradient "
                        + ", ".join(same(a, b, f"block {i}")
                                    for i, (a, b) in enumerate(zip(gs, g0))))
        gm = load("gm.pt").to(dev)
        msgs.append(f"{len(MSRC)}-shot int8 multishot gradient, shots over block and "
                    "each shot's wavefield over grid (K4 on the z-slabs), vs phase 65's "
                    + agree(gm, DIST_REF["ms_grad"], "gradient", 1e-5)
                    + " (the shots' sum in another order, the reverse sweep plain)")
        for q_ in res:
            _add(launched, q_["launches"])
        msgs.append(
            "rank 0: us per pencil step (marginal nt 20->120, host clock) "
            + ", ".join(f"{k} {v:.1f}" for k, v in q["us_per_step"].items())
            + "; halo exchange of 1 plane each way " + ", ".join(
                f"dim {k} {v:.1f} us" for k, v in q["halo_us"].items())
            + "; all_reduce of the flagship model slab " + ", ".join(
                f"over {k} {v:.2f} ms" for k, v in q["allreduce_ms"].items())
            + "; peak device memory per rank " + ", ".join(
                f"{q_['peak_gib']:.2f}" for q_ in res) + " GiB; launches per rank "
            + str([q_["launches"] for q_ in res]))
        log(68, "; ".join(msgs) + f" [{smi}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.distributed.destroy_process_group()  # phase 67's world of one
    return launched


def rank2d_main(rank, world, tmp):
    """One rank of phase 68: ``python3 chip_smoke.py --rank2d r world dir``.
    Joins a gloo group of ``world`` ranks on this card through a file in
    ``dir``, makes the (2, 2) block x grid mesh, runs config 5, the flagship
    LSQR (its state written as a DCP checkpoint), iso, VTI and TTI under the
    pencil and the 16-shot multishot gradient with their launches counted,
    then times them, and writes what the parent compares into ``dir``."""
    import os

    import torch.distributed as dist

    from jets_tpu_torch.models import configs
    from jets_tpu_torch.models.seismic import make_seismic_problem
    from jets_tpu_torch.ops.wave import multishot_wave_operator
    from jets_tpu_torch.parallel import runner
    from jets_tpu_torch.parallel.collectives import (gather_blocks, halo_exchange,
                                                     halo_transport, sum_replicated)
    from jets_tpu_torch.parallel.gspmd import make_mesh_2d, shard_model
    from jets_tpu_torch.parallel.sharded import BlockSharding
    from jets_tpu_torch.solvers import lsqr
    from jets_tpu_torch.utils import save_checkpoint_orbax

    t0 = time.perf_counter()
    runner.init_distributed("gloo", device="cuda",
                            init_method="file://" + os.path.join(tmp, "store2d"), rank=rank,
                            world_size=world, timeout=RANK68_TIMEOUT / 2)
    mesh2 = make_mesh_2d(*MESH68, device="cuda")
    assert mesh2.backend == "gloo" and mesh2.size == world, mesh2
    dev = mesh2.device
    out = {"transport": halo_transport(mesh2)}
    save = lambda t, n: torch.save(t, os.path.join(tmp, n))  # noqa: E731
    _reset_all()

    res, relres, A5 = configs.run_config(configs.config5_seismic3d_pod,
                                         maxiter=MESH_CONFIGS["config5_seismic3d_pod"][1],
                                         tol=1e-10, mesh=mesh2)
    out["relres5"], out["it5"] = relres, int(res.iterations)
    res = configs.run_config(configs.config5_seismic3d_pod, maxiter=CONFIG5_EARLY, tol=1e-10,
                             mesh=mesh2)[0]
    x5 = gather_blocks(res.x, A5.dom.shape[0], mesh2, "grid")
    if rank == 0:
        save(x5.cpu(), "x5.pt")
    del res, A5, x5

    grid3, nshots3, nrecv = FLAGSHIP
    A, _, d = make_seismic_problem(grid3, nshots3, nrecv, seed=0, noise=0.05, mesh=mesh2)
    r = lsqr(A, d, maxiter=50, tol=0.0)
    st = r.state
    save_checkpoint_orbax(os.path.join(tmp, "state68"), _dcp_tree(A, st))
    full = {k: gather_blocks(getattr(st, k), grid3[0], mesh2, "grid").cpu()
            for k in ("x", "v", "w")}
    full["u"] = gather_blocks(st.u, nshots3, mesh2, "block").cpu()
    full.update({k: getattr(st, k).cpu() for k in ("alpha", "phibar", "rhobar")})
    if rank == 0:
        save(full["x"], "x.pt")
        save({**full, "i": st.i}, "state68.pt")
    del full

    c_true, src0, wkw, _ = wave_model(dev)
    wshape = tuple(c_true.shape)
    ws = BlockSharding(mesh2, ("block", "grid"))
    for name in PHYSICS:
        make = _make(name)
        Fs = make(wshape, nt=220, src_idx=src0, wavefield_sharding=ws, **wkw)
        m = _physics_model(name, Fs, _grid_space(Fs).local(c_true).contiguous())
        save(Fs(m).cpu(), f"traces_{name}_{rank}.pt")
        dd = torch.load(os.path.join(tmp, f"dd_{name}.pt")).to(dev)
        g = make(wshape, nt=220, src_idx=src0, wavefield_sharding=ws, store_adjoint="int8",
                 **wkw).linearize(m).H(dd)
        save([b.cpu() for b in _blocks(g)], f"grad_{name}_{rank}.pt")
        del Fs, m, g

    Fm = multishot_wave_operator(wshape, MSRC, nt=220, store_adjoint="int8", mesh=mesh2,
                                 **wkw)
    c_l = shard_model(c_true, mesh2)
    gm = Fm.linearize(torch.full_like(c_l, 1500.0)).H(Fm(c_l))
    gm = gather_blocks(gm, wshape[0], mesh2, "grid")
    if rank == 0:
        save(gm.cpu(), "gm.pt")
    del Fm, gm
    out["launches"] = _counts_all()
    print(f"[phase 68 rank {rank}/{world}] main path done in {time.perf_counter() - t0:.1f} "
          f"s (start-up included) on {dev}: launches {out['launches']}", flush=True)

    t = {n: _wall_ms(lambda n=n: lsqr(A, d, maxiter=n, tol=0.0), mesh2) for n in (10, 30)}
    out["ms_per_iter"] = (t[30] - t[10]) / 20
    out["us_per_step"] = {}
    for name in PHYSICS:
        ops = {n: _make(name)(wshape, nt=n, src_idx=src0, wavefield_sharding=ws, **wkw)
               for n in (20, 120)}
        m = _physics_model(name, ops[20], _grid_space(ops[20]).local(c_true).contiguous())
        t = {n: _wall_ms(lambda op=op: op(m), mesh2) for n, op in ops.items()}
        out["us_per_step"][name] = 1e3 * (t[120] - t[20]) / 100
    slab = torch.ones((wshape[0] // MESH68[0], wshape[1] // MESH68[1], wshape[2]),
                      device=dev)
    out["halo_us"] = {d_: 1e3 * _wall_ms(lambda d_=d_, a=a: [
        halo_exchange(slab, 1, mesh2, d_, a) for _ in range(50)], mesh2) / 50
        for d_, a in ((0, "block"), (1, "grid"))}
    groups = {"block": "block", "grid": "grid", "block x grid": ("block", "grid")}
    out["allreduce_ms"] = {k: _wall_ms(lambda a=a: [sum_replicated(A.dom.zeros(), mesh2, a)
                                                    for _ in range(5)], mesh2) / 5
                           for k, a in groups.items()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(tmp, f"rank2d_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def wave_model(dev):
    """The wave paths' 256^3 model and geometry: ``c_true``, 1500 m/s plus
    four smooth Gaussian anomalies drawn from a numpy seed; the source at
    the centre; ``wkw``, the propagators' shared keywords with 128 receivers
    on the x-line through it; and the seeded generator, for later draws."""
    wshape = ISO_SHAPES[0]
    rs = np.random.default_rng(0)
    axis = torch.arange(256, dtype=torch.float32, device=dev)
    c_true = torch.full(wshape, 1500.0, device=dev)
    for _ in range(4):
        (cz, cy, cx), a, sig = rs.uniform(48, 208, 3), rs.uniform(-80, 80), rs.uniform(12, 32)
        gz, gy, gx = (torch.exp(-0.5 * ((axis - float(o)) / sig) ** 2) for o in (cz, cy, cx))
        c_true += a * (gz[:, None, None] * gy[None, :, None] * gx[None, None, :])
    rcv = [int(np.ravel_multi_index((128, 128, x), wshape)) for x in range(0, 256, 2)]
    src0 = int(np.ravel_multi_index((128, 128, 128), wshape))
    return c_true, src0, dict(dt=5e-4, dx=10.0, freq=15.0, rcv_idx=rcv, sponge_width=12), rs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    from jets_tpu_torch import dot_product_test, kernels
    from jets_tpu_torch.models.seismic import (
        make_seismic_problem,
        seismic_operator_from_arrays,
    )
    from jets_tpu_torch.ops import cuda_solver as cs
    from jets_tpu_torch.ops import cuda_tti as ct
    from jets_tpu_torch.ops import cuda_vti as cv
    from jets_tpu_torch.ops import cuda_wave as cw
    from jets_tpu_torch.solvers import lsqr

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    # ---- phase 0: environment and kernel build -------------------------------
    t0 = time.perf_counter()
    kernels.build_all()  # one nvcc per source, started together
    for name in kernels.SOURCES:
        kernels.load_library(name)
    build_s = time.perf_counter() - t0
    log(0, f"python {sys.version.split()[0]} torch {torch.__version__} "
           f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
           f"count {torch.cuda.device_count()} | nvidia-smi: {smi} | "
           f"kernel build+load {build_s:.2f} s (nvcc {kernels.build_seconds})")
    ptx = {}  # (kernel template, order) -> (max registers, spill bytes, static smem)
    for name in kernels.SOURCES:
        text = kernels.nvcc_log(name)
        # ptxas -v: each "Compiling entry function" line is followed by its
        # stack/spill line and its register line; one line per kernel
        # template and order: the registers over its instantiations (store
        # and coefficient types) and their spill bytes
        fn, regs, spills, smem = None, {}, {}, {}
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = kernel_of(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                regs.setdefault(fn, []).append(int(m.group(1)))
                m = re.search(r"(\d+) bytes smem", line)
                smem[fn] = max(smem.get(fn, 0), int(m.group(1)) if m else 0)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn:
                spills[fn] = spills.get(fn, 0) + int(m.group(1)) + int(m.group(2))
        for (base, order), r in sorted(regs.items()):
            ptx[base, order] = (max(r), spills.get((base, order), 0), smem[base, order])
            log(0, f"{name}: {base}" + (f" order {order}" if order else "")
                   + f": {len(r)} instantiation(s), registers {min(r)}-{max(r)}, "
                   f"spill bytes {spills.get((base, order), 0)}")

    # ---- phase 1: each kernel against its plain version ----------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev)

    scal = [torch.tensor(v, device=dev) for v in (0.37, -0.21, 1.7)]
    err = {"xw_update": 0.0, "lap3d_axpy_norm2": 0.0, "laplacian3d": 0.0}
    for shape, off in SOLVER_SHAPES:
        x, w, vh = (rnd(shape)[off:] for _ in range(3))
        xp, wp = cs.xw_update_torch(x.clone(), w.clone(), vh, *scal)
        xk, wk = x.clone(), w.clone()
        px, pw = xk.data_ptr(), wk.data_ptr()
        ro, rw = cs.xw_update(xk, wk, vh, *scal)
        torch.cuda.synchronize()
        assert ro.data_ptr() == px and rw.data_ptr() == pw, "K1 not in place"
        assert torch.equal(xk, xp) and torch.equal(wk, wp), f"K1 not bitwise at {shape}"
        err["xw_update"] = max(err["xw_update"], float((xk - xp).abs().max()),
                               float((wk - wp).abs().max()))
    # K3 at config 5's grid, the extended slabs of phases 67-68, then the
    # flagship's grid (whose z is kept for K2)
    for shape in ((128, 128, 64),) + K3_SLABS + ((256, 256, 256),):
        z = rnd(shape)
        lap_k, lap_p = cs.laplacian3d(z), cs.laplacian3d_torch(z)
        torch.cuda.synchronize()
        assert torch.equal(lap_k, lap_p), f"K3 not bitwise at {shape}"
        err["laplacian3d"] = max(err["laplacian3d"], float((lap_k - lap_p).abs().max()))
    v = rnd((256, 256, 256))
    s = torch.tensor(-0.43, device=dev)
    vh_k, n2_k = cs.lap3d_axpy_norm2(z, v, s)
    vh_p, _ = cs.lap3d_axpy_norm2_torch(z, v, s)
    torch.cuda.synchronize()
    assert torch.equal(vh_k, vh_p), "K2 vh not bitwise"
    err["lap3d_axpy_norm2"] = float((vh_k - vh_p).abs().max())
    n2_ref = float(torch.sum(vh_p.double() ** 2))
    n2_rel = abs(float(n2_k) - n2_ref) / n2_ref
    assert n2_rel <= 1e-5, f"K2 n2 rel err {n2_rel}"
    log(1, f"K1 bitwise at {SOLVER_SHAPES_TEXT} (in place); "
           f"K3 bitwise at 128x128x64, {shapes_text(K3_SLABS)} and 256^3; K2 vh bitwise, n2 rel err {n2_rel:.3e} vs f64 "
           f"(<= 1e-5); max_abs_err {err}")
    del x, w, vh, xp, wp, xk, wk, ro, rw, lap_k, lap_p, vh_k, vh_p

    # K4 and K5 at every shape of ISO_SHAPES, every order and history type,
    # bitwise against the plain versions, and in place; the 256^3 fields stay
    # for the timings of phase 12
    def sponges(shape):
        return tuple(torch.linspace(lo, 1.0, n, device=dev)
                     for lo, n in zip((0.9, 0.8, 0.7), shape))

    def centre(shape):
        return int(np.ravel_multi_index(tuple(n // 2 for n in shape), shape))

    def iso_kernels_check(up, u, a1, a2, g2, c2, spz, spy, spx, src):
        """K4 and K5 against their plain versions; returns the histories of u."""
        shape = tuple(u.shape)
        for order in (2, 4, 8):
            ref = cw.fused_leapfrog_step_torch(up, u, c2, spz, spy, spx, s_t, src, amp,
                                               order=order)
            upk = up.clone()
            out = cw.fused_leapfrog_step(upk, u, c2, spz, spy, spx, s_t, src, amp,
                                         order=order, out=upk)
            torch.cuda.synchronize()
            assert out.data_ptr() == upk.data_ptr(), "K4 not in place"
            assert torch.equal(out, ref), f"K4 not bitwise at order {order}, {shape}"
            err["fused_leapfrog_step"] = max(err["fused_leapfrog_step"],
                                             float((out - ref).abs().max()))
        smax = u.abs().amax()
        hists = {
            "f32": (u, torch.tensor(1.0, device=dev)),
            "bf16": (u.to(torch.bfloat16), torch.tensor(1.0, device=dev)),
            "int8": (torch.round(u * (torch.full_like(smax, 127.0) / smax)).to(torch.int8),
                     smax / torch.full_like(smax, 127.0)),
        }
        for store, (q, sc) in hists.items():
            for order in (2, 4, 8):
                core_r, g_r = cw.fused_adjoint_step_torch(a1, a2, g2, c2, q, sc, spz, spy,
                                                          spx, order=order)
                a2k, g2k = a2.clone(), g2.clone()
                core, gk = cw.fused_adjoint_step(a1, a2k, g2k, c2, q, sc, spz, spy, spx,
                                                 order=order, inplace=True)
                torch.cuda.synchronize()
                assert core.data_ptr() == a2k.data_ptr() and \
                    gk.data_ptr() == g2k.data_ptr(), "K5 not in place"
                assert torch.equal(core, core_r) and torch.equal(gk, g_r), \
                    f"K5 not bitwise ({store}, order {order}, {shape})"
                err["fused_adjoint_step"] = max(err["fused_adjoint_step"],
                                                float((core - core_r).abs().max()),
                                                float((gk - g_r).abs().max()))
        return hists

    wshape = ISO_SHAPES[0]
    up, u, a1, a2, g2 = (rnd(wshape) for _ in range(5))
    c2 = 0.3 * torch.rand(wshape, generator=gen, device=dev)
    spz, spy, spx = sponges(wshape)
    s_t, amp = torch.tensor(0.37, device=dev), torch.tensor(2.5e-7, device=dev)
    src_flat = centre(wshape)
    err["fused_leapfrog_step"] = err["fused_adjoint_step"] = 0.0
    hists = iso_kernels_check(up, u, a1, a2, g2, c2, spz, spy, spx, src_flat)
    for shape in ISO_SHAPES[1:]:
        for src in (centre(shape),) + ((-1,) if shape in SLAB_SHAPES else ()):
            iso_kernels_check(*(rnd(shape) for _ in range(5)),
                              0.3 * torch.rand(shape, generator=gen, device=dev),
                              *sponges(shape), src)
    log(1, f"K4 bitwise and in place at {shapes_text(ISO_SHAPES)}, orders 2/4/8 (at "
           f"{shapes_text(SLAB_SHAPES)} also with no source, -1); K5 bitwise and in place "
           f"at the same shapes with f32/bf16/int8 histories, orders 2/4/8")

    # K8, K9 and K10 at every shape of VTI_SHAPES, every order and history
    # type, bitwise against the plain versions, in place; fields from a numpy
    # seed, with C = c²dt², ah = 1+2ε and av = √(1+2δ) from physical (c, ε, δ)
    rk = np.random.default_rng(7)

    def npf(draw, shape=wshape):
        return torch.from_numpy(draw(shape).astype(np.float32)).to(dev)

    def vti_coeffs(shape):
        """(C, ah, av) of random physical (c, eps, delta)."""
        c = npf(lambda n: rk.uniform(1400.0, 4500.0, n), shape)
        return ((c * c) * (5e-4 * 5e-4),
                1.0 + 2.0 * npf(lambda n: rk.uniform(0.0, 0.3, n), shape),
                torch.sqrt(1.0 + 2.0 * npf(lambda n: rk.uniform(-0.1, 0.2, n), shape)))

    def scalings(p, q):
        """The history's quantisation factors and decode scales per store type."""
        sc, one = torch.stack([p.abs().amax(), q.abs().amax()]), torch.ones(2, device=dev)
        return ({"f32": one, "bf16": one, "int8": torch.full_like(sc, 127.0) / sc},
                {"f32": one, "bf16": one, "int8": sc / torch.full_like(sc, 127.0)})

    vpp, vp, vqp, vq, ap1, aq1, ap2, aq2, vgC, vgah, vgav = (
        npf(rk.standard_normal) for _ in range(11))
    vC, vah, vav = vti_coeffs(wshape)
    idx2 = torch.tensor(1.0 / (10.0 * 10.0), device=dev)
    vst = torch.tensor(-0.37, device=dev)  # a negative sample: s_t·0 is -0.0
    vkw = dict(C=vC, ah=vah, av=vav, spz=spz, sy=spy, sx=spx, inv_dx2=idx2, s_t=vst,
               src_idx=src_flat, amp=amp)
    vqf, vdec = scalings(vp, vq)
    for k in ("fused_vti_step", "fused_vti_hist_step", "fused_vti_adjoint_step"):
        err[k] = 0.0

    def maxerr(name, got, ref):
        err[name] = max(err[name], *(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(got, ref)))

    def vti_kernels_check(pp, p, qp, q, ap1, aq1, ap2, aq2, gC, gah, gav, kw, qfs, decs):
        """K8-K10 against their plain versions; returns K9's history codes per
        store type."""
        shape, hist = tuple(p.shape), {}
        for order in (2, 4, 8):
            ref = cv.fused_vti_step_torch(pp, p, qp, q, order=order, **kw)
            o = (pp.clone(), qp.clone())
            got = cv.fused_vti_step(o[0], p, o[1], q, order=order, out=o, **kw)
            torch.cuda.synchronize()
            assert got[0] is o[0] and got[1] is o[1], "K8 not in place"
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
                f"K8 not bitwise, order {order}, {shape}"
            maxerr("fused_vti_step", got, ref)
            for store in ("f32", "bf16", "int8"):
                qf = qfs[store]
                ref = cv.fused_vti_hist_step_torch(pp, p, qp, q, qfp=qf[0], qfq=qf[1],
                                                   store=store, order=order, **kw)
                o = (pp.clone(), qp.clone())
                got = cv.fused_vti_hist_step(o[0], p, o[1], q, qfp=qf[0], qfq=qf[1],
                                             store=store, order=order, out=o, **kw)
                torch.cuda.synchronize()
                assert got[0] is o[0] and got[1] is o[1], "K9 not in place"
                assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
                    f"K9 not bitwise (fields, codes, maxima; {store}, order {order}, {shape})"
                maxerr("fused_vti_hist_step", got, ref)
                hist[store] = (ref[2], ref[3])
                dsc = decs[store]
                args = (kw["C"], kw["av"], kw["ah"], *hist[store], dsc[0], dsc[1],
                        kw["inv_dx2"], kw["spz"], kw["sy"], kw["sx"])
                ref = cv.fused_vti_adjoint_step_torch(ap1, aq1, ap2, aq2, gC, gah, gav,
                                                      *args, order=order)
                o = tuple(t.clone() for t in (ap2, aq2, gC, gah, gav))
                got = cv.fused_vti_adjoint_step(ap1, aq1, *o, *args, order=order,
                                                inplace=True)
                torch.cuda.synchronize()
                assert all(a is b for a, b in zip(got, o)), "K10 not in place"
                assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
                    f"K10 not bitwise ({store}, order {order}, {shape})"
                maxerr("fused_vti_adjoint_step", got, ref)
        return hist

    vhist = vti_kernels_check(vpp, vp, vqp, vq, ap1, aq1, ap2, aq2, vgC, vgah, vgav, vkw,
                              vqf, vdec)
    for shape in VTI_SHAPES[1:]:
        f = [npf(rk.standard_normal, shape) for _ in range(11)]
        C_, ah_, av_ = vti_coeffs(shape)
        sz_, sy_, sx_ = sponges(shape)
        vti_kernels_check(*f, dict(vkw, C=C_, ah=ah_, av=av_, spz=sz_, sy=sy_, sx=sx_,
                                   src_idx=centre(shape)), *scalings(f[1], f[3]))
    log(1, f"K8 bitwise and in place at {shapes_text(VTI_SHAPES)}, orders 2/4/8; K9 "
           "(fields, f32/bf16/int8 codes, reduced maxima) and K10 (five outputs) bitwise "
           "and in place at the same shapes with f32/bf16/int8 histories, orders 2/4/8")

    # K11, K12 and K13 at every shape of TTI_SHAPES (among them two ragged
    # ones: a last z-chunk, tile rows and columns cut by the grid's edge; D
    # below one z-chunk), every order, coefficient width and history type,
    # bitwise against the plain versions, in place; the axis (cosθ, sinθcosφ,
    # sinθsinφ) of random tilt and azimuth angles
    def tti_axis(shape):
        th = torch.from_numpy(rk.uniform(-0.6, 0.6, shape)).to(dev)
        az = torch.from_numpy(rk.uniform(-3.0, 3.0, shape)).to(dev)
        return (torch.cos(th).float(), torch.sin(th).float() * torch.cos(az).float(),
                torch.sin(th).float() * torch.sin(az).float())

    def tti_kernels_check(f, tco, tkw, qfs, decs):
        """K11-K13 against their plain versions on fields ``f``; returns the
        history codes of K12 per store type."""
        hist = {}
        accs = (f["gC"], f["gah"], f["gav"], f["gnz"], f["gny"], f["gnx"])
        fields = (f["pp"], f["p"], f["qp"], f["q"], f["C"])
        for cdt, co in tco.items():
            for order in (2, 4, 8):
                ref = ct.fused_tti_step_torch(*fields, *co, order=order, **tkw)
                o = (f["pp"].clone(), f["qp"].clone())
                got = ct.fused_tti_step(o[0], f["p"], o[1], f["q"], f["C"], *co, order=order,
                                        out=o, **tkw)
                torch.cuda.synchronize()
                assert got[0] is o[0] and got[1] is o[1], "K11 not in place"
                assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
                    f"K11 not bitwise ({cdt}, order {order}, {tuple(f['p'].shape)})"
                maxerr("fused_tti_step", got, ref)
                for store in ("f32", "bf16", "int8"):
                    qf = qfs[store]
                    ref = ct.fused_tti_hist_step_torch(*fields, *co, qfp=qf[0], qfq=qf[1],
                                                       store=store, order=order, **tkw)
                    o = (f["pp"].clone(), f["qp"].clone())
                    got = ct.fused_tti_hist_step(o[0], f["p"], o[1], f["q"], f["C"], *co,
                                                 qfp=qf[0], qfq=qf[1], store=store,
                                                 order=order, out=o, **tkw)
                    torch.cuda.synchronize()
                    assert got[0] is o[0] and got[1] is o[1], "K12 not in place"
                    assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
                        (f"K12 not bitwise (fields, codes, maxima; {cdt}, {store}, order "
                         f"{order}, {tuple(f['p'].shape)})")
                    maxerr("fused_tti_hist_step", got, ref)
                    hist[store] = (ref[2], ref[3])
                    dsc = decs[store]
                    targs = (f["C"], *co, *hist[store], dsc[0], dsc[1], tkw["inv_dx2"],
                             tkw["inv_dx"], tkw["spz"], tkw["sy"], tkw["sx"])
                    ref = ct.fused_tti_adjoint_step_torch(f["ap1"], f["aq1"], f["ap2"],
                                                          f["aq2"], *accs, *targs,
                                                          order=order)
                    o = tuple(t.clone() for t in (f["ap2"], f["aq2"], *accs))
                    got = ct.fused_tti_adjoint_step(f["ap1"], f["aq1"], *o, *targs,
                                                    order=order, inplace=True)
                    torch.cuda.synchronize()
                    assert all(a is b for a, b in zip(got, o)), "K13 not in place"
                    assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
                        f"K13 not bitwise ({cdt}, {store}, order {order}, {tuple(f['p'].shape)})"
                    maxerr("fused_tti_adjoint_step", got, ref)
        return hist

    tnz, tny, tnx = tti_axis(wshape)
    tco = {torch.float32: (vah, vav, tnz, tny, tnx)}
    tco[torch.bfloat16] = tuple(t.to(torch.bfloat16) for t in tco[torch.float32])
    tacc = [npf(rk.standard_normal) for _ in range(3)]  # gnz, gny, gnx
    idx1 = torch.tensor(1.0 / 10.0, device=dev)
    tkw = dict(spz=spz, sy=spy, sx=spx, inv_dx2=idx2, inv_dx=idx1, s_t=vst,
               src_idx=src_flat, amp=amp)
    for k in ("fused_tti_step", "fused_tti_hist_step", "fused_tti_adjoint_step"):
        err[k] = 0.0
    tf = dict(pp=vpp, p=vp, qp=vqp, q=vq, C=vC, ap1=ap1, aq1=aq1, ap2=ap2, aq2=aq2, gC=vgC,
              gah=vgah, gav=vgav, gnz=tacc[0], gny=tacc[1], gnx=tacc[2])
    thist = tti_kernels_check(tf, tco, tkw, vqf, vdec)
    for rshape in TTI_SHAPES[1:]:
        rD, rH, rW = rshape
        rf = {k: npf(rk.standard_normal, rshape) for k in tf}
        rf["C"], rah, rav = vti_coeffs(rshape)
        rco = {torch.float32: (rah, rav, *tti_axis(rshape))}
        rco[torch.bfloat16] = tuple(t.to(torch.bfloat16) for t in rco[torch.float32])
        rsz, rsy, rsx = sponges(rshape)
        rkw = dict(tkw, spz=rsz, sy=rsy, sx=rsx,
                   src_idx=((rD // 2) * rH + rH // 3) * rW + rW - 2)
        tti_kernels_check(rf, rco, rkw, *scalings(rf["p"], rf["q"]))
    log(1, f"K11 bitwise and in place at {shapes_text(TTI_SHAPES)}, orders 2/4/8, f32 and "
           "bf16 coefficients; K12 (fields, f32/bf16/int8 codes, reduced maxima) and K13 "
           "(eight outputs) bitwise and in place at the same shapes with f32/bf16/int8 "
           "histories, orders 2/4/8, f32 and bf16 coefficients")
    del rf, rco

    # K6a, K6b and K7 at the Krylov paths' shapes, an odd length and its
    # offset views, bitwise and in place (K6a's rho, an f64 sum rounded to
    # f32, against an f64 sum of the plain r': rel <= 1e-6); K14 at the Q
    # path's shape, every order and friction width, bitwise and in place
    alpha, beta = torch.tensor(0.37, device=dev), torch.tensor(-0.61, device=dev)
    lsc = [torch.tensor(v, device=dev) for v in (-0.31, 0.77, -0.52, 1.9)]
    for k in ("cg_update", "p_update", "lsmr_update", "fused_q_step"):
        err[k] = 0.0
    rho_rel = 0.0
    for shape, off in SOLVER_SHAPES:
        x, r, p, q, h, hb = (rnd(shape)[off:] for _ in range(6))
        ref = cs.cg_update_torch(x.clone(), r.clone(), p, q, alpha)
        o = (x.clone(), r.clone())
        got = cs.cg_update(*o, p, q, alpha)
        torch.cuda.synchronize()
        assert got[0] is o[0] and got[1] is o[1], "K6a not in place"
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), \
            f"K6a not bitwise at {shape}"
        maxerr("cg_update", got[:2], ref[:2])
        rho64 = float(torch.sum(ref[1].double() ** 2))
        rho_rel = max(rho_rel, abs(float(got[2]) - rho64) / rho64)
        assert rho_rel <= 1e-6, f"K6a rho rel err {rho_rel}"
        ref = cs.p_update_torch(r, p.clone(), beta)
        o = p.clone()
        assert cs.p_update(r, o, beta) is o, "K6b not in place"
        torch.cuda.synchronize()
        assert torch.equal(o, ref), f"K6b not bitwise at {shape}"
        maxerr("p_update", (o,), (ref,))
        ref = cs.lsmr_update_torch(p, h.clone(), hb.clone(), x.clone(), *lsc)
        o = (h.clone(), hb.clone(), x.clone())
        got = cs.lsmr_update(p, *o, *lsc)
        torch.cuda.synchronize()
        assert all(a is b for a, b in zip(got, o)), "K7 not in place"
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), f"K7 not bitwise at {shape}"
        maxerr("lsmr_update", got, ref)
    del x, r, p, q, h, hb, ref, got, o
    def friction(shape):
        g = 0.01 + 0.05 * torch.rand(shape, generator=gen, device=dev)
        return {torch.float32: g, torch.bfloat16: g.to(torch.bfloat16)}

    def q_kernel_check(up, u, c2, gq, spz, spy, spx, src):
        shape = tuple(u.shape)
        for gdt, gg in gq.items():
            for order in (2, 4, 8):
                ref = cw.fused_q_step_torch(up, u, c2, gg, spz, spy, spx, vst, src, amp,
                                            order=order)
                upk = up.clone()
                out = cw.fused_q_step(upk, u, c2, gg, spz, spy, spx, vst, src, amp,
                                      order=order, out=upk)
                torch.cuda.synchronize()
                assert out is upk, "K14 not in place"
                assert torch.equal(out, ref), f"K14 not bitwise ({gdt}, order {order}, {shape})"
                maxerr("fused_q_step", (out,), (ref,))

    gq = friction(wshape)
    q_kernel_check(up, u, c2, gq, spz, spy, spx, src_flat)
    for shape in Q_SHAPES[1:]:
        q_kernel_check(rnd(shape), rnd(shape), 0.3 * torch.rand(shape, generator=gen, device=dev),
                       friction(shape), *sponges(shape), centre(shape))
    log(1, f"K6a (x, r), K6b and K7 bitwise and in place at {SOLVER_SHAPES_TEXT}, "
           f"K6a rho rel err {rho_rel:.3e} vs f64 (<= 1e-6); K14 bitwise and in place at "
           f"{shapes_text(Q_SHAPES)}, orders 2/4/8, f32 and bf16 friction fields")

    # ---- phase 2: the 3-D flagship at full width -----------------------------
    grid3, nshots3, nrecv = (256, 256, 256), 16, 4096
    t0 = time.perf_counter()
    A, m_true, d = make_seismic_problem(grid3, nshots3, nrecv, seed=0, noise=0.05)
    torch.cuda.synchronize()
    build3 = time.perf_counter() - t0
    wr = A.jet.state["bstate"]["wr"]
    g = torch.Generator().manual_seed(1)
    mt, dt = A.dom.randn(g), A.rng.randn(g)
    lhs, rhs = dot_product_test(A, mt, dt)
    gate = abs(float(lhs) - float(rhs)) / abs(float(rhs))
    assert gate <= 1e-4, f"dot-product gate rel {gate}"
    Ac = seismic_operator_from_arrays(grid3, nshots3, nrecv, wr=wr, impl="composed")
    fused, composed = A(m_true), Ac(m_true)
    fc = rel(fused, composed)
    assert fc <= 1e-6, f"fused vs composed rel {fc}"
    dnorm = float(torch.linalg.vector_norm(d))
    log(2, f"3-D problem {grid3} x {nshots3} shots x {nrecv} rcv built in "
           f"{build3:.2f} s; dot-product gate rel {gate:.3e} (<= 1e-4); "
           f"fused vs composed rel {fc:.3e} (<= 1e-6, bitwise: "
           f"{bool(torch.equal(fused, composed))})")
    del mt, fused, composed, Ac

    # ---- phases 3-6: the main path, launches counted -------------------------
    cs.reset_launch_counts()
    c0 = cs.launch_counts()
    r3 = lsqr(A, d, maxiter=50, tol=0.0)
    flagship_ref = (r3.x, r3.history)  # phase 65 holds the mesh runs to these bits
    c3 = cs.launch_counts()
    assert c3["xw_update"] - c0["xw_update"] == 50, c3
    check_history(r3, 50, dnorm, 3)
    log(3, f"lsqr 3-D 50 iterations: launches {c3}")

    A_hook = seismic_operator_from_arrays(grid3, nshots3, nrecv, wr=wr,
                                          epilogue_hook=True)
    assert A_hook.jet.state.get("adjoint_axpy_norm") is not None
    r4 = lsqr(A_hook, d, maxiter=50, tol=0.0)
    c4 = cs.launch_counts()
    assert c4["lap3d_axpy_norm2"] - c3["lap3d_axpy_norm2"] == 50, c4
    assert c4["xw_update"] - c3["xw_update"] == 50, c4
    check_history(r4, 50, dnorm, 4)
    hx = rel(r4.x, r3.x)
    assert hx <= 1e-4, f"hooked vs plain x rel {hx}"
    log(4, f"lsqr 3-D hooked 50 iterations: launches {c4}; "
           f"||x_hook - x||/||x|| {hx:.3e} (<= 1e-4)")

    A_cpu = seismic_operator_from_arrays(grid3, nshots3, nrecv, wr=wr.cpu(),
                                         device="cpu")
    d_cpu = d.cpu()
    c_before = cs.launch_counts()
    r_cpu = lsqr(A_cpu, d_cpu, maxiter=10, tol=0.0)
    assert cs.launch_counts() == c_before, "a CPU run launched a kernel"
    r_gpu = lsqr(A, d, maxiter=10, tol=0.0)
    c5 = cs.launch_counts()
    dx = rel(r_gpu.x.cpu(), r_cpu.x)
    dres = abs(float(r_gpu.resnorm) - float(r_cpu.resnorm)) / float(r_cpu.resnorm)
    assert dx <= 1e-4 and dres <= 1e-5, f"card vs CPU: x rel {dx}, resnorm rel {dres}"
    log(5, f"card vs CPU, 3-D 10 iterations: ||dx||/||x|| {dx:.3e} (<= 1e-4), "
           f"resnorm rel {dres:.3e} (<= 1e-5)")
    del A_cpu, d_cpu, r_cpu, r_gpu, r3, r4

    t0 = time.perf_counter()
    A2, _, d2 = make_seismic_problem((2048, 2048), 64, nrecv, seed=0, noise=0.05)
    d2norm = float(torch.linalg.vector_norm(d2))
    r6 = lsqr(A2, d2, maxiter=100, tol=0.0)
    c6 = cs.launch_counts()
    assert c6["xw_update"] - c5["xw_update"] == 100, c6
    check_history(r6, 100, d2norm, 6)
    log(6, f"lsqr 2-D (2048^2, 64 shots, {nrecv} rcv) 100 iterations in "
           f"{time.perf_counter() - t0:.2f} s incl. build: launches {c6}")
    main_path = {k: cs.launch_counts()[k] for k in ("xw_update", "lap3d_axpy_norm2",
                                                     "laplacian3d")}
    for name, n in main_path.items():
        assert n > 0, f"kernel {name} was not launched on the main path"

    # ---- phase 7: times -------------------------------------------------------
    ms3 = ms_per_iter(lsqr, A, d, 10, 60)
    ms3h = ms_per_iter(lsqr, A_hook, d, 10, 60)
    ms2 = ms_per_iter(lsqr, A2, d2, 20, 120)

    x, w, vh = rnd(grid3), rnd(grid3), rnd(grid3)
    kt = {
        "xw_update": (cuda_ms(lambda: cs.xw_update(x, w, vh, *scal), 20),
                      cuda_ms(lambda: cs.xw_update_torch(x, w, vh, *scal), 20)),
        "lap3d_axpy_norm2": (cuda_ms(lambda: cs.lap3d_axpy_norm2(z, v, s), 20),
                             cuda_ms(lambda: cs.lap3d_axpy_norm2_torch(z, v, s), 20)),
        "laplacian3d": (cuda_ms(lambda: cs.laplacian3d(z), 20),
                        cuda_ms(lambda: cs.laplacian3d_torch(z), 20)),
    }
    # the one PyTorch call that computes a kernel's function: K3 as a 3-D
    # convolution with the 7-point stencil and zero padding (timed as a
    # yardstick only; TF32 is off above)
    w7 = torch.zeros((1, 1, 3, 3, 3), device=dev)
    w7[0, 0, 1, 1, 1] = -6.0
    for a_ in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        w7[(0, 0) + a_] = 1.0
    conv = torch.nn.functional.conv3d(z[None, None], w7, padding=1)[0, 0]
    conv_rel = rel(conv, cs.laplacian3d(z))
    assert conv_rel <= 1e-6, f"conv3d vs K3 rel {conv_rel}"
    kbytes = {"xw_update": nbytes(x, w, vh, x, w), "lap3d_axpy_norm2": nbytes(z, v, z),
              "laplacian3d": nbytes(z, z)}
    lib_ms = {"laplacian3d": cuda_ms(
        lambda: torch.nn.functional.conv3d(z[None, None], w7, padding=1), 20)}
    del conv
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(7, f"3-D LSQR {ms3:.4f} ms/iter, hooked {ms3h:.4f} ms/iter; 2-D LSQR "
           f"{ms2:.4f} ms/iter ({1e3 / ms2:.1f} iter/s); kernel vs plain at 256^3 "
           + ", ".join(f"{k} {1e3 * a:.1f} vs {1e3 * b:.1f} us" for k, (a, b) in kt.items())
           + f"; conv3d (the library call for K3, rel {conv_rel:.1e} to K3) "
           f"{1e3 * lib_ms['laplacian3d']:.1f} us; peak device memory {peak_gib:.2f} GiB "
           f"[{smi}]")

    del A, A_hook, A2, d, d2, x, w, vh, z, v

    # ---- phases 8-12: the FWI gradient path, launches counted ------------------
    from jets_tpu_torch.ops.wave import (born_operator, multishot_wave_operator,
                                         wave_propagator)

    c_true, src0, wkw, rs = wave_model(dev)
    axis = torch.arange(256, dtype=torch.float32, device=dev)
    c_bg = torch.full(wshape, 1500.0, device=dev)

    def delta(before):
        now = cw.launch_counts()
        return tuple(now[k] - before[k] for k in ("fused_leapfrog_step",
                                                   "fused_adjoint_step"))

    cw.reset_launch_counts()
    F = wave_propagator(wshape, nt=220, src_idx=src0, **wkw)
    Fp = wave_propagator(wshape, nt=220, src_idx=src0, fused=False, **wkw)
    b = cw.launch_counts()
    d_k = F(c_true)
    assert delta(b) == (220, 0), delta(b)
    d_p = Fp(c_true)
    assert delta(b) == (220, 0), "the plain route launched a kernel"
    assert d_k.shape == (220, 128)
    live(d_k, "forward traces")
    log(8, "forward 256^3, nt=220, 128 rcv: K4 launched 220 times; kernel vs plain "
           "route " + agree(d_k, d_p, "traces", 1e-6))

    resid = d_k - Fp(c_bg)  # a physical residual
    live(resid, "residual")
    Fg = wave_propagator(wshape, nt=220, src_idx=src0, store_adjoint="int8", **wkw)
    Fgp = wave_propagator(wshape, nt=220, src_idx=src0, store_adjoint="int8",
                          fused=False, **wkw)
    b = cw.launch_counts()
    g_k = Fg.linearize(c_true).H(resid)
    assert delta(b) == (220, 220), delta(b)
    g_p = Fgp.linearize(c_true).H(resid)
    assert delta(b) == (220, 220), "the plain route launched a kernel"
    live(g_k, "int8 gradient")
    # the sweeps are the same trees; the receiver injection is an in-place
    # index_add_ on the kernel route and a dense add on the plain one, which
    # differ only in the sign of a zero
    log(9, "int8-stored gradient 256^3, nt=220: K4 220 + K5 220 launches; kernel "
           "vs plain route " + agree(g_k, g_p, "gradient", 1e-6))
    del d_p, g_p, Fp, Fgp

    F20 = wave_propagator(wshape, nt=20, src_idx=src0, store_adjoint="int8", **wkw)
    F20c = wave_propagator(wshape, nt=20, src_idx=src0, store_adjoint="int8",
                           **{**wkw, "device": "cpu"})
    c_cpu = c_true.cpu()
    r20 = torch.from_numpy(rs.standard_normal((20, 128)).astype(np.float32))
    b = cw.launch_counts()
    t0 = time.perf_counter()
    d20c, g20c = F20c(c_cpu), F20c.linearize(c_cpu).H(r20)
    t_cpu = time.perf_counter() - t0
    assert delta(b) == (0, 0), "a CPU run launched a kernel"
    d20, g20 = F20(c_true), F20.linearize(c_true).H(r20.to(dev))
    assert delta(b) == (40, 20), delta(b)
    live(d20c, "CPU traces")
    live(g20c, "CPU gradient")
    log(10, f"card vs CPU at 256^3, nt=20 (CPU {t_cpu:.1f} s): "
            + agree(d20.cpu(), d20c, "traces", 1e-5) + "; "
            + agree(g20.cpu(), g20c, "int8 gradient", 1e-5))
    del F20c, c_cpu, d20c, g20c

    Fb = wave_propagator(wshape, nt=60, src_idx=src0, store_adjoint="f32", **wkw)
    J = born_operator(Fb, c_true)
    gb = torch.Generator().manual_seed(3)
    mb, db = J.dom.randn(gb), J.rng.randn(gb)
    b = cw.launch_counts()
    lhs, rhs = dot_product_test(J, mb, db)
    assert delta(b) == (120, 60), delta(b)
    gate_w = abs(float(lhs) - float(rhs)) / abs(float(rhs))
    assert gate_w <= 1e-4, f"Born dot-product gate rel {gate_w}"
    log(11, f"Born operator 256^3, nt=60, f32 history: dot-product gate rel "
            f"{gate_w:.3e} (<= 1e-4; <d, J m> = {float(lhs):.6g}); launches K4 120 "
            f"(Born forward 60 + adjoint sweep 60), K5 60")
    del J, Fb, mb

    nsh = 16
    msrc = np.ravel_multi_index((np.full(nsh, 128), np.full(nsh, 128),
                                 16 + 14 * np.arange(nsh)), wshape)
    mkw = dict(store_adjoint="int8", shot_map="map", **wkw)
    Fm = multishot_wave_operator(wshape, msrc, nt=120, **mkw)
    b = cw.launch_counts()
    dm = Fm(c_true)
    assert delta(b) == (nsh * 120, 0), delta(b)
    assert dm.shape == (nsh, 120, 128)
    live(dm, "multishot traces")
    ones = torch.ones(dm.shape, device=dev)
    gm = Fm.linearize(c_true).H(ones)
    assert delta(b) == (2 * nsh * 120, nsh * 120), delta(b)
    live(gm, "multishot gradient")
    n_ms = cw.launch_counts()
    # shot 0 against a single-shot plain propagator, and the adjoint of two
    # shots against the sum of their single-shot gradients
    d0 = wave_propagator(wshape, nt=120, src_idx=int(msrc[0]), fused=False,
                         **wkw)(c_true)
    Fm2 = multishot_wave_operator(wshape, msrc[:2], nt=120, **mkw)
    gm2 = Fm2.linearize(c_true).H(ones[:2])
    gm2s = sum(wave_propagator(wshape, nt=120, src_idx=int(sidx), store_adjoint="int8",
                              **wkw).linearize(c_true).H(ones[0]) for sidx in msrc[:2])
    log(12, f"multishot 256^3, {nsh} shots, nt=120, map, int8: launches forward "
            f"K4 {nsh * 120}, gradient K4 {nsh * 120} + K5 {nsh * 120}; "
            + agree(dm[0], d0, "shot 0 vs single-shot plain", 1e-6) + "; "
            + agree(gm2, gm2s, "2-shot gradient vs sum of single shots", 1e-6))
    wave_path = {k: n_ms[k] for k in ("fused_leapfrog_step", "fused_adjoint_step")}
    for name, n in wave_path.items():
        assert n > 0, f"kernel {name} was not launched on the wave path"
    del dm, gm, Fm, Fm2, gm2, gm2s, d0

    # ---- phase 13: wave times ---------------------------------------------------
    def us_per_step(make, run, lo, hi, reps=3, per=1):
        """Marginal µs per step between nt budgets lo and hi (median of reps)."""
        ops = {n: make(n) for n in (lo, hi)}
        run(ops[lo], lo)  # warm-up
        t = {n: sorted(event_ms(lambda: run(ops[n], n)) for _ in range(reps))[reps // 2]
             for n in (lo, hi)}
        return 1e3 * (t[hi] - t[lo]) / (hi - lo) / per

    def fwd(op, n):
        return op(c_true)

    def grad(op, n):
        return op.linearize(c_true).H(torch.ones(op.rng.shape, device=dev))

    def single(**kw):
        return lambda n: wave_propagator(wshape, nt=n, src_idx=src0, **wkw, **kw)

    def multi(n):
        return multishot_wave_operator(wshape, msrc, nt=n, **mkw)

    us = {
        "forward": us_per_step(single(), fwd, 20, 220),
        "forward_plain": us_per_step(single(fused=False), fwd, 20, 220),
        "gradient": us_per_step(single(store_adjoint="int8"), grad, 20, 220),
        "gradient_plain": us_per_step(single(store_adjoint="int8", fused=False), grad,
                                      20, 220),
        "multishot_forward": us_per_step(multi, fwd, 20, 120, reps=1, per=nsh),
        "multishot_gradient": us_per_step(multi, grad, 20, 120, reps=1, per=nsh),
    }
    q8, sc8 = hists["int8"]
    kbytes["fused_leapfrog_step"] = nbytes(up, u, c2, spz, spy, spx, up)
    kbytes["fused_adjoint_step"] = nbytes(a1, a2, g2, c2, q8, spz, spy, spx, a2, g2)
    kt["fused_leapfrog_step"] = (
        cuda_ms(lambda: cw.fused_leapfrog_step(up, u, c2, spz, spy, spx, s_t, src_flat,
                                               amp), 20),
        cuda_ms(lambda: cw.fused_leapfrog_step_torch(up, u, c2, spz, spy, spx, s_t,
                                                     src_flat, amp), 20))
    kt["fused_adjoint_step"] = (
        cuda_ms(lambda: cw.fused_adjoint_step(a1, a2, g2, c2, q8, sc8, spz, spy, spx), 20),
        cuda_ms(lambda: cw.fused_adjoint_step_torch(a1, a2, g2, c2, q8, sc8, spz, spy,
                                                    spx), 20))

    # device busy share of the wave steps from one profiler trace each
    Fprof = wave_propagator(wshape, nt=40, src_idx=src0, store_adjoint="int8", **wkw)
    shares = {"forward": busy_share(lambda: Fprof(c_true)),
              "gradient": busy_share(lambda: grad(Fprof, 40))}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(13, "wave us/step (marginal, CUDA events): "
            + ", ".join(f"{k} {v:.2f}" for k, v in us.items())
            + "; kernel vs plain at 256^3 "
            + ", ".join(f"{k} {1e3 * kt[k][0]:.1f} vs {1e3 * kt[k][1]:.1f} us"
                        for k in ("fused_leapfrog_step", "fused_adjoint_step"))
            + "; device busy share under the profiler (nt=40): "
            + ", ".join(f"{k} {'not measured' if sh is None else f'{sh:.3f}'} of "
                        f"{wall:.2f} ms ({n} device events; top kernels, us total/"
                        f"count: " + "; ".join(f"{nm} {t:.0f}/{c}" for nm, (t, c) in top)
                        + ")"
                        for k, (sh, wall, n, top) in shares.items())
            + f"; peak device memory {peak_gib:.2f} GiB [{smi}]")

    # ---- phases 14-18: the VTI gradient path, launches counted -----------------
    from jets_tpu_torch import BlockVector
    from jets_tpu_torch.ops.wave import multishot_vti_wave_operator, vti_wave_propagator

    def vdelta(before):
        now = cv.launch_counts()
        return tuple(now[k] - before[k] for k in ("fused_vti_step", "fused_vti_hist_step",
                                                   "fused_vti_adjoint_step"))

    def vti_model(dom, c):
        return BlockVector((c, torch.full(wshape, 0.1, device=dev),
                            torch.full(wshape, 0.05, device=dev)), dom)

    cv.reset_launch_counts()
    Fv = vti_wave_propagator(wshape, nt=220, src_idx=src0, **wkw)
    m_true, m_bg = vti_model(Fv.dom, c_true), vti_model(Fv.dom, c_bg)
    b = cv.launch_counts()
    dv_k = Fv(m_true)
    assert vdelta(b) == (220, 0, 0), vdelta(b)
    dv_p = vti_wave_propagator(wshape, nt=220, src_idx=src0, fused=False, **wkw)(m_true)
    assert vdelta(b) == (220, 0, 0), "the plain route launched a kernel"
    assert dv_k.shape == (220, 128)
    log(14, "VTI forward 256^3, nt=220, (c, eps, delta) = (1500 + anomalies, 0.1, 0.05): "
            "K8 launched 220 times; kernel vs plain route " + same(dv_k, dv_p, "traces"))
    del dv_k, dv_p

    Fg = vti_wave_propagator(wshape, nt=160, src_idx=src0, store_adjoint="int8", **wkw)
    Fgp = vti_wave_propagator(wshape, nt=160, src_idx=src0, store_adjoint="int8",
                              fused=False, **wkw)
    vres = Fg(m_true) - Fg(m_bg)  # a physical residual
    live(vres, "VTI residual")
    b = cv.launch_counts()
    gv_k = Fg.linearize(m_true).H(vres)
    assert vdelta(b) == (0, 160, 160), vdelta(b)
    gv_p = Fgp.linearize(m_true).H(vres)
    assert vdelta(b) == (0, 160, 160), "the plain route launched a kernel"
    log(15, "VTI int8-stored gradient 256^3, nt=160: K9 160 + K10 160 launches; kernel vs "
            "plain route " + same(gv_k, gv_p, "(gc, geps, gdelta)"))
    del gv_k, gv_p, Fgp

    F12 = vti_wave_propagator(wshape, nt=12, src_idx=src0, store_adjoint="int8", **wkw)
    F12c = vti_wave_propagator(wshape, nt=12, src_idx=src0, store_adjoint="int8",
                               **{**wkw, "device": "cpu"})
    m_cpu = BlockVector(tuple(t.cpu() for t in m_true.blocks), F12c.dom)
    r12 = torch.from_numpy(rs.standard_normal((12, 128)).astype(np.float32))
    b = cv.launch_counts()
    t0 = time.perf_counter()
    d12c, g12c = F12c(m_cpu), F12c.linearize(m_cpu).H(r12)
    t_cpu = time.perf_counter() - t0
    assert vdelta(b) == (0, 0, 0), "a CPU run launched a kernel"
    d12, g12 = F12(m_true), F12.linearize(m_true).H(r12.to(dev))
    assert vdelta(b) == (12, 12, 12), vdelta(b)
    g12 = BlockVector(tuple(t.cpu() for t in g12.blocks), F12c.dom)
    log(16, f"VTI card vs CPU at 256^3, nt=12 (CPU {t_cpu:.1f} s): "
            + same(d12.cpu(), d12c, "traces") + "; " + same(g12, g12c, "int8 gradient"))
    del F12c, m_cpu, d12c, g12c, g12

    Fb = vti_wave_propagator(wshape, nt=60, src_idx=src0, store_adjoint="f32", **wkw)
    J = born_operator(Fb, m_true)
    gb = torch.Generator().manual_seed(4)
    mb, db = J.dom.randn(gb), J.rng.randn(gb)
    b = cv.launch_counts()
    lhs, rhs = dot_product_test(J, mb, db)
    assert vdelta(b) == (60, 60, 60), vdelta(b)
    gate_v = abs(float(lhs) - float(rhs)) / abs(float(rhs))
    assert gate_v <= 1e-4, f"VTI Jacobian dot-product gate rel {gate_v}"
    # the same two products of the same f32 vectors, summed in f64: the f32
    # sums above can round both sides to one value
    Jm, Jd = J(mb), J.H(db)
    assert vdelta(b) == (120, 120, 120), vdelta(b)
    lhs64 = float(torch.vdot(db.double().reshape(-1), Jm.double().reshape(-1)))
    rhs64 = sum(float(torch.vdot(x.double().reshape(-1), y.double().reshape(-1)))
                for x, y in zip(Jd.blocks, mb.blocks))
    gate64 = abs(lhs64 - rhs64) / abs(rhs64)
    assert gate64 <= 1e-4, f"VTI Jacobian dot-product gate (f64 sums) rel {gate64}"
    log(17, f"VTI Jacobian 256^3, nt=60, f32 history: dot-product gate rel {gate_v:.3e} "
            f"(<= 1e-4; <d, J m> = {float(lhs):.6g}), with f64 sums rel {gate64:.3e} "
            f"(<d, J m> = {lhs64:.9g}, <J^H d, m> = {rhs64:.9g}); launches K8 60 "
            f"(tangent through the autograd Function), K9 60 + K10 60 (adjoint), twice")
    del Jm, Jd
    del J, Fb, mb

    Fvm = multishot_vti_wave_operator(wshape, msrc, nt=120, **mkw)
    b = cv.launch_counts()
    dvm = Fvm(m_true)
    assert vdelta(b) == (nsh * 120, 0, 0), vdelta(b)
    assert dvm.shape == (nsh, 120, 128)
    gvm = Fvm.linearize(m_true).H(torch.ones(dvm.shape, device=dev))
    assert vdelta(b) == (nsh * 120, nsh * 120, nsh * 120), vdelta(b)
    for i, blk in enumerate(gvm.blocks):
        live(blk, f"VTI multishot gradient[{i}]")
    n_vti = cv.launch_counts()
    dv0 = vti_wave_propagator(wshape, nt=120, src_idx=int(msrc[0]), **wkw)(m_true)
    Fvm2 = multishot_vti_wave_operator(wshape, msrc[:2], nt=120, **mkw)
    gvm2 = Fvm2.linearize(m_true).H(torch.ones((2, 120, 128), device=dev))
    g1 = [vti_wave_propagator(wshape, nt=120, src_idx=int(sidx), store_adjoint="int8",
                              **wkw).linearize(m_true).H(torch.ones((120, 128), device=dev))
          for sidx in msrc[:2]]
    log(18, f"VTI multishot 256^3, {nsh} shots, nt=120, map, int8: launches forward K8 "
            f"{nsh * 120}, gradient K9 {nsh * 120} + K10 {nsh * 120}; "
            + same(dvm[0], dv0, "shot 0 vs single shot") + "; "
            + same(gvm2, g1[0] + g1[1], "2-shot gradient vs sum of single shots"))
    vti_path = {k: n_vti[k] for k in ("fused_vti_step", "fused_vti_hist_step",
                                      "fused_vti_adjoint_step")}
    for name, n in vti_path.items():
        assert n > 0, f"kernel {name} was not launched on the VTI path"
    del dvm, gvm, Fvm, Fvm2, gvm2, g1, dv0

    # ---- phase 19: VTI times ------------------------------------------------------
    def vfwd(op, n):
        return op(m_true)

    def vgrad(op, n):
        return op.linearize(m_true).H(torch.ones(op.rng.shape, device=dev))

    def vsingle(**kw):
        return lambda n: vti_wave_propagator(wshape, nt=n, src_idx=src0, **wkw, **kw)

    def vmulti(n):
        return multishot_vti_wave_operator(wshape, msrc, nt=n, **mkw)

    vus = {
        "forward": us_per_step(vsingle(), vfwd, 20, 220),
        "forward_plain": us_per_step(vsingle(fused=False), vfwd, 20, 220),
        "gradient": us_per_step(vsingle(store_adjoint="int8"), vgrad, 20, 160),
        "gradient_plain": us_per_step(vsingle(store_adjoint="int8", fused=False), vgrad,
                                      20, 160),
        "multishot_forward": us_per_step(vmulti, vfwd, 20, 120, reps=1, per=nsh),
        "multishot_gradient": us_per_step(vmulti, vgrad, 20, 120, reps=1, per=nsh),
    }
    qf8, dec8, (pe8, qe8) = vqf["int8"], vdec["int8"], vhist["int8"]
    adj8 = (ap1, aq1, ap2, aq2, vgC, vgah, vgav, vC, vav, vah, pe8, qe8, dec8[0], dec8[1],
            idx2, spz, spy, spx)
    kbytes["fused_vti_step"] = nbytes(vpp, vp, vqp, vq, vC, vah, vav, spz, spy, spx, vpp,
                                      vqp)
    kbytes["fused_vti_hist_step"] = kbytes["fused_vti_step"] + nbytes(pe8, qe8)
    kbytes["fused_vti_adjoint_step"] = nbytes(*adj8[:12], spz, spy, spx, ap2, aq2, vgC,
                                              vgah, vgav)
    kt["fused_vti_step"] = (
        cuda_ms(lambda: cv.fused_vti_step(vpp, vp, vqp, vq, **vkw), 20),
        cuda_ms(lambda: cv.fused_vti_step_torch(vpp, vp, vqp, vq, **vkw), 20))
    kt["fused_vti_hist_step"] = (
        cuda_ms(lambda: cv.fused_vti_hist_step(vpp, vp, vqp, vq, qfp=qf8[0], qfq=qf8[1],
                                               **vkw), 20),
        cuda_ms(lambda: cv.fused_vti_hist_step_torch(vpp, vp, vqp, vq, qfp=qf8[0],
                                                     qfq=qf8[1], **vkw), 20))
    kt["fused_vti_adjoint_step"] = (
        cuda_ms(lambda: cv.fused_vti_adjoint_step(*adj8), 20),
        cuda_ms(lambda: cv.fused_vti_adjoint_step_torch(*adj8), 20))
    Fvprof = vti_wave_propagator(wshape, nt=40, src_idx=src0, store_adjoint="int8", **wkw)
    vshares = {"forward": busy_share(lambda: Fvprof(m_true)),
               "gradient": busy_share(lambda: vgrad(Fvprof, 40))}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(19, "VTI us/step (marginal, CUDA events): "
            + ", ".join(f"{k} {v:.2f}" for k, v in vus.items())
            + "; kernel vs plain at 256^3 "
            + ", ".join(f"{k} {1e3 * kt[k][0]:.1f} vs {1e3 * kt[k][1]:.1f} us"
                        for k in ("fused_vti_step", "fused_vti_hist_step",
                                  "fused_vti_adjoint_step"))
            + "; device busy share under the profiler (nt=40): "
            + ", ".join(f"{k} {'not measured' if sh is None else f'{sh:.3f}'} of "
                        f"{wall:.2f} ms ({n} device events; top kernels, us total/"
                        f"count: " + "; ".join(f"{nm} {t:.0f}/{c}" for nm, (t, c) in top)
                        + ")"
                        for k, (sh, wall, n, top) in vshares.items())
            + f"; peak device memory {peak_gib:.2f} GiB [{smi}]")

    del Fvprof

    # ---- phases 20-25: the TTI gradient path, launches counted -----------------
    from jets_tpu_torch.ops.wave import multishot_tti_wave_operator, tti_wave_propagator

    def tdelta(before):
        now = ct.launch_counts()
        return tuple(now[k] - before[k] for k in ("fused_tti_step", "fused_tti_hist_step",
                                                   "fused_tti_adjoint_step"))

    # (c, ε, δ, θ, φ) = (1500 m/s + anomalies, 0.1, 0.05, 0.2, 0.7), bench.py's model
    def tti_model(dom, c, theta=0.2, phi=0.7):
        return BlockVector((c, *(torch.full(wshape, v, device=dev)
                                 for v in (0.1, 0.05, theta, phi))), dom)

    cdts = (None, torch.bfloat16)
    ct.reset_launch_counts()
    for cdt in cdts:
        Ft = tti_wave_propagator(wshape, nt=60, src_idx=src0, coeff_dtype=cdt, **wkw)
        mt_true = tti_model(Ft.dom, c_true)
        b = ct.launch_counts()
        dt_k = Ft(mt_true)
        assert tdelta(b) == (60, 0, 0), tdelta(b)
        dt_p = tti_wave_propagator(wshape, nt=60, src_idx=src0, coeff_dtype=cdt,
                                   fused=False, **wkw)(mt_true)
        assert tdelta(b) == (60, 0, 0), "the plain route launched a kernel"
        assert dt_k.shape == (60, 128)
        log(20, f"TTI forward 256^3, nt=60, {cdt or 'f32'} coefficients, (c, eps, delta, "
                "theta, phi) = (1500 + anomalies, 0.1, 0.05, 0.2, 0.7): K11 launched 60 "
                "times; kernel vs plain route " + same(dt_k, dt_p, "traces"))
    del dt_k, dt_p

    for cdt in cdts:
        Fg = tti_wave_propagator(wshape, nt=60, src_idx=src0, store_adjoint="int8",
                                 coeff_dtype=cdt, **wkw)
        Fgp = tti_wave_propagator(wshape, nt=60, src_idx=src0, store_adjoint="int8",
                                  coeff_dtype=cdt, fused=False, **wkw)
        mt_true, mt_bg = tti_model(Fg.dom, c_true), tti_model(Fg.dom, c_bg)
        tres = Fg(mt_true) - Fg(mt_bg)  # a physical residual
        live(tres, "TTI residual")
        b = ct.launch_counts()
        gt_k = Fg.linearize(mt_true).H(tres)
        assert tdelta(b) == (0, 60, 60), tdelta(b)
        gt_p = Fgp.linearize(mt_true).H(tres)
        assert tdelta(b) == (0, 60, 60), "the plain route launched a kernel"
        log(21, f"TTI int8-stored gradient 256^3, nt=60, {cdt or 'f32'} coefficients: K12 "
                "60 + K13 60 launches; kernel vs plain route "
                + same(gt_k, gt_p, "(gc, geps, gdelta, gtheta, gphi)"))
    del gt_p, Fgp

    cshape = (32, 64, 128)
    csrc = int(np.ravel_multi_index((16, 32, 64), cshape))
    ckw = dict(dt=5e-4, dx=10.0, freq=15.0, sponge_width=6, src_idx=csrc,
               rcv_idx=[int(np.ravel_multi_index((16, 32, x), cshape))
                        for x in range(0, 128, 2)])
    r12 = torch.from_numpy(rs.standard_normal((12, 64)).astype(np.float32))
    for cdt in cdts:
        F12 = tti_wave_propagator(cshape, nt=12, store_adjoint="int8", coeff_dtype=cdt,
                                  **ckw)
        F12c = tti_wave_propagator(cshape, nt=12, store_adjoint="int8", coeff_dtype=cdt,
                                   device="cpu", **ckw)
        m12 = BlockVector((c_true[:32, :64, :128].contiguous(),
                           *(torch.full(cshape, v, device=dev) for v in (0.1, 0.05)),
                           0.2 + 0.1 * torch.rand(cshape, generator=gen, device=dev),
                           0.7 + 0.3 * torch.rand(cshape, generator=gen, device=dev)),
                          F12.dom)
        m_cpu = BlockVector(tuple(t.cpu() for t in m12.blocks), F12c.dom)
        b = ct.launch_counts()
        t0 = time.perf_counter()
        d12c, g12c = F12c(m_cpu), F12c.linearize(m_cpu).H(r12)
        t_cpu = time.perf_counter() - t0
        assert tdelta(b) == (0, 0, 0), "a CPU run launched a kernel"
        d12, g12 = F12(m12), F12.linearize(m12).H(r12.to(dev))
        assert tdelta(b) == (12, 12, 12), tdelta(b)
        g12 = BlockVector(tuple(t.cpu() for t in g12.blocks), F12c.dom)
        log(22, f"TTI card vs CPU at {cshape}, nt=12, {cdt or 'f32'} coefficients, random "
                f"tilt and azimuth fields (CPU {t_cpu:.1f} s): "
                + same(d12.cpu(), d12c, "traces") + "; " + same(g12, g12c, "int8 gradient"))
    del F12, F12c, m12, m_cpu, d12c, g12c, g12

    # at θ = φ = 0 the TTI system is the VTI one: K11's traces are K8's
    Ft0 = tti_wave_propagator(wshape, nt=60, src_idx=src0, **wkw)
    Fv0 = vti_wave_propagator(wshape, nt=60, src_idx=src0, **wkw)
    b = ct.launch_counts()
    dt0 = Ft0(tti_model(Ft0.dom, c_true, 0.0, 0.0))
    assert tdelta(b) == (60, 0, 0), tdelta(b)
    log(23, "TTI at theta = phi = 0 vs VTI on the card, 256^3, nt=60: "
            + same(dt0, Fv0(vti_model(Fv0.dom, c_true)), "traces"))
    del Ft0, Fv0, dt0

    Fb = tti_wave_propagator(wshape, nt=60, src_idx=src0, store_adjoint="f32", **wkw)
    mt_true = tti_model(Fb.dom, c_true)
    J = born_operator(Fb, mt_true)
    gb = torch.Generator().manual_seed(5)
    mb, db = J.dom.randn(gb), J.rng.randn(gb)
    b = ct.launch_counts()
    lhs, rhs = dot_product_test(J, mb, db)
    assert tdelta(b) == (60, 60, 60), tdelta(b)
    gate_t = abs(float(lhs) - float(rhs)) / abs(float(rhs))
    assert gate_t <= 1e-4, f"TTI Jacobian dot-product gate rel {gate_t}"
    Jm, Jd = J(mb), J.H(db)
    assert tdelta(b) == (120, 120, 120), tdelta(b)
    lhs64 = float(torch.vdot(db.double().reshape(-1), Jm.double().reshape(-1)))
    rhs64 = sum(float(torch.vdot(x.double().reshape(-1), y.double().reshape(-1)))
                for x, y in zip(Jd.blocks, mb.blocks))
    gate64 = abs(lhs64 - rhs64) / abs(rhs64)
    assert gate64 <= 1e-4, f"TTI Jacobian dot-product gate (f64 sums) rel {gate64}"
    del Jm, Jd, J, mb
    # the int8 history's gradient against the f32 history's, per block
    g32 = Fb.linearize(mt_true).H(tres)
    coss = []
    Fg8 = tti_wave_propagator(wshape, nt=60, src_idx=src0, store_adjoint="int8", **wkw)
    g8 = Fg8.linearize(mt_true).H(tres)
    for i, (x, y) in enumerate(zip(g8.blocks, g32.blocks)):
        live(y, f"f32-history gradient[{i}]")
        cos = _cosine(x, y)
        coss.append(cos)
        assert cos > 1.0 - 5e-2, f"int8 vs f32 history gradient[{i}] cosine {cos}"
    assert tdelta(b) == (120, 240, 240), tdelta(b)
    log(24, f"TTI Jacobian 256^3, nt=60, f32 history: dot-product gate rel {gate_t:.3e} "
            f"(<= 1e-4; <d, J m> = {float(lhs):.6g}), with f64 sums rel {gate64:.3e}; "
            "launches K11 60 (tangent through the autograd Function), K12 60 + K13 60 "
            "(adjoint), twice; int8 vs f32 history gradient cosines per block "
            + ", ".join(f"{c_:.6f}" for c_ in coss) + " (> 0.95)")
    del Fb, g32, Fg8, g8

    tmkw = dict(store_adjoint="int8", shot_map="map", **wkw)
    Ftm = multishot_tti_wave_operator(wshape, msrc[:2], nt=60, **tmkw)
    b = ct.launch_counts()
    dtm = Ftm(mt_true)
    assert tdelta(b) == (120, 0, 0), tdelta(b)
    gtm = Ftm.linearize(mt_true).H(torch.ones(dtm.shape, device=dev))
    assert tdelta(b) == (120, 120, 120), tdelta(b)
    n_tti = ct.launch_counts()
    dts = [tti_wave_propagator(wshape, nt=60, src_idx=int(sidx), **wkw)(mt_true)
           for sidx in msrc[:2]]
    g1 = [tti_wave_propagator(wshape, nt=60, src_idx=int(sidx), store_adjoint="int8",
                              **wkw).linearize(mt_true).H(torch.ones((60, 128), device=dev))
          for sidx in msrc[:2]]
    log(25, "TTI multishot 256^3, 2 shots, nt=60, map, int8: launches forward K11 120, "
            "gradient K12 120 + K13 120; " + same(dtm[0], dts[0], "shot 0 vs single shot")
            + "; " + same(dtm[1], dts[1], "shot 1 vs single shot") + "; "
            + same(gtm, g1[0] + g1[1], "2-shot gradient vs sum of single shots"))
    tti_path = {k: n_tti[k] for k in ("fused_tti_step", "fused_tti_hist_step",
                                      "fused_tti_adjoint_step")}
    for name, n in tti_path.items():
        assert n > 0, f"kernel {name} was not launched on the TTI path"
    del dtm, gtm, Ftm, dts, g1, tres

    # ---- phase 26: TTI times ------------------------------------------------------
    def tsingle(**kw):
        return lambda n: tti_wave_propagator(wshape, nt=n, src_idx=src0, **wkw, **kw)

    def tfwd(op, n):
        return op(mt_true)

    def tgrad(op, n):
        return op.linearize(mt_true).H(torch.ones(op.rng.shape, device=dev))

    tus = {}
    for cdt, tag in ((None, ""), (torch.bfloat16, "bf16_")):
        tus[f"tti3d_{tag}step_us"] = us_per_step(tsingle(coeff_dtype=cdt), tfwd, 10, 60)
        tus[f"tti3d_{tag}grad_step_us"] = us_per_step(
            tsingle(coeff_dtype=cdt, store_adjoint="int8"), tgrad, 10, 60)
        tus[f"tti3d_{tag}step_us_plain"] = us_per_step(
            tsingle(coeff_dtype=cdt, fused=False), tfwd, 10, 60, reps=1)
        tus[f"tti3d_{tag}grad_step_us_plain"] = us_per_step(
            tsingle(coeff_dtype=cdt, store_adjoint="int8", fused=False), tgrad, 10, 60,
            reps=1)
    tq8 = thist["int8"]
    tadj = {cdt: (ap1, aq1, ap2, aq2, vgC, vgah, vgav, *tacc, vC, *co, *tq8,
                  vdec["int8"][0], vdec["int8"][1], idx2, idx1, spz, spy, spx)
            for cdt, co in tco.items()}
    tkt = {}
    for cdt, co in tco.items():
        tag = "" if cdt == torch.float32 else " bf16"
        tkt["fused_tti_step" + tag] = (
            cuda_ms(lambda: ct.fused_tti_step(vpp, vp, vqp, vq, vC, *co, **tkw), 20),
            cuda_ms(lambda: ct.fused_tti_step_torch(vpp, vp, vqp, vq, vC, *co, **tkw), 20))
        tkt["fused_tti_hist_step" + tag] = (
            cuda_ms(lambda: ct.fused_tti_hist_step(vpp, vp, vqp, vq, vC, *co, qfp=qf8[0],
                                                   qfq=qf8[1], **tkw), 20),
            cuda_ms(lambda: ct.fused_tti_hist_step_torch(vpp, vp, vqp, vq, vC, *co,
                                                         qfp=qf8[0], qfq=qf8[1], **tkw), 20))
        tkt["fused_tti_adjoint_step" + tag] = (
            cuda_ms(lambda: ct.fused_tti_adjoint_step(*tadj[cdt]), 20),
            cuda_ms(lambda: ct.fused_tti_adjoint_step_torch(*tadj[cdt]), 20))
    for k in ("fused_tti_step", "fused_tti_hist_step", "fused_tti_adjoint_step"):
        kt[k] = tkt[k]
    kbytes["fused_tti_step"] = nbytes(vpp, vp, vqp, vq, vC, *tco[torch.float32], spz, spy,
                                      spx, vpp, vqp)
    kbytes["fused_tti_hist_step"] = kbytes["fused_tti_step"] + nbytes(*tq8)
    kbytes["fused_tti_adjoint_step"] = nbytes(*tadj[torch.float32][:18], spz, spy, spx,
                                              *tadj[torch.float32][2:10])
    tbounds = {}
    for cdt, co in tco.items():
        tag = "" if cdt == torch.float32 else " bf16"
        b11 = nbytes(vpp, vp, vqp, vq, vC, *co, spz, spy, spx, vpp, vqp)
        tbounds["fused_tti_step" + tag] = bound_ms(b11, vp.numel(), "fused_tti_step")[0]
        tbounds["fused_tti_hist_step" + tag] = bound_ms(b11 + nbytes(*tq8), vp.numel(),
                                                        "fused_tti_hist_step")[0]
        tbounds["fused_tti_adjoint_step" + tag] = bound_ms(
            nbytes(*tadj[cdt][:18], spz, spy, spx, *tadj[cdt][2:10]), vp.numel(),
            "fused_tti_adjoint_step")[0]
    Ftprof = tti_wave_propagator(wshape, nt=40, src_idx=src0, store_adjoint="int8", **wkw)
    tshares = {"forward": busy_share(lambda: Ftprof(mt_true)),
               "gradient": busy_share(lambda: tgrad(Ftprof, 40))}
    peak_all = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    tgrad(Ftprof, 40)
    tpeak_gib = torch.cuda.max_memory_allocated() / 2**30
    tlib = kernels.load_library("tti")
    for k, (a, _) in tkt.items():  # the kernel's card-side numbers, order 2
        kern, width = k.split(" ")[0], "bf16" if k.endswith("bf16") else "f32"
        tmpl = "tti_adjoint_kernel" if kern == "fused_tti_adjoint_step" else "tti_step_kernel"
        nreg, nspill, sstat = ptx.get((tmpl, 2), (None, None, 0))
        sdyn = int(tlib.jt_tti_smem_bytes(int(tmpl == "tti_adjoint_kernel"), 2))
        moved = 1e-3 * tbounds[k] * HBM_BYTES_PER_S
        log(26, f"{kern}, {width} coefficients, 256^3 order 2: {1e3 * a:.1f} us, bound "
                f"{1e3 * tbounds[k]:.1f} us (bytes), bound/time {tbounds[k] / a:.3f}, "
                f"{moved / (1e-3 * a) / 1e12:.3f} TB/s achieved; ptxas over the "
                f"template's instantiations: {nreg} registers, {nspill} spill bytes, "
                f"shared memory per block {sstat} B static + {sdyn} B dynamic [{smi}]")
    log(26, "TTI us/step (marginal nt 60 vs 10, CUDA events; bench.py's keys): "
            + ", ".join(f"{k} {v:.2f}" for k, v in tus.items())
            + "; kernel vs plain at 256^3 (int8 history; bound by bytes) "
            + ", ".join(f"{k} {1e3 * a:.1f} vs {1e3 * b_:.1f} us (bound "
                        f"{1e3 * tbounds[k]:.1f} us)" for k, (a, b_) in tkt.items())
            + "; device busy share under the profiler (nt=40): "
            + ", ".join(f"{k} {'not measured' if sh is None else f'{sh:.3f}'} of "
                        f"{wall:.2f} ms ({n} device events; top kernels, us total/"
                        f"count: " + "; ".join(f"{nm} {t:.0f}/{c}" for nm, (t, c) in top)
                        + ")"
                        for k, (sh, wall, n, top) in tshares.items())
            + f"; peak device memory of the nt=40 int8 gradient {tpeak_gib:.2f} GiB, "
            f"of the whole run before it {peak_all:.2f} GiB [{smi}]")

    del Ftprof

    # ---- phases 27-30: CG, CGLS and LSMR on the flagship, launches counted -----
    from jets_tpu_torch.solvers import cg, cgls, jacobi_preconditioner, lsmr, normal_operator

    kry = ("xw_update", "cg_update", "p_update", "lsmr_update", "lap3d_axpy_norm2")

    def sdelta(before):
        now = cs.launch_counts()
        return {k: now[k] - before[k] for k in kry if now[k] != before[k]}

    def decreased(res, n, what):
        h = res.history
        assert res.iterations == n, f"{what}: ran {res.iterations} of {n} iterations"
        assert bool(torch.isfinite(h).all()), f"{what}: history is not finite"
        assert float(res.resnorm) < float(h[0]), f"{what}: resnorm did not decrease"
        return (f"{what} history {float(h[0]):.6g} -> {float(h[-1]):.6g}, resnorm "
                f"{float(res.resnorm):.6g}")

    cs.reset_launch_counts()
    t0 = time.perf_counter()
    A, _, d = make_seismic_problem(grid3, nshots3, nrecv, seed=0, noise=0.05)
    wr = A.jet.state["bstate"]["wr"]
    N = normal_operator(A, damp=0.1)
    b = A.H(d)
    torch.cuda.synchronize()
    build3 = time.perf_counter() - t0
    c0 = cs.launch_counts()
    rcg = cg(N, b, maxiter=50, tol=0.0)
    assert sdelta(c0) == {"cg_update": 50, "p_update": 50}, sdelta(c0)
    msg = decreased(rcg, 50, "CG")
    A_cpu = seismic_operator_from_arrays(grid3, nshots3, nrecv, wr=wr.cpu(), device="cpu")
    c0 = cs.launch_counts()
    t0 = time.perf_counter()
    r_cpu = cg(normal_operator(A_cpu, damp=0.1), b.cpu(), maxiter=10, tol=0.0)
    t_cpu = time.perf_counter() - t0
    assert cs.launch_counts() == c0, "a CPU run launched a kernel"
    r_gpu = cg(N, b, maxiter=10, tol=0.0)
    assert sdelta(c0) == {"cg_update": 10, "p_update": 10}, sdelta(c0)
    dx_cg = rel(r_gpu.x.cpu(), r_cpu.x)
    assert dx_cg <= 1e-4, f"CG card vs CPU x rel {dx_cg}"
    gen_p = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    M = jacobi_preconditioner(A, generator=gen_p, nsamples=32)
    torch.cuda.synchronize()
    t_est = time.perf_counter() - t0
    c0 = cs.launch_counts()
    rpcg = cg(N, b, maxiter=50, tol=0.0, M=M)
    assert sdelta(c0) == {}, f"PCG launched a solver kernel: {sdelta(c0)}"
    msg_p = decreased(rpcg, 50, "PCG")
    rcgls = cgls(A, d, maxiter=50, tol=0.0)
    assert sdelta(c0) == {}, f"CGLS launched a solver kernel: {sdelta(c0)}"
    msg_l = decreased(rcgls, 50, "CGLS")
    log(27, f"3-D flagship {grid3} x {nshots3} shots x {nrecv} rcv (built in {build3:.2f} "
            f"s), normal operator damp 0.1, 50 iterations at tol 0: {msg}; K6a 50 + K6b "
            f"50 launches; card vs CPU at 10 iterations (CPU {t_cpu:.1f} s) ||dx||/||x|| "
            f"{dx_cg:.3e} (<= 1e-4); Jacobi diagonal from 32 probes in {t_est:.2f} s, "
            f"{msg_p}, no solver kernel launched; {msg_l}, no solver kernel launched")
    del r_cpu, r_gpu, rpcg, rcgls, M

    A_hook = seismic_operator_from_arrays(grid3, nshots3, nrecv, wr=wr, epilogue_hook=True)
    c0 = cs.launch_counts()
    rlp = lsmr(A, d, maxiter=50, tol=0.0)
    assert sdelta(c0) == {"lsmr_update": 50}, sdelta(c0)
    c1 = cs.launch_counts()
    rlh = lsmr(A_hook, d, maxiter=50, tol=0.0)
    assert sdelta(c1) == {"lsmr_update": 50, "lap3d_axpy_norm2": 50}, sdelta(c1)
    msgs = []
    for res, what in ((rlp, "LSMR"), (rlh, "LSMR hooked")):
        msgs.append(decreased(res, 50, what))
        # |zetabar_k| = |sbar_k|·|zetabar_{k-1}| with |sbar_k| <= 1 (hypot)
        assert bool((res.history[1:] <= res.history[:-1]).all()), f"{what} increased"
    hx = rel(rlh.x, rlp.x)
    assert hx <= 1e-4, f"LSMR hooked vs plain x rel {hx}"
    c0 = cs.launch_counts()
    r_cpu = lsmr(A_cpu, d.cpu(), maxiter=10, tol=0.0)
    assert cs.launch_counts() == c0, "a CPU run launched a kernel"
    r_gpu = lsmr(A, d, maxiter=10, tol=0.0)
    assert sdelta(c0) == {"lsmr_update": 10}, sdelta(c0)
    dx_l = rel(r_gpu.x.cpu(), r_cpu.x)
    assert dx_l <= 1e-4, f"LSMR card vs CPU x rel {dx_l}"
    log(28, f"LSMR 3-D 50 iterations, plain and hooked: K7 50 + 50, K2 50 (hooked) "
            f"launches; {'; '.join(msgs)}; |zetabar| finite and non-increasing; "
            f"||x_hook - x||/||x|| "
            f"{hx:.3e} (<= 1e-4); card vs CPU at 10 iterations ||dx||/||x|| {dx_l:.3e} "
            "(<= 1e-4)")
    del A_cpu, r_cpu, r_gpu, rlp, rlh, rcg

    t0 = time.perf_counter()
    A2, _, d2 = make_seismic_problem((2048, 2048), 64, nrecv, seed=0, noise=0.05)
    N2, b2 = normal_operator(A2, damp=0.1), A2.H(d2)
    c0 = cs.launch_counts()
    msg = decreased(cg(N2, b2, maxiter=100, tol=0.0), 100, "CG")
    assert sdelta(c0) == {"cg_update": 100, "p_update": 100}, sdelta(c0)
    c1 = cs.launch_counts()
    msg_l = decreased(lsmr(A2, d2, maxiter=100, tol=0.0), 100, "LSMR")
    assert sdelta(c1) == {"lsmr_update": 100}, sdelta(c1)
    log(29, f"2-D (2048^2, 64 shots, {nrecv} rcv) 100 iterations each in "
            f"{time.perf_counter() - t0:.2f} s incl. build: {msg}; {msg_l}; K6a 100 + K6b "
            "100, K7 100 launches")
    krylov_path = {k: cs.launch_counts()[k] for k in ("cg_update", "p_update",
                                                      "lsmr_update")}
    for name, n in krylov_path.items():
        assert n > 0, f"kernel {name} was not launched on the Krylov paths"

    kms = {"cg_3d": ms_per_iter(cg, N, b, 10, 60),
           "cgls_3d": ms_per_iter(cgls, A, d, 10, 60),
           "lsmr_3d": ms_per_iter(lsmr, A, d, 10, 60),
           "lsmr_3d_hooked": ms_per_iter(lsmr, A_hook, d, 10, 60),
           "cg_2d": ms_per_iter(cg, N2, b2, 20, 120),
           "cgls_2d": ms_per_iter(cgls, A2, d2, 20, 120),
           "lsmr_2d": ms_per_iter(lsmr, A2, d2, 20, 120)}
    del A, A_hook, A2, N, N2, b, b2, d, d2
    x, r, p, q, h, hb = (rnd(grid3) for _ in range(6))
    kt["cg_update"] = (cuda_ms(lambda: cs.cg_update(x, r, p, q, alpha), 20),
                       cuda_ms(lambda: cs.cg_update_torch(x, r, p, q, alpha), 20))
    kt["p_update"] = (cuda_ms(lambda: cs.p_update(r, p, beta), 20),
                      cuda_ms(lambda: cs.p_update_torch(r, p, beta), 20))
    kt["lsmr_update"] = (cuda_ms(lambda: cs.lsmr_update(q, h, hb, x, *lsc), 20),
                         cuda_ms(lambda: cs.lsmr_update_torch(q, h, hb, x, *lsc), 20))
    # the one PyTorch call that computes K6b's function (timed as a yardstick)
    am = torch.addcmul(r, beta, p)
    am_rel = rel(am, cs.p_update_torch(r, p.clone(), beta))
    assert am_rel <= 1e-6, f"addcmul vs K6b rel {am_rel}"
    lib_ms["p_update"] = cuda_ms(lambda: torch.addcmul(r, beta, p), 20)
    kbytes["cg_update"] = nbytes(x, r, p, q, x, r)
    kbytes["p_update"] = nbytes(r, p, p)
    kbytes["lsmr_update"] = nbytes(q, h, hb, x, h, hb, x)
    del x, r, p, q, h, hb, am
    log(30, "Krylov ms/iter (marginal, CUDA events): "
            + ", ".join(f"{k} {v:.4f}" for k, v in kms.items())
            + "; kernel vs plain at 256^3 "
            + ", ".join(f"{k} {1e3 * kt[k][0]:.1f} vs {1e3 * kt[k][1]:.1f} us (bound "
                        f"{1e3 * bound_ms(kbytes[k], 256 ** 3, k)[0]:.1f} us)"
                        for k in ("cg_update", "p_update", "lsmr_update"))
            + f"; addcmul (the library call for K6b, rel {am_rel:.1e}) "
            f"{1e3 * lib_ms['p_update']:.1f} us [{smi}]")

    # ---- phases 31-37: the constant-Q path, launches counted --------------------
    from jets_tpu_torch.ops.wave import q_wave_propagator

    def qdelta(before):
        return cw.launch_counts()["fused_q_step"] - before["fused_q_step"]

    # Q = 50 with one smooth seeded low-Q anomaly down to 25; f0 = 15 Hz
    (qz, qy, qx), qsig = rs.uniform(64, 192, 3), 24.0
    gz, gy, gx = (torch.exp(-0.5 * ((axis - float(o)) / qsig) ** 2) for o in (qz, qy, qx))
    q_true = 50.0 - 25.0 * (gz[:, None, None] * gy[None, :, None] * gx[None, None, :])
    qkw = dict(src_idx=src0, f0=15.0, **wkw)

    def q_model(dom, c, qf):
        return BlockVector((c, qf), dom)

    cw.reset_launch_counts()
    for cdt in cdts:
        Fq = q_wave_propagator(wshape, nt=220, coeff_dtype=cdt, **qkw)
        mq = q_model(Fq.dom, c_true, q_true)
        b_ = cw.launch_counts()
        dq_k = Fq(mq)
        assert qdelta(b_) == 220, qdelta(b_)
        dq_p = q_wave_propagator(wshape, nt=220, coeff_dtype=cdt, fused=False, **qkw)(mq)
        assert qdelta(b_) == 220, "the plain route launched a kernel"
        assert dq_k.shape == (220, 128)
        log(31, f"Q forward 256^3, nt=220, {cdt or 'f32'} friction field, (c, Q) = (1500 + "
                "anomalies, 50 with a low-Q anomaly to 25), f0 15 Hz: K14 launched 220 "
                "times; kernel vs plain route " + same(dq_k, dq_p, "traces"))
    del dq_k, dq_p

    Fg = q_wave_propagator(wshape, nt=120, store_adjoint="int8", **qkw)
    Fgp = q_wave_propagator(wshape, nt=120, store_adjoint="int8", fused=False, **qkw)
    mq_true = q_model(Fg.dom, c_true, q_true)
    mq_bg = q_model(Fg.dom, c_bg, torch.full(wshape, 50.0, device=dev))
    qres = Fg(mq_true) - Fg(mq_bg)  # a physical residual
    live(qres, "Q residual")
    b_ = cw.launch_counts()
    gq_k = Fg.linearize(mq_true).H(qres)
    assert qdelta(b_) == 120, qdelta(b_)
    gq_p = Fgp.linearize(mq_true).H(qres)
    assert qdelta(b_) == 120, "the plain route launched a kernel"
    log(32, "Q int8-stored gradient 256^3, nt=120: K14 120 launches (the forward sweep; "
            "the reverse sweep is plain); kernel vs plain route "
            + same(gq_k, gq_p, "(gc, gQ)"))
    del gq_p, Fgp

    Fq12 = q_wave_propagator(cshape, nt=12, store_adjoint="int8", f0=15.0, **ckw)
    Fq12c = q_wave_propagator(cshape, nt=12, store_adjoint="int8", f0=15.0, device="cpu",
                              **ckw)
    Fa12 = q_wave_propagator(cshape, nt=12, f0=15.0, **ckw)
    Fa12c = q_wave_propagator(cshape, nt=12, f0=15.0, device="cpu", **ckw)
    m12 = q_model(Fq12.dom, c_true[:32, :64, :128].contiguous(),
                  q_true[:32, :64, :128].contiguous())
    m_cpu = BlockVector(tuple(t.cpu() for t in m12.blocks), Fq12c.dom)
    b_ = cw.launch_counts()
    t0 = time.perf_counter()
    d12c, g12c, a12c = (Fq12c(m_cpu), Fq12c.linearize(m_cpu).H(r12),
                        Fa12c.linearize(m_cpu).H(r12))
    t_cpu = time.perf_counter() - t0
    assert qdelta(b_) == 0, "a CPU run launched a kernel"
    d12, g12, a12 = (Fq12(m12), Fq12.linearize(m12).H(r12.to(dev)),
                     Fa12.linearize(m12).H(r12.to(dev)))
    assert qdelta(b_) == 36, qdelta(b_)
    log(33, f"Q card vs CPU at {cshape}, nt=12 (CPU {t_cpu:.1f} s): "
            + agree(d12.cpu(), d12c, "traces", 1e-5) + "; "
            + "; ".join(agree(x_.cpu(), y_, f"{nm}[{i}]", 1e-5)
                        for nm, gg_, cc_ in (("int8 gradient", g12, g12c),
                                             ("autodiff adjoint (_QStep.backward)", a12,
                                              a12c))
                        for i, (x_, y_) in enumerate(zip(gg_.blocks, cc_.blocks))))
    del Fq12, Fq12c, Fa12, Fa12c, m12, m_cpu, d12c, g12c, a12c, d12, g12, a12

    # at Q = inf (g = 0) K14 is K4 bit for bit
    Fq0 = q_wave_propagator(wshape, nt=60, **qkw)
    Fw0 = wave_propagator(wshape, nt=60, src_idx=src0, **wkw)
    b_ = cw.launch_counts()
    dq0 = Fq0(q_model(Fq0.dom, c_true, torch.full(wshape, float("inf"), device=dev)))
    assert qdelta(b_) == 60, qdelta(b_)
    log(34, "Q = inf vs the lossless wave_propagator on the card, 256^3, nt=60: "
            + same(dq0, Fw0(c_true), "traces"))
    del Fq0, Fw0, dq0

    Fb = q_wave_propagator(wshape, nt=60, store_adjoint="f32", **qkw)
    J = born_operator(Fb, mq_true)
    gb = torch.Generator().manual_seed(6)
    mb, db = J.dom.randn(gb), J.rng.randn(gb)
    b_ = cw.launch_counts()
    lhs, rhs = dot_product_test(J, mb, db)
    assert qdelta(b_) == 120, qdelta(b_)
    gate_q = abs(float(lhs) - float(rhs)) / abs(float(rhs))
    assert gate_q <= 1e-4, f"Q Jacobian dot-product gate rel {gate_q}"
    Jm, Jd = J(mb), J.H(db)
    lhs64 = float(torch.vdot(db.double().reshape(-1), Jm.double().reshape(-1)))
    rhs64 = sum(float(torch.vdot(x_.double().reshape(-1), y_.double().reshape(-1)))
                for x_, y_ in zip(Jd.blocks, mb.blocks))
    gate64 = abs(lhs64 - rhs64) / abs(rhs64)
    assert gate64 <= 1e-4, f"Q Jacobian dot-product gate (f64 sums) rel {gate64}"
    del Jm, Jd, J, mb
    qres60 = Fb(mq_true) - Fb(mq_bg)
    g32 = Fb.linearize(mq_true).H(qres60)
    g8 = q_wave_propagator(wshape, nt=60, store_adjoint="int8", **qkw).linearize(
        mq_true).H(qres60)
    qcos = []
    for i, (x_, y_) in enumerate(zip(g8.blocks, g32.blocks)):
        live(y_, f"Q f32-history gradient[{i}]")
        cos = _cosine(x_, y_)
        qcos.append(cos)
        assert cos > 1.0 - 5e-2, f"Q int8 vs f32 history gradient[{i}] cosine {cos}"
    log(35, f"Q Jacobian 256^3, nt=60, f32 history: dot-product gate rel {gate_q:.3e} "
            f"(<= 1e-4; <d, J m> = {float(lhs):.6g}), with f64 sums rel {gate64:.3e}; "
            "launches K14 60 (tangent through _QStep) + 60 (the adjoint's forward sweep); "
            "int8 vs f32 history gradient cosines (c, Q) "
            + ", ".join(f"{c_:.6f}" for c_ in qcos) + " (> 0.95)")
    del Fb, g32, g8, qres60
    q_path = {"fused_q_step": cw.launch_counts()["fused_q_step"]}
    assert q_path["fused_q_step"] > 0, "kernel fused_q_step was not launched on the Q path"

    # ---- phase 36: Q times ----------------------------------------------------------
    def qsingle(**kw):
        return lambda n: q_wave_propagator(wshape, nt=n, **qkw, **kw)

    def qfwd(op, n):
        return op(mq_true)

    def qgrad(op, n):
        return op.linearize(mq_true).H(torch.ones(op.rng.shape, device=dev))

    qus = {}
    for cdt, tag in ((None, ""), (torch.bfloat16, "bf16_")):
        qus[f"q3d_{tag}step_us"] = us_per_step(qsingle(coeff_dtype=cdt), qfwd, 20, 220)
        qus[f"q3d_{tag}step_us_plain"] = us_per_step(qsingle(coeff_dtype=cdt, fused=False),
                                                     qfwd, 20, 220)
    qus["q3d_grad_step_us"] = us_per_step(qsingle(store_adjoint="int8"), qgrad, 20, 120)
    qus["q3d_grad_step_us_plain"] = us_per_step(
        qsingle(store_adjoint="int8", fused=False), qgrad, 20, 120, reps=1)
    qkt, qbounds = {}, {}
    for gdt, gg in gq.items():
        tag = "" if gdt == torch.float32 else " bf16"
        qkt["fused_q_step" + tag] = (
            cuda_ms(lambda: cw.fused_q_step(up, u, c2, gg, spz, spy, spx, s_t, src_flat,
                                            amp), 20),
            cuda_ms(lambda: cw.fused_q_step_torch(up, u, c2, gg, spz, spy, spx, s_t,
                                                  src_flat, amp), 20))
        qbounds["fused_q_step" + tag] = bound_ms(
            nbytes(up, u, c2, gg, spz, spy, spx, up), up.numel(), "fused_q_step")[0]
    kt["fused_q_step"] = qkt["fused_q_step"]
    kbytes["fused_q_step"] = nbytes(up, u, c2, gq[torch.float32], spz, spy, spx, up)
    Fqprof = q_wave_propagator(wshape, nt=40, store_adjoint="int8", **qkw)
    qshares = {"forward": busy_share(lambda: Fqprof(mq_true)),
               "gradient": busy_share(lambda: qgrad(Fqprof, 40))}
    log(36, "Q us/step (marginal, CUDA events): "
            + ", ".join(f"{k} {v:.2f}" for k, v in qus.items())
            + "; kernel vs plain at 256^3 (bound by bytes) "
            + ", ".join(f"{k} {1e3 * a:.1f} vs {1e3 * b_:.1f} us (bound "
                        f"{1e3 * qbounds[k]:.1f} us)" for k, (a, b_) in qkt.items())
            + "; device busy share under the profiler (nt=40): "
            + ", ".join(f"{k} {'not measured' if sh is None else f'{sh:.3f}'} of "
                        f"{wall:.2f} ms ({n} device events; top kernels, us total/"
                        f"count: " + "; ".join(f"{nm} {t:.0f}/{c}" for nm, (t, c) in top)
                        + ")"
                        for k, (sh, wall, n, top) in qshares.items())
            + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"[{smi}]")
    del Fqprof

    main_path.update(wave_path)
    main_path.update(vti_path)
    main_path.update(tti_path)
    main_path.update(krylov_path)
    main_path.update(q_path)
    log(37, f"paths 1-6 done in {time.perf_counter() - t_start:.1f} s, kernel build "
            "included")
    for k, n in baseline_configs(smi).items():
        main_path[k] += n
    for k, n in fwi_inversion(smi, c_true, wkw).items():
        main_path[k] += n
    for k, n in other_physics(smi, c_true, q_true, wkw).items():
        main_path[k] += n
    for k, n in dsp_path(smi).items():
        main_path[k] += n
    for k, n in vmap_remat(smi, c_true, wkw).items():
        main_path[k] += n
    for k, n in utils_path(smi, c_true, wkw).items():
        main_path[k] += n
    for k, n in distribution(smi, c_true, src0, wkw, flagship_ref).items():
        main_path[k] += n
    for k, n in block_by_grid(smi, c_true, src0, wkw, flagship_ref).items():
        main_path[k] += n
    sources = {"solver": "jets_tpu_torch/csrc/solver_kernels.cu",
               "wave": "jets_tpu_torch/csrc/wave_kernels.cu",
               "vti": "jets_tpu_torch/csrc/vti_kernels.cu",
               "tti": "jets_tpu_torch/csrc/tti_kernels.cu"}
    replaces = {
        "xw_update": ("solver", "jets_tpu/ops/pallas_solver.py:104"),
        "lap3d_axpy_norm2": ("solver", "jets_tpu/ops/pallas_solver.py:410"),
        "laplacian3d": ("solver", "jets_tpu/ops/pallas_solver.py:446"),
        "fused_leapfrog_step": ("wave", "jets_tpu/ops/pallas_wave.py:274"),
        "fused_adjoint_step": ("wave", "jets_tpu/ops/pallas_wave.py:1203"),
        "fused_vti_step": ("vti", "jets_tpu/ops/pallas_wave.py:501"),
        "fused_vti_hist_step": ("vti", "jets_tpu/ops/pallas_wave.py:544"),
        "fused_vti_adjoint_step": ("vti", "jets_tpu/ops/pallas_wave.py:1660"),
        "fused_tti_step": ("tti", "jets_tpu/ops/pallas_wave.py:869"),
        "fused_tti_hist_step": ("tti", "jets_tpu/ops/pallas_wave.py:922"),
        "fused_tti_adjoint_step": ("tti", "jets_tpu/ops/pallas_wave.py:2014"),
        "cg_update": ("solver", "jets_tpu/ops/pallas_solver.py:241"),
        "p_update": ("solver", "jets_tpu/ops/pallas_solver.py:273"),
        "lsmr_update": ("solver", "jets_tpu/ops/pallas_solver.py:177"),
        "fused_q_step": ("wave", "jets_tpu/ops/pallas_wave.py:1425"),
    }
    assert len(replaces) == 15 and all(main_path[k] > 0 for k in replaces), main_path
    log(61, f"chip_smoke total {time.perf_counter() - t_start:.1f} s, kernel build "
            f"included")
    rows = []
    for k, (lib, where) in replaces.items():
        bms, by = bound_ms(kbytes[k], 256 ** 3, k)
        rows.append({"name": k, "route": "cuda", "source": sources[lib], "replaces": where,
                     "launches": main_path[k], "max_abs_err": err[k], "ms": kt[k][0],
                     "plain_ms": kt[k][1], "bound_ms": bms, "bound_by": by,
                     "library_ms": lib_ms.get(k)})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # one rank of phase 66, started by main
        sys.exit(rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--rank2d"]:  # one rank of phase 68, started by main
        sys.exit(rank2d_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
