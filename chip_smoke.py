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
4096 receivers). Every phase asserts; a failure raises and exits non-zero.
The last lines are a JSON object of the kernels (route, source, launches
on the main path, error against the plain version, times), the card's
name and power limit from ``nvidia-smi``, and the result line
``{"ok": true, "device": {...}}``.

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

import torch


def log(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


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
    from jets_tpu_torch.solvers import lsqr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    # ---- phase 0: environment and kernel build -------------------------------
    t0 = time.perf_counter()
    kernels.load_library()
    build_s = time.perf_counter() - t0
    regs = re.findall(r"Used (\d+) registers", kernels.build_log or "")
    spills = re.findall(r"(\d+) bytes spill stores", kernels.build_log or "")
    log(0, f"python {sys.version.split()[0]} torch {torch.__version__} "
           f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
           f"count {torch.cuda.device_count()} | nvidia-smi: {smi} | "
           f"kernel build+load {build_s:.2f} s (nvcc {kernels.build_seconds}) "
           f"registers {regs} spill stores {spills}")

    # ---- phase 1: each kernel against its plain version ----------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev)

    scal = [torch.tensor(v, device=dev) for v in (0.37, -0.21, 1.7)]
    err = {"xw_update": 0.0, "lap3d_axpy_norm2": 0.0, "laplacian3d": 0.0}
    # the main path's shapes, then an odd length (vector path + scalar tail)
    # and its offset views (the unaligned scalar path)
    for shape, off in [((256, 256, 256), 0), ((2048, 2048), 0), ((1000003,), 0),
                       ((1000003,), 1)]:
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
    z, v = rnd((256, 256, 256)), rnd((256, 256, 256))
    lap_k, lap_p = cs.laplacian3d(z), cs.laplacian3d_torch(z)
    torch.cuda.synchronize()
    assert torch.equal(lap_k, lap_p), "K3 not bitwise"
    err["laplacian3d"] = float((lap_k - lap_p).abs().max())
    s = torch.tensor(-0.43, device=dev)
    vh_k, n2_k = cs.lap3d_axpy_norm2(z, v, s)
    vh_p, _ = cs.lap3d_axpy_norm2_torch(z, v, s)
    torch.cuda.synchronize()
    assert torch.equal(vh_k, vh_p), "K2 vh not bitwise"
    err["lap3d_axpy_norm2"] = float((vh_k - vh_p).abs().max())
    n2_ref = float(torch.sum(vh_p.double() ** 2))
    n2_rel = abs(float(n2_k) - n2_ref) / n2_ref
    assert n2_rel <= 1e-5, f"K2 n2 rel err {n2_rel}"
    log(1, f"K1 bitwise at 256^3, 2048^2 and 1000003 aligned/unaligned (in place); "
           f"K3 bitwise at 256^3; K2 vh bitwise, n2 rel err {n2_rel:.3e} vs f64 "
           f"(<= 1e-5); max_abs_err {err}")
    del x, w, vh, xp, wp, xk, wk, ro, rw, lap_k, lap_p, vh_k, vh_p

    # ---- phase 2: the 3-D flagship at full width -----------------------------
    grid3, nshots3, nrecv = (256, 256, 256), 16, 4096
    t0 = time.perf_counter()
    A, m_true, d = make_seismic_problem(grid3, nshots3, nrecv, seed=0, noise=0.05,
                                        device=dev)
    torch.cuda.synchronize()
    build3 = time.perf_counter() - t0
    wr = A.jet.state["bstate"]["wr"]
    g = torch.Generator().manual_seed(1)
    mt, dt = A.dom.randn(g), A.rng.randn(g)
    lhs, rhs = dot_product_test(A, mt, dt)
    gate = abs(float(lhs) - float(rhs)) / abs(float(rhs))
    assert gate <= 1e-4, f"dot-product gate rel {gate}"
    Ac = seismic_operator_from_arrays(grid3, nshots3, nrecv, wr=wr, impl="composed",
                                      device=dev)
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
    c3 = cs.launch_counts()
    assert c3["xw_update"] - c0["xw_update"] == 50, c3
    check_history(r3, 50, dnorm, 3)
    log(3, f"lsqr 3-D 50 iterations: launches {c3}")

    A_hook = seismic_operator_from_arrays(grid3, nshots3, nrecv, wr=wr,
                                          epilogue_hook=True, device=dev)
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
    A2, _, d2 = make_seismic_problem((2048, 2048), 64, nrecv, seed=0, noise=0.05,
                                     device=dev)
    d2norm = float(torch.linalg.vector_norm(d2))
    r6 = lsqr(A2, d2, maxiter=100, tol=0.0)
    c6 = cs.launch_counts()
    assert c6["xw_update"] - c5["xw_update"] == 100, c6
    check_history(r6, 100, d2norm, 6)
    log(6, f"lsqr 2-D (2048^2, 64 shots, {nrecv} rcv) 100 iterations in "
           f"{time.perf_counter() - t0:.2f} s incl. build: launches {c6}")
    main_path = cs.launch_counts()
    for name, n in main_path.items():
        assert n > 0, f"kernel {name} was not launched on the main path"

    # ---- phase 7: times -------------------------------------------------------
    def lsqr_ms_per_iter(op, rhs, lo, hi, reps=3):
        def run(n):
            s0 = torch.cuda.Event(enable_timing=True)
            s1 = torch.cuda.Event(enable_timing=True)
            s0.record()
            res = lsqr(op, rhs, maxiter=n, tol=0.0)
            s1.record()
            torch.cuda.synchronize()
            assert res.iterations == n
            return s0.elapsed_time(s1)

        run(lo)  # warm-up
        t_lo = sorted(run(lo) for _ in range(reps))[reps // 2]
        t_hi = sorted(run(hi) for _ in range(reps))[reps // 2]
        return (t_hi - t_lo) / (hi - lo)

    ms3 = lsqr_ms_per_iter(A, d, 10, 60)
    ms3h = lsqr_ms_per_iter(A_hook, d, 10, 60)
    ms2 = lsqr_ms_per_iter(A2, d2, 20, 120)

    x, w, vh = rnd(grid3), rnd(grid3), rnd(grid3)
    kt = {
        "xw_update": (cuda_ms(lambda: cs.xw_update(x, w, vh, *scal), 20),
                      cuda_ms(lambda: cs.xw_update_torch(x, w, vh, *scal), 20)),
        "lap3d_axpy_norm2": (cuda_ms(lambda: cs.lap3d_axpy_norm2(z, v, s), 20),
                             cuda_ms(lambda: cs.lap3d_axpy_norm2_torch(z, v, s), 20)),
        "laplacian3d": (cuda_ms(lambda: cs.laplacian3d(z), 20),
                        cuda_ms(lambda: cs.laplacian3d_torch(z), 20)),
    }
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(7, f"3-D LSQR {ms3:.4f} ms/iter, hooked {ms3h:.4f} ms/iter; 2-D LSQR "
           f"{ms2:.4f} ms/iter ({1e3 / ms2:.1f} iter/s); kernel vs plain at 256^3 "
           + ", ".join(f"{k} {1e3 * a:.1f} vs {1e3 * b:.1f} us" for k, (a, b) in kt.items())
           + f"; peak device memory {peak_gib:.2f} GiB [{smi}]")

    src = "jets_tpu_torch/csrc/solver_kernels.cu"
    replaces = {
        "xw_update": "jets_tpu/ops/pallas_solver.py:104",
        "lap3d_axpy_norm2": "jets_tpu/ops/pallas_solver.py:410",
        "laplacian3d": "jets_tpu/ops/pallas_solver.py:446",
    }
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": main_path[k], "max_abs_err": err[k],
         "ms": kt[k][0], "plain_ms": kt[k][1]}
        for k in ("xw_update", "lap3d_axpy_norm2", "laplacian3d")
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
