#!/usr/bin/env python3
"""Time the TTI kernels K11, K12 and K13 of the repository's
``jets_tpu_torch/csrc/tti_kernels.cu`` against other builds of it on one
CUDA card, in turns.

    python3 tools/compare_tti_kernels.py OTHER.cu [OTHER2.cu ...]
        [--orders 2 4 8] [--reps 20] [--shape 256 256 256] [--json OUT.json]

Each ``OTHER.cu`` is another revision of the source, for example one
unpacked with ``git show REV:jets_tpu_torch/csrc/tti_kernels.cu``. All are
built with the flags of :mod:`jets_tpu_torch.kernels` (one ``nvcc`` each,
started together), all are held bitwise against the plain versions at the
timed shape, then each kernel, order and coefficient width (int8
histories) is timed with CUDA events over ``--reps`` calls in the order
other, repo, repo, other for each other build. Prints ptxas registers,
spills and static shared memory of every build, one line per timing with
its bound (bytes over 3.35 TB/s) and achieved bytes per second, and the
card's name and power limit; ``--json`` writes the same to a file.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory


def ptxas(text):
    """``{(kernel, order): (max registers, spill bytes, static smem, registers
    of each instantiation...)}`` from nvcc's ``-Xptxas=-v`` output."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"(tti_step_kernel|tti_adjoint_kernel)ILi(\d+)E", m.group(1))
            fn = (name.group(1), int(name.group(2))) if name else None
        if fn is None:
            continue
        r = out.setdefault(fn, [0, 0, 0])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            r[1] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            r[0] = max(r[0], int(m.group(1)))
            r.append(int(m.group(1)))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            r[2] = max(r[2], int(m.group(1)))
    return {k: tuple(v) for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="+")
    ap.add_argument("--orders", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shape", type=int, nargs=3, default=[256, 256, 256])
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_tti_kernels: needs a CUDA card")
    from jets_tpu_torch import kernels
    from jets_tpu_torch.ops import cuda_tti as ct

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, builds = [], {}
    for path in args.other:
        so = kernels.BUILD_DIR / (
            f"tti_other_{hashlib.sha256(path.read_bytes()).hexdigest()[:16]}.so")
        builds[path.stem] = so
        if not so.is_file():
            procs.append((path, so, subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    kernels.build_all(["tti"])
    for path, so, proc in procs:
        so.with_suffix(".log").write_text(proc.communicate()[0])
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {path}:\n{so.with_suffix('.log').read_text()}")
    libs = {"repo": kernels.load_library("tti")}
    regs = {"repo": ptxas(kernels.nvcc_log("tti"))}
    for name, so in builds.items():
        libs[name] = ctypes.CDLL(str(so))
        regs[name] = ptxas(so.with_suffix(".log").read_text())
        for fname, (argtypes, restype) in kernels._SIGNATURES["tti"].items():
            if hasattr(libs[name], fname):  # an older source may lack a query
                fn = getattr(libs[name], fname)
                fn.argtypes, fn.restype = argtypes, restype
    for k in sorted({k for r in regs.values() for k in r}):
        print(f"ptxas {k[0]} order {k[1]} (registers, spill bytes, static smem): "
              + ", ".join(f"{n} {r.get(k)}" for n, r in regs.items()), flush=True)

    def use(which):
        kernels._libs["tti"] = libs[which]

    dev = torch.device("cuda")
    shape = tuple(args.shape)
    D, H, W = shape
    rk = np.random.default_rng(7)

    def npf(draw):
        return torch.from_numpy(draw(shape).astype(np.float32)).to(dev)

    pp, p, qp, q, ap1, aq1, ap2, aq2, *accs = (npf(rk.standard_normal) for _ in range(14))
    c = npf(lambda n: rk.uniform(1400.0, 4500.0, n))
    C = (c * c) * (5e-4 * 5e-4)
    ah = 1.0 + 2.0 * npf(lambda n: rk.uniform(0.0, 0.3, n))
    av = torch.sqrt(1.0 + 2.0 * npf(lambda n: rk.uniform(-0.1, 0.2, n)))
    th = npf(lambda n: rk.uniform(-0.6, 0.6, n)).double()
    az = npf(lambda n: rk.uniform(-3.0, 3.0, n)).double()
    axis = (torch.cos(th).float(), torch.sin(th).float() * torch.cos(az).float(),
            torch.sin(th).float() * torch.sin(az).float())
    del th, az, c
    co = {"f32": (ah, av, *axis)}
    co["bf16"] = tuple(t.to(torch.bfloat16) for t in co["f32"])
    spz, spy, spx = (torch.linspace(lo, 1.0, n, device=dev)
                     for lo, n in ((0.9, D), (0.8, H), (0.7, W)))
    sc = torch.stack([p.abs().amax(), q.abs().amax()])
    qf, dec = torch.full_like(sc, 127.0) / sc, sc / torch.full_like(sc, 127.0)
    kw = dict(spz=spz, sy=spy, sx=spx, inv_dx2=torch.tensor(0.01, device=dev),
              inv_dx=torch.tensor(0.1, device=dev), s_t=torch.tensor(-0.37, device=dev),
              src_idx=((D // 2) * H + H // 2) * W + W // 2,
              amp=torch.tensor(2.5e-7, device=dev))

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    codes = ct.fused_tti_hist_step_torch(pp, p, qp, q, C, *co["f32"], qfp=qf[0], qfq=qf[1],
                                         **kw)[2:4]
    calls = {}
    for w, cf in co.items():
        b11 = nbytes(pp, p, qp, q, C, *cf, spz, spy, spx, pp, qp)
        adj = (ap1, aq1, ap2, aq2, *accs, C, *cf, *codes, dec[0], dec[1], kw["inv_dx2"],
               kw["inv_dx"], spz, spy, spx)
        for order in args.orders:
            calls[("fused_tti_step", w, order)] = (
                lambda cf=cf, o=order: ct.fused_tti_step(pp, p, qp, q, C, *cf, order=o, **kw),
                lambda cf=cf, o=order: ct.fused_tti_step_torch(pp, p, qp, q, C, *cf, order=o,
                                                               **kw), b11)
            calls[("fused_tti_hist_step", w, order)] = (
                lambda cf=cf, o=order: ct.fused_tti_hist_step(
                    pp, p, qp, q, C, *cf, qfp=qf[0], qfq=qf[1], order=o, **kw),
                lambda cf=cf, o=order: ct.fused_tti_hist_step_torch(
                    pp, p, qp, q, C, *cf, qfp=qf[0], qfq=qf[1], order=o, **kw),
                b11 + nbytes(*codes))
            calls[("fused_tti_adjoint_step", w, order)] = (
                lambda adj=adj, o=order: ct.fused_tti_adjoint_step(*adj, order=o),
                lambda adj=adj, o=order: ct.fused_tti_adjoint_step_torch(*adj, order=o),
                nbytes(*adj[:18], spz, spy, spx, *adj[2:10]))
    for key, (kern, ref_fn, _) in calls.items():
        ref = ref_fn()
        for which in libs:
            use(which)
            got = kern()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), (which, key)
        del ref, got
    print(f"both builds bitwise against the plain versions at {shape}, orders "
          f"{args.orders}, f32 and bf16 coefficients, int8 histories", flush=True)

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(args.reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / args.reps

    rows = []
    for (name, w, order), (kern, _, nb) in calls.items():
        t = {k: [] for k in libs}
        for other in builds:
            for which in (other, "repo", "repo", other):
                use(which)
                t[which].append(cuda_ms(kern))
        bound = 1e3 * nb / HBM_BYTES_PER_S
        row = {"kernel": name, "coeffs": w, "order": order, "bound_ms": bound,
               "ms": t, "TBps": {k: [nb / (1e9 * x) for x in v] for k, v in t.items()}}
        rows.append(row)
        print(f"{name} {w} coeffs order {order}, bound {1e3 * bound:.1f} us: "
              + "; ".join(f"{k} " + " / ".join(f"{1e3 * x:.1f}" for x in v)
                          + f" us ({bound / min(v):.2f} of bound, "
                          + f"{max(row['TBps'][k]):.2f} TB/s)" for k, v in t.items())
              + f" [{smi}]", flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "card": smi, "shape": shape, "reps": args.reps,
            "builds": [str(p) for p in args.other], "rows": rows,
            "ptxas": {k: {f"{a} {o}": v for (a, o), v in r.items()}
                      for k, r in regs.items()}}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
